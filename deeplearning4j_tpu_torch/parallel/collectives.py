"""The collectives the mesh modules use.

The reference's collectives are XLA's (``psum``, ``ppermute``,
``all_to_all``), inserted by GSPMD or written in ``shard_map``. The port
calls ``torch.distributed`` on the mesh axis's process group, with the
same calls on every backend it runs: NCCL with CUDA tensors, gloo with
CPU tensors, and gloo with CUDA tensors (several ranks sharing one
card), which carries ``all_reduce``, ``all_gather`` and
``all_to_all_single`` (uneven splits too) but has no CUDA point-to-point
(``chip_smoke.py``'s probe). So the ring's K/V rotation (the reference's
``lax.ppermute``) is one ``all_to_all_single`` with a single non-empty
split each way, not a send and a receive: each rank sends its packed
buffer to one peer and receives one from another, one call for any
number of tensors.

:class:`RingCarry`, :class:`AllToAllFn` and :class:`AllReduceFn` are
the differentiable versions: the backward of a ring's rotations is the
opposite rotations, of a sequence-to-heads reshard the heads-to-sequence
one, and of an all-reduce the all-reduce of the gradient.
:class:`SumSharesFn` sums a loss's shares and sends each share its own
gradient.

Tensor parallelism over ``model`` (Megatron) pairs two of them: **f**
(:class:`CopyToShardsFn`: identity forward, all-reduce backward) where
a replicated activation enters the column-split GEMMs, and **g**
(:class:`SumSharesFn`: sum forward, identity backward) after the
row-split GEMM. An all-reduce's summation order depends on the buffer
size (gloo and NCCL chunk their rings by it), so a split network's
inference sums its partials with :func:`fixed_order_sum` instead:
gathered, then added in rank order in float64, so that the sum over
ranks does not depend on the batch (the partials still come from the
matrix library, whose order may).
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence

import torch
import torch.distributed as dist

# the open record_collectives() blocks (usually none)
_RECORDERS: List[list] = []


@contextlib.contextmanager
def record_collectives():
    """Every collective this module issues inside the block, as ``(op,
    group)`` pairs in issue order (the program contracts check each group
    against the mesh axes the sharding registry declared)."""
    calls: list = []
    _RECORDERS.append(calls)
    try:
        yield calls
    finally:
        _RECORDERS.remove(calls)


def _note(op: str, group) -> None:
    for calls in _RECORDERS:
        calls.append((op, group))


def _pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors])


def _unpack(flat: torch.Tensor, like: Sequence[torch.Tensor]):
    out, off = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(flat[off:off + n].view(t.dtype).reshape(t.shape))
        off += n
    return out


def rotate(tensors: Sequence[torch.Tensor], group, shift: int
           ) -> List[torch.Tensor]:
    """Send every tensor to the rank ``shift`` places before this one
    in ``group`` and receive the same shapes from the rank ``shift``
    places after it: group index i ends up holding what i + shift held
    (the reference's ``ppermute`` with ``perm = [(i, i - shift)]``)."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    shift %= n
    if shift == 0:
        return [t.clone() for t in tensors]
    flat = _pack(tensors)
    send = [0] * n
    recv = [0] * n
    send[(me - shift) % n] = flat.numel()
    recv[(me + shift) % n] = flat.numel()
    dst = torch.empty_like(flat)
    _note("rotate", group)
    dist.all_to_all_single(dst, flat, recv, send, group=group)
    return _unpack(dst, tensors)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` ``[n, ...]``: chunk j goes to group index j; returns
    ``[n, ...]`` whose chunk j came from group index j."""
    src = x.contiguous()
    dst = torch.empty_like(src)
    _note("all_to_all", group)
    dist.all_to_all_single(dst, src, group=group)
    return dst


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place; returns ``x``."""
    _note("all_reduce", group)
    dist.all_reduce(x, group=group)
    return x


def all_reduce_tree_(tensors: Sequence[torch.Tensor], group) -> None:
    """Sum every tensor over ``group`` in place, in one collective per
    dtype (packed into one flat buffer each)."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group_ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group_ts])
        all_reduce_(flat, group)
        off = 0
        for t in group_ts:
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Concatenate every group member's ``x`` along ``dim``, in group
    order (all members' ``x`` have one shape)."""
    src = x.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    _note("all_gather", group)
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


class RingCarry(torch.autograd.Function):
    """Differentiable K/V travel around a ring: ``apply(k, v, group,
    shift, steps)`` returns ``(k_0, v_0, k_1, v_1, …)`` where ``k_s`` is
    ``k`` rotated ``s`` times by ``shift`` (one :func:`rotate` of both a
    step). One function for the whole trip, so its backward — the
    opposite rotations, each adding the gradient of the block a step
    held — runs in every rank even where a rank left a block unused (a
    hop in its causal future): a collective per unused block would
    leave the other ranks waiting."""

    @staticmethod
    def forward(ctx, k, v, group, shift, steps):
        ctx.group, ctx.shift = group, shift
        out = [k.clone(), v.clone()]
        for _ in range(steps - 1):
            out += rotate(out[-2:], group, shift)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        gk, gv = grads[-2], grads[-1]
        for s in range(len(grads) // 2 - 2, -1, -1):
            gk, gv = rotate([gk, gv], ctx.group, -ctx.shift)
            gk = gk + grads[2 * s]
            gv = gv + grads[2 * s + 1]
        return gk, gv, None, None, None


class AllToAllFn(torch.autograd.Function):
    """Differentiable reshard of ``[b, t_local, H, d]`` sequence shards
    to ``[b, t, H/n, d]`` head shards (``to_heads=True``) or back: the
    reference's tiled ``lax.all_to_all``. Chunk order is group order on
    both axes."""

    @staticmethod
    def forward(ctx, x, group, to_heads: bool):
        ctx.group, ctx.to_heads = group, to_heads
        return _reshard(x, group, to_heads)

    @staticmethod
    def backward(ctx, g):
        return _reshard(g, ctx.group, not ctx.to_heads), None, None


def _reshard(x: torch.Tensor, group, to_heads: bool) -> torch.Tensor:
    n = dist.get_world_size(group)
    b, t, h, d = x.shape
    if to_heads:
        # [b, tl, H, d] → [n(dst), b, tl, H/n, d] → exchange →
        # [n(src), b, tl, H/n, d] → [b, n·tl, H/n, d]
        send = x.reshape(b, t, n, h // n, d).permute(2, 0, 1, 3, 4)
        got = all_to_all(send, group)
        return got.permute(1, 0, 2, 3, 4).reshape(b, n * t, h // n, d)
    # [b, T, h, d] → [n(dst), b, T/n, h, d] → exchange →
    # [n(src), b, T/n, h, d] → [b, T/n, n·h, d]
    send = x.reshape(b, n, t // n, h, d).permute(1, 0, 2, 3, 4)
    got = all_to_all(send, group)
    return got.permute(1, 2, 0, 3, 4).reshape(b, t // n, n * h, d)


class AllReduceFn(torch.autograd.Function):
    """Differentiable sum over ``group``: every member gets the sum, and
    the gradient of each member's input is the sum of the members'
    output gradients (the loss is the sum of the members' losses)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class CopyToShardsFn(torch.autograd.Function):
    """Megatron's f: the identity forward; backward, the sum over
    ``group`` of the members' gradients. Placed where one replicated
    tensor feeds each member's shard of a split computation, so that
    its gradient is the whole computation's."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # a 16-bit gradient is summed in f32 and rounded once
        return all_reduce_(g.float(), ctx.group).to(g.dtype), None


def fixed_order_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of every member's ``x``, the same bytes in
    every member: the partials are gathered and added in group order in
    float64, then rounded once to ``x``'s dtype. The order does not
    depend on the size of ``x``, as a ring all-reduce's does."""
    n = dist.get_world_size(group)
    parts = all_gather(x[None], group, 0)
    acc = parts[0].double()
    for i in range(1, n):
        acc = acc + parts[i].double()
    return acc.to(x.dtype)


class FixedOrderSumFn(torch.autograd.Function):
    """:func:`fixed_order_sum` forward, the identity backward (g)."""

    @staticmethod
    def forward(ctx, x, group):
        return fixed_order_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class SumSharesFn(torch.autograd.Function):
    """The sum over ``group`` of each member's share of one quantity (a
    loss): every member gets the sum, and each member's gradient flows
    to its own share only, so a member's parameter gradients are its
    part of the whole and their sum over the group is the whole's."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class GatherShardsFn(torch.autograd.Function):
    """The whole tensor from every member's shard along ``dim``
    (:func:`all_gather`); backward, this member's chunk of the whole
    gradient, not summed: every member ran the same whole computation
    on the gathered tensor, so each already holds the whole gradient."""

    @staticmethod
    def forward(ctx, x, group, dim: int):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.r = dist.get_rank(group)
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.r * ctx.n, ctx.n).contiguous(), \
            None, None


class RotateFn(torch.autograd.Function):
    """Differentiable :func:`rotate` of one tensor: the backward rotates
    the gradient the other way, so the backward collectives of a
    schedule of rotations meet in every member."""

    @staticmethod
    def forward(ctx, x, group, shift: int):
        ctx.group, ctx.shift = group, shift
        return rotate([x], group, shift)[0]

    @staticmethod
    def backward(ctx, g):
        return rotate([g.contiguous()], ctx.group, -ctx.shift)[0], \
            None, None
