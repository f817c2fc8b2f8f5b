"""Ring attention: context parallelism over a ``sequence`` mesh axis.

Port of ``deeplearning4j_tpu/parallel/ring_attention.py`` (Liu et al.,
"Ring Attention with Blockwise Transformers"). The sequence is split
over the ranks of the ``sequence`` axis; each rank keeps its Q block and
the K/V blocks travel around the ring (``collectives.rotate``, the
reference's ``ppermute``), merged by an online softmax in f32.

The reference takes global arrays and runs the ring inside
``shard_map``; under torch's SPMD model every rank calls
:func:`ring_attention` with its own ``[b, t_local, h, d]`` shards (rank
i of the axis holding positions ``[i·t_local, (i+1)·t_local)``) and gets
its shard of the output. Each rank knows its index on the host, so the
reference's ``lax.switch``/``lax.cond`` over hop kinds are host
branches here, and a hop that contributes nothing launches nothing.

Two per-block implementations:

- ``impl="xla"`` — blockwise plain-torch math (the oracle),
  differentiable by autograd through :class:`collectives.RingCarry`.
- ``impl="flash"`` — the flash kernels per hop: a
  ``torch.autograd.Function`` whose forward runs B1
  (``flash_attention_fwd``) on each hop that sees anything — *full*
  below the diagonal, *diag* (causal) on it, nothing above it — and
  merges the blocks by their log-sum-exp; its backward is a second ring
  pass running B2 + B3 (``flash_attention_bwd``) per hop against the
  merged ``out``/``lse``, dq accumulating locally and dk/dv travelling
  with their blocks. Causal, rank r runs r + 1 of the n hops.

A causal sliding window runs only the hops its band reaches
(:func:`_win_steps`), rotating against the causal direction. Flash:
the diagonal hop runs B1 banded, fully in-band hops B1 unmasked, and
the ≤ 2 band-edge hops plain math, as in the reference; the backward
accumulates in f32 in every branch (the reference's bf16 ``lax.cond``
there does not trace, ROADMAP C).
"""

from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch.kernels.flash_attention import (
    MASK_VALUE,
    flash_attention,
    flash_attention_bwd,
    flash_attention_fwd,
    flash_backward,
)
from deeplearning4j_tpu_torch.ops.attention import NEG_INF, causal_band_mask
from deeplearning4j_tpu_torch.parallel.collectives import RingCarry, rotate
from deeplearning4j_tpu_torch.parallel.mesh import (
    SEQUENCE_AXIS,
    axis_group,
    axis_rank,
    axis_size,
)


def _block_attn(q, k, v, q_offset, k_offset, *, causal, scale,
                window=None):
    """Blockwise attention at absolute positions: ``(p·v, running max,
    normaliser)`` in f32. ``window`` (requires causal) keeps k in
    ``(q - window, q]``."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        keep = causal_band_mask(q.shape[1], k.shape[1], window=window,
                                q_offset=q_offset, k_offset=k_offset,
                                device=q.device)
        logits = torch.where(keep, logits, NEG_INF)
    m = logits.amax(dim=-1)  # [b, h, tq]
    p = torch.exp(logits - m[..., None])
    l = p.sum(dim=-1)  # [b, h, tq]
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return pv, m, l


def _lse_merge(o, lse, o_blk, lse_blk):
    """Merge a normalised attention block into the running (o, lse)
    accumulator by log-sum-exp: the ONE merge both flash rings share. o
    accumulates in f32."""
    lse_new = torch.logaddexp(lse, lse_blk)
    w_old = torch.exp(lse - lse_new)
    w_new = torch.exp(lse_blk - lse_new)
    o_new = (o * w_old.transpose(1, 2)[..., None]
             + o_blk.float() * w_new.transpose(1, 2)[..., None])
    return o_new, lse_new


def _online_merge(o, m, l, pv, m_blk, l_blk):
    """The XLA rings' online-softmax merge of one block."""
    m_new = torch.maximum(m, m_blk)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(m_blk - m_new)
    l_new = l * alpha + l_blk * beta
    o_new = (o * alpha.transpose(1, 2)[..., None]
             + pv * beta.transpose(1, 2)[..., None])
    return o_new, m_new, l_new


def _normalise(o, l, dtype):
    denom = torch.clamp(l.transpose(1, 2)[..., None], min=1e-30)
    return (o / denom).to(dtype)


class _Ring:
    """The statics of one ring call: the group, this rank's index, the
    ring size, the local block length, scale, causality and window."""

    def __init__(self, mesh, axis_name, t_local, scale, causal, window):
        self.group = axis_group(mesh, axis_name)
        self.n = axis_size(mesh, axis_name)
        self.me = axis_rank(mesh, axis_name)
        self.t_local = t_local
        self.scale = scale
        self.causal = causal
        self.window = window

    # the full ring: step s holds the block of owner (me + s) % n
    def hop_mode(self, s: int) -> str:
        if not self.causal:
            return "full"
        owner = (self.me + s) % self.n
        if owner < self.me:
            return "full"
        return "diag" if owner == self.me else "skip"

    # the windowed ring: step s holds the block of owner (me - s) % n
    @property
    def n_steps(self) -> int:
        return _win_steps(self.window, self.t_local, self.n)

    def win_kind(self, s: int) -> str:
        """"skip" for wrapped owners (the causal future), "diag" at s=0
        (the banded kernel applies), "full" when every (q, k) pair is in
        band (the unmasked kernel), else "partial" (plain math)."""
        if self.me < s:
            return "skip"
        if s == 0:
            return "diag"
        return ("full" if (s + 1) * self.t_local <= self.window
                else "partial")


def _win_steps(window: int, t_local: int, n_ring: int) -> int:
    """Ring hops a causal band ``(q-window, q]`` can touch: the diagonal
    block plus ``ceil((window-1)/t_local)`` previous neighbours, capped
    at the ring size."""
    return min(n_ring, -(-(window - 1) // t_local) + 1)


def hop_schedule(n: int, *, causal: bool, window: Optional[int] = None,
                 t_local: Optional[int] = None) -> int:
    """Flash-kernel hops (B1 launches forward, B2 and B3 each backward)
    one ring attention call makes, summed over its ``n`` ranks."""
    if window is not None and window < n * t_local:
        steps = _win_steps(window, t_local, n)
        return sum(1 for me in range(n) for s in range(steps)
                   if me >= s and (s == 0 or (s + 1) * t_local <= window))
    return n * (n + 1) // 2 if causal else n * n


def _merged_start(q):
    b, tq, h, d = q.shape
    return (torch.zeros((b, tq, h, d), dtype=torch.float32, device=q.device),
            torch.full((b, h, tq), MASK_VALUE, dtype=torch.float32,
                       device=q.device))


def _ring_fwd(q, k, v, ring):
    """The flash ring's forward: B1 per hop that sees anything, blocks
    merged by log-sum-exp → (out in q's dtype, lse f32)."""
    o, lse = _merged_start(q)
    kc, vc = k, v
    for s in range(ring.n):
        mode = ring.hop_mode(s)
        if mode != "skip":
            o_blk, lse_blk = flash_attention_fwd(
                q, kc, vc, causal=mode == "diag", scale=ring.scale)
            o, lse = _lse_merge(o, lse, o_blk, lse_blk)
        if s + 1 < ring.n:
            kc, vc = rotate([kc, vc], ring.group, 1)
    return o.to(q.dtype), lse


def _win_ring_fwd(q, k, v, ring):
    """The windowed flash ring's forward → (out, lse)."""
    o, lse = _merged_start(q)
    kc, vc = k, v
    for s in range(ring.n_steps):
        kind = ring.win_kind(s)
        if kind == "diag":
            o_blk, lse_blk = flash_attention_fwd(
                q, kc, vc, causal=True, window=ring.window, scale=ring.scale)
        elif kind == "full":
            o_blk, lse_blk = flash_attention_fwd(
                q, kc, vc, causal=False, scale=ring.scale)
        elif kind == "partial":
            o_blk, lse_blk = _win_partial_hop(ring, q, kc, vc, s)
            o_blk = o_blk.to(q.dtype)
        if kind != "skip":
            o, lse = _lse_merge(o, lse, o_blk, lse_blk)
        if s + 1 < ring.n_steps:
            kc, vc = rotate([kc, vc], ring.group, -1)
    return o.to(q.dtype), lse


class _RingFlash(torch.autograd.Function):
    """Forward B1 per hop, backward B2 + B3 per hop (the reference's
    ``_ring_flash`` custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, ring):
        out, lse = _ring_fwd(q, k, v, ring)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = ring
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        ring = ctx.ring
        do = do.to(q.dtype).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkc = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dvc = torch.zeros_like(dkc)
        kc, vc = k, v
        for s in range(ring.n):
            mode = ring.hop_mode(s)
            if mode != "skip":
                dq_c, dk_c, dv_c = flash_attention_bwd(
                    q, kc, vc, out, lse, do, causal=mode == "diag",
                    scale=ring.scale)
                dq += dq_c
                dkc += dk_c
                dvc += dv_c
            if s + 1 < ring.n:
                kc, vc, dkc, dvc = rotate([kc, vc, dkc, dvc], ring.group, 1)
        # after n-1 rotations rank i holds owner i-1's accumulators: one
        # more rotation sends every one home
        if ring.n > 1:
            dkc, dvc = rotate([dkc, dvc], ring.group, 1)
        return dq.to(q.dtype), dkc.to(k.dtype), dvc.to(v.dtype), None


def _win_partial_hop(ring, q, kc, vc, s):
    """One band-edge hop in plain f32 math → (o, lse) in the flash merge
    convention."""
    pv, m, l = _block_attn(q.float(), kc.float(), vc.float(),
                           q_offset=s * ring.t_local, k_offset=0,
                           causal=True, scale=ring.scale, window=ring.window)
    l_safe = torch.clamp(l, min=1e-30)
    return pv / l_safe.transpose(1, 2)[..., None], m + torch.log(l_safe)


class _WinRingFlash(torch.autograd.Function):
    """The windowed flash ring (the reference's ``_win_ring_flash``)."""

    @staticmethod
    def forward(ctx, q, k, v, ring):
        out, lse = _win_ring_fwd(q, k, v, ring)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = ring
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        ring = ctx.ring
        do = do.to(q.dtype).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkc = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dvc = torch.zeros_like(dkc)
        kc, vc = k, v
        for s in range(ring.n_steps):
            kind = ring.win_kind(s)
            if kind in ("diag", "full"):
                g = flash_attention_bwd(
                    q, kc, vc, out, lse, do, causal=kind == "diag",
                    window=ring.window if kind == "diag" else None,
                    scale=ring.scale)
            elif kind == "partial":
                g = flash_backward(
                    q, kc, vc, out, lse, do, causal=True,
                    window=ring.window, q_offset=s * ring.t_local,
                    k_offset=0, scale=ring.scale)
            if kind != "skip":
                dq += g[0]
                dkc += g[1]
                dvc += g[2]
            if s + 1 < ring.n_steps:
                kc, vc, dkc, dvc = rotate([kc, vc, dkc, dvc], ring.group,
                                          -1)
        # after n_steps-1 rotations rank i holds owner
        # (i - (n_steps-1))'s accumulators: send them home in one hop
        if ring.n_steps > 1:
            dkc, dvc = rotate([dkc, dvc], ring.group, ring.n_steps - 1)
        return dq.to(q.dtype), dkc.to(k.dtype), dvc.to(v.dtype), None


def _xla_ring(q, k, v, ring):
    """The plain ring: blockwise f32 math, differentiable by autograd."""
    b, tq, h, d = q.shape
    o = torch.zeros((b, tq, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, tq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, tq), dtype=torch.float32, device=q.device)
    windowed = ring.window is not None
    steps = ring.n_steps if windowed else ring.n
    blocks = RingCarry.apply(k.float(), v.float(), ring.group,
                             -1 if windowed else 1, steps)
    for s in range(steps):
        owner = (ring.me - s if windowed else ring.me + s) % ring.n
        # windowed: wrapped owners sit in the causal future (skipped)
        if not (windowed and owner > ring.me):
            pv, m_blk, l_blk = _block_attn(
                q, blocks[2 * s], blocks[2 * s + 1],
                q_offset=ring.me * ring.t_local,
                k_offset=owner * ring.t_local, causal=ring.causal,
                scale=ring.scale, window=ring.window)
            o, m, l = _online_merge(o, m, l, pv, m_blk, l_blk)
    return _normalise(o, l, q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, *, causal: bool = False,
                   scale: Optional[float] = None,
                   axis_name: str = SEQUENCE_AXIS, impl: str = "xla",
                   window: Optional[int] = None) -> torch.Tensor:
    """Ring attention over ``axis_name``. q/k/v: this rank's ``[b,
    t_local, h, d]`` shards of the sequence; returns this rank's shard
    of the output. ``impl="flash"`` runs the flash kernels per hop (B1
    forward, B2 + B3 backward); ``"xla"`` the plain blockwise math.

    ``window`` (requires ``causal=True``) composes sliding-window
    attention with the ring: only the ``ceil((window-1)/t_local) + 1``
    hops its band reaches run. A band at least as long as the sequence
    is plain causal attention and takes the full ring. With the axis
    dropped from the mesh (size 1) this is single-device attention."""
    if impl not in ("xla", "flash"):
        raise ValueError(f"unknown ring attention impl {impl!r}")
    if window is not None and (not causal or window < 1):
        raise ValueError("window requires causal=True and window >= 1")
    n = axis_size(mesh, axis_name)
    t_local = q.shape[1]
    if window is not None and window >= n * t_local:
        window = None
    scale_val = scale if scale is not None else float(
        1.0 / (q.shape[-1] ** 0.5))
    if n == 1:
        if impl == "flash":
            return flash_attention(q, k, v, causal=causal, scale=scale_val,
                                   window=window)
        pv, _, l = _block_attn(q, k, v, 0, 0, causal=causal,
                               scale=scale_val, window=window)
        return _normalise(pv, l, q.dtype)
    ring = _Ring(mesh, axis_name, t_local, scale_val, causal, window)
    if impl == "xla":
        return _xla_ring(q, k, v, ring)
    q, k, v = (x.contiguous() for x in (q, k, v))
    if window is not None:
        return _WinRingFlash.apply(q, k, v, ring)
    return _RingFlash.apply(q, k, v, ring)


def ring_flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mesh, *, causal: bool = False,
                       scale: Optional[float] = None,
                       axis_name: str = SEQUENCE_AXIS,
                       window: Optional[int] = None):
    """The flash ring's forward alone: this rank's ``(out, lse [b, h,
    t_local] f32)``, the merged log-sum-exp the backward ring reads (a
    mesh of one: B1's own)."""
    n, t_local = axis_size(mesh, axis_name), q.shape[1]
    if window is not None and window >= n * t_local:
        window = None
    scale_val = scale if scale is not None else float(
        1.0 / (q.shape[-1] ** 0.5))
    q, k, v = (x.contiguous() for x in (q, k, v))
    if n == 1:
        return flash_attention_fwd(q, k, v, causal=causal, scale=scale_val,
                                   window=window)
    ring = _Ring(mesh, axis_name, t_local, scale_val, causal, window)
    if window is not None:
        return _win_ring_fwd(q, k, v, ring)
    return _ring_fwd(q, k, v, ring)


def ring_self_attention_sharded(mesh):
    """Convenience: ``fn(q, k, v, causal=False)`` bound to ``mesh``."""
    def fn(q, k, v, causal=False):
        return ring_attention(q, k, v, mesh, causal=causal)

    return fn
