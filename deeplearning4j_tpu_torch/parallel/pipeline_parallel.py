"""Pipeline parallelism: a GPipe microbatch schedule over a ``pipe`` axis.

Port of ``deeplearning4j_tpu/parallel/pipeline_parallel.py``. Every rank
runs the same program; its stage is its coordinate on the ``pipe`` axis
and activations hop stage to stage with ``collectives.rotate``.

Schedule: GPipe with M microbatches over S stages, T = M + S − 1 ticks.
Each tick every stage (a) selects its input (stage 0 ingests microbatch
t, the others take the activation handed to them last tick), (b)
applies its stage function, (c) rotates the result one hop down the
ring. Every rank runs every tick and every rotation, bubbles included,
as the reference does: the rotation is :class:`collectives.RotateFn`,
whose backward rotates the other way, and each tick's selections are
``torch.where``s on tensors, so every rank's backward runs every
rotation's backward and the collectives meet. Only the last stage holds
real outputs; a masked sum over ``pipe`` (g, ``SumSharesFn``) gives them
to every rank. Other mesh axes (``data``) split each microbatch's rows:
each rank pipelines its rows and the outputs are gathered whole.

Stages must be homogeneous (same activation shape in and out). Stage
params are stacked on a leading ``[S, ...]`` axis; ``shard_stage_params``
keeps this rank's ``[1, ...]`` part.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from deeplearning4j_tpu_torch.dtypes import tree_leaves, tree_map
from deeplearning4j_tpu_torch.parallel.mesh import (
    PIPE_AXIS,
    axis_group,
    axis_rank,
    axis_size,
    local_chunk,
    mesh_shape,
    shard_leading_axis,
)

__all__ = ["stack_stage_params", "shard_stage_params", "spmd_pipeline",
           "split_microbatches", "pipeline_train_step"]


def stack_stage_params(per_stage_params) -> Any:
    """``[{...}, {...}, ...]`` per-stage trees → one tree whose every leaf
    has a leading ``[S]`` axis (the layout :func:`spmd_pipeline` takes)."""
    first = per_stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in per_stage_params])
                for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_stage_params([p[i] for p in
                                               per_stage_params])
                           for i in range(len(first)))
    return torch.stack(list(per_stage_params))


def shard_stage_params(stacked, mesh, axis_name: str = PIPE_AXIS):
    """This rank's stage of stacked stage params: every leaf's ``[1,
    ...]`` chunk of the stage axis (the whole stack when the axis was
    dropped)."""
    return shard_leading_axis(stacked, mesh, axis_name)


def split_microbatches(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """``[B, ...]`` → ``[M, B/M, ...]``."""
    if x.shape[0] % n_micro:
        raise ValueError(
            f"batch {x.shape[0]} not divisible by {n_micro} microbatches")
    return x.reshape((n_micro, x.shape[0] // n_micro) + tuple(x.shape[1:]))


def _stage_of(stage_params, n_stages: int, stage: int):
    """This rank's stage params (leaves ``[1, ...]`` or the whole
    ``[S, ...]`` stack), unstacked."""
    lead = tree_leaves(stage_params)[0].shape[0]
    if lead not in (1, n_stages):
        raise ValueError(
            f"stage_params stack {lead} stages but the pipe axis has "
            f"{n_stages} ranks")
    return tree_map(lambda p: p[0] if lead == 1 else p[stage], stage_params)


def _row_axes(mesh, axis_name: str):
    """The mesh axes other than ``axis_name`` that split the rows."""
    return [a for a, n in mesh_shape(mesh).items()
            if a != axis_name and n > 1]


def spmd_pipeline(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                  stage_params: Any, x_microbatches: torch.Tensor, mesh, *,
                  axis_name: str = PIPE_AXIS) -> torch.Tensor:
    """Run ``[M, mb, ...]`` microbatches (the same in every rank) through
    the stages; returns the ``[M, mb, ...]`` outputs in every rank.

    ``stage_fn(params, x) -> y`` with ``y.shape == x.shape``;
    ``stage_params`` the stacked stages (whole or this rank's part)."""
    n_stages = axis_size(mesh, axis_name)
    if n_stages == 1:
        # the pipe axis was dropped: the stages in sequence
        n = tree_leaves(stage_params)[0].shape[0]
        out = x_microbatches
        for s in range(n):
            p = tree_map(lambda a, s=s: a[s], stage_params)
            out = torch.stack([stage_fn(p, xb) for xb in out])
        return out
    from deeplearning4j_tpu_torch.parallel.collectives import (
        GatherShardsFn, RotateFn, SumSharesFn)

    group = axis_group(mesh, axis_name)
    stage = axis_rank(mesh, axis_name)
    params = _stage_of(stage_params, n_stages, stage)
    x = x_microbatches
    rows = _row_axes(mesh, axis_name)
    for ax in rows:
        x = local_chunk(x, 1, axis_size(mesh, ax), axis_rank(mesh, ax))
    n_micro = x.shape[0]
    dev = x.device
    first = torch.tensor(stage == 0, device=dev)
    last = stage == n_stages - 1
    state = torch.zeros_like(x[0])
    outputs = [torch.zeros_like(x[0]) for _ in range(n_micro)]
    for t in range(n_micro + n_stages - 1):
        cur = torch.where(first, x[min(t, n_micro - 1)], state)
        out = stage_fn(params, cur)
        mb = t - (n_stages - 1)
        slot = min(max(mb, 0), n_micro - 1)
        valid = torch.tensor(last and mb >= 0, device=dev)
        outputs[slot] = torch.where(valid, out, outputs[slot])
        state = RotateFn.apply(out.contiguous(), group, -1)
    out = torch.stack(outputs)
    out = torch.where(torch.tensor(last, device=dev), out,
                      torch.zeros_like(out))
    # one stage's outputs and zeros: the f32 sum is exact
    out = SumSharesFn.apply(out.float(), group).to(out.dtype)
    for ax in reversed(rows):
        out = GatherShardsFn.apply(out, axis_group(mesh, ax), 1)
    return out


def pipeline_train_step(stage_fn: Callable[[Any, torch.Tensor],
                                           torch.Tensor],
                        loss_fn: Callable[[torch.Tensor, torch.Tensor],
                                          torch.Tensor],
                        mesh, *, n_microbatches: int,
                        learning_rate: float = 0.1,
                        axis_name: str = PIPE_AXIS):
    """An SGD step ``step(params, x, y) -> (params, loss)`` for a
    pipelined tower: ``loss_fn(y_pred, y_true)`` on the re-flattened
    outputs, differentiated through the schedule (the backward rotations
    run the backward pipeline), the gradients summed over the axes that
    split the rows. Every rank calls it with the same ``x`` and ``y``
    and its stage params (whole or its part; it returns the same
    layout)."""
    from deeplearning4j_tpu_torch.parallel.collectives import all_reduce_tree_

    def step(params, x, y):
        fwd = tree_map(lambda p: p.detach().requires_grad_(), params)
        out = spmd_pipeline(stage_fn, fwd, split_microbatches(
            x, n_microbatches), mesh, axis_name=axis_name)
        loss = loss_fn(out.reshape((-1,) + tuple(out.shape[2:])), y)
        leaves = tree_leaves(fwd)
        grads = list(torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True))
        if axis_size(mesh, axis_name) > 1:
            for ax in _row_axes(mesh, axis_name):
                all_reduce_tree_(grads, axis_group(mesh, ax))
        it = iter(grads)
        with torch.no_grad():
            new = tree_map(lambda p: p - learning_rate * next(it), params)
        return new, loss.detach()

    return step
