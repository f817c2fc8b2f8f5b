"""The in-program metrics pack: per-step training diagnostics on the device.

Port of ``deeplearning4j_tpu/monitor/pack.py``. A fused training step can
emit a ``[4]`` float32 vector

    [grad global-norm, update global-norm, param global-norm, lr scale]

which the epoch driver stacks into an ``[E, N, 4]`` history beside the
loss history, read back with it. Telemetry off leaves the pack out, and
the step is then exactly the step without it. A stride above 1 keeps the
vector on every stride-th iteration and NaN on the others: the norms are
computed on every step and a ``torch.where`` on the device iteration
picks the row, since a host branch would need a host read (the
reference's ``lax.cond`` computes only the kept rows; the values kept
are the same).

Under the sentinel a tripped step keeps its params, so its update norm
is 0 and its param norm the pre-step norm.
"""

from __future__ import annotations

import functools

import torch

from deeplearning4j_tpu_torch.dtypes import tree_leaves

__all__ = ["METRIC_NAMES", "N_METRICS", "step_metrics", "tree_global_norm"]

# column order of the [E, N, 4] metrics history
METRIC_NAMES = ("grad_norm", "update_norm", "param_norm", "lr_scale")
N_METRICS = len(METRIC_NAMES)


def tree_global_norm(tree) -> torch.Tensor:
    """float32 global L2 norm over every floating leaf of ``tree``
    (integer leaves skipped), summed in float32 whatever the leaf dtype."""
    sq = [torch.sum(torch.square(leaf.float())) for leaf in tree_leaves(tree)
          if leaf.is_floating_point()]
    if not sq:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(functools.reduce(torch.add, sq))


def step_metrics(params, new_params, grads, lr_scale: torch.Tensor,
                 iteration: torch.Tensor, stride: int) -> torch.Tensor:
    """The ``[4]`` float32 metrics vector of one step. ``params`` and
    ``new_params`` are the trees before and after it (their difference is
    the update applied); ``lr_scale`` and ``iteration`` are device
    scalars."""
    upd = [b.float() - a.float()
           for a, b in zip(tree_leaves(params), tree_leaves(new_params))]
    vec = torch.stack([
        tree_global_norm(grads),
        tree_global_norm(upd),
        tree_global_norm(new_params),
        lr_scale.to(torch.float32),
    ])
    if stride <= 1:
        return vec
    return torch.where(iteration % stride == 0, vec,
                       torch.full_like(vec, float("nan")))
