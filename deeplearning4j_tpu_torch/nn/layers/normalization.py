"""Batch normalization + local response normalization, on tensors.

Port of ``deeplearning4j_tpu/nn/layers/normalization.py`` (the
reference's BatchNormalization.java and LocalResponseNormalization.java).
Both normalise over the last axis as it comes: channels of an NHWC
tensor, features of a ``[b, f]`` one. No NCHW copy is made.

BatchNorm keeps the reference's arithmetic, in plain ops:

- the batch variance is the biased one (``jnp.var``), both to normalise
  and to decay the running variance; ``F.batch_norm`` decays with the
  unbiased one, so its running-statistics update does not fit;
- ``decay`` weighs the old running value (torch's ``momentum`` is
  ``1 − decay``);
- the new running statistics are detached: ``net_state`` carries values
  from step to step, never a step's autograd graph.

Under ``ParallelWrapper`` over a ``data`` axis the batch statistics are
the global batch's (sync-BN, :func:`sync_batch_stats`): the per-channel
sum and squared deviation are summed over the ranks by a differentiable
all-reduce, as the reference's one program over the global batch
computes them.

LRN is ``x / (k + α·Σ x²)^β`` over a window of ``n`` channels padded
``(n//2, n−1−n//2)``. ``F.local_response_norm`` divides α by ``n`` and
the reference does not, so the window sum is written out.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers.base import LayerImpl, register_layer_impl


# the process group BatchNorm sums its batch statistics over (None: the
# local batch is the whole batch)
_STATS_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "dl4j_bn_stats_group", default=None)


@contextlib.contextmanager
def sync_batch_stats(group):
    """BatchNorm layers run inside take their training statistics over
    ``group``'s ranks (each holding an equal share of the batch)."""
    token = _STATS_GROUP.set(group)
    try:
        yield
    finally:
        _STATS_GROUP.reset(token)


def _batch_var_mean(x: torch.Tensor):
    """Biased variance and mean over every axis but the last, over the
    global batch when a stats group is set."""
    dims = tuple(range(x.ndim - 1))
    group = _STATS_GROUP.get()
    if group is None:
        return torch.var_mean(x, dim=dims, correction=0)
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel.collectives import AllReduceFn

    count = (x.numel() // x.shape[-1]) * dist.get_world_size(group)
    mean = AllReduceFn.apply(x.sum(dims), group) / count
    var = AllReduceFn.apply(((x - mean) ** 2).sum(dims), group) / count
    return var, mean


@register_layer_impl(L.BatchNormalization)
class BatchNormImpl(LayerImpl):
    """Per-channel (NHWC) or per-feature (``[b, f]``) statistics; γ/β
    are params unless ``lock_gamma_beta``; running mean and variance
    (float32) are the layer's state."""

    def _width(self) -> int:
        c = self.conf
        n = c.n_out if c.n_out is not None else c.n_in
        if n is None:
            raise ValueError(
                "BatchNormalization needs n_in (set_input_type or explicit)")
        return n

    def param_shapes(self):
        if self.conf.lock_gamma_beta:
            return {}
        n = self._width()
        return {"gamma": (n,), "beta": (n,)}

    def init_params(self, gen):
        c, dt = self.conf, self.policy.param_dtype
        return {name: torch.full(shape, getattr(c, name), dtype=dt)
                for name, shape in self.param_shapes().items()}

    def init_state(self):
        n = self._width()
        return {"mean": torch.zeros((n,), dtype=torch.float32),
                "var": torch.ones((n,), dtype=torch.float32)}

    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        c = self.conf
        if train:
            var, mean = _batch_var_mean(x)
            d = c.decay
            new_state = {
                "mean": d * state["mean"] + (1.0 - d) * mean.detach(),
                "var": d * state["var"] + (1.0 - d) * var.detach(),
            }
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        xhat = (x - mean) * torch.rsqrt(var + c.eps)
        if c.lock_gamma_beta:
            y = c.gamma * xhat + c.beta
        else:
            y = params["gamma"] * xhat + params["beta"]
        return self.activation_fn()(y), new_state


@register_layer_impl(L.LocalResponseNormalization)
class LRNImpl(LayerImpl):
    """Cross-channel LRN: ``y = x / (k + α·Σ_{j∈window} x_j²)^β``."""

    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        c = self.conf
        half = c.n // 2
        sq = F.pad(x * x, (half, c.n - 1 - half))
        ssum = sq.unfold(-1, c.n, 1).sum(-1)
        return self.activation_fn()(x / (c.k + c.alpha * ssum) ** c.beta), state
