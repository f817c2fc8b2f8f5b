"""Dense / output / embedding / activation / dropout / loss layers.

Port of ``deeplearning4j_tpu/nn/layers/feedforward.py``. Dense is
``z = x·W + b`` with ``W`` as ``[in, out]`` (the reference's layout, so
params carry over unpermuted), the operands cast to the policy's compute
dtype and the product to its output dtype before the bias, as the
reference does (``:42-44``).
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers.base import LayerImpl, register_layer_impl
from deeplearning4j_tpu_torch.ops.initializers import init_weights


class _WeightAndBias(LayerImpl):
    """``W [n_in, n_out]`` from the conf's scheme and ``b [n_out]``."""

    def param_shapes(self):
        c = self.conf
        return {"W": (c.n_in, c.n_out), "b": (c.n_out,)}

    def init_params(self, gen):
        c, dt = self.conf, self.policy.param_dtype
        W = init_weights(gen, (c.n_in, c.n_out), c.weight_init.value,
                         distribution=c.dist, dtype=dt)
        return {"W": W, "b": torch.full((c.n_out,), c.bias_init, dtype=dt)}


@register_layer_impl(L.DenseLayer)
class DenseImpl(_WeightAndBias):
    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout(x, train=train, rng=rng)
        pol = self.policy
        z = pol.cast_compute(x) @ pol.cast_compute(params["W"])
        z = pol.cast_output(z) + params["b"]
        return self.activation_fn()(z), state


@register_layer_impl(L.OutputLayer)
class OutputImpl(DenseImpl):
    """Dense + activation; the network applies ``conf.loss_function``."""


@register_layer_impl(L.RnnOutputLayer)
class RnnOutputImpl(DenseImpl):
    """Per-timestep dense: ``[b, t, f] · W`` is one batched GEMM."""


@register_layer_impl(L.EmbeddingLayer)
class EmbeddingImpl(_WeightAndBias):
    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        # x: integer indices [b] or [b, 1], or one-hot [b, n_in]
        if (x.is_floating_point() and x.ndim >= 2
                and x.shape[-1] == self.conf.n_in):
            idx = torch.argmax(x, dim=-1)
        else:
            idx = x.long()
            if idx.ndim >= 2 and idx.shape[-1] == 1:
                idx = idx[..., 0]
        out = params["W"][idx] + params["b"]
        return self.activation_fn()(out), state


@register_layer_impl(L.ActivationLayer)
class ActivationImpl(LayerImpl):
    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout(x, train=train, rng=rng)
        return self.activation_fn()(x), state


@register_layer_impl(L.DropoutLayer)
class DropoutImpl(LayerImpl):
    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        return self.maybe_dropout(x, train=train, rng=rng), state


@register_layer_impl(L.LossLayer)
class LossLayerImpl(LayerImpl):
    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        return self.activation_fn()(x), state
