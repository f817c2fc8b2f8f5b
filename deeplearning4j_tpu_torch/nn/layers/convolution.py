"""Convolution + pooling layers on NHWC tensors.

Port of ``deeplearning4j_tpu/nn/layers/convolution.py``. The layout is
the reference's: inputs ``[b, h, w, c]``, conv ``W`` as ``[kh, kw, in,
out]`` (HWIO). ``x.permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is
an NCHW view with channels-last strides, which cuDNN takes without a
copy; the weight becomes a channels-last OIHW tensor (one small copy per
use), so the convolution runs channels-last and its output turns back
into NHWC by a view.

Where torch's padding differs from XLA's, the layers pad explicitly:

- SAME at stride > 1: XLA pads ``max((ceil(n/s) − 1)·s + k − n, 0)`` in
  all, the smaller half first; ``F.conv2d(padding="same")`` rejects
  stride > 1.
- Pooling: MAX pads with −inf, AVG/SUM/PNORM with 0; AVG divides by
  ``kh·kw`` padding included. ``F.max_pool2d`` and ``F.avg_pool2d`` cap
  their padding at half the window, so the pad is an ``F.pad`` and the
  pool runs unpadded. PNORM is ``(Σ|x|^p)^(1/p)`` (``F.lp_pool2d`` drops
  the ``abs``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.enums import PoolingType
from deeplearning4j_tpu_torch.nn.layers.base import LayerImpl, register_layer_impl
from deeplearning4j_tpu_torch.ops.initializers import conv_fans, init_weights


def same_pads(size: int, k: int, s: int):
    """XLA's SAME padding of one spatial dim: ``(low, high)``."""
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


@register_layer_impl(L.ConvolutionLayer)
class ConvolutionImpl(LayerImpl):
    def param_shapes(self):
        c = self.conf
        kh, kw = c.kernel_size
        return {"W": (kh, kw, c.n_in, c.n_out), "b": (c.n_out,)}

    def init_params(self, gen):
        c, dt = self.conf, self.policy.param_dtype
        kshape = self.param_shapes()["W"]
        fan_in, fan_out = conv_fans(kshape)
        W = init_weights(gen, kshape, c.weight_init.value, fan_in=fan_in,
                         fan_out=fan_out, distribution=c.dist, dtype=dt)
        return {"W": W, "b": torch.full((c.n_out,), c.bias_init, dtype=dt)}

    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        c, pol = self.conf, self.policy
        x = self.maybe_dropout(x, train=train, rng=rng)
        xc = pol.cast_compute(x).permute(0, 3, 1, 2)
        w = pol.cast_compute(params["W"]).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        kh, kw = c.kernel_size
        sh, sw = c.stride
        if c.convolution_mode == "same":
            (ht, hb), (wl, wr) = (same_pads(xc.shape[2], kh, sh),
                                  same_pads(xc.shape[3], kw, sw))
        else:
            (ht, hb), (wl, wr) = ((c.padding[0],) * 2, (c.padding[1],) * 2)
        if ht == hb and wl == wr:
            padding = (ht, wl)
        else:
            xc, padding = F.pad(xc, (wl, wr, ht, hb)), 0
        y = F.conv2d(xc, w, stride=(sh, sw), padding=padding)
        y = pol.cast_output(y.permute(0, 2, 3, 1)) + params["b"]
        return self.activation_fn()(y), state


@register_layer_impl(L.GlobalPoolingLayer)
class GlobalPoolingImpl(LayerImpl):
    """Mean/max/sum/pnorm over the spatial axes (NHWC [b,h,w,c] → [b,c]) or
    the time axis (RNN [b,t,f] → [b,f]); masked timesteps are left out."""

    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        c = self.conf
        m = None
        if x.ndim == 4:
            axes = (1, 2)
        elif x.ndim == 3:
            axes = (1,)
            if mask is not None:
                m = mask[..., None].to(x.dtype)
        else:
            raise ValueError(f"GlobalPooling expects rank 3/4 input, got {x.ndim}")
        pt = c.pooling_type
        if pt == PoolingType.MAX:
            if m is not None:
                x = torch.where(m > 0, x, -math.inf)
            y = torch.amax(x, dim=axes)
            if m is not None:
                # an example with no valid step gives 0, not -inf
                y = torch.where(torch.amax(m, dim=axes) > 0, y, 0.0)
        elif pt == PoolingType.SUM:
            y = torch.sum(x if m is None else x * m, dim=axes)
        elif pt == PoolingType.AVG:
            if m is None:
                y = torch.mean(x, dim=axes)
            else:
                y = torch.sum(x * m, dim=axes) / torch.clamp(
                    torch.sum(m, dim=axes), min=1.0)
        elif pt == PoolingType.PNORM:
            p = float(c.pnorm)
            if m is not None:
                x = x * m
            y = torch.sum(torch.abs(x) ** p, dim=axes) ** (1.0 / p)
        else:
            raise ValueError(f"unknown pooling type {pt}")
        return self.activation_fn()(y), state


@register_layer_impl(L.SubsamplingLayer)
class SubsamplingImpl(LayerImpl):
    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        c = self.conf
        k, s = tuple(c.kernel_size), tuple(c.stride)
        ph, pw = c.padding
        pt = c.pooling_type
        xc = x.permute(0, 3, 1, 2)
        if ph or pw:
            fill = -math.inf if pt == PoolingType.MAX else 0.0
            xc = F.pad(xc, (pw, pw, ph, ph), value=fill)
        if pt == PoolingType.MAX:
            y = F.max_pool2d(xc, k, s)
        elif pt == PoolingType.SUM:
            y = F.avg_pool2d(xc, k, s, divisor_override=1)
        elif pt == PoolingType.AVG:
            y = F.avg_pool2d(xc, k, s, divisor_override=k[0] * k[1])
        elif pt == PoolingType.PNORM:
            p = float(c.pnorm)
            y = F.avg_pool2d(torch.abs(xc) ** p, k, s,
                             divisor_override=1) ** (1.0 / p)
        else:
            raise ValueError(f"unknown pooling type {pt}")
        return self.activation_fn()(y.permute(0, 2, 3, 1)), state
