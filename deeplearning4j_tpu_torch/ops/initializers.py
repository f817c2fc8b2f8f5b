"""Weight initialization schemes, drawn from an explicit ``torch.Generator``.

Port of ``deeplearning4j_tpu/ops/initializers.py`` (the reference's
``WeightInit`` enum, ``WeightInitUtil.java:81-106``). torch's streams
cannot equal ``jax.random``'s, so the port matches the reference in
distribution: the same family, mean, scale and bounds for each scheme and
fan. Weights that must equal the reference's come over from it through
``models/convert.py``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch


def _uniform(gen, shape, dtype, lo, hi):
    return torch.rand(shape, generator=gen, dtype=dtype) * (hi - lo) + lo


def _normal(gen, shape, dtype):
    return torch.randn(shape, generator=gen, dtype=dtype)


def init_weights(
    gen: torch.Generator,
    shape: Sequence[int],
    scheme: str = "XAVIER",
    fan_in: Optional[int] = None,
    fan_out: Optional[int] = None,
    distribution: Optional[dict] = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Sample a weight tensor on ``gen``'s device.

    ``fan_in``/``fan_out`` default to shape[0]/shape[-1] for 2-D matrices;
    conv layers pass receptive-field-scaled fans (:func:`conv_fans`).
    """
    shape = tuple(int(s) for s in shape)
    if fan_in is None:
        fan_in = shape[0] if len(shape) >= 1 else 1
    if fan_out is None:
        fan_out = shape[-1] if len(shape) >= 2 else shape[0]
    scheme = scheme.upper()

    if scheme == "ZERO":
        return torch.zeros(shape, dtype=dtype)
    if scheme == "ONES":
        return torch.ones(shape, dtype=dtype)
    if scheme == "UNIFORM":
        a = 1.0 / math.sqrt(float(fan_in))
        return _uniform(gen, shape, dtype, -a, a)
    if scheme == "XAVIER":
        return _normal(gen, shape, dtype) * math.sqrt(2.0 / (fan_in + fan_out))
    if scheme == "XAVIER_UNIFORM":
        a = math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(gen, shape, dtype, -a, a)
    if scheme == "RELU":
        return _normal(gen, shape, dtype) * math.sqrt(2.0 / fan_in)
    if scheme == "LECUN":
        return _normal(gen, shape, dtype) * math.sqrt(1.0 / fan_in)
    if scheme == "VI":
        r = 4.0 * math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(gen, shape, dtype, -r, r)
    if scheme == "SIZE":
        r = math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(gen, shape, dtype, -r, r)
    if scheme == "NORMALIZED":
        return (_uniform(gen, shape, dtype, 0.0, 1.0) - 0.5) / float(shape[0])
    if scheme == "DISTRIBUTION":
        return _from_distribution(gen, shape, distribution or {}, dtype)
    raise ValueError(f"unknown weight init scheme {scheme!r}")


def _from_distribution(gen, shape, dist: dict, dtype):
    """DISTRIBUTION init from a config dict (normal, uniform, binomial)."""
    kind = dist.get("type", "normal").lower()
    if kind in ("normal", "gaussian"):
        mean = float(dist.get("mean", 0.0))
        std = float(dist.get("std", dist.get("sd", 1.0)))
        return mean + std * _normal(gen, shape, dtype)
    if kind == "uniform":
        lower = float(dist.get("lower", -1.0))
        upper = float(dist.get("upper", 1.0))
        return _uniform(gen, shape, dtype, lower, upper)
    if kind == "binomial":
        n = int(dist.get("n", dist.get("numberOfTrials", 1)))
        p = float(dist.get("p", dist.get("probabilityOfSuccess", 0.5)))
        return torch.binomial(torch.full(shape, float(n)),
                              torch.full(shape, p), generator=gen).to(dtype)
    raise ValueError(f"unknown distribution {kind!r}")


def conv_fans(kernel_shape: Tuple[int, ...]) -> Tuple[int, int]:
    """fan_in/fan_out for a conv kernel in HWIO layout [kh, kw, in_c, out_c]."""
    receptive = 1
    for k in kernel_shape[:-2]:
        receptive *= int(k)
    return receptive * int(kernel_shape[-2]), receptive * int(kernel_shape[-1])
