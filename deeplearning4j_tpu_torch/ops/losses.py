"""Loss functions with masking support, on tensors.

Port of ``deeplearning4j_tpu/ops/losses.py``. Each per-example loss
reduces over the feature axis only; :func:`compute_loss` takes the
mask-weighted mean over examples (and timesteps), the reference's
minibatch-size division.

The clips are ``maximum``/``minimum`` pairs, not ``torch.clamp``: at a
tie (a softmax output of exactly 1.0, say) both halves take half the
gradient, as ``jnp.clip`` does, where ``clamp`` passes all of it. MCXENT
is softmax output → clip → log, kept as the reference has it rather
than ``log_softmax``: the clip changes the gradient near 0.
"""

from __future__ import annotations

import enum
from typing import Callable, Optional

import torch

_EPS = 1e-8


class LossFunction(str, enum.Enum):
    MSE = "MSE"
    SQUARED_LOSS = "SQUARED_LOSS"
    L1 = "L1"
    XENT = "XENT"  # binary cross entropy (sigmoid outputs)
    MCXENT = "MCXENT"  # multi-class cross entropy (softmax outputs)
    NEGATIVELOGLIKELIHOOD = "NEGATIVELOGLIKELIHOOD"
    RMSE_XENT = "RMSE_XENT"
    RECONSTRUCTION_CROSSENTROPY = "RECONSTRUCTION_CROSSENTROPY"
    EXPLL = "EXPLL"  # exponential log likelihood (Poisson-style)
    COSINE_PROXIMITY = "COSINE_PROXIMITY"
    HINGE = "HINGE"
    SQUARED_HINGE = "SQUARED_HINGE"
    KL_DIVERGENCE = "KL_DIVERGENCE"
    MEAN_ABSOLUTE_PERCENTAGE_ERROR = "MEAN_ABSOLUTE_PERCENTAGE_ERROR"
    POISSON = "POISSON"
    CUSTOM = "CUSTOM"


def _const(x: torch.Tensor, v: float) -> torch.Tensor:
    """A 0-dim constant beside ``x`` (a fill kernel, no host copy)."""
    return torch.full((), v, dtype=x.dtype, device=x.device)


def _clip(x, lo: Optional[float], hi: Optional[float]):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, ties split."""
    if lo is not None:
        x = torch.maximum(x, _const(x, lo))
    if hi is not None:
        x = torch.minimum(x, _const(x, hi))
    return x


def _mse(out, y):
    return torch.sum((out - y) ** 2, dim=-1) / out.shape[-1]


def _squared(out, y):
    return torch.sum((out - y) ** 2, dim=-1)


def _l1(out, y):
    return torch.sum(torch.abs(out - y), dim=-1)


def _xent(out, y):
    out = _clip(out, _EPS, 1.0 - _EPS)
    return -torch.sum(y * torch.log(out) + (1.0 - y) * torch.log1p(-out),
                      dim=-1)


def _mcxent(out, y):
    out = _clip(out, _EPS, 1.0)
    return -torch.sum(y * torch.log(out), dim=-1)


def _rmse_xent(out, y):
    return torch.sqrt(_mse(out, y) + _EPS)


def _expll(out, y):
    out = _clip(out, _EPS, None)
    return torch.sum(out - y * torch.log(out), dim=-1)


def _cosine(out, y):
    num = torch.sum(out * y, dim=-1)
    den = (torch.linalg.vector_norm(out, dim=-1)
           * torch.linalg.vector_norm(y, dim=-1) + _EPS)
    return -num / den


def _hinge(out, y):
    sign = torch.where(y > 0, 1.0, -1.0).to(out.dtype)
    return torch.sum(_clip(1.0 - sign * out, 0.0, None), dim=-1)


def _squared_hinge(out, y):
    sign = torch.where(y > 0, 1.0, -1.0).to(out.dtype)
    return torch.sum(_clip(1.0 - sign * out, 0.0, None) ** 2, dim=-1)


def _kld(out, y):
    out = _clip(out, _EPS, 1.0)
    yc = _clip(y, _EPS, 1.0)
    return torch.sum(yc * (torch.log(yc) - torch.log(out)), dim=-1)


def _mape(out, y):
    return (100.0 * torch.sum(torch.abs((y - out) / (torch.abs(y) + _EPS)),
                              dim=-1) / out.shape[-1])


def _poisson(out, y):
    out = _clip(out, _EPS, None)
    return torch.sum(out - y * torch.log(out), dim=-1)


_TABLE: dict[LossFunction, Callable] = {
    LossFunction.MSE: _mse,
    LossFunction.SQUARED_LOSS: _squared,
    LossFunction.L1: _l1,
    LossFunction.XENT: _xent,
    LossFunction.MCXENT: _mcxent,
    # NLL over softmax outputs is MCXENT in the reference
    LossFunction.NEGATIVELOGLIKELIHOOD: _mcxent,
    LossFunction.RMSE_XENT: _rmse_xent,
    LossFunction.RECONSTRUCTION_CROSSENTROPY: _xent,
    LossFunction.EXPLL: _expll,
    LossFunction.COSINE_PROXIMITY: _cosine,
    LossFunction.HINGE: _hinge,
    LossFunction.SQUARED_HINGE: _squared_hinge,
    LossFunction.KL_DIVERGENCE: _kld,
    LossFunction.MEAN_ABSOLUTE_PERCENTAGE_ERROR: _mape,
    LossFunction.POISSON: _poisson,
}

_CUSTOM: dict[str, Callable] = {}


def register_loss(name: str, fn: Callable) -> None:
    """Register a CUSTOM loss: fn(output, labels) -> per-example scores."""
    _CUSTOM[name] = fn


def per_example_loss(loss, output, labels, custom_name: Optional[str] = None):
    """Unreduced per-example scores ([batch] or [batch, time])."""
    if isinstance(loss, str):
        loss = LossFunction(loss)
    if loss is LossFunction.CUSTOM:
        if custom_name is None or custom_name not in _CUSTOM:
            raise ValueError(
                f"CUSTOM loss requires a registered name, got {custom_name!r}")
        return _CUSTOM[custom_name](output, labels)
    return _TABLE[loss](output, labels)


def compute_loss(loss, output: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None,
                 custom_name: Optional[str] = None) -> torch.Tensor:
    """Mask-weighted mean per-example loss (0-dim tensor).

    ``mask`` is broadcastable to the per-example score shape ([batch] or
    [batch, time]); masked-out entries contribute nothing and the mean is
    over the mask sum.
    """
    per_example = per_example_loss(loss, output, labels, custom_name)
    if mask is None:
        return torch.mean(per_example)
    mask = torch.as_tensor(mask, dtype=per_example.dtype,
                           device=per_example.device)
    mask = mask.reshape(mask.shape + (1,) * (per_example.ndim - mask.ndim))
    mask = torch.broadcast_to(mask, per_example.shape)
    total = torch.sum(per_example * mask)
    denom = _clip(torch.sum(mask), 1.0, None)
    return total / denom
