"""Activation registry on tensors.

Port of ``deeplearning4j_tpu/ops/activations.py``: the config DSL names
(``activation("tanh")`` etc.) map to torch functions with the reference's
semantics. Two names differ from torch's defaults and keep the
reference's meaning:

- ``gelu`` is ``jax.nn.gelu``, whose default is the tanh approximation;
- ``hardsigmoid`` is DL4J's ``clip(0.2x + 0.5, 0, 1)``, not
  ``F.hardsigmoid``'s ``x/6 + 0.5``.

``leakyrelu`` is a ``where`` on ``x >= 0`` so its gradient at 0 is the
reference's (1), where ``F.leaky_relu`` gives the slope.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

Activation = Callable[[torch.Tensor], torch.Tensor]


def _identity(x):
    return x


def _leakyrelu(x, alpha=0.01):
    return torch.where(x >= 0, x, alpha * x)


def _softsign(x):
    return x / (1.0 + torch.abs(x))


def _hardtanh(x):
    return torch.clamp(x, -1.0, 1.0)


def _hardsigmoid(x):
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def _cube(x):
    return x * x * x


def _rationaltanh(x):
    a = 0.6666667 * x
    return 1.7159 * a / (1.0 + torch.abs(a))


_REGISTRY: Dict[str, Activation] = {
    "identity": _identity,
    "linear": _identity,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "relu6": F.relu6,
    "leakyrelu": _leakyrelu,
    "elu": F.elu,
    "selu": F.selu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "swish": F.silu,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "logsoftmax": lambda x: torch.log_softmax(x, dim=-1),
    "softsign": _softsign,
    "softplus": F.softplus,
    "hardtanh": _hardtanh,
    "hardsigmoid": _hardsigmoid,
    "cube": _cube,
    "rationaltanh": _rationaltanh,
    "abs": torch.abs,
    "sign": torch.sign,
    "exp": torch.exp,
}


def get_activation(name: str) -> Activation:
    """Look up an activation by its config-DSL name (case-insensitive)."""
    fn = _REGISTRY.get(name.lower())
    if fn is None:
        raise ValueError(
            f"unknown activation {name!r}; known: {sorted(_REGISTRY)}")
    return fn


def activation_names() -> list[str]:
    return sorted(_REGISTRY)


def register_activation(name: str, fn: Activation) -> None:
    """Register a custom activation (the reference's CUSTOM escape hatch)."""
    _REGISTRY[name.lower()] = fn
