"""Dtype policy: parameters vs compute vs output dtypes, on torch dtypes.

Port of ``deeplearning4j_tpu/dtypes.py``. Parameters are kept in float32,
compute optionally runs in bfloat16 (tensor-core rate on Hopper), outputs
and losses are float32. The two bf16 flavours keep the reference's names:

- ``mixed_bfloat16`` / ``bf16`` — per-use casts (``cast_compute`` at every
  matmul operand).
- ``mixed_bf16`` — master weights: one bf16 parameter copy per step
  (``compute_copy``), grads upcast once (``master_grads``).

Parameter trees are nested dicts/lists of tensors (the reference's pytree
layout), walked by :func:`tree_map` and :func:`tree_leaves`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List

import torch


def tree_map(fn: Callable[[torch.Tensor], Any], tree):
    """Apply ``fn`` to every tensor leaf of a nested dict/list/tuple."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensor leaves of a nested dict/list/tuple, in the order
    :func:`tree_map` visits them."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    """Immutable dtype policy triple (plus the master-weights switch)."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32
    master_weights: bool = False

    def cast_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)

    def cast_output(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.output_dtype)

    def cast_param(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.param_dtype)

    def compute_copy(self, tree):
        """Compute-dtype copy of a parameter tree under master weights
        (identity otherwise)."""
        if not self.master_weights:
            return tree
        return tree_map(self.cast_compute, tree)

    def master_grads(self, tree):
        """Upcast a gradient tree to the param dtype once (identity when
        masters are off)."""
        if not self.master_weights:
            return tree
        return tree_map(lambda g: g.to(self.param_dtype), tree)

    def grad_zeros(self, params_tree):
        """Gradient-accumulation buffers in the param dtype."""
        return tree_map(
            lambda p: torch.zeros(p.shape, dtype=self.param_dtype,
                                  device=p.device), params_tree)


FLOAT32 = DtypePolicy(torch.float32, torch.float32, torch.float32)
MIXED_BF16 = DtypePolicy(torch.float32, torch.bfloat16, torch.float32)
MIXED_BF16_MASTER = DtypePolicy(torch.float32, torch.bfloat16, torch.float32,
                                master_weights=True)
FLOAT64 = DtypePolicy(torch.float64, torch.float64, torch.float64)


def policy_from_name(name: str) -> DtypePolicy:
    table = {
        "float32": FLOAT32,
        "f32": FLOAT32,
        "mixed_bfloat16": MIXED_BF16,
        "bf16": MIXED_BF16,
        "mixed_bf16": MIXED_BF16_MASTER,
        "float64": FLOAT64,
        "f64": FLOAT64,
    }
    key = name.lower()
    if key not in table:
        raise ValueError(f"unknown dtype policy {name!r}; one of {sorted(table)}")
    return table[key]
