"""Slot-based batched KV cache: the device-resident state of the server.

Port of ``deeplearning4j_tpu/serving/kv_cache.py``. One ``[L, S, T_max,
Hkv, Dh]`` pair of K/V tensors lives on the card for the server's
lifetime; each of the S slots holds one in-flight request at its own
decode position (slot lifecycle and masking rules as in the reference:
a slot's keys beyond its cursor are never attended, so stale contents
of a recycled slot are unreachable).

The pool is updated IN PLACE: the prefill copies a prompt's K/V into
its slot's slice and the decode step scatters each consumed token's K/V
with ``index_put_``. That replaces the reference's buffer donation
(``donate_argnums``), which existed so that XLA could reuse the pool's
memory across immutable program calls.

Quantized pool (``kv_dtype="int8"`` / ``DL4J_SERVE_KV_DTYPE``): per-(layer,
slot, head) absmax scales in f32 beside the pool; a write whose absmax
exceeds the stored scale requantizes that slot-head's entries first
(:func:`requant_write_slab`), so streamed writes never clip.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

__all__ = [
    "SlotKVCache",
    "resolve_kv_dtype",
    "kv_pool_nbytes",
    "max_slots_in_budget",
    "dequant_slab",
    "requant_write_slab",
]

_KV_DTYPES = ("float32", "bfloat16", "int8")
_ALIASES = {"f32": "float32", "bf16": "bfloat16"}
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.int8, "float64": torch.float64}
_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def resolve_kv_dtype(kv_dtype: Optional[str], model) -> str:
    """Canonical store-dtype name: an explicit ``kv_dtype`` wins, else
    ``DL4J_SERVE_KV_DTYPE``, else the model's compute dtype."""
    raw = kv_dtype
    if raw is None:
        raw = os.environ.get("DL4J_SERVE_KV_DTYPE", "").strip() or None
    if raw is None:
        return _NAMES[model.policy.compute_dtype]
    name = _ALIASES.get(str(raw).lower(), str(raw).lower())
    if name not in _KV_DTYPES:
        raise ValueError(
            f"kv_dtype={raw!r} must be one of {_KV_DTYPES} "
            "(DL4J_SERVE_KV_DTYPE)")
    return name


def _elem_bytes(name: str) -> int:
    return torch.empty((), dtype=_TORCH_DTYPES[name]).element_size()


def _pool_dims(model, slots: int, max_len: int):
    dh = model.d_model // model.num_heads
    return (model.num_layers, slots, max_len, model.num_kv_heads, dh)


def kv_pool_nbytes(model, slots: int, max_len: Optional[int] = None,
                   kv_dtype: Optional[str] = None) -> int:
    """Analytic device footprint of the K/V pool pair (+ int8 scales);
    equals ``SlotKVCache.nbytes``."""
    name = resolve_kv_dtype(kv_dtype, model)
    ll, ss, tt, hkv, dh = _pool_dims(model, slots,
                                     int(max_len or model.max_len))
    total = 2 * ll * ss * tt * hkv * dh * _elem_bytes(name)
    if name == "int8":
        total += 2 * ll * ss * hkv * 4  # f32 per-(layer, slot, head) scales
    return total


def max_slots_in_budget(model, max_len: int, budget_bytes: int,
                        kv_dtype: Optional[str] = None) -> int:
    """How many concurrent slots a device-memory budget holds at
    ``max_len`` context."""
    per_slot = kv_pool_nbytes(model, 1, max_len, kv_dtype)
    return max(0, int(budget_bytes) // per_slot)


# ---------------------------------------------------------------------------
# int8 codec
# ---------------------------------------------------------------------------
def dequant_slab(slab: torch.Tensor, scale: Optional[torch.Tensor],
                 dtype: torch.dtype) -> torch.Tensor:
    """Dequantize one layer's slab ``[S, T, Hkv, Dh]`` to ``dtype``.
    ``scale is None`` = unquantized store (cast only if needed)."""
    if scale is None:
        return slab if slab.dtype == dtype else slab.to(dtype)
    return (slab.float() * (scale[:, None, :, None] / 127.0)).to(dtype)


def requant_write_slab(slab: torch.Tensor, scale: Optional[torch.Tensor],
                       values: torch.Tensor, rows: torch.Tensor,
                       positions: torch.Tensor):
    """Write ``values [S, q, Hkv, Dh]`` at ``(rows [S], positions [S, q])``
    into one layer's slab, in place; returns ``(slab, scale)``.

    int8: per-(slot, head) running-absmax scales. The slot-heads whose
    scale grows are requantized to the grown scale (the others multiply
    by exactly 1.0, an identity on int8 values), then the new values
    quantize and scatter. Positions must lie inside the slab."""
    if scale is None:
        slab[rows[:, None], positions] = values.to(slab.dtype)
        return slab, None
    vals = values.float()
    m = vals.abs().amax(dim=(1, 3))                         # [S, Hkv]
    new_scale = torch.maximum(scale, m)
    denom = torch.where(new_scale > 0, new_scale, 1.0)
    factor = torch.where(new_scale > 0, scale / denom, 1.0)
    slab.copy_(torch.round(slab.float() * factor[:, None, :, None]))
    q = torch.clamp(torch.round(vals / denom[:, None, :, None] * 127.0),
                    -127, 127).to(torch.int8)
    slab[rows[:, None], positions] = q
    scale.copy_(new_scale)
    return slab, scale


class SlotKVCache:
    """``[L, S, T_max, Hkv, Dh]`` K/V pools + per-slot cursors, on the
    model's device."""

    # the slot pool is single-replica device state
    n_shard = 1

    def __init__(self, model, slots: int, max_len: Optional[int] = None,
                 kv_dtype: Optional[str] = None):
        if slots < 1:
            raise ValueError(f"slots={slots} must be >= 1")
        self.slots = int(slots)
        self.max_len = int(max_len or model.max_len)
        if self.max_len < 2:
            raise ValueError(f"max_len={self.max_len} must be >= 2")
        if (model.pos_encoding == "learned"
                and self.max_len > model.max_len):
            raise ValueError(
                f"max_len={self.max_len} exceeds the model's learned "
                f"position table ({model.max_len}); use "
                "pos_encoding='rope' to serve past it")
        self.kv_dtype = resolve_kv_dtype(kv_dtype, model)
        dev = model.device
        shape = _pool_dims(model, self.slots, self.max_len)
        store = _TORCH_DTYPES[self.kv_dtype]
        self.k = torch.zeros(shape, dtype=store, device=dev)
        self.v = torch.zeros(shape, dtype=store, device=dev)
        self.k_scale = self.v_scale = None
        if self.kv_dtype == "int8":
            sshape = shape[:2] + (shape[3],)
            self.k_scale = torch.zeros(sshape, dtype=torch.float32, device=dev)
            self.v_scale = torch.zeros(sshape, dtype=torch.float32, device=dev)
        # per-slot write cursor: the position the NEXT consumed token's K/V
        # lands at. Device state: the fused decode advances it on the card;
        # the host writes it at admission and never reads it in the loop.
        self.cursors = torch.zeros(self.slots, dtype=torch.long, device=dev)

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def set_cursor(self, slot: int, value: int) -> None:
        """Admission-boundary cursor write (prefill lands a request)."""
        self.cursors[slot] = int(value)

    def advance(self, live_mask) -> None:
        """Unfused (K=1) path: advance live slots' cursors by one."""
        self.cursors += torch.as_tensor(
            np.asarray(live_mask, np.int64), device=self.cursors.device)

    @property
    def nbytes(self) -> int:
        """Device footprint of the pool state, scales included."""
        tensors = [self.k, self.v]
        if self.quantized:
            tensors += [self.k_scale, self.v_scale]
        return sum(t.numel() * t.element_size() for t in tensors)

    @property
    def per_slot_nbytes(self) -> int:
        return self.nbytes // self.slots
