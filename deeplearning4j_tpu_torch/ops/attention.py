"""Scaled dot-product / grouped-query attention ops (plain PyTorch).

Port of ``deeplearning4j_tpu/ops/attention.py``. Layouts are BTHD
(``[batch, time, heads, head_dim]``). Numerics follow the reference:
logits are float32 results of input-dtype operands (the reference's
``preferred_element_type=float32``; summed in float64 and rounded once,
see :func:`_mm_f32`), masked entries are filled with
``NEG_INF = -1e30`` (not ``-inf``), and the probabilities are cast to
``v.dtype`` before the PV product, whose float32 result is cast to
``v.dtype``.

The hand-written flash kernel (``kernels/flash_attention.py``) computes
the causal/windowed case of :func:`dot_product_attention` blockwise.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _lift_mask(mask: torch.Tensor, rank: int) -> torch.Tensor:
    """Broadcast a keep-mask to a logits rank: ``[b, t_kv]`` masks
    broadcast over heads and queries; ``[b, t_q, t_kv]`` per-query masks
    vary along the query axis too."""
    m = mask.to(torch.bool)
    if m.ndim == 2:                      # [b, k]
        idx = (slice(None),) + (None,) * (rank - 2) + (slice(None),)
    elif m.ndim == 3:                    # [b, q, k]
        idx = (slice(None),) + (None,) * (rank - 3) + \
            (slice(None), slice(None))
    else:
        raise ValueError(
            f"mask must be [b, t_kv] or [b, t_q, t_kv] (got {tuple(m.shape)})")
    return m[idx]


def causal_band_mask(tq: int, tkv: int, *, window: Optional[int] = None,
                     q_offset=0, k_offset=0, device=None) -> torch.Tensor:
    """``[tq, tkv]`` bool keep-mask for causal attention, optionally banded
    to the sliding window ``k in (q - window, q]``. Offsets are the
    absolute positions of q[0]/k[0]."""
    qi = q_offset + torch.arange(tq, device=device)[:, None]
    ki = k_offset + torch.arange(tkv, device=device)[None, :]
    keep = qi >= ki
    if window is not None:
        keep &= qi - ki < window
    return keep


def _mm_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Einsum with a float32 result from input-dtype operands, summed in
    float64 and rounded once to float32.

    The products of bf16 or f32 operands are exact in float64 and the
    sums keep ~29 more bits than float32, so the rounded result does not
    depend on the order of summation. On the card the matrix library
    picks that order (split-K and tile shapes) from the batch and the
    key length; in float32 the same decode row then rounds differently
    in a batch of 8 slots over a 1024-position pool than in a batch of
    one over a shorter cache, and greedy streams drift apart."""
    return torch.einsum(eq, a.double(), b.double()).float()


def _softmax_weights(logits: torch.Tensor, dtype: torch.dtype):
    """softmax of float32 logits, normalised in float64 (for the reason
    in :func:`_mm_f32`) and cast to the value dtype for the PV product."""
    return torch.softmax(logits.double(), dim=-1).to(dtype)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """softmax(q·kᵀ·scale + bias)·v. q: [b, tq, h, d]; k/v: [b, tkv, h, d]
    → [b, tq, h, d] in ``v.dtype``. ``window`` requires ``causal``."""
    if window is not None and (not causal or window < 1):
        raise ValueError("window requires causal=True and window >= 1")
    d = q.shape[-1]
    scale = scale if scale is not None else float(1.0 / math.sqrt(d))
    logits = _mm_f32("bqhd,bkhd->bhqk", q, k) * scale
    if bias is not None:
        logits = logits + bias
    if causal:
        logits = torch.where(
            causal_band_mask(q.shape[1], k.shape[1], window=window,
                             device=q.device), logits, NEG_INF)
    if mask is not None:
        logits = torch.where(_lift_mask(mask, 4), logits, NEG_INF)
    weights = _softmax_weights(logits, v.dtype)
    return _mm_f32("bhqk,bkhd->bqhd", weights, v).to(v.dtype)


def grouped_query_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """GQA/MQA: q [b, tq, H, d] against k/v [b, tkv, Hkv, d], H a multiple
    of Hkv; each kv head serves a group of query heads by broadcasting.
    Same numerics and masking as :func:`dot_product_attention`, to which
    it delegates when H == Hkv."""
    if window is not None and (not causal or window < 1):
        raise ValueError("window requires causal=True and window >= 1")
    b, tq, H, d = q.shape
    hkv = k.shape[2]
    if H == hkv:
        return dot_product_attention(q, k, v, causal=causal, mask=mask,
                                     scale=scale, window=window)
    if H % hkv:
        raise ValueError(f"num query heads {H} not a multiple of kv "
                         f"heads {hkv}")
    rep = H // hkv
    scale = scale if scale is not None else float(1.0 / math.sqrt(d))
    qg = q.reshape(b, tq, hkv, rep, d)
    logits = _mm_f32("bqhrd,bkhd->bhrqk", qg, k) * scale
    if causal:
        logits = torch.where(
            causal_band_mask(tq, k.shape[1], window=window,
                             device=q.device), logits, NEG_INF)
    if mask is not None:
        logits = torch.where(_lift_mask(mask, 5), logits, NEG_INF)
    weights = _softmax_weights(logits, v.dtype)
    o = _mm_f32("bhrqk,bkhd->bqhrd", weights, v).to(v.dtype)
    return o.reshape(b, tq, H, d)
