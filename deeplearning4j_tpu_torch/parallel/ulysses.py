"""Ulysses sequence parallelism: all-to-all head↔sequence resharding.

Port of ``deeplearning4j_tpu/parallel/ulysses.py`` (DeepSpeed-Ulysses).
Each rank of the ``sequence`` axis holds ``[B, T/P, H, D]``; an
all-to-all reshards to ``[B, T, H/P, D]`` (every rank sees the FULL
sequence for its subset of heads), plain softmax attention runs locally,
and a second all-to-all restores sequence sharding. Two collectives per
attention call against the ring's P hops — the better trade when heads
≥ ranks. The local attention stays plain torch, as it is plain XLA in
the reference; the reshards are :class:`collectives.AllToAllFn`, whose
backward is the opposite reshard.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops.attention import NEG_INF, causal_band_mask
from deeplearning4j_tpu_torch.parallel.collectives import AllToAllFn
from deeplearning4j_tpu_torch.parallel.mesh import (
    SEQUENCE_AXIS,
    axis_group,
    axis_size,
)


def _local_attention(q, k, v, *, causal: bool, t_offset_q=0, window=None):
    """Plain softmax attention on full-sequence blocks [B, T, h, D] in
    f32. ``window`` (requires causal) keeps k in ``(q - window, q]``."""
    scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1])))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = causal_band_mask(q.shape[1], k.shape[1], window=window,
                                q_offset=t_offset_q, device=q.device)
        logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def ulysses_attention(q, k, v, mesh, causal: bool = False,
                      axis_name: str = SEQUENCE_AXIS, window=None):
    """Self-attention over this rank's ``[B, T/P, H, D]`` sequence
    shards; returns its shard of the output. ``H`` must be divisible by
    the sequence-axis size. ``window`` (requires causal) applies
    sliding-window masking inside the local full-sequence attention."""
    if window is not None and (not causal or window < 1):
        raise ValueError("window requires causal=True and window >= 1")
    n_seq = axis_size(mesh, axis_name)
    if n_seq == 1:
        return _local_attention(q, k, v, causal=causal, window=window)
    if q.shape[2] % n_seq:
        raise ValueError(
            f"num_heads {q.shape[2]} not divisible by sequence-parallel "
            f"degree {n_seq}")
    group = axis_group(mesh, axis_name)
    qh, kh, vh = (AllToAllFn.apply(x, group, True) for x in (q, k, v))
    out = _local_attention(qh, kh, vh, causal=causal, window=window)
    return AllToAllFn.apply(out, group, False)


def ulysses_self_attention_sharded(mesh):
    """Convenience: ``fn(q, k, v, causal=False)`` bound to ``mesh``
    (mirrors ``ring_self_attention_sharded``)."""
    def fn(q, k, v, causal=False):
        return ulysses_attention(q, k, v, mesh, causal=causal)

    return fn
