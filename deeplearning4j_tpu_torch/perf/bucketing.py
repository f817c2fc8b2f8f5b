"""Prompt-length ladder for the serving prefill (copy of the jax-free part
of ``deeplearning4j_tpu/perf/bucketing.py``).

A causal decoder prefill may pad its prompt: position i attends keys
0..i only, so tokens past the prompt never reach the real positions, and
the decode mask excludes the pad tail of the KV pool until generated
tokens overwrite it. Padding prompts up a powers-of-two ladder bounds the
number of distinct prefill shapes (on the card: the shapes the kernels
and the matmul library see) at the ladder length.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

DEFAULT_BATCH_BUCKETS: Tuple[int, ...] = (
    1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)

DEFAULT_PROMPT_BUCKETS: Tuple[int, ...] = (
    16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def bucketing_enabled() -> bool:
    """Kill switch: ``DL4J_DISABLE_BUCKETING=1`` makes every bucket exact."""
    return os.environ.get("DL4J_DISABLE_BUCKETING", "") != "1"


def bucket_size(n: int, buckets: Optional[Sequence[int]] = None) -> int:
    """Smallest ladder rung >= n (n itself when bucketing is disabled);
    beyond the ladder, a multiple of the top rung."""
    if n <= 0 or not bucketing_enabled():
        return n
    for b in (buckets or DEFAULT_BATCH_BUCKETS):
        if n <= b:
            return int(b)
    top = int((buckets or DEFAULT_BATCH_BUCKETS)[-1])
    return ((n + top - 1) // top) * top


def prompt_bucket(n: int, buckets: Optional[Sequence[int]] = None,
                  max_len: Optional[int] = None) -> int:
    """Smallest prompt-ladder rung >= ``n``, capped at ``max_len`` (the
    server's slot capacity)."""
    if n <= 0:
        raise ValueError(f"prompt length must be >= 1 (got {n})")
    if max_len is not None and n > max_len:
        raise ValueError(f"prompt length {n} exceeds max_len={max_len}")
    if not bucketing_enabled():
        return n
    b = bucket_size(n, buckets or DEFAULT_PROMPT_BUCKETS)
    return b if max_len is None else min(b, max_len)


def pad_prompt(tokens, bucket: int, pad_id: int = 0):
    """Right-pad token rows ([t] or [b, t] int) to ``bucket`` positions.
    Returns ``(padded, length)`` with ``length`` the real prompt length."""
    a = np.asarray(tokens)
    t = int(a.shape[-1])
    if t > bucket:
        raise ValueError(f"prompt length {t} exceeds bucket {bucket}")
    widths = [(0, 0)] * (a.ndim - 1) + [(0, bucket - t)]
    return np.pad(a, widths, constant_values=pad_id), t
