"""Shape buckets: the batch ladder for training data and the prompt
ladder for the serving prefill (port of ``deeplearning4j_tpu/perf/
bucketing.py``).

Batch axis: :func:`pad_dataset` pads a batch up the ladder with zero rows
and a labels mask that is zero on them, so the pad rows drop out of every
mask-weighted loss. On the card a shape costs what a compile costs the
reference: each distinct batch shape of a fused path is one CUDA-graph
capture (``perf/step_graph.py``), so the epoch cache pads every batch to
one bucket and ``BucketedDataSetIterator`` pads a stream's ragged tail.
Train-mode BatchNorm takes its statistics over all rows, pad rows
included, as in the reference.

Prompts: a causal decoder prefill may pad its prompt: position i attends
keys 0..i only, so tokens past the prompt never reach the real positions,
and the decode mask excludes the pad tail of the KV pool until generated
tokens overwrite it. Padding prompts up a powers-of-two ladder bounds the
number of distinct prefill shapes at the ladder length.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

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


def pad_axis0(a, target: int):
    """Zero-pad the batch axis up to ``target`` rows: a numpy array with
    numpy, a tensor with torch on its own device."""
    if a is None:
        return None
    n = int(a.shape[0])
    if n >= target:
        return a
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a.new_zeros((target - n,) + tuple(a.shape[1:]))])
    a = np.asarray(a)
    return np.pad(a, [(0, target - n)] + [(0, 0)] * (a.ndim - 1))


def padded_label_mask(labels, labels_mask, target: int):
    """The labels mask that makes pad rows inert: the existing mask (or
    ones) as float32, extended with zeros to ``target`` rows. ``[b]`` for
    ``[b, c]`` labels, ``[b, t]`` for ``[b, t, c]``. Tensor labels give a
    tensor on their device, numpy labels a numpy array."""
    b = int(labels.shape[0])
    if isinstance(labels, torch.Tensor):
        if labels_mask is None:
            shape = (b,) if labels.ndim == 2 else (b, int(labels.shape[1]))
            labels_mask = torch.ones(shape, dtype=torch.float32,
                                     device=labels.device)
        else:
            labels_mask = torch.as_tensor(labels_mask).to(
                labels.device, torch.float32)
    elif labels_mask is None:
        shape = (b,) if labels.ndim == 2 else (b, int(labels.shape[1]))
        labels_mask = np.ones(shape, np.float32)
    else:
        labels_mask = np.asarray(labels_mask, np.float32)
    return pad_axis0(labels_mask, target)


def pad_dataset(ds, buckets: Optional[Sequence[int]] = None):
    """A DataSet with its batch axis padded to its bucket: features and
    labels with zero rows, and the labels mask always present (ones where
    absent) so that full batches and a padded tail have one signature.
    The features mask pads only when present (making one up would change
    a recurrent forward)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    b = bucket_size(int(ds.features.shape[0]), buckets)
    if ds.labels is None:
        return DataSet(pad_axis0(ds.features, b), None,
                       pad_axis0(ds.features_mask, b), None)
    return DataSet(pad_axis0(ds.features, b), pad_axis0(ds.labels, b),
                   pad_axis0(ds.features_mask, b),
                   padded_label_mask(ds.labels, ds.labels_mask, b))


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
