"""DataSet: the batch container.

Port of ``deeplearning4j_tpu/datasets/dataset.py`` (nd4j's
``DataSet``): features + labels (+ per-example or
per-timestep masks for variable-length series). Values are numpy arrays
or torch tensors and stay what they are: a batch already on the card is
not copied back, and the network moves a host batch to its device once
per step.

Layouts: FF [b, f]; RNN [b, t, f] (batch-major, time second); CNN NHWC
[b, h, w, c].
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def _as_batch_array(a):
    """Keep arrays and tensors as they are (a tensor on the card stays
    there); lists and scalars become numpy arrays."""
    if a is None:
        return None
    return a if hasattr(a, "dtype") and hasattr(a, "shape") else np.asarray(a)


def _concat(parts):
    """``np.concatenate``, or ``torch.cat`` for tensors."""
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(list(parts))
    return np.concatenate(parts)


class DataSet:
    def __init__(self, features, labels=None, features_mask=None, labels_mask=None):
        self.features = _as_batch_array(features)
        self.labels = _as_batch_array(labels)
        self.features_mask = _as_batch_array(features_mask)
        self.labels_mask = _as_batch_array(labels_mask)

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    # --- reference API surface ---
    def get_features(self):
        return self.features

    def get_labels(self):
        return self.labels

    def slice_time(self, start: int, end: int) -> "DataSet":
        """Time-axis slice for TBPTT (features/labels [b, t, ...])."""
        f = self.features[:, start:end]
        l = self.labels[:, start:end] if self.labels is not None and self.labels.ndim == 3 else self.labels
        fm = self.features_mask[:, start:end] if self.features_mask is not None else None
        lm = self.labels_mask[:, start:end] if self.labels_mask is not None else None
        return DataSet(f, l, fm, lm)

    def sample(self, n: int, rng: Optional[np.random.Generator] = None) -> "DataSet":
        rng = rng or np.random.default_rng()
        idx = rng.choice(self.num_examples(), size=n, replace=n > self.num_examples())
        return self._take(idx)

    def shuffle(self, seed: Optional[int] = None) -> None:
        rng = np.random.default_rng(seed)
        idx = rng.permutation(self.num_examples())
        self.features = self.features[idx]
        if self.labels is not None:
            self.labels = self.labels[idx]
        if self.features_mask is not None:
            self.features_mask = self.features_mask[idx]
        if self.labels_mask is not None:
            self.labels_mask = self.labels_mask[idx]

    def split_test_and_train(self, n_train: int) -> Tuple["DataSet", "DataSet"]:
        return self._take(np.arange(n_train)), self._take(
            np.arange(n_train, self.num_examples()))

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        return [
            self._take(np.arange(i, min(i + batch_size, self.num_examples())))
            for i in range(0, self.num_examples(), batch_size)
        ]

    def _take(self, idx) -> "DataSet":
        return DataSet(
            self.features[idx],
            None if self.labels is None else self.labels[idx],
            None if self.features_mask is None else self.features_mask[idx],
            None if self.labels_mask is None else self.labels_mask[idx],
        )

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        return DataSet(
            _concat([d.features for d in datasets]),
            None if datasets[0].labels is None else _concat([d.labels for d in datasets]),
            None if datasets[0].features_mask is None else _concat([d.features_mask for d in datasets]),
            None if datasets[0].labels_mask is None else _concat([d.labels_mask for d in datasets]),
        )

    def scale_minus_one_to_one(self):
        lo, hi = self.features.min(), self.features.max()
        self.features = 2.0 * (self.features - lo) / max(hi - lo, 1e-12) - 1.0

    def normalize_zero_mean_unit_variance(self):
        f = self.features
        mean = f.mean(axis=0, keepdims=True)
        if isinstance(f, torch.Tensor):  # numpy's std: ddof 0
            std = f.std(dim=0, keepdim=True, correction=0)
        else:
            std = f.std(axis=0, keepdims=True)
        self.features = (f - mean) / (std + 1e-12)

    def __repr__(self):
        return (f"DataSet(features={self.features.shape}, "
                f"labels={None if self.labels is None else self.labels.shape})")


class MultiDataSet:
    """Multiple ordered inputs + outputs (ComputationGraph batches), on
    numpy arrays or tensors as :class:`DataSet` takes them."""

    def __init__(self, features: Sequence, labels: Sequence,
                 features_masks: Optional[Sequence] = None,
                 labels_masks: Optional[Sequence] = None):
        self.features = [_as_batch_array(f) for f in features]
        self.labels = [_as_batch_array(l) for l in labels]
        self.features_masks = (
            None if features_masks is None
            else [_as_batch_array(m) for m in features_masks]
        )
        self.labels_masks = (
            None if labels_masks is None
            else [_as_batch_array(m) for m in labels_masks]
        )

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])

    @staticmethod
    def from_dataset(ds: DataSet) -> "MultiDataSet":
        return MultiDataSet(
            [ds.features], [ds.labels],
            None if ds.features_mask is None else [ds.features_mask],
            None if ds.labels_mask is None else [ds.labels_mask],
        )
