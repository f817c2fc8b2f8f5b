"""Evaluation / ConfusionMatrix / RegressionEvaluation implementations."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


class ConfusionMatrix:
    """Counts of (actual, predicted) pairs (eval/ConfusionMatrix.java).

    Array-backed: one [C, C] int64 grid, so lookups are O(1), row/column
    totals are O(C), and whole-batch count arrays (numpy bincount or the
    device confusion matrix readback) fold in as a single vectorized add —
    the dict-of-dicts walk the reference uses is O(C²) per ``to_array``
    and O(batch) python-loop ``add`` calls per eval. Classes outside the
    declared range grow the grid (the dict accepted them silently)."""

    def __init__(self, classes: Sequence[int]):
        self.classes = list(classes)
        n = len(self.classes)
        self._counts = np.zeros((n, n), np.int64)

    def _ensure_size(self, idx: int):
        n = self._counts.shape[0]
        if idx < n:
            return
        grown = np.zeros((idx + 1, idx + 1), np.int64)
        grown[:n, :n] = self._counts
        self._counts = grown
        self.classes.extend(range(n, idx + 1))

    def add(self, actual: int, predicted: int, count: int = 1):
        a, p = int(actual), int(predicted)
        self._ensure_size(max(a, p))
        self._counts[a, p] += count

    def add_array(self, counts: np.ndarray):
        """Fold a [C', C'] count grid in (vectorized ``add``)."""
        counts = np.asarray(counts, np.int64)
        self._ensure_size(counts.shape[0] - 1)
        self._counts[:counts.shape[0], :counts.shape[1]] += counts

    def get_count(self, actual: int, predicted: int) -> int:
        a, p = int(actual), int(predicted)
        if a >= self._counts.shape[0] or p >= self._counts.shape[1]:
            return 0
        return int(self._counts[a, p])

    def actual_total(self, actual: int) -> int:
        a = int(actual)
        if a >= self._counts.shape[0]:
            return 0
        return int(self._counts[a].sum())

    def predicted_total(self, predicted: int) -> int:
        p = int(predicted)
        if p >= self._counts.shape[1]:
            return 0
        return int(self._counts[:, p].sum())

    @property
    def matrix(self):
        """Dict-of-dicts view of the nonzero counts — the seed's internal
        representation, kept read-only for callers that iterate it."""
        out: dict = {}
        for a, p in zip(*np.nonzero(self._counts)):
            out.setdefault(int(a), {})[int(p)] = int(self._counts[a, p])
        return out

    def merge(self, other: "ConfusionMatrix"):
        self.add_array(other._counts)

    def to_array(self) -> np.ndarray:
        n = len(self.classes)
        if self._counts.shape[0] == n:
            return self._counts.copy()
        out = np.zeros((n, n), np.int64)
        m = min(n, self._counts.shape[0])
        out[:m, :m] = self._counts[:m, :m]
        return out


class Evaluation:
    """Multi-class classification metrics (eval/Evaluation.java)."""

    def __init__(self, num_classes: Optional[int] = None,
                 labels: Optional[List[str]] = None):
        self.num_classes = num_classes
        self.label_names = labels
        self.confusion: Optional[ConfusionMatrix] = None

    def _ensure(self, n: int):
        if self.confusion is None:
            self.num_classes = self.num_classes or n
            self.confusion = ConfusionMatrix(list(range(self.num_classes)))

    def eval(self, labels: np.ndarray, predictions: np.ndarray,
             mask: Optional[np.ndarray] = None):
        """labels/predictions: one-hot or probability arrays [b, c] or
        time-series [b, t, c]; mask [b] / [b, t]."""
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 3:  # flatten time into batch, honoring the mask
            b, t, c = labels.shape
            labels = labels.reshape(b * t, c)
            predictions = predictions.reshape(b * t, c)
            if mask is not None:
                mask = np.asarray(mask).reshape(b * t)
        self._ensure(labels.shape[-1])
        actual = np.argmax(labels, axis=-1)
        predicted = np.argmax(predictions, axis=-1)
        if mask is not None:
            keep = np.asarray(mask).astype(bool)
            actual, predicted = actual[keep], predicted[keep]
        # one bincount over actual*C + predicted replaces the per-example
        # python loop; C covers any out-of-range class so the flat index
        # stays collision-free (add_array grows the grid to match)
        c = max(int(self.num_classes),
                int(actual.max()) + 1 if actual.size else 0,
                int(predicted.max()) + 1 if predicted.size else 0)
        flat = actual.astype(np.int64) * c + predicted.astype(np.int64)
        counts = np.bincount(flat, minlength=c * c).reshape(c, c)
        self.confusion.add_array(counts)

    def eval_confusion(self, counts):
        """Fold a precomputed [C, C] count grid (rows=actual) into this
        Evaluation — the fold-in point for the DEVICE confusion matrix
        read back once per ``evaluate()`` call (perf/device_eval)."""
        counts = np.asarray(counts)
        self._ensure(counts.shape[0])
        self.confusion.add_array(counts)

    # --- per-class counts ---
    def true_positives(self, cls: int) -> int:
        return self.confusion.get_count(cls, cls)

    def false_positives(self, cls: int) -> int:
        return self.confusion.predicted_total(cls) - self.true_positives(cls)

    def false_negatives(self, cls: int) -> int:
        return self.confusion.actual_total(cls) - self.true_positives(cls)

    # --- aggregate metrics ---
    def accuracy(self) -> float:
        total = sum(self.confusion.actual_total(c) for c in self.confusion.classes)
        correct = sum(self.true_positives(c) for c in self.confusion.classes)
        return correct / total if total else 0.0

    def precision(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            tp, fp = self.true_positives(cls), self.false_positives(cls)
            return tp / (tp + fp) if tp + fp else 0.0
        vals = [self.precision(c) for c in self.confusion.classes
                if self.confusion.actual_total(c) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            tp, fn = self.true_positives(cls), self.false_negatives(cls)
            return tp / (tp + fn) if tp + fn else 0.0
        vals = [self.recall(c) for c in self.confusion.classes
                if self.confusion.actual_total(c) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        p, r = self.precision(cls), self.recall(cls)
        return 2 * p * r / (p + r) if p + r else 0.0

    def merge(self, other: "Evaluation"):
        """Distributed eval reduce (Evaluation.merge :684)."""
        if other.confusion is None:
            return self
        if self.confusion is None:
            self.num_classes = other.num_classes
            self.confusion = ConfusionMatrix(list(range(other.num_classes)))
        self.confusion.merge(other.confusion)
        return self

    def stats(self) -> str:
        """Text report (Evaluation.stats())."""
        if self.confusion is None:
            return "Evaluation: no data"
        lines = ["==========================Scores========================================"]
        lines.append(f" Accuracy:  {self.accuracy():.4f}")
        lines.append(f" Precision: {self.precision():.4f}")
        lines.append(f" Recall:    {self.recall():.4f}")
        lines.append(f" F1 Score:  {self.f1():.4f}")
        lines.append("========================================================================")
        lines.append("Confusion matrix (rows=actual, cols=predicted):")
        arr = self.confusion.to_array()
        for i, row in enumerate(arr):
            name = (self.label_names[i] if self.label_names
                    and i < len(self.label_names) else str(i))
            lines.append(f"  {name:>8}: " + " ".join(f"{v:6d}" for v in row))
        return "\n".join(lines)


class RegressionEvaluation:
    """Per-column regression metrics (eval/RegressionEvaluation.java)."""

    def __init__(self, num_columns: Optional[int] = None):
        self.num_columns = num_columns
        self._labels: List[np.ndarray] = []
        self._preds: List[np.ndarray] = []

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels, np.float64)
        predictions = np.asarray(predictions, np.float64)
        if labels.ndim == 3:
            b, t, c = labels.shape
            labels = labels.reshape(b * t, c)
            predictions = predictions.reshape(b * t, c)
            if mask is not None:
                keep = np.asarray(mask).reshape(b * t).astype(bool)
                labels, predictions = labels[keep], predictions[keep]
        elif mask is not None:
            keep = np.asarray(mask).astype(bool)
            labels, predictions = labels[keep], predictions[keep]
        self._labels.append(labels)
        self._preds.append(predictions)

    def _stacked(self):
        return np.concatenate(self._labels), np.concatenate(self._preds)

    def mean_squared_error(self, col: int) -> float:
        y, p = self._stacked()
        return float(np.mean((y[:, col] - p[:, col]) ** 2))

    def mean_absolute_error(self, col: int) -> float:
        y, p = self._stacked()
        return float(np.mean(np.abs(y[:, col] - p[:, col])))

    def root_mean_squared_error(self, col: int) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def correlation_r2(self, col: int) -> float:
        y, p = self._stacked()
        ss_res = np.sum((y[:, col] - p[:, col]) ** 2)
        ss_tot = np.sum((y[:, col] - np.mean(y[:, col])) ** 2)
        return float(1.0 - ss_res / ss_tot) if ss_tot else 0.0

    def pearson_correlation(self, col: int) -> float:
        y, p = self._stacked()
        if np.std(y[:, col]) == 0 or np.std(p[:, col]) == 0:
            return 0.0
        return float(np.corrcoef(y[:, col], p[:, col])[0, 1])

    def stats(self) -> str:
        y, _ = self._stacked()
        cols = y.shape[1]
        lines = ["Column    MSE        MAE        RMSE       R^2        Corr"]
        for c in range(cols):
            lines.append(
                f"{c:6d} {self.mean_squared_error(c):10.5f} "
                f"{self.mean_absolute_error(c):10.5f} "
                f"{self.root_mean_squared_error(c):10.5f} "
                f"{self.correlation_r2(c):10.5f} "
                f"{self.pearson_correlation(c):10.5f}"
            )
        return "\n".join(lines)
