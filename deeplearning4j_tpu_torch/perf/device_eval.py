"""On-device metric accumulation for ``evaluate()``.

Port of ``deeplearning4j_tpu/perf/device_eval.py``. A ``[C, C]``
confusion matrix (int32) and per-column regression sums stay on the
network's device across a whole iterator, updated per batch by a masked
argmax and a scatter-add; ``evaluate()`` reads back one small array per
call instead of every batch's ``[B, C]`` outputs.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _flatten_time(output, labels, mask):
    """[b, t, c] -> [b*t, c] (mask [b, t] -> [b*t]), as the host
    ``Evaluation.eval`` folds time into batch."""
    if output.ndim == 3:
        b, t, c = output.shape
        output = output.reshape(b * t, c)
        labels = labels.reshape(b * t, c)
        if mask is not None:
            mask = mask.reshape(b * t)
    return output, labels, mask


def confusion_update(cm: torch.Tensor, output, labels, mask=None):
    """One batch folded into the confusion matrix (rows = actual, columns =
    predicted). ``mask`` [b] / [b, t], nonzero = keep: masked rows add 0."""
    output, labels, mask = _flatten_time(output, labels, mask)
    predicted = torch.argmax(output, dim=-1)
    actual = torch.argmax(labels, dim=-1)
    if mask is None:
        w = torch.ones(predicted.shape, dtype=cm.dtype, device=cm.device)
    else:
        w = (mask != 0).to(cm.dtype)
    c = cm.shape[1]
    return cm.reshape(-1).index_add(0, actual * c + predicted, w).reshape(
        cm.shape)


# Per-column sufficient statistics in Welford/Chan form: {n, mean,
# M2 (centered second moment), C (centered co-moment)} plus the error
# sums Σ|y-p| and Σ(y-p)². MSE/MAE/RMSE/R²/Pearson derive from these
# 1+7·C floats.


def init_regression_sums(num_columns: int, device="cpu"
                         ) -> Dict[str, torch.Tensor]:
    z = lambda: torch.zeros((num_columns,), dtype=torch.float32, device=device)
    return {"n": torch.zeros((), dtype=torch.float32, device=device),
            "mean_y": z(), "mean_p": z(), "m2_y": z(), "m2_p": z(),
            "c_yp": z(), "sum_abs": z(), "sum_sq": z()}


def regression_update(sums, output, labels, mask=None):
    output, labels, mask = _flatten_time(output, labels, mask)
    y = labels.to(torch.float32)
    p = output.to(torch.float32)
    if mask is None:
        w = torch.ones((y.shape[0],), dtype=torch.float32, device=y.device)
    else:
        w = (mask != 0).to(torch.float32)
    wc = w[:, None]
    # this batch's centered stats (one pass, weighted)
    nb = torch.sum(w)
    safe_nb = torch.clamp(nb, min=1.0)
    mean_yb = torch.sum(y * wc, dim=0) / safe_nb
    mean_pb = torch.sum(p * wc, dim=0) / safe_nb
    dy, dp = y - mean_yb, p - mean_pb
    m2_yb = torch.sum(dy * dy * wc, dim=0)
    m2_pb = torch.sum(dp * dp * wc, dim=0)
    c_b = torch.sum(dy * dp * wc, dim=0)
    # Chan's parallel merge with the running stats
    na, ntot = sums["n"], sums["n"] + nb
    safe_n = torch.clamp(ntot, min=1.0)
    delta_y = mean_yb - sums["mean_y"]
    delta_p = mean_pb - sums["mean_p"]
    factor = na * nb / safe_n
    err = y - p
    return {
        "n": ntot,
        "mean_y": sums["mean_y"] + delta_y * nb / safe_n,
        "mean_p": sums["mean_p"] + delta_p * nb / safe_n,
        "m2_y": sums["m2_y"] + m2_yb + delta_y * delta_y * factor,
        "m2_p": sums["m2_p"] + m2_pb + delta_p * delta_p * factor,
        "c_yp": sums["c_yp"] + c_b + delta_y * delta_p * factor,
        "sum_abs": sums["sum_abs"] + torch.sum(torch.abs(err) * wc, dim=0),
        "sum_sq": sums["sum_sq"] + torch.sum(err * err * wc, dim=0),
    }


class RegressionStats:
    """Host-side view over the sums; the accessor surface of
    ``RegressionEvaluation`` (per-column MSE/MAE/RMSE/R²/Pearson)."""

    def __init__(self, sums):
        self._s = {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor)
                                 else v, np.float64)
                   for k, v in sums.items()}
        self.num_columns = int(self._s["mean_y"].shape[0])

    @property
    def n(self) -> float:
        return float(self._s["n"])

    def mean_squared_error(self, col: int) -> float:
        return float(self._s["sum_sq"][col] / self.n)

    def mean_absolute_error(self, col: int) -> float:
        return float(self._s["sum_abs"][col] / self.n)

    def root_mean_squared_error(self, col: int) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def correlation_r2(self, col: int) -> float:
        ss_tot = self._s["m2_y"][col]  # == Σ(y - ȳ)² exactly
        if ss_tot == 0:
            return 0.0
        return float(1.0 - self._s["sum_sq"][col] / ss_tot)

    def pearson_correlation(self, col: int) -> float:
        s = self._s
        var_y, var_p = s["m2_y"][col], s["m2_p"][col]
        if var_y <= 0 or var_p <= 0:
            return 0.0
        return float(s["c_yp"][col] / np.sqrt(var_y * var_p))

    def stats(self) -> str:
        lines = ["Column    MSE        MAE        RMSE       R^2        Corr"]
        for c in range(self.num_columns):
            lines.append(
                f"{c:6d} {self.mean_squared_error(c):10.5f} "
                f"{self.mean_absolute_error(c):10.5f} "
                f"{self.root_mean_squared_error(c):10.5f} "
                f"{self.correlation_r2(c):10.5f} "
                f"{self.pearson_correlation(c):10.5f}")
        return "\n".join(lines)
