"""Math helpers (util/MathUtils.java, 1,308 LoC — the subset the framework
actually exercises: normalization, correlation/regression-error stats,
entropy/information, rounding/discretization, combinatorics). Vectorized
numpy instead of the reference's scalar loops. Port of
``deeplearning4j_tpu/utils/mathutils.py``."""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


# -- scaling / normalization -------------------------------------------
def normalize(value: float, min_v: float, max_v: float) -> float:
    """MathUtils.normalize: scale into [0, 1]; errors when max <= min."""
    if max_v <= min_v:
        raise ValueError("max must exceed min")
    return (value - min_v) / (max_v - min_v)


def normalize_array(x, low: float = 0.0, high: float = 1.0) -> np.ndarray:
    x = np.asarray(x, np.float64)
    lo, hi = x.min(), x.max()
    if hi == lo:
        return np.full_like(x, low)
    return low + (x - lo) * (high - low) / (hi - lo)


def clamp(value: float, low: float, high: float) -> float:
    return max(low, min(high, value))


# -- information theory -------------------------------------------------
def entropy(probabilities) -> float:
    """Shannon entropy in bits over a probability vector."""
    p = np.asarray(probabilities, np.float64)
    p = p[p > 0]
    return float(-np.sum(p * np.log2(p)))


def information_gain(parent_counts, split_counts) -> float:
    """Entropy(parent) - Σ weight·Entropy(child) over a candidate split."""
    parent = np.asarray(parent_counts, np.float64)
    h_parent = entropy(parent / parent.sum())
    total = parent.sum()
    h_children = 0.0
    for child in split_counts:
        child = np.asarray(child, np.float64)
        if child.sum() == 0:
            continue
        h_children += (child.sum() / total) * entropy(child / child.sum())
    return h_parent - h_children


def log2(x: float) -> float:
    return math.log2(x)


# -- regression / correlation statistics --------------------------------
def sum_of_squares(x) -> float:
    return float(np.sum(np.square(np.asarray(x, np.float64))))


def sum_of_products(x, y) -> float:
    return float(np.dot(np.asarray(x, np.float64), np.asarray(y, np.float64)))


def ss_reg(predicted, actual) -> float:
    """Regression sum of squares vs the mean of actual."""
    a = np.asarray(actual, np.float64)
    p = np.asarray(predicted, np.float64)
    return float(np.sum((p - a.mean()) ** 2))


def ss_error(predicted, actual) -> float:
    """Residual sum of squares (MathUtils.ssError)."""
    a = np.asarray(actual, np.float64)
    p = np.asarray(predicted, np.float64)
    return float(np.sum((a - p) ** 2))


def correlation(x, y) -> float:
    """Pearson correlation (MathUtils.correlation)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    sx, sy = x.std(), y.std()
    if sx == 0 or sy == 0:
        return 0.0
    return float(np.mean((x - x.mean()) * (y - y.mean())) / (sx * sy))


def euclidean_distance(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64)
                                - np.asarray(b, np.float64)))


def manhattan_distance(a, b) -> float:
    return float(np.sum(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


# -- rounding / discretization -------------------------------------------
def round_to_decimals(value: float, decimals: int) -> float:
    factor = 10.0 ** decimals
    return math.floor(value * factor + 0.5) / factor


def discretize(value: float, min_v: float, max_v: float,
               bins: int) -> int:
    """Bin index in [0, bins) for a value in [min, max]."""
    if bins <= 0:
        raise ValueError("bins must be positive")
    frac = normalize(clamp(value, min_v, max_v), min_v,
                     max_v) if max_v > min_v else 0.0
    return min(int(frac * bins), bins - 1)


def next_power_of_2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


# -- combinatorics -------------------------------------------------------
def factorial(n: int) -> float:
    return float(math.factorial(n))


def permutation(n: int, r: int) -> float:
    return float(math.perm(n, r))


def combination(n: int, r: int) -> float:
    return float(math.comb(n, r))


# -- misc ---------------------------------------------------------------
def sigmoid(x: float) -> float:
    if x >= 0:
        return 1.0 / (1.0 + math.exp(-x))
    e = math.exp(x)
    return e / (1.0 + e)


def bernoullis(successes: float, trials: float, p: float) -> float:
    """Probability of k successes in n Bernoulli(p) trials."""
    n, k = int(trials), int(successes)
    return float(math.comb(n, k) * p ** k * (1 - p) ** (n - k))


def uniform(rng, a: float, b: float) -> float:
    return a + (b - a) * rng.random()


def weights_for(counts: Sequence[float]) -> np.ndarray:
    """Inverse-frequency class weights, normalized to sum 1."""
    c = np.asarray(counts, np.float64)
    w = np.where(c > 0, 1.0 / np.maximum(c, 1e-12), 0.0)
    total = w.sum()
    return w / total if total > 0 else w
