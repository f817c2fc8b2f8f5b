"""Vantage-point tree for metric-space nearest-neighbor search.

Reference: ``clustering/vptree/VPTree.java`` (345 LoC) — backs the UI
nearest-neighbors endpoint (``ui/nearestneighbors/NearestNeighborsResource``)
and word-vector similarity queries. Host-side structure.

A copy of ``deeplearning4j_tpu/clustering/vptree.py``: the port keeps its own,
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


class _VPNode:
    __slots__ = ("index", "threshold", "inside", "outside")

    def __init__(self, index: int):
        self.index = index
        self.threshold = 0.0
        self.inside: Optional["_VPNode"] = None
        self.outside: Optional["_VPNode"] = None


def _euclidean(a, b):
    return float(np.linalg.norm(a - b))


class VPTree:
    """VP-tree over a fixed point set; supports euclidean and cosine.

    VP-tree pruning requires a metric (triangle inequality), which
    ``1 - cos`` is not — so for cosine the tree is built over L2-normalized
    points with chord (euclidean) distance, which induces the identical
    neighbor ordering (chord² = 2·(1 − cos)); reported distances are
    converted back to cosine distance.
    """

    def __init__(self, points: np.ndarray, distance: str = "euclidean",
                 seed: int = 123):
        if distance not in ("euclidean", "cosine"):
            raise ValueError(f"unknown distance: {distance}")
        self.points = np.asarray(points, np.float64)
        self.distance = distance
        self._dist = _euclidean
        if distance == "cosine":
            norms = np.linalg.norm(self.points, axis=1, keepdims=True)
            self._search_points = self.points / np.maximum(norms, 1e-12)
        else:
            self._search_points = self.points
        rng = np.random.default_rng(seed)
        indices = list(range(self.points.shape[0]))
        self.root = self._build(indices, rng)

    def _build(self, indices: List[int],
               rng: np.random.Generator) -> Optional[_VPNode]:
        if not indices:
            return None
        vp_pos = int(rng.integers(len(indices)))
        indices[0], indices[vp_pos] = indices[vp_pos], indices[0]
        node = _VPNode(indices[0])
        rest = indices[1:]
        if not rest:
            return node
        vp = self._search_points[node.index]
        dists = np.array([self._dist(vp, self._search_points[i])
                          for i in rest])
        median = float(np.median(dists))
        node.threshold = median
        inside = [i for i, d in zip(rest, dists) if d < median]
        outside = [i for i, d in zip(rest, dists) if d >= median]
        node.inside = self._build(inside, rng)
        node.outside = self._build(outside, rng)
        return node

    def knn(self, query: np.ndarray, k: int) -> List[Tuple[int, float]]:
        """k nearest neighbors of ``query`` as [(index, distance)]."""
        query = np.asarray(query, np.float64)
        if self.distance == "cosine":
            query = query / max(np.linalg.norm(query), 1e-12)
        heap: List[Tuple[float, int]] = []  # max-heap (negated)
        tau = [np.inf]

        def rec(node: Optional[_VPNode]):
            if node is None:
                return
            d = self._dist(query, self._search_points[node.index])
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
                if len(heap) == k:
                    tau[0] = -heap[0][0]
            elif d < tau[0]:
                heapq.heapreplace(heap, (-d, node.index))
                tau[0] = -heap[0][0]
            if node.inside is None and node.outside is None:
                return
            if d < node.threshold:
                rec(node.inside)
                if d + tau[0] >= node.threshold:
                    rec(node.outside)
            else:
                rec(node.outside)
                if d - tau[0] <= node.threshold:
                    rec(node.inside)

        rec(self.root)
        out = sorted([(idx, -negd) for negd, idx in heap],
                     key=lambda t: t[1])
        if self.distance == "cosine":
            # chord → cosine distance: d_cos = chord² / 2
            out = [(idx, d * d / 2.0) for idx, d in out]
        return out
