"""KD-tree for exact nearest-neighbor queries.

Reference: ``clustering/kdtree/KDTree.java`` (370 LoC) — insert/nn/knn over
axis-aligned median splits. Host-side index structure (numpy); device code
never traverses it.

A copy of ``deeplearning4j_tpu/clustering/kdtree.py``: the port keeps its own,
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


class _Node:
    __slots__ = ("point", "index", "axis", "left", "right")

    def __init__(self, point, index, axis):
        self.point = point
        self.index = index
        self.axis = axis
        self.left: Optional["_Node"] = None
        self.right: Optional["_Node"] = None


class KDTree:
    """Exact k-d tree; build bulk via median splits or insert incrementally."""

    def __init__(self, dims: int):
        self.dims = dims
        self.root: Optional[_Node] = None
        self.size = 0

    @classmethod
    def build(cls, points: np.ndarray) -> "KDTree":
        points = np.asarray(points, np.float64)
        tree = cls(points.shape[1])

        def rec(indices: np.ndarray, depth: int) -> Optional[_Node]:
            if indices.size == 0:
                return None
            axis = depth % tree.dims
            order = np.argsort(points[indices, axis], kind="stable")
            indices = indices[order]
            mid = indices.size // 2
            node = _Node(points[indices[mid]], int(indices[mid]), axis)
            node.left = rec(indices[:mid], depth + 1)
            node.right = rec(indices[mid + 1:], depth + 1)
            return node

        tree.root = rec(np.arange(points.shape[0]), 0)
        tree.size = points.shape[0]
        return tree

    def insert(self, point: np.ndarray, index: Optional[int] = None):
        point = np.asarray(point, np.float64)
        if index is None:
            index = self.size
        if self.root is None:
            self.root = _Node(point, index, 0)
            self.size += 1
            return
        node = self.root
        depth = 0
        while True:
            axis = node.axis
            branch = "left" if point[axis] < node.point[axis] else "right"
            child = getattr(node, branch)
            if child is None:
                setattr(node, branch,
                        _Node(point, index, (depth + 1) % self.dims))
                self.size += 1
                return
            node = child
            depth += 1

    def nn(self, point: np.ndarray) -> Tuple[int, float]:
        """Nearest neighbor: (index, euclidean distance)."""
        if self.root is None:
            raise ValueError("nearest-neighbor query on an empty KDTree")
        return self.knn(point, 1)[0]

    def knn(self, point: np.ndarray, k: int) -> List[Tuple[int, float]]:
        """k nearest neighbors as [(index, distance)] sorted ascending."""
        point = np.asarray(point, np.float64)
        heap: List[Tuple[float, int]] = []  # max-heap via negated distance

        def rec(node: Optional[_Node]):
            if node is None:
                return
            d = float(np.linalg.norm(node.point - point))
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, node.index))
            diff = point[node.axis] - node.point[node.axis]
            near, far = ((node.left, node.right) if diff < 0
                         else (node.right, node.left))
            rec(near)
            if len(heap) < k or abs(diff) < -heap[0][0]:
                rec(far)

        rec(self.root)
        return sorted([(idx, -negd) for negd, idx in heap],
                      key=lambda t: t[1])
