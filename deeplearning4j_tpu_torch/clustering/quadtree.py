"""2-D quadtree (the d=2 specialization the reference keeps separately).

Reference: ``clustering/quadtree/QuadTree.java`` (396 LoC). The general
d-dimensional tree lives in ``sptree.py``; this class keeps the reference's
2-D API (boundary cells, insert, point containment) for parity and for the
UI scatter queries.

A copy of ``deeplearning4j_tpu/clustering/quadtree.py``: the port keeps its own,
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .sptree import SpTree


class QuadTree(SpTree):
    """Quadtree = SpTree restricted to 2-D points."""

    def __init__(self, points: np.ndarray):
        points = np.asarray(points, np.float64)
        if points.ndim != 2 or points.shape[1] != 2:
            raise ValueError(f"QuadTree requires [n, 2] points, "
                             f"got {points.shape}")
        super().__init__(points)

    def query_range(self, center: Tuple[float, float],
                    half_width: Tuple[float, float]) -> List[int]:
        """Indices of points inside the axis-aligned box
        center ± half_width."""
        c = np.asarray(center, np.float64)
        hw = np.asarray(half_width, np.float64)
        out: List[int] = []

        def overlaps(cell) -> bool:
            return bool(np.all(np.abs(cell.center - c)
                               <= cell.width / 2 + hw))

        def rec(cell):
            if cell is None or cell.n_points == 0 or not overlaps(cell):
                return
            if cell.is_leaf:
                for idx in cell.indices:
                    if np.all(np.abs(self.points[idx] - c) <= hw):
                        out.append(idx)
                return
            for child in cell.children:
                rec(child)

        rec(self.root)
        return sorted(out)
