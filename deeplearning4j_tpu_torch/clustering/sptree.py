"""Space-partitioning tree (generalized quadtree/octree) for Barnes-Hut.

Reference: ``clustering/sptree/SpTree.java`` (363 LoC) — d-dimensional cell
tree with center-of-mass summaries, used by ``plot/BarnesHutTsne.java`` to
approximate the t-SNE repulsive forces in O(n log n).

Host-side: Barnes-Hut is inherently pointer-chasing and data-dependent —
the device path for t-SNE is the exact O(n²) version in
``plot/tsne.py`` (dense GEMMs over [n, n]); this tree serves the
large-n host fallback exactly like the reference's.

A copy of ``deeplearning4j_tpu/clustering/sptree.py``: the port keeps its own,
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

# beyond this depth points are treated as coincident and aggregated in one
# leaf rather than subdivided further
_MAX_DEPTH = 48


class _Cell:
    __slots__ = ("center", "width", "n_points", "center_of_mass",
                 "indices", "children", "is_leaf")

    def __init__(self, center: np.ndarray, width: np.ndarray):
        self.center = center
        self.width = width
        self.n_points = 0
        self.center_of_mass = np.zeros_like(center)
        self.indices: List[int] = []   # leaf-resident point indices
        self.children: Optional[List["_Cell"]] = None
        self.is_leaf = True

    def contains(self, point: np.ndarray) -> bool:
        return bool(np.all(np.abs(point - self.center) <= self.width / 2
                           + 1e-10))


class SpTree:
    """Barnes-Hut space tree over points [n, d]."""

    def __init__(self, points: np.ndarray):
        self.points = np.asarray(points, np.float64)
        n, d = self.points.shape
        self.dims = d
        lo = self.points.min(axis=0)
        hi = self.points.max(axis=0)
        center = (lo + hi) / 2.0
        width = (hi - lo) + 1e-5
        self.root = _Cell(center, width)
        for i in range(n):
            self._insert(self.root, i)

    def _subdivide(self, cell: _Cell):
        d = self.dims
        cell.children = []
        half = cell.width / 2.0
        for mask in range(2 ** d):
            offset = np.array([(1 if (mask >> j) & 1 else -1)
                               for j in range(d)], np.float64)
            child_center = cell.center + offset * half / 2.0
            cell.children.append(_Cell(child_center, half))
        cell.is_leaf = False

    def _insert(self, cell: _Cell, index: int, depth: int = 0):
        point = self.points[index]
        cell.center_of_mass = (
            (cell.center_of_mass * cell.n_points + point)
            / (cell.n_points + 1))
        cell.n_points += 1
        if cell.is_leaf:
            if not cell.indices or depth > _MAX_DEPTH:
                cell.indices.append(index)
                return
            old = cell.indices
            cell.indices = []
            self._subdivide(cell)
            for o in old:
                self._route(cell, o, depth)
        self._route(cell, index, depth)

    def _route(self, cell: _Cell, index: int, depth: int):
        point = self.points[index]
        for child in cell.children:
            if child.contains(point):
                self._insert(child, index, depth + 1)
                return
        # numerical edge: force into nearest child
        dists = [float(np.linalg.norm(point - c.center))
                 for c in cell.children]
        self._insert(cell.children[int(np.argmin(dists))], index, depth + 1)

    def compute_non_edge_forces(self, index: int, theta: float,
                                neg_force: np.ndarray) -> float:
        """Accumulate Barnes-Hut repulsive force for point ``index``.

        Returns this point's contribution to the normalization sum_Q.
        Mirrors SpTree.computeNonEdgeForces: cell used whole when
        max_width / dist < theta.
        """
        point = self.points[index]
        sum_q = 0.0

        def rec(cell: _Cell):
            nonlocal sum_q
            if cell.n_points == 0:
                return
            if cell.is_leaf and cell.indices == [index]:
                return
            diff = point - cell.center_of_mass
            dist2 = float(np.dot(diff, diff))
            max_width = float(np.max(cell.width))
            if cell.is_leaf or max_width * max_width < theta * theta * dist2:
                n_eff = cell.n_points
                if cell.is_leaf and index in cell.indices:
                    n_eff -= 1
                    if n_eff == 0:
                        return
                q = 1.0 / (1.0 + dist2)
                sum_q += n_eff * q
                neg_force[:] = neg_force + n_eff * q * q * diff
            else:
                for child in cell.children:
                    rec(child)

        rec(self.root)
        return sum_q
