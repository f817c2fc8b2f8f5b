"""Random-walk sequence generators over a Graph.

Reference: ``iterator/RandomWalkIterator.java:133`` (uniform next-vertex
choice, NoEdgeHandling SELF_LOOP vs EXCEPTION) and
``WeightedRandomWalkIterator.java:156`` (edge-weight-proportional choice).

A copy of ``deeplearning4j_tpu/graph/walks.py``: the port keeps its own,
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import enum
from typing import Iterator, Optional

import numpy as np

from .graph import Graph


class NoEdgeHandling(enum.Enum):
    SELF_LOOP_ON_DISCONNECTED = "self_loop"
    EXCEPTION_ON_DISCONNECTED = "exception"


class RandomWalkIterator:
    """Uniform random walks of fixed length, one starting at each vertex."""

    def __init__(self, graph: Graph, walk_length: int,
                 seed: int = 12345,
                 no_edge_handling: NoEdgeHandling =
                 NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED):
        self.graph = graph
        self.walk_length = walk_length
        self.seed = seed
        self.no_edge_handling = no_edge_handling
        self.reset()

    def reset(self):
        self._rng = np.random.default_rng(self.seed)
        self._order = self._rng.permutation(self.graph.num_vertices)
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._order)

    def _choose_next(self, vertex: int) -> int:
        neighbors = self.graph.connected_vertices(vertex)
        if not neighbors:
            if (self.no_edge_handling
                    is NoEdgeHandling.EXCEPTION_ON_DISCONNECTED):
                raise RuntimeError(
                    f"vertex {vertex} has no outgoing edges")
            return vertex  # self loop
        return int(neighbors[self._rng.integers(len(neighbors))])

    def next(self) -> np.ndarray:
        """Next walk as an int array [walk_length + 1]."""
        start = int(self._order[self._pos])
        self._pos += 1
        walk = [start]
        cur = start
        for _ in range(self.walk_length):
            cur = self._choose_next(cur)
            walk.append(cur)
        return np.asarray(walk, np.int32)

    def __iter__(self) -> Iterator[np.ndarray]:
        while self.has_next():
            yield self.next()


class WeightedRandomWalkIterator(RandomWalkIterator):
    """Random walks with next-vertex probability ∝ edge weight."""

    def _choose_next(self, vertex: int) -> int:
        neighbors = self.graph.weighted_neighbors(vertex)
        if not neighbors:
            if (self.no_edge_handling
                    is NoEdgeHandling.EXCEPTION_ON_DISCONNECTED):
                raise RuntimeError(
                    f"vertex {vertex} has no outgoing edges")
            return vertex
        idx = [n for n, _ in neighbors]
        w = np.asarray([wt for _, wt in neighbors], np.float64)
        if np.any(w < 0):
            raise ValueError(
                f"vertex {vertex} has negative edge weights; weighted "
                "walks require non-negative weights")
        total = w.sum()
        if total <= 0:
            return int(idx[self._rng.integers(len(idx))])
        return int(self._rng.choice(idx, p=w / total))
