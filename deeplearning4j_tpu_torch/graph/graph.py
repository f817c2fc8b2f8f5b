"""Adjacency-list graph + file loaders.

Reference: ``graph/Graph.java:221`` (IGraph over adjacency lists, directed
or undirected, optional edge weights) and ``data/GraphLoader.java:170``
(edge-list and adjacency-list text formats).

A copy of ``deeplearning4j_tpu/graph/graph.py``: the port keeps its own,
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


class Graph:
    """Adjacency-list graph with optional edge weights (api/IGraph.java)."""

    def __init__(self, num_vertices: int, directed: bool = False):
        if num_vertices <= 0:
            raise ValueError("num_vertices must be positive")
        self.directed = directed
        self._adj: List[Dict[int, float]] = [dict()
                                             for _ in range(num_vertices)]

    @property
    def num_vertices(self) -> int:
        return len(self._adj)

    def _check(self, vertex: int) -> int:
        if not 0 <= vertex < self.num_vertices:
            raise ValueError(
                f"vertex {vertex} out of range [0,{self.num_vertices})")
        return vertex

    def add_edge(self, v_from: int, v_to: int, weight: float = 1.0):
        self._check(v_from)
        self._check(v_to)
        self._adj[v_from][v_to] = weight
        if not self.directed:
            self._adj[v_to][v_from] = weight

    def connected_vertices(self, vertex: int) -> List[int]:
        return sorted(self._adj[self._check(vertex)].keys())

    def edge_weight(self, v_from: int, v_to: int) -> Optional[float]:
        return self._adj[self._check(v_from)].get(self._check(v_to))

    def degree(self, vertex: int) -> int:
        return len(self._adj[self._check(vertex)])

    def num_edges(self) -> int:
        total = sum(len(d) for d in self._adj)
        if self.directed:
            return total
        # undirected: normal edges stored twice, self-loops once
        self_loops = sum(1 for v, d in enumerate(self._adj) if v in d)
        return (total + self_loops) // 2

    def weighted_neighbors(self, vertex: int) -> List[Tuple[int, float]]:
        return sorted(self._adj[self._check(vertex)].items())


class GraphLoader:
    """Text-file graph loaders (data/GraphLoader.java)."""

    @staticmethod
    def load_edge_list(path: str, num_vertices: int,
                       directed: bool = False,
                       delimiter: Optional[str] = None) -> Graph:
        """Lines of ``from to [weight]``; '#' comments skipped."""
        g = Graph(num_vertices, directed)
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(delimiter)
                w = float(parts[2]) if len(parts) > 2 else 1.0
                g.add_edge(int(parts[0]), int(parts[1]), w)
        return g

    @staticmethod
    def load_adjacency_list(path: str, num_vertices: int,
                            directed: bool = True,
                            delimiter: Optional[str] = None) -> Graph:
        """Lines of ``vertex neighbor neighbor ...``."""
        g = Graph(num_vertices, directed)
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(delimiter)
                v = int(parts[0])
                for nb in parts[1:]:
                    g.add_edge(v, int(nb))
        return g

    @staticmethod
    def from_edges(edges: Sequence[Tuple[int, int]], num_vertices: int,
                   directed: bool = False) -> Graph:
        g = Graph(num_vertices, directed)
        for e in edges:
            g.add_edge(e[0], e[1], e[2] if len(e) > 2 else 1.0)
        return g
