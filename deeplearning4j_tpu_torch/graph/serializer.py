"""Text serialization of vertex vectors.

Reference: ``loader/GraphVectorSerializer.java:82`` — one line per vertex:
``index v0 v1 ... vD``.

A copy of ``deeplearning4j_tpu/graph/serializer.py``: the port keeps its own,
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


class GraphVectorSerializer:

    @staticmethod
    def write_graph_vectors(deepwalk, path: str):
        with open(path, "w") as f:
            for v in range(deepwalk.num_vertices):
                vec = deepwalk.get_vertex_vector(v)
                f.write(str(v) + " "
                        + " ".join(f"{x:.8g}" for x in vec) + "\n")

    @staticmethod
    def read_graph_vectors(path: str) -> np.ndarray:
        """Returns [V, D] vectors ordered by vertex index."""
        rows = {}
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                rows[int(parts[0])] = np.asarray(
                    [float(x) for x in parts[1:]], np.float32)
        if not rows:
            return np.zeros((0, 0), np.float32)
        dim = len(next(iter(rows.values())))
        out = np.zeros((max(rows) + 1, dim), np.float32)
        for idx, vec in rows.items():
            out[idx] = vec
        return out
