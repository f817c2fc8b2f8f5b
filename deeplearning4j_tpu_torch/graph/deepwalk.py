"""DeepWalk: skip-gram with hierarchical softmax over random walks.

Reference: ``models/deepwalk/DeepWalk.java:253`` (learnVertexVectors:
walks → skip-gram pairs → HS dot/σ row updates on vertex/inner-node
tables) and ``GraphHuffman.java:130`` (Huffman codes over vertex degrees).

Port of ``deeplearning4j_tpu/graph/deepwalk.py``. The reference project
updates one (vertex, inner-node) pair at a time; here pairs are batched
and each batch is one step of word2vec's ``_hs_step`` on the card
(``device=None``) or on ``device``, sharing its padded Huffman-path
layout. The init and the walks are numpy, as in the reference, so both
packages start from the same tables.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..nlp.vocab import Huffman, VocabCache, padded_paths
from ..nlp.word2vec import _hs_step, to_host
from .graph import Graph
from .walks import RandomWalkIterator


class GraphHuffman:
    """Huffman codes/points for vertices, weighted by degree.

    Reuses the NLP Huffman over a synthetic vocab where token ``str(v)``
    has count ``degree(v) + 1`` (the +1 keeps zero-degree vertices codable).
    """

    def __init__(self, graph: Graph):
        self.vocab = VocabCache()
        for v in range(graph.num_vertices):
            self.vocab.add_token(str(v), graph.degree(v) + 1)
        Huffman(self.vocab).build()
        words = self.vocab.vocab_words()
        self.codes: List[np.ndarray] = [None] * graph.num_vertices
        self.points: List[np.ndarray] = [None] * graph.num_vertices
        for vw in words:
            self.codes[int(vw.word)] = vw.codes
            self.points[int(vw.word)] = vw.points
        self.max_code_length = max(
            (len(c) for c in self.codes if c is not None), default=0)

    def padded_paths(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(points [V, C], codes [V, C], mask [V, C]) padded arrays."""
        return padded_paths(self.codes, self.points)


class DeepWalk:
    """DeepWalk graph-vertex embeddings (models/deepwalk/DeepWalk.java).

    Usage mirrors the reference::

        dw = DeepWalk.Builder().vector_size(32).window_size(4).build()
        dw.initialize(graph)
        dw.fit(RandomWalkIterator(graph, walk_length=8))
    """

    class Builder:
        def __init__(self):
            self._vector_size = 100
            self._window_size = 5
            self._learning_rate = 0.01
            self._batch_size = 1024
            self._seed = 12345
            self._device = None

        def device(self, v):
            self._device = v
            return self

        def vector_size(self, v: int):
            self._vector_size = v
            return self

        def window_size(self, v: int):
            self._window_size = v
            return self

        def learning_rate(self, v: float):
            self._learning_rate = v
            return self

        def batch_size(self, v: int):
            self._batch_size = v
            return self

        def seed(self, v: int):
            self._seed = v
            return self

        def build(self) -> "DeepWalk":
            return DeepWalk(self._vector_size, self._window_size,
                            self._learning_rate, self._batch_size,
                            self._seed, device=self._device)

    def __init__(self, vector_size: int = 100, window_size: int = 5,
                 learning_rate: float = 0.01, batch_size: int = 1024,
                 seed: int = 12345, device=None):
        self.device = resolve_device(device)
        self.vector_size = vector_size
        self.window_size = window_size
        self.learning_rate = learning_rate
        self.batch_size = batch_size
        self.seed = seed
        self.graph: Optional[Graph] = None
        self.syn0: Optional[torch.Tensor] = None   # vertex vectors [V, D]
        self.syn1: Optional[torch.Tensor] = None   # inner nodes [V-1, D]
        self._paths = None
        self._norm_cache: Optional[np.ndarray] = None
        self.loss_history: List[float] = []

    def initialize(self, graph: Graph):
        self.graph = graph
        v = graph.num_vertices
        rng = np.random.default_rng(self.seed)
        bound = 0.5 / self.vector_size
        self.syn0 = torch.from_numpy(rng.uniform(
            -bound, bound, (v, self.vector_size)).astype(np.float32)).to(
                self.device)
        self.syn1 = torch.zeros((max(v - 1, 1), self.vector_size),
                                dtype=torch.float32, device=self.device)
        self._norm_cache = None
        self._huffman = GraphHuffman(graph)
        self._paths = self._huffman.padded_paths()

    def _pairs_from_walk(self, walk: np.ndarray) -> List[Tuple[int, int]]:
        pairs = []
        n = len(walk)
        for i in range(n):
            lo = max(0, i - self.window_size)
            hi = min(n, i + self.window_size + 1)
            for j in range(lo, hi):
                if j != i:
                    pairs.append((int(walk[i]), int(walk[j])))
        return pairs

    def fit(self, walk_iterator: RandomWalkIterator,
            epochs: int = 1) -> "DeepWalk":
        if self.graph is None:
            raise RuntimeError("call initialize(graph) before fit")
        points_all, codes_all, mask_all = self._paths
        syn0 = self.syn0
        syn1 = self.syn1
        losses: List = []  # device scalars; read once after the loop
        for _ in range(epochs):
            walk_iterator.reset()
            buf: List[Tuple[int, int]] = []
            for walk in walk_iterator:
                buf.extend(self._pairs_from_walk(walk))
                while len(buf) >= self.batch_size:
                    batch, buf = (buf[:self.batch_size],
                                  buf[self.batch_size:])
                    syn0, syn1 = self._step(syn0, syn1, batch, points_all,
                                            codes_all, mask_all, losses)
            if buf:
                syn0, syn1 = self._step(syn0, syn1, buf, points_all,
                                        codes_all, mask_all, losses)
        self.syn0 = syn0
        self.syn1 = syn1
        self.loss_history = (torch.stack(losses).cpu().tolist() if losses
                             else [])
        self._norm_cache = None
        return self

    def _step(self, syn0, syn1, pairs, points_all, codes_all, mask_all,
              losses):
        centers = np.asarray([p[0] for p in pairs], np.int32)
        targets = np.asarray([p[1] for p in pairs], np.int32)
        dev = self.device
        syn0, syn1, loss = _hs_step(
            syn0, syn1, torch.from_numpy(centers).to(dev),
            torch.from_numpy(points_all[targets]).to(dev),
            torch.from_numpy(codes_all[targets]).to(dev),
            torch.from_numpy(mask_all[targets]).to(dev),
            float(np.float32(self.learning_rate)))
        losses.append(loss)
        return syn0, syn1

    # ---- GraphVectors query API (GraphVectorsImpl.java) ----

    def get_vertex_vector(self, vertex: int) -> np.ndarray:
        return to_host(self.syn0[vertex])

    def _normed(self) -> np.ndarray:
        if self._norm_cache is None:
            syn0 = to_host(self.syn0)
            self._norm_cache = syn0 / (
                np.linalg.norm(syn0, axis=1, keepdims=True) + 1e-12)
        return self._norm_cache

    def similarity(self, v1: int, v2: int) -> float:
        normed = self._normed()
        return float(np.dot(normed[v1], normed[v2]))

    def vertices_nearest(self, vertex: int, top_n: int = 5) -> List[int]:
        normed = self._normed()
        sims = normed @ normed[vertex]
        sims[vertex] = -np.inf
        return list(np.argsort(-sims)[:top_n])

    @property
    def num_vertices(self) -> int:
        return 0 if self.graph is None else self.graph.num_vertices
