"""GloVe: windowed co-occurrence counting + fused AdaGrad WLS on the card.

Port of ``deeplearning4j_tpu/nlp/glove.py`` (models/glove/Glove.java:413,
AbstractCoOccurrences.java:624 and GloveWeightLookupTable's AdaGrad
updates in the reference project). Counting stays on the host (a copy of
the reference's, spill and merge included, so the triples come in the
reference's order). The weighted-least-squares updates run the fused
way: the triples are padded to N·B with ``fx = 0`` (inert under the
masked step), each epoch's permutation is drawn on the device from a
generator seeded for that absolute epoch and applied into static batch
buffers, and one captured batch step (``perf/step_graph.StepGraph``)
is replayed N times an epoch on static tables. On the CPU the same step
runs eagerly. The fit ends with the standard merge ``syn0 = w + w̃``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.analysis.annotations import traced
from deeplearning4j_tpu_torch.nlp.sentence_iterator import SentenceIterator
from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory,
    TokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, build_vocab
from deeplearning4j_tpu_torch.nlp.word2vec import (
    _row_scale,
    _scatter_add,
    to_host,
)


def _glove_step_math(w, wc, b, bc, hw, hwc, hb, hbc, rows, cols, logx, fx,
                     lr):
    """AdaGrad step on J = Σ f(x)(w_i·w̃_j + b_i + b̃_j − log x)², in place
    on the eight tables; returns them and the loss.

    Masked for the fused path's padding: a triple with ``fx == 0`` is
    inert (zero gradient, zero accumulator growth) and excluded from the
    loss mean. Duplicate rows in one batch mean-normalize through
    ``_row_scale`` (weighted by validity, the word2vec rule)."""
    rows, cols = rows.long(), cols.long()
    valid = (fx > 0).to(torch.float32)
    wi = w[rows]
    wj = wc[cols]
    diff = torch.sum(wi * wj, dim=-1) + b[rows] + bc[cols] - logx  # [B]
    loss = torch.sum(fx * diff * diff) / torch.clamp_min(torch.sum(valid),
                                                         1.0)
    g = fx * diff                                                # [B]
    gwi = g[:, None] * wj
    gwj = g[:, None] * wi
    # AdaGrad accumulators keep the SUMMED g² (history is a sum)
    _scatter_add(hw, rows, gwi * gwi)
    _scatter_add(hwc, cols, gwj * gwj)
    _scatter_add(hb, rows, g * g)
    _scatter_add(hbc, cols, g * g)
    sr = _row_scale(w.shape[0], rows, valid)
    sc = _row_scale(wc.shape[0], cols, valid)
    _scatter_add(w, rows, -lr * gwi / (torch.sqrt(hw[rows]) + 1e-8)
                 * sr[:, None])
    _scatter_add(wc, cols, -lr * gwj / (torch.sqrt(hwc[cols]) + 1e-8)
                 * sc[:, None])
    _scatter_add(b, rows, -lr * g / (torch.sqrt(hb[rows]) + 1e-8) * sr)
    _scatter_add(bc, cols, -lr * g / (torch.sqrt(hbc[cols]) + 1e-8) * sc)
    return w, wc, b, bc, hw, hwc, hb, hbc, loss


class _GloveRun:
    """The fused run for one geometry: static tables, the epoch's permuted
    ``[N, B]`` batch buffers, the cursor, the learning rate, the epoch's
    loss row, and the StepGraph of one batch step."""

    def __init__(self, n_rows: int, dim: int, n_batches: int, batch: int,
                 device):
        from deeplearning4j_tpu_torch.perf.step_graph import StepGraph

        f32 = dict(dtype=torch.float32, device=device)
        self.n_batches = n_batches
        self.tables = tuple(torch.zeros(shape, **f32) for shape in (
            (n_rows, dim), (n_rows, dim), (n_rows,), (n_rows,),
            (n_rows, dim), (n_rows, dim), (n_rows,), (n_rows,)))
        self.batch = (torch.zeros((n_batches, batch), dtype=torch.int32,
                                  device=device),
                      torch.zeros((n_batches, batch), dtype=torch.int32,
                                  device=device),
                      torch.zeros((n_batches, batch), **f32),
                      torch.zeros((n_batches, batch), **f32))
        self.lr = torch.zeros((), **f32)
        self.cursor = torch.zeros((1,), dtype=torch.int64, device=device)
        self.row = torch.zeros((n_batches,), **f32)
        self.graph = StepGraph(self._step, device)

    @traced
    def _step(self) -> None:
        i = self.cursor
        r, c, lx, f = (a.index_select(0, i).squeeze(0) for a in self.batch)
        *_, loss = _glove_step_math(*self.tables, r, c, lx, f, self.lr)
        self.row.index_copy_(0, i, loss.reshape(1))
        self.cursor.copy_(torch.remainder(i + 1, self.n_batches))

    def run(self, tables, triples, lr: float, orders) -> torch.Tensor:
        """One fit: ``tables`` copied in, then per epoch its ``orders[e]``
        applied to the flat ``triples`` and N steps; returns the ``[E, N]``
        history (the tables stay in :attr:`tables`)."""
        for dst, src in zip(self.tables, tables):
            dst.copy_(src)
        self.lr.fill_(float(lr))
        self.cursor.zero_()
        hist = torch.empty((len(orders), self.n_batches),
                           dtype=torch.float32, device=self.row.device)
        for e, order in enumerate(orders):
            for dst, src in zip(self.batch, triples):
                torch.index_select(src, 0, order, out=dst.view(-1))
            for _ in range(self.n_batches):
                self.graph()
            hist[e].copy_(self.row)
        return hist


class Glove:
    class Builder:
        def __init__(self):
            self._kw = {}

        def iterate(self, it: SentenceIterator):
            self._kw["sentence_iterator"] = it
            return self

        def tokenizer_factory(self, tf: TokenizerFactory):
            self._kw["tokenizer_factory"] = tf
            return self

        def min_word_frequency(self, v):
            self._kw["min_word_frequency"] = int(v)
            return self

        def layer_size(self, v):
            self._kw["layer_size"] = int(v)
            return self

        def window_size(self, v):
            self._kw["window_size"] = int(v)
            return self

        def learning_rate(self, v):
            self._kw["learning_rate"] = float(v)
            return self

        def epochs(self, v):
            self._kw["epochs"] = int(v)
            return self

        def x_max(self, v):
            self._kw["x_max"] = float(v)
            return self

        def alpha(self, v):
            self._kw["alpha"] = float(v)
            return self

        def seed(self, v):
            self._kw["seed"] = int(v)
            return self

        def device(self, v):
            self._kw["device"] = v
            return self

        def build(self) -> "Glove":
            return Glove(**self._kw)

    def __init__(self, sentence_iterator: Optional[SentenceIterator] = None,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 min_word_frequency: int = 1, layer_size: int = 50,
                 window_size: int = 5, learning_rate: float = 0.05,
                 epochs: int = 20, x_max: float = 100.0, alpha: float = 0.75,
                 batch_size: int = 16384, seed: int = 42,
                 max_memory_pairs: int = 5_000_000,
                 spill_dir: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self.sentence_iterator = sentence_iterator
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.min_word_frequency = min_word_frequency
        self.layer_size = layer_size
        self.window_size = window_size
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.x_max = x_max
        self.alpha = alpha
        self.batch_size = batch_size
        self.seed = seed
        self.max_memory_pairs = max_memory_pairs
        self.spill_dir = spill_dir
        self.spill_count = 0  # shards written during the last count pass
        self.vocab: Optional[VocabCache] = None
        self.syn0: Optional[torch.Tensor] = None  # w + wc merged after fit
        self._rng = np.random.default_rng(seed)
        self._train_dispatches = 0  # fused runs (one per fit)
        self._runs: Dict[tuple, _GloveRun] = {}
        # tables carried in by models.convert.load_embeddings_from_jax
        # (w, wc, b, bc, hw, hwc, hb, hbc): fit starts from them
        self._start_tables = None
        self._history: Optional[torch.Tensor] = None  # [E, N] losses

    def _sentences_tokens(self):
        self.sentence_iterator.reset()
        for s in self.sentence_iterator:
            yield self.tokenizer_factory.create(s).get_tokens()

    def count_cooccurrences(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Windowed, distance-weighted counts with DISK SPILL: when the
        in-memory map reaches ``max_memory_pairs``, it is flushed to a
        sorted shard on disk and the counting map restarts empty; shards
        are merged back with a vectorized chunk-wise k-way merge that sums
        duplicate keys (the role of AbstractCoOccurrences.java:624's countMap +
        count/ spill files, redesigned around sorted-run external
        aggregation instead of a disk-backed hash map)."""
        import os
        import tempfile

        counts: Dict[Tuple[int, int], float] = defaultdict(float)
        shards: List[str] = []
        spill_root: Optional[str] = None

        def spill():
            nonlocal spill_root
            if spill_root is None:
                spill_root = self.spill_dir or tempfile.mkdtemp(
                    prefix="glove-cooc-")
                os.makedirs(spill_root, exist_ok=True)
            keys = np.asarray(list(counts.keys()), np.int64)  # [m, 2]
            vals = np.asarray(list(counts.values()), np.float32)
            order = np.lexsort((keys[:, 1], keys[:, 0]))
            # a single sortable key per pair lets the merge compare scalars;
            # plain .npy files (not npz) so the merge can mmap them
            packed = (keys[order, 0] << 32) | keys[order, 1]
            base = os.path.join(spill_root, f"shard-{len(shards):05d}")
            np.save(base + ".keys.npy", packed)
            np.save(base + ".x.npy", vals[order])
            shards.append(base)
            counts.clear()

        for tokens in self._sentences_tokens():
            idx = [self.vocab.index_of(t) for t in tokens]
            idx = [i for i in idx if i >= 0]
            for i, wi in enumerate(idx):
                for off in range(1, self.window_size + 1):
                    j = i + off
                    if j >= len(idx):
                        break
                    weight = 1.0 / off
                    counts[(wi, idx[j])] += weight
                    counts[(idx[j], wi)] += weight
            if len(counts) >= self.max_memory_pairs:
                spill()

        self.spill_count = len(shards) + (1 if shards and counts else 0)
        if not shards:  # everything fit in memory: fast path
            rows = np.asarray([k[0] for k in counts], np.int32)
            cols = np.asarray([k[1] for k in counts], np.int32)
            x = np.asarray(list(counts.values()), np.float32)
            return rows, cols, x

        if counts:
            spill()

        # vectorized chunk-wise k-way merge of the sorted runs: per round,
        # take every element <= the minimum of the shards' chunk-max keys
        # (guaranteeing round-completeness per key), sort the <= k*chunk
        # gathered elements, and aggregate duplicates with add.reduceat —
        # O(k*chunk) resident, no per-pair Python loop
        chunk = 1 << 17
        keys_mm = [np.load(p + ".keys.npy", mmap_mode="r") for p in shards]
        vals_mm = [np.load(p + ".x.npy", mmap_mode="r") for p in shards]
        sizes = [len(k) for k in keys_mm]
        pos = [0] * len(shards)
        key_blocks: List[np.ndarray] = []
        val_blocks: List[np.ndarray] = []
        while True:
            live = [i for i in range(len(shards)) if pos[i] < sizes[i]]
            if not live:
                break
            bound = min(
                keys_mm[i][min(pos[i] + chunk, sizes[i]) - 1] for i in live)
            parts_k, parts_v = [], []
            for i in live:
                window = np.asarray(
                    keys_mm[i][pos[i]:min(pos[i] + chunk, sizes[i])])
                take = int(np.searchsorted(window, bound, side="right"))
                if take:
                    parts_k.append(window[:take])
                    parts_v.append(
                        np.asarray(vals_mm[i][pos[i]:pos[i] + take]))
                    pos[i] += take
            merged_k = np.concatenate(parts_k)
            merged_v = np.concatenate(parts_v)
            order = np.argsort(merged_k, kind="stable")
            merged_k = merged_k[order]
            merged_v = merged_v[order]
            starts = np.flatnonzero(
                np.concatenate(([True], merged_k[1:] != merged_k[:-1])))
            key_blocks.append(merged_k[starts])
            val_blocks.append(
                np.add.reduceat(merged_v.astype(np.float64), starts)
                .astype(np.float32))
        for p in shards:
            for suffix in (".keys.npy", ".x.npy"):
                try:
                    os.unlink(p + suffix)
                except OSError:
                    pass
        packed = np.concatenate(key_blocks)
        return ((packed >> 32).astype(np.int32),
                (packed & 0xFFFFFFFF).astype(np.int32),
                np.concatenate(val_blocks))

    def init_tables(self, n: int) -> tuple:
        """The eight fresh tables: w and w̃ ~ U(-0.5/d, 0.5/d) (one CPU
        generator seeded with ``seed``, w drawn first), zero biases, and
        AdaGrad histories at 1e-8."""
        d = self.layer_size
        scale = 0.5 / d
        gen = torch.Generator().manual_seed(int(self.seed))
        w, wc = (torch.rand((n, d), generator=gen) * (2 * scale) - scale
                 for _ in range(2))
        f32 = dict(dtype=torch.float32)
        tables = (w, wc, torch.zeros((n,), **f32), torch.zeros((n,), **f32),
                  torch.full((n, d), 1e-8, **f32),
                  torch.full((n, d), 1e-8, **f32),
                  torch.full((n,), 1e-8, **f32), torch.full((n,), 1e-8, **f32))
        return tuple(t.to(self.device) for t in tables)

    def fit(self, _orders=None) -> "Glove":
        """Count, then train ``epochs`` epochs. ``_orders`` (tests): one
        permutation of the padded triples per epoch, replacing the drawn
        ones."""
        from deeplearning4j_tpu_torch.nlp.epoch_kernels import (
            epoch_generator,
            epoch_keys_for,
        )

        if self.vocab is None:
            self.vocab = build_vocab(self._sentences_tokens(),
                                     self.min_word_frequency)
        rows, cols, x = self.count_cooccurrences()
        n = self.vocab.num_words()
        if self._start_tables is not None:
            tables, self._start_tables = self._start_tables, None
        else:
            tables = self.init_tables(n)
        logx = np.log(np.maximum(x, 1e-12)).astype(np.float32)
        fx = np.minimum(1.0, (x / self.x_max) ** self.alpha).astype(np.float32)
        if len(rows) == 0 or self.epochs <= 0:
            self.syn0 = tables[0] + tables[1]
            self._loss = float("nan")
            return self
        # pad the triples to N*B with fx=0 (inert under the masked step)
        batch = min(self.batch_size, max(32, len(rows) // 8))
        n_batches = -(-len(rows) // batch)
        total = n_batches * batch
        pad = total - len(rows)
        dev = self.device
        triples = tuple(torch.from_numpy(np.pad(a, (0, pad))).to(dev)
                        for a in (rows.astype(np.int32), cols.astype(np.int32),
                                  logx, fx))
        if _orders is not None:
            orders = [torch.from_numpy(np.array(o, dtype=np.int64)).to(dev)
                      for o in _orders[:self.epochs]]
        else:
            orders = [torch.randperm(total, generator=epoch_generator(s, dev),
                                     device=dev)
                      for s in epoch_keys_for(self.seed, 0, self.epochs)]
        key = (n, self.layer_size, n_batches, batch)
        run = self._runs.get(key)
        if run is None:
            run = self._runs[key] = _GloveRun(n, self.layer_size, n_batches,
                                              batch, dev)
        hist = run.run(tables, triples, self.learning_rate, orders)
        self._train_dispatches += 1
        w, wc = run.tables[0], run.tables[1]
        self.syn0 = w + wc  # standard GloVe merge
        self._history = hist
        self._loss = float(hist[-1, -1])
        return self

    # --- lookups (same surface as Word2Vec), on the host ---
    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        idx = self.vocab.index_of(word)
        return None if idx < 0 else to_host(self.syn0[idx])

    def similarity(self, w1: str, w2: str) -> float:
        a, b = self.get_word_vector(w1), self.get_word_vector(w2)
        if a is None or b is None:
            return float("nan")
        return float(np.dot(a, b)
                     / ((np.linalg.norm(a) + 1e-12) * (np.linalg.norm(b) + 1e-12)))

    def words_nearest(self, word: str, top_n: int = 10) -> List[str]:
        v = self.get_word_vector(word)
        syn0 = to_host(self.syn0)
        n = syn0 / (np.linalg.norm(syn0, axis=1, keepdims=True) + 1e-12)
        sims = n @ (v / (np.linalg.norm(v) + 1e-12))
        sims[self.vocab.index_of(word)] = -np.inf
        return [self.vocab.word_at_index(int(i))
                for i in np.argsort(-sims)[:top_n]]
