"""Vocabulary construction + Huffman coding.

Mirror of models/word2vec/wordstore/ (VocabConstructor.java:397 parallel
vocab count, VocabularyHolder, InMemoryLookupCache) and
models/word2vec/Huffman.java:34 (Huffman tree assignment for hierarchical
softmax). Host-side, numpy-backed; the device only ever sees index arrays.

A copy of ``deeplearning4j_tpu/nlp/vocab.py``: the port keeps its own,
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import heapq
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


class VocabWord:
    __slots__ = ("word", "count", "index", "codes", "points")

    def __init__(self, word: str, count: int = 1, index: int = -1):
        self.word = word
        self.count = count
        self.index = index
        self.codes: Optional[np.ndarray] = None   # Huffman code bits
        self.points: Optional[np.ndarray] = None  # inner-node indices

    def __repr__(self):
        return f"VocabWord({self.word!r}, count={self.count}, index={self.index})"


class VocabCache:
    """word ↔ index ↔ count store (VocabCache/InMemoryLookupCache)."""

    def __init__(self):
        self._words: Dict[str, VocabWord] = {}
        self._by_index: List[VocabWord] = []
        self.total_word_count = 0

    def add_token(self, word: str, count: int = 1):
        vw = self._words.get(word)
        if vw is None:
            vw = VocabWord(word, 0, len(self._by_index))
            self._words[word] = vw
            self._by_index.append(vw)
        vw.count += count
        self.total_word_count += count

    def has_token(self, word: str) -> bool:
        return word in self._words

    def word_for(self, word: str) -> Optional[VocabWord]:
        return self._words.get(word)

    def index_of(self, word: str) -> int:
        vw = self._words.get(word)
        return -1 if vw is None else vw.index

    def word_at_index(self, index: int) -> str:
        return self._by_index[index].word

    def word_frequency(self, word: str) -> int:
        vw = self._words.get(word)
        return 0 if vw is None else vw.count

    def num_words(self) -> int:
        return len(self._by_index)

    def words(self) -> List[str]:
        return [vw.word for vw in self._by_index]

    def vocab_words(self) -> List[VocabWord]:
        return list(self._by_index)

    def truncate(self, min_word_frequency: int) -> "VocabCache":
        """Drop rare words, reassigning indices by descending count (the
        reference sorts the vocab by frequency before Huffman)."""
        kept = [vw for vw in self._by_index if vw.count >= min_word_frequency]
        kept.sort(key=lambda vw: (-vw.count, vw.word))
        out = VocabCache()
        for vw in kept:
            out.add_token(vw.word, vw.count)
        return out


def build_vocab(sentences: Iterable[Sequence[str]],
                min_word_frequency: int = 1) -> VocabCache:
    """VocabConstructor.buildJointVocabulary equivalent."""
    counts = Counter()
    for tokens in sentences:
        counts.update(tokens)
    cache = VocabCache()
    for word, count in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])):
        if count >= min_word_frequency:
            cache.add_token(word, count)
    return cache


class Huffman:
    """Huffman-code the vocab for hierarchical softmax (Huffman.java:34).

    Assigns each VocabWord its ``codes`` (bit path, 0/1) and ``points``
    (inner-node indices, < num_words-1), root first — matching word2vec's
    layout where syn1 holds one row per inner node.
    """

    def __init__(self, vocab: VocabCache):
        self.vocab = vocab

    def build(self) -> None:
        words = self.vocab.vocab_words()
        n = len(words)
        if n == 0:
            return
        # heap of (count, tiebreak, node_id); leaves are 0..n-1, inner nodes
        # n..2n-2
        heap = [(vw.count, i, i) for i, vw in enumerate(words)]
        heapq.heapify(heap)
        parent = {}
        bit = {}
        next_id = n
        while len(heap) > 1:
            c1, _, a = heapq.heappop(heap)
            c2, _, b = heapq.heappop(heap)
            parent[a], bit[a] = next_id, 0
            parent[b], bit[b] = next_id, 1
            heapq.heappush(heap, (c1 + c2, next_id, next_id))
            next_id += 1
        root = heap[0][2]
        for i, vw in enumerate(words):
            codes, points = [], []
            node = i
            while node != root:
                codes.append(bit[node])
                points.append(parent[node] - n)  # inner-node index
                node = parent[node]
            codes.reverse()
            points.reverse()
            vw.codes = np.asarray(codes, np.int32)
            vw.points = np.asarray(points, np.int32)


def padded_paths(codes_list, points_list):
    """Pad per-row Huffman paths into the [R, C] (points, codes, mask)
    layout consumed by the HS step (shared by word2vec and DeepWalk).

    ``codes_list[i]``/``points_list[i]`` are the row's bit path and
    inner-node indices (or None for an uncodable row).
    """
    rows = len(codes_list)
    c = max((len(x) for x in codes_list if x is not None), default=0)
    c = max(c, 1)
    points = np.zeros((rows, c), np.int32)
    codes = np.zeros((rows, c), np.float32)
    mask = np.zeros((rows, c), np.float32)
    for i, path in enumerate(codes_list):
        if path is None:
            continue
        k = len(path)
        points[i, :k] = points_list[i]
        codes[i, :k] = path
        mask[i, :k] = 1.0
    return points, codes, mask


def padded_huffman_paths(vocab: VocabCache):
    """(points, codes, mask) for a Huffman-coded vocab, row = word index."""
    n = vocab.num_words()
    codes_list = [None] * n
    points_list = [None] * n
    for vw in vocab.vocab_words():
        codes_list[vw.index] = vw.codes
        points_list[vw.index] = vw.points
    return padded_paths(codes_list, points_list)


def subsample_keep_prob(vocab: VocabCache, sampling: float) -> np.ndarray:
    """``[V]`` frequent-word keep probabilities (SkipGram's sampling
    rule): ``keep = (sqrt(f/s) + 1) * s/f`` clipped to [0, 1], all-ones
    when sampling is off. ONE derivation shared by the host emitter
    (``Word2Vec._corpus_indices``) and the device corpus cache
    (``nlp/epoch_kernels``) so both paths subsample the same
    distribution."""
    n = vocab.num_words()
    if sampling <= 0 or n == 0:
        return np.ones((max(n, 1),), np.float32)
    total = max(vocab.total_word_count, 1)
    counts = np.asarray([w.count for w in vocab.vocab_words()], np.float64)
    f = np.maximum(counts / total, 1e-12)
    keep = (np.sqrt(f / sampling) + 1.0) * sampling / f
    return np.clip(keep, 0.0, 1.0).astype(np.float32)


def unigram_table(vocab: VocabCache, table_size: int = 1_000_000,
                  power: float = 0.75) -> np.ndarray:
    """Negative-sampling unigram table (InMemoryLookupTable's ``table``):
    word i appears proportional to count^0.75."""
    counts = np.asarray([vw.count for vw in vocab.vocab_words()], np.float64)
    probs = counts ** power
    probs /= probs.sum()
    return np.random.default_rng(0).choice(
        len(counts), size=table_size, p=probs).astype(np.int32)
