"""In-memory inverted index for corpus sampling and TF-IDF.

Re-design of ``deeplearning4j-nlp/.../text/invertedindex/
LuceneInvertedIndex.java`` (919 LoC). The reference embeds Lucene to store
documents and sample mini-batches for word2vec training; this build keeps
the same surface (index documents, look up by word, iterate document
batches, mini-batch sampling) on plain dicts — the training batcher is the
device-side consumer, so the index only needs fast host lookups, not a
search engine.

A copy of ``deeplearning4j_tpu/nlp/invertedindex.py``: the port keeps its own,
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import math
import random
import threading
from typing import Dict, Iterator, List, Optional, Sequence


class InvertedIndex:
    """word → posting list of document ids (LuceneInvertedIndex surface:
    addWordsToDoc, document(s), numDocuments, eachDoc/batchIter)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._docs: Dict[int, List[str]] = {}
        self._doc_ids: List[int] = []  # insertion order (sampling/batching)
        self._postings: Dict[str, List[int]] = {}
        self._labels: Dict[int, Optional[str]] = {}

    # -- indexing -------------------------------------------------------
    def _insert(self, doc_id: int, words: Sequence[str],
                label: Optional[str]) -> None:
        # caller holds self._lock
        if doc_id in self._docs:
            raise KeyError(f"doc {doc_id} already indexed")
        self._docs[doc_id] = list(words)
        self._doc_ids.append(doc_id)
        self._labels[doc_id] = label
        seen = set()
        for w in words:
            if w not in seen:
                self._postings.setdefault(w, []).append(doc_id)
                seen.add(w)

    def add_words_to_doc(self, doc_id: int, words: Sequence[str],
                         label: Optional[str] = None) -> None:
        with self._lock:
            self._insert(doc_id, words, label)

    def add_doc(self, words: Sequence[str],
                label: Optional[str] = None) -> int:
        # id allocation + insert under ONE lock acquisition: two concurrent
        # add_doc calls must never claim the same id
        with self._lock:
            doc_id = len(self._docs)
            self._insert(doc_id, words, label)
        return doc_id

    # -- lookups (locked: concurrent indexing must not break iteration) --
    def document(self, doc_id: int) -> List[str]:
        with self._lock:
            return list(self._docs[doc_id])

    def label(self, doc_id: int) -> Optional[str]:
        with self._lock:
            return self._labels[doc_id]

    def documents(self, word: str) -> List[int]:
        with self._lock:
            return list(self._postings.get(word, []))

    def num_documents(self, word: Optional[str] = None) -> int:
        with self._lock:
            if word is None:
                return len(self._docs)
            return len(self._postings.get(word, []))

    def terms(self) -> List[str]:
        with self._lock:
            return sorted(self._postings)

    def doc_frequency(self, word: str) -> int:
        with self._lock:
            return len(self._postings.get(word, []))

    def idf(self, word: str) -> float:
        n, df = self.num_documents(), self.doc_frequency(word)
        return math.log((1 + n) / (1 + df)) + 1.0

    def tfidf(self, doc_id: int) -> Dict[str, float]:
        doc = self.document(doc_id)
        out: Dict[str, float] = {}
        for w in doc:
            out[w] = out.get(w, 0.0) + 1.0
        inv_len = 1.0 / max(len(doc), 1)
        return {w: tf * inv_len * self.idf(w) for w, tf in out.items()}

    # -- batching (the word2vec-feeding role) ---------------------------
    def each_doc(self) -> Iterator[List[str]]:
        with self._lock:
            ids = list(self._doc_ids)
        for doc_id in ids:
            yield self.document(doc_id)

    def batch_iter(self, batch_size: int,
                   shuffle: bool = False,
                   seed: Optional[int] = None) -> Iterator[List[List[str]]]:
        with self._lock:
            ids = list(self._doc_ids)
        if shuffle:
            random.Random(seed).shuffle(ids)
        for i in range(0, len(ids), batch_size):
            yield [self.document(d) for d in ids[i:i + batch_size]]

    def sample_doc(self, rng: random.Random) -> List[str]:
        with self._lock:
            if not self._doc_ids:
                raise IndexError("empty index")
            doc_id = rng.choice(self._doc_ids)
        return self.document(doc_id)
