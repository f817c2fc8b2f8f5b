"""ParagraphVectors (doc2vec): PV-DBOW with labels as pseudo-words.

Port of ``deeplearning4j_tpu/nlp/paragraph_vectors.py`` (models/
paragraphvectors/ParagraphVectors.java:37 and learning/impl/sequence/
DBOW.java in the reference project). Label rows live at the end of the
embedding table; PV-DBOW trains each label row to predict the words of its
document with Word2Vec's negative-sampling step, on the card
(``device=None``) or on ``device``. The host draws (order, negatives) are
numpy's, as in the reference. ``infer_vector`` gradient-fits a fresh row
against the frozen word tables on the host (numpy), as the reference does.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.sentence_iterator import (
    LabelAwareSentenceIterator,
)
from deeplearning4j_tpu_torch.nlp.word2vec import (
    Word2Vec,
    _neg_sampling_math,
    to_host,
    uniform_init,
)


class ParagraphVectors(Word2Vec):
    class Builder(Word2Vec.Builder):
        def labels_source(self, labels: Sequence[str]):
            self._kw["labels"] = list(labels)
            return self

        def build(self) -> "ParagraphVectors":
            return ParagraphVectors(**self._kw)

    def __init__(self, labels: Optional[List[str]] = None, **kw):
        super().__init__(**kw)
        self.labels = labels
        self._label_offset = 0  # index of first label row in syn0
        # tables carried in by models.convert.load_embeddings_from_jax:
        # fit starts from them instead of a fresh init
        self._start_tables = None

    # ------------------------------------------------------------------
    def _documents(self):
        """(label, tokens) pairs from a label-aware iterator or generated
        DOC_n labels."""
        it = self.sentence_iterator
        it.reset()
        docs = []
        if isinstance(it, LabelAwareSentenceIterator):
            while it.has_next():
                s = it.next_sentence()
                docs.append((it.current_label(),
                             self.tokenizer_factory.create(s).get_tokens()))
        else:
            for i, s in enumerate(it):
                docs.append((f"DOC_{i}",
                             self.tokenizer_factory.create(s).get_tokens()))
        return docs

    def fit(self) -> "ParagraphVectors":
        docs = self._documents()
        if self.vocab is None:
            from deeplearning4j_tpu_torch.nlp.vocab import (
                build_vocab,
                unigram_table,
            )

            self.vocab = build_vocab((t for _, t in docs),
                                     self.min_word_frequency)
            self._table = unigram_table(self.vocab, self.table_size)
        self._label_offset = self.vocab.num_words()
        self.doc_labels = [label for label, _ in docs]
        label_index = {l: i for i, l in enumerate(self.doc_labels)}

        n_words = self.vocab.num_words()
        n_rows = n_words + len(self.doc_labels)
        d = self.layer_size
        if self._start_tables is not None:
            self.syn0, self.syn1neg = self._start_tables
            self._start_tables = None
        else:
            self.syn0 = (uniform_init(self.seed, (n_rows, d), self.device)
                         - 0.5) / d
            self.syn1neg = torch.zeros((n_words, d), dtype=torch.float32,
                                       device=self.device)

        # PV-DBOW pairs: (label_row, word)
        centers, contexts = [], []
        for label, tokens in docs:
            li = self._label_offset + label_index[label]
            for t in tokens:
                wi = self.vocab.index_of(t)
                if wi >= 0:
                    centers.append(li)
                    contexts.append(wi)
        centers = np.asarray(centers, np.int32)
        contexts = np.asarray(contexts, np.int32)

        planned = max(1, self.epochs)
        step = 0
        batch_size = min(self.batch_size, max(32, len(centers) // 8))
        for epoch in range(self.epochs):
            order = self._rng.permutation(len(centers))
            for s in range(0, len(order), batch_size):
                sel = order[s:s + batch_size]
                frac = step / max(1, planned * max(1, len(centers) // batch_size))
                lr = max(self.min_learning_rate,
                         self.learning_rate * (1.0 - frac))
                negs = self._sample_negatives(len(sel), contexts[sel])
                self.syn0, self.syn1neg, self._score = _neg_sampling_math(
                    self.syn0, self.syn1neg, self._dev(centers[sel]),
                    self._dev(contexts[sel]), self._dev(negs), lr)
                step += 1
        self._norm_cache = None
        return self

    # ------------------------------------------------------------------
    def get_label_vector(self, label: str) -> Optional[np.ndarray]:
        if label not in self.doc_labels:
            return None
        idx = self._label_offset + self.doc_labels.index(label)
        return to_host(self.syn0[idx])

    def predict(self, text: str) -> str:
        """Nearest document label for a text (reference's label-lookup
        predict())."""
        v = self.infer_vector(text)
        best, best_sim = None, -np.inf
        for label in self.doc_labels:
            lv = self.get_label_vector(label)
            sim = float(np.dot(v, lv)
                        / ((np.linalg.norm(v) + 1e-12)
                           * (np.linalg.norm(lv) + 1e-12)))
            if sim > best_sim:
                best, best_sim = label, sim
        return best

    def infer_vector(self, text: str, steps: int = 50,
                     lr: float = 0.05) -> np.ndarray:
        """Fit a fresh doc vector against frozen word tables."""
        tokens = self.tokenizer_factory.create(text).get_tokens()
        word_idx = np.asarray(
            [self.vocab.index_of(t) for t in tokens if self.vocab.index_of(t) >= 0],
            np.int32)
        rng = np.random.default_rng(self.seed)
        v = ((rng.random(self.layer_size).astype(np.float32) - 0.5)
             / self.layer_size)
        if len(word_idx) == 0:
            return v
        syn1neg = to_host(self.syn1neg)
        for step in range(steps):
            cur_lr = lr * (1.0 - step / steps)
            negs = self._sample_negatives(len(word_idx), word_idx)
            v_pos = syn1neg[word_idx]
            s_pos = 1.0 / (1.0 + np.exp(-v_pos @ v))
            g = np.sum((s_pos - 1.0)[:, None] * v_pos, axis=0)
            v_neg = syn1neg[negs.ravel()]
            s_neg = 1.0 / (1.0 + np.exp(-v_neg @ v))
            g += np.sum(s_neg[:, None] * v_neg, axis=0)
            v -= cur_lr * g / max(1, len(word_idx))
        return v

    def similarity_to_label(self, text: str, label: str) -> float:
        v = self.infer_vector(text)
        lv = self.get_label_vector(label)
        return float(np.dot(v, lv)
                     / ((np.linalg.norm(v) + 1e-12)
                        * (np.linalg.norm(lv) + 1e-12)))
