"""Bag-of-words / TF-IDF vectorizers.

Mirror of bagofwords/vectorizer/ (BaseTextVectorizer, TfidfVectorizer,
BagOfWordsVectorizer — SURVEY §2.4): documents → count or tf-idf feature
matrices + optional label one-hots, feeding the standard DataSet pipeline.

A copy of ``deeplearning4j_tpu/nlp/bagofwords.py``: the port keeps its own,
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory,
    TokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, build_vocab


class BaseTextVectorizer:
    def __init__(self, tokenizer_factory: Optional[TokenizerFactory] = None,
                 min_word_frequency: int = 1,
                 stop_words: Sequence[str] = ()):
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.min_word_frequency = min_word_frequency
        self.stop_words = set(stop_words)
        self.vocab: Optional[VocabCache] = None
        self._doc_freq: Optional[np.ndarray] = None
        self.num_docs = 0

    def _tokens(self, text: str) -> List[str]:
        return [t for t in self.tokenizer_factory.create(text).get_tokens()
                if t not in self.stop_words]

    def fit(self, documents: Sequence[str]) -> "BaseTextVectorizer":
        token_docs = [self._tokens(d) for d in documents]
        self.vocab = build_vocab(token_docs, self.min_word_frequency)
        self.num_docs = len(documents)
        df = np.zeros(self.vocab.num_words(), np.float64)
        for toks in token_docs:
            for idx in {self.vocab.index_of(t) for t in toks}:
                if idx >= 0:
                    df[idx] += 1
        self._doc_freq = df
        return self

    def transform(self, document: str) -> np.ndarray:
        raise NotImplementedError

    def vectorize(self, documents: Sequence[str],
                  labels: Optional[Sequence[int]] = None,
                  num_classes: Optional[int] = None) -> DataSet:
        x = np.stack([self.transform(d) for d in documents])
        y = None
        if labels is not None:
            n_cls = num_classes or (max(labels) + 1)
            y = np.eye(n_cls, dtype=np.float32)[np.asarray(labels)]
        return DataSet(x.astype(np.float32), y)


class BagOfWordsVectorizer(BaseTextVectorizer):
    def transform(self, document: str) -> np.ndarray:
        x = np.zeros(self.vocab.num_words(), np.float32)
        for t in self._tokens(document):
            idx = self.vocab.index_of(t)
            if idx >= 0:
                x[idx] += 1.0
        return x


class TfidfVectorizer(BaseTextVectorizer):
    """tf-idf with the reference's smooth idf: log(numDocs / df)."""

    def transform(self, document: str) -> np.ndarray:
        counts = np.zeros(self.vocab.num_words(), np.float64)
        toks = self._tokens(document)
        for t in toks:
            idx = self.vocab.index_of(t)
            if idx >= 0:
                counts[idx] += 1.0
        tf = counts / max(len(toks), 1)
        idf = np.where(self._doc_freq > 0,
                       np.log(self.num_docs / np.maximum(self._doc_freq, 1e-12)),
                       0.0)
        return (tf * idf).astype(np.float32)
