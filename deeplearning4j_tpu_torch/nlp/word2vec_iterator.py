"""Word2VecDataSetIterator — labeled text → DataSets of window embeddings.

Port of ``deeplearning4j_tpu/nlp/word2vec_iterator.py`` (models/word2vec/
iterator/Word2VecDataSetIterator.java in the reference project): a moving
window slides over each labeled sentence, the word vectors of a window are
concatenated into one feature row, and the sentence's label is one-hot
for every window. Only int32 window-index rows and label ids are kept on
the host; each batch is one gather from the vectors' table on the device
the vectors live on, so a fitted model on the card yields batches on the
card.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator
from deeplearning4j_tpu_torch.nlp.movingwindow import window_indices


class Word2VecDataSetIterator(DataSetIterator):
    """Iterate DataSets whose rows are flattened word-vector windows.

    ``vectors``: a fitted Word2Vec/SequenceVectors (needs ``vocab`` +
    ``syn0``); ``labeled_sentences``: (tokens, label) pairs; ``labels``:
    the label universe (order fixes one-hot columns).
    """

    def __init__(self, vectors, labeled_sentences: Sequence[Tuple[Sequence[str], str]],
                 labels: Sequence[str], window_size: int = 5,
                 batch: int = 32):
        if vectors.vocab is None or vectors.syn0 is None:
            raise ValueError("vectors must be fitted (vocab + syn0)")
        self.vectors = vectors
        self.window_size = window_size
        self._batch_size = batch
        self.labels = list(labels)
        label_index = {l: i for i, l in enumerate(self.labels)}
        syn0 = vectors.syn0
        self._dim = int(syn0.shape[1])
        # row 0 stands in for padding/unknown — zero it so <s>/unk windows
        # contribute nothing rather than an arbitrary word's vector
        self._table = torch.cat(
            [torch.zeros((1, self._dim), dtype=syn0.dtype,
                         device=syn0.device), syn0]).to(torch.float32)
        self._eye = torch.eye(len(self.labels), dtype=torch.float32,
                              device=syn0.device)
        shifted = {w: vectors.vocab.index_of(w) + 1
                   for w in vectors.vocab.words()}

        idx_rows: List[np.ndarray] = []
        ys: List[int] = []
        for tokens, label in labeled_sentences:
            if label not in label_index:
                raise ValueError(f"unknown label {label!r}")
            toks = list(tokens)
            if not toks:
                continue
            idx = window_indices(toks, shifted, window_size, unk_index=0)
            idx_rows.append(idx)
            ys.extend([label_index[label]] * idx.shape[0])
        self._indices = (np.concatenate(idx_rows) if idx_rows
                         else np.zeros((0, window_size), np.int32))
        self._label_ids = np.asarray(ys, np.int64)
        self._pos = 0

    # -- DataSetIterator surface ---------------------------------------
    def has_next(self) -> bool:
        return self._pos < len(self._indices)

    def next(self, num: Optional[int] = None) -> DataSet:
        n = num or self._batch_size
        dev = self._table.device
        idx = torch.from_numpy(
            self._indices[self._pos:self._pos + n].astype(np.int64)).to(dev)
        ys = torch.from_numpy(self._label_ids[self._pos:self._pos + n]).to(dev)
        self._pos += n
        feats = self._table[idx].reshape(idx.shape[0], -1)
        return DataSet(feats, self._eye[ys])

    def reset(self) -> None:
        self._pos = 0

    def batch(self) -> int:  # DataSetIterator protocol
        return self._batch_size

    def batch_size(self) -> int:
        return self._batch_size

    def total_examples(self) -> int:
        return len(self._indices)

    def input_columns(self) -> int:
        return self.window_size * self._dim

    def total_outcomes(self) -> int:
        return len(self.labels)
