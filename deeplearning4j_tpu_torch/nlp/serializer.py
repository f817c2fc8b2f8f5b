"""WordVectorSerializer: Google word2vec text/binary format round-trip.

Mirror of models/embeddings/loader/WordVectorSerializer.java (1,257 LoC:
writeWordVectors/loadTxtVectors, the Google binary format, zip model
format). The text and binary formats here are byte-compatible with the
C word2vec release so vectors interchange with gensim/word2vec tooling.

Port of ``deeplearning4j_tpu/nlp/serializer.py``: the same files, so a
file written by either package reads in the other with equal vectors.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

import torch

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache
from deeplearning4j_tpu_torch.nlp.word2vec import to_host


def write_word_vectors(model, path: str) -> None:
    """Text format: first line ``n d``, then ``word v1 ... vd`` per line."""
    vocab: VocabCache = model.vocab
    syn0 = to_host(model.syn0)[:vocab.num_words()]
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"{vocab.num_words()} {syn0.shape[1]}\n")
        for i in range(vocab.num_words()):
            vec = " ".join(f"{v:.6f}" for v in syn0[i])
            f.write(f"{vocab.word_at_index(i)} {vec}\n")


def load_txt_vectors(path: str) -> Tuple[VocabCache, np.ndarray]:
    with open(path, encoding="utf-8") as f:
        header = f.readline().split()
        n, d = int(header[0]), int(header[1])
        vocab = VocabCache()
        syn0 = np.zeros((n, d), np.float32)
        for i in range(n):
            parts = f.readline().rstrip("\n").split(" ")
            vocab.add_token(parts[0])
            syn0[i] = [float(v) for v in parts[1:d + 1]]
    return vocab, syn0


def write_binary(model, path: str) -> None:
    """Google word2vec binary format (float32 little-endian rows)."""
    vocab: VocabCache = model.vocab
    syn0 = np.asarray(to_host(model.syn0), np.float32)[:vocab.num_words()]
    with open(path, "wb") as f:
        f.write(f"{vocab.num_words()} {syn0.shape[1]}\n".encode())
        for i in range(vocab.num_words()):
            f.write(vocab.word_at_index(i).encode("utf-8") + b" ")
            f.write(syn0[i].tobytes())
            f.write(b"\n")


def load_binary(path: str) -> Tuple[VocabCache, np.ndarray]:
    with open(path, "rb") as f:
        header = f.readline().split()
        n, d = int(header[0]), int(header[1])
        vocab = VocabCache()
        syn0 = np.zeros((n, d), np.float32)
        for i in range(n):
            word = bytearray()
            while True:
                ch = f.read(1)
                if ch == b" ":
                    break
                word.extend(ch)
            vocab.add_token(word.decode("utf-8"))
            syn0[i] = np.frombuffer(f.read(4 * d), np.float32)
            f.read(1)  # trailing newline
    return vocab, syn0


def load_word_vectors(path: str, binary: bool = False, device=None):
    """Returns an object with the Word2Vec lookup surface
    (get_word_vector/similarity/words_nearest), its table on ``device``
    (``None``: the card)."""
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

    vocab, syn0 = (load_binary(path) if binary else load_txt_vectors(path))
    model = Word2Vec.__new__(Word2Vec)
    model.device = resolve_device(device)
    model.vocab = vocab
    model.syn0 = torch.from_numpy(syn0).to(model.device)
    model.layer_size = syn0.shape[1]
    model._norm_cache = None
    return model
