"""HMM part-of-speech tagger decoded on the device by the Viterbi recursion.

Closes the POS leg of the reference's UIMA/OpenNLP text pipeline
(``deeplearning4j-scaleout/deeplearning4j-nlp/.../text/corpora/treeparser/
TreeParser.java`` drove an OpenNLP POS tagger + chunker behind UIMA
annotators). The package bundles no model binaries, so the same
capability is a bigram HMM ESTIMATED from any tagged corpus the user has
(word/TAG pairs — the Penn Treebank distribution format):

- :meth:`HmmPosTagger.fit` counts tag-transition, tag-emission, and
  initial-tag frequencies with add-k smoothing; singleton words double as
  the unknown-word distribution per tag, optionally sharpened by common
  English suffix/shape features.
- :meth:`HmmPosTagger.tag` builds the [T, S] emission log-score matrix on
  the host and decodes the argmax tag path with the port's
  :class:`~.viterbi.Viterbi` — the DP runs on the tagger's device.

Pairs with :class:`~deeplearning4j_tpu_torch.nlp.treeparser.TreebankParser`
(tags feed grammar symbols) and HeadWordFinder (percolation reads tags).

A copy of ``deeplearning4j_tpu/nlp/postagger.py``: the port keeps its own,
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch._device import DeviceLike, resolve_device

_UNK = "*UNK*"

# cheap word-shape features for unknown words: (predicate, pseudo-word).
# First match wins; purely lexical, no language model needed.
_SHAPE_FEATURES = (
    (lambda w: any(c.isdigit() for c in w), "*NUM*"),
    (lambda w: w.endswith("ing"), "*ING*"),
    (lambda w: w.endswith("ed"), "*ED*"),
    (lambda w: w.endswith("ly"), "*LY*"),
    (lambda w: w.endswith("s") and len(w) > 2, "*S*"),
    (lambda w: w[:1].isupper(), "*CAP*"),
)


def _shape(word: str) -> Optional[str]:
    for pred, pseudo in _SHAPE_FEATURES:
        if pred(word):
            return pseudo
    return None


class HmmPosTagger:
    """Bigram HMM tagger: P(tags, words) = Π P(t|t_prev)·P(w|t)."""

    def __init__(self, smoothing: float = 0.1, device: DeviceLike = None):
        self.smoothing = float(smoothing)
        # the Viterbi decode runs here (resolved now, so a missing card
        # shows at construction)
        self.device = resolve_device(device)
        self.tags: List[str] = []
        self._tag_index: Dict[str, int] = {}
        # emission[tag_id]: {word: log P(word|tag)} incl. *UNK* and shapes
        self._emission: List[Dict[str, float]] = []
        self._viterbi = None
        self._fitted = False

    # -- training ------------------------------------------------------
    def fit(self, tagged_sentences: Sequence[Sequence[Tuple[str, str]]]
            ) -> "HmmPosTagger":
        """``tagged_sentences``: iterable of [(word, tag), ...] sentences."""
        from deeplearning4j_tpu_torch.nlp.viterbi import Viterbi

        emit: Dict[str, Dict[str, float]] = defaultdict(
            lambda: defaultdict(float))
        word_freq: Dict[str, float] = defaultdict(float)
        tag_set: Dict[str, int] = {}
        rows: List[List[str]] = []  # per-sentence tag sequences
        for sent in tagged_sentences:
            if not sent:  # blank lines in word/TAG files
                continue
            rows.append([t for _, t in sent])
            for w, t in sent:
                tag_set.setdefault(t, len(tag_set))
                emit[t][w] += 1.0
                word_freq[w] += 1.0
        if not tag_set:
            raise ValueError("no non-empty tagged sentences")
        self.tags = sorted(tag_set, key=tag_set.get)
        self._tag_index = {t: i for i, t in enumerate(self.tags)}
        S = len(self.tags)

        trans = np.full((S, S), self.smoothing, np.float64)
        initial = np.full((S,), self.smoothing, np.float64)
        for tags in rows:
            initial[self._tag_index[tags[0]]] += 1.0
            for a, b in zip(tags, tags[1:]):
                trans[self._tag_index[a], self._tag_index[b]] += 1.0

        self._emission = []
        for tag in self.tags:
            counts = dict(emit[tag])
            # singletons estimate the open-class mass: they stand in for
            # words never seen with this tag, bucketed by shape
            unk = self.smoothing
            shapes: Dict[str, float] = defaultdict(float)
            for w, c in counts.items():
                if word_freq[w] <= 1.0:
                    unk += c
                    sh = _shape(w)
                    if sh:
                        shapes[sh] += c
            counts[_UNK] = unk
            for sh, c in shapes.items():
                counts[sh] = counts.get(sh, 0.0) + c
            total = sum(counts.values())
            self._emission.append(
                {w: math.log(c / total) for w, c in counts.items()})

        log_trans = np.log(trans / trans.sum(axis=1, keepdims=True))
        log_init = np.log(initial / initial.sum())
        self._log_trans = log_trans.astype(np.float32)
        self._log_init = log_init.astype(np.float32)
        self._viterbi = Viterbi(S, transitions=self._log_trans,
                                initial=self._log_init, device=self.device)
        self._fitted = True
        return self

    # -- tagging -------------------------------------------------------
    # penalty (nats) for a tag with NO evidence of an OOV word's shape,
    # when other tags have such evidence: shape buckets hold a SUBSET of
    # each tag's UNK mass, so comparing one tag's bucket against another
    # tag's full UNK mass would invert the ranking (a tag that never
    # emitted plurals would beat the plural tag on an OOV plural)
    _SHAPE_MISS_PENALTY = 2.5

    def _emission_row(self, word: str) -> np.ndarray:
        row = np.empty((len(self.tags),), np.float32)
        sh = _shape(word)
        for i, dist in enumerate(self._emission):
            lp = dist.get(word)
            if lp is None:
                if sh is not None:
                    lp = dist.get(sh)
                    if lp is None:
                        lp = (dist.get(_UNK, -30.0)
                              - self._SHAPE_MISS_PENALTY)
                else:
                    lp = dist.get(_UNK, -30.0)
            row[i] = lp
        return row

    def emissions(self, tokens: Sequence[str]) -> np.ndarray:
        """The [T, S] emission log-score matrix of a token sequence."""
        emissions = np.zeros((len(tokens), len(self.tags)), np.float32)
        for i, w in enumerate(tokens):
            emissions[i] = self._emission_row(w)
        return emissions

    def tag_tokens(self, tokens: Sequence[str]) -> List[Tuple[str, str]]:
        if not self._fitted:
            raise RuntimeError("fit() the tagger before tagging")
        tokens = list(tokens)
        if not tokens:
            return []
        # decoded at the true length: the reference pads to a bucket only
        # to bound its recompiles, and its masked padding is inert
        path, _ = self._viterbi.decode(self.emissions(tokens))
        return [(w, self.tags[int(s)]) for w, s in zip(tokens, path)]

    def tag(self, sentence: str) -> List[Tuple[str, str]]:
        """Raw sentence → [(word, tag), ...]."""
        from deeplearning4j_tpu_torch.nlp.tokenization import (
            DefaultTokenizerFactory)

        return self.tag_tokens(
            DefaultTokenizerFactory().create(sentence).get_tokens())

    # -- persistence (SerializationUtils role for trained taggers) ------
    def to_dict(self) -> dict:
        if not self._fitted:
            raise RuntimeError("fit() the tagger before serializing")
        return {
            "format": "deeplearning4j-tpu/HmmPosTagger",
            "smoothing": self.smoothing,
            "tags": self.tags,
            "emission": self._emission,
            "log_trans": self._log_trans.tolist(),
            "log_init": self._log_init.tolist(),
        }

    @staticmethod
    def from_dict(d: dict, device: DeviceLike = None) -> "HmmPosTagger":
        import numpy as _np

        from deeplearning4j_tpu_torch.nlp.viterbi import Viterbi

        t = HmmPosTagger(smoothing=float(d.get("smoothing", 0.1)),
                         device=device)
        t.tags = list(d["tags"])
        t._tag_index = {tag: i for i, tag in enumerate(t.tags)}
        t._emission = [dict(e) for e in d["emission"]]
        t._log_trans = _np.asarray(d["log_trans"], _np.float32)
        t._log_init = _np.asarray(d["log_init"], _np.float32)
        t._viterbi = Viterbi(len(t.tags), transitions=t._log_trans,
                             initial=t._log_init, device=t.device)
        t._fitted = True
        return t

    def save(self, path: str) -> None:
        import json

        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f)

    @staticmethod
    def load(path: str, device: DeviceLike = None) -> "HmmPosTagger":
        import json

        with open(path, encoding="utf-8") as f:
            return HmmPosTagger.from_dict(json.load(f), device=device)

    @staticmethod
    def from_treebank(trees, device: DeviceLike = None) -> "HmmPosTagger":
        """Train from parse trees whose leaves carry POS ``tag``s (the
        output of ``Tree.parse`` on tagged PTB data)."""
        sents = []
        for t in trees:
            pairs = [(leaf.word, leaf.tag) for leaf in t.leaves()
                     if leaf.word is not None and leaf.tag is not None]
            if pairs:
                sents.append(pairs)
        return HmmPosTagger(device=device).fit(sents)
