"""SequenceVectors — the generic embedding engine over arbitrary sequences.

Re-design of ``models/sequencevectors/SequenceVectors.java:48``: the
reference's generic trainer over ``SequenceElement`` streams, of which
Word2Vec (sentences of words), ParagraphVectors (documents + labels) and
DeepWalk (random-walk vertex sequences) are the concrete instances. Here the
device-batched skip-gram/CBOW/HS machinery lives in ``nlp/word2vec.py``;
``SequenceVectors`` generalizes its input from tokenized text to ANY
iterable of element-id sequences — vertices, products, labels — with the
same Builder surface (`iterate`, `layerSize`, `minWordFrequency`, …).

Elements are opaque strings; no tokenizer runs. Training is Word2Vec's
one step per batch on the card (``device=None``) or on ``device``.

Port of ``deeplearning4j_tpu/nlp/sequencevectors.py``.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec


class SequenceVectors(Word2Vec):
    """Generic trainer: ``SequenceVectors.Builder().iterate(seqs).build()``
    then ``fit()``; lookups (`get_word_vector`, `similarity`,
    `words_nearest`) inherited."""

    class Builder(Word2Vec.Builder):
        """Word2Vec.Builder surface, re-targeted at element sequences:
        ``iterate`` takes sequences instead of a SentenceIterator, and
        ``min_element_frequency`` defaults to 1 (walk/graph corpora rarely
        repeat elements five times)."""

        def __init__(self):
            super().__init__()
            self._kw["min_word_frequency"] = 1
            self._sequences: Optional[Iterable[Sequence[str]]] = None

        def iterate(self, sequences: Iterable[Sequence[str]]):  # type: ignore[override]
            self._sequences = sequences
            return self

        def min_element_frequency(self, v: int):
            return self.min_word_frequency(v)

        def build(self) -> "SequenceVectors":
            if self._sequences is None:
                raise ValueError("no sequences: call iterate(...) first")
            return SequenceVectors(self._sequences, **self._kw)

    def __init__(self, sequences: Iterable[Sequence[str]], **kw):
        super().__init__(sentence_iterator=None, **kw)
        # fit() iterates the corpus twice (vocab, then pair emission), so a
        # one-shot generator must be materialized or training would silently
        # see an empty second pass
        if not isinstance(sequences, (list, tuple)):
            sequences = [list(s) for s in sequences]
        self._sequences = sequences

    def _sentences_tokens(self) -> Iterable[List[str]]:
        # elements are already ids: bypass the sentence/tokenizer pipeline
        for seq in self._sequences:
            yield [str(e) for e in seq]

    # reference-surface aliases
    def get_element_vector(self, element: str):
        return self.get_word_vector(element)

    def elements_nearest(self, element: str, top_n: int = 10):
        return self.words_nearest(element, top_n=top_n)
