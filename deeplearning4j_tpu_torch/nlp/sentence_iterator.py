"""Sentence/document iterators (text/sentenceiterator/ + documentiterator/):
Basic/LineSentence/FileSentence/Collection + label-aware variants and
LabelsSource.

A copy of ``deeplearning4j_tpu/nlp/sentence_iterator.py``: the port keeps
its own, so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, List, Optional, Sequence


class SentenceIterator:
    def __iter__(self) -> Iterator[str]:
        self.reset()
        while self.has_next():
            yield self.next_sentence()

    def has_next(self) -> bool:
        raise NotImplementedError

    def next_sentence(self) -> str:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


class CollectionSentenceIterator(SentenceIterator):
    def __init__(self, sentences: Sequence[str]):
        self.sentences = list(sentences)
        self._pos = 0

    def has_next(self):
        return self._pos < len(self.sentences)

    def next_sentence(self):
        s = self.sentences[self._pos]
        self._pos += 1
        return s

    def reset(self):
        self._pos = 0


class BasicLineIterator(SentenceIterator):
    """One sentence per line from a file path (BasicLineIterator)."""

    def __init__(self, path: str):
        self.path = path
        self._lines: Optional[List[str]] = None
        self._pos = 0

    def _load(self):
        if self._lines is None:
            with open(self.path, encoding="utf-8", errors="replace") as f:
                self._lines = [l.strip() for l in f if l.strip()]

    def has_next(self):
        self._load()
        return self._pos < len(self._lines)

    def next_sentence(self):
        self._load()
        s = self._lines[self._pos]
        self._pos += 1
        return s

    def reset(self):
        self._pos = 0


LineSentenceIterator = BasicLineIterator


class FileSentenceIterator(SentenceIterator):
    """All files under a directory, one sentence per line
    (FileSentenceIterator)."""

    def __init__(self, directory: str):
        self.directory = directory
        self._files = sorted(
            os.path.join(directory, f) for f in os.listdir(directory)
            if os.path.isfile(os.path.join(directory, f)))
        self._file_idx = 0
        self._current: Optional[BasicLineIterator] = None

    def _advance(self):
        while ((self._current is None or not self._current.has_next())
               and self._file_idx < len(self._files)):
            self._current = BasicLineIterator(self._files[self._file_idx])
            self._file_idx += 1

    def has_next(self):
        self._advance()
        return self._current is not None and self._current.has_next()

    def next_sentence(self):
        self._advance()
        return self._current.next_sentence()

    def reset(self):
        self._file_idx = 0
        self._current = None


class LabelsSource:
    """Generated or explicit document labels (text/documentiterator/
    LabelsSource)."""

    def __init__(self, template: str = "DOC_",
                 labels: Optional[List[str]] = None):
        self.template = template
        self._labels = list(labels) if labels else []
        self._counter = 0
        self._explicit = labels is not None

    def next_label(self) -> str:
        if self._explicit:
            label = self._labels[self._counter]
        else:
            label = f"{self.template}{self._counter}"
            self._labels.append(label)
        self._counter += 1
        return label

    def get_labels(self) -> List[str]:
        return list(self._labels)

    def reset(self):
        self._counter = 0


class LabelAwareSentenceIterator(SentenceIterator):
    """Sentences + per-sentence labels (labelaware variants)."""

    def __init__(self, sentences: Sequence[str],
                 labels: Optional[Sequence[str]] = None,
                 label_template: str = "DOC_"):
        self._it = CollectionSentenceIterator(sentences)
        self.labels_source = LabelsSource(
            label_template, list(labels) if labels is not None else None)
        self._current_label: Optional[str] = None

    def has_next(self):
        return self._it.has_next()

    def next_sentence(self):
        self._current_label = self.labels_source.next_label()
        return self._it.next_sentence()

    def current_label(self) -> str:
        return self._current_label

    def reset(self):
        self._it.reset()
        self.labels_source.reset()
