"""Record readers — the Canova-equivalent host-side ETL.

The reference delegates record parsing to the external Canova library
(RecordReader/InputFormat — deeplearning4j-core/pom.xml:106; the CLI's
default input format is SVMLight, cli/subcommands/Train.java:75) and bridges
it with RecordReaderDataSetIterator (datasets/canova/
RecordReaderDataSetIterator.java, SequenceRecordReaderDataSetIterator.java
with aligned/unaligned modes, RecordReaderMultiDataSetIterator.java with
named-input mapping). This module provides the same capability surface in
one place: readers yield records (lists of values); iterators assemble
padded/masked DataSet/MultiDataSet batches of numpy arrays, which the
networks move to their device.

Port of ``deeplearning4j_tpu/datasets/records.py`` (which imports no
jax). All-numeric CSV and SVMLight files go through the C++ host parser
(``native/dl4j_host.cpp``, bound by :mod:`deeplearning4j_tpu_torch.native`)
when it builds; otherwise numpy and ``csv`` parse them by the native
parser's number grammar, which gives the same records. Each parse counts
its path in ``native_parse_total``.
"""

from __future__ import annotations

import csv
import io
import re
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator


class RecordReader:
    """Iterable of records; a record is a list of float values (or an
    ndarray for image/sequence readers)."""

    def __iter__(self) -> Iterator:
        self.reset()
        return self

    def __next__(self):
        if not self.has_next():
            raise StopIteration
        return self.next()

    def has_next(self) -> bool:
        raise NotImplementedError

    def next(self):
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


# A number as C's strtof reads one, the whole cell: decimal, hex, inf,
# infinity, nan and nan(chars), any case. The JAX package's native parser
# takes a file as numeric by this grammar, so the port does too.
_STRTOF = re.compile(r"""[+-]?(?:
    (?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?
  | 0[xX](?:[0-9a-fA-F]+\.?[0-9a-fA-F]*|\.[0-9a-fA-F]+)(?:[pP][+-]?\d+)?
  | [iI][nN][fF](?:[iI][nN][iI][tT][yY])?
  | [nN][aA][nN](?:\([0-9A-Za-z_]*\))?)""", re.X)
# cells spelt only with these characters read alike under numpy's float
# parsing and under strtof, so the whole file can go through numpy at once
_PLAIN_CELL_CHARS = re.compile(r"[0-9eE.+\-nNaAiIfFtTyY \t\r\n]*")


def _strtof(cell: str) -> float:
    body = cell.lstrip("+-")
    if body[:2] in ("0x", "0X"):
        return float.fromhex(cell)
    if body[:3].lower() == "nan":
        return float("nan")
    return float(cell)


def _numeric_matrix(text: str, delimiter: str,
                    skip_lines: int) -> Optional[np.ndarray]:
    """``text`` as a float32 ``[rows, cols]`` matrix when every cell (blank
    lines and the first ``skip_lines`` lines aside) is a number and every
    row has the same width; None otherwise, as the native parser. Values
    round through float64 to float32 (strtof rounds once), which differs
    only for a decimal within 2^-29 of a float32 rounding tie."""
    lines = [l for l in re.split(r"\r\n|\r|\n", text)[skip_lines:] if l]
    if not lines or len(delimiter) != 1:
        return None
    cells = [l.split(delimiter) for l in lines]
    if any(len(r) != len(cells[0]) for r in cells):
        return None
    if _PLAIN_CELL_CHARS.fullmatch(text.replace(delimiter, " ")):
        try:
            return np.asarray(cells, np.float32)
        except ValueError:
            return None
    values = []
    for row in cells:
        for cell in row:
            cell = cell.strip(" \t\r")
            if not _STRTOF.fullmatch(cell):
                return None
            values.append(_strtof(cell))
    return np.asarray(values, np.float32).reshape(len(cells), -1)


class CSVRecordReader(RecordReader):
    """CSV line reader (Canova CSVRecordReader equivalent): skips
    ``skip_lines`` header rows, splits on ``delimiter``."""

    def __init__(self, path: str, skip_lines: int = 0, delimiter: str = ","):
        self.path = path
        self.skip_lines = skip_lines
        self.delimiter = delimiter
        self._rows: Optional[List[List[str]]] = None
        self._matrix: Optional[np.ndarray] = None  # all-numeric files
        self._pos = 0

    def _load(self):
        if self._rows is not None or self._matrix is not None:
            return
        # All-numeric rectangular files parse to a float32 matrix (the
        # native parser when it builds, numpy otherwise: the same result);
        # files with string cells or ragged rows stay lists of strings.
        from deeplearning4j_tpu_torch import native

        self._matrix = native.csv_to_array(self.path, self.delimiter,
                                           self.skip_lines)
        if self._matrix is not None:
            return
        with open(self.path, newline="") as f:
            text = f.read()
        if not native.is_available():
            # the native parser, when it runs, has already said no
            self._matrix = _numeric_matrix(text, self.delimiter,
                                           self.skip_lines)
            native.count_parse("numpy", "csv")
        if self._matrix is None:
            rows = list(csv.reader(io.StringIO(text, newline=""),
                                   delimiter=self.delimiter))
            self._rows = [r for r in rows[self.skip_lines:] if r]

    def _count(self) -> int:
        return (len(self._matrix) if self._matrix is not None
                else len(self._rows))

    def has_next(self):
        self._load()
        return self._pos < self._count()

    def next(self):
        """Next record: a float32 row for all-numeric files, a list of
        strings otherwise."""
        self._load()
        row = (self._matrix[self._pos] if self._matrix is not None
               else self._rows[self._pos])
        self._pos += 1
        return row

    def reset(self):
        self._pos = 0


class SVMLightRecordReader(RecordReader):
    """SVMLight/libsvm format: ``label idx:val idx:val ...`` (1-based or
    0-based indices; the CLI default input format in the reference)."""

    def __init__(self, path: str, num_features: int, zero_based: bool = False):
        self.path = path
        self.num_features = num_features
        self.zero_based = zero_based
        self._lines: Optional[List[str]] = None
        self._native: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._pos = 0

    def _load(self):
        if self._lines is not None or self._native is not None:
            return
        from deeplearning4j_tpu_torch import native

        self._native = native.svmlight_to_arrays(
            self.path, self.num_features, self.zero_based)
        if self._native is not None:
            return
        native.count_parse("numpy", "svmlight")
        with open(self.path) as f:
            self._lines = [l.strip() for l in f if l.strip()
                           and not l.startswith("#")]

    def _count(self) -> int:
        return (len(self._native[1]) if self._native is not None
                else len(self._lines))

    def has_next(self):
        self._load()
        return self._pos < self._count()

    def next(self) -> Tuple[float, np.ndarray]:
        self._load()
        if self._native is not None:
            feats, labels = self._native
            i = self._pos
            self._pos += 1
            return float(labels[i]), feats[i]
        parts = self._lines[self._pos].split()
        self._pos += 1
        label = float(parts[0])
        x = np.zeros(self.num_features, np.float32)
        for tok in parts[1:]:
            if tok.startswith("#"):
                break
            idx, val = tok.split(":")
            i = int(idx) - (0 if self.zero_based else 1)
            if not 0 <= i < self.num_features:
                raise ValueError(
                    f"{self.path}: feature index {idx} out of range for "
                    f"{self.num_features} features "
                    f"({'zero' if self.zero_based else 'one'}-based)")
            x[i] = float(val)
        return label, x

    def reset(self):
        self._pos = 0


class CSVSequenceRecordReader(RecordReader):
    """One CSV file per sequence (the reference's csvsequence_*.txt test
    fixtures): each file's rows are timesteps."""

    def __init__(self, paths: Sequence[str], skip_lines: int = 0,
                 delimiter: str = ","):
        self.paths = list(paths)
        self.skip_lines = skip_lines
        self.delimiter = delimiter
        self._pos = 0

    def has_next(self):
        return self._pos < len(self.paths)

    def next(self) -> np.ndarray:
        reader = CSVRecordReader(self.paths[self._pos], self.skip_lines,
                                 self.delimiter)
        self._pos += 1
        rows = [[float(v) for v in row] for row in reader]
        return np.asarray(rows, np.float32)

    def reset(self):
        self._pos = 0


class CollectionRecordReader(RecordReader):
    """In-memory records (testing / programmatic pipelines)."""

    def __init__(self, records: Sequence):
        self.records = list(records)
        self._pos = 0

    def has_next(self):
        return self._pos < len(self.records)

    def next(self):
        r = self.records[self._pos]
        self._pos += 1
        return r

    def reset(self):
        self._pos = 0


# ---------------------------------------------------------------------------
# record → DataSet iterators
# ---------------------------------------------------------------------------


class RecordReaderDataSetIterator(DataSetIterator):
    """records → [features | one-hot label] batches
    (datasets/canova/RecordReaderDataSetIterator.java).

    ``label_index``: column holding the class label (-1 = last);
    ``num_classes``: one-hot width; ``regression``: keep label as float.
    """

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: int = -1, num_classes: Optional[int] = None,
                 regression: bool = False):
        self.reader = reader
        self.batch_size = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression
        self._exhausted = False

    def has_next(self):
        return self.reader.has_next()

    def next(self, num: Optional[int] = None) -> DataSet:
        n = num or self.batch_size
        feats, labels = [], []
        while self.reader.has_next() and len(feats) < n:
            rec = self.reader.next()
            if isinstance(rec, tuple):  # (label, features) e.g. SVMLight
                label, x = rec
                feats.append(np.asarray(x, np.float32))
                labels.append(label)
            else:
                vals = [float(v) for v in rec]
                li = self.label_index if self.label_index >= 0 else len(vals) - 1
                labels.append(vals[li])
                feats.append(np.asarray(vals[:li] + vals[li + 1:], np.float32))
        x = np.stack(feats)
        if self.regression:
            y = np.asarray(labels, np.float32).reshape(-1, 1)
        else:
            if self.num_classes is None:
                raise ValueError("num_classes required for classification")
            y = np.eye(self.num_classes, dtype=np.float32)[
                np.asarray(labels, np.int64)]
        return DataSet(x, y)

    def reset(self):
        self.reader.reset()

    def batch(self):
        return self.batch_size

    def total_examples(self):
        raise NotImplementedError("unknown for streaming readers")

    def input_columns(self):
        raise NotImplementedError

    def total_outcomes(self):
        return self.num_classes or 1


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Two sequence readers (features + labels) → padded/masked [b, t, f]
    batches (SequenceRecordReaderDataSetIterator.java's ALIGN_END mode for
    unequal lengths).

    If ``single_reader`` mode: the label column is carved out of each
    timestep row of one reader.
    """

    def __init__(self, features_reader: RecordReader,
                 labels_reader: Optional[RecordReader] = None,
                 batch_size: int = 10, num_classes: Optional[int] = None,
                 regression: bool = False, label_index: int = -1):
        self.features_reader = features_reader
        self.labels_reader = labels_reader
        self.batch_size = batch_size
        self.num_classes = num_classes
        self.regression = regression
        self.label_index = label_index

    def has_next(self):
        return self.features_reader.has_next()

    def next(self, num: Optional[int] = None) -> DataSet:
        n = num or self.batch_size
        fseqs, lseqs = [], []
        while self.features_reader.has_next() and len(fseqs) < n:
            f = np.asarray(self.features_reader.next(), np.float32)
            if self.labels_reader is not None:
                l = np.asarray(self.labels_reader.next(), np.float32)
            else:
                li = self.label_index if self.label_index >= 0 else f.shape[1] - 1
                l = f[:, li:li + 1]
                f = np.delete(f, li, axis=1)
            fseqs.append(f)
            lseqs.append(l)
        t_max = max(s.shape[0] for s in fseqs)
        b = len(fseqs)
        x = np.zeros((b, t_max, fseqs[0].shape[1]), np.float32)
        mask = np.zeros((b, t_max), np.float32)
        if self.regression:
            y = np.zeros((b, t_max, lseqs[0].shape[1]), np.float32)
        else:
            y = np.zeros((b, t_max, self.num_classes), np.float32)
        for i, (f, l) in enumerate(zip(fseqs, lseqs)):
            t = f.shape[0]
            x[i, :t] = f
            mask[i, :t] = 1.0
            if self.regression:
                y[i, :t] = l
            else:
                y[i, :t] = np.eye(self.num_classes, dtype=np.float32)[
                    l.astype(np.int64).ravel()]
        return DataSet(x, y, features_mask=mask, labels_mask=mask.copy())

    def reset(self):
        self.features_reader.reset()
        if self.labels_reader is not None:
            self.labels_reader.reset()

    def batch(self):
        return self.batch_size

    def total_examples(self):
        raise NotImplementedError

    def input_columns(self):
        raise NotImplementedError

    def total_outcomes(self):
        return self.num_classes or 1


class RecordReaderMultiDataSetIterator:
    """Named readers → MultiDataSet (RecordReaderMultiDataSetIterator.java:
    named-input mapping for ComputationGraph fit)."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self._readers: dict = {}
        self._inputs: List[Tuple[str, int, int]] = []  # (name, from, to) col range
        self._outputs: List[Tuple[str, int, int, Optional[int]]] = []

    def add_reader(self, name: str, reader: RecordReader):
        self._readers[name] = reader
        return self

    def add_input(self, reader_name: str, col_from: int = 0, col_to: int = -1):
        self._inputs.append((reader_name, col_from, col_to))
        return self

    def add_output_one_hot(self, reader_name: str, column: int, num_classes: int):
        self._outputs.append((reader_name, column, column, num_classes))
        return self

    def add_output(self, reader_name: str, col_from: int = 0, col_to: int = -1):
        self._outputs.append((reader_name, col_from, col_to, None))
        return self

    def __iter__(self):
        for r in self._readers.values():
            r.reset()
        return self

    def __next__(self) -> MultiDataSet:
        if not all(r.has_next() for r in self._readers.values()):
            raise StopIteration
        rows = {name: [] for name in self._readers}
        count = 0
        while count < self.batch_size and all(
                r.has_next() for r in self._readers.values()):
            for name, r in self._readers.items():
                rows[name].append([float(v) for v in r.next()])
            count += 1
        arrays = {n: np.asarray(v, np.float32) for n, v in rows.items()}
        feats = []
        for name, c_from, c_to in self._inputs:
            a = arrays[name]
            end = a.shape[1] if c_to == -1 else c_to + 1
            feats.append(a[:, c_from:end])
        labels = []
        for name, c_from, c_to, n_classes in self._outputs:
            a = arrays[name]
            if n_classes is not None:
                labels.append(np.eye(n_classes, dtype=np.float32)[
                    a[:, c_from].astype(np.int64)])
            else:
                end = a.shape[1] if c_to == -1 else c_to + 1
                labels.append(a[:, c_from:end])
        return MultiDataSet(feats, labels)

    has_next = lambda self: all(r.has_next() for r in self._readers.values())
    reset = lambda self: [r.reset() for r in self._readers.values()] and None
