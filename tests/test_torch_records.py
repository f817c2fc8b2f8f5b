"""Port parity for the record readers and their iterators
(``datasets/records.py``) against ``deeplearning4j_tpu.datasets.records``
on the same files: every record and every batch (features, labels and
masks) must be equal. The JAX package parses all-numeric CSV and SVMLight
with its C++ library where that builds; the port parses them with numpy,
so these tests also hold the two parsers against each other, on numeric,
non-numeric and ragged CSV.
"""

import numpy as np
import pytest

from deeplearning4j_tpu.datasets import records as jax_records
from deeplearning4j_tpu_torch.datasets import records


def _write(path, text):
    path.write_text(text)
    return str(path)


def _records(reader):
    out = []
    reader.reset()
    while reader.has_next():
        out.append(reader.next())
    return out


def _same_record(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_record(x, y)
        return
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
        return
    assert a == b


def _same_batches(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        for field in ("features", "labels", "features_mask", "labels_mask"):
            x, y = getattr(a, field), getattr(b, field)
            if x is None or y is None:
                assert x is None and y is None, field
                continue
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
            assert np.asarray(x).dtype == np.asarray(y).dtype


def _batches(it):
    it.reset()
    out = []
    while it.has_next():
        out.append(it.next())
    return out


@pytest.fixture
def numeric_csv(tmp_path):
    rng = np.random.default_rng(0)
    rows = ["# a header line"]
    for _ in range(23):
        x = rng.normal(0, 3, 5)
        rows.append(",".join(f"{v:.7g}" for v in x)
                    + f",{int(rng.integers(0, 4))}")
    rows.insert(7, "")  # a blank line is skipped
    return _write(tmp_path / "n.csv", "\n".join(rows) + "\n")


@pytest.mark.parametrize("skip", [1, 3])
def test_numeric_csv_records_match(numeric_csv, skip):
    ours = _records(records.CSVRecordReader(numeric_csv, skip_lines=skip))
    theirs = _records(jax_records.CSVRecordReader(numeric_csv,
                                                  skip_lines=skip))
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        _same_record(a, b)


@pytest.mark.parametrize("text", [
    "1,2,cat\n3,4,dog\n",            # string cells
    "1,2,3\n4,5\n6,7,8\n",           # ragged rows
    "1;2;3\n4;5;6\n",                # another delimiter, read with ","
    "1e3,-2.5e-3,inf\nnan,0x10,7\n",  # spellings parsers disagree on
    "0X1P3,nan(7),-INF\n+.5,5.,1e-2\n",
    "1_0,2\n3,4\n",                  # numpy reads "1_0"; strtof does not
    '"1","2"\n"3","4"\n',            # quoted numbers
    "1,2\r\n\r\n3,4\r\n",            # CRLF and a blank line
    "",                               # empty
], ids=["strings", "ragged", "delimiter", "spellings", "hex_nan_chars",
        "underscore", "quoted", "crlf", "empty"])
def test_non_numeric_and_ragged_csv_records_match(tmp_path, text):
    path = _write(tmp_path / "x.csv", text)
    ours = _records(records.CSVRecordReader(path))
    theirs = _records(jax_records.CSVRecordReader(path))
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        _same_record(a, b)


@pytest.mark.parametrize("batch,label_index", [(5, -1), (8, 0), (23, 5)])
def test_csv_iterator_batches_match(numeric_csv, batch, label_index):
    def it(mod):
        return mod.RecordReaderDataSetIterator(
            mod.CSVRecordReader(numeric_csv, skip_lines=1), batch,
            label_index=label_index, num_classes=None if label_index == 0
            else 4, regression=label_index == 0)
    _same_batches(_batches(it(records)), _batches(it(jax_records)))


def test_iterator_without_classes_raises(numeric_csv):
    it = records.RecordReaderDataSetIterator(
        records.CSVRecordReader(numeric_csv, skip_lines=1), 4)
    with pytest.raises(ValueError, match="num_classes"):
        it.next()


@pytest.mark.parametrize("zero_based", [False, True],
                         ids=["one_based", "zero_based"])
def test_svmlight_records_and_batches_match(tmp_path, zero_based):
    rng = np.random.default_rng(1)
    lines = ["# comment"]
    base = 0 if zero_based else 1
    for _ in range(17):
        idx = sorted(rng.choice(6, size=int(rng.integers(1, 5)),
                                replace=False))
        feats = " ".join(f"{i + base}:{rng.normal():.6g}" for i in idx)
        lines.append(f"{int(rng.integers(0, 3))} {feats} # tail")
    path = _write(tmp_path / "d.svm", "\n".join(lines) + "\n")
    ours = _records(records.SVMLightRecordReader(path, 6, zero_based))
    theirs = _records(jax_records.SVMLightRecordReader(path, 6, zero_based))
    assert len(ours) == len(theirs) == 17
    for a, b in zip(ours, theirs):
        _same_record(a, b)

    def it(mod):
        return mod.RecordReaderDataSetIterator(
            mod.SVMLightRecordReader(path, 6, zero_based), 5, num_classes=3)
    _same_batches(_batches(it(records)), _batches(it(jax_records)))
    bad = _write(tmp_path / "bad.svm", f"1 {7 + base}:1.0\n")
    with pytest.raises(ValueError, match="out of range"):
        records.SVMLightRecordReader(bad, 6, zero_based).next()


@pytest.fixture
def sequence_files(tmp_path):
    rng = np.random.default_rng(2)
    feats, labels = [], []
    for i, t in enumerate((4, 7, 2, 5, 3)):
        x = rng.normal(size=(t, 3))
        y = rng.integers(0, 4, t)
        feats.append(_write(tmp_path / f"f{i}.csv", "\n".join(
            ",".join(f"{v:.6g}" for v in row) + f",{yy}"
            for row, yy in zip(x, y)) + "\n"))
        labels.append(_write(tmp_path / f"l{i}.csv",
                             "\n".join(str(v) for v in y) + "\n"))
    return feats, labels


@pytest.mark.parametrize("mode", ["two_readers", "single_reader",
                                  "regression"])
def test_sequence_iterator_batches_match(sequence_files, mode):
    feats, labels = sequence_files

    def it(mod):
        fr = mod.CSVSequenceRecordReader(feats)
        if mode == "two_readers":
            return mod.SequenceRecordReaderDataSetIterator(
                fr, mod.CSVSequenceRecordReader(labels), batch_size=2,
                num_classes=4)
        return mod.SequenceRecordReaderDataSetIterator(
            fr, batch_size=3, num_classes=4, regression=mode == "regression",
            label_index=-1 if mode != "regression" else 1)
    _same_batches(_batches(it(records)), _batches(it(jax_records)))


def test_collection_reader_and_multi_dataset_iterator():
    rng = np.random.default_rng(3)
    a = [list(rng.normal(size=4)) + [float(rng.integers(0, 3))]
         for _ in range(11)]
    b = [list(rng.normal(size=2)) for _ in range(11)]

    def it(mod):
        return (mod.RecordReaderMultiDataSetIterator(4)
                .add_reader("a", mod.CollectionRecordReader(a))
                .add_reader("b", mod.CollectionRecordReader(b))
                .add_input("a", 0, 3).add_input("b")
                .add_output_one_hot("a", 4, 3).add_output("b", 1, 1))
    ours, theirs = list(it(records)), list(it(jax_records))
    assert len(ours) == len(theirs) == 3
    for x, y in zip(ours, theirs):
        for u, v in zip(x.features + x.labels, y.features + y.labels):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
    r = records.CollectionRecordReader(a)
    assert [list(v) for v in r] == a and list(r) == a  # iter resets
