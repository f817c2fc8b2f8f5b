"""The port's binding of the C++ host runtime (``native/dl4j_host.cpp``)
against the JAX package's binding and against numpy: CSV, SVMLight and
idx parses equal bitwise, ``FileStreamer`` returns the file's bytes, and
the port builds its own library (under ``kernels/_build``, never the JAX
package's ``.so``). When the library cannot be built, every entry point
returns None and the record readers take their numpy path, counted in
``native_parse_total{path="numpy"}``."""

import os
import struct

import numpy as np
import pytest

from deeplearning4j_tpu import native as jax_native
from deeplearning4j_tpu_torch import native
from deeplearning4j_tpu_torch.datasets import records
from deeplearning4j_tpu_torch.monitor import metrics

needs_lib = pytest.mark.skipif(not native.is_available(),
                               reason="g++ cannot build the host library")


def _count(path, fmt):
    return metrics().counter("native_parse_total").value(path=path, fmt=fmt)


@needs_lib
def test_builds_its_own_library():
    so = native.library_path()
    assert os.path.exists(so)
    assert os.path.dirname(so).endswith(os.path.join("kernels", "_build"))
    assert not so.startswith(os.path.dirname(jax_native.__file__))


@needs_lib
@pytest.mark.parametrize("delim,skip", [(",", 0), (";", 1), ("\t", 2)])
def test_csv_matches_jax_and_numpy(tmp_path, delim, skip):
    rng = np.random.default_rng(0)
    m = rng.normal(size=(37, 5)).astype(np.float32)
    lines = ["head"] * skip + [delim.join(f"{v:.7g}" for v in r) for r in m]
    p = tmp_path / "m.csv"
    p.write_text("\n".join(lines) + "\n")
    before = _count("native", "csv")
    ours = native.csv_to_array(str(p), delim, skip)
    np.testing.assert_array_equal(ours, jax_native.csv_to_array(
        str(p), delim, skip))
    np.testing.assert_array_equal(
        ours, np.loadtxt(str(p), delimiter=delim, skiprows=skip,
                         dtype=np.float32))
    assert _count("native", "csv") == before + 1


@needs_lib
def test_csv_rejects_what_numpy_would(tmp_path):
    p = tmp_path / "s.csv"
    p.write_text("1,2,x\n3,4,5\n")
    assert native.csv_to_array(str(p)) is None
    assert jax_native.csv_to_array(str(p)) is None
    p.write_text("1,2\n3,4,5\n")
    assert native.csv_to_array(str(p)) is None


@needs_lib
@pytest.mark.parametrize("zero_based", [False, True])
def test_svmlight_matches_jax(tmp_path, zero_based):
    rng = np.random.default_rng(1)
    base = 0 if zero_based else 1
    rows = []
    for _ in range(23):
        idx = sorted(rng.choice(8, 3, replace=False))
        rows.append(f"{rng.integers(0, 3)} " + " ".join(
            f"{i + base}:{rng.normal():.5g}" for i in idx))
    p = tmp_path / "d.svm"
    p.write_text("\n".join(rows) + "\n")
    xf, yl = native.svmlight_to_arrays(str(p), 8, zero_based)
    jf, jl = jax_native.svmlight_to_arrays(str(p), 8, zero_based)
    np.testing.assert_array_equal(xf, jf)
    np.testing.assert_array_equal(yl, jl)
    assert xf.shape == (23, 8) and yl.shape == (23,)


@needs_lib
def test_idx_matches_jax_and_numpy(tmp_path):
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (5, 28, 28), dtype=np.uint8)
    p = tmp_path / "imgs-idx3-ubyte"
    with open(p, "wb") as fh:
        fh.write(struct.pack(">IIII", 2051, 5, 28, 28))
        fh.write(imgs.tobytes())
    ours = native.idx_to_array(str(p))
    np.testing.assert_array_equal(ours, jax_native.idx_to_array(str(p)))
    np.testing.assert_array_equal(ours, imgs.astype(np.float32))


@needs_lib
def test_file_streamer_returns_the_bytes(tmp_path):
    data = os.urandom(10_000)
    p = tmp_path / "blob.bin"
    p.write_bytes(data)
    with native.FileStreamer(str(p), 1024, capacity=3) as s:
        chunks = list(s)
    assert b"".join(chunks) == data
    assert [len(c) for c in chunks[:-1]] == [1024] * 9
    assert s.next() is None  # closed


def test_without_library_readers_take_numpy(tmp_path, monkeypatch):
    """The numpy path gives the native path's records and is counted."""
    rng = np.random.default_rng(3)
    m = rng.normal(size=(9, 4)).astype(np.float32)
    p = tmp_path / "m.csv"
    p.write_text("\n".join(",".join(f"{v:.7g}" for v in r) for r in m))
    native_rows = [np.asarray(r) for r in records.CSVRecordReader(str(p))]
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", True)
    assert not native.is_available()
    assert native.csv_to_array(str(p)) is None
    before = _count("numpy", "csv")
    numpy_rows = [np.asarray(r) for r in records.CSVRecordReader(str(p))]
    assert _count("numpy", "csv") == before + 1
    assert len(numpy_rows) == 9
    for a, b in zip(numpy_rows, native_rows):
        np.testing.assert_array_equal(a, b)
