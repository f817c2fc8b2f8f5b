"""Port parity for ``datasets/fetchers.py`` against
``deeplearning4j_tpu.datasets.fetchers``: every synthetic surrogate
(MNIST train and test, binarized and not, flat and NHWC; Iris; CIFAR;
Curves; LFW; the MovingWindow augmentation; RawMnist) gives the same
arrays bitwise, batch for batch through the canonical iterators; idx
files written to a temporary data directory read the same; and no path
reaches the network: ``download_file`` is replaced by one that raises,
and downloads stay off by default."""

import struct

import numpy as np
import pytest

from deeplearning4j_tpu.datasets import fetchers as jax_f
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets import fetchers as f
from deeplearning4j_tpu_torch.monitor import metrics


@pytest.fixture(autouse=True)
def _offline(monkeypatch, tmp_path):
    """An empty data directory, downloads off, and a download_file that
    fails the test if anything reaches it."""
    def refuse(*a, **k):
        raise AssertionError("a fetcher reached download_file")

    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path / "data"))
    monkeypatch.delenv("DL4J_TPU_ALLOW_DOWNLOAD", raising=False)
    monkeypatch.setattr(f, "download_file", refuse)
    monkeypatch.setattr(jax_f, "download_file", refuse)


def _same_batches(ours, theirs):
    a, b = list(ours), list(theirs)
    assert len(a) == len(b) and a
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.features, np.asarray(y.features))
        np.testing.assert_array_equal(x.labels, np.asarray(y.labels))


def test_downloads_are_off_by_default():
    assert not f.downloads_allowed()
    assert f.MNIST_URLS == jax_f.MNIST_URLS


@pytest.mark.parametrize("kw", [
    dict(train=True), dict(train=False), dict(binarize=True),
    dict(flatten=False, num_examples=300), dict(seed=7, num_examples=50)])
def test_mnist_synthetic_bitwise(kw):
    ours, theirs = f.MnistDataFetcher(**kw), jax_f.MnistDataFetcher(**kw)
    assert ours.is_synthetic and theirs.is_synthetic
    np.testing.assert_array_equal(ours.features, theirs.features)
    np.testing.assert_array_equal(ours.labels, theirs.labels)


def test_mnist_iterator_full_width_bitwise():
    _same_batches(f.MnistDataSetIterator(1024),
                  jax_f.MnistDataSetIterator(1024))


@pytest.mark.parametrize("name,args", [
    ("IrisDataSetIterator", (32,)),
    ("CifarDataSetIterator", (64, 256)),
    ("CurvesDataSetIterator", (100, 500)),
    ("RawMnistDataSetIterator", (8, 24)),
])
def test_iterators_bitwise(name, args):
    _same_batches(getattr(f, name)(*args), getattr(jax_f, name)(*args))


def test_lfw_synthetic_bitwise():
    kw = dict(num_examples=20, img_dim=(32, 32), num_categories=4)
    _same_batches(f.LFWDataSetIterator(5, **kw),
                  jax_f.LFWDataSetIterator(5, **kw))


@pytest.mark.parametrize("flat", [True, False])
def test_moving_window_bitwise(flat):
    rng = np.random.default_rng(1)
    shape = (6, 784) if flat else (6, 28, 28, 1)
    x = rng.random(shape).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
    _same_batches(f.MovingWindowDataSetIterator(10, DataSet(x, y), 14, 14),
                  jax_f.MovingWindowDataSetIterator(
                      10, JaxDataSet(x, y), 14, 14))


def _write_idx(base, n=12, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, n, dtype=np.uint8)
    mdir = base / "mnist"
    mdir.mkdir(parents=True)
    with open(mdir / "train-images-idx3-ubyte", "wb") as fh:
        fh.write(struct.pack(">IIII", 2051, n, 28, 28))
        fh.write(imgs.tobytes())
    with open(mdir / "train-labels-idx1-ubyte", "wb") as fh:
        fh.write(struct.pack(">II", 2049, n))
        fh.write(labels.tobytes())
    return imgs, labels


def test_idx_files_read_identically(tmp_path, monkeypatch):
    imgs, labels = _write_idx(tmp_path)
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    before = metrics().counter("native_parse_total").value(
        path="native", fmt="idx")
    ours = f.MnistDataFetcher(train=True, flatten=False)
    theirs = jax_f.MnistDataFetcher(train=True, flatten=False)
    assert not ours.is_synthetic and not theirs.is_synthetic
    np.testing.assert_array_equal(ours.features, theirs.features)
    np.testing.assert_array_equal(ours.labels, theirs.labels)
    np.testing.assert_allclose(ours.features[..., 0],
                               imgs.astype(np.float32) / 255.0)
    assert ours.labels.tolist() == labels.tolist()
    from deeplearning4j_tpu_torch import native

    if native.is_available():
        assert metrics().counter("native_parse_total").value(
            path="native", fmt="idx") == before + 1


def test_download_path_is_opt_in(tmp_path, monkeypatch):
    """With downloads allowed, the fetcher calls download_file, and a
    refused download falls back to the surrogate; with them off it never
    calls it (the autouse fixture's refusal would fail the test)."""
    calls = []

    def fail(url, dest, **kw):
        calls.append(url)
        raise f.RetryError("offline", OSError("offline"), 1)

    monkeypatch.setattr(f, "download_file", fail)
    monkeypatch.setenv("DL4J_TPU_ALLOW_DOWNLOAD", "1")
    fetcher = f.MnistDataFetcher(num_examples=10)
    assert fetcher.is_synthetic and calls
