"""Dataset fetchers + canonical iterators (MNIST / Iris / CIFAR / Curves).

Port of ``deeplearning4j_tpu/datasets/fetchers.py`` (which imports no
jax): a copy on the port's iterators, retry policy, file helpers and
native parser. The synthetic surrogates draw from numpy's generators, so
their arrays equal the reference's bitwise.

Mirror of ``datasets/fetchers/`` + ``datasets/iterator/impl/`` in the
reference (MnistDataFetcher + MnistDataSetIterator with the idx-file binary
parsers in datasets/mnist/, IrisDataFetcher, CifarDataSetIterator,
CurvesDataFetcher).

Zero-egress policy: the reference's fetchers download on demand
(base/MnistFetcher.java). Here each fetcher first looks for local files
(``DL4J_TPU_DATA_DIR``, default ``~/.deeplearning4j_tpu``); when absent it
falls back to a DETERMINISTIC synthetic surrogate with the same shapes and
label structure, so pipelines/tests/benchmarks run identically with or
without the real data. ``is_synthetic`` reports which one you got.
"""

from __future__ import annotations

import gzip
import logging
import os
import shutil
import struct
from typing import Callable, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import BaseDataSetIterator
from deeplearning4j_tpu_torch.resilience import (
    FaultInjected,
    RetryError,
    RetryPolicy,
    faults,
)
from deeplearning4j_tpu_torch.utils.fileio import atomic_write_bytes

logger = logging.getLogger(__name__)


def data_dir() -> str:
    return os.environ.get(
        "DL4J_TPU_DATA_DIR",
        os.path.join(os.path.expanduser("~"), ".deeplearning4j_tpu"))


# ---------------------------------------------------------------------------
# on-demand download (base/MnistFetcher.java role), retry-guarded
# ---------------------------------------------------------------------------

#: canonical MNIST idx files (the reference's MnistFetcher URLs, modulo host)
MNIST_URLS = {
    name: f"https://ossci-datasets.s3.amazonaws.com/mnist/{name}.gz"
    for name in ("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
                 "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")
}


def downloads_allowed() -> bool:
    """Zero-egress by default: fetchers only reach the network when
    ``DL4J_TPU_ALLOW_DOWNLOAD=1`` (CI images and tests stay offline)."""
    return os.environ.get("DL4J_TPU_ALLOW_DOWNLOAD", "") == "1"


def default_download_retry_policy() -> RetryPolicy:
    import http.client

    # HTTPException covers connection-dropped-mid-body (IncompleteRead),
    # which does NOT subclass OSError but is just as transient
    return RetryPolicy(max_attempts=4, base_delay_s=0.5, max_delay_s=8.0,
                       retryable=(OSError, http.client.HTTPException,
                                  FaultInjected))


def download_file(url: str, dest: str,
                  policy: Optional[RetryPolicy] = None,
                  opener: Optional[Callable] = None) -> str:
    """Download ``url`` to ``dest`` atomically (tempfile + rename, so a
    killed download never leaves a truncated file under the real name),
    retrying transient network errors under the shared
    :class:`RetryPolicy`. Fires the ``fetcher.download`` fault point once
    per attempt. ``opener``: urlopen-compatible callable (tests substitute
    an in-memory one)."""
    policy = policy or default_download_retry_policy()

    def attempt():
        faults.fault_point("fetcher.download")
        import urllib.request

        opn = opener or urllib.request.urlopen
        os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)

        def write(out):
            with opn(url) as resp:
                shutil.copyfileobj(resp, out)

        atomic_write_bytes(dest, write)

    policy.call(attempt)
    return dest


def _valid_idx_gz(path: str) -> bool:
    """Cheap integrity check before a download enters the permanent
    cache: a gzip'd idx file must decompress and carry an idx magic
    (2051 images / 2049 labels). Catches mirror error pages served with
    HTTP 200, which would otherwise poison every later (even offline)
    run."""
    try:
        with gzip.open(path, "rb") as f:
            magic = struct.unpack(">I", f.read(4))[0]
        return magic in (2051, 2049)
    except (OSError, struct.error, EOFError):
        return False


def _maybe_download_mnist(base: str, name: str) -> Optional[str]:
    """Fetch one idx file when downloads are enabled; None (→ synthetic
    fallback) when disabled, when retries were exhausted, or when the
    downloaded content fails validation — a flaky/broken mirror degrades
    to the surrogate instead of failing the pipeline."""
    if not downloads_allowed() or name not in MNIST_URLS:
        return None
    dest = os.path.join(base, name + ".gz")
    try:
        download_file(MNIST_URLS[name], dest)
    except RetryError as e:
        logger.warning("download of %s failed after retries (%s); using "
                       "synthetic surrogate", name, e)
        return None
    if not _valid_idx_gz(dest):
        logger.warning("download of %s is not a valid idx.gz (mirror "
                       "error page?); discarding and using synthetic "
                       "surrogate", name)
        try:
            os.unlink(dest)  # never poison the cache
        except FileNotFoundError:
            pass
        return None
    return dest


# ---------------------------------------------------------------------------
# MNIST idx parsing (datasets/mnist/MnistImageFile|MnistDbFile equivalents)
# ---------------------------------------------------------------------------


def _read_idx_images(path: str) -> np.ndarray:
    from deeplearning4j_tpu_torch import native

    if not path.endswith(".gz"):
        # native C++ idx parser fast path
        arr = native.idx_to_array(path)
        if arr is not None and arr.ndim == 3:
            return arr[..., None] / 255.0
    native.count_parse("numpy", "idx")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"{path}: bad idx image magic {magic}")
        data = np.frombuffer(f.read(n * rows * cols), np.uint8)
    return data.reshape(n, rows, cols, 1).astype(np.float32) / 255.0


def _read_idx_labels(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"{path}: bad idx label magic {magic}")
        return np.frombuffer(f.read(n), np.uint8).astype(np.int64)


class BaseDataFetcher:
    """Cursor-based fetcher protocol (datasets/fetchers/BaseDataFetcher)."""

    def __init__(self, features: np.ndarray, labels: np.ndarray,
                 num_classes: int, synthetic: bool):
        self.features = features
        self.labels = labels
        self.num_classes = num_classes
        self.is_synthetic = synthetic

    def total_examples(self) -> int:
        return int(self.features.shape[0])

    def fetch(self, start: int, num: int) -> DataSet:
        x = self.features[start:start + num]
        y = np.eye(self.num_classes, dtype=np.float32)[
            self.labels[start:start + num]]
        return DataSet(x, y)

    def input_columns(self) -> int:
        return int(np.prod(self.features.shape[1:]))

    def total_outcomes(self) -> int:
        return self.num_classes


class MnistDataFetcher(BaseDataFetcher):
    """MNIST from local idx files, or a deterministic synthetic surrogate
    (digit-dependent gaussian blobs over 28x28) when absent."""

    FILES = {
        True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
        False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    }

    def __init__(self, train: bool = True, binarize: bool = False,
                 flatten: bool = True, num_examples: Optional[int] = None,
                 seed: int = 123):
        img_name, lbl_name = self.FILES[train]
        base = os.path.join(data_dir(), "mnist")
        # each file resolves independently: local copy, else on-demand
        # fetch (opt-in, retry-guarded) — a cached image file must not
        # suppress downloading a missing label file
        img_path = (_first_existing(base, img_name)
                    or _maybe_download_mnist(base, img_name))
        lbl_path = _first_existing(base, lbl_name)
        if lbl_path is None and img_path is not None:
            # short-circuit: once the image fetch failed, synthetic is
            # already decided — don't burn the label fetch's retry budget
            lbl_path = _maybe_download_mnist(base, lbl_name)
        synthetic = img_path is None or lbl_path is None
        if not synthetic:
            x = _read_idx_images(img_path)
            y = _read_idx_labels(lbl_path)
        else:
            n = num_examples or (60000 if train else 10000)
            n = min(n, 10000)  # keep the synthetic surrogate small
            x, y = _synthetic_mnist(n, seed + (0 if train else 1))
        if num_examples is not None:
            x, y = x[:num_examples], y[:num_examples]
        if binarize:
            x = (x > 0.5).astype(np.float32)
        if flatten:
            x = x.reshape(x.shape[0], -1)
        super().__init__(x, y, 10, synthetic)


def _first_existing(base: str, name: str) -> Optional[str]:
    for candidate in (os.path.join(base, name),
                      os.path.join(base, name + ".gz")):
        if os.path.exists(candidate):
            return candidate
    return None


def _synthetic_mnist(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Digit-dependent blob images: class-separable, deterministic."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 10, n)
    x = np.zeros((n, 28, 28, 1), np.float32)
    yy, xx = np.mgrid[0:28, 0:28]
    for digit in range(10):
        idx = np.where(y == digit)[0]
        if idx.size == 0:
            continue
        cy, cx = 7 + 2 * (digit // 5), 5 + 4 * (digit % 5)
        blob = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0))
        noise = rng.random((idx.size, 28, 28)).astype(np.float32) * 0.2
        x[idx, :, :, 0] = np.clip(blob[None] + noise, 0, 1)
    return x, y


class IrisDataFetcher(BaseDataFetcher):
    """Iris from a local CSV (sepal/petal cols + class index), else a
    deterministic 3-cluster synthetic with iris-like feature scales."""

    def __init__(self, seed: int = 6):
        path = os.path.join(data_dir(), "iris", "iris.csv")
        if os.path.exists(path):
            raw = np.loadtxt(path, delimiter=",")
            x = raw[:, :4].astype(np.float32)
            y = raw[:, 4].astype(np.int64)
            synthetic = False
        else:
            rng = np.random.default_rng(seed)
            centers = np.asarray([[5.0, 3.4, 1.5, 0.2],
                                  [5.9, 2.8, 4.3, 1.3],
                                  [6.6, 3.0, 5.6, 2.0]], np.float32)
            scales = np.asarray([[0.35, 0.38, 0.17, 0.10],
                                 [0.52, 0.31, 0.47, 0.20],
                                 [0.64, 0.32, 0.55, 0.27]], np.float32)
            y = np.repeat(np.arange(3), 50)
            x = (centers[y] + rng.normal(size=(150, 4)).astype(np.float32)
                 * scales[y])
            synthetic = True
        super().__init__(x, y, 3, synthetic)


class CifarDataFetcher(BaseDataFetcher):
    """CIFAR-10 from local binary batches, else synthetic 32x32x3 blobs."""

    def __init__(self, train: bool = True, num_examples: Optional[int] = None,
                 seed: int = 77):
        base = os.path.join(data_dir(), "cifar-10-batches-bin")
        files = ([f"data_batch_{i}.bin" for i in range(1, 6)] if train
                 else ["test_batch.bin"])
        paths = [os.path.join(base, f) for f in files]
        if all(os.path.exists(p) for p in paths):
            xs, ys = [], []
            for p in paths:
                raw = np.fromfile(p, np.uint8).reshape(-1, 3073)
                ys.append(raw[:, 0].astype(np.int64))
                # stored CHW planar → NHWC
                imgs = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
                xs.append(imgs.astype(np.float32) / 255.0)
            x, y = np.concatenate(xs), np.concatenate(ys)
            synthetic = False
        else:
            n = num_examples or (2000 if train else 500)
            rng = np.random.default_rng(seed + (0 if train else 1))
            y = rng.integers(0, 10, n)
            x = (rng.random((n, 32, 32, 3)).astype(np.float32) * 0.3
                 + (y[:, None, None, None] / 10.0))
            synthetic = True
        if num_examples is not None:
            x, y = x[:num_examples], y[:num_examples]
        super().__init__(x, y, 10, synthetic)


class CurvesDataFetcher(BaseDataFetcher):
    """Synthetic 'curves' autoencoder dataset (CurvesDataFetcher role):
    smooth random 1-D curves rasterized to vectors; labels = curve family."""

    def __init__(self, num_examples: int = 2000, dim: int = 784,
                 seed: int = 99):
        rng = np.random.default_rng(seed)
        t = np.linspace(0, 1, dim, dtype=np.float32)
        y = rng.integers(0, 4, num_examples)
        freq = 1.0 + y.astype(np.float32)
        phase = rng.random(num_examples).astype(np.float32) * 2 * np.pi
        x = 0.5 + 0.5 * np.sin(2 * np.pi * freq[:, None] * t[None]
                               + phase[:, None])
        super().__init__(x.astype(np.float32), y, 4, True)


class LFWDataFetcher(BaseDataFetcher):
    """LFW faces (datasets/iterator/impl/LFWDataSetIterator.java: 250×250×3
    images, one directory per person, label = person).

    Local layout: ``data_dir()/lfw/<person>/<image>.{png,ppm,pgm,npy}``
    (PNG/PNM decode + nearest-neighbor resize via ``utils/image.py`` — no
    PIL/JPEG in the zero-egress image). Without local data, a deterministic
    synthetic surrogate with person-dependent structure is generated.
    """

    def __init__(self, num_examples: Optional[int] = None,
                 img_dim: Tuple[int, int] = (250, 250),
                 num_categories: Optional[int] = None,
                 use_subset: bool = False, seed: int = 123):
        from deeplearning4j_tpu_torch.utils import image as image_util

        h, w = img_dim
        base = os.path.join(data_dir(), "lfw")
        people = (sorted(
            d for d in os.listdir(base)
            if os.path.isdir(os.path.join(base, d)))
            if os.path.isdir(base) else [])
        if use_subset:
            # the reference's useSubset loads the curated "lfw-a" subset;
            # locally: keep only people with >= 2 images
            people = [p for p in people if len(
                os.listdir(os.path.join(base, p))) >= 2]
        if num_categories is not None:
            people = people[:num_categories]
        synthetic = not people
        if not synthetic:
            xs, ys = [], []
            for label, person in enumerate(people):
                pdir = os.path.join(base, person)
                for fname in sorted(os.listdir(pdir)):
                    path = os.path.join(pdir, fname)
                    try:
                        if fname.endswith(".npy"):
                            img = np.load(path).astype(np.float32)
                            if img.max() > 1.0:
                                img = img / 255.0
                        else:
                            img = image_util.as_matrix(path)
                    except (ValueError, OSError):
                        continue  # undecodable format (e.g. JPEG): skip
                    if img.ndim == 2:
                        img = np.repeat(img[..., None], 3, axis=-1)
                    if img.shape[:2] != (h, w):
                        img = image_util.resize(img, h, w)
                    xs.append(img[..., :3])
                    ys.append(label)
                    if num_examples is not None and len(xs) >= num_examples:
                        break
                if num_examples is not None and len(xs) >= num_examples:
                    break
            if not xs:
                synthetic = True  # directories exist but nothing decodable
            else:
                x = np.stack(xs).astype(np.float32)
                y = np.asarray(ys, np.int64)
                n_classes = len(people)
        if synthetic:
            n_classes = num_categories or 10
            n = min(num_examples or 400, 2000)
            rng = np.random.default_rng(seed)
            y = rng.integers(0, n_classes, n)
            # person-dependent "face": oval + eye offsets parameterized by
            # the label so classes are separable
            yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
            cy, cx = h / 2, w / 2
            x = np.empty((n, h, w, 3), np.float32)
            for i in range(n):
                k = float(y[i])
                oval = (((yy - cy) / (h * (0.30 + 0.02 * (k % 5)))) ** 2
                        + ((xx - cx) / (w * (0.20 + 0.02 * (k % 7)))) ** 2) < 1
                img = 0.2 + 0.6 * oval.astype(np.float32)
                img += rng.normal(0, 0.05, (h, w)).astype(np.float32)
                x[i] = np.clip(img, 0, 1)[..., None]
        if num_examples is not None:
            x, y = x[:num_examples], y[:num_examples]
        super().__init__(x, y, n_classes, synthetic)


class MovingWindowDataSetFetcher(BaseDataFetcher):
    """Sliding-window augmentation fetcher
    (datasets/iterator/impl/MovingWindowDataSetFetcher.java): every example
    is expanded into its window tiles (plus 3 rot90 variants for square
    windows, as the reference constructs MovingWindowMatrix with
    addRotate=true), all merged into one dataset, each tile inheriting the
    source example's label."""

    def __init__(self, data: DataSet, window_rows: int, window_cols: int):
        from deeplearning4j_tpu_torch.utils.matrix import MovingWindowMatrix

        feats = np.asarray(data.features, np.float32)
        labels = np.asarray(data.labels, np.float32)
        if feats.ndim == 2:  # flattened square images
            side = int(np.sqrt(feats.shape[1]))
            imgs = feats.reshape(-1, side, side)
        elif feats.ndim == 4:
            if feats.shape[-1] != 1:
                raise ValueError(
                    f"MovingWindowDataSetFetcher windows single-channel "
                    f"images; got {feats.shape[-1]} channels")
            imgs = feats[..., 0]
        else:
            imgs = feats
        xs, ys = [], []
        for i in range(imgs.shape[0]):
            windows = MovingWindowMatrix(
                imgs[i], window_rows, window_cols, add_rotate=True
            ).windows(flattened=feats.ndim == 2)
            for wdw in windows:
                xs.append(wdw)
                ys.append(labels[i])
        x = np.stack(xs).astype(np.float32)
        y = np.stack(ys).astype(np.float32)
        super().__init__(x, y, labels.shape[-1], False)

    def fetch(self, start: int, num: int) -> DataSet:
        # labels are already one-hot rows (no class-index lookup)
        return DataSet(self.features[start:start + num],
                       self.labels[start:start + num])


# ---------------------------------------------------------------------------
# canonical iterators (datasets/iterator/impl/)
# ---------------------------------------------------------------------------


class MnistDataSetIterator(BaseDataSetIterator):
    def __init__(self, batch_size: int, num_examples: Optional[int] = None,
                 train: bool = True, binarize: bool = False,
                 flatten: bool = True, seed: int = 123):
        fetcher = MnistDataFetcher(train=train, binarize=binarize,
                                   flatten=flatten, num_examples=num_examples,
                                   seed=seed)
        super().__init__(batch_size,
                         min(num_examples or fetcher.total_examples(),
                             fetcher.total_examples()), fetcher)


class IrisDataSetIterator(BaseDataSetIterator):
    def __init__(self, batch_size: int, num_examples: int = 150):
        fetcher = IrisDataFetcher()
        super().__init__(batch_size, min(num_examples, fetcher.total_examples()),
                         fetcher)


class CifarDataSetIterator(BaseDataSetIterator):
    def __init__(self, batch_size: int, num_examples: Optional[int] = None,
                 train: bool = True):
        fetcher = CifarDataFetcher(train=train, num_examples=num_examples)
        super().__init__(batch_size,
                         min(num_examples or fetcher.total_examples(),
                             fetcher.total_examples()), fetcher)


class CurvesDataSetIterator(BaseDataSetIterator):
    def __init__(self, batch_size: int, num_examples: int = 2000):
        fetcher = CurvesDataFetcher(num_examples=num_examples)
        super().__init__(batch_size, num_examples, fetcher)


class RawMnistDataSetIterator(BaseDataSetIterator):
    """MNIST without binarization — raw grayscale values
    (datasets/iterator/impl/RawMnistDataSetIterator.java: fetcher built
    with binarize=false)."""

    def __init__(self, batch_size: int, num_examples: Optional[int] = None):
        fetcher = MnistDataFetcher(train=True, binarize=False, flatten=True,
                                   num_examples=num_examples)
        super().__init__(batch_size,
                         min(num_examples or fetcher.total_examples(),
                             fetcher.total_examples()), fetcher)


class LFWDataSetIterator(BaseDataSetIterator):
    """LFW face-recognition iterator (LFWDataSetIterator.java's constructor
    family: batch, numExamples, imgDim [h, w], numCategories, useSubset)."""

    def __init__(self, batch_size: int, num_examples: Optional[int] = None,
                 img_dim: Tuple[int, int] = (250, 250),
                 num_categories: Optional[int] = None,
                 use_subset: bool = False, seed: int = 123):
        fetcher = LFWDataFetcher(num_examples=num_examples, img_dim=img_dim,
                                 num_categories=num_categories,
                                 use_subset=use_subset, seed=seed)
        super().__init__(batch_size,
                         min(num_examples or fetcher.total_examples(),
                             fetcher.total_examples()), fetcher)


class MovingWindowDataSetIterator(BaseDataSetIterator):
    """Iterator over MovingWindowDataSetFetcher's window-augmented data."""

    def __init__(self, batch_size: int, data: DataSet, window_rows: int,
                 window_cols: int):
        fetcher = MovingWindowDataSetFetcher(data, window_rows, window_cols)
        super().__init__(batch_size, fetcher.total_examples(), fetcher)
