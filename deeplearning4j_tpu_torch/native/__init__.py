"""ctypes binding of the C++ host runtime (``native/dl4j_host.cpp``).

Port of ``deeplearning4j_tpu/native/__init__.py``: record parsing (CSV,
SVMLight, idx) and read-ahead file streaming off the Python heap. This
is host code, not a device kernel.

The library is compiled from the repository's ``native/dl4j_host.cpp``
with ``g++`` (the reference's flags) at first use, never at import, into
``kernels/_build/libdl4j_host-<hash>.so`` (git-ignored; the hash covers
the source and the flags, so an edited source is never served stale).
The build goes to a private temporary name and is published with
``os.replace``, so concurrent processes never load a torn file.

As in the reference, :func:`is_available` is advisory and every parse
has a numpy path in its caller: the entry points here return None when
the library cannot be built or loaded, or the input is not what the
native parser takes. Every parse that runs here counts
``native_parse_total{path="native", fmt=...}``; a caller that falls back
counts ``path="numpy"`` (:func:`count_parse`), so a run can tell which
parser served it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(_HERE))
SRC = os.path.join(_ROOT, "native", "dl4j_host.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "kernels", "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def count_parse(path: str, fmt: str) -> None:
    """Count one parse by the parser that served it (``native`` or
    ``numpy``)."""
    from deeplearning4j_tpu_torch.monitor import record_counter

    record_counter("native_parse_total", path=path, fmt=fmt)


def library_path() -> str:
    """Where the library builds to: the name hashes the source and the
    flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libdl4j_host-{h.hexdigest()[:12]}.so")


def _build(so: str) -> bool:
    """Compile to a private name, then publish atomically."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.build-{os.getpid()}-{threading.get_ident()}"
    cmd = ["g++", *CXX_FLAGS, SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)
        return True
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_p, c_i64, c_i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.dl4j_buf_data.restype = ctypes.POINTER(ctypes.c_float)
    lib.dl4j_buf_data.argtypes = [c_p]
    lib.dl4j_buf_size.restype = c_i64
    lib.dl4j_buf_size.argtypes = [c_p]
    lib.dl4j_buf_ndim.restype = c_i32
    lib.dl4j_buf_ndim.argtypes = [c_p]
    lib.dl4j_buf_dims.restype = None
    lib.dl4j_buf_dims.argtypes = [c_p, ctypes.POINTER(c_i64)]
    lib.dl4j_buf_free.restype = None
    lib.dl4j_buf_free.argtypes = [c_p]
    lib.dl4j_csv_parse.restype = c_p
    lib.dl4j_csv_parse.argtypes = [ctypes.c_char_p, ctypes.c_char, c_i64]
    lib.dl4j_svmlight_parse.restype = c_p
    lib.dl4j_svmlight_parse.argtypes = [ctypes.c_char_p, c_i64, c_i32]
    lib.dl4j_idx_parse.restype = c_p
    lib.dl4j_idx_parse.argtypes = [ctypes.c_char_p]
    lib.dl4j_stream_open.restype = c_p
    lib.dl4j_stream_open.argtypes = [ctypes.c_char_p, c_i64, c_i64]
    lib.dl4j_stream_next.restype = c_i64
    lib.dl4j_stream_next.argtypes = [c_p, ctypes.c_char_p]
    lib.dl4j_stream_close.restype = None
    lib.dl4j_stream_close.argtypes = [c_p]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if not os.path.exists(SRC):
            _load_failed = True
            return None
        so = library_path()
        if not os.path.exists(so) and not _build(so):
            _load_failed = True
            return None
        try:
            _lib = _bind(ctypes.CDLL(so))
        except OSError:
            _load_failed = True
            return None
        return _lib


def is_available() -> bool:
    return _load() is not None


def _buf_to_flat(lib, handle) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """Copy a native buffer out as (flat float32 array, header dims).
    The flat size may exceed prod(dims): SVMLight appends the labels."""
    try:
        size = lib.dl4j_buf_size(handle)
        ndim = lib.dl4j_buf_ndim(handle)
        dims = (ctypes.c_int64 * max(ndim, 1))()
        lib.dl4j_buf_dims(handle, dims)
        shape = tuple(dims[i] for i in range(ndim))
        if size == 0:  # empty vector: .data() is NULL
            return np.zeros((0,), np.float32), shape
        flat = np.ctypeslib.as_array(lib.dl4j_buf_data(handle),
                                     shape=(size,)).astype(np.float32,
                                                           copy=True)
        return flat, shape
    finally:
        lib.dl4j_buf_free(handle)


def csv_to_array(path: str, delimiter: str = ",",
                 skip_lines: int = 0) -> Optional[np.ndarray]:
    """Parse an all-numeric CSV into [rows, cols] float32. None when the
    file is non-numeric or ragged (the caller takes its numpy path) or
    the library is unavailable."""
    lib = _load()
    if lib is None or len(delimiter) != 1:
        return None
    h = lib.dl4j_csv_parse(path.encode(), delimiter.encode(), skip_lines)
    if not h:
        return None
    flat, shape = _buf_to_flat(lib, h)
    count_parse("native", "csv")
    return flat.reshape(shape)


def svmlight_to_arrays(path: str, num_features: int,
                       zero_based: bool = False
                       ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Parse SVMLight into (features [rows, n], labels [rows])."""
    lib = _load()
    if lib is None:
        return None
    h = lib.dl4j_svmlight_parse(path.encode(), num_features,
                                1 if zero_based else 0)
    if not h:
        return None
    # buffer layout: rows*n features then rows labels (dims = [rows, n])
    flat, (rows, n) = _buf_to_flat(lib, h)
    count_parse("native", "svmlight")
    return flat[:rows * n].reshape(rows, n), flat[rows * n:rows * n + rows]


def idx_to_array(path: str) -> Optional[np.ndarray]:
    """Parse an idx (MNIST) file into a float32 array with header dims."""
    lib = _load()
    if lib is None:
        return None
    h = lib.dl4j_idx_parse(path.encode())
    if not h:
        return None
    flat, shape = _buf_to_flat(lib, h)
    count_parse("native", "idx")
    return flat.reshape(shape)


class FileStreamer:
    """Background read-ahead over a binary file of fixed-size chunks: a
    C++ thread fills a bounded ring; ``next()`` blocks on its condition
    variable, never on the file. Iterate to EOF or ``close()`` early."""

    def __init__(self, path: str, chunk_bytes: int, capacity: int = 4):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.chunk_bytes = chunk_bytes
        # one receive buffer, reused: next() calls are serialized per
        # streamer
        self._buf = ctypes.create_string_buffer(chunk_bytes)
        self._h = lib.dl4j_stream_open(path.encode(), chunk_bytes, capacity)
        if not self._h:
            raise OSError(f"cannot stream {path}")

    def next(self) -> Optional[bytes]:
        if self._h is None:  # closed: the C side would dereference NULL
            return None
        got = self._lib.dl4j_stream_next(self._h, self._buf)
        if got == 0:
            return None
        return self._buf.raw[:got]

    def __iter__(self):
        while (b := self.next()) is not None:
            yield b

    def close(self) -> None:
        if self._h:
            self._lib.dl4j_stream_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        # a dropped streamer must release the C++ reader thread and FILE*
        try:
            self.close()
        except Exception:
            pass
