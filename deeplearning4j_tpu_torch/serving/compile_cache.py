"""A shared build cache for the kernel libraries, for a fleet's cold start.

Port of ``deeplearning4j_tpu/serving/compile_cache.py``. The reference
points jax's persistent compilation cache at ``DL4J_COMPILE_CACHE_DIR``
so that a cold replica replays its programs from disk. The port runs its
models eagerly; its only compiled artifacts are the CUDA kernel
libraries, which ``kernels/_build.py`` builds with ``nvcc`` at first use
into a file named by the hash of the sources and the flags. Pointing
``_build.BUILD_DIR`` at ``DL4J_COMPILE_CACHE_DIR`` lets every process
that shares the directory load a library another process built, instead
of running ``nvcc`` again (the build writes each library under a
temporary name and renames it, so a reader never sees half a file).

Configuration is lazy: ``ensure_compile_cache()`` runs before the serving
layer's first kernel build (``DecodeEngine.__init__``), never at import,
and is idempotent; pointing the variable at a new directory reconfigures.
With the variable unset nothing changes: the kernels build into the
package's git-ignored ``kernels/_build/``.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

from deeplearning4j_tpu_torch.kernels import _build
from deeplearning4j_tpu_torch.monitor import record_counter, tracer

logger = logging.getLogger(__name__)

__all__ = ["compile_cache_dir", "ensure_compile_cache",
           "compile_cache_stats"]

_LOCK = threading.Lock()
_CONFIGURED_DIR: Optional[str] = None
_DEFAULT_BUILD_DIR = _build.BUILD_DIR


def compile_cache_dir() -> Optional[str]:
    """``DL4J_COMPILE_CACHE_DIR``: the shared directory of the kernel
    libraries (unset: the package's own build directory)."""
    raw = os.environ.get("DL4J_COMPILE_CACHE_DIR", "").strip()
    return os.path.abspath(raw) if raw else None


def ensure_compile_cache() -> Optional[str]:
    """Point the kernels' build directory at ``DL4J_COMPILE_CACHE_DIR``
    if it is set. Returns the configured directory, or None when the
    variable is unset."""
    global _CONFIGURED_DIR
    d = compile_cache_dir()
    if d is None:
        return None
    with _LOCK:
        if _CONFIGURED_DIR == d:
            return d
        os.makedirs(d, exist_ok=True)
        _build.BUILD_DIR = d
        _CONFIGURED_DIR = d
        tracer().event("serve.compile_cache", dir=d)
        record_counter("serve_compile_cache_configured_total")
        logger.info("kernel build cache at %s", d)
        return d


def compile_cache_stats() -> dict:
    """On-disk view of the cache: ``{dir, configured, entries, bytes}``,
    what a run reports so that warm-start claims are checkable."""
    d = compile_cache_dir()
    entries = 0
    size = 0
    if d and os.path.isdir(d):
        for root, _dirs, files in os.walk(d):
            for f in files:
                entries += 1
                try:
                    size += os.path.getsize(os.path.join(root, f))
                except OSError:
                    pass
    return {"dir": d, "configured": _CONFIGURED_DIR == d and d is not None,
            "entries": entries, "bytes": size}


def _reset_for_tests() -> None:
    """Forget the configuration and restore the package's build
    directory."""
    global _CONFIGURED_DIR
    with _LOCK:
        _CONFIGURED_DIR = None
        _build.BUILD_DIR = _DEFAULT_BUILD_DIR
