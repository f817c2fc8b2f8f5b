"""Build the port's CUDA kernels with ``nvcc`` at first use and load them
with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``_build/lib<name>-<hash>.so`` (the directory is git-ignored), with
``NVCC_FLAGS`` and the source's own flags (``SOURCE_FLAGS`` of the
package). The hash covers the source, every shared header ``csrc/*.cuh``
and the flags, so a stale library is impossible to load. Nothing is
built when a module is imported: the CPU tests import every module on
machines without ``nvcc``. ``LOGS`` keeps each build's compiler output,
with ptxas's register and spill counts.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Iterable, List

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: compiler output of each library built by this process, by source name
LOGS: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


class KernelBuildError(RuntimeError):
    """A kernel library could not be built (no ``nvcc``, or it failed)."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise KernelBuildError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card (set CUDA_HOME or "
                           "PATH)")


def nvcc_flags(name: str) -> tuple:
    """The compiler flags of ``csrc/<name>.cu``: ``NVCC_FLAGS`` and the
    source's own."""
    from deeplearning4j_tpu_torch.kernels import SOURCE_FLAGS

    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to: the file name carries a hash of
    the source, of every ``csrc/*.cuh`` (sorted by name) and of the
    flags."""
    h = hashlib.sha256(" ".join(nvcc_flags(name)).encode())
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    for path in [os.path.join(CSRC, f"{name}.cu")] + headers:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _compile_cmd(name: str, out: str) -> List[str]:
    return [nvcc_path(), *nvcc_flags(name), "-o", out,
            os.path.join(CSRC, f"{name}.cu")]


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns ``{name: library path}``;
    raises with the compiler's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    paths = {}
    for name in names:
        path = paths[name] = library_path(name)
        if os.path.exists(path):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        procs[name] = (tmp, subprocess.Popen(
            _compile_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        LOGS[name] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, paths[name])
    if errors:
        raise KernelBuildError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(build_all([name])[name])
        return lib
