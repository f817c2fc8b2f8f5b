"""Program profiles: the work, memory and time of one program, and the
step-time decomposition against the card's peaks.

Port of ``deeplearning4j_tpu/monitor/profile.py``. The reference reads a
compiled XLA program's ``cost_analysis()`` and ``memory_analysis()``;
the port has no compiled artifact to ask, so it measures one call:

- **FLOPs** from ``torch.utils.flop_counter.FlopCounterMode`` over one
  eager call (the fused paths' CUDA-graph capture is switched off for
  it: a replay dispatches no operator the counter could see). The
  counter sees aten operators only; the hand-written flash kernels
  launch through ctypes, so each launch in the call adds its FLOPs and
  bytes from the formulas its bound uses
  (``kernels.flash_attention.work_sinks``). ``mm.dtype`` (the bf16
  GEMM with f32 output of the training unembedding) is counted as mm.
- **Bytes accessed**: every aten operator's tensor inputs and outputs,
  summed (XLA's per-operation count; nothing is fused), plus the flash
  kernels' bound bytes.
- **Memory**: ``argument_bytes`` and ``output_bytes`` are the call's
  tensors; ``peak_bytes`` the allocator's peak over the counted call
  and ``temp_bytes`` that peak above what was allocated before it.
- **Time** (``measured_s``): CUDA events over ``replays`` further calls
  on the card, after ``warmup`` untimed ones (a captured program's
  warm-up and capture), so that the timed calls are replays; host time
  on the CPU.

:class:`ProgramProfile`, :class:`ProfileStore` (``profiles()``),
:func:`capture_program_profile` and :class:`ProfiledProgram` keep the
reference's fields; a field with no counterpart (``lower_s``,
``generated_code_bytes``, ``alias_bytes``, ``optimal_seconds``) stays
None. :func:`classify_boundedness` and :func:`flops_divergence_pct` are
copies; callers give them the H100's peaks
(``kernels.flash_attention.H100_FLOPS`` and ``H100_BYTES_PER_S``).

Profiles are mirrored into the registry (``program_flops``,
``program_bytes_accessed``, ``program_peak_hbm_bytes`` gauges and the
``program_compile_seconds`` histogram, whose value here is the counted
call's wall time). A capture runs its program and reads allocator state:
callers take one between chunks, never inside a step.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

logger = logging.getLogger(__name__)

__all__ = [
    "ProgramProfile",
    "ProfileStore",
    "ProfiledProgram",
    "capture_program_profile",
    "classify_boundedness",
    "count_work",
    "flops_divergence_pct",
    "profile_enabled",
    "profiles",
]

_ON = ("1", "on", "true", "yes")


def profile_enabled() -> bool:
    """``DL4J_PROFILE``: ``on`` profiles every fused epoch program on its
    first call and samples device-memory watermarks at chunk boundaries.
    Default off: the programs run unwrapped."""
    return os.environ.get("DL4J_PROFILE", "").strip().lower() in _ON


class ProgramProfile:
    """One program's work, memory and timing."""

    __slots__ = ("name", "key", "signature", "flops", "bytes_accessed",
                 "optimal_seconds", "argument_bytes", "output_bytes",
                 "temp_bytes", "alias_bytes", "generated_code_bytes",
                 "peak_bytes", "lower_s", "compile_s", "n_devices",
                 "error", "measured_s", "kernel_flops")

    def __init__(self, name: str, key: Any, signature: Any):
        self.name = name
        self.key = key
        self.signature = signature
        self.flops: Optional[float] = None
        self.bytes_accessed: Optional[float] = None
        self.optimal_seconds: Optional[float] = None
        self.argument_bytes: Optional[int] = None
        self.output_bytes: Optional[int] = None
        self.temp_bytes: Optional[int] = None
        self.alias_bytes: Optional[int] = None
        self.generated_code_bytes: Optional[int] = None
        self.peak_bytes: Optional[int] = None
        self.lower_s: Optional[float] = None
        self.compile_s: Optional[float] = None
        self.n_devices: Optional[int] = None
        self.error: Optional[str] = None
        self.measured_s: Optional[float] = None
        self.kernel_flops: Dict[str, float] = {}

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "key": list(self.key) if isinstance(self.key, tuple)
            else self.key,
            "signature": str(self.signature),
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "optimal_seconds": self.optimal_seconds,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "alias_bytes": self.alias_bytes,
            "generated_code_bytes": self.generated_code_bytes,
            "peak_bytes": self.peak_bytes,
            "lower_s": self.lower_s,
            "compile_s": self.compile_s,
            "n_devices": self.n_devices,
            "error": self.error,
            "measured_s": self.measured_s,
            "kernel_flops": dict(self.kernel_flops),
        }

    def __repr__(self) -> str:
        return (f"ProgramProfile({self.name!r}, key={self.key}, "
                f"flops={self.flops}, peak_bytes={self.peak_bytes}, "
                f"measured_s={self.measured_s})")


class ProfileStore:
    """Thread-safe collection of captured profiles (process-global via
    ``profiles()``; tests construct private stores)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._profiles: List[ProgramProfile] = []

    def add(self, profile: ProgramProfile) -> None:
        with self._lock:
            self._profiles.append(profile)

    def all(self) -> List[ProgramProfile]:
        with self._lock:
            return list(self._profiles)

    def find(self, name: Optional[str] = None,
             key: Optional[Any] = None) -> List[ProgramProfile]:
        return [p for p in self.all()
                if (name is None or p.name == name)
                and (key is None or p.key == key)]

    def snapshot(self) -> List[dict]:
        return [p.to_dict() for p in self.all()]

    def reset(self) -> None:
        with self._lock:
            self._profiles.clear()


_STORE: Optional[ProfileStore] = None
_STORE_LOCK = threading.Lock()


def profiles() -> ProfileStore:
    """The process-global profile store every capture lands in."""
    global _STORE
    if _STORE is None:
        with _STORE_LOCK:
            if _STORE is None:
                _STORE = ProfileStore()
    return _STORE


# ---------------------------------------------------------------------------
# counting one call
# ---------------------------------------------------------------------------


def _leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree)
               if isinstance(t, torch.Tensor))


def _signature_of(args) -> Tuple:
    """(shape, dtype) of every leaf of ``args``: the identity a program
    is captured for."""
    return tuple(
        (tuple(getattr(leaf, "shape", ())),
         str(getattr(leaf, "dtype", type(leaf).__name__)))
        for leaf in _leaves(args))


def _mm_dtype_flop(a_shape, b_shape, *args, out_shape=None, **kwargs):
    """``mm.dtype`` (a GEMM with another output dtype) costs what mm
    costs: 2·m·k·n."""
    m, k = a_shape
    _, n = b_shape
    return 2 * m * k * n


# operators that move no data: views and metadata
_NO_TRAFFIC = ("view", "_unsafe_view", "reshape", "expand", "t",
               "transpose", "permute", "squeeze", "unsqueeze", "slice",
               "select", "as_strided", "alias", "detach", "split",
               "unbind", "chunk", "diagonal", "unfold", "narrow",
               "expand_as", "view_as", "lift_fresh")


def _bytes_mode_cls():
    from torch.utils._python_dispatch import TorchDispatchMode

    class _BytesMode(TorchDispatchMode):
        """Sums the tensor bytes each aten operator reads and writes."""

        def __init__(self):
            super().__init__()
            self.total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__.lstrip("_").rstrip("_") \
                    not in _NO_TRAFFIC:
                self.total += (_tensor_bytes(args)
                               + _tensor_bytes(kwargs or {})
                               + _tensor_bytes(out))
            return out

    return _BytesMode


def count_work(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under the flop counter and the
    bytes counter; returns ``(result, flops, bytes_accessed,
    kernel_flops)``. ``kernel_flops`` is the flash kernels' share by
    kernel, already included in ``flops``."""
    from torch.utils.flop_counter import FlopCounterMode

    from deeplearning4j_tpu_torch.kernels import flash_attention as fa

    kernel_flops: Dict[str, float] = {}
    kernel_bytes = [0]

    def sink(kernel, flops, nbytes):
        kernel_flops[kernel] = kernel_flops.get(kernel, 0) + flops
        kernel_bytes[0] += nbytes

    mapping = {torch.ops.aten.mm.dtype: _mm_dtype_flop,
               torch.ops.aten.mm.dtype_out: _mm_dtype_flop}
    counter = FlopCounterMode(display=False, custom_mapping=mapping)
    bytes_mode = _bytes_mode_cls()()
    fa.work_sinks.append(sink)
    try:
        with counter, bytes_mode:
            out = fn(*args, **kwargs)
    finally:
        fa.work_sinks.remove(sink)
    flops = counter.get_total_flops() + sum(kernel_flops.values())
    return (out, float(flops), float(bytes_mode.total + kernel_bytes[0]),
            kernel_flops)


def _register(profile: ProgramProfile) -> None:
    """Mirror the profile into the global registry."""
    from deeplearning4j_tpu_torch.monitor import record_counter
    from deeplearning4j_tpu_torch.monitor.registry import metrics

    reg = metrics()
    labels = {"program": profile.name, "key": str(profile.key)}
    if profile.flops is not None:
        reg.gauge("program_flops",
                  "counted FLOPs per program execution").set(
            profile.flops, **labels)
    if profile.bytes_accessed is not None:
        reg.gauge("program_bytes_accessed",
                  "counted bytes accessed per execution").set(
            profile.bytes_accessed, **labels)
    if profile.peak_bytes is not None:
        reg.gauge("program_peak_hbm_bytes",
                  "allocator peak over the counted call").set(
            profile.peak_bytes, **labels)
    if profile.compile_s is not None:
        reg.histogram("program_compile_seconds",
                      "wall time of the counted (first) call"
                      ).observe(profile.compile_s, program=profile.name)
    record_counter("program_profiles_total", program=profile.name,
                   outcome="error" if profile.error else "ok")


def _on_card(args) -> bool:
    return any(isinstance(t, torch.Tensor) and t.is_cuda
               for t in _leaves(args))


def _time_calls(fn, args, n: int, cuda: bool) -> float:
    """Seconds per call over ``n`` calls: CUDA events on the card, the
    host clock elsewhere."""
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(n):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn(*args)
    return (time.perf_counter() - t0) / n


def _capture_profile(fn, args, name, key, replays: int, warmup: int):
    from deeplearning4j_tpu_torch.perf.step_graph import eager_steps

    profile = ProgramProfile(name, key, _signature_of(args))
    cuda = _on_card(args)
    profile.argument_bytes = _tensor_bytes(args)
    profile.n_devices = torch.cuda.device_count() if cuda else 1
    before = 0
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with eager_steps():  # a replay dispatches nothing the counters see
        out, flops, nbytes, kflops = count_work(fn, *args)
    if cuda:
        torch.cuda.synchronize()
        profile.peak_bytes = int(torch.cuda.max_memory_allocated())
        profile.temp_bytes = profile.peak_bytes - int(before)
    profile.compile_s = round(time.perf_counter() - t0, 6)
    profile.flops, profile.bytes_accessed = flops, nbytes
    profile.kernel_flops = kflops
    profile.output_bytes = _tensor_bytes(out)
    if replays > 0:
        for _ in range(warmup):
            fn(*args)
        profile.measured_s = _time_calls(fn, args, replays, cuda)
    return profile, out


def capture_program_profile(fn, args, *, name: str, key: Any = (),
                            store: Optional[ProfileStore] = None,
                            replays: int = 10, warmup: int = 2):
    """Count one eager call of ``fn(*args)`` (FLOPs, bytes, memory), then
    run ``warmup`` calls untimed and time ``replays`` more (none of either
    when ``replays`` is 0); register the profile and return
    ``(profile, output of the counted call)``. Each call is a real call:
    a training step trains. Runs inside a ``profile.capture`` span."""
    from deeplearning4j_tpu_torch.monitor import tracer

    with tracer().span("profile.capture", program=name,
                       key=str(key)) as sp:
        profile, out = _capture_profile(fn, tuple(args), name, key, replays,
                                        warmup)
        sp.attrs.update(flops=profile.flops,
                        peak_bytes=profile.peak_bytes,
                        measured_s=profile.measured_s)
    (store if store is not None else profiles()).add(profile)
    _register(profile)
    return profile, out


class ProfiledProgram:
    """A fused program and its profile. With ``DL4J_PROFILE`` off every
    call passes straight through. With it on, the first call per
    argument signature runs eagerly under the counters (the same steps:
    replays equal eager steps bitwise) and captures the
    :class:`ProgramProfile`; later calls pass through. A capture failure
    logs once and the call runs plainly: profiling must never stop
    training."""

    def __init__(self, fn, *, name: str, key: Any):
        self._fn = fn
        self.name = name
        self.key = key
        self._seen: Dict[Tuple, bool] = {}
        self.profiles: List[ProgramProfile] = []

    def __call__(self, *args):
        if not profile_enabled():
            return self._fn(*args)
        sig = _signature_of(args)
        if sig in self._seen:
            return self._fn(*args)
        self._seen[sig] = True
        try:
            prof, out = capture_program_profile(
                self._fn, args, name=self.name, key=self.key, replays=0)
        except Exception as e:
            logger.warning("profile capture for %s%s failed (%s); running "
                           "the call plainly", self.name, self.key, e)
            return self._fn(*args)
        self.profiles.append(prof)
        return out

    def __getattr__(self, attr):
        return getattr(self._fn, attr)

    def __repr__(self) -> str:
        return (f"ProfiledProgram({self.name!r}, key={self.key}, "
                f"profiles={len(self.profiles)})")


# ---------------------------------------------------------------------------
# the step-time decomposition (copies of the reference's)
# ---------------------------------------------------------------------------


def classify_boundedness(flops: Optional[float],
                         bytes_accessed: Optional[float],
                         measured_s: Optional[float],
                         peak_flops_per_s: float,
                         peak_bytes_per_s: float) -> dict:
    """Decompose a measured step time against the cost model.

    ``optimal_compute_s`` = FLOPs / peak FLOP/s and ``optimal_memory_s``
    = bytes accessed / peak memory rate are the two roofline floors; the
    larger is the program's optimal device time and names it compute- or
    memory-bound. What the measured time spends above that optimum is
    dispatch and overhead."""
    out = {
        "flops": flops,
        "bytes_accessed": bytes_accessed,
        "measured_s": measured_s,
        "optimal_compute_s": None,
        "optimal_memory_s": None,
        "optimal_s": None,
        "dispatch_wait_s": None,
        "dispatch_wait_pct": None,
        "arithmetic_intensity": None,
        "bound": None,
    }
    if flops is not None and peak_flops_per_s > 0:
        out["optimal_compute_s"] = flops / peak_flops_per_s
    if bytes_accessed is not None and peak_bytes_per_s > 0:
        out["optimal_memory_s"] = bytes_accessed / peak_bytes_per_s
    if flops is not None and bytes_accessed:
        out["arithmetic_intensity"] = flops / bytes_accessed
    floors = [s for s in (out["optimal_compute_s"],
                          out["optimal_memory_s"]) if s is not None]
    if floors:
        out["optimal_s"] = max(floors)
        if (out["optimal_compute_s"] is not None
                and out["optimal_memory_s"] is not None):
            out["bound"] = ("compute"
                            if out["optimal_compute_s"]
                            >= out["optimal_memory_s"] else "memory")
        elif out["optimal_compute_s"] is not None:
            out["bound"] = "compute"
        else:
            out["bound"] = "memory"
    if measured_s is not None and out["optimal_s"] is not None:
        out["dispatch_wait_s"] = max(0.0, measured_s - out["optimal_s"])
        if measured_s > 0:
            out["dispatch_wait_pct"] = round(
                100.0 * out["dispatch_wait_s"] / measured_s, 2)
    return out


def flops_divergence_pct(analytic: Optional[float],
                         cost_analysis: Optional[float]
                         ) -> Optional[float]:
    """Signed divergence of the counted FLOPs from the analytic formula,
    as a percentage of the analytic value (positive: the counter counts
    more work than the formula). None when either side is missing or
    the analytic value is zero."""
    if not analytic or cost_analysis is None:
        return None
    return round(100.0 * (cost_analysis - analytic) / analytic, 2)
