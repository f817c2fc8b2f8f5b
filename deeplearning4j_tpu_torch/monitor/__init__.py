"""Telemetry: metrics registry, span tracer, exporters, flight recorder,
run ledger, device-memory watermarks, program profiles and the
in-program metrics pack.

Port of ``deeplearning4j_tpu/monitor``:

- :mod:`.registry` — ``MetricsRegistry`` (counters, gauges and
  histograms with labels); ``metrics()`` is the process-wide instance.
- :mod:`.trace` — ``SpanTracer`` (``with`` spans on a monotonic clock,
  parent ids, an injectable clock, a sink and the flight hook);
  ``tracer()`` is the process-wide instance.
- :mod:`.exporters` — the JSONL event log and the Prometheus textfile
  under ``DL4J_TELEMETRY_DIR``, and ``telemetry_summary()``.
- :mod:`.flight` — the crash-surviving flight recorder (``DL4J_FLIGHT``).
- :mod:`.ledger` — the run ledger: a fused run's wall time classified by
  state from the spans and the chunk driver's boundary marks.
- :mod:`.memory` — device-memory watermarks from ``torch.cuda``'s
  allocator statistics, and the epoch cache's priced bytes against the
  storage its tensors hold.
- :mod:`.profile` — program profiles (FLOPs from
  ``torch.utils.flop_counter``, the allocator's peak, CUDA-event times)
  and the step-time decomposition against the H100's peaks.
- :mod:`.pack` — the per-step metrics pack of the fused epoch step,
  imported by the networks.

Env surface: ``DL4J_TELEMETRY`` (``on`` puts the metrics pack into the
fused step; default off), ``DL4J_TELEMETRY_STRIDE``,
``DL4J_TELEMETRY_DIR`` (file exporters), ``DL4J_PROFILE`` (profiles and
watermarks) and ``DL4J_FLIGHT``. The registry and the tracer are always
live: they are host-side and cheap.
"""

from __future__ import annotations

import logging
import os

from deeplearning4j_tpu_torch.monitor.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    metrics,
)
from deeplearning4j_tpu_torch.monitor.trace import (  # noqa: F401
    Span,
    SpanTracer,
    set_tracer,
    tracer,
)
from deeplearning4j_tpu_torch.monitor.exporters import (  # noqa: F401
    JsonlExporter,
    export_metrics_jsonl,
    telemetry_dir,
    telemetry_summary,
    write_prometheus_textfile,
)
from deeplearning4j_tpu_torch.monitor.profile import (  # noqa: F401
    ProfiledProgram,
    ProgramProfile,
    capture_program_profile,
    classify_boundedness,
    flops_divergence_pct,
    profile_enabled,
    profiles,
)
from deeplearning4j_tpu_torch.monitor.memory import (  # noqa: F401
    sample_hbm_watermark,
    validate_cache_budget,
)
from deeplearning4j_tpu_torch.monitor.ledger import (  # noqa: F401
    RunLedger,
    ledger_chunk_done,
    ledger_chunk_start,
    ledger_run_end,
    ledger_run_start,
    run_ledger,
    set_run_ledger,
)
from deeplearning4j_tpu_torch.monitor.flight import (  # noqa: F401
    FlightRecorder,
    classify_end_state,
    flight,
    flight_record,
    load_flight_records,
    set_flight,
)

# the registry's name in the port before it took the reference's
Registry = MetricsRegistry

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "metrics",
    "Span", "SpanTracer", "set_tracer", "tracer",
    "JsonlExporter", "export_metrics_jsonl", "telemetry_dir",
    "telemetry_summary", "write_prometheus_textfile",
    "telemetry_enabled", "metrics_stride", "fused_metrics_stride",
    "record_counter",
    "ProfiledProgram", "ProgramProfile", "capture_program_profile",
    "classify_boundedness", "flops_divergence_pct", "profile_enabled",
    "profiles", "sample_hbm_watermark", "validate_cache_budget",
    "RunLedger", "ledger_chunk_done", "ledger_chunk_start",
    "ledger_run_end", "ledger_run_start", "run_ledger", "set_run_ledger",
    "FlightRecorder", "classify_end_state", "flight", "flight_record",
    "load_flight_records", "set_flight",
]

_ON = ("1", "on", "true", "yes")
_OFF = ("", "0", "off", "false", "no")


def telemetry_enabled() -> bool:
    """``DL4J_TELEMETRY``: ``on`` puts the in-program metrics pack into
    the fused epoch step. Default off: the step is then exactly the
    step without telemetry."""
    raw = os.environ.get("DL4J_TELEMETRY", "").strip().lower()
    if raw in _ON:
        return True
    if raw not in _OFF:
        logging.getLogger(__name__).warning(
            "DL4J_TELEMETRY=%r is not on/off; treating as off", raw)
    return False


def metrics_stride() -> int:
    """``DL4J_TELEMETRY_STRIDE`` (default 1): the metrics pack is kept on
    every stride-th iteration; the other rows are NaN."""
    raw = os.environ.get("DL4J_TELEMETRY_STRIDE", "")
    try:
        return max(1, int(raw)) if raw else 1
    except ValueError:
        return 1


def fused_metrics_stride(override=None) -> int:
    """Resolve ``fit_epochs(telemetry=...)`` to the stride of the fused
    step, 0 meaning no pack: ``None`` reads the environment, ``False``
    gives 0, ``True`` the environment's stride, an int that stride."""
    if override is None:
        return metrics_stride() if telemetry_enabled() else 0
    if override is False:
        return 0
    if override is True:
        return metrics_stride()
    return max(0, int(override))


def record_counter(name: str, amount: float = 1.0, **labels) -> None:
    """Bump the named counter of the global registry."""
    metrics().counter(name).inc(amount, **labels)
