"""Telemetry exporters: JSONL event log, Prometheus textfile, summary block.

Three sinks, one source of truth (the :mod:`registry` snapshot and the
:mod:`trace` ring):

- **JSONL** (``DL4J_TELEMETRY_DIR/telemetry.jsonl``) — append-only event
  log; each line is ``{"kind": "span"|"metrics", "t_wall": <unix>, ...}``.
  The span sink streams every finished span; ``export_metrics_jsonl``
  appends a registry snapshot on demand (drive/bench call it per run).
- **Prometheus textfile** (``DL4J_TELEMETRY_DIR/metrics.prom``) — the
  node-exporter textfile-collector dialect, one snapshot per write; a
  scraper (or a human) reads counters/gauges/histograms with labels.
- **Summary block** (``telemetry_summary()``) — the dict embedded in
  every ``BENCH_*.json`` / ``bench_partial.json``: metrics snapshot +
  per-span-name aggregates + the recent-span timeline, so a wedged grant
  leaves a diagnosable artifact instead of a bare error line.

All exporters degrade silently on I/O errors — telemetry must never be
the thing that kills a training run.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Callable, Optional

logger = logging.getLogger(__name__)

__all__ = [
    "JsonlExporter",
    "export_metrics_jsonl",
    "span_sink_from_env",
    "telemetry_dir",
    "telemetry_summary",
    "write_prometheus_textfile",
]

JSONL_NAME = "telemetry.jsonl"
PROM_NAME = "metrics.prom"


def telemetry_dir() -> Optional[str]:
    """``DL4J_TELEMETRY_DIR`` — directory for the JSONL event log and the
    Prometheus textfile; unset disables file export entirely."""
    d = os.environ.get("DL4J_TELEMETRY_DIR", "").strip()
    return d or None


class JsonlExporter:
    """Append-only JSON-lines writer (thread-safe, best-effort I/O).

    Disk use is BOUNDED: once the file exceeds ``max_bytes`` it rotates
    through the flight recorder's shift mechanism (``path`` →
    ``path.1`` → … up to ``backups`` files, oldest overwritten), so an
    always-on span sink can no longer grow ``telemetry.jsonl`` without
    limit. Defaults come from the shared segment knobs
    (``DL4J_FLIGHT_SEGMENT_KB`` / ``DL4J_FLIGHT_SEGMENTS``); pass
    ``max_bytes=0`` for the legacy unbounded behavior."""

    def __init__(self, path: str, max_bytes: Optional[int] = None,
                 backups: Optional[int] = None):
        from deeplearning4j_tpu_torch.monitor.flight import (
            max_segments, segment_bytes)

        self.path = path
        self.max_bytes = (segment_bytes() if max_bytes is None
                          else int(max_bytes))
        self.backups = (max_segments() - 1 if backups is None
                        else max(0, int(backups)))
        self._lock = threading.Lock()
        self._size: Optional[int] = None
        self._warned = False

    def write(self, record: dict) -> None:
        from deeplearning4j_tpu_torch.monitor.flight import shift_rotate

        line = json.dumps(record, default=_json_default) + "\n"
        try:
            with self._lock:
                os.makedirs(os.path.dirname(self.path) or ".",
                            exist_ok=True)
                if self._size is None:
                    try:
                        self._size = os.path.getsize(self.path)
                    except OSError:
                        self._size = 0
                if (self.max_bytes > 0 and self._size > 0
                        and self._size + len(line) > self.max_bytes):
                    try:
                        shift_rotate(self.path, self.backups)
                    except FileNotFoundError:
                        # the live file vanished externally (operator
                        # cleanup, foreign logrotate): nothing to
                        # rotate — fall through and recreate it
                        pass
                    self._size = 0
                with open(self.path, "a") as f:
                    f.write(line)
                self._size += len(line)
        except OSError as e:
            if not self._warned:  # complain once, not per event
                self._warned = True
                logger.warning("telemetry JSONL write to %s failed: %s "
                               "(further failures silent)", self.path, e)


def _json_default(o):
    try:
        return float(o)
    except (TypeError, ValueError):
        return str(o)


def span_sink_from_env() -> Optional[Callable[[dict], None]]:
    """A span sink streaming to ``DL4J_TELEMETRY_DIR/telemetry.jsonl``,
    or None when the env var is unset (tracing stays in-memory only)."""
    d = telemetry_dir()
    if d is None:
        return None
    exporter = JsonlExporter(os.path.join(d, JSONL_NAME))

    def sink(span_dict: dict) -> None:
        exporter.write({"kind": "span", "t_wall": time.time(),
                        **span_dict})

    return sink


def export_metrics_jsonl(registry=None, path: Optional[str] = None
                         ) -> Optional[str]:
    """Append one registry snapshot to the JSONL log; returns the path
    written (None when no directory is configured and no path given)."""
    if registry is None:
        from deeplearning4j_tpu_torch.monitor.registry import metrics

        registry = metrics()
    if path is None:
        d = telemetry_dir()
        if d is None:
            return None
        path = os.path.join(d, JSONL_NAME)
    JsonlExporter(path).write({"kind": "metrics", "t_wall": time.time(),
                               "metrics": registry.snapshot()})
    return path


def write_prometheus_textfile(registry=None, path: Optional[str] = None
                              ) -> Optional[str]:
    """Write the registry as a Prometheus textfile snapshot (atomic
    tmp+rename, so a scraper never reads a torn file). Returns the path,
    or None when no directory is configured and no path given."""
    if registry is None:
        from deeplearning4j_tpu_torch.monitor.registry import metrics

        registry = metrics()
    if path is None:
        d = telemetry_dir()
        if d is None:
            return None
        path = os.path.join(d, PROM_NAME)
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(registry.to_prometheus())
        os.replace(tmp, path)
    except OSError as e:
        logger.warning("prometheus textfile write to %s failed: %s",
                       path, e)
        return None
    return path


def telemetry_summary(registry=None, span_tracer=None,
                      recent_spans: int = 40) -> dict:
    """The metrics+span summary block bench artifacts embed: registry
    snapshot, per-span-name aggregates, the recent-span timeline, and
    the run ledger's goodput/badput report."""
    if registry is None:
        from deeplearning4j_tpu_torch.monitor.registry import metrics

        registry = metrics()
    if span_tracer is None:
        from deeplearning4j_tpu_torch.monitor.trace import tracer

        span_tracer = tracer()
    out = {
        "metrics": registry.snapshot(),
        "spans": span_tracer.summary(recent=recent_spans),
    }
    try:
        from deeplearning4j_tpu_torch.monitor.ledger import run_ledger

        out["ledger"] = run_ledger().report(spans=span_tracer.spans())
    except Exception as e:  # the ledger must never break an artifact
        logger.warning("run-ledger report failed: %s", e)
    return out
