"""The metrics registry, span tracer and telemetry knobs the port uses.

Counterpart of the parts of ``deeplearning4j_tpu/monitor`` that
``serving/server.py`` and the fused training paths call: labelled
counters, gauges and histograms in one process-wide registry
(:func:`metrics`, :func:`record_counter`), a tracer (:func:`tracer`)
whose spans time a ``with`` block on the host clock and whose events are
kept in a bounded ring, and the ``DL4J_TELEMETRY`` /
``DL4J_TELEMETRY_STRIDE`` resolution of the in-program metrics pack
(:func:`fused_metrics_stride`, the pack itself in :mod:`.pack`).
Exporters, the flight recorder, the run ledger and device-memory
watermarks are not ported yet (ROADMAP A12).
"""

from __future__ import annotations

import bisect
import logging
import os
import threading
import time
from collections import deque
from typing import Deque, Dict, Optional, Sequence, Tuple

_DEFAULT_BUCKETS = (0.001, 0.01, 0.1, 1.0, 10.0, float("inf"))


def _key(labels: dict) -> Tuple:
    return tuple(sorted(labels.items()))


class Counter:
    def __init__(self):
        self._v: Dict[Tuple, float] = {}
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0, **labels) -> None:
        k = _key(labels)
        with self._lock:
            self._v[k] = self._v.get(k, 0.0) + n

    def value(self, **labels) -> float:
        return self._v.get(_key(labels), 0.0)


class Gauge:
    def __init__(self):
        self._v: Dict[Tuple, float] = {}
        self._lock = threading.Lock()

    def set(self, v: float, **labels) -> None:
        with self._lock:
            self._v[_key(labels)] = float(v)

    def value(self, **labels) -> float:
        """The labelled series' value; 0.0 for one never set (or
        removed), as the reference's registry reads it."""
        return self._v.get(_key(labels), 0.0)

    def remove(self, **labels) -> bool:
        """Drop one labelled series (a dead replica stops reporting as
        current); returns whether it existed."""
        with self._lock:
            return self._v.pop(_key(labels), None) is not None


class Histogram:
    def __init__(self, buckets: Sequence[float]):
        self.buckets = tuple(buckets)
        self.counts = [0] * len(self.buckets)
        self.count = 0
        self.sum = 0.0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            i = min(bisect.bisect_left(self.buckets, v),
                    len(self.buckets) - 1)
            self.counts[i] += 1
            self.count += 1
            self.sum += v


class Registry:
    def __init__(self):
        self._metrics: Dict[Tuple[str, str], object] = {}
        self._lock = threading.Lock()

    def _get(self, kind: str, name: str, factory):
        with self._lock:
            m = self._metrics.get((kind, name))
            if m is None:
                m = self._metrics[(kind, name)] = factory()
            return m

    def counter(self, name: str) -> Counter:
        return self._get("counter", name, Counter)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get("gauge", name, Gauge)

    def histogram(self, name: str,
                  buckets: Sequence[float] = _DEFAULT_BUCKETS) -> Histogram:
        return self._get("histogram", name, lambda: Histogram(buckets))


class Span:
    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.start_s = 0.0
        self.duration_s: Optional[float] = None


class SpanTracer:
    """Records finished spans and events (newest ``capacity`` kept)."""

    def __init__(self, capacity: int = 4096):
        self.records: Deque[dict] = deque(maxlen=capacity)

    def span(self, name: str, **attrs) -> "_SpanContext":
        return _SpanContext(self, Span(name, attrs))

    def event(self, name: str, **attrs) -> None:
        self.records.append({"event": name, "t": time.monotonic(),
                             **attrs})


class _SpanContext:
    def __init__(self, tracer: SpanTracer, span: Span):
        self.tracer = tracer
        self.span = span

    def __enter__(self) -> Span:
        self.span.start_s = time.monotonic()
        return self.span

    def __exit__(self, *exc) -> None:
        sp = self.span
        sp.duration_s = time.monotonic() - sp.start_s
        self.tracer.records.append({"span": sp.name, "t": sp.start_s,
                                    "duration_s": sp.duration_s,
                                    **sp.attrs})


_REGISTRY = Registry()
_TRACER = SpanTracer()


def metrics() -> Registry:
    return _REGISTRY


def tracer() -> SpanTracer:
    return _TRACER


def set_tracer(t: SpanTracer) -> None:
    global _TRACER
    _TRACER = t


def record_counter(name: str, amount: float = 1.0, **labels) -> None:
    """Bump the named counter of the global registry."""
    metrics().counter(name).inc(amount, **labels)


# ---------------------------------------------------------------------------
# telemetry knobs (copies of deeplearning4j_tpu/monitor/__init__.py)
# ---------------------------------------------------------------------------
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
