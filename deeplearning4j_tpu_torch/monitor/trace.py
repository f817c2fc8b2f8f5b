"""Span tracer: timestamped, nested spans over the training control plane.

The fused pipeline's failure mode is a TIMELINE problem: a wedged device
grant or a stalled chunk leaves a bare error line with no
record of what the host was doing or for how long. Spans fix that: every
interesting host-side operation — chunk dispatch, sentinel readback, cache
build, checkpoint save/verify, backend/grant acquisition, retry sleeps —
runs inside ``tracer().span(name, **attrs)``; the tracer keeps a bounded
ring of finished spans with monotonic start/end timestamps and parent ids
(a thread-local stack provides the nesting), and exporters turn the ring
into a JSONL event log or the summary block embedded in bench artifacts.

The clock is injectable (tests drive a fake), span recording is a deque
append under a lock (no I/O on the hot path — a ``sink`` callback, when
configured, forwards each finished span to the JSONL exporter), and a
tracer with no sink and no reader costs two clock reads per span.
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager
from collections import deque
from typing import Callable, Dict, List, Optional

__all__ = ["Span", "SpanTracer", "tracer", "set_tracer"]

DEFAULT_CAPACITY = 4096


class Span:
    """One finished (or in-flight) operation: ``[start_s, end_s]`` on the
    tracer's monotonic clock, a ``parent_id`` giving the nesting, and
    free-form ``attrs``."""

    __slots__ = ("name", "span_id", "parent_id", "start_s", "end_s",
                 "attrs")

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 start_s: float, attrs: Dict):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_s = start_s
        self.end_s: Optional[float] = None
        self.attrs = attrs

    @property
    def duration_s(self) -> float:
        return 0.0 if self.end_s is None else self.end_s - self.start_s

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_s": round(self.start_s, 6),
            "end_s": None if self.end_s is None else round(self.end_s, 6),
            "duration_s": round(self.duration_s, 6),
            "attrs": self.attrs,
        }

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.span_id}, "
                f"parent={self.parent_id}, dur={self.duration_s:.6f}s)")


class SpanTracer:
    """Bounded ring of finished spans + a thread-local open-span stack.

    - ``span(name, **attrs)`` — context manager; yields the live
      :class:`Span` so callers can add attrs discovered mid-operation.
      An exception inside the body stamps ``attrs["error"]`` before the
      span closes (the timeline records WHAT failed, not just that
      something did).
    - ``event(name, **attrs)`` — zero-duration span, recorded
      immediately (watchdog fired, preemption latched).
    - ``clock`` is injectable; ``sink(span_dict)`` forwards each
      finished span (the JSONL exporter wires in here).
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 capacity: int = DEFAULT_CAPACITY,
                 sink: Optional[Callable[[dict], None]] = None):
        self._clock = clock
        self._sink = sink
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._local = threading.local()

    # ------------------------------------------------------------------
    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def current(self) -> Optional[Span]:
        st = self._stack()
        return st[-1] if st else None

    def _record(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)
        if self._sink is not None:
            try:
                self._sink(span.to_dict())
            except Exception:
                # the sink is best-effort I/O; a full disk must not turn
                # into a training failure
                pass
        # the flight recorder (when enabled) gets every finished span —
        # the postmortem timeline a crash is reconstructed from.
        # (import from the submodule: the package re-exports a `flight`
        # FUNCTION that shadows the module attribute of the same name)
        try:
            from deeplearning4j_tpu_torch.monitor.flight import (
                flight as _active_flight)

            rec = _active_flight()
            if rec is not None:
                rec.record_span(span.to_dict())
        except Exception:
            pass

    # ------------------------------------------------------------------
    @contextmanager
    def span(self, name: str, **attrs):
        parent = self.current()
        sp = Span(name, next(self._ids),
                  None if parent is None else parent.span_id,
                  self._clock(), attrs)
        stack = self._stack()
        stack.append(sp)
        try:
            yield sp
        except BaseException as e:
            sp.attrs.setdefault("error", f"{type(e).__name__}: {e}"[:200])
            raise
        finally:
            sp.end_s = self._clock()
            if stack and stack[-1] is sp:
                stack.pop()
            else:  # defensive: unbalanced exit must not corrupt nesting
                try:
                    stack.remove(sp)
                except ValueError:
                    pass
            self._record(sp)

    def event(self, name: str, **attrs) -> Span:
        now = self._clock()
        parent = self.current()
        sp = Span(name, next(self._ids),
                  None if parent is None else parent.span_id, now, attrs)
        sp.end_s = now
        self._record(sp)
        return sp

    # ------------------------------------------------------------------
    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def summary(self, recent: int = 40) -> dict:
        """Aggregate view for artifact embedding: per span name count /
        total / max seconds, plus the ``recent`` newest span dicts — the
        timeline a wedged run is diagnosed from."""
        spans = self.spans()
        agg: Dict[str, dict] = {}
        for sp in spans:
            a = agg.setdefault(sp.name,
                               {"count": 0, "total_s": 0.0, "max_s": 0.0})
            a["count"] += 1
            a["total_s"] += sp.duration_s
            a["max_s"] = max(a["max_s"], sp.duration_s)
        for a in agg.values():
            a["total_s"] = round(a["total_s"], 6)
            a["max_s"] = round(a["max_s"], 6)
        return {
            "n_spans": len(spans),
            "by_name": agg,
            "recent": [sp.to_dict() for sp in spans[-recent:]],
        }


_TRACER: Optional[SpanTracer] = None
_TRACER_LOCK = threading.Lock()


def tracer() -> SpanTracer:
    """The process-global tracer. First use wires the JSONL sink when
    ``DL4J_TELEMETRY_DIR`` is set (see ``monitor.exporters``)."""
    global _TRACER
    if _TRACER is None:
        with _TRACER_LOCK:
            if _TRACER is None:
                from deeplearning4j_tpu_torch.monitor import exporters

                _TRACER = SpanTracer(sink=exporters.span_sink_from_env())
    return _TRACER


def set_tracer(t: Optional[SpanTracer]) -> None:
    """Swap the global tracer (tests install fakes; ``None`` re-derives
    from the environment on next use)."""
    global _TRACER
    with _TRACER_LOCK:
        _TRACER = t
