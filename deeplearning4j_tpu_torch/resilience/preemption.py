"""PreemptionGuard: turn SIGTERM (and injected preemptions) into a clean
chunk-boundary stop instead of a killed process.

TPU VMs and spot/preemptible instances get a termination signal with a
grace window; the reference's YARN story was "the container dies, the AM
restarts it". Under whole-epoch fusion the unit of lost work is an entire
E x N chunk, so the guard's job is: notice the request, let the in-flight
chunk finish, checkpoint (params + updater state + epoch RNG key +
epoch/step cursors — see ``FaultTolerantTrainer.save``/``save_async``),
and stop. ``resume()`` then re-derives the epoch permutation from the pure
``epoch_schedule`` key stream and continues exactly where the dead process
stopped — bitwise, because the per-chunk key splits are a pure function of
the restored RNG key.

Two trigger paths:

- **SIGTERM/SIGINT** — ``install()`` chains a handler that sets a flag
  (and re-raises KeyboardInterrupt semantics are NOT preserved: the guard
  is for orderly preemption, not ctrl-C debugging — pass ``signals=()``
  to opt out).
- **``fault_point("preempt.chunk")``** — every :meth:`check` polls the
  named fault site, so chaos tests (and ``DL4J_FAULTS``) inject a
  deterministic preemption at an exact chunk boundary:
  ``DL4J_FAULTS="preempt.chunk=fail_nth:2"`` preempts at the second
  boundary.

The guard is poll-based on purpose: a signal can land mid-dispatch,
and the only safe reaction point is the host decision point between
chunks.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Optional, Sequence

from deeplearning4j_tpu_torch.resilience import faults

logger = logging.getLogger(__name__)

__all__ = ["PreemptionGuard", "PREEMPT_CHUNK_SITE"]

PREEMPT_CHUNK_SITE = "preempt.chunk"


class PreemptionGuard:
    """Latches a preemption request from SIGTERM or the
    ``preempt.chunk`` fault site; callers poll :meth:`check` at chunk
    boundaries.

    Context-manager protocol installs/uninstalls the signal handlers;
    previous handlers are chained (a framework above us — e.g. a cluster
    launcher's own SIGTERM hook — still sees the signal)."""

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,)):
        self.signals = tuple(signals)
        self._requested = threading.Event()
        self._pending_latch = None
        self._prev = {}
        self._installed = False

    # ------------------------------------------------------------------
    def install(self) -> "PreemptionGuard":
        if self._installed:
            return self
        for sig in self.signals:
            try:
                self._prev[sig] = signal.signal(sig, self._on_signal)
            except ValueError:
                # signal.signal only works in the main thread; a guard
                # created on a worker thread degrades to fault-site +
                # request() triggering only
                logger.debug("PreemptionGuard: cannot install handler "
                             "for signal %s off the main thread", sig)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except ValueError:
                pass
        self._prev.clear()
        self._installed = False

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # ------------------------------------------------------------------
    def _on_signal(self, signum, frame) -> None:
        logger.warning("preemption signal %s received; will checkpoint "
                       "and stop at the next chunk boundary", signum)
        self._requested.set()
        # telemetry is NOT recorded here: the handler runs on the main
        # thread, and record_counter/tracer take non-reentrant locks the
        # interrupted frame may already hold — a latch must never
        # deadlock the preemption it reports. The next requested()/
        # check() poll (every chunk boundary) flushes it.
        # CPython delivers signal handlers on the main thread only, so
        # _pending_latch is main-thread-confined; a lock here could
        # deadlock the very frame the handler interrupted.
        self._pending_latch = (  # dl4j-lint: disable=lock-discipline -- signal handlers run on the main thread: no concurrent writer exists
            "signal", {"signum": signum})
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)

    def _flush_pending_latch(self) -> None:
        pending = self._pending_latch
        if pending is not None:
            self._pending_latch = None  # dl4j-lint: disable=lock-discipline -- main-thread-confined: the only other writer is the signal handler, which CPython delivers on this same thread
            _latch_telemetry(pending[0], **pending[1])

    def request(self) -> None:
        """Programmatic preemption (tests, cloud metadata watchers)."""
        self._requested.set()
        _latch_telemetry("request")

    def requested(self) -> bool:
        self._flush_pending_latch()
        return self._requested.is_set()

    def check(self) -> bool:
        """Poll both trigger paths; returns True once preemption has been
        requested. An injected fault at ``preempt.chunk`` counts as a
        request (the injection IS the preemption notice)."""
        self._flush_pending_latch()
        if not self._requested.is_set():
            try:
                faults.fault_point(PREEMPT_CHUNK_SITE)
            except Exception:  # noqa: BLE001 — any injected exception
                logger.warning("injected preemption at %s; will "
                               "checkpoint and stop at this chunk "
                               "boundary", PREEMPT_CHUNK_SITE)
                self._requested.set()
                _latch_telemetry("fault")
        return self._requested.is_set()


def _latch_telemetry(source: str, **attrs) -> None:
    """Count + timeline-stamp a preemption latch. Best-effort: it can run
    inside a signal handler, where telemetry must never raise."""
    try:
        from deeplearning4j_tpu_torch.monitor import record_counter, tracer

        record_counter("preemption_latches_total", source=source)
        tracer().event("preemption.latch", source=source, **attrs)
    except Exception:  # noqa: BLE001
        pass
