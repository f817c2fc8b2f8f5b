"""StepWatchdog: flag hung training steps.

Copy of ``deeplearning4j_tpu/resilience/watchdog.py``, which imports no
JAX; the port keeps its own so that it imports nothing of that package.

GSPMD-style multi-host SPMD makes one hung host everyone's problem — the
collective blocks the whole pod, and nothing crashes, so nothing restarts.
The watchdog is the liveness complement to ``HeartbeatMonitor``: the
training loop calls :meth:`StepWatchdog.beat` after every step; a
background thread (same shape as HeartbeatMonitor's) fires ``on_stall``
when no beat lands within ``deadline_s``. The callback decides the policy
— log, evict via the tracker, or abort the process.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

logger = logging.getLogger(__name__)

__all__ = ["StepWatchdog"]


def _log_stall(stalled_s: float) -> None:
    logger.warning("training step hung: no progress for %.1fs", stalled_s)


class StepWatchdog:
    """Fire ``on_stall(stalled_seconds)`` when no :meth:`beat` arrives
    within ``deadline_s``.

    ``on_stall`` fires once per stall episode (re-armed by the next beat),
    so a log-only callback does not spam while a long step compiles —
    except with ``repeat_every_s`` set, which re-fires that often during
    one continuing stall (escalation policies).

    Context-manager protocol starts/stops the thread; ``beats`` and
    ``stalls`` counters are exposed for tests and metrics.
    """

    def __init__(self, deadline_s: float,
                 on_stall: Optional[Callable[[float], None]] = None,
                 poll_s: Optional[float] = None,
                 repeat_every_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        self.deadline_s = deadline_s
        self.on_stall = on_stall or _log_stall
        self.poll_s = poll_s if poll_s is not None else min(deadline_s / 4,
                                                            1.0)
        self.repeat_every_s = repeat_every_s
        self._clock = clock
        self._lock = threading.Lock()
        self._last_beat = clock()
        self._thread: Optional[threading.Thread] = None
        self._stop: Optional[threading.Event] = None
        self.beats = 0
        self.stalls = 0

    # ------------------------------------------------------------------
    def beat(self) -> None:
        """Record progress; re-arms the stall trigger."""
        with self._lock:
            self._last_beat = self._clock()
            self.beats += 1

    def stalled_for(self) -> float:
        with self._lock:
            return self._clock() - self._last_beat

    def set_deadline(self, deadline_s: float) -> None:
        """Rescale the stall deadline mid-run (and re-arm the trigger).
        The chunk driver calls this after an elastic reshard changes the
        per-chunk step count / device width — a legitimate post-shrink
        chunk must not be flagged against the old, wider mesh's budget."""
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        with self._lock:
            self.deadline_s = deadline_s
            self._last_beat = self._clock()

    # ------------------------------------------------------------------
    def start(self) -> "StepWatchdog":
        if self._thread is not None:
            return self
        stop = threading.Event()
        self._stop = stop
        self.beat()  # the clock starts now, not at construction

        def run():
            fired_at: Optional[float] = None  # beat timestamp last fired on
            last_fire = 0.0
            while not stop.wait(self.poll_s):
                with self._lock:
                    last = self._last_beat
                    stalled = self._clock() - last
                if stalled < self.deadline_s:
                    fired_at = None
                    continue
                refire = (self.repeat_every_s is not None
                          and self._clock() - last_fire
                          >= self.repeat_every_s)
                if fired_at == last and not refire:
                    continue  # already flagged this stall episode
                fired_at = last
                last_fire = self._clock()
                self.stalls += 1
                try:
                    # telemetry first: even an on_stall that aborts the
                    # process leaves the stall on the timeline
                    from deeplearning4j_tpu_torch.monitor import (
                        record_counter, tracer)

                    record_counter("watchdog_stalls_total")
                    tracer().event("watchdog.stall",
                                   stalled_s=round(stalled, 3),
                                   deadline_s=self.deadline_s)
                    self.on_stall(stalled)
                except Exception:  # noqa: BLE001 — callback must not
                    logger.exception("StepWatchdog on_stall raised")

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="step-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        thread, stop = self._thread, self._stop
        if thread is None:
            return  # idempotent, same contract as HeartbeatMonitor.stop
        self._thread = None
        stop.set()
        thread.join(timeout=self.poll_s + 1.0)

    def __enter__(self) -> "StepWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
