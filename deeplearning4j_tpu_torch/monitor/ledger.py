"""RunLedger: classify every wall-clock second of a training run.

The metrics pack makes a *step* observable and ProgramProfile a
*program*; nothing accounts for a *run*: no artifact says what
fraction of a ``fit_epochs`` / ``FaultTolerantTrainer`` run's wall time
was spent actually training versus building caches, backing off retries,
writing checkpoints, stalled behind a hung dispatch, or waiting on a
device grant. Large-scale systems treat that goodput/badput ledger as
first-class infrastructure; this module is ours.

The ledger consumes the EXISTING span taxonomy (it adds no new hot-path
instrumentation): the chunk driver marks run/chunk boundaries
(``ledger_run_start`` / ``ledger_chunk_start`` / ``ledger_chunk_done`` /
``ledger_run_end`` — chunk-boundary-only, dl4j-lint-enforced), and
``report()`` sweeps the tracer's span ring, classifying wall time into
states by priority:

| state | source spans/marks |
|---|---|
| ``compute`` | inside a run window (dispatch + device execution), unless overridden below |
| ``cache_build`` | ``cache.build`` |
| ``checkpoint`` | ``checkpoint.write``/``verify``/``snapshot`` — EXCEPT background writes (``attrs.background``), which overlap compute and are reported separately as ``hidden_checkpoint_s`` |
| ``retry_backoff`` | ``retry.sleep`` |
| ``watchdog_stall`` | ``watchdog.stall`` events (interval re-derived from ``stalled_s``) |
| ``preemption_recovery`` | ``checkpoint.resume`` |
| ``reshard`` | ``reshard.elastic`` — the chunk-boundary device snapshot → respec → continue of a mid-run mesh grow/shrink |
| ``grant_wait`` | ``grant.probe`` / ``grant.acquire`` / ``grant.reacquire`` / ``grant.backoff`` / ``grant.subprocess`` — including every lease re-acquire cycle, so a rescued wedge is booked as grant badput instead of a lost round |
| ``idle`` | outside any run window and any classified span |

Goodput % is ``compute / (window − idle)``; the badput breakdown is the
rest. Everything is host-side arithmetic over the bounded span ring —
free at the <3% overhead bar; ``telemetry_summary()`` embeds the report
in every bench artifact.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "RunLedger",
    "ledger_chunk_done",
    "ledger_chunk_start",
    "ledger_run_end",
    "ledger_run_start",
    "run_ledger",
    "set_run_ledger",
]

GOODPUT_STATE = "compute"
IDLE_STATE = "idle"

#: span name -> badput state (spans that BLOCK the training thread)
BADPUT_SPAN_STATES = {
    "cache.build": "cache_build",
    "checkpoint.write": "checkpoint",
    "checkpoint.verify": "checkpoint",
    "checkpoint.snapshot": "checkpoint",
    "checkpoint.resume": "preemption_recovery",
    "retry.sleep": "retry_backoff",
    "reshard.elastic": "reshard",
    "grant.probe": "grant_wait",
    "grant.acquire": "grant_wait",
    "grant.reacquire": "grant_wait",
    "grant.backoff": "grant_wait",
    "grant.subprocess": "grant_wait",
}

#: overlap resolution: a second covered by several intervals takes the
#: highest-priority state (a stalled chunk is a stall, not compute)
STATE_PRIORITY = {
    IDLE_STATE: 0,
    GOODPUT_STATE: 1,
    "cache_build": 2,
    "checkpoint": 3,
    "reshard": 4,
    "retry_backoff": 5,
    "watchdog_stall": 6,
    "preemption_recovery": 7,
    "grant_wait": 8,
}

BADPUT_STATES = tuple(s for s in STATE_PRIORITY
                      if s not in (IDLE_STATE, GOODPUT_STATE))


def _sweep(intervals: List[Tuple[float, float, str]],
           t0: float, t1: float) -> Dict[str, float]:
    """Elementary-segment sweep: per-state seconds over ``[t0, t1]``
    with priority overlap resolution. O(n log n) in interval count."""
    totals = {s: 0.0 for s in STATE_PRIORITY}
    if t1 <= t0:
        return totals
    events: List[Tuple[float, int, str]] = []
    for start, end, state in intervals:
        start, end = max(start, t0), min(end, t1)
        if end > start:
            events.append((start, 1, state))
            events.append((end, -1, state))
    if not events:
        totals[IDLE_STATE] = t1 - t0
        return totals
    events.sort(key=lambda e: e[0])
    active = {s: 0 for s in STATE_PRIORITY}
    prev = t0
    i = 0
    while i < len(events):
        t = events[i][0]
        if t > prev:
            state = IDLE_STATE
            best = -1
            for s, n in active.items():
                if n > 0 and STATE_PRIORITY[s] > best:
                    best = STATE_PRIORITY[s]
                    state = s
            totals[state] += t - prev
            prev = t
        while i < len(events) and events[i][0] == t:
            _, delta, s = events[i]
            active[s] += delta
            i += 1
    if t1 > prev:
        state = IDLE_STATE
        best = -1
        for s, n in active.items():
            if n > 0 and STATE_PRIORITY[s] > best:
                best = STATE_PRIORITY[s]
                state = s
        totals[state] += t1 - prev
    return totals


class RunLedger:
    """Run/chunk boundary marks + span-ring classification.

    The chunk driver calls :meth:`run_start` / :meth:`chunk_start` /
    :meth:`chunk_done` / :meth:`run_end` (all O(1) dict work — nothing
    here belongs anywhere near a fused dispatch except at chunk
    boundaries); :meth:`report` does the wall-time sweep on demand.
    ``clock`` must be the same monotonic clock the span tracer uses so
    intervals line up (both default to ``time.monotonic``).
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 span_source: Optional[Callable[[], list]] = None,
                 keep_runs: int = 8):
        self._clock = clock
        self._span_source = span_source
        self._keep = max(1, keep_runs)
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._t0 = self._clock()
            self._runs: List[dict] = []
            self._active: Optional[dict] = None
            self._chunk_t0: Optional[float] = None
            self._n_runs = 0

    # -- boundary marks (chunk-boundary-only on training paths) ---------
    def run_start(self, **attrs) -> None:
        with self._lock:
            self._active = {"start_s": self._clock(), "end_s": None,
                            "status": None, "chunks": 0,
                            "dispatch_s": 0.0, "attrs": dict(attrs)}

    def chunk_start(self, **attrs) -> None:
        with self._lock:
            self._chunk_t0 = self._clock()

    def chunk_done(self, **attrs) -> None:
        with self._lock:
            now = self._clock()
            if self._active is not None:
                self._active["chunks"] += 1
                if self._chunk_t0 is not None:
                    self._active["dispatch_s"] += now - self._chunk_t0
            self._chunk_t0 = None

    def run_end(self, status: str = "clean", **attrs) -> Optional[dict]:
        """Close the active run and cache its classified report (one
        span-ring sweep per run — the cheap read the fleet heartbeat
        payload uses). Returns the per-run report, or None if no run was
        open."""
        with self._lock:
            run = self._active
            self._active = None
            if run is None:
                return None
            run["end_s"] = self._clock()
            run["status"] = status
            run["attrs"].update(attrs)
        run["report"] = self._classify(run["start_s"], run["end_s"],
                                       runs=[run])
        with self._lock:
            self._runs.append(run)
            self._n_runs += 1
            del self._runs[:-self._keep]
        return run["report"]

    # -- reads -----------------------------------------------------------
    def last_run_goodput(self) -> Optional[float]:
        """Goodput percentage of the most recently finished run (cached
        at ``run_end`` — no sweep)."""
        with self._lock:
            if not self._runs:
                return None
            return self._runs[-1]["report"]["goodput_pct"]

    def _spans(self, spans: Optional[list] = None) -> list:
        if spans is not None:
            return spans
        if self._span_source is not None:
            return self._span_source()
        from deeplearning4j_tpu_torch.monitor.trace import tracer

        return tracer().spans()

    def _classify(self, t0: float, t1: float,
                  runs: Optional[List[dict]] = None,
                  spans: Optional[list] = None) -> dict:
        if runs is None:
            with self._lock:
                runs = list(self._runs)
                if self._active is not None:
                    runs.append(dict(self._active))
        intervals: List[Tuple[float, float, str]] = []
        for run in runs:
            intervals.append((run["start_s"],
                              t1 if run["end_s"] is None else run["end_s"],
                              GOODPUT_STATE))
        hidden_ckpt = 0.0
        for sp in self._spans(spans):
            end = t1 if sp.end_s is None else sp.end_s
            state = BADPUT_SPAN_STATES.get(sp.name)
            if state == "checkpoint" and sp.attrs.get("background"):
                # a background write overlaps compute by design — it is
                # hidden, not badput, but the postmortem wants to know
                hidden_ckpt += max(0.0, min(end, t1)
                                   - max(sp.start_s, t0))
                continue
            if state is not None:
                intervals.append((sp.start_s, end, state))
            elif sp.name == "watchdog.stall":
                stalled = float(sp.attrs.get("stalled_s", 0.0))
                if stalled > 0:
                    intervals.append((end - stalled, end,
                                      "watchdog_stall"))
        totals = _sweep(intervals, t0, t1)
        window = t1 - t0
        accounted = window - totals[IDLE_STATE]
        goodput = (100.0 * totals[GOODPUT_STATE] / accounted
                   if accounted > 0 else None)
        return {
            "window_s": round(window, 6),
            "goodput_pct": None if goodput is None else round(goodput, 2),
            "states": {s: round(v, 6) for s, v in totals.items()},
            "badput": {s: round(totals[s], 6) for s in BADPUT_STATES
                       if totals[s] > 0},
            "hidden_checkpoint_s": round(hidden_ckpt, 6),
        }

    def report(self, spans: Optional[list] = None) -> dict:
        """The JSON-ready ledger block ``telemetry_summary()`` embeds:
        whole-window classification plus the per-run detail (last
        ``keep_runs`` runs, each with its own goodput and badput
        breakdown)."""
        now = self._clock()
        out = self._classify(self._t0, now, spans=spans)
        with self._lock:
            runs = list(self._runs)
            active = self._active
            n_runs = self._n_runs
        out["n_runs"] = n_runs
        out["run_in_flight"] = active is not None
        out["runs"] = [{
            "status": r["status"],
            "wall_s": round(r["end_s"] - r["start_s"], 6),
            "chunks": r["chunks"],
            "host_dispatch_s": round(r["dispatch_s"], 6),
            "goodput_pct": r["report"]["goodput_pct"],
            "badput": r["report"]["badput"],
            **{k: v for k, v in r["attrs"].items()
               if isinstance(v, (str, int, float, bool))},
        } for r in runs]
        return out


_LEDGER: Optional[RunLedger] = None
_LEDGER_LOCK = threading.Lock()


def run_ledger() -> RunLedger:
    """The process-global ledger (window starts at first use)."""
    global _LEDGER
    if _LEDGER is None:
        with _LEDGER_LOCK:
            if _LEDGER is None:
                _LEDGER = RunLedger()
    return _LEDGER


def set_run_ledger(ledger: Optional[RunLedger]) -> None:
    """Swap the global ledger (tests install fakes; ``None`` re-creates
    fresh on next use)."""
    global _LEDGER
    with _LEDGER_LOCK:
        _LEDGER = ledger


# ---------------------------------------------------------------------------
# the chunk-boundary helpers drive_epoch_chunks calls (and dl4j-lint
# keeps OUT of traced programs — see LEDGER_FLIGHT_CALLS in
# analysis/rules.py)
# ---------------------------------------------------------------------------


def _flight(kind: str, **payload) -> None:
    from deeplearning4j_tpu_torch.monitor.flight import flight_record

    flight_record(kind, **payload)


def ledger_run_start(**attrs) -> None:
    run_ledger().run_start(**attrs)
    _flight("run.start", **attrs)


def ledger_chunk_start(**attrs) -> None:
    run_ledger().chunk_start(**attrs)
    _flight("chunk.launch", **attrs)


def ledger_chunk_done(**attrs) -> None:
    run_ledger().chunk_done(**attrs)
    _flight("chunk.done", **attrs)


def ledger_run_end(status: str = "clean", **attrs) -> None:
    rep = run_ledger().run_end(status=status, **attrs)
    _flight("run.end", status=status,
            goodput_pct=None if rep is None else rep["goodput_pct"],
            **attrs)
