"""Open-loop Poisson load generator + latency report for the serve bench
(port of ``deeplearning4j_tpu/serving/loadgen.py``; the fleet's driver,
``serving/fleet/driver.py``, fills the same report with its retry and
hedge accounting; the schedule is numpy-seeded, so both packages replay
the same stream).

Open loop means arrivals come from a schedule, not from completions —
the load a server actually faces (users do not wait for each other), and
the one that exposes queueing collapse. A closed loop would hide an
under-provisioned server behind its own backpressure.

The schedule is generated up front (deterministic in the seed) so the
same stream can replay against different server configs; the loop
submits every arrival whose time has come, steps the server, and sleeps
only when idle with arrivals still pending. Clock and sleep are
injectable: tests drive a fake clock, the bench uses wall time.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np

__all__ = ["Arrival", "poisson_schedule", "run_open_loop", "LoadReport"]


@dataclass
class Arrival:
    arrival_s: float
    prompt: np.ndarray
    max_new_tokens: int
    seed: int
    # RELATIVE deadline budget (seconds from arrival); the loop
    # converts to the absolute instant at submit. None = no deadline.
    deadline_s: Optional[float] = None
    criticality: str = "interactive"


def poisson_schedule(n_requests: int, rate_rps: float, *,
                     vocab_size: int,
                     prompt_lens: Sequence[int] = (8, 16, 24, 48),
                     max_new_tokens: Sequence[int] = (4, 8, 16),
                     criticality_mix: Optional[dict] = None,
                     deadlines_s: Optional[dict] = None,
                     seed: int = 0) -> List[Arrival]:
    """Ragged request stream: exponential interarrivals at ``rate_rps``,
    prompt lengths / generation lengths drawn uniformly from the given
    menus (several ladder rungs on purpose — the compile-flatness claim
    is only interesting under shape raggedness).

    ``criticality_mix`` maps class -> weight (e.g. ``{"interactive":
    0.3, "batch": 0.7}``; default all-interactive) and ``deadlines_s``
    maps class -> RELATIVE deadline budget (classes absent get none) —
    together they shape the overload-storm workloads the serve-SLO soak
    drives."""
    if n_requests < 1 or rate_rps <= 0:
        raise ValueError("need n_requests >= 1 and rate_rps > 0")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, n_requests)
    arrivals = np.cumsum(gaps)
    classes, weights = None, None
    if criticality_mix:
        classes = list(criticality_mix)
        total = float(sum(criticality_mix.values()))
        weights = [criticality_mix[c] / total for c in classes]
    deadlines_s = deadlines_s or {}
    out = []
    for i in range(n_requests):
        plen = int(rng.choice(prompt_lens))
        crit = (str(rng.choice(classes, p=weights))
                if classes else "interactive")
        out.append(Arrival(
            arrival_s=float(arrivals[i]),
            prompt=rng.integers(0, vocab_size, plen, dtype=np.int32),
            max_new_tokens=int(rng.choice(max_new_tokens)),
            seed=int(rng.integers(0, 2**31 - 1)),
            deadline_s=deadlines_s.get(crit),
            criticality=crit))
    return out


@dataclass
class LoadReport:
    """Aggregated open-loop run: per-request latency/TTFT/TPOT samples
    plus the stream-level occupancy trace."""

    latencies_s: List[float] = field(default_factory=list)
    ttfts_s: List[float] = field(default_factory=list)
    tpots_s: List[float] = field(default_factory=list)
    occupancy: List[float] = field(default_factory=list)
    # per-drop timestamps (seconds since stream start): shows WHEN
    # capacity ran out, not just how often
    drop_times_s: List[float] = field(default_factory=list)
    submitted: int = 0
    rejected: int = 0
    finished: int = 0
    tokens: int = 0
    wall_s: float = 0.0
    # overload-control accounting: sheds (admitted then dropped by
    # deadline/displacement — distinct from rejected-at-admission),
    # split by class and by where the deadline caught them, plus
    # per-class submission/completion/TTFT splits so the SLO gate can
    # assert "interactive held while batch absorbed the storm"
    shed: int = 0
    shed_by_class: dict = field(default_factory=dict)
    expired_in_queue: int = 0
    expired_in_flight: int = 0
    submitted_by_class: dict = field(default_factory=dict)
    finished_by_class: dict = field(default_factory=dict)
    ttfts_by_class: dict = field(default_factory=dict)
    # retry-amplification evidence (the fleet driver's): total placements
    # (first and re-dispatch) and hedges across the run
    placements: int = 0
    hedges: int = 0

    @staticmethod
    def _pct(xs: List[float], q: float) -> Optional[float]:
        return float(np.percentile(xs, q)) if xs else None

    def summary(self) -> dict:
        """The bench's ``serve`` section fields (ms where latency)."""
        ms = 1e3
        wall = self.wall_s or float("nan")
        return {
            "submitted": self.submitted,
            "rejected": self.rejected,
            "finished": self.finished,
            "tokens": self.tokens,
            "wall_s": round(self.wall_s, 3),
            "requests_per_sec": round(self.finished / wall, 2),
            "tokens_per_sec": round(self.tokens / wall, 1),
            "p50_latency_ms": _r(self._pct(self.latencies_s, 50), ms),
            "p99_latency_ms": _r(self._pct(self.latencies_s, 99), ms),
            "ttft_p50_ms": _r(self._pct(self.ttfts_s, 50), ms),
            "ttft_p99_ms": _r(self._pct(self.ttfts_s, 99), ms),
            "tpot_mean_ms": _r(float(np.mean(self.tpots_s))
                               if self.tpots_s else None, ms),
            "occupancy_mean": (round(float(np.mean(self.occupancy)), 3)
                               if self.occupancy else None),
            # shed load, accounted in time: the sorted drop timestamps
            "dropped_request_seconds": [round(t, 3)
                                        for t in sorted(self.drop_times_s)],
            "shed": self.shed,
            "shed_by_class": dict(self.shed_by_class),
            "expired_in_queue": self.expired_in_queue,
            "expired_in_flight": self.expired_in_flight,
            "submitted_by_class": dict(self.submitted_by_class),
            "finished_by_class": dict(self.finished_by_class),
            "ttft_p50_ms_by_class": {
                c: _r(self._pct(xs, 50), ms)
                for c, xs in self.ttfts_by_class.items()},
            # placements + hedges over submissions: the amplification
            # the retry budget bounds (1.0 = no retries at all)
            "retry_amplification": (
                round((self.placements + self.hedges)
                      / self.submitted, 3)
                if self.submitted else None),
        }


def _r(v: Optional[float], scale: float) -> Optional[float]:
    return None if v is None else round(v * scale, 3)


def run_open_loop(server, schedule: List[Arrival], *,
                  clock: Optional[Callable[[], float]] = None,
                  sleep: Optional[Callable[[float], None]] = None,
                  idle_wait_s: float = 0.001) -> LoadReport:
    """Drive ``server`` through ``schedule`` open-loop. Rejected submits
    (queue full) are counted, not retried — open loop drops, it does not
    secretly become closed loop. Runs until every arrival was offered
    and the server drained."""
    clock = clock or time.monotonic
    sleep = sleep or time.sleep
    # the ranks of a tensor-parallel server step together: each takes
    # rank 0's view of which arrivals are due and whether to go on
    agree = getattr(server, "agree", lambda value: value)
    report = LoadReport()
    t0 = clock()
    i = 0
    reqs = []
    while True:
        now = clock() - t0
        due = i
        while due < len(schedule) and schedule[due].arrival_s <= now:
            due += 1
        due, go = agree((due, i < len(schedule) or server.busy()))
        if not go:
            break
        while i < due:
            a = schedule[i]
            i += 1
            # the arrival's deadline is a budget from NOW; the server
            # wants the absolute instant on ITS clock axis (the same
            # injected clock, before the t0 re-base)
            deadline = (None if a.deadline_s is None
                        else clock() + a.deadline_s)
            verdict = server.try_submit(a.prompt, a.max_new_tokens,
                                        seed=a.seed, deadline_s=deadline,
                                        criticality=a.criticality)
            req = verdict.request
            if verdict.admitted:
                report.submitted += 1
                report.submitted_by_class[a.criticality] = (
                    report.submitted_by_class.get(a.criticality, 0) + 1)
                reqs.append(req)
            else:
                # open loop drops, it does not retry — but it records
                # WHEN it dropped, so shed load is visible in time
                report.rejected += 1
                report.drop_times_s.append(now)
        progressed = server.step()
        report.occupancy.append(server.occupancy())
        if not progressed and i < len(schedule):
            # idle with arrivals pending: wait out the gap
            gap = schedule[i].arrival_s - (clock() - t0)
            if gap > 0:
                sleep(min(gap, 0.05) if gap > idle_wait_s else idle_wait_s)
    report.wall_s = clock() - t0
    for req in reqs:
        if req.state == "shed":
            # admitted, then dropped by deadline or displacement: the
            # shed instant joins the drop series (t0-relative)
            report.shed += 1
            report.shed_by_class[req.criticality] = (
                report.shed_by_class.get(req.criticality, 0) + 1)
            if req.finish_s is not None:
                report.drop_times_s.append(req.finish_s - t0)
            continue
        if req.state != "finished":
            continue
        report.finished += 1
        report.finished_by_class[req.criticality] = (
            report.finished_by_class.get(req.criticality, 0) + 1)
        report.tokens += len(req.tokens)
        if req.latency_s is not None:
            report.latencies_s.append(req.latency_s)
        if req.ttft_s is not None:
            report.ttfts_s.append(req.ttft_s)
            report.ttfts_by_class.setdefault(
                req.criticality, []).append(req.ttft_s)
        if req.first_token_s is not None and req.finish_s is not None \
                and len(req.tokens) > 1:
            report.tpots_s.append((req.finish_s - req.first_token_s)
                                  / (len(req.tokens) - 1))
    s = server.stats()
    report.expired_in_queue = s["expired_in_queue"]
    report.expired_in_flight = s["expired_in_flight"]
    return report
