"""Fleet load driver: replay an arrival schedule on per-replica clocks.

Copy of ``deeplearning4j_tpu/serving/fleet/driver.py`` on the port's
modules.

The bench problem: an M-replica fleet deploys as M chips, but the bench
host has ONE backend — in-process replicas time-slice it, so measuring
fleet throughput on a single wall clock would show zero scaling no
matter how good the routing is (the host can only run one dispatch at a
time). The honest fix is the one discrete-event simulation has always
used: **book real measured costs on virtual per-replica timelines**.
Every replica step runs for real (its wall duration is measured), but
the duration lands on that replica's own clock — exactly how M chips
would overlap — and every request timestamp (submit/TTFT/finish) is
read off the virtual timeline. What the scaling number then measures is
the fleet layer itself: routing balance, queue spill, admission
batching, failover cost. What it deliberately does NOT measure is
host parallelism the bench machine doesn't have.

The same driver measures failover: kill a replica at a virtual time,
let the controller evict + requeue, and read the recovery off the
survivors' timelines.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.serving.fleet.controller import FleetController
from deeplearning4j_tpu_torch.serving.fleet.replica import ServeReplica
from deeplearning4j_tpu_torch.serving.fleet.router import FleetRouter
from deeplearning4j_tpu_torch.serving.loadgen import Arrival, LoadReport

__all__ = ["FleetLoadDriver"]


def _wall_step_timer(replica: ServeReplica) -> float:
    """Default step cost: the step's real wall duration."""
    t0 = time.perf_counter()
    replica.step_once()
    return time.perf_counter() - t0


class FleetLoadDriver:
    """Replays one :func:`poisson_schedule` against a routed fleet.

    ``step_timer(replica) -> seconds`` runs ONE replica step and
    returns its cost — injectable so tests can pin deterministic costs
    (the default measures real wall time). The driver owns every
    clock: it points each server/replica clock at that replica's
    virtual timeline and the router clock at the event frontier, so
    all recorded latencies are virtual-timeline consistent."""

    def __init__(self, router: FleetRouter,
                 controller: Optional[FleetController] = None, *,
                 step_timer=_wall_step_timer):
        self.router = router
        self.controller = controller
        self.step_timer = step_timer
        self._now = 0.0
        self.vt: Dict[str, float] = {
            r.replica_id: 0.0 for r in router.replicas}
        self.dispatch_log: List[tuple] = []   # (replica, t_start, cost)
        router.clock = lambda: self._now
        for r in router.replicas:
            rid = r.replica_id
            clock = (lambda rid=rid: self.vt[rid])
            r.clock = clock
            r.server.clock = clock
            # the replica's rate window was stamped from the wall clock
            # at construction; re-base it on the virtual timeline or
            # `elapsed` stays negative and tokens_per_sec reads 0
            r._rate_t0 = 0.0
            r._rate_tokens0 = r.server.decode_tokens
        if controller is not None:
            controller.clock = lambda: self._now

    # ------------------------------------------------------------------
    def busy_seconds(self) -> Dict[str, float]:
        """Per-replica time spent dispatching (the balance evidence).
        Seeded with EVERY replica at 0.0 — a replica routing starved
        entirely must show up as the imbalance it is, not vanish from
        the evidence."""
        out: Dict[str, float] = {
            r.replica_id: 0.0 for r in self.router.replicas}
        for rid, _, cost in self.dispatch_log:
            out[rid] += cost
        return out

    def run(self, schedule: List[Arrival], *,
            kill_at_s: Optional[float] = None,
            kill_replica: Optional[str] = None,
            drain_at_s: Optional[float] = None,
            drain_replica: Optional[str] = None,
            max_events: int = 2_000_000) -> LoadReport:
        """Drive the schedule to completion. With ``kill_at_s`` /
        ``kill_replica`` set, that replica dies at the first event past
        the virtual time and the controller (required then) evicts +
        fails over; ``drain_at_s`` / ``drain_replica`` instead retire
        the replica GRACEFULLY at that instant (quiesce + KV-slab
        migration, zero recompute). The report still covers every
        request. Returns the standard :class:`LoadReport` read off the
        virtual timelines."""
        for t_s, rid, what in ((kill_at_s, kill_replica, "kill"),
                               (drain_at_s, drain_replica, "drain")):
            if t_s is None:
                continue
            if self.controller is None:
                raise ValueError(f"{what}_at_s needs a controller")
            if rid not in self.router._by_id:
                raise ValueError(
                    f"{what}_replica={rid!r} is not in the fleet "
                    f"({sorted(self.router._by_id)})")
        report = LoadReport()
        i = 0
        killed = drained = False
        self.failover_done_s: Optional[float] = None
        self.kill_time_s: Optional[float] = None
        self.drain_time_s: Optional[float] = None
        self.drain_summary: Optional[dict] = None
        failover_victims: List = []
        for _ in range(max_events):
            alive = [r for r in self.router.replicas if r.alive]
            if self.router._pending:
                # parked failovers retry whenever a survivor may have
                # freed up (the controller tick does this in real-time
                # fleets; the driver IS the tick here) — placements
                # resume on the current frontier, not in a stale past
                if self.router.retry_pending():
                    for rr in alive:
                        if rr.busy():
                            self.vt[rr.replica_id] = max(
                                self.vt[rr.replica_id], self._now)
            busy = [r for r in alive if r.busy()]
            pending = self.router._pending
            if i >= len(schedule) and not busy and not pending:
                break
            # ---- next event: an arrival or a replica coming free
            events = []
            if i < len(schedule):
                events.append((schedule[i].arrival_s, 0, "arrive", None))
            for r in busy:
                events.append((self.vt[r.replica_id], 1, "step", r))
            if not events:
                break  # pending failovers with nowhere to go
            t, _, kind, r = min(events, key=lambda e: (e[0], e[1]))
            self._now = max(self._now, t)
            # ---- scheduled kill fires at the first event past its time
            if (not killed and kill_at_s is not None
                    and self._now >= kill_at_s):
                killed = True
                self.kill_time_s = self._now
                victim = self.router._by_id[kill_replica]
                failover_victims = [
                    fr for fr in self.router.requests
                    if fr.replica_id == kill_replica and not fr.finished]
                # evict() kills the victim itself (loop + beats down)
                self.controller.evict(
                    kill_replica, reason="bench-kill",
                    last_metrics=victim.heartbeat_payload())
                # requeued work starts no earlier than the kill instant
                for rr in self.router.replicas:
                    if rr.alive and rr.busy():
                        self.vt[rr.replica_id] = max(
                            self.vt[rr.replica_id], self._now)
                continue
            # ---- scheduled drain: graceful retire, mid-storm
            if (not drained and drain_at_s is not None
                    and self._now >= drain_at_s):
                drained = True
                self.drain_time_s = self._now
                # migrated streams continue no earlier than the later
                # of the drain instant and the victim's own frontier
                # (its already-booked steps produced those tokens)
                t_resume = max(self._now, self.vt[drain_replica])
                self.drain_summary = self.controller.drain(
                    drain_replica, reason="bench-drain")
                for rr in self.router.replicas:
                    if rr.alive and rr.busy():
                        self.vt[rr.replica_id] = max(
                            self.vt[rr.replica_id], t_resume)
                continue
            # hedging rides the driver loop the way it rides the
            # controller tick in real-time fleets
            if self.router.maybe_hedge():
                for rr in self.router.replicas:
                    if rr.alive and rr.busy():
                        self.vt[rr.replica_id] = max(
                            self.vt[rr.replica_id], self._now)
            if kind == "arrive":
                a = schedule[i]
                i += 1
                deadline = (None if a.deadline_s is None
                            else self._now + a.deadline_s)
                freq = self.router.try_submit(
                    a.prompt, a.max_new_tokens, seed=a.seed,
                    deadline_s=deadline, criticality=a.criticality)
                if freq is None:
                    report.rejected += 1
                    report.drop_times_s.append(self._now)
                else:
                    report.submitted += 1
                    report.submitted_by_class[a.criticality] = (
                        report.submitted_by_class.get(a.criticality, 0)
                        + 1)
                # whoever just went from idle to busy resumes its
                # timeline here, not in its past
                for rr in self.router.replicas:
                    if rr.alive and rr.busy():
                        self.vt[rr.replica_id] = max(
                            self.vt[rr.replica_id], self._now)
                continue
            # ---- one replica step, booked on its own timeline
            rid = r.replica_id
            was_busy = {rr.replica_id for rr in self.router.replicas
                        if rr.busy()}
            cost = self.step_timer(r)
            self.dispatch_log.append((rid, self.vt[rid], cost))
            self.vt[rid] += cost
            # work this step handed elsewhere (a prefill replica's slab
            # landing on a decode replica) cannot start before it was
            # produced: an idle receiver resumes its timeline here
            for rr in self.router.replicas:
                if (rr is not r and rr.alive and rr.busy()
                        and rr.replica_id not in was_busy):
                    self.vt[rr.replica_id] = max(
                        self.vt[rr.replica_id], self.vt[rid])
            if killed and self.failover_done_s is None \
                    and failover_victims \
                    and all(fr.finished for fr in failover_victims):
                self.failover_done_s = self.vt[rid]
        # ---- fold the fleet's request ledger into the report
        report.wall_s = max([self._now] + list(self.vt.values()))
        for fr in self.router.requests:
            report.placements += fr.attempts
            if fr.state == "shed":
                # admitted then shed (deadline or displacement): joins
                # the drop series at the instant the decision was made
                report.shed += 1
                report.shed_by_class[fr.criticality] = (
                    report.shed_by_class.get(fr.criticality, 0) + 1)
                if fr.finish_s is not None:
                    report.drop_times_s.append(fr.finish_s)
                continue
            if not fr.finished:
                continue
            report.finished += 1
            report.finished_by_class[fr.criticality] = (
                report.finished_by_class.get(fr.criticality, 0) + 1)
            report.tokens += len(fr.tokens)
            if fr.latency_s is not None:
                report.latencies_s.append(fr.latency_s)
            if fr.ttft_s is not None:
                report.ttfts_s.append(fr.ttft_s)
                report.ttfts_by_class.setdefault(
                    fr.criticality, []).append(fr.ttft_s)
            if fr.first_token_s is not None and fr.finish_s is not None \
                    and len(fr.tokens) > 1:
                report.tpots_s.append(
                    (fr.finish_s - fr.first_token_s)
                    / (len(fr.tokens) - 1))
        report.hedges = len(self.router.hedge_log)
        for r in self.router.replicas:
            s = r.server.stats()
            report.expired_in_queue += s.get("expired_in_queue", 0)
            report.expired_in_flight += s.get("expired_in_flight", 0)
        return report
