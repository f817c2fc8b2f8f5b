"""FleetController: the master tick for the serve fleet.

Copy of ``deeplearning4j_tpu/serving/fleet/controller.py`` on the port's
modules. With ``tracker=`` every tick reads the replicas' beat payloads
off the state tracker and evicts a replica silent past the timeout;
without one it reads the in-process replicas' payloads directly. The
goodput autopilot (``DL4J_AUTOPILOT``, ``autopilot=``) observes every
tick's payloads and straggler flags and evicts through the controller's
own evidence-logged ``evict``. The loop closes the way ``DistributedTrainer``'s master tick does
for training workers, on the heartbeat channel:

- **aggregate** — every tick reads each replica's newest beat payload
  and publishes the fleet gauges (``fleet_serve_replicas``, per-replica
  ``fleet_serve_occupancy`` / ``fleet_serve_queue_depth`` /
  ``fleet_serve_free_slots`` / ``fleet_serve_ttft_p50_s`` /
  ``fleet_serve_tokens_per_sec``).
- **flag stragglers** — a replica whose TPOT exceeds
  ``straggler_ratio`` x the fleet median (≥3 reporting) is flagged via
  the SAME outlier rule the training master uses
  (``parallel/workrouter.update_straggler_flags``), with the evidence
  on the timeline (``serve.straggler`` event).
- **evict + requeue** — a replica silent past ``DL4J_SERVE_EVICT_S``
  (wedged: beats stopped, nobody told us why) or one whose in-process
  loop died (crashed: the dead flag is honest local knowledge) is
  evicted with the decision's evidence — silence, timeout, last
  payload — appended to ``controller.eviction_log`` exactly like the
  training master's eviction log, its per-replica gauges dropped (a
  dead replica must stop reporting as current), and its unfinished
  requests requeued onto survivors through
  :meth:`FleetRouter.failover` (``serve.failover`` span). The
  correctness contract rides on deterministic prefill: a killed
  replica's requests complete token-identical to an unfailed run.
- **drain** — :meth:`FleetController.drain` is the PLANNED way out:
  quiesce admission, stop the step loop, migrate in-flight streams to
  survivors wholesale (KV slab + cursor + RNG via the handoff path —
  zero recompute, zero lost tokens), retire the replica. Eviction is
  for corpses; drain is for maintenance.

A fleet of tensor-parallel replicas (see ``router.py``) ticks in every
rank of their ``model`` group: rank 0's clock, heartbeat view and
autopilot decide the evictions, which every rank then carries out.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.monitor import metrics, record_counter, tracer
from deeplearning4j_tpu_torch.parallel.workrouter import update_straggler_flags
from deeplearning4j_tpu_torch.serving.fleet.router import FleetRouter
from deeplearning4j_tpu_torch.serving.scheduler import serve_evict_s

__all__ = ["FleetController"]

#: per-replica gauges the controller owns (published on tick, removed
#: on eviction so a dead replica stops reporting as current)
_REPLICA_GAUGES = {
    "fleet_serve_occupancy": "occupancy",
    "fleet_serve_queue_depth": "queue_depth",
    "fleet_serve_free_slots": "free_slots",
    "fleet_serve_ttft_p50_s": "ttft_p50",
    "fleet_serve_tokens_per_sec": "tokens_per_sec",
}


class FleetController:
    """Aggregate, flag, evict, requeue — one tick at a time."""

    def __init__(self, router: FleetRouter, tracker=None, *,
                 evict_timeout_s: Optional[float] = None,
                 straggler_ratio: float = 3.0,
                 clock=time.time, autopilot=None):
        self.router = router
        self.tracker = tracker
        self.evict_timeout_s = (evict_timeout_s
                                if evict_timeout_s is not None
                                else serve_evict_s())
        self.straggler_ratio = float(straggler_ratio)
        self.clock = clock
        self.stragglers: set = set()
        self.evicted: List[str] = []
        self.eviction_log: List[dict] = []
        self.drained: List[str] = []
        self.drain_log: List[dict] = []
        # tick-skip set: drained replicas join it too (retired is not
        # crashed, but neither reports as current)
        self._evicted_set: set = set()
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None
        self._reg = metrics()
        # the goodput autopilot rides the controller tick as it rides the
        # training master's: DL4J_AUTOPILOT=1 builds the default policy,
        # autopilot= passes one. Its evict actuator is the controller's
        # own evidence-logged evict: one eviction path whoever decided
        if autopilot is None:
            from deeplearning4j_tpu_torch.resilience.autopilot import (
                GoodputAutopilot, autopilot_enabled)

            if autopilot_enabled():
                autopilot = GoodputAutopilot(
                    silence_s=self.evict_timeout_s, clock=clock)
        self.autopilot = autopilot
        # a tensor-parallel fleet's autopilot only advises: rank 0's
        # evictions are carried out in every rank (_observe_tp)
        if autopilot is not None and not router.tensor_parallel:
            autopilot.bind(evict=lambda rid, d: self.evict(
                **self._autopilot_eviction(rid, d)))

    @staticmethod
    def _autopilot_eviction(rid: str, d) -> dict:
        return dict(replica_id=rid, reason=f"autopilot:{d.reason}",
                    silent_s=d.gauges.get("silent_s"),
                    last_metrics={k: v for k, v in d.gauges.items()
                                  if k not in ("silent_s",
                                               "silence_timeout_s")})

    def _evict_all(self, plan: List[dict]) -> None:
        """Carry out rank 0's evictions in every rank."""
        for kw in self.router.agree(plan):
            self.evict(**kw)

    def _observe_tp(self, fleet: Dict[str, dict], now: float) -> None:
        """The autopilot pass of a tensor-parallel fleet: rank 0's
        autopilot observes and decides, every rank evicts. An eviction
        that raises is logged and un-latched, so the next tick retries
        it, as an actuator's failure inside the autopilot's pass is."""
        decided = {d.target: d for d in (
            self._observe(fleet, now) if self.router.is_leader else [])
            if d.action == "evict"}
        for kw in self.router.agree([self._autopilot_eviction(rid, d)
                                     for rid, d in decided.items()]):
            rid = kw["replica_id"]
            try:
                self.evict(**kw)
            except Exception:  # noqa: BLE001 — the control loop survives
                logging.getLogger(__name__).exception(
                    "autopilot eviction of %s failed", rid)
                self.autopilot.unlatch(rid)
                continue
            if rid in decided:
                decided[rid].acted = True

    # ------------------------------------------------------------------
    def _payload(self, replica) -> Optional[dict]:
        """Newest beat payload: from the tracker when one is wired (the
        cross-process path), else straight from the in-process replica
        (the same dict, no beat in between)."""
        if self.tracker is not None:
            return self.tracker.heartbeat_metrics(replica.replica_id)
        return replica.heartbeat_payload() if replica.alive else None

    def tick(self) -> Dict[str, dict]:
        """One aggregation + health pass; returns the per-replica
        payload map (tests and dashboards read it)."""
        fleet: Dict[str, dict] = {}
        now = self.router.agree(self.clock())
        for r in self.router.replicas:
            if r.replica_id in self._evicted_set:
                continue
            m = self._payload(r)
            if m:
                fleet[r.replica_id] = m
                for gauge, key in _REPLICA_GAUGES.items():
                    if isinstance(m.get(key), (int, float)):
                        self._reg.gauge(gauge).set(float(m[key]),
                                                   replica=r.replica_id)
        tpots = {rid: float(m["tpot_s"]) for rid, m in fleet.items()
                 if isinstance(m.get("tpot_s"), (int, float))}
        update_straggler_flags(
            tpots, self.stragglers, self.straggler_ratio,
            id_label="replica", value_key="tpot_s",
            counter_name="fleet_serve_stragglers_total",
            event_name="serve.straggler")
        self._evict_pass(now, fleet)
        if self.autopilot is not None:
            if self.router.tensor_parallel:
                self._observe_tp(fleet, now)
            else:
                self._observe(fleet, now)
        alive = [r for r in self.router.replicas
                 if r.replica_id not in self._evicted_set and r.alive]
        self._reg.gauge("fleet_serve_replicas",
                        "decode-serving replicas currently alive"
                        ).set(float(len(alive)))
        self._reg.gauge("fleet_serve_stragglers").set(
            float(len(self.stragglers)))
        self.router.retry_pending()
        self.router.maybe_hedge()
        return fleet

    def _observe(self, fleet: Dict[str, dict], now: float) -> list:
        """The autopilot's pass; its decisions (none if it failed)."""
        try:
            live = [r.replica_id for r in self.router.replicas
                    if r.replica_id not in self._evicted_set]
            return self.autopilot.observe(
                fleet, stragglers=set(self.stragglers),
                last_beat=(
                    {rid: self.tracker.last_heartbeat(rid)
                     for rid in live}
                    if self.tracker is not None else None),
                now=now)
        except Exception:  # noqa: BLE001 — observing must not take
            # the serve control loop down
            logging.getLogger(__name__).exception(
                "serve autopilot observe pass failed")
            return []

    # ------------------------------------------------------------------
    def _evict_pass(self, now: float, fleet: Dict[str, dict]) -> None:
        """Evict the in-process replicas whose loop died (the dead flag
        is honest local knowledge) and, with a tracker, those whose
        heartbeat has been silent for ``evict_timeout_s`` or more (a
        replica that never beat yet is still booting); rank 0's choice
        in a tensor-parallel fleet."""
        plan = []
        for r in list(self.router.replicas):
            rid = r.replica_id
            if rid in self._evicted_set:
                continue
            if r.dead:
                plan.append(dict(replica_id=rid,
                                 reason=f"crashed: {r.dead_reason}",
                                 silent_s=None, last_metrics=fleet.get(rid)))
                continue
            if self.tracker is None:
                continue
            t = self.tracker.last_heartbeat(rid)
            if t is None:
                continue
            silent = now - t
            if silent >= self.evict_timeout_s:
                plan.append(dict(
                    replica_id=rid, reason="heartbeat_silence",
                    silent_s=round(silent, 3),
                    last_metrics=self.tracker.heartbeat_metrics(rid)
                    or fleet.get(rid)))
        self._evict_all(plan)

    def evict(self, replica_id: str, *, reason: str,
              silent_s: Optional[float] = None,
              last_metrics: Optional[dict] = None) -> dict:
        """Evict one replica: evidence-logged decision, gauges dropped,
        in-flight requests failed over. Also the bench/dryrun's forced-
        eviction hook. Idempotent: the crash sweep and an
        autopilot-directed eviction may both reach the same replica, and
        only the first one acts."""
        if replica_id in self._evicted_set:
            return {"replica": replica_id, "reason": "already_evicted"}
        replica = self.router._by_id[replica_id]
        # kill, don't just flag: a silence-evicted replica may still be
        # RUNNING (stalled beats, live loop) — leaving its loop up would
        # have a zombie decoding the same requests the survivors now own
        replica.kill(reason)
        self._evicted_set.add(replica_id)
        self.evicted.append(replica_id)
        self.stragglers.discard(replica_id)
        for gauge in _REPLICA_GAUGES:
            self._reg.gauge(gauge).remove(replica=replica_id)
        decision = {"replica": replica_id, "reason": reason,
                    "silent_s": silent_s,
                    "timeout_s": self.evict_timeout_s,
                    "t_wall": self.clock(),
                    "last_metrics": last_metrics}
        record_counter("fleet_serve_evictions_total", replica=replica_id)
        # the tracer event forwards into the flight ring on its own
        # (span forwarding) — no explicit flight write
        tracer().event("serve.evict", **decision)
        summary = self.router.failover(replica_id, reason=reason)
        decision["failover"] = summary
        self.eviction_log.append(decision)
        return decision

    def drain(self, replica_id: str, *,
              reason: str = "operator_drain") -> dict:
        """Gracefully retire one replica: quiesce admission, stop its
        step loop, migrate every in-flight stream to survivors via
        KV-slab handoff (zero recompute, zero lost tokens — contrast
        :meth:`evict`, which re-prefills because a dead replica's KV is
        gone), and mark it retired. Evidence-logged like an eviction;
        idempotent against evict/drain races the same way."""
        if replica_id in self._evicted_set:
            return {"replica": replica_id, "reason": "already_evicted"}
        replica = self.router._by_id.get(replica_id)
        if replica is None:
            raise KeyError(f"unknown replica {replica_id!r}")
        self._evicted_set.add(replica_id)
        self.drained.append(replica_id)
        self.stragglers.discard(replica_id)
        # 1) no new work lands on it (placement, spill, hedges,
        #    affinity all skip a quiesced replica)
        self.router.quiesce(replica_id)
        # 2) stop the step loop CLEANLY before touching device state —
        #    migrate_out exports live cursors a concurrent step would
        #    advance; retired is not dead, so no failover fires
        replica.retire()
        # 3) move everything off with zero recompute
        summary = self.router.migrate_out(replica_id)
        for gauge in _REPLICA_GAUGES:
            self._reg.gauge(gauge).remove(replica=replica_id)
        migrated = (summary["handoffs"] + summary["queued"]
                    + summary["live"])
        decision = {"replica": replica_id, "reason": reason,
                    "t_wall": self.clock(), "migrated": migrated,
                    **summary}
        record_counter("fleet_serve_drains_total", replica=replica_id)
        self._reg.gauge("serve_drain_migrated").set(
            float(migrated), replica=replica_id)
        tracer().event("serve.drain", **decision)
        self.drain_log.append(decision)
        return decision

    # ------------------------------------------------------------------
    # real-time loop (the in-process fleet's master thread)
    # ------------------------------------------------------------------
    def start(self, interval_s: Optional[float] = None
              ) -> "FleetController":
        if self._thread is not None and self._thread.is_alive():
            return self
        interval = (interval_s if interval_s is not None
                    else max(0.05, self.evict_timeout_s / 4))
        stop = threading.Event()
        self._stop = stop

        def run():
            while not stop.wait(interval):
                self.tick()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="serve-fleet-controller")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
