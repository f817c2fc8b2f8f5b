"""Work routing: synchronous iterative-reduce vs asynchronous Hogwild.

Port of ``deeplearning4j_tpu/parallel/workrouter.py``, the reference's
scaleout SPI and its two dispatch policies: ``IterativeReduceWorkRouter``
(the master waits until every worker has posted before averaging and
redistributing) and ``HogwildWorkRouter`` (each worker's update folds in as
it lands, no barrier); performers fit a network on a job's DataSet and emit
flat params, and ``average_aggregator`` averages them.

Workers are threads or processes sharing a ``StateTracker`` (in-memory or
file-backed); the master loop is ``DistributedTrainer``, and the math inside
each ``perform()`` is the network's own step on its device. This layer is
the control plane: gradient sync inside one world is ``ParallelWrapper``'s
collectives. The goodput autopilot (``autopilot=``, ``DL4J_AUTOPILOT``)
rides the master tick and evicts through the trainer's own evidence-logged
``evict_worker``.
"""

from __future__ import annotations

import logging
import statistics
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.monitor import metrics, record_counter, tracer
from deeplearning4j_tpu_torch.parallel.statetracker import StateTracker

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# SPI
# ---------------------------------------------------------------------------


class WorkerPerformer:
    """perform(job payload) → flat update array (WorkerPerformer.java)."""

    def perform(self, payload: Any) -> np.ndarray:
        raise NotImplementedError

    def update(self, params: np.ndarray) -> None:
        """Receive redistributed parameters (WorkerPerformer.update)."""


class NetworkWorkPerformer(WorkerPerformer):
    """Fit a MultiLayerNetwork on each job's DataSet and emit flat params
    (BaseMultiLayerNetworkWorkPerformer.java: conf JSON in, params out).
    The network lives on ``device`` (default: the card)."""

    def __init__(self, conf_json: str, fit_epochs: int = 1, device=None):
        from deeplearning4j_tpu_torch.nn.conf.neural_net import (
            MultiLayerConfiguration)
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        self.network = MultiLayerNetwork(
            MultiLayerConfiguration.from_json(conf_json),
            device=device).init()
        self.fit_epochs = fit_epochs

    def perform(self, payload: Any) -> np.ndarray:
        from deeplearning4j_tpu_torch.datasets.dataset import DataSet

        ds = DataSet(np.asarray(payload["features"], np.float32),
                     np.asarray(payload["labels"], np.float32))
        self.network.fit(ds, num_epochs=self.fit_epochs)
        return self.network.get_flat_params()

    def update(self, params: np.ndarray) -> None:
        self.network.set_flat_params(np.asarray(params))


def update_straggler_flags(samples: Dict[str, float], flagged: set,
                           ratio: float, *, id_label: str,
                           value_key: str, counter_name: str,
                           event_name: str,
                           min_reporting: int = 3) -> Optional[float]:
    """Shared outlier rule for fleet views (training master tick AND the
    serve-fleet controller): a member whose sample exceeds ``ratio`` x
    the fleet median gets flagged — with the evidence (value, median,
    ratio) on the timeline — and un-flagged on recovery. Requires at
    least ``min_reporting`` members so one slow pair cannot nominate
    each other. Mutates ``flagged`` in place; returns the median used
    (None when below the reporting floor)."""
    if len(samples) < min_reporting:
        return None
    median = statistics.median(samples.values())
    for member, value in samples.items():
        slow = median > 0 and value > ratio * median
        if slow and member not in flagged:
            flagged.add(member)
            record_counter(counter_name, **{id_label: member})
            tracer().event(event_name,
                           **{id_label: member,
                              value_key: round(value, 4),
                              "median_s": round(median, 4),
                              "ratio": ratio})
        elif not slow:
            flagged.discard(member)
    return median


def average_aggregator(updates: Sequence[np.ndarray]) -> np.ndarray:
    """INDArrayAggregator: element-wise mean (parameter averaging)."""
    if not updates:
        raise ValueError("no updates to aggregate")
    return np.mean(np.stack([np.asarray(u) for u in updates]), axis=0)


class WorkRouter:
    """Decides when worker updates become the new global parameters."""

    def __init__(self, tracker: StateTracker,
                 aggregator: Callable[[Sequence[np.ndarray]], np.ndarray]
                 = average_aggregator):
        self.tracker = tracker
        self.aggregator = aggregator
        self.rounds = 0

    def post(self, worker_id: str, update: np.ndarray) -> None:
        raise NotImplementedError

    def step(self, num_workers: int) -> bool:
        """Master tick; True when global params advanced this tick."""
        raise NotImplementedError

    def current_params(self) -> Optional[np.ndarray]:
        got = self.tracker.get_array("global_params")
        return None if got is None else np.asarray(got, np.float32)

    def _publish(self, params: np.ndarray) -> None:
        # binary channel: flat params are MBs — never JSON-encode them
        self.tracker.put_array("global_params", np.asarray(params))
        self.rounds += 1


class IterativeReduceWorkRouter(WorkRouter):
    """Barrier semantics (IterativeReduceWorkRouter.java:48-53): aggregate
    only once EVERY worker has posted, then redistribute. The barrier peeks
    entry KEYS only (no array reads on the poll path) and counts distinct
    workers; consumption is an atomic drain, so updates posted between peek
    and drain — including a second post from a fast worker — are
    aggregated, never dropped."""

    def post(self, worker_id: str, update: np.ndarray) -> None:
        self.tracker.post_update(worker_id, update)

    def step(self, num_workers: int) -> bool:
        keys = self.tracker.posted_update_keys()
        distinct = {self.tracker.update_worker(k) for k in keys}
        if len(distinct) < num_workers:
            return False
        updates = self.tracker.drain_updates()
        if not updates:
            return False
        self._publish(self.aggregator(
            [updates[k] for k in sorted(updates)]))
        return True


class HogwildWorkRouter(WorkRouter):
    """Async semantics (HogWildWorkRouter.java:32): each update folds into
    the global params immediately — no waiting on stragglers. The fold is
    serialized per router instance (in-process workers); cross-process
    Hogwild should give each process its own router over a shared tracker
    and accept last-write races on the published params, as the reference
    does by design."""

    def __init__(self, tracker: StateTracker, mix: float = 0.5, **kw):
        super().__init__(tracker, **kw)
        self.mix = mix  # how far to move toward the incoming update
        self._fold_lock = threading.Lock()

    def post(self, worker_id: str, update: np.ndarray) -> None:
        with self._fold_lock:  # read-modify-write must not drop updates
            cur = self.current_params()
            new = (np.asarray(update, np.float32) if cur is None
                   else (1.0 - self.mix) * cur
                   + self.mix * np.asarray(update, np.float32))
            self._publish(new)

    def step(self, num_workers: int) -> bool:
        return False  # nothing gated on the master


# ---------------------------------------------------------------------------
# the master/worker loop (DeepLearning4jDistributed.train(), in-process)
# ---------------------------------------------------------------------------


class DistributedTrainer:
    """Run jobs through N worker threads under a router's policy.

    In-process stand-in for the actor runtime (MasterActor poll loop
    :106-139 + WorkerActor pool :183-203), testable on one host the way the
    reference's ``BaseTestDistributed`` boots an embedded actor system.
    """

    def __init__(self, tracker: StateTracker, router: WorkRouter,
                 performer_factory: Callable[[], WorkerPerformer],
                 num_workers: int = 2, poll_s: float = 0.01,
                 max_attempts: int = 3, join_timeout_s: float = 60.0,
                 eviction_timeout_s: Optional[float] = None,
                 heartbeat_interval_s: float = 1.0,
                 straggler_ratio: float = 3.0,
                 autopilot=None):
        self.tracker = tracker
        self.router = router
        self.performer_factory = performer_factory
        self.num_workers = num_workers
        self.poll_s = poll_s
        self.max_attempts = max_attempts
        self.join_timeout_s = join_timeout_s
        # MasterActor heartbeat eviction: with a timeout set, the master
        # tick drops workers silent >= timeout and requeues their claimed
        # jobs — a killed worker cannot wedge the run. The timeout must
        # comfortably exceed the beat interval or live workers get evicted
        # on ordinary scheduling jitter and their jobs double-executed.
        if (eviction_timeout_s is not None
                and eviction_timeout_s <= 2 * heartbeat_interval_s):
            raise ValueError(
                f"eviction_timeout_s ({eviction_timeout_s}) must exceed "
                f"2x heartbeat_interval_s ({heartbeat_interval_s}): a "
                f"single missed beat would evict a live worker")
        self.eviction_timeout_s = eviction_timeout_s
        self.heartbeat_interval_s = heartbeat_interval_s
        # fleet view: a worker whose step time exceeds straggler_ratio x
        # the fleet median gets flagged (>=3 reporting workers, so one
        # slow pair can't nominate each other)
        self.straggler_ratio = float(straggler_ratio)
        # the goodput autopilot (observe→act over the fleet gauges this
        # tick aggregates): pass an instance, or set DL4J_AUTOPILOT=1 for
        # the default policy with the trainer's own evict path wired in
        if autopilot is None:
            from deeplearning4j_tpu_torch.resilience.autopilot import (
                GoodputAutopilot, autopilot_enabled)

            if autopilot_enabled():
                # silence threshold = the eviction timeout (one policy,
                # two detectors); 120 s without timeout-based eviction
                autopilot = GoodputAutopilot(
                    silence_s=(eviction_timeout_s
                               if eviction_timeout_s is not None
                               else 120.0))
        self.autopilot = autopilot
        if autopilot is not None:
            autopilot.bind(
                evict=lambda w, d: self.evict_worker(w, decision=d),
                readmit=lambda w, d: self.readmitted.append(w))
        self.performers: List[WorkerPerformer] = []
        self.errors: List[str] = []
        self.evicted: List[str] = []
        self.readmitted: List[str] = []
        self.eviction_log: List[dict] = []  # decisions + their evidence
        self.stragglers: set = set()
        self.monitors: Dict[str, Any] = {}
        # per-worker stop events: a TARGETED eviction (autopilot
        # straggler decision) must stop that worker's loop and beats —
        # otherwise the evicted worker re-registers on its next beat,
        # re-claims its own requeued job, and the fleet flaps
        # evict/readmit forever while the straggler keeps dragging
        self._worker_stops: Dict[str, threading.Event] = {}
        self._stats_lock = threading.Lock()
        self._worker_stats: Dict[str, Dict[str, Any]] = {}
        self._last_fleet_tick = 0.0

    def _worker_loop(self, worker_id: str, performer: WorkerPerformer,
                     stop: threading.Event,
                     worker_stop: Optional[threading.Event] = None
                     ) -> None:
        from deeplearning4j_tpu_torch.parallel.cluster import HeartbeatMonitor

        # beats come from a background monitor thread, NOT the work loop:
        # a long perform() (a first call building kernels, a big job) must
        # not go
        # silent and get spuriously evicted + double-executed. Only a dead
        # process — which takes its monitor thread with it — stops beating.
        # Each beat carries the worker's compact metrics payload (step
        # time, jobs, last loss, process goodput) for the master's fleet
        # view; payload failures degrade to payload-less liveness.
        monitor = HeartbeatMonitor(
            self.tracker, worker_id,
            interval_s=self.heartbeat_interval_s,
            payload_fn=lambda: self._heartbeat_payload(worker_id)).start()
        self.monitors[worker_id] = monitor
        try:
            self._worker_poll(worker_id, performer, stop, worker_stop)
        finally:
            monitor.stop()

    def _worker_poll(self, worker_id: str, performer: WorkerPerformer,
                     stop: threading.Event,
                     worker_stop: Optional[threading.Event] = None
                     ) -> None:
        while not stop.is_set() and not (worker_stop is not None
                                         and worker_stop.is_set()):
            job = self.tracker.claim_job(worker_id)
            if job is None:
                time.sleep(self.poll_s)
                continue
            try:
                latest = self.router.current_params()
                if latest is not None:
                    performer.update(latest)
                t0 = time.monotonic()
                update = performer.perform(job.payload)
                self._note_step(worker_id, performer,
                                time.monotonic() - t0)
                self.router.post(worker_id, update)
                self.tracker.complete_job(job.job_id)
            except Exception as e:
                # a poison job must not kill the worker pool: bounded
                # requeue, permanent failure after max_attempts, error kept
                # for the master (JobFailed protocol)
                import traceback

                self.errors.append(
                    f"{job.job_id} attempt {job.attempts}: "
                    f"{traceback.format_exc()}")
                requeue = job.attempts < self.max_attempts
                self.tracker.fail_job(job.job_id, requeue=requeue)

    # -- fleet telemetry -------------------------------------------------
    def _note_step(self, worker_id: str, performer: WorkerPerformer,
                   step_s: float) -> None:
        loss = None
        score = getattr(getattr(performer, "network", None), "_score",
                        None)
        if score is not None:
            try:
                loss = float(score)  # control-plane thread, one scalar
            except (TypeError, ValueError):
                loss = None
        with self._stats_lock:
            prev = self._worker_stats.get(worker_id, {})
            self._worker_stats[worker_id] = {
                "step_s": float(step_s),
                "jobs": int(prev.get("jobs", 0)) + 1,
                "last_loss": loss,
            }

    def _heartbeat_payload(self, worker_id: str) -> Optional[dict]:
        with self._stats_lock:
            stats = self._worker_stats.get(worker_id)
            payload = None if stats is None else dict(stats)
        if payload is not None:
            try:
                from deeplearning4j_tpu_torch.monitor.ledger import run_ledger

                payload["goodput_pct"] = run_ledger().last_run_goodput()
            except Exception:  # the beat must post regardless
                pass
        return payload

    def fleet_tick(self) -> Dict[str, dict]:
        """One master-side aggregation pass over the fleet's heartbeat
        payloads: per-worker gauges (step time, goodput, last loss) land
        in the registry, and step-time outliers — more than
        ``straggler_ratio`` x the fleet median, with at least three
        workers reporting — are flagged as stragglers, with the evidence
        (step time, median, ratio) on the timeline. Returns the
        per-worker payload map (tests read it)."""
        fleet: Dict[str, dict] = {}
        reg = metrics()
        for w in self.tracker.workers():
            m = self.tracker.heartbeat_metrics(w)
            if not m:
                continue
            fleet[w] = m
            if isinstance(m.get("step_s"), (int, float)):
                reg.gauge("fleet_worker_step_seconds",
                          "per-worker step time from heartbeat payloads"
                          ).set(float(m["step_s"]), worker=w)
            if isinstance(m.get("goodput_pct"), (int, float)):
                reg.gauge("fleet_worker_goodput_pct",
                          "per-worker run-ledger goodput"
                          ).set(float(m["goodput_pct"]), worker=w)
            if isinstance(m.get("last_loss"), (int, float)):
                reg.gauge("fleet_worker_last_loss",
                          "per-worker last-chunk loss"
                          ).set(float(m["last_loss"]), worker=w)
        steps = {w: float(m["step_s"]) for w, m in fleet.items()
                 if isinstance(m.get("step_s"), (int, float))}
        update_straggler_flags(steps, self.stragglers,
                               self.straggler_ratio, id_label="worker",
                               value_key="step_s",
                               counter_name="fleet_stragglers_total",
                               event_name="fleet.straggler")
        reg.gauge("fleet_workers", "workers with live heartbeats"
                  ).set(float(len(self.tracker.workers())))
        reg.gauge("fleet_stragglers",
                  "workers currently flagged as stragglers"
                  ).set(float(len(self.stragglers)))
        return fleet

    def evict_worker(self, worker_id: str, *, decision=None,
                     reason: str = "autopilot") -> dict:
        """Targeted eviction through the SAME evidence-logged path the
        master tick's stale sweep uses: evidence gathered (beat age +
        last payload), jobs requeued via the tracker, the decision
        appended to ``eviction_log``, counter bumped, ``fleet.evict``
        event on the timeline. The autopilot's evict actuator lands
        here, so an autopilot-directed eviction is indistinguishable in
        the audit trail from a timeout one — except for its recorded
        reason."""
        now = time.time()
        t = self.tracker.last_heartbeat(worker_id)
        evidence = {
            "worker": worker_id,
            "reason": (reason if decision is None
                       else f"autopilot:{decision.reason}"),
            "silent_s": None if t is None else round(now - t, 3),
            "timeout_s": self.eviction_timeout_s,
            "t_wall": now,
            "last_metrics": self.tracker.heartbeat_metrics(worker_id),
        }
        # stop the worker FOR REAL (loop + beats), not just its tracker
        # record: a still-running straggler would re-register on its next
        # beat and re-claim its own requeued job — evict/readmit flap
        wstop = self._worker_stops.get(worker_id)
        if wstop is not None:
            wstop.set()
        monitor = self.monitors.get(worker_id)
        if monitor is not None:
            monitor.stop()
        self.tracker.evict_worker(worker_id)
        self.evicted.append(worker_id)
        self.stragglers.discard(worker_id)
        self.eviction_log.append(evidence)
        record_counter("fleet_evictions_total", worker=worker_id)
        tracer().event("fleet.evict", **{
            k: v for k, v in evidence.items()
            if isinstance(v, (str, int, float, bool))})
        return evidence

    def autopilot_tick(self, fleet: Dict[str, dict]) -> None:
        """Feed the autopilot exactly what this master tick already
        holds: the payload map, the straggler set, and the last-beat
        timestamps. Decisions act through the bound actuators (evict →
        :meth:`evict_worker`); the observe pass itself must never take
        the training loop down."""
        if self.autopilot is None:
            return
        try:
            self.autopilot.observe(
                fleet, stragglers=set(self.stragglers),
                last_beat={w: self.tracker.last_heartbeat(w)
                           for w in self.tracker.workers()})
        except Exception:  # noqa: BLE001 — act layer is best-effort
            logger.exception("autopilot observe pass failed")

    def _evict_tick(self) -> List[str]:
        """Evict stale workers AND record each decision with the
        evidence that justified it — beat age vs timeout plus the last
        metrics payload the dead worker reported — so a postmortem can
        audit why the master dropped someone. Evidence (a second beat
        read + a metrics read) is gathered ONLY for workers already
        past the timeout: the common all-alive tick costs the same one
        read per worker it always did."""
        now = time.time()
        evidence = {}
        for w in self.tracker.workers():
            t = self.tracker.last_heartbeat(w)
            if t is not None and now - t < self.eviction_timeout_s:
                continue  # alive: no evidence needed, no extra I/O
            evidence[w] = {
                "silent_s": None if t is None else round(now - t, 3),
                "last_metrics": self.tracker.heartbeat_metrics(w),
            }
        stale = self.tracker.evict_stale(self.eviction_timeout_s)
        for w in stale:
            decision = {"worker": w,
                        "timeout_s": self.eviction_timeout_s,
                        "t_wall": now, **evidence.get(w, {})}
            self.eviction_log.append(decision)
            record_counter("fleet_evictions_total", worker=w)
            # the tracer event forwards into the flight ring on its own
            # (trace._record) — no explicit flight write, or evictions
            # would double-count in the postmortem tally
            tracer().event("fleet.evict", **decision)
        return stale

    def train(self, timeout_s: float = 120.0,
              raise_on_failed_jobs: bool = True) -> np.ndarray:
        """Drain all pending jobs; returns the final global params."""
        stop = threading.Event()
        self.performers = [self.performer_factory()
                           for _ in range(self.num_workers)]
        self._worker_stops = {f"worker-{i}": threading.Event()
                              for i in range(self.num_workers)}
        threads = [
            threading.Thread(
                target=self._worker_loop,
                args=(f"worker-{i}", p, stop,
                      self._worker_stops[f"worker-{i}"]), daemon=True)
            for i, p in enumerate(self.performers)
        ]
        for t in threads:
            t.start()
        deadline = time.monotonic() + timeout_s
        try:
            while time.monotonic() < deadline:
                self.router.step(self.num_workers)
                # fleet aggregation is throttled to the beat cadence —
                # re-reading every payload each 10 ms poll would hammer a
                # file-backed tracker for data that changes once a beat
                now_mono = time.monotonic()
                if now_mono - self._last_fleet_tick >= max(
                        self.poll_s, self.heartbeat_interval_s):
                    self._last_fleet_tick = now_mono
                    self.autopilot_tick(self.fleet_tick())
                if self.eviction_timeout_s is not None:
                    stale = self._evict_tick()
                    if stale:
                        self.evicted.extend(stale)
                        self.errors.append(
                            f"evicted stale worker(s) {stale}; their "
                            f"claimed jobs were requeued")
                pending = self.tracker.jobs(status="pending")
                claimed = self.tracker.jobs(status="claimed")
                if not pending and not claimed:
                    break
                time.sleep(self.poll_s)
            else:
                raise TimeoutError(
                    "jobs not drained in time"
                    + (f"; worker errors: {self.errors[-1]}"
                       if self.errors else ""))
        finally:
            stop.set()
            # a worker mid-perform (a first call building kernels, say) must
            # land
            # its post before the leftover drain below, or its finished
            # job's training would be lost — wait generously and surface a
            # straggler instead of silently proceeding
            for t in threads:
                t.join(timeout=self.join_timeout_s)
            stragglers = [t.name for t in threads if t.is_alive()]
            if stragglers:
                self.errors.append(
                    f"worker threads still running after "
                    f"{self.join_timeout_s}s: {stragglers}; their updates "
                    f"may be excluded from the returned params")
        params = self.router.current_params()
        # a final partial barrier round (fewer posts than workers) still
        # carries finished jobs' training — fold it in, never discard
        leftover = self.tracker.drain_updates()
        if leftover:
            vals = [leftover[k] for k in sorted(leftover)]
            if params is not None:
                vals.append(params)
            params = self.router.aggregator(vals)
        if raise_on_failed_jobs and self.tracker.jobs(status="failed"):
            raise RuntimeError(
                f"{len(self.tracker.jobs(status='failed'))} job(s) failed "
                f"permanently; last error:\n"
                f"{self.errors[-1] if self.errors else '(none recorded)'}")
        return params
