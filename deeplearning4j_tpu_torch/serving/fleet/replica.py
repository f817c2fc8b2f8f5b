"""ServeReplica: one DecodeServer as a fleet worker.

Port of ``deeplearning4j_tpu/serving/fleet/replica.py``. With
``tracker=`` a started replica beats through a
``parallel.cluster.HeartbeatMonitor``, each beat carrying
:meth:`heartbeat_payload`; without one an in-process fleet's controller
reads the payload directly. With ``lease=`` (a
``resilience.lease.GrantLease``, typically around :meth:`warm_up`),
``start`` acquires it first; a lease that wedges on every attempt marks
the replica dead and the controller's crash path evicts it, while a
kernel that fails to build or launch propagates from ``start``. A
sampled request's stream is a ``torch.Generator`` seeded with
its seed (the reference's ``jax.random.PRNGKey(seed)``). Several replicas
started on one card share its default stream; a killed replica dies
between steps, at the ``serve.replica.step.<id>`` fault site, never
inside a kernel.

The serving analogue of ``DistributedTrainer``'s worker loop: a replica
wraps a :class:`~deeplearning4j_tpu_torch.serving.server.DecodeServer` in
a poll loop and exposes the compact serve payload the router and
controller consume (the reference posts it on every heartbeat)::

    {occupancy, queue_depth, free_slots, ttft_p50, tpot_s,
     tokens_per_sec, role}

Roles (``DL4J_SERVE_ROLE``): ``mixed`` replicas run the full request
lifecycle; ``prefill`` replicas only drain prompt-prefill jobs into
:class:`~.handoff.SlotHandoff` packages for the router to place;
``decode`` replicas only accept handoffs + continue streams. The loop
body (:meth:`step_once`) is shared by the real-time thread and the
bench's virtual-clock driver, and declares the ``serve.replica.step``
fault site (plus a per-replica ``serve.replica.step.<id>`` site) so
chaos tests can kill or wedge one specific replica mid-stream.

A replica whose server is tensor-parallel (``DecodeServer(mesh=)``) is
one replica of every rank of the ``model`` group: each rank holds its
own copy of it (and of the fleet around it) and makes the same calls.
Its ``step_once`` is then collective: a prefill-role replica runs the
job rank 0 chose (by its sequence number, broadcast), so every rank
prefills and exports the same prompt together. Such a fleet is stepped
by its caller, alike in every rank (``step_once`` in one order): a loop
thread of its own (``start``) would run its collectives in an order no
other rank shares, so ``start`` refuses it.
"""

from __future__ import annotations

import statistics
import threading
import time
from collections import deque
from typing import Deque, Optional

import numpy as np

from deeplearning4j_tpu_torch.monitor import metrics, tracer
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.serving.fleet.handoff import (
    SlotHandoff, export_slot, generator_key)
from deeplearning4j_tpu_torch.serving.scheduler import SERVE_ROLES, serve_role
from deeplearning4j_tpu_torch.serving.server import (
    _LATENCY_BUCKETS, DecodeServer)

__all__ = ["ServeReplica"]

#: scratch slot a prefill-role replica reuses for every prompt: it never
#: decodes, so the slot is always free again the moment the slab exports
_PREFILL_SCRATCH_SLOT = 0


class ServeReplica:
    """One decode server + its worker-loop/heartbeat/handoff plumbing."""

    def __init__(self, replica_id: str, model, *,
                 tracker=None, role: Optional[str] = None,
                 heartbeat_interval_s: float = 1.0,
                 poll_s: float = 0.002,
                 clock=time.monotonic, server: Optional[DecodeServer] = None,
                 lease=None, **server_kw):
        self.replica_id = str(replica_id)
        self.role = role if role is not None else serve_role()
        if self.role not in SERVE_ROLES:
            raise ValueError(
                f"role={self.role!r} must be one of {SERVE_ROLES}")
        self.server = server if server is not None else DecodeServer(
            model, clock=clock, **server_kw)
        self.tracker = tracker
        # grant lease around this replica's backend acquisition (its
        # warm-up): a wedged acquisition re-acquires under the lease's
        # bounded watchdog; exhaustion marks the replica dead so the
        # controller evicts it. None: an acquire-free start
        self.lease = lease
        self.monitor = None  # the HeartbeatMonitor while started
        self._monitor_lock = threading.Lock()
        self.heartbeat_interval_s = heartbeat_interval_s
        self.poll_s = poll_s
        self.clock = clock
        self.dead = False
        self.dead_reason: Optional[str] = None
        # planned removal (graceful drain): alive goes False without
        # the dead flag — drained is not crashed, and the controller's
        # crash-evict pass must not treat it as a corpse
        self.retired = False
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None
        # prefill-role work: (seq, FleetRequest, on_handoff) jobs the
        # router assigned; on_handoff(freq, SlotHandoff) places the result
        self._prefill_jobs: Deque = deque()
        self._jobs_lock = threading.Lock()
        self._job_seq = 0
        # rolling quality-of-service samples for the heartbeat payload
        self._ttfts: Deque[float] = deque(maxlen=128)
        self._tpots: Deque[float] = deque(maxlen=128)
        self._ttft_seen: set = set()
        self._finished_seen = 0
        self._rate_t0 = clock()
        self._rate_tokens0 = 0
        self._rate = 0.0
        self.prefills_done = 0

    # ------------------------------------------------------------------
    # load / QoS view (the router reads these directly in-process; the
    # heartbeat payload carries the same numbers across processes)
    # ------------------------------------------------------------------
    @property
    def alive(self) -> bool:
        return not self.dead and not self.retired

    def ttft_p50(self) -> Optional[float]:
        return statistics.median(self._ttfts) if self._ttfts else None

    def tpot_p50(self) -> Optional[float]:
        return statistics.median(self._tpots) if self._tpots else None

    def queue_depth(self) -> int:
        with self._jobs_lock:
            jobs = len(self._prefill_jobs)
        return len(self.server.queue) + jobs

    def busy(self) -> bool:
        with self._jobs_lock:
            jobs = bool(self._prefill_jobs)
        return jobs or self.server.busy()

    def heartbeat_payload(self) -> dict:
        """The compact fleet-view payload each beat carries."""
        s = self.server
        ttft = self.ttft_p50()
        tpot = self.tpot_p50()
        return {
            "role": self.role,
            "occupancy": round(s.occupancy(), 4),
            "queue_depth": self.queue_depth(),
            "free_slots": s.free_slot_count(),
            "ttft_p50": None if ttft is None else round(ttft, 6),
            "tpot_s": None if tpot is None else round(tpot, 6),
            "tokens_per_sec": round(self._rate, 2),
        }

    # ------------------------------------------------------------------
    # the worker loop body (shared by the thread and the virtual driver)
    # ------------------------------------------------------------------
    def step_once(self) -> bool:
        """One loop iteration: drain one prefill job (prefill role) or
        run one server step (decode-capable roles), then harvest QoS
        samples. Returns False when nothing progressed (caller may
        idle). Declares the chaos fault sites."""
        faults.fault_point("serve.replica.step")
        faults.fault_point(f"serve.replica.step.{self.replica_id}")
        progressed = False
        # prefill jobs are a prefill-ROLE surface only: _do_prefill
        # writes into the fixed scratch slot, which on a decode-capable
        # replica could hold a live stream mid-decode
        if self.role == "prefill":
            job = self._next_job()
            if job is not None:
                self._do_prefill(*job)
                progressed = True
        else:
            progressed = self.server.step()
        self._harvest()
        return progressed

    def _next_job(self):
        """The next prefill job, ``(freq, on_handoff)`` or None: the
        oldest one, and on a tensor-parallel server the one rank 0 takes
        (every rank runs it, so it names it by sequence number)."""
        with self._jobs_lock:
            head = self._prefill_jobs[0][0] if self._prefill_jobs else None
        seq = self.server.agree(head)
        if seq is None:
            return None
        with self._jobs_lock:
            for i, (s, freq, on_handoff) in enumerate(self._prefill_jobs):
                if s == seq:
                    del self._prefill_jobs[i]
                    return freq, on_handoff
        raise RuntimeError(
            f"rank 0 runs prefill job {seq} of replica {self.replica_id}, "
            "which this rank was not assigned: every rank of a "
            "tensor-parallel fleet must make the same calls")

    def _do_prefill(self, freq, on_handoff) -> None:
        """Run one prompt prefill into the scratch slot, export the
        slab (the whole slot: a tensor-parallel server gathers its
        ranks' heads), stamp TTFT, and hand the package to the router's
        placement callback."""
        engine = self.server.engine
        req = freq.inner
        with tracer().span("serve.handoff.prefill", request=req.id,
                           replica=self.replica_id,
                           prompt_len=int(req.prompt.shape[0])):
            gen = self.server._generator(req.seed)
            tok = int(engine.prefill(req.prompt, _PREFILL_SCRATCH_SLOT,
                                     gen, replay=req.replay))
            slabs = export_slot(engine, _PREFILL_SCRATCH_SLOT)
        now = self.clock()
        req.state = "running"
        req.first_token_s = now
        req.tokens.append(tok)
        self.prefills_done += 1
        if req.ttft_s is not None:
            self._ttfts.append(req.ttft_s)
            # same histogram (and bucket ladder) the single-server
            # admission path feeds — TTFT is stamped wherever the first
            # token is sampled
            metrics().histogram("serve_ttft_seconds",
                                buckets=_LATENCY_BUCKETS
                                ).observe(req.ttft_s)
        metrics().counter("serve_tokens_total").inc()
        handoff = SlotHandoff(
            slabs=slabs, cursor=int(req.prompt.shape[0]),
            key=generator_key(gen), first_token=tok,
            kv_dtype=engine.kv_dtype, max_len=engine.max_len,
            device=engine.device.type)
        on_handoff(freq, handoff)

    def enqueue_prefill(self, freq, on_handoff) -> None:
        """Router-side: assign one prefill job to this replica.
        Prefill-role only — the scratch slot a job prefills into is
        free by construction there, and could be a live stream's slot
        anywhere else."""
        if self.role != "prefill":
            raise ValueError(
                f"replica {self.replica_id} has role {self.role!r}; "
                "prefill jobs only run on role='prefill' replicas")
        with self._jobs_lock:
            self._prefill_jobs.append((self._job_seq, freq, on_handoff))
            self._job_seq += 1

    def _harvest(self) -> None:
        """Pull QoS samples out of the server's bookkeeping: TTFTs of
        newly-first-tokened requests, per-token latency of newly
        finished ones, and the rolling token rate."""
        s = self.server
        for req in s._slot_req:
            # handed-off requests' TTFT belongs to the prefill replica
            # that stamped it — re-collecting it here would attribute
            # another replica's latency to this one (and double-count
            # it fleet-wide)
            if req is not None and req.ttft_s is not None \
                    and not req.handoff \
                    and req.id not in self._ttft_seen:
                self._ttft_seen.add(req.id)
                self._ttfts.append(req.ttft_s)
        new = s.finished[self._finished_seen:]
        self._finished_seen = len(s.finished)
        for req in new:
            if (req.id not in self._ttft_seen and not req.handoff
                    and req.ttft_s is not None):
                self._ttft_seen.add(req.id)
                self._ttfts.append(req.ttft_s)
            self._ttft_seen.discard(req.id)
            if (req.first_token_s is not None and req.finish_s is not None
                    and len(req.tokens) > 1):
                self._tpots.append((req.finish_s - req.first_token_s)
                                   / (len(req.tokens) - 1))
        now = self.clock()
        elapsed = now - self._rate_t0
        if elapsed >= 1.0:
            self._rate = (s.decode_tokens - self._rate_tokens0) / elapsed
            self._rate_t0 = now
            self._rate_tokens0 = s.decode_tokens

    # ------------------------------------------------------------------
    # real-time lifecycle (threads; the bench's virtual driver calls
    # step_once directly instead)
    # ------------------------------------------------------------------
    def warm_up(self, prompt=None) -> int:
        """The replica's backend acquisition, for a ``GrantLease``: on the
        card, load the kernel library (built on first use) and run one
        prefill of ``prompt`` (default one token) into a scratch slot,
        which launches B1 once a layer on a flash model; returns the
        first token (reading it waits for the card). Run it before
        ``start``: the slot is overwritten by the next admission."""
        engine = self.server.engine
        if engine.device.type == "cuda":
            from deeplearning4j_tpu_torch.kernels import _build

            _build.load("flash_fwd")
        prompt = np.zeros((1,), np.int64) if prompt is None else prompt
        return int(engine.prefill(prompt, _PREFILL_SCRATCH_SLOT,
                                  self.server._generator(0)))

    def start(self) -> "ServeReplica":
        if self.server.tensor_parallel:
            raise ValueError(
                f"replica {self.replica_id} serves tensor-parallel: every "
                "rank must run its collectives in one order, so step it "
                "with step_once alike in every rank, not in a thread")
        if self._thread is not None and self._thread.is_alive():
            return self
        if self.lease is not None:
            from deeplearning4j_tpu_torch.resilience.lease import (
                GrantWedgedError)

            try:
                self.lease.acquire()
            except GrantWedgedError as e:
                # a replica that never got its grant is a dead replica:
                # the controller's crash path evicts it with the lease's
                # evidence and fails its (zero) requests over
                self._die(f"grant wedged: {e}")
                return self
        if self.tracker is not None and self.monitor is None:
            from deeplearning4j_tpu_torch.parallel.cluster import (
                HeartbeatMonitor)

            monitor = HeartbeatMonitor(
                self.tracker, self.replica_id,
                interval_s=self.heartbeat_interval_s,
                payload_fn=self.heartbeat_payload).start()
            with self._monitor_lock:
                self.monitor = monitor
        stop = threading.Event()
        self._stop = stop

        def run():
            while not stop.is_set():
                try:
                    progressed = self.step_once()
                except BaseException as e:  # noqa: BLE001 — a dying
                    # replica must look dead (its beats stop: the monitor
                    # thread would keep a corpse "alive") and leave the
                    # reason for the eviction evidence
                    self._die(f"{type(e).__name__}: {e}")
                    return
                if not progressed:
                    time.sleep(self.poll_s)

        self._thread = threading.Thread(
            target=run, daemon=True, name=f"serve-{self.replica_id}")
        self._thread.start()
        return self

    def _die(self, reason: str) -> None:
        self.dead = True
        if self.dead_reason is None:  # first cause wins (a crash's
            self.dead_reason = reason  # exception beats a later evict)
        self._stop_beats()

    def _stop_beats(self) -> None:
        # the loop thread (a crash) and the controller (a kill) may both
        # get here: the lock makes one of them stop the monitor
        with self._monitor_lock:
            monitor, self.monitor = self.monitor, None
        if monitor is not None:
            monitor.stop()

    def kill(self, reason: str = "killed") -> None:
        """Make this replica dead the way a crashed one is — loop
        stopped, beats stopped, dead flag up. The controller's evict
        path calls this too: a silence-evicted replica may still be
        RUNNING, and its loop must not keep decoding requests the
        survivors now own."""
        if self._stop is not None:
            self._stop.set()
        self._die(reason)
        if (self._thread is not None
                and self._thread is not threading.current_thread()):
            self._thread.join(timeout=5.0)

    def wedge(self) -> None:
        """Test hook: alive-but-stuck. The loop stops making progress
        and the beats stop, but the dead flag stays down, so only
        heartbeat silence past the timeout catches it."""
        if self._stop is not None:
            self._stop.set()
        self._stop_beats()

    def retire(self) -> None:
        """Planned removal (graceful drain): clean shutdown PLUS the
        retired flag, so ``alive`` goes False — the router stops
        placing, the driver stops stepping — without the dead flag a
        crash would raise."""
        self.stop()
        self.retired = True

    def stop(self) -> None:
        """Clean shutdown (not an eviction): loop joined, beats off."""
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self._stop_beats()
