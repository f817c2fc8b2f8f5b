"""FleetRouter: the admission frontend in front of N replicas.

Copy of ``deeplearning4j_tpu/serving/fleet/router.py`` on the port's
modules (its replicas are port replicas; its spans feed the port's
flight recorder when ``DL4J_FLIGHT`` is on).

The serving counterpart of ``parallel/workrouter.py``'s dispatch
policies: where the training router decides when worker updates become
global parameters, the serve router decides which replica a request
lands on. Policy (stated so it can be changed deliberately):

- **least-loaded placement** — free-slots-first (a replica with an open
  slot starts decoding at its next step boundary; one with a deep queue
  makes the request wait), with a TTFT-aware tiebreak: at equal free
  slots the replica whose recent TTFT p50 is lower wins (it is
  admitting faster, whatever the reason), then replica id for
  determinism.
- **bounded queues + spill** — each replica's own admission queue bound
  (``DL4J_SERVE_MAX_QUEUE``) is the per-replica backpressure edge; a
  full replica spills to the next-least-loaded one, and only when EVERY
  alive replica is full does the router report a drop (open-loop load
  sheds it; the loadgen's drop series records when).
- **sticky affinity** — an in-flight stream never migrates (its slot
  holds its KV); optionally, a caller-provided ``affinity`` key pins
  future requests to the replica that served the key before (session
  cache reuse), falling back to least-loaded when that replica died.
- **failover** — when the controller evicts a replica, its unfinished
  requests requeue onto survivors with the prompt re-prefilled. Greedy
  streams keep the tokens already emitted; the survivor prefills the
  prompt and replays the emitted tokens through the decode step (the
  port's change: the reference re-prefills ``prompt + emitted``, which
  under bf16 rounds differently from the decode steps that first
  consumed them), so the continuation is the exact suffix the dead
  replica would have produced; sampled streams
  replay from scratch with the original seed (the per-request RNG chain
  is a pure function of the seed, so the replayed stream is identical
  too — it just cannot resume mid-chain). Either way a killed replica
  costs recompute, never tokens: completed output is token-identical
  to an unfailed run.

In a role-split fleet (any ``prefill`` replicas present) new requests
route to the least-loaded prefill replica, whose finished slab the
router then places on the least-loaded decode replica
(``place_handoff``), and failover re-enters the same pipeline.

Spans: every placement runs under ``serve.route`` and every eviction
recovery under ``serve.failover`` — both feed the flight recorder via
the standard span forwarding, so a postmortem can replay routing
decisions around a death.

Tensor-parallel replicas (``DecodeServer(mesh=)``, all over one mesh):
each rank of the ``model`` group holds its own copy of the fleet and
makes the same calls on it (submissions, steps, drains). Whatever a
routing decision reads that may differ between the ranks — a clock, a
TTFT sample, a follower server's verdict (a follower only records a
submission: rank 0's server decides it) — rank 0 decides and
broadcasts (:meth:`FleetRouter.agree`), so every rank places each
request, slab and job on the same replica and every rank's collectives
line up. Every time the router stamps is rank 0's clock
(:meth:`FleetRouter.now`), and so is a request's deadline. One-device
replicas may stand in such a fleet (slabs move to and from them whole);
each rank's copy of one serves on its own.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.monitor import metrics, tracer
from deeplearning4j_tpu_torch.serving.fleet.handoff import (
    SlotHandoff, export_live_slot, make_install)
from deeplearning4j_tpu_torch.serving.fleet.replica import ServeReplica
from deeplearning4j_tpu_torch.serving.scheduler import (
    CRITICALITIES, AdmissionVerdict, RetryBudget, ServeRequest,
    criticality_rank, serve_hedge_s, serve_replicas)

__all__ = ["FleetRequest", "FleetRouter", "FleetSaturated"]

_FLEET_IDS = itertools.count(1)


class FleetSaturated(RuntimeError):
    """Every alive replica's queue is at its bound."""


@dataclass
class FleetRequest:
    """One request at fleet level: survives replica failover by
    stitching the tokens emitted before the death (``emitted``) to the
    current replica-local segment (``inner``)."""

    prompt: np.ndarray
    max_new_tokens: int
    seed: int = 0
    affinity: Optional[str] = None
    # absolute deadline on the router's clock axis; None = no deadline
    deadline_s: Optional[float] = None
    criticality: str = "interactive"
    id: int = field(default_factory=lambda: next(_FLEET_IDS))
    replica_id: Optional[str] = None
    inner: Optional[ServeRequest] = None
    emitted: List[int] = field(default_factory=list)
    attempts: int = 0
    submit_s: Optional[float] = None
    _first_token_s: Optional[float] = None
    # a finished prefill slab waiting for decode headroom (split mode)
    _parked_handoff: Optional[SlotHandoff] = None
    # hedge copy: a second replica racing the same (greedy) stream for
    # a tail-latency-stuck interactive request; first winner cancels
    # the loser (token-identical, so either copy's output is THE output)
    hedge: Optional[ServeRequest] = None
    hedge_replica_id: Optional[str] = None
    # stamped when the fleet sheds the request (displacement victim or
    # past-deadline); mirrors the inner request's shed_reason when the
    # shed happened replica-side
    shed_reason: Optional[str] = None

    # stamped by the router when a requeue discovers everything was
    # already streamed before the death (no inner segment remains to
    # carry a finish timestamp)
    _finish_s: Optional[float] = None
    # retry-budget denial evidence is logged once per request
    _denied_logged: bool = False

    @property
    def tokens(self) -> List[int]:
        inner = self.inner.tokens if self.inner is not None else []
        return self.emitted + list(inner)

    @property
    def finished(self) -> bool:
        if (self.inner is None
                and len(self.emitted) >= self.max_new_tokens):
            # a failover found every token already emitted: complete
            # with no live segment
            return True
        return (self.inner is not None
                and self.inner.state == "finished"
                and len(self.tokens) >= self.max_new_tokens)

    @property
    def state(self) -> str:
        if self.finished:
            return "finished"
        if self.shed_reason is not None:
            return "shed"
        return "queued" if self.inner is None else self.inner.state

    @property
    def cost(self) -> int:
        """Work estimate for shedding decisions (same scale as
        ``ServeRequest.cost``)."""
        return int(self.prompt.size) + int(self.max_new_tokens)

    @property
    def first_token_s(self) -> Optional[float]:
        if self._first_token_s is not None:
            return self._first_token_s
        return None if self.inner is None else self.inner.first_token_s

    @property
    def finish_s(self) -> Optional[float]:
        if self._finish_s is not None:
            return self._finish_s
        return None if self.inner is None else self.inner.finish_s

    @property
    def ttft_s(self) -> Optional[float]:
        ft = self.first_token_s
        if self.submit_s is None or ft is None:
            return None
        return ft - self.submit_s

    @property
    def latency_s(self) -> Optional[float]:
        if self.submit_s is None or self.finish_s is None \
                or not self.finished:
            return None
        return self.finish_s - self.submit_s

    @property
    def output(self) -> np.ndarray:
        """``prompt + generated`` — the ``generate()`` shape, for the
        token-identity contract across failover."""
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens, self.prompt.dtype)])


class FleetRouter:
    """Route requests across replicas; requeue them across deaths."""

    @classmethod
    def build(cls, model, *, replicas: Optional[int] = None,
              tracker=None, role: Optional[str] = None,
              clock=time.monotonic, **server_kw) -> "FleetRouter":
        """Stand up a uniform in-process fleet: ``DL4J_SERVE_REPLICAS``
        (or ``replicas=``) workers named ``replica-<i>``, each reading
        its role from ``DL4J_SERVE_ROLE`` (or ``role=``) and its server
        config from the usual ``DL4J_SERVE_*`` knobs / ``server_kw``.
        The operator entry point the env rows document; callers needing
        heterogeneous roles construct :class:`ServeReplica` lists
        themselves."""
        n = replicas if replicas is not None else serve_replicas()
        if server_kw.get("mesh") is None:
            from deeplearning4j_tpu_torch.parallel.sharding_registry import (
                mesh_from_env)

            # one mesh for every replica: a model is placed on one mesh
            server_kw["mesh"] = mesh_from_env(device=server_kw.get("device"))
        reps = [ServeReplica(f"replica-{i}", model, tracker=tracker,
                             role=role, clock=clock, **server_kw)
                for i in range(n)]
        return cls(reps, clock=clock)

    def __init__(self, replicas: Sequence[ServeReplica], *,
                 clock=time.monotonic):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        ids = [r.replica_id for r in replicas]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate replica ids: {ids}")
        self.replicas = list(replicas)
        self._by_id: Dict[str, ServeReplica] = {
            r.replica_id: r for r in replicas}
        self.prefill_replicas = [r for r in replicas
                                 if r.role == "prefill"]
        self.decode_replicas = [r for r in replicas
                                if r.role in ("decode", "mixed")]
        if not self.decode_replicas:
            raise ValueError("a fleet needs at least one decode-capable "
                             "(mixed/decode) replica")
        self.split = bool(self.prefill_replicas)
        # tensor-parallel replicas: rank 0 of their model group decides
        # whatever may differ between the ranks (see agree)
        tp = [r.server for r in replicas if r.server.tensor_parallel]
        if len({id(srv.engine.mesh) for srv in tp}) > 1:
            raise ValueError(
                "the tensor-parallel replicas of one fleet must share one "
                "mesh: every rank holds the same fleet and rank 0 of its "
                "model group decides for all of them")
        self._tp = tp[0] if tp else None
        temps = {r.server.engine.temperature for r in replicas}
        if len(temps) > 1:
            raise ValueError(
                f"replicas disagree on sampling temperature ({temps}): "
                "failover token-identity needs one fleet-wide config")
        self.greedy = temps.pop() == 0.0
        # pool config must be fleet-uniform too: a failover continuation
        # or a handoff landing on a smaller/differently-quantized pool
        # would raise mid-recovery (or mid-step, killing a healthy
        # replica) — reject the misconfiguration at construction
        for attr in ("max_len", "kv_dtype"):
            vals = {getattr(r.server.engine, attr) for r in replicas}
            if len(vals) > 1:
                raise ValueError(
                    f"replicas disagree on {attr} ({vals}): failover "
                    "and handoff need one fleet-wide pool config")
        if self.prefill_replicas:
            spec = [r.replica_id for r in self.decode_replicas
                    if r.server.engine.spec]
            if spec:
                raise ValueError(
                    f"decode replicas {spec} run speculative decoding, "
                    "which cannot accept handoffs (no draft-pool prompt "
                    "K/V) — a split fleet needs non-speculative decode "
                    "replicas")
        self.clock = clock
        self.requests: List[FleetRequest] = []
        self._affinity: Dict[str, str] = {}
        # failover parking lot: requeues that found every survivor full
        # wait here and retry on the next controller tick / submission
        self._pending: List[FleetRequest] = []
        # overload control: per-class retry budget (failover re-dispatch,
        # spill probes past the first-ranked candidate, and hedges all
        # draw from it — bounding retry amplification under storm),
        # hedge latency threshold, quiesced replicas (draining: admit
        # nothing new), and the inner-request -> fleet-request index the
        # displacement/drain paths settle through
        self.retry_budget = RetryBudget()
        self.hedge_after_s = serve_hedge_s()
        self._quiesced: set = set()
        self._owner: Dict[int, FleetRequest] = {}
        self.shed_log: List[dict] = []
        self.hedge_log: List[dict] = []
        self.hedge_wins = 0
        self._lock = threading.RLock()
        self._reg = metrics()

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------
    def _alive_decode(self) -> List[ServeReplica]:
        return [r for r in self.decode_replicas
                if r.alive and r.replica_id not in self._quiesced]

    def _alive_prefill(self) -> List[ServeReplica]:
        return [r for r in self.prefill_replicas
                if r.alive and r.replica_id not in self._quiesced]

    @property
    def tensor_parallel(self) -> bool:
        """Whether the fleet holds tensor-parallel replicas."""
        return self._tp is not None

    @property
    def is_leader(self) -> bool:
        """Rank 0 of the TP replicas' ``model`` group, which decides for
        the fleet; True in a fleet of one-device replicas."""
        return self._tp is None or self._tp.is_leader

    def quiesce(self, replica_id: str) -> None:
        """Stop routing NEW work to ``replica_id`` (first step of a
        graceful drain): the replica keeps stepping its in-flight
        streams until ``migrate_out`` moves them, but placement,
        spill, hedging and affinity pinning all skip it."""
        with self._lock:
            self._quiesced.add(replica_id)
            self._affinity = {k: v for k, v in self._affinity.items()
                              if v != replica_id}

    def unquiesce(self, replica_id: str) -> None:
        """Route new work to a quiesced ``replica_id`` again."""
        with self._lock:
            self._quiesced.discard(replica_id)

    def agree(self, value):
        """Rank 0's ``value`` in every rank of a fleet of tensor-parallel
        replicas (a collective over their ``model`` group); ``value``
        itself otherwise."""
        return value if self._tp is None else self._tp.agree(value)

    def _agreed(self, replicas: List[ServeReplica]) -> List[ServeReplica]:
        """Rank 0's ordering of ``replicas`` in every rank."""
        if self._tp is None:
            return replicas
        return [self._by_id[rid]
                for rid in self.agree([r.replica_id for r in replicas])]

    def now(self) -> float:
        """The router's clock: rank 0's in every rank of a fleet of
        tensor-parallel replicas (their clocks have unrelated offsets)."""
        return self.agree(self.clock())

    def _try_submit(self, r: ServeReplica, prompt, max_new_tokens: int, *,
                    seed: int, deadline_s, criticality: str,
                    displace: bool, replay: int = 0) -> AdmissionVerdict:
        """``r.server.try_submit`` with rank 0's verdict when ``r`` is
        tensor-parallel."""
        return r.server.agreed_verdict(r.server.try_submit(
            prompt, max_new_tokens, seed=seed, deadline_s=deadline_s,
            criticality=criticality, displace=displace, replay=replay))

    @staticmethod
    def _rank(replicas: List[ServeReplica]) -> List[ServeReplica]:
        """Least-loaded first: headroom = free slots MINUS queued
        requests (queued work claims a slot at the next boundary — free
        slots alone would send a whole arrival burst to one replica,
        since admission only moves the count at step boundaries), then
        recent TTFT p50 ascending (no samples = no traffic yet = 0, so
        fresh replicas absorb load), then id for determinism."""
        return sorted(replicas,
                      key=lambda r: (-(r.server.free_slot_count()
                                       - r.queue_depth()),
                                     r.ttft_p50() or 0.0,
                                     r.replica_id))

    def submit(self, prompt, max_new_tokens: int, *, seed: int = 0,
               affinity: Optional[str] = None,
               deadline_s: Optional[float] = None,
               criticality: str = "interactive") -> FleetRequest:
        """Admit one request into the fleet; raises
        :class:`FleetSaturated` when every alive replica is full."""
        freq = self.try_submit(prompt, max_new_tokens, seed=seed,
                               affinity=affinity, deadline_s=deadline_s,
                               criticality=criticality)
        if freq is None:
            raise FleetSaturated(
                "every alive replica's queue is at its bound")
        return freq

    def try_submit(self, prompt, max_new_tokens: int, *, seed: int = 0,
                   affinity: Optional[str] = None,
                   deadline_s: Optional[float] = None,
                   criticality: str = "interactive"
                   ) -> Optional[FleetRequest]:
        """Non-raising admission: ``None`` means the fleet shed the
        request (every alive replica full, even after criticality
        displacement) — open-loop callers record the drop and move on.
        ``deadline_s`` is ABSOLUTE on the router's clock axis (rank 0's
        in a fleet of tensor-parallel replicas)."""
        criticality_rank(criticality)     # fail fast on a typo'd class
        with self._lock:
            self.retry_pending()
            # rank 0's clock and deadline in every rank (see now)
            submit_s, deadline_s = self.agree((self.clock(), deadline_s))
            freq = FleetRequest(
                prompt=np.asarray(prompt, np.int32).reshape(-1),
                max_new_tokens=int(max_new_tokens), seed=int(seed),
                affinity=affinity, deadline_s=deadline_s,
                criticality=criticality)
            freq.submit_s = submit_s
            # every accepted submission funds future retries for its
            # class — the token-bucket side of the retry-amplification
            # bound (retries <= ratio * submissions + burst)
            self.retry_budget.deposit(criticality)
            self._publish_budget()
            if self._place(freq, freq.prompt, freq.max_new_tokens):
                self.requests.append(freq)
                return freq
            self._reg.counter("serve_route_total").inc(outcome="dropped")
            if freq.shed_reason is None:
                # fleet-level decision (every replica full even after
                # displacement); past-deadline sheds were already
                # evidence-logged by the replica that refused them
                freq.shed_reason = "fleet_saturated"
                decision = {"request": freq.id,
                            "criticality": criticality,
                            "where": "admission",
                            "reason": "fleet_saturated",
                            "t": freq.submit_s}
                self.shed_log.append(decision)
                tracer().event("serve.shed", **decision)
            return None

    def _publish_budget(self) -> None:
        for c in CRITICALITIES:
            self._reg.gauge("serve_retry_budget_remaining").set(
                self.retry_budget.remaining(c), criticality=c)

    def _place(self, freq: FleetRequest, prompt,
               max_new_tokens: int) -> bool:
        """One routing decision under a ``serve.route`` span: prefill
        pipeline in split mode, else direct decode placement with
        affinity-first + least-loaded + spill."""
        # a greedy continuation's prompt ends with the emitted tokens,
        # which the admission replays through the decode step (the port's
        # change: the reference re-prefills them, which under bf16 may not
        # reproduce the unfailed stream)
        replay = len(freq.emitted)
        with tracer().span("serve.route", request=freq.id) as sp:
            if self.split:
                # the mixed path gets this check from try_submit; the
                # prefill pipeline builds its ServeRequest directly, so
                # validate here or an oversized request would scatter
                # past T_max on the decode side (silently clipped) —
                # or kill a prefill replica's worker thread
                total = int(np.asarray(prompt).size) + max_new_tokens
                cap = self.decode_replicas[0].server.max_len
                if total > cap:
                    raise ValueError(
                        f"prompt_len + max_new_tokens = {total} exceeds "
                        f"the fleet's slot capacity max_len={cap}")
                # each prefill replica's job queue is bounded by the
                # same DL4J_SERVE_MAX_QUEUE edge as decode admission —
                # without it, split-mode overload would grow host
                # memory (queued prompts + parked slabs) without ever
                # shedding, while a mixed fleet correctly drops
                pre = self._agreed([r for r in sorted(
                    self._alive_prefill(),
                    key=lambda r: (r.queue_depth(), r.replica_id))
                    if r.queue_depth() < r.server.queue.max_depth])
                if not pre:
                    sp.attrs["outcome"] = "prefill_saturated"
                    return False
                req = ServeRequest(
                    prompt=np.asarray(prompt, np.int32).reshape(-1),
                    max_new_tokens=max_new_tokens, seed=freq.seed,
                    deadline_s=freq.deadline_s,
                    criticality=freq.criticality, replay=replay)
                req.submit_s = freq.submit_s
                freq.inner = req
                freq.replica_id = pre[0].replica_id
                freq.attempts += 1
                self._owner[req.id] = freq
                pre[0].enqueue_prefill(freq, self.place_handoff)
                sp.attrs.update(outcome="prefill",
                                replica=pre[0].replica_id)
                self._reg.counter("serve_route_total").inc(
                    outcome="prefill")
                return True
            cands = self._rank(self._alive_decode())
            if freq.affinity is not None:
                pinned = self._by_id.get(self._affinity.get(freq.affinity))
                if pinned is not None and pinned.alive:
                    cands = [pinned] + [r for r in cands if r is not pinned]
            cands = self._agreed(cands)
            # pass 1: plain spill — least-loaded first, no one harmed
            spilled = 0
            for r in cands:
                verdict = self._try_submit(
                    r, prompt, max_new_tokens, seed=freq.seed,
                    deadline_s=freq.deadline_s,
                    criticality=freq.criticality, displace=False,
                    replay=replay)
                if verdict.admitted:
                    self._settle_placement(freq, r, verdict)
                    sp.attrs.update(outcome="placed",
                                    replica=r.replica_id,
                                    spilled=spilled,
                                    queue_depth=verdict.queue_depth)
                    self._reg.counter("serve_route_total").inc(
                        outcome="placed")
                    if spilled:
                        self._reg.counter(
                            "fleet_serve_spills_total").inc(spilled)
                    return True
                if verdict.reason == "expired":
                    # the replica shed it at admission (past deadline) —
                    # probing further replicas cannot un-expire it
                    freq.shed_reason = "deadline"
                    freq._finish_s = self.now()
                    sp.attrs["outcome"] = "expired"
                    return False
                spilled += 1
            # pass 2: criticality displacement — every queue is at its
            # bound, so try to buy a seat by shedding the costliest
            # queued request of a STRICTLY lower class (the replica
            # picks the victim; same-or-higher class is never
            # displaced, so an all-interactive overload still sheds
            # the newcomer, not a peer)
            for r in cands:
                verdict = self._try_submit(
                    r, prompt, max_new_tokens, seed=freq.seed,
                    deadline_s=freq.deadline_s,
                    criticality=freq.criticality, displace=True,
                    replay=replay)
                if verdict.admitted:
                    if verdict.displaced is not None:
                        self._on_displaced(verdict.displaced, freq)
                    self._settle_placement(freq, r, verdict)
                    sp.attrs.update(outcome="displaced",
                                    replica=r.replica_id,
                                    spilled=spilled)
                    self._reg.counter("serve_route_total").inc(
                        outcome="placed")
                    return True
            sp.attrs.update(outcome="saturated", spilled=spilled)
            return False

    def _settle_placement(self, freq: FleetRequest, r: ServeReplica,
                          verdict) -> None:
        freq.inner = verdict.request
        freq.replica_id = r.replica_id
        freq.attempts += 1
        self._owner[verdict.request.id] = freq
        if freq.affinity is not None:
            self._affinity[freq.affinity] = r.replica_id

    def _on_displaced(self, victim: ServeRequest,
                      by: FleetRequest) -> None:
        """Settle a displacement victim at fleet level. The replica
        already marked it shed and logged the evidence; here the owning
        :class:`FleetRequest` (if fleet-routed) drops its claim: a shed
        hedge copy just disappears (the primary still runs), a shed
        primary marks the whole fleet request shed and cancels any
        hedge it had in flight."""
        fr = self._owner.pop(victim.id, None)
        self._reg.counter("fleet_serve_displacements_total").inc(
            victim=victim.criticality, by=by.criticality)
        if fr is None:
            return
        if fr.hedge is victim:
            fr.hedge = None
            fr.hedge_replica_id = None
            return
        fr.shed_reason = victim.shed_reason or "shed_overload"
        self._pending = [p for p in self._pending if p is not fr]
        if fr.hedge is not None:
            self._cancel_inner(fr.hedge, fr.hedge_replica_id)
            fr.hedge = None
            fr.hedge_replica_id = None

    def place_handoff(self, freq: FleetRequest,
                      handoff: SlotHandoff) -> bool:
        """Place a prefilled slab on the least-loaded decode replica
        (headroom = free slots minus already-queued handoffs); parks the
        request for retry when every decode replica is packed."""
        with self._lock, tracer().span("serve.handoff",
                                       request=freq.id) as sp:
            target = self._handoff_target()
            if target is not None:
                target.server.admit_external(freq.inner,
                                             make_install(handoff))
                freq.replica_id = target.replica_id
                sp.attrs.update(outcome="placed", replica=target.replica_id)
                return True
            # no headroom anywhere: hold the finished prefill and retry
            # at the next tick (the slab is host-resident — it costs
            # memory, not a slot)
            freq._parked_handoff = handoff
            # by identity: FleetRequest's field-wise == compares prompt
            # arrays, which raises (the reference's `freq not in` does)
            if not any(p is freq for p in self._pending):
                self._pending.append(freq)
            sp.attrs["outcome"] = "parked"
            return False

    def _handoff_target(self) -> Optional[ServeReplica]:
        """The non-speculative decode replica with the most handoff
        headroom (then id), rank 0's in every rank; None when none has
        any."""
        cands = sorted(
            (r for r in self._alive_decode()
             if not r.server.engine.spec
             and r.server.handoff_headroom() > 0),
            key=lambda r: (-r.server.handoff_headroom(), r.replica_id))
        rid = self.agree(cands[0].replica_id if cands else None)
        return None if rid is None else self._by_id[rid]

    # ------------------------------------------------------------------
    # failover
    # ------------------------------------------------------------------
    def failover(self, replica_id: str, *,
                 reason: str = "evicted") -> dict:
        """Requeue the dead replica's unfinished requests onto
        survivors. Returns a summary for the eviction evidence log."""
        with self._lock, tracer().span("serve.failover",
                                       replica=replica_id,
                                       reason=reason) as sp:
            victims = [fr for fr in self.requests
                       if fr.replica_id == replica_id and not fr.finished]
            # a victim may ALSO sit in the parking lot (its handoff
            # found no headroom before the death): drop it there first,
            # or the next retry would place the same request twice
            drop = set(map(id, victims))
            self._pending = [fr for fr in self._pending
                             if id(fr) not in drop]
            requeued = parked = 0
            for fr in victims:
                if self._requeue(fr):
                    requeued += 1
                else:
                    parked += 1
            sp.attrs.update(requeued=requeued, parked=parked)
            if victims:
                self._reg.counter(
                    "fleet_serve_failover_requests_total").inc(
                    len(victims))
            return {"victims": len(victims), "requeued": requeued,
                    "parked": parked}

    def _requeue(self, fr: FleetRequest, *, charge: bool = True) -> bool:
        inner = fr.inner
        if self.greedy and inner is not None and inner.tokens:
            # keep what was already streamed; prefill the prompt and
            # replay the prefix through the decode step (``replay``), so
            # the continuation is the exact suffix of the unfailed stream
            fr._first_token_s = fr.first_token_s
            fr.emitted.extend(inner.tokens)
        else:
            # sampled (or nothing emitted): replay from scratch with the
            # original seed — the per-request RNG chain is a pure
            # function of the seed, so the replayed stream is identical
            fr.emitted = []
            fr._first_token_s = None
        fr.inner = None
        fr.replica_id = None
        fr._parked_handoff = None
        if len(fr.emitted) >= fr.max_new_tokens:
            # everything already streamed before the death (e.g. a
            # prefill-complete max_new=1 request whose handoff never
            # installed): complete it here — no survivor has work to do
            fr._finish_s = self.now()
            return True
        return self._place_continuation(fr, charge=charge)

    def _place_continuation(self, fr: FleetRequest, *,
                            charge: bool = True) -> bool:
        """Re-dispatch a failed-over request. ``charge=True`` draws one
        token from the class's retry budget — spent only when the
        placement actually lands (a re-dispatch is the recompute the
        budget bounds; a parked request costs nothing until it does).
        A dry budget parks the request instead of re-dispatching it:
        under storm, retries must not amplify load past the bound.
        ``charge=False`` is for drain migrations — deliberate operator
        moves, not retries."""
        if charge and not self.retry_budget.has(fr.criticality):
            if not fr._denied_logged:     # once per request, not per tick
                fr._denied_logged = True
                self._reg.counter("serve_retry_denied_total").inc(
                    kind="failover", criticality=fr.criticality)
                tracer().event("serve.retry_denied", request=fr.id,
                               kind="failover",
                               criticality=fr.criticality,
                               t=self.now())
            self._pending.append(fr)
            return False
        prompt = (np.concatenate(
            [fr.prompt, np.asarray(fr.emitted, np.int32)])
            if fr.emitted else fr.prompt)
        remaining = fr.max_new_tokens - len(fr.emitted)
        if self._place(fr, prompt, remaining):
            if charge:
                self.retry_budget.try_spend(fr.criticality)
                self._publish_budget()
            return True
        if fr.shed_reason is not None:
            # the placement attempt discovered the deadline passed —
            # the request is shed, not parked
            return False
        self._pending.append(fr)
        return False

    def retry_pending(self) -> int:
        """Drain the failover parking lot (called on every tick and
        submission); returns how many found a home. Failures re-park
        themselves (``place_handoff`` / ``_place_continuation`` both
        append back on a miss); past-deadline parkers shed instead of
        retrying — the earliest point that looks at a parked deadline."""
        with self._lock:
            now = self.now()
            pending, self._pending = self._pending, []
            placed = 0
            for fr in pending:
                if fr.deadline_s is not None and now > fr.deadline_s:
                    self._shed_fleet(fr, where="parked",
                                     reason="deadline")
                    continue
                handoff, fr._parked_handoff = fr._parked_handoff, None
                if handoff is not None:
                    ok = self.place_handoff(fr, handoff)
                else:
                    ok = self._place_continuation(fr)
                placed += int(ok)
            return placed

    def _shed_fleet(self, fr: FleetRequest, *, where: str,
                    reason: str) -> None:
        """Shed a request the fleet (not a replica) owns right now —
        same evidence shape as the replica-side shed."""
        fr.shed_reason = reason
        fr._finish_s = self.now()
        fr._parked_handoff = None
        decision = {"request": fr.id, "criticality": fr.criticality,
                    "where": where, "reason": reason, "t": fr._finish_s}
        self.shed_log.append(decision)
        self._reg.counter("serve_shed_total").inc(
            criticality=fr.criticality, where=where)
        tracer().event("serve.shed", **decision)

    # ------------------------------------------------------------------
    # hedging
    # ------------------------------------------------------------------
    def maybe_hedge(self) -> int:
        """Tail-latency hedging pass (called from the controller tick
        and the load driver's event loop): an ``interactive`` request
        still QUEUED ``hedge_after_s`` after submit places a second
        copy on a different replica — greedy token identity makes both
        copies produce THE stream, so whichever starts first wins and
        the loser cancels. Hedges draw from the interactive retry
        budget (a hedge is speculative extra load; under storm the
        budget keeps it from amplifying the overload). Also reconciles
        existing hedge pairs. Returns how many new hedges were placed.

        Disabled unless ``DL4J_SERVE_HEDGE_S`` (or ``hedge_after_s``)
        is set — and meaningless for sampled fleets, where the two
        copies would diverge, so it refuses those at the gate."""
        with self._lock:
            for fr in self.requests:
                if fr.hedge is not None:
                    self._reconcile_hedge(fr)
            if self.hedge_after_s is None or not self.greedy:
                return 0
            now = self.now()
            placed = 0
            for fr in self.requests:
                if (fr.criticality != "interactive"
                        or fr.hedge is not None
                        or fr.inner is None
                        or fr.inner.state != "queued"
                        or fr.shed_reason is not None
                        or fr.submit_s is None
                        or now - fr.submit_s < self.hedge_after_s):
                    continue
                if fr.deadline_s is not None and now > fr.deadline_s:
                    continue        # the expiry sweeps will shed it
                if not self.retry_budget.try_spend("interactive"):
                    break           # budget dry: no hedging this pass
                self._publish_budget()
                placed += int(self._place_hedge(fr, now))
            return placed

    def _place_hedge(self, fr: FleetRequest, now: float) -> bool:
        cands = self._agreed([r for r in self._rank(self._alive_decode())
                              if r.replica_id != fr.replica_id])
        for r in cands[:1]:       # one extra bet, on the best candidate
            verdict = self._try_submit(
                r, fr.prompt, fr.max_new_tokens, seed=fr.seed,
                deadline_s=fr.deadline_s, criticality=fr.criticality,
                displace=False)   # a hedge must not shed anyone
            if verdict.admitted:
                fr.hedge = verdict.request
                fr.hedge_replica_id = r.replica_id
                self._owner[verdict.request.id] = fr
                ev = {"request": fr.id, "from": fr.replica_id,
                      "to": r.replica_id, "t": now}
                self.hedge_log.append(ev)
                self._reg.counter("fleet_serve_hedges_total").inc()
                tracer().event("serve.hedge", **ev)
                return True
        # nowhere to hedge: the spent token goes back
        self.retry_budget.refund("interactive")
        self._publish_budget()
        return False

    def _reconcile_hedge(self, fr: FleetRequest) -> None:
        """First winner cancels the loser: whichever copy reached a
        slot (running/finished) first keeps the stream; the other is
        canceled (pulled from its queue, or flagged for the server's
        cancel sweep if already in a slot)."""
        pri, h = fr.inner, fr.hedge
        if h is None:
            return
        if h.state in ("shed", "canceled"):
            self._owner.pop(h.id, None)
            fr.hedge = None
            fr.hedge_replica_id = None
            return
        if pri is None or pri.state in ("shed", "canceled"):
            self._promote_hedge(fr)
            return
        if pri.state == "finished":
            # primary delivered the stream: the hedge copy is moot
            if h.state != "finished":
                self._cancel_inner(h, fr.hedge_replica_id)
            else:
                self._owner.pop(h.id, None)
            fr.hedge = None
            fr.hedge_replica_id = None
            return
        pri_live = pri.state == "running"
        h_live = h.state in ("running", "finished")
        if h_live and not pri_live:
            # hedge won the race: primary is still queued — cancel it
            # and promote the hedge to be THE segment
            self._cancel_inner(pri, fr.replica_id)
            self._promote_hedge(fr)
            self.hedge_wins += 1
            self._reg.counter("fleet_serve_hedge_wins_total").inc()
            self._reg.gauge("serve_hedge_wins").set(
                float(self.hedge_wins))
            tracer().event("serve.hedge_win", request=fr.id,
                           replica=fr.replica_id, t=self.now())
            return
        if pri_live and not h_live:
            # primary won: drop the hedge copy
            self._cancel_inner(h, fr.hedge_replica_id)
            fr.hedge = None
            fr.hedge_replica_id = None
        # both queued (keep racing) or both live (greedy token identity:
        # let the primary finish; the hedge cancels on the next pass
        # once the primary is done) — nothing to do this pass

    def _promote_hedge(self, fr: FleetRequest) -> None:
        if fr.inner is not None:
            self._owner.pop(fr.inner.id, None)
        fr.inner = fr.hedge
        fr.replica_id = fr.hedge_replica_id
        fr.hedge = None
        fr.hedge_replica_id = None

    def _cancel_inner(self, req: ServeRequest,
                      replica_id: Optional[str]) -> None:
        """Cancel one replica-local segment: flag it (the server's
        sweep retires a running slot) and best-effort pull it from the
        admission queue so it stops holding a seat."""
        req.canceled = True
        self._owner.pop(req.id, None)
        r = self._by_id.get(replica_id) if replica_id else None
        if r is not None and req.state == "queued":
            if r.server.withdraw(req):
                req.state = "canceled"

    # ------------------------------------------------------------------
    # graceful drain
    # ------------------------------------------------------------------
    def migrate_out(self, replica_id: str) -> dict:
        """Move every request off a RETIRED replica with zero recompute
        and zero lost tokens — the drain counterpart of :meth:`failover`
        (which re-prefills because a dead replica's KV is gone; a
        drained replica's KV is intact, so live slots export wholesale
        via :func:`export_live_slot`). The replica's step loop must be
        stopped (``retire()``) before calling: the export reads device
        state that a concurrent step would advance.

        Three populations, in order: parked prefill handoffs re-home
        directly (the slab is already host-resident); queued-never-
        admitted requests re-place on survivors (nothing was computed,
        so nothing is recomputed); live slots export mid-stream and
        re-enter through the handoff install path. Hedge copies on the
        draining replica are dropped, not moved (the primary still
        runs — a hedge is redundant by construction). Speculative
        survivors cannot accept handoffs; when no non-spec survivor
        exists the live slots fall back to failover re-prefill,
        reported as ``fallback_failovers`` (recompute, never tokens).

        A tensor-parallel replica drains in every rank together: rank 0
        names the queued requests (a follower's server only recorded
        them), the live slots export by gathering the ranks' heads, and
        every survivor is rank 0's choice."""
        victim = self._by_id.get(replica_id)
        if victim is None:
            raise KeyError(f"unknown replica {replica_id!r}")
        server = victim.server
        with self._lock:
            moved_handoffs = moved_queued = moved_live = 0
            dropped_hedges = fallback = 0
            # (i) parked prefill handoffs queued on the victim
            while server._handoffs:
                req, install = server._handoffs.popleft()
                fr = self._owner.get(req.id)
                target = self._handoff_target()
                if target is not None:
                    target.server.admit_external(req, install)
                    if fr is not None:
                        fr.replica_id = target.replica_id
                    moved_handoffs += 1
                elif fr is not None:
                    # no headroom anywhere right now: the install
                    # closure owns the slab, so we cannot re-park it
                    # fleet-side — fall back to re-prefill (recompute,
                    # never tokens)
                    fr.inner = req
                    self._requeue(fr, charge=False)
                    fallback += 1
            # (ii) queued, never admitted: re-place (zero compute done,
            # zero recomputed); drain moves are deliberate, not retries
            for req in server.pop_queued():
                fr = self._owner.get(req.id)
                if fr is None:
                    continue          # direct server user; nothing to do
                if fr.hedge is req:
                    self._owner.pop(req.id, None)
                    fr.hedge = None
                    fr.hedge_replica_id = None
                    dropped_hedges += 1
                    continue
                self._owner.pop(req.id, None)
                fr.inner = None
                fr.replica_id = None
                if self._place_continuation(fr, charge=False):
                    moved_queued += 1
            # (iii) live slots: export mid-stream KV + cursor + RNG and
            # re-install on a survivor — the zero-recompute move
            non_spec = [r for r in self._alive_decode()
                        if not r.server.engine.spec]
            for slot in list(server._live_slots()):
                req = server._slot_req[slot]
                fr = self._owner.get(req.id)
                if fr is None:
                    continue
                if fr.hedge is req:
                    self._owner.pop(req.id, None)
                    fr.hedge = None
                    fr.hedge_replica_id = None
                    dropped_hedges += 1
                    server._slot_req[slot] = None
                    continue
                if not non_spec:
                    # no survivor can install a handoff: failover-style
                    # re-prefill (costs recompute, never tokens)
                    self._owner.pop(req.id, None)
                    server._slot_req[slot] = None
                    self._requeue(fr, charge=False)
                    fallback += 1
                    continue
                handoff = export_live_slot(server, slot)
                # detach WITHOUT retiring: the stream continues
                # elsewhere (same ServeRequest object, same tokens
                # list), this replica just stops owning it
                server._slot_req[slot] = None
                fr.replica_id = None
                self.place_handoff(fr, handoff)
                moved_live += 1
            return {"handoffs": moved_handoffs, "queued": moved_queued,
                    "live": moved_live, "dropped_hedges": dropped_hedges,
                    "fallback_failovers": fallback}

    # ------------------------------------------------------------------
    def unfinished(self) -> List[FleetRequest]:
        with self._lock:
            return [fr for fr in self.requests if not fr.finished]

    def stats(self) -> dict:
        with self._lock:
            return {
                "replicas": len(self.replicas),
                "alive": sum(1 for r in self.replicas if r.alive),
                "split": self.split,
                "requests": len(self.requests),
                "finished": sum(1 for fr in self.requests if fr.finished),
                "pending_failover": len(self._pending),
                "quiesced": sorted(self._quiesced),
                "shed": len(self.shed_log),
                "hedges": len(self.hedge_log),
                "hedge_wins": self.hedge_wins,
                "retry_budget": {c: self.retry_budget.remaining(c)
                                 for c in CRITICALITIES},
            }
