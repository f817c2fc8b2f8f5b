"""DecodeServer: continuous batching over the slot pool.

Port of ``deeplearning4j_tpu/serving/server.py``. The loop, per
``step()`` (a step is a fusion boundary):

1. **admit** — handed-off slabs first (``admit_external``: their prefill
   ran on another replica), then queued requests into free slots; each
   admission runs the bucket-padded prefill (``serve.prefill`` span),
   records TTFT, and may retire at once when ``max_new_tokens == 1``.
2. **decode** — if any slot is live, run ONE decode dispatch: the single
   step (``fuse_steps=1``), K fused steps, or K speculative rounds when a
   draft is configured. Every live slot appends up to its remaining
   tokens; finished requests retire and free their slots.

The host reads back one token block per dispatch ([S] at K=1, [K, S]
fused, [K, S, G+2] speculative); that readback is the loop's
synchronisation point. Deadlines, criticality shedding and the bounded
queue behave as in the reference.

Tensor-parallel serving (``mesh=``, or ``DL4J_MESH_SHAPE`` /
``DL4J_TP_SHARDS`` through ``mesh_from_env`` when no mesh is passed):
every rank of the ``model`` axis runs its own copy of this loop, and
each ``step()`` is collective. Whatever the loop decides from a clock
(deadlines, shedding, admissions) rank 0 decides: at each step it
broadcasts its decisions since the last one (sheds, cancels,
rejections) and the step's admissions, with the requests themselves,
and the other ranks apply them, so every rank runs the same prefills
and decodes. A follower's own ``submit`` only records its request;
its state follows rank 0's. A handed-off slab (``admit_external``) is
one more submission: every rank is handed the same slab in the same
order, and rank 0 decides which slot it lands in and at which step, so
every rank installs its heads of it together. ``drain`` and
``loadgen.run_open_loop`` take rank 0's view of when to stop and of
which arrivals are due.

Randomness: a sampled request draws from a ``torch.Generator`` seeded
with its seed; a speculative server gives it a second one for the draft's
proposals, seeded with :func:`draft_seed` of the same seed (the reference
folds ``0x5bec`` into the request's key instead).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Deque, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.monitor import metrics, tracer
from deeplearning4j_tpu_torch.serving.engine import DecodeEngine
from deeplearning4j_tpu_torch.serving.scheduler import (
    AdmissionVerdict, RequestQueue, ServeQueueFull, ServeRequest,
    criticality_rank, serve_deadline_s, serve_draft_layers,
    serve_fuse_steps, serve_kv_dtype, serve_max_queue, serve_slots)

__all__ = ["DecodeServer", "draft_seed"]

_MASK64 = (1 << 64) - 1

_LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                    float("inf"))


def draft_seed(seed: int) -> int:
    """The seed of a request's draft generator: splitmix64's finaliser of
    the request's seed plus ``0x5bec`` golden-ratio increments, in
    [0, 2**63). A fixed function of the seed, so a sampled speculative
    stream is a pure function of the request's seed."""
    z = (int(seed) + 0x5bec * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


class DecodeServer:
    """Slot-batched online decode server for a :class:`TransformerLM`.
    ``device=None`` means the card, as for :class:`DecodeEngine`."""

    def __init__(self, model, *, slots: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 max_len: Optional[int] = None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 buckets: Optional[Sequence[int]] = None,
                 fuse_steps: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 draft_model=None, draft_layers: Optional[int] = None,
                 spec_tokens: int = 3, mesh=None, device=None,
                 clock=time.monotonic):
        self.fuse_steps = (fuse_steps if fuse_steps is not None
                           else serve_fuse_steps())
        if self.fuse_steps < 1:
            raise ValueError(f"fuse_steps={fuse_steps} must be >= 1")
        if mesh is None:
            from deeplearning4j_tpu_torch.parallel.sharding_registry import (
                mesh_from_env)

            mesh = mesh_from_env(device=device)
        self.engine = DecodeEngine(
            model, slots if slots is not None else serve_slots(),
            max_len=max_len, temperature=temperature, top_k=top_k,
            buckets=buckets,
            kv_dtype=kv_dtype if kv_dtype is not None else serve_kv_dtype(),
            draft_model=draft_model,
            draft_layers=(draft_layers if draft_layers is not None
                          else (0 if draft_model is not None
                                else serve_draft_layers())),
            spec_tokens=spec_tokens, mesh=mesh, device=device)
        self.model = model
        self.slots = self.engine.slots
        self.max_len = self.engine.max_len
        self.queue = RequestQueue(
            max_queue if max_queue is not None else serve_max_queue())
        self.clock = clock
        self._slot_req: List[Optional[ServeRequest]] = [None] * self.slots
        self._last_tok = np.zeros(self.slots, np.int64)
        self._last_tok_s = np.zeros(self.slots, np.float64)
        # per-slot sampling streams (None for greedy servers and free slots)
        self._gens: List[Optional[torch.Generator]] = [None] * self.slots
        self._draft_gens: List[Optional[torch.Generator]] = \
            [None] * self.slots
        # externally prefilled requests waiting for a free slot: each entry
        # carries an ``install(engine, slot) -> (last_tok, generator)``
        # that lands the handed-off slab and cursor in the slot
        # (serving/fleet/handoff.py builds these)
        self._handoffs: Deque[Tuple[ServeRequest, Callable]] = deque()
        self.finished: List[ServeRequest] = []
        self.shed: List[ServeRequest] = []
        self.shed_log: List[dict] = []
        self.shed_by_class: dict = {}
        self.expired_in_queue = 0
        self.expired_in_flight = 0
        self.steps = 0
        self.decode_tokens = 0
        self.slot_dispatches = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self._reg = metrics()
        # tensor-parallel serving: rank 0 of the model axis decides
        self._group = None
        self._leader = True
        self._seq = 0                 # submissions so far, the same in
        #                               every rank of a mesh server
        self._by_seq: dict = {}       # a follower's undecided requests
        self._log: List[tuple] = []   # rank 0's decisions since a step
        if mesh is not None:
            from deeplearning4j_tpu_torch.parallel.mesh import (
                MODEL_AXIS, axis_group, axis_rank)

            self._group = axis_group(mesh, MODEL_AXIS)
            self._leader = axis_rank(mesh, MODEL_AXIS) == 0

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, *, seed: int = 0,
               deadline_s: Optional[float] = None,
               criticality: str = "interactive") -> ServeRequest:
        """Enqueue one request; raises :class:`ServeQueueFull` at the
        queue bound."""
        verdict = self.try_submit(prompt, max_new_tokens, seed=seed,
                                  deadline_s=deadline_s,
                                  criticality=criticality)
        if not verdict.admitted:
            raise ServeQueueFull(
                f"serve queue at max depth {self.queue.max_depth}")
        return verdict.request

    def try_submit(self, prompt, max_new_tokens: int, *,
                   seed: int = 0,
                   deadline_s: Optional[float] = None,
                   criticality: str = "interactive",
                   displace: bool = True,
                   replay: int = 0) -> AdmissionVerdict:
        """Non-blocking ``submit`` returning an :class:`AdmissionVerdict`.
        Malformed requests raise. ``deadline_s`` is the ABSOLUTE expiry
        on this server's clock (None: ``DL4J_SERVE_DEADLINE_S`` as a
        budget from now); at the queue bound ``displace=True`` sheds the
        costliest queued request of a strictly lower class. ``replay``:
        the prompt's last tokens were emitted by the stream already (a
        greedy failover continuation, see :meth:`DecodeEngine.prefill`)."""
        criticality_rank(criticality)
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.shape[0] < 1:
            raise ValueError("prompt must hold at least one token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = int(prompt.shape[0]) + max_new_tokens
        # the speculative verify writes up to spec_tokens candidate K/V
        # past the live cursor, so the slot needs that slack in the pool
        slack = self.engine.spec_tokens if self.engine.spec else 0
        if total + slack > self.max_len:
            raise ValueError(
                f"prompt_len + max_new_tokens = {total}"
                + (f" (+ {slack} speculative slack)" if slack else "")
                + f" exceeds the server's slot capacity "
                f"max_len={self.max_len}")
        now = self.clock()
        if deadline_s is None:
            budget = serve_deadline_s()
            deadline_s = None if budget is None else now + budget
        req = ServeRequest(prompt=prompt, max_new_tokens=max_new_tokens,
                           seed=seed, deadline_s=deadline_s,
                           criticality=criticality, replay=int(replay))
        req.submit_s = now
        if self._group is not None:
            req.mesh_seq = self._seq
            self._seq += 1
            if not self._leader:  # its fate is rank 0's to decide
                old = self._by_seq.get(req.mesh_seq)
                if old is None:
                    self._by_seq[req.mesh_seq] = req
                elif old.state != "running":  # rank 0 admitted it first
                    del self._by_seq[req.mesh_seq]
                return AdmissionVerdict(admitted=True, request=old or req,
                                        queue_depth=len(self.queue))
        if req.expired(now):
            self._shed(req, where="admission", reason="deadline", now=now)
            self._reg.counter("serve_requests_total").inc(event="rejected")
            return AdmissionVerdict(admitted=False, reason="expired",
                                    queue_depth=len(self.queue))
        victim = None
        if not self.queue.try_push(req):
            admitted = False
            if displace:
                admitted, victim = self.queue.displace(req)
            if not admitted:
                self._note("rejected", req)
                self._reg.counter("serve_requests_total").inc(
                    event="rejected")
                return AdmissionVerdict(admitted=False,
                                        reason="queue_full",
                                        queue_depth=len(self.queue))
            if victim is not None:
                self._shed(victim, where="queue", reason="shed_overload",
                           now=now, displaced_by=req.id)
        self._reg.counter("serve_requests_total").inc(event="submitted")
        self._reg.gauge("serve_queue_depth").set(len(self.queue))
        return AdmissionVerdict(admitted=True, request=req,
                                queue_depth=len(self.queue),
                                displaced=victim)

    def _shed(self, req: ServeRequest, *, where: str, reason: str,
              now: float, displaced_by: Optional[int] = None) -> None:
        """Shed one request with its evidence (``shed_log``, a
        ``serve.shed`` event, counters)."""
        self._note("shed", req, where, reason, displaced_by)
        req.state = "shed"
        req.shed_reason = reason
        req.finish_s = now
        self.shed.append(req)
        self.shed_by_class[req.criticality] = (
            self.shed_by_class.get(req.criticality, 0) + 1)
        if where == "queue" and reason == "deadline":
            self.expired_in_queue += 1
        elif where == "in_flight":
            self.expired_in_flight += 1
        decision = {"request": req.id, "criticality": req.criticality,
                    "where": where, "reason": reason, "t": now}
        if displaced_by is not None:
            decision["displaced_by"] = displaced_by
        self.shed_log.append(decision)
        self._reg.counter("serve_shed_total").inc(
            criticality=req.criticality, where=where)
        self._reg.gauge("serve_shed_by_class").set(
            float(self.shed_by_class[req.criticality]),
            criticality=req.criticality)
        tracer().event("serve.shed", **decision)

    def admit_external(self, req: ServeRequest,
                       install: Callable) -> None:
        """Queue an externally prefilled request (prefill/decode split):
        at the next step boundary a free slot is claimed and
        ``install(engine, slot) -> (last_token, generator)`` lands the
        handed-off slab and cursor in it; the request then decodes like a
        locally prefilled one. ``req`` must already carry its first token
        (sampled by the prefill replica, which recorded its TTFT).

        On a mesh server every rank makes this call with the same slab,
        in the same order among its submissions; rank 0 picks the slot
        and the step."""
        if self.engine.spec:
            raise ValueError(
                "handoff into a speculative decode server is "
                "unsupported: the draft pool holds no prompt K/V for "
                "the handed-off slot")
        if not req.tokens:
            raise ValueError(
                "admit_external needs a prefilled request (its first "
                "token sampled by the prefill replica)")
        if self._group is not None:
            req.mesh_seq = self._seq
            self._seq += 1
            if not self._leader:   # rank 0's decisions name it by seq
                self._by_seq[req.mesh_seq] = req
        self._handoffs.append((req, install))

    def handoff_headroom(self) -> int:
        """Free slots not yet spoken for by queued handoffs: the router's
        can-this-replica-take-a-slab signal."""
        return self.free_slot_count() - len(self._handoffs)

    # ------------------------------------------------------------------
    # the serve loop
    # ------------------------------------------------------------------
    def _free_slots(self) -> List[int]:
        return [s for s, r in enumerate(self._slot_req) if r is None]

    def _live_slots(self) -> List[int]:
        return [s for s, r in enumerate(self._slot_req) if r is not None]

    def free_slot_count(self) -> int:
        return len(self._free_slots())

    def occupancy(self) -> float:
        return len(self._live_slots()) / self.slots

    def busy(self) -> bool:
        return (bool(self._live_slots()) or len(self.queue) > 0
                or bool(self._handoffs))

    def _pop_live_request(self) -> Optional[ServeRequest]:
        """Next queued request, shedding expired and dropping canceled
        ones before their prefill burns a slot."""
        req = self.queue.pop()
        while req is not None:
            now = self.clock()
            if req.canceled:
                self._note("canceled", req)
                req.state = "canceled"
            elif req.expired(now):
                self._shed(req, where="queue", reason="deadline", now=now)
            else:
                return req
            req = self.queue.pop()
        return None

    def _admit_handoff(self, slot: int, entry: Tuple[ServeRequest, Callable]
                       ) -> None:
        req, install = entry
        with tracer().span("serve.handoff.install", request=req.id,
                           slot=slot):
            last_tok, gen = install(self.engine, slot)
        now = self.clock()
        req.state = "running"
        req.handoff = True
        req.slot = slot
        self._slot_req[slot] = req
        self._gens[slot] = gen
        self._last_tok[slot] = int(last_tok)
        self._last_tok_s[slot] = now
        # TTFT was recorded by the prefill replica; the installed slab
        # covers every emitted token, so a request that arrived complete
        # just retires
        if len(req.tokens) >= req.max_new_tokens:
            self._retire(slot, now)

    def _generator(self, seed: int) -> Optional[torch.Generator]:
        """A sampled request's stream (None on a greedy server)."""
        if self.engine.temperature == 0.0:
            return None
        return torch.Generator(device=self.engine.device).manual_seed(seed)

    def _admit(self) -> int:
        admitted = 0
        for slot in self._free_slots():
            # handed-off slabs first: their prefill compute is already
            # spent, and a queued prompt admitted ahead of them would idle
            # a finished prefill while burning a slot on new work
            if self._handoffs:
                self._admit_handoff(slot, self._handoffs.popleft())
                admitted += 1
                continue
            req = self._pop_live_request()
            if req is None:
                break
            self._admit_one(slot, req)
            admitted += 1
        return admitted

    def _admit_one(self, slot: int, req: ServeRequest) -> None:
        """Prefill ``req`` into the free ``slot``."""
        with tracer().span("serve.prefill", request=req.id, slot=slot,
                           prompt_len=int(req.prompt.shape[0])):
            gen = self._generator(req.seed)
            if self.engine.spec:
                self._draft_gens[slot] = self._generator(
                    draft_seed(req.seed))
            tok = int(self.engine.prefill(req.prompt, slot, gen,
                                          replay=req.replay))
        now = self.clock()
        req.state = "running"
        req.slot = slot
        req.first_token_s = now
        req.tokens.append(tok)
        self._slot_req[slot] = req
        self._gens[slot] = gen
        self._last_tok[slot] = tok
        self._last_tok_s[slot] = now
        if req.ttft_s is not None:
            self._reg.histogram("serve_ttft_seconds",
                                buckets=_LATENCY_BUCKETS
                                ).observe(req.ttft_s)
        self._reg.counter("serve_tokens_total").inc()
        if len(req.tokens) >= req.max_new_tokens:
            self._retire(slot, now)

    # ------------------------------------------------------------------
    # tensor-parallel serving: rank 0 decides, the others follow
    # ------------------------------------------------------------------
    def _note(self, kind: str, req: ServeRequest, *args) -> None:
        """Record one of rank 0's decisions about ``req`` for the next
        step's broadcast."""
        if self._group is not None and self._leader:
            self._log.append((kind, req.mesh_seq) + args)

    def agree(self, value):
        """Rank 0's ``value`` in every rank of a mesh server (a
        collective); ``value`` itself otherwise."""
        if self._group is None:
            return value
        import torch.distributed as dist

        box = [value]
        dist.broadcast_object_list(
            box, src=dist.get_global_rank(self._group, 0), group=self._group)
        return box[0]

    @property
    def tensor_parallel(self) -> bool:
        """Whether this server serves over a mesh's ``model`` group."""
        return self._group is not None

    @property
    def is_leader(self) -> bool:
        """Rank 0 of the ``model`` group, which takes every decision;
        True on a one-device server."""
        return self._leader

    def agreed_verdict(self, verdict: AdmissionVerdict
                       ) -> AdmissionVerdict:
        """Rank 0's admission ``verdict`` in every rank of a mesh server
        (a collective): a follower's ``try_submit`` only recorded the
        request under its sequence number, and rank 0's server decided
        it (the follower's learns at its next step). ``verdict`` itself
        on a one-device server."""
        if self._group is None:
            return verdict
        victim = verdict.displaced
        admitted, reason, depth, victim_seq = self.agree(
            (verdict.admitted, verdict.reason, verdict.queue_depth,
             None if victim is None else victim.mesh_seq))
        if self._leader:
            return verdict
        return AdmissionVerdict(
            admitted=admitted, reason=reason,
            request=verdict.request if admitted else None,
            queue_depth=depth,
            displaced=(None if victim_seq is None
                       else self._by_seq.get(victim_seq)))

    def withdraw(self, req: ServeRequest) -> bool:
        """Pull a queued ``req`` from the admission queue; whether it was
        there. On a mesh server rank 0's answer in every rank (only its
        queue holds the request; a follower then forgets it)."""
        removed = self.queue.remove(req)
        if self._group is not None:
            removed = self.agree(removed)
            if removed:
                self._decided(req)
        return removed

    def pop_queued(self) -> List[ServeRequest]:
        """Empty the admission queue, oldest first. On a mesh server rank
        0's queue names the requests in every rank (a follower's server
        only recorded its submissions)."""
        queued = []
        while (req := self.queue.pop()) is not None:
            queued.append(req)
        if self._group is not None:
            seqs = self.agree([r.mesh_seq for r in queued])
            if not self._leader:
                queued = [self._by_seq.pop(seq) for seq in seqs]
        return queued

    def _lead(self) -> None:
        """Rank 0: sweep, choose the admissions (handed-off slabs first,
        as ``_admit`` does), broadcast them with the decisions logged
        since the last step, then install and prefill."""
        self._sweep_expired()
        slabs, picks = [], []
        for slot in self._free_slots():
            if self._handoffs:
                slabs.append((slot, self._handoffs.popleft()))
                continue
            req = self._pop_live_request()
            if req is None:
                break
            picks.append((slot, req))
        admits = [(slot, req.mesh_seq, req.prompt, req.max_new_tokens,
                   req.seed, req.deadline_s, req.criticality, req.replay)
                  for slot, req in picks]
        self.agree({"log": self._log, "admit": admits,
                    "handoff": [(slot, entry[0].mesh_seq)
                                for slot, entry in slabs]})
        self._log = []
        for slot, entry in slabs:
            self._admit_handoff(slot, entry)
        for slot, req in picks:
            self._admit_one(slot, req)

    def _follow(self) -> None:
        """Every other rank: apply rank 0's decisions, then run the same
        prefills. A request leaves ``_by_seq`` once decided (a running
        one when it retires), unless it was not submitted here yet."""
        plan = self.agree(None)
        now = self.clock()
        for kind, seq, *args in plan["log"]:
            req = self._by_seq.get(seq)
            if req is None:
                continue
            self._decided(req)
            if req.slot is not None and self._slot_req[req.slot] is req:
                self._free(req.slot)
            if kind == "shed":
                where, reason, by = args
                self._shed(req, where=where, reason=reason, now=now,
                           displaced_by=by)
            elif kind == "canceled":
                req.state = "canceled"
        for slot, seq in plan["handoff"]:
            self._admit_handoff(slot, self._take_handoff(seq))
        for (slot, seq, prompt, max_new, seed, deadline, crit,
             replay) in plan["admit"]:
            req = self._by_seq.get(seq)
            if req is None:   # submitted here later than on rank 0
                req = ServeRequest(prompt=prompt, max_new_tokens=max_new,
                                   seed=seed, deadline_s=deadline,
                                   criticality=crit, replay=replay)
                req.submit_s, req.mesh_seq = now, seq
                self._by_seq[seq] = req
            self._admit_one(slot, req)

    def _take_handoff(self, seq: int) -> Tuple[ServeRequest, Callable]:
        """A follower's queued handoff that rank 0 admitted, by seq."""
        for i, entry in enumerate(self._handoffs):
            if entry[0].mesh_seq == seq:
                del self._handoffs[i]
                return entry
        raise RuntimeError(
            f"rank 0 admitted handoff {seq}, which this rank was not "
            "handed: every rank of a mesh server must be handed the same "
            "slabs in the same order")

    def _decided(self, req: ServeRequest) -> None:
        """A follower forgets a request whose fate is settled, once its
        own ``submit`` of it has come."""
        if self._group is not None and req.mesh_seq < self._seq:
            self._by_seq.pop(req.mesh_seq, None)

    def _free(self, slot: int) -> None:
        self._slot_req[slot] = None
        self._gens[slot] = None
        self._draft_gens[slot] = None

    def _retire(self, slot: int, now: float) -> None:
        req = self._slot_req[slot]
        self._decided(req)
        req.state = "finished"
        req.finish_s = now
        self._free(slot)
        self.finished.append(req)
        self._reg.counter("serve_requests_total").inc(event="finished")
        if req.latency_s is not None:
            self._reg.histogram("serve_request_latency_seconds",
                                buckets=_LATENCY_BUCKETS
                                ).observe(req.latency_s)

    def _dispatch(self, live: List[int]):
        """ONE decode dispatch for the current live set. Returns
        ``(toks [K, S], counts [K, S] or None)`` as host arrays (the
        loop's one readback); ``counts`` is None outside the speculative
        path, where every row emits exactly one token."""
        remaining = np.zeros(self.slots, np.int64)
        for slot in live:
            req = self._slot_req[slot]
            remaining[slot] = req.max_new_tokens - len(req.tokens)
        if self.engine.spec:
            block = self.engine.decode_spec(
                self._last_tok, remaining, self._gens, self._draft_gens,
                self.fuse_steps).cpu().numpy()       # [K, S, G+2]
            return block[:, :, 1:], block[:, :, 0]
        if self.fuse_steps > 1:
            toks = self.engine.decode_fused(self._last_tok, remaining,
                                            self._gens, self.fuse_steps)
            return toks.cpu().numpy(), None
        toks = self.engine.decode(self._last_tok, self.engine.cache.cursors,
                                  self._gens)
        live_mask = np.zeros(self.slots, bool)
        live_mask[live] = True
        self.engine.cache.advance(live_mask)
        return toks.cpu().numpy()[None], None

    def _sweep_expired(self) -> None:
        """Free the slots of canceled and expired in-flight requests."""
        now = self.clock()
        for slot in self._live_slots():
            req = self._slot_req[slot]
            if req.canceled:
                self._note("canceled", req)
                req.state = "canceled"
                self._free(slot)
                self._reg.counter("serve_requests_total").inc(
                    event="canceled")
            elif req.expired(now):
                self._free(slot)
                self._shed(req, where="in_flight", reason="deadline",
                           now=now)

    def step(self) -> bool:
        """One scheduler iteration: shed expired/canceled slots, admit,
        then one decode dispatch. Returns False when nothing was live."""
        with tracer().span("serve.step") as sp:
            if self._group is None:
                self._sweep_expired()
                self._admit()
            elif self._leader:
                self._lead()
            else:
                self._follow()
            live = self._live_slots()
            self._reg.gauge("serve_queue_depth").set(len(self.queue))
            self._reg.gauge("serve_slot_occupancy").set(
                len(live) / self.slots)
            if not live:
                return False
            toks, counts = self._dispatch(live)
            now = self.clock()
            self.steps += 1
            self.slot_dispatches += len(live)
            sp.attrs["live"] = len(live)
            self._reg.counter("serve_decode_steps_total").inc()
            tpot = self._reg.histogram("serve_tpot_seconds",
                                       buckets=_LATENCY_BUCKETS)
            emitted_total = 0
            proposed0, accepted0 = self.spec_proposed, self.spec_accepted
            for slot in live:
                req = self._slot_req[slot]
                rem = req.max_new_tokens - len(req.tokens)
                got: List[int] = []
                if counts is None:
                    got = [int(toks[r, slot])
                           for r in range(min(toks.shape[0], rem))]
                else:
                    for r in range(toks.shape[0]):
                        c = int(counts[r, slot])
                        if c <= 0:
                            continue
                        take = min(c, rem - len(got))
                        got.extend(int(t) for t in toks[r, slot, :take])
                        self.spec_proposed += self.engine.spec_tokens
                        self.spec_accepted += c - 1
                        if len(got) >= rem:
                            break
                req.tokens.extend(got)
                emitted_total += len(got)
                # fused tokens land together: spread the interval evenly
                interval = (now - self._last_tok_s[slot]) / max(1, len(got))
                for _ in got:
                    tpot.observe(interval)
                self._last_tok[slot] = got[-1]
                self._last_tok_s[slot] = now
                if len(req.tokens) >= req.max_new_tokens:
                    self._retire(slot, now)
            self.decode_tokens += emitted_total
            self._reg.counter("serve_tokens_total").inc(emitted_total)
            if self.spec_proposed > proposed0:
                self._reg.counter("serve_spec_proposed_total").inc(
                    self.spec_proposed - proposed0)
            if self.spec_accepted > accepted0:
                self._reg.counter("serve_spec_accepted_total").inc(
                    self.spec_accepted - accepted0)
            self._reg.gauge("serve_slot_occupancy").set(self.occupancy())
            return True

    def drain(self, max_steps: Optional[int] = None) -> int:
        """Step until queue and slots are empty; returns steps taken."""
        taken = 0
        while self.agree(self.busy()):
            self.step()
            taken += 1
            if max_steps is not None and taken >= max_steps:
                break
        return taken

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Snapshot: shape counts, pool footprint (the draft pool's
        included), request/dispatch totals, the dispatch ratios and, when
        speculative, the proposal and acceptance counts."""
        pool_bytes = self.engine.cache.nbytes
        per_slot = self.engine.cache.per_slot_nbytes
        if self.engine.draft_cache is not None:
            pool_bytes += self.engine.draft_cache.nbytes
            per_slot += self.engine.draft_cache.per_slot_nbytes
        out = {
            "slots": self.slots,
            "max_len": self.max_len,
            "queue_depth": len(self.queue),
            "occupancy": self.occupancy(),
            "steps": self.steps,
            "finished": len(self.finished),
            "shed": len(self.shed),
            "shed_by_class": dict(self.shed_by_class),
            "expired_in_queue": self.expired_in_queue,
            "expired_in_flight": self.expired_in_flight,
            "fuse_steps": self.fuse_steps,
            "kv_dtype": self.engine.kv_dtype,
            "kv_pool_bytes": pool_bytes,
            # one concurrent request's share of the pools (the draft's
            # included): kv_per_slot_bytes * slots == kv_pool_bytes
            "kv_per_slot_bytes": per_slot,
            "kv_shards": self.engine.cache.n_shard,
            "decode_dispatches": self.steps,
            "decode_tokens": self.decode_tokens,
            "dispatches_per_token": (
                round(self.steps / self.decode_tokens, 4)
                if self.decode_tokens else None),
            "accepted_tokens_per_dispatch": (
                round(self.decode_tokens / self.steps, 4)
                if self.steps else None),
            "tokens_per_slot_dispatch": (
                round(self.decode_tokens / self.slot_dispatches, 4)
                if self.slot_dispatches else None),
            "speculative": self.engine.spec,
            "compiles": self.engine.compile_counts(),
        }
        if self.engine.spec:
            out["spec_tokens"] = self.engine.spec_tokens
            out["spec_proposed"] = self.spec_proposed
            out["spec_accepted"] = self.spec_accepted
            out["spec_accept_rate"] = (
                round(self.spec_accepted / self.spec_proposed, 4)
                if self.spec_proposed else None)
        return out
