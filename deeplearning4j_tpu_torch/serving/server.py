"""DecodeServer: continuous batching over the slot pool.

Port of ``deeplearning4j_tpu/serving/server.py`` (without the fleet's
slab handoff, speculative decoding and ``mesh=``, which are later
slices). The loop, per ``step()`` (a step is a fusion boundary):

1. **admit** — pop queued requests into free slots; each admission runs
   the bucket-padded prefill (``serve.prefill`` span), records TTFT, and
   may retire at once when ``max_new_tokens == 1``.
2. **decode** — if any slot is live, run ONE decode dispatch: the single
   step (``fuse_steps=1``) or K fused steps. Every live slot appends up to
   its remaining tokens; finished requests retire and free their slots.

The host reads back one token block per dispatch ([S] at K=1, [K, S]
fused); that readback is the loop's synchronisation point. Deadlines,
criticality shedding and the bounded queue behave as in the reference.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.monitor import metrics, tracer
from deeplearning4j_tpu_torch.serving.engine import DecodeEngine
from deeplearning4j_tpu_torch.serving.scheduler import (
    AdmissionVerdict, RequestQueue, ServeQueueFull, ServeRequest,
    criticality_rank, serve_deadline_s, serve_draft_layers,
    serve_fuse_steps, serve_kv_dtype, serve_max_queue, serve_slots)

__all__ = ["DecodeServer"]

_LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                    float("inf"))


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
        self.engine = DecodeEngine(
            model, slots if slots is not None else serve_slots(),
            max_len=max_len, temperature=temperature, top_k=top_k,
            buckets=buckets,
            kv_dtype=kv_dtype if kv_dtype is not None else serve_kv_dtype(),
            draft_model=draft_model,
            draft_layers=(draft_layers if draft_layers is not None
                          else serve_draft_layers()),
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
        self.finished: List[ServeRequest] = []
        self.shed: List[ServeRequest] = []
        self.shed_log: List[dict] = []
        self.shed_by_class: dict = {}
        self.expired_in_queue = 0
        self.expired_in_flight = 0
        self.steps = 0
        self.decode_tokens = 0
        self.slot_dispatches = 0
        self._reg = metrics()

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
                   displace: bool = True) -> AdmissionVerdict:
        """Non-blocking ``submit`` returning an :class:`AdmissionVerdict`.
        Malformed requests raise. ``deadline_s`` is the ABSOLUTE expiry
        on this server's clock (None: ``DL4J_SERVE_DEADLINE_S`` as a
        budget from now); at the queue bound ``displace=True`` sheds the
        costliest queued request of a strictly lower class."""
        criticality_rank(criticality)
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.shape[0] < 1:
            raise ValueError("prompt must hold at least one token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = int(prompt.shape[0]) + max_new_tokens
        if total > self.max_len:
            raise ValueError(
                f"prompt_len + max_new_tokens = {total} exceeds the "
                f"server's slot capacity max_len={self.max_len}")
        now = self.clock()
        if deadline_s is None:
            budget = serve_deadline_s()
            deadline_s = None if budget is None else now + budget
        req = ServeRequest(prompt=prompt, max_new_tokens=max_new_tokens,
                           seed=seed, deadline_s=deadline_s,
                           criticality=criticality)
        req.submit_s = now
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
        return bool(self._live_slots()) or len(self.queue) > 0

    def _pop_live_request(self) -> Optional[ServeRequest]:
        """Next queued request, shedding expired and dropping canceled
        ones before their prefill burns a slot."""
        req = self.queue.pop()
        while req is not None:
            now = self.clock()
            if req.canceled:
                req.state = "canceled"
            elif req.expired(now):
                self._shed(req, where="queue", reason="deadline", now=now)
            else:
                return req
            req = self.queue.pop()
        return None

    def _admit(self) -> int:
        admitted = 0
        for slot in self._free_slots():
            req = self._pop_live_request()
            if req is None:
                break
            with tracer().span("serve.prefill", request=req.id, slot=slot,
                               prompt_len=int(req.prompt.shape[0])):
                gen = None
                if self.engine.temperature > 0.0:
                    gen = torch.Generator(
                        device=self.engine.device).manual_seed(req.seed)
                tok = int(self.engine.prefill(req.prompt, slot, gen))
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
            admitted += 1
            if len(req.tokens) >= req.max_new_tokens:
                self._retire(slot, now)
        return admitted

    def _free(self, slot: int) -> None:
        self._slot_req[slot] = None
        self._gens[slot] = None

    def _retire(self, slot: int, now: float) -> None:
        req = self._slot_req[slot]
        req.state = "finished"
        req.finish_s = now
        self._free(slot)
        self.finished.append(req)
        self._reg.counter("serve_requests_total").inc(event="finished")
        if req.latency_s is not None:
            self._reg.histogram("serve_request_latency_seconds",
                                buckets=_LATENCY_BUCKETS
                                ).observe(req.latency_s)

    def _dispatch(self, live: List[int]) -> np.ndarray:
        """ONE decode dispatch for the current live set; returns the
        ``[K, S]`` token block as a host array (the loop's one
        readback)."""
        if self.fuse_steps > 1:
            remaining = np.zeros(self.slots, np.int64)
            for slot in live:
                req = self._slot_req[slot]
                remaining[slot] = req.max_new_tokens - len(req.tokens)
            toks = self.engine.decode_fused(self._last_tok, remaining,
                                            self._gens, self.fuse_steps)
            return toks.cpu().numpy()
        toks = self.engine.decode(self._last_tok, self.engine.cache.cursors,
                                  self._gens)
        live_mask = np.zeros(self.slots, bool)
        live_mask[live] = True
        self.engine.cache.advance(live_mask)
        return toks.cpu().numpy()[None]

    def _sweep_expired(self) -> None:
        """Free the slots of canceled and expired in-flight requests."""
        now = self.clock()
        for slot in self._live_slots():
            req = self._slot_req[slot]
            if req.canceled:
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
            self._sweep_expired()
            self._admit()
            live = self._live_slots()
            self._reg.gauge("serve_queue_depth").set(len(self.queue))
            self._reg.gauge("serve_slot_occupancy").set(
                len(live) / self.slots)
            if not live:
                return False
            toks = self._dispatch(live)
            now = self.clock()
            self.steps += 1
            self.slot_dispatches += len(live)
            sp.attrs["live"] = len(live)
            self._reg.counter("serve_decode_steps_total").inc()
            tpot = self._reg.histogram("serve_tpot_seconds",
                                       buckets=_LATENCY_BUCKETS)
            emitted_total = 0
            for slot in live:
                req = self._slot_req[slot]
                rem = req.max_new_tokens - len(req.tokens)
                got = [int(toks[r, slot])
                       for r in range(min(toks.shape[0], rem))]
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
            self._reg.gauge("serve_slot_occupancy").set(self.occupancy())
            return True

    def drain(self, max_steps: Optional[int] = None) -> int:
        """Step until queue and slots are empty; returns steps taken."""
        taken = 0
        while self.busy():
            self.step()
            taken += 1
            if max_steps is not None and taken >= max_steps:
                break
        return taken

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Snapshot: shape counts, pool footprint, request/dispatch
        totals and the dispatch ratios."""
        return {
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
            "kv_pool_bytes": self.engine.cache.nbytes,
            "kv_per_slot_bytes": self.engine.cache.per_slot_nbytes,
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
            "speculative": False,
            "compiles": self.engine.compile_counts(),
        }
