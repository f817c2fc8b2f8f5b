"""Request model + admission queue for the decode server (copy of the
jax-free ``deeplearning4j_tpu/serving/scheduler.py``; the port keeps its
own copy so that it never imports the JAX package).

Scheduler policy (stated so it can be changed deliberately): admission
at step boundaries from a bounded queue (``DL4J_SERVE_MAX_QUEUE``;
overflow rejects at submit — backpressure belongs at the edge, not as
unbounded memory), ordered by criticality class then FIFO within a
class. No preemption of running slots, no prompt-length reordering:
continuous batching already removes the head-of-line blocking that
matters (a long generation never stalls admission — new requests join
mid-flight the moment any slot frees), and class-then-FIFO keeps
per-request latency analyzable under the open-loop load the bench
drives while letting ``interactive`` traffic hold its TTFT through an
overload storm.

Overload control (the request-level half of the fleet's robustness
story — the replica-level half is failover/eviction):

- **deadlines** — ``ServeRequest.deadline_s`` is an ABSOLUTE instant on
  the server's clock; an expired request sheds at the earliest point
  that looks at it (admission, queue pop, or the in-flight sweep)
  instead of burning decode slots on an answer nobody waits for.
- **criticality** — :data:`CRITICALITIES` orders the classes; when the
  queue is at bound an arriving request may displace the costliest
  queued request of a STRICTLY lower class (cost estimate
  ``prompt_len + max_new_tokens``), so ``batch`` absorbs the storm
  while ``interactive`` holds.
- **retry budgets** — :class:`RetryBudget` is the per-class token
  bucket the router's failover/hedge retries draw from: each
  submitted request deposits ``DL4J_SERVE_RETRY_RATIO`` tokens, each
  retry spends one, so retry amplification is bounded by construction
  (≈ ``1 + ratio`` long-run) instead of melting the fleet under the
  very overload that caused the retries.
"""

from __future__ import annotations

import itertools
import os
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np

__all__ = ["ServeRequest", "ServeQueueFull", "RequestQueue",
           "AdmissionVerdict", "RetryBudget", "serve_slots",
           "serve_max_queue", "serve_fuse_steps", "serve_kv_dtype",
           "serve_draft_layers", "serve_replicas", "serve_role",
           "serve_evict_s", "serve_deadline_s", "serve_retry_ratio",
           "serve_retry_burst", "serve_hedge_s", "SERVE_ROLES",
           "CRITICALITIES", "criticality_rank", "request_cost"]

_IDS = itertools.count(1)


def serve_slots(default: int = 8) -> int:
    """``DL4J_SERVE_SLOTS``: concurrent decode slots S (the batch width
    of the one compiled decode program)."""
    raw = os.environ.get("DL4J_SERVE_SLOTS", "")
    try:
        return max(1, int(raw)) if raw else default
    except ValueError:
        return default


def serve_fuse_steps(default: int = 1) -> int:
    """``DL4J_SERVE_FUSE_STEPS``: decode steps fused per dispatch (K).
    1 (default) = one decode step per scheduler step; K > 1 runs K
    steps per dispatch with one token readback, and admits
    new requests only at fusion boundaries."""
    raw = os.environ.get("DL4J_SERVE_FUSE_STEPS", "")
    try:
        return max(1, int(raw)) if raw else default
    except ValueError:
        return default


def serve_kv_dtype(default=None):
    """``DL4J_SERVE_KV_DTYPE``: the KV pool's store dtype
    (``float32``/``bfloat16``/``int8``); unset = the model's compute
    dtype (pre-quantization behavior). Validation happens in
    ``kv_cache.resolve_kv_dtype`` (model-aware)."""
    raw = os.environ.get("DL4J_SERVE_KV_DTYPE", "").strip()
    return raw or default


def serve_draft_layers(default: int = 0) -> int:
    """``DL4J_SERVE_DRAFT_LAYERS``: speculative decoding via a shallow
    self-draft of the target's first N layers. 0 (default) = off."""
    raw = os.environ.get("DL4J_SERVE_DRAFT_LAYERS", "")
    try:
        return max(0, int(raw)) if raw else default
    except ValueError:
        return default


def serve_max_queue(default: int = 64) -> int:
    """``DL4J_SERVE_MAX_QUEUE``: admission queue bound; submits beyond
    it raise :class:`ServeQueueFull`."""
    raw = os.environ.get("DL4J_SERVE_MAX_QUEUE", "")
    try:
        return max(1, int(raw)) if raw else default
    except ValueError:
        return default


# ---------------------------------------------------------------------------
# fleet knobs (serving/fleet/)
# ---------------------------------------------------------------------------

#: replica roles for the prefill/decode split: ``mixed`` replicas run the
#: whole request lifecycle (the single-replica behavior), ``prefill``
#: replicas only compute prompt K/V slabs and hand them off, ``decode``
#: replicas only accept handed-off slabs and stream tokens.
SERVE_ROLES = ("mixed", "prefill", "decode")


def serve_replicas(default: int = 2) -> int:
    """``DL4J_SERVE_REPLICAS``: how many ``DecodeServer`` replicas a
    fleet stands up (``serving/fleet``)."""
    raw = os.environ.get("DL4J_SERVE_REPLICAS", "")
    try:
        return max(1, int(raw)) if raw else default
    except ValueError:
        return default


def serve_role(default: str = "mixed") -> str:
    """``DL4J_SERVE_ROLE``: this process's replica role in a
    prefill/decode-disaggregated fleet (``mixed``/``prefill``/
    ``decode``). An unknown value raises — a replica silently falling
    back to ``mixed`` would serve decode traffic a router believes it
    routed elsewhere."""
    raw = os.environ.get("DL4J_SERVE_ROLE", "").strip().lower()
    if not raw:
        return default
    if raw not in SERVE_ROLES:
        raise ValueError(
            f"DL4J_SERVE_ROLE={raw!r} must be one of {SERVE_ROLES}")
    return raw


def serve_evict_s(default: float = 10.0) -> float:
    """``DL4J_SERVE_EVICT_S``: heartbeat-silence timeout after which the
    fleet controller evicts a replica and requeues its in-flight
    requests onto survivors."""
    raw = os.environ.get("DL4J_SERVE_EVICT_S", "")
    try:
        return max(0.1, float(raw)) if raw else default
    except ValueError:
        return default


# ---------------------------------------------------------------------------
# overload-control knobs
# ---------------------------------------------------------------------------

#: criticality classes, most to least critical. Shedding walks this
#: list from the BACK (``best_effort`` goes first); queue admission
#: pops from the FRONT (``interactive`` jumps the line).
CRITICALITIES = ("interactive", "batch", "best_effort")

_CRIT_RANK = {c: i for i, c in enumerate(CRITICALITIES)}


def criticality_rank(criticality: str) -> int:
    """0 = most critical; raises on an unknown class (silently treating
    a typo as lowest-priority would shed traffic the caller believed
    was interactive)."""
    try:
        return _CRIT_RANK[criticality]
    except KeyError:
        raise ValueError(
            f"criticality={criticality!r} must be one of {CRITICALITIES}")


def request_cost(prompt_len: int, max_new_tokens: int) -> int:
    """The shed-ordering cost estimate: prefill work scales with the
    prompt, decode occupancy with the generation budget — their sum is
    the slot-seconds a request would claim."""
    return int(prompt_len) + int(max_new_tokens)


def serve_deadline_s(default: Optional[float] = None) -> Optional[float]:
    """``DL4J_SERVE_DEADLINE_S``: default per-request deadline BUDGET
    (seconds from submit) applied when a request carries none. Unset =
    no deadline (requests wait forever, the pre-overload-control
    behavior)."""
    raw = os.environ.get("DL4J_SERVE_DEADLINE_S", "")
    try:
        return max(0.0, float(raw)) if raw else default
    except ValueError:
        return default


def serve_retry_ratio(default: float = 0.1) -> float:
    """``DL4J_SERVE_RETRY_RATIO``: retry-budget tokens each submitted
    request deposits into its class's bucket. 0.1 bounds long-run retry
    amplification at ~1.1x submitted."""
    raw = os.environ.get("DL4J_SERVE_RETRY_RATIO", "")
    try:
        return max(0.0, float(raw)) if raw else default
    except ValueError:
        return default


def serve_retry_burst(default: float = 10.0) -> float:
    """``DL4J_SERVE_RETRY_BURST``: retry-budget bucket cap (and initial
    fill) per class — the burst of retries a cold fleet may spend
    before the deposit stream has accrued."""
    raw = os.environ.get("DL4J_SERVE_RETRY_BURST", "")
    try:
        return max(0.0, float(raw)) if raw else default
    except ValueError:
        return default


def serve_hedge_s(default: Optional[float] = None) -> Optional[float]:
    """``DL4J_SERVE_HEDGE_S``: latency threshold past which a
    still-queued ``interactive`` request may hedge to a second replica
    (first winner cancels the loser). Unset/0 = hedging off."""
    raw = os.environ.get("DL4J_SERVE_HEDGE_S", "")
    try:
        v = float(raw) if raw else None
    except ValueError:
        return default
    if v is None:
        return default
    return v if v > 0 else None


class RetryBudget:
    """Per-class token bucket bounding retry amplification.

    Every submitted request deposits ``ratio`` tokens into its class's
    bucket (capped at ``burst``, which is also the initial fill); every
    retry — a failover re-dispatch (however many replicas the spill
    probes on its way to a seat), a hedge — spends one. First-time
    placement is free: routing a fresh request is not a retry, only
    re-doing work is. When a bucket is dry
    the retry simply does not happen: during the overload that caused
    the failures, retries are the amplifier that melts fleets, and the
    budget caps total attempts at ``submitted * (1 + ratio) + burst``
    per class by construction. Thread-safe (router + controller tick)."""

    def __init__(self, ratio: Optional[float] = None,
                 burst: Optional[float] = None):
        self.ratio = serve_retry_ratio() if ratio is None else float(ratio)
        self.burst = serve_retry_burst() if burst is None else float(burst)
        self._tokens: Dict[str, float] = {
            c: self.burst for c in CRITICALITIES}
        self._lock = threading.Lock()

    def deposit(self, criticality: str) -> None:
        criticality_rank(criticality)
        with self._lock:
            self._tokens[criticality] = min(
                self.burst, self._tokens[criticality] + self.ratio)

    def has(self, criticality: str, n: float = 1.0) -> bool:
        with self._lock:
            return self._tokens[criticality] >= n

    def try_spend(self, criticality: str, n: float = 1.0) -> bool:
        """Spend ``n`` tokens if available; False (and no change) when
        the bucket is dry — the caller skips the retry."""
        criticality_rank(criticality)
        with self._lock:
            if self._tokens[criticality] < n:
                return False
            self._tokens[criticality] -= n
            return True

    def refund(self, criticality: str, n: float = 1.0) -> None:
        """Return tokens a spent retry never used (e.g. a hedge that
        found no replica to land on); capped at ``burst``."""
        criticality_rank(criticality)
        with self._lock:
            self._tokens[criticality] = min(
                self.burst, self._tokens[criticality] + float(n))

    def remaining(self, criticality: str) -> float:
        with self._lock:
            return self._tokens[criticality]


class ServeQueueFull(RuntimeError):
    """Backpressure signal: the admission queue is at its bound."""


@dataclass(frozen=True)
class AdmissionVerdict:
    """Outcome of a non-blocking ``DecodeServer.try_submit``: either the
    request was enqueued (``admitted``, ``request`` set) or the server
    reported why not (``reason``) — so a routing frontend can place
    against many replicas without exception-driven control flow.
    ``queue_depth`` is the admission queue's depth at decision time
    (the spill signal). ``displaced`` carries the lower-criticality
    victim this admission shed from a full queue (criticality
    displacement), so the router can settle the victim's fleet-level
    bookkeeping."""

    admitted: bool
    reason: Optional[str] = None     # None | "queue_full" | "expired"
    request: Optional["ServeRequest"] = None
    queue_depth: int = 0
    displaced: Optional["ServeRequest"] = None


@dataclass(eq=False)  # identity semantics: a request IS its object —
class ServeRequest:   # field-wise eq would compare prompt arrays
    """One generation request and its measured lifecycle.

    Timestamps are the server clock's (injectable, monotonic):
    ``submit_s`` at enqueue, ``first_token_s`` when the prefill emits
    the first token (TTFT), ``finish_s`` at retirement. ``tokens`` are
    the generated tokens only (the caller owns its prompt)."""

    prompt: np.ndarray
    max_new_tokens: int
    seed: int = 0
    id: int = field(default_factory=lambda: next(_IDS))
    state: str = "queued"   # queued | running | finished | shed | canceled
    # True once the request entered a server through a slab handoff:
    # its TTFT belongs to the PREFILL side (stamped there), so the
    # decode side must not re-attribute it to itself
    handoff: bool = False
    slot: Optional[int] = None
    submit_s: Optional[float] = None
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    tokens: List[int] = field(default_factory=list)
    # overload control: ABSOLUTE expiry instant on the server's clock
    # (None = no deadline), criticality class, and — once shed — why
    # ("deadline" | "shed_overload") for the evidence trail
    deadline_s: Optional[float] = None
    criticality: str = "interactive"
    shed_reason: Optional[str] = None
    # a hedged duplicate that lost the race: the server retires it
    # without counting it finished the next time it looks at it
    canceled: bool = False
    # a greedy failover continuation: the last ``replay`` prompt tokens
    # are tokens the stream already emitted, which the admission feeds
    # through the decode step, as the stream first consumed them
    replay: int = 0

    def expired(self, now: float) -> bool:
        return self.deadline_s is not None and now > self.deadline_s

    @property
    def cost(self) -> int:
        return request_cost(self.prompt.shape[0], self.max_new_tokens)

    @property
    def ttft_s(self) -> Optional[float]:
        if self.submit_s is None or self.first_token_s is None:
            return None
        return self.first_token_s - self.submit_s

    @property
    def latency_s(self) -> Optional[float]:
        if self.submit_s is None or self.finish_s is None:
            return None
        return self.finish_s - self.submit_s

    @property
    def output(self) -> np.ndarray:
        """``prompt + generated`` — the shape ``generate()`` returns,
        for equivalence checks."""
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens, self.prompt.dtype)])


class RequestQueue:
    """Bounded class-then-FIFO admission queue; thread-safe so
    producers may submit while the serve loop runs on another thread.

    One FIFO deque per criticality class: ``pop`` serves the most
    critical non-empty class first (FIFO within it — a single-class
    workload sees exactly the old FIFO behavior), and at the bound
    ``displace`` lets an arrival shed the costliest queued request of a
    strictly lower class instead of being rejected."""

    def __init__(self, max_depth: int):
        self.max_depth = int(max_depth)
        self._lock = threading.Lock()
        self._qs: Dict[str, Deque[ServeRequest]] = {
            c: deque() for c in CRITICALITIES}

    def push(self, req: ServeRequest) -> None:
        if not self.try_push(req):
            raise ServeQueueFull(
                f"serve queue at max depth {self.max_depth}")

    def try_push(self, req: ServeRequest) -> bool:
        """Non-raising ``push``: False when the queue is at its bound."""
        with self._lock:
            if self._size() >= self.max_depth:
                return False
            self._qs[req.criticality].append(req)
            return True

    def displace(self, req: ServeRequest
                 ) -> "tuple[bool, Optional[ServeRequest]]":
        """Admission at the bound: evict the costliest queued request
        of the LOWEST class strictly below ``req``'s and enqueue
        ``req`` in its place. Returns ``(admitted, victim)`` — the
        victim (for the caller to shed with evidence) is None when the
        queue had room, and ``admitted`` is False when every queued
        request is at least as critical as the arrival (the arrival is
        then the one to reject)."""
        with self._lock:
            if self._size() < self.max_depth:
                self._qs[req.criticality].append(req)
                return True, None
            rank = criticality_rank(req.criticality)
            for c in reversed(CRITICALITIES):
                if _CRIT_RANK[c] <= rank or not self._qs[c]:
                    continue
                victim = max(self._qs[c], key=lambda r: (r.cost, r.id))
                self._qs[c].remove(victim)
                self._qs[req.criticality].append(req)
                return True, victim
            return False, None

    def pop(self) -> Optional[ServeRequest]:
        with self._lock:
            for c in CRITICALITIES:
                if self._qs[c]:
                    return self._qs[c].popleft()
            return None

    def remove(self, req: ServeRequest) -> bool:
        """Pull a specific request back out (hedge-loser cancellation);
        False when it was already popped into a slot."""
        with self._lock:
            q = self._qs[req.criticality]
            try:
                q.remove(req)
                return True
            except ValueError:
                return False

    def _size(self) -> int:
        return sum(len(q) for q in self._qs.values())

    def __len__(self) -> int:
        with self._lock:
            return self._size()
