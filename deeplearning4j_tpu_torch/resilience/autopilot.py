"""Goodput autopilot: the observe→act loop over the fleet gauges.

Port of ``deeplearning4j_tpu/resilience/autopilot.py``. The master tick
(``DistributedTrainer``'s, ``FleetController``'s) aggregates every
member's heartbeat payload into gauges (step time, ledger goodput %,
last loss, a serve replica's TPOT), flags stragglers against the fleet
median and logs eviction evidence; this module acts on that evidence.
TensorFlow's design (arXiv 1605.08695) treats worker failure as a
scheduling event; this module is that scheduler for the fleet.

:class:`GoodputAutopilot` consumes exactly what the master tick already
aggregates — the per-member payload map, the straggler flag set, the
last-beat timestamps, the run-ledger goodput — and issues three kinds of
decision through caller-provided **actuators** (so every action flows
through the same evidence-logged path the master tick uses: the
trainer's eviction log, the fused driver's ``request_reshard``, the
serve controller's ``evict``):

- ``evict``   — a member silent past ``silence_s``, or flagged as a
  straggler for ``straggler_ticks`` consecutive observations (one noisy
  tick never evicts);
- ``reshard`` — fleet goodput below the floor (``DL4J_GOODPUT_FLOOR``):
  shrink the mesh to the healthy members instead of letting the whole
  run pace at the sick one (actuator wired by the caller that owns the
  network: ``nn/fused.py`` and ``parallel/data_parallel.py``'s
  ``request_reshard``);
- ``readmit`` — a previously evicted member beating again with a
  healthy payload rejoins (the scheduling event is reversible).

Every decision is recorded as an ``autopilot.decision`` tracer event
carrying the gauge values that triggered it (forwarded into the flight
ring like every event), appended to :attr:`GoodputAutopilot.decisions`,
and counted in ``autopilot_decisions_total`` (labeled by action).
Actuator failures mark the decision ``acted=False`` and never crash the
control loop.

``DL4J_AUTOPILOT=1`` opts the built-in integrations in
(``DistributedTrainer`` and ``FleetController`` also accept an explicit
``autopilot=`` instance); a ``cooldown_s`` throttle keeps a persistent
condition from flapping decisions every tick.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)

__all__ = [
    "AutopilotDecision",
    "GoodputAutopilot",
    "autopilot_enabled",
    "goodput_floor",
]

DEFAULT_GOODPUT_FLOOR = 50.0
DEFAULT_SILENCE_S = 30.0
DEFAULT_STRAGGLER_TICKS = 2
# a persistent goodput collapse must not emit a reshard decision per
# tick (~1 s cadence): one decision, then silence until the cooldown
# passes — the condition either resolves (the reshard worked) or the
# next decision fires with fresh gauges
DEFAULT_COOLDOWN_S = 30.0


def autopilot_enabled() -> bool:
    """``DL4J_AUTOPILOT`` opts the built-in control-loop integrations in
    (default off: observe-only fleets behave exactly as before)."""
    return os.environ.get("DL4J_AUTOPILOT", "").strip().lower() in (
        "1", "on", "true")


def goodput_floor() -> float:
    """Fleet goodput floor in percent (``DL4J_GOODPUT_FLOOR``, default
    50): sustained goodput below it triggers a reshard decision."""
    raw = os.environ.get("DL4J_GOODPUT_FLOOR", "")
    try:
        return float(raw) if raw else DEFAULT_GOODPUT_FLOOR
    except ValueError:
        return DEFAULT_GOODPUT_FLOOR


@dataclass
class AutopilotDecision:
    """One evidence-carrying decision. ``gauges`` holds the values that
    triggered it (the observe side); ``acted`` whether the actuator ran
    cleanly (the act side)."""

    action: str            # "evict" | "reshard" | "readmit"
    target: Optional[str]  # worker/replica id (None for fleet-wide)
    reason: str
    gauges: dict = field(default_factory=dict)
    t_wall: float = 0.0
    acted: bool = True

    def to_json(self) -> dict:
        return {"action": self.action, "target": self.target,
                "reason": self.reason, "gauges": dict(self.gauges),
                "t_wall": self.t_wall, "acted": self.acted}


class GoodputAutopilot:
    """Turn fleet gauges into evict/reshard/re-admit decisions.

    Actuators (all optional — a decision with no actuator is still
    evidence-logged, it just isn't executed):

    - ``evict(member_id, decision)`` — drop a member; the trainer wires
      ``DistributedTrainer.evict_worker`` (tracker eviction + the same
      eviction-log entry the master tick writes), the serve fleet wires
      ``FleetController.evict`` (kill + failover).
    - ``reshard(healthy_ids, decision)`` — resize around the sick
      members. NOT auto-wired by the built-in integrations (the
      control-plane trainer and serve controller own no fused network):
      the caller that owns the run wires
      ``reshard=lambda healthy, d: w.request_reshard(build_mesh(
      MeshSpec(data=len(healthy)), ranks=...))`` so the resize lands at
      the next chunk boundary through the elastic reshard path, the
      ranks outside the mesh parked. ``build_mesh`` is a collective of
      the whole world, so in a world of several ranks one rank observes,
      its decision is broadcast in the ``on_chunk`` hook, and every rank
      builds the same mesh and requests it. Unwired, the decision is
      still evidence-logged with ``acted=False``.
    - ``readmit(member_id, decision)`` — restore an evicted member the
      autopilot sees beating healthily again (for a run: a reshard onto
      a mesh over it, which grows the run back).

    ``observe()`` is the tick: pass the payload map the master tick
    aggregated plus the straggler set and last-beat timestamps it
    already holds. The autopilot keeps only the cross-tick state the
    gauges cannot carry (straggler streaks, its own evicted set, the
    last decision time for the cooldown).
    """

    def __init__(self, *,
                 floor: Optional[float] = None,
                 silence_s: float = DEFAULT_SILENCE_S,
                 straggler_ticks: int = DEFAULT_STRAGGLER_TICKS,
                 cooldown_s: float = DEFAULT_COOLDOWN_S,
                 clock: Callable[[], float] = time.time,
                 evict: Optional[Callable] = None,
                 reshard: Optional[Callable] = None,
                 readmit: Optional[Callable] = None):
        self.floor = goodput_floor() if floor is None else float(floor)
        self.silence_s = float(silence_s)
        self.straggler_ticks = max(1, int(straggler_ticks))
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self._evict = evict
        self._reshard = reshard
        self._readmit = readmit
        self.decisions: List[AutopilotDecision] = []
        self.evicted: set = set()
        self._evicted_at: Dict[str, float] = {}
        self._streaks: Dict[str, int] = {}
        self._last_reshard_t: Optional[float] = None

    def bind(self, *, evict: Optional[Callable] = None,
             reshard: Optional[Callable] = None,
             readmit: Optional[Callable] = None) -> "GoodputAutopilot":
        """Late actuator wiring for integrations that construct the
        autopilot before the object its decisions act on (the trainer
        binds its own evidence-logged evict path here). Only unset
        actuators are filled — an explicitly provided one wins."""
        if self._evict is None:
            self._evict = evict
        if self._reshard is None:
            self._reshard = reshard
        if self._readmit is None:
            self._readmit = readmit
        return self

    # ------------------------------------------------------------------
    def _issue(self, decision: AutopilotDecision,
               actuator: Optional[Callable], *args) -> AutopilotDecision:
        from deeplearning4j_tpu_torch.monitor import record_counter, tracer

        decision.t_wall = self.clock()
        if actuator is not None:
            try:
                actuator(*args, decision)
            except Exception:  # noqa: BLE001 — the control loop survives
                logger.exception("autopilot %s actuator failed for %s",
                                 decision.action, decision.target)
                decision.acted = False
        else:
            decision.acted = False
        # the decision event carries the triggering gauge values — the
        # flight ring gets it via event forwarding, so a postmortem can
        # audit every action against the evidence that justified it
        tracer().event("autopilot.decision", action=decision.action,
                       target=decision.target, reason=decision.reason,
                       acted=decision.acted,
                       **{k: v for k, v in decision.gauges.items()
                          if isinstance(v, (str, int, float, bool))})
        record_counter("autopilot_decisions_total",
                       action=decision.action)
        self.decisions.append(decision)
        return decision

    def _latch_eviction(self, member: str, decision: AutopilotDecision,
                        now: float) -> bool:
        """Record the eviction ONLY when it happened: the actuator ran
        cleanly, or none is bound (advisory mode — latching avoids
        re-advising every tick). A bound actuator that RAISED leaves
        the member un-latched so the next tick retries — a wedged
        worker must not be permanently forgotten over one transient
        tracker error."""
        if decision.acted or self._evict is None:
            self.evicted.add(member)
            self._evicted_at[member] = now
            return True
        return False

    def unlatch(self, member: str) -> None:
        """Forget an eviction whose actuator failed after the pass that
        latched it (a caller that carries evictions out later), so the
        next pass decides it again."""
        self.evicted.discard(member)
        self._evicted_at.pop(member, None)

    # ------------------------------------------------------------------
    def observe(self, fleet: Dict[str, dict], *,
                stragglers: Sequence[str] = (),
                last_beat: Optional[Dict[str, float]] = None,
                goodput_pct: Optional[float] = None,
                now: Optional[float] = None) -> List[AutopilotDecision]:
        """One observe→act pass. ``fleet`` is the master tick's payload
        map; ``stragglers`` its current flag set; ``last_beat`` the
        wall-clock timestamp of each member's newest beat; ``goodput_pct``
        an explicit fleet goodput override (default: the minimum of the
        members' reported ``goodput_pct`` gauges). Returns the decisions
        issued this pass (also appended to :attr:`decisions`)."""
        now = self.clock() if now is None else now
        out: List[AutopilotDecision] = []
        last_beat = last_beat or {}

        # -- silence ⇒ evict (the wedged-member shape: alive-or-dead,
        #    nothing has told us anything for too long)
        for member, t in sorted(last_beat.items()):
            if member in self.evicted or t is None:
                continue
            silent = now - t
            if silent >= self.silence_s:
                d = self._issue(AutopilotDecision(
                    action="evict", target=member,
                    reason="heartbeat_silence",
                    gauges={"silent_s": round(silent, 3),
                            "silence_timeout_s": self.silence_s,
                            **_compact(fleet.get(member))}),
                    self._evict, member)
                self._latch_eviction(member, d, now)
                out.append(d)

        # -- straggler streak ⇒ evict (one noisy tick never evicts; a
        #    member slow for straggler_ticks consecutive passes does)
        flagged = set(stragglers) - self.evicted
        for member in list(self._streaks):
            if member not in flagged:
                del self._streaks[member]
        for member in sorted(flagged):
            self._streaks[member] = self._streaks.get(member, 0) + 1
            if self._streaks[member] >= self.straggler_ticks:
                d = self._issue(AutopilotDecision(
                    action="evict", target=member,
                    reason="straggler_streak",
                    gauges={"streak_ticks": self.straggler_ticks,
                            **_compact(fleet.get(member))}),
                    self._evict, member)
                if self._latch_eviction(member, d, now):
                    del self._streaks[member]
                else:
                    # actuator raised: hold the streak at the threshold
                    # so the NEXT flagged tick retries the eviction
                    self._streaks[member] = self.straggler_ticks - 1
                out.append(d)

        # -- previously evicted member beating again healthily ⇒
        #    readmit. The beat must be NEWER than the eviction: the
        #    snapshot that justified a straggler eviction this very pass
        #    still carries that member's (fresh) beat, and readmitting
        #    off it would instantly contradict the eviction
        for member in sorted(set(fleet) & self.evicted):
            t = last_beat.get(member)
            if (t is not None and now - t < self.silence_s
                    and t > self._evicted_at.get(member, float("-inf"))):
                self.evicted.discard(member)
                self._evicted_at.pop(member, None)
                self._streaks.pop(member, None)
                out.append(self._issue(AutopilotDecision(
                    action="readmit", target=member,
                    reason="healthy_beat_after_eviction",
                    gauges={"silent_s": round(now - t, 3),
                            **_compact(fleet.get(member))}),
                    self._readmit, member))

        # -- goodput floor ⇒ reshard around the healthy members
        gp = goodput_pct
        if gp is None:
            reported = [float(m["goodput_pct"]) for m in fleet.values()
                        if isinstance(m.get("goodput_pct"), (int, float))]
            gp = min(reported) if reported else None
        if gp is not None and gp < self.floor:
            cooled = (self._last_reshard_t is None
                      or now - self._last_reshard_t >= self.cooldown_s)
            if cooled:
                self._last_reshard_t = now
                healthy = sorted(set(fleet) - self.evicted - flagged)
                out.append(self._issue(AutopilotDecision(
                    action="reshard", target=None,
                    reason="goodput_below_floor",
                    gauges={"goodput_pct": round(float(gp), 2),
                            "floor_pct": self.floor,
                            "healthy": ",".join(healthy),
                            "n_healthy": len(healthy)}),
                    self._reshard, healthy))
        return out


def _compact(payload: Optional[dict]) -> dict:
    """The scalar slice of a heartbeat payload — the gauge values a
    decision event can carry verbatim."""
    if not payload:
        return {}
    return {k: v for k, v in payload.items()
            if isinstance(v, (str, int, float, bool))}
