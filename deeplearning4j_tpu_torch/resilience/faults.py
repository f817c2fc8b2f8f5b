"""Deterministic, seeded fault injection for the control plane.

Copy of ``deeplearning4j_tpu/resilience/faults.py``, which imports no
JAX; the port keeps its own so that it imports nothing of that package.
Only ``epoch.chunk`` is a site of the port so far.

The reference dl4j's distributed story was *tested* by real failures (Akka
kills actors, YARN restarts containers). Our control plane
(statetracker/cluster/registry/fetchers) is plain Python, so faults are
injected at named **fault points** — call sites that the production code
threads through :func:`fault_point`. When no schedule is installed the call
is a dict lookup on an empty dict guarded by a module-level flag: zero
overhead in production.

Usage (tests)::

    with inject("statetracker.write", fail_nth(3, exc=OSError)):
        ...          # the 3rd tracker write raises OSError("injected ...")

    with inject("heartbeat.post", delay(50)):
        ...          # every heartbeat post sleeps 50 ms

Usage (process-level, e.g. chaos runs of the CLI)::

    DL4J_FAULTS="checkpoint.save=fail_nth:2;fetcher.download=fail_rate:0.5:123"

Well-known sites (grep for ``fault_point(`` for the authoritative list):

- ``statetracker.write``   — every FileStateTracker atomic publish
- ``checkpoint.save``      — FaultTolerantTrainer.save/save_async, before
  the write
- ``checkpoint.restore``   — FaultTolerantTrainer.resume, per candidate
- ``heartbeat.post``       — every heartbeat post (monitor + workers)
- ``distributed.init``     — each distributed initialisation attempt
- ``fetcher.download``     — each dataset download attempt
- ``registry.retrieve``    — ConfigRegistry reads (wait_for polls)
- ``epoch.chunk``          — before every fused epoch-chunk dispatch
  (drive_epoch_chunks)
- ``preempt.chunk``        — polled at every chunk boundary by
  PreemptionGuard.check; an injected fault here IS a preemption notice

Schedules are deterministic: ``fail_nth`` counts invocations,
``fail_rate`` draws from its own seeded RNG — re-running a test replays
the identical fault sequence.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Callable, Dict, Optional

__all__ = [
    "FaultInjected",
    "FaultPoint",
    "fault_point",
    "inject",
    "install",
    "uninstall",
    "clear",
    "active",
    "fail_nth",
    "fail_times",
    "fail_rate",
    "delay",
    "install_from_env",
    "parse_spec",
]


class FaultInjected(Exception):
    """Default exception raised by failure schedules."""


# A schedule is any callable taking the site name; it raises/sleeps/no-ops.
Schedule = Callable[[str], None]

_lock = threading.RLock()
_active: Dict[str, Schedule] = {}
# fast-path flag: production code pays one attribute read + truth test
_armed: bool = False


def fault_point(name: str) -> None:
    """Declare a named injection site. No-op unless a schedule is
    installed for ``name`` (zero overhead when the registry is empty).
    Armed sites count every evaluation in the metrics registry
    (``fault_site_fires_total``, labeled raised=true/false) so a chaos
    run's artifact shows which sites actually fired."""
    if not _armed:
        return
    sched = _active.get(name)
    if sched is not None:
        from deeplearning4j_tpu_torch.monitor import record_counter

        try:
            sched(name)
        except BaseException:
            record_counter("fault_site_fires_total", site=name,
                           raised="true")
            raise
        record_counter("fault_site_fires_total", site=name,
                       raised="false")


class FaultPoint:
    """First-class handle on a site name; ``FaultPoint("x")()`` fires it.

    Lets a module hoist its site into a constant and call it like a
    function, keeping the site name greppable in one place."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __call__(self) -> None:
        fault_point(self.name)

    def __repr__(self) -> str:
        return f"FaultPoint({self.name!r})"


def install(name: str, schedule: Schedule) -> None:
    global _armed
    with _lock:
        _active[name] = schedule
        _armed = True


def uninstall(name: str) -> None:
    global _armed
    with _lock:
        _active.pop(name, None)
        _armed = bool(_active)


def clear() -> None:
    """Remove every installed schedule."""
    global _armed
    with _lock:
        _active.clear()
        _armed = False


def active() -> Dict[str, Schedule]:
    with _lock:
        return dict(_active)


class inject:
    """Context manager installing ``schedule`` at ``name`` for the body.

    Restores the previous schedule (if any) on exit, so nested injections
    at the same site compose."""

    def __init__(self, name: str, schedule: Schedule):
        self.name = name
        self.schedule = schedule
        self._prev: Optional[Schedule] = None
        self._had_prev = False

    def __enter__(self) -> "inject":
        with _lock:
            self._had_prev = self.name in _active
            self._prev = _active.get(self.name)
            install(self.name, self.schedule)
        return self

    def __exit__(self, *exc) -> None:
        with _lock:
            if self._had_prev and self._prev is not None:
                install(self.name, self._prev)
            else:
                uninstall(self.name)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


def fail_nth(n: int, exc: Callable[[str], BaseException] = None) -> Schedule:
    """Fail exactly the ``n``-th invocation (1-based); all others pass.

    ``exc``: exception *type or factory* called with a message — inject
    ``OSError`` to exercise paths whose retry filters treat I/O errors as
    transient."""
    counter = {"n": 0}
    make = exc or FaultInjected

    def sched(name: str) -> None:
        with _lock:
            counter["n"] += 1
            hit = counter["n"] == n
        if hit:
            raise make(f"injected fault at {name} (call #{n})")

    return sched


def fail_times(k: int, exc: Callable[[str], BaseException] = None) -> Schedule:
    """Fail the first ``k`` invocations, then succeed forever — the
    canonical transient-fault shape for retry tests."""
    counter = {"n": 0}
    make = exc or FaultInjected

    def sched(name: str) -> None:
        with _lock:
            counter["n"] += 1
            hit = counter["n"] <= k
        if hit:
            raise make(f"injected fault at {name} "
                       f"(call #{counter['n']} of first {k})")

    return sched


def fail_rate(p: float, seed: int = 0,
              exc: Callable[[str], BaseException] = None) -> Schedule:
    """Fail with probability ``p`` from a private seeded RNG — the fault
    sequence is a pure function of ``seed``, so runs replay exactly."""
    rng = random.Random(seed)
    make = exc or FaultInjected

    def sched(name: str) -> None:
        with _lock:
            hit = rng.random() < p
        if hit:
            raise make(f"injected fault at {name} (rate={p}, seed={seed})")

    return sched


def delay(ms: float) -> Schedule:
    """Sleep ``ms`` milliseconds on every invocation (slow-host / hung-step
    simulation — pair with StepWatchdog tests)."""

    def sched(name: str) -> None:
        time.sleep(ms / 1000.0)

    return sched


# ---------------------------------------------------------------------------
# DL4J_FAULTS env spec
# ---------------------------------------------------------------------------

_SCHEDULES = {
    "fail_nth": lambda *a: fail_nth(int(a[0])),
    "fail_times": lambda *a: fail_times(int(a[0])),
    "fail_rate": lambda *a: fail_rate(float(a[0]),
                                      int(a[1]) if len(a) > 1 else 0),
    "delay": lambda *a: delay(float(a[0])),
}


def parse_spec(spec: str) -> Dict[str, Schedule]:
    """Parse a ``DL4J_FAULTS`` spec:
    ``site=schedule:arg[:arg...]`` entries joined by ``;``. Example::

        statetracker.write=fail_nth:3;heartbeat.post=delay:100
    """
    out: Dict[str, Schedule] = {}
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        try:
            site, rhs = entry.split("=", 1)
            parts = rhs.split(":")
            kind, args = parts[0], parts[1:]
            out[site.strip()] = _SCHEDULES[kind](*args)
        except (ValueError, KeyError, IndexError):
            raise ValueError(
                f"bad DL4J_FAULTS entry {entry!r}: expected "
                f"site=schedule:arg[:arg], schedule one of "
                f"{sorted(_SCHEDULES)}") from None
    return out


def install_from_env(env_var: str = "DL4J_FAULTS") -> int:
    """Install schedules from the environment; returns how many. Called at
    ``deeplearning4j_tpu_torch.resilience`` import so chaos runs need only the
    env var set before the process starts."""
    spec = os.environ.get(env_var)
    if not spec:
        return 0
    parsed = parse_spec(spec)
    for site, sched in parsed.items():
        install(site, sched)
    return len(parsed)
