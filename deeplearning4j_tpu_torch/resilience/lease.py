"""Grant lease protocol: bounded, self-healing backend acquisition.

Port of ``deeplearning4j_tpu/resilience/lease.py``. A :class:`GrantLease`
wraps one backend acquisition (on the card: a serve replica's warm-up,
which loads the kernel library ``kernels/_build.py`` builds and runs its
first B1 prefill) in a bounded-watchdog lease:

- every attempt is **bounded** (``lease_s``, default
  ``DL4J_GRANT_LEASE_S``): a blocking acquisition runs on a daemon
  thread and the lease stops waiting at the bound instead of hanging
  the process (the thread cannot be killed, but nothing above it needs
  to keep waiting);
- a wedged or failed attempt **releases and re-acquires** instead of
  dying: best-effort ``release()``, an escalating backoff
  (``grant.backoff`` span — the run ledger books it as ``grant_wait``
  badput, like the blocked attempt itself), an optional ``probe()``
  re-check, then a fresh attempt under a ``grant.reacquire`` span;
- attempts are bounded by ``max_reacquires`` (``DL4J_GRANT_REACQUIRES``)
  — exhaustion raises :class:`GrantWedgedError` and the caller takes its
  honest-error path (a serve replica dies and is evicted);
- a rescue leaves evidence: the ``grant.reacquired`` event (forwarded
  into the flight ring like every tracer event) is what
  ``flight_report`` classifies the ``reacquired`` end state from.

A kernel that fails to build or to launch is **not** retryable by
default (:func:`retryable_acquisition`): it is a fault of the program or
the card, not of the grant, so it propagates from ``acquire`` at once —
no quiet dead replica and no CPU fallback.

The reference's bench wraps its TPU grant in a short-lived PJRT child
probe; the card has no such grant, so the port has no probe of its own
(``probe=`` stays for callers that bring one).

State machine::

    unheld --acquire()--> acquiring --ok--> held
                 ^            |
                 |         wedge/fail (attempt <= max_reacquires)
                 |            v
                 +-- backoff/release/probe  --exhausted--> GrantWedgedError

Chaos hook: every attempt declares the ``grant.lease`` fault site, so a
``DL4J_FAULTS=grant.lease=fail_times:1`` schedule deterministically
wedges the first acquisition and exercises the re-acquire path.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Optional, Tuple

from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.resilience.retry import RetryableSpec, is_retryable

logger = logging.getLogger(__name__)

__all__ = [
    "GrantLease",
    "GrantWedgedError",
    "grant_lease_s",
    "grant_reacquires",
    "retryable_acquisition",
]

DEFAULT_LEASE_S = 90.0
DEFAULT_REACQUIRES = 2


class GrantWedgedError(RuntimeError):
    """Every lease attempt wedged or failed. ``attempts`` is how many
    were made; ``last`` the final exception (None when the last attempt
    timed out rather than raised)."""

    def __init__(self, message: str, attempts: int,
                 last: Optional[BaseException] = None):
        super().__init__(message)
        self.attempts = attempts
        self.last = last


def grant_lease_s() -> float:
    """Per-attempt watchdog bound for a grant acquisition
    (``DL4J_GRANT_LEASE_S``, default 90 s: a replica's warm-up, the
    kernels' build included, takes far less, so the bound separates
    healthy from wedged)."""
    raw = os.environ.get("DL4J_GRANT_LEASE_S", "")
    try:
        return float(raw) if raw else DEFAULT_LEASE_S
    except ValueError:
        return DEFAULT_LEASE_S


def grant_reacquires() -> int:
    """How many release-and-re-acquire cycles a lease attempts after the
    first wedge (``DL4J_GRANT_REACQUIRES``, default 2) before giving up
    with :class:`GrantWedgedError`."""
    raw = os.environ.get("DL4J_GRANT_REACQUIRES", "")
    try:
        return max(0, int(raw)) if raw else DEFAULT_REACQUIRES
    except ValueError:
        return DEFAULT_REACQUIRES


def retryable_acquisition(exc: BaseException) -> bool:
    """The default ``retryable`` filter: every ``Exception`` re-acquires
    except a kernel that failed to build (``KernelBuildError``) or to
    launch (a CUDA error), which propagates."""
    import torch

    from deeplearning4j_tpu_torch.kernels._build import KernelBuildError

    if isinstance(exc, KernelBuildError):
        return False
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return False
    if isinstance(exc, RuntimeError) and "CUDA error" in str(exc):
        return False
    return isinstance(exc, Exception)


class GrantLease:
    """Bounded-watchdog lease around one backend acquisition.

    - ``acquire``: the acquisition; may block indefinitely (run on a
      daemon thread under the ``lease_s`` bound when ``bounded=True``)
      or self-bound (subprocess probes pass ``bounded=False`` — they
      enforce their own timeout and raise on it).
    - ``release``: best-effort cleanup after a wedged/failed attempt
      (kill a probe child, drop a half-claim). Exceptions are logged,
      never raised — release runs on the way to a retry.
    - ``probe``: optional liveness pre-check run before every
      RE-acquire (never before the first attempt): return falsy or
      raise to count the cycle as wedged without paying the full
      acquisition.
    - ``retryable``: exception types (tuple) or predicate deciding
      which acquisition failures re-acquire (default
      :func:`retryable_acquisition`); anything else propagates
      immediately (a kernel that does not build must not burn the
      backoff budget). Timeouts of a bounded attempt always count as
      wedges.
    - ``sleep`` / ``clock``: injectable for deterministic tests.

    ``acquire()`` returns the acquisition's value and sets
    ``state == "held"``; ``reacquires`` counts the wedge→re-acquire
    cycles the rescue cost (0 on a clean first attempt).
    """

    def __init__(self, name: str, acquire: Callable[[], object], *,
                 release: Optional[Callable[[], None]] = None,
                 probe: Optional[Callable[[], object]] = None,
                 lease_s: Optional[float] = None,
                 max_reacquires: Optional[int] = None,
                 bounded: bool = True,
                 base_backoff_s: float = 2.0,
                 backoff_multiplier: float = 2.0,
                 max_backoff_s: float = 30.0,
                 retryable: RetryableSpec = retryable_acquisition,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self._acquire = acquire
        self._release = release
        self._probe = probe
        self.lease_s = grant_lease_s() if lease_s is None else float(lease_s)
        self.max_reacquires = (grant_reacquires() if max_reacquires is None
                               else max(0, int(max_reacquires)))
        self.bounded = bounded
        self.base_backoff_s = base_backoff_s
        self.backoff_multiplier = backoff_multiplier
        self.max_backoff_s = max_backoff_s
        self.retryable = retryable
        self._sleep = sleep
        self._clock = clock
        self.state = "unheld"
        self.reacquires = 0
        self.last_detail: Optional[str] = None

    # ------------------------------------------------------------------
    def backoff_for(self, cycle: int) -> float:
        """Escalating (deterministic) backoff before re-acquire cycle
        ``cycle`` (1-based). Determinism over jitter here: lease retries
        are rare, serial, and per-process — there is no thundering herd
        to de-synchronize, and a replayable chaos run wants replayable
        waits."""
        return min(self.max_backoff_s,
                   self.base_backoff_s
                   * self.backoff_multiplier ** (cycle - 1))

    # ------------------------------------------------------------------
    def _attempt_bounded(self):
        """Run the acquisition on a daemon thread under the lease bound.
        Returns (ok, value, exc). A timed-out thread is left behind — it
        may be blocked inside a call that cannot be interrupted — and a
        retry starts a FRESH attempt rather than re-joining it."""
        box: dict = {}
        done = threading.Event()

        def run():
            try:
                faults.fault_point("grant.lease")
                box["value"] = self._acquire()
            except BaseException as e:  # noqa: BLE001 — reported below
                box["exc"] = e
            done.set()

        threading.Thread(target=run, daemon=True,
                         name=f"grant-lease-{self.name}").start()
        if not done.wait(self.lease_s):
            return False, None, None  # wedged: no exception, no value
        if "exc" in box:
            return False, None, box["exc"]
        return True, box.get("value"), None

    def _attempt_unbounded(self):
        try:
            faults.fault_point("grant.lease")
            return True, self._acquire(), None
        except BaseException as e:  # noqa: BLE001 — filtered by caller
            return False, None, e

    def _do_release(self) -> None:
        self.state = "releasing"
        if self._release is None:
            return
        try:
            self._release()
        except Exception:  # noqa: BLE001 — release is best-effort
            logger.warning("grant lease %s: release failed", self.name,
                           exc_info=True)

    def _do_probe(self) -> Tuple[bool, Optional[str]]:
        if self._probe is None:
            return True, None
        try:
            ok = self._probe()
        except Exception as e:  # noqa: BLE001 — a raising probe = wedged
            return False, f"probe raised: {e}"
        if not ok:
            return False, "probe reported backend unavailable"
        return True, None

    # ------------------------------------------------------------------
    def acquire(self):
        """Acquire under the lease protocol; returns the acquisition's
        value or raises :class:`GrantWedgedError` after
        ``1 + max_reacquires`` wedged/failed attempts (non-retryable
        acquisition exceptions propagate as-is)."""
        from deeplearning4j_tpu_torch.monitor import record_counter, tracer

        last_exc: Optional[BaseException] = None
        for attempt in range(1 + self.max_reacquires):
            if attempt > 0:
                ok, detail = self._do_probe()
                if not ok:
                    self.last_detail = detail
                    tracer().event("grant.watchdog", phase=self.name,
                                   attempt=attempt,
                                   detail=str(detail)[:200])
                    record_counter("grant_wedges_total", phase=self.name)
                    if attempt < self.max_reacquires:
                        self._backoff(attempt + 1, tracer)
                    continue
            self.state = "acquiring"
            span_name = "grant.acquire" if attempt == 0 else "grant.reacquire"
            # the flight marker lands BEFORE the (possibly blocking)
            # attempt — spans only record on completion, so a grant that
            # never returns leaves the open marker as the wedge evidence
            _flight_marker(phase=self.name, attempt=attempt,
                           timeout_s=self.lease_s)
            with tracer().span(span_name, lease=self.name,
                               attempt=attempt,
                               timeout_s=self.lease_s) as sp:
                if self.bounded:
                    ok, value, exc = self._attempt_bounded()
                else:
                    ok, value, exc = self._attempt_unbounded()
                sp.attrs["ok"] = ok
            # an injected grant.lease fault is ALWAYS a wedge, whatever
            # the retryable filter says: the documented chaos contract
            # (DL4J_FAULTS="grant.lease=fail_times:1") must exercise the
            # re-acquire path on every lease
            if isinstance(exc, faults.FaultInjected):
                retryable_exc = True
            else:
                retryable_exc = exc is None or is_retryable(
                    exc, self.retryable)
            if ok:
                self.state = "held"
                self.reacquires = attempt
                record_counter("grant_lease_acquired_total",
                               phase=self.name,
                               reacquired=str(attempt > 0).lower())
                if attempt > 0:
                    # the rescue record: flight_report classifies a run
                    # whose timeline carries this as `reacquired`
                    # (clean-with-recovery), not wedged
                    tracer().event("grant.reacquired", lease=self.name,
                                   attempts=attempt)
                    logger.warning(
                        "grant lease %s: re-acquired after %d wedged "
                        "attempt(s)", self.name, attempt)
                return value
            if not retryable_exc:
                self.state = "unheld"
                raise exc
            last_exc = exc
            detail = ("no completion within lease bound "
                      f"{self.lease_s:.0f}s" if exc is None
                      else f"{type(exc).__name__}: {exc}")
            self.last_detail = detail
            tracer().event("grant.watchdog", phase=self.name,
                           attempt=attempt, timeout_s=self.lease_s,
                           detail=str(detail)[:200])
            record_counter("grant_wedges_total", phase=self.name)
            self._do_release()
            if attempt < self.max_reacquires:
                self._backoff(attempt + 1, tracer)
        self.state = "wedged"
        raise GrantWedgedError(
            f"grant lease {self.name!r} wedged: "
            f"{1 + self.max_reacquires} attempt(s) exhausted "
            f"(last: {self.last_detail})",
            attempts=1 + self.max_reacquires, last=last_exc)

    def _backoff(self, cycle: int, tracer) -> None:
        self.state = "backoff"
        delay = self.backoff_for(cycle)
        # its own span name (not retry.sleep): the ledger books lease
        # backoff as grant_wait — the run lost this time to the GRANT,
        # and the goodput breakdown should say so
        with tracer().span("grant.backoff", lease=self.name,
                           cycle=cycle, delay_s=round(delay, 3)):
            self._sleep(delay)


def _flight_marker(**payload) -> None:
    try:
        from deeplearning4j_tpu_torch.monitor.flight import flight_record

        flight_record("grant.wait", **payload)
    except Exception:  # telemetry must never block an acquisition
        pass
