"""One retry policy for the whole control plane.

The seed grew ad-hoc retry shapes — ``initialize_distributed`` slept a
fixed 5 s, ``ConfigRegistry.wait_for`` hand-rolled a poll loop,
``FileStateTracker`` and the dataset fetchers had none. ``RetryPolicy``
replaces all of them: exponential backoff with **full jitter** (AWS
architecture-blog shape: each delay is uniform in ``[0, cap]``, which
de-synchronizes a pod's worth of workers hammering one shared filesystem),
a max-attempt bound, an overall deadline, a retryable-exception filter,
and an ``on_retry`` hook for logging/metrics.

Both the sleeper and the jitter RNG are injectable, so tests assert the
exact delay sequence under a seed without ever sleeping.
"""

from __future__ import annotations

import logging
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple, Type, Union

logger = logging.getLogger(__name__)

__all__ = ["RetryPolicy", "RetryError", "is_retryable", "no_jitter"]

RetryableSpec = Union[Tuple[Type[BaseException], ...],
                      Callable[[BaseException], bool]]


class RetryError(RuntimeError):
    """All attempts exhausted. ``last`` holds the final exception (also
    chained as ``__cause__``); ``attempts`` how many were made."""

    def __init__(self, message: str, last: BaseException, attempts: int):
        super().__init__(message)
        self.last = last
        self.attempts = attempts


def no_jitter(lo: float, hi: float) -> float:
    """Deterministic 'jitter' pinning each delay to its cap — use in tests
    that want the raw exponential sequence."""
    return hi


def is_retryable(exc: BaseException, spec: RetryableSpec) -> bool:
    """Shared retryable test (RetryPolicy AND GrantLease): a bare
    exception class/tuple is a membership test, NOT a predicate —
    treating it as one would call OSError(exc) (always truthy) and retry
    everything, Ctrl-C included."""
    if isinstance(spec, tuple) or (isinstance(spec, type)
                                   and issubclass(spec, BaseException)):
        return isinstance(exc, spec)
    return bool(spec(exc))


@dataclass
class RetryPolicy:
    """Exponential backoff + full jitter.

    Delay before attempt ``k`` (k = 1 is the first *retry*) is drawn
    uniformly from ``[0, min(max_delay_s, base_delay_s * multiplier**(k-1))]``.
    ``multiplier=1.0`` gives fixed-interval polling (registry watch loops).

    - ``max_attempts``: total tries including the first (None = unbounded,
      bound by ``deadline_s`` instead; at least one bound is required).
    - ``deadline_s``: overall wall-clock budget; once exceeded, no further
      attempt is made.
    - ``retryable``: exception types (tuple) or a predicate; anything else
      propagates immediately.
    - ``on_retry(attempt, exc, delay_s)``: observability hook, called
      before each backoff sleep.
    - ``sleep`` / ``rng``: injectable for deterministic tests; ``seed``
      builds a private ``random.Random`` so two policies with the same
      seed produce identical jitter sequences.
    """

    max_attempts: Optional[int] = 5
    base_delay_s: float = 0.1
    max_delay_s: float = 30.0
    multiplier: float = 2.0
    deadline_s: Optional[float] = None
    retryable: RetryableSpec = (Exception,)
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None
    sleep: Callable[[float], None] = time.sleep
    seed: Optional[int] = None
    rng: Optional[Callable[[float, float], float]] = None
    monotonic: Callable[[], float] = field(default=time.monotonic)

    def __post_init__(self):
        if self.max_attempts is None and self.deadline_s is None:
            raise ValueError("RetryPolicy needs max_attempts or deadline_s "
                             "(otherwise it would retry forever)")
        if self.max_attempts is not None and self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, "
                             f"got {self.max_attempts}")
        if self.rng is None:
            self.rng = random.Random(self.seed).uniform

    # ------------------------------------------------------------------
    def _is_retryable(self, exc: BaseException) -> bool:
        return is_retryable(exc, self.retryable)

    def delay_for(self, attempt: int) -> float:
        """Backoff delay after failed attempt ``attempt`` (1-based)."""
        cap = min(self.max_delay_s,
                  self.base_delay_s * self.multiplier ** (attempt - 1))
        return self.rng(0.0, cap)

    # ------------------------------------------------------------------
    def call(self, fn: Callable, *args, **kwargs):
        """Run ``fn`` under this policy; returns its value or raises
        :class:`RetryError` (non-retryable exceptions propagate as-is)."""
        start = self.monotonic()
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — filtered below
                if not self._is_retryable(e):
                    raise
                out_of_attempts = (self.max_attempts is not None
                                   and attempt >= self.max_attempts)
                wait = self.delay_for(attempt)
                out_of_time = (self.deadline_s is not None
                               and self.monotonic() - start + wait
                               > self.deadline_s)
                if out_of_attempts or out_of_time:
                    raise RetryError(
                        f"{getattr(fn, '__name__', fn)!r} failed after "
                        f"{attempt} attempt(s)"
                        + (" (deadline exceeded)" if out_of_time else "")
                        + f": {e}", last=e, attempts=attempt) from e
                fname = getattr(fn, "__name__", repr(fn))
                if self.on_retry is not None:
                    self.on_retry(attempt, e, wait)
                else:
                    logger.debug("retry %d of %r in %.3fs after %s",
                                 attempt, fname, wait, e)
                # telemetry: every retry counts, every backoff sleep is a
                # span — a run that spent its wall clock backing off shows
                # it on the timeline instead of looking wedged
                from deeplearning4j_tpu_torch.monitor import (record_counter,
                                                        tracer)

                record_counter("retry_attempts_total", fn=fname)
                with tracer().span("retry.sleep", fn=fname,
                                   attempt=attempt,
                                   delay_s=round(wait, 4)):
                    self.sleep(wait)

    def retrying(self, fn: Callable) -> Callable:
        """Decorator form of :meth:`call`."""

        def wrapped(*args, **kwargs):
            return self.call(fn, *args, **kwargs)

        wrapped.__name__ = getattr(fn, "__name__", "retrying")
        return wrapped
