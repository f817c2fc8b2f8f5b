"""Robustness around the fused training paths and the fleets.

Port of ``deeplearning4j_tpu/resilience``:

- :mod:`~deeplearning4j_tpu_torch.resilience.guard` — the numeric
  sentinel and the ``DL4J_NAN_GUARD`` policy;
- :mod:`~deeplearning4j_tpu_torch.resilience.watchdog` — ``StepWatchdog``
  flags a chunk that does not finish within its deadline;
- :mod:`~deeplearning4j_tpu_torch.resilience.faults` — named injection
  sites (``epoch.chunk``, ``preempt.chunk``, ``checkpoint.save``, ...)
  for chaos tests;
- :mod:`~deeplearning4j_tpu_torch.resilience.retry` — ``RetryPolicy``
  (the fetchers' downloads);
- :mod:`~deeplearning4j_tpu_torch.resilience.preemption` —
  ``PreemptionGuard`` (``FaultTolerantTrainer``);
- :mod:`~deeplearning4j_tpu_torch.resilience.lease` — ``GrantLease``, a
  bounded watchdog around a backend acquisition (a serve replica's
  warm-up) that releases and re-acquires a wedged one under escalating
  backoff;
- :mod:`~deeplearning4j_tpu_torch.resilience.autopilot` —
  ``GoodputAutopilot``: goodput below the floor, a straggler streak or
  heartbeat silence become evict/reshard/re-admit decisions, each
  evidence-logged as an ``autopilot.decision`` event.
"""

from deeplearning4j_tpu_torch.resilience.faults import (  # noqa: F401
    FaultInjected,
    FaultPoint,
    clear,
    delay,
    fail_nth,
    fail_rate,
    fail_times,
    fault_point,
    inject,
    install,
    install_from_env,
    parse_spec,
    uninstall,
)
from deeplearning4j_tpu_torch.resilience.autopilot import (  # noqa: F401
    AutopilotDecision,
    GoodputAutopilot,
    autopilot_enabled,
    goodput_floor,
)
from deeplearning4j_tpu_torch.resilience.guard import (  # noqa: F401
    NAN_GUARD_POLICIES,
    TrainingDivergedError,
    nan_guard_policy,
    tree_all_finite,
)
from deeplearning4j_tpu_torch.resilience.lease import (  # noqa: F401
    GrantLease,
    GrantWedgedError,
    grant_lease_s,
    grant_reacquires,
)
from deeplearning4j_tpu_torch.resilience.preemption import (  # noqa: F401
    PREEMPT_CHUNK_SITE,
    PreemptionGuard,
)
from deeplearning4j_tpu_torch.resilience.retry import (  # noqa: F401
    RetryError,
    RetryPolicy,
    is_retryable,
    no_jitter,
)
from deeplearning4j_tpu_torch.resilience.watchdog import StepWatchdog  # noqa: F401

install_from_env()
