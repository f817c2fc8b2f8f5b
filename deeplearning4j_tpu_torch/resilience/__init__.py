"""Robustness around the fused training paths.

Port of the parts of ``deeplearning4j_tpu/resilience`` that
``perf/epoch_cache.drive_epoch_chunks`` uses:

- :mod:`~deeplearning4j_tpu_torch.resilience.guard` — the numeric
  sentinel and the ``DL4J_NAN_GUARD`` policy;
- :mod:`~deeplearning4j_tpu_torch.resilience.watchdog` — ``StepWatchdog``
  flags a chunk that does not finish within its deadline;
- :mod:`~deeplearning4j_tpu_torch.resilience.faults` — named injection
  sites (``epoch.chunk``) for chaos tests.

Preemption, leases, retries and the autopilot are not ported yet.
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
from deeplearning4j_tpu_torch.resilience.guard import (  # noqa: F401
    NAN_GUARD_POLICIES,
    TrainingDivergedError,
    nan_guard_policy,
    tree_all_finite,
)
from deeplearning4j_tpu_torch.resilience.watchdog import StepWatchdog  # noqa: F401

install_from_env()
