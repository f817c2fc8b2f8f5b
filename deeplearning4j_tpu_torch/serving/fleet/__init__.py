"""Serve fleet: multi-replica routing, failover, the prefill/decode split.

Port of ``deeplearning4j_tpu/serving/fleet``, in one process on one card:

- :mod:`.replica` — :class:`ServeReplica`: a ``DecodeServer`` in a worker
  loop (a thread, or stepped by the driver) with its serve payload
  ``{occupancy, queue_depth, free_slots, ttft_p50, tpot_s,
  tokens_per_sec}``.
- :mod:`.router` — :class:`FleetRouter`: least-loaded admission, bounded
  per-replica queues with spill, sticky affinity, failover requeue with
  the prompt re-prefilled, retry budgets, hedging and graceful drain.
- :mod:`.controller` — :class:`FleetController`: the master tick
  (gauges, TPOT stragglers, eviction of crashed replicas with evidence,
  requeue onto survivors, drain).
- :mod:`.handoff` — the prefill/decode split (``DL4J_SERVE_ROLE``):
  prefill replicas export ``(kv_slab, cursor, key)`` packages that a
  decode replica installs into a free slot.
- :mod:`.driver` — :class:`FleetLoadDriver`: replays a schedule on
  virtual per-replica timelines with measured (or pinned) step costs.

Replicas beat to a ``parallel.StateTracker`` when given ``tracker=``, and
the controller evicts one silent past its timeout. A replica started with
``lease=`` (a ``resilience.GrantLease``, around :meth:`ServeReplica
.warm_up`) dies when the lease wedges on every attempt; the controller
with ``autopilot=`` (or ``DL4J_AUTOPILOT``) evicts a straggler through
its own ``evict``.
"""

from deeplearning4j_tpu_torch.serving.fleet.controller import (  # noqa: F401
    FleetController,
)
from deeplearning4j_tpu_torch.serving.fleet.driver import (  # noqa: F401
    FleetLoadDriver,
)
from deeplearning4j_tpu_torch.serving.fleet.handoff import (  # noqa: F401
    SlotHandoff,
    export_live_slot,
    export_slot,
    install_slot,
    make_install,
)
from deeplearning4j_tpu_torch.serving.fleet.replica import (  # noqa: F401
    ServeReplica,
)
from deeplearning4j_tpu_torch.serving.fleet.router import (  # noqa: F401
    FleetRequest,
    FleetRouter,
    FleetSaturated,
)

__all__ = [
    "FleetController", "FleetLoadDriver", "FleetRequest", "FleetRouter",
    "FleetSaturated", "ServeReplica", "SlotHandoff", "export_live_slot",
    "export_slot", "install_slot", "make_install",
]
