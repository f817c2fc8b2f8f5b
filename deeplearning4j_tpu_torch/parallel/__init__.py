"""Parallel and distributed pieces of the port: the fleet controller's
:func:`workrouter.update_straggler_flags` and :mod:`.cluster`'s
``FaultTolerantTrainer``. Meshes, data/tensor/pipeline parallelism, the
state tracker, the multi-host runtime and the rest of the work router
are ROADMAP A14/A15."""

from deeplearning4j_tpu_torch.parallel.cluster import (  # noqa: F401
    FaultTolerantTrainer,
)
