"""Distributed training over ``torch.distributed`` meshes.

Port of ``deeplearning4j_tpu/parallel``. The reference runs one jitted
SPMD program over a ``jax.sharding.Mesh``; the port runs torch's SPMD
model — one process per rank, a ``DeviceMesh`` over the world
(:mod:`.mesh`, joined through a ``FileStore`` by ``join_world``), a
process group per axis — with the collectives written out
(:mod:`.collectives`).

Ported: the mesh and its spec registry (:mod:`.sharding_registry`),
``ParallelWrapper`` and ``ParameterAveragingTrainer``
(:mod:`.data_parallel`), FSDP (:mod:`.fsdp`), ring attention over the
flash kernels (:mod:`.ring_attention`) and Ulysses (:mod:`.ulysses`)
(ROADMAP A14.1); tensor parallelism over ``model``
(:mod:`.tensor_parallel`, ``TransformerLM.shard_params``), the GPipe
schedule over ``pipe`` (:mod:`.pipeline_parallel`) and the MoE FFN over
``expert`` (:mod:`.expert_parallel`) (A14.2); the fused epoch over a mesh
with its elastic reshard (``ParallelWrapper.fit_epochs``), the state
tracker (:mod:`.statetracker`), the multi-host runtime and
``FaultTolerantTrainer`` (:mod:`.cluster`) and the work router
(:mod:`.workrouter`) (A14.3); the config registry (:mod:`.registry`).
"""

from deeplearning4j_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshSpec,
    build_mesh,
    in_mesh,
    join_world,
    leave_world,
    local_device_count,
    mesh_ranks,
)
from deeplearning4j_tpu_torch.parallel.data_parallel import (  # noqa: F401
    ParallelWrapper,
    ParameterAveragingTrainer,
)
from deeplearning4j_tpu_torch.parallel.ring_attention import (  # noqa: F401
    ring_attention,
    ring_self_attention_sharded,
)
from deeplearning4j_tpu_torch.parallel.ulysses import (  # noqa: F401
    ulysses_attention,
    ulysses_self_attention_sharded,
)
from deeplearning4j_tpu_torch.parallel.fsdp import (  # noqa: F401
    FSDP,
    fsdp_shardings,
    fsdp_spec,
    shard_tree,
)
from deeplearning4j_tpu_torch.parallel.statetracker import (  # noqa: F401
    FileStateTracker,
    InMemoryStateTracker,
    Job,
    StateTracker,
)
from deeplearning4j_tpu_torch.parallel.cluster import (  # noqa: F401
    ClusterConfig,
    FaultTolerantTrainer,
    HeartbeatMonitor,
    initialize_distributed,
)
from deeplearning4j_tpu_torch.parallel.workrouter import (  # noqa: F401
    DistributedTrainer,
    HogwildWorkRouter,
    IterativeReduceWorkRouter,
    NetworkWorkPerformer,
    WorkRouter,
    WorkerPerformer,
    average_aggregator,
)
from deeplearning4j_tpu_torch.parallel.pipeline_parallel import (  # noqa: F401
    pipeline_train_step,
    shard_stage_params,
    split_microbatches,
    spmd_pipeline,
    stack_stage_params,
)
from deeplearning4j_tpu_torch.parallel.expert_parallel import (  # noqa: F401
    MoEConfig,
    init_moe_params,
    moe_ffn,
    shard_moe_params,
)
from deeplearning4j_tpu_torch.parallel.registry import ConfigRegistry  # noqa: F401
