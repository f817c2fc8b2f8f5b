"""Online serving for the port: slot KV pool, decode engine (with
speculative decoding), continuous-batching server, open-loop load
generator, the kernel build cache and the serve knobs.

The multi-replica fleet (:mod:`deeplearning4j_tpu_torch.serving.fleet`:
replicas, router, controller, the prefill/decode handoff and the load
driver) is imported explicitly, not re-exported here, as in the
reference."""

from deeplearning4j_tpu_torch.serving.compile_cache import (  # noqa: F401
    compile_cache_dir,
    compile_cache_stats,
    ensure_compile_cache,
)
from deeplearning4j_tpu_torch.serving.kv_cache import (  # noqa: F401
    SlotKVCache,
    kv_pool_nbytes,
    max_slots_in_budget,
    resolve_kv_dtype,
)
from deeplearning4j_tpu_torch.serving.engine import DecodeEngine  # noqa
from deeplearning4j_tpu_torch.serving.scheduler import (  # noqa: F401
    CRITICALITIES,
    AdmissionVerdict,
    RequestQueue,
    RetryBudget,
    ServeQueueFull,
    ServeRequest,
    criticality_rank,
    request_cost,
    serve_deadline_s,
    serve_draft_layers,
    serve_evict_s,
    serve_fuse_steps,
    serve_hedge_s,
    serve_kv_dtype,
    serve_max_queue,
    serve_replicas,
    serve_retry_burst,
    serve_retry_ratio,
    serve_role,
    serve_slots,
)
from deeplearning4j_tpu_torch.serving.server import DecodeServer  # noqa
from deeplearning4j_tpu_torch.serving.loadgen import (  # noqa: F401
    Arrival,
    LoadReport,
    poisson_schedule,
    run_open_loop,
)

__all__ = [
    "AdmissionVerdict", "Arrival", "CRITICALITIES", "DecodeEngine",
    "DecodeServer", "LoadReport", "RequestQueue", "RetryBudget",
    "ServeQueueFull", "ServeRequest", "SlotKVCache",
    "compile_cache_dir", "compile_cache_stats", "criticality_rank",
    "ensure_compile_cache", "kv_pool_nbytes", "max_slots_in_budget",
    "poisson_schedule", "request_cost", "resolve_kv_dtype",
    "run_open_loop", "serve_deadline_s", "serve_draft_layers",
    "serve_evict_s", "serve_fuse_steps", "serve_hedge_s",
    "serve_kv_dtype", "serve_max_queue", "serve_replicas",
    "serve_retry_burst", "serve_retry_ratio", "serve_role",
    "serve_slots",
]
