"""Online serving for the port: slot KV pool, decode engine, continuous-
batching server, open-loop load generator."""

from deeplearning4j_tpu_torch.serving.engine import DecodeEngine
from deeplearning4j_tpu_torch.serving.kv_cache import (
    SlotKVCache, kv_pool_nbytes, max_slots_in_budget, resolve_kv_dtype)
from deeplearning4j_tpu_torch.serving.loadgen import (
    Arrival, LoadReport, poisson_schedule, run_open_loop)
from deeplearning4j_tpu_torch.serving.scheduler import (
    AdmissionVerdict, RequestQueue, RetryBudget, ServeQueueFull,
    ServeRequest)
from deeplearning4j_tpu_torch.serving.server import DecodeServer

__all__ = [
    "AdmissionVerdict", "Arrival", "DecodeEngine", "DecodeServer",
    "LoadReport", "RequestQueue", "RetryBudget", "ServeQueueFull",
    "ServeRequest", "SlotKVCache", "kv_pool_nbytes", "max_slots_in_budget",
    "poisson_schedule", "resolve_kv_dtype", "run_open_loop",
]
