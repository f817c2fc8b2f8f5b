"""Device-memory watermarks at chunk boundaries, and the epoch cache's
priced bytes against what it holds.

Port of ``deeplearning4j_tpu/monitor/memory.py`` on ``torch.cuda``:

- :func:`sample_hbm_watermark` — one sample per visible card: the
  caching allocator's current and peak allocated bytes
  (``torch.cuda.memory_stats``) and the card's capacity
  (``torch.cuda.mem_get_info``), ``source: "memory_stats"``. Without a
  card it walks the live CPU tensors (:func:`live_array_bytes`,
  ``source: "live_arrays"``), as the reference does on a backend without
  stats. Samples land in the registry as ``hbm_bytes_in_use`` /
  ``hbm_peak_bytes`` gauges and on the tracer as an ``hbm.watermark``
  event.
- :func:`cache_resident_bytes` — the bytes of the storage a device
  cache's tensors hold (dataset caches and the serving slot pool).
- :func:`validate_cache_budget` — the cache's priced bytes
  (``cache.nbytes / n_shard``) against that storage, at a relative
  tolerance.

Every call here reads host-side allocator state; the chunk driver calls
it between chunks, and only under ``DL4J_PROFILE``.
"""

from __future__ import annotations

import gc
import logging
import warnings
from typing import Any, Dict, List, Optional

import torch

logger = logging.getLogger(__name__)

__all__ = [
    "cache_resident_bytes",
    "live_array_bytes",
    "sample_hbm_watermark",
    "validate_cache_budget",
]


def live_array_bytes() -> Dict[str, int]:
    """Bytes of the storage of every live tensor, by device, found by a
    walk over the garbage collector's objects: the counterpart of the
    reference's ``jax.live_arrays`` walk. A storage shared by several
    tensors (views) counts once."""
    per_device: Dict[str, int] = {}
    seen = set()
    with warnings.catch_warnings():
        # isinstance probes deprecated module proxies, which warn
        warnings.simplefilter("ignore")
        tensors = [o for o in gc.get_objects()
                   if isinstance(o, torch.Tensor)]
    for obj in tensors:
        try:
            if obj.is_meta:
                continue
            st = obj.untyped_storage()
            key = (st.data_ptr(), str(obj.device))
        except Exception:  # sparse or otherwise storage-less tensors
            continue
        if key in seen:
            continue
        seen.add(key)
        dev = str(obj.device)
        per_device[dev] = per_device.get(dev, 0) + int(st.nbytes())
    return per_device


def _device_entries() -> List[dict]:
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        out.append({
            "device": f"cuda:{i}",
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(
                stats.get("allocated_bytes.all.peak", 0)) or None,
            "bytes_limit": int(total) or None,
            "source": "memory_stats",
        })
    return out


def sample_hbm_watermark(tag: Optional[str] = None,
                         record: bool = True) -> dict:
    """One watermark sample: per card, ``bytes_in_use`` and
    ``peak_bytes_in_use`` from the allocator and ``bytes_limit`` from the
    card; with no card, the CPU's live tensors (``source`` says which).
    ``record=True`` mirrors the sample into the registry gauges and
    stamps an ``hbm.watermark`` tracer event."""
    if torch.cuda.is_available():
        devices = _device_entries()
    else:
        live = live_array_bytes()
        n = int(live.get("cpu", 0))
        devices = [{"device": "cpu", "bytes_in_use": n,
                    "peak_bytes_in_use": None, "bytes_limit": None,
                    "source": "live_arrays", "live_array_bytes": n}]
    sample = {
        "tag": tag,
        "devices": devices,
        "total_bytes_in_use": sum(e["bytes_in_use"] for e in devices),
        "max_bytes_in_use": max(
            (e["bytes_in_use"] for e in devices), default=0),
    }
    if record:
        from deeplearning4j_tpu_torch.monitor.registry import metrics
        from deeplearning4j_tpu_torch.monitor.trace import tracer

        reg = metrics()
        in_use = reg.gauge("hbm_bytes_in_use",
                           "per-device bytes in use at the last "
                           "watermark sample")
        peak = reg.gauge("hbm_peak_bytes",
                         "per-device peak bytes (allocator-reported)")
        for e in devices:
            in_use.set(e["bytes_in_use"], device=e["device"],
                       source=e["source"])
            if e["peak_bytes_in_use"] is not None:
                peak.set(e["peak_bytes_in_use"], device=e["device"])
        tracer().event("hbm.watermark", tag=tag,
                       total_bytes=sample["total_bytes_in_use"],
                       max_device_bytes=sample["max_bytes_in_use"])
    return sample


def cache_resident_bytes(cache) -> Dict[str, int]:
    """Bytes of the storage held by a device cache's tensors, by device:
    the dataset caches' features, labels and masks (both cache shapes)
    and the serving slot pool's ``k``/``v`` and their int8 scales. A
    storage shared by several attributes counts once."""
    per_device: Dict[str, int] = {}
    arrays: List[Any] = []
    for attr in ("features", "labels", "features_mask", "labels_mask",
                 "features_masks", "labels_masks",
                 "k", "v", "k_scale", "v_scale"):
        val = getattr(cache, attr, None)
        if val is None:
            continue
        arrays.extend(val if isinstance(val, (tuple, list)) else [val])
    seen = set()
    for arr in arrays:
        if not isinstance(arr, torch.Tensor):
            continue
        st = arr.untyped_storage()
        key = (st.data_ptr(), str(arr.device))
        if key in seen:
            continue
        seen.add(key)
        dev = str(arr.device)
        per_device[dev] = per_device.get(dev, 0) + int(st.nbytes())
    return per_device


def validate_cache_budget(cache, tolerance: float = 0.25) -> dict:
    """The epoch cache's priced resident bytes (``cache.nbytes /
    n_shard``, the resident term of the budget) against the most any
    device holds for it. ``within_tolerance`` is the verdict at relative
    ``tolerance``; a drift beyond it means the budget no longer prices
    what the allocator holds."""
    predicted = cache.nbytes / max(1, cache.n_shard)
    per_device = cache_resident_bytes(cache)
    measured = max(per_device.values(), default=0)
    ratio = measured / predicted if predicted else None
    out = {
        "predicted_per_shard_bytes": int(predicted),
        "measured_per_device_bytes": int(measured),
        "n_shard": cache.n_shard,
        "n_devices_holding": len(per_device),
        "ratio": None if ratio is None else round(ratio, 4),
        "tolerance": tolerance,
        "within_tolerance": (ratio is not None
                             and abs(ratio - 1.0) <= tolerance),
    }
    if not out["within_tolerance"]:
        logger.warning(
            "epoch-cache budget model drift: predicted %d B/shard, "
            "measured %d B on the fullest device (ratio %s, tolerance "
            "%.0f%%)", out["predicted_per_shard_bytes"],
            out["measured_per_device_bytes"], out["ratio"],
            100 * tolerance)
    return out
