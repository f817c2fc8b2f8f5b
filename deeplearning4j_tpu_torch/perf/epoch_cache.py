"""Device-resident dataset cache and the chunk driver of ``fit_epochs``.

Port of ``deeplearning4j_tpu/perf/epoch_cache.py``. ``fit(iterator)``
moves every batch to the device again in every epoch, and launches each
step from the host. ``DeviceDataSetCache`` drains the iterator once, pads
every batch to one bucket (``perf.bucketing``: the largest rung any batch
needs, so a 100/100/56 epoch at batch 100 stacks as ``[3, 128, ...]``),
and moves each ``[N, B, ...]`` stack to the device once for the whole
run. ``fit_epochs`` on both network classes then runs E epochs x N
batches as replays of one captured step (``perf/step_graph.py``): the
step gathers its batch from the stacks through a device cursor into the
epoch's batch order, which is drawn once per epoch with ``torch.randperm``
on the network's generator (``epoch_schedule``). The loss history comes
back as one ``[E, N]`` device tensor.

The cache respects a device-memory budget (``DL4J_DEVICE_CACHE_MB``,
default 2048): ``build`` returns ``None``, and never raises, when the
padded dataset would not fit or when the batches cannot stack (ragged
trailing shapes, missing labels); the caller then streams
(:func:`stream_epochs`). ``DL4J_CACHE_DTYPE=bfloat16`` stores features
and labels in bf16 (masks stay float32), and ``accum_steps=K`` divides the
step's working-set term of the budget by K, as in the reference.

Pad rows drop out of every mask-weighted loss (the labels mask is always
materialised, zero on pad rows). Train-mode BatchNorm takes its
statistics over all rows, pad rows included, as in the reference.

Not ported: ``mesh=`` and ``respec`` (sharding the stacks over a device
mesh, and the elastic reshard that re-places them; ROADMAP A14), the
asynchronous device prefetch of the streaming fallback (A11) and the run
ledger's chunk hooks and device-memory watermarks (A12).
"""

from __future__ import annotations

import logging
import os
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.perf.bucketing import bucket_size, pad_axis0

DEFAULT_CACHE_MB = 2048


def mesh_not_ported(what: str) -> NotImplementedError:
    """The error of everything that trains or caches over a device mesh."""
    return NotImplementedError(
        f"{what} (training over a device mesh) is not ported yet "
        "(ROADMAP A14)")


def cache_budget_mb() -> float:
    """Device-memory budget of the epoch cache (``DL4J_DEVICE_CACHE_MB``);
    0 disables the cache (every ``fit_epochs`` call streams)."""
    raw = os.environ.get("DL4J_DEVICE_CACHE_MB", "")
    try:
        return float(raw) if raw else float(DEFAULT_CACHE_MB)
    except ValueError:
        return float(DEFAULT_CACHE_MB)


def cache_dtype() -> Optional[torch.dtype]:
    """Storage dtype of the features and labels stacks
    (``DL4J_CACHE_DTYPE``): ``bfloat16``/``bf16`` gives torch's bfloat16;
    anything else keeps the source dtype. Masks are never narrowed."""
    raw = os.environ.get("DL4J_CACHE_DTYPE", "").strip().lower()
    if raw in ("bfloat16", "bf16"):
        return torch.bfloat16
    return None


def accum_steps_default() -> int:
    """Default gradient-accumulation factor of ``fit_epochs``
    (``DL4J_ACCUM_STEPS``, default 1)."""
    raw = os.environ.get("DL4J_ACCUM_STEPS", "")
    try:
        return max(1, int(raw)) if raw else 1
    except ValueError:
        return 1


def effective_accum_steps(requested: int, batch: int) -> int:
    """Largest divisor of ``batch`` that is <= ``requested`` (logged when
    it is not ``requested`` itself)."""
    requested = max(1, int(requested))
    if requested <= 1 or batch <= 0:
        return 1
    batch = int(batch)
    k = next(d for d in range(min(requested, batch), 0, -1)
             if batch % d == 0)
    if k != requested:
        logging.getLogger(__name__).warning(
            "accum_steps=%d does not divide the bucket batch %d; "
            "clamped to %d", requested, batch, k)
    return k


def epoch_schedule(gen: torch.Generator, n_batches: int, shuffle: bool,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One epoch's batch order, an int64 tensor on the generator's device:
    ``torch.randperm`` drawn from ``gen`` when shuffling, else
    ``arange`` (which draws nothing). The fused path writes it into its
    static ``out`` buffer; the tests and the ``raise`` replay call it on
    a generator cloned from the same state, so both see the same orders
    and the steps the same dropout draws."""
    device = gen.device if out is None else out.device
    if not shuffle:
        order = torch.arange(n_batches, device=device)
        return order if out is None else out.copy_(order)
    if out is None:
        return torch.randperm(n_batches, generator=gen, device=device)
    return torch.randperm(n_batches, generator=gen, out=out)


def clone_generator(gen: torch.Generator) -> torch.Generator:
    """A new generator on ``gen``'s device in ``gen``'s current state."""
    other = torch.Generator(device=gen.device)
    other.set_state(gen.get_state())
    return other


def _nbytes_padded(a, target_rows: int, itemsize: Optional[int] = None) -> int:
    if a is None:
        return 0
    size = a.dtype.itemsize if itemsize is None else itemsize
    per_row = int(np.prod(a.shape[1:], dtype=np.int64)) * size
    return per_row * target_rows


def _host(a) -> Optional[np.ndarray]:
    """A batch array as numpy (a tensor on the card is read back once, at
    build); float64 becomes float32, the reference's default dtype."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == np.float64 else a


def _stack_padded(arrays: Sequence, target: int) -> np.ndarray:
    return np.stack([pad_axis0(_host(a), target) for a in arrays])


def _host_label_mask(labels: np.ndarray, mask, target: int) -> np.ndarray:
    """The labels mask (or ones) as float32, extended with zeros so that
    pad rows drop out of every mask-weighted reduction."""
    n = int(labels.shape[0])
    if mask is None:
        shape = (n,) if labels.ndim == 2 else (n, int(labels.shape[1]))
        mask = np.ones(shape, np.float32)
    return pad_axis0(_host(mask).astype(np.float32), target)


def _place(arr: np.ndarray, device, dtype=None) -> torch.Tensor:
    """One host-to-device transfer of a stack (then the narrowing cast)."""
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return t if dtype is None else t.to(dtype)


def _drain(data) -> Optional[List[Any]]:
    if hasattr(data, "features"):  # a single (Multi)DataSet
        return [data]
    return list(data)  # DataSetIterator.__iter__ resets


class DeviceDataSetCache:
    """The whole dataset as four device-resident ``[N, B, ...]`` stacks:
    features, labels, the features mask (or None) and the labels mask
    (always materialised)."""

    def __init__(self, features, labels, features_mask, labels_mask,
                 n_batches: int, batch: int, total_examples: int,
                 nbytes: int, mesh=None, n_shard: int = 1):
        self.features = features
        self.labels = labels
        self.features_mask = features_mask
        self.labels_mask = labels_mask
        self.n_batches = n_batches
        self.batch = batch
        self.total_examples = total_examples
        self.nbytes = nbytes
        self.mesh = mesh
        self.n_shard = n_shard

    @property
    def device(self) -> torch.device:
        return self.features.device

    def respec(self, mesh) -> "DeviceDataSetCache":
        raise mesh_not_ported("respec")

    @classmethod
    def build(cls, data, budget_mb: Optional[float] = None,
              buckets: Optional[Sequence[int]] = None, mesh=None,
              accum_steps: int = 1,
              device=None) -> Optional["DeviceDataSetCache"]:
        """Drain ``data`` (an iterator, a list of DataSets or one DataSet)
        onto ``device`` (default: the card). ``None`` when over budget or
        not stackable; the iterator is then reset for streaming."""
        return _traced_build(cls, data, budget_mb, buckets, mesh,
                             accum_steps, device)

    @classmethod
    def _build(cls, data, budget_mb, buckets, accum_steps, device):
        budget = cache_budget_mb() if budget_mb is None else float(budget_mb)
        if budget <= 0:
            return None
        limit = budget * 1024 ** 2
        try:
            batches = _drain(data)
        except TypeError:
            return None
        if not batches:
            return None
        if any(getattr(ds, "labels", None) is None for ds in batches):
            return None  # the loss needs labels
        dtype = cache_dtype()
        itemsize = None if dtype is None else dtype.itemsize
        target = 0
        running = 0
        for ds in batches:
            b = bucket_size(int(ds.features.shape[0]), buckets)
            target = max(target, b)
            running += (_nbytes_padded(ds.features, b, itemsize)
                        + _nbytes_padded(ds.labels, b, itemsize))
            if running > limit:  # early exit; the check below governs
                _reset(data)
                return None
        total = 0
        step_bytes = 0
        for ds in batches:
            data_bytes = (_nbytes_padded(ds.features, target, itemsize)
                          + _nbytes_padded(ds.labels, target, itemsize))
            step_bytes = max(step_bytes, data_bytes)
            total += (data_bytes
                      + _nbytes_padded(ds.features_mask, target)
                      + 4 * target * (1 if ds.labels.ndim == 2
                                      else int(ds.labels.shape[1])))
        # the resident stacks plus the step's working set (the gathered
        # batch and its gradient-side twin), the latter divided by K
        accum = effective_accum_steps(accum_steps, target)
        if total + 2 * step_bytes / accum > limit:
            _reset(data)
            return None
        any_fm = any(ds.features_mask is not None for ds in batches)
        try:
            features = _stack_padded([ds.features for ds in batches], target)
            labels = _stack_padded([ds.labels for ds in batches], target)
            fm = None
            if any_fm:
                fm = _stack_padded(
                    [ds.features_mask if ds.features_mask is not None
                     else np.ones(ds.features.shape[:2], np.float32)
                     for ds in batches], target)
            lm = np.stack([_host_label_mask(_host(ds.labels),
                                            ds.labels_mask, target)
                           for ds in batches])
        except ValueError:  # ragged trailing shapes: cannot stack
            _reset(data)
            return None
        device = resolve_device(device)
        return cls(_place(features, device, dtype),
                   _place(labels, device, dtype),
                   None if fm is None else _place(fm, device),
                   _place(lm, device),
                   n_batches=len(batches), batch=target,
                   total_examples=sum(int(ds.features.shape[0])
                                      for ds in batches),
                   nbytes=total)

    def batch_stacks(self) -> Tuple:
        """``(features, labels, features_mask, labels_mask)``, the
        structure of a ``MultiLayerNetwork`` batch."""
        return (self.features, self.labels, self.features_mask,
                self.labels_mask)


class DeviceMultiDataSetCache:
    """``DeviceDataSetCache`` for MultiDataSet streams (ComputationGraph):
    per-position tuples of ``[N, B, ...]`` stacks. DataSet batches are
    promoted with ``MultiDataSet.from_dataset``."""

    def __init__(self, features: Tuple, labels: Tuple,
                 features_masks: Optional[Tuple], labels_masks: Tuple,
                 n_batches: int, batch: int, total_examples: int,
                 nbytes: int, mesh=None, n_shard: int = 1):
        self.features = features
        self.labels = labels
        self.features_masks = features_masks
        self.labels_masks = labels_masks
        self.n_batches = n_batches
        self.batch = batch
        self.total_examples = total_examples
        self.nbytes = nbytes
        self.mesh = mesh
        self.n_shard = n_shard

    @property
    def device(self) -> torch.device:
        return self.features[0].device

    def respec(self, mesh) -> "DeviceMultiDataSetCache":
        raise mesh_not_ported("respec")

    @classmethod
    def build(cls, data, budget_mb: Optional[float] = None,
              buckets: Optional[Sequence[int]] = None, mesh=None,
              accum_steps: int = 1,
              device=None) -> Optional["DeviceMultiDataSetCache"]:
        return _traced_build(cls, data, budget_mb, buckets, mesh,
                             accum_steps, device)

    @classmethod
    def _build(cls, data, budget_mb, buckets, accum_steps, device):
        from deeplearning4j_tpu_torch.datasets.dataset import (
            DataSet, MultiDataSet)

        budget = cache_budget_mb() if budget_mb is None else float(budget_mb)
        if budget <= 0:
            return None
        limit = budget * 1024 ** 2
        try:
            batches = _drain(data)
        except TypeError:
            return None
        batches = [MultiDataSet.from_dataset(b) if isinstance(b, DataSet)
                   else b for b in batches]
        if not batches:
            return None
        n_in = len(batches[0].features)
        n_out = len(batches[0].labels)
        if any(len(b.features) != n_in or len(b.labels) != n_out
               or any(l is None for l in b.labels) for b in batches):
            return None
        dtype = cache_dtype()
        itemsize = None if dtype is None else dtype.itemsize
        target = 0
        running = 0
        for mds in batches:
            b = bucket_size(int(mds.features[0].shape[0]), buckets)
            target = max(target, b)
            running += sum(_nbytes_padded(a, b, itemsize)
                           for a in list(mds.features) + list(mds.labels))
            if running > limit:
                _reset(data)
                return None
        try:
            features = tuple(
                _stack_padded([b.features[i] for b in batches], target)
                for i in range(n_in))
            labels = tuple(
                _stack_padded([b.labels[i] for b in batches], target)
                for i in range(n_out))
            fms = None
            if any(b.features_masks is not None
                   and any(m is not None for m in b.features_masks)
                   for b in batches):
                fms = tuple(
                    _stack_padded(
                        [_mask_or_ones(b, i) for b in batches], target)
                    for i in range(n_in))
            lms = tuple(
                np.stack([
                    _host_label_mask(
                        _host(b.labels[i]),
                        None if b.labels_masks is None else b.labels_masks[i],
                        target)
                    for b in batches])
                for i in range(n_out))
        except ValueError:
            _reset(data)
            return None
        nbytes = sum(_stored_nbytes(a, itemsize) for a in features + labels)
        nbytes += sum(a.nbytes for a in lms)
        if fms is not None:
            nbytes += sum(a.nbytes for a in fms)
        step_bytes = sum(_stored_nbytes(a[0], itemsize)
                         for a in features + labels)
        accum = effective_accum_steps(accum_steps, target)
        if nbytes + 2 * step_bytes / accum > limit:
            _reset(data)
            return None
        device = resolve_device(device)
        return cls(tuple(_place(a, device, dtype) for a in features),
                   tuple(_place(a, device, dtype) for a in labels),
                   None if fms is None else tuple(_place(a, device)
                                                  for a in fms),
                   tuple(_place(a, device) for a in lms),
                   n_batches=len(batches), batch=target,
                   total_examples=sum(int(b.features[0].shape[0])
                                      for b in batches),
                   nbytes=nbytes)

    def batch_stacks(self) -> Tuple:
        """``(features, labels, features_masks, labels_masks)`` as lists,
        the structure of a ``ComputationGraph`` batch."""
        return (list(self.features), list(self.labels),
                None if self.features_masks is None
                else list(self.features_masks),
                list(self.labels_masks))


def _stored_nbytes(a: np.ndarray, itemsize: Optional[int]) -> int:
    """Bytes of ``a`` once stored (narrowed to ``itemsize`` if given)."""
    return a.nbytes if itemsize is None else a.size * itemsize


def _traced_build(cls, data, budget_mb, buckets, mesh, accum_steps, device):
    """``cache.build`` span around either class's ``_build`` (the drain,
    pad and transfer are the fused path's one serial host cost)."""
    from deeplearning4j_tpu_torch.monitor import record_counter, tracer

    if mesh is not None:
        raise mesh_not_ported("mesh=")
    with tracer().span("cache.build", kind=cls.__name__) as sp:
        out = cls._build(data, budget_mb, buckets, accum_steps, device)
        sp.attrs["cached"] = out is not None
        if out is not None:
            sp.attrs.update(n_batches=out.n_batches, batch=out.batch,
                            mb=round(out.nbytes / 1024 ** 2, 3),
                            n_shard=out.n_shard)
    record_counter("cache_builds_total", kind=cls.__name__,
                   outcome="cached" if out is not None else "fallback")
    return out


def chunk_deadline_s(chunk_steps: int, width_factor: float = 1.0) -> float:
    """StepWatchdog deadline of one chunk: ``DL4J_STEP_DEADLINE_S`` per
    step when set, else 30 s a step with a floor of 120 s (the first
    chunk builds kernels and captures its step)."""
    raw = os.environ.get("DL4J_STEP_DEADLINE_S", "")
    steps = max(1, int(chunk_steps))
    factor = max(1.0, float(width_factor))
    try:
        if raw:
            return float(raw) * steps * factor
    except ValueError:
        pass
    return max(120.0, 30.0 * steps * factor)


def drive_epoch_chunks(net, cache, num_epochs: int,
                       chunk_epochs: Optional[int], launch_chunk, *,
                       shuffle: bool = True, guard: str = "off",
                       replay_step=None, on_chunk=None, reshard=None):
    """The host-side chunk driver behind both classes' ``fit_epochs``.

    ``launch_chunk(k) -> ([k, N] losses, [k, N] trips or None, [k, N, 4]
    metrics or None)`` runs k epochs (drawing each epoch's order from
    ``net._rng``) and updates the network's state itself. The driver
    advances ``iteration_count`` by k·N, fires listeners once per chunk
    (``chunk_done(net, it0, losses, metrics=)`` where a listener has it,
    else ``iteration_done``), and calls ``on_chunk(epochs_done)``, whose
    True stops the run. Default chunking: the whole run without
    listeners, one epoch with them. Returns the ``[E, N]`` loss history.

    The sentinel history is read as the reference reads it: ``skip``
    keeps the device tensors and reads them once at the end of the run;
    ``halve_lr`` and ``raise`` read each chunk's (one host sync a chunk),
    and ``raise`` snapshots the state and the generator before each chunk
    so that ``replay_step(params, upd, nst, iteration, batch_index, gen)
    -> (params, upd, nst, loss)`` can replay it step by step. The metrics
    history stays on the device (``net._last_metrics``).

    Every chunk opens an ``epoch.chunk`` span, bumps
    ``train_chunk_dispatches_total`` and runs under a ``StepWatchdog``
    whose deadline scales with its steps; ``epoch.chunk`` is a fault
    site. A pending elastic reshard is applied through ``reshard`` or,
    without it, logged and dropped (the port has no mesh, ROADMAP A14).
    """
    from deeplearning4j_tpu_torch.monitor import record_counter, tracer
    from deeplearning4j_tpu_torch.resilience import faults
    from deeplearning4j_tpu_torch.resilience.watchdog import StepWatchdog

    if chunk_epochs is None:
        chunk_epochs = 1 if net.listeners else num_epochs
    chunk_epochs = max(1, min(int(chunk_epochs), num_epochs))
    model_name = type(net).__name__
    history = []
    sentinel_chunks = []
    metrics_chunks = []
    net._last_sentinel = None
    net._last_metrics = None
    defer_inspect = guard not in ("halve_lr", "raise")
    done = 0
    watchdog = StepWatchdog(chunk_deadline_s(chunk_epochs * cache.n_batches))
    net._chunk_watchdog = watchdog
    try:
        with watchdog:
            while done < num_epochs:
                pending = getattr(net, "_pending_mesh", None)
                if pending is not None:
                    net._pending_mesh = None
                    if reshard is None:
                        logging.getLogger(__name__).warning(
                            "elastic reshard requested but this fit path "
                            "has no reshard; request dropped")
                    else:
                        with tracer().span("reshard.elastic",
                                           model=model_name, epoch0=done):
                            reshard(pending[0])
                        record_counter("elastic_reshards_total",
                                       model=model_name)
                k = min(chunk_epochs, num_epochs - done)
                faults.fault_point("epoch.chunk")
                snapshot = gen_state = None
                it0 = net.iteration_count
                if guard == "raise":
                    # the chunk overwrites the state: keep the last good
                    # copy and the generator's state for the replay
                    snapshot = tuple(
                        _tree_clone(t) for t in (net.params,
                                                 net.updater_state,
                                                 net.net_state))
                    gen_state = net._rng.get_state()
                with tracer().span("epoch.chunk", model=model_name,
                                   epochs=k, steps=k * cache.n_batches,
                                   epoch0=done):
                    hist, trips, mets = launch_chunk(k)
                watchdog.beat()
                record_counter("train_chunk_dispatches_total",
                               model=model_name)
                net.iteration_count += k * cache.n_batches
                net._score = hist[-1, -1]  # device scalar
                if mets is not None:
                    metrics_chunks.append(mets)
                if trips is not None:
                    if defer_inspect:
                        sentinel_chunks.append(trips)
                    else:
                        with tracer().span("epoch.readback",
                                           what="sentinel"):
                            t = trips.cpu().numpy()
                        sentinel_chunks.append(t)
                        if t.any():
                            _enforce_nan_guard(
                                net, guard, t, done, gen_state, shuffle,
                                cache.n_batches, snapshot, it0, replay_step)
                history.append(hist)
                done += k
                for listener in net.listeners:
                    chunk_cb = getattr(listener, "chunk_done", None)
                    if chunk_cb is not None:
                        chunk_cb(net, it0, hist, metrics=mets)
                    else:
                        listener.iteration_done(net, net.iteration_count)
                if on_chunk is not None and on_chunk(done):
                    break
    finally:
        # flushed even when ``raise`` aborts the run: a handler of
        # TrainingDivergedError reads the history that tripped it
        if metrics_chunks:
            net._last_metrics = _concat_chunks(metrics_chunks)
        if sentinel_chunks:
            with tracer().span("epoch.readback", what="sentinel_flush"):
                full = np.concatenate([
                    t.cpu().numpy() if isinstance(t, torch.Tensor) else t
                    for t in sentinel_chunks])
            net._last_sentinel = full
            if defer_inspect and full.any():
                _enforce_nan_guard(net, guard, full, 0, None, shuffle,
                                   cache.n_batches, None, 0, None)
    return _concat_chunks(history)


def _tree_clone(tree):
    from deeplearning4j_tpu_torch.dtypes import tree_map

    return tree_map(torch.clone, tree)


def _concat_chunks(chunks):
    return chunks[0] if len(chunks) == 1 else torch.cat(chunks)


def _enforce_nan_guard(net, policy: str, trips: np.ndarray,
                       done_epochs: int, gen_state, shuffle: bool,
                       n_batches: int, snapshot, it0: int,
                       replay_step) -> None:
    """The host-side policy for a chunk whose sentinel tripped; ``trips``
    is its ``[k, N]`` bool history."""
    from deeplearning4j_tpu_torch.resilience.guard import (
        TrainingDivergedError)

    log = logging.getLogger(__name__)
    n_trips = int(trips.sum())
    e_rel, step = (int(v) for v in np.argwhere(trips)[0])
    epoch = done_epochs + e_rel
    if policy == "halve_lr":
        net._lr_scale_host = getattr(net, "_lr_scale_host", 1.0) * 0.5
        log.warning(
            "numeric sentinel: %d non-finite step(s) skipped in-program "
            "(first at epoch %d, step %d); halving host LR scale to %g "
            "[DL4J_NAN_GUARD=halve_lr]", n_trips, epoch, step,
            net._lr_scale_host)
        return
    if policy != "raise":
        log.warning(
            "numeric sentinel: %d non-finite step(s) skipped in-program "
            "(first at epoch %d, step %d); params/updater state carried "
            "unchanged through them [DL4J_NAN_GUARD=skip]", n_trips,
            epoch, step)
        return
    batch_index = loss = None
    if replay_step is not None and snapshot is not None:
        batch_index, loss = _replay_localize(
            replay_step, snapshot, gen_state, net._rng.device, shuffle,
            n_batches, e_rel, step, it0)
    raise TrainingDivergedError(epoch=epoch, step=step,
                                batch_index=batch_index, loss=loss,
                                n_trips=n_trips)


def _replay_localize(replay_step, snapshot, gen_state, device,
                     shuffle: bool, n_batches: int, e_trip: int,
                     s_trip: int, it0: int):
    """Replay the chunk step by step from its snapshot through the first
    tripped step, each epoch's order re-drawn from a generator in the
    chunk's starting state, so the replay visits the same batches with
    the same draws. Returns ``(batch_index, loss)`` of that step."""
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    params, upd, nst = snapshot
    it = it0
    order = None
    loss = None
    for e in range(e_trip + 1):
        order = epoch_schedule(gen, n_batches, shuffle).cpu().numpy()
        last = s_trip if e == e_trip else n_batches - 1
        for j in range(last + 1):
            params, upd, nst, loss = replay_step(
                params, upd, nst, it, int(order[j]), gen)
            it += 1
    return int(order[s_trip]), float(loss)


def stream_epochs(net, data, num_epochs: int) -> None:
    """The over-budget fallback: ``net.fit`` once per epoch. The
    reference streams through ``AsyncDataSetIterator`` with device
    prefetch (A11); the results are the same either way."""
    for _ in range(num_epochs):
        net.fit(data)


def _mask_or_ones(mds, i):
    m = None if mds.features_masks is None else mds.features_masks[i]
    if m is not None:
        return m
    f = mds.features[i]
    shape = tuple(f.shape[:2]) if f.ndim == 3 else (int(f.shape[0]), 1)
    return np.ones(shape, np.float32)


def _reset(data) -> None:
    """Hand a drained iterator back ready for streaming."""
    if hasattr(data, "reset"):
        data.reset()
