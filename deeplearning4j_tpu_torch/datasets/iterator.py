"""DataSetIterator protocol and its wrappers.

Port of ``deeplearning4j_tpu/datasets/iterator.py`` (the reference's
DataSetIterator.java:53, BaseDatasetIterator, AsyncDataSetIterator.java:44,
MultipleEpochsIterator, SamplingDataSetIterator, ReconstructionDataSetIterator
and ListDataSetIterator), with ``BucketedDataSetIterator``.

``AsyncDataSetIterator`` overlaps host batch preparation with the
device's work through a producer thread and a bounded queue; with
``device_prefetch=True`` the producer also copies each batch to the card
on a CUDA stream of its own (see the class).
"""

from __future__ import annotations

import collections
import contextlib
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet


class DataSetIterator:
    """Iterable of DataSet minibatches with reset semantics."""

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        return self

    def __next__(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        return self.next()

    # --- protocol ---
    def has_next(self) -> bool:
        raise NotImplementedError

    def next(self, num: Optional[int] = None) -> DataSet:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def batch(self) -> int:
        raise NotImplementedError

    def total_examples(self) -> int:
        raise NotImplementedError

    def input_columns(self) -> int:
        raise NotImplementedError

    def total_outcomes(self) -> int:
        raise NotImplementedError



class BaseDataSetIterator(DataSetIterator):
    """Iterator over an in-memory fetcher (BaseDatasetIterator.java)."""

    def __init__(self, batch_size: int, num_examples: int, fetcher):
        self.batch_size = int(batch_size)
        self.num_examples_ = int(num_examples)
        self.fetcher = fetcher
        self.cursor = 0

    def has_next(self) -> bool:
        return self.cursor < self.num_examples_

    def next(self, num: Optional[int] = None) -> DataSet:
        n = min(num or self.batch_size, self.num_examples_ - self.cursor)
        ds = self.fetcher.fetch(self.cursor, n)
        self.cursor += n
        return ds

    def reset(self) -> None:
        self.cursor = 0
        if hasattr(self.fetcher, "reset"):
            self.fetcher.reset()

    def batch(self) -> int:
        return self.batch_size

    def total_examples(self) -> int:
        return self.num_examples_

    def input_columns(self) -> int:
        return self.fetcher.input_columns()

    def total_outcomes(self) -> int:
        return self.fetcher.total_outcomes()

class ListDataSetIterator(DataSetIterator):
    """Iterator over a list of examples, re-batched (ListDataSetIterator)."""

    def __init__(self, dataset_or_list, batch_size: int = 10):
        if isinstance(dataset_or_list, DataSet):
            self._batches = dataset_or_list.batch_by(batch_size)
        else:
            merged = DataSet.merge(list(dataset_or_list))
            self._batches = merged.batch_by(batch_size)
        self.batch_size = batch_size
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._batches)

    def next(self, num=None):
        ds = self._batches[self._pos]
        self._pos += 1
        return ds

    def reset(self):
        self._pos = 0

    def batch(self):
        return self.batch_size

    def total_examples(self):
        return sum(b.num_examples() for b in self._batches)

    def input_columns(self):
        return int(self._batches[0].features.shape[-1])

    def total_outcomes(self):
        return int(self._batches[0].labels.shape[-1])



class MultipleEpochsIterator(DataSetIterator):
    """Loops an underlying iterator N times (MultipleEpochsIterator.java)."""

    def __init__(self, num_epochs: int, underlying: DataSetIterator):
        self.num_epochs = int(num_epochs)
        self.underlying = underlying
        self.epoch = 0

    def has_next(self):
        if self.underlying.has_next():
            return True
        if self.epoch + 1 < self.num_epochs:
            self.epoch += 1
            self.underlying.reset()
            return self.underlying.has_next()
        return False

    def next(self, num=None):
        return self.underlying.next(num)

    def reset(self):
        self.epoch = 0
        self.underlying.reset()

    def batch(self):
        return self.underlying.batch()

    def total_examples(self):
        return self.underlying.total_examples() * self.num_epochs

    def input_columns(self):
        return self.underlying.input_columns()

    def total_outcomes(self):
        return self.underlying.total_outcomes()


class SamplingDataSetIterator(DataSetIterator):
    """Batches drawn with replacement (SamplingDataSetIterator): numpy's
    ``default_rng(seed)`` through ``DataSet.sample``, so the batches
    equal the reference's bitwise."""

    def __init__(self, dataset: DataSet, batch_size: int, total_batches: int,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.total_batches = total_batches
        self._rng = np.random.default_rng(seed)
        self._seed = seed
        self._count = 0

    def has_next(self):
        return self._count < self.total_batches

    def next(self, num=None):
        self._count += 1
        return self.dataset.sample(num or self.batch_size, self._rng)

    def reset(self):
        self._count = 0
        self._rng = np.random.default_rng(self._seed)

    def batch(self):
        return self.batch_size

    def total_examples(self):
        return self.batch_size * self.total_batches

    def input_columns(self):
        return int(self.dataset.features.shape[-1])

    def total_outcomes(self):
        return int(self.dataset.labels.shape[-1])


class ReconstructionDataSetIterator(DataSetIterator):
    """Wraps an iterator so that labels are the features
    (ReconstructionDataSetIterator: AutoEncoder and RBM targets)."""

    def __init__(self, underlying: DataSetIterator):
        self.underlying = underlying

    def has_next(self):
        return self.underlying.has_next()

    def next(self, num=None):
        ds = self.underlying.next(num)
        return DataSet(ds.features, ds.features,
                       ds.features_mask, ds.features_mask)

    def reset(self):
        self.underlying.reset()

    def batch(self):
        return self.underlying.batch()

    def total_examples(self):
        return self.underlying.total_examples()

    def input_columns(self):
        return self.underlying.input_columns()

    def total_outcomes(self):
        return self.underlying.input_columns()  # labels are the features

class BucketedDataSetIterator(DataSetIterator):
    """Pads every batch up the batch-bucket ladder with a labels mask that
    is zero on the pad rows (``perf.bucketing.pad_dataset``). On the card
    each distinct batch shape of a fused training path costs one CUDA-graph
    capture, so an epoch's ragged tail (100/100/56 at batch 100) would
    otherwise cost a capture of its own. BatchNorm in train mode takes its
    statistics over all rows, pad rows included: do not wrap the training
    stream of a BatchNorm network (inference uses the stored statistics)."""

    def __init__(self, underlying: DataSetIterator, buckets=None):
        self.underlying = underlying
        self.buckets = buckets

    def has_next(self):
        return self.underlying.has_next()

    def next(self, num=None):
        from deeplearning4j_tpu_torch.perf.bucketing import pad_dataset

        return pad_dataset(self.underlying.next(num), buckets=self.buckets)

    def reset(self):
        self.underlying.reset()

    def batch(self):
        return self.underlying.batch()

    def total_examples(self):
        return self.underlying.total_examples()

    def input_columns(self):
        return self.underlying.input_columns()

    def total_outcomes(self):
        return self.underlying.total_outcomes()


def _map_batch(ds, fn):
    """``fn`` over every array of a DataSet or MultiDataSet (None kept)."""
    f = lambda a: None if a is None else fn(a)
    if isinstance(ds, MultiDataSet):
        lists = lambda xs: None if xs is None else [f(a) for a in xs]
        return MultiDataSet(lists(ds.features), lists(ds.labels),
                            lists(ds.features_masks),
                            lists(ds.labels_masks))
    return DataSet(f(ds.features), f(ds.labels), f(ds.features_mask),
                   f(ds.labels_mask))


def _pinned(shape, dtype) -> torch.Tensor:
    """A page-locked host buffer."""
    return torch.empty(shape, dtype=dtype, pin_memory=True)


def _host_tensor(a):
    """A host array as a CPU tensor (float64 as float32, as the networks'
    own host-to-device move does); a tensor on the card as it is."""
    if isinstance(a, torch.Tensor) and a.device.type == "cuda":
        return a
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    return t.float() if t.dtype == torch.float64 else t


class _DevicePrefetch:
    """The copy side of a device prefetch: a CUDA stream of its own, made
    on the consumer's thread when the producer starts (an error there
    raises to the caller; there is no synchronous fallback).

    :meth:`copy` runs on the producer thread: each host array is copied
    into a page-locked staging buffer and from there to the card with
    ``non_blocking=True`` on the copy stream; the batch is queued with an
    event recorded after its copies. The staging buffers are a ring per
    shape and dtype, allocated at their first use and kept for the
    iterator's life (page-locking is what costs: a fresh pinned buffer a
    batch made the prefetch slower than a synchronous feed). A batch that
    holds ``n`` arrays of one shape and dtype (a MultiDataSet's heads,
    masks of one ``[B, T]``) takes ``n`` distinct buffers of a ring of at
    least ``max(RING, n + 1)``, so no buffer is written twice in a batch;
    before it overwrites a buffer the producer waits on the event of the
    batch whose copy read it last, so the spare buffers overlap one
    batch's host copy with the previous batch's transfer. The device
    tensors are allocated on the copy stream; :meth:`deliver`, on the
    consumer's thread, makes the consumer's stream wait on the event and
    ``record_stream``s every tensor there, so the caching allocator does
    not reuse a block while the step still reads it.

    Captures: no capture may begin while the producer makes a CUDA call.
    The producer calls the CUDA API (pinned and device allocations, event
    waits, copies) only inside ``perf.step_graph.CAPTURE_LOCK``, which a
    graph capture holds for its whole length: a capture waits for the
    copy in hand, and the producer waits while a capture runs
    (``capture_waits`` counts its waits)."""

    RING = 2  # the least staging buffers per (shape, dtype)

    def __init__(self, device: torch.device):
        from deeplearning4j_tpu_torch.perf.step_graph import CAPTURE_LOCK

        self._rings = {}  # (shape, dtype) -> [[pinned buffer, event]]
        self._lock = CAPTURE_LOCK
        self.capture_waits = 0
        with self._held():
            if device.type == "cuda" and device.index is None:
                # "cuda": the consumer's current card
                device = torch.device("cuda", torch.cuda.current_device())
            self.device = device
            self.stream = torch.cuda.Stream(device)

    @contextlib.contextmanager
    def _held(self):
        """``CAPTURE_LOCK``, counting the times a capture held it."""
        if not self._lock.acquire(blocking=False):
            self.capture_waits += 1
            self._lock.acquire()
        try:
            yield
        finally:
            self._lock.release()

    def enter_thread(self) -> None:
        """The producer thread's first call: its current device."""
        with self._held():
            torch.cuda.set_device(self.device)

    def _slot(self, t: torch.Tensor, uses: int):
        """The next staging buffer of ``t``'s shape and dtype, free to
        overwrite: the ring's oldest, once the copy that read it last has
        finished. ``uses`` is the batch's count of arrays of that key."""
        key = (tuple(t.shape), t.dtype)
        ring = self._rings.setdefault(key, [])
        while len(ring) < max(self.RING, uses + 1):
            ring.append([_pinned(t.shape, t.dtype), None])
        slot = ring.pop(0)
        ring.append(slot)
        if slot[1] is not None:
            slot[1].synchronize()
        return slot

    def copy(self, ds):
        hosts = []

        def host(a):
            t = _host_tensor(a)
            if t.device.type != "cuda":
                hosts.append(t)
            return t

        ds = _map_batch(ds, host)
        uses = collections.Counter((tuple(t.shape), t.dtype) for t in hosts)
        used = []

        def put(t):
            if t.device.type == "cuda":
                return t
            slot = self._slot(t, uses[(tuple(t.shape), t.dtype)])
            slot[0].copy_(t)
            used.append(slot)
            return slot[0].to(self.device, non_blocking=True)

        with self._held():
            with torch.cuda.stream(self.stream):
                out = _map_batch(ds, put)
                event = torch.cuda.Event()
                event.record(self.stream)
            for slot in used:
                slot[1] = event
        return _Prefetched(out, event)


class _Prefetched:
    """A batch on the card and the event its copies completed behind."""

    def __init__(self, ds, event):
        self.ds = ds
        self.event = event

    def deliver(self, device: torch.device):
        stream = torch.cuda.current_stream(device)
        stream.wait_event(self.event)
        _map_batch(self.ds, lambda t: t.record_stream(stream))
        return self.ds


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch wrapper (AsyncDataSetIterator.java:44).

    A daemon producer thread drains the underlying iterator into a bounded
    queue (the reference's LinkedBlockingDeque) so host ETL overlaps the
    device's work. ``reset`` stops and joins the producer and resets the
    underlying iterator, as the reference's guarded reset (:77-90).

    ``queue_size`` bounds both buffers: the host queue and, with
    ``device_prefetch=True``, the batches on the card ahead of the
    consumer, because the producer copies each batch to ``device`` (the
    card by default) before it queues it (at most ``queue_size`` queued,
    one in the producer's hand and one in the consumer's). The copies run
    on a CUDA stream of the iterator's own and overlap the steps; see
    :class:`_DevicePrefetch` for the stream, allocator and capture rules.
    On ``device="cpu"`` the prefetch is the identity, as the reference's
    on a CPU backend. Without a card, ``device_prefetch=True`` with the
    default device raises.
    """

    _END = object()

    def __init__(self, underlying: DataSetIterator, queue_size: int = 4,
                 device_prefetch: bool = False, device=None):
        from deeplearning4j_tpu_torch._device import resolve_device

        self.underlying = underlying
        self.queue_size = max(1, int(queue_size))
        self.device_prefetch = device_prefetch
        self.device = resolve_device(device) if device_prefetch else None
        self._queue: queue.Queue = queue.Queue(maxsize=self.queue_size)
        self._thread: Optional[threading.Thread] = None
        self._peek = None
        self._started = False
        self._copier: Optional[_DevicePrefetch] = None

    def _start(self):
        # The producer's queue, stop flag and error slot are local to this
        # generation (captured by the closure, not read off self): a
        # straggler from a previous generation only ever touches its own.
        # The one shared object is ``self.underlying``, which is why
        # _shutdown refuses to start a new generation until the old
        # thread has exited.
        q = queue.Queue(maxsize=self.queue_size)
        stop = threading.Event()
        state = {"error": None}
        self._queue = q
        self._stop_flag = stop
        self._producer_state = state
        copier = None
        if self.device is not None and self.device.type == "cuda":
            if self._copier is None:
                self._copier = _DevicePrefetch(self.device)
            copier = self._copier

        def put_bounded(item) -> bool:
            """Enqueue honoring the stop flag: the producer never blocks
            for good (a parked thread is a leak)."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            produced = 0
            try:
                if copier is not None:
                    copier.enter_thread()
                while not stop.is_set() and self.underlying.has_next():
                    ds = self.underlying.next()
                    if copier is not None:
                        ds = copier.copy(ds)
                    if not put_bounded(ds):
                        return
                    produced += 1
            except BaseException as exc:  # re-raised on the consumer side
                # the consumer sees this batches later (after draining
                # what was prefetched): record which batch the producer
                # was on, so the error names the poisoned input
                state["error"] = exc
                state["error_index"] = produced
            finally:
                put_bounded(self._END)

        self._thread = threading.Thread(target=producer, daemon=True)
        self._thread.start()
        self._started = True

    def has_next(self):
        if self._peek is not None:
            return self._peek is not self._END
        if not self._started:
            self._start()
        self._peek = self._queue.get()
        if self._peek is self._END and self._producer_state["error"] is not None:
            exc = self._producer_state["error"]
            self._producer_state["error"] = None
            raise self._annotate(exc, self._producer_state)
        return self._peek is not self._END

    @staticmethod
    def _annotate(exc: BaseException, state: dict) -> BaseException:
        """Attach the producing batch's index to a producer exception
        (``exc.batch_index`` and a message suffix) without changing its
        type, so callers' except clauses and retry filters keep
        matching."""
        idx = state.get("error_index")
        if idx is None or getattr(exc, "batch_index", None) is not None:
            return exc
        exc.batch_index = idx
        note = f"[while producing batch #{idx}]"
        if exc.args and isinstance(exc.args[0], str):
            exc.args = (f"{exc.args[0]} {note}",) + exc.args[1:]
        else:
            exc.args = exc.args + (note,)
        return exc

    def next(self, num=None):
        if not self.has_next():
            raise StopIteration
        item, self._peek = self._peek, None
        if isinstance(item, _Prefetched):
            return item.deliver(self.device)
        return item

    def reset(self):
        self._shutdown()
        self.underlying.reset()
        self._peek = None
        self._started = False

    def _shutdown(self):
        """Stop and join the producer. Safe mid-epoch: the stop flag
        bounds every producer wait (the final _END put included), and the
        queue is drained so that a blocked put wakes at once. A thread
        still alive after the join is parked inside
        ``underlying.next()`` (a stalled fetch); resetting the shared
        underlying iterator under it would corrupt the stream, so this
        raises instead."""
        if not self._started or self._thread is None:
            return
        self._stop_flag.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
        if self._thread.is_alive():
            raise RuntimeError(
                "AsyncDataSetIterator producer did not stop within 5s "
                "(blocked inside underlying.next()?); refusing to reset "
                "the shared underlying iterator while it is still in use")
        self._thread = None

    def batch(self):
        return self.underlying.batch()

    def total_examples(self):
        return self.underlying.total_examples()

    def input_columns(self):
        return self.underlying.input_columns()

    def total_outcomes(self):
        return self.underlying.total_outcomes()
