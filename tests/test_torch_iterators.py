"""Port parity for the rest of ``datasets/iterator.py``: the base,
multi-epoch, sampling and reconstruction iterators against
``deeplearning4j_tpu.datasets.iterator`` on the same seeded numpy data
(bitwise: both sides only slice and draw with numpy), and
``AsyncDataSetIterator``'s semantics as the reference's tests exercise
them (``tests/test_regressions.py``, ``tests/test_epoch_cache.py``): a
full epoch and reset, error propagation with the batch index, resets
mid-epoch, a straggler generation, the queue bound, and the refusal to
reset under a stalled producer. The CUDA-stream prefetch itself runs on
the card (``chip_smoke.py`` phase 11); here ``device="cpu"`` makes it the
identity, and ``fit_epochs``'s streaming fallback through it equals a
plain ``fit`` loop bitwise."""

import contextlib
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import iterator as jax_it
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu_torch.datasets import (
    AsyncDataSetIterator,
    BaseDataSetIterator,
    DataSet,
    ListDataSetIterator,
    MultipleEpochsIterator,
    ReconstructionDataSetIterator,
    SamplingDataSetIterator,
)
from deeplearning4j_tpu_torch.dtypes import tree_leaves
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.perf import epoch_cache as ec


def _arrays(n=40, d=3, c=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]
    return x, y


def _same(ours, theirs):
    assert len(ours) == len(theirs) and ours
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(np.asarray(a.features),
                                      np.asarray(b.features))
        np.testing.assert_array_equal(np.asarray(a.labels),
                                      np.asarray(b.labels))


class _Fetcher:
    def __init__(self, x, y, ds_cls):
        self.x, self.y, self.ds_cls = x, y, ds_cls
        self.resets = 0

    def fetch(self, start, num):
        return self.ds_cls(self.x[start:start + num],
                           self.y[start:start + num])

    def reset(self):
        self.resets += 1

    def input_columns(self):
        return self.x.shape[1]

    def total_outcomes(self):
        return self.y.shape[1]


def test_base_iterator_matches_reference():
    x, y = _arrays(23)
    ours = BaseDataSetIterator(5, 23, _Fetcher(x, y, DataSet))
    theirs = jax_it.BaseDataSetIterator(5, 23, _Fetcher(x, y, JaxDataSet))
    _same(list(ours), list(theirs))
    assert ours.fetcher.resets == 1  # __iter__ resets
    assert (ours.input_columns(), ours.total_outcomes()) == (3, 2)
    ours.reset()
    assert ours.next(num=7).num_examples() == 7


@pytest.mark.parametrize("epochs", [1, 3])
def test_multiple_epochs_matches_reference(epochs):
    x, y = _arrays(30)
    ours = MultipleEpochsIterator(epochs, ListDataSetIterator(DataSet(x, y),
                                                              8))
    theirs = jax_it.MultipleEpochsIterator(
        epochs, jax_it.ListDataSetIterator(JaxDataSet(x, y), 8))
    _same(list(ours), list(theirs))
    assert ours.total_examples() == 30 * epochs
    _same(list(ours), list(theirs))  # a second pass after reset


@pytest.mark.parametrize("n,batch,seed", [(40, 8, 0), (6, 10, 3)])
def test_sampling_iterator_bitwise(n, batch, seed):
    x, y = _arrays(n, seed=seed)
    ours = SamplingDataSetIterator(DataSet(x, y), batch, 5, seed=seed)
    theirs = jax_it.SamplingDataSetIterator(JaxDataSet(x, y), batch, 5,
                                            seed=seed)
    a, b = list(ours), list(theirs)
    _same(a, b)
    _same(list(ours), a)  # reset re-seeds
    assert ours.total_examples() == batch * 5


def test_reconstruction_iterator_matches_reference():
    x, y = _arrays(20)
    ours = ReconstructionDataSetIterator(ListDataSetIterator(DataSet(x, y),
                                                             6))
    theirs = jax_it.ReconstructionDataSetIterator(
        jax_it.ListDataSetIterator(JaxDataSet(x, y), 6))
    a, b = list(ours), list(theirs)
    _same(a, b)
    for ds in a:
        np.testing.assert_array_equal(ds.features, ds.labels)
    assert ours.total_outcomes() == 3


# ---------------------------------------------------------------------------
# AsyncDataSetIterator
# ---------------------------------------------------------------------------
def _list_it(n=40, batch=10):
    x, y = _arrays(n)
    return ListDataSetIterator(DataSet(x, y), batch)


def test_async_full_epoch_and_reset():
    it = AsyncDataSetIterator(_list_it())
    a = list(it)
    b = list(it)
    assert len(a) == len(b) == 4
    _same(a, b)
    _same(a, list(_list_it()))


@pytest.mark.parametrize("exc_type", [RuntimeError, KeyError])
def test_async_error_keeps_type_and_names_batch(exc_type):
    class Boom(ListDataSetIterator):
        def next(self, num=None):
            if self._pos >= 1:
                raise exc_type("corrupt batch")
            return super().next(num)

    x, y = _arrays()
    it = AsyncDataSetIterator(Boom(DataSet(x, y), 10))
    with pytest.raises(exc_type, match="corrupt batch") as ei:
        while it.has_next():
            it.next()
    assert ei.value.batch_index == 1
    assert "while producing batch #1" in str(ei.value)


def test_async_reset_midepoch_joins_producer():
    it = AsyncDataSetIterator(_list_it(80, 8), queue_size=2)
    assert it.has_next()
    it.next()
    thread = it._thread
    it.reset()
    assert thread is not None and not thread.is_alive()
    assert it._thread is None
    assert len(list(it)) == 10


def test_async_repeated_resets_leave_no_threads():
    it = AsyncDataSetIterator(_list_it(80, 8), queue_size=2)
    baseline = threading.active_count()
    for _ in range(5):
        assert it.has_next()
        it.next()
        it.reset()
    deadline = time.time() + 5
    while threading.active_count() > baseline and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= baseline


def test_async_straggler_cannot_pollute_new_generation():
    class Slow(ListDataSetIterator):
        def next(self, num=None):
            time.sleep(0.02)
            return super().next(num)

    x, y = _arrays()
    it = AsyncDataSetIterator(Slow(DataSet(x, y), 8), queue_size=2)
    assert it.has_next()
    it.reset()
    batches = list(it)
    assert len(batches) == 5
    np.testing.assert_array_equal(
        np.concatenate([b.features for b in batches]), x)


def test_async_queue_size_bounds_what_is_produced_ahead():
    class Counting(ListDataSetIterator):
        produced = 0

        def next(self, num=None):
            type(self).produced += 1
            return super().next(num)

    x, y = _arrays(80)
    it = AsyncDataSetIterator(Counting(DataSet(x, y), 8), queue_size=3)
    assert it.has_next()  # one batch taken by the consumer
    time.sleep(0.3)
    # queued (3) + the consumer's peek (1) + one in the producer's hand
    assert Counting.produced <= 3 + 1 + 1
    it.reset()


def test_async_refuses_reset_under_stalled_producer():
    release = threading.Event()

    class Stuck(ListDataSetIterator):
        def next(self, num=None):
            if self._pos == 1:
                release.wait(30)
            return super().next(num)

    x, y = _arrays()
    it = AsyncDataSetIterator(Stuck(DataSet(x, y), 10), queue_size=1)
    assert it.has_next()
    it.next()
    time.sleep(0.05)  # the producer is now parked inside next()
    with pytest.raises(RuntimeError, match="did not stop"):
        it.reset()
    release.set()


def test_async_device_prefetch_on_cpu_is_identity():
    x, y = _arrays()
    it = AsyncDataSetIterator(ListDataSetIterator(DataSet(x, y), 10),
                              device_prefetch=True, device="cpu")
    got = list(it)
    _same(got, list(_list_it()))
    assert all(isinstance(b.features, np.ndarray) for b in got)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the "
                    "behaviour without a card")
def test_async_device_prefetch_without_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AsyncDataSetIterator(_list_it(), device_prefetch=True)


class _FakeEvent:
    """A CUDA event's host side: which batch recorded it, and waits."""

    recorded = 0

    def __init__(self):
        self.waits = 0

    def record(self, stream):
        _FakeEvent.recorded += 1
        self.batch = _FakeEvent.recorded

    def synchronize(self):
        self.waits += 1


@pytest.fixture
def host_copier(monkeypatch):
    """A ``_DevicePrefetch`` whose copy stream, events and pinned buffers
    are host stand-ins and whose target is the CPU: ``.to("cpu")`` hands
    back the staging buffer itself, so an output array shows what was
    written into its buffer last."""
    from deeplearning4j_tpu_torch.datasets import iterator as it_mod

    monkeypatch.setattr(torch.cuda, "Stream", lambda device: object())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(it_mod, "_pinned",
                        lambda shape, dtype: torch.empty(shape, dtype=dtype))
    return it_mod._DevicePrefetch(torch.device("cpu"))


def test_device_prefetch_never_reuses_a_buffer_within_a_batch(host_copier):
    """A MultiDataSet with four arrays of one shape and dtype takes four
    distinct staging buffers; the next batch rewrites a buffer only after
    waiting on the event of the batch that read it."""
    from deeplearning4j_tpu_torch.datasets import MultiDataSet

    rng = np.random.default_rng(7)
    for batch in range(3):
        arrays = [rng.random((8, 5), np.float32) for _ in range(4)]
        mds = MultiDataSet(arrays[:2], arrays[2:])
        out = host_copier.copy(mds).ds
        got = list(out.features) + list(out.labels)
        assert len({t.data_ptr() for t in got}) == 4
        for g, a in zip(got, arrays):
            np.testing.assert_array_equal(g.numpy(), a)
    ring = host_copier._rings[((8, 5), torch.float32)]
    assert len(ring) == 5  # four uses a batch, and one spare
    assert sum(s[1].waits for s in ring) > 0


def test_device_prefetch_waits_while_a_capture_holds_the_lock(host_copier):
    """The producer's copy makes no CUDA call while a graph capture holds
    ``CAPTURE_LOCK``: it waits, and counts the wait."""
    from deeplearning4j_tpu_torch.perf.step_graph import CAPTURE_LOCK

    x, y = _arrays()
    done = {}
    with CAPTURE_LOCK:
        t = threading.Thread(
            target=lambda: done.setdefault("ds", host_copier.copy(
                DataSet(x, y)).ds))
        t.start()
        time.sleep(0.1)
        assert t.is_alive() and not done
    t.join(timeout=5)
    assert not t.is_alive() and host_copier.capture_waits == 1
    np.testing.assert_array_equal(done["ds"].features.numpy(), x)
    np.testing.assert_array_equal(done["ds"].labels.numpy(), y)


def test_prefetch_depth_knob(monkeypatch):
    monkeypatch.delenv("DL4J_PREFETCH_DEPTH", raising=False)
    assert ec.prefetch_depth() == 8
    monkeypatch.setenv("DL4J_PREFETCH_DEPTH", "3")
    assert ec.prefetch_depth() == 3
    monkeypatch.setenv("DL4J_PREFETCH_DEPTH", "zero")
    assert ec.prefetch_depth() == 8


def test_streaming_fit_epochs_goes_through_prefetch(monkeypatch):
    """Over the cache budget, ``fit_epochs`` streams through an
    ``AsyncDataSetIterator`` of ``prefetch_depth`` and lands where
    ``fit`` per epoch lands, bitwise."""
    rng = np.random.default_rng(4)
    x = rng.random((96, 784), np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 96)]
    made = []
    real = ec.stream_epochs

    def spy(net, data, n):
        made.append(data)
        return real(net, data, n)

    monkeypatch.setattr("deeplearning4j_tpu_torch.nn.fused.stream_epochs",
                        spy)
    monkeypatch.setenv("DL4J_PREFETCH_DEPTH", "2")
    a = zoo.mnist_mlp(hidden=16, device="cpu").init()
    b = zoo.mnist_mlp(hidden=16, device="cpu").init()
    it = ListDataSetIterator(DataSet(x, y), 32)
    assert a.fit_epochs(it, 3, cache_mb=1e-6) is None
    for _ in range(3):
        b.fit(ListDataSetIterator(DataSet(x, y), 32))
    assert made and a.iteration_count == b.iteration_count == 9
    assert all(torch.equal(p, q) for p, q in
               zip(tree_leaves(a.params), tree_leaves(b.params)))
