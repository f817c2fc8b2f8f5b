"""Port parity for the epoch pipeline: ``perf/epoch_cache.py``,
``fit_epochs`` and ``build_epoch_cache`` on both network classes, and
``BucketedDataSetIterator``, against ``deeplearning4j_tpu`` on the same
numpy data, with the JAX network's params and updater state carried
over by ``models/convert.load_network_from_jax``.

- The cache: stack shapes, bucket padding, the labels mask (always
  materialised, zero on pad rows) and the ``None`` returns are equal to
  the reference's, array for array.
- ``fit_epochs`` with ``shuffle=False`` and no dropout (the batch order
  and the draws are then the same in both packages): the ``[E, N]`` loss
  history and the params at rtol 1e-4 / atol 1e-6 under float32 and
  2e-2 / 1e-2 under ``bf16`` (the reference's own gates for bf16
  training), for feed-forward, recurrent and graph networks, with and
  without a labels mask; accumulation at 2 and 4 microbatches over a
  padded tail; the telemetry history ``[E, N, 4]`` at strides 1 and 2.
- Inside the port, bit for bit: the fused run against the per-step loop
  on the same generator's orders (shuffled, and with dropout), telemetry
  on against off, explicit chunks against one chunk.
- Fallbacks (TBPTT, the SCORE policy, ``iterations > 1``) equal plain
  ``fit``, and a cache passed to them raises, as in the reference.
"""

import gc
import weakref

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.iterator import (
    BucketedDataSetIterator as JaxBucketed,
)
from deeplearning4j_tpu.datasets.iterator import \
    ListDataSetIterator as JaxListIterator
from deeplearning4j_tpu.nn import conf as jax_conf
from deeplearning4j_tpu.nn.conf import enums as jax_E
from deeplearning4j_tpu.nn.conf import layers as jax_L
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxCG
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.ops.losses import LossFunction as JaxLoss
from deeplearning4j_tpu.perf import epoch_cache as jax_ec
from deeplearning4j_tpu_torch.datasets import (
    BucketedDataSetIterator,
    DataSet,
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.models.convert import load_network_from_jax
from deeplearning4j_tpu_torch.nn import ComputationGraph, MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import conf as port_conf
from deeplearning4j_tpu_torch.nn.conf import enums as E
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.fused import _map
from deeplearning4j_tpu_torch.ops.losses import LossFunction
from deeplearning4j_tpu_torch.perf import epoch_cache as ec

JAX = (jax_conf, jax_L, jax_E, JaxLoss)
PORT = (port_conf, L, E, LossFunction)
TOL = {"float32": dict(rtol=1e-4, atol=1e-6),
       "bf16": dict(rtol=2e-2, atol=1e-2)}


# ---------------------------------------------------------------------------
# networks and data, built by both packages from the same calls
# ---------------------------------------------------------------------------
def _builder(pkg, policy, updater, lr, seed, dropout=None):
    conf = pkg[0]
    b = (conf.NeuralNetConfiguration.Builder().seed(seed).learning_rate(lr)
         .updater(getattr(conf.Updater, updater)).dtype_policy(policy))
    return b if dropout is None else b.drop_out(dropout)


def ff_conf(pkg, policy="float32", updater="ADAM", lr=0.05, seed=0,
            dropout=None, **glob):
    _, Lm, _, _ = pkg
    b = _builder(pkg, policy, updater, lr, seed, dropout)
    for name, value in glob.items():
        b = getattr(b, name)(value)
    return (b.list()
            .layer(0, Lm.DenseLayer(n_in=6, n_out=12, activation="tanh"))
            .layer(1, Lm.OutputLayer(n_in=12, n_out=3)).build())


def rnn_conf(pkg, policy="float32", updater="SGD", lr=0.02, seed=0,
             **kw):
    _, Lm, _, Loss = pkg
    return (_builder(pkg, policy, updater, lr, seed).list()
            .layer(0, Lm.GravesLSTM(n_in=3, n_out=6, activation="tanh"))
            .layer(1, Lm.RnnOutputLayer(n_in=6, n_out=4,
                                        loss_function=Loss.MCXENT))
            .build())


def graph_conf(pkg, policy="float32", updater="ADAM", lr=0.05, seed=0,
               dropout=None):
    _, Lm, _, _ = pkg
    return (_builder(pkg, policy, updater, lr, seed, dropout)
            .graph_builder()
            .add_inputs("in")
            .add_layer("dense", Lm.DenseLayer(n_in=6, n_out=12,
                                              activation="tanh"), "in")
            .add_layer("out", Lm.OutputLayer(n_in=12, n_out=3), "dense")
            .set_outputs("out")
            .build())


KINDS = {"ff": (ff_conf, JaxMLN, MultiLayerNetwork),
         "rnn": (rnn_conf, JaxMLN, MultiLayerNetwork),
         "graph": (graph_conf, JaxCG, ComputationGraph)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_np(tree):
    return jax.tree_util.tree_map(lambda t: t.detach().float().numpy(), tree)


def pair(kind, policy="float32", **kw):
    build, jax_cls, port_cls = KINDS[kind]
    ref = jax_cls(build(JAX, policy, **kw)).init()
    port = load_network_from_jax(
        port_cls(build(PORT, policy, **kw), device="cpu"), _np(ref.params),
        _np(ref.updater_state), _np(ref.net_state), ref.iteration_count)
    return ref, port


def port_net(kind, policy="float32", **kw):
    build, _, port_cls = KINDS[kind]
    return port_cls(build(PORT, policy, **kw), device="cpu").init()


def ff_data(n=100, seed=0, label_mask=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    lm = rng.integers(0, 2, n).astype(np.float32) if label_mask else None
    return x, y, None, lm


def rnn_data(n=15, t=5, seed=0, label_mask=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, t, 3)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (n, t))]
    lm = None
    if label_mask:  # variable-length sequences: the tails masked out
        lm = (np.arange(t)[None, :]
              < rng.integers(3, t + 1, n)[:, None]).astype(np.float32)
    return x, y, None, lm


DATA = {"ff": (ff_data, 32), "rnn": (rnn_data, 6), "graph": (ff_data, 32)}


def iterators(kind, label_mask=False, **kw):
    make, batch = DATA[kind]
    arrays = make(label_mask=label_mask, **kw)
    return (JaxListIterator(JaxDataSet(*arrays), batch),
            ListDataSetIterator(DataSet(*arrays), batch))


def assert_trees_close(port_tree, ref_tree, rtol, atol):
    got = jax.tree_util.tree_leaves(_port_np(port_tree))
    want = jax.tree_util.tree_leaves(_np(ref_tree))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=rtol,
                                   atol=atol)


def assert_nets_equal(a, b):
    for u, v in zip(jax.tree_util.tree_leaves(
                        (a.params, a.updater_state, a.net_state)),
                    jax.tree_util.tree_leaves(
                        (b.params, b.updater_state, b.net_state)),
                    strict=True):
        assert torch.equal(u, v)


# ---------------------------------------------------------------------------
# the cache against the reference's
# ---------------------------------------------------------------------------
CACHE_CASES = {
    # 100 @ 32 -> 32/32/32/4, one bucket of 32
    "stacks_pads_counts": (ff_data, dict(n=100), 32),
    # 70 @ 48 -> 48/22 -> buckets 64/32 -> one stack of 64
    "ragged_max_bucket": (ff_data, dict(n=70), 48),
    "labels_mask": (ff_data, dict(n=50, label_mask=True), 16),
    # 6/6/3 -> bucket 8; [b, t] labels mask
    "rnn_mask": (rnn_data, dict(label_mask=True), 6),
}


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("case", sorted(CACHE_CASES))
def test_cache_matches_reference(case, multi):
    make, kw, batch = CACHE_CASES[case]
    arrays = make(**kw)
    jcls = jax_ec.DeviceMultiDataSetCache if multi else jax_ec.DeviceDataSetCache
    pcls = ec.DeviceMultiDataSetCache if multi else ec.DeviceDataSetCache
    ref = jcls.build(JaxListIterator(JaxDataSet(*arrays), batch))
    got = pcls.build(ListDataSetIterator(DataSet(*arrays), batch),
                     device="cpu")
    assert (got.n_batches, got.batch, got.total_examples) == (
        ref.n_batches, ref.batch, ref.total_examples)
    assert got.nbytes == ref.nbytes
    if multi:
        pairs = [(got.features, ref.features), (got.labels, ref.labels),
                 (got.labels_masks, ref.labels_masks)]
        assert got.features_masks is None and ref.features_masks is None
    else:
        pairs = [(got.features, ref.features), (got.labels, ref.labels),
                 (got.labels_mask, ref.labels_mask)]
        assert got.features_mask is None and ref.features_mask is None
    for a, b in pairs:
        for u, v in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b), strict=True):
            np.testing.assert_array_equal(u.numpy(), np.asarray(v))


def _over_budget(mod):
    it_cls = (ListDataSetIterator if mod is ec else JaxListIterator)
    ds_cls = DataSet if mod is ec else JaxDataSet
    it = it_cls(ds_cls(*ff_data(4096, seed=1)[:2]), 512)
    out = mod.DeviceDataSetCache.build(it, budget_mb=0.01,
                                       **({"device": "cpu"} if mod is ec
                                          else {}))
    return out, len(list(it))  # the iterator is handed back reset


def _unstackable(mod):
    ds_cls = DataSet if mod is ec else JaxDataSet
    rng = np.random.default_rng(0)
    batches = [ds_cls(rng.normal(size=(8, 6)).astype(np.float32),
                      np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]),
               ds_cls(rng.normal(size=(8, 5)).astype(np.float32),
                      np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)])]
    kw = {"device": "cpu"} if mod is ec else {}
    return mod.DeviceDataSetCache.build(batches, **kw), None


def _no_labels(mod):
    ds_cls = DataSet if mod is ec else JaxDataSet
    kw = {"device": "cpu"} if mod is ec else {}
    return mod.DeviceDataSetCache.build(
        [ds_cls(np.zeros((8, 6), np.float32))], **kw), None


def _budget_zero(mod):
    kw = {"device": "cpu"} if mod is ec else {}
    ds_cls = DataSet if mod is ec else JaxDataSet
    return mod.DeviceMultiDataSetCache.build(
        [ds_cls(*ff_data(32)[:2])], budget_mb=0, **kw), None


@pytest.mark.parametrize("case", [_over_budget, _unstackable, _no_labels,
                                  _budget_zero],
                         ids=["over_budget", "unstackable", "no_labels",
                              "budget_zero"])
def test_cache_returns_none_where_the_reference_does(case):
    got, got_left = case(ec)
    ref, ref_left = case(jax_ec)
    assert got is None and ref is None
    assert got_left == ref_left


def test_env_budget_zero_disables(monkeypatch):
    monkeypatch.setenv("DL4J_DEVICE_CACHE_MB", "0")
    assert ec.cache_budget_mb() == jax_ec.cache_budget_mb() == 0
    assert ec.DeviceDataSetCache.build(
        ListDataSetIterator(DataSet(*ff_data()[:2]), 32),
        device="cpu") is None


@pytest.mark.parametrize("requested,batch", [
    (1, 32), (2, 32), (4, 32), (3, 32), (5, 12), (7, 7), (9, 4), (0, 8)])
def test_effective_accum_steps_matches_reference(requested, batch):
    assert ec.effective_accum_steps(requested, batch) == \
        jax_ec.effective_accum_steps(requested, batch)


def test_cache_dtype_bf16_narrows_features_and_labels(monkeypatch):
    monkeypatch.setenv("DL4J_CACHE_DTYPE", "bfloat16")
    arrays = ff_data(50, label_mask=True)
    got = ec.DeviceDataSetCache.build(
        ListDataSetIterator(DataSet(*arrays), 16), device="cpu")
    ref = jax_ec.DeviceDataSetCache.build(
        JaxListIterator(JaxDataSet(*arrays), 16))
    assert got.features.dtype == got.labels.dtype == torch.bfloat16
    assert got.labels_mask.dtype == torch.float32
    assert got.nbytes == ref.nbytes
    np.testing.assert_array_equal(got.features.float().numpy(),
                                  np.asarray(ref.features, np.float32))


def test_bucketed_iterator_matches_reference():
    x, y, _, lm = ff_data(70, label_mask=True)
    got = list(BucketedDataSetIterator(
        ListDataSetIterator(DataSet(x, y, None, lm), 48)))
    ref = list(JaxBucketed(JaxListIterator(JaxDataSet(x, y, None, lm), 48)))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        for name in ("features", "labels", "labels_mask"):
            np.testing.assert_array_equal(np.asarray(getattr(g, name)),
                                          np.asarray(getattr(r, name)))
        assert g.features_mask is None and r.features_mask is None


# ---------------------------------------------------------------------------
# fit_epochs against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,policy,label_mask", [
    ("ff", "float32", False), ("ff", "float32", True),
    ("rnn", "float32", False), ("rnn", "float32", True),
    ("graph", "float32", False), ("graph", "float32", True),
    ("ff", "bf16", False), ("graph", "bf16", True),
])
def test_fit_epochs_matches_jax(kind, policy, label_mask):
    ref, port = pair(kind, policy)
    jit, pit = iterators(kind, label_mask)
    want = np.asarray(ref.fit_epochs(jit, 2, shuffle=False))
    got = port.fit_epochs(pit, 2, shuffle=False)
    assert got.shape == want.shape == (2, 3 if kind == "rnn" else 4)
    np.testing.assert_allclose(got.numpy(), want, **TOL[policy])
    assert_trees_close(port.params, ref.params, **TOL[policy])
    assert port.iteration_count == ref.iteration_count
    assert port._last_sentinel.shape == want.shape
    assert not port._last_sentinel.any()


@pytest.mark.parametrize("kind", ["ff", "graph"])
@pytest.mark.parametrize("accum", [2, 4])
def test_accumulated_fit_epochs_matches_jax(accum, kind):
    # 100 @ 32: the 4-row tail pads to 32, so microbatches are masked
    ref, port = pair(kind)
    jit, pit = iterators(kind, label_mask=True)
    want = np.asarray(ref.fit_epochs(jit, 2, shuffle=False,
                                     accum_steps=accum))
    got = port.fit_epochs(pit, 2, shuffle=False, accum_steps=accum)
    np.testing.assert_allclose(got.numpy(), want, **TOL["float32"])
    assert_trees_close(port.params, ref.params, **TOL["float32"])
    assert_trees_close(port.updater_state, ref.updater_state,
                       **TOL["float32"])


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kind", ["ff", "graph"])
def test_telemetry_history_matches_jax(kind, stride):
    ref, port = pair(kind)
    jit, pit = iterators(kind)
    ref.fit_epochs(jit, 2, shuffle=False, telemetry=stride)
    port.fit_epochs(pit, 2, shuffle=False, telemetry=stride)
    want = np.asarray(ref._last_metrics)
    got = port._last_metrics.numpy()
    assert got.shape == want.shape == (2, 4, 4)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    if stride == 2:
        assert np.isnan(got[:, 1::2]).all() and not np.isnan(got[:, ::2]).any()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# inside the port, bit for bit
# ---------------------------------------------------------------------------
def per_step_epochs(net, cache, epochs, shuffle=True):
    """The per-step loop on the fused path's schedule: each epoch's order
    drawn from the network's generator, then one eager step per batch."""
    stacks = cache.batch_stacks()
    gen = net._rng  # a torch.Generator: every draw advances its state
    history = []
    for _ in range(epochs):
        order = ec.epoch_schedule(gen, cache.n_batches, shuffle)
        row = []
        for j in range(cache.n_batches):
            i = int(order[j])
            net._sgd_step(*_map(lambda a: a[i], stacks))
            net.iteration_count += 1
            row.append(net._score)
        history.append(torch.stack(row))
    return torch.stack(history)


@pytest.mark.parametrize("kind,label_mask,shuffle,dropout", [
    ("ff", False, True, None), ("ff", True, True, None),
    ("ff", False, False, None), ("ff", False, True, 0.5),
    ("rnn", False, True, None), ("rnn", True, True, None),
    ("graph", False, True, None), ("graph", True, True, 0.5),
])
def test_fused_equals_per_step_loop(kind, label_mask, shuffle, dropout):
    kw = {} if dropout is None else {"dropout": dropout}
    fused, ref = port_net(kind, **kw), port_net(kind, **kw)
    _, pit = iterators(kind, label_mask)
    cache = fused.build_epoch_cache(pit)
    hist = fused.fit_epochs(cache, 3, shuffle=shuffle)
    want = per_step_epochs(ref, cache, 3, shuffle)
    assert torch.equal(hist, want)
    assert_nets_equal(fused, ref)
    assert fused.iteration_count == ref.iteration_count == 3 * cache.n_batches
    assert fused._train_dispatches == 3 * cache.n_batches
    assert len(fused._programs) == 1


@pytest.mark.parametrize("kind", ["ff", "graph"])
def test_telemetry_on_equals_off_bitwise(kind):
    on, off = port_net(kind), port_net(kind)
    _, pit = iterators(kind)
    h_on = on.fit_epochs(pit, 2, telemetry=1)
    h_off = off.fit_epochs(pit, 2, telemetry=False)
    assert torch.equal(h_on, h_off)
    assert_nets_equal(on, off)
    assert on._last_metrics.shape == (2, 4, 4) and off._last_metrics is None
    assert torch.isfinite(on._last_metrics).all()


def test_chunks_listeners_and_on_chunk():
    calls, chunks = [], []

    class Legacy:
        def iteration_done(self, net, it):
            calls.append(it)

    class Chunked:
        def chunk_done(self, net, it0, losses, metrics=None):
            chunks.append((it0, tuple(losses.shape)))

    whole, split = port_net("ff"), port_net("ff")
    _, pit = iterators("ff")
    h_whole = whole.fit_epochs(pit, 3)
    split.set_listeners(Legacy(), Chunked())
    h_split = split.fit_epochs(pit, 3)  # listeners: one epoch a chunk
    assert torch.equal(h_whole, h_split)
    assert_nets_equal(whole, split)
    assert calls == [4, 8, 12]
    assert chunks == [(0, (1, 4)), (4, (1, 4)), (8, (1, 4))]
    stopped = port_net("ff")
    hist = stopped.fit_epochs(pit, 5, chunk_epochs=2,
                              on_chunk=lambda done: done >= 2)
    assert hist.shape == (2, 4) and stopped.iteration_count == 8


def test_program_is_kept_per_cache_and_rebuilt_for_a_new_one():
    net = port_net("ff")
    _, pit = iterators("ff")
    cache = net.build_epoch_cache(pit)
    net.fit_epochs(cache, 1)
    prog = next(iter(net._programs.values()))
    net.fit_epochs(cache, 1)
    assert next(iter(net._programs.values())) is prog
    net.fit_epochs(net.build_epoch_cache(pit), 1)  # new stacks, same shapes
    assert len(net._programs) == 1
    assert next(iter(net._programs.values())) is not prog


def _tensors(tree):
    if isinstance(tree, (list, tuple)):
        return [t for part in tree for t in _tensors(part)]
    return [] if tree is None else [tree]


@pytest.mark.parametrize("kind", ["ff", "graph"])
def test_programs_share_one_pool_and_do_not_keep_the_cache(kind):
    """A network's programs (one per key) capture into the network's one
    graph pool, and an epoch program reads its cache only while a
    ``fit_epochs`` call runs: dropping the cache frees its stacks while
    the network keeps its programs."""
    net = port_net(kind)
    _, pit = iterators(kind)
    cache = net.build_epoch_cache(pit)
    net.fit_epochs(cache, 1, guard="skip")
    net.fit_epochs(cache, 1, guard="off")
    x, y, _, _ = ff_data(32)
    net.fit_steps(DataSet(x, y), 2)
    progs = list(net._programs.values())
    assert len(progs) == 3
    assert all(p.graph.pool is net._graph_pool for p in progs)
    stacks = [weakref.ref(t) for t in _tensors(cache.batch_stacks())]
    del cache
    gc.collect()
    assert stacks and all(r() is None for r in stacks)
    assert list(net._programs.values()) == progs


# ---------------------------------------------------------------------------
# fallbacks
# ---------------------------------------------------------------------------
def _tbptt_conf(pkg):
    _, Lm, Em, Loss = pkg
    return (_builder(pkg, "float32", "SGD", 0.02, 0).list()
            .layer(0, Lm.GravesLSTM(n_in=3, n_out=6, activation="tanh"))
            .layer(1, Lm.RnnOutputLayer(n_in=6, n_out=4,
                                        loss_function=Loss.MCXENT))
            .backprop_type(Em.BackpropType.TRUNCATED_BPTT)
            .t_bptt_forward_length(2).t_bptt_backward_length(2).build())


FALLBACKS = {
    "tbptt": (_tbptt_conf, rnn_data),
    "score": (lambda pkg: ff_conf(
        pkg, learning_rate_decay_policy=pkg[2].LearningRatePolicy.SCORE,
        learning_rate_score_based_decay_rate=0.5), ff_data),
    "iterations": (lambda pkg: ff_conf(pkg, iterations=2), ff_data),
}


@pytest.mark.parametrize("case", sorted(FALLBACKS))
def test_fallback_configurations_equal_plain_fit(case):
    build, make = FALLBACKS[case]
    a = MultiLayerNetwork(build(PORT), device="cpu").init()
    b = MultiLayerNetwork(build(PORT), device="cpu").init()
    assert not a.fused_epochs_supported()
    assert not JaxMLN(build(JAX)).fused_epochs_supported()
    it = ListDataSetIterator(DataSet(*make()), 8)
    assert a.fit_epochs(it, 2) is None
    for _ in range(2):
        b.fit(it)
    assert a.iteration_count == b.iteration_count > 0
    assert_nets_equal(a, b)
    cache = ec.DeviceDataSetCache.build(it, device="cpu")
    with pytest.raises(ValueError, match="per-step fit loop"):
        a.fit_epochs(cache, 1)


def test_over_budget_streams_with_plain_fit_results():
    a, b = port_net("ff"), port_net("ff")
    _, pit = iterators("ff")
    assert a.fit_epochs(pit, 2, cache_mb=1e-4) is None
    for _ in range(2):
        b.fit(pit)
    assert a.iteration_count == b.iteration_count == 8
    assert_nets_equal(a, b)
