"""Port parity for the numeric sentinel and the ``DL4J_NAN_GUARD``
policies of ``fit_epochs`` (``resilience/guard.py``, the chunk driver's
enforcement in ``perf/epoch_cache.py``), the metrics pack
(``monitor/pack.py``) and the chunk watchdog and fault site, against
``deeplearning4j_tpu`` on the same weights and data.

One batch of four (rows 16..31 of 64, batch 16) holds a NaN feature:

- ``skip`` keeps that step's params, updater state and net state, and
  the ``[E, N]`` trip history equals the reference's; params stay finite
  and match the reference's run (float32, rtol 1e-4 / atol 1e-6) and,
  bit for bit, a port run that trains every batch but the poisoned one;
- ``halve_lr`` halves the host LR scale once per tripped chunk, and the
  halved scale reaches the step (a graph's too: its step with scale 0.5
  equals, bit for bit, the step at half the learning rate);
- ``raise`` names the same epoch, step and dataset batch as the
  reference; through a shuffle, the batch index is the same and the step
  is that batch's position in the port's own order;
- ``off`` against ``skip`` on clean data: bitwise equal, inside the port.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.iterator import \
    ListDataSetIterator as JaxListIterator
from deeplearning4j_tpu.monitor import pack as jax_pack
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxCG
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.resilience import \
    TrainingDivergedError as JaxDiverged
from deeplearning4j_tpu.resilience import guard as jax_guard
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.models.convert import load_network_from_jax
from deeplearning4j_tpu_torch.monitor import fused_metrics_stride, pack
from deeplearning4j_tpu_torch.nn import ComputationGraph, MultiLayerNetwork
from deeplearning4j_tpu_torch.perf import epoch_cache as ec
from deeplearning4j_tpu_torch.resilience import (
    FaultInjected,
    StepWatchdog,
    TrainingDivergedError,
    fail_nth,
    guard,
    inject,
    nan_guard_policy,
    tree_all_finite,
)

from test_torch_epoch_cache import JAX, PORT, ff_conf, graph_conf

TOL = dict(rtol=1e-4, atol=1e-6)
CLASSES = {"mln": (ff_conf, JaxMLN, MultiLayerNetwork),
           "graph": (graph_conf, JaxCG, ComputationGraph)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def pair(kind, **kw):
    build, jcls, pcls = CLASSES[kind]
    ref = jcls(build(JAX, **kw)).init()
    port = load_network_from_jax(
        pcls(build(PORT, **kw), device="cpu"), _np(ref.params),
        _np(ref.updater_state), _np(ref.net_state), ref.iteration_count)
    return ref, port


def port_net(kind, **kw):
    build, _, pcls = CLASSES[kind]
    return pcls(build(PORT, **kw), device="cpu").init()


def data(n=64, seed=0, poison_row=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    if poison_row is not None:
        x[poison_row] = np.nan
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def its(poison_row=None):
    x, y = data(poison_row=poison_row)
    return (JaxListIterator(JaxDataSet(x, y), 16),
            ListDataSetIterator(DataSet(x, y), 16))


def leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def assert_equal_nets(a, b):
    for u, v in zip(leaves((a.params, a.updater_state, a.net_state)),
                    leaves((b.params, b.updater_state, b.net_state)),
                    strict=True):
        assert torch.equal(u, v)


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_guard_off_equals_skip_bitwise_on_clean_data(kind):
    a, b = port_net(kind), port_net(kind)
    _, it = its()
    ha = a.fit_epochs(it, 3, guard="off")
    hb = b.fit_epochs(it, 3, guard="skip")
    assert torch.equal(ha, hb)
    assert_equal_nets(a, b)
    assert a._last_sentinel is None
    assert b._last_sentinel.shape == (3, 4) and not b._last_sentinel.any()


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_skip_contains_the_poisoned_batch_like_the_reference(kind):
    ref, port = pair(kind, updater="SGD")
    jit, pit = its(poison_row=20)
    want = np.asarray(ref.fit_epochs(jit, 3, shuffle=False, guard="skip"))
    got = port.fit_epochs(pit, 3, shuffle=False, guard="skip").numpy()
    np.testing.assert_array_equal(port._last_sentinel, ref._last_sentinel)
    np.testing.assert_array_equal(np.argwhere(port._last_sentinel),
                                  [[0, 1], [1, 1], [2, 1]])
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], **TOL)
    for u, v in zip(leaves(jax.tree_util.tree_map(
            lambda t: t.numpy(), port.params)), leaves(_np(ref.params))):
        assert np.isfinite(u).all()
        np.testing.assert_allclose(u, v, **TOL)


def test_skip_equals_training_every_batch_but_the_poisoned_one():
    guarded, clean = port_net("mln", updater="SGD"), port_net("mln",
                                                              updater="SGD")
    _, it = its(poison_row=20)
    guarded.fit_epochs(it, 1, shuffle=False, guard="skip")
    assert guarded._last_sentinel.tolist() == [[False, True, False, False]]
    batches = list(ListDataSetIterator(DataSet(*data()), 16))
    for i in (0, 2, 3):
        clean.fit(batches[i])
    for u, v in zip(leaves(guarded.params), leaves(clean.params)):
        assert torch.equal(u, v)


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_halve_lr_halves_once_per_tripped_chunk(kind):
    ref, port = pair(kind)
    jit, pit = its(poison_row=20)
    ref.fit_epochs(jit, 2, shuffle=False, guard="halve_lr", chunk_epochs=1)
    port.fit_epochs(pit, 2, shuffle=False, guard="halve_lr", chunk_epochs=1)
    assert port._lr_scale_host == ref._lr_scale_host == pytest.approx(0.25)
    np.testing.assert_array_equal(port._last_sentinel, ref._last_sentinel)


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_host_lr_scale_reaches_the_guarded_step(kind):
    # SGD: a scale of 0.5 on lr 0.05 is the step at lr 0.025, bit for bit
    halved = port_net(kind, updater="SGD", lr=0.05)
    halved._lr_scale_host = 0.5
    half_lr = port_net(kind, updater="SGD", lr=0.025)
    _, it = its()
    halved.fit_epochs(it, 1, shuffle=False, guard="skip")
    half_lr.fit_epochs(it, 1, shuffle=False, guard="skip")
    for u, v in zip(leaves(halved.params), leaves(half_lr.params)):
        assert torch.equal(u, v)


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_raise_names_the_reference_epoch_step_and_batch(kind):
    ref, port = pair(kind)
    jit, pit = its(poison_row=20)
    with pytest.raises(JaxDiverged) as want:
        ref.fit_epochs(jit, 1, shuffle=False, guard="raise")
    with pytest.raises(TrainingDivergedError) as got:
        port.fit_epochs(pit, 1, shuffle=False, guard="raise")
    w, g = want.value, got.value
    assert (g.epoch, g.step, g.batch_index) == (w.epoch, w.step,
                                                w.batch_index) == (0, 1, 1)
    assert not np.isfinite(g.loss)
    assert "epoch 0, step 1" in str(g)
    assert port._last_sentinel is not None and port._last_sentinel.any()


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_raise_localises_through_a_shuffle(kind):
    ref, port = pair(kind, seed=3)
    jit, pit = its(poison_row=20)
    with pytest.raises(JaxDiverged) as want:
        ref.fit_epochs(jit, 1, shuffle=True, guard="raise")
    gen = ec.clone_generator(port._rng)
    with pytest.raises(TrainingDivergedError) as got:
        port.fit_epochs(pit, 1, shuffle=True, guard="raise")
    order = ec.epoch_schedule(gen, 4, True).tolist()
    assert got.value.batch_index == want.value.batch_index == 1
    assert got.value.step == order.index(1)


def test_env_policy_resolution(monkeypatch):
    for raw, want in (("", "skip"), ("off", "off"), ("HALVE_LR", "halve_lr"),
                      ("raise", "raise"), ("bogus", "skip")):
        monkeypatch.setenv("DL4J_NAN_GUARD", raw)
        assert nan_guard_policy() == jax_guard.nan_guard_policy() == want
    assert guard.NAN_GUARD_POLICIES == jax_guard.NAN_GUARD_POLICIES


@pytest.mark.parametrize("override,env,want", [
    (None, {}, 0), (None, {"DL4J_TELEMETRY": "on"}, 1),
    (None, {"DL4J_TELEMETRY": "on", "DL4J_TELEMETRY_STRIDE": "3"}, 3),
    (False, {"DL4J_TELEMETRY": "on"}, 0), (True, {}, 1), (2, {}, 2)])
def test_fused_metrics_stride_resolution(monkeypatch, override, env, want):
    from deeplearning4j_tpu import monitor as jax_monitor

    for k in ("DL4J_TELEMETRY", "DL4J_TELEMETRY_STRIDE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert fused_metrics_stride(override) == \
        jax_monitor.fused_metrics_stride(override) == want


def test_tree_all_finite_and_step_metrics_match_the_reference():
    rng = np.random.default_rng(0)
    p = {"a": rng.normal(size=(3, 4)).astype(np.float32),
         "b": rng.normal(size=(4,)).astype(np.float32)}
    q = {k: v - 0.1 * np.sign(v) for k, v in p.items()}
    g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p.items()}
    tp, tq, tg = ({k: torch.from_numpy(v) for k, v in t.items()}
                  for t in (p, q, g))
    ints = {"n": torch.arange(3)}
    assert bool(tree_all_finite({**tg, "n": ints["n"]}))
    bad = {**g, "b": np.array([1.0, np.inf, 0, 0], np.float32)}
    assert not bool(tree_all_finite(
        {k: torch.from_numpy(v) for k, v in bad.items()}))
    assert bool(jax_guard.tree_all_finite(g)) and \
        not bool(jax_guard.tree_all_finite(bad))
    for it, stride in ((4, 1), (4, 2), (5, 2)):
        got = pack.step_metrics(tp, tq, tg, torch.tensor(0.5),
                                torch.tensor(it), stride).numpy()
        want = np.asarray(jax_pack.step_metrics(p, q, g, np.float32(0.5),
                                                np.int32(it), stride))
        np.testing.assert_allclose(got, want, rtol=1e-6, equal_nan=True)
    assert pack.METRIC_NAMES == jax_pack.METRIC_NAMES


def test_epoch_chunk_fault_site_and_watchdog_deadline(monkeypatch):
    net = port_net("mln")
    _, it = its()
    with inject("epoch.chunk", fail_nth(1)):
        with pytest.raises(FaultInjected):
            net.fit_epochs(it, 1)
    assert net.iteration_count == 0
    net.fit_epochs(it, 2, chunk_epochs=1)
    assert isinstance(net._chunk_watchdog, StepWatchdog)
    assert net._chunk_watchdog.deadline_s == ec.chunk_deadline_s(4)
    monkeypatch.setenv("DL4J_STEP_DEADLINE_S", "0.5")
    from deeplearning4j_tpu.perf import epoch_cache as jax_ec

    for steps, factor in ((4, 1.0), (10, 2.0), (3, 0.5)):
        assert ec.chunk_deadline_s(steps, factor) == \
            jax_ec.chunk_deadline_s(steps, factor)
