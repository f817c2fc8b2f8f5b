"""Port parity for ``earlystopping/`` against ``deeplearning4j_tpu
.earlystopping``: the counterparts of ``tests/test_earlystopping.py``'s
8 tests, each run per batch and with ``fuse_epochs=True``, on networks
whose weights and Adam state are carried from the JAX network
(``load_network_from_jax``). Termination reasons, details, best epochs
and epoch counts are equal; ``score_vs_epoch`` and the best score agree
at float32 rtol 1e-4 / atol 1e-6.

The per-batch loop visits the batches in order on both sides. The fused
path shuffles each epoch's batches (``torch.randperm`` on the port's
generator, ``jax.random`` in the reference), so fused scores are held
against the reference where the epoch is one batch; with several
batches the fused runs are held to the same reasons and counts."""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import earlystopping as jes
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.iterator import \
    ListDataSetIterator as JaxList
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import Updater as JaxUpdater
from deeplearning4j_tpu.nn.conf import layers as jax_L
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.utils import ModelSerializer as JaxSerializer
from deeplearning4j_tpu_torch import earlystopping as es
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.models.convert import load_network_from_jax
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import Updater
from deeplearning4j_tpu_torch.nn.conf import layers as L

RTOL, ATOL = 1e-4, 1e-6


def toy(n=128, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(3, 6)) * 3
    ys = rng.integers(0, 3, n)
    x = (centers[ys] + rng.normal(size=(n, 6))).astype(np.float32)
    return x, np.eye(3)[ys].astype(np.float32)


def _pair(lr=0.05):
    ref = JaxMLN(JaxNNC.Builder().seed(1).learning_rate(lr)
                 .updater(JaxUpdater.ADAM).list()
                 .layer(0, jax_L.DenseLayer(n_in=6, n_out=12,
                                            activation="relu"))
                 .layer(1, jax_L.OutputLayer(n_in=12, n_out=3))
                 .build()).init()
    port = MultiLayerNetwork(
        NeuralNetConfiguration.Builder().seed(1).learning_rate(lr)
        .updater(Updater.ADAM).list()
        .layer(0, L.DenseLayer(n_in=6, n_out=12, activation="relu"))
        .layer(1, L.OutputLayer(n_in=12, n_out=3)).build(), device="cpu")
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    load_network_from_jax(port, np_(ref.params), np_(ref.updater_state),
                          np_(ref.net_state), ref.iteration_count)
    return ref, port


def _run(mod, data_cls, list_cls, net, conds, iter_conds=(), batch=64,
         saver=None, fuse=False, train_seed=0, n=128):
    builder = (mod.EarlyStoppingConfiguration.Builder()
               .epoch_termination_conditions(*conds)
               .score_calculator(mod.DataSetLossCalculator(
                   list_cls(data_cls(*toy(seed=1, n=64)), 64))))
    if iter_conds:
        builder.iteration_termination_conditions(*iter_conds)
    if saver is not None:
        builder.model_saver(saver)
    trainer = mod.EarlyStoppingTrainer(
        builder.build(), net,
        list_cls(data_cls(*toy(seed=train_seed, n=n)), batch),
        fuse_epochs=fuse)
    return trainer, trainer.fit()


def _both(make_conds, make_iter=lambda m: (), lr=0.05, fuse=False,
          batch=64):
    ref, port = _pair(lr)
    _, want = _run(jes, JaxDataSet, JaxList, ref, make_conds(jes),
                   make_iter(jes), batch=batch)
    trainer, got = _run(es, DataSet, ListDataSetIterator, port,
                        make_conds(es), make_iter(es), batch=batch,
                        fuse=fuse)
    return want, got, trainer


def _same_result(want, got, scores=True):
    assert got.termination_reason.value == want.termination_reason.value
    assert got.termination_details == want.termination_details
    assert got.total_epochs == want.total_epochs
    assert got.best_model_epoch == want.best_model_epoch
    if scores:
        assert sorted(got.score_vs_epoch) == sorted(want.score_vs_epoch)
        for e in want.score_vs_epoch:
            np.testing.assert_allclose(got.score_vs_epoch[e],
                                       want.score_vs_epoch[e],
                                       rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got.best_model_score,
                                   want.best_model_score, rtol=RTOL,
                                   atol=ATOL)


# fused runs: one batch an epoch (batch 128) matches the reference's
# per-batch scores; two batches (batch 64) match reasons and counts
MODES = [("per_batch", False, 64, True), ("fused_one_batch", True, 128, True),
         ("fused", True, 64, False)]


@pytest.mark.parametrize("mode,fuse,batch,scores", MODES)
def test_max_epochs_termination(mode, fuse, batch, scores):
    want, got, _ = _both(lambda m: [m.MaxEpochsTerminationCondition(5)],
                         fuse=fuse, batch=batch)
    _same_result(want, got, scores)
    assert got.total_epochs == 5 and got.best_model is not None
    assert np.isfinite(got.best_model_score)


@pytest.mark.parametrize("mode,fuse,batch,scores", MODES)
def test_score_improvement_patience(mode, fuse, batch, scores):
    want, got, _ = _both(lambda m: [
        m.MaxEpochsTerminationCondition(50),
        m.ScoreImprovementEpochTerminationCondition(2)], lr=0.0,
        fuse=fuse, batch=batch)
    _same_result(want, got, scores)
    assert "ScoreImprovement" in got.termination_details
    assert got.total_epochs <= 5


@pytest.mark.parametrize("mode,fuse,batch,scores", MODES)
def test_divergence_guard(mode, fuse, batch, scores):
    want, got, _ = _both(
        lambda m: [m.MaxEpochsTerminationCondition(50)],
        lambda m: [m.MaxScoreIterationTerminationCondition(1e-12)],
        fuse=fuse, batch=batch)
    _same_result(want, got, scores)
    assert got.termination_reason is \
        es.EarlyStoppingResult.TerminationReason.ITERATION_TERMINATION
    assert "MaxScore" in got.termination_details


def test_time_guard_initializes():
    cond = es.MaxTimeIterationTerminationCondition(1e9)
    cond.initialize()
    assert not cond.terminate(1.0)
    assert str(cond) == str(jes.MaxTimeIterationTerminationCondition(1e9))


@pytest.mark.parametrize("cls,arg", [
    ("InvalidScoreIterationTerminationCondition", ()),
    ("MaxScoreIterationTerminationCondition", (2.0,))])
def test_iteration_conditions_match(cls, arg):
    ours, theirs = getattr(es, cls)(*arg), getattr(jes, cls)(*arg)
    for v in (float("nan"), float("inf"), 1.0, 3.0):
        assert ours.terminate(v) == theirs.terminate(v)
    assert str(ours) == str(theirs)


@pytest.mark.parametrize("fuse", [False, True])
def test_local_file_saver_roundtrip(tmp_path, fuse):
    _, port = _pair()
    saver = es.LocalFileModelSaver(str(tmp_path))
    _, result = _run(es, DataSet, ListDataSetIterator, port,
                     [es.MaxEpochsTerminationCondition(3)], saver=saver,
                     fuse=fuse)
    best = result.get_best_model()
    x = toy()[0][:4]
    out = best.output(x)
    assert tuple(out.shape) == (4, 3)
    # the zip both packages read: the JAX package restores the same model
    ref = JaxSerializer.restore(saver.best_path)
    np.testing.assert_allclose(np.asarray(ref.output(x)), out.numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fuse", [False, True])
def test_best_model_is_frozen_copy(fuse):
    _, port = _pair()
    trainer, result = _run(es, DataSet, ListDataSetIterator, port,
                           [es.MaxEpochsTerminationCondition(4)],
                           saver=es.InMemoryModelSaver(), fuse=fuse)
    best = result.best_model.get_flat_params()
    trainer.network.fit(DataSet(*toy()))
    np.testing.assert_array_equal(best, result.best_model.get_flat_params())


def test_fused_iteration_condition_sees_every_batch_and_skips_trips():
    """Fused: the host checks the [1, N] history batch by batch; steps the
    sentinel tripped (skip policy) are dropped before InvalidScore looks,
    so a NaN batch does not end the run, while MaxScore still trips."""
    _, port = _pair()
    x, y = toy()
    x[70] = np.nan  # batch 1 of 2 at batch 64
    cfg = (es.EarlyStoppingConfiguration.Builder()
           .epoch_termination_conditions(es.MaxEpochsTerminationCondition(3))
           .iteration_termination_conditions(
               es.InvalidScoreIterationTerminationCondition())
           .score_calculator(es.DataSetLossCalculator(
               ListDataSetIterator(DataSet(*toy(seed=1, n=64)), 64)))
           .build())
    result = es.EarlyStoppingTrainer(
        cfg, port, ListDataSetIterator(DataSet(x, y), 64),
        fuse_epochs=True).fit()
    assert result.termination_reason is \
        es.EarlyStoppingResult.TerminationReason.EPOCH_TERMINATION
    assert result.total_epochs == 3
    assert port._last_sentinel is not None and port._last_sentinel.any()
    assert port._train_dispatches == 6  # two replayed steps an epoch
    assert es.EarlyStoppingGraphTrainer is es.EarlyStoppingTrainer
    assert torch.isfinite(torch.as_tensor(port.get_flat_params())).all()
