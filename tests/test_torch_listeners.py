"""The port's iteration listeners (``optimize/listeners.py``) against the
JAX package's on the same network weights: what they log, collect and
write, their firing strides on the per-step and the fused paths, and the
profiler window (a ``torch.profiler`` Chrome trace here, an XPlane trace
in the reference).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import layers as jax_L
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.optimize import listeners as jax_listeners
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models.convert import load_network_from_jax
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf.neural_net import MultiLayerConfiguration
from deeplearning4j_tpu_torch.optimize import listeners


def _pair():
    conf = (JaxNNC.Builder().seed(3).learning_rate(0.1).list()
            .layer(0, jax_L.DenseLayer(n_in=5, n_out=4, activation="tanh"))
            .layer(1, jax_L.OutputLayer(n_in=4, n_out=2,
                                        loss_function="MCXENT",
                                        activation="softmax")).build())
    ref = JaxMLN(conf).init()
    port = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu")
    load_network_from_jax(port, jax.tree_util.tree_map(np.asarray,
                                                       ref.params),
                          jax.tree_util.tree_map(np.asarray,
                                                 ref.updater_state))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 5)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)]
    return ref, port, x, y


def _run(ref, port, x, y, ref_listener, listener, steps=4):
    ref.set_listeners(ref_listener)
    port.set_listeners(listener)
    for _ in range(steps):
        ref.fit(JaxDataSet(x, y))
        port.fit(DataSet(x, y))


def test_score_and_collect_listeners_log_the_same_iterations():
    ref, port, x, y = _pair()
    ref_lines, lines = [], []
    ref_collect = jax_listeners.CollectScoresIterationListener(2)
    collect = listeners.CollectScoresIterationListener(2)
    _run(ref, port, x, y, jax_listeners.ComposableIterationListener(
        jax_listeners.ScoreIterationListener(2, ref_lines.append),
        ref_collect), listeners.ComposableIterationListener(
        listeners.ScoreIterationListener(2, lines.append), collect))
    assert [l.split(" is ")[0] for l in lines] == \
        [l.split(" is ")[0] for l in ref_lines] == \
        ["Score at iteration 2", "Score at iteration 4"]
    its, vals = zip(*collect.scores)
    ref_its, ref_vals = zip(*ref_collect.scores)
    assert its == ref_its == (2, 4)
    np.testing.assert_allclose(vals, ref_vals, rtol=1e-5)


def test_chunk_histories_replay_per_step_from_a_tensor():
    """The fused paths hand ``chunk_done`` a device tensor: one read."""
    port = _pair()[1]
    lines, collect = [], listeners.CollectScoresIterationListener(3)
    both = listeners.ComposableIterationListener(
        listeners.ScoreIterationListener(3, lines.append), collect)
    losses = torch.arange(8, dtype=torch.float32).reshape(2, 4)
    both.chunk_done(port, 10, losses)
    assert collect.scores == [(12, 1.0), (15, 4.0), (18, 7.0)]
    assert lines == ["Score at iteration 12 is 1.0",
                     "Score at iteration 15 is 4.0",
                     "Score at iteration 18 is 7.0"]
    timer = listeners.TimeIterationListener(warmup=1)
    timer.chunk_done(port, 0, losses)
    timer.chunk_done(port, 8, losses)
    assert timer.count == 9 and timer.steps_per_second() > 0


def test_param_and_gradient_listener_writes_the_references_table(tmp_path):
    ref, port, x, y = _pair()
    ours, theirs = str(tmp_path / "p.tsv"), str(tmp_path / "j.tsv")
    ref.set_listeners(jax_listeners.ParamAndGradientIterationListener(
        theirs, 2))
    port.set_listeners(listeners.ParamAndGradientIterationListener(ours, 2))
    ref.fit(JaxDataSet(x, y))
    port.fit(DataSet(x, y))
    ref.fit(JaxDataSet(x, y))
    port.fit(DataSet(x, y))
    a, b = (open(p).read().splitlines() for p in (ours, theirs))
    assert a[0] == b[0] == "iteration\tscore\tparam\tmean\tstd\tl2"
    assert len(a) == len(b) == 5  # header and 4 params at iteration 2
    for row_a, row_b in zip(a[1:], b[1:]):
        ra, rb = row_a.split("\t"), row_b.split("\t")
        assert ra[0] == rb[0] == "2" and ra[2] == rb[2]
        np.testing.assert_allclose([float(v) for v in ra[3:] + ra[1:2]],
                                   [float(v) for v in rb[3:] + rb[1:2]],
                                   rtol=1e-4, atol=1e-6)


def test_profiler_listener_writes_a_trace_for_its_window(tmp_path):
    port = _pair()[1]
    x = np.zeros((4, 5), np.float32)
    y = np.eye(2, dtype=np.float32)[[0, 1, 0, 1]]
    prof = listeners.ProfilerIterationListener(str(tmp_path / "tr"), 1, 3)
    port.set_listeners(prof)
    for _ in range(2):
        port.fit(DataSet(x, y))
    assert prof.active  # window (1, 3] still open
    port.fit(DataSet(x, y))
    assert not prof.active and not prof.failed
    with open(tmp_path / "tr" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    with pytest.raises(ValueError, match="must exceed"):
        listeners.ProfilerIterationListener(str(tmp_path), 3, 3)
    early = listeners.ProfilerIterationListener(str(tmp_path / "e"), 0, 9)
    early.iteration_done(port, 1)
    early.close()  # training ended mid-window: the trace is still written
    assert os.path.exists(tmp_path / "e" / "trace.json")
