"""Port parity for ``gradientcheck/util.py``: central-difference checks in
float64 pass on every layer family the reference checks
(``tests/test_gradientcheck.py``), probe the same coordinates as the
reference for the same seed (params flattened in ``jax.tree_util``
order, dict keys sorted), whose analytic gradients equal the JAX
network's on the same weights (rtol 1e-10: both in float64, summed in
another order), and fail when the gradient is deliberately wrong."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import dtypes as jax_dtypes
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import layers as jax_L
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.gradientcheck import (
    GradientCheckUtil,
    check_gradients,
)
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.models.convert import load_network_from_jax
from deeplearning4j_tpu_torch.nn import ComputationGraph, MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.graph import MergeVertex


def _net(layers, input_type=None, l1=0.0, l2=0.0, seed=3):
    b = (NeuralNetConfiguration.Builder().seed(seed)
         .dtype_policy("float64").l1(l1).l2(l2).list())
    for i, layer in enumerate(layers):
        b.layer(i, layer)
    if input_type is not None:
        b.set_input_type(input_type)
    return MultiLayerNetwork(b.build(), device="cpu").init()


def _toy(n=8, d=5, c=3, seed=0):
    rng = np.random.default_rng(seed)
    return DataSet(rng.normal(size=(n, d)), np.eye(c)[rng.integers(0, c, n)])


def _seq(seed, b=3, t=4, d=5, mask=None):
    rng = np.random.default_rng(seed)
    return DataSet(rng.normal(size=(b, t, d)),
                   np.eye(2)[rng.integers(0, 2, (b, t))],
                   features_mask=mask, labels_mask=mask)


CASES = {
    "mlp_tanh_mcxent": lambda: (_net([
        L.DenseLayer(n_in=5, n_out=7, activation="tanh"),
        L.OutputLayer(n_in=7, n_out=3)]), _toy()),
    "mlp_l1_l2": lambda: (_net([
        L.DenseLayer(n_in=5, n_out=7, activation="softplus"),
        L.OutputLayer(n_in=7, n_out=3)], l1=0.01, l2=0.02), _toy()),
    "mse_identity": lambda: (_net([
        L.DenseLayer(n_in=4, n_out=6, activation="sigmoid"),
        L.OutputLayer(n_in=6, n_out=2, activation="identity",
                      loss_function="MSE")]),
        DataSet(*(np.random.default_rng(1).normal(size=s)
                  for s in ((6, 4), (6, 2))))),
    "cnn": lambda: (_net([
        L.ConvolutionLayer(n_out=3, kernel_size=(3, 3), activation="tanh"),
        L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)),
        L.OutputLayer(n_out=2)], input_type=InputType.convolutional(6, 6, 1)),
        DataSet(np.random.default_rng(2).normal(size=(4, 6, 6, 1)),
                np.eye(2)[np.random.default_rng(2).integers(0, 2, 4)])),
    "lstm": lambda: (_net([L.GravesLSTM(n_in=5, n_out=6),
                           L.RnnOutputLayer(n_in=6, n_out=2)]), _seq(3)),
    "lstm_mask": lambda: (_net([L.GravesLSTM(n_in=5, n_out=4),
                                L.RnnOutputLayer(n_in=4, n_out=2)]),
                          _seq(4, mask=np.array([[1, 1, 1, 0], [1, 1, 0, 0],
                                                 [1, 1, 1, 1]], np.float64))),
    "gru": lambda: (_net([L.GRU(n_in=5, n_out=6),
                          L.RnnOutputLayer(n_in=6, n_out=2)]), _seq(5)),
    "bidirectional": lambda: (_net([
        L.GravesBidirectionalLSTM(n_in=4, n_out=5),
        L.RnnOutputLayer(n_in=5, n_out=2)]), _seq(6, b=2, t=3, d=4)),
    "batchnorm": lambda: (_net([
        L.DenseLayer(n_in=5, n_out=6, activation="tanh"),
        L.BatchNormalization(), L.OutputLayer(n_out=3)],
        input_type=InputType.feed_forward(5)), _toy()),
    "embedding": lambda: (_net([
        L.EmbeddingLayer(n_in=11, n_out=5, activation="tanh"),
        L.OutputLayer(n_in=5, n_out=3)]),
        DataSet(np.random.default_rng(7).integers(0, 11, (6, 1)).astype(
            np.float64), np.eye(3)[np.random.default_rng(8).integers(0, 3,
                                                                      6)])),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_passes_on_correct_layers(name):
    net, ds = CASES[name]()
    report = {}
    assert check_gradients(net, ds, subset=40, report=report)
    assert report["n_probed"] == min(40, net.num_params())


def test_graph_and_multidataset():
    conf = (NeuralNetConfiguration.Builder().seed(3).dtype_policy("float64")
            .graph_builder().add_inputs("in")
            .add_layer("a", L.DenseLayer(n_in=5, n_out=4, activation="tanh"),
                       "in")
            .add_layer("b", L.DenseLayer(n_in=5, n_out=4,
                                         activation="sigmoid"), "in")
            .add_vertex("m", MergeVertex(), "a", "b")
            .add_layer("out", L.OutputLayer(n_in=8, n_out=3), "m")
            .set_outputs("out").build())
    net = ComputationGraph(conf, device="cpu").init()
    assert check_gradients(net, _toy(), subset=40)
    from deeplearning4j_tpu_torch.datasets import MultiDataSet

    assert GradientCheckUtil.check_gradients(
        net, MultiDataSet.from_dataset(_toy(seed=2)), subset=20)


def test_bf16_network_checks_in_float64():
    """The check swaps the layers to float64 for its duration, as the
    reference's policy scope does, and gives the policy back."""
    net = zoo.mnist_mlp(hidden=8, dtype_policy="bf16", device="cpu").init()
    rng = np.random.default_rng(0)
    ds = DataSet(rng.random((4, 784)), np.eye(10)[rng.integers(0, 10, 4)])
    policy = net.layers[0].policy
    assert check_gradients(net, ds, subset=32)
    assert net.layers[0].policy is policy


def _jax_pair():
    layers = [jax_L.DenseLayer(n_in=5, n_out=7, activation="tanh"),
              jax_L.DenseLayer(n_in=7, n_out=6, activation="sigmoid"),
              jax_L.OutputLayer(n_in=6, n_out=3)]
    b = JaxNNC.Builder().seed(3).dtype_policy("float64").l2(0.01).list()
    for i, lay in enumerate(layers):
        b.layer(i, lay)
    with jax.enable_x64(True):
        ref = JaxMLN(b.build()).init()
    port = _net([L.DenseLayer(n_in=5, n_out=7, activation="tanh"),
                 L.DenseLayer(n_in=7, n_out=6, activation="sigmoid"),
                 L.OutputLayer(n_in=6, n_out=3)], l2=0.01)
    np_tree = jax.tree_util.tree_map(np.asarray, ref.params)
    load_network_from_jax(port, np_tree,
                          jax.tree_util.tree_map(np.asarray,
                                                 ref.updater_state),
                          jax.tree_util.tree_map(np.asarray, ref.net_state),
                          0)
    port.params = jax.tree_util.tree_map(
        lambda t: t.to(torch.float64), port.params)
    return ref, port


@pytest.mark.parametrize("seed,subset", [(0, 40), (5, 17)])
def test_same_coordinates_and_gradients_as_reference(seed, subset):
    ref, port = _jax_pair()
    ds = _toy()
    report = {}
    assert check_gradients(port, ds, subset=subset, seed=seed, report=report)
    # the reference's draw, over jax's flattening of its own params
    leaves = jax.tree_util.tree_leaves(ref.params)
    total = sum(int(p.size) for p in leaves)
    want = sorted(np.random.default_rng(seed).choice(total, size=subset,
                                                     replace=False))
    assert report["coords"] == [int(c) for c in want]
    # the same coordinate names the same parameter: the analytic
    # gradients there agree
    with jax.enable_x64(True), jax_dtypes.policy_scope(jax_dtypes.FLOAT64):
        x = jnp.asarray(ds.features, jnp.float64)
        y = jnp.asarray(ds.labels, jnp.float64)
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     ref.params)
        g = jax.grad(lambda p: ref._loss_and_state(
            p, ref.net_state, x, y, None, None, rng=None, train=False)[0])(
            p64)
    want_g = np.concatenate([np.asarray(a).ravel()
                             for a in jax.tree_util.tree_leaves(g)])[want]
    fwd = jax.tree_util.tree_map(lambda t: t.detach().clone()
                                 .requires_grad_(), port.params)
    loss, _ = port._loss_and_state(
        fwd, port.net_state,
        torch.as_tensor(ds.features), torch.as_tensor(ds.labels),
        None, None, None, False)
    from deeplearning4j_tpu_torch.gradientcheck.util import _leaves

    grads = torch.autograd.grad(loss, _leaves(fwd))
    got_g = torch.cat([t.reshape(-1) for t in grads]).numpy()[want]
    np.testing.assert_allclose(got_g, want_g, rtol=1e-10, atol=1e-14)


def test_fails_on_a_wrong_gradient(monkeypatch):
    """A loss term whose value counts and whose gradient is cut off makes
    the analytic gradient wrong; the check must say so."""
    net, ds = CASES["mlp_tanh_mcxent"]()
    real = net._loss_and_state

    def wrong(params, *a, **k):
        loss, st = real(params, *a, **k)
        w = params["0"]["W"]
        return loss + 0.5 * (w.detach() ** 2).sum(), st

    monkeypatch.setattr(net, "_loss_and_state", wrong)
    report = {}
    assert not check_gradients(net, ds, subset=40, report=report)
    assert report["failures"] and report["max_rel_error"] > 1e-3
