"""Port parity for ``ComputationGraph``, its configuration and the
normalization layers, against ``deeplearning4j_tpu`` on the same numpy
inputs, with the JAX graph's params, updater state, BatchNorm running
statistics and iteration count carried over by
``models/convert.load_network_from_jax``.

Tolerances:

- configurations are data: ``to_json`` text and ``topological_order``
  are equal;
- vertices: forward values and the loss within 1e-6 relative to each
  array's largest magnitude (the vertex ops are exact; the dense layers
  around them sum a handful of products); gradients within 1e-5, since a
  weight's gradient sums one product per example and those cancel (the
  stacked batch's ``da`` W gradient: 7.5e-8 off on an array whose
  largest element is 0.044);
- BatchNorm and LRN layers, forward, gradient and running statistics:
  float32 1e-5 (a mean and a variance over up to 100 values, summed in
  another order);
- graph inference under float32 1e-5; the full-width ResNet-18 1e-4
  (20 convolutions of up to 4,608 products each, in another order);
- after 3 Adam steps under float32: rtol 1e-4 / atol 1e-6 on losses,
  params, Adam state and running statistics; under ``bf16`` and
  ``mixed_bf16`` 2e-2 / 1e-2, the reference's own gates for bf16
  training (``tests/test_mixed_precision.py``).

The graphs with BatchNorm train Adam with epsilon 1e-3, not the default
1e-6. A bias that feeds a BatchNorm has a gradient of exactly zero in
exact arithmetic (the BatchNorm subtracts it again), so what either
package computes for it is rounding noise of ~1e-8, and Adam moves such
a bias by lr·|g|/(|g| + epsilon) in a direction the noise picks. At
epsilon 1e-6 those biases, and only they, came out up to 1.1e-4 apart
after 3 steps; at 1e-4, 1.5e-6 past the gate after 7. The loss does not
depend on those biases.

Port-internal equalities (``fit_steps`` against ``fit`` calls, device
against host ``evaluate``, the per-layer against the grouped updater
apply) are held bit for bit."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import dtypes as jax_dtypes
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn import conf as jax_conf
from deeplearning4j_tpu.nn.conf import enums as jax_E
from deeplearning4j_tpu.nn.conf import graph as jax_G
from deeplearning4j_tpu.nn.conf import layers as jax_L
from deeplearning4j_tpu.nn.conf import preprocessors as jax_pre
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxCG
from deeplearning4j_tpu.nn.layers import get_layer_impl as jax_layer_impl
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch.datasets import (
    DataSet,
    ListDataSetIterator,
    MultiDataSet,
)
from deeplearning4j_tpu_torch.dtypes import tree_leaves, tree_map
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.models.convert import load_network_from_jax
from deeplearning4j_tpu_torch.nn import ComputationGraph, MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import conf as port_conf
from deeplearning4j_tpu_torch.nn import updater as upd
from deeplearning4j_tpu_torch.nn.conf import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf import enums as E
from deeplearning4j_tpu_torch.nn.conf import graph as G
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf import preprocessors as pre
from deeplearning4j_tpu_torch.nn.layers import get_layer_impl

JAX = (jax_conf, jax_L, jax_E, jax_G, jax_pre)
PORT = (port_conf, L, E, G, pre)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_np(tree):
    return jax.tree_util.tree_map(lambda t: t.detach().numpy(), tree)


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= tol * scale


def _carry(ref, port):
    return load_network_from_jax(port, _np(ref.params),
                                 _np(ref.updater_state), _np(ref.net_state),
                                 ref.iteration_count)


def _pair(build, policy="float32"):
    """The JAX graph (initialised) and the port graph on its weights."""
    ref = JaxCG(build(JAX, policy)).init()
    return ref, _carry(ref, ComputationGraph(build(PORT, policy),
                                             device="cpu"))


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _onehot(n, classes, seed=1):
    rng = np.random.default_rng(seed)
    return np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]


# ---------------------------------------------------------------------------
# graphs, built by both packages from the same calls
# ---------------------------------------------------------------------------


def _builder(pkg, policy, seed=7, lr=1e-3, epsilon=1e-6):
    conf, _, Em, _, _ = pkg
    return (conf.NeuralNetConfiguration.Builder().seed(seed)
            .learning_rate(lr).updater(Em.Updater.ADAM).epsilon(epsilon)
            .weight_init(Em.WeightInit.XAVIER).dtype_policy(policy)
            .graph_builder())


def _narrow_resnet(pkg, policy):
    """Stem of 8 channels, one identity block and one stride-2 block
    projected to 16 channels (3x3 SAME at stride 2 on 8x8 pads (0, 1)),
    BatchNorm, global average pooling and a softmax head; both zoos'
    own ``_res_block``."""
    _, Lm, Em, _, _ = pkg
    res_block = (jax_zoo if pkg is JAX else zoo)._res_block
    g = _builder(pkg, policy, epsilon=1e-3).add_inputs("in")
    g.add_layer("stem", Lm.ConvolutionLayer(
        n_in=3, n_out=8, kernel_size=(3, 3), convolution_mode="same"), "in")
    g.add_layer("stem_bn", Lm.BatchNormalization(
        n_in=8, n_out=8, activation="relu"), "stem")
    prev = res_block(g, "s0b0", "stem_bn", 8, 1, 8)
    prev = res_block(g, "s1b0", prev, 16, 2, 8)
    g.add_layer("gap", Lm.GlobalPoolingLayer(
        pooling_type=Em.PoolingType.AVG), prev)
    g.add_layer("out", Lm.OutputLayer(n_in=16, n_out=10,
                                      loss_function="MCXENT"), "gap")
    return g.set_outputs("out").build()


def _two_io(pkg, policy):
    """Two inputs merged, two loss heads (softmax MCXENT and MSE)."""
    _, Lm, _, Gm, _ = pkg
    g = _builder(pkg, policy).add_inputs("a", "b")
    g.add_layer("da", Lm.DenseLayer(n_in=6, n_out=8, activation="tanh"), "a")
    g.add_layer("db", Lm.DenseLayer(n_in=5, n_out=8, activation="tanh"), "b")
    g.add_vertex("merge", Gm.MergeVertex(), "da", "db")
    g.add_layer("h", Lm.DenseLayer(n_in=16, n_out=12, activation="relu"),
                "merge")
    g.add_layer("out1", Lm.OutputLayer(n_in=12, n_out=4,
                                       loss_function="MCXENT"), "h")
    g.add_layer("out2", Lm.OutputLayer(n_in=8, n_out=3, activation="identity",
                                       loss_function="MSE"), "db")
    return g.set_outputs("out1", "out2").build()


def _two_io_data(batch=8):
    return ([_rand(batch, 6, seed=2), _rand(batch, 5, seed=3)],
            [_onehot(batch, 4), _rand(batch, 3, seed=4)])


def _resnet18(pkg, policy):
    kw = {} if pkg is JAX else {"device": "cpu"}
    return (jax_zoo if pkg is JAX else zoo).resnet18(
        dtype_policy=policy, **kw).conf


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("build", [_resnet18, _two_io],
                         ids=["resnet18", "two_io"])
def test_graph_conf_json_equals_jax(build):
    ref, port = build(JAX, "bf16"), build(PORT, "bf16")
    assert port.to_json() == ref.to_json()
    assert port.topological_order == ref.topological_order
    assert ComputationGraphConfiguration.from_json(ref.to_json()) == port
    assert jax_G.ComputationGraphConfiguration.from_json(
        port.to_json()) == ref
    assert port.clone() == port
    assert ComputationGraphConfiguration.from_yaml(port.to_json()) == port


def test_graph_builder_infers_shapes_as_jax():
    def build(pkg):
        conf, Lm, _, Gm, Pm = pkg
        g = (conf.NeuralNetConfiguration.Builder().graph_builder()
             .add_inputs("img", "vec"))
        g.add_layer("c", Lm.ConvolutionLayer(n_out=4, kernel_size=(3, 3)),
                    "img")
        g.add_layer("d", Lm.DenseLayer(n_out=5), "c",
                    preprocessor=Pm.CnnToFeedForwardPreProcessor(4, 4, 4))
        g.add_vertex("m", Gm.MergeVertex(), "d", "vec")
        g.add_vertex("s", Gm.SubsetVertex(from_index=2, to_index=6), "m")
        g.add_layer("o", Lm.OutputLayer(n_out=2), "s")
        g.set_input_types(img=conf.InputType.convolutional(6, 6, 1),
                          vec=conf.InputType.feed_forward(3))
        return g.set_outputs("o").build()

    ref, port = build(JAX), build(PORT)
    assert port.to_dict() == ref.to_dict()
    assert port.layers["d"].n_in == 64 and port.layers["o"].n_in == 5


def test_graph_conf_rejects_what_jax_rejects():
    for pkg in (JAX, PORT):
        _, Lm, _, Gm, _ = pkg
        g = _builder(pkg, "float32").add_inputs("in")
        g.add_layer("a", Lm.DenseLayer(n_in=2, n_out=2), "b")
        g.add_layer("b", Lm.DenseLayer(n_in=2, n_out=2), "a")
        with pytest.raises(ValueError, match="cycle"):
            g.set_outputs("b").build()
        g = _builder(pkg, "float32").add_inputs("in")
        g.add_layer("a", Lm.DenseLayer(n_in=2, n_out=2), "nowhere")
        with pytest.raises(ValueError, match="unknown input"):
            g.set_outputs("a").build()


# ---------------------------------------------------------------------------
# vertices: forward and gradient in small graphs
# ---------------------------------------------------------------------------

B, T = 4, 5


def _vertex_graph(kind):
    """``(build, inputs, labels, feature_masks)`` for a graph around one
    vertex of ``kind``."""
    def build(pkg, policy):
        _, Lm, _, Gm, Pm = pkg
        g = _builder(pkg, policy).add_inputs("a", "b")
        dense = lambda n_in, n_out: Lm.DenseLayer(  # noqa: E731
            n_in=n_in, n_out=n_out, activation="tanh")
        out = lambda n_in: Lm.OutputLayer(  # noqa: E731
            n_in=n_in, n_out=3, loss_function="MCXENT")
        if kind != "Preprocessor":  # there "a" is a 4-D image
            g.add_layer("da", dense(4, 5), "a")
        g.add_layer("db", dense(3, 5), "b")
        if kind == "Merge":
            g.add_vertex("v", Gm.MergeVertex(), "da", "db")
            g.add_layer("out", out(10), "v")
        elif kind.startswith("ElementWise"):
            op = kind.split("-")[1]
            g.add_vertex("v", Gm.ElementWiseVertex(op=op), "da", "db")
            g.add_layer("out", out(5), "v")
        elif kind == "Subset":
            g.add_vertex("v", Gm.SubsetVertex(from_index=1, to_index=3), "da")
            g.add_layer("out", out(3), "v")
        elif kind == "LastTimeStep":  # "a" is [b, t, 4] with a mask
            g.add_vertex("v", Gm.LastTimeStepVertex(mask_input="a"), "da")
            g.add_layer("out", out(5), "v")
        elif kind == "DuplicateToTimeSeries":  # "a" is [b, t, 4]
            g.add_vertex("v", Gm.DuplicateToTimeSeriesVertex(input_name="a"),
                         "db")
            g.add_vertex("w", Gm.ElementWiseVertex(op="Product"), "v", "da")
            g.add_layer("out", Lm.RnnOutputLayer(n_in=5, n_out=3,
                                                 loss_function="MCXENT"), "w")
        elif kind == "Scale":
            g.add_vertex("v", Gm.ScaleVertex(scale=0.375), "da")
            g.add_layer("out", out(5), "v")
        elif kind == "Stack":
            g.add_vertex("v", Gm.StackVertex(), "da", "db")
            g.add_layer("out", out(5), "v")
        elif kind == "Unstack":
            g.add_vertex("v", Gm.UnstackVertex(from_index=1, stack_size=2),
                         "da")
            g.add_vertex("w", Gm.ScaleVertex(scale=2.0), "db")
            g.add_vertex("u", Gm.UnstackVertex(from_index=0, stack_size=2),
                         "w")
            g.add_vertex("x", Gm.ElementWiseVertex(op="Add"), "v", "u")
            g.add_layer("out", out(5), "x")
        elif kind == "Preprocessor":  # "a" is [b, 2, 2, 1] NHWC
            g.add_vertex("v", Gm.PreprocessorVertex(
                preprocessor=Pm.CnnToFeedForwardPreProcessor(
                    2, 2, 1).to_dict()), "a")
            g.add_layer("dv", dense(4, 5), "v")
            g.add_vertex("x", Gm.ElementWiseVertex(op="Add"), "dv", "db")
            g.add_layer("out", out(5), "x")
        return g.set_outputs("out").build()

    a_shape = {"LastTimeStep": (B, T, 4), "DuplicateToTimeSeries": (B, T, 4),
               "Preprocessor": (B, 2, 2, 1)}.get(kind, (B, 4))
    inputs = [_rand(*a_shape, seed=5), _rand(B, 3, seed=6)]
    rows = {"Stack": 2 * B, "Unstack": B // 2}.get(kind, B)
    labels = [_onehot(rows, 3)]
    if kind == "DuplicateToTimeSeries":
        labels = [_onehot(B * T, 3).reshape(B, T, 3)]
    masks = None
    if kind == "LastTimeStep":
        masks = [np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1],
                           [1, 0, 0, 0, 0], [0, 0, 0, 0, 0]], np.float32),
                 None]
    return build, inputs, labels, masks


VERTICES = ["Merge", "ElementWise-Add", "ElementWise-Subtract",
            "ElementWise-Product", "ElementWise-Average", "ElementWise-Max",
            "Subset", "LastTimeStep", "DuplicateToTimeSeries", "Scale",
            "Stack", "Unstack", "Preprocessor"]


@pytest.mark.parametrize("kind", VERTICES)
def test_vertex_forward_and_gradient(kind):
    build, inputs, labels, masks = _vertex_graph(kind)
    ref, port = _pair(build)
    jm = None if masks is None else tuple(
        None if m is None else jnp.asarray(m) for m in masks)
    tm = None if masks is None else [
        None if m is None else torch.from_numpy(m) for m in masks]
    want = ref._forward(ref.params, ref.net_state,
                        tuple(jnp.asarray(x) for x in inputs), train=False,
                        rng=None, feature_masks=jm, collect=True)[0]
    with torch.no_grad():
        got = port._forward(port.params, port.net_state,
                            [torch.from_numpy(x) for x in inputs],
                            train=False, rng=None, feature_masks=tm,
                            collect=True)[0]
    assert set(got) == set(want)
    for name in want:
        _close(got[name].detach(), want[name], 1e-6)
    (want_loss, _), want_g = ref._loss_grads(
        ref.params, ref.net_state, tuple(jnp.asarray(x) for x in inputs),
        tuple(jnp.asarray(y) for y in labels), jm, None, None)
    loss, _, grads = port._loss_grads(
        port.params, port.net_state, [torch.from_numpy(x) for x in inputs],
        [torch.from_numpy(y) for y in labels], tm, None, None)
    _close(loss, want_loss, 1e-6)
    for a, b in zip(tree_leaves(grads), jax.tree_util.tree_leaves(want_g),
                    strict=True):
        _close(a.numpy(), b, 1e-5)


# ---------------------------------------------------------------------------
# normalization layers
# ---------------------------------------------------------------------------


def _g(shape, seed=9):
    return _rand(*shape, seed=seed)


@pytest.mark.parametrize("locked", [False, True], ids=["gamma_beta", "locked"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "inference"])
@pytest.mark.parametrize("shape", [(10, 6), (3, 4, 5, 6)], ids=["2d", "4d"])
def test_batch_norm_matches_jax(shape, train, locked):
    kw = dict(n_in=6, n_out=6, decay=0.8, eps=1e-3, gamma=1.5, beta=-0.25,
              lock_gamma_beta=locked, activation="tanh")
    jimpl, impl = jax_layer_impl(jax_L.BatchNormalization(**kw)), \
        get_layer_impl(L.BatchNormalization(**kw))
    x = (_rand(*shape, seed=4) * 2.0 + 0.5).astype(np.float32)
    params = {} if locked else {"gamma": _rand(6, seed=5),
                                "beta": _rand(6, seed=6)}
    state = {"mean": _rand(6, seed=7), "var": np.exp(_rand(6, seed=8))}
    g = _g(shape)

    def f(p, v):
        return jimpl.forward(p, v, {k: jnp.asarray(s) for k, s in
                                    state.items()}, train=train)

    out, vjp = jax.vjp(lambda p, v: f(p, v)[0],
                       {k: jnp.asarray(v) for k, v in params.items()},
                       jnp.asarray(x))
    want_gp, want_gx = vjp(jnp.asarray(g))
    want_state = f({k: jnp.asarray(v) for k, v in params.items()},
                   jnp.asarray(x))[1]
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    xt = torch.tensor(x, requires_grad=True)
    got, got_state = impl.forward(
        tp, xt, {k: torch.from_numpy(s) for k, s in state.items()},
        train=train)
    (got * torch.from_numpy(g)).sum().backward()
    _close(got.detach(), out)
    _close(xt.grad, want_gx)
    for k in params:
        _close(tp[k].grad, want_gp[k])
    for k in ("mean", "var"):
        assert not got_state[k].requires_grad
        assert got_state[k].dtype == torch.float32
        _close(got_state[k], want_state[k])
    assert impl.num_params() == (0 if locked else 12)
    assert {k: tuple(v.shape) for k, v in impl.init_params(None).items()} \
        == {k: v.shape for k, v in jimpl.init_params(None).items()}


@pytest.mark.parametrize("n", [5, 4, 1], ids=["n5", "n4", "n1"])
def test_lrn_matches_jax(n):
    kw = dict(n=n, k=1.5, alpha=0.3, beta=0.6)
    jimpl = jax_layer_impl(jax_L.LocalResponseNormalization(**kw))
    impl = get_layer_impl(L.LocalResponseNormalization(**kw))
    x = _rand(2, 3, 4, 7, seed=3)
    g = _g(x.shape)
    out, vjp = jax.vjp(lambda v: jimpl.forward({}, v, {})[0], jnp.asarray(x))
    (want_gx,) = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    got, _ = impl.forward({}, xt, {})
    (got * torch.from_numpy(g)).sum().backward()
    _close(got.detach(), out)
    _close(xt.grad, want_gx)


# ---------------------------------------------------------------------------
# training: the narrow residual graph, the two-input graph, BN in an MLN
# ---------------------------------------------------------------------------


def _resnet_data(batch=8):
    return _rand(batch, 8, 8, 3, seed=11), _onehot(batch, 10)


def _compare_states(ref, port, rtol, atol):
    pairs = [(port.params, ref.params),
             (port.updater_state, ref.updater_state),
             (port.net_state, ref.net_state)]
    for got, want in pairs:
        got_l = jax.tree_util.tree_leaves(_port_np(got))
        want_l = jax.tree_util.tree_leaves(_np(want))
        assert len(got_l) == len(want_l)
        for a, b in zip(got_l, want_l):
            assert a.dtype == np.float32
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def test_narrow_resnet_inference_matches_jax():
    ref, port = _pair(_narrow_resnet)
    x, y = _resnet_data()
    _close(port.output(x)[0].numpy(), ref.output(x)[0])
    got, want = port.feed_forward(x), ref.feed_forward(x)
    for name in want:
        _close(got[name].numpy(), want[name])
    _close(port.score(DataSet(x, y)), ref.score(JaxDataSet(x, y)))


@pytest.mark.parametrize("policy,rtol,atol", [
    ("float32", 1e-4, 1e-6), ("bf16", 2e-2, 1e-2),
    ("mixed_bf16", 2e-2, 1e-2)], ids=["f32", "bf16", "mixed_bf16"])
def test_narrow_resnet_three_steps_match(policy, rtol, atol):
    ref, port = _pair(_narrow_resnet, policy)
    x, y = _resnet_data()
    la, lb = [], []
    for _ in range(3):
        ref.fit(JaxDataSet(x, y))
        la.append(ref.score_value)
        port.fit(DataSet(x, y))
        lb.append(port.score_value)
    np.testing.assert_allclose(lb, la, rtol=rtol, atol=atol)
    assert la[-1] < la[0] and lb[-1] < lb[0]
    assert port.iteration_count == ref.iteration_count == 3
    _compare_states(ref, port, rtol, atol)


def test_two_input_two_output_graph_three_steps_match():
    ref, port = _pair(_two_io)
    xs, ys = _two_io_data()
    for _ in range(3):
        ref.fit(JaxMDS(xs, ys))
        port.fit(MultiDataSet(xs, ys))
        np.testing.assert_allclose(port.score_value, ref.score_value,
                                   rtol=1e-4, atol=1e-6)
    _compare_states(ref, port, 1e-4, 1e-6)
    for got, want in zip(port.output(*xs), ref.output(*xs), strict=True):
        _close(got.numpy(), want)
    _close(port.score(MultiDataSet(xs, ys)), ref.score(JaxMDS(xs, ys)))


def _bn_mlp(pkg, policy):
    conf, Lm, Em, _, _ = pkg
    return (conf.NeuralNetConfiguration.Builder().seed(3).learning_rate(1e-3)
            .updater(Em.Updater.ADAM).epsilon(1e-3).dtype_policy(policy)
            .list()
            .layer(0, Lm.DenseLayer(n_in=12, n_out=16, activation="identity"))
            .layer(1, Lm.BatchNormalization(n_in=16, n_out=16,
                                            activation="relu"))
            .layer(2, Lm.OutputLayer(n_in=16, n_out=10)).build())


def test_batch_norm_in_a_multilayer_network_matches_jax():
    ref = JaxMLN(_bn_mlp(JAX, "float32")).init()
    port = _carry(ref, MultiLayerNetwork(_bn_mlp(PORT, "float32"),
                                         device="cpu"))
    x, y = _rand(16, 12, seed=12), _onehot(16, 10)
    for _ in range(3):
        ref.fit(JaxDataSet(x, y))
        port.fit(DataSet(x, y))
        np.testing.assert_allclose(port.score_value, ref.score_value,
                                   rtol=1e-4, atol=1e-6)
    _compare_states(ref, port, 1e-4, 1e-6)
    # inference reads the running statistics the steps left
    _close(port.output(x).numpy(), ref.output(x))


# ---------------------------------------------------------------------------
# full-width ResNet-18
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def resnet18_pair():
    ref = jax_zoo.resnet18().init()
    return ref, _carry(ref, zoo.resnet18(device="cpu"))


def test_resnet18_counts_and_names_match_jax(resnet18_pair):
    ref, port = resnet18_pair
    assert zoo.resnet18(device="cpu").num_params() == 11_176_970
    assert port.num_params() == ref.num_params() == 11_176_970
    assert sorted(port.conf.layers) == sorted(ref.conf.layers)
    assert len(port.conf.layers) == 47
    assert sum(isinstance(v, G.ElementWiseVertex)
               for v in port.conf.vertices.values()) == 8
    fresh = zoo.resnet18(device="cpu").init()
    assert sorted(fresh.get_param_table()) == sorted(ref.get_param_table())
    for name, arr in fresh.get_param_table().items():
        assert arr.shape == ref.get_param_table()[name].shape
    assert {n: sorted(s) for n, s in fresh.net_state.items()} == \
        {n: sorted(s) for n, s in ref.net_state.items()}


def test_resnet18_output_matches_jax(resnet18_pair):
    ref, port = resnet18_pair
    x = np.random.default_rng(0).random((2, 32, 32, 3), np.float32)
    _close(port.output(x)[0].numpy(), ref.output(x)[0], 1e-4)


# ---------------------------------------------------------------------------
# step behaviour, evaluation, what raises
# ---------------------------------------------------------------------------


def test_fit_steps_equals_fit_calls():
    ref, a = _pair(_narrow_resnet)
    b = _carry(ref, ComputationGraph(_narrow_resnet(PORT, "float32"),
                                     device="cpu"))
    x, y = _resnet_data()
    ds = DataSet(torch.from_numpy(x), torch.from_numpy(y))
    a.fit_steps(ds, 3)
    for _ in range(3):
        b.fit(ds)
    assert a.iteration_count == b.iteration_count == 3
    assert a.score_value == b.score_value
    for u, v in zip(tree_leaves((a.params, a.updater_state, a.net_state)),
                    tree_leaves((b.params, b.updater_state, b.net_state)),
                    strict=True):
        assert torch.equal(u, v)


def test_fit_forms_and_iterator_match_jax():
    ref, port = _pair(_narrow_resnet)
    x, y = _resnet_data(batch=12)
    from deeplearning4j_tpu.datasets.iterator import \
        ListDataSetIterator as JaxListIterator

    ref.fit(JaxListIterator(JaxDataSet(x, y), 5), num_epochs=2)
    port.fit(ListDataSetIterator(DataSet(x, y), 5), num_epochs=2)
    ref.fit(x, y)
    port.fit(x, y)
    assert port.iteration_count == ref.iteration_count == 7
    np.testing.assert_allclose(port.score_value, ref.score_value,
                               rtol=1e-4, atol=1e-6)
    _compare_states(ref, port, 1e-4, 1e-6)


@pytest.mark.parametrize("device_accumulation", [True, False],
                         ids=["device", "host"])
def test_evaluate_matches_jax(device_accumulation):
    ref, port = _pair(_narrow_resnet)
    x, y = _resnet_data(batch=13)
    mask = np.ones(13, np.float32)
    mask[[2, 7]] = 0.0
    from deeplearning4j_tpu.datasets.iterator import \
        ListDataSetIterator as JaxListIterator

    want = ref.evaluate(JaxListIterator(JaxDataSet(x, y, labels_mask=mask),
                                        batch_size=5),
                        device_accumulation=device_accumulation)
    before = port._eval_readbacks
    got = port.evaluate(ListDataSetIterator(DataSet(x, y, labels_mask=mask),
                                            batch_size=5),
                        device_accumulation=device_accumulation)
    assert port._eval_readbacks - before == int(device_accumulation)
    np.testing.assert_array_equal(got.confusion.to_array(),
                                  want.confusion.to_array())
    assert got.confusion.to_array().sum() == 11
    other = port.evaluate(DataSet(x, y, labels_mask=mask),
                          device_accumulation=not device_accumulation)
    np.testing.assert_array_equal(other.confusion.to_array(),
                                  got.confusion.to_array())


def test_evaluate_picks_the_output_head():
    ref, port = _pair(_two_io)
    xs, ys = _two_io_data(batch=10)
    want = ref.evaluate(JaxMDS(xs, ys), output_index=0)
    got = port.evaluate(MultiDataSet(xs, ys), output_index=0)
    np.testing.assert_array_equal(got.confusion.to_array(),
                                  want.confusion.to_array())


def test_clone_and_param_table():
    ref, port = _pair(_narrow_resnet)
    table = port.get_param_table()
    for name, arr in ref.get_param_table().items():
        np.testing.assert_array_equal(table[name], arr)
    clone = port.clone()
    assert clone.device == port.device and clone.conf == port.conf
    for u, v in zip(tree_leaves((clone.params, clone.net_state)),
                    tree_leaves((port.params, port.net_state)), strict=True):
        assert torch.equal(u, v)
    calls = []

    class Listener:
        def iteration_done(self, net, it):
            calls.append(it)

    port.set_listeners(Listener())
    x, y = _resnet_data()
    port.fit(DataSet(x, y))
    port.fit_steps(DataSet(x, y), 2)
    assert calls == [1, 3]


@pytest.mark.parametrize("call,item", [
    (lambda n, ds: n.fit_epochs(ds, 1, mesh=_MeshOfOne()), "A14.3"),
    (lambda n, ds: n.build_epoch_cache(ds, mesh=_MeshOfOne()), "A14.3"),
    (lambda n, ds: n.request_reshard(None), "A14.3"),
], ids=["fit_epochs", "build_epoch_cache", "request_reshard"])
def test_features_outside_the_slice_raise(call, item):
    """The mesh items (A14.3) are ported: over a mesh of one device the
    fused epoch and its cache are the meshless ones, and a reshard
    request is latched for the next chunk boundary."""
    net = ComputationGraph(_narrow_resnet(PORT, "float32"), device="cpu")
    x, y = _resnet_data()
    out = call(net, DataSet(x, y))
    if out is None:
        assert net._pending_mesh == (None,)
    else:
        assert getattr(out, "n_shard", 1) == 1
    assert net.fused_epochs_supported()


class _MeshOfOne:
    mesh_dim_names, shape = ("data",), (1,)


def _outcome(fn):
    """What ``fn()`` gives: its text (a configuration as its JSON), or the
    type and message of what it raised."""
    try:
        out = fn()
    except Exception as e:  # the reference's errors are part of the API
        return type(e).__name__, str(e)
    return out if isinstance(out, str) else out.to_json()


@pytest.mark.parametrize("call", [
    lambda C, c: c.to_yaml(),
    lambda C, c: c.to_reference_json(),
    lambda C, c: c.to_reference_yaml(),
    lambda C, c: C.from_reference_json("{}"),
    lambda C, c: C.from_reference_yaml("a: 1"),
    lambda C, c: C.from_yaml("inputs:\n  - a\n"),
    lambda C, c: C.from_yaml(c.to_yaml()),
    lambda C, c: C.from_reference_json(c.to_reference_json()),
], ids=["to_yaml", "to_reference_json", "to_reference_yaml",
        "from_reference_json", "from_reference_yaml", "from_yaml_block",
        "from_yaml_round_trip", "reference_json_round_trip"])
def test_graph_compat_formats_raise_with_their_item(call):
    """The graph's YAML and reference-format methods (ROADMAP A10.6,
    ported): each gives the JAX package's text, or raises what it raises."""
    ours = _outcome(lambda: call(ComputationGraphConfiguration,
                                 _two_io(PORT, "float32")))
    theirs = _outcome(lambda: call(type(_two_io(JAX, "float32")),
                                   _two_io(JAX, "float32")))
    assert ours == theirs


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zoo.resnet18()
    assert zoo.resnet18(device="cpu").device == torch.device("cpu")


# ---------------------------------------------------------------------------
# updaters, datasets, dtypes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", [u.value for u in E.Updater
                                  if u.value != "CUSTOM"])
def test_per_layer_apply_is_bitwise_the_grouped_apply(kind):
    spec = upd.UpdaterSpec(kind=E.Updater(kind), learning_rate=0.05,
                           bias_learning_rate=0.01, momentum=0.9,
                           gradient_normalization=E.GradientNormalization(
                               "ClipL2PerLayer"),
                           gradient_normalization_threshold=0.5)
    plain = upd.UpdaterSpec(kind=E.Updater(kind), learning_rate=0.05)
    items = [("a", spec), ("b", plain), ("pool", plain), ("c", spec)]
    gen = torch.Generator().manual_seed(0)
    shapes = {"a": {"W": (5, 4), "b": (4,)}, "b": {"gamma": (4,),
                                                   "beta": (4,)},
              "pool": {}, "c": {"W": (3, 3, 4, 2), "b": (2,)}}
    params = {k: {n: torch.randn(s, generator=gen) for n, s in sh.items()}
              for k, sh in shapes.items()}
    state = {k: upd.init_updater_state(s, params[k]) for k, s in items}
    grouped = per_layer = (params, state)
    for i in range(3):
        grads = tree_map(lambda p: torch.randn(p.shape, generator=gen),
                         params)
        it = torch.tensor(i, dtype=torch.int32)
        scale = torch.tensor(0.9, dtype=torch.float32) ** i
        grouped = upd.grouped_apply_updaters(items, *grouped, grads, scale,
                                             it + 1)
        per_layer = upd.per_layer_apply_updaters(items, *per_layer, grads,
                                                 scale, it + 1)
        assert jax.tree_util.tree_structure(_port_np(grouped)) == \
            jax.tree_util.tree_structure(_port_np(per_layer))
        for a, b in zip(tree_leaves(grouped), tree_leaves(per_layer),
                        strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_multi_data_set_matches_jax(kind):
    wrap = torch.from_numpy if kind == "tensor" else np.asarray
    x, y = _resnet_data(batch=6)
    m = np.ones(6, np.float32)
    ref = JaxMDS.from_dataset(JaxDataSet(x, y, labels_mask=m))
    got = MultiDataSet.from_dataset(DataSet(wrap(x), wrap(y),
                                            labels_mask=wrap(m)))
    assert got.num_examples() == ref.num_examples() == 6
    assert got.features_masks is None and ref.features_masks is None
    for a, b in zip(got.features + got.labels + got.labels_masks,
                    ref.features + ref.labels + ref.labels_masks,
                    strict=True):
        assert isinstance(a, torch.Tensor) == (kind == "tensor")
        np.testing.assert_array_equal(np.asarray(a), b)


def test_policy_scope_restores_the_policy_it_replaced():
    assert dtypes.get_policy() is dtypes.FLOAT32
    with contextlib.ExitStack() as stack:
        stack.enter_context(dtypes.policy_scope(dtypes.MIXED_BF16))
        assert dtypes.get_policy() is dtypes.MIXED_BF16
        with dtypes.policy_scope(dtypes.FLOAT64) as p:
            assert p is dtypes.get_policy() is dtypes.FLOAT64
        assert dtypes.get_policy() is dtypes.MIXED_BF16
        with pytest.raises(RuntimeError):
            with dtypes.policy_scope(dtypes.MIXED_BF16_MASTER):
                raise RuntimeError("inside the scope")
        assert dtypes.get_policy() is dtypes.MIXED_BF16
    assert dtypes.get_policy() is dtypes.FLOAT32
    dtypes.set_policy(dtypes.MIXED_BF16_MASTER)
    try:
        assert dtypes.get_policy() is dtypes.MIXED_BF16_MASTER
    finally:
        dtypes.set_policy(dtypes.FLOAT32)
    assert jax_dtypes.get_policy() is jax_dtypes.FLOAT32
