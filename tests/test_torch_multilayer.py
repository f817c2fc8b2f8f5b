"""Port parity for ``MultiLayerNetwork`` on the two zoo models, LeNet-5
(at its fixed widths) and the MNIST MLP (hidden 32), against
``deeplearning4j_tpu.nn.multilayer`` with the JAX network's params,
Adam state and iteration count carried over by
``models/convert.load_network_from_jax``; batches of 8 seeded numpy
draws with one-hot labels.

Tolerances:

- inference (``output``, ``feed_forward``, ``score``) under float32:
  1e-5 relative to each array's largest magnitude (summation order only);
- after 3 ``fit`` steps under float32: losses, params and Adam ``m``/``v``
  at rtol 1e-4 / atol 1e-6 (the reference's conv and GEMM sum in another
  order; Adam's epsilon of 1e-6 keeps a gradient's last bits from
  swinging a step);
- under ``bf16`` (bf16 operands, f32 outputs) and ``mixed_bf16`` (a bf16
  copy of f32 master weights): 2e-2 / 1e-2, the reference's own gates
  for bf16 training (``tests/test_mixed_precision.py``).

Port-internal equalities (``fit_steps`` against ``fit`` calls, flat
params round trip) are held bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.iterator import \
    ListDataSetIterator as JaxListIterator
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import layers as jax_L
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.models.convert import load_network_from_jax
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import layers as L

MODELS = ["mnist_mlp", "lenet5"]
BATCH = 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _data(name, batch=BATCH, seed=0):
    rng = np.random.default_rng(seed)
    shape = (batch, 28, 28, 1) if name == "lenet5" else (batch, 784)
    x = rng.random(shape, np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, batch)]
    return x, y


def _carry(ref, port):
    return load_network_from_jax(port, _np(ref.params),
                                 _np(ref.updater_state), _np(ref.net_state),
                                 ref.iteration_count)


def _pair(name, policy="float32"):
    kw = {"hidden": 32} if name == "mnist_mlp" else {}
    ref = getattr(jax_zoo, name)(dtype_policy=policy, **kw).init()
    port = getattr(zoo, name)(dtype_policy=policy, device="cpu", **kw)
    return ref, _carry(ref, port)


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= tol * scale


def _port_tree_np(tree):
    return jax.tree_util.tree_map(lambda t: t.numpy(), tree)


@pytest.mark.parametrize("name", MODELS)
def test_inference_agrees(name):
    ref, port = _pair(name)
    x, y = _data(name)
    out = port.output(x)
    assert out.device == torch.device("cpu")
    _close(out.numpy(), ref.output(x))
    for got, want in zip(port.feed_forward(x), ref.feed_forward(x),
                         strict=True):
        _close(got.numpy(), want)
    np.testing.assert_array_equal(port.predict(x), ref.predict(x))
    _close(port.score(DataSet(x, y)), ref.score(JaxDataSet(x, y)))
    _close(port.score_examples(DataSet(x, y)),
           ref.score_examples(JaxDataSet(x, y)))


def _train_both(ref, port, x, y, steps=3):
    la, lb = [], []
    for _ in range(steps):
        ref.fit(JaxDataSet(x, y))
        la.append(ref.score_value)
        port.fit(DataSet(x, y))
        lb.append(port.score_value)
    return np.array(la), np.array(lb)


@pytest.mark.parametrize("policy,rtol,atol", [
    ("float32", 1e-4, 1e-6), ("bf16", 2e-2, 1e-2),
    ("mixed_bf16", 2e-2, 1e-2)], ids=["f32", "bf16", "mixed_bf16"])
@pytest.mark.parametrize("name", MODELS)
def test_three_fit_steps_match(name, policy, rtol, atol):
    ref, port = _pair(name, policy)
    x, y = _data(name)
    la, lb = _train_both(ref, port, x, y)
    np.testing.assert_allclose(lb, la, rtol=rtol, atol=atol)
    assert la[-1] < la[0] and lb[-1] < lb[0]
    assert port.iteration_count == ref.iteration_count == 3
    pairs = [(_port_tree_np(port.params), _np(ref.params)),
             (_port_tree_np(port.updater_state), _np(ref.updater_state))]
    for got, want in pairs:
        got_l, want_l = (jax.tree_util.tree_leaves(t) for t in (got, want))
        assert len(got_l) == len(want_l)
        for a, b in zip(got_l, want_l):
            assert a.dtype == np.float32
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", MODELS)
def test_fit_steps_equals_fit_calls(name):
    ref, a = _pair(name)
    b = _carry(ref, getattr(zoo, name)(
        device="cpu", **({"hidden": 32} if name == "mnist_mlp" else {})))
    x, y = _data(name)
    ds = DataSet(torch.from_numpy(x), torch.from_numpy(y))
    a.fit_steps(ds, 3)
    for _ in range(3):
        b.fit(ds)
    assert a.iteration_count == b.iteration_count == 3
    assert a.score_value == b.score_value
    for u, v in zip(jax.tree_util.tree_leaves((a.params, a.updater_state)),
                    jax.tree_util.tree_leaves((b.params, b.updater_state)),
                    strict=True):
        assert torch.equal(u, v)
    ref.fit_steps(JaxDataSet(x, y), 3)
    assert ref.iteration_count == 3


def _mlp_conf(nnc, Lmod, l1=0.0, l2=0.0):
    return (nnc.Builder().seed(3).learning_rate(0.1).l1(l1).l2(l2).list()
            .layer(0, Lmod.DenseLayer(n_in=784, n_out=16, activation="relu"))
            .layer(1, Lmod.OutputLayer(n_in=16, n_out=10))
            .build())


def test_l1_l2_change_the_score_as_in_jax():
    l1, l2 = 1e-3, 1e-2
    ref = JaxMLN(_mlp_conf(JaxNNC, jax_L, l1, l2)).init()
    port = _carry(ref, MultiLayerNetwork(
        _mlp_conf(NeuralNetConfiguration, L, l1, l2), device="cpu"))
    plain = _carry(ref, MultiLayerNetwork(
        _mlp_conf(NeuralNetConfiguration, L), device="cpu"))
    x, y = _data("mnist_mlp")
    got = port.score(DataSet(x, y))
    _close(got, ref.score(JaxDataSet(x, y)))
    # the penalty covers the weights and not the biases
    W = [np.asarray(ref.params[k]["W"], np.float64) for k in ("0", "1")]
    penalty = sum(l1 * np.abs(w).sum() + 0.5 * l2 * (w * w).sum() for w in W)
    _close(got - plain.score(DataSet(x, y)), penalty)
    port.fit(DataSet(x, y))
    ref.fit(JaxDataSet(x, y))
    _close(port.get_flat_params(), ref.get_flat_params(), 1e-4)


def _policy_conf(nnc, Lmod, E, kind):
    b = nnc.Builder().seed(5).iterations(2)
    if kind == "nesterovs-step":
        b = (b.learning_rate(0.05).updater(E.Updater.NESTEROVS).momentum(0.8)
             .learning_rate_decay_policy(E.LearningRatePolicy.STEP)
             .lr_policy_decay_rate(0.5).lr_policy_steps(3))
    else:  # the score-reactive policy, decided on the host per step
        # Adam's first steps are lr·g/(|g| + 1e-6): a gradient element near
        # 1e-6 carries its summation-order noise times lr/1e-6 into the
        # params, so the lr is the zoo's 1e-3, not 0.05
        b = (b.learning_rate(1e-3).updater(E.Updater.ADAM)
             .learning_rate_decay_policy(E.LearningRatePolicy.SCORE)
             .learning_rate_score_based_decay_rate(0.5))
    return (b.list()
            .layer(0, Lmod.DenseLayer(n_in=784, n_out=16, activation="tanh"))
            .layer(1, Lmod.OutputLayer(n_in=16, n_out=10)).build())


@pytest.mark.parametrize("kind", ["nesterovs-step", "adam-score"])
def test_fit_iterator_epochs_match_jax(kind):
    """``fit(iterator, num_epochs=2)`` over ragged batches of 5, 2 optimizer
    iterations each, under an LR policy: float32 at rtol 1e-4 / atol 1e-6,
    as after 3 ``fit`` steps; ``fit_steps`` falls back to ``fit`` calls
    under SCORE and takes the Python loop otherwise."""
    from deeplearning4j_tpu.nn.conf import enums as jax_E
    from deeplearning4j_tpu_torch.nn.conf import enums as E

    ref = JaxMLN(_policy_conf(JaxNNC, jax_L, jax_E, kind)).init()
    port = _carry(ref, MultiLayerNetwork(
        _policy_conf(NeuralNetConfiguration, L, E, kind), device="cpu"))
    x, y = _data("mnist_mlp", batch=12)
    ref.fit(JaxListIterator(JaxDataSet(x, y), 5), num_epochs=2)
    port.fit(ListDataSetIterator(DataSet(x, y), 5), num_epochs=2)
    assert port.iteration_count == ref.iteration_count == 12
    np.testing.assert_allclose(port.score_value, ref.score_value,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(port.get_flat_params(), ref.get_flat_params(),
                               rtol=1e-4, atol=1e-6)
    assert port._lr_scale_host == pytest.approx(ref._lr_scale_host)
    if kind == "adam-score":
        assert ref._lr_scale_host < 1.0  # the policy decayed the lr
    ref.fit_steps(JaxDataSet(x, y), 2)
    port.fit_steps(DataSet(x, y), 2)
    assert port.iteration_count == ref.iteration_count == 16
    np.testing.assert_allclose(port.get_flat_params(), ref.get_flat_params(),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("device_accumulation", [True, False],
                         ids=["device", "host"])
@pytest.mark.parametrize("name", MODELS)
def test_evaluate_matches_jax(name, device_accumulation):
    ref, port = _pair(name)
    x, y = _data(name, batch=13)
    mask = np.ones(13, np.float32)
    mask[[2, 7]] = 0.0
    jds, ds = JaxDataSet(x, y, labels_mask=mask), DataSet(x, y,
                                                          labels_mask=mask)
    want = ref.evaluate(JaxListIterator(jds, batch_size=5),
                        device_accumulation=device_accumulation)
    got = port.evaluate(ListDataSetIterator(ds, batch_size=5),
                        device_accumulation=device_accumulation)
    np.testing.assert_array_equal(got.confusion.to_array(),
                                  want.confusion.to_array())
    assert got.confusion.to_array().sum() == 11
    assert got.accuracy() == want.accuracy() and got.f1() == want.f1()
    other = port.evaluate(ds, device_accumulation=not device_accumulation)
    np.testing.assert_array_equal(other.confusion.to_array(),
                                  got.confusion.to_array())


def test_evaluate_regression_matches_jax():
    ref, port = _pair("mnist_mlp")
    x, y = _data("mnist_mlp", batch=12)
    want = ref.evaluate_regression(JaxListIterator(JaxDataSet(x, y), 5))
    got = port.evaluate_regression(ListDataSetIterator(DataSet(x, y), 5))
    for col in range(10):
        for m in ("mean_squared_error", "mean_absolute_error",
                  "correlation_r2", "pearson_correlation"):
            _close(getattr(got, m)(col), getattr(want, m)(col), 1e-4)


@pytest.mark.parametrize("name", MODELS)
def test_flat_params_and_param_table(name):
    ref, port = _pair(name)
    flat = port.get_flat_params()
    np.testing.assert_array_equal(flat, ref.get_flat_params())
    assert flat.size == port.num_params() == ref.num_params()
    assert sorted(port.get_param_table()) == sorted(ref.get_param_table())
    other = getattr(zoo, name)(
        device="cpu", seed=1, **({"hidden": 32} if name == "mnist_mlp" else {}))
    other.set_flat_params(flat)
    np.testing.assert_array_equal(other.get_flat_params(), flat)
    other.set_param_table({"0_b": np.full_like(flat[:1], 0.5).repeat(
        port.get_param_table()["0_b"].size)})
    assert float(other.params["0"]["b"][0]) == 0.5
    with pytest.raises(ValueError, match="param vector length"):
        other.set_flat_params(flat[:-1])
    clone = port.clone()
    np.testing.assert_array_equal(clone.get_flat_params(), flat)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_dataset_helpers_match_jax(kind):
    """The port's ``DataSet`` on numpy arrays or tensors gives the JAX
    ``DataSet``'s values (float32: 1e-6 relative, summation order only)."""
    x, y = _data("mnist_mlp", batch=7)
    wrap = torch.from_numpy if kind == "tensor" else np.asarray

    def both(fn):
        a, b = JaxDataSet(x.copy(), y.copy()), DataSet(wrap(x.copy()),
                                                       wrap(y.copy()))
        fn(a), fn(b)
        assert isinstance(b.features, torch.Tensor) == (kind == "tensor")
        _close(np.asarray(b.features), a.features, 1e-6)
        _close(np.asarray(b.labels), a.labels, 1e-6)

    both(lambda d: d.shuffle(3))
    both(lambda d: d.normalize_zero_mean_unit_variance())
    both(lambda d: d.scale_minus_one_to_one())
    ds = DataSet(wrap(x), wrap(y))
    parts = ds.batch_by(3)
    assert [p.num_examples() for p in parts] == [3, 3, 1]
    merged = DataSet.merge(parts)
    np.testing.assert_array_equal(np.asarray(merged.features), x)
    train, test = ds.split_test_and_train(5)
    assert (train.num_examples(), test.num_examples()) == (5, 2)
    it = ListDataSetIterator(parts, batch_size=4)
    assert [b.num_examples() for b in it] == [4, 3]
    assert it.total_examples() == 7 and it.total_outcomes() == 10


def test_lenet_counts_its_params_without_drawing_them():
    net = zoo.lenet5(device="cpu")
    assert net.num_params() == 431_080 == jax_zoo.lenet5().init().num_params()
    assert net.params == {}  # counting drew no weight
    assert net.init().get_flat_params().size == 431_080


@pytest.mark.parametrize("call,item", [
    (lambda n, ds: n.fit_epochs(ds, 1, mesh=object()), "A14"),
    (lambda n, ds: n.build_epoch_cache(ds, mesh=object()), "A14"),
    (lambda n, ds: n.request_reshard(None), "A14"),
    (lambda n, ds: n.pretrain([ds]), "A10.3"),
], ids=["fit_epochs", "build_epoch_cache", "request_reshard", "pretrain"])
def test_features_outside_the_slice_raise(call, item):
    net = zoo.mnist_mlp(hidden=8, device="cpu").init()
    x, y = _data("mnist_mlp")
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        call(net, DataSet(x, y))
    # the fused epoch path itself is ported; only the mesh is not
    assert net.fused_epochs_supported()


def test_solver_raises_with_its_item():
    from deeplearning4j_tpu_torch.nn.conf import OptimizationAlgorithm

    conf = (NeuralNetConfiguration.Builder()
            .optimization_algo(OptimizationAlgorithm.LBFGS).list()
            .layer(0, L.OutputLayer(n_in=784, n_out=10)).build())
    x, y = _data("mnist_mlp")
    with pytest.raises(NotImplementedError, match="ROADMAP A10.4"):
        MultiLayerNetwork(conf, device="cpu").fit(DataSet(x, y))


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zoo.lenet5()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiLayerNetwork(zoo.mnist_mlp(device="cpu").conf)
    assert zoo.lenet5(device="cpu").device == torch.device("cpu")
