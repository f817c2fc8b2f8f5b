"""Port parity for the pretraining layers and ``MultiLayerNetwork.pretrain``
against ``deeplearning4j_tpu.nn.layers.pretrain`` and the JAX network.

``jax.random`` streams cannot be reproduced in torch, so both packages
are fed the same draws: the uniforms and normals the reference's keys
give (``jax.random.bernoulli(key, p)`` is ``uniform(key, p.shape) < p``,
held below), laid out as the reference lays out its keys
(``split(rng, 2k + 1)``: the first hidden sample, then a visible and a
hidden draw per Gibbs step; the AutoEncoder's corruption mask from the
step's key itself). A binary sample then differs only where a draw lies
within rounding of its mean: the tests count flipped samples and fail on
one.

Gates: float32 at rtol 1e-4 / atol 1e-6 (the two packages sum the same
products in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import layers as jax_L
from deeplearning4j_tpu.nn.conf.enums import HiddenUnit, VisibleUnit
from deeplearning4j_tpu.nn.conf.enums import Updater as JaxUpdater
from deeplearning4j_tpu.nn.layers import get_layer_impl as jax_impl
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models.convert import (
    load_network_from_jax,
    params_from_jax,
)
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.neural_net import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import get_layer_impl

RTOL, ATOL = 1e-4, 1e-6
UNITS = [(HiddenUnit.BINARY, VisibleUnit.BINARY),
         (HiddenUnit.GAUSSIAN, VisibleUnit.GAUSSIAN),
         (HiddenUnit.RECTIFIED, VisibleUnit.LINEAR),
         (HiddenUnit.SOFTMAX, VisibleUnit.SOFTMAX)]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(a, b, rtol=RTOL, atol=ATOL):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _close(a[k], b[k], rtol, atol)
        return
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


def _draw(kind, key, shape):
    if kind == "uniform":
        return jax.random.uniform(key, shape, jnp.float32)
    return jax.random.normal(key, shape, jnp.float32)


def cd_draws(impl, rng, batch):
    """The draws of one CD-k step from the reference's key ``rng``, as
    numpy arrays (None where the unit is mean-field)."""
    shapes = impl.draw_shapes(batch)
    keys = jax.random.split(rng, len(shapes))
    return [None if kind is None else np.asarray(_draw(kind, keys[j], shape))
            for j, (kind, shape) in enumerate(shapes)]


def _t(draws):
    return [None if d is None else torch.from_numpy(d.copy()) for d in draws]


def _rbm_pair(hidden, visible, k, n_in=12, n_out=7):
    kw = dict(n_in=n_in, n_out=n_out, hidden_unit=hidden,
              visible_unit=visible, k=k)
    ref = jax_impl(jax_L.RBM(**kw))
    port = get_layer_impl(L.RBM(**kw))
    params = _np(ref.init_params(jax.random.PRNGKey(3)))
    # nonzero biases, so every term of the update is exercised
    rng = np.random.default_rng(1)
    params["hb"] = rng.normal(0, 0.1, n_out).astype(np.float32)
    params["vb"] = rng.normal(0, 0.1, n_in).astype(np.float32)
    return ref, port, params


def _visible(visible, shape, seed=0):
    rng = np.random.default_rng(seed)
    if visible == VisibleUnit.BINARY:
        return (rng.random(shape) < 0.4).astype(np.float32)
    if visible == VisibleUnit.SOFTMAX:
        return np.eye(shape[1], dtype=np.float32)[
            rng.integers(0, shape[1], shape[0])]
    return rng.normal(0, 1, shape).astype(np.float32)


def test_bernoulli_is_uniform_below_p():  # dl4j-lint: disable=rng-reuse -- one key feeds both calls on purpose: the test holds bernoulli(key) to uniform(key) < p
    """What the port's draws rest on, on the installed jax."""
    key = jax.random.PRNGKey(11)
    p = jnp.asarray(np.random.default_rng(0).random((64, 33)), jnp.float32)
    assert np.array_equal(np.asarray(jax.random.bernoulli(key, p)),
                          np.asarray(jax.random.uniform(key, p.shape,
                                                        p.dtype) < p))
    keep = jax.random.bernoulli(key, 1.0 - 0.3, (16, 9))
    assert np.array_equal(np.asarray(keep), np.asarray(
        jax.random.uniform(key, (16, 9), jnp.float32) < 0.7))


@pytest.mark.parametrize("hidden,visible", UNITS,
                         ids=[f"{h.name}-{v.name}" for h, v in UNITS])
def test_rbm_propagation_and_free_energy(hidden, visible):
    ref, port, params = _rbm_pair(hidden, visible, 1)
    tp = params_from_jax(params)
    v = _visible(visible, (9, 12))
    h = np.random.default_rng(2).random((9, 7)).astype(np.float32)
    _close(port.prop_up(tp, torch.from_numpy(v)), ref.prop_up(params, v))
    _close(port.prop_down(tp, torch.from_numpy(h)), ref.prop_down(params, h))
    _close(port.free_energy(tp, torch.from_numpy(v)),
           ref.free_energy(params, v))
    y, _ = port.forward(tp, torch.from_numpy(v), {})
    _close(y, ref.forward(params, v, {})[0])


def _jax_chain(ref, params, v0, rng, k):
    """The reference's CD-k chain, unrolled: its samples in order."""
    keys = jax.random.split(rng, 2 * k + 1)
    _, h_s = ref._sample_hidden(params, v0, keys[0])
    samples = [h_s]
    for kv, kh in keys[1:].reshape(k, 2, -1):
        _, v_s = ref._sample_visible(params, h_s, kv)
        _, h_s = ref._sample_hidden(params, v_s, kh)
        samples += [v_s, h_s]
    return samples


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("hidden,visible", UNITS,
                         ids=[f"{h.name}-{v.name}" for h, v in UNITS])
def test_cd_k_step_matches_with_the_same_draws(hidden, visible, k):
    ref, port, params = _rbm_pair(hidden, visible, k)
    tp = params_from_jax(params)
    v0 = _visible(visible, (10, 12), seed=k)
    rng = jax.random.PRNGKey(40 + k)
    draws = cd_draws(port, rng, 10)
    grads, score = port.pretrain_grads(tp, torch.from_numpy(v0),
                                       draws=_t(draws))
    ref_grads, ref_score = ref.pretrain_grads(params, jnp.asarray(v0), rng)
    _close(grads, _np(ref_grads))
    _close(score, ref_score)
    # the samples themselves: zero flipped
    h0, steps = port.gibbs_chain(tp, torch.from_numpy(v0), draws=_t(draws))
    ours = [h0] + [s for v_m, v_s, h_m, h_s in steps for s in (v_s, h_s)]
    theirs = _jax_chain(ref, params, jnp.asarray(v0), rng, k)
    for j, (a, b) in enumerate(zip(ours, theirs)):
        if (hidden == HiddenUnit.BINARY if j % 2 == 0  # a hidden sample
                else visible == VisibleUnit.BINARY):
            flipped = int(np.sum(a.numpy() != np.asarray(b)))
            assert flipped == 0, f"{flipped} flipped samples in draw {j}"
        else:
            _close(a, b)


def test_cd_draws_from_a_generator_are_binary_and_reproducible():
    _, port, params = _rbm_pair(HiddenUnit.BINARY, VisibleUnit.BINARY, 2)
    tp = params_from_jax(params)
    v0 = torch.from_numpy(_visible(VisibleUnit.BINARY, (10, 12)))
    a = port.pretrain_grads(tp, v0, torch.Generator().manual_seed(5))
    b = port.pretrain_grads(tp, v0, torch.Generator().manual_seed(5))
    assert all(torch.equal(a[0][n], b[0][n]) for n in a[0])
    _, steps = port.gibbs_chain(tp, v0, torch.Generator().manual_seed(5))
    assert set(torch.unique(steps[-1][1]).tolist()) <= {0.0, 1.0}
    with pytest.raises(ValueError, match="takes 5 draws"):
        port.pretrain_grads(tp, v0, draws=[None])


@pytest.mark.parametrize("level", [0.0, 0.3])
def test_autoencoder_loss_and_grads_with_the_same_mask(level):
    kw = dict(n_in=10, n_out=6, corruption_level=level, activation="sigmoid",
              loss_function="RMSE_XENT")
    ref, port = jax_impl(jax_L.AutoEncoder(**kw)), get_layer_impl(
        L.AutoEncoder(**kw))
    params = _np(ref.init_params(jax.random.PRNGKey(0)))
    x = np.random.default_rng(3).random((8, 10)).astype(np.float32)
    rng = jax.random.PRNGKey(9)
    mask_u = np.asarray(jax.random.uniform(rng, x.shape, jnp.float32))
    ref_loss, ref_g = jax.value_and_grad(
        lambda p: ref.pretrain_loss(p, jnp.asarray(x), rng))(params)
    tp = {k: v.requires_grad_() for k, v in params_from_jax(params).items()}
    loss = port.pretrain_loss(tp, torch.from_numpy(x),
                              draws=[torch.from_numpy(mask_u.copy())])
    grads = dict(zip(tp, torch.autograd.grad(loss, list(tp.values()))))
    _close(loss, ref_loss)
    _close(grads, _np(ref_g))
    y, _ = port.forward(params_from_jax(params), torch.from_numpy(x), {})
    _close(y, ref.forward(params, x, {})[0])


@pytest.mark.parametrize("masked", [False, True])
def test_recursive_autoencoder_forward_and_loss(masked):
    kw = dict(n_in=5, n_out=4, activation="tanh", loss_function="MSE")
    ref = jax_impl(jax_L.RecursiveAutoEncoder(**kw))
    port = get_layer_impl(L.RecursiveAutoEncoder(**kw))
    params = _np(ref.init_params(jax.random.PRNGKey(2)))
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (3, 6, 5)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((3, 6), np.float32)
        mask[0, 4:] = 0
        mask[2, 2:] = 0
    tmask = None if mask is None else torch.from_numpy(mask)
    tp = params_from_jax(params)
    y, _ = port.forward(tp, torch.from_numpy(x), {}, mask=tmask)
    _close(y, ref.forward(params, jnp.asarray(x), {}, mask=mask)[0])
    ref_loss, ref_g = jax.value_and_grad(
        lambda p: ref.pretrain_loss(p, jnp.asarray(x), None, mask=mask))(
            params)
    tg = {k: v.requires_grad_() for k, v in tp.items()}
    loss = port.pretrain_loss(tg, torch.from_numpy(x), mask=tmask)
    _close(loss, ref_loss)
    _close(dict(zip(tg, torch.autograd.grad(loss, list(tg.values())))),
           _np(ref_g))
    y2, _ = port.forward(tp, torch.from_numpy(x[:, 0]), {})  # rank 2
    _close(y2, ref.forward(params, jnp.asarray(x[:, 0]), {})[0])


@pytest.mark.parametrize("cls,n", [(L.RBM, 12 * 7 + 7 + 12),
                                   (L.AutoEncoder, 12 * 7 + 7 + 12),
                                   (L.RecursiveAutoEncoder,
                                    19 * 7 + 7 + 7 * 19 + 19)])
def test_pretrain_layers_count_their_params(cls, n):
    impl = get_layer_impl(cls(n_in=12, n_out=7))
    assert impl.num_params() == n
    assert sum(p.numel() for p in impl.init_params(
        torch.Generator().manual_seed(0)).values()) == n


# ---------------------------------------------------------------------------
# MultiLayerNetwork.pretrain and fit
# ---------------------------------------------------------------------------
def _stack_conf(updater, layers=None, backprop=True, algo=None,
                iterations=1):
    b = (JaxNNC.Builder().seed(17).learning_rate(0.05).updater(updater)
         .iterations(iterations))
    if algo is not None:
        b = b.optimization_algo(algo)
    b = b.list()
    layers = layers or [jax_L.RBM(n_in=12, n_out=10),
                        jax_L.RBM(n_in=10, n_out=8),
                        jax_L.RBM(n_in=8, n_out=6)]
    for i, layer in enumerate(layers):
        b = b.layer(i, layer)
    b = b.layer(len(layers), jax_L.OutputLayer(
        n_in=layers[-1].n_out, n_out=3, loss_function="MCXENT",
        activation="softmax"))
    return b.pretrain(True).backprop(backprop).build()


def _batches(n=3, batch=16, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = (rng.random((batch, 12)) < 0.3).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, batch)]
        out.append((x, y))
    return out


class ReferenceDraws:
    """The draws the JAX network's pretraining takes, replayed for the
    port: one split of the network's key per layer and batch, then CD-k's
    ``2k + 1`` keys (an RBM) or the key itself (an AutoEncoder's mask)."""

    def __init__(self, key):
        self.key = key

    def advance(self, n):  # the splits the reference's SGD steps take
        for _ in range(n):
            self.key, _ = jax.random.split(self.key)

    def __call__(self, i, impl, x):
        self.key, rng = jax.random.split(self.key)
        if hasattr(impl, "draw_shapes"):
            return _t(cd_draws(impl, rng, x.shape[0]))
        return [torch.from_numpy(np.array(jax.random.uniform(
            rng, tuple(x.shape), jnp.float32)))]


def _pair(jconf):
    ref = JaxMLN(jconf).init()
    port = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu")
    load_network_from_jax(port, _np(ref.params), _np(ref.updater_state),
                          _np(ref.net_state), ref.iteration_count)
    return ref, port


def _assert_same_state(ref, port):
    _close(port.params, _np(ref.params))
    _close(port.updater_state, _np(ref.updater_state))
    assert port.iteration_count == ref.iteration_count


@pytest.mark.parametrize("updater", [JaxUpdater.SGD, JaxUpdater.ADAM],
                         ids=["sgd", "adam"])
@pytest.mark.parametrize("stack", ["rbm", "rbm_ae"])
def test_pretrain_stack_matches(updater, stack):
    layers = None
    if stack == "rbm_ae":
        layers = [jax_L.RBM(n_in=12, n_out=10, k=2),
                  jax_L.AutoEncoder(n_in=10, n_out=8, corruption_level=0.3,
                                    activation="sigmoid",
                                    loss_function="RMSE_XENT")]
    ref, port = _pair(_stack_conf(updater, layers))
    draws = ReferenceDraws(ref._rng)
    data = _batches()
    ref.pretrain([JaxDataSet(x, y) for x, y in data])
    port.pretrain([DataSet(x, y) for x, y in data], draws=draws)
    _assert_same_state(ref, port)
    n_pre = 3 if stack == "rbm" else 2
    assert sorted(port.pretrain_scores) == list(range(n_pre))
    assert all(len(s) == 3 for s in port.pretrain_scores.values())
    np.testing.assert_allclose(port.score_value, ref.score_value,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("algo", [None, "LBFGS"], ids=["sgd", "lbfgs"])
def test_fit_pretrains_then_backprops(algo):
    from deeplearning4j_tpu.nn.conf.enums import OptimizationAlgorithm

    iterations = 2
    jconf = _stack_conf(JaxUpdater.SGD, algo=algo and OptimizationAlgorithm(
        algo), iterations=iterations)
    ref, port = _pair(jconf)
    port._pretrain_draws = ReferenceDraws(ref._rng)
    for x, y in _batches(2, seed=8):
        ref.fit(JaxDataSet(x, y))
        port.fit(DataSet(x, y))
        _assert_same_state(ref, port)
        np.testing.assert_allclose(port.score_value, ref.score_value,
                                   rtol=RTOL, atol=ATOL)
        if algo is None:  # each SGD step splits the reference's key
            port._pretrain_draws.advance(iterations)


def test_pretrain_only_conf_trains_no_output_layer():
    ref, port = _pair(_stack_conf(JaxUpdater.SGD, backprop=False))
    port._pretrain_draws = ReferenceDraws(ref._rng)
    (x, y), = _batches(1)
    before = port.params["3"]["W"].clone()
    ref.fit(JaxDataSet(x, y))
    port.fit(DataSet(x, y))
    _assert_same_state(ref, port)
    assert torch.equal(port.params["3"]["W"], before)
