"""Port parity for the DL4J layer numerics: activations, losses, the
dense/output, convolution and pooling layers, initializers and dropout,
against ``deeplearning4j_tpu`` on the same numpy inputs and weights.

Forward values and gradients (of ``sum(y * G)`` for a seeded cotangent
``G``, with respect to the input and every param) are held at float32
``rtol 1e-5`` with an absolute floor of ``1e-5`` times the largest
magnitude of the reference's array: the two packages sum the same
products in other orders (a convolution sums up to 27 products here, a
pooling window 9), which moves results by a few float32 ulps of the
largest term. Initializers are held in distribution (torch's streams are
not ``jax.random``'s)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import enums as jax_enums
from deeplearning4j_tpu.nn.conf import layers as jax_L
from deeplearning4j_tpu.nn.layers import get_layer_impl as jax_layer_impl
from deeplearning4j_tpu.ops import activations as jax_act
from deeplearning4j_tpu.ops import initializers as jax_init
from deeplearning4j_tpu.ops import losses as jax_losses
from deeplearning4j_tpu_torch.nn.conf import enums
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers import get_layer_impl
from deeplearning4j_tpu_torch.ops import activations, initializers, losses

TOL = 1e-5


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", jax_act.activation_names())
def test_activation_forward_and_gradient(name):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 7)) * 3).astype(np.float32)
    g = rng.standard_normal((4, 7)).astype(np.float32)
    f_ref = jax_act.get_activation(name)
    want, want_g = jax.jit(lambda v: (f_ref(v), jax.grad(
        lambda u: jnp.sum(f_ref(u) * g))(v)))(jnp.asarray(x))
    xt = _t(x, grad=True)
    got = activations.get_activation(name)(xt)
    (got * _t(g)).sum().backward()
    _close(got.detach(), want)
    _close(xt.grad, want_g)


def test_activation_names_match():
    assert activations.activation_names() == jax_act.activation_names()


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

LOSSES = [l for l in jax_losses.LossFunction if l.value != "CUSTOM"]


@pytest.mark.parametrize("mask_kind", ["none", "example", "timestep"])
@pytest.mark.parametrize("loss", [l.value for l in LOSSES])
def test_loss_value_and_gradient(loss, mask_kind):
    rng = np.random.default_rng(2)
    shape = (5, 3, 4) if mask_kind == "timestep" else (5, 4)
    out = rng.uniform(0.05, 0.95, shape).astype(np.float32)
    labels = np.eye(4, dtype=np.float32)[rng.integers(0, 4, shape[:-1])]
    mask = None
    if mask_kind != "none":
        mask = (rng.random(shape[:-1]) > 0.3).astype(np.float32)
        mask.reshape(-1)[0] = 1.0
    jm = None if mask is None else jnp.asarray(mask)
    f = lambda o: jax_losses.compute_loss(loss, o, jnp.asarray(labels), jm)
    want, want_g = jax.jit(jax.value_and_grad(f))(jnp.asarray(out))
    ot = _t(out, grad=True)
    got = losses.compute_loss(loss, ot, _t(labels),
                              None if mask is None else _t(mask))
    got.backward()
    _close(got.detach(), want)
    _close(ot.grad, want_g)
    _close(losses.per_example_loss(loss, _t(out), _t(labels)),
           jax_losses.per_example_loss(loss, jnp.asarray(out),
                                       jnp.asarray(labels)))


def test_mcxent_clip_splits_the_gradient_at_one():
    """A softmax output of exactly 1.0 sits on the clip's upper bound: the
    reference's ``jnp.clip`` gives it half the gradient, and so does the
    port (``torch.clamp`` would give all of it)."""
    out = np.array([[1.0, 0.0, 0.0]], np.float32)
    y = np.array([[1.0, 0.0, 0.0]], np.float32)
    want = jax.grad(lambda o: jax_losses.compute_loss(
        "MCXENT", o, jnp.asarray(y)))(jnp.asarray(out))
    ot = _t(out, grad=True)
    losses.compute_loss("MCXENT", ot, _t(y)).backward()
    _close(ot.grad, want)
    assert float(ot.grad[0, 0]) == -0.5


# ---------------------------------------------------------------------------
# layers: forward and gradients against the JAX layer on the same params
# ---------------------------------------------------------------------------


def _confs(cls_name, **kw):
    """The same conf in both packages (enum fields given by value)."""
    def build(Lmod, E):
        args = dict(kw)
        if "pooling_type" in args:
            args["pooling_type"] = E.PoolingType(args["pooling_type"])
        return getattr(Lmod, cls_name)(**args)

    return build(jax_L, jax_enums), build(L, enums)


def _jax_fwd_bwd(f, rng, *args):
    """The reference's ``f(*args)``, a seeded cotangent ``g`` of its shape
    and the gradients of ``sum(f(*args) * g)``, from one compiled call."""
    g = rng.standard_normal(jax.eval_shape(f, *args).shape).astype(
        np.float32)

    def fwd_bwd(*a):
        out, vjp = jax.vjp(f, *a)
        return out, vjp(jnp.asarray(g))

    out, grads = jax.jit(fwd_bwd)(*args)
    return out, g, grads


def _check_layer(cls_name, x, mask=None, **kw):
    jconf, pconf = _confs(cls_name, **kw)
    impl = get_layer_impl(pconf)
    rng = np.random.default_rng(3)
    params = {k: (rng.standard_normal(s) * 0.5).astype(np.float32)
              for k, s in impl.param_shapes().items()}
    jimpl = jax_layer_impl(jconf)
    jm = None if mask is None else jnp.asarray(mask)

    def f(p, v):
        return jimpl.forward(p, v, {}, train=False, rng=None, mask=jm)[0]

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want, g, (want_gp, want_gx) = _jax_fwd_bwd(f, rng, jp, jnp.asarray(x))
    tp = {k: _t(v, grad=True) for k, v in params.items()}
    xt = _t(x, grad=True)
    got, _ = impl.forward(tp, xt, {}, train=False, rng=None,
                          mask=None if mask is None else _t(mask))
    (got * _t(g)).sum().backward()
    _close(got.detach(), want)
    _close(xt.grad, want_gx)
    for k in params:
        _close(tp[k].grad, want_gp[k])
    return got


def _x(*shape, seed=4):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("cls_name,shape,kw", [
    ("DenseLayer", (6, 7), dict(n_in=7, n_out=5, activation="tanh")),
    ("OutputLayer", (6, 7), dict(n_in=7, n_out=4)),
    ("RnnOutputLayer", (3, 5, 7), dict(n_in=7, n_out=4)),
    ("ActivationLayer", (6, 7), dict(activation="elu")),
], ids=["dense", "output", "rnn_output", "activation"])
def test_feedforward_layers(cls_name, shape, kw):
    _check_layer(cls_name, _x(*shape), **kw)


def test_loss_layer():
    _check_layer("LossLayer", _x(6, 4), activation="softmax")


@pytest.mark.parametrize("x", [
    np.array([3, 0, 4, 3], np.int64),
    np.array([[1], [4], [0]], np.int64),
    np.eye(5, dtype=np.float32)[[2, 2, 0]],
], ids=["indices", "indices-b1", "one-hot"])
def test_embedding(x):
    jconf, pconf = _confs("EmbeddingLayer", n_in=5, n_out=3,
                          activation="tanh")
    rng = np.random.default_rng(5)
    params = {"W": rng.standard_normal((5, 3)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    jimpl = jax_layer_impl(jconf)

    def f(p):
        return jimpl.forward(p, jnp.asarray(x), {}, train=False)[0]

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want, g, (want_gp,) = _jax_fwd_bwd(f, rng, jp)
    tp = {k: _t(v, grad=True) for k, v in params.items()}
    got, _ = get_layer_impl(pconf).forward(tp, _t(x), {}, train=False)
    (got * _t(g)).sum().backward()
    _close(got.detach(), want)
    for k in params:
        _close(tp[k].grad, want_gp[k])


# ---------------------------------------------------------------------------
# preprocessors
# ---------------------------------------------------------------------------

PREPROCESSORS = [
    ("CnnToFeedForwardPreProcessor", dict(height=3, width=4, channels=2),
     (2, 3, 4, 2)),
    ("FeedForwardToCnnPreProcessor", dict(height=3, width=4, channels=2),
     (2, 24)),
    ("RnnToFeedForwardPreProcessor", {}, (2, 3, 4)),
    ("FeedForwardToRnnPreProcessor", {}, (6, 4)),
    ("CnnToRnnPreProcessor", dict(height=3, width=4, channels=2),
     (6, 3, 4, 2)),
    ("RnnToCnnPreProcessor", dict(height=3, width=4, channels=2),
     (2, 3, 24)),
    ("ReshapePreProcessor", dict(shape=(4, 6)), (2, 24)),
    ("ZeroMeanAndUnitVariancePreProcessor", {}, (2, 3, 4)),
    ("UnitVariancePreProcessor", {}, (2, 3, 4)),
    ("ZeroMeanPrePreProcessor", {}, (2, 3, 4)),
    ("ComposableInputPreProcessor", dict(preprocessors=(
        {"type": "ZeroMeanPrePreProcessor"},
        {"type": "RnnToFeedForwardPreProcessor"})), (2, 3, 4)),
]


@pytest.mark.parametrize("cls_name,kw,shape", PREPROCESSORS,
                         ids=[p[0] for p in PREPROCESSORS])
def test_preprocessor(cls_name, kw, shape):
    """Output, input gradient and ``to_dict`` against the reference; the
    time-folding ones are given the minibatch size 2."""
    from deeplearning4j_tpu.nn.conf import preprocessors as jax_pre
    from deeplearning4j_tpu_torch.nn.conf import preprocessors as pre

    jp, tp = getattr(jax_pre, cls_name)(**kw), getattr(pre, cls_name)(**kw)
    assert tp.to_dict() == jp.to_dict()
    assert pre.InputPreProcessor.from_dict(jp.to_dict()) == tp
    x = _x(*shape)

    def f(v):
        return jax_pre.apply_preprocessor(jp, v, batch=2)[0]

    want, g, (want_gx,) = _jax_fwd_bwd(f, np.random.default_rng(6),
                                       jnp.asarray(x))
    xt = _t(x, grad=True)
    got = pre.apply_preprocessor(tp, xt, batch=2)[0]
    (got * _t(g)).sum().backward()
    _close(got.detach(), want)
    _close(xt.grad, want_gx)


def test_binomial_sampling_preprocessor():
    """Bernoulli(p = x) draws in distribution, straight-through gradient."""
    from deeplearning4j_tpu_torch.nn.conf import preprocessors as pre

    x = torch.full((300, 200), 0.3, requires_grad=True)
    y, _ = pre.apply_preprocessor(pre.BinomialSamplingPreProcessor(), x,
                                  rng=torch.Generator().manual_seed(0))
    assert set(torch.unique(y.detach()).tolist()) == {0.0, 1.0}
    # 60,000 draws: the share of ones has a standard error of 0.0019
    assert abs(float(y.detach().mean()) - 0.3) < 0.01
    (y * 2.0).sum().backward()
    assert torch.equal(x.grad, torch.full_like(x, 2.0))


@pytest.mark.parametrize("kw", [
    dict(kernel_size=(3, 2), stride=(1, 2), padding=(1, 2)),
    dict(kernel_size=(3, 3), stride=(1, 1), convolution_mode="same"),
    dict(kernel_size=(3, 4), stride=(2, 2), convolution_mode="same"),
    dict(kernel_size=(2, 5), stride=(3, 2), convolution_mode="same"),
], ids=["truncate-padded", "same-s1", "same-s2-asymmetric", "same-s3x2"])
def test_convolution(kw):
    _check_layer("ConvolutionLayer", _x(2, 9, 7, 3), n_in=3, n_out=4,
                 activation="relu", **kw)


@pytest.mark.parametrize("padding", [(0, 0), (1, 1), (2, 1)],
                         ids=["unpadded", "pad1", "pad2x1"])
@pytest.mark.parametrize("pooling", ["MAX", "AVG", "SUM", "PNORM"])
def test_subsampling(pooling, padding):
    _check_layer("SubsamplingLayer", _x(2, 9, 7, 3), pooling_type=pooling,
                 kernel_size=(3, 3), stride=(2, 2), padding=padding, pnorm=3)


@pytest.mark.parametrize("pooling", ["MAX", "AVG", "SUM", "PNORM"])
@pytest.mark.parametrize("rank", [4, 3], ids=["cnn", "rnn-masked"])
def test_global_pooling(pooling, rank):
    if rank == 4:
        _check_layer("GlobalPoolingLayer", _x(2, 5, 4, 3),
                     pooling_type=pooling)
        return
    mask = np.array([[1, 1, 0, 1, 0], [1, 0, 0, 0, 0], [0, 0, 0, 0, 0]],
                    np.float32)
    if pooling == "PNORM":
        mask[2, 0] = 1.0  # |0|^(1/p) has no gradient at 0 in either package
    _check_layer("GlobalPoolingLayer", _x(3, 5, 4), mask=mask,
                 pooling_type=pooling)


# ---------------------------------------------------------------------------
# initializers (in distribution) and dropout
# ---------------------------------------------------------------------------

SHAPE, FAN_IN, FAN_OUT = (200, 150), 200, 150


def _expected(scheme, dist):
    """(mean, std, low bound, high bound) of one scheme at SHAPE's fans."""
    fs = FAN_IN + FAN_OUT
    uni = lambda a: (0.0, a / math.sqrt(3), -a, a)
    normal = lambda s: (0.0, s, -math.inf, math.inf)
    if scheme == "DISTRIBUTION":
        kind = dist["type"]
        if kind == "normal":
            return (dist["mean"], dist["std"], -math.inf, math.inf)
        if kind == "uniform":
            lo, hi = dist["lower"], dist["upper"]
            return ((lo + hi) / 2, (hi - lo) / math.sqrt(12), lo, hi)
        n, p = dist["n"], dist["p"]
        return (n * p, math.sqrt(n * p * (1 - p)), 0.0, float(n))
    return {
        "ZERO": (0.0, 0.0, 0.0, 0.0), "ONES": (1.0, 0.0, 1.0, 1.0),
        "UNIFORM": uni(1 / math.sqrt(FAN_IN)),
        "XAVIER": normal(math.sqrt(2 / fs)),
        "XAVIER_UNIFORM": uni(math.sqrt(6 / fs)),
        "RELU": normal(math.sqrt(2 / FAN_IN)),
        "LECUN": normal(math.sqrt(1 / FAN_IN)),
        "VI": uni(4 * math.sqrt(6 / fs)),
        "SIZE": uni(math.sqrt(6 / fs)),
        "NORMALIZED": (0.0, 1 / math.sqrt(12) / SHAPE[0],
                       -0.5 / SHAPE[0], 0.5 / SHAPE[0]),
    }[scheme]


def _assert_in_distribution(sample, mean, std, lo, hi):
    """Mean within 6 standard errors, std within 3 % (its own standard
    error at 30,000 draws is 0.4 %), every draw inside the bounds."""
    s = np.asarray(sample, np.float64).ravel()
    assert abs(s.mean() - mean) <= 6 * std / math.sqrt(s.size) + 1e-12
    assert abs(s.std() - std) <= 0.03 * std + 1e-12
    assert s.min() >= lo and s.max() <= hi


INIT_CASES = [(s, None) for s in (
    "ZERO", "ONES", "UNIFORM", "XAVIER", "XAVIER_UNIFORM", "RELU", "LECUN",
    "VI", "SIZE", "NORMALIZED")] + [
    ("DISTRIBUTION", {"type": "normal", "mean": 0.3, "std": 2.0}),
    ("DISTRIBUTION", {"type": "uniform", "lower": -1.0, "upper": 3.0}),
    ("DISTRIBUTION", {"type": "binomial", "n": 5, "p": 0.3}),
]


@pytest.mark.parametrize("scheme,dist", INIT_CASES,
                         ids=[s if d is None else f"{s}-{d['type']}"
                              for s, d in INIT_CASES])
def test_initializer_in_distribution(scheme, dist):
    expected = _expected(scheme, dist)
    got = initializers.init_weights(torch.Generator().manual_seed(0), SHAPE,
                                    scheme, distribution=dist)
    assert got.dtype == torch.float32 and tuple(got.shape) == SHAPE
    _assert_in_distribution(got.numpy(), *expected)
    ref = jax_init.init_weights(jax.random.PRNGKey(0), SHAPE, scheme,
                                distribution=dist)
    _assert_in_distribution(np.asarray(ref), *expected)


def test_conv_fans_match():
    for shape in [(5, 5, 1, 20), (3, 2, 7, 4)]:
        assert initializers.conv_fans(shape) == jax_init.conv_fans(shape)


def test_dropout_keep_rate_and_scale():
    impl = get_layer_impl(L.DropoutLayer(dropout=0.3))
    x = torch.ones((200, 300))
    y, _ = impl.forward({}, x, {}, train=True,
                        rng=torch.Generator().manual_seed(0))
    kept = y != 0
    # 60,000 Bernoulli(0.7) draws: the kept share's std is 0.0019
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    assert torch.equal(y[kept], torch.full_like(y[kept], 1.0 / 0.7))
    assert torch.equal(impl.forward({}, x, {}, train=False)[0], x)
    with pytest.raises(ValueError, match="no generator"):
        impl.forward({}, x, {}, train=True, rng=None)


@pytest.mark.parametrize("cls_name,item", [
    ("AutoEncoder", "A10.3"), ("RBM", "A10.3"),
])
def test_unported_layers_raise_with_their_item(cls_name, item):
    """The pretrain layers of ROADMAP A10.3 are ported: each builds, counts
    its pretrain params (W, b or hb, vb) and runs forward
    (``tests/test_torch_pretrain.py`` holds them against the reference)."""
    impl = get_layer_impl(getattr(L, cls_name)(n_in=4, n_out=3))
    assert impl.num_params() == 4 * 3 + 3 + 4
    params = impl.init_params(torch.Generator().manual_seed(0))
    y, _ = impl.forward(params, torch.ones(2, 4), {})
    assert y.shape == (2, 3) and torch.isfinite(y).all()
