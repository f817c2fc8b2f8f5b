"""Port parity for the recurrent layers (GravesLSTM, LSTM, the
bidirectional LSTM, GRU, ImageLSTM) against
``deeplearning4j_tpu.nn.layers.recurrent`` on the same seeded numpy
inputs and weights; float64 gradient checks of the port's layers;
ImageLSTM's host beam search; and the zoo's char-LSTM.

Tolerances: float32 forward values and gradients (of ``sum(y * G)`` for a
seeded cotangent ``G``, with respect to the input and every param) at
rtol 1e-4 / atol 1e-6; both packages run the same loop over time, so
only the order of the small GEMMs' sums differs. Beam search: the same
tokens, log-probs within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn.conf import layers as jax_L
from deeplearning4j_tpu.nn.layers import get_layer_impl as jax_layer_impl
from deeplearning4j_tpu_torch.dtypes import FLOAT64, tree_leaves
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.models.convert import params_from_jax
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers import get_layer_impl

B, T, N_IN = 3, 7, 5
# a hole at step 2 of row 1 and ragged tails on rows 1 and 2: the forward
# pass holds its carry over the hole, the reverse pass over the tails
MASK = np.array([[1, 1, 1, 1, 1, 1, 1],
                 [1, 1, 0, 1, 1, 0, 0],
                 [1, 1, 1, 1, 0, 0, 0]], np.float32)

LAYERS = {
    "GravesLSTM": dict(n_in=N_IN, n_out=6),
    "LSTM": dict(n_in=N_IN, n_out=6),
    "GravesBidirectionalLSTM": dict(n_in=N_IN, n_out=4),
    "GRU": dict(n_in=N_IN, n_out=6),
    "ImageLSTM": dict(n_in=N_IN, n_out=4, hidden_size=6),
}


def _close(got, want, rtol=1e-4, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def _random_params(jimpl, rng):
    """The reference layer's param tree, every leaf redrawn N(0, 0.5²) so
    the peepholes and biases are not zero."""
    tree = jimpl.init_params(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        lambda a: (0.5 * rng.standard_normal(a.shape)).astype(np.float32),
        tree)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("cls_name", list(LAYERS))
def test_layer_forward_and_gradients(cls_name, masked):
    kw = LAYERS[cls_name]
    rng = np.random.default_rng(1)
    jimpl = jax_layer_impl(getattr(jax_L, cls_name)(**kw))
    impl = get_layer_impl(getattr(L, cls_name)(**kw))
    params = _random_params(jimpl, rng)
    x = rng.standard_normal((B, T, N_IN)).astype(np.float32)
    mask = MASK if masked else None

    def f(p, v):
        return jimpl.forward(p, v, {}, train=False,
                             mask=None if mask is None else jnp.asarray(mask))[0]

    want = f(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    g = rng.standard_normal(want.shape).astype(np.float32)
    want_gp, want_gx = jax.grad(lambda p, v: jnp.sum(f(p, v) * g),
                                argnums=(0, 1))(params, jnp.asarray(x))

    tp = jax.tree_util.tree_map(
        lambda a: torch.tensor(a, requires_grad=True), params)
    tx = torch.tensor(x, requires_grad=True)
    got, state = impl.forward(tp, tx, {}, train=False,
                              mask=None if mask is None
                              else torch.from_numpy(mask))
    assert state == {}
    (got * torch.from_numpy(g)).sum().backward()
    _close(got.detach(), want)
    _close(tx.grad, want_gx)
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(want_gp),
                    strict=True):
        _close(a.grad, b)
    if masked:  # padded steps emit zeros
        assert torch.all(got.detach()[torch.from_numpy(MASK) == 0] == 0)


@pytest.mark.parametrize("cls_name", ["GravesLSTM", "LSTM", "GRU",
                                      "ImageLSTM"])
def test_stateful_carry_matches(cls_name):
    """With ``h``/``c`` in the state dict a layer starts from them and
    returns the last step's carry, as the reference's does."""
    kw = LAYERS[cls_name]
    rng = np.random.default_rng(2)
    jimpl = jax_layer_impl(getattr(jax_L, cls_name)(**kw))
    impl = get_layer_impl(getattr(L, cls_name)(**kw))
    params = _random_params(jimpl, rng)
    hid = kw.get("hidden_size", kw["n_out"])
    names = ("h",) if cls_name == "GRU" else ("h", "c")
    state = {k: rng.standard_normal((B, hid)).astype(np.float32)
             for k in names}
    x = rng.standard_normal((B, T, N_IN)).astype(np.float32)
    want, want_state = jimpl.forward(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in state.items()}, train=False,
        mask=jnp.asarray(MASK))
    with torch.no_grad():
        got, got_state = impl.forward(
            params_from_jax(params), torch.from_numpy(x),
            {k: torch.from_numpy(v) for k, v in state.items()}, train=False,
            mask=torch.from_numpy(MASK))
    _close(got, want)
    assert set(got_state) == set(want_state) == set(names)
    for k in names:
        _close(got_state[k], want_state[k])


@pytest.mark.parametrize("cls_name", list(LAYERS))
def test_param_shapes_and_init(cls_name):
    """The param tree has the reference's names and shapes; ``num_params``
    counts it without drawing; the LSTM matrices are drawn with the
    reference's fans (``fan_out = n``, not ``4n``)."""
    kw = LAYERS[cls_name]
    jtree = jax_layer_impl(getattr(jax_L, cls_name)(**kw)).init_params(
        jax.random.PRNGKey(0))
    impl = get_layer_impl(getattr(L, cls_name)(**kw))
    tree = impl.init_params(torch.Generator().manual_seed(0))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jtree)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), tree) == shapes
    assert impl.num_params() == sum(
        a.size for a in jax.tree_util.tree_leaves(jtree))
    for k in ("b", "gb"):
        if k in tree:
            np.testing.assert_array_equal(tree[k].numpy(), np.asarray(jtree[k]))


def test_lstm_init_draws_from_the_reference_law():
    """XAVIER with ``fan_in=n_in, fan_out=n``: std sqrt(2 / (n_in + n))."""
    n_in, n = 128, 256
    conf = L.GravesLSTM(n_in=n_in, n_out=n)
    p = get_layer_impl(conf).init_params(torch.Generator().manual_seed(3))
    jp = jax_layer_impl(jax_L.GravesLSTM(n_in=n_in, n_out=n)).init_params(
        jax.random.PRNGKey(3))
    for name, fan_in in (("W", n_in), ("RW", n)):
        want = np.sqrt(2.0 / (fan_in + n))
        assert abs(float(p[name].std()) / want - 1.0) < 0.02
        assert abs(float(np.asarray(jp[name]).std()) / want - 1.0) < 0.02
    assert float(p["b"][n:2 * n].min()) == 1.0  # forget-gate bias


GRADCHECK = {
    "GravesLSTM": (L.GravesLSTM(n_in=4, n_out=3), None),
    "GravesLSTM-mask": (L.GravesLSTM(n_in=4, n_out=3),
                        [[1, 1, 1, 0], [1, 1, 0, 0], [1, 1, 1, 1]]),
    "GravesBidirectionalLSTM": (L.GravesBidirectionalLSTM(n_in=4, n_out=3),
                                [[1, 1, 1, 0], [1, 0, 1, 1], [1, 1, 1, 1]]),
    "GRU": (L.GRU(n_in=4, n_out=3), None),
}


@pytest.mark.parametrize("case", list(GRADCHECK))
def test_gradcheck_float64(case):
    """Finite differences against autograd in float64 over the input and
    every param (tests/test_gradientcheck.py's recurrent cases)."""
    conf, mask = GRADCHECK[case]
    impl = get_layer_impl(conf, FLOAT64)
    gen = torch.Generator().manual_seed(5)
    params = impl.init_params(gen)
    leaves = tree_leaves(params)
    # peepholes and biases start at zero; give every leaf a nonzero value
    leaves = [(0.5 * torch.randn(l.shape, generator=gen, dtype=torch.float64)
               ).requires_grad_() for l in leaves]
    x = torch.randn((3, 4, 4), generator=gen,
                    dtype=torch.float64).requires_grad_()
    m = None if mask is None else torch.tensor(mask, dtype=torch.float64)

    def rebuild(ls):
        it = iter(ls)

        def fill(tree):
            return {k: fill(v) if isinstance(v, dict) else next(it)
                    for k, v in tree.items()}

        return fill(params)

    def f(xx, *ls):
        return impl.forward(rebuild(ls), xx, {}, train=False, mask=m)[0]

    assert torch.autograd.gradcheck(f, (x, *leaves), eps=1e-6, atol=1e-6)


def _image_lstm(rng):
    kw = dict(n_in=6, n_out=5, hidden_size=8)
    jimpl = jax_layer_impl(jax_L.ImageLSTM(**kw))
    impl = get_layer_impl(L.ImageLSTM(**kw))
    params = _random_params(jimpl, rng)
    return jimpl, impl, params


@pytest.mark.parametrize("n_steps,beam_width,end_token",
                         [(4, 2, None), (8, 3, 0), (6, 1, None)],
                         ids=["beam2", "beam3-end", "greedy"])
def test_beam_search_matches(n_steps, beam_width, end_token):
    """The same tokens in the same order, log-probs within 1e-5
    (tests/test_utils_extras.py's beam-search cases)."""
    rng = np.random.default_rng(7)
    jimpl, impl, params = _image_lstm(rng)
    xi = rng.normal(size=(6,)).astype(np.float32)
    ws = rng.normal(size=(5, 6)).astype(np.float32)
    want = jimpl.beam_search(jax.tree_util.tree_map(jnp.asarray, params),
                             xi, ws, n_steps=n_steps, beam_width=beam_width,
                             end_token=end_token)
    got = impl.beam_search(params_from_jax(params), xi, ws, n_steps=n_steps,
                           beam_width=beam_width, end_token=end_token)
    assert [t for t, _ in got] == [t for t, _ in want]
    np.testing.assert_allclose([lp for _, lp in got],
                               [lp for _, lp in want], rtol=0, atol=1e-5)
    scores = [lp for _, lp in got]
    assert scores == sorted(scores, reverse=True)


def test_char_lstm_counts_the_reference_params():
    net = zoo.char_lstm(device="cpu")
    want = jax_zoo.char_lstm().init()
    assert net.num_params() == want.num_params()
    assert net.params == {}  # counting drew no weight
    small = zoo.char_lstm(vocab_size=10, hidden=8, device="cpu").init()
    ref = jax_zoo.char_lstm(vocab_size=10, hidden=8).init()
    assert (set(small.get_param_table()) == set(ref.get_param_table()))
    assert small.conf.to_dict() == ref.conf.to_dict()
