"""Port parity for the transformer's training half: ``loss``, the
hand-written Adam step and ``evaluate_perplexity`` against
``deeplearning4j_tpu.models.transformer`` from the same state.

The JAX model is initialised from its seed; its params AND its Adam
moments go through ``params_from_jax``, so both packages start a step from
the same state. Sizes are small (vocab 64, d128, two heads of 64, two
layers, batch 2, 40 tokens). The JAX flash path runs the Pallas kernels in
interpret mode; the port's flash path runs the kernels' plain versions on
CPU tensors. Tolerances, after three ``fit_batch`` steps:

- float32: losses 1e-5 and params 1e-4 absolute, Adam moments 1e-4
  relative to each leaf's largest entry (measured: 1e-6, 1e-5 and 5e-6;
  the two differ in summation order only);
- ``mixed_bf16``: losses 2e-2 and params 1e-2, the reference's own gates
  for bf16 training (``tests/test_mixed_precision.py``).

Port-internal equalities (fused multi-step against per-step, remat and
scan_layers against the plain loop) are held bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import transformer as jax_tm
from deeplearning4j_tpu_torch.models import transformer as tm
from deeplearning4j_tpu_torch.models.convert import params_from_jax

CFG = dict(vocab_size=64, d_model=128, num_heads=2, num_layers=2,
           max_len=64, seed=0)
STEPS = 3


def _pair(**kw):
    cfg = {**CFG, **kw}
    ref = jax_tm.TransformerLM(**cfg).init()
    port = tm.TransformerLM(**cfg, device="cpu")
    port.params = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                         ref.params))
    port.opt_state = params_from_jax(jax.tree_util.tree_map(
        np.asarray, ref.opt_state))
    return ref, port


def _tokens(b=2, t=40, seed=0):
    return np.random.default_rng(seed).integers(0, 64, (b, t)).astype(
        np.int32)


def _leaves(tree):
    return [np.asarray(x) if not isinstance(x, torch.Tensor)
            else x.detach().numpy() for x in jax.tree_util.tree_leaves(tree)]


def _train_both(ref, port, tok):
    la = [ref.fit_batch(tok) for _ in range(STEPS)]
    lb = [port.fit_batch(tok) for _ in range(STEPS)]
    return np.array(la), np.array(lb)


@pytest.mark.parametrize("variant", [
    {"attn_impl": "flash"},
    {"attn_impl": "xla"},
    {"attn_impl": "flash", "pos_encoding": "rope"},
    {"attn_impl": "flash", "num_kv_heads": 1, "attn_window": 12},
], ids=["flash", "xla", "rope", "gqa-window"])
def test_float32_steps_match_reference(variant):
    ref, port = _pair(**variant)
    la, lb = _train_both(ref, port, _tokens())
    np.testing.assert_allclose(lb, la, rtol=0, atol=1e-5)
    assert la[-1] < la[0]
    assert port.step_count == ref.step_count == STEPS
    for a, b in zip(_leaves(ref.params), _leaves(port.params)):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4)
    for a, b in zip(_leaves(ref.opt_state), _leaves(port.opt_state)):
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-4 * np.abs(a).max() + 1e-30)


def test_mixed_bf16_steps_match_reference():
    ref, port = _pair(attn_impl="flash", dtype_policy="mixed_bf16")
    la, lb = _train_both(ref, port, _tokens(seed=1))
    assert np.abs(la - lb).max() <= 2e-2
    for a, b in zip(_leaves(ref.params), _leaves(port.params)):
        assert np.abs(a - b).max() <= 1e-2
    # masters and moments stay f32; the masters never require grad
    for x in jax.tree_util.tree_leaves((port.params, port.opt_state)):
        assert x.dtype == torch.float32 and not x.requires_grad


def test_mixed_bf16_training_unembedding_matches_reference():
    """The training path's unembedding is the reference's ``_unembed``:
    layernorm, bf16 operands, products summed in f32, f32 logits. On the
    same bf16 hidden state both sides multiply the same operands exactly
    and sum in f32 in another order, so the logits agree to a few f32
    ulps of their largest magnitude (measured: 4; gate 8). Through the
    blocks, the training-path logits hold the bf16 forward gate of
    ``test_torch_transformer.py``."""
    ref, port = _pair(attn_impl="xla", dtype_policy="mixed_bf16")
    h = np.random.default_rng(6).normal(size=(2, 40, 128)).astype(
        np.float32)
    want = np.asarray(ref._unembed(ref.params,
                                   jnp.asarray(h, jnp.bfloat16)))
    got = port._unembed_train(port.params,
                              torch.from_numpy(h).to(torch.bfloat16))
    assert got.dtype == torch.float32 and got.shape == want.shape
    ulp = np.spacing(np.float32(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=8 * ulp)

    tok = _tokens(seed=6)
    with torch.no_grad():
        logits = port._logits(port.params, tok, train=True)
    want = np.asarray(ref.forward(ref.params, jnp.asarray(tok), train=True))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), want, rtol=5e-2, atol=5e-2)


def test_decode_unembedding_keeps_f64_sums_and_batch_invariance():
    """``_unembed`` (decode, prefill, ``forward``) still sums in f64 and
    rounds once: a row's logits are bitwise the same alone and inside a
    batch of 8."""
    _, port = _pair(dtype_policy="mixed_bf16")
    h = torch.from_numpy(np.random.default_rng(7).normal(
        size=(8, 128)).astype(np.float32)).to(torch.bfloat16)
    batch = port._unembed(port.params, h)
    for i in range(8):
        assert torch.equal(port._unembed(port.params, h[i:i + 1]),
                           batch[i:i + 1])
    ln = port.params["ln_f"]
    hf = tm._layernorm(h, ln["g"], ln["b"])
    e = port.params["embed"].to(torch.bfloat16)
    assert torch.equal(batch, (hf.double() @ e.double().T).float())


def test_params_from_jax_carries_the_adam_state():
    ref, port = _pair()
    ref.fit_batch(_tokens())
    state = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                   ref.opt_state))
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda x: 0, state)) == \
        jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda x: 0, ref.opt_state))
    for a, b in zip(_leaves(ref.opt_state), _leaves(state)):
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(b, a)
    # a fresh port model builds the same layout of f32 zeros
    fresh = tm.TransformerLM(**CFG, device="cpu").init()
    assert fresh.step_count == 0
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda x: 0, fresh.opt_state)) == \
        jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda x: 0, ref.opt_state))
    assert all(not x.any() and x.dtype == torch.float32
               for x in jax.tree_util.tree_leaves(fresh.opt_state))


def _clone(lm, **kw):
    """A port model with ``lm``'s config (plus ``kw``) and a copy of its
    params and Adam state."""
    other = tm.TransformerLM(**{**lm.get_config(), **kw}, device="cpu")
    other.params = jax.tree_util.tree_map(torch.clone, lm.params)
    other.opt_state = jax.tree_util.tree_map(torch.clone, lm.opt_state)
    return other


def _assert_same_state(a, b):
    for x, y in zip(jax.tree_util.tree_leaves((a.params, a.opt_state)),
                    jax.tree_util.tree_leaves((b.params, b.opt_state))):
        assert torch.equal(x, y)


@pytest.mark.parametrize("policy", ["float32", "mixed_bf16"])
def test_multi_train_step_equals_fit_batch_bitwise(policy):
    _, a = _pair(attn_impl="flash", dtype_policy=policy)
    b = _clone(a)
    tok = _tokens(seed=2)
    losses = [a.fit_batch(tok) for _ in range(STEPS)]
    multi = b.make_multi_train_step(STEPS)
    last = b.fit_batch_multi(tok, multi_step=multi, k=STEPS)
    assert last == losses[-1] and b.step_count == a.step_count == STEPS
    _assert_same_state(a, b)


@pytest.mark.parametrize("option", ["remat", "scan_layers"])
def test_remat_and_scan_layers_equal_the_plain_loop(option):
    _, a = _pair(attn_impl="flash", dtype_policy="mixed_bf16")
    b = _clone(a, **{option: True})
    tok = _tokens(seed=3)
    for _ in range(2):
        assert a.fit_batch(tok) == b.fit_batch(tok)
    _assert_same_state(a, b)


@pytest.mark.parametrize("attn_impl", ["flash", "xla"])
def test_evaluate_perplexity_matches_reference(attn_impl):
    ref, port = _pair(attn_impl=attn_impl)
    tok = _tokens(b=3, t=33, seed=4)
    a, b = ref.evaluate_perplexity(tok), port.evaluate_perplexity(tok)
    assert b == pytest.approx(a, rel=1e-5)
    assert b == pytest.approx(float(torch.exp(port.loss(port.params, tok))),
                              rel=1e-6)


def test_training_keeps_the_serve_path_graph_free():
    _, port = _pair(attn_impl="flash")
    port.fit_batch(_tokens())
    assert not any(x.requires_grad
                   for x in jax.tree_util.tree_leaves(port.params))
    logits = port.forward(port.params, _tokens(b=1, t=8))
    assert logits.grad_fn is None
    loss = port.fit_batch(_tokens(), block=False)
    assert isinstance(loss, torch.Tensor) and loss.grad_fn is None


def test_train_attention_and_unported_options():
    lm = tm.TransformerLM(**CFG, device="cpu")
    assert lm._attn_impl(40, train=True) == "xla"     # auto on the CPU
    lm.device = torch.device("cuda")                   # resolution only
    assert lm._attn_impl(1024, train=True) == "flash"
    assert lm._attn_impl(1024) == "xla"
    _, port = _pair()
    # sequence parallelism without a mesh is the meshless (captured)
    # step, as in the reference; tensor-parallel placement over a mesh
    # of one device places nothing and keeps the captured step
    assert port.make_train_step(sequence_parallel=True).captured

    class OneDevice:
        mesh_dim_names, shape = ("data",), (1,)

    before = [p.clone() for p in jax.tree_util.tree_leaves(port.params)]
    port.shard_params(OneDevice())
    assert port._tp is None
    assert all(torch.equal(a, b) for a, b in zip(
        before, jax.tree_util.tree_leaves(port.params)))
    assert port.make_train_step(mesh=OneDevice()).captured
    port.shard_params(OneDevice())        # again: still nothing placed
    assert port._tp is None and port.make_train_step().captured


def test_flops_per_token_is_the_reference_benchmarks_count():
    ref, port = _pair()
    n = sum(int(np.prod(p.shape)) for blk in ref.params["blocks"]
            for grp in blk.values() for p in grp.values()) + 128 * 64
    assert port.flops_per_token(40) == int(6 * n + 12 * 2 * 128 * 20)
    w = tm.TransformerLM(**CFG, attn_window=8, device="cpu")
    assert w.flops_per_token(40) == int(
        6 * n + 12 * 2 * 128 * (8 * (40 - 3.5) / 40))
