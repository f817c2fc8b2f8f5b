"""Port parity for the transformer LM: ``deeplearning4j_tpu_torch.models``
against ``deeplearning4j_tpu.models.transformer`` on the same weights.

The JAX model is initialised from its seed; its params go through
``params_from_jax`` into the port, so both packages run the same numbers.
Sizes are small (d128, two heads of 64, two layers, vocab 64). The JAX
flash path runs the Pallas kernel in interpret mode (its own CPU default);
the port's runs the kernel's plain version on CPU tensors. Tolerances:
logits 1e-4 in float32 (the two differ in summation order only); greedy
token streams are held identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu import dtypes as jax_dtypes
from deeplearning4j_tpu.models import transformer as jax_tm
from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch.models import transformer as tm
from deeplearning4j_tpu_torch.models.convert import params_from_jax

CFG = dict(vocab_size=64, d_model=128, num_heads=2, num_layers=2,
           max_len=64, seed=0)


def _pair(**kw):
    cfg = {**CFG, **kw}
    ref = jax_tm.TransformerLM(**cfg).init()
    port = tm.TransformerLM(**cfg, device="cpu")
    port.params = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                         ref.params))
    return ref, port


def _tokens(b, t, seed=0, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


@pytest.mark.parametrize("name", ["float32", "f32", "mixed_bfloat16", "bf16",
                                  "mixed_bf16", "float64", "f64"])
def test_dtype_policies_match_reference(name):
    ref, port = jax_dtypes.policy_from_name(name), dtypes.policy_from_name(
        name.upper())
    for field in ("param_dtype", "compute_dtype", "output_dtype"):
        assert str(getattr(port, field)).replace("torch.", "") == \
            jnp.dtype(getattr(ref, field)).name
    assert port.master_weights == ref.master_weights
    tree = {"w": torch.ones(2, 3), "b": [torch.zeros(3)]}
    copy = port.compute_copy(tree)
    assert copy["w"].dtype == (port.compute_dtype if port.master_weights
                               else torch.float32)
    grads = port.master_grads(copy)
    assert grads["b"][0].dtype == (port.param_dtype if port.master_weights
                                   else torch.float32)
    zeros = port.grad_zeros(tree)
    assert zeros["w"].dtype == port.param_dtype and not zeros["w"].any()
    assert port.cast_output(torch.ones(1, dtype=torch.bfloat16)).dtype == \
        port.output_dtype
    with pytest.raises(ValueError, match="unknown dtype policy"):
        dtypes.policy_from_name("fp8")


def test_params_from_jax_keeps_leaf_names_dtypes_and_layouts():
    ref, port = _pair(dtype_policy="mixed_bf16")
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref.params)
    assert len(ref_leaves) == len(
        jax.tree_util.tree_leaves(port.params))
    blk = port.params["blocks"][0]
    assert blk["attn"]["wq"].shape == (128, 128)
    assert blk["mlp"]["w1"].shape == (128, 512)
    assert port.params["embed"].dtype == torch.float32
    np.testing.assert_array_equal(port.params["pos"].numpy(),
                                  np.asarray(ref.params["pos"]))
    # a bf16 leaf crosses bit for bit
    x = jnp.asarray(np.random.default_rng(0).normal(size=(3, 5)),
                    jnp.bfloat16)
    t = params_from_jax({"w": np.asarray(x)})["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(x.astype(jnp.float32)))


def test_rope_and_layernorm_match_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    for pos in (np.arange(5), np.array([[3], [9]])):
        xs = x if pos.ndim == 1 else x[:, :1]
        a = np.asarray(jax_tm._rope(jnp.asarray(xs), jnp.asarray(pos)))
        b = tm._rope(torch.from_numpy(xs), torch.from_numpy(pos)).numpy()
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
    h = rng.normal(size=(2, 5, 16)).astype(np.float32)
    g = rng.normal(size=16).astype(np.float32)
    bb = rng.normal(size=16).astype(np.float32)
    a = np.asarray(jax_tm._layernorm(*(jnp.asarray(v) for v in (h, g, bb))))
    b = tm._layernorm(*(torch.from_numpy(v) for v in (h, g, bb))).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
    hb = torch.from_numpy(h).to(torch.bfloat16)
    assert tm._layernorm(hb, torch.from_numpy(g),
                         torch.from_numpy(bb)).dtype == torch.bfloat16


@pytest.mark.parametrize("attn_impl", ["flash", "xla"])
@pytest.mark.parametrize("variant", [
    {}, {"pos_encoding": "rope"}, {"num_kv_heads": 1, "attn_window": 12}],
    ids=["learned", "rope", "gqa-window"])
def test_forward_logits_match(attn_impl, variant):
    ref, port = _pair(attn_impl=attn_impl, **variant)
    tok = _tokens(2, 40, seed=2)
    a = np.asarray(ref.forward(ref.params, jnp.asarray(tok)))
    b = port.forward(port.params, tok)
    assert b.shape == (2, 40, 64) and b.dtype == torch.float32
    np.testing.assert_allclose(b.numpy(), a, rtol=1e-4, atol=1e-4)


def test_forward_mixed_bf16_close_to_reference():
    """bf16 compute rounds at the same places in both packages; the
    remaining gap is bf16 rounding of differently ordered f32 sums."""
    ref, port = _pair(attn_impl="flash", dtype_policy="mixed_bf16")
    tok = _tokens(1, 33, seed=3)
    a = np.asarray(ref.forward(ref.params, jnp.asarray(tok)))
    b = port.forward(port.params, tok).numpy()
    assert np.isfinite(b).all()
    np.testing.assert_allclose(b, a, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("attn_impl", ["flash", "xla"])
def test_generate_greedy_token_identical(attn_impl):
    ref, port = _pair(attn_impl=attn_impl)
    prompt = _tokens(2, 13, seed=4)
    a = np.asarray(ref.generate(prompt, 10))
    b = port.generate(prompt, 10)
    assert b.shape == (2, 23)
    np.testing.assert_array_equal(b.numpy(), a)


def test_generate_sampled_is_seeded():
    _, port = _pair()
    prompt = _tokens(1, 7, seed=5)
    s1 = port.generate(prompt, 12, temperature=0.9, top_k=8, seed=3)
    s2 = port.generate(prompt, 12, temperature=0.9, top_k=8, seed=3)
    s3 = port.generate(prompt, 12, temperature=0.9, top_k=8, seed=4)
    assert torch.equal(s1, s2)
    assert not torch.equal(s1, s3)
    assert int(s1.max()) < 64 and torch.equal(s1[:, :7],
                                              torch.from_numpy(prompt).long())


def test_generate_argument_checks():
    _, port = _pair()
    with pytest.raises(ValueError, match="max_len"):
        port.generate(_tokens(1, 60), 10)
    with pytest.raises(ValueError):
        port.generate(_tokens(1, 4), 2, top_k=0)
    with pytest.raises(ValueError):
        port.generate(_tokens(1, 4), 2, temperature=-1.0)


def test_init_is_seeded_and_config_round_trips():
    a = tm.TransformerLM(**CFG, device="cpu").init()
    b = tm.TransformerLM(**a.get_config(), device="cpu").init()
    assert a.get_config() == jax_tm.TransformerLM(**CFG).get_config()
    for x, y in zip(jax.tree_util.tree_leaves(a.params),
                    jax.tree_util.tree_leaves(b.params)):
        assert torch.equal(x, y)
    c = tm.TransformerLM(**{**CFG, "seed": 1}, device="cpu").init()
    assert not torch.equal(a.params["embed"], c.params["embed"])


def test_attn_impl_resolution(monkeypatch):
    lm = tm.TransformerLM(**CFG, device="cpu")
    assert lm._attn_impl(4096) == "xla"          # auto on a CPU device
    monkeypatch.setenv("DL4J_ATTN_IMPL", "flash")
    assert lm._attn_impl(8) == "flash"
    monkeypatch.setenv("DL4J_ATTN_IMPL", "bogus")
    with pytest.raises(ValueError):
        lm._attn_impl(8)
    monkeypatch.delenv("DL4J_ATTN_IMPL")
    assert tm.TransformerLM(**CFG, attn_impl="flash",
                            device="cpu")._attn_impl(8) == "flash"
