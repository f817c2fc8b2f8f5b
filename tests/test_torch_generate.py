"""Port parity for the inference extras: ``multi_head_attention``,
``make_generate``, beam search (``make_generate_beam``,
``generate_beam``), the per-signature decoder cache and
``zoo.transformer_lm``, against the JAX package on the same weights.

The load-bearing claims:

1. ``make_generate``'s greedy decoder is token-identical to the port's
   ``generate`` and to the JAX package's decoder (``attn_impl="flash"``:
   the Pallas kernel in interpret mode on the JAX side, the kernel's
   plain version on the port's CPU tensors).
2. Beam search is deterministic, so it is token-identical to the
   reference at beam 1, 2 and 4, with scores at float32 rtol 1e-5; beam
   1 is greedy ``generate``; and when every candidate ties (a zeroed
   unembedding), the port ranks them as ``lax.top_k`` does.
3. The decoder cache holds at most ``GEN_CACHE_MAX`` signatures, least
   recently used out first, and the builders raise on the reference's
   argument errors.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.models.transformer import TransformerLM as JaxLM
from deeplearning4j_tpu.ops.attention import (
    multi_head_attention as jax_mha)
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.models.convert import params_from_jax
from deeplearning4j_tpu_torch.models.transformer import (
    TransformerLM, top_k_first_index)
from deeplearning4j_tpu_torch.ops.attention import multi_head_attention

CFG = dict(vocab_size=64, d_model=128, num_heads=2, num_layers=2,
           max_len=64, seed=0, attn_impl="flash")
_MODELS = {}


def _pair(**kw):
    """(JAX model, port model on the JAX weights), cached per config."""
    key = tuple(sorted(kw.items()))
    if key not in _MODELS:
        ref = JaxLM(**{**CFG, **kw}).init()
        port = TransformerLM(**{**CFG, **kw}, device="cpu")
        port.params = params_from_jax(
            jax.tree_util.tree_map(np.asarray, ref.params))
        _MODELS[key] = (ref, port)
    return _MODELS[key]


def _prompts(b=2, t=7, seed=3):
    return np.random.default_rng(seed).integers(1, 64, (b, t)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# multi_head_attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal,masked", [(False, False), (True, False),
                                           (False, True)])
def test_multi_head_attention_matches_jax(causal, masked):
    rng = np.random.default_rng(0)
    b, t, f, h = 2, 9, 24, 3
    x = rng.standard_normal((b, t, f)).astype(np.float32)
    ws = [rng.standard_normal((f, f)).astype(np.float32) * 0.3
          for _ in range(4)]
    mask = None
    if masked:
        mask = np.ones((b, t), bool)
        mask[1, 6:] = False
    want = np.asarray(jax_mha(
        jnp.asarray(x), *map(jnp.asarray, ws), num_heads=h, causal=causal,
        mask=None if mask is None else jnp.asarray(mask)))
    got = multi_head_attention(
        torch.from_numpy(x), *map(torch.from_numpy, ws), num_heads=h,
        causal=causal, mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# make_generate
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [{}, {"pos_encoding": "rope",
                                     "num_kv_heads": 1}],
                         ids=["learned", "rope-mqa"])
def test_make_generate_greedy_matches_generate_and_jax(kw):
    ref, lm = _pair(**kw)
    prompt = _prompts()
    want = np.asarray(ref.make_generate(7, 9)(
        ref.params, jnp.asarray(prompt), jax.random.PRNGKey(0)))
    got = lm.make_generate(7, 9)(lm.params, prompt).numpy()
    assert got.shape == (2, 16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(lm.generate(prompt, 9).numpy(), got)


def test_make_generate_sampled_equals_seeded_generate():
    _, lm = _pair()
    prompt = _prompts()
    gen = lm.make_generate(7, 6, temperature=0.8, top_k=10)
    a = gen(lm.params, prompt, torch.Generator().manual_seed(4)).numpy()
    b = lm.generate(prompt, 6, temperature=0.8, top_k=10, seed=4).numpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a[:, :7], prompt)
    assert ((a >= 0) & (a < 64)).all()


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("beam", [1, 2, 4])
def test_generate_beam_matches_jax(beam):
    ref, lm = _pair()
    prompt = _prompts()
    want_s, want_sc = ref.generate_beam(prompt, 8, beam_size=beam)
    got_s, got_sc = lm.generate_beam(prompt, 8, beam_size=beam)
    assert tuple(got_s.shape) == (2, beam, 15)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_allclose(got_sc.numpy(), np.asarray(want_sc),
                               rtol=1e-5)
    # best beam first
    assert (np.diff(got_sc.numpy(), axis=1) <= 0).all()


def test_beam_one_is_greedy_generate():
    _, lm = _pair(pos_encoding="rope", num_kv_heads=1, attn_window=5)
    prompt = _prompts(t=9)
    seqs, _ = lm.generate_beam(prompt, 7, beam_size=1)
    np.testing.assert_array_equal(seqs[:, 0].numpy(),
                                  lm.generate(prompt, 7).numpy())


def test_beam_ties_rank_as_lax_top_k():
    """A zeroed unembedding gives every candidate the same log-prob; the
    reference's ``lax.top_k`` then ranks the lower index first, and so
    must the port."""
    ref, lm = _pair()
    ref_z = JaxLM(**CFG).init()
    ref_z.params = dict(ref.params, embed=jnp.zeros_like(ref.params["embed"]))
    lm_z = TransformerLM(**CFG, device="cpu")
    lm_z.params = dict(lm.params, embed=torch.zeros_like(lm.params["embed"]))
    prompt = _prompts()
    want_s, want_sc = ref_z.generate_beam(prompt, 5, beam_size=4)
    got_s, got_sc = lm_z.generate_beam(prompt, 5, beam_size=4)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_allclose(got_sc.numpy(), np.asarray(want_sc),
                               rtol=1e-5)
    # every candidate tied: each step every beam descends from beam 0,
    # beam j appending token j, so beam j ends [0, 0, 0, 0, j]
    want_new = np.zeros((4, 5), np.int64)
    want_new[:, -1] = np.arange(4)
    np.testing.assert_array_equal(got_s[0, :, 7:].numpy(), want_new)


def test_top_k_first_index_matches_lax_top_k_on_ties():
    x = np.array([[0.5, 1.0, 1.0, 0.5, 1.0, -2.0],
                  [3.0, 3.0, 3.0, 3.0, 3.0, 3.0]], np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(x), 4)
    gv, gi = top_k_first_index(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


# ---------------------------------------------------------------------------
# the decoder cache and the argument errors
# ---------------------------------------------------------------------------
def test_decoder_cache_is_lru_bounded():
    lm = TransformerLM(vocab_size=16, d_model=16, num_heads=2, num_layers=1,
                       max_len=64, seed=0, device="cpu").init()
    assert lm.GEN_CACHE_MAX == 16
    prompt = np.ones((1, 2), np.int32)
    for n in range(1, 18):
        lm.generate(prompt, n)
    sigs = list(lm._gen_cache)
    assert len(sigs) == 16
    assert ((1, 2), 1, 0.0, None) not in sigs     # the oldest went out
    # a hit moves its signature to the back, so the next miss evicts the
    # one after it
    lm.generate(prompt, 2)
    lm.generate_beam(prompt, 3, beam_size=2)
    assert ((1, 2), 2, 0.0, None) in lm._gen_cache
    assert ((1, 2), 3, 0.0, None) not in lm._gen_cache
    assert next(reversed(lm._gen_cache)) == ("beam", (1, 2), 3, 2)


def test_argument_errors():
    _, lm = _pair()
    with pytest.raises(ValueError, match="prompt_len"):
        lm.make_generate(0, 4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        lm.make_generate(4, 0)
    with pytest.raises(ValueError, match="learned position table"):
        lm.make_generate(40, 30)
    with pytest.raises(ValueError, match="top_k"):
        lm.make_generate(4, 4, temperature=1.0, top_k=65)
    with pytest.raises(ValueError, match="temperature"):
        lm.make_generate(4, 4, temperature=-1.0)
    with pytest.raises(ValueError, match="beam_size"):
        lm.make_generate_beam(4, 4, 0)
    with pytest.raises(ValueError, match="beam_size"):
        lm.make_generate_beam(4, 4, 65)
    with pytest.raises(ValueError, match="max_len"):
        lm.generate_beam(_prompts(t=60), 10)
    with pytest.raises(ValueError, match=r"prompt must be \[b, 4\]"):
        lm.make_generate(4, 2)(lm.params, _prompts(t=5))


def test_zoo_transformer_lm_matches_jax_config():
    got = zoo.transformer_lm(vocab_size=96, num_layers=2, device="cpu")
    want = jax_zoo.transformer_lm(vocab_size=96, num_layers=2)
    assert got.get_config() == want.get_config()
    assert zoo.transformer_lm(device="cpu").get_config() == \
        jax_zoo.transformer_lm().get_config()
