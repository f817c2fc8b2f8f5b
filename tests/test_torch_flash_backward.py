"""Port parity for the flash-attention backward (B2 dk/dv, B3 dq) and the
differentiable ``flash_attention``.

The JAX side runs ``flash_backward_pallas`` in interpret mode, as
``tests/test_pallas.py`` does, and its XLA-scan ``flash_backward`` with
``precise=True`` as the f32 oracle. The port side runs the plain versions
(``flash_attention_bwd_reference``, ``flash_backward``) and the wrapper on
CPU tensors, which takes the plain version (the CUDA kernels are checked
against it on the card by ``chip_smoke.py``). Tolerances:

- f32: 1e-4 on dq, dk, dv, the reference's gate for its kernels against
  its scan (``tests/test_pallas.py``).
- bf16 against the Pallas kernels in bf16: 1e-3. Both round p and ds to
  bf16 at the same places; an f32 sum taken in another order can put one
  of them on the other side of a rounding tie, which moves a gradient by
  one bf16 ulp of p or ds times one input element (measured below 1e-4).
- bf16 against the f32 oracle: 2e-2, for the bf16 rounding of the inputs
  (2^-9 relative) carried into gradients of magnitude up to ~5.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu_torch.kernels import flash_attention as fa

jfa = importlib.import_module("deeplearning4j_tpu.pallas.flash_attention")

CASES = [
    # label, b, tq, tkv, h, d, causal, window, jax blocks
    ("causal", 1, 64, 64, 2, 64, True, None, 512),
    ("non-causal", 2, 24, 40, 2, 64, False, None, 512),
    ("ragged multi-block", 1, 300, 300, 2, 64, True, None, 128),
    ("windowed", 1, 300, 300, 1, 64, True, 50, 128),
    ("head_dim 128", 1, 37, 37, 2, 128, True, None, 512),
    ("cross-attention lengths", 1, 64, 160, 2, 64, False, None, 128),
    # where a 16-row MMA tile or a 64-key tile of the card's kernels has
    # a ragged or masked edge (chip_smoke.py holds the kernels against
    # the plain versions at these shapes)
    ("causal P=17", 1, 17, 17, 2, 64, True, None, 512),
    ("causal P=63", 1, 63, 63, 2, 64, True, None, 512),
    ("non-causal tq=5 tkv=130", 1, 5, 130, 2, 64, False, None, 128),
    ("windowed w=1", 1, 300, 300, 1, 64, True, 1, 128),
    ("windowed w=65", 1, 300, 300, 1, 64, True, 65, 128),
]
IDS = [c[0] for c in CASES]
# the bf16 test's cases: multi-block, windowed, cross lengths and the
# tile edges
BF16 = [2, 3, 5, 6, 7, 8, 9, 10]


def _inputs(b, tq, tkv, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, tq, h, d)).astype(np.float32),
            rng.normal(size=(b, tkv, h, d)).astype(np.float32),
            rng.normal(size=(b, tkv, h, d)).astype(np.float32),
            rng.normal(size=(b, tq, h, d)).astype(np.float32))


def _both(case, dtype, seed=0):
    """The same inputs in both packages, with out and lse from the JAX
    forward kernel: ``(jax args, torch args)`` as (q, k, v, out, lse, do)."""
    _, b, tq, tkv, h, d, causal, window, block = case
    q, k, v, do = (jnp.asarray(x, dtype)
                   for x in _inputs(b, tq, tkv, h, d, seed))
    out, lse = jfa.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       block_q=block, block_k=block,
                                       interpret=True)

    def conv(x):
        return torch.from_numpy(np.array(x.astype(jnp.float32))).to(
            torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32)

    jargs = (q, k, v, out, lse, do)
    return jargs, tuple(conv(x) for x in jargs)


def _close(got, want, tol):
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_f32_reference_matches_pallas_kernels(case):
    _, _, _, _, _, _, causal, window, block = case
    jargs, targs = _both(case, jnp.float32)
    want = jfa.flash_backward_pallas(*jargs, causal=causal, window=window,
                                     block_q=block, block_k=block,
                                     interpret=True)
    got = fa.flash_attention_bwd_reference(*targs, causal=causal,
                                           window=window)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_f32_reference_matches_precise_scan(case):
    causal, window = case[6], case[7]
    jargs, targs = _both(case, jnp.float32, seed=1)
    want = jfa.flash_backward(*jargs, causal=causal, window=window,
                              precise=True)
    got = fa.flash_attention_bwd_reference(*targs, causal=causal,
                                           window=window)
    _close(got, want, 1e-4)
    # the wrapper on CPU tensors is the plain version, bit for bit
    before = (fa.flash_attention_bwd_dkdv.launches,
              fa.flash_attention_bwd_dq.launches)
    wrapped = fa.flash_attention_bwd(*targs, causal=causal, window=window)
    assert all(torch.equal(a, b) for a, b in zip(wrapped, got))
    assert (fa.flash_attention_bwd_dkdv.launches,
            fa.flash_attention_bwd_dq.launches) == before


@pytest.mark.parametrize("case", [CASES[i] for i in BF16],
                         ids=[IDS[i] for i in BF16])
def test_bf16_reference_matches_pallas_bf16_and_f32_oracle(case):
    causal, window, block = case[6], case[7], case[8]
    jargs, targs = _both(case, jnp.bfloat16, seed=2)
    assert targs[0].dtype == torch.bfloat16
    got = fa.flash_attention_bwd_reference(*targs, causal=causal,
                                           window=window)
    pallas = jfa.flash_backward_pallas(*jargs, causal=causal, window=window,
                                       block_q=block, block_k=block,
                                       interpret=True)
    _close(got, pallas, 1e-3)
    oracle = jfa.flash_backward(*jargs, causal=causal, window=window,
                                precise=True)
    _close(got, oracle, 2e-2)
    # the chunked plain backward rounds where the tiles round too
    chunked = fa.flash_backward(*targs, causal=causal, window=window,
                                block_k=64)
    _close(chunked, [g.numpy() for g in got], 1e-5)


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("window", [None, 20])
def test_flash_backward_with_offsets_matches_jax(window, precise):
    """q at positions 64..95 against keys 0..95 (a later ring hop's
    geometry): lse is that of the full attention over these keys."""
    rng = np.random.default_rng(3)
    q, k, v, do = (rng.normal(size=s).astype(np.float32) for s in
                   ((2, 32, 2, 64), (2, 96, 2, 64), (2, 96, 2, 64),
                    (2, 32, 2, 64)))
    qi = 64 + np.arange(32)[:, None]
    ki = np.arange(96)[None, :]
    keep = qi >= ki
    if window is not None:
        keep &= qi - ki < window
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / 8.0
    s = np.where(keep, s, -np.inf)
    lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    p = np.exp(s - lse[..., None])
    out = np.einsum("bhqk,bkhd->bqhd", p, v).astype(np.float32)
    lse = lse.astype(np.float32)
    kw = dict(causal=True, window=window, q_offset=64, k_offset=0,
              precise=precise)
    want = jfa.flash_backward(*(jnp.asarray(x) for x in
                                (q, k, v, out, lse, do)), block_k=128, **kw)
    got = fa.flash_backward(*(torch.from_numpy(x) for x in
                              (q, k, v, out, lse, do)), block_k=40, **kw)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (True, 24)],
                         ids=["non-causal", "causal", "windowed"])
def test_autograd_matches_jax_grad(causal, window):
    q, k, v = _inputs(2, 128, 128, 4, 64, seed=4)[:3]

    def jax_loss(q, k, v):
        return jnp.sum(jfa.flash_attention(
            q, k, v, causal=causal, window=window, block_q=64, block_k=64,
            interpret=True) ** 2)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (fa.flash_attention(tq, tk, tv, causal=causal, window=window)
     ** 2).sum().backward()
    _close([tq.grad, tk.grad, tv.grad], want, 1e-4)


def test_autograd_bf16_grads_take_the_input_dtype():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
               for x in _inputs(1, 40, 40, 2, 64, seed=5)[:3])
    out = fa.flash_attention(q, k, v, causal=True)
    assert out.dtype == torch.bfloat16 and out.grad_fn is not None
    do = torch.ones_like(out)
    out.backward(do)
    with torch.no_grad():
        ref_out, lse = fa.flash_attention_fwd_reference(q, k, v, causal=True)
        want = fa.flash_attention_bwd_reference(q, k, v, ref_out, lse, do,
                                                causal=True)
    for x, w in zip((q, k, v), want):
        assert x.grad.dtype == torch.bfloat16
        assert torch.equal(x.grad, w.to(torch.bfloat16))


def test_wrappers_raise_off_the_cpu_instead_of_falling_back():
    x = torch.zeros(1, 8, 1, 64, device="meta")
    lse = torch.zeros(1, 1, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd(x, x, x, x, lse, x, causal=True)
    for wrapper in (fa.flash_attention_bwd_dkdv, fa.flash_attention_bwd_dq):
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(x, x, x, x, lse, lse, causal=True)
    c = torch.zeros(1, 8, 1, 64)
    with pytest.raises(ValueError):       # causal needs tq == tkv
        fa.flash_attention_bwd(c, c[:, :6], c[:, :6], c,
                               torch.zeros(1, 1, 8), c, causal=True)


def test_bwd_bound_counts_each_kernels_work():
    b = fa.flash_bwd_bound(16, 1024, 1024, 8, 64, torch.bfloat16,
                           causal=True)
    elems = 16 * 1024 * 8 * 64
    pairs = 16 * 8 * 64 * (1024 * 1025 // 2)
    reads = 2 * 4 * elems + 2 * 4 * 16 * 8 * 1024
    assert b["dkdv"]["bytes"] == reads + 2 * 4 * elems == 135_266_304
    assert b["dq"]["bytes"] == reads + 4 * elems == 101_711_872
    assert b["dkdv"]["flops"] == 8 * pairs
    assert b["dq"]["flops"] == 6 * pairs
    for name in ("dkdv", "dq"):
        assert b[name]["bound_by"] == "bytes"
        assert b[name]["bound_ms"] == pytest.approx(
            b[name]["bytes"] / 3.35e12 * 1e3)
    assert b["dkdv"]["bound_ms"] == pytest.approx(0.0404, abs=1e-4)
    assert b["dq"]["bound_ms"] == pytest.approx(0.0304, abs=1e-4)
    w = fa.flash_bwd_bound(1, 1000, 1000, 8, 64, torch.float32,
                           causal=True, window=128)
    vis = fa.visible_keys(1000, 1000, causal=True, window=128)
    assert w["dq"]["flops"] == 6 * 8 * 64 * vis
    assert w["dkdv"]["bound_by"] == "operations"
