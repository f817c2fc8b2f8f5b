"""Port parity for the flash-attention forward (B1).

The JAX side runs the Pallas kernel in interpret mode, as
``tests/test_pallas.py`` does; the port side runs
``flash_attention_fwd`` on CPU tensors, which takes its plain version
(the CUDA kernel itself is checked against that plain version on the card
by ``chip_smoke.py``). Tolerances: f32 2e-5 on out and lse; bf16 inputs
against the f32 oracle 5e-2.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.pallas.flash_attention import (
    flash_attention_fwd as jax_flash_fwd)
from deeplearning4j_tpu_torch.kernels import flash_attention as fa

CASES = [
    # label, b, tq, tkv, h, d, causal, window, jax blocks
    ("causal", 1, 64, 64, 2, 64, True, None, 512),
    ("non-causal", 2, 24, 40, 2, 64, False, None, 512),
    ("ragged multi-block", 1, 300, 300, 2, 64, True, None, 128),
    ("windowed", 1, 300, 300, 1, 64, True, 50, 128),
    ("head_dim 128", 1, 37, 37, 2, 128, True, None, 512),
]


def _qkv(b, tq, tkv, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, tq, h, d)).astype(np.float32),
            rng.normal(size=(b, tkv, h, d)).astype(np.float32),
            rng.normal(size=(b, tkv, h, d)).astype(np.float32))


def _jax(q, k, v, causal, window, block, dtype=jnp.float32):
    out, lse = jax_flash_fwd(
        *(jnp.asarray(x, dtype) for x in (q, k, v)), causal=causal,
        window=window, block_q=block, block_k=block, interpret=True)
    return np.asarray(out.astype(jnp.float32)), np.asarray(lse)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_f32_matches_pallas_kernel(case):
    _, b, tq, tkv, h, d, causal, window, block = case
    q, k, v = _qkv(b, tq, tkv, h, d)
    ref_out, ref_lse = _jax(q, k, v, causal, window, block)
    out, lse = fa.flash_attention_fwd(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        window=window)
    assert out.shape == (b, tq, h, d) and out.dtype == torch.float32
    assert lse.shape == (b, h, tq) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref_out, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_bf16_against_f32_oracle(case):
    _, b, tq, tkv, h, d, causal, window, block = case
    q, k, v = _qkv(b, tq, tkv, h, d, seed=1)
    ref_out, ref_lse = _jax(q, k, v, causal, window, block)
    out, lse = fa.flash_attention_fwd(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        causal=causal, window=window)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(), ref_out, rtol=5e-2,
                               atol=5e-2)
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=5e-2, atol=5e-2)


def test_bf16_matches_pallas_bf16():
    """Same bf16 inputs through both packages' bf16 paths."""
    q, k, v = _qkv(1, 100, 100, 2, 64, seed=2)
    ref_out, ref_lse = _jax(q, k, v, True, None, 512, jnp.bfloat16)
    out, lse = fa.flash_attention_fwd(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        causal=True)
    np.testing.assert_allclose(out.float().numpy(), ref_out, rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=1e-4, atol=1e-4)


def test_cpu_path_takes_plain_version_and_counts_nothing():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 16, 16, 1, 64))
    before = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, causal=True)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert fa.flash_attention_fwd.launches == before
    assert torch.equal(fa.flash_attention(q, k, v, causal=True), out)


def test_argument_checks():
    q = torch.zeros(1, 8, 1, 64)
    k = torch.zeros(1, 6, 1, 64)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, k, k, causal=True)      # tq != tkv
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, q, q, window=4)         # window w/o causal
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, k[..., :32], k, causal=False)
    # flash_attention is differentiable: a grad flows back to q
    qg = q.clone().requires_grad_()
    fa.flash_attention(qg, q, q, causal=True).sum().backward()
    assert qg.grad is not None and qg.grad.shape == q.shape


def test_bound_counts_visible_keys():
    assert fa.visible_keys(4, 4, causal=False) == 16
    assert fa.visible_keys(4, 4, causal=True) == 10
    assert fa.visible_keys(5, 5, causal=True, window=2) == 1 + 2 * 4
    b = fa.flash_bound(1, 1024, 1024, 8, 64, torch.bfloat16, causal=True)
    assert b["flops"] == 4 * 8 * 64 * (1024 * 1025 // 2)
    assert b["bytes"] == 2 * 4 * 1024 * 8 * 64 + 4 * 8 * 1024
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(b["bytes"] / 3.35e12 * 1e3)
