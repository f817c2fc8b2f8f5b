"""Port parity: ``deeplearning4j_tpu_torch.ops.attention`` against the JAX
reference ``deeplearning4j_tpu.ops.attention`` on the same numpy inputs
(float32, tolerance 1e-5: the two differ only in summation order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.ops import attention as ref
from deeplearning4j_tpu_torch.ops import attention as port

TOL = 1e-5


def _qkv(b, tq, tkv, h, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, tq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, tkv, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, tkv, hkv, d)).astype(np.float32)
    return q, k, v


def _both(fn_name, q, k, v, **kw):
    jkw = {n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
           for n, x in kw.items()}
    tkw = {n: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
           for n, x in kw.items()}
    a = np.asarray(getattr(ref, fn_name)(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), **jkw))
    b = getattr(port, fn_name)(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), **tkw).numpy()
    return a, b


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("tq,tkv,q_offset", [(6, 6, 0), (4, 9, 5)])
def test_causal_band_mask(window, tq, tkv, q_offset):
    a = np.asarray(ref.causal_band_mask(tq, tkv, window=window,
                                        q_offset=q_offset))
    b = port.causal_band_mask(tq, tkv, window=window,
                              q_offset=q_offset).numpy()
    assert np.array_equal(a, b)


@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (True, 4)])
def test_dot_product_attention(causal, window):
    q, k, v = _qkv(2, 11, 11, 2, 2, 16)
    a, b = _both("dot_product_attention", q, k, v, causal=causal,
                 window=window)
    np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mask_rank", [2, 3])
@pytest.mark.parametrize("hkv", [2, 1])
def test_masked_attention(mask_rank, hkv):
    """2D padding masks and 3D per-query masks (including a row with no
    visible key), dense (H == Hkv) and grouped (H > Hkv)."""
    q, k, v = _qkv(2, 5, 9, 2, hkv, 16, seed=1)
    rng = np.random.default_rng(2)
    shape = (2, 9) if mask_rank == 2 else (2, 5, 9)
    mask = rng.random(shape) < 0.7
    if mask_rank == 3:
        mask[1, 2] = False
    a, b = _both("grouped_query_attention", q, k, v, mask=mask)
    np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("window", [None, 3])
def test_grouped_query_attention_causal(window):
    q, k, v = _qkv(1, 10, 10, 4, 2, 8, seed=3)
    a, b = _both("grouped_query_attention", q, k, v, causal=True,
                 window=window)
    np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


def test_bf16_inputs_follow_reference_casts():
    """bf16 operands: f32 logits, probabilities cast to bf16 before the
    PV product, bf16 result — one bf16 ulp of agreement."""
    q, k, v = _qkv(1, 8, 8, 2, 2, 16, seed=4)
    qj, kj, vj = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    a = np.asarray(ref.dot_product_attention(qj, kj, vj, causal=True)
                   .astype(jnp.float32))
    qt, kt, vt = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out = port.dot_product_attention(qt, kt, vt, causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), a, rtol=1e-2, atol=1e-2)


def test_window_requires_causal():
    q, k, v = (torch.zeros(1, 4, 1, 8),) * 3
    with pytest.raises(ValueError):
        port.dot_product_attention(q, k, v, window=2)
    with pytest.raises(ValueError):
        port.grouped_query_attention(q, k, v, causal=True, window=0)
