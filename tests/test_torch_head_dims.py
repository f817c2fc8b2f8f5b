"""Port parity for B1–B3 at head dimensions other than 64 and 128, and the
kernels' launch plan.

The reference's kernels (``flash_attention_fwd``, ``flash_backward_pallas``)
put no constraint on the head dimension, and the reference's transformer
sends any head_dim to them under ``attn_impl="flash"`` (training takes
flash under ``"auto"`` whenever ``head_dim >= 64 and head_dim % 8 == 0``).
The port's CUDA kernels took 64 and 128 only, and ``b·h`` up to 65,535;
``launch_plan`` now takes every head_dim and any ``b·h`` that fits an int,
and these tests hold what it accepts and what it still refuses (the
earlier wrappers refused the head-dim and ``b·h`` cases below).

The JAX side runs the Pallas kernels in interpret mode, as
``tests/test_pallas.py`` does; the port side runs the wrappers on CPU
tensors, which take the plain versions (the CUDA kernels are held against
those on the card by ``chip_smoke.py`` phase 19). Tolerances: f32 out and
lse 2e-5, gradients 1e-4 (the reference's gate for its kernels); the LM's
loss and gradients rtol 2e-3 / atol 1e-3 (the train phase's float32 gate).
"""

import importlib
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from deeplearning4j_tpu.models import transformer as jax_tm
from deeplearning4j_tpu_torch.dtypes import tree_leaves
from deeplearning4j_tpu_torch.kernels import _build
from deeplearning4j_tpu_torch.kernels import flash_attention as fa
from deeplearning4j_tpu_torch.models import transformer as tm
from deeplearning4j_tpu_torch.models.convert import params_from_jax

jfa = importlib.import_module("deeplearning4j_tpu.pallas.flash_attention")

HEAD_DIMS = (16, 72, 80, 100, 256, 320)
CASES = [
    # label, b, tq, tkv, h, causal, window
    ("causal", 1, 100, 100, 2, True, None),
    ("windowed", 1, 100, 100, 1, True, 17),
    ("non-causal", 2, 24, 70, 1, False, None),
]
BLOCK = 128
# the backward at every head dim, each case at two of them (interpret-mode
# compiles dominate this file's time)
BWD = [(d, CASES[i % len(CASES)]) for i, d in enumerate(HEAD_DIMS)]


def _inputs(b, tq, tkv, h, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, tq, h, d)).astype(np.float32),
            rng.normal(size=(b, tkv, h, d)).astype(np.float32),
            rng.normal(size=(b, tkv, h, d)).astype(np.float32),
            rng.normal(size=(b, tq, h, d)).astype(np.float32))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_forward_matches_pallas_kernel(d, case):
    _, b, tq, tkv, h, causal, window = case
    q, k, v, _ = _inputs(b, tq, tkv, h, d, seed=d)
    want_out, want_lse = jfa.flash_attention_fwd(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal, window=window,
        block_q=BLOCK, block_k=BLOCK, interpret=True)
    out, lse = fa.flash_attention_fwd(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        window=window)
    assert out.shape == (b, tq, h, d) and lse.shape == (b, h, tq)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("d, case", BWD,
                         ids=[f"{d}-{c[0]}" for d, c in BWD])
def test_backward_matches_pallas_kernels(d, case):
    _, b, tq, tkv, h, causal, window = case
    q, k, v, do = (jnp.asarray(x)
                   for x in _inputs(b, tq, tkv, h, d, seed=d + 1))
    kw = dict(causal=causal, window=window, block_q=BLOCK, block_k=BLOCK,
              interpret=True)
    out, lse = jfa.flash_attention_fwd(q, k, v, **kw)
    want = jfa.flash_backward_pallas(q, k, v, out, lse, do, **kw)
    got = fa.flash_attention_bwd(
        *(torch.from_numpy(np.array(x)) for x in (q, k, v, out, lse, do)),
        causal=causal, window=window)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_lm_at_head_dim_80_matches_reference():
    """d160 over 2 heads (head_dim 80, OPT-2.7B's), flash on both sides:
    loss and every parameter's gradient from the same weights."""
    cfg = dict(vocab_size=64, d_model=160, num_heads=2, num_layers=2,
               max_len=64, seed=0, attn_impl="flash")
    ref = jax_tm.TransformerLM(**cfg).init()
    port = tm.TransformerLM(**cfg, device="cpu")
    port.params = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                         ref.params))
    assert port._attn_impl(48, train=True) == "flash"
    tok = np.random.default_rng(0).integers(0, 64, (2, 48)).astype(np.int32)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: ref.loss(p, jnp.asarray(tok), train=True)))(ref.params)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ref.params))
    leaves = tree_leaves(params)
    for x in leaves:
        x.requires_grad_()
    loss = port.loss(params, torch.from_numpy(tok), train=True)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=2e-3, atol=1e-3)
    want = tree_leaves(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              want_grads)))
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-3,
                                   atol=1e-3)


def _expected_route(d, dtype):
    """B1–B3's route and width in either dtype: rows whole up to the
    widest tier (bf16) or ``F32_TIER_MAX`` (f32), streamed above."""
    if d in fa.EXACT_HEAD_DIMS:
        return "exact", d
    widest = fa.MMA_TIERS[-1] if dtype == torch.bfloat16 else fa.F32_TIER_MAX
    if d <= widest:
        return "tier", min(t for t in fa.MMA_TIERS if t >= d)
    return "wide", fa.CHUNK


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_launch_plan_takes_every_head_dim(dtype):
    """Every d in 1..512 gets a plan whose padded width covers it or
    whose route streams it in chunks; the earlier wrappers refused every
    d but 64 and 128."""
    b, t, h = 2, 130, 3
    for d in range(1, 513):
        plan = fa.launch_plan((b, t, h, d), (b, t, h, d), dtype,
                              causal=True)
        route, tier = _expected_route(d, dtype)
        assert (plan.route, plan.tier) == (route, tier), d
        assert plan.vec == (d % 8 == 0)
        if route in ("exact", "tier"):
            assert d <= plan.tier
        assert plan.c_args() == ({"exact": 0, "tier": 1, "wide": 3}[route],
                                 tier, int(plan.vec))
        assert plan.variant == ("mma.sync bf16" if dtype == torch.bfloat16
                                else "mma.sync 3xtf32")
    # OPT-2.7B's head_dim runs at its own width, not padded to 128
    assert fa.launch_plan((2, 2048, 32, 80), (2, 2048, 32, 80),
                          torch.bfloat16, causal=True).tier == 80


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_launch_plan_names_each_kernels_variant(dtype):
    """B1, B2 and B3 share one plan in both dtypes. In f32 it is the
    3xTF32 tensor-core kernels at every d (rows whole up to
    ``F32_TIER_MAX``, streamed in chunks above). ``chip_smoke.variant``
    prints what the plan says."""
    name = str(dtype).replace("torch.", "")
    b, t, h = 2, 130, 3
    for d in range(1, 513):
        plan = fa.launch_plan((b, t, h, d), (b, t, h, d), dtype,
                              causal=True)
        bwd = plan.kernel("dkdv")
        assert plan.kernel("dq") == bwd == plan
        route, tier = _expected_route(d, dtype)
        assert (bwd.route, bwd.tier, bwd.vec) == (route, tier, d % 8 == 0), d
        assert bwd.c_args() == ({"exact": 0, "tier": 1, "wide": 3}[route],
                                tier, int(d % 8 == 0))
        if route != "wide":
            assert d <= bwd.tier
        fwd = plan.kernel("fwd")
        assert (fwd.route, fwd.variant, fwd.tier, fwd.vec) == \
            (plan.route, plan.variant, plan.tier, plan.vec)
        assert bwd == fwd and bwd.variant == (
            "mma.sync 3xtf32" if dtype == torch.float32 else "mma.sync bf16")
        for kern in ("fwd", "dkdv", "dq"):
            assert chip_smoke.variant(kern, name) == \
                plan.kernel(kern).variant
    # an input off a 16-byte boundary: the padded tier of 64 with element
    # copies for all three kernels
    plan = fa.launch_plan((1, 8, 2, 64), (1, 8, 2, 64), dtype,
                          aligned=False)
    assert (plan.route, plan.tier, plan.vec) == ("tier", 64, False)
    assert plan.kernel("fwd") == plan.kernel("dkdv") == plan
    with pytest.raises(ValueError, match="kernel"):
        plan.kernel("bwd")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_launch_plan_takes_batch_times_heads_past_the_grid_y_limit(dtype):
    """b·h goes on grid x (up to 2^31 - 1); the earlier kernels capped it at
    65,535 (grid y)."""
    plan = fa.launch_plan((8200, 16, 8, 64), (8200, 16, 8, 64), dtype,
                          causal=True)
    assert plan.route == "exact"
    for d in (80, 320):
        assert fa.launch_plan((65_600, 4, 1, d), (65_600, 4, 1, d), dtype
                              ).route != "exact"
    with pytest.raises(ValueError, match="int"):
        fa.launch_plan((2 ** 16, 1, 2 ** 15, 64), (2 ** 16, 1, 2 ** 15, 64),
                       dtype)


def test_launch_plan_keeps_the_references_refusals():
    x = (1, 8, 2, 80)
    with pytest.raises(ValueError, match="window"):
        fa.launch_plan(x, x, torch.bfloat16, window=4)
    with pytest.raises(ValueError, match="window"):
        fa.launch_plan(x, x, torch.bfloat16, causal=True, window=0)
    with pytest.raises(ValueError, match="tq == tkv"):
        fa.launch_plan(x, (1, 6, 2, 80), torch.bfloat16, causal=True)
    for k in ((1, 8, 2, 72), (1, 8, 3, 80), (2, 8, 2, 80), (1, 8, 80)):
        with pytest.raises(ValueError):
            fa.launch_plan(x, k, torch.float32)
    # the wrapper's own preconditions
    with pytest.raises(TypeError):
        fa.launch_plan(x, x, torch.float16)
    with pytest.raises(ValueError, match="empty"):
        fa.launch_plan((1, 0, 2, 80), (1, 0, 2, 80), torch.float32)
    with pytest.raises(ValueError, match="rows"):
        fa.launch_plan((1, 65_535 * 64 + 1, 1, 64),
                       (1, 65_535 * 64 + 1, 1, 64), torch.bfloat16,
                       causal=True)
    # an input off a 16-byte boundary leaves the exact route and the
    # 16-byte copies
    for dtype in (torch.bfloat16, torch.float32):
        plan = fa.launch_plan((1, 8, 2, 64), (1, 8, 2, 64), dtype,
                              aligned=False)
        assert plan.route == "tier" and not plan.vec


def test_tier_list_reaches_nvcc(monkeypatch):
    """The tier list is written once, in the package: both flash sources
    get it as a compiler flag (their text holds no width of its own), and
    another list builds another library."""
    from deeplearning4j_tpu_torch import kernels

    flag = "-DDL4J_MMA_TIERS=" + "".join(f"DL4J_TIER({t})"
                                         for t in fa.MMA_TIERS)
    assert fa.MMA_TIERS == kernels.MMA_TIERS
    for name in ("flash_fwd", "flash_bwd"):
        assert _build.nvcc_flags(name)[-1] == flag
        with open(os.path.join(_build.CSRC, f"{name}.cu")) as f:
            src = f.read()
        assert "DL4J_MMA_TIERS" in src
        assert not re.search(r"DL4J_TIER\(\d+\)", src), name
        before = _build.library_path(name)
        monkeypatch.setitem(kernels.SOURCE_FLAGS, name, (flag + "X",))
        assert _build.library_path(name) != before


def test_f32_tier_max_reaches_nvcc():
    """The f32 kernels' widest whole row is written once, in the
    package: the plan reads it and both flash sources get it as a
    compiler flag (their text holds no width of its own)."""
    from deeplearning4j_tpu_torch import kernels

    flag = f"-DDL4J_F32_TIER_MAX={kernels.F32_TIER_MAX}"
    assert fa.F32_TIER_MAX == kernels.F32_TIER_MAX
    for name in ("flash_fwd", "flash_bwd"):
        assert flag in _build.nvcc_flags(name)
        with open(os.path.join(_build.CSRC, f"{name}.cu")) as f:
            src = f.read()
        assert "kF32TierMax = DL4J_F32_TIER_MAX;" in src
        assert not re.search(r"kF32TierMax = \d", src), name

