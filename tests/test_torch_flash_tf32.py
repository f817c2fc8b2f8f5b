"""The arithmetic of the float32 flash kernels B1, B2 and B3 on the CPU.

On the card the f32 B1, B2 and B3 run on the tensor cores as 3xTF32
(``csrc/mma_tf32.cuh``): every f32 operand ``x`` is split into ``big =
cvt.rna.tf32(x)`` and ``small = cvt.rna.tf32(x - big)``, and each k-step of
8 products is ``small_a·big_b + big_a·small_b + big_a·big_b``, three
MMAs that each round their sum toward zero, started from a zero tile
that is added to the running f32 sum. No CPU can run those
kernels, so this file emulates that arithmetic with numpy (TF32 rounding:
round to nearest, ties away, on the low 13 bits) and holds the emulated
B2/B3 against the port's plain f32 backward and against the JAX package's
``flash_backward_pallas`` (interpret mode, as ``tests/test_pallas.py`` runs
it) on the same numpy inputs, at ``BWD_TOL["float32"]`` (1e-4, the
reference's gate for its kernels) with a 10x margin.

The emulated forward B1 sums as ``csrc/flash_fwd.cu``'s f32 kernels do:
s = (q·kᵀ)·scale by the 3xTF32 k-steps, then an online softmax over key
tiles of 64 in the kernel's order (masked scores -inf, the running max
from -1e30, ``l`` summing the unrounded p), each tile's P·V added by its
k-steps of 8 keys to ``acc·corr``; on rows of up to 128 floats the
kernel gives each 16-row group two warps, each takes half of every
tile's keys and the two partial states are merged once at the end; the
wide kernel sums q·kᵀ a chunk of 64 columns at a time.
``out`` and ``lse`` are held against the port's plain f32 forward and
the JAX package's ``flash_attention_fwd`` (interpret mode) at
``TOL["float32"]`` (2e-5, the forward's gate) with the same margin.

A single TF32 product per k-step (1xTF32), and 3xTF32 chained straight
into the accumulators, are emulated too; how far they land from the plain
versions is recorded, not asserted.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from deeplearning4j_tpu_torch.kernels import flash_attention as fa

jfa = importlib.import_module("deeplearning4j_tpu.pallas.flash_attention")

BWD_TOL = chip_smoke.BWD_TOL["float32"]
FWD_TOL = chip_smoke.TOL["float32"]
MARGIN = 10.0
K_STEP = 8  # products a tensor-core k-step (mma.sync m16n8k8)
KEY_TILE = 64  # keys a tile of the forward kernel
HEAD_DIMS = (16, 64, 80, 128, 320)
CASES = [
    # label, b, tq, tkv, h, causal, window
    ("causal", 1, 100, 100, 2, True, None),
    ("windowed", 1, 100, 100, 1, True, 17),
    ("non-causal", 2, 24, 70, 1, False, None),
]
BLOCK = 128


def rna_tf32(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: f32 rounded to 10 mantissa bits, to nearest
    with ties away from zero (the low 13 bits cleared)."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x1000) & 0xFFFFE000).astype(np.uint32)
    return u.view(np.float32)


def split(x: np.ndarray):
    """x = big + small, both TF32 values."""
    x = np.asarray(x, np.float32)
    big = rna_tf32(x)
    return big, rna_tf32(x - big)


def rz_f32(x: np.ndarray) -> np.ndarray:
    """f64 values rounded toward zero to f32, as the tensor core rounds
    the sum it returns."""
    f = np.asarray(x, np.float64).astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def tc_matmul(a: np.ndarray, b: np.ndarray, passes: int = 3,
              chain: bool = False, init=None) -> np.ndarray:
    """``init + a [..., m, k] @ b [..., k, n]`` as the kernels sum it
    (``init`` zero if None): k in steps
    of 8; each MMA adds its 8 TF32 products (exact in f64) to its
    accumulator and rounds toward zero; ``passes`` 3 runs small·big,
    big·small and big·big, 1 big·big only. Each step's MMAs start from a
    zero tile that is then added to the running sum in f32 (round to
    nearest: ``mma_3x``); ``chain=True`` sends them straight into the
    running sum instead."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    ab, as_ = split(a)
    bb, bs = split(b)
    terms = [(ab, bb)] if passes == 1 else [(as_, bb), (ab, bs), (ab, bb)]
    k = a.shape[-1]
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    if init is not None:
        acc = acc + np.asarray(init, np.float32)
    for k0 in range(0, k, K_STEP):
        sl = slice(k0, k0 + K_STEP)
        t = acc if chain else np.zeros_like(acc)
        for x, y in terms:
            prod = np.matmul(x[..., sl].astype(np.float64),
                             y[..., sl, :].astype(np.float64))
            t = rz_f32(t.astype(np.float64) + prod)
        acc = t if chain else acc + t
    return acc


def emulated_bwd(q, k, v, do, lse, delta, keep, scale, passes=3,
                 chain=False):
    """B2 and B3 as the f32 kernels compute them: ``(dq, dk, dv)`` f32 in
    BTHD (``chain`` chains every product's MMAs, to show why the kernels
    do not). q/do ``[b, tq, h, d]``, k/v ``[b, tkv, h, d]``, lse/delta
    ``[b, h, tq]``, keep ``[tq, tkv]``."""
    qh, kh, vh, doh = (np.transpose(x, (0, 2, 1, 3)) for x in (q, k, v, do))
    s = tc_matmul(qh, np.swapaxes(kh, -1, -2), passes, chain)
    dp = tc_matmul(doh, np.swapaxes(vh, -1, -2), passes, chain)
    p = np.where(keep, np.exp(s * np.float32(scale) - lse[..., None]),
                 np.float32(0)).astype(np.float32)
    ds = (p * (dp - delta[..., None]) * np.float32(scale)).astype(np.float32)
    dv = tc_matmul(np.swapaxes(p, -1, -2), doh, passes, chain)
    dk = tc_matmul(np.swapaxes(ds, -1, -2), qh, passes, chain)
    dq = tc_matmul(ds, kh, passes, chain)
    return tuple(np.transpose(x, (0, 2, 1, 3)) for x in (dq, dk, dv))


def emulated_fwd(q, k, v, keep, scale, split_keys, chunk=None, passes=3,
                 chain=False):
    """B1 as the f32 kernels compute it: ``(out [b, tq, h, d], lse [b, h,
    tq])`` f32. q ``[b, tq, h, d]``, k/v ``[b, tkv, h, d]``, keep ``[tq,
    tkv]``; ``split_keys``: two warps a row group, each taking half of
    every key tile, merged at the end (the kernel's layout on rows of up
    to 128 floats); ``chunk``: q·kᵀ summed over ``d`` a chunk of that many
    columns at a time, each chunk's sum added to the scores in f32 (the
    wide kernel's)."""
    qh, kh, vh = (np.transpose(x, (0, 2, 1, 3)) for x in (q, k, v))
    tkv, d = kh.shape[2], kh.shape[3]
    pad = -tkv % KEY_TILE  # the kernel's last tile: keys past tkv masked
    kt = np.swapaxes(kh, -1, -2)
    step = chunk or d
    s = tc_matmul(qh[..., :step], kt[..., :step, :], passes, chain)
    for c0 in range(step, d, step):
        s = s + tc_matmul(qh[..., c0:c0 + step], kt[..., c0:c0 + step, :],
                          passes, chain)
    s = np.where(keep, s * np.float32(scale), np.float32(-np.inf))
    s = np.pad(s, [(0, 0)] * 3 + [(0, pad)], constant_values=-np.inf)
    vh = np.pad(vh, [(0, 0), (0, 0), (0, pad), (0, 0)])
    shares = ([(0, KEY_TILE // 2), (KEY_TILE // 2, KEY_TILE)] if split_keys
              else [(0, KEY_TILE)])
    states = []
    for lo, hi in shares:  # one warp's keys of each tile
        m = np.full(s.shape[:-1], fa.MASK_VALUE, np.float32)
        l = np.zeros(s.shape[:-1], np.float32)
        acc = np.zeros(qh.shape, np.float32)
        for k0 in range(0, tkv + pad, KEY_TILE):
            st = s[..., k0 + lo:k0 + hi]
            m_next = np.maximum(m, st.max(-1))
            corr = np.exp(m - m_next)
            p = np.exp(st - m_next[..., None])
            l = l * corr + p.sum(-1, dtype=np.float32)
            acc = tc_matmul(p, vh[..., k0 + lo:k0 + hi, :], passes, chain,
                            init=acc * corr[..., None])
            m = m_next
        states.append((m, l, acc))
    m, l, acc = states[0]
    if split_keys:  # the second half's state merged into the first's
        m1, l1, acc1 = states[1]
        m_all = np.maximum(m, m1)
        c0, c1 = np.exp(m - m_all), np.exp(m1 - m_all)
        l = l * c0 + l1 * c1
        acc = acc * c0[..., None] + acc1 * c1[..., None]
        m = m_all
    safe_l = np.where(l == 0, np.float32(1), l)
    out = acc / safe_l[..., None]
    return (np.transpose(out, (0, 2, 1, 3)),
            (m + np.log(safe_l)).astype(np.float32))


def _inputs(b, tq, tkv, h, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, tq, h, d)).astype(np.float32),
            rng.normal(size=(b, tkv, h, d)).astype(np.float32),
            rng.normal(size=(b, tkv, h, d)).astype(np.float32),
            rng.normal(size=(b, tq, h, d)).astype(np.float32))


def _case(d, case, seed):
    """The port's plain f32 backward and the emulated kernels' on one
    case: ``(inputs, plain (dq, dk, dv), emulate(passes, chain))``."""
    _, b, tq, tkv, h, causal, window = case
    q, k, v, do = _inputs(b, tq, tkv, h, d, seed)
    tq_, tk_ = (torch.from_numpy(x) for x in (q, k))
    out, lse = fa.flash_attention_fwd(tq_, tk_, torch.from_numpy(v),
                                      causal=causal, window=window)
    plain = fa.flash_attention_bwd(tq_, tk_, torch.from_numpy(v), out, lse,
                                   torch.from_numpy(do), causal=causal,
                                   window=window)
    delta = fa._delta(out, torch.from_numpy(do)).numpy()
    keep = fa._keep(tq, tkv, causal, window).numpy()
    scale = 1.0 / np.sqrt(d)

    def emulate(passes=3, chain=False):
        return emulated_bwd(q, k, v, do, lse.numpy(), delta, keep, scale,
                            passes, chain)

    return (q, k, v, do), tuple(x.numpy() for x in plain), emulate


def _err(got, want) -> float:
    return max(float(np.abs(g - w).max()) for g, w in zip(got, want))


def test_split_recovers_x_to_2_pow_minus_22():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=100_000) *
         10.0 ** rng.uniform(-30, 30, 100_000)).astype(np.float32)
    x = np.concatenate([x, np.float32([1.0, -1.0, 3.0, 1 + 2 ** -11,
                                       1 + 2 ** -11 + 2 ** -23])])
    big, small = split(x)
    # both parts are TF32: the low 13 bits are clear
    for part in (big, small):
        assert not np.any(part.view(np.uint32) & 0x1FFF)
    rel = np.abs(big.astype(np.float64) + small - x) / np.abs(x)
    assert rel.max() <= 2.0 ** -22
    # one TF32 part alone keeps about 2^-11 only
    assert (np.abs(big.astype(np.float64) - x) / np.abs(x)).max() > 2 ** -14


def test_rna_rounds_ties_away_from_zero():
    one = np.float32(1.0)
    tie = np.float32(1 + 2 ** -11)      # halfway between 1 and 1 + 2^-10
    assert rna_tf32(tie) == np.float32(1 + 2 ** -10)
    assert rna_tf32(-tie) == -np.float32(1 + 2 ** -10)
    assert rna_tf32(np.nextafter(tie, one)) == one


BWD = [(d, c) for d in HEAD_DIMS for c in CASES]


@pytest.mark.parametrize("d, case", BWD,
                         ids=[f"{d}-{c[0]}" for d, c in BWD])
def test_emulated_3xtf32_backward_meets_the_f32_gate(d, case, record_property):
    _, plain, emulate = _case(d, case, seed=d)
    err = _err(emulate(3), plain)
    record_property("err_3xtf32", err)
    assert err * MARGIN <= BWD_TOL, (d, case[0], err)


@pytest.mark.parametrize("d, case", [(d, CASES[i % len(CASES)])
                                     for i, d in enumerate(HEAD_DIMS)],
                         ids=[f"{d}-{CASES[i % len(CASES)][0]}"
                              for i, d in enumerate(HEAD_DIMS)])
def test_emulated_3xtf32_backward_matches_pallas_kernels(d, case):
    _, b, tq, tkv, h, causal, window = case
    (q, k, v, do), _, emulate = _case(d, case, seed=d + 1)
    kw = dict(causal=causal, window=window, block_q=BLOCK, block_k=BLOCK,
              interpret=True)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    out, lse = jfa.flash_attention_fwd(jq, jk, jv, **kw)
    want = jfa.flash_backward_pallas(jq, jk, jv, out, lse, jdo, **kw)
    got = emulate(3)
    for g, w in zip(got, want):
        assert g.shape == w.shape
    err = _err(got, [np.asarray(w) for w in want])
    assert err * MARGIN <= BWD_TOL, (d, case[0], err)


LONG = ("causal t=512", 1, 512, 512, 1, True, None)


def test_one_tf32_product_is_recorded_not_asserted(record_property, capsys):
    """How far a single TF32 product a k-step (what a kernel would compute
    without the split) lands from the plain f32 backward, and how far
    3xTF32 would with every product's MMAs chained straight into its
    accumulator (the tensor core's rounding toward zero adds up), beside
    the kernels' arithmetic: recorded for the notes, not asserted."""
    rows = []
    for d in (64, 80, 128):
        _, plain, emulate = _case(d, LONG, seed=d)
        errs = {"1xtf32": _err(emulate(1), plain),
                "3xtf32_chained": _err(emulate(3, chain=True), plain),
                "3xtf32": _err(emulate(3), plain)}
        for key, e in errs.items():
            record_property(f"d{d}_err_{key}", e)
        rows.append(f"d={d} t=512: " + ", ".join(
            f"{key} {e:.3e}" for key, e in errs.items())
            + f" (gate {BWD_TOL:.0e})")
    with capsys.disabled():
        print("\n" + "\n".join(rows))
    assert len(rows) == 3


def _fwd_case(d, case, seed):
    """The port's plain f32 forward and the emulated kernel's on one
    case: ``(q, k, v), plain (out, lse), emulate(passes, chain)``. The
    kernel's layout (whether two warps split each key tile) comes from
    the launch plan's route and width."""
    _, b, tq, tkv, h, causal, window = case
    q, k, v, _ = _inputs(b, tq, tkv, h, d, seed)
    plain = fa.flash_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)),
                                   causal=causal, window=window)
    plan = fa.launch_plan(q.shape, k.shape, torch.float32, causal=causal,
                          window=window).kernel("fwd")
    assert plan.variant == "mma.sync 3xtf32"
    wide = plan.route == "wide"
    keep = fa._keep(tq, tkv, causal, window).numpy()

    def emulate(passes=3, chain=False):
        return emulated_fwd(q, k, v, keep, 1.0 / np.sqrt(d), not wide,
                            plan.tier if wide else None, passes, chain)

    return (q, k, v), tuple(x.numpy() for x in plain), emulate


@pytest.mark.parametrize("d, case", BWD,
                         ids=[f"{d}-{c[0]}" for d, c in BWD])
def test_emulated_3xtf32_forward_meets_the_f32_gate(d, case,
                                                    record_property):
    _, plain, emulate = _fwd_case(d, case, seed=d + 2)
    got = emulate(3)
    for g, w in zip(got, plain):
        assert g.shape == w.shape and bool(np.isfinite(g).all())
    err = _err(got, plain)
    record_property("err_3xtf32", err)
    assert err * MARGIN <= FWD_TOL, (d, case[0], err)


@pytest.mark.parametrize("d, case", [(d, CASES[i % len(CASES)])
                                     for i, d in enumerate(HEAD_DIMS)],
                         ids=[f"{d}-{CASES[i % len(CASES)][0]}"
                              for i, d in enumerate(HEAD_DIMS)])
def test_emulated_3xtf32_forward_matches_pallas_kernel(d, case):
    _, b, tq, tkv, h, causal, window = case
    (q, k, v), _, emulate = _fwd_case(d, case, seed=d + 3)
    want = jfa.flash_attention_fwd(*(jnp.asarray(x) for x in (q, k, v)),
                                   causal=causal, window=window,
                                   block_q=BLOCK, block_k=BLOCK,
                                   interpret=True)
    got = emulate(3)
    for g, w in zip(got, want):
        assert g.shape == w.shape
    err = _err(got, [np.asarray(w) for w in want])
    assert err * MARGIN <= FWD_TOL, (d, case[0], err)


def test_forward_tf32_variants_are_recorded_not_asserted(record_property,
                                                         capsys):
    """How far the forward lands from the plain f32 forward with one TF32
    product a k-step and with 3xTF32's MMAs chained straight into S and
    the output accumulators, beside the kernel's arithmetic: recorded for
    the notes, not asserted (small sizes: t 100)."""
    rows = []
    for d in (64, 80, 128):
        _, plain, emulate = _fwd_case(d, CASES[0], seed=d)
        errs = {"1xtf32": _err(emulate(1), plain),
                "3xtf32_chained": _err(emulate(3, chain=True), plain),
                "3xtf32": _err(emulate(3), plain)}
        for key, e in errs.items():
            record_property(f"fwd_d{d}_err_{key}", e)
        rows.append(f"fwd d={d} t=100: " + ", ".join(
            f"{key} {e:.3e}" for key, e in errs.items())
            + f" (gate {FWD_TOL:.0e})")
    with capsys.disabled():
        print("\n" + "\n".join(rows))
    assert len(rows) == 3
