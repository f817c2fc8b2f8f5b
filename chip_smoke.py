#!/usr/bin/env python3
"""Chip smoke for the PyTorch/H100 port (``deeplearning4j_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Five phases; any failure exits non-zero and prints no result line.

1. Build and device: compile every CUDA kernel from ``csrc/`` (one
   ``nvcc`` per source, all at once) and print the card's name and power
   limit from ``nvidia-smi``.
2. Kernels against their plain versions on the card: the flash-attention
   forward (f32 and bf16; causal prompts of 16, 37, 512 and 1000 tokens,
   a windowed case, a non-causal case, head_dim 128, and every prefill
   shape of the serve phase) against ``flash_attention_fwd_reference``
   with TF32 off, at f32 2e-5 and bf16 2e-2 on out and lse. Prints the
   kernel's time beside the plain version's,
   ``F.scaled_dot_product_attention`` as a yardstick the port never
   calls, and the H100 bound. The training shape [16, 1024, 8, 64] is
   timed too.
3. Flash backward: the dk/dv kernel (B2) and the dq kernel (B3) against
   their plain versions on the card with TF32 off, on the forward
   phase's cases and the training shape, in f32 (1e-4) and bf16 (2e-2)
   on dq, dk and dv. Prints each kernel's time, the plain version's,
   the bound and the backward of ``F.scaled_dot_product_attention`` (B2
   and B3 together), a yardstick the port never calls.
4. Serve: the d512·L8·H8 ``TransformerLM`` (vocab 8192, d_ff 2048,
   learned positions, max_len 1024, ``mixed_bf16``, ``attn_impl="flash"``,
   random weights from seed 0) first has its logits on a 77-token prompt
   held against the same weights on the CPU (5e-2); then, behind
   ``DecodeServer(slots=8, max_len=1024)``, it answers a seeded Poisson
   stream of ragged greedy requests (prompts 20–900 tokens, 16–64 new)
   at ``fuse_steps`` 1 and 4.
   Asserts that the flash kernel ran ``num_layers`` times per prefill,
   that every stream equals the port's own ``lm.generate`` on the same
   prompt, and that both settings give the same streams.
5. Train: the same model with ``attn_impl="auto"`` (which resolves to
   flash under ``train=True``) takes 2 warm-up and 8 timed ``fit_batch``
   steps on one seeded ``[16, 1024]`` batch under ``mixed_bf16``.
   Asserts finite, falling losses, B1, B2 and B3 each launched
   ``num_layers`` times per step, and f32 masters and Adam moments;
   prints ms/step, tokens/s and the share of the bf16 peak. Then, at full
   width and batch 2, holds the flash path against the plain-attention
   path on the same weights: one step's loss and gradients under
   ``float32`` (rtol 2e-3, atol 1e-3) and the loss and params after 3
   steps under ``mixed_bf16`` (2e-2, 1e-2).

Output: metric lines, then a ``{"kernels": [...]}`` JSON line (each
kernel's ``launches`` counted over the train phase's timed steps; B1's
over the serve phase too, as ``launches_serve``) and the ``nvidia-smi``
line, then ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

SERVE_CFG = dict(vocab_size=8192, d_model=512, num_heads=8, num_layers=8,
                 d_ff=2048, max_len=1024, seed=0, pos_encoding="learned",
                 dtype_policy="mixed_bf16", attn_impl="flash")
SERVE_SLOTS = 8
SERVE_MAX_LEN = 1024
SERVE_REQUESTS = 8
SERVE_PROMPT_LENS = (20, 75, 160, 333, 512, 700, 900)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# backward: f32 at the reference's gate for its kernels (tests/
# test_pallas.py); bf16: both sides round p and ds to bf16 at the same
# places, but an f32 sum taken in another order can land one of them on
# the other side of a rounding tie, moving a gradient by one bf16 ulp of
# p or ds (<= 2^-9 below 1) times one do/q/k element (|x| < 5 for these
# N(0, 1) draws), so the forward's 2e-2 holds with room
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TRAIN_CFG = {**SERVE_CFG, "attn_impl": "auto"}
TRAIN_BATCH, TRAIN_T = 16, 1024
TRAIN_WARMUP, TRAIN_STEPS = 2, 8
H100_BF16_FLOPS = 989e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return out[0] if out else "nvidia-smi printed nothing"


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2: flash-attention forward against its plain version
# ---------------------------------------------------------------------------
def flash_cases():
    """(label, b, tq, tkv, h, d, causal, window). The "main path" entries
    are the prefill shapes the serve phase gives the kernel (one per
    prompt-ladder rung of its prompt lengths); the last is the largest."""
    from deeplearning4j_tpu_torch.perf.bucketing import prompt_bucket

    cases = [(f"causal P={p}", 1, p, p, 8, 64, True, None)
             for p in (16, 37, 512, 1000)]
    cases += [("windowed P=1000 w=128", 1, 1000, 1000, 8, 64, True, 128),
              ("non-causal tq=300 tkv=700", 1, 300, 700, 8, 64, False, None),
              ("head_dim 128 b=2 P=513", 2, 513, 513, 4, 128, True, None),
              train_case()]
    rungs = sorted({prompt_bucket(n, max_len=SERVE_MAX_LEN)
                    for n in SERVE_PROMPT_LENS})
    cases += [(f"main path P={p}", 1, p, p, SERVE_CFG["num_heads"],
               SERVE_CFG["d_model"] // SERVE_CFG["num_heads"], True, None)
              for p in rungs]
    return cases


def train_case():
    """The attention shape of the train phase's steps."""
    h = TRAIN_CFG["num_heads"]
    return (f"train b={TRAIN_BATCH} P={TRAIN_T}", TRAIN_BATCH, TRAIN_T,
            TRAIN_T, h, TRAIN_CFG["d_model"] // h, True, None)


def check_flash(card: str) -> dict:
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1234)
    failures, entry = [], None
    for label, b, tq, tkv, h, d, causal, window in flash_cases():
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            q, k, v = (torch.randn((b, t, h, d), generator=gen,
                                   device="cuda").to(dtype)
                       for t in (tq, tkv, tkv))
            kw = dict(causal=causal, window=window)
            out, lse = fa.flash_attention_fwd(q, k, v, **kw)
            ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, **kw)
            torch.cuda.synchronize()
            err = max(float((out.float() - ref_out.float()).abs().max()),
                      float((lse - ref_lse).abs().max()))
            finite = bool(torch.isfinite(out.float()).all())
            ok = finite and err <= TOL[name]
            ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw))
            plain_ms = cuda_ms(
                lambda: fa.flash_attention_fwd_reference(q, k, v, **kw))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            mask = None
            if window is not None:
                i = torch.arange(tq, device="cuda")
                mask = (i[:, None] >= i[None, :]) & \
                    (i[:, None] - i[None, :] < window)
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=causal and mask is None))
            bound = fa.flash_bound(b, tq, tkv, h, d, dtype, causal=causal,
                                   window=window)
            print(f"flash_fwd {label} {name}: max_abs_err={err:.3e} "
                  f"(tol {TOL[name]:.0e}) kernel_ms={ms:.5f} "
                  f"plain_ms={plain_ms:.5f} library_ms={lib_ms:.5f} "
                  f"bound_ms={bound['bound_ms']:.6f} ({bound['bound_by']}) "
                  f"{'ok' if ok else 'MISMATCH'} [{card}]")
            if not ok:
                failures.append(f"{label} {name}: err {err} finite {finite}")
            if label == flash_cases()[-1][0] and dtype == torch.bfloat16:
                entry = {
                    "name": "flash_attention_fwd",
                    "route": "cuda",
                    "source": "deeplearning4j_tpu_torch/kernels/csrc/"
                              "flash_fwd.cu",
                    "replaces": "deeplearning4j_tpu/pallas/"
                                "flash_attention.py:49",
                    "launches": None,
                    "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound["bound_ms"],
                    "bound_by": bound["bound_by"],
                    "library_ms": lib_ms,
                    "shape": [b, tq, h, d], "dtype": name,
                }
    if failures:
        raise AssertionError("flash kernel disagrees with its plain "
                             "version: " + "; ".join(failures))
    return entry


# ---------------------------------------------------------------------------
# phase 3: serve the slice's model
# ---------------------------------------------------------------------------
def check_forward(lm, card: str) -> None:
    """The served model's logits on the card (flash kernel) against the
    same weights on the CPU (the kernel's plain version and PyTorch's CPU
    matmuls) on a small prompt. Both run bf16 compute, which rounds the
    residual stream to 8 mantissa bits at different places on the two
    devices: tolerance 5e-2 on logits of magnitude ~1."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.dtypes import tree_map
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM

    cpu = TransformerLM(**{**SERVE_CFG, "device": "cpu"})
    cpu.params = tree_map(lambda p: p.cpu(), lm.params)
    tok = np.random.default_rng(5).integers(
        0, SERVE_CFG["vocab_size"], (1, 77))
    got = lm.forward(lm.params, tok).cpu()
    want = cpu.forward(cpu.params, tok)
    err = float((got - want).abs().max())
    ok = bool(torch.isfinite(got).all()) and got.shape == want.shape \
        and err <= 5e-2
    print(f"forward [1, 77] card vs cpu: max_abs_err={err:.3e} (tol 5e-2) "
          f"{'ok' if ok else 'MISMATCH'} [{card}]")
    if not ok:
        raise AssertionError(f"served model's logits disagree with the CPU "
                             f"reference: max_abs_err {err}")


def serve(card: str) -> int:
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.kernels.flash_attention import (
        flash_attention_fwd)
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM
    from deeplearning4j_tpu_torch.serving import (
        DecodeServer, poisson_schedule, run_open_loop)

    lm = TransformerLM(**SERVE_CFG).init()
    check_forward(lm, card)
    sched = poisson_schedule(
        SERVE_REQUESTS, 20.0, vocab_size=SERVE_CFG["vocab_size"],
        prompt_lens=SERVE_PROMPT_LENS, max_new_tokens=(16, 32, 64), seed=7)
    # warm the card (allocator, matmul library) outside the measured runs
    warm = DecodeServer(lm, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN)
    warm.submit(sched[0].prompt, 4)
    warm.drain()
    refs = {a.prompt.tobytes(): lm.generate(a.prompt[None],
                                            a.max_new_tokens)[0].cpu().numpy()
            for a in sched}
    torch.cuda.synchronize()

    streams, launches = {}, 0
    for k in (1, 4):
        srv = DecodeServer(lm, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                           fuse_steps=k)
        flash_attention_fwd.launches = 0
        report = run_open_loop(srv, sched)
        torch.cuda.synchronize()
        launches = flash_attention_fwd.launches
        s = report.summary()
        st = srv.stats()
        print(f"serve fuse_steps={k}: finished={s['finished']} "
              f"tokens={s['tokens']} tokens_per_sec={s['tokens_per_sec']} "
              f"ttft_p50_ms={s['ttft_p50_ms']} "
              f"p50_latency_ms={s['p50_latency_ms']} "
              f"kv_pool_bytes={st['kv_pool_bytes']} "
              f"prefill_buckets={st['compiles']['prefill_buckets']} "
              f"flash_launches={launches} [{card}]")
        if s["finished"] != len(sched):
            raise AssertionError(f"fuse_steps={k}: {s['finished']} of "
                                 f"{len(sched)} requests finished")
        want = lm.num_layers * len(sched)
        if launches != want:
            raise AssertionError(
                f"fuse_steps={k}: flash kernel launched {launches} times, "
                f"expected num_layers x prefills = {want}")
        for req in srv.finished:
            key = req.prompt.tobytes()
            if not np.array_equal(req.output, refs[key]):
                diff = int(np.argmax(req.output != refs[key]))
                raise AssertionError(
                    f"fuse_steps={k}: stream of the {req.prompt.shape[0]}"
                    f"-token prompt differs from lm.generate at index "
                    f"{diff}")
            streams.setdefault(key, []).append(req.output)
    for outs in streams.values():
        if not np.array_equal(outs[0], outs[1]):
            raise AssertionError("fuse_steps 1 and 4 streams differ")
    print(f"serve: {len(streams)} greedy streams equal lm.generate at "
          f"fuse_steps 1 and 4 [{card}]")
    return launches


# ---------------------------------------------------------------------------
# phase 4: flash-attention backward against its plain version
# ---------------------------------------------------------------------------
def sdpa_backward_ms(q, k, v, do, causal, window) -> float:
    """Device time of the backward of ``F.scaled_dot_product_attention``
    alone (the graph is kept and only ``autograd.grad`` is timed)."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    mask = None
    if window is not None:
        i = torch.arange(q.shape[1], device=q.device)
        mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                         is_causal=causal and mask is None)
    dot = do.transpose(1, 2)
    return cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                               retain_graph=True))


def check_flash_bwd(card: str) -> list:
    import torch
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4321)
    cases = [c for c in flash_cases() if not c[0].startswith("main path")]
    failures, entries = [], []
    for label, b, tq, tkv, h, d, causal, window in cases:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            q, k, v, do = (torch.randn((b, t, h, d), generator=gen,
                                       device="cuda").to(dtype)
                           for t in (tq, tkv, tkv, tq))
            kw = dict(causal=causal, window=window)
            out, lse = fa.flash_attention_fwd_reference(q, k, v, **kw)
            delta = fa._delta(out, do)
            args = (q, k, v, do, lse, delta)
            dk, dv = fa.flash_attention_bwd_dkdv(*args, **kw)
            dq = fa.flash_attention_bwd_dq(*args, **kw)
            ref_dq, ref_dk, ref_dv = fa.flash_attention_bwd_reference(
                q, k, v, out, lse, do, **kw)
            torch.cuda.synchronize()
            err = {"dkdv": max(float((dk - ref_dk).abs().max()),
                               float((dv - ref_dv).abs().max())),
                   "dq": float((dq - ref_dq).abs().max())}
            finite = all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv))
            ok = finite and max(err.values()) <= BWD_TOL[name]
            ms = {"dkdv": cuda_ms(
                      lambda: fa.flash_attention_bwd_dkdv(*args, **kw)),
                  "dq": cuda_ms(lambda: fa.flash_attention_bwd_dq(*args,
                                                                  **kw))}
            keep = fa._keep(tq, tkv, causal, window, device="cuda")
            scale = fa._scale(q, None)
            plain_ms = {"dkdv": cuda_ms(lambda: fa._dkdv(*args, keep, scale)),
                        "dq": cuda_ms(lambda: fa._dq(*args, keep, scale))}
            lib_ms = sdpa_backward_ms(q, k, v, do, causal, window)
            bound = fa.flash_bwd_bound(b, tq, tkv, h, d, dtype, causal=causal,
                                       window=window)
            for kern in ("dkdv", "dq"):
                print(f"flash_bwd_{kern} {label} {name}: "
                      f"max_abs_err={err[kern]:.3e} "
                      f"(tol {BWD_TOL[name]:.0e}) kernel_ms={ms[kern]:.5f} "
                      f"plain_ms={plain_ms[kern]:.5f} "
                      f"bound_ms={bound[kern]['bound_ms']:.6f} "
                      f"({bound[kern]['bound_by']}) "
                      f"{'ok' if ok else 'MISMATCH'} [{card}]")
            print(f"flash_bwd {label} {name}: B2+B3 kernel_ms="
                  f"{ms['dkdv'] + ms['dq']:.5f} sdpa_backward_ms={lib_ms:.5f}"
                  f" [{card}]")
            if not ok:
                failures.append(f"{label} {name}: err {err} finite {finite}")
            if label == train_case()[0] and dtype == torch.bfloat16:
                for kern, line in (("dkdv", 391), ("dq", 432)):
                    entries.append({
                        "name": f"flash_attention_bwd_{kern}",
                        "route": "cuda",
                        "source": "deeplearning4j_tpu_torch/kernels/csrc/"
                                  "flash_bwd.cu",
                        "replaces": "deeplearning4j_tpu/pallas/"
                                    f"flash_attention.py:{line}",
                        "launches": None,
                        "max_abs_err": err[kern],
                        "ms": ms[kern], "plain_ms": plain_ms[kern],
                        "bound_ms": bound[kern]["bound_ms"],
                        "bound_by": bound[kern]["bound_by"],
                        # one call computes B2 and B3 together
                        "library_ms": lib_ms,
                        "library_call": "F.scaled_dot_product_attention "
                                        "backward (dq, dk, dv)",
                        "shape": [b, tq, h, d], "dtype": name,
                    })
            del q, k, v, do, out, lse, delta, args, dq, dk, dv, keep
    if failures:
        raise AssertionError("flash backward kernels disagree with their "
                             "plain version: " + "; ".join(failures))
    return entries


# ---------------------------------------------------------------------------
# phase 5: train the slice's model
# ---------------------------------------------------------------------------
def launch_counts() -> dict:
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa

    return {"flash_attention_fwd": fa.flash_attention_fwd.launches,
            "flash_attention_bwd_dkdv": fa.flash_attention_bwd_dkdv.launches,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq.launches}


def reset_launch_counts() -> None:
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa

    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd_dkdv.launches = 0
    fa.flash_attention_bwd_dq.launches = 0


def train_tokens(batch: int = TRAIN_BATCH):
    import numpy as np

    return np.random.default_rng(0).integers(
        0, TRAIN_CFG["vocab_size"], (batch, TRAIN_T))


def train(card: str) -> dict:
    """Steps of the headline model; returns the kernels' launches over
    the timed steps."""
    import torch
    from deeplearning4j_tpu_torch.dtypes import tree_leaves
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM

    lm = TransformerLM(**TRAIN_CFG).init()
    impl = lm._attn_impl(TRAIN_T, train=True)
    if impl != "flash":
        raise AssertionError(f"attn_impl='auto' resolved to {impl!r} for "
                             "training, not 'flash'")
    tok = torch.as_tensor(train_tokens(), device="cuda")
    warm = [lm.fit_batch(tok) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, per_step, host = [], [], 0.0
    t0 = time.monotonic()
    for _ in range(TRAIN_STEPS):
        before = launch_counts()
        t = time.monotonic()
        losses.append(lm.fit_batch(tok, block=False))
        host += time.monotonic() - t
        per_step.append({k: n - before[k]
                         for k, n in launch_counts().items()})
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = launch_counts()
    losses = [float(x) for x in losses]
    ms_step = wall / TRAIN_STEPS * 1e3
    tps = TRAIN_BATCH * TRAIN_T * TRAIN_STEPS / wall
    fpt = lm.flops_per_token(TRAIN_T)
    print(f"train [{TRAIN_BATCH}, {TRAIN_T}] mixed_bf16 attn={impl}: "
          f"warmup_losses={warm} losses={losses} ms_per_step={ms_step} "
          f"host_ms_per_step={host / TRAIN_STEPS * 1e3} "
          f"tokens_per_sec={tps} flops_per_token={fpt} "
          f"share_of_bf16_peak={fpt * tps / H100_BF16_FLOPS} "
          f"peak_mem_bytes={torch.cuda.max_memory_allocated()} "
          f"launches={launches} [{card}]")
    if not all(math.isfinite(x) for x in warm + losses):
        raise AssertionError(f"non-finite loss: {warm + losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall on a repeated batch: "
                             f"{losses}")
    for i, counts in enumerate(per_step):
        if any(n != lm.num_layers for n in counts.values()):
            raise AssertionError(f"step {i} launched {counts}, expected "
                                 f"{lm.num_layers} of each kernel")
    for x in tree_leaves((lm.params, lm.opt_state)):
        if x.dtype != torch.float32 or x.requires_grad:
            raise AssertionError(f"a master or moment is {x.dtype} "
                                 f"(requires_grad={x.requires_grad})")
    return launches


def check_train_parity(card: str) -> None:
    """Flash against plain attention on the card at full width, batch 2,
    on the same weights."""
    import torch
    from deeplearning4j_tpu_torch.dtypes import tree_leaves, tree_map
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM

    torch.backends.cuda.matmul.allow_tf32 = False
    tok = torch.as_tensor(train_tokens(2), device="cuda")

    def pair(policy):
        flash = TransformerLM(**{**TRAIN_CFG, "dtype_policy": policy,
                                 "attn_impl": "flash"}).init()
        plain = TransformerLM(**{**flash.get_config(), "attn_impl": "xla"},
                              device=flash.device)
        plain.params = tree_map(torch.clone, flash.params)
        plain.opt_state = tree_map(torch.clone, flash.opt_state)
        return flash, plain

    # float32: one step's loss and gradients (tests/test_models.py gate)
    flash, plain = pair("float32")
    got = {}
    for name, lm in (("flash", flash), ("plain", plain)):
        fwd = tree_map(lambda p: p.detach().requires_grad_(), lm.params)
        leaves = tree_leaves(fwd)
        loss = lm.loss(fwd, tok, train=True)
        got[name] = (loss.detach(), torch.autograd.grad(loss, leaves))
    (lf, gf), (lp, gp) = got["flash"], got["plain"]
    err_loss = float((lf - lp).abs())
    excess = max(float(((a - b).abs() - (1e-3 + 2e-3 * b.abs())).max())
                 for a, b in zip(gf, gp))
    err_grad = max(float((a - b).abs().max()) for a, b in zip(gf, gp))
    ok32 = err_loss <= 1e-3 + 2e-3 * abs(float(lp)) and excess <= 0.0
    print(f"train parity float32 [2, {TRAIN_T}] flash vs plain: "
          f"loss {float(lf)} vs {float(lp)} grad_max_abs_err={err_grad:.3e}"
          f" (rtol 2e-3, atol 1e-3) {'ok' if ok32 else 'MISMATCH'} [{card}]")
    del flash, plain, got, gf, gp

    # mixed_bf16: loss and params after 3 steps
    flash, plain = pair("mixed_bf16")
    la = [flash.fit_batch(tok) for _ in range(3)]
    lb = [plain.fit_batch(tok) for _ in range(3)]
    err_l = max(abs(a - b) for a, b in zip(la, lb))
    err_p = max(float((a - b).abs().max()) for a, b in
                zip(tree_leaves(flash.params), tree_leaves(plain.params)))
    okbf = err_l <= 2e-2 and err_p <= 1e-2
    print(f"train parity mixed_bf16 [2, {TRAIN_T}] 3 steps flash vs plain: "
          f"losses {la} vs {lb} loss_err={err_l:.3e} (tol 2e-2) "
          f"param_err={err_p:.3e} (tol 1e-2) "
          f"{'ok' if okbf else 'MISMATCH'} [{card}]")
    if not (ok32 and okbf):
        raise AssertionError("flash training disagrees with the plain "
                             "attention path")


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    sys.path.insert(0, HERE)
    try:
        from deeplearning4j_tpu_torch.kernels import KERNEL_SOURCES, _build
    except ImportError as e:
        fail(f"the port package is not beside this script: {e}")

    failed = []
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    t0 = time.monotonic()
    try:
        _build.build_all(KERNEL_SOURCES)
        print(f"build: {len(KERNEL_SOURCES)} kernel(s) in "
              f"{time.monotonic() - t0:.1f} s [{card}]")
    except Exception:
        traceback.print_exc()
        fail("kernel build failed")

    entries = {}
    serve_launches, train_launches = None, None
    for phase in ("flash", "flash_bwd", "serve", "train"):
        try:
            if phase == "flash":
                entries["flash_attention_fwd"] = check_flash(card)
            elif phase == "flash_bwd":
                for e in check_flash_bwd(card):
                    entries[e["name"]] = e
            elif phase == "serve":
                reset_launch_counts()
                serve_launches = serve(card)
                if launch_counts()["flash_attention_bwd_dkdv"] or \
                        launch_counts()["flash_attention_bwd_dq"]:
                    raise AssertionError("serving launched a backward "
                                         "kernel")
            else:
                train_launches = train(card)
                check_train_parity(card)
        except Exception:
            traceback.print_exc()
            failed.append(phase)
        torch.cuda.empty_cache()
    if failed:
        fail(f"phase(s) failed: {', '.join(failed)}")
    for name, e in entries.items():
        e["launches"] = train_launches[name]
        if not e["launches"]:
            fail(f"{name} was not launched on the train path")
    entries["flash_attention_fwd"]["launches_serve"] = serve_launches
    print(json.dumps({"kernels": list(entries.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
