#!/usr/bin/env python3
"""Chip smoke for the PyTorch/H100 port (``deeplearning4j_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Three phases; any failure exits non-zero and prints no result line.

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
   calls, and the H100 bound.
3. Serve: the d512·L8·H8 ``TransformerLM`` (vocab 8192, d_ff 2048,
   learned positions, max_len 1024, ``mixed_bf16``, ``attn_impl="flash"``,
   random weights from seed 0) first has its logits on a 77-token prompt
   held against the same weights on the CPU (5e-2); then, behind
   ``DecodeServer(slots=8, max_len=1024)``, it answers a seeded Poisson
   stream of ragged greedy requests (prompts 20–900 tokens, 16–64 new)
   at ``fuse_steps`` 1 and 4.
   Asserts that the flash kernel ran ``num_layers`` times per prefill,
   that every stream equals the port's own ``lm.generate`` on the same
   prompt, and that both settings give the same streams.

Output: metric lines, then a ``{"kernels": [...]}`` JSON line and the
``nvidia-smi`` line, then ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import json
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
              ("head_dim 128 b=2 P=513", 2, 513, 513, 4, 128, True, None)]
    rungs = sorted({prompt_bucket(n, max_len=SERVE_MAX_LEN)
                    for n in SERVE_PROMPT_LENS})
    cases += [(f"main path P={p}", 1, p, p, SERVE_CFG["num_heads"],
               SERVE_CFG["d_model"] // SERVE_CFG["num_heads"], True, None)
              for p in rungs]
    return cases


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

    entry = None
    for phase in ("flash", "serve"):
        try:
            if phase == "flash":
                entry = check_flash(card)
            else:
                launches = serve(card)
                if entry is not None:
                    entry["launches"] = launches
        except Exception:
            traceback.print_exc()
            failed.append(phase)
    if failed:
        fail(f"phase(s) failed: {', '.join(failed)}")
    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
