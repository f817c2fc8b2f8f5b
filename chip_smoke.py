#!/usr/bin/env python3
"""Chip smoke for the PyTorch/H100 port (``deeplearning4j_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Eight phases; any failure exits non-zero and prints no result line.

1. Build and device: compile every CUDA kernel from ``csrc/`` (one
   ``nvcc`` per source, all at once), print ptxas's registers and spill
   bytes for each kernel, and the card's name and power limit from
   ``nvidia-smi``.
2. Kernels against their plain versions on the card: the flash-attention
   forward (f32 and bf16; causal prompts of 1, 5, 16, 17, 37, 63, 512
   and 1000 tokens, windows of 1, 65 and 128 at 1000, non-causal
   tq=300/tkv=700 and tq=5/tkv=130, head_dim 128 at b=2 P=513 and at
   P=1000, the training shape [16, 1024, 8, 64], and every prefill shape
   of the serve phase) against ``flash_attention_fwd_reference`` with
   TF32 off, at f32 2e-5 and bf16 2e-2 on out and lse. The short and
   windowed cases put sequence ends and mask edges inside one 16-row MMA
   tile and one zero-filled ``cp.async`` row. Prints each kernel's
   variant ("mma.sync bf16" or "fma f32") and time beside the plain
   version's, ``F.scaled_dot_product_attention`` as a yardstick the port
   never calls, and the H100 bound; asserts that two launches at the
   training shape give bitwise identical outputs. Times are CUDA events
   over 20 launches queued behind a sleep kernel (``cuda_ms``), so small
   shapes show the card's time and not the host's launch rate.
3. Flash backward: the dk/dv kernel (B2) and the dq kernel (B3) against
   their plain versions on the card with TF32 off, on the forward
   phase's cases and the training shape, in f32 (1e-4) and bf16 (2e-2)
   on dq, dk and dv. Prints each kernel's variant and time, the plain
   version's, the bound and the backward of
   ``F.scaled_dot_product_attention`` (B2 and B3 together), a yardstick
   the port never calls; asserts that two launches of B2 and of B3 at the
   training shape give bitwise identical gradients.
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
   steps on one seeded ``[16, 1024]`` batch under ``mixed_bf16``; the
   first warm-up step runs eagerly, the second captures the step as a
   CUDA graph, and every later step is a replay with B1–B3 inside it.
   Asserts finite, falling losses, B1, B2 and B3 each launched
   ``num_layers`` times per step (counted as the launches that ran:
   ``perf.step_graph.kernel_launches``, replays included; one more
   replayed step under ``torch.profiler`` must show the card running as
   many of each kernel as that count says), and f32 masters and Adam
   moments;
   prints ms/step, host time per step, tokens/s and the share of the
   bf16 peak. Holds the training unembedding (bf16 GEMMs with f32
   output) against the f32 product of its widened operands at the step's
   shape (logits 1e-4, gradients 2e-2 of their largest magnitude) and
   prints its time beside the f64 decode unembedding's. Then, at full
   width and batch 2, holds the flash path against the plain-attention
   path on the same weights: one step's loss and gradients under
   ``float32`` (rtol 2e-3, atol 1e-3) and the loss and params after 3
   steps under ``mixed_bf16`` (2e-2, 1e-2).
6. Networks: LeNet-5 at ``[1024, 28, 28, 1]`` and the MNIST MLP
   (784-256-256-10) at ``[4096, 784]`` through ``MultiLayerNetwork``,
   and ResNet-18 (11,176,970 params, 20 convolutions, 20 BatchNorms, 8
   residual adds) at ``[256, 32, 32, 3]`` through ``ComputationGraph``,
   the sizes of ``bench.py``'s ``bench_lenet``, ``bench_mlp`` and
   ``bench_resnet18``, built by the port's zoo on the config DSL and
   trained under ``bf16`` with Adam on one seeded batch placed on the
   card once: 2 warm-up and 20 timed ``fit`` calls (ResNet-18: 10), then
   ``fit_steps(ds, 10)`` twice (replays of a captured step; the first
   call's time includes the warm-up step and the capture). Asserts
   finite, falling losses; prints
   ms per step, host ms per step and samples/s for ``fit`` and
   ``fit_steps``, the peak of allocated device memory, and for ResNet-18
   the share of the bf16 peak (3 × 1.11 GFLOP a sample, bench.py's
   count). ``evaluate`` with the confusion matrix on the card equals the
   host path, with one readback. At batch 64 (ResNet-18: 8) the card is
   held against the CPU on the same weights: one step's loss, gradients
   and new BatchNorm running statistics under ``float32`` with TF32 off
   (rtol 2e-3, atol 1e-3), the loss and params (1e-2) and each
   BatchNorm's running statistics (1e-2 plus 2e-2 of the layer's largest)
   after 3 steps under ``bf16``
   (ResNet-18 at lr 1e-4: see ``NET_PARITY_LR``). The phase runs cuDNN,
   cuBLAS and eager torch, and asserts that it launched none of B1–B3.
7. Recurrent: the char-LSTM (two GravesLSTM layers of 256 with
   peepholes, ``RnnOutputLayer`` over 128 characters, truncated BPTT in
   windows of 50) at ``bench.py``'s ``bench_char_lstm`` size, batch 128 ×
   t 200 of seeded one-hot characters on the card once, ``bf16``, Adam:
   one warm-up and 5 timed ``fit`` calls (4 windows, so 4 steps, each;
   the full windows replay a captured window step, the warm-up ``fit``
   running the first eagerly and capturing it).
   Asserts finite losses, a falling last-window loss and the iteration
   count; prints ms and host ms per ``fit``, samples/s, tokens/s, the
   share of the bf16 peak (3 × 1.90 MFLOP a token, from the widths) and
   peak allocated memory. Then ``rnn_time_step`` one character at a time
   for 200 steps at batch 128 against the full ``output`` (bf16 2e-2 on
   the softmax outputs), with ms a step. At batch 8 the card is held
   against the CPU: float32 with TF32 off, the first window's loss,
   gradients and carried state, and the loss and params after one whole
   ``fit`` (rtol 2e-3, atol 1e-3); ``bf16`` after one ``fit`` at the
   zoo's lr (loss 2e-2, params 1e-2); float32 stepwise generation at
   1e-4. The phase runs cuBLAS and eager torch and asserts that it
   launched none of B1–B3.
8. Fused: every fused training path as CUDA-graph replays, each against
   the same run eagerly (``perf.step_graph._capture`` off: the same steps,
   the same order and generator seed; ``torch.equal`` on params, updater
   state, net state and the loss history), with ms and host ms (the time
   to return), and under ``torch.profiler`` the host's launch calls by
   CUDA API (``cudaGraphLaunch`` being a replay), the card's events, busy
   time and idle share. The epoch and ``fit_steps`` cells print the peak
   allocated memory and what stays resident (live tensors and graph pools,
   cached blocks released) of each run. The epoch cell is ``bench.py``'s
   ``bench_epoch``: the MNIST MLP (hidden 256, ``bf16``), 16 batches of
   2048 x 784 from ``default_rng(0)``, 5 epochs by streaming ``fit`` and
   by ``fit_epochs`` with chunks of 1 and of 5 epochs (samples/s, replays
   and other launches per epoch). The guard cell poisons batch 5 with a
   NaN row: under ``skip`` the sentinel trips once an epoch, at that
   batch's place in each epoch's order, and params stay finite; on clean
   data ``off`` and ``skip`` are bitwise equal; ``raise`` names the batch.
   ``fit_steps`` cells: LeNet-5 at ``[1024, 28, 28, 1]`` and ResNet-18 at
   ``[256, 32, 32, 3]`` (BatchNorm state under replay), ``bf16``, 2 + 10
   steps. The char-LSTM cell: phase 7's ``fit``, 5 timed. The LM cell: the
   train phase's model, ``fit_batch_multi`` with a captured step (k 4, 3
   timed calls); B1–B3 must launch ``num_layers`` times a step under
   replay and eagerly, and one more call under ``torch.profiler`` must
   show the card running what the count says. The programs cell runs six
   fused calls of five keys on one ResNet-18 at ``[256, 32, 32, 3]``, 4
   batches (``fit_epochs`` under ``skip``, ``off``, telemetry and in
   order, ``fit_steps``, then the first key again) against the same calls
   eagerly, bitwise, printing the resident memory after each; its graphs
   share one pool, and dropping the cache frees it while the network keeps
   its programs. Then the card's fused runs against the CPU's at the
   earlier gates: ``fit_epochs`` of the MLP (4 batches of 64, 2 epochs in
   order) under float32 with TF32 off (rtol 2e-3, atol 1e-3) and ``bf16``
   (loss 2e-2, params 1e-2), and ``fit_steps(ds, 3)`` of LeNet-5 and
   ResNet-18 at phase 6's parity batches under ``bf16`` (ResNet-18 at
   ``NET_PARITY_LR``).

Output: metric lines, then a ``{"kernels": [...]}`` JSON line (each
kernel's ``variant`` and ``launches`` counted over the train phase's
timed steps, replays included; over phase 8's LM cell as
``launches_fused_lm``; B1's over the serve phase too, as
``launches_serve``, and its train-shape numbers under ``train``) and
the ``nvidia-smi`` line,
then ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import json
import math
import os
import re
import contextlib
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
# the kernels whose bf16 launches run on the tensor cores (csrc/ notes);
# every f32 launch runs the FMA kernels
MMA_BF16 = ("fwd", "dkdv", "dq")


def variant(kernel: str, dtype: str) -> str:
    """The CUDA kernel a wrapper launches: "mma.sync bf16" or "fma f32"."""
    return ("mma.sync bf16" if dtype == "bfloat16" and kernel in MMA_BF16
            else "fma f32")


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


def ptxas_lines(log: str):
    """One line per kernel from ``nvcc -Xptxas=-v`` output: its mangled
    name, registers and spill bytes."""
    name, spill, out = None, "", []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif "spill stores" in line:
            spill = line.strip()
        else:
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                out.append(f"{name}: {m.group(1)} registers, {spill}")
                name, spill = None, ""
    return out


def same_twice(fn) -> bool:
    """Whether two launches of ``fn()`` (a tensor or a tuple of them)
    give bitwise identical outputs."""
    import torch

    a, b = fn(), fn()
    if isinstance(a, torch.Tensor):
        a, b = (a,), (b,)
    return all(torch.equal(x, y) for x, y in zip(a, b))


_SLEEP_CYCLES_PER_MS = []


def sleep_cycles_per_ms() -> float:
    """Cycles of ``torch.cuda._sleep`` per ms on this card (measured once)."""
    import torch

    if not _SLEEP_CYCLES_PER_MS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(10 ** 7)
        end.record()
        torch.cuda.synchronize()
        _SLEEP_CYCLES_PER_MS.append(10 ** 7 / start.elapsed_time(end))
    return _SLEEP_CYCLES_PER_MS[0]


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events).
    The timed launches are queued behind a sleep kernel twice as long as
    the host took to issue as many in the warm-up, so the card runs them
    back to back: at small shapes this is the kernel's time, not the
    host's launch rate."""
    import torch

    t = time.perf_counter()
    for _ in range(iters):  # warm-up, and the host's time to issue
        fn()
    host_ms = (time.perf_counter() - t) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2 * host_ms * sleep_cycles_per_ms()))
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

    # P=1, 5, 17, 63, tq=5/tkv=130 and w=1/65 put sequence ends and mask
    # edges inside one 16-row MMA tile and one 16-byte cp.async chunk row
    cases = [(f"causal P={p}", 1, p, p, 8, 64, True, None)
             for p in (1, 5, 16, 17, 37, 63, 512, 1000)]
    cases += [(f"windowed P=1000 w={w}", 1, 1000, 1000, 8, 64, True, w)
              for w in (1, 65, 128)]
    cases += [("non-causal tq=300 tkv=700", 1, 300, 700, 8, 64, False, None),
              ("non-causal tq=5 tkv=130", 1, 5, 130, 8, 64, False, None),
              ("head_dim 128 b=2 P=513", 2, 513, 513, 4, 128, True, None),
              ("head_dim 128 P=1000", 1, 1000, 1000, 8, 128, True, None),
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
    failures, entry, train = [], None, None
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
            print(f"flash_fwd {label} {name} [{variant('fwd', name)}]: "
                  f"max_abs_err={err:.3e} "
                  f"(tol {TOL[name]:.0e}) kernel_ms={ms:.5f} "
                  f"plain_ms={plain_ms:.5f} library_ms={lib_ms:.5f} "
                  f"bound_ms={bound['bound_ms']:.6f} ({bound['bound_by']}) "
                  f"{'ok' if ok else 'MISMATCH'} [{card}]")
            if not ok:
                failures.append(f"{label} {name}: err {err} finite {finite}")
            if label == train_case()[0] and dtype == torch.bfloat16:
                same = same_twice(lambda: fa.flash_attention_fwd(q, k, v,
                                                                 **kw))
                print(f"flash_fwd {label} {name}: two launches bitwise "
                      f"identical: {same} [{card}]")
                if not same:
                    failures.append(f"{label} {name}: two launches differ")
                train = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": bound["bound_ms"],
                         "bound_by": bound["bound_by"], "max_abs_err": err,
                         "shape": [b, tq, h, d]}
            if label == flash_cases()[-1][0] and dtype == torch.bfloat16:
                entry = {
                    "name": "flash_attention_fwd",
                    "route": "cuda",
                    "variant": variant("fwd", name),
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
    entry["train"] = train  # the same kernel at the train step's shape
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
                print(f"flash_bwd_{kern} {label} {name} "
                      f"[{variant(kern, name)}]: "
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
                for kern, fn in (("dkdv", fa.flash_attention_bwd_dkdv),
                                 ("dq", fa.flash_attention_bwd_dq)):
                    same = same_twice(lambda: fn(*args, **kw))
                    print(f"flash_bwd_{kern} {label} {name}: two launches "
                          f"bitwise identical: {same} [{card}]")
                    if not same:
                        failures.append(f"{label} {name}: two {kern} "
                                        "launches differ")
                for kern, line in (("dkdv", 391), ("dq", 432)):
                    entries.append({
                        "name": f"flash_attention_bwd_{kern}",
                        "route": "cuda",
                        "variant": variant(kern, name),
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
    """B1–B3's launches that ran on the card: the wrappers' counts, less
    the launches a CUDA-graph capture recorded, plus what replays ran
    (``perf.step_graph.kernel_launches``)."""
    from deeplearning4j_tpu_torch.perf import step_graph

    return step_graph.kernel_launches()


def reset_launch_counts() -> None:
    from deeplearning4j_tpu_torch.perf import step_graph

    step_graph.reset_kernel_launches()


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
    traced = traced_launches(lambda: lm.fit_batch(tok),
                             "train fit_batch, one replayed step", card)
    if any(n != lm.num_layers for n in traced.values()):
        raise AssertionError(f"the traced step launched {traced}")
    check_train_unembedding(lm, card)
    return launches


def unembed_inputs(lm, rows: int):
    """``(params, h, g)`` for the unembedding at a train step's shape: the
    step's compute-dtype copy of ``embed`` (requiring grad) and ``ln_f``,
    a seeded hidden state of ``rows`` rows in the compute dtype
    (requiring grad) and an f32 upstream gradient, on the card."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(99)
    params = lm.policy.compute_copy({"embed": lm.params["embed"],
                                     "ln_f": lm.params["ln_f"]})
    params["embed"] = params["embed"].detach().requires_grad_()
    h = torch.randn((rows, lm.d_model), device="cuda", generator=gen).to(
        lm.policy.compute_dtype).requires_grad_()
    g = torch.randn((rows, lm.vocab_size), device="cuda", generator=gen)
    return params, h, g


def unembed_ms(lm, rows: int, *, train: bool, iters: int = 10) -> float:
    """Forward and backward of the training unembedding
    (``lm._unembed_train``: bf16 products, f32 sums) or, with
    ``train=False``, of the decode one (``lm._unembed``: f64 sums) on
    :func:`unembed_inputs` (CUDA events)."""
    import torch

    params, h, g = unembed_inputs(lm, rows)
    fn = lm._unembed_train if train else lm._unembed
    return cuda_ms(lambda: torch.autograd.grad(
        fn(params, h), (h, params["embed"]), g), iters=iters)


def mm_dtype_differentiates() -> bool:
    """Whether this torch can differentiate ``torch.mm(...,
    out_dtype=torch.float32)`` by itself (the port does not rely on it:
    ``_UnembedBF16`` writes the backward)."""
    import torch

    a = torch.ones((16, 16), device="cuda", dtype=torch.bfloat16,
                   requires_grad=True)
    try:
        torch.mm(a, a, out_dtype=torch.float32).sum().backward()
    except RuntimeError:
        return False
    return True


def check_train_unembedding(lm, card: str) -> None:
    """The training unembedding on the card (bf16 GEMMs with f32 output)
    against its plain version at the train step's shape: the f32 product
    of the same operands widened to f32 with TF32 off, under autograd.
    Logits within 1e-4 (exact products, f32 sums in two orders, logits
    of magnitude < 3 here); gradients within 2e-2 of their largest
    magnitude, the forward's bf16 gate (both sides round each gradient
    to bf16, one ulp apart at most, 2^-8; the card's side also rounds the
    upstream gradient to bf16 before the backward products). Prints its
    time and the decode unembedding's (f64 sums), which training ran
    before."""
    import torch
    from deeplearning4j_tpu_torch.models.transformer import _layernorm

    torch.backends.cuda.matmul.allow_tf32 = False
    n = TRAIN_BATCH * TRAIN_T
    params, h, g = unembed_inputs(lm, n)
    e = params["embed"]
    got = lm._unembed_train(params, h)
    got_grads = torch.autograd.grad(got, (h, e), g)
    hf = _layernorm(h, params["ln_f"]["g"], params["ln_f"]["b"])
    want = hf.float() @ e.float().T
    want_grads = torch.autograd.grad(want, (h, e), g)
    err = float((got - want).detach().abs().max())
    grad_err = max(float((a.float() - b.float()).abs().max())
                   / float(b.float().abs().max())
                   for a, b in zip(got_grads, want_grads))
    ok = got.dtype == torch.float32 and err <= 1e-4 and grad_err <= 2e-2
    train_ms = unembed_ms(lm, n, train=True)
    decode_ms = unembed_ms(lm, n, train=False)
    print(f"train unembedding [{n}, {lm.d_model}] x [{lm.vocab_size}, "
          f"{lm.d_model}] bf16 -> f32 vs widened f32: max_abs_err={err:.3e} "
          f"(tol 1e-4) grad_rel_err={grad_err:.3e} (tol 2e-2) "
          f"fwd_bwd_ms={train_ms:.5f} decode_f64_fwd_bwd_ms={decode_ms:.5f} "
          f"mm_dtype_differentiates={mm_dtype_differentiates()} "
          f"{'ok' if ok else 'MISMATCH'} [{card}]")
    if not ok:
        raise AssertionError("the training unembedding disagrees with its "
                             "plain version")


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


# ---------------------------------------------------------------------------
# phase 6: the DL4J network surface (MultiLayerNetwork on the zoo models)
# ---------------------------------------------------------------------------
# bench.py's sizes for its network benches: bench_lenet (batch 1024),
# bench_mlp (batch 4096, hidden 256) and bench_resnet18 (batch 256), all
# under dtype "bf16"
NETWORKS = {"lenet5": (1024, (28, 28, 1)), "mnist_mlp": (4096, (784,)),
            "resnet18": (256, (32, 32, 3))}
NET_WARMUP, NET_FUSED, NET_FUSED_REPEATS = 2, 10, 2
NET_STEPS = {"lenet5": 20, "mnist_mlp": 20, "resnet18": 10}  # timed fits
# the card against the CPU; the full-width ResNet-18 steps on the CPU too
NET_PARITY_BATCH = {"lenet5": 64, "mnist_mlp": 64, "resnet18": 8}
# Adam's first step moves every weight by about ±lr whatever its
# gradient's size, so a gradient element whose bf16 rounding differs
# between the card and the CPU moves that weight 2·lr apart. Batch 8 of
# ResNet-18 is learnt in one step; at the zoo's lr of 1e-3 its running
# statistics then differ between bf16 and float32 on the CPU alone by
# more than a gate that could tell a fault from rounding allows (the
# phase prints both figures); at 1e-4 they do not.
NET_PARITY_LR = {"resnet18": 1e-4}
# forward FLOPs per sample as bench.py counts them (bench_resnet18's
# analytic CIFAR ResNet-18 figure); a training step is taken as 3x
NET_FWD_FLOPS = {"resnet18": 1.11e9}


def network_data(name: str, batch: int):
    """bench.py's inputs: ``np.random.default_rng(0)`` draws in [0, 1) and
    one-hot labels over 10 classes."""
    import numpy as np

    rng = np.random.default_rng(0)
    x = rng.random((batch,) + NETWORKS[name][1], np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, batch)]
    return x, y


def build_network(name: str, policy: str, device: str, **kw):
    """A zoo network at the bench's widths (a ``MultiLayerNetwork``, or for
    ResNet-18 a ``ComputationGraph``), initialised from seed 12345 (the
    same weights on every device: ``init`` draws on a CPU generator)."""
    from deeplearning4j_tpu_torch.models import zoo

    if name == "mnist_mlp":
        kw["hidden"] = 256
    return getattr(zoo, name)(dtype_policy=policy, device=device, **kw).init()


def flat(tree):
    """A tree of tensors (a network's params or its net state, which holds
    BatchNorm's running statistics) as one float32 numpy vector."""
    import numpy as np
    from deeplearning4j_tpu_torch.dtypes import tree_leaves

    return np.concatenate([np.zeros(0, np.float32)] + [
        t.detach().float().cpu().numpy().ravel() for t in tree_leaves(tree)])


def train_network(name: str, card: str) -> None:
    """Warm-up, timed ``fit`` and ``fit_steps`` calls at the bench's batch
    under ``bf16``, on one batch placed on the card once."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet

    batch = NETWORKS[name][0]
    steps = NET_STEPS[name]
    net = build_network(name, "bf16", "cuda")
    x, y = network_data(name, batch)
    ds = DataSet(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warm = []
    for _ in range(NET_WARMUP):
        net.fit(ds)
        warm.append(net.score_value)
    torch.cuda.synchronize()
    scores, host = [], 0.0
    t0 = time.monotonic()
    for _ in range(steps):
        t = time.monotonic()
        net.fit(ds)
        host += time.monotonic() - t
        scores.append(net._score)  # a device scalar: no sync per step
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    losses = [float(v) for v in scores]
    fused = []
    for _ in range(NET_FUSED_REPEATS):
        t = time.monotonic()
        net.fit_steps(ds, NET_FUSED)
        f_host = time.monotonic() - t
        torch.cuda.synchronize()
        fused.append((time.monotonic() - t, f_host, net.score_value))
    peak_mem = torch.cuda.max_memory_allocated()
    f_wall = sum(f[0] for f in fused)
    f_host = sum(f[1] for f in fused)
    f_steps = NET_FUSED * NET_FUSED_REPEATS
    sps, f_sps = batch * steps / wall, batch * f_steps / f_wall
    peak_share = ""
    if name in NET_FWD_FLOPS:
        step_flops = 3 * NET_FWD_FLOPS[name]
        peak_share = (f"share_of_bf16_peak={step_flops * sps / H100_BF16_FLOPS}"
                      f" (fit_steps {step_flops * f_sps / H100_BF16_FLOPS}) ")
    print(f"networks {name} [{batch}, {', '.join(map(str, NETWORKS[name][1]))}] "
          f"bf16: warmup_losses={warm} losses={losses} "
          f"fit: ms_per_step={wall / steps * 1e3} "
          f"host_ms_per_step={host / steps * 1e3} "
          f"samples_per_sec={sps} "
          f"fit_steps({NET_FUSED}) x{NET_FUSED_REPEATS}: "
          f"ms_per_step={f_wall / f_steps * 1e3} "
          f"host_ms_per_step={f_host / f_steps * 1e3} "
          f"samples_per_sec={f_sps} {peak_share}"
          f"peak_mem_bytes={peak_mem} "
          f"fused_losses={[f[2] for f in fused]} "
          f"iterations={net.iteration_count} [{card}]")
    every = warm + losses + [f[2] for f in fused]
    if not all(math.isfinite(v) for v in every):
        raise AssertionError(f"{name}: non-finite loss: {every}")
    if not (losses[-1] < losses[0] and fused[-1][2] < losses[-1]):
        raise AssertionError(f"{name}: loss did not fall on a repeated "
                             f"batch: {every}")
    if net.iteration_count != NET_WARMUP + steps + f_steps:
        raise AssertionError(f"{name}: {net.iteration_count} iterations")
    check_network_evaluate(name, net, ds, card)


def check_network_evaluate(name: str, net, ds, card: str) -> None:
    """``evaluate`` with the confusion matrix on the card equals the host
    path (every batch's outputs read back), over ragged batches of 1000."""
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator

    it = ListDataSetIterator(ds, batch_size=1000)
    before = net._eval_readbacks
    dev = net.evaluate(it, device_accumulation=True).confusion.to_array()
    host = net.evaluate(it, device_accumulation=False).confusion.to_array()
    same = (dev == host).all() and int(dev.sum()) == ds.num_examples()
    print(f"networks evaluate {name}: device "
          f"confusion == host confusion: {bool(same)} "
          f"(readbacks {net._eval_readbacks - before}) [{card}]")
    if not same or net._eval_readbacks - before != 1:
        raise AssertionError("device evaluate disagrees with the host path")


def check_network_parity(name: str, card: str) -> None:
    """The card against the CPU on the same weights (batch 64; ResNet-18
    8): one step's loss and gradients under float32 with TF32 off (rtol
    2e-3, atol 1e-3), and the loss, params and BatchNorm running
    statistics after 3 ``fit`` steps under ``bf16`` (2e-2, 1e-2), the
    train phase's gates."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.dtypes import tree_leaves
    from deeplearning4j_tpu_torch.nn import ComputationGraph

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pbatch = NET_PARITY_BATCH[name]
    x, y = network_data(name, pbatch)

    def on(device, policy, **kw):
        net = build_network(name, policy, device, **kw)
        return (net, torch.from_numpy(x).to(device),
                torch.from_numpy(y).to(device))

    got = {}
    for device in ("cuda", "cpu"):
        net, xd, yd = on(device, "float32")
        if isinstance(net, ComputationGraph):
            xd, yd = [xd], [yd]
        loss, (state, _), grads = net._loss_grads(net.params, net.net_state,
                                                  xd, yd)
        got[device] = (loss.cpu(), [g.cpu() for g in tree_leaves(grads)]
                       + [s.cpu() for s in tree_leaves(state)],
                       flat(net.params))
    (lc, gc, pc), (lh, gh, ph) = got["cuda"], got["cpu"]
    if not (pc == ph).all():
        raise AssertionError(f"{name}: the card and the CPU drew other "
                             "weights from one seed")
    excess = max(float(((a - b).abs() - (1e-3 + 2e-3 * b.abs())).max())
                 for a, b in zip(gc + [lc], gh + [lh]))
    err_grad = max(float((a - b).abs().max()) for a, b in zip(gc, gh))
    ok32 = excess <= 0.0
    print(f"networks parity {name} float32 [{pbatch}] card vs cpu: "
          f"loss {float(lc)} vs {float(lh)} grad_and_new_stats_max_abs_err="
          f"{err_grad:.3e} (rtol 2e-3, atol 1e-3) "
          f"{'ok' if ok32 else 'MISMATCH'} [{card}]")

    def three_steps(device, policy, **kw):
        net, xd, yd = on(device, policy, **kw)
        losses = []
        for _ in range(3):
            net.fit(DataSet(xd, yd))
            losses.append(net.score_value)
        return (losses, flat(net.params),
                [flat(st) for st in net.net_state.values() if st])

    def stats_err(a, b):
        return max((float(abs(x - y).max()) for x, y in zip(a[2], b[2])),
                   default=0.0)

    lr = NET_PARITY_LR.get(name)
    kw = {} if lr is None else {"lr": lr}
    (la, pa, sa), (lb, pb, sb) = (three_steps(d, "bf16", **kw)
                                  for d in ("cuda", "cpu"))
    err_l = max(abs(a - b) for a, b in zip(la, lb))
    err_p = float(abs(pa - pb).max())
    # a BatchNorm's running statistics are sums of bf16-rounded conv
    # outputs: their rounding scales with the largest of the layer's
    # statistics (running variances reach a few units), so each layer's
    # are held at atol 1e-2 plus rtol 2e-2 of that largest value
    err_s = stats_err((la, pa, sa), (lb, pb, sb))
    excess_s = max((float(abs(a - b).max() - 1e-2 - 2e-2 * abs(b).max())
                    for a, b in zip(sa, sb)), default=0.0)
    okbf = err_l <= 2e-2 and err_p <= 1e-2 and excess_s <= 0.0
    print(f"networks parity {name} bf16 [{pbatch}] 3 steps card vs "
          f"cpu{'' if lr is None else f' (lr {lr})'}: losses {la} vs {lb} "
          f"loss_err={err_l:.3e} (tol 2e-2) "
          f"param_err={err_p:.3e} (tol 1e-2) "
          f"running_stats_max_abs_err={err_s:.3e} of largest "
          f"{max((float(abs(b).max()) for b in sb), default=0.0):.3e} "
          f"(atol 1e-2 + 2e-2 x a layer's largest) "
          f"{'ok' if okbf else 'MISMATCH'} [{card}]")
    if lr is not None:
        # why the gate runs at that lr: at the zoo's, rounding alone
        # moves the running statistics past it (NET_PARITY_LR)
        card_bf, cpu_bf, cpu_32 = (three_steps(d, p) for d, p in (
            ("cuda", "bf16"), ("cpu", "bf16"), ("cpu", "float32")))
        print(f"networks parity {name} [{pbatch}] 3 steps at the zoo's lr, "
              f"not gated: running_stats_max_abs_err bf16 card vs cpu "
              f"{stats_err(card_bf, cpu_bf):.3e}, bf16 vs float32 on the "
              f"cpu {stats_err(cpu_bf, cpu_32):.3e}, of largest "
              f"{max(float(abs(b).max()) for b in cpu_32[2]):.3e}; "
              f"param_max_abs_err {float(abs(card_bf[1] - cpu_bf[1]).max()):.3e}"
              f" and {float(abs(cpu_bf[1] - cpu_32[1]).max()):.3e} [{card}]")
    if not (ok32 and okbf):
        raise AssertionError(f"{name} on the card disagrees with the CPU")


def networks(card: str) -> None:
    """Phase 6: LeNet-5 and the MNIST MLP through ``MultiLayerNetwork``,
    ResNet-18 through ``ComputationGraph``. The path is cuDNN, cuBLAS and
    eager torch: it must launch none of the flash kernels."""
    reset_launch_counts()
    for name in NETWORKS:
        train_network(name, card)
        check_network_parity(name, card)
    if any(launch_counts().values()):
        raise AssertionError(f"the networks phase launched a flash kernel: "
                             f"{launch_counts()}")


# ---------------------------------------------------------------------------
# phase 7: the recurrent path (the char-LSTM with truncated BPTT)
# ---------------------------------------------------------------------------
# bench.py's bench_char_lstm (bench.py:320-341), nothing cut: vocab 128,
# two GravesLSTM layers of 256, TBPTT windows of 50, batch 128 x t 200,
# under "bf16" with Adam at the zoo's lr 3e-3; 4 windows, so 4 steps a fit
RNN_CFG = dict(vocab_size=128, hidden=256, layers=2, tbptt_length=50,
               seed=12345)
RNN_BATCH, RNN_T = 128, 200
RNN_WARMUP, RNN_FITS = 1, 5
RNN_PARITY_BATCH = 8
# generation: stepwise against the full forward. bf16 rounds the second
# layer's input GEMM over [128, 256] rows per step and over [25600, 256]
# in one go; cuBLAS may sum each in another order, so bf16's gate holds
# the softmax outputs; float32 with TF32 off holds them at 1e-4
RNN_GEN_TOL = {"bf16": 2e-2, "float32": 1e-4}


def char_lstm_data(batch: int):
    """bench.py's draw: ``np.random.default_rng(0)`` character ids, one-hot
    ``x`` and ``y`` = ``x`` one step ahead (rolled)."""
    import numpy as np

    vocab = RNN_CFG["vocab_size"]
    idx = np.random.default_rng(0).integers(0, vocab, (batch, RNN_T))
    eye = np.eye(vocab, dtype=np.float32)
    return eye[idx], eye[np.roll(idx, -1, axis=1)]


def char_lstm_flops_per_token() -> int:
    """Forward FLOPs a token from the widths: each GravesLSTM layer's input
    and recurrent GEMMs, 2·(n_in + h)·4h, and the output layer's 2·h·vocab
    (1.90 MFLOP at the bench's widths; a training step is taken as 3x)."""
    v, h = RNN_CFG["vocab_size"], RNN_CFG["hidden"]
    n_in, flops = v, 2 * h * v
    for _ in range(RNN_CFG["layers"]):
        flops += 2 * (n_in + h) * 4 * h
        n_in = h
    return flops


def build_char_lstm(policy: str, device: str, **kw):
    """``zoo.char_lstm`` at the bench's widths, from seed 12345 (the same
    weights on every device)."""
    from deeplearning4j_tpu_torch.models import zoo

    return zoo.char_lstm(dtype_policy=policy, device=device,
                         **{**RNN_CFG, **kw}).init()


def train_char_lstm(card: str):
    """Warm-up and timed ``fit`` calls at the bench's size; returns the
    network and its batch on the card."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet

    net = build_char_lstm("bf16", "cuda")
    x, y = char_lstm_data(RNN_BATCH)
    ds = DataSet(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warm = []
    for _ in range(RNN_WARMUP):
        net.fit(ds)
        warm.append(net.score_value)
    torch.cuda.synchronize()
    scores, host = [], 0.0
    t0 = time.monotonic()
    for _ in range(RNN_FITS):
        t = time.monotonic()
        net.fit(ds)
        host += time.monotonic() - t
        scores.append(net._score)  # the last window's loss, on the card
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    losses = [float(v) for v in scores]
    windows = -(-RNN_T // RNN_CFG["tbptt_length"])
    sps = RNN_BATCH * RNN_FITS / wall
    train_flops = 3 * char_lstm_flops_per_token()
    print(f"recurrent char_lstm [{RNN_BATCH}, {RNN_T}, "
          f"{RNN_CFG['vocab_size']}] hidden {RNN_CFG['hidden']} x"
          f"{RNN_CFG['layers']} tbptt {RNN_CFG['tbptt_length']} bf16: "
          f"warmup_losses={warm} losses={losses} "
          f"ms_per_fit={wall / RNN_FITS * 1e3} "
          f"host_ms_per_fit={host / RNN_FITS * 1e3} "
          f"steps_per_fit={windows} samples_per_sec={sps} "
          f"tokens_per_sec={sps * RNN_T} "
          f"share_of_bf16_peak={train_flops * sps * RNN_T / H100_BF16_FLOPS} "
          f"(train_flops_per_token={train_flops}) "
          f"peak_mem_bytes={torch.cuda.max_memory_allocated()} "
          f"iterations={net.iteration_count} [{card}]")
    every = warm + losses
    if not all(math.isfinite(v) for v in every):
        raise AssertionError(f"char_lstm: non-finite loss: {every}")
    if not losses[-1] < warm[0]:
        raise AssertionError(f"char_lstm: the last window's loss did not "
                             f"fall on a repeated batch: {every}")
    if net.iteration_count != windows * (RNN_WARMUP + RNN_FITS):
        raise AssertionError(f"char_lstm: {net.iteration_count} iterations")
    return net, ds


def check_char_lstm_parity(card: str) -> None:
    """The card against the CPU on the same weights at batch 8, full width
    and t 200: under float32 with TF32 off, the first window's loss,
    gradients and carried state (rtol 2e-3, atol 1e-3), then one whole
    ``fit`` (4 windows) on loss and params (the same); under ``bf16``, one
    whole ``fit`` at the zoo's lr: loss 2e-2, params 1e-2."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.dtypes import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pbatch, w = RNN_PARITY_BATCH, RNN_CFG["tbptt_length"]
    x, y = char_lstm_data(pbatch)

    def rel_excess(got, want):
        return max(float(((a - b).abs() - (1e-3 + 2e-3 * b.abs())).max())
                   for a, b in zip(got, want))

    window, fits = {}, {}
    for device in ("cuda", "cpu"):
        net = build_char_lstm("float32", device)
        xd, yd = (torch.from_numpy(a[:, :w]).to(device) for a in (x, y))
        loss, (_, carry), grads = net._loss_grads(
            net.params, net.net_state, xd, yd,
            rnn_state=net._zero_rnn_state(pbatch))
        window[device] = ([loss.cpu()] + [g.cpu() for g in tree_leaves(grads)]
                          + [c.detach().cpu() for c in tree_leaves(carry)],
                          flat(net.params))
        for policy in ("float32", "bf16"):
            net = build_char_lstm(policy, device)
            net.fit(DataSet(*(torch.from_numpy(a).to(device) for a in (x, y))))
            fits[policy, device] = (torch.tensor(net.score_value),
                                    torch.from_numpy(flat(net.params)))
    if not (window["cuda"][1] == window["cpu"][1]).all():
        raise AssertionError("char_lstm: the card and the CPU drew other "
                             "weights from one seed")
    err_w = max(float((a - b).abs().max())
                for a, b in zip(window["cuda"][0], window["cpu"][0]))
    ok_w = rel_excess(window["cuda"][0], window["cpu"][0]) <= 0.0
    (lc, pc), (lh, ph) = fits["float32", "cuda"], fits["float32", "cpu"]
    ok_f = rel_excess([lc, pc], [lh, ph]) <= 0.0
    (bc, bpc), (bh, bph) = fits["bf16", "cuda"], fits["bf16", "cpu"]
    err_bl, err_bp = abs(float(bc - bh)), float((bpc - bph).abs().max())
    ok_b = err_bl <= 2e-2 and err_bp <= 1e-2
    print(f"recurrent parity float32 [{pbatch}, {RNN_T}] card vs cpu: "
          f"window 0 loss {float(window['cuda'][0][0])} vs "
          f"{float(window['cpu'][0][0])}, loss_grads_and_carry_max_abs_err="
          f"{err_w:.3e} (rtol 2e-3, atol 1e-3) {'ok' if ok_w else 'MISMATCH'}"
          f"; one fit (4 windows) loss {float(lc)} vs {float(lh)} "
          f"param_max_abs_err={float((pc - ph).abs().max()):.3e} "
          f"(rtol 2e-3, atol 1e-3) {'ok' if ok_f else 'MISMATCH'} [{card}]")
    print(f"recurrent parity bf16 [{pbatch}, {RNN_T}] one fit (4 windows) "
          f"card vs cpu at lr {3e-3}: loss {float(bc)} vs {float(bh)} "
          f"loss_err={err_bl:.3e} (tol 2e-2) param_err={err_bp:.3e} "
          f"(tol 1e-2) {'ok' if ok_b else 'MISMATCH'} [{card}]")
    if not (ok_w and ok_f and ok_b):
        raise AssertionError("char_lstm on the card disagrees with the CPU")


def check_generation(net, x, policy: str, card: str) -> None:
    """``rnn_time_step`` one character at a time equals the full-sequence
    ``output`` on the same weights (``RNN_GEN_TOL``); prints ms a step."""
    import torch

    with torch.no_grad():
        full = net.output(x)
    net.rnn_clear_previous_state()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    steps = [net.rnn_time_step(x[:, s]) for s in range(x.shape[1])]
    torch.cuda.synchronize()
    ms = (time.monotonic() - t0) / x.shape[1] * 1e3
    err = float((torch.stack(steps, dim=1) - full).abs().max())
    ok = err <= RNN_GEN_TOL[policy] and steps[0].shape == (x.shape[0],
                                                           x.shape[2])
    print(f"recurrent generation {policy} [{x.shape[0]}] {x.shape[1]} "
          f"rnn_time_step calls vs full output: max_abs_err={err:.3e} "
          f"(tol {RNN_GEN_TOL[policy]}) ms_per_step={ms} "
          f"{'ok' if ok else 'MISMATCH'} [{card}]")
    if not ok:
        raise AssertionError(f"{policy} stepwise generation disagrees with "
                             "the full forward")


def recurrent(card: str) -> None:
    """Phase 7: the char-LSTM through ``MultiLayerNetwork``'s truncated
    BPTT, the card against the CPU, and stepwise generation. The path is
    cuBLAS and eager torch: it must launch none of the flash kernels."""
    import torch

    reset_launch_counts()
    net, ds = train_char_lstm(card)
    check_generation(net, ds.features, "bf16", card)
    del net, ds
    check_char_lstm_parity(card)
    x, _ = char_lstm_data(RNN_PARITY_BATCH)
    check_generation(build_char_lstm("float32", "cuda"),
                     torch.from_numpy(x).cuda(), "float32", card)
    if any(launch_counts().values()):
        raise AssertionError(f"the recurrent phase launched a flash kernel: "
                             f"{launch_counts()}")


# ---------------------------------------------------------------------------
# phase 8: the fused training paths, each a CUDA-graph replay per step
# ---------------------------------------------------------------------------
# bench.py's bench_epoch (bench.py:527-590), nothing cut: the MNIST MLP
# (hidden 256) under bf16, 16 batches of 2048 x 784 float32 from
# default_rng(0), 5 epochs
EPOCH_BATCH, EPOCH_BATCHES, EPOCH_EPOCHS = 2048, 16, 5
EPOCH_POISON = 5  # the guard cell's poisoned batch (one NaN feature row)
EPOCH_PARITY = (64, 4, 2)  # card against CPU: batch, batches, epochs
FUSED_NETS = ("lenet5", "resnet18")  # fit_steps cells, the bench's sizes
FUSED_WARMUP, FUSED_STEPS = 2, 10
LM_FUSED_K, LM_FUSED_CALLS = 4, 3  # fit_batch_multi: k steps, calls timed
# the programs cell: ResNet-18 at the bench's batch, 4 batches a epoch
PROGRAMS_NET, PROGRAMS_BATCHES = "resnet18", 4
# the CUDA runtime calls that put work on the card, counted under the
# profiler as the host's launches
HOST_LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                    "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                    "cudaMemcpyAsync", "cudaMemsetAsync")
# the hand-written kernels by the names the card's trace gives them (both
# variants of each: flash_fwd_kernel, flash_fwd_mma_kernel, ...)
KERNEL_TRACE_NAMES = {"flash_attention_fwd": "flash_fwd_",
                      "flash_attention_bwd_dkdv": "flash_bwd_dkdv_",
                      "flash_attention_bwd_dq": "flash_bwd_dq_"}


def busy_union_s(intervals) -> float:
    """Seconds covered by the union of ``(start_us, end_us)`` intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e6


def profiled(fn, units: int) -> dict:
    """``fn()`` under ``torch.profiler`` (CPU and CUDA activity), per one
    of ``units``: the host's launch calls by API (``cudaGraphLaunch`` is
    one replay), the device's events (kernels, copies, memsets), its
    busy time (their union) and the hand-written kernels it ran
    (``kernels``, by wrapper name)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    host = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in HOST_LAUNCH_APIS:
            host[e.name] = host.get(e.name, 0) + 1
    kernels = {k: sum(tag in e.name for e in device) / units
               for k, tag in KERNEL_TRACE_NAMES.items()}
    return {"host_launches": {k: v / units for k, v in sorted(host.items())},
            "replays": host.get("cudaGraphLaunch", 0) / units,
            "other_host_launches": sum(v for k, v in host.items()
                                       if k != "cudaGraphLaunch") / units,
            "device_events": len(device) / units,
            "device_busy_ms": busy_union_s(
                [(e.time_range.start, e.time_range.end)
                 for e in device]) * 1e3 / units,
            "kernels": kernels}


def traced_launches(fn, what: str, card: str) -> dict:
    """Run ``fn()`` once under the profiler and hold B1–B3's launches as
    ``perf.step_graph.kernel_launches`` counts them (the wrappers' counts
    corrected for captures and replays) against the kernels the card's
    trace shows; returns the count."""
    reset_launch_counts()
    traced = profiled(fn, 1)["kernels"]
    counted = launch_counts()
    print(f"{what}: B1-B3 launches counted={counted} traced={traced} "
          f"[{card}]")
    if any(traced[k] != n for k, n in counted.items()):
        raise AssertionError(f"{what}: the launch count {counted} differs "
                             f"from the card's trace {traced}")
    return counted


def idle_share(prof: dict, wall_ms: float) -> float:
    """The card's idle share of an unprofiled run whose device work the
    profiled run measured."""
    return 1.0 - prof["device_busy_ms"] / wall_ms


def same_state(a, b) -> bool:
    """Bitwise equality of two networks' params, updater and net state."""
    import torch
    from deeplearning4j_tpu_torch.dtypes import tree_leaves

    la = tree_leaves((a.params, a.updater_state, a.net_state))
    lb = tree_leaves((b.params, b.updater_state, b.net_state))
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def max_state_err(a, b) -> float:
    return float(abs(flat((a.params, a.updater_state, a.net_state))
                     - flat((b.params, b.updater_state, b.net_state))).max())


def epoch_data(batch=None, n_batches=None, poison=None):
    """bench_epoch's draw: ``default_rng(0)`` features in [0, 1) and
    one-hot labels over 10 classes; ``poison`` sets one row of that
    batch to NaN."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets import DataSet

    batch = batch or EPOCH_BATCH
    n = batch * (n_batches or EPOCH_BATCHES)
    rng = np.random.default_rng(0)
    x = rng.random((n, 784), np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    if poison is not None:
        x[poison * batch + 7] = np.nan
    return DataSet(x, y)


def timed(fn, sync=True):
    """``(wall s, host s)`` of ``fn()``: host is the time to return."""
    import torch

    torch.cuda.synchronize()
    t0 = time.monotonic()
    fn()
    host = time.monotonic() - t0
    if sync:
        torch.cuda.synchronize()
    return time.monotonic() - t0, host


@contextlib.contextmanager
def captured(graphs: bool):
    """Inside the block the fused paths replay CUDA graphs (True) or run
    the same steps eagerly (False): the comparison's switch."""
    from deeplearning4j_tpu_torch.perf import step_graph

    step_graph._capture = graphs
    try:
        yield
    finally:
        step_graph._capture = True


def memory_mark():
    """Start a memory reading: cached blocks released, the peak reset."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()


def memory_since(mark) -> dict:
    """Device memory since ``mark``: the peak allocated, and what stays
    reserved once cached blocks are released (live tensors and the
    graphs' pools, which cannot be released)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    allocated, reserved = mark
    return {"peak_mem_bytes": torch.cuda.max_memory_allocated() - allocated,
            "resident_bytes": torch.cuda.memory_reserved() - reserved}


def fused_epochs(card: str) -> None:
    """The epoch cell: streaming ``fit`` against ``fit_epochs`` with chunks
    of 1 and of 5 epochs, replayed against the same run eagerly."""
    import torch
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator

    ds = epoch_data()
    total = EPOCH_BATCH * EPOCH_BATCHES * EPOCH_EPOCHS
    it = ListDataSetIterator(ds, EPOCH_BATCH)

    net = build_network("mnist_mlp", "bf16", "cuda")
    net.fit(it)  # warm-up: the first epoch of the streaming loop
    d0 = net._train_dispatches
    wall, host = timed(lambda: net.fit(it, num_epochs=EPOCH_EPOCHS))
    stream = {"samples_per_sec": total / wall,
              "ms_per_epoch": wall / EPOCH_EPOCHS * 1e3,
              "host_ms_per_epoch": host / EPOCH_EPOCHS * 1e3,
              "dispatches_per_epoch": (net._train_dispatches - d0)
              / EPOCH_EPOCHS}
    prof = profiled(lambda: net.fit(it), 1)
    stream.update(prof, device_idle_share=idle_share(
        prof, stream["ms_per_epoch"]))
    del net

    runs = {}
    for chunk in (1, EPOCH_EPOCHS):
        for graphs in (True, False):
            with captured(graphs):
                mark = memory_mark()
                net = build_network("mnist_mlp", "bf16", "cuda")
                cache = net.build_epoch_cache(it)
                net.fit_epochs(cache, chunk, chunk_epochs=chunk)  # warm-up
                d0 = net._train_dispatches
                out = {}
                wall, host = timed(lambda: out.setdefault(
                    "hist", net.fit_epochs(cache, EPOCH_EPOCHS,
                                           chunk_epochs=chunk)))
                r = {"samples_per_sec": total / wall,
                     "ms_per_epoch": wall / EPOCH_EPOCHS * 1e3,
                     "host_ms_per_epoch": host / EPOCH_EPOCHS * 1e3,
                     "dispatches_per_epoch": (net._train_dispatches - d0)
                     / EPOCH_EPOCHS, **memory_since(mark)}
                prog = next(iter(net._programs.values()))
                r.update(captures=prog.graph.captures,
                         replays=prog.graph.replays)
                prof = profiled(lambda: net.fit_epochs(
                    cache, EPOCH_EPOCHS, chunk_epochs=chunk), EPOCH_EPOCHS)
                r.update(prof, device_idle_share=idle_share(
                    prof, r["ms_per_epoch"]))
                runs[(chunk, graphs)] = (net, out["hist"], r)
    for chunk in (1, EPOCH_EPOCHS):
        (g, hg, rg), (e, he, re_) = runs[(chunk, True)], runs[(chunk, False)]
        bitwise = torch.equal(hg, he) and same_state(g, e)
        print(f"fused epoch mnist_mlp [{EPOCH_BATCHES} x {EPOCH_BATCH}, 784] "
              f"bf16 x{EPOCH_EPOCHS} epochs, chunk {chunk}: "
              f"replayed={json.dumps(rg)} eager={json.dumps(re_)} "
              f"replay_equals_eager={bitwise} "
              f"(max_abs_err {max_state_err(g, e):.3e}) [{card}]")
        if not bitwise:
            raise AssertionError(f"fit_epochs chunk {chunk}: the replayed "
                                 "run differs from the eager one")
        if not bool(torch.isfinite(hg).all()):
            raise AssertionError(f"fit_epochs: losses {hg.tolist()}")
    print(f"fused epoch mnist_mlp streaming fit: {json.dumps(stream)} "
          f"[{card}]")


def fused_guard(card: str) -> None:
    """The guard cell: a NaN batch under ``skip`` trips once an epoch, at
    that batch's place in the epoch's order, and params stay finite;
    ``off`` and ``skip`` are bitwise equal on clean data; ``raise``
    names the batch."""
    import torch
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.dtypes import tree_leaves
    from deeplearning4j_tpu_torch.perf.epoch_cache import (
        clone_generator, epoch_schedule)
    from deeplearning4j_tpu_torch.resilience import TrainingDivergedError

    it = ListDataSetIterator(epoch_data(poison=EPOCH_POISON), EPOCH_BATCH)
    net = build_network("mnist_mlp", "bf16", "cuda")
    cache = net.build_epoch_cache(it)
    gen = clone_generator(net._rng)
    net.fit_epochs(cache, EPOCH_EPOCHS, guard="skip")
    trips = net._last_sentinel
    where = [epoch_schedule(gen, EPOCH_BATCHES, True).tolist().index(
        EPOCH_POISON) for _ in range(EPOCH_EPOCHS)]
    want = [[j == w for j in range(EPOCH_BATCHES)] for w in where]
    finite = all(bool(torch.isfinite(t).all())
                 for t in tree_leaves((net.params, net.updater_state)))
    clean = ListDataSetIterator(epoch_data(), EPOCH_BATCH)
    off, skip = (build_network("mnist_mlp", "bf16", "cuda")
                 for _ in range(2))
    h_off = off.fit_epochs(clean, 2, guard="off")
    h_skip = skip.fit_epochs(clean, 2, guard="skip")
    off_eq_skip = torch.equal(h_off, h_skip) and same_state(off, skip)
    raising = build_network("mnist_mlp", "bf16", "cuda")
    named = None
    try:
        raising.fit_epochs(cache, 1, guard="raise")
    except TrainingDivergedError as e:
        named = (e.epoch, e.step, e.batch_index)
    print(f"fused guard mnist_mlp bf16, batch {EPOCH_POISON} poisoned: "
          f"skip trips per epoch {trips.sum(axis=1).tolist()} at "
          f"{[row.nonzero()[0].tolist() for row in trips]} (its places in "
          f"the orders: {where}) params_finite={finite}; clean data: "
          f"off_equals_skip={off_eq_skip}; raise names (epoch, step, "
          f"batch)={named} [{card}]")
    if trips.tolist() != want or not finite or not off_eq_skip \
            or named is None or named[2] != EPOCH_POISON:
        raise AssertionError("the guard cell failed")


def fused_steps(name: str, card: str) -> None:
    """A ``fit_steps`` cell: replayed against eager at the bench's size."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet

    batch = NETWORKS[name][0]
    x, y = network_data(name, batch)
    ds = DataSet(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
    nets, rows = {}, {}
    for graphs in (True, False):
        with captured(graphs):
            mark = memory_mark()
            net = build_network(name, "bf16", "cuda")
            net.fit_steps(ds, FUSED_WARMUP)
            wall, host = timed(lambda: net.fit_steps(ds, FUSED_STEPS))
            r = {"ms_per_step": wall / FUSED_STEPS * 1e3,
                 "host_ms_per_step": host / FUSED_STEPS * 1e3,
                 "samples_per_sec": batch * FUSED_STEPS / wall,
                 "loss": net.score_value, **memory_since(mark)}
            prof = profiled(lambda: net.fit_steps(ds, FUSED_STEPS),
                            FUSED_STEPS)
            r.update(prof, device_idle_share=idle_share(prof,
                                                        r["ms_per_step"]))
            nets[graphs], rows[graphs] = net, r
    bitwise = same_state(nets[True], nets[False])
    print(f"fused fit_steps {name} [{batch}, "
          f"{', '.join(map(str, NETWORKS[name][1]))}] bf16: "
          f"replayed={json.dumps(rows[True])} eager={json.dumps(rows[False])} "
          f"replay_equals_eager={bitwise} (max_abs_err "
          f"{max_state_err(nets[True], nets[False]):.3e}) [{card}]")
    if not bitwise:
        raise AssertionError(f"{name}: fit_steps replayed differs from "
                             "eager")
    if not math.isfinite(rows[True]["loss"]):
        raise AssertionError(f"{name}: non-finite loss")


def fused_char_lstm(card: str) -> None:
    """The char-LSTM cell: ``fit`` with its full TBPTT windows replayed
    against the same windows eagerly."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet

    x, y = char_lstm_data(RNN_BATCH)
    ds = DataSet(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
    nets, rows = {}, {}
    for graphs in (True, False):
        with captured(graphs):
            net = build_char_lstm("bf16", "cuda")
            net.fit(ds)  # warm-up: the first window runs eagerly, then capture
            ms, hosts = [], []
            for _ in range(RNN_FITS):
                wall, host = timed(lambda: net.fit(ds))
                ms.append(wall * 1e3)
                hosts.append(host * 1e3)
            r = {"ms_per_fit": sum(ms) / RNN_FITS,
                 "ms_per_fit_each": ms,
                 "host_ms_per_fit": sum(hosts) / RNN_FITS,
                 "loss": net.score_value}
            prof = profiled(lambda: net.fit(ds), 1)
            r.update(prof, device_idle_share=idle_share(prof,
                                                        r["ms_per_fit"]))
            nets[graphs], rows[graphs] = net, r
    bitwise = same_state(nets[True], nets[False])
    print(f"fused char_lstm [{RNN_BATCH}, {RNN_T}, {RNN_CFG['vocab_size']}] "
          f"tbptt {RNN_CFG['tbptt_length']} bf16, a fit = 4 windows: "
          f"replayed={json.dumps(rows[True])} eager={json.dumps(rows[False])} "
          f"replay_equals_eager={bitwise} (max_abs_err "
          f"{max_state_err(nets[True], nets[False]):.3e}) [{card}]")
    if not bitwise:
        raise AssertionError("char_lstm: replayed windows differ from eager")


def fused_lm(card: str) -> dict:
    """The LM cell: ``fit_batch_multi`` with a captured step against the
    same steps eagerly; returns B1–B3's launches in the replayed run."""
    import torch
    from deeplearning4j_tpu_torch.dtypes import tree_leaves
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM
    from deeplearning4j_tpu_torch.perf import step_graph

    tok = torch.as_tensor(train_tokens(), device="cuda")
    rows, models, launches, traced = {}, {}, {}, {}
    for graphs in (True, False):
        with captured(graphs):
            lm = TransformerLM(**TRAIN_CFG).init()
            multi = lm.make_multi_train_step(LM_FUSED_K)
            warm = lm.fit_batch_multi(tok, multi_step=multi, k=LM_FUSED_K)
            step_graph.reset_kernel_launches()
            losses = []
            wall, host = timed(lambda: losses.extend(
                lm.fit_batch_multi(tok, multi_step=multi, k=LM_FUSED_K,
                                   block=False)
                for _ in range(LM_FUSED_CALLS)))
            steps = LM_FUSED_K * LM_FUSED_CALLS
            launches[graphs] = step_graph.kernel_launches()
            prog = next(iter(multi.programs.values()))
            rows[graphs] = {"ms_per_step": wall / steps * 1e3,
                            "host_ms_per_step": host / steps * 1e3,
                            "tokens_per_sec": TRAIN_BATCH * TRAIN_T * steps
                            / wall,
                            "warmup_loss": warm,
                            "losses": [float(v) for v in losses],
                            "captures": prog.graph.captures,
                            "replays": prog.graph.replays,
                            "launches": launches[graphs]}
            # one more call (k steps) under the profiler, in both runs
            traced[graphs] = traced_launches(
                lambda: lm.fit_batch_multi(tok, multi_step=multi,
                                           k=LM_FUSED_K),
                f"fused lm fit_batch_multi k={LM_FUSED_K} "
                f"{'replayed' if graphs else 'eager'}", card)
            models[graphs] = lm
    a, b = models[True], models[False]
    la, lb = (tree_leaves((m.params, m.opt_state)) for m in (a, b))
    bitwise = all(torch.equal(x, y) for x, y in zip(la, lb))
    err = max(float((x - y).abs().max()) for x, y in zip(la, lb))
    steps = LM_FUSED_K * LM_FUSED_CALLS
    want = {k: a.num_layers * steps for k in launches[True]}
    print(f"fused lm d{TRAIN_CFG['d_model']} L{TRAIN_CFG['num_layers']} "
          f"[{TRAIN_BATCH}, {TRAIN_T}] mixed_bf16 fit_batch_multi k="
          f"{LM_FUSED_K} x{LM_FUSED_CALLS}: replayed={json.dumps(rows[True])} "
          f"eager={json.dumps(rows[False])} replay_equals_eager={bitwise} "
          f"(max_abs_err {err:.3e}) [{card}]")
    if launches[True] != want or launches[False] != want:
        raise AssertionError(f"B1-B3 launches {launches}, expected {want}")
    want_one = {k: a.num_layers * LM_FUSED_K for k in launches[True]}
    if traced[True] != want_one or traced[False] != want_one:
        raise AssertionError(f"traced B1-B3 launches {traced}, expected "
                             f"{want_one}")
    if not bitwise:
        raise AssertionError("the LM's replayed steps differ from eager")
    return launches[True]


def fused_programs(card: str) -> None:
    """The programs cell: one ResNet-18 keeps a program per key, and its
    graphs share one memory pool. Six fused calls of five keys
    (``fit_epochs`` under ``skip``, ``off``, telemetry and in order,
    ``fit_steps``, then the first key again, so that a graph replays
    after others were captured into the pool) against the same calls
    eagerly, bitwise; the resident memory after each call; then the
    cache is dropped, and its memory must come back while the network
    keeps its programs."""
    import gc

    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator

    batch = NETWORKS[PROGRAMS_NET][0]
    x, y = network_data(PROGRAMS_NET, batch * PROGRAMS_BATCHES)
    it = ListDataSetIterator(DataSet(x, y), batch)
    step_ds = DataSet(torch.from_numpy(x[:batch]).cuda(),
                      torch.from_numpy(y[:batch]).cuda())
    calls = (
        ("fit_epochs skip", lambda n, c: n.fit_epochs(c, 1, guard="skip")),
        ("fit_epochs off", lambda n, c: n.fit_epochs(c, 1, guard="off")),
        ("fit_epochs telemetry", lambda n, c: n.fit_epochs(
            c, 1, guard="off", telemetry=True)),
        ("fit_epochs in order", lambda n, c: n.fit_epochs(
            c, 1, guard="off", shuffle=False)),
        ("fit_steps", lambda n, c: n.fit_steps(step_ds, 3)),
        ("fit_epochs skip again", lambda n, c: n.fit_epochs(
            c, 1, guard="skip")))
    nets, hists, rows = {}, {}, {}
    for graphs in (True, False):
        with captured(graphs):
            mark = memory_mark()
            net = build_network(PROGRAMS_NET, "bf16", "cuda")
            cache = net.build_epoch_cache(it)
            row = {"resident_bytes_with_cache":
                   memory_since(mark)["resident_bytes"]}
            hists[graphs], resident = [], []
            for _, call in calls:
                out = call(net, cache)
                hists[graphs].append(out.clone() if isinstance(
                    out, torch.Tensor) else None)  # fit_steps: no history
                resident.append(memory_since(mark)["resident_bytes"])
            row.update(resident_bytes_after_each=resident,
                       peak_mem_bytes=memory_since(mark)["peak_mem_bytes"],
                       programs=len(net._programs),
                       captures=sum(p.graph.captures
                                    for p in net._programs.values()))
            cache_bytes = cache.nbytes
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            del cache
            gc.collect()
            row.update(cache_bytes=cache_bytes,
                       freed_bytes_on_cache_drop=before
                       - torch.cuda.memory_allocated())
            nets[graphs], rows[graphs] = net, row
    bitwise = same_state(nets[True], nets[False]) and all(
        (a is None and b is None) or torch.equal(a, b)
        for a, b in zip(hists[True], hists[False]))
    print(f"fused programs {PROGRAMS_NET} [{batch}, "
          f"{', '.join(map(str, NETWORKS[PROGRAMS_NET][1]))}] bf16, "
          f"{PROGRAMS_BATCHES} batches, calls "
          f"{[name for name, _ in calls]}: replayed={json.dumps(rows[True])} "
          f"eager={json.dumps(rows[False])} replay_equals_eager={bitwise} "
          f"(max_abs_err {max_state_err(nets[True], nets[False]):.3e}) "
          f"[{card}]")
    if not bitwise:
        raise AssertionError("programs cell: the replayed calls differ from "
                             "the eager ones")
    if rows[True]["programs"] != 5 or rows[True]["captures"] != 5:
        raise AssertionError(f"programs cell: {rows[True]['programs']} "
                             f"programs, {rows[True]['captures']} captures; "
                             "expected 5 of each")
    for graphs in (True, False):
        if rows[graphs]["freed_bytes_on_cache_drop"] < \
                rows[graphs]["cache_bytes"]:
            raise AssertionError("programs cell: dropping the cache did not "
                                 "free it; a program keeps it alive")


def fused_parity(card: str) -> None:
    """The card's fused runs against the CPU's, at the earlier phases'
    gates: ``fit_epochs`` of the MLP (4 batches of 64, 2 epochs, in order)
    under float32 with TF32 off (rtol 2e-3, atol 1e-3) and ``bf16`` (loss
    2e-2, params 1e-2); ``fit_steps(ds, 3)`` of LeNet-5 and ResNet-18 at
    the networks phase's parity batches under ``bf16`` (ResNet-18 at
    ``NET_PARITY_LR``)."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch, n_batches, epochs = EPOCH_PARITY
    it = ListDataSetIterator(epoch_data(batch, n_batches), batch)
    failures = []
    for policy, tol in (("float32", (2e-3, 1e-3)), ("bf16", None)):
        got = {}
        for device in ("cuda", "cpu"):
            net = build_network("mnist_mlp", policy, device)
            hist = net.fit_epochs(it, epochs, shuffle=False)
            got[device] = (hist.float().cpu(), flat(net.params))
        (hc, pc), (hh, ph) = got["cuda"], got["cpu"]
        if tol is None:
            ok = (float((hc - hh).abs().max()) <= 2e-2
                  and float(abs(pc - ph).max()) <= 1e-2)
        else:
            rtol, atol = tol
            ok = (bool(((hc - hh).abs() <= atol + rtol * hh.abs()).all())
                  and bool((abs(pc - ph) <= atol + rtol * abs(ph)).all()))
        print(f"fused parity mnist_mlp fit_epochs {policy} [{n_batches} x "
              f"{batch}] x{epochs} card vs cpu: loss_err="
              f"{float((hc - hh).abs().max()):.3e} param_err="
              f"{float(abs(pc - ph).max()):.3e} "
              f"({'rtol 2e-3, atol 1e-3' if tol else 'loss 2e-2, params 1e-2'})"
              f" {'ok' if ok else 'MISMATCH'} [{card}]")
        if not ok:
            failures.append(f"mnist_mlp {policy}")
    for name in FUSED_NETS:
        pbatch = NET_PARITY_BATCH[name]
        x, y = network_data(name, pbatch)
        lr = NET_PARITY_LR.get(name)
        got = {}
        for device in ("cuda", "cpu"):
            net = build_network(name, "bf16", device,
                                **({} if lr is None else {"lr": lr}))
            net.fit_steps(DataSet(torch.from_numpy(x).to(device),
                                  torch.from_numpy(y).to(device)), 3)
            got[device] = (net.score_value, flat(net.params),
                           [flat(s) for s in net.net_state.values() if s])
        (lc, pc, sc), (lh, ph, sh) = got["cuda"], got["cpu"]
        excess_s = max((float(abs(a - b).max() - 1e-2 - 2e-2 * abs(b).max())
                        for a, b in zip(sc, sh)), default=0.0)
        ok = (abs(lc - lh) <= 2e-2 and float(abs(pc - ph).max()) <= 1e-2
              and excess_s <= 0.0)
        print(f"fused parity {name} fit_steps(3) bf16 [{pbatch}]"
              f"{'' if lr is None else f' (lr {lr})'} card vs cpu: loss "
              f"{lc} vs {lh} param_err={float(abs(pc - ph).max()):.3e} "
              f"(loss 2e-2, params 1e-2; running statistics atol 1e-2 + "
              f"2e-2 x a layer's largest) {'ok' if ok else 'MISMATCH'} "
              f"[{card}]")
        if not ok:
            failures.append(name)
    if failures:
        raise AssertionError(f"the card's fused runs disagree with the "
                             f"CPU's: {failures}")


def fused(card: str) -> dict:
    """Phase 8: every fused path by graph replay, against its eager run
    and against the CPU. Returns B1–B3's launches in the LM cell."""
    import torch

    fused_epochs(card)
    fused_guard(card)
    for name in FUSED_NETS:
        fused_steps(name, card)
        torch.cuda.empty_cache()
    fused_programs(card)
    torch.cuda.empty_cache()
    fused_char_lstm(card)
    torch.cuda.empty_cache()
    launches = fused_lm(card)
    torch.cuda.empty_cache()
    fused_parity(card)
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
        for name in KERNEL_SOURCES:
            for line in ptxas_lines(_build.LOGS.get(name, "")):
                print(f"ptxas {name}.cu {line}")
    except Exception:
        traceback.print_exc()
        fail("kernel build failed")

    entries = {}
    serve_launches = train_launches = fused_launches = None
    for phase in ("flash", "flash_bwd", "serve", "train", "networks",
                  "recurrent", "fused"):
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
            elif phase == "train":
                train_launches = train(card)
                check_train_parity(card)
            elif phase == "networks":
                networks(card)
            elif phase == "recurrent":
                recurrent(card)
            else:
                fused_launches = fused(card)
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
    for name, e in entries.items():
        e["launches_fused_lm"] = fused_launches[name]
    entries["flash_attention_fwd"]["launches_serve"] = serve_launches
    print(json.dumps({"kernels": list(entries.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
