#!/usr/bin/env python3
"""Same-call A/B of the float32 flash-attention forward (B1) between two
checkouts of the port, on one CUDA card.

Each checkout's ``flash_attention_fwd`` runs in a child process of its
own, which imports that checkout's ``deeplearning4j_tpu_torch`` and builds
its ``csrc/flash_fwd.cu`` (the library lands in the checkout's own
``kernels/_build``), in the order other, this, this, other: the two sides
share the card and its neighbours, in turns. Every child draws the same
seeded f32 inputs and, at each causal shape of ``SHAPES`` (the train
step's, a head_dim-128 prefill and OPT-2.7B's training shape), prints:

- the launch plan's route and variant, where the checkout has one;
- ``kernel_ms``: the mean of 20 launches (CUDA events, queued behind a
  sleep kernel so the card runs them back to back);
- ``max_abs_err``: out and lse against the checkout's plain version on
  the same inputs (the forward's gate is 2e-5), and whether two launches
  give the same bits.

The first child of this tree also prints the plain version's ms, the
time of ``F.scaled_dot_product_attention`` in f32 (a yardstick the port
never calls) and the bound (3xTF32 and the CUDA cores' rate). A child
that builds its library prints ptxas's registers and spill bytes of each
f32 forward kernel.

Run from the repository root, with the other checkout unpacked into a
directory (``git archive <commit> deeplearning4j_tpu_torch | tar -x -C
DIR``):

    python3 scripts/torch_flash_fwd_ab.py DIR

Without a card it exits 1.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((16, 1024, 8, 64), (1, 1000, 8, 128), (2, 2048, 32, 80))
ITERS = 20


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def cuda_ms(fn, iters: int = ITERS) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches, queued behind
    a sleep kernel twice as long as the host took to issue them."""
    import torch

    t = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(10 ** 6)
    end.record()
    torch.cuda.synchronize()
    cycles_per_ms = 10 ** 6 / start.elapsed_time(end)
    torch.cuda._sleep(int(2 * host_ms * cycles_per_ms))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ptxas_f32_fwd(log: str) -> list:
    """``name: registers, spills`` of each f32 forward kernel in an
    ``nvcc -Xptxas=-v`` log (the mangled names hold ``tf32`` or, in
    older checkouts, the FMA kernels' names)."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif "spill stores" in line:
            spill = line.strip()
        else:
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                if re.search(r"tf32|flash_fwd_kernel|chunked", name):
                    out.append(f"{name}: {m.group(1)} registers, {spill}")
                name, spill = None, ""
    return out


def child(tag: str, root: str, extras: bool) -> None:
    """Time and check one checkout's f32 B1 (see the module note)."""
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import _build
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        sys.exit("no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    t0 = time.monotonic()
    _build.build_all(["flash_fwd"])
    for line in ptxas_f32_fwd(_build.LOGS.get("flash_fwd", "")):
        print(f"AB {tag} ptxas {line}")
    print(f"AB {tag} build {time.monotonic() - t0:.1f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(21)
    for b, t, h, d in SHAPES:
        q, k, v = (torch.randn((b, t, h, d), generator=gen, device="cuda")
                   for _ in range(3))
        run = lambda: fa.flash_attention_fwd(q, k, v, causal=True)  # noqa
        out, lse = run()
        ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v,
                                                            causal=True)
        err = max(float((out - ref_out).abs().max()),
                  float((lse - ref_lse).abs().max()))
        a, b2 = run(), run()
        same = torch.equal(a[0], b2[0]) and torch.equal(a[1], b2[1])
        del out, lse, ref_out, ref_lse, a, b2
        plan = getattr(fa, "launch_plan", None)
        route = ""
        if plan is not None:
            p = plan(q.shape, k.shape, q.dtype, causal=True)
            route = f" [{p.route} {p.variant} tier {p.tier}]"
        line = (f"AB {tag} [{b}, {t}, {h}, {d}] float32 causal{route}: "
                f"kernel_ms={cuda_ms(run):.5f} max_abs_err={err:.3e} "
                f"two_launches_bitwise={same}")
        if extras:
            plain = cuda_ms(lambda: fa.flash_attention_fwd_reference(
                q, k, v, causal=True), iters=3)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True))
            bound = fa.flash_bound(b, t, t, h, d, torch.float32, causal=True)
            line += (f" plain_ms={plain:.5f} sdpa_f32_ms={sdpa:.5f} "
                     f"bound_ms={bound['bound_ms']:.6f} "
                     f"({bound['bound_by']}) cuda_core_bound_ms="
                     f"{bound['cuda_core_bound_ms']:.6f}")
        print(f"{line} [{card}]", flush=True)
        del q, k, v
        torch.cuda.empty_cache()


def main() -> None:
    if len(sys.argv) == 5 and sys.argv[1] == "--child":
        child(sys.argv[2], sys.argv[3], sys.argv[4] == "1")
        return
    if len(sys.argv) != 2 or not os.path.isdir(sys.argv[1]):
        sys.exit(__doc__)
    other = os.path.abspath(sys.argv[1])
    runs = (("other", other, 0), ("this", HERE, 1), ("this", HERE, 0),
            ("other", other, 0))
    for tag, root, extras in runs:
        code = subprocess.call([sys.executable, os.path.abspath(__file__),
                                "--child", tag, root, str(extras)])
        if code:
            sys.exit(f"the {tag} checkout's child exited {code}")


if __name__ == "__main__":
    main()
