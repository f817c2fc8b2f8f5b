#!/usr/bin/env python3
"""Where the serve time goes, for the PyTorch/H100 port.

Serves the traffic of ``chip_smoke.py``'s serve phase (the d512·L8·H8
``TransformerLM`` behind ``DecodeServer(slots=8, max_len=1024)``, the
same seeded Poisson stream) once untraced to warm every shape, then once
per ``fuse_steps`` value under ``torch.profiler`` (CPU + CUDA activity),
and prints:

- the run's wall time and the device's busy time (the union of kernel
  and copy intervals on the card) and idle share;
- device time by kernel name, largest first, and the flash-attention
  forward kernel's share of it;
- host time inside the server's ``serve.prefill`` and ``serve.step``
  spans.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/torch_serve_profile.py [--fuse-steps 1 4] [--trace DIR]

``--trace`` also writes a Chrome trace per run into DIR. The last line
is one JSON object with the numbers above. Without a card it exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

# both variants of B1: flash_fwd_kernel (f32), flash_fwd_mma_kernel (bf16)
FLASH_KERNEL = "flash_fwd_"


def profile_run(lm, sched, fuse_steps: int, trace_dir):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from deeplearning4j_tpu_torch.monitor import SpanTracer, set_tracer
    from deeplearning4j_tpu_torch.serving import DecodeServer, run_open_loop

    tracer = SpanTracer(capacity=1 << 16)
    set_tracer(tracer)
    srv = DecodeServer(lm, slots=cs.SERVE_SLOTS, max_len=cs.SERVE_MAX_LEN,
                       fuse_steps=fuse_steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        report = run_open_loop(srv, sched)
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
    set_tracer(SpanTracer())
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(trace_dir, f"serve_fuse{fuse_steps}.json"))

    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in device:
        t = e.time_range.end - e.time_range.start
        n, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (n + t, c + 1)
    busy_s = cs.busy_union_s([(e.time_range.start, e.time_range.end)
                              for e in device])
    kernel_s = sum(t for t, _ in by_name.values()) / 1e6
    flash_s = sum(t for name, (t, _) in by_name.items()
                  if FLASH_KERNEL in name) / 1e6
    spans = {}
    for sp in tracer.spans():
        spans[sp.name] = spans.get(sp.name, 0.0) + sp.duration_s
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "fuse_steps": fuse_steps,
        "wall_s": wall_s,
        "tokens": report.tokens,
        "tokens_per_sec": report.tokens / wall_s,
        "ttft_p50_ms": report.summary()["ttft_p50_ms"],
        "device_events": len(device),
        "device_busy_s": busy_s,
        "device_idle_share": 1.0 - busy_s / wall_s if device else None,
        "device_time_s": kernel_s,
        "flash_fwd_s": flash_s,
        "flash_fwd_share_of_device": flash_s / kernel_s if kernel_s else None,
        "host_prefill_span_s": spans.get("serve.prefill", 0.0),
        "host_step_span_s": spans.get("serve.step", 0.0),
        "decode_dispatches": srv.steps,
        "top_kernels": [{"name": n[:120], "s": t / 1e6, "count": c}
                        for n, (t, c) in top],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fuse-steps", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--trace", default=None,
                    help="directory for one Chrome trace per run")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device is available",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM
    from deeplearning4j_tpu_torch.serving import (
        DecodeServer, poisson_schedule, run_open_loop)

    card = cs.card_line()
    lm = TransformerLM(**cs.SERVE_CFG).init()
    sched = poisson_schedule(
        cs.SERVE_REQUESTS, 20.0, vocab_size=cs.SERVE_CFG["vocab_size"],
        prompt_lens=cs.SERVE_PROMPT_LENS, max_new_tokens=(16, 32, 64),
        seed=7)
    for k in args.fuse_steps:        # warm every shape untraced
        run_open_loop(DecodeServer(lm, slots=cs.SERVE_SLOTS,
                                   max_len=cs.SERVE_MAX_LEN, fuse_steps=k),
                      sched)
    runs = []
    for k in args.fuse_steps:
        r = profile_run(lm, sched, k, args.trace)
        runs.append(r)
        print(f"fuse_steps={k}: wall_s={r['wall_s']} "
              f"tokens_per_sec={r['tokens_per_sec']} "
              f"device_busy_s={r['device_busy_s']} "
              f"device_idle_share={r['device_idle_share']} "
              f"flash_fwd_s={r['flash_fwd_s']} "
              f"flash_share_of_device={r['flash_fwd_share_of_device']} "
              f"host_prefill_span_s={r['host_prefill_span_s']} "
              f"host_step_span_s={r['host_step_span_s']} [{card}]")
        for t in r["top_kernels"]:
            print(f"  {t['s']:.6f} s  x{t['count']:<5d} {t['name']}")
    print(card)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
