#!/usr/bin/env python3
"""Where the training time goes, for the PyTorch/H100 port.

Trains the model of ``chip_smoke.py``'s train phase (the d512·L8·H8
``TransformerLM``, ``mixed_bf16``, ``attn_impl="auto"``, one seeded
``[16, 1024]`` batch) for a few untraced warm-up steps, then for
``--steps`` steps under ``torch.profiler`` (CPU + CUDA activity), and
prints:

- wall time per step, host time per step (the time ``fit_batch`` takes
  to return without waiting for the card), the device's busy time (the
  union of kernel and copy intervals) and idle share;
- device time by group: the flash kernels B1, B2 and B3, float64 GEMMs
  (the batch-invariant unembedding of the serve path; none in a train
  step, whose unembedding sums in f32), other GEMMs (the blocks' bf16
  matmuls and the training unembedding), copies and casts (the per-step
  bf16 weight copy), and the rest; then the largest kernels by name;
- the training unembedding alone (bf16 products, f32 sums), forward and
  backward at the step's shape, and beside it the decode unembedding
  (f64 sums) at the same shape, both timed with CUDA events outside the
  profiler;
- how many synchronising CUDA operations one step makes, as PyTorch's
  sync debug mode detects them (it does not detect all of them), and the
  host's launch calls per step by CUDA runtime API (``cudaGraphLaunch``
  being one graph replay).

Without ``--fused`` the step runs eagerly (``perf.step_graph._capture``
off);
with it, every step after the warm-up is a replay of the captured step,
B1–B3 inside it.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/torch_train_profile.py [--fused] [--steps 3] [--trace DIR]

``--trace`` also writes the Chrome trace into DIR. The last line is one
JSON object with the numbers above. Without a card it exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)


def _is_f64(name: str) -> bool:
    low = name.lower()
    return "double" in low or "f64" in low or "dgemm" in low


def _is_gemm(name: str) -> bool:
    low = name.lower()
    return any(w in low for w in ("gemm", "nvjet", "cutlass", "xmma"))


GROUPS = (
    # both variants of each kernel: flash_fwd_kernel, flash_fwd_mma_kernel
    ("flash_fwd (B1)", lambda n: "flash_fwd_" in n),
    ("flash_bwd_dkdv (B2)", lambda n: "flash_bwd_dkdv_" in n),
    ("flash_bwd_dq (B3)", lambda n: "flash_bwd_dq_" in n),
    ("f64 GEMMs", lambda n: _is_gemm(n) and _is_f64(n)),
    ("other GEMMs", _is_gemm),
    ("copies and casts", lambda n: "copy" in n.lower() or "Memcpy" in n),
)


def group_of(name: str) -> str:
    for label, pred in GROUPS:
        if pred(name):
            return label
    return "other"


def sync_ops(lm, tok) -> int:
    """Synchronising CUDA operations in one step, as PyTorch's sync debug
    mode reports them."""
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            lm.fit_batch(tok, block=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchronizing CUDA operation" in str(w.message)
               for w in caught)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--fused", action="store_true",
                    help="profile the replayed step (CUDA graphs)")
    ap.add_argument("--trace", default=None,
                    help="directory for the Chrome trace")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device is available",
              file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from deeplearning4j_tpu_torch.kernels import _build, KERNEL_SOURCES
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM
    from deeplearning4j_tpu_torch.perf import step_graph

    card = cs.card_line()
    _build.build_all(KERNEL_SOURCES)
    lm = TransformerLM(**cs.TRAIN_CFG).init()
    step_graph._capture = args.fused  # the seam: eager steps on the card
    tok = torch.as_tensor(cs.train_tokens(), device="cuda")
    for _ in range(cs.TRAIN_WARMUP):
        lm.fit_batch(tok)
    torch.cuda.synchronize()

    host_s = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(args.steps):
            t = time.monotonic()
            loss = lm.fit_batch(tok, block=False)
            host_s.append(time.monotonic() - t)
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace, "train.json"))

    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name, by_group = {}, {}
    for e in device:
        t = e.time_range.end - e.time_range.start
        n, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (n + t, c + 1)
        g = group_of(e.name)
        n, c = by_group.get(g, (0.0, 0))
        by_group[g] = (n + t, c + 1)
    busy_s = cs.busy_union_s([(e.time_range.start, e.time_range.end)
                              for e in device])
    kernel_s = sum(t for t, _ in by_name.values()) / 1e6
    steps = args.steps
    groups = {g: {"s_per_step": t / 1e6 / steps,
                  "launches_per_step": c / steps,
                  "share_of_device": t / 1e6 / kernel_s}
              for g, (t, c) in sorted(by_group.items(),
                                      key=lambda kv: -kv[1][0])}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    rows = cs.TRAIN_BATCH * cs.TRAIN_T
    unembed = cs.unembed_ms(lm, rows, train=True)
    unembed_f64 = cs.unembed_ms(lm, rows, train=False)
    syncs = sync_ops(lm, tok)
    host_launches = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in cs.HOST_LAUNCH_APIS:
            host_launches[e.name] = host_launches.get(e.name, 0) + 1 / steps
    step_s = wall_s / steps
    result = {
        "card": card,
        "shape": [cs.TRAIN_BATCH, cs.TRAIN_T],
        "fused": args.fused,
        "host_launches_per_step": host_launches,
        "steps": steps,
        "loss": float(loss),
        "wall_s_per_step": step_s,
        "host_s_per_step": sum(host_s) / steps,
        "device_events": len(device),
        "device_busy_s_per_step": busy_s / steps,
        "device_idle_share": 1.0 - busy_s / wall_s if device else None,
        "device_time_s_per_step": kernel_s / steps,
        "groups": groups,
        "train_unembedding_fwd_bwd_ms": unembed,
        "train_unembedding_share_of_step": unembed / 1e3 / step_s,
        "decode_f64_unembedding_fwd_bwd_ms": unembed_f64,
        "sync_ops_per_step": syncs,
        "top_kernels": [{"name": n[:120], "s_per_step": t / 1e6 / steps,
                         "launches_per_step": c / steps}
                        for n, (t, c) in top],
    }
    print(f"train [{cs.TRAIN_BATCH}, {cs.TRAIN_T}]"
          f"{' replayed' if args.fused else ' eager'} under the profiler: "
          f"wall_s_per_step={step_s} "
          f"host_s_per_step={result['host_s_per_step']} "
          f"device_busy_s_per_step={result['device_busy_s_per_step']} "
          f"device_idle_share={result['device_idle_share']} "
          f"sync_ops_per_step={syncs} "
          f"host_launches_per_step={host_launches} [{card}]")
    for g, v in groups.items():
        print(f"  {v['s_per_step']:.6f} s/step  "
              f"share={v['share_of_device']:.4f}  "
              f"x{v['launches_per_step']:<7.1f} {g}")
    print(f"train unembedding fwd+bwd alone: {unembed:.5f} ms "
          f"({result['train_unembedding_share_of_step']:.4f} of a step); "
          f"decode f64 unembedding at the same shape: {unembed_f64:.5f} ms "
          f"[{card}]")
    for t in result["top_kernels"]:
        print(f"  {t['s_per_step']:.6f} s/step  "
              f"x{t['launches_per_step']:<6.1f} {t['name']}")
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
