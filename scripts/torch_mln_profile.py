#!/usr/bin/env python3
"""Where the time goes in a network step of the port.

Trains the model of ``chip_smoke.py``'s networks or recurrent phase
(``--model lenet5``: LeNet-5 at ``[1024, 28, 28, 1]``; ``--model
mnist_mlp``: the 784-256-256-10 MLP at ``[4096, 784]``; ``--model
resnet18``: the ``ComputationGraph`` ResNet-18 at ``[256, 32, 32, 3]``;
``--model char_lstm``: the char-LSTM at ``[128, 200, 128]``, one step per
TBPTT window of 50, so a ``fit`` is 4 steps; all ``bf16`` with Adam, on
one seeded batch placed on the card once) for a few untraced ``fit``
calls, times ``--steps`` more without the profiler (ending in a
synchronise), then runs ``--steps`` calls under ``torch.profiler`` (CPU
+ CUDA activity), and prints (a "step" below is one ``fit`` call):

- wall time per step with and without the profiler, host time per step
  (the time ``fit`` takes to return without waiting for the card), the
  device's busy time (the union of kernel and copy intervals) and idle
  share, both under the profiler and against the unprofiled step;
  samples/s, the peak of allocated device memory and, for ResNet-18 and
  the char-LSTM, the share of the bf16 peak (bench.py's 3 × 1.11 GFLOP a
  ResNet-18 sample; 3 × 1.90 MFLOP a character, from the char-LSTM's
  widths); for the char-LSTM also tokens/s and the launches per timestep
  and layer (a step's launches over ``t × layers``, the output layer's
  and Adam's included);
- device time and launches per step by group: convolutions (cuDNN),
  GEMMs (cuBLAS), the updater's multi-tensor kernels, copies and casts
  (dtype casts, cuDNN's layout transforms and channel padding, the conv
  weights' channels-last copy, the explicit pad of a stride-2 SAME
  convolution, memsets), and the rest (BatchNorm's statistics and
  normalisation, activations, residual adds, pooling, the loss); then
  the largest kernels by name, each kernel of the copies group, and how
  often the host operators that copy or cast (``aten::_to_copy``,
  ``clone``, ``contiguous``, ``copy_``, ``constant_pad_nd``) and the
  layout views (``permute``) ran per step;
- how many synchronising CUDA operations one ``fit`` makes, as PyTorch's
  sync debug mode detects them (it does not detect all of them), and the
  host's launch calls per step by CUDA runtime API (``cudaGraphLaunch``
  being one graph replay).

Without ``--fused`` every step runs eagerly (``perf.step_graph._capture``
off, the char-LSTM's TBPTT windows too). ``--fused`` profiles the
replayed step instead: for the CNNs and the MLP a step is one replay inside
``fit_steps(ds, steps)``; for the char-LSTM a ``fit`` whose 4 windows
are replays.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/torch_mln_profile.py --model lenet5|mnist_mlp|resnet18|char_lstm [--fused] [--steps 5] [--trace DIR]

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

import chip_smoke as cs  # noqa: E402

# cuDNN's layout transforms and channel padding (bf16 tensor-core convs
# want channels in multiples of 8), and torch's transposes
_LAYOUT = ("nchwtonhwc", "nhwctonchw", "addpadding", "transpose")


# host operators that copy or cast a tensor, and the layout view
_COPY_OPS = ("aten::_to_copy", "aten::clone", "aten::contiguous",
             "aten::copy_", "aten::permute", "aten::constant_pad_nd")


def _low(name: str) -> str:
    return name.lower()


GROUPS = (
    ("copies and casts", lambda n: "copy" in _low(n) or "Memcpy" in n
     or "Memset" in n or any(w in _low(n) for w in _LAYOUT)),
    ("conv (cuDNN)", lambda n: any(w in _low(n) for w in (
        "conv", "fprop", "dgrad", "wgrad", "implicit", "winograd"))),
    ("GEMM (cuBLAS)", lambda n: any(w in _low(n) for w in (
        "gemm", "nvjet", "cutlass", "xmma"))),
    ("updater (multi-tensor)", lambda n: "multi_tensor" in _low(n)
     or "foreach" in _low(n)),
)


def group_of(name: str) -> str:
    for label, pred in GROUPS:
        if pred(name):
            return label
    return "elementwise, BatchNorm, pooling, reductions"


def sync_ops(step) -> int:
    """Synchronising CUDA operations in one ``step()``, as PyTorch's sync
    debug mode reports them."""
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchronizing CUDA operation" in str(w.message)
               for w in caught)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=tuple(cs.NETWORKS) + ("char_lstm",),
                    default="lenet5")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--fused", action="store_true",
                    help="profile the replayed step (CUDA graphs)")
    ap.add_argument("--trace", default=None,
                    help="directory for the Chrome trace")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_mln_profile: no CUDA device is available",
              file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.perf import step_graph

    card = cs.card_line()
    rnn = args.model == "char_lstm"
    if rnn:
        batch = cs.RNN_BATCH
        shape = (cs.RNN_T, cs.RNN_CFG["vocab_size"])
        net = cs.build_char_lstm("bf16", "cuda")
        x, y = cs.char_lstm_data(batch)
    else:
        batch, shape = cs.NETWORKS[args.model]
        net = cs.build_network(args.model, "bf16", "cuda")
        x, y = cs.network_data(args.model, batch)
    ds = DataSet(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
    step_graph._capture = args.fused  # the seam: eager steps on the card
    steps_call = args.fused and not rnn

    def run(n: int) -> float:
        """``n`` steps; returns the host's seconds to issue them."""
        if steps_call:
            t = time.monotonic()
            net.fit_steps(ds, n)
            return time.monotonic() - t
        host = 0.0
        for _ in range(n):
            t = time.monotonic()
            net.fit(ds)
            host += time.monotonic() - t
        return host

    torch.cuda.reset_peak_memory_stats()
    run(cs.NET_WARMUP + 1)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    run(args.steps)
    torch.cuda.synchronize()
    plain_s = (time.monotonic() - t0) / args.steps

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        host_s = run(args.steps)
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace,
                                              f"{args.model}.json"))

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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]
    copies = sorted(((n, v) for n, v in by_name.items()
                     if group_of(n) == "copies and casts"),
                    key=lambda kv: -kv[1][0])
    # the host operators behind those copies, per step
    copy_ops = {e.key: e.count / steps for e in prof.key_averages()
                if e.key in _COPY_OPS}
    syncs = sync_ops(lambda: run(1))
    host_launches = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in cs.HOST_LAUNCH_APIS:
            host_launches[e.name] = host_launches.get(e.name, 0) + 1 / steps
    peak_mem = torch.cuda.max_memory_allocated()
    share = per_timestep_layer = tokens_per_sec = None
    if args.model in cs.NET_FWD_FLOPS:
        share = (3 * cs.NET_FWD_FLOPS[args.model] * batch / plain_s
                 / cs.H100_BF16_FLOPS)
    if rnn:
        tokens_per_sec = batch * cs.RNN_T / plain_s
        share = (3 * cs.char_lstm_flops_per_token() * tokens_per_sec
                 / cs.H100_BF16_FLOPS)
        per_timestep_layer = (len(device) / args.steps
                              / (cs.RNN_T * cs.RNN_CFG["layers"]))
    result = {
        "card": card,
        "model": args.model,
        "fused": args.fused,
        "shape": [batch, *shape],
        "steps": steps,
        "loss": net.score_value,
        "wall_s_per_step": wall_s / steps,
        "unprofiled_wall_s_per_step": plain_s,
        "unprofiled_samples_per_sec": batch / plain_s,
        "unprofiled_tokens_per_sec": tokens_per_sec,
        "unprofiled_device_idle_share": (1.0 - busy_s / steps / plain_s
                                         if device else None),
        "share_of_bf16_peak": share,
        "peak_mem_bytes": peak_mem,
        "host_s_per_step": host_s / steps,
        "host_launches_per_step": host_launches,
        "device_events_per_step": len(device) / steps,
        "device_events_per_timestep_layer": per_timestep_layer,
        "device_busy_s_per_step": busy_s / steps,
        "device_idle_share": 1.0 - busy_s / wall_s if device else None,
        "device_time_s_per_step": kernel_s / steps,
        "groups": groups,
        "sync_ops_per_step": syncs,
        "top_kernels": [{"name": n[:120], "s_per_step": t / 1e6 / steps,
                         "launches_per_step": c / steps}
                        for n, (t, c) in top],
        "copy_kernels": [{"name": n[:120], "s_per_step": t / 1e6 / steps,
                          "launches_per_step": c / steps}
                         for n, (t, c) in copies],
        "copy_ops_per_step": copy_ops,
    }
    print(f"{args.model} {result['shape']} bf16"
          f"{' replayed' if args.fused else ' eager'} under the profiler: "
          f"wall_s_per_step={result['wall_s_per_step']} "
          f"host_s_per_step={result['host_s_per_step']} "
          f"device_busy_s_per_step={result['device_busy_s_per_step']} "
          f"device_idle_share={result['device_idle_share']} "
          f"launches_per_step={result['device_events_per_step']} "
          f"launches_per_timestep_layer={per_timestep_layer} "
          f"sync_ops_per_step={syncs} "
          f"host_launches_per_step={host_launches} [{card}]")
    print(f"{args.model} unprofiled: wall_s_per_step={plain_s} "
          f"samples_per_sec={batch / plain_s} "
          f"tokens_per_sec={tokens_per_sec} device_idle_share="
          f"{result['unprofiled_device_idle_share']} "
          f"share_of_bf16_peak={share} peak_mem_bytes={peak_mem} [{card}]")
    for g, v in groups.items():
        print(f"  {v['s_per_step']:.6f} s/step  "
              f"share={v['share_of_device']:.4f}  "
              f"x{v['launches_per_step']:<7.1f} {g}")
    for t in result["top_kernels"]:
        print(f"  {t['s_per_step']:.6f} s/step  "
              f"x{t['launches_per_step']:<6.1f} {t['name']}")
    print("copies and casts, by kernel:")
    for t in result["copy_kernels"]:
        print(f"  {t['s_per_step']:.6f} s/step  "
              f"x{t['launches_per_step']:<6.1f} {t['name']}")
    print(f"copying host operators per step: {copy_ops}")
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
