#!/usr/bin/env python3
"""Where the time goes in a solver iteration of the port.

Builds the deep-belief net of ``chip_smoke.py``'s phase 9 (RBMs
784-500-250-200, softmax 10, LBFGS with 5 iterations a batch) on the
card from its reference-format document and one batch of that phase's
data (``--batch`` rows, 1024 by default), runs one warm-up
``Solver.optimize``, then ``--calls`` timed ones, and prints:

- ms per iteration and its split by ``network.solver_stats``: the score
  and gradient, the line search's probes, and the rest (the host's
  float64 algebra, ``get_flat_params`` and ``set_flat_params``);
- the score and gradient taken apart, each stage alone and synchronised,
  ``--reps`` times: the float64 → float32 cast on the host, the copy to
  the card, the forward, the backward, the gradient's copy back and its
  cast to float64;
- the host's float64 work alone: the solver's L-BFGS two-loop
  recursion (``optimize/function._lbfgs_direction``) with 4 pairs of
  vectors of the network's size, and ``get_flat_params`` /
  ``set_flat_params``;
- under ``torch.profiler`` (CPU + CUDA activity) one more
  ``optimize``: the card's busy time (the union of kernel and copy
  intervals) and idle share, and the host operators that took most time;
- the peak of allocated device memory above what was live before, of
  one ``optimize`` and of one ``pretrain`` pass (the three RBMs, CD-1)
  over the batch; what the params take, what was live before those
  two (the params, the batch and what earlier calls left allocated)
  and the process's peak since it started.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/torch_solver_profile.py [--batch 1024] [--calls 4] [--reps 20]

The last line is one JSON object with the numbers above. Without a card
it exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ms(fn, reps: int, sync) -> float:
    fn()
    sync()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
        sync()
    return (time.perf_counter() - t) / reps * 1e3


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--calls", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, HERE)
    import chip_smoke
    from deeplearning4j_tpu_torch.cli import driver
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.optimize import Solver
    from deeplearning4j_tpu_torch.optimize.function import _lbfgs_direction
    from deeplearning4j_tpu_torch.optimize.solver import new_solver_stats

    card = chip_smoke.card_line()
    sync = torch.cuda.synchronize
    net = driver._net_from_document(chip_smoke.dbn_document())
    x, labels = chip_smoke.dbn_data(args.batch)
    xd = torch.from_numpy(x).cuda()
    yd = torch.nn.functional.one_hot(
        torch.from_numpy(labels), chip_smoke.DBN_WIDTHS[-1]).float().cuda()
    ds = DataSet(xd, yd)
    Solver(net).optimize(ds)  # warm-up
    net.solver_stats = new_solver_stats()
    for _ in range(args.calls):
        Solver(net).optimize(ds)
    st = net.solver_stats
    n = st["iterations"]
    split = {"ms_per_iteration": 1e3 * st["total_s"] / n,
             "score_and_grad_ms": 1e3 * st["value_and_grad_s"] / n,
             "probes_ms": 1e3 * st["score_s"] / n,
             "probes_per_iteration": st["score_calls"] / n,
             "rest_ms": 1e3 * (st["total_s"] - st["value_and_grad_s"]
                               - st["score_s"]) / n}
    print(f"solver LBFGS [{args.batch}] {n} iterations: "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
          + f" [{card}]")

    # the score and gradient, stage by stage
    solver = Solver(net)
    params64 = net.get_flat_params().astype(np.float64)
    host32 = torch.from_numpy(params64.astype(np.float32))
    flat = host32.cuda().requires_grad_()

    def loss_of(f):
        loss, _ = net._loss_and_state(solver._unflatten(f), net.net_state,
                                      xd, yd, None, None, rng=None,
                                      train=False)
        return loss

    def fwd_bwd():
        (g,) = torch.autograd.grad(loss_of(flat), flat)
        return g

    grad = fwd_bwd()
    stages = {
        "cast_f64_to_f32_ms": _ms(lambda: params64.astype(np.float32),
                                  args.reps, sync),
        "copy_to_card_ms": _ms(lambda: host32.cuda(), args.reps, sync),
        "forward_ms": _ms(lambda: loss_of(flat.detach()), args.reps, sync),
        "forward_backward_ms": _ms(fwd_bwd, args.reps, sync),
        "copy_from_card_ms": _ms(lambda: grad.cpu(), args.reps, sync),
        "cast_f32_to_f64_ms": _ms(
            lambda: grad.cpu().numpy().astype(np.float64), args.reps, sync),
    }
    print("score+grad stages: " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items()) + f" [{card}]")

    # the host's float64 work alone
    rng = np.random.default_rng(0)
    size = params64.size
    s_list = [rng.normal(size=size) for _ in range(4)]
    y_list = [rng.normal(size=size) for _ in range(4)]
    g64 = rng.normal(size=size)

    host = {
        "lbfgs_two_loop_4_pairs_ms": _ms(
            lambda: _lbfgs_direction(g64, s_list, y_list), args.reps, sync),
        "get_flat_params_ms": _ms(net.get_flat_params, args.reps, sync),
        "set_flat_params_ms": _ms(
            lambda: net.set_flat_params(params64.astype(np.float32)),
            args.reps, sync),
    }
    print("host: " + ", ".join(f"{k} {v:.4f}" for k, v in host.items())
          + f" [{card}]")

    # one optimize under the profiler
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        Solver(net).optimize(ds)
        sync()
        wall = time.perf_counter() - t
    intervals = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type.name == "CUDA")
    busy, end = 0.0, None
    for a, b in intervals:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    busy_s = busy / 1e6
    top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    top_ops = {e.key: round(e.self_cpu_time_total / 1e3, 3)
               for e in top[:8]}
    print(f"profiled optimize: wall {wall * 1e3:.3f} ms, card busy "
          f"{busy_s * 1e3:.3f} ms, idle share {1 - busy_s / wall:.4f}; "
          f"top host ops (self ms): {top_ops} [{card}]")

    def peak_above(fn) -> int:
        sync()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        fn()
        sync()
        return torch.cuda.max_memory_allocated() - live

    mem = {"params_bytes": 4 * net.num_params(),
           "live_bytes_before": torch.cuda.memory_allocated(),
           "process_peak_bytes": torch.cuda.max_memory_allocated(),
           "optimize_peak_bytes": peak_above(lambda: Solver(net).optimize(ds)),
           "pretrain_peak_bytes": peak_above(lambda: net.pretrain([ds]))}
    print("memory: " + ", ".join(f"{k} {v}" for k, v in mem.items())
          + f" [{card}]")
    print(json.dumps({"card": card, "batch": args.batch, "iterations": n,
                      **split, **stages, **host,
                      "profiled_wall_ms": wall * 1e3,
                      "card_busy_ms": busy_s * 1e3,
                      "idle_share": 1 - busy_s / wall,
                      "top_host_ops_self_ms": top_ops, **mem}))


if __name__ == "__main__":
    main()
