"""Read the numbers that decide ``correct`` on many seeds, to set each limit
between its two readings (``benchmark/limits/<cell>.json``).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds 10]

For each of ``--seeds`` it runs the cell's program path as a run does
(a train cell's set-up steps; a serving cell's window of ``--seconds``
and its sample of finished requests) and compares it with the reference:
the lower readings. For each of ``--control-seeds`` it puts the
reference computed in float8 (the precision below the configurations'
bf16) in the program's place: the control's readings. For a train cell,
each of ``--fault-seeds`` also runs the program with the loss taken over
half of the batch (its first rows, or its first positions for a batch of
one). One JSON line per reading, then a summary line: the largest
reading of the program and the least of the control and the fault by
number (a train cell's lines also name the leaf of each worst leaf's
number), all on standard output. Needs a card.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def half_batch_loss():
    """The port's loss over the first half of the batch's rows (of its
    positions when it has one row), the mean taken over the rest."""
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM

    whole = TransformerLM.loss

    def half(self, params, tokens, **kw):
        tokens = self._tokens(tokens)
        b, t = tokens.shape
        tokens = tokens[:b // 2] if b > 1 else tokens[:, :t // 2]
        return whole(self, params, tokens, **kw)

    TransformerLM.loss = half
    try:
        yield
    finally:
        TransformerLM.loss = whole


def _free() -> None:
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def readings(cell, kind: str) -> dict:
    """One seed's numbers: the program's (``program``, ``half_batch``) or
    the control's (``control``)."""
    from benchmark.drivers import serving, train
    from benchmark.reference import opt as ref
    from benchmark import harness, trace

    ref.strict_f32()
    if cell.kind == "train":
        if kind == "control":
            return train.compare(train.reference_readings(cell, fp8=True),
                                 train.reference_readings(cell), worst=True)
        with (half_batch_loss() if kind == "half_batch"
              else contextlib.nullcontext()):
            state = train.setup(cell)
        train.release(state)
        _free()
        return train.compare(state["readings"],
                             train.reference_readings(cell), worst=True)
    drv = harness.driver(cell.kind)
    state = drv.setup(cell)
    win = drv.window(cell, state, trace.Stretch(False, 0.0, 0.0))
    drv.release(state)
    _free()
    checked = serving.sample(state["done"], cell.mix["check_requests"],
                             cell.seed)
    prog = serving.gaps(cell, checked)
    ctrl = serving.gaps(cell, checked, fp8=True)
    return {"logit_gap": prog["logit_gap"],
            "control_logit_gap": ctrl["logit_gap"],
            "tokens": prog["tokens"], "failed": win["failed"],
            **{k: v for k, v in win["metrics"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device is available", file=sys.stderr)
        return 2
    from benchmark import harness, program
    from benchmark.run import cache_env

    os.environ.update(cache_env(ROOT))
    program.point_kernel_cache(os.environ["DL4J_COMPILE_CACHE_DIR"])
    card = torch.cuda.get_device_name(0)
    runs = ([("program", s) for s in args.seeds.split(",") if s]
            + [("control", s) for s in args.control_seeds.split(",") if s]
            + [("half_batch", s) for s in args.fault_seeds.split(",") if s])
    worst: dict = {}
    for kind, seed in runs:
        cell = harness.load_cell(ROOT, args.workload, seed=int(seed),
                                 seconds=args.seconds, trace=False,
                                 device="cuda")
        if cell.kind != "train" and kind != "program":
            continue   # a serving seed reads the program and the control
        t = time.monotonic()
        got = readings(cell, kind)
        line = {"cell": args.workload, "kind": kind, "seed": int(seed),
                "card": card, "s": time.monotonic() - t, **got}
        print(json.dumps(line), flush=True)
        for k, v in got.items():
            if k in cell.limits or k.endswith("gap"):
                key = ("control", k[len("control_"):]) \
                    if k.startswith("control_") else (kind, k)
                pick = max if key[0] == "program" else min
                worst[key] = v if key not in worst else pick(worst[key], v)
    summary = {f"{kind}:{k}": v for (kind, k), v in sorted(worst.items())}
    print(json.dumps({"summary": summary, "cell": args.workload}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
