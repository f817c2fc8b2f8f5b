#!/usr/bin/env python3
"""How far model-split runs of the MNIST MLP part from one device, by
learning rate, and whether the float32 gate sees a wrong gradient norm.

``chip_smoke.py``'s phase 16 holds two cells on the MNIST MLP
(784-256-256-10, the zoo's seed and init) on SGD against one device at
rtol 1e-4 / atol 1e-6:

- (f) ``ParallelWrapper`` over ``data=2 × model=2``, 3 fits of its
  seeded ``[4096, 784]`` batches, under each gradient normalization by
  L2 norms;
- (g) ``ParallelWrapper(fsdp=True)`` over ``data=2 × model=2`` under
  ``ClipL2PerLayer``: the same 3 fits, then ``fit_epochs`` on
  bench_epoch's data (its gate takes the params and the loss history).

This script runs both cells in a gloo world of 4 processes and prints,
for each learning rate, in units of that gate (the largest ``|a - b| /
(atol + rtol·|b|)``; under 1 passes). For (f), by mode:

- ``split``: the split run against one device;
- ``unreduced``: the split run with each split layer's squared norms
  left unsummed over ``model`` (every rank normalizing by its own
  shard's norm: the fault the cell must catch) against one device;
- ``moved``: one device with the mode against one device without
  normalization (how far the mode moves the result at all).

For (g), under mode ``None`` and ``ClipL2PerLayer``, cell (g)'s fits and
``fit_epochs`` against one device on three layouts: ``tp`` (the split
over ``data=2 × model=2`` without FSDP), ``fsdp data=4`` (FSDP alone)
and ``tp+fsdp`` (cell (g) itself); under ``ClipL2PerLayer`` also
``tp+fsdp unreduced`` (the control, as above).

Mode ``None`` shows what a layout alone does: its GEMMs and reductions
round in another order, and large SGD steps carry that past the gate.

From the repository root, on the CPU in about 3 minutes, or with
``--device cuda`` on one card (the 4 ranks share it, as phase 16's do):

    python3 scripts/torch_split_norm_witness.py [--device cpu|cuda] [LR ...]
    # default LRs 0.1 0.01 0.001
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("None", "RenormalizeL2PerLayer", "ClipL2PerLayer",
         "RenormalizeL2PerParamType", "ClipL2PerParamType")
G_MODES = ("None", "ClipL2PerLayer")
RANKS = 4


def rank_main(rank: int, store: str, lr: float, device: str) -> None:
    import torch

    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, HERE)
    import chip_smoke as smoke
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.nn.updater import split_sq_norms
    from deeplearning4j_tpu_torch.parallel import (
        MeshSpec, ParallelWrapper, build_mesh, join_world, leave_world)
    from deeplearning4j_tpu_torch.parallel import tensor_parallel

    smoke.MODEL_L2_LR = lr
    join_world(store, rank, RANKS, backend="gloo")
    m22 = build_mesh(MeshSpec(data=2, model=2), device=device)
    m4 = build_mesh(MeshSpec(data=RANKS), device=device)
    batches = smoke.mesh_batches()
    it = ListDataSetIterator(smoke.epoch_data(), smoke.EPOCH_BATCH)
    reduced = tensor_parallel._SplitNorms.__call__

    def unreduced(self, items, grads):
        return split_sq_norms(items, grads, self.split, lambda v: v)

    def run(mode, mesh=m22, fsdp=False, cut=False, epochs=0):
        """The wrapper's run: ``(params, history)`` gathered."""
        w = ParallelWrapper(smoke.l2_mlp(mode, device), mesh=mesh,
                            fsdp=fsdp)
        if cut:
            tensor_parallel._SplitNorms.__call__ = unreduced
        try:
            w.fit(batches)
            hist = w.fit_epochs(it, epochs) if epochs else None
        finally:
            tensor_parallel._SplitNorms.__call__ = reduced
        return w.gather()[0], hist

    def one_device(mode, epochs=0):
        net = smoke.l2_mlp(mode, device)
        net.fit(batches)
        hist = net.fit_epochs(it, epochs) if epochs else None
        return net.params, hist

    def share(got, want):
        (p, h), (q, g) = got, want
        return max([smoke.gate_ratio(p, q)]
                   + ([] if h is None else [smoke.gate_ratio(h, g)]))

    plain = one_device("None")
    f = {}
    for mode in MODES:
        ref = one_device(mode)
        f[mode] = {"split": share(run(mode), ref)}
        if mode != "None":
            f[mode]["unreduced"] = share(run(mode, cut=True), ref)
            f[mode]["moved"] = share(ref, plain)
    g = {}
    epochs = smoke.MODEL_FSDP_EPOCHS
    for mode in G_MODES:
        ref = one_device(mode, epochs)
        g[mode] = {
            name: share(run(mode, mesh, fsdp, epochs=epochs), ref)
            for name, mesh, fsdp in (("tp", m22, False),
                                     ("fsdp data=4", m4, True),
                                     ("tp+fsdp", m22, True))}
        if mode != "None":
            g[mode]["tp+fsdp unreduced"] = share(
                run(mode, m22, True, cut=True, epochs=epochs), ref)
    leave_world()
    if rank == 0:
        print(json.dumps({"lr": lr, "device": device,
                          "gate_units": {"f": f, "g": g}}), flush=True)


def main() -> None:
    args = sys.argv[1:]
    if args[:1] == ["--rank"]:
        rank_main(int(args[1]), args[2], float(args[3]), args[4])
        return
    device = "cpu"
    if args[:1] == ["--device"]:
        device, args = args[1], args[2:]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": HERE}
    if device == "cuda":   # the card's name and power limit
        subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], check=True)
    for lr in args or ("0.1", "0.01", "0.001"):
        with tempfile.TemporaryDirectory() as tmp:
            store = os.path.join(tmp, "store")
            procs = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank",
                 str(r), store, lr, device], env=env) for r in range(RANKS)]
            codes = [p.wait() for p in procs]
        if any(codes):
            sys.exit(f"lr {lr}: ranks exited {codes}")


if __name__ == "__main__":
    main()
