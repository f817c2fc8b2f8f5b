#!/usr/bin/env python3
"""Where the two packages' LBFGS runs part on a penalty-free conf.

Takes ``tests/test_torch_cli.py``'s separable toy CSV (80 rows, 4
features, 2 classes, ``default_rng(12345)``) and its LBFGS document with
no L2 penalty (3 iterations a batch, batches of 16) through the CLI
drivers' own steps for 2 epochs, in the JAX package and in the port,
each in float32 and in float64, all four from the JAX package's float32
init. Prints the largest absolute difference of the flat params and the
relative difference of the final score for each pair:

- port float32 against JAX float32 (the gap the tests' L2 hides);
- each package in float32 against itself in float64 (its own rounding);
- port float64 against JAX float64 (the same steps without rounding).

Runs on the CPU in about 10 s, from the repository root:

    python3 scripts/lbfgs_float_witness.py
"""

from __future__ import annotations

import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    import test_torch_cli as T
    from deeplearning4j_tpu import dtypes as jax_dtypes
    from deeplearning4j_tpu.cli import driver as jax_driver
    from deeplearning4j_tpu_torch.cli import driver
    from deeplearning4j_tpu_torch.models.convert import load_network_from_jax

    rng = np.random.default_rng(12345)
    x = np.concatenate([rng.normal(-2, 0.5, (40, 4)),
                        rng.normal(2, 0.5, (40, 4))])
    y = np.repeat([0, 1], 40)
    order = rng.permutation(80)
    tmp = tempfile.mkdtemp()
    csv = os.path.join(tmp, "data.csv")
    with open(csv, "w") as f:
        for i in order:
            f.write(",".join(f"{v:.5f}" for v in x[i]) + f",{y[i]}\n")
    doc = T._lbfgs_doc(l2=None)
    argv = ["train", "-input", csv, "-model", "m", "-output", "o",
            "--num-classes", "2", "--batch-size", "16"]

    def run(float64):
        ref = jax_driver._net_from_document(doc)
        port = driver._net_from_document(doc, device="cpu")
        if float64:
            ref, port = T._in_float64(ref, port)
        else:
            load_network_from_jax(
                port, jax.tree_util.tree_map(np.asarray, ref.params),
                jax.tree_util.tree_map(np.asarray, ref.updater_state))
        out = {}
        for name, net, drv in (("jax", ref, jax_driver),
                               ("port", port, driver)):
            it = drv._build_iterator(drv.build_parser().parse_args(argv), {})
            for _ in range(2):
                it.reset()
                net.fit(it)
            out[name] = (np.asarray(net.get_flat_params(), np.float64),
                         float(net.score_value))
        return out

    f32 = run(False)
    with jax.enable_x64(True), jax_dtypes.policy_scope(jax_dtypes.FLOAT64):
        f64 = run(True)
    for label, (pa, sa), (pb, sb) in (
            ("port f32 vs jax f32", f32["port"], f32["jax"]),
            ("jax f32 vs jax f64", f32["jax"], f64["jax"]),
            ("port f32 vs port f64", f32["port"], f64["port"]),
            ("port f64 vs jax f64", f64["port"], f64["jax"])):
        gap = float(np.abs(pa - pb).max())
        print(f"{label}: params max abs diff {gap!r}, "
              f"score rel diff {abs(sa - sb) / abs(sb)!r}")


if __name__ == "__main__":
    main()
