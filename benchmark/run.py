"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout of the repository, on a machine with the card
the cell asks for. The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``check``: each number the
correctness check compared, with its limit); the same numbers are the last
lines of standard error. Without a card, or with fewer cards than the cell
asks for, it prints no result and exits 2; it exits 3 if JAX or the JAX
package was loaded. The build and kernel caches live under
``benchmark/.cache/`` in the checkout.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "deeplearning4j_tpu")
# settings of the port's server that the environment could change
PORT_KNOBS = ("DL4J_ATTN_IMPL", "DL4J_SERVE_SLOTS", "DL4J_SERVE_FUSE_STEPS",
              "DL4J_SERVE_KV_DTYPE", "DL4J_SERVE_DRAFT_LAYERS",
              "DL4J_SERVE_MAX_QUEUE", "DL4J_SERVE_DEADLINE_S",
              "DL4J_MESH_SHAPE", "DL4J_TP_SHARDS", "DL4J_DISABLE_BUCKETING",
              "DL4J_TELEMETRY_DIR")


def cache_env(root: str) -> dict:
    """Fixed cache directories inside the checkout."""
    cache = os.path.join(root, "benchmark", ".cache")
    return {"DL4J_COMPILE_CACHE_DIR": os.path.join(cache, "kernels"),
            "TRITON_CACHE_DIR": os.path.join(cache, "triton"),
            "TORCH_EXTENSIONS_DIR": os.path.join(cache, "torch_extensions"),
            "TORCHINDUCTOR_CACHE_DIR": os.path.join(cache, "inductor"),
            "CUDA_CACHE_PATH": os.path.join(cache, "nv"),
            "USE_FLAX": "0", "USE_JAX": "0"}


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that are JAX or its package."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for k in PORT_KNOBS:
        os.environ.pop(k, None)
    os.environ.update(cache_env(ROOT))
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("benchmark: no CUDA device is available", file=sys.stderr)
        return 2
    chips = next((w["chips"] for w in harness.load_bench(ROOT)["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"benchmark: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    from benchmark import program

    program.point_kernel_cache(os.environ["DL4J_COMPILE_CACHE_DIR"])
    cell = harness.load_cell(ROOT, args.workload, seed=args.seed,
                             seconds=args.seconds, trace=bool(args.trace),
                             device="cuda")
    result = harness.run(cell, T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"benchmark: loaded {', '.join(bad)}: the benchmark runs the "
              "port alone", file=sys.stderr)
        return 3
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
