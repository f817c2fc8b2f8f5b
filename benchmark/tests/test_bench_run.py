"""``run.py`` without a card, in a bare directory, and the import check of
a whole run."""

import json
import os
import shutil
import subprocess
import sys

from bench_tiny import BENCH, ROOT, cells, make_root

RUN = os.path.join(BENCH, "run.py")


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, RUN, "--workload", "opt-2.7b.train", "--seed",
         str(2**31 + 9), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_run_in_a_directory_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "opt-1.3b.chat",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_a_whole_run_loads_neither_jax_nor_its_package(tmp_path):
    """Set-up, window, check and readers of every cell in one process
    (on the CPU, the tiny cells): no loaded module's top-level name is
    ``jax``, ``jaxlib``, ``flax`` or ``deeplearning4j_tpu``."""
    make_root(str(tmp_path))
    code = f"""
import json, sys, time
sys.path.insert(0, {ROOT!r})
from benchmark import harness, run
for cell in {cells()!r}:
    c = harness.load_cell({str(tmp_path)!r}, cell, seed=2**31 + 3,
                          seconds=0.8, trace=True, device="cpu")
    harness.run(c, time.monotonic())
print(json.dumps(run.loaded_forbidden()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
