"""The plain reference against the port on the CPU at a tiny width, and
the comparisons that decide ``correct``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import program, weights
from benchmark.drivers import train
from benchmark.reference import opt as ref

from bench_tiny import BENCH, ROOT, TINY

CPU = torch.device("cpu")


def _cfg(policy="float32"):
    cfg = json.load(open(os.path.join(BENCH, "configs", "opt-1.3b.json")))
    cfg.update(TINY)
    cfg["assumed"] = dict(cfg["assumed"], dtype_policy=policy)
    return cfg


def test_reference_logits_equal_the_port_in_float32():
    cfg = _cfg()
    params = weights.draw(cfg, 2**31 + 5, CPU)
    lm = program.build_lm(cfg, params, CPU)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, 1024, 40))
    port = lm.forward(lm.params, tokens[None])[0]
    ours = ref.logits(weights.draw(cfg, 2**31 + 5, CPU), tokens, cfg)
    torch.testing.assert_close(ours, port.float(), rtol=1e-4, atol=1e-4)
    at = torch.tensor([3, 39])
    torch.testing.assert_close(
        ref.logits(weights.draw(cfg, 2**31 + 5, CPU), tokens, cfg,
                   positions=at), ours[at])


def test_reference_steps_equal_the_port_in_float32():
    cfg = _cfg()
    seed = 77
    params = weights.draw(cfg, seed, CPU)
    batches = weights.token_batches(1024, (2, 32), 3, seed, CPU)
    lm = program.build_lm(cfg, params, CPU, lr=3e-4, adam=True)
    losses = [lm.fit_batch(b) for b in batches]
    got = ref.train_readings(weights.draw(cfg, seed, CPU), list(batches),
                             cfg, 3e-4)
    np.testing.assert_allclose(losses, got["losses"], rtol=1e-5)
    for n, w in ref.leaves(lm.params):
        start = dict(ref.leaves(weights.draw(cfg, seed, CPU)))[n]
        assert float((w - start).norm()) == pytest.approx(
            got["change_norm"][n], rel=2e-3, abs=1e-7)


def test_compare_takes_the_worst_leaf_against_the_median_floor():
    t = torch.tensor
    refr = {"losses": [10.0, 9.0], "grad_norm": {"a": 1.0, "b": 2.0,
                                                 "c": 1e-9},
            "first_grad": {"a": t([1.0, 0.0]), "b": t([2.0, 0.0]),
                           "c": t([1e-9, 0.0])},
            "change_norm": {"a": 1.0, "b": 1.0, "c": 1.0}}
    prog = {"losses": [10.1, 9.0], "grad_norm": {"a": 1.1, "b": 2.0,
                                                 "c": 0.0},
            # b's norm is the reference's, its direction is not
            "first_grad": {"a": t([1.0, 0.2]), "b": t([0.0, 2.0]),
                           "c": t([0.0, 0.0])},
            "change_norm": {"a": 1.0, "b": 1.5, "c": 9.0}}
    got = train.compare(prog, refr, worst=True)
    assert got["loss_gap"] == pytest.approx(0.01)
    assert got["grad_norm_gap"] == pytest.approx(0.1)
    # leaf c's reference gradient is under a thousandth of the median's
    assert got["change_norm_gap"] == pytest.approx(0.5)
    assert got["grad_diff"] == pytest.approx(8 ** 0.5 / 2)
    assert got["grad_diff_leaf"] == "b"


def test_the_train_drivers_first_gradient_equals_the_reference_in_float32(
        tmp_path):
    from benchmark import harness

    from bench_tiny import make_root

    make_root(str(tmp_path))
    cell = harness.load_cell(str(tmp_path), "opt-2.7b.train",
                             seed=2**31 + 7, seconds=1, trace=False,
                             device="cpu")
    cell.cfg["assumed"] = dict(cell.cfg["assumed"], dtype_policy="float32")
    state = train.setup(cell)
    got = train.compare(state["readings"], train.reference_readings(cell))
    assert got["grad_diff"] < 1e-4 and got["grad_norm_gap"] < 1e-4, got


def test_fp8_rounds_to_eight_bits_under_one_scale():
    x = torch.linspace(-3.0, 3.0, 1001)
    q = ref.to_fp8(x)
    assert q.abs().max() == pytest.approx(3.0)
    assert (q - x).abs().max() / 3.0 < 2 ** -4
    assert len(torch.unique(q)) < 256


def test_reference_imports_torch_alone():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.opt; "
            "tops = {m.split('.')[0] for m in sys.modules}; "
            "bad = tops & {'jax', 'jaxlib', 'flax', 'deeplearning4j_tpu', "
            "'deeplearning4j_tpu_torch'}; "
            "print(sorted(bad)); sys.exit(1 if bad else 0)") % ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
