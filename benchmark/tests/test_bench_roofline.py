"""The frozen formulas equal the port's, at three shapes."""

import json
import os

import pytest
import torch

from benchmark import roofline

from bench_tiny import BENCH

SHAPES = [(4, 2048, 2048, 32, 80), (1, 2048, 2048, 32, 64),
          (16, 1024, 1024, 8, 64)]


@pytest.mark.parametrize("shape", SHAPES)
def test_flash_bounds_equal_the_port(shape):
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa

    fwd = fa.flash_bound(*shape, torch.bfloat16, causal=True)
    assert roofline.flash_fwd_bound_s(*shape, causal=True) * 1e3 \
        == pytest.approx(fwd["bound_ms"], rel=1e-12)
    bwd = fa.flash_bwd_bound(*shape, torch.bfloat16, causal=True)
    ours = roofline.flash_bwd_bound_s(*shape, causal=True)
    for k in ("dkdv", "dq"):
        assert ours[k] * 1e3 == pytest.approx(bwd[k]["bound_ms"], rel=1e-12)
    assert roofline.BF16_FLOPS == fa.H100_FLOPS[torch.bfloat16]
    assert roofline.BYTES_PER_S == fa.H100_BYTES_PER_S


@pytest.mark.parametrize("t", [64, 2048])
def test_train_flops_equal_the_port(t):
    from benchmark import program, weights

    cfg = json.load(open(os.path.join(BENCH, "configs", "opt-1.3b.json")))
    cfg.update(vocab_size=300, hidden_size=32, ffn_dim=96,
               num_hidden_layers=3, max_position_embeddings=t)
    lm = program.build_lm(cfg, weights.draw(cfg, 0, torch.device("cpu")),
                          torch.device("cpu"))
    assert roofline.train_flops_per_token(cfg, t) == lm.flops_per_token(t)
