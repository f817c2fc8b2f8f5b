"""The benchmark's yardstick: peaks of one H100 and the operations and bytes
of the work it measures.

A frozen copy of the port's formulas (``kernels/flash_attention.py``'s
``visible_keys``, ``flash_bound`` and ``flash_bwd_bound``, and
``TransformerLM.flops_per_token``), so that a later change to the program
cannot move the bar it is measured against. Peaks are NVIDIA's data sheet
for the SXM part, dense: 989 TFLOP/s in bf16, 3.35 TB/s of HBM.
"""

from __future__ import annotations

from typing import Optional

BF16_FLOPS = 989e12
BYTES_PER_S = 3.35e12


def visible_keys(tq: int, tkv: int, *, causal: bool,
                 window: Optional[int] = None) -> int:
    """Sum over query rows of the keys each row attends."""
    if not causal:
        return tq * tkv
    w = tq if window is None else min(window, tq)
    return w * (w + 1) // 2 + (tq - w) * w


def _bound_s(nbytes: int, flops: int) -> float:
    """Least seconds for ``nbytes`` moved and ``flops`` done in bf16."""
    return max(nbytes / BYTES_PER_S, flops / BF16_FLOPS)


def flash_fwd_bound_s(b: int, tq: int, tkv: int, h: int, d: int, *,
                      causal: bool, elem: int = 2) -> float:
    """B1: q, k, v read once, out written once (``elem`` bytes each), the
    f32 log-sum-exp written once; 4 FLOPs per visible (q, k) pair and
    head column."""
    nbytes = elem * (2 * b * tq * h * d + 2 * b * tkv * h * d) + 4 * b * h * tq
    flops = 4 * b * h * d * visible_keys(tq, tkv, causal=causal)
    return _bound_s(nbytes, flops)


def flash_bwd_bound_s(b: int, tq: int, tkv: int, h: int, d: int, *,
                      causal: bool, elem: int = 2) -> dict:
    """B2 (``dkdv``) and B3 (``dq``): both read q, k, v and do once and the
    f32 lse and delta; B2 writes dk, dv in f32 and does 8 FLOPs per pair
    and column, B3 writes dq in f32 and does 6."""
    reads = elem * (2 * b * tq * h * d + 2 * b * tkv * h * d) + 2 * 4 * b * h * tq
    pairs = b * h * d * visible_keys(tq, tkv, causal=causal)
    return {"dkdv": _bound_s(reads + 2 * 4 * b * tkv * h * d, 8 * pairs),
            "dq": _bound_s(reads + 4 * b * tq * h * d, 6 * pairs)}


def block_matmul_params(cfg: dict) -> int:
    """Every parameter of the blocks, as the port counts them: the four
    projections, the MLP with its biases, and the two norms (these few
    add under 0.1 % at the widths measured)."""
    d, f = cfg["hidden_size"], cfg["ffn_dim"]
    return cfg["num_hidden_layers"] * (4 * d * d + 2 * d * f + f + d + 4 * d)


def matmul_params(cfg: dict) -> int:
    """``block_matmul_params`` and the tied unembedding."""
    return block_matmul_params(cfg) + cfg["hidden_size"] * cfg["vocab_size"]


def train_flops_per_token(cfg: dict, t: int) -> float:
    """Model FLOPs of one trained token at sequence length ``t``: 6 per
    matmul weight plus 12 per layer, model column and average visible key
    (forward and backward of QKᵀ and PV), rounded down as the port
    rounds."""
    return int(6 * matmul_params(cfg)
               + 12 * cfg["num_hidden_layers"] * cfg["hidden_size"] * t / 2)
