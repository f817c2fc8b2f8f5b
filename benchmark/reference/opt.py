"""Plain PyTorch reference of the benchmark's OPT configurations, as the
port's block computes them (see each configuration's ``departures``).

Pre-norm decoder: learned positions added to the token embedding; each
block ``h += Wo·attn(LN1(h))`` with causal softmax attention over heads of
``hidden_size / num_attention_heads`` columns scaled by ``1/sqrt(head)``,
then ``h += W2·gelu_tanh(W1·LN2(h) + b1) + b2``; a final norm and the tied
unembedding. LayerNorm uses the population variance and eps 1e-5.

Everything is float32, and the caller turns TF32 off (:func:`strict_f32`).
``fp8=True`` is the benchmark's control: every matrix product takes its two
operands rounded to float8 e4m3 with one absmax scale per tensor, forward
and backward, the precision below the configurations' bf16 compute. The
parameters are a nested dict in the port's layout (``embed``, ``pos``,
``ln_f``, ``blocks[i].{ln1, attn.{wq, wk, wv, wo}, ln2, mlp.{w1, b1, w2,
b2}}``, weights ``[in, out]``), made by the benchmark from the seed.
Imports torch alone.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
E4M3_MAX = 448.0


def strict_f32() -> None:
    """Float32 products in float32: TF32 off in both backends."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one absmax scale, back in f32."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` on e4m3-rounded operands; the backward's products round
    theirs too."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = to_fp8(a), to_fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = to_fp8(g)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


def matmul(a: torch.Tensor, b: torch.Tensor, fp8: bool) -> torch.Tensor:
    return _Fp8Matmul.apply(a, b) if fp8 else a @ b


def layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps) * g + b


def attention(x: torch.Tensor, attn: Dict[str, torch.Tensor], heads: int,
              fp8: bool) -> torch.Tensor:
    """Causal self-attention of one sequence ``x [t, D]``."""
    t, d = x.shape
    hd = d // heads
    q = matmul(x, attn["wq"], fp8).reshape(t, heads, hd).transpose(0, 1)
    k = matmul(x, attn["wk"], fp8).reshape(t, heads, hd).transpose(0, 1)
    v = matmul(x, attn["wv"], fp8).reshape(t, heads, hd).transpose(0, 1)
    s = matmul(q, k.transpose(-1, -2), fp8) / math.sqrt(hd)     # [H, t, t]
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(s.masked_fill(~causal, -math.inf), dim=-1)
    o = matmul(p, v, fp8).transpose(0, 1).reshape(t, d)
    return matmul(o, attn["wo"], fp8)


def hidden(params, tokens: torch.Tensor, cfg: dict, fp8: bool = False
           ) -> torch.Tensor:
    """The final-normed hidden states ``[t, D]`` of one sequence."""
    heads = cfg["num_attention_heads"]
    h = params["embed"][tokens] + params["pos"][:tokens.shape[0]]
    for blk in params["blocks"]:
        h = h + attention(layernorm(h, blk["ln1"]["g"], blk["ln1"]["b"]),
                          blk["attn"], heads, fp8)
        x = layernorm(h, blk["ln2"]["g"], blk["ln2"]["b"])
        mlp = blk["mlp"]
        x = F.gelu(matmul(x, mlp["w1"], fp8) + mlp["b1"], approximate="tanh")
        h = h + matmul(x, mlp["w2"], fp8) + mlp["b2"]
    return layernorm(h, params["ln_f"]["g"], params["ln_f"]["b"])


def logits(params, tokens: torch.Tensor, cfg: dict, fp8: bool = False,
           positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Logits ``[n, V]`` of one sequence at ``positions`` (all by default)."""
    h = hidden(params, tokens, cfg, fp8)
    if positions is not None:
        h = h[positions]
    return matmul(h, params["embed"].t(), fp8)


def leaves(tree, prefix: str = "") -> List[tuple]:
    """``(path, tensor)`` of every leaf, in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def loss_and_grads(params, batch: torch.Tensor, cfg: dict, fp8: bool = False
                   ) -> tuple:
    """Mean next-token cross entropy of ``batch [b, t]`` and its gradient
    by leaf, one row at a time (each row's share of the mean), so that one
    row's activations are alive at once."""
    ws = [w for _, w in leaves(params)]
    for w in ws:
        w.requires_grad_(True)
    grads = [torch.zeros_like(w) for w in ws]
    b, t = batch.shape
    total = 0.0
    for row in batch:
        lg = logits(params, row[:-1], cfg, fp8)
        nll = F.cross_entropy(lg, row[1:], reduction="sum") / (b * (t - 1))
        for acc, g in zip(grads, torch.autograd.grad(nll, ws)):
            acc += g
        total += float(nll.detach())
    for w in ws:
        w.requires_grad_(False)
    return total, grads


@torch.no_grad()
def adam_(ws: Sequence[torch.Tensor], grads, ms, vs, step: int,
          lr: float) -> None:
    """One Adam step, in place, with bias correction at step ``step``
    (1 for the first)."""
    bc1, bc2 = 1 - ADAM_B1 ** step, 1 - ADAM_B2 ** step
    for w, g, m, v in zip(ws, grads, ms, vs):
        m.mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
        v.mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
        w.sub_(lr * (m / bc1) / ((v / bc2).sqrt() + ADAM_EPS))


def train_readings(params, batches: Sequence[torch.Tensor], cfg: dict,
                   lr: float, fp8: bool = False) -> dict:
    """Adam from ``params`` over ``batches`` (updated in place): each
    step's loss, the first step's gradient by leaf (``first_grad``) and
    its norm, and each leaf's change after the last step, norms in
    float64."""
    named = leaves(params)
    ws = [w for _, w in named]
    start = [w.clone() for w in ws]
    ms = [torch.zeros_like(w) for w in ws]
    vs = [torch.zeros_like(w) for w in ws]
    losses, first_grad = [], None
    for step, batch in enumerate(batches, start=1):
        loss, grads = loss_and_grads(params, batch, cfg, fp8)
        losses.append(loss)
        if first_grad is None:
            first_grad = [g.clone() for g in grads]
        adam_(ws, grads, ms, vs, step, lr)
        del grads
    change = [float((w.double() - s.double()).norm())
              for w, s in zip(ws, start)]
    names = [n for n, _ in named]
    return {"losses": losses,
            "grad_norm": dict(zip(names, (float(g.double().norm())
                                          for g in first_grad))),
            "first_grad": dict(zip(names, first_grad)),
            "change_norm": dict(zip(names, change))}
