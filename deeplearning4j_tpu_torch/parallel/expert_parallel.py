"""Expert parallelism: a mixture-of-experts FFN split over an ``expert``
axis.

Port of ``deeplearning4j_tpu/parallel/expert_parallel.py``. GShard-style
top-k gating under a capacity limit routes each token to up to ``top_k``
experts; the tokens land in an expert-major ``[E, C, d]`` buffer, each
expert runs its FFN on its rows, and the outputs are combined back
weighted by the gates. The Switch/GShard auxiliary loss
(E · Σ_e fraction_tokens(e) · mean_gate_prob(e)) balances the load.

The reference's dispatch and combine are one-hot einsums over ``[T, E,
C]``; the port gathers instead (a slot's token index, a token's slots),
which computes the same outputs without the ``T²``-sized tensors.

Over ``expert`` (``mesh=``) the tokens are replicated within the expert
group (as in the reference's ``data × expert`` mesh: each data group
routes its own tokens) and each rank runs its ``E/n`` experts on its
slice of the ``[E, C, d]`` buffer; one g (``SumSharesFn``) sums the
combine over ``expert``. The gates and the tokens enter the per-rank
experts through f (``CopyToShardsFn``), so the router's gradient counts
every expert's combine share once and the auxiliary loss once. The
GShard all-to-all for tokens split across the expert ranks is later
speed work (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.parallel.mesh import (
    EXPERT_AXIS,
    axis_group,
    axis_rank,
    axis_size,
    shard_leading_axis,
)

__all__ = ["MoEConfig", "init_moe_params", "shard_moe_params",
           "expert_capacity", "moe_ffn"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int
    n_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 1e-2

    def __post_init__(self):
        if self.top_k > self.n_experts:
            raise ValueError(
                f"top_k={self.top_k} > n_experts={self.n_experts}: a token "
                "would be dispatched to the same expert twice")


def init_moe_params(cfg: MoEConfig, generator: torch.Generator, *,
                    device=None, dtype=torch.float32
                    ) -> Dict[str, torch.Tensor]:
    """Router and stacked per-expert FFN weights (``[E, ...]`` leading
    axis), drawn from ``generator`` (a CPU generator, so a seed gives the
    same weights on every device) with the reference's scales, on
    ``device`` (default the card). The draws are not the reference's
    ``jax.random`` ones; carry those with
    ``models/convert.params_from_jax``."""
    device = resolve_device(device)
    s_in = 1.0 / math.sqrt(cfg.d_model)
    s_ff = 1.0 / math.sqrt(cfg.d_ff)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype)

    params = {"Wg": normal(d, e) * s_in, "W1": normal(e, d, f) * s_in,
              "b1": torch.zeros(e, f, dtype=dtype),
              "W2": normal(e, f, d) * s_ff,
              "b2": torch.zeros(e, d, dtype=dtype)}
    return {k: v.to(device) for k, v in params.items()}


def shard_moe_params(params, mesh, axis_name: str = EXPERT_AXIS):
    """This rank's experts of the stacked expert weights (``E/n`` each);
    the router stays whole (every rank routes the tokens)."""
    out = shard_leading_axis({k: v for k, v in params.items() if k != "Wg"},
                             mesh, axis_name)
    out["Wg"] = params["Wg"]
    return out


def expert_capacity(n_tokens: int, cfg: MoEConfig) -> int:
    cap = int(math.ceil(cfg.capacity_factor * cfg.top_k * n_tokens
                        / cfg.n_experts))
    return max(cap, 1)


def _top_k_dispatch(gates: torch.Tensor, capacity: int, top_k: int):
    """The routing of ``gates [T, E]`` (softmax router outputs): for
    each of the ``top_k`` rounds, every token's expert ``[T]``, its
    position in that expert's buffer ``[T]`` and whether it fits
    (``keep [T]``); position counters carry across rounds, so a second
    choice never collides with first-choice traffic. Ties pick the lower
    expert, as ``argmax`` does in both packages. Returns ``(rounds,
    aux)``, ``aux`` the Switch load-balance loss on first choices."""
    n_experts = gates.shape[1]
    fill = torch.zeros(n_experts, dtype=torch.long, device=gates.device)
    remaining = gates.detach()
    rounds = []
    for _ in range(top_k):
        choice = torch.argmax(remaining, dim=-1)                   # [T]
        onehot = F.one_hot(choice, n_experts)                      # [T, E]
        before = torch.cumsum(onehot, dim=0) - onehot
        pos = before.gather(1, choice[:, None])[:, 0] + fill[choice]
        keep = pos < capacity
        fill = fill + (onehot * keep[:, None]).sum(dim=0)
        remaining = remaining * (1 - onehot).to(remaining.dtype)
        rounds.append((choice, pos, keep))
    first = F.one_hot(torch.argmax(gates, dim=-1),
                      n_experts).to(gates.dtype)
    aux = n_experts * torch.sum(first.mean(dim=0) * gates.mean(dim=0))
    return rounds, aux


def _local_experts(params, n_experts: int, n: int, r: int):
    """This rank's expert weights (``params`` whole or already its
    part)."""
    lead = params["W1"].shape[0]
    if lead == n_experts // n:
        return params
    if lead != n_experts:
        raise ValueError(f"expert weights stack {lead} experts; expected "
                         f"{n_experts} or {n_experts // n}")
    e = n_experts // n
    return {k: (v if k == "Wg" else v[r * e:(r + 1) * e])
            for k, v in params.items()}


def moe_ffn(params: Dict[str, torch.Tensor], x: torch.Tensor,
            cfg: MoEConfig, mesh=None, *, axis_name: str = EXPERT_AXIS
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE feed-forward: ``x [..., d_model]`` → ``(y [..., d_model],
    aux_loss)``. Dropped tokens (over capacity in every round) give zero
    rows. With ``mesh`` carrying ``axis_name``, every rank of the expert
    group is given the same tokens and runs its own experts."""
    lead = x.shape[:-1]
    xt = x.reshape(-1, cfg.d_model)
    n_tokens = xt.shape[0]
    cap = expert_capacity(n_tokens, cfg)
    n_exp = cfg.n_experts
    gates = torch.softmax(xt @ params["Wg"], dim=-1)               # [T, E]
    rounds, aux = _top_k_dispatch(gates, cap, cfg.top_k)

    n = axis_size(mesh, axis_name) if mesh is not None else 1
    r = axis_rank(mesh, axis_name) if n > 1 else 0
    group = axis_group(mesh, axis_name) if n > 1 else None
    if n_exp % n:
        raise ValueError(f"{n_exp} experts do not split over {n} ranks")
    p = _local_experts(params, n_exp, n, r)
    e_local = n_exp // n
    x_in, g_in = xt, gates
    if group is not None:
        from deeplearning4j_tpu_torch.parallel.collectives import (
            CopyToShardsFn)

        x_in = CopyToShardsFn.apply(xt, group)
        g_in = CopyToShardsFn.apply(gates, group)

    # dispatch: each of this rank's slots holds a token index (T: none)
    tok = torch.arange(n_tokens, device=xt.device)
    lo = r * e_local
    slot_token = torch.full((e_local * cap,), n_tokens, dtype=torch.long,
                            device=xt.device)
    slots = []
    for choice, pos, keep in rounds:
        mine = keep & (choice >= lo) & (choice < lo + e_local)
        slot = (choice - lo) * cap + pos.clamp(max=cap - 1)
        slot_token[slot[mine]] = tok[mine]
        slots.append((slot, mine, choice))
    padded = torch.cat([x_in, x_in.new_zeros(1, cfg.d_model)])
    exp_in = padded[slot_token].reshape(e_local, cap, cfg.d_model)
    h = F.relu(torch.bmm(exp_in, p["W1"]) + p["b1"][:, None, :])
    exp_out = (torch.bmm(h, p["W2"]) + p["b2"][:, None, :]).reshape(
        e_local * cap, cfg.d_model)

    # combine: each token's kept slots on this rank, weighted by its gate
    y = torch.zeros_like(xt)
    for slot, mine, choice in slots:
        w = g_in.gather(1, choice[:, None])[:, 0] * mine
        y = y + w[:, None] * exp_out[slot.clamp(0, e_local * cap - 1)]
    if group is not None:
        from deeplearning4j_tpu_torch.parallel.collectives import SumSharesFn

        y = SumSharesFn.apply(y, group)
    return y.reshape(lead + (cfg.d_model,)), cfg.aux_loss_weight * aux
