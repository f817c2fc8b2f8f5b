"""What the two serving kinds share: the server and its warm-up, the record
of each request, and the check of served tokens against the reference.

The server is the port's ``DecodeServer`` (greedy, one decode step a
dispatch) over a ``TransformerLM`` holding the benchmark's weights. Set-up
warms every prompt bucket the mix's lengths fall in and the decode step of
all slots, by serving one short request a bucket through the server.

The check samples finished requests from the seed, the one with the most
generated tokens among them, and runs the reference once over each prompt
and its served tokens. A served token's gap is how far its reference logit
lies below the reference's best at the position that produced it; the
check compares the widest gap.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from benchmark import program, weights
from benchmark.reference import opt as ref


@dataclass
class Served:
    """One request of the window: when it was due (the host clock), its
    prompt and the port's request object (None when it was refused)."""

    due_s: float
    prompt: np.ndarray
    req: object = None

    @property
    def ok(self) -> bool:
        return self.req is not None and self.req.state == "finished"


def buckets_used(server, mix: dict) -> List[int]:
    lo, hi = mix["prompt"]["min"], mix["prompt"]["max"]
    return sorted({server.engine.prompt_bucket(n)
                   for n in range(lo, hi + 1)})


def setup(cell) -> dict:
    cfg, mix, dev = cell.cfg, cell.mix, cell.device
    phases = [("start", time.monotonic())]
    lm = program.build_lm(cfg, weights.draw(cfg, cell.seed, dev), dev)
    server = program.build_server(lm, mix, dev)
    phases.append(("model and server", time.monotonic()))
    rng = np.random.default_rng(weights.sub_seed(cell.seed, 3))
    for bucket in buckets_used(server, mix):
        n = max(mix["prompt"]["min"], min(bucket, mix["prompt"]["max"]))
        server.submit(rng.integers(0, cfg["vocab_size"], n, dtype=np.int32),
                      2)
        server.drain()
    phases.append(("prompt buckets", time.monotonic()))
    # every slot live in one decode step
    for _ in range(server.slots):
        server.submit(rng.integers(0, cfg["vocab_size"], mix["prompt"]["min"],
                                   dtype=np.int32), 2)
    server.drain()
    server.finished.clear()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    phases.append(("every slot", time.monotonic()))
    return {"lm": lm, "server": server, "phases": phases}


def submit(server, r, due_s: float) -> Served:
    verdict = server.try_submit(r.prompt, r.max_new_tokens, seed=0)
    return Served(due_s, r.prompt,
                  verdict.request if verdict.admitted else None)


def counters(server) -> dict:
    s = server.stats()
    return {"steps": s["steps"], "decode_tokens": s["decode_tokens"],
            "slots": s["slots"]}


def release(state: dict) -> None:
    """Drop the program's server and model; the served record stays."""
    state.pop("server", None)
    state.pop("lm", None)


def sample(done: List[Served], count: int, seed: int) -> List[Served]:
    """The finished request with the most generated tokens (the longest
    sequence on a tie) and ``count − 1`` more drawn from ``seed``."""
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: (
        len(done[i].req.tokens), len(done[i].prompt) + len(done[i].req.tokens)))
    rest = [i for i in range(len(done)) if i != longest]
    rng = np.random.default_rng(weights.sub_seed(seed, 4))
    pick = rng.choice(len(rest), size=min(count - 1, len(rest)),
                      replace=False) if rest else []
    return [done[longest]] + [done[rest[int(i)]] for i in pick]


def gaps(cell, checked: List[Served], fp8: bool = False) -> dict:
    """Per request, each served token's gap below the float32 reference's
    best logit. With ``fp8`` the control's: at each position the token
    that the float8 reference puts first, read in the float32 one."""
    dev = cell.device
    params = weights.draw(cell.cfg, cell.seed, dev)
    out = []
    with torch.no_grad():
        for s in checked:
            served = [int(x) for x in s.req.tokens]
            seq = np.concatenate([s.prompt.astype(np.int64),
                                  np.asarray(served[:-1], np.int64)])
            seq = torch.as_tensor(seq, device=dev)
            at = torch.arange(len(s.prompt) - 1, len(seq), device=dev)
            lg = ref.logits(params, seq, cell.cfg, positions=at)
            if fp8:
                pick = ref.logits(params, seq, cell.cfg, fp8=True,
                                  positions=at).argmax(dim=-1)
            else:
                pick = torch.as_tensor(served, device=dev)
            g = lg.max(dim=-1).values - lg.gather(1, pick[:, None])[:, 0]
            out.append(g.double().cpu().numpy())
    return {"per_request": out,
            "logit_gap": max(float(g.max()) for g in out) if out else None,
            "tokens": int(sum(len(g) for g in out))}


def check(cell, state: dict) -> dict:
    checked = sample(state["done"], cell.mix["check_requests"], cell.seed)
    if not checked:   # nothing finished: nothing served is correct
        return {"logit_gap": float("inf")}
    return {"logit_gap": gaps(cell, checked)["logit_gap"]}
