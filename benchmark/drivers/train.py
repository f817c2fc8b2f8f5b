"""Traffic kind ``train``: ``TransformerLM.fit_batch`` on seeded token
batches, the captured step (B1–B3 in it) and Adam.

Set-up builds one model with the benchmark's weights and zero moments and
drives it through ``setup_steps`` steps by the window's own call, on
batches that all differ: the first runs eagerly, the second captures the
step and replays it, the rest replay it. The check reads those steps: each
loss, the first gradient by leaf from Adam's first moment (``m = (1 − β1)
g`` after one step) and each leaf's change after the last of them. The
window then dispatches steps with ``block=False``, ``in_flight`` ahead of
the card, over ``window_batches`` further batches in turn, until
``--seconds`` have passed, and closes on ``torch.cuda.synchronize()``.
The first gradient waits on the host through the window, for the check.
"""

from __future__ import annotations

import time
from collections import deque

import torch

from benchmark import program, weights
from benchmark.reference import opt as ref

ADAM_B1 = 0.9


def _norms(tensors) -> list:
    return [float(x) for x in torch.stack(
        [t.detach().double().norm() for t in tensors]).cpu()]


def setup(cell) -> dict:
    cfg, mix, dev = cell.cfg, cell.mix, cell.device
    b, t = mix["batch"], mix["seq_len"]
    steps = mix["setup_steps"]
    phases = [("start", time.monotonic())]
    start = weights.draw(cfg, cell.seed, dev)
    lm = program.build_lm(cfg, start, dev, lr=mix["lr"], adam=True)
    batches = weights.token_batches(cfg["vocab_size"], (b, t),
                                    steps + mix["window_batches"],
                                    cell.seed, dev)
    phases.append(("model and batches", time.monotonic()))
    losses, grad, grad_norm = [], None, None
    for i in range(steps):
        losses.append(lm.fit_batch(batches[i], block=False))
        if i == 0:
            grad = [s["m"] / (1 - ADAM_B1) for _, s in
                    _moments(lm.opt_state)]
            grad_norm = _norms(grad)
            grad = [g.cpu() for g in grad]
        phases.append((f"step {i + 1}", time.monotonic()))
    names = [n for n, _ in ref.leaves(start)]
    now = dict(ref.leaves(lm.params))
    change = _norms(now[n] - w for n, w in ref.leaves(start))
    readings = {"losses": [float(x) for x in losses],
                "grad_norm": dict(zip(names, grad_norm)),
                "first_grad": dict(zip(names, grad)),
                "change_norm": dict(zip(names, change))}
    del start, now
    return {"lm": lm, "batches": batches[steps:], "readings": readings,
            "setup_batches": steps, "phases": phases}


def _moments(opt_state):
    """``(path, {"m", "v"})`` of every leaf, in ``ref.leaves`` order."""
    out = []

    def walk(tree, prefix):
        if isinstance(tree, dict) and set(tree) == {"m", "v"}:
            out.append((prefix[:-1], tree))
        elif isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], f"{prefix}{k}.")
        else:
            for i, v in enumerate(tree):
                walk(v, f"{prefix}{i}.")

    walk(opt_state, "")
    return out


def window(cell, state: dict, stretch, clock=time.monotonic) -> dict:
    lm, batches = state["lm"], state["batches"]
    b, t = cell.mix["batch"], cell.mix["seq_len"]
    sync = cell.device.type == "cuda"
    pending: deque = deque()
    steps = 0
    t0 = clock()
    while clock() - t0 < cell.seconds or stretch.active:
        lm.fit_batch(batches[steps % len(batches)], block=False)
        steps += 1
        if sync:
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            if len(pending) > cell.mix["in_flight"]:
                pending.popleft().synchronize()
        stretch.tick()
    if sync:
        torch.cuda.synchronize()
    stretch.close()
    elapsed = clock() - t0
    out = {"metrics": {"train_tokens_per_s": b * t * steps / elapsed},
           "attempted": steps, "failed": 0, "window_s": elapsed}
    if stretch.summary is not None:   # the traced steps alone
        out["traced_tokens_per_s"] = (b * t * stretch.ticks
                                      / stretch.summary["window_s"])
    return out


def release(state: dict) -> None:
    """Drop the program's model and batches; the readings stay."""
    state.pop("lm", None)
    state.pop("batches", None)


def gap(prog: float, refv: float, floor: float) -> float:
    """``|prog − ref|`` over the larger of ``|ref|`` and ``floor``."""
    return abs(prog - refv) / max(abs(refv), floor)


def _diff_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    """``‖a − b‖`` in float64, on ``b``'s device."""
    return float((a.to(b.device).double() - b.double()).norm())


def compare(prog: dict, refr: dict, worst: bool = False) -> dict:
    """The numbers the check compares: the worst step's loss gap; the
    worst leaf's gap of first-gradient norms and of change norms (leaves
    whose reference gradient is under a thousandth of the median leaf's
    left out of the change); and the worst leaf's norm of the first
    gradient's difference, ``grad_diff``. Each leaf's number is taken
    over the larger of that leaf's reference norm and the median leaf's.
    With ``worst``, also the leaf that gave each worst number."""
    names = list(refr["grad_norm"])
    g_ref = [refr["grad_norm"][n] for n in names]
    c_ref = [refr["change_norm"][n] for n in names]
    g_med = sorted(g_ref)[len(g_ref) // 2]
    c_med = sorted(c_ref)[len(c_ref) // 2]
    moving = [n for n in names if refr["grad_norm"][n] >= 1e-3 * g_med]
    by_leaf = {
        "grad_norm_gap": {n: gap(prog["grad_norm"][n], refr["grad_norm"][n],
                                 g_med) for n in names},
        "change_norm_gap": {n: gap(prog["change_norm"][n],
                                   refr["change_norm"][n], c_med)
                            for n in moving},
        "grad_diff": {n: _diff_norm(prog["first_grad"][n],
                                    refr["first_grad"][n])
                      / max(refr["grad_norm"][n], g_med) for n in names},
    }
    out = {"loss_gap": max(gap(p, r, 0.0) for p, r in
                           zip(prog["losses"], refr["losses"]))}
    for k, leaf in by_leaf.items():
        top = max(leaf, key=leaf.get)
        out[k] = leaf[top]
        if worst:
            out[f"{k}_leaf"] = top
    return out


def reference_readings(cell, fp8: bool = False) -> dict:
    """The reference's readings of the set-up steps: the same weights and
    batches, drawn again from the seed."""
    mix, dev = cell.mix, cell.device
    steps = mix["setup_steps"]
    params = weights.draw(cell.cfg, cell.seed, dev)
    batches = weights.token_batches(cell.cfg["vocab_size"],
                                    (mix["batch"], mix["seq_len"]),
                                    steps + mix["window_batches"], cell.seed,
                                    dev)[:steps]
    return ref.train_readings(params, list(batches), cell.cfg, mix["lr"],
                              fp8=fp8)


def check(cell, state: dict) -> dict:
    return compare(state["readings"], reference_readings(cell))
