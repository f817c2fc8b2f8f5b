#!/usr/bin/env python3
"""Where a served greedy stream can part from ``lm.generate`` on the card.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/torch_serve_invariance.py

Two parts, on the smoke's served model (``chip_smoke.SERVE_CFG``: d512,
L8, ``mixed_bf16``):

1. Row invariance of the decode step's pieces (the layernorm with its
   f32 statistics, as training takes it, and with the float64 ones every
   other path takes): for each weight shape
   of ``TransformerLM._block`` and each row count M the serving paths use
   (1 for ``generate``'s decode, 8 for the server's, 32 for an 8-slot
   verify of 4 candidates, prompt lengths and their padded buckets for
   the prefills), how many output elements of ``x[:M] @ W`` differ from
   the same rows of ``x[:1024] @ W``, bitwise; the same for the block's
   layernorm over d512 rows; and the attention core of one decode row
   over its 224 live keys in a cache of 224 and of 1024 positions, alone
   and beside 7 other rows.
2. One fleet stream against ``lm.generate``: the smoke's 16-request
   schedule (seed 8) behind ``DecodeServer(slots=8, fuse_steps=4)``; for
   every stream that differs, the first pool position whose K/V differ
   from ``generate``'s cache (a prompt position: the prefill; a later
   one: a decode step), the first differing token and the target's top-2
   logit margin there, and the same step redone as one row and as 8
   copies of it with every intermediate compared (the first that
   differs names the op that is not row-invariant).

``--f32-layernorm`` serves with the block's layernorm statistics in f32
(as training takes them) instead of float64, the port's serving paths
before this script found them to be the one piece that was not
row-invariant: part 2 then shows the stream that parts and the op.

Prints one line per finding and the card's name and power limit.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402
from deeplearning4j_tpu_torch.models.transformer import (  # noqa: E402
    TransformerLM, _layernorm)
from deeplearning4j_tpu_torch.serving import DecodeServer  # noqa: E402

ROWS = (1, 2, 8, 32, 77, 160, 256, 333, 512, 700, 1024)
EXACT_LN = True        # --f32-layernorm sets it False


def gemm_rows(card: str) -> None:
    cfg = chip_smoke.SERVE_CFG
    d, f = cfg["d_model"], cfg["d_ff"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for k, n in ((d, d), (d, f), (f, d), (d, cfg["vocab_size"])):
        x = torch.randn(1024, k, device="cuda", generator=gen).bfloat16()
        w = (torch.randn(k, n, device="cuda", generator=gen)
             / k ** 0.5).bfloat16()
        full = x @ w
        diffs = {m: int((x[:m] @ w != full[:m]).sum()) for m in ROWS}
        print(f"gemm bf16 [M, {k}] @ [{k}, {n}]: elements differing from "
              f"the M=1024 rows: {diffs} [{card}]")


def ops_rows(card: str) -> None:
    from deeplearning4j_tpu_torch.ops.attention import (
        grouped_query_attention)

    d = chip_smoke.SERVE_CFG["d_model"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(1024, 1, d, device="cuda", generator=gen).bfloat16()
    g = 1 + 0.1 * torch.randn(d, device="cuda", generator=gen)
    b = 0.1 * torch.randn(d, device="cuda", generator=gen)
    for exact in (False, True):
        full = _layernorm(x, g, b, exact=exact)
        diffs = {m: int((_layernorm(x[:m], g, b, exact=exact)
                         != full[:m]).sum()) for m in ROWS}
        print(f"layernorm bf16 [M, 1, {d}] exact={exact}: elements "
              f"differing from the M=1024 rows: {diffs} [{card}]")
    h, dh, live = 8, d // 8, 224
    q = torch.randn(8, 1, h, dh, device="cuda", generator=gen).bfloat16()
    kv = torch.randn(2, 8, 1024, h, dh, device="cuda",
                     generator=gen).bfloat16()
    ar = torch.arange(1024, device="cuda")

    def core(rows, t):
        mask = (ar[:t] < live)[None].expand(rows, t)
        return grouped_query_attention(q[:rows], kv[0, :rows, :t],
                                       kv[1, :rows, :t], mask=mask)

    ref = core(1, live)[0]
    print(f"attention core, one decode row over {live} live keys: "
          f"differs from cache {live}/batch 1 in "
          f"{ {(r, t): int((core(r, t)[0] != ref).sum()) for r in (1, 8) for t in (live, 1024)} } "
          f"elements [{card}]")


def first_kv_mismatch(lm, srv_cache, slot, prompt, n_new):
    """Decode ``prompt`` greedily like ``generate`` while keeping its
    cache; return (first position whose K/V differ from the server's
    slot, generate's tokens)."""
    params = lm.params
    p = torch.as_tensor(prompt, device="cuda")[None]
    total = p.shape[1] + n_new
    with torch.no_grad():
        h, cache = lm._prefill(params, p, n_new)
        tok = torch.argmax(lm._unembed(params, h), -1)
        toks = [int(tok)]
        for t in range(p.shape[1], total - 1):
            h = lm._decode_token(params, cache, tok, t, total)
            tok = torch.argmax(lm._unembed(params, h), -1)
            toks.append(int(tok))
    first = None
    for li, c in enumerate(cache):
        for name in ("k", "v"):
            a = c[name][0, :total - 1]
            b = getattr(srv_cache, name)[li, slot, :total - 1]
            bad = (a != b.to(a.dtype)).flatten(1).any(dim=1)
            if bad.any():
                pos = int(torch.nonzero(bad)[0])
                first = pos if first is None else min(first, pos)
    return first, toks


def layer_by_layer(lm, k, v, tok, pos, card: str) -> None:
    """The decode step at ``pos`` for one row and for 8 copies of it,
    every intermediate of every block compared bitwise: prints the first
    intermediate that differs."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.ops.attention import (
        _mm_f32, _softmax_weights, _lift_mask, NEG_INF)

    params, pol = lm.params, lm.policy
    cdt = pol.compute_dtype
    live = torch.arange(1024, device="cuda") <= pos

    def run(rows):
        out = {}
        h = params["embed"][tok.repeat(rows)] + params["pos"][pos]
        h = pol.cast_compute(h)[:, None, :]
        m = live[None].expand(rows, 1024)
        for li, blk in enumerate(params["blocks"]):
            def rec(name, t):
                out[f"L{li} {name}"] = t[0].clone()
                return t
            x = rec("ln1", _layernorm(h, blk["ln1"]["g"], blk["ln1"]["b"],
                                      exact=EXACT_LN))
            q = rec("q", x @ pol.cast_compute(blk["attn"]["wq"]))
            kk = rec("k", x @ pol.cast_compute(blk["attn"]["wk"]))
            vv = rec("v", x @ pol.cast_compute(blk["attn"]["wv"]))
            q = q.reshape(rows, 1, lm.num_heads, -1)
            ck = k[li, None, :1024].repeat(rows, 1, 1, 1).to(cdt)
            cv = v[li, None, :1024].repeat(rows, 1, 1, 1).to(cdt)
            ck[:, pos] = kk.reshape(rows, lm.num_kv_heads, -1)
            cv[:, pos] = vv.reshape(rows, lm.num_kv_heads, -1)
            lg = rec("logits", _mm_f32("bqhd,bkhd->bhqk", q, ck)
                     * float(q.shape[-1] ** -0.5))
            lg = torch.where(_lift_mask(m, 4), lg, NEG_INF)
            w = rec("weights", _softmax_weights(lg, cv.dtype))
            o = rec("pv", _mm_f32("bhqk,bkhd->bqhd", w, cv).to(cv.dtype))
            o = rec("wo", o.reshape(rows, 1, -1)
                    @ pol.cast_compute(blk["attn"]["wo"]))
            h = rec("res1", h + o)
            x = rec("ln2", _layernorm(h, blk["ln2"]["g"], blk["ln2"]["b"],
                                      exact=EXACT_LN))
            x = rec("w1", x @ pol.cast_compute(blk["mlp"]["w1"])
                    + pol.cast_compute(blk["mlp"]["b1"]))
            x = rec("gelu", F.gelu(x, approximate="tanh"))
            x = rec("w2", x @ pol.cast_compute(blk["mlp"]["w2"]))
            h = rec("res2", h + x + pol.cast_compute(blk["mlp"]["b2"]))
        return out

    with torch.no_grad():
        one, eight = run(1), run(8)
    differ = [name for name in one if not torch.equal(one[name],
                                                      eight[name])]
    print(f"  position {pos}, 1 row against 8 copies: first differing "
          f"intermediates {differ[:6]} of {len(one)} [{card}]")


def recompute(lm, k, v, req, pos, card: str) -> None:
    """The decode step at the first mismatching position ``pos``, redone
    from the server's own pool contents below ``pos`` (equal to
    ``generate``'s there): as one row in a pool of 1024 positions, as one
    row in a pool cut to the stream's length, and as 8 copies of the
    row. Prints which of them give the server's and which generate's
    K/V at ``pos``, layer by layer."""
    from deeplearning4j_tpu_torch.serving.engine import _decode_step_body
    from deeplearning4j_tpu_torch.serving.kv_cache import SlotKVCache

    total = req.prompt.shape[0] + req.max_new_tokens
    p = torch.as_tensor(req.prompt, device="cuda")[None]
    with torch.no_grad():
        h, cache = lm._prefill(lm.params, p, req.max_new_tokens)
        tok = torch.argmax(lm._unembed(lm.params, h), -1)
        for t in range(p.shape[1], pos + 1):
            if t == pos:
                tok_at = tok.clone()
            h = lm._decode_token(lm.params, cache, tok, t, total)
            tok = torch.argmax(lm._unembed(lm.params, h), -1)
    gen_k = torch.stack([c["k"][0, pos] for c in cache])
    srv_k = k[:, pos]

    def step(rows, t_max):
        pool = SlotKVCache(lm, rows, t_max)
        pool.k[:, :, :pos] = k[:, None, :pos]
        pool.v[:, :, :pos] = v[:, None, :pos]
        _decode_step_body(lm, pool, tok_at.repeat(rows),
                          torch.full((rows,), pos, device="cuda"))
        return pool.k[:, 0, pos]

    layer_by_layer(lm, k, v, tok_at, pos, card)
    for label, out in (("1 row, 1024", step(1, 1024)),
                       ("1 row, stream length", step(1, total)),
                       ("8 rows, 1024", step(8, 1024))):
        print(f"  position {pos}, redone as {label}: layers equal to the "
              f"server's {[bool(torch.equal(out[i], srv_k[i])) for i in range(lm.num_layers)]}"
              f", to generate's {[bool(torch.equal(out[i], gen_k[i])) for i in range(lm.num_layers)]}"
              f" [{card}]")


def fleet_stream(card: str) -> None:
    lm = TransformerLM(**chip_smoke.SERVE_CFG).init()
    sched = chip_smoke.serve_schedule(chip_smoke.FLEET_REQUESTS,
                                      chip_smoke.FLEET_RATE, seed=8)
    srv = DecodeServer(lm, slots=chip_smoke.SERVE_SLOTS,
                       max_len=chip_smoke.SERVE_MAX_LEN,
                       fuse_steps=chip_smoke.FLEET_FUSE)
    # keep each finished slot's pool contents: retire copies the slot
    kept = {}
    retire = srv._retire

    def keep(slot, now):
        req = srv._slot_req[slot]
        kept[req.id] = (srv.engine.cache.k[:, slot].clone(),
                        srv.engine.cache.v[:, slot].clone())
        retire(slot, now)

    srv._retire = keep
    for a in sched:
        srv.submit(a.prompt, a.max_new_tokens)
    srv.drain()
    bad = 0
    for req in srv.finished:
        want = lm.generate(req.prompt[None], req.max_new_tokens)[0]
        want = want.cpu().numpy()
        if np.array_equal(req.output, want):
            continue
        bad += 1
        k, v = kept[req.id]
        view = type("Pool", (), {"k": k[:, None], "v": v[:, None]})
        pos, _ = first_kv_mismatch(lm, view, 0, req.prompt,
                                   req.max_new_tokens)
        if pos is not None and pos >= req.prompt.shape[0]:
            recompute(lm, k, v, req, pos, card)
        print(f"stream of a {req.prompt.shape[0]}-token prompt: "
              + chip_smoke.first_divergence(req.output, want, lm,
                                            req.prompt)
              + f"; first K/V mismatch at position {pos} ("
              + ("prefill" if pos is not None and pos < req.prompt.shape[0]
                 else "decode") + f") [{card}]")
    print(f"fleet stream: {bad} of {len(srv.finished)} streams differ from "
          f"lm.generate [{card}]")


def f32_layernorm() -> None:
    """Serve with the block's layernorm statistics in f32."""
    global EXACT_LN
    from deeplearning4j_tpu_torch.models import transformer

    EXACT_LN = False
    transformer._layernorm = (
        lambda x, g, b, eps=1e-5, exact=False: _layernorm(x, g, b, eps))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("no CUDA device is available")
    if "--f32-layernorm" in sys.argv[1:]:
        f32_layernorm()
    card = chip_smoke.card_line()
    gemm_rows(card)
    ops_rows(card)
    fleet_stream(card)
    print(card)


if __name__ == "__main__":
    main()
