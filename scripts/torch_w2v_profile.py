#!/usr/bin/env python3
"""Where the time of a fused skip-gram step goes, on the card.

The ``chip_smoke.py`` phase-13 word2vec cells (E1: ``bench_word2vec``'s
2000 sentences over 5000 words; E2: text8's scale, 17,005,240 tokens
over 71,290 words at min count 5; d128, window 5, 5 negatives): one
fused warm-up epoch (warm-up step and capture), then a window of
replayed steps under ``torch.profiler``. Prints, per step, the card's
time (CUDA events), the host's time to issue a replay, the card's busy
time and its kernels grouped (the sorted scatter-adds, the sorts
under them, the gathers, the matmuls, the rest) with their launches,
and the ``_row_sums`` of one step's output-table update timed alone
(CUDA events) with and without the hot-row spread, with the card's name
and power limit.

    python3 scripts/torch_w2v_profile.py [--cell e1|e2] [--window 200]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

GROUPS = (("scatter (index_put, sorted)", ("indexing_backward",)),
          ("sort", ("radix", "sort", "Sort")),
          ("gather (index)", ("index_elementwise", "index_select",
                              "indexSelect", "vectorized_gather")),
          ("matmul", ("gemm", "gemv", "Kernel2", "cutlass", "sm90")),
          ("reduce", ("reduce_kernel",)))


def group_of(name: str) -> str:
    for group, tags in GROUPS:
        if any(t in name for t in tags):
            return group
    return "elementwise and the rest"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=("e1", "e2"), default="e2")
    ap.add_argument("--window", type=int, default=200)
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from deeplearning4j_tpu_torch.nlp import word2vec as w2v_mod

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    card = cs.card_line()
    if args.cell == "e1":
        sentences, _ = cs.zipf_corpus(cs.W2V_SENTENCES, cs.W2V_VOCAB)
        m = cs.make_w2v(sentences, 44, "cuda")
        budget = None
    else:
        sentences, _ = cs.zipf_corpus(-(-cs.TEXT8_TOKENS // cs.W2V_LEN),
                                      cs.TEXT8_VOCAB)
        m = cs.make_w2v(sentences, 47, "cuda",
                        min_word_frequency=cs.TEXT8_MIN_COUNT, epochs=2)
        budget = cs.TEXT8_BUDGET_MB
    m.build_vocab()
    m.reset_weights()
    cache = m.build_corpus_cache(budget_mb=budget)
    del sentences
    m.fit_epochs(1)
    prog = m._skipgram_program(cache)
    window = min(args.window, cache.n_batches)

    def steps():
        for _ in range(window):
            prog.graph()

    steps()
    wall_ms = cs.cuda_ms(steps, iters=1) / window
    # the host's time to issue the window (a replay returns before the
    # card runs it; the launch queue holds more than the window)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps()
    host_ms = (time.perf_counter() - t0) * 1e3 / window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_group = collections.defaultdict(lambda: [0.0, 0])
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        g = by_group[group_of(e.name)]
        g[0] += us / 1e3 / window
        g[1] += 1 / window
        n = by_name[e.name[:90]]
        n[0] += us / 1e3 / window
        n[1] += 1 / window
    busy = cs.busy_union_s([(e.time_range.start, e.time_range.end)
                            for e in kernels]) * 1e3 / window
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    print(json.dumps({
        "cell": args.cell, "vocab": m.vocab.num_words(),
        "batch": cache.batch, "window": window,
        "ms_per_step": wall_ms, "host_issue_ms_per_step": host_ms,
        "device_busy_ms_per_step": busy,
        "kernels_per_step": len(kernels) / window,
        "groups_ms_and_launches_per_step": {
            k: [round(v[0], 6), round(v[1], 2)] for k, v in
            sorted(by_group.items(), key=lambda kv: -kv[1][0])},
        "top_kernels_ms_and_launches_per_step": {
            k: [round(v[0], 6), round(v[1], 2)] for k, v in top}}))

    # one step's output-table update alone: the spread against a plain
    # sorted index_put_ of the same entries
    cen, ctx, val, neg = (p[0] for p in prog.plan)
    h = m.syn0[cen.long()]
    g_pos = torch.ones_like(val) * 1e-3
    g_neg = torch.ones(neg.shape, device="cuda") * 1e-3
    idx, vals = w2v_mod._output_updates(h, ctx.long(), neg.long(), g_pos,
                                        g_neg)
    n_rows = m.syn1neg.shape[0]
    counts = torch.bincount(idx, minlength=n_rows)

    def plain():
        torch.zeros_like(m.syn1neg).index_put_((idx,), vals,
                                               accumulate=True)

    def spread():
        w2v_mod._spread_row_sums(n_rows, idx, vals)

    print(json.dumps({
        "output_update_entries": int(idx.numel()),
        "longest_row_repeats": int(counts.max()),
        "rows_over_1000_repeats": int((counts > 1000).sum()),
        "plain_index_put_ms": cs.cuda_ms(plain, iters=5),
        "spread_row_sums_ms": cs.cuda_ms(spread, iters=5)}))
    print(card)


if __name__ == "__main__":
    main()
