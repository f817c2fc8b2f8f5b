#!/usr/bin/env python3
"""Where the time of the prefetched infeed cell goes, on the card.

The ``bench_infeed`` cell of ``chip_smoke.py`` phase 11 (the MNIST MLP,
bf16, 16 distinct ``[4096, 784]`` batches, ``queue_size`` 4) fed
synchronously and through ``AsyncDataSetIterator(device_prefetch=True)``
in alternating rounds, one fresh network and iterator a run. For the
prefetched runs it splits the producer's time a batch into the fetch
from the underlying iterator and the copy (finding a free pinned staging
buffer, allocating it at first use, the host copy into it and the issue
of the device copy), and gives the consumer's total wait for the
queue. Prints one JSON line a round and the
medians, with the card's name and power limit.

    python3 scripts/torch_prefetch_profile.py [--rounds 6]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from deeplearning4j_tpu_torch.datasets import (
        AsyncDataSetIterator, DataSet, ListDataSetIterator)
    from deeplearning4j_tpu_torch.datasets import iterator as it_mod

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    card = cs.card_line()
    rng = np.random.default_rng(0)
    b, n = cs.INFEED_BATCH, cs.INFEED_BATCHES
    batches = [DataSet(rng.random((b, 784), np.float32),
                       np.eye(10, dtype=np.float32)[rng.integers(0, 10, b)])
               for _ in range(n)]

    split = {"fetch": [], "slot": [], "copy": [], "wait": []}
    real_copy = it_mod._DevicePrefetch.copy
    real_slot = it_mod._DevicePrefetch._slot
    real_has_next = AsyncDataSetIterator.has_next

    def timed_slot(self, t):
        t0 = time.perf_counter()
        out = real_slot(self, t)
        split["slot"].append(time.perf_counter() - t0)
        return out

    def timed_copy(self, ds):
        t0 = time.perf_counter()
        out = real_copy(self, ds)
        split["copy"].append(time.perf_counter() - t0)
        return out

    def timed_has_next(self):
        t0 = time.perf_counter()
        out = real_has_next(self)
        split["wait"].append(time.perf_counter() - t0)
        return out

    class TimedList(ListDataSetIterator):
        def next(self, num=None):
            t0 = time.perf_counter()
            out = super().next(num)
            split["fetch"].append(time.perf_counter() - t0)
            return out

    it_mod._DevicePrefetch._slot = timed_slot
    it_mod._DevicePrefetch.copy = timed_copy
    AsyncDataSetIterator.has_next = timed_has_next
    rows = []
    for r in range(args.rounds):
        order = ("sync", "prefetch") if r % 2 == 0 else ("prefetch", "sync")
        row = {"round": r}
        for mode in order:
            for v in split.values():
                v.clear()
            net = cs.build_network("mnist_mlp", "bf16", "cuda")
            net.fit(batches[0])
            torch.cuda.synchronize()
            src = TimedList(batches, b) if mode == "prefetch" else \
                ListDataSetIterator(batches, b)
            data = AsyncDataSetIterator(src, queue_size=cs.INFEED_QUEUE,
                                        device_prefetch=True) \
                if mode == "prefetch" else src
            t0 = time.perf_counter()
            net.fit(data)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            row[f"{mode}_ms"] = wall * 1e3
            if mode == "prefetch":
                # copy: staging (slot) waits and allocations, the host
                # copy into pinned memory and the device copy's issue
                row["producer_ms_per_batch"] = {
                    "fetch": 1e3 * statistics.mean(split["fetch"]),
                    "copy": 1e3 * statistics.mean(split["copy"]),
                    "slot_mean": 1e3 * statistics.mean(split["slot"]),
                    "slot_max": 1e3 * max(split["slot"]),
                }
                row["consumer_wait_ms_total"] = 1e3 * sum(split["wait"])
        row["ratio"] = row["sync_ms"] / row["prefetch_ms"]
        rows.append(row)
        print(json.dumps(row), f"[{card}]", flush=True)
    med = {k: statistics.median(r[k] for r in rows)
           for k in ("sync_ms", "prefetch_ms", "ratio",
                     "consumer_wait_ms_total")}
    print(f"prefetch profile medians over {args.rounds} rounds: "
          f"{json.dumps(med)} [{card}]")


if __name__ == "__main__":
    main()
