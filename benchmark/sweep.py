"""Find the highest request rate an open-loop cell sustains without a
growing backlog: one server, one window at each rate.

    python3 benchmark/sweep.py --workload opt-1.3b.chat \
        --rates 1.0,1.5,2.0 [--seconds 60] [--seed 1]

Each rate offers the cell's open-loop schedule with its ``rate_rps``
replaced for ``--seconds``, then cancels what is left and lets the server
empty. It prints one JSON line a rate: the requests offered, those whose
first token came inside the window and those still queued at its end,
TTFT at the 50th and 95th percentile of the requests that got one (ms),
and the median TTFT of the first and of the last quarter of the offered
requests, a request still waiting counting as its wait so far. A backlog
that grows shows as a last quarter that waits far longer than the first,
and requests left queued. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def offer(server, plan, seconds: float, clock=time.monotonic) -> dict:
    """Offer ``plan`` for ``seconds``; then cancel what is left and empty
    the server."""
    from benchmark import stats
    from benchmark.drivers import serving

    record = []
    t0 = clock()
    i = 0
    while clock() < t0 + seconds:
        now = clock()
        while i < len(plan) and t0 + plan[i].due_s <= now:
            record.append(serving.submit(server, plan[i], t0 + plan[i].due_s))
            i += 1
        if not server.step() and i < len(plan):
            time.sleep(max(0.0, min(t0 + plan[i].due_s, t0 + seconds)
                           - clock()))
    end = clock()
    waits = [((s.req.first_token_s if s.req.first_token_s is not None
               else end) - s.due_s) * 1e3 for s in record]
    got = [w for s, w in zip(record, waits) if s.req.first_token_s]
    queued = sum(1 for s in record if s.req.state == "queued")
    for s in record:
        s.req.canceled = True
    server.drain()
    server.finished.clear()
    q = max(1, len(record) // 4)
    return {"offered": len(record), "first_token_in_window": len(got),
            "queued_at_end": queued,
            "ttft_p50_ms": stats.percentile(got, 50),
            "ttft_p95_ms": stats.percentile(got, 95),
            "wait_first_quarter_p50_ms": stats.percentile(waits[:q], 50),
            "wait_last_quarter_p50_ms": stats.percentile(waits[-q:], 50)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("sweep: no CUDA device is available", file=sys.stderr)
        return 2
    from benchmark import harness, traffic
    from benchmark.drivers import open_loop

    cell = harness.load_cell(ROOT, args.workload, seed=args.seed,
                             seconds=args.seconds, trace=False, device="cuda")
    server = open_loop.setup(cell)["server"]
    card = torch.cuda.get_device_name(0)
    for rate in (float(r) for r in args.rates.split(",")):
        mix = dict(cell.mix, rate_rps=rate)
        plan = traffic.open_loop(mix, args.seconds, args.seed,
                                 cell.cfg["vocab_size"])
        got = offer(server, plan, args.seconds)
        print(json.dumps({"rate_rps": rate, "card": card,
                          "seconds": args.seconds, **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
