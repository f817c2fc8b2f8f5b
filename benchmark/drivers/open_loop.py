"""Traffic kind ``open_loop``: requests due on a fixed schedule, whatever
the server has finished (independent users).

Each request is submitted once its due time has come. The window offers
the requests due in ``--seconds``; after it closes the run serves what is
left, and every request due in the window counts: one refused or shed
ranks above any limit. TPOT is a request's time from its first token to
its last over the tokens after the first. The p95 of TTFT, from the due
time to the first token, is printed on standard error beside the result,
and is no metric of a cell (``PERF.md``).
"""

from __future__ import annotations

import time

from benchmark import stats, traffic
from benchmark.drivers import serving

setup = serving.setup
release = serving.release
check = serving.check


def window(cell, state: dict, stretch, clock=time.monotonic) -> dict:
    server = state["server"]
    plan = traffic.open_loop(cell.mix, cell.seconds, cell.seed,
                             cell.cfg["vocab_size"])
    record = []
    t0 = clock()
    i = 0
    while True:
        now = clock()
        while i < len(plan) and t0 + plan[i].due_s <= now:
            record.append(serving.submit(server, plan[i],
                                         t0 + plan[i].due_s))
            i += 1
        if i == len(plan) and not server.busy():
            break
        stepped = server.step()
        stretch.tick()
        if not stepped and i < len(plan):
            wait = t0 + plan[i].due_s - clock()
            if wait > 0:
                time.sleep(wait)
    stretch.close()
    tpot = [None if not s.ok else
            (s.req.finish_s - s.req.first_token_s) * 1e3
            / max(len(s.req.tokens) - 1, 1) for s in record]
    ttft = [None if not s.ok else (s.req.first_token_s - s.due_s) * 1e3
            for s in record]
    state["done"] = [s for s in record if s.ok]
    return {"metrics": {"tpot_p95_ms": stats.percentile(tpot, 95)},
            "extra": {"ttft_p95_ms": stats.percentile(ttft, 95)},
            "attempted": len(record),
            "failed": sum(1 for s in record if not s.ok),
            "window_s": cell.seconds}
