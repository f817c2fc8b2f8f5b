"""The traffic generator: one seed, one schedule; every seed, one set of
sizes."""

import json
import os

import numpy as np

from benchmark import traffic

from bench_tiny import BENCH

MIXES = os.path.join(BENCH, "traffic")


def _mix(name):
    return json.load(open(os.path.join(MIXES, f"{name}.json")))


def _key(plan):
    return [(r.due_s, r.max_new_tokens, r.prompt.tobytes()) for r in plan]


def test_open_loop_schedule_is_the_same_for_one_seed():
    mix = _mix("chat")
    a = traffic.open_loop(mix, 30, 2**31 + 17, 50272)
    b = traffic.open_loop(mix, 30, 2**31 + 17, 50272)
    assert _key(a) == _key(b)
    assert _key(a) != _key(traffic.open_loop(mix, 30, 2**31 + 18, 50272))


def test_open_loop_seeds_share_sizes_and_gaps():
    mix = _mix("chat")
    a = traffic.open_loop(mix, 30, 1, 50272)
    b = traffic.open_loop(mix, 30, 2**33 + 5, 50272)
    assert len(a) == len(b) == round(mix["rate_rps"] * 30)
    assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt) for r in b)
    assert sorted(r.max_new_tokens for r in a) \
        == sorted(r.max_new_tokens for r in b)
    gaps = lambda p: np.diff([0.0] + [r.due_s for r in p])  # noqa: E731
    np.testing.assert_allclose(np.sort(gaps(a)), np.sort(gaps(b)))
    assert max(r.due_s for r in a) <= 30 + 1e-9
    for r in a:
        assert mix["prompt"]["min"] <= len(r.prompt) <= mix["prompt"]["max"]
        assert len(r.prompt) + r.max_new_tokens <= mix["max_total"]


def test_quantile_lengths_follow_the_median_and_clip():
    spec = {"median": 256, "sigma": 0.8, "min": 16, "max": 1536}
    n = traffic.quantile_lengths(spec, 1001)
    assert n[500] == 256 and n.min() >= 16 and n.max() <= 1536
