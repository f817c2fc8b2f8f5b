"""Everything a cell needs is found by name from ``BENCHMARK.json``, and
the file keeps to the benchmark's contract."""

import json
import os
import re

import pytest

from benchmark import harness

from bench_tiny import BENCH, ROOT, cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return harness.load_bench(ROOT)


@pytest.mark.parametrize("cell", cells())
def test_cell_files_are_found_by_name(cell):
    c = harness.load_cell(ROOT, cell, seed=2**31 + 1, seconds=1, trace=False,
                          device="cpu")
    assert c.cfg["name"] == c.entry["config"]
    assert c.kind in ("train", "open_loop")
    harness.driver(c.kind)
    assert c.limits and all(v > 0 for v in c.limits.values())
    for trace in (False, True):
        assert harness.metrics_of(_bench(), cell, trace)
    assert "setup_s" in [m["name"] for m in
                         harness.metrics_of(_bench(), cell, False)]
    for m in harness.metrics_of(_bench(), cell, True):
        assert callable(harness.reader(ROOT, m["name"]))


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.load_cell(ROOT, "no-such-cell", seed=1, seconds=1,
                          trace=False, device="cpu")


def test_benchmark_json_keeps_to_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        conf = json.load(open(os.path.join(ROOT, c["file"])))
        assert conf["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
        names.add(c["name"])
    cells_seen = set()
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in cells_seen
        cells_seen.add((w["config"], w["traffic"]))
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in [x["name"] for x in b["workloads"]]
            assert w in e2e[m["moves"]].get("workloads", [w])
        if m["name"].endswith("_roofline") or "mfu" in m["name"] \
                or "_roofline." in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], 0)
    assert set(layers) == {"engine", "model step", "kernels", "device"}
    for w in b["workloads"]:
        got = [m["name"] for m in harness.metrics_of(b, w["name"], False)]
        assert "setup_s" in got and len(got) >= 2
        assert harness.metrics_of(b, w["name"], True)
    assert len(json.dumps(b)) < 64 * 1024


def test_paths_hold_the_benchmark_alone():
    b = _bench()
    assert b["paths"] == ["benchmark"]
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert os.path.isfile(os.path.join(BENCH, "run.py"))
