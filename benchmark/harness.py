"""One run of one cell: find its configuration, mix, driver and readers by
name, set up, measure the window, check the output against the reference,
and build the result line.

Everything a cell needs is found from its entry in ``BENCHMARK.json``:
``benchmark/configs/<config>.json``, ``benchmark/traffic/<traffic>.json``
(whose ``kind`` names ``benchmark/drivers/<kind>.py``),
``benchmark/limits/<cell>.json`` (the limit of each number the check
compares) and, in a ``--trace 1`` run, ``benchmark/metrics/<metric>.py``
for each per-layer metric of the cell. A driver module has
``setup(cell) -> state``, ``window(cell, state, stretch) -> dict``,
``release(state)`` and ``check(cell, state) -> {number: value}``.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional

import torch

from benchmark import roofline, trace as trace_mod
from benchmark.reference import opt as ref

SPAN_CAPACITY = 1 << 21


@dataclass
class Cell:
    name: str
    root: str
    entry: dict
    cfg: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device

    @property
    def kind(self) -> str:
        return self.mix["kind"]


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_bench(root: str) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def load_cell(root: str, name: str, *, seed: int, seconds: float,
              trace: bool, device) -> Cell:
    bench = load_bench(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    here = os.path.join(root, "benchmark")
    return Cell(name=name, root=root, entry=entry,
                cfg=_json(os.path.join(root, conf["file"])),
                mix=_json(os.path.join(here, "traffic",
                                       f"{entry['traffic']}.json")),
                limits=_json(os.path.join(here, "limits", f"{name}.json")),
                seed=int(seed), seconds=float(seconds), trace=bool(trace),
                device=torch.device(device))


def driver(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}")


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics (``trace`` false) or per-layer ones."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


def reader(root: str, name: str):
    """``read(ctx)`` of ``benchmark/metrics/<name>.py``, or, where there is
    no such file, of the reader its stem names: ``device_idle.py`` reads
    ``device_idle.train`` and ``device_idle.chat`` alike."""
    here = os.path.join(root, "benchmark", "metrics")
    path = os.path.join(here, f"{name}.py")
    if not os.path.isfile(path):
        path = os.path.join(here, f"{name.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def judge(readings: dict, limits: dict) -> tuple:
    """``(correct, {number: {value, limit}})``: every number compared at
    or under its limit (a number that is not finite fails)."""
    shown, ok = {}, True
    for k, limit in limits.items():
        v = readings.get(k)
        v = float("inf") if v is None else float(v)
        ok = ok and math.isfinite(v) and v <= limit
        shown[k] = {"value": v, "limit": limit}
    return ok, shown


def device_line(cell: Cell) -> dict:
    if cell.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(cell.device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_reserved(
                cell.device))}


def run(cell: Cell, t_start: float, clock=time.monotonic) -> dict:
    """Set up, measure and check ``cell``; returns the result line's
    object. ``t_start``: the process's start on ``clock``."""
    from benchmark import program

    bench = load_bench(cell.root)
    drv = driver(cell.kind)
    tracer = program.spans_tracer(SPAN_CAPACITY) if cell.trace else None
    state = drv.setup(cell)
    for name, t in state.pop("phases", []):
        print(f"setup {name} {t - t_start!r}", file=sys.stderr)
    cuda = cell.device.type == "cuda"
    if cuda:   # the window's peak: what set-up alone held is let go
        torch.cuda.synchronize(cell.device)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(cell.device)
    if tracer is not None:
        tracer.clear()
    t0 = clock()
    setup_s = t0 - t_start
    mix = cell.mix
    stretch = trace_mod.Stretch(
        cell.trace, t0 + max(0.0, (cell.seconds - mix["trace_seconds"]) / 2),
        mix["trace_seconds"], clock)
    win = drv.window(cell, state, stretch)
    for k, v in win.get("extra", {}).items():
        print(f"window {k} {v!r}", file=sys.stderr)
    values = dict(win["metrics"], setup_s=setup_s)
    device = device_line(cell)
    spans = tracer.spans() if tracer is not None else []
    drv.release(state)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    ref.strict_f32()
    try:
        readings = drv.check(cell, state)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    correct, shown = judge(readings, cell.limits)
    out = {"correct": correct, "attempted": int(win["attempted"]),
           "failed": int(win["failed"])}
    metrics = {}
    summary: Optional[dict] = stretch.summary
    if not cell.trace:
        for m in metrics_of(bench, cell.name, False):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        ctx = SimpleNamespace(cell=cell, window=win, values=values,
                              trace=summary, spans=spans,
                              roofline=roofline)
        for m in metrics_of(bench, cell.name, True):
            v = reader(cell.root, m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if summary is not None:
            device["busy_s"] = summary["busy_s"]
            device["window_s"] = summary["window_s"]
            out["breakdown"] = {"device_ops": summary["device_ops"],
                                "idle_gaps": summary["idle_gaps"]}
    out["metrics"] = metrics
    out["device"] = device
    out["check"] = shown
    return out
