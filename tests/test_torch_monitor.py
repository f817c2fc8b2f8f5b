"""Port parity for ``monitor/`` (registry, trace, exporters, flight
recorder, run ledger) against ``deeplearning4j_tpu.monitor``: the same
sequence of instrument calls and spans under one injected clock gives
equal snapshots, Prometheus text, span dicts, JSONL records, flight
records and ledger reports; and one ``fit_epochs`` call drives the same
ledger and flight events, in the same order, on both packages (the
chunk driver's hooks sit at the reference's points)."""

import importlib
import json
import os

import jax
import numpy as np
import pytest

from deeplearning4j_tpu import monitor as jm
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.iterator import \
    ListDataSetIterator as JaxList
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.monitor import ledger as jledger
from deeplearning4j_tpu_torch import monitor as pm
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.monitor import ledger as pledger

# the packages re-export a ``flight`` function over the module's name
jflight = importlib.import_module("deeplearning4j_tpu.monitor.flight")
pflight = importlib.import_module("deeplearning4j_tpu_torch.monitor.flight")


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def tick(self, dt):
        self.t += dt


def _drive(mod, clock, with_ledger=True):
    """One scripted sequence of metrics, spans and ledger marks."""
    reg = mod.MetricsRegistry()
    tr = mod.SpanTracer(clock=clock, capacity=64)
    led = (mod.RunLedger(clock=clock, span_source=tr.spans)
           if with_ledger else None)
    reg.counter("steps_total", "steps").inc(3, model="MLN")
    reg.counter("steps_total").inc(2, model="CG")
    reg.gauge("hbm_bytes").set(1024, device="cuda:0")
    h = reg.histogram("lat_seconds", "latency", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v, op="fit")
    led.run_start(model="MLN", epochs=2)
    with tr.span("cache.build", kind="DS"):
        clock.tick(0.5)
    for e in range(2):
        led.chunk_start(epoch0=e)
        with tr.span("epoch.chunk", epoch0=e) as sp:
            clock.tick(1.0)
            with tr.span("epoch.readback", what="sentinel"):
                clock.tick(0.25)
            sp.attrs["steps"] = 4
        led.chunk_done(epoch0=e)
    with tr.span("checkpoint.write", background=False):
        clock.tick(0.3)
    with tr.span("checkpoint.write", background=True):
        clock.tick(0.2)
    tr.event("watchdog.stall", stalled_s=0.1)
    with pytest.raises(ValueError):
        with tr.span("retry.sleep", attempt=1):
            clock.tick(0.05)
            raise ValueError("boom")
    led.run_end(status="clean", epochs_done=2)
    clock.tick(1.0)
    return reg, tr, led


def test_registry_trace_and_ledger_equal_reference():
    ours = _drive(pm, FakeClock())
    theirs = _drive(jm, FakeClock())
    assert ours[0].snapshot() == theirs[0].snapshot()
    assert ours[0].to_prometheus() == theirs[0].to_prometheus()
    assert [s.to_dict() for s in ours[1].spans()] == \
        [s.to_dict() for s in theirs[1].spans()]
    assert ours[1].summary() == theirs[1].summary()
    assert ours[2].report() == theirs[2].report()
    rep = ours[2].report()
    assert rep["runs"][0]["status"] == "clean"
    assert rep["states"]["checkpoint"] == pytest.approx(0.3)
    assert rep["hidden_checkpoint_s"] == pytest.approx(0.2)


def test_registry_contracts():
    reg = pm.MetricsRegistry()
    with pytest.raises(ValueError):
        reg.counter("c").inc(-1)
    reg.counter("x")
    with pytest.raises(TypeError):
        reg.gauge("x")
    g = reg.gauge("g")
    g.set(2, r="a")
    assert g.remove(r="a") and g.value(r="a") == 0.0
    assert pm.Registry is pm.MetricsRegistry  # the name the port had


def test_exporters_write_what_the_reference_writes(tmp_path, monkeypatch):
    reg, tr, _ = _drive(pm, FakeClock())
    jreg, jtr, _ = _drive(jm, FakeClock())
    p_ours = pm.write_prometheus_textfile(reg, str(tmp_path / "o.prom"))
    p_theirs = jm.write_prometheus_textfile(jreg, str(tmp_path / "t.prom"))
    assert open(p_ours).read() == open(p_theirs).read()
    pm.export_metrics_jsonl(reg, str(tmp_path / "o.jsonl"))
    jm.export_metrics_jsonl(jreg, str(tmp_path / "t.jsonl"))
    strip = lambda p: [{k: v for k, v in json.loads(l).items()  # noqa: E731
                        if k != "t_wall"} for l in open(p)]
    assert strip(tmp_path / "o.jsonl") == strip(tmp_path / "t.jsonl")
    # the env-wired span sink streams every finished span
    monkeypatch.setenv("DL4J_TELEMETRY_DIR", str(tmp_path / "tele"))
    from deeplearning4j_tpu_torch.monitor import exporters

    t2 = pm.SpanTracer(sink=exporters.span_sink_from_env())
    with t2.span("epoch.chunk", epoch0=0):
        pass
    lines = open(tmp_path / "tele" / "telemetry.jsonl").read().splitlines()
    rec = json.loads(lines[-1])
    assert rec["kind"] == "span" and rec["name"] == "epoch.chunk"
    summary = pm.telemetry_summary(reg, tr)
    assert set(summary) == {"metrics", "spans", "ledger"}


def test_flight_recorder_records_and_classifies(tmp_path):
    rec = pm.FlightRecorder(str(tmp_path / "o"), heartbeat_s_=60,
                            metric_deltas=False)
    jrec = jm.FlightRecorder(str(tmp_path / "t"), heartbeat_s_=60,
                             metric_deltas=False)
    for r in (rec, jrec):
        r.record("run.start", model="MLN")
        r.record("chunk.launch", epoch0=0)
        r.record("preemption.latch", source="fault")
        r.record("run.end", status="stopped")
        r.close()
    ours = pm.load_flight_records(str(tmp_path / "o"))
    theirs = jm.load_flight_records(str(tmp_path / "t"))
    strip = lambda rs: [{k: v for k, v in r.items()  # noqa: E731
                         if k not in ("t_wall", "_segment")} for r in rs]
    assert strip(ours) == strip(theirs)
    assert pm.classify_end_state(ours)["end_state"] == \
        jm.classify_end_state(theirs)["end_state"] == "preempted"


def test_flight_rotation_caps_segments(tmp_path):
    rec = pm.FlightRecorder(str(tmp_path), segment_bytes_=512,
                            max_segments_=3, heartbeat_s_=60,
                            metric_deltas=False)
    for i in range(200):
        rec.record("event", i=i, pad="x" * 40)
    rec.close()
    segs = [n for n in os.listdir(tmp_path) if n.startswith("flight-")]
    assert len(segs) <= 3 and rec.segments_rotated > 0
    assert pflight.SEGMENT_RE.pattern == jflight.SEGMENT_RE.pattern


def _ledger_events(mod_monitor, mod_flight, mod_ledger, fit, tmp_path):
    rec = mod_flight.FlightRecorder(str(tmp_path), heartbeat_s_=60,
                                    metric_deltas=False)
    mod_flight.set_flight(rec)
    mod_ledger.set_run_ledger(None)
    try:
        fit()
        rep = mod_ledger.run_ledger().report()
    finally:
        mod_flight.set_flight(None)
        rec.close()
    events = [r for r in mod_monitor.load_flight_records(str(tmp_path))
              if r["kind"] in ("run.start", "chunk.launch", "chunk.done",
                               "run.end")]
    return [{k: v for k, v in r.items()
             if k not in ("t_wall", "_segment", "goodput_pct")}
            for r in events], rep


@pytest.mark.parametrize("chunk", [1, 2])
def test_fit_epochs_ledger_events_equal_reference(tmp_path, chunk):
    rng = np.random.default_rng(0)
    x = rng.random((64, 784), np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 64)]
    port = zoo.mnist_mlp(hidden=16, device="cpu").init()
    ref = jax_zoo.mnist_mlp(hidden=16).init()
    ours, rep = _ledger_events(
        pm, pflight, pledger, lambda: port.fit_epochs(
            ListDataSetIterator(DataSet(x, y), 32), 4, chunk_epochs=chunk),
        tmp_path / "o")
    theirs, _ = _ledger_events(
        jm, jflight, jledger, lambda: ref.fit_epochs(
            JaxList(JaxDataSet(x, y), 32), 4, chunk_epochs=chunk),
        tmp_path / "t")
    assert ours == theirs
    assert [e["kind"] for e in ours][:3] == ["run.start", "chunk.launch",
                                            "chunk.done"]
    assert ours[-1]["kind"] == "run.end" and ours[-1]["status"] == "clean"
    assert rep["n_runs"] == 1 and rep["runs"][0]["chunks"] == 4 // chunk
    pledger.set_run_ledger(None)
    jledger.set_run_ledger(None)


@pytest.mark.chaos
def test_stopped_and_errored_runs_close_the_window(tmp_path):
    rng = np.random.default_rng(1)
    x = rng.random((32, 784), np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 32)]
    net = zoo.mnist_mlp(hidden=8, device="cpu").init()
    pledger.set_run_ledger(None)
    net.fit_epochs(ListDataSetIterator(DataSet(x, y), 32), 3,
                   chunk_epochs=1, on_chunk=lambda done: done == 1)
    assert pledger.run_ledger().report()["runs"][-1]["status"] == "stopped"
    from deeplearning4j_tpu_torch.resilience import faults

    faults.install("epoch.chunk", faults.fail_nth(1))
    try:
        with pytest.raises(Exception):
            net.fit_epochs(ListDataSetIterator(DataSet(x, y), 32), 2)
    finally:
        faults.clear()
    assert pledger.run_ledger().report()["runs"][-1]["status"].startswith(
        "error:")
    pledger.set_run_ledger(None)
