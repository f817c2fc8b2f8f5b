"""The grant lease and the goodput autopilot of the port against the
reference's: ``deeplearning4j_tpu_torch.resilience.lease`` /
``.autopilot`` beside ``deeplearning4j_tpu.resilience``.

1. **Same lease protocol.** The same acquisition script (which attempts
   raise, which wedge past the bound), the same ``grant.lease`` fault
   schedule, the same probe and an injected ``sleep`` give the same
   value, state, ``reacquires``, backoff sequence and exception in both
   packages; the port's default filter lets a kernel that does not build
   or launch propagate at once.
2. **Same decisions.** The same scripted gauges (payload maps, straggler
   sets, last beats, goodput, clock) give the same (action, target,
   reason, acted) decisions from both packages' ``GoodputAutopilot``.
3. **Wired in.** A rescue is booked as ``grant_wait`` by the port's run
   ledger and classified ``reacquired`` by its flight recorder; the
   autopilot evicts a serve-fleet straggler through the controller's
   evidence-logged ``evict`` and a silent training worker through the
   work router's ``evict_worker``.
"""

import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu import resilience as jres
from deeplearning4j_tpu_torch import resilience as tres
from deeplearning4j_tpu_torch.kernels._build import KernelBuildError
from deeplearning4j_tpu_torch.monitor import tracer
from deeplearning4j_tpu_torch.monitor.flight import (
    FlightRecorder,
    classify_end_state,
    load_flight_records,
    set_flight,
)
from deeplearning4j_tpu_torch.monitor.ledger import (
    RunLedger,
    ledger_chunk_done,
    ledger_chunk_start,
    ledger_run_end,
    ledger_run_start,
    set_run_ledger,
)

PACKAGES = {"jax": jres, "torch": tres}


# ---------------------------------------------------------------------------
# the lease
# ---------------------------------------------------------------------------


def _scripted(script):
    """An acquisition that follows ``script``, one entry an attempt: an
    exception instance is raised, "ok" returns the attempt number."""
    calls = {"n": 0}

    def acquire():
        i = calls["n"]
        calls["n"] += 1
        step = script[min(i, len(script) - 1)]
        if isinstance(step, BaseException):
            raise step
        return f"grant-{i}"

    return acquire, calls


def _run_lease(res, script, *, faults=0, probe_script=None, **kw):
    """(value or exception type, state, reacquires, sleeps, attempts,
    probes) of one acquisition in package ``res``."""
    acquire, calls = _scripted(script)
    sleeps = []
    probes = []

    def probe():
        probes.append(1)
        return probe_script[len(probes) - 1]

    lease = res.GrantLease("t", acquire, bounded=False, sleep=sleeps.append,
                           probe=probe if probe_script else None, **kw)
    try:
        if faults:
            with res.inject("grant.lease", res.fail_times(faults)):
                out = lease.acquire()
        else:
            out = lease.acquire()
    except Exception as exc:  # noqa: BLE001 — compared across packages
        out = type(exc).__name__
        if isinstance(exc, res.GrantWedgedError):
            out = (out, exc.attempts)
    return (out, lease.state, lease.reacquires, sleeps, calls["n"],
            len(probes))


LEASE_CASES = {
    "clean": dict(script=["ok"]),
    "two_transient": dict(script=[OSError("a"), OSError("b"), "ok"],
                          max_reacquires=3),
    "exhausted": dict(script=[OSError("x")], max_reacquires=2),
    "exhausted_capped_backoff": dict(
        script=[OSError("x")], max_reacquires=4, base_backoff_s=3.0,
        backoff_multiplier=3.0, max_backoff_s=20.0),
    "non_retryable": dict(script=[ValueError("bug")],
                          retryable=(OSError,)),
    "predicate_filter": dict(script=[OSError("a"), "ok"],
                             retryable=lambda e: isinstance(e, OSError)),
    "no_reacquires": dict(script=[OSError("a"), "ok"], max_reacquires=0),
    "probe_gates": dict(script=[OSError("a"), "ok"], max_reacquires=3,
                        probe_script=[False, True]),
    "probe_never": dict(script=[OSError("a"), "ok"], max_reacquires=2,
                        probe_script=[False, False]),
}


@pytest.mark.parametrize("case", sorted(LEASE_CASES))
def test_lease_protocol_matches_the_reference(case):
    kw = dict(LEASE_CASES[case])
    script = kw.pop("script")
    got = {name: _run_lease(res, script, **kw)
           for name, res in PACKAGES.items()}
    assert got["torch"] == got["jax"]


@pytest.mark.chaos
@pytest.mark.parametrize("n_faults,reacquires", [(1, 2), (2, 2), (3, 2)])
def test_lease_fault_schedule_matches_the_reference(n_faults, reacquires):
    """``grant.lease=fail_times:n`` wedges the first n attempts in both
    packages, whatever the retryable filter names."""
    got = {name: _run_lease(res, ["ok"], faults=n_faults,
                            max_reacquires=reacquires,
                            retryable=(KeyError,))
           for name, res in PACKAGES.items()}
    assert got["torch"] == got["jax"]


def test_bounded_wedge_matches_the_reference():
    """An attempt that never returns is a wedge at the bound in both."""
    out = {}
    for name, res in PACKAGES.items():
        gate = threading.Event()
        calls = {"n": 0}
        released = []

        def acquire():
            calls["n"] += 1
            if calls["n"] == 1:
                gate.wait()
            return "late"

        lease = res.GrantLease("t", acquire, bounded=True, lease_s=0.05,
                               max_reacquires=1,
                               release=lambda: released.append(1),
                               sleep=lambda s: None)
        try:
            out[name] = (lease.acquire(), lease.reacquires, released)
        finally:
            gate.set()
    assert out["torch"] == out["jax"] == ("late", 1, [1])


def test_env_knobs_match_the_reference(monkeypatch):
    for lease_s, reacq in (("17.5", "4"), ("bogus", "bogus"), ("", "")):
        monkeypatch.setenv("DL4J_GRANT_LEASE_S", lease_s)
        monkeypatch.setenv("DL4J_GRANT_REACQUIRES", reacq)
        got = {n: (r.grant_lease_s(), r.grant_reacquires())
               for n, r in PACKAGES.items()}
        assert got["torch"] == got["jax"]


@pytest.mark.parametrize("exc", [
    KernelBuildError("nvcc failed for flash_fwd.cu"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
])
def test_kernel_fault_propagates_without_a_retry(exc):
    """A kernel that does not build or launch is not the grant's fault:
    the default filter re-raises it on the first attempt."""
    acquire, calls = _scripted([exc, "ok"])
    sleeps = []
    lease = tres.GrantLease("t", acquire, bounded=False,
                            sleep=sleeps.append)
    with pytest.raises(type(exc)):
        lease.acquire()
    assert calls["n"] == 1 and sleeps == [] and lease.state == "unheld"
    assert tres.lease.retryable_acquisition(OSError("transient"))
    assert not tres.lease.retryable_acquisition(KeyboardInterrupt())


@pytest.mark.chaos
def test_rescue_booked_as_grant_wait_and_classified_reacquired(tmp_path):
    """One re-acquire (the ``grant.lease`` site failing once) in a run:
    the ledger books the backoff and the re-acquire as ``grant_wait``,
    the flight recorder classifies the run ``reacquired``."""
    d = str(tmp_path / "flight")
    rec = FlightRecorder(d, heartbeat_s_=60.0)
    ledger = RunLedger(span_source=lambda: tracer().spans())
    set_flight(rec)
    set_run_ledger(ledger)
    try:
        ledger_run_start(model="lease", epochs=1)
        with tres.inject("grant.lease", tres.fail_times(1)):
            lease = tres.GrantLease("t", lambda: "ok", bounded=False,
                                    base_backoff_s=0.05, sleep=time.sleep)
            assert lease.acquire() == "ok"
        ledger_chunk_start()
        ledger_chunk_done()
        ledger_run_end(status="clean")
        report = ledger.report()
    finally:
        set_flight(None)
        set_run_ledger(None)
        rec.close()
    assert lease.reacquires == 1
    assert report["states"]["grant_wait"] >= 0.04
    verdict = classify_end_state(load_flight_records(d))
    assert verdict["end_state"] == "reacquired"
    assert verdict["evidence"]["n_reacquires"] == 1


# ---------------------------------------------------------------------------
# the autopilot
# ---------------------------------------------------------------------------


def _decisions(res, ticks, *, fail_first_evict=False, **kw):
    """Every decision of a ``GoodputAutopilot`` of package ``res`` over
    the scripted ``ticks`` (observe kwargs, ``now`` included), with every
    actuator bound; the first eviction's actuator raises when asked."""
    acted = []
    calls = {"evict": 0}

    def evict(member, d):
        calls["evict"] += 1
        if fail_first_evict and calls["evict"] == 1:
            raise OSError("tracker hiccup")
        acted.append(("evict", member))

    ap = res.GoodputAutopilot(
        clock=lambda: 0.0, evict=evict,
        reshard=lambda healthy, d: acted.append(("reshard", tuple(healthy))),
        readmit=lambda member, d: acted.append(("readmit", member)), **kw)
    out = []
    for tick in ticks:
        for d in ap.observe(**tick):
            out.append((d.action, d.target, d.reason, d.acted,
                        sorted((k, v) for k, v in d.gauges.items())))
    return out, acted, sorted(ap.evicted)


AUTOPILOT_SCRIPTS = {
    "silence": dict(kw=dict(floor=0.0, silence_s=5.0), ticks=[
        dict(fleet={"w0": {"step_s": 1.0}},
             last_beat={"w0": 99.0, "w1": 80.0}, now=100.0)]),
    "straggler_streak": dict(kw=dict(floor=0.0, silence_s=1e9,
                                     straggler_ticks=2), ticks=[
        dict(fleet={"w0": {"step_s": 9.0}}, stragglers=["w0"], now=0.0),
        dict(fleet={"w0": {"step_s": 9.0}}, stragglers=["w0"], now=1.0)]),
    "streak_resets": dict(kw=dict(floor=0.0, silence_s=1e9,
                                  straggler_ticks=2), ticks=[
        dict(fleet={}, stragglers=["w0"], now=0.0),
        dict(fleet={}, stragglers=[], now=1.0),
        dict(fleet={}, stragglers=["w0"], now=2.0)]),
    "floor_and_cooldown": dict(kw=dict(floor=50.0, silence_s=1e9,
                                       cooldown_s=10.0), ticks=[
        dict(fleet={"w0": {"goodput_pct": 20.0},
                    "w1": {"goodput_pct": 90.0}}, stragglers=["w1"],
             now=0.0),
        dict(fleet={"w0": {"goodput_pct": 20.0}}, now=5.0),
        dict(fleet={"w0": {"goodput_pct": 20.0}}, now=11.0),
        dict(fleet={"w0": {"goodput_pct": 90.0}}, goodput_pct=10.0,
             now=30.0)]),
    "readmit": dict(kw=dict(floor=0.0, silence_s=5.0), ticks=[
        dict(fleet={}, last_beat={"w0": 10.0}, now=100.0),
        dict(fleet={"w0": {"step_s": 1.0}}, last_beat={"w0": 199.0},
             now=200.0)]),
    "no_readmit_same_pass": dict(kw=dict(floor=0.0, silence_s=1e9,
                                         straggler_ticks=1), ticks=[
        dict(fleet={"w0": {"step_s": 9.0}}, stragglers=["w0"],
             last_beat={"w0": 99.5}, now=100.0),
        dict(fleet={"w0": {"step_s": 9.0}}, stragglers=[],
             last_beat={"w0": 99.5}, now=101.0),
        dict(fleet={"w0": {"step_s": 9.0}}, stragglers=[],
             last_beat={"w0": 109.0}, now=110.0)]),
}


def _random_script(seed: int, n_ticks: int = 25, members: int = 6):
    """Gauges a fleet could report: random stragglers, beats that stop
    and resume, goodput that dips under the floor."""
    rng = np.random.default_rng(seed)
    names = [f"w{i}" for i in range(members)]
    last = {m: 0.0 for m in names}
    ticks = []
    for t in range(1, n_ticks + 1):
        now = float(t)
        for m in names:
            if rng.random() < 0.7:
                last[m] = now - float(rng.integers(0, 3))
        fleet = {m: {"step_s": float(rng.integers(1, 9)) / 4,
                     "goodput_pct": float(rng.integers(20, 100))}
                 for m in names if rng.random() < 0.8}
        stragglers = [m for m in names if rng.random() < 0.15]
        ticks.append(dict(fleet=fleet, stragglers=stragglers,
                          last_beat=dict(last), now=now))
    return ticks


@pytest.mark.parametrize("case", sorted(AUTOPILOT_SCRIPTS) + [
    "random_0", "random_1", "random_2", "failing_actuator"])
def test_autopilot_decisions_match_the_reference(case):
    if case.startswith("random_"):
        kw = dict(floor=60.0, silence_s=2.5, straggler_ticks=2,
                  cooldown_s=4.0)
        ticks = _random_script(int(case.split("_")[1]))
        extra = {}
    elif case == "failing_actuator":
        kw = dict(floor=0.0, silence_s=1.0)
        ticks = [dict(fleet={}, last_beat={"w0": 0.0}, now=100.0),
                 dict(fleet={}, last_beat={"w0": 0.0}, now=101.0)]
        extra = dict(fail_first_evict=True)
    else:
        kw = AUTOPILOT_SCRIPTS[case]["kw"]
        ticks = AUTOPILOT_SCRIPTS[case]["ticks"]
        extra = {}
    got = {name: _decisions(res, ticks, **extra, **kw)
           for name, res in PACKAGES.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"][0] or case == "streak_resets"


def test_autopilot_env_helpers_match_the_reference(monkeypatch):
    for ap, floor in (("1", "72.5"), ("off", "junk"), ("true", "")):
        monkeypatch.setenv("DL4J_AUTOPILOT", ap)
        monkeypatch.setenv("DL4J_GOODPUT_FLOOR", floor)
        got = {n: (r.autopilot_enabled(), r.goodput_floor())
               for n, r in PACKAGES.items()}
        assert got["torch"] == got["jax"]


def test_serve_fleet_autopilot_evicts_a_straggler(monkeypatch):
    """Three replicas reporting, one slow for two ticks: the autopilot's
    straggler streak evicts it through the controller's ``evict``, with
    its gauges as the evidence, and its requests move to survivors."""
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM
    from deeplearning4j_tpu_torch.serving.fleet import (
        FleetController, FleetRouter, ServeReplica)

    lm = TransformerLM(vocab_size=31, d_model=16, num_heads=2, num_layers=1,
                       max_len=32, seed=1, device="cpu").init()
    reps = [ServeReplica(f"r{i}", lm, slots=1, max_len=32, device="cpu")
            for i in range(3)]
    router = FleetRouter(reps)
    ap = tres.GoodputAutopilot(floor=0.0, silence_s=1e9, straggler_ticks=2)
    controller = FleetController(router, None, evict_timeout_s=60.0,
                                 autopilot=ap)
    tpot = {"r0": 0.01, "r1": 0.012, "r2": 0.5}
    for r in reps:
        monkeypatch.setattr(
            r, "heartbeat_payload",
            lambda rid=r.replica_id: {"occupancy": 0.0, "queue_depth": 0,
                                      "free_slots": 1, "tpot_s": tpot[rid]})
    controller.tick()
    assert controller.evicted == [] and controller.stragglers == {"r2"}
    controller.tick()
    assert controller.evicted == ["r2"]
    entry = controller.eviction_log[0]
    assert entry["reason"] == "autopilot:straggler_streak"
    assert entry["last_metrics"]["tpot_s"] == 0.5
    assert [(d.action, d.target) for d in ap.decisions] == [
        ("evict", "r2")]
    assert reps[2].dead and not reps[0].dead


def test_trainer_autopilot_evicts_a_silent_worker(monkeypatch):
    from deeplearning4j_tpu_torch.parallel import InMemoryStateTracker
    from deeplearning4j_tpu_torch.parallel.workrouter import (
        DistributedTrainer, IterativeReduceWorkRouter)

    tracker = InMemoryStateTracker()
    trainer = DistributedTrainer(
        tracker, IterativeReduceWorkRouter(tracker),
        performer_factory=lambda: None, num_workers=1,
        autopilot=tres.GoodputAutopilot(floor=0.0, silence_s=0.05))
    tracker.heartbeat("w0", metrics={"step_s": 2.5})
    time.sleep(0.08)
    trainer.autopilot_tick(trainer.fleet_tick())
    assert trainer.evicted == ["w0"]
    entry = trainer.eviction_log[0]
    assert entry["reason"] == "autopilot:heartbeat_silence"
    assert entry["last_metrics"]["step_s"] == 2.5
    monkeypatch.setenv("DL4J_AUTOPILOT", "1")
    built = DistributedTrainer(
        tracker, IterativeReduceWorkRouter(tracker),
        performer_factory=lambda: None, num_workers=1,
        eviction_timeout_s=7.0)
    assert isinstance(built.autopilot, tres.GoodputAutopilot)
    assert built.autopilot.silence_s == 7.0
