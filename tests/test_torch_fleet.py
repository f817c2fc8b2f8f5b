"""The serve fleet on port replicas: ``deeplearning4j_tpu_torch.serving
.fleet`` re-running the cases of ``tests/test_serving_fleet.py`` and
``tests/test_serve_overload.py`` with the same assertions, plus a
JAX-against-port run of the fleet load driver, the tracker, lease and
autopilot wiring, and the port's compile cache.

The load-bearing claims:

1. **Failover never costs tokens.** A killed replica's requests complete
   on survivors token-identical to an unfailed run: greedy streams
   continue from their emitted prefix, sampled streams replay from the
   request's seed.
2. **Handoffs are exact.** A prefill replica's exported ``(kv_slab,
   cursor, key)`` installed into a decode replica's free slot produces
   the stream a local prefill would, greedy and sampled; the key is the
   slot generator's state, so it installs only on the same device type.
3. **Routing is least-loaded and bounded**, deadlines shed at the
   earliest point with evidence, retries and hedges draw on budgets, and
   a graceful drain moves live slabs with zero recompute.
4. **The port's fleet is the reference's.** Under pinned step costs and
   a kill of ``r0`` the port's ``FleetLoadDriver`` logs the JAX fleet's
   dispatches and emits its tokens, losing nothing on either side.
"""

import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.kernels import _build
from deeplearning4j_tpu_torch.models.transformer import TransformerLM
from deeplearning4j_tpu_torch.monitor import metrics, set_tracer, tracer
from deeplearning4j_tpu_torch.monitor import SpanTracer
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.serving import (
    DecodeServer, RetryBudget, ServeQueueFull, compile_cache_dir,
    compile_cache_stats, ensure_compile_cache, poisson_schedule,
    run_open_loop, serve_evict_s, serve_replicas, serve_role)
from deeplearning4j_tpu_torch.serving import compile_cache as cc_mod
from deeplearning4j_tpu_torch.serving.fleet import (
    FleetController, FleetLoadDriver, FleetRouter, ServeReplica,
    export_live_slot, export_slot, install_slot, make_install)
from deeplearning4j_tpu_torch.serving.fleet.handoff import (
    SlotHandoff, generator_key)
from deeplearning4j_tpu_torch.serving.scheduler import (
    RequestQueue, ServeRequest)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLEET_CFG = dict(vocab_size=61, d_model=32, num_heads=4, num_kv_heads=2,
                 num_layers=2, max_len=96, seed=3, pos_encoding="rope")
_LM_CACHE = {}


def _lm(key="greedy", **kw):
    """One tiny port model per config, cached for the module."""
    if key not in _LM_CACHE:
        _LM_CACHE[key] = TransformerLM(**{**FLEET_CFG, **kw},
                                       device="cpu").init()
    return _LM_CACHE[key]


def _replica(rid, lm=None, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("device", "cpu")
    return ServeReplica(rid, lm if lm is not None else _lm(), **kw)


def _server(lm=None, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("device", "cpu")
    return DecodeServer(lm if lm is not None else _lm(), **kw)


def _ref(lm, prompt, n, **kw):
    return lm.generate(np.asarray(prompt)[None], n, **kw)[0].numpy()


def _prompt(n=4):
    return np.arange(1, n + 1, dtype=np.int32)


def _pinned(replica):
    replica.step_once()
    return 0.01


class _Tracer:
    """Install a fresh tracer for the block; restore the old one after."""

    def __enter__(self):
        self.old = tracer()
        self.tr = SpanTracer()
        set_tracer(self.tr)
        return self.tr

    def __exit__(self, *exc):
        set_tracer(self.old)


def _events(tr, name):
    return [{"event": sp.name, **sp.attrs} for sp in tr.spans()
            if sp.name == name]


# ---------------------------------------------------------------------------
# env knobs and server hooks
# ---------------------------------------------------------------------------
def test_env_knobs(monkeypatch):
    assert serve_replicas() == 2
    monkeypatch.setenv("DL4J_SERVE_REPLICAS", "5")
    assert serve_replicas() == 5
    monkeypatch.setenv("DL4J_SERVE_REPLICAS", "junk")
    assert serve_replicas() == 2
    assert serve_role() == "mixed"
    monkeypatch.setenv("DL4J_SERVE_ROLE", "prefill")
    assert serve_role() == "prefill"
    monkeypatch.setenv("DL4J_SERVE_ROLE", "bogus")
    with pytest.raises(ValueError, match="DL4J_SERVE_ROLE"):
        serve_role()
    assert serve_evict_s() == 10.0
    monkeypatch.setenv("DL4J_SERVE_EVICT_S", "2.5")
    assert serve_evict_s() == 2.5


def test_replica_rejects_unknown_role():
    with pytest.raises(ValueError, match="role"):
        _replica("r0", role="bogus")


def test_try_submit_and_free_slots():
    server = _server(max_queue=1)
    assert server.free_slot_count() == 2
    v1 = server.try_submit(_prompt(), 4)
    assert v1.admitted and v1.request is not None and v1.reason is None
    v2 = server.try_submit(_prompt(), 2)
    assert not v2.admitted and v2.reason == "queue_full"
    assert v2.request is None and v2.queue_depth == 1
    with pytest.raises(ServeQueueFull):
        server.submit(_prompt(), 2)
    server.step()
    assert server.free_slot_count() == 1
    server.drain()
    assert server.free_slot_count() == 2
    with pytest.raises(ValueError):
        server.try_submit(np.zeros(0, np.int32), 2)
    with pytest.raises(ValueError):
        server.try_submit(_prompt(), 999)


def test_rejected_counter_on_verdict():
    reg = metrics()
    server = _server(slots=1, max_queue=1)
    r0 = reg.counter("serve_requests_total").value(event="rejected")
    server.try_submit(_prompt(3), 2)
    assert not server.try_submit(_prompt(3), 2).admitted
    assert reg.counter("serve_requests_total").value(
        event="rejected") == r0 + 1


def test_loadgen_drop_timestamps_recorded():
    server = _server(slots=1, max_queue=1, clock=time.monotonic)
    sched = poisson_schedule(8, rate_rps=5000.0, vocab_size=61,
                             prompt_lens=(4,), max_new_tokens=(8,), seed=0)
    report = run_open_loop(server, sched)
    assert report.rejected > 0
    assert len(report.drop_times_s) == report.rejected
    assert report.submitted + report.rejected == 8
    s = report.summary()
    assert s["dropped_request_seconds"] == sorted(
        round(t, 3) for t in report.drop_times_s)
    assert report.finished == report.submitted


# ---------------------------------------------------------------------------
# routing policy
# ---------------------------------------------------------------------------
def test_least_loaded_splits_a_burst():
    router = FleetRouter([_replica(f"r{i}") for i in range(2)])
    a = router.submit(_prompt(), 2)
    b = router.submit(_prompt(), 2)
    assert {a.replica_id, b.replica_id} == {"r0", "r1"}


def test_ttft_tiebreak():
    reps = [_replica(f"r{i}") for i in range(2)]
    reps[0]._ttfts.append(0.5)
    reps[1]._ttfts.append(0.01)
    assert FleetRouter(reps).submit(_prompt(), 2).replica_id == "r1"


def test_spill_and_drop():
    reg = metrics()
    reps = [_replica(f"r{i}", slots=1, max_queue=1) for i in range(2)]
    router = FleetRouter(reps)
    placed = [router.try_submit(_prompt(3), 2) for _ in range(2)]
    assert {fr.replica_id for fr in placed} == {"r0", "r1"}
    d0 = reg.counter("serve_route_total").value(outcome="dropped")
    assert router.try_submit(_prompt(3), 2) is None
    assert reg.counter("serve_route_total").value(
        outcome="dropped") == d0 + 1


def test_sticky_affinity():
    router = FleetRouter([_replica(f"r{i}", slots=4, max_queue=8)
                          for i in range(2)])
    a = router.submit(_prompt(), 2, affinity="session-7")
    other = "r1" if a.replica_id == "r0" else "r0"
    b = router.submit(_prompt(), 2, affinity="session-7")
    assert b.replica_id == a.replica_id != other
    router._by_id[a.replica_id].dead = True
    c = router.submit(_prompt(), 2, affinity="session-7")
    assert c.replica_id == other


def test_build_reads_env_replica_count(monkeypatch):
    monkeypatch.setenv("DL4J_SERVE_REPLICAS", "3")
    router = FleetRouter.build(_lm(), slots=2, max_len=64, device="cpu")
    assert [r.replica_id for r in router.replicas] == [
        "replica-0", "replica-1", "replica-2"]
    assert router.build(_lm(), replicas=1, slots=2, max_len=64,
                        device="cpu").stats()["replicas"] == 1


def test_uniform_fleet_config_required():
    with pytest.raises(ValueError, match="max_len"):
        FleetRouter([_replica("r0"), _replica("r1", max_len=48)])
    hot = _replica("r1", server=_server(temperature=0.8))
    with pytest.raises(ValueError, match="temperature"):
        FleetRouter([_replica("r0"), hot])


# ---------------------------------------------------------------------------
# failover
# ---------------------------------------------------------------------------
def test_greedy_continuation_token_identity():
    lm = _lm()
    router = FleetRouter([_replica(f"r{i}", fuse_steps=2)
                          for i in range(2)])
    controller = FleetController(router, None, evict_timeout_s=5.0)
    prompt = _prompt(6)
    fr = router.submit(prompt, 8)
    victim = fr.replica_id
    router._by_id[victim].step_once()
    emitted_before = len(fr.tokens)
    assert 0 < emitted_before < 8
    decision = controller.evict(victim, reason="test-kill")
    assert fr.emitted and len(fr.emitted) == emitted_before
    assert fr.replica_id != victim
    survivor = router._by_id[fr.replica_id]
    while survivor.busy():
        survivor.step_once()
    assert fr.finished
    np.testing.assert_array_equal(fr.output, _ref(lm, prompt, 8))
    assert decision["replica"] == victim
    assert decision["failover"]["victims"] == 1
    assert controller.eviction_log[-1] is decision
    assert metrics().gauge("fleet_serve_occupancy").value(
        replica=victim) == 0.0


def test_sampled_replay_token_identity():
    lm = _lm()
    reps = [_replica(f"r{i}", temperature=0.7, top_k=20) for i in range(2)]
    router = FleetRouter(reps)
    controller = FleetController(router, None, evict_timeout_s=5.0)
    prompt = _prompt(6)
    fr = router.submit(prompt, 6, seed=123)
    victim = fr.replica_id
    router._by_id[victim].step_once()
    assert fr.tokens
    controller.evict(victim, reason="test-kill")
    assert fr.emitted == []
    survivor = router._by_id[fr.replica_id]
    while survivor.busy():
        survivor.step_once()
    assert fr.finished
    np.testing.assert_array_equal(
        fr.output, _ref(lm, prompt, 6, temperature=0.7, top_k=20, seed=123))


def test_replayed_continuation_rebuilds_the_slot_bitwise():
    """The port's failover continuation prefills the prompt and replays
    the emitted tokens through the decode step: the survivor's slot then
    holds the dead replica's K/V bit for bit and emits its next token,
    under bf16 too (a prefill over the emitted tokens rounds them
    differently)."""
    lm = _lm("bf16", dtype_policy="mixed_bf16")
    src = _server(lm, fuse_steps=3)
    prompt = _prompt(7)
    req = src.submit(prompt, 12)
    src.step()
    src.step()
    emitted = list(req.tokens)
    cursor = src.engine.cursor_of(req.slot)
    assert cursor == len(prompt) + len(emitted) - 1
    dst = _server(lm)
    tok = dst.engine.prefill(np.concatenate([prompt, emitted[:-1]]), 1,
                             replay=len(emitted) - 1)
    assert dst.engine.cursor_of(1) == cursor
    assert int(tok) == emitted[-1]
    for pool in ("k", "v"):
        a = getattr(src.engine.cache, pool)[:, req.slot, :cursor]
        b = getattr(dst.engine.cache, pool)[:, 1, :cursor]
        assert torch.equal(a, b), pool
    with pytest.raises(ValueError, match="replay"):
        dst.engine.prefill(prompt, 0, replay=len(prompt))


def test_bf16_greedy_failover_equals_generate():
    lm = _lm("bf16", dtype_policy="mixed_bf16")
    router = FleetRouter([_replica(f"r{i}", lm, fuse_steps=2)
                          for i in range(2)])
    controller = FleetController(router, None, evict_timeout_s=5.0)
    frs = [router.submit(_prompt(n), 14) for n in (5, 9)]
    router._by_id["r0"].step_once()
    router._by_id["r0"].step_once()
    controller.evict("r0", reason="test-kill")
    while router.unfinished():
        router._by_id["r1"].step_once()
    for fr in frs:
        np.testing.assert_array_equal(fr.output, _ref(lm, fr.prompt, 14))
    assert any(fr.emitted for fr in frs)


def test_exact_dispatch_counts_across_failover():
    """K=4 fused: A needs 9 (prefill 1 + 4 on f0 before the kill, then a
    re-prefill emits 1 + 3 fused on f1), B needs 5 (prefill 1 + 4 fused);
    one shared dispatch on the survivor covers both."""
    lm = _lm()
    reps = [_replica(f"f{i}", fuse_steps=4) for i in range(2)]
    router = FleetRouter(reps)
    controller = FleetController(router, None, evict_timeout_s=5.0)
    prompt = _prompt(8)
    fa = router.submit(prompt, 9)
    fb = router.submit(prompt + 1, 5)
    assert fa.replica_id == "f0" and fb.replica_id == "f1"
    reps[0].step_once()
    assert len(fa.tokens) == 5
    controller.evict("f0", reason="test-kill")
    while reps[1].busy():
        reps[1].step_once()
    assert fa.finished and fb.finished
    assert reps[0].server.steps == 1 and reps[1].server.steps == 1
    np.testing.assert_array_equal(fa.output, _ref(lm, prompt, 9))
    np.testing.assert_array_equal(fb.output, _ref(lm, prompt + 1, 5))


def test_fully_emitted_requeue_completes_without_survivor_work():
    lm = _lm()
    pre = _replica("p0", role="prefill")
    dec = _replica("d0", role="decode")
    router = FleetRouter([pre, dec])
    controller = FleetController(router, None, evict_timeout_s=5.0)
    prompt = _prompt(5)
    fr = router.submit(prompt, 1)
    pre.step_once()
    assert len(fr.tokens) == 1 and not fr.finished
    controller.evict("d0", reason="test-kill")
    assert fr.finished and fr.latency_s is not None
    np.testing.assert_array_equal(fr.output, _ref(lm, prompt, 1))


def test_parked_failover_retries_when_survivor_frees():
    lm = _lm()
    reps = [_replica(f"r{i}", slots=1, max_queue=1) for i in range(2)]
    router = FleetRouter(reps)
    controller = FleetController(router, None, evict_timeout_s=5.0)
    frs = [router.submit(_prompt(), 4, seed=i) for i in range(2)]
    for r in reps:
        r.step_once()
    frs += [router.submit(_prompt(), 4, seed=2 + i) for i in range(2)]
    victim = frs[0].replica_id
    survivor = router._by_id["r1" if victim == "r0" else "r0"]
    controller.evict(victim, reason="test-kill")
    assert router.stats()["pending_failover"] > 0
    for _ in range(64):
        if not router.unfinished():
            break
        survivor.step_once()
        controller.tick()
    assert all(fr.finished for fr in frs), [fr.state for fr in frs]
    for fr in frs:
        np.testing.assert_array_equal(fr.output, _ref(lm, fr.prompt, 4))


def test_queued_requests_requeue_too():
    lm = _lm()
    router = FleetRouter([_replica(f"r{i}", slots=1, max_queue=4)
                          for i in range(2)])
    controller = FleetController(router, None, evict_timeout_s=5.0)
    frs = [router.submit(_prompt(), 3, seed=i) for i in range(4)]
    victim = frs[0].replica_id
    controller.evict(victim, reason="test-kill")
    survivor = router._by_id["r1" if victim == "r0" else "r0"]
    while survivor.busy():
        survivor.step_once()
    assert all(fr.finished for fr in frs)
    for fr in frs:
        np.testing.assert_array_equal(fr.output, _ref(lm, fr.prompt, 3))


# ---------------------------------------------------------------------------
# controller: gauges, stragglers, crash eviction; what is not ported
# ---------------------------------------------------------------------------
def _fleet_of_three():
    shared = _server()
    reps = [_replica(f"r{i}", server=shared) for i in range(3)]
    return reps, FleetRouter(reps)


def test_tick_gauges_from_payloads():
    reg = metrics()
    reps, router = _fleet_of_three()
    fleet = FleetController(router, None, evict_timeout_s=5.0).tick()
    assert set(fleet) == {"r0", "r1", "r2"}
    assert reg.gauge("fleet_serve_replicas").value() == 3.0
    assert reg.gauge("fleet_serve_free_slots").value(replica="r1") == 2.0
    assert reg.gauge("fleet_serve_occupancy").value(replica="r2") == 0.0


def test_straggler_flag_and_recovery(monkeypatch):
    """The reference feeds TPOTs through tracker beats; here the same
    payloads come straight from the replicas."""
    reg = metrics()
    reps, router = _fleet_of_three()
    controller = FleetController(router, None, evict_timeout_s=60.0,
                                 straggler_ratio=3.0)
    base = {"occupancy": 0.5, "queue_depth": 0, "free_slots": 1}
    tpot = {"r0": 0.01, "r1": 0.012, "r2": 0.2}
    for r in reps:
        monkeypatch.setattr(r, "heartbeat_payload",
                            lambda rid=r.replica_id: {**base,
                                                      "tpot_s": tpot[rid]})
    c0 = reg.counter("fleet_serve_stragglers_total").value(replica="r2")
    with _Tracer() as tr:
        controller.tick()
    assert controller.stragglers == {"r2"}
    assert reg.counter("fleet_serve_stragglers_total").value(
        replica="r2") == c0 + 1
    ev = _events(tr, "serve.straggler")
    assert ev and ev[0]["replica"] == "r2" and ev[0]["ratio"] == 3.0
    tpot["r2"] = 0.011
    controller.tick()
    assert controller.stragglers == set()
    # below three reporting: no flags
    tpot["r1"] = 9.9
    controller2 = FleetController(FleetRouter(reps[:2]), None,
                                  evict_timeout_s=60.0)
    controller2.tick()
    assert controller2.stragglers == set()


def test_crash_eviction_with_evidence():
    reps, router = _fleet_of_three()
    controller = FleetController(router, None, evict_timeout_s=5.0)
    reps[0]._die("RuntimeError: boom")
    controller.tick()
    assert controller.evicted == ["r0"]
    ev = controller.eviction_log[0]
    assert ev["reason"] == "crashed: RuntimeError: boom"
    assert ev["timeout_s"] == 5.0 and ev["silent_s"] is None
    assert "r0" not in controller.tick()


def test_tracker_lease_and_autopilot_raise_naming_their_items(monkeypatch):
    """``tracker=`` (replicas beat through a HeartbeatMonitor, the
    controller reads the beats), the grant lease (``lease=``: acquired by
    ``start``; a wedge on every attempt marks the replica dead and the
    controller's crash path evicts it) and the autopilot (``autopilot=``
    or ``DL4J_AUTOPILOT``: bound to the controller's evict) on port
    replicas."""
    from deeplearning4j_tpu_torch.parallel import InMemoryStateTracker
    from deeplearning4j_tpu_torch.resilience import (
        GoodputAutopilot, GrantLease)

    reps, router = _fleet_of_three()
    tracker = InMemoryStateTracker()
    rx = _replica("rx", tracker=tracker, heartbeat_interval_s=0.02)
    rx.start()
    try:
        deadline = time.monotonic() + 5.0
        while (tracker.heartbeat_metrics("rx") is None
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert tracker.heartbeat_metrics("rx")["free_slots"] == 2
    finally:
        rx.stop()
    assert rx.monitor is None
    # a lease around the warm-up: acquired once, the replica serves
    ry = _replica("ry")
    ry.lease = GrantLease("ry", ry.warm_up, bounded=False,
                          sleep=lambda s: None)
    ry.start()
    try:
        assert ry.lease.state == "held" and ry.alive
    finally:
        ry.stop()
    # a lease that wedges on every attempt: a dead replica, evicted
    wedged = GrantLease("r2", lambda: (_ for _ in ()).throw(
        OSError("wedged")), bounded=False, max_reacquires=1,
        sleep=lambda s: None)
    reps[2].lease = wedged
    reps[2].start()
    assert reps[2].dead and reps[2].dead_reason.startswith("grant wedged")
    assert FleetController(router, tracker).tracker is tracker
    built = FleetRouter.build(_lm(), replicas=1, tracker=tracker, slots=2,
                              max_len=64, device="cpu")
    assert built.replicas[0].tracker is tracker
    ap = GoodputAutopilot(floor=0.0, silence_s=1e9)
    controller = FleetController(router, None, autopilot=ap)
    assert controller.autopilot is ap
    controller.tick()
    assert controller.evicted == ["r2"]
    assert controller.eviction_log[0]["reason"].startswith(
        "crashed: grant wedged")
    monkeypatch.setenv("DL4J_AUTOPILOT", "1")
    assert isinstance(FleetController(router, None).autopilot,
                      GoodputAutopilot)
    monkeypatch.setenv("DL4J_AUTOPILOT", "off")
    assert FleetController(router, None).autopilot is None


def test_silence_eviction_with_evidence():
    """A replica whose beats stopped is evicted once the controller's
    clock has moved ``evict_timeout_s`` past its last beat, with the
    evidence on the log (reference ``tests/test_serving_fleet.py:431``);
    the clock is a fake one, so nothing sleeps."""
    from deeplearning4j_tpu_torch.parallel import InMemoryStateTracker

    reps, router = _fleet_of_three()
    tracker = InMemoryStateTracker()
    now = {"t": time.time()}
    controller = FleetController(router, tracker, evict_timeout_s=5.0,
                                 clock=lambda: now["t"])
    payload = {"occupancy": 1.0, "tpot_s": 0.02}
    for r in ("r0", "r1", "r2"):
        tracker.heartbeat(r, metrics=payload)
    controller.tick()
    assert controller.evicted == []
    now["t"] += 6.0
    for r in ("r1", "r2"):  # r0 went silent
        tracker._beats[r] = now["t"]
    controller.tick()
    assert controller.evicted == ["r0"]
    ev = controller.eviction_log[0]
    assert ev["reason"] == "heartbeat_silence"
    assert ev["silent_s"] >= 5.0 and ev["timeout_s"] == 5.0
    assert ev["last_metrics"]["occupancy"] == 1.0
    assert reps[0].dead and "r0" not in controller.tick()


@pytest.mark.parametrize("deferred", [False, True],
                         ids=["one_device", "tp_deferred"])
def test_autopilot_eviction_that_raises_is_retried(monkeypatch, deferred):
    """An autopilot eviction whose ``evict`` raises leaves the member
    un-latched and the tick standing, and the next tick evicts it: in
    the autopilot's own pass (one-device fleets) and when a
    tensor-parallel fleet carries rank 0's decisions out after the pass
    (``deferred``: this one-device fleet takes that path)."""
    from deeplearning4j_tpu_torch.parallel import InMemoryStateTracker
    from deeplearning4j_tpu_torch.resilience import GoodputAutopilot

    if deferred:
        monkeypatch.setattr(FleetRouter, "tensor_parallel",
                            property(lambda self: True))
    reps, router = _fleet_of_three()
    tracker = InMemoryStateTracker()
    now = {"t": time.time()}
    clock = lambda: now["t"]  # noqa: E731
    ap = GoodputAutopilot(floor=0.0, silence_s=5.0, clock=clock)
    controller = FleetController(router, tracker, evict_timeout_s=1e9,
                                 clock=clock, autopilot=ap)
    tracker.heartbeat("r0", metrics={"occupancy": 1.0, "tpot_s": 0.02})
    now["t"] += 6.0
    real, calls = controller.evict, []

    def flaky(replica_id, **kw):
        calls.append(replica_id)
        if len(calls) == 1:
            raise RuntimeError("transient")
        return real(replica_id, **kw)

    controller.evict = flaky
    controller.tick()
    assert calls == ["r0"] and controller.evicted == []
    assert "r0" not in ap.evicted and not ap.decisions[-1].acted
    controller.tick()
    assert calls == ["r0", "r0"] and controller.evicted == ["r0"]
    assert "r0" in ap.evicted and ap.decisions[-1].acted
    assert controller.eviction_log[0]["reason"] == \
        "autopilot:heartbeat_silence"
    controller.tick()
    assert calls == ["r0", "r0"]


# ---------------------------------------------------------------------------
# prefill/decode handoff
# ---------------------------------------------------------------------------
def _handoff(engine, slot, prompt, tok, gen=None, **kw):
    base = dict(slabs=export_slot(engine, slot), cursor=len(prompt),
                key=generator_key(gen), first_token=int(tok),
                kv_dtype=engine.kv_dtype, max_len=engine.max_len,
                device=engine.device.type)
    base.update(kw)
    return SlotHandoff(**base)


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_export_install_round_trip_greedy(kv_dtype):
    lm = _lm()
    src, dst = _server(kv_dtype=kv_dtype), _server(kv_dtype=kv_dtype)
    prompt = _prompt(8)
    tok = src.engine.prefill(prompt, 0)
    handoff = _handoff(src.engine, 0, prompt, tok)
    assert handoff.nbytes == src.stats()["kv_per_slot_bytes"]
    req = ServeRequest(prompt=prompt, max_new_tokens=6)
    req.submit_s = 0.0
    req.tokens.append(int(tok))
    dst.admit_external(req, make_install(handoff))
    assert dst.busy() and dst.handoff_headroom() == 1
    dst.drain()
    assert req.state == "finished" and req.handoff
    # the installed slot holds exactly the exported slab
    local = _server(kv_dtype=kv_dtype)
    want = local.submit(prompt, 6)
    local.drain()
    np.testing.assert_array_equal(req.output, want.output)
    if kv_dtype != "int8":
        np.testing.assert_array_equal(req.output, _ref(lm, prompt, 6))


def test_live_slot_export_continues_a_sampled_stream():
    lm = _lm()
    kw = dict(temperature=0.7, top_k=20, fuse_steps=2)
    src, dst = _server(**kw), _server(**kw)
    prompt = _prompt(6)
    req = src.submit(prompt, 9, seed=5)
    src.step()
    src.step()
    assert 0 < len(req.tokens) < 9
    handoff = export_live_slot(src, req.slot)
    assert handoff.cursor == len(prompt) + len(req.tokens) - 1
    src._slot_req[req.slot] = None
    dst.admit_external(req, make_install(handoff))
    dst.drain()
    np.testing.assert_array_equal(
        req.output, _ref(lm, prompt, 9, temperature=0.7, top_k=20, seed=5))


def test_split_fleet_end_to_end_sampled():
    lm = _lm()
    kw = dict(temperature=0.7, top_k=20)
    pre = _replica("p0", role="prefill", **kw)
    dec = _replica("d0", role="decode", **kw)
    router = FleetRouter([pre, dec])
    assert router.split
    prompt = _prompt(6)
    fr = router.submit(prompt, 6, seed=42)
    assert fr.replica_id == "p0"
    pre.step_once()
    assert fr.replica_id == "d0"
    assert len(fr.tokens) == 1 and fr.ttft_s is not None
    while dec.busy():
        dec.step_once()
    assert fr.finished
    np.testing.assert_array_equal(
        fr.output, _ref(lm, prompt, 6, temperature=0.7, top_k=20, seed=42))


def test_split_fleet_parks_several_slabs():
    """More finished prefills than decode slots: the slabs park and
    land as slots free. The reference's parking check (``freq not in
    self._pending``) compares prompt arrays field-wise and raises once a
    second slab parks; the port's compares identities."""
    lm = _lm()
    pre = _replica("p0", role="prefill", slots=1)
    dec = _replica("d0", role="decode", slots=1, fuse_steps=2)
    router = FleetRouter([pre, dec])
    frs = [router.submit(_prompt(n), 5) for n in (4, 6, 9)]
    for _ in frs:
        pre.step_once()
    assert router.stats()["pending_failover"] == 2
    for _ in range(64):
        if not router.unfinished():
            break
        dec.step_once()
        router.retry_pending()
    for fr in frs:
        assert fr.finished
        np.testing.assert_array_equal(fr.output, _ref(lm, fr.prompt, 5))


def test_split_fleet_config_and_capacity_validation():
    lm = _lm()
    pre = _replica("p0", role="prefill")
    spec_dec = _replica("d0", role="decode",
                        server=_server(lm, draft_layers=1))
    with pytest.raises(ValueError, match="speculative"):
        FleetRouter([pre, spec_dec])
    router = FleetRouter([pre, _replica("d0", role="decode")])
    with pytest.raises(ValueError, match="slot capacity"):
        router.submit(np.arange(1, 41, dtype=np.int32), 30)


def test_handoff_validation():
    lm = _lm()
    src = _server()
    prompt = _prompt()
    tok = src.engine.prefill(prompt, 0)
    good = _handoff(src.engine, 0, prompt, tok)
    with pytest.raises(ValueError, match="max_len"):
        install_slot(_server(max_len=48).engine, 0, good)
    with pytest.raises(ValueError, match="kv_dtype"):
        install_slot(_server(kv_dtype="int8").engine, 0, good)
    # a CUDA generator's state cannot continue on a CPU replica
    with pytest.raises(ValueError, match="cuda replica cannot install"):
        install_slot(_server().engine, 0,
                     _handoff(src.engine, 0, prompt, tok, device="cuda"))
    spec = _server(lm, draft_layers=1)
    req = ServeRequest(prompt=prompt, max_new_tokens=2)
    req.tokens.append(int(tok))
    with pytest.raises(ValueError, match="speculative"):
        spec.admit_external(req, make_install(good))
    bare = ServeRequest(prompt=prompt, max_new_tokens=2)
    with pytest.raises(ValueError, match="prefilled"):
        _server().admit_external(bare, make_install(good))


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_handoff_of_fewer_heads_raises(kv_dtype):
    """A slab of fewer heads than the target pool's slot raises and
    leaves the pool as it was: written as ``pool[:, slot] = slab``, a
    one-head slab would broadcast into every head with no error (as a
    tensor-parallel rank's share of a slot would on a one-device
    pool)."""
    src = _server(kv_dtype=kv_dtype)
    prompt = _prompt()
    tok = src.engine.prefill(prompt, 0)
    good = _handoff(src.engine, 0, prompt, tok)
    assert good.slabs["k"].shape[2] == FLEET_CFG["num_kv_heads"]
    one_head = _handoff(src.engine, 0, prompt, tok, slabs={
        name: (slab[:, :, :1] if slab.ndim == 4 else slab[:, :1])
        for name, slab in good.slabs.items()})
    dst = _server(kv_dtype=kv_dtype)
    before = {name: t.clone() for name, t in
              (("k", dst.engine.cache.k), ("v", dst.engine.cache.v))}
    with pytest.raises(ValueError, match="shape"):
        install_slot(dst.engine, 1, one_head)
    for name, t in before.items():
        assert torch.equal(getattr(dst.engine.cache, name), t)


# ---------------------------------------------------------------------------
# the virtual-clock driver
# ---------------------------------------------------------------------------
def test_driver_deterministic_scaling():
    def run(n):
        router = FleetRouter([_replica(f"r{i}", fuse_steps=2)
                              for i in range(n)])
        driver = FleetLoadDriver(
            router, FleetController(router, None, evict_timeout_s=5.0),
            step_timer=_pinned)
        sched = poisson_schedule(12, rate_rps=1e4, vocab_size=61,
                                 prompt_lens=(4, 8), max_new_tokens=(6,),
                                 seed=5)
        report = driver.run(sched)
        assert report.finished == 12
        return report.summary()

    s1, s2 = run(1), run(2)
    assert s2["tokens_per_sec"] / s1["tokens_per_sec"] > 1.6
    assert s2["p50_latency_ms"] < s1["p50_latency_ms"]


def test_driver_failover_zero_lost():
    lm = _lm()
    router = FleetRouter([_replica(f"r{i}", fuse_steps=2)
                          for i in range(2)])
    controller = FleetController(router, None, evict_timeout_s=5.0)
    driver = FleetLoadDriver(router, controller, step_timer=_pinned)
    sched = poisson_schedule(10, rate_rps=1e4, vocab_size=61,
                             prompt_lens=(4,), max_new_tokens=(8,), seed=6)
    report = driver.run(sched, kill_at_s=0.02, kill_replica="r0")
    assert report.finished == 10
    assert controller.evicted == ["r0"]
    assert driver.kill_time_s is not None
    for fr in router.requests:
        np.testing.assert_array_equal(
            fr.output, _ref(lm, fr.prompt, fr.max_new_tokens))


def test_driver_matches_the_jax_fleet_under_pinned_costs():
    """The same fleet on both packages (same weights through numpy),
    pinned step costs and a kill of r0 mid-stream: identical dispatch
    logs, identical outputs, nothing lost on either side."""
    import jax

    from deeplearning4j_tpu.models.transformer import TransformerLM as JaxLM
    from deeplearning4j_tpu.serving import poisson_schedule as jax_schedule
    from deeplearning4j_tpu.serving.fleet import (
        FleetController as JaxController, FleetLoadDriver as JaxDriver,
        FleetRouter as JaxRouter, ServeReplica as JaxReplica)
    from deeplearning4j_tpu_torch.models.convert import params_from_jax

    ref = JaxLM(**FLEET_CFG).init()
    lm = TransformerLM(**FLEET_CFG, device="cpu")
    lm.params = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                       ref.params))
    sched_kw = dict(vocab_size=61, prompt_lens=(4, 9, 14),
                    max_new_tokens=(5, 8), seed=8)

    def run(replica_cls, router_cls, controller_cls, driver_cls, model,
            schedule, **kw):
        reps = [replica_cls(f"r{i}", model, slots=2, max_len=64,
                            fuse_steps=2, **kw) for i in range(2)]
        router = router_cls(reps)
        controller = controller_cls(router, None, evict_timeout_s=5.0)
        driver = driver_cls(router, controller, step_timer=_pinned)
        report = driver.run(schedule, kill_at_s=0.03, kill_replica="r0")
        return driver, router, controller, report

    jd, jr, jc, jrep = run(JaxReplica, JaxRouter, JaxController, JaxDriver,
                           ref, jax_schedule(12, 300.0, **sched_kw))
    pd, pr, pc, prep = run(ServeReplica, FleetRouter, FleetController,
                           FleetLoadDriver, lm,
                           poisson_schedule(12, 300.0, **sched_kw),
                           device="cpu")
    assert jrep.finished == prep.finished == 12        # zero lost
    assert jc.evicted == pc.evicted == ["r0"]
    assert pd.dispatch_log == jd.dispatch_log
    assert len(pd.dispatch_log) > 10
    for a, b in zip(jr.requests, pr.requests):
        np.testing.assert_array_equal(b.output, np.asarray(a.output))
        assert b.attempts == a.attempts
    assert any(fr.attempts > 1 for fr in pr.requests)  # r0 held work
    assert prep.summary()["retry_amplification"] == \
        jrep.summary()["retry_amplification"]


# ---------------------------------------------------------------------------
# chaos: kill a live threaded replica mid-stream
# ---------------------------------------------------------------------------
@pytest.mark.chaos
def test_replica_death_mid_stream_completes_on_survivors():
    lm = _lm()
    reps = [_replica(f"r{i}", fuse_steps=2) for i in range(2)]
    for r in reps:
        r.server.submit(_prompt(), 2)
        r.server.drain()
        r.server.finished.clear()
        r._finished_seen = 0
    router = FleetRouter(reps)
    controller = FleetController(router, None, evict_timeout_s=0.5)
    frs = [router.submit(_prompt(5), 8, seed=i) for i in range(6)]
    on_r0 = [fr for fr in frs if fr.replica_id == "r0"]
    assert on_r0
    try:
        faults.install("serve.replica.step.r0", faults.fail_nth(3))
        for r in reps:
            r.start()
        controller.start(interval_s=0.05)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if all(fr.finished for fr in frs):
                break
            time.sleep(0.05)
    finally:
        faults.uninstall("serve.replica.step.r0")
        controller.stop()
        for r in reps:
            r.stop()
    assert all(fr.finished for fr in frs), [fr.state for fr in frs]
    assert reps[0].dead and "FaultInjected" in reps[0].dead_reason
    for fr in frs:
        np.testing.assert_array_equal(fr.output, _ref(lm, fr.prompt, 8))
    evs = [e for e in controller.eviction_log if e["replica"] == "r0"]
    assert evs and evs[0]["reason"].startswith("crashed")


# ---------------------------------------------------------------------------
# deadlines: shed at the earliest point, with evidence
# ---------------------------------------------------------------------------
def _clocked(t, **kw):
    server = _server(max_queue=4, **kw)
    server.clock = lambda: t["now"]
    return server


def test_expired_at_admission():
    server = _clocked({"now": 10.0})
    v = server.try_submit(_prompt(), 4, deadline_s=9.0)
    assert not v.admitted and v.reason == "expired"
    assert server.shed_log[-1]["where"] == "admission"
    assert server.shed_log[-1]["reason"] == "deadline"
    assert server.shed[-1].state == "shed"
    assert len(server.queue) == 0


def test_expired_in_queue_swept_at_admit():
    t = {"now": 0.0}
    server = _clocked(t, slots=1)
    v1 = server.try_submit(_prompt(), 2, deadline_s=100.0)
    server.step()
    v2 = server.try_submit(_prompt(5), 4, deadline_s=0.5)
    assert v1.admitted and v2.admitted
    while v1.request.state != "finished":
        server.step()
    t["now"] = 1.0
    server.step()
    assert v2.request.state == "shed"
    assert v2.request.shed_reason == "deadline"
    assert server.stats()["expired_in_queue"] == 1
    assert server.stats()["expired_in_flight"] == 0


def test_expired_in_flight_frees_slot():
    t = {"now": 0.0}
    server = _clocked(t, slots=1)
    v = server.try_submit(_prompt(), 8, deadline_s=0.5)
    server.step()
    assert v.request.state == "running"
    t["now"] = 1.0
    server.step()
    assert v.request.state == "shed"
    assert server.stats()["expired_in_flight"] == 1
    v2 = server.try_submit(_prompt(), 4, deadline_s=100.0)
    server.step()
    assert v2.request.state == "running"


def test_env_deadline_budget_applies(monkeypatch):
    monkeypatch.setenv("DL4J_SERVE_DEADLINE_S", "2.5")
    server = _clocked({"now": 100.0})
    v = server.try_submit(_prompt(), 4)
    assert v.admitted
    assert v.request.deadline_s == pytest.approx(102.5)


def test_shed_events_on_tracer_timeline():
    with _Tracer() as tr:
        server = _clocked({"now": 10.0})
        server.try_submit(_prompt(), 4, deadline_s=1.0)
        evs = _events(tr, "serve.shed")
    assert len(evs) == 1 and evs[0]["reason"] == "deadline"


# ---------------------------------------------------------------------------
# criticality displacement
# ---------------------------------------------------------------------------
def test_queue_pops_by_class_priority():
    q = RequestQueue(max_depth=4)
    reqs = [ServeRequest(prompt=_prompt(), max_new_tokens=4, criticality=c)
            for c in ("batch", "best_effort", "interactive")]
    for r in reqs:
        assert q.try_push(r)
    assert [q.pop(), q.pop(), q.pop()] == [reqs[2], reqs[0], reqs[1]]


def test_displace_sheds_costliest_of_lowest_class():
    q = RequestQueue(max_depth=2)
    cheap = ServeRequest(prompt=_prompt(2), max_new_tokens=2,
                         criticality="best_effort")
    costly = ServeRequest(prompt=_prompt(8), max_new_tokens=16,
                          criticality="best_effort")
    for r in (cheap, costly):
        assert q.try_push(r)
    admitted, victim = q.displace(ServeRequest(
        prompt=_prompt(), max_new_tokens=4, criticality="batch"))
    assert admitted and victim is costly
    q1 = RequestQueue(max_depth=1)
    assert q1.try_push(ServeRequest(prompt=_prompt(), max_new_tokens=4,
                                    criticality="batch"))
    assert q1.displace(ServeRequest(prompt=_prompt(), max_new_tokens=4,
                                    criticality="batch")) == (False, None)


def test_server_displacement_evidence():
    server = _server(slots=1, max_queue=1)
    server.try_submit(_prompt(), 8, criticality="interactive")
    server.step()
    vb = server.try_submit(_prompt(5), 4, criticality="batch")
    assert vb.admitted
    vi = server.try_submit(_prompt(6), 4, criticality="interactive")
    assert vi.admitted and vi.displaced is vb.request
    assert vb.request.state == "shed"
    assert vb.request.shed_reason == "shed_overload"
    decision = server.shed_log[-1]
    assert decision["reason"] == "shed_overload"
    assert decision["displaced_by"] == vi.request.id
    assert server.stats()["shed_by_class"] == {"batch": 1}


def test_interactive_overload_sheds_newcomer_not_peer():
    server = _server(slots=1, max_queue=1)
    server.try_submit(_prompt(), 8, criticality="interactive")
    server.step()
    assert server.try_submit(_prompt(), 4,
                             criticality="interactive").admitted
    v = server.try_submit(_prompt(), 4, criticality="interactive")
    assert not v.admitted and v.reason == "queue_full"
    assert server.stats()["shed"] == 0


# ---------------------------------------------------------------------------
# retry budget
# ---------------------------------------------------------------------------
def test_retry_budget_token_bucket():
    b = RetryBudget(ratio=0.5, burst=2.0)
    assert b.remaining("batch") == 2.0
    assert b.try_spend("batch") and b.try_spend("batch")
    assert not b.try_spend("batch")
    b.deposit("batch")
    assert b.remaining("batch") == pytest.approx(0.5)
    assert not b.has("batch")
    b.refund("batch", 5.0)
    assert b.remaining("batch") == 2.0
    c = RetryBudget(ratio=0.1, burst=1.0)
    assert c.try_spend("interactive")
    assert not c.has("interactive") and c.has("batch")
    with pytest.raises(ValueError):
        RetryBudget().deposit("platinum")


def test_dry_budget_parks_failover_with_evidence():
    reps = [_replica(f"r{i}", fuse_steps=2) for i in range(2)]
    router = FleetRouter(reps)
    router.retry_budget = RetryBudget(ratio=0.0, burst=0.0)
    controller = FleetController(router, None, evict_timeout_s=5.0)
    frs = [router.submit(_prompt(), 4, seed=i) for i in range(2)]
    victim_rid = frs[0].replica_id
    victims = [fr for fr in frs if fr.replica_id == victim_rid]
    before = metrics().counter("serve_retry_denied_total").value(
        kind="failover", criticality="interactive")
    controller.evict(victim_rid, reason="test")
    assert all(fr.replica_id is None for fr in victims)
    assert len(router._pending) == len(victims)
    assert metrics().counter("serve_retry_denied_total").value(
        kind="failover", criticality="interactive") == before + len(victims)
    router.retry_budget = RetryBudget(ratio=0.1, burst=10.0)
    assert router.retry_pending() == len(victims)
    survivor = [r for r in reps if r.alive][0]
    while router.unfinished():
        survivor.step_once()
    for fr in frs:
        np.testing.assert_array_equal(
            fr.output, _ref(_lm(), fr.prompt, fr.max_new_tokens))


def test_first_placement_is_free():
    router = FleetRouter([_replica("r0", fuse_steps=2)])
    router.retry_budget = RetryBudget(ratio=0.0, burst=0.0)
    fr = router.try_submit(_prompt(), 4)
    assert fr is not None and fr.replica_id == "r0"


# ---------------------------------------------------------------------------
# hedging
# ---------------------------------------------------------------------------
def _hedge_fleet(t):
    reps = [_replica(f"r{i}", slots=1, max_queue=2, fuse_steps=2)
            for i in range(2)]
    clock = lambda: t["now"]  # noqa: E731
    router = FleetRouter(reps, clock=clock)
    for r in reps:
        r.clock = clock
        r.server.clock = clock
    router.hedge_after_s = 0.05
    return reps, router


def test_hedge_placed_after_threshold_and_budget_gated():
    t = {"now": 0.0}
    reps, router = _hedge_fleet(t)
    router.submit(_prompt(), 8, seed=0)
    router.submit(_prompt(5), 8, seed=0)
    for r in reps:
        r.step_once()
    c = router.submit(_prompt(6), 4, seed=0)
    assert c.inner.state == "queued"
    assert router.maybe_hedge() == 0
    t["now"] = 0.1
    assert router.maybe_hedge() == 1
    assert c.hedge is not None and c.hedge_replica_id != c.replica_id
    assert len(router.hedge_log) == 1
    router.retry_budget = RetryBudget(ratio=0.0, burst=0.0)
    c.hedge = None
    c.hedge_replica_id = None
    assert router.maybe_hedge() == 0


def test_hedge_win_cancels_queued_primary():
    t = {"now": 0.0}
    reps, router = _hedge_fleet(t)
    a = router.submit(_prompt(), 2, seed=0)
    b = router.submit(_prompt(5), 8, seed=0)
    for r in reps:
        r.step_once()
    c = router.submit(_prompt(6), 4, seed=0)
    primary_rid = c.replica_id
    t["now"] = 0.1
    assert router.maybe_hedge() == 1
    hedge_rep = router._by_id[c.hedge_replica_id]
    finish_first = a if hedge_rep.replica_id == "r0" else b
    while not finish_first.finished:
        hedge_rep.step_once()
    hedge_rep.step_once()
    assert c.hedge.state in ("running", "finished")
    assert c.inner.state == "queued"
    router.maybe_hedge()
    assert router.hedge_wins == 1
    assert c.replica_id == hedge_rep.replica_id and c.hedge is None
    assert router._by_id[primary_rid].server.queue.pop() is not c.inner
    while not c.finished:
        hedge_rep.step_once()
    np.testing.assert_array_equal(c.output, _ref(_lm(), c.prompt, 4))


def test_primary_win_cancels_hedge():
    t = {"now": 0.0}
    reps, router = _hedge_fleet(t)
    router.submit(_prompt(), 8, seed=0)
    router.submit(_prompt(5), 8, seed=0)
    for r in reps:
        r.step_once()
    c = router.submit(_prompt(6), 4, seed=0)
    t["now"] = 0.1
    assert router.maybe_hedge() == 1
    hedge_req = c.hedge
    pri_rep = router._by_id[c.replica_id]
    while c.inner.state == "queued":
        pri_rep.step_once()
    router.maybe_hedge()
    assert c.hedge is None and hedge_req.canceled
    assert router.hedge_wins == 0


def test_sampled_fleet_refuses_hedging():
    lm = _lm("sampled", seed=4)
    router = FleetRouter([_replica(f"r{i}", lm, slots=1, temperature=0.8)
                          for i in range(2)])
    router.hedge_after_s = 0.0
    router.submit(_prompt(), 4, seed=7)
    assert router.maybe_hedge() == 0


# ---------------------------------------------------------------------------
# graceful drain
# ---------------------------------------------------------------------------
def test_drain_migrates_live_and_queued_zero_recompute():
    lm = _lm()
    reps = [_replica(f"r{i}", max_queue=4, fuse_steps=2) for i in range(2)]
    router = FleetRouter(reps)
    controller = FleetController(router, None, evict_timeout_s=5.0)
    frs = [router.submit(_prompt(4 + i), 8, seed=i, affinity="pin")
           for i in range(3)]
    assert all(fr.replica_id == "r0" for fr in frs)
    r0 = router._by_id["r0"]
    for _ in range(2):
        r0.step_once()
    live_tokens = {fr.id: list(fr.tokens) for fr in frs}
    assert any(live_tokens.values())
    failover_before = metrics().counter(
        "fleet_serve_failover_requests_total").value()
    decision = controller.drain("r0", reason="test-drain")
    assert controller.drained == ["r0"]
    assert r0.retired and r0.alive is False and not r0.dead
    assert decision["migrated"] == 3
    assert decision["fallback_failovers"] == 0
    assert decision["live"] == 2 and decision["queued"] == 1
    assert controller.drain_log[-1] is decision
    assert metrics().counter(
        "fleet_serve_failover_requests_total").value() == failover_before
    for fr in frs:
        assert list(fr.tokens)[:len(live_tokens[fr.id])] == \
            live_tokens[fr.id]
    r1 = router._by_id["r1"]
    while router.unfinished():
        r1.step_once()
    for fr in frs:
        np.testing.assert_array_equal(
            fr.output, _ref(lm, fr.prompt, fr.max_new_tokens))


def test_drain_drops_hedge_copies_not_primaries():
    t = {"now": 0.0}
    reps, router = _hedge_fleet(t)
    controller = FleetController(router, None, evict_timeout_s=5.0,
                                 clock=lambda: t["now"])
    router.submit(_prompt(), 8, seed=0)
    router.submit(_prompt(5), 8, seed=0)
    for r in reps:
        r.step_once()
    c = router.submit(_prompt(6), 4, seed=0)
    t["now"] = 0.1
    assert router.maybe_hedge() == 1
    decision = controller.drain(c.hedge_replica_id, reason="test")
    assert decision["dropped_hedges"] == 1
    assert c.hedge is None
    assert not c.finished and c.shed_reason is None


def test_drain_is_idempotent_and_skips_evicted():
    router = FleetRouter([_replica(f"r{i}") for i in range(2)])
    controller = FleetController(router, None, evict_timeout_s=5.0)
    controller.drain("r0")
    assert controller.drain("r0")["reason"] == "already_evicted"
    controller.evict("r1", reason="dead")
    assert controller.drain("r1")["reason"] == "already_evicted"


def test_drain_emits_evidence():
    with _Tracer() as tr:
        router = FleetRouter([_replica(f"r{i}") for i in range(2)])
        controller = FleetController(router, None, evict_timeout_s=5.0)
        router.submit(_prompt(), 4)
        controller.drain("r0")
        evs = _events(tr, "serve.drain")
    assert len(evs) == 1 and evs[0]["replica"] == "r0"


# ---------------------------------------------------------------------------
# the storm soak: 3x capacity, a criticality mix, a mid-storm drain
# ---------------------------------------------------------------------------
def test_storm_soak_slos():
    lm = _lm()
    pin = 0.01

    def fleet():
        router = FleetRouter([_replica(f"r{i}", max_queue=4, fuse_steps=2)
                              for i in range(3)])
        controller = FleetController(router, None, evict_timeout_s=50.0)
        return router, controller, FleetLoadDriver(
            router, controller, step_timer=_pinned)

    _, _, base_driver = fleet()
    base = base_driver.run(poisson_schedule(
        30, rate_rps=20.0, vocab_size=61, prompt_lens=(4, 8),
        max_new_tokens=(6,), deadlines_s={"interactive": 10.0},
        seed=11)).summary()
    assert base["finished"] == 30
    base_ttft = max(base["ttft_p50_ms_by_class"]["interactive"], 1e3 * pin)

    router, controller, driver = fleet()
    sched = poisson_schedule(
        200, rate_rps=500.0, vocab_size=61, prompt_lens=(4, 8),
        max_new_tokens=(6,),
        criticality_mix={"interactive": 0.20, "batch": 0.65,
                         "best_effort": 0.15},
        deadlines_s={"interactive": 2.0, "batch": 0.15,
                     "best_effort": 0.08},
        seed=12)
    failover_before = metrics().counter(
        "fleet_serve_failover_requests_total").value()
    report = driver.run(sched, drain_at_s=sched[-1].arrival_s / 2,
                        drain_replica="r0")
    s = report.summary()
    assert s["shed"] + s["rejected"] > 0, s
    assert s["finished"] > 0
    assert s["expired_in_queue"] + s["expired_in_flight"] > 0, s
    storm_ttft = s["ttft_p50_ms_by_class"]["interactive"]
    assert storm_ttft <= 2.0 * base_ttft, (storm_ttft, base_ttft)
    decisions = list(router.shed_log)
    for r in router.replicas:
        decisions.extend(r.server.shed_log)
    assert decisions
    for d in decisions:
        assert (d["criticality"] in ("batch", "best_effort")
                or d["reason"] == "deadline"), d
    assert s["retry_amplification"] is not None
    assert s["retry_amplification"] <= 1.2, s["retry_amplification"]
    assert controller.drained == ["r0"]
    assert router._by_id["r0"].retired
    assert driver.drain_summary is not None
    assert driver.drain_summary["fallback_failovers"] == 0
    assert metrics().counter(
        "fleet_serve_failover_requests_total").value() == failover_before
    finished = [fr for fr in router.requests if fr.finished]
    assert finished
    for fr in finished:
        np.testing.assert_array_equal(
            fr.output, _ref(lm, fr.prompt, fr.max_new_tokens))
    assert s["submitted"] == len(router.requests)
    states = [fr.state for fr in router.requests]
    assert s["finished"] + s["shed"] + sum(
        1 for st in states if st not in ("finished", "shed")) \
        == s["submitted"]
    assert s["expired_in_queue"] + s["expired_in_flight"] \
        <= s["shed"] + len(router.shed_log)


# ---------------------------------------------------------------------------
# the kernel build cache (no nvcc needed)
# ---------------------------------------------------------------------------
def test_compile_cache_points_the_kernel_build_at_the_directory(
        tmp_path, monkeypatch):
    d = str(tmp_path / "cache")
    default = _build.BUILD_DIR
    monkeypatch.setenv("DL4J_COMPILE_CACHE_DIR", d)
    cc_mod._reset_for_tests()
    try:
        assert compile_cache_dir() == d
        assert ensure_compile_cache() == d
        assert _build.BUILD_DIR == d and os.path.isdir(d)
        assert os.path.dirname(_build.library_path("flash_fwd")) == d
        assert ensure_compile_cache() == d          # idempotent
        (tmp_path / "cache" / "libx-abc.so").write_bytes(b"12345")
        assert compile_cache_stats() == {
            "dir": d, "configured": True, "entries": 1, "bytes": 5}
        # an engine configures it before its first kernel build
        cc_mod._reset_for_tests()
        assert _build.BUILD_DIR == default
        _server()
        assert _build.BUILD_DIR == d
    finally:
        cc_mod._reset_for_tests()
    assert _build.BUILD_DIR == default


def test_compile_cache_unset_is_a_noop(monkeypatch):
    monkeypatch.delenv("DL4J_COMPILE_CACHE_DIR", raising=False)
    cc_mod._reset_for_tests()
    assert ensure_compile_cache() is None
    assert compile_cache_stats() == {
        "dir": None, "configured": False, "entries": 0, "bytes": 0}
    assert _build.BUILD_DIR.endswith(os.path.join("kernels", "_build"))


def test_warm_cache_loads_a_library_without_nvcc(tmp_path):
    """A library already in the cache directory under its hashed name is
    loaded as is: ``build_all`` starts no compiler (here there is none)
    and records no build."""
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent("""
            import os
            from deeplearning4j_tpu_torch.kernels import _build
            from deeplearning4j_tpu_torch.serving import ensure_compile_cache
            ensure_compile_cache()
            path = _build.library_path("flash_fwd")
            open(path, "wb").close()
            assert _build.build_all(["flash_fwd"]) == {"flash_fwd": path}
            print(len(_build.LOGS), os.path.dirname(path))
        """)], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO, "PATH": "/usr/bin:/bin",
             "CUDA_HOME": str(tmp_path / "none"),
             "DL4J_COMPILE_CACHE_DIR": str(tmp_path / "cache")})
    assert out.returncode == 0, out.stderr
    builds, where = out.stdout.split()
    assert builds == "0" and where == str(tmp_path / "cache")
