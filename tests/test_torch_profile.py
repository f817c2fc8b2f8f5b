"""``monitor/profile.py`` and ``monitor/memory.py`` in the port:
``classify_boundedness`` and ``flops_divergence_pct`` equal the
reference's on the same inputs; the flop counter's count for an MLP
training step equals the analytic GEMM count exactly; the flash kernels'
work reaches a profile through the wrappers' work sinks by their bounds'
formulas; ``DL4J_PROFILE`` profiles an epoch program once per signature
and samples a watermark per chunk without changing the params; the epoch
cache's priced bytes match the storage it holds; and the CPU's live
tensor walk sees a new allocation, measured as a difference after
``gc.collect()`` (the walk counts whatever else is alive)."""

import gc

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.monitor import profile as jprof
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.dtypes import tree_leaves
from deeplearning4j_tpu_torch.kernels import flash_attention as fa
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.monitor import memory, metrics
from deeplearning4j_tpu_torch.monitor import profile as prof


@pytest.mark.parametrize("args", [
    (1e12, 1e9, 2e-3, 989e12, 3.35e12),
    (1e9, 1e12, 1.0, 989e12, 3.35e12),
    (None, 1e9, 1e-3, 989e12, 3.35e12),
    (1e9, None, None, 67e12, 3.35e12),
    (0.0, 0.0, 0.0, 0.0, 0.0),
])
def test_classify_boundedness_equals_reference(args):
    assert prof.classify_boundedness(*args) == \
        jprof.classify_boundedness(*args)


@pytest.mark.parametrize("a,c", [(100.0, 102.0), (100.0, 90.0),
                                 (0.0, 1.0), (None, 1.0), (5.0, None)])
def test_flops_divergence_equals_reference(a, c):
    assert prof.flops_divergence_pct(a, c) == jprof.flops_divergence_pct(a, c)


def _mlp_data(b=16, seed=0):
    rng = np.random.default_rng(seed)
    return DataSet(rng.random((b, 784), np.float32),
                   np.eye(10, dtype=np.float32)[rng.integers(0, 10, b)])


def test_mlp_step_flops_equal_the_analytic_count():
    h, b = 32, 16
    net = zoo.mnist_mlp(hidden=h, device="cpu").init()
    ds = _mlp_data(b)
    store = prof.ProfileStore()
    p, _ = prof.capture_program_profile(lambda d: net.fit(d), (ds,),
                                        name="mlp.fit", store=store,
                                        replays=2, warmup=1)
    dims = [(784, h), (h, h), (h, 10)]
    fwd = sum(2 * b * i * o for i, o in dims)
    d_w = sum(2 * b * i * o for i, o in dims)
    d_x = sum(2 * b * i * o for i, o in dims[1:])  # no input gradient
    assert p.flops == fwd + d_w + d_x
    assert prof.flops_divergence_pct(fwd + d_w + d_x, p.flops) == 0.0
    assert p.bytes_accessed > 0 and p.measured_s > 0
    # the counted call, one warm-up and two timed calls
    assert net.iteration_count == 4
    assert store.find(name="mlp.fit") == [p]
    assert metrics().gauge("program_flops").value(
        program="mlp.fit", key="()") == p.flops


def test_flash_work_is_added_by_the_bounds_formulas():
    q = torch.zeros(2, 64, 4, 64)
    got = []
    fa.work_sinks.append(lambda *a: got.append(a))
    try:
        fa._note_work("fwd", q, q, True, None)
        fa._note_work("dkdv", q, q, True, None)
        fa._note_work("dq", q, q, True, None)
    finally:
        fa.work_sinks.clear()
    fwd = fa.flash_bound(2, 64, 64, 4, 64, torch.float32, causal=True)
    bwd = fa.flash_bwd_bound(2, 64, 64, 4, 64, torch.float32, causal=True)
    assert got == [("fwd", fwd["flops"], fwd["bytes"]),
                   ("dkdv", bwd["dkdv"]["flops"], bwd["dkdv"]["bytes"]),
                   ("dq", bwd["dq"]["flops"], bwd["dq"]["bytes"])]
    vis = fa.visible_keys(64, 64, causal=True)
    assert [g[1] for g in got] == [4 * 2 * 4 * 64 * vis,
                                   8 * 2 * 4 * 64 * vis,
                                   6 * 2 * 4 * 64 * vis]
    # nothing is computed without a sink
    fa._note_work("fwd", q, q, True, None)


def test_count_work_adds_kernel_flops():
    q = torch.ones(2, 8, 1, 64)

    def fake():
        fa._note_work("fwd", q, q, False, None)
        return q.reshape(16, 64) @ q.reshape(16, 64).T

    _, flops, _, kflops = prof.count_work(fake)
    want = fa.flash_bound(2, 8, 8, 1, 64, torch.float32,
                          causal=False)["flops"]
    assert kflops == {"fwd": want}
    assert flops == want + 2 * 16 * 64 * 16
    assert fa.work_sinks == []


@pytest.mark.parametrize("on", [False, True])
def test_profile_env_profiles_epoch_program_and_samples_watermarks(
        monkeypatch, on):
    if on:
        monkeypatch.setenv("DL4J_PROFILE", "on")
    else:
        monkeypatch.delenv("DL4J_PROFILE", raising=False)
    prof.profiles().reset()
    nets = []
    for _ in range(2):
        net = zoo.mnist_mlp(hidden=16, device="cpu").init()
        net.fit_epochs(ListDataSetIterator(_mlp_data(64), 16), 3,
                       chunk_epochs=1)
        nets.append(net)
    plain = zoo.mnist_mlp(hidden=16, device="cpu").init()
    monkeypatch.delenv("DL4J_PROFILE", raising=False)
    plain.fit_epochs(ListDataSetIterator(_mlp_data(64), 16), 3,
                     chunk_epochs=1)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(nets[0].params), tree_leaves(plain.params)))
    found = prof.profiles().find(name="MultiLayerNetwork.fit_epochs")
    if on:
        # one per network: each program profiles its first signature
        assert len(found) == 2 and found[0].flops > 0
        marks = nets[0]._hbm_watermarks
        assert len(marks) == 3 and all(
            m["devices"][0]["source"] in ("live_arrays", "memory_stats")
            for m in marks)
    else:
        assert found == [] and nets[0]._hbm_watermarks is None


def test_cache_budget_matches_held_storage():
    net = zoo.mnist_mlp(hidden=16, device="cpu").init()
    cache = net.build_epoch_cache(ListDataSetIterator(_mlp_data(100), 32))
    v = memory.validate_cache_budget(cache)
    assert v["within_tolerance"] and v["n_devices_holding"] == 1
    assert v["measured_per_device_bytes"] == sum(
        t.untyped_storage().nbytes() for t in tree_leaves(
            [x for x in cache.batch_stacks() if x is not None]))


def test_live_walk_sees_a_new_tensor_as_a_difference():
    gc.collect()
    before = memory.live_array_bytes().get("cpu", 0)
    keep = torch.ones(1 << 20, dtype=torch.float32)  # 4 MiB
    gc.collect()
    after = memory.live_array_bytes().get("cpu", 0)
    assert after - before >= keep.nbytes
    sample = memory.sample_hbm_watermark(tag="t", record=False)
    if not torch.cuda.is_available():
        assert sample["devices"][0]["source"] == "live_arrays"
    del keep


def test_eager_steps_is_scoped_to_the_calling_thread(monkeypatch):
    """Inside ``eager_steps`` a graphed step runs eagerly on this thread;
    outside it, and on another thread meanwhile, it takes its graph path
    (the warm-up, stubbed here: the CPU has no graphs)."""
    import threading

    from deeplearning4j_tpu_torch.perf import step_graph

    calls = []
    sg = step_graph.StepGraph(lambda: calls.append("eager"), "cpu")
    sg.graphed = True  # as on the card
    monkeypatch.setattr(sg, "_warm_up", lambda: calls.append("graph"))
    with step_graph.eager_steps():
        sg()
        other = threading.Thread(target=sg)
        other.start()
        other.join()
    sg()
    assert calls == ["eager", "graph", "graph"]
    assert sg.eager_calls == 1
