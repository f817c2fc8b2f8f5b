"""``parallel/cluster.FaultTolerantTrainer`` in the port, as the
reference's ``tests/test_cluster.py`` and ``tests/test_self_healing.py``
exercise it: checkpoints written, pruned and published with sha256
manifests; a truncated or bit-flipped newest checkpoint falls back to
the one before it, a directory of bad ones only raises; ``save_async``
snapshots the state before the next chunk runs; an injected
``preempt.chunk`` stops ``fit_epochs`` at a chunk boundary, and a fresh
trainer's ``resume`` finishes the run with params bitwise those of an
uninterrupted run; ``fit`` skips the consumed batches of a mid-epoch
checkpoint; the tracker's pointer and ``resume(mesh=, fsdp=)`` on a
mesh of one device; and a checkpoint the JAX
trainer wrote resumes in the port with the same weights (float32,
bitwise: the zip carries them as they are) and cursors."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.iterator import \
    ListDataSetIterator as JaxList
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.parallel.cluster import \
    FaultTolerantTrainer as JaxTrainer
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.dtypes import tree_leaves
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.monitor import run_ledger, set_run_ledger
from deeplearning4j_tpu_torch.parallel import FaultTolerantTrainer
from deeplearning4j_tpu_torch.resilience import PreemptionGuard, faults


def _net(seed=3):
    return zoo.mnist_mlp(hidden=16, seed=seed, device="cpu").init()


def _data(n=96, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 784), np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    return x, y


def _it(batch=32):
    return ListDataSetIterator(DataSet(*_data()), batch)


def _bitwise(a, b):
    la, lb = (tree_leaves((n.params, n.updater_state)) for n in (a, b))
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.fixture(autouse=True)
def _clean():
    faults.clear()
    yield
    faults.clear()


def test_checkpoints_written_pruned_with_manifests(tmp_path):
    net = _net()
    ft = FaultTolerantTrainer(net, str(tmp_path), checkpoint_every=2,
                              keep=2)
    ds = DataSet(*_data(32))
    for _ in range(7):
        net.fit(ds)
        if net.iteration_count % ft.every == 0:
            ft.save()
    cks = ft.checkpoints()
    assert [os.path.basename(c) for c in cks] == [
        "ckpt-000000000004.zip", "ckpt-000000000006.zip"]
    for c in cks:
        with open(c + ".sha256") as f:
            m = json.load(f)
        assert m["size"] == os.path.getsize(c) and m["iteration"] in (4, 6)
        assert ft.verify_checkpoint(c) == "ok"
    assert not os.path.exists(os.path.join(
        str(tmp_path), "ckpt-000000000002.zip.sha256"))


@pytest.mark.parametrize("damage", ["truncate", "flip"])
def test_corrupt_newest_falls_back(tmp_path, damage):
    net = _net()
    ft = FaultTolerantTrainer(net, str(tmp_path))
    ds = DataSet(*_data(32))
    net.fit(ds)
    older = ft.save()
    net.fit(ds)
    newer = ft.save()
    data = open(newer, "rb").read()
    with open(newer, "wb") as f:
        f.write(data[: len(data) // 2] if damage == "truncate"
                else data[:100] + bytes([data[100] ^ 0xFF]) + data[101:])
    assert ft.verify_checkpoint(newer) == "corrupt"
    n2 = _net(seed=9)
    assert FaultTolerantTrainer(n2, str(tmp_path)).resume()
    assert n2.iteration_count == 1
    os.unlink(older)
    with pytest.raises(RuntimeError, match="corrupt or unloadable"):
        FaultTolerantTrainer(_net(), str(tmp_path)).resume()


def test_resume_without_checkpoint(tmp_path):
    assert FaultTolerantTrainer(_net(), str(tmp_path)).resume() is False


@pytest.mark.chaos
def test_preempted_then_resumed_equals_uninterrupted(tmp_path):
    base = _net()
    FaultTolerantTrainer(base, str(tmp_path / "base")).fit_epochs(_it(), 4)

    net = _net()
    ft = FaultTolerantTrainer(net, str(tmp_path / "ck"))
    faults.install("preempt.chunk", faults.fail_nth(2))
    ft.fit_epochs(_it(), 4)
    faults.clear()
    assert ft.preempted and net._epoch_cursor == 2

    fresh = _net(seed=11)  # another init: everything comes from the zip
    ft2 = FaultTolerantTrainer(fresh, str(tmp_path / "ck"))
    assert ft2.resume() and fresh.iteration_count == 6
    ft2.fit_epochs(_it(), 4)
    assert not ft2.preempted
    assert fresh.iteration_count == base.iteration_count == 12
    assert _bitwise(fresh, base)
    # nothing left: a rerun of the job is a no-op
    again = _net()
    ft3 = FaultTolerantTrainer(again, str(tmp_path / "ck"))
    assert ft3.resume() and ft3.fit_epochs(_it(), 4) is None


def test_ledger_books_checkpoint_and_recovery(tmp_path):
    set_run_ledger(None)
    try:
        net = _net()
        FaultTolerantTrainer(net, str(tmp_path)).fit_epochs(_it(), 2)
        FaultTolerantTrainer(_net(), str(tmp_path)).resume()
        rep = run_ledger().report()
        assert rep["runs"][-1]["status"] == "clean"
        assert rep["states"]["preemption_recovery"] > 0
        assert rep["states"]["checkpoint"] > 0
    finally:
        set_run_ledger(None)


def test_save_async_snapshots_before_the_next_chunk(tmp_path):
    net = _net()
    net.fit_epochs(_it(), 1)
    t = FaultTolerantTrainer(net, str(tmp_path))
    fut = t.save_async()
    net.fit_epochs(_it(), 1)
    path = fut.result(timeout=30)
    assert t.verify_checkpoint(path) == "ok"
    n2 = _net(seed=5)
    assert FaultTolerantTrainer(n2, str(tmp_path)).resume()
    assert n2.iteration_count == 3
    p = t.save()  # waits for the writer first
    assert t.verify_checkpoint(p) == "ok"
    assert t.wait_for_saves() is None


def test_training_state_round_trips(tmp_path):
    net = _net()
    net.fit_epochs(_it(), 2)
    net._epoch_cursor, net._lr_scale_host = 2, 0.25
    FaultTolerantTrainer(net, str(tmp_path)).save()
    n2 = _net(seed=8)
    assert FaultTolerantTrainer(n2, str(tmp_path)).resume()
    assert n2._epoch_cursor == 2 and n2._lr_scale_host == 0.25
    assert torch.equal(n2._rng.get_state(), net._rng.get_state())


@pytest.mark.chaos
def test_fit_preempts_mid_epoch_and_skips_consumed_batches(tmp_path):
    base = _net()
    for _ in range(2):
        base.fit(_it())
    net = _net()
    ft = FaultTolerantTrainer(net, str(tmp_path), checkpoint_every=100)
    guard = PreemptionGuard(signals=())
    faults.install("preempt.chunk", faults.fail_nth(2))
    ft.fit(_it(), num_epochs=2, preemption=guard)
    faults.clear()
    assert ft.preempted and net._step_cursor == 2
    n2 = _net(seed=4)
    ft2 = FaultTolerantTrainer(n2, str(tmp_path), checkpoint_every=100)
    assert ft2.resume()
    ft2.fit(_it(), num_epochs=1)  # finishes the interrupted epoch
    ft2.fit(_it(), num_epochs=1)
    assert n2.iteration_count == base.iteration_count == 6
    assert _bitwise(n2, base)


@pytest.mark.parametrize("call", ["tracker", "mesh", "fsdp"])
def test_cluster_parts_raise_naming_a14(tmp_path, call):
    """The A14.3 parts are ported: a tracker's ``latest_checkpoint``
    pointer is written and is a resume candidate; ``resume(mesh=)`` and
    ``resume(fsdp=True)`` over a mesh of one device restore the same
    state as ``resume()``."""
    from deeplearning4j_tpu_torch.parallel import InMemoryStateTracker

    class MeshOfOne:
        mesh_dim_names, shape = ("data",), (1,)

    net = _net()
    net.fit_epochs(_it(), 1)
    tracker = InMemoryStateTracker() if call == "tracker" else None
    path = FaultTolerantTrainer(net, str(tmp_path / "a"),
                                tracker=tracker).save()
    n2 = _net(seed=8)
    if call == "tracker":
        assert tracker.get_meta("latest_checkpoint") == path
        ft = FaultTolerantTrainer(n2, str(tmp_path / "empty"),
                                  tracker=tracker)
        assert ft._resume_candidates() == [path]
        assert ft.resume()
    elif call == "mesh":
        assert FaultTolerantTrainer(n2, str(tmp_path / "a")).resume(
            mesh=MeshOfOne())
    else:
        assert FaultTolerantTrainer(n2, str(tmp_path / "a")).resume(
            fsdp=True)
    assert _bitwise(n2, net)


def test_jax_written_checkpoint_resumes_in_port(tmp_path):
    ref = jax_zoo.mnist_mlp(hidden=16, seed=3).init()
    jt = JaxTrainer(ref, str(tmp_path))
    x, y = _data()
    jt.fit_epochs(JaxList(JaxDataSet(x, y), 32), 2)
    net = _net(seed=99)
    ft = FaultTolerantTrainer(net, str(tmp_path))
    assert ft.resume()
    assert net.iteration_count == ref.iteration_count == 6
    assert net._epoch_cursor == 2
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                            ref.params))
    got = [t.numpy() for t in jax.tree_util.tree_leaves(net.params)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # nothing left of the 2-epoch job; a longer one continues
    assert ft.fit_epochs(_it(), 2) is None
    ft.fit_epochs(_it(), 3)
    assert net.iteration_count == 9
