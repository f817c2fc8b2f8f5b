"""Port parity for the mesh, the spec registry, ``ParallelWrapper``
(replicated and FSDP), FSDP and ``ParameterAveragingTrainer`` against
``deeplearning4j_tpu.parallel``.

The JAX side runs on a 2- or 4-device slice of the 8 host devices
(``tests/conftest.py``); the port side runs gloo worlds of 2 and 4
spawned ranks (``tests/torch_worlds.py``), every rank given the same
global batches, one world per size for all the cases of this module,
each world with a hard timeout. Both sides start from the JAX
network's params, updater state and iteration
(``models/convert.load_network_from_jax``).

Gates: float32 rtol 1e-4 / atol 1e-6 on losses, params, updater state
and BatchNorm statistics after 3 steps (a float32 sum over ranks is not
the single-device sum bitwise); the mesh, specs and shard sizes exactly.
"""

import os

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.datasets.iterator import \
    ListDataSetIterator as JaxListIterator
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import graph as jax_G
from deeplearning4j_tpu.nn.conf import layers as jax_L
from deeplearning4j_tpu.nn.conf.enums import Updater as JaxUpdater
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxCG
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.ops.losses import LossFunction as JaxLoss
from deeplearning4j_tpu.parallel import (
    MeshSpec as JaxMeshSpec,
    ParallelWrapper as JaxWrapper,
    ParameterAveragingTrainer as JaxPAT,
    build_mesh as jax_build_mesh,
)
from deeplearning4j_tpu.parallel import fsdp as jax_fsdp
from deeplearning4j_tpu.resilience.guard import TrainingDivergedError
from deeplearning4j_tpu.parallel import sharding_registry as jax_reg
from deeplearning4j_tpu.parallel import tensor_parallel as jax_tp
from deeplearning4j_tpu.models.transformer import TransformerLM as JaxLM

import torch_worlds
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.dtypes import tree_leaves
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.models.convert import load_network_from_jax
from deeplearning4j_tpu_torch.models.transformer import TransformerLM
from deeplearning4j_tpu_torch.parallel import (
    FSDP,
    MeshSpec,
    ParallelWrapper,
    ParameterAveragingTrainer,
    build_mesh,
)
from deeplearning4j_tpu_torch.parallel import fsdp as port_fsdp
from deeplearning4j_tpu_torch.parallel import mesh as port_mesh
from deeplearning4j_tpu_torch.parallel import sharding_registry as reg
from deeplearning4j_tpu_torch.parallel import tensor_parallel as port_tp

SIZES = (2, 4)
STEPS = 3
TOL = dict(rtol=1e-4, atol=1e-6)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _conf(kind: str):
    """Small MLPs (Adam, L2 1e-3): plain, with a BatchNorm, or a
    char-LSTM under TBPTT."""
    if kind == "tbptt":
        return jax_zoo.char_lstm(vocab_size=6, hidden=8, layers=1,
                                 tbptt_length=3, seed=3).conf
    b = (JaxNNC.Builder().seed(7).learning_rate(1e-2)
         .updater(JaxUpdater.ADAM).regularization(True).l2(1e-3).list())
    b.layer(0, jax_L.DenseLayer(n_in=8, n_out=16, activation="relu"))
    i = 1
    if kind == "bn":
        b.layer(1, jax_L.BatchNormalization(n_in=16, n_out=16))
        i = 2
    b.layer(i, jax_L.DenseLayer(n_in=16, n_out=16, activation="tanh"))
    b.layer(i + 1, jax_L.OutputLayer(n_in=16, n_out=4,
                                     loss_function=JaxLoss.MCXENT))
    return b.build()


def _batches(kind: str, n: int, seed: int):
    """Three global batches of seeded numpy draws; ``masked`` gives the
    first shard all its labels and the others one each; ``ragged`` ends
    on a batch the data axis does not divide."""
    rng = np.random.default_rng(seed)
    out = []
    sizes = (16, 16, 4 * n + 1) if kind == "ragged" else (16,) * STEPS
    for rows in sizes:
        if kind == "tbptt":
            x = np.eye(6, dtype=np.float32)[rng.integers(0, 6, (4, 7))]
            y = np.eye(6, dtype=np.float32)[rng.integers(0, 6, (4, 7))]
            out.append((x, y, None, None))
            continue
        x = rng.normal(size=(rows, 8)).astype(np.float32)
        y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, rows)]
        lm = None
        if kind == "masked":
            per = rows // n
            lm = np.zeros(rows, np.float32)
            lm[:per] = 1.0
            lm[per::per] = 1.0
        out.append((x, y, None, lm))
    return out


def _case(kind: str, n: int):
    conf_kind = kind if kind in ("bn", "tbptt") else "mlp"
    ref = JaxMLN(_conf(conf_kind)).init()
    batches = _batches(kind, n, seed=n)
    state = (_np(ref.params), _np(ref.updater_state), _np(ref.net_state),
             ref.iteration_count)
    wrapper_kind = {"fsdp": "fsdp", "pat": "pat"}.get(kind, "wrapper")
    return ref, {"n": n, "kind": wrapper_kind, "conf": ref.conf.to_json(),
                 "state": state, "batches": batches, "frequency": 2}


KINDS = ("mlp", "fsdp", "masked", "bn", "ragged", "pat")
CASES = [(k, n) for n in SIZES for k in KINDS] + [("tbptt", 2)]


# ---------------------------------------------------------------------------
# the fused epoch over the mesh (ParallelWrapper.fit_epochs): the cases run
# in the same worlds as the per-batch ones
# ---------------------------------------------------------------------------
def _epoch_conf(kind: str):
    """The networks of ``tests/test_dp_epoch.py``: a tanh MLP (Adam), a
    GravesLSTM with a label mask (SGD) and a two-input graph (Adam)."""
    b = JaxNNC.Builder().seed(0).learning_rate(0.05).updater(
        JaxUpdater.ADAM)
    if kind == "rnn":
        return (JaxNNC.Builder().seed(0).learning_rate(0.02)
                .updater(JaxUpdater.SGD).list()
                .layer(0, jax_L.GravesLSTM(n_in=3, n_out=6,
                                           activation="tanh"))
                .layer(1, jax_L.RnnOutputLayer(
                    n_in=6, n_out=4, loss_function=JaxLoss.MCXENT))
                .build())
    if kind == "graph2":
        return (b.graph_builder().add_inputs("a", "b")
                .add_layer("da", jax_L.DenseLayer(n_in=6, n_out=8,
                                                  activation="tanh"), "a")
                .add_layer("db", jax_L.DenseLayer(n_in=4, n_out=8,
                                                  activation="tanh"), "b")
                .add_vertex("m", jax_G.MergeVertex(), "da", "db")
                .add_layer("out", jax_L.OutputLayer(n_in=16, n_out=3), "m")
                .set_outputs("out").build())
    return (b.list()
            .layer(0, jax_L.DenseLayer(n_in=6, n_out=12, activation="tanh"))
            .layer(1, jax_L.OutputLayer(n_in=12, n_out=3)).build())


def _epoch_arrays(kind: str, rows: int, seed: int, label_mask=False,
                  poison=None):
    rng = np.random.default_rng(seed)
    if kind == "rnn":
        x = rng.normal(size=(rows, 5, 3)).astype(np.float32)
        y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (rows, 5))]
        lm = (np.arange(5)[None, :]
              < rng.integers(3, 6, rows)[:, None]).astype(np.float32)
        return x, y, None, lm
    x = rng.normal(size=(rows, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, rows)]
    if poison is not None:  # one row of one batch non-finite
        x[poison] = np.nan
    lm = rng.integers(0, 2, rows).astype(np.float32) if label_mask else None
    return x, y, None, lm


#: key -> (world size, network, options); every case is checked against
#: the JAX wrapper's fit_epochs, the shuffled ones against the port's own
#: one-device fit_epochs on the same plan
EPOCH_CASES = {
    "epoch_mlp-2": (2, "mlp", {}), "epoch_mlp-4": (4, "mlp", {}),
    "epoch_mlp_fsdp-2": (2, "mlp", dict(fsdp=True)),
    "epoch_mlp_fsdp-4": (4, "mlp", dict(fsdp=True)),
    "epoch_rnn-4": (4, "rnn", {}),
    "epoch_rnn_fsdp-2": (2, "rnn", dict(fsdp=True)),
    "epoch_graph2-4": (4, "graph2", {}),
    "epoch_graph2_fsdp-2": (2, "graph2", dict(fsdp=True)),
    "epoch_accum-4": (4, "mlp", dict(rows=100, label_mask=True,
                               fit=dict(accum_steps=2))),
    "epoch_skip-2": (2, "mlp", dict(poison=40, fit=dict(guard="skip"))),
    "epoch_raise-2": (2, "mlp", dict(poison=40, fit=dict(guard="raise"))),
    "epoch_telemetry-4": (4, "mlp", dict(fit=dict(telemetry=1))),
    "epoch_net_mesh-4": (4, "mlp", dict(mode="net_mesh")),
    "epoch_fsdp_chunks-4": (4, "mlp", dict(fsdp=True, epochs=3,
                                     fit=dict(chunk_epochs=1))),
    "epoch_shuffle-4": (4, "mlp", dict(shuffle=True)),
    "epoch_shuffle_fsdp-2": (2, "mlp", dict(fsdp=True, shuffle=True)),
    "epoch_stream-2": (2, "mlp", dict(mode="stream",
                                      fit=dict(cache_mb=1e-4))),
}


def _epoch_case(key):
    n, kind, opt = EPOCH_CASES[key]
    conf = _epoch_conf(kind)
    ref = (JaxCG if kind == "graph2" else JaxMLN)(conf).init()
    state = (_np(ref.params), _np(ref.updater_state), _np(ref.net_state),
             ref.iteration_count)
    fit = dict(shuffle=opt.get("shuffle", False), **opt.get("fit", {}))
    case = {"n": n, "conf": conf.to_json(), "state": state,
            "graph": kind == "graph2", "fsdp": opt.get("fsdp", False),
            "mode": opt.get("mode", "wrapper"),
            "epochs": opt.get("epochs", 2), "fit": fit,
            "one_device": fit["shuffle"]}
    if kind == "graph2":
        rng = np.random.default_rng(n)
        a = rng.normal(size=(96, 6)).astype(np.float32)
        bb = rng.normal(size=(96, 4)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 96)]
        case["multi"] = [((a[i:i + 32], bb[i:i + 32]), (y[i:i + 32],))
                         for i in range(0, 96, 32)]
    else:
        case["arrays"] = _epoch_arrays(
            kind, opt.get("rows", 48 if kind == "rnn" else 96), seed=n,
            label_mask=opt.get("label_mask", False),
            poison=opt.get("poison"))
        case["batch"] = 16 if kind == "rnn" else 32
    return ref, case


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' results, and the JAX networks they started from."""
    refs, payload = {}, {}
    for kind, n in CASES:
        refs[(kind, n)], payload[f"{kind}-{n}"] = _case(kind, n)
    epoch = {}
    for key in EPOCH_CASES:
        refs[key], epoch[key] = _epoch_case(key)
    results = {}
    for n in SIZES:
        out = torch_worlds.run_world(
            n, ["dp_cases", "dp_epoch_cases"],
            {"dp": payload, "dp_epoch": epoch},
            str(tmp_path_factory.mktemp(f"dp{n}")))
        results.update(out["dp_cases"])
        results.update(out["dp_epoch_cases"])
    return refs, {**payload, **epoch}, results


def _jax_fit(ref, case, n):
    mesh = jax_build_mesh(JaxMeshSpec(data=n), devices=jax.devices()[:n])
    batches = [JaxDataSet(*b) for b in case["batches"]]
    if case["kind"] == "pat":
        JaxPAT(ref, num_replicas=n, averaging_frequency=2,
               mesh=mesh).fit(batches)
        return None
    w = JaxWrapper(ref, mesh=mesh, fsdp=case["kind"] == "fsdp")
    w.fit(batches)
    return w


@pytest.mark.parametrize("kind,n", CASES,
                         ids=[f"{k}-{n}" for k, n in CASES])
def test_three_steps_match_reference(worlds, kind, n):
    refs, payload, results = worlds
    ref, case = refs[(kind, n)], payload[f"{kind}-{n}"]
    got = results[f"{kind}-{n}"]
    w = _jax_fit(ref, case, n)
    for want_tree, got_tree in ((ref.params, got["params"]),
                                (ref.updater_state, got["updater"]),
                                (ref.net_state, got["net_state"])):
        want, have = _leaves(want_tree), _leaves(got_tree)
        assert len(want) == len(have)
        for a, b in zip(want, have):
            np.testing.assert_allclose(b, a, **TOL)
    assert got["iteration"] == ref.iteration_count
    if w is not None:
        x = case["batches"][0][0]
        np.testing.assert_allclose(got["output"], np.asarray(w.output(x)),
                                   **TOL)
        np.testing.assert_allclose(got["score"],
                                   float(w.score(JaxDataSet(
                                       *case["batches"][0]))), **TOL)


def test_fsdp_holds_one_shard_per_rank(worlds):
    """Each rank holds 1/N of every leaf FSDP can split; the rest (the
    4-wide output bias at n=4 splits, odd ones would not) replicate."""
    refs, payload, results = worlds
    for n in SIZES:
        shards = results[f"fsdp-{n}"]["shard_numel"]
        ref = refs[("fsdp", n)]
        mesh = jax_build_mesh(JaxMeshSpec(data=n), devices=jax.devices()[:n])
        want = 0
        for x in jax.tree_util.tree_leaves(ref.params):
            spec = jax_fsdp.fsdp_spec(x.shape, mesh)
            want += x.size // n if any(e is not None for e in spec) \
                else x.size
        assert shards == [want] * n
        total = sum(x.size for x in jax.tree_util.tree_leaves(ref.params))
        assert want < total
        # the replicated wrapper holds the whole tree in every rank
        assert results[f"mlp-{n}"]["shard_numel"] == [total] * n


def test_ragged_tail_is_one_unsharded_step(worlds):
    refs, payload, results = worlds
    for n in SIZES:
        got = results[f"ragged-{n}"]
        assert got["iteration"] == STEPS and got["dispatches"] == STEPS


def test_masked_shards_normalise_as_one_batch(worlds):
    """The shards hold different label-mask counts; averaging per-rank
    means would weigh the first shard's rows n/2 times less."""
    refs, payload, results = worlds
    lm = payload["masked-4"]["batches"][0][3]
    counts = lm.reshape(4, -1).sum(1)
    assert len(set(counts.tolist())) > 1
    # the gate itself is test_three_steps_match_reference[masked-*]


def _jax_epoch_data(case):
    if case.get("multi"):
        return [JaxMDS(list(f), list(l)) for f, l in case["multi"]]
    return JaxListIterator(JaxDataSet(*case["arrays"]), case["batch"])


def _jax_epochs(ref, case):
    """The JAX wrapper's fit_epochs on the case (shuffle off)."""
    n = case["n"]
    mesh = jax_build_mesh(JaxMeshSpec(data=n), devices=jax.devices()[:n])
    kw = {k: v for k, v in case["fit"].items() if k != "cache_mb"}
    if case["mode"] == "net_mesh":
        return ref.fit_epochs(_jax_epoch_data(case), case["epochs"],
                              mesh=mesh, **kw)
    w = JaxWrapper(ref, mesh=mesh, fsdp=case["fsdp"])
    return w.fit_epochs(_jax_epoch_data(case), case["epochs"], **kw)


def _assert_tree_close(got_tree, want_tree, **tol):
    want, have = _leaves(want_tree), _leaves(got_tree)
    assert len(want) == len(have)
    for a, b in zip(want, have):
        np.testing.assert_allclose(b, a, **tol)


UNSHUFFLED = [k for k, (_, _, o) in EPOCH_CASES.items()
              if not o.get("shuffle") and o.get("mode") != "stream"
              and o.get("fit", {}).get("guard") != "raise"]


@pytest.mark.parametrize("key", UNSHUFFLED)
def test_mesh_fit_epochs_matches_reference(worlds, key):
    """The ``[E, N]`` history and the params of the port's fused epoch
    over ``data`` against the JAX wrapper's fused program on
    ``jax.devices()[:n]`` (shuffle off), float32 rtol 1e-4 / atol 1e-6;
    the sentinel and the telemetry pack too where they are on."""
    refs, payload, results = worlds
    ref, case, got = refs[key], payload[key], results[key]
    want = np.asarray(_jax_epochs(ref, case))
    assert got["hist"].shape == want.shape
    np.testing.assert_allclose(got["hist"], want, **TOL)
    _assert_tree_close(got["params"], ref.params, **TOL)
    _assert_tree_close(got["updater"], ref.updater_state, **TOL)
    assert got["iteration"] == ref.iteration_count
    if case["fit"].get("guard") == "skip":
        trips = np.asarray(ref._last_sentinel)
        assert trips.any()
        np.testing.assert_array_equal(got["sentinel"], trips)
    if case["fit"].get("telemetry"):
        np.testing.assert_allclose(got["metrics"],
                                   np.asarray(ref._last_metrics), **TOL)


def test_mesh_guard_raise_names_the_batch_as_the_reference(worlds):
    """``guard="raise"`` over ``data=2``: every rank stops at the chunk
    whose sentinel tripped, replays it from rank 0's generator and names
    the epoch, the step and the dataset batch the JAX wrapper names."""
    refs, payload, results = worlds
    ref, case = refs["epoch_raise-2"], payload["epoch_raise-2"]
    with pytest.raises(TrainingDivergedError) as want:
        _jax_epochs(ref, case)
    got = results["epoch_raise-2"]["diverged"]
    e = want.value
    assert got == (e.epoch, e.step, e.batch_index, e.n_trips)
    assert got[2] == 1  # row 40 lies in the second batch of 32


@pytest.mark.parametrize("key", ["epoch_shuffle-4", "epoch_shuffle_fsdp-2"])
def test_shuffled_mesh_epochs_match_one_device(worlds, key):
    """Shuffled, every rank trains on rank 0's plan (the network's own
    stream), so the run is the port's one-device fit_epochs on the same
    orders: rtol 1e-5 / atol 1e-6."""
    _, _, results = worlds
    got = results[key]
    plans = got["plans"]
    assert all(p == plans[0] for p in plans) and len(plans[0]) == 2
    assert sorted(plans[0][0]) == [0, 1, 2]
    np.testing.assert_allclose(got["hist"], got["one_hist"], rtol=1e-5,
                               atol=1e-6)
    _assert_tree_close(got["params"], got["one_params"], rtol=1e-5,
                       atol=1e-6)


def test_fsdp_state_stays_sharded_across_chunks(worlds):
    refs, payload, results = worlds
    got = results["epoch_fsdp_chunks-4"]
    total = sum(x.size for x in _leaves(got["params"]))
    assert got["local_numel"] < total
    assert got["hist"].shape == (3, 3)


def test_over_budget_mesh_epochs_stream_through_the_wrapper(worlds):
    """Over the per-rank budget the run streams each epoch through the
    wrapper's sharded fit: bitwise the wrapper's fit run each epoch."""
    _, _, results = worlds
    got = results["epoch_stream-2"]
    assert got["hist"] is None
    for a, b in zip(_leaves(got["params"]), _leaves(got["fit_params"])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_leaves(got["updater"]), _leaves(got["fit_updater"])):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# in this process: the mesh of one, specs, FSDP and one-card averaging
# ---------------------------------------------------------------------------
@pytest.fixture
def world_of_one(tmp_path):
    port_mesh.join_world(str(tmp_path / "store"), 0, 1, backend="gloo",
                         timeout_s=60)
    try:
        yield
    finally:
        port_mesh.leave_world()


@pytest.mark.parametrize("spec,n", [
    (dict(), 8), (dict(data=2, model=4), 8), (dict(data=1, sequence=8), 8),
    (dict(data=-1, sequence=2), 4), (dict(model=2, pipe=2, expert=2), 8)])
def test_mesh_spec_resolves_as_reference(spec, n):
    assert MeshSpec(**spec).resolve(n) == JaxMeshSpec(**spec).resolve(n)


def test_mesh_spec_errors_as_reference():
    for spec, n in ((dict(model=3), 8), (dict(data=3, model=2), 8)):
        with pytest.raises(ValueError) as want:
            JaxMeshSpec(**spec).resolve(n)
        with pytest.raises(ValueError) as got:
            MeshSpec(**spec).resolve(n)
        assert str(got.value) == str(want.value)


def test_mesh_of_one_device(world_of_one):
    mesh = build_mesh(device="cpu")
    assert port_mesh.mesh_shape(mesh) == {"data": 1}
    assert port_mesh.data_axis_size(mesh) == 1
    assert port_mesh.axis_group(mesh, "data") is None
    assert port_mesh.axis_size(mesh, "sequence") == 1
    from torch.distributed.tensor import Replicate, Shard

    assert port_mesh.replicated(mesh) == (Replicate(),)
    assert port_mesh.batch_sharding(mesh, 3) == (Shard(0),)
    x = torch.arange(6.0).reshape(3, 2)
    assert port_mesh.shard_leading_axis({"x": x}, mesh, "data")["x"] is x


def test_build_mesh_joins_a_world_of_one_and_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_mesh()
    try:
        assert port_mesh.mesh_shape(build_mesh(device="cpu")) == {"data": 1}
    finally:
        port_mesh.leave_world()


@pytest.mark.parametrize("text", ["8x1", "4x2", "2x2x2", "8", " 2 x 4 "])
def test_parse_mesh_shape_as_reference(text):
    assert reg.parse_mesh_shape(text) == MeshSpec(
        **vars(jax_reg.parse_mesh_shape(text)))


@pytest.mark.parametrize("text", ["2x2x2x2", "axb", "0x8", ""])
def test_parse_mesh_shape_errors_as_reference(text):
    with pytest.raises(ValueError) as want:
        jax_reg.parse_mesh_shape(text)
    with pytest.raises(ValueError) as got:
        reg.parse_mesh_shape(text)
    assert str(got.value) == str(want.value)


def test_mesh_from_env(world_of_one, monkeypatch):
    monkeypatch.delenv("DL4J_MESH_SHAPE", raising=False)
    monkeypatch.delenv("DL4J_TP_SHARDS", raising=False)
    assert reg.mesh_from_env(device="cpu") is None
    monkeypatch.setenv("DL4J_MESH_SHAPE", "1x1")
    assert port_mesh.mesh_shape(reg.mesh_from_env(device="cpu")) == \
        {"data": 1}
    monkeypatch.delenv("DL4J_MESH_SHAPE")
    monkeypatch.setenv("DL4J_TP_SHARDS", "1")
    assert port_mesh.mesh_shape(reg.mesh_from_env(device="cpu")) == \
        {"data": 1}
    monkeypatch.setenv("DL4J_TP_SHARDS", "0")
    with pytest.raises(ValueError, match="DL4J_TP_SHARDS"):
        reg.mesh_from_env(device="cpu")


def test_env_mesh_is_one_mesh_a_world(world_of_one, monkeypatch):
    """The reference's ``DL4J_TP_SHARDS`` fleet: ``FleetRouter.build``
    resolves the environment once and builds every server over that
    mesh, so the replicas share one placement of the model (a mesh a
    server raised "placed on another mesh")."""
    from deeplearning4j_tpu_torch.serving.fleet import FleetRouter

    monkeypatch.delenv("DL4J_MESH_SHAPE", raising=False)
    monkeypatch.setenv("DL4J_TP_SHARDS", "1")
    lm = TransformerLM(vocab_size=32, d_model=16, num_heads=2,
                       num_layers=1, max_len=16, device="cpu").init()
    router = FleetRouter.build(lm, replicas=2, device="cpu", slots=2,
                               max_len=16)
    meshes = {id(r.server.engine.mesh) for r in router.replicas}
    assert len(meshes) == 1 and router.replicas[0].server.engine.mesh \
        is not None
    fr = router.submit(np.arange(1, 5, dtype=np.int32), 3)
    while router.unfinished():
        for r in router.replicas:
            r.step_once()
    np.testing.assert_array_equal(
        fr.output, lm.generate(fr.prompt[None], 3)[0].numpy())


def _spec_tuples(tree):
    """Spec trees as nested dicts/lists of plain tuples (either package)."""
    if isinstance(tree, dict):
        return {k: _spec_tuples(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_spec_tuples(v) for v in tree]
    if type(tree).__name__ == "_ReplicateAll":
        return "replicate-all"
    return tuple(tree)


@pytest.mark.parametrize("name", ["mnist_mlp", "lenet5", "char_lstm"])
def test_network_specs_as_reference(name):
    kw = {"hidden": 32} if name == "mnist_mlp" else {}
    if name == "char_lstm":
        kw = dict(vocab_size=6, hidden=8)
    want = jax_tp.param_specs_for_network(getattr(jax_zoo, name)(**kw).conf)
    got = port_tp.param_specs_for_network(
        getattr(zoo, name)(device="cpu", **kw).conf)
    assert _spec_tuples(got) == _spec_tuples(want)


@pytest.mark.parametrize("kw", [
    dict(), dict(shard_data_embed=True), dict(model_axis_size=2),
    dict(num_kv_heads=2, model_axis_size=2),
    dict(num_kv_heads=1, model_axis_size=2),
    dict(pos_encoding="rope", model_axis_size=4)])
def test_transformer_param_specs_as_reference(kw):
    cfg = dict(vocab_size=32, d_model=32, num_heads=4, num_layers=2,
               max_len=16)
    model_kw = {k: kw[k] for k in ("num_kv_heads", "pos_encoding")
                if k in kw}
    spec_kw = {k: kw[k] for k in ("shard_data_embed", "model_axis_size")
               if k in kw}
    want = JaxLM(**cfg, **model_kw).param_specs(**spec_kw)
    got = TransformerLM(**cfg, **model_kw, device="cpu").param_specs(
        **spec_kw)
    assert _spec_tuples(got) == _spec_tuples(want)


def test_gqa_specs_need_the_model_axis():
    lm = TransformerLM(vocab_size=32, d_model=32, num_heads=4,
                       num_kv_heads=2, device="cpu")
    with pytest.raises(ValueError, match="model_axis_size"):
        lm.param_specs()


def test_registry_for_network_and_transformer(world_of_one):
    mesh = build_mesh(device="cpu")
    net = zoo.mnist_mlp(hidden=32, device="cpu").init()
    r = reg.ShardingRegistry.for_network(net, mesh)
    assert r.spec_for("0", "W") == reg.P()
    assert len(r.leaf_specs(net.params)) == 6
    assert r.declared_axes == {"data"}
    assert r.describe() == {"model": "MultiLayerNetwork",
                            "mesh": {"data": 1},
                            "declared_axes": ["data"], "leaves": 6,
                            "sharded_leaves": 0}
    fsdp = r.with_fsdp(net.params)
    assert fsdp.spec_for("0", "W") == reg.P("data", None)
    assert fsdp.describe()["sharded_leaves"] == 6
    placed = r.place(net.params)
    assert placed["0"]["W"] is net.params["0"]["W"]
    lm = TransformerLM(vocab_size=32, d_model=32, num_heads=4,
                       num_layers=2, max_len=16, device="cpu").init()
    lr = reg.ShardingRegistry.for_transformer(lm, mesh)
    assert lr.spec_for("blocks", 1, "attn", "wq") == reg.P()
    with pytest.raises(reg.UnmappedLeafError):
        lr.spec_for("blocks", 2)
    with pytest.raises(reg.UnmappedLeafError):
        lr.spec_for("blocks", 1, "attn")


def test_unmapped_leaf_raises():
    net = zoo.mnist_mlp(hidden=32, device="cpu").init()
    specs = port_tp.param_specs_for_network(net.conf)
    del specs["1"]["b"]
    with pytest.raises(reg.UnmappedLeafError, match=r"\('1', 'b'\)"):
        reg._expand(net.params, specs, (), "MultiLayerNetwork")
    with pytest.raises(reg.UnmappedLeafError, match="expected "
                       "PartitionSpec"):
        reg._expand({"w": torch.zeros(2)}, {"w": "data"}, (), "m")


def test_later_items_raise_naming_them(world_of_one, tmp_path):
    import deeplearning4j_tpu_torch.parallel as par

    mesh = build_mesh(device="cpu")
    net = zoo.mnist_mlp(hidden=8, device="cpu").init()
    r = reg.ShardingRegistry.for_network(net, mesh)
    # the model axis's items (A14.2) are ported: over a mesh of one they
    # place nothing and replicate
    assert r.kv_pool_spec(2) == reg.P() and r.kv_scale_spec(2) == reg.P()
    tables = reg.ShardingRegistry.for_embedding_tables(
        {"syn0": torch.zeros(4, 2)}, mesh, row_shard=True)
    assert tables.spec_for("syn0") == reg.P()
    before = [x.clone() for x in tree_leaves(net.params)]
    port_tp.shard_network_params(net, mesh)
    assert all(torch.equal(a, b)
               for a, b in zip(before, tree_leaves(net.params)))
    lm = TransformerLM(vocab_size=8, d_model=8, num_heads=1,
                       device="cpu").shard_params(mesh)
    assert lm._tp is None and lm.make_train_step(mesh=mesh).captured
    from deeplearning4j_tpu_torch.parallel import (
        expert_parallel, pipeline_parallel)

    assert par.moe_ffn is expert_parallel.moe_ffn
    assert par.spmd_pipeline is pipeline_parallel.spmd_pipeline
    # the A14.3 items are ported: over a mesh of one the wrapper's fused
    # epoch is the network's own, a reshard to None places nothing, the
    # epoch layouts are replicated and the cluster names are real
    w = ParallelWrapper(net, mesh=mesh)
    assert w.build_epoch_cache([]) is None
    assert w.fit_epochs([], 1) is None
    w.request_reshard(None)
    assert net._pending_mesh == (None,)
    outs = r.epoch_out_shardings(net.params, net.updater_state, guard=True,
                                 metrics_stride=1)
    assert len(outs) == 6
    assert all(sh.is_replicated for sh in reg.tree_leaves_of(outs[0]))
    assert par.ClusterConfig().num_processes == 1
    assert par.InMemoryStateTracker().jobs() == []
    reg_dir = str(tmp_path / "registry")
    par.ConfigRegistry(reg_dir).register("h", "t", {"mesh": "data=1"})
    assert par.ConfigRegistry(reg_dir).retrieve("h", "t") == {"mesh": "data=1"}


@pytest.mark.parametrize("shape", [(784, 256), (256,), (10,), (3, 5),
                                   (), (4, 8, 2)])
def test_fsdp_spec_as_reference(shape):
    class FakeMesh:
        mesh_dim_names = ("data",)
        shape = (4,)

    jmesh = jax_build_mesh(JaxMeshSpec(data=4), devices=jax.devices()[:4])
    assert tuple(port_fsdp.fsdp_spec(shape, FakeMesh())) == tuple(
        jax_fsdp.fsdp_spec(shape, jmesh))


def test_fsdp_wrapper_donation_check(world_of_one):
    mesh = build_mesh(device="cpu")
    lm = TransformerLM(vocab_size=16, d_model=32, num_heads=2,
                       num_layers=1, max_len=16, device="cpu").init()
    trainer = FSDP(mesh, lm.params, lm.opt_state)
    params, opt = trainer.params, trainer.opt_state
    step = trainer.jit_step(lm._step_body(mesh=mesh))
    tok = np.random.default_rng(0).integers(0, 16, (2, 16))
    params, opt, loss = step(params, opt, lm._tokens(tok), 0)
    assert torch.isfinite(loss)
    with pytest.raises(RuntimeError, match="donated"):
        trainer.params


def test_parallel_wrapper_on_one_device_is_fit_bitwise(world_of_one):
    """A data axis of 1 runs the network's own step."""
    mesh = build_mesh(device="cpu")
    ref = JaxMLN(_conf("bn")).init()
    state = (_np(ref.params), _np(ref.updater_state), _np(ref.net_state),
             ref.iteration_count)
    for fsdp in (False, True):
        nets = []
        for _ in range(2):
            from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
            from deeplearning4j_tpu_torch.nn.conf.neural_net import (
                MultiLayerConfiguration)

            net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
                ref.conf.to_json()), device="cpu").init()
            nets.append(load_network_from_jax(net, *state))
        batches = [DataSet(*b) for b in _batches("mlp", 1, seed=5)]
        ParallelWrapper(nets[0], mesh=mesh, fsdp=fsdp).fit(batches)
        nets[1].fit(batches)
        for a, b in zip(*(tree_leaves(
                (n.params, n.updater_state, n.net_state)) for n in nets)):
            assert torch.equal(a, b)


def test_parameter_averaging_on_one_card_needs_no_group():
    """Four replicas stacked on the one device, averaged every 2 steps,
    against the JAX trainer over 4 devices."""
    ref = JaxMLN(_conf("mlp")).init()
    state = (_np(ref.params), _np(ref.updater_state), _np(ref.net_state),
             ref.iteration_count)
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf.neural_net import (
        MultiLayerConfiguration)

    net = load_network_from_jax(MultiLayerNetwork(
        MultiLayerConfiguration.from_json(ref.conf.to_json()),
        device="cpu").init(), *state)
    batches = _batches("mlp", 4, seed=9)
    trainer = ParameterAveragingTrainer(net, num_replicas=4,
                                        averaging_frequency=2)
    assert trainer._group is None
    trainer.fit([DataSet(*b) for b in batches])
    mesh = jax_build_mesh(JaxMeshSpec(data=4), devices=jax.devices()[:4])
    JaxPAT(ref, num_replicas=4, averaging_frequency=2, mesh=mesh).fit(
        [JaxDataSet(*b) for b in batches])
    for a, b in zip(_leaves(ref.params), _leaves(
            jax.tree_util.tree_map(lambda t: t.numpy(), net.params))):
        np.testing.assert_allclose(b, a, **TOL)
    for a, b in zip(_leaves(ref.updater_state), _leaves(
            jax.tree_util.tree_map(lambda t: t.numpy(),
                                   net.updater_state))):
        np.testing.assert_allclose(b, a, **TOL)
