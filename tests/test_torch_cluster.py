"""Port parity for the cluster layer (ROADMAP A14.3) against
``deeplearning4j_tpu``: the state tracker, heartbeats, the multi-host
runtime's init, the work router, the elastic reshard of the fused epoch,
``FaultTolerantTrainer`` resuming over a mesh, ``DistributedWord2Vec``
and the CLI's ``-runtime mesh|multihost``.

The in-process cases are those of ``tests/test_cluster.py`` and
``tests/test_workrouter.py`` on the port's modules, on both trackers. The
mesh cases run in ONE spawned gloo world of 4 ranks
(``tests/torch_worlds.py``: ``elastic_case``, ``resume_cases``,
``w2v_cases``) from the JAX network's weights and numpy data; the JAX side
and the one-device runs are in this process.

Gates: the elastic run against the uninterrupted one at rtol 2e-4 /
atol 1e-5 (the reference's ``tests/test_parallel.py`` gate: the
all-reduce sums in another order at each width); a resume in the same
layout bitwise; the work router's average against the JAX router's at
rtol 1e-5 / atol 1e-6. ``DistributedWord2Vec`` is held within 1e-6 of
the JAX fused program fed the same plans, and of the port's one-device
fused run on them (the mesh modes apply the one-device scatter-adds in
the one-device order, so on the CPU they are its bytes).
"""

import os
import socket
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.iterator import (
    ListDataSetIterator as JaxListDataSetIterator)
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import layers as jax_L
from deeplearning4j_tpu.nn.conf.enums import (
    GradientNormalization as JaxGradientNormalization,
    Updater as JaxUpdater,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.parallel import (
    DistributedTrainer as JaxDistributedTrainer,
    FileStateTracker as JaxFileStateTracker,
    InMemoryStateTracker as JaxInMemoryStateTracker,
    IterativeReduceWorkRouter as JaxIterativeReduce,
    NetworkWorkPerformer as JaxNetworkPerformer,
)

import torch_worlds
from test_torch_data_parallel import _epoch_case, _jax_epoch_data
from test_torch_word2vec import _jax_plans, _pair, _sentences
from deeplearning4j_tpu_torch.cli import main
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.models.convert import load_network_from_jax
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.parallel import (
    ClusterConfig,
    DistributedTrainer,
    FaultTolerantTrainer,
    FileStateTracker,
    HeartbeatMonitor,
    HogwildWorkRouter,
    InMemoryStateTracker,
    IterativeReduceWorkRouter,
    NetworkWorkPerformer,
    WorkerPerformer,
    average_aggregator,
    initialize_distributed,
)
from deeplearning4j_tpu_torch.parallel import cluster as port_cluster
from deeplearning4j_tpu_torch.perf.epoch_cache import chunk_deadline_s
from deeplearning4j_tpu_torch.resilience import (
    RetryPolicy,
    fail_times,
    faults,
    inject,
)
from deeplearning4j_tpu_torch.utils import ModelSerializer

ELASTIC_TOL = dict(rtol=2e-4, atol=1e-5)
ROUTER_TOL = dict(rtol=1e-5, atol=1e-6)
W2V_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


# ---------------------------------------------------------------------------
# the 4-rank world: elastic reshard, resume over a mesh, word2vec
# ---------------------------------------------------------------------------
def _mlp_conf():
    return (JaxNNC.Builder().seed(0).learning_rate(0.05)
            .updater(JaxUpdater.ADAM).list()
            .layer(0, jax_L.DenseLayer(n_in=6, n_out=12, activation="tanh"))
            .layer(1, jax_L.OutputLayer(n_in=12, n_out=3)).build())


def _mlp_case():
    ref = JaxMLN(_mlp_conf()).init()
    rng = np.random.default_rng(11)
    x = rng.normal(size=(128, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 128)]
    state = jax.tree_util.tree_map(
        np.asarray, (ref.params, ref.updater_state, ref.net_state))
    return {"conf": ref.conf.to_json(), "state": (*state,
                                                  ref.iteration_count),
            "arrays": (x, y, None, None), "batch": 32}


def _pair_conf():
    """A dense pair and an output layer on SGD under per-layer L2
    clipping (a threshold below every layer's first gradient norms):
    over ``data=2 × model=2`` with FSDP the pair splits over ``model``,
    the row layer's bias and the output layer's weight over ``data``."""
    return (JaxNNC.Builder().seed(1).learning_rate(0.1)
            .updater(JaxUpdater.SGD)
            .gradient_normalization(JaxGradientNormalization.CLIP_L2_PER_LAYER)
            .gradient_normalization_threshold(0.1).list()
            .layer(0, jax_L.DenseLayer(n_in=6, n_out=12, activation="tanh"))
            .layer(1, jax_L.DenseLayer(n_in=12, n_out=8, activation="relu"))
            .layer(2, jax_L.OutputLayer(n_in=8, n_out=3)).build())


def _fsdp_model_case(root):
    ref = JaxMLN(_pair_conf()).init()
    rng = np.random.default_rng(12)
    x = rng.normal(size=(128, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 128)]
    state = jax.tree_util.tree_map(
        np.asarray, (ref.params, ref.updater_state, ref.net_state))
    return {"conf": ref.conf.to_json(),
            "state": (*state, ref.iteration_count),
            "arrays": (x, y, None, None), "batch": 32, "epochs": 2,
            "batches": [(x[i:i + 32], y[i:i + 32], None, None)
                        for i in range(0, 96, 32)],
            "dir": os.path.join(root, "fsdp_model_ckpt")}


def _port_net(case):
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(case["conf"]),
                            device="cpu").init()
    return load_network_from_jax(net, *case["state"])


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _close(got_tree, want_tree, **tol):
    got, want = _leaves(got_tree), _leaves(want_tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **tol)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cluster"))
    sents = _sentences()
    ref, port = _pair(sents, epochs=2)
    cache = ref.build_corpus_cache()
    plans = _jax_plans(ref, cache, 0, 2)
    w2v = {"sents": sents, "kw": dict(min_word_frequency=1, layer_size=16,
                                      window_size=3, negative=5, seed=0,
                                      epochs=2),
           "vocab": port.vocab, "table": port._table,
           "syn0": port.syn0.numpy().copy(),
           "syn1neg": port.syn1neg.numpy().copy(), "plans": plans}
    payload = {"elastic": _mlp_case(),
               "resume": {**_mlp_case(), "dir": root}, "w2v": w2v,
               "fsdp_model": _fsdp_model_case(root),
               "graph": _epoch_case("epoch_graph2-4")[1]}
    out = torch_worlds.run_world(
        4, ["elastic_case", "width_cases", "resume_cases", "w2v_cases",
            "contract_cases", "fsdp_model_cases"],
        payload,
        os.path.join(root, "world"))
    return payload, out, (ref, port, plans)


def test_elastic_reshard_matches_the_uninterrupted_run(world):
    """``data=4 → None → data=2 × model=2 → data=4`` between chunks
    against the uninterrupted ``data=4`` run: the same plans, the history
    and the params within the elastic gate, three reshards counted."""
    _, out, _ = world
    got = out["elastic_case"]
    np.testing.assert_allclose(got["hist"], got["base_hist"], **ELASTIC_TOL)
    _close(got["params"], got["base_params"], **ELASTIC_TOL)
    assert got["reshards"] == 3
    plans = got["plans"]
    assert all(p == plans[0] for p in plans) and len(plans[0]) == 4
    # seen at each boundary: (this rank's W, mesh None, data axis size)
    assert [v[:3] for v in got["seen"].values()] == [
        ((6, 12), False, 4), ((6, 12), True, 1),
        ((6, 6), False, 2),  # W column-split
        ((6, 12), False, 4)]


def test_watchdog_deadline_rescaled_after_reshard(world):
    """The chunk deadline follows the width, as the reference's driver
    rescales it: 4x the first chunk's after ``data=4 → None``, 2x over
    ``data=2 × model=2``, back to 1x after ``→ data=4`` (a chunk over
    fewer shards is slower, not stalled)."""
    _, out, _ = world
    seen = out["elastic_case"]["seen"]
    first = seen[1][3]
    assert [seen[d][3] / first for d in (1, 2, 3, 4)] == [1.0, 4.0, 2.0,
                                                           1.0]


# ---------------------------------------------------------------------------
# a run that changes width in-process: meshes over some of the world's
# ranks, the parked ranks, the autopilot's reshard to the healthy ranks
# ---------------------------------------------------------------------------
# the lead at the end of each width case, the ranks parked there, the
# reshards it makes and the width factor of its deadline at each boundary
# (batch 32 tiles data=2 and data=4, not data=3)
WIDTH_ENDS = {"a": (0, [], 2, [1, 2, 1, 1]),
              "b": (1, [0], 1, [1, 4, 4, 4]),
              "c": (0, [], 3, [1, 1, 1, 1]),  # growth never tightens it
              "d": (0, [2, 3], 1, [1, 2, 2, 2]),
              "e": (0, [], 2, [1, 4, 1, 1]),
              "g": (0, [], 3, [1, 4, 2, 1]),
              "m": (0, [], 2, [1, 4, 4, 1])}


@pytest.fixture(scope="module")
def jax_width_ref(world):
    """The JAX networks' one-device ``fit_epochs(shuffle=False)`` on the
    width cases' weights and data: the MLP's, and the two-input graph's
    of case (g)."""
    payload, _, _ = world
    case = payload["elastic"]
    x, y = case["arrays"][:2]
    ref = JaxMLN(_mlp_conf()).init()
    hist = ref.fit_epochs(JaxListDataSetIterator(JaxDataSet(x, y),
                                                 case["batch"]),
                          torch_worlds.WIDTH_EPOCHS, shuffle=False)
    graph, case = _epoch_case("epoch_graph2-4")
    graph_hist = graph.fit_epochs(_jax_epoch_data(case),
                                  torch_worlds.WIDTH_EPOCHS, shuffle=False)
    return {"elastic": (np.asarray(hist), ref.params),
            "graph": (np.asarray(graph_hist), graph.params)}


@pytest.mark.parametrize("name", sorted(WIDTH_ENDS))
def test_a_run_changes_width_in_process(world, jax_width_ref, name):
    """(a) ``data=4 → ranks [0,1] → data=4``; (b) ``data=4 → ranks
    [1,2,3]`` (rank 0 parked, the lead moved, the batch whole over
    ``data=3``); (c) ``net.fit_epochs`` without a mesh in every rank
    ``→ data=4 → ranks [2,3] → None``; (d) FSDP onto ranks [0,1]; (e)
    the autopilot's shrink and readmit; (g) a two-input
    ``ComputationGraph`` over ``data=4 → ranks [1,2,3] → ranks [0,1] →
    data=4``; (m) ``data=4 → ranks [0,1] as model=2`` (the dense layer
    column-split over the two) ``→ data=4``. Shuffled, the port's uninterrupted ``data=4`` run; in the
    data's order, the JAX network's one-device ``fit_epochs`` and the
    port's uninterrupted run, all within the elastic gate."""
    _, out, _ = world
    got = out["width_cases"]
    key = "graph" if name == "g" else "elastic"
    jax_hist, jax_params = jax_width_ref[key]
    for shuffle in (True, False):
        run, base = got[(name, shuffle)], got[(f"base_{key}", shuffle)]
        np.testing.assert_allclose(run["hist"], base["hist"], **ELASTIC_TOL)
        _close(run["params"], base["params"], **ELASTIC_TOL)
        assert run["reshards"] == WIDTH_ENDS[name][2]
    ordered = got[(name, False)]
    np.testing.assert_allclose(ordered["hist"], jax_hist, **ELASTIC_TOL)
    _close(ordered["params"], jax_params, **ELASTIC_TOL)
    if name == "m":  # rank 0's W over model=2, after the split's chunks
        assert [ordered["shapes"][d]["0/W"] for d in (1, 2, 3, 4)] == [
            (6, 12), (6, 6), (6, 6), (6, 12)]


@pytest.mark.parametrize("name", sorted(WIDTH_ENDS))
def test_parked_ranks_return_the_leads_history_and_state(world, name):
    """Every rank returns the lead's ``[E, N]`` history bitwise and ends
    at its iteration; a rank parked at the end holds the lead's whole
    params bitwise; the watchdog's deadline follows the width."""
    _, out, _ = world
    lead, parked, _, factors = WIDTH_ENDS[name]
    for shuffle in (True, False):
        run = out["width_cases"][(name, shuffle)]
        ranks = run["ranks"]
        assert [r[2] for r in ranks] == [r in parked for r in range(4)]
        hist, params, _, it = ranks[lead]
        for r, (h, p, _, i) in enumerate(ranks):
            np.testing.assert_array_equal(h, hist)
            assert i == it
            if r in parked:
                for a, b in zip(_leaves(p), _leaves(params)):
                    np.testing.assert_array_equal(a, b)
        steps = 3 if name == "g" else 4  # a chunk: one epoch's batches
        assert [run["deadlines"][d] for d in (1, 2, 3, 4)] == [
            chunk_deadline_s(steps, f) for f in factors]


def test_the_autopilot_shrinks_to_the_healthy_ranks_and_readmits(world):
    """Case (e): rank 3's stall gets it evicted and the run resharded onto
    ranks [0,1,2] at the first boundary; at the next, its healthy beat
    readmits it and the run grows back over all 4 ranks; the decisions
    and the reshards are on the tracer."""
    _, out, _ = world
    for shuffle in (True, False):
        run = out["width_cases"][("e", shuffle)]
        assert run["decisions"] == ["evict", "reshard", "readmit"]
        assert run["meshes"] == {1: [0, 1, 2], 2: [0, 1, 2, 3]}
        assert {"autopilot.decision", "reshard.elastic"} <= set(run["spans"])


def test_a_mesh_of_one_rank_parks_the_other_three(world, jax_width_ref):
    """``net.fit_epochs(mesh=)`` over rank 0 alone in the world of 4:
    rank 0 trains the JAX network's one-device run (first 2 epochs, in
    the data's order), the others take no step and return its history
    and params bitwise."""
    _, out, _ = world
    got = out["width_cases"]["one_rank"]
    jax_hist, _ = jax_width_ref["elastic"]
    np.testing.assert_allclose(got["hist"], jax_hist[:2], **ELASTIC_TOL)
    hist, params, steps, parked = got["ranks"][0]
    assert steps == 8 and not parked
    for h, p, s, k in got["ranks"][1:]:
        assert s == 0 and k
        np.testing.assert_array_equal(h, hist)
        for a, b in zip(_leaves(p), _leaves(params)):
            np.testing.assert_array_equal(a, b)


def test_wrapper_fit_over_two_ranks_parks_the_others(world):
    """``ParallelWrapper.fit`` over ranks [0,1] on four batches: the JAX
    network's one-device ``fit`` within the elastic gate; ranks 2 and 3
    take no step and hold rank 0's params and iteration bitwise."""
    payload, out, _ = world
    got = out["width_cases"]["fit_r01"]
    case = payload["elastic"]
    x, y = case["arrays"][:2]
    ref = JaxMLN(_mlp_conf()).init()
    for i in range(0, 128, 32):
        ref.fit(JaxDataSet(x[i:i + 32], y[i:i + 32]))
    _close(got["params"], ref.params, **ELASTIC_TOL)
    params, steps, parked, it = got["ranks"][0]
    assert steps > 0 and not parked and it == 4
    for r, (p, s, k, i) in enumerate(got["ranks"][1:], 1):
        assert (s == 0) == k == (r >= 2) and i == it
        for a, b in zip(_leaves(p), _leaves(params)):
            np.testing.assert_array_equal(a, b)


def test_a_checkpoint_with_rank_0_parked_is_the_leads(world):
    """``FaultTolerantTrainer`` over ranks [1,2,3], preempted after an
    epoch: the lead (rank 1) writes the checkpoint, so it restores, in
    every rank, the params at the stop bitwise (rank 0's own state is
    stale while it is parked)."""
    _, out, _ = world
    got = out["width_cases"]["parked_checkpoint"]
    lead = got["final"][1]
    for restored, final in zip(got["restored"], got["final"]):
        for a, b, c in zip(_leaves(restored), _leaves(lead), _leaves(final)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(c, b)


def test_save_network_with_ranks_parked_is_the_leads(world):
    """``save_network`` in every rank of an FSDP run shrunk onto ranks
    [0,1]: the lead writes its gathered state, no parked rank writes its
    stale one or waits at a barrier the members skip, and every rank
    restores the lead's params bitwise."""
    _, out, _ = world
    got = out["width_cases"]["parked_save"]
    assert got["parked"] == [False, False, True, True]
    for restored in got["restored"]:
        for a, b in zip(_leaves(restored), _leaves(got["lead"])):
            np.testing.assert_array_equal(a, b)


def test_a_divergence_with_rank_0_parked_raises_in_every_rank(world):
    """``guard="raise"`` over ranks [1,2,3] with a non-finite row in the
    second batch: every rank raises ``TrainingDivergedError`` at the same
    epoch and step (rank 0 from the trips the lead broadcasts, with no
    world left waiting), naming the batch the lead's replay found."""
    _, out, _ = world
    got = out["width_cases"]["parked_divergence"]
    assert got["parked"] == [True, False, False, False]
    assert got["raised"] == [(0, 1, 1)] * 4


def test_a_target_outside_the_world_raises(world):
    """(f) In the world of 4: a rank the world lacks, a negative rank and
    an unordered list raise before any collective."""
    _, out, _ = world
    refused = out["width_cases"]["refused"]
    assert "[4] are not ranks of the world of 4" in refused[0]
    assert "[-1] are not ranks" in refused[1]
    assert "ascending order" in refused[2]


class _TwoDevices:
    mesh_dim_names, shape = ("data",), (2,)


def test_a_world_of_one_cannot_grow():
    """(f) The one width change the port refuses: a world of one has no
    rank to grow onto."""
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    with pytest.raises(ValueError, match="a world of one cannot span 2"):
        build_mesh(MeshSpec(data=2), ranks=[0, 1], device="cpu")
    net = _port_net(_mlp_case())
    with pytest.raises(ValueError, match="a world of one cannot span 2"):
        net.request_reshard(_TwoDevices())


def test_ranks_that_disagree_at_a_chunk_boundary_stop(world):
    """A reshard only rank 0 requests: the boundary's all_gather sees
    the ranks disagree, and every rank raises there (none enters a
    collective the others skip)."""
    _, out, _ = world
    assert "disagree" in out["elastic_case"]["disagreed"]


def test_preempted_wrapper_run_resumes_bitwise(world):
    _, out, _ = world
    got = out["resume_cases"]
    assert got["preempted"] and got["resumed"]
    assert got["bitwise"]


@pytest.mark.parametrize("name", ["m22", "fsdp", "m22_fsdp"])
def test_a_4_rank_checkpoint_resumes_on_another_layout(world, name):
    """The preempted checkpoint resumed over ``data=2 × model=2`` (W
    column-split), under FSDP (W split over ``data``) and under both
    (W column-split, the output layer's W over ``data``), then run to
    the end: the uninterrupted run's params within the elastic gate."""
    _, out, _ = world
    got = out["resume_cases"]
    _close(got[name], got["base_params"], **ELASTIC_TOL)
    assert got[f"{name}_local_w"] == {"m22": (6, 6), "fsdp": (6, 3),
                                      "m22_fsdp": (6, 6)}[name]
    if name == "m22_fsdp":   # every rank: layer 0 over model, 1 over data
        assert got["m22_fsdp_ranks"] == [((6, 6), (6, 3))] * 4


# the composed layout over data=2 x model=2: the pair's W and the column
# layer's b over model (model rank r holds part r), the row layer's b and
# the output layer's W over data, the output layer's b whole
FSDP_MODEL_SHAPES = {"0/W": (6, 6), "0/b": (6,), "1/W": (6, 8),
                     "1/b": (4,), "2/W": (4, 3), "2/b": (3,)}


def test_fsdp_over_data_and_model_fit_matches_one_device(world):
    """``ParallelWrapper(fsdp=True)`` over ``data=2 × model=2`` under
    per-layer L2 clipping (norms over each layer's ``data`` and ``model``
    parts): every rank holds the composed layout, and 3 fits give the
    JAX network's one-device params and output within the elastic gate;
    a checkpoint of the layout restores onto another network's parts
    bitwise."""
    payload, out, _ = world
    got = out["fsdp_model_cases"]
    assert got["shapes"] == [FSDP_MODEL_SHAPES] * 4
    assert got["kinds"] == ["_ColumnDense", "_RowDense", "OutputImpl"]
    case = payload["fsdp_model"]
    ref = JaxMLN(_pair_conf()).init()
    for b in case["batches"]:
        ref.fit(JaxDataSet(*b))
    _close(got["fit_params"], ref.params, **ELASTIC_TOL)
    np.testing.assert_allclose(
        got["output"], np.asarray(ref.output(case["batches"][0][0])),
        **ELASTIC_TOL)
    assert got["restored_equal"] == [True] * 4


def test_fsdp_over_data_and_model_fit_epochs_matches_one_device(world):
    """``fit_epochs`` through the same wrapper: the history and params
    of the port's one-device ``fit_epochs`` on the same plans."""
    payload, out, _ = world
    got = out["fsdp_model_cases"]
    case = payload["fsdp_model"]
    net = _port_net(case)
    hist = net.fit_epochs(ListDataSetIterator(DataSet(*case["arrays"]),
                                              case["batch"]), case["epochs"])
    np.testing.assert_allclose(got["epoch_hist"], hist.numpy(),
                               **ELASTIC_TOL)
    _close(got["epoch_params"],
           jax.tree_util.tree_map(lambda t: t.numpy(), net.params),
           **ELASTIC_TOL)


def test_fsdp_over_data_and_model_fit_epochs_matches_the_reference(world):
    """``fit_epochs`` through the same wrapper in the data's order: the
    history and params of the JAX network's one-device ``fit_epochs``
    (``shuffle=False``), each layer's clip norm over its ``data`` and
    ``model`` parts."""
    payload, out, _ = world
    got = out["fsdp_model_cases"]
    case = payload["fsdp_model"]
    x, y = case["arrays"][:2]
    ref = JaxMLN(_pair_conf()).init()
    hist = ref.fit_epochs(JaxListDataSetIterator(JaxDataSet(x, y),
                                                 case["batch"]),
                          case["epochs"], shuffle=False)
    np.testing.assert_allclose(got["epoch_hist_ordered"], np.asarray(hist),
                               **ELASTIC_TOL)
    _close(got["epoch_params_ordered"], ref.params, **ELASTIC_TOL)


def test_elastic_reshard_onto_fsdp_over_data_and_model(world):
    """``data=4``+FSDP resharded after its first epoch onto ``data=2 ×
    model=2``+FSDP: the uninterrupted ``data=4``+FSDP run's history and
    params within the elastic gate, the layout changed at the boundary."""
    _, out, _ = world
    got = out["fsdp_model_cases"]
    np.testing.assert_allclose(got["elastic_hist"], got["base_hist"],
                               **ELASTIC_TOL)
    _close(got["elastic_params"], got["base_params"], **ELASTIC_TOL)
    assert got["elastic_seen"][1]["0/W"] == (6, 3)   # over data=4
    assert got["elastic_seen"][2] == FSDP_MODEL_SHAPES


def test_a_4_rank_checkpoint_resumes_on_one_device(world, tmp_path):
    """The same checkpoint in this process, no world: the network picks
    up rank 0's generator, so it trains on the same plans."""
    payload, out, _ = world
    got = out["resume_cases"]
    case = payload["resume"]
    saved = str(tmp_path / "copy")
    import shutil

    shutil.copytree(got["saved_dir"], saved)
    net = _port_net(case)
    ft = FaultTolerantTrainer(net, saved)
    assert ft.resume()
    assert net._epoch_cursor == 1
    ft.fit_epochs(ListDataSetIterator(DataSet(*case["arrays"]), 32), 3)
    _close(jax.tree_util.tree_map(lambda t: t.numpy(), net.params),
           got["base_params"], **ELASTIC_TOL)


def test_program_contracts_over_the_mesh(world):
    """Check 3 over a mesh (``analysis/contracts.py``): the wrapper's
    epoch program and the distributed skip-gram chunk over ``data=4``
    hold every contract in every rank and are left as they were; a step
    that also sums over a ``model`` line of another mesh is reported in
    every rank."""
    _, out, _ = world
    got = out["contract_cases"]
    assert list(got["clean"].values()) == [[]]
    assert got["unchanged"] and got["tables_unchanged"]
    assert list(got["embedding"].values()) == [[]]
    (violations,) = got["seeded"].values()
    assert len(violations) == 1
    assert "undeclared mesh axis '<unnamed>'" in violations[0]
    assert "all_reduce" in violations[0]
    assert got["found_in"] == [1, 1, 1, 1]


def test_heartbeats_and_the_tracker_pointer(world):
    _, out, _ = world
    got = out["resume_cases"]
    assert got["workers"] == [f"rank-{r}" for r in range(4)]
    assert got["pointer"].endswith(".zip")
    assert got["pointer_resumes"]


@pytest.mark.parametrize("mode", ["dp", "rows"])
def test_distributed_word2vec_matches_one_device(world, mode):
    """``dp`` over ``data=4`` and ``rows`` over ``data=2 × model=2``, fed
    the JAX plans: within 1e-6 of the port's one-device fused run on the
    same plans and of the JAX fused program; the rows mode's shards hold
    V/2 rows."""
    _, out, (ref, port, plans) = world
    got = out["w2v_cases"][mode]
    assert got["mode"] == mode
    v = port.vocab.num_words()
    assert got["local_rows"] == (v // 2 if mode == "rows" else v)
    _, one = _pair(_sentences(), epochs=2)
    one_hist = one.fit_epochs(2, _plan=plans)
    np.testing.assert_allclose(got["hist"], one_hist.numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got["syn0"], one.syn0.numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got["syn1neg"], one.syn1neg.numpy(), rtol=0,
                               atol=1e-6)
    if not hasattr(ref, "_fitted_hist"):
        ref._fitted_hist = np.asarray(ref.fit_epochs(2))
    np.testing.assert_allclose(got["hist"], ref._fitted_hist, **W2V_TOL)
    np.testing.assert_allclose(got["syn0"], np.asarray(ref.syn0), **W2V_TOL)
    np.testing.assert_allclose(got["syn1neg"], np.asarray(ref.syn1neg),
                               **W2V_TOL)


def test_distributed_word2vec_host_loop_keeps_the_ranks_equal(world):
    """``fit()`` over ``data=4`` splits each padded batch over the ranks
    and averages their tables in rank order: every rank holds the same
    bytes, finite."""
    _, out, _ = world
    got = out["w2v_cases"]["host_loop"]
    tables = got["syn0"]
    assert all(np.array_equal(t, tables[0]) for t in tables)
    assert np.isfinite(tables[0]).all() and np.isfinite(got["loss"])


def test_distributed_word2vec_heartbeat_payload():
    """``attach_heartbeat`` posts the fused driver's words/s and loss."""
    from deeplearning4j_tpu_torch.nlp import CollectionSentenceIterator
    from deeplearning4j_tpu_torch.nlp.distributed import DistributedWord2Vec
    from deeplearning4j_tpu_torch.parallel import mesh as port_mesh

    tracker = InMemoryStateTracker()
    dw = DistributedWord2Vec(CollectionSentenceIterator(_sentences()),
                             device="cpu", min_word_frequency=1,
                             layer_size=8, window_size=2, epochs=1)
    try:
        assert dw._fused_mode(dw.mesh) == "single"
        with dw.attach_heartbeat(tracker, "w2v", interval_s=0.02):
            dw.fit_epochs(1)
            deadline = time.monotonic() + 5.0
            while (not (tracker.heartbeat_metrics("w2v") or {}).get(
                    "words_per_sec") and time.monotonic() < deadline):
                time.sleep(0.01)
        m = tracker.heartbeat_metrics("w2v")
        assert m["words_per_sec"] > 0 and m["epochs_done"] == 1
        assert np.isfinite(m["last_loss"])
    finally:
        port_mesh.leave_world()


# ---------------------------------------------------------------------------
# the state tracker (tests/test_cluster.py on the port's modules)
# ---------------------------------------------------------------------------
@pytest.fixture(params=["memory", "file"])
def tracker(request, tmp_path):
    if request.param == "memory":
        return InMemoryStateTracker()
    return FileStateTracker(str(tmp_path / "tracker"))


class TestStateTracker:
    def test_job_lifecycle(self, tracker):
        jid = tracker.add_job({"batch": 0})
        assert tracker.jobs(status="pending")[0].job_id == jid
        j = tracker.claim_job("w1")
        assert j.job_id == jid and j.worker_id == "w1" and j.attempts == 1
        assert tracker.claim_job("w2") is None
        tracker.complete_job(jid, result={"loss": 0.5})
        done = tracker.jobs(status="done")
        assert len(done) == 1 and done[0].result == {"loss": 0.5}

    def test_fifo_claim_order(self, tracker):
        ids = [tracker.add_job(i) for i in range(3)]
        assert [tracker.claim_job("w").job_id for _ in range(3)] == ids

    def test_fail_requeues(self, tracker):
        jid = tracker.add_job("x")
        tracker.claim_job("w1")
        tracker.fail_job(jid, requeue=True)
        j = tracker.claim_job("w2")
        assert j.job_id == jid and j.attempts == 2

    def test_fail_terminal(self, tracker):
        jid = tracker.add_job("x")
        tracker.claim_job("w1")
        tracker.fail_job(jid, requeue=False)
        assert tracker.claim_job("w2") is None
        assert tracker.jobs(status="failed")[0].job_id == jid

    def test_heartbeat_and_eviction_requeues_jobs(self, tracker):
        jid = tracker.add_job("x")
        tracker.heartbeat("w1")
        tracker.claim_job("w1")
        assert "w1" in tracker.workers()
        assert tracker.evict_stale(timeout_s=60.0) == []
        time.sleep(0.05)
        assert tracker.evict_stale(timeout_s=0.01) == ["w1"]
        assert tracker.workers() == []
        j = tracker.claim_job("w2")
        assert j.job_id == jid and j.attempts == 2

    def test_meta_roundtrip(self, tracker):
        tracker.put_meta("conf", {"lr": 0.1})
        assert tracker.get_meta("conf") == {"lr": 0.1}
        assert tracker.get_meta("missing", 42) == 42

    def test_updates_channel(self, tracker):
        tracker.post_update("w1", np.array([1.0, 2.0], np.float32))
        tracker.post_update("w1", np.array([3.0, 4.0], np.float32))
        keys = tracker.posted_update_keys()
        assert {tracker.update_worker(k) for k in keys} == {"w1"}
        got = tracker.drain_updates()
        assert len(got) == 2 and tracker.drain_updates() == {}


def test_stale_lock_broken_and_job_claimable(tmp_path):
    tr = FileStateTracker(str(tmp_path / "t"))
    jid = tr.add_job("x")
    lock = os.path.join(tr.root, "locks", "claim-" + jid)
    open(lock, "w").close()
    old = time.time() - 120
    os.utime(lock, (old, old))
    j = tr.claim_job("w2")
    assert j is not None and j.job_id == jid


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_file_tracker_directory_reads_across_packages(tmp_path, writer):
    """A directory written by either package's ``FileStateTracker`` reads
    back the same in the other: jobs and their states, claims, meta,
    heartbeats with payloads and the binary updates channel."""
    root = str(tmp_path / "shared")
    cls_w, cls_r = ((JaxFileStateTracker, FileStateTracker)
                    if writer == "jax"
                    else (FileStateTracker, JaxFileStateTracker))
    w = cls_w(root)
    ids = [w.add_job({"batch": i}) for i in range(3)]
    w.claim_job("w1")
    w.complete_job(ids[0], result={"loss": 0.25})
    w.claim_job("w2")
    w.fail_job(ids[1], requeue=False)
    w.put_meta("latest_checkpoint", "/ck/ckpt-1.zip")
    w.heartbeat("w1", metrics={"step_s": 0.5})
    w.put_array("global_params", np.arange(4, dtype=np.float32))
    w.post_update("w2", np.ones(3, np.float32))
    r = cls_r(root)
    for status in ("pending", "claimed", "done", "failed"):
        assert [(j.job_id, j.payload, j.worker_id, j.attempts, j.result)
                for j in r.jobs(status=status)] == [
            (j.job_id, j.payload, j.worker_id, j.attempts, j.result)
            for j in w.jobs(status=status)]
    assert r.jobs(status="pending")[0].job_id == ids[2]
    assert r.get_meta("latest_checkpoint") == "/ck/ckpt-1.zip"
    assert r.workers() == ["w1"]
    assert r.heartbeat_metrics("w1") == {"step_s": 0.5}
    assert abs(r.last_heartbeat("w1") - w.last_heartbeat("w1")) < 1e-6
    np.testing.assert_array_equal(r.get_array("global_params"),
                                  np.arange(4, dtype=np.float32))
    got = r.drain_updates()
    assert len(got) == 1
    np.testing.assert_array_equal(list(got.values())[0], np.ones(3))
    assert r.claim_job("w3").job_id == ids[2]


# ---------------------------------------------------------------------------
# heartbeats and the multi-host init
# ---------------------------------------------------------------------------
class TestHeartbeatMonitor:
    def test_background_beats(self):
        tracker = InMemoryStateTracker()
        with HeartbeatMonitor(tracker, "w1", interval_s=0.02):
            time.sleep(0.1)
            t1 = tracker.last_heartbeat("w1")
            time.sleep(0.1)
            t2 = tracker.last_heartbeat("w1")
        assert t1 is not None and t2 > t1
        final = tracker.last_heartbeat("w1")
        time.sleep(0.1)
        assert tracker.last_heartbeat("w1") == final

    def test_restart(self):
        tracker = InMemoryStateTracker()
        m = HeartbeatMonitor(tracker, "w1", interval_s=0.02)
        m.start()
        time.sleep(0.05)
        m.stop()
        m.start()
        time.sleep(0.08)
        t1 = tracker.last_heartbeat("w1")
        time.sleep(0.08)
        t2 = tracker.last_heartbeat("w1")
        m.stop()
        assert t2 > t1

    def test_payload_rides_and_failures_degrade(self):
        tracker = InMemoryStateTracker()
        calls = {"n": 0}

        def payload():
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("telemetry down")
            return {"step_s": 0.1}

        m = HeartbeatMonitor(tracker, "w1", interval_s=0.02,
                             payload_fn=payload).start()
        assert tracker.last_heartbeat("w1") is not None  # beat anyway
        time.sleep(0.1)
        m.stop()
        assert tracker.heartbeat_metrics("w1") == {"step_s": 0.1}


class TestHeartbeatMonitorHardening:
    def test_stop_idempotent(self):
        tracker = InMemoryStateTracker()
        m = HeartbeatMonitor(tracker, "w1", interval_s=0.02)
        m.start()
        m.stop()
        m.stop()
        assert tracker.last_heartbeat("w1") is not None

    def test_rapid_stop_start_cycles_beat_cleanly(self):
        tracker = InMemoryStateTracker()
        m = HeartbeatMonitor(tracker, "w1", interval_s=0.01)
        for _ in range(5):
            m.start()
            m.stop()
        m.start()
        time.sleep(0.06)
        t1 = tracker.last_heartbeat("w1")
        time.sleep(0.06)
        t2 = tracker.last_heartbeat("w1")
        m.stop()
        assert t2 > t1

    def test_start_twice_single_thread(self):
        tracker = InMemoryStateTracker()
        m = HeartbeatMonitor(tracker, "w1", interval_s=0.02)
        assert m.start() is m.start()
        thread = m._thread
        m.start()
        assert m._thread is thread
        m.stop()


class TestInitializeDistributed:
    CFG = ClusterConfig(coordinator_address="127.0.0.1:1", num_processes=2,
                        process_id=0)

    def test_single_process_noop(self):
        assert initialize_distributed(ClusterConfig()) is False
        assert initialize_distributed(
            ClusterConfig(coordinator_address=None, num_processes=4)) is False

    def test_injected_faults_exhaust_deterministically(self):
        sleeps = []
        policy = RetryPolicy(max_attempts=3, base_delay_s=0.01, seed=5,
                             sleep=sleeps.append)
        with inject("distributed.init", fail_times(10)):
            with pytest.raises(RuntimeError, match="after 3 attempts"):
                initialize_distributed(self.CFG, policy=policy,
                                       device="cpu")
        assert len(sleeps) == 2
        assert all(0.0 <= s <= 0.04 for s in sleeps)

    def test_transient_init_then_success(self, monkeypatch):
        import torch.distributed as dist

        calls = {"n": 0, "kw": None}

        def flaky_init(backend, **kw):
            calls["n"] += 1
            calls["kw"] = (backend, kw["rank"], kw["world_size"])
            if calls["n"] < 3:
                raise RuntimeError("coordinator not up yet")

        monkeypatch.setattr(dist, "TCPStore", lambda *a, **kw: object())
        monkeypatch.setattr(dist, "init_process_group", flaky_init)
        policy = RetryPolicy(max_attempts=5, base_delay_s=0.001,
                             sleep=lambda s: None)
        assert initialize_distributed(self.CFG, policy=policy,
                                      device="cpu") is True
        assert calls["n"] == 3 and calls["kw"] == ("gloo", 0, 2)

    def test_legacy_knobs_seed_default_policy(self, monkeypatch):
        import torch.distributed as dist

        def always_down(*a, **kw):
            raise RuntimeError("down")

        monkeypatch.setattr(dist, "TCPStore", always_down)
        monkeypatch.setattr(time, "sleep", lambda s: None)
        with pytest.raises(RuntimeError, match="after 2 attempts"):
            initialize_distributed(self.CFG, retries=2, retry_delay_s=0.001,
                                   device="cpu")

    def test_backend_follows_the_cards(self):
        assert port_cluster.default_backend("cpu", 4) == "gloo"


# ---------------------------------------------------------------------------
# the work router (tests/test_workrouter.py on the port's modules)
# ---------------------------------------------------------------------------
class _ConstPerformer(WorkerPerformer):
    def __init__(self, value):
        self.value = np.asarray(value, np.float32)
        self.received = []

    def perform(self, payload):
        time.sleep(0.05)
        return self.value

    def update(self, params):
        self.received.append(np.asarray(params))


def test_average_aggregator():
    out = average_aggregator([np.array([1.0, 2.0]), np.array([3.0, 4.0])])
    np.testing.assert_allclose(out, [2.0, 3.0])
    with pytest.raises(ValueError):
        average_aggregator([])


def test_iterative_reduce_barrier_waits_for_all(tracker):
    router = IterativeReduceWorkRouter(tracker)
    router.post("w1", np.array([1.0, 1.0]))
    assert not router.step(num_workers=2)
    assert router.current_params() is None
    router.post("w2", np.array([3.0, 5.0]))
    assert router.step(num_workers=2)
    np.testing.assert_allclose(router.current_params(), [2.0, 3.0])
    assert router.rounds == 1


def test_hogwild_async_mix():
    router = HogwildWorkRouter(InMemoryStateTracker(), mix=0.5)
    router.post("w1", np.array([2.0]))
    np.testing.assert_allclose(router.current_params(), [2.0])
    router.post("w2", np.array([4.0]))
    np.testing.assert_allclose(router.current_params(), [3.0])
    assert not router.step(2)


def test_trainer_drains_jobs_and_averages():
    tr = InMemoryStateTracker()
    router = IterativeReduceWorkRouter(tr)
    values = iter([[1.0, 1.0], [3.0, 3.0]])
    trainer = DistributedTrainer(tr, router,
                                 lambda: _ConstPerformer(next(values)),
                                 num_workers=2)
    for i in range(4):
        tr.add_job({"i": i})
    params = trainer.train(timeout_s=20)
    np.testing.assert_allclose(params, [2.0, 2.0])
    assert len(tr.jobs(status="done")) == 4


def test_poison_job_fails_bounded_and_raises():
    class Poison(WorkerPerformer):
        def perform(self, payload):
            if payload == "bad":
                raise ValueError("poison")
            return np.ones(2, np.float32)

    tr = InMemoryStateTracker()
    trainer = DistributedTrainer(tr, IterativeReduceWorkRouter(tr), Poison,
                                 num_workers=1, max_attempts=2)
    tr.add_job("bad")
    tr.add_job("ok")
    with pytest.raises(RuntimeError, match="failed permanently"):
        trainer.train(timeout_s=20)
    bad = tr.jobs(status="failed")
    assert len(bad) == 1 and bad[0].attempts == 2
    assert len(trainer.errors) == 2


def test_partial_final_round_not_discarded():
    tr = InMemoryStateTracker()
    router = IterativeReduceWorkRouter(tr)
    trainer = DistributedTrainer(tr, router,
                                 lambda: _ConstPerformer([4.0]),
                                 num_workers=2)
    tr.add_job({"i": 0})  # one job for two workers: never a full round
    params = trainer.train(timeout_s=20)
    np.testing.assert_allclose(params, [4.0])


def test_autopilot_env_raises_naming_a15(monkeypatch):
    """``DL4J_AUTOPILOT=1`` builds the default goodput autopilot, its
    silence bound the trainer's eviction timeout (120 s without one), its
    evict actuator the trainer's own ``evict_worker``."""
    from deeplearning4j_tpu_torch.resilience import GoodputAutopilot

    monkeypatch.setenv("DL4J_AUTOPILOT", "1")
    tr = InMemoryStateTracker()
    trainer = DistributedTrainer(tr, IterativeReduceWorkRouter(tr),
                                 lambda: _ConstPerformer([1.0]))
    assert isinstance(trainer.autopilot, GoodputAutopilot)
    assert trainer.autopilot.silence_s == 120.0
    tr.heartbeat("w9")
    trainer.autopilot._evict("w9", None)
    assert trainer.evicted == ["w9"]
    monkeypatch.setenv("DL4J_AUTOPILOT", "0")
    assert DistributedTrainer(tr, IterativeReduceWorkRouter(tr),
                              lambda: _ConstPerformer([1.0])
                              ).autopilot is None


def _router_run(package, conf_json, jobs, start):
    """One barrier round: 2 workers, 2 jobs, both from ``start``."""
    if package == "jax":
        tr, router_cls, trainer_cls = (JaxInMemoryStateTracker(),
                                       JaxIterativeReduce,
                                       JaxDistributedTrainer)
        make = lambda: JaxNetworkPerformer(conf_json)  # noqa: E731
    else:
        tr, router_cls, trainer_cls = (InMemoryStateTracker(),
                                       IterativeReduceWorkRouter,
                                       DistributedTrainer)
        make = lambda: NetworkWorkPerformer(conf_json,  # noqa: E731
                                            device="cpu")
    router = router_cls(tr)
    tr.put_array("global_params", start)
    barrier = threading.Barrier(2)

    class OneJobEach:
        """A performer that waits for its peer before its one job, so
        each worker takes one job from the published start."""

        def __init__(self):
            self.inner = make()
            self.network = self.inner.network

        def perform(self, payload):
            barrier.wait(timeout=30)
            return self.inner.perform(payload)

        def update(self, params):
            self.inner.update(params)

    trainer = trainer_cls(tr, router, OneJobEach, num_workers=2)
    for job in jobs:
        tr.add_job(job)
    return np.asarray(trainer.train(timeout_s=120), np.float32)


def test_network_performers_average_as_the_jax_router():
    """``DistributedTrainer`` with ``NetworkWorkPerformer`` against the
    JAX router on the same jobs and the same starting weights: the
    averaged params at rtol 1e-5 / atol 1e-6."""
    ref = JaxMLN(_mlp_conf()).init()
    start = np.asarray(ref.get_flat_params(), np.float32)
    port = _port_net({"conf": ref.conf.to_json(), "state": (
        *jax.tree_util.tree_map(np.asarray, (ref.params, ref.updater_state,
                                             ref.net_state)),
        ref.iteration_count)})
    np.testing.assert_array_equal(port.get_flat_params(), start)
    rng = np.random.default_rng(3)
    jobs = []
    for _ in range(2):
        x = rng.normal(size=(16, 6)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
        jobs.append({"features": x.tolist(), "labels": y.tolist()})
    conf_json = ref.conf.to_json()
    want = _router_run("jax", conf_json, jobs, start)
    got = _router_run("port", conf_json, jobs, start)
    assert not np.allclose(got, start)
    np.testing.assert_allclose(got, want, **ROUTER_TOL)


# ---------------------------------------------------------------------------
# chaos: a worker dies mid-job
# ---------------------------------------------------------------------------
class _DieFirstPerformer(WorkerPerformer):
    _lock = threading.Lock()
    _dead = False

    def __init__(self, worker_id, trainer_ref):
        self.worker_id = worker_id
        self.trainer_ref = trainer_ref

    def perform(self, payload):
        cls = type(self)
        with cls._lock:
            die, cls._dead = not cls._dead, True
        if die:  # a dead process takes its heartbeat thread with it
            self.trainer_ref["trainer"].monitors[self.worker_id].stop()
            threading.Event().wait()
        return np.asarray(payload["value"], np.float32)


@pytest.mark.chaos
def test_worker_crash_eviction_requeue_completes():
    _DieFirstPerformer._dead = False
    tracker = InMemoryStateTracker()
    router = IterativeReduceWorkRouter(tracker)
    for i in range(4):
        tracker.add_job({"value": [float(i + 1)]})
    ref, made = {}, []

    def factory():
        p = _DieFirstPerformer(f"worker-{len(made)}", ref)
        made.append(p)
        return p

    trainer = DistributedTrainer(
        tracker, router, factory, num_workers=2, poll_s=0.01,
        join_timeout_s=0.2, heartbeat_interval_s=0.05,
        eviction_timeout_s=0.3)
    ref["trainer"] = trainer
    params = trainer.train(timeout_s=30.0)
    assert len(set(trainer.evicted)) == 1
    assert trainer.eviction_log[0]["timeout_s"] == 0.3
    assert len(tracker.jobs(status="done")) == 4
    assert tracker.jobs(status="pending") == [] and params is not None


# ---------------------------------------------------------------------------
# the CLI's runtimes
# ---------------------------------------------------------------------------
def _cli_files(tmp_path):
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.normal(-2, 0.5, (40, 4)),
                        rng.normal(2, 0.5, (40, 4))])
    y = np.repeat([0, 1], 40)
    order = rng.permutation(80)
    data = tmp_path / "data.csv"
    with open(data, "w") as f:
        for i in order:
            f.write(",".join(f"{v:.5f}" for v in x[i]) + f",{y[i]}\n")
    conf = (JaxNNC.Builder().seed(7).learning_rate(0.5).list()
            .layer(0, jax_L.DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(1, jax_L.OutputLayer(n_in=8, n_out=2,
                                        activation="softmax"))
            .build())
    model = tmp_path / "conf.json"
    model.write_text(conf.to_json())
    return str(data), str(model)


def _cli_train(data, model, out, *extra):
    return main(["train", "-input", data, "-model", model, "-output", out,
                 "--num-classes", "2", "--batch-size", "16", "--epochs",
                 "2", *extra, "--device", "cpu"])


def _zip_params(path):
    net = ModelSerializer.restore(path, device="cpu")
    return jax.tree_util.tree_map(lambda t: t.numpy(), net.params)


def test_mesh_runtime_in_a_world_of_one_is_local_bitwise(tmp_path):
    data, model = _cli_files(tmp_path)
    local, mesh = str(tmp_path / "l.zip"), str(tmp_path / "m.zip")
    assert _cli_train(data, model, local) == 0
    assert _cli_train(data, model, mesh, "-runtime", "mesh") == 0
    for a, b in zip(_leaves(_zip_params(local)), _leaves(_zip_params(mesh))):
        np.testing.assert_array_equal(a, b)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_multihost_runtime_as_two_processes_matches_local(tmp_path):
    """Two CLI processes meeting at a free local port, each training on
    its half of every batch; rank 0 writes the zip. Against ``-runtime
    local`` at rtol 1e-4."""
    data, model = _cli_files(tmp_path)
    local = str(tmp_path / "l.zip")
    assert _cli_train(data, model, local) == 0
    out = str(tmp_path / "mh.zip")
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": torch_worlds.REPO,
           "OMP_NUM_THREADS": "1"}
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "train",
         "-input", data, "-model", model, "-output", out, "--num-classes",
         "2", "--batch-size", "16", "--epochs", "2", "--device", "cpu",
         "-runtime", "multihost", "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(r)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    assert "runtime=multihost" in logs[0]
    _close(_zip_params(out), _zip_params(local), rtol=1e-4, atol=1e-6)


def test_multihost_runtime_over_the_first_rank_parks_the_other(tmp_path):
    """``--mesh-devices 1`` in a world of two CLI processes: rank 0
    trains alone over ranks ``[0, 1)``, rank 1 parks, rank 0 writes the
    zip, which is ``-runtime local``'s bitwise."""
    data, model = _cli_files(tmp_path)
    local = str(tmp_path / "l.zip")
    assert _cli_train(data, model, local) == 0
    out = str(tmp_path / "mh1.zip")
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": torch_worlds.REPO,
           "OMP_NUM_THREADS": "1"}
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "train",
         "-input", data, "-model", model, "-output", out, "--num-classes",
         "2", "--batch-size", "16", "--epochs", "2", "--device", "cpu",
         "-runtime", "multihost", "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(r),
         "--mesh-devices", "1"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    for a, b in zip(_leaves(_zip_params(out)), _leaves(_zip_params(local))):
        np.testing.assert_array_equal(a, b)


def test_mesh_devices_above_the_world_exits(tmp_path):
    data, model = _cli_files(tmp_path)
    with pytest.raises(SystemExit, match="exceeds the world's 1 rank"):
        _cli_train(data, model, str(tmp_path / "x.zip"), "-runtime",
                   "mesh", "--mesh-devices", "2")


def test_multihost_without_a_coordinator_exits(tmp_path):
    data, model = _cli_files(tmp_path)
    with pytest.raises(SystemExit, match="requires --coordinator"):
        _cli_train(data, model, str(tmp_path / "x.zip"), "-runtime",
                   "multihost", "--num-processes", "2")
    props = tmp_path / "r.properties"
    props.write_text("runtime=multihost\nruntime.num.processes=2\n")
    with pytest.raises(SystemExit, match="requires --coordinator"):
        _cli_train(data, model, str(tmp_path / "y.zip"), "-conf",
                   str(props))
