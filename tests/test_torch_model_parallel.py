"""Port parity for the ``model``, ``pipe`` and ``expert`` axes against
``deeplearning4j_tpu``: tensor-parallel training, decoding and serving of
``TransformerLM``, ``shard_network_params`` on networks, the GPipe
schedule and the MoE FFN.

Every multi-rank case runs in ONE gloo world of 4 spawned CPU ranks
(``tests/torch_worlds.py``), every rank given the same inputs, made
from numpy seeds, and the JAX model's weights
(``models/convert``); the JAX functions run unsharded in the parent,
as the reference's own tests hold its sharded runs against them
(``tests/test_parallel.py``).

Slot handoff into and out of tensor-parallel replicas (``tp_fleet``
cases): every rank holds the same fleet and makes the same calls, rank
0's fake clock ticks 4 ms a read and the others' 1e7 s, so a decision a
follower took from its own clock would part the streams or hang the
world. Gates: greedy streams of a split fleet of TP replicas, of drains
of a TP decode replica (a split fleet's, with live slots and a handoff
not yet installed, and a mixed fleet's, with live slots and a queued
request) and of slabs moved TP to one device and back equal the JAX
``generate`` exactly (int8 pools the JAX server's int8 streams); a
sampled split fleet's equal the port's one-device split fleet's; every
handoff's bytes equal ``kv_per_slot_bytes``; a drain recomputes
nothing; a hedge race (the followers' clocks running 1e7 s a read ahead,
rank 0's settable) hedges, withdraws and wins as the one-device fleet
does.

Gates: greedy and beam-3 tokens exactly equal (``TestShardedDecode``'s
config, vocab 64, d64, H8, Hkv 4, RoPE, two layers; the GQA fallback at
Hkv 2); one step's loss and gradients at float32 rtol 2e-3 / atol 1e-3,
the params after one Adam step at atol 1e-4 (the single-device
training parity's gate); served greedy streams exactly equal, with an
int8 pool too; a decode row's logits bitwise the same at batch 1 and 5
under ``mixed_bf16`` (as ``tests/test_torch_training.py`` holds it
unsharded); the sharded forward logits and beam scores bitwise the
unsharded port's in float32; a dense pair with dropout after two fits
at rtol 1e-5 / atol 1e-6 of the port's unsharded fit;
the TP MLP's outputs at rtol 1e-5 / atol 1e-6 and one fit at 2e-4 /
1e-5 (``tests/test_parallel.py:201-225``); the dense-pair MLP, LeNet-5
and a char-LSTM (Adam) after ``fit``, the MLP also through
``ParallelWrapper`` over ``data=2 × model=2``: Adam state at rtol 2e-4 / atol
1e-5, params at atol 1e-4 (a first Adam step moves a weight by about
±lr whatever its gradient, so rounding of a near-zero gradient shows at
up to lr; the training parity's gate); the pipeline's
outputs at 1e-5 / 1e-6 and gradients at 1e-4 / 1e-5, its loss falling
over 20 steps; the MoE's y at 1e-4 / 1e-5, aux at 1e-4, gradients at
1e-4 / 1e-5.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.models.transformer import TransformerLM as JaxLM
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import layers as jax_L
from deeplearning4j_tpu.nn.conf import graph as jax_G
from deeplearning4j_tpu.nn.conf.enums import Updater as JaxUpdater
from deeplearning4j_tpu.nn.conf.graph import (
    ComputationGraphConfiguration as JaxCGC)
from deeplearning4j_tpu.nn.conf.neural_net import (
    MultiLayerConfiguration as JaxMLC)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxCG
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.parallel.expert_parallel import (
    MoEConfig as JaxMoEConfig, init_moe_params as jax_init_moe,
    moe_ffn as jax_moe_ffn)
from deeplearning4j_tpu.parallel.pipeline_parallel import (
    stack_stage_params as jax_stack)
from deeplearning4j_tpu.serving import DecodeServer as JaxServer
from deeplearning4j_tpu.serving import poisson_schedule as jax_schedule
from deeplearning4j_tpu.serving import run_open_loop as jax_open_loop

import torch_worlds

N = 4
DECODE = dict(vocab_size=64, d_model=64, num_heads=8, num_layers=2,
              max_len=24, seed=9, num_kv_heads=4, pos_encoding="rope")
SERVE = {**DECODE, "max_len": 64}
SCHEDULE = dict(vocab_size=64, prompt_lens=(5, 13, 20),
                max_new_tokens=(3, 6, 8), seed=11)
TP_LM = {"m4": (dict(model=4), {}),
         "gqa2": (dict(model=4), {"num_kv_heads": 2}),
         "d2m2": (dict(data=2, model=2), {})}
TP_SERVE = {"f32": {}, "int8": {"kv_dtype": "int8", "fuse_steps": 4}}
# the fleets' requests: prompt lengths and max_new_tokens; the drains
# take the first five (three live on the drained replica after its two
# steps, one installed on the survivor, one handed off but not yet
# installed)
FLEET_REQUESTS = ((5, 8), (13, 6), (20, 8), (7, 8), (9, 6), (11, 4))
FLEET_SAMPLED = dict(temperature=0.7, top_k=20, deadline_s=1e6)
TP_CROSS = {"m4": {}, "gqa2": {"num_kv_heads": 2}}
HEDGES = ("win", "lose")   # which copy of the hedged request runs first
TP_NETS = ("tp_mlp", "pair_mlp", "lenet", "lstm", "graph", "wrapped")
# gradient normalization by L2 norms on split layers, under SGD (Adam's
# step hardly moves when its gradient is scaled, so it would hide a wrong
# norm): each net's threshold lies below most of its layers' and leaves'
# first-step gradient norms (pair_mlp's layers 1.3-6.2, its biases
# 0.29-0.44; the LSTM's layer 0.21, its leaves 0.008-0.15), so the clips
# engage on some leaves and not on others
L2_MODES = ("RenormalizeL2PerLayer", "ClipL2PerLayer",
            "RenormalizeL2PerParamType", "ClipL2PerParamType")
L2_THRESHOLD = {"pair_mlp": 0.5, "lenet": 0.5, "lstm": 0.1, "graph": 0.5,
                "wrapped": 0.5, "fit_steps": 0.5, "fit_epochs": 0.5}
L2_LR = 0.1
L2_CASES = ([f"{kind}:{mode}" for kind in ("pair_mlp", "lenet", "lstm",
                                           "graph") for mode in L2_MODES]
            + ["wrapped:ClipL2PerLayer", "fit_steps:ClipL2PerParamType",
               "fit_epochs:RenormalizeL2PerLayer", "pair_mlp:None"])
L2_TOL = dict(rtol=2e-4, atol=1e-5)
PIPES = {"p4": (dict(data=1, pipe=4), 4), "d2p2": (dict(data=2, pipe=2), 2)}
MOE = dict(d_model=8, d_ff=16, n_experts=8, top_k=2, capacity_factor=2.0)
DROP = dict(d_model=8, d_ff=16, n_experts=4, top_k=1, capacity_factor=0.25)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _prompt():
    return np.random.default_rng(0).integers(0, 64, (2, 8)).astype(np.int32)


def _fleet_requests():
    rng = np.random.default_rng(11)
    return [dict(prompt=rng.integers(0, 64, n).astype(np.int32),
                 max_new_tokens=m, seed=i)
            for i, (n, m) in enumerate(FLEET_REQUESTS)]


def _hedge_requests():
    """The hedge race's three requests: a short and a long one fill the
    two replicas' slots, the third queues behind them."""
    return [dict(r, max_new_tokens=m)
            for r, m in zip(_fleet_requests(), (2, 8, 4))]


def _lm_tokens():
    return np.random.default_rng(20).integers(0, 64, (4, 16)).astype(
        np.int32)


_JAX = {}


def _jax_lm(cfg):
    """One JAX model per config (its decoders and steps compile once)."""
    key = tuple(sorted(cfg.items()))
    if key not in _JAX:
        _JAX[key] = JaxLM(**cfg).init()
    return _JAX[key]


def _jax_step(cfg):
    """The JAX model's loss and gradients on ``_lm_tokens()`` and a fresh
    model's loss and params after one ``fit_batch``, once per config."""
    key = ("step",) + tuple(sorted(cfg.items()))
    if key not in _JAX:
        ref, tok = _jax_lm(cfg), jnp.asarray(_lm_tokens())
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: ref.loss(p, tok, train=True)))(ref.params)
        lm = JaxLM(**cfg).init()
        _JAX[key] = (float(loss), grads, lm.fit_batch(tok), lm.params)
    return _JAX[key]


# ---------------------------------------------------------------------------
# networks
# ---------------------------------------------------------------------------
def _toy(n, seed=0, d=8, c=3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(c, d)) * 3.0
    ys = rng.integers(0, c, n)
    xs = (centers[ys] + rng.normal(size=(n, d))).astype(np.float32)
    return xs, np.eye(c)[ys].astype(np.float32)


def _net(kind):
    """(JAX network, its batches)."""
    if kind == "tp_mlp":
        conf = (JaxNNC.Builder().seed(11).learning_rate(0.1)
                .updater(JaxUpdater.SGD).list()
                .layer(0, jax_L.DenseLayer(n_in=8, n_out=16,
                                           activation="relu"))
                .layer(1, jax_L.OutputLayer(n_in=16, n_out=3))
                .build())
        return JaxMLN(conf).init(), [_toy(32) + (None, None)]
    if kind in ("pair_mlp", "wrapped"):
        net = jax_zoo.mnist_mlp(hidden=16, lr=1e-2, seed=3).init()
        rng = np.random.default_rng(5)
        return net, [(rng.normal(size=(16, 784)).astype(np.float32),
                      np.eye(10, dtype=np.float32)[rng.integers(0, 10, 16)],
                      None, None) for _ in range(2)]
    if kind == "graph":
        g = (JaxNNC.Builder().seed(8).learning_rate(1e-2)
             .updater(JaxUpdater.ADAM).graph_builder().add_inputs("in"))
        g.add_layer("d0", jax_L.DenseLayer(n_in=8, n_out=16,
                                           activation="tanh"), "in")
        g.add_layer("d1", jax_L.DenseLayer(n_in=16, n_out=12,
                                           activation="relu"), "d0")
        g.add_vertex("cat", jax_G.MergeVertex(), "d1", "in")
        g.add_layer("out", jax_L.OutputLayer(n_in=20, n_out=3), "cat")
        net = JaxCG(g.set_outputs("out").build()).init()
        return net, [_toy(16, seed=s) + (None, None) for s in (1, 2)]
    if kind == "lenet":
        net = jax_zoo.lenet5(lr=1e-2, seed=4).init()
        rng = np.random.default_rng(6)
        return net, [(rng.normal(size=(8, 28, 28, 1)).astype(np.float32),
                      np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)],
                      None, None) for _ in range(2)]
    net = jax_zoo.char_lstm(vocab_size=6, hidden=8, layers=1,
                            tbptt_length=3, seed=3).init()
    rng = np.random.default_rng(7)
    return net, [(np.eye(6, dtype=np.float32)[rng.integers(0, 6, (4, 7))],
                  np.eye(6, dtype=np.float32)[rng.integers(0, 6, (4, 7))],
                  None, None)]


def _sgd_with(conf_json: str, mode: str, threshold: float) -> str:
    """A conf's JSON with every layer on SGD at ``L2_LR`` under the
    gradient normalization ``mode``."""
    conf = json.loads(conf_json)

    def walk(node):
        if isinstance(node, dict):
            if "updater" in node:
                node.update(updater="SGD", learning_rate=L2_LR,
                            gradient_normalization=mode,
                            gradient_normalization_threshold=threshold)
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(conf)
    return json.dumps(conf)


def _l2_net(key):
    """(JAX network, its batches, the port case's fields) of an
    ``L2_CASES`` key: the ``_net`` of its kind (pair_mlp's for the
    ``fit_steps`` and ``fit_epochs`` cases) on SGD under its mode."""
    kind, mode = key.split(":")
    net, batches = _net("pair_mlp" if kind.startswith("fit_") else kind)
    conf = _sgd_with(net.conf.to_json(), mode, L2_THRESHOLD[kind])
    graph = kind == "graph"
    jnet = (JaxCG(JaxCGC.from_json(conf)) if graph
            else JaxMLN(JaxMLC.from_json(conf))).init()
    fields = dict(mesh=dict(model=N), wrapper=kind == "wrapped", conf=conf,
                  graph=graph)
    if kind in ("wrapped", "fit_epochs"):
        fields["mesh"] = dict(data=2, model=2)
    if kind == "fit_steps":
        batches = batches[:1]
        fields.update(how="fit_steps", steps=3)
    if kind == "fit_epochs":
        fields.update(how="fit_epochs", epochs=2)
    return jnet, batches, fields


def _l2_fit(jnet, batches, fields):
    """The JAX network's unsharded run of the case; its loss history
    for ``fit_epochs``."""
    ds = [JaxDataSet(*b) for b in batches]
    how = fields.get("how", "fit")
    if how == "fit_epochs":
        return np.asarray(jnet.fit_epochs(ds, fields["epochs"],
                                          shuffle=False))
    if how == "fit_steps":
        jnet.fit_steps(ds[0], fields["steps"])
        return None
    for d in ds:
        jnet.fit(d)
    return None


# ---------------------------------------------------------------------------
# pipeline and experts (tests/test_parallel.py:349-507)
# ---------------------------------------------------------------------------
def _stages(n_stages, seed, d=8):
    rng = np.random.default_rng(seed)
    return [{"W": (rng.normal(size=(d, d)) / np.sqrt(d)).astype(np.float32),
             "b": np.zeros((d,), np.float32)} for _ in range(n_stages)]


def _stage_fn(params, x):
    return jnp.tanh(x @ params["W"] + params["b"])


def _sequential(per_stage, x):
    for p in per_stage:
        x = _stage_fn(p, x)
    return x


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One 4-rank world running every case; the JAX models and inputs
    each case started from."""
    tmp = tmp_path_factory.mktemp("model_axes")
    refs, payload = {}, {"tp_lm": {}, "tp_serve": {}, "tp_net": {},
                         "pipe": {}}
    for key, (mesh, extra) in TP_LM.items():
        cfg = {**DECODE, **extra}
        ref = _jax_lm(cfg)
        refs[key] = ref
        payload["tp_lm"][key] = dict(
            mesh=mesh, cfg=cfg, params=_np(ref.params), prompt=_prompt(),
            new=8, beam_new=6, tokens=_lm_tokens(), decode=True,
            grads=True)
    sref = JaxLM(**SERVE).init()
    refs["serve"] = sref
    sched = jax_schedule(6, 50.0, **SCHEDULE)
    for key, extra in TP_SERVE.items():
        payload["tp_serve"][key] = dict(
            mesh=dict(model=N), cfg=SERVE, params=_np(sref.params),
            slots=2, max_len=64,
            schedule=[dict(arrival_s=a.arrival_s, prompt=a.prompt,
                           max_new_tokens=a.max_new_tokens, seed=a.seed)
                      for a in sched], **extra)
    fleet = dict(mesh=dict(model=N), cfg=SERVE, params=_np(sref.params),
                 max_len=64, requests=_fleet_requests())
    payload["tp_fleet"] = {
        **{f"split:{key}": dict(kind="split", **fleet, **extra)
           for key, extra in TP_SERVE.items()},
        "split:sampled": dict(kind="split", **fleet, **FLEET_SAMPLED),
        "drain:split": dict(kind="split_drain", **fleet),
        "drain:mixed": dict(kind="mixed_drain", **fleet, fuse_steps=2),
        **{f"hedge:{s}": dict(fleet, kind="hedge", scenario=s, slots=1,
                              fuse_steps=2, requests=_hedge_requests())
           for s in HEDGES}}
    for key, extra in TP_CROSS.items():
        cfg = {**SERVE, **extra}
        refs[f"cross:{key}"] = _jax_lm(cfg)
        payload["tp_fleet"][f"cross:{key}"] = dict(
            fleet, kind="cross", cfg=cfg,
            params=_np(refs[f"cross:{key}"].params),
            requests=_fleet_requests()[:2])
    # the served policy: under float32 the CPU's projection GEMMs round a
    # row differently beside others even unsharded
    payload["tp_invariance"] = dict(
        mesh=dict(model=N), cfg={**SERVE, "dtype_policy": "mixed_bf16"},
        params=_np(sref.params), max_len=64)
    payload["tp_checkpoint"] = dict(
        mesh=dict(model=N), cfg=DECODE, params=_np(refs["m4"].params),
        tokens=_lm_tokens(), dir=str(tmp / "ckpt"))
    for kind in TP_NETS:
        net, batches = _net(kind)
        refs[kind] = (net, batches)
        if kind == "graph":
            refs["graph_output"] = net.output(jnp.asarray(batches[0][0]))[0]
        wrapped = kind == "wrapped"   # ParallelWrapper, data=2 x model=2
        payload["tp_net"][kind] = dict(
            mesh=dict(data=2, model=2) if wrapped else dict(model=N),
            wrapper=wrapped, conf=net.conf.to_json(),
            state=(_np(net.params), _np(net.updater_state),
                   _np(net.net_state), net.iteration_count),
            batches=batches, graph=kind == "graph")
    for key in L2_CASES:
        jnet, batches, fields = _l2_net(key)
        refs[key] = (jnet, batches, fields)
        payload["tp_net"][key] = dict(
            state=(_np(jnet.params), _np(jnet.updater_state),
                   _np(jnet.net_state), jnet.iteration_count),
            batches=batches, **fields)
    # a dense pair with dropout against the port's own unsharded fit
    # (the reference's masks come from jax.random, so no JAX fit)
    conf = (JaxNNC.Builder().seed(12).learning_rate(0.1)
            .updater(JaxUpdater.SGD).list()
            .layer(0, jax_L.DenseLayer(n_in=8, n_out=16, activation="tanh",
                                       dropout=0.5))
            .layer(1, jax_L.DenseLayer(n_in=16, n_out=12,
                                       activation="relu", dropout=0.5))
            .layer(2, jax_L.OutputLayer(n_in=12, n_out=3))
            .build())
    net = JaxMLN(conf).init()
    payload["tp_net"]["dropout_pair"] = dict(
        mesh=dict(model=N), wrapper=False, conf=conf.to_json(),
        state=(_np(net.params), _np(net.updater_state), _np(net.net_state),
               net.iteration_count),
        batches=[_toy(32, seed=s) + (None, None) for s in (3, 4)],
        graph=False, unsharded=True)
    for key, (mesh, s) in PIPES.items():
        rng = np.random.default_rng(3)
        x = rng.normal(size=(16, 8)).astype(np.float32)
        y = rng.normal(size=(16, 8)).astype(np.float32)
        payload["pipe"][key] = dict(
            mesh=mesh, stacked=_np(jax_stack(_stages(s, 0))),
            train_stacked=_np(jax_stack(_stages(s, 5))), x=x, y=y,
            micro=8, micro_grad=4)
        refs[key] = s
    cfg = JaxMoEConfig(**MOE)
    rng = np.random.default_rng(2)
    payload["moe"] = dict(
        mesh=dict(data=1, expert=N), cfg=MOE,
        params=_np(jax_init_moe(cfg, jax.random.PRNGKey(0))),
        x=rng.normal(size=(64, 8)).astype(np.float32),
        target=rng.normal(size=(64, 8)).astype(np.float32),
        drop_cfg=DROP,
        drop_params=_np(jax_init_moe(JaxMoEConfig(**DROP),
                                     jax.random.PRNGKey(3))),
        drop_x=np.random.default_rng(4).normal(size=(32, 8)).astype(
            np.float32),
        train_params=_np(jax_init_moe(cfg, jax.random.PRNGKey(5))),
        train_x=np.random.default_rng(6).normal(size=(64, 8)).astype(
            np.float32),
        train_y=np.random.default_rng(16).normal(size=(64, 8)).astype(
            np.float32))
    results = torch_worlds.run_world(
        N, ["tp_lm_cases", "tp_invariance_case", "tp_serve_cases",
            "tp_fleet_cases", "tp_checkpoint_case", "tp_network_cases",
            "pipe_cases", "moe_cases"], payload, str(tmp))
    return refs, payload, results


# ---------------------------------------------------------------------------
# the LM over model and data × model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("key", list(TP_LM))
def test_sharded_generate_and_beam_equal_unsharded(world, key):
    """``TestShardedDecode``: greedy and beam tokens of the sharded LM
    exactly equal the unsharded JAX model's."""
    refs, payload, results = world
    ref, got = refs[key], results["tp_lm_cases"][key]
    prompt = jnp.asarray(_prompt())
    np.testing.assert_array_equal(
        got["greedy"], np.asarray(ref.generate(prompt, max_new_tokens=8)))
    seqs, scores = ref.generate_beam(prompt, max_new_tokens=6, beam_size=3)
    np.testing.assert_array_equal(got["beam"], np.asarray(seqs))
    np.testing.assert_allclose(got["beam_scores"], np.asarray(scores),
                               rtol=1e-5, atol=1e-5)
    want = np.asarray(ref.forward(ref.params,
                                  jnp.asarray(payload["tp_lm"][key]
                                              ["tokens"])))
    np.testing.assert_allclose(got["logits"], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("key", list(TP_LM))
def test_sharded_inference_is_the_unsharded_ports_bytes(world, key):
    """Outside training a TP rank runs the unsharded GEMMs on whole
    weights: in float32, where the CPU's GEMMs are not row-invariant,
    its forward logits and beam scores are still the unsharded port's
    bytes, so no near-tie can part the tokens."""
    got = world[2]["tp_lm_cases"][key]
    assert got["same_logits"] and got["same_beam"]


def test_shards_are_the_megatron_split(world):
    got = world[2]["tp_lm_cases"]
    assert got["m4"]["wq_local"] == (64, 16)       # 2 of 8 heads
    assert got["m4"]["wk_local"] == (64, 8)        # 1 of 4 kv heads
    assert got["gqa2"]["wk_local"] == (64, 16)     # replicated (fallback)
    assert got["d2m2"]["wq_local"] == (64, 32)


@pytest.mark.parametrize("key", list(TP_LM))
def test_sharded_loss_gradients_and_step(world, key):
    refs, payload, results = world
    got = results["tp_lm_cases"][key]
    loss, grads, step_loss, params = _jax_step(payload["tp_lm"][key]["cfg"])
    assert got["loss"] == pytest.approx(loss, rel=2e-3, abs=1e-3)
    want = [np.asarray(g, np.float32)
            for g in jax.tree_util.tree_leaves(grads)]
    assert len(want) == len(got["grads"])
    for a, b in zip(want, got["grads"]):
        np.testing.assert_allclose(b, a, rtol=2e-3, atol=1e-3)
    # one Adam step over the mesh: eager (gloo collectives)
    assert got["captured"] is False
    assert got["step_loss"] == pytest.approx(step_loss, rel=2e-3, abs=1e-3)
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(got["params"])):
        assert np.abs(np.asarray(a, np.float32) - b).max() <= 1e-4


def test_decode_rows_batch_invariant_under_model_axis(world):
    got = world[2]["tp_invariance_case"]
    assert got["equal"]
    assert got["kv_local_heads"] == 1 and got["n_shard"] == N


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
class FakeClock:
    def __init__(self, tick=0.004):
        self.t = 0.0
        self.tick = tick

    def __call__(self):
        self.t += self.tick
        return self.t

    def sleep(self, s):
        self.t += s


@pytest.mark.parametrize("key", list(TP_SERVE))
def test_sharded_server_streams_equal_unsharded(world, key):
    refs, payload, results = world
    got = results["tp_serve_cases"][key]
    case = payload["tp_serve"][key]
    clock = FakeClock()
    srv = JaxServer(refs["serve"], slots=2, max_len=64, clock=clock,
                    kv_dtype=case.get("kv_dtype"),
                    fuse_steps=case.get("fuse_steps", 1))
    report = jax_open_loop(srv, jax_schedule(6, 50.0, **SCHEDULE),
                           clock=clock, sleep=clock.sleep)
    assert report.finished == got["finished"] == 6
    want = {r.prompt.tobytes(): r.output for r in srv.finished}
    assert got["streams"].keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got["streams"][k], want[k])
    assert got["kv_shards"] == N and got["pool_local_heads"] == 1


def _generated(ref, requests):
    return [np.asarray(ref.generate(jnp.asarray(r["prompt"][None]),
                                    max_new_tokens=r["max_new_tokens"]))[0]
            for r in requests]


def _assert_streams(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _assert_whole_slabs(got):
    """Every handoff carried one slot of the whole pool."""
    per_slot = set(got["kv_per_slot_bytes"].values())
    assert len(per_slot) == 1 and set(got["nbytes"]) == per_slot


@pytest.mark.parametrize("key", list(TP_SERVE))
def test_tp_split_fleet_streams_equal_unsharded(world, key):
    """A prefill replica and two decode replicas, each over
    ``model=4``: the prefill exports the ranks' heads gathered, each
    decode rank installs its own, and the greedy streams are the JAX
    model's (an int8 pool's, the JAX int8 server's)."""
    refs, payload, results = world
    case = payload["tp_fleet"][f"split:{key}"]
    got = results["tp_fleet_cases"][f"split:{key}"]
    if key == "int8":
        srv = JaxServer(refs["serve"], slots=2, max_len=64,
                        kv_dtype="int8", fuse_steps=4)
        reqs = [srv.submit(r["prompt"], r["max_new_tokens"])
                for r in case["requests"]]
        srv.drain()
        want = [r.output for r in reqs]
    else:
        want = _generated(refs["serve"], case["requests"])
    _assert_streams(got["streams"], want)
    _assert_whole_slabs(got)
    assert set(got["kv_shards"].values()) == {N}
    assert set(got["placed"]) == {"d0", "d1"}
    assert "step it with step_once alike in every rank" in got["thread"]


def test_tp_sampled_split_fleet_equals_one_device_fleet(world):
    """Sampled, with deadlines the followers' clocks pass at their first
    read: the TP fleet's streams are the port's one-device split
    fleet's, and nothing is shed (rank 0's clock decides)."""
    refs, payload, results = world
    case = payload["tp_fleet"]["split:sampled"]
    got = results["tp_fleet_cases"]["split:sampled"]
    lm = torch_worlds._lm(case["cfg"], case["params"])
    clock = torch_worlds._rank_clock(0)
    reps, router = torch_worlds._fleet(
        [("p0", "prefill", lm, None), ("d0", "decode", lm, None),
         ("d1", "decode", lm, None)], clock,
        **torch_worlds._server_kw(case))
    frs = [router.submit(r["prompt"], r["max_new_tokens"], seed=r["seed"],
                         deadline_s=case["deadline_s"])
           for r in case["requests"]]
    torch_worlds._drive(router, reps)
    _assert_streams(got["streams"], [fr.output for fr in frs])
    assert got["placed"] == [fr.replica_id for fr in frs]
    assert got["shed"] == 0
    _assert_whole_slabs(got)


@pytest.mark.parametrize("key", ["split", "mixed"])
def test_tp_drain_migrates_with_zero_recompute(world, key):
    """``FleetController.drain`` of a TP decode replica mid-stream: its
    live slots export (the ranks' heads gathered) and install on the TP
    survivor, its handed-off slab (split fleet) or queued request (mixed
    fleet, built by ``FleetRouter.build`` under ``DL4J_TP_SHARDS``)
    moves, nothing falls back to re-prefill, every stream keeps its
    emitted prefix and equals the undrained greedy stream."""
    refs, payload, results = world
    case = payload["tp_fleet"][f"drain:{key}"]
    got = results["tp_fleet_cases"][f"drain:{key}"]
    d = got["decision"]
    assert d["fallback_failovers"] == 0 and d["dropped_hedges"] == 0
    assert d["migrated"] == d["live"] + d["queued"] + d["handoffs"]
    if key == "split":
        assert got["placed"] == ["d0", "d0", "d0", "d1", "d0"]
        assert (d["live"], d["handoffs"], d["queued"]) == (3, 1, 0)
        assert got["retired"]
        requests = case["requests"][:5]
    else:   # FleetRouter.build under DL4J_TP_SHARDS=4
        assert got["placed"] == ["replica-0"] * 3
        assert set(got["kv_shards"].values()) == {N}
        assert (d["live"], d["handoffs"], d["queued"]) == (2, 0, 1)
        requests = case["requests"][:3]
    want = _generated(refs["serve"], requests)
    _assert_streams(got["streams"], want)
    for stream, r, before in zip(want, requests, got["emitted"]):
        new = stream[len(r["prompt"]):]
        assert list(new[:len(before)]) == before
    _assert_whole_slabs(got)


@pytest.mark.parametrize("key", list(TP_CROSS))
def test_tp_handoff_across_layouts(world, key):
    """Slabs from a TP prefill replica into a one-device decode replica
    and from a one-device prefill replica into a TP decode replica, on a
    pool split over ``model`` (m4: one KV head a rank) and on one the
    GQA fallback replicates (gqa2): greedy streams equal the JAX
    model's, and the TP export holds a one-device prefill's bytes."""
    refs, payload, results = world
    case = payload["tp_fleet"][f"cross:{key}"]
    got = results["tp_fleet_cases"][f"cross:{key}"]
    want = _generated(refs[f"cross:{key}"], case["requests"])
    for name in ("tp_to_one", "one_to_tp"):
        _assert_streams(got[name]["streams"], want)
        _assert_whole_slabs(got[name])
    assert got["slab_bytes_equal"] == [True, True]
    split = key == "m4"
    assert got["pool_local_heads"] == (1 if split else 2)
    assert got["tp_to_one"]["kv_shards"] == {"p0": N if split else 1,
                                             "d0": 1}
    assert got["one_to_tp"]["kv_shards"] == {"p1": 1,
                                             "d1": N if split else 1}


@pytest.mark.parametrize("scenario", HEDGES)
def test_tp_hedge_under_skewed_clocks(world, scenario):
    """Hedging in a fleet of two mixed TP replicas whose followers'
    clocks run 1e7 s a read ahead of rank 0's: every rank times the
    queued request on rank 0's clock, so the TP fleet hedges, withdraws
    the losing copy and counts the win as the port's one-device fleet
    does on rank 0's clock, and the streams are the JAX model's."""
    refs, payload, results = world
    case = payload["tp_fleet"][f"hedge:{scenario}"]
    got = dict(results["tp_fleet_cases"][f"hedge:{scenario}"])
    want = torch_worlds._tp_hedge(0, {**case, "tp": False})
    streams = got.pop("streams")
    _assert_streams(streams, want.pop("streams"))
    _assert_streams(streams, _generated(refs["serve"], case["requests"]))
    assert got == want
    assert got["hedges"] == [0, 1, 0] and got["hedge_log"] == 1
    assert (got["primary"], got["hedge"]) == ("r0", "r1")
    win = scenario == "win"
    assert got["settled"] == ("r1" if win else "r0", True, int(win))
    assert got["finished"] == [True, True, True]


def test_tp_checkpoint_round_trip(world):
    got = world[2]["tp_checkpoint_case"]
    assert got["same_params"] and got["same_state"]
    assert got["step_count"] == 1 and got["wq_local"] == (64, 16)


# ---------------------------------------------------------------------------
# networks
# ---------------------------------------------------------------------------
def test_tp_mlp_output_matches_replicated(world):
    refs, payload, results = world
    net, batches = refs["tp_mlp"]
    got = results["tp_network_cases"]["tp_mlp"]
    want = np.asarray(net.output(jnp.asarray(batches[0][0])))
    np.testing.assert_allclose(got["output"], want, rtol=1e-5, atol=1e-6)
    # a column layer with no row partner runs on gathered weights
    assert got["kinds"] == {"0": "_Gathered", "1": "OutputImpl"}


@pytest.mark.parametrize("kind", TP_NETS)
def test_tp_network_fit_matches_unsharded(world, kind):
    refs, payload, results = world
    net, batches = refs[kind]
    got = results["tp_network_cases"][kind]
    for b in batches:
        net.fit(JaxDataSet(*b))   # a graph takes a DataSet too
    # Adam's first steps move a weight by about ±lr whatever its
    # gradient's size, so a near-zero gradient's rounding shows at up to
    # lr: the Adam networks' params take the training parity's atol 1e-4
    atol = 1e-5 if kind == "tp_mlp" else 1e-4
    for a, b in zip(jax.tree_util.tree_leaves(net.params),
                    jax.tree_util.tree_leaves(got["params"])):
        np.testing.assert_allclose(b, np.asarray(a), rtol=2e-4, atol=atol)
    for a, b in zip(jax.tree_util.tree_leaves(net.updater_state),
                    jax.tree_util.tree_leaves(got["updater"])):
        np.testing.assert_allclose(b, np.asarray(a), rtol=2e-4, atol=1e-5)
    if kind in ("pair_mlp", "wrapped"):
        assert got["kinds"] == {"0": "_ColumnDense", "1": "_RowDense",
                                "2": "OutputImpl"}
    if kind == "graph":
        assert got["kinds"] == {"d0": "_ColumnDense", "d1": "_RowDense",
                                "out": "OutputImpl"}
        np.testing.assert_allclose(
            got["output"], np.asarray(refs["graph_output"]), rtol=1e-5,
            atol=1e-6)


def test_tp_dense_pair_dropout_matches_unsharded_fit(world):
    """The row layer of a split pair draws the unsharded layer's mask
    over the whole input and keeps its own columns: two fits with
    dropout on both layers equal the port's unsharded fit."""
    got = world[2]["tp_network_cases"]["dropout_pair"]
    assert got["kinds"] == {"0": "_ColumnDense", "1": "_RowDense",
                            "2": "OutputImpl"}
    want = jax.tree_util.tree_leaves(got["unsharded_params"])
    have = jax.tree_util.tree_leaves(got["params"])
    assert len(want) == len(have)
    for a, b in zip(want, have):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("key", L2_CASES)
def test_tp_l2_normalization_matches_unsharded(world, key):
    """Gradient normalization by L2 norms on model-split layers (column
    and row dense pairs, a gathered convolution and dense layer, LSTM
    gates, a graph's pair; through ``ParallelWrapper`` and ``fit_epochs``
    over ``data=2 x model=2``, and ``fit_steps``): the norms span each
    whole layer or leaf, so the params equal the JAX network's
    unsharded run."""
    refs, payload, results = world
    jnet, batches, fields = refs[key]
    got = results["tp_network_cases"][key]
    hist = _l2_fit(jnet, batches, fields)
    want = jax.tree_util.tree_leaves(jnet.params)
    have = jax.tree_util.tree_leaves(got["params"])
    assert len(want) == len(have)
    for a, b in zip(want, have):
        np.testing.assert_allclose(b, np.asarray(a), **L2_TOL)
    if hist is not None:
        np.testing.assert_allclose(got["hist"], hist, **L2_TOL)
    split = {"_ColumnDense", "_RowDense", "_Gathered"}
    assert split & set(got["kinds"].values())


def test_l2_normalization_moves_the_result_beyond_the_gate(world):
    """The control: the same net's run with L2 clipping and without part
    by at least 10x the parity gate, so the gate sees the norm."""
    got = world[2]["tp_network_cases"]
    clipped = jax.tree_util.tree_leaves(got["pair_mlp:ClipL2PerLayer"]
                                        ["params"])
    plain = jax.tree_util.tree_leaves(got["pair_mlp:None"]["params"])
    ratio = max(float(np.max(np.abs(a - b) / (L2_TOL["atol"]
                                              + L2_TOL["rtol"] * np.abs(b))))
                for a, b in zip(clipped, plain))
    assert ratio >= 10.0, ratio


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("key", list(PIPES))
def test_pipeline_matches_sequential(world, key):
    refs, payload, results = world
    case, got = payload["pipe"][key], results["pipe_cases"][key]
    s = refs[key]
    per_stage = _stages(s, 0)
    x, y = jnp.asarray(case["x"]), jnp.asarray(case["y"])
    np.testing.assert_allclose(got["out"], np.asarray(_sequential(
        per_stage, x)), rtol=1e-5, atol=1e-6)
    stacked = jax_stack(per_stage)

    def seq_loss(p):
        h = x
        for i in range(s):
            h = _stage_fn(jax.tree_util.tree_map(lambda a: a[i], p), h)
        return jnp.mean((h - y) ** 2)

    g = jax.grad(seq_loss)(stacked)
    np.testing.assert_allclose(got["grads"][0], np.asarray(g["W"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["grads"][1], np.asarray(g["b"]),
                               rtol=1e-4, atol=1e-5)
    losses = got["losses"]
    assert losses[-1] < losses[0]
    assert losses[0] == pytest.approx(
        float(seq_loss(jax_stack(_stages(s, 5)))), rel=1e-5)


# ---------------------------------------------------------------------------
# experts
# ---------------------------------------------------------------------------
def test_moe_sharded_matches_unsharded(world):
    refs, payload, results = world
    case, got = payload["moe"], results["moe_cases"]
    cfg = JaxMoEConfig(**MOE)
    params = jax.tree_util.tree_map(jnp.asarray, case["params"])
    x, target = jnp.asarray(case["x"]), jnp.asarray(case["target"])
    y, aux = jax_moe_ffn(params, x, cfg)
    np.testing.assert_allclose(got["y"], np.asarray(y), rtol=1e-4,
                               atol=1e-5)
    assert got["aux"] == pytest.approx(float(aux), rel=1e-4)

    def loss(p):
        o, a = jax_moe_ffn(p, x, cfg)
        return jnp.mean((o - target) ** 2) + a

    g = jax.jit(jax.grad(loss))(params)
    for k in ("Wg", "W1", "b1", "W2", "b2"):
        np.testing.assert_allclose(got["grads"][k], np.asarray(g[k]),
                                   rtol=1e-4, atol=1e-5)


def test_moe_dropped_tokens_and_training(world):
    refs, payload, results = world
    case, got = payload["moe"], results["moe_cases"]
    y, _ = jax_moe_ffn(jax.tree_util.tree_map(jnp.asarray,
                                              case["drop_params"]),
                       jnp.asarray(case["drop_x"]), JaxMoEConfig(**DROP))
    assert np.isfinite(got["dropped"]).all()
    np.testing.assert_allclose(got["dropped"], np.asarray(y), rtol=1e-4,
                               atol=1e-5)
    assert got["losses"][-1] < got["losses"][0]
