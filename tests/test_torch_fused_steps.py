"""Port parity for the fused step paths and the CUDA-graph machinery
behind them (``perf/step_graph.py``, ``nn/fused.py``): ``fit_steps`` on
both network classes, the TBPTT window scan and the LM's
``make_multi_train_step``, against ``deeplearning4j_tpu``'s fused
programs on the same weights and data.

Tolerances: float32 rtol 1e-4 / atol 1e-6 on losses and params (the
LM: its training gates, losses 1e-5 and params 1e-4 absolute), ``bf16``
and ``mixed_bf16`` 2e-2 / 1e-2. Inside the port the fused paths equal
the per-step loops bit for bit. On the CPU every step runs eagerly; the
warm-up, capture and replay sequence and its kernel-launch accounting
are exercised with a stand-in for the CUDA graph API."""

import contextlib

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.models import transformer as jax_tm
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxCG
from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.kernels import flash_attention as fa
from deeplearning4j_tpu_torch.models import transformer as tm
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.models.convert import (
    load_network_from_jax,
    params_from_jax,
)
from deeplearning4j_tpu_torch.nn import ComputationGraph
from deeplearning4j_tpu_torch.perf import step_graph

from test_torch_epoch_cache import JAX, PORT, graph_conf

TOL = {"float32": dict(rtol=1e-4, atol=1e-6),
       "bf16": dict(rtol=2e-2, atol=1e-2),
       "mixed_bf16": dict(rtol=2e-2, atol=1e-2)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _carry(ref, port):
    return load_network_from_jax(port, _np(ref.params),
                                 _np(ref.updater_state), _np(ref.net_state),
                                 ref.iteration_count)


def _close_trees(port_tree, ref_tree, tol):
    got = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t: t.detach().float().numpy(), port_tree))
    want = jax.tree_util.tree_leaves(_np(ref_tree))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), **tol)


def _equal_trees(a, b):
    la, lb = dtypes.tree_leaves(a), dtypes.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _mlp_data(batch=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((batch, 784), np.float32)
    return x, np.eye(10, dtype=np.float32)[rng.integers(0, 10, batch)]


def _seq(batch=3, t=20, vocab=10, seed=4):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, vocab, (batch, t))
    eye = np.eye(vocab, dtype=np.float32)
    return eye[idx], eye[np.roll(idx, -1, axis=1)]


# ---------------------------------------------------------------------------
# fit_steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["float32", "bf16"])
def test_mln_fit_steps_matches_jax(policy):
    ref = jax_zoo.mnist_mlp(hidden=32, dtype_policy=policy).init()
    port = _carry(ref, zoo.mnist_mlp(hidden=32, dtype_policy=policy,
                                     device="cpu"))
    x, y = _mlp_data()
    ref.fit_steps(JaxDataSet(x, y), 4)
    port.fit_steps(DataSet(x, y), 4)
    np.testing.assert_allclose(port.score_value, ref.score_value,
                               **TOL[policy])
    _close_trees(port.params, ref.params, TOL[policy])
    _close_trees(port.updater_state, ref.updater_state, TOL[policy])
    assert port.iteration_count == ref.iteration_count == 4
    assert port._train_dispatches == 4


def test_graph_fit_steps_matches_jax():
    ref = JaxCG(graph_conf(JAX)).init()
    port = _carry(ref, ComputationGraph(graph_conf(PORT), device="cpu"))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(16, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    ref.fit_steps(JaxMDS([x], [y]), 5)
    port.fit_steps(MultiDataSet([x], [y]), 5)
    np.testing.assert_allclose(port.score_value, ref.score_value,
                               **TOL["float32"])
    _close_trees(port.params, ref.params, TOL["float32"])
    assert port.iteration_count == ref.iteration_count == 5


def test_fused_steps_read_the_live_state_at_every_call():
    """Static buffers are copied in per call: params set between calls
    (``set_flat_params``) are the ones the next call trains."""
    a = zoo.mnist_mlp(hidden=16, device="cpu").init()
    b = zoo.mnist_mlp(hidden=16, device="cpu").init()
    x, y = _mlp_data(8)
    a.fit_steps(DataSet(x, y), 2)
    flat = a.get_flat_params() * 0.5
    a.set_flat_params(flat)
    b.set_flat_params(flat)
    b.updater_state = dtypes.tree_map(torch.clone, a.updater_state)
    b.iteration_count = a.iteration_count
    b._rng.set_state(a._rng.get_state())  # the zoo MLP has dropout
    a.fit_steps(DataSet(x, y), 2)
    for _ in range(2):
        b.fit(DataSet(x, y))
    assert _equal_trees((a.params, a.updater_state),
                        (b.params, b.updater_state))


def test_program_and_static_state_follow_the_structure():
    net = zoo.mnist_mlp(hidden=16, device="cpu").init()
    x, y = _mlp_data(8)
    net.fit_steps(DataSet(x, y), 1)
    net.fit_steps(DataSet(x, y), 1)
    st = net._static
    assert len(net._programs) == 1 and net._fused_state() is st
    net.fit_steps(DataSet(*_mlp_data(4)), 1)  # another batch shape
    assert len(net._programs) == 2
    net._policy = dtypes.FLOAT64  # another policy drops them all
    assert net._fused_state() is not st and not net._programs


# ---------------------------------------------------------------------------
# TBPTT: the full windows through one window step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["float32", "bf16"])
def test_fused_tbptt_matches_jax(policy):
    kw = dict(vocab_size=10, hidden=8, layers=2, tbptt_length=6, seed=11,
              dtype_policy=policy)
    ref = jax_zoo.char_lstm(**kw).init()
    port = _carry(ref, zoo.char_lstm(device="cpu", **kw))
    x, y = _seq()
    for _ in range(2):  # 3 full windows and a tail of 2 per fit
        ref.fit(JaxDataSet(x, y))
        port.fit(DataSet(x, y))
    np.testing.assert_allclose(port.score_value, ref.score_value,
                               **TOL[policy])
    _close_trees(port.params, ref.params, TOL[policy])
    assert port.iteration_count == ref.iteration_count == 8
    prog = port._programs[next(k for k in port._programs
                               if k[0] == "tbptt")]
    assert prog.graph.eager_calls == 6  # the full windows, on the CPU
    assert port._train_dispatches == 8


def _lstm_graph(pkg, tbptt=4):
    conf, Lm, Em, Loss = pkg
    return (conf.NeuralNetConfiguration.Builder().seed(0).learning_rate(0.01)
            .updater(conf.Updater.ADAM).graph_builder()
            .add_inputs("in")
            .add_layer("lstm", Lm.GravesLSTM(n_in=10, n_out=8,
                                             activation="tanh"), "in")
            .add_layer("out", Lm.RnnOutputLayer(
                n_in=8, n_out=10, loss_function=Loss.MCXENT), "lstm")
            .set_outputs("out")
            .backprop_type(Em.BackpropType.TRUNCATED_BPTT)
            .t_bptt_forward_length(tbptt).t_bptt_backward_length(tbptt)
            .build())


def test_graph_fused_tbptt_matches_jax():
    ref = JaxCG(_lstm_graph(JAX)).init()
    port = _carry(ref, ComputationGraph(_lstm_graph(PORT), device="cpu"))
    x, y = _seq(t=18)
    ref.fit(JaxMDS([x], [y]))
    port.fit(MultiDataSet([x], [y]))
    np.testing.assert_allclose(port.score_value, ref.score_value,
                               **TOL["float32"])
    _close_trees(port.params, ref.params, TOL["float32"])
    assert port.iteration_count == ref.iteration_count == 5
    assert port._train_dispatches == 5


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_fused_tbptt_equals_the_window_loop_bitwise(kind):
    """A listener makes the reference's condition fail, so that network
    walks every window eagerly; the results are the same bits."""
    def build():
        if kind == "mln":
            return zoo.char_lstm(vocab_size=10, hidden=8, layers=2,
                                 tbptt_length=6, seed=11, device="cpu").init()
        return ComputationGraph(_lstm_graph(PORT, tbptt=6),
                                device="cpu").init()

    class Listener:
        def iteration_done(self, net, it):
            pass

    fused, loop = build(), build()
    loop.set_listeners(Listener())
    x, y = _seq()
    for _ in range(2):
        fused.fit(DataSet(x, y))
        loop.fit(DataSet(x, y))
    assert fused.score_value == loop.score_value
    assert _equal_trees((fused.params, fused.updater_state),
                        (loop.params, loop.updater_state))
    assert any(k[0] == "tbptt" for k in fused._programs)
    assert not loop._programs


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------
LM_CFG = dict(vocab_size=64, d_model=128, num_heads=2, num_layers=2,
              max_len=64, seed=0, attn_impl="flash")


@pytest.mark.parametrize("policy", ["float32", "mixed_bf16"])
def test_multi_train_step_matches_jax(policy):
    ref = jax_tm.TransformerLM(**LM_CFG, dtype_policy=policy).init()
    port = tm.TransformerLM(**LM_CFG, dtype_policy=policy, device="cpu")
    port.params = params_from_jax(_np(ref.params))
    port.opt_state = params_from_jax(_np(ref.opt_state))
    tok = np.random.default_rng(0).integers(0, 64, (2, 40)).astype(np.int32)
    want = ref.fit_batch_multi(tok, multi_step=ref.make_multi_train_step(3),
                               k=3)
    got = port.fit_batch_multi(tok, multi_step=port.make_multi_train_step(3),
                               k=3)
    assert port.step_count == ref.step_count == 3
    if policy == "float32":
        assert abs(got - want) <= 1e-5
        tol = dict(rtol=0, atol=1e-4)
    else:
        assert abs(got - want) <= 2e-2
        tol = dict(rtol=0, atol=1e-2)
    _close_trees(port.params, ref.params, tol)


def test_lm_step_functions_share_one_graph_pool():
    """Every program of every step function of one LM captures into the
    LM's one pool; another LM has its own."""
    lm = tm.TransformerLM(**LM_CFG, device="cpu").init()
    tok = np.random.default_rng(1).integers(0, 64, (2, 16))
    multi = lm.make_multi_train_step(2)
    lm.fit_batch(tok)
    lm.fit_batch_multi(tok, multi_step=multi, k=2)
    lm.fit_batch_multi(tok[:1], multi_step=multi, k=2)  # a second shape
    progs = (list(lm._default_step.programs.values())
             + list(multi.programs.values()))
    assert len(progs) == 3
    assert all(p.graph.pool is lm._graph_pool for p in progs)
    other = tm.TransformerLM(**LM_CFG, device="cpu")
    assert other._graph_pool is not lm._graph_pool


def test_lm_step_counter_and_loss_live_on_the_device():
    lm = tm.TransformerLM(**LM_CFG, device="cpu").init()
    tok = np.random.default_rng(1).integers(0, 64, (2, 16))
    first = lm.fit_batch(tok, block=False)
    second = lm.fit_batch(tok, block=False)
    assert isinstance(first, torch.Tensor) and first.ndim == 0
    assert float(first) != float(second)  # not one aliased buffer
    prog = next(iter(lm._default_step.programs.values()))
    assert int(prog.step) == lm.step_count == 2
    assert prog.graph.eager_calls == 2  # the CPU runs the same step
    # what the step returned is the program's own state: no copy in
    assert dtypes.tree_leaves(lm.params)[0] is \
        dtypes.tree_leaves(prog.params)[0]


# ---------------------------------------------------------------------------
# StepGraph: warm-up, capture, replays; launch accounting
# ---------------------------------------------------------------------------
class _FakeGraph:
    def __init__(self):
        self.replays = 0
        self.generators = []

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        self.replays += 1


class _FakeStream:
    def wait_stream(self, other):
        pass


def test_step_graph_warms_up_captures_once_and_replays(monkeypatch):
    """The CUDA graph API replaced by stand-ins: the step runs twice (the
    warm-up, then the capture, which records), every later call replays,
    and the kernel launches count the warm-up and each replay, not the
    capture."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    pools = []

    def graph(g, pool=None):
        pools.append(pool)
        return contextlib.nullcontext()

    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: ("pool",))
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    step_graph.reset_kernel_launches()
    ran = []

    def step():
        ran.append(1)
        fa.flash_attention_fwd.launches += 1  # what a wrapper counts
        fa.flash_attention_bwd_dq.launches += 2

    pool = step_graph.GraphPool()
    g = step_graph.StepGraph(step, "cpu", pool=pool)
    assert not g.graphed
    g.graphed = True  # as on a card
    for _ in range(5):
        g()
    assert len(ran) == 2 and g.eager_calls == 1 and g.captures == 1
    assert g.replays == 4 and g.graph.replays == 4
    # a second graph of the same owner captures into the same pool
    h = step_graph.StepGraph(lambda: None, "cpu", pool=pool)
    h.graphed = True
    h(), h()
    assert pools == [("pool",), ("pool",)] and pool.handle == ("pool",)
    assert g.recorded == {"flash_attention_fwd": 1,
                          "flash_attention_bwd_dq": 2}
    assert step_graph.kernel_launches() == {
        "flash_attention_fwd": 5, "flash_attention_bwd_dkdv": 0,
        "flash_attention_bwd_dq": 10}
    step_graph.reset_kernel_launches()
    assert set(step_graph.kernel_launches().values()) == {0}
    # the test seam: every call of a card's graph runs eagerly
    monkeypatch.setattr(step_graph, "_capture", False)
    g()
    assert len(ran) == 3 and g.eager_calls == 2 and g.replays == 4


def test_static_tree_helpers():
    a = {"w": torch.zeros(2), "b": {"x": torch.zeros(3)}}
    b = {"b": {"x": torch.arange(3.0)}, "w": torch.ones(2)}  # other order
    step_graph.copy_tree_(a, b)
    assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"]["x"],
                                                       b["b"]["x"])
    assert step_graph.tree_signature(a) == step_graph.tree_signature(b)
    with pytest.raises(ValueError, match="keys differ"):
        step_graph.copy_tree_(a, {"w": torch.ones(2)})
    clone = step_graph.static_clone(a)
    assert step_graph.tree_signature(clone) == step_graph.tree_signature(a)
    assert clone["w"] is not a["w"]
