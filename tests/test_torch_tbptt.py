"""Port parity for truncated BPTT and ``rnn_time_step`` on both network
classes, against ``deeplearning4j_tpu`` with the JAX network's params,
Adam state and iteration count carried over by
``models/convert.load_network_from_jax``; seeded numpy one-hot sequences
(the char-LSTM's shape: ``y`` is ``x`` shifted by one step).

Tolerances: float32 losses, params and Adam ``m``/``v`` at rtol 1e-4 /
atol 1e-6 (the JAX network fuses its full TBPTT windows into one scanned
program, the port loops over them; the sums are the same up to order);
``bf16`` and ``mixed_bf16`` at 2e-2 / 1e-2, the reference's gates for
bf16 training. Port-internal equalities (one window against standard
BPTT, ``fit_steps`` against ``fit``) are held bit for bit."""

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn import conf as jax_conf
from deeplearning4j_tpu.nn.conf import graph as jax_graph_conf
from deeplearning4j_tpu.nn.conf import layers as jax_L
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.ops.losses import LossFunction as JaxLoss
from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.models.convert import load_network_from_jax
from deeplearning4j_tpu_torch.nn import ComputationGraph, MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import conf as port_conf
from deeplearning4j_tpu_torch.nn.conf import graph as port_graph_conf
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.enums import BackpropType
from deeplearning4j_tpu_torch.ops.losses import LossFunction

VOCAB, HIDDEN, WINDOW = 10, 8, 6


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _carry(ref, port):
    return load_network_from_jax(port, _np(ref.params),
                                 _np(ref.updater_state), _np(ref.net_state),
                                 ref.iteration_count)


def _seq(batch=3, t=20, vocab=VOCAB, seed=4):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, vocab, (batch, t))
    x = np.eye(vocab, dtype=np.float32)[idx]
    y = np.eye(vocab, dtype=np.float32)[np.roll(idx, -1, axis=1)]
    return x, y


def _char_pair(policy="float32", layers=2, tbptt=WINDOW):
    kw = dict(vocab_size=VOCAB, hidden=HIDDEN, layers=layers,
              tbptt_length=tbptt, seed=11, dtype_policy=policy)
    ref = jax_zoo.char_lstm(**kw).init()
    return ref, _carry(ref, zoo.char_lstm(device="cpu", **kw))


def _assert_trees(port, ref, rtol, atol):
    pairs = [(port.params, ref.params),
             (port.updater_state, ref.updater_state)]
    for got, want in pairs:
        got = jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(lambda t: t.float().numpy(), got))
        for a, b in zip(got, jax.tree_util.tree_leaves(_np(want)),
                        strict=True):
            np.testing.assert_allclose(a, np.asarray(b, np.float32),
                                       rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# MultiLayerNetwork
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy,rtol,atol", [
    ("float32", 1e-4, 1e-6), ("bf16", 2e-2, 1e-2),
    ("mixed_bf16", 2e-2, 1e-2)], ids=["f32", "bf16", "mixed_bf16"])
def test_tbptt_fit_matches(policy, rtol, atol):
    """t 20 in windows of 6: 3 full windows and a tail of 2, so one
    ``fit`` is 4 Adam steps; two ``fit`` calls."""
    ref, port = _char_pair(policy)
    x, y = _seq(t=20)
    for _ in range(2):
        ref.fit(JaxDataSet(x, y))
        port.fit(DataSet(x, y))
        np.testing.assert_allclose(port.score_value, ref.score_value,
                                   rtol=rtol, atol=atol)
    assert port.iteration_count == ref.iteration_count == 8
    _assert_trees(port, ref, rtol, atol)


def test_one_window_equals_standard_bptt():
    """A window as long as the series takes the standard step, bit for
    bit, and both equal the reference's standard step."""
    x, y = _seq(t=12)
    ref, tb = _char_pair(tbptt=12)
    _, std = _char_pair(tbptt=12)
    std.conf.backprop_type = BackpropType.STANDARD
    tb.fit(DataSet(x, y))
    std.fit(DataSet(x, y))
    ref.fit(JaxDataSet(x, y))
    assert tb.iteration_count == std.iteration_count == 1
    for k, v in std.get_param_table().items():
        np.testing.assert_array_equal(tb.get_param_table()[k], v)
    _assert_trees(tb, ref, 1e-4, 1e-6)


def test_listeners_fire_once_per_window():
    """Each step of each window is an iteration: at t 12 in windows of 6
    and ``iterations=2``, two ``fit`` calls make the listener see 1 … 8,
    with the reference's scores."""
    seen = {"ref": [], "port": []}

    def listener(key):
        class Rec:
            def iteration_done(self, net, it):
                seen[key].append((it, net.score_value))
        return Rec()

    kw = dict(vocab_size=VOCAB, hidden=HIDDEN, layers=1, tbptt_length=WINDOW,
              seed=11)
    ref = jax_zoo.char_lstm(**kw)
    ref.conf.global_conf.iterations = 2
    ref.init()
    port = zoo.char_lstm(device="cpu", **kw)
    port.conf.global_conf.iterations = 2
    _carry(ref, port)
    ref.set_listeners(listener("ref"))
    port.set_listeners(listener("port"))
    x, y = _seq(t=12)
    for _ in range(2):
        ref.fit(JaxDataSet(x, y))
        port.fit(DataSet(x, y))
    assert [i for i, _ in seen["port"]] == [i for i, _ in seen["ref"]] \
        == list(range(1, 9))
    np.testing.assert_allclose([s for _, s in seen["port"]],
                               [s for _, s in seen["ref"]], rtol=1e-4,
                               atol=1e-6)
    _assert_trees(port, ref, 1e-4, 1e-6)


def _masks(batch=3, t=20):
    """Features and labels masked alike: a hole and ragged tails that end
    inside the second window and inside the tail."""
    m = np.ones((batch, t), np.float32)
    m[1, 3] = 0.0
    m[1, 9:] = 0.0
    m[2, 19:] = 0.0
    return m


def test_masks_run_through_tbptt():
    ref, port = _char_pair()
    x, y = _seq(t=20)
    m = _masks()
    ref.fit(JaxDataSet(x, y, m, m))
    port.fit(DataSet(x, y, m, m))
    np.testing.assert_allclose(port.score_value, ref.score_value, rtol=1e-4,
                               atol=1e-6)
    assert port.iteration_count == ref.iteration_count == 4
    _assert_trees(port, ref, 1e-4, 1e-6)


def _rnn_mln(layer):
    def build(nnc, Lmod, bp):
        return (nnc.Builder().seed(3).learning_rate(0.05).list()
                .layer(0, layer(Lmod))
                .layer(1, Lmod.RnnOutputLayer(n_in=7, n_out=VOCAB))
                .backprop_type(bp.TRUNCATED_BPTT)
                .t_bptt_forward_length(WINDOW)
                .t_bptt_backward_length(WINDOW).build())

    from deeplearning4j_tpu_torch.nn.conf import enums as port_enums
    from deeplearning4j_tpu.nn.conf import enums as jax_enums

    ref = JaxMLN(build(jax_conf.NeuralNetConfiguration, jax_L,
                       jax_enums.BackpropType)).init()
    port = MultiLayerNetwork(build(port_conf.NeuralNetConfiguration, L,
                                   port_enums.BackpropType), device="cpu")
    return ref, _carry(ref, port)


STATEFUL = {
    "GRU": lambda M: M.GRU(n_in=VOCAB, n_out=7),
    "LSTM": lambda M: M.LSTM(n_in=VOCAB, n_out=7),
    "ImageLSTM": lambda M: M.ImageLSTM(n_in=VOCAB, n_out=7, hidden_size=5),
    "GravesBidirectionalLSTM": lambda M: M.GravesBidirectionalLSTM(
        n_in=VOCAB, n_out=7),
}


@pytest.mark.parametrize("kind", list(STATEFUL))
def test_tbptt_carries_each_layer_kind(kind):
    """GRU threads ``h``, LSTM and ImageLSTM ``h`` and ``c`` (at
    ``hidden_size``) across windows; the bidirectional LSTM carries
    nothing. Each against the reference after one ``fit``."""
    ref, port = _rnn_mln(STATEFUL[kind])
    state = port._zero_rnn_state(2)
    want = ref._zero_rnn_state(2)
    assert (None if state is None else {
        k: {n: tuple(v.shape) for n, v in s.items()}
        for k, s in state.items()}) == (None if want is None else {
            k: {n: tuple(v.shape) for n, v in s.items()}
            for k, s in want.items()})
    x, y = _seq(t=20)
    ref.fit(JaxDataSet(x, y))
    port.fit(DataSet(x, y))
    assert port.iteration_count == ref.iteration_count == 4
    np.testing.assert_allclose(port.score_value, ref.score_value, rtol=1e-4,
                               atol=1e-6)
    _assert_trees(port, ref, 1e-4, 1e-6)


def test_rnn_time_step_matches_full_sequence():
    """Stepwise equals the full-sequence output, and equals the
    reference's ``rnn_time_step``; a 2-D input gives a 2-D output."""
    ref, port = _char_pair()
    x, _ = _seq(batch=3, t=9, seed=2)
    full = port.output(x).numpy()
    steps = []
    for i in range(x.shape[1]):
        out = port.rnn_time_step(x[:, i])
        assert out.shape == (3, VOCAB)
        want = np.asarray(ref.rnn_time_step(x[:, i]))
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-4, atol=1e-6)
        steps.append(out.numpy())
    np.testing.assert_allclose(np.stack(steps, 1), full, rtol=1e-5,
                               atol=1e-6)
    # a 3-D call carries on from the same state
    port.rnn_clear_previous_state()
    ref.rnn_clear_previous_state()
    a = port.rnn_time_step(x[:, :4]).numpy()
    b = port.rnn_time_step(x[:, 4:]).numpy()
    np.testing.assert_allclose(np.concatenate([a, b], 1), full, rtol=1e-5,
                               atol=1e-6)


def test_rnn_time_step_clear_resets():
    """tests/test_regressions.py:85: state carries between calls; a clear
    brings back the first call's output."""
    _, port = _char_pair(layers=1)
    x = np.ones((3, VOCAB), np.float32)
    first = port.rnn_time_step(x).numpy()
    second = port.rnn_time_step(x).numpy()
    assert np.abs(second - first).max() > 1e-6
    port.rnn_clear_previous_state()
    np.testing.assert_array_equal(port.rnn_time_step(x).numpy(), first)


def test_fit_steps_falls_back_to_fit_under_tbptt():
    _, a = _char_pair()
    _, b = _char_pair()
    x, y = _seq(t=20)
    a.fit_steps(DataSet(x, y), 2)
    for _ in range(2):
        b.fit(DataSet(x, y))
    assert a.iteration_count == b.iteration_count == 8
    for k, v in a.get_param_table().items():
        np.testing.assert_array_equal(b.get_param_table()[k], v)


# ---------------------------------------------------------------------------
# ComputationGraph (tests/test_graph_rnn.py's cases)
# ---------------------------------------------------------------------------


def _rnn_graph(module, Lmod, enums, loss, *, tbptt=8,
               backprop="TruncatedBPTT", updater="SGD", seed=0):
    g = (module.NeuralNetConfiguration.Builder()
         .seed(seed).learning_rate(0.01)
         .updater(getattr(module.Updater, updater))
         .graph_builder()
         .add_inputs("in")
         .add_layer("lstm", Lmod.GravesLSTM(n_in=12, n_out=8,
                                            activation="tanh"), "in")
         .add_layer("out", Lmod.RnnOutputLayer(
             n_in=8, n_out=12, loss_function=loss.MCXENT), "lstm")
         .set_outputs("out")
         .backprop_type(enums.BackpropType(backprop))
         .t_bptt_forward_length(tbptt)
         .t_bptt_backward_length(tbptt))
    return g.build()


def _graph_pair(**kw):
    from deeplearning4j_tpu.nn.conf import enums as jax_enums
    from deeplearning4j_tpu_torch.nn.conf import enums as port_enums

    ref = JaxGraph(_rnn_graph(jax_conf, jax_L, jax_enums, JaxLoss,
                              **kw)).init()
    port = ComputationGraph(_rnn_graph(port_conf, L, port_enums,
                                       LossFunction, **kw), device="cpu")
    return ref, _carry(ref, port)


def _graph_trees_close(port, ref, rtol=1e-4, atol=1e-6):
    got, want = port.get_param_table(), ref.get_param_table()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("updater", ["SGD", "ADAM"])
def test_graph_tbptt_matches(updater):
    """24 steps in windows of 8: 3 iterations, against the reference."""
    ref, port = _graph_pair(updater=updater)
    x, y = _seq(batch=4, t=24, vocab=12, seed=0)
    ref.fit(JaxDataSet(x, y))
    port.fit(DataSet(x, y))
    assert port.iteration_count == ref.iteration_count == 3
    np.testing.assert_allclose(port.score_value, ref.score_value, rtol=1e-4,
                               atol=1e-6)
    _graph_trees_close(port, ref)


def test_graph_tbptt_masks_and_listeners():
    """Masked features and labels through the graph's windows (t 20 in
    windows of 8: 8, 8 and a tail of 4), a listener once per window, as
    the reference's host loop (which its listeners select) does."""
    ref, port = _graph_pair(updater="ADAM")
    seen = {"ref": [], "port": []}

    def listener(key):
        class Rec:
            def iteration_done(self, net, it):
                seen[key].append((it, net.score_value))
        return Rec()

    ref.set_listeners(listener("ref"))
    port.set_listeners(listener("port"))
    x, y = _seq(batch=3, t=20, vocab=12, seed=6)
    m = _masks(t=20)
    ref.fit(JaxMDS([x], [y], [m], [m]))
    port.fit(MultiDataSet([x], [y], [m], [m]))
    assert [i for i, _ in seen["port"]] == [i for i, _ in seen["ref"]] \
        == [1, 2, 3]
    np.testing.assert_allclose([v for _, v in seen["port"]],
                               [v for _, v in seen["ref"]], rtol=1e-4,
                               atol=1e-6)
    _graph_trees_close(port, ref)


def test_graph_single_window_equals_standard():
    x, y = _seq(batch=4, t=12, vocab=12, seed=0)
    _, tb = _graph_pair(tbptt=12)
    _, std = _graph_pair(tbptt=12, backprop="Standard")
    tb.fit(DataSet(x, y))
    std.fit(DataSet(x, y))
    for k, v in std.get_param_table().items():
        np.testing.assert_array_equal(tb.get_param_table()[k], v)


def test_graph_rnn_time_step_and_clear():
    ref, port = _graph_pair(backprop="Standard")
    x, _ = _seq(batch=3, t=10, vocab=12, seed=2)
    full = port.output(x)[0].numpy()
    np.testing.assert_allclose(full, np.asarray(ref.output(x)[0]),
                               rtol=1e-5, atol=1e-6)
    stepped = np.stack([port.rnn_time_step(x[:, i])[0].numpy()
                        for i in range(x.shape[1])], axis=1)
    np.testing.assert_allclose(stepped, full, rtol=1e-5, atol=1e-6)
    port.rnn_clear_previous_state()
    first = port.rnn_time_step(x)[0].numpy()
    second = port.rnn_time_step(x)[0].numpy()
    assert np.abs(second - first).max() > 1e-6
    ref.rnn_time_step(x)
    np.testing.assert_allclose(second, np.asarray(ref.rnn_time_step(x)[0]),
                               rtol=1e-4, atol=1e-6)
    port.rnn_clear_previous_state()
    np.testing.assert_array_equal(port.rnn_time_step(x)[0].numpy(), first)


def _last_step_graph(module, Lmod, graph_mod, loss):
    g = (module.NeuralNetConfiguration.Builder()
         .seed(0).learning_rate(0.05).updater(module.Updater.ADAM)
         .graph_builder()
         .add_inputs("in")
         .add_layer("lstm", Lmod.GravesLSTM(n_in=8, n_out=6,
                                            activation="tanh"), "in")
         .add_vertex("last", graph_mod.LastTimeStepVertex("in"), "lstm")
         .add_layer("out", Lmod.OutputLayer(
             n_in=6, n_out=3, loss_function=loss.MCXENT), "last")
         .set_outputs("out"))
    return g.build()


def test_recurrent_dag_with_last_time_step_vertex():
    """LSTM → LastTimeStep (masked) → OutputLayer, 5 Adam steps."""
    ref = JaxGraph(_last_step_graph(jax_conf, jax_L, jax_graph_conf,
                                    JaxLoss)).init()
    port = _carry(ref, ComputationGraph(
        _last_step_graph(port_conf, L, port_graph_conf, LossFunction),
        device="cpu"))
    rng = np.random.default_rng(0)
    x = np.eye(8, dtype=np.float32)[rng.integers(0, 8, (6, 10))]
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
    m = np.ones((6, 10), np.float32)
    m[1, 6:] = 0.0
    m[4, 2:] = 0.0
    for _ in range(5):
        ref.fit(JaxMDS([x], [y], [m], None))
        port.fit(MultiDataSet([x], [y], [m], None))
        np.testing.assert_allclose(port.score_value, ref.score_value,
                                   rtol=1e-4, atol=1e-6)
    _graph_trees_close(port, ref)
    out = port.output(x)[0].numpy()
    assert out.shape == (6, 3)


def _captioner(module, Lmod, graph_mod, enums, loss):
    g = (module.NeuralNetConfiguration.Builder()
         .seed(5).learning_rate(0.01).updater(module.Updater.SGD)
         .graph_builder()
         .add_inputs("img", "seq")
         .add_layer("imgfeat", Lmod.DenseLayer(n_in=6, n_out=4,
                                               activation="tanh"), "img")
         .add_vertex("dup", graph_mod.DuplicateToTimeSeriesVertex("seq"),
                     "imgfeat")
         .add_vertex("cat", graph_mod.MergeVertex(), "seq", "dup")
         .add_layer("lstm", Lmod.GravesLSTM(n_in=VOCAB + 4, n_out=8,
                                            activation="tanh"), "cat")
         .add_layer("out", Lmod.RnnOutputLayer(
             n_in=8, n_out=VOCAB, loss_function=loss.MCXENT), "lstm")
         .set_outputs("out")
         .backprop_type(enums.BackpropType.TRUNCATED_BPTT)
         .t_bptt_forward_length(6)
         .t_bptt_backward_length(6))
    return g.build()


def test_graph_tbptt_static_input_goes_whole_to_every_window():
    """A 2-D image input beside a sequence (t 20: windows of 6 and a tail
    of 2): the image is fed whole to each window, as in the reference."""
    from deeplearning4j_tpu.nn.conf import enums as jax_enums
    from deeplearning4j_tpu_torch.nn.conf import enums as port_enums

    ref = JaxGraph(_captioner(jax_conf, jax_L, jax_graph_conf, jax_enums,
                              JaxLoss)).init()
    port = _carry(ref, ComputationGraph(
        _captioner(port_conf, L, port_graph_conf, port_enums, LossFunction),
        device="cpu"))
    x, y = _seq(t=20)
    img = np.random.default_rng(9).standard_normal((3, 6)).astype(np.float32)
    ref.fit(JaxMDS([img, x], [y]))
    port.fit(MultiDataSet([img, x], [y]))
    assert port.iteration_count == ref.iteration_count == 4
    np.testing.assert_allclose(port.score_value, ref.score_value, rtol=1e-4,
                               atol=1e-6)
    _graph_trees_close(port, ref)
    port.fit_steps(MultiDataSet([img, x], [y]), 2)
    assert port.iteration_count == 12


def test_zero_rnn_state_keys_match_the_reference():
    """ImageLSTM gets an ``h``/``c`` carry at ``hidden_size`` (defaulting to
    ``n_out``) on both classes (tests/test_regressions.py:158)."""
    def mln(nnc, Lmod):
        return (nnc.Builder().seed(0).learning_rate(0.01).list()
                .layer(0, Lmod.ImageLSTM(n_in=12, n_out=9, hidden_size=7))
                .layer(1, Lmod.RnnOutputLayer(n_in=9, n_out=5)).build())

    def graph(nnc, Lmod):
        return (nnc.Builder().seed(0).learning_rate(0.01).graph_builder()
                .add_inputs("in")
                .add_layer("ilstm", Lmod.ImageLSTM(n_in=12, n_out=9), "in")
                .set_outputs("ilstm").build())

    def shapes(state):
        return {k: {n: tuple(v.shape) for n, v in s.items()}
                for k, s in state.items()}

    ref = JaxMLN(mln(jax_conf.NeuralNetConfiguration, jax_L)).init()
    port = MultiLayerNetwork(mln(port_conf.NeuralNetConfiguration, L),
                             device="cpu")
    assert shapes(port._zero_rnn_state(4)) == shapes(
        ref._zero_rnn_state(4)) == {"0": {"h": (4, 7), "c": (4, 7)}}
    gref = JaxGraph(graph(jax_conf.NeuralNetConfiguration, jax_L)).init()
    gport = ComputationGraph(graph(port_conf.NeuralNetConfiguration, L),
                             device="cpu")
    assert shapes(gport._zero_rnn_state(2)) == shapes(
        gref._zero_rnn_state(2)) == {"ilstm": {"h": (2, 9), "c": (2, 9)}}
