"""ModelSerializer zips across the two packages, and the port's checkpoints.

A zip written by either package restores in the other: a
``MultiLayerNetwork`` with BatchNorm, a ``ComputationGraph`` and a
``TransformerLM``, each trained a few steps first. The restored model's
outputs equal the writer's (float32 rtol 1e-5: the packages sum in
another order), and its updater state, net state and iteration count are
the writer's exactly. The port's checkpoint directories save, prune to
``keep``, resume, and raise on a missing entry or a list of another
length.
"""

import json
import os
import zipfile

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.models.transformer import TransformerLM as JaxLM
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import Updater as JaxUpdater
from deeplearning4j_tpu.nn.conf import layers as jax_L
from deeplearning4j_tpu.nn.conf.graph import MergeVertex as JaxMerge
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxCG
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.utils.serializer import ModelSerializer as JaxMS
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models.transformer import TransformerLM
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.listeners import (
    CheckpointIterationListener)
from deeplearning4j_tpu_torch.utils import ModelSerializer
from deeplearning4j_tpu_torch.utils import checkpoint as ckpt
from deeplearning4j_tpu_torch.utils.serializer import prng_key_words

RTOL, ATOL = 1e-5, 1e-6


def _np_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return np.asarray(tree)


def _same_tree(a, b, exact=True):
    a, b = _np_tree(a), _np_tree(b)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same_tree(a[k], b[k], exact)
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y, exact)
    elif exact:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def _toy(n=32, d=6, c=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x, np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]


def _mln_conf():
    return (JaxNNC.Builder().seed(1).learning_rate(0.05)
            .updater(JaxUpdater.ADAM).list()
            .layer(0, jax_L.DenseLayer(n_in=6, n_out=12, activation="relu"))
            .layer(1, jax_L.BatchNormalization())
            .layer(2, jax_L.OutputLayer(n_out=3))
            .set_input_type(JaxInputType.feed_forward(6)).build())


def _mln():
    net = JaxMLN(_mln_conf()).init()
    x, y = _toy()
    for _ in range(3):
        net.fit(JaxDataSet(x, y))
    return net, (x,)


def _graph():
    conf = (JaxNNC.Builder().seed(5).learning_rate(0.05)
            .updater(JaxUpdater.NESTEROVS).graph_builder()
            .add_inputs("in")
            .add_layer("d/1", jax_L.DenseLayer(n_in=6, n_out=5,
                                               activation="relu"), "in")
            .add_layer("d[2]", jax_L.DenseLayer(n_in=6, n_out=4,
                                                activation="tanh"), "in")
            .add_vertex("merge", JaxMerge(), "d/1", "d[2]")
            .add_layer("out", jax_L.OutputLayer(n_in=9, n_out=3,
                                                loss_function="MCXENT"),
                       "merge")
            .set_outputs("out").build())
    net = JaxCG(conf).init()
    x, y = _toy(seed=1)
    for _ in range(2):
        net.fit(JaxDataSet(x, y))
    return net, (x,)


def _lm():
    lm = JaxLM(vocab_size=16, d_model=16, num_heads=2, num_layers=2,
               max_len=8, lr=3e-3, seed=3).init()
    tok = np.random.default_rng(0).integers(0, 16, (2, 8)).astype(np.int32)
    step = lm.make_train_step(donate=False)
    for _ in range(2):
        lm.fit_batch(tok, train_step=step)
    return lm, tok


def _outputs(model, inputs):
    if hasattr(model, "step_count"):
        out = model.forward(model.params, inputs if isinstance(
            model, JaxLM) else torch.from_numpy(inputs).long())
        return _np_tree(out)
    out = model.output(*inputs)
    if isinstance(out, (list, tuple)):
        out = out[0]
    return _np_tree(out)


def _updater(model):
    return model.opt_state if hasattr(model, "step_count") \
        else model.updater_state


def _count(model):
    return model.step_count if hasattr(model, "step_count") \
        else model.iteration_count


MODELS = {"mln_batchnorm": _mln, "graph": _graph, "transformer_lm": _lm}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_a_jax_zip_restores_in_the_port_and_back(tmp_path, name):
    ref, inputs = MODELS[name]()
    path = str(tmp_path / "jax.zip")
    JaxMS.write_model(ref, path)
    port = ModelSerializer.restore(path, device="cpu")
    assert type(port).__name__ == type(ref).__name__
    np.testing.assert_allclose(_outputs(port, inputs), _outputs(ref, inputs),
                               rtol=RTOL, atol=ATOL)
    _same_tree(port.params, ref.params)
    _same_tree(_updater(port), _updater(ref))
    if hasattr(ref, "net_state"):
        _same_tree(port.net_state, ref.net_state)
    assert _count(port) == _count(ref)
    # and the port's zip of it restores in the JAX package
    back_path = str(tmp_path / "port.zip")
    ModelSerializer.write_model(port, back_path)
    back = JaxMS.restore(back_path)
    np.testing.assert_allclose(_outputs(back, inputs), _outputs(ref, inputs),
                               rtol=RTOL, atol=ATOL)
    _same_tree(back.params, ref.params)
    _same_tree(_updater(back), _updater(ref))
    if hasattr(ref, "net_state"):
        _same_tree(back.net_state, ref.net_state)
        assert np.array_equal(np.asarray(back._rng), np.asarray(
            jax.random.PRNGKey(ref.conf.global_conf.seed)))
    assert _count(back) == _count(ref)


def test_a_port_zip_restores_and_trains_on_in_jax(tmp_path):
    """Written by the port after its own training; JAX restores it and
    takes the same next step as the port."""
    from deeplearning4j_tpu_torch.nn.conf.neural_net import (
        MultiLayerConfiguration)

    port = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _mln_conf().to_json()), device="cpu").init()
    x, y = _toy(seed=4)
    for _ in range(2):
        port.fit(DataSet(x, y))
    path = str(tmp_path / "p.zip")
    ModelSerializer.write_model(port, path)
    back = JaxMS.restore_multi_layer_network(path)
    port.fit(DataSet(x, y))
    back.fit(JaxDataSet(x, y))
    _same_tree(port.params, back.params, exact=False)
    _same_tree(port.updater_state, back.updater_state, exact=False)
    _same_tree(port.net_state, back.net_state, exact=False)
    assert back.iteration_count == port.iteration_count == 3


def test_the_ports_generator_state_round_trips(tmp_path):
    ref, _ = _mln()
    path = str(tmp_path / "a.zip")
    JaxMS.write_model(ref, path)
    port = ModelSerializer.restore(path, device="cpu")
    fresh = torch.Generator().manual_seed(ref.conf.global_conf.seed)
    assert torch.equal(port._rng.get_state(), fresh.get_state())
    torch.rand(5, generator=port._rng)  # advance it
    ModelSerializer.write_model(port, path)
    again = ModelSerializer.restore(path, device="cpu")
    assert torch.equal(again._rng.get_state(), port._rng.get_state())
    with zipfile.ZipFile(path) as zf:
        ts = json.loads(zf.read("metadata.json"))["training_state"]
    assert ts["torch_rng"]["device"] == "cpu"


@pytest.mark.parametrize("seed", [0, 12345, 2 ** 31 - 1, 2 ** 33 + 5])
def test_rng_key_is_the_references_key_of_the_seed(seed):
    with jax.enable_x64(True):
        key = np.asarray(jax.random.PRNGKey(seed))
    assert prng_key_words(seed) == key.tolist()


def test_restore_checks_the_type_and_the_entries(tmp_path):
    ref, _ = _mln()
    path = str(tmp_path / "m.zip")
    JaxMS.write_model(ref, path)
    with pytest.raises(TypeError, match="restore_multi_layer_network"):
        ModelSerializer.restore_computation_graph(path, device="cpu")
    no_upd = str(tmp_path / "n.zip")
    JaxMS.write_model(ref, no_upd, save_updater=False)
    fresh = ModelSerializer.restore(no_upd, device="cpu")
    assert all(float(np.abs(t).sum()) == 0.0
               for t in jax.tree_util.tree_leaves(
                   _np_tree(fresh.updater_state)))
    broken = str(tmp_path / "b.zip")
    with zipfile.ZipFile(path) as src, zipfile.ZipFile(broken, "w") as dst:
        for item in src.namelist():
            data = src.read(item)
            if item == "coefficients.npz":
                import io

                with np.load(io.BytesIO(data)) as npz:
                    kept = {k: npz[k] for k in npz.files if k != "2/W"}
                buf = io.BytesIO()
                np.savez(buf, **kept)
                data = buf.getvalue()
            dst.writestr(item, data)
    with pytest.raises(ValueError, match="missing parameter entry '2/W'"):
        ModelSerializer.restore(broken, device="cpu")


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _port_net():
    from deeplearning4j_tpu_torch.nn.conf.neural_net import (
        MultiLayerConfiguration)

    return MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _mln_conf().to_json()), device="cpu").init()


def test_save_restore_latest_and_keep(tmp_path):
    d = str(tmp_path / "ck")
    assert ckpt.latest_step(d) is None
    net = _port_net()
    x, y = _toy()
    saved = {}
    for step in (1, 2, 3):
        net.fit(DataSet(x, y))
        ckpt.save_network(d, net, step=step, keep=2)
        saved[step] = (_np_tree(net.params), _np_tree(net.updater_state),
                       _np_tree(net.net_state))
    assert ckpt.latest_step(d) == 3
    assert sorted(os.listdir(d)) == ["2", "3"]
    other = _port_net()
    ckpt.restore_network(d, other)
    assert other.iteration_count == 3
    _same_tree(other.params, saved[3][0])
    _same_tree(other.updater_state, saved[3][1])
    _same_tree(other.net_state, saved[3][2])
    ckpt.restore_network(d, other, step=2)
    _same_tree(other.params, saved[2][0])
    assert other.iteration_count == 2
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"))


def test_checkpoint_trees_scalars_and_empty_leaves(tmp_path):
    d = str(tmp_path / "t")
    state = {"a": torch.arange(6.0).reshape(2, 3), "n": 7, "lr": 0.5,
             "empty": torch.zeros((0,)), "blocks": [{"w": torch.ones(2)},
                                                    {"w": torch.zeros(2)}]}
    ckpt.save_checkpoint(d, state, step=10)
    back = ckpt.restore_checkpoint(d, target=state)
    assert back["n"] == 7 and isinstance(back["n"], int)
    assert back["lr"] == 0.5
    assert back["empty"].shape == (0,)
    _same_tree(back["blocks"], state["blocks"])
    plain = ckpt.restore_checkpoint(d)
    assert torch.equal(plain["a"], state["a"])


def test_a_list_of_another_length_raises(tmp_path):
    """The reference's ``_reinstate_empty`` zips lists and so truncates
    silently; the port raises, as for a missing dict entry."""
    d = str(tmp_path / "l")
    ckpt.save_checkpoint(d, {"blocks": [torch.ones(2), torch.ones(2)]}, 1)
    with pytest.raises(ValueError, match="has 2 items, expected 3"):
        ckpt.restore_checkpoint(d, target={"blocks": [torch.ones(2)] * 3})
    with pytest.raises(ValueError, match="missing parameter entry 'other'"):
        ckpt.restore_checkpoint(d, target={"blocks": [torch.ones(2)] * 2,
                                           "other": torch.ones(1)})


def test_transformer_checkpoint_round_trip(tmp_path):
    lm = TransformerLM(vocab_size=16, d_model=16, num_heads=2, num_layers=1,
                       max_len=8, device="cpu").init()
    lm.step_count = 5
    ckpt.save_network(str(tmp_path / "lm"), lm)
    other = TransformerLM(vocab_size=16, d_model=16, num_heads=2,
                          num_layers=1, max_len=8, seed=9,
                          device="cpu").init()
    ckpt.restore_network(str(tmp_path / "lm"), other)
    assert other.step_count == 5
    _same_tree(other.params, lm.params)


def test_checkpoint_iteration_listener_keeps_its_stride(tmp_path):
    d = str(tmp_path / "it")
    net = _port_net()
    listener = CheckpointIterationListener(d, frequency=2, keep=5)
    net.set_listeners(listener)
    x, y = _toy()
    for _ in range(5):
        net.fit(DataSet(x, y))
    net.fit_steps(DataSet(x, y), 3)  # jumps the count by 3 in one firing
    listener.close()
    assert sorted(int(s) for s in os.listdir(d)) == [2, 4, 8]
