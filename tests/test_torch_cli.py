"""The port's CLI (``python -m deeplearning4j_tpu_torch.cli``): the
single-process cases of ``tests/test_cli.py`` with ``--device cpu``, and
the drivers' own steps below ``main`` held against the JAX package's.

From one document and one data file, ``_net_from_document`` builds the
network in both packages, ``load_network_from_jax`` gives the port the
JAX weights, ``_build_iterator`` reads the file, and ``fit`` runs once
per epoch as ``cmd_train`` does: after 2 epochs the params agree at
float32 rtol 1e-4 / atol 1e-6, for the SGD fixture configuration, for
an LBFGS one, and for a penalty-free LBFGS one in float64 (none
pretrains, so no draws are involved).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from deeplearning4j_tpu import dtypes as jax_dtypes
from deeplearning4j_tpu.cli import driver as jax_driver
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import layers as jax_L
from deeplearning4j_tpu_torch.cli import driver, main
from deeplearning4j_tpu_torch.cli.driver import load_properties
from deeplearning4j_tpu_torch.models.convert import load_network_from_jax
from deeplearning4j_tpu_torch.utils import ModelSerializer
from deeplearning4j_tpu_torch.utils.checkpoint import latest_step, save_network

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


@pytest.fixture
def toy_csv(tmp_path, rng):
    """Separable 2-class CSV: 4 features + label column (last)."""
    x = np.concatenate([rng.normal(-2, 0.5, (40, 4)),
                        rng.normal(2, 0.5, (40, 4))])
    y = np.repeat([0, 1], 40)
    order = rng.permutation(80)
    p = tmp_path / "data.csv"
    with open(p, "w") as f:
        for i in order:
            f.write(",".join(f"{v:.5f}" for v in x[i]) + f",{y[i]}\n")
    return str(p)


@pytest.fixture
def toy_svmlight(tmp_path, rng):
    x = np.concatenate([rng.normal(-2, 0.5, (30, 3)),
                        rng.normal(2, 0.5, (30, 3))])
    y = np.repeat([0, 1], 30)
    p = tmp_path / "data.svm"
    with open(p, "w") as f:
        for xi, yi in zip(x, y):
            feats = " ".join(f"{j + 1}:{v:.5f}" for j, v in enumerate(xi))
            f.write(f"{yi} {feats}\n")
    return str(p)


def _sgd_conf():
    return (JaxNNC.Builder().seed(7).iterations(8).learning_rate(0.5).list()
            .layer(0, jax_L.DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(1, jax_L.OutputLayer(n_in=8, n_out=2,
                                        activation="softmax"))
            .build())


@pytest.fixture
def conf_json(tmp_path):
    p = tmp_path / "conf.json"
    p.write_text(_sgd_conf().to_json())
    return str(p)


def _train(toy, model, out, *extra):
    return main(["train", "-input", toy, "-model", model, "-output", out,
                 "--num-classes", "2", *extra, *CPU])


def test_full_cycle_csv(tmp_path, toy_csv, conf_json, capsys):
    model_out = str(tmp_path / "model.zip")
    assert _train(toy_csv, conf_json, model_out, "--epochs", "3",
                  "--batch-size", "16") == 0
    assert os.path.exists(model_out)
    out = capsys.readouterr().out
    assert "epoch 3/3 score:" in out
    assert main(["test", "-input", toy_csv, "-model", model_out,
                 "--num-classes", "2", *CPU]) == 0
    assert "Accuracy" in capsys.readouterr().out
    pred_out = str(tmp_path / "preds.txt")
    assert main(["predict", "-input", toy_csv, "-model", model_out,
                 "--num-classes", "2", "-output", pred_out, *CPU]) == 0
    preds = [int(l) for l in open(pred_out).read().split()]
    assert len(preds) == 80 and set(preds) <= {0, 1}
    # predict's labels are the restored network's argmax
    net = ModelSerializer.restore(model_out, device="cpu")
    it = driver._build_iterator(driver.build_parser().parse_args(
        ["test", "-input", toy_csv, "-model", model_out, "--num-classes",
         "2"]), {})
    ds = driver._full_dataset(it, toy_csv)
    assert preds == net.predict(ds.features).tolist()
    assert net.evaluate(ds).accuracy() > 0.9


def test_predict_probabilities_stdout(tmp_path, toy_csv, conf_json, capsys):
    model_out = str(tmp_path / "model.zip")
    _train(toy_csv, conf_json, model_out)
    capsys.readouterr()
    assert main(["predict", "-input", toy_csv, "-model", model_out,
                 "--num-classes", "2", "--probabilities", *CPU]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 80
    row = [float(v) for v in lines[0].split()]
    assert len(row) == 2
    np.testing.assert_allclose(sum(row), 1.0, atol=1e-3)


def test_svmlight_with_properties(tmp_path, toy_svmlight, capsys):
    conf = (JaxNNC.Builder().seed(3).iterations(8).learning_rate(0.5).list()
            .layer(0, jax_L.DenseLayer(n_in=3, n_out=8, activation="tanh"))
            .layer(1, jax_L.OutputLayer(n_in=8, n_out=2,
                                        activation="softmax")).build())
    conf_p = tmp_path / "conf.json"
    conf_p.write_text(conf.to_json())
    props = tmp_path / "run.properties"
    props.write_text("# run config\ninput.format=svmlight\nbatch.size=20\n"
                     "input.num.classes=2\nepochs=3\n")
    model_out = str(tmp_path / "model.zip")
    assert main(["train", "-input", toy_svmlight, "-model", str(conf_p),
                 "-conf", str(props), "-output", model_out, *CPU]) == 0
    assert main(["test", "-input", toy_svmlight, "-model", model_out,
                 "-conf", str(props), *CPU]) == 0
    assert "Accuracy" in capsys.readouterr().out


def test_train_checkpoints_and_resumes(tmp_path, toy_csv, conf_json,
                                       capsys):
    ck = str(tmp_path / "ckpt")
    args = ("--batch-size", "16", "--checkpoint-dir", ck)
    assert _train(toy_csv, conf_json, str(tmp_path / "m1.zip"),
                  "--epochs", "2", *args) == 0
    assert latest_step(ck) == 2
    capsys.readouterr()
    assert _train(toy_csv, conf_json, str(tmp_path / "m2.zip"),
                  "--epochs", "4", "--resume", *args) == 0
    out = capsys.readouterr().out
    assert "resumed from checkpoint epoch 2" in out
    assert "2 epoch(s) (2 resumed)" in out
    assert latest_step(ck) == 4
    # resumed to 4 equals 4 straight epochs
    straight = str(tmp_path / "m4.zip")
    _train(toy_csv, conf_json, straight, "--epochs", "4", "--batch-size",
           "16")
    a = ModelSerializer.restore(str(tmp_path / "m2.zip"), device="cpu")
    b = ModelSerializer.restore(straight, device="cpu")
    np.testing.assert_array_equal(a.get_flat_params(), b.get_flat_params())
    assert a.iteration_count == b.iteration_count
    # resume when already done: zero epochs run, model still written
    out3 = str(tmp_path / "m3.zip")
    assert _train(toy_csv, conf_json, out3, "--epochs", "4", "--resume",
                  *args) == 0
    assert os.path.exists(out3)


def test_resume_rejections_and_fresh_start(tmp_path, toy_csv, conf_json,
                                           capsys):
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf.neural_net import (
        MultiLayerConfiguration)

    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        open(conf_json).read()), device="cpu").init()
    ck = str(tmp_path / "iter_ck")
    save_network(ck, net, step=400)
    with pytest.raises(SystemExit, match="not epoch-keyed"):
        _train(toy_csv, conf_json, str(tmp_path / "m.zip"), "--epochs", "4",
               "--checkpoint-dir", ck, "--resume")
    with pytest.raises(SystemExit, match="checkpoint-dir"):
        _train(toy_csv, conf_json, str(tmp_path / "m.zip"), "--resume")
    capsys.readouterr()
    assert _train(toy_csv, conf_json, str(tmp_path / "m.zip"),
                  "--batch-size", "16", "--epochs", "1", "--checkpoint-dir",
                  str(tmp_path / "empty_ck"), "--resume") == 0
    assert "training from scratch" in capsys.readouterr().out


def test_load_properties(tmp_path):
    p = tmp_path / "x.properties"
    p.write_text("# comment\n! also comment\na=1\nb: two\n\nmalformed\n"
                 "spaced = v \n")
    assert load_properties(str(p)) == {"a": "1", "b": "two", "spaced": "v"}


def test_flag_overrides_property(tmp_path, toy_csv, conf_json):
    props = tmp_path / "p.properties"
    props.write_text("batch.size=7\ninput.num.classes=2\n")
    args = driver.build_parser().parse_args(
        ["train", "-input", toy_csv, "-model", conf_json, "-conf",
         str(props), "-output", "x", "--batch-size", "40"])
    assert driver._build_iterator(args, load_properties(str(props))
                                  ).batch_size == 40
    assert main(["train", "-input", toy_csv, "-model", conf_json, "-conf",
                 str(props), "-output", str(tmp_path / "m.zip"),
                 "--batch-size", "40", *CPU]) == 0


def test_empty_input_clean_error(tmp_path, toy_csv, conf_json):
    model_out = str(tmp_path / "m.zip")
    _train(toy_csv, conf_json, model_out)
    empty = tmp_path / "empty.csv"
    empty.write_text("")
    with pytest.raises(SystemExit, match="no records"):
        main(["test", "-input", str(empty), "-model", model_out,
              "--num-classes", "2", *CPU])


def test_epochs_zero_respected(tmp_path, toy_csv, conf_json, capsys):
    assert _train(toy_csv, conf_json, str(tmp_path / "m.zip"),
                  "--epochs", "0") == 0
    assert "0 epoch(s)" in capsys.readouterr().out


def test_svmlight_readers(tmp_path):
    p = tmp_path / "zb.svm"
    p.write_text("1 0:5.0 2:7.0\n0 1:3.0\n")
    label, x = driver._build_reader(str(p), "svmlight", zero_based=True,
                                    num_features=None).next()
    assert label == 1.0
    np.testing.assert_allclose(x, [5.0, 0.0, 7.0])
    q = tmp_path / "narrow.svm"
    q.write_text("0 1:1.0\n")
    _, x = driver._build_reader(str(q), "svmlight", zero_based=False,
                                num_features=3).next()
    assert x.shape == (3,)
    with pytest.raises(ValueError, match="unknown input format"):
        driver._build_reader(str(q), "parquet", False, None)


@pytest.mark.parametrize("runtime", ["mesh", "multihost"])
def test_data_parallel_runtimes_exit_naming_their_item(tmp_path, toy_csv,
                                                       conf_json, runtime):
    """The runtimes are ported: ``mesh`` (from the flag or the
    ``runtime`` property) trains in a world of one, bitwise ``local``;
    ``multihost`` over more than one process needs a coordinator and
    exits with the reference's message; an unknown one is refused. The
    multi-process runs are tests/test_torch_cluster.py's."""
    local = str(tmp_path / "l.zip")
    assert _train(toy_csv, conf_json, local) == 0
    props = tmp_path / "r.properties"
    if runtime == "mesh":
        assert _train(toy_csv, conf_json, str(tmp_path / "x.zip"),
                      "-runtime", runtime) == 0
        props.write_text(f"runtime={runtime}\ninput.num.classes=2\n")
        assert main(["train", "-input", toy_csv, "-model", conf_json,
                     "-conf", str(props), "-output",
                     str(tmp_path / "y.zip"), *CPU]) == 0
        want = ModelSerializer.restore(local, device="cpu").get_flat_params()
        for name in ("x.zip", "y.zip"):
            got = ModelSerializer.restore(str(tmp_path / name),
                                          device="cpu").get_flat_params()
            np.testing.assert_array_equal(got, want)
    else:
        with pytest.raises(SystemExit, match="requires --coordinator"):
            _train(toy_csv, conf_json, str(tmp_path / "x.zip"),
                   "-runtime", runtime, "--num-processes", "2")
        props.write_text(f"runtime={runtime}\ninput.num.classes=2\n"
                         "runtime.num.processes=2\n")
        with pytest.raises(SystemExit, match="requires --coordinator"):
            main(["train", "-input", toy_csv, "-model", conf_json, "-conf",
                  str(props), "-output", str(tmp_path / "y.zip"), *CPU])
    with pytest.raises(SystemExit):  # argparse refuses an unknown one
        _train(toy_csv, conf_json, str(tmp_path / "z.zip"),
               "-runtime", "yarn")


REF_MLN = {
    "backprop": True,
    "confs": [
        {"layer": {"dense": {"nIn": 4, "nOut": 8,
                             "activationFunction": "tanh",
                             "learningRate": 0.5}},
         "seed": 7, "numIterations": 8},
        {"layer": {"output": {"nIn": 8, "nOut": 2,
                              "activationFunction": "softmax",
                              "lossFunction": "MCXENT",
                              "learningRate": 0.5}},
         "seed": 7, "numIterations": 8},
    ],
}
REF_GRAPH = {
    "vertices": {
        "d": {"LayerVertex": {"layerConf": {
            "layer": {"dense": {"nIn": 4, "nOut": 8,
                                "activationFunction": "tanh",
                                "learningRate": 0.5}},
            "seed": 7, "numIterations": 4}}},
        "out": {"LayerVertex": {"layerConf": {
            "layer": {"output": {"nIn": 8, "nOut": 2,
                                 "lossFunction": "MCXENT",
                                 "learningRate": 0.5}},
            "seed": 7, "numIterations": 4}}},
    },
    "vertexInputs": {"d": ["in"], "out": ["d"]},
    "networkInputs": ["in"], "networkOutputs": ["out"],
}
REF_YAML = '\n'.join([
    '---', 'backprop: true', 'confs:',
    '- layer:', '    dense:', '      nIn: 4', '      nOut: 8',
    '      activationFunction: "tanh"', '      learningRate: 0.5',
    '  seed: 7', '  numIterations: 4',
    '- layer:', '    output:', '      nIn: 8', '      nOut: 2',
    '      lossFunction: "MCXENT"', '      learningRate: 0.5',
    '  seed: 7', '  numIterations: 4',
]) + '\n'


@pytest.mark.parametrize("doc,kind", [
    (json.dumps(REF_MLN), "MultiLayerNetwork"),
    (json.dumps(REF_GRAPH), "ComputationGraph"),
    (REF_YAML, "MultiLayerNetwork"),
    ("native_graph", "ComputationGraph"),
], ids=["reference_json", "reference_graph_json", "yaml", "native_graph"])
def test_model_documents_train_and_predict(tmp_path, toy_csv, capsys, doc,
                                           kind):
    if doc == "native_graph":
        doc = (JaxNNC.Builder().seed(1).learning_rate(0.5).graph_builder()
               .add_inputs("in")
               .add_layer("out", jax_L.OutputLayer(
                   n_in=4, n_out=2, loss_function="MCXENT"), "in")
               .set_outputs("out").build().to_json())
    conf = tmp_path / "model.doc"
    conf.write_text(doc)
    model_out = str(tmp_path / "m.zip")
    assert _train(toy_csv, str(conf), model_out, "--batch-size", "16",
                  "--epochs", "2") == 0
    assert type(ModelSerializer.restore(model_out, device="cpu")
                ).__name__ == kind
    capsys.readouterr()
    assert main(["predict", "-input", toy_csv, "-model", model_out,
                 "--batch-size", "16", "--num-classes", "2", *CPU]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 80 and set(lines) <= {"0", "1"}
    assert main(["predict", "-input", toy_csv, "-model", model_out,
                 "--num-classes", "2", "--probabilities", *CPU]) == 0
    probs = capsys.readouterr().out.strip().splitlines()
    assert len(probs) == 80 and len(probs[0].split()) == 2


def _lbfgs_doc(l2=0.1):
    """LBFGS, by default with an L2 penalty of 0.1. The toy data are
    separable: with no penalty the loss heads for zero and its curvature
    with it, and the two-loop recursion amplifies float32 rounding until
    the params part by 1e-2 after 2 epochs. That gap is each package's
    own: with no penalty, each package in float32 parts from itself in
    float64 by as much, while the two in float64 agree (the
    ``lbfgs_no_penalty_float64`` case; ROADMAP C). The penalty bounds the
    curvature from below, so the float32 case holds at the tight gate."""
    doc = json.loads(json.dumps(REF_MLN))
    for c in doc["confs"]:
        c["optimizationAlgo"] = "LBFGS"
        c["numIterations"] = 3
        if l2:
            next(iter(c["layer"].values()))["l2"] = l2
    return json.dumps(doc)


def _in_float64(ref, port):
    """Both networks rebuilt under the float64 dtype policy, from the JAX
    network's float32 init widened to float64."""
    wide = lambda tree: jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64), tree)
    params, updater_state = wide(ref.params), wide(ref.updater_state)
    for net in (ref, port):
        net.conf.global_conf.dtype_policy = "float64"
    ref = type(ref)(ref.conf).init()
    ref.params = jax.tree_util.tree_map(jax.numpy.asarray, params)
    ref.updater_state = jax.tree_util.tree_map(jax.numpy.asarray,
                                               updater_state)
    port = type(port)(port.conf, device="cpu")
    load_network_from_jax(port, params, updater_state)
    return ref, port


@pytest.mark.parametrize("conf", ["sgd_fixture", "lbfgs",
                                  "lbfgs_no_penalty_float64"])
def test_drivers_steps_match_the_jax_package(tmp_path, toy_csv, conf):
    """``_net_from_document`` → the JAX weights → ``_build_iterator`` →
    ``fit`` once per epoch, for 2 epochs, in both packages. The float64
    case enables JAX's 64-bit types and enters the JAX float64 policy
    around ``fit``: the JAX solver traces its loss under the policy in
    scope, not the network's."""
    if conf == "lbfgs_no_penalty_float64":
        with jax.enable_x64(True), jax_dtypes.policy_scope(
                jax_dtypes.FLOAT64):
            _drivers_steps(toy_csv, _lbfgs_doc(l2=None), float64=True)
    else:
        _drivers_steps(toy_csv, _sgd_conf().to_json()
                       if conf == "sgd_fixture" else _lbfgs_doc())


def _drivers_steps(toy_csv, doc, float64=False):
    argv = ["train", "-input", toy_csv, "-model", "m", "-output", "o",
            "--num-classes", "2", "--batch-size", "16"]
    ref = jax_driver._net_from_document(doc)
    port = driver._net_from_document(doc, device="cpu")
    if float64:
        ref, port = _in_float64(ref, port)
    else:
        load_network_from_jax(
            port, jax.tree_util.tree_map(np.asarray, ref.params),
            jax.tree_util.tree_map(np.asarray, ref.updater_state),
            jax.tree_util.tree_map(np.asarray, ref.net_state),
            ref.iteration_count)
    ref_it = jax_driver._build_iterator(
        jax_driver.build_parser().parse_args(argv), {})
    it = driver._build_iterator(driver.build_parser().parse_args(argv), {})
    for _ in range(2):
        ref_it.reset()
        ref.fit(ref_it)
        it.reset()
        port.fit(it)
    # float64: the two packages end with equal params and scores within
    # 1.1e-10 of each other; the gate leaves 1000 times that
    tol = dict(rtol=1e-7, atol=1e-10) if float64 else dict(rtol=1e-4,
                                                          atol=1e-6)
    np.testing.assert_allclose(port.get_flat_params(), ref.get_flat_params(),
                               **tol)
    assert port.iteration_count == ref.iteration_count > 0
    np.testing.assert_allclose(port.score_value, ref.score_value, **tol)


def test_module_entry_point_runs(tmp_path, toy_csv, conf_json):
    """``python -m deeplearning4j_tpu_torch.cli`` as a user runs it."""
    model_out = str(tmp_path / "m.zip")
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "train",
         "-input", toy_csv, "-model", conf_json, "-output", model_out,
         "--num-classes", "2", "--epochs", "1", *CPU],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    assert "saved to" in proc.stdout and os.path.exists(model_out)
