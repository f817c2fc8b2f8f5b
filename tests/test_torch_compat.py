"""Port parity for the reference-format configurations (``nn/conf/compat.py``)
and the YAML subset (``utils/yamlio.py``) against the JAX package.

The gate is the same text: from the same configuration both packages
write byte-identical reference JSON, reference YAML and native YAML, and
every reference document of ``tests/test_compat.py`` (LeNet, an LSTM
under truncated BPTT, a two-input graph, both YAML flavours, the garbage
cases) loads to configurations whose native JSON is identical. A DBN
reference document loads and trains in the port as in the JAX package
(float32 rtol 1e-4 / atol 1e-6, pretraining fed the reference's draws).
"""

import json

import jax
import numpy as np
import pytest

import test_compat as ref_docs
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import layers as jax_L
from deeplearning4j_tpu.nn.conf.graph import (
    ComputationGraphConfiguration as JaxCGC,
    ElementWiseVertex as JaxEW,
    MergeVertex as JaxMerge,
    ScaleVertex as JaxScale,
)
from deeplearning4j_tpu.nn.conf.neural_net import (
    MultiLayerConfiguration as JaxMLC)
from deeplearning4j_tpu.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor as JaxCnnToFF)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.utils import yamlio as jax_yamlio
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models.convert import load_network_from_jax
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf.compat import _convert_layer
from deeplearning4j_tpu_torch.nn.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.neural_net import MultiLayerConfiguration
from deeplearning4j_tpu_torch.utils import yamlio
from test_torch_pretrain import ReferenceDraws

LSTM_DOC = json.dumps({
    "backprop": True, "backpropType": "TruncatedBPTT",
    "tbpttFwdLength": 8, "tbpttBackLength": 8,
    "confs": [
        {"layer": {"gravesLSTM": {
            "nIn": 10, "nOut": 16, "activationFunction": "tanh",
            "updater": "ADAM", "learningRate": 0.02}},
         "seed": 7, "numIterations": 1},
        {"layer": {"rnnoutput": {
            "nIn": 16, "nOut": 10, "activationFunction": "softmax",
            "lossFunction": "MCXENT", "updater": "ADAM",
            "learningRate": 0.02}},
         "seed": 7, "numIterations": 1},
    ],
})
DIST_DOC = json.dumps({
    "backprop": True,
    "confs": [{
        "layer": {"dense": {
            "nIn": 4, "nOut": 3, "activationFunction": "tanh",
            "weightInit": "DISTRIBUTION",
            "dist": {"normal": {"mean": 0.0, "std": 0.5}},
            "momentum": 0.9, "someFutureField": 1}},
        "seed": 1}],
})
COMPOSABLE_DOC = json.dumps({
    "backprop": True,
    "inputPreProcessors": {
        "0": {"binomialSampling": {}},
        "1": {"composableInput": {"inputPreProcessors": [
            {"rnnToFeedForward": {}}, {"zeroMean": {}}]}},
    },
    "confs": [
        {"layer": {"dense": {"nIn": 6, "nOut": 5,
                             "activationFunction": "relu"}}, "seed": 1},
        {"layer": {"output": {"nIn": 5, "nOut": 2,
                              "lossFunction": "MCXENT"}}, "seed": 1},
    ],
})
# the MNIST deep-belief net of the DL4J 0.4 examples, narrowed (784-500-
# 250-200-10 there): binary RBMs, CD-1, pretrain then LBFGS finetuning
DBN_DOC = json.dumps({
    "backprop": True, "pretrain": True,
    "confs": [
        {"layer": {"RBM": {"nIn": 16, "nOut": 12, "k": 1,
                           "hiddenUnit": "BINARY", "visibleUnit": "BINARY",
                           "weightInit": "XAVIER", "learningRate": 0.1}},
         "seed": 123, "numIterations": 3, "optimizationAlgo": "LBFGS"},
        {"layer": {"RBM": {"nIn": 12, "nOut": 8, "k": 1,
                           "hiddenUnit": "BINARY", "visibleUnit": "BINARY",
                           "learningRate": 0.1}},
         "seed": 123, "numIterations": 3, "optimizationAlgo": "LBFGS"},
        {"layer": {"output": {"nIn": 8, "nOut": 4,
                              "activationFunction": "softmax",
                              "lossFunction": "MCXENT",
                              "learningRate": 0.1}},
         "seed": 123, "numIterations": 3, "optimizationAlgo": "LBFGS"},
    ],
})

MLN_DOCS = {"lenet": ref_docs.REFERENCE_LENET_JSON, "lstm_tbptt": LSTM_DOC,
            "distribution": DIST_DOC, "composable": COMPOSABLE_DOC,
            "dbn": DBN_DOC}


def _same_conf(port, ref):
    assert port.to_json() == ref.to_json()


@pytest.mark.parametrize("name", sorted(MLN_DOCS))
def test_reference_json_loads_to_the_same_configuration(name):
    port = MultiLayerConfiguration.from_reference_json(MLN_DOCS[name])
    ref = JaxMLC.from_reference_json(MLN_DOCS[name])
    _same_conf(port, ref)
    assert port.to_reference_json() == ref.to_reference_json()
    assert port.to_reference_yaml() == ref.to_reference_yaml()
    assert port.to_yaml() == ref.to_yaml()
    assert MultiLayerConfiguration.from_yaml(port.to_yaml()) == port
    assert MultiLayerConfiguration.from_reference_yaml(
        port.to_reference_yaml()).to_json() == \
        MultiLayerConfiguration.from_reference_json(
            port.to_reference_json()).to_json()


def test_reference_graph_json_and_yaml_load_to_the_same_configuration():
    for doc, port_load, ref_load in (
            (ref_docs.REFERENCE_GRAPH_JSON,
             ComputationGraphConfiguration.from_reference_json,
             JaxCGC.from_reference_json),
            (ref_docs.TestReferenceYamlLoader.GRAPH_YAML,
             ComputationGraphConfiguration.from_reference_yaml,
             JaxCGC.from_reference_yaml)):
        port, ref = port_load(doc), ref_load(doc)
        _same_conf(port, ref)
        assert port.to_reference_json() == ref.to_reference_json()
        assert port.to_reference_yaml() == ref.to_reference_yaml()
        assert port.to_yaml() == ref.to_yaml()
        assert ComputationGraphConfiguration.from_yaml(port.to_yaml()) == port


def test_reference_mln_yaml_loads_to_the_same_configuration():
    doc = ref_docs.TestReferenceYamlLoader.MLN_YAML
    port = MultiLayerConfiguration.from_reference_yaml(doc)
    _same_conf(port, JaxMLC.from_reference_yaml(doc))
    assert port == MultiLayerConfiguration.from_reference_json(LSTM_DOC)


@pytest.mark.parametrize("doc,match", [
    ("{}", "no 'confs'"),
    (json.dumps({"confs": [{"layer": {"frobnicator": {}}}]}),
     "unknown reference layer"),
    (json.dumps({"confs": [{"seed": 1}]}), "without a 'layer'"),
], ids=["empty", "unknown_layer", "no_layer"])
def test_garbage_raises_as_in_the_reference(doc, match):
    with pytest.raises(ValueError, match=match) as ours:
        MultiLayerConfiguration.from_reference_json(doc)
    with pytest.raises(ValueError) as theirs:
        JaxMLC.from_reference_json(doc)
    assert str(ours.value) == str(theirs.value)


def test_graph_garbage_raises_as_in_the_reference():
    for doc in ("{}", json.dumps({
            "vertices": {"x": {"FrobnicateVertex": {}}},
            "vertexInputs": {"x": ["in"]},
            "networkInputs": ["in"], "networkOutputs": ["x"]})):
        with pytest.raises(ValueError) as ours:
            ComputationGraphConfiguration.from_reference_json(doc)
        with pytest.raises(ValueError) as theirs:
            JaxCGC.from_reference_json(doc)
        assert str(ours.value) == str(theirs.value)


def _port_of(jconf):
    cls = (ComputationGraphConfiguration if isinstance(jconf, JaxCGC)
           else MultiLayerConfiguration)
    return cls.from_json(jconf.to_json())


def _builder_confs():
    """The configurations ``tests/test_compat.py`` exports, built in the
    JAX package (the port's come from their native JSON)."""
    from deeplearning4j_tpu.nn.conf import Updater, WeightInit
    from deeplearning4j_tpu.ops.losses import LossFunction

    mcx = LossFunction.MCXENT
    confs = {
        "mlp": (JaxNNC.Builder().seed(11).learning_rate(0.05)
                .updater(Updater.ADAM).list()
                .layer(0, jax_L.DenseLayer(n_in=6, n_out=8,
                                           activation="relu", l2=1e-4))
                .layer(1, jax_L.OutputLayer(n_in=8, n_out=3,
                                            loss_function=mcx)).build()),
        "conv": (JaxNNC.Builder().seed(3).learning_rate(0.02)
                 .updater(Updater.RMSPROP).list()
                 .layer(0, jax_L.ConvolutionLayer(
                     n_in=1, n_out=4, kernel_size=(3, 3), stride=(1, 1),
                     padding=(0, 0), activation="relu",
                     weight_init=WeightInit.XAVIER))
                 .layer(1, jax_L.DenseLayer(n_in=144, n_out=10,
                                            activation="tanh"))
                 .layer(2, jax_L.OutputLayer(n_in=10, n_out=2,
                                             loss_function=mcx))
                 .input_pre_processor(1, JaxCnnToFF(height=6, width=6,
                                                    channels=4)).build()),
        "lr_schedule": (JaxNNC.Builder().seed(1).learning_rate(0.1)
                        .learning_rate_schedule({5: 0.01, 20: 0.001}).list()
                        .layer(0, jax_L.DenseLayer(n_in=4, n_out=3,
                                                   activation="tanh"))
                        .layer(1, jax_L.OutputLayer(n_in=3, n_out=2,
                                                    loss_function=mcx))
                        .build()),
        "rbm_stack": (JaxNNC.Builder().seed(5).learning_rate(0.1).list()
                      .layer(0, jax_L.RBM(n_in=8, n_out=6, k=2))
                      .layer(1, jax_L.AutoEncoder(n_in=6, n_out=4))
                      .layer(2, jax_L.OutputLayer(n_in=4, n_out=2,
                                                  loss_function=mcx))
                      .pretrain(True).build()),
        "graph_merge": (JaxNNC.Builder().seed(5).learning_rate(0.05)
                        .updater(Updater.ADAM).graph_builder()
                        .add_inputs("in")
                        .add_layer("d1", jax_L.DenseLayer(
                            n_in=4, n_out=6, activation="relu"), "in")
                        .add_layer("d2", jax_L.DenseLayer(
                            n_in=4, n_out=6, activation="tanh"), "in")
                        .add_vertex("merge", JaxMerge(), "d1", "d2")
                        .add_layer("out", jax_L.OutputLayer(
                            n_in=12, n_out=2, loss_function=mcx), "merge")
                        .set_outputs("out").build()),
    }
    rng = np.random.default_rng(7)  # test_compat's fuzz stacks
    acts = ["relu", "tanh", "sigmoid", "leakyrelu"]
    upds = [Updater.SGD, Updater.ADAM, Updater.RMSPROP, Updater.ADAGRAD,
            Updater.NESTEROVS]
    for trial in range(8):
        depth = int(rng.integers(1, 4))
        widths = [int(rng.integers(3, 9)) for _ in range(depth + 1)]
        b = (JaxNNC.Builder().seed(int(rng.integers(0, 2 ** 31 - 1)))
             .learning_rate(float(rng.choice([0.5, 0.05, 0.01])))
             .updater(upds[trial % len(upds)]).list())
        n_in = 5
        for i, w in enumerate(widths[:-1]):
            b.layer(i, jax_L.DenseLayer(
                n_in=n_in, n_out=w, activation=str(rng.choice(acts)),
                l1=float(rng.choice([0.0, 1e-5])),
                l2=float(rng.choice([0.0, 1e-4]))))
            n_in = w
        b.layer(depth, jax_L.OutputLayer(n_in=n_in, n_out=widths[-1],
                                         loss_function=mcx))
        confs[f"fuzz{trial}"] = b.build()
    return confs


CONFS = _builder_confs()


@pytest.mark.parametrize("name", sorted(CONFS))
def test_exports_are_byte_identical(name):
    ref = CONFS[name]
    port = _port_of(ref)
    assert port.to_reference_json() == ref.to_reference_json()
    assert port.to_reference_yaml() == ref.to_reference_yaml()
    assert port.to_yaml() == ref.to_yaml()
    loader = type(port).from_reference_json
    back, ref_back = loader(port.to_reference_json()), \
        type(ref).from_reference_json(ref.to_reference_json())
    assert back.to_json() == ref_back.to_json()


def _inexpressible():
    from deeplearning4j_tpu.nn.conf import Updater
    from deeplearning4j_tpu.ops.losses import LossFunction

    mcx = LossFunction.MCXENT
    base = JaxNNC.Builder().seed(0).learning_rate(0.01)
    return {
        "convolution_mode": (base.list().layer(0, jax_L.ConvolutionLayer(
            n_in=1, n_out=2, kernel_size=(3, 3), stride=(1, 1),
            convolution_mode="same")).layer(1, jax_L.OutputLayer(
                n_in=8, n_out=2, loss_function=mcx)).build()),
        "dtype_policy": (JaxNNC.Builder().seed(0).learning_rate(0.01)
                         .dtype_policy("bf16").list()
                         .layer(0, jax_L.OutputLayer(
                             n_in=4, n_out=2, loss_function=mcx)).build()),
        "momentum_zero": (JaxNNC.Builder().seed(0).learning_rate(0.01).list()
                          .layer(0, jax_L.DenseLayer(
                              n_in=4, n_out=3, momentum=0.0,
                              updater=Updater.NESTEROVS))
                          .layer(1, jax_L.OutputLayer(
                              n_in=3, n_out=2, loss_function=mcx)).build()),
        "average_vertex": (JaxNNC.Builder().seed(0).learning_rate(0.01)
                           .graph_builder().add_inputs("a", "b")
                           .add_vertex("avg", JaxEW(op="Average"), "a", "b")
                           .add_layer("out", jax_L.OutputLayer(
                               n_in=4, n_out=2, loss_function=mcx), "avg")
                           .set_outputs("out").build()),
        "scale_vertex": (JaxNNC.Builder().seed(0).learning_rate(0.01)
                         .graph_builder().add_inputs("in")
                         .add_vertex("s", JaxScale(scale=2.0), "in")
                         .add_layer("out", jax_L.OutputLayer(
                             n_in=4, n_out=2, loss_function=mcx), "s")
                         .set_outputs("out").build()),
    }


@pytest.mark.parametrize("name", sorted(_inexpressible()))
def test_inexpressible_settings_raise_as_in_the_reference(name):
    ref = _inexpressible()[name]
    port = _port_of(ref)
    with pytest.raises(ValueError) as ours:
        port.to_reference_json()
    with pytest.raises(ValueError) as theirs:
        ref.to_reference_json()
    assert str(ours.value) == str(theirs.value)


def test_every_layer_tag_translates_as_in_the_reference():
    from deeplearning4j_tpu.nn.conf.compat import (
        _convert_layer as jax_convert)

    # tags of test_all_layer_tags_translate, with non-default fields
    tags = {"autoEncoder": {"nIn": 8, "nOut": 4},
            "RBM": {"nIn": 8, "nOut": 4, "hiddenUnit": "GAUSSIAN",
                    "visibleUnit": "LINEAR", "k": 3, "sparsity": 0.1},
            "recursiveAutoEncoder": {"nIn": 8, "nOut": 8},
            "gru": {"nIn": 8, "nOut": 6},
            "subsampling": {"poolingType": "AVG", "kernelSize": [2, 2]},
            "localResponseNormalization": {"n": 5.0, "alpha": 1e-4},
            "activation": {"activationFunction": "relu"}}
    for tag, fields in tags.items():
        ours, theirs = _convert_layer({tag: fields}), jax_convert(
            {tag: fields})
        assert type(ours).__name__ == type(theirs).__name__
        assert ours.to_dict() == theirs.to_dict()


@pytest.mark.parametrize("doc", [
    {"names": ["conv: 1", "plain", 'quo"te'], "n": 3},
    {"name": "nan", "other": "Infinity", "real": 1.5},
    {"xs": [[], {}, [1], {"a": 1}, "[]"], "empty_list": [], "empty_map": {}},
    {"nested": {"a": [{"b": 1, "c": [1, 2]}, None, True]}, "z": -1e-7},
], ids=["quoted_colon", "nan_strings", "empty_collections", "nested"])
def test_yaml_subset_matches_the_reference(doc):
    text = yamlio.dump(doc)
    assert text == jax_yamlio.dump(doc)
    assert yamlio.load(text) == jax_yamlio.load(text) == doc
    with pytest.raises(yamlio.YamlError):
        yamlio.load("a: &anchor 1\nb: *anchor\n")


def test_dbn_reference_document_loads_and_trains():
    """Pretraining (CD-1 on both RBMs) then LBFGS, in both packages, from
    the same weights and draws."""
    jconf = JaxMLC.from_reference_json(DBN_DOC)
    ref = JaxMLN(jconf).init()
    port = MultiLayerNetwork(MultiLayerConfiguration.from_reference_json(
        DBN_DOC), device="cpu")
    load_network_from_jax(port, jax.tree_util.tree_map(np.asarray,
                                                       ref.params),
                          jax.tree_util.tree_map(np.asarray,
                                                 ref.updater_state))
    port._pretrain_draws = ReferenceDraws(ref._rng)
    rng = np.random.default_rng(3)
    x = (rng.random((32, 16)) < 0.3).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[(x[:, :4] * [1, 2, 3, 4]).argmax(1)]
    s0 = port.score(DataSet(x, y))
    for _ in range(2):
        ref.fit(JaxDataSet(x, y))
        port.fit(DataSet(x, y))
    np.testing.assert_allclose(port.get_flat_params(), ref.get_flat_params(),
                               rtol=1e-4, atol=1e-6)
    assert port.iteration_count == ref.iteration_count == 6
    assert port.score(DataSet(x, y)) < s0
