"""Port parity for the config DSL: ``NeuralNetConfiguration`` builders,
shape inference, preprocessor insertion and JSON, against
``deeplearning4j_tpu.nn.conf``. Configurations are data, so every check
here is exact equality of ``to_dict()``."""

import importlib
import json

import pytest

from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration as JaxMLC
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration

PKGS = ("deeplearning4j_tpu", "deeplearning4j_tpu_torch")


def _zoo_conf(pkg_zoo, name, **kw):
    if pkg_zoo is zoo:
        kw["device"] = "cpu"
    if name == "mnist_mlp":
        kw["hidden"] = 32
    return getattr(pkg_zoo, name)(**kw).conf


@pytest.mark.parametrize("name", ["mnist_mlp", "lenet5"])
@pytest.mark.parametrize("policy", ["float32", "bf16"])
def test_zoo_confs_equal(name, policy):
    a = _zoo_conf(jax_zoo, name, dtype_policy=policy).to_dict()
    b = _zoo_conf(zoo, name, dtype_policy=policy).to_dict()
    assert a == b
    if name == "lenet5":
        # the inferred dense n_in and the auto-inserted NHWC flatten
        assert b["layers"][4]["n_in"] == 800
        assert b["preprocessors"] == {"4": {
            "type": "CnnToFeedForwardPreProcessor",
            "height": 4, "width": 4, "channels": 50}}


@pytest.mark.parametrize("name", ["mnist_mlp", "lenet5"])
def test_json_crosses_between_packages(name):
    jax_conf = _zoo_conf(jax_zoo, name)
    port_conf = _zoo_conf(zoo, name)
    from_jax = MultiLayerConfiguration.from_json(jax_conf.to_json())
    assert from_jax == port_conf
    assert from_jax.to_json() == jax_conf.to_json()
    from_port = JaxMLC.from_json(port_conf.to_json())
    assert from_port == jax_conf
    assert port_conf.clone() == port_conf
    assert MultiLayerConfiguration.from_yaml(port_conf.to_json()) == port_conf


def _built(pkg: str) -> dict:
    """One builder exercising the global layer defaults, per package."""
    conf = importlib.import_module(pkg + ".nn.conf")
    L = conf.layers
    return (
        conf.NeuralNetConfiguration.Builder()
        .seed(7).learning_rate(0.05).bias_learning_rate(0.01)
        .updater(conf.Updater.NESTEROVS).momentum(0.8)
        .activation("tanh").weight_init(conf.WeightInit.XAVIER_UNIFORM)
        .l1(1e-4).l2(1e-3).drop_out(0.25).bias_init(0.1)
        .gradient_normalization(conf.GradientNormalization.CLIP_L2_PER_LAYER)
        .gradient_normalization_threshold(2.0)
        .learning_rate_decay_policy(conf.LearningRatePolicy.STEP)
        .lr_policy_decay_rate(0.5).lr_policy_steps(3)
        .momentum_after({2: 0.5})
        .list()
        .layer(0, L.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                     stride=(2, 2), convolution_mode="same"))
        .layer(1, L.SubsamplingLayer(pooling_type=conf.PoolingType.AVG,
                                     kernel_size=(2, 2), stride=(1, 1),
                                     padding=(1, 1)))
        # layer values beat the globals
        .layer(2, L.DenseLayer(n_out=6, activation="relu", l2=0.0,
                               updater=conf.Updater.ADAM))
        .layer(3, L.OutputLayer(n_out=3,
                                loss_function=conf.LossFunction.MSE,
                                activation="identity"))
        .set_input_type(conf.InputType.convolutional(9, 7, 2))
        .build()
    ).to_dict()


def test_builder_defaults_apply_as_in_jax():
    a, b = (_built(p) for p in PKGS)
    assert a == b
    dense = b["layers"][2]
    assert dense["activation"] == "relu" and dense["updater"] == "ADAM"
    assert dense["l1"] == 1e-4 and dense["l2"] == 1e-3  # 0.0 is the default
    # SAME stride 2 on 9x7: 5x4; pool 2x2, stride 1, pad 1: 6x5; 4 channels
    assert dense["n_in"] == 6 * 5 * 4
    assert b["layers"][0]["activation"] == "tanh"
    assert b["global"]["momentum_schedule"] == {2: 0.5}
    assert json.loads(json.dumps(b)) == json.loads(json.dumps(a))


def _outcome(fn):
    """What ``fn()`` gives: its text (a configuration as its JSON), or the
    type and message of what it raised."""
    try:
        out = fn()
    except Exception as e:  # the reference's errors are part of the API
        return type(e).__name__, str(e)
    return out if isinstance(out, str) else out.to_json()


@pytest.mark.parametrize("call", [
    lambda C, c: c.to_yaml(),
    lambda C, c: c.to_reference_json(),
    lambda C, c: c.to_reference_yaml(),
    lambda C, c: C.from_reference_json("{}"),
    lambda C, c: C.from_reference_yaml("a: 1"),
    lambda C, c: C.from_yaml("global:\n  seed: 1\n"),
    lambda C, c: C.from_yaml(c.to_yaml()),
], ids=["to_yaml", "to_reference_json", "to_reference_yaml",
        "from_reference_json", "from_reference_yaml", "from_yaml_block",
        "from_yaml_round_trip"])
def test_compat_formats_raise_with_their_item(call):
    """The YAML and reference-format methods (ROADMAP A10.6, ported): each
    gives the JAX package's text, or raises what it raises."""
    ours = _outcome(lambda: call(MultiLayerConfiguration,
                                 _zoo_conf(zoo, "mnist_mlp")))
    theirs = _outcome(lambda: call(JaxMLC, _zoo_conf(jax_zoo, "mnist_mlp")))
    assert ours == theirs


def test_graph_builder_raises_with_its_item():
    """``graph_builder()`` builds a graph configuration (ROADMAP A10.1 is
    done); its YAML round-trips (A10.6 is done too)."""
    from deeplearning4j_tpu_torch.nn.conf import (
        GraphBuilder,
        NeuralNetConfiguration,
        layers as L,
    )

    g = NeuralNetConfiguration.Builder().graph_builder()
    assert isinstance(g, GraphBuilder)
    conf = (g.add_inputs("in")
            .add_layer("out", L.OutputLayer(n_in=4, n_out=2), "in")
            .set_outputs("out").build())
    assert conf.topological_order == ["in", "out"]
    assert type(conf).from_yaml(conf.to_yaml()) == conf
