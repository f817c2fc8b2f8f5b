"""NeuralNetConfiguration / MultiLayerConfiguration + builders.

Port of ``deeplearning4j_tpu/nn/conf/neural_net.py``: the same builder
DSL, shape inference and JSON (``to_dict`` is key for key the
reference's, so a JSON written by either package loads in the other).

The public config DSL, mirroring ``nn/conf/NeuralNetConfiguration.java`` (731
LoC: Builder + ListBuilder :145, per-param lr/l1/l2, toJson/fromJson :214-239)
and ``nn/conf/MultiLayerConfiguration.java`` (backprop/pretrain flags,
BackpropType, tBPTT lengths, InputPreProcessor map). JSON round-trip is a hard
API requirement: it is also the wire format for shipping model definitions to
distributed workers (the reference broadcasts ``conf.toJson()`` to Spark
executors, SparkDl4jMultiLayer.java:387).
"""

from __future__ import annotations

import copy
import dataclasses
import json
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.nn.conf.enums import (
    BackpropType,
    GradientNormalization,
    LearningRatePolicy,
    OptimizationAlgorithm,
    Updater,
    WeightInit,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import LayerConf
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor,
    FeedForwardToCnnPreProcessor,
    FeedForwardToRnnPreProcessor,
    InputPreProcessor,
    RnnToFeedForwardPreProcessor,
)

_ENUMS = {
    "optimization_algo": OptimizationAlgorithm,
    "updater": Updater,
    "weight_init": WeightInit,
    "lr_policy": LearningRatePolicy,
    "gradient_normalization": GradientNormalization,
    "backprop_type": BackpropType,
}


@dataclasses.dataclass
class GlobalConf:
    """Network-wide defaults + training hyperparameters."""

    seed: int = 12345
    iterations: int = 1  # optimizer iterations per fit minibatch (reference default)
    optimization_algo: OptimizationAlgorithm = (
        OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT
    )
    learning_rate: float = 0.1
    lr_policy: LearningRatePolicy = LearningRatePolicy.NONE
    lr_policy_decay_rate: float = 0.0
    lr_policy_steps: float = 1.0
    lr_policy_power: float = 1.0
    lr_schedule: Optional[Dict[int, float]] = None  # iteration → lr
    # iteration → momentum, sticky from each key on (the reference's
    # momentumAfter / Layer.momentumSchedule, BaseUpdater.java:75-80)
    momentum_schedule: Optional[Dict[int, float]] = None
    lr_score_based_decay_rate: float = 0.0
    max_num_line_search_iterations: int = 5
    minibatch: bool = True  # divide loss/gradient by minibatch size
    use_drop_connect: bool = False
    mini_batch_size_divisor: Optional[int] = None
    dtype_policy: str = "float32"

    def to_dict(self) -> dict:
        d = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None:
                continue
            if hasattr(v, "value"):
                v = v.value
            d[f.name] = v
        return d

    @staticmethod
    def from_dict(d: dict) -> "GlobalConf":
        kwargs = {}
        names = {f.name for f in dataclasses.fields(GlobalConf)}
        for k, v in d.items():
            if k not in names:
                continue
            if k in _ENUMS and isinstance(v, str):
                v = _ENUMS[k](v)
            if k in ("lr_schedule", "momentum_schedule") and v is not None:
                v = {int(i): float(x) for i, x in v.items()}
            kwargs[k] = v
        return GlobalConf(**kwargs)


def _compat_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: the YAML and reference-format JSON of configurations are "
        "not ported yet (ROADMAP A10.6)")


class MultiLayerConfiguration:
    """Sequential-network configuration: global conf + ordered layer confs +
    preprocessor map + backprop/pretrain/TBPTT flags."""

    def __init__(
        self,
        global_conf: GlobalConf,
        layers: List[LayerConf],
        input_preprocessors: Optional[Dict[int, InputPreProcessor]] = None,
        backprop: bool = True,
        pretrain: bool = False,
        backprop_type: BackpropType = BackpropType.STANDARD,
        tbptt_fwd_length: int = 20,
        tbptt_back_length: int = 20,
        input_type: Optional[InputType] = None,
    ):
        self.global_conf = global_conf
        self.layers = layers
        self.input_preprocessors = input_preprocessors or {}
        self.backprop = backprop
        self.pretrain = pretrain
        self.backprop_type = backprop_type
        self.tbptt_fwd_length = tbptt_fwd_length
        self.tbptt_back_length = tbptt_back_length
        self.input_type = input_type

    # --- serde ---------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "format": "deeplearning4j-tpu/MultiLayerConfiguration",
            "version": 1,
            "global": self.global_conf.to_dict(),
            "layers": [l.to_dict() for l in self.layers],
            "preprocessors": {
                str(i): p.to_dict() for i, p in self.input_preprocessors.items()
            },
            "backprop": self.backprop,
            "pretrain": self.pretrain,
            "backprop_type": self.backprop_type.value,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
            "input_type": self.input_type.to_dict() if self.input_type else None,
        }

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @staticmethod
    def from_dict(d: dict) -> "MultiLayerConfiguration":
        conf = MultiLayerConfiguration(
            global_conf=GlobalConf.from_dict(d.get("global", {})),
            layers=[LayerConf.from_dict(ld) for ld in d["layers"]],
            input_preprocessors={
                int(i): InputPreProcessor.from_dict(pd)
                for i, pd in d.get("preprocessors", {}).items()
            },
            backprop=d.get("backprop", True),
            pretrain=d.get("pretrain", False),
            backprop_type=BackpropType(d.get("backprop_type", "Standard")),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
            input_type=(
                InputType.from_dict(d["input_type"]) if d.get("input_type") else None
            ),
        )
        return conf

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration.from_dict(json.loads(s))

    # YAML and the reference's Jackson JSON (``nn/conf/compat.py`` and
    # ``utils/yamlio.py`` in the JAX package) are not ported yet
    def to_yaml(self) -> str:
        raise _compat_not_ported("to_yaml")

    @staticmethod
    def from_yaml(s: str) -> "MultiLayerConfiguration":
        """Accepts JSON (valid YAML, and this method's historical input);
        block-style YAML is not ported yet."""
        try:
            return MultiLayerConfiguration.from_json(s)
        except json.JSONDecodeError:
            raise _compat_not_ported("from_yaml of block-style YAML") from None

    @staticmethod
    def from_reference_json(s: str) -> "MultiLayerConfiguration":
        raise _compat_not_ported("from_reference_json")

    @staticmethod
    def from_reference_yaml(s: str) -> "MultiLayerConfiguration":
        raise _compat_not_ported("from_reference_yaml")

    def to_reference_json(self) -> str:
        raise _compat_not_ported("to_reference_json")

    def to_reference_yaml(self) -> str:
        raise _compat_not_ported("to_reference_yaml")

    def __eq__(self, other):
        return (
            isinstance(other, MultiLayerConfiguration)
            and self.to_dict() == other.to_dict()
        )

    def clone(self) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration.from_dict(copy.deepcopy(self.to_dict()))


class NeuralNetConfiguration:
    """Entry point of the DSL: ``NeuralNetConfiguration.Builder()``."""

    class Builder:
        def __init__(self):
            self._global = GlobalConf()
            # layer-field defaults the user set globally; applied to layers
            # whose field still holds its dataclass default (layer overrides
            # global, as in the reference where layers clone the global conf).
            self._layer_defaults: Dict[str, Any] = {}

        # global trainer settings -----------------------------------
        def seed(self, s: int):
            self._global.seed = int(s)
            return self

        def iterations(self, n: int):
            self._global.iterations = int(n)
            return self

        def optimization_algo(self, algo: OptimizationAlgorithm):
            self._global.optimization_algo = OptimizationAlgorithm(algo)
            return self

        def learning_rate(self, lr: float):
            self._global.learning_rate = float(lr)
            self._layer_defaults["learning_rate"] = float(lr)
            return self

        def bias_learning_rate(self, lr: float):
            self._layer_defaults["bias_learning_rate"] = float(lr)
            return self

        def learning_rate_decay_policy(self, policy: LearningRatePolicy):
            self._global.lr_policy = LearningRatePolicy(policy)
            return self

        def lr_policy_decay_rate(self, r: float):
            self._global.lr_policy_decay_rate = float(r)
            return self

        def lr_policy_steps(self, s: float):
            self._global.lr_policy_steps = float(s)
            return self

        def lr_policy_power(self, p: float):
            self._global.lr_policy_power = float(p)
            return self

        def learning_rate_schedule(self, schedule: Dict[int, float]):
            self._global.lr_schedule = dict(schedule)
            self._global.lr_policy = LearningRatePolicy.SCHEDULE
            return self

        def learning_rate_score_based_decay_rate(self, r: float):
            self._global.lr_score_based_decay_rate = float(r)
            self._global.lr_policy = LearningRatePolicy.SCORE
            return self

        def momentum_after(self, schedule: Dict[int, float]):
            """Iteration → momentum, sticky from each key on (the
            reference's ``momentumAfter``,
            NeuralNetConfiguration.java:550)."""
            self._global.momentum_schedule = {
                int(k): float(v) for k, v in schedule.items()}
            return self

        def max_num_line_search_iterations(self, n: int):
            self._global.max_num_line_search_iterations = int(n)
            return self

        def minibatch(self, b: bool):
            self._global.minibatch = bool(b)
            return self

        def use_drop_connect(self, b: bool):
            self._global.use_drop_connect = bool(b)
            return self

        def dtype_policy(self, name: str):
            self._global.dtype_policy = name
            return self

        # layer-field global defaults --------------------------------
        def updater(self, u: Updater):
            self._layer_defaults["updater"] = Updater(u)
            return self

        def activation(self, a: str):
            self._layer_defaults["activation"] = a
            return self

        def weight_init(self, w: WeightInit):
            self._layer_defaults["weight_init"] = WeightInit(w)
            return self

        def dist(self, d: dict):
            self._layer_defaults["dist"] = dict(d)
            return self

        def bias_init(self, b: float):
            self._layer_defaults["bias_init"] = float(b)
            return self

        def l1(self, v: float):
            self._layer_defaults["l1"] = float(v)
            return self

        def l2(self, v: float):
            self._layer_defaults["l2"] = float(v)
            return self

        def drop_out(self, v: float):
            self._layer_defaults["dropout"] = float(v)
            return self

        def momentum(self, v: float):
            self._layer_defaults["momentum"] = float(v)
            return self

        def rho(self, v: float):
            self._layer_defaults["rho"] = float(v)
            return self

        def epsilon(self, v: float):
            self._layer_defaults["epsilon"] = float(v)
            return self

        def rms_decay(self, v: float):
            self._layer_defaults["rms_decay"] = float(v)
            return self

        def adam_mean_decay(self, v: float):
            self._layer_defaults["adam_mean_decay"] = float(v)
            return self

        def adam_var_decay(self, v: float):
            self._layer_defaults["adam_var_decay"] = float(v)
            return self

        def gradient_normalization(self, g: GradientNormalization):
            self._layer_defaults["gradient_normalization"] = GradientNormalization(g)
            return self

        def gradient_normalization_threshold(self, t: float):
            self._layer_defaults["gradient_normalization_threshold"] = float(t)
            return self

        def regularization(self, b: bool):
            # kept for API parity; l1/l2 of 0 are already no-ops
            return self

        # transitions -------------------------------------------------
        def list(self) -> "ListBuilder":
            return ListBuilder(self._global, dict(self._layer_defaults))

        def graph_builder(self):
            from deeplearning4j_tpu_torch.nn.conf.graph import GraphBuilder

            return GraphBuilder(self._global, dict(self._layer_defaults))

        def layer(self, layer_conf: LayerConf):
            """Single-layer config (reference: .layer(new RBM...) w/o list)."""
            return self.list().layer(0, layer_conf)


def apply_layer_defaults(layer: LayerConf, defaults: Dict[str, Any]) -> None:
    """Fill globally-set builder defaults into layer fields the user left at
    their dataclass default value."""
    field_defaults = {
        f.name: f.default for f in dataclasses.fields(type(layer))
        if f.default is not dataclasses.MISSING
    }
    for key, value in defaults.items():
        if not hasattr(layer, key):
            continue
        if key in field_defaults and getattr(layer, key) == field_defaults[key]:
            setattr(layer, key, value)


class ListBuilder:
    """Sequential builder (``NeuralNetConfiguration.ListBuilder`` :145)."""

    def __init__(self, global_conf: GlobalConf, layer_defaults: Dict[str, Any]):
        self._global = global_conf
        self._defaults = layer_defaults
        self._layers: Dict[int, LayerConf] = {}
        self._preprocessors: Dict[int, InputPreProcessor] = {}
        self._backprop = True
        self._pretrain = False
        self._backprop_type = BackpropType.STANDARD
        self._tbptt_fwd = 20
        self._tbptt_back = 20
        self._input_type: Optional[InputType] = None

    def layer(self, index_or_conf, conf: Optional[LayerConf] = None) -> "ListBuilder":
        if conf is None:
            index, conf = len(self._layers), index_or_conf
        else:
            index = int(index_or_conf)
        self._layers[index] = conf
        return self

    def input_pre_processor(self, index: int, p: InputPreProcessor) -> "ListBuilder":
        self._preprocessors[int(index)] = p
        return self

    def backprop(self, b: bool) -> "ListBuilder":
        self._backprop = bool(b)
        return self

    def pretrain(self, b: bool) -> "ListBuilder":
        self._pretrain = bool(b)
        return self

    def backprop_type(self, t: BackpropType) -> "ListBuilder":
        self._backprop_type = BackpropType(t)
        return self

    def t_bptt_forward_length(self, n: int) -> "ListBuilder":
        self._tbptt_fwd = int(n)
        return self

    def t_bptt_backward_length(self, n: int) -> "ListBuilder":
        self._tbptt_back = int(n)
        return self

    def set_input_type(self, input_type: InputType) -> "ListBuilder":
        self._input_type = input_type
        return self

    def build(self) -> MultiLayerConfiguration:
        if not self._layers:
            raise ValueError("no layers configured")
        indices = sorted(self._layers)
        if indices != list(range(len(indices))):
            raise ValueError(f"layer indices must be contiguous from 0, got {indices}")
        layers = [self._layers[i] for i in indices]
        for l in layers:
            apply_layer_defaults(l, self._defaults)
        if self._input_type is not None:
            _infer_shapes_and_preprocessors(
                layers, self._preprocessors, self._input_type
            )
        _validate(layers)
        return MultiLayerConfiguration(
            global_conf=self._global,
            layers=layers,
            input_preprocessors=self._preprocessors,
            backprop=self._backprop,
            pretrain=self._pretrain,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
            input_type=self._input_type,
        )


def _infer_shapes_and_preprocessors(
    layers: List[LayerConf],
    preprocessors: Dict[int, InputPreProcessor],
    input_type: InputType,
) -> None:
    """Walk the layer list inferring n_in and auto-inserting rank adapters —
    the reference's ConvolutionLayerSetup pass generalised to all families."""
    from deeplearning4j_tpu_torch.nn.conf import layers as L

    current = input_type
    for i, layer in enumerate(layers):
        expected = _expected_kind(layer)
        if i not in preprocessors and expected is not None and current.kind != expected:
            p = _auto_preprocessor(current, expected)
            if p is not None:
                preprocessors[i] = p
                current = p.output_type(current)
        elif i in preprocessors:
            current = preprocessors[i].output_type(current)
        layer.infer_n_in(current)
        if layer.n_out is None and not isinstance(
            layer, (L.SubsamplingLayer, L.ActivationLayer, L.BatchNormalization,
                    L.LocalResponseNormalization, L.LossLayer, L.DropoutLayer,
                    L.GlobalPoolingLayer)
        ):
            raise ValueError(f"layer {i} ({type(layer).__name__}) needs n_out")
        current = layer.output_type(current)


def _expected_kind(layer) -> Optional[str]:
    from deeplearning4j_tpu_torch.nn.conf import layers as L

    if isinstance(layer, (L.ConvolutionLayer, L.SubsamplingLayer,
                          L.LocalResponseNormalization)):
        return "CNN"
    if isinstance(layer, (L.GravesLSTM, L.GravesBidirectionalLSTM, L.GRU,
                          L.LSTM, L.RnnOutputLayer)):
        return "RNN"
    if isinstance(layer, (L.DenseLayer, L.OutputLayer, L.AutoEncoder, L.RBM,
                          L.EmbeddingLayer)):
        return "FF"
    return None  # BatchNorm/Activation/Loss/Dropout accept any rank


def _auto_preprocessor(current: InputType, expected: str):
    if current.kind == "CNN" and expected == "FF":
        return CnnToFeedForwardPreProcessor(
            current.height, current.width, current.channels
        )
    if current.kind == "FF" and expected == "RNN":
        return FeedForwardToRnnPreProcessor()
    if current.kind == "RNN" and expected == "FF":
        return RnnToFeedForwardPreProcessor()
    if current.kind == "CNN" and expected == "RNN":
        from deeplearning4j_tpu_torch.nn.conf.preprocessors import CnnToRnnPreProcessor

        return CnnToRnnPreProcessor(current.height, current.width, current.channels)
    return None


def _validate(layers: List[LayerConf]) -> None:
    from deeplearning4j_tpu_torch.nn.conf import layers as L

    for i, layer in enumerate(layers):
        needs_nin = not isinstance(
            layer, (L.SubsamplingLayer, L.ActivationLayer, L.LossLayer,
                    L.DropoutLayer, L.LocalResponseNormalization,
                    L.BatchNormalization, L.GlobalPoolingLayer)
        )
        if needs_nin and (layer.n_in is None or layer.n_out is None):
            raise ValueError(
                f"layer {i} ({type(layer).__name__}): n_in/n_out unset — set them "
                "explicitly or call set_input_type(...)"
            )
