"""Layer configuration dataclasses — the declarative half of the layer zoo.

Mirrors ``nn/conf/layers/`` in the reference (Layer.java:307 base builder
fields; DenseLayer, ConvolutionLayer, SubsamplingLayer, BatchNormalization,
LocalResponseNormalization, EmbeddingLayer, GravesLSTM,
GravesBidirectionalLSTM, GRU, RBM, AutoEncoder, OutputLayer, RnnOutputLayer,
ActivationLayer) with JSON round-trip via a polymorphic ``type`` tag, the way
the reference uses Jackson polymorphic serde.

Port of ``deeplearning4j_tpu/nn/conf/layers.py``: the same dataclasses,
field names and JSON form, so a conf written by either package loads in
the other. Configs are declarative only; the executable layer
(init/forward) lives in ``deeplearning4j_tpu_torch.nn.layers`` keyed by
these classes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Type

from deeplearning4j_tpu_torch.nn.conf.enums import (
    GradientNormalization,
    HiddenUnit,
    LearningRatePolicy,
    PoolingType,
    Updater,
    VisibleUnit,
    WeightInit,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.ops.losses import LossFunction

_LAYER_REGISTRY: Dict[str, Type["LayerConf"]] = {}


def register_layer_conf(cls):
    _LAYER_REGISTRY[cls.__name__] = cls
    return cls


@dataclasses.dataclass
class LayerConf:
    """Base layer config. Field names follow the reference's builder DSL."""

    name: Optional[str] = None
    activation: str = "sigmoid"
    weight_init: WeightInit = WeightInit.XAVIER
    dist: Optional[dict] = None  # for WeightInit.DISTRIBUTION
    bias_init: float = 0.0
    learning_rate: Optional[float] = None  # None → inherit global
    bias_learning_rate: Optional[float] = None
    l1: float = 0.0
    l2: float = 0.0
    dropout: float = 0.0  # keep-nothing prob as in reference (0 = off)
    updater: Optional[Updater] = None  # None → inherit global
    momentum: Optional[float] = None
    rho: Optional[float] = None
    epsilon: Optional[float] = None
    rms_decay: Optional[float] = None
    adam_mean_decay: Optional[float] = None
    adam_var_decay: Optional[float] = None
    gradient_normalization: Optional[GradientNormalization] = None
    gradient_normalization_threshold: float = 1.0
    n_in: Optional[int] = None
    n_out: Optional[int] = None

    # --- serde ---------------------------------------------------------
    def to_dict(self) -> dict:
        d = {"type": type(self).__name__}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None:
                continue
            if isinstance(v, (WeightInit, Updater, GradientNormalization,
                              LossFunction, PoolingType, HiddenUnit,
                              VisibleUnit, LearningRatePolicy)):
                v = v.value
            d[f.name] = v
        return d

    @staticmethod
    def from_dict(d: dict) -> "LayerConf":
        d = dict(d)
        tname = d.pop("type")
        cls = _LAYER_REGISTRY.get(tname)
        if cls is None:
            raise ValueError(f"unknown layer type {tname!r}")
        field_types = {f.name: f.type for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in d.items():
            if k not in field_types:
                continue
            kwargs[k] = _coerce(k, v)
        return cls(**kwargs)

    # --- shape inference ----------------------------------------------
    def output_type(self, input_type: InputType) -> InputType:
        """Output InputType given input; default: dense-like FF mapping."""
        n_out = self.n_out if self.n_out is not None else input_type.flat_size()
        return InputType.feed_forward(n_out)

    def infer_n_in(self, input_type: InputType) -> None:
        if self.n_in is None:
            self.n_in = input_type.flat_size()


_ENUM_FIELDS = {
    "weight_init": WeightInit,
    "updater": Updater,
    "gradient_normalization": GradientNormalization,
    "loss_function": LossFunction,
    "pooling_type": PoolingType,
    "hidden_unit": HiddenUnit,
    "visible_unit": VisibleUnit,
}


def _coerce(key: str, v: Any) -> Any:
    if v is None:
        return None
    enum_cls = _ENUM_FIELDS.get(key)
    if enum_cls is not None and isinstance(v, str):
        return enum_cls(v)
    if isinstance(v, list):
        return tuple(v) if key in ("kernel_size", "stride", "padding") else v
    return v


@register_layer_conf
@dataclasses.dataclass
class DenseLayer(LayerConf):
    """Fully connected layer (nn/conf/layers/DenseLayer.java)."""


@register_layer_conf
@dataclasses.dataclass
class OutputLayer(LayerConf):
    """Dense + loss head (nn/conf/layers/OutputLayer.java)."""

    loss_function: LossFunction = LossFunction.MCXENT
    activation: str = "softmax"


@register_layer_conf
@dataclasses.dataclass
class RnnOutputLayer(OutputLayer):
    """Per-timestep output head (nn/layers/recurrent/RnnOutputLayer.java)."""

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timeseries_length)


@register_layer_conf
@dataclasses.dataclass
class LossLayer(LayerConf):
    """Loss-only layer (no params): output == input, scored by loss."""

    loss_function: LossFunction = LossFunction.MCXENT
    activation: str = "identity"

    def output_type(self, input_type: InputType) -> InputType:
        return input_type


@register_layer_conf
@dataclasses.dataclass
class EmbeddingLayer(LayerConf):
    """Index → row lookup (nn/layers/feedforward/embedding/EmbeddingLayer.java:
    equivalent to one-hot times dense, implemented as a row gather)."""

    activation: str = "identity"


@register_layer_conf
@dataclasses.dataclass
class ActivationLayer(LayerConf):
    """Activation-only layer (nn/layers/ActivationLayer.java)."""

    def output_type(self, input_type: InputType) -> InputType:
        return input_type


@register_layer_conf
@dataclasses.dataclass
class DropoutLayer(LayerConf):
    """Dropout-only layer."""

    def output_type(self, input_type: InputType) -> InputType:
        return input_type


@register_layer_conf
@dataclasses.dataclass
class ConvolutionLayer(LayerConf):
    """2-D convolution (nn/conf/layers/ConvolutionLayer.java).

    Executed with ``F.conv2d`` on a channels-last view of the NHWC input,
    not the reference's im2col+GEMM (ConvolutionLayer.java:109,135).
    """

    kernel_size: Tuple[int, int] = (5, 5)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    activation: str = "identity"
    convolution_mode: str = "truncate"  # truncate|same

    def output_type(self, input_type: InputType) -> InputType:
        assert input_type.kind == "CNN", "ConvolutionLayer needs CNN input"
        kh, kw = self.kernel_size
        sh, sw = self.stride
        ph, pw = self.padding
        if self.convolution_mode == "same":
            oh = -(-input_type.height // sh)
            ow = -(-input_type.width // sw)
        else:
            oh = (input_type.height + 2 * ph - kh) // sh + 1
            ow = (input_type.width + 2 * pw - kw) // sw + 1
        return InputType.convolutional(oh, ow, self.n_out)

    def infer_n_in(self, input_type: InputType) -> None:
        if self.n_in is None:
            assert input_type.kind == "CNN"
            self.n_in = input_type.channels


@register_layer_conf
@dataclasses.dataclass
class SubsamplingLayer(LayerConf):
    """Pooling layer (nn/conf/layers/SubsamplingLayer.java; MAX/AVG/SUM as in
    nn/layers/convolution/subsampling/SubsamplingLayer.java)."""

    pooling_type: PoolingType = PoolingType.MAX
    kernel_size: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)
    pnorm: int = 2
    activation: str = "identity"

    def output_type(self, input_type: InputType) -> InputType:
        assert input_type.kind == "CNN"
        kh, kw = self.kernel_size
        sh, sw = self.stride
        ph, pw = self.padding
        oh = (input_type.height + 2 * ph - kh) // sh + 1
        ow = (input_type.width + 2 * pw - kw) // sw + 1
        return InputType.convolutional(oh, ow, input_type.channels)

    def infer_n_in(self, input_type: InputType) -> None:
        pass  # no params


@register_layer_conf
@dataclasses.dataclass
class GlobalPoolingLayer(LayerConf):
    """Global pooling over spatial (CNN) or time (RNN) axes → FF output.
    Mask-aware for variable-length series."""

    pooling_type: PoolingType = PoolingType.AVG
    pnorm: int = 2
    activation: str = "identity"

    def output_type(self, input_type: InputType) -> InputType:
        if input_type.kind == "CNN":
            return InputType.feed_forward(input_type.channels)
        return InputType.feed_forward(input_type.size)

    def infer_n_in(self, input_type: InputType) -> None:
        pass  # no params


@register_layer_conf
@dataclasses.dataclass
class BatchNormalization(LayerConf):
    """Batch norm (nn/layers/normalization/BatchNormalization.java: batch
    stats at :146-147, γ/β, lockGammaBeta :85, running-mean decay)."""

    decay: float = 0.9
    eps: float = 1e-5
    gamma: float = 1.0
    beta: float = 0.0
    lock_gamma_beta: bool = False
    activation: str = "identity"

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def infer_n_in(self, input_type: InputType) -> None:
        if self.n_in is None:
            if input_type.kind == "CNN":
                self.n_in = input_type.channels
            else:
                self.n_in = input_type.flat_size()
        if self.n_out is None:
            self.n_out = self.n_in


@register_layer_conf
@dataclasses.dataclass
class LocalResponseNormalization(LayerConf):
    """LRN (nn/layers/normalization/LocalResponseNormalization.java)."""

    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75
    activation: str = "identity"

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def infer_n_in(self, input_type: InputType) -> None:
        pass


@dataclasses.dataclass
class BaseRecurrentConf(LayerConf):
    activation: str = "tanh"
    forget_gate_bias_init: float = 1.0

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timeseries_length)


@register_layer_conf
@dataclasses.dataclass
class GravesLSTM(BaseRecurrentConf):
    """LSTM with peepholes, after Graves (2013) — the reference's
    nn/layers/recurrent/GravesLSTM.java + LSTMHelpers.java:45. Executed as a
    single input-GEMM over all timesteps + a loop over the recurrence."""


@register_layer_conf
@dataclasses.dataclass
class GravesBidirectionalLSTM(BaseRecurrentConf):
    """Bidirectional Graves LSTM (GravesBidirectionalLSTM.java): forward and
    backward passes each n_out wide, summed (reference ADD mode)."""


@register_layer_conf
@dataclasses.dataclass
class GRU(BaseRecurrentConf):
    """GRU (nn/layers/recurrent/GRU.java)."""


@register_layer_conf
@dataclasses.dataclass
class LSTM(BaseRecurrentConf):
    """Standard LSTM without peepholes (modern variant; not in the reference
    layer zoo but required for the transformer/long-context stack)."""


@register_layer_conf
@dataclasses.dataclass
class ImageLSTM(BaseRecurrentConf):
    """Image-captioning LSTM (nn/layers/recurrent/ImageLSTM.java, 503 LoC —
    "based on Karpathy et al.'s work on generation of image descriptions"):
    an image representation is consumed as the first timestep conditioning
    an LSTM over word vectors, with a projection to the output vocabulary
    at every step and beam-search decoding. ``hidden_size`` defaults to
    ``n_out`` when unset; params mirror the reference's RW (combined
    input+recurrent gate weights), W (hidden→output), b."""

    hidden_size: Optional[int] = None


@register_layer_conf
@dataclasses.dataclass
class AutoEncoder(LayerConf):
    """Denoising autoencoder (nn/layers/feedforward/autoencoder/
    AutoEncoder.java): corruption_level = input dropout noise for pretraining."""

    corruption_level: float = 0.3
    sparsity: float = 0.0
    loss_function: LossFunction = LossFunction.RECONSTRUCTION_CROSSENTROPY
    activation: str = "sigmoid"


@register_layer_conf
@dataclasses.dataclass
class RecursiveAutoEncoder(LayerConf):
    """Recursive autoencoder (nn/layers/feedforward/autoencoder/recursive/
    RecursiveAutoEncoder.java, 162): folds a (batch, time, n_in) sequence
    left-to-right through a shared encoder, accumulating a per-fold
    reconstruction loss; forward output is the root encoding (batch, n_out).
    The fold is a loop over the sequence."""

    loss_function: LossFunction = LossFunction.MSE
    activation: str = "tanh"


@register_layer_conf
@dataclasses.dataclass
class RBM(LayerConf):
    """Restricted Boltzmann machine (nn/layers/feedforward/rbm/RBM.java:68,
    CD-k at :101). Gibbs sampling uses functional PRNG keys threaded through
    the pretrain step instead of a global RNG."""

    hidden_unit: HiddenUnit = HiddenUnit.BINARY
    visible_unit: VisibleUnit = VisibleUnit.BINARY
    k: int = 1
    sparsity: float = 0.0
    loss_function: LossFunction = LossFunction.RECONSTRUCTION_CROSSENTROPY
    activation: str = "sigmoid"
