"""Config DSL package (port of ``deeplearning4j_tpu/nn/conf``)."""

from deeplearning4j_tpu_torch.nn.conf.enums import (  # noqa: F401
    BackpropType,
    GradientNormalization,
    HiddenUnit,
    LearningRatePolicy,
    OptimizationAlgorithm,
    PoolingType,
    Updater,
    VisibleUnit,
    WeightInit,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf import layers  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf.layers import LayerConf  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf import preprocessors  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf.preprocessors import InputPreProcessor  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf.neural_net import (  # noqa: F401
    GlobalConf,
    ListBuilder,
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.graph import (  # noqa: F401
    ComputationGraphConfiguration,
    DuplicateToTimeSeriesVertex,
    ElementWiseVertex,
    GraphBuilder,
    GraphVertexConf,
    LastTimeStepVertex,
    MergeVertex,
    ScaleVertex,
    SubsetVertex,
)
from deeplearning4j_tpu_torch.ops.losses import LossFunction  # noqa: F401
