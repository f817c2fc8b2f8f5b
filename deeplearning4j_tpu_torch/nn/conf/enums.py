"""Enums of the config DSL.

Names track the reference's enums so JSON configs use the same vocabulary:
- Updater: nn/conf/Updater.java:10-17
- LearningRatePolicy: nn/conf/LearningRatePolicy.java
- GradientNormalization: nn/conf/GradientNormalization.java
- OptimizationAlgorithm: (Solver dispatch, optimize/Solver.java:57-72)
- BackpropType: nn/conf/MultiLayerConfiguration.java
- WeightInit: nn/weights/WeightInit.java
"""

from __future__ import annotations

import enum


class Updater(str, enum.Enum):
    SGD = "SGD"
    ADAM = "ADAM"
    ADADELTA = "ADADELTA"
    NESTEROVS = "NESTEROVS"
    ADAGRAD = "ADAGRAD"
    RMSPROP = "RMSPROP"
    NONE = "NONE"
    CUSTOM = "CUSTOM"


class WeightInit(str, enum.Enum):
    DISTRIBUTION = "DISTRIBUTION"
    NORMALIZED = "NORMALIZED"
    SIZE = "SIZE"
    UNIFORM = "UNIFORM"
    VI = "VI"
    ZERO = "ZERO"
    ONES = "ONES"
    XAVIER = "XAVIER"
    XAVIER_UNIFORM = "XAVIER_UNIFORM"
    RELU = "RELU"
    LECUN = "LECUN"


class LearningRatePolicy(str, enum.Enum):
    NONE = "None"
    EXPONENTIAL = "Exponential"
    INVERSE = "Inverse"
    POLY = "Poly"
    SIGMOID = "Sigmoid"
    STEP = "Step"
    TORCH_STEP = "TorchStep"
    SCHEDULE = "Schedule"
    SCORE = "Score"


class GradientNormalization(str, enum.Enum):
    NONE = "None"
    RENORMALIZE_L2_PER_LAYER = "RenormalizeL2PerLayer"
    RENORMALIZE_L2_PER_PARAM_TYPE = "RenormalizeL2PerParamType"
    CLIP_ELEMENTWISE_ABSOLUTE_VALUE = "ClipElementWiseAbsoluteValue"
    CLIP_L2_PER_LAYER = "ClipL2PerLayer"
    CLIP_L2_PER_PARAM_TYPE = "ClipL2PerParamType"


class OptimizationAlgorithm(str, enum.Enum):
    LBFGS = "LBFGS"
    LINE_GRADIENT_DESCENT = "LINE_GRADIENT_DESCENT"
    CONJUGATE_GRADIENT = "CONJUGATE_GRADIENT"
    STOCHASTIC_GRADIENT_DESCENT = "STOCHASTIC_GRADIENT_DESCENT"


class BackpropType(str, enum.Enum):
    STANDARD = "Standard"
    TRUNCATED_BPTT = "TruncatedBPTT"


class PoolingType(str, enum.Enum):
    MAX = "MAX"
    AVG = "AVG"
    SUM = "SUM"
    PNORM = "PNORM"


class HiddenUnit(str, enum.Enum):
    """RBM hidden unit types (nn/conf/layers/RBM.java)."""

    BINARY = "BINARY"
    GAUSSIAN = "GAUSSIAN"
    RECTIFIED = "RECTIFIED"
    SOFTMAX = "SOFTMAX"


class VisibleUnit(str, enum.Enum):
    BINARY = "BINARY"
    GAUSSIAN = "GAUSSIAN"
    LINEAR = "LINEAR"
    SOFTMAX = "SOFTMAX"
