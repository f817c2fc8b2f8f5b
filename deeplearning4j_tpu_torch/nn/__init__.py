"""The network surface of the port: the config DSL (``nn.conf``), the
layers, the updaters, ``MultiLayerNetwork`` and ``ComputationGraph``,
under the JAX package's import paths."""

from deeplearning4j_tpu_torch.nn.conf import (  # noqa: F401
    ComputationGraphConfiguration,
    InputType,
    LossFunction,
    MultiLayerConfiguration,
    NeuralNetConfiguration,
    Updater,
    WeightInit,
    layers,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: F401
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph  # noqa: F401
