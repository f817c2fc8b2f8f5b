"""Model zoo of the port: the MNIST MLP and LeNet-5.

Port of ``deeplearning4j_tpu/models/zoo.py:21-59``, built with the same
config DSL calls; each builder also takes ``device=`` (``None`` is the
CUDA card). ``char_lstm`` and ``resnet18`` wait for the recurrent layers
(ROADMAP A10.2) and ``ComputationGraph`` (A10.1).
"""

from __future__ import annotations

from deeplearning4j_tpu_torch._device import DeviceLike
from deeplearning4j_tpu_torch.nn.conf import (
    InputType,
    NeuralNetConfiguration,
    Updater,
    WeightInit,
)
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.enums import PoolingType
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops.losses import LossFunction


def mnist_mlp(hidden: int = 256, lr: float = 1e-3, seed: int = 12345,
              dtype_policy: str = "float32",
              device: DeviceLike = None) -> MultiLayerNetwork:
    """MNIST MLP (DenseLayer ×2 + OutputLayer) — BASELINE.md config 1."""
    conf = (
        NeuralNetConfiguration.Builder()
        .seed(seed).learning_rate(lr).updater(Updater.ADAM)
        .weight_init(WeightInit.RELU).dtype_policy(dtype_policy)
        .list()
        .layer(0, L.DenseLayer(n_in=784, n_out=hidden, activation="relu"))
        .layer(1, L.DenseLayer(n_in=hidden, n_out=hidden, activation="relu"))
        .layer(2, L.OutputLayer(n_in=hidden, n_out=10,
                                loss_function=LossFunction.MCXENT))
        .build()
    )
    return MultiLayerNetwork(conf, device=device)


def lenet5(lr: float = 1e-3, seed: int = 12345,
           dtype_policy: str = "float32",
           device: DeviceLike = None) -> MultiLayerNetwork:
    """LeNet-5 on MNIST (conv/pool stack) — BASELINE.md config 2."""
    conf = (
        NeuralNetConfiguration.Builder()
        .seed(seed).learning_rate(lr).updater(Updater.ADAM)
        .weight_init(WeightInit.XAVIER).dtype_policy(dtype_policy)
        .list()
        .layer(0, L.ConvolutionLayer(n_out=20, kernel_size=(5, 5),
                                     activation="relu"))
        .layer(1, L.SubsamplingLayer(pooling_type=PoolingType.MAX,
                                     kernel_size=(2, 2), stride=(2, 2)))
        .layer(2, L.ConvolutionLayer(n_out=50, kernel_size=(5, 5),
                                     activation="relu"))
        .layer(3, L.SubsamplingLayer(pooling_type=PoolingType.MAX,
                                     kernel_size=(2, 2), stride=(2, 2)))
        .layer(4, L.DenseLayer(n_out=500, activation="relu"))
        .layer(5, L.OutputLayer(n_out=10, loss_function=LossFunction.MCXENT))
        .set_input_type(InputType.convolutional(28, 28, 1))
        .build()
    )
    return MultiLayerNetwork(conf, device=device)
