"""Model zoo of the port: the MNIST MLP, LeNet-5, the char-LSTM,
ResNet-18 and the transformer LM.

Port of ``deeplearning4j_tpu/models/zoo.py``, built with the same
config DSL calls and the same layer and vertex names; each builder also
takes ``device=`` (``None`` is the CUDA card).
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
from deeplearning4j_tpu_torch.nn.conf.enums import BackpropType, PoolingType
from deeplearning4j_tpu_torch.nn.conf.graph import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
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


def char_lstm(vocab_size: int = 128, hidden: int = 256, layers: int = 2,
              lr: float = 3e-3, tbptt_length: int = 50, seed: int = 12345,
              dtype_policy: str = "float32",
              device: DeviceLike = None) -> MultiLayerNetwork:
    """GravesLSTM char-RNN (tiny-shakespeare style) with TBPTT —
    BASELINE.md config 4."""
    b = (
        NeuralNetConfiguration.Builder()
        .seed(seed).learning_rate(lr).updater(Updater.ADAM)
        .dtype_policy(dtype_policy)
        .list()
    )
    n_in = vocab_size
    for i in range(layers):
        b.layer(i, L.GravesLSTM(n_in=n_in, n_out=hidden, activation="tanh"))
        n_in = hidden
    b.layer(layers, L.RnnOutputLayer(n_in=hidden, n_out=vocab_size,
                                     loss_function=LossFunction.MCXENT))
    conf = (b.backprop_type(BackpropType.TRUNCATED_BPTT)
            .t_bptt_forward_length(tbptt_length)
            .t_bptt_backward_length(tbptt_length)
            .build())
    return MultiLayerNetwork(conf, device=device)


def _res_block(g, name: str, in_name: str, channels: int, stride: int,
               in_channels: int):
    """Two 3x3 conv/BN/relu + identity (or 1x1-projected) skip."""
    g.add_layer(f"{name}_c1", L.ConvolutionLayer(
        n_in=in_channels, n_out=channels, kernel_size=(3, 3),
        stride=(stride, stride), convolution_mode="same"), in_name)
    g.add_layer(f"{name}_b1", L.BatchNormalization(
        n_in=channels, n_out=channels, activation="relu"), f"{name}_c1")
    g.add_layer(f"{name}_c2", L.ConvolutionLayer(
        n_in=channels, n_out=channels, kernel_size=(3, 3),
        convolution_mode="same"), f"{name}_b1")
    g.add_layer(f"{name}_b2", L.BatchNormalization(
        n_in=channels, n_out=channels), f"{name}_c2")
    if stride != 1 or in_channels != channels:
        g.add_layer(f"{name}_proj", L.ConvolutionLayer(
            n_in=in_channels, n_out=channels, kernel_size=(1, 1),
            stride=(stride, stride), convolution_mode="same"), in_name)
        skip = f"{name}_proj"
    else:
        skip = in_name
    g.add_vertex(f"{name}_add", ElementWiseVertex(op="Add"), f"{name}_b2", skip)
    g.add_layer(f"{name}_relu", L.ActivationLayer(activation="relu"),
                f"{name}_add")
    return f"{name}_relu"


def resnet18(num_classes: int = 10, lr: float = 1e-3, seed: int = 12345,
             dtype_policy: str = "float32", image_channels: int = 3,
             device: DeviceLike = None) -> ComputationGraph:
    """ResNet-18-class ComputationGraph for CIFAR-10 — BASELINE.md config 5.

    CIFAR variant: 3x3 stem (no 7x7/maxpool), stages [64,128,256,512]×2
    blocks, global average pool, softmax head.
    """
    g = (
        NeuralNetConfiguration.Builder()
        .seed(seed).learning_rate(lr).updater(Updater.ADAM)
        .weight_init(WeightInit.RELU).dtype_policy(dtype_policy)
        .graph_builder()
        .add_inputs("in")
    )
    g.add_layer("stem", L.ConvolutionLayer(
        n_in=image_channels, n_out=64, kernel_size=(3, 3),
        convolution_mode="same"), "in")
    g.add_layer("stem_bn", L.BatchNormalization(
        n_in=64, n_out=64, activation="relu"), "stem")
    prev, prev_c = "stem_bn", 64
    for stage, channels in enumerate([64, 128, 256, 512]):
        for block in range(2):
            stride = 2 if (stage > 0 and block == 0) else 1
            prev = _res_block(g, f"s{stage}b{block}", prev, channels,
                              stride, prev_c)
            prev_c = channels
    g.add_layer("gap", L.GlobalPoolingLayer(pooling_type=PoolingType.AVG), prev)
    g.add_layer("out", L.OutputLayer(n_in=512, n_out=num_classes,
                                     loss_function=LossFunction.MCXENT), "gap")
    g.set_outputs("out")
    return ComputationGraph(g.build(), device=device)


def transformer_lm(vocab_size: int = 1024, d_model: int = 256,
                   num_heads: int = 8, num_layers: int = 4,
                   max_len: int = 512, lr: float = 3e-4,
                   seed: int = 12345, device: DeviceLike = None):
    """Decoder-only transformer LM, built on the functional transformer
    module (not the DSL), as the reference builds it."""
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerLM)

    return TransformerLM(vocab_size=vocab_size, d_model=d_model,
                         num_heads=num_heads, num_layers=num_layers,
                         max_len=max_len, lr=lr, seed=seed, device=device)
