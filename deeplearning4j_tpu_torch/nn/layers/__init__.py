"""Executable layers keyed by config class (port of
``deeplearning4j_tpu/nn/layers``): feed-forward, convolution,
normalization and recurrent families. Pretrain layers wait for ROADMAP
A10.3.
"""

from deeplearning4j_tpu_torch.nn.layers.base import (  # noqa: F401
    LayerImpl,
    get_layer_impl,
    register_layer_impl,
)
from deeplearning4j_tpu_torch.nn.layers import feedforward  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers import convolution  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers import normalization  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers import recurrent  # noqa: F401
