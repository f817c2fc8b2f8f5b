"""Models of the port: the zoo's DSL networks (``zoo.py``), the
transformer LM (``transformer.py``) and the recursive neural tensor network
over parse trees (``rntn.py``)."""

from deeplearning4j_tpu_torch.models.zoo import (  # noqa: F401
    char_lstm,
    lenet5,
    mnist_mlp,
    resnet18,
    transformer_lm,
)
from deeplearning4j_tpu_torch.models.rntn import RNTN  # noqa: F401
