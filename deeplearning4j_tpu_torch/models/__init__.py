"""Models of the port: the zoo's DSL networks (``zoo.py``) and the
transformer LM (``transformer.py``)."""

from deeplearning4j_tpu_torch.models.zoo import (  # noqa: F401
    char_lstm,
    lenet5,
    mnist_mlp,
    resnet18,
    transformer_lm,
)
