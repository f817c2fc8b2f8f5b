"""Models of the port: the zoo's DSL networks (``zoo.py``) and the
transformer LM (``transformer.py``)."""

from deeplearning4j_tpu_torch.models.zoo import (  # noqa: F401
    lenet5,
    mnist_mlp,
    resnet18,
)
