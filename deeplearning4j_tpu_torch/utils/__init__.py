"""Host-side utilities (port of ``deeplearning4j_tpu/utils``): the
ModelSerializer zips, step-keyed checkpoints and the YAML subset of the
configuration documents."""

from deeplearning4j_tpu_torch.utils.serializer import ModelSerializer  # noqa: F401
