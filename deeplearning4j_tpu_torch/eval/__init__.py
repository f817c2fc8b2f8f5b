"""Evaluation: classification + regression metrics (copy of
``deeplearning4j_tpu/eval``, which is numpy only)."""

from deeplearning4j_tpu_torch.eval.evaluation import (  # noqa: F401
    ConfusionMatrix,
    Evaluation,
    RegressionEvaluation,
)
