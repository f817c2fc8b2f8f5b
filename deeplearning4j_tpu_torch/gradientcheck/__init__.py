"""Gradient checks: central-difference validation of the analytic
gradients (port of ``deeplearning4j_tpu/gradientcheck``, the reference's
``gradientcheck/GradientCheckUtil.java:48``). The analytic gradient comes
from ``torch.autograd`` over the network's loss; the check holds the
loss's composition (masks, regularisation, preprocessors, recurrence)
against central differences in float64."""

from deeplearning4j_tpu_torch.gradientcheck.util import (  # noqa: F401
    GradientCheckUtil,
    check_gradients,
)
