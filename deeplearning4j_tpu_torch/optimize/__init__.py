"""Optimization: solvers for full-batch algorithms + iteration listeners.

Port of ``deeplearning4j_tpu/optimize`` with the same exports.

The reference routes ALL training through ``optimize/Solver.java`` (dispatch
:57-72 over OptimizationAlgorithm) with BaseOptimizer's loop (gradientAndScore
→ line search → step → listeners, solvers/BaseOptimizer.java:165). Here the
hot path (STOCHASTIC_GRADIENT_DESCENT) is the network's own train step;
this package provides the host-driven solvers — line gradient descent,
conjugate gradient, LBFGS with backtracking line search — over one
score-and-gradient call on the network's device (SURVEY hard-part #5).
"""

from deeplearning4j_tpu_torch.optimize.solver import Solver  # noqa: F401
from deeplearning4j_tpu_torch.optimize.function import (  # noqa: F401
    BackTrackLineSearch,
    EpsTermination,
    Norm2Termination,
    TerminationCondition,
    ZeroDirection,
    minimize,
)
from deeplearning4j_tpu_torch.optimize.listeners import (  # noqa: F401
    CheckpointIterationListener,
    ComposableIterationListener,
    IterationListener,
    ParamAndGradientIterationListener,
    ScoreIterationListener,
)
