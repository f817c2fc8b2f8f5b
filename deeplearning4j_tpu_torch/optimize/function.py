"""Generic function minimization shared by the network Solver and
standalone use.

A copy of ``deeplearning4j_tpu/optimize/function.py`` (numpy only; its
divergence policy comes from the port's ``resilience/guard.py``), so the
port's solvers take the reference's steps on the same scores and
gradients.

Reference: ``optimize/solvers/BaseOptimizer.java:165`` (optimize loop with
step function, line search, termination conditions) and
``optimize/terminations/`` (EpsTermination, Norm2Termination,
ZeroDirection). The reference's TestOptimizers exercises these algorithms
on convex toy "models" (Sphere/Rosenbrock/Rastrigin) — this module is the
equivalent surface: any differentiable function of a flat vector.

The objective's value+gradient is one callable (on a network, one forward
and backward on its device); search-direction/line-search logic runs on
the host in float64 (control-flow heavy, O(params) cheap).
"""

from __future__ import annotations

import logging
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.nn.conf.enums import OptimizationAlgorithm

logger = logging.getLogger(__name__)


class TerminationCondition:
    def terminate(self, new_score: float, old_score: float,
                  grad: np.ndarray, direction: np.ndarray) -> bool:
        raise NotImplementedError


class EpsTermination(TerminationCondition):
    """Stop when the score improvement falls below eps
    (terminations/EpsTermination.java)."""

    def __init__(self, eps: float = 1e-10, tolerance: float = 1e-8):
        self.eps = eps
        self.tolerance = tolerance

    def terminate(self, new_score, old_score, grad, direction):
        # old_score is +inf before the first evaluation (no improvement
        # to measure yet). NON-finite scores mid-run never reach here:
        # ``minimize`` routes them through the DL4J_NAN_GUARD policy
        # before the termination checks run.
        if not np.isfinite(old_score):
            return False
        return abs(new_score - old_score) < self.eps + self.tolerance * abs(
            old_score)


class Norm2Termination(TerminationCondition):
    """Stop when ||grad||₂ falls below the floor
    (terminations/Norm2Termination.java)."""

    def __init__(self, gradient_norm_floor: float = 1e-10):
        self.floor = gradient_norm_floor

    def terminate(self, new_score, old_score, grad, direction):
        return float(np.linalg.norm(grad)) < self.floor


class ZeroDirection(TerminationCondition):
    """Stop when the search direction vanishes
    (terminations/ZeroDirection.java). ``direction`` is the previous
    iteration's search direction (-grad before the first step)."""

    def terminate(self, new_score, old_score, grad, direction):
        return float(np.abs(direction).max(initial=0.0)) == 0.0


class BackTrackLineSearch:
    """Armijo backtracking line search (BackTrackLineSearch.java)."""

    def __init__(self, score_fn, max_iterations: int = 5, c1: float = 1e-4,
                 shrink: float = 0.5, initial_step: float = 1.0):
        self.score_fn = score_fn
        self.max_iterations = max_iterations
        self.c1 = c1
        self.shrink = shrink
        self.initial_step = initial_step

    def optimize(self, params: np.ndarray, score0: float, grad: np.ndarray,
                 direction: np.ndarray) -> float:
        """Returns a step size along ``direction``."""
        slope = float(np.dot(grad, direction))
        if slope >= 0:  # not a descent direction — ZeroDirection guard
            return 0.0
        step = self.initial_step
        for _ in range(self.max_iterations):
            new_score = float(self.score_fn(params + step * direction))
            if new_score <= score0 + self.c1 * step * slope:
                return step
            step *= self.shrink
        return step


def _lbfgs_direction(grad: np.ndarray, lbfgs_s: Sequence[np.ndarray],
                     lbfgs_y: Sequence[np.ndarray]) -> np.ndarray:
    """LBFGS search direction by the two-loop recursion over the stored
    (s, y) pairs, oldest first."""
    q = grad.copy()
    alphas = []
    for s_i, y_i in zip(reversed(lbfgs_s), reversed(lbfgs_y)):
        rho = 1.0 / (np.dot(y_i, s_i) + 1e-20)
        a = rho * np.dot(s_i, q)
        q -= a * y_i
        alphas.append((rho, a, s_i, y_i))
    if lbfgs_y:
        gamma = (np.dot(lbfgs_s[-1], lbfgs_y[-1])
                 / (np.dot(lbfgs_y[-1], lbfgs_y[-1]) + 1e-20))
        q *= gamma
    for rho, a, s_i, y_i in reversed(alphas):
        b = rho * np.dot(y_i, q)
        q += (a - b) * s_i
    return -q


def minimize(value_and_grad: Callable, params0: np.ndarray,
             algo: OptimizationAlgorithm = OptimizationAlgorithm.LBFGS,
             iterations: int = 100, learning_rate: float = 0.1,
             score_fn: Optional[Callable] = None,
             max_line_search_iterations: int = 5,
             lbfgs_memory: int = 10,
             terminations: Optional[Sequence[TerminationCondition]] = None,
             callback: Optional[Callable[[np.ndarray, float, int], None]]
             = None,
             rescore_final: bool = True,
             nan_guard: Optional[str] = None
             ) -> Tuple[np.ndarray, float, List[float]]:
    """Minimize a scalar function of a flat vector.

    ``value_and_grad(params) -> (score, grad)``; ``score_fn(params) ->
    score`` (defaults to value_and_grad's score; used by the line search).
    Returns (params, final_score, score_history).

    ``rescore_final=False`` skips the extra evaluation that makes the
    returned score exact for the returned params — per-minibatch callers
    (the network Solver) don't want a second forward pass per batch.

    Divergence handling routes through the SAME ``DL4J_NAN_GUARD`` policy
    as the fused training pipeline (``nan_guard`` overrides the env; the
    former ad-hoc behavior was an isfinite branch inside EpsTermination
    that silently kept iterating on garbage): a non-finite score or
    gradient skips that iteration's update (params unchanged — the
    host-loop analogue of the fused path's sentinel identity) under
    ``skip``/``off``, additionally halves ``learning_rate`` under
    ``halve_lr``, and raises :class:`TrainingDivergedError` naming the
    iteration under ``raise``.
    """
    from deeplearning4j_tpu_torch.resilience.guard import (
        TrainingDivergedError, nan_guard_policy)

    guard = nan_guard_policy() if nan_guard is None else nan_guard
    params = np.asarray(params0, np.float64).copy()
    if score_fn is None:
        score_fn = lambda p: value_and_grad(p)[0]
    if terminations is None:
        terminations = (EpsTermination(), Norm2Termination(), ZeroDirection())
    line = BackTrackLineSearch(
        score_fn, max_iterations=max_line_search_iterations)

    prev_grad = None
    prev_params = None
    direction = None
    lbfgs_s: List[np.ndarray] = []
    lbfgs_y: List[np.ndarray] = []

    old_score = np.inf
    score = np.inf
    history: List[float] = []
    stepped = False  # params changed since `score` was computed
    for it in range(iterations):
        score_j, grad_j = value_and_grad(params)
        score = float(score_j)
        grad = np.asarray(grad_j, np.float64)
        history.append(score)
        stepped = False
        if not (np.isfinite(score) and np.isfinite(grad).all()):
            if guard == "raise":
                raise TrainingDivergedError(
                    epoch=0, step=it, loss=score,
                    where="host optimizer loop")
            if guard == "halve_lr":
                learning_rate *= 0.5
                logger.warning(
                    "minimize: non-finite score/gradient at iteration "
                    "%d; update skipped, learning_rate halved to %g "
                    "[DL4J_NAN_GUARD=halve_lr]", it, learning_rate)
            else:
                logger.warning(
                    "minimize: non-finite score/gradient at iteration "
                    "%d; update skipped [DL4J_NAN_GUARD=%s]", it, guard)
            continue  # params unchanged; try the next evaluation
        dir_for_term = -grad if direction is None else direction
        if any(t.terminate(score, old_score, grad, dir_for_term)
               for t in terminations):
            break
        old_score = score

        if algo == OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT:
            params = params - learning_rate * grad
        elif algo == OptimizationAlgorithm.LINE_GRADIENT_DESCENT:
            direction = -grad
            step = line.optimize(params, score, grad, direction)
            params = params + step * direction
        elif algo == OptimizationAlgorithm.CONJUGATE_GRADIENT:
            if prev_grad is None:
                direction = -grad
            else:
                # Polak–Ribière with automatic restart
                beta = max(0.0, float(
                    np.dot(grad, grad - prev_grad)
                    / (np.dot(prev_grad, prev_grad) + 1e-20)))
                direction = -grad + beta * direction
            step = line.optimize(params, score, grad, direction)
            params = params + step * direction
            prev_grad = grad
        elif algo == OptimizationAlgorithm.LBFGS:
            # update memory with the (s, y) pair from the previous step
            if prev_grad is not None and prev_params is not None:
                s_k = params - prev_params
                y_k = grad - prev_grad
                if np.dot(s_k, y_k) > 1e-10:  # curvature condition
                    lbfgs_s.append(s_k)
                    lbfgs_y.append(y_k)
                    if len(lbfgs_s) > lbfgs_memory:
                        lbfgs_s.pop(0)
                        lbfgs_y.pop(0)
            direction = _lbfgs_direction(grad, lbfgs_s, lbfgs_y)
            step = line.optimize(params, score, grad, direction)
            prev_params = params.copy()
            prev_grad = grad
            params = params + step * direction
        else:
            raise ValueError(f"unknown algorithm {algo}")
        stepped = True

        if callback is not None:
            callback(params, score, it)

    if stepped and rescore_final:
        # loop exhausted right after an update: score the final iterate so
        # the returned score matches the returned params
        score = float(score_fn(params))
        history.append(score)
    return params, score, history
