"""Host-driven solvers over the network's score and gradient.

Port of ``deeplearning4j_tpu/optimize/solver.py`` (the reference's
OptimizationAlgorithm family, optimize/solvers/: LineGradientDescent,
ConjugateGradient, LBFGS with BackTrackLineSearch.java). The score and
gradient of the whole network with respect to its flat parameter vector
run on the network's device: the float64 iterate is rounded to the
params' dtype (float32 unless the dtype policy is float64), copied to
the device, cut into the param tree (numeric layer order, then
sorted param names: ``get_flat_params``'s order) and run forward and
backward with ``train=False`` and no generator. The search direction, the
Armijo line search and the L-BFGS two-loop recursion run on the host in
float64 (``optimize/function.py``), as in the reference.

So every solver iteration moves the parameter vector to the device and
its gradient back, and every line-search probe moves the vector and reads
a score back: the reference's design, kept. ``network.solver_stats``
counts what that costs (calls, seconds, bytes each way).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.optimize.function import (
    Norm2Termination,
    minimize,
)

_STAT_KEYS = ("optimize_calls", "iterations", "value_and_grad_calls",
              "value_and_grad_s", "score_calls", "score_s", "total_s",
              "bytes_to_device", "bytes_from_device")


def new_solver_stats() -> Dict[str, float]:
    """Zeroed counters of :class:`Solver` (``network.solver_stats``). The
    host's float64 algebra takes ``total_s`` less the two device parts."""
    return {k: 0 for k in _STAT_KEYS}


class Solver:
    """Per-network solver; dispatches on ``conf.optimization_algo``."""

    def __init__(self, network):
        self.network = network
        self.conf = network.conf.global_conf

    def _unflatten(self, flat: torch.Tensor):
        """The network's param tree cut from a flat device vector, in
        ``get_flat_params``'s order (leaves are views of ``flat``, so the
        gradient reaches it)."""
        offset = 0

        def rebuild(tree):
            nonlocal offset
            if isinstance(tree, dict):
                return {k: rebuild(tree[k]) for k in sorted(tree)}
            n = tree.numel()
            leaf = flat[offset:offset + n].reshape(tree.shape).to(tree.dtype)
            offset += n
            return leaf

        net = self.network
        return {str(i): rebuild(net.params[str(i)])
                for i in range(len(net.layers))}

    def optimize(self, ds, iterations: Optional[int] = None) -> float:
        net = self.network
        stats = net.solver_stats
        t_start = time.perf_counter()
        iterations = iterations or max(1, self.conf.iterations)
        x, y = net._dev(ds.features), net._dev(ds.labels)
        fm, lm = net._dev(ds.features_mask), net._dev(ds.labels_mask)
        device = net.device
        start = net.get_flat_params()
        dtype = start.dtype  # the params' dtype: what the device sees
        size = dtype.itemsize

        def loss_of(flat):
            loss, _ = net._loss_and_state(self._unflatten(flat),
                                          net.net_state, x, y, fm, lm,
                                          rng=None, train=False)
            return loss

        def to_device(params64):
            host = torch.from_numpy(np.asarray(params64, dtype))
            stats["bytes_to_device"] += host.numel() * size
            return host.to(device)

        def vg_flat(params64):
            t = time.perf_counter()
            flat = to_device(params64).requires_grad_()
            loss = loss_of(flat)
            (grad,) = torch.autograd.grad(loss, flat)
            score = float(loss.detach())
            grad = grad.cpu().numpy().astype(np.float64)
            stats["bytes_from_device"] += (grad.size + 1) * size
            stats["value_and_grad_calls"] += 1
            stats["value_and_grad_s"] += time.perf_counter() - t
            return score, grad

        def score_of(params64):
            t = time.perf_counter()
            with torch.no_grad():
                score = float(loss_of(to_device(params64)))
            stats["bytes_from_device"] += size
            stats["score_calls"] += 1
            stats["score_s"] += time.perf_counter() - t
            return score

        def on_iteration(cur_params, score, it):
            net.iteration_count += 1
            net.score_value = score
            stats["iterations"] += 1
            for listener in net.listeners:
                listener.iteration_done(net, net.iteration_count)

        stats["bytes_from_device"] += start.size * size
        params, score, history = minimize(
            vg_flat, np.asarray(start, np.float64),
            algo=self.conf.optimization_algo, iterations=iterations,
            learning_rate=self.conf.learning_rate, score_fn=score_of,
            max_line_search_iterations=(
                self.conf.max_num_line_search_iterations),
            terminations=(Norm2Termination(),),  # keep fixed-iteration
            callback=on_iteration,               # semantics of fit()
            rescore_final=False)  # no extra forward pass per minibatch
        net.set_flat_params(params.astype(np.float32))
        stats["bytes_to_device"] += params.size * 4
        if history:
            net.score_value = score
        stats["optimize_calls"] += 1
        stats["total_s"] += time.perf_counter() - t_start
        return net.score_value
