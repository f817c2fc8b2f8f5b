"""Central-difference gradient checks for MultiLayerNetwork and
ComputationGraph (port of ``deeplearning4j_tpu/gradientcheck/util.py``)."""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import dtypes as dtypes_mod


def _leaves(tree) -> list:
    """Leaves in ``jax.tree_util`` order (dict keys sorted, sequences in
    order), so that a seed probes the coordinates the reference probes."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _replace_leaf(tree, index: int, value, counter=None):
    """``tree`` with its ``index``-th leaf (in :func:`_leaves` order)
    replaced by ``value``; the other leaves are shared."""
    counter = [0] if counter is None else counter
    if isinstance(tree, dict):
        return {k: _replace_leaf(tree[k], index, value, counter)
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_replace_leaf(v, index, value, counter)
                          for v in tree)
    i = counter[0]
    counter[0] += 1
    return value if i == index else tree


@contextlib.contextmanager
def _float64_layers(net):
    """The network's layers compute in float64 inside the block: the
    port's layers take their dtype policy at construction, where the
    reference's read the global one that ``policy_scope`` sets."""
    impls = list(getattr(net, "layer_impls", {}).values()) \
        or list(getattr(net, "layers", []))
    saved = [(impl, impl.policy) for impl in impls]
    net_policy = net._policy
    try:
        net._policy = dtypes_mod.FLOAT64
        for impl, _ in saved:
            impl.policy = dtypes_mod.FLOAT64
        with dtypes_mod.policy_scope(dtypes_mod.FLOAT64):
            yield
    finally:
        net._policy = net_policy
        for impl, policy in saved:
            impl.policy = policy


def check_gradients(
    net,
    ds,
    epsilon: float = 1e-6,
    max_rel_error: float = 1e-3,
    min_abs_error: float = 1e-8,
    subset: Optional[int] = 64,
    seed: int = 0,
    print_results: bool = False,
    report: Optional[dict] = None,
) -> bool:
    """Central-difference check of d(loss)/d(params) in float64.

    ``subset``: the number of parameter coordinates probed, drawn by
    ``default_rng(seed).choice`` over the params flattened in the
    reference's order (the reference probes every coordinate; a seeded
    subset gives the same regression power). The loss runs on the
    network's device with its layers in float64, whatever the network's
    dtype policy. ``report``, when given, receives ``n_probed``,
    ``max_rel_error``, ``max_abs_error`` and the ``failures``."""
    net._ensure_init()
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    dev = net.device
    to64 = lambda a: None if a is None else torch.as_tensor(  # noqa: E731
        np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a),
        dtype=torch.float64).to(dev)
    if isinstance(net, ComputationGraph):
        from deeplearning4j_tpu_torch.datasets.dataset import (
            DataSet, MultiDataSet)

        if isinstance(ds, DataSet):
            ds = MultiDataSet.from_dataset(ds)
        seq = lambda xs: None if xs is None else [to64(a) for a in xs]  # noqa: E731
        batch = (seq(ds.features), seq(ds.labels), seq(ds.features_masks),
                 seq(ds.labels_masks))
    else:
        batch = (to64(ds.features), to64(ds.labels), to64(ds.features_mask),
                 to64(ds.labels_mask))
    cast = lambda t: t.detach().to(torch.float64)  # noqa: E731
    params64 = dtypes_mod.tree_map(cast, net.params)
    state64 = dtypes_mod.tree_map(cast, net.net_state)
    flat = _leaves(params64)

    with _float64_layers(net), torch.no_grad():
        def loss_at(params) -> float:
            loss, _ = net._loss_and_state(params, state64, *batch,
                                          None, False)
            return float(loss)

        with torch.enable_grad():
            fwd = [p.clone().requires_grad_() for p in flat]
            tree = params64
            for i, p in enumerate(fwd):
                tree = _replace_leaf(tree, i, p)
            loss, _ = net._loss_and_state(tree, state64, *batch, None, False)
            grads = torch.autograd.grad(loss, fwd, allow_unused=True,
                                        materialize_grads=True)

        total = sum(int(p.numel()) for p in flat)
        rng = np.random.default_rng(seed)
        n_probe = total if subset is None else min(subset, total)
        coords = sorted(rng.choice(total, size=n_probe, replace=False))
        bounds = np.cumsum([0] + [int(p.numel()) for p in flat])
        failures = []
        max_rel = max_abs = 0.0
        for c in coords:
            li = int(np.searchsorted(bounds, c, side="right") - 1)
            off = int(c - bounds[li])
            leaf = flat[li]

            def perturbed(sign):
                new_leaf = leaf.clone()
                new_leaf.view(-1)[off] += sign * epsilon
                return _replace_leaf(params64, li, new_leaf)

            numeric = (loss_at(perturbed(+1))
                       - loss_at(perturbed(-1))) / (2 * epsilon)
            analytic = float(grads[li].reshape(-1)[off])
            abs_err = abs(numeric - analytic)
            denom = max(abs(numeric), abs(analytic))
            rel_err = abs_err / denom if denom > 0 else 0.0
            ok = rel_err <= max_rel_error or abs_err <= min_abs_error
            max_rel, max_abs = max(max_rel, rel_err), max(max_abs, abs_err)
            if print_results or not ok:
                print(f"coord {c}: analytic={analytic:.8e} "
                      f"numeric={numeric:.8e} relErr={rel_err:.3e} "
                      f"{'OK' if ok else 'FAIL'}")
            if not ok:
                failures.append((int(c), analytic, numeric, rel_err))
    if report is not None:
        report.update(n_probed=len(coords), max_rel_error=max_rel,
                      max_abs_error=max_abs, failures=failures,
                      coords=[int(c) for c in coords])
    return not failures


class GradientCheckUtil:
    """Class-style facade matching GradientCheckUtil.checkGradients."""

    @staticmethod
    def check_gradients(net, ds, **kwargs) -> bool:
        return check_gradients(net, ds, **kwargs)
