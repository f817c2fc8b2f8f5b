"""Updaters (per-param gradient transforms), LR policies, gradient
normalization, on tensors.

Port of ``deeplearning4j_tpu/nn/updater/__init__.py`` (the reference's
BaseUpdater and the nd4j learning package: Sgd, Adam, AdaDelta,
Nesterovs, AdaGrad, RmsProp, NoOp, plus the LearningRatePolicy
schedules). Updater state is a tree mirroring the params, one slot per
param array. L1/L2 are not applied here: the network folds them into the
loss, so the gradient and the score include the penalty.

The updater math is written once (:func:`_apply_one`) over an ops table:
on single tensors for :func:`apply_updater`, and on lists of tensors
(``torch._foreach_*``) for :func:`grouped_apply_updaters`, the fused tail
of a step, which groups leaves by (spec, lr, dtype). Both run the same
elementwise operations in the same order, so they agree bit for bit.
The iteration, ``b1**t``, ``b2**t`` and the LR scale are float32 tensors
on the params' device, as in the reference; nothing in a step reads a
value back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.dtypes import tree_leaves, tree_map
from deeplearning4j_tpu_torch.nn.conf.enums import (
    GradientNormalization,
    LearningRatePolicy,
    Updater,
)
from deeplearning4j_tpu_torch.nn.conf.layers import LayerConf
from deeplearning4j_tpu_torch.nn.layers.base import is_bias_param

_DEFAULTS = {
    "momentum": 0.9,
    "rho": 0.95,
    "epsilon": 1e-6,
    "rms_decay": 0.95,
    "adam_mean_decay": 0.9,
    "adam_var_decay": 0.999,
}


@dataclasses.dataclass(frozen=True)
class UpdaterSpec:
    """Static updater description for one layer."""

    kind: Updater = Updater.SGD
    learning_rate: float = 0.1
    bias_learning_rate: Optional[float] = None
    momentum: float = 0.9
    rho: float = 0.95
    epsilon: float = 1e-6
    rms_decay: float = 0.95
    adam_mean_decay: float = 0.9
    adam_var_decay: float = 0.999
    # ((iteration, momentum), ...) sorted — sticky from each key on
    # (BaseUpdater.java:75-80); a tuple so the spec stays hashable
    momentum_schedule: Optional[Tuple[Tuple[int, float], ...]] = None
    gradient_normalization: GradientNormalization = GradientNormalization.NONE
    gradient_normalization_threshold: float = 1.0

    @staticmethod
    def from_layer_conf(conf: LayerConf, default_lr: float,
                        momentum_schedule: Optional[Dict[int, float]] = None
                        ) -> "UpdaterSpec":
        def pick(name):
            v = getattr(conf, name, None)
            return _DEFAULTS[name] if v is None else float(v)

        sched = None
        if momentum_schedule:
            sched = tuple(sorted(
                (int(k), float(v)) for k, v in momentum_schedule.items()))
        return UpdaterSpec(
            momentum_schedule=sched,
            kind=conf.updater or Updater.SGD,
            learning_rate=(float(conf.learning_rate)
                           if conf.learning_rate is not None
                           else float(default_lr)),
            bias_learning_rate=(float(conf.bias_learning_rate)
                                if conf.bias_learning_rate is not None
                                else None),
            momentum=pick("momentum"),
            rho=pick("rho"),
            epsilon=pick("epsilon"),
            rms_decay=pick("rms_decay"),
            adam_mean_decay=pick("adam_mean_decay"),
            adam_var_decay=pick("adam_var_decay"),
            gradient_normalization=(
                conf.gradient_normalization or GradientNormalization.NONE),
            gradient_normalization_threshold=float(
                conf.gradient_normalization_threshold),
        )


# ---------------------------------------------------------------------------
# State init
# ---------------------------------------------------------------------------


def init_updater_state(spec: UpdaterSpec, params: Any) -> Any:
    """Mirror tree of per-param state for this layer's updater kind."""
    if spec.kind in (Updater.SGD, Updater.NONE):
        return tree_map(lambda p: p.new_zeros((0,)), params)
    if spec.kind in (Updater.ADAGRAD, Updater.RMSPROP, Updater.NESTEROVS):
        return tree_map(torch.zeros_like, params)
    if spec.kind == Updater.ADADELTA:
        return tree_map(lambda p: {"msg": torch.zeros_like(p),
                                   "msdx": torch.zeros_like(p)}, params)
    if spec.kind == Updater.ADAM:
        return tree_map(lambda p: {"m": torch.zeros_like(p),
                                   "v": torch.zeros_like(p)}, params)
    raise ValueError(f"unsupported updater {spec.kind}")


# ---------------------------------------------------------------------------
# Gradient normalization (BaseUpdater.preApply :126)
# ---------------------------------------------------------------------------


def _layer_norm(leaves):
    return torch.sqrt(sum(torch.sum(g * g) for g in leaves) + 1e-12)


def normalize_gradients(spec: UpdaterSpec, grads: Any) -> Any:
    gn = spec.gradient_normalization
    thr = spec.gradient_normalization_threshold
    if gn == GradientNormalization.NONE:
        return grads
    if gn == GradientNormalization.RENORMALIZE_L2_PER_LAYER:
        norm = _layer_norm(tree_leaves(grads))
        return tree_map(lambda g: g / norm, grads)
    if gn == GradientNormalization.RENORMALIZE_L2_PER_PARAM_TYPE:
        return tree_map(
            lambda g: g / (torch.linalg.vector_norm(g) + 1e-12), grads)
    if gn == GradientNormalization.CLIP_ELEMENTWISE_ABSOLUTE_VALUE:
        return tree_map(lambda g: torch.clamp(g, -thr, thr), grads)
    if gn == GradientNormalization.CLIP_L2_PER_LAYER:
        scale = torch.clamp(thr / _layer_norm(tree_leaves(grads)), max=1.0)
        return tree_map(lambda g: g * scale, grads)
    if gn == GradientNormalization.CLIP_L2_PER_PARAM_TYPE:
        def clip(g):
            norm = torch.linalg.vector_norm(g) + 1e-12
            return g * torch.clamp(thr / norm, max=1.0)

        return tree_map(clip, grads)
    raise ValueError(gn)


# ---------------------------------------------------------------------------
# Per-param updater math
# ---------------------------------------------------------------------------


def _piecewise_constant(schedule: Dict[int, float], it: torch.Tensor,
                        default) -> torch.Tensor:
    """Sticky piecewise-constant lookup shared by the momentum schedule
    and the SCHEDULE lr policy: value of the latest key ≤ ``it`` (a
    float32 tensor), else ``default``. A ``where`` per key, so the lookup
    stays on the device."""
    val = torch.full((), float(default), dtype=torch.float32,
                     device=it.device)
    for k in sorted(schedule):
        val = torch.where(it >= k, float(schedule[k]), val)
    return val


class _TensorOps:
    """The updater's operations on single tensors."""

    add, sub, mul, div = torch.add, torch.sub, torch.mul, torch.div
    sqrt, neg = torch.sqrt, torch.neg


class _ForeachOps:
    """The same operations on lists of tensors (multi-tensor kernels)."""

    add, sub, mul = torch._foreach_add, torch._foreach_sub, torch._foreach_mul
    div, sqrt, neg = torch._foreach_div, torch._foreach_sqrt, torch._foreach_neg


def _apply_one(spec: UpdaterSpec, lr, g, s, t, ops=_TensorOps):
    """Returns (step_to_subtract, new_state) for one param array, or, with
    ``ops=_ForeachOps``, for a list of them (``s`` a list, or a dict of
    lists for Adam/AdaDelta). ``lr`` and ``t`` are float32 tensors."""
    kind = spec.kind
    if kind == Updater.SGD:
        return ops.mul(g, lr), s
    if kind == Updater.NONE:
        return g, s
    eps = spec.epsilon
    if kind == Updater.ADAGRAD:
        s2 = ops.add(s, ops.mul(g, g))
        return ops.div(ops.mul(g, lr), ops.add(ops.sqrt(s2), eps)), s2
    if kind == Updater.RMSPROP:
        rd = spec.rms_decay
        s2 = ops.add(ops.mul(s, rd), ops.mul(ops.mul(g, 1.0 - rd), g))
        return ops.div(ops.mul(g, lr), ops.add(ops.sqrt(s2), eps)), s2
    if kind == Updater.NESTEROVS:
        # nd4j Nesterovs: v' = mu*v - lr*g; params += mu*v' - lr*g
        mu = spec.momentum
        if spec.momentum_schedule:
            # sticky switch: the latest key ≤ the 0-based iteration wins
            mu = _piecewise_constant(dict(spec.momentum_schedule), t - 1.0,
                                     default=mu)
        v_new = ops.sub(ops.mul(s, mu), ops.mul(g, lr))
        return ops.neg(ops.sub(ops.mul(v_new, mu), ops.mul(g, lr))), v_new
    if kind == Updater.ADADELTA:
        rho = spec.rho
        msg = ops.add(ops.mul(s["msg"], rho), ops.mul(ops.mul(g, 1.0 - rho), g))
        dx = ops.mul(ops.sqrt(ops.div(ops.add(s["msdx"], eps),
                                      ops.add(msg, eps))), g)
        msdx = ops.add(ops.mul(s["msdx"], rho),
                       ops.mul(ops.mul(dx, 1.0 - rho), dx))
        return dx, {"msg": msg, "msdx": msdx}
    if kind == Updater.ADAM:
        b1, b2 = spec.adam_mean_decay, spec.adam_var_decay
        m = ops.add(ops.mul(s["m"], b1), ops.mul(g, 1.0 - b1))
        v = ops.add(ops.mul(s["v"], b2), ops.mul(ops.mul(g, 1.0 - b2), g))
        mhat = ops.div(m, 1.0 - b1 ** t)
        vhat = ops.div(v, 1.0 - b2 ** t)
        step = ops.div(ops.mul(mhat, lr), ops.add(ops.sqrt(vhat), eps))
        return step, {"m": m, "v": v}
    raise ValueError(kind)


def _step_t(step_count: torch.Tensor) -> torch.Tensor:
    return torch.clamp(step_count, min=1).to(torch.float32)


def _leaf_lr(spec: UpdaterSpec, name: str) -> float:
    if spec.bias_learning_rate is not None and is_bias_param(name):
        return spec.bias_learning_rate
    return spec.learning_rate


def apply_updater(spec: UpdaterSpec, grads: Dict[str, Any],
                  state: Dict[str, Any], lr_scale: torch.Tensor,
                  step_count: torch.Tensor
                  ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Transform one layer's gradients into parameter steps.

    ``lr_scale`` multiplies the spec's base lr (the LR policy's factor, a
    float32 tensor); ``step_count`` is the 1-based global step (an integer
    tensor) for Adam's bias correction. Returns (steps, new_state) with
    steps to be SUBTRACTED from params.
    """
    grads = normalize_gradients(spec, grads)
    t = _step_t(step_count)

    def walk(sub_g, sub_s):
        steps, new_state = {}, {}
        for name in sub_g:
            if isinstance(sub_g[name], dict):  # nested (e.g. biLSTM fwd/bwd)
                steps[name], new_state[name] = walk(sub_g[name], sub_s[name])
                continue
            lr = _leaf_lr(spec, name) * lr_scale
            steps[name], new_state[name] = _apply_one(
                spec, lr, sub_g[name], sub_s[name], t)
        return steps, new_state

    return walk(grads, state)


def per_layer_apply_updaters(items, params, updater_state, grads,
                             lr_scale: torch.Tensor,
                             step_count: torch.Tensor):
    """The classic per-layer loop (one :func:`apply_updater` per layer),
    with the signature and result of :func:`grouped_apply_updaters` and
    bit for bit its values: both run :func:`_apply_one`. The networks take
    the grouped apply; the reference falls back to this loop where GSPMD
    miscompiles the grouped one over mixed shardings (``flat_apply_safe``),
    a fault of XLA that has no counterpart here."""
    new_params, new_updater = {}, {}
    for key, spec in items:
        steps, new_updater[key] = apply_updater(
            spec, grads[key], updater_state[key], lr_scale, step_count)
        new_params[key] = _sub_tree(params[key], steps)
    return new_params, new_updater


def _sub_tree(params, steps):
    if isinstance(params, dict):
        return {k: _sub_tree(params[k], steps[k]) for k in params}
    return params - steps.to(params.dtype)


# ---------------------------------------------------------------------------
# Grouped updater apply — the fused optimizer tail
# ---------------------------------------------------------------------------


def _iter_leaf_records(grads, state, params, path=()):
    """Yield ``(path, g, s, p)`` per param leaf of one layer's subtree."""
    for name in sorted(grads):
        g = grads[name]
        if isinstance(g, dict):  # nested (e.g. biLSTM fwd/bwd)
            yield from _iter_leaf_records(g, state[name], params[name],
                                          path + (name,))
        else:
            yield path + (name,), g, state[name], params[name]


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    return tree  # leaf placeholder, overwritten by _put


def _put(root, path, value):
    node = root
    for part in path[:-1]:
        node = node[part]
    node[path[-1]] = value


def grouped_apply_updaters(items, params, updater_state, grads,
                           lr_scale: torch.Tensor, step_count: torch.Tensor):
    """The whole multi-layer optimizer tail as multi-tensor operations.

    ``items`` is the ordered ``(layer_key, spec)`` list; ``params`` /
    ``updater_state`` / ``grads`` are the per-layer-keyed trees. Leaves
    are grouped by ``(spec, effective lr, dtype)`` and :func:`_apply_one`
    runs once per group on ``torch._foreach_*`` kernels, so the launches
    do not grow with depth. Per-layer gradient normalization runs per
    layer before grouping (its norms are over one layer's gradient);
    ``bias_learning_rate`` leaves form their own group. The result equals
    the per-layer :func:`apply_updater` loop bit for bit.

    Returns ``(new_params, new_updater_state)`` in the input structure.
    """
    t = _step_t(step_count)
    groups: Dict[Any, list] = {}
    new_params: Dict[str, Any] = {}
    new_updater: Dict[str, Any] = {}
    for key, spec in items:
        new_params[key] = _skeleton(params[key])
        new_updater[key] = _skeleton(updater_state[key])
        g_layer = normalize_gradients(spec, grads[key])
        for path, g, s, p in _iter_leaf_records(
                g_layer, updater_state[key], params[key]):
            gk = (spec, _leaf_lr(spec, path[-1]), g.dtype)
            groups.setdefault(gk, []).append((key, path, g, s, p))

    for (spec, lr, _), recs in groups.items():
        gs = [r[2] for r in recs]
        s0 = recs[0][3]
        if isinstance(s0, dict):
            ss = {k2: [r[3][k2] for r in recs] for k2 in s0}
        else:
            ss = [r[3] for r in recs]
        steps, s2 = _apply_one(spec, lr * lr_scale, gs, ss, t, _ForeachOps)
        new_ps = torch._foreach_sub([r[4] for r in recs], steps)
        for i, (key, path, _, _, _) in enumerate(recs):
            _put(new_params[key], path, new_ps[i])
            slot = ({k2: v[i] for k2, v in s2.items()}
                    if isinstance(s2, dict) else s2[i])
            _put(new_updater[key], path, slot)
    return new_params, new_updater


# ---------------------------------------------------------------------------
# Learning-rate policies (nn/conf/LearningRatePolicy)
# ---------------------------------------------------------------------------


def lr_policy_scale(policy: LearningRatePolicy, iteration: torch.Tensor,
                    decay_rate: float, steps: float, power: float,
                    schedule: Optional[Dict[int, float]] = None,
                    base_lr: float = 1.0) -> torch.Tensor:
    """Multiplicative factor on the base lr at ``iteration`` (an integer
    tensor), a float32 tensor on its device."""
    it = iteration.to(torch.float32)
    if policy in (LearningRatePolicy.NONE, LearningRatePolicy.SCORE):
        # SCORE decays host-side (the network's post-iteration hook)
        return torch.ones_like(it)
    if policy == LearningRatePolicy.EXPONENTIAL:
        return torch.pow(decay_rate, it)
    if policy == LearningRatePolicy.INVERSE:
        return torch.pow(1.0 + decay_rate * it, -power)
    if policy == LearningRatePolicy.POLY:
        return torch.pow(torch.clamp(1.0 - it / max(steps, 1.0), min=0.0),
                         power)
    if policy == LearningRatePolicy.SIGMOID:
        return 1.0 / (1.0 + torch.exp(-decay_rate * (it - steps)))
    if policy in (LearningRatePolicy.STEP, LearningRatePolicy.TORCH_STEP):
        return torch.pow(decay_rate, torch.floor(it / max(steps, 1.0)))
    if policy == LearningRatePolicy.SCHEDULE:
        if not schedule:
            return torch.ones_like(it)
        # piecewise-constant absolute lr: factor = schedule_lr / base_lr
        factors = {k: v / max(base_lr, 1e-30) for k, v in schedule.items()}
        return _piecewise_constant(factors, it, default=1.0)
    raise ValueError(policy)
