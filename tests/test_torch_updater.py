"""Port parity for the updaters: each of the 7 updaters, under each of the
6 gradient-normalization modes and each of the 9 LR policies (the
SCHEDULE policy and a ``momentum_after`` schedule included), over 5 steps
of ``apply_updater`` against ``deeplearning4j_tpu.nn.updater`` on the
same seeded gradients.

Tolerance: float32, 1e-6 relative to the largest magnitude of each leaf
(steps, updater state and the params they move). Both packages run the
same float32 operations in the same order; ``pow``, ``sqrt`` and ``exp``
may round differently by an ulp, and five steps compound that.

Inside the port, the grouped multi-tensor apply equals the per-layer
apply bit for bit."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import enums as jax_enums
from deeplearning4j_tpu.nn import updater as jax_upd
from deeplearning4j_tpu_torch.dtypes import tree_leaves, tree_map
from deeplearning4j_tpu_torch.nn.conf import enums
from deeplearning4j_tpu_torch.nn import updater as upd

UPDATERS = [u.value for u in enums.Updater if u.value != "CUSTOM"]
NORMS = [g.value for g in enums.GradientNormalization]
POLICIES = [p.value for p in enums.LearningRatePolicy]
STEPS = 5
SCHEDULE = {0: 0.05, 2: 0.03, 4: 0.01}
POLICY_ARGS = dict(decay_rate=0.7, steps=2.0, power=1.5, schedule=SCHEDULE,
                   base_lr=0.05)
SHAPES = {"W": (4, 3), "b": (3,)}


def _spec(mod, E, kind, norm, bias_lr=0.02):
    return mod.UpdaterSpec(
        kind=E.Updater(kind), learning_rate=0.05, bias_learning_rate=bias_lr,
        momentum=0.8, momentum_schedule=((0, 0.9), (3, 0.5)),
        gradient_normalization=E.GradientNormalization(norm),
        gradient_normalization_threshold=0.5)


def _close_rel(got, want, tol=1e-6):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) if want.size else 0.0
    assert np.abs(got - want).max(initial=0.0) <= tol * max(scale, 1e-30)


def _jax_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _jax_leaves(tree[k])]
    return [np.asarray(tree)]


def _port_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _port_leaves(tree[k])]
    return [tree.numpy()]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("kind", UPDATERS)
def test_five_steps_match_reference(kind, norm, policy):
    rng = np.random.default_rng([UPDATERS.index(kind), NORMS.index(norm),
                                 POLICIES.index(policy)])
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in SHAPES.items()}
    jspec = _spec(jax_upd, jax_enums, kind, norm)
    spec = _spec(upd, enums, kind, norm)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    js = jax_upd.init_updater_state(jspec, jp)
    ts = upd.init_updater_state(spec, tp)
    for i in range(STEPS):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in SHAPES.items()}
        jscale = jax_upd.lr_policy_scale(
            jax_enums.LearningRatePolicy(policy), jnp.asarray(i, jnp.int32),
            **POLICY_ARGS)
        tscale = upd.lr_policy_scale(
            enums.LearningRatePolicy(policy),
            torch.tensor(i, dtype=torch.int32), **POLICY_ARGS)
        assert tscale.dtype == torch.float32
        _close_rel(tscale, jscale)
        jsteps, js = jax_upd.apply_updater(
            jspec, {k: jnp.asarray(v) for k, v in g.items()}, js, jscale,
            jnp.asarray(i + 1, jnp.int32))
        tsteps, ts = upd.apply_updater(
            spec, {k: torch.tensor(v) for k, v in g.items()}, ts, tscale,
            torch.tensor(i + 1, dtype=torch.int32))
        jp = {k: jp[k] - jsteps[k] for k in jp}
        tp = {k: tp[k] - tsteps[k] for k in tp}
        got = _port_leaves({"0": tsteps, "1": ts, "2": tp})
        want = _jax_leaves({"0": jsteps, "1": js, "2": jp})
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _close_rel(a, b)


def _layers(kind):
    """Five layers: two sharing one spec, one with a bias LR and per-layer
    gradient clipping, one without params (a pooling layer), one SGD."""
    a = _spec(upd, enums, kind, "None", bias_lr=None)
    b = _spec(upd, enums, kind, "ClipL2PerLayer", bias_lr=0.01)
    c = _spec(upd, enums, "SGD", "None", bias_lr=None)
    shapes = [{"W": (5, 4), "b": (4,)}, {"W": (4, 3), "b": (3,)},
              {"W": (2, 3, 4), "b": (4,)}, {}, {"W": (3, 2), "b": (2,)}]
    return list(zip(map(str, range(5)), [a, a, b, a, c])), shapes


@pytest.mark.parametrize("kind", UPDATERS)
def test_grouped_apply_is_bitwise_the_per_layer_apply(kind):
    items, shapes = _layers(kind)
    gen = torch.Generator().manual_seed(0)
    params = {k: {n: torch.randn(s, generator=gen) for n, s in sh.items()}
              for (k, _), sh in zip(items, shapes)}
    state = {k: upd.init_updater_state(spec, params[k]) for k, spec in items}
    grouped = (params, state)
    per_layer = (tree_map(torch.clone, params), tree_map(torch.clone, state))
    for i in range(3):
        grads = tree_map(lambda p: torch.randn(p.shape, generator=gen), params)
        it = torch.tensor(i, dtype=torch.int32)
        scale = upd.lr_policy_scale(enums.LearningRatePolicy.EXPONENTIAL, it,
                                    0.9, 1.0, 1.0)
        grouped = upd.grouped_apply_updaters(items, *grouped, grads, scale,
                                             it + 1)
        new_p, new_s = {}, {}
        for key, spec in items:
            steps, new_s[key] = upd.apply_updater(
                spec, grads[key], per_layer[1][key], scale, it + 1)
            new_p[key] = {n: per_layer[0][key][n] - steps[n]
                          for n in per_layer[0][key]}
        per_layer = (new_p, new_s)
        for a, b in itertools.zip_longest(tree_leaves(grouped),
                                          tree_leaves(per_layer)):
            assert a.dtype == b.dtype and torch.equal(a, b)
