"""Port parity for the host-driven solvers (``optimize/``) against
``deeplearning4j_tpu.optimize``.

``minimize`` is host numpy in both packages, so fed one score-and-gradient
callable the two must take the same steps bit for bit: the reference's
toys (``tests/test_solvers.py``: sphere, Rosenbrock, Rastrigin) for all
four algorithms, and the divergence policies. A network's ``fit`` under
line gradient descent, conjugate gradient and LBFGS then runs its score
and gradient in torch: params, the score at every iteration and the
iteration count after 2 batches are held against the JAX network's at
float32 rtol 1e-4 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import layers as jax_L
from deeplearning4j_tpu.nn.conf.enums import OptimizationAlgorithm as JaxAlgo
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.optimize import minimize as jax_minimize
from deeplearning4j_tpu.optimize.listeners import (
    CollectScoresIterationListener as JaxCollect)
from deeplearning4j_tpu.resilience.guard import (
    TrainingDivergedError as JaxDiverged)
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models.convert import load_network_from_jax
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import OptimizationAlgorithm
from deeplearning4j_tpu_torch.nn.conf.neural_net import MultiLayerConfiguration
from deeplearning4j_tpu_torch.optimize import (
    EpsTermination,
    Norm2Termination,
    Solver,
    ZeroDirection,
    minimize,
)
from deeplearning4j_tpu_torch.optimize.listeners import (
    CollectScoresIterationListener)
from deeplearning4j_tpu_torch.resilience.guard import TrainingDivergedError

RTOL, ATOL = 1e-4, 1e-6
ALGOS = list(OptimizationAlgorithm)
SOLVERS = [OptimizationAlgorithm.LINE_GRADIENT_DESCENT,
           OptimizationAlgorithm.CONJUGATE_GRADIENT,
           OptimizationAlgorithm.LBFGS]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def make_vg(f):
    vg = jax.jit(jax.value_and_grad(f))
    return lambda p: tuple(map(np.asarray, vg(jnp.asarray(p))))


def sphere(x):
    return jnp.sum(x * x)


def rosenbrock(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                   + (1.0 - x[:-1]) ** 2)


def rastrigin(x):
    return jnp.sum(x * x - 10.0 * jnp.cos(2.0 * jnp.pi * x) + 10.0)


def torch_vg(f):
    def vg(p):
        t = torch.tensor(p, dtype=torch.float64, requires_grad=True)
        s = f(t)
        (g,) = torch.autograd.grad(s, t)
        return float(s.detach()), g.numpy()
    return vg


# (name, function, x0, minimize kwargs): the reference's toy settings
TOYS = {
    "sphere": (sphere, np.random.default_rng(12345).normal(0, 2, 10),
               dict(iterations=200, learning_rate=0.1)),
    "rosenbrock": (rosenbrock, np.full(6, -1.2),
                   dict(iterations=300, max_line_search_iterations=20)),
    "rastrigin": (rastrigin, np.random.default_rng(12345).uniform(-.5, .5, 8),
                  dict(iterations=100, learning_rate=0.001,
                       max_line_search_iterations=10)),
}


@pytest.mark.parametrize("algo", ALGOS, ids=[a.name for a in ALGOS])
@pytest.mark.parametrize("toy", sorted(TOYS))
def test_minimize_takes_the_references_steps(toy, algo):
    f, x0, kw = TOYS[toy]
    vg = make_vg(f)
    ours = minimize(vg, x0, algo=algo, **kw)
    theirs = jax_minimize(vg, x0, algo=JaxAlgo(algo.value), **kw)
    np.testing.assert_array_equal(ours[0], theirs[0])
    assert ours[1] == theirs[1] and ours[2] == theirs[2]


@pytest.mark.parametrize("algo", ALGOS, ids=[a.name for a in ALGOS])
def test_minimize_on_torch_toys_converges_like_the_reference(algo):
    x0 = np.random.default_rng(12345).normal(0, 2, 10)
    params, score, hist = minimize(
        torch_vg(lambda x: torch.sum(x * x)), x0, algo=algo,
        iterations=200, learning_rate=0.1)
    _, ref_score, _ = jax_minimize(make_vg(sphere), x0,
                                   algo=JaxAlgo(algo.value), iterations=200,
                                   learning_rate=0.1)
    assert score < 1e-3 and ref_score < 1e-3
    assert hist[-1] <= hist[0]
    np.testing.assert_allclose(score, float(np.sum(params * params)),
                               rtol=1e-5, atol=1e-9)


def test_terminations():
    vg = make_vg(sphere)
    _, _, hist = minimize(vg, np.ones(4) * 3.0, algo=OptimizationAlgorithm.LBFGS,
                          iterations=10_000,
                          terminations=(Norm2Termination(1e-6),))
    assert len(hist) < 10_000
    _, _, hist = minimize(
        vg, np.ones(4), algo=OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT,
        iterations=10_000, learning_rate=0.2,
        terminations=(EpsTermination(1e-12),))
    assert len(hist) < 10_000
    _, _, hist = minimize(make_vg(lambda x: jnp.sum(x * 0.0)), np.ones(3),
                          algo=OptimizationAlgorithm.LINE_GRADIENT_DESCENT,
                          iterations=50, terminations=(ZeroDirection(),))
    assert len(hist) == 1
    with pytest.raises(ValueError):
        minimize(vg, np.ones(2), algo="NOT_AN_ALGO", iterations=1)


def _poisoned_vg(bad_iterations):
    vg = make_vg(sphere)
    calls = []

    def poisoned(p):
        calls.append(1)
        s, g = vg(p)
        if len(calls) - 1 in bad_iterations:
            return float("nan"), g
        return s, g
    return poisoned


@pytest.mark.parametrize("policy", ["skip", "halve_lr", "off"])
def test_nan_guard_policies_take_the_references_steps(policy):
    kw = dict(algo=OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT,
              iterations=8, learning_rate=0.1, terminations=(),
              nan_guard=policy)
    x0 = np.ones(5)
    ours = minimize(_poisoned_vg({2, 5}), x0, **kw)
    kw["algo"] = JaxAlgo.STOCHASTIC_GRADIENT_DESCENT
    theirs = jax_minimize(_poisoned_vg({2, 5}), x0, **kw)
    np.testing.assert_array_equal(ours[0], theirs[0])
    np.testing.assert_array_equal(ours[2], theirs[2])
    assert np.isnan(ours[2][2]) and np.isfinite(ours[0]).all()


def test_nan_guard_raise_names_the_iteration():
    kw = dict(algo=OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT,
              iterations=8, terminations=(), nan_guard="raise")
    with pytest.raises(TrainingDivergedError, match="step 3") as ours:
        minimize(_poisoned_vg({3}), np.ones(5), **kw)
    kw["algo"] = JaxAlgo.STOCHASTIC_GRADIENT_DESCENT
    with pytest.raises(JaxDiverged) as theirs:
        jax_minimize(_poisoned_vg({3}), np.ones(5), **kw)
    assert str(ours.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# networks
# ---------------------------------------------------------------------------
def _conf(algo, iterations=3, net="dense"):
    """``dense``: a tanh layer with an L2 of 1e-3, so the solver's flat
    loss carries a penalty term (the RBM stack has none);
    ``dense_no_penalty``: the same without it; ``rbm``: two RBMs under a
    softmax output, the pretrain params in the flat vector."""
    b = (JaxNNC.Builder().seed(21).iterations(iterations).learning_rate(0.1)
         .optimization_algo(JaxAlgo(algo.value)).list())
    if net == "rbm":
        b = (b.layer(0, jax_L.RBM(n_in=10, n_out=8))
             .layer(1, jax_L.RBM(n_in=8, n_out=6))
             .layer(2, jax_L.OutputLayer(n_in=6, n_out=3,
                                         loss_function="MCXENT",
                                         activation="softmax")))
    else:
        l2 = 1e-3 if net == "dense" else 0.0
        b = (b.layer(0, jax_L.DenseLayer(n_in=10, n_out=8, activation="tanh",
                                         l2=l2))
             .layer(1, jax_L.OutputLayer(n_in=8, n_out=3,
                                         loss_function="MCXENT",
                                         activation="softmax")))
    return b.build()


def _pair(jconf):
    ref = JaxMLN(jconf).init()
    port = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jconf.to_json()), device="cpu")
    load_network_from_jax(port, _np(ref.params), _np(ref.updater_state),
                          _np(ref.net_state), ref.iteration_count)
    return ref, port


def _data(seed, n=24):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, 10)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[(x[:, :3]).argmax(1)]
    return x, y


@pytest.mark.parametrize("algo", SOLVERS, ids=[a.name for a in SOLVERS])
@pytest.mark.parametrize("net", ["dense", "rbm", "dense_no_penalty"])
def test_fit_under_a_solver_matches(algo, net):
    ref, port = _pair(_conf(algo, net=net))
    ref_scores, scores = JaxCollect(), CollectScoresIterationListener()
    ref.set_listeners(ref_scores)
    port.set_listeners(scores)
    for seed in (1, 2):
        x, y = _data(seed)
        ref.fit(JaxDataSet(x, y))
        port.fit(DataSet(x, y))
    assert port.iteration_count == ref.iteration_count == 6
    its, vals = zip(*scores.scores)
    ref_its, ref_vals = zip(*ref_scores.scores)
    assert its == ref_its
    np.testing.assert_allclose(vals, ref_vals, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(port.get_flat_params(), ref.get_flat_params(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(port.score_value, ref.score_value,
                               rtol=RTOL, atol=ATOL)
    stats = port.solver_stats
    assert stats["iterations"] == 6 and stats["optimize_calls"] == 2
    assert stats["value_and_grad_calls"] == 6
    n = port.num_params()
    assert stats["bytes_from_device"] == 2 * 4 * n + 6 * (4 * n + 4) + \
        4 * stats["score_calls"]


def test_flat_order_on_an_rbm_stack():
    ref, port = _pair(_conf(OptimizationAlgorithm.LBFGS, net="rbm"))
    flat = port.get_flat_params()
    np.testing.assert_array_equal(flat, np.asarray(ref.get_flat_params()))
    rebuilt = Solver(port)._unflatten(torch.from_numpy(flat))
    for i in range(3):
        for name, leaf in port.params[str(i)].items():
            assert torch.equal(rebuilt[str(i)][name], leaf)
    # numeric layer order, then sorted names: "W" sorts before "hb"
    w = port.params["0"]["W"].numel()
    assert np.array_equal(flat[:w], port.params["0"]["W"].numpy().ravel())
