"""Port parity for the RNTN (``models/rntn.py``), held against the JAX
package's ``RNTN`` at narrow widths (d 4–6, 2–5 classes).

The JAX model initialises with ``jax.random``, so its vocab, params and
AdaGrad state are carried into the port by ``load_rntn_from_jax``. The
port evaluates a batch by height (every node of one height, across the
batch, in one step) where the reference scans node by node; only the
summation order of the batched GEMMs differs, so node vectors, logits,
the loss, every gradient and the state after 3 ``fit`` batches are held
at float32 rtol 1e-4 / atol 1e-6, and predictions are equal. Against a
plain node-by-node loop of the port's own composition the schedule is
bitwise on the CPU (at these widths the CPU's GEMMs give a row the same
bits whatever the number of rows). A float64 finite-difference check
covers the hand-written parts of the backward (the fixed-order row
gather), and two CPU runs on a batch past 32,768 gathered elements give
the same bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.rntn import RNTN as JaxRNTN
from deeplearning4j_tpu.nlp.trees import Tree as JaxTree
from deeplearning4j_tpu.nlp.trees import build_word_index
from deeplearning4j_tpu_torch.models import RNTN
from deeplearning4j_tpu_torch.models.convert import load_rntn_from_jax
from deeplearning4j_tpu_torch.models.rntn import make_plan
from deeplearning4j_tpu_torch.nlp.trees import Tree

TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_NAMES = ("L", "W", "b", "T", "Ws", "bs")   # the reference's params


def _tree_strings(n, seed, classes, vocab=30, max_len=10):
    """Seeded SST-format binary trees with labels on every node (a few
    unlabelled nodes, and Zipf words, so row 0 and the head words
    repeat)."""
    rng = np.random.default_rng(seed)

    def label():
        return "X" if rng.random() < 0.05 else str(rng.integers(classes))

    def rec(words):
        if len(words) == 1:
            return f"({label()} {words[0]})"
        s = int(rng.integers(1, len(words)))
        return f"({label()} {rec(words[:s])} {rec(words[s:])})"

    return [rec([f"w{t}" for t in rng.zipf(1.4, rng.integers(1, max_len))
                 % vocab]) for _ in range(n)]


def _pair(d, classes, use_tensors=True, n=12, seed=0, activation="tanh"):
    """A JAX model with seeded numpy weights (its init's distributions;
    ``jax.random`` would compile a program a shape) and the port's model
    carried from it."""
    strings = _tree_strings(n, seed, classes)
    jt = [JaxTree.parse(s) for s in strings]
    pt = [Tree.parse(s) for s in strings]
    ref = JaxRNTN(num_hidden=d, num_classes=classes,
                  use_tensors=use_tensors, activation=activation)
    ref.vocab = build_word_index(jt)
    rng = np.random.default_rng(seed + 100)
    r = 1.0 / np.sqrt(2.0 * d)
    shapes = {"L": (len(ref.vocab), d), "W": (2 * d, d), "b": (d,),
              "T": (2 * d, 2 * d, d) if use_tensors else (0, 0, 0),
              "Ws": (d, classes), "bs": (classes,)}
    ref.params = {k: jnp.asarray(
        rng.normal(0, 0.01, s) if k == "L"
        else rng.uniform(-r, r, s) if k in ("W", "T", "Ws")
        else np.zeros(s), jnp.float32) for k, s in shapes.items()}
    ref.updater_state = {k: jnp.zeros_like(p)
                         for k, p in ref.params.items()}
    # a word the vocab lacks falls back to row 0
    jt.append(JaxTree.parse("(1 (0 unseen) (1 w1))"))
    pt.append(Tree.parse("(1 (0 unseen) (1 w1))"))
    port = load_rntn_from_jax(
        RNTN(num_hidden=d, num_classes=classes, use_tensors=use_tensors,
             activation=activation, device="cpu"), ref)
    return ref, port, jt, pt


CONFIGS = [(4, 2, True, "tanh"), (6, 5, True, "relu"),
           (5, 3, False, "tanh")]


@pytest.mark.parametrize("d,classes,use_tensors,activation", CONFIGS)
def test_forward_loss_and_grads_equal(d, classes, use_tensors, activation):
    ref, port, jt, pt = _pair(d, classes, use_tensors,
                              activation=activation)
    batch, _ = ref._batch_programs(jt)
    # the reference's per-tree evaluator, over the padded batch at once
    bufs, logits = jax.jit(jax.vmap(ref._forward_tree, in_axes=(None, 0)))(
        ref.params, batch)
    for i, b in enumerate(pt):
        n = b.binarize().num_nodes()
        np.testing.assert_allclose(port.node_vectors(b),
                                   np.asarray(bufs[i, :n]), **TOL)
        _, plogits = port._evaluate(b)
        np.testing.assert_allclose(plogits.numpy(),
                                   np.asarray(logits[i, :n]), **TOL)
        want = np.asarray(jnp.argmax(logits[i, :n], axis=-1))
        np.testing.assert_array_equal(port.predict(b), want)
        assert port.predict_root(b) == int(want[-1])
    loss, grads = jax.jit(jax.value_and_grad(ref._loss))(ref.params,
                                                         batch)
    leaves = {k: p.clone().requires_grad_(True)
              for k, p in port.params.items()}
    ploss = port._loss(leaves, port._plan(pt))
    ploss.backward()
    np.testing.assert_allclose(float(ploss.detach()), float(loss), **TOL)
    for k in PARAM_NAMES:
        got = (leaves[k].grad if leaves[k].grad is not None
               else torch.zeros_like(leaves[k]))
        np.testing.assert_allclose(got.numpy(), np.asarray(grads[k]),
                                   err_msg=k, **TOL)
    np.testing.assert_allclose(port.score(pt), float(loss), **TOL)
    np.testing.assert_array_equal(port.get_word_vector("w1"),
                                  np.asarray(ref.get_word_vector("w1")))


@pytest.mark.parametrize("d,classes,use_tensors", [(4, 2, True),
                                                   (5, 3, False)])
def test_fit_three_batches_equal(d, classes, use_tensors):
    ref, port, jt, pt = _pair(d, classes, use_tensors, n=12)
    ref_loss = ref.fit(jt, batch_size=5)          # 3 batches (5, 5, 3)
    port_loss = port.fit(pt, batch_size=5)
    assert port.iteration_count == ref.iteration_count == 3
    assert port.loss_history.shape == (3,)
    np.testing.assert_allclose(port_loss, ref_loss, **TOL)
    for k in PARAM_NAMES:
        np.testing.assert_allclose(port.params[k].numpy(),
                                   np.asarray(ref.params[k]),
                                   err_msg=k, **TOL)
        np.testing.assert_allclose(port.updater_state[k].numpy(),
                                   np.asarray(ref.updater_state[k]),
                                   err_msg=k, **TOL)
    if not use_tensors:
        assert tuple(port.params["T"].shape) == (0, 0, 0)


def test_init_matches_the_reference_shapes_and_draws():
    strings = _tree_strings(20, 1, 5)
    ref = JaxRNTN().init([JaxTree.parse(s) for s in strings])
    port = RNTN(device="cpu").init([Tree.parse(s) for s in strings])
    assert port.vocab == ref.vocab
    r = 1.0 / np.sqrt(50.0)
    for k in PARAM_NAMES:
        assert tuple(port.params[k].shape) == tuple(ref.params[k].shape)
    assert float(port.params["L"].std()) == pytest.approx(0.01, rel=0.2)
    for k in ("W", "T", "Ws"):
        p = port.params[k]
        assert float(p.abs().max()) <= r and float(p.std()) > 0.4 * r
    again = RNTN(device="cpu").init([Tree.parse(s) for s in strings])
    for k in PARAM_NAMES:
        assert torch.equal(port.params[k], again.params[k])
    assert tuple(RNTN(use_tensors=False, device="cpu").init(
        [Tree.parse(s) for s in strings]).params["T"].shape) == (0, 0, 0)
    with pytest.raises(ValueError):
        RNTN(device="cpu").init()


def _node_by_node(model, tree):
    """The reference's order: one node at a time, post-order, through the
    port's own leaf and composition functions."""
    prog = tree.linearize(model.vocab)
    vecs = []
    for i in range(int(prog["n_nodes"])):
        if prog["is_leaf"][i]:
            v = model._leaf(model.params,
                            torch.tensor([int(prog["word"][i])]))
        else:
            cc = torch.cat([vecs[prog["left"][i]], vecs[prog["right"][i]]],
                           dim=1)
            v = model._compose(model.params, cc)
        vecs.append(v)
    buf = torch.cat(vecs)
    return buf, buf @ model.params["Ws"] + model.params["bs"]


@pytest.mark.parametrize("d,classes,use_tensors", [(4, 2, True),
                                                   (6, 5, True),
                                                   (5, 3, False)])
def test_height_schedule_equals_node_loop_bitwise(d, classes, use_tensors):
    pt = [Tree.parse(s) for s in _tree_strings(16, 4, classes)]
    port = RNTN(num_hidden=d, num_classes=classes, use_tensors=use_tensors,
                device="cpu").init(pt)
    plan = port._plan(pt)
    with torch.no_grad():
        buf, logits = port._forward(port.params, plan)
        for t, tree in enumerate(pt):
            rows = torch.from_numpy(plan.rows[t])
            want_buf, want_logits = _node_by_node(port, tree)
            assert torch.equal(buf[rows], want_buf)
            assert torch.equal(logits[rows], want_logits)
    # O(height) steps: one a level, and leaves first
    heights = [tree.binarize().depth() for tree in pt]
    assert len(plan.levels) == max(heights)
    assert plan.n_leaves == sum(len(t.words()) for t in pt)


def test_plan_layout():
    trees = [Tree.parse("(1 (0 a) (1 (2 b) (0 c)))"), Tree.parse("(3 d)")]
    plan = make_plan([t.linearize({"*UNK*": 0, "a": 1, "b": 2, "c": 3})
                      for t in trees], torch.device("cpu"))
    # rows: leaves a, b, c, d; then (b c) at height 1; then the root
    assert plan.words.tolist() == [1, 2, 3, 0]
    assert plan.levels == [(4, 1, 4), (5, 1, 6)]
    assert plan.children(0).tolist() == [1, 2]
    assert plan.children(1).tolist() == [0, 4]
    assert plan.labels.tolist() == [0, 2, 0, 3, 1, 1]
    assert [r.tolist() for r in plan.rows] == [[0, 1, 2, 4, 5], [3]]
    assert plan.n_labelled == 6


def test_float64_finite_differences():
    pt = [Tree.parse(s) for s in _tree_strings(4, 2, 3)]
    port = RNTN(num_hidden=4, num_classes=3, device="cpu").init(pt)
    plan = port._plan(pt)
    names = list(port.params)
    inputs = tuple(port.params[k].double().requires_grad_(True)
                   for k in names)

    def loss(*ps):
        return port._loss(dict(zip(names, ps)), plan)

    assert torch.autograd.gradcheck(loss, inputs, eps=1e-6, atol=1e-7,
                                    rtol=1e-5, fast_mode=True)


def test_two_cpu_runs_bitwise_past_the_accumulate_threshold():
    """Leaves × d past 32,768 gathered elements, where CPU autograd's
    accumulating index_put_ stops adding in a fixed order."""
    strings = _tree_strings(600, 8, 5, vocab=200, max_len=24)
    trees = [Tree.parse(s) for s in strings]
    runs = []
    for _ in range(2):
        m = RNTN(num_hidden=6, device="cpu").init(trees)
        assert m._plan(trees).n_leaves * 6 > 32768
        m.fit(trees, batch_size=len(trees))
        m.fit(trees, batch_size=len(trees))
        runs.append(m)
    for k in PARAM_NAMES:
        assert torch.equal(runs[0].params[k], runs[1].params[k]), k
        assert torch.equal(runs[0].updater_state[k],
                           runs[1].updater_state[k]), k
    assert np.isfinite(runs[0].loss_history).all()


def test_loading_params_by_keyword():
    ref, _, jt, pt = _pair(4, 2, True, n=4)
    params = {k: np.asarray(v) for k, v in ref.params.items()}
    params["Ws"] = params["Ws"] * 2.0
    port = load_rntn_from_jax(RNTN(num_hidden=4, num_classes=2,
                                   device="cpu"), ref, **params)
    np.testing.assert_array_equal(port.params["Ws"].numpy(), params["Ws"])
    assert port.vocab == ref.vocab and port.iteration_count == 0
    for k in PARAM_NAMES:
        assert not np.any(np.asarray(ref.updater_state[k]))
        assert not torch.any(port.updater_state[k])
