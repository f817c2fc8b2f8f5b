"""Port parity for ``TransformerLM``'s sequence parallelism against
``deeplearning4j_tpu.models.transformer`` over a device mesh.

The JAX model runs ``loss`` and ``make_train_step`` with ``mesh=`` and
``sequence_parallel=True`` on a 2- or 4-device slice of the 8 host
devices (``MeshSpec(data=1, sequence=n)``; one case ``data=2 x
sequence=2``); the port runs the same calls in gloo worlds of 2 and 4
spawned ranks (``tests/torch_worlds.py``), every rank given the global
tokens, from the JAX model's params (``models/convert.params_from_jax``)
and zero Adam moments. Cases: the ring with the plain blocks
(``attn_impl="xla"``) and with the flash kernels (their plain versions
on the CPU; the JAX side in Pallas interpret mode), Ulysses, RoPE with a
sliding window of 6 (the windowed ring), GQA, and ``mixed_bf16``.

Gates: the loss at the reference's own 1e-5 relative; the gradients
(summed over the mesh) at float32 rtol 1e-4 with atol 1e-4 of each
leaf's largest entry; params after 3 Adam steps at atol 1e-4, the
single-device training parity's gate (``tests/test_torch_training.py``;
Adam's first steps are ±lr whatever the gradient's size, so a gradient
entry near zero may step either way); ``mixed_bf16`` 2e-2 / 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.models.transformer import TransformerLM as JaxLM
from deeplearning4j_tpu.parallel import MeshSpec as JaxMeshSpec
from deeplearning4j_tpu.parallel import build_mesh as jax_build_mesh

import torch_worlds

SIZES = (2, 4)
STEPS = 3
BASE = dict(vocab_size=32, d_model=32, num_heads=4, num_layers=1,
            max_len=32, seed=0)


def _spec(name, n, mesh=None, **cfg):
    return dict(name=name, n=n, mesh=mesh or dict(data=1, sequence=n),
                cfg={**BASE, **cfg})


SPECS = [_spec("ring-xla", 2, attn_impl="xla"),
         _spec("ring-flash", 4, attn_impl="flash"),
         _spec("ulysses", 2, sp_impl="ulysses"),
         _spec("ulysses", 4, sp_impl="ulysses"),
         _spec("rope-window", 4, attn_impl="flash", pos_encoding="rope",
               attn_window=6),
         _spec("gqa", 2, attn_impl="flash", num_kv_heads=2),
         _spec("data-sequence", 4, dict(data=2, sequence=2),
               attn_impl="flash"),
         _spec("mixed-bf16", 4, attn_impl="flash",
               dtype_policy="mixed_bf16")]


def _key(s):
    return f"{s['name']}-{s['n']}"


def _tokens(seed):
    return np.random.default_rng(seed).integers(0, 32, (4, 32)).astype(
        np.int32)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    cases, refs = {}, {}
    for i, s in enumerate(SPECS):
        ref = JaxLM(**s["cfg"]).init()
        refs[_key(s)] = ref
        cases[_key(s)] = dict(
            n=s["n"], mesh=s["mesh"], cfg=s["cfg"], tokens=_tokens(i),
            params=jax.tree_util.tree_map(np.asarray, ref.params),
            steps=STEPS, forward=True)
    results = {}
    for n in SIZES:
        results.update(torch_worlds.run_world(
            n, ["lm_cases"], {"lm": cases},
            str(tmp_path_factory.mktemp(f"lm{n}")))["lm_cases"])
    return cases, refs, results


def _jax_run(ref, case):
    m = case["mesh"]
    n = m["data"] * m["sequence"]
    mesh = jax_build_mesh(JaxMeshSpec(**m), devices=jax.devices()[:n])
    tok = jnp.asarray(case["tokens"])
    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: ref.loss(p, tok, mesh=mesh, sequence_parallel=True,
                               train=True)))(ref.params)
        step = ref.make_train_step(mesh=mesh, sequence_parallel=True,
                                   donate=False)
        losses = [ref.fit_batch(tok, train_step=step) for _ in range(STEPS)]
    return float(loss), grads, losses


@pytest.mark.parametrize("spec", SPECS, ids=[_key(s) for s in SPECS])
def test_sequence_parallel_matches_reference(worlds, spec):
    cases, refs, results = worlds
    key = _key(spec)
    got, case, ref = results[key], cases[key], refs[key]
    loss, grads, losses = _jax_run(ref, case)
    bf16 = spec["cfg"].get("dtype_policy") == "mixed_bf16"
    if bf16:
        assert abs(got["loss"] - loss) <= 2e-2
    else:
        assert got["loss"] == pytest.approx(loss, rel=1e-5)
    want = [np.asarray(g, np.float32)
            for g in jax.tree_util.tree_leaves(grads)]
    assert len(want) == len(got["grads"])
    for a, b in zip(want, got["grads"]):
        scale = float(np.abs(a).max())
        if bf16:
            assert np.abs(a - b).max() <= 2e-2 * max(scale, 1.0)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4 * scale)
    np.testing.assert_allclose(got["losses"], losses, rtol=0,
                               atol=2e-2 if bf16 else 1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(ref.params),
                    jax.tree_util.tree_leaves(got["params"])):
        assert np.abs(np.asarray(a, np.float32) - b).max() <= (
            1e-2 if bf16 else 1e-4)
    # the mesh step has collectives: it runs eagerly, not captured
    assert got["captured"] is False


def test_forward_gathers_the_global_logits(worlds):
    """``forward`` over the mesh returns the whole ``[b, t, V]`` logits
    in every rank, equal to the JAX model's over its mesh."""
    cases, refs, results = worlds
    for key in ("ring-flash-4", "data-sequence-4"):
        case = cases[key]
        lm = JaxLM(**case["cfg"]).init()
        m = case["mesh"]
        mesh = jax_build_mesh(JaxMeshSpec(**m), devices=jax.devices()[
            :m["data"] * m["sequence"]])
        with mesh:
            want = np.asarray(lm.forward(lm.params,
                                         jnp.asarray(case["tokens"]),
                                         mesh=mesh, sequence_parallel=True))
        np.testing.assert_allclose(results[key]["logits"], want, rtol=1e-4,
                                   atol=1e-5)
