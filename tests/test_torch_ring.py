"""Port parity for ring attention and Ulysses against
``deeplearning4j_tpu.parallel.ring_attention`` / ``.ulysses``.

The JAX side runs each global ``[b, t, h, d]`` case on a 2- or 4-device
slice of the 8 host devices (``MeshSpec(data=1, sequence=n)``), the
flash ring with the Pallas kernels in interpret mode; the port side runs
gloo worlds of 2 and 4 spawned ranks (``tests/torch_worlds.py``), each
rank given its sequence shard, the flash ring taking the kernels' plain
versions on CPU tensors. One world per size runs every case; outputs
and the gradients of ``Σ out·g`` come back gathered whole.

Gates: the reference's own for the ring (rtol 2e-4 / atol 2e-5) on
outputs and gradients in float32; bf16 2e-2 / 1e-2. The reference's
bf16 windowed flash backward does not trace (its ``lax.cond`` branches
return f32 and bf16, ROADMAP C), so the port's bf16 windowed gradients
are held against the port's own float32 ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.parallel import MeshSpec as JaxMeshSpec
from deeplearning4j_tpu.parallel import build_mesh as jax_build_mesh
from deeplearning4j_tpu.parallel.ring_attention import (
    ring_attention as jax_ring)
from deeplearning4j_tpu.parallel.ulysses import (
    ulysses_attention as jax_ulysses)

import torch_worlds
from deeplearning4j_tpu_torch.parallel.ring_attention import (
    _win_steps,
    hop_schedule,
)

SIZES = (2, 4)
B, T, H, D = 2, 32, 4, 16
TOL = {"float32": dict(rtol=2e-4, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=1e-2)}


def _spec(impl, n, causal, window=None, dtype="float32"):
    return dict(impl=impl, n=n, causal=causal, window=window, dtype=dtype)


SPECS = (
    [_spec(impl, n, c) for impl in ("xla", "flash", "ulysses")
     for n in SIZES for c in (False, True)]
    + [_spec(impl, n, True, 6) for impl in ("xla", "flash", "ulysses")
       for n in SIZES]
    + [_spec(impl, 4, True, w) for impl in ("xla", "flash")
       for w in (1, 40)]
    + [_spec("flash", 4, c, None, "bfloat16") for c in (False, True)]
    + [_spec("flash", 4, True, 6, "bfloat16")])


def _key(s):
    w = "" if s["window"] is None else f"-w{s['window']}"
    return f"{s['impl']}-{s['n']}-{'causal' if s['causal'] else 'full'}" \
           f"{w}-{s['dtype']}"


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return {a: rng.normal(size=(B, T, H, D)).astype(np.float32)
            for a in "qkvg"}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    cases = {}
    for i, s in enumerate(SPECS):
        cases[_key(s)] = {**s, **_inputs(i), "grad": True}
    # the port's float32 twin of each bf16 case (the windowed one's
    # gradient gate)
    for key, c in list(cases.items()):
        if c["dtype"] == "bfloat16":
            cases[key + "-twin"] = {**c, "dtype": "float32"}
    results = {}
    for n in SIZES:
        out = torch_worlds.run_world(
            n, ["ring_cases", "ring_errors"], {"ring": cases},
            str(tmp_path_factory.mktemp(f"ring{n}")))
        results.update(out["ring_cases"])
        results[f"errors-{n}"] = out["ring_errors"]
    return cases, results


def _jax_case(c):
    n = c["n"]
    mesh = jax_build_mesh(JaxMeshSpec(data=1, sequence=n),
                          devices=jax.devices()[:n])
    dt = jnp.bfloat16 if c["dtype"] == "bfloat16" else jnp.float32
    q, k, v = (jnp.asarray(c[a], dt) for a in "qkv")
    g = jnp.asarray(c["g"], jnp.float32)

    def f(q, k, v):
        if c["impl"] == "ulysses":
            return jax_ulysses(q, k, v, mesh, causal=c["causal"],
                               window=c["window"])
        return jax_ring(q, k, v, mesh, causal=c["causal"], impl=c["impl"],
                        window=c["window"], interpret=True)

    if c["dtype"] == "bfloat16" and c["window"] is not None:
        # the reference's bf16 windowed backward does not trace
        return {"out": np.asarray(jax.jit(f)(q, k, v).astype(jnp.float32))}

    @jax.jit
    def out_and_grads(q, k, v, g):
        out, vjp = jax.vjp(lambda *a: f(*a).astype(jnp.float32), q, k, v)
        return out, vjp(g)

    out, grads = out_and_grads(q, k, v, g)
    want = {"out": np.asarray(out)}
    for name, x in zip(("dq", "dk", "dv"), grads):
        want[name] = np.asarray(x.astype(jnp.float32))
    return want


@pytest.mark.parametrize("spec", SPECS, ids=[_key(s) for s in SPECS])
def test_ring_and_ulysses_match_reference(worlds, spec):
    cases, results = worlds
    key = _key(spec)
    got, want = results[key], _jax_case(cases[key])
    tol = TOL[spec["dtype"]]
    for name in ("out", "dq", "dk", "dv"):
        if name in want:
            np.testing.assert_allclose(got[name], want[name], **tol,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(got[name], results[key + "-twin"][
                name], **tol, err_msg=name)


def test_refusals_match_reference(worlds):
    cases, results = worlds
    got = results["errors-2"]
    assert got["window_needs_causal"] == \
        "window requires causal=True and window >= 1"
    assert got["bad_impl"] == "unknown ring attention impl 'pallas'"
    assert got["heads"] == ("num_heads 3 not divisible by "
                            "sequence-parallel degree 2")


@pytest.mark.parametrize("window,t_local,n", [
    (1, 8, 4), (6, 8, 4), (8, 8, 4), (9, 8, 4), (20, 8, 8), (50, 8, 8)])
def test_window_hops_as_reference(window, t_local, n):
    from deeplearning4j_tpu.parallel.ring_attention import (
        _win_steps as jax_win_steps)

    assert _win_steps(window, t_local, n) == jax_win_steps(window, t_local,
                                                           n)


def test_hop_schedule_counts_the_flash_hops():
    """Causal: rank r runs r + 1 of n hops (10 at n=4); a full ring n²;
    a window its diagonal and fully in-band hops."""
    assert hop_schedule(4, causal=True) == 10
    assert hop_schedule(4, causal=False) == 16
    assert hop_schedule(4, causal=True, window=128, t_local=256) == 4
    # t_local 8, window 20: hops 0 (diag), 1 (full: 16 <= 20), 2 (partial)
    assert hop_schedule(4, causal=True, window=20, t_local=8) == 4 + 3
