"""Spawned ``torch.distributed`` worlds for the port's mesh tests.

A world is ``n`` fresh Python processes on the CPU, joined as gloo
ranks through a ``FileStore`` in a temporary directory
(``parallel.mesh.join_world``: no TCP port, so test workers cannot
collide). Every rank runs the named case functions of this module in
order, on one payload (a pickle of numpy inputs), and writes what rank
0 returns to a result pickle; one world runs many cases, so each test
module pays for its ranks' imports once. The parent kills every rank
and fails if the world outlives its timeout.

This module imports no JAX: the ranks load it, and the tests that
compare against the JAX package import it from the parent only.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from typing import Any, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORLD_TIMEOUT_S = 180.0


def run_world(n: int, cases: List[str], payload: Dict[str, Any],
              tmp_dir: str, timeout_s: float = WORLD_TIMEOUT_S
              ) -> Dict[str, Any]:
    """Run ``cases`` (names of functions here) in a gloo world of ``n``
    ranks; returns ``{case: rank 0's result}``."""
    os.makedirs(tmp_dir, exist_ok=True)
    with open(os.path.join(tmp_dir, "payload.pkl"), "wb") as f:
        pickle.dump({"cases": cases, "payload": payload}, f)
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
           "MKL_NUM_THREADS": "1"}
    env.pop("JAX_PLATFORMS", None)
    code = ("import sys; sys.path.insert(0, %r); import torch_worlds; "
            "torch_worlds.child_main(int(sys.argv[1]), int(sys.argv[2]), "
            "sys.argv[3])" % HERE)
    procs = []
    for r in range(n):
        with open(os.path.join(tmp_dir, f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, str(r), str(n), tmp_dir],
                env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout_s
    logs = [os.path.join(tmp_dir, f"rank{r}.log") for r in range(n)]
    try:
        # a rank that fails leaves the others waiting in a collective:
        # poll them all and stop the world at the first failure
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"world of {n} outlived {timeout_s} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs)
           if p.returncode != 0]
    if bad:
        r, rc = bad[0]
        with open(logs[r]) as f:
            raise AssertionError(f"rank {r} exited {rc}:\n{f.read()[-4000:]}")
    with open(os.path.join(tmp_dir, "result.pkl"), "rb") as f:
        return pickle.load(f)


def child_main(rank: int, n: int, tmp_dir: str) -> None:
    import torch

    torch.set_num_threads(1)
    from deeplearning4j_tpu_torch.parallel.mesh import join_world, leave_world

    with open(os.path.join(tmp_dir, "payload.pkl"), "rb") as f:
        job = pickle.load(f)
    join_world(os.path.join(tmp_dir, "store"), rank, n, backend="gloo",
               timeout_s=WORLD_TIMEOUT_S)
    results = {}
    try:
        for name in job["cases"]:
            results[name] = globals()[name](rank, n, job["payload"])
    finally:
        leave_world()
    if rank == 0:
        with open(os.path.join(tmp_dir, "result.pkl"), "wb") as f:
            pickle.dump(results, f)


# ---------------------------------------------------------------------------
# helpers the cases share
# ---------------------------------------------------------------------------
def _mesh(**spec):
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    return build_mesh(MeshSpec(**spec), device="cpu")


def _gather_seq(x, mesh, dim=1):
    from deeplearning4j_tpu_torch.parallel.collectives import all_gather
    from deeplearning4j_tpu_torch.parallel.mesh import (
        SEQUENCE_AXIS, axis_group)

    return all_gather(x.contiguous(), axis_group(mesh, SEQUENCE_AXIS), dim)


def _np(x):
    return x.detach().float().cpu().numpy()


def _tensor(a, dtype="float32"):
    import torch

    return torch.as_tensor(a).to(getattr(torch, dtype))


# ---------------------------------------------------------------------------
# ring attention and Ulysses (tests/test_torch_ring.py)
# ---------------------------------------------------------------------------
def ring_cases(rank, n, payload):
    """Every ring case of the payload at this world's size: out (and,
    with ``grad``, dq/dk/dv of ``Σ out·g``) gathered to whole tensors."""
    import torch

    from deeplearning4j_tpu_torch.parallel.ring_attention import (
        ring_attention)
    from deeplearning4j_tpu_torch.parallel.ulysses import ulysses_attention
    from deeplearning4j_tpu_torch.parallel.mesh import local_chunk

    mesh = _mesh(data=1, sequence=n)
    out = {}
    for key, case in payload["ring"].items():
        if case["n"] != n:
            continue
        dt = case.get("dtype", "float32")
        q, k, v, g = (local_chunk(_tensor(case[a], dt), 1, n, rank)
                      .requires_grad_(a != "g")
                      for a in ("q", "k", "v", "g"))
        if case["impl"] == "ulysses":
            o = ulysses_attention(q, k, v, mesh, causal=case["causal"],
                                  window=case.get("window"))
        else:
            o = ring_attention(q, k, v, mesh, causal=case["causal"],
                               impl=case["impl"], window=case.get("window"))
        res = {"out": _np(_gather_seq(o.detach(), mesh))}
        if case.get("grad"):
            (o.float() * g.float()).sum().backward()
            for name, x in (("dq", q), ("dk", k), ("dv", v)):
                res[name] = _np(_gather_seq(x.grad, mesh))
        out[key] = res
    return out


def ring_errors(rank, n, payload):
    """What the ring and Ulysses refuse."""
    import torch

    from deeplearning4j_tpu_torch.parallel.ring_attention import (
        ring_attention)
    from deeplearning4j_tpu_torch.parallel.ulysses import ulysses_attention

    mesh = _mesh(data=1, sequence=n)
    x = torch.zeros(1, 4, 3, 8)
    msgs = {}
    for name, fn in (
            ("window_needs_causal",
             lambda: ring_attention(x, x, x, mesh, window=2)),
            ("bad_impl", lambda: ring_attention(x, x, x, mesh, impl="pallas")),
            ("heads", lambda: ulysses_attention(x, x, x, mesh))):
        try:
            fn()
            msgs[name] = None
        except ValueError as e:
            msgs[name] = str(e)
    return msgs


# ---------------------------------------------------------------------------
# the LM's sequence parallelism (tests/test_torch_sequence_parallel.py)
# ---------------------------------------------------------------------------
def _lm(cfg, params=None):
    """A CPU TransformerLM of ``cfg``; with ``params`` (numpy trees of
    the JAX model) carrying those weights and zero Adam moments."""
    from deeplearning4j_tpu_torch.models.convert import params_from_jax
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM

    lm = TransformerLM(**cfg, device="cpu").init()
    if params is not None:
        lm.params = params_from_jax(params, device="cpu")
        lm.opt_state = _zero_moments(lm.params)
    return lm


def _zero_moments(params):
    import torch

    from deeplearning4j_tpu_torch.dtypes import tree_map

    return tree_map(lambda p: {"m": torch.zeros_like(p),
                               "v": torch.zeros_like(p)}, params)


def _tree_np(tree):
    from deeplearning4j_tpu_torch.dtypes import tree_map

    return tree_map(lambda x: x.detach().float().cpu().numpy(), tree)


def lm_cases(rank, n, payload):
    """Every LM case: the loss, its gradients and ``steps`` Adam steps
    over a ``sequence=n`` (or ``data``/``sequence``) mesh, from the
    payload's params."""
    import torch

    from deeplearning4j_tpu_torch.dtypes import tree_leaves, tree_map
    from deeplearning4j_tpu_torch.parallel.collectives import all_reduce_tree_
    from deeplearning4j_tpu_torch.parallel.mesh import axis_group

    out = {}
    for key, case in payload["lm"].items():
        if case["n"] != n:
            continue
        mesh = _mesh(**case["mesh"])
        sp = case.get("sequence_parallel", True)
        lm = _lm(case["cfg"], case.get("params"))
        tokens = torch.as_tensor(case["tokens"])
        fwd = tree_map(lambda p: p.detach().requires_grad_(), lm.params)
        loss = lm.loss(fwd, tokens, mesh=mesh, sequence_parallel=sp,
                       train=True)
        grads = list(torch.autograd.grad(loss, tree_leaves(fwd)))
        for axis in lm._mesh_axes(mesh, sp):
            all_reduce_tree_(grads, axis_group(mesh, axis))
        res = {"loss": float(loss),
               "grads": [g.float().numpy() for g in grads]}
        if case.get("forward"):
            res["logits"] = lm.forward(lm.params, tokens, mesh=mesh,
                                       sequence_parallel=sp).float().numpy()
        if case.get("steps"):
            step = lm.make_train_step(mesh=mesh, sequence_parallel=sp)
            res["captured"] = step.captured
            losses = [lm.fit_batch(tokens, train_step=step)
                      for _ in range(case["steps"])]
            res.update(losses=losses, params=_tree_np(lm.params))
        out[key] = res
    return out


# ---------------------------------------------------------------------------
# data parallelism (tests/test_torch_data_parallel.py)
# ---------------------------------------------------------------------------
def _network(case):
    """A CPU MultiLayerNetwork from the case's JSON conf, carrying the
    JAX network's params, updater state, net state and iteration."""
    from deeplearning4j_tpu_torch.models.convert import load_network_from_jax
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf.neural_net import (
        MultiLayerConfiguration)

    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(case["conf"]),
                            device="cpu").init()
    return load_network_from_jax(net, *case["state"])


def _batches(case):
    from deeplearning4j_tpu_torch.datasets import DataSet

    return [DataSet(*b) for b in case["batches"]]


def dp_cases(rank, n, payload):
    """Every data-parallel case at this world's size: the state after
    ``fit`` through ``ParallelWrapper`` (replicated or FSDP) or
    ``ParameterAveragingTrainer``, gathered whole."""
    import torch

    from deeplearning4j_tpu_torch.dtypes import tree_leaves
    from deeplearning4j_tpu_torch.parallel import (
        ParallelWrapper, ParameterAveragingTrainer)
    from deeplearning4j_tpu_torch.parallel.collectives import all_gather
    from deeplearning4j_tpu_torch.parallel.mesh import DATA_AXIS, axis_group

    out = {}
    for key, case in payload["dp"].items():
        if case["n"] != n:
            continue
        mesh = _mesh(data=n)
        net = _network(case)
        batches = _batches(case)
        res = {}
        if case["kind"] == "pat":
            ParameterAveragingTrainer(
                net, num_replicas=case.get("replicas", n),
                averaging_frequency=case.get("frequency", 1),
                mesh=mesh).fit(batches)
            params, upd = net.params, net.updater_state
        else:
            w = ParallelWrapper(net, mesh=mesh, fsdp=case["kind"] == "fsdp")
            local = sum(x.numel() for x in tree_leaves(net.params))
            res["shard_numel"] = all_gather(
                torch.tensor([local]), axis_group(mesh, DATA_AXIS)).tolist()
            w.fit(batches)
            params, upd = w.gather()
            x = torch.as_tensor(case["batches"][0][0])
            res["output"] = _np(w.output(x))
            res["score"] = float(w.score(batches[0]))
        res.update(params=_tree_np(params), updater=_tree_np(upd),
                   net_state=_tree_np(net.net_state),
                   iteration=net.iteration_count,
                   dispatches=net._train_dispatches)
        out[key] = res
    return out
