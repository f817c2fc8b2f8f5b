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


def _any_network(case):
    """A CPU MultiLayerNetwork or ComputationGraph from the case's JSON
    conf (``case["graph"]`` picks the class), carrying the JAX state."""
    from deeplearning4j_tpu_torch.models.convert import load_network_from_jax
    from deeplearning4j_tpu_torch.nn import ComputationGraph
    from deeplearning4j_tpu_torch.nn.conf import (
        ComputationGraphConfiguration)

    if not case.get("graph"):
        return _network(case)
    net = ComputationGraph(ComputationGraphConfiguration.from_json(
        case["conf"]), device="cpu").init()
    return load_network_from_jax(net, *case["state"])


def _epoch_data(case):
    """The case's data: a ListDataSetIterator over one DataSet, or a
    list of MultiDataSet batches (``case["multi"]``)."""
    from deeplearning4j_tpu_torch.datasets import (
        DataSet, ListDataSetIterator, MultiDataSet)

    if case.get("multi"):
        return [MultiDataSet(list(f), list(l)) for f, l in case["multi"]]
    return ListDataSetIterator(DataSet(*case["arrays"]), case["batch"])


def _all_ranks(obj):
    import torch.distributed as dist

    views = [None] * dist.get_world_size()
    dist.all_gather_object(views, obj)
    return views


def dp_epoch_cases(rank, n, payload):
    """Every mesh-epoch case at this world's size: ``fit_epochs`` through
    ``ParallelWrapper`` (``mode`` ``wrapper``), ``net.fit_epochs(mesh=)``
    (``net_mesh``) or the over-budget stream (``stream``, beside the
    wrapper's ``fit`` run each epoch on a second network), with the
    history, the sentinel and metrics, the whole state, each rank's
    plans and, with ``one_device``, the port's own one-device run."""
    from deeplearning4j_tpu_torch.dtypes import tree_leaves
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.resilience.guard import (
        TrainingDivergedError)

    out = {}
    for key, case in payload["dp_epoch"].items():
        if case["n"] != n:
            continue
        mesh = _mesh(data=n)
        net = _any_network(case)
        kw = case.get("fit", {})
        res = {}
        if case["mode"] == "net_mesh":
            hist = net.fit_epochs(_epoch_data(case), case["epochs"],
                                  mesh=mesh, **kw)
            params, upd = net.params, net.updater_state
        else:
            w = ParallelWrapper(net, mesh=mesh, fsdp=case.get("fsdp", False))
            try:
                hist = w.fit_epochs(_epoch_data(case), case["epochs"], **kw)
            except TrainingDivergedError as e:  # guard="raise"
                hist = None
                res["diverged"] = (e.epoch, e.step, e.batch_index,
                                   e.n_trips)
            res["local_numel"] = sum(x.numel()
                                     for x in tree_leaves(net.params))
            res["plans"] = _all_ranks(w._epoch_plans)
            params, upd = w.gather()
        if case["mode"] == "stream":
            other = _any_network(case)
            w2 = ParallelWrapper(other, mesh=mesh)
            for _ in range(case["epochs"]):
                w2.fit(_epoch_data(case))
            res["fit_params"] = _tree_np(other.params)
            res["fit_updater"] = _tree_np(other.updater_state)
        if case.get("one_device"):
            one = _any_network(case)
            one_hist = one.fit_epochs(_epoch_data(case), case["epochs"],
                                      **kw)
            res["one_hist"] = _np(one_hist)
            res["one_params"] = _tree_np(one.params)
        res.update(
            hist=None if hist is None else _np(hist),
            params=_tree_np(params), updater=_tree_np(upd),
            iteration=net.iteration_count,
            sentinel=(None if net._last_sentinel is None
                      else net._last_sentinel.copy()),
            metrics=(None if net._last_metrics is None
                     else _np(net._last_metrics)))
        out[key] = res
    return out


# ---------------------------------------------------------------------------
# the model, pipe and expert axes (tests/test_torch_model_parallel.py)
# ---------------------------------------------------------------------------
def _tp_lm(case):
    """A CPU TransformerLM carrying the case's JAX params, sharded over
    the case's mesh."""
    mesh = _mesh(**case["mesh"])
    lm = _lm(case["cfg"], case["params"])
    lm.shard_params(mesh)
    return lm, mesh


def tp_lm_cases(rank, n, payload):
    """The LM over ``model`` (and ``data × model``): greedy and beam
    tokens, one step's loss and whole gradients, forward logits, decode
    rows at batch 1 and 5, and a step's launch of the attention per
    rank's heads."""
    import torch

    from deeplearning4j_tpu_torch.dtypes import tree_leaves, tree_map
    from deeplearning4j_tpu_torch.parallel.collectives import all_reduce_tree_
    from deeplearning4j_tpu_torch.parallel.mesh import axis_group

    out = {}
    for key, case in payload["tp_lm"].items():
        lm, mesh = _tp_lm(case)
        res = {"wq_local": tuple(lm.params["blocks"][0]["attn"]["wq"].shape),
               "wk_local": tuple(lm.params["blocks"][0]["attn"]["wk"].shape)}
        tokens = torch.as_tensor(case["tokens"])
        if case.get("decode"):
            prompt = torch.as_tensor(case["prompt"])
            res["greedy"] = lm.generate(prompt, case["new"]).numpy()
            seqs, scores = lm.generate_beam(prompt, case["beam_new"],
                                            beam_size=3)
            res["beam"] = seqs.numpy()
            res["beam_scores"] = scores.numpy()
            res["logits"] = lm.forward(lm.params, tokens).numpy()
            # the unsharded port on this rank's rows: the same bytes
            one = _lm(case["cfg"], case["params"])
            rows = lm._local_part(tokens, mesh, False)[0]
            res["same_logits"] = bool(torch.equal(
                torch.as_tensor(res["logits"])[rows],
                one.forward(one.params, tokens[rows])))
            oseqs, oscores = one.generate_beam(prompt, case["beam_new"],
                                               beam_size=3)
            res["same_beam"] = bool(torch.equal(seqs, oseqs)
                                    and torch.equal(scores, oscores))
        if case.get("grads"):
            fwd = tree_map(lambda p: p.detach().requires_grad_(), lm.params)
            loss = lm.loss(fwd, tokens, mesh=mesh, train=True)
            grads = list(torch.autograd.grad(loss, tree_leaves(fwd)))
            for axis in lm._mesh_axes(mesh, False):
                all_reduce_tree_(grads, axis_group(mesh, axis))
            it = iter(grads)
            whole = lm._registry.gather(tree_map(lambda _: next(it), fwd))
            res["loss"] = float(loss.detach())
            res["grads"] = [g.numpy() for g in tree_leaves(whole)]
            step = lm.make_train_step(mesh=mesh)
            res["captured"] = step.captured
            res["step_loss"] = lm.fit_batch(tokens, train_step=step)
            params, _ = lm.gather_params()
            res["params"] = _tree_np(params)
        out[key] = res
    return out


def tp_invariance_case(rank, n, payload):
    """One decode row alone and beside four others in a ``model=n``
    engine: its logits must be the same bytes."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.serving.engine import (
        DecodeEngine, _decode_step_body)

    case = payload["tp_invariance"]
    lm, mesh = _tp_lm(case)
    eng = DecodeEngine(lm, 5, max_len=case["max_len"], mesh=mesh,
                       device="cpu")
    rng = np.random.default_rng(3)
    for slot in range(5):
        eng.prefill(rng.integers(0, 64, 6 + slot), slot)
    tok = torch.as_tensor(rng.integers(0, 64, 5))
    pos = eng.cache.cursors.clone()
    alone = _decode_step_body(lm, eng.cache.slot_view(2), tok[2:3],
                              pos[2:3])
    batch = _decode_step_body(lm, eng.cache, tok, pos)
    return {"equal": bool(torch.equal(alone[0], batch[2])),
            "kv_local_heads": int(eng.cache.k.shape[3]),
            "n_shard": eng.cache.n_shard}


def tp_serve_cases(rank, n, payload):
    """``DecodeEngine(mesh=)`` through ``DecodeServer(mesh=)`` on one
    Poisson schedule under a fake clock: the greedy streams."""
    import numpy as np

    from deeplearning4j_tpu_torch.serving import DecodeServer
    from deeplearning4j_tpu_torch.serving.loadgen import (
        Arrival, run_open_loop)

    out = {}
    for key, case in payload["tp_serve"].items():
        lm, mesh = _tp_lm(case)
        t = [0.0]

        def clock():
            t[0] += 0.004
            return t[0]

        srv = DecodeServer(lm, slots=case["slots"], max_len=case["max_len"],
                           kv_dtype=case.get("kv_dtype"),
                           fuse_steps=case.get("fuse_steps", 1),
                           mesh=mesh, device="cpu", clock=clock)
        sched = [Arrival(**a) for a in case["schedule"]]
        report = run_open_loop(srv, sched, clock=clock,
                               sleep=lambda s: t.__setitem__(0, t[0] + s))
        out[key] = {"streams": {r.prompt.tobytes(): np.asarray(r.output)
                                for r in srv.finished},
                    "finished": report.finished,
                    "kv_shards": srv.stats()["kv_shards"],
                    "pool_local_heads": int(srv.engine.cache.k.shape[3])}
    return out


# ---------------------------------------------------------------------------
# slot handoff into and out of tensor-parallel replicas: every rank holds
# the same fleet and makes the same calls; rank 0 decides
# ---------------------------------------------------------------------------
def _rank_clock(rank):
    """A fake clock: rank 0's ticks 4 ms a read, every other rank's 1e7 s
    a read, past any deadline at once. A decision a follower took from
    its own clock would part its fleet from rank 0's."""
    t = [0.0]
    tick = 0.004 if rank == 0 else 1e7

    def clock():
        t[0] += tick
        return t[0]

    return clock


def _recording(router):
    """``router``, recording every handoff it places in ``handoffs``."""
    router.handoffs = []
    place = router.place_handoff

    def recorded(freq, handoff):
        router.handoffs.append(handoff)
        return place(freq, handoff)

    router.place_handoff = recorded
    return router


def _fleet(specs, clock, **kw):
    """Replicas ``(id, role, lm, mesh[, own settings])`` on the server
    settings ``kw``, and a router over them that records every handoff
    it places."""
    from deeplearning4j_tpu_torch.serving import DecodeServer
    from deeplearning4j_tpu_torch.serving.fleet import (
        FleetRouter, ServeReplica)

    reps = [ServeReplica(rid, lm, role=role, server=DecodeServer(
        lm, mesh=mesh, device="cpu", clock=clock,
        **{**kw, **(own[0] if own else {})}), clock=clock)
        for rid, role, lm, mesh, *own in specs]
    return reps, _recording(FleetRouter(reps, clock=clock))


def _drive(router, reps, limit=400):
    """Step every live replica in turn (and retry parked slabs) until
    rank 0's router has nothing unfinished (asked through a TP server's
    ``agree``, whichever replica holds one)."""
    tp = [r.server for r in reps if r.server.tensor_parallel]
    for _ in range(limit):
        left = bool(router.unfinished())
        if not (tp[0].agree(left) if tp else left):
            return
        for r in reps:
            if r.alive:
                r.step_once()
        router.retry_pending()
    raise AssertionError("the fleet did not finish")


def _server_kw(case):
    return dict(slots=case.get("slots", 2), max_len=case["max_len"],
                kv_dtype=case.get("kv_dtype"),
                fuse_steps=case.get("fuse_steps", 1),
                temperature=case.get("temperature", 0.0),
                top_k=case.get("top_k"))


def _fleet_result(router, frs, reps):
    return {"streams": [fr.output for fr in frs],
            "nbytes": [h.nbytes for h in router.handoffs],
            "kv_per_slot_bytes": {r.replica_id:
                                  r.server.stats()["kv_per_slot_bytes"]
                                  for r in reps},
            "kv_shards": {r.replica_id: r.server.stats()["kv_shards"]
                          for r in reps}}


def _tp_split_fleet(rank, case):
    """A split fleet of TP replicas (``p0`` prefill, ``d0``/``d1``
    decode) serving the case's requests."""
    lm, mesh = _tp_lm(case)
    clock = _rank_clock(rank)
    reps, router = _fleet([("p0", "prefill", lm, mesh),
                           ("d0", "decode", lm, mesh),
                           ("d1", "decode", lm, mesh)], clock,
                          **_server_kw(case))
    frs = [router.submit(r["prompt"], r["max_new_tokens"], seed=r["seed"],
                         deadline_s=case.get("deadline_s"))
           for r in case["requests"]]
    _drive(router, reps)
    res = _fleet_result(router, frs, reps)
    res["placed"] = [fr.replica_id for fr in frs]
    res["shed"] = router.stats()["shed"]
    try:   # a loop thread would order its collectives on its own
        reps[1].start()
        res["thread"] = "started"
    except ValueError as e:
        res["thread"] = str(e)
    return res


def _tp_split_drain(rank, case):
    """Drain the TP decode replica ``d0`` of a split fleet mid-stream,
    with live slots and a handoff it has not installed yet, onto
    ``d1``."""
    from deeplearning4j_tpu_torch.serving.fleet import FleetController

    lm, mesh = _tp_lm(case)
    clock = _rank_clock(rank)
    reps, router = _fleet([("p0", "prefill", lm, mesh),
                           ("d0", "decode", lm, mesh, {"slots": 4}),
                           ("d1", "decode", lm, mesh)], clock,
                          **_server_kw(case))
    p0, d0, _ = reps
    reqs = case["requests"]
    frs = [router.submit(r["prompt"], r["max_new_tokens"]) for r in reqs[:4]]
    for _ in range(4):   # three slabs land on d0 (4 slots), one on d1
        p0.step_once()
    d0.step_once()
    d0.step_once()
    frs.append(router.submit(reqs[4]["prompt"], reqs[4]["max_new_tokens"]))
    p0.step_once()       # the fifth waits on d0, not installed yet
    placed = [fr.replica_id for fr in frs]
    emitted = [list(fr.tokens) for fr in frs]
    decision = FleetController(router, None, evict_timeout_s=5.0,
                               clock=clock).drain("d0")
    _drive(router, reps)
    res = _fleet_result(router, frs, reps)
    res.update(placed=placed, emitted=emitted, decision=decision,
               retired=d0.retired and not d0.dead)
    return res


def _tp_mixed_drain(rank, n, case):
    """The one-device drain test's fleet on TP replicas, built as the
    reference's ``DL4J_TP_SHARDS`` fleet is (``FleetRouter.build``, each
    server's mesh from the environment): two mixed replicas, three
    requests pinned to the first, which drains after two steps with two
    live slots and one queued request."""
    import os

    from deeplearning4j_tpu_torch.serving.fleet import (
        FleetController, FleetRouter)

    lm = _lm(case["cfg"], case["params"])
    clock = _rank_clock(rank)
    os.environ["DL4J_TP_SHARDS"] = str(n)
    try:
        router = _recording(FleetRouter.build(
            lm, replicas=2, role="mixed", clock=clock, device="cpu",
            max_queue=4, **_server_kw(case)))
    finally:
        del os.environ["DL4J_TP_SHARDS"]
    reps = router.replicas
    frs = [router.submit(r["prompt"], r["max_new_tokens"], seed=i,
                         affinity="pin")
           for i, r in enumerate(case["requests"][:3])]
    placed = [fr.replica_id for fr in frs]
    reps[0].step_once()
    reps[0].step_once()
    emitted = [list(fr.tokens) for fr in frs]
    decision = FleetController(router, None, evict_timeout_s=5.0,
                               clock=clock).drain(placed[0])
    _drive(router, reps)
    res = _fleet_result(router, frs, reps)
    res.update(placed=placed, emitted=emitted, decision=decision)
    return res


def _tp_cross_layout(rank, case):
    """Slabs from a TP prefill replica into a one-device decode replica,
    and from a one-device prefill replica into a TP decode replica; the
    TP export against a one-device prefill of the same prompt."""
    import numpy as np

    from deeplearning4j_tpu_torch.serving import DecodeServer
    from deeplearning4j_tpu_torch.serving.fleet import export_slot

    lm, mesh = _tp_lm(case)
    one = _lm(case["cfg"], case["params"])
    clock = _rank_clock(rank)
    kw = _server_kw(case)
    out = {}
    for name, specs in (("tp_to_one", [("p0", "prefill", lm, mesh),
                                       ("d0", "decode", one, None)]),
                        ("one_to_tp", [("p1", "prefill", one, None),
                                       ("d1", "decode", lm, mesh)])):
        reps, router = _fleet(specs, clock, **kw)
        frs = [router.submit(r["prompt"], r["max_new_tokens"])
               for r in case["requests"]]
        _drive(router, reps)
        out[name] = _fleet_result(router, frs, reps)
        out[name]["slabs"] = router.handoffs
    # the TP export holds the bytes a one-device prefill writes
    single = DecodeServer(one, device="cpu", **kw)
    same = []
    for r, h in zip(case["requests"], out["tp_to_one"]["slabs"]):
        single.engine.prefill(r["prompt"], 0)
        want = export_slot(single.engine, 0)
        same.append(all(np.array_equal(h.slabs[k][:, :h.cursor],
                                       want[k][:, :h.cursor])
                        for k in ("k", "v")))
    for name in out:
        out[name].pop("slabs")
    out["slab_bytes_equal"] = same
    out["pool_local_heads"] = int(lm._local_heads()[1])
    return out


def _skewed_clock(rank):
    """A settable fake clock: rank 0 reads ``t["now"]``, every other rank
    runs 1e7 s a read ahead of it. A hedge a follower timed on its own
    clock would part its fleet from rank 0's."""
    t = {"now": 0.0, "reads": 0}

    def clock():
        if rank == 0:
            return t["now"]
        t["reads"] += 1
        return t["now"] + 1e7 * t["reads"]

    return t, clock


def _tp_hedge(rank, case):
    """The one-device hedge tests' race on two mixed replicas, TP unless
    ``case["tp"]`` is False: two requests fill both one-slot replicas, a
    third queues on ``r0``, the clock passes ``hedge_after_s`` and a
    hedge goes to ``r1``; then the hedge (``win``) or the primary
    (``lose``) reaches a slot first and the loser is withdrawn."""
    t, clock = _skewed_clock(rank)
    if case.get("tp", True):
        lm, mesh = _tp_lm(case)
    else:
        lm, mesh = _lm(case["cfg"], case["params"]), None
    reps, router = _fleet([("r0", "mixed", lm, mesh),
                           ("r1", "mixed", lm, mesh)], clock, max_queue=2,
                          **_server_kw(case))
    router.hedge_after_s = 0.05
    reqs = case["requests"]
    a, b = [router.submit(r["prompt"], r["max_new_tokens"])
            for r in reqs[:2]]
    for r in reps:
        r.step_once()
    c = router.submit(reqs[2]["prompt"], reqs[2]["max_new_tokens"])
    hedges = [router.maybe_hedge()]
    t["now"] = 0.1
    hedges.append(router.maybe_hedge())
    primary, hedge = c.replica_id, c.hedge_replica_id
    pri_rep, hedge_rep = router._by_id[primary], router._by_id[hedge]
    if case["scenario"] == "win":   # the hedge's replica frees its slot
        first = a if hedge == "r0" else b
        while router.agree(not first.finished):
            hedge_rep.step_once()
        hedge_rep.step_once()
    else:                           # the primary's replica admits it
        while router.agree(c.inner.state == "queued"):
            pri_rep.step_once()
    hedges.append(router.maybe_hedge())
    settled = (c.replica_id, c.hedge is None, router.hedge_wins)
    _drive(router, reps)
    return {"streams": [fr.output for fr in (a, b, c)], "hedges": hedges,
            "primary": primary, "hedge": hedge, "settled": settled,
            "hedge_log": len(router.hedge_log),
            "finished": [fr.finished for fr in (a, b, c)]}


def tp_fleet_cases(rank, n, payload):
    """Slot handoff into and out of tensor-parallel replicas: split
    fleets, drains, slabs across layouts and hedges (the case's
    ``kind``)."""
    kinds = {"split": _tp_split_fleet, "split_drain": _tp_split_drain,
             "mixed_drain": lambda r, c: _tp_mixed_drain(r, n, c),
             "cross": _tp_cross_layout, "hedge": _tp_hedge}
    return {key: kinds[case["kind"]](rank, case)
            for key, case in payload["tp_fleet"].items()}


def _tp_network(case):
    from deeplearning4j_tpu_torch.models.convert import load_network_from_jax
    from deeplearning4j_tpu_torch.nn.conf.graph import (
        ComputationGraphConfiguration)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
        shard_network_params)

    if case.get("graph"):
        net = load_network_from_jax(ComputationGraph(
            ComputationGraphConfiguration.from_json(case["conf"]),
            device="cpu").init(), *case["state"])
    else:
        net = _network(case)
    mesh = _mesh(**case["mesh"])
    if case.get("wrapper"):
        from deeplearning4j_tpu_torch.parallel import ParallelWrapper

        return ParallelWrapper(net, mesh=mesh), mesh
    if case.get("how") != "fit_epochs":   # fit_epochs(mesh=) splits it
        shard_network_params(net, mesh)
    return net, mesh


def tp_network_cases(rank, n, payload):
    """MultiLayerNetworks and graphs under ``shard_network_params``: the
    output before and the whole state after ``fit`` (or, by the case's
    ``how``, ``fit_steps`` on its one batch, or ``net.fit_epochs(mesh=)``
    unshuffled over its batches, which splits the network itself)."""
    import torch

    out = {}
    for key, case in payload["tp_net"].items():
        net, mesh = _tp_network(case)
        trainer = net
        if case.get("wrapper"):   # rows over data, layers over model
            net = trainer.network
        res = {}
        how = case.get("how", "fit")
        if how != "fit_epochs":
            x = torch.as_tensor(case["batches"][0][0])
            y = net.output(x)
            res["output"] = _np(y[0] if case.get("graph") else y)
        if how == "fit_epochs":
            from deeplearning4j_tpu_torch.datasets import DataSet

            res["hist"] = _np(net.fit_epochs(
                [DataSet(*b) for b in case["batches"]], case["epochs"],
                mesh=mesh, shuffle=False))
        elif how == "fit_steps":
            (b,) = _batches(case)
            net.fit_steps(b, case["steps"])
        else:
            for b in _batches(case):
                trainer.fit(b)
        impls = (net.layer_impls if case.get("graph")
                 else dict(enumerate(net.layers)))
        res["kinds"] = {str(k): type(v).__name__ for k, v in impls.items()}
        reg = net._sharding_registry
        res.update(params=_tree_np(reg.gather(net.params)),
                   updater=_tree_np(reg.gather_state(net.updater_state)))
        if case.get("unsharded"):   # the port's own fit on one device
            ref = _network(case)
            for b in _batches(case):
                ref.fit(b)
            res["unsharded_params"] = _tree_np(ref.params)
        out[key] = res
    return out


def tp_checkpoint_case(rank, n, payload):
    """A TP-sharded LM's checkpoint round trip: saved whole, restored
    onto another model's shards."""
    import numpy as np

    from deeplearning4j_tpu_torch.utils.checkpoint import (
        restore_network, save_network)

    case = payload["tp_checkpoint"]
    lm, mesh = _tp_lm(case)
    lm.fit_batch(np.asarray(case["tokens"]),
                 train_step=lm.make_train_step(mesh=mesh))
    save_network(case["dir"], lm, step=1)
    other = _lm({**case["cfg"], "seed": 5})
    other.shard_params(mesh)
    restore_network(case["dir"], other)
    same = _equal_trees(lm.params, other.params)
    same_state = _equal_trees(lm.opt_state, other.opt_state)
    return {"same_params": same, "same_state": same_state,
            "step_count": other.step_count,
            "wq_local": tuple(other.params["blocks"][0]["attn"]["wq"].shape)}


def _equal_trees(a, b) -> bool:
    """Same keys and the same bytes in every leaf, whatever the key
    order."""
    import torch

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal_trees(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_equal_trees, a, b))
    return bool(torch.equal(a, b))


def _pipe_stage_fn(params, x):
    import torch

    return torch.tanh(x @ params["W"] + params["b"])


def pipe_cases(rank, n, payload):
    """GPipe over ``pipe`` (and ``data × pipe``): outputs, gradients of
    the mean-square loss and 20 SGD steps' losses."""
    import torch

    from deeplearning4j_tpu_torch.dtypes import tree_map
    from deeplearning4j_tpu_torch.models.convert import params_from_jax
    from deeplearning4j_tpu_torch.parallel import (
        pipeline_train_step, shard_stage_params, split_microbatches,
        spmd_pipeline)
    from deeplearning4j_tpu_torch.parallel.collectives import (
        all_gather, all_reduce_tree_)
    from deeplearning4j_tpu_torch.parallel.mesh import (
        PIPE_AXIS, axis_group, axis_size)

    out = {}
    for key, case in payload["pipe"].items():
        mesh = _mesh(**case["mesh"])
        stacked = params_from_jax(case["stacked"])
        x = torch.as_tensor(case["x"])
        y = torch.as_tensor(case["y"])
        local = tree_map(lambda p: p.requires_grad_(),
                         shard_stage_params(stacked, mesh))
        res = {"out": _np(spmd_pipeline(
            _pipe_stage_fn, local, split_microbatches(x, case["micro"]),
            mesh).reshape(x.shape))}
        pred = spmd_pipeline(_pipe_stage_fn, local, split_microbatches(
            x, case["micro_grad"]), mesh).reshape(x.shape)
        loss = ((pred - y) ** 2).mean()
        grads = list(torch.autograd.grad(loss, [local["W"], local["b"]]))
        # the whole stack's gradient: summed over the data groups' rows,
        # the stages gathered over pipe
        if axis_size(mesh, "data") > 1:
            all_reduce_tree_(grads, axis_group(mesh, "data"))
        group = axis_group(mesh, PIPE_AXIS)
        res["grads"] = [_np(all_gather(g, group, 0)) for g in grads]
        step = pipeline_train_step(
            _pipe_stage_fn, lambda p, t: ((p - t) ** 2).mean(), mesh,
            n_microbatches=case["micro"], learning_rate=0.5)
        params = shard_stage_params(params_from_jax(case["train_stacked"]),
                                    mesh)
        losses = []
        for _ in range(21):
            params, l_ = step(params, x, y)
            losses.append(float(l_))
        res["losses"] = losses
        out[key] = res
    return out


def moe_cases(rank, n, payload):
    """The MoE FFN over ``expert``: y, aux, the router's and this
    rank's experts' gradients gathered whole, and 31 SGD steps."""
    import torch

    from deeplearning4j_tpu_torch.models.convert import params_from_jax
    from deeplearning4j_tpu_torch.parallel import (
        MoEConfig, moe_ffn, shard_moe_params)
    from deeplearning4j_tpu_torch.parallel.collectives import all_gather
    from deeplearning4j_tpu_torch.parallel.mesh import (
        EXPERT_AXIS, axis_group)

    case = payload["moe"]
    cfg = MoEConfig(**case["cfg"])
    mesh = _mesh(**case["mesh"])
    group = axis_group(mesh, EXPERT_AXIS)
    params = shard_moe_params(params_from_jax(case["params"]), mesh)
    params = {k: v.requires_grad_() for k, v in params.items()}
    x = torch.as_tensor(case["x"])
    y, aux = moe_ffn(params, x, cfg, mesh)
    res = {"y": _np(y), "aux": float(aux)}
    target = torch.as_tensor(case["target"])
    loss = ((y - target) ** 2).mean() + aux
    names = ["Wg", "W1", "b1", "W2", "b2"]
    grads = torch.autograd.grad(loss, [params[k] for k in names])
    res["grads"] = {k: _np(g if k == "Wg" else all_gather(g, group, 0))
                    for k, g in zip(names, grads)}
    drop_cfg = MoEConfig(**case["drop_cfg"])
    dp = shard_moe_params(params_from_jax(case["drop_params"]), mesh)
    res["dropped"] = _np(moe_ffn(dp, torch.as_tensor(case["drop_x"]),
                                 drop_cfg, mesh)[0])
    p = shard_moe_params(params_from_jax(case["train_params"]), mesh)
    xt, yt = torch.as_tensor(case["train_x"]), torch.as_tensor(
        case["train_y"])
    losses = []
    for _ in range(31):
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        o, a = moe_ffn(leaves, xt, cfg, mesh)
        l_ = ((o - yt) ** 2).mean() + a
        g = torch.autograd.grad(l_, list(leaves.values()))
        p = {k: (v - 0.1 * gi).detach()
             for (k, v), gi in zip(leaves.items(), g)}
        losses.append(float(l_))
    res["losses"] = losses
    return res


# ---------------------------------------------------------------------------
# the cluster layer (tests/test_torch_cluster.py)
# ---------------------------------------------------------------------------
def _wrapped(case, mesh, fsdp=False):
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    return ParallelWrapper(_network(case), mesh=mesh, fsdp=fsdp)


def _deadline(net):
    return net._chunk_watchdog.deadline_s


def elastic_case(rank, n, payload):
    """The uninterrupted ``data=4`` run against one resharded between
    chunks ``data=4 → None → data=2 × model=2 → data=4``; the reshard
    counter, the shard shapes and the watchdog's deadline on the way, and
    ranks that disagree at a boundary."""
    from deeplearning4j_tpu_torch.monitor import metrics

    case = payload["elastic"]
    m4, m22 = _mesh(data=4), _mesh(data=2, model=2)
    base = _wrapped(case, m4)
    base_hist = base.fit_epochs(_epoch_data(case), 4, chunk_epochs=1)
    counter = metrics().counter("elastic_reshards_total")
    before = counter.value(model="MultiLayerNetwork")
    w = _wrapped(case, m4)
    plan = {1: None, 2: m22, 3: m4}
    seen = {}

    def on_chunk(done):
        net = w.network
        seen[done] = (tuple(net.params["0"]["W"].shape),
                      w.mesh is None, w.data_parallelism, _deadline(net))
        if done in plan:
            w.request_reshard(plan[done])
        return False

    hist = w.fit_epochs(_epoch_data(case), 4, chunk_epochs=1,
                        on_chunk=on_chunk)
    # a reshard that only rank 0 asks for: every rank stops alike
    lone = _wrapped(case, m4)

    def rank0_only(done):
        if rank == 0:
            lone.request_reshard(None)
        return False

    disagreed = None
    try:
        lone.fit_epochs(_epoch_data(case), 2, chunk_epochs=1,
                        on_chunk=rank0_only)
    except RuntimeError as e:
        disagreed = str(e)
    return {"disagreed": disagreed, "hist": _np(hist),
            "base_hist": _np(base_hist),
            "params": _tree_np(w.gather()[0]),
            "base_params": _tree_np(base.gather()[0]),
            "reshards": counter.value(model="MultiLayerNetwork") - before,
            "seen": seen, "plans": _all_ranks(w._epoch_plans)}


# the width cases: name -> (payload key, start, fsdp, {epochs done:
# target}); a target names a mesh of ``width_cases``, "None" whole batches
WIDTH_EPOCHS = 4
WIDTH_PLANS = {
    "a": ("elastic", "m4", False, {1: "r01", 2: "m4"}),
    "b": ("elastic", "m4", False, {1: "r123"}),
    "c": ("elastic", None, False, {1: "m4", 2: "r23", 3: "None"}),
    "d": ("elastic", "m4", True, {1: "r01"}),
    "g": ("graph", "m4", False, {1: "r123", 2: "r01", 3: "m4"}),
    "m": ("elastic", "m4", False, {1: "r01_model", 3: "m4"}),
}
WIDTH_SLOW_MS = 600.0  # rank 3's injected epoch.chunk delay in case (e)


def _width_run(rank, case, meshes, start, fsdp, plan, shuffle):
    """One run of a width case, from ``start`` (a mesh name, or None:
    ``net.fit_epochs`` without a mesh in every rank), resharded at the
    boundaries of ``plan``; what every rank returned and holds."""
    from deeplearning4j_tpu_torch.monitor import metrics

    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    counter = metrics().counter("elastic_reshards_total")
    net = _any_network(case)
    model = type(net).__name__
    before = counter.value(model=model)
    w = None if start is None else ParallelWrapper(net, meshes[start],
                                                   fsdp=fsdp)
    owner = net if w is None else w
    deadlines, shapes = {}, {}

    def on_chunk(done):
        deadlines[done] = _deadline(net)
        shapes[done] = _local_shapes(net.params)
        if done in plan:
            owner.request_reshard(meshes[plan[done]])
        return False

    hist = owner.fit_epochs(_epoch_data(case), WIDTH_EPOCHS,
                            chunk_epochs=1, on_chunk=on_chunk,
                            shuffle=shuffle)
    out = _width_result(w, net, hist, deadlines,
                        counter.value(model=model) - before)
    out["shapes"] = shapes
    return out


def _width_result(w, net, hist, deadlines, reshards):
    params = net.params if w is None else w.gather()[0]
    parked = False if w is None else w._parked
    return {"hist": _np(hist), "params": _tree_np(params),
            "deadlines": deadlines, "reshards": reshards,
            "ranks": _all_ranks((_np(hist), _tree_np(params), parked,
                                 net.iteration_count))}


def _autopilot_run(rank, n, case, meshes, shuffle):
    """Case (e), the chaos soak's counterpart: rank 3's first chunk
    straggles by an injected ``epoch.chunk`` delay. Each rank reports the
    time it stalled at the chunk's site (every rank's wall time is the
    straggler's, since the chunk's collectives wait for it); rank 0's
    ``GoodputAutopilot`` sees the stall, evicts rank 3 and reshards onto
    the healthy ranks, and once rank 3 beats healthily again readmits it,
    and the run grows back. Rank 0's decisions are broadcast at the
    boundary, and every rank builds the same mesh and requests it."""
    import statistics
    import time

    import torch.distributed as dist

    from deeplearning4j_tpu_torch.monitor import metrics, tracer
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from deeplearning4j_tpu_torch.resilience import GoodputAutopilot, faults

    counter = metrics().counter("elastic_reshards_total")
    before = counter.value(model="MultiLayerNetwork")
    w = _wrapped(case, meshes["m4"])
    wanted = []
    ap = GoodputAutopilot(
        floor=50.0, silence_s=1e9, straggler_ticks=1, cooldown_s=1e9,
        evict=lambda member, d: None,
        reshard=lambda healthy, d: wanted.append(
            [int(h.split("-")[1]) for h in healthy]),
        readmit=lambda member, d: wanted.append(list(range(n))))
    clock = {"chunks": 0}
    slow = faults.delay(WIDTH_SLOW_MS)

    def chunk_site(name):
        clock["enter"] = time.perf_counter()
        if rank == 3 and clock["chunks"] == 0:
            slow(name)
        clock["chunks"] += 1
        clock["stall"] = time.perf_counter() - clock["enter"]

    deadlines, meshes_seen, decisions = {}, {}, []

    def on_chunk(done):
        deadlines[done] = _deadline(w.network)
        wall = time.perf_counter() - clock["enter"]
        stalls = _all_ranks(clock["stall"])
        box = [None]
        if rank == 0:
            mid = statistics.median(stalls)
            fleet = {f"rank-{r}": {"step_s": wall, "stall_s": s}
                     for r, s in enumerate(stalls)}
            flagged = [f"rank-{r}" for r, s in enumerate(stalls)
                       if s > mid + WIDTH_SLOW_MS / 2e3]
            asked = len(wanted)
            decisions.extend(d.action for d in ap.observe(
                fleet, stragglers=flagged,
                last_beat={m: float(done) for m in fleet},
                goodput_pct=100.0 * max(0.0, 1.0 - max(stalls) / wall),
                now=float(done)))
            box = [wanted[-1] if len(wanted) > asked else None]
        dist.broadcast_object_list(box, src=0)
        if box[0] is not None:
            ranks = box[0]
            mesh = (meshes["m4"] if len(ranks) == n else build_mesh(
                MeshSpec(data=len(ranks)), ranks=ranks, device="cpu"))
            meshes_seen[done] = ranks
            w.request_reshard(mesh)
        return False

    mark = len(tracer().spans())
    faults.install("epoch.chunk", chunk_site)
    try:
        hist = w.fit_epochs(_epoch_data(case), WIDTH_EPOCHS, chunk_epochs=1,
                            on_chunk=on_chunk, shuffle=shuffle)
    finally:
        faults.clear()
    out = _width_result(w, w.network, hist, deadlines,
                        counter.value(model="MultiLayerNetwork") - before)
    out.update(decisions=decisions, meshes=meshes_seen,
               spans=sorted({sp.name for sp in tracer().spans()[mark:]}))
    return out


def _one_rank_runs(case, meshes):
    """A mesh of rank 0 alone in the world of 4: ``net.fit_epochs(mesh=)``
    in the data's order, and ``ParallelWrapper.fit`` over ranks [0,1] on
    the case's batches; in every rank its steps, history and state."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    net = _network(case)
    hist = net.fit_epochs(_epoch_data(case), 2, mesh=meshes["r0"],
                          shuffle=False)
    one = {"hist": _np(hist), "ranks": _all_ranks((
        _np(hist), _tree_np(net.params), net._train_dispatches,
        net._mesh_wrapper_._parked))}
    w = ParallelWrapper(_network(case), meshes["r01"])
    x, y = case["arrays"][:2]
    w.fit([DataSet(x[i:i + 32], y[i:i + 32]) for i in range(0, 128, 32)])
    net = w.network
    fit = {"params": _tree_np(w.gather()[0]), "ranks": _all_ranks((
        _tree_np(w.gather()[0]), net._train_dispatches, w._parked,
        net.iteration_count))}
    return {"one_rank": one, "fit_r01": fit}


def _parked_checkpoint(rank, case, meshes, directory):
    """``FaultTolerantTrainer`` over ranks [1,2,3] (rank 0 parked),
    preempted after its first epoch: the checkpoint taken at that
    boundary, restored onto a fresh network in every rank, beside the
    lead's params at the stop."""
    from deeplearning4j_tpu_torch.parallel import FaultTolerantTrainer
    from deeplearning4j_tpu_torch.resilience import faults
    from deeplearning4j_tpu_torch.resilience.preemption import (
        PreemptionGuard)

    w = _wrapped(case, meshes["r123"])
    ft = FaultTolerantTrainer(w, directory, worker_id=f"rank-{rank}")
    faults.install("preempt.chunk", faults.fail_nth(1))
    try:
        ft.fit_epochs(_epoch_data(case), 2,
                      preemption=PreemptionGuard(signals=()))
    finally:
        faults.clear()
    ft.wait_for_saves()
    _all_ranks(ft.preempted)  # every save is on disk
    again = FaultTolerantTrainer(_network(case), directory)
    again.resume()
    return {"restored": _all_ranks(_tree_np(again.network.params)),
            "final": _all_ranks(_tree_np(w.gather()[0]))}


def _parked_divergence(case, meshes):
    """``fit_epochs(guard="raise")`` over ranks [1,2,3] on the case's data
    with one row of its second batch non-finite: what each rank raised
    (epoch, step, batch index)."""
    import numpy as np

    from deeplearning4j_tpu_torch.resilience.guard import (
        TrainingDivergedError)

    x, y = case["arrays"][:2]
    x = x.copy()
    x[40] = np.nan
    w = _wrapped(case, meshes["r123"])
    seen = None
    try:
        w.fit_epochs(_epoch_data({**case, "arrays": (x, y, None, None)}), 2,
                     chunk_epochs=1, guard="raise", shuffle=False)
    except TrainingDivergedError as e:
        seen = (e.epoch, e.step, e.batch_index)
    return {"raised": _all_ranks(seen), "parked": _all_ranks(w._parked)}


def _parked_save_network(case, meshes, directory):
    """``save_network`` in every rank of an FSDP run over ranks [0,1]
    (ranks 2 and 3 parked), then ``restore_network`` onto a fresh
    network in every rank, beside the lead's gathered params."""
    from deeplearning4j_tpu_torch.utils.checkpoint import (
        restore_network, save_network)

    w = _wrapped(case, meshes["m4"], fsdp=True)

    def shrink(done):
        if done == 1:
            w.request_reshard(meshes["r01"])
        return False

    w.fit_epochs(_epoch_data(case), 2, chunk_epochs=1, on_chunk=shrink)
    save_network(directory, w.network, step=1)
    _all_ranks(None)  # the lead's save is on disk
    fresh = restore_network(directory, _network(case))
    return {"restored": _all_ranks(_tree_np(fresh.params)),
            "lead": _tree_np(w.gather()[0]), "parked": _all_ranks(w._parked)}


def width_cases(rank, n, payload):
    """Cases (a)-(e) of a run that changes width in-process, each in the
    plans' order (``shuffle=False``, against the JAX package) and
    shuffled (against the port's uninterrupted run), beside those
    uninterrupted ``data=4`` runs; and (f), targets that cannot be
    built."""
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    case = payload["elastic"]
    meshes = {"m4": _mesh(data=4), "None": None}
    for name, ranks in (("r01", [0, 1]), ("r123", [1, 2, 3]),
                        ("r23", [2, 3])):
        meshes[name] = build_mesh(MeshSpec(data=len(ranks)), ranks=ranks,
                                  device="cpu")
    meshes["r0"] = build_mesh(MeshSpec(data=1), ranks=[0], device="cpu")
    meshes["r01_model"] = build_mesh(MeshSpec(data=1, model=2),
                                     ranks=[0, 1], device="cpu")
    out = {}
    for shuffle in (False, True):
        for key in ("elastic", "graph"):
            base = ParallelWrapper(_any_network(payload[key]),
                                   meshes["m4"])
            hist = base.fit_epochs(_epoch_data(payload[key]), WIDTH_EPOCHS,
                                   chunk_epochs=1, shuffle=shuffle)
            out[(f"base_{key}", shuffle)] = {
                "hist": _np(hist), "params": _tree_np(base.gather()[0])}
        for name, (key, start, fsdp, plan) in WIDTH_PLANS.items():
            out[(name, shuffle)] = _width_run(rank, payload[key], meshes,
                                              start, fsdp, plan, shuffle)
        out[("e", shuffle)] = _autopilot_run(rank, n, case, meshes, shuffle)
    out.update(_one_rank_runs(case, meshes))
    out["parked_checkpoint"] = _parked_checkpoint(
        rank, case, meshes, payload["resume"]["dir"] + "/parked_ck")
    out["parked_divergence"] = _parked_divergence(case, meshes)
    out["parked_save"] = _parked_save_network(
        case, meshes, payload["resume"]["dir"] + "/parked_save")
    refused = []
    for bad in ([3, 4], [-1, 0], [2, 1]):
        try:
            build_mesh(MeshSpec(data=2), ranks=bad, device="cpu")
        except ValueError as e:
            refused.append(str(e))
    out["refused"] = refused
    return out


def resume_cases(rank, n, payload):
    """``FaultTolerantTrainer`` on the wrapper's ``fit_epochs`` with a
    ``FileStateTracker``: preempted after epoch 1 and resumed over
    ``data=4`` (bitwise the uninterrupted run), over ``data=2 × model=2``
    and with ``fsdp=True`` from a copy of the preempted checkpoint; every
    rank's heartbeat in the tracker and its checkpoint pointer."""
    import os
    import shutil

    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import (
        FaultTolerantTrainer, FileStateTracker)
    from deeplearning4j_tpu_torch.resilience import faults
    from deeplearning4j_tpu_torch.resilience.preemption import (
        PreemptionGuard)

    case = payload["resume"]
    root = case["dir"]
    m4, m22 = _mesh(data=4), _mesh(data=2, model=2)
    epochs = 3
    base = _wrapped(case, m4)
    base.fit_epochs(_epoch_data(case), epochs, chunk_epochs=1)
    tracker = FileStateTracker(os.path.join(root, "tracker"))
    ck = os.path.join(root, "ck")

    def trainer(w, directory=ck):
        return FaultTolerantTrainer(w, directory, tracker=tracker,
                                    worker_id=f"rank-{rank}",
                                    heartbeat_interval_s=0.05)

    first = trainer(_wrapped(case, m4))
    faults.install("preempt.chunk", faults.fail_nth(1))
    try:
        first.fit_epochs(_epoch_data(case), epochs,
                         preemption=PreemptionGuard(signals=()))
    finally:
        faults.clear()
    preempted = first.preempted
    saved = os.path.join(root, "preempted")
    if rank == 0:
        shutil.copytree(ck, saved)
    dist.barrier()
    out = {"preempted": preempted,
           "base_params": _tree_np(base.gather()[0]),
           "pointer": tracker.get_meta("latest_checkpoint"),
           "saved_dir": saved}
    again = trainer(_wrapped(case, m4))
    out["resumed"] = again.resume()
    again.fit_epochs(_epoch_data(case), epochs)
    out["same_world"] = _tree_np(again.network.gather()[0])
    out["bitwise"] = _equal_trees(again.network.gather()[0],
                                  base.gather()[0])
    for name, kw in (("m22", dict(mesh=m22)), ("fsdp", dict(fsdp=True)),
                     ("m22_fsdp", dict(mesh=m22, fsdp=True))):
        other = os.path.join(root, f"from-{name}")
        if rank == 0:
            shutil.copytree(saved, other)
        dist.barrier()
        t = trainer(_wrapped(case, m4), other)
        t.resume(**kw)
        t.fit_epochs(_epoch_data(case), epochs)
        out[name] = _tree_np(t.network.gather()[0])
        params = t.network.network.params
        out[f"{name}_local_w"] = tuple(params["0"]["W"].shape)
        if name == "m22_fsdp":
            out["m22_fsdp_ranks"] = _all_ranks(
                (tuple(params["0"]["W"].shape),
                 tuple(params["1"]["W"].shape)))
    dist.barrier()
    out["workers"] = sorted(tracker.workers())
    # the tracker's pointer finds a checkpoint outside an empty directory
    lone = trainer(_wrapped(case, m4), os.path.join(root, f"empty{rank}"))
    out["pointer_resumes"] = lone.resume()
    return out


def _local_shapes(tree):
    """``{"layer/leaf": shape}`` of this rank's params."""
    return {f"{k}/{leaf}": tuple(v.shape) for k, layer in tree.items()
            for leaf, v in layer.items()}


def fsdp_model_cases(rank, n, payload):
    """``ParallelWrapper(fsdp=True)`` over ``data=2 × model=2``: every
    rank's param shapes, the whole state and the output after ``fit``, a
    checkpoint of that layout saved and restored onto another network's,
    the history and state after ``fit_epochs`` (shuffled, and in the
    data's order as ``*_ordered``), and the elastic run
    ``data=4``+FSDP → ``data=2 × model=2``+FSDP beside the uninterrupted
    ``data=4``+FSDP run."""
    import torch

    from deeplearning4j_tpu_torch.utils.checkpoint import (
        restore_network, save_network)

    case = payload["fsdp_model"]
    m4, m22 = _mesh(data=4), _mesh(data=2, model=2)
    out = {}
    w = _wrapped(case, m22, fsdp=True)
    out["shapes"] = _all_ranks(_local_shapes(w.network.params))
    out["kinds"] = [type(impl).__name__ for impl in w.network.layers]
    for b in _batches(case):
        w.fit(b)
    out["fit_params"] = _tree_np(w.gather()[0])
    out["output"] = _np(w.output(torch.as_tensor(case["batches"][0][0])))
    save_network(case["dir"], w.network, step=1)
    other = _wrapped(case, m22, fsdp=True)
    restore_network(case["dir"], other.network)
    out["restored_equal"] = _all_ranks(
        _equal_trees(other.network.params, w.network.params)
        and _equal_trees(other.network.updater_state,
                         w.network.updater_state))
    for suffix, shuffle in (("", True), ("_ordered", False)):
        w = _wrapped(case, m22, fsdp=True)
        out[f"epoch_hist{suffix}"] = _np(w.fit_epochs(
            _epoch_data(case), case["epochs"], shuffle=shuffle))
        out[f"epoch_params{suffix}"] = _tree_np(w.gather()[0])
    base = _wrapped(case, m4, fsdp=True)
    out["base_hist"] = _np(base.fit_epochs(_epoch_data(case),
                                           case["epochs"] + 1,
                                           chunk_epochs=1))
    out["base_params"] = _tree_np(base.gather()[0])
    w = _wrapped(case, m4, fsdp=True)
    seen = {}

    def on_chunk(done):
        seen[done] = _local_shapes(w.network.params)
        if done == 1:
            w.request_reshard(m22)
        return False

    out["elastic_hist"] = _np(w.fit_epochs(
        _epoch_data(case), case["epochs"] + 1, chunk_epochs=1,
        on_chunk=on_chunk))
    out["elastic_params"] = _tree_np(w.gather()[0])
    out["elastic_seen"] = seen
    return out


def w2v_cases(rank, n, payload):
    """``DistributedWord2Vec`` over ``data=4`` and row-sharded over
    ``data=2 × model=2``, fed the JAX plans: history, whole tables, the
    mode and this rank's table rows."""
    import torch

    from deeplearning4j_tpu_torch.nlp import CollectionSentenceIterator
    from deeplearning4j_tpu_torch.nlp.distributed import DistributedWord2Vec

    case = payload["w2v"]
    out = {}
    for name, spec in (("dp", dict(data=4)), ("rows", dict(data=2,
                                                           model=2))):
        mesh = _mesh(**spec)
        dw = DistributedWord2Vec(CollectionSentenceIterator(case["sents"]),
                                 mesh=mesh, device="cpu", **case["kw"])
        dw.vocab = case["vocab"]
        dw._table = case["table"]
        dw.syn0 = torch.from_numpy(case["syn0"].copy())
        dw.syn1neg = torch.from_numpy(case["syn1neg"].copy())
        hist = dw.fit_epochs(2, _plan=case["plans"])
        syn0, syn1neg = dw.gather_tables()
        out[name] = {"hist": _np(hist), "syn0": _np(syn0),
                     "syn1neg": _np(syn1neg), "mode": dw._fused_mode(mesh),
                     "local_rows": int(dw.syn0.shape[0]),
                     "batch": dw._corpus_cache.batch}
    # the host loop over data=4: each rank's slice, tables averaged
    dw = DistributedWord2Vec(CollectionSentenceIterator(case["sents"]),
                             mesh=_mesh(data=4), device="cpu", **case["kw"])
    dw.fit()
    out["host_loop"] = {"syn0": _all_ranks(_np(dw.syn0)),
                        "loss": float(dw._score)}
    return out


def contract_cases(rank, n, payload):
    """The program contracts over a mesh: a ``ParallelWrapper`` epoch
    program over ``data=4`` and a ``DistributedWord2Vec`` chunk over
    ``data=4`` hold all four, the network's state is what it was before
    the check, and a step that also sums over a group of another mesh (a
    ``model`` line of ``data=2 × model=2``, no axis of ``data=4``) is
    reported."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.analysis.contracts import (
        check_embedding_contracts, check_network_contracts)
    from deeplearning4j_tpu_torch.nlp import CollectionSentenceIterator
    from deeplearning4j_tpu_torch.nlp.distributed import DistributedWord2Vec
    from deeplearning4j_tpu_torch.parallel.collectives import all_reduce_
    from deeplearning4j_tpu_torch.parallel.mesh import axis_group

    case = payload["elastic"]
    m4, m22 = _mesh(data=4), _mesh(data=2, model=2)
    w = _wrapped(case, m4)
    cache = w.build_epoch_cache(_epoch_data(case))
    w.fit_epochs(cache, 1)
    before = _tree_np(w.network.params)
    clean = check_network_contracts(w, cache, raise_on_violation=False)
    after = _tree_np(w.network.params)
    unchanged = all(np.array_equal(a, b) for a, b in zip(
        _leaves_np(before), _leaves_np(after)))
    (key, prog), = w._programs.items()
    step = prog.step
    stray = axis_group(m22, "model")

    def seeded(i, it):
        out = step(i, it)
        all_reduce_(torch.zeros(1), stray)
        return out

    prog.step = seeded
    seeded_out = check_network_contracts(w, cache, raise_on_violation=False)
    prog.step = step
    w2v = payload["w2v"]
    dw = DistributedWord2Vec(CollectionSentenceIterator(w2v["sents"]),
                             mesh=m4, device="cpu", **w2v["kw"])
    dw.vocab = w2v["vocab"]
    dw._table = w2v["table"]
    dw.syn0 = torch.from_numpy(w2v["syn0"].copy())
    dw.syn1neg = torch.from_numpy(w2v["syn1neg"].copy())
    dw.fit_epochs(1, _plan=w2v["plans"][:1])
    syn0 = dw.syn0.clone()
    emb = check_embedding_contracts(dw, dw._corpus_cache, epochs=1,
                                    raise_on_violation=False)
    return {"clean": {repr(k): v for k, v in clean.items()},
            "seeded": {repr(k): v for k, v in seeded_out.items()},
            "unchanged": unchanged,
            "embedding": {repr(k): v for k, v in emb.items()},
            "tables_unchanged": bool(torch.equal(dw.syn0, syn0)),
            "found_in": _all_ranks(sum(len(v) for v in seeded_out.values()))}


def _leaves_np(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_np(tree[k])]
    return [tree]
