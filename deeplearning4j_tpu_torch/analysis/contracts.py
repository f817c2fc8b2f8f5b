"""Program-contract checker: assert invariants of the cached fused programs.

Port of ``deeplearning4j_tpu/analysis/contracts.py``. dl4j-lint
(``analysis/rules.py``) checks the SOURCE; this module checks the
PROGRAMS a network, a ``ParallelWrapper`` or a ``Word2Vec`` keeps after
``fit_epochs``. The reference reads each program's jaxpr and lowered
StableHLO; the port's programs are a step captured as a CUDA graph over
static buffers (``perf/step_graph.py``, ``nn/fused.py``,
``nlp/epoch_kernels.py``) or, over a mesh, eager steps whose collectives
cannot be captured. So each program is checked by running it: one
**probe step** (the program's step function, run eagerly) and one
**chunk** (the program's own launch over ``epochs`` epochs), after which
the owner's state is put back as it was (params, updater and net state,
tables, the iteration, the generators).

1. **No host round-trip.** The probe step reads nothing back to the host:
   no ``.item()``, ``.tolist()``, ``.numpy()``, ``.cpu()``,
   ``.to("cpu")``, ``float()``/``int()``/``bool()`` of a tensor (seen by
   a ``TorchFunctionMode``), and on the card no synchronising CUDA call
   (``torch.cuda.set_sync_debug_mode``). On the card each captured step
   replays as a graph: captured once, replayed, and never run eagerly
   except for its warm-up and the runs an ``eager_steps()`` block asked
   for (no eager fallback).
2. **In place.** Every tensor of the program's static state (params,
   updater state and net state of a network; the tables, cursor and
   scalars of a skip-gram chunk) keeps its storage
   (``untyped_storage().data_ptr()``) across the probe step and across
   the chunk: a replayed graph writes the addresses it captured, so a
   step that rebinds a state tensor trains a copy nobody reads. The
   counterpart of the reference's donation check. A mesh program holds
   no static state (its steps are eager and rebind fresh tensors by
   design, as the reference's FSDP programs are exempt from donation)
   and is exempt.
3. **Collectives on declared axes.** Every collective the probe step
   issues through ``parallel/collectives.py`` runs on the process group
   of a mesh axis the sharding registry declared (or, with no registry,
   an axis of the mesh); a one-device step issues none.
4. **Outputs match the program key.** A chunk of E epochs over N batches
   returns the ``[E, N]`` loss history, the ``[E, N]`` bool trip history
   iff the key's guard is on, the ``[E, N, 4]`` metrics history iff its
   stride is; a skip-gram chunk returns ``[E, N]`` and leaves tables of
   the shapes it found.

``check_network_contracts(net, cache)`` and
``check_embedding_contracts(w2v, cache)`` keep the reference's
signatures and results (``{program key: [violations]}``, the network
keys being ``(shuffle, accum_steps, guard, metrics_stride)``); an empty
program cache raises ``ValueError``: a vacuous pass must never look like
a checked one.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "ContractViolation",
    "HOST_READ_FUNCTIONS",
    "host_readbacks",
    "collective_axes",
    "check_network_contracts",
    "check_embedding_contracts",
]


class ContractViolation(AssertionError):
    """One or more fused-program contract checks failed."""

    def __init__(self, violations: Sequence[str]):
        self.violations = list(violations)
        super().__init__(
            "fused-program contract violated:\n  - "
            + "\n  - ".join(self.violations))


#: tensor methods that read device data back to the host
HOST_READ_FUNCTIONS = frozenset({
    "item", "tolist", "numpy", "cpu", "__float__", "__int__", "__bool__",
})


# ---------------------------------------------------------------------------
# the probes
# ---------------------------------------------------------------------------


def _host_read_mode():
    """A ``TorchFunctionMode`` that records the host readbacks of the code
    it wraps (torch's own Python code inside a call is not seen: the mode
    is off while a torch function runs)."""
    from torch.overrides import TorchFunctionMode

    class HostReads(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.seen: List[str] = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = getattr(func, "__name__", "")
            if name in HOST_READ_FUNCTIONS:
                self.seen.append(name)
            elif name == "to" and _to_cpu(args[1:], kwargs):
                self.seen.append("to('cpu')")
            return func(*args, **kwargs)

    return HostReads()


def _to_cpu(args, kwargs) -> bool:
    import torch

    targets = list(args[:1]) + [kwargs.get("device")]
    return any((isinstance(t, str) and t.split(":")[0] == "cpu")
               or (isinstance(t, torch.device) and t.type == "cpu")
               for t in targets)


def host_readbacks(fn, device=None) -> List[str]:
    """Run ``fn()`` and return the host readbacks it made: the tensor
    methods of :data:`HOST_READ_FUNCTIONS`, and on a CUDA ``device`` every
    synchronising CUDA call torch warns about."""
    import torch

    mode = _host_read_mode()
    cuda = device is not None and torch.device(device).type == "cuda"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with mode:
                fn()
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode("default")
    syncs = [f"synchronising CUDA call ({str(w.message)[:80]})"
             for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    return mode.seen + syncs


def _mesh_axes(mesh) -> List[Tuple[str, Any]]:
    """``(axis name, its process group)`` of every axis of ``mesh`` whose
    size is over 1."""
    from deeplearning4j_tpu_torch.parallel.mesh import axis_group

    if mesh is None:
        return []
    return [(ax, axis_group(mesh, ax)) for ax in mesh.mesh_dim_names
            if axis_group(mesh, ax) is not None]


def _group_ranks(group) -> Tuple[int, ...]:
    import torch.distributed as dist

    if group is None:
        return tuple(range(dist.get_world_size()))
    return tuple(dist.get_process_group_ranks(group))


def collective_axes(calls, mesh) -> Dict[str, List[str]]:
    """axis name -> sorted collective ops the recorded ``calls`` (``(op,
    group)`` pairs of ``collectives.record_collectives``) ran over it; a
    group that is no axis of ``mesh`` files under ``<unnamed>``."""
    axes = _mesh_axes(mesh)
    out: Dict[str, set] = {}
    for op, group in calls:
        name = next((ax for ax, g in axes if g is group), None)
        if name is None:
            ranks = _group_ranks(group)
            name = next((ax for ax, g in axes
                         if _group_ranks(g) == ranks), "<unnamed>")
        out.setdefault(name, set()).add(op)
    return {ax: sorted(ops) for ax, ops in out.items()}


def _undeclared(calls, mesh, allowed: Sequence[str]) -> List[str]:
    allowed = set(allowed)
    return [f"collective(s) {ops} over undeclared mesh axis '{ax}' "
            f"(declared: {sorted(allowed) or 'none'})"
            for ax, ops in sorted(collective_axes(calls, mesh).items())
            if ax not in allowed]


def _ptrs(tensors) -> List[int]:
    return [t.untyped_storage().data_ptr() for t in tensors]


def _moved(before: List[int], tensors, what: str) -> List[str]:
    after = _ptrs(tensors)
    if len(after) != len(before):
        return [f"the static state changed from {len(before)} to "
                f"{len(after)} tensors across {what}"]
    moved = [i for i, (a, b) in enumerate(zip(before, after)) if a != b]
    if not moved:
        return []
    return [f"{len(moved)}/{len(before)} static state tensor(s) lost their "
            f"storage across {what} (indices {moved[:8]}"
            f"{'...' if len(moved) > 8 else ''}) — the step wrote a copy, "
            "not the state a replay reads"]


def _probe(step, state, device, generators) -> Tuple[List[str], list, list]:
    """Run ``step()`` once eagerly: ``(host readbacks, collectives,
    in-place violations)``; the generators are put back afterwards."""
    from deeplearning4j_tpu_torch.parallel.collectives import (
        record_collectives)
    from deeplearning4j_tpu_torch.perf.step_graph import eager_steps

    saved = [g.get_state() for g in generators]
    before = _ptrs(state())
    with record_collectives() as calls, eager_steps():
        reads = host_readbacks(step, device)
    moved = _moved(before, state(), "the probe step")
    for g, st in zip(generators, saved):
        g.set_state(st)
    return reads, calls, moved


def _graph_accounting(graph) -> List[str]:
    """Contract 1 on the card: the step replays as a graph, and nothing
    ran it eagerly but its warm-up and requested eager blocks."""
    if graph is None or not graph.graphed:
        return []
    out = []
    fallbacks = graph.eager_calls - graph.requested_eager - int(graph.warmed)
    if fallbacks > 0:
        out.append(f"the step ran eagerly {fallbacks} time(s) beyond its "
                   "warm-up: an eager fallback on the card")
    if graph.captures > 1:
        out.append(f"the step was captured {graph.captures} times")
    if graph.warmed and not graph.replays:
        out.append("the step never replayed as a graph")
    return out


def _shape_violations(got, want, what: str) -> List[str]:
    if got is None:
        return [f"{what} missing, contract says {want}"]
    if tuple(got.shape) != tuple(want):
        return [f"{what} shape {tuple(got.shape)} != {tuple(want)}"]
    return []


def _output_violations(outs, epochs: int, n: int, guard: bool,
                       stride: int) -> List[str]:
    import torch

    if not isinstance(outs, tuple) or len(outs) != 3:
        return ["program returns "
                f"{len(outs) if isinstance(outs, tuple) else type(outs).__name__}"
                " outputs, contract says (history, trips, metrics)"]
    hist, trips, mets = outs
    v = _shape_violations(hist, (epochs, n), "loss history")
    if guard:
        v += _shape_violations(trips, (epochs, n), "sentinel trip history")
        if trips is not None and trips.dtype != torch.bool:
            v.append(f"sentinel trip history dtype {trips.dtype} != bool")
    elif trips is not None:
        v.append("the program returns a trip history, contract says "
                 f"none (guard={guard})")
    if stride:
        v += _shape_violations(mets, (epochs, n, 4), "metrics history")
    elif mets is not None:
        v.append("the program returns a metrics history, contract says "
                 f"none (metrics_stride={stride})")
    return v


# ---------------------------------------------------------------------------
# networks and ParallelWrapper
# ---------------------------------------------------------------------------


def _allowed_axes(owner, network, cache, registry, allowed_axes, mesh):
    if allowed_axes is not None:
        return tuple(allowed_axes)
    if registry is None:
        registry = (getattr(owner, "_registry", None)
                    or getattr(network, "_sharding_registry", None))
    if registry is not None:
        return tuple(sorted(registry.declared_axes))
    return tuple(mesh.mesh_dim_names) if mesh is not None else ()


def _static_leaves(st) -> list:
    from deeplearning4j_tpu_torch.dtypes import tree_leaves

    return [t for t in (tree_leaves(st.params) + tree_leaves(st.updater_state)
                        + tree_leaves(st.net_state) + [st.it, st.lr])
            if t is not None]


@contextlib.contextmanager
def _network_restored(net):
    """Put the network's trainable state, counters and generator back as
    they were (a chunk stores fresh tensors on it; the saved ones are
    never written)."""
    saved = (net.params, net.updater_state, net.net_state,
             net.iteration_count, net._train_dispatches,
             getattr(net, "_score", None), net._lr_scale_host,
             net._rng.get_state(), net._last_sentinel, net._last_metrics)
    try:
        yield
    finally:
        (net.params, net.updater_state, net.net_state,
         net.iteration_count, net._train_dispatches, net._score,
         net._lr_scale_host, rng, net._last_sentinel,
         net._last_metrics) = saved
        net._rng.set_state(rng)


def _check_network_program(net, prog, key, cache, epochs, mesh, allowed,
                           expect_in_place) -> List[str]:
    """The four checks on one captured (or eager TP) epoch program of a
    network, keyed ``(shuffle, accum, guard, stride)``."""
    _, _, guard, stride = key
    st = net._static
    v: List[str] = []
    width = 1 + int(guard) + (4 if stride else 0)
    if tuple(prog.row.shape) != (cache.n_batches, width):
        v.append(f"history row shape {tuple(prog.row.shape)} != "
                 f"({cache.n_batches}, {width}): the program's outputs do "
                 f"not match its key (guard={guard}, metrics_stride="
                 f"{stride})")
    with _network_restored(net):
        prog.stacks = cache.batch_stacks()
        try:
            st.load(net)
            reads, calls, moved = _probe(
                prog.graph.fn, lambda: _static_leaves(st), net.device,
                [net._rng])
            if reads:
                v.append(f"host readback(s) {sorted(set(reads))} inside the "
                         "step — each step would round-trip to the host")
            v += _undeclared(calls, mesh, allowed)
            if expect_in_place:
                v += moved
            before = _ptrs(_static_leaves(st))
            try:
                outs = prog.launch(epochs)
            except Exception as exc:  # a failed capture is a finding
                v.append(f"the chunk failed: {type(exc).__name__}: {exc}")
            else:
                if expect_in_place:
                    v += _moved(before, _static_leaves(st), "the chunk")
                v += _output_violations(outs, epochs, cache.n_batches,
                                        bool(guard), int(stride))
            v += _graph_accounting(prog.graph)
        finally:
            prog.stacks = None
    return v


def _check_mesh_program(wrapper, prog, key, epochs, mesh, allowed
                        ) -> List[str]:
    """The checks on one ``ParallelWrapper`` epoch program (eager steps
    with collectives: exempt from check 2, see the module)."""
    _, _, guard, stride = key
    net = wrapper.network
    v: List[str] = []
    with _network_restored(net):
        plans = list(wrapper._epoch_plans)
        reads, calls, _ = _probe(
            lambda: prog.step(0, net.iteration_count), lambda: [],
            net.device, [net._rng])
        if reads:
            v.append(f"host readback(s) {sorted(set(reads))} inside the "
                     "step — each step would round-trip to the host")
        v += _undeclared(calls, mesh, allowed)
        try:
            outs = prog.launch(epochs)
        except Exception as exc:
            v.append(f"the chunk failed: {type(exc).__name__}: {exc}")
        else:
            v += _output_violations(outs, epochs, prog.cache.n_batches,
                                    bool(guard), int(stride))
        wrapper._epoch_plans[:] = plans
    return v


def _network_programs(net) -> Dict[Tuple, Any]:
    """``{(shuffle, accum, guard, stride): program}`` of the epoch
    programs a network or a ``ParallelWrapper`` keeps."""
    programs = getattr(net, "_programs", None) or {}
    out = {}
    for key, prog in programs.items():
        if isinstance(key, tuple) and len(key) == 6 and key[0] == "fit_epochs":
            out[tuple(key[2:])] = prog
        elif isinstance(key, tuple) and len(key) == 4:
            out[key] = prog
    return out


def check_network_contracts(net, cache, *, epochs: int = 2,
                            allowed_axes: Optional[Sequence[str]] = None,
                            expect_donation: bool = True,
                            raise_on_violation: bool = True,
                            require_programs: bool = True,
                            registry=None
                            ) -> Dict[Tuple, List[str]]:
    """Contract-check EVERY cached epoch program of ``net`` (a network or
    a ``ParallelWrapper``: the wrapper's mesh programs, or its network's
    when it ran meshless) built over ``cache``'s geometry. Returns
    {(shuffle, accum, guard, stride): violations}; raises
    :class:`ContractViolation` listing every violation unless
    ``raise_on_violation=False``. No such program raises
    :class:`ValueError` unless ``require_programs=False``.
    ``expect_donation`` (the reference's name) turns check 2 on.

    The declared-axes set of check 3 resolves, in order: explicit
    ``allowed_axes=``; ``registry=`` (a ``ShardingRegistry``); the
    registry the wrapper or the network placed its state through
    (``_registry`` / ``_sharding_registry``): its ``declared_axes``;
    finally every axis of the wrapper's, the cache's or the network's
    tensor-parallel mesh."""
    from deeplearning4j_tpu_torch.perf.step_graph import tree_signature

    network = getattr(net, "network", net)
    mesh_programs = net is not network and _network_programs(net)
    programs = mesh_programs or _network_programs(network)
    sig = tree_signature(cache.batch_stacks())
    if not mesh_programs:
        raw = getattr(network, "_programs", {})
        programs = {k: p for k, p in programs.items()
                    if ("fit_epochs", sig) + k in raw}
    if not programs and require_programs:
        raise ValueError(
            "no cached fused programs on %r for this cache's geometry "
            "(_programs is empty or missing) — run fit_epochs first, or "
            "pass require_programs=False to accept an empty check"
            % type(net).__name__)
    mesh = (getattr(net, "mesh", None) or getattr(cache, "mesh", None)
            or getattr(network, "_tp_mesh", None))
    allowed = _allowed_axes(net, network, cache, registry, allowed_axes,
                            mesh)
    results: Dict[Tuple, List[str]] = {}
    for key, prog in sorted(programs.items(), key=repr):
        if mesh_programs:
            v = _check_mesh_program(net, prog, key, epochs, mesh, allowed)
        else:
            v = _check_network_program(network, prog, key, cache, epochs,
                                       mesh, allowed, expect_donation)
        results[key] = [f"program {key}: {x}" for x in v]
    flat = [x for vs in results.values() for x in vs]
    if flat and raise_on_violation:
        raise ContractViolation(flat)
    return results


# ---------------------------------------------------------------------------
# Word2Vec
# ---------------------------------------------------------------------------


def _chunk_state(prog) -> list:
    return [prog.syn0, prog.syn1neg, prog.it, prog.lr0, prog.min_lr,
            prog.planned, prog.cursor, prog.row, *prog.plan]


def _mesh_chunk_step(prog, w2v, cache):
    """One step of a mesh skip-gram chunk on copies of ``w2v``'s tables,
    batch 0 of epoch 0's plan."""
    import torch

    from deeplearning4j_tpu_torch.nlp.epoch_kernels import (
        epoch_generator, epoch_keys_for)

    plan = cache.plan(epoch_generator(epoch_keys_for(w2v.seed, 0, 1)[0],
                                      cache.device))
    lr = torch.full((), float(w2v.learning_rate), dtype=torch.float32,
                    device=cache.device)
    prog._step(w2v.syn0.clone(), w2v.syn1neg.clone(),
               tuple(a[0] for a in plan), lr)


def check_embedding_contracts(w2v, cache, *, epochs: int = 2,
                              allowed_axes: Optional[Sequence[str]] = None,
                              raise_on_violation: bool = True
                              ) -> Dict[Tuple, List[str]]:
    """Contract-check every cached fused skip-gram program of a
    ``Word2Vec``/``DistributedWord2Vec`` (``_epoch_steps``, filled by
    ``fit_epochs``): no host readback in the step, the chunk's tables and
    scalars written in place (one-device chunks), collectives only over
    axes the table registry declared (or the cache mesh's axes; none at
    all on one device), and a chunk returning ``[E, N]`` and leaving
    tables of their shapes. Empty ``_epoch_steps`` raises ValueError."""
    from deeplearning4j_tpu_torch.nlp.epoch_kernels import (
        SkipGramChunk, epoch_keys_for)

    programs = getattr(w2v, "_epoch_steps", None) or {}
    if not programs:
        raise ValueError(
            "no cached fused skip-gram programs on %r (_epoch_steps is "
            "empty) — run fit_epochs first" % type(w2v).__name__)
    mesh = getattr(cache, "mesh", None)
    if allowed_axes is None:
        registry = getattr(w2v, "_sharding_registry", None)
        if registry is not None:
            allowed_axes = tuple(sorted(registry.declared_axes))
        elif mesh is not None:
            allowed_axes = tuple(mesh.mesh_dim_names)
        else:
            allowed_axes = ()
    results: Dict[Tuple, List[str]] = {}
    for key, prog in sorted(programs.items(), key=repr):
        v: List[str] = []
        single = isinstance(prog, SkipGramChunk)
        tables = (w2v.syn0, w2v.syn1neg)
        shapes = [tuple(t.shape) for t in tables]
        if single:
            reads, calls, moved = _probe(prog.graph.fn,
                                         lambda: _chunk_state(prog),
                                         w2v.device, [])
        else:
            reads, calls, moved = _probe(
                lambda: _mesh_chunk_step(prog, w2v, cache), lambda: [],
                w2v.device, [])
        if reads:
            v.append(f"host readback(s) {sorted(set(reads))} inside the "
                     "skip-gram step")
        v += _undeclared(calls, mesh, allowed_axes)
        v += moved
        saved = [t.clone() for t in tables] if not single else None
        before = _ptrs(_chunk_state(prog)) if single else None
        try:
            out = prog.launch(w2v, cache,
                              epoch_keys_for(w2v.seed, 0, epochs), None)
        except Exception as exc:
            v.append(f"the chunk failed: {type(exc).__name__}: {exc}")
        else:
            if single:
                v += _moved(before, _chunk_state(prog), "the chunk")
                v += _graph_accounting(prog.graph)
            v += _shape_violations(out, (epochs, cache.n_batches),
                                   "loss history")
            got = [tuple(t.shape) for t in (w2v.syn0, w2v.syn1neg)]
            if got != shapes:
                v.append(f"the chunk left tables of shapes {got}, not "
                         f"{shapes}")
        # put the tables back as they were
        if single:
            w2v.syn0, w2v.syn1neg = tables
        else:
            for t, s in zip((w2v.syn0, w2v.syn1neg), saved):
                t.copy_(s)
        results[key] = [f"program {key}: {x}" for x in v]
    flat = [x for vs in results.values() for x in vs]
    if flat and raise_on_violation:
        raise ContractViolation(flat)
    return results
