"""One mesh for everything: the sharding-spec registry, on torch.

Port of ``deeplearning4j_tpu/parallel/sharding_registry.py``. One named
mesh (``parallel/mesh.py``) and one per-model registry mapping every
parameter, updater-state and batch leaf to a :class:`PartitionSpec`: a
tuple naming, for each tensor dim, the mesh axis (or axes) it is split
over, or ``None``. A spec's DTensor form is :func:`named`'s
``placements`` (``Shard(dim)`` / ``Replicate()`` per mesh axis). Under
torch's SPMD model a rank holds only its part of a sharded leaf:
:meth:`ShardingRegistry.place` cuts that part out of the whole leaf
(every rank holds the whole tree before placement, as every process of
the reference's program sees the global arrays), and
:meth:`ShardingRegistry.gather` puts the whole leaf back together.

Registry contract (the "no silent replication" rule): every leaf of the
model's param tree MUST be covered by an explicit spec — ``P()``
(replicate, on purpose) or a sharded spec. An unmapped leaf raises
:class:`UnmappedLeafError` at registry construction instead of silently
falling back to replicated.

Placement covers every axis: ``data`` (replicated leaves, batches,
FSDP shards), ``model`` (the Megatron column/row splits that
``TransformerLM.shard_params`` and ``tensor_parallel
.shard_network_params`` step over, the serving K/V pool's head split,
row-sharded embedding tables) and ``pipe`` (stacked stage params), and
the layouts the fused epoch over a mesh keeps across chunks
(``epoch_out_shardings``).

Env knobs (resolved by :func:`mesh_from_env`):

- ``DL4J_MESH_SHAPE`` — ``"8x1"`` / ``"4x2"`` / ``"2x2x2"`` as
  data×model[×pipe]; the full-topology override.
- ``DL4J_TP_SHARDS`` — just the ``model`` axis size; ``data`` takes the
  remaining devices (``MeshSpec(data=-1, model=N)``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Dict, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.dtypes import tree_leaves
from deeplearning4j_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    MeshSpec,
    axis_group,
    axis_rank,
    axis_size,
    build_mesh,
    local_chunk,
    mesh_shape,
)

logger = logging.getLogger(__name__)

__all__ = [
    "PartitionSpec",
    "P",
    "NamedSharding",
    "UnmappedLeafError",
    "ShardingRegistry",
    "named",
    "replicated_sharding",
    "batch_spec",
    "batch_sharding",
    "stage_spec",
    "model_axis_size",
    "pipe_axis_size",
    "parse_mesh_shape",
    "mesh_from_env",
]


class PartitionSpec(tuple):
    """Per-dim mesh axes of a leaf: ``P(None, "model")`` splits dim 1
    over ``model``; ``P()`` replicates. Trailing dims left out are
    replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


class UnmappedLeafError(KeyError):
    """A param/updater leaf has no PartitionSpec in the registry — the
    registry refuses to guess (silent replication is a memory
    regression, silent sharding a numerics one)."""


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the reference's ``NamedSharding``. Its
    ``placements`` are the DTensor form; :meth:`local` and
    :meth:`gather` move a leaf between whole and this rank's part."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self):
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for name in self.mesh.mesh_dim_names:
            dims = [i for i, e in enumerate(self.spec)
                    if name in _entry_axes(e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def _split(self, dim: int) -> Tuple[int, int]:
        """(parts, this rank's index) of ``dim``: row-major over the
        entry's axes; (1, 0) when every axis was dropped."""
        n, r = 1, 0
        for ax in _entry_axes(self.spec[dim]):
            size = axis_size(self.mesh, ax)
            n, r = n * size, r * size + axis_rank(self.mesh, ax)
        return n, r

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole leaf ``x``."""
        for dim in range(len(self.spec)):
            n, r = self._split(dim)
            if n > 1:
                x = local_chunk(x, dim, n, r)
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's part ``x``."""
        from deeplearning4j_tpu_torch.parallel.collectives import all_gather

        for dim in reversed(range(len(self.spec))):
            for ax in reversed(_entry_axes(self.spec[dim])):
                group = axis_group(self.mesh, ax)
                if group is not None:
                    x = all_gather(x, group, dim)
        return x

    @property
    def is_replicated(self) -> bool:
        return all(self._split(d)[0] == 1 for d in range(len(self.spec)))


# ---------------------------------------------------------------------------
# sanctioned sharding builders
# ---------------------------------------------------------------------------
def named(mesh, spec: PartitionSpec) -> NamedSharding:
    """THE sharding constructor: a spec on ``mesh``."""
    return NamedSharding(mesh, P(*spec))


def replicated_sharding(mesh) -> NamedSharding:
    """Fully-replicated placement on ``mesh``."""
    return named(mesh, P())


def batch_spec(ndim: int, *, stacked: bool = False,
               axis: str = DATA_AXIS) -> PartitionSpec:
    """The activation/batch spec: batch dim over ``data``, everything
    else replicated. ``stacked=True`` is the epoch cache's ``[N, B,
    ...]`` layout (the BATCH dim is axis 1)."""
    if stacked:
        return P(None, axis, *([None] * max(0, ndim - 2)))
    return P(axis, *([None] * max(0, ndim - 1)))


def batch_sharding(mesh, ndim: int, *, stacked: bool = False,
                   axis: str = DATA_AXIS) -> NamedSharding:
    return named(mesh, batch_spec(ndim, stacked=stacked, axis=axis))


def stage_spec(ndim: int, *, axis: str = PIPE_AXIS) -> PartitionSpec:
    """Stacked pipeline-stage params ``[S, ...]``: leading stage axis
    over ``pipe``."""
    return P(axis, *([None] * max(0, ndim - 1)))


def model_axis_size(mesh) -> int:
    """Size of the ``model`` (tensor-parallel) axis; 1 when absent."""
    return axis_size(mesh, MODEL_AXIS)


def pipe_axis_size(mesh) -> int:
    """Size of the ``pipe`` (pipeline) axis; 1 when absent."""
    return axis_size(mesh, PIPE_AXIS)


# ---------------------------------------------------------------------------
# env-driven mesh resolution
# ---------------------------------------------------------------------------
def parse_mesh_shape(text: str) -> MeshSpec:
    """``"8x1"`` / ``"4x2"`` / ``"2x2x2"`` → MeshSpec(data, model[, pipe]).
    One value means pure DP; a fourth value is rejected (the registry
    axes are data×model×pipe)."""
    parts = [p.strip() for p in str(text).lower().split("x") if p.strip()]
    if not 1 <= len(parts) <= 3:
        raise ValueError(
            f"DL4J_MESH_SHAPE={text!r} must be DPxTP or DPxTPxPP "
            "(e.g. '8x1', '4x2', '2x2x2')")
    try:
        dims = [int(p) for p in parts]
    except ValueError:
        raise ValueError(
            f"DL4J_MESH_SHAPE={text!r}: non-integer mesh dimension")
    if any(d < 1 for d in dims):
        raise ValueError(f"DL4J_MESH_SHAPE={text!r}: dims must be >= 1")
    dims += [1] * (3 - len(dims))
    return MeshSpec(data=dims[0], model=dims[1], pipe=dims[2])


def mesh_from_env(device=None, ranks=None):
    """Resolve ``DL4J_MESH_SHAPE`` (full topology, wins) then
    ``DL4J_TP_SHARDS`` (model axis only, data takes the rest) into a
    mesh over ``ranks`` of the current world (default: all of them);
    ``None`` when neither is set."""
    shape = os.environ.get("DL4J_MESH_SHAPE", "").strip()
    if shape:
        return build_mesh(parse_mesh_shape(shape), device=device,
                          ranks=ranks)
    tp = os.environ.get("DL4J_TP_SHARDS", "").strip()
    if tp:
        n = int(tp)
        if n < 1:
            raise ValueError(f"DL4J_TP_SHARDS={tp!r} must be >= 1")
        return build_mesh(MeshSpec(data=-1, model=n), device=device,
                          ranks=ranks)
    return None


# ---------------------------------------------------------------------------
# strict spec-tree expansion
# ---------------------------------------------------------------------------
def _expand(tree, spec, path: Tuple[Any, ...], name: str):
    """Expand a (possibly sentinel-bearing) spec tree against the model's
    actual param tree, leaf for leaf. Structure mismatches and missing
    keys raise :class:`UnmappedLeafError` naming the leaf path."""
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
        _ReplicateAll)

    if isinstance(spec, _ReplicateAll):
        if isinstance(tree, dict):
            return {k: _expand(v, spec, path + (k,), name)
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [_expand(v, spec, path + (i,), name)
                    for i, v in enumerate(tree)]
        return P()
    if isinstance(tree, dict):
        if not isinstance(spec, dict):
            raise UnmappedLeafError(
                f"registry[{name}]: param subtree at {path!r} is a dict "
                f"but its spec is {type(spec).__name__}")
        out = {}
        for k, v in tree.items():
            if k not in spec:
                raise UnmappedLeafError(
                    f"registry[{name}]: no PartitionSpec for param leaf "
                    f"{path + (k,)!r} — every leaf needs an explicit "
                    "spec (P() to replicate on purpose)")
            out[k] = _expand(v, spec[k], path + (k,), name)
        return out
    if isinstance(tree, (list, tuple)):
        if not isinstance(spec, (list, tuple)) or isinstance(
                spec, PartitionSpec) or len(spec) != len(tree):
            raise UnmappedLeafError(
                f"registry[{name}]: param list at {path!r} has "
                f"{len(tree)} entries but the spec does not match")
        return [_expand(v, s, path + (i,), name)
                for i, (v, s) in enumerate(zip(tree, spec))]
    if not isinstance(spec, PartitionSpec):
        raise UnmappedLeafError(
            f"registry[{name}]: spec for leaf {path!r} is "
            f"{type(spec).__name__}, expected PartitionSpec")
    return spec


def _replicate_all_tree(tree):
    """Explicit replicate-everything spec tree matching ``tree``."""
    if isinstance(tree, dict):
        return {k: _replicate_all_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_replicate_all_tree(v) for v in tree]
    return P()


def _divisible_or_replicated(tree, spec, mesh, name, path=()):
    """Demote specs whose sharded dimension does not tile the mesh axis
    to an explicit P() — LOUDLY (a warning naming the leaf), never
    silently."""
    if isinstance(tree, dict):
        return {k: _divisible_or_replicated(v, spec[k], mesh, name,
                                            path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_divisible_or_replicated(v, s, mesh, name, path + (i,))
                for i, (v, s) in enumerate(zip(tree, spec))]
    shape = getattr(tree, "shape", None)
    if shape is None or spec == P():
        return spec
    if len(spec) > len(shape):
        logger.warning(
            "registry[%s]: spec %s for leaf %r has more entries than its "
            "rank %d — replicating", name, spec, path, len(shape))
        return P()
    for i, entry in enumerate(spec):
        axes = _entry_axes(entry)
        n = 1
        for ax in axes:
            n *= axis_size(mesh, ax)
        if n > 1 and shape[i] % n:
            logger.warning(
                "registry[%s]: leaf %r dim %d (size %d) does not tile "
                "mesh axes %r (size %d) — replicating this leaf",
                name, path, i, shape[i], axes, n)
            return P()
    return spec


def _spec_leaves(spec_tree) -> List[PartitionSpec]:
    if isinstance(spec_tree, PartitionSpec):
        return [spec_tree]
    if isinstance(spec_tree, dict):
        return [s for v in spec_tree.values() for s in _spec_leaves(v)]
    if isinstance(spec_tree, (list, tuple)):
        return [s for v in spec_tree for s in _spec_leaves(v)]
    return [spec_tree]


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves replaced, in order."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return next(it)

    return walk(tree)


class ShardingRegistry:
    """Per-model mapping of every param/updater/batch leaf to a
    PartitionSpec on one named mesh.

    Construction goes through the classmethods — ``for_network`` (MLN and
    ComputationGraph, with ``tensor_parallel``'s Megatron layer rules
    when the mesh carries a ``model`` axis) and ``for_transformer``
    (``TransformerLM.param_specs``). Both expand the spec tree strictly
    against the model's live param tree: every leaf covered, unmapped
    leaves raise."""

    def __init__(self, mesh, spec_tree, *, name: str = "model"):
        self.mesh = mesh
        self.name = name
        self.spec_tree = spec_tree

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------
    @classmethod
    def for_network(cls, net, mesh) -> "ShardingRegistry":
        """Registry for a MultiLayerNetwork or ComputationGraph: TP layer
        specs over ``model`` when the mesh carries that axis (>1), else
        explicit replicate-all. Strict against ``net.params``."""
        net._ensure_init()
        name = type(net).__name__
        if model_axis_size(mesh) > 1:
            raw = _network_specs(net)
        else:
            raw = _replicate_all_tree(net.params)
        expanded = _expand(net.params, raw, (), name)
        return cls(mesh,
                   _divisible_or_replicated(net.params, expanded, mesh,
                                            name),
                   name=name)

    @classmethod
    def for_transformer(cls, lm, mesh, *,
                        shard_data_embed: bool = False
                        ) -> "ShardingRegistry":
        """Registry for a TransformerLM: the model's own Megatron
        ``param_specs`` over ``model`` when present, else replicate-all."""
        lm._ensure_init()
        if model_axis_size(mesh) > 1:
            raw = lm.param_specs(mesh=mesh,
                                 shard_data_embed=shard_data_embed)
        else:
            raw = _replicate_all_tree(lm.params)
        expanded = _expand(lm.params, raw, (), "TransformerLM")
        return cls(mesh,
                   _divisible_or_replicated(lm.params, expanded, mesh,
                                            "TransformerLM"),
                   name="TransformerLM")

    @classmethod
    def for_embedding_tables(cls, tables, mesh, *, row_shard: bool = False,
                             name: str = "Word2Vec"
                             ) -> "ShardingRegistry":
        """Registry for sparse embedding tables (word2vec's syn0/syn1neg,
        GloVe's w/wc): ``row_shard=True`` splits the vocab dim over
        ``model`` (``P("model", None)``), else replicate-all (the
        data-parallel layout). A vocab the axis does not tile is
        replicated, with a warning naming the table."""
        if row_shard and model_axis_size(mesh) > 1:
            raw = {k: P(MODEL_AXIS, None) for k in tables}
        else:
            raw = _replicate_all_tree(tables)
        expanded = _expand(tables, raw, (), name)
        return cls(mesh,
                   _divisible_or_replicated(tables, expanded, mesh, name),
                   name=name)

    # ------------------------------------------------------------------
    # lookup
    # ------------------------------------------------------------------
    def spec_for(self, *path) -> PartitionSpec:
        """Strict leaf lookup by path (e.g. ``spec_for("0", "W")``)."""
        node = self.spec_tree
        for i, key in enumerate(path):
            try:
                node = node[key]
            except (KeyError, IndexError, TypeError):
                raise UnmappedLeafError(
                    f"registry[{self.name}]: no PartitionSpec at "
                    f"{tuple(path[:i + 1])!r}")
        if not isinstance(node, PartitionSpec):
            raise UnmappedLeafError(
                f"registry[{self.name}]: {tuple(path)!r} names a subtree, "
                "not a leaf")
        return node

    def leaf_specs(self, tree) -> List[PartitionSpec]:
        """Specs aligned with ``dtypes.tree_leaves(tree)``; strict — a
        tree with leaves the registry does not cover raises."""
        expanded = _expand(tree, self.spec_tree, (), self.name)
        return _spec_leaves(expanded)

    def param_shardings(self, tree):
        """Tree of :class:`NamedSharding` matching ``tree``."""
        return _rebuild(tree, [named(self.mesh, s)
                               for s in self.leaf_specs(tree)])

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------
    def place(self, tree):
        """This rank's part of every param leaf under its spec."""
        sh = self.param_shardings(tree)
        return _rebuild(tree, [s.local(x) for x, s in
                               zip(tree_leaves(tree), tree_leaves_of(sh))])

    def gather(self, tree):
        """The whole params from every rank's parts (``place`` undone)."""
        sh = self.param_shardings(tree)
        return _rebuild(tree, [s.gather(x) for x, s in
                               zip(tree_leaves(tree), tree_leaves_of(sh))])

    def state_shardings(self, state_tree):
        """Shardings for an updater-state tree that NESTS (zero or one
        level of dict, e.g. adam ``{m, v}``) below the param leaves. A
        state leaf inherits its param's spec when the ranks agree;
        scalars, empties and rank-mismatched leaves replicate."""
        return self._walk_state(state_tree, self.spec_tree, ())

    def _walk_state(self, tree, spec, path):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                sub = spec[k] if isinstance(spec, dict) and k in spec else spec
                if isinstance(spec, dict) and k not in spec and isinstance(
                        v, (dict, list, tuple)):
                    raise UnmappedLeafError(
                        f"registry[{self.name}]: updater subtree at "
                        f"{path + (k,)!r} has no matching param spec")
                out[k] = self._walk_state(v, sub, path + (k,))
            return out
        if isinstance(tree, (list, tuple)) and not isinstance(
                tree, PartitionSpec):
            subs = (spec if isinstance(spec, (list, tuple))
                    and not isinstance(spec, PartitionSpec)
                    and len(spec) == len(tree) else [spec] * len(tree))
            return [self._walk_state(v, s, path + (i,))
                    for i, (v, s) in enumerate(zip(tree, subs))]
        nd = getattr(tree, "ndim", None)
        numel = tree.numel() if isinstance(tree, torch.Tensor) else None
        if (nd in (None, 0) or numel == 0
                or not isinstance(spec, PartitionSpec) or len(spec) != nd):
            return named(self.mesh, P())
        return named(self.mesh, spec)

    def place_state(self, state_tree):
        """This rank's part of an updater-state tree mirroring params."""
        sh = self.state_shardings(state_tree)
        return _rebuild(state_tree, [
            s.local(x) for x, s in zip(tree_leaves(state_tree),
                                       tree_leaves_of(sh))])

    def gather_state(self, state_tree):
        sh = self.state_shardings(state_tree)
        return _rebuild(state_tree, [
            s.gather(x) for x, s in zip(tree_leaves(state_tree),
                                        tree_leaves_of(sh))])

    def place_network(self, net) -> "ShardingRegistry":
        """Place a network's trainable state — params under the
        registered specs, updater state mirrored leaf for leaf, net state
        replicated — and stamp the registry on the network
        (``net._sharding_registry``)."""
        net.params = self.place(net.params)
        net.updater_state = self.place_state(net.updater_state)
        net._sharding_registry = self
        return self

    def with_fsdp(self, params) -> "ShardingRegistry":
        """Compose FSDP over ``data`` with the registered specs: leaves
        the registry replicates get their largest data-divisible dim
        sharded over ``data``; sharded leaves keep their spec."""
        from deeplearning4j_tpu_torch.parallel.fsdp import fsdp_spec

        composed = [
            fsdp_spec(tuple(x.shape), self.mesh) if s == P() else s
            for x, s in zip(tree_leaves(params), self.leaf_specs(params))
        ]
        return ShardingRegistry(self.mesh, _rebuild(params, composed),
                                name=self.name + "+fsdp")

    # ------------------------------------------------------------------
    # activations / datasets / programs
    # ------------------------------------------------------------------
    def batch_sharding(self, ndim: int, *,
                       stacked: bool = False) -> NamedSharding:
        """Activation/batch placement: batch dim over ``data``."""
        return batch_sharding(self.mesh, ndim, stacked=stacked)

    def epoch_out_shardings(self, params_tree, state_tree, *,
                            guard: bool = False, metrics_stride: int = 0):
        """The placement the fused epoch keeps across chunks: params and
        updater state under their registered specs (replicated,
        TP-sharded, FSDP-sharded or a composition), net state and the
        loss, trip and metrics histories replicated. The reference pins
        its program's ``out_shardings`` to this tuple; the port's mesh
        epoch places each step's result with :meth:`place` and
        :meth:`place_state`, so these are the layouts it keeps."""
        repl = replicated_sharding(self.mesh)
        out = (self.param_shardings(params_tree),
               self.state_shardings(state_tree), repl, repl)
        if guard:
            out = out + (repl,)
        if metrics_stride:
            out = out + (repl,)
        return out

    def kv_pool_spec(self, n_kv_heads: int) -> PartitionSpec:
        """Spec of a ``[L, S, T_max, Hkv, Dh]`` K/V pool: the heads split
        over ``model`` as the attention params split them, so each rank
        holds ``Hkv/model`` heads of every slot. Replicated, with a
        warning, when the kv heads do not tile the axis (the GQA
        fallback, where wk/wv replicate too)."""
        tp = model_axis_size(self.mesh)
        if tp > 1 and n_kv_heads % tp == 0:
            return P(None, None, None, MODEL_AXIS, None)
        if tp > 1:
            logger.warning(
                "KV pool TP fallback: %d kv heads do not tile the model "
                "axis (size %d) — pool stays replicated", n_kv_heads, tp)
        return P()

    def kv_scale_spec(self, n_kv_heads: int) -> PartitionSpec:
        """The int8 scales ``[L, S, Hkv]``: the pool's head split."""
        if self.kv_pool_spec(n_kv_heads) == P():
            return P()
        return P(None, None, MODEL_AXIS)

    # ------------------------------------------------------------------
    # contracts
    # ------------------------------------------------------------------
    @property
    def declared_axes(self) -> set:
        """Mesh axes this registry maps anything over — the only axes a
        collective in this model's steps may reduce or permute over.
        ``data`` is always declared; ``pipe`` when the mesh carries it."""
        axes = {DATA_AXIS}
        for s in _spec_leaves(self.spec_tree):
            for entry in s:
                axes.update(_entry_axes(entry))
        if pipe_axis_size(self.mesh) > 1:
            axes.add(PIPE_AXIS)
        return axes & set(self.mesh.mesh_dim_names) | {DATA_AXIS}

    def describe(self) -> Dict[str, Any]:
        """Artifact-ready summary."""
        leaves = _spec_leaves(self.spec_tree)
        return {
            "model": self.name,
            "mesh": {k: int(v) for k, v in mesh_shape(self.mesh).items()},
            "declared_axes": sorted(self.declared_axes),
            "leaves": len(leaves),
            "sharded_leaves": sum(1 for s in leaves if s != P()),
        }


def tree_leaves_of(sharding_tree) -> List[NamedSharding]:
    """The :class:`NamedSharding` leaves of a tree, in tree order."""
    if isinstance(sharding_tree, NamedSharding):
        return [sharding_tree]
    if isinstance(sharding_tree, dict):
        return [s for v in sharding_tree.values()
                for s in tree_leaves_of(v)]
    if isinstance(sharding_tree, (list, tuple)):
        return [s for v in sharding_tree for s in tree_leaves_of(v)]
    return [sharding_tree]


def _network_specs(net):
    """TP spec tree for either network class, via tensor_parallel's
    Megatron layer rules (MLN: indexed layers; graph: named layers in
    topological order)."""
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
        param_specs_for_layers,
        param_specs_for_network,
    )

    conf = net.conf
    layers = getattr(conf, "layers", None)
    if isinstance(layers, dict):  # ComputationGraph: {name: LayerConf}
        order = [n for n in conf.topological_order if n in layers]
        order += [n for n in layers if n not in order]
        return param_specs_for_layers([(n, layers[n]) for n in order])
    return param_specs_for_network(conf)
