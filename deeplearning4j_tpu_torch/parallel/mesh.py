"""Mesh construction helpers, on ``torch.distributed``.

Port of ``deeplearning4j_tpu/parallel/mesh.py``. The reference builds a
``jax.sharding.Mesh`` over the devices of one controller; the port runs
torch's SPMD model instead: one process per rank, the same program in
each, a :class:`torch.distributed.device_mesh.DeviceMesh` over the
world, and a process group per mesh axis. Each rank holds its own part
of a sharded tensor (the reference's global arrays do not exist here);
:mod:`.sharding_registry` says which part.

Axis-name conventions used across the framework (the scaling-book
vocabulary):

- ``data``     — batch (data parallel; gradient all-reduce)
- ``model``    — tensor parallel (sharded GEMMs)
- ``sequence`` — context parallel (ring attention)
- ``pipe``     — pipeline stages
- ``expert``   — expert parallel (MoE)

:func:`join_world` is the port's way in: a ``FileStore`` at a path, the
rank and the world size, and a hard timeout. It opens no TCP port, so
worlds on one host (test workers, four ranks sharing one card) cannot
collide. :func:`build_mesh` joins a world of one that way when no world
is up, so a one-device mesh needs no launcher and runs exactly the
meshless program.

A mesh may span some of the world's ranks (``build_mesh(ranks=)``, the
reference's ``devices=``): every rank of the world builds it, since the
process groups are made by world-wide collectives, and a rank outside it
gets a mesh whose ``get_coordinate()`` is ``None`` (:func:`in_mesh`).
Such a rank stays in the world, *parked*: it takes no part in the mesh's
collectives and can be brought back by a later mesh over it. The
mesh's first rank is its *lead* (:func:`mesh_lead`).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch._device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQUENCE_AXIS = "sequence"
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"

#: seconds a collective may wait before the world gives up on it
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape; -1 means 'all remaining devices'."""

    data: int = -1
    model: int = 1
    sequence: int = 1
    pipe: int = 1
    expert: int = 1

    def resolve(self, n_devices: int) -> Tuple[Tuple[str, int], ...]:
        fixed = {
            MODEL_AXIS: self.model,
            SEQUENCE_AXIS: self.sequence,
            PIPE_AXIS: self.pipe,
            EXPERT_AXIS: self.expert,
        }
        known = 1
        for v in fixed.values():
            known *= v
        data = self.data
        if data == -1:
            if n_devices % known:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {known}")
            data = n_devices // known
        total = data * known
        if total != n_devices:
            raise ValueError(
                f"mesh {data}x{known} != device count {n_devices}")
        axes = [(DATA_AXIS, data)]
        for name, size in fixed.items():
            if size > 1:
                axes.append((name, size))
        return tuple(axes)


def join_world(store_path: str, rank: int, world_size: int, *,
               backend: Optional[str] = None, device: DeviceLike = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the world of ``world_size`` ranks that meet at the
    ``FileStore`` ``store_path`` (a file every rank can reach; it must
    not exist before the world's first join). ``backend`` defaults to
    NCCL for a CUDA device and gloo for the CPU; gloo also carries CUDA
    tensors, which is how several ranks share one card. A collective
    that waits longer than ``timeout_s`` raises instead of hanging."""
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world_size), rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))


def leave_world() -> None:
    """Destroy the default process group (and the mesh groups with it)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _ensure_world(device: torch.device) -> None:
    """A world of one, joined through a fresh FileStore, when none is up."""
    if dist.is_initialized():
        return
    fd, path = tempfile.mkstemp(prefix="dl4j_world_")
    os.close(fd)
    os.unlink(path)  # the store creates it
    join_world(path, 0, 1, device=device)


def local_device_count(device: DeviceLike = None) -> int:
    """Devices of the default device's type this process can see."""
    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def build_mesh(spec: Optional[MeshSpec] = None, *,
               device: DeviceLike = None,
               ranks: Optional[Sequence[int]] = None):
    """A ``DeviceMesh`` over the current world (joining a world of one
    when none is up), on the type of ``device`` (default: the card).

    ``ranks`` (default: every rank of the world) lists the world ranks
    the mesh spans, in ascending order; ``spec.resolve(len(ranks))``
    sizes its axes. Every rank of the world calls it, inside the mesh or
    not (the groups are made by world-wide collectives); a rank outside
    gets a mesh whose ``get_coordinate()`` is ``None``. A rank that is
    not a rank of the world, a repeated or unordered list (a process
    group orders its members by rank, so the axes' coordinates would not
    be the list's order) raise ``ValueError``, before any collective.

    Axes of size 1 are dropped, as in the reference, except ``data``,
    which is always there: a pure-DP mesh is 1-D ("data",), a mesh of one
    device is ("data",) of size 1, and every step over it is the
    meshless step. Ranks are laid out in row-major order over the axes,
    so the innermost axis holds neighbouring ranks."""
    spec = spec or MeshSpec()
    dev = resolve_device(device)
    if ranks is not None:
        ranks = [int(r) for r in ranks]
        check_ranks(ranks)
        axes = spec.resolve(len(ranks))
    _ensure_world(dev)
    if ranks is None or ranks == list(range(dist.get_world_size())):
        from torch.distributed.device_mesh import init_device_mesh

        axes = spec.resolve(dist.get_world_size())
        return init_device_mesh(dev.type, tuple(s for _, s in axes),
                                mesh_dim_names=tuple(n for n, _ in axes))
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh(dev.type, torch.tensor(ranks).reshape(
        tuple(s for _, s in axes)), mesh_dim_names=tuple(n for n, _ in axes))
    # the group of every member, made by every rank of the world: the
    # lead's broadcasts to its mesh run over it
    mesh._dl4j_members = dist.new_group(ranks)
    return mesh


def check_ranks(ranks: Sequence[int]) -> None:
    """``ValueError`` unless ``ranks`` are distinct ranks of the current
    world (of one when none is up), in ascending order."""
    world = world_size()
    ranks = list(ranks)
    if not ranks:
        raise ValueError("a mesh needs at least one rank")
    if world == 1 and len(ranks) > 1:
        raise ValueError(
            f"a world of one cannot span {len(ranks)} devices: each rank "
            "is one process, so a run grows only onto ranks its world "
            "already has; start it in a world of that many ranks")
    outside = [r for r in ranks if not 0 <= r < world]
    if outside:
        raise ValueError(f"ranks {outside} are not ranks of the world of "
                         f"{world}")
    if any(b <= a for a, b in zip(ranks, ranks[1:])):
        raise ValueError(f"list a mesh's ranks once each, in ascending "
                         f"order (got {ranks})")


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}``, the reference's ``mesh.shape``."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, axis: str) -> int:
    """Size of ``axis`` (1 when mesh is None or the axis was dropped)."""
    return int(mesh_shape(mesh).get(axis, 1))


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 when it was dropped)."""
    if axis_size(mesh, axis) == 1:
        return 0
    return int(mesh.get_local_rank(axis))


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``; ``None``
    when the axis has size 1 (nothing to communicate)."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


def mesh_devices(mesh) -> int:
    """The devices (ranks) ``mesh`` spans: the product of its axes; 1 for
    None."""
    n = 1
    for size in mesh_shape(mesh).values():
        n *= int(size)
    return n


def world_size() -> int:
    """Ranks in the current world (1 when no world is up)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def mesh_ranks(mesh) -> List[int]:
    """The world ranks ``mesh`` spans, row-major over its axes; every
    rank of the world for None (each runs whole batches)."""
    if mesh is None:
        return list(range(world_size()))
    ranks = getattr(mesh, "mesh", None)
    if ranks is None:  # a mesh that names no ranks: the world's first
        return list(range(mesh_devices(mesh)))
    return [int(r) for r in ranks.flatten().tolist()]


def mesh_lead(mesh) -> int:
    """The mesh's first rank: the one that draws its plans and holds the
    network's generator."""
    return mesh_ranks(mesh)[0]


def in_mesh(mesh) -> bool:
    """Whether this rank is a member of ``mesh`` (always, for None)."""
    if mesh is None or not hasattr(mesh, "get_coordinate"):
        return True
    return mesh.get_coordinate() is not None


def mesh_group(mesh):
    """The process group of every member of ``mesh``: the world's (None)
    for a mesh over the whole world or None."""
    return getattr(mesh, "_dl4j_members", None)


def check_mesh_in_world(mesh) -> None:
    """A reshard target must span ranks of the current world (or be
    None: whole batches in every rank): ``ValueError`` otherwise. A world
    of one cannot grow onto more devices."""
    if mesh is not None:
        check_ranks(mesh_ranks(mesh))


def data_axis_size(mesh) -> int:
    """Size of the ``data`` axis of ``mesh`` (1 when mesh is None or the
    axis was dropped) — the data-parallel shard count a batch splits
    into."""
    return axis_size(mesh, DATA_AXIS)


def replicated(mesh):
    """DTensor placements of a replicated leaf: ``Replicate()`` on every
    mesh axis."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in mesh.shape)


def batch_sharding(mesh, ndim: int = 2, axis: str = DATA_AXIS):
    """Placements of a batch: axis 0 sharded over ``axis``, the rest
    replicated."""
    from deeplearning4j_tpu_torch.parallel.sharding_registry import (
        batch_spec, named)

    return named(mesh, batch_spec(ndim, axis=axis)).placements


def shard_leading_axis(tree, mesh, axis_name: str):
    """This rank's part of every leaf with its leading dim sharded over
    ``axis_name`` (the whole leaf when the axis was dropped)."""
    from deeplearning4j_tpu_torch.dtypes import tree_map

    n = axis_size(mesh, axis_name)
    r = axis_rank(mesh, axis_name)
    return tree_map(lambda x: x if n == 1 else local_chunk(x, 0, n, r),
                    tree)


def local_chunk(x: torch.Tensor, dim: int, n: int, r: int) -> torch.Tensor:
    """Chunk ``r`` of ``n`` equal chunks of ``x`` along ``dim`` (a
    contiguous copy, so it owns its storage)."""
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of size {size} does not split into "
                         f"{n} equal shards")
    step = size // n
    return x.narrow(dim, r * step, step).contiguous()
