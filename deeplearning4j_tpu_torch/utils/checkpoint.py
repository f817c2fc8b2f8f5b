"""Step-keyed training checkpoints in a directory.

Port of ``deeplearning4j_tpu/utils/checkpoint.py`` with its API
(``save_checkpoint``, ``restore_checkpoint``, ``latest_step``,
``save_network``, ``restore_network``, ``NetworkCheckpointer``, ``keep``)
in a layout of the port's own: the JAX package writes Orbax directories,
and the machines the port runs on have neither Orbax nor jax. Each step is
one directory, ``<directory>/<step>/``, holding

- ``state.npz`` — the state tree flattened as ``ModelSerializer`` flattens
  it ("/"-joined keys, lists under "[i]");
- ``metadata.json`` — the step, the format and its version.

A step is written to a temporary directory and renamed into place, so a
kill mid-write leaves the last complete step as the latest. After each
save only the newest ``keep`` steps remain. The two packages exchange
models through ModelSerializer zips; neither reads the other's checkpoint
directories.

A network sharded over a mesh (``TransformerLM.shard_params``,
``tensor_parallel.shard_network_params``, FSDP) is saved whole:
``save_network`` gathers its state in every rank (a collective) and
rank 0 writes it; ``restore_network`` reads the whole state and places
each rank's part onto the network's own sharding.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.utils.serializer import (
    _flatten_tree,
    _load_npz,
    _merge_into,
    _unflatten_tree,
)

FORMAT = "deeplearning4j_tpu_torch checkpoint"
FORMAT_VERSION = 1


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(name) for name in os.listdir(directory)
                  if name.isdigit() and os.path.isfile(
                      os.path.join(directory, name, "metadata.json")))


def latest_step(directory: str) -> Optional[int]:
    """The newest complete step under ``directory``, or None."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def save_checkpoint(directory: str, state: Any, step: int,
                    keep: int = 3) -> None:
    """Write ``state`` (a tree of tensors, arrays and scalars) as step
    ``step``, then keep only the newest ``keep`` steps."""
    step = int(step)
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".{step}.", dir=directory)
    try:
        np.savez(os.path.join(tmp, "state.npz"), **_flatten_tree(state))
        with open(os.path.join(tmp, "metadata.json"), "w") as f:
            json.dump({"format": FORMAT, "format_version": FORMAT_VERSION,
                       "step": step}, f)
        final = os.path.join(directory, str(step))
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    for old in _steps(directory)[:-max(1, int(keep))]:
        shutil.rmtree(os.path.join(directory, str(old)), ignore_errors=True)


def restore_checkpoint(directory: str, target: Any = None,
                       step: Optional[int] = None) -> Any:
    """Restore step ``step`` (the newest when None). With ``target``, an
    example tree fixing the structure, dtypes and devices, every leaf is
    cast onto its target leaf (python scalars come back as python
    scalars); a missing entry or a list of another length raises. Without
    it the leaves come back as CPU tensors."""
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, str(int(step)))
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path} is not a checkpoint of this package")
    with open(os.path.join(path, "state.npz"), "rb") as f:
        tree = _unflatten_tree(_load_npz(f.read()))
    if target is None:
        return tree
    return _scalars_like(_merge_into(target, tree), target)


def _scalars_like(restored: Any, target: Any) -> Any:
    """Python scalars of ``target`` back from their 0-d tensors."""
    if isinstance(target, dict):
        return {k: _scalars_like(restored[k], v) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return type(target)(_scalars_like(r, t)
                            for r, t in zip(restored, target))
    if isinstance(target, (bool, int, float)) and isinstance(
            restored, torch.Tensor):
        return type(target)(restored.item())
    return restored


class NetworkCheckpointer:
    """Periodic in-training saves into one directory, ``keep`` retained.
    Saves are synchronous; ``close()`` is kept for the reference's API."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep

    def save(self, network, step: int) -> None:
        save_network(self.directory, network, step, keep=self.keep)

    def close(self) -> None:
        pass


def _network_state(network) -> dict:
    """The training-state tree of a MultiLayerNetwork, ComputationGraph
    (params, updater state, net state, iteration count) or TransformerLM
    (params, Adam state, step count)."""
    ensure = getattr(network, "_ensure_init", None)
    if ensure is None:
        raise TypeError(
            f"cannot checkpoint {type(network).__name__}: expected a "
            "MultiLayerNetwork/ComputationGraph/TransformerLM")
    ensure()
    reg = _registry(network)
    if hasattr(network, "opt_state") and hasattr(network, "step_count"):
        params, state = network.params, network.opt_state
        it = network.step_count
    elif hasattr(network, "updater_state"):
        params, state = network.params, network.updater_state
        it = network.iteration_count
    else:
        raise TypeError(
            f"cannot checkpoint {type(network).__name__}: expected a "
            "MultiLayerNetwork/ComputationGraph/TransformerLM")
    if reg is not None:
        params, state = reg.gather(params), reg.gather_state(state)
    out = {"params": params, "updater_state": state, "iteration": it}
    if not hasattr(network, "opt_state"):
        out["net_state"] = network.net_state
    return out


def _registry(network):
    """The sharding registry a network's state is split under (None
    when every rank holds it whole)."""
    reg = (getattr(network, "_registry", None)
           or getattr(network, "_sharding_registry", None))
    if reg is None or not reg.describe()["sharded_leaves"]:
        return None
    return reg


def _writes() -> bool:
    """Whether this process writes a sharded network's checkpoint: rank
    0 of the world (every process without one)."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def save_network(directory: str, network, step: Optional[int] = None,
                 keep: int = 3) -> None:
    """Checkpoint a network's training state as step ``step`` (its
    iteration count when None). A network a ``ParallelWrapper`` trains
    over a mesh that leaves ranks parked (``_mesh_lead``) is written by
    the mesh's lead alone: a parked rank's state is stale until the call
    that parked it ends."""
    import torch.distributed as dist

    state = _network_state(network)
    sharded = _registry(network) is not None
    lead = getattr(network, "_mesh_lead", None)
    if (dist.get_rank() == lead if lead is not None
            else not sharded or _writes()):
        save_checkpoint(directory, state,
                        step if step is not None else int(state["iteration"]),
                        keep=keep)
    if sharded and lead is None and _world():
        dist.barrier()


def _world() -> bool:
    import torch.distributed as dist

    return dist.is_initialized() and dist.get_world_size() > 1


def restore_network(directory: str, network, step: Optional[int] = None):
    """Restore what ``save_network`` saved into ``network``, on the
    network's device."""
    target = _network_state(network)
    target["iteration"] = 0
    state = restore_checkpoint(directory, target=target, step=step)
    params, upd = state["params"], state["updater_state"]
    reg = _registry(network)
    if reg is not None:
        params, upd = reg.place(params), reg.place_state(upd)
    network.params = params
    if hasattr(network, "opt_state"):
        network.opt_state = upd
        network.step_count = int(state["iteration"])
    else:
        network.updater_state = upd
        network.net_state = state["net_state"]
        network.iteration_count = int(state["iteration"])
    return network
