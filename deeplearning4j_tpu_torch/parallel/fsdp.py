"""FSDP / ZeRO-3: parameters and optimizer state sharded over ``data``.

Port of ``deeplearning4j_tpu/parallel/fsdp.py``. Each rank keeps 1/N of
every leaf between steps; a step gathers the whole state over the
``data`` axis (the all-gather GSPMD inserts when a weight is used),
runs, and keeps its own part of what the step returned. The reference's
partitioner also reduce-scatters gradients; here the step function
reduces its gradients over the mesh itself (``ParallelWrapper``'s step,
``TransformerLM._step_body(mesh=)``) or is given the global batch.

A leaf is sharded along its LARGEST mesh-divisible dimension (ties →
first); leaves with no divisible dimension (scalars, small biases) stay
replicated.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

from deeplearning4j_tpu_torch.dtypes import tree_leaves
from deeplearning4j_tpu_torch.parallel.mesh import DATA_AXIS, axis_size
from deeplearning4j_tpu_torch.parallel.sharding_registry import (
    NamedSharding,
    P,
    PartitionSpec,
    _rebuild,
    batch_sharding as _batch_sharding,
    named,
    tree_leaves_of,
)


def fsdp_spec(shape: Tuple[int, ...], mesh,
              axis: str = DATA_AXIS) -> PartitionSpec:
    """Spec sharding the largest dimension divisible by the mesh axis
    size; replicated when nothing divides (scalars, odd biases)."""
    n = axis_size(mesh, axis)
    best = None
    for i, d in enumerate(shape):
        if d % n == 0 and d >= n and (best is None or d > shape[best]):
            best = i
    if best is None:
        return P()
    entries: list = [None] * len(shape)
    entries[best] = axis
    return P(*entries)


def fsdp_shardings(tree: Any, mesh, axis: str = DATA_AXIS) -> Any:
    """Per-leaf :class:`NamedSharding` for a tree of tensors (optimizer
    state leaves mirror their parameter's shape, so the same rule
    applies)."""
    return _rebuild(tree, [named(mesh, fsdp_spec(tuple(x.shape), mesh,
                                                 axis))
                           for x in tree_leaves(tree)])


def shard_tree(tree: Any, mesh, axis: str = DATA_AXIS, *,
               with_shardings: bool = False) -> Any:
    """This rank's part of every leaf under its FSDP sharding. With
    ``with_shardings=True`` returns ``(local_tree, shardings)``."""
    shardings = fsdp_shardings(tree, mesh, axis)
    placed = _rebuild(tree, [s.local(x) for x, s in
                             zip(tree_leaves(tree), tree_leaves_of(shardings))])
    return (placed, shardings) if with_shardings else placed


def gather_tree(tree: Any, shardings: Any) -> Any:
    """The whole leaves from every rank's parts (``shard_tree`` undone)."""
    return _rebuild(tree, [s.gather(x) for x, s in
                           zip(tree_leaves(tree), tree_leaves_of(shardings))])


def local_tree(tree: Any, shardings: Any) -> Any:
    """This rank's part of whole leaves under ``shardings``."""
    return _rebuild(tree, [s.local(x) for x, s in
                           zip(tree_leaves(tree), tree_leaves_of(shardings))])


class FSDP:
    """Generic ZeRO-3 wrapper around a ``(params, opt_state, *args) ->
    (params, opt_state, aux)`` step function.

    >>> trainer = FSDP(mesh, lm.params, lm.opt_state)
    >>> step = trainer.jit_step(lm._step_body(mesh=mesh))
    >>> params, opt_state = trainer.params, trainer.opt_state
    >>> params, opt_state, loss = step(params, opt_state, tokens, 0)

    ``params``/``opt_state`` are this rank's parts from construction on;
    the wrapped step takes and returns parts, so each rank holds 1/N of
    the state between steps. With ``donate=True`` the wrapper drops its
    own references at the first step, so a later ``.params`` read raises
    a clear error instead of handing out stale parts.
    """

    _DONATED = object()

    def __init__(self, mesh, params: Any, opt_state: Any,
                 axis: str = DATA_AXIS):
        self.mesh = mesh
        self.axis = axis
        self._params, self.param_shardings = shard_tree(
            params, mesh, axis, with_shardings=True)
        self._opt_state, self.opt_shardings = shard_tree(
            opt_state, mesh, axis, with_shardings=True)

    @property
    def params(self):
        return self._checked(self._params, "params")

    @property
    def opt_state(self):
        return self._checked(self._opt_state, "opt_state")

    def _checked(self, val, name):
        if val is FSDP._DONATED:
            raise RuntimeError(
                f"FSDP.{name} was donated to a jit_step call; the live "
                "state is what that step returned (take ownership of "
                ".params/.opt_state BEFORE the first step, as in the "
                "class docstring)")
        return val

    def gather(self, params: Any, opt_state: Any):
        """The whole ``(params, opt_state)`` from this rank's parts."""
        return (gather_tree(params, self.param_shardings),
                gather_tree(opt_state, self.opt_shardings))

    def jit_step(self, step_fn: Callable, *, donate: bool = True
                 ) -> Callable:
        """``step_fn(params, opt_state, *args) -> (params, opt_state,
        aux)`` on whole state, wrapped to take and return this rank's
        parts: gather, step, keep the local part. The name is the
        reference's; there is nothing to compile."""
        def fn(params, opt_state, *args, **kwargs):
            full_p, full_s = self.gather(params, opt_state)
            new_p, new_s, aux = step_fn(full_p, full_s, *args, **kwargs)
            return (local_tree(new_p, self.param_shardings),
                    local_tree(new_s, self.opt_shardings), aux)

        if not donate:
            return fn

        def wrapper(*args, **kwargs):
            self._params = self._opt_state = FSDP._DONATED
            return fn(*args, **kwargs)

        return wrapper

    def batch_sharding(self, ndim: int) -> NamedSharding:
        """Standard data-parallel batch sharding (leading dim)."""
        return _batch_sharding(self.mesh, ndim, axis=self.axis)
