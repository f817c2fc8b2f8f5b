"""In-program numeric sentinel and the ``DL4J_NAN_GUARD`` divergence policy.

Port of ``deeplearning4j_tpu/resilience/guard.py``. The fused training
paths (``perf/epoch_cache.py``) run a whole chunk of optimizer steps
without reading anything back, so one non-finite batch would poison every
later step before the host saw it. The sentinel checks each step's loss
and every gradient leaf on the device; a tripped step keeps params,
updater state and net state as they were (``torch.where`` leaf by leaf,
no host branch), and the ``[E, N]`` trip history comes back with the
loss history for the host to enforce the policy per chunk:

- ``skip`` (default) — log and continue;
- ``halve_lr`` — also halve the host LR scale for the later chunks;
- ``raise`` — replay the chunk step by step from the last good snapshot
  to find the batch, then raise :class:`TrainingDivergedError`;
- ``off`` — run the step without the sentinel.

A skipped step still advances the iteration counter, so LR schedules
stay aligned with an uninterrupted run.
"""

from __future__ import annotations

import logging
import os

import torch

logger = logging.getLogger(__name__)

__all__ = [
    "NAN_GUARD_POLICIES",
    "TrainingDivergedError",
    "nan_guard_policy",
    "tree_all_finite",
]

NAN_GUARD_POLICIES = ("skip", "halve_lr", "raise", "off")
DEFAULT_POLICY = "skip"


class TrainingDivergedError(RuntimeError):
    """Raised under ``DL4J_NAN_GUARD=raise`` when a fused optimizer step
    produced a non-finite loss or gradient. ``epoch``/``step`` locate the
    trip (``step`` is the position in that epoch's batch order); the
    per-step replay adds the dataset ``batch_index`` and the ``loss``."""

    def __init__(self, epoch: int, step: int, batch_index=None, loss=None,
                 n_trips: int = 1, where: str = "fused epoch program"):
        self.epoch = int(epoch)
        self.step = int(step)
        self.batch_index = batch_index
        self.loss = loss
        self.n_trips = int(n_trips)
        msg = (f"training diverged in the {where}: non-finite step at "
               f"epoch {epoch}, step {step}")
        if batch_index is not None:
            msg += f" (dataset batch #{batch_index}"
            if loss is not None:
                msg += f", loss={loss}"
            msg += ")"
        if n_trips > 1:
            msg += f"; {n_trips} step(s) tripped in total"
        msg += " [DL4J_NAN_GUARD=raise]"
        super().__init__(msg)


def nan_guard_policy() -> str:
    """Resolve ``DL4J_NAN_GUARD`` (default ``skip``); an unknown value
    logs and falls back to the default."""
    raw = os.environ.get("DL4J_NAN_GUARD", "").strip().lower()
    if not raw:
        return DEFAULT_POLICY
    if raw not in NAN_GUARD_POLICIES:
        logger.warning("DL4J_NAN_GUARD=%r is not one of %s; using %r",
                       raw, NAN_GUARD_POLICIES, DEFAULT_POLICY)
        return DEFAULT_POLICY
    return raw


def tree_all_finite(tree) -> torch.Tensor:
    """A 0-dim bool tensor on the leaves' device: every floating leaf of
    ``tree`` is finite everywhere. Integer leaves are skipped, as in the
    reference. Nothing is read back to the host."""
    from deeplearning4j_tpu_torch.dtypes import tree_leaves

    checks = [torch.isfinite(leaf).all() for leaf in tree_leaves(tree)
              if leaf.is_floating_point()]
    if not checks:
        return torch.ones((), dtype=torch.bool)
    return torch.stack(checks).all()
