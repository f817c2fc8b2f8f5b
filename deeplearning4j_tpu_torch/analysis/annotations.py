"""Hot-path annotations consumed by dl4j-lint (stdlib-only, zero cost).

Port of ``deeplearning4j_tpu/analysis/annotations.py``. The fused paths
stake correctness on a contract no test states directly: code reachable
from a captured step must never touch the host (``float()``,
``.item()``, ``.tolist()``, ``.cpu()``, ``np.asarray``,
``torch.cuda.synchronize``) — one such call either breaks the CUDA-graph
capture outright or, on the eager path, serializes every step behind a
device sync.

``@traced`` marks a function as part of that surface.  It is a pure
marker: the decorator returns the function unchanged and only sets
``__dl4j_traced__`` for runtime introspection.  The static analyzer
(``analysis/rules.py``) does not import the code at all — it matches the
decorator *name* in the AST.

``HOT_PATH_REGISTRY`` is the second prong: function names that are hot
by convention, so code is covered without edits.  Names are matched
bare, module-independent — every ``_step_impl`` in the tree is a hot
root.
"""

from __future__ import annotations

from typing import Callable, TypeVar

F = TypeVar("F", bound=Callable)

__all__ = ["traced", "HOT_PATH_REGISTRY"]


def traced(fn: F) -> F:
    """Mark ``fn`` as running inside a captured (or capturable) step (a
    hot root for dl4j-lint's host-sync rule). Identity at runtime."""
    fn.__dl4j_traced__ = True
    return fn


# Functions that are hot roots by NAME, wherever they are defined — the
# step variants every network shares (nn/fused.py) and the loss/grad
# functions each network class defines, the device_eval kernels, and the
# helpers the steps lean on.
#
# profile-readback note: profile collection (monitor/profile
# ``capture_program_profile``, monitor/memory ``sample_hbm_watermark``
# and friends) is a host readback and is only permitted at CHUNK
# BOUNDARIES — between chunks, where drive_epoch_chunks calls it. The
# host-sync rule flags any ``PROFILE_READBACK_CALLS`` name
# (analysis/rules.py) reachable from these roots, exactly like float().
# The same contract covers the run-ledger boundary marks and flight-
# recorder writes (``LEDGER_FLIGHT_CALLS``).
HOT_PATH_REGISTRY = frozenset({
    # nn/fused.py + nn/multilayer.py + nn/graph.py step surface
    "_step_impl",
    "_variant_step",
    "_accum_micro",
    "_loss_grads",
    "_accum_loss_grads",
    # perf/epoch_cache.py — the epoch order drawn on the device
    "epoch_schedule",
    # perf/device_eval.py kernels
    "confusion_update",
    "regression_update",
    "_flatten_time",
    # monitor/pack.py + resilience/guard.py helpers inside the step
    "step_metrics",
    "tree_global_norm",
    "tree_all_finite",
    # serving/engine.py — the decode server's program bodies (the serve
    # loop's one readback is the per-dispatch token block in
    # serving/server.py, outside these roots)
    "_serve_prefill_impl",
    "_serve_spec_impl",
    "_serve_verify_impl",
    "_decode_step_body",
    # serving/fleet/handoff.py — the slot movers (the handoff's host
    # readback is once a request, in export_slot, outside these bodies)
    "_slot_export_impl",
    "_slot_import_impl",
    # nlp/epoch_kernels.py + nlp/glove.py — the fused embedding steps:
    # the plan, the masked NEG update (one device, dp and rows modes) and
    # GloVe's AdaGrad step. The chunk DRIVER (drive_skipgram_chunks) is
    # the host boundary.
    "skipgram_pair_plan",
    "skipgram_negatives",
    "skipgram_epoch_plan",
    "_neg_epoch_math",
    "_neg_epoch_math_dp",
    "_neg_epoch_math_rows",
    "_glove_step_math",
})
