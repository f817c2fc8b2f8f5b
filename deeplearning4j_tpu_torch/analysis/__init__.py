"""Static analysis for the fused-path contract.

Port of ``deeplearning4j_tpu/analysis``. Two prongs, one import-light
package (stdlib at import time — torch loads lazily inside the contract
checker only, so CLI shells can import this freely):

- **dl4j-lint** (``engine``/``rules``/``baseline``): an AST rule engine
  with inline suppressions and a checked-in baseline, shipping the
  ruleset that machine-checks what the fused paths rely on — no host
  syncs in hot paths, hashable program-cache keys, locked cross-thread
  mutation, registry-backed counters, audited pytest markers, placement
  through the sharding registry. CLI: ``python -m
  deeplearning4j_tpu_torch.analysis``.
- **program contracts** (``contracts``): checks of every cached fused
  program of a network, a ``ParallelWrapper`` or a ``Word2Vec`` — no host
  round-trip in a step, the state written in place, collectives on
  declared mesh axes, outputs matching the program key.
"""

from deeplearning4j_tpu_torch.analysis.annotations import (  # noqa: F401
    HOT_PATH_REGISTRY,
    traced,
)

__all__ = [
    "HOT_PATH_REGISTRY",
    "traced",
    "Finding",
    "LintConfig",
    "run_lint",
    "check_network_contracts",
    "check_embedding_contracts",
    "ContractViolation",
]

# PEP 562: only the annotations marker loads eagerly — the production
# modules that import @traced must not pay for the lint engine
# (ast/tokenize), and the contracts load torch
_LAZY = {
    "Finding": "engine", "LintConfig": "engine", "run_lint": "engine",
    "check_network_contracts": "contracts",
    "check_embedding_contracts": "contracts",
    "ContractViolation": "contracts",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is not None:
        import importlib

        return getattr(importlib.import_module(
            f"deeplearning4j_tpu_torch.analysis.{mod}"), name)
    raise AttributeError(name)
