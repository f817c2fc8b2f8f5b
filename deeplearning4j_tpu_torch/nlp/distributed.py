"""``DistributedWord2Vec``: word2vec over a device mesh.

The reference's ``nlp/distributed.py`` shards each batch (and optionally
the tables) over a mesh. The port does not run it yet (ROADMAP A14.3): the name
is exported so that code naming it fails with that item, not with an
import error.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.perf.epoch_cache import mesh_not_ported


class DistributedWord2Vec:
    """Raises on construction (ROADMAP A14.3)."""

    def __init__(self, *args, **kwargs):
        raise mesh_not_ported("DistributedWord2Vec")
