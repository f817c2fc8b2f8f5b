"""Mesh-parallel word2vec: the dl4j-spark-nlp equivalent.

Port of ``deeplearning4j_tpu/nlp/distributed.py``. The semantics of the
reference's Spark module carry over: each partition trains skip-gram on its
slice of the pair batch, and the resulting tables are averaged across the
partitions after every step. Here the partitions are the ranks of a mesh's
``data`` axis: every rank calls the same methods with the same corpus and
seed (so every rank emits the same pairs and negatives), runs the
single-device NEG update (``word2vec._neg_sampling_math``) on its slice of
each batch, and the tables and the loss are averaged over ``data`` in rank
order (``collectives.fixed_order_sum``, so that every rank holds the same
bytes whatever the table size).

``fit_epochs`` is the fused epoch of ``Word2Vec.fit_epochs(mesh=)`` on this
instance's mesh (``dp`` or ``rows``, see ``nlp/epoch_kernels``), and
``attach_heartbeat`` makes the run report to a state tracker like any
other worker.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec, _neg_sampling_math
from deeplearning4j_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    axis_group,
    axis_rank,
    data_axis_size,
)


class DistributedWord2Vec(Word2Vec):
    """Word2Vec whose NEG skip-gram batches split across a device mesh.

    Only the hot path (skip-gram with negative sampling, the Spark module's
    algorithm) distributes; hierarchical softmax and CBOW run the
    single-device steps. A pair batch is padded to a multiple of the
    data-parallel degree by wrapping around to its own first pairs
    (duplicates collapse to a mean under the per-row scaling, so padding
    re-weights real pairs slightly instead of adding fake ones)."""

    def __init__(self, *args, mesh=None, **kw):
        super().__init__(*args, **kw)
        if mesh is None:
            from deeplearning4j_tpu_torch.parallel.mesh import build_mesh

            mesh = build_mesh(device=self.device)
        self.mesh = mesh
        self._group = axis_group(mesh, DATA_AXIS)
        self._shard = axis_rank(mesh, DATA_AXIS)
        self._heartbeat = None
        self._heartbeat_stats = {}

    @property
    def data_parallelism(self) -> int:
        return data_axis_size(self.mesh)

    def fit_epochs(self, num_epochs: Optional[int] = None, *,
                   cache=None, chunk_epochs=None, on_chunk=None,
                   mesh=None, budget_mb=None, _plan=None):
        """Fused epochs on ``self.mesh`` by default: the corpus cache,
        the chunk program and the table registry all use the mesh this
        instance was built for."""
        return super().fit_epochs(
            num_epochs, cache=cache, chunk_epochs=chunk_epochs,
            on_chunk=on_chunk, mesh=self.mesh if mesh is None else mesh,
            budget_mb=budget_mb, _plan=_plan)

    # ------------------------------------------------------------------
    # fleet wiring: an embedding run looks like any other worker
    # ------------------------------------------------------------------
    def attach_heartbeat(self, tracker, worker_id: str,
                         interval_s: float = 5.0):
        """Post words/s and loss payloads to a cluster state tracker, so
        that the fleet master's tick and straggler flags see this run
        like any dense worker. The fused chunk driver refreshes
        ``_heartbeat_stats`` once per chunk; the monitor thread sends
        whatever is current. Returns the :class:`HeartbeatMonitor` (a
        context manager around training, or ``start()``/``stop()``)."""
        from deeplearning4j_tpu_torch.parallel.cluster import HeartbeatMonitor

        self._heartbeat = HeartbeatMonitor(
            tracker, worker_id, interval_s=interval_s,
            payload_fn=lambda: dict(self._heartbeat_stats))
        return self._heartbeat

    def _neg_batch(self, c: np.ndarray, x: np.ndarray, lr: float):
        """One NEG batch split over ``data``: this rank's slice updates
        its copy of the tables, then the copies and the loss are
        averaged over the ranks."""
        from deeplearning4j_tpu_torch.parallel.collectives import (
            fixed_order_sum)

        if self._group is None:
            return super()._neg_batch(c, x, lr)
        negs = self._sample_negatives(len(c), x)
        dp = self.data_parallelism
        pad = (-len(c)) % dp
        if pad:  # wrap-around padding with the batch's own pairs
            c = np.resize(c, len(c) + pad)
            x = np.resize(x, len(x) + pad)
            negs = np.resize(negs, (negs.shape[0] + pad, negs.shape[1]))
        per = len(c) // dp
        mine = slice(self._shard * per, (self._shard + 1) * per)
        syn0, syn1neg, loss = _neg_sampling_math(
            self.syn0, self.syn1neg, self._dev(c[mine]), self._dev(x[mine]),
            self._dev(negs[mine]), lr)
        self.syn0 = fixed_order_sum(syn0, self._group) / dp
        self.syn1neg = fixed_order_sum(syn1neg, self._group) / dp
        return fixed_order_sum(loss, self._group) / dp
