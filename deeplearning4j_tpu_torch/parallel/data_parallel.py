"""Data-parallel training: synchronous all-reduce DP + parameter averaging.

Port of ``deeplearning4j_tpu/parallel/data_parallel.py``.

``ParallelWrapper``: the reference's one SPMD program over a mesh — the
batch split over the ``data`` axis, params replicated, the gradient
all-reduce inserted by GSPMD — is, under torch's SPMD model, the same
wrapper in every rank of the world. Each rank is given the same global
batch, takes its rows (rank r of N: rows ``[r·B/N, (r+1)·B/N)``), and
the step is written so that it equals the single-device step over the
global batch:

- the loss's numerator is summed locally and its denominator (the
  examples, or the label mask's sum) over all ranks, so masked batches
  whose shards hold different mask counts normalise as one batch;
- the L1/L2 penalty enters each rank's loss as 1/N of itself;
- BatchNorm takes its statistics over the global batch (sync-BN,
  ``nn.layers.normalization.sync_batch_stats``);
- the gradients are summed over the ranks in one flat all-reduce per
  dtype, then the updaters run on the whole gradient, as the
  reference's gradient normalisation sees it.

That step is the network's own (``_variant_step``) inside
``ops.losses.data_parallel_loss``, the scope whose losses are each
rank's share of the global batch's.

A float32 sum over ranks is not the single-device sum bitwise (the
order differs), so a wrapper over N > 1 ranks agrees with the global
batch to rounding (the tests' float32 gate is rtol 1e-4 / atol 1e-6).
A mesh whose ``data`` axis has size 1 runs the network's own step:
bitwise ``net.fit``. Dropout draws come from each rank's own generator
(seeded from the conf's seed and the rank), so they match the global
program in distribution only.

``fsdp=True`` keeps params and updater state sharded over ``data``
between steps (``parallel/fsdp.py``): each rank holds its part in
``network.params``/``network.updater_state``; a step gathers the whole
state, runs the step above and keeps its part of the result.
``gather()`` returns the whole trees; ``output``, ``score`` and
``evaluate`` gather what they need.

Over a mesh with a ``model`` axis the rows go over ``data`` and each
data group's model ranks split the layers (``tensor_parallel``). With
``fsdp=True`` there the two compose as the reference's ``with_fsdp``
composes them: a ``model``-split leaf keeps its split, every leaf the
split replicates is sharded over ``data``; a step gathers the ``data``
parts over the ``data`` group of this rank's model line, and the split
layers gather their ``model`` shards themselves. Gradient normalization
by L2 norms then spans a layer's ``data`` parts (gathered before the
step, the gradients summed over ``data``) and its ``model`` parts (the
split layers' norms summed over ``model``).

``ParameterAveragingTrainer`` keeps the reference's exact semantics
(independent replicas, periodic averaging — local SGD): replicas stacked
on a leading axis, each step's gradients ``torch.func.vmap``-ed over the
replicas, params AND updater state averaged every
``averaging_frequency`` steps. Without a mesh all replicas live on the
one device and no process group is needed; over a ``data`` axis each
rank holds R/N of them and the average is an all-reduce.

``fit_epochs`` is the fused epoch over the mesh: the dataset cache
keeps each rank's ``B/n`` rows of every batch (``perf.epoch_cache``
``build(mesh=)``), and each epoch runs the step above on this rank's
rows of every batch of the plan, eagerly (gloo collectives cannot be
captured), with the ``[E, N]`` history, the numeric sentinel, telemetry
and ``accum_steps`` of the one-device ``fit_epochs``. Every rank trains
on one plan: the mesh's lead (its first rank) draws each epoch's order
from the network's generator (the one-device run's stream) and
broadcasts it to the members. A world of one runs the network's own
captured ``fit_epochs``, bitwise.

``request_reshard(mesh)`` re-lays the run out at the next chunk boundary
(elastic reshard): another topology, over all of the world's ranks or
some of them (``build_mesh(ranks=)``), or ``None``: every rank the
one-device step on whole batches. A rank outside the mesh *parks*: it
skips each chunk's compute and the mesh's collectives, keeps whole
batches of the dataset cache, and receives each chunk's history from
the lead. It still joins each boundary's world-wide decision, so that a
stop, a disagreement or a grow reaches it; a grow sends it the lead's
whole state (params, updater and net state) and the generator, the
iteration count, the learning-rate scale and the epoch cursor, and a
shrink hands the generator from the old lead to the new one. At the end
of a call that left ranks parked, the lead broadcasts its history and
whole state over the world, so that every rank returns the same history
and holds the same state. Chunk-boundary decisions (``on_chunk``'s
stop, a reshard request) must agree across ranks, which the boundary
checks with one ``all_gather`` over the world.
"""

from __future__ import annotations

import contextlib
import logging
import types
from typing import Any, Optional

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.dtypes import tree_leaves, tree_map
from deeplearning4j_tpu_torch.ops.losses import masked_sums, per_example_loss
from deeplearning4j_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce_,
)
from deeplearning4j_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    axis_group,
    axis_rank,
    build_mesh,
    data_axis_size,
    in_mesh,
    local_chunk,
    mesh_devices,
    mesh_group,
    mesh_lead,
    mesh_ranks,
    world_size,
)
from deeplearning4j_tpu_torch.parallel.sharding_registry import _rebuild

logger = logging.getLogger(__name__)


def loss_sums(loss_fn, out: torch.Tensor, y: torch.Tensor,
              mask: Optional[torch.Tensor]):
    """The loss's numerator and denominator on this rank's rows."""
    return masked_sums(per_example_loss(loss_fn, out, y), mask)


class ParallelWrapper:
    """Synchronous data-parallel fit over a mesh.

    Usage (in every rank of the world)::

        wrapper = ParallelWrapper(net, mesh=build_mesh(device="cuda"))
        wrapper.fit(iterator)   # the same global batches in every rank
    """

    def __init__(self, network, mesh=None, donate: bool = True,
                 fsdp: bool = False):
        """``fsdp=True`` shards parameters AND updater state over the
        ``data`` axis instead of replicating (over a ``model`` axis, the
        leaves the tensor-parallel split replicates); batch sizes must then
        divide the data axis (no ragged-tail step). ``donate`` is the
        reference's buffer-donation switch; eager torch updates in place
        and ignores it."""
        self.network = network
        network._ensure_init()
        self._donate = donate
        self.fsdp = fsdp
        self._epoch_plans = []  # each epoch's order, as every rank drew it
        self._programs = {}  # the epoch programs fit_epochs ran, by key
        self._ran_partial = False  # a fit_epochs run left ranks parked
        self._set_mesh(mesh if mesh is not None else build_mesh(
            device=network.device))

    def _set_mesh(self, mesh) -> None:
        """Adopt ``mesh`` (``None``: whole batches in every rank) and
        place the network's whole state on it; a rank outside it parks,
        holding the whole state as it stands."""
        net = self.network
        self.mesh = mesh
        self._lead = mesh_lead(mesh)
        self._members = mesh_group(mesh)
        self._parked = not in_mesh(mesh)
        # some rank of the world lies outside the mesh
        self._partial = len(mesh_ranks(mesh)) < world_size()
        self._ran_partial = self._ran_partial or self._partial
        # the rank that holds the run's state for a checkpoint
        # (``utils.checkpoint.save_network``) while ranks are parked
        net._mesh_lead = self._lead if self._partial else None
        self._registry = self._fsdp_reg = None
        if self._parked:
            self._group, self._rank = None, 0
            return
        self._group = axis_group(mesh, DATA_AXIS)
        self._rank = axis_rank(mesh, DATA_AXIS)
        if self._group is not None and self._rank:
            # each rank draws its own dropout masks for its own rows;
            # rank 0 keeps the network's stream, which draws the plans
            net._rng.manual_seed(net.conf.global_conf.seed
                                 + (self._rank << 32)
                                 + net.iteration_count)
        if mesh is not None:
            self._place_params()

    @property
    def device(self):
        return self.network.device

    @property
    def data_parallelism(self) -> int:
        return data_axis_size(self.mesh)

    def _place_params(self):
        """Registry-driven placement, composed as the reference composes
        it: the registry's specs for the mesh first (replicated on a
        pure-DP mesh; over a ``model`` axis the Megatron splits, run by
        ``tensor_parallel.shard_network_params``), then with
        ``fsdp=True`` ``with_fsdp``: every leaf those specs replicate is
        split over ``data`` along its largest divisible dim, and a
        ``model``-split leaf keeps its spec. ``_fsdp_reg`` holds the
        ``data`` splits alone: a step gathers them over the ``data``
        group of this rank's model line, and a split layer gathers its
        ``model`` shards itself."""
        from deeplearning4j_tpu_torch.parallel.sharding_registry import (
            P, ShardingRegistry, _spec_leaves, model_axis_size)
        from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
            shard_network_params)

        net = self.network
        split = model_axis_size(self.mesh) > 1
        if split:
            # rows over data, each data group's model ranks splitting
            # the layers as tensor_parallel does
            if getattr(net, "_tp_mesh", None) is not self.mesh:
                shard_network_params(net, self.mesh)
            reg = net._sharding_registry
        else:
            reg = ShardingRegistry.for_network(net, self.mesh)
        self._registry, self._fsdp_reg = reg, None
        if self.fsdp:
            self._registry = self._fsdp_reg = reg.with_fsdp(net.params)
            if split:
                data_only = [c if t == P() else P() for c, t in zip(
                    _spec_leaves(self._registry.spec_tree),
                    _spec_leaves(reg.spec_tree))]
                self._fsdp_reg = ShardingRegistry(
                    self.mesh, _rebuild(net.params, data_only),
                    name=self._registry.name)
        elif split:
            return   # shard_network_params placed the split
        (reg if self._fsdp_reg is None else self._fsdp_reg).place_network(net)
        net._sharding_registry = self._registry

    def gather(self):
        """The whole ``(params, updater_state)`` (under ``fsdp=True`` or
        tensor parallelism gathered from every rank's parts; else the
        network's own)."""
        net = self.network
        if self._registry is None or (
                not self.fsdp and getattr(net, "_tp_mesh", None) is None):
            return net.params, net.updater_state
        return (self._registry.gather(net.params),
                self._registry.gather_state(net.updater_state))

    @contextlib.contextmanager
    def _whole_params(self):
        """The network holds its params whole over ``data`` inside (FSDP
        gathers; a ``model``-split leaf stays this rank's shard)."""
        net = self.network
        if self._fsdp_reg is None or self._group is None:
            yield
            return
        parts = net.params
        net.params = self._fsdp_reg.gather(parts)
        try:
            yield
        finally:
            net.params = parts

    def request_reshard(self, mesh) -> None:
        """Request an elastic reshard of the in-flight ``fit_epochs`` run
        onto ``mesh`` (another topology over all or some of the world's
        ranks, or ``None``: every rank the one-device step on whole
        batches), applied at the next chunk boundary
        (``_apply_reshard``). Every rank of the world must request the
        same one. A mesh over ranks the world lacks raises
        ``ValueError``."""
        self.network.request_reshard(mesh)

    def _apply_reshard(self, mesh, cache) -> None:
        """The chunk driver's reshard actuator, in every rank of the
        world: the whole state gathered from the old layout by its
        members (tensor-parallel layers unwrapped), the dataset cache
        re-laid for ``mesh``, the state placed on it. Ranks that come
        back from parking receive the old lead's whole state; every rank
        takes the old lead's generator, iteration count, learning-rate
        scale and epoch cursor (the new lead continues its stream, and
        with ``None`` the ranks' whole-batch steps stay the same bytes).
        Values are untouched; only placement changes."""
        from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
            unshard_network_params)

        net = self.network
        old_ranks, old_lead = mesh_ranks(self.mesh), self._lead
        if not self._parked:
            params, upd = self.gather()
            unshard_network_params(net)
            net.params, net.updater_state = params, upd
        net.__dict__.pop("_sharding_registry", None)
        cache.respec(mesh)
        if world_size() > 1:
            if set(mesh_ranks(mesh)) - set(old_ranks):  # parked ranks return
                _adopt_state(net, old_lead, (net.params, net.updater_state,
                                             net.net_state))
            _adopt_host_state(net, old_lead, adopt=True)
        self._set_mesh(mesh)

    def _share_with_parked(self) -> None:
        """The end of a call over a mesh that leaves ranks out: the
        lead's whole state (gathered by the members where it is sharded)
        and its host state, broadcast over the world, adopted by every
        parked rank. Nothing when every rank is a member."""
        if not self._partial:
            return
        net = self.network
        params, upd = self.gather()
        _adopt_state(net, self._lead, (params, upd, net.net_state),
                     adopt=self._parked)
        _adopt_host_state(net, self._lead, adopt=self._parked)

    def fit(self, data, num_epochs: int = 1):
        """fit(DataSetIterator | DataSet). Every rank passes the same
        global batches; each steps on its rows.

        TBPTT, non-SGD-solver, pretraining, SCORE-lr and iterations > 1
        configurations are NOT sharded: they delegate wholly to the
        network's own fit (every rank runs the same whole batches, so
        the replicas stay equal) rather than silently taking different
        steps on the mesh. A rank outside the mesh takes no step and
        receives the lead's state at the end."""
        net = self.network
        shardable = self._shardable()
        if not shardable and self.fsdp:
            raise ValueError(
                "ParallelWrapper(fsdp=True) does not support "
                "TBPTT/non-SGD/pretrain/SCORE-lr/iterations>1 "
                "configs; use fsdp=False (replicated DP) for these")
        if not self._parked:
            self._fit_member(data, num_epochs, shardable)
        self._share_with_parked()
        return self

    def _fit_member(self, data, num_epochs: int, shardable: bool) -> None:
        net = self.network
        if not shardable:
            from deeplearning4j_tpu_torch.nn.multilayer import (
                MultiLayerNetwork)

            reason = ("non-shardable config (TBPTT/non-SGD/pretrain/"
                      "SCORE-lr/iterations>1)"
                      if isinstance(net, MultiLayerNetwork)
                      else f"{type(net).__name__} does not speak the "
                           "MLN sharded-step protocol")
            logger.info("ParallelWrapper: %s — delegating to the "
                        "network's own fit path", reason)
            net.fit(data, num_epochs=num_epochs)
        elif isinstance(data, DataSet):
            self._fit_one(data)
        else:
            for _ in range(num_epochs):
                if hasattr(data, "reset"):
                    data.reset()
                for ds in data:
                    self._fit_one(ds)

    def _shardable(self) -> bool:
        """Configs whose per-batch semantics the sharded step keeps
        exactly — MultiLayerNetwork's ``fit_steps`` exclusion list."""
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        if not isinstance(self.network, MultiLayerNetwork):
            return False
        return self.network.fused_epochs_supported()

    def _fit_one(self, ds: DataSet):
        net = self.network
        dp = self.data_parallelism
        n = ds.num_examples()
        if n % dp:
            if self.fsdp:
                raise ValueError(
                    f"FSDP requires batch sizes divisible by the data "
                    f"axis (got {n} vs dp={dp}); pad or drop the tail "
                    f"batch")
            # ragged tail batch: ONE unsharded step (every rank alike) —
            # the same step count as the sharded path
            logger.debug("batch of %d not divisible by dp=%d; running "
                         "unsharded", n, dp)
            self._whole_step(ds)
            return
        if self._group is None:
            self._whole_step(ds)
            return
        batch = tuple(None if a is None else
                      net._dev(local_chunk(torch.as_tensor(a), 0, dp,
                                           self._rank))
                      for a in (ds.features, ds.labels, ds.features_mask,
                                ds.labels_mask))
        # on whole params under FSDP, on this rank's shards under tensor
        # parallelism (its layers gather their own)
        p, u, s, loss, _, _ = self._sharded_step(
            net.params, net.updater_state, net.net_state,
            net.iteration_count, batch, self._group, 1, False, 0, net._rng)
        net.params, net.updater_state, net.net_state = p, u, s
        net._score = loss
        net._train_dispatches += 1
        net._post_iteration()

    def _whole_step(self, ds: DataSet):
        """The network's own step on the whole batch (a mesh of one, or
        a ragged tail on replicated params)."""
        net = self.network
        net._sgd_step(net._dev(ds.features), net._dev(ds.labels),
                      net._dev(ds.features_mask), net._dev(ds.labels_mask))
        net._post_iteration()

    # ------------------------------------------------------------------
    # the fused epoch over the mesh
    # ------------------------------------------------------------------
    def fused_epochs_supported(self) -> bool:
        """The wrapped network's own fused-path matrix."""
        supported = getattr(self.network, "fused_epochs_supported", None)
        return bool(supported and supported())

    def build_epoch_cache(self, data, accum_steps: Optional[int] = None,
                          cache_mb: Optional[float] = None):
        """The device cache with each rank's ``B/n`` rows of every batch
        (a batch the ``data`` axis does not divide stays whole), priced
        per rank. ``accum_steps=None`` reads ``DL4J_ACCUM_STEPS``."""
        from deeplearning4j_tpu_torch.perf.epoch_cache import (
            accum_steps_default)

        net = self.network
        if accum_steps is None:
            accum_steps = accum_steps_default()
        return net._CACHE.build(data, budget_mb=cache_mb, mesh=self.mesh,
                                accum_steps=accum_steps, device=net.device)

    def _meshless(self) -> bool:
        return world_size() == 1 and mesh_devices(self.mesh) == 1

    def fit_epochs(self, data, num_epochs: int, *, shuffle: bool = True,
                   chunk_epochs: Optional[int] = None,
                   cache_mb: Optional[float] = None,
                   accum_steps: Optional[int] = None,
                   guard: Optional[str] = None, telemetry=None,
                   on_chunk=None):
        """``net.fit_epochs`` over the mesh (see the module): every rank
        calls it with the same data. Returns the ``[E, N]`` loss history
        (the global batch's losses, the same in every rank), or ``None``
        when a fallback ran: an unsupported configuration runs the
        network's own per-epoch ``fit`` (``fsdp=True`` raises, having no
        unsharded fallback); a dataset over the per-rank budget streams
        through the wrapper's sharded ``fit`` for a MultiLayerNetwork and
        the graph's own ``fit`` for a ComputationGraph (which raises
        under ``fsdp=True``)."""
        from deeplearning4j_tpu_torch.monitor import fused_metrics_stride
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        from deeplearning4j_tpu_torch.perf.epoch_cache import (
            accum_steps_default,
            drive_epoch_chunks,
            effective_accum_steps,
            layout_shards,
            stream_epochs,
        )
        from deeplearning4j_tpu_torch.resilience.guard import (
            TrainingDivergedError, nan_guard_policy)

        net = self.network
        net._ensure_init()
        if self._meshless():
            return net.fit_epochs(
                data, num_epochs, shuffle=shuffle, chunk_epochs=chunk_epochs,
                cache_mb=cache_mb, accum_steps=accum_steps, guard=guard,
                telemetry=telemetry, on_chunk=on_chunk)
        if num_epochs <= 0 or net._fit_trains_nothing():
            return None
        if accum_steps is None:
            accum_steps = accum_steps_default()
        prebuilt = isinstance(data, net._CACHE)
        if not self.fused_epochs_supported():
            if prebuilt:
                raise ValueError(
                    "this configuration needs the per-step fit loop — "
                    "pass the original iterator, not a prebuilt cache")
            if self.fsdp:
                raise ValueError(
                    "ParallelWrapper(fsdp=True) cannot run this "
                    "configuration's per-step fallback; use fsdp=False")
            if not self._parked:
                for _ in range(num_epochs):
                    net.fit(data)
            self._share_with_parked()
            return None
        cache = data if prebuilt else self.build_epoch_cache(
            data, accum_steps=accum_steps, cache_mb=cache_mb)
        if cache is None:
            if self.fsdp and not isinstance(net, MultiLayerNetwork):
                raise ValueError(
                    "dataset exceeds the per-rank cache budget and "
                    "ComputationGraph has no fsdp streaming fallback — "
                    "raise DL4J_DEVICE_CACHE_MB, set "
                    "DL4J_CACHE_DTYPE=bfloat16, or increase accum_steps")
            stream_epochs(self, data, num_epochs)
            return None
        if (self.fsdp and self.data_parallelism > 1
                and layout_shards(cache.batch, self.mesh) == 1):
            # decided from the mesh, so that a parked rank raises too
            raise ValueError(
                f"FSDP requires the bucket batch ({cache.batch}) to divide "
                f"the data axis ({self.data_parallelism})")
        accum = effective_accum_steps(accum_steps, cache.rows_per_shard)
        guard = nan_guard_policy() if guard is None else guard
        stride = fused_metrics_stride(telemetry)
        hooks = self._driver_hooks(cache, shuffle, accum, guard != "off",
                                   stride, on_chunk)
        self._ran_partial = self._partial
        try:
            hist = drive_epoch_chunks(
                net, cache, num_epochs, chunk_epochs, hooks.launch,
                shuffle=shuffle, guard=guard, replay_step=hooks.replay_step,
                on_chunk=hooks.on_chunk, reshard=hooks.reshard,
                gen_state_fn=hooks.gen_state_fn)
        except TrainingDivergedError as e:
            self._raise_divergence(e)
            raise
        return self._finish_run(hist)

    def _driver_hooks(self, cache, shuffle: bool, accum: int, guarded: bool,
                      stride: int, on_chunk):
        """The chunk driver's callbacks over this wrapper's mesh:
        ``launch``, the ``raise`` replay, the agreed ``on_chunk``, the
        reshard actuator and the lead's generator state (also what a
        meshless run hands the rest of its run to)."""
        from deeplearning4j_tpu_torch.nn.fused import _map

        def replay_step(params, upd, nst, it, i, gen):
            # the ``raise`` replay: the same step on the same rows (a
            # parked rank localizes nothing: its state is not the run's)
            if self._parked:
                return params, upd, nst, torch.tensor(float("nan"))
            batch = _map(lambda a: a[i], cache.batch_stacks())
            p, u, s, loss, _, _ = self._sharded_step(
                params, upd, nst, it, batch, self._cache_group(cache), accum,
                False, 0, gen)
            return p, u, s, loss

        def agreed(done: int) -> bool:
            stop = bool(on_chunk(done)) if on_chunk is not None else False
            self._agree(stop)
            return stop

        return types.SimpleNamespace(
            launch=self._epoch_launch(cache, shuffle, accum, guarded, stride),
            replay_step=replay_step, on_chunk=agreed,
            reshard=lambda mesh: self._apply_reshard(mesh, cache),
            gen_state_fn=self._lead_generator_state)

    def _finish_run(self, hist):
        """The end of a ``fit_epochs`` run that left ranks parked at some
        boundary: the lead's ``[E, N]`` history and whole state in every
        rank (parked ranks adopt the state; members keep their layout)."""
        if self._ran_partial:
            dist.broadcast(hist, src=self._lead)
            self._share_with_parked()
        return hist

    def _raise_divergence(self, e) -> None:
        """A ``TrainingDivergedError`` ``e``, which every rank raises at
        the same boundary, raised again with the lead's replayed batch
        and loss where the run left ranks parked (a parked rank replays
        nothing); nothing otherwise."""
        from deeplearning4j_tpu_torch.resilience.guard import (
            TrainingDivergedError)

        if self._ran_partial:
            box = [(e.batch_index, e.loss)]
            dist.broadcast_object_list(box, src=self._lead)
            raise TrainingDivergedError(
                e.epoch, e.step, *box[0], n_trips=e.n_trips) from e

    def _cache_group(self, cache):
        """The group a step over ``cache`` sums over: the ``data`` axis's
        while the cache holds each rank's rows, none while it holds whole
        batches (read per step: a reshard changes both)."""
        return self._group if cache.n_shard > 1 else None

    def _epoch_launch(self, cache, shuffle: bool, accum: int, guarded: bool,
                      stride: int):
        """``launch(k)`` for the chunk driver: k epochs of eager steps on
        this rank's rows of every batch, in the plan every rank shares.
        The program (its ``launch``, its ``step(i, it)`` on batch i from
        the network's live state, its history ``width`` and ``hdtype``)
        is kept in ``_programs`` under ``(shuffle, accum, guard,
        stride)``, where the program contracts find it."""
        from deeplearning4j_tpu_torch.nn.fused import _map

        net = self.network
        width = 1 + int(guarded) + (4 if stride else 0)
        hdtype = torch.promote_types(net._policy.output_dtype, torch.float32)

        def step(i: int, it: int):
            # resolved per call: a reshard between chunks swaps both
            batch = _map(lambda a: a[i], cache.batch_stacks())
            return self._sharded_step(
                net.params, net.updater_state, net.net_state, it, batch,
                self._cache_group(cache), accum, guarded, stride, net._rng)

        def launch(k: int):
            # a parked rank computes nothing: it receives the lead's rows
            n = cache.n_batches
            out = (torch.zeros if self._parked else torch.empty)(
                (k, n, width), dtype=hdtype, device=net.device)
            it = net.iteration_count
            for e in range(k if not self._parked else 0):
                for j, i in enumerate(self._plan(n, shuffle)):
                    p, u, s, loss, tripped, mets = step(i, it)
                    net.params, net.updater_state, net.net_state = p, u, s
                    vals = [loss.reshape(1)]
                    if guarded:
                        vals.append(tripped.reshape(1))
                    if stride:
                        vals.append(mets)
                    out[e, j] = torch.cat([v.to(hdtype) for v in vals])
                    net._train_dispatches += 1
                    it += 1
            if self._partial:
                dist.broadcast(out, src=self._lead)
            hist = out[..., 0].contiguous()
            trips = out[..., 1] != 0 if guarded else None
            mets = (out[..., width - 4:].to(torch.float32)
                    if stride else None)
            return hist, trips, mets

        self._programs[(shuffle, accum, guarded, stride)] = (
            types.SimpleNamespace(launch=launch, step=step, width=width,
                                  hdtype=hdtype, cache=cache))
        return launch

    def _sharded_step(self, params, upd, nst, it: int, batch, group,
                      accum: int, guarded: bool, stride: int, gen):
        """One step on this rank's rows that equals the global batch's:
        the network's ``_variant_step`` inside a data-parallel loss scope
        over ``group`` (none when every rank holds the whole batch), with
        BatchNorm's statistics over it. Under FSDP ``params``/``upd``
        are this rank's parts: the step runs on the gathered state and
        keeps this rank's part of the result. Returns ``(params, updater
        state, net state, loss, tripped, metrics)``."""
        from deeplearning4j_tpu_torch.nn.layers.normalization import (
            sync_batch_stats)
        from deeplearning4j_tpu_torch.ops.losses import data_parallel_loss

        net = self.network
        fsdp = self._fsdp_reg
        if fsdp is not None:
            params = fsdp.gather(params)
            upd = fsdp.gather_state(upd)
        itt = torch.full((), it, dtype=torch.int32, device=net.device)
        lr = torch.full((), net._lr_scale_host, dtype=torch.float32,
                        device=net.device)
        scope = (contextlib.nullcontext() if group is None else
                 data_parallel_loss(group, self.data_parallelism))
        with scope, sync_batch_stats(group):
            p, u, s, loss, tripped, mets = net._variant_step(
                params, upd, nst, itt, lr, batch, gen, accum, guarded,
                stride)
        if fsdp is not None:
            p = fsdp.place(p)
            u = fsdp.place_state(u)
        return p, u, s, loss, tripped, mets

    def _plan(self, n: int, shuffle: bool):
        """This epoch's batch order, the same list in every member: drawn
        by the lead from the network's generator and broadcast to the
        members (with ``None`` every rank draws it from the same
        stream)."""
        from deeplearning4j_tpu_torch.perf.epoch_cache import epoch_schedule

        net = self.network
        if not shuffle:
            order = list(range(n))
        elif self.mesh is None:
            order = epoch_schedule(net._rng, n, True).tolist()
        else:
            box = [epoch_schedule(net._rng, n, True).tolist()
                   if dist.get_rank() == self._lead else None]
            dist.broadcast_object_list(box, src=self._lead,
                                       group=self._members)
            order = box[0]
        self._epoch_plans.append(order)
        return order

    def _lead_generator_state(self):
        """The lead's generator state, in every member (the ``raise``
        replay redraws the lead's plans from it); a parked rank's own."""
        state = [self.network._rng.get_state()]
        if self.mesh is not None and not self._parked:
            dist.broadcast_object_list(state, src=self._lead,
                                       group=self._members)
        return state[0]

    def _agree(self, stop: bool) -> None:
        """Every rank must leave a chunk with the same decision: the same
        stop and the same pending reshard. ``RuntimeError`` where they
        differ (the ranks would otherwise enter different collectives)."""
        pending = getattr(self.network, "_pending_mesh", None)
        mine = (stop, pending is not None,
                None if pending is None else _mesh_key(pending[0]))
        views = [None] * world_size()
        dist.all_gather_object(views, mine)
        if any(v != views[0] for v in views):
            raise RuntimeError(
                "the ranks disagree at a chunk boundary (stop, reshard "
                f"target) by rank: {views}; on_chunk and listeners must "
                "decide alike in every rank")

    def output(self, x):
        """The whole batch's output in every rank: each rank's forward
        runs on its rows, the rows are gathered. Batches that do not
        divide the data axis run whole."""
        net = self.network
        x = torch.as_tensor(x)
        dp = self.data_parallelism
        with self._whole_params():
            if self._group is None or x.shape[0] % dp:
                return net.output(x)
            local = net.output(local_chunk(x, 0, dp, self._rank))
            return all_gather(local, self._group, 0)

    # -- model-like surface so trainers (early stopping, solvers) can use
    #    the wrapper interchangeably with the wrapped network -----------
    @property
    def score_value(self) -> float:
        return self.network.score_value

    def score(self, ds) -> float:
        """The global batch's loss with each rank scoring its rows."""
        net = self.network
        dp = self.data_parallelism
        with self._whole_params():
            if self._group is None or ds.num_examples() % dp:
                return net.score(ds)
            rows = [None if a is None else
                    net._dev(local_chunk(torch.as_tensor(a), 0, dp,
                                         self._rank))
                    for a in (ds.features, ds.labels, ds.labels_mask)]
            with torch.no_grad():
                out = net._infer(rows[0])
                num, den = loss_sums(net._output_conf.loss_function, out,
                                     rows[1], rows[2])
                num = all_reduce_(num.clone(), self._group)
                den = all_reduce_(den.clone(), self._group)
                val = num / torch.clamp(den, min=1.0)
                for i, impl in enumerate(net.layers):
                    penalty = impl.l1_l2_penalty(net.params[str(i)])
                    if penalty is not None:
                        val = val + penalty
        net.score_value = val
        return net.score_value

    def clone(self):
        return self.network.clone()

    @property
    def conf(self):
        return self.network.conf

    def evaluate(self, data):
        """Distributed evaluation: each batch's forward split over the
        mesh, the per-batch Evaluations merged on the host (the
        reference's map-side evaluate + ``Evaluation.merge``)."""
        import numpy as np

        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation

        if isinstance(data, DataSet):
            batches = [data]
        else:
            if hasattr(data, "reset"):
                data.reset()
            batches = data
        total = Evaluation()
        for ds in batches:
            out = self.output(ds.features).float().cpu().numpy()
            part = Evaluation()
            part.eval(np.asarray(torch.as_tensor(ds.labels).cpu()), out,
                      mask=None if ds.labels_mask is None
                      else np.asarray(torch.as_tensor(ds.labels_mask).cpu()))
            total.merge(part)
        return total


class ParameterAveragingTrainer:
    """Reference-parity DP: R independent replicas + periodic averaging.

    Semantics match SparkDl4jMultiLayer with ``averageEachIteration=
    false``: each replica runs ``averaging_frequency`` local updater
    steps on its own shard of every global batch, then params AND updater
    state are averaged across replicas (UpdaterAggregator behaviour).
    """

    def __init__(self, network, num_replicas: Optional[int] = None,
                 averaging_frequency: int = 1, mesh=None):
        network._ensure_init()
        self.network = network
        self.mesh = mesh
        dp = data_axis_size(mesh)
        self.num_replicas = num_replicas or dp
        self.averaging_frequency = max(1, averaging_frequency)
        # replicas over 'data' when they divide evenly, else every rank
        # runs all of them (placement here is an optimisation, not
        # semantics)
        split = self.num_replicas % dp == 0
        self._group = axis_group(mesh, DATA_AXIS) if split else None
        self._n_local = self.num_replicas // dp if split else \
            self.num_replicas
        self._first = axis_rank(mesh, DATA_AXIS) * self._n_local \
            if split else 0
        self._stacked: Optional[Any] = None  # [R_local, ...] params
        self._stacked_upd: Optional[Any] = None
        self._local_steps = 0

    def _stack(self, tree):
        r = self._n_local
        return tree_map(lambda p: p[None].expand((r,) + tuple(p.shape))
                        .clone(), tree)

    def _replica_grads(self, stacked, xs, ys):
        """Loss and gradients of every local replica on its rows, one
        ``torch.func.vmap`` of ``torch.func.grad_and_value``."""
        from torch.func import grad_and_value, vmap

        net = self.network
        state = net.net_state

        def one_replica(params, x, y):
            loss, _ = net._loss_and_state(params, state, x, y, None, None,
                                          rng=None, train=True)
            return loss

        return vmap(grad_and_value(one_replica))(stacked, xs, ys)

    def fit(self, data, num_epochs: int = 1):
        batches = [data] if isinstance(data, DataSet) else data
        for _ in range(num_epochs):
            if hasattr(batches, "reset"):
                batches.reset()
            for ds in batches:
                self._fit_one(ds)
        self._sync_down(force=True)
        return self

    def _fit_one(self, ds: DataSet):
        net = self.network
        if any(True for _ in tree_leaves(net.net_state)):
            raise ValueError(
                "ParameterAveragingTrainer: the network carries net state "
                "(BatchNorm statistics), which independent replicas would "
                "each change; train it with ParallelWrapper")
        r = self.num_replicas
        n = ds.num_examples()
        if n % r:
            raise ValueError(f"batch {n} not divisible by {r} replicas")
        if self._stacked is None:
            self._stacked = self._stack(net.params)
            self._stacked_upd = self._stack(net.updater_state)
        per = n // r
        lo, hi = self._first * per, (self._first + self._n_local) * per
        xs = net._dev(torch.as_tensor(ds.features)[lo:hi])
        ys = net._dev(torch.as_tensor(ds.labels)[lo:hi])
        xs = xs.reshape((self._n_local, per) + tuple(xs.shape[1:]))
        ys = ys.reshape((self._n_local, per) + tuple(ys.shape[1:]))
        grads, losses = self._replica_grads(self._stacked, xs, ys)
        it = torch.full((), net.iteration_count, dtype=torch.int32,
                        device=net.device)
        new_p, new_u = [], []
        for i in range(self._n_local):
            p_i, u_i = net._apply_updaters(
                tree_map(lambda a: a[i], self._stacked),
                tree_map(lambda a: a[i], self._stacked_upd),
                tree_map(lambda a: a[i], grads), it)
            new_p.append(p_i)
            new_u.append(u_i)
        self._stacked = _stack_trees(new_p)
        self._stacked_upd = _stack_trees(new_u)
        loss = losses.sum()
        if self._group is not None:
            loss = all_reduce_(loss, self._group)
        net.score_value = loss / r
        self._local_steps += 1
        if self._local_steps % self.averaging_frequency == 0:
            self._sync_down()
        net._post_iteration()

    def _average(self, stacked):
        def mean(a):
            s = a.sum(0)
            if self._group is not None:
                all_reduce_(s, self._group)
            return s / self.num_replicas

        return tree_map(mean, stacked)

    def _sync_down(self, force: bool = False):
        """Average replicas → params (+ updater state), restack."""
        if self._stacked is None:
            return
        net = self.network
        net.params = self._average(self._stacked)
        net.updater_state = self._average(self._stacked_upd)
        if force:
            self._stacked = None
            self._stacked_upd = None
        else:
            self._stacked = self._stack(net.params)
            self._stacked_upd = self._stack(net.updater_state)


def _mesh_key(mesh):
    """What identifies a reshard target across ranks: its axes, their
    sizes and the world ranks it spans."""
    if mesh is None:
        return None
    return (tuple(mesh.mesh_dim_names), tuple(int(d) for d in mesh.shape),
            tuple(mesh_ranks(mesh)))


def _broadcast_tree(tree, src: int):
    """Every tensor leaf of ``tree`` as world rank ``src`` holds it,
    broadcast over the world (each other rank receives into a copy of its
    own leaf, which must have the same shape)."""
    me = dist.get_rank()

    def one(t):
        if not isinstance(t, torch.Tensor):
            return t
        buf = t.detach().contiguous()
        if me != src:
            buf = buf.clone()
        dist.broadcast(buf.view(torch.uint8) if buf.dtype == torch.bool
                       else buf, src)
        return buf

    return tree_map(one, tree)


def _adopt_state(net, src: int, trees, adopt: bool = True) -> None:
    """``(params, updater state, net state)``, whole, broadcast from world
    rank ``src``; the network takes them where ``adopt``."""
    params, upd, nst = _broadcast_tree(trees, src)
    if adopt:
        net.params, net.updater_state, net.net_state = params, upd, nst


def _adopt_host_state(net, src: int, adopt: bool) -> None:
    """The network's host state as world rank ``src`` holds it: the
    generator, the iteration count, the learning-rate scale, the epoch
    cursor and the score; the network takes it where ``adopt``."""
    score = net._score
    if isinstance(score, torch.Tensor):
        score = score.detach().cpu()
    box = [(net._rng.get_state(), net.iteration_count, net._lr_scale_host,
            getattr(net, "_epoch_cursor", None), score)]
    dist.broadcast_object_list(box, src=src)
    if not adopt:
        return
    gen, net.iteration_count, net._lr_scale_host, cursor, score = box[0]
    net._rng.set_state(gen)
    if cursor is not None:
        net._epoch_cursor = cursor
    net._score = (score.to(net.device) if isinstance(score, torch.Tensor)
                  else score)


def _stack_trees(trees):
    """``[tree, ...]`` of one structure → one tree of stacked leaves."""
    leaves = [tree_leaves(t) for t in trees]
    return _rebuild(trees[0], [torch.stack(parts) for parts in
                               zip(*leaves)])
