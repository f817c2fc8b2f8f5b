"""The step variants and fused training paths both network classes share.

The reference writes these out in ``MultiLayerNetwork`` and
``ComputationGraph`` alike (``nn/multilayer.py:282-455``, ``:549-881``,
``:923-1013`` and ``nn/graph.py:545-1012``); the port keeps one copy
here, mixed into both classes, on top of four things each class defines:
``_loss_grads(params, net_state, *batch, rng, rnn_state)``,
``_accum_loss_grads(params, net_state, batch, rng, k)``, ``_update_items``
``_zero_rnn_state`` and ``_state_key_order``. A batch is a tuple ``(features, labels,
features_mask, labels_mask)``: tensors for a ``MultiLayerNetwork``,
lists of them for a ``ComputationGraph``.

Step variants, as pure functions of device tensors (the iteration and
the host LR scale included, so that the eager and the captured step are
one function):

- :meth:`_step_impl` — the plain step (with the recurrent carries);
- :meth:`_variant_step` — the accumulated step (``accum > 1``: the
  strided microbatch split, each microbatch's loss its share of the full
  batch's masked mean, gradients summed in the param dtype, one updater
  apply), the guarded step (the sentinel, then ``torch.where(ok, new,
  old)`` leaf by leaf: a blend ``new·ok + old·(1−ok)`` would turn
  ``NaN·0`` into NaN and flip the sign of ``−0``) and the telemetry step
  (the same math branch for branch, plus ``monitor.pack.step_metrics``).

Fused paths: ``fit_steps`` (one step replayed K times), ``fit_epochs``
(E x N steps over ``perf.epoch_cache``, one step replayed per batch) and
the TBPTT window scan (one window step replayed per full window). Each
runs a :class:`~deeplearning4j_tpu_torch.perf.step_graph.StepGraph` over
the network's :class:`StaticTrainState`: replays on the card, the same
step eagerly on the CPU. A network keeps one program per key, as the
reference keeps one jitted program per ``(shapes, dtypes, shuffle,
accum_steps, guard, metrics_stride)``; its graphs share one memory pool
(``perf.step_graph.GraphPool``), and an epoch program reads its cache
only while a ``fit_epochs`` call runs, so a program does not keep a
cache alive. The programs and the static state are dropped when the
structure of the params, updater state or net state or the dtype
policy changes.

``_train_dispatches`` counts graph replays plus eager steps: on the card
one per step, where the reference counts one per fused program.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from deeplearning4j_tpu_torch.dtypes import tree_leaves, tree_map
from deeplearning4j_tpu_torch.monitor import fused_metrics_stride
from deeplearning4j_tpu_torch.nn.updater import (
    grouped_apply_updaters,
    lr_policy_scale,
)
from deeplearning4j_tpu_torch.perf.epoch_cache import (
    accum_steps_default,
    drive_epoch_chunks,
    effective_accum_steps,
    epoch_schedule,
    mesh_not_ported,
    stream_epochs,
)
from deeplearning4j_tpu_torch.perf.step_graph import (
    GraphPool,
    StaticTrainState,
    StepGraph,
    copy_tree_,
    static_clone,
    tree_signature,
)


def _map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (tuples, lists,
    dicts), ``None`` leaves kept as ``None``."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_map(fn, *parts) for parts in zip(*trees))
    if t0 is None:
        return None
    return fn(*trees)


def _where_tree(ok: torch.Tensor, new, old):
    """``torch.where(ok, new, old)`` leaf by leaf (keys matched by name)."""
    if isinstance(old, dict):
        return {k: _where_tree(ok, new[k], old[k]) for k in old}
    return torch.where(ok, new, old)


class _Program:
    """A fused path's static buffers and its StepGraph."""

    def __init__(self, binding=None):
        self.binding = binding
        self.graph: Optional[StepGraph] = None


class FusedTraining:
    """Mixin of the step variants and fused paths (see the module)."""

    #: whether the plain (unguarded) step multiplies the host LR scale in:
    #: the reference's MultiLayerNetwork does, its ComputationGraph not
    _PLAIN_STEP_HOST_LR = True

    def _init_fused(self) -> None:
        self._lr_scale_host = 1.0  # SCORE decay and the halve_lr policy
        self._train_dispatches = 0  # graph replays plus eager steps
        self._programs: Dict[Any, _Program] = {}
        self._graph_pool = GraphPool()  # shared by all the programs' graphs
        self._static: Optional[StaticTrainState] = None
        self._static_sig = None
        self._last_sentinel = None  # [E, N] trip history of fit_epochs
        self._last_metrics = None  # [E, N, 4] metrics-pack history

    # ------------------------------------------------------------------
    # the step variants
    # ------------------------------------------------------------------
    def _lr_scale(self, iteration, lr_scale_host=None):
        """The LR policy's factor at ``iteration`` (a device int tensor),
        times the host scale when one is given."""
        gc = self.conf.global_conf
        scale = lr_policy_scale(
            gc.lr_policy, iteration, gc.lr_policy_decay_rate,
            gc.lr_policy_steps, gc.lr_policy_power, gc.lr_schedule,
            base_lr=gc.learning_rate)
        return scale if lr_scale_host is None else scale * lr_scale_host

    def _apply_updaters(self, params, updater_state, grads, iteration,
                        lr_scale_host=None):
        """LR schedule, updater math and parameter update on multi-tensor
        kernels, grouped by (spec, lr, dtype). Under master weights
        ``params`` are the f32 masters and ``grads`` arrive upcast."""
        return grouped_apply_updaters(
            self._update_items(), params, updater_state, grads,
            self._lr_scale(iteration, lr_scale_host), iteration + 1)

    def _plain_lr(self, lr):
        return lr if self._PLAIN_STEP_HOST_LR else None

    def _step_impl(self, params, updater_state, net_state, iteration, lr,
                   batch, rng, rnn_state=None):
        """One optimizer step: ``(params, updater state, net state, new
        carries or None, loss)``. Master weights: one compute copy for
        forward and backward, the grads upcast once, the updater on the
        f32 masters."""
        pol = self._policy
        loss, (new_state, new_rnn), grads = self._loss_grads(
            pol.compute_copy(params), net_state, *batch, rng, rnn_state)
        new_params, new_updater = self._apply_updaters(
            params, updater_state, pol.master_grads(grads), iteration,
            self._plain_lr(lr))
        return new_params, new_updater, new_state, new_rnn, loss

    def _variant_step(self, params, updater_state, net_state, iteration, lr,
                      batch, rng, accum: int, guard: bool, stride: int):
        """The fused epoch step: ``(params, updater state, net state,
        loss, tripped or None, [4] metrics or None)``. Accumulated when
        ``accum > 1``, under the sentinel when ``guard``, with the metrics
        pack when ``stride > 0``; with none of them, :meth:`_step_impl`."""
        if accum <= 1 and not guard and not stride:
            p2, u2, s2, _, loss = self._step_impl(
                params, updater_state, net_state, iteration, lr, batch, rng)
            return p2, u2, s2, loss, None, None
        pol = self._policy
        fwd = pol.compute_copy(params)
        if accum > 1:
            grads, loss, nst2 = self._accum_loss_grads(
                fwd, net_state, batch, rng, accum)
        else:
            loss, (nst2, _), grads = self._loss_grads(
                fwd, net_state, *batch, rng, None)
        # the sentinel and the norms read the f32 (master) grads: a bf16
        # overflow to inf survives the widening cast
        grads = pol.master_grads(grads)
        tripped = None
        step_lr = lr if guard else self._plain_lr(lr)
        new_params, new_updater = self._apply_updaters(
            params, updater_state, grads, iteration, step_lr)
        if guard:
            from deeplearning4j_tpu_torch.resilience.guard import (
                tree_all_finite)

            ok = torch.isfinite(loss) & tree_all_finite(grads)
            new_params = _where_tree(ok, new_params, params)
            new_updater = _where_tree(ok, new_updater, updater_state)
            nst2 = _where_tree(ok, nst2, net_state)
            tripped = ~ok
        metrics = None
        if stride:
            from deeplearning4j_tpu_torch.monitor.pack import step_metrics

            metrics = step_metrics(params, new_params, grads,
                                   self._lr_scale(iteration, step_lr),
                                   iteration, stride)
        return new_params, new_updater, nst2, loss, tripped, metrics

    def _accum_micro(self, params, net_state, batch, rng, k: int,
                     micro_loss):
        """The shared loop of ``_accum_loss_grads``: the batch split
        strided (row i to microbatch i % k), each microbatch's loss from
        ``micro_loss(params, net_state, micro_batch, rng) -> (loss, new
        net state)``, its gradients added into param-dtype sums and the
        net state threaded through. Returns ``(grads, loss, net state)``."""
        def split(a):
            return a.reshape((a.shape[0] // k, k) + tuple(a.shape[1:])
                             ).movedim(1, 0)

        parts = _map(split, batch)
        gsum = self._policy.grad_zeros(params)
        lsum = torch.zeros((), dtype=torch.float32, device=self.device)
        nst = net_state
        for j in range(k):
            fwd = tree_map(lambda p: p.detach().requires_grad_(), params)
            lval, nst = micro_loss(fwd, nst, _map(lambda a: a[j], parts),
                                   rng)
            grads = iter(torch.autograd.grad(lval, tree_leaves(fwd),
                                             allow_unused=True,
                                             materialize_grads=True))
            gsum = tree_map(lambda s: s + next(grads).to(s.dtype), gsum)
            lsum = lsum + lval.detach()
        return gsum, lsum, nst

    def _sgd_step_batch(self, batch, rnn_state=None):
        """One eager optimizer step on the live state. The iteration and
        the host LR scale reach the device as fill kernels (no copy, so
        the step never waits for the card); the captured paths read them
        from static buffers instead."""
        it = torch.full((), self.iteration_count, dtype=torch.int32,
                        device=self.device)
        lr = torch.full((), self._lr_scale_host, dtype=torch.float32,
                        device=self.device)
        (self.params, self.updater_state, self.net_state, new_rnn,
         loss) = self._step_impl(self.params, self.updater_state,
                                 self.net_state, it, lr, batch, self._rng,
                                 rnn_state)
        self._score = loss  # device scalar; no sync (see score_value)
        self._train_dispatches += 1
        return new_rnn

    # ------------------------------------------------------------------
    # static state and the program cache
    # ------------------------------------------------------------------
    def _fused_state(self) -> StaticTrainState:
        sig = (tree_signature(self.params), tree_signature(self.updater_state),
               tree_signature(self.net_state), self._policy)
        if self._static is None or sig != self._static_sig:
            self._programs.clear()
            self._static = StaticTrainState(self, self._state_key_order())
            self._static_sig = sig
        return self._static

    def _program(self, key, binding, build) -> _Program:
        """The cached program for ``key`` (built by ``build(state)``), or
        a new one when ``binding`` (the external buffers it reads) moved."""
        st = self._fused_state()
        prog = self._programs.get(key)
        if prog is None or prog.binding != binding:
            prog = build(st)
            prog.binding = binding
            self._programs[key] = prog
        return prog

    def _step_graph(self, body) -> StepGraph:
        return StepGraph(body, self.device, generators=(self._rng,),
                         pool=self._graph_pool)

    def _run(self, prog: _Program, n: int) -> None:
        for _ in range(n):
            prog.graph()
        self._train_dispatches += n

    # ------------------------------------------------------------------
    # fit_steps: one step replayed K times
    # ------------------------------------------------------------------
    def _fused_fit_steps(self, batch, total: int) -> None:
        """``total`` steps on one device batch; advances the iteration."""
        def build(st):
            prog = _Program()
            prog.batch = static_clone(batch)
            prog.loss = None

            def body():
                p2, u2, s2, _, loss = self._step_impl(
                    st.params, st.updater_state, st.net_state, st.it, st.lr,
                    prog.batch, self._rng)
                st.commit(p2, u2, s2)
                if prog.loss is None:  # the first (eager) step shapes it
                    prog.loss = torch.empty_like(loss)
                prog.loss.copy_(loss)

            prog.graph = self._step_graph(body)
            return prog

        prog = self._program(("fit_steps", tree_signature(batch)), None,
                             build)
        st = self._static
        st.load(self)
        copy_tree_(prog.batch, batch)
        self._run(prog, total)
        st.store(self)
        self._score = prog.loss.clone()
        self.iteration_count += total

    # ------------------------------------------------------------------
    # TBPTT: the full windows, one window step replayed per window
    # ------------------------------------------------------------------
    def _fused_tbptt(self, batch, n_full: int, window: int):
        """Train the ``n_full`` full windows of a device batch; returns
        the carries after the last of them (for the eager tail)."""
        def cut(pos):
            def f(a):
                if a.ndim < (2 if pos >= 2 else 3):
                    return a  # 2-D inputs and labels go whole to each window
                a = a[:, :n_full * window]
                return a.reshape((a.shape[0], n_full, window)
                                 + tuple(a.shape[2:])).movedim(1, 0)
            return f

        windows = tuple(_map(cut(pos), part) for pos, part in
                        enumerate(batch))
        whole = tuple(_map(lambda a: a.ndim < (2 if pos >= 2 else 3), part)
                      for pos, part in enumerate(batch))
        b = int(tree_leaves(batch[0])[0].shape[0])

        def build(st):
            prog = _Program()
            prog.windows = static_clone(windows)
            prog.carry = self._zero_rnn_state(b)
            prog.index = torch.zeros((1,), dtype=torch.int64,
                                     device=self.device)
            prog.loss = None

            def body():
                sub = _map(lambda a, w: a if w else
                           a.index_select(0, prog.index).squeeze(0),
                           prog.windows, whole)
                p2, u2, s2, rnn2, loss = self._step_impl(
                    st.params, st.updater_state, st.net_state, st.it, st.lr,
                    sub, self._rng, prog.carry)
                st.commit(p2, u2, s2)
                # truncation: the carry crosses the boundary as a value
                copy_tree_(prog.carry, tree_map(torch.Tensor.detach, rnn2))
                if prog.loss is None:
                    prog.loss = torch.empty_like(loss)
                prog.loss.copy_(loss)
                prog.index.add_(1)

            prog.graph = self._step_graph(body)
            return prog

        prog = self._program(("tbptt", tree_signature(windows), window), None,
                             build)
        st = self._static
        st.load(self)
        copy_tree_(prog.windows, windows)
        torch._foreach_zero_(tree_leaves(prog.carry))
        prog.index.zero_()
        self._run(prog, n_full)
        st.store(self)
        self._score = prog.loss.clone()
        self.iteration_count += n_full
        return prog.carry

    # ------------------------------------------------------------------
    # fit_epochs over the device cache
    # ------------------------------------------------------------------
    def build_epoch_cache(self, data, mesh=None,
                          accum_steps: Optional[int] = None):
        """Prebuild the device cache ``fit_epochs`` would build, on the
        network's device, so that callers re-running chunks pay the drain
        and transfer once. ``accum_steps=None`` reads ``DL4J_ACCUM_STEPS``
        (it prices the budget's working-set term)."""
        if mesh is not None:
            raise mesh_not_ported("build_epoch_cache(mesh=)")
        if accum_steps is None:
            accum_steps = accum_steps_default()
        return self._CACHE.build(data, accum_steps=accum_steps,
                                 device=self.device)

    def request_reshard(self, mesh) -> None:
        raise mesh_not_ported("request_reshard")

    def _fit_trains_nothing(self) -> bool:
        return False

    def fit_epochs(self, data, num_epochs: int, *, shuffle: bool = True,
                   chunk_epochs: Optional[int] = None,
                   cache_mb: Optional[float] = None, mesh=None,
                   accum_steps: Optional[int] = None,
                   guard: Optional[str] = None, telemetry=None,
                   on_chunk=None):
        """``fit(data)`` for ``num_epochs`` epochs with the dataset cached
        on the device and every step a replay of one captured step; the
        batch order is drawn on the device once per epoch. Returns the
        ``[E, N]`` loss history as a device tensor, or ``None`` when a
        fallback ran.

        ``data`` is an iterator, a list of batches, one batch, or a cache
        from ``build_epoch_cache``. ``chunk_epochs`` sets the epochs
        between host decision points (default: the whole run without
        listeners, one epoch with them); listeners fire once per chunk
        and ``on_chunk(epochs_done) -> bool`` can stop the run.
        ``accum_steps=K`` (default ``DL4J_ACCUM_STEPS``) runs each batch
        as K accumulated microbatches. ``guard`` (default
        ``DL4J_NAN_GUARD``, ``skip``) puts the numeric sentinel in the
        step: ``skip`` keeps a poisoned step's state, ``halve_lr`` also
        halves the host LR scale per tripped chunk, ``raise`` replays the
        chunk to name the batch and raises ``TrainingDivergedError``,
        ``off`` leaves the sentinel out; the ``[E, N]`` trip history lands
        in ``_last_sentinel``. ``telemetry`` (default ``DL4J_TELEMETRY``)
        adds the metrics pack, an ``[E, N, 4]`` history in
        ``_last_metrics``; params are the same with it or without.

        Fallbacks, as in the reference: the configurations
        ``fused_epochs_supported`` rejects run ``fit`` per epoch (and a
        cache passed for one raises), and a dataset over the budget
        (``DL4J_DEVICE_CACHE_MB``) streams. ``mesh=`` raises (A14)."""
        from deeplearning4j_tpu_torch.resilience.guard import nan_guard_policy

        self._ensure_init()
        if mesh is not None:
            raise mesh_not_ported("fit_epochs(mesh=)")
        if num_epochs <= 0 or self._fit_trains_nothing():
            return None
        if accum_steps is None:
            accum_steps = accum_steps_default()
        if not self.fused_epochs_supported():
            if isinstance(data, self._CACHE):
                raise ValueError(
                    "this configuration needs the per-step fit loop "
                    f"({self._FALLBACKS}) — pass the original iterator, "
                    f"not a {self._CACHE.__name__}")
            for _ in range(num_epochs):
                self.fit(data)
            return None
        cache = data if isinstance(data, self._CACHE) else (
            self._CACHE.build(data, budget_mb=cache_mb,
                              accum_steps=accum_steps, device=self.device))
        if cache is None:
            stream_epochs(self, data, num_epochs)
            return None
        if not _same_device(cache.device, self.device):
            raise ValueError(f"the cache lies on {cache.device}, the "
                             f"network on {self.device}")
        accum = effective_accum_steps(accum_steps, cache.batch)
        guard = nan_guard_policy() if guard is None else guard
        guarded = guard != "off"
        stride = fused_metrics_stride(telemetry)
        prog = self._epoch_program(cache, shuffle, accum, guarded, stride)
        stacks = cache.batch_stacks()
        prog.stacks = stacks  # bound for this call only

        def replay_step(params, upd, nst, it, i, gen):
            # the ``raise`` replay: the same step math on the same cache
            # slice with the same generator, accumulation split included
            batch = _map(lambda a: a[i], stacks)
            itt = torch.full((), it, dtype=torch.int32, device=self.device)
            lr = torch.full((), self._lr_scale_host, dtype=torch.float32,
                            device=self.device)
            p, u, s, loss, _, _ = self._variant_step(
                params, upd, nst, itt, lr, batch, gen, accum, False, 0)
            return p, u, s, loss

        try:
            return drive_epoch_chunks(self, cache, num_epochs, chunk_epochs,
                                      prog.launch, shuffle=shuffle,
                                      guard=guard, replay_step=replay_step,
                                      on_chunk=on_chunk)
        finally:
            prog.stacks = None

    def _epoch_program(self, cache, shuffle: bool, accum: int,
                       guarded: bool, stride: int) -> _Program:
        stacks = cache.batch_stacks()
        n = cache.n_batches
        # each step writes one row: the loss, the trip flag, the metrics
        width = 1 + int(guarded) + (4 if stride else 0)
        hdtype = torch.promote_types(self._policy.output_dtype,
                                     torch.float32)

        def build(st):
            prog = _Program()
            # the cache's stacks, bound by fit_epochs for one call: the
            # graph reads them at the addresses it was captured with (the
            # program's binding), and the program does not keep them alive
            prog.stacks = None
            prog.order = torch.arange(n, device=self.device)
            prog.cursor = torch.zeros((1,), dtype=torch.int64,
                                      device=self.device)
            prog.row = torch.zeros((n, width), dtype=hdtype,
                                   device=self.device)

            def body():
                i = prog.order.index_select(0, prog.cursor)
                batch = _map(lambda a: a.index_select(0, i).squeeze(0),
                             prog.stacks)
                p2, u2, s2, loss, tripped, metrics = self._variant_step(
                    st.params, st.updater_state, st.net_state, st.it, st.lr,
                    batch, self._rng, accum, guarded, stride)
                st.commit(p2, u2, s2)
                vals = [loss.reshape(1)]
                if guarded:
                    vals.append(tripped.reshape(1))
                if stride:
                    vals.append(metrics)
                vec = torch.cat([v.to(hdtype) for v in vals])
                prog.row.index_copy_(0, prog.cursor, vec[None])
                prog.cursor.copy_(torch.remainder(prog.cursor + 1, n))

            prog.graph = self._step_graph(body)

            def launch(k: int):
                st.load(self)
                prog.cursor.zero_()
                out = torch.empty((k, n, width), dtype=hdtype,
                                  device=self.device)
                for e in range(k):
                    if shuffle:
                        epoch_schedule(self._rng, n, True, out=prog.order)
                    self._run(prog, n)
                    out[e].copy_(prog.row)
                st.store(self)
                hist = out[..., 0].contiguous()
                trips = out[..., 1] != 0 if guarded else None
                mets = (out[..., width - 4:].to(torch.float32)
                        if stride else None)
                return hist, trips, mets

            prog.launch = launch
            return prog

        key = ("fit_epochs", tree_signature(stacks), shuffle, accum,
               guarded, stride)
        binding = tuple(a.data_ptr() for a in _flat(stacks))
        return self._program(key, binding, build)


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` and ``cuda:0`` name one card (the current one)."""
    def index(d):
        return (torch.cuda.current_device() if d.type == "cuda"
                and d.index is None else d.index)

    return a.type == b.type and index(a) == index(b)


def _flat(tree):
    """The non-None leaves of a batch-shaped tree."""
    out = []
    _map(lambda a: out.append(a), tree)
    return out
