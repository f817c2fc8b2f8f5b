"""ComputationGraph: DAG networks with several inputs and outputs, on torch.

Port of ``deeplearning4j_tpu/nn/graph.py`` (the reference's
``nn/graph/ComputationGraph.java`` and the vertex impls in
``nn/graph/vertex/impl/``). The forward walks ``conf.topological_order``
once per call: each layer vertex runs its layer (after its
preprocessor), each other vertex its tensor op. A step takes the path of
``MultiLayerNetwork._sgd_step``: one compute copy of the params (bf16
under master weights), every output head's loss plus L1/L2,
``torch.autograd.grad``, the grads upcast once, and the updaters on
multi-tensor kernels (``grouped_apply_updaters`` over ``(name, spec)``).
BatchNorm's new running statistics replace ``net_state``. The iteration
and the LR scale are device tensors, so the step reads nothing back; the
host LR scale (``_lr_scale_host``, which the ``halve_lr`` guard policy
halves) enters the LR product of the guarded step, as in the reference.
Truncated BPTT and ``rnn_time_step`` are the MLN's, with the carries
keyed by layer name; static 2-D inputs go whole to every window.

The fused paths are the MLN's (``nn/fused.py``): ``fit_steps``,
``fit_epochs`` over ``DeviceMultiDataSetCache`` with the sentinel,
telemetry and accumulation, and the TBPTT window scan, each replaying one
captured CUDA graph per step on the card.

The graph runs on the CUDA card unless it is given ``device="cpu"``;
with no card and no device it raises. Training over a device mesh
(``mesh=``, ``request_reshard``) raises ``NotImplementedError`` naming
ROADMAP A14.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.dtypes import policy_from_name, tree_leaves, tree_map
from deeplearning4j_tpu_torch.nn.conf.enums import BackpropType
from deeplearning4j_tpu_torch.nn.conf.graph import (
    ComputationGraphConfiguration,
    DuplicateToTimeSeriesVertex,
    ElementWiseVertex,
    GraphVertexConf,
    LastTimeStepVertex,
    MergeVertex,
    PreprocessorVertex,
    ScaleVertex,
    StackVertex,
    SubsetVertex,
    UnstackVertex,
)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    InputPreProcessor,
    apply_preprocessor,
)
from deeplearning4j_tpu_torch.nn.layers import get_layer_impl
from deeplearning4j_tpu_torch.nn.layers.recurrent import zero_rnn_state
from deeplearning4j_tpu_torch.nn.fused import FusedTraining
from deeplearning4j_tpu_torch.nn.multilayer import (
    _as_batches,
    _host,
    _is_temporal,
    _named_leaves,
    copy_model_state,
    to_device,
)
from deeplearning4j_tpu_torch.nn.conf.enums import LearningRatePolicy
from deeplearning4j_tpu_torch.nn.updater import UpdaterSpec, init_updater_state
from deeplearning4j_tpu_torch.ops.losses import compute_loss
from deeplearning4j_tpu_torch.perf.device_eval import confusion_update
from deeplearning4j_tpu_torch.perf.epoch_cache import DeviceMultiDataSetCache


def _as_mds(data) -> MultiDataSet:
    return MultiDataSet.from_dataset(data) if isinstance(data, DataSet) else data


def _slice_time(batch, start: int, end: int):
    """A device batch (inputs, labels, feature masks, label masks) cut to
    the ``[start, end)`` window: temporal ``[b, t, ...]`` arrays and the
    ``[b, t]`` masks are cut, 2-D inputs and labels pass whole."""
    def cut(a):
        return a[:, start:end] if a.ndim >= 3 else a

    def cut_masks(ms):
        return None if ms is None else [
            None if m is None else m[:, start:end] for m in ms]

    inputs, labels, fms, lms = batch
    return ([cut(f) for f in inputs], [cut(l) for l in labels],
            cut_masks(fms), cut_masks(lms))


class ComputationGraph(FusedTraining):
    _CACHE = DeviceMultiDataSetCache
    _FALLBACKS = "TBPTT / iterations > 1"
    # the reference's unguarded graph step leaves the host LR scale out
    _PLAIN_STEP_HOST_LR = False

    def __init__(self, conf: ComputationGraphConfiguration,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.conf = conf
        self._policy = policy_from_name(conf.global_conf.dtype_policy)
        self.layer_impls = {n: get_layer_impl(lc, self._policy)
                            for n, lc in conf.layers.items()}
        self.params: Dict[str, Any] = {}
        self.net_state: Dict[str, Any] = {}
        self.updater_state: Dict[str, Any] = {}
        self.updater_specs: Dict[str, UpdaterSpec] = {}
        self.iteration_count = 0
        self._score: Any = float("nan")
        self.listeners: List[Any] = []
        self._init_fused()
        self._initialized = False
        # dropout draws, on the graph's device
        self._rng = torch.Generator(device=self.device).manual_seed(
            conf.global_conf.seed)
        self._eval_readbacks = 0  # host transfers made by evaluate() calls
        self._rnn_state: Dict[str, Any] = {}  # rnn_time_step's carries

    @property
    def score_value(self) -> float:
        """Most recent loss. Reading it waits for the device: the step
        stores the loss as a device scalar so steps queue without a sync."""
        return float(self._score)

    @score_value.setter
    def score_value(self, v) -> None:
        self._score = v

    # ------------------------------------------------------------------
    def init(self) -> "ComputationGraph":
        """Draw every layer's params, in ``sorted(name)`` order as the
        reference splits its key, from one CPU generator seeded with the
        conf's seed (the same weights on every device), then move them and
        the layers' state to the graph's device."""
        if self._initialized:
            return self
        gc = self.conf.global_conf
        gen = torch.Generator().manual_seed(gc.seed)
        to_dev = lambda t: t.to(self.device)  # noqa: E731
        for name in sorted(self.layer_impls):
            impl = self.layer_impls[name]
            self.params[name] = tree_map(to_dev, impl.init_params(gen))
            self.net_state[name] = tree_map(to_dev, impl.init_state())
        self.updater_specs = {
            n: UpdaterSpec.from_layer_conf(
                lc, gc.learning_rate, momentum_schedule=gc.momentum_schedule)
            for n, lc in self.conf.layers.items()}
        self.updater_state = {
            n: init_updater_state(spec, self.params[n])
            for n, spec in self.updater_specs.items()}
        self._initialized = True
        return self

    def _ensure_init(self):
        if not self._initialized:
            self.init()

    def _batch(self, mds: MultiDataSet):
        """A MultiDataSet's arrays on the graph's device: (inputs, labels,
        feature masks or None, label masks or None)."""
        dev = lambda xs: (None if xs is None  # noqa: E731
                          else [to_device(x, self.device) for x in xs])
        return (dev(mds.features), dev(mds.labels), dev(mds.features_masks),
                dev(mds.labels_masks))

    # ------------------------------------------------------------------
    # forward over the topological order
    # ------------------------------------------------------------------
    def _forward(self, params, net_state, inputs: Sequence[torch.Tensor], *,
                 train: bool, rng, feature_masks: Optional[Sequence] = None,
                 collect: bool = False, rnn_state: Optional[dict] = None):
        """Returns (the outputs in ``conf.outputs`` order, or every
        vertex's value by name when ``collect``; the new net state; the
        recurrent layers' new carries, or None without ``rnn_state``, which
        maps a layer's name to its initial ``h``/``c``)."""
        conf = self.conf
        values: Dict[str, torch.Tensor] = {}
        masks: Dict[str, Optional[torch.Tensor]] = {}
        for i, name in enumerate(conf.inputs):
            values[name] = inputs[i]
            masks[name] = None if feature_masks is None else feature_masks[i]
        new_net_state: Dict[str, Any] = {}
        new_rnn_state = {} if rnn_state is not None else None
        for name in conf.topological_order:
            if name in conf.inputs:
                continue
            in_names = conf.vertex_inputs[name]
            in_vals = [values[n] for n in in_names]
            in_mask = next((masks[n] for n in in_names
                            if masks.get(n) is not None), None)
            if name in conf.layers:
                h = in_vals[0]
                pre = conf.preprocessors.get(name)
                if pre is not None:
                    h, rng = apply_preprocessor(pre, h, batch=h.shape[0],
                                                rng=rng)
                lstate = net_state.get(name, {})
                carry = None if rnn_state is None else rnn_state.get(name)
                h, lstate_out = self.layer_impls[name].forward(
                    params[name], h, {**lstate, **(carry or {})},
                    train=train, rng=rng,
                    mask=in_mask if h.ndim == 3 else None)
                if carry is not None:
                    new_rnn_state[name] = {k: lstate_out[k] for k in carry}
                new_net_state[name] = {k: v for k, v in lstate_out.items()
                                       if k in lstate}
                values[name] = h
            else:
                values[name] = self._apply_vertex(conf.vertices[name],
                                                  in_vals, values, masks)
            masks[name] = in_mask
        if collect:
            return values, new_net_state, new_rnn_state
        return [values[o] for o in conf.outputs], new_net_state, new_rnn_state

    @staticmethod
    def _apply_vertex(vertex: GraphVertexConf, in_vals, values, masks):
        if isinstance(vertex, MergeVertex):
            return torch.cat(in_vals, dim=-1)
        if isinstance(vertex, ElementWiseVertex):
            op = vertex.op
            out = in_vals[0]
            for v in in_vals[1:]:
                if op in ("Add", "Average"):
                    out = out + v
                elif op == "Subtract":
                    out = out - v
                elif op == "Product":
                    out = out * v
                elif op == "Max":
                    out = torch.maximum(out, v)
                else:
                    raise ValueError(f"unknown elementwise op {op}")
            if op == "Average":
                out = out / float(len(in_vals))
            return out
        if isinstance(vertex, SubsetVertex):  # to_index is inclusive
            return in_vals[0][..., vertex.from_index:vertex.to_index + 1]
        if isinstance(vertex, LastTimeStepVertex):
            x = in_vals[0]  # [b, t, f]
            mask = (None if vertex.mask_input is None
                    else masks.get(vertex.mask_input))
            if mask is None:
                return x[:, -1, :]
            # the last step the mask keeps, per example
            idx = torch.clamp(mask.to(torch.int64).sum(dim=1) - 1, min=0)
            return x[torch.arange(x.shape[0], device=x.device), idx]
        if isinstance(vertex, DuplicateToTimeSeriesVertex):
            x = in_vals[0]  # [b, f]
            t = values[vertex.input_name].shape[1]
            return x[:, None, :].expand(x.shape[0], t, x.shape[1])
        if isinstance(vertex, ScaleVertex):
            return in_vals[0] * vertex.scale
        if isinstance(vertex, StackVertex):
            return torch.cat(in_vals, dim=0)
        if isinstance(vertex, UnstackVertex):
            x = in_vals[0]
            n = x.shape[0] // vertex.stack_size
            return x[vertex.from_index * n:(vertex.from_index + 1) * n]
        if isinstance(vertex, PreprocessorVertex):
            p = InputPreProcessor.from_dict(vertex.preprocessor)
            return p.pre_process(in_vals[0])
        raise ValueError(f"unknown vertex {type(vertex).__name__}")

    # ------------------------------------------------------------------
    # loss over all output heads / gradients / the step
    # ------------------------------------------------------------------
    def _loss_and_state(self, params, net_state, inputs, labels,
                        feature_masks, label_masks, rng, train: bool,
                        rnn_state=None):
        """Every head's loss plus L1/L2, and (new net state, new rnn
        carries)."""
        outs, new_state, new_rnn = self._forward(
            params, net_state, inputs, train=train, rng=rng,
            feature_masks=feature_masks, rnn_state=rnn_state)
        total = 0.0
        for i, out_name in enumerate(self.conf.outputs):
            lc = self.conf.layers.get(out_name)
            if lc is None or not hasattr(lc, "loss_function"):
                continue
            lm = None if label_masks is None else label_masks[i]
            total = total + compute_loss(lc.loss_function, outs[i],
                                         labels[i], lm)
        for name, impl in self.layer_impls.items():
            penalty = impl.l1_l2_penalty(params[name])
            if penalty is not None:
                total = total + penalty
        return total, (new_state, new_rnn)

    def _loss_grads(self, params, net_state, inputs, labels,
                    feature_masks=None, label_masks=None, rng=None,
                    rnn_state=None):
        """Training loss, (new net state, new rnn carries) and the gradient
        tree of ``params`` (under master weights their bf16 copy). A param
        no loss head reaches gets a zero gradient, as under ``jax.grad``."""
        fwd = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, states = self._loss_and_state(
            fwd, net_state, inputs, labels, feature_masks, label_masks, rng,
            train=True, rnn_state=rnn_state)
        grads = iter(torch.autograd.grad(loss, tree_leaves(fwd),
                                         allow_unused=True,
                                         materialize_grads=True))
        return loss.detach(), states, tree_map(lambda _: next(grads), fwd)

    def _update_items(self):
        return list(self.updater_specs.items())

    def _state_key_order(self):
        return (list(self.updater_specs),
                [n for n in self.conf.topological_order
                 if n in self.layer_impls])

    def _accum_loss_grads(self, params, net_state, batch, rng, k: int):
        """Loss and gradients of one step as ``k`` accumulated
        microbatches: every head's loss is its masked mean scaled by the
        microbatch's share of that head's full-batch mask, plus 1/k of the
        L1/L2 penalty. Returns ``(grads, loss, new net state)``."""
        d_full = [torch.clamp(m.sum(), min=1.0) for m in batch[3]]

        def micro_loss(p, nst, mb, rng):
            inputs, labels, fms, lms = mb
            outs, st, _ = self._forward(p, nst, inputs, train=True, rng=rng,
                                        feature_masks=fms)
            total = 0.0
            for i, out_name in enumerate(self.conf.outputs):
                lc = self.conf.layers.get(out_name)
                if lc is None or not hasattr(lc, "loss_function"):
                    continue
                core = compute_loss(lc.loss_function, outs[i], labels[i],
                                    lms[i])
                total = total + core * (torch.clamp(lms[i].sum(), min=1.0)
                                        / d_full[i])
            for name, impl in self.layer_impls.items():
                penalty = impl.l1_l2_penalty(p[name])
                if penalty is not None:
                    total = total + penalty / k
            return total, st

        return self._accum_micro(params, net_state, batch, rng, k,
                                 micro_loss)

    def _sgd_step(self, inputs, labels, feature_masks=None,
                  label_masks=None, rnn_state=None):
        """One eager optimizer step on device tensors; returns the
        recurrent layers' new carries (``None`` without ``rnn_state``)."""
        return self._sgd_step_batch((inputs, labels, feature_masks,
                                     label_masks), rnn_state)

    def _post_iteration(self):
        self.iteration_count += 1
        for listener in self.listeners:
            listener.iteration_done(self, self.iteration_count)

    # ------------------------------------------------------------------
    # fit (ComputationGraph.fit :449-563)
    # ------------------------------------------------------------------
    def fit(self, data, labels=None, num_epochs: int = 1):
        """fit(MultiDataSet | DataSet) / fit(features, labels) /
        fit(iterator, num_epochs)."""
        self._ensure_init()
        if labels is not None:
            data = MultiDataSet(
                data if isinstance(data, (list, tuple)) else [data],
                labels if isinstance(labels, (list, tuple)) else [labels])
        if isinstance(data, (DataSet, MultiDataSet)):
            self._fit_batches([data])
            return self
        for _ in range(num_epochs):
            if hasattr(data, "reset"):
                data.reset()
            self._fit_batches(data)
        return self

    def _is_tbptt(self, mds: MultiDataSet) -> bool:
        return (self.conf.backprop_type == BackpropType.TRUNCATED_BPTT
                and any(_is_temporal(f) for f in mds.features))

    def _fit_batches(self, batches):
        for mds in batches:
            mds = _as_mds(mds)
            if self._is_tbptt(mds):
                self._fit_tbptt(mds)
                continue
            batch = self._batch(mds)
            for _ in range(max(1, self.conf.global_conf.iterations)):
                self._sgd_step(*batch)
                self._post_iteration()

    def _fit_tbptt(self, mds: MultiDataSet):
        """Truncated BPTT over the DAG (ComputationGraph.java:489-534): the
        MLN's window loop, its full windows replayed under the same
        condition. The time length is the longest 3-D input's."""
        gc = self.conf.global_conf
        iterations = max(1, gc.iterations)
        window = self.conf.tbptt_fwd_length
        batch = self._batch(mds)
        t = max(f.shape[1] for f in batch[0] if _is_temporal(f))
        rnn_state = self._zero_rnn_state(mds.num_examples())
        n_full = t // window
        start = 0
        if (rnn_state is not None and n_full > 1 and iterations == 1
                and gc.lr_policy != LearningRatePolicy.SCORE
                and not self.listeners):
            rnn_state = self._fused_tbptt(batch, n_full, window)
            start = n_full * window
        for start in range(start, t, window):
            sub = _slice_time(batch, start, min(start + window, t))
            for _ in range(iterations):
                new_rnn = self._sgd_step(*sub, rnn_state)
                self._post_iteration()
            if new_rnn is not None:  # truncation: no gradient crosses
                rnn_state = tree_map(torch.Tensor.detach, new_rnn)

    def _zero_rnn_state(self, batch: int) -> Optional[Dict[str, Any]]:
        return zero_rnn_state(self.conf.layers.items(), batch, self.device,
                              self._policy.output_dtype)

    def fit_steps(self, data, n_steps: int):
        """``fit(data)`` called ``n_steps`` times: the batch moves to the
        device once, then ``n_steps · conf.iterations`` steps replay one
        captured step (the reference fuses them into one XLA program).
        Listeners fire once, after the block. TBPTT falls back to a plain
        ``fit`` loop."""
        self._ensure_init()
        mds = _as_mds(data)
        if self._is_tbptt(mds):
            for _ in range(n_steps):
                self.fit(mds)
            return self
        self._fused_fit_steps(
            self._batch(mds),
            n_steps * max(1, self.conf.global_conf.iterations))
        for listener in self.listeners:
            listener.iteration_done(self, self.iteration_count)
        return self

    # ------------------------------------------------------------------
    # the fused epoch path (fit_epochs, build_epoch_cache: nn/fused.py)
    # ------------------------------------------------------------------
    def fused_epochs_supported(self) -> bool:
        """The graph's per-step path has no solver or SCORE handling, so
        only TBPTT and ``iterations > 1`` fall back, as in the reference."""
        return (self.conf.backprop_type != BackpropType.TRUNCATED_BPTT
                and max(1, self.conf.global_conf.iterations) == 1)

    # ------------------------------------------------------------------
    # rnnTimeStep (ComputationGraph.java:1285): stateful stepping
    # ------------------------------------------------------------------
    def rnn_clear_previous_state(self):
        self._rnn_state = {}

    def rnn_time_step(self, *inputs) -> List[torch.Tensor]:
        """The outputs for ``[b, t, f]`` inputs (or all ``[b, f]``, one
        step, which gives 2-D outputs) from the hidden state the last call
        left; the state starts at zero, at the first call's batch size."""
        self._ensure_init()
        xs = [to_device(x, self.device) for x in inputs]
        single_step = all(x.ndim == 2 for x in xs)
        if single_step:
            xs = [x[:, None, :] for x in xs]
        if not self._rnn_state:
            self._rnn_state = self._zero_rnn_state(xs[0].shape[0]) or {}
        with torch.no_grad():
            outs, _, new_rnn = self._forward(
                self.params, self.net_state, xs, train=False, rng=None,
                rnn_state=self._rnn_state)
        if new_rnn:
            self._rnn_state = new_rnn
        if single_step:
            outs = [o[:, 0, :] if o.ndim == 3 else o for o in outs]
        return outs

    # ------------------------------------------------------------------
    # inference / scoring
    #
    # The reference pads every batch up a bucket ladder so that XLA
    # compiles once per bucket. Inference here is eager and compiles
    # nothing per shape, so it does not pad; on the fused training paths
    # each batch shape is one CUDA-graph capture, and the epoch cache
    # pads every batch to one bucket.
    # ------------------------------------------------------------------
    def _infer(self, inputs, collect: bool = False):
        with torch.no_grad():
            out, _, _ = self._forward(self.params, self.net_state, inputs,
                                      train=False, rng=None, collect=collect)
        return out

    def output(self, *inputs) -> List[torch.Tensor]:
        """The outputs, in ``conf.outputs`` order, for arrays or tensors."""
        self._ensure_init()
        return self._infer([to_device(x, self.device) for x in inputs])

    def feed_forward(self, *inputs) -> Dict[str, torch.Tensor]:
        """Every vertex's activation by name, the inputs included."""
        self._ensure_init()
        return self._infer([to_device(x, self.device) for x in inputs],
                           collect=True)

    def score(self, mds) -> float:
        self._ensure_init()
        inputs, labels, fms, lms = self._batch(_as_mds(mds))
        with torch.no_grad():
            self._score, _ = self._loss_and_state(
                self.params, self.net_state, inputs, labels, fms, lms,
                rng=None, train=False)
        return self.score_value

    def evaluate(self, iterator_or_ds, output_index: int = 0,
                 device_accumulation: bool = True):
        """Classification metrics for one output head. By default the
        ``[C, C]`` confusion matrix accumulates on the device and comes
        back once per call; ``device_accumulation=False`` reads each
        batch's outputs back and accumulates in numpy."""
        from deeplearning4j_tpu_torch.eval import Evaluation

        self._ensure_init()
        ev = Evaluation()
        cm = None
        for ds in _as_batches(iterator_or_ds):
            inputs, labels, _, lms = self._batch(_as_mds(ds))
            out = self._infer(inputs)[output_index]
            y = labels[output_index]
            lm = None if lms is None else lms[output_index]
            if not device_accumulation:
                ev.eval(_host(y), _host(out),
                        mask=None if lm is None else _host(lm))
                continue
            if cm is None:
                cm = torch.zeros((int(y.shape[-1]),) * 2, dtype=torch.int32,
                                 device=self.device)
            cm = confusion_update(cm, out, y, lm)
        if cm is not None:
            self._eval_readbacks += 1
            ev.eval_confusion(cm.cpu().numpy())  # the one host transfer
        return ev

    # ------------------------------------------------------------------
    # params surface
    # ------------------------------------------------------------------
    def num_params(self) -> int:
        """Counted from the layers' shapes; no weight is drawn."""
        return sum(impl.num_params() for impl in self.layer_impls.values())

    def get_param_table(self) -> Dict[str, np.ndarray]:
        """Flat ``"<layer>_<param>"`` table, layers in sorted order."""
        self._ensure_init()
        return {f"{name}_{path}": _host(leaf)
                for name in sorted(self.params)
                for path, leaf in _named_leaves(self.params[name])}

    def set_listeners(self, *listeners):
        self.listeners = list(listeners)

    def clone(self) -> "ComputationGraph":
        self._ensure_init()
        other = ComputationGraph(self.conf.clone(), device=self.device)
        copy_model_state(self, other)
        return other
