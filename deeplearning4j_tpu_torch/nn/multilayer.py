"""MultiLayerNetwork: the primary user API (sequential networks), on torch.

Port of ``deeplearning4j_tpu/nn/multilayer.py`` (the reference's
``nn/multilayer/MultiLayerNetwork.java``). A step is the reference's
``_step_impl`` in torch: forward through the preprocessors and layers,
loss plus L1/L2, ``torch.autograd.grad``, per-layer gradient
normalization and the updaters on multi-tensor kernels
(``grouped_apply_updaters``). Params, updater state and the batch stay
on the network's device; the step reads nothing back to the host, and
``score_value`` keeps the loss as a device scalar until it is read.

``fit`` runs one eager step per batch. The fused paths the reference
compiles into one XLA program each (``fit_steps``, ``fit_epochs`` over
the device cache with its sentinel, telemetry and accumulation, and the
full windows of truncated BPTT) replay one captured CUDA graph per step
on the card (``nn/fused.py``, ``perf/step_graph.py``); on the CPU the
same step runs eagerly in the same loop.

Truncated BPTT (``_fit_tbptt``) is the reference's window loop: one
step per window of ``tbptt_fwd_length`` timesteps, the recurrent layers'
``h``/``c`` carried from window to window and detached at each boundary.
``rnn_time_step`` carries the same state across calls for generation.

The network runs on the CUDA card unless it is given ``device="cpu"``;
with no card and no device it raises. What the port leaves out raises
``NotImplementedError`` naming its ROADMAP item: pretraining (A10.3),
solvers for a non-SGD ``optimization_algo`` (A10.4), and training over a
device mesh (``mesh=``, ``request_reshard``: A14).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.dtypes import policy_from_name, tree_leaves, tree_map
from deeplearning4j_tpu_torch.nn.conf.enums import (
    BackpropType,
    LearningRatePolicy,
    OptimizationAlgorithm,
)
from deeplearning4j_tpu_torch.nn.conf.neural_net import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.preprocessors import apply_preprocessor
from deeplearning4j_tpu_torch.nn.layers import get_layer_impl
from deeplearning4j_tpu_torch.nn.fused import FusedTraining
from deeplearning4j_tpu_torch.nn.layers.recurrent import zero_rnn_state
from deeplearning4j_tpu_torch.nn.updater import UpdaterSpec, init_updater_state
from deeplearning4j_tpu_torch.ops.losses import compute_loss, per_example_loss
from deeplearning4j_tpu_torch.perf.epoch_cache import DeviceDataSetCache
from deeplearning4j_tpu_torch.perf.device_eval import (
    RegressionStats,
    confusion_update,
    init_regression_sums,
    regression_update,
)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


class MultiLayerNetwork(FusedTraining):
    _CACHE = DeviceDataSetCache
    _FALLBACKS = ("non-SGD solver / TBPTT / pretraining / SCORE policy / "
                  "iterations > 1")

    def __init__(self, conf: MultiLayerConfiguration,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.conf = conf
        self._policy = policy_from_name(conf.global_conf.dtype_policy)
        self.layers = [get_layer_impl(lc, self._policy) for lc in conf.layers]
        self.params: Dict[str, Any] = {}
        self.net_state: Dict[str, Any] = {}
        self.updater_state: Dict[str, Any] = {}
        self.updater_specs: List[UpdaterSpec] = []
        self.iteration_count = 0
        self._score: Any = float("nan")
        self.listeners: List[Any] = []
        self._init_fused()
        self._best_score = None
        self._initialized = False
        # dropout and sampling draws, on the network's device
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
    # init
    # ------------------------------------------------------------------
    def init(self) -> "MultiLayerNetwork":
        """Draw every layer's params from one CPU generator seeded with the
        conf's seed (so a seed gives the same weights on every device),
        then move them to the network's device."""
        if self._initialized:
            return self
        gc = self.conf.global_conf
        gen = torch.Generator().manual_seed(gc.seed)
        for i, impl in enumerate(self.layers):
            self.params[str(i)] = tree_map(lambda t: t.to(self.device),
                                           impl.init_params(gen))
            self.net_state[str(i)] = tree_map(lambda t: t.to(self.device),
                                              impl.init_state())
        self.updater_specs = [
            UpdaterSpec.from_layer_conf(lc, gc.learning_rate,
                                        momentum_schedule=gc.momentum_schedule)
            for lc in self.conf.layers]
        self.updater_state = {
            str(i): init_updater_state(spec, self.params[str(i)])
            for i, spec in enumerate(self.updater_specs)}
        self._initialized = True
        return self

    def _ensure_init(self):
        if not self._initialized:
            self.init()

    def _dev(self, x) -> Optional[torch.Tensor]:
        return to_device(x, self.device)

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def _forward(self, params, net_state, x, *, train: bool, rng,
                 feature_mask=None, rnn_state: Optional[dict] = None,
                 collect: bool = False):
        """Apply preprocessors + layers. ``rnn_state`` maps a recurrent
        layer's index to its initial ``h``/``c``. Returns (out,
        new_net_state, the new carries or None, activations or None)."""
        batch = x.shape[0]
        activations = [x] if collect else None
        new_net_state = {}
        new_rnn_state = {} if rnn_state is not None else None
        h = x
        for i, impl in enumerate(self.layers):
            pre = self.conf.input_preprocessors.get(i)
            if pre is not None:
                h, rng = apply_preprocessor(pre, h, batch=batch, rng=rng)
            si = str(i)
            lstate = dict(net_state.get(si, {}))
            carry = None if rnn_state is None else rnn_state.get(si)
            if carry is not None:
                lstate.update(carry)
            mask = feature_mask if h.ndim == 3 else None
            h, lstate_out = impl.forward(params[si], h, lstate, train=train,
                                         rng=rng, mask=mask)
            if carry is not None:
                new_rnn_state[si] = {k: lstate_out[k] for k in carry}
            new_net_state[si] = {k: v for k, v in lstate_out.items()
                                 if k in net_state.get(si, {})}
            if collect:
                activations.append(h)
        return h, new_net_state, new_rnn_state, activations

    # ------------------------------------------------------------------
    # loss / gradients / the step
    # ------------------------------------------------------------------
    @property
    def _output_conf(self):
        last = self.conf.layers[-1]
        if not hasattr(last, "loss_function"):
            raise ValueError(
                "last layer has no loss function (need OutputLayer/LossLayer)")
        return last

    def _loss_and_state(self, params, net_state, x, y, feature_mask,
                        label_mask, rng, train: bool, rnn_state=None):
        """Loss plus L1/L2, and (new net state, new rnn carries)."""
        out, new_state, new_rnn, _ = self._forward(
            params, net_state, x, train=train, rng=rng,
            feature_mask=feature_mask, rnn_state=rnn_state)
        loss = compute_loss(self._output_conf.loss_function, out, y,
                            label_mask)
        for i, impl in enumerate(self.layers):
            penalty = impl.l1_l2_penalty(params[str(i)])
            if penalty is not None:
                loss = loss + penalty
        return loss, (new_state, new_rnn)

    def _loss_grads(self, params, net_state, x, y, feature_mask=None,
                    label_mask=None, rng=None, rnn_state=None):
        """Training loss, (new net state, new rnn carries) and the gradient
        tree of ``params`` (the tree the forward ran on: under master
        weights its bf16 copy)."""
        fwd = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, states = self._loss_and_state(
            fwd, net_state, x, y, feature_mask, label_mask, rng, train=True,
            rnn_state=rnn_state)
        grads = iter(torch.autograd.grad(loss, tree_leaves(fwd)))
        return loss.detach(), states, tree_map(lambda _: next(grads), fwd)

    def _update_items(self):
        return [(str(i), spec) for i, spec in enumerate(self.updater_specs)]

    def _state_key_order(self):
        keys = [str(i) for i in range(len(self.layers))]
        return keys, keys

    def _accum_loss_grads(self, params, net_state, batch, rng, k: int):
        """Loss and gradients of one step as ``k`` accumulated
        microbatches: each microbatch's loss is its masked mean scaled by
        its share of the full batch's mask (``d_mb / d_full``) plus 1/k
        of the L1/L2 penalty. Returns ``(grads, loss, new net state)``."""
        d_full = torch.clamp(batch[3].sum(), min=1.0)

        def micro_loss(p, nst, mb, rng):
            x, y, fm, lm = mb
            out, st, _, _ = self._forward(p, nst, x, train=True, rng=rng,
                                          feature_mask=fm)
            core = compute_loss(self._output_conf.loss_function, out, y, lm)
            loss = core * (torch.clamp(lm.sum(), min=1.0) / d_full)
            for i, impl in enumerate(self.layers):
                penalty = impl.l1_l2_penalty(p[str(i)])
                if penalty is not None:
                    loss = loss + penalty / k
            return loss, st

        return self._accum_micro(params, net_state, batch, rng, k,
                                 micro_loss)

    def _sgd_step(self, x, y, feature_mask=None, label_mask=None,
                  rnn_state=None):
        """One eager optimizer step on device tensors; returns the
        recurrent layers' new carries (``None`` without ``rnn_state``)."""
        return self._sgd_step_batch((x, y, feature_mask, label_mask),
                                    rnn_state)

    # ------------------------------------------------------------------
    # fit
    # ------------------------------------------------------------------
    def fit(self, data, labels=None, feature_mask=None, label_mask=None,
            num_epochs: int = 1):
        """fit(DataSetIterator) / fit(DataSet) / fit(features, labels)."""
        self._ensure_init()
        if labels is not None:
            data = DataSet(data, labels, feature_mask, label_mask)
        if hasattr(data, "features"):  # single DataSet
            self._fit_batches([data])
            return self
        for _ in range(num_epochs):
            if hasattr(data, "reset"):
                data.reset()
            self._fit_batches(data)
        return self

    def _fit_batches(self, batches):
        # pretrain layers are not registered (ROADMAP A10.3), so a conf
        # with ``pretrain=True`` has no layer to pretrain
        gc = self.conf.global_conf
        if not self.conf.backprop:
            return
        for ds in batches:
            if (self.conf.backprop_type == BackpropType.TRUNCATED_BPTT
                    and _is_temporal(ds.features)):
                self._fit_tbptt(ds)
                continue
            if (gc.optimization_algo
                    != OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT):
                raise _not_ported(f"the {gc.optimization_algo.value} solver",
                                  "A10.4")
            x, y = self._dev(ds.features), self._dev(ds.labels)
            fm, lm = self._dev(ds.features_mask), self._dev(ds.labels_mask)
            for _ in range(max(1, gc.iterations)):
                self._sgd_step(x, y, fm, lm)
                self._post_iteration()

    def _fit_tbptt(self, ds):
        """Truncated BPTT (doTruncatedBPTT): the batch moves to the device
        once, then each window of ``tbptt_fwd_length`` timesteps (the tail
        shorter) takes ``conf.iterations`` steps from the carry the last
        window left, detached at the boundary. A 2-D label stays whole for
        every window. The reference ignores ``tbptt_back_length``, and so
        does the port. Where the reference fuses the full windows into one
        program (carries present, more than one full window, one
        iteration, not SCORE, no listeners: then the loop cannot be told
        apart), the port replays one captured window step per full
        window; the short tail runs eagerly, as in the reference."""
        gc = self.conf.global_conf
        iterations = max(1, gc.iterations)
        window = self.conf.tbptt_fwd_length
        ds = DataSet(self._dev(ds.features), self._dev(ds.labels),
                     self._dev(ds.features_mask), self._dev(ds.labels_mask))
        t = ds.features.shape[1]
        rnn_state = self._zero_rnn_state(ds.num_examples())
        n_full = t // window
        start = 0
        if (rnn_state is not None and n_full > 1 and iterations == 1
                and gc.lr_policy != LearningRatePolicy.SCORE
                and not self.listeners):
            rnn_state = self._fused_tbptt(
                (ds.features, ds.labels, ds.features_mask, ds.labels_mask),
                n_full, window)
            start = n_full * window
        for start in range(start, t, window):
            sub = ds.slice_time(start, min(start + window, t))
            for _ in range(iterations):
                new_rnn = self._sgd_step(sub.features, sub.labels,
                                         sub.features_mask, sub.labels_mask,
                                         rnn_state)
                self._post_iteration()
            if new_rnn is not None:  # truncation: no gradient crosses
                rnn_state = tree_map(torch.Tensor.detach, new_rnn)

    def _zero_rnn_state(self, batch: int) -> Optional[Dict[str, Any]]:
        return zero_rnn_state(
            ((str(i), lc) for i, lc in enumerate(self.conf.layers)), batch,
            self.device, self._policy.output_dtype)

    def fit_steps(self, ds, n_steps: int):
        """``fit(ds)`` called ``n_steps`` times: the batch moves to the
        device once, then ``n_steps · conf.iterations`` steps replay one
        captured step (the reference fuses them into one XLA program).
        Listeners fire once, after the block. Falls back to a plain
        ``fit`` loop for the score-reactive LR policy (a host decision per
        step) and for what ``fit`` itself falls back on."""
        self._ensure_init()
        gc = self.conf.global_conf
        if not self.conf.backprop and not self.conf.pretrain:
            return self  # fit() trains nothing in this configuration
        if (gc.optimization_algo != OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT
                or (self.conf.backprop_type == BackpropType.TRUNCATED_BPTT
                    and _is_temporal(ds.features))
                or self.conf.pretrain
                or gc.lr_policy == LearningRatePolicy.SCORE):
            for _ in range(n_steps):
                self.fit(ds)
            return self
        batch = (self._dev(ds.features), self._dev(ds.labels),
                 self._dev(ds.features_mask), self._dev(ds.labels_mask))
        self._fused_fit_steps(batch, n_steps * max(1, gc.iterations))
        for listener in self.listeners:
            listener.iteration_done(self, self.iteration_count)
        return self

    def _post_iteration(self):
        self.iteration_count += 1
        gc = self.conf.global_conf
        if (gc.lr_policy == LearningRatePolicy.SCORE
                and gc.lr_score_based_decay_rate > 0):
            if self._best_score is None or self.score_value < self._best_score:
                self._best_score = self.score_value
            elif self.score_value > self._best_score:
                self._lr_scale_host *= (1.0 - gc.lr_score_based_decay_rate)
        for listener in self.listeners:
            listener.iteration_done(self, self.iteration_count)

    # ------------------------------------------------------------------
    # the fused epoch path (fit_epochs, build_epoch_cache: nn/fused.py)
    # ------------------------------------------------------------------
    def fused_epochs_supported(self) -> bool:
        """Whether this configuration can run the fused epoch path: the
        ``fit_steps`` fallback matrix plus ``iterations == 1``."""
        gc = self.conf.global_conf
        return (gc.optimization_algo
                == OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT
                and self.conf.backprop_type != BackpropType.TRUNCATED_BPTT
                and not self.conf.pretrain
                and gc.lr_policy != LearningRatePolicy.SCORE
                and max(1, gc.iterations) == 1)

    def _fit_trains_nothing(self) -> bool:
        return not self.conf.backprop and not self.conf.pretrain

    def pretrain(self, batches):
        raise _not_ported("layerwise pretraining", "A10.3")

    # ------------------------------------------------------------------
    # rnnTimeStep (:1208): stateful stepping for generation
    # ------------------------------------------------------------------
    def rnn_clear_previous_state(self):
        self._rnn_state = {}

    def rnn_time_step(self, x) -> torch.Tensor:
        """``x [b, t, f]`` (or ``[b, f]`` for one step, which gives a 2-D
        output) from the hidden state the last call left; the state starts
        at zero, at the batch size of the first call after a clear."""
        self._ensure_init()
        x = self._dev(x)
        single_step = x.ndim == 2
        if single_step:
            x = x[:, None, :]
        if not self._rnn_state:
            self._rnn_state = self._zero_rnn_state(x.shape[0]) or {}
        with torch.no_grad():
            out, _, new_rnn, _ = self._forward(
                self.params, self.net_state, x, train=False, rng=None,
                rnn_state=self._rnn_state)
        if new_rnn:
            self._rnn_state = new_rnn
        if single_step and out.ndim == 3:
            out = out[:, 0, :]
        return out

    # ------------------------------------------------------------------
    # inference / scoring
    #
    # The reference pads every batch up a bucket ladder so that XLA
    # compiles once per bucket. Inference here is eager and compiles
    # nothing per shape, so it does not pad. Shapes cost something only
    # on the fused training paths, where each distinct batch shape is one
    # CUDA-graph capture: the epoch cache pads every batch to one bucket,
    # and ``BucketedDataSetIterator`` pads a stream's ragged tail.
    # ------------------------------------------------------------------
    def _infer(self, x) -> torch.Tensor:
        with torch.no_grad():
            out, _, _, _ = self._forward(self.params, self.net_state, x,
                                         train=False, rng=None)
        return out

    def output(self, x, train: bool = False) -> torch.Tensor:
        """Network output for ``x``, a tensor on the network's device."""
        self._ensure_init()
        return self._infer(self._dev(x))

    def feed_forward(self, x) -> List[torch.Tensor]:
        """All layer activations, input first (feedForward :586)."""
        self._ensure_init()
        with torch.no_grad():
            _, _, _, acts = self._forward(self.params, self.net_state,
                                       self._dev(x), train=False, rng=None,
                                       collect=True)
        return acts

    def predict(self, x) -> np.ndarray:
        """Class indices; the argmax runs on the device, so [B] int32 comes
        back rather than [B, C] outputs."""
        out = self.output(x)
        return torch.argmax(out, dim=-1).to(torch.int32).cpu().numpy()

    def score(self, ds=None, x=None, y=None) -> float:
        self._ensure_init()
        if ds is not None:
            x, y = ds.features, ds.labels
            fm, lm = ds.features_mask, ds.labels_mask
        else:
            fm = lm = None
        with torch.no_grad():
            val, _ = self._loss_and_state(
                self.params, self.net_state, self._dev(x), self._dev(y),
                self._dev(fm), self._dev(lm), rng=None, train=False)
        self._score = val
        return self.score_value

    def score_examples(self, ds) -> np.ndarray:
        """Per-example losses (ScoreExamplesFunction parity)."""
        out = self.output(ds.features)
        with torch.no_grad():
            per = per_example_loss(self._output_conf.loss_function, out,
                                   self._dev(ds.labels))
        return per.cpu().numpy()

    def evaluate(self, iterator_or_ds, device_accumulation: bool = True):
        """Classification metrics over a DataSet or iterator.

        By default the ``[C, C]`` confusion matrix accumulates on the
        device and comes back once per call. ``device_accumulation=False``
        reads each batch's outputs back and accumulates in numpy."""
        from deeplearning4j_tpu_torch.eval import Evaluation

        self._ensure_init()
        ev = Evaluation()
        if not device_accumulation:
            for ds in _as_batches(iterator_or_ds):
                out = self.output(ds.features)
                ev.eval(_host(ds.labels), out.cpu().numpy(),
                        mask=None if ds.labels_mask is None
                        else _host(ds.labels_mask))
            return ev
        cm = None
        for ds in _as_batches(iterator_or_ds):
            y = self._dev(ds.labels)
            if cm is None:
                cm = torch.zeros((int(y.shape[-1]),) * 2, dtype=torch.int32,
                                 device=self.device)
            cm = confusion_update(cm, self._infer(self._dev(ds.features)), y,
                                  self._dev(ds.labels_mask))
        if cm is not None:
            self._eval_readbacks += 1
            ev.eval_confusion(cm.cpu().numpy())  # the one host transfer
        return ev

    def evaluate_regression(self, iterator_or_ds) -> RegressionStats:
        """Per-column regression stats; the sums stay on the device and
        come back once per call."""
        self._ensure_init()
        sums = None
        for ds in _as_batches(iterator_or_ds):
            y = self._dev(ds.labels)
            if sums is None:
                sums = init_regression_sums(int(y.shape[-1]), self.device)
            with torch.no_grad():
                sums = regression_update(
                    sums, self._infer(self._dev(ds.features)), y,
                    self._dev(ds.labels_mask))
        if sums is None:
            sums = init_regression_sums(0)
        else:
            self._eval_readbacks += 1
        return RegressionStats(sums)

    def f1_score(self, ds) -> float:
        return self.evaluate(ds).f1()

    # ------------------------------------------------------------------
    # params surface (pack/unpack :940-1013)
    # ------------------------------------------------------------------
    def num_params(self) -> int:
        """Counted from the layers' shapes; no weight is drawn."""
        return sum(impl.num_params() for impl in self.layers)

    def get_flat_params(self) -> np.ndarray:
        """All params as one vector in (layer, sorted-param-name) order, the
        reference's order."""
        self._ensure_init()
        leaves = []
        for i in range(len(self.layers)):
            leaves.extend(_sorted_leaves(self.params[str(i)]))
        if not leaves:
            return np.zeros((0,), np.float32)
        return np.concatenate([_host(l).ravel() for l in leaves])

    def set_flat_params(self, flat) -> None:
        self._ensure_init()
        flat = np.asarray(flat)
        if flat.size != self.num_params():
            raise ValueError(f"param vector length {flat.size} != expected "
                             f"{self.num_params()}")
        offset = 0
        new_params = {}
        for i in range(len(self.layers)):
            new_params[str(i)], offset = _unflatten_like(
                self.params[str(i)], flat, offset)
        self.params = new_params

    def get_param_table(self) -> Dict[str, np.ndarray]:
        """Flat "0_W"-style param table (MultiLayerNetwork.java:1114)."""
        self._ensure_init()
        table = {}
        for i in range(len(self.layers)):
            for path, leaf in _named_leaves(self.params[str(i)]):
                table[f"{i}_{path}"] = _host(leaf)
        return table

    def set_param_table(self, table: Dict[str, np.ndarray]) -> None:
        self._ensure_init()
        for key, value in table.items():
            idx, path = key.split("_", 1)
            parts = path.split(".")
            node = self.params[idx]
            for p in parts[:-1]:
                node = node[p]
            old = node[parts[-1]]
            node[parts[-1]] = torch.as_tensor(
                np.asarray(value), dtype=old.dtype).to(self.device)

    def set_listeners(self, *listeners):
        self.listeners = list(listeners)

    def clone(self) -> "MultiLayerNetwork":
        self._ensure_init()
        other = MultiLayerNetwork(self.conf.clone(), device=self.device)
        copy_model_state(self, other)
        return other


def copy_model_state(src, dst) -> None:
    """Deep-copy trained state into a freshly built network."""
    dst.init()
    dst.params = tree_map(torch.clone, src.params)
    dst.net_state = tree_map(torch.clone, src.net_state)
    dst.updater_state = tree_map(torch.clone, src.updater_state)
    dst.iteration_count = src.iteration_count


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def to_device(x, device) -> Optional[torch.Tensor]:
    """A batch array on ``device`` (float64 host arrays become float32, as
    the reference's default dtype); a tensor already there is returned as
    is."""
    if x is None:
        return None
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        x = torch.from_numpy(a.astype(np.float32) if a.dtype == np.float64
                             else a)
    return x.to(device)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _is_temporal(x) -> bool:
    return getattr(x, "ndim", 0) == 3


def _as_batches(it):
    if hasattr(it, "features"):
        return [it]
    if hasattr(it, "reset"):
        it.reset()
    return it


def _sorted_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    return [tree]


def _named_leaves(tree, prefix=""):
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out.extend(_named_leaves(tree[k], f"{prefix}.{k}" if prefix else k))
    return out


def _unflatten_like(tree, flat, offset):
    if isinstance(tree, dict):
        new = {}
        for k in sorted(tree):
            new[k], offset = _unflatten_like(tree[k], flat, offset)
        return new, offset
    size = tree.numel()
    chunk = np.ascontiguousarray(flat[offset:offset + size]).reshape(
        tuple(tree.shape))
    return (torch.as_tensor(chunk, dtype=tree.dtype).to(tree.device),
            offset + size)
