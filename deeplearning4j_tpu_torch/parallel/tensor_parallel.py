"""Tensor parallelism (Megatron-style) over the ``model`` axis.

Port of ``deeplearning4j_tpu/parallel/tensor_parallel.py``: alternating
column/row parallelism for stacked dense-like layers — layer 2k's W is
column-sharded ``P(None, "model")``, layer 2k+1's W is row-sharded
``P("model", None)`` — recurrent layers column-shard the gate dimension,
embedding tables row-shard the vocab, convolutions shard their output
channels. The registry's ``for_network`` reads these specs.

The reference lets GSPMD partition the step along those specs;
:func:`shard_network_params` writes the collectives out by replacing
each split layer's implementation with one that runs on its shards:

- **dense pairs** — a column-split ``DenseLayer`` whose output feeds the
  row-split ``DenseLayer`` after it, and nothing else, run split: the
  input enters through f (``collectives.CopyToShardsFn``), the column
  layer computes its slice of the features, the row layer its partial
  product, one g sums the partials (an all-reduce in training, the
  fixed-order float64 sum in inference) and the row layer's bias is
  added once, after the sum; the row layer's dropout draws the unsharded
  layer's mask over the whole input and keeps this rank's columns;
- **every other split layer** (a column layer with no row partner,
  convolutions, LSTM/GRU gates, the row-split ``EmbeddingLayer``)
  gathers its weights over ``model`` for its own forward, as FSDP does,
  and keeps its own slice of the weight gradient without summing it:
  every model rank computed the same whole gradient. Splitting their
  compute is later speed work (ROADMAP).

Updater state is sharded like its parameter; the updaters are
elementwise, so each rank updates its own slices. Gradient
normalization by L2 norms (``*_PER_LAYER``, ``*_PER_PARAM_TYPE``) needs
the norm of the whole layer or leaf, as the reference's GSPMD program
takes it on its sharded leaves: each split layer's squared norms are
summed over ``model`` (``nn.updater.split_sq_norms``), every rank's
part of a split leaf counted once and a leaf every model rank holds
whole (a row layer's bias) once, in one all-reduce a step for all the
network's split layers. Over ``data × model`` the gradients are summed
over ``data`` first, so the norms are the global batch's.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.parallel.mesh import MODEL_AXIS
from deeplearning4j_tpu_torch.parallel.sharding_registry import (
    P, PartitionSpec, _entry_axes, _rebuild, _spec_leaves)


def _dense_spec(column: bool) -> Dict[str, P]:
    if column:
        return {"W": P(None, MODEL_AXIS), "b": P(MODEL_AXIS)}
    return {"W": P(MODEL_AXIS, None), "b": P()}


def _lstm_spec() -> Dict[str, P]:
    # gate dim (4n) column-sharded; recurrence contracts the replicated n
    return {"W": P(None, MODEL_AXIS), "RW": P(None, MODEL_AXIS),
            "b": P(MODEL_AXIS), "pI": P(MODEL_AXIS), "pF": P(MODEL_AXIS),
            "pO": P(MODEL_AXIS)}


def param_specs_for_network(conf) -> Dict[str, Any]:
    """PartitionSpec tree matching a MultiLayerConfiguration's param tree."""
    return param_specs_for_layers(
        (str(i), lc) for i, lc in enumerate(conf.layers))


def param_specs_for_layers(items) -> Dict[str, Any]:
    """The Megatron layer rules over any keyed layer-conf sequence —
    MultiLayerNetwork passes indexed layers, the sharding registry passes
    a ComputationGraph's named layers in topological order."""
    specs: Dict[str, Any] = {}
    dense_count = 0
    for si, lc in items:
        if isinstance(lc, (L.DenseLayer, L.OutputLayer, L.AutoEncoder)):
            # output layers stay replicated: their n_out is the class
            # count, usually tiny and followed by a softmax over the axis
            if isinstance(lc, L.OutputLayer):
                specs[si] = {k: P() for k in ("W", "b")}
                if isinstance(lc, L.AutoEncoder):
                    specs[si]["vb"] = P()
                continue
            specs[si] = _dense_spec(column=(dense_count % 2 == 0))
            if isinstance(lc, L.AutoEncoder):
                specs[si]["vb"] = P()
            dense_count += 1
        elif isinstance(lc, (L.GravesLSTM, L.LSTM)):
            specs[si] = _lstm_spec()
        elif isinstance(lc, L.GravesBidirectionalLSTM):
            specs[si] = {"fwd": _lstm_spec(), "bwd": _lstm_spec()}
        elif isinstance(lc, L.GRU):
            specs[si] = {"W": P(None, MODEL_AXIS), "RW": P(None, MODEL_AXIS),
                         "b": P(MODEL_AXIS)}
        elif isinstance(lc, L.EmbeddingLayer):
            specs[si] = {"W": P(MODEL_AXIS, None), "b": P()}
        elif isinstance(lc, L.ConvolutionLayer):
            # channels-out sharded: each model shard computes a slice of
            # output feature maps
            specs[si] = {"W": P(None, None, None, MODEL_AXIS),
                         "b": P(MODEL_AXIS)}
        else:
            specs[si] = _ReplicateAll()
    return specs


class _ReplicateAll:
    """Sentinel: replicate every leaf of this layer's params."""


def shard_network_params(network, mesh,
                         specs: Optional[Dict[str, Any]] = None) -> None:
    """Keep this rank's shards of a MultiLayerNetwork's or
    ComputationGraph's params and updater state under the Megatron specs
    (every rank holds the whole network before the call, as after
    ``init`` from one seed) and run its later steps, ``output`` and
    ``score`` on them over the mesh's ``model`` axis. ``specs`` (default
    the registry's ``for_network`` specs) is a spec tree over the
    network's params. Every rank then calls the same methods with the
    same batches. A ``model`` axis of 1 places nothing."""
    from deeplearning4j_tpu_torch.nn.updater import (
        L2_PER_LAYER, L2_PER_PARAM_TYPE)
    from deeplearning4j_tpu_torch.parallel.mesh import (
        axis_group, axis_size)
    from deeplearning4j_tpu_torch.parallel.sharding_registry import (
        ShardingRegistry, _divisible_or_replicated, _expand)

    network._ensure_init()
    reg = ShardingRegistry.for_network(network, mesh)
    if specs is not None:
        expanded = _expand(network.params, specs, (), reg.name)
        reg = ShardingRegistry(
            mesh, _divisible_or_replicated(network.params, expanded, mesh,
                                           reg.name), name=reg.name)
    if axis_size(mesh, MODEL_AXIS) == 1:
        return
    graph = isinstance(network.conf.layers, dict)
    impls = network.layer_impls if graph else dict(
        (str(i), impl) for i, impl in enumerate(network.layers))
    split = {k for k in impls if _is_split(reg.spec_tree[k])}
    group = axis_group(mesh, MODEL_AXIS)
    l2 = {k: _model_split(network.params[k], reg.spec_tree[k])
          for k in split if network.updater_specs[k if graph else int(k)]
          .gradient_normalization in L2_PER_LAYER + L2_PER_PARAM_TYPE}
    pairs = _dense_pairs(network, reg.spec_tree, graph)
    wrapped = {}
    for key, impl in impls.items():
        if key not in split:
            continue
        if key in pairs:
            wrapped[key] = _ColumnDense(impl, group)
        elif key in pairs.values():
            wrapped[key] = _RowDense(impl, group)
        else:
            wrapped[key] = _Gathered(impl, group, reg.spec_tree[key])
    reg.place_network(network)
    if graph:
        network.layer_impls.update(wrapped)
    else:
        for key, impl in wrapped.items():
            network.layers[int(key)] = impl
    network._tp_mesh = mesh
    network._split_norms = _SplitNorms(l2, group) if l2 else None


def unshard_network_params(network) -> None:
    """Undo :func:`shard_network_params`'s layer wrapping: the network
    runs its own layers again (the caller puts the whole params and
    updater state back, gathered while the mesh was in place). A network
    that was never split is left as it is."""
    if getattr(network, "_tp_mesh", None) is None:
        return
    if isinstance(network.conf.layers, dict):
        for key, impl in list(network.layer_impls.items()):
            if isinstance(impl, _ShardLayer):
                network.layer_impls[key] = impl.impl
    else:
        network.layers = [impl.impl if isinstance(impl, _ShardLayer)
                          else impl for impl in network.layers]
    network._tp_mesh = None
    network._split_norms = None
    network.__dict__.pop("_sharding_registry", None)


def _is_split(spec) -> bool:
    if isinstance(spec, PartitionSpec):
        return any(e is not None for e in spec)
    if isinstance(spec, dict):
        return any(_is_split(v) for v in spec.values())
    if isinstance(spec, (list, tuple)):
        return any(_is_split(v) for v in spec)
    return False


def _model_split(params, spec):
    """A layer's params as a tree of bools: ``True`` where the leaf is
    split over ``model`` by ``spec``."""
    return _rebuild(params, [any(MODEL_AXIS in _entry_axes(e) for e in s)
                             for s in _spec_leaves(spec)])


class _SplitNorms:
    """The squared gradient norms of the split layers whose updater
    normalizes by L2 norms, over the whole layers: one all-reduce over
    ``model`` a step (``nn.updater.split_sq_norms``). ``split`` maps each
    such layer's key to :func:`_model_split` of its specs."""

    def __init__(self, split: Dict[str, Any], group):
        self.split = split
        self.group = group

    def __call__(self, items, grads):
        from deeplearning4j_tpu_torch.nn.updater import split_sq_norms
        from deeplearning4j_tpu_torch.parallel.collectives import all_reduce_

        return split_sq_norms(items, grads, self.split,
                              lambda v: all_reduce_(v, self.group))


def _splittable_dense(lc) -> bool:
    return (type(lc) is L.DenseLayer
            and str(lc.activation).lower() != "softmax")


def _dense_pairs(network, spec_tree, graph: bool) -> Dict[str, str]:
    """``{column layer: row layer}`` for the dense pairs that run split:
    a column-split DenseLayer whose output feeds only the row-split
    DenseLayer after it (no preprocessor between, an elementwise
    activation)."""
    conf = network.conf
    col, row = P(None, MODEL_AXIS), P(MODEL_AXIS, None)

    def role(key, lc, want):
        return (_splittable_dense(lc) and isinstance(spec_tree[key], dict)
                and spec_tree[key].get("W") == want)

    pairs: Dict[str, str] = {}
    if graph:
        consumers: Dict[str, List[str]] = {}
        for name, ins in conf.vertex_inputs.items():
            for i in ins:
                consumers.setdefault(i, []).append(name)
        for name, lc in conf.layers.items():
            nxt = consumers.get(name, [])
            if (role(name, lc, col) and len(nxt) == 1
                    and name not in conf.outputs
                    and nxt[0] in conf.layers
                    and list(conf.vertex_inputs[nxt[0]]) == [name]
                    and nxt[0] not in conf.preprocessors
                    and role(nxt[0], conf.layers[nxt[0]], row)):
                pairs[name] = nxt[0]
        return pairs
    layers = conf.layers
    for i in range(len(layers) - 1):
        a, b = str(i), str(i + 1)
        if (role(a, layers[i], col) and role(b, layers[i + 1], row)
                and (i + 1) not in conf.input_preprocessors):
            pairs[a] = b
    return pairs


class _ShardLayer:
    """A layer implementation run on this rank's shards; everything but
    ``forward`` and ``l1_l2_penalty`` is the wrapped one's."""

    def __init__(self, impl, group):
        self.impl = impl
        self.group = group

    def __getattr__(self, name):
        return getattr(self.impl, name)

    def _sum(self, x, train: bool):
        from deeplearning4j_tpu_torch.parallel.collectives import (
            FixedOrderSumFn, SumSharesFn)

        return (SumSharesFn if train else FixedOrderSumFn).apply(
            x, self.group)

    def l1_l2_penalty(self, params):
        """The whole layer's penalty: the shards' penalties summed (each
        shard's gradient its own)."""
        from deeplearning4j_tpu_torch.parallel.collectives import SumSharesFn

        pen = self.impl.l1_l2_penalty(params)
        return None if pen is None else SumSharesFn.apply(pen, self.group)


class _ColumnDense(_ShardLayer):
    """The column half of a dense pair: f, then its slice of the
    features."""

    def forward(self, params, x, state, **kw):
        from deeplearning4j_tpu_torch.parallel.collectives import (
            CopyToShardsFn)

        return self.impl.forward(params, CopyToShardsFn.apply(x, self.group),
                                 state, **kw)


class _RowDense(_ShardLayer):
    """The row half of a dense pair: the partial product of its slice of
    the inputs, summed over ``model`` (g), then the bias, once, and the
    activation."""

    def forward(self, params, x, state, *, train=False, rng=None,
                mask=None):
        impl = self.impl
        if train and float(impl.conf.dropout or 0.0) > 0.0:
            x = self._dropout(x, rng)
        pol = impl.policy
        z = pol.cast_output(pol.cast_compute(x)
                            @ pol.cast_compute(params["W"]))
        z = self._sum(z, train) + params["b"]
        return impl.activation_fn()(z), state


    def _dropout(self, x, rng):
        """The unsharded layer's dropout of this rank's columns: the mask
        drawn over the whole input (every rank draws the same one, and
        the generator advances as in the unsharded layer), this rank's
        columns kept."""
        import torch.distributed as dist

        from deeplearning4j_tpu_torch.parallel.collectives import (
            GatherShardsFn)

        k, last = x.shape[-1], x.dim() - 1
        whole = self.impl.maybe_dropout(
            GatherShardsFn.apply(x, self.group, last), train=True, rng=rng)
        return whole.narrow(last, dist.get_rank(self.group) * k, k)


class _Gathered(_ShardLayer):
    """A split layer that runs whole: its shards gathered over
    ``model`` (``collectives.GatherShardsFn``: the backward keeps this
    rank's slice of the whole gradient)."""

    def __init__(self, impl, group, spec):
        super().__init__(impl, group)
        self.spec = spec

    def _whole(self, params, spec=None):
        from deeplearning4j_tpu_torch.parallel.collectives import (
            GatherShardsFn)

        spec = self.spec if spec is None else spec
        if isinstance(params, dict):
            return {k: self._whole(v, spec[k] if isinstance(spec, dict)
                                   else spec)
                    for k, v in params.items()}
        if not isinstance(spec, PartitionSpec):
            return params
        for dim, entry in enumerate(spec):
            if entry is not None:
                params = GatherShardsFn.apply(params, self.group, dim)
        return params

    def forward(self, params, x, state, **kw):
        return self.impl.forward(self._whole(params), x, state, **kw)

    def l1_l2_penalty(self, params):
        return self.impl.l1_l2_penalty(self._whole(params))
