"""Tensor-parallel sharding specs (Megatron-style) over the ``model`` axis.

The spec half of ``deeplearning4j_tpu/parallel/tensor_parallel.py``:
alternating column/row parallelism for stacked dense-like layers —
layer 2k's W is column-sharded ``P(None, "model")``, layer 2k+1's W is
row-sharded ``P("model", None)`` — recurrent layers column-shard the
gate dimension, embedding tables row-shard the vocab, convolutions
shard their output channels. The registry's ``for_network`` reads these
specs. Running a step over the shards (``shard_network_params``) is
ROADMAP A14.2 and raises.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.parallel.mesh import MODEL_AXIS
from deeplearning4j_tpu_torch.parallel.sharding_registry import P, a14_2


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
    raise a14_2("tensor_parallel.shard_network_params")
