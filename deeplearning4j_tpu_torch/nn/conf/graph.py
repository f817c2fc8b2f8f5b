"""ComputationGraphConfiguration + GraphBuilder (DAG config DSL).

Copy of ``deeplearning4j_tpu/nn/conf/graph.py`` on the port's ``nn/conf``
modules: the same vertices, builder, shape inference and JSON (``to_dict``
is key for key the reference's, so a graph JSON written by either package
loads in the other). YAML and the reference-format JSON are not ported
yet (ROADMAP A10.6).

Mirror of ``nn/conf/ComputationGraphConfiguration.java:446`` — GraphBuilder
(addLayer :569, addInputs :605, addVertex :649, setOutputs :633, validate
:214, topological sort :295-331) and the conf-side vertex types in
``nn/conf/graph/`` (MergeVertex, ElementWiseVertex Add/Subtract/Product,
SubsetVertex, LastTimeStepVertex, DuplicateToTimeSeriesVertex).
"""

from __future__ import annotations

import copy
import dataclasses
import json
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.nn.conf.enums import BackpropType
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import LayerConf
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    GlobalConf,
    _compat_not_ported,
    apply_layer_defaults,
)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import InputPreProcessor

_VERTEX_REGISTRY: Dict[str, type] = {}


def register_vertex(cls):
    _VERTEX_REGISTRY[cls.__name__] = cls
    return cls


@dataclasses.dataclass
class GraphVertexConf:
    """Base class for non-layer vertices."""

    def to_dict(self) -> dict:
        d = {"type": type(self).__name__}
        d.update(
            {
                f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None
            }
        )
        return d

    @staticmethod
    def from_dict(d: dict) -> "GraphVertexConf":
        d = dict(d)
        cls = _VERTEX_REGISTRY[d.pop("type")]
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@register_vertex
@dataclasses.dataclass
class MergeVertex(GraphVertexConf):
    """Concatenate inputs along the feature/channel (last) axis
    (nn/graph/vertex/impl/MergeVertex.java)."""


@register_vertex
@dataclasses.dataclass
class ElementWiseVertex(GraphVertexConf):
    """Pointwise combine (nn/graph/vertex/impl/ElementWiseVertex.java:
    Add/Subtract/Product; Average/Max added for completeness)."""

    op: str = "Add"  # Add | Subtract | Product | Average | Max


@register_vertex
@dataclasses.dataclass
class SubsetVertex(GraphVertexConf):
    """Feature-range slice [from, to] inclusive, as in SubsetVertex.java."""

    from_index: int = 0
    to_index: int = 0


@register_vertex
@dataclasses.dataclass
class LastTimeStepVertex(GraphVertexConf):
    """[b,t,f] → [b,f] taking the last non-masked step
    (nn/graph/vertex/impl/rnn/LastTimeStepVertex.java). ``mask_input`` names
    the network input whose mask selects the step."""

    mask_input: Optional[str] = None


@register_vertex
@dataclasses.dataclass
class DuplicateToTimeSeriesVertex(GraphVertexConf):
    """[b,f] → [b,t,f] broadcast over the time length of a named input
    (nn/graph/vertex/impl/rnn/DuplicateToTimeSeriesVertex.java)."""

    input_name: Optional[str] = None


@register_vertex
@dataclasses.dataclass
class ScaleVertex(GraphVertexConf):
    scale: float = 1.0


@register_vertex
@dataclasses.dataclass
class StackVertex(GraphVertexConf):
    """Stack along batch axis (for weight sharing patterns)."""


@register_vertex
@dataclasses.dataclass
class UnstackVertex(GraphVertexConf):
    from_index: int = 0
    stack_size: int = 1


@register_vertex
@dataclasses.dataclass
class PreprocessorVertex(GraphVertexConf):
    """Wraps an InputPreProcessor as a standalone vertex."""

    preprocessor: Optional[dict] = None  # serialized InputPreProcessor


class ComputationGraphConfiguration:
    def __init__(
        self,
        global_conf: GlobalConf,
        inputs: List[str],
        outputs: List[str],
        layers: Dict[str, LayerConf],
        vertices: Dict[str, GraphVertexConf],
        vertex_inputs: Dict[str, List[str]],
        preprocessors: Optional[Dict[str, InputPreProcessor]] = None,
        backprop: bool = True,
        pretrain: bool = False,
        backprop_type: BackpropType = BackpropType.STANDARD,
        tbptt_fwd_length: int = 20,
        tbptt_back_length: int = 20,
        input_types: Optional[Dict[str, InputType]] = None,
    ):
        self.global_conf = global_conf
        self.inputs = inputs
        self.outputs = outputs
        self.layers = layers
        self.vertices = vertices
        self.vertex_inputs = vertex_inputs
        self.preprocessors = preprocessors or {}
        self.backprop = backprop
        self.pretrain = pretrain
        self.backprop_type = backprop_type
        self.tbptt_fwd_length = tbptt_fwd_length
        self.tbptt_back_length = tbptt_back_length
        self.input_types = input_types or {}
        self.validate()
        self.topological_order = self._topological_sort()

    # --- validation + topo sort (reference :214, :295-331) ------------
    def all_vertex_names(self) -> List[str]:
        return list(self.inputs) + list(self.layers) + list(self.vertices)

    def validate(self) -> None:
        names = self.all_vertex_names()
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(f"duplicate vertex names: {sorted(dupes)}")
        name_set = set(names)
        for v, ins in self.vertex_inputs.items():
            if v not in name_set:
                raise ValueError(f"vertex_inputs references unknown vertex {v!r}")
            for i in ins:
                if i not in name_set:
                    raise ValueError(f"vertex {v!r} consumes unknown input {i!r}")
        for o in self.outputs:
            if o not in name_set:
                raise ValueError(f"unknown output {o!r}")
        for n in list(self.layers) + list(self.vertices):
            if not self.vertex_inputs.get(n):
                raise ValueError(f"vertex {n!r} has no inputs")

    def _topological_sort(self) -> List[str]:
        # Kahn's algorithm over the full DAG (inputs included).
        indeg = {n: 0 for n in self.all_vertex_names()}
        children: Dict[str, List[str]] = {n: [] for n in indeg}
        for v, ins in self.vertex_inputs.items():
            for i in ins:
                children[i].append(v)
                indeg[v] += 1
        queue = [n for n in self.inputs]
        # deterministic order: keep insertion order for stability
        order: List[str] = []
        while queue:
            n = queue.pop(0)
            order.append(n)
            for c in children[n]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    queue.append(c)
        if len(order) != len(indeg):
            cyc = sorted(set(indeg) - set(order))
            raise ValueError(f"graph has a cycle or unreachable vertices: {cyc}")
        return order

    # --- serde ---------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "format": "deeplearning4j-tpu/ComputationGraphConfiguration",
            "version": 1,
            "global": self.global_conf.to_dict(),
            "inputs": self.inputs,
            "outputs": self.outputs,
            "layers": {n: l.to_dict() for n, l in self.layers.items()},
            "vertices": {n: v.to_dict() for n, v in self.vertices.items()},
            "vertex_inputs": self.vertex_inputs,
            "preprocessors": {n: p.to_dict() for n, p in self.preprocessors.items()},
            "backprop": self.backprop,
            "pretrain": self.pretrain,
            "backprop_type": self.backprop_type.value,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
            "input_types": {n: t.to_dict() for n, t in self.input_types.items()},
        }

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @staticmethod
    def from_dict(d: dict) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration(
            global_conf=GlobalConf.from_dict(d.get("global", {})),
            inputs=list(d["inputs"]),
            outputs=list(d["outputs"]),
            layers={n: LayerConf.from_dict(ld) for n, ld in d["layers"].items()},
            vertices={
                n: GraphVertexConf.from_dict(vd) for n, vd in d["vertices"].items()
            },
            vertex_inputs={n: list(v) for n, v in d["vertex_inputs"].items()},
            preprocessors={
                n: InputPreProcessor.from_dict(pd)
                for n, pd in d.get("preprocessors", {}).items()
            },
            backprop=d.get("backprop", True),
            pretrain=d.get("pretrain", False),
            backprop_type=BackpropType(d.get("backprop_type", "Standard")),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
            input_types={
                n: InputType.from_dict(td) for n, td in d.get("input_types", {}).items()
            },
        )

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration.from_dict(json.loads(s))

    # YAML and the reference's Jackson JSON (``nn/conf/compat.py`` and
    # ``utils/yamlio.py`` in the JAX package) are not ported yet
    @staticmethod
    def from_reference_json(s: str) -> "ComputationGraphConfiguration":
        raise _compat_not_ported("from_reference_json")

    @staticmethod
    def from_reference_yaml(s: str) -> "ComputationGraphConfiguration":
        raise _compat_not_ported("from_reference_yaml")

    def to_reference_json(self) -> str:
        raise _compat_not_ported("to_reference_json")

    def to_reference_yaml(self) -> str:
        raise _compat_not_ported("to_reference_yaml")

    def to_yaml(self) -> str:
        raise _compat_not_ported("to_yaml")

    @staticmethod
    def from_yaml(s: str) -> "ComputationGraphConfiguration":
        """Accepts JSON (valid YAML); block-style YAML is not ported yet."""
        try:
            return ComputationGraphConfiguration.from_json(s)
        except json.JSONDecodeError:
            raise _compat_not_ported("from_yaml of block-style YAML") from None

    def __eq__(self, other):
        return (
            isinstance(other, ComputationGraphConfiguration)
            and self.to_dict() == other.to_dict()
        )

    def clone(self) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration.from_dict(copy.deepcopy(self.to_dict()))


class GraphBuilder:
    """Fluent DAG builder (ComputationGraphConfiguration.GraphBuilder)."""

    def __init__(self, global_conf: GlobalConf, layer_defaults: Dict[str, Any]):
        self._global = global_conf
        self._defaults = layer_defaults
        self._inputs: List[str] = []
        self._outputs: List[str] = []
        self._layers: Dict[str, LayerConf] = {}
        self._vertices: Dict[str, GraphVertexConf] = {}
        self._vertex_inputs: Dict[str, List[str]] = {}
        self._preprocessors: Dict[str, InputPreProcessor] = {}
        self._backprop = True
        self._pretrain = False
        self._backprop_type = BackpropType.STANDARD
        self._tbptt_fwd = 20
        self._tbptt_back = 20
        self._input_types: Dict[str, InputType] = {}

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._inputs.extend(names)
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    def add_layer(
        self, name: str, layer: LayerConf, *inputs: str,
        preprocessor: Optional[InputPreProcessor] = None,
    ) -> "GraphBuilder":
        layer.name = name
        self._layers[name] = layer
        self._vertex_inputs[name] = list(inputs)
        if preprocessor is not None:
            self._preprocessors[name] = preprocessor
        return self

    def add_vertex(
        self, name: str, vertex: GraphVertexConf, *inputs: str
    ) -> "GraphBuilder":
        self._vertices[name] = vertex
        self._vertex_inputs[name] = list(inputs)
        return self

    def set_input_types(self, **types: InputType) -> "GraphBuilder":
        self._input_types.update(types)
        return self

    def backprop(self, b: bool) -> "GraphBuilder":
        self._backprop = bool(b)
        return self

    def pretrain(self, b: bool) -> "GraphBuilder":
        self._pretrain = bool(b)
        return self

    def backprop_type(self, t: BackpropType) -> "GraphBuilder":
        self._backprop_type = BackpropType(t)
        return self

    def t_bptt_forward_length(self, n: int) -> "GraphBuilder":
        self._tbptt_fwd = int(n)
        return self

    def t_bptt_backward_length(self, n: int) -> "GraphBuilder":
        self._tbptt_back = int(n)
        return self

    def build(self) -> ComputationGraphConfiguration:
        for l in self._layers.values():
            apply_layer_defaults(l, self._defaults)
        conf = ComputationGraphConfiguration(
            global_conf=self._global,
            inputs=self._inputs,
            outputs=self._outputs,
            layers=self._layers,
            vertices=self._vertices,
            vertex_inputs=self._vertex_inputs,
            preprocessors=self._preprocessors,
            backprop=self._backprop,
            pretrain=self._pretrain,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
            input_types=self._input_types,
        )
        if self._input_types:
            _infer_graph_shapes(conf)
        return conf


def _infer_graph_shapes(conf: ComputationGraphConfiguration) -> None:
    """Propagate InputTypes through topo order, inferring layer n_in."""
    types: Dict[str, InputType] = dict(conf.input_types)
    for name in conf.topological_order:
        if name in conf.inputs:
            continue
        in_types = [types[i] for i in conf.vertex_inputs[name] if i in types]
        if not in_types:
            continue
        if name in conf.layers:
            layer = conf.layers[name]
            it = in_types[0]
            if name in conf.preprocessors:
                it = conf.preprocessors[name].output_type(it)
            layer.infer_n_in(it)
            types[name] = layer.output_type(it)
        else:
            types[name] = _vertex_output_type(conf.vertices[name], in_types, conf, name)


def _vertex_output_type(
    vertex: GraphVertexConf, in_types: List[InputType],
    conf: ComputationGraphConfiguration, name: str,
) -> InputType:
    first = in_types[0]
    if isinstance(vertex, MergeVertex):
        if first.kind == "CNN":
            return InputType.convolutional(
                first.height, first.width, sum(t.channels for t in in_types)
            )
        total = sum(t.flat_size() for t in in_types)
        if first.kind == "RNN":
            return InputType.recurrent(total, first.timeseries_length)
        return InputType.feed_forward(total)
    if isinstance(vertex, SubsetVertex):
        size = vertex.to_index - vertex.from_index + 1
        if first.kind == "RNN":
            return InputType.recurrent(size, first.timeseries_length)
        return InputType.feed_forward(size)
    if isinstance(vertex, LastTimeStepVertex):
        return InputType.feed_forward(first.size)
    if isinstance(vertex, DuplicateToTimeSeriesVertex):
        return InputType.recurrent(first.flat_size())
    return first
