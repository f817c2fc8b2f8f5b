"""Reference-format JSON loader: the ecosystem-compat half of the serde
contract.

A reference ``MultiLayerConfiguration.toJson()`` document (Jackson
polymorphic serde — deeplearning4j-core's org/deeplearning4j/nn/conf/
NeuralNetConfiguration.java:214-239 and
MultiLayerConfiguration.java:48-58) looks like::

    {
      "backprop": true, "pretrain": false,
      "backpropType": "TruncatedBPTT",
      "tbpttFwdLength": 50, "tbpttBackLength": 50,
      "inputPreProcessors": {"1": {"cnnToFeedForward":
          {"inputHeight": 12, "inputWidth": 12, "numChannels": 20}}},
      "confs": [
        {"layer": {"dense": {"nIn": 784, "nOut": 100,
                             "activationFunction": "relu",
                             "weightInit": "XAVIER", "updater": "ADAM",
                             "learningRate": 0.01, "l2": 1e-4, ...}},
         "numIterations": 1, "seed": 123,
         "optimizationAlgo": "STOCHASTIC_GRADIENT_DESCENT",
         "learningRatePolicy": "None", ...},
        ...
      ]
    }

Layer/preprocessor/distribution type tags are Jackson WRAPPER_OBJECT names
(Layer.java:42-60, InputPreProcessor.java @JsonSubTypes,
Distribution.java:34-37); enums serialize by Java name. This module
translates that document into the native
:class:`~deeplearning4j_tpu_torch.nn.conf.neural_net.MultiLayerConfiguration` so a
model definition exported from the reference loads unchanged
(``MultiLayerConfiguration.from_reference_json(...)``).

Port of ``deeplearning4j_tpu/nn/conf/compat.py`` (which imports no jax)
on the port's conf classes, whose field names and defaults are the same:
both packages write the same reference JSON and YAML text for the same
configuration and read a reference document into equal configurations.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Tuple

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.enums import (
    BackpropType,
    GradientNormalization,
    HiddenUnit,
    LearningRatePolicy,
    OptimizationAlgorithm,
    PoolingType,
    Updater,
    VisibleUnit,
    WeightInit,
)
from deeplearning4j_tpu_torch.nn.conf.neural_net import GlobalConf, MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    BinomialSamplingPreProcessor,
    CnnToFeedForwardPreProcessor,
    CnnToRnnPreProcessor,
    ComposableInputPreProcessor,
    FeedForwardToCnnPreProcessor,
    FeedForwardToRnnPreProcessor,
    InputPreProcessor,
    ReshapePreProcessor,
    RnnToCnnPreProcessor,
    RnnToFeedForwardPreProcessor,
    UnitVariancePreProcessor,
    ZeroMeanAndUnitVariancePreProcessor,
    ZeroMeanPrePreProcessor,
)
from deeplearning4j_tpu_torch.ops.losses import LossFunction

# Jackson WRAPPER_OBJECT names (Layer.java:44-59) → native layer confs
_LAYER_TYPES: Dict[str, type] = {
    "autoEncoder": L.AutoEncoder,
    "convolution": L.ConvolutionLayer,
    "imageLSTM": L.ImageLSTM,
    "gravesLSTM": L.GravesLSTM,
    "gravesBidirectionalLSTM": L.GravesBidirectionalLSTM,
    "gru": L.GRU,
    "output": L.OutputLayer,
    "rnnoutput": L.RnnOutputLayer,
    "RBM": L.RBM,
    "dense": L.DenseLayer,
    "recursiveAutoEncoder": L.RecursiveAutoEncoder,
    "subsampling": L.SubsamplingLayer,
    "batchNormalization": L.BatchNormalization,
    "localResponseNormalization": L.LocalResponseNormalization,
    "embedding": L.EmbeddingLayer,
    "activation": L.ActivationLayer,
}

# reference camelCase layer field → native field (+ optional coercion)
_FIELD_MAP = {
    "layerName": "name",
    "activationFunction": "activation",
    "weightInit": "weight_init",
    "biasInit": "bias_init",
    "learningRate": "learning_rate",
    "biasLearningRate": "bias_learning_rate",
    "l1": "l1",
    "l2": "l2",
    "dropOut": "dropout",
    "updater": "updater",
    "momentum": "momentum",
    "rho": "rho",
    "rmsDecay": "rms_decay",
    "adamMeanDecay": "adam_mean_decay",
    "adamVarDecay": "adam_var_decay",
    "gradientNormalization": "gradient_normalization",
    "gradientNormalizationThreshold": "gradient_normalization_threshold",
    "nIn": "n_in",
    "nOut": "n_out",
    "kernelSize": "kernel_size",
    "stride": "stride",
    "padding": "padding",
    "poolingType": "pooling_type",
    "lossFunction": "loss_function",
    "hiddenUnit": "hidden_unit",
    "visibleUnit": "visible_unit",
    "k": "k",
    "sparsity": "sparsity",
    "decay": "decay",
    "eps": "eps",
    "gamma": "gamma",
    "beta": "beta",
    "n": "n",
    "alpha": "alpha",
    "hiddenSize": "hidden_size",
    "dist": "dist",
}

_ENUM_COERCE = {
    "weight_init": WeightInit,
    "updater": Updater,
    "pooling_type": PoolingType,
    "loss_function": LossFunction,
    "hidden_unit": HiddenUnit,
    "visible_unit": VisibleUnit,
    "gradient_normalization": GradientNormalization,
}

# fields where Jackson writes 0.0 for "unset" and the native conf expects
# None to mean "inherit the global/default value"
_ZERO_MEANS_UNSET = {"learning_rate", "bias_learning_rate", "momentum",
                     "rho", "rms_decay", "adam_mean_decay", "adam_var_decay"}


def _convert_distribution(d: Optional[dict]) -> Optional[dict]:
    """{"normal": {"mean": m, "std": s}} → {"type": "normal", ...}
    (Distribution.java:34-37 wrapper names)."""
    if not d:
        return None
    (kind, fields), = d.items()
    out = {"type": kind}
    out.update(fields)
    return out


def _convert_layer(wrapped: dict) -> L.LayerConf:
    if len(wrapped) != 1:
        raise ValueError(
            f"expected one Jackson wrapper-object layer key, got {list(wrapped)}")
    (tag, fields), = wrapped.items()
    cls = _LAYER_TYPES.get(tag)
    if cls is None:
        raise ValueError(f"unknown reference layer type {tag!r} "
                         f"(known: {sorted(_LAYER_TYPES)})")
    import dataclasses as _dc

    names = {f.name for f in _dc.fields(cls)}
    kwargs: Dict[str, Any] = {}
    for ref_key, value in fields.items():
        key = _FIELD_MAP.get(ref_key)
        if key is None or key not in names or value is None:
            continue
        if key == "dist":
            value = _convert_distribution(value)
        elif key in _ENUM_COERCE and isinstance(value, str):
            value = _ENUM_COERCE[key](value)
        elif key in ("kernel_size", "stride", "padding") and isinstance(value, list):
            value = tuple(value)
        elif key in _ZERO_MEANS_UNSET and value == 0:
            continue
        elif key in ("n_in", "n_out") and value == 0:
            continue  # Jackson default int; let shape inference fill it
        kwargs[key] = value
    return cls(**kwargs)


# preprocessor wrapper names (InputPreProcessor.java @JsonSubTypes)
def _convert_preprocessor(wrapped: dict) -> InputPreProcessor:
    (tag, fields), = wrapped.items()
    fields = fields or {}
    h = fields.get("inputHeight")
    w = fields.get("inputWidth")
    c = fields.get("numChannels")
    if tag == "cnnToFeedForward":
        return CnnToFeedForwardPreProcessor(height=h, width=w, channels=c)
    if tag == "feedForwardToCnn":
        return FeedForwardToCnnPreProcessor(height=h or 0, width=w or 0,
                                            channels=c or 1)
    if tag == "cnnToRnn":
        return CnnToRnnPreProcessor(height=h, width=w, channels=c)
    if tag == "rnnToCnn":
        return RnnToCnnPreProcessor(height=h or 0, width=w or 0,
                                    channels=c or 1)
    if tag == "feedForwardToRnn":
        return FeedForwardToRnnPreProcessor()
    if tag == "rnnToFeedForward":
        return RnnToFeedForwardPreProcessor()
    if tag == "reshape":
        return ReshapePreProcessor(shape=tuple(fields.get("shape", ())))
    if tag == "unitVariance":
        return UnitVariancePreProcessor()
    if tag == "zeroMeanAndUnitVariance":
        return ZeroMeanAndUnitVariancePreProcessor()
    if tag == "zeroMean":
        return ZeroMeanPrePreProcessor()
    if tag == "binomialSampling":
        return BinomialSamplingPreProcessor()
    if tag == "composableInput":
        children = fields.get("inputPreProcessors", [])
        return ComposableInputPreProcessor(
            preprocessors=tuple(_convert_preprocessor(p) for p in children))
    raise ValueError(f"unknown reference preprocessor type {tag!r}")


def _convert_global_conf(first: dict, layers) -> GlobalConf:
    """Network-wide hyperparameters from one reference
    ``NeuralNetConfiguration`` document (the reference clones one per layer;
    trainer-level fields are replicated across them)."""
    global_conf = GlobalConf(
        seed=int(first.get("seed", 12345)) & 0x7FFFFFFF,
        iterations=int(first.get("numIterations", 1)),
        optimization_algo=_safe_enum(
            OptimizationAlgorithm, first.get("optimizationAlgo"),
            OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT),
        lr_policy=_safe_enum(LearningRatePolicy,
                             first.get("learningRatePolicy"),
                             LearningRatePolicy.NONE),
        lr_policy_decay_rate=float(first.get("lrPolicyDecayRate", 0.0)),
        lr_policy_steps=float(first.get("lrPolicySteps", 1.0) or 1.0),
        lr_policy_power=float(first.get("lrPolicyPower", 1.0) or 1.0),
        max_num_line_search_iterations=int(
            first.get("maxNumLineSearchIterations", 5)),
        minibatch=bool(first.get("miniBatch", True)),
        use_drop_connect=bool(first.get("useDropConnect", False)),
    )
    # the reference carries the learning rate on each layer; surface the
    # first explicit one as the network-wide base LR
    for layer in layers:
        if layer.learning_rate is not None:
            global_conf.learning_rate = float(layer.learning_rate)
            break
    # per-layer schedules (Layer.java:72,75; the Builder clones one
    # schedule onto every layer) → the native global schedules
    sched = (first.get("layer") or {})
    if sched:
        (_, layer_fields), = sched.items()
        layer_fields = layer_fields or {}
        ref_sched = layer_fields.get("learningRateSchedule")
        if ref_sched:
            global_conf.lr_schedule = {int(k): float(v)
                                       for k, v in ref_sched.items()}
        ref_mom = layer_fields.get("momentumSchedule")
        if ref_mom:
            global_conf.momentum_schedule = {int(k): float(v)
                                             for k, v in ref_mom.items()}
    return global_conf


def from_reference_json(document: str) -> MultiLayerConfiguration:
    """Load a reference-format ``MultiLayerConfiguration.toJson()`` document
    (NeuralNetConfiguration.java:214-239 mapper conventions)."""
    d = json.loads(document)
    return _mln_from_reference_dict(d)


def _mln_from_reference_dict(d: dict) -> MultiLayerConfiguration:
    confs = d.get("confs")
    if not confs:
        raise ValueError("reference document has no 'confs' list")

    layers = []
    for conf in confs:
        layer_doc = conf.get("layer")
        if layer_doc is None:
            raise ValueError("conf entry without a 'layer'")
        layers.append(_convert_layer(layer_doc))

    global_conf = _convert_global_conf(confs[0], layers)

    preprocessors = {
        int(i): _convert_preprocessor(p)
        for i, p in (d.get("inputPreProcessors") or {}).items()
    }

    return MultiLayerConfiguration(
        global_conf=global_conf,
        layers=layers,
        input_preprocessors=preprocessors,
        backprop=bool(d.get("backprop", True)),
        pretrain=bool(d.get("pretrain", False)),
        backprop_type=_safe_enum(BackpropType, d.get("backpropType"),
                                 BackpropType.STANDARD),
        tbptt_fwd_length=int(d.get("tbpttFwdLength", 20)),
        tbptt_back_length=int(d.get("tbpttBackLength", 20)),
    )


def graph_from_reference_json(document: str):
    """Load a reference-format ``ComputationGraphConfiguration.toJson()``
    document (ComputationGraphConfiguration.java:113,129 mapper
    conventions) into the native
    :class:`~deeplearning4j_tpu_torch.nn.conf.graph.ComputationGraphConfiguration`.

    Reference shape (Jackson field names from
    ComputationGraphConfiguration.java:59-81, vertex WRAPPER_OBJECT tags
    from nn/conf/graph/GraphVertex.java:37-44)::

        {
          "vertices": {
            "dense1": {"LayerVertex": {
                "layerConf": {"layer": {"dense": {...}}, "seed": 123, ...},
                "preProcessor": {"cnnToFeedForward": {...}}}},
            "merge": {"MergeVertex": {}},
            "ew": {"ElementWiseVertex": {"op": "Add"}},
            "sub": {"SubsetVertex": {"from": 0, "to": 9}},
            "last": {"LastTimeStepVertex": {"maskArrayInputName": "in"}},
            "dup": {"DuplicateToTimeSeriesVertex": {"inputName": "in"}},
            "pre": {"PreprocessorVertex": {"preProcessor": {...}}}
          },
          "vertexInputs": {"dense1": ["in"], ...},
          "networkInputs": ["in"], "networkOutputs": ["out"],
          "pretrain": true, "backprop": false,
          "backpropType": "Standard",
          "tbpttFwdLength": 20, "tbpttBackLength": 20,
          "defaultConfiguration": {...}
        }
    """
    d = json.loads(document)
    return _graph_from_reference_dict(d)


def _graph_from_reference_dict(d: dict):
    from deeplearning4j_tpu_torch.nn.conf import graph as G

    vertices_doc = d.get("vertices")
    if not vertices_doc:
        raise ValueError("reference graph document has no 'vertices' map")
    inputs = list(d.get("networkInputs") or [])
    outputs = list(d.get("networkOutputs") or [])
    if not inputs or not outputs:
        raise ValueError(
            "reference graph document needs networkInputs and networkOutputs")

    layers: Dict[str, Any] = {}
    vertices: Dict[str, Any] = {}
    preprocessors: Dict[str, Any] = {}
    layer_conf_docs = []
    for name, wrapped in vertices_doc.items():
        if len(wrapped) != 1:
            raise ValueError(
                f"vertex {name!r}: expected one Jackson wrapper-object key, "
                f"got {list(wrapped)}")
        (tag, fields), = wrapped.items()
        fields = fields or {}
        if tag == "LayerVertex":
            layer_conf = fields.get("layerConf") or {}
            layer_doc = layer_conf.get("layer")
            if layer_doc is None:
                raise ValueError(f"LayerVertex {name!r} without a layer")
            layer = _convert_layer(layer_doc)
            layer.name = name
            layers[name] = layer
            layer_conf_docs.append(layer_conf)
            pre = fields.get("preProcessor")
            if pre:
                preprocessors[name] = _convert_preprocessor(pre)
        elif tag == "MergeVertex":
            vertices[name] = G.MergeVertex()
        elif tag == "ElementWiseVertex":
            vertices[name] = G.ElementWiseVertex(op=fields.get("op", "Add"))
        elif tag == "SubsetVertex":
            vertices[name] = G.SubsetVertex(
                from_index=int(fields.get("from", 0)),
                to_index=int(fields.get("to", 0)))
        elif tag == "LastTimeStepVertex":
            vertices[name] = G.LastTimeStepVertex(
                mask_input=fields.get("maskArrayInputName"))
        elif tag == "DuplicateToTimeSeriesVertex":
            vertices[name] = G.DuplicateToTimeSeriesVertex(
                input_name=fields.get("inputName"))
        elif tag == "PreprocessorVertex":
            pre = fields.get("preProcessor")
            vertices[name] = G.PreprocessorVertex(
                preprocessor=_convert_preprocessor(pre).to_dict()
                if pre else None)
        else:
            raise ValueError(
                f"unknown reference graph vertex type {tag!r} "
                "(known: LayerVertex, MergeVertex, ElementWiseVertex, "
                "SubsetVertex, LastTimeStepVertex, "
                "DuplicateToTimeSeriesVertex, PreprocessorVertex)")

    vertex_inputs = {n: list(v)
                     for n, v in (d.get("vertexInputs") or {}).items()}

    # global hyperparameters: defaultConfiguration if present, else the
    # first LayerVertex's cloned conf (both are full reference
    # NeuralNetConfiguration documents)
    source = d.get("defaultConfiguration") or (
        layer_conf_docs[0] if layer_conf_docs else {})
    global_conf = _convert_global_conf(source, list(layers.values()))

    return G.ComputationGraphConfiguration(
        global_conf=global_conf,
        inputs=inputs,
        outputs=outputs,
        layers=layers,
        vertices=vertices,
        vertex_inputs=vertex_inputs,
        preprocessors=preprocessors,
        backprop=bool(d.get("backprop", True)),
        pretrain=bool(d.get("pretrain", False)),
        backprop_type=_safe_enum(BackpropType, d.get("backpropType"),
                                 BackpropType.STANDARD),
        tbptt_fwd_length=int(d.get("tbpttFwdLength", 20)),
        tbptt_back_length=int(d.get("tbpttBackLength", 20)),
    )


def from_reference_yaml(document: str) -> MultiLayerConfiguration:
    """Load a reference-format ``MultiLayerConfiguration.toYaml()`` document.

    The reference emits via Jackson's SnakeYAML mapper
    (NeuralNetConfiguration.java:214-239 toYaml/fromYaml,
    MultiLayerConfiguration.java fromYaml) — block mappings/sequences with
    double-quoted strings and an optional ``---`` document marker; the field
    and wrapper-tag vocabulary is identical to the JSON form, so the parsed
    tree routes through the same translation."""
    from deeplearning4j_tpu_torch.utils.yamlio import load

    d = load(document)
    if not isinstance(d, dict):
        raise ValueError("reference YAML document is not a mapping")
    return _mln_from_reference_dict(d)


def graph_from_reference_yaml(document: str):
    """Load a reference-format ``ComputationGraphConfiguration.toYaml()``
    document (ComputationGraphConfiguration.java:86-96)."""
    from deeplearning4j_tpu_torch.utils.yamlio import load

    d = load(document)
    if not isinstance(d, dict):
        raise ValueError("reference YAML document is not a mapping")
    return _graph_from_reference_dict(d)


# ---------------------------------------------------------------------------
# EXPORT: native configuration → reference Jackson format. The exact
# inverse of the loaders above — enum .value spellings ARE the Java names,
# so a to_reference_json document loads in the reference (and round-trips
# through from_reference_json, which the fuzz test exercises).
# ---------------------------------------------------------------------------

_TAG_BY_CLASS = {cls: tag for tag, cls in _LAYER_TYPES.items()}
_REF_KEY_BY_FIELD = {v: k for k, v in _FIELD_MAP.items()}


def _export_distribution(d: Optional[dict]) -> Optional[dict]:
    if not d:
        return None
    d = dict(d)
    kind = d.pop("type")
    return {kind: d}


def _field_default(f) -> Any:
    import dataclasses as _dc

    if f.default is not _dc.MISSING:
        return f.default
    if f.default_factory is not _dc.MISSING:  # type: ignore[misc]
        return f.default_factory()  # type: ignore[misc]
    return None


def _export_layer(layer: "L.LayerConf") -> dict:
    tag = _TAG_BY_CLASS.get(type(layer))
    if tag is None:
        raise ValueError(
            f"{type(layer).__name__} has no reference Jackson tag "
            f"(exportable: {sorted(c.__name__ for c in _TAG_BY_CLASS)})")
    import dataclasses as _dc
    import enum as _enum

    fields: Dict[str, Any] = {}
    for f in _dc.fields(layer):
        v = getattr(layer, f.name)
        if v is None:
            continue
        ref_key = _REF_KEY_BY_FIELD.get(f.name)
        if ref_key is None:
            # native-only field: silently dropping it would re-import as
            # a DIFFERENT network (e.g. convolution_mode="same" reverts
            # to "truncate" and changes output shapes) — raise unless it
            # still holds its default, same contract as unexportable
            # layer/vertex types
            if v != _field_default(f):
                raise ValueError(
                    f"{type(layer).__name__}.{f.name}={v!r} has no "
                    "reference counterpart — the reference format "
                    "cannot express it")
            continue
        if f.name in _ZERO_MEANS_UNSET and v == 0:
            # the reference format writes 0.0 for UNSET updater
            # hyperparameters (Jackson primitive defaults), which is why
            # the importer's _ZERO_MEANS_UNSET drops zeros — an explicit
            # 0.0 is therefore inexpressible and would re-import as the
            # per-field default (e.g. momentum 0.9), silently
            raise ValueError(
                f"{type(layer).__name__}.{f.name}=0.0 cannot be "
                "expressed in the reference format (0.0 means UNSET "
                "there and re-imports as the default)")
        if f.name == "dist":
            v = _export_distribution(v)
        elif isinstance(v, _enum.Enum):
            v = v.value
        elif isinstance(v, tuple):
            v = list(v)
        fields[ref_key] = v
    return {tag: fields}


# preprocessor export table, adjacent to the import chain in
# _convert_preprocessor: class name → (wrapper tag, field names to copy)
_HWC = (("inputHeight", "height"), ("inputWidth", "width"),
        ("numChannels", "channels"))
_PRE_EXPORT: Dict[str, Tuple[str, tuple]] = {
    "CnnToFeedForwardPreProcessor": ("cnnToFeedForward", _HWC),
    "FeedForwardToCnnPreProcessor": ("feedForwardToCnn", _HWC),
    "CnnToRnnPreProcessor": ("cnnToRnn", _HWC),
    "RnnToCnnPreProcessor": ("rnnToCnn", _HWC),
    "FeedForwardToRnnPreProcessor": ("feedForwardToRnn", ()),
    "RnnToFeedForwardPreProcessor": ("rnnToFeedForward", ()),
    "UnitVariancePreProcessor": ("unitVariance", ()),
    "ZeroMeanAndUnitVariancePreProcessor": ("zeroMeanAndUnitVariance", ()),
    "ZeroMeanPrePreProcessor": ("zeroMean", ()),
    "BinomialSamplingPreProcessor": ("binomialSampling", ()),
}


def _export_preprocessor(p: InputPreProcessor) -> dict:
    name = type(p).__name__
    if name == "ReshapePreProcessor":
        return {"reshape": {"shape": list(p.shape)}}
    if name == "ComposableInputPreProcessor":
        return {"composableInput": {"inputPreProcessors": [
            _export_preprocessor(c) for c in p.preprocessors]}}
    entry = _PRE_EXPORT.get(name)
    if entry is None:
        raise ValueError(f"{name} has no reference wrapper tag")
    tag, field_pairs = entry
    return {tag: {ref: getattr(p, attr)
                  for ref, attr in field_pairs
                  if getattr(p, attr, None) is not None}}


def _export_conf_entry(layer, global_conf: GlobalConf) -> dict:
    """One ``confs`` element: the reference clones trainer-level fields
    onto every per-layer NeuralNetConfiguration."""
    # global hyperparameters with NO serialized reference counterpart
    # (lrScoreBasedDecay lives only in the reference Builder; the others
    # are native-only): raise rather than silently train differently
    for attr, default, what in (
            ("lr_score_based_decay_rate", 0.0,
             "score-based LR decay (reference Builder-only, never "
             "serialized)"),
            ("mini_batch_size_divisor", None, "native-only field"),
            ("dtype_policy", "float32", "native-only mixed-precision "
                                        "policy")):
        v = getattr(global_conf, attr)
        if v != default:
            raise ValueError(
                f"GlobalConf.{attr}={v!r} cannot be expressed in the "
                f"reference format ({what})")
    layer_doc = _export_layer(layer)
    # the reference carries the learning rate (and its schedule) per layer
    (tag, fields), = layer_doc.items()
    if "learningRate" not in fields:
        if not global_conf.learning_rate:
            raise ValueError(
                "GlobalConf.learning_rate=0.0 cannot be expressed in "
                "the reference format (0.0 means UNSET there and "
                "re-imports as the 0.1 default)")
        fields["learningRate"] = global_conf.learning_rate
    if global_conf.lr_schedule:
        fields["learningRateSchedule"] = {
            str(k): v for k, v in global_conf.lr_schedule.items()}
    if global_conf.momentum_schedule:
        fields["momentumSchedule"] = {
            str(k): v for k, v in global_conf.momentum_schedule.items()}
    return {
        "layer": layer_doc,
        "seed": global_conf.seed,
        "numIterations": global_conf.iterations,
        "optimizationAlgo": global_conf.optimization_algo.value,
        "learningRatePolicy": global_conf.lr_policy.value,
        "lrPolicyDecayRate": global_conf.lr_policy_decay_rate,
        "lrPolicySteps": global_conf.lr_policy_steps,
        "lrPolicyPower": global_conf.lr_policy_power,
        "maxNumLineSearchIterations":
            global_conf.max_num_line_search_iterations,
        "miniBatch": global_conf.minibatch,
        "useDropConnect": global_conf.use_drop_connect,
    }


def to_reference_json(conf: MultiLayerConfiguration) -> str:
    """Export a native MultiLayerConfiguration as a reference-format
    ``MultiLayerConfiguration.toJson()`` document."""
    doc = {
        "backprop": conf.backprop,
        "pretrain": conf.pretrain,
        "backpropType": conf.backprop_type.value,
        "tbpttFwdLength": conf.tbptt_fwd_length,
        "tbpttBackLength": conf.tbptt_back_length,
        "confs": [_export_conf_entry(l, conf.global_conf)
                  for l in conf.layers],
    }
    if conf.input_preprocessors:
        doc["inputPreProcessors"] = {
            str(i): _export_preprocessor(p)
            for i, p in conf.input_preprocessors.items()}
    return json.dumps(doc, indent=2)


def graph_to_reference_json(conf) -> str:
    """Export a native ComputationGraphConfiguration as a reference-format
    ``ComputationGraphConfiguration.toJson()`` document. Vertices with no
    reference tag (Scale/Stack/Unstack) raise — the reference format
    cannot express them."""
    from deeplearning4j_tpu_torch.nn.conf import graph as G

    vertices: Dict[str, Any] = {}
    for name, layer in conf.layers.items():
        lv: Dict[str, Any] = {
            "layerConf": _export_conf_entry(layer, conf.global_conf)}
        if name in conf.preprocessors:
            lv["preProcessor"] = _export_preprocessor(
                conf.preprocessors[name])
        vertices[name] = {"LayerVertex": lv}
    for name, v in conf.vertices.items():
        if isinstance(v, G.MergeVertex):
            vertices[name] = {"MergeVertex": {}}
        elif isinstance(v, G.ElementWiseVertex):
            if v.op not in ("Add", "Subtract", "Product"):
                raise ValueError(
                    f"vertex {name!r}: ElementWiseVertex op {v.op!r} "
                    "cannot be expressed in the reference format (its "
                    "enum is Add/Subtract/Product — "
                    "ElementWiseVertex.java:39)")
            vertices[name] = {"ElementWiseVertex": {"op": v.op}}
        elif isinstance(v, G.SubsetVertex):
            vertices[name] = {"SubsetVertex": {"from": v.from_index,
                                               "to": v.to_index}}
        elif isinstance(v, G.LastTimeStepVertex):
            vertices[name] = {"LastTimeStepVertex":
                              {"maskArrayInputName": v.mask_input}}
        elif isinstance(v, G.DuplicateToTimeSeriesVertex):
            vertices[name] = {"DuplicateToTimeSeriesVertex":
                              {"inputName": v.input_name}}
        elif isinstance(v, G.PreprocessorVertex):
            pre = (InputPreProcessor.from_dict(v.preprocessor)
                   if v.preprocessor else None)
            vertices[name] = {"PreprocessorVertex": {
                "preProcessor": _export_preprocessor(pre) if pre else None}}
        else:
            raise ValueError(
                f"vertex {name!r} ({type(v).__name__}) has no reference "
                "Jackson tag — the reference format cannot express it")
    return json.dumps({
        "vertices": vertices,
        "vertexInputs": conf.vertex_inputs,
        "networkInputs": conf.inputs,
        "networkOutputs": conf.outputs,
        "backprop": conf.backprop,
        "pretrain": conf.pretrain,
        "backpropType": conf.backprop_type.value,
        "tbpttFwdLength": conf.tbptt_fwd_length,
        "tbpttBackLength": conf.tbptt_back_length,
    }, indent=2)


def _safe_enum(enum_cls, value, default):
    if value is None:
        return default
    try:
        return enum_cls(value)
    except ValueError:
        # tolerate case-insensitive matches (Jackson writes Java names)
        for member in enum_cls:
            if member.value.lower() == str(value).lower() \
                    or member.name.lower() == str(value).lower():
                return member
        raise
