"""ML pipeline abstractions: Params / Estimator / Transformer / Pipeline.

Port of ``deeplearning4j_tpu/ml/pipeline.py``, the reference's Spark ML integration
(`dl4j-spark-ml`, 2,424 LoC Scala): `ml/classification/
MultiLayerNetworkClassification.scala` et al. implement spark.ml's
Estimator/Model contract over DataFrames with a typed param map. Here the
same contract is expressed dataframe-free: a "dataset" is a plain dict of
named numpy columns (``{"features": (n, d), "label": (n,)}``), estimators
``fit`` a dataset and return a fitted Transformer (a Model), transformers
return a NEW dict with output columns added (immutably, like DataFrame
withColumn), and ``Pipeline`` chains stages the way spark.ml does —
fitting each estimator on the running transform of its predecessors.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


Dataset = Dict[str, np.ndarray]


class Params:
    """Typed param map (the spark.ml Params trait). Params are declared as
    constructor kwargs; get/set/copy work uniformly."""

    def __init__(self, **params: Any):
        self._params: Dict[str, Any] = dict(params)

    def get(self, name: str, default: Any = None) -> Any:
        return self._params.get(name, default)

    def set(self, name: str, value: Any) -> "Params":
        if name not in self._params:
            raise KeyError(f"unknown param {name!r}; declared: "
                           f"{sorted(self._params)}")
        self._params[name] = value
        return self

    def params(self) -> Dict[str, Any]:
        return dict(self._params)

    def copy(self, **overrides: Any) -> "Params":
        other = copy.deepcopy(self)
        for k, v in overrides.items():
            other.set(k, v)
        return other

    def _explain(self) -> str:
        return "\n".join(f"{k}: {v!r}" for k, v in sorted(self._params.items()))


class Transformer(Params):
    """Stage that maps dataset → dataset (spark.ml Transformer)."""

    def transform(self, dataset: Dataset) -> Dataset:
        raise NotImplementedError


class Estimator(Params):
    """Stage that learns from a dataset and yields a Transformer
    (spark.ml Estimator[M <: Model])."""

    def fit(self, dataset: Dataset) -> Transformer:
        raise NotImplementedError


class Pipeline(Estimator):
    """Ordered stages of Estimators/Transformers (org.apache.spark.ml.Pipeline
    as used by the reference's examples)."""

    def __init__(self, stages: Sequence[Any]):
        super().__init__(stages=list(stages))

    def fit(self, dataset: Dataset) -> "PipelineModel":
        stages = self.get("stages")
        fitted: List[Transformer] = []
        current = dataset
        for i, stage in enumerate(stages):
            if isinstance(stage, Estimator):
                model = stage.fit(current)
            elif isinstance(stage, Transformer):
                model = stage
            else:
                raise TypeError(f"stage {stage!r} is neither Estimator nor "
                                f"Transformer")
            if i < len(stages) - 1:  # last stage's transform is unused
                current = model.transform(current)
            fitted.append(model)
        return PipelineModel(fitted)

    def transform(self, dataset: Dataset) -> Dataset:
        raise TypeError("Pipeline must be fit() first")


class PipelineModel(Transformer):
    def __init__(self, stages: Sequence[Transformer]):
        super().__init__(stages=list(stages))

    def transform(self, dataset: Dataset) -> Dataset:
        current = dataset
        for stage in self.get("stages"):
            current = stage.transform(current)
        return current


class StandardScaler(Estimator):
    """Feature standardizer — the role the reference's examples fill with
    spark.ml feature transformers ahead of the network stage."""

    def __init__(self, input_col: str = "features",
                 output_col: str = "features"):
        super().__init__(input_col=input_col, output_col=output_col)

    def fit(self, dataset: Dataset) -> "StandardScalerModel":
        x = np.asarray(dataset[self.get("input_col")], np.float64)
        mean = x.mean(axis=0)
        std = x.std(axis=0)
        std = np.where(std > 0, std, 1.0)
        return StandardScalerModel(self.get("input_col"),
                                   self.get("output_col"), mean, std)


class StandardScalerModel(Transformer):
    def __init__(self, input_col: str, output_col: str,
                 mean: np.ndarray, std: np.ndarray):
        super().__init__(input_col=input_col, output_col=output_col)
        self.mean = mean
        self.std = std

    def transform(self, dataset: Dataset) -> Dataset:
        out = dict(dataset)
        x = np.asarray(dataset[self.get("input_col")], np.float64)
        out[self.get("output_col")] = ((x - self.mean) / self.std
                                       ).astype(np.float32)
        return out
