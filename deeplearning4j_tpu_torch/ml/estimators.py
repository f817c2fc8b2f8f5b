"""Network-backed pipeline stages: classification / reconstruction /
unsupervised.

Reference: `dl4j-spark-ml/.../ml/classification/
MultiLayerNetworkClassification.scala` (207 — Estimator producing a Model
whose transform adds a prediction column), `ml/reconstruction/
MultiLayerNetworkReconstruction.scala` (190 — adds a reconstruction column
from a chosen layer), `ml/Unsupervised.scala` (154 — pretrain-only fit).
Each estimator takes a ``MultiLayerConfiguration`` (the same JSON-round-
trippable conf the whole framework uses) plus train-loop params, and fits a
``MultiLayerNetwork`` under the hood, on ``device`` (default: the card).
Port of ``deeplearning4j_tpu/ml/estimators.py``; columns stay numpy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator
from deeplearning4j_tpu_torch.ml.pipeline import Dataset, Estimator, Transformer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork


def _host(a) -> np.ndarray:
    """A network output (a device tensor) as a numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu")
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a)


def _one_hot(labels: np.ndarray, num_classes: int) -> np.ndarray:
    return np.eye(num_classes, dtype=np.float32)[
        np.asarray(labels, np.int64).ravel()]


def _iterate(x: np.ndarray, y: np.ndarray, batch_size: int):
    return ListDataSetIterator(DataSet(x, y), batch_size)


def _pretrain_net(conf, x: np.ndarray, epochs: int,
                  batch_size: int, device=None) -> MultiLayerNetwork:
    """Shared layer-wise pretraining loop for the reconstruction /
    unsupervised estimators (features reconstruct themselves)."""
    net = MultiLayerNetwork(conf, device=device).init()
    batches = [DataSet(x[i:i + batch_size], x[i:i + batch_size])
               for i in range(0, len(x), batch_size)]
    for _ in range(epochs):
        net.pretrain(batches)
    return net


class NeuralNetClassification(Estimator):
    """Classification estimator (MultiLayerNetworkClassification.scala).

    Params mirror the Scala param map: conf, epochs, batch_size, plus
    column names (features_col/label_col/prediction_col/probability_col).
    """

    def __init__(self, conf, num_classes: Optional[int] = None,
                 epochs: int = 10, batch_size: int = 32,
                 features_col: str = "features", label_col: str = "label",
                 prediction_col: str = "prediction",
                 probability_col: str = "probability", device=None):
        super().__init__(conf=conf, num_classes=num_classes, epochs=epochs,
                         batch_size=batch_size, features_col=features_col,
                         label_col=label_col, prediction_col=prediction_col,
                         probability_col=probability_col, device=device)

    def fit(self, dataset: Dataset) -> "NeuralNetClassificationModel":
        x = np.asarray(dataset[self.get("features_col")], np.float32)
        labels = np.asarray(dataset[self.get("label_col")])
        num_classes = self.get("num_classes")
        if num_classes is None:
            num_classes = int(labels.max()) + 1
        y = (labels.astype(np.float32) if labels.ndim == 2
             else _one_hot(labels, num_classes))
        net = MultiLayerNetwork(self.get("conf"),
                                device=self.get("device")).init()
        net.fit(_iterate(x, y, self.get("batch_size")),
                num_epochs=self.get("epochs"))
        return NeuralNetClassificationModel(
            net, features_col=self.get("features_col"),
            prediction_col=self.get("prediction_col"),
            probability_col=self.get("probability_col"))


class NeuralNetClassificationModel(Transformer):
    def __init__(self, network: MultiLayerNetwork, features_col: str,
                 prediction_col: str, probability_col: str):
        super().__init__(features_col=features_col,
                         prediction_col=prediction_col,
                         probability_col=probability_col)
        self.network = network

    def transform(self, dataset: Dataset) -> Dataset:
        out = dict(dataset)
        x = np.asarray(dataset[self.get("features_col")], np.float32)
        probs = _host(self.network.output(x))
        out[self.get("probability_col")] = probs
        out[self.get("prediction_col")] = probs.argmax(axis=1)
        return out

    def predict(self, x: np.ndarray) -> np.ndarray:
        return _host(self.network.output(
            np.asarray(x, np.float32))).argmax(axis=1)


class NeuralNetReconstruction(Estimator):
    """Reconstruction estimator (MultiLayerNetworkReconstruction.scala):
    pretrains an autoencoder-style conf; transform adds the hidden
    representation of ``layer_index`` as the reconstruction column."""

    def __init__(self, conf, epochs: int = 10, batch_size: int = 32,
                 layer_index: int = 0, features_col: str = "features",
                 reconstruction_col: str = "reconstruction", device=None):
        super().__init__(conf=conf, epochs=epochs, batch_size=batch_size,
                         layer_index=layer_index, features_col=features_col,
                         reconstruction_col=reconstruction_col,
                         device=device)

    def fit(self, dataset: Dataset) -> "NeuralNetReconstructionModel":
        x = np.asarray(dataset[self.get("features_col")], np.float32)
        net = _pretrain_net(self.get("conf"), x, self.get("epochs"),
                            self.get("batch_size"), self.get("device"))
        return NeuralNetReconstructionModel(
            net, layer_index=self.get("layer_index"),
            features_col=self.get("features_col"),
            reconstruction_col=self.get("reconstruction_col"))


class NeuralNetReconstructionModel(Transformer):
    def __init__(self, network: MultiLayerNetwork, layer_index: int,
                 features_col: str, reconstruction_col: str):
        super().__init__(layer_index=layer_index, features_col=features_col,
                         reconstruction_col=reconstruction_col)
        self.network = network

    def transform(self, dataset: Dataset) -> Dataset:
        out = dict(dataset)
        x = np.asarray(dataset[self.get("features_col")], np.float32)
        acts = self.network.feed_forward(x)
        out[self.get("reconstruction_col")] = _host(
            acts[self.get("layer_index") + 1])
        return out


class NeuralNetUnsupervised(Estimator):
    """Pretrain-only estimator (Unsupervised.scala): fits by layer-wise
    pretraining and exposes the final hidden features."""

    def __init__(self, conf, epochs: int = 10, batch_size: int = 32,
                 features_col: str = "features",
                 output_col: str = "embedding", device=None):
        super().__init__(conf=conf, epochs=epochs, batch_size=batch_size,
                         features_col=features_col, output_col=output_col,
                         device=device)

    def fit(self, dataset: Dataset) -> "NeuralNetUnsupervisedModel":
        x = np.asarray(dataset[self.get("features_col")], np.float32)
        net = _pretrain_net(self.get("conf"), x, self.get("epochs"),
                            self.get("batch_size"), self.get("device"))
        return NeuralNetUnsupervisedModel(
            net, features_col=self.get("features_col"),
            output_col=self.get("output_col"))


class NeuralNetUnsupervisedModel(Transformer):
    def __init__(self, network: MultiLayerNetwork, features_col: str,
                 output_col: str):
        super().__init__(features_col=features_col, output_col=output_col)
        self.network = network

    def transform(self, dataset: Dataset) -> Dataset:
        out = dict(dataset)
        x = np.asarray(dataset[self.get("features_col")], np.float32)
        acts = self.network.feed_forward(x)
        out[self.get("output_col")] = _host(acts[-2] if len(acts) > 2
                                            else acts[-1])
        return out
