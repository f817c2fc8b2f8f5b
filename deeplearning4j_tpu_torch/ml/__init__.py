"""ML pipeline API (reference: dl4j-spark-ml — spark.ml Estimator/Model
integration, re-expressed dataframe-free over dicts of numpy columns). Port of
``deeplearning4j_tpu/ml/__init__.py``."""

from deeplearning4j_tpu_torch.ml.pipeline import (  # noqa: F401
    Dataset,
    Estimator,
    Params,
    Pipeline,
    PipelineModel,
    StandardScaler,
    StandardScalerModel,
    Transformer,
)
from deeplearning4j_tpu_torch.ml.estimators import (  # noqa: F401
    NeuralNetClassification,
    NeuralNetClassificationModel,
    NeuralNetReconstruction,
    NeuralNetReconstructionModel,
    NeuralNetUnsupervised,
    NeuralNetUnsupervisedModel,
)
