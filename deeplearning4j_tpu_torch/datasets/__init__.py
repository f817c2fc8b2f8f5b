"""Batch containers and iterators (port of ``deeplearning4j_tpu/datasets``)."""

from deeplearning4j_tpu_torch.datasets.dataset import (  # noqa: F401
    DataSet,
    MultiDataSet,
)
from deeplearning4j_tpu_torch.datasets.iterator import (  # noqa: F401
    BucketedDataSetIterator,
    DataSetIterator,
    ListDataSetIterator,
)
