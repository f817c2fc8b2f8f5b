"""Batch containers, iterators and fetchers (port of
``deeplearning4j_tpu/datasets``)."""

from deeplearning4j_tpu_torch.datasets.dataset import (  # noqa: F401
    DataSet,
    MultiDataSet,
)
from deeplearning4j_tpu_torch.datasets.iterator import (  # noqa: F401
    AsyncDataSetIterator,
    BaseDataSetIterator,
    BucketedDataSetIterator,
    DataSetIterator,
    ListDataSetIterator,
    MultipleEpochsIterator,
    ReconstructionDataSetIterator,
    SamplingDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.fetchers import (  # noqa: F401
    CifarDataSetIterator,
    CurvesDataSetIterator,
    IrisDataSetIterator,
    LFWDataSetIterator,
    MnistDataSetIterator,
    MovingWindowDataSetIterator,
    RawMnistDataSetIterator,
)
