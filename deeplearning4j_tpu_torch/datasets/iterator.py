"""DataSetIterator protocol, ``ListDataSetIterator`` and
``BucketedDataSetIterator``.

Port of the part of ``deeplearning4j_tpu/datasets/iterator.py`` that the
network surface needs (the reference's DataSetIterator.java:53 and
ListDataSetIterator). The prefetching, sampling and multi-epoch
iterators are not ported yet (ROADMAP A11).
"""

from __future__ import annotations

from typing import Iterator, Optional

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


class DataSetIterator:
    """Iterable of DataSet minibatches with reset semantics."""

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        return self

    def __next__(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        return self.next()

    # --- protocol ---
    def has_next(self) -> bool:
        raise NotImplementedError

    def next(self, num: Optional[int] = None) -> DataSet:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def batch(self) -> int:
        raise NotImplementedError

    def total_examples(self) -> int:
        raise NotImplementedError

    def input_columns(self) -> int:
        raise NotImplementedError

    def total_outcomes(self) -> int:
        raise NotImplementedError


class ListDataSetIterator(DataSetIterator):
    """Iterator over a list of examples, re-batched (ListDataSetIterator)."""

    def __init__(self, dataset_or_list, batch_size: int = 10):
        if isinstance(dataset_or_list, DataSet):
            self._batches = dataset_or_list.batch_by(batch_size)
        else:
            merged = DataSet.merge(list(dataset_or_list))
            self._batches = merged.batch_by(batch_size)
        self.batch_size = batch_size
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._batches)

    def next(self, num=None):
        ds = self._batches[self._pos]
        self._pos += 1
        return ds

    def reset(self):
        self._pos = 0

    def batch(self):
        return self.batch_size

    def total_examples(self):
        return sum(b.num_examples() for b in self._batches)

    def input_columns(self):
        return int(self._batches[0].features.shape[-1])

    def total_outcomes(self):
        return int(self._batches[0].labels.shape[-1])


class BucketedDataSetIterator(DataSetIterator):
    """Pads every batch up the batch-bucket ladder with a labels mask that
    is zero on the pad rows (``perf.bucketing.pad_dataset``). On the card
    each distinct batch shape of a fused training path costs one CUDA-graph
    capture, so an epoch's ragged tail (100/100/56 at batch 100) would
    otherwise cost a capture of its own. BatchNorm in train mode takes its
    statistics over all rows, pad rows included: do not wrap the training
    stream of a BatchNorm network (inference uses the stored statistics)."""

    def __init__(self, underlying: DataSetIterator, buckets=None):
        self.underlying = underlying
        self.buckets = buckets

    def has_next(self):
        return self.underlying.has_next()

    def next(self, num=None):
        from deeplearning4j_tpu_torch.perf.bucketing import pad_dataset

        return pad_dataset(self.underlying.next(num), buckets=self.buckets)

    def reset(self):
        self.underlying.reset()

    def batch(self):
        return self.underlying.batch()

    def total_examples(self):
        return self.underlying.total_examples()

    def input_columns(self):
        return self.underlying.input_columns()

    def total_outcomes(self):
        return self.underlying.total_outcomes()
