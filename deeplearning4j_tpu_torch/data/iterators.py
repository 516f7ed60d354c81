"""DataSetIterators — port of the part of
``deeplearning4j_tpu/data/iterators.py`` the char-RNN trains through:
``BaseDatasetIterator`` (the reference's DataSetIterator protocol:
hasNext/next/reset/batch) and ``ListDataSetIterator``.

Not ported yet: the MNIST/EMNIST/CIFAR/IRIS iterators and their offline
procedural datasets, ``ArrayDataSetIterator``, ``IteratorDataSetIterator``,
the random, k-fold and sequence iterators.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from .dataset import DataSet


class BaseDatasetIterator:
    """Python-iterable + reference-style hasNext/next protocol."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self._cursor = 0

    # --- python protocol ---------------------------------------------------
    def __iter__(self):
        self.reset()
        return self

    def __next__(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        return self.next()

    def __len__(self):
        return math.ceil(self.total_examples() / self.batch_size)

    # --- reference protocol ------------------------------------------------
    def has_next(self) -> bool:
        return self._cursor < self.total_examples()

    def next(self, num: Optional[int] = None) -> DataSet:
        n = num or self.batch_size
        ds = self._slice(self._cursor,
                         min(self._cursor + n, self.total_examples()))
        self._cursor += n
        return ds

    def reset(self):
        self._cursor = 0

    def batch(self) -> int:
        return self.batch_size

    def total_examples(self) -> int:
        raise NotImplementedError

    def _slice(self, lo, hi) -> DataSet:
        raise NotImplementedError

    def total_outcomes(self) -> int:
        return -1

    def input_columns(self) -> int:
        return -1

    def async_supported(self) -> bool:
        return True


class ListDataSetIterator(BaseDatasetIterator):
    """Iterates a list of pre-built DataSets (reference ListDataSetIterator)."""

    def __init__(self, data, batch_size: Optional[int] = None):
        if isinstance(data, DataSet):
            data = [data]
        self._datasets = list(data)
        self._full = (DataSet.merge(self._datasets) if len(self._datasets) > 1
                      else self._datasets[0])
        super().__init__(batch_size or self._full.num_examples())

    def total_examples(self):
        return self._full.num_examples()

    def _slice(self, lo, hi):
        return self._full._take(np.arange(lo, hi))

    def total_outcomes(self):
        return int(self._full.labels.shape[-1])
