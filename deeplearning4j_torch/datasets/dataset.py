"""DataSet container and iterator protocol.

Counterpart of ``deeplearning4j_tpu/datasets/dataset.py`` (``DataSet``,
``DataSetIterator``, ``ListDataSetIterator``). Arrays are host numpy;
``MultiLayerNetwork.fit`` moves each minibatch to the network's device.
Masks follow the reference: ``features_mask``/``labels_mask`` are
[batch, T] arrays (values in [0, 1]) for sequence data.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

__all__ = ["DataSet", "DataSetIterator", "ListDataSetIterator"]


def _opt(a):
    return None if a is None else np.asarray(a)


class DataSet:
    """features/labels (+ optional masks)."""

    def __init__(self, features, labels=None, features_mask=None, labels_mask=None):
        self.features = np.asarray(features)
        self.labels = _opt(labels)
        self.features_mask = _opt(features_mask)
        self.labels_mask = _opt(labels_mask)

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    numExamples = num_examples

    def _arrays(self):
        return (self.features, self.labels, self.features_mask, self.labels_mask)

    def _take(self, idx) -> "DataSet":
        return DataSet(*(None if a is None else a[idx] for a in self._arrays()))

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        n = self.num_examples()
        return [self._take(slice(i, min(i + batch_size, n))) for i in range(0, n, batch_size)]

    def shuffle(self, seed=None):
        idx = np.random.default_rng(seed).permutation(self.num_examples())
        self.features, self.labels, self.features_mask, self.labels_mask = \
            self._take(idx)._arrays()


class DataSetIterator:
    """Iterator protocol (ND4J ``DataSetIterator``): python-iterable + reset()."""

    def __iter__(self):
        self.reset()
        return self

    def __next__(self) -> DataSet:
        raise NotImplementedError

    def reset(self):
        pass

    def batch(self) -> int:
        raise NotImplementedError


class ListDataSetIterator(DataSetIterator):
    """Reference ``ListDataSetIterator``: iterate a pre-built list of DataSets;
    with ``batch_size`` and one DataSet, iterate its minibatches."""

    def __init__(self, datasets: Sequence[DataSet], batch_size: Optional[int] = None):
        if batch_size is not None and len(datasets) == 1:
            datasets = datasets[0].batch_by(batch_size)
        self._data = list(datasets)
        self._pos = 0
        self._batch = batch_size or (self._data[0].num_examples() if self._data else 0)

    def __next__(self):
        if self._pos >= len(self._data):
            raise StopIteration
        d = self._data[self._pos]
        self._pos += 1
        return d

    def reset(self):
        self._pos = 0

    def batch(self):
        return self._batch
