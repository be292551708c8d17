"""Concrete dataset iterators: MNIST, EMNIST, IRIS, CIFAR, LFW, TinyImageNet.

Counterpart of ``deeplearning4j_tpu/datasets/impl.py`` (reference
``datasets/iterator/impl/``: ``MnistDataSetIterator``,
``EmnistDataSetIterator``, ``IrisDataSetIterator``, ``CifarDataSetIterator``
...) on the port's ``DataSetIterator``. Constructor shapes mirror the
reference; data comes from :mod:`.fetchers` (local files or the
deterministic synthetic stand-in), and each DataSet carries
``synthetic``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .dataset import DataSet, DataSetIterator
from .fetchers import (MnistDataFetcher, EmnistDataFetcher, IrisDataFetcher,
                       CifarDataFetcher, LFWDataFetcher, TinyImageNetFetcher)


class _ArrayIterator(DataSetIterator):
    """Minibatch iterator over in-memory feature/label arrays."""

    def __init__(self, features, labels, batch_size: int,
                 num_examples: Optional[int] = None, synthetic: bool = False):
        n = len(features) if num_examples is None else min(num_examples,
                                                           len(features))
        self._features = features[:n]
        self._labels = labels[:n]
        self._batch = int(batch_size)
        self._pos = 0
        self._synthetic = bool(synthetic)

    def __next__(self) -> DataSet:
        if self._pos >= len(self._features):
            raise StopIteration
        sl = slice(self._pos, self._pos + self._batch)
        self._pos += self._batch
        ds = DataSet(self._features[sl], self._labels[sl])
        ds.synthetic = self._synthetic  # loud stand-in-data marker
        return ds

    def reset(self):
        self._pos = 0

    def batch(self) -> int:
        return self._batch

    def total_examples(self) -> int:
        return len(self._features)

    totalExamples = total_examples

    def num_outcomes(self) -> int:
        return int(self._labels.shape[-1])


class MnistDataSetIterator(_ArrayIterator):
    """Reference ``MnistDataSetIterator(batch, numExamples, binarize, train,
    shuffle, rngSeed)``."""

    def __init__(self, batch: int, num_examples: Optional[int] = None,
                 binarize: bool = False, train: bool = True,
                 shuffle: bool = True, seed: int = 123, **fetcher_kw):
        f = MnistDataFetcher(train=train, binarize=binarize, shuffle=shuffle,
                             seed=seed, **fetcher_kw)
        self.fetcher = f
        super().__init__(f.features, f.labels, batch, num_examples,
                         synthetic=f.is_synthetic)


class EmnistDataSetIterator(_ArrayIterator):
    def __init__(self, split: str, batch: int,
                 num_examples: Optional[int] = None, train: bool = True,
                 shuffle: bool = True, seed: int = 123, **fetcher_kw):
        f = EmnistDataFetcher(split=split, train=train, shuffle=shuffle,
                              seed=seed, **fetcher_kw)
        self.fetcher = f
        super().__init__(f.features, f.labels, batch, num_examples,
                         synthetic=f.is_synthetic)


class IrisDataSetIterator(_ArrayIterator):
    """Reference ``IrisDataSetIterator(batch, numExamples)``."""

    def __init__(self, batch: int = 150, num_examples: int = 150):
        f = IrisDataFetcher()
        super().__init__(f.features, f.labels, batch, num_examples)


class CifarDataSetIterator(_ArrayIterator):
    """Reference ``CifarDataSetIterator``; features NCHW [b, 3, 32, 32]."""

    def __init__(self, batch: int, num_examples: Optional[int] = None,
                 train: bool = True, seed: int = 123, **fetcher_kw):
        f = CifarDataFetcher(train=train, seed=seed, **fetcher_kw)
        self.fetcher = f
        super().__init__(f.features, f.labels, batch, num_examples,
                         synthetic=f.is_synthetic)


class LFWDataSetIterator(_ArrayIterator):
    """Reference ``LFWDataSetIterator`` (``LFWDataFetcher.java:1``); features
    NCHW [b, 3, H, W]."""

    def __init__(self, batch: int, num_examples: Optional[int] = None,
                 seed: int = 123, **fetcher_kw):
        f = LFWDataFetcher(seed=seed, **fetcher_kw)
        self.fetcher = f
        super().__init__(f.features, f.labels, batch, num_examples,
                         synthetic=f.is_synthetic)


class TinyImageNetDataSetIterator(_ArrayIterator):
    """Reference ``TinyImageNetDataSetIterator``; 200-class 64×64 RGB."""

    def __init__(self, batch: int, num_examples: Optional[int] = None,
                 seed: int = 123, **fetcher_kw):
        f = TinyImageNetFetcher(seed=seed, **fetcher_kw)
        self.fetcher = f
        super().__init__(f.features, f.labels, batch, num_examples,
                         synthetic=f.is_synthetic)
