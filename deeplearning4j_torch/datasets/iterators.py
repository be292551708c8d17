"""Iterator wrappers: async prefetch, early termination, multiple epochs,
synthetic benchmark data.

Counterpart of ``deeplearning4j_tpu/datasets/iterators.py``:
``AsyncDataSetIterator`` (one background prefetch thread,
``AsyncDataSetIterator.java``), ``EarlyTerminationDataSetIterator``,
``MultipleEpochsIterator`` and ``BenchmarkDataSetIterator``. The
reference's monitor series (``dataset_next_ms``,
``dataset_batches_total``) wait for the monitor's port.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from .dataset import DataSet, DataSetIterator

__all__ = ["AsyncDataSetIterator", "EarlyTerminationDataSetIterator",
           "MultipleEpochsIterator", "BenchmarkDataSetIterator"]


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch with a bounded buffer (reference
    ``AsyncDataSetIterator``; default queue depth 2)."""

    _STOP = object()

    def __init__(self, base: DataSetIterator, queue_size: int = 2):
        self._base = base
        self._size = max(2, queue_size)
        self._queue = None
        self._thread = None
        self._stop_event = None
        self._exc = None

    def _worker(self, q, stop):
        """The worker owns its queue and stop token, so a reset() cannot
        leak stale batches into a new epoch's queue."""
        try:
            for ds in self._base:
                while not stop.is_set():
                    try:
                        q.put(ds, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except Exception as e:  # re-raised on the consumer
            self._exc = e
        finally:
            while not stop.is_set():
                try:
                    q.put(self._STOP, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        self.reset()
        return self

    def reset(self):
        if self._thread is not None and self._thread.is_alive():
            self._stop_event.set()
            self._thread.join(timeout=5)
        self._queue = queue.Queue(maxsize=self._size)
        self._stop_event = threading.Event()
        self._exc = None
        self._thread = threading.Thread(target=self._worker,
                                        args=(self._queue, self._stop_event),
                                        daemon=True)
        self._thread.start()

    def __next__(self):
        if self._queue is None:
            self.reset()
        while True:
            # bounded get + liveness check: a worker that dies without
            # enqueueing its stop token must raise here, not park the
            # consumer on queue.get() forever
            try:
                item = self._queue.get(timeout=0.2)
                break
            except queue.Empty:
                if self._thread is not None and self._thread.is_alive():
                    continue
                # the worker may have enqueued its last item and exited
                # between the timeout and the liveness check: drain once
                try:
                    item = self._queue.get_nowait()
                    break
                except queue.Empty:
                    pass
                if self._exc is not None:
                    raise self._exc
                raise RuntimeError("AsyncDataSetIterator: prefetch worker died without "
                                   "delivering a batch or a stop token")
        if item is self._STOP:
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item

    def batch(self):
        return self._base.batch()


class EarlyTerminationDataSetIterator(DataSetIterator):
    """Caps the number of minibatches per epoch (reference
    ``EarlyTerminationDataSetIterator.java``)."""

    def __init__(self, base: DataSetIterator, max_batches: int):
        self._base = base
        self._max = max_batches
        self._count = 0

    def __iter__(self):
        self.reset()
        return self

    def __next__(self):
        if self._count >= self._max:
            raise StopIteration
        self._count += 1
        return next(self._base)

    def reset(self):
        self._base.reset()
        self._count = 0

    def batch(self):
        return self._base.batch()


class MultipleEpochsIterator(DataSetIterator):
    """Replays the base iterator N times as one pass (reference
    ``MultipleEpochsIterator.java``)."""

    def __init__(self, epochs: int, base: DataSetIterator):
        self._base = base
        self._epochs = epochs
        self._epoch = 0
        self._it = None

    def __iter__(self):
        self._epoch = 0
        self._it = iter(self._base)
        return self

    def __next__(self):
        while True:
            try:
                if self._it is None:
                    self._it = iter(self._base)
                return next(self._it)
            except StopIteration:
                self._epoch += 1
                if self._epoch >= self._epochs:
                    raise
                self._it = iter(self._base)

    def reset(self):
        self._epoch = 0
        self._it = None

    def batch(self):
        return self._base.batch()


class BenchmarkDataSetIterator(DataSetIterator):
    """Synthetic fixed-shape batches for benchmarking (reference
    ``BenchmarkDataSetIterator.java``): one batch is made from ``seed`` and
    served ``num_batches`` times, so the input costs about nothing."""

    def __init__(self, feature_shape, num_classes, num_batches, seed=42, label_shape=None):
        rng = np.random.default_rng(seed)
        self._features = rng.standard_normal(feature_shape).astype(np.float32)
        if label_shape is not None:
            self._labels = rng.standard_normal(label_shape).astype(np.float32)
        else:
            idx = rng.integers(0, num_classes, size=feature_shape[0])
            self._labels = np.eye(num_classes, dtype=np.float32)[idx]
        self._num = num_batches
        self._pos = 0

    def __iter__(self):
        self._pos = 0
        return self

    def __next__(self):
        if self._pos >= self._num:
            raise StopIteration
        self._pos += 1
        return DataSet(self._features, self._labels)

    def reset(self):
        self._pos = 0

    def batch(self):
        return int(self._features.shape[0])
