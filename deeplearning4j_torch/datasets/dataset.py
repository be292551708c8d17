"""DataSet containers and the iterator protocol.

Counterpart of ``deeplearning4j_tpu/datasets/dataset.py`` (``DataSet``,
``MultiDataSet``, ``DataSetIterator``, ``ListDataSetIterator``,
``ExistingDataSetIterator`` and the ``CacheMode.DEVICE`` cache). Arrays
are host numpy; the fit loops move each minibatch to the network's device
(through ``datasets/prefetch.py`` by default). Masks follow the reference:
``features_mask``/``labels_mask`` are [batch, T] arrays (values in
[0, 1]) for sequence data.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

__all__ = ["DataSet", "MultiDataSet", "DataSetIterator", "ListDataSetIterator",
           "ExistingDataSetIterator", "to_tensor"]


def _opt(a):
    return None if a is None else np.asarray(a)


def to_tensor(a, device, non_blocking=False):
    """One batch array as the tensor a training step reads: floating data
    as float32 (cast on the host), other types kept, on ``device``. The
    synchronous path, the put-ahead and the device cache all build their
    tensors with this cast, so a step sees the same bits on each. A tensor
    already of that type on ``device`` is returned as it is."""
    if a is None:
        return None
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    if t.is_floating_point():
        t = t.float()
    return t.to(device, non_blocking=non_blocking)


def _array_key(a):
    """Identity key for the device cache. The cache retains the keyed host
    arrays (``_cached_device_put`` stores them beside the key), so a live
    key's ``id``/data pointer cannot be recycled by the allocator: identity
    compare is sound, and reassignment (what normalizers do) always
    misses."""
    if a is None:
        return None
    data_ptr = getattr(a, "__array_interface__", {"data": (0,)})["data"][0]
    return (id(a), data_ptr, tuple(a.shape), str(a.dtype))


class DeviceArrays:
    """A cache entry: the arrays as tensors on one device, and the CUDA
    event after their copies when a side stream made them (None when the
    caller's stream did). :meth:`ready` orders the calling thread's current
    stream after the copies and records that stream on each tensor, so the
    caching allocator keeps their memory until the work that reads them
    has run."""

    __slots__ = ("arrays", "event")

    def __init__(self, arrays, event=None):
        self.arrays = arrays
        self.event = event

    def ready(self):
        if self.event is not None:
            tensors = [t for t in _flatten(self.arrays) if t is not None]
            stream = torch.cuda.current_stream(tensors[0].device)
            stream.wait_event(self.event)
            for t in tensors:
                t.record_stream(stream)
        return self.arrays


def _flatten(arrays):
    for a in arrays:
        if isinstance(a, (tuple, list)):
            yield from a
        else:
            yield a


def _cached_device_put(container, device, build, retain):
    """The ``CacheMode.DEVICE`` machinery: rebuild the entry only when the
    container's ``_device_key()`` or the device changes. ``build()``
    returns a :class:`DeviceArrays`; ``retain`` is the tuple of host arrays
    the key describes, kept alive on the container so that freed-memory id
    reuse can never alias a stale key. Returns the entry."""
    key = (container._device_key(), str(device))
    entry = getattr(container, "_dev", None)
    if getattr(container, "_dev_key", None) != key or entry is None:
        entry = build()
        container._dev, container._dev_key, container._dev_retained = entry, key, retain
    return entry


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

    # ------------------------------------------------- device residency
    def _device_key(self):
        return tuple(_array_key(a) for a in self._arrays())

    def _device_entry(self, device, put=None) -> DeviceArrays:
        """The cache entry on ``device``, built with ``put`` (arrays ->
        :class:`DeviceArrays`) when the key changed; ``put`` defaults to a
        copy on the calling thread's current stream."""
        arrays = self._arrays()
        if put is None:
            def put(arrs):
                return DeviceArrays(tuple(to_tensor(a, device) for a in arrs))
        return _cached_device_put(self, device, lambda: put(arrays), arrays)

    def device_arrays(self, device):
        """``CacheMode.DEVICE`` (reference ``nn/conf/CacheMode.java``):
        (features, labels, features_mask, labels_mask) as tensors on
        ``device``, copied once and reused across fits and epochs until the
        arrays change. The cache is keyed on the arrays' identity and data
        pointer, so normalizers (which reassign ``ds.features``) invalidate
        it; writes in place into the same buffer are not detected, as in
        the reference: reassign or build a new DataSet instead."""
        return self._device_entry(device).ready()

    def get_features(self):
        return self.features

    def get_labels(self):
        return self.labels

    def _take(self, idx) -> "DataSet":
        return DataSet(*(None if a is None else a[idx] for a in self._arrays()))

    def split_test_and_train(self, n_train: int):
        """(the first ``n_train`` examples, the rest)."""
        return self._take(slice(0, n_train)), self._take(slice(n_train, None))

    splitTestAndTrain = split_test_and_train

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        n = self.num_examples()
        return [self._take(slice(i, min(i + batch_size, n))) for i in range(0, n, batch_size)]

    def shuffle(self, seed=None):
        idx = np.random.default_rng(seed).permutation(self.num_examples())
        self.features, self.labels, self.features_mask, self.labels_mask = \
            self._take(idx)._arrays()

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        """Concatenate example-wise. Mixed mask presence synthesizes
        all-ones masks for the unmasked sets."""
        def cat(xs):
            return None if any(x is None for x in xs) else np.concatenate(xs, axis=0)
        return DataSet(cat([d.features for d in datasets]),
                       cat([d.labels for d in datasets]),
                       _cat_masks([d.features_mask for d in datasets],
                                  [d.features for d in datasets]),
                       _cat_masks([d.labels_mask for d in datasets],
                                  [d.labels for d in datasets]))


class MultiDataSet:
    """Multi-input/multi-output container (ND4J ``MultiDataSet``)."""

    def __init__(self, features, labels, features_masks=None, labels_masks=None):
        self.features = [np.asarray(f) for f in _as_list(features)]
        self.labels = [np.asarray(l) for l in _as_list(labels)]
        self.features_masks = (None if features_masks is None
                               else [_opt(m) for m in _as_list(features_masks)])
        self.labels_masks = (None if labels_masks is None
                             else [_opt(m) for m in _as_list(labels_masks)])

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])

    def _streams(self):
        return (self.features, self.labels, self.features_masks, self.labels_masks)

    def _device_key(self):
        return tuple(None if seq is None else tuple(_array_key(a) for a in seq)
                     for seq in self._streams())

    def _device_entry(self, device, put=None) -> DeviceArrays:
        streams = tuple(None if seq is None else tuple(seq) for seq in self._streams())
        if put is None:
            def put(arrs):
                return DeviceArrays(tuple(to_tensor(a, device) for a in arrs))

        def build():
            flat = [a for seq in streams if seq is not None for a in seq]
            entry = put(flat)
            it = iter(entry.arrays)
            return DeviceArrays(tuple(None if seq is None else tuple(next(it) for _ in seq)
                                      for seq in streams), entry.event)
        return _cached_device_put(self, device, build, streams)

    def device_arrays(self, device):
        """``CacheMode.DEVICE`` for the multi-stream container: (features,
        labels, features_masks, labels_masks), each a tuple of tensors on
        ``device`` or None; see :meth:`DataSet.device_arrays`."""
        return self._device_entry(device).ready()

    @staticmethod
    def merge(datasets: Sequence["MultiDataSet"]) -> "MultiDataSet":
        """Concatenate example-wise, stream by stream (ND4J
        ``MultiDataSet.merge``). Mixed mask presence synthesizes all-ones
        masks for the unmasked sets: dropping the mask stream would train
        on padding."""
        def cat_streams(streams):
            if any(s is None for s in streams):
                return None
            return [np.concatenate([s[i] for s in streams], axis=0)
                    for i in range(len(streams[0]))]

        def cat_mask_streams(mask_lists, data_lists):
            if all(m is None for m in mask_lists):
                return None
            return [_cat_masks([None if ml is None else ml[i] for ml in mask_lists],
                               [dl[i] for dl in data_lists])
                    for i in range(len(data_lists[0]))]

        return MultiDataSet(
            cat_streams([d.features for d in datasets]),
            cat_streams([d.labels for d in datasets]),
            cat_mask_streams([d.features_masks for d in datasets],
                             [d.features for d in datasets]),
            cat_mask_streams([d.labels_masks for d in datasets],
                             [d.labels for d in datasets]))


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _cat_masks(masks, data):
    """Concatenate per-example masks; when presence is mixed, missing masks
    become all-ones shaped after their data's leading mask dims."""
    if all(m is None for m in masks):
        return None
    ndim = next(m.ndim for m in masks if m is not None)
    filled = [m if m is not None else np.ones(np.asarray(d).shape[:ndim], np.float32)
              for m, d in zip(masks, data)]
    return np.concatenate(filled, axis=0)


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

    def async_supported(self) -> bool:
        """Whether the fit loops may wrap this iterator in the prefetch
        pipeline (``datasets/prefetch.py``)."""
        return True

    def concurrent_pull_supported(self) -> bool:
        """True when ``__next__`` is safe to call from several prefetch
        workers at once: needed for a slow source (disk decode, network
        fetch) to run in parallel, not just a slow transform. Default
        False: most iterators hold unguarded position state. Opt in only
        when the iterator serializes its own bookkeeping and tolerates
        best-effort ordering at the stream tail."""
        return False


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


class ExistingDataSetIterator(DataSetIterator):
    """Wraps any python iterable of DataSets."""

    def __init__(self, iterable):
        self._iterable = iterable
        self._it = None

    def __iter__(self):
        self._it = iter(self._iterable)
        return self

    def __next__(self):
        if self._it is None:
            self._it = iter(self._iterable)
        return next(self._it)

    def reset(self):
        self._it = iter(self._iterable)

    def batch(self):
        return -1
