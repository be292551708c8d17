"""Shape-bucketed batching: pad each batch up to one of a closed set of shapes.

Counterpart of ``deeplearning4j_tpu/datasets/bucketing.py``: the bucket
rules (a bucket spec is a sorted set of positive sizes, and a size goes to
the smallest bucket that admits it; shared with the serving batcher) and
:class:`ShapeBucketingDataSetIterator`, which pads every batch up to a
bucket of batch size and, for sequence data, of length.

Padding never trains, by the masking conventions of the reference:

- padded time steps get a zero ``features_mask``/``labels_mask`` entry;
- padded batch rows get a zero ``labels_mask`` row, so their loss is 0;
- the real mask entries are scaled by ``padded_b / real_b``: the loss
  divides by the minibatch size, which padding inflates, so the padded
  batch's loss and gradients equal the unpadded batch's.
  ``rescale_loss=False`` keeps 0/1 masks.

A ``labels_mask`` is made for every batch and sequence batches always
carry a ``features_mask``, so mask presence does not vary from batch to
batch either. Batch-statistics layers see the padded rows.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .dataset import DataSet, DataSetIterator, MultiDataSet

__all__ = ["ShapeBucketingDataSetIterator", "validate_buckets", "bucket_for"]


def validate_buckets(values: Sequence[int], kind: str = "batch") -> List[int]:
    """Normalize a bucket spec: sorted unique positive ints, loud on junk."""
    out = sorted({int(v) for v in values})
    if not out or out[0] < 1:
        raise ValueError(f"{kind} buckets must be positive ints, got "
                         f"{list(values)}")
    return out


def bucket_for(buckets, n: int, kind: str = "batch") -> int:
    """Smallest bucket admitting ``n``; oversize is rejected loudly."""
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(
        f"{kind} size {n} exceeds the largest configured bucket "
        f"{buckets[-1]} — add a bucket >= {n} (buckets: {buckets})")


def _pad_axis0(arr: np.ndarray, b: int, t: Optional[int] = None):
    """Zero-pad ``arr`` to ``b`` rows (and, when ``t`` is given and the
    array has a time axis, ``t`` steps)."""
    shape = list(arr.shape)
    shape[0] = b
    if t is not None and arr.ndim >= 2:
        shape[1] = t
    if shape == list(arr.shape):
        return arr
    out = np.zeros(shape, arr.dtype)
    sl = (slice(0, arr.shape[0]),) + (
        (slice(0, arr.shape[1]),) if t is not None and arr.ndim >= 2 else ())
    out[sl] = arr
    return out


def _per_step(labels: np.ndarray, T: Optional[int]) -> bool:
    """Whether labels have a time axis: rank 3, or rank 2 spanning the
    sequence's T ([b, T] sparse class ids). Other rank-2 labels are [b,
    n_classes] vectors, padded along the batch only."""
    return labels.ndim == 3 or (T is not None and labels.ndim == 2 and labels.shape[1] == T)


class ShapeBucketingDataSetIterator(DataSetIterator):
    """Pad each batch up to the smallest admitting bucket shape.

    ``batch_buckets``: allowed batch sizes (e.g. ``(32, 64, 128)``).
    ``time_buckets``: allowed sequence lengths for rank-3 ``[b, T, f]``
    features (None: the time dim passes through). ``rescale_loss``: scale
    the made ``labels_mask`` by ``padded_b / real_b`` so the padded batch's
    loss and gradients equal the unpadded ones.
    """

    def __init__(self, base: DataSetIterator, batch_buckets: Sequence[int],
                 time_buckets: Optional[Sequence[int]] = None, rescale_loss: bool = True):
        self._base = base
        self._bb = validate_buckets(batch_buckets, "batch")
        self._tb = validate_buckets(time_buckets, "time") if time_buckets else None
        self._rescale = bool(rescale_loss)
        self._it = None

    @property
    def buckets(self):
        return list(self._bb)

    def __iter__(self):
        self._it = iter(self._base)
        return self

    def __next__(self) -> DataSet:
        if self._it is None:
            self._it = iter(self._base)
        return self.pad(next(self._it))

    def reset(self):
        self._base.reset()
        self._it = iter(self._base)

    def batch(self):
        return self._base.batch()

    def pad(self, ds: DataSet) -> DataSet:
        if isinstance(ds, MultiDataSet):
            raise TypeError("ShapeBucketingDataSetIterator pads DataSet streams; wrap the "
                            "per-stream iterators before merging into MultiDataSets")
        f = np.asarray(ds.features)
        b = int(f.shape[0])
        tb = bucket_for(self._bb, b, "batch")
        seq = f.ndim == 3
        T = int(f.shape[1]) if seq else None
        tt = bucket_for(self._tb, T, "time") if seq and self._tb is not None else T

        out = DataSet(_pad_axis0(f, tb, tt if seq else None))
        if ds.labels is not None:
            l = np.asarray(ds.labels)
            out.labels = _pad_axis0(l, tb, tt if _per_step(l, T) else None)
        if seq:
            fm = (np.asarray(ds.features_mask, np.float32) if ds.features_mask is not None
                  else np.ones((b, T), np.float32))
            out.features_mask = _pad_axis0(fm, tb, tt)
        if ds.labels is not None:
            out.labels_mask = self._labels_mask(ds, b, tb, T, tt)
        return out

    def _labels_mask(self, ds: DataSet, b: int, tb: int, T: Optional[int],
                     tt: Optional[int]) -> np.ndarray:
        if ds.labels_mask is not None:
            lm = np.asarray(ds.labels_mask, np.float32)
        elif _per_step(np.asarray(ds.labels), T):
            # the features mask, so that time padding in the labels also
            # stays out of the loss (one [b, T] mask)
            lm = (np.asarray(ds.features_mask, np.float32) if ds.features_mask is not None
                  else np.ones((b, T), np.float32))
        else:
            lm = np.ones((b,), np.float32)
        if self._rescale and tb != b:
            # the loss divides by the padded minibatch size; the rescale
            # restores the unpadded batch's loss and gradient magnitude
            lm = lm * (tb / float(b))
        return _pad_axis0(lm, tb, tt if lm.ndim >= 2 else None)
