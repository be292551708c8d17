"""Data normalizers with fit/transform/revert and serialization.

Counterpart of ``deeplearning4j_tpu/datasets/normalizers.py`` (the ND4J
``NormalizerStandardize``, ``NormalizerMinMaxScaler`` and
``ImagePreProcessingScaler``). numpy only. ``to_bytes`` writes the JAX
package's format (JSON ``{"type": ..., "state": ...}``), so a normalizer
written by either package loads in the other.
"""
from __future__ import annotations

import json
from typing import Optional

import numpy as np

from .dataset import DataSet

__all__ = ["Normalizer", "NormalizerStandardize", "NormalizerMinMaxScaler",
           "ImagePreProcessingScaler"]


class Normalizer:
    """Base: fit on a DataSet or an iterator of them; transform and revert
    DataSets in place (by reassigning ``ds.features``, which invalidates
    the ``CacheMode.DEVICE`` cache)."""

    TYPE = "base"
    _REGISTRY = {}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        Normalizer._REGISTRY[cls.TYPE] = cls

    def fit(self, data):
        """``data``: DataSet or iterator of DataSets."""
        if isinstance(data, DataSet):
            self._fit_arrays([np.asarray(data.features)])
        else:
            self._fit_arrays([np.asarray(ds.features) for ds in data])
        return self

    def _fit_arrays(self, arrays):
        raise NotImplementedError

    def transform(self, ds):
        ds.features = self._apply(np.asarray(ds.features))
        return ds

    def pre_process(self, ds):
        return self.transform(ds)

    preProcess = pre_process

    def revert(self, ds):
        ds.features = self._invert(np.asarray(ds.features))
        return ds

    def revert_features(self, features):
        return self._invert(np.asarray(features))

    revertFeatures = revert_features

    def _apply(self, x):
        raise NotImplementedError

    def _invert(self, x):
        raise NotImplementedError

    def _state(self) -> dict:
        raise NotImplementedError

    def _load_state(self, state: dict):
        raise NotImplementedError

    def to_bytes(self) -> bytes:
        state = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                 for k, v in self._state().items()}
        return json.dumps({"type": self.TYPE, "state": state}).encode("utf-8")

    @staticmethod
    def from_bytes(data: bytes) -> "Normalizer":
        doc = json.loads(data.decode("utf-8"))
        cls = Normalizer._REGISTRY[doc["type"]]
        obj = cls()
        obj._load_state(doc["state"])
        return obj


def _stat_axes(ndim: int):
    """Axes reduced for per-feature statistics (ND4J semantics): 2-D [b, f]
    per column; 3-D [b, T, f] per feature across batch and time; 4-D NCHW
    per channel."""
    if ndim == 2:
        return (0,)
    if ndim == 3:
        return (0, 1)
    if ndim == 4:
        return (0, 2, 3)
    raise ValueError(f"Unsupported feature rank {ndim}")


def _bshape(ndim: int):
    """Shape that broadcasts per-feature statistics against rank-``ndim`` data."""
    if ndim == 2:
        return (1, -1)
    if ndim == 3:
        return (1, 1, -1)
    return (1, -1, 1, 1)  # NCHW channel


class NormalizerStandardize(Normalizer):
    """Zero mean, unit variance per feature, from moments accumulated in
    f64 over the fit batches."""

    TYPE = "standardize"

    def __init__(self):
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None

    def _fit_arrays(self, arrays):
        total = sum_ = sumsq = None
        for a in arrays:
            a = a.astype(np.float64)
            axes = _stat_axes(a.ndim)
            n = int(np.prod([a.shape[i] for i in axes]))
            s = a.sum(axis=axes)
            ss = (a * a).sum(axis=axes)
            if sum_ is None:
                total, sum_, sumsq = n, s, ss
            else:
                total, sum_, sumsq = total + n, sum_ + s, sumsq + ss
        self.mean = sum_ / total
        self.std = np.sqrt(np.maximum(sumsq / total - self.mean ** 2, 0.0))
        self.std[self.std < 1e-8] = 1.0

    def _apply(self, x):
        b = _bshape(x.ndim)
        return ((x - self.mean.reshape(b)) / self.std.reshape(b)).astype(x.dtype)

    def _invert(self, x):
        b = _bshape(x.ndim)
        return (x * self.std.reshape(b) + self.mean.reshape(b)).astype(x.dtype)

    def _state(self):
        return {"mean": self.mean, "std": self.std}

    def _load_state(self, s):
        self.mean = np.asarray(s["mean"])
        self.std = np.asarray(s["std"])


class NormalizerMinMaxScaler(Normalizer):
    """Scale each feature to [min_range, max_range]."""

    TYPE = "minmax"

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0):
        self.min_range = float(min_range)
        self.max_range = float(max_range)
        self.data_min: Optional[np.ndarray] = None
        self.data_max: Optional[np.ndarray] = None

    def _fit_arrays(self, arrays):
        lo = hi = None
        for a in arrays:
            a = a.astype(np.float64)
            axes = _stat_axes(a.ndim)
            mn, mx = a.min(axis=axes), a.max(axis=axes)
            lo = mn if lo is None else np.minimum(lo, mn)
            hi = mx if hi is None else np.maximum(hi, mx)
        self.data_min, self.data_max = lo, hi

    def _scale(self):
        rng = self.data_max - self.data_min
        rng[rng < 1e-8] = 1.0
        return rng

    def _apply(self, x):
        b = _bshape(x.ndim)
        unit = (x - self.data_min.reshape(b)) / self._scale().reshape(b)
        return (unit * (self.max_range - self.min_range) + self.min_range).astype(x.dtype)

    def _invert(self, x):
        b = _bshape(x.ndim)
        unit = (x - self.min_range) / (self.max_range - self.min_range)
        return (unit * self._scale().reshape(b) + self.data_min.reshape(b)).astype(x.dtype)

    def _state(self):
        return {"min_range": self.min_range, "max_range": self.max_range,
                "data_min": self.data_min, "data_max": self.data_max}

    def _load_state(self, s):
        self.min_range = s["min_range"]
        self.max_range = s["max_range"]
        self.data_min = np.asarray(s["data_min"])
        self.data_max = np.asarray(s["data_max"])


class ImagePreProcessingScaler(Normalizer):
    """Pixel scaling [0, max_pixel] -> [min_range, max_range], no fitted
    statistics (default /255)."""

    TYPE = "image"

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0,
                 max_pixel: float = 255.0):
        self.min_range = float(min_range)
        self.max_range = float(max_range)
        self.max_pixel = float(max_pixel)

    def _fit_arrays(self, arrays):
        pass  # stateless

    def _apply(self, x):
        return (x / self.max_pixel * (self.max_range - self.min_range)
                + self.min_range).astype(np.float32)

    def _invert(self, x):
        return ((x - self.min_range) / (self.max_range - self.min_range)
                * self.max_pixel).astype(np.float32)

    def _state(self):
        return {"min_range": self.min_range, "max_range": self.max_range,
                "max_pixel": self.max_pixel}

    def _load_state(self, s):
        self.min_range = s["min_range"]
        self.max_range = s["max_range"]
        self.max_pixel = s["max_pixel"]
