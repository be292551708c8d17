"""Multi-model hosting: named models, each behind its own batcher.

Counterpart of ``deeplearning4j_tpu/serving/registry.py``. The registry
maps ``name -> ServedModel``; each entry owns its own
:class:`~deeplearning4j_torch.serving.batcher.ContinuousBatcher`.
"""
from __future__ import annotations

from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .. import resolve_device
from .batcher import ContinuousBatcher, ModelNotFoundError
from ..monitor.lockwatch import make_lock

__all__ = ["ServedModel", "ModelRegistry", "DEFAULT_BATCH_BUCKETS"]

#: powers of two up to a modest serving batch
DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32)


class ServedModel:
    """One hosted model: the net, its batcher, and its serving config.

    ``model`` is anything with ``output(features[, mask=])``, or a
    ``ZooModel``, which is built on ``device``. ``device`` is
    where batches are staged (the card unless ``device="cpu"``); a model
    that lives on a device (``model.device``) must live there.
    ``input_shape`` (the per-example trailing shape, e.g. ``(T, vocab)``)
    enables :meth:`warm`, which runs every bucket shape once."""

    def __init__(self, name: str, model, *, device="cuda",
                 batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
                 time_buckets: Optional[Sequence[int]] = None,
                 max_queue_examples: int = 256,
                 linger_ms: float = 5.0,
                 default_deadline_ms: Optional[float] = 2000.0,
                 input_shape: Optional[Sequence[int]] = None,
                 warmup: bool = False):
        dev = resolve_device(device)
        if hasattr(model, "conf") and not hasattr(model, "output"):
            model = model.init(device=dev)          # a ZooModel, not yet built
        if not callable(getattr(model, "output", None)):
            raise TypeError(f"model {name!r} has no callable output(features)")
        model_dev = getattr(model, "device", None)
        if model_dev is not None and model_dev != dev:
            raise ValueError(f"model {name!r} lives on {model_dev}, but the "
                             f"registration serves on {dev}")
        self.name = name
        self.model = model
        self.device = dev
        self.input_shape = (tuple(int(d) for d in input_shape)
                            if input_shape is not None else None)
        self.batcher = ContinuousBatcher(
            self._forward, name=name, batch_buckets=batch_buckets,
            time_buckets=time_buckets, max_queue_examples=max_queue_examples,
            linger_ms=linger_ms, default_deadline_ms=default_deadline_ms,
            device=dev)
        if warmup:
            self.warm()

    def warm(self):
        """Run the forward once at every bucket shape (kernel builds and
        first-launch costs are paid at registration, not by requests)."""
        if self.input_shape is None:
            raise ValueError(f"model {self.name!r}: warmup needs input_shape=")
        b = self.batcher
        shape = self.input_shape
        for n in b._bb:
            if b._tb is not None and len(shape) >= 2:
                for tt in b._tb:
                    xs = np.zeros((n, tt) + shape[1:], np.float32)
                    self._forward(xs, np.ones((n, tt), np.float32))
            else:
                self._forward(np.zeros((n,) + shape, np.float32))
        return self

    def _forward(self, xs, mask=None):
        return self.model.output(xs) if mask is None \
            else self.model.output(xs, mask=mask)

    def submit(self, x, deadline_ms: Optional[float] = None) -> Future:
        return self.batcher.submit(x, deadline_ms=deadline_ms)

    def predict(self, x, deadline_ms: Optional[float] = None,
                timeout: float = 60.0):
        """Synchronous convenience: submit + wait for the result rows."""
        return self.submit(x, deadline_ms=deadline_ms).result(timeout)

    def stats(self) -> Dict[str, Any]:
        b = self.batcher
        return {
            "name": self.name,
            "model": type(self.model).__name__,
            "device": str(self.device),
            "queue_depth": b.queue_depth(),
            "batch_buckets": list(b._bb),
            "time_buckets": list(b._tb) if b._tb else None,
            "max_queue_examples": b.max_queue_examples,
            "linger_ms": b.linger_ms,
            "default_deadline_ms": b.default_deadline_ms,
        }

    def close(self, drain: bool = True, timeout: float = 30.0):
        self.batcher.close(drain=drain, timeout=timeout)


class ModelRegistry:
    """Thread-safe name -> :class:`ServedModel` table. The lock covers the
    name map only; request traffic never runs under it."""

    def __init__(self):
        self._lock = make_lock("ModelRegistry._lock")
        self._models: Dict[str, ServedModel] = {}
        self._reserved: set = set()

    def register(self, name: str, model, **config) -> ServedModel:
        """Host ``model`` under ``name`` (config: see :class:`ServedModel`).
        Re-using a live name raises; the name is reserved before the
        (possibly slow, warming) construction, which runs unlocked."""
        with self._lock:
            if name in self._models or name in self._reserved:
                raise ValueError(f"model {name!r} already registered — "
                                 f"unregister it first")
            self._reserved.add(name)
        try:
            served = ServedModel(name, model, **config)
            with self._lock:
                self._models[name] = served
        finally:
            with self._lock:
                self._reserved.discard(name)
        return served

    def unregister(self, name: str, drain: bool = True):
        with self._lock:
            served = self._models.pop(name, None)
        if served is None:
            raise ModelNotFoundError(name)
        served.close(drain=drain)

    def get(self, name: str) -> ServedModel:
        with self._lock:
            served = self._models.get(name)
        if served is None:
            raise ModelNotFoundError(name)
        return served

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def list_models(self) -> List[Dict[str, Any]]:
        with self._lock:
            models = sorted(self._models.items())
        return [m.stats() for _, m in models]

    def submit(self, name: str, x, deadline_ms: Optional[float] = None) -> Future:
        return self.get(name).submit(x, deadline_ms=deadline_ms)

    def predict(self, name: str, x, deadline_ms: Optional[float] = None,
                timeout: float = 60.0):
        return self.get(name).predict(x, deadline_ms=deadline_ms,
                                      timeout=timeout)

    def close_all(self, drain: bool = True, timeout: float = 30.0):
        """Stop admission on every model, serve what was accepted
        (``drain=True``), join every scheduler — outside the lock."""
        with self._lock:
            models, self._models = list(self._models.values()), {}
        for m in models:
            m.close(drain=drain, timeout=timeout)
