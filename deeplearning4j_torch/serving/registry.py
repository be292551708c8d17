"""Multi-model hosting: named models, each behind its own batcher.

Counterpart of ``deeplearning4j_tpu/serving/registry.py``. The registry
maps ``name -> ServedModel``; each entry owns its own
:class:`~deeplearning4j_torch.serving.batcher.ContinuousBatcher` (queue,
buckets, deadlines, precision, response cache) and reports under its name
in the ``serving_*`` series and the ``serving`` block of ``GET /profile``.
``ModelRegistry(max_in_flight=)`` bounds the forwards that run at once
across its models.

Anything with ``output(features[, mask=])`` serves; a ``ZooModel`` is
built on the registration's device.
"""
from __future__ import annotations

import hashlib
import logging
import threading
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..monitor.lockwatch import make_lock
from .batcher import ContinuousBatcher, ModelNotFoundError, PRECISIONS, serving_dtype

log = logging.getLogger(__name__)

__all__ = ["ServedModel", "ModelRegistry", "DEFAULT_BATCH_BUCKETS"]

#: powers of two up to a modest serving batch
DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32)


def _flip_compute_dtype(model, dtype_name: str) -> bool:
    """Set every layer's compute dtype (and the dtype activations flow in
    between layers) of a framework net to ``dtype_name``, nested impls
    included; parameters keep their dtype. This mutates the net: two
    registrations at two precisions need two nets. The routing predicates
    read the new dtype (``lstm_fused.fwd_route`` takes the weights'
    dtype). A duck model without ``impls`` is left alone. True when a
    layer changed."""
    from ..nn.layers.base import torch_dtype
    impls = getattr(model, "impls", None)
    if impls is None:
        return False
    dt = torch_dtype(dtype_name)
    flipped = False
    stack = list(impls.values() if hasattr(impls, "values") else impls)
    while stack:
        impl = stack.pop()
        if impl is None:
            continue
        inner = getattr(impl, "inner", None)
        if inner is not None:
            stack.append(inner)
        if hasattr(impl, "compute_dtype") and impl.compute_dtype != dt:
            impl.compute_dtype = dt
            impl.out_dtype = dt if dt.itemsize < 4 else getattr(impl, "dtype", dt)
            flipped = True
    if not flipped:
        return False
    gc = getattr(model, "gc", None)
    if gc is not None and hasattr(gc, "compute_dtype"):
        gc.compute_dtype = dtype_name
    cache = getattr(model, "_jit_output", None)
    if isinstance(cache, dict):
        cache.clear()       # first calls at the old dtype do not count for the new
    return True


class ServedModel:
    """One hosted model: the net, its batcher and its serving config.

    ``device`` is where batches are staged (the card unless
    ``device="cpu"``); a model that lives on a device must live there.
    ``precision="bf16"`` flips a framework net's compute dtype to bf16 at
    registration (``"f32"`` flips it back) and casts inputs at submit;
    answers come back as float32. ``cache_size`` (examples) enables the
    response cache. ``device_path`` stages batches on ``device`` (the
    default for framework nets; a duck model gets host arrays).
    ``input_shape`` (the per-example trailing shape) enables :meth:`warm`
    and :meth:`golden`; ``warmup_artifact`` warms from an exported
    artifact (``compilecache/artifacts.py``)."""

    def __init__(self, name: str, model, *, device="cuda",
                 batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
                 time_buckets: Optional[Sequence[int]] = None,
                 max_queue_examples: int = 256,
                 linger_ms: float = 5.0,
                 default_deadline_ms: Optional[float] = 2000.0,
                 input_shape: Optional[Sequence[int]] = None,
                 warmup: bool = False,
                 qps_window_s: float = 10.0,
                 in_flight: Optional[threading.Semaphore] = None,
                 precision: str = "f32",
                 cache_size: Optional[int] = None,
                 device_path: Optional[bool] = None,
                 warmup_artifact: Optional[str] = None):
        from ..compilecache.cache import maybe_enable
        maybe_enable()
        dev = resolve_device(device)
        if hasattr(model, "conf") and not hasattr(model, "output"):
            model = model.init(device=dev)          # a ZooModel, not yet built
        if not callable(getattr(model, "output", None)):
            raise TypeError(f"model {name!r} has no callable output(features) — pass an "
                            f"initialized network or a ZooModel")
        model_dev = getattr(model, "device", None)
        if model_dev is not None and model_dev != dev:
            raise ValueError(f"model {name!r} lives on {model_dev}, but the registration "
                             f"serves on {dev}")
        if precision not in PRECISIONS:
            raise ValueError(f"model {name!r}: precision must be one of {PRECISIONS}, got "
                             f"{precision!r}")
        self.name = name
        self.model = model
        self.device = dev
        self.precision = precision
        # the declared precision holds both ways: an f32 registration flips
        # a bf16 net back
        _flip_compute_dtype(model, "bfloat16" if precision == "bf16" else "float32")
        self.input_shape = (tuple(int(d) for d in input_shape)
                            if input_shape is not None else None)
        if device_path is None:
            device_path = hasattr(model, "impls")
        #: the signatures a warmup artifact covered (empty: warmed live)
        self._aot: set = set()
        self._golden: Optional[Dict[str, Any]] = None
        self.batcher = ContinuousBatcher(
            self._forward, name=name, batch_buckets=batch_buckets, time_buckets=time_buckets,
            max_queue_examples=max_queue_examples, linger_ms=linger_ms,
            default_deadline_ms=default_deadline_ms, queue_policy="reject",
            in_flight=in_flight, metrics_label=name, qps_window_s=qps_window_s,
            precision=precision, cache_size=cache_size,
            device=dev if device_path else None)
        if warmup_artifact is not None:
            self.warm(artifact=warmup_artifact)
        elif warmup:
            self.warm()

    def warm(self, artifact: Optional[str] = None):
        """Call the forward once at every signature of the closed set
        (``compile_signatures``, in the serving dtype), so that first-call
        costs (kernel library loads, cuBLAS/cuDNN heuristics, allocator
        growth) are paid at registration, and make the bucket buffers.

        ``artifact=`` installs a warmup artifact's kernel libraries first,
        so that this warmup runs no ``nvcc``. Any mismatch or corruption
        falls back loudly (a ``compile_cache_miss`` flight event) to the
        live warmup; a loader-only replica (no ``input_shape``) whose
        artifact is rejected starts cold. Warming more buckets than
        ``DL4J_TPU_RETRACE_THRESHOLD`` back to back logs one retrace storm,
        as in the JAX package."""
        fallback = False
        if artifact is not None:
            from ..compilecache.artifacts import try_install
            fallback = not try_install(self, artifact)
        if self.input_shape is None:
            if fallback:
                log.warning("model %r: rejected warmup artifact and no input_shape "
                            "configured — starting COLD (first requests pay the first "
                            "calls)", self.name)
                return self
            raise ValueError(f"model {self.name!r}: warmup needs input_shape= (the "
                             f"per-example trailing shape) at registration")
        dt = serving_dtype(self.precision)
        dev = self.batcher._device
        for shape, _, masked in self.batcher.compile_signatures(self.input_shape):
            xs = torch.zeros(shape, dtype=dt, device=dev)
            if masked:
                self._forward(xs, torch.ones((shape[0], shape[1]), device=dev))
            else:
                self._forward(xs)
        self._warm_pads()
        return self

    def _warm_pads(self):
        b = self.batcher
        if self.input_shape is None:
            return
        if b._tb is not None and len(self.input_shape) >= 2:
            for tt in b._tb:
                b.warm_pads((tt,) + self.input_shape[1:], masked=True)
        else:
            b.warm_pads(self.input_shape)

    def export_warmup(self, out: str) -> str:
        """Write this model's warmup artifact (``compilecache/artifacts.py``)
        to ``out`` (a directory or a file path); returns the path."""
        from ..compilecache.artifacts import export_warmup_artifact
        return export_warmup_artifact(self, out)

    def _forward(self, xs, mask=None):
        # the scheduler thread is the only caller once traffic flows; the
        # output stays where the model computed it (the batcher slices and
        # copies it once). After an artifact install this is the same eager
        # forward, loading the installed libraries.
        return self.model.output(xs) if mask is None else self.model.output(xs, mask=mask)

    def submit(self, x, deadline_ms: Optional[float] = None, trace_ctx=None,
               cache_bypass: bool = False) -> Future:
        return self.batcher.submit(x, deadline_ms=deadline_ms, trace_ctx=trace_ctx,
                                   cache_bypass=cache_bypass)

    def predict(self, x, deadline_ms: Optional[float] = None, timeout: float = 60.0,
                trace_ctx=None, cache_bypass: bool = False):
        """Synchronous convenience: submit and wait for the result rows."""
        return self.submit(x, deadline_ms=deadline_ms, trace_ctx=trace_ctx,
                           cache_bypass=cache_bypass).result(timeout)

    def golden(self, inputs=None, examples: int = 2, refresh: bool = False) -> Dict[str, Any]:
        """The golden set: canonical inputs and their f32 outputs through
        the serving path (bucketing and the precision cast included, the
        cache bypassed). Default inputs are ``examples`` rows of
        ``(arange % 7) / 7`` in ``input_shape``; ``version`` hashes inputs,
        outputs and precision; ``atol`` is 5e-2 at bf16 and 1e-4 at f32.
        Latched; ``refresh`` recaptures."""
        if self._golden is not None and not refresh and inputs is None:
            return self._golden
        if inputs is None:
            if self.input_shape is None:
                raise ValueError(f"model {self.name!r}: golden() needs input_shape= at "
                                 f"registration (or pass canonical inputs=)")
            per = int(np.prod(self.input_shape, dtype=np.int64))
            n = max(1, int(examples))
            x = (np.arange(n * per, dtype=np.float32).reshape((n,) + self.input_shape)
                 % 7.0) / 7.0
        else:
            x = np.asarray(inputs, np.float32)
            if x.ndim < 2:
                x = x.reshape(1, -1)
        expected = np.asarray(self.predict(x, cache_bypass=True), np.float32)
        h = hashlib.sha256()
        h.update(x.tobytes())
        h.update(expected.tobytes())
        h.update(self.precision.encode())
        self._golden = {"model": self.name, "version": h.hexdigest()[:16],
                        "precision": self.precision, "inputs": x.tolist(),
                        "outputs": expected.tolist(),
                        "atol": 5e-2 if self.precision == "bf16" else 1e-4}
        return self._golden

    def stats(self) -> Dict[str, Any]:
        b = self.batcher
        return {
            "name": self.name,
            "model": type(self.model).__name__,
            "device": str(self.device),
            "queue_depth": b.queue_depth(),
            "batch_buckets": list(b._bb) if b._bb else None,
            "time_buckets": list(b._tb) if b._tb else None,
            "max_queue_examples": b.max_queue_examples,
            "linger_ms": b.linger_ms,
            "default_deadline_ms": b.default_deadline_ms,
            "precision": self.precision,
            "cache_size": b.cache_size,
            "cache": b.cache_stats(),
            "aot_signatures": len(self._aot),
            "golden_version": (self._golden or {}).get("version"),
        }

    def set_admission(self, max_queue_examples: Optional[int] = None,
                      linger_ms: Optional[float] = None) -> Dict[str, Any]:
        """Move this model's admission knobs on the live batcher; returns
        the previous values."""
        return self.batcher.set_admission(max_queue_examples=max_queue_examples,
                                          linger_ms=linger_ms)

    def close(self, drain: bool = True, timeout: float = 30.0):
        self.batcher.close(drain=drain, timeout=timeout)


class ModelRegistry:
    """Thread-safe name -> :class:`ServedModel` table. ``max_in_flight``
    bounds concurrent forwards across its models (one semaphore every
    model's scheduler takes around a flush). The lock covers the name map
    only; request traffic never runs under it."""

    def __init__(self, max_in_flight: Optional[int] = None):
        self._lock = make_lock("ModelRegistry._lock")
        self._models: Dict[str, ServedModel] = {}
        self._reserved: set = set()
        self._in_flight = (threading.BoundedSemaphore(int(max_in_flight))
                           if max_in_flight else None)

    def register(self, name: str, model, **config) -> ServedModel:
        """Host ``model`` under ``name`` (config: see :class:`ServedModel`).
        Re-using a live name raises; the name is reserved before the
        (possibly slow, warming) construction, which runs unlocked."""
        with self._lock:
            if name in self._models or name in self._reserved:
                raise ValueError(f"model {name!r} already registered — unregister it first")
            self._reserved.add(name)
        try:
            served = ServedModel(name, model, in_flight=self._in_flight, **config)
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
        """Rows of ``GET /v1/models`` (name order)."""
        with self._lock:
            models = sorted(self._models.items())
        return [m.stats() for _, m in models]

    def submit(self, name: str, x, deadline_ms: Optional[float] = None, trace_ctx=None,
               cache_bypass: bool = False) -> Future:
        return self.get(name).submit(x, deadline_ms=deadline_ms, trace_ctx=trace_ctx,
                                     cache_bypass=cache_bypass)

    def predict(self, name: str, x, deadline_ms: Optional[float] = None,
                timeout: float = 60.0, trace_ctx=None, cache_bypass: bool = False):
        return self.get(name).predict(x, deadline_ms=deadline_ms, timeout=timeout,
                                      trace_ctx=trace_ctx, cache_bypass=cache_bypass)

    def close_all(self, drain: bool = True, timeout: float = 30.0):
        """Stop admission on every model, serve what was accepted
        (``drain=True``) and join every scheduler, outside the lock."""
        with self._lock:
            models, self._models = list(self._models.values()), {}
        for m in models:
            m.close(drain=drain, timeout=timeout)
