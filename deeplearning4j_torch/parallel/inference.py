"""ParallelInference: inference over a mesh's slots.

Counterpart of ``deeplearning4j_tpu/parallel/inference.py`` (reference
``ParallelInference.java:32``, ``InferenceMode.SEQUENTIAL/BATCHED``,
``BatchedInferenceObservable``). A request's batch is padded to a
multiple of the slots (the last row repeated), split across them, each
slot runs the container's ``output`` on its rows (the network itself on
its own device, a replica elsewhere: for the char-RNN that is K1 for a
masked request and K3 for an unmasked one), and the rows come back
together in order. BATCHED mode coalesces concurrent ``submit``s: a
scheduler thread flushes when ``batch_limit`` examples or ``queue_limit``
requests are queued, or ``flush_after_ms`` after the oldest request, so a
lone request is never stranded; a request larger than ``batch_limit``
runs as a batch of its own, and ``close(drain=True)`` serves what is
queued first. Requests coalesce only with requests of the same trailing
shape and mask presence. As in the JAX package the scheduling is the
serving batcher's (``serving/batcher.py``, ``queue_policy="flush"``,
unbucketed). ``INPLACE`` and ``SEQUENTIAL`` run each request at once.
"""
from __future__ import annotations

from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from .mesh import DATA_AXIS, Mesh, default_devices, make_mesh, record_step
from .sharding import SlotReplicas, _split_rows
from ..monitor.lockwatch import make_lock

__all__ = ["ParallelInference", "InferenceMode"]


class InferenceMode:
    SEQUENTIAL = "sequential"
    BATCHED = "batched"
    INPLACE = "inplace"


class ParallelInference:
    class Builder:
        def __init__(self, net):
            self._net = net
            self._kw = dict(mode=InferenceMode.BATCHED, batch_limit=64, queue_limit=64,
                            workers=None, flush_after_ms=10.0, devices=None)

        def _set(self, k, v):
            self._kw[k] = v
            return self

        def inference_mode(self, mode):
            return self._set("mode", mode)

        inferenceMode = inference_mode

        def batch_limit(self, n):
            return self._set("batch_limit", int(n))

        batchLimit = batch_limit

        def queue_limit(self, n):
            return self._set("queue_limit", int(n))

        queueLimit = queue_limit

        def workers(self, n):
            return self._set("workers", int(n))

        def devices(self, devices):
            return self._set("devices", list(devices))

        def flush_after_ms(self, ms):
            """Max-linger for a partial batch."""
            return self._set("flush_after_ms", float(ms))

        flushAfterMs = flush_after_ms

        def build(self):
            return ParallelInference(self._net, **self._kw)

    def __init__(self, net, mode: str = InferenceMode.BATCHED, batch_limit: int = 64,
                 queue_limit: int = 64, workers: Optional[int] = None,
                 mesh: Optional[Mesh] = None, flush_after_ms: float = 10.0, devices=None):
        self.net = net
        if mesh is None:
            devs = list(devices) if devices is not None else default_devices()
            if workers is not None and workers < len(devs):
                devs = devs[:workers]
            mesh = make_mesh(devs, axes=(DATA_AXIS,))
        self.mesh = mesh
        self.n_devices = mesh.size
        self.mode = mode
        self.batch_limit = int(batch_limit)
        self.queue_limit = int(queue_limit)
        self.flush_after_ms = float(flush_after_ms)
        self._replicas = SlotReplicas(net)
        self._lock = make_lock("ParallelInference._lock")
        self._batcher = None      # made at the first BATCHED submit
        record_step("inference/fwd", mesh)

    # ------------------------------------------------------------------
    def _forward(self, x, mask=None) -> torch.Tensor:
        """The rows' output: padded to a multiple of the slots, split, each
        slot's ``output`` on its rows, the padding stripped."""
        net = self.net
        n = self.n_devices
        devs = [d for _, d in self.mesh.slots()]
        xt = torch.as_tensor(x) if not isinstance(x, torch.Tensor) else x
        mt = None if mask is None else (torch.as_tensor(mask) if not isinstance(
            mask, torch.Tensor) else mask)
        b = int(xt.shape[0])
        pad = (-b) % n
        if pad:
            xt = torch.cat([xt, xt[-1:].expand(pad, *xt.shape[1:])])
            if mt is not None:
                mt = torch.cat([mt, mt[-1:].expand(pad, *mt.shape[1:])])
        xs = _split_rows(xt, n, devs)
        ms = _split_rows(mt, n, devs)
        with self._lock:
            outs = [self._replicas.on(d).output(xs[i], mask=ms[i])
                    if ms[i] is not None else self._replicas.on(d).output(xs[i])
                    for i, d in enumerate(devs)]
        y = torch.cat([o.to(net.device) for o in outs])
        return y[:b]

    def output(self, x, mask=None) -> torch.Tensor:
        """Synchronous inference (reference ``output``); in BATCHED mode the
        queue is flushed first. Returns a tensor on the network's device."""
        if self.mode == InferenceMode.BATCHED:
            self.flush()
        return self._forward(np.asarray(x, np.float32) if not isinstance(x, torch.Tensor)
                             else x, mask)

    # ----------------------------------------------------- async batched path
    def _ensure_batcher(self):
        with self._lock:
            if self._batcher is None:
                from ..serving.batcher import ContinuousBatcher
                # queue_policy="flush": batch_limit examples or queue_limit
                # requests force a flush (the reference semantics) instead of
                # a rejection; the host path, since _forward splits the rows
                # over the slots itself
                self._batcher = ContinuousBatcher(
                    self._forward, name="parallel-inference", max_batch=self.batch_limit,
                    max_queue_examples=None, max_queue_requests=self.queue_limit,
                    linger_ms=self.flush_after_ms, queue_policy="flush")
            return self._batcher

    def submit(self, x, mask=None) -> Future:
        """Queue a request; the Future resolves to its rows (numpy). BATCHED
        mode coalesces on the serving batcher; other modes run it now."""
        x = np.asarray(x, np.float32)
        m = None if mask is None else np.asarray(mask, np.float32)
        if self.mode != InferenceMode.BATCHED:
            fut: Future = Future()
            try:
                fut.set_result(self._forward(x, m).cpu().numpy())
            except Exception as e:       # the caller's Future carries it
                fut.set_exception(e)
            return fut
        return self._ensure_batcher().submit(x, mask=m)

    def flush(self):
        """Run everything queued now; returns once the queue is drained."""
        if self._batcher is not None:
            self._batcher.flush(wait=True)

    def close(self, drain: bool = True):
        """Stop the batcher; ``drain=True`` serves every queued request
        first, else they fail. A later ``submit`` starts a new one."""
        with self._lock:
            batcher, self._batcher = self._batcher, None
        if batcher is not None:
            batcher.close(drain=drain)
