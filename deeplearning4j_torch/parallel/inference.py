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
shape and mask presence. ``INPLACE`` and ``SEQUENTIAL`` run each request
at once. The JAX package delegates the scheduling to its serving
batcher; the port's batcher has fixed buckets and rejects a request past
the largest, so the scheduler here is its own.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import List, Optional

import numpy as np
import torch

from .mesh import DATA_AXIS, Mesh, default_devices, make_mesh, record_step
from .sharding import SlotReplicas, _split_rows

__all__ = ["ParallelInference", "InferenceMode"]


class InferenceMode:
    SEQUENTIAL = "sequential"
    BATCHED = "batched"
    INPLACE = "inplace"


class _Req:
    __slots__ = ("x", "mask", "fut", "t")

    def __init__(self, x, mask, fut):
        self.x, self.mask, self.fut, self.t = x, mask, fut, time.perf_counter()

    def key(self):
        return (self.x.shape[1:], self.x.dtype.str,
                None if self.mask is None else self.mask.shape[1:])


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
        self._lock = threading.Lock()
        self._cond = threading.Condition()
        self._queue: List[_Req] = []
        self._thread = None
        self._closing = False
        self._flush_now = False
        self._in_flight = 0
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
    def submit(self, x, mask=None) -> Future:
        """Queue a request; the Future resolves to its rows (numpy). BATCHED
        mode flushes as the module docstring says; other modes run it now."""
        x = np.asarray(x, np.float32)
        m = None if mask is None else np.asarray(mask, np.float32)
        fut: Future = Future()
        if self.mode != InferenceMode.BATCHED:
            try:
                fut.set_result(self._forward(x, m).cpu().numpy())
            except Exception as e:       # the caller's Future carries it
                fut.set_exception(e)
            return fut
        with self._cond:
            if self._thread is None or not self._thread.is_alive():
                self._closing = False
                self._thread = threading.Thread(target=self._loop, daemon=True,
                                                name="parallel-inference")
                self._thread.start()
            self._queue.append(_Req(x, m, fut))
            self._cond.notify_all()
        return fut

    def _ripe(self, now):
        q = self._queue
        if not q:
            return False
        if self._flush_now or self._closing:
            return True
        if sum(r.x.shape[0] for r in q) >= self.batch_limit or len(q) >= self.queue_limit:
            return True
        return (now - q[0].t) * 1e3 >= self.flush_after_ms

    def _take(self):
        """The oldest request and the queued ones that coalesce with it, up
        to ``batch_limit`` examples (a larger first request alone)."""
        first = self._queue[0]
        batch, total = [first], first.x.shape[0]
        rest = []
        for r in self._queue[1:]:
            if r.key() == first.key() and total + r.x.shape[0] <= self.batch_limit:
                batch.append(r)
                total += r.x.shape[0]
            else:
                rest.append(r)
        self._queue = rest
        return batch

    def _loop(self):
        while True:
            with self._cond:
                while not self._ripe(time.perf_counter()):
                    if self._closing and not self._queue:
                        return
                    if not self._queue:
                        self._flush_now = False
                        self._cond.notify_all()
                        self._cond.wait(0.5)
                    else:
                        wait = self.flush_after_ms / 1e3 - (time.perf_counter()
                                                            - self._queue[0].t)
                        self._cond.wait(max(wait, 1e-4))
                batch = self._take()
                self._in_flight += 1
            try:
                x = np.concatenate([r.x for r in batch])
                m = (None if batch[0].mask is None
                     else np.concatenate([r.mask for r in batch]))
                y = self._forward(x, m).cpu().numpy()
                pos = 0
                for r in batch:
                    n = r.x.shape[0]
                    r.fut.set_result(y[pos:pos + n])
                    pos += n
            except Exception as e:       # every request of the batch gets it
                for r in batch:
                    if not r.fut.done():
                        r.fut.set_exception(e)
            finally:
                with self._cond:
                    self._in_flight -= 1
                    self._cond.notify_all()

    def flush(self):
        """Run everything queued now; returns once the queue is drained."""
        with self._cond:
            if self._thread is None:
                return
            self._flush_now = True
            self._cond.notify_all()
            while self._queue or self._in_flight:
                self._cond.wait(0.5)
            self._flush_now = False

    def close(self, drain: bool = True):
        """Stop the scheduler; ``drain=True`` serves every queued request
        first, else they fail. A later ``submit`` starts it again."""
        with self._cond:
            t = self._thread
            if not drain:
                for r in self._queue:
                    r.fut.set_exception(RuntimeError("ParallelInference closed"))
                self._queue = []
            self._closing = True
            self._cond.notify_all()
        if t is not None:
            t.join()
        with self._cond:
            self._thread = None
            self._closing = False
