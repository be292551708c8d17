"""Continuous-batching scheduler: many small requests, one forward per flush.

Counterpart of ``deeplearning4j_tpu/serving/batcher.py``. Concurrent
callers ``submit()`` small requests; a scheduler thread coalesces requests
of one shape into one padded batch, runs one forward, and hands each
caller its rows through a :class:`~concurrent.futures.Future`.

- **closed signature set.** A flush pads its batch dim up to a batch
  bucket, and a sequence request ``[b, T, f]`` pads its time dim up to a
  time bucket with a zero features mask on the padding (the mask is always
  present when time buckets are set). Steady state calls the forward at
  ``len(batch_buckets) x len(time_buckets)`` signatures however request
  sizes churn (:meth:`compile_signatures`; jitwatch counts the first call
  at each). Without buckets ``max_batch`` is a flush trigger and an
  oversize request runs as a batch of its own.
- **admission.** The queue is bounded (``max_queue_examples``,
  ``max_queue_requests``); at the cap ``queue_policy="reject"`` raises
  :class:`OverloadedError` (HTTP 429) and ``"flush"`` (ParallelInference's
  semantics) forces a flush and keeps accepting. A request whose deadline
  passes while queued completes with :class:`DeadlineExceededError`
  (HTTP 504). ``close(drain=True)`` serves every accepted request;
  :meth:`set_admission` moves the cap and the linger of a live batcher.
- **data plane.** With a ``device`` the host moves only the real examples:
  they are coalesced into a pinned staging buffer, copied once to a
  device-resident buffer of the bucket's shape (one per (key, bucket),
  reused each flush with its padding rows zeroed; one CUDA event a flush
  keeps the staging buffer from being overwritten before its copy ends),
  and the forward's output is sliced to the real rows on the device and
  copied to the host once. Without a device the forward gets host arrays
  padded on the host. ``serving/pad`` and ``serving/transfer`` spans nest
  under ``serving/flush``; ``transfer_stats()`` counts the bytes.
- **precision.** ``precision="bf16"`` casts float inputs to bfloat16 at
  submit (a CPU tensor: torch does the cast; the card's machine has no
  ``ml_dtypes``), so the host-to-device copy moves half the bytes; bf16
  outputs come back as float32, cast on the host after the one copy.
- **response cache.** ``cache_size=`` (examples) puts a content-addressed
  LRU in front of the queue: the key is shape, dtype and sha256 of the
  bytes after the cast, so two f32 inputs that round to the same bf16 hit
  one entry. A hit resolves the future on the caller's thread with a copy
  of the cached rows: no queue, no flush, no launch.
- **observability.** With ``metrics_label`` the ``serving_*`` series of
  the JAX package (requests by outcome, latency with trace-id exemplars,
  batch size, queue depth, QPS over ``qps_window_s``, pad and transfer
  times, cache hits and misses) and a trace context for every request.

Locking: one condition (``ContinuousBatcher._cond``) guards the queue; the
forward runs outside it on the scheduler thread. The response cache has its
own lock (``ContinuousBatcher._cache_lock``), never held together with the
condition.
"""
from __future__ import annotations

import contextlib
import hashlib
import logging
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future, InvalidStateError
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..datasets.bucketing import bucket_for, validate_buckets
from ..monitor.lockwatch import make_condition, make_lock

log = logging.getLogger(__name__)

__all__ = ["ContinuousBatcher", "OverloadedError", "DeadlineExceededError",
           "ModelNotFoundError", "PRECISIONS", "serving_dtype"]

#: serving precisions
PRECISIONS = ("f32", "bf16")


def serving_dtype(precision: str) -> torch.dtype:
    """The dtype a serving precision casts float features to."""
    return torch.bfloat16 if precision == "bf16" else torch.float32


def _dtype_str(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _content_key(x) -> Tuple:
    """The response-cache address: (shape, dtype name, sha256 of the
    bytes). ``x`` is a CPU tensor or an array; a bf16 tensor hashes its
    16-bit patterns, the bytes ``ml_dtypes`` would hold."""
    if isinstance(x, torch.Tensor):
        t = x.contiguous()
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return (tuple(t.shape), _dtype_str(t.dtype),
                hashlib.sha256(raw.numpy().data).digest())
    buf = x.data if x.flags.c_contiguous else x.tobytes()
    return (x.shape, str(x.dtype), hashlib.sha256(buf).digest())


def _complete(fut: Future, value=None, exc: Optional[Exception] = None) -> bool:
    """Resolve a future, tolerating a caller's ``cancel()``."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(value)
        return True
    except InvalidStateError:
        return False


def _rows(x) -> int:
    return int(x.shape[0]) if x.ndim >= 1 else 1


class OverloadedError(RuntimeError):
    """Admission refused: queue at capacity or the batcher is closing
    (HTTP 429)."""


class DeadlineExceededError(RuntimeError):
    """The request's deadline expired before a flush could serve it
    (HTTP 504)."""


class ModelNotFoundError(KeyError):
    """No model registered under that name (HTTP 404)."""


class _Request:
    __slots__ = ("x", "mask", "fut", "key", "n", "t_enq", "t_perf", "deadline",
                 "orig_t", "padded_t", "ctx", "ckey")

    def __init__(self, x, mask, key, t_enq, deadline, orig_t, padded_t, ctx=None,
                 ckey=None):
        self.x = x                    # CPU tensor, [b, ...] (time-padded)
        self.mask = mask              # [b, T] float32 array, or None
        self.fut: Future = Future()
        self.key = key
        self.n = int(x.shape[0])
        self.t_enq = t_enq
        self.t_perf = time.perf_counter()
        self.deadline = deadline      # monotonic seconds, or None
        self.orig_t = orig_t          # pre-padding time steps, or None
        self.padded_t = padded_t      # time bucket the input was padded to
        self.ctx = ctx                # SpanContext, or None
        self.ckey = ckey              # response-cache key, or None


class ContinuousBatcher:
    """Request coalescing behind one forward callable.

    ``forward_fn(xs)`` (or ``forward_fn(xs, mask)`` when a features mask is
    present) receives the ``[bucket, ...]`` batch and returns rows whose
    leading dim matches: tensors on ``device`` when one is given (the
    device path), else host arrays (an f32 ndarray, or a CPU tensor for
    bf16).
    """

    def __init__(self, forward_fn: Callable, *, name: str = "model",
                 batch_buckets: Optional[Sequence[int]] = None,
                 time_buckets: Optional[Sequence[int]] = None,
                 max_batch: int = 64,
                 max_queue_examples: Optional[int] = 256,
                 max_queue_requests: Optional[int] = None,
                 linger_ms: float = 5.0,
                 default_deadline_ms: Optional[float] = None,
                 queue_policy: str = "reject",
                 in_flight: Optional[threading.Semaphore] = None,
                 metrics_label: Optional[str] = None,
                 qps_window_s: float = 10.0,
                 precision: str = "f32",
                 cache_size: Optional[int] = None,
                 device: Optional[torch.device] = None):
        if queue_policy not in ("reject", "flush"):
            raise ValueError(f"queue_policy must be 'reject' or 'flush', got {queue_policy!r}")
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        if cache_size is not None and int(cache_size) < 1:
            raise ValueError(f"cache_size must be >= 1 examples, got {cache_size}")
        self.name = str(name)
        self._forward = forward_fn
        self.precision = precision
        self._in_dtype = serving_dtype(precision)
        self._device = None if device is None else torch.device(device)
        self.cache_size = int(cache_size) if cache_size is not None else None
        # ckey -> read-only result rows (hits hand out copies)
        self._cache: Optional[OrderedDict] = (
            OrderedDict() if self.cache_size is not None else None)
        self._cache_examples = 0
        self._cache_lock = (make_lock("ContinuousBatcher._cache_lock")
                            if self._cache is not None else None)
        # (key, bucket) -> device buffer; (key, bucket) -> (pinned, event);
        # scheduler-thread-only, dropped on close
        self._dev_bufs: Dict[Tuple, torch.Tensor] = {}
        self._staging: Dict[Tuple, Tuple[torch.Tensor, Any]] = {}
        self._bytes = {"flushes": 0, "h2d_bytes": 0, "d2h_bytes": 0}
        self._bb = validate_buckets(batch_buckets, "batch") if batch_buckets else None
        self._tb = validate_buckets(time_buckets, "time") if time_buckets else None
        self.max_batch = self._bb[-1] if self._bb else int(max_batch)
        self.max_queue_examples = max_queue_examples
        self.max_queue_requests = max_queue_requests
        self.linger_ms = float(linger_ms)
        self.default_deadline_ms = default_deadline_ms
        self.queue_policy = queue_policy
        self._in_flight = in_flight
        self._label = metrics_label
        self._qps_window = float(qps_window_s)

        self._cond = make_condition("ContinuousBatcher._cond")
        self._queue: List[_Request] = []
        self._queued_examples = 0
        self._key_examples: Dict[Tuple, int] = {}
        self._force = False
        self._closed = False
        self._running = False          # a flush is executing forward_fn
        self._done_times: Deque[float] = deque()
        self._handles = None
        self._thread = threading.Thread(target=self._loop, name=f"serving-batcher-{self.name}",
                                        daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- metrics
    def _metric_handles(self):
        # lazy: a batcher populates /metrics once traffic flows
        if self._label is None:
            return None
        if self._handles is None:
            from ..monitor.registry import get_registry
            reg = get_registry()
            m = self._label
            handles = {
                "req_ok": reg.counter("serving_requests_total",
                                      "inference requests by outcome "
                                      "(ok/rejected/deadline/error)", model=m, outcome="ok"),
                "latency": reg.histogram("serving_request_latency_ms",
                                         "request latency, submit to result (queue + batch "
                                         "assembly + forward)", model=m),
                "batch": reg.histogram("serving_batch_examples",
                                       "real (pre-padding) examples per flushed batch",
                                       model=m),
                "depth": reg.gauge("serving_queue_depth",
                                   "requests currently queued for batching", model=m),
                "depth_ex": reg.gauge("serving_queue_examples",
                                      "examples currently queued for batching — the unit "
                                      "the admission cap (max_queue_examples) is in, so "
                                      "saturation alerts compare like with like", model=m),
                "qps": reg.gauge("serving_qps",
                                 "completed requests per second over the trailing window",
                                 model=m),
                "pad": reg.histogram("serving_pad_ms",
                                     "per-flush batch-assembly time: host coalesce into the "
                                     "staging buffer + mask pad", model=m),
                "xfer": reg.histogram("serving_transfer_ms",
                                      "per-flush host<->device movement: one copy of the "
                                      "real examples in (with the device pad), one sliced "
                                      "copy out", model=m),
            }
            if self._cache is not None:
                handles["c_hit"] = reg.counter(
                    "serving_cache_hits_total",
                    "response-cache hits — requests answered without queueing or a flush",
                    model=m)
                handles["c_miss"] = reg.counter(
                    "serving_cache_misses_total",
                    "response-cache misses — requests that paid the full queue + flush path",
                    model=m)
            self._handles = handles      # published complete (read lock-free)
        return self._handles

    def _cache_count(self, hit: bool):
        h = self._metric_handles()
        if h is not None:
            (h["c_hit"] if hit else h["c_miss"]).inc()

    def _count(self, outcome: str, n: int = 1):
        if self._label is None:
            return
        if outcome == "ok" and self._handles is not None:
            self._handles["req_ok"].inc(n)
            return
        from ..monitor.registry import get_registry
        get_registry().counter("serving_requests_total",
                               "inference requests by outcome (ok/rejected/deadline/error)",
                               model=self._label, outcome=outcome).inc(n)

    def _note_done(self, outcome: str, latency_ms: Optional[float] = None,
                   exemplar: Optional[str] = None):
        h = self._metric_handles()
        self._count(outcome)
        if h is None:
            return
        if latency_ms is not None:
            h["latency"].observe(latency_ms, exemplar=exemplar)
        now = time.monotonic()
        with self._cond:
            if self._closed and not self._thread.is_alive():
                return            # a late hit after close: the gauge stays 0
            was_empty = not self._done_times
            self._done_times.append(now)
            self._trim_done(now, h)
            if was_empty:
                self._cond.notify_all()    # re-arm the idle decay

    def _trim_done(self, now: float, h) -> bool:
        cut = now - self._qps_window
        changed = False
        while self._done_times and self._done_times[0] < cut:
            self._done_times.popleft()
            changed = True
        if h is not None:
            h["qps"].set(len(self._done_times) / self._qps_window)
        return changed

    def _decay_qps(self, now: float):
        """Walk the QPS gauge down after traffic stops (the idle
        scheduler wakes as completions age out of the window)."""
        if self._done_times:
            self._trim_done(now, self._metric_handles())

    def _set_depth(self):
        h = self._metric_handles()
        if h is not None:
            h["depth"].set(len(self._queue))
            h["depth_ex"].set(self._queued_examples)

    # -------------------------------------------------------- response cache
    def _cache_lookup(self, ckey):
        with self._cache_lock:
            got = self._cache.get(ckey)
            if got is not None:
                self._cache.move_to_end(ckey)
            return got

    def _cache_store(self, ckey, rows: np.ndarray):
        if self._closed:
            return            # a drain-window flush must not refill a cleared cache
        master = np.array(rows)
        master.flags.writeable = False
        n = _rows(master)
        with self._cache_lock:
            old = self._cache.pop(ckey, None)
            if old is not None:
                self._cache_examples -= _rows(old)
            self._cache[ckey] = master
            self._cache_examples += n
            while self._cache_examples > self.cache_size and self._cache:
                _, evicted = self._cache.popitem(last=False)
                self._cache_examples -= _rows(evicted)

    def cache_stats(self) -> Dict[str, int]:
        """Live cache occupancy (entries, examples)."""
        if self._cache is None:
            return {"entries": 0, "examples": 0}
        with self._cache_lock:
            return {"entries": len(self._cache), "examples": self._cache_examples}

    def transfer_stats(self) -> Dict[str, int]:
        """Flushes and the bytes they moved host-to-device and back."""
        return dict(self._bytes)

    # -------------------------------------------------------------- submit
    def _cast(self, x):
        """The submitted features as a CPU tensor in the serving dtype (a
        conforming f32 ndarray is wrapped, not copied). Returns (tensor,
        owned)."""
        if isinstance(x, torch.Tensor):
            t, owned = x.detach().cpu(), False
        else:
            arr = np.asarray(x)
            owned = arr is not x
            if arr.dtype.kind == "f" and arr.dtype != np.float32 \
                    and self._in_dtype == torch.float32:
                arr, owned = arr.astype(np.float32), True
            t = torch.from_numpy(np.ascontiguousarray(arr) if not arr.flags.c_contiguous
                                 else arr)
        if t.is_floating_point() and t.dtype != self._in_dtype:
            t, owned = t.to(self._in_dtype), True
        return t, owned

    def submit(self, x, deadline_ms: Optional[float] = None, trace_ctx=None,
               cache_bypass: bool = False, mask=None) -> Future:
        """Queue a request ``[b, ...]`` (``b >= 1``); the Future resolves to
        the result rows of exactly these examples, as a host array.

        Raises :class:`OverloadedError` at the cap (policy ``"reject"``) or
        after close, ``ValueError`` when ``b`` exceeds the largest batch
        bucket or ``T`` the largest time bucket. ``cache_bypass`` skips the
        response cache (no lookup, no store: a probe). ``trace_ctx`` is the
        request's span context; a labelled batcher makes one when none is
        given. ``mask`` is a caller's ``[b, T]`` features mask (a
        ParallelInference request); it joins the signature.

        The batcher never mutates a submitted array, and a conforming one
        (f32 at f32) is not copied: the caller must not mutate it before
        the future resolves. A cached model copies on a miss, so that the
        content address names bytes nobody can change."""
        x, owned = self._cast(x)
        if x.dim() < 1 or x.shape[0] < 1:
            raise ValueError(f"request must be [b, ...] with b >= 1, got shape "
                             f"{tuple(x.shape)}")
        b = int(x.shape[0])
        if self._bb is not None and b > self.max_batch:
            raise ValueError(f"request of {b} examples exceeds the largest batch bucket "
                             f"{self.max_batch} — split the request or configure a "
                             f"bigger bucket")
        ckey = None
        if self._cache is not None and not self._closed and not cache_bypass:
            ckey = _content_key(x)
            hit = self._cache_lookup(ckey)
            if hit is not None:
                self._cache_count(True)
                self._note_done("ok", 0.0, exemplar=(f"{trace_ctx.trace_id:x}"
                                                     if trace_ctx is not None else None))
                fut: Future = Future()
                fut.set_result(hit.copy())
                return fut
            if not owned:
                # a miss is stored under these bytes' hash: own them, and
                # hash the owned copy
                x = x.clone()
                ckey = _content_key(x)
        m = None if mask is None else np.asarray(mask, np.float32)
        orig_t = padded_t = None
        if self._tb is not None and x.dim() >= 3:
            orig_t = int(x.shape[1])
            padded_t = bucket_for(self._tb, orig_t, "time")
            full = np.zeros((b, padded_t), np.float32)
            full[:, :orig_t] = 1.0 if m is None else m
            m = full
            if padded_t != orig_t:
                pad = torch.zeros((b, padded_t - orig_t) + tuple(x.shape[2:]), dtype=x.dtype)
                x = torch.cat([x, pad], dim=1)
        key = (tuple(x.shape[1:]), _dtype_str(x.dtype), m is not None)
        now = time.monotonic()
        dl_ms = deadline_ms if deadline_ms is not None else self.default_deadline_ms
        ctx = trace_ctx
        if ctx is None and self._label is not None:
            from ..monitor.tracer import new_context
            ctx = new_context()
        req = _Request(x, m, key, now, now + dl_ms / 1e3 if dl_ms is not None else None,
                       orig_t, padded_t, ctx=ctx, ckey=ckey)
        with self._cond:
            if self._closed:
                self._count("rejected")
                raise OverloadedError(f"model {self.name!r} is shutting down")
            over = ((self.max_queue_examples is not None
                     and self._queued_examples + b > self.max_queue_examples)
                    or (self.max_queue_requests is not None
                        and len(self._queue) + 1 > self.max_queue_requests))
            if over and self.queue_policy == "reject":
                self._count("rejected")
                raise OverloadedError(
                    f"model {self.name!r} overloaded: {self._queued_examples} examples / "
                    f"{len(self._queue)} requests queued (caps: {self.max_queue_examples} "
                    f"examples, {self.max_queue_requests} requests)")
            self._queue.append(req)
            self._queued_examples += b
            self._key_examples[key] = self._key_examples.get(key, 0) + b
            if over:                      # policy "flush": drain, keep going
                self._force = True
            self._set_depth()
            self._cond.notify_all()
        if ckey is not None:
            self._cache_count(False)
        return req.fut

    # ----------------------------------------------------------- scheduler
    def _ripe_locked(self, now: float) -> bool:
        if not self._queue:
            return False
        if self._force or self._closed:
            return True
        if any(n >= self.max_batch for n in self._key_examples.values()):
            return True
        if (self.max_queue_requests is not None
                and len(self._queue) >= self.max_queue_requests):
            return True
        if any(r.deadline is not None and now > r.deadline for r in self._queue):
            return True
        return (now - self._queue[0].t_enq) * 1e3 >= self.linger_ms

    def _wait_timeout_locked(self, now: float) -> Optional[float]:
        """Until the oldest request's linger ends or the nearest deadline
        passes; with an empty queue, until the oldest completion leaves the
        QPS window (None: park until notified)."""
        if not self._queue:
            if self._done_times:
                return max(self._done_times[0] + self._qps_window - now, 0.0) + 0.05
            return None
        t = self._queue[0].t_enq + self.linger_ms / 1e3
        for r in self._queue:
            if r.deadline is not None:
                t = min(t, r.deadline)
        return max(t - now, 0.0)

    def _take_locked(self, now: float):
        """Pop expired requests plus one same-key batch (the FIFO head's
        key, up to the cap; the head always goes)."""
        expired, keep = [], []
        for r in self._queue:
            if r.deadline is not None and now > r.deadline:
                expired.append(r)
                self._queued_examples -= r.n
                self._key_examples[r.key] -= r.n
            else:
                keep.append(r)
        self._queue = keep
        batch = []
        if self._queue:
            key = self._queue[0].key
            taken = 0
            keep = []
            for r in self._queue:
                if r.key == key and (not batch or taken + r.n <= self.max_batch):
                    batch.append(r)
                    taken += r.n
                else:
                    keep.append(r)
            self._queue = keep
            self._queued_examples -= taken
            self._key_examples[key] -= taken
        for k in [k for k, n in self._key_examples.items() if n <= 0]:
            del self._key_examples[k]
        if not self._queue:
            self._force = False
        self._set_depth()
        return expired, batch

    def _loop(self):
        try:
            self._loop_inner()
        finally:
            self._dev_bufs.clear()
            self._staging.clear()

    def _loop_inner(self):
        while True:
            with self._cond:
                now = time.monotonic()
                while not self._ripe_locked(now):
                    if self._closed and not self._queue:
                        self._done_times.clear()
                        h = self._metric_handles()
                        if h is not None:
                            h["qps"].set(0.0)
                        return
                    if self._force and not self._queue:
                        self._force = False    # a stale flush() must not skip a linger
                    self._cond.wait(self._wait_timeout_locked(now))
                    now = time.monotonic()
                    self._decay_qps(now)
                expired, batch = self._take_locked(now)
                self._running = bool(batch)
            try:
                for r in expired:
                    if _complete(r.fut, exc=DeadlineExceededError(
                            f"deadline expired after {(now - r.t_enq) * 1e3:.1f}ms in queue "
                            f"(model {self.name!r})")):
                        self._note_done("deadline")
                if batch:
                    self._run_batch(batch)
            except Exception:
                # the scheduler must survive anything: a dead scheduler turns
                # every later submit into a hang
                log.exception("serving batcher %s: scheduler iteration failed", self.name)
            finally:
                with self._cond:
                    self._running = False
                    self._cond.notify_all()

    def _span(self, name: str, **args):
        if self._label is None:
            return contextlib.nullcontext()
        from ..monitor.tracer import get_tracer
        return get_tracer().span(name, cat="serving", model=self.name, **args)

    def _coalesce(self, batch: List[_Request], padded: int):
        """The real examples as one CPU tensor ``[total, ...]`` (a lone
        request as it is) and the bucket-shaped mask (zero padding rows)."""
        xs = batch[0].x if len(batch) == 1 else torch.cat([r.x for r in batch], dim=0)
        mask = None
        if batch[0].mask is not None:
            mask = np.zeros((padded,) + batch[0].mask.shape[1:], np.float32)
            pos = 0
            for r in batch:
                mask[pos:pos + r.n] = r.mask
                pos += r.n
        return xs, mask

    def _h2d(self, xs: torch.Tensor, padded: int, key) -> torch.Tensor:
        """The real rows into this (key, bucket)'s device buffer, its
        padding rows zeroed. On the card the rows go through a pinned
        staging buffer whose previous copy must have ended (its event)."""
        total = int(xs.shape[0])
        shape = (padded,) + tuple(xs.shape[1:])
        buf = self._dev_bufs.get((key, padded))
        if buf is None or tuple(buf.shape) != shape or buf.dtype != xs.dtype:
            buf = self._dev_bufs[(key, padded)] = torch.empty(shape, dtype=xs.dtype,
                                                              device=self._device)
        if self._device.type == "cuda":
            staged = self._staging.get((key, padded))
            if staged is None:
                staged = (torch.empty(shape, dtype=xs.dtype, pin_memory=True),
                          torch.cuda.Event())
                self._staging[(key, padded)] = staged
            pinned, event = staged
            event.synchronize()
            pinned[:total].copy_(xs)
            buf[:total].copy_(pinned[:total], non_blocking=True)
            event.record(torch.cuda.current_stream(self._device))
        else:
            buf[:total].copy_(xs)
        if total < padded:
            buf[total:].zero_()
        return buf

    def compile_signatures(self, input_shape: Sequence[int]
                           ) -> List[Tuple[Tuple[int, ...], str, bool]]:
        """The closed set of forward signatures this batcher will ever use
        for a model with per-example trailing shape ``input_shape``:
        ``[(batch_shape, dtype, masked), ...]``, one per batch bucket (x
        time bucket for a sequence model), in the serving dtype. Shared by
        ``ServedModel.warm()`` and the warmup-artifact exporter."""
        shape = tuple(int(d) for d in input_shape)
        dt = _dtype_str(self._in_dtype)
        out: List[Tuple[Tuple[int, ...], str, bool]] = []
        for n in (self._bb or [self.max_batch]):
            if self._tb is not None and len(shape) >= 2:
                for tt in self._tb:
                    out.append(((n, tt) + shape[1:], dt, True))
            else:
                out.append(((n,) + shape, dt, False))
        return out

    def warm_pads(self, trailing: Sequence[int], masked: bool = False):
        """Make every bucket's device buffer (and pinned staging buffer)
        with this trailing shape before traffic, so no live flush pays the
        allocation. Pre-traffic only: the buffers belong to the scheduler
        thread once requests flow."""
        if not self._bb or self._device is None:
            return
        trailing = tuple(int(d) for d in trailing)
        key = (trailing, _dtype_str(self._in_dtype), masked)
        for bucket in self._bb:
            self._h2d(torch.zeros((1,) + trailing, dtype=self._in_dtype), bucket, key)
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def _stage_in(self, batch: List[_Request], total: int, padded: int):
        """(xs, mask, pad seconds, h2d seconds): the padded batch where the
        forward wants it."""
        t0 = time.perf_counter()
        with self._span("serving/pad", examples=int(total), padded=int(padded)):
            xs, mask = self._coalesce(batch, padded)
        t1 = time.perf_counter()
        if self._device is not None:
            with self._span("serving/transfer", direction="h2d"):
                self._bytes["h2d_bytes"] += xs.numel() * xs.element_size()
                xs = self._h2d(xs, padded, batch[0].key)
                if mask is not None:
                    mask = torch.from_numpy(mask).to(self._device, non_blocking=True)
                    self._bytes["h2d_bytes"] += mask.numel() * 4
            return xs, mask, t1 - t0, time.perf_counter() - t1
        if int(xs.shape[0]) != padded:
            with self._span("serving/pad", padded=int(padded)):
                out = torch.zeros((padded,) + tuple(xs.shape[1:]), dtype=xs.dtype)
                out[:xs.shape[0]] = xs
                xs = out
        if xs.dtype != torch.bfloat16:
            xs = xs.numpy()
        return xs, mask, time.perf_counter() - t0, 0.0

    def _stage_out(self, ys, total: int) -> np.ndarray:
        """Slice the padding off where the output lies and copy to the host
        once; a bf16 output becomes float32 on the host side."""
        if getattr(ys, "ndim", 0) >= 1 and ys.shape[0] >= total:
            ys = ys[:total]
        with self._span("serving/transfer", direction="d2h", examples=int(total)):
            if isinstance(ys, torch.Tensor):
                if ys.device.type == "cpu":
                    host = ys.detach().clone()    # never alias a reused buffer
                else:
                    host = ys.detach().cpu()
                    self._bytes["d2h_bytes"] += host.numel() * host.element_size()
                out = (host.float() if host.dtype == torch.bfloat16 else host).numpy()
            else:
                out = np.asarray(ys)
        return out

    def _forward_batch(self, xs, mask):
        if self._in_flight is not None:
            self._in_flight.acquire()
        try:
            return self._forward(xs) if mask is None else self._forward(xs, mask)
        finally:
            if self._in_flight is not None:
                self._in_flight.release()

    def _flush_once(self, batch: List[_Request], total: int, padded: int):
        xs, mask, t_pad, t_h2d = self._stage_in(batch, total, padded)
        ys = self._forward_batch(xs, mask)
        if self._device is not None and self._device.type == "cuda":
            # the compute tail lands in the forward's share of the flush,
            # not in the d2h span
            torch.cuda.current_stream(self._device).synchronize()
        t0 = time.perf_counter()
        out = self._stage_out(ys, total)
        self._bytes["flushes"] += 1
        return out, t_pad, t_h2d + (time.perf_counter() - t0)

    def _run_batch(self, batch: List[_Request]):
        try:
            total = sum(r.n for r in batch)
            padded = bucket_for(self._bb, total, "batch") if self._bb else total
            flush_start = time.perf_counter()
            if self._label is not None:
                # one serving/flush span on the scheduler thread; each
                # request's queue-wait span (in the request's trace) links
                # to it by id
                from ..monitor.tracer import get_tracer
                with get_tracer().span("serving/flush", cat="serving", model=self.name,
                                       examples=int(total), padded=int(padded),
                                       requests=len(batch)) as flush_ctx:
                    ys, t_pad, t_xfer = self._flush_once(batch, total, padded)
            else:
                flush_ctx = None
                ys, t_pad, t_xfer = self._flush_once(batch, total, padded)
            h = self._metric_handles()
            if h is not None:
                h["batch"].observe(float(total))
                h["pad"].observe(t_pad * 1e3)
                h["xfer"].observe(t_xfer * 1e3)
            done = time.monotonic()
            if flush_ctx is not None:
                from ..monitor.tracer import get_tracer
                tracer = get_tracer()
                for r in batch:
                    if r.ctx is not None:
                        tracer.record_complete(
                            "serving/queue_wait", r.t_perf, max(flush_start - r.t_perf, 0.0),
                            cat="serving", parent=r.ctx, model=self.name,
                            flush_span_id=f"{flush_ctx.span_id:x}")
            pos = 0
            for r in batch:
                yr = ys[pos:pos + r.n]
                pos += r.n
                if (r.padded_t is not None and r.padded_t != r.orig_t
                        and yr.ndim >= 2 and yr.shape[1] == r.padded_t):
                    yr = yr[:, :r.orig_t]        # per-step output: strip the time pad
                if self._cache is not None and r.ckey is not None:
                    self._cache_store(r.ckey, yr)
                if _complete(r.fut, yr):
                    self._note_done("ok", (done - r.t_enq) * 1e3,
                                    exemplar=(f"{r.ctx.trace_id:x}" if r.ctx is not None
                                              else None))
        except Exception as e:
            for r in batch:
                if not r.fut.done() and _complete(r.fut, exc=e):
                    self._note_done("error")

    # ------------------------------------------------------------ lifecycle
    def flush(self, wait: bool = True, timeout: float = 30.0) -> bool:
        """Flush everything queued now (ignoring linger). ``wait`` blocks
        until the queue is empty and no flush runs; False on timeout."""
        deadline = time.monotonic() + timeout
        with self._cond:
            if not self._queue and not self._running:
                return True      # idle: an armed force would rob the next linger
            self._force = True
            self._cond.notify_all()
            if not wait:
                return True
            while self._queue or self._running:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
        return True

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def set_admission(self, max_queue_examples: Optional[int] = None,
                      linger_ms: Optional[float] = None) -> Dict[str, Any]:
        """Move the admission knobs of a live batcher; queued examples are
        served, never evicted. Returns the previous values."""
        with self._cond:
            prev = {"max_queue_examples": self.max_queue_examples,
                    "linger_ms": self.linger_ms}
            if max_queue_examples is not None:
                cap = int(max_queue_examples)
                if cap < 1:
                    raise ValueError(f"max_queue_examples must be >= 1, got {cap}")
                self.max_queue_examples = cap
            if linger_ms is not None:
                lg = float(linger_ms)
                if lg < 0:
                    raise ValueError(f"linger_ms must be >= 0, got {lg}")
                self.linger_ms = lg
            self._cond.notify_all()
        return prev

    def close(self, drain: bool = True, timeout: float = 30.0):
        """Stop admission, then serve (``drain=True``) or fail with
        :class:`OverloadedError` everything still queued, and join the
        scheduler thread; the device buffers and the cache are released."""
        with self._cond:
            self._closed = True
            dropped: List[_Request] = []
            if not drain:
                dropped, self._queue = self._queue, []
                self._queued_examples = 0
                self._key_examples.clear()
            self._cond.notify_all()
        for r in dropped:
            if _complete(r.fut, exc=OverloadedError(
                    f"model {self.name!r} shut down without drain")):
                self._count("rejected")
        self._thread.join(timeout)
        if not self._thread.is_alive():
            self._dev_bufs.clear()
            self._staging.clear()
        if self._cache is not None:
            with self._cache_lock:
                self._cache.clear()
                self._cache_examples = 0
            h = self._metric_handles()
            if h is not None:
                with self._cond:
                    self._done_times.clear()
                    h["qps"].set(0.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
