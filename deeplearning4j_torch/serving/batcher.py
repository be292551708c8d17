"""Continuous-batching scheduler: many small requests, one forward per flush.

Counterpart of ``deeplearning4j_tpu/serving/batcher.py``. Concurrent
callers ``submit()`` small requests; a scheduler thread coalesces requests
of one shape into one padded batch, runs one forward, and hands each
caller its rows through a :class:`~concurrent.futures.Future`.

- **buckets.** A flush pads its batch dim up to a batch bucket, and a
  sequence request ``[b, T, f]`` pads its time dim up to a time bucket,
  with a zero features mask on the padding (the mask is always present
  when time buckets are set, so masked and unmasked shapes never mix).
- **linger.** A partial batch flushes once its oldest request has waited
  ``linger_ms``.
- **deadlines.** A request whose deadline passes while queued completes
  with :class:`DeadlineExceededError` (HTTP 504) and takes no flush slot.
- **admission.** The queue is bounded (``max_queue_examples``); an
  over-cap ``submit`` raises :class:`OverloadedError` (HTTP 429).
- **drain.** ``close(drain=True)`` stops admission and serves every
  accepted request.
- **data plane.** A flush makes one host-to-device copy of the real rows
  (plus the small mask), pads on the ``device``, and makes one
  device-to-host copy of the real result rows.

Left out of the port so far: the response cache, trace spans and metrics,
AOT warmup and bf16 serving precision.

Locking: one condition variable guards the queue; the forward runs outside
it on the scheduler thread, so submitters never wait behind the device.
"""
from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..datasets.bucketing import bucket_for, validate_buckets
from ..monitor.lockwatch import make_condition

log = logging.getLogger(__name__)

__all__ = ["ContinuousBatcher", "OverloadedError", "DeadlineExceededError",
           "ModelNotFoundError"]


class OverloadedError(RuntimeError):
    """Admission refused: queue at capacity or the batcher is closing
    (HTTP 429)."""


class DeadlineExceededError(RuntimeError):
    """The request's deadline expired before a flush could serve it
    (HTTP 504)."""


class ModelNotFoundError(KeyError):
    """No model registered under that name (HTTP 404)."""


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


class _Request:
    __slots__ = ("x", "mask", "fut", "key", "n", "t_enq", "deadline",
                 "orig_t", "padded_t")

    def __init__(self, x, mask, key, t_enq, deadline, orig_t, padded_t):
        self.x = x
        self.mask = mask
        self.fut: Future = Future()
        self.key = key
        self.n = int(x.shape[0])
        self.t_enq = t_enq
        self.deadline = deadline      # monotonic seconds, or None
        self.orig_t = orig_t          # pre-padding time steps, or None
        self.padded_t = padded_t      # time bucket the input was padded to


class ContinuousBatcher:
    """Request coalescing behind one forward callable.

    ``forward_fn(xs)`` (or ``forward_fn(xs, mask)`` when a features mask is
    present) receives the ``[bucket, ...]`` batch as tensors on ``device``
    and returns a tensor whose leading dim matches.
    """

    def __init__(self, forward_fn: Callable, *, device: torch.device,
                 batch_buckets: Sequence[int],
                 name: str = "model",
                 time_buckets: Optional[Sequence[int]] = None,
                 max_queue_examples: Optional[int] = 256,
                 linger_ms: float = 5.0,
                 default_deadline_ms: Optional[float] = None):
        self.name = str(name)
        self._forward = forward_fn
        self._device = device
        self._bb = validate_buckets(batch_buckets, "batch")
        self._tb = (validate_buckets(time_buckets, "time")
                    if time_buckets else None)
        self.max_batch = self._bb[-1]
        self.max_queue_examples = max_queue_examples
        self.linger_ms = float(linger_ms)
        self.default_deadline_ms = default_deadline_ms

        self._cond = make_condition("ContinuousBatcher._cond")
        self._queue: List[_Request] = []
        self._queued_examples = 0
        self._key_examples: Dict[Tuple, int] = {}
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop, name=f"serving-batcher-{self.name}",
            daemon=True)
        self._thread.start()

    # -------------------------------------------------------------- submit
    def submit(self, x, deadline_ms: Optional[float] = None) -> Future:
        """Queue a request ``[b, ...]`` (``b >= 1``); the Future resolves to
        the result rows of exactly these examples (padding never leaks).
        Raises :class:`OverloadedError` at the queue cap or after close,
        ``ValueError`` when ``b`` exceeds the largest batch bucket or ``T``
        the largest time bucket."""
        x = np.asarray(x)
        if x.dtype.kind == "f" and x.dtype != np.float32:
            x = x.astype(np.float32)
        if x.ndim < 1 or x.shape[0] < 1:
            raise ValueError(f"request must be [b, ...] with b >= 1, "
                             f"got shape {x.shape}")
        b = int(x.shape[0])
        if b > self.max_batch:
            raise ValueError(
                f"request of {b} examples exceeds the largest batch "
                f"bucket {self.max_batch} — split the request or "
                f"configure a bigger bucket")
        mask = orig_t = padded_t = None
        if self._tb is not None and x.ndim >= 3:
            orig_t = int(x.shape[1])
            padded_t = bucket_for(self._tb, orig_t, "time")
            mask = np.zeros((b, padded_t), np.float32)
            mask[:, :orig_t] = 1.0
            if padded_t != orig_t:
                pad = np.zeros((b, padded_t - orig_t) + x.shape[2:], x.dtype)
                x = np.concatenate([x, pad], axis=1)
        key = (x.shape[1:], str(x.dtype), mask is not None)
        now = time.monotonic()
        dl_ms = deadline_ms if deadline_ms is not None \
            else self.default_deadline_ms
        req = _Request(x, mask, key, now,
                       now + dl_ms / 1e3 if dl_ms is not None else None,
                       orig_t, padded_t)
        with self._cond:
            if self._closed:
                raise OverloadedError(f"model {self.name!r} is shutting down")
            if (self.max_queue_examples is not None
                    and self._queued_examples + b > self.max_queue_examples):
                raise OverloadedError(
                    f"model {self.name!r} overloaded: {self._queued_examples} "
                    f"examples queued (cap {self.max_queue_examples})")
            self._queue.append(req)
            self._queued_examples += b
            self._key_examples[key] = self._key_examples.get(key, 0) + b
            self._cond.notify_all()
        return req.fut

    # ----------------------------------------------------------- scheduler
    def _ripe_locked(self, now: float) -> bool:
        if not self._queue:
            return False
        if self._closed:
            return True
        if any(n >= self.max_batch for n in self._key_examples.values()):
            return True
        if any(r.deadline is not None and now > r.deadline
               for r in self._queue):
            return True
        return (now - self._queue[0].t_enq) * 1e3 >= self.linger_ms

    def _wait_timeout_locked(self, now: float) -> Optional[float]:
        """Until the oldest request's linger ends or the nearest deadline
        passes (None: park until notified)."""
        if not self._queue:
            return None
        t = self._queue[0].t_enq + self.linger_ms / 1e3
        for r in self._queue:
            if r.deadline is not None:
                t = min(t, r.deadline)
        return max(t - now, 0.0)

    def _take_locked(self, now: float):
        """Pop expired requests plus one same-key batch (the FIFO head's
        key, up to the bucket cap)."""
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
                # the head always goes; others join while the cap holds
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
        return expired, batch

    def _loop(self):
        while True:
            with self._cond:
                now = time.monotonic()
                while not self._ripe_locked(now):
                    if self._closed and not self._queue:
                        return
                    self._cond.wait(self._wait_timeout_locked(now))
                    now = time.monotonic()
                expired, batch = self._take_locked(now)
            try:
                for r in expired:
                    _complete(r.fut, exc=DeadlineExceededError(
                        f"deadline expired after {(now - r.t_enq) * 1e3:.1f}ms "
                        f"in queue (model {self.name!r})"))
                if batch:
                    self._run_batch(batch)
            except Exception:
                # the scheduler must survive anything: a dead scheduler
                # turns every later submit into a hang
                log.exception("serving batcher %s: scheduler iteration failed",
                              self.name)

    def _coalesce(self, batch: List[_Request], padded: int):
        """Host-side coalesce of the real examples plus the bucket-shaped
        mask (padding rows get a zero mask)."""
        xs = batch[0].x if len(batch) == 1 else np.concatenate(
            [r.x for r in batch], axis=0)
        mask = None
        if batch[0].mask is not None:
            mask = np.zeros((padded,) + batch[0].mask.shape[1:], np.float32)
            pos = 0
            for r in batch:
                mask[pos:pos + r.n] = r.mask
                pos += r.n
        return xs, mask

    def _stage_in(self, batch: List[_Request], padded: int):
        xs, mask = self._coalesce(batch, padded)
        total = int(xs.shape[0])
        rows = torch.from_numpy(np.ascontiguousarray(xs)).to(self._device)
        if total != padded:
            xs_dev = torch.zeros((padded,) + tuple(rows.shape[1:]),
                                 dtype=rows.dtype, device=self._device)
            xs_dev[:total] = rows
        else:
            xs_dev = rows
        mask_dev = (None if mask is None
                    else torch.from_numpy(mask).to(self._device))
        return xs_dev, mask_dev

    def _run_batch(self, batch: List[_Request]):
        try:
            total = sum(r.n for r in batch)
            padded = bucket_for(self._bb, total, "batch")
            xs, mask = self._stage_in(batch, padded)
            ys = (self._forward(xs) if mask is None
                  else self._forward(xs, mask))[:total]
            ys = ys.cpu().numpy()
            pos = 0
            for r in batch:
                yr = ys[pos:pos + r.n]
                pos += r.n
                if (r.padded_t is not None and r.padded_t != r.orig_t
                        and yr.ndim >= 2 and yr.shape[1] == r.padded_t):
                    # per-timestep output: strip the time padding too
                    yr = yr[:, :r.orig_t]
                _complete(r.fut, yr)
        except Exception as e:
            for r in batch:
                if not r.fut.done():
                    _complete(r.fut, exc=e)

    # ------------------------------------------------------------ lifecycle
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def close(self, drain: bool = True, timeout: float = 30.0):
        """Stop admission, then serve (``drain=True``) or fail with
        :class:`OverloadedError` everything still queued, and join the
        scheduler thread."""
        with self._cond:
            self._closed = True
            dropped: List[_Request] = []
            if not drain:
                dropped, self._queue = self._queue, []
                self._queued_examples = 0
                self._key_examples.clear()
            self._cond.notify_all()
        for r in dropped:
            _complete(r.fut, exc=OverloadedError(
                f"model {self.name!r} shut down without drain"))
        self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
