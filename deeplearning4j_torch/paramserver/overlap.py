"""Latency hiding for the parameter-server training loop.

Counterpart of ``deeplearning4j_tpu/paramserver/overlap.py``.
:class:`CommsPipeline` is one background comms thread with an in-flight
depth of one: while the card computes step k+1, the thread encodes and
pushes step k; step k+2's comms cannot start before step k's are drained,
so staleness grows by exactly one step. Submitting over an undrained job
raises, and a job's exception re-raises at :meth:`CommsPipeline.drain`, on
the training thread. Jobs run unlocked: the condition guards only the
small state machine, never socket I/O.

:func:`start_device_get` starts the device-to-host copy of every tensor of
a tree at once: ``non_blocking`` copies into pinned host memory on a side
CUDA stream (one per card), ordered after the work already queued on the
caller's stream, and an event recorded behind them. :func:`async_device_get`
waits on that event (never on ``torch.cuda.synchronize()``, which would
wait for the whole card) and hands back numpy arrays. CPU tensors are
copied at once.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

import torch

from ..utils.trees import tree_map

__all__ = ["CommsPipeline", "async_device_get", "start_device_get", "PendingCopy"]

_side_streams: Dict[int, "torch.cuda.Stream"] = {}
_side_lock = threading.Lock()


def _side_stream(device: torch.device):
    idx = device.index if device.index is not None else torch.cuda.current_device()
    with _side_lock:
        s = _side_streams.get(idx)
        if s is None:
            s = _side_streams[idx] = torch.cuda.Stream(device=idx)
        return s


def _host_dtype(t: torch.Tensor) -> torch.dtype:
    # numpy has no bf16: the wire carries f32
    return torch.float32 if t.dtype == torch.bfloat16 else t.dtype


class PendingCopy:
    """A tree's device-to-host copies in flight: pinned host tensors and,
    per card, the event recorded behind their copies."""

    def __init__(self, staged, events):
        self.staged = staged
        self.events = events

    def wait(self):
        for ev in self.events:
            ev.synchronize()
        return tree_map(lambda t: t.numpy(), self.staged)


def start_device_get(tree) -> PendingCopy:
    """Start copying every tensor of ``tree`` (nested dicts) to the host,
    without waiting: on a card, a ``non_blocking`` copy into pinned memory
    on the side stream after the caller's queued work; on the CPU, a copy
    now. Collect with :func:`async_device_get`."""
    events = {}

    def stage(t):
        t = t.detach()
        if not t.is_cuda:
            return t.to(_host_dtype(t), copy=True)
        cur = torch.cuda.current_stream(t.device)
        side = _side_stream(t.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            src = t if t.dtype == _host_dtype(t) else t.to(_host_dtype(t))
            host = torch.empty(tuple(src.shape), dtype=src.dtype, pin_memory=True)
            host.copy_(src, non_blocking=True)
            # the source's memory must outlive the copy on the side stream
            t.record_stream(side)
            src.record_stream(side)
            ev = events.get(t.device)
            if ev is None:
                ev = events[t.device] = torch.cuda.Event()
        return host

    staged = tree_map(stage, tree)
    for dev, ev in events.items():
        ev.record(_side_stream(dev))
    return PendingCopy(staged, list(events.values()))


def async_device_get(tree):
    """The tree as numpy arrays: ``tree`` is a :class:`PendingCopy` from
    :func:`start_device_get` (waited on by its events) or a tree of
    tensors, whose copies are all started before the first is waited
    for."""
    if not isinstance(tree, PendingCopy):
        tree = start_device_get(tree)
    return tree.wait()


class _Job:
    """One in-flight comms round: the closure and its outcome."""
    __slots__ = ("fn", "label", "started", "done", "result", "error")

    def __init__(self, fn: Callable[[], Any], label: str):
        self.fn = fn
        self.label = label
        self.started = False
        self.done = False
        self.result: Any = None
        self.error: Optional[BaseException] = None


class CommsPipeline:
    """One background comms thread, in-flight depth 1: every
    :meth:`submit` must follow a :meth:`drain` of the previous job (else
    ``RuntimeError``); ``drain()`` waits for the job and returns its result
    or re-raises its exception, and returns None when nothing is in
    flight."""

    def __init__(self, name: str = "ps-comms"):
        self._cond = threading.Condition()
        self._inflight: Optional[_Job] = None
        self._closed = False
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            with self._cond:
                while not self._closed and (self._inflight is None or self._inflight.started):
                    self._cond.wait(0.2)
                if self._closed and (self._inflight is None or self._inflight.started):
                    return
                job = self._inflight
                job.started = True
            try:
                job.result = job.fn()
            except BaseException as e:  # delivered at drain()
                job.error = e
            with self._cond:
                job.done = True
                self._cond.notify_all()

    def submit(self, fn: Callable[[], Any], label: str = "comms"):
        """Hand one comms round to the thread; the previous one must have
        been drained."""
        with self._cond:
            if self._closed:
                raise RuntimeError("CommsPipeline is closed")
            if self._inflight is not None:
                raise RuntimeError(
                    f"submit('{label}') over undrained in-flight job "
                    f"'{self._inflight.label}': drain() first (in-flight depth 1)")
            self._inflight = _Job(fn, label)
            self._cond.notify_all()

    def inflight(self) -> bool:
        """True while a submitted job has not been drained."""
        with self._cond:
            return self._inflight is not None

    def drain(self):
        """Wait for the in-flight job; its result, or its exception
        re-raised. None at once when nothing is in flight."""
        with self._cond:
            job = self._inflight
            if job is None:
                return None
            while not job.done:
                self._cond.wait(0.5)
            self._inflight = None
        if job.error is not None:
            raise job.error
        return job.result

    def close(self, timeout: float = 10.0):
        """Stop the thread. Callers drain first: an undrained job still
        finishes, but its outcome is lost with the pipeline."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
