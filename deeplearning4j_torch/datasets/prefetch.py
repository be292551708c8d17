"""Multi-worker prefetch with put-ahead to the card.

Counterpart of ``deeplearning4j_tpu/datasets/prefetch.py``:

- :class:`PrefetchIterator`: N worker threads pull from the base
  iterator. Pulls are serialized (python iterators are not thread-safe)
  and sequence-numbered, so the per-batch work (transform, host cast,
  copy to the card) runs in parallel while batch order is kept exactly.
  A worker's error re-raises on the consumer at the position where it
  happened, and every wait is bounded with a liveness check, so a dead
  worker raises instead of hanging the training loop.
- :class:`PrefetchDataSetIterator`: the DataSetIterator seam with
  put-ahead. While step k computes, batch k+1 is copied to the card: on
  a worker, the host arrays are cast and copied into pinned staging
  buffers (a ring of ``queue_size`` buffers per shape and type, each
  reused only after the copy out of it has completed), then copied with
  ``non_blocking=True`` on the pipeline's own CUDA stream, and an event
  is recorded after the copies. Before the step reads the batch, the
  consumer's stream waits for that event and is recorded on each tensor
  (``record_stream``), so the caching allocator does not hand the memory
  to a later copy while the step still reads it. On the CPU the put is a
  plain tensor conversion. In the fit loops' pipelines
  (``copy_under_backward``) the copy of batch k+1 is held until the step
  on batch k begins its backward
  (:func:`backward_begins`), so that it runs beside the backward's
  kernels: the forward and the update are launched one small kernel at a
  time and leave the card idle for stretches, where a copy that started
  at a random moment was overlapped as little as 3% (ROADMAP C 7).
- :func:`wrap_for_training`: the containers' fit-loop wrap, with the
  reference's dials ``DL4J_TPU_PREFETCH_WORKERS`` (default 2; 0 is the
  synchronous path), ``DL4J_TPU_PUT_AHEAD`` (default on) and
  ``DL4J_TPU_PREFETCH_QUEUE`` (default 2 with put-ahead, so at most two
  batches hold card memory; ``2 x workers`` host batches otherwise).

A failed pin, copy or event travels as the batch's error and raises on
the consumer in order; nothing reverts to a synchronous copy.

Monitor series (the JAX package's names): ``input_queue_depth`` (ready
batches buffered ahead of the consumer: 0 sustained means input-bound),
``input_wait_seconds`` (how long ``next()`` blocked), ``input_bytes_total``
and ``input_batches_total`` (host bytes and batches fed through). The
locks come from ``monitor.lockwatch`` under the JAX names.
"""
from __future__ import annotations

import collections
import logging
import os
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from .dataset import DataSet, DataSetIterator, DeviceArrays, MultiDataSet, to_tensor
from .iterators import AsyncDataSetIterator
from ..monitor import get_registry
from ..monitor.lockwatch import make_condition, make_lock

log = logging.getLogger(__name__)

__all__ = ["PrefetchIterator", "PrefetchDataSetIterator", "ShardedDataSet",
           "wrap_for_training"]

#: consumer/worker poll granularity (seconds): every blocking wait in this
#: module is bounded by this and re-checks stop/liveness, so no thread can
#: park forever on a condition a dead peer will never signal
_POLL_S = 0.2

#: host arrays of at least this many bytes are copied into their staging
#: buffer by torch (its intra-op threads: about 3x numpy's rate, but slow
#: to start on a fresh worker thread); smaller ones by numpy on the worker
#: alone. On an H100's host, from a fresh thread: 4.1 MB 0.81 ms by torch,
#: 0.32 ms by numpy; 537 MB 17.4 ms by torch, 50.4 ms by numpy
#: (``chip_smoke.py``'s ``host_copy_rates``)
_PARALLEL_COPY_BYTES = 32 << 20

#: device index -> the side stream every pipeline on that card copies on.
#: The caching allocator keeps freed blocks per stream, so a stream per
#: pipeline (a pipeline per fit) would make every fit allocate its batch
#: memory anew and leave the last fit's blocks cached on a stream no one
#: uses again.
_COPY_STREAMS = {}
_COPY_STREAMS_LOCK = threading.Lock()


def _copy_stream(device: torch.device):
    with _COPY_STREAMS_LOCK:
        stream = _COPY_STREAMS.get(device.index)
        if stream is None:
            stream = _COPY_STREAMS[device.index] = torch.cuda.Stream(device)
        return stream


#: the training steps' signal to held put-ahead copies: the number of
#: backwards begun so far in the process, and the condition a held copy
#: waits on (notified by each backward and by a consumer that starts
#: waiting). Plain ``threading`` primitives: no counterpart lock in the
#: JAX package.
_BACKWARDS = 0
_BACKWARD_COND = threading.Condition()


def backward_begins():
    """Called by the training steps just before their backward
    (``torch.autograd.grad``): a put-ahead copy held for it is queued
    now, to run beside the backward's kernels."""
    global _BACKWARDS
    with _BACKWARD_COND:
        _BACKWARDS += 1
        _BACKWARD_COND.notify_all()


def _hold_copy(ep: "_Epoch", seq: int):
    """Block the copy of batch ``seq`` until the consumer has taken batch
    ``seq - 1`` and a backward began after that, or until the consumer
    waits for a batch or the epoch stops. Batch 0 goes at once."""
    if seq == 0:
        return
    with _BACKWARD_COND:
        while not (ep.stop.is_set() or ep.waiting
                   or (ep.emit_seq == seq and _BACKWARDS > ep.take_gen)):
            _BACKWARD_COND.wait(_POLL_S)


class _Raise:
    """A worker-side error travelling the reorder buffer in batch order:
    batches produced before the failure are still delivered, then the
    exception re-raises on the consumer thread at its true position."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class _Epoch:
    """One epoch's pipeline state. Workers only touch the epoch they were
    born with, so a ``reset()`` mid-epoch cannot leak stale batches into
    the next epoch. The pull lock lives on the iterator: a stale worker
    still blocked inside ``next(source)`` after a timed-out join must keep
    excluding the next epoch's workers from the shared base."""

    __slots__ = ("source", "cond", "buf", "next_seq", "emit_seq", "end_seq", "exc",
                 "ended", "pulling", "source_done", "stop", "threads", "take_gen",
                 "waiting")

    def __init__(self, source):
        self.source = source
        self.cond = make_condition("_Epoch.cond")  # guards buf/emit_seq/end_seq
        self.buf = {}                       # seq -> item | _Raise
        self.next_seq = 0
        self.emit_seq = 0
        self.end_seq = None                 # first seq past the stream end
        self.exc = None                     # pull-side error (raised at end_seq)
        self.ended = False                  # no further pulls
        self.pulling = 0                    # concurrent mode: in-flight pulls
        self.source_done = False            # concurrent mode: saw exhaustion
        self.stop = threading.Event()
        self.threads = []
        self.take_gen = 0                   # _BACKWARDS when the consumer last took a batch
        self.waiting = False                # the consumer waits for a batch


class PrefetchIterator:
    """Order-preserving multi-worker prefetch over any iterator.

    ``transform`` runs on the worker threads: that is the parallel part.
    The pull itself is serialized under a lock by default;
    ``concurrent_pull=True`` lets the N workers call ``next(base)``
    concurrently, which a slow source needs to run in parallel and which
    is sound only when the base is safe to call from several threads
    (``DataSetIterator.concurrent_pull_supported()``). ``queue_size``
    bounds the batches ready ahead of the consumer (plus up to ``workers``
    in-flight transforms). ``finalize`` runs after admission into that
    window, still on the worker: the seam for work whose result must stay
    bounded, such as the copy to the card.
    """

    def __init__(self, base, workers: int = 2, queue_size: Optional[int] = None,
                 transform: Optional[Callable] = None, concurrent_pull: bool = False,
                 finalize: Optional[Callable] = None, name: str = "prefetch"):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self._base = base
        self._workers = int(workers)
        self._qsize = int(queue_size) if queue_size else max(2, 2 * workers)
        self._transform = transform
        self._finalize = finalize
        self._concurrent = bool(concurrent_pull)
        self._name = name
        self._pull_lock = make_lock("PrefetchIterator._pull_lock")
        self._hold_copies = False           # finalize(out, hold): see _hold_copy
        self._ep: Optional[_Epoch] = None
        self._handles = None

    def _metric_handles(self):
        if self._handles is None:
            reg = get_registry()
            self._handles = (
                reg.gauge("input_queue_depth",
                          "prefetched batches buffered ahead of the "
                          "training loop"),
                reg.histogram("input_wait_seconds",
                              "blocking wait for the next batch in the "
                              "input pipeline (seconds)", unit="s"),
                reg.counter("input_batches_total",
                            "batches served by the input pipeline"),
            )
        return self._handles

    # ------------------------------------------------------------- workers
    def _mark_end(self, ep: _Epoch, seq: int, exc=None):
        """Record the stream end (or the position of a failure): the
        smallest ending seq wins, and its exception (if any) re-raises
        after every earlier batch has been delivered."""
        with ep.cond:
            if ep.end_seq is None or ep.end_seq > seq:
                ep.end_seq = seq
                ep.exc = exc
            ep.cond.notify_all()

    def _pull(self, ep: _Epoch):
        """One pull: ``(seq, item)``, or None when the stream (or this
        worker's reason to continue) ended.

        Serial mode: ``next(source)`` and the seq assignment both happen
        under the pull lock, so order is exact and the first failure ends
        the stream at its true position.

        Concurrent mode: pulls run in parallel and seqs are assigned in
        pull-completion order, so no seq maps to a lost item. Exhaustion
        is final only once every in-flight pull has resolved: a worker that
        raced past a sibling's StopIteration with the true last item still
        delivers it."""
        if not self._concurrent:
            with self._pull_lock:
                if ep.ended or ep.stop.is_set():
                    return None
                seq = ep.next_seq
                try:
                    item = next(ep.source)
                except StopIteration:
                    ep.ended = True
                    self._mark_end(ep, seq)
                    return None
                except Exception as e:
                    ep.ended = True
                    self._mark_end(ep, seq, e)
                    return None
                ep.next_seq = seq + 1
            return seq, item
        with ep.cond:
            if ep.ended or ep.source_done:
                return None
            ep.pulling += 1
        try:
            item = next(ep.source)
        except StopIteration:
            self._concurrent_pull_resolved(ep, done=True)
            return None
        except Exception as e:
            self._concurrent_pull_resolved(ep, done=True, exc=e)
            return None
        with ep.cond:
            seq = ep.next_seq
            ep.next_seq = seq + 1
        self._concurrent_pull_resolved(ep, done=False)
        return seq, item

    @staticmethod
    def _concurrent_pull_resolved(ep: _Epoch, done: bool, exc=None):
        with ep.cond:
            ep.pulling -= 1
            if done:
                ep.source_done = True
                if exc is not None and ep.exc is None:
                    ep.exc = exc
            if ep.source_done and ep.pulling == 0 and ep.end_seq is None:
                # the last in-flight pull resolved: every assigned seq has
                # an item, so the end is exactly the seq count
                ep.end_seq = ep.next_seq
            ep.cond.notify_all()

    def _fail(self, ep: _Epoch, seq: int, e: Exception) -> _Raise:
        """A transform or finalize error at ``seq``: it is the stream's end
        at seq + 1, delivered (and raised) in order."""
        with ep.cond:
            ep.ended = True
        self._mark_end(ep, seq + 1)
        return _Raise(e)

    def _worker_loop(self, ep: _Epoch):
        depth_g = self._metric_handles()[0]
        while not ep.stop.is_set():
            pulled = self._pull(ep)
            if pulled is None:
                return
            seq, item = pulled
            try:
                out = item if self._transform is None else self._transform(item)
            except Exception as e:
                out = self._fail(ep, seq, e)
            # bounded put-ahead: wait for admission into the window, then
            # finalize, so at most queue_size finalized batches exist
            with ep.cond:
                while (not ep.stop.is_set() and seq - ep.emit_seq >= self._qsize
                       and (ep.end_seq is None or seq < ep.end_seq)):
                    ep.cond.wait(_POLL_S)
                if ep.stop.is_set():
                    return
                if ep.end_seq is not None and seq >= ep.end_seq:
                    continue   # past the recorded end: drop, never deliver
            if self._finalize is not None and not isinstance(out, _Raise):
                try:
                    out = (self._finalize(out, lambda ep=ep, seq=seq: _hold_copy(ep, seq))
                           if self._hold_copies else self._finalize(out))
                except Exception as e:
                    out = self._fail(ep, seq, e)
            with ep.cond:
                if ep.stop.is_set():
                    return
                ep.buf[seq] = out
                depth_g.set(len(ep.buf))
                ep.cond.notify_all()

    # ------------------------------------------------------------ protocol
    def __iter__(self):
        self.reset()
        return self

    def reset(self):
        stale = self._stop_epoch()
        # the base's reset under the pull lock: a stale serial-mode worker
        # still blocked inside next(source) holds it, so it cannot race the
        # rewind. The acquire is bounded: a source stuck forever gets a
        # warning, not a hang.
        if self._pull_lock.acquire(timeout=5):
            try:
                source = iter(self._base)
            finally:
                self._pull_lock.release()
        else:
            log.warning("%s: a previous epoch's worker is still blocked inside next(base) "
                        "after 5s; resetting the base anyway", self._name)
            source = iter(self._base)
        if stale:
            log.warning("%s: %d worker(s) from the previous epoch outlived their join; their "
                        "in-flight pull may consume (and discard) a batch from the reset "
                        "stream", self._name, stale)
        ep = _Epoch(source)
        for i in range(self._workers):
            t = threading.Thread(target=self._worker_loop, args=(ep,),
                                 name=f"{self._name}-{i}", daemon=True)
            ep.threads.append(t)
            t.start()
        self._ep = ep

    def _stop_epoch(self) -> int:
        """Stop and join the current epoch's workers; returns how many
        survived the bounded join (0 on the normal path)."""
        ep, self._ep = self._ep, None
        if ep is None:
            return 0
        ep.stop.set()
        with ep.cond:
            ep.cond.notify_all()
        for t in ep.threads:
            t.join(timeout=5)
        return sum(1 for t in ep.threads if t.is_alive())

    def shutdown(self):
        """Stop and join the current epoch's workers (no thread outlives a
        fit or a reset)."""
        self._stop_epoch()

    def __next__(self):
        if self._ep is None:
            self.reset()
        ep = self._ep
        depth_g, wait_h, batches_c = self._metric_handles()
        t0 = time.perf_counter()
        with ep.cond:
            while True:
                if ep.emit_seq in ep.buf:
                    item = ep.buf.pop(ep.emit_seq)
                    ep.take_gen = _BACKWARDS
                    ep.emit_seq += 1
                    ep.waiting = False
                    depth_g.set(len(ep.buf))
                    ep.cond.notify_all()     # space freed for producers
                    break
                if ep.end_seq is not None and ep.emit_seq >= ep.end_seq:
                    if ep.exc is not None:
                        raise ep.exc
                    raise StopIteration
                if not any(t.is_alive() for t in ep.threads):
                    # every worker died without delivering the batch we wait
                    # for: raise the cause, or a loud stand-in for it
                    if ep.exc is not None:
                        raise ep.exc
                    raise RuntimeError(
                        f"{self._name}: all {self._workers} prefetch workers died without "
                        f"delivering batch {ep.emit_seq} or an end-of-stream marker")
                if self._hold_copies and not ep.waiting:
                    ep.waiting = True        # releases a copy held for a backward
                    with _BACKWARD_COND:
                        _BACKWARD_COND.notify_all()
                ep.cond.wait(_POLL_S)
        wait_h.observe(time.perf_counter() - t0)
        if isinstance(item, _Raise):
            raise item.exc
        batches_c.inc()
        return item


# ------------------------------------------------------------- put-ahead
def _host_nbytes(ds) -> int:
    """Host bytes of a DataSet/MultiDataSet's arrays (before the copy)."""
    def nb(a):
        return int(getattr(a, "nbytes", 0) or 0) if a is not None else 0
    if isinstance(ds, MultiDataSet):
        total = sum(nb(a) for a in ds.features) + sum(nb(a) for a in ds.labels)
        for masks in (ds.features_masks, ds.labels_masks):
            if masks is not None:
                total += sum(nb(a) for a in masks)
        return total
    if isinstance(ds, DataSet):
        return (nb(ds.features) + nb(ds.labels) + nb(ds.features_mask)
                + nb(ds.labels_mask))
    return 0


class _PinnedStager:
    """The put-ahead's host-to-card copies for one pipeline on one card:
    pinned staging buffers, reused by shape and type (at most ``slots``
    each), and the side ``stream`` that every copy runs on."""

    def __init__(self, device: torch.device, slots: int, stream):
        self._device = device
        self._slots = slots
        self._stream = stream
        self._cond = threading.Condition()
        self._free = {}        # (shape, dtype) -> deque of (pinned, event of its last copy)
        self._count = collections.Counter()

    def _acquire(self, key):
        """A staging buffer for ``key``: a free one whose copy has
        completed, else a new one while fewer than ``slots`` exist, else
        the oldest free one once its copy completes."""
        with self._cond:
            ring = self._free.setdefault(key, collections.deque())
            while True:
                done = next((i for i, (_, ev) in enumerate(ring) if ev.query()), None)
                if done is not None:
                    buf, event = ring[done]
                    del ring[done]
                    return buf
                if self._count[key] < self._slots:
                    self._count[key] += 1
                    buf = None
                    break
                if ring:
                    buf, event = ring.popleft()
                    break
                self._cond.wait(_POLL_S)
        if buf is None:
            try:
                return torch.empty(key[0], dtype=key[1], pin_memory=True)
            except BaseException:
                self._discard(key)
                raise
        event.synchronize()
        return buf

    def release(self):
        """Give every staging buffer back to PyTorch's pinned-memory cache,
        which hands a block out again only after the copies out of it have
        completed; a later put allocates anew."""
        with self._cond:
            self._free.clear()
            self._count.clear()

    def _discard(self, key):
        with self._cond:
            self._count[key] -= 1
            self._cond.notify_all()

    def put(self, arrays, hold=None) -> DeviceArrays:
        """Host arrays (or None) -> their tensors on the card, with the
        event recorded on the side stream after the copies. ``hold``, when
        given, is called first and returns when the copies may start (it
        comes before the staging: a batch holding staged buffers would keep
        them from another worker's batch, which could hold the rest). Each
        staging buffer goes back to the ring as soon as its copy is queued
        (with an event of its own), so a batch may hold more arrays of one
        shape and type than there are slots."""
        if hold is not None:
            hold()
        hosts = [None if a is None else to_tensor(a, "cpu") for a in arrays]
        out = []
        with torch.cuda.stream(self._stream):
            for h in hosts:
                if h is None:
                    out.append(None)
                    continue
                key = (tuple(h.shape), h.dtype)
                buf = self._acquire(key)
                try:
                    if h.numel() * h.element_size() >= _PARALLEL_COPY_BYTES:
                        buf.copy_(h)
                    else:
                        np.copyto(buf.numpy(), h.numpy())
                    dst = torch.empty(h.shape, dtype=h.dtype, device=self._device)
                    dst.copy_(buf, non_blocking=True)
                    copied = torch.cuda.Event()
                    copied.record(self._stream)
                except BaseException:
                    self._discard(key)
                    raise
                with self._cond:
                    self._free[key].append((buf, copied))
                    self._cond.notify_all()
                out.append(dst)
            event = torch.cuda.Event()
            event.record(self._stream)
        return DeviceArrays(tuple(out), event)


def _device_view(ds, put):
    """A shallow DataSet/MultiDataSet whose arrays are tensors from
    ``put``. Built with ``__new__``: the constructors call ``np.asarray``,
    which would pull a tensor back to the host. The caller's DataSet is
    never mutated, so the card's copies die with the view (one step)."""
    if isinstance(ds, MultiDataSet):
        streams = ds._streams()
        entry = put([a for seq in streams if seq is not None for a in seq])
        it = iter(entry.arrays)
        view = MultiDataSet.__new__(MultiDataSet)
        (view.features, view.labels, view.features_masks, view.labels_masks) = [
            None if seq is None else [next(it) for _ in seq] for seq in streams]
    else:
        entry = put(ds._arrays())
        view = DataSet.__new__(DataSet)
        view.features, view.labels, view.features_mask, view.labels_mask = entry.arrays
    view._pending = entry
    return view


class PrefetchDataSetIterator(PrefetchIterator, DataSetIterator):
    """Multi-worker prefetch over a ``DataSetIterator``, with put-ahead to
    ``device`` when one is given.

    With ``device``, each batch is copied on a worker (on the CPU: made
    tensors), so the training loop receives tensors on the device and its
    own conversion is an identity; on the card the copy overlaps the
    previous step (double buffering, bounded by ``queue_size``).

    ``cache_device=True`` (``CacheMode.DEVICE`` networks): in place of a
    fresh copy per epoch, the worker warms :meth:`DataSet.device_arrays`
    on the base dataset, keeping the one-copy-per-dataset semantics
    across fits; the entry carries its event.

    ``transform`` (on the host, before the copy) is where decode, augment
    and padding work runs in parallel across workers.

    ``copy_under_backward`` (the fit loops' pipelines, on the card): the
    copy of batch k+1 (staging included) is held on its worker until the
    consumer has taken batch k and the step on it begins its backward
    (:func:`backward_begins`), so it runs beside the backward's kernels;
    a consumer that waits for a held batch releases it at once.

    ``sharding`` (a ``parallel.Sharding``, e.g. ``batch_sharded(mesh)``)
    places each batch into a mesh's slots on the worker
    (:class:`ShardedDataSet`: every array a list of the slots' shards,
    each on its slot's device; a replicated spec gives each slot a copy),
    the counterpart of the JAX package's ``jax.device_put(x, sharding)``:
    a ``parallel.data_parallel_step`` takes such a batch's lists as its
    slots' shards without placing them again.
    """

    def __init__(self, base: DataSetIterator, workers: int = 2,
                 queue_size: Optional[int] = None, device=None, cache_device: bool = False,
                 transform: Optional[Callable] = None,
                 concurrent_pull: Optional[bool] = None, sharding=None,
                 copy_under_backward: bool = False):
        self._sharding = sharding
        self._user_transform = transform
        self._bytes_counter = get_registry().counter(
            "input_bytes_total",
            "host bytes fed through the input pipeline")
        transform = self._prepare
        if sharding is not None:
            if device is not None or cache_device:
                raise ValueError("sharding places batches in the mesh's slots; it does not "
                                 "combine with device or cache_device")
            super().__init__(base, workers=workers, queue_size=queue_size,
                             transform=transform, finalize=self._put_sharded,
                             concurrent_pull=bool(getattr(base, "concurrent_pull_supported",
                                                          lambda: False)())
                             if concurrent_pull is None else concurrent_pull,
                             name="input-prefetch")
            self._device, self._device_put, self._cache_device = None, False, False
            self._stager = None
            return
        self._device = None if device is None else torch.device(device)
        self._device_put = self._device is not None
        self._cache_device = bool(cache_device)
        if concurrent_pull is None:
            concurrent_pull = bool(getattr(base, "concurrent_pull_supported",
                                           lambda: False)())
        super().__init__(base, workers=workers, queue_size=queue_size, transform=transform,
                         finalize=self._put_ahead if self._device_put else None,
                         concurrent_pull=concurrent_pull, name="input-prefetch")
        self._stager = None
        if self._device_put and self._device.type == "cuda":
            self._stager = _PinnedStager(self._device, self._qsize,
                                         _copy_stream(self._device))
            self._hold_copies = bool(copy_under_backward) and not self._cache_device

    def _prepare(self, ds):
        if self._user_transform is not None:
            ds = self._user_transform(ds)
        self._bytes_counter.inc(_host_nbytes(ds))
        return ds

    def _put(self, arrays, hold=None) -> DeviceArrays:
        if self._stager is not None:
            return self._stager.put(arrays, hold)
        return DeviceArrays(tuple(to_tensor(a, self._device) for a in arrays))

    def _put_sharded(self, ds):
        """The batch split into the sharding's slots (a DataSet's arrays;
        a MultiDataSet's streams member-wise)."""
        from ..parallel.sharding import shard_batch
        mesh, spec = self._sharding.mesh, tuple(self._sharding.spec)

        def put(a):
            if a is None:
                return None
            if not spec or spec[0] is None:
                return [to_tensor(a, d) for _, d in mesh.slots()]
            return shard_batch(a, mesh, spec[0])
        if isinstance(ds, MultiDataSet):
            streams = [ds.features, ds.labels, ds.features_masks, ds.labels_masks]
            return ShardedDataSet(*[None if seq is None else [put(a) for a in seq]
                                    for seq in streams], multi=True, n=ds.num_examples())
        if isinstance(ds, DataSet):
            return ShardedDataSet(put(ds.features), put(ds.labels), put(ds.features_mask),
                                  put(ds.labels_mask), n=ds.num_examples())
        return ds

    def _put_ahead(self, ds, hold=None):
        if self._stager is not None:
            torch.cuda.set_device(self._device)   # the worker's current card
        if self._cache_device and isinstance(ds, (DataSet, MultiDataSet)):
            # warm the base dataset's cache ahead of the step; the fit
            # loop's own device_arrays() call then hits it
            ds._device_entry(self._device, self._put)
            return ds
        if isinstance(ds, (DataSet, MultiDataSet)):
            return _device_view(ds, lambda arrays: self._put(arrays, hold))
        return ds

    def __next__(self):
        item = super().__next__()
        entry = getattr(item, "_pending", None)
        if entry is not None:
            entry.ready()           # on the consumer's stream
        return item

    def shutdown(self):
        """Stop and join the workers, and give the pinned staging buffers
        back (the next fit's pipeline draws them from PyTorch's cache)."""
        super().shutdown()
        if self._stager is not None:
            self._stager.release()

    def batch(self):
        return self._base.batch()

    def async_supported(self):
        return False    # already asynchronous: never wrap again


class ShardedDataSet:
    """A batch placed in a mesh's slots by ``PrefetchDataSetIterator(
    sharding=...)``: each array (each stream of a MultiDataSet's, with
    ``multi``) is a list of the slots' tensors."""

    def __init__(self, features, labels, features_mask=None, labels_mask=None,
                 multi=False, n=0):
        self.features, self.labels = features, labels
        self.features_mask, self.labels_mask = features_mask, labels_mask
        self.multi = multi
        self._n = int(n)

    def num_examples(self) -> int:
        return self._n


def wrap_for_training(it, device, cache_device: bool = False):
    """The containers' fit-loop wrap: returns ``(iterator, owned)``.
    ``owned`` is True when a new pipeline was made here; the caller must
    ``shutdown()`` it when fit ends, normally or by an error, so that no
    worker thread outlives the loop. ``device`` is the network's.

    Dials (read per call): ``DL4J_TPU_PREFETCH_WORKERS`` (default 2;
    ``0``: no wrap, fully synchronous), ``DL4J_TPU_PREFETCH_QUEUE`` (default
    2 with put-ahead, so at most two batches hold device memory; ``2 x
    workers`` host batches otherwise), ``DL4J_TPU_PUT_AHEAD`` (default on).
    """
    if not isinstance(it, DataSetIterator):
        return it, False
    if isinstance(it, (AsyncDataSetIterator, PrefetchDataSetIterator)):
        return it, False
    if not it.async_supported():
        return it, False
    try:
        workers = int(os.environ.get("DL4J_TPU_PREFETCH_WORKERS", "2"))
    except ValueError:
        workers = 2
    if workers <= 0:
        return it, False
    put_ahead = os.environ.get("DL4J_TPU_PUT_AHEAD", "1") not in ("0", "false", "")
    qs = os.environ.get("DL4J_TPU_PREFETCH_QUEUE", "")
    if qs.isdigit() and int(qs) > 0:
        queue_size = int(qs)
    else:
        queue_size = 2 if put_ahead else None
    return PrefetchDataSetIterator(it, workers=workers, queue_size=queue_size,
                                   device=device if put_ahead else None,
                                   cache_device=cache_device, copy_under_backward=True), True
