"""ParallelWrapper: data-parallel training over a mesh's slots.

Counterpart of ``deeplearning4j_tpu/parallel/wrapper.py`` (reference
``ParallelWrapper.java``: modes :59-74, fit :468, round-robin dispatch
:497-516, averaging barrier :551-562):

- ``TrainingMode.AVERAGING`` with ``averaging_frequency=1``: each step is
  one :class:`~.sharding.SyncStep` over the global batch (every slot's
  gradients on its shard, reduced in rank order, one update), which is the
  single network's step on that batch up to the reduction's rounding;
  under truncated BPTT, one such update a segment, each slot carrying
  its own state (``:348-427``). ``tensor_parallel``, ``weight_update_
  sharding`` and ``fsdp`` decide what the slots hold (``sharding.py``).
- ``averaging_frequency=N > 1``: local SGD (``:428-511``). Each slot
  advances a replica of its own (parameters, updater state, layer state)
  for N micro-batches on its shards, then parameters AND updater state are
  averaged (the reference's ``averageUpdatersState`` :339).
- ``TrainingMode.SHARED_GRADIENTS`` (``:707-792``): the reduced
  gradients go through the updater, the update through the threshold
  codec (``accumulation.py``: residual kept, the quantized decode is what
  peers would receive), and the decoded update is applied.

The reference's worker threads and device affinity become the mesh's
slots (``devices=``, default every visible card; a device may repeat).
Iterator batches group one a slot (round robin); a group whose size the
slots do not divide trains unsharded (``:697``), one iteration. Under
``CacheMode.DEVICE`` the sharded global batches are cached on the
group's arrays under a byte budget, ``DL4J_TPU_PW_CACHE_BYTES`` (the JAX
package's own switch, default 4 GiB), least recently used first out.
"""
from __future__ import annotations

import logging
import os
import time
from typing import List, Optional

import numpy as np
import torch

from ..datasets.dataset import (DataSet, DataSetIterator, ListDataSetIterator, MultiDataSet,
                                to_tensor)
from ..datasets.iterators import AsyncDataSetIterator
from ..datasets.prefetch import PrefetchDataSetIterator
from ..nn.conf import BackpropType, CacheMode
from ..nn.multilayer import _map_streams, _observe
from ..utils.trees import leaves
from .accumulation import EncodedGradientsAccumulator, GradientsAccumulator
from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, MeshSpec, default_devices, record_step,
                   require_axes, tree_get, tree_map)
from .sharding import SyncStep, _split_rows, clone_net, copy_into, slot_sum

log = logging.getLogger(__name__)

__all__ = ["ParallelWrapper", "TrainingMode"]


class TrainingMode:
    """Reference ``ParallelWrapper.TrainingMode`` (:59-74)."""
    AVERAGING = "averaging"
    SHARED_GRADIENTS = "shared_gradients"
    CUSTOM = "custom"


def _is_graph(net) -> bool:
    return hasattr(net, "topo")


def _as_multi(ds):
    if isinstance(ds, MultiDataSet):
        return ds
    return MultiDataSet([ds.features], [ds.labels],
                        None if ds.features_mask is None else [ds.features_mask],
                        None if ds.labels_mask is None else [ds.labels_mask])


def _segment(sl):
    """Cutters of a TBPTT segment ``sl``: (features and masks, labels; a
    rank-2 label, a whole-sequence one, passes), over tuples of streams."""
    return (lambda x: _map_streams(lambda a: a[:, sl], x),
            lambda x: _map_streams(lambda a: a[:, sl] if a.dim() == 3 else a, x))


class ParallelWrapper:
    """Builder-style facade over the data-parallel steps."""

    class Builder:
        def __init__(self, net):
            self._net = net
            self._kw = dict(workers=None, prefetch_buffer=2, prefetch_workers=2,
                            averaging_frequency=1, training_mode=TrainingMode.AVERAGING,
                            report_score_after_averaging=True, accumulator=None, mesh=None,
                            devices=None, weight_update_sharding=False, fsdp=False,
                            host_transfer_dtype=None, tensor_parallel=None, tp_rules=None)

        def _set(self, key, value):
            self._kw[key] = value
            return self

        def workers(self, n):
            return self._set("workers", int(n))

        def devices(self, devices):
            """The slots' devices (default every visible card; a device may
            repeat)."""
            return self._set("devices", list(devices))

        def prefetch_buffer(self, n):
            return self._set("prefetch_buffer", int(n))

        prefetchBuffer = prefetch_buffer

        def prefetch_workers(self, n):
            """Host ETL worker threads feeding the batch grouper (default 2);
            placement on the slots stays with the wrapper."""
            return self._set("prefetch_workers", int(n))

        prefetchWorkers = prefetch_workers

        def averaging_frequency(self, n):
            return self._set("averaging_frequency", int(n))

        averagingFrequency = averaging_frequency

        def training_mode(self, mode):
            return self._set("training_mode", mode)

        trainingMode = training_mode

        def report_score_after_averaging(self, flag=True):
            return self._set("report_score_after_averaging", bool(flag))

        reportScoreAfterAveraging = report_score_after_averaging

        def gradients_accumulator(self, acc: GradientsAccumulator):
            return self._set("accumulator", acc)

        gradientsAccumulator = gradients_accumulator

        def mesh(self, mesh: Mesh):
            return self._set("mesh", mesh)

        def tensor_parallel(self, n: int = 2, rules=None):
            """Tensor parallelism over a ``model`` axis of extent ``n`` on a
            2-D ``data x model`` mesh (``rules`` default
            :func:`~.tensor.megatron_rules`); AVERAGING with frequency 1
            only."""
            self._kw["tensor_parallel"] = int(n)
            return self._set("tp_rules", rules)

        tensorParallel = tensor_parallel

        def weight_update_sharding(self, flag=True):
            """Shard the updater state over the data axis (ZeRO-1);
            AVERAGING with frequency 1 only."""
            return self._set("weight_update_sharding", bool(flag))

        weightUpdateSharding = weight_update_sharding

        def fsdp(self, flag=True):
            """Shard the parameters and the updater state over the data axis
            (ZeRO-3); implies :meth:`weight_update_sharding`."""
            return self._set("fsdp", bool(flag))

        def host_transfer_dtype(self, dtype):
            """Cast float feature arrays to ``dtype`` on the host before the
            copy to the slots (explicit opt-in: bit-identical only when the
            layers compute in that type; unsafe for float-encoded ids)."""
            return self._set("host_transfer_dtype", dtype)

        hostTransferDtype = host_transfer_dtype

        def build(self) -> "ParallelWrapper":
            return ParallelWrapper(self._net, **self._kw)

    def __init__(self, net, workers: Optional[int] = None, prefetch_buffer: int = 2,
                 prefetch_workers: int = 2, averaging_frequency: int = 1,
                 training_mode: str = TrainingMode.AVERAGING,
                 report_score_after_averaging: bool = True,
                 accumulator: Optional[GradientsAccumulator] = None,
                 mesh: Optional[Mesh] = None, devices=None,
                 weight_update_sharding: bool = False, fsdp: bool = False,
                 host_transfer_dtype=None, tensor_parallel: Optional[int] = None,
                 tp_rules=None):
        from .distributed import process_count
        self.net = net
        self.host_transfer_dtype = host_transfer_dtype
        self.fsdp = bool(fsdp)
        self.weight_update_sharding = bool(weight_update_sharding) or self.fsdp
        if tp_rules is not None and tensor_parallel is None and mesh is None:
            raise ValueError("tp_rules needs a model axis: pass tensor_parallel=<extent> or a "
                             "mesh carrying a 'model' axis")
        if tensor_parallel is not None and int(tensor_parallel) < 2:
            raise ValueError(f"tensor_parallel extent must be >= 2 (got {tensor_parallel}); "
                             f"without a model split just omit it")
        self.tensor_parallel = None if tensor_parallel is None else int(tensor_parallel)
        if self.tensor_parallel and tp_rules is None:
            from .tensor import megatron_rules
            tp_rules = megatron_rules(net)
        self.tp_rules = tp_rules
        if int(getattr(net.gc, "iterations", 1) or 1) > 1:
            log.warning("iterations(%s) is ignored under ParallelWrapper; each dispatched "
                        "batch runs one optimizer iteration", net.gc.iterations)
        if mesh is None:
            devs = list(devices) if devices is not None else default_devices()
            if workers is not None and workers < len(devs):
                devs = devs[:workers]
            if self.tensor_parallel:
                mesh = MeshSpec(axes=(DATA_AXIS, MODEL_AXIS),
                                shape=(None, self.tensor_parallel), devices=devs).build()
            else:
                mesh = MeshSpec(axes=(DATA_AXIS,), devices=devs).build()
        elif self.tensor_parallel and MODEL_AXIS in mesh.shape and \
                int(mesh.shape[MODEL_AXIS]) != self.tensor_parallel:
            raise ValueError(f"tensor_parallel={self.tensor_parallel} but the given mesh has "
                             f"model extent {int(mesh.shape[MODEL_AXIS])}; drop one of the two "
                             f"or make them agree")
        self.mesh = mesh
        require_axes(self.mesh, (DATA_AXIS,), style="ParallelWrapper")
        if self.tp_rules is not None:
            require_axes(self.mesh, (MODEL_AXIS,), style="ParallelWrapper.tensor_parallel")
        # the wrapper drives the DATA axis: batch divisibility, round-robin
        # group size and iteration accounting follow the data extent
        self.workers_ = int(self.mesh.shape[DATA_AXIS])
        self.local_workers_ = self.workers_
        self.process_count = process_count()
        self._mp_batch_size = None
        if self.weight_update_sharding or self.tp_rules is not None:
            if (training_mode != TrainingMode.AVERAGING
                    or max(1, int(averaging_frequency)) != 1):
                what = "weight_update_sharding" if self.weight_update_sharding \
                    else "tensor_parallel"
                raise NotImplementedError(
                    f"{what} applies to TrainingMode.AVERAGING with averaging_frequency=1 "
                    "(the synchronous step); the local-SGD and SHARED_GRADIENTS paths keep "
                    "replicated model state")
        self._sharded_batch_cache = {}   # key -> (out, retained, nbytes)
        self._sharded_cache_bytes = 0
        self.sharded_cache_budget = int(os.environ.get("DL4J_TPU_PW_CACHE_BYTES", 4 << 30))
        self.prefetch_buffer = prefetch_buffer
        self.prefetch_workers = max(0, int(prefetch_workers))
        self.averaging_frequency = max(1, int(averaging_frequency))
        self.training_mode = training_mode
        self.report_score_after_averaging = report_score_after_averaging
        self.accumulator = accumulator
        self.iteration_count = 0
        self.last_score = float("nan")
        self.averaging_ms = 0.0
        self._sync_step: Optional[SyncStep] = None
        self._replicas = None
        self._is_graph = _is_graph(net)

    # ------------------------------------------------------------------ steps
    def _ensure_sync_step(self) -> SyncStep:
        if self._sync_step is None:
            self._sync_step = SyncStep(self.net, self.mesh, DATA_AXIS,
                                       shard_update=self.weight_update_sharding,
                                       shard_params=self.fsdp, tp_rules=self.tp_rules,
                                       style="sharding/dp_step")
        return self._sync_step

    def _tbptt_applicable(self, f) -> bool:
        """Whether a slot's feature shard trains as TBPTT segments: the
        containers' own predicate."""
        conf = self.net.conf
        if conf.backprop_type != BackpropType.TruncatedBPTT:
            return False
        xs = f if isinstance(f, (tuple, list)) else (f,)
        return all(x.dim() == 3 for x in xs) and xs[0].shape[1] > conf.tbptt_fwd_length

    def _fit_tbptt_segments(self, fs, ls, fms, lms, seg_step):
        """The sharded TBPTT loop (the containers' ``_run_tbptt``): one
        update a segment, each slot's carry detached between segments, one
        listener event a batch. ``seg_step(f_c, l_c, fm_c, lm_c, carries)
        -> (loss, carries)``."""
        net = self.net
        first = fs[0][0] if isinstance(fs[0], (tuple, list)) else fs[0]
        T, L = int(first.shape[1]), net.conf.tbptt_fwd_length
        carries = [net._init_rnn_state(int((f[0] if isinstance(f, (tuple, list)) else f)
                                           .shape[0])) for f in fs]
        loss = None
        for start in range(0, T, L):
            cut, cut_l = _segment(slice(start, min(start + L, T)))
            loss, carries = seg_step([cut(x) for x in fs], [cut_l(x) for x in ls],
                                     [cut(x) for x in fms], [cut(x) for x in lms], carries)
        self._scored(loss)

    def _scored(self, loss):
        net = self.net
        net.score_ = loss
        self.iteration_count += 1
        self.last_score = float(loss)
        _observe(net)

    # ------------------------------------------------------------------ fit
    def fit(self, data, epochs: int = 1):
        """Train over the iterator on every slot (reference ``fit`` :468)."""
        if isinstance(data, (DataSet, MultiDataSet)):
            data = ListDataSetIterator([data])
        it, owned = data, False
        if (isinstance(it, DataSetIterator)
                and not isinstance(it, (AsyncDataSetIterator, PrefetchDataSetIterator))
                and it.async_supported() and self.prefetch_workers > 0):
            # host ETL ahead of the batch grouper; placement stays here
            it = PrefetchDataSetIterator(it, workers=self.prefetch_workers,
                                         queue_size=self.prefetch_buffer, device=None)
            owned = True
        try:
            for _ in range(epochs):
                if self.training_mode == TrainingMode.SHARED_GRADIENTS:
                    self._fit_shared(it)
                elif self.averaging_frequency == 1:
                    self._fit_sync(it)
                else:
                    self._fit_local_sgd(it)
                self.net.epoch_count += 1
        finally:
            if owned:
                it.shutdown()
            if self._sync_step is not None:
                self._sync_step.gather()
        return self

    def _fit_sync(self, it):
        """AVERAGING freq=1: one :class:`SyncStep` a global batch (the
        reference's per-iteration averaging = the gradients' reduction)."""
        net = self.net
        step = self._ensure_sync_step()
        for group in self._batch_groups(it):
            if group is None:
                continue
            fs, ls, fms, lms = self._global_batch(group)
            if self._tbptt_applicable(fs[0]):
                def seg(f_c, l_c, fm_c, lm_c, carries):
                    return step(f_c, l_c, fm_c, lm_c, carries)
                self._fit_tbptt_segments(fs, ls, fms, lms, seg)
                continue
            loss, _ = step(fs, ls, fms, lms)
            self._scored(loss)

    def _batch_groups(self, it):
        """Groups of iterator batches, one a data slot (reference round-robin
        dispatch). A group whose example total the slots do not divide is
        trained unsharded here, one iteration, and yielded as None; under
        several processes it is dropped (an unsharded step would desync the
        processes' collectives) and batch sizes must be uniform."""
        net = self.net
        group_size = self.local_workers_
        pending = []
        it = iter(it)
        exhausted = False
        while not exhausted:
            try:
                pending.append(next(it))
            except StopIteration:
                exhausted = True
            if not pending or (len(pending) < group_size and not exhausted):
                continue
            group, pending = pending, []
            total = sum(b.num_examples() for b in group)
            if self.process_count > 1:
                sizes = {b.num_examples() for b in group}
                if self._mp_batch_size is None:
                    self._mp_batch_size = next(iter(sizes))
                sizes.add(self._mp_batch_size)
                if len(sizes) != 1:
                    raise ValueError(f"multi-process training requires uniform iterator "
                                     f"batch sizes; saw {sorted(sizes)}")
            if total % group_size:
                if self.process_count > 1:
                    log.warning("Dropping %d-example tail group (not divisible by %d local "
                                "slots)", total, group_size)
                    yield None
                    continue
                merged = self._merge(group)
                log.info("Batch group of %d examples not divisible by %d slots; training it "
                         "unsharded", total, self.workers_)
                self._fit_unsharded(net, merged)
                self.iteration_count += 1
                self.last_score = float(net.score_)
                yield None
                continue
            yield group

    def _merge(self, group):
        if len(group) == 1:
            return group[0]
        if self._is_graph:
            return MultiDataSet.merge([_as_multi(b) for b in group])
        return DataSet.merge(group)

    def _fit_unsharded(self, net, merged):
        """One unsharded batch with exactly one optimizer iteration a step
        (TBPTT: a segment), masks and segmentation as the container's own
        ``_fit_batch``."""
        if self._is_graph:
            f, l, fm, lm = net._streams(merged)
        else:
            f, l, fm, lm = net._tensors(merged)
        self._fit_tensors(net, f, l, fm, lm)

    def _fit_tensors(self, net, f, l, fm, lm):
        """One batch of tensors (a graph's: tuples of streams) through
        ``net``, one iteration a step or TBPTT segment."""
        net.last_batch_size = int((f[0] if isinstance(f, tuple) else f).shape[0])
        if self._tbptt_applicable(f):
            first = f[0] if isinstance(f, tuple) else f
            T, L = int(first.shape[1]), net.conf.tbptt_fwd_length
            state = net._init_rnn_state(int(first.shape[0]))
            for start in range(0, T, L):
                cut, cut_l = _segment(slice(start, min(start + L, T)))
                loss, state = net._step(cut(f), cut_l(l), cut(fm), cut(lm),
                                        net.iteration_count, state)
                net.iteration_count += 1
        else:
            loss, _ = net._step(f, l, fm, lm, net.iteration_count)
            net.iteration_count += 1
        net.score_ = loss
        _observe(net)

    # ------------------------------------------------------ shared gradients
    def _fit_shared(self, it):
        """SHARED_GRADIENTS (reference ``SymmetricTrainer`` +
        ``EncodedGradientsAccumulator.java:257``): every round the reduced
        update is threshold-encoded (sub-threshold mass stays in the
        residual) and the decoded update is applied, so the wire would
        carry ``encoded_bytes()`` instead of dense tensors."""
        if self.accumulator is None:
            self.accumulator = EncodedGradientsAccumulator()
        step = self._ensure_sync_step()
        record_step("wrapper/shared", self.mesh)
        for group in self._batch_groups(it):
            if group is None:
                continue
            fs, ls, fms, lms = self._global_batch(group)
            if self._tbptt_applicable(fs[0]):
                def seg(f_c, l_c, fm_c, lm_c, carries):
                    return self._shared_step(step, f_c, l_c, fm_c, lm_c, carries)
                self._fit_tbptt_segments(fs, ls, fms, lms, seg)
                continue
            loss, _ = self._shared_step(step, fs, ls, fms, lms)
            self._scored(loss)

    def _shared_step(self, step: SyncStep, fs, ls, fms, lms, carries=None):
        net = self.net
        per_slot = step.slot_grads(fs, ls, fms, lms, carries)
        loss, grads, new_states = step.reduce(per_slot)
        if not net.gc.minimize:
            grads = tree_map(torch.neg, grads)
        _, updates = net._updates(grads, net.iteration_count)
        decoded = self.accumulator.store_update(updates)
        with torch.no_grad():
            for path, p in leaves(net._trainable()):
                try:
                    u = tree_get(decoded, path)
                except KeyError:
                    continue        # a layer the step left out
                p.sub_(torch.as_tensor(u).to(p.device, p.dtype))
        net._apply_constraints()
        net._commit_states(new_states)
        net.iteration_count += 1
        return loss, [r[2] for r in per_slot]

    # -------------------------------------------------------------- local SGD
    def _ensure_replicas(self):
        """One replica a data slot, on the slot's device, each with its own
        step stream (seeded from the network's, offset by the slot)."""
        if self._replicas is None:
            net = self.net
            seed = int(net.gc.seed) + 1
            self._replicas = []
            for s, dev in enumerate(self.mesh.axis_devices(DATA_AXIS)):
                rep = clone_net(net, dev)
                rep._gen = torch.Generator().manual_seed(seed + 1000 * (s + 1))
                self._replicas.append(rep)
            record_step("wrapper/local_sgd", self.mesh)
        return self._replicas

    def _fit_local_sgd(self, it):
        """AVERAGING freq=N: N micro-batches a round, each slot's replica
        training on its shards of them, then the average of parameters,
        updater state and layer state."""
        net = self.net
        reps = self._ensure_replicas()
        pending: List = []
        for ds in it:
            pending.append(ds)
            if len(pending) < self.averaging_frequency:
                continue
            batches = [self._global_batch([b]) for b in pending]
            pending = []
            t0 = time.perf_counter()
            it0 = net.iteration_count
            losses = []
            for s, rep in enumerate(reps):
                copy_into(rep, net)
                rep.updater_state = tree_map(lambda t, d=rep.device: t.to(d, copy=True),
                                             net.updater_state)
                rep.iteration_count = it0
                for fs, ls, fms, lms in batches:
                    self._fit_tensors(rep, fs[s], ls[s], fms[s], lms[s])
                losses.append(rep.score_)
            self._average(reps)
            n_it = reps[0].iteration_count - it0
            loss = slot_sum(losses, net.device) / len(reps)
            self.last_score = float(loss)
            self.averaging_ms = (time.perf_counter() - t0) * 1e3
            net.iteration_count += n_it
            self.iteration_count += self.averaging_frequency
            net.score_ = loss
            if self.report_score_after_averaging:
                _observe(net)
        if pending:
            log.info("Dropping %d tail micro-batches (< averaging_frequency)", len(pending))

    def _average(self, reps):
        """The averaging barrier: parameters, layer state and updater state
        of the replicas, averaged in rank order into the network."""
        net, n = self.net, len(reps)
        dev = net.device
        with torch.no_grad():
            for name, p in leaves(net._trainable()):
                p.copy_(slot_sum([tree_get(r._trainable(), name) for r in reps], dev) / n)
            for name, t in leaves(net.states):
                if t.is_floating_point():
                    t.copy_(slot_sum([tree_get(r.states, name) for r in reps], dev) / n)
        net.updater_state = tree_map(lambda *ts: slot_sum(ts, dev) / n,
                                     reps[0].updater_state,
                                     *[r.updater_state for r in reps[1:]])

    # ---------------------------------------------------------------- batches
    def _global_batch(self, batches):
        """The group merged and split over the data slots: (features,
        labels, features masks, labels masks), each a list with one entry
        a slot (a tensor, a graph's tuple of streams, or None). Under
        ``CacheMode.DEVICE`` cached on the group's arrays (LRU under
        ``sharded_cache_budget`` bytes; cached arrays must not be mutated
        in place, or call :meth:`clear_device_cache`)."""
        if getattr(self.net.gc, "cache_mode", None) != CacheMode.DEVICE:
            return self._global_batch_uncached(batches)
        ckey = tuple(b._device_key() for b in batches)
        cache = self._sharded_batch_cache
        hit = cache.pop(ckey, None)
        if hit is not None:
            cache[ckey] = hit
            return hit[0]
        out = self._global_batch_uncached(batches)
        nbytes = sum(t.numel() * t.element_size() for part in out for slot in part
                     for t in _tensors_of(slot))
        cache[ckey] = (out, tuple(batches), nbytes)
        self._sharded_cache_bytes += nbytes
        while self._sharded_cache_bytes > self.sharded_cache_budget and len(cache) > 1:
            oldest = next(iter(cache))
            self._sharded_cache_bytes -= cache.pop(oldest)[2]
        return out

    def clear_device_cache(self):
        """Drop every cached sharded batch."""
        self._sharded_batch_cache.clear()
        self._sharded_cache_bytes = 0

    def _host_cast(self, x):
        """``host_transfer_dtype``: float features cast on the host, so the
        copy to the slots carries fewer bytes; integers untouched."""
        if self.host_transfer_dtype is None or x is None:
            return x
        t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
        if t.dtype not in (torch.float32, torch.float64):
            return x
        name = str(self.host_transfer_dtype)
        dt = torch.bfloat16 if name in ("bf16", "bfloat16", "torch.bfloat16") else \
            getattr(torch, name.replace("torch.", ""))
        compute = str(getattr(self.net.gc, "compute_dtype", "float32"))
        if compute != str(dt).replace("torch.", "") and not getattr(self, "_warned_cast", False):
            self._warned_cast = True
            log.warning("host_transfer_dtype=%s with compute_dtype=%s: inputs are rounded "
                        "BEFORE the (wider) compute — results will differ from the uncast "
                        "run. Bit-identical only when the two dtypes match.", dt, compute)
        return t.to("cpu").to(dt)

    def _global_batch_uncached(self, batches):
        n = self.workers_
        devs = self.mesh.axis_devices(DATA_AXIS)
        dev0 = devs[0]
        merged = self._merge(batches)
        put = lambda a: None if a is None else to_tensor(a, dev0)
        if self._is_graph:
            m = _as_multi(merged)
            f = tuple(put(self._host_cast(x)) for x in m.features)
            l = tuple(put(x) for x in m.labels)
            fm = None if m.features_masks is None else tuple(put(x) for x in m.features_masks)
            lm = None if m.labels_masks is None else tuple(put(x) for x in m.labels_masks)
            b = int(f[0].shape[0])
        else:
            f, l = put(self._host_cast(merged.features)), put(merged.labels)
            fm, lm = put(merged.features_mask), put(merged.labels_mask)
            b = int(f.shape[0])
        if b % n:
            raise ValueError(f"Local batch {b} not divisible by {n} local slots")
        return tuple(_split_rows(x, n, devs) for x in (f, l, fm, lm))

    def gather_model(self):
        """Put a sharded model (``fsdp``/``weight_update_sharding``/
        ``tensor_parallel``) back whole on the network; ``fit`` does this
        when it returns."""
        if self._sync_step is not None:
            self._sync_step.gather()
        return self.net

    gatherModel = gather_model

    def shutdown(self):
        """Nothing to stop: the slots run in this thread."""


def _tensors_of(x):
    if x is None:
        return []
    if isinstance(x, (tuple, list)):
        return [t for t in x if t is not None]
    return [x]
