"""Distributed training: the TrainingMaster SPI and training across
processes.

Counterpart of ``deeplearning4j_tpu/parallel/distributed.py`` (the
reference's Spark layer: ``TrainingMaster.java:28``,
``ParameterAveragingTrainingMaster``, ``SharedTrainingMaster.java:55``,
``SparkDl4jMultiLayer``). The JAX package forms its cluster with
``jax.distributed.initialize``; here :func:`initialize_distributed` forms
a ``torch.distributed`` process group (gloo on the CPU, NCCL across
cards) from an explicit address, world size and rank, since nothing on a
machine tells a program of its cluster. Each process runs its own mesh of
slots (``ParallelWrapper``); with several processes the synchronous
step's reduced gradients are averaged across them as well
(:func:`all_reduce_mean`). NCCL refuses two ranks on one card, so
multi-process runs on one machine use gloo on the CPU.
"""
from __future__ import annotations

import logging
import pickle
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .accumulation import EncodedGradientsAccumulator
from ..utils.trees import leaves
from .mesh import tree_get, tree_map
from .wrapper import ParallelWrapper, TrainingMode

log = logging.getLogger(__name__)

__all__ = ["initialize_distributed", "is_chief", "process_count", "process_index",
           "all_reduce_mean", "allgather_objects", "ProcessLocalIterator", "TrainingMaster",
           "ParameterAveragingTrainingMaster", "SharedTrainingMaster",
           "SharedGradientsClusterTrainer", "DistributedMultiLayerNetwork",
           "DistributedComputationGraph", "SparkDl4jMultiLayer", "SparkComputationGraph",
           "DistributedDataSetLossCalculator", "DistributedEarlyStoppingTrainer"]


def process_count() -> int:
    """Processes in the group (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


_process_count, _process_index = process_count, process_index


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           heartbeat_timeout_s: Optional[int] = None,
                           initialization_timeout_s: Optional[int] = None,
                           backend: Optional[str] = None) -> bool:
    """Form the process group (the reference's ``VoidParameterServer.init``
    handshake, ``SharedTrainingMaster.java:469``) at ``coordinator_address``
    (``host:port``) with ``num_processes`` ranks, this one ``process_id``;
    a no-op returning False without an address. ``backend`` defaults to
    NCCL when a card is visible, else gloo. The group is fate-shared: a
    collective with a dead peer raises once the timeout passes
    (``heartbeat_timeout_s``, else ``initialization_timeout_s``, else
    torch's default)."""
    if coordinator_address is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("initialize_distributed needs num_processes and process_id "
                         "beside coordinator_address")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    timeout = heartbeat_timeout_s or initialization_timeout_s
    kw = {} if timeout is None else {"timeout": timedelta(seconds=int(timeout))}
    addr = coordinator_address if "://" in coordinator_address else \
        f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=addr, world_size=int(num_processes),
                            rank=int(process_id), **kw)
    return True


def is_chief() -> bool:
    """True on rank 0: checkpoints and listener output are written once."""
    return process_index() == 0


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the processes (``t`` itself with one)."""
    if process_count() <= 1:
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out / process_count()


class ProcessLocalIterator:
    """Round-robins a shared stream over processes: process ``p`` of ``P``
    keeps batches ``p, p+P, ...``; training drops the final partial window
    so that every process takes the same number of steps."""

    def __init__(self, iterator, process_index: Optional[int] = None,
                 process_count: Optional[int] = None, drop_remainder: bool = True):
        self.it = iterator
        self.p = _process_index() if process_index is None else int(process_index)
        self.P = _process_count() if process_count is None else int(process_count)
        self.drop_remainder = drop_remainder

    def __iter__(self):
        chunk = []
        for b in self.it:
            chunk.append(b)
            if len(chunk) == self.P:
                yield chunk[self.p]
                chunk = []
        if chunk and not self.drop_remainder and self.p < len(chunk):
            yield chunk[self.p]

    def reset(self):
        if hasattr(self.it, "reset"):
            self.it.reset()

    def async_supported(self):
        return False


class TrainingMaster:
    """SPI (reference ``TrainingMaster.java:28``): how distributed fitting
    is executed."""

    def execute_training(self, net, iterator):
        raise NotImplementedError

    executeTraining = execute_training


class ParameterAveragingTrainingMaster(TrainingMaster):
    """Synchronous data parallelism (reference
    ``ParameterAveragingTrainingMaster``): averaging every iteration is the
    reduction of the gradients; ``averaging_frequency > 1`` is local SGD
    with parameters and updater state averaged."""

    class Builder:
        def __init__(self, batch_size_per_worker: int = 32):
            self._batch = batch_size_per_worker
            self._freq = 1
            self._workers = None
            self._devices = None

        def averaging_frequency(self, n):
            self._freq = int(n)
            return self

        averagingFrequency = averaging_frequency

        def batch_size_per_worker(self, n):
            self._batch = int(n)
            return self

        batchSizePerWorker = batch_size_per_worker

        def workers(self, n):
            self._workers = int(n)
            return self

        def devices(self, devices):
            self._devices = list(devices)
            return self

        def build(self):
            return ParameterAveragingTrainingMaster(
                batch_size_per_worker=self._batch, averaging_frequency=self._freq,
                workers=self._workers, devices=self._devices)

    def __init__(self, batch_size_per_worker: int = 32, averaging_frequency: int = 1,
                 workers: Optional[int] = None, devices=None):
        self.batch_size_per_worker = batch_size_per_worker
        self.averaging_frequency = averaging_frequency
        self.workers = workers
        self.devices = devices

    def execute_training(self, net, iterator):
        pw = ParallelWrapper(net, workers=self.workers, devices=self.devices,
                             averaging_frequency=self.averaging_frequency,
                             training_mode=TrainingMode.AVERAGING)
        pw.fit(iterator)
        return pw


class SharedTrainingMaster(TrainingMaster):
    """Quantized update sharing (reference ``SharedTrainingMaster``): the
    wrapper's SHARED_GRADIENTS mode with this master's accumulator."""

    class Builder:
        def __init__(self, threshold: float = 1e-3):
            self._threshold = threshold
            self._batch = 32
            self._workers = None
            self._devices = None

        def threshold(self, t):
            self._threshold = float(t)
            return self

        def batch_size_per_worker(self, n):
            self._batch = int(n)
            return self

        batchSizePerWorker = batch_size_per_worker

        def workers(self, n):
            self._workers = int(n)
            return self

        def devices(self, devices):
            self._devices = list(devices)
            return self

        def build(self):
            return SharedTrainingMaster(threshold=self._threshold,
                                        batch_size_per_worker=self._batch,
                                        workers=self._workers, devices=self._devices)

    def __init__(self, threshold: float = 1e-3, batch_size_per_worker: int = 32,
                 workers: Optional[int] = None, devices=None):
        self.threshold = threshold
        self.batch_size_per_worker = batch_size_per_worker
        self.workers = workers
        self.devices = devices
        self.accumulator = EncodedGradientsAccumulator(initial_threshold=threshold)

    def execute_training(self, net, iterator):
        pw = ParallelWrapper(net, workers=self.workers, devices=self.devices,
                             training_mode=TrainingMode.SHARED_GRADIENTS,
                             accumulator=self.accumulator)
        pw.fit(iterator)
        return pw


class SharedGradientsClusterTrainer:
    """SHARED_GRADIENTS across processes over a real wire (reference
    ``SharedTrainingWrapper.java:160-244``): each process encodes its local
    update, exchanges frames with its peers over ``transport.py``'s TCP
    mesh, and applies the rank-ordered sum of everyone's decoded update,
    so the replicas stay bit-identical while the wire carries the
    encoding."""

    def __init__(self, net, channel, accumulator: Optional[EncodedGradientsAccumulator] = None):
        self.net = net
        self.channel = channel
        self.accumulator = accumulator or EncodedGradientsAccumulator()
        self.wire_bytes_sent = 0
        self.dense_bytes_equiv = 0

    def fit(self, iterator, epochs: int = 1):
        # imported here: the parameter server's package imports this module
        from ..paramserver.overlap import async_device_get
        net, acc, ch = self.net, self.accumulator, self.channel
        for _ in range(epochs):
            for ds in iterator:
                f, l, fm, lm = net._tensors(ds)
                loss, _, new_states = net._train_loss(f, l, fm, lm)
                grads = net._grads(loss, skip=net._idle_frozen())
                if not net.gc.minimize:
                    grads = tree_map(torch.neg, grads)
                _, update = net._updates(grads, net.iteration_count)
                update = async_device_get(update)
                decoded_own = acc.store_update(update)
                frame = acc.serialize_last()
                self.wire_bytes_sent += len(frame) * (ch.P - 1)
                self.dense_bytes_equiv += sum(u.nbytes for u in _np_leaves(update)) * (ch.P - 1)
                peer_frames = ch.exchange(frame)
                contributions = {ch.p: decoded_own}
                peers = [q for q in range(ch.P) if q != ch.p]
                for q, fr in zip(peers, peer_frames):
                    contributions[q] = acc.decode_payload(fr)
                total = None
                for q in sorted(contributions):
                    c = contributions[q]
                    total = c if total is None else tree_map(np.add, total, c)
                with torch.no_grad():
                    for path, p in leaves(net._trainable()):
                        try:
                            u = tree_get(total, path)
                        except KeyError:
                            continue
                        p.sub_(torch.as_tensor(u).to(p.device, p.dtype))
                net._commit_states(new_states)
                net.score_ = loss.detach()
                net.iteration_count += 1
                for lst in net.listeners:
                    lst.iteration_done(net, net.iteration_count - 1, float(loss))
        return net


def _np_leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


class DistributedMultiLayerNetwork:
    """User-facing facade (reference ``SparkDl4jMultiLayer``:
    ``fit(JavaRDD<DataSet>)`` :214 -> ``trainingMaster.executeTraining``)."""

    def __init__(self, net, training_master: TrainingMaster,
                 checkpoint_path: Optional[str] = None):
        self.net = net
        self.training_master = training_master
        self.checkpoint_path = checkpoint_path

    def fit(self, iterator, epochs: int = 1):
        multi = process_count() > 1
        saved = None
        if multi:
            iterator = ProcessLocalIterator(iterator)
            if not is_chief():
                saved, self.net.listeners = self.net.listeners, []
        try:
            for _ in range(epochs):
                self.training_master.execute_training(self.net, iterator)
        finally:
            if saved is not None:
                self.net.listeners = saved
        if self.checkpoint_path and is_chief():
            from ..utils.model_serializer import ModelSerializer
            ModelSerializer.write_model(self.net, self.checkpoint_path)
        return self.net

    def evaluate(self, iterator):
        """Distributed evaluation (reference ``IEvaluateFlatMapFunction`` +
        ``IEvaluationReduceFunction``): each process evaluates its share,
        the partial evaluations are gathered and merged."""
        if process_count() <= 1:
            return self.net.evaluate(iterator)
        local = self.net.evaluate(ProcessLocalIterator(iterator, drop_remainder=False))
        merged = None
        for part in allgather_objects(local):
            merged = part if merged is None else merged.merge(part)
        return merged

    def calculate_score(self, iterator, average: bool = True):
        """Reference ``calculateScore`` :332."""
        total, n = 0.0, 0
        for ds in iterator:
            b = ds.num_examples()
            total += self.net.score(ds) * b
            n += b
        return total / n if (average and n) else total

    calculateScore = calculate_score


SparkDl4jMultiLayer = DistributedMultiLayerNetwork


class DistributedComputationGraph(DistributedMultiLayerNetwork):
    """Reference ``SparkComputationGraph`` counterpart."""


SparkComputationGraph = DistributedComputationGraph


def allgather_objects(obj) -> list:
    """Every process's picklable ``obj``, in rank order (``[obj]`` with one
    process): ``torch.distributed.all_gather_object``."""
    if process_count() <= 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, pickle.loads(pickle.dumps(obj)))
    return out


class DistributedDataSetLossCalculator:
    """Cluster-wide validation loss (reference
    ``SparkDataSetLossCalculator.java``): each process sums the loss over
    its share, the partial (total, n) pairs are gathered, and every process
    computes the same average."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def minimize_score(self) -> bool:
        return True

    def calculate_score(self, net) -> float:
        it = (ProcessLocalIterator(self.iterator, drop_remainder=False)
              if process_count() > 1 else self.iterator)
        total, n = 0.0, 0
        for ds in it:
            b = ds.num_examples()
            total += float(net.score(ds)) * b
            n += b
        parts = allgather_objects((total, n))
        total = sum(t for t, _ in parts)
        n = sum(c for _, c in parts)
        return total / n if (self.average and n) else total

    calculateScore = calculate_score


from ..earlystopping import EarlyStoppingTrainer, TerminationReason  # noqa: E402


class DistributedEarlyStoppingTrainer(EarlyStoppingTrainer):
    """Early stopping over the distributed facade (reference
    ``SparkEarlyStoppingTrainer.java``): each epoch runs through the
    facade's TrainingMaster; score with
    :class:`DistributedDataSetLossCalculator` so that the conditions fire
    alike on every process."""

    def __init__(self, config, dist_net: DistributedMultiLayerNetwork, train_iterator):
        super().__init__(config, dist_net.net, train_iterator)
        self.dist_net = dist_net

    def _train_one_epoch(self, c, reason, details):
        before = self.net.epoch_count
        self.dist_net.fit(self.iterator, epochs=1)
        self.net.epoch_count = before
        last = float(self.net.score_)
        for cond in c.iteration_termination_conditions:
            if cond.terminate(last):
                reason = TerminationReason.IterationTerminationCondition
                details = f"{type(cond).__name__} at score {last}"
                return True, reason, details
        return False, reason, details


SparkEarlyStoppingTrainer = DistributedEarlyStoppingTrainer
SparkDataSetLossCalculator = DistributedDataSetLossCalculator
