"""Server-mediated asynchronous training: ``ParameterServerTrainingMaster``.

Counterpart of ``deeplearning4j_tpu/paramserver/training.py``, the third
TrainingMaster of ``parallel/distributed.py``'s SPI: every update goes
through a :class:`~.server.ParameterServer` (the reference
``SharedTrainingMaster``'s deployment in which ``VoidParameterServer``
nodes hold the parameters and the executors are clients). Workers are
decoupled: one can die, back off and rejoin (``init_params``, then adopt
the server's state) without the others.

A step: the container's seam computes the update of one standard-backprop
step over the whole sequence (``_train_loss`` -> ``_grads`` -> the minimize
flip -> ``_updates``: normalization and the updater, nothing applied), the
layers' new state is committed, the update is copied to the host
(``overlap.start_device_get``: pinned memory, a side stream, an event),
threshold-encoded with the residual kept in the
``EncodedGradientsAccumulator``, the decoded update applied locally
(``p -= u``), the frame pushed, and the server's state adopted under the
bounded-staleness rule (``staleness=0``: after every push; k: up to k
unseen versions). A lossless accumulator (threshold 0) applies the
device's own update (the fast path: decode would give the same values).
``overlap(True)`` hands encode, push and the staleness probe to a
:class:`~.overlap.CommsPipeline` while the card computes the next step.

Several server addresses (comma-joined or a list; the order is the shard
assignment) drive a :class:`~.sharded.ShardedParameterServerClient`: the
versions become per-shard lists, a failed shard push's mass is
re-injected into the accumulator's residual, and a partial resync
scatters only the refreshed shards' slices. ``delta_push`` rides the
proto v3 delta wire (default: on for several servers, off for one);
``remap`` rebinds the master to a rebalanced fleet between fits. Joins,
leaves and rejoins are flight-recorder events (``worker_join``,
``worker_leave``, ``worker_rejoin``), and the telemetry reports carry the
recorder's tail. The compile cache the JAX master enables at join (A 16)
has nothing to do in an eager port.
"""
from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

from ..monitor import get_flight_recorder
from ..monitor.jitwatch import monitored_jit
from ..parallel.accumulation import EncodedGradientsAccumulator, flatten_tree_f32
from ..parallel.distributed import TrainingMaster
from ..utils.trees import sorted_leaves, tree_map
from .client import ParameterServerClient, ParameterServerError
from .sharded import ShardedParameterServerClient, parse_addresses
from .metrics import ParamServerMetricsListener  # noqa: F401  (re-export)
from .metrics import TrainStepPhases
from .overlap import CommsPipeline, async_device_get, start_device_get

__all__ = ["ParameterServerTrainingMaster", "flatten_params", "set_params_from_flat"]

log = logging.getLogger(__name__)


def flatten_params(params) -> np.ndarray:
    """Flat float32 vector in the wire layout (``flatten_tree_f32``: the
    leaves in sorted key order, as the JAX package flattens), so pushed
    updates and the server's parameters index alike."""
    return flatten_tree_f32(params)[0]


def set_params_from_flat(net, vec: np.ndarray):
    """Inverse of :func:`flatten_params`: copy a server vector into the
    network's parameters in place (their shapes, dtypes and device kept).
    A vector of the wrong length raises ``ValueError`` before anything is
    written."""
    vec = np.asarray(vec, np.float32)
    items = sorted_leaves(net._trainable())
    n = sum(int(p.numel()) for _, p in items)
    if n != vec.size:
        raise ValueError(f"server vector length {vec.size} != model {n}")
    flat = torch.from_numpy(vec.copy())
    if items:
        flat = flat.to(items[0][1].device)
    off = 0
    with torch.no_grad():
        for _, p in items:
            k = int(p.numel())
            p.copy_(flat[off:off + k].view(p.shape).to(p.dtype))
            off += k


def _aligned(update, params):
    """The update as a tree with an entry for every parameter: a layer the
    step skipped (an idle frozen layer, an empty dict) updates by zeros, as
    its zero gradient does in the JAX package."""
    out = {}
    for path, p in sorted_leaves(params):
        node = update
        for part in path.split("/"):
            node = node.get(part) if isinstance(node, dict) else None
            if node is None:
                break
        d = out
        parts = path.split("/")
        for part in parts[:-1]:
            d = d.setdefault(part, {})
        d[parts[-1]] = torch.zeros_like(p) if node is None else node
    return out


class ParameterServerTrainingMaster(TrainingMaster):
    """Asynchronous data parallelism through a parameter server, taken as
    the collective masters are::

        master = (ParameterServerTrainingMaster.Builder("127.0.0.1:40123")
                  .staleness(2).threshold(1e-3).build())
        DistributedMultiLayerNetwork(net, master).fit(iterator)

    A server outage within the client's retry budget is absorbed; past it
    :class:`~.client.ServerUnavailableError` surfaces: keep the net (its
    parameters are the last adopted state) and fit again once the server
    is back (the rejoin pulls its state)."""

    class Builder:
        def __init__(self, server_address):
            self._address = server_address
            self._staleness = 0
            self._threshold = 1e-3
            self._batch = 32
            self._retries = 5
            self._backoff = 0.05
            self._count_own_pushes = True
            self._worker_id = None
            self._telemetry_interval = 5.0
            self._num_servers = None
            self._delta_push = None
            self._overlap = False

        def staleness(self, n):
            self._staleness = int(n)
            return self

        def threshold(self, t):
            self._threshold = float(t)
            return self

        def batch_size_per_worker(self, n):
            self._batch = int(n)
            return self

        batchSizePerWorker = batch_size_per_worker

        def max_retries(self, n):
            self._retries = int(n)
            return self

        def backoff(self, seconds):
            self._backoff = float(seconds)
            return self

        def count_own_pushes(self, flag: bool = True):
            self._count_own_pushes = bool(flag)
            return self

        countOwnPushes = count_own_pushes

        def worker_id(self, wid: str):
            self._worker_id = str(wid)
            return self

        workerId = worker_id

        def telemetry_interval(self, seconds: float):
            self._telemetry_interval = float(seconds)
            return self

        telemetryInterval = telemetry_interval

        def num_servers(self, n: int):
            """Expected shard-server count: checked against the address
            list (a width that disagreed with the topology would mis-shard
            every push)."""
            self._num_servers = int(n)
            return self

        numServers = num_servers

        def delta_push(self, flag: bool = True):
            """Proto v3 delta wire: per-shard sparse pushes and
            journal-replay pulls (default on for several addresses, off
            for one; True with one address rides the delta wire against a
            single server through the sharded client)."""
            self._delta_push = bool(flag)
            return self

        deltaPush = delta_push

        def overlap(self, flag: bool = True):
            """The comms pipeline (``overlap.py``): step k's encode and
            push on a background thread while the card computes step k+1,
            one step more of staleness. Default False: the synchronous
            loop."""
            self._overlap = bool(flag)
            return self

        def build(self):
            return ParameterServerTrainingMaster(
                self._address, staleness=self._staleness, threshold=self._threshold,
                batch_size_per_worker=self._batch, max_retries=self._retries,
                backoff=self._backoff, count_own_pushes=self._count_own_pushes,
                worker_id=self._worker_id, telemetry_interval=self._telemetry_interval,
                num_servers=self._num_servers, delta_push=self._delta_push,
                overlap=self._overlap)

    def __init__(self, server_address, staleness: int = 0, threshold: float = 1e-3,
                 batch_size_per_worker: int = 32, max_retries: int = 5,
                 backoff: float = 0.05, count_own_pushes: bool = True,
                 worker_id: Optional[str] = None, telemetry_interval: float = 5.0,
                 num_servers: Optional[int] = None, delta_push: Optional[bool] = None,
                 client: Optional[ParameterServerClient] = None, overlap: bool = False):
        self.server_address = server_address
        self.staleness = int(staleness)
        self.threshold = float(threshold)
        self.batch_size_per_worker = int(batch_size_per_worker)
        self.max_retries = int(max_retries)
        self.backoff = float(backoff)
        #: True: ``local_version`` advances only on pulls, so a worker's
        #: own pushes count toward the pull trigger (staleness 0 resyncs
        #: after every push). False: a pushed version exactly
        #: ``local_version + 1`` (provably our own push) is adopted, so a
        #: lone worker stops pulling its own updates back
        self.count_own_pushes = bool(count_own_pushes)
        self.worker_id = worker_id
        #: seconds between mid-training telemetry reports (0 = every step,
        #: None = only at join and leave)
        self.telemetry_interval = telemetry_interval
        #: the sharded fleet's dials: ``server_address`` may name N servers
        #: (shard order is address order), ``num_servers`` cross-checks
        #: that width, ``delta_push`` rides the delta wire (None: on for
        #: several servers)
        self.num_servers = num_servers
        self.delta_push = delta_push
        self.overlap = bool(overlap)
        self.client = client
        self.accumulator = EncodedGradientsAccumulator(initial_threshold=threshold)
        #: the server version the net reflects; a list, one a shard, under
        #: the sharded client
        self.local_version = 0
        self._step_net = None
        self._joined_once = False
        self._last_telemetry = 0.0
        self._pipeline: Optional[CommsPipeline] = None
        self._phases: Optional[TrainStepPhases] = None

    # ------------------------------------------------------------ plumbing
    def _ensure_client(self):
        if self.client is None:
            addrs = parse_addresses(self.server_address)
            if self.num_servers is not None and self.num_servers != len(addrs):
                raise ValueError(
                    f"num_servers={self.num_servers} but {len(addrs)} "
                    f"server address(es) configured: {addrs}")
            delta = self.delta_push if self.delta_push is not None else len(addrs) > 1
            if len(addrs) > 1 or self.delta_push:
                self.client = ShardedParameterServerClient(
                    addrs, staleness=self.staleness, delta=delta,
                    max_retries=self.max_retries, backoff=self.backoff,
                    worker_id=self.worker_id)
            else:
                self.client = ParameterServerClient(
                    addrs[0], staleness=self.staleness, max_retries=self.max_retries,
                    backoff=self.backoff, worker_id=self.worker_id)
        return self.client

    def remap(self, addresses):
        """Rebind the master to a new shard-server set between fits (after
        ``ShardedParameterServerGroup.scale_to`` or a move). The next fit
        joins the new layout (``init_params`` finds it seeded and adopts
        the rebalanced state); a sharded client remaps in place
        (``client_remap`` flight event), a single-server client is
        rebuilt. An in-flight comms round is drained first: its push
        targeted the old layout, and a failed one re-raises here."""
        self._drain_for_membership_change("remap")
        addrs = parse_addresses(addresses)
        self.server_address = ",".join(addrs)
        self.num_servers = None
        if self.client is not None:
            if hasattr(self.client, "remap"):
                self.client.remap(addrs)
            else:
                self.client.close()
                self.client = None
        self.local_version = 0

    def _ship_telemetry(self, client: ParameterServerClient, force: bool = False):
        """Best-effort OP_TELEMETRY report under the interval dial: a
        transport failure is logged and swallowed (the next op's retry loop
        owns reconnecting)."""
        now = time.monotonic()
        if not force:
            if self.telemetry_interval is None:
                return
            if now - self._last_telemetry < self.telemetry_interval:
                return
        try:
            client.send_telemetry(
                flight_events=get_flight_recorder().events()[-64:])
            self._last_telemetry = now
        except (ConnectionError, ParameterServerError) as e:
            log.debug("telemetry report to %s skipped: %s", client.address, e)

    def _ensure_steps(self, net):
        """A master reused with another net resets the accumulator: the
        residual and the adaptive threshold belong to the previous net's
        update stream."""
        if self._step_net is not net:
            if self._step_net is not None:
                self.accumulator.reset()
            self._step_net = net

    @staticmethod
    @monitored_jit(name="paramserver/update_step")
    def _update_step(net, ds):
        """One step's update, nothing applied: (update tree aligned to the
        parameters, detached loss). The layers' new state is committed, as
        the JAX step returns it."""
        f, l, fm, lm = net._tensors(ds)
        loss, _, new_states = net._train_loss(f, l, fm, lm)
        grads = net._grads(loss, skip=net._idle_frozen())
        if not net.gc.minimize:
            grads = tree_map(torch.neg, grads)
        _, update = net._updates(grads, net.iteration_count)
        net._commit_states(new_states)
        return _aligned(update, net._trainable()), loss.detach()

    @staticmethod
    @monitored_jit(name="paramserver/apply_step")
    def _apply(net, update):
        """``p -= u`` in place; ``update`` holds tensors (the fast path's
        device update) or host arrays (a decoded frame)."""
        with torch.no_grad():
            for path, p in sorted_leaves(net._trainable()):
                u = update
                for part in path.split("/"):
                    u = u[part]
                p.sub_(torch.as_tensor(u).to(p.device, p.dtype))

    # ------------------------------------------------------ hot-loop parts
    def _adopt_pushed_version(self, pushed_version):
        """``count_own_pushes=False``: adopt a pushed version only when it
        is exactly ``local_version + 1`` (just our own push); a gap means
        other workers' pushes interleaved, which a pull must bring in."""
        if self.count_own_pushes:
            return
        if isinstance(pushed_version, list):
            # per shard: each node's version counts its own pushes only
            for j, pv in enumerate(pushed_version):
                if pv is not None and pv == self.local_version[j] + 1:
                    self.local_version[j] = pv
        elif pushed_version == self.local_version + 1:
            self.local_version = pushed_version

    def _adopt_fresh(self, net, client, fresh):
        """Adopt a non-None ``pull_if_stale`` answer into the net: a full
        vector, or (sharded, some shards fresh) only the refreshed shards'
        slices, the fresh shards keeping this worker's local state."""
        if fresh is None:
            return
        self.local_version, payload = fresh
        if isinstance(payload, dict):
            vec = flatten_params(net.params)
            n_srv = client.num_servers
            for j, values in payload.items():
                vec[j::n_srv] = values
            payload = vec
        set_params_from_flat(net, payload)

    def _comms_round(self, client, acc, update_host, fast):
        """One comms round for ``update_host``: encode, push, failed-mass
        re-injection, version contiguity, the staleness probe and the
        periodic telemetry. Runs on the comms thread in overlap mode and
        returns ``(decoded_own, fast, fresh)`` for the training thread."""
        with self._phases.phase("encode"):
            decoded_own = acc.store_update(update_host)
        with self._phases.phase("push"):
            pushed_version, failed_mass = client.push_encoded(acc.last_encoded)
        if failed_mass is not None:
            # a down shard's mass re-rides the next encode
            acc.reinject(failed_mass)
        self._adopt_pushed_version(pushed_version)
        fresh = client.pull_if_stale(self.local_version)
        self._ship_telemetry(client)
        return decoded_own, fast, fresh

    def _drain_for_membership_change(self, what: str):
        """Land an in-flight comms round before the shard set changes
        under it; a failed push re-raises here, never discarded."""
        if self._pipeline is None or not self._pipeline.inflight():
            return
        if self._step_net is not None and self.client is not None:
            self._drain_inflight(self._step_net, self.client)
        else:
            log.warning("%s with an in-flight comms round but no bound net: draining "
                        "without apply", what)
            self._pipeline.drain()

    def _drain_inflight(self, net, client):
        """Drain the in-flight round (a no-op without one): apply its
        decoded update unless the fast path applied the device's own, and
        adopt any pull it brought. A failed job re-raises here."""
        if self._pipeline is None or not self._pipeline.inflight():
            return
        decoded_own, fast, fresh = self._pipeline.drain()
        if not fast:
            self._apply(net, decoded_own)
        self._adopt_fresh(net, client, fresh)

    def close(self):
        """Drain an in-flight round loudly, stop the comms thread, close
        the client. The master stays reusable (the next fit reconnects)."""
        try:
            if self._pipeline is not None and self._step_net is not None \
                    and self.client is not None:
                self._drain_inflight(self._step_net, self.client)
        finally:
            if self._pipeline is not None:
                self._pipeline.close()
                self._pipeline = None
            if self.client is not None:
                self.client.close()
                self.client = None

    @property
    def phases(self) -> Optional[TrainStepPhases]:
        """The last fit's phase timings."""
        return self._phases

    # ------------------------------------------------------------ training
    def execute_training(self, net, iterator):
        # a joining or rejoining worker is about to load (or build) its
        # kernel libraries: the fleet's shared cache directory, if any
        from ..compilecache.cache import maybe_enable
        maybe_enable()
        client = self._ensure_client()
        self._ensure_steps(net)
        acc = self.accumulator
        phases = self._phases = TrainStepPhases(client.tracer, overlap=self.overlap)
        if self.overlap and self._pipeline is None:
            self._pipeline = CommsPipeline()
        # a round left in flight by an aborted fit lands before the join
        self._drain_inflight(net, client)

        if not self.count_own_pushes:
            stats0 = client.stats()
            if isinstance(stats0, list):   # sharded: one snapshot a shard
                stats0 = next((st for st in stats0 if "threshold" in st), {})
            if float(stats0.get("threshold", 0.0)) > 0.0:
                log.warning(
                    "count_own_pushes=False against a residual-merging server "
                    "(threshold > 0): skipped pulls let local params drift "
                    "from the server's merged state; prefer the default "
                    "count_own_pushes=True on threshold>0 servers")

        fr = get_flight_recorder()
        join_kind = "worker_rejoin" if self._joined_once else "worker_join"
        version, created = client.init_params(flatten_params(net.params))
        if not created:
            # join or rejoin: adopt the server's merged state before stepping
            version, vec = client.pull()
            try:
                set_params_from_flat(net, vec)
            except ValueError as e:
                raise ParameterServerError(
                    f"server {client.address} holds parameters for a different "
                    f"model: {e}") from e
        self.local_version = version
        fr.record(join_kind, worker=client.worker_id, server=client.address, seeded=created,
                  version=(list(map(int, version)) if isinstance(version, (list, tuple))
                           else int(version)))
        self._joined_once = True
        self._ship_telemetry(client, force=True)

        steps = 0
        try:
            for ds in iterator:
                step_t0 = time.perf_counter()
                with phases.phase("compute"):
                    # the host's step, then the wait for the card's
                    update, loss = self._update_step(net, ds)
                    done = None
                    if loss.is_cuda:
                        done = torch.cuda.Event()
                        done.record()
                    # the copies start now, behind the step's queued work
                    pending = start_device_get(update)
                    if done is not None:
                        done.synchronize()
                with phases.phase("d2h"):
                    update_host = async_device_get(pending)
                fast = acc.lossless and not acc.has_residual
                if self.overlap:
                    # land step k-1's round, then hand step k's to the thread
                    self._drain_inflight(net, client)
                    fast = acc.lossless and not acc.has_residual
                    if fast:
                        self._apply(net, update)
                    self._pipeline.submit(
                        lambda uh=update_host, fa=fast: self._comms_round(client, acc, uh, fa),
                        label=f"step-{steps}")
                else:
                    with phases.phase("encode"):
                        decoded_own = acc.store_update(update_host)
                    # optimistic local apply; the next adopted pull replaces it
                    self._apply(net, update if fast else decoded_own)
                    with phases.phase("push"):
                        pushed_version, failed_mass = client.push_encoded(acc.last_encoded)
                    if failed_mass is not None:
                        acc.reinject(failed_mass)
                    self._adopt_pushed_version(pushed_version)
                    self._adopt_fresh(net, client, client.pull_if_stale(self.local_version))
                net.score_ = loss
                net.iteration_count += 1
                steps += 1
                for lst in net.listeners:
                    lst.iteration_done(net, net.iteration_count - 1, float(loss))
                if not self.overlap:
                    self._ship_telemetry(client)
                phases.wall((time.perf_counter() - step_t0) * 1e3)
            # the epoch's last round lands before the leave record
            self._drain_inflight(net, client)
        except BaseException as e:
            if self._pipeline is not None:
                try:
                    self._drain_inflight(net, client)
                except Exception as drain_err:
                    log.warning("in-flight comms round failed during error unwind: %s",
                                drain_err)
            # whatever unwinds leaves an ordered leave event, so a later
            # rejoin is attributable
            fr.record("worker_leave", worker=client.worker_id, reason=f"error: {e!r}",
                      steps=steps)
            raise
        fr.record("worker_leave", worker=client.worker_id, reason="completed", steps=steps)
        self._ship_telemetry(client, force=True)
        return net

    executeTraining = execute_training
