"""Sharded parameter-server fleet: N real server nodes and a fan-out client.

Counterpart of ``deeplearning4j_tpu/paramserver/sharded.py``, on the same
wire. One :class:`~.server.ParameterServer` holds the whole flat vector and
serialises every worker's push and pull through one accept loop; this
module splits the vector across real server nodes:

- :class:`ShardedParameterServerGroup` owns N ``ParameterServer`` nodes;
  node ``j`` holds the round-robin slice ``vec[j::N]`` of the global
  vector. Fault injection (``kill``/``restart`` with snapshot restore,
  ``last_snapshot``) and elastic rebalancing (``scale_to(m)`` re-splits
  the merged state, values and residuals, across a new node count).
- :class:`ShardedParameterServerClient` fans every op out per shard in
  parallel (one :class:`~.client.ParameterServerClient` per node, a shared
  :class:`~.client.Fanout`). Pushes split the threshold-encoded update by
  shard (element ``i`` belongs to shard ``i % N`` at intra-shard index
  ``i // N``); pulls ride the proto v3 delta wire (``OP_PULL_DELTA``):
  each client keeps a per-shard shadow (the last reconstructed server
  state) and replays the server's journaled applied-update frames onto it,
  bit-exact with a dense pull, negotiated down to full pulls against v1/v2
  servers.

Partial failure never stalls the fleet: a dead node surfaces per shard as
:class:`~.client.ServerUnavailableError` after that client's retry budget,
opens a down-backoff window for the shard (fail fast, no repeated budget
burn) and records a ``shard_server_down`` flight event
(``shard_server_restored`` when it answers again). Pulls continue on the
surviving shards (a dead shard serves its shadow); a failed push hands the
shard's decoded mass back (``push_encoded``'s second return), which the
training master re-injects into its accumulator's residual.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..monitor import get_flight_recorder, get_registry
from ..monitor.lockwatch import make_lock
from ..parallel.accumulation import (deserialize_encoded, serialize_encoded,
                                     threshold_decode)
from .client import (Fanout, ParameterServerClient, ParameterServerError,
                     ServerUnavailableError)
from .metrics import ParamServerMetrics
from .server import DELTA_FRESH, DELTA_FULL, ParameterServer

log = logging.getLogger(__name__)

__all__ = ["ShardedParameterServerGroup", "ShardedParameterServerClient",
           "parse_addresses", "shard_slice_length"]


def parse_addresses(spec: Union[str, Sequence[str]]) -> List[str]:
    """Normalize a server spec — ``"h:p1,h:p2"`` (Builder-friendly) or a
    list/tuple of addresses — into the address list the fan-out client
    runs over. Order IS the shard assignment: address ``j`` holds shard
    ``j`` (the slice ``vec[j::N]``)."""
    if isinstance(spec, str):
        addrs = [a.strip() for a in spec.split(",") if a.strip()]
    else:
        addrs = [str(a) for a in spec]
    if not addrs:
        raise ValueError("no parameter-server addresses given")
    return addrs


def shard_slice_length(shard: int, n: int, num_shards: int) -> int:
    """Element count of round-robin shard ``shard`` of a length-``n``
    vector (``vec[shard::num_shards]``)."""
    return len(range(int(shard), int(n), int(num_shards)))


class ShardedParameterServerGroup:
    """Own N :class:`~.server.ParameterServer` nodes, one round-robin slice
    each. Every node is a real TCP server on its own port in this process
    (the loopback contract of ``ParameterServer(port=0)``); a deployment
    runs one node per host and hands :class:`ShardedParameterServerClient`
    the address list instead of a group.

    ``threshold``/``journal`` pass through to every node. ``kill(j)``
    stops node ``j`` and returns ``(port, snapshot)`` for a later
    ``restart(j, snapshot)`` (fault injection + the crash-recovery path);
    ``scale_to(m)`` is the elastic-membership seam.
    """

    def __init__(self, num_servers: int = 2, host: str = "127.0.0.1",
                 threshold: float = 0.0, journal: int = 256,
                 ports: Optional[Sequence[int]] = None, tracer=None,
                 fleet=None):
        if num_servers < 1:
            raise ValueError(f"num_servers must be >= 1, got {num_servers}")
        self.host = host
        self.threshold = float(threshold)
        self.journal = int(journal)
        self._tracer = tracer
        self._fleet = fleet
        self._last_snapshots: Dict[int, tuple] = {}
        self.servers: List[ParameterServer] = [
            self._spawn(j, port=(ports[j] if ports else 0))
            for j in range(int(num_servers))]
        get_flight_recorder().record(
            "shard_group_start", servers=self.num_servers,
            addresses=list(self.addresses))

    def _spawn(self, shard: int, port: int = 0,
               restore: Optional[tuple] = None) -> ParameterServer:
        return ParameterServer(
            host=self.host, port=port, threshold=self.threshold,
            journal=self.journal, restore=restore, shard_label=str(shard),
            tracer=self._tracer, fleet=self._fleet)

    # --------------------------------------------------------- addressing
    @property
    def num_servers(self) -> int:
        return len(self.servers)

    @property
    def addresses(self) -> List[str]:
        """Per-shard addresses, shard order (a stopped node keeps its
        address — the restart path rebinds the same port)."""
        return [s.address for s in self.servers]

    @property
    def address(self) -> str:
        """Comma-joined form for
        ``ParameterServerTrainingMaster.Builder(group.address)``."""
        return ",".join(self.addresses)

    # ------------------------------------------------------- fault / state
    def kill(self, shard: int) -> Tuple[int, tuple]:
        """Fault injection: stop node ``shard`` (its clients start seeing
        ``ServerUnavailableError``) and return ``(port, snapshot)`` so
        :meth:`restart` can resurrect it with state and version numbering
        intact."""
        srv = self.servers[shard]
        snap = srv.snapshot()
        port = srv.port
        srv.stop()
        # latch for the control plane's auto-restart path: a policy
        # reacting to shard_server_down asks last_snapshot(shard) instead
        # of threading the kill() return value through the alert loop
        self._last_snapshots[int(shard)] = snap
        get_flight_recorder().record(
            "shard_server_leave", shard=int(shard), address=srv.address,
            reason="killed")
        return port, snap

    def last_snapshot(self, shard: int) -> Optional[tuple]:
        """The most recent snapshot latched for ``shard`` (by
        :meth:`kill`), or None — the control plane's restart-from-latest
        source. A None means a cold restart (empty journal, clients
        resync DELTA_FULL once), which is still correct, just slower."""
        return self._last_snapshots.get(int(shard))

    def restart(self, shard: int, snapshot: Optional[tuple] = None,
                port: Optional[int] = None) -> ParameterServer:
        """Resurrect node ``shard`` on its old port (clients' retry loops
        reconnect transparently; their next delta pull resyncs DELTA_FULL
        once — the restarted journal is empty — then rides frames again)."""
        old = self.servers[shard]
        srv = self._spawn(shard, port=(old.port if port is None else port),
                          restore=snapshot)
        self.servers[shard] = srv
        get_flight_recorder().record(
            "shard_server_join", shard=int(shard), address=srv.address,
            restored=snapshot is not None)
        return srv

    def assemble(self) -> Tuple[List[int], np.ndarray,
                                Optional[np.ndarray]]:
        """(per-node versions, merged full vector, merged residual) from
        live node snapshots — the round-robin reassembly ``scale_to`` and
        group-level checkpointing build on."""
        snaps = [s.snapshot() for s in self.servers]
        n_total = sum(int(vec.size) for _, vec, _ in snaps)
        full = np.zeros(n_total, np.float32)
        res = np.zeros(n_total, np.float32)
        has_res = False
        for j, (_, vec, residual) in enumerate(snaps):
            full[j::self.num_servers] = vec
            if residual is not None:
                res[j::self.num_servers] = residual
                has_res = True
        return ([int(v) for v, _, _ in snaps], full,
                res if has_res else None)

    def scale_to(self, num_servers: int) -> List[str]:
        """Elastic rebalance: re-split the CURRENT merged state (values
        AND server-side residuals) across ``num_servers`` nodes, growing or
        shrinking the fleet. Every surviving node's version continues from
        ``max(old versions) + 1`` so rejoining clients' staleness
        bookkeeping never runs backwards; journals clear (the layout
        changed — no frame replay crosses a reshard), so the first delta
        pull after a rebalance is a full resync per shard. Callers must
        ``remap(...)`` their clients afterwards — in-flight pushes against
        the old layout are the usual async-SGD at-least-once noise. Returns
        the new address list."""
        num_servers = int(num_servers)
        if num_servers < 1:
            raise ValueError(f"num_servers must be >= 1, got {num_servers}")
        if num_servers == self.num_servers:
            return self.addresses
        versions, full, res = self.assemble()
        fr = get_flight_recorder()
        old_n = self.num_servers
        if num_servers > old_n:
            for j in range(old_n, num_servers):
                self.servers.append(self._spawn(j))
                fr.record("shard_server_join", shard=j,
                          address=self.servers[j].address, restored=False)
        else:
            for j in range(old_n - 1, num_servers - 1, -1):
                srv = self.servers.pop(j)
                srv.stop()
                fr.record("shard_server_leave", shard=j,
                          address=srv.address, reason="scale_down")
        ver = max(versions) + 1 if versions else 1
        for j, srv in enumerate(self.servers):
            values = np.ascontiguousarray(full[j::num_servers], np.float32)
            residual = (None if res is None else
                        np.ascontiguousarray(res[j::num_servers],
                                             np.float32))
            # direct state swap under the node's own lock (same-package
            # surgery, equivalent to restart(restore=...) without dropping
            # the port or the live connections)
            with srv._lock:
                srv._store(values)
                srv._residual = residual
                srv._version = ver
                srv._journal.clear()
        fr.record("shard_group_rebalance", servers=num_servers,
                  was=old_n, version=int(ver),
                  addresses=list(self.addresses))
        return self.addresses

    def stop(self):
        for srv in self.servers:
            srv.stop()
        get_flight_recorder().record("shard_group_stop",
                                     servers=self.num_servers)

    close = stop

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


class ShardedParameterServerClient:
    """Fan-out client over N shard servers: the same op surface as
    :class:`~.client.ParameterServerClient` where that makes sense, with
    versions as PER-SHARD lists. All sub-clients share ONE
    :class:`~.metrics.ParamServerMetrics` (so ``metrics.snapshot()``
    aggregates the whole fan-out — a "push" there counts per shard server
    touched) and one :class:`~.client.Fanout` executor.

    ``delta=True`` (default) rides the proto v3 delta wire wherever a
    server advertises it; servers that negotiate < 3 silently fall back to
    version-check + full pulls per shard. ``down_backoff`` is the fail-fast
    window after a shard exhausts its retry budget.
    """

    def __init__(self, addresses: Union[str, Sequence[str]],
                 staleness: int = 0, delta: bool = True,
                 max_retries: int = 5, backoff: float = 0.05,
                 backoff_max: float = 2.0, jitter: float = 0.25,
                 timeout: float = 30.0, pool_size: int = 2,
                 worker_id: Optional[str] = None, tracer=None,
                 down_backoff: float = 1.0,
                 metrics: Optional[ParamServerMetrics] = None,
                 push_delay_s: float = 0.0):
        # join, rejoin and remap: the fleet's shared kernel-library cache
        from ..compilecache.cache import maybe_enable
        maybe_enable()
        self.addresses = parse_addresses(addresses)
        self.address = ",".join(self.addresses)
        self.staleness = int(staleness)
        self.delta = bool(delta)
        self.down_backoff = float(down_backoff)
        self.metrics = metrics or ParamServerMetrics(role="client")
        self._client_kw = dict(
            staleness=staleness, max_retries=max_retries, backoff=backoff,
            backoff_max=backoff_max, jitter=jitter, timeout=timeout,
            pool_size=pool_size, push_delay_s=push_delay_s)
        self.clients = [ParameterServerClient(
            a, metrics=self.metrics, worker_id=worker_id, tracer=tracer,
            shard=j, **self._client_kw)
            for j, a in enumerate(self.addresses)]
        self.worker_id = self.clients[0].worker_id
        self.tracer = self.clients[0].tracer
        self._fan = Fanout(min(2 * self.num_servers, 16))
        self._state_lock = make_lock("ShardedParameterServerClient._state_lock")
        self._shadow: List[Optional[np.ndarray]] = [None] * self.num_servers
        #: per-shard version of the shadow (the server state the client
        #: can reconstruct) — distinct from the MASTER's local_version,
        #: which may run ahead under count_own_pushes=False
        self.versions: List[int] = [0] * self.num_servers
        self._down_until: List[float] = [0.0] * self.num_servers
        self._thresholds: List[Optional[float]] = [None] * self.num_servers
        self._n = 0

    # ------------------------------------------------------------ plumbing
    @property
    def num_servers(self) -> int:
        return len(self.clients)

    def _skip_down(self, shard: int) -> bool:
        """True while ``shard`` sits inside its down-backoff window — ops
        fail fast instead of re-burning the retry budget every step."""
        with self._state_lock:
            until = self._down_until[shard]
        return until > 0.0 and time.monotonic() < until

    def _count_unavailable(self, shard: int):
        get_registry().counter(
            "paramserver_shard_unavailable_total",
            "per-shard ops lost to a down shard server", role="client",
            shard=str(shard)).inc()

    def _mark_down(self, shard: int, err: BaseException):
        now = time.monotonic()
        with self._state_lock:
            first = self._down_until[shard] <= 0.0
            self._down_until[shard] = now + self.down_backoff
        if first:
            get_flight_recorder().record(
                "shard_server_down", worker=self.worker_id,
                shard=int(shard), server=self.addresses[shard],
                error=str(err))
            log.warning("shard server %d (%s) unavailable: %s",
                        shard, self.addresses[shard], err)
        self._count_unavailable(shard)

    def _mark_up(self, shard: int):
        with self._state_lock:
            was_down = self._down_until[shard] > 0.0
            self._down_until[shard] = 0.0
        if was_down:
            get_flight_recorder().record(
                "shard_server_restored", worker=self.worker_id,
                shard=int(shard), server=self.addresses[shard])
            log.info("shard server %d (%s) reachable again", shard,
                     self.addresses[shard])

    def _per_shard(self, fn, shards: Optional[Sequence[int]] = None,
                   ignore_backoff: bool = False) -> Dict[int, object]:
        """Run ``fn(shard, client)`` for every (or the given) shard on the
        fan-out executor. Returns ``{shard: result-or-
        ServerUnavailableError}`` — unavailability is a per-shard VALUE
        (the partial-failure contract), while typed server rejections
        (:class:`ParameterServerError`) raise through: retrying or
        degrading can't fix a protocol error. ``ignore_backoff`` bypasses
        the down-window fail-fast (the join/seed path: a deliberate
        reconnect right after a restart must actually try the wire)."""
        shards = (list(range(self.num_servers)) if shards is None
                  else list(shards))

        def call(j: int):
            if not ignore_backoff and self._skip_down(j):
                self._count_unavailable(j)  # a lost op, just a cheap one
                return ServerUnavailableError(
                    f"shard {j} ({self.addresses[j]}) in its down-backoff "
                    f"window")
            try:
                out = fn(j, self.clients[j])
            except ServerUnavailableError as e:
                self._mark_down(j, e)
                return e
            self._mark_up(j)
            return out

        results = self._fan.run([(lambda j=j: call(j)) for j in shards])
        return dict(zip(shards, results))

    def _server_threshold(self, shard: int) -> float:
        """The node's server-side residual threshold (cached after the
        first successful stats). A residual-merging node (> 0) must see
        EVERY push — even an empty sub-frame — so its residual rule runs
        on the same rounds a dense single server's would. The probe obeys
        the same down-backoff discipline as every other per-shard op: a
        down node answers 0.0 fast (skip the empty frame — degraded
        anyway) instead of burning the retry budget each push, and the
        probe failure itself opens the down window."""
        with self._state_lock:
            thr = self._thresholds[shard]
        if thr is not None:
            return thr
        if self._skip_down(shard):
            return 0.0
        try:
            thr = float(self.clients[shard].stats().get("threshold", 0.0))
        except ServerUnavailableError as e:
            self._mark_down(shard, e)
            return 0.0  # uncached: re-probe once the node answers
        except (ConnectionError, ParameterServerError) as e:
            log.debug("threshold probe for shard %d failed: %s", shard, e)
            return 0.0
        self._mark_up(shard)
        with self._state_lock:
            self._thresholds[shard] = thr
        return thr

    def negotiate(self) -> int:
        """Fleet protocol floor: the minimum negotiated version across
        reachable shard servers (1 when none answer)."""
        res = self._per_shard(lambda j, c: c.negotiate())
        versions = [v for v in res.values() if not isinstance(v, Exception)]
        return min(versions) if versions else 1

    # ----------------------------------------------------------------- ops
    def init_params(self, vec: np.ndarray) -> Tuple[List[int], bool]:
        """Seed every shard server iff it holds nothing yet (the join
        path). Returns ``(versions, created)``; ``created`` is True only
        when EVERY shard was seeded by this call — any pre-seeded shard
        means the caller should pull the merged state (a concurrent-join
        race can leave a mixed seed behind; the pull reconciles it, and
        async SGD absorbs the one-step noise). A down shard here raises:
        a partial seed would strand inconsistent state."""
        vec = np.ascontiguousarray(vec, np.float32)
        self._n = int(vec.size)
        N = self.num_servers
        res = self._per_shard(lambda j, c: c.init_params(vec[j::N]),
                              ignore_backoff=True)
        versions: List[int] = []
        created: List[bool] = []
        for j in range(N):
            out = res[j]
            if isinstance(out, Exception):
                raise ServerUnavailableError(
                    f"shard {j} ({self.addresses[j]}) unavailable during "
                    f"init: {out}") from out
            v, flag = out
            versions.append(int(v))
            created.append(bool(flag))
        with self._state_lock:
            for j in range(N):
                # the shadow is only trustworthy where WE seeded; a
                # pre-seeded shard's shadow arrives with the caller's pull
                self._shadow[j] = (np.array(vec[j::N], np.float32)
                                   if created[j] else None)
                self.versions[j] = versions[j] if created[j] else 0
        if any(created) and not all(created):
            log.warning("mixed init across shard servers (a concurrent "
                        "worker raced the seed on %d/%d shards); pulling "
                        "the merged state reconciles it",
                        sum(created), N)
        return versions, all(created)

    def set_params(self, vec: np.ndarray) -> List[int]:
        """Unconditional overwrite of every shard. A down shard raises —
        like init, a partial overwrite would strand mixed state."""
        vec = np.ascontiguousarray(vec, np.float32)
        self._n = int(vec.size)
        N = self.num_servers
        res = self._per_shard(lambda j, c: c.set_params(vec[j::N]),
                              ignore_backoff=True)
        versions: List[int] = []
        for j in range(N):
            out = res[j]
            if isinstance(out, Exception):
                raise ServerUnavailableError(
                    f"shard {j} ({self.addresses[j]}) unavailable during "
                    f"set_params: {out}") from out
            versions.append(int(out))
        with self._state_lock:
            for j in range(N):
                self._shadow[j] = np.array(vec[j::N], np.float32)
                self.versions[j] = versions[j]
        return versions

    def push_encoded(self, encoded
                     ) -> Tuple[List[Optional[int]], Optional[np.ndarray]]:
        """Split one threshold-encoded full-vector update by shard (element
        ``i`` → shard ``i % N`` at intra-shard index ``i // N``) and push
        the sub-frames in parallel. Returns ``(versions, failed_mass)``:

        - ``versions[j]`` — node ``j``'s version after its push, ``None``
          when nothing was sent there (empty sub-frame against a
          non-residual server) or the node was down;
        - ``failed_mass`` — the decoded update the down shard(s) never
          received, as a dense full-length vector, or ``None``. Callers
          feed it back into their accumulator residual
          (``EncodedGradientsAccumulator.reinject``) so the mass re-rides
          the next encode instead of vanishing.
        """
        idx, signs, thr, n = encoded
        idx = np.ascontiguousarray(idx, np.int32)
        signs = np.asarray(signs)
        # float32 "signs" are an exact frame (lossless accumulator) and
        # must keep their dtype through the split — serialize_encoded
        # branches on it
        exact = signs.dtype == np.float32
        signs = np.ascontiguousarray(signs,
                                     np.float32 if exact else np.int8)
        n = int(n)
        self._n = n
        N = self.num_servers
        owner = idx % N
        frames: Dict[int, bytes] = {}
        masks: Dict[int, np.ndarray] = {}
        for j in range(N):
            m = owner == j
            if not m.any() and self._server_threshold(j) <= 0.0:
                # nothing for this shard and no server-side residual rule
                # to run — skip the round trip (and the version bump)
                continue
            masks[j] = m
            frames[j] = serialize_encoded(
                ((idx[m] // N).astype(np.int32), signs[m], thr,
                 shard_slice_length(j, n, N)))
        if not frames:
            return [None] * N, None
        res = self._per_shard(lambda j, c: c.push_update(frames[j]),
                              shards=sorted(frames))
        versions: List[Optional[int]] = [None] * N
        failed_mass: Optional[np.ndarray] = None
        for j, out in res.items():
            if isinstance(out, Exception):
                m = masks[j]
                if m.any():
                    if failed_mass is None:
                        failed_mass = np.zeros(n, np.float32)
                    # what decode(frame) would have applied: ±thr at the
                    # encoded indices (the raw values for an exact frame) —
                    # hand it back for residual reinjection
                    failed_mass[idx[m]] += (
                        signs[m] if exact
                        else signs[m].astype(np.float32) * np.float32(thr))
            else:
                versions[j] = int(out)
        return versions, failed_mass

    def pull(self) -> Tuple[List[int], np.ndarray]:
        """Full merged pull: every shard in parallel, reassembled. A down
        shard serves its shadow (last reconstructed state — the bounded-
        staleness degraded read); only a down shard with NO shadow raises,
        because then no coherent vector exists to hand back."""
        N = self.num_servers
        res = self._per_shard(lambda j, c: c.pull())
        parts: List[Optional[np.ndarray]] = [None] * N
        versions = [0] * N
        for j in range(N):
            out = res[j]
            if isinstance(out, Exception):
                with self._state_lock:
                    shadow = self._shadow[j]
                    ver = self.versions[j]
                if shadow is None:
                    raise ServerUnavailableError(
                        f"shard {j} ({self.addresses[j]}) unavailable and "
                        f"no local copy exists yet: {out}") from out
                parts[j], versions[j] = shadow, ver
            else:
                versions[j] = int(out[0])
                part = np.array(out[1], np.float32)
                parts[j] = part
                with self._state_lock:
                    self._shadow[j] = part
                    self.versions[j] = versions[j]
        n = sum(int(p.size) for p in parts)
        vec = np.empty(n, np.float32)
        for j in range(N):
            vec[j::N] = parts[j]
        self._n = n
        return versions, vec

    def _pull_shard(self, j: int, client: ParameterServerClient,
                    since: int) -> Tuple[int, Optional[np.ndarray]]:
        """One shard's bounded-staleness resync. Returns
        ``(server_version, values-or-None)`` — None means within the
        staleness bound. The delta wire needs a shadow base: frames replay
        from the SHADOW's version, while the staleness decision runs
        against the caller's ``since`` (which may be ahead of the shadow
        under count_own_pushes=False), so the slack sent to the server is
        ``staleness + (since - shadow_version)``."""
        since = int(since)
        with self._state_lock:
            shadow = self._shadow[j]
            base_ver = self.versions[j]
        if self.delta and shadow is not None and client.negotiate() >= 3:
            slack = self.staleness + max(since - base_ver, 0)
            ver, mode, body = client.pull_delta(base_ver, slack)
            if mode == DELTA_FRESH:
                return ver, None
            if mode == DELTA_FULL:
                part = np.array(body, np.float32)
            else:
                part = shadow.copy()
                for frame in body:
                    fi, fs, fthr, fn = deserialize_encoded(frame)
                    if fn != part.size:
                        raise ParameterServerError(
                            f"shard {j} delta frame length {fn} != local "
                            f"copy {part.size}")
                    part -= threshold_decode(fi, fs, fthr, (fn,))
            with self._state_lock:
                self._shadow[j] = part
                self.versions[j] = int(ver)
            return int(ver), part.copy()
        # v1/v2 fallback (or no shadow yet): version round trip + full pull
        ver, _ = client.server_version()
        if since <= ver and ver - since <= self.staleness \
                and shadow is not None:
            return ver, None
        ver, part = client.pull()
        part = np.array(part, np.float32)
        with self._state_lock:
            self._shadow[j] = part
            self.versions[j] = int(ver)
        return int(ver), part.copy()

    def pull_if_stale(self, local_versions: Sequence[int]
                      ) -> Optional[Tuple[List[int],
                                          Dict[int, np.ndarray]]]:
        """Per-shard bounded staleness: resync ONLY the shards whose server
        ran more than ``staleness`` versions past ``local_versions`` (one
        delta round trip each, in parallel). Returns ``None`` when every
        reachable shard is within the bound; ``(new_versions, vector)``
        (a full assembled ndarray) when EVERY shard refreshed — the
        staleness=0 hot path, sparing the caller a full flatten of its
        local state; else ``(new_versions, {shard: values})`` — the caller
        scatters only the refreshed slices (``vec[j::N] = values``),
        keeping its own optimistic local state on the fresh ones. Down
        shards are skipped (their staleness keeps growing — the survivors
        never stall)."""
        local = [int(v) for v in local_versions]
        if len(local) != self.num_servers:
            raise ValueError(
                f"{len(local)} local versions for {self.num_servers} "
                f"shard servers (remap out of sync?)")
        res = self._per_shard(
            lambda j, c: self._pull_shard(j, c, local[j]))
        new_versions = list(local)
        changed: Dict[int, np.ndarray] = {}
        reg = get_registry()
        for j in range(self.num_servers):
            out = res[j]
            if isinstance(out, Exception):
                continue  # down shard: survivors carry on
            ver, values = out
            reg.gauge("paramserver_shard_staleness",
                      "versions the local copy trails the shard server by",
                      role="client", shard=str(j)).set(
                          max(ver - local[j], 0))
            if values is None:
                self.metrics.add("staleness_hits")
                continue
            changed[j] = values
            new_versions[j] = ver
        if not changed:
            return None
        if len(changed) == self.num_servers:
            n = sum(int(v.size) for v in changed.values())
            vec = np.empty(n, np.float32)
            for j, values in changed.items():
                vec[j::self.num_servers] = values
            return new_versions, vec
        return new_versions, changed

    def server_version(self) -> Tuple[List[int], int]:
        """Per-shard versions + total element count (parallel)."""
        res = self._per_shard(lambda j, c: c.server_version())
        versions, total = [], 0
        for j in range(self.num_servers):
            out = res[j]
            if isinstance(out, Exception):
                raise out
            versions.append(int(out[0]))
            total += int(out[1])
        return versions, total

    def stats(self) -> List[dict]:
        """Per-shard OP_STATS snapshots; a down shard's slot carries
        ``{"error": ...}`` instead (partial visibility beats none)."""
        res = self._per_shard(lambda j, c: c.stats())
        return [res[j] if not isinstance(res[j], Exception)
                else {"error": str(res[j]), "shard": str(j)}
                for j in range(self.num_servers)]

    def send_telemetry(self, registry=None, tracer=None,
                       flight_events=None) -> bool:
        """Fleet telemetry ships to shard server 0 — the group's
        aggregation point (its process serves ``GET /fleet``)."""
        return self.clients[0].send_telemetry(
            registry=registry, tracer=tracer, flight_events=flight_events)

    # ------------------------------------------------------------- elastic
    def remap(self, addresses: Union[str, Sequence[str]]):
        """Elastic membership: rebind to a new shard-server set (after a
        group ``scale_to`` or an address change). Shadows and versions
        reset — the next pull is a full per-shard resync against the new
        layout. Flight event ``client_remap`` closes the audit trail the
        group's join/leave events open."""
        addrs = parse_addresses(addresses)
        old_clients = self.clients
        self.clients = [ParameterServerClient(
            a, metrics=self.metrics, worker_id=self.worker_id,
            tracer=self.tracer, shard=j, **self._client_kw)
            for j, a in enumerate(addrs)]
        self.addresses = addrs
        self.address = ",".join(addrs)
        with self._state_lock:
            self._shadow = [None] * len(addrs)
            self.versions = [0] * len(addrs)
            self._down_until = [0.0] * len(addrs)
            self._thresholds = [None] * len(addrs)
        for c in old_clients:
            c.close()
        get_flight_recorder().record(
            "client_remap", worker=self.worker_id, servers=len(addrs),
            addresses=list(addrs))

    def close(self):
        for c in self.clients:
            c.close()
        self._fan.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
