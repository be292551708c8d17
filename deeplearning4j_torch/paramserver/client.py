"""Fault-tolerant parameter-server client.

Counterpart of ``deeplearning4j_tpu/paramserver/client.py`` (the client
role of the reference's ``VoidParameterServer``): every op reconnects and
retries with exponential backoff and jitter on socket errors, and when the
retry budget is spent the caller gets a :class:`ServerUnavailableError`
naming the server and the attempts (and the flight recorder a
``retry_exhausted`` event); a request the server rejects raises
:class:`ParameterServerError` and is not retried. The frames are the JAX
client's, byte for byte.

Bounded staleness: :meth:`ParameterServerClient.pull_if_stale` asks for the
server's version first (a 16-byte round trip) and skips the transfer while
the local copy is within ``staleness`` versions. :class:`Fanout` runs
per-shard requests concurrently (this client's ``pull_sharded`` and the
sharded fleet's client, ``sharded.py``).

Monitor planes, as the JAX client's: ``ps/push``, ``ps/pull`` and
``ps/pull_delta`` spans whose context rides the wire (``FLAG_TRACE``) to a
proto v2+ server, ``paramserver_wire_bytes_total{role="client",op=,shard=,
direction=}`` and the :class:`~.metrics.ParamServerMetrics` series in the
registry, every op's outcome in the process health, and
:meth:`ParameterServerClient.send_telemetry` shipping the registry dump,
the newest trace events and flight events.
"""
from __future__ import annotations

import json
import logging
import os
import random
import socket
import struct
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..monitor import (get_flight_recorder, get_health, get_registry,
                       get_tracer)
from ..monitor.lockwatch import make_lock
from ..parallel.accumulation import serialize_encoded
from ..parallel.transport import send_frame, recv_frame
from .metrics import ParamServerMetrics
from .server import (OP_INIT, OP_SET, OP_PUSH, OP_PULL, OP_VERSION, OP_STATS,
                     OP_TELEMETRY, OP_PULL_DELTA, FLAG_TRACE, OP_MASK,
                     OP_NAMES, ST_OK, DELTA_FRESH, DELTA_FRAMES, DELTA_FULL)

log = logging.getLogger(__name__)

__all__ = ["ParameterServerClient", "ServerUnavailableError",
           "ParameterServerError", "Fanout"]

#: newest trace events shipped per telemetry report — a snapshot window,
#: not the whole ring buffer (reports are meant to stay "compact")
TELEMETRY_TRACE_EVENTS = 512


class ServerUnavailableError(ConnectionError):
    """The parameter server stayed unreachable through the whole retry
    budget. Catchable as ``ConnectionError`` but carries the diagnosis
    (address, attempts) instead of a bare socket message."""


class ParameterServerError(RuntimeError):
    """The server answered, but rejected the request (bad frame, length
    mismatch, pull-before-init). Not retried — retrying can't fix it."""


class Fanout:
    """Tiny shared fan-out runner: execute a list of thunks concurrently
    and return their results in submission order. THE one parallel-request
    code path — :meth:`ParameterServerClient.pull_sharded` (per-shard pulls
    against a single server, over its connection pool) and
    :class:`~.sharded.ShardedParameterServerClient` (per-shard-server
    fan-out) both ride it, so the two paths cannot diverge.

    An exception from any thunk re-raises after every thunk has resolved
    (each is an independent request whose effect stands either way);
    callers that need per-shard error-as-value semantics wrap their thunks
    — see ``ShardedParameterServerClient._per_shard``. The first thunk
    runs inline on the calling thread, so the 1-server/1-shard case pays
    no thread overhead."""

    def __init__(self, max_workers: int):
        self.max_workers = max(1, int(max_workers))
        self._lock = make_lock("Fanout._lock")
        self._exec: Optional[ThreadPoolExecutor] = None

    def _executor(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._exec is None:
                self._exec = ThreadPoolExecutor(
                    max_workers=self.max_workers,
                    thread_name_prefix="psfanout")
            return self._exec

    def run(self, thunks: Sequence[Callable]) -> List[object]:
        def call(t: Callable):
            try:
                return False, t()
            except Exception as e:
                return True, e
        # the FIRST thunk runs inline on the calling thread: it would only
        # block on its future anyway, and the saved dispatch+wakeup is a
        # measurable slice of a small delta round trip
        futures = [self._executor().submit(call, t) for t in thunks[1:]]
        results = [call(thunks[0])] + [f.result() for f in futures]
        out: List[object] = []
        for raised, value in results:
            if raised:
                raise value
            out.append(value)
        return out

    def close(self):
        with self._lock:
            ex, self._exec = self._exec, None
        if ex is not None:
            ex.shutdown(wait=False)


class ParameterServerClient:
    """Pooled TCP connections to a :class:`~.server.ParameterServer` (of
    either package), (re)established lazily per request.

    ``staleness``: version slack for :meth:`pull_if_stale`.
    ``max_retries``: reconnect attempts per op before
    :class:`ServerUnavailableError`; backoff sleeps are
    ``backoff * 2^attempt`` (capped at ``backoff_max``) with ±``jitter``
    randomization so rejoining clients don't thundering-herd the server.
    ``pool_size``: idle connections kept (>= 2 lets concurrent requests —
    :meth:`pull_sharded`, the fan-out client — genuinely parallelize; extra
    concurrent requests open temporary sockets that close on return).
    ``shard``: which shard of a fleet this client talks to — metrics
    labeling only (``paramserver_wire_bytes_total{shard=}``).
    ``push_delay_s``: artificial per-push latency added before the wire
    round — a fault-injection dial for benchmarks/tests that need a slow
    transport (the overlap bench drives sync vs overlap against it).
    """

    def __init__(self, address: str, staleness: int = 0,
                 max_retries: int = 5, backoff: float = 0.05,
                 backoff_max: float = 2.0, jitter: float = 0.25,
                 timeout: float = 30.0,
                 metrics: Optional[ParamServerMetrics] = None,
                 worker_id: Optional[str] = None, tracer=None,
                 pool_size: int = 1, shard: Optional[int] = None,
                 push_delay_s: float = 0.0):
        host, _, port = address.rpartition(":")
        self.host, self.port = host, int(port)
        self.address = address
        self.staleness = int(staleness)
        self.max_retries = int(max_retries)
        self.backoff = float(backoff)
        self.backoff_max = float(backoff_max)
        self.jitter = float(jitter)
        self.timeout = float(timeout)
        self.pool_size = max(1, int(pool_size))
        self.push_delay_s = float(push_delay_s)
        self.shard_label = "0" if shard is None else str(shard)
        self.metrics = metrics or ParamServerMetrics()
        #: fleet identity this client reports telemetry under; spans land
        #: in ``tracer`` (default: the process-global one) so an in-process
        #: multi-worker test can give each worker its own trace buffer
        self.worker_id = worker_id or f"{socket.gethostname()}:{os.getpid()}"
        self.tracer = tracer if tracer is not None else get_tracer()
        #: negotiated server protocol version — None until the first
        #: OP_STATS answer; 1 for pre-OP_TELEMETRY servers (no flag bits,
        #: no telemetry), >= 2 to use the v2 extensions, >= 3 for the
        #: delta-pull wire
        self._proto: Optional[int] = None
        self._pool: List[socket.socket] = []
        self._pool_lock = make_lock("ParameterServerClient._pool_lock")
        self._fan: Optional[Fanout] = None
        self._rand = random.Random()

    # ---------------------------------------------------------- connection
    @property
    def _sock(self) -> Optional[socket.socket]:
        """The first idle pooled connection (None when none is open) —
        kept for the fault-injection idiom ``client._sock.close()`` that
        simulates a transient network blip."""
        with self._pool_lock:
            return self._pool[0] if self._pool else None

    def _checkout(self) -> socket.socket:
        with self._pool_lock:
            if self._pool:
                return self._pool.pop()
        # connect outside the lock: a slow connect must not stall the other
        # pool users. The caller owns the socket: _checkin pools or closes
        # it, and every _request error path closes it
        s = socket.create_connection((self.host, self.port), timeout=self.timeout)
        try:
            # delta frames and version checks are tiny — Nagle coalescing
            # would add a delayed-ACK round to exactly the ops the sharded
            # wire made small
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        return s

    def _checkin(self, s: socket.socket):
        with self._pool_lock:
            if len(self._pool) < self.pool_size:
                self._pool.append(s)
                return
        try:
            s.close()
        except OSError:
            pass

    def _drop_sock(self):
        """Close every idle pooled connection (sockets checked out by
        in-flight requests close themselves on their own error paths)."""
        with self._pool_lock:
            socks, self._pool = self._pool, []
        for s in socks:
            try:
                s.close()
            except OSError:
                pass

    def _fanout(self) -> Fanout:
        if self._fan is None:
            self._fan = Fanout(max(self.pool_size, 2))
        return self._fan

    def _record_wire(self, op: int, n_tx: int, n_rx: int):
        """Client half of ``paramserver_wire_bytes_total{op=,shard=,
        direction=}`` — tx is the request frame, rx the response frame."""
        name = OP_NAMES.get(op & OP_MASK)
        if name is None:
            return
        reg = get_registry()
        reg.counter("paramserver_wire_bytes_total",
                    "bytes on the parameter-server wire", role="client",
                    op=name, shard=self.shard_label,
                    direction="tx").inc(n_tx)
        reg.counter("paramserver_wire_bytes_total",
                    "bytes on the parameter-server wire", role="client",
                    op=name, shard=self.shard_label,
                    direction="rx").inc(n_rx)

    def _request(self, op: int, payload: bytes = b"") -> bytes:
        """One request/response round with reconnect-retry-backoff.
        Thread-safe: concurrent requests each check a connection out of the
        pool (or open a temporary one), so per-shard parallel pulls and the
        fan-out client can overlap rounds on one client."""
        last: Optional[BaseException] = None
        for attempt in range(self.max_retries + 1):
            if attempt:
                self.metrics.add("retries")
                delay = min(self.backoff * (2 ** (attempt - 1)),
                            self.backoff_max)
                delay *= 1.0 + self.jitter * (2 * self._rand.random() - 1)
                time.sleep(max(delay, 0.0))
            s: Optional[socket.socket] = None
            try:
                s = self._checkout()
                send_frame(s, bytes([op]) + payload)
                resp = recv_frame(s)
                if resp is None or not resp:
                    raise ConnectionError("server closed the connection")
                self._checkin(s)
                s = None
                self._record_wire(op, 1 + len(payload), len(resp))
                if resp[0] != ST_OK:
                    raise ParameterServerError(
                        resp[1:].decode("utf-8", "replace"))
                get_health().record_ps_ok()
                return resp[1:]
            except (OSError, socket.timeout) as e:  # incl. ConnectionError
                last = e
                if s is not None:
                    try:
                        s.close()
                    except OSError:
                        pass
                # the blip that killed this socket likely killed its pool
                # siblings too — drop the idle ones so the retry reconnects
                self._drop_sock()
        self.metrics.add("errors")
        err = ServerUnavailableError(
            f"parameter server {self.address} unavailable after "
            f"{self.max_retries + 1} attempts: {last}")
        get_health().record_ps_error(str(err))
        get_flight_recorder().record(
            "retry_exhausted", worker=self.worker_id, server=self.address,
            attempts=self.max_retries + 1, error=str(last))
        raise err from last

    # ------------------------------------------------------ proto v2 seam
    def negotiate(self) -> int:
        """The server's protocol version, negotiated once per client via
        OP_STATS (``proto`` key; absent on v1 servers → 1). Flag bits and
        OP_TELEMETRY are only ever used after this answers >= 2, which is
        what keeps a v2 client safe against a v1 server."""
        if self._proto is None:
            try:
                self._proto = int(self.stats().get("proto", 1))
            except ParameterServerError as e:
                # the server answered but can't do stats: oldest possible
                # peer — stay on the v1 wire forms
                log.debug("proto negotiation fell back to v1: %s", e)
                self._proto = 1
        return self._proto

    def _traced(self, op: int, payload: bytes, ctx) -> Tuple[int, bytes]:
        """Attach the active span context to an op when the server speaks
        proto v2: sets FLAG_TRACE and prefixes the 16-byte context header
        the server parses in ``_serve_conn``."""
        if ctx is None or self.negotiate() < 2:
            return op, payload
        return (op | FLAG_TRACE,
                struct.pack("<QQ", ctx.trace_id, ctx.span_id) + payload)

    # ----------------------------------------------------------------- ops
    def init_params(self, vec: np.ndarray) -> Tuple[int, bool]:
        """Initialize the server iff it holds nothing yet. Returns
        ``(version, created)`` — ``created=False`` means another worker got
        there first (or this is a rejoin) and the caller should pull."""
        out = self._request(
            OP_INIT, np.ascontiguousarray(vec, np.float32).tobytes())
        version, created = struct.unpack("<qB", out)
        return version, bool(created)

    def set_params(self, vec: np.ndarray) -> int:
        """Unconditional overwrite (checkpoint restore / debug). Returns the
        new version."""
        out = self._request(
            OP_SET, np.ascontiguousarray(vec, np.float32).tobytes())
        return struct.unpack("<q", out)[0]

    def push_update(self, frame: bytes) -> int:
        """Push one threshold-encoded update frame
        (``EncodedGradientsAccumulator.serialize_last()`` wire form).
        Returns the server version after application.

        Delivery is at-least-once: a connection that dies between the send
        and the response is retried, so a push can apply twice across a
        server blip — the async-SGD trade (a quantized update re-applied is
        noise of the same scale the staleness bound already tolerates); use
        ``set_params`` for state that must be exact."""
        t0 = time.perf_counter()
        with self.tracer.span("ps/push", cat="paramserver",
                              bytes=len(frame)) as ctx:
            if self.push_delay_s > 0.0:
                time.sleep(self.push_delay_s)  # injected transport latency
            op, payload = self._traced(OP_PUSH, frame, ctx)
            out = self._request(op, payload)
        self.metrics.record_push((time.perf_counter() - t0) * 1e3,
                                 len(frame))
        return struct.unpack("<q", out)[0]

    push = push_update

    def push_encoded(self, encoded) -> Tuple[int, Optional[np.ndarray]]:
        """Push a raw ``(idx, signs, threshold, n)`` encoding. Returns
        ``(version, failed_mass)`` — always ``(v, None)`` here; the sharded
        fan-out client shares this signature and uses the second slot to
        hand un-deliverable shard mass back to the caller's accumulator."""
        return self.push_update(serialize_encoded(encoded)), None

    def pull_delta(self, since: int, slack: int = 0):
        """Proto v3 delta pull: ONE round trip answering
        ``(version, mode, body)`` —

        - ``DELTA_FRESH``: ``body None`` — the server is within ``slack``
          versions of ``since``; keep the local copy.
        - ``DELTA_FRAMES``: ``body`` is the list of APPLIED update frames
          for ``since+1..version`` in application order; replaying
          ``p -= decode(frame)`` on the local copy at ``since``
          reconstructs the server state bit-exactly.
        - ``DELTA_FULL``: ``body`` is the full f32 value vector (journal
          evicted / restart / SET barrier / caller ahead of the server).

        Callers must negotiate proto >= 3 first (the sharded client does);
        a v1/v2 server rejects the op as unknown."""
        t0 = time.perf_counter()
        with self.tracer.span("ps/pull_delta", cat="paramserver",
                              since=int(since)) as ctx:
            op, payload = self._traced(
                OP_PULL_DELTA, struct.pack("<qi", int(since), int(slack)),
                ctx)
            out = self._request(op, payload)
        version, mode = struct.unpack("<qB", out[:9])
        body = out[9:]
        if mode == DELTA_FRESH:
            return version, mode, None
        self.metrics.record_pull((time.perf_counter() - t0) * 1e3,
                                 len(body))
        if mode == DELTA_FULL:
            return version, mode, np.frombuffer(body, np.float32)
        if mode != DELTA_FRAMES:
            raise ParameterServerError(f"unknown delta mode {mode}")
        (count,) = struct.unpack_from("<I", body)
        frames, off = [], 4
        for _ in range(count):
            (ln,) = struct.unpack_from("<I", body, off)
            off += 4
            frames.append(bytes(body[off:off + ln]))
            off += ln
        if off != len(body):
            raise ParameterServerError(
                f"delta body length mismatch ({off} parsed, "
                f"{len(body)} received)")
        return version, mode, frames

    def pull_sharded(self, num_shards: Optional[int] = None
                     ) -> Tuple[int, np.ndarray]:
        """Pull every virtual shard of ONE server in PARALLEL over the
        connection pool and reassemble the round-robin layout — the
        single-server half of the fan-out code path (:class:`Fanout`).
        Returns ``(version, vector)`` with ``version`` the max seen across
        shards; like sequential per-shard pulls, concurrent pushes can
        tear the snapshot across shard boundaries (the async-PS trade)."""
        if num_shards is None:
            num_shards = int(self.stats().get("num_shards", 1))
        results = self._fanout().run(
            [(lambda s=s: self.pull(shard=s)) for s in range(num_shards)])
        n = sum(part.size for _, part in results)
        vec = np.empty(n, np.float32)
        for s, (_, part) in enumerate(results):
            vec[s::num_shards] = part
        return max(v for v, _ in results), vec

    def pull(self, shard: int = -1) -> Tuple[int, np.ndarray]:
        """Current parameters (``shard=-1``: full vector; ``shard=s``: the
        round-robin slice ``s::num_shards``), stamped with the server
        version they correspond to."""
        t0 = time.perf_counter()
        with self.tracer.span("ps/pull", cat="paramserver",
                              shard=int(shard)) as ctx:
            op, payload = self._traced(OP_PULL,
                                       struct.pack("<i", int(shard)), ctx)
            out = self._request(op, payload)
        self.metrics.record_pull((time.perf_counter() - t0) * 1e3,
                                 len(out) - 12)
        version, _shard = struct.unpack("<qi", out[:12])
        return version, np.frombuffer(out[12:], np.float32)

    def pull_if_stale(self, local_version: int
                      ) -> Optional[Tuple[int, np.ndarray]]:
        """Bounded-staleness pull: fetch only when the server has advanced
        more than ``staleness`` versions past ``local_version`` — otherwise
        skip the transfer (counted as a ``staleness_hits`` metric) and
        return None."""
        server_version, _ = self.server_version()
        if server_version - int(local_version) <= self.staleness:
            self.metrics.add("staleness_hits")
            return None
        return self.pull()

    def server_version(self) -> Tuple[int, int]:
        """(version, param count) without transferring values."""
        out = self._request(OP_VERSION)
        return struct.unpack("<qq", out)

    def stats(self) -> dict:
        """Server-side metrics snapshot (counters, latency histograms,
        version, size; proto v2 adds ``proto``, ``uptime_s`` and per-op
        ``ops`` request counters)."""
        return json.loads(self._request(OP_STATS).decode("utf-8"))

    def send_telemetry(self, registry=None, tracer=None,
                       flight_events=None) -> bool:
        """Ship one fleet telemetry report over OP_TELEMETRY: this
        worker's registry dump, the newest trace events, and (optionally)
        flight-recorder events — the feed behind the server's ``GET
        /fleet`` and merged-trace views. Returns False without touching
        the wire when the server predates the extension (proto < 2)."""
        if self.negotiate() < 2:
            return False
        reg = registry if registry is not None else get_registry()
        tr = tracer if tracer is not None else self.tracer
        report = {"worker": self.worker_id, "registry": reg.dump(),
                  "trace_events": tr.events()[-TELEMETRY_TRACE_EVENTS:]}
        if flight_events is not None:
            report["flight_events"] = list(flight_events)
        # default=repr: flight-recorder fields may be non-serializable by
        # contract (they degrade, same as FlightRecorder.dump) — telemetry
        # must never raise into the training loop over a weird field
        out = self._request(OP_TELEMETRY,
                            json.dumps(report, default=repr).encode("utf-8"))
        return bool(json.loads(out.decode("utf-8")).get("ok"))

    def close(self):
        self._drop_sock()
        if self._fan is not None:
            self._fan.close()
            self._fan = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
