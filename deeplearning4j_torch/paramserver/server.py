"""Threaded TCP parameter-server node.

Counterpart of ``deeplearning4j_tpu/paramserver/server.py`` (the contract
of the reference's Aeron ``nd4j-parameter-server``: ``VoidParameterServer``
and ``ParameterServerNode``, a shard role holding the flat parameter
buffer, clients pushing encoded updates and pulling current values). The
wire is the JAX module's, byte for byte: ``parallel/transport.py``'s
length-prefixed frames around ``[op u8 | payload]`` requests and ``[status
u8 | payload]`` answers, with update frames in ``parallel/accumulation.py``'s
encoded form, so a client of either package talks to a server of either.

State: one flat float32 vector, split round-robin across ``num_shards``
virtual shards (shard s holds elements ``s::num_shards``). ``PUSH`` applies
an encoded update (``p -= decode(frame)``), through a server-side residual
when ``threshold > 0`` (sub-threshold mass is kept and applied once it
crosses the threshold). ``PULL`` answers the values with a version that
rises by one for each applied push or set; ``PULL_DELTA`` (proto v3)
answers "fresh", the journal of applied frames since a version, or the
full vector.

What the JAX server reports into its monitor planes (tracer spans, fleet
liveness, registry counters: ROADMAP A 17) stays on this object until the
port has those planes: ``OP_STATS`` carries the per-op counters and the
uptime, and ``OP_TELEMETRY`` keeps each worker's last report in
:attr:`ParameterServer.telemetry`. A ``FLAG_TRACE`` header is parsed and
its context dropped.

``ParameterServer(port=0)`` binds a free port (``.port``/``.address``).
"""
from __future__ import annotations

import json
import logging
import socket
import struct
import threading
import time
from collections import deque
from typing import List, Optional, Tuple

import numpy as np

from ..parallel.transport import send_frame, recv_frame
from ..parallel.accumulation import (deserialize_encoded, threshold_decode,
                                     encode_residual, serialize_encoded)
from .metrics import ParamServerMetrics

log = logging.getLogger(__name__)

__all__ = ["ParameterServer", "OP_INIT", "OP_SET", "OP_PUSH", "OP_PULL",
           "OP_VERSION", "OP_STATS", "OP_TELEMETRY", "OP_PULL_DELTA",
           "FLAG_TRACE", "OP_MASK", "PROTO_VERSION", "ST_OK", "ST_ERR",
           "DELTA_FRESH", "DELTA_FRAMES", "DELTA_FULL"]

# request = [op u8 | payload]; response = [status u8 | payload]
OP_INIT = 1     # payload f32[n]; set params ONLY if uninitialized → [ver q | created u8]
OP_SET = 2      # payload f32[n]; unconditional overwrite → [ver q]
OP_PUSH = 3     # payload accumulation.serialize_encoded frame → [ver q]
OP_PULL = 4     # payload [shard i32] (-1 = full vector) → [ver q | shard i32 | f32 bytes]
OP_VERSION = 5  # no payload → [ver q | n q]
OP_STATS = 6    # no payload → JSON bytes
OP_TELEMETRY = 7  # payload JSON {worker, registry, trace_events, ...} → JSON
OP_PULL_DELTA = 8  # v3: payload [since q | slack i32] → [ver q | mode u8 | body]
ST_OK = 0
ST_ERR = 1

# --- proto v2 extension (fleet observability, docs/OBSERVABILITY.md) ----
# The op byte's LOW 7 bits are the op; the HIGH bit is a flags bit:
# FLAG_TRACE means the payload is prefixed with a 16-byte trace-context
# header [trace_id u64 | parent span_id u64] and the server records its
# handling as a child span of that remote context. Version negotiation:
# OP_STATS answers carry "proto"; a v2 client only sets flag bits / sends
# OP_TELEMETRY after seeing proto >= 2, so v2 clients interoperate with v1
# servers (no flags, no telemetry) and v1 clients — which only ever send
# plain op bytes 1..6 — work against v2 servers unchanged.
FLAG_TRACE = 0x80
OP_MASK = 0x7F

# --- proto v3 extension (sharded fleet / delta wire, docs/PARALLELISM.md
# "Sharded parameter-server fleet") ---------------------------------------
# OP_PULL_DELTA replaces "version round trip + full-vector pull" with ONE
# round trip that ships only what changed. Request: [since q | slack i32]
# (the version the caller's local copy reconstructs, and how many server
# versions of lag it tolerates). Response: [ver q | mode u8 | body] where
#   DELTA_FRESH   body empty        — ver - since <= slack, keep local copy
#   DELTA_FRAMES  body = [count u32 | (len u32, frame)*count]
#                 — the APPLIED update frames for versions since+1..ver, in
#                 application order; replaying `p -= decode(frame)` on the
#                 local copy reconstructs the server state BIT-EXACTLY
#   DELTA_FULL    body = f32 values — the journal no longer reaches back to
#                 `since` (eviction, restart, or a SET barrier), or the
#                 caller is AHEAD of the server (restore from an older
#                 snapshot): full resync
# Clients only send OP_PULL_DELTA after OP_STATS advertises proto >= 3, so
# v3 clients negotiate down against v1/v2 servers exactly like v2 did.
DELTA_FRESH = 0
DELTA_FRAMES = 1
DELTA_FULL = 2
PROTO_VERSION = 3

#: a connection idle this long (no request) is closed; its client
#: reconnects on its next request
CONN_IDLE_TIMEOUT_S = 300.0

OP_NAMES = {OP_INIT: "init", OP_SET: "set", OP_PUSH: "push",
            OP_PULL: "pull", OP_VERSION: "version", OP_STATS: "stats",
            OP_TELEMETRY: "telemetry", OP_PULL_DELTA: "pull_delta"}


class ParameterServer:
    """Standalone parameter-server node: ``start()`` (or construct), point
    :class:`~deeplearning4j_tpu.paramserver.client.ParameterServerClient` at
    ``.address``, ``stop()`` when done (context manager supported).

    ``restore``: a ``snapshot()`` tuple from a previous incarnation — the
    restart path after a crash (version numbering continues, so client
    staleness bookkeeping survives the restart, and the server-side
    residual — sub-threshold pushed mass still awaiting application —
    carries over too).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 num_shards: int = 1, threshold: float = 0.0,
                 restore: Optional[tuple] = None, journal: int = 256,
                 shard_label: str = "0"):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.num_shards = int(num_shards)
        self.threshold = float(threshold)
        #: which shard of a ShardedParameterServerGroup this node holds —
        #: pure metrics/stats labeling, the storage layout doesn't change
        self.shard_label = str(shard_label)
        #: ring of the last `journal` APPLIED update frames (version,
        #: wire bytes) behind OP_PULL_DELTA; 0 disables (delta pulls always
        #: fall back to full). Cleared by SET/INIT (a full-state barrier no
        #: frame replay can cross) and empty after a restore — spanning
        #: pulls resync via DELTA_FULL once, then ride frames again.
        self._journal: deque = deque(maxlen=max(int(journal), 0))
        self.metrics = ParamServerMetrics(role="server")
        #: each worker's last OP_TELEMETRY report and when it came, by
        #: worker id (the JAX server's fleet table, kept here until A 17)
        self.telemetry: dict = {}
        self._t_start = time.time()
        self._op_lock = threading.Lock()
        self._op_counts = {name: 0 for name in OP_NAMES.values()}
        self._wire: dict = {}
        self._lock = threading.Lock()
        self._shards: Optional[List[np.ndarray]] = None
        self._n = 0
        self._version = 0
        self._residual: Optional[np.ndarray] = None
        if restore is not None:
            version, vec = restore[0], restore[1]
            residual = restore[2] if len(restore) > 2 else None
            self._store(np.asarray(vec, np.float32))
            self._version = int(version)
            if residual is not None:
                self._residual = np.asarray(residual, np.float32)

        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, int(port)))
        self._srv.listen(64)
        self._srv.settimeout(0.5)
        self.host = host
        self.port = self._srv.getsockname()[1]
        self.address = f"{host}:{self.port}"
        self._running = True
        self._conns: List[socket.socket] = []
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- storage
    def _store(self, vec: np.ndarray):
        """Split a flat vector round-robin into the virtual shards."""
        self._n = vec.size
        self._shards = [np.array(vec[s::self.num_shards], np.float32)
                        for s in range(self.num_shards)]

    def _assemble(self) -> np.ndarray:
        out = np.empty(self._n, np.float32)
        for s in range(self.num_shards):
            out[s::self.num_shards] = self._shards[s]
        return out

    def snapshot(self) -> Tuple[int, np.ndarray, Optional[np.ndarray]]:
        """(version, flat params, residual) — feed to ``restore=`` on
        restart. The residual slot keeps the never-lose-sub-threshold-mass
        guarantee across restarts of a ``threshold > 0`` server."""
        with self._lock:
            if self._shards is None:
                return self._version, np.zeros(0, np.float32), None
            residual = (None if self._residual is None
                        else self._residual.copy())
            return self._version, self._assemble(), residual

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    # ------------------------------------------------------------ op logic
    def _apply_push(self, payload: bytes) -> int:
        idx, signs, thr, n = deserialize_encoded(payload)
        with self._lock:
            if self._shards is None:
                raise ValueError("push before init: server holds no params")
            if n != self._n:
                raise ValueError(
                    f"pushed update length {n} != model length {self._n}")
            update = threshold_decode(idx, signs, thr, (n,))
            applied_frame = bytes(payload)
            if self.threshold > 0.0:
                # server-side residual accumulation: retain sub-threshold
                # mass, apply only what crossed the threshold this round
                g = (update if self._residual is None
                     else update + self._residual)
                (i2, s2), self._residual = encode_residual(g, self.threshold)
                update = threshold_decode(i2, s2, self.threshold, (n,))
                # the journal must hold what was APPLIED (post-residual) —
                # replaying the raw pushed frame would skip the residual rule
                applied_frame = serialize_encoded((i2, s2, self.threshold, n))
            for s in range(self.num_shards):
                self._shards[s] -= update[s::self.num_shards]
            self._version += 1
            if self._journal.maxlen:
                self._journal.append((self._version, applied_frame))
            return self._version

    def _handle(self, op: int, payload: bytes) -> bytes:
        if op == OP_INIT:
            vec = np.frombuffer(payload, np.float32)
            with self._lock:
                created = self._shards is None
                if created:
                    self._store(vec.copy())
                    self._version += 1
                    self._journal.clear()
                return struct.pack("<qB", self._version, int(created))
        if op == OP_SET:
            vec = np.frombuffer(payload, np.float32)
            with self._lock:
                self._store(vec.copy())
                self._residual = None
                self._version += 1
                # a SET is a full-state barrier: no sequence of journaled
                # push frames reconstructs across it
                self._journal.clear()
                return struct.pack("<q", self._version)
        if op == OP_PUSH:
            t0 = time.perf_counter()
            version = self._apply_push(payload)
            self.metrics.record_push((time.perf_counter() - t0) * 1e3,
                                     len(payload))
            return struct.pack("<q", version)
        if op == OP_PULL:
            (shard,) = struct.unpack("<i", payload)
            t0 = time.perf_counter()
            with self._lock:
                if self._shards is None:
                    raise ValueError("pull before init: server holds no params")
                if shard < -1 or shard >= self.num_shards:
                    raise ValueError(f"shard {shard} out of range "
                                     f"(num_shards={self.num_shards}; "
                                     f"-1 = full vector)")
                data = (self._assemble() if shard < 0
                        else self._shards[shard]).tobytes()
                version = self._version
            self.metrics.record_pull((time.perf_counter() - t0) * 1e3,
                                     len(data))
            return struct.pack("<qi", version, shard) + data
        if op == OP_PULL_DELTA:
            since, slack = struct.unpack("<qi", payload)
            t0 = time.perf_counter()
            with self._lock:
                if self._shards is None:
                    raise ValueError("pull before init: server holds no "
                                     "params")
                ver = self._version
                if since > ver:
                    # the caller is AHEAD of us (we restored from an older
                    # snapshot): a frame replay can't rewind — force resync
                    mode, body = DELTA_FULL, self._assemble().tobytes()
                elif ver - since <= max(int(slack), 0):
                    mode, body = DELTA_FRESH, b""
                else:
                    frames = [f for v, f in self._journal if v > since]
                    if len(frames) == ver - since:
                        # the journal covers since+1..ver contiguously
                        # (only pushes append; SET/INIT clear), so the
                        # caller replays exactly what we applied
                        mode = DELTA_FRAMES
                        parts = [struct.pack("<I", len(frames))]
                        for f in frames:
                            parts.append(struct.pack("<I", len(f)))
                            parts.append(f)
                        body = b"".join(parts)
                    else:
                        mode, body = DELTA_FULL, self._assemble().tobytes()
            if mode != DELTA_FRESH:
                self.metrics.record_pull((time.perf_counter() - t0) * 1e3,
                                         len(body))
            return struct.pack("<qB", ver, mode) + body
        if op == OP_VERSION:
            with self._lock:
                return struct.pack("<qq", self._version, self._n)
        if op == OP_STATS:
            stats = self.metrics.snapshot()
            with self._lock:
                stats["version"] = self._version
                stats["n"] = self._n
                stats["num_shards"] = self.num_shards
                stats["journal_len"] = len(self._journal)
            stats["shard"] = self.shard_label
            # immutable after construction; lets clients detect
            # server-side residual merging (see training.py's
            # count_own_pushes drift warning)
            stats["threshold"] = self.threshold
            # proto v2 additions: capability advertisement (the version-
            # negotiation seam v2 clients key flagged ops / telemetry on),
            # server-side load visible without log scraping
            stats["proto"] = PROTO_VERSION
            stats["uptime_s"] = time.time() - self._t_start
            with self._op_lock:
                stats["ops"] = dict(self._op_counts)
                stats["wire"] = {k: dict(v) for k, v in self._wire.items()}
            return json.dumps(stats).encode("utf-8")
        if op == OP_TELEMETRY:
            report = json.loads(payload.decode("utf-8"))
            worker = report.get("worker")
            if not worker:
                raise ValueError("telemetry report carries no worker id")
            with self._op_lock:
                self.telemetry[str(worker)] = {"t": time.time(), "report": report}
                workers = len(self.telemetry)
            return json.dumps({"ok": True, "workers": workers}).encode("utf-8")
        raise ValueError(f"unknown op {op}")

    # ------------------------------------------------------------- network
    def _accept_loop(self):
        while self._running:
            try:
                s, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            if not self._running:
                # raced stop(): the blocked accept() kept the port alive
                # until this connection arrived — refuse it, don't serve it
                try:
                    s.close()
                except OSError:
                    pass
                return
            try:
                # small-response ops (version, delta-fresh) must not sit
                # out a Nagle/delayed-ACK round
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            s.settimeout(CONN_IDLE_TIMEOUT_S)
            self._conns.append(s)
            threading.Thread(target=self._serve_conn, args=(s,),
                             daemon=True).start()

    def _count_op(self, op: int):
        name = OP_NAMES.get(op)
        if name is None:
            return
        with self._op_lock:
            self._op_counts[name] += 1

    def _record_wire(self, op: int, n_rx: int, n_tx: int):
        """Wire bytes by op: rx the request frame, tx the answer frame
        (``OP_STATS``'s ``wire``)."""
        name = OP_NAMES.get(op)
        if name is None:
            return
        with self._op_lock:
            row = self._wire.setdefault(name, {"rx": 0, "tx": 0})
            row["rx"] += int(n_rx)
            row["tx"] += int(n_tx)

    def _serve_conn(self, s: socket.socket):
        try:
            while True:
                frame = recv_frame(s)
                if frame is None or not frame:
                    return  # client closed (or sent an empty keepalive)
                # proto v2: high bit of the op byte = FLAG_TRACE (a 16-byte
                # remote span context precedes the payload). v1 clients
                # never set it, so for them this is the old [op | payload].
                op = frame[0] & OP_MASK
                flags = frame[0] & ~OP_MASK
                payload = frame[1:]
                self._count_op(op)
                try:
                    if flags & FLAG_TRACE:
                        # a remote span context [trace_id u64 | span_id
                        # u64]: parsed off and dropped until the port has a
                        # tracer (ROADMAP A 17)
                        if len(payload) < 16:
                            raise ValueError(
                                "FLAG_TRACE set but no 16-byte trace-"
                                "context header precedes the payload")
                        payload = payload[16:]
                    out = self._handle(op, payload)
                    self._record_wire(op, len(frame), 1 + len(out))
                    send_frame(s, bytes([ST_OK]) + out)
                except Exception as e:  # malformed frame ≠ dead server: the
                    # client gets a typed error, the connection stays up
                    self.metrics.add("errors")
                    send_frame(s, bytes([ST_ERR]) + str(e).encode("utf-8"))
        except OSError:
            pass  # client vanished mid-frame or idle past the timeout
        finally:
            try:
                s.close()
            except OSError:
                pass
            try:
                self._conns.remove(s)
            except ValueError:
                pass

    def stop(self):
        self._running = False
        try:  # wake a blocked accept() (close alone defers while it waits)
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass
        for s in list(self._conns):
            # shutdown, not just close: a serve thread blocked in recv holds
            # the connection open past close(); shutdown aborts the recv so
            # clients see the death immediately instead of a live zombie
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        self._thread.join(timeout=5.0)

    close = stop

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
