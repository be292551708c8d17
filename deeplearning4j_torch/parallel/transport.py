"""Peer-to-peer update transport for SHARED_GRADIENTS across processes.

Counterpart of ``deeplearning4j_tpu/parallel/transport.py``: the
replacement for the reference's Aeron UDP data plane (``nd4j-aeron``
driven from ``SharedTrainingWrapper.java:206-244``; update frames are
``networking/messages/SilentUpdatesMessage.java``). Within a process the
slots' gradients are summed in memory (``sharding.py``); this channel
carries the threshold-encoded update frames (``accumulation.py`` wire
form) between processes that train on their own.

Topology: full mesh of TCP streams between N processes (N is small — one per
slice/host). Frames are length-prefixed. ``broadcast`` sends the local frame
to every peer; ``gather`` collects one frame from each peer, so a round trip
is: encode → broadcast → gather → decode+apply all — exactly the reference's
"each worker applies everyone's quantized update" semantics.
"""
from __future__ import annotations

import logging
import socket
import struct
import time
from typing import Dict, List, Sequence

log = logging.getLogger(__name__)

__all__ = ["UpdateChannel", "PeerFailedError", "send_frame", "recv_exact",
           "recv_frame"]


class PeerFailedError(ConnectionError):
    """A specific peer's connection died mid-round. ``rank`` names the
    failing process so survivors can log/evict it instead of dying on an
    anonymous socket error (the reference's Aeron layer reports the
    disconnected session id the same way)."""

    def __init__(self, rank: int, message: str):
        super().__init__(message)
        self.rank = int(rank)


# Shared length-prefixed framing (little-endian i64 length + payload). Also
# used by the streaming pub/sub layer (datasets/streaming.py) so the two wire
# formats cannot diverge.
def send_frame(sock: "socket.socket", payload: bytes):
    sock.sendall(struct.pack("<q", len(payload)) + payload)


def recv_exact(sock: "socket.socket", n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


def recv_frame(sock: "socket.socket"):
    """One frame, or None when the peer closed cleanly before a header."""
    try:
        header = recv_exact(sock, 8)
    except ConnectionError:
        return None
    (n,) = struct.unpack("<q", header)
    return recv_exact(sock, n)


class UpdateChannel:
    """Full-mesh, length-prefixed frame exchange between training processes.

    ``process_id``/``addresses``: this process's rank and the listen address
    of every process (index-aligned). Lower ranks accept connections from
    higher ranks; higher ranks dial lower ranks — a deterministic handshake
    with no coordinator (the reference needed a shard/client role split,
    ``VoidConfiguration`` — multi-controller symmetry removes it).
    """

    def __init__(self, process_id: int, addresses: Sequence[str],
                 timeout: float = 60.0):
        self.p = int(process_id)
        self.addrs = [(h, int(pt)) for h, pt in
                      (a.rsplit(":", 1) for a in addresses)]
        self.P = len(self.addrs)
        self._peers: Dict[int, socket.socket] = {}
        self._listener = None
        #: per-peer wire bytes, last send/receive ms and failures (the JAX
        #: package's monitor series, kept on the channel)
        self.stats = {"bytes_out": {}, "bytes_in": {}, "send_ms": {}, "recv_ms": {},
                      "peer_failures": {}}
        if self.P > 1:
            try:
                self._connect(timeout)
            except BaseException:
                # half-built mesh: release the listen port and any peer
                # sockets so a retrying caller can bind again immediately
                self.close()
                raise

    # ------------------------------------------------------------- handshake
    def _connect(self, timeout: float):
        host, port = self.addrs[self.p]
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(self.P)
        self._listener = srv
        expected_in = [q for q in range(self.P) if q > self.p]
        expected_out = [q for q in range(self.P) if q < self.p]
        deadline = time.monotonic() + timeout
        for q in expected_out:
            while True:
                try:
                    s = socket.create_connection(self.addrs[q], timeout=2.0)
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"peer {q} unreachable")
                    time.sleep(0.05)
            # the 2s timeout is for the dial only — steps can legitimately
            # take longer (compile skew, data stalls), so frames block forever
            s.settimeout(None)
            s.sendall(struct.pack("<i", self.p))
            self._peers[q] = s
        for _ in expected_in:
            srv.settimeout(max(deadline - time.monotonic(), 0.1))
            try:
                s, _ = srv.accept()
            except socket.timeout:
                missing = sorted(set(expected_in) - set(self._peers))
                raise TimeoutError(
                    f"rank {self.p}: handshake timed out after {timeout:.1f}s;"
                    f" ranks {missing} never connected") from None
            s.settimeout(None)
            q = struct.unpack("<i", recv_exact(s, 4))[0]
            self._peers[q] = s

    # ----------------------------------------------------------------- frames
    def _peer_failed(self, rank: int, op: str, exc: OSError):
        fails = self.stats["peer_failures"]
        fails[rank] = fails.get(rank, 0) + 1
        log.warning("transport: rank %d saw peer %d fail during %s: %s", self.p, rank, op, exc)
        raise PeerFailedError(rank, f"peer {rank} failed during {op}: {exc}") from exc

    def _count(self, key, q, value):
        d = self.stats[key]
        d[q] = d.get(q, 0) + value

    def broadcast(self, frame: bytes):
        """Send one frame to every peer (``SilentUpdatesMessage`` fan-out);
        per-peer bytes and send time land in ``stats``."""
        header = struct.pack("<q", len(frame))
        for q in sorted(self._peers):
            s = self._peers[q]
            t0 = time.perf_counter()
            try:
                s.sendall(header)
                s.sendall(frame)
            except OSError as e:
                self._peer_failed(q, "broadcast", e)
            self.stats["send_ms"][q] = (time.perf_counter() - t0) * 1e3
            self._count("bytes_out", q, len(frame) + 8)

    def gather(self) -> List[bytes]:
        """Receive exactly one frame from every peer, rank order. A dead
        peer surfaces as :class:`PeerFailedError` naming the rank; the wait
        for each peer (the straggler signal) lands in ``stats``."""
        out = []
        for q in sorted(self._peers):
            s = self._peers[q]
            t0 = time.perf_counter()
            try:
                (n,) = struct.unpack("<q", recv_exact(s, 8))
                out.append(recv_exact(s, n))
            except OSError as e:
                self._peer_failed(q, "gather", e)
            self.stats["recv_ms"][q] = (time.perf_counter() - t0) * 1e3
            self._count("bytes_in", q, n + 8)
        return out

    def exchange(self, frame: bytes) -> List[bytes]:
        """broadcast + gather — one SHARED_GRADIENTS wire round. The send
        runs on a helper thread while this thread receives: with every rank
        sending before reading, frames larger than the kernel socket buffers
        would otherwise deadlock the full mesh pairwise."""
        import threading
        exc: List[BaseException] = []

        def send():
            try:
                self.broadcast(frame)
            except BaseException as e:  # surfaced after the join
                exc.append(e)

        t = threading.Thread(target=send, daemon=True)
        t.start()
        out = self.gather()
        t.join()
        if exc:
            raise exc[0]
        return out

    def close(self):
        for s in self._peers.values():
            try:
                s.close()
            except OSError:
                pass
        if self._listener is not None:
            self._listener.close()
