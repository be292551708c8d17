"""Streaming ingestion and serving: NDArray pub/sub and streaming iterators.

Counterpart of ``deeplearning4j_tpu/datasets/streaming.py`` (reference
``dl4j-streaming``: ``NDArrayKafkaClient``/``NDArrayPublisher``/
``NDArrayConsumer``, the record-to-DataSet conversion functions and the
Camel serving route ``routes/DL4jServeRouteBuilder.java``):

 - :class:`NDArrayMessage`: the little-endian wire codec for numpy arrays
   (dtype tag, rank, dims, raw bytes), the same bytes as the JAX module's.
 - :class:`StreamingBroker`: an in-process topic broker over TCP, framed
   by ``parallel/transport.py``'s ``send_frame``/``recv_frame``.
 - :class:`NDArrayPublisher` / :class:`NDArrayConsumer`: publish and
   subscribe arrays (a tuple of arrays is one message of several parts).
 - :class:`StreamingDataSetIterator`: a consumer of (features, labels)
   messages as a ``DataSetIterator``, so ``net.fit`` trains off the stream
   through the prefetch pipeline.
 - :class:`ServingRoute`: consume feature arrays, answer through the
   network's ``output`` (on the card, its kernels), publish predictions.

Every socket wait has a timeout: the consumer's ``timeout``, the
publisher's connect, and on the broker side ``BROKER_IDLE_TIMEOUT_S`` for
a publisher's next frame and a subscriber's send (a peer idle that long
is dropped as if it had disconnected). The broker's locks are plain
``threading.Lock`` objects. ``subscribers``/``publishers`` count a topic's
registered peers, so a caller can wait for its registration to land
before it publishes.

For real Kafka brokers, ``datasets/kafka.py`` speaks the Kafka protocol
and carries these ``NDArrayMessage`` payloads as record values.
"""
from __future__ import annotations

import socket
import struct
import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .dataset import DataSet, DataSetIterator

__all__ = ["NDArrayMessage", "StreamingBroker", "NDArrayPublisher",
           "NDArrayConsumer", "StreamingDataSetIterator", "ServingRoute",
           "StreamIdleTimeout"]


class StreamIdleTimeout(TimeoutError):
    """Timeout that fired BETWEEN frames (no bytes consumed) — safe to retry.
    A plain TimeoutError from ``receive`` means bytes of a frame were already
    consumed; retrying would desync the framed stream."""


# ------------------------------------------------------------------ wire codec
class NDArrayMessage:
    """Multi-part numpy array wire codec. Frame = u32 part count, then per
    part: u8 dtype tag, u8 rank, u64 dims[rank], raw bytes."""

    _DTYPES = [np.dtype(np.float32), np.dtype(np.float64),
               np.dtype(np.int32), np.dtype(np.int64),
               np.dtype(np.uint8), np.dtype(np.bool_), np.dtype(np.float16),
               np.dtype(np.int8), np.dtype(np.int16), np.dtype(np.uint16),
               np.dtype(np.uint32), np.dtype(np.uint64)]
    _TAG = {d: i for i, d in enumerate(_DTYPES)}

    @classmethod
    def encode(cls, arrays: Sequence[np.ndarray]) -> bytes:
        if isinstance(arrays, np.ndarray):
            arrays = [arrays]
        out = [struct.pack("<I", len(arrays))]
        for a in arrays:
            a = np.asarray(a)
            if a.ndim and not a.flags["C_CONTIGUOUS"]:
                # ascontiguousarray only when needed: it promotes 0-d arrays
                # to 1-d, breaking scalar round-trips
                a = np.ascontiguousarray(a)
            if a.dtype not in cls._TAG:
                # a wire codec must not silently change dtype
                raise ValueError(f"NDArrayMessage: unsupported dtype "
                                 f"{a.dtype}; supported: "
                                 f"{[str(d) for d in cls._DTYPES]}")
            out.append(struct.pack("<BB", cls._TAG[a.dtype], a.ndim))
            out.append(struct.pack(f"<{max(a.ndim, 1)}q",
                                   *(a.shape or (a.size,))))
            out.append(a.tobytes())
        return b"".join(out)

    @classmethod
    def decode(cls, data: bytes) -> List[np.ndarray]:
        (n,) = struct.unpack_from("<I", data, 0)
        off = 4
        out = []
        for _ in range(n):
            tag, rank = struct.unpack_from("<BB", data, off)
            off += 2
            dims = struct.unpack_from(f"<{max(rank, 1)}q", data, off)
            off += 8 * max(rank, 1)
            dt = cls._DTYPES[tag]
            count = int(np.prod(dims[:rank])) if rank else int(dims[0])
            nbytes = count * dt.itemsize
            arr = np.frombuffer(data[off:off + nbytes], dt)
            off += nbytes
            # rank 0 round-trips to a scalar shape (), not (1,)
            out.append(arr.reshape(dims[:rank] if rank else ()))
        return out


# framing shared with the SHARED_GRADIENTS update wire — one format, one
# implementation (parallel/transport.py)
from ..parallel.transport import send_frame as _send_frame  # noqa: E402
from ..parallel.transport import recv_frame as _recv_frame  # noqa: E402

#: a broker-side peer idle this long (a publisher's next frame, a send to a
#: subscriber) is dropped as if it had disconnected
BROKER_IDLE_TIMEOUT_S = 300.0

#: zero-length payload = end-of-stream control frame: a closing publisher
#: sends it and the broker fans it out, so subscribers see a clean end
#: instead of blocking until their socket times out
_EOS = b""


# ---------------------------------------------------------------------- broker
class StreamingBroker:
    """Topic broker: clients send ``SUB <topic>`` or ``PUB <topic>`` control
    frames, then publishers stream message frames which the broker fans out
    to every subscriber of that topic (at-most-once, the reference test
    cluster's semantics)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(64)
        self._srv.settimeout(0.5)
        self.address = f"{host}:{self._srv.getsockname()[1]}"
        self._subs: Dict[str, List[socket.socket]] = {}
        # per-subscriber send locks: two publishers on one topic fan out from
        # different threads, and interleaved sendall() on the same socket
        # would corrupt the subscriber's frame stream
        self._send_locks: Dict[socket.socket, threading.Lock] = {}
        # active publishers per topic: EOS reaches subscribers only when the
        # LAST publisher of a topic closes — one departing publisher must not
        # end the stream for a topic others are still feeding
        self._pubs: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._running = True
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def _accept_loop(self):
        while self._running:
            try:
                s, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            s.settimeout(BROKER_IDLE_TIMEOUT_S)
            threading.Thread(target=self._client_loop, args=(s,),
                             daemon=True).start()

    def subscribers(self, topic: str) -> int:
        """Subscribers registered on ``topic``."""
        with self._lock:
            return len(self._subs.get(topic, ()))

    def publishers(self, topic: str) -> int:
        """Publishers registered on ``topic`` and not yet closed."""
        with self._lock:
            return self._pubs.get(topic, 0)

    def _client_loop(self, s: socket.socket):
        try:
            hello = _recv_frame(s)
        except OSError:
            hello = None
        if hello is None:
            s.close()
            return
        mode, _, topic = hello.decode("utf-8").partition(" ")
        if mode == "SUB":
            with self._lock:
                self._subs.setdefault(topic, []).append(s)
                self._send_locks[s] = threading.Lock()
            return  # frames are pushed by publishers; socket stays open
        with self._lock:
            self._pubs[topic] = self._pubs.get(topic, 0) + 1
        while True:  # PUB
            try:
                frame = _recv_frame(s)
            except OSError:  # abrupt disconnect, a reset, or idle past the timeout
                frame = None
            if frame == _EOS or frame is None:
                with self._lock:
                    self._pubs[topic] = self._pubs.get(topic, 1) - 1
                    last = self._pubs[topic] <= 0
                # forward EOS only on an EXPLICIT close of the last
                # publisher; an abrupt disconnect stays loud (subscribers
                # time out instead of "finishing" a truncated stream)
                if frame == _EOS and last:
                    self._fanout(topic, _EOS)
                s.close()
                return
            self._fanout(topic, frame)

    def _fanout(self, topic: str, frame: bytes):
        with self._lock:
            targets = [(t, self._send_locks[t])
                       for t in self._subs.get(topic, ())]
        for t, lock in targets:
            try:
                with lock:
                    _send_frame(t, frame)
            except OSError:
                with self._lock:
                    if t in self._subs.get(topic, ()):
                        self._subs[topic].remove(t)
                    self._send_locks.pop(t, None)

    def close(self):
        self._running = False
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            for socks in self._subs.values():
                for s in socks:
                    try:
                        s.close()
                    except OSError:
                        pass


def _connect(address: str) -> socket.socket:
    host, _, port = address.rpartition(":")
    return socket.create_connection((host, int(port)), timeout=30.0)


class NDArrayPublisher:
    """Reference ``NDArrayPublisher`` (``streaming/kafka/NDArrayPublisher.java:23``,
    ``publish(INDArray)``/``publish(INDArray[])``)."""

    def __init__(self, address: str, topic: str):
        self._sock = _connect(address)
        _send_frame(self._sock, f"PUB {topic}".encode("utf-8"))

    def publish(self, arrays):
        _send_frame(self._sock, NDArrayMessage.encode(arrays))

    def close(self, end_stream: bool = True):
        """``end_stream`` sends the EOS control frame first, giving
        subscribers a clean end-of-stream (None from ``receive``) instead of
        an eventual timeout."""
        if end_stream:
            try:
                _send_frame(self._sock, _EOS)
            except OSError:
                pass
        self._sock.close()


class NDArrayConsumer:
    """Reference ``NDArrayConsumer``: blocking array receive from a topic."""

    def __init__(self, address: str, topic: str, timeout: float = 30.0):
        self._sock = _connect(address)
        self._sock.settimeout(timeout)
        _send_frame(self._sock, f"SUB {topic}".encode("utf-8"))

    def _recv_idle_aware(self) -> Optional[bytes]:
        """One frame; distinguishes idle (no bytes consumed → safe to retry)
        from a mid-frame stall (stream desynced → fatal)."""
        try:
            first = self._sock.recv(8)
        except socket.timeout:
            raise StreamIdleTimeout(
                f"no message within {self._sock.gettimeout()}s — producer "
                f"idle or stalled (safe to retry)")
        if not first:
            return None  # orderly close
        buf = bytearray(first)
        while len(buf) < 8:
            chunk = self._sock.recv(8 - len(buf))
            if not chunk:
                raise ConnectionError("peer closed mid-header")
            buf.extend(chunk)
        (n,) = struct.unpack("<q", bytes(buf))
        payload = bytearray()
        while len(payload) < n:
            chunk = self._sock.recv(n - len(payload))
            if not chunk:
                raise ConnectionError("peer closed mid-frame")
            payload.extend(chunk)
        return bytes(payload)

    def receive(self) -> Optional[List[np.ndarray]]:
        """Next message's arrays; None only on CLEAN stream end (the last
        publisher's EOS frame or an orderly socket close). An idle/stalled
        producer raises StreamIdleTimeout (retryable — no bytes consumed); a
        timeout or close mid-frame raises TimeoutError/ConnectionError
        (fatal: the framed stream is desynced). Silently treating failures
        as end-of-stream would let training finish "successfully" on a
        truncated stream."""
        try:
            frame = self._recv_idle_aware()
        except StreamIdleTimeout:
            raise
        except socket.timeout:
            raise TimeoutError("timeout mid-frame — framed stream desynced")
        except OSError as e:
            raise ConnectionError(f"stream connection lost: {e}") from e
        if frame is None or frame == _EOS:
            return None
        return NDArrayMessage.decode(frame)

    getINDArray = receive

    def close(self):
        self._sock.close()


# ------------------------------------------------------------------- iterators
class StreamingDataSetIterator(DataSetIterator):
    """DataSetIterator over an array stream: each message is (features,
    labels[, features_mask, labels_mask]). ``num_batches`` bounds the stream
    (None → iterate until the producer closes). The conversion-function role
    of the reference's ``streaming/conversion`` is the optional ``convert``
    hook mapping raw message parts to a DataSet."""

    def __init__(self, consumer: NDArrayConsumer,
                 num_batches: Optional[int] = None,
                 convert: Optional[Callable[[List[np.ndarray]], DataSet]] = None):
        self.consumer = consumer
        self.num_batches = num_batches
        self.convert = convert
        self._seen = 0

    def __next__(self) -> DataSet:
        if self.num_batches is not None and self._seen >= self.num_batches:
            raise StopIteration
        parts = self.consumer.receive()
        if parts is None:
            raise StopIteration
        self._seen += 1
        if self.convert is not None:
            return self.convert(parts)
        return DataSet(*parts[:4])

    def reset(self):
        self._seen = 0  # a stream cannot rewind; counting restarts

    def async_supported(self):
        return True  # prefetch thread overlaps H2D with the network


def _host_array(t) -> np.ndarray:
    """A prediction as a host array for the wire (bf16, which numpy lacks,
    as f32)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().to("cpu")
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


class ServingRoute:
    """Reference ``routes/DL4jServeRouteBuilder.java``: consume feature
    arrays, run the model, publish predictions. ``run(max_messages=N)``
    processes N messages then returns; ``max_messages=None`` serves until
    the stream ends. ``start`` runs the same loop on a daemon thread; a
    fatal error is stored on ``self.error`` (and re-raised by ``check``)
    rather than dying silently inside the thread. Idle timeouts are NOT
    fatal — gaps between requests are normal for a serving endpoint."""

    def __init__(self, net, consumer: NDArrayConsumer,
                 publisher: NDArrayPublisher):
        self.net = net
        self.consumer = consumer
        self.publisher = publisher
        self.served = 0
        self.error: Optional[BaseException] = None

    def run(self, max_messages: Optional[int] = None):
        is_graph = hasattr(self.net.conf, "vertices")  # ComputationGraph
        while max_messages is None or self.served < max_messages:
            try:
                parts = self.consumer.receive()
                if parts is None:
                    return  # clean end of the request stream
                if is_graph:
                    out = self.net.output(*parts)   # multi-input graphs
                elif len(parts) > 1:
                    # MLN: (features, mask) message shape
                    out = self.net.output(parts[0], mask=parts[1])
                else:
                    out = self.net.output(parts[0])
                outs = out if isinstance(out, (list, tuple)) else [out]
                self.publisher.publish([_host_array(o) for o in outs])
                self.served += 1
            except StreamIdleTimeout:
                continue  # idle between requests — keep serving
            except Exception as e:  # noqa: BLE001 — surfaced via check()
                # ANY fatal error (desync, decode, inference shape mismatch)
                # is stored, not swallowed by the daemon thread
                self.error = e
                return

    def check(self):
        """Re-raise a fatal serving error captured on the daemon thread."""
        if self.error is not None:
            raise self.error

    def start(self, max_messages: Optional[int] = None) -> threading.Thread:
        t = threading.Thread(target=self.run, args=(max_messages,),
                             daemon=True)
        t.start()
        return t
