"""Kafka wire-protocol codec and the NDArray Kafka client.

Counterpart of ``deeplearning4j_tpu/datasets/kafka.py``: the reference's
``NDArrayKafkaClient`` (``dl4j-streaming/.../streaming/kafka/
NDArrayKafkaClient.java:1``) carries arrays through Kafka topics; this
module speaks the Kafka byte formats it needs, with no Kafka library:

- :func:`crc32c`: the Castagnoli CRC of RecordBatch v2, slice-by-8 (the
  published vector crc32c(b"123456789") == 0xE3069283).
- varint/zigzag codecs (Kafka's record-level integers).
- :class:`Record` and :class:`RecordBatch` (magic 2): encode and decode
  with per-record varint framing, headers, and the crc32c over
  attributes..records.
- Produce v3 and Fetch v4 requests and responses (the first versions that
  carry RecordBatch v2), with the 4-byte size framing. There is no
  metadata or leader discovery: the client talks to the bootstrap broker,
  which must be (or proxy to) the partition leader.
- :class:`NDArrayKafkaClient` (``publish(arrays)`` / ``poll()``), whose
  record values are ``streaming.NDArrayMessage`` payloads, and
  :class:`KafkaDataSetIterator`, which feeds ``fit`` from a topic.

All of it is host code; the bytes are the JAX module's, so records one
package writes the other reads. Every socket wait has the client's
``timeout``.
"""
from __future__ import annotations

import io
import socket
import struct
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .dataset import DataSet, DataSetIterator

# ------------------------------------------------------------------- crc32c
_CRC32C_POLY = 0x82F63B78
_CRC32C_TABLES = [[0] * 256 for _ in range(8)]
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _CRC32C_POLY if _c & 1 else _c >> 1
    _CRC32C_TABLES[0][_i] = _c
for _k in range(1, 8):
    for _i in range(256):
        _p = _CRC32C_TABLES[_k - 1][_i]
        _CRC32C_TABLES[_k][_i] = _CRC32C_TABLES[0][_p & 0xFF] ^ (_p >> 8)


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) — RecordBatch v2's checksum. Slice-by-8 table
    walk (8 bytes per loop iteration — the pure-Python constant matters:
    tensor payloads are MBs). Matches the published vectors
    (crc32c(b"123456789") == 0xE3069283)."""
    t = _CRC32C_TABLES
    crc = ~crc & 0xFFFFFFFF
    n = len(data)
    i = 0
    while n - i >= 8:
        lo = crc ^ int.from_bytes(data[i:i + 4], "little")
        hi = int.from_bytes(data[i + 4:i + 8], "little")
        crc = (t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF]
               ^ t[5][(lo >> 16) & 0xFF] ^ t[4][(lo >> 24) & 0xFF]
               ^ t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF]
               ^ t[1][(hi >> 16) & 0xFF] ^ t[0][(hi >> 24) & 0xFF])
        i += 8
    while i < n:
        crc = (crc >> 8) ^ t[0][(crc ^ data[i]) & 0xFF]
        i += 1
    return ~crc & 0xFFFFFFFF


# ----------------------------------------------------------- varint / zigzag
def zigzag_encode(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def zigzag_decode(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def write_varint(out: io.BytesIO, value: int):
    """Kafka varint: zigzag then LEB128."""
    v = zigzag_encode(value) & 0xFFFFFFFFFFFFFFFF
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.write(bytes([b | 0x80]))
        else:
            out.write(bytes([b]))
            return


def read_varint(buf: io.BytesIO) -> int:
    shift, result = 0, 0
    while True:
        raw = buf.read(1)
        if not raw:
            raise EOFError("varint truncated")
        b = raw[0]
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return zigzag_decode(result)
        shift += 7


# --------------------------------------------------------------- primitives
def _i8(v):
    return struct.pack(">b", v)


def _i16(v):
    return struct.pack(">h", v)


def _i32(v):
    return struct.pack(">i", v)


def _i64(v):
    return struct.pack(">q", v)


def _string(s: Optional[str]) -> bytes:
    if s is None:
        return _i16(-1)
    b = s.encode()
    return _i16(len(b)) + b


def _bytes(b: Optional[bytes]) -> bytes:
    if b is None:
        return _i32(-1)
    return _i32(len(b)) + b


class _Reader:
    def __init__(self, data: bytes):
        self.b = io.BytesIO(data)

    def i8(self):
        return struct.unpack(">b", self.b.read(1))[0]

    def i16(self):
        return struct.unpack(">h", self.b.read(2))[0]

    def i32(self):
        return struct.unpack(">i", self.b.read(4))[0]

    def i64(self):
        return struct.unpack(">q", self.b.read(8))[0]

    def u32(self):
        return struct.unpack(">I", self.b.read(4))[0]

    def string(self):
        n = self.i16()
        return None if n < 0 else self.b.read(n).decode()

    def bytes_(self):
        n = self.i32()
        return None if n < 0 else self.b.read(n)

    def raw(self, n):
        return self.b.read(n)


# ------------------------------------------------------------ RecordBatch v2
class Record:
    """One record inside a v2 batch."""

    def __init__(self, value: bytes, key: Optional[bytes] = None,
                 headers: Sequence[Tuple[str, bytes]] = (),
                 timestamp_delta: int = 0, offset_delta: int = 0):
        self.value = value
        self.key = key
        self.headers = list(headers)
        self.timestamp_delta = timestamp_delta
        self.offset_delta = offset_delta

    def encode(self) -> bytes:
        body = io.BytesIO()
        body.write(_i8(0))                       # attributes (unused)
        write_varint(body, self.timestamp_delta)
        write_varint(body, self.offset_delta)
        if self.key is None:
            write_varint(body, -1)
        else:
            write_varint(body, len(self.key))
            body.write(self.key)
        if self.value is None:
            write_varint(body, -1)
        else:
            write_varint(body, len(self.value))
            body.write(self.value)
        write_varint(body, len(self.headers))
        for hk, hv in self.headers:
            kb = hk.encode()
            write_varint(body, len(kb))
            body.write(kb)
            write_varint(body, len(hv))
            body.write(hv)
        payload = body.getvalue()
        out = io.BytesIO()
        write_varint(out, len(payload))
        out.write(payload)
        return out.getvalue()

    @classmethod
    def decode(cls, buf: io.BytesIO) -> "Record":
        length = read_varint(buf)
        body = io.BytesIO(buf.read(length))
        body.read(1)                             # attributes
        ts_delta = read_varint(body)
        off_delta = read_varint(body)
        klen = read_varint(body)
        key = body.read(klen) if klen >= 0 else None
        vlen = read_varint(body)
        value = body.read(vlen) if vlen >= 0 else None  # None = tombstone
        n_headers = read_varint(body)
        headers = []
        for _ in range(n_headers):
            hklen = read_varint(body)
            hk = body.read(hklen).decode()
            hvlen = read_varint(body)
            hv = body.read(hvlen) if hvlen >= 0 else b""
            headers.append((hk, hv))
        return cls(value, key, headers, ts_delta, off_delta)


class RecordBatch:
    """Kafka message-format v2 batch (magic byte 2) — the format every
    broker since 0.11 stores and ships. Layout (all big-endian):

    baseOffset i64 | batchLength i32 | partitionLeaderEpoch i32 | magic i8 |
    crc u32 (crc32c of everything after it) | attributes i16 |
    lastOffsetDelta i32 | baseTimestamp i64 | maxTimestamp i64 |
    producerId i64 | producerEpoch i16 | baseSequence i32 |
    recordCount i32 | records…
    """

    MAGIC = 2

    def __init__(self, records: List[Record], base_offset: int = 0,
                 base_timestamp: int = 0, last_offset_delta: Optional[int] = None,
                 attributes: int = 0):
        self.records = records
        self.base_offset = base_offset
        self.base_timestamp = base_timestamp
        # may exceed len(records)-1 on compacted batches; consumers must
        # advance by it, not by the surviving record count
        self.last_offset_delta = (len(records) - 1 if last_offset_delta is None
                                  else last_offset_delta)
        self.attributes = attributes

    @property
    def is_control(self) -> bool:
        """Transaction-marker batches (attributes bit 5): skip, never
        decode their payloads."""
        return bool(self.attributes & 0x20)

    @property
    def next_offset(self) -> int:
        return self.base_offset + self.last_offset_delta + 1

    def encode(self) -> bytes:
        # brokers validate record offsets: producer batches get sequential
        # deltas 0..n-1 (consistent with lastOffsetDelta). A synthetic
        # compacted batch (caller-set larger delta) keeps its own deltas.
        if self.last_offset_delta == len(self.records) - 1:
            for i, r in enumerate(self.records):
                r.offset_delta = i
        recs = b"".join(r.encode() for r in self.records)
        after_crc = io.BytesIO()
        after_crc.write(_i16(self.attributes))
        after_crc.write(_i32(max(0, self.last_offset_delta)))
        after_crc.write(_i64(self.base_timestamp))
        after_crc.write(_i64(self.base_timestamp))
        after_crc.write(_i64(-1))                            # producerId
        after_crc.write(_i16(-1))                            # producerEpoch
        after_crc.write(_i32(-1))                            # baseSequence
        after_crc.write(_i32(len(self.records)))
        after_crc.write(recs)
        tail = after_crc.getvalue()
        crc = crc32c(tail)
        # batchLength counts from partitionLeaderEpoch (exclusive of
        # baseOffset+batchLength themselves)
        body = _i32(-1) + _i8(self.MAGIC) + struct.pack(">I", crc) + tail
        return _i64(self.base_offset) + _i32(len(body)) + body

    @classmethod
    def decode(cls, data: bytes, verify_crc: bool = True) -> "RecordBatch":
        r = _Reader(data)
        base_offset = r.i64()
        batch_len = r.i32()
        body = r.raw(batch_len)
        br = _Reader(body)
        br.i32()                                             # leaderEpoch
        magic = br.i8()
        if magic != cls.MAGIC:
            raise ValueError(f"unsupported message-format magic {magic} "
                             f"(only v2 RecordBatch is implemented)")
        crc = br.u32()
        tail = body[9:]
        if verify_crc and crc32c(tail) != crc:
            raise ValueError("RecordBatch crc32c mismatch (corrupt batch)")
        tr = _Reader(tail)
        attributes = tr.i16()
        last_delta = tr.i32()
        base_ts = tr.i64()
        tr.i64()                                             # maxTimestamp
        tr.i64()                                             # producerId
        tr.i16()                                             # producerEpoch
        tr.i32()                                             # baseSequence
        n = tr.i32()
        buf = io.BytesIO(tail[tr.b.tell():])
        records = [Record.decode(buf) for _ in range(n)]
        return cls(records, base_offset, base_ts,
                   last_offset_delta=last_delta, attributes=attributes)


# ------------------------------------------------------------- request codec
API_PRODUCE = 0
API_FETCH = 1
API_METADATA = 3
API_VERSIONS = 18


def request_frame(api_key: int, api_version: int, correlation_id: int,
                  client_id: str, body: bytes) -> bytes:
    """4-byte-size framed Kafka request with the classic (v1) header."""
    header = (_i16(api_key) + _i16(api_version) + _i32(correlation_id)
              + _string(client_id))
    payload = header + body
    return _i32(len(payload)) + payload


def produce_request(topic: str, partition: int, batch: RecordBatch,
                    acks: int = 1, timeout_ms: int = 10000) -> bytes:
    """Produce v3 body (first version carrying RecordBatch v2)."""
    rec = batch.encode()
    return (_string(None)                       # transactional_id
            + _i16(acks) + _i32(timeout_ms)
            + _i32(1) + _string(topic)
            + _i32(1) + _i32(partition) + _bytes(rec))


def parse_produce_response(body: bytes) -> Dict:
    r = _Reader(body)
    n_topics = r.i32()
    out = {}
    for _ in range(n_topics):
        topic = r.string()
        n_parts = r.i32()
        parts = {}
        for _ in range(n_parts):
            pid = r.i32()
            err = r.i16()
            base_offset = r.i64()
            log_append_time = r.i64()
            parts[pid] = {"error_code": err, "base_offset": base_offset,
                          "log_append_time": log_append_time}
        out[topic] = parts
    r.i32()                                      # throttle_time_ms
    return out


def fetch_request(topic: str, partition: int, offset: int,
                  max_bytes: int = 1 << 20, max_wait_ms: int = 500) -> bytes:
    """Fetch v4 body (first version returning RecordBatch v2)."""
    return (_i32(-1)                             # replica_id (consumer)
            + _i32(max_wait_ms) + _i32(1)        # min_bytes
            + _i32(max_bytes) + _i8(0)           # isolation_level
            + _i32(1) + _string(topic)
            + _i32(1) + _i32(partition) + _i64(offset) + _i32(max_bytes))


def parse_fetch_response(body: bytes) -> Dict:
    r = _Reader(body)
    r.i32()                                      # throttle_time_ms
    n_topics = r.i32()
    out = {}
    for _ in range(n_topics):
        topic = r.string()
        n_parts = r.i32()
        parts = {}
        for _ in range(n_parts):
            pid = r.i32()
            err = r.i16()
            high_watermark = r.i64()
            r.i64()                              # last_stable_offset
            n_aborted = r.i32()
            for _ in range(max(0, n_aborted)):
                r.i64()
                r.i64()
            recs = r.bytes_()
            batches = []
            buf = recs or b""
            pos = 0
            while pos + 12 <= len(buf):
                blen = struct.unpack(">i", buf[pos + 8:pos + 12])[0]
                end = pos + 12 + blen
                if end > len(buf):
                    break                        # truncated trailing batch
                batches.append(RecordBatch.decode(buf[pos:end]))
                pos = end
            parts[pid] = {"error_code": err,
                          "high_watermark": high_watermark,
                          "batches": batches}
        out[topic] = parts
    return out


# --------------------------------------------------------------- the client
class NDArrayKafkaClient:
    """The reference ``NDArrayKafkaClient`` contract over the raw protocol:
    ``publish(arrays)`` produces one record whose value is the
    ``streaming.NDArrayMessage`` payload; ``poll()`` fetches and decodes
    records from the current offset. One socket, one topic-partition —
    the shape the reference's Camel route used."""

    def __init__(self, bootstrap: str, topic: str, partition: int = 0,
                 client_id: str = "dl4j-tpu", timeout: float = 10.0):
        host, _, port = bootstrap.partition(":")
        self._addr = (host, int(port or 9092))
        self.topic = topic
        self.partition = partition
        self.client_id = client_id
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._correlation = 0
        self.offset = 0

    # -- plumbing ---------------------------------------------------------
    def _conn(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection(self._addr, self.timeout)
        return self._sock

    def _roundtrip(self, api_key: int, api_version: int, body: bytes) -> bytes:
        self._correlation += 1
        s = self._conn()
        s.sendall(request_frame(api_key, api_version, self._correlation,
                                self.client_id, body))
        size_raw = self._recv_exact(4)
        size = struct.unpack(">i", size_raw)[0]
        payload = self._recv_exact(size)
        corr = struct.unpack(">i", payload[:4])[0]
        if corr != self._correlation:
            raise IOError(f"correlation id mismatch: {corr} != "
                          f"{self._correlation}")
        return payload[4:]

    def _recv_exact(self, n: int) -> bytes:
        s = self._conn()
        chunks = []
        while n:
            c = s.recv(n)
            if not c:
                raise ConnectionError("broker closed connection")
            chunks.append(c)
            n -= len(c)
        return b"".join(chunks)

    # -- API --------------------------------------------------------------
    def publish(self, arrays) -> int:
        """Produce one record carrying the NDArrayMessage payload; returns
        the record's base offset as assigned by the broker."""
        from .streaming import NDArrayMessage

        if isinstance(arrays, np.ndarray):
            arrays = [arrays]
        batch = RecordBatch([Record(NDArrayMessage.encode(arrays))],
                            base_timestamp=int(time.time() * 1000))
        resp = parse_produce_response(self._roundtrip(
            API_PRODUCE, 3, produce_request(self.topic, self.partition,
                                            batch)))
        part = resp[self.topic][self.partition]
        if part["error_code"]:
            raise IOError(f"Kafka produce error {part['error_code']} for "
                          f"{self.topic}/{self.partition}")
        return part["base_offset"]

    def poll(self) -> List[List[np.ndarray]]:
        """Fetch records from the current offset, decode each value as an
        NDArrayMessage; advances the consumer offset."""
        from .streaming import NDArrayMessage

        resp = parse_fetch_response(self._roundtrip(
            API_FETCH, 4, fetch_request(self.topic, self.partition,
                                        self.offset)))
        part = resp[self.topic][self.partition]
        if part["error_code"]:
            raise IOError(f"Kafka fetch error {part['error_code']} for "
                          f"{self.topic}/{self.partition}")
        out = []
        for batch in part["batches"]:
            if not batch.is_control:             # skip transaction markers
                for rec in batch.records:
                    # the broker returns the WHOLE batch containing the
                    # fetch offset: records before self.offset were already
                    # delivered (mid-batch offsets happen after compaction
                    # rewrites batch boundaries) — consumer contract says
                    # discard them
                    if batch.base_offset + rec.offset_delta < self.offset:
                        continue
                    if rec.value is not None:    # skip tombstones
                        out.append(NDArrayMessage.decode(rec.value))
            # advance by lastOffsetDelta, NOT the surviving record count —
            # compacted batches otherwise re-fetch forever
            self.offset = max(self.offset, batch.next_offset)
        return out

    def close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None


class KafkaDataSetIterator(DataSetIterator):
    """``DataSetIterator`` over a real Kafka topic: each record's value is an
    ``NDArrayMessage`` of (features, labels[, masks]) — the reference's
    record→DataSet conversion role (``streaming/conversion``) against the
    real wire protocol instead of the in-process broker. Polls until
    ``num_batches`` (None → until a poll returns nothing after
    ``max_empty_polls`` tries)."""

    def __init__(self, client: NDArrayKafkaClient,
                 num_batches: Optional[int] = None, convert=None,
                 max_empty_polls: int = 3):
        self.client = client
        self.num_batches = num_batches
        self.convert = convert
        self.max_empty_polls = max_empty_polls
        self._queue: List = []
        self._seen = 0

    def __next__(self):
        if self.num_batches is not None and self._seen >= self.num_batches:
            raise StopIteration
        empty = 0
        while not self._queue:
            msgs = self.client.poll()
            if msgs:
                self._queue.extend(msgs)
                break
            empty += 1
            if empty >= self.max_empty_polls:
                raise StopIteration
        parts = self._queue.pop(0)
        self._seen += 1
        if self.convert is not None:
            return self.convert(parts)
        return DataSet(*parts[:4])

    def reset(self):
        self._seen = 0  # the topic offset does not rewind; counting restarts
