"""Helpers shared by the port's streaming tests and ``chip_smoke.py``: an
in-process Kafka stub broker and a listener that keeps each minibatch's
loss. Not a test module (pytest collects ``test_*.py`` only);
``chip_smoke.py`` puts this directory on ``sys.path`` to import it.
"""
import io
import socket
import struct
import threading

from deeplearning4j_torch.datasets.kafka import API_FETCH, API_PRODUCE, RecordBatch
from deeplearning4j_torch.optimize.listeners import TrainingListener


class KafkaStubBroker:
    """An in-process Kafka broker for one partition a topic: Produce v3
    stores the batch (its base offset rewritten as a log append does),
    Fetch v4 returns every batch that reaches the fetch offset, over real
    sockets in the Kafka size framing (the port's counterpart of the JAX
    suite's stub, ``tests/test_kafka.py:75``)."""

    def __init__(self):
        self.store = {}
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(4)
        self.sock.settimeout(0.5)
        self.port = self.sock.getsockname()[1]
        self.address = f"127.0.0.1:{self.port}"
        self._running = True
        self._t = threading.Thread(target=self._serve, daemon=True)
        self._t.start()

    def _serve(self):
        while self._running:
            try:
                c, _ = self.sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            c.settimeout(60.0)
            threading.Thread(target=self._client, args=(c,), daemon=True).start()

    @staticmethod
    def _recv_exact(c, n):
        data = bytearray()
        while len(data) < n:
            chunk = c.recv(n - len(data))
            if not chunk:
                raise ConnectionError("client closed")
            data.extend(chunk)
        return bytes(data)

    def _client(self, c):
        try:
            while True:
                size = struct.unpack(">i", self._recv_exact(c, 4))[0]
                payload = self._recv_exact(c, size)
                api_key, _, corr = struct.unpack(">hhi", payload[:8])
                clen = struct.unpack(">h", payload[8:10])[0]
                body = payload[10 + max(0, clen):]
                resp = (self._produce(body) if api_key == API_PRODUCE else
                        self._fetch(body) if api_key == API_FETCH else b"")
                out = struct.pack(">i", corr) + resp
                c.sendall(struct.pack(">i", len(out)) + out)
        except OSError:
            pass
        finally:
            c.close()

    def _produce(self, body):
        r = io.BytesIO(body)
        r.read(max(0, struct.unpack(">h", r.read(2))[0]))   # transactional id
        r.read(6 + 4)                                        # acks, timeout, topics
        topic = r.read(struct.unpack(">h", r.read(2))[0]).decode()
        r.read(4)                                            # partitions
        pid = struct.unpack(">i", r.read(4))[0]
        rec = r.read(struct.unpack(">i", r.read(4))[0])
        log_ = self.store.setdefault((topic, pid), [])
        base = sum(len(RecordBatch.decode(b, verify_crc=False).records) for b in log_)
        log_.append(struct.pack(">q", base) + rec[8:])
        return (struct.pack(">i", 1) + struct.pack(">h", len(topic)) + topic.encode()
                + struct.pack(">i", 1) + struct.pack(">ihqq", pid, 0, base, -1)
                + struct.pack(">i", 0))

    def _fetch(self, body):
        r = io.BytesIO(body)
        r.read(17 + 4)                                       # replica .. isolation, topics
        topic = r.read(struct.unpack(">h", r.read(2))[0]).decode()
        r.read(4)
        pid = struct.unpack(">i", r.read(4))[0]
        offset = struct.unpack(">q", r.read(8))[0]
        batches, total = [], 0
        for wire in self.store.get((topic, pid), []):
            n = len(RecordBatch.decode(wire, verify_crc=False).records)
            if total + n > offset:
                batches.append(wire)
            total += n
        recs = b"".join(batches)
        return (struct.pack(">i", 0) + struct.pack(">i", 1) + struct.pack(">h", len(topic))
                + topic.encode() + struct.pack(">i", 1)
                + struct.pack(">ihqq", pid, 0, total, -1) + struct.pack(">i", 0)
                + struct.pack(">i", len(recs)) + recs)

    def close(self):
        self._running = False
        self.sock.close()


class LossRecorder(TrainingListener):
    """A listener keeping each minibatch's loss."""

    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, score):
        self.scores.append(float(score))
