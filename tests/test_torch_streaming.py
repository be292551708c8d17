"""Streaming and Kafka of the port (``deeplearning4j_torch/datasets/
{streaming,kafka}.py``) against the JAX package's: the NDArray wire codec,
the Kafka record batches and requests are the same bytes in both packages
(each decodes what the other wrote), a port publisher and consumer work
through the JAX broker and the reverse, and a fit fed from a stream or a
Kafka topic (a stub broker, ``torch_kafka_stub.KafkaStubBroker``) equals a fit
from a ``ListDataSetIterator`` over the same batches, loss for loss and
parameter for parameter (exact: the same batches through the same code).
Oracles: ``tests/test_streaming.py``, ``tests/test_kafka.py``. Every socket
binds port 0 and every wait has a timeout; the end-of-stream test waits
for the broker to register each peer and for the first message before the
second publisher sends, so its order cannot race.
"""
import io
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import kafka as jkafka
from deeplearning4j_tpu.datasets import streaming as jstreaming

from deeplearning4j_torch import (DataSet, ListDataSetIterator, MultiLayerNetwork,
                                  NeuralNetConfiguration, Sgd)
from deeplearning4j_torch.datasets import kafka
from deeplearning4j_torch.datasets.kafka import (KafkaDataSetIterator, NDArrayKafkaClient,
                                                 Record, RecordBatch, crc32c)
from deeplearning4j_torch.datasets.streaming import (NDArrayConsumer, NDArrayMessage,
                                                     NDArrayPublisher, ServingRoute,
                                                     StreamIdleTimeout, StreamingBroker,
                                                     StreamingDataSetIterator)
from deeplearning4j_torch.nn.conf.layers import DenseLayer, OutputLayer
from torch_kafka_stub import KafkaStubBroker, LossRecorder


def _arrays():
    rng = np.random.default_rng(0)
    return [rng.normal(size=(3, 4)).astype(np.float32),
            rng.integers(0, 100, size=(5,)).astype(np.int64),
            rng.random((2, 2, 2)) > 0.5, np.asarray(np.float32(3.5)),
            rng.integers(0, 9, size=(4,)).astype(np.int16)]


def _wait(cond, what, timeout=10.0):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


def test_ndarray_message_is_the_jax_wire():
    arrays = _arrays()
    blob = NDArrayMessage.encode(arrays)
    assert blob == jstreaming.NDArrayMessage.encode(arrays)
    for back in (NDArrayMessage.decode(blob), jstreaming.NDArrayMessage.decode(blob)):
        for a, b in zip(arrays, back):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unsupported dtype"):
        NDArrayMessage.encode([np.zeros(2, np.complex64)])


@pytest.mark.parametrize("broker_pkg", ["torch", "jax"])
def test_publish_subscribe_across_the_packages(broker_pkg):
    """A port publisher and a JAX consumer (and the reverse) through
    either package's broker: bit-identical arrays in order, then the clean
    end of the stream."""
    broker = (StreamingBroker if broker_pkg == "torch" else jstreaming.StreamingBroker)()
    try:
        cons = NDArrayConsumer(broker.address, "a", timeout=10.0)
        jcons = jstreaming.NDArrayConsumer(broker.address, "b", timeout=10.0)
        subs = (broker.subscribers if broker_pkg == "torch"
                else (lambda topic: len(broker._subs.get(topic, ()))))
        _wait(lambda: subs("a") == subs("b") == 1, "SUB")
        jpub = jstreaming.NDArrayPublisher(broker.address, "a")
        pub = NDArrayPublisher(broker.address, "b")
        sent = [np.full((2, 3), i, np.float32) for i in range(4)]
        for a in sent:
            jpub.publish(a)
            pub.publish([a, a.astype(np.int64)])
        for a in sent:
            np.testing.assert_array_equal(cons.receive()[0], a)
            got = jcons.receive()
            np.testing.assert_array_equal(got[1], a.astype(np.int64))
        jpub.close()
        pub.close()
        assert cons.receive() is None and jcons.receive() is None
        cons.close()
        jcons.close()
    finally:
        broker.close()


def test_eos_waits_for_last_publisher_and_idle_timeouts():
    """EOS does not end a topic another publisher still feeds; a silent
    producer raises the retryable StreamIdleTimeout, not a quiet end."""
    broker = StreamingBroker()
    try:
        consumer = NDArrayConsumer(broker.address, "multi", timeout=10.0)
        _wait(lambda: broker.subscribers("multi") == 1, "SUB")
        p1 = NDArrayPublisher(broker.address, "multi")
        p2 = NDArrayPublisher(broker.address, "multi")
        _wait(lambda: broker.publishers("multi") == 2, "both PUBs")
        p1.publish(np.ones((1,), np.float32))
        assert float(consumer.receive()[0][0]) == 1.0
        p1.close()
        _wait(lambda: broker.publishers("multi") == 1, "p1's EOS")
        p2.publish(np.full((1,), 2, np.float32))
        p2.close()
        assert float(consumer.receive()[0][0]) == 2.0
        assert consumer.receive() is None
        consumer.close()
        idle = NDArrayConsumer(broker.address, "quiet", timeout=0.2)
        with pytest.raises(StreamIdleTimeout):
            idle.receive()
        idle.close()
    finally:
        broker.close()


def _net(seed=3):
    conf = (NeuralNetConfiguration.builder().seed(seed).updater(Sgd(learning_rate=0.1))
            .activation("tanh").list().layer(DenseLayer(n_in=6, n_out=12))
            .layer(OutputLayer(n_in=12, n_out=3, activation="softmax", loss="mcxent")).build())
    return MultiLayerNetwork(conf).init(device="cpu")


def _batches(n=4, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(8, 6)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]) for _ in range(n)]


def _fit_losses(net, it):
    rec = LossRecorder()
    net.set_listeners(rec)
    net.fit(it)
    return rec.scores


def _same_fit(make_iter, batches):
    ref, net = _net(), _net()
    want = _fit_losses(ref, ListDataSetIterator([DataSet(f, l) for f, l in batches]))
    got = _fit_losses(net, make_iter())
    assert got == want and net.iteration_count == len(batches)
    for k in ref.params:
        for n in ref.params[k]:
            assert torch.equal(net.params[k][n], ref.params[k][n]), f"{k}/{n}"


def test_streamed_fit_equals_listed_fit():
    batches = _batches()
    broker = StreamingBroker()
    try:
        consumer = NDArrayConsumer(broker.address, "train", timeout=10.0)
        _wait(lambda: broker.subscribers("train") == 1, "SUB")

        def produce():
            pub = NDArrayPublisher(broker.address, "train")
            for f, l in batches:
                pub.publish([f, l])
            pub.close()
        t = threading.Thread(target=produce, daemon=True)
        t.start()
        _same_fit(lambda: StreamingDataSetIterator(consumer, num_batches=len(batches)), batches)
        t.join(timeout=10.0)
        consumer.close()
    finally:
        broker.close()


def test_serving_route_answers_through_output_and_captures_errors():
    """Predictions equal ``output`` on the request; idle timeouts keep the
    route alive; a malformed request is stored on ``error``."""
    net = _net(seed=4)
    broker = StreamingBroker()
    try:
        fc = NDArrayConsumer(broker.address, "rin", timeout=0.2)
        pc = NDArrayConsumer(broker.address, "rout", timeout=10.0)
        _wait(lambda: broker.subscribers("rin") == broker.subscribers("rout") == 1, "SUBs")
        route = ServingRoute(net, fc, NDArrayPublisher(broker.address, "rout"))
        t = route.start()
        time.sleep(0.5)                      # two idle timeouts pass
        req = NDArrayPublisher(broker.address, "rin")
        x = np.random.default_rng(5).normal(size=(3, 6)).astype(np.float32)
        req.publish(x)
        np.testing.assert_array_equal(pc.receive()[0], net.output(x).numpy())
        assert route.served == 1 and route.error is None
        req.publish(np.zeros((2, 5), np.float32))   # wrong width
        t.join(timeout=10.0)
        with pytest.raises(Exception):
            route.check()
        req.close()
        route.publisher.close()
        fc.close()
        pc.close()
    finally:
        broker.close()


# ------------------------------------------------------------------- Kafka
def test_crc32c_varints_and_batches_are_the_jax_bytes():
    """The published CRC vector, the slice-by-8 walk against a bytewise
    one, zigzag varints, and record batches (headers, keys, tombstones,
    control and compacted batches) the same bytes as JAX's, each package
    decoding the other's."""
    assert crc32c(b"123456789") == 0xE3069283
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 8, 9, 63, 1000):
        data = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        assert crc32c(data) == jkafka.crc32c(data)
    for v in (0, 1, -1, 63, -64, 2 ** 31, -(2 ** 40)):
        buf = io.BytesIO()
        kafka.write_varint(buf, v)
        jbuf = io.BytesIO()
        jkafka.write_varint(jbuf, v)
        assert buf.getvalue() == jbuf.getvalue()
        assert kafka.read_varint(io.BytesIO(buf.getvalue())) == v
    value = NDArrayMessage.encode([np.arange(6, dtype=np.float32)])
    cases = [(dict(records=[Record(value, key=b"k", headers=[("h", b"v")])],
                   base_timestamp=1234), None),
             (dict(records=[Record(None), Record(b"y")]), None),
             (dict(records=[Record(b"x")], base_offset=10, last_offset_delta=5), 16),
             (dict(records=[Record(b"m")], attributes=0x20), None)]
    for kw, next_off in cases:
        jkw = dict(kw, records=[jkafka.Record(r.value, key=r.key, headers=r.headers)
                                for r in kw["records"]])
        wire = RecordBatch(**kw).encode()
        assert wire == jkafka.RecordBatch(**jkw).encode()
        for back in (RecordBatch.decode(wire), jkafka.RecordBatch.decode(wire)):
            assert [r.value for r in back.records] == [r.value for r in kw["records"]]
            if next_off is not None:
                assert back.next_offset == next_off
    assert RecordBatch.decode(RecordBatch(**cases[3][0]).encode()).is_control
    bad = bytearray(RecordBatch([Record(b"z")]).encode())
    bad[-1] ^= 1
    with pytest.raises(Exception):
        RecordBatch.decode(bytes(bad))
    batch = RecordBatch([Record(value)])
    assert kafka.produce_request("t", 0, batch) == jkafka.produce_request(
        "t", 0, jkafka.RecordBatch([jkafka.Record(value)]))
    assert kafka.fetch_request("t", 0, 5) == jkafka.fetch_request("t", 0, 5)


def test_kafka_clients_of_both_packages_share_a_topic():
    """Through the stub broker: records the JAX client produced are polled
    by the port's and the reverse; offsets advance; a consumer placed
    mid-batch discards what it has seen."""
    broker = KafkaStubBroker()
    try:
        a = np.arange(12, dtype=np.float32).reshape(3, 4)
        jprod = jkafka.NDArrayKafkaClient(broker.address, "t")
        prod = NDArrayKafkaClient(broker.address, "t", timeout=10.0)
        assert jprod.publish([a, np.ones((2, 2))]) == 0
        assert prod.publish(np.full((5,), 7.0, np.float32)) == 1
        for cons in (NDArrayKafkaClient(broker.address, "t", timeout=10.0),
                     jkafka.NDArrayKafkaClient(broker.address, "t")):
            polled = cons.poll()
            np.testing.assert_array_equal(polled[0][0], a)
            np.testing.assert_array_equal(polled[1][0], np.full((5,), 7.0, np.float32))
            assert cons.offset == 2 and cons.poll() == []
            cons.close()
        late = NDArrayKafkaClient(broker.address, "t", timeout=10.0)
        late.offset = 1
        assert [m[0].shape for m in late.poll()] == [(5,)]
        late.close()
        prod.close()
        jprod.close()
    finally:
        broker.close()


def test_kafka_fed_fit_equals_listed_fit():
    batches = _batches(seed=9)
    broker = KafkaStubBroker()
    try:
        prod = NDArrayKafkaClient(broker.address, "train", timeout=10.0)
        for f, l in batches:
            prod.publish([f, l])
        prod.close()
        cons = NDArrayKafkaClient(broker.address, "train", timeout=10.0)
        _same_fit(lambda: KafkaDataSetIterator(cons, num_batches=len(batches)), batches)
        cons.close()
    finally:
        broker.close()
