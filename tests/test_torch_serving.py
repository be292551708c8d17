"""The port's serving tier on the CPU: HTTP front door, batcher, registry.

A small char-RNN (2 x GravesLSTM(16), softmax output) on ``device="cpu"``
is served by the port's ``InferenceServer`` on port 0. Concurrent requests
must come back as the rows ``model.output`` gives for the same inputs
(the batcher pads batch and time and strips both again; tolerance 1e-5,
the same f32 arithmetic on other batch compositions), and the typed
failures must map to 404, 400, 429 and 504.
"""
import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from deeplearning4j_torch import (InferenceServer, MultiLayerNetwork,
                                  NeuralNetConfiguration)
from deeplearning4j_torch.nn.conf.layers import GravesLSTM, RnnOutputLayer
from deeplearning4j_torch.serving import (ContinuousBatcher, DeadlineExceededError,
                                          OverloadedError)

V, H = 10, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread per test worker leaves the other
    cores to the workers running other test files."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _net():
    conf = (NeuralNetConfiguration.builder().seed(3).activation("tanh").list()
            .layer(GravesLSTM(n_in=V, n_out=H)).layer(GravesLSTM(n_in=H, n_out=H))
            .layer(RnnOutputLayer(n_in=H, n_out=V, activation="softmax"))
            .build())
    return MultiLayerNetwork(conf).init(device="cpu")


def _onehot(rng, b, t):
    return np.eye(V, dtype=np.float32)[rng.integers(0, V, (b, t))]


def _post(port, name, body):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/models/{name}/predict",
                                 data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture()
def server():
    srv = InferenceServer()
    net = _net()
    srv.register("masked", net, device="cpu", time_buckets=(4, 8, 12),
                 linger_ms=20.0, batch_buckets=(1, 2, 4, 8, 16))
    srv.register("fixed", net, device="cpu", linger_ms=20.0)
    srv.register("tiny", net, device="cpu", max_queue_examples=1)
    port = srv.start(port=0)
    yield srv, net, port
    srv.stop()


def test_concurrent_requests_return_model_output_rows(server):
    srv, net, port = server
    rng = np.random.default_rng(0)
    jobs = [("masked", _onehot(rng, int(rng.integers(1, 5)), int(t)))
            for t in (3, 4, 7, 9, 12, 5)]
    jobs += [("fixed", _onehot(rng, int(rng.integers(1, 5)), 8)) for _ in range(6)]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        replies = list(pool.map(lambda j: _post(port, j[0], {"inputs": j[1].tolist()}),
                                jobs))
    for (name, x), (code, doc) in zip(jobs, replies):
        assert code == 200, doc
        assert doc["model"] == name
        got = np.asarray(doc["outputs"], np.float32)
        want = net.output(x).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_listing_and_error_codes(server):
    srv, net, port = server
    code, doc = _get(port, "/v1/models")
    assert code == 200 and [m["name"] for m in doc["models"]] == ["fixed", "masked", "tiny"]
    assert _get(port, "/v1/models/masked")[1]["time_buckets"] == [4, 8, 12]
    assert _get(port, "/v1/models/nope")[0] == 404
    x = _onehot(np.random.default_rng(1), 2, 4).tolist()
    assert _post(port, "nope", {"inputs": x})[0] == 404
    assert _post(port, "masked", b"{not json")[0] == 400
    assert _post(port, "masked", {"outputs": x})[0] == 400
    assert _post(port, "masked", {"inputs": x, "deadline_ms": -1})[0] == 400
    # longer than the largest time bucket, more rows than the largest bucket
    assert _post(port, "masked", {"inputs": _onehot(np.random.default_rng(2), 1, 13).tolist()})[0] == 400
    assert _post(port, "masked", {"inputs": _onehot(np.random.default_rng(2), 17, 4).tolist()})[0] == 400
    code, doc = _post(port, "tiny", {"inputs": x})          # 2 examples > cap of 1
    assert code == 429 and "overloaded" in doc["error"]
    code, doc = _post(port, "fixed", {"inputs": x, "deadline_ms": 1e-3})
    assert code == 504 and "deadline" in doc["error"]


def test_drain_on_close_serves_every_accepted_request():
    calls = []
    gate = threading.Event()

    def forward(xs):
        gate.wait(10)
        calls.append(xs.shape[0])
        return xs * 2

    b = ContinuousBatcher(forward, device=torch.device("cpu"), batch_buckets=(1, 2, 4),
                          linger_ms=1e4)
    futs = [b.submit(np.full((1, 3), float(i), np.float32)) for i in range(3)]
    gate.set()
    b.close(drain=True, timeout=10)
    assert [f.result(1)[0, 0] for f in futs] == [0.0, 2.0, 4.0]
    assert sum(calls) == 4                    # one flush, padded 3 -> 4
    with pytest.raises(OverloadedError):
        b.submit(np.zeros((1, 3), np.float32))


def test_close_without_drain_fails_queued_and_deadlines_expire():
    b = ContinuousBatcher(lambda xs: xs, device=torch.device("cpu"), batch_buckets=(1, 4),
                          linger_ms=1e4)
    fut = b.submit(np.zeros((1, 2), np.float32))
    b.close(drain=False, timeout=10)
    with pytest.raises(OverloadedError):
        fut.result(1)
    b2 = ContinuousBatcher(lambda xs: xs, device=torch.device("cpu"), batch_buckets=(1, 4),
                           linger_ms=1e4)
    try:
        with pytest.raises(DeadlineExceededError):
            b2.submit(np.zeros((1, 2), np.float32), deadline_ms=1.0).result(10)
    finally:
        b2.close()


def test_device_staging_pads_on_the_device_and_returns_host_rows():
    seen = []

    def forward(xs, mask):
        seen.append((type(xs), tuple(xs.shape), tuple(mask.shape)))
        return xs.sum(-1)

    b = ContinuousBatcher(forward, batch_buckets=(4,), time_buckets=(6,),
                          device=torch.device("cpu"), linger_ms=1.0)
    try:
        x = np.ones((3, 5, 2), np.float32)
        y = b.submit(x).result(10)
    finally:
        b.close()
    assert seen == [(torch.Tensor, (4, 6, 2), (4, 6))]
    assert isinstance(y, np.ndarray) and y.shape == (3, 5)
    np.testing.assert_array_equal(y, 2.0)


def test_registration_checks_the_model_device():
    from deeplearning4j_torch.serving import ServedModel

    class OnTheCard:
        device = torch.device("cuda", 0)

        def output(self, x):
            return x

    with pytest.raises(ValueError, match="lives on"):
        ServedModel("m", OnTheCard(), device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        ServedModel("m", _net(), device="meta")
