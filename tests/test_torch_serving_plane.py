"""The rest of the port's serving tier against the JAX package's: the
precision flip, the closed signature set, the response cache, request
tracing, admission, golden sets and the monitor routes of a serving
replica.

The nets are JAX nets moved into the port through the model zip (a
char-RNN, 2 x GravesLSTM(16) over 10 characters, and a dense classifier),
served on ``device="cpu"``. Tolerances: a bf16-served answer within 5e-2
of JAX's f32 output (the serving tier's bf16 atol); an f32 served row bit
for bit equal to the same bucket's forward, and within 1e-6 of the
unbatched forward (other batch compositions, other sum orders); cache
keys, hit/miss sequences, cache occupancy, signature sets, trace-header
parses and golden inputs exactly equal to JAX's.
"""
import hashlib
import json
import threading
import time
import urllib.error
import urllib.request

import ml_dtypes
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import (NeuralNetConfiguration as JConf, MultiLayerNetwork as JNet,
                                Sgd as JSgd)
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.serving import batcher as jbatcher
from deeplearning4j_tpu.serving import (ContinuousBatcher as JBatcher,
                                        parse_trace_header as jparse)
from deeplearning4j_tpu.serving.registry import ServedModel as JServed
from deeplearning4j_tpu.utils.model_serializer import ModelSerializer

from deeplearning4j_torch.monitor import get_flight_recorder, get_jit_registry, get_tracer
from deeplearning4j_torch.parallel import InferenceMode, ParallelInference
from deeplearning4j_torch.serving import (ContinuousBatcher, DeadlineExceededError,
                                          InferenceServer, ModelRegistry, OverloadedError,
                                          PROBE_HEADER, TRACE_HEADER, parse_trace_header)
from deeplearning4j_torch.serving import batcher as pbatcher
from deeplearning4j_torch.utils.model_serializer import restore_model

V, H = 10, 16
BF16_ATOL = 5e-2
UNBATCHED_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _clean():
    get_flight_recorder().clear()
    get_jit_registry().drain_storms()
    yield
    get_jit_registry().drain_storms()


def _jchar_rnn(seed=5):
    conf = (JConf.builder().seed(seed).updater(JSgd(learning_rate=0.1)).activation("tanh")
            .list().layer(jl.GravesLSTM(n_in=V, n_out=H)).layer(jl.GravesLSTM(n_in=H, n_out=H))
            .layer(jl.RnnOutputLayer(n_in=H, n_out=V, activation="softmax", loss="mcxent"))
            .build())
    return JNet(conf).init()


def _jdense(seed=11):
    conf = (JConf.builder().seed(seed).updater(JSgd(learning_rate=0.1)).activation("tanh")
            .list().layer(jl.DenseLayer(n_in=6, n_out=16))
            .layer(jl.OutputLayer(n_in=16, n_out=4, activation="softmax", loss="mcxent"))
            .build())
    return JNet(conf).init()


def _port(jnet, tmp_path, name):
    path = str(tmp_path / name)
    ModelSerializer.write_model(jnet, path)
    return restore_model(path, device="cpu")


def _onehot(rng, b, t):
    return np.eye(V, dtype=np.float32)[rng.integers(0, V, (b, t))]


class Stub:
    """A duck-typed model (the JAX suite's stub): every row the sum of the
    batch's first feature; a call log. At bf16 it gets a CPU bf16 tensor.
    With a ``gate`` (an Event) each call waits for it after logging."""

    def __init__(self, delay_s=0.0, gate=None):
        self.delay_s, self.gate, self.calls = delay_s, gate, []

    def output(self, x, mask=None):
        if isinstance(x, torch.Tensor):
            x = x.float().numpy()
        self.calls.append(np.asarray(x).shape)
        if self.gate is not None:
            assert self.gate.wait(30)
        if self.delay_s:
            time.sleep(self.delay_s)
        x = np.asarray(x, np.float32)
        return np.full((x.shape[0], 2), float(x.reshape(x.shape[0], -1)[:, 0].sum()),
                       np.float32)


def _http(port, path, body=None, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            raw = r.read().decode()
            return r.status, (json.loads(raw) if r.headers.get_content_type()
                              == "application/json" else raw)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


# ------------------------------------------------------------ precision
def test_precision_flip_both_ways_and_bf16_within_atol_of_jax(tmp_path):
    """A bf16 registration flips every layer to bf16 and answers within
    5e-2 of JAX's f32 output as float32 rows; a later f32 registration of
    the same net flips it back, and its answers equal the f32 twin's."""
    jnet = _jchar_rnn()
    net, twin = _port(jnet, tmp_path, "a.zip"), _port(jnet, tmp_path, "b.zip")
    reg = ModelRegistry()
    reg.register("bf", net, device="cpu", time_buckets=(4, 8), batch_buckets=(2, 4),
                 linger_ms=1.0, input_shape=(8, V), warmup=True, precision="bf16")
    assert {str(im.compute_dtype) for im in net.impls} == {"torch.bfloat16"}
    assert net.gc.compute_dtype == "bfloat16"
    rng = np.random.default_rng(0)
    xs = [_onehot(rng, int(rng.integers(1, 5)), int(rng.integers(2, 9))) for _ in range(5)]
    for x in xs:
        y = reg.predict("bf", x)
        assert y.dtype == np.float32 and y.shape == x.shape
        np.testing.assert_allclose(y, np.asarray(jnet.output(x)), rtol=0, atol=BF16_ATOL)
    reg.close_all()
    reg2 = ModelRegistry()
    reg2.register("back", net, device="cpu", time_buckets=(4, 8), batch_buckets=(2, 4),
                  linger_ms=1.0)
    assert {str(im.compute_dtype) for im in net.impls} == {"torch.float32"}
    twin_reg = ModelRegistry()
    twin_reg.register("twin", twin, device="cpu", time_buckets=(4, 8), batch_buckets=(2, 4),
                      linger_ms=1.0)
    for x in xs:
        np.testing.assert_array_equal(reg2.predict("back", x), twin_reg.predict("twin", x))
    reg2.close_all()
    twin_reg.close_all()
    with pytest.raises(ValueError):
        ModelRegistry().register("bad", Stub(), device="cpu", precision="f16")


def test_compile_signatures_equal_jax_and_closed_under_churn(tmp_path):
    """The closed set equals JAX's for the same buckets at both
    precisions; after warmup, request-size churn adds no first call of
    ``mln/output`` and no retrace storm, and the signatures seen are the
    closed set's."""
    for prec in ("f32", "bf16"):
        for tb, shape in ((None, (6,)), ((4, 8), (8, V))):
            mine = ContinuousBatcher(lambda x, m=None: x, batch_buckets=(1, 2, 4),
                                     time_buckets=tb, precision=prec)
            theirs = JBatcher(lambda x, m=None: x, batch_buckets=(1, 2, 4), time_buckets=tb,
                              precision=prec)
            try:
                assert mine.compile_signatures(shape) == theirs.compile_signatures(shape)
            finally:
                mine.close()
                theirs.close()
    net = _port(_jchar_rnn(), tmp_path, "c.zip")
    reg = ModelRegistry()
    served = reg.register("churn", net, device="cpu", time_buckets=(4, 8),
                          batch_buckets=(1, 2, 4), linger_ms=2.0, input_shape=(8, V),
                          warmup=True)
    wrapper = net._jit_output[(False, True)]
    sigs = served.batcher.compile_signatures((8, V))
    assert wrapper.compiles == len(sigs)
    get_flight_recorder().clear()
    rng = np.random.default_rng(1)
    futs = [reg.submit("churn", _onehot(rng, int(rng.integers(1, 5)), int(rng.integers(1, 9))))
            for _ in range(12)]
    for f in futs:
        f.result(30)
    assert wrapper.compiles == len(sigs)
    assert not [e for e in get_flight_recorder().events() if e["event"] == "retrace_storm"]
    want = {f"[0][0]=float32[{s[0]},{s[1]},{s[2]}];[0][1]=float32[{s[0]},{s[1]}]"
            for s, _, _ in sigs}
    assert set(wrapper.signatures) == want
    reg.close_all()


def test_served_row_equals_its_bucket_forward_bit_for_bit(tmp_path):
    """A served f32 row is the same bucket's forward (padded rows, padded
    time, the zero mask on the padding) bit for bit, and the unbatched
    forward within 1e-6."""
    net = _port(_jchar_rnn(seed=7), tmp_path, "d.zip")
    reg = ModelRegistry()
    reg.register("rows", net, device="cpu", time_buckets=(4, 8), batch_buckets=(4,),
                 linger_ms=1.0)
    x = _onehot(np.random.default_rng(2), 3, 6)
    y = reg.predict("rows", x)
    reg.close_all()
    xp = np.zeros((4, 8, V), np.float32)
    xp[:3, :6] = x
    mask = np.zeros((4, 8), np.float32)
    mask[:3, :6] = 1.0
    bucket = net.output(xp, mask=mask).numpy()[:3, :6]
    np.testing.assert_array_equal(y, bucket)
    np.testing.assert_allclose(y, net.output(x).numpy(), rtol=0, atol=UNBATCHED_ATOL)


# ------------------------------------------------------- response cache
def test_content_keys_equal_jax_and_bf16_rounding_shares_an_entry():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5)).astype(np.float32)
    assert pbatcher._content_key(torch.from_numpy(x)) == jbatcher._content_key(x)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert pbatcher._content_key(xb) == jbatcher._content_key(x.astype(ml_dtypes.bfloat16))
    exact = xb.float().numpy()              # on the bf16 grid
    nudged = exact * np.float32(1 + 2.0 ** -12)   # less than half a bf16 step away
    assert not np.array_equal(nudged, exact)
    assert torch.equal(torch.from_numpy(nudged).to(torch.bfloat16), xb)
    stub = Stub()
    b = ContinuousBatcher(stub.output, batch_buckets=(1, 2), linger_ms=0.0, cache_size=8,
                          precision="bf16")
    try:
        first = b.submit(exact).result(5)
        hit = b.submit(nudged)
        assert hit.done() and hit.result(0).tobytes() == first.tobytes()
        assert len(stub.calls) == 1
    finally:
        b.close()


def test_cache_hits_and_lru_by_examples_equal_jax_on_one_stream():
    """One request stream through the port's and JAX's batchers (capacity
    5 examples): the same hit/miss sequence, the same occupancy after
    each request, bit-equal answers."""
    rng = np.random.default_rng(4)
    pool = [rng.normal(size=(int(n), 3)).astype(np.float32) for n in (1, 2, 2, 1, 3)]
    stream = [pool[i] for i in (0, 1, 0, 2, 3, 1, 4, 0, 2, 2, 3, 4)]
    runs = []
    for make in (ContinuousBatcher, JBatcher):
        stub = Stub()
        b = make(stub.output, batch_buckets=(1, 2, 4), linger_ms=0.0, cache_size=5)
        seen = []
        try:
            for x in stream:
                fut = b.submit(x)
                hit = fut.done()
                seen.append((hit, fut.result(5).tobytes(), tuple(b.cache_stats().values())))
        finally:
            b.close()
        runs.append(seen)
    assert runs[0] == runs[1]
    assert any(h for h, _, _ in runs[0]) and not all(h for h, _, _ in runs[0])


def test_probe_bypasses_the_cache_and_a_hit_launches_nothing(tmp_path):
    """A probe request neither reads nor fills the cache; a hit resolves
    at submit without a flush span or a forward call."""
    srv = InferenceServer()
    stub = Stub()
    srv.register("stub", stub, device="cpu", batch_buckets=(1, 2), linger_ms=0.0,
                 cache_size=8)
    port = srv.start(port=0)
    try:
        x = [[1.0, 2.0, 3.0]]
        probe = {PROBE_HEADER: "1"}
        assert _http(port, "/v1/models/stub/predict", {"inputs": x}, probe)[0] == 200
        assert srv.registry.get("stub").batcher.cache_stats()["entries"] == 0
        _http(port, "/v1/models/stub/predict", {"inputs": x})
        calls = len(stub.calls)
        get_tracer().clear()
        code, doc = _http(port, "/v1/models/stub/predict", {"inputs": x})
        assert code == 200 and len(stub.calls) == calls
        assert not [e for e in get_tracer().events() if e["name"] == "serving/flush"]
        _http(port, "/v1/models/stub/predict", {"inputs": x}, probe)
        assert len(stub.calls) == calls + 1
    finally:
        srv.stop()


# -------------------------------------------------------------- tracing
@pytest.mark.parametrize("value", [None, "", "abc:def", "zz:1", "0:1", "1" * 17 + ":2",
                                   "ffffffffffffffff:1", "7:8:9"])
def test_parse_trace_header_equals_jax(value):
    mine, theirs = parse_trace_header(value), jparse(value)
    assert (mine is None) == (theirs is None)
    if mine is not None:
        assert (mine.trace_id, mine.span_id) == (theirs.trace_id, theirs.span_id)


def test_trace_header_joins_the_request_to_its_flush(tmp_path):
    """``X-DL4J-Trace`` joins the caller's trace: the response carries its
    trace id, and ``/trace`` holds the request's ``serving/queue_wait``
    span linked to a ``serving/flush`` span; the latency histogram's
    exemplar is a trace id."""
    net = _port(_jdense(), tmp_path, "e.zip")
    srv = InferenceServer()
    srv.register("dense", net, device="cpu", batch_buckets=(2, 4), linger_ms=1.0)
    port = srv.start(port=0)
    try:
        code, doc = _http(port, "/v1/models/dense/predict",
                          {"inputs": np.ones((3, 6)).tolist()}, {TRACE_HEADER: "abc123:77"})
        assert code == 200 and doc["trace_id"] == "abc123"
        code, trace = _http(port, "/trace")
        evs = trace["traceEvents"]
        waits = [e for e in evs if e["name"] == "serving/queue_wait"
                 and e["args"]["trace_id"] == "abc123"]
        flushes = {e["args"]["span_id"] for e in evs if e["name"] == "serving/flush"}
        assert waits and waits[0]["args"]["flush_span_id"] in flushes
        assert [e for e in evs if e["name"] == "http/predict"
                and e["args"]["trace_id"] == "abc123"]
    finally:
        srv.stop()


# ------------------------------------------------------------ admission
def _until(cond, timeout=30.0):
    end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < end, "condition not reached"
        time.sleep(0.005)


def test_429_504_drain_flush_and_set_admission():
    """The scheduler is held inside a gated forward, so the queue's state
    is known: a full queue answers 429, and a request whose deadline
    passes in the queue answers 504."""
    gate = threading.Event()
    stub = Stub(gate=gate)
    reg = ModelRegistry()
    slow = reg.register("slow", stub, device="cpu", batch_buckets=(1, 2),
                        max_queue_examples=2, linger_ms=0.0)
    srv = InferenceServer(reg)
    port = srv.start(port=0)
    one = np.ones((1, 1), np.float32)
    try:
        busy = slow.batcher.submit(one)
        _until(lambda: len(stub.calls) == 1)        # the scheduler holds it
        queued = [slow.batcher.submit(one) for _ in range(2)]
        assert _http(port, "/v1/models/slow/predict", {"inputs": [[1.0]]})[0] == 429
        gate.set()
        assert all(f.result(30).shape == (1, 2) for f in [busy] + queued)
        gate.clear()
        busy = slow.batcher.submit(one)
        _until(lambda: len(stub.calls) == 3)
        got = []
        late = threading.Thread(target=lambda: got.append(_http(
            port, "/v1/models/slow/predict", {"inputs": [[1.0]], "deadline_ms": 1e-3})))
        late.start()
        _until(lambda: slow.batcher.queue_depth() == 1)
        gate.set()
        late.join(30)
        assert got[0][0] == 504 and busy.result(30).shape == (1, 2)
        prev = slow.set_admission(max_queue_examples=16, linger_ms=50.0)
        assert prev == {"max_queue_examples": 2, "linger_ms": 0.0}
        assert (slow.batcher.max_queue_examples, slow.batcher.linger_ms) == (16, 50.0)
        with pytest.raises(ValueError):
            slow.set_admission(max_queue_examples=0)
        with pytest.raises(ValueError):
            slow.set_admission(linger_ms=-1)
    finally:
        srv.stop()
    b = ContinuousBatcher(lambda xs: np.asarray(xs) * 2, batch_buckets=(4,), linger_ms=1e4)
    try:
        futs = [b.submit(np.full((1, 2), float(i), np.float32)) for i in range(3)]
        assert not futs[0].done() and b.flush(wait=True, timeout=10)
        assert [f.result(0)[0, 0] for f in futs] == [0.0, 2.0, 4.0]
        late = [b.submit(np.ones((1, 2), np.float32)) for _ in range(2)]
        with pytest.raises(DeadlineExceededError):
            b.submit(np.ones((1, 2), np.float32), deadline_ms=1.0).result(10)
    finally:
        b.close(drain=True)
    assert all(f.result(0).shape == (1, 2) for f in late)
    with pytest.raises(OverloadedError):
        b.submit(np.ones((1, 2), np.float32))


def test_parallel_inference_batched_runs_on_the_serving_batcher(tmp_path):
    net = _port(_jdense(), tmp_path, "f.zip")
    pi = ParallelInference(net, mode=InferenceMode.BATCHED, devices=["cpu"] * 2,
                           batch_limit=8, queue_limit=4, flush_after_ms=5.0)
    x = np.random.default_rng(5).normal(size=(3, 6)).astype(np.float32)
    try:
        np.testing.assert_allclose(pi.submit(x).result(30), net.output(x).numpy(), rtol=0,
                                   atol=UNBATCHED_ATOL)
        b = pi._batcher
        assert isinstance(b, ContinuousBatcher) and b.queue_policy == "flush"
        assert (b.max_batch, b.max_queue_requests, b.max_queue_examples) == (8, 4, None)
    finally:
        pi.close()


# --------------------------------------------------- listing and golden
def test_model_rows_match_jax_keys(tmp_path):
    jnet = _jdense()
    srv = InferenceServer()
    srv.register("dense", _port(jnet, tmp_path, "g.zip"), device="cpu", batch_buckets=(2, 4),
                 precision="bf16", cache_size=4, input_shape=(6,))
    port = srv.start(port=0)
    theirs = JServed("dense", jnet, batch_buckets=(2, 4), precision="bf16", cache_size=4,
                     input_shape=(6,))
    try:
        code, doc = _http(port, "/v1/models")
        row = doc["models"][0]
        jrow = theirs.stats()
        assert set(row) - {"device"} == set(jrow)
        for k in ("name", "model", "batch_buckets", "time_buckets", "max_queue_examples",
                  "linger_ms", "default_deadline_ms", "precision", "cache_size", "cache",
                  "aot_signatures", "golden_version"):
            assert row[k] == jrow[k], k
        assert _http(port, "/v1/models/dense")[1] == row
    finally:
        srv.stop()
        theirs.close()


def test_golden_inputs_equal_jax_and_the_version_recipe(tmp_path):
    jnet = _jdense(seed=13)
    mine = ModelRegistry().register("g", _port(jnet, tmp_path, "h.zip"), device="cpu",
                                    batch_buckets=(2, 4), input_shape=(6,))
    theirs = JServed("g", jnet, batch_buckets=(2, 4), input_shape=(6,))
    try:
        a, b = mine.golden(examples=3), theirs.golden(examples=3)
    finally:
        mine.close()
        theirs.close()
    xa, xb = np.asarray(a["inputs"], np.float32), np.asarray(b["inputs"], np.float32)
    assert xa.tobytes() == xb.tobytes()
    np.testing.assert_allclose(a["outputs"], b["outputs"], rtol=0, atol=1e-5)

    def recipe(g):
        h = hashlib.sha256()
        h.update(np.asarray(g["inputs"], np.float32).tobytes())
        h.update(np.asarray(g["outputs"], np.float32).tobytes())
        h.update(g["precision"].encode())
        return h.hexdigest()[:16]
    assert a["version"] == recipe(a) and b["version"] == recipe(b)
    assert (a["atol"], a["precision"]) == (b["atol"], b["precision"]) == (1e-4, "f32")
    if np.asarray(a["outputs"], np.float32).tobytes() == \
            np.asarray(b["outputs"], np.float32).tobytes():
        assert a["version"] == b["version"]


def test_monitor_routes_of_a_serving_replica(tmp_path):
    """``/metrics`` carries the serving series, ``/profile`` its serving
    block (and text), ``/healthz``, ``/history``, ``/events``, ``/fleet``
    and ``/fleet/trace`` answer; ``/alerts``, ``/probes`` and ``/telemetry``
    answer with the JAX package's document keys; the routes of unported
    planes (``/control``, ``/incidents``) 404."""
    srv = InferenceServer()
    srv.register("routes", _port(_jdense(), tmp_path, "i.zip"), device="cpu",
                 batch_buckets=(2, 4), linger_ms=1.0)
    port = srv.start(port=0)
    try:
        assert _http(port, "/v1/models/routes/predict", {"inputs": np.ones((2, 6)).tolist()})[0] \
            == 200
        code, metrics = _http(port, "/metrics")
        assert 'serving_requests_total{model="routes",outcome="ok"} 1' in metrics
        assert 'jit_calls_total{fn="mln/output"}' in metrics
        code, rep = _http(port, "/profile")
        assert rep["serving"]["routes"]["requests"]["ok"] == 1
        assert "p99_ms" in rep["serving"]["routes"]["latency_ms"]
        assert "# serving (per hosted model)" in _http(port, "/profile?format=text")[1]
        assert _http(port, "/healthz")[0] == 200
        assert set(_http(port, "/history")[1]) >= {"interval_s", "capacity", "samples"}
        assert _http(port, "/history?metric=serving_qps")[1]["metric"] == "serving_qps"
        assert _http(port, "/history?metric=x&seconds=z")[0] == 400
        assert "events" in _http(port, "/events")[1]
        assert _http(port, "/fleet")[0] == 200 and _http(port, "/fleet?format=json")[0] == 200
        assert "traceEvents" in _http(port, "/fleet/trace")[1]
        code, alerts = _http(port, "/alerts")
        assert code == 200 and set(alerts) == {"alerts", "firing", "pending", "evaluated_at"}
        code, probes = _http(port, "/probes")
        assert code == 200 and set(probes) == {"interval_s", "timeout_s", "fail_threshold",
                                               "running", "targets"}
        code, tel = _http(port, "/telemetry")
        assert code == 200 and set(tel) == {"registry", "trace_events", "flight_events",
                                            "last_seq", "health", "exemplars"}
        assert tel["flight_events"] == []
        assert _http(port, "/telemetry?since_seq=x")[0] == 400
        for path in ("/control", "/incidents"):
            assert _http(port, path)[0] == 404
    finally:
        srv.stop()
