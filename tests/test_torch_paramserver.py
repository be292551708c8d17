"""The port's parameter server (``deeplearning4j_torch/paramserver/``) and
native host codec (``deeplearning4j_torch/ops/native.py``) against the
JAX package's.

The wire is the contract: a port client drives a JAX ``ParameterServer``
and a JAX client drives a port server through the same script (SET/PULL,
INIT, quantized and exact PUSH, round-robin shard pulls, PULL_DELTA,
server-side residual, typed errors), and every answer must be bit-equal to
the same script on a JAX client and server. The training master is held
on its counters and versions (``tests/test_paramserver.py:238``) and
against JAX's master on the same networks (carried over in the model zip)
and batches: parameters at PARAM_ATOL (f32 rounding of differently ordered
gradient sums, measured under 1e-7). The native library must be bit-equal
to the numpy plain versions. Every socket binds port 0 and every client
has a timeout.
"""
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import (NeuralNetConfiguration as JConf, MultiLayerNetwork as JNet,
                                DataSet as JDataSet, ListDataSetIterator as JList,
                                Sgd as JSgd)
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.parallel.accumulation import serialize_encoded as jserialize
from deeplearning4j_tpu import paramserver as jps
from deeplearning4j_tpu.utils.model_serializer import ModelSerializer

from deeplearning4j_torch import DataSet, ListDataSetIterator
from deeplearning4j_torch import paramserver as ps
from deeplearning4j_torch.monitor.health import get_health
from deeplearning4j_torch.ops import native
from deeplearning4j_torch.parallel import DistributedMultiLayerNetwork
from deeplearning4j_torch.parallel.accumulation import serialize_encoded
from deeplearning4j_torch.paramserver.server import DELTA_FRAMES, DELTA_FRESH, DELTA_FULL
from deeplearning4j_torch.utils.model_serializer import restore_model

PARAM_ATOL = 1e-6
PKG = {"jax": jps, "torch": ps}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _client(mod, srv, **kw):
    kw.setdefault("max_retries", 2)
    kw.setdefault("backoff", 0.01)
    kw.setdefault("timeout", 10.0)
    return mod.ParameterServerClient(srv.address, **kw)


def _wire_script(srv_mod, cli_mod):
    """Every op of the protocol, its answers recorded for comparison."""
    out = []
    rng = np.random.default_rng(0)
    vec = rng.normal(size=103).astype(np.float32)
    with srv_mod.ParameterServer(port=0, num_shards=4) as srv, \
            _client(cli_mod, srv) as c, _client(cli_mod, srv) as c2:
        out.append(c.init_params(vec))
        out.append(c2.init_params(np.ones(103, np.float32)))   # second INIT: not seeded
        v, got = c.pull()
        out.append((v, got.tobytes()))
        out.append(c.set_params(vec * 2))
        q = serialize_encoded((np.array([0, 5, 102], np.int32),
                               np.array([1, -1, 1], np.int8), 0.5, 103))
        x = serialize_encoded((np.array([3, 7], np.int32),
                               np.array([0.125, -1e-8], np.float32), 0.0, 103))
        out.append(c.push_update(q))
        out.append(c.push_update(x))
        out.append([(v, p.tobytes()) for v, p in (c.pull(shard=s) for s in range(4))])
        v, full = c.pull_sharded(4)
        out.append((v, full.tobytes()))
        v, mode, frames = c.pull_delta(v - 2)
        out.append((v, mode, [bytes(f) for f in frames]))
        out.append(c.pull_delta(v, slack=0)[:2])
        v, mode, body = c.pull_delta(v + 5)        # ahead of the server: full resync
        out.append((v, mode, body.tobytes()))
        out.append(c.server_version())
        stats = c.stats()
        out.append({k: stats[k] for k in ("version", "n", "num_shards", "proto", "threshold",
                                          "journal_len")})
        for bad in (lambda: c.push_update(b"garbage-frame"), lambda: c.pull(shard=9)):
            with pytest.raises(cli_mod.ParameterServerError):
                bad()
        assert c.send_telemetry() is True
    with srv_mod.ParameterServer(port=0, threshold=0.5) as srv, _client(cli_mod, srv) as c:
        c.set_params(np.zeros(6, np.float32))
        frame = serialize_encoded((np.array([0], np.int32), np.array([1], np.int8), 0.2, 6))
        for _ in range(3):
            c.push_update(frame)
            out.append(c.pull()[1].tobytes())
    return out


@pytest.mark.parametrize("server,client", [("jax", "torch"), ("torch", "jax"),
                                           ("torch", "torch")])
def test_wire_is_bit_exact_between_the_packages(server, client):
    """Each op's answer is bit-equal to the JAX client against the JAX
    server, in both cross directions and between two port peers."""
    want = _wire_script(jps, jps)
    got = _wire_script(PKG[server], PKG[client])
    assert got == want
    assert want[2][1] == np.random.default_rng(0).normal(size=103).astype(np.float32).tobytes()
    modes = [want[8][1], want[9][1], want[10][1]]
    assert modes == [DELTA_FRAMES, DELTA_FRESH, DELTA_FULL]


def test_port_server_keeps_op_stats_and_telemetry():
    """Until the monitor planes are ported, the server keeps per-op
    counters, wire bytes, uptime and each worker's last report."""
    with ps.ParameterServer(port=0) as srv, _client(ps, srv, worker_id="w-1") as c:
        c.set_params(np.zeros(3, np.float32))
        c.pull()
        c.pull()
        assert c.send_telemetry()
        stats = c.stats()
        assert stats["proto"] == 3 and stats["uptime_s"] >= 0.0
        assert (stats["ops"]["set"], stats["ops"]["pull"], stats["ops"]["push"]) == (1, 2, 0)
        assert stats["ops"]["telemetry"] == 1 and stats["ops"]["stats"] >= 1
        assert stats["wire"]["pull"]["tx"] == 2 * (1 + 12 + 12)
        assert c.wire["pull"] == {"tx": 2 * (1 + 4), "rx": 2 * (1 + 12 + 12)}
        assert set(srv.telemetry) == {"w-1"}
        assert srv.telemetry["w-1"]["report"]["registry"]["paramserver"]["counters"]["pulls"] == 2


def test_client_fault_model_and_health():
    """Retries, then a typed ServerUnavailableError naming the server;
    the process health turns unhealthy and recovers on the next answered
    request; a dropped connection is absorbed; a restarted server restores
    its snapshot (version, values, residual)."""
    get_health().reset()
    srv = ps.ParameterServer(port=0, threshold=0.5)
    port = srv.port
    c = _client(ps, srv, max_retries=3, backoff_max=0.05)
    c.set_params(np.zeros(4, np.float32))
    frame = serialize_encoded((np.array([1], np.int32), np.array([1], np.int8), 0.3, 4))
    c.push_update(frame)                               # 0.3 stays in the residual
    c._sock.close()
    c.pull()
    assert c.metrics.counters["retries"] >= 1
    snap = srv.snapshot()
    srv.stop()
    t0 = time.monotonic()
    with pytest.raises(ps.ServerUnavailableError) as ei:
        c.pull()
    assert time.monotonic() - t0 < 5.0 and srv.address in str(ei.value)
    assert not get_health().snapshot()["healthy"]
    assert get_health().snapshot()["paramserver"]["errors"] == 1
    with ps.ParameterServer(port=port, threshold=0.5, restore=snap) as srv2, \
            _client(ps, srv2) as fresh:
        v, out = fresh.pull()
        assert v == snap[0]
        fresh.push_update(frame)                       # 0.6 >= 0.5: applies -0.5
        np.testing.assert_array_equal(fresh.pull()[1], np.array([0, -0.5, 0, 0], np.float32))
        assert get_health().snapshot()["healthy"]
    get_health().reset()


def test_concurrent_pushes_lose_no_update():
    """More client threads than cores push exact frames at once (switch
    interval shortened): every push applies once, the version counts
    them, the values are the sum."""
    import sys
    import threading

    n, workers, pushes = 64, 16, 5
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ps.ParameterServer(port=0, num_shards=3) as srv:
            with _client(ps, srv) as c:
                v0 = c.set_params(np.zeros(n, np.float32))
            errors = []

            def work(w):
                try:
                    with _client(ps, srv) as cw:
                        for k in range(pushes):
                            idx = np.array([w, (w + k + 1) % n], np.int32)
                            cw.push_update(serialize_encoded(
                                (idx, np.array([-1.0, -0.5], np.float32), 0.0, n)))
                except Exception as e:      # noqa: BLE001 - re-raised below
                    errors.append(e)
            threads = [threading.Thread(target=work, args=(w,)) for w in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30.0)
            assert not errors and not any(t.is_alive() for t in threads)
            with _client(ps, srv) as c:
                v, out = c.pull()
    finally:
        sys.setswitchinterval(old)
    want = np.zeros(n, np.float32)
    for w in range(workers):
        for k in range(pushes):
            want[w] += 1.0
            want[(w + k + 1) % n] += 0.5
    assert v == v0 + workers * pushes
    np.testing.assert_array_equal(out, want)


def test_bounded_staleness_and_latency_histogram():
    with ps.ParameterServer(port=0) as srv, _client(ps, srv, staleness=2) as c:
        v = c.set_params(np.zeros(4, np.float32))
        assert c.pull_if_stale(v) is None
        frame = serialize_encoded((np.array([1], np.int32), np.array([1], np.int8), 0.5, 4))
        c.push_update(frame)
        c.push_update(frame)
        assert c.pull_if_stale(v) is None
        c.push_update(frame)
        new_v, out = c.pull_if_stale(v)
        assert new_v == v + 3 and out[1] == -1.5
        assert c.metrics.counters["staleness_hits"] == 2
    h, jh = ps.LatencyHistogram(), jps.LatencyHistogram()
    assert h.summary() == {}
    for ms in (0.2, 0.5, 1.0, 2.0, 100.0):
        h.record(ms)
        jh.record(ms)
    assert h.summary() == jh.summary()


# ----------------------------------------------------------- the master
def _toy(seed=11, lr=5e-2):
    conf = (JConf.builder().seed(seed).updater(JSgd(learning_rate=lr)).activation("tanh")
            .list().layer(jl.DenseLayer(n_in=6, n_out=16))
            .layer(jl.OutputLayer(n_in=16, n_out=4, activation="softmax", loss="mcxent"))
            .build())
    return JNet(conf).init()


def _port(jnet, tmp_path, name="m.zip"):
    path = str(tmp_path / name)
    ModelSerializer.write_model(jnet, path)
    return restore_model(path, device="cpu")


def _batches(n=8, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(16, 6)).astype(np.float32),
             np.eye(4, dtype=np.float32)[rng.integers(0, 4, 16)]) for _ in range(n)]


def test_master_counts_ops_and_matches_jax_master(tmp_path):
    """Staleness 1, threshold 1e-3, 8 batches x 4 epochs: the loss falls,
    32 pushes in the client's metrics and the server's, version 33 (INIT +
    32 pushes), staleness skips; the parameters equal the JAX master's on
    the same network and batches."""
    jnet = _toy()
    net = _port(jnet, tmp_path)
    data = _batches()
    with ps.ParameterServer(port=0) as srv, jps.ParameterServer(port=0) as jsrv:
        m = ps.ParameterServerTrainingMaster.Builder(srv.address).staleness(1) \
            .threshold(1e-3).backoff(0.01).build()
        s0 = net.score(DataSet.merge([DataSet(f, l) for f, l in data]))
        DistributedMultiLayerNetwork(net, m).fit(
            ListDataSetIterator([DataSet(f, l) for f, l in data]), epochs=4)
        assert net.score(DataSet.merge([DataSet(f, l) for f, l in data])) < s0
        snap = m.client.metrics.snapshot()
        assert snap["counters"]["pushes"] == 32 and snap["push_latency"]["n"] == 32
        assert snap["counters"]["staleness_hits"] > 0 and snap["counters"]["pulls"] >= 1
        stats = m.client.stats()
        assert stats["counters"]["pushes"] == 32 and stats["version"] == 33
        assert [e["kind"] for e in m.events][:2] == ["worker_join", "worker_leave"]
        jm = jps.ParameterServerTrainingMaster.Builder(jsrv.address).staleness(1) \
            .threshold(1e-3).backoff(0.01).build()
        from deeplearning4j_tpu.parallel import DistributedMultiLayerNetwork as JDist
        JDist(jnet, jm).fit(JList([JDataSet(f, l) for f, l in data]), epochs=4)
        np.testing.assert_allclose(ps.flatten_params(net.params),
                                   jps.flatten_params(jnet.params), rtol=0, atol=PARAM_ATOL)
        m.close()
        jm.close()


def test_master_join_rejoin_switch_mismatch_and_flat_roundtrip(tmp_path):
    """A later worker adopts the server's state; a master reused with
    another net resets its accumulator; a different architecture is a
    typed error; flatten/set round-trips and refuses a wrong length."""
    net_a, net_b = _port(_toy(seed=1), tmp_path, "a.zip"), _port(_toy(seed=2), tmp_path, "b.zip")
    data = [DataSet(f, l) for f, l in _batches(n=2)]
    with ps.ParameterServer(port=0) as srv:
        m = ps.ParameterServerTrainingMaster(srv.address, threshold=1e-2, backoff=0.01)
        m.execute_training(net_a, ListDataSetIterator(data))
        assert m.accumulator._residual is not None
        m.execute_training(net_b, ListDataSetIterator([]))
        assert m.accumulator._residual is None
        np.testing.assert_array_equal(ps.flatten_params(net_b.params),
                                      ps.flatten_params(net_a.params))
        assert [e["kind"] for e in m.events] == ["worker_join", "worker_leave",
                                                 "worker_rejoin", "worker_leave"]
        small = (JConf.builder().seed(1).updater(JSgd(learning_rate=5e-2)).list()
                 .layer(jl.DenseLayer(n_in=6, n_out=4))
                 .layer(jl.OutputLayer(n_in=4, n_out=4, activation="softmax", loss="mcxent"))
                 .build())
        other = _port(JNet(small).init(), tmp_path, "o.zip")
        m2 = ps.ParameterServerTrainingMaster(srv.address, backoff=0.01)
        with pytest.raises(ps.ParameterServerError, match="different model"):
            m2.execute_training(other, ListDataSetIterator([]))
        m2.close()
        m.close()
    vec = ps.flatten_params(net_a.params)
    assert vec.size == net_a.num_params()
    np.testing.assert_array_equal(vec, jps.flatten_params(
        {k: {n: t.numpy() for n, t in v.items()} for k, v in net_a.params.items()}))
    new = np.random.default_rng(5).normal(size=vec.size).astype(np.float32)
    ps.set_params_from_flat(net_a, new)
    np.testing.assert_array_equal(ps.flatten_params(net_a.params), new)
    with pytest.raises(ValueError):
        ps.set_params_from_flat(net_a, new[:-1])
    with pytest.raises(NotImplementedError, match="A 15b"):
        ps.ParameterServerTrainingMaster("127.0.0.1:1,127.0.0.1:2")._ensure_client()


def test_master_server_death_and_count_own_pushes(tmp_path):
    """Killing the server mid-fit surfaces ServerUnavailableError with
    finite parameters; ``count_own_pushes=False`` turns a lone worker's
    per-step pulls into staleness skips (12 pushes, 1 rejoin pull)."""
    net = _port(_toy(), tmp_path)
    data = [DataSet(f, l) for f, l in _batches(n=4)]
    srv = ps.ParameterServer(port=0)
    m = ps.ParameterServerTrainingMaster(srv.address, staleness=0, max_retries=2,
                                         backoff=0.01)

    class KillAfter:
        left = 2

        def iteration_done(self, model, iteration, score):
            KillAfter.left -= 1
            if KillAfter.left == 0:
                srv.stop()

    net.set_listeners(KillAfter())
    try:
        with pytest.raises(ps.ServerUnavailableError):
            m.execute_training(net, ListDataSetIterator(data))
        assert np.all(np.isfinite(ps.flatten_params(net.params)))
        assert m.events[-1]["kind"] == "worker_leave"
    finally:
        srv.stop()
        get_health().reset()
    net = _port(_toy(seed=4), tmp_path, "b.zip")
    with ps.ParameterServer(port=0) as srv:
        m = ps.ParameterServerTrainingMaster(srv.address, staleness=0, backoff=0.01,
                                             count_own_pushes=False)
        DistributedMultiLayerNetwork(net, m).fit(
            ListDataSetIterator([DataSet(f, l) for f, l in _batches(n=6, seed=9)]), epochs=2)
        snap = m.client.metrics.snapshot()["counters"]
        assert (snap["pushes"], snap["pulls"], snap["staleness_hits"]) == (12, 1, 12)
        m.close()


def test_metrics_listener_rows_on_bus(tmp_path):
    net = _port(_toy(), tmp_path)
    with ps.ParameterServer(port=0) as srv:
        m = ps.ParameterServerTrainingMaster(srv.address, backoff=0.01)
        lst = ps.ParamServerMetricsListener(m._ensure_client(), frequency=2)
        net.set_listeners(lst)
        m.execute_training(net, ListDataSetIterator([DataSet(f, l) for f, l in _batches(4)]))
        assert len(lst.rows) == 2
        assert lst.rows[-1]["counters"]["pushes"] >= 3 and "iteration" in lst.rows[-1]
        m.close()


# ---------------------------------------------------------- native codec
def test_native_codec_bit_equal_to_numpy():
    """The C++ library (built at first use) against the numpy plain
    versions: indices, signs, residuals, bitmaps and decodes bit for bit,
    on a gradient-like vector with entries at and around the threshold."""
    native.load()
    assert native.library_path().exists()
    rng = np.random.default_rng(0)
    g = (rng.normal(size=100_003) * 0.01).astype(np.float32)
    g[:4] = [0.01, -0.01, np.nextafter(np.float32(0.01), np.float32(0)), 0.0]
    for thr in (0.01, 1e-3):
        for a, b in zip(native.threshold_encode(g, thr), native.threshold_encode_plain(g, thr)):
            np.testing.assert_array_equal(a, b)
        idx, signs, _ = native.threshold_encode(g, thr)
        np.testing.assert_array_equal(native.threshold_decode(idx, signs, thr, g.shape),
                                      native.threshold_decode_plain(idx, signs, thr, g.shape))
        bm, k, res = native.bitmap_encode(g, thr)
        pbm, pk, pres = native.bitmap_encode_plain(g, thr)
        np.testing.assert_array_equal(bm, pbm)
        np.testing.assert_array_equal(res, pres)
        assert k == pk == int((np.abs(g) >= thr).sum())
        np.testing.assert_array_equal(native.bitmap_decode(bm, g.size, thr),
                                      native.bitmap_decode_plain(bm, g.size, thr))
        assert bm.nbytes == ((g.size + 15) // 16) * 4


def test_native_parsers_and_accumulator_route(tmp_path):
    """IDX and CSV through the library against the Python parsers; the
    accumulator's codec is the library's (decoded + residual == update)."""
    from deeplearning4j_tpu.datasets.fetchers import read_idx, write_idx
    from deeplearning4j_torch.parallel import EncodedGradientsAccumulator

    arr = np.random.default_rng(2).integers(0, 255, size=(20, 28, 28)).astype(np.uint8)
    p = str(tmp_path / "imgs-idx3-ubyte")
    write_idx(p, arr)
    np.testing.assert_array_equal(native.idx_read(p), read_idx(p))
    assert native.idx_read(p + ".gz") is None
    rows = np.random.default_rng(3).normal(size=(50, 4)).astype(np.float32)
    csv = tmp_path / "data.csv"
    csv.write_text("h1,h2,h3,h4\n" + "\n".join(",".join(f"{v:.6f}" for v in r) for r in rows))
    np.testing.assert_allclose(native.csv_read_f32(str(csv), skip_lines=1), rows, atol=1e-6)
    acc = EncodedGradientsAccumulator(initial_threshold=0.05)
    grads = {"0": {"W": (np.random.default_rng(4).normal(size=(32, 32)) * 0.1
                         ).astype(np.float32)}}
    decoded = acc.store_update(grads)
    np.testing.assert_allclose(decoded["0"]["W"] + acc._residual.reshape(32, 32),
                               grads["0"]["W"], atol=1e-6)
    idx, signs, thr, n = acc.last_encoded
    want = native.threshold_encode_plain(grads["0"]["W"].ravel(), thr)
    np.testing.assert_array_equal(idx, want[0])
    np.testing.assert_array_equal(signs, want[1])
    assert acc.serialize_last() == jserialize(acc.last_encoded)
