"""The port's probe plane (``deeplearning4j_torch/monitor/probes.py``,
``/probes`` and ``alerts.default_probe_rules``) against the JAX package's,
across the wire both ways.

- A port replica serves a char-RNN (2 x GravesLSTM(16) over 10
  characters) whose weights came from JAX through the model zip; the
  port's ``Prober`` and a JAX ``Prober`` probe it with the port's golden
  set tick for tick: the same outcomes, ``ok`` while healthy and
  ``mismatch`` once the served output layer is perturbed in place, and
  one ``probe_target_failing`` edge each. A port prober probes a JAX
  replica with JAX's golden set the same way.
- SLIs, the deadman, trace ids on the replica's ``/trace``, health
  problems, down targets, the lifecycle, the lock and the rule pack.
- JAX's gray-failure drill with its replicas in this process: a replica
  that answers fast but wrong while every self-reported surface stays
  green is caught by ``probe_mismatch`` and ``probe_deadman`` only. The
  drill's control-plane restart (``ControlPlane`` with
  ``probe_failure_policy``) waits for the port's control plane; here the
  test restarts the replica itself.

The JAX side runs on planes of its own for each test (its ``get_*``
functions patched to private instances); the port's process-wide
registry, flight recorder, fleet table, tracer and health are cleared
around each test. Tolerance: a golden set's own ``atol`` (1e-4 at f32).
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import (NeuralNetConfiguration as JConf, MultiLayerNetwork as JNet,
                                Sgd as JSgd)
from deeplearning4j_tpu.monitor import alerts as jalerts, probes as jprobes
from deeplearning4j_tpu.monitor import (fleet as jfleet, flightrec as jflightrec,
                                        health as jhealth, registry as jregistry,
                                        tracer as jtracer)
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.serving import InferenceServer as JServer
from deeplearning4j_tpu.utils.model_serializer import ModelSerializer

from deeplearning4j_torch.monitor import (ProbeTarget, Prober, default_probe_rules, get_fleet,
                                          get_flight_recorder, get_health, get_prober,
                                          get_registry, get_tracer, lockwatch)
from deeplearning4j_torch.serving import InferenceServer
from deeplearning4j_torch.utils.model_serializer import restore_model

V, H, T = 10, 16, 8


@pytest.fixture(autouse=True)
def _fresh_port_planes():
    for plane in (get_registry(), get_flight_recorder(), get_fleet(), get_tracer()):
        plane.clear()
    get_health().reset()
    yield
    for plane in (get_registry(), get_flight_recorder(), get_fleet(), get_tracer()):
        plane.clear()
    get_health().reset()


@pytest.fixture
def jax_planes(monkeypatch):
    planes = {"reg": jregistry.MetricsRegistry(), "rec": jflightrec.FlightRecorder(),
              "tracer": jtracer.Tracer(), "fleet": jfleet.FleetState(),
              "health": jhealth.HealthState()}
    monkeypatch.setattr(jregistry, "get_registry", lambda: planes["reg"])
    monkeypatch.setattr(jflightrec, "get_flight_recorder", lambda: planes["rec"])
    monkeypatch.setattr(jtracer, "get_tracer", lambda: planes["tracer"])
    monkeypatch.setattr(jfleet, "get_fleet", lambda: planes["fleet"])
    monkeypatch.setattr(jhealth, "get_health", lambda: planes["health"])
    return planes


def _jchar_rnn(seed=5):
    conf = (JConf.builder().seed(seed).updater(JSgd(learning_rate=0.1)).activation("tanh")
            .list().layer(jl.GravesLSTM(n_in=V, n_out=H)).layer(jl.GravesLSTM(n_in=H, n_out=H))
            .layer(jl.RnnOutputLayer(n_in=H, n_out=V, activation="softmax", loss="mcxent"))
            .build())
    return JNet(conf).init()


def _port(jnet, tmp_path):
    path = str(tmp_path / "char_rnn.zip")
    ModelSerializer.write_model(jnet, path)
    return restore_model(path, device="cpu")


CHAR = dict(time_buckets=(4, T), batch_buckets=(2, 4), input_shape=(T, V), linger_ms=0.0,
            cache_size=8)


class GrayModel:
    """The first two columns doubled; ``wrong`` adds 37 (fast, 200, wrong)."""

    def __init__(self):
        self.wrong = False

    def output(self, x, mask=None):
        out = np.asarray(x, np.float32)[:, :2] * 2.0
        return out + 37.0 if self.wrong else out


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, json.loads(r.read().decode("utf-8"))
    except urllib.error.HTTPError as e:
        body = json.loads(e.read().decode("utf-8"))
        e.close()
        return e.code, body


def _predict(port, inputs, model="drill"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/models/{model}/predict",
                                 data=json.dumps({"inputs": inputs}).encode("utf-8"),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read().decode("utf-8"))


def _events(rec, name, **match):
    return [e for e in rec.events() if e["event"] == name
            and all(e.get(k) == v for k, v in match.items())]


def _trace_ids(port):
    return {(e.get("args") or {}).get("trace_id")
            for e in _get(port, "/trace")[1]["traceEvents"]}


def _gray_server(name="drill"):
    srv = InferenceServer()
    model = GrayModel()
    served = srv.register(name, model, device="cpu", input_shape=(4,), batch_buckets=(1, 2),
                          linger_ms=0.0, max_queue_examples=64, cache_size=16)
    golden = served.golden()
    return srv, srv.start(port=0), model, golden


# ------------------------------------------------------------ targets
def test_probe_target_normalisation_and_validation_equal_jax():
    g = {"model": "m", "inputs": [[1.0, 2.0]], "outputs": [[2.0, 4.0]], "atol": 1e-3,
         "version": "abc"}
    for url in ("127.0.0.1:9/", "http://127.0.0.1:9", "https://h:1//"):
        assert ProbeTarget("t", url, g).to_dict() == jprobes.ProbeTarget("t", url, g).to_dict()
    assert ProbeTarget("t", "h:1", {**g, "atol": None}).atol == \
        jprobes.ProbeTarget("t", "h:1", {**g, "atol": None}).atol == 1e-4
    for bad, kw in (({"inputs": [[1.0]]}, {}), ("x", {}), ({**g, "model": ""}, {})):
        with pytest.raises(ValueError) as mine:
            ProbeTarget("t", "h:1", bad, **kw)
        with pytest.raises(ValueError) as theirs:
            jprobes.ProbeTarget("t", "h:1", bad, **kw)
        assert str(mine.value) == str(theirs.value)


def test_char_rnn_golden_in_jax_format(tmp_path):
    """The port's golden set of the char-RNN has JAX's keys, JAX's inputs
    and outputs within the f32 ``atol`` of JAX's own golden."""
    jnet = _jchar_rnn()
    srv = InferenceServer()
    mine = srv.register("char", _port(jnet, tmp_path), device="cpu", **CHAR).golden()
    jsrv = JServer()
    theirs = jsrv.register("char", jnet, **CHAR).golden()
    try:
        assert set(mine) == set(theirs)
        assert (mine["model"], mine["precision"], mine["atol"]) == \
            (theirs["model"], theirs["precision"], theirs["atol"]) == ("char", "f32", 1e-4)
        assert np.asarray(mine["inputs"], np.float32).tobytes() == \
            np.asarray(theirs["inputs"], np.float32).tobytes()
        np.testing.assert_allclose(mine["outputs"], theirs["outputs"], rtol=0, atol=1e-5)
    finally:
        srv.stop()
        jsrv.stop()


# ------------------------------------------------------- across the wire
def _lockstep(probers, ticks, t0):
    outs = []
    for k in range(ticks):
        outs.append([p.tick(now=t0 + k)["outcomes"] for p in probers])
    return outs


def test_port_and_jax_probers_agree_on_a_port_replica(tmp_path, jax_planes):
    """Both probers, the port's golden set: ``ok`` x3, then ``mismatch`` x3
    after the served output layer's W is negated in place (no version
    bump), then ``ok`` again once restored; one failing and one recovered
    edge each; nothing lands in the response cache."""
    srv = InferenceServer()
    net = _port(_jchar_rnn(), tmp_path)
    served = srv.register("char", net, device="cpu", **CHAR)
    golden = served.golden()
    port = srv.start(port=0)
    mine, theirs = Prober(timeout_s=10.0), jprobes.Prober(timeout_s=10.0)
    for p in (mine, theirs):
        p.add_target("replica", f"127.0.0.1:{port}", golden)
    w = net.params["2"]["W"]
    try:
        healthy = _lockstep((mine, theirs), 3, 1000.0)
        with torch.no_grad():
            w.neg_()                               # exactly undone below
        wrong = _lockstep((mine, theirs), 3, 1003.0)
        with torch.no_grad():
            w.neg_()
        back = _lockstep((mine, theirs), 1, 1006.0)
        assert healthy == [[{"replica": "ok"}] * 2] * 3
        assert wrong == [[{"replica": "mismatch"}] * 2] * 3
        assert back == [[{"replica": "ok"}] * 2]
        for rec in (get_flight_recorder(), jax_planes["rec"]):
            fails = _events(rec, "probe_target_failing", target="replica")
            assert len(fails) == 1 and fails[0]["outcome"] == "mismatch"
            assert fails[0]["trace_id"] in _trace_ids(port)
            assert len(_events(rec, "probe_target_recovered", target="replica")) == 1
        assert served.stats()["cache"]["entries"] == 0
        snaps = [p.snapshot()["targets"]["replica"] for p in (mine, theirs)]
        for key in ("golden_version", "atol", "last_outcome", "consecutive_failures", "probes"):
            assert snaps[0][key] == snaps[1][key], key
    finally:
        srv.stop()


def test_port_prober_on_a_jax_replica(jax_planes):
    """The port's prober with JAX's golden set on a JAX replica: ``ok``,
    and ``mismatch`` once the JAX model answers wrong; the probe's trace
    id lands on the JAX replica's tracer."""
    jsrv = JServer()
    model = GrayModel()
    golden = jsrv.register("drill", model, input_shape=(4,), batch_buckets=(1, 2),
                           linger_ms=0.0).golden()
    port = jsrv.start(port=0)
    p = Prober(timeout_s=10.0)
    p.add_target("jax", f"127.0.0.1:{port}", golden)
    try:
        assert p.tick(now=10.0)["outcomes"] == {"jax": "ok"}
        model.wrong = True
        assert [p.tick(now=11.0 + k)["outcomes"] for k in range(2)] == [{"jax": "mismatch"}] * 2
        assert len(_events(get_flight_recorder(), "probe_target_failing", target="jax")) == 1
        tid = p.snapshot()["targets"]["jax"]["last_trace_id"]
        assert tid in {(e.get("args") or {}).get("trace_id")
                       for e in jax_planes["tracer"].export()["traceEvents"]}
    finally:
        jsrv.stop()


# ---------------------------------------------------------- the prober
def test_ok_probe_lands_slis_and_a_resolvable_trace():
    srv, port, _, golden = _gray_server("ok")
    p = Prober()
    try:
        p.add_target("u_ok", f"127.0.0.1:{port}", golden)
        res = p.tick(now=time.time())
        assert res["probed"] == ["u_ok"] and res["outcomes"] == {"u_ok": "ok"}
        snap = p.snapshot()["targets"]["u_ok"]
        assert snap["golden_version"] == golden["version"] and snap["consecutive_failures"] == 0
        assert snap["last_trace_id"] in _trace_ids(port)
        dump = p.probe_dump()
        oks = [r["value"] for r in dump["probe_requests_total"]["children"]
               if r["labels"] == {"target": "u_ok", "model": "ok", "outcome": "ok"}]
        assert oks == [1.0]
        assert [r["value"] for r in dump["probe_last_success_age_s"]["children"]] == [0.0]
        assert len(p.history.samples()) == 1
        assert _get(port, "/v1/models/ok")[1]["cache"]["entries"] == 0
    finally:
        srv.stop()


def test_mismatch_holds_the_deadman_and_edges_once():
    """Fast but wrong answers: the deadman grows, the failing edge fires
    once, ``fail_threshold`` failures land one ``health_problem`` (kind
    probe), a fixed golden recovers."""
    srv, port, _, good = _gray_server("wrong")
    bad = {**good, "outputs": (np.asarray(good["outputs"], np.float32) + 5.0).tolist()}
    p = Prober(fail_threshold=2)
    rec = get_flight_recorder()
    try:
        p.add_target("u_mm", f"127.0.0.1:{port}", bad)
        t0 = time.time()
        for k in range(3):
            assert p.tick(now=t0 + k)["outcomes"] == {"u_mm": "mismatch"}
        assert p.snapshot()["targets"]["u_mm"]["consecutive_failures"] == 3
        assert [t.label for t in p.failing_targets()] == ["u_mm"]
        ages = [pt["value"] for pt in p.history.series("probe_last_success_age_s")["points"]]
        assert max(ages) >= 2.0
        assert len(_events(rec, "probe_target_failing", target="u_mm")) == 1
        probs = _events(rec, "health_problem", kind="probe")
        assert len(probs) == 1 and "u_mm" in probs[0]["message"]
        assert any(pr.startswith("probe:") for pr in get_health().snapshot()["problems"])
        assert get_health().snapshot()["healthy"] is True
        p.add_target("u_mm", f"127.0.0.1:{port}", good)
        assert p.tick(now=t0 + 3)["outcomes"] == {"u_mm": "ok"}
        assert len(_events(rec, "probe_target_recovered", target="u_mm")) == 1
        assert "u_mm: mismatch" not in p.failure_detail()
    finally:
        srv.stop()


def test_down_target_is_an_error_and_removal_retires_its_series():
    g = {"model": "m", "inputs": [[1.0]], "outputs": [[1.0]]}
    p = Prober(timeout_s=0.2, fail_threshold=99)
    p.add_target("u_gone", "127.0.0.1:9", g)
    res = p.tick(now=time.time())
    assert res["outcomes"] == {"u_gone": "error"} and "u_gone" in res["errors"]
    assert p.last_failure_trace() == p.snapshot()["targets"]["u_gone"]["last_trace_id"]
    assert "u_gone: error" in p.failure_detail()
    p.remove_target("u_gone")
    fam = p.probe_dump().get("probe_last_success_age_s")
    assert not fam or not [r for r in fam["children"] if r["labels"]["target"] == "u_gone"]


def test_lifecycle_route_and_the_lock_is_a_leaf():
    """``start`` is idempotent and probes at once, ``stop`` joins; under
    the lockwatch ``Prober._lock`` is acquired and never held while
    another lock is taken; ``/probes`` answers with JAX's keys;
    ``get_prober`` is one idle process-wide prober."""
    prev = lockwatch.enabled()
    lockwatch.set_enabled(True)
    lockwatch.get_lockwatch().clear()
    srv, port, _, golden = _gray_server()
    try:
        p = Prober()
        p.add_target("u", f"127.0.0.1:{port}", golden)
        p.start(interval_s=120.0)
        p.start()
        assert p.running() and "prober" in [t.name for t in threading.enumerate()]
        deadline = time.monotonic() + 20
        while p.snapshot()["targets"]["u"]["last_outcome"] != "ok" \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert p.snapshot()["targets"]["u"]["last_outcome"] == "ok"
        p.stop()
        assert not p.running() and "prober" not in [t.name for t in threading.enumerate()]
        watch = lockwatch.get_lockwatch()
        assert watch.contention_table()["Prober._lock"]["acquisitions"] > 0
        assert not [e for e in watch.observed_edges() if e[0] == "Prober._lock"]
        code, doc = _get(port, "/probes")
        assert code == 200 and set(doc) == set(jprobes.Prober().snapshot())
    finally:
        srv.stop()
        lockwatch.set_enabled(prev)
        lockwatch.get_lockwatch().clear()
    assert get_prober() is get_prober()
    assert not get_prober().running() and get_prober().targets() == []


def test_probe_rule_pack_walks_like_jax(jax_planes):
    """``default_probe_rules`` wired to each prober, both probing one port
    replica whose golden goes wrong then right at the same synthetic
    times: the same states at every tick; ``probe_mismatch`` fires with
    the guilty target in its detail and the probe's trace id; both
    resolve."""
    srv, port, _, good = _gray_server("rw")
    bad = {**good, "outputs": (np.asarray(good["outputs"], np.float32) + 9.0).tolist()}
    probers = [Prober(fail_threshold=99), jprobes.Prober(fail_threshold=99)]
    for p, pack in zip(probers, (default_probe_rules, jalerts.default_probe_rules)):
        rules = pack(p, windows=(1.5, 3.0), deadman_s=2.0, for_seconds=0.2)
        assert rules[2].exemplar_lookup == p.last_failure_trace
        assert rules[3].detail_lookup == p.failure_detail
        p.engine.add(*rules)
    assert [r.name for r in probers[0].engine.rules()] == \
        [r.name for r in probers[1].engine.rules()]
    edges = []
    probers[0].engine.subscribe(lambda ev, pl: edges.append((ev, dict(pl))))
    walks = ([], [])
    t0 = time.time()
    try:
        for step, golden in enumerate([good] * 7 + [bad] * 8 + [good] * 12):
            for p, walk in zip(probers, walks):
                p.add_target("u_rule", f"127.0.0.1:{port}", golden)
                p.tick(now=t0 + 0.5 * step)
                walk.append({r.name: r.state for r in p.engine.rules()})
        assert walks[0] == walks[1]
        states = [w["probe_mismatch"] for w in walks[0]]
        assert "PENDING" in states and "FIRING" in states and states[-1] == "OK"
        assert "FIRING" in [w["probe_deadman"] for w in walks[0]]
        assert set(walks[0][-1].values()) == {"OK"}
        fired = [pl for ev, pl in edges if ev == "alert_firing" and pl["rule"] == "probe_mismatch"]
        assert len(fired) == 1 and "u_rule" in fired[0]["detail"]
        assert fired[0]["exemplar_trace_id"] in _trace_ids(port)
        assert {pl["rule"] for ev, pl in edges if ev == "alert_resolved"} >= \
            {"probe_mismatch", "probe_deadman"}
    finally:
        for p in probers:
            p.engine.clear()
        srv.stop()


# ------------------------------------------------------ the gray drill
def test_gray_failure_drill_in_process():
    """JAX's gray-failure drill with in-process replicas: r1 answers fast
    and wrong while its ``/healthz`` and ``/telemetry`` stay green and a
    cached right answer keeps serving normal traffic; ``probe_mismatch``
    and ``probe_deadman`` walk PENDING -> FIRING naming r1 with a trace id
    r1's ``/trace`` resolves; a restarted r1 recovers every rule; no probe
    lands in a response cache; the incident reads back from ``/events``."""
    rec = get_flight_recorder()
    host = InferenceServer()
    host_port = host.start(port=0)
    prober = Prober(timeout_s=10.0, fail_threshold=3)
    edges = []
    prober.engine.subscribe(lambda ev, pl: edges.append((ev, dict(pl))))
    prober.engine.add(*default_probe_rules(prober, windows=(1.5, 3.0), deadman_s=2.0,
                                           for_seconds=0.2))
    servers, states, step = [], [], [0]

    def beat():
        step[0] += 1
        res = prober.tick(now=t0 + 0.5 * step[0])
        states.append({r.name: r.state for r in prober.engine.rules()})
        return res

    try:
        s0, port0, _, golden0 = _gray_server()
        s1, port1, model1, golden1 = _gray_server()
        servers += [s0, s1]
        prober.add_target("r0", f"127.0.0.1:{port0}", golden0)
        prober.add_target("r1", f"127.0.0.1:{port1}", golden1)
        prober.start(interval_s=120.0)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            targets = prober.snapshot()["targets"]
            if all(v["last_outcome"] == "ok" for v in targets.values()):
                break
            time.sleep(0.05)
        else:
            pytest.fail(f"live probe never landed: {prober.snapshot()}")
        time.sleep(0.25)
        t0 = time.time()
        for _ in range(7):
            assert beat()["outcomes"] == {"r0": "ok", "r1": "ok"}
        assert set(states[-1].values()) == {"OK"}

        assert _predict(port1, golden1["inputs"])[0] == 200       # seeds r1's cache
        assert _get(port1, "/v1/models/drill")[1]["cache"]["entries"] == 1
        model1.wrong = True
        code, cached = _predict(port1, golden1["inputs"])
        np.testing.assert_allclose(cached["outputs"], golden1["outputs"],
                                   atol=golden1["atol"])
        for _ in range(18):
            beat()
            if states[-1]["probe_mismatch"] == states[-1]["probe_deadman"] == "FIRING":
                break
            code, h = _get(port1, "/healthz")
            assert code == 200 and h["healthy"] is True
            assert _get(port1, "/telemetry")[0] == 200
        assert states[-1]["probe_mismatch"] == "FIRING", \
            [(r.name, r.state, r.last_detail) for r in prober.engine.rules()]
        assert states[-1]["probe_deadman"] == "FIRING"
        assert "PENDING" in [s["probe_mismatch"] for s in states]
        fired = [pl for ev, pl in edges if ev == "alert_firing" and pl["rule"] == "probe_mismatch"]
        assert fired and "r1" in fired[-1]["detail"]
        assert fired[-1]["exemplar_trace_id"] in _trace_ids(port1)
        assert [e for e in _events(rec, "health_problem", kind="probe") if "r1" in e["message"]]
        assert len(_events(rec, "probe_target_failing", target="r1")) == 1

        s1.stop()                                   # the restart a policy would make
        s1b, port1b, _, golden1b = _gray_server()
        servers.append(s1b)
        assert golden1b["version"] == golden1["version"]
        prober.add_target("r1", f"127.0.0.1:{port1b}", golden1b)
        for _ in range(20):
            beat()
            if set(states[-1].values()) == {"OK"}:
                break
        assert set(states[-1].values()) == {"OK"}, \
            [(r.name, r.state, r.last_detail) for r in prober.engine.rules()]
        assert _events(rec, "probe_target_recovered", target="r1")
        assert {pl["rule"] for ev, pl in edges if ev == "alert_resolved"} >= \
            {"probe_mismatch", "probe_deadman"}
        for port in (port0, port1b):
            assert _get(port, "/v1/models/drill")[1]["cache"]["entries"] == 0
        names = [e["event"] for e in _get(host_port, "/events")[1]["events"]]
        for needed in ("probe_target_failing", "health_problem", "alert_firing",
                       "probe_target_recovered", "alert_resolved"):
            assert needed in names, names
        assert names.index("probe_target_failing") < names.index("probe_target_recovered")
        prober.stop()
        assert "prober" not in [t.name for t in threading.enumerate()]
    finally:
        prober.stop()
        prober.engine.clear()
        for s in servers:
            s.stop()
        host.stop()
