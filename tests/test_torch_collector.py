"""The port's scrape plane (``deeplearning4j_torch/monitor/collector.py``
and the ``/telemetry`` route) against the JAX package's, across the wire
both ways.

- ``telemetry_snapshot``: the priming reply (``last_seq``, no events),
  the cursored reply, ``since_seq=-1`` for the whole history, JAX's keys;
  the route's 400 on a bad cursor.
- A port collector scrapes a JAX replica, and a JAX collector scrapes a
  port replica: the first scrape primes the cursor (the replica's earlier
  flight events do not replay), later events land with ``target``,
  ``origin_seq`` and their fields, the report lands in the fleet table
  under ``worker=<label>``, and each tick samples the collector's history
  once. Both collectors scraping one replica tick for tick keep the same
  target state and record the same events.
- Down targets, removal, the lifecycle and the lock.

The JAX side runs on planes of its own for each test (its ``get_*``
functions patched to private instances), so the JAX package's
process-wide state is not touched; the port's is cleared around each test.
A replica in this process shares the port's planes with a port collector,
so the two-replica fleet drill runs its replicas as processes of their own
and is marked ``slow``; like JAX's (``TestFleetAcceptanceDrill``) it is
hosted on a ``UIServer``, and its in-process half (a collector's merged
views read from a ``UIServer``) runs in tier 1.
"""
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu.monitor import collector as jcollector
from deeplearning4j_tpu.monitor import (fleet as jfleet, flightrec as jflightrec,
                                        health as jhealth, registry as jregistry,
                                        tracer as jtracer)
from deeplearning4j_tpu.serving import InferenceServer as JServer

from deeplearning4j_torch.monitor import (FleetState, TelemetryCollector,
                                          default_fleet_scope_rules, get_collector, get_fleet,
                                          get_flight_recorder, get_health, get_registry,
                                          get_tracer, lockwatch, telemetry_snapshot)
from deeplearning4j_torch.serving import InferenceServer
from deeplearning4j_torch.ui import InMemoryStatsStorage, UIServer


class DrillModel:
    """Two columns of ones; ``fault`` makes it slow, and every second call
    of it fail."""

    def __init__(self):
        self.fault, self.n = False, 0

    def output(self, x, mask=None):
        x = np.asarray(x)
        if self.fault:
            time.sleep(0.08)
            self.n += 1
            if self.n % 2 == 0:
                raise RuntimeError("injected drill fault")
        return np.full((x.shape[0], 2), 1.0, np.float32)


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
    """The JAX package's registry, flight recorder, tracer, fleet table and
    health as private instances for the test."""
    planes = {"reg": jregistry.MetricsRegistry(), "rec": jflightrec.FlightRecorder(),
              "tracer": jtracer.Tracer(), "fleet": jfleet.FleetState(),
              "health": jhealth.HealthState()}
    monkeypatch.setattr(jregistry, "get_registry", lambda: planes["reg"])
    monkeypatch.setattr(jflightrec, "get_flight_recorder", lambda: planes["rec"])
    monkeypatch.setattr(jtracer, "get_tracer", lambda: planes["tracer"])
    monkeypatch.setattr(jfleet, "get_fleet", lambda: planes["fleet"])
    monkeypatch.setattr(jhealth, "get_health", lambda: planes["health"])
    return planes


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            raw = r.read().decode("utf-8")
            ctype = r.headers.get_content_type()
            return r.status, json.loads(raw) if ctype == "application/json" else raw
    except urllib.error.HTTPError as e:
        body = json.loads(e.read().decode("utf-8"))
        e.close()
        return e.code, body


def _predict(port, model="drill"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/{model}/predict",
        data=json.dumps({"inputs": [[1.0, 2.0]]}).encode("utf-8"),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status
    except urllib.error.HTTPError as e:
        e.close()
        return e.code


def _serve(server_cls):
    srv = server_cls()
    kw = {"device": "cpu"} if server_cls is InferenceServer else {}
    srv.register("drill", DrillModel(), batch_buckets=(1,), linger_ms=0.0,
                 max_queue_examples=64, **kw)
    return srv, srv.start(port=0)


def _landed(events, name):
    return [{k: v for k, v in e.items() if k not in ("t", "seq")}
            for e in events if e["event"] == name]


# --------------------------------------------------------- /telemetry
def test_telemetry_snapshot_prime_cursor_and_full_history(jax_planes):
    """No cursor: ``last_seq`` only; a cursor: the newer events; -1: all.
    The same events give the same documents' keys and event lists in both
    packages (seqs relative to each recorder's first event: a cleared
    recorder keeps counting)."""
    recs = {"port": get_flight_recorder(), "jax": jax_planes["rec"]}
    fns = {"port": telemetry_snapshot, "jax": jcollector.telemetry_snapshot}
    docs = {}
    for name, rec in recs.items():
        first = rec.record("collector_unit_t1", shard=1)["seq"]
        prime = fns[name]()
        assert prime["flight_events"] == [] and prime["last_seq"] == first
        rec.record("collector_unit_t2", shard=2)
        fresh = fns[name](since_seq=first)
        full = fns[name](since_seq=-1)
        docs[name] = [set(prime),
                      [(e["event"], e["seq"] - first, e.get("shard"))
                       for e in fresh["flight_events"]],
                      [(e["event"], e["seq"] - first) for e in full["flight_events"]],
                      fresh["last_seq"] - first]
    assert docs["port"] == docs["jax"]
    assert docs["port"][0] == {"registry", "trace_events", "flight_events", "last_seq",
                               "health", "exemplars"}
    assert docs["port"][1] == [("collector_unit_t2", 1, 2)]


def test_telemetry_route_cursor_exemplars_and_400():
    """The route on an ``InferenceServer``: the priming reply, a cursored
    reply with the request's exemplar latched, and 400 on a bad cursor."""
    srv, port = _serve(InferenceServer)
    try:
        code, prime = _get(port, "/telemetry")
        assert code == 200 and prime["flight_events"] == []
        assert _predict(port) == 200
        get_flight_recorder().record("collector_http_fresh")
        code, doc = _get(port, f"/telemetry?since_seq={prime['last_seq']}")
        assert code == 200
        assert [e["event"] for e in doc["flight_events"]] == ["collector_http_fresh"]
        rows = doc["exemplars"]["serving_request_latency_ms"]
        assert rows[0]["labels"] == {"model": "drill"} and rows[0]["exemplar"]
        assert doc["registry"]["serving_requests_total"]["type"] == "counter"
        code, err = _get(port, "/telemetry?since_seq=banana")
        assert code == 400 and "since_seq" in err["error"]
    finally:
        srv.stop()


# ------------------------------------------------------- across the wire
def _cross_scrape(collector, rec_remote, rec_local, port):
    """Prime, then scrape an event recorded on the replica; returns the
    local copies of the replica's events."""
    rec_remote.record("preexisting_incident", origin="replica")
    collector.add_target("u0", f"127.0.0.1:{port}")
    res = collector.tick()
    assert res["scraped"] == ["u0"] and not res["errors"], res
    assert not _landed(rec_local.events(), "preexisting_incident")
    assert _predict(port) == 200
    seq = rec_remote.record("collector_remote_boom", shard=3)["seq"]
    collector.tick()
    assert len(collector.history.samples()) == 2
    landed = _landed(rec_local.events(), "collector_remote_boom")
    assert len(landed) == 1 and landed[0]["origin_seq"] == seq
    return landed


def test_port_collector_scrapes_a_jax_replica(jax_planes):
    srv, port = _serve(JServer)
    fleet = FleetState()
    c = TelemetryCollector(fleet=fleet, timeout_s=10.0)
    try:
        landed = _cross_scrape(c, jax_planes["rec"], get_flight_recorder(), port)
        assert landed[0]["target"] == "u0" and landed[0]["shard"] == 3
        snap = c.snapshot()["targets"]["u0"]
        assert snap["up"] is True and snap["cursor"] == 2 and snap["errors"] == 0
        rows = fleet.merged_dump()["serving_requests_total"]["children"]
        assert {"worker": "u0", "model": "drill", "outcome": "ok"} in [r["labels"] for r in rows]
        ups = {r["labels"]["target"]: r["value"]
               for r in c.fleet_dump()["fleet_target_up"]["children"]}
        assert ups == {"u0": 1.0}
    finally:
        c.stop()
        srv.stop()


def test_jax_collector_scrapes_a_port_replica(jax_planes):
    srv, port = _serve(InferenceServer)
    fleet = jfleet.FleetState()
    c = jcollector.TelemetryCollector(fleet=fleet, timeout_s=10.0)
    try:
        landed = _cross_scrape(c, get_flight_recorder(), jax_planes["rec"], port)
        assert landed[0]["target"] == "u0" and landed[0]["shard"] == 3
        rows = fleet.merged_dump()["serving_requests_total"]["children"]
        assert {"worker": "u0", "model": "drill", "outcome": "ok"} in [r["labels"] for r in rows]
        trace = fleet.merged_trace()
        assert any((e.get("args") or {}).get("trace_id") for e in trace["traceEvents"]
                   if e.get("name") == "http/predict")
    finally:
        c.stop()
        srv.stop()


def _scrape_turns(c, rec_remote, rec_local, port):
    """Four synthetic ticks of ``c`` over the replica at ``port`` and a
    refused target: the target states after each, the events landed, the
    down edges and the labels of the collector's own scrape series."""
    c.add_target("r", f"127.0.0.1:{port}")
    c.add_target("gone", "127.0.0.1:9")
    states = []
    for k in range(4):
        assert _predict(port) == 200
        rec_remote.record("remote_step", k=k)
        res = c.tick(now=50_000.0 + k)
        assert res["scraped"] == ["r"] and set(res["errors"]) == {"gone"}
        states.append({label: {f: v for f, v in row.items() if f not in ("cursor", "url")}
                       for label, row in c.snapshot()["targets"].items()})
    landed = [{f: v for f, v in e.items() if f not in ("origin_seq", "origin_t")}
              for e in _landed(rec_local.events(), "remote_step") if "target" in e]
    down = [e["target"] for e in _landed(rec_local.events(), "fleet_target_down")]
    own = {name: sorted(str(r["labels"]) for r in c.fleet_dump()[name]["children"])
           for name in ("fleet_target_up", "fleet_scrape_errors_total",
                        "fleet_scrape_duration_ms", "fleet_worker_up")}
    return states, landed, down, own


def test_both_collectors_keep_the_same_state_across_the_wire(jax_planes):
    """A port collector scraping a JAX replica, then a JAX collector
    scraping a port replica (one after the other: a collector's own events
    land on the planes its package's replica serves), fed the same
    requests and events at the same synthetic times: equal target states,
    landed events, down edges and scrape series."""
    jsrv, jport = _serve(JServer)
    psrv, pport = _serve(InferenceServer)
    try:
        mine = _scrape_turns(TelemetryCollector(fleet=FleetState(), timeout_s=10.0),
                             jax_planes["rec"], get_flight_recorder(), jport)
        theirs = _scrape_turns(jcollector.TelemetryCollector(fleet=jfleet.FleetState(),
                                                             timeout_s=10.0),
                               get_flight_recorder(), jax_planes["rec"], pport)
    finally:
        jsrv.stop()
        psrv.stop()
    assert mine == theirs
    assert mine[1] == [{"event": "remote_step", "target": "r", "k": k} for k in (1, 2, 3)]
    assert mine[2] == ["gone"]


def test_relayed_event_with_provenance_keeps_this_hops(jax_planes):
    """A scraped event that already carries ``target``/``origin_seq`` (a
    replica that runs a collector of its own) lands with this hop's
    provenance and its own target as ``origin_target``; the JAX package's
    relay raises ``TypeError`` there (a departure, ROADMAP Queue C)."""
    jsrv, jport = _serve(JServer)
    psrv, pport = _serve(InferenceServer)
    pc = TelemetryCollector(fleet=FleetState(), timeout_s=10.0)
    jc = jcollector.TelemetryCollector(fleet=jfleet.FleetState(), timeout_s=10.0)
    try:
        pc.add_target("r", f"127.0.0.1:{jport}")
        jc.add_target("r", f"127.0.0.1:{pport}")
        pc.tick()
        jc.tick()
        for rec in (jax_planes["rec"], get_flight_recorder()):
            rec.record("fleet_target_down", target="inner", origin_seq=5, url="u")
        pc.tick()
        landed = _landed(get_flight_recorder().events(), "fleet_target_down")
        assert [(e["target"], e.get("origin_target"), e["url"]) for e in landed] == \
            [("inner", None, "u"), ("r", "inner", "u")]
        assert landed[-1]["origin_seq"] != 5
        with pytest.raises(TypeError):
            jc.tick()
    finally:
        jsrv.stop()
        psrv.stop()


def test_down_target_recovers_and_removal_retires_its_series():
    """A refused target is down (edge once), comes back (recovered edge),
    and ``remove_target`` drops its scrape series from the fleet dump."""
    srv, port = _serve(InferenceServer)
    c = TelemetryCollector(fleet=FleetState(), timeout_s=0.5)
    try:
        c.add_target("flaky", "127.0.0.1:9")
        c.tick()
        c.tick()
        assert [t.label for t in c.down_targets()] == ["flaky"]
        rec = get_flight_recorder()
        assert len(_landed(rec.events(), "fleet_target_down")) == 1
        c.add_target("flaky", f"127.0.0.1:{port}")
        c.tick()
        assert c.down_targets() == []
        assert len(_landed(rec.events(), "fleet_target_recovered")) == 1
        c.remove_target("flaky")
        fam = c.fleet_dump().get("fleet_target_up")     # the collector's own rows
        assert not fam or not [r for r in fam["children"] if r["labels"] == {"target": "flaky"}]
        assert c.snapshot()["targets"] == {}
    finally:
        srv.stop()


def test_lifecycle_and_the_lock_is_a_leaf():
    """``start`` is idempotent and scrapes at once; ``stop`` joins the
    thread; under the lockwatch ``TelemetryCollector._lock`` is acquired
    and never held while another lock is taken; ``get_collector`` is one
    idle process-wide collector."""
    prev = lockwatch.enabled()
    lockwatch.set_enabled(True)
    lockwatch.get_lockwatch().clear()
    srv, port = _serve(InferenceServer)
    try:
        c = TelemetryCollector(fleet=FleetState(), timeout_s=10.0)
        c.add_target("u", f"127.0.0.1:{port}")
        c.start(interval_s=120.0)
        c.start()
        assert c.running() and "telemetry-collector" in [t.name for t in threading.enumerate()]
        deadline = time.monotonic() + 20
        while c.snapshot()["targets"]["u"]["up"] is not True and time.monotonic() < deadline:
            time.sleep(0.02)
        assert c.snapshot()["targets"]["u"]["up"] is True
        c.stop()
        assert not c.running()
        assert "telemetry-collector" not in [t.name for t in threading.enumerate()]
        watch = lockwatch.get_lockwatch()
        assert watch.contention_table()["TelemetryCollector._lock"]["acquisitions"] > 0
        assert not [e for e in watch.observed_edges() if e[0] == "TelemetryCollector._lock"]
    finally:
        srv.stop()
        lockwatch.set_enabled(prev)
        lockwatch.get_lockwatch().clear()
    assert get_collector() is get_collector()
    assert not get_collector().running() and get_collector().targets() == []


def test_merged_views_on_a_ui_server():
    """The drill's surfaces without its processes: a collector scraping an
    in-process replica and a refused target lands the replica's series
    under ``worker=r0`` and the down edge, which a ``UIServer`` serves from
    ``/fleet``, ``/fleet?format=json``, ``/fleet/trace`` and ``/events``."""
    srv, port = _serve(InferenceServer)
    ui = UIServer(port=0)
    ui.attach(InMemoryStatsStorage())
    ui_port = ui.start()
    c = TelemetryCollector(timeout_s=10.0)
    try:
        c.add_target("r0", f"127.0.0.1:{port}")
        c.add_target("gone", "127.0.0.1:9")
        c.tick()
        assert _predict(port) == 200
        res = c.tick()
        assert res["scraped"] == ["r0"] and set(res["errors"]) == {"gone"}
        code, text = _get(ui_port, "/fleet")
        assert code == 200 and 'fleet_worker_up{worker="r0"} 1' in text
        assert 'serving_requests_total{model="drill",outcome="ok",worker="r0"}' in text
        code, live = _get(ui_port, "/fleet?format=json")
        assert code == 200 and live["workers"]["r0"]["stale"] is False
        code, trace = _get(ui_port, "/fleet/trace")
        assert any(e.get("name") == "http/predict" for e in trace["traceEvents"])
        code, doc = _get(ui_port, "/events")
        downs = [e for e in doc["events"] if e["event"] == "fleet_target_down"]
        assert code == 200 and [e["target"] for e in downs] == ["gone"]
    finally:
        c.stop()
        ui.stop()
        srv.stop()


# ------------------------------------------------------- the fleet drill
_REPLICA_SRC = r"""
import sys, time
import numpy as np

flag = sys.argv[1]

class DrillModel:
    def __init__(self):
        self.n = 0
    def output(self, x, mask=None):
        import os
        x = np.asarray(x)
        if os.path.exists(flag):          # fault switch: slow + erroring
            time.sleep(0.08)
            self.n += 1
            if self.n % 2 == 0:
                raise RuntimeError("injected drill fault")
        return np.full((x.shape[0], 2), 1.0, np.float32)

from deeplearning4j_torch.serving import InferenceServer
from deeplearning4j_torch.monitor import get_flight_recorder

get_flight_recorder().record("preexisting_incident", origin="replica")
srv = InferenceServer()
srv.register("drill", DrillModel(), device="cpu", batch_buckets=(1,), linger_ms=0.0,
             max_queue_examples=64)
print(srv.start(port=0), flush=True)
sys.stdin.read()
"""


def _spawn_replica(flag_path, err_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    errf = open(err_path, "w")
    proc = subprocess.Popen([sys.executable, "-c", _REPLICA_SRC, str(flag_path)],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=errf,
                            text=True, env=env, cwd=root)
    box = {}
    t = threading.Thread(target=lambda: box.update(line=proc.stdout.readline()), daemon=True)
    t.start()
    t.join(120)
    errf.close()
    line = (box.get("line") or "").strip()
    if not line:
        proc.kill()
        proc.wait(timeout=30)
        with open(err_path) as f:
            raise RuntimeError(f"replica failed to start:\n{f.read()}")
    return proc, int(line)


@pytest.mark.slow
def test_two_replica_fleet_drill(tmp_path):
    """JAX's fleet acceptance drill on the port: two port replica processes
    scraped by a live collector hosted on a port ``UIServer``. A slow,
    erroring r1
    walks ``fleet_p99_worst_replica`` and ``fleet_error_burn`` through
    PENDING to FIRING, naming r1 with an exemplar that r1's ``/trace``
    resolves; killing r1 fires ``fleet_target_down``; a respawn resolves
    every rule; the incident reads back from ``/events``."""
    rec = get_flight_recorder()
    host = UIServer(port=0)
    host.attach(InMemoryStatsStorage())
    host_port = host.start()
    flag = tmp_path / "fault_r1"
    collector = TelemetryCollector(timeout_s=10.0)
    edges = []
    collector.engine.subscribe(lambda ev, pl: edges.append((ev, dict(pl))))
    collector.engine.add(*default_fleet_scope_rules(fleet=collector.fleet, windows=(1.5, 3.0),
                                                    p99_target_ms=40.0, for_seconds=0.2))
    procs, states, step = [], [], [0]
    ok = {"fleet_error_burn": "OK", "fleet_p99_worst_replica": "OK", "fleet_target_down": "OK"}

    def beat(ports, per=2):
        for p in ports:
            for _ in range(per):
                _predict(p)
        step[0] += 1
        res = collector.tick(now=t0 + 0.5 * step[0])
        states.append({r.name: r.state for r in collector.engine.rules()})
        return res

    try:
        p0, port0 = _spawn_replica(tmp_path / "no_fault_r0", tmp_path / "r0.err")
        procs.append(p0)
        p1, port1 = _spawn_replica(flag, tmp_path / "r1.err")
        procs.append(p1)
        collector.add_target("r0", f"127.0.0.1:{port0}")
        collector.add_target("r1", f"127.0.0.1:{port1}")
        collector.start(interval_s=120.0)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            targets = collector.snapshot()["targets"]
            if len(targets) == 2 and all(v["up"] for v in targets.values()):
                break
            time.sleep(0.05)
        else:
            pytest.fail(f"live scrape never landed: {collector.snapshot()}")
        time.sleep(0.25)
        t0 = time.time()
        assert not _landed(rec.events(), "preexisting_incident")
        for _ in range(7):
            assert not beat([port0, port1])["errors"]
        assert states[-1] == ok
        text = _get(host_port, "/fleet")[1]
        assert 'worker="r0"' in text and 'worker="r1"' in text and "fleet_worker_up" in text
        code, trace = _get(host_port, "/fleet/trace")
        spans = [e for e in trace["traceEvents"]
                 if e.get("ph") == "X" and (e.get("args") or {}).get("trace_id")]
        keys = [(e["args"]["trace_id"], e["args"].get("span_id"), e["ts"]) for e in spans]
        assert spans and len(keys) == len(set(keys)) and len({e["pid"] for e in spans}) >= 2

        flag.write_text("x")
        for _ in range(14):
            beat([port0, port1])
            if states[-1]["fleet_p99_worst_replica"] == states[-1]["fleet_error_burn"] \
                    == "FIRING":
                break
        assert states[-1]["fleet_p99_worst_replica"] == "FIRING", \
            [(r.name, r.state, r.last_detail) for r in collector.engine.rules()]
        assert states[-1]["fleet_error_burn"] == "FIRING"
        assert "PENDING" in [s["fleet_p99_worst_replica"] for s in states]
        fired = [p for ev, p in edges
                 if ev == "alert_firing" and p["rule"] == "fleet_p99_worst_replica"]
        assert fired and "worker=r1" in fired[-1]["detail"]
        exemplar = fired[-1]["exemplar_trace_id"]
        assert exemplar in {(e.get("args") or {}).get("trace_id")
                            for e in _get(port1, "/trace")[1]["traceEvents"]}

        p1.kill()
        p1.wait(timeout=30)
        flag.unlink()
        assert "r1" in beat([port0])["errors"]
        assert [t.label for t in collector.down_targets()] == ["r1"]
        beat([port0])
        assert states[-1]["fleet_target_down"] == "FIRING"
        ups = {r["labels"]["target"]: r["value"]
               for r in collector.fleet_dump()["fleet_target_up"]["children"]}
        assert ups == {"r0": 1.0, "r1": 0.0}

        p1b, port1b = _spawn_replica(flag, tmp_path / "r1b.err")
        procs.append(p1b)
        collector.add_target("r1", f"127.0.0.1:{port1b}")
        for _ in range(16):
            beat([port0, port1b])
            if states[-1] == ok:
                break
        assert states[-1] == ok, [(r.name, r.state, r.last_detail)
                                  for r in collector.engine.rules()]
        assert _landed(rec.events(), "fleet_target_recovered")
        assert not _landed(rec.events(), "preexisting_incident")
        assert {p["rule"] for ev, p in edges if ev == "alert_resolved"} >= set(ok)
        names = [e["event"] for e in _get(host_port, "/events")[1]["events"]]
        for needed in ("alert_firing", "fleet_target_down", "fleet_target_recovered",
                       "alert_resolved"):
            assert needed in names, names
        assert names.index("fleet_target_down") < names.index("fleet_target_recovered")
        collector.stop()
        assert "telemetry-collector" not in [t.name for t in threading.enumerate()]
    finally:
        collector.stop()
        collector.engine.clear()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        host.stop()
