"""The port's incident recorder (``deeplearning4j_torch/monitor/
incidents.py``) against the JAX package's.

- Both packages get private planes (registry, flight recorder, tracer,
  history, alert engine, control plane) read through their ``get_*``
  functions on one synthetic clock. The same gauge series, drawn from a
  numpy seed, go into both registries; the same spans into both tracers;
  the same flight events into both recorders. Both engines evaluate the
  same rules and both recorders tick at the same ``now``: the table rows
  and the bundles must be equal (the file's path and size apart, whose
  digest covers ``capture_ms``, and ``capture_ms`` itself).
- A bundle persisted by either package loads through the other's
  ``load_bundle`` and renders to the same text through both
  ``render_incident_text``; an edited bundle fails its content address
  in both.
- The rest of JAX's ``tests/test_incidents.py`` on the port: the
  provisional bundle, merging and re-firing, persistence, the pinned
  exemplar, the bounded table, the daemon, the halt flush, the routes on
  the port's ``InferenceServer``, and the lock (a leaf under the
  lockwatch).

The port's process-wide registry, flight recorder, tracer, history, alert
engine, control plane and incident recorder are reset around every test.
"""
import json
import re
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

import deeplearning4j_tpu.monitor.incidents as jincidents
from deeplearning4j_tpu.control import plane as jplane
from deeplearning4j_tpu.monitor import (alerts as jalerts, collector as jcollector,
                                        flightrec as jflightrec, history as jhistory,
                                        jitwatch as jjitwatch, lockwatch as jlockwatch,
                                        probes as jprobes, registry as jregistry,
                                        tracer as jtracer)

import deeplearning4j_torch.monitor.incidents as pincidents
from deeplearning4j_torch.control import get_control_plane, plane as pplane
from deeplearning4j_torch.monitor import (IncidentRecorder, ThresholdRule, get_alert_engine,
                                          get_fleet, get_flight_recorder, get_health,
                                          get_history, get_registry, get_tracer, load_bundle,
                                          lockwatch, render_incident_text)
from deeplearning4j_torch.monitor import (alerts as palerts, collector as pcollector,
                                          flightrec as pflightrec, history as phistory,
                                          jitwatch as pjitwatch, probes as pprobes,
                                          registry as pregistry, tracer as ptracer)
from deeplearning4j_torch.monitor.incidents import BUNDLE_FORMAT

T0 = 20_000.0


def _reset_port():
    plane = get_control_plane()
    plane.stop(timeout=5.0)
    plane.clear()
    get_alert_engine().clear()
    get_history().clear()
    for p in (get_registry(), get_flight_recorder(), get_fleet(), get_tracer()):
        p.clear()
    get_health().reset()
    pincidents.get_incident_recorder().clear()


@pytest.fixture(autouse=True)
def _clean_port_state():
    _reset_port()
    yield
    _reset_port()


class Clock:
    """``time()``/``monotonic()`` read ``t``; ``perf_counter()`` stands
    still, so a capture takes 0 ms in both packages."""

    def __init__(self, t):
        self.t = t

    def time(self):
        return self.t

    def monotonic(self):
        return self.t

    def perf_counter(self):
        return 0.0

    def __getattr__(self, name):
        return getattr(time, name)


class FixedSource:
    def __init__(self, doc):
        self.doc = doc

    def table(self):
        return self.doc

    def snapshot(self):
        return self.doc


JIT_TABLE = {"mln/output": {"compiles": 2, "calls": 9}}
LOCK_CENSUS = {"Prober._lock": {"acquisitions": 4}}
PROBES = {"targets": {"r0": {"last_outcome": "ok"}}}


@pytest.fixture
def pair(monkeypatch, tmp_path):
    """(JAX planes, port planes, clock)."""
    clock = Clock(T0)
    sides = []
    for tag, mods in (("jax", (jregistry, jflightrec, jtracer, jhistory, jalerts, jplane,
                               jincidents, jjitwatch, jlockwatch, jprobes, jcollector)),
                      ("port", (pregistry, pflightrec, ptracer, phistory, palerts, pplane,
                                pincidents, pjitwatch, lockwatch, pprobes, pcollector))):
        registry, flightrec, tracer, history, alerts, plane, incidents, jit, lw, probes, \
            collector = mods
        reg, rec, tr = registry.MetricsRegistry(), flightrec.FlightRecorder(), tracer.Tracer()
        monkeypatch.setattr(registry, "get_registry", lambda reg=reg: reg)
        monkeypatch.setattr(flightrec, "get_flight_recorder", lambda rec=rec: rec)
        monkeypatch.setattr(tracer, "get_tracer", lambda tr=tr: tr)
        monkeypatch.setattr(jit, "get_jit_registry", lambda: FixedSource(JIT_TABLE))
        monkeypatch.setattr(lw, "contention_table", lambda: LOCK_CENSUS)
        monkeypatch.setattr(probes, "_PROBER", FixedSource(PROBES))
        monkeypatch.setattr(collector, "_COLLECTOR", None)
        for mod in (registry, flightrec, plane, incidents):
            monkeypatch.setattr(mod, "time", clock)
        hist = history.MetricsHistory(capacity=512, registry=reg)
        engine = alerts.AlertEngine(history=hist)
        (tmp_path / tag).mkdir()
        recorder = incidents.IncidentRecorder(engine=engine, dump_dir=str(tmp_path / tag),
                                              lookback_s=4.0)
        ctl = plane.ControlPlane(engine=engine)
        engine.subscribe(ctl._on_edge)
        engine.subscribe(recorder._on_edge)
        sides.append(SimpleNamespace(tag=tag, mod=incidents, alerts=alerts, plane=plane,
                                     reg=reg, rec=rec, tracer=tr, hist=hist, engine=engine,
                                     recorder=recorder, ctl=ctl, dir=tmp_path / tag))
    return sides[0], sides[1], clock


def _spans(seed):
    """Two traces (a parent and a child span each) as tracer events."""
    rng = np.random.default_rng(seed)
    out, tids = [], []
    for k in range(2):
        tid = f"{int(rng.integers(1, 2 ** 48)):x}"
        root, child = f"{k + 1:x}0", f"{k + 1:x}1"
        ts = float(rng.uniform(0, 1e6))
        out += [{"name": "serving/request", "cat": "serving", "ph": "X", "ts": ts,
                 "dur": 5000.0, "pid": 1, "tid": 7,
                 "args": {"trace_id": tid, "span_id": root, "model": "m"}},
                {"name": "serving/flush", "cat": "serving", "ph": "X", "ts": ts + 100.0,
                 "dur": 4000.0, "pid": 1, "tid": 7,
                 "args": {"trace_id": tid, "span_id": child, "parent_span_id": root}}]
        tids.append(tid)
    return out, tids


def _series(seed, n=36):
    """Gauges a and b a step: quiet, then overlapping bursts, then quiet."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 4.0, n)
    b = rng.uniform(0.0, 4.0, n)
    s = int(rng.integers(4, 8))
    a[s:s + int(rng.integers(6, 10))] += 8.0
    sb = s + int(rng.integers(2, 5))
    b[sb:sb + int(rng.integers(3, 8))] += 8.0
    s2 = int(rng.integers(22, 26))
    a[s2:s2 + 3] += 8.0
    noise = rng.random(n) < 0.3
    return a, b, noise


def _row(r):
    return {k: v for k, v in r.items() if k not in ("path", "bundle_bytes")}


def _bundle_view(b):
    b = json.loads(json.dumps(b, sort_keys=True, default=repr))
    for c in b["captures"]:
        c.pop("capture_ms")
    return b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_recorder_equals_jax_on_the_same_edges(pair, seed):
    j, p, clock = pair
    spans, tids = _spans(seed)
    a, b, noise = _series(seed)
    for side in (j, p):
        for ev in spans:
            side.tracer._append(dict(ev, args=dict(ev["args"])))
        side.engine.add(side.alerts.ThresholdRule("inc_a", "pressure_a", threshold=5.0,
                                                  for_seconds=1.0, severity="page",
                                                  exemplar_lookup=lambda: tids[0]),
                        side.alerts.ThresholdRule("inc_b", "pressure_b", threshold=5.0,
                                                  exemplar_lookup=lambda: tids[1]))
        side.ctl.add(side.plane.ControlPolicy("shed_a", lambda ctx: "stepped", rules=("inc_a",),
                                              cooldown_s=2.0))
        side.ctl._prime_cursor()
    for i in range(len(a)):
        clock.t = T0 + i
        ticked = []
        for side in (j, p):
            side.reg.gauge("pressure_a", "a").set(float(a[i]))
            side.reg.gauge("pressure_b", "b").set(float(b[i]))
            if noise[i]:
                side.rec.record("noise", step=i, level=float(a[i]))
            side.hist.sample(now=clock.t)
            side.engine.evaluate(now=clock.t)
            side.ctl.tick(now=clock.t)
            ticked.append(side.recorder.tick(now=clock.t))
        assert ticked[1] == ticked[0]
        js, ps = j.recorder.snapshot(), p.recorder.snapshot()
        assert [_row(r) for r in ps.pop("incidents")] == [_row(r) for r in js.pop("incidents")]
        assert ps == js
        for inc in js["open"]:
            assert _bundle_view(p.recorder.bundle(inc)) == _bundle_view(j.recorder.bundle(inc))
    incs = p.recorder.incidents()
    assert len(incs) >= 2 and all(inc.status == "resolved" for inc in incs)
    assert any(len(inc.rules) == 2 for inc in incs)
    for inc in incs:
        jb, pb = j.recorder.bundle(inc.id), p.recorder.bundle(inc.id)
        assert _bundle_view(pb) == _bundle_view(jb)
        assert _bundle_view(load_bundle(inc.path)) == _bundle_view(pb)
        assert pb["context"] == {"jit_table": JIT_TABLE, "lock_census": LOCK_CENSUS,
                                 "probes": PROBES}
        assert render_incident_text(pb) == jincidents.render_incident_text(jb)
    first = _bundle_view(p.recorder.bundle(incs[0].id))
    assert {s["name"] for s in first["rules"]["inc_a"]["exemplar_spans"]} == {
        "serving/request", "serving/flush"}
    assert [a["policy"] for a in first["control_actions"]] == ["shed_a"]
    for side in (j, p):
        assert len(list(side.dir.glob("inc-*.dl4jinc"))) == len(incs)
        assert side.reg.gauge("incidents_open").value == 0.0


def _resolved(mod, tmp_path, tid=None):
    """One merged, resolved, persisted incident made by ``mod``'s recorder
    on the process-wide planes of its package."""
    engine = SimpleNamespace(rules=lambda: [], history=SimpleNamespace(samples=lambda: []))
    rec = mod.IncidentRecorder(engine=engine, dump_dir=str(tmp_path))
    rec._on_edge("alert_firing", {"rule": "inc_x", "severity": "page", "value": 41.5,
                                  "detail": "hot", "exemplar_trace_id": tid})
    rec.tick(now=50.0)
    rec._on_edge("alert_firing", {"rule": "inc_y", "severity": "ticket", "value": 2.0,
                                  "detail": "warm", "exemplar_trace_id": None})
    rec.tick(now=51.0)
    for rule in ("inc_x", "inc_y"):
        rec._on_edge("alert_resolved", {"rule": rule, "detail": "ok"})
    rec.tick(now=60.0)
    (path,) = tmp_path.glob("*.dl4jinc")
    return path


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_bundles_load_and_render_across_packages(tmp_path, monkeypatch, writer):
    """A bundle persisted by one package loads through the other's
    ``load_bundle`` and renders to the same text in both; an edited copy
    fails its content address in both. The JAX writer runs on private
    planes holding the port tracer's spans."""
    planes = {"reg": jregistry.MetricsRegistry(), "rec": jflightrec.FlightRecorder(),
              "tracer": jtracer.Tracer()}
    monkeypatch.setattr(jregistry, "get_registry", lambda: planes["reg"])
    monkeypatch.setattr(jflightrec, "get_flight_recorder", lambda: planes["rec"])
    monkeypatch.setattr(jtracer, "get_tracer", lambda: planes["tracer"])
    with get_tracer().span("inc_req", cat="serving") as ctx:
        with get_tracer().span("inc_child", cat="serving", parent=ctx):
            pass
    for ev in get_tracer().events():
        planes["tracer"]._append(ev)
    path = _resolved(pincidents if writer == "port" else jincidents, tmp_path,
                     f"{ctx.trace_id:x}")
    assert re.fullmatch(r"inc-0001-[0-9a-f]{16}\.dl4jinc", path.name)
    pb, jb = pincidents.load_bundle(str(path)), jincidents.load_bundle(str(path))
    assert pb == jb and pb["format"] == BUNDLE_FORMAT == jincidents.BUNDLE_FORMAT
    assert set(pb["rules"]) == {"inc_x", "inc_y"} and pb["status"] == "resolved"
    text = pincidents.render_incident_text(pb)
    assert text == jincidents.render_incident_text(jb)
    assert text.startswith("# incident inc-0001 — resolved") and "rules (2 merged):" in text
    assert "exemplar trace" in text and "inc_child" in text
    raw = path.read_text()
    path.write_text(raw.replace('"resolved"', '"re-edited"', 1))
    for mod in (pincidents, jincidents):
        with pytest.raises(ValueError, match="content address"):
            mod.load_bundle(str(path))


def _fire(rule, tid=None, value=1.0):
    return ("alert_firing", {"rule": rule, "severity": "page", "value": value,
                             "detail": "injected", "exemplar_trace_id": tid})


def _resolve(rule):
    return ("alert_resolved", {"rule": rule, "detail": "ok", "exemplar_trace_id": None})


def _bundles(path):
    return sorted(path.glob("*.dl4jinc"))


def test_provisional_bundle_merge_refire_and_untracked_resolve(tmp_path):
    rec = IncidentRecorder(engine=get_alert_engine(), dump_dir=str(tmp_path))
    rec._on_edge(*_resolve("inc_never_fired"))
    assert rec.tick(now=5.0) == 0 and rec.incidents() == []
    rec._on_edge(*_fire("inc_flap"))
    rec._on_edge(*_fire("inc_other"))
    rec.tick(now=10.0)
    (inc,) = rec.incidents()
    bundle = rec.bundle(inc.id)
    assert bundle["status"] == "open" and bundle["format"] == BUNDLE_FORMAT
    assert set(bundle["rules"]) == {"inc_flap", "inc_other"}
    assert [c["outcome"] for c in inc.captures] == ["captured", "merged"]
    assert rec.bundle("inc-nope") is None and not _bundles(tmp_path)
    rec._on_edge(*_resolve("inc_flap"))
    rec.tick(now=11.0)
    rec._on_edge(*_fire("inc_flap"))
    rec.tick(now=12.0)
    assert inc.status == "open" and inc.rules["inc_flap"]["fired_t"] == 12.0
    assert inc.rules["inc_flap"]["resolved_t"] is None
    rec._on_edge(*_resolve("inc_other"))
    rec.tick(now=13.0)
    assert inc.status == "open"
    rec._on_edge(*_resolve("inc_flap"))
    rec.tick(now=14.0)
    assert inc.status == "resolved" and len(_bundles(tmp_path)) == 1
    assert get_registry().counter("incident_captures_total", outcome="merged").value == 2.0


@pytest.mark.parametrize("where", ["none", "env", "dump_dir_beats_env"])
def test_persistence_follows_dump_dir_then_the_environment(tmp_path, monkeypatch, where):
    envdir, own = tmp_path / "env", tmp_path / "own"
    envdir.mkdir()
    own.mkdir()
    if where == "none":
        monkeypatch.delenv("DL4J_TPU_INCIDENT_DIR", raising=False)
    else:
        monkeypatch.setenv("DL4J_TPU_INCIDENT_DIR", str(envdir))
    rec = IncidentRecorder(engine=get_alert_engine(),
                           dump_dir=str(own) if where == "dump_dir_beats_env" else None)
    rec._on_edge(*_fire("inc_p"))
    rec.tick(now=1.0)
    rec._on_edge(*_resolve("inc_p"))
    rec.tick(now=2.0)
    (inc,) = rec.incidents()
    assert rec.bundle(inc.id)["status"] == "resolved"
    want = {"none": (0, 0), "env": (1, 0), "dump_dir_beats_env": (0, 1)}[where]
    assert (len(_bundles(envdir)), len(_bundles(own))) == want
    if where == "none":
        assert inc.path is None
    else:
        (row,) = rec.snapshot()["incidents"]
        assert row["path"] == inc.path and row["bundle_bytes"] == len(open(inc.path).read())


def test_exemplar_pinned_by_copy_survives_the_ring(tmp_path):
    with get_tracer().span("inc_req", cat="serving") as ctx:
        with get_tracer().span("inc_child", cat="serving", parent=ctx):
            pass
    tid = f"{ctx.trace_id:x}"
    rec = IncidentRecorder(engine=get_alert_engine(), dump_dir=str(tmp_path))
    rec._on_edge(*_fire("inc_pin", tid=tid))
    rec.tick(now=10.0)
    get_tracer().clear()
    for _ in range(64):
        with get_tracer().span("churn", cat="test"):
            pass
    rec._on_edge(*_resolve("inc_pin"))
    rec.tick(now=20.0)
    spans = load_bundle(str(_bundles(tmp_path)[0]))["rules"]["inc_pin"]["exemplar_spans"]
    assert {s["name"] for s in spans} == {"inc_req", "inc_child"}
    assert all(s["args"]["trace_id"] == tid for s in spans)


def test_bounded_table_evicts_the_oldest_closed_first(tmp_path):
    rec = IncidentRecorder(engine=get_alert_engine(), dump_dir=str(tmp_path), max_incidents=2)
    for i, now in enumerate((10.0, 20.0, 30.0)):
        rec._on_edge(*_fire(f"inc_ev_{i}"))
        rec.tick(now=now)
        rec._on_edge(*_resolve(f"inc_ev_{i}"))
        rec.tick(now=now + 1.0)
    assert [inc.id for inc in rec.incidents()] == ["inc-0002", "inc-0003"]
    assert rec.snapshot()["evicted"] == 1 and rec.bundle("inc-0001") is None
    assert len(_bundles(tmp_path)) == 3
    small = IncidentRecorder(engine=get_alert_engine(), max_incidents=1)
    small._on_edge(*_fire("inc_first"))
    small.tick(now=1.0)
    small._on_edge(*_resolve("inc_first"))
    small.tick(now=2.0)
    small._on_edge(*_fire("inc_second"))
    small.tick(now=3.0)
    (inc,) = small.incidents()
    assert (inc.id, inc.status, small.evicted) == ("inc-0002", "open", 1)


def test_daemon_captures_and_stops_clean(tmp_path):
    g = get_registry().gauge("inc_daemon_gauge", "test gauge")
    g.set(0.0)
    eng = get_alert_engine()
    eng.add(ThresholdRule("inc_d", "inc_daemon_gauge", threshold=5.0, for_seconds=0.0))
    rec = IncidentRecorder(engine=eng, dump_dir=str(tmp_path))
    try:
        rec.start(interval_s=0.01)
        rec.start(interval_s=0.01)
        assert rec.running() and rec._on_edge in eng._listeners
        assert [t.name for t in threading.enumerate()].count("incident-recorder") == 1
        g.set(10.0)
        get_history().sample()
        eng.evaluate()
        deadline = time.time() + 5.0
        while not rec.incidents() and time.time() < deadline:
            time.sleep(0.01)
        g.set(0.0)
        get_history().sample()
        eng.evaluate()
        while not _bundles(tmp_path) and time.time() < deadline:
            time.sleep(0.01)
    finally:
        rec.stop()
    assert not rec.running() and rec._on_edge not in eng._listeners
    assert "incident-recorder" not in [t.name for t in threading.enumerate()]
    (path,) = _bundles(tmp_path)
    assert load_bundle(str(path))["status"] == "resolved"
    rec._on_edge(*_fire("inc_clr"))
    rec.tick(now=1.0)
    assert get_registry().gauge("incidents_open").value == 1.0
    rec.clear()
    assert rec.incidents() == [] and rec.snapshot()["open"] == []
    assert get_registry().gauge("incidents_open").value == 0.0


def test_halt_flushes_the_open_incident_as_aborted(tmp_path, monkeypatch):
    """A halt while an incident is open writes it as ``aborted``, a fire
    edge still queued included; without a recorder the halt pays nothing."""
    rec = IncidentRecorder(engine=get_alert_engine(), dump_dir=str(tmp_path))
    assert rec.abort_open("idle halt") == []
    monkeypatch.setattr(pincidents, "_RECORDER", rec)
    rec._on_edge(*_fire("inc_halt_a"))
    rec.tick(now=10.0)
    rec._on_edge(*_fire("inc_halt_b"))
    get_health().record_halt("injected halt")
    (path,) = _bundles(tmp_path)
    bundle = load_bundle(str(path))
    assert bundle["status"] == "aborted" and set(bundle["rules"]) == {"inc_halt_a", "inc_halt_b"}
    assert "halt" in {e["event"] for e in bundle["flight_events"]}
    closed = [e for e in get_flight_recorder().events() if e["event"] == "incident_closed"]
    assert closed[-1]["reason"] == "halt: injected halt" and rec.snapshot()["open"] == []
    monkeypatch.setattr(pincidents, "_RECORDER", None)
    get_health().record_halt("bare process halt")
    assert pincidents._RECORDER is None                 # the halt made no recorder
    assert pincidents.abort_open_incidents() == [] and len(_bundles(tmp_path)) == 1


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        body = json.loads(e.read())
        e.close()
        return e.code, body


def test_inference_server_serves_the_incident_routes(tmp_path, monkeypatch):
    from deeplearning4j_torch.serving import InferenceServer
    with get_tracer().span("inc_req", cat="serving") as ctx:
        pass
    rec = IncidentRecorder(engine=get_alert_engine(), dump_dir=str(tmp_path))
    monkeypatch.setattr(pincidents, "_RECORDER", rec)
    rec._on_edge(*_fire("inc_http", tid=f"{ctx.trace_id:x}"))
    rec.tick(now=100.0)
    rec._on_edge(*_resolve("inc_http"))
    rec.tick(now=101.0)
    rec._on_edge(*_fire("inc_http_open"))
    rec.tick(now=102.0)
    srv = InferenceServer()
    port = srv.start(port=0)
    try:
        base = f"http://127.0.0.1:{port}"
        status, doc = _get(f"{base}/incidents")
        assert status == 200 and set(doc) == set(jincidents.IncidentRecorder().snapshot())
        assert len(doc["incidents"]) == 2 and doc["open"] == ["inc-0002"]
        assert set(doc["incidents"][0]) == set(jincidents.Incident("x", 0.0).row())
        status, bundle = _get(f"{base}/incidents/inc-0001")
        assert status == 200 and bundle["status"] == "resolved"
        assert bundle["rules"]["inc_http"]["exemplar_spans"]
        assert set(bundle) == set(jincidents.IncidentRecorder._bundle_locked(
            jincidents.Incident("x", 0.0)))
        status, bundle = _get(f"{base}/incidents/inc-0002")
        assert status == 200 and bundle["status"] == "open"
        status, doc = _get(f"{base}/incidents/inc-nope")
        assert status == 404 and doc == {"error": "unknown incident 'inc-nope'"}
        metrics = urllib.request.urlopen(f"{base}/metrics", timeout=10).read().decode()
        assert "\nincidents_open 1\n" in metrics
    finally:
        srv.stop()


def test_the_recorder_lock_is_a_leaf(tmp_path):
    """JAX's ``tests/test_lockwatch.py`` incident flows under the port's
    lockwatch: capture, merge, the surfaces, close and persist, the halt
    flush; ``IncidentRecorder._lock`` is acquired and no other lock is
    taken while it is held."""
    prev = lockwatch.enabled()
    lockwatch.set_enabled(True)
    watch = lockwatch.get_lockwatch()
    watch.clear()
    try:
        eng = palerts.AlertEngine(history=phistory.MetricsHistory())
        rec = IncidentRecorder(engine=eng, dump_dir=str(tmp_path))
        with get_tracer().span("lw_inc_req", cat="serve") as ctx:
            pass
        rec._on_edge(*_fire("lw_inc_a", tid=f"{ctx.trace_id:x}"))
        rec.tick()
        rec._on_edge(*_fire("lw_inc_b"))
        rec.tick()
        rec.bundle(rec.snapshot()["open"][0])
        rec._on_edge(*_resolve("lw_inc_a"))
        rec._on_edge(*_resolve("lw_inc_b"))
        rec.tick()
        rec._on_edge(*_fire("lw_inc_a"))
        rec.tick()
        assert rec.abort_open("lw halt")
        rec.start(interval_s=0.01)
        rec.stop()
        rec.clear()
        assert watch.contention_table()["IncidentRecorder._lock"]["acquisitions"] > 0
        assert not [e for e in watch.observed_edges() if e[0] == "IncidentRecorder._lock"]
        assert watch.inversions() == []
    finally:
        lockwatch.set_enabled(prev)
        watch.clear()
