"""The port's alert engine (``deeplearning4j_torch/monitor/alerts.py``)
against the JAX package's.

Both packages get private planes for each test: a registry, a flight
recorder, a health state and a fleet table of their own, returned by their
``get_*`` functions, with one synthetic clock read by the registry (the
exemplar latch), the flight recorder, the health state and the fleet
table. The same series, drawn from one numpy seed, go into both registries
and both history rings at the same synthetic times, and both engines
evaluate the same rules at each ``now``: the rows (state, value, detail,
exemplar, counts), the ``alerts_firing`` gauges and the flight edges must
be equal, exactly. The port's process-wide registry, flight recorder and
fleet table are also cleared around every test.
"""
import json
import threading
import time
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

from deeplearning4j_tpu.monitor import alerts as jalerts
from deeplearning4j_tpu.monitor import (fleet as jfleet, flightrec as jflightrec,
                                        health as jhealth, history as jhistory,
                                        registry as jregistry)

from deeplearning4j_torch.monitor import alerts as palerts
from deeplearning4j_torch.monitor import (fleet as pfleet, flightrec as pflightrec,
                                          health as phealth, history as phistory,
                                          lockwatch as plockwatch, registry as pregistry)
from deeplearning4j_torch.monitor import get_fleet, get_flight_recorder, get_health, get_registry

T0 = 10_000.0
STEP_S = 1.0


class Clock:
    """The synthetic clock: ``time()`` and ``monotonic()`` read ``t``;
    everything else is the real ``time`` module's."""

    def __init__(self, t):
        self.t = t

    def time(self):
        return self.t

    def monotonic(self):
        return self.t

    def __getattr__(self, name):
        return getattr(time, name)


def _planes(monkeypatch, clock, tmp_path, alerts, fleet, flightrec, health, history,
            registry, tag):
    reg = registry.MetricsRegistry()
    rec = flightrec.FlightRecorder(dump_dir=str(tmp_path / tag))
    (tmp_path / tag).mkdir()
    hs = health.HealthState()
    fl = fleet.FleetState(stale_after=5.0)
    for mod in (registry, flightrec, health, fleet):
        monkeypatch.setattr(mod, "time", clock)
    monkeypatch.setattr(registry, "get_registry", lambda: reg)
    monkeypatch.setattr(flightrec, "get_flight_recorder", lambda: rec)
    monkeypatch.setattr(health, "get_health", lambda: hs)
    monkeypatch.setattr(fleet, "get_fleet", lambda: fl)
    hist = history.MetricsHistory(capacity=256, registry=reg)
    return SimpleNamespace(alerts=alerts, reg=reg, rec=rec, health=hs, fleet=fl, hist=hist,
                           engine=alerts.AlertEngine(history=hist), edges=[])


@pytest.fixture
def pair(monkeypatch, tmp_path):
    """(JAX planes, port planes, clock)."""
    for plane in (get_registry(), get_flight_recorder(), get_fleet()):
        plane.clear()
    get_health().reset()
    clock = Clock(T0)
    j = _planes(monkeypatch, clock, tmp_path, jalerts, jfleet, jflightrec, jhealth,
                jhistory, jregistry, "jax")
    p = _planes(monkeypatch, clock, tmp_path, palerts, pfleet, pflightrec, phealth,
                phistory, pregistry, "port")
    for side in (j, p):
        side.engine.subscribe(lambda ev, pl, side=side: side.edges.append((ev, pl)))
    yield j, p, clock
    for plane in (get_registry(), get_flight_recorder(), get_fleet()):
        plane.clear()
    get_health().reset()


def _rows(side):
    return side.engine.snapshot()


def _flight(side):
    return [{k: v for k, v in e.items() if k not in ("seq",)} for e in side.rec.events()]


def _gauges(side):
    fam = side.reg.dump().get("alerts_firing") or {}
    return {r["labels"]["rule"]: r["value"] for r in fam.get("children", [])}


def _same(j, p):
    assert _rows(p) == _rows(j)
    assert _flight(p) == _flight(j)
    assert _gauges(p) == _gauges(j)
    assert p.edges == j.edges
    assert p.health.snapshot()["problems"] == j.health.snapshot()["problems"]


# ------------------------------------------------------------ the feeds
def _feed_gauge(side, v, other):
    side.reg.gauge("queue_depth", "queued examples", model="m").set(v)
    side.reg.gauge("queue_depth", "queued examples", model="n").set(other)


def _feed_serving(side, ok, bad, lat_ms, traces):
    """ok/bad requests of model m, each latency latched with its trace id."""
    side.reg.counter("serving_requests_total", "requests", model="m", outcome="ok").inc(ok)
    side.reg.counter("serving_requests_total", "requests", model="m",
                     outcome="error").inc(bad)
    side.reg.counter("serving_requests_total", "requests", model="m",
                     outcome="rejected").inc(bad // 2)
    for ms, tr in zip(lat_ms, traces):
        side.reg.histogram("serving_request_latency_ms", "latency", model="m",
                           worker=tr[:2]).observe(float(ms), exemplar=tr)


def _serving_series(seed, n=30):
    """Per step: ok, bad, latencies, trace ids. Healthy, then an outage
    (errors and slow answers) from step 10 to 19, then healthy again."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        bad_phase = 10 <= i < 20
        ok = int(rng.integers(40, 60))
        bad = int(rng.integers(20, 40)) if bad_phase else int(rng.integers(0, 2))
        lat = rng.uniform(150, 900, 4) if bad_phase else rng.uniform(2, 40, 4)
        workers = ["r0", "r1"] if bad_phase else ["r0", "r0"]
        traces = [f"{workers[k % 2]}{i:03d}{k}{int(rng.integers(1 << 20)):05x}"
                  for k in range(4)]
        rows.append((ok, bad, lat, traces))
    return rows


RULES = {
    "threshold_value": (lambda a: [a.ThresholdRule("deep", "queue_depth", threshold=60.0,
                                                   labels={"model": "m"}, for_seconds=2.0)],
                        "gauge"),
    "threshold_value_max": (lambda a: [a.ThresholdRule("deep_any", "queue_depth",
                                                       threshold=60.0, agg="max", op=">=",
                                                       for_seconds=0.0, action="halt")],
                            "gauge"),
    "threshold_rate": (lambda a: [a.ThresholdRule("rejects", "serving_requests_total",
                                                  labels={"outcome": "rejected"},
                                                  threshold=5.0, mode="rate", window_s=4.0,
                                                  for_seconds=1.0)], "serving"),
    "threshold_max": (lambda a: [a.ThresholdRule("peak", "queue_depth", threshold=80.0,
                                                 mode="max", window_s=5.0, agg="max")],
                      "gauge"),
    "threshold_quantile": (lambda a: [a.ThresholdRule("slow_q", "serving_request_latency_ms",
                                                      labels={"model": "m"}, threshold=100.0,
                                                      mode="quantile", q=0.9, window_s=4.0,
                                                      for_seconds=1.0)], "serving"),
    "burn_availability": (lambda a: [a.BurnRateRule("burn", kind="availability", slo=0.95,
                                                    burn_factor=2.0, windows=(3.0, 8.0),
                                                    total_labels={"model": "m"},
                                                    for_seconds=1.0)], "serving"),
    "burn_latency": (lambda a: [a.BurnRateRule("p99", kind="latency", target_ms=120.0,
                                               windows=(3.0, 6.0), q=0.99,
                                               latency_labels={"model": "m"},
                                               for_seconds=1.0)], "serving"),
    "burn_latency_per_label": (lambda a: [a.BurnRateRule("p99_worst", kind="latency",
                                                         target_ms=120.0, windows=(3.0, 6.0),
                                                         per_label="worker",
                                                         for_seconds=0.0)], "serving"),
    "health_stall_and_problem": (lambda a: [
        a.HealthRule("stall", kind="stall", stall_after_s=4.0, for_seconds=1.0),
        a.HealthRule("nan", kind="problem", problem_kinds=("nan",), within_s=6.0)],
        "health"),
    "fleet_staleness": (lambda a: a.default_fleet_rules(for_seconds=1.0), "fleet"),
}


@pytest.mark.parametrize("kind", sorted(RULES))
def test_rule_kinds_step_for_step(pair, kind):
    """The same rules over the same series: equal rows, gauges, flight
    edges, listener edges and health problems at every step, and the
    rules walk OK -> PENDING/FIRING -> OK at least once."""
    j, p, clock = pair
    make, feed = RULES[kind]
    for side in (j, p):
        side.engine.add(*make(side.alerts))
    rng = np.random.default_rng(7)
    serving = _serving_series(11)
    walked = set()
    for i in range(30):
        clock.t = T0 + STEP_S * i
        v = 90.0 if 8 <= i < 16 else float(rng.integers(0, 50))
        other = float(rng.integers(0, 50))
        for side in (j, p):
            if feed == "gauge":
                _feed_gauge(side, v, other)
            elif feed == "serving":
                _feed_serving(side, *serving[i])
            elif feed == "health":
                if i < 12 or i >= 22:          # iterations stop from 12 to 21
                    side.health.record_iteration(i, 1.0 / (i + 1))
                if i in (3, 4):
                    side.health.record_problem("nan", f"score went NaN at {i}")
            elif feed == "fleet":
                if i < 10 or i >= 20:          # w1 goes quiet from 10 to 19
                    side.fleet.record_report("w1", {"registry": {}})
                side.fleet.record_report("w0", {"registry": {}})
            side.hist.sample(now=clock.t)
            side.engine.evaluate(now=clock.t, strict=False)
        _same(j, p)
        walked |= {r["state"] for r in _rows(p)["alerts"]}
    assert "FIRING" in walked, _rows(p)
    assert all(r["state"] == "OK" for r in _rows(p)["alerts"]), _rows(p)
    assert {ev for ev, _ in p.edges} == {"alert_firing", "alert_resolved"}
    if kind.startswith("burn_latency"):
        fired = [pl for ev, pl in p.edges if ev == "alert_firing"]
        assert all(pl["exemplar_trace_id"] for pl in fired), fired
    if kind == "burn_latency_per_label":
        assert any("worker=r1" in pl["detail"] for ev, pl in p.edges if ev == "alert_firing")


def test_exemplar_ttl_and_strict_raise(pair):
    """An exemplar past ``EXEMPLAR_TTL_S`` is not surfaced; ``action=
    "raise"`` raises ``AlertError`` from a strict evaluate in both and is
    downgraded with ``strict=False``."""
    j, p, clock = pair
    for side in (j, p):
        h = side.reg.histogram("serving_request_latency_ms", "latency", model="m")
        h.observe(900.0, exemplar="cold")
        side.engine.add(side.alerts.BurnRateRule("p99", kind="latency", target_ms=100.0,
                                                 windows=(1.0, 2.0),
                                                 latency_labels={"model": "m"}),
                        side.alerts.ThresholdRule("boom", "boom", threshold=1.0,
                                                  action="raise"))
        side.reg.gauge("boom", "x").set(5.0)
    rows = []
    for step in range(4):
        clock.t = T0 + step
        if step == 3:
            clock.t += pregistry.EXEMPLAR_TTL_S
        for side in (j, p):
            side.reg.histogram("serving_request_latency_ms", "latency",
                               model="m").observe(500.0 + step,
                                                  exemplar=f"t{step}" if step < 3 else None)
            side.hist.sample(now=clock.t)
            with pytest.raises(side.alerts.AlertError) if step == 0 else _nothing():
                side.engine.evaluate(now=clock.t, strict=step == 0)
        _same(j, p)
        rows.append({r["rule"]: r for r in _rows(p)["alerts"]})
    assert rows[2]["boom"]["state"] == "FIRING"
    assert rows[2]["p99"]["state"] == "FIRING" and rows[2]["p99"]["exemplar_trace_id"] == "cold"
    assert rows[3]["p99"]["exemplar_trace_id"] is None
    assert pregistry.EXEMPLAR_TTL_S == jregistry.EXEMPLAR_TTL_S
    for side in (j, p):
        h = side.reg.histogram("serving_request_latency_ms", "latency", model="m")
        assert h.worst_exemplar() is None      # every latched one is past the TTL


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_remove_and_clear_close_firing_rules(pair):
    """Removing a firing rule zeroes its gauge, records the closing
    ``alert_resolved`` and delivers it to listeners; ``clear`` does so for
    every firing rule; an unsubscribed listener hears nothing more; a
    failing listener is logged, not fatal."""
    j, p, clock = pair
    for side in (j, p):
        side.reg.gauge("g", "x").set(9.0)
        side.hist.sample(now=clock.t)
        side.engine.subscribe(lambda ev, pl: 1 / 0)
        side.engine.add(*(side.alerts.ThresholdRule(n, "g", threshold=1.0)
                          for n in ("a", "b", "c")))
        side.engine.evaluate(now=clock.t)
        side.engine.remove("a")
        late = []
        fn = late.append
        side.engine.subscribe(lambda ev, pl, fn=fn: fn(ev))
        side.engine.unsubscribe(side.engine._listeners[-1])
        side.engine.clear()
        assert late == [] and side.engine.rules() == []
    _same(j, p)
    assert [(ev, pl["rule"]) for ev, pl in p.edges] == [
        ("alert_firing", "a"), ("alert_firing", "b"), ("alert_firing", "c"),
        ("alert_resolved", "a"), ("alert_resolved", "b"), ("alert_resolved", "c")]
    assert _gauges(p) == {"a": 0.0, "b": 0.0, "c": 0.0}


def test_attach_evaluates_on_sampler_ticks_outside_the_lock(pair):
    """``attach`` evaluates on every history tick (idempotent); a listener
    that reads the engine from inside its callback does not deadlock
    (fan-out outside the engine lock); the locks carry the JAX names."""
    j, p, clock = pair
    prev = plockwatch.enabled()
    plockwatch.set_enabled(True)
    plockwatch.get_lockwatch().clear()
    try:
        hist = phistory.MetricsHistory(capacity=16, registry=p.reg)
        engine = palerts.AlertEngine(history=hist)
        seen = []
        engine.subscribe(lambda ev, pl: seen.append((ev, engine.firing(),
                                                     engine.snapshot()["firing"])))
        engine.add(palerts.ThresholdRule("hot", "g", threshold=1.0))
        engine.attach()
        engine.attach()
        p.reg.gauge("g", "x").set(5.0)
        hist.start(interval_s=60.0)          # the first tick runs at once
        deadline = time.monotonic() + 10
        while not seen and time.monotonic() < deadline:
            time.sleep(0.01)
        hist.stop()
        assert not hist.running()
        assert seen == [("alert_firing", ["hot"], ["hot"])], "listener fan-out under the lock"
        assert len(hist._listeners) == 1
        names = set(plockwatch.get_lockwatch().contention_table())
        assert {"AlertEngine._lock", "AlertEngine._eval_lock"} <= names
    finally:
        plockwatch.set_enabled(prev)
        plockwatch.get_lockwatch().clear()


def _pack_dicts(alerts, which):
    if which == "serving_model":
        rules = alerts.default_serving_rules("char_rnn", windows=(30.0, 120.0))
    elif which == "serving":
        rules = alerts.default_serving_rules()
    elif which == "training":
        rules = alerts.default_training_rules(stall_after_s=60.0)
    elif which == "fleet":
        rules = alerts.default_fleet_rules()
    elif which == "fleet_scope":
        rules = alerts.default_fleet_scope_rules(fleet=object(), p99_target_ms=80.0)
    elif which == "probe":
        rules = alerts.default_probe_rules(deadman_s=20.0)
    else:
        rules = alerts.default_rules(for_seconds=5.0, p99_target_ms=99.0)
    out = []
    for r in rules:
        d = r.to_dict()
        d["type"] = type(r).__name__
        d["params"] = {k: v for k, v in vars(r).items()
                       if k not in d and not callable(v) and k != "state"}
        out.append(d)
    return out


@pytest.mark.parametrize("which", ["serving_model", "serving", "training", "fleet",
                                   "fleet_scope", "probe", "rules"])
def test_default_packs_equal_jax(which):
    """Every rule pack's ``to_dict()`` (and each rule's parameters) equals
    JAX's."""
    assert _pack_dicts(palerts, which) == _pack_dicts(jalerts, which)
    assert palerts.DEFAULT_FOR_SECONDS == jalerts.DEFAULT_FOR_SECONDS


def test_alerts_route_and_metrics_gauge_over_http():
    """``GET /alerts`` on an ``InferenceServer`` evaluates the process
    engine at request time (always 200, JAX's keys) and ``/metrics``
    carries ``alerts_firing{rule=...}``; ``/healthz`` lists the problem."""
    from deeplearning4j_torch.monitor import get_alert_engine, get_history
    from deeplearning4j_torch.serving import InferenceServer

    for plane in (get_registry(), get_flight_recorder()):
        plane.clear()
    get_health().reset()
    engine, hist = get_alert_engine(), get_history()
    engine.clear()
    hist.clear()
    srv = InferenceServer()
    port = srv.start(port=0)
    try:
        get_registry().gauge("route_probe", "x").set(3.0)
        hist.sample()
        engine.add(palerts.ThresholdRule("route_hot", "route_probe", threshold=1.0))

        def get(path):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
                return r.status, r.read().decode()
        code, body = get("/alerts")
        doc = json.loads(body)
        assert code == 200 and set(doc) == {"alerts", "firing", "pending", "evaluated_at"}
        assert doc["firing"] == ["route_hot"]
        assert set(doc["alerts"][0]) == set(jalerts.ThresholdRule("x", "y", threshold=1.0)
                                            .to_dict())
        assert 'alerts_firing{rule="route_hot"} 1' in get("/metrics")[1]
        assert any(p.startswith("alert: alert route_hot FIRING")
                   for p in json.loads(get("/healthz")[1])["problems"])
    finally:
        srv.stop()
        engine.clear()
        hist.clear()
        get_health().reset()
        for plane in (get_registry(), get_flight_recorder()):
            plane.clear()
