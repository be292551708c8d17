"""The port's control plane (``deeplearning4j_torch/control/``) against the
JAX package's.

- The state machine: one sequence of alert edges and flight events, drawn
  from a numpy seed (or scripted to walk every transition), goes into a
  JAX ``ControlPlane`` and a port ``ControlPlane`` carrying the same
  policies with recording actuators, both ticked at the same ``now``.
  After every tick the states, the actuators' calls, ``actions()``,
  ``snapshot()``'s rows (``cooldown_remaining_s`` to 1e-9), the
  ``control_action`` flight events and the two series must be equal. Both
  packages run on private registries and flight recorders read through
  their ``get_*`` functions, with one synthetic clock.
- The pack on the port's real actuators, in process: the sharded group and
  the training master, a served model, a collector, a prober; the pack's
  composition against JAX's.
- The surfaces (``/control``, the ``/profile`` block), the daemon, the
  lock (a leaf under the lockwatch), and JAX's chaos drill with its
  servers in this process, ``/events`` read from the port's
  ``InferenceServer``.

The port's process-wide registry, flight recorder, history, alert engine,
control plane and incident recorder are reset around every test.
"""
import itertools
import json
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

from deeplearning4j_tpu.control import plane as jplane, policies as jpolicies
from deeplearning4j_tpu.monitor import flightrec as jflightrec, registry as jregistry

from deeplearning4j_torch.control import (ControlPlane, ControlPolicy, fleet_replica_policy,
                                          fleet_scale_policy, get_control_plane,
                                          probe_failure_policy, serving_pressure_policy,
                                          shard_restart_policy)
from deeplearning4j_torch.control import plane as pplane, policies as ppolicies
from deeplearning4j_torch.control.plane import COOLDOWN, OK
from deeplearning4j_torch.monitor import (BurnRateRule, IncidentRecorder, Prober,
                                          TelemetryCollector, ThresholdRule, get_alert_engine,
                                          get_fleet, get_flight_recorder, get_health,
                                          get_history, get_incident_recorder, get_registry,
                                          get_tracer, load_bundle, lockwatch, profile_report,
                                          render_profile_text)
from deeplearning4j_torch.monitor import flightrec as pflightrec, registry as pregistry
from deeplearning4j_torch.paramserver import (ParameterServerTrainingMaster,
                                              ShardedParameterServerClient,
                                              ShardedParameterServerGroup)
from deeplearning4j_torch.serving import TRACE_HEADER, InferenceServer, ModelRegistry

T0 = 50_000.0


def _reset_port():
    plane = get_control_plane()
    plane.stop(timeout=5.0)
    plane.clear()
    get_alert_engine().clear()
    get_history().clear()
    for p in (get_registry(), get_flight_recorder(), get_fleet(), get_tracer()):
        p.clear()
    get_health().reset()
    get_incident_recorder().clear()


@pytest.fixture(autouse=True)
def _clean_port_state():
    _reset_port()
    yield
    _reset_port()


class Clock:
    def __init__(self, t):
        self.t = t

    def time(self):
        return self.t

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture
def pair(monkeypatch):
    """Private registries and flight recorders for both packages, read on
    one synthetic clock."""
    clock = Clock(T0)
    sides = []
    for tag, registry, flightrec, plane in (("jax", jregistry, jflightrec, jplane),
                                           ("port", pregistry, pflightrec, pplane)):
        reg, rec = registry.MetricsRegistry(), flightrec.FlightRecorder()
        monkeypatch.setattr(registry, "get_registry", lambda reg=reg: reg)
        monkeypatch.setattr(flightrec, "get_flight_recorder", lambda rec=rec: rec)
        for mod in (flightrec, plane):
            monkeypatch.setattr(mod, "time", clock)
        sides.append(SimpleNamespace(tag=tag, plane_mod=plane, reg=reg, rec=rec, calls=[]))
    return sides[0], sides[1], clock


def _policies(side):
    """One set of policies over rules a, b, c and flight event ev_x, each
    actuator recording its call."""
    P = side.plane_mod.ControlPolicy
    calls = side.calls

    def act(tag):
        def fn(ctx):
            calls.append((tag, dict(ctx)))
            return f"{tag}_{ctx.get('value')}"
        return fn

    def boom(ctx):
        calls.append(("boom", dict(ctx)))
        raise RuntimeError(f"actuator failed on {ctx.get('rule')}")

    return [P("fire", act("fire"), rules=("a",), cooldown_s=5.0),
            P("sustain", act("sustain"), rules=("b",), sustain_s=3.0, cooldown_s=4.0,
              on_resolve=act("restore"), resolve_name="undo", description="held"),
            P("boom", boom, rules=("c",), cooldown_s=2.0, action_name="explode"),
            P("evt", act("evt"), event="ev_x", cooldown_s=3.0),
            P("multi", act("multi"), rules=("a", "c"), cooldown_s=1.0)]


def _scripted():
    """(dt, edges, flight events) steps walking every transition: fire,
    suppression in cooldown, a resolve before and after the cooldown,
    hysteresis cancel, sustain maturing, a same-batch fire+resolve cancel,
    an actuator error, event policies priming, suppressing and re-arming,
    a latch that holds until its alert resolves."""
    f = lambda r, v=1.0, ex=None: ("alert_firing", {"rule": r, "value": v, "detail": f"{r} hot",
                                                    "severity": "page", "exemplar_trace_id": ex})
    r = lambda r: ("alert_resolved", {"rule": r, "value": 0.0, "detail": f"{r} ok",
                                      "exemplar_trace_id": None})
    return [(0.0, [f("a", 9.0, "e1")], []),
            (1.0, [f("a", 9.5, "e2")], [("ev_x", {"shard": 1})]),
            (1.0, [r("a")], [("ev_x", {"shard": 2})]),
            (1.0, [f("b", 3.0, "e3")], []),
            (1.0, [r("b")], []),
            (1.0, [f("b", 4.0, "e4")], []),
            (1.0, [], []),
            (1.5, [], [("other", {"x": 1})]),
            (1.0, [], []),
            (1.0, [f("c", 7.0), r("c")], []),
            (1.0, [f("c", 8.0, "e5")], [("ev_x", {"shard": 3})]),
            (4.0, [f("a", 1.0)], []),
            (10.0, [], []),
            (1.0, [r("b")], []),
            (5.0, [r("c"), r("a")], [("ev_x", {"shard": 4})]),
            (1.0, [f("a", 2.0, "e6"), f("b", 5.0)], [])]


def _random(seed, n=40):
    rng = np.random.default_rng(seed)
    firing = {k: False for k in "abc"}
    steps = []
    for i in range(n):
        edges = []
        for k in "abc":
            u = rng.random()
            if u < 0.08:        # fire and resolve in one batch
                edges += [("alert_firing", {"rule": k, "value": float(i)}),
                          ("alert_resolved", {"rule": k})]
            elif u < 0.4:
                firing[k] = not firing[k]
                edges.append(("alert_firing" if firing[k] else "alert_resolved",
                              {"rule": k, "value": float(i),
                               "exemplar_trace_id": f"{seed:x}{i:04x}" if firing[k] else None}))
        events = [("ev_x", {"shard": int(rng.integers(0, 3))})] if rng.random() < 0.25 else []
        steps.append((float(rng.choice([0.25, 0.5, 1.0, 2.0, 3.5])), edges, events))
    return steps


def _family(reg, name):
    fam = reg.dump().get(name) or {"children": []}
    return sorted((tuple(sorted(c["labels"].items())), c["value"]) for c in fam["children"])


def _view(side, plane):
    snap = plane.snapshot()
    rows = [{k: v for k, v in row.items() if k != "cooldown_remaining_s"}
            for row in snap["policies"]]
    return {"states": {p.name: p.state for p in plane.policies()},
            "rows": rows, "cooldowns_active": snap["cooldowns_active"],
            "evaluated_at": snap["evaluated_at"], "actions": plane.actions(),
            "block": plane.block(), "calls": list(side.calls),
            "flight": side.rec.events(),
            "counters": _family(side.reg, "control_actions_total"),
            "gauges": _family(side.reg, "control_cooldown_active")}, \
        [row["cooldown_remaining_s"] for row in snap["policies"]]


@pytest.mark.parametrize("script", ["scripted", 0, 1, 2])
def test_state_machine_equals_jax(pair, script):
    j, p, clock = pair
    steps = _scripted() if script == "scripted" else _random(script)
    planes = []
    for side in (j, p):
        plane = side.plane_mod.ControlPlane(engine=object())
        plane.add(*_policies(side))
        plane._prime_cursor()
        planes.append(plane)
    seen = set()
    for dt, edges, events in steps:
        clock.t += dt
        ran = []
        for side, plane in zip((j, p), planes):
            for kind, fields in events:
                side.rec.record(kind, **fields)
            for ev, payload in edges:
                plane._on_edge(ev, dict(payload))
            ran.append(plane.tick(now=clock.t))
        (jv, jrem), (pv, prem) = _view(j, planes[0]), _view(p, planes[1])
        assert ran[1] == ran[0]
        assert pv == jv
        np.testing.assert_allclose(prem, jrem, rtol=0, atol=1e-9)
        seen |= {a["outcome"] for a in pv["actions"]}
        seen |= {s for s in pv["states"].values()}
    if script == "scripted":
        pol = {x.name: x for x in planes[1].policies()}
        assert seen >= {"fire_9.0", "restore_0.0", "sustain_4.0", "error", "evt_None",
                        "multi_9.0", "multi_8.0", "PENDING", "COOLDOWN", "OK"}, seen
        assert pol["fire"].suppressed_count == 1 and pol["evt"].suppressed_count >= 1
        assert [c[0] for c in p.calls].count("boom") == 1        # the cancelled batch never ran
        assert pol["sustain"].fired_count == 1                     # the transient was swallowed
        assert pol["fire"].fired_count == 3


def _remove_mid_action(mod, rec):
    started, release = threading.Event(), threading.Event()

    def blocking(ctx):
        started.set()
        release.wait(5.0)
        return "done"
    plane = mod.ControlPlane(engine=object()).add(
        mod.ControlPolicy("racey", blocking, rules=("race_rule",), cooldown_s=30.0,
                          action_name="block"))
    plane._on_edge("alert_firing", {"rule": "race_rule"})
    t = threading.Thread(target=plane.tick, kwargs={"now": T0}, daemon=True)
    t.start()
    assert started.wait(5.0)
    plane.remove("racey")
    release.set()
    t.join(5.0)
    assert not t.is_alive()
    return ([{k: v for k, v in e.items() if k != "seq"} for e in rec.events()],
            plane.policies(), plane.actions(), plane.snapshot()["cooldowns_active"])


def test_remove_mid_action_equals_jax(pair):
    """A policy removed while its actuator runs: the action's flight event
    stands, its bookkeeping and its cooldown gauge do not."""
    j, p, _ = pair
    got = [_remove_mid_action(side.plane_mod, side.rec) for side in (j, p)]
    assert got[1] == got[0]
    events, policies, actions, cooling = got[1]
    assert [e["outcome"] for e in events if e["event"] == "control_action"] == ["done"]
    assert policies == [] and actions == [] and cooling == []
    for side in (j, p):
        assert side.reg.gauge("control_cooldown_active", policy="racey").value == 0.0


def test_policy_validation_and_clear():
    with pytest.raises(ValueError, match="matches nothing"):
        ControlPolicy("matchless", lambda ctx: None)
    plane = ControlPlane().add(ControlPolicy("dup", lambda ctx: "ok", rules=("r",),
                                             cooldown_s=30.0),
                               ControlPolicy("other", lambda ctx: "ok", rules=("r",),
                                             cooldown_s=30.0))
    with pytest.raises(ValueError, match="already registered"):
        plane.add(ControlPolicy("dup", lambda ctx: None, rules=("r",)))
    plane._on_edge("alert_firing", {"rule": "r"})
    assert plane.tick(now=T0) == 2
    gauge = lambda n: get_registry().gauge("control_cooldown_active", policy=n).value
    assert gauge("dup") == gauge("other") == 1.0
    plane.clear()
    assert gauge("dup") == gauge("other") == 0.0
    assert plane.policies() == [] and plane.actions() == [] and plane.block() == {}


# ----------------------------------------------------- the pack, real actuators
class Stub:
    """A served stub with an injectable delay."""

    def __init__(self):
        self.delay_s = 0.0

    def output(self, x, mask=None):
        if self.delay_s:
            time.sleep(self.delay_s)
        return np.full((np.asarray(x).shape[0], 2), 1.0, np.float32)


def test_serving_pressure_steps_and_restores_a_served_model():
    reg = ModelRegistry()
    reg.register("press", Stub(), device="cpu", input_shape=(2,), batch_buckets=(1, 2),
                 linger_ms=5.0, max_queue_examples=64)
    try:
        served = reg.get("press")
        pol = serving_pressure_policy(reg, "press", rules=("p99x",), factor=0.5, min_cap=8,
                                      cooldown_s=5.0)
        plane = ControlPlane().add(pol)
        plane._on_edge("alert_firing", {"rule": "p99x", "exemplar_trace_id": "abc123",
                                        "detail": "p99 120ms"})
        plane.tick(now=T0)
        assert (served.batcher.max_queue_examples, served.batcher.linger_ms) == (32, 0.0)
        assert pol.last_action["outcome"] == "cap_32"
        assert pol.last_action["exemplar_trace_id"] == "abc123"
        plane._on_edge("alert_firing", {"rule": "p99x"})
        plane.tick(now=T0 + 1.0)                        # suppressed: one step per incident
        assert served.batcher.max_queue_examples == 32
        plane._on_edge("alert_resolved", {"rule": "p99x"})
        plane.tick(now=T0 + 2.0)
        assert (served.batcher.max_queue_examples, served.batcher.linger_ms) == (64, 5.0)
        assert pol.last_action["outcome"] == "restored" and pol.state == COOLDOWN
        plane.tick(now=T0 + 6.0)
        assert pol.state == OK and pol.on_resolve({}) == "nothing_to_restore"
        plane._on_edge("alert_firing", {"rule": "p99x"})
        plane.tick(now=T0 + 7.0)
        assert served.batcher.max_queue_examples == 32
        assert reg.predict("press", np.ones((1, 2), np.float32)).shape == (1, 2)
    finally:
        reg.close_all()


def _events(kind):
    return [e for e in get_flight_recorder().events() if e.get("event") == kind]


def test_shard_restart_from_the_latched_snapshot():
    n = 10
    vec = np.arange(n, dtype=np.float32)
    with ShardedParameterServerGroup(2) as group:
        c = ShardedParameterServerClient(group.addresses, max_retries=0, backoff=0.01,
                                         down_backoff=0.05)
        try:
            c.set_params(vec)
            pol = shard_restart_policy(group, cooldown_s=30.0)
            plane = ControlPlane().add(pol)
            plane._prime_cursor()
            srv0 = group.servers[0]
            get_flight_recorder().record("shard_server_down", shard=0, worker="w0",
                                         error="transient")
            assert plane.tick() == 1 and pol.last_action["outcome"] == "still_running"
            assert group.servers[0] is srv0
            plane.tick(now=time.time() + 60.0)          # re-arms on the cooldown alone
            group.kill(1)
            idx, signs = np.array([0, 1], np.int32), np.array([1, 1], np.int8)
            versions, failed = c.push_encoded((idx, signs, 0.5, n))
            assert versions[1] is None and failed is not None
            assert plane.tick() == 1
            assert pol.last_action["outcome"] == "restarted"
            assert pol.last_action["rule"] == "shard_server_down"
            assert group.servers[1]._running and plane.tick() == 0
            time.sleep(0.06)
            _, out = c.pull()
            want = vec.copy()
            want[0] -= 0.5
            np.testing.assert_array_equal(out, want)
            assert len(_events("shard_server_restored")) == 1
            plane.tick(now=time.time() + 60.0)
            get_flight_recorder().record("shard_server_down", shard=7)
            plane.tick(now=time.time() + 61.0)
            assert pol.last_action["outcome"] == "unknown_shard"
        finally:
            c.close()


def test_fleet_scale_remaps_the_master_then_reports_at_max():
    vec = np.arange(12, dtype=np.float32)
    with ShardedParameterServerGroup(2) as group:
        master = ParameterServerTrainingMaster(group.address, staleness=0, backoff=0.01,
                                               max_retries=1)
        try:
            with ShardedParameterServerClient(group.addresses, max_retries=1,
                                              backoff=0.01) as c:
                c.set_params(vec)
            pol = fleet_scale_policy(group, master, max_servers=3, cooldown_s=5.0)
            plane = ControlPlane().add(pol)
            plane._on_edge("alert_firing", {"rule": "fleet_worker_stale"})
            plane.tick(now=T0)
            assert group.num_servers == 3 and pol.last_action["outcome"] == "scaled_to_3"
            assert master.server_address == ",".join(group.addresses)
            with ShardedParameterServerClient(group.addresses, max_retries=1,
                                              backoff=0.01) as c:
                np.testing.assert_array_equal(c.pull()[1], vec)
            plane._on_edge("alert_resolved", {"rule": "fleet_worker_stale"})
            plane.tick(now=T0 + 6.0)
            plane._on_edge("alert_firing", {"rule": "fleet_worker_stale"})
            plane.tick(now=T0 + 7.0)
            assert pol.last_action["outcome"] == "at_max" and group.num_servers == 3
        finally:
            master.close()


def _dead_address():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def test_replica_and_probe_policies_ask_at_fire_time():
    """fleet_replica_policy restarts what the collector sees down, and
    probe_failure_policy what the prober sees failing, at fire time: a
    target that recovered before the plane acted is not bounced."""
    srv = InferenceServer()
    srv.register("up", Stub(), device="cpu", input_shape=(2,), batch_buckets=(1, 2),
                 linger_ms=0.0)
    port = srv.start(port=0)
    restarted = []
    try:
        collector = TelemetryCollector(timeout_s=2.0)
        collector.add_target("alive", f"127.0.0.1:{port}")
        collector.add_target("gone", _dead_address())
        prober = Prober(timeout_s=2.0)
        golden = srv.registry.get("up").golden()
        prober.add_target("ok", f"127.0.0.1:{port}", golden)
        bad = dict(golden, outputs=(np.asarray(golden["outputs"]) + 5.0).tolist())
        prober.add_target("wrong", f"127.0.0.1:{port}", bad)
        pols = [fleet_replica_policy(collector, lambda lab, url: restarted.append(("fleet", lab)),
                                     cooldown_s=5.0),
                probe_failure_policy(prober, lambda lab, url: restarted.append(("probe", lab)),
                                     cooldown_s=5.0)]
        plane = ControlPlane().add(*pols)
        for rule in ("fleet_target_down", "probe_mismatch"):
            plane._on_edge("alert_firing", {"rule": rule})
        plane.tick(now=T0)                       # nothing scraped or probed yet
        assert [x.last_action["outcome"] for x in pols] == ["none_down", "none_failing"]
        collector.tick(now=T0 + 1.0)
        prober.tick(now=T0 + 1.0)
        assert [t.label for t in collector.down_targets()] == ["gone"]
        assert [t.label for t in prober.failing_targets()] == ["wrong"]
        for rule in ("fleet_target_down", "probe_mismatch", "probe_deadman"):
            plane._on_edge("alert_resolved", {"rule": rule})
        plane.tick(now=T0 + 10.0)
        for rule in ("fleet_target_down", "probe_deadman"):
            plane._on_edge("alert_firing", {"rule": rule})
        plane.tick(now=T0 + 11.0)
        assert [x.last_action["outcome"] for x in pols] == ["restarted_gone", "restarted_wrong"]
        assert restarted == [("fleet", "gone"), ("probe", "wrong")]
        collector.stop()
        prober.stop()
    finally:
        srv.stop()


@pytest.mark.parametrize("kw", [
    dict(group=1, master=2, registry=3, model="mnist", cooldown_s=2.5),
    dict(registry=3, model="m", collector=4, restart=5, prober=6, sustain_s=1.5),
    dict(group=1, prober=6, probe_restart=7, rule="custom_stale", factor=0.25)])
def test_default_pack_composition_equals_jax(kw):
    def rows(pols):
        return [(x.name, x.rules, x.event, x.action_name, x.resolve_name, x.cooldown_s,
                 x.sustain_s, x.description, x.on_resolve is not None) for x in pols]
    got = rows(ppolicies.default_control_policies(**kw))
    assert got == rows(jpolicies.default_control_policies(**kw)) and got


# ------------------------------------------------------------- surfaces
def test_control_route_profile_block_and_daemon():
    assert profile_report()["control"] == {}
    plane = get_control_plane()
    engine = get_alert_engine()
    plane.add(ControlPolicy("surface_probe", lambda ctx: "ok", rules=("surface_rule",),
                            cooldown_s=1.0))
    rep = profile_report()
    assert rep["control"] == {"policies": 1, "running": False, "cooldowns_active": 0,
                              "pending": 0, "actions_total": 0, "last_action": None}
    assert "# control" in render_profile_text(rep)
    srv = InferenceServer()
    port = srv.start(port=0)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/control", timeout=10) as r:
            status, doc = r.status, json.loads(r.read())
        assert status == 200
        assert set(doc) == set(jplane.ControlPlane().snapshot())
        assert [row["policy"] for row in doc["policies"]] == ["surface_probe"]
        assert set(doc["policies"][0]) == set(
            jplane.ControlPolicy("x", lambda c: None, rules=("r",)).to_dict(0.0))
        assert doc["policies"][0]["state"] == OK and doc["running"] is False
    finally:
        srv.stop()
    plane.start(interval_s=0.02)
    plane.start()
    assert plane.running() and plane.snapshot()["running"] is True
    assert [t.name for t in threading.enumerate()].count("control-plane") == 1
    deadline = time.monotonic() + 5.0
    while plane.last_tick is None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert plane.last_tick is not None and plane._on_edge in engine._listeners
    plane.stop()
    assert not plane.running() and plane._on_edge not in engine._listeners
    assert "control-plane" not in [t.name for t in threading.enumerate()]


def test_the_plane_lock_is_a_leaf():
    """Under the lockwatch ``ControlPlane._lock`` is acquired and no other
    lock is taken while it is held (JAX's ``tests/test_lockwatch.py``
    control flows: edges, a flight-event policy, actions, the surfaces,
    removal)."""
    prev = lockwatch.enabled()
    lockwatch.set_enabled(True)
    watch = lockwatch.get_lockwatch()
    watch.clear()
    try:
        plane = ControlPlane(engine=get_alert_engine())
        plane.add(ControlPolicy("lw_edge", lambda ctx: "ok", rules=("lw_rule",),
                                cooldown_s=0.05),
                  ControlPolicy("lw_evt", lambda ctx: "ok", event="lw_probe_evt",
                                cooldown_s=0.05))
        plane._prime_cursor()
        plane._on_edge("alert_firing", {"rule": "lw_rule", "exemplar_trace_id": None})
        get_flight_recorder().record("lw_probe_evt", shard=0)
        assert plane.tick() == 2
        plane._on_edge("alert_resolved", {"rule": "lw_rule"})
        plane.tick(now=time.time() + 1.0)
        plane.snapshot()
        plane.block()
        plane.actions()
        plane.start(interval_s=0.01)
        plane.stop()
        plane.remove("lw_edge")
        plane.clear()
        table = watch.contention_table()
        assert table["ControlPlane._lock"]["acquisitions"] > 0
        assert not [e for e in watch.observed_edges() if e[0] == "ControlPlane._lock"]
        assert watch.inversions() == []
    finally:
        lockwatch.set_enabled(prev)
        watch.clear()


# ----------------------------------------------------------- the chaos drill
def _post(url, doc, headers=None):
    req = urllib.request.Request(url, data=json.dumps(doc).encode("utf-8"),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        body = json.loads(e.read())
        e.close()
        return e.code, body


def test_chaos_drill_recovers_alert_free_and_reconstructs(tmp_path):
    """JAX's chaos drill on the port, servers in this process: a slow
    served model and a killed shard at once, the plane's daemon running.
    Admission steps then restores, the shard restarts from its latched
    snapshot, each action fires once, every alert resolves, ``/events``
    tells it in seq order, and the incident recorder merges the two
    overlapping rules into one persisted incident holding both actions."""
    model = Stub()
    srv = InferenceServer()
    srv.register("chaos", model, device="cpu", input_shape=(2,), batch_buckets=(1, 2, 4),
                 linger_ms=0.5, max_queue_examples=64, qps_window_s=1.0)
    port = srv.start(port=0)
    base = f"http://127.0.0.1:{port}"
    url = f"{base}/v1/models/chaos/predict"
    engine, hist = get_alert_engine(), get_history()
    engine.add(BurnRateRule("chaos_p99", kind="latency", target_ms=40.0, windows=(1.5, 3.0),
                            latency_labels={"model": "chaos"}, for_seconds=0.2),
               ThresholdRule("chaos_shard_unavailable", "paramserver_shard_unavailable_total",
                             threshold=0.0, mode="rate", window_s=1.0, for_seconds=0.0))
    n = 8
    vec = np.arange(n, dtype=np.float32)
    group = ShardedParameterServerGroup(2)
    client = ShardedParameterServerClient(group.addresses, max_retries=0, backoff=0.01,
                                          down_backoff=0.05)
    plane = get_control_plane()
    plane.add(serving_pressure_policy(srv.registry, "chaos", rules=("chaos_p99",), factor=0.5,
                                      min_cap=8, cooldown_s=0.5),
              shard_restart_policy(group, cooldown_s=0.5))
    recorder = IncidentRecorder(engine=engine, dump_dir=str(tmp_path))
    served = srv.registry.get("chaos")
    trace = itertools.count(1)

    def drive(k):
        for _ in range(k):
            _post(url, {"inputs": [[1.0, 2.0]]}, headers={TRACE_HEADER: f"{next(trace):08x}:1"})
        hist.sample()
        engine.evaluate(strict=False)

    def acts(name):
        return [a for a in plane.actions() if a["action"] == name]
    idx, signs = np.array([0, 1], np.int32), np.array([1, 1], np.int8)
    try:
        client.set_params(vec)
        plane.start(interval_s=0.05)
        recorder.start(interval_s=0.05)
        drive(6)
        time.sleep(0.15)
        assert engine.firing() == [] and plane.actions() == []

        model.delay_s = 0.12
        deadline = time.monotonic() + 25.0
        while time.monotonic() < deadline and not acts("set_admission"):
            drive(3)
        stepped = acts("set_admission")
        assert len(stepped) == 1, [(r.name, r.state, r.last_detail) for r in engine.rules()]
        assert stepped[0]["rule"] == "chaos_p99" and stepped[0]["outcome"] == "cap_32"
        assert stepped[0]["exemplar_trace_id"]
        assert (served.batcher.max_queue_examples, served.batcher.linger_ms) == (32, 0.0)

        group.kill(1)
        versions, failed = client.push_encoded((idx, signs, 0.5, n))
        assert versions[1] is None and failed is not None
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and not acts("restart"):
            drive(1)
        restarted = acts("restart")
        assert len(restarted) == 1
        assert (restarted[0]["rule"], restarted[0]["outcome"]) == ("shard_server_down",
                                                                  "restarted")
        assert group.servers[1]._running
        time.sleep(0.06)
        versions, failed = client.push_encoded((idx, signs, 0.5, n))
        assert versions[1] is not None and failed is None

        model.delay_s = 0.0
        deadline = time.monotonic() + 25.0
        while time.monotonic() < deadline:
            drive(4)
            if not engine.firing() and acts("restore_admission") \
                    and not recorder.snapshot()["open"]:
                break
            time.sleep(0.2)
        assert engine.firing() == [], [(r.name, r.state, r.last_detail) for r in engine.rules()]
        restores = acts("restore_admission")
        assert len(restores) == 1 and restores[0]["outcome"] == "restored"
        assert (served.batcher.max_queue_examples, served.batcher.linger_ms) == (64, 0.5)
        ca = _events("control_action")
        assert [e["action"] for e in ca].count("set_admission") == 1
        assert [e["action"] for e in ca].count("restart") == 1

        with urllib.request.urlopen(f"{base}/events", timeout=10) as r:
            evs = json.loads(r.read())["events"]

        def seq(pred):
            return next(e["seq"] for e in evs if pred(e))
        fire = seq(lambda e: e["event"] == "alert_firing" and e["rule"] == "chaos_p99")
        step = seq(lambda e: e["event"] == "control_action" and e["action"] == "set_admission")
        down = seq(lambda e: e["event"] == "shard_server_down")
        restart = seq(lambda e: e["event"] == "control_action" and e["action"] == "restart")
        restored = seq(lambda e: e["event"] == "shard_server_restored")
        resolved = seq(lambda e: e["event"] == "alert_resolved" and e["rule"] == "chaos_p99")
        restore = seq(lambda e: e["event"] == "control_action"
                      and e["action"] == "restore_admission")
        assert fire < step and down < restart < restored and resolved < restore
        step_ev = next(e for e in evs if e["seq"] == step)
        fire_ev = next(e for e in evs if e["seq"] == fire)
        assert step_ev["exemplar_trace_id"] == fire_ev["exemplar_trace_id"]

        with urllib.request.urlopen(f"{base}/control", timeout=10) as r:
            doc = json.loads(r.read())
        byname = {row["policy"]: row for row in doc["policies"]}
        assert byname["serving_pressure_chaos"]["fired_count"] == 1
        assert byname["shard_restart"]["fired_count"] == 1 and doc["running"] is True

        (inc,) = recorder.incidents()
        assert inc.status == "resolved"
        assert set(inc.rules) == {"chaos_p99", "chaos_shard_unavailable"}
        (path,) = tmp_path.glob("*.dl4jinc")
        bundle = load_bundle(str(path))
        assert [a["action"] for a in bundle["control_actions"]][:2] == ["set_admission",
                                                                        "restart"]
        assert bundle["rules"]["chaos_p99"]["exemplar_spans"]
    finally:
        recorder.stop()
        plane.stop()
        client.close()
        group.stop()
        srv.stop()
