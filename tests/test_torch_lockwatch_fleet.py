"""The port's lockwatch and fleet table (``deeplearning4j_torch/monitor/
lockwatch.py``, ``fleet.py``) against the JAX package's.

- Lockwatch: the counterparts of ``tests/test_lockwatch.py``'s first six
  tests (plain primitives when off; metrics and the contention table;
  RLock re-entry; order edges; ``Condition.wait`` releasing the hold; the
  hold-time flight event), a runtime lock-order inversion, and one flow
  (a parameter server, its client's sharded pull and a prefetch epoch) run
  under both packages' lockwatch: the same lock names are acquired, so the
  port's locks carry the JAX names the JAX static lock graph reads.
- Fleet: ``merge_traces`` and ``FleetState`` fed the same reports in both
  packages give the same documents (liveness, merged dump and scrape with
  the age rows set aside, the per-shard block, the merged trace with its
  stable pid rows, the worst exemplar); the health snapshot folds the
  fleet's liveness in.

Staleness is made by ageing a worker's ``last_seen`` by hand, so no test
waits on the clock.
"""
import copy
import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu import monitor as jmon
from deeplearning4j_tpu.datasets.prefetch import PrefetchIterator as JPrefetchIterator
from deeplearning4j_tpu.monitor import lockwatch as jlockwatch
from deeplearning4j_tpu import paramserver as jps

from deeplearning4j_torch.datasets.prefetch import PrefetchIterator
from deeplearning4j_torch.monitor import (FleetState, get_fleet, get_flight_recorder,
                                          get_health, get_registry, lockwatch, merge_traces)
from deeplearning4j_torch.parallel.accumulation import serialize_encoded
from deeplearning4j_torch import paramserver as ps


@pytest.fixture(autouse=True)
def _fresh_monitor():
    for plane in (get_registry(), get_flight_recorder(), get_fleet()):
        plane.clear()
    get_health().reset()
    yield
    get_health().reset()


@pytest.fixture
def watch():
    """The port's lockwatch on for the test, restored and cleared after."""
    prev = lockwatch.enabled()
    lockwatch.set_enabled(True)
    w = lockwatch.get_lockwatch()
    w.clear()
    try:
        yield w
    finally:
        lockwatch.set_enabled(prev)
        w.clear()


# ---------------------------------------------------------------- lockwatch
def test_factory_returns_plain_primitives_when_disabled():
    assert not lockwatch.enabled()
    assert not isinstance(lockwatch.make_lock("X.l"), lockwatch.InstrumentedLock)
    assert isinstance(lockwatch.make_rlock("X.r"), type(threading.RLock()))
    assert isinstance(lockwatch.make_condition("X.c"), threading.Condition)


def test_instrumented_lock_metrics_and_contention_table(watch):
    lk = lockwatch.make_lock("Unit.alpha")
    assert isinstance(lk, lockwatch.InstrumentedLock)
    for _ in range(3):
        with lk:
            pass
    assert lk.acquire(blocking=False)
    lk.release()
    table = watch.contention_table()
    assert table["Unit.alpha"]["acquisitions"] == 4
    assert table["Unit.alpha"]["held_s_max"] >= 0.0 and "wait_s_p95" in table["Unit.alpha"]
    dump = get_registry().dump()
    assert [r["value"] for r in dump["lock_acquisitions_total"]["children"]
            if r["labels"] == {"lock": "Unit.alpha"}] == [4]
    assert dump["lock_wait_seconds"]["unit"] == dump["lock_held_seconds"]["unit"] == "s"


def test_rlock_reentrancy_counts_once_on_the_stack(watch):
    r = lockwatch.make_rlock("Unit.re")
    with r:
        with r:
            pass
    assert watch.observed_edges() == set()
    assert watch.contention_table()["Unit.re"]["acquisitions"] == 2


def test_order_edges_and_inversion(watch):
    """A consistent order gives one edge and no inversion; the first
    acquisition in the other order closes a cycle: one
    ``lock_order_inversion`` flight event and health problem, with both
    witnesses."""
    a, b = lockwatch.make_lock("Unit.a"), lockwatch.make_lock("Unit.b")
    for _ in range(2):
        with a:
            with b:
                pass
    assert watch.observed_edges() == {("Unit.a", "Unit.b")} and watch.inversions() == []
    for _ in range(2):
        with b:
            with a:
                pass
    inv = watch.inversions()
    assert len(inv) == 1 and inv[0]["locks"] == ["Unit.a", "Unit.b"]
    assert "Unit.b at" in inv[0]["path_forward"] and "Unit.a at" in inv[0]["path_reverse"]
    events = [e for e in get_flight_recorder().events() if e["event"] == "lock_order_inversion"]
    assert len(events) == 1 and events[0]["locks"] == ["Unit.a", "Unit.b"]
    assert any(p.startswith("lock_order_inversion") for p in get_health().snapshot()["problems"])
    assert watch.contention_table()["_inversions"] == {"count": 1}


def test_condition_wait_releases_the_tracked_hold(watch):
    cond = lockwatch.make_condition("Unit.cond")
    other = lockwatch.make_lock("Unit.other")
    hits = []
    parked = threading.Event()

    def waiter():
        with cond:
            hits.append("waiting")
            parked.set()
            while "go" not in hits:
                cond.wait(5.0)
            hits.append("woke")

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    assert parked.wait(5.0)
    with cond:               # taken while the waiter is parked inside wait()
        hits.append("go")
        cond.notify_all()
    t.join(timeout=5)
    assert not t.is_alive() and hits == ["waiting", "go", "woke"]
    with cond:
        with other:
            pass
    assert ("Unit.cond", "Unit.other") in watch.observed_edges()


def test_hold_time_threshold_fires_flight_event(watch, monkeypatch):
    monkeypatch.setattr(lockwatch, "HOLD_THRESHOLD_S", 0.05)
    lk = lockwatch.make_lock("Unit.slow")
    with lk:
        time.sleep(0.08)
    events = [e for e in get_flight_recorder().events() if e["event"] == "lock_hold_exceeded"]
    assert len(events) == 1 and events[0]["lock"] == "Unit.slow"
    assert events[0]["held_s"] > 0.05 and events[0]["threshold_s"] == 0.05
    assert watch.hold_events()
    assert any("lock_hold" in p for p in get_health().snapshot()["problems"])


def _lock_flow(pkg, prefetch_cls):
    """A server, a pooled client's parallel shard pulls and a push, and a
    prefetch epoch: the locks a parameter-server worker and its input
    pipeline take."""
    with pkg.ParameterServer(port=0, num_shards=2) as srv:
        with pkg.ParameterServerClient(srv.address, pool_size=2, max_retries=1,
                                       backoff=0.01) as c:
            c.set_params(np.arange(8, dtype=np.float32))
            c.pull_sharded(2)
            c.push_update(serialize_encoded(
                (np.array([1], np.int32), np.array([1], np.int8), 0.5, 8)))
    assert list(prefetch_cls(iter(range(5)), workers=2)) == list(range(5))


def test_port_locks_carry_the_jax_names(watch):
    """One flow under both packages' lockwatch acquires the same named
    locks (and no port lock under a name of its own)."""
    _lock_flow(ps, PrefetchIterator)
    port_locks = watch.observed_locks()
    prev = jlockwatch.enabled()
    jlockwatch.set_enabled(True)
    jw = jlockwatch.get_lockwatch()
    jw.clear()
    try:
        _lock_flow(jps, JPrefetchIterator)
        jax_locks = jw.observed_locks()
    finally:
        jlockwatch.set_enabled(prev)
        jw.clear()
    assert port_locks == jax_locks
    assert {"ParameterServer._lock", "ParameterServer._op_lock",
            "ParameterServerClient._pool_lock", "Fanout._lock", "ParamServerMetrics._lock",
            "_Epoch.cond", "PrefetchIterator._pull_lock"} <= port_locks
    assert watch.inversions() == []


# -------------------------------------------------------------------- fleet
def _trace_span(i, trace_id="7", ts=None):
    return {"name": f"s{i}", "ph": "X", "pid": 0, "tid": 1,
            "ts": i * 10 if ts is None else ts, "dur": 5,
            "args": {"trace_id": trace_id, "span_id": str(i)}}


def _reports():
    """Per-worker reports as the wire carries them: registry dumps (with
    the sharded client's series), ring tails that overlap, flight events,
    exemplars and health."""
    def reg_dump(pkg, k):
        reg = pkg.MetricsRegistry()
        reg.counter("jobs_total", "jobs", kind="a").inc(3 + k)
        reg.histogram("lat_ms", "latency", op="push").observe(1.5 * (k + 1))
        for shard in ("0", "1"):
            reg.gauge("paramserver_shard_staleness", "lag", role="client",
                      shard=shard).set(k + int(shard))
            for d in ("tx", "rx"):
                reg.counter("paramserver_wire_bytes_total", "wire", role="client", op="push",
                            shard=shard, direction=d).inc(100 * (k + 1))
                reg.counter("paramserver_wire_bytes_total", "wire", role="server", op="push",
                            shard=shard, direction=d).inc(7)
        return reg.dump()
    out = []
    for k, worker in enumerate(("b", "a", "b")):
        out.append((worker, {
            "registry": reg_dump(jmon, k),
            "trace_events": [_trace_span(k), _trace_span(k + 1)],
            "flight_events": [{"event": "worker_join", "seq": k}],
            "exemplars": {"lat_ms": [{"value": 1.5 * (k + 1), "exemplar": f"t{k}"}]},
            "health": {"healthy": True}}))
    out.append(("c", {"registry": {"x_total": {"type": "gauge", "help": "", "children": [
        {"labels": {}, "value": 9.0}]}}}))
    out.append(("d", {"registry": {"x_total": {"type": "counter", "help": "", "children": [
        {"labels": {}, "value": 1.0}]}}}))
    return out


def _feed(fleet):
    for worker, report in _reports():
        fleet.record_report(worker, copy.deepcopy(report))
    with fleet._lock:
        fleet._workers["a"]["last_seen"] -= 60.0     # "a" went silent


def _without_ages(dump):
    dump = copy.deepcopy(dump)
    dump.pop("fleet_worker_last_seen_age_s")
    return dump


def test_merge_traces_gives_jax_s_document():
    """Pid rows (mapped and first-seen), metadata rows, and the global
    dedup of overlapping windows, label for label as JAX's."""
    named = {"worker:w2": [_trace_span(1), _trace_span(2)],
             "server": [_trace_span(2), _trace_span(3), {"name": "meta", "ph": "M", "pid": 9}],
             "worker:w1": [_trace_span(4, trace_id="8")]}
    for pids in (None, {"server": 5}, {"worker:w1": 0, "server": 1}):
        assert merge_traces(copy.deepcopy(named), pids=pids) == \
            jmon.merge_traces(copy.deepcopy(named), pids=pids)
    doc = merge_traces(named)
    assert [e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"] == \
        ["s2", "s3", "s4", "s1"]


def test_fleet_state_gives_jax_s_answers_on_the_same_reports():
    port, jax_ = FleetState(stale_after=15.0), jmon.FleetState(stale_after=15.0)
    _feed(port)
    _feed(jax_)
    lp, lj = port.liveness(), jax_.liveness()
    for live in (lp, lj):
        for w in live["workers"].values():
            w.pop("last_seen_age_s")
    assert lp == lj
    assert lp["stale"] == ["a"] and set(lp["shards"]) == {"0", "1"}
    assert port.shard_block() == jax_.shard_block()
    # the client rows of the last reports only: b (third) 300, a 200
    assert port.shard_block()["1"]["wire_bytes"] == {"tx": 500.0, "rx": 500.0}
    assert _without_ages(port.merged_dump()) == _without_ages(jax_.merged_dump())
    text = port.render_prometheus()
    assert 'fleet_worker_up{worker="a"} 0' in text and 'fleet_worker_up{worker="b"} 1' in text
    assert text.count("# TYPE x_total") == 1 and 'x_total{worker="d"}' not in text

    def strip(t):
        return [ln for ln in t.splitlines() if not ln.startswith("fleet_worker_last_seen")]
    assert strip(text) == strip(jax_.render_prometheus())
    local = [_trace_span(9, trace_id="s")]
    assert port.merged_trace(local_events=local) == jax_.merged_trace(local_events=local)
    assert port.worst_exemplar("lat_ms") == jax_.worst_exemplar("lat_ms") == "t2"
    assert port.worst_exemplar("lat_ms", worker="a") == "t1"


def test_merged_trace_pid_rows_stable_across_join_and_leave():
    """First-seen pid rows: a joiner sorting first gets a new row and the
    others keep theirs; a repeat export is unchanged; overlapping report
    windows render each span once."""
    fleet = FleetState()
    fleet.record_report("b", {"trace_events": [_trace_span(1), _trace_span(2)]})

    def rows(doc):
        return {e["args"]["name"]: e["pid"] for e in doc["traceEvents"] if e.get("ph") == "M"}
    first = rows(fleet.merged_trace(local_events=[]))
    fleet.record_report("a", {"trace_events": [_trace_span(3)]})
    fleet.record_report("b", {"trace_events": [_trace_span(2), _trace_span(4)]})
    doc = fleet.merged_trace(local_events=[])
    second = rows(doc)
    assert second["worker:b"] == first["worker:b"] and second["server"] == first["server"]
    assert second["worker:a"] not in first.values()
    assert rows(fleet.merged_trace(local_events=[])) == second
    assert sorted(e["name"] for e in doc["traceEvents"] if e.get("ph") == "X") == \
        ["s1", "s2", "s3", "s4"]


def test_health_folds_in_fleet_liveness():
    """The health snapshot carries the fleet's liveness once a worker has
    reported; a stale worker is listed but leaves the process healthy."""
    assert "fleet" not in get_health().snapshot()
    fleet = get_fleet()
    fleet.record_report("hw", {"registry": {}})
    fleet.record_report("gone", {"registry": {}})
    with fleet._lock:
        fleet._workers["gone"]["last_seen"] -= 60.0
    snap = get_health().snapshot()
    assert snap["fleet"]["workers"]["hw"]["stale"] is False
    assert snap["fleet"]["stale"] == ["gone"] and snap["healthy"]
    fleet.clear()
    assert "fleet" not in get_health().snapshot()
