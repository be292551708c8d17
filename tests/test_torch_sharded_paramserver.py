"""The port's sharded parameter-server fleet
(``deeplearning4j_torch/paramserver/sharded.py``) against the JAX package's.

Counterparts of ``tests/test_sharded_paramserver.py``'s 15 tests, all in
this process against loopback groups (every node a real TCP server on port
0): per-shard fan-out, the proto v3 delta wire, partial failure, elastic
rebalancing, and the master over the fleet. The wire is held both ways: a
port client drives a JAX group and a JAX client drives a port group through
one script, whose answers must be bit-equal to the JAX client against the
JAX group. Also held here, as the JAX parameter-server tests hold them: the
flight recorder's join/leave/rejoin with its JSONL dump and the fleet's
stale worker, pull bytes through the registry's
``paramserver_pull_bytes_total``, and ``shard_server_down``.
"""
import json
import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import paramserver as jps

from deeplearning4j_torch import (DataSet, ListDataSetIterator, MultiLayerNetwork,
                                  NeuralNetConfiguration, Sgd)
from deeplearning4j_torch.monitor import (FleetState, Tracer, get_fleet, get_flight_recorder,
                                          get_registry, get_tracer)
from deeplearning4j_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_torch.parallel import DistributedMultiLayerNetwork
from deeplearning4j_torch.parallel.accumulation import (EncodedGradientsAccumulator,
                                                        serialize_encoded)
from deeplearning4j_torch import paramserver as ps
from deeplearning4j_torch.paramserver import (ParameterServer, ParameterServerClient,
                                              ParameterServerTrainingMaster,
                                              ServerUnavailableError,
                                              ShardedParameterServerClient,
                                              ShardedParameterServerGroup, flatten_params,
                                              set_params_from_flat, shard_slice_length)
from deeplearning4j_torch.paramserver.server import DELTA_FRAMES, DELTA_FRESH, DELTA_FULL

PKG = {"jax": jps, "torch": ps}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _fresh_monitor():
    """The port's monitor planes are process-wide: each test starts empty."""
    for plane in (get_registry(), get_tracer(), get_flight_recorder(), get_fleet()):
        plane.clear()
    yield


def _toy_net(seed=11, n_in=6, hidden=16):
    conf = (NeuralNetConfiguration.builder().seed(seed)
            .updater(Sgd(learning_rate=5e-2)).activation("tanh").list()
            .layer(DenseLayer(n_in=n_in, n_out=hidden))
            .layer(OutputLayer(n_in=hidden, n_out=4, activation="softmax", loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf).init(device="cpu")


def _toy_batches(n=8, seed=3, n_in=6):
    rng = np.random.default_rng(seed)
    return [DataSet(rng.normal(size=(16, n_in)).astype(np.float32),
                    np.eye(4, dtype=np.float32)[rng.integers(0, 4, 16)])
            for _ in range(n)]


def _sharded_client(group, mod=ps, **kw):
    kw.setdefault("max_retries", 2)
    kw.setdefault("backoff", 0.01)
    return mod.ShardedParameterServerClient(group.addresses, **kw)


#: the per-training-step wire ops
_STEP_OPS = ("push", "pull", "pull_delta", "version")


def _wire_bytes_total(role="client", ops=_STEP_OPS):
    fam = get_registry().dump().get("paramserver_wire_bytes_total")
    if not fam:
        return 0.0
    return sum(row["value"] for row in fam["children"]
               if row["labels"].get("role") == role and row["labels"].get("op") in ops)


def _events(kind):
    return [e for e in get_flight_recorder().events() if e["event"] == kind]


# ------------------------------------------------------------------- group
def test_group_spawns_real_servers_with_round_robin_slices():
    vec = np.random.default_rng(0).normal(size=103).astype(np.float32)  # 103 % 3 != 0
    with ShardedParameterServerGroup(3) as group:
        assert len(set(group.addresses)) == 3
        with _sharded_client(group) as c:
            c.set_params(vec)
            for j, addr in enumerate(group.addresses):
                with ParameterServerClient(addr, max_retries=1, backoff=0.01) as raw:
                    _, part = raw.pull()
                    np.testing.assert_array_equal(part, vec[j::3])
                    assert part.size == shard_slice_length(j, 103, 3)
            versions, out = c.pull()
            np.testing.assert_array_equal(out, vec)
            assert len(set(versions)) == 1
        assert [e["servers"] for e in _events("shard_group_start")] == [3]


@pytest.mark.parametrize("n,num_shards", [(10, 3), (103, 4), (5, 8)])
def test_sharded_push_splits_indices_exactly(n, num_shards):
    """Element i goes to shard i % N at index i // N, also where N does not
    divide the length (and where shards outnumber elements)."""
    rng = np.random.default_rng(n)
    vec = np.arange(n, dtype=np.float32)
    k = max(1, n // 2)
    idx = np.sort(rng.choice(n, k, replace=False)).astype(np.int32)
    signs = rng.choice(np.array([-1, 1], np.int8), k)
    with ShardedParameterServerGroup(num_shards) as group:
        with _sharded_client(group) as c:
            c.set_params(vec)
            versions, failed = c.push_encoded((idx, signs, 0.5, n))
            assert failed is None
            want = vec.copy()
            want[idx] -= signs * np.float32(0.5)
            np.testing.assert_array_equal(c.pull()[1], want)
            owners = set((idx % num_shards).tolist())
            assert [v is not None for v in versions] == \
                [j in owners for j in range(num_shards)]


# -------------------------------------------------------------- delta wire
def test_pull_delta_modes_fresh_frames_full():
    vec = np.random.default_rng(1).normal(size=64).astype(np.float32)
    frame = serialize_encoded((np.array([2, 7], np.int32), np.array([1, -1], np.int8), 0.25, 64))
    with ParameterServer(port=0, journal=2) as srv:
        with ParameterServerClient(srv.address, max_retries=1, backoff=0.01) as c:
            assert c.negotiate() >= 3
            v0 = c.set_params(vec)
            assert c.pull_delta(v0) == (v0, DELTA_FRESH, None)
            c.push_update(frame)
            ver, mode, frames = c.pull_delta(v0)
            assert mode == DELTA_FRAMES and ver == v0 + 1 and frames == [frame]
            assert c.pull_delta(v0, slack=1)[1] == DELTA_FRESH
            c.push_update(frame)
            c.push_update(frame)
            ver, mode, body = c.pull_delta(v0)
            assert mode == DELTA_FULL
            np.testing.assert_array_equal(body, c.pull()[1])
            v_set = c.set_params(vec)
            c.push_update(frame)
            assert c.pull_delta(v_set - 1)[1] == DELTA_FULL
            assert c.pull_delta(v_set + 99)[1] == DELTA_FULL


def test_delta_replay_reconstructs_bit_exactly_across_workers():
    """Another worker's pushes arrive as journal frames and replay onto
    this worker's shadow bit for bit; the replay moves fewer bytes than a
    full vector."""
    rng = np.random.default_rng(2)
    vec = rng.normal(size=301).astype(np.float32)
    with ShardedParameterServerGroup(3) as group:
        a, b = _sharded_client(group), _sharded_client(group)
        try:
            versions = a.set_params(vec)
            for _ in range(4):
                idx = rng.choice(301, 17, replace=False).astype(np.int32)
                signs = np.ascontiguousarray(rng.choice(np.array([-1, 1], np.int8), 17))
                b.push_encoded((idx, signs, 1e-2, 301))
            rx0 = _wire_bytes_total(ops=("pull_delta",))
            new_versions, payload = a.pull_if_stale(versions)
            delta_bytes = _wire_bytes_total(ops=("pull_delta",)) - rx0
            assert isinstance(payload, np.ndarray)
            np.testing.assert_array_equal(payload, b.pull()[1])
            assert delta_bytes < 301 * 4
            assert a.pull_if_stale(new_versions) is None
        finally:
            a.close()
            b.close()


def test_sharded_delta_training_bit_equivalent_and_2x_fewer_wire_bytes():
    """The same fit against one dense server and against a 3-node delta
    fleet lands bit-equal parameters, the fleet moving at least 2x fewer
    step wire bytes (``paramserver_wire_bytes_total``)."""
    def run(address, delta):
        net = _toy_net(seed=21, n_in=12, hidden=96)
        master = (ParameterServerTrainingMaster.Builder(address).staleness(0)
                  .threshold(1e-2).backoff(0.01).delta_push(delta).build())
        before = _wire_bytes_total()
        DistributedMultiLayerNetwork(net, master).fit(
            ListDataSetIterator(_toy_batches(n=6, seed=17, n_in=12)), epochs=2)
        master.close()
        return net, _wire_bytes_total() - before

    with ParameterServer(port=0) as srv:
        net_dense, wire_dense = run(srv.address, delta=False)
    with ShardedParameterServerGroup(3) as group:
        net_delta, wire_delta = run(group.address, delta=True)
    np.testing.assert_array_equal(flatten_params(net_dense.params),
                                  flatten_params(net_delta.params))
    assert wire_dense >= 2.0 * wire_delta, (wire_dense, wire_delta)


def test_delta_push_residual_rule_matches_dense_server():
    """A threshold > 0 fleet releases sub-threshold mass exactly as a dense
    threshold > 0 server fed the same frames: empty sub-frames still reach
    every residual-merging node."""
    n = 12
    rng = np.random.default_rng(5)
    pushes = []
    for _ in range(6):
        k = int(rng.integers(1, 5))
        idx = np.sort(rng.choice(n, k, replace=False)).astype(np.int32)
        pushes.append((idx, np.ascontiguousarray(rng.choice(np.array([-1, 1], np.int8), k)),
                       float(rng.uniform(0.1, 0.4))))
    with ParameterServer(port=0, threshold=0.5) as srv:
        with ParameterServerClient(srv.address, max_retries=1, backoff=0.01) as c:
            c.set_params(np.zeros(n, np.float32))
            for idx, signs, thr in pushes:
                c.push_update(serialize_encoded((idx, signs, thr, n)))
            dense = c.pull()[1]
    with ShardedParameterServerGroup(3, threshold=0.5) as group:
        with _sharded_client(group) as sc:
            sc.set_params(np.zeros(n, np.float32))
            for idx, signs, thr in pushes:
                versions, failed = sc.push_encoded((idx, signs, thr, n))
                assert failed is None and all(v is not None for v in versions)
            sharded = sc.pull()[1]
    np.testing.assert_array_equal(sharded, dense)


def test_v3_client_negotiates_down_against_v2_server():
    """Against a proto 2 server no OP_PULL_DELTA reaches the wire: pulls
    fall back to a version check and the full vector."""
    from deeplearning4j_torch.paramserver.server import OP_PULL_DELTA, OP_STATS

    class _V2Server(ParameterServer):
        def _handle(self, op, payload):
            if op == OP_PULL_DELTA:
                raise ValueError(f"unknown op {op}")
            out = super()._handle(op, payload)
            if op == OP_STATS:
                stats = json.loads(out.decode("utf-8"))
                stats["proto"] = 2
                out = json.dumps(stats).encode("utf-8")
            return out

    vec = np.arange(9, dtype=np.float32)
    with _V2Server(port=0) as srv:
        with ShardedParameterServerClient([srv.address], delta=True, max_retries=1,
                                          backoff=0.01) as c:
            assert c.negotiate() == 2
            versions = c.set_params(vec)
            c.push_encoded((np.array([1], np.int32), np.array([1], np.int8), 0.5, 9))
            _, payload = c.pull_if_stale(versions)
            want = vec.copy()
            want[1] -= 0.5
            np.testing.assert_array_equal(np.asarray(payload), want)
            with srv._op_lock:
                assert srv._op_counts["pull_delta"] == 0
            assert c.metrics.counters["errors"] == 0


# --------------------------------------------------- partial failure model
def test_dead_shard_fails_per_shard_and_mass_reinjects():
    """One dead node: only its shard's push fails, its decoded mass comes
    back for re-injection, pulls serve its shadow, ``shard_server_down``
    is recorded once, and ops inside the down window fail fast."""
    n = 9
    vec = np.zeros(n, np.float32)
    group = ShardedParameterServerGroup(3)
    try:
        with _sharded_client(group, max_retries=0, down_backoff=0.2) as c:
            c.set_params(vec)
            group.kill(1)
            versions, failed = c.push_encoded((np.array([0, 1, 2], np.int32),
                                               np.array([1, 1, 1], np.int8), 0.5, n))
            assert versions[0] is not None and versions[2] is not None
            assert versions[1] is None
            want_failed = np.zeros(n, np.float32)
            want_failed[1] = 0.5
            np.testing.assert_array_equal(failed, want_failed)
            acc = EncodedGradientsAccumulator(initial_threshold=0.5)
            acc.reinject(failed)
            assert acc.store_update({"w": np.zeros(n, np.float32)})["w"][1] == 0.5
            _, out = c.pull()
            want = vec.copy()
            want[0] -= 0.5
            want[2] -= 0.5
            np.testing.assert_array_equal(out, want)
            downs = _events("shard_server_down")
            assert len(downs) == 1 and downs[0]["shard"] == 1
            assert downs[0]["server"] == group.addresses[1]
            assert [e["shard"] for e in _events("shard_server_leave")] == [1]
            assert get_registry().counter("paramserver_shard_unavailable_total",
                                          role="client", shard="1").value >= 2
            assert group.last_snapshot(1)[1].size == shard_slice_length(1, n, 3)
    finally:
        group.stop()


def test_kill_one_shard_server_mid_fit_training_degrades_then_recovers():
    """Kill one of three nodes mid-fit: training neither hangs nor raises;
    after a restart from its snapshot the fleet heals
    (``shard_server_restored``) and the loss falls."""
    group = ShardedParameterServerGroup(3)
    try:
        net = _toy_net(seed=5)
        batches = _toy_batches(n=8, seed=2)
        master = ParameterServerTrainingMaster(group.address, staleness=0, backoff=0.01,
                                               max_retries=1)
        master._ensure_client().down_backoff = 0.2
        killed = {}

        class KillShard:
            def iteration_done(self, model, iteration, score):
                if iteration == 2 and not killed:
                    killed["port"], killed["snap"] = group.kill(1)

        net.set_listeners(KillShard())
        s0 = net.score(DataSet.merge(batches))
        master.execute_training(net, ListDataSetIterator(batches))
        assert killed and _events("shard_server_down")
        assert np.all(np.isfinite(flatten_params(net.params)))
        group.restart(1, snapshot=killed["snap"])
        assert group.addresses[1].endswith(f":{killed['port']}")
        net.listeners = []
        master.execute_training(net, ListDataSetIterator(batches))
        assert _events("shard_server_restored")
        assert net.score(DataSet.merge(batches)) < s0
        master.close()
    finally:
        group.stop()


def test_worker_surge_2x_mid_training_neither_halts_nor_corrupts():
    """Three workers train against the fleet, then three more join
    mid-training: every worker completes and joins on the record, and the
    merged state is finite and learned."""
    group = ShardedParameterServerGroup(3)
    errors, masters = [], []
    started = threading.Event()

    def worker(wid, seed):
        try:
            master = ParameterServerTrainingMaster(group.address, staleness=1, backoff=0.01,
                                                   worker_id=f"surge-{wid}",
                                                   telemetry_interval=None)
            masters.append(master)
            net = _toy_net(seed=seed)
            started.set()
            master.execute_training(net, ListDataSetIterator(_toy_batches(n=16, seed=seed)))
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append((wid, e))

    try:
        first = [threading.Thread(target=worker, args=(i, 30 + i)) for i in range(3)]
        for t in first:
            t.start()
        assert started.wait(timeout=30)
        surge = [threading.Thread(target=worker, args=(i, 40 + i)) for i in range(3, 6)]
        for t in surge:
            t.start()
        for t in first + surge:
            t.join(timeout=120)
            assert not t.is_alive(), "worker hung"
        assert errors == []
        assert {f"surge-{i}" for i in range(6)} <= {e["worker"] for e in _events("worker_join")}
        with _sharded_client(group) as c:
            merged = c.pull()[1]
        assert np.all(np.isfinite(merged))
        probe = _toy_net(seed=50)
        held = DataSet.merge(_toy_batches(n=6, seed=30))
        s_random = probe.score(held)
        set_params_from_flat(probe, merged)
        assert probe.score(held) < s_random
    finally:
        for m in masters:
            m.close()
        group.stop()


# ----------------------------------------------------------------- elastic
def test_scale_to_rebalances_state_and_clients_remap():
    """scale_to re-splits values and residuals; remapped clients resync; the
    record holds join, rebalance and remap; a master remaps through a grow
    and a shrink and refits."""
    rng = np.random.default_rng(9)
    vec = rng.normal(size=97).astype(np.float32)
    one = (np.array([0], np.int32), np.array([1], np.int8), 0.2, 97)
    group = ShardedParameterServerGroup(2, threshold=0.5)
    try:
        with _sharded_client(group) as c:
            c.set_params(vec)
            c.push_encoded(one)                  # sub-threshold residual left behind
            addrs = group.scale_to(3)
            assert len(addrs) == 3
            c.remap(addrs)
            np.testing.assert_array_equal(c.pull()[1], vec)
            c.push_encoded(one)
            c.push_encoded(one)
            want = vec.copy()
            want[0] -= 0.5
            np.testing.assert_array_equal(c.pull()[1], want)
            kinds = [e["event"] for e in get_flight_recorder().events()]
            assert {"shard_server_join", "shard_group_rebalance", "client_remap"} <= set(kinds)
    finally:
        group.stop()
    with ShardedParameterServerGroup(2) as group2:
        net = _toy_net(seed=3)
        master = ParameterServerTrainingMaster(group2.address, backoff=0.01)
        master.execute_training(net, ListDataSetIterator(_toy_batches(n=2)))
        master.remap(group2.scale_to(3))
        master.execute_training(net, ListDataSetIterator(_toy_batches(n=2)))
        assert master.client.num_servers == 3 and len(master.local_version) == 3
        master.remap(group2.scale_to(2))
        master.execute_training(net, ListDataSetIterator(_toy_batches(n=2)))
        assert master.client.num_servers == 2
        assert _events("shard_server_leave")
        assert np.all(np.isfinite(flatten_params(net.params)))
        master.close()


# ------------------------------------------------- shared fan-out, builder
def test_single_server_parallel_shard_pulls_share_fanout_path():
    vec = np.random.default_rng(4).normal(size=205).astype(np.float32)
    with ParameterServer(port=0, num_shards=4) as srv:
        with ParameterServerClient(srv.address, pool_size=4, max_retries=1,
                                   backoff=0.01) as c:
            c.set_params(vec)
            version, out = c.pull_sharded()
            np.testing.assert_array_equal(out, vec)
            assert version == c.server_version()[0]
            with c._pool_lock:
                assert len(c._pool) >= 2


def test_sharded_client_single_address_is_the_legacy_path_plus_delta():
    net = _toy_net(seed=8)
    batches = _toy_batches(n=4, seed=6)
    with ParameterServer(port=0) as srv:
        master = (ParameterServerTrainingMaster.Builder(srv.address).staleness(0)
                  .backoff(0.01).delta_push(True).build())
        DistributedMultiLayerNetwork(net, master).fit(ListDataSetIterator(batches))
        assert isinstance(master.client, ShardedParameterServerClient)
        assert master.client.num_servers == 1
        with srv._op_lock:
            assert srv._op_counts["pull_delta"] >= len(batches)
            assert srv._op_counts["pull"] <= 1
        master.close()


def test_builder_num_servers_cross_checks_addresses():
    with pytest.raises(ValueError, match="num_servers"):
        (ParameterServerTrainingMaster.Builder("127.0.0.1:1,127.0.0.1:2")
         .numServers(3).build())._ensure_client()
    m = (ParameterServerTrainingMaster.Builder(["127.0.0.1:1", "127.0.0.1:2"])
         .num_servers(2).deltaPush(False).build())
    c = m._ensure_client()
    assert isinstance(c, ShardedParameterServerClient) and not c.delta
    assert c.addresses == ["127.0.0.1:1", "127.0.0.1:2"]
    m.close()


def test_init_requires_whole_fleet():
    group = ShardedParameterServerGroup(3)
    try:
        group.kill(2)
        with _sharded_client(group, max_retries=0) as c:
            with pytest.raises(ServerUnavailableError, match="shard 2"):
                c.init_params(np.zeros(6, np.float32))
    finally:
        group.stop()


# -------------------------------------------------- the wire, both ways
def _fleet_script(group_mod, client_mod):
    """Every sharded op against a 3-node group, answers recorded."""
    out = []
    rng = np.random.default_rng(12)
    vec = rng.normal(size=50).astype(np.float32)
    with group_mod.ShardedParameterServerGroup(3, threshold=0.25) as group:
        a, b = _sharded_client(group, client_mod), _sharded_client(group, client_mod)
        try:
            out.append(a.negotiate())
            out.append(a.init_params(vec))
            out.append(b.init_params(np.ones(50, np.float32)))
            v, got = b.pull()
            out.append((v, got.tobytes()))
            base = a.set_params(vec * 2)
            for k in range(3):
                idx = np.sort(rng.choice(50, 9, replace=False)).astype(np.int32)
                signs = np.ascontiguousarray(rng.choice(np.array([-1, 1], np.int8), 9))
                versions, failed = b.push_encoded((idx, signs, 0.3, 50))
                out.append((versions, failed))
            exact = (np.array([1, 4, 49], np.int32), np.array([0.5, -2.0, 1e-7], np.float32),
                     0.0, 50)
            out.append(b.push_encoded(exact)[0])
            v2, payload = a.pull_if_stale(base)
            out.append((v2, payload.tobytes()))
            out.append(a.pull_if_stale(v2))
            out.append(b.server_version())
            out.append([{k: st[k] for k in ("version", "n", "threshold", "shard", "proto")}
                        for st in a.stats()])
            out.append(a.send_telemetry())
        finally:
            a.close()
            b.close()
    return out


@pytest.mark.parametrize("group_pkg,client_pkg", [("jax", "torch"), ("torch", "jax")])
def test_sharded_wire_is_bit_exact_between_the_packages(group_pkg, client_pkg):
    """A port client against a JAX group and a JAX client against a port
    group answer every op as the JAX client against the JAX group, bit for
    bit (delta replay included)."""
    want = _fleet_script(jps, jps)
    got = _fleet_script(PKG[group_pkg], PKG[client_pkg])
    assert got == want
    assert want[1] == ([1, 1, 1], True) and want[2] == ([1, 1, 1], False)


# --------------------- the JAX parameter-server tests' monitor assertions
def test_worker_die_rejoin_flight_recorder_and_fleet_stale(tmp_path):
    """A worker dies mid-epoch: the recorder holds join → leave → rejoin →
    leave in order, through a JSONL dump; the fleet marks the dead worker
    stale and the live one fresh (the dead one's last report is aged by
    hand, so no test waits on the clock); a rejoin makes it fresh."""
    fleet = FleetState(stale_after=5.0)
    batches = _toy_batches(n=3, seed=2)
    with ParameterServer(port=0, fleet=fleet, tracer=Tracer()) as srv:
        def master(worker):
            return ParameterServerTrainingMaster(srv.address, staleness=0, backoff=0.01,
                                                 worker_id=worker, telemetry_interval=0.0)
        alive, dying = master("alive"), master("dying")
        alive.execute_training(_toy_net(seed=5), ListDataSetIterator(batches[:1]))

        def feed():
            yield batches[0]
            raise RuntimeError("worker killed")
        net = _toy_net(seed=3)
        with pytest.raises(RuntimeError, match="worker killed"):
            dying.execute_training(net, feed())
        with fleet._lock:
            fleet._workers["dying"]["last_seen"] -= 60.0
        alive.client.send_telemetry()
        live = fleet.liveness()
        assert live["stale"] == ["dying"] and live["workers"]["alive"]["stale"] is False
        assert 'fleet_worker_up{worker="dying"} 0' in fleet.render_prometheus()
        dying.execute_training(net, ListDataSetIterator(batches[:1]))
        assert fleet.liveness()["workers"]["dying"]["stale"] is False
        alive.close()
        dying.close()
    rec = get_flight_recorder()
    kinds = [e["event"] for e in rec.events()
             if e.get("worker") == "dying" and e["event"].startswith("worker_")]
    assert kinds == ["worker_join", "worker_leave", "worker_rejoin", "worker_leave"]
    leaves = [e for e in rec.events() if e.get("worker") == "dying"
              and e["event"] == "worker_leave"]
    assert "worker killed" in leaves[0]["reason"] and leaves[1]["reason"] == "completed"
    path = rec.dump(path=str(tmp_path / "flight.jsonl"))
    rows = [json.loads(line) for line in open(path).read().splitlines()]
    assert [r["event"] for r in rows if r.get("worker") == "dying"
            and r["event"].startswith("worker_")] == kinds
    seqs = [r["seq"] for r in rows]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)


def test_count_own_pushes_dial_saves_pull_bandwidth():
    """By default a lone staleness-0 worker re-pulls the full vector after
    every push; ``count_own_pushes=False`` adopts its own pushes' versions
    and only the second epoch's rejoin pull remains. Measured as the JAX
    test measures it: pull bytes through the registry's
    ``paramserver_pull_bytes_total{role="client"}``."""
    pull_bytes = get_registry().counter("paramserver_pull_bytes_total",
                                        "parameter-server op counter", role="client")

    def run(**master_kw):
        net = _toy_net(seed=4)
        with ParameterServer(port=0) as srv:
            master = ParameterServerTrainingMaster(srv.address, staleness=0, backoff=0.01,
                                                   **master_kw)
            before = pull_bytes.value
            DistributedMultiLayerNetwork(net, master).fit(
                ListDataSetIterator(_toy_batches(n=6, seed=9)), epochs=2)
            snap = master.client.metrics.snapshot()["counters"]
            master.close()
            return net, snap, pull_bytes.value - before

    net_dflt, snap_dflt, wire_dflt = run()
    net_dial, snap_dial, wire_dial = run(count_own_pushes=False)
    n_params = flatten_params(net_dflt.params).size
    assert (snap_dflt["pushes"], snap_dflt["pulls"]) == (12, 13)
    assert wire_dflt == 13 * 4 * n_params
    assert (snap_dial["pushes"], snap_dial["pulls"], snap_dial["staleness_hits"]) == (12, 1, 12)
    assert wire_dial == 4 * n_params and wire_dial < wire_dflt / 10
    assert net_dial.iteration_count == 12 and np.isfinite(float(net_dial.score_))
