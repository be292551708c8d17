"""The port's training UI (``deeplearning4j_torch/ui/``) against the JAX
package's (``tests/test_ui.py`` is the oracle).

- JAX's seven UI cases on the port, on the CPU: the listener's reports,
  the JSON-lines and sqlite storages, the server's routes and remote
  POST, system stats, the t-SNE tab, the convolutional activations.
- ``_array_stats`` of the same arrays in both packages (f32, f64, a
  constant array, values on the bin edges, an empty array): bin counts
  exact, moments at rtol 1e-9 (both reduce in float64; only the order of
  the sums differs); a NaN raises numpy's ValueError in both.
- A listener's reports on the same weights carried across
  (``params_from_numpy``), parameters and updates, against JAX's.
- A report copies two small vectors to the host (min/max, then the
  rest), never a parameter, also when an array is binned in runs.
- Stats files written by either package and read by the other.
- The monitor routes on ``UIServer``: ``/control``, ``/incidents`` and
  ``/incidents/<id>`` (404 body), ``/events``, and JAX's two-worker
  ``/fleet`` + ``/fleet/trace`` check (``tests/test_fleet.py``).
"""
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import MultiLayerNetwork as JNet
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.ui import stats as jstats

from deeplearning4j_torch import DataSet, MultiLayerNetwork, NeuralNetConfiguration, Sgd
from deeplearning4j_torch.monitor import (get_alert_engine, get_fleet, get_flight_recorder,
                                          get_tracer)
from deeplearning4j_torch.monitor import incidents as pincidents
from deeplearning4j_torch.nn.conf import serde
from deeplearning4j_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_torch.ui import (FileStatsStorage, InMemoryStatsStorage,
                                     RemoteUIStatsStorageRouter, SqliteStatsStorage,
                                     StatsListener, StatsReport, UIServer)
from deeplearning4j_torch.ui import stats as pstats
from deeplearning4j_torch.utils.model_serializer import params_from_numpy

MOMENT_RTOL = 1e-9
MOMENTS = ("mean", "stdev", "min", "max", "norm2", "mean_magnitude")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _net(seed=1):
    conf = (NeuralNetConfiguration.builder().seed(seed)
            .updater(Sgd(learning_rate=0.1)).activation("tanh").list()
            .layer(DenseLayer(n_in=4, n_out=8))
            .layer(OutputLayer(n_in=8, n_out=3, activation="softmax", loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf).init(device="cpu")


def _train_with(storage, iters=5, **kw):
    net = _net()
    net.set_listeners(StatsListener(storage, session_id="s1", **kw))
    rng = np.random.default_rng(0)
    ds = DataSet(rng.normal(size=(16, 4)).astype(np.float32),
                 np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)])
    for _ in range(iters):
        net.fit(ds)
    return net


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            raw = r.read().decode("utf-8")
            if r.headers.get_content_type() == "application/json":
                return r.status, json.loads(raw)
            return r.status, raw
    except urllib.error.HTTPError as e:
        body = json.loads(e.read().decode("utf-8"))
        e.close()
        return e.code, body


def _serving(storage=None):
    srv = UIServer(port=0)
    srv.attach(storage if storage is not None else InMemoryStatsStorage())
    return srv, srv.start()


def _assert_stats_equal(got, want):
    """Counts and edges exact, moments at MOMENT_RTOL, the same keys."""
    assert list(got) == list(want)
    if not want:
        return
    assert got["histogram"] == want["histogram"]
    assert got["histogram_edges"] == want["histogram_edges"]
    for k in MOMENTS:
        np.testing.assert_allclose(got[k], want[k], rtol=MOMENT_RTOL, atol=0, err_msg=k)


# ------------------------------------------------------- JAX's UI cases
def test_stats_listener_collects_reports():
    storage = InMemoryStatsStorage()
    _train_with(storage, iters=4)
    assert storage.list_session_ids() == ["s1"]
    ups = storage.get_all_updates("s1")
    assert len(ups) == 4
    r = ups[-1]
    assert np.isfinite(r.score)
    assert "0_W" in r.param_stats and "norm2" in r.param_stats["0_W"]
    assert "histogram" in r.param_stats["0_W"]
    assert ups[0].update_stats == {} and "0_W" in ups[1].update_stats


@pytest.mark.parametrize("kind", ["jsonl", "sqlite"])
def test_storage_roundtrip(tmp_path, kind):
    cls = FileStatsStorage if kind == "jsonl" else SqliteStatsStorage
    path = str(tmp_path / f"stats.{kind}")
    storage = cls(path)
    _train_with(storage, iters=3)
    storage.close()
    reloaded = cls(path)
    ups = reloaded.get_all_updates("s1")
    assert len(ups) == 3 and ups[0].iteration < ups[-1].iteration
    assert reloaded.list_session_ids() == ["s1"]
    reloaded.close()


def test_ui_server_endpoints_and_remote_post():
    storage = InMemoryStatsStorage()
    server, port = _serving(storage)
    try:
        _train_with(storage, iters=3)
        assert _get(port, "/train/sessions") == (200, ["s1"])
        assert len(_get(port, "/train/overview?sid=s1")[1]["scores"]) == 3
        assert "0_W" in _get(port, "/train/model?sid=s1")[1]["params"]
        assert "Training overview" in _get(port, "/")[1]
        RemoteUIStatsStorageRouter(f"http://127.0.0.1:{port}").put_update(
            StatsReport("remote_session", "w0", 0, 0.0, 1.23, {}, {}, 0.0))
        assert "remote_session" in storage.list_session_ids()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/remote", data=b"[1, 2]")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 400
        e.value.close()
        assert _get(port, "/train/nope") == (404, {"error": "not found"})
    finally:
        server.stop()


def test_system_stats_collected_and_served():
    """The system tab: host RSS, its peak and GC counts a report; a CPU
    model reports no device keys, as the JAX package's CPU backend."""
    storage = InMemoryStatsStorage()
    _train_with(storage, iters=3)
    ups = storage.get_all_updates("s1")
    s = ups[-1].system
    assert s["host_rss_bytes"] > 0 and s["host_peak_rss_bytes"] >= s["host_rss_bytes"] // 2
    assert isinstance(s["gc_collections"], list) and s["gc_collections"]
    assert not any(k.startswith("device_") for k in s)
    assert list(s) == [k for k in jstats._system_stats() if not k.startswith("device_")]
    server, port = _serving(storage)
    try:
        status, data = _get(port, "/train/system?sid=s1")
        assert data["iterations"] == [u.iteration for u in ups]
        assert all(v > 0 for v in data["host_rss_bytes"])
        assert data["device_bytes_in_use"] == [None] * 3
    finally:
        server.stop()


def test_tsne_tab_upload_and_fetch():
    from deeplearning4j_torch.clustering.tsne import Tsne
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(0, 0.2, size=(10, 6)),
                        rng.normal(4, 0.2, size=(10, 6))]).astype(np.float32)
    coords = Tsne(n_components=2, n_iter=30, perplexity=5.0, seed=3,
                  device="cpu").fit_transform(x)
    server, port = _serving()
    try:
        server.upload_tsne(coords, labels=[0] * 10 + [1] * 10)
        data = _get(port, "/tsne/coords")[1]
        assert len(data["coords"]) == 20 and len(data["labels"]) == 20
        server.upload_tsne(torch.arange(4.0).reshape(2, 2))
        assert _get(port, "/tsne/coords")[1] == {"coords": [[0.0, 1.0], [2.0, 3.0]],
                                                 "labels": []}
        body = json.dumps({"coords": [[0, 0], [1, 1]], "labels": ["a", "b"]}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/tsne/upload", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert json.loads(r.read())["status"] == "ok"
        assert _get(port, "/tsne/coords")[1]["labels"] == ["a", "b"]
    finally:
        server.stop()


def test_conv_activations_endpoint():
    from deeplearning4j_torch import InputType
    from deeplearning4j_torch.nn.conf.layers import ConvolutionLayer, SubsamplingLayer
    conf = (NeuralNetConfiguration.builder().seed(2)
            .updater(Sgd(learning_rate=0.05)).activation("relu").list()
            .layer(ConvolutionLayer(n_out=3, kernel_size=(3, 3)))
            .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(DenseLayer(n_out=8))
            .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.convolutional(8, 8, 1)).build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    rng = np.random.default_rng(1)
    probe = rng.normal(size=(2, 1, 8, 8)).astype(np.float32)
    storage = InMemoryStatsStorage()
    net.set_listeners(StatsListener(storage, session_id="sconv", activation_probe=probe,
                                    activation_frequency=1, activation_max_channels=2))
    net.fit(DataSet(rng.normal(size=(8, 1, 8, 8)).astype(np.float32),
                    np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)]))
    act = storage.get_all_updates("sconv")[-1].activations
    assert act["layer"] == "0"
    want = net.feed_forward(probe)[1][0].permute(2, 0, 1)[:2].tolist()
    assert act["grids"] == want and len(want[0]) == 6      # 8 - 3 + 1
    server, port = _serving(storage)
    try:
        data = _get(port, "/train/activations?sid=sconv")[1]
        assert data["grids"] == want and data["iteration"] == 0
    finally:
        server.stop()


# ------------------------------------------------------ against JAX
def _edge_values():
    """Values on the bin edges of [0, 1]: every edge, twice."""
    return np.repeat(np.linspace(0.0, 1.0, 21), 2)


@pytest.mark.parametrize("case", ["f32", "f64", "constant", "on_edges", "empty", "nan"])
def test_array_stats_matches_jax(case):
    rng = np.random.default_rng(7)
    arr = {"f32": lambda: rng.normal(size=(33, 17)).astype(np.float32),
           "f64": lambda: rng.standard_cauchy(size=500),
           "constant": lambda: np.zeros((3, 5), np.float32),
           "on_edges": _edge_values,
           "empty": lambda: np.zeros((0, 4), np.float32),
           "nan": lambda: np.array([0.5, np.nan, -1.0], np.float32)}[case]()
    if case == "nan":       # numpy's histogram refuses a range that is not finite
        for fn in (jstats._array_stats, lambda a: pstats._array_stats(torch.from_numpy(a))):
            with pytest.raises(ValueError, match="finite"):
                fn(arr)
        return
    want = jstats._array_stats(arr)
    _assert_stats_equal(pstats._array_stats(torch.from_numpy(arr)), want)
    if case == "constant":
        assert want["histogram_edges"] == [-0.5, 0.5] and want["histogram"][10] == 15


def _carried_pair():
    jconf = (JConf.builder().seed(5).list()
             .layer(jl.DenseLayer(n_in=6, n_out=9, activation="relu"))
             .layer(jl.OutputLayer(n_in=9, n_out=3, activation="softmax")).build())
    jnet = JNet(jconf).init()
    conf = serde.decode(json.loads(jconf.to_json()))
    arrays = {f"{i}/{k}": np.asarray(v) for i, p in jnet.params.items() for k, v in p.items()}
    net = MultiLayerNetwork(conf).init(params=params_from_numpy(conf, arrays), device="cpu")
    return jnet, net


def test_listener_reports_match_jax_on_carried_weights():
    """The first report's parameter stats and, after the same f32 delta
    lands on both nets' weights, the second report's update stats."""
    import jax.numpy as jnp
    jnet, net = _carried_pair()
    jstore, pstore = jstats.InMemoryStatsStorage(), InMemoryStatsStorage()
    jl_, pl_ = (jstats.StatsListener(jstore, session_id="c", collect_system=False),
                StatsListener(pstore, session_id="c", collect_system=False))
    jl_.iteration_done(jnet, 0, 1.5)
    pl_.iteration_done(net, 0, 1.5)
    rng = np.random.default_rng(3)
    for i, p in jnet.params.items():
        for k, v in p.items():
            new = np.asarray(v) + rng.normal(scale=1e-2, size=v.shape).astype(np.float32)
            p[k] = jnp.asarray(new)
            net.params[i][k].copy_(torch.from_numpy(new))
    jl_.iteration_done(jnet, 1, 1.25)
    pl_.iteration_done(net, 1, 1.25)
    (j0, j1), (p0, p1) = jstore.get_all_updates("c"), pstore.get_all_updates("c")
    assert list(p0.param_stats) == list(j0.param_stats) == ["0_W", "0_b", "1_W", "1_b"]
    for pr, jr in ((p0, j0), (p1, j1)):
        assert (pr.iteration, pr.score, pr.system) == (jr.iteration, jr.score, jr.system)
        for name in jr.param_stats:
            _assert_stats_equal(pr.param_stats[name], jr.param_stats[name])
    assert p0.update_stats == j0.update_stats == {}
    assert list(p1.update_stats) == list(j1.update_stats)
    for name in j1.update_stats:
        _assert_stats_equal(p1.update_stats[name], j1.update_stats[name])


def test_norm_only_reports_match_jax():
    jnet, net = _carried_pair()
    jstore, pstore = jstats.InMemoryStatsStorage(), InMemoryStatsStorage()
    jstats.StatsListener(jstore, collect_histograms=False, collect_system=False,
                         session_id="n").iteration_done(jnet, 0, 0.5)
    StatsListener(pstore, collect_histograms=False, collect_system=False,
                  session_id="n").iteration_done(net, 0, 0.5)
    want = jstore.get_all_updates("n")[0].param_stats
    got = pstore.get_all_updates("n")[0].param_stats
    assert list(got) == list(want) and all(list(v) == ["norm2"] for v in got.values())
    for name in want:   # JAX takes this norm in the parameter's f32
        np.testing.assert_allclose(got[name]["norm2"], want[name]["norm2"], rtol=1e-6)


def test_a_report_copies_two_small_vectors_to_the_host(monkeypatch):
    """Every ``Tensor.cpu`` a report makes: the mins and maxes, then the
    moments and the counts at the inner edges; a parameter never (the
    net's largest has 32 elements here; 8 arrays with the updates).
    Comparing an array with its edges in runs of ``RUN_ELEMS`` elements
    gives the same statistics and the same two copies."""
    net = _net()
    lst = StatsListener(InMemoryStatsStorage(), session_id="h")
    lst.iteration_done(net, 0, 1.0)                 # no updates yet
    copies = []
    real = torch.Tensor.cpu

    def counted(self, *a, **k):
        copies.append(tuple(self.shape))
        return real(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    lst.iteration_done(net, 1, 1.0)                 # parameters and updates
    assert copies == [(16,), (8, 23)]
    arrays = list(net.param_table().values())
    whole = pstats._stats_batch(arrays)
    monkeypatch.setattr(pstats, "RUN_ELEMS", 5)
    copies.clear()
    for got, want in zip(pstats._stats_batch(arrays), whole):
        _assert_stats_equal(got, want)
    assert copies == [(8,), (4, 23)]


@pytest.mark.parametrize("kind", ["jsonl", "sqlite"])
def test_stats_files_cross_between_packages(tmp_path, kind):
    """A file written by either package loads in the other with the same
    reports (JSON keys and values)."""
    jnet, net = _carried_pair()
    for writer in ("port", "jax"):
        path = str(tmp_path / f"{writer}.{kind}")
        pkg = pstats if writer == "port" else jstats
        store = (pkg.FileStatsStorage if kind == "jsonl" else pkg.SqliteStatsStorage)(path)
        lst = pkg.StatsListener(store, session_id=writer)
        for it in range(2):
            lst.iteration_done(net if writer == "port" else jnet, it, 0.75)
        store.close()
        readers = [(pstats if r == "port" else jstats) for r in ("port", "jax")]
        docs = []
        for mod in readers:
            rd = (mod.FileStatsStorage if kind == "jsonl" else mod.SqliteStatsStorage)(path)
            assert rd.list_session_ids() == [writer]
            docs.append([json.loads(u.to_json()) for u in rd.get_all_updates(writer)])
            rd.close()
        assert docs[0] == docs[1] and len(docs[0]) == 2
        assert set(docs[0][1]) == set(vars(jstats.StatsReport("s", "w", 0, 0.0, 0.0, {}, {},
                                                              0.0)))
        assert docs[0][1]["update_stats"]["0_W"]["histogram"]


# ------------------------------------------------------ monitor routes
def test_monitor_routes_on_the_ui_server(tmp_path, monkeypatch):
    """``/control``, ``/incidents``, ``/incidents/<id>`` (and its 404),
    ``/events`` from a ``UIServer``: JAX's ``TestHttpSurface`` and
    ``TestSurfaces`` UI halves."""
    from deeplearning4j_tpu.control import plane as jplane
    from deeplearning4j_torch.control import ControlPolicy, get_control_plane
    from deeplearning4j_torch.monitor import IncidentRecorder
    plane = get_control_plane()
    plane.clear()
    plane.add(ControlPolicy("ui_probe", lambda ctx: "ok", rules=("ui_rule",), cooldown_s=1.0))
    rec = IncidentRecorder(engine=get_alert_engine(), dump_dir=str(tmp_path))
    monkeypatch.setattr(pincidents, "_RECORDER", rec)
    rec._on_edge("alert_firing", {"rule": "ui_inc", "severity": "page", "value": 2.0,
                                  "detail": "hot", "exemplar_trace_id": None})
    rec.tick(now=10.0)
    rec._on_edge("alert_resolved", {"rule": "ui_inc", "detail": "ok"})
    rec.tick(now=11.0)
    get_flight_recorder().record("ui_probe_event", detail=7)
    server, port = _serving()
    try:
        status, doc = _get(port, "/control")
        assert status == 200 and set(doc) == set(jplane.ControlPlane().snapshot())
        assert [r["policy"] for r in doc["policies"]] == ["ui_probe"]
        status, doc = _get(port, "/incidents")
        assert status == 200 and [r["id"] for r in doc["incidents"]] == ["inc-0001"]
        status, bundle = _get(port, "/incidents/inc-0001")
        assert status == 200 and bundle["status"] == "resolved" and "ui_inc" in bundle["rules"]
        assert _get(port, "/incidents/inc-nope") == (404, {"error":
                                                           "unknown incident 'inc-nope'"})
        events = _get(port, "/events")[1]["events"]
        assert [e["detail"] for e in events if e["event"] == "ui_probe_event"] == [7]
    finally:
        server.stop()
        plane.clear()


def test_two_worker_fleet_http_on_the_ui_server():
    """JAX's ``test_two_worker_merged_trace_and_fleet_http`` on a port
    server and port workers: ``/fleet`` carries both workers' series under
    their labels, and ``/fleet/trace`` ties each client push to the
    server's apply on distinct pid rows."""
    from deeplearning4j_torch import ListDataSetIterator
    from deeplearning4j_torch.monitor import Tracer
    from deeplearning4j_torch.paramserver import (ParameterServer, ParameterServerClient,
                                                  ParameterServerTrainingMaster)
    fleet = get_fleet()
    fleet.clear()
    get_tracer().clear()
    rng = np.random.default_rng(0)
    batches = [DataSet(rng.normal(size=(8, 4)).astype(np.float32),
                       np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]) for _ in range(2)]
    try:
        with ParameterServer(port=0) as srv:
            for i, w in enumerate(("w1", "w2")):
                tracer = Tracer()
                master = ParameterServerTrainingMaster(
                    srv.address, staleness=0, backoff=0.01, worker_id=w,
                    telemetry_interval=0.0)
                master.client = ParameterServerClient(srv.address, worker_id=w, tracer=tracer,
                                                      backoff=0.01)
                master.execute_training(_net(seed=i + 1), ListDataSetIterator(batches))
            server, port = _serving()
            try:
                text = _get(port, "/fleet")[1]
                merged = _get(port, "/fleet/trace")[1]
            finally:
                server.stop()
    finally:
        fleet.clear()
    for w in ("w1", "w2"):
        assert f'paramserver_pushes_total{{role="client",worker="{w}"}}' in text
        assert f'fleet_worker_up{{worker="{w}"}} 1' in text
    evs = merged["traceEvents"]
    pid_of = {e["args"]["name"]: e["pid"] for e in evs
              if e.get("ph") == "M" and e["name"] == "process_name"}
    assert {"worker:w1", "worker:w2", "server"} <= set(pid_of)
    assert len(set(pid_of.values())) == len(pid_of)
    pushes = [e for e in evs if e["name"] == "ps/push" and e["pid"] == pid_of["worker:w1"]]
    applies = {e["args"]["trace_id"] for e in evs
               if e["name"] == "ps/apply_push" and e["pid"] == pid_of["server"]}
    assert pushes and {e["args"]["trace_id"] for e in pushes} <= applies
