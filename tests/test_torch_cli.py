"""The port's operational CLI (``python -m deeplearning4j_torch``) against
the JAX package's (``tests/test_cli.py`` is the oracle), on the CPU
(``--device cpu``: the default is the card and raises without one).

- ``train``: a model zip in, a trained zip out, with camelCase flags, a
  data factory, a stats file that ``serve-ui`` serves, ``--workers``
  advisory; its zip is bit-equal to a direct ``ParallelWrapper`` fit of
  the same JAX-written zip and data (a TBPTT char-RNN and a dense net),
  and the dense net's is held against the JAX CLI's own trained zip at
  the port's f32 training tolerance (``tests/test_torch_training.py``:
  parameters 1e-5 absolute).
- ``monitor`` with each flag, locally and against a port ``UIServer``;
  ``--collect`` against a port server; ``incident show`` on bundles
  written by either package; ``monitor --control``.
- ``cache --stats`` and ``--gc``; ``lint`` is not part of the port's CLI
  yet.
- The two-process ``--coordinator`` run over gloo is ``slow``.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import MultiLayerNetwork as JNet
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu import Sgd as JSgd
from deeplearning4j_tpu.main import main as jmain
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.utils.model_serializer import ModelSerializer as JSerializer

from deeplearning4j_torch.control import ControlPolicy, get_control_plane
from deeplearning4j_torch.main import build_parser, cmd_serve_ui, main
from deeplearning4j_torch.monitor import (IncidentRecorder, MetricsRegistry, ThresholdRule,
                                          get_alert_engine, get_fleet, get_flight_recorder,
                                          get_health, get_history, get_prober, get_registry,
                                          get_tracer, monitored_jit)
from deeplearning4j_torch.monitor import incidents as pincidents
from deeplearning4j_torch.ui import InMemoryStatsStorage, UIServer
from deeplearning4j_torch.utils.model_serializer import restore_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: parameters after the same f32 fit in both packages (test_torch_training.py)
PARAM_ATOL_F32 = 1e-5


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
def _clean(monkeypatch, tmp_path):
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path / "data"))
    _reset_port()
    yield
    _reset_port()
    torch.set_num_threads(old)


def _dense_zip(path, n_in=784, n_hidden=16, n_out=10, seed=1, lr=5e-2):
    """A JAX-written dense classifier's zip (the port restores it)."""
    conf = (JConf.builder().seed(seed).updater(JSgd(learning_rate=lr)).activation("tanh")
            .list()
            .layer(jl.DenseLayer(n_in=n_in, n_out=n_hidden))
            .layer(jl.OutputLayer(n_in=n_hidden, n_out=n_out, activation="softmax",
                                  loss="mcxent"))
            .build())
    JSerializer.write_model(JNet(conf).init(), str(path))
    return str(path)


def _char_rnn_zip(path, vocab=6, h=8, tbptt=4):
    """A JAX-written f32 char-RNN (2 x GravesLSTM + RnnOutputLayer, TBPTT)."""
    conf = (JConf.builder().seed(3).updater(JSgd(learning_rate=0.1)).activation("tanh")
            .list()
            .layer(jl.GravesLSTM(n_in=vocab, n_out=h))
            .layer(jl.GravesLSTM(n_in=h, n_out=h))
            .layer(jl.RnnOutputLayer(n_in=h, n_out=vocab, activation="softmax",
                                     loss="mcxent"))
            .backprop_type("tbptt").t_bptt_forward_length(tbptt)
            .t_bptt_backward_length(tbptt).build())
    JSerializer.write_model(JNet(conf).init(), str(path))
    return str(path)


_FACTORY = '''
import numpy as np
from {pkg}.datasets.dataset import DataSet, ListDataSetIterator

def make():
    rng = np.random.default_rng(0)
    f = {features}
    return ListDataSetIterator([DataSet(f[i:i + {b}], l[i:i + {b}])
                                for i in range(0, {n}, {b})])
'''


def _factory(tmp_path, monkeypatch, name, pkg, kind, n, b):
    if kind == "dense":
        features = ("rng.normal(size=(%d, 784)).astype(np.float32); "
                    "l = np.eye(10, dtype=np.float32)[rng.integers(0, 10, %d)]" % (n, n))
    else:   # one-hot next-character text, vocab 6, T 8
        features = ("np.eye(6, dtype=np.float32)[rng.integers(0, 6, (%d, 9))]; "
                    "l = f[:, 1:]; f = f[:, :-1]" % n)
    (tmp_path / f"{name}.py").write_text(_FACTORY.format(pkg=pkg, features=features, b=b, n=n))
    monkeypatch.syspath_prepend(str(tmp_path))
    return f"{name}:make"


def _flat(net):
    return {f"{i}/{k}": v.detach().numpy().copy() for i, p in net.params.items()
            for k, v in p.items()}


def _direct_fit(model, factory, epochs=1):
    """The same fit through ParallelWrapper.Builder, as the CLI builds it."""
    import importlib
    from deeplearning4j_torch.parallel import ParallelWrapper
    net = restore_model(model, device="cpu")
    mod, _, fn = factory.partition(":")
    (ParallelWrapper.Builder(net).devices(["cpu"]).averaging_frequency(1).prefetch_buffer(16)
     .build().fit(getattr(importlib.import_module(mod), fn)(), epochs=epochs))
    return net


# ------------------------------------------------------------------ train
def test_train_subcommand_end_to_end(tmp_path, capsys):
    model, out, stats = (_dense_zip(tmp_path / "model.zip"), tmp_path / "trained.zip",
                         tmp_path / "stats.jsonl")
    assert main(["train", "--model-path", model, "--model-output-path", str(out),
                 "--data", "mnist", "--num-examples", "256", "--batch-size", "32",
                 "--epochs", "1", "--report-score", "--stats-file", str(stats),
                 "--device", "cpu"]) == 0
    assert f"model written to {out}" in capsys.readouterr().out
    net = restore_model(str(out), device="cpu")
    assert net.iteration_count == 8
    from deeplearning4j_torch.ui import FileStatsStorage
    storage = FileStatsStorage(str(stats))
    (sid,) = storage.list_session_ids()
    ups = storage.get_all_updates(sid)
    storage.close()
    assert [u.iteration for u in ups] == list(range(8))
    assert all(np.isfinite(u.score) for u in ups) and ups[1].update_stats


def test_train_camelcase_flags_and_factory(tmp_path, monkeypatch):
    model, out = _dense_zip(tmp_path / "m.zip"), tmp_path / "t.zip"
    fac = _factory(tmp_path, monkeypatch, "portfac_camel", "deeplearning4j_torch", "dense",
                   128, 32)
    assert main(["train", "--modelPath", model, "--modelOutputPath", str(out),
                 "--dataSetIteratorFactory", fac, "--averagingFrequency", "1",
                 "--prefetchSize", "4", "--reportScore", "--device", "cpu"]) == 0
    assert restore_model(str(out), device="cpu").iteration_count == 4


def test_parser_errors_and_the_card_default(tmp_path, monkeypatch):
    with pytest.raises(SystemExit):
        build_parser().parse_args(["train"])                 # the required pair
    with pytest.raises(SystemExit):
        main(["train", "--model-path", "x", "--model-output-path", "y", "--data", "nope",
              "--device", "cpu"])
    with pytest.raises(SystemExit):
        main(["train", "--model-path", "x", "--model-output-path", "y", "--data", "mnist",
              "--data-factory", "a:b", "--device", "cpu"])
    with pytest.raises(SystemExit):
        main(["cache", "--export", "--model-path", "x"])     # --input-shape, --out missing
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["train", "--model-path", _dense_zip(tmp_path / "m.zip"),
              "--model-output-path", str(tmp_path / "t.zip"), "--data", "iris"])


def test_subcommands_and_lint_absent():
    """``--help`` lists the five subcommands; ``lint`` (the static
    analyser) is not ported yet and is not in the parser."""
    out = subprocess.run([sys.executable, "-m", "deeplearning4j_torch", "--help"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0
    for cmd in ("train", "serve-ui", "monitor", "incident", "cache"):
        assert cmd in out.stdout
    assert "lint" not in out.stdout
    with pytest.raises(SystemExit):
        build_parser().parse_args(["lint"])


def test_workers_flag_is_advisory(tmp_path, capsys):
    model = _dense_zip(tmp_path / "m.zip", n_in=4, n_hidden=8, n_out=3)
    assert main(["train", "--model-path", model, "--model-output-path",
                 str(tmp_path / "t.zip"), "--data", "iris", "--batch-size", "30",
                 "--workers", "8", "--no-average-updaters", "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert "# --workers 8 is advisory: the mesh has 1 devices" in err
    assert "--no-average-updaters has no effect" in err


def test_serve_ui_serves_training_stats(tmp_path):
    import urllib.request
    model, stats = _dense_zip(tmp_path / "m.zip"), tmp_path / "stats.jsonl"
    assert main(["train", "--model-path", model, "--model-output-path",
                 str(tmp_path / "t.zip"), "--data", "mnist", "--num-examples", "128",
                 "--batch-size", "32", "--stats-file", str(stats), "--device", "cpu"]) == 0
    port = cmd_serve_ui(build_parser().parse_args(["serve-ui", "--stats-file", str(stats),
                                                   "--port", "0"]), block=False)
    base = f"http://127.0.0.1:{port}"
    try:
        with urllib.request.urlopen(base + "/train/sessions", timeout=10) as r:
            (sid,) = json.loads(r.read())
        with urllib.request.urlopen(f"{base}/train/overview?sid={sid}", timeout=10) as r:
            assert len(json.loads(r.read())["scores"]) == 4
        # a second run posts through the router into the served storage
        assert main(["train", "--model-path", model, "--model-output-path",
                     str(tmp_path / "t2.zip"), "--data", "mnist", "--num-examples", "64",
                     "--batch-size", "32",
                     "--ui-url", f"127.0.0.1:{port}", "--device", "cpu"]) == 0
        with urllib.request.urlopen(base + "/train/sessions", timeout=10) as r:
            sessions = json.loads(r.read())
        assert len(sessions) == 2 and sid in sessions
    finally:
        UIServer.get_instance().stop()


@pytest.mark.parametrize("kind", ["char_rnn", "dense"])
def test_trained_zip_equals_a_direct_fit_and_the_jax_cli(tmp_path, monkeypatch, kind):
    """The CLI's fit is a ParallelWrapper fit: its zip's parameters are
    bit-equal to a direct one of the same JAX-written zip and data (a
    TBPTT char-RNN: two segments a batch). The dense net's are also held
    against the JAX CLI's trained zip on the same zip and data; one batch
    an epoch, so that the JAX package's 8 virtual devices take one step
    an epoch, as the port's one slot does."""
    if kind == "char_rnn":
        model = _char_rnn_zip(tmp_path / "m.zip")
        fac = _factory(tmp_path, monkeypatch, "portfac_rnn", "deeplearning4j_torch", kind,
                       32, 16)
        epochs = 1
    else:
        model = _dense_zip(tmp_path / "m.zip")
        fac = _factory(tmp_path, monkeypatch, "portfac_dense", "deeplearning4j_torch", kind,
                       16, 16)
        epochs = 3
    out = tmp_path / "t.zip"
    assert main(["train", "--model-path", model, "--model-output-path", str(out),
                 "--data-factory", fac, "--epochs", str(epochs), "--device", "cpu"]) == 0
    got = _flat(restore_model(str(out), device="cpu"))
    want = _flat(_direct_fit(model, fac, epochs))
    assert list(got) == list(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert any(not np.array_equal(got[k], v) for k, v in
               _flat(restore_model(model, device="cpu")).items())
    if kind == "dense":
        jfac = _factory(tmp_path, monkeypatch, "jaxfac_dense", "deeplearning4j_tpu", kind,
                        16, 16)
        jout = tmp_path / "jax_t.zip"
        assert jmain(["train", "--model-path", model, "--model-output-path", str(jout),
                      "--data-factory", jfac, "--epochs", str(epochs)]) == 0
        jnet = restore_model(str(jout), device="cpu")
        assert jnet.iteration_count == epochs
        for k, v in _flat(jnet).items():
            np.testing.assert_allclose(got[k], v, rtol=0, atol=PARAM_ATOL_F32, err_msg=k)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_train_multihost_coordinator_flags(tmp_path):
    """Two CLI processes form a gloo group and train their halves of the
    data; only rank 0 writes the model."""
    (tmp_path / "partfactory.py").write_text(
        "import numpy as np, torch.distributed as dist\n"
        "from deeplearning4j_torch.datasets.dataset import DataSet, ListDataSetIterator\n"
        "def make():\n"
        "    rng = np.random.default_rng(0)\n"
        "    sets = [DataSet(rng.normal(size=(8, 6)).astype(np.float32),\n"
        "                    np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)])\n"
        "            for _ in range(8)]\n"
        "    return ListDataSetIterator(sets[dist.get_rank()::2])\n")
    model = _dense_zip(tmp_path / "m.zip", n_in=6, n_hidden=8, n_out=3, seed=2, lr=1e-2)
    out = tmp_path / "trained.zip"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), ROOT,
                                                       os.environ.get("PYTHONPATH", "")]))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_torch", "train", "--model-path", model,
         "--model-output-path", str(out), "--data-factory", "partfactory:make",
         "--epochs", "2", "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(p), "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
        for p in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    assert out.exists() and "model written" in outs[0] and "model written" not in outs[1]
    assert restore_model(str(out), device="cpu").iteration_count == 8


# ---------------------------------------------------------------- monitor
def _ui():
    srv = UIServer(port=0)
    srv.attach(InMemoryStatsStorage())
    return srv, f"127.0.0.1:{srv.start()}"


def test_monitor_default_fleet_and_events(tmp_path, capsys):
    """The plain dump (local, ``--url``, ``--trace-out``), ``--fleet``
    and ``--events``, text and JSON."""
    get_registry().counter("cli_probe_total").inc(2)
    reg = MetricsRegistry()
    reg.counter("cli_fleet_probe_total").inc(2)
    get_fleet().record_report("cli-w", {"registry": reg.dump()})
    get_flight_recorder().record("cli_probe_event", detail=7)
    with get_tracer().span("cli_span", cat="test"):
        pass
    assert main(["monitor"]) == 0
    out = capsys.readouterr().out
    assert "cli_probe_total 2" in out and "# health " in out
    assert main(["monitor", "--fleet", "--format", "json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["workers"]["cli-w"]["stale"] is False
    assert main(["monitor", "--fleet"]) == 0
    assert 'cli_fleet_probe_total{worker="cli-w"} 2' in capsys.readouterr().out
    assert main(["monitor", "--events"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["detail"] for r in rows if r["event"] == "cli_probe_event"] == [7]
    srv, url = _ui()
    try:
        trace = tmp_path / "trace.json"
        assert main(["monitor", "--url", url, "--format", "json",
                     "--trace-out", str(trace)]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert "cli_probe_total 2" in doc["metrics_text"] and "healthy" in doc["health"]
        assert "cli_span" in {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
        assert main(["monitor", "--fleet", "--url", url, "--format", "json"]) == 0
        assert "cli-w" in json.loads(capsys.readouterr().out)["workers"]
        assert main(["monitor", "--events", "--url", url]) == 0
        assert "cli_probe_event" in capsys.readouterr().out
    finally:
        srv.stop()


def test_monitor_collect_against_a_port_server(capsys):
    get_registry().counter("cli_collect_probe_total").inc(3)
    srv, url = _ui()
    try:
        assert main(["monitor", "--collect", f"cli0={url}"]) == 0
        out = capsys.readouterr().out
        assert 'fleet_target_up{target="cli0"}' in out
        assert 'cli_collect_probe_total{worker="cli0"} 3' in out
        assert main(["monitor", "--collect", f"cli0={url}", "--format", "json"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["targets"]["targets"]["cli0"]["up"] is True
        assert "cli0" in doc["liveness"]["workers"]
        assert main(["monitor", "--collect", url]) == 0
        assert f'worker="{url}"' in capsys.readouterr().out
    finally:
        srv.stop()
    assert main(["monitor", "--collect", "dead=127.0.0.1:9"]) == 1
    assert "# scrape dead FAILED" in capsys.readouterr().err


def test_monitor_probes(capsys):
    from deeplearning4j_torch.serving import InferenceServer

    class _Twice:
        def output(self, x, mask=None):
            return np.asarray(x, np.float32) * 2.0

    prober = get_prober()
    assert main(["monitor", "--probes"]) == 0
    assert "# no probe targets configured" in capsys.readouterr().out
    srv = InferenceServer()
    m = srv.register("cliprobe", _Twice(), device="cpu", input_shape=(2,),
                     batch_buckets=(1, 2), linger_ms=0.0)
    port = srv.start(port=0)
    ui, url = _ui()
    try:
        prober.add_target("cli_t", f"127.0.0.1:{port}", m.golden())
        prober.tick()
        assert main(["monitor", "--probes"]) == 0
        out = capsys.readouterr().out
        assert "cli_t" in out and f"golden={m.golden()['version']}" in out
        assert "fails=0" in out and "# running=False" in out
        assert main(["monitor", "--probes", "--url", url, "--format", "json"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["targets"]["cli_t"]["last_outcome"] == "ok"
    finally:
        prober.remove_target("cli_t")
        ui.stop()
        srv.stop()


def test_monitor_profile(capsys):
    f = monitored_jit(lambda x: x + 1, name="cli/profile_probe")
    f(torch.ones(2))
    assert main(["monitor", "--profile"]) == 0
    out = capsys.readouterr().out
    assert "cli/profile_probe" in out and "# device memory" in out
    assert main(["monitor", "--profile", "--format", "json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["jit"]["cli/profile_probe"]["compiles"] == 1 and "steps" in doc
    srv, url = _ui()
    try:
        assert main(["monitor", "--profile", "--url", url]) == 0
        assert "cli/profile_probe" in capsys.readouterr().out
        assert main(["monitor", "--profile", "--url", url, "--format", "json"]) == 0
        assert "cli/profile_probe" in json.loads(capsys.readouterr().out)["jit"]
    finally:
        srv.stop()


def test_monitor_alerts_and_history(capsys):
    engine, hist = get_alert_engine(), get_history()
    get_registry().counter("cli_alert_probe_total").inc(5)
    hist.sample()
    engine.add(ThresholdRule("cli_probe", "cli_alert_probe_total", threshold=1.0))
    assert main(["monitor", "--alerts"]) == 0
    out = capsys.readouterr().out
    assert "cli_probe" in out and "# FIRING: cli_probe" in out
    assert main(["monitor", "--history"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["samples"] >= 1 and "cli_alert_probe_total" in doc["metrics"]
    srv, url = _ui()
    try:
        assert main(["monitor", "--alerts", "--url", url, "--format", "json"]) == 0
        assert json.loads(capsys.readouterr().out)["firing"] == ["cli_probe"]
        assert main(["monitor", "--history", "--url", url]) == 0
        assert json.loads(capsys.readouterr().out)["samples"] >= 1
    finally:
        srv.stop()


def test_monitor_control(capsys):
    """JAX's ``TestSurfaces::test_control_endpoint_profile_block_and_cli``
    CLI half: ``monitor --control`` locally and against a ``UIServer``."""
    assert main(["monitor", "--control"]) == 0
    assert "# no control policies registered" in capsys.readouterr().out
    get_control_plane().add(ControlPolicy("surface_probe", lambda ctx: "ok",
                                          rules=("surface_rule",), cooldown_s=1.0))
    assert main(["monitor", "--control"]) == 0
    out = capsys.readouterr().out
    assert "surface_probe" in out and "on=surface_rule" in out
    assert main(["monitor", "--control", "--format", "json"]) == 0
    assert json.loads(capsys.readouterr().out)["policies"][0]["policy"] == "surface_probe"
    srv, url = _ui()
    try:
        assert main(["monitor", "--control", "--url", url]) == 0
        assert "surface_probe" in capsys.readouterr().out
    finally:
        srv.stop()


def test_monitor_incidents(tmp_path, capsys, monkeypatch):
    assert main(["monitor", "--incidents"]) == 0
    out = capsys.readouterr().out
    assert "# no incidents recorded" in out and "open=none" in out
    rec = IncidentRecorder(engine=get_alert_engine(), dump_dir=str(tmp_path))
    monkeypatch.setattr(pincidents, "_RECORDER", rec)
    rec._on_edge("alert_firing", {"rule": "cli_inc", "severity": "page", "value": 7.0,
                                  "detail": "smoke", "exemplar_trace_id": None})
    rec.tick(now=100.0)
    rec._on_edge("alert_resolved", {"rule": "cli_inc", "detail": "ok"})
    rec.tick(now=101.0)
    assert main(["monitor", "--incidents"]) == 0
    out = capsys.readouterr().out
    assert "resolved" in out and "inc-0001" in out and "rules=cli_inc" in out
    assert "bundle=" in out
    srv, url = _ui()
    try:
        assert main(["monitor", "--incidents", "--url", url, "--format", "json"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert [(r["id"], r["status"]) for r in doc["incidents"]] == [("inc-0001",
                                                                       "resolved")]
    finally:
        srv.stop()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_incident_show_renders_bundles_of_both_packages(tmp_path, capsys, monkeypatch, writer):
    """JAX's ``test_incident_show_cli_renders_offline`` on the port's CLI,
    for a bundle each package wrote; a tampered byte fails the content
    address with exit 1."""
    from types import SimpleNamespace
    if writer == "jax":
        from deeplearning4j_tpu.monitor import (flightrec as jflightrec,
                                                incidents as jincidents,
                                                registry as jregistry, tracer as jtracer)
        monkeypatch.setattr(jregistry, "get_registry", jregistry.MetricsRegistry)
        monkeypatch.setattr(jflightrec, "get_flight_recorder", jflightrec.FlightRecorder)
        monkeypatch.setattr(jtracer, "get_tracer", jtracer.Tracer)
        mod = jincidents
    else:
        mod = pincidents
    engine = SimpleNamespace(rules=lambda: [], history=SimpleNamespace(samples=lambda: []))
    rec = mod.IncidentRecorder(engine=engine, dump_dir=str(tmp_path))
    rec._on_edge("alert_firing", {"rule": "cli_inc", "severity": "page", "value": 7.0,
                                  "detail": "smoke", "exemplar_trace_id": None})
    rec.tick(now=100.0)
    rec._on_edge("alert_resolved", {"rule": "cli_inc", "detail": "ok"})
    rec.tick(now=101.0)
    (path,) = sorted(tmp_path.glob("*.dl4jinc"))
    assert main(["incident", "show", str(path)]) == 0
    out = capsys.readouterr().out
    assert "# incident inc-0001 — resolved" in out and "cli_inc" in out
    assert main(["incident", "show", str(path), "--format", "json"]) == 0
    assert json.loads(capsys.readouterr().out)["status"] == "resolved"
    raw = path.read_bytes()
    path.write_bytes(raw.replace(b'"resolved"', b'"Resolved"', 1))
    assert main(["incident", "show", str(path)]) == 1
    assert "content address" in capsys.readouterr().err


# ------------------------------------------------------------------ cache
def test_cache_stats_and_gc(tmp_path, capsys):
    """The census of an empty and of a populated directory, and a GC that
    lists (dry run) and then deletes an orphaned temp file."""
    assert main(["cache", "--stats", "--dir", str(tmp_path)]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["dir"] == str(tmp_path) and doc["artifacts"] == doc["entries"] == 0
    assert "process" in doc and doc["bytes"] == 0
    (tmp_path / "m-0123456789abcdef.dl4jaot").write_bytes(b"not a zip")
    (tmp_path / "lost.tmp").write_bytes(b"x" * 10)
    assert main(["cache", "--dir", str(tmp_path)]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["artifacts"] == 1 and doc["bytes"] == 19
    assert main(["cache", "--gc", "--dir", str(tmp_path)]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["dry_run"] is True and len(rep["evicted"]) == 2
    assert (tmp_path / "lost.tmp").exists()
    assert main(["cache", "--gc", "--apply", "--dir", str(tmp_path)]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["dry_run"] is False and not os.listdir(tmp_path)
