"""The port's monitor core (``deeplearning4j_torch/monitor/``) against the
JAX package's.

- The fit loops observe every minibatch by default, as the JAX loops do: a
  bare ``fit`` (no listener) leaves the same last iteration and score in
  both packages' health state and registry (multilayer, graph and TBPTT
  fits of one network, carried over in a model zip; scores within
  SCORE_RTOL, f32 sums in another order).
- The registry renders byte-identical Prometheus text for one sequence of
  operations, and each package's ``render_prometheus_dump`` re-renders the
  other's dump identically.
- The tracer: nesting and Chrome export, the ring's drop count, remote
  parents, a fit's ``epoch`` → ``step`` nesting (the same spans as the JAX
  fit's), and the ``torch.profiler`` annotation only while a profiler
  records.
- The flight recorder's bounds, order and JSONL dump, and the dump on a
  ``TrainingHealthListener`` halt.
- The input pipeline's and the parameter-server metrics' series, the
  device-memory sampler on the CPU, and the monitor's switch.
"""
import json
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import (NeuralNetConfiguration as JConf, MultiLayerNetwork as JNet,
                                ComputationGraph as JGraph, DataSet as JDataSet,
                                ListDataSetIterator as JList, Sgd as JSgd)
from deeplearning4j_tpu import monitor as jmon
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.utils.model_serializer import ModelSerializer

from deeplearning4j_torch import DataSet, ListDataSetIterator
from deeplearning4j_torch import monitor as mon
from deeplearning4j_torch.datasets.iterators import AsyncDataSetIterator
from deeplearning4j_torch.datasets.prefetch import PrefetchDataSetIterator
from deeplearning4j_torch.monitor import (FlightRecorder, SpanContext, Tracer,
                                          TrainingHealthListener, get_fleet,
                                          get_flight_recorder, get_health, get_registry,
                                          get_tracer)
from deeplearning4j_torch.paramserver import ParamServerMetrics, TrainStepPhases
from deeplearning4j_torch.utils.model_serializer import restore_model

SCORE_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _fresh_monitor():
    """The port's planes are process-wide: each test starts from empty ones
    (and the monitor on, as by default)."""
    for plane in (get_registry(), get_tracer(), get_flight_recorder(), get_fleet()):
        plane.clear()
    get_health().reset()
    mon.set_enabled(True)
    yield
    mon.set_enabled(True)
    get_health().reset()


def _jax_mln(seed=1):
    conf = (JConf.builder().seed(seed).updater(JSgd(learning_rate=0.1)).activation("tanh")
            .list().layer(jl.DenseLayer(n_in=4, n_out=8))
            .layer(jl.OutputLayer(n_in=8, n_out=3, activation="softmax", loss="mcxent"))
            .build())
    return JNet(conf).init()


def _jax_graph(seed=2):
    conf = (JConf.builder().seed(seed).updater(JSgd(learning_rate=0.1)).activation("tanh")
            .graph_builder().add_inputs("in")
            .add_layer("d", jl.DenseLayer(n_in=4, n_out=8), "in")
            .add_layer("out", jl.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                             loss="mcxent"), "d")
            .set_outputs("out").build())
    return JGraph(conf).init()


def _jax_tbptt(seed=3):
    conf = (JConf.builder().seed(seed).updater(JSgd(learning_rate=0.1)).activation("tanh")
            .list().layer(jl.GravesLSTM(n_in=3, n_out=5))
            .layer(jl.RnnOutputLayer(n_in=5, n_out=3, activation="softmax", loss="mcxent"))
            .backprop_type("tbptt").t_bptt_forward_length(3).t_bptt_backward_length(3)
            .build())
    return JNet(conf).init()


def _data(kind, seed=0, n=16):
    rng = np.random.default_rng(seed)
    if kind == "tbptt":
        f = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (n, 7))]
        return f, np.roll(f, -1, axis=1)
    return (rng.normal(size=(n, 4)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)])


def _port(jnet, tmp_path, name="m.zip"):
    path = str(tmp_path / name)
    ModelSerializer.write_model(jnet, path)
    return restore_model(path, device="cpu")


def jmon_iter(batches):
    return JList([JDataSet(f, l) for f, l in batches])


def _jax_series(name):
    fam = jmon.get_registry().dump().get(name, {"children": []})
    return sum(row.get("value", row.get("count", 0)) for row in fam["children"])


# ------------------------------------------------------------- the repair
@pytest.mark.parametrize("kind", ["multilayer", "graph", "tbptt"])
def test_bare_fit_records_health_and_registry_like_jax(kind, tmp_path):
    """No listener, monitor on by default: after two fits of two minibatches
    each package's health state and registry hold the last iteration and
    its score, the iteration and example counts, and (outside TBPTT) a
    step and a wait time per minibatch. The port's fit observed only with
    listeners before: its health held no iteration."""
    jnet = {"multilayer": _jax_mln, "graph": _jax_graph, "tbptt": _jax_tbptt}[kind]()
    net = _port(jnet, tmp_path)
    batches = [_data(kind, seed=s) for s in (0, 1)]
    before = {k: _jax_series(k) for k in ("training_iterations_total",
                                         "training_examples_total", "training_step_ms",
                                         "training_etl_ms")}
    for _ in range(2):
        jnet.fit(jmon_iter(batches))
        net.fit(ListDataSetIterator([DataSet(f, l) for f, l in batches]))
    jh, h = jmon.get_health().snapshot(), get_health().snapshot()
    last = 11 if kind == "tbptt" else 3     # TBPTT: 3 segments, 3 updates a batch
    assert h["last_iteration"] == jh["last_iteration"] == last
    np.testing.assert_allclose(h["last_score"], jh["last_score"], rtol=SCORE_RTOL)
    reg = get_registry()
    assert reg.gauge("training_iteration").value == last == \
        jmon.get_registry().gauge("training_iteration").value
    np.testing.assert_allclose(reg.gauge("training_score").value,
                               jmon.get_registry().gauge("training_score").value,
                               rtol=SCORE_RTOL)
    assert reg.gauge("training_score").value == h["last_score"]
    assert reg.counter("training_iterations_total").value == 4 == \
        _jax_series("training_iterations_total") - before["training_iterations_total"]
    assert reg.counter("training_examples_total").value == 64 == \
        _jax_series("training_examples_total") - before["training_examples_total"]
    timed = 0 if kind == "tbptt" else 4
    for name in ("training_step_ms", "training_etl_ms"):
        assert reg.histogram(name).summary().get("n", 0.0) == timed == \
            _jax_series(name) - before[name]


def test_monitor_switch_off_records_nothing_and_changes_no_arithmetic(tmp_path):
    """``set_enabled(False)`` with no listener: no value fetch, no series,
    no span, no health write; the same parameters as the monitored fit."""
    jnet = _jax_mln()
    on, off = _port(jnet, tmp_path, "a.zip"), _port(jnet, tmp_path, "b.zip")
    f, l = _data("multilayer")
    on.fit(f, l)
    get_registry().clear()
    get_tracer().clear()
    get_health().reset()
    mon.set_enabled(False)
    off.fit(f, l)
    assert not [n for n in get_registry().dump() if n.startswith("training_")]
    assert [e["name"] for e in get_tracer().events()] == ["epoch"]
    assert get_health().snapshot()["last_iteration"] is None
    for k, ps in on.params.items():
        for n, t in ps.items():
            assert torch.equal(t, off.params[k][n])


# --------------------------------------------------------------- registry
def _registry_ops(mod):
    reg = mod.MetricsRegistry()
    reg.counter("reqs_total", "requests", route="/a").inc(3)
    reg.counter("reqs_total", "requests", route='/b"q\\n').inc(0.5)
    reg.gauge("temp", "temperature").set(21.5)
    reg.gauge("depth", "queue depth", q="x").set(7)
    reg.gauge("depth", "queue depth", q="x").dec(2)
    h = reg.histogram("lat_ms", "latency", op="push")
    for v in (0.05, 0.3, 1.0, 17.0, 5000.0):
        h.observe(v)
    s = reg.histogram("wait_seconds", "wait (seconds)", unit="s", lock="L")
    for v in (1e-5, 0.003, 0.25, 2.0):
        s.observe(v)
    reg.histogram("empty_ms", "nothing yet")
    return reg


def test_registry_renders_byte_identical_to_jax():
    """One sequence of operations: the same Prometheus text, the same
    snapshot, in both packages."""
    port, jax_ = _registry_ops(mon), _registry_ops(jmon)
    assert port.render_prometheus() == jax_.render_prometheus()
    assert port.snapshot() == jax_.snapshot()
    with pytest.raises(ValueError):
        port.gauge("reqs_total")
    with pytest.raises(ValueError):
        port.histogram("wait_seconds", unit="ms", lock="L")


def test_dumps_rerender_across_packages():
    """A dump that crossed the wire as JSON re-renders in the other
    package byte for byte, with and without the fleet's worker label."""
    port, jax_ = _registry_ops(mon), _registry_ops(jmon)
    port_wire = json.loads(json.dumps(port.dump()))
    jax_wire = json.loads(json.dumps(jax_.dump()))
    assert jmon.render_prometheus_dump(port_wire) == port.render_prometheus()
    assert mon.render_prometheus_dump(jax_wire) == jax_.render_prometheus()
    assert jmon.render_prometheus_dump(port_wire, {"worker": "w9"}) == \
        mon.render_prometheus_dump(port_wire, {"worker": "w9"})
    assert 'reqs_total{route="/a",worker="w9"} 3' in \
        mon.render_prometheus_dump(port_wire, {"worker": "w9"})


# ----------------------------------------------------------------- tracer
def test_tracer_nesting_and_chrome_export():
    tr = Tracer()
    with tr.span("outer", cat="test", k=1):
        with tr.span("inner", cat="test"):
            time.sleep(0.002)
    evs = json.loads(json.dumps(tr.export()))["traceEvents"]
    assert len(evs) == 2
    for e in evs:
        assert e["ph"] == "X" and {"name", "cat", "ts", "dur", "pid", "tid"} <= set(e)
    inner, outer = evs
    assert (inner["name"], outer["name"]) == ("inner", "outer")
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1
    assert outer["args"]["k"] == 1
    assert inner["args"]["trace_id"] == outer["args"]["trace_id"]
    assert inner["args"]["parent_span_id"] == outer["args"]["span_id"]
    assert "parent_span_id" not in outer["args"]


def test_tracer_ring_overflow_counts_drops():
    tr = Tracer(capacity=5)
    for i in range(12):
        with tr.span(f"s{i}"):
            pass
    assert [e["name"] for e in tr.events()] == [f"s{i}" for i in range(7, 12)]
    assert tr.dropped == 7
    assert get_registry().counter("tracer_spans_dropped_total").value == 7
    assert "tracer_spans_dropped_total 7" in get_registry().render_prometheus()


def test_tracer_remote_parent_record_complete_and_decorator():
    client_tr, server_tr = Tracer(), Tracer()
    with client_tr.span("rpc") as ctx:
        with server_tr.span("handle", parent=SpanContext(ctx.trace_id, ctx.span_id)):
            pass
        server_tr.record_complete("late", time.perf_counter(), 1e-3)
    handle, late = server_tr.events()
    rpc = client_tr.events()[0]
    assert handle["args"]["trace_id"] == rpc["args"]["trace_id"]
    assert handle["args"]["parent_span_id"] == rpc["args"]["span_id"]
    assert "parent_span_id" not in late["args"]    # no open span on server_tr
    root = mon.new_context()
    assert root.parent_span_id == 0 and root.trace_id and root.span_id

    @client_tr.trace(cat="test")
    def add(a, b):
        return a + b
    assert add(1, 2) == 3 and client_tr.events()[-1]["name"].endswith("add")


def test_fit_produces_nested_epoch_step_spans_like_jax(tmp_path):
    """Three fits of one minibatch: a ``step`` span per minibatch, each a
    child of its fit's ``epoch`` span, the same spans as the JAX fit's."""
    jnet = _jax_mln()
    net = _port(jnet, tmp_path)
    f, l = _data("multilayer")
    jmon.get_tracer().clear()
    for _ in range(3):
        jnet.fit(JDataSet(f, l))
        net.fit(DataSet(f, l))

    def shape(events):
        by_id = {e["args"]["span_id"]: e for e in events}
        return [(e["name"], e["args"].get("iteration", e["args"].get("epoch")),
                 by_id[e["args"]["parent_span_id"]]["name"]
                 if "parent_span_id" in e["args"] else None) for e in events
                if e["name"] in ("epoch", "step")]
    got = shape(get_tracer().events())
    assert got == shape(jmon.get_tracer().events())
    assert got == [("step", 0, "epoch"), ("epoch", 0, None), ("step", 1, "epoch"),
                   ("epoch", 1, None), ("step", 2, "epoch"), ("epoch", 2, None)]


def test_step_span_annotates_a_recording_profiler_only():
    """Inside a ``torch.profiler`` session the ``step`` span is a
    ``record_function`` range around the step's operations; outside one no
    annotation is made."""
    from deeplearning4j_torch.monitor import tracer as tracer_mod
    assert tracer_mod._annotation("step") is None
    x = torch.ones(64, 64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with mon.step_span(5):
            x @ x
    names = [e.name for e in prof.events()]
    assert "step" in names and "aten::mm" in names
    step = next(e for e in prof.events() if e.name == "step")
    mm = next(e for e in prof.events() if e.name == "aten::mm")
    assert step.time_range.start <= mm.time_range.start
    assert mm.time_range.end <= step.time_range.end
    assert [e["args"]["iteration"] for e in get_tracer().events()] == [5]


# -------------------------------------------------------- flight recorder
def test_flight_recorder_bounds_order_and_jsonl_dump(tmp_path):
    fr = FlightRecorder(capacity=4)
    for i in range(7):
        fr.record("e", i=i)
    evs = fr.events()
    assert len(evs) == len(fr) == 4 and fr.dropped == 3
    assert [e["i"] for e in evs] == [3, 4, 5, 6]
    assert [e["seq"] for e in evs] == [4, 5, 6, 7]
    fr.record("weird", obj=object())       # degrades to repr in the dump
    path = fr.dump(path=str(tmp_path / "fr.jsonl"))
    rows = [json.loads(line) for line in open(path).read().splitlines()]
    assert [r["event"] for r in rows] == ["e", "e", "e", "weird"]
    assert "object" in rows[-1]["obj"] and fr.last_dump_path == path
    assert fr.dump(path=str(tmp_path / "missing" / "x.jsonl")) is None


def test_halt_dumps_flight_recorder(tmp_path, monkeypatch):
    """A ``TrainingHealthListener(action="halt")`` on a NaN score stops a
    port fit after that minibatch, records ``health_problem`` and ``halt``
    and leaves the recorder's JSONL dump in ``DL4J_TPU_FLIGHT_DIR``."""
    monkeypatch.setenv("DL4J_TPU_FLIGHT_DIR", str(tmp_path))
    net = _port(_jax_mln(), tmp_path)
    f, l = _data("multilayer")
    bad = f.copy()
    bad[0, 0] = np.nan
    get_flight_recorder().record("before_halt", marker=1)
    net.set_listeners(TrainingHealthListener(action="halt"))
    net.fit(ListDataSetIterator([DataSet(f, l), DataSet(bad, l), DataSet(f, l)]))
    assert net.iteration_count == 2 and get_health().snapshot()["halted"]
    dumps = list(tmp_path.glob("flightrec-*.jsonl"))
    assert len(dumps) == 1
    rows = [json.loads(line) for line in dumps[0].read_text().splitlines()]
    assert [r["event"] for r in rows] == ["before_halt", "health_problem", "halt"]
    assert rows[1]["kind"] == "nan" and "iteration 1" in rows[2]["reason"]


# ------------------------------------------------------- the wired series
def test_input_pipeline_series_after_a_fit(tmp_path):
    """A fit through the prefetch pipeline and through an
    ``AsyncDataSetIterator`` fills the JAX package's input series."""
    net = _port(_jax_mln(), tmp_path)
    batches = [DataSet(*_data("multilayer", seed=s)) for s in range(3)]
    nbytes = sum(ds.features.nbytes + ds.labels.nbytes for ds in batches)
    it = PrefetchDataSetIterator(ListDataSetIterator(batches), workers=2, device="cpu")
    try:
        net.fit(it)
    finally:
        it.shutdown()
    reg = get_registry()
    assert reg.counter("input_batches_total").value == 3
    assert reg.counter("input_bytes_total").value == nbytes
    assert reg.histogram("input_wait_seconds", unit="s").summary()["n"] == 3
    assert reg.gauge("input_queue_depth").value >= 0
    for ds in AsyncDataSetIterator(ListDataSetIterator(batches)):
        pass
    assert reg.counter("dataset_batches_total").value == 3
    assert reg.histogram("dataset_next_ms").summary()["n"] == 3


def test_paramserver_metrics_mirror_and_phase_spans():
    """``ParamServerMetrics`` mirrors every increment into the registry
    (shared per role); ``TrainStepPhases`` spans each phase and fills the
    phase and wall histograms, as the JAX classes do."""
    a, b = ParamServerMetrics(role="client"), ParamServerMetrics(role="client")
    a.record_push(2.0, 100)
    b.record_pull(3.0, 40)
    b.add("retries", 2)
    reg = get_registry()
    assert reg.counter("paramserver_push_bytes_total", role="client").value == 100
    assert reg.counter("paramserver_pull_bytes_total", role="client").value == 40
    assert reg.counter("paramserver_retries_total", role="client").value == 2
    assert a.snapshot()["counters"]["pushes"] == 1 and b.snapshot()["counters"]["pushes"] == 0
    tr = Tracer()
    phases = TrainStepPhases(tr, overlap=True)
    for p in TrainStepPhases.PHASES:
        with phases.phase(p):
            pass
    phases.wall(1.0)
    assert [e["name"] for e in tr.events()] == [f"train/{p}" for p in TrainStepPhases.PHASES]
    assert reg.histogram("train_step_phase_ms", phase="push").summary()["n"] == 1
    assert reg.histogram("train_step_wall_ms").summary()["n"] == 1
    assert reg.gauge("train_overlap_active").value == 1.0
    assert phases.snapshot()["phases"]["encode"]["n"] == 1.0


def test_device_memory_sampler_and_health_problem_events():
    """On a process that never touched CUDA the sampler records nothing
    (it never initialises the card); a health problem is a flight event."""
    out = mon.sample_device_memory()
    assert out == {"devices": {}, "live_buffers": None}
    assert "device_memory_in_use_bytes" not in get_registry().dump()
    get_health().record_problem("stall", "slow")
    assert [(e["event"], e["kind"]) for e in get_flight_recorder().events()] == \
        [("health_problem", "stall")]
