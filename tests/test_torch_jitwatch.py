"""The port's jitwatch (``deeplearning4j_torch/monitor/jitwatch.py``) and
metric history against the JAX package's.

A compile in the port is the first call of a watched function at an
argument signature it has not seen. The signature strings and deltas are
the JAX package's on the same argument trees (tensors beside jax arrays);
the retrace-storm detector trips where JAX's does (a fit whose batch size
churns) and stays quiet where JAX's does (a fixed batch, a TBPTT fit with
a ragged tail); ``TrainingHealthListener`` applies warn/raise/halt to a
storm of its own thread. ``profile_report``'s blocks, ``_serving_block``
and ``render_profile_text`` are held to JAX's on the same recorded series,
and ``MetricsHistory``'s readers on the same samples. Exact comparisons
throughout (the same integer counts and strings).
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import (NeuralNetConfiguration as JConf, MultiLayerNetwork as JNet,
                                DataSet as JDataSet, Sgd as JSgd)
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.monitor import jitwatch as jjw
from deeplearning4j_tpu.monitor import history as jhist
from deeplearning4j_tpu.monitor import registry as jreg
from deeplearning4j_tpu.monitor import TrainingHealthListener as JHealthListener
from deeplearning4j_tpu.utils.model_serializer import ModelSerializer

from deeplearning4j_torch import DataSet, monitor as mon
from deeplearning4j_torch.monitor import (TrainingHealthError, TrainingHealthListener,
                                          get_flight_recorder, get_health, get_jit_registry,
                                          get_registry, get_tracer, monitored_jit,
                                          profile_report, render_profile_text)
from deeplearning4j_torch.monitor import history as phist
from deeplearning4j_torch.monitor import jitwatch as pjw
from deeplearning4j_torch.monitor import registry as preg
from deeplearning4j_torch.utils.model_serializer import restore_model


@pytest.fixture(autouse=True)
def _clean_monitor_state():
    """Storms, problems and flight events are process-global."""
    for clear in (get_health().reset, get_flight_recorder().clear,
                  get_jit_registry().drain_storms):
        clear()
    yield
    for clear in (get_health().reset, get_flight_recorder().clear,
                  get_jit_registry().drain_storms):
        clear()


@pytest.fixture()
def cost_capture(monkeypatch):
    """FLOP counts of first calls on for one test, as
    ``DL4J_TPU_JITWATCH_COST=1`` at import sets them (they slow every later
    first call in the process, so they are switched off again)."""
    monkeypatch.setattr(pjw, "_COST_CAPTURE", True)


def _jnet(seed=1, tbptt=False):
    b = JConf.builder().seed(seed).updater(JSgd(learning_rate=0.1)).activation("tanh").list()
    if tbptt:
        b = (b.layer(jl.LSTM(n_in=3, n_out=8)).layer(jl.RnnOutputLayer(
            n_in=8, n_out=3, activation="softmax", loss="mcxent"))
             .backprop_type("tbptt").t_bptt_forward_length(4).t_bptt_backward_length(4))
    else:
        b = (b.layer(jl.DenseLayer(n_in=4, n_out=8))
             .layer(jl.OutputLayer(n_in=8, n_out=3, activation="softmax", loss="mcxent")))
    return JNet(b.build()).init()


def _port(jnet, tmp_path, name="m.zip"):
    path = str(tmp_path / name)
    ModelSerializer.write_model(jnet, path)
    return restore_model(path, device="cpu")


def _ds(batch, rng, t=None):
    if t is None:
        f = rng.normal(size=(batch, 4)).astype(np.float32)
        l = np.eye(3, dtype=np.float32)[rng.integers(0, 3, batch)]
    else:
        f = rng.normal(size=(batch, t, 3)).astype(np.float32)
        l = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (batch, t))]
    return f, l


def _storms(fn):
    return [e for e in get_flight_recorder().events()
            if e["event"] == "retrace_storm" and e["fn"] == fn]


# ------------------------------------------------------------- signatures
_TREES = [
    ((np.ones((2, 3), np.float32),), {}),
    ((np.ones((2, 3), np.float32), None, [np.zeros(4, np.int32), 3]), {"k": 1.5}),
    (({"b": np.ones((1,), np.float32), "a": np.ones((2, 2), np.float32)},), {}),
    ((np.ones((5,), np.float32), (np.ones((2,), np.float32),)), {"m": None}),
]


def _as(kind, tree):
    """The same tree with its arrays as torch tensors or jax arrays."""
    if isinstance(tree, np.ndarray):
        return torch.as_tensor(tree) if kind == "torch" else jnp.asarray(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_as(kind, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _as(kind, v) for k, v in tree.items()}
    return tree


@pytest.mark.parametrize("i", range(len(_TREES)))
def test_signature_strings_equal_jax(i):
    args, kwargs = _TREES[i]
    mine = pjw._signature(_as("torch", args), _as("torch", kwargs))
    theirs = jjw._signature(_as("jax", args), _as("jax", kwargs))
    assert mine == theirs


def test_signature_deltas_equal_jax():
    pairs = [(_TREES[0], ((np.ones((3, 3), np.float32),), {})),
             (_TREES[0], ((np.ones((2, 3), np.int32),), {})),
             (_TREES[0], ((np.ones((2, 3), np.float32), np.ones(2, np.float32)), {})),
             (_TREES[1], _TREES[0]), (_TREES[0], _TREES[0])]
    for (a, b) in pairs:
        mine = pjw._sig_delta(pjw._signature(*_as("torch", a)),
                              pjw._signature(*_as("torch", b)))
        theirs = jjw._sig_delta(jjw._signature(*_as("jax", a)), jjw._signature(*_as("jax", b)))
        assert mine == theirs
    assert pjw._sig_delta(None, pjw._signature(*_as("torch", _TREES[0]))) == "first compile"


def test_monitored_fn_counts_first_calls_spans_and_flops(cost_capture):
    """Calls and first calls per signature, the registry series, a
    compile span with its delta, and the first call's FLOPs (those of
    ``FlopCounterMode``); a Python scalar's value is not a new
    signature (JAX traces it as a weakly typed value)."""
    from torch.utils.flop_counter import FlopCounterMode
    f = monitored_jit(lambda a, b, s: (a @ b) * s, name="test/port_matmul")
    a, b = torch.ones(8, 8), torch.ones(8, 8)
    for s in (1.0, 2.0, 3.0, 4.0):
        f(a, b, s)
    assert (f.calls, f.compiles) == (4, 1)
    f(torch.ones(4, 8), b, 1.0)
    assert (f.calls, f.compiles) == (5, 2) and f.cache_miss_ratio == pytest.approx(0.4)
    reg = get_registry()
    assert reg.counter("jit_calls_total", fn="test/port_matmul").value == 5
    assert reg.counter("jit_compiles_total", fn="test/port_matmul").value == 2
    assert reg.histogram("jit_compile_seconds", fn="test/port_matmul").state()[2] == 2
    evs = [e for e in get_tracer().events() if e["name"] == "compile/test/port_matmul"]
    assert evs[-2]["args"]["signature_delta"] == "first compile"
    assert "float32[8,8] -> float32[4,8]" in evs[-1]["args"]["signature_delta"]
    with FlopCounterMode(display=False) as m:
        torch.ones(4, 8) @ b
    row = get_jit_registry().table()["test/port_matmul"]
    assert row["flops"] == m.get_total_flops() and "K1-K7" in row["flops_note"]
    assert f.signatures == ["[0][0]=float32[8,8];[0][1]=float32[8,8];[0][2]=1.0",
                            "[0][0]=float32[4,8];[0][1]=float32[8,8];[0][2]=1.0"]


# ------------------------------------------------------- retrace storms
def test_shape_churn_fit_trips_storm_like_jax(tmp_path):
    """Batch sizes 16..19: four first calls of ``mln/step`` in both
    packages, a retrace storm with a delta naming the batch dimension,
    and the listener's warn action; a fixed batch compiles once and
    stays quiet in both."""
    jnet = _jnet()
    net = _port(jnet, tmp_path)
    health, jhealth = TrainingHealthListener(action="warn"), JHealthListener(action="warn")
    net.set_listeners(health)
    jnet.set_listeners(jhealth)
    rng = np.random.default_rng(0)
    for batch in (16, 17, 18, 19):
        f, l = _ds(batch, rng)
        net.fit(f, l)
        jnet.fit(JDataSet(f, l))
    assert net._jit_step.compiles == jnet._jit_step.compiles == 4
    storms = _storms("mln/step")
    assert storms and "->" in storms[0]["signature_delta"]
    assert "float32[1" in storms[0]["signature_delta"]
    assert any("retrace" in p and "mln/step" in p for p in get_health().snapshot()["problems"])
    assert any(k == "retrace" for k, _, _ in health.triggered)
    assert [k for k, _, _ in health.triggered] == [k for k, _, _ in jhealth.triggered]

    get_flight_recorder().clear()
    jnet2, net2 = _jnet(seed=2), _port(_jnet(seed=2), tmp_path, "b.zip")
    for _ in range(4):
        f, l = _ds(16, rng)
        net2.fit(f, l)
        jnet2.fit(JDataSet(f, l))
    assert (net2._jit_step.compiles, net2._jit_step.calls) == (1, 4)
    assert jnet2._jit_step.compiles == 1
    assert not _storms("mln/step")


@pytest.mark.parametrize("T", [12, 14])
def test_tbptt_fit_is_storm_free_like_jax(tmp_path, T):
    """TBPTT (segments of 4) over T=12 (equal segments: one
    ``nn/tbptt_scan`` first call) and T=14 (a ragged tail: two ``mln/step``
    signatures), three fits each: the same first-call counts as JAX's
    wrappers and no storm in either package."""
    jnet = _jnet(seed=3, tbptt=True)
    net = _port(jnet, tmp_path)
    rng = np.random.default_rng(1)
    for _ in range(3):
        f, l = _ds(4, rng, t=T)
        net.fit(f, l)
        jnet.fit(JDataSet(f, l))
    if T % 4 == 0:
        jcompiles = sum(w.compiles for w in jnet._jit_tbptt_scan.values())
        assert net._jit_tbptt_scan.compiles == jcompiles == 1
    else:
        assert net._jit_tbptt_step.compiles == jnet._jit_tbptt_step.compiles == 2
    assert not [e for e in get_flight_recorder().events() if e["event"] == "retrace_storm"]


@pytest.mark.parametrize("action", ["raise", "halt"])
def test_listener_acts_on_its_threads_storm(action):
    """A storm of a watched function on the listener's thread raises
    ``TrainingHealthError("retrace")`` or sets the model's halt."""
    lst = TrainingHealthListener(action=action)
    f = monitored_jit(lambda x: x * 2, name=f"test/churn_{action}")
    for n in (3, 4, 5):
        f(torch.ones(n))

    class Model:
        halt_requested = False
    model = Model()
    if action == "raise":
        with pytest.raises(TrainingHealthError) as ei:
            lst.iteration_done(model, 0, 0.5)
        assert ei.value.kind == "retrace"
    else:
        lst.iteration_done(model, 0, 0.5)
        assert model.halt_requested and get_health().snapshot()["halted"]
    assert [k for k, _, _ in lst.triggered] == ["retrace"]


def test_foreign_old_and_ignored_storms_are_not_acted_on():
    """A storm of another fit thread is requeued, one older than the
    listener is ignored, and ``watch_retrace=False`` drains nothing."""
    old = monitored_jit(lambda x: x + 1, name="test/old_churn")
    for n in (3, 4, 5):
        old(torch.ones(n))
    bystander = TrainingHealthListener(action="raise")
    bystander.iteration_done(object(), 0, 0.5)            # the old storm: ignored
    assert not bystander.triggered

    def churn():
        f = monitored_jit(lambda x: x * 2, name="test/other_thread")
        for n in (3, 4, 5):
            f(torch.ones(n))
    t = threading.Thread(target=churn)
    t.start()
    t.join(30)
    bystander.iteration_done(object(), 1, 0.5)
    assert not bystander.triggered
    assert [s["fn"] for s in get_jit_registry().drain_storms()] == ["test/other_thread"]
    quiet = TrainingHealthListener(action="raise", watch_retrace=False)
    f = monitored_jit(lambda x: x * 3, name="test/quiet")
    for n in (3, 4, 5):
        f(torch.ones(n))
    quiet.iteration_done(object(), 0, 0.5)
    assert not quiet.triggered
    assert [s["fn"] for s in get_jit_registry().drain_storms()] == ["test/quiet"]


def test_monitor_off_records_nothing():
    f = monitored_jit(lambda x: x + 1, name="test/off")
    mon.set_enabled(False)
    try:
        assert torch.equal(f(torch.ones(3)), torch.full((3,), 2.0))
        assert (f.calls, f.compiles) == (0, 0)
    finally:
        mon.set_enabled(True)


# ------------------------------------------------------------ the report
def _record_serving(reg):
    """The same serving series in either package's registry."""
    for model in ("alpha", "beta"):
        reg.counter("serving_requests_total", "r", model=model, outcome="ok").inc(7)
        reg.counter("serving_requests_total", "r", model=model, outcome="rejected").inc(2)
        for v in (1.5, 3.0, 12.0, 40.0):
            reg.histogram("serving_request_latency_ms", "l", model=model).observe(v)
        for v in (1.0, 3.0, 4.0):
            reg.histogram("serving_batch_examples", "b", model=model).observe(v)
        reg.gauge("serving_queue_depth", "d", model=model).set(2)
        reg.gauge("serving_qps", "q", model=model).set(3.5)
        for v in (0.25, 0.5):
            reg.histogram("serving_pad_ms", "p", model=model).observe(v)
            reg.histogram("serving_transfer_ms", "x", model=model).observe(2 * v)
    reg.counter("serving_cache_hits_total", "h", model="alpha").inc(3)
    reg.counter("serving_cache_misses_total", "m", model="alpha").inc(1)


def test_serving_block_and_text_equal_jax():
    mine, theirs = preg.MetricsRegistry(), jreg.MetricsRegistry()
    _record_serving(mine)
    _record_serving(theirs)
    block = pjw._serving_block(mine.snapshot())
    assert block == jjw._serving_block(theirs.snapshot())
    assert set(block) == {"alpha", "beta"} and block["alpha"]["cache"]["hit_rate"] == 0.75
    rep = {"jit": {"mln/output": {"calls": 9, "compiles": 3, "cache_miss_ratio": 0.3333,
                                  "compile_seconds": 0.12, "persistent_cache_hits": 1,
                                  "flops": 2.5e9, "storms": 1,
                                  "last_signature_delta": "[0][0]: a -> b"}},
           "memory": {"devices": {"cuda:0": {"bytes_in_use": 5, "peak_bytes_in_use": 9,
                                             "bytes_limit": 80}}, "live_buffers": 3},
           "steps": {"iterations": 4, "examples": 64}, "serving": block,
           "locks": {}, "mesh": {"wrapper/sync": {"axes": {"data": 2}, "devices": 2,
                                                  "steps": 1}},
           "trends": {"window_s": [60.0, 300.0], "serving_qps": {"now": 1.0}}}
    assert render_profile_text(rep) == jjw.render_profile_text(rep)


def test_profile_report_blocks_and_jit_row(cost_capture):
    f = monitored_jit(lambda x: x - 1, name="test/report")
    f(torch.ones(2))
    rep = profile_report()
    assert list(rep) == ["jit", "memory", "steps", "pipeline", "training", "serving", "mesh",
                         "locks", "control", "trends"]
    assert set(rep) == set(jjw.profile_report())
    row = rep["jit"]["test/report"]
    assert set(row) >= {"calls", "compiles", "cache_miss_ratio", "compile_seconds", "variants",
                        "storms", "persistent_cache_hits", "true_compiles", "flops"}
    assert rep["control"] == {}
    assert "test/report" in render_profile_text(rep)


def test_history_readers_equal_jax():
    """The same registry contents sampled at the same times: windowed
    quantile, delta, rate, max, coverage, the series and the ring's
    description agree with the JAX package's."""
    pr, jr = preg.MetricsRegistry(), jreg.MetricsRegistry()
    ph = phist.MetricsHistory(capacity=16, interval_s=1.0, registry=pr)
    jh = jhist.MetricsHistory(capacity=16, interval_s=1.0, registry=jr)
    t = 1000.0
    for step in range(10):
        for reg in (pr, jr):
            reg.counter("jit_compiles_total", "c", fn="x").inc(step % 3)
            reg.histogram("serving_request_latency_ms", "l", model="m").observe(2.0 ** step)
            reg.gauge("device_memory_peak_bytes", "p", device="cuda:0").set(100 + 7 * step)
        ph.sample(now=t + step)
        jh.sample(now=t + step)
    now = t + 9
    for w in (3.0, 5.0, 8.0):
        assert ph.quantile_over("serving_request_latency_ms", 0.99, w, now=now) == \
            jh.quantile_over("serving_request_latency_ms", 0.99, w, now=now)
        assert ph.delta("jit_compiles_total", w, now=now) == \
            jh.delta("jit_compiles_total", w, now=now)
        assert ph.rate("jit_compiles_total", w, now=now) == \
            jh.rate("jit_compiles_total", w, now=now)
        assert ph.max_over("device_memory_peak_bytes", w, now=now) == \
            jh.max_over("device_memory_peak_bytes", w, now=now)
        assert ph.covers(w, now=now) == jh.covers(w, now=now)
    assert ph.series("serving_request_latency_ms")["points"] == \
        jh.series("serving_request_latency_ms")["points"]
    pd, jd = ph.describe(), jh.describe()
    assert {k: v for k, v in pd.items()} == {k: v for k, v in jd.items()}
