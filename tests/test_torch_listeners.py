"""The listener bus, the stock listeners and the health halt, against the
JAX package.

Held: the hooks both containers fire (``on_epoch_start``, one
``iteration_done`` a minibatch, once a batch under truncated BPTT with the
last segment's loss, ``on_epoch_end``) in the JAX package's order, with
its iteration numbers and its scores (f32, 1e-5 relative); the stock
listeners of ``tests/test_solvers.py:78-200`` (ParamAndGradient's rows
against JAX's, CheckpointListener's rotation, exact resume and adoption of
an existing directory) and ``tests/test_monitor.py::TestHealthListener``
case for case; the health halt in both containers, with and without
TBPTT, on an iterator whose second batch is NaN; the error seam; no
host read of the loss in a fit without listeners; and the listener-bus
contract over every module of the port (``tests/test_listener_contract.py``).
"""
import importlib
import inspect
import logging
import os
import pkgutil
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import Sgd as JSgd
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import ListDataSetIterator as JListIterator
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.conf import inputs as jinputs
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.optimize import listeners as jlisteners

import deeplearning4j_torch
from deeplearning4j_torch import Adam, DataSet, ListDataSetIterator, NeuralNetConfiguration, Sgd
from deeplearning4j_torch.monitor.health import (HealthState, TrainingHealthError,
                                                 TrainingHealthListener, get_health)
from deeplearning4j_torch.nn.conf import ComputationGraphConfiguration, MultiLayerConfiguration
from deeplearning4j_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_torch.nn.graph import ComputationGraph
from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_torch.optimize import listeners as plisteners

SCORE_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_health():
    get_health().reset()
    yield
    get_health().reset()


def _net(seed=1, lr=0.1):
    conf = (NeuralNetConfiguration.builder().seed(seed).updater(Sgd(learning_rate=lr))
            .activation("tanh").list()
            .layer(DenseLayer(n_in=4, n_out=8))
            .layer(OutputLayer(n_in=8, n_out=3, activation="softmax", loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf).init(device="cpu")


def _ds(seed=0, n=16):
    rng = np.random.default_rng(seed)
    return DataSet(rng.normal(size=(n, 4)).astype(np.float32),
                   np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)])


# ----------------------------------------------------- the bus against JAX
def _jconf(kind):
    """A feed-forward or a recurrent (TBPTT 4) net, as a MultiLayerNetwork
    or a graph."""
    b = JConf.builder().seed(4).updater(JSgd(learning_rate=0.1)).activation("tanh")
    recurrent = kind.endswith("tbptt")
    if kind.startswith("mln"):
        lb = b.list()
        if recurrent:
            lb = (lb.layer(jlayers.LSTM(n_in=3, n_out=6))
                  .layer(jlayers.RnnOutputLayer(n_in=6, n_out=3, activation="softmax",
                                                loss="mcxent"))
                  .backprop_type("tbptt").t_bptt_forward_length(4)
                  .t_bptt_backward_length(4))
        else:
            lb = (lb.layer(jlayers.DenseLayer(n_in=3, n_out=6))
                  .layer(jlayers.OutputLayer(n_in=6, n_out=3, activation="softmax",
                                             loss="mcxent")))
        return lb.build()
    gb = b.graph_builder().add_inputs("in")
    if recurrent:
        gb = (gb.add_layer("h", jlayers.LSTM(n_out=6), "in")
              .add_layer("out", jlayers.RnnOutputLayer(n_out=3, activation="softmax",
                                                       loss="mcxent"), "h")
              .set_input_types(jinputs.InputType.recurrent(3))
              .backprop_type("tbptt").t_bptt_forward_length(4).t_bptt_backward_length(4))
    else:
        gb = (gb.add_layer("h", jlayers.DenseLayer(n_out=6), "in")
              .add_layer("out", jlayers.OutputLayer(n_out=3, activation="softmax",
                                                    loss="mcxent"), "h")
              .set_input_types(jinputs.InputTypeFeedForward(3)))
    return gb.set_outputs("out").build()


def _pair(kind):
    jconf = _jconf(kind)
    if kind.startswith("mln"):
        jnet, cls, ccls = JNet(jconf).init(), MultiLayerNetwork, MultiLayerConfiguration
    else:
        jnet, cls, ccls = JGraph(jconf).init(), ComputationGraph, ComputationGraphConfiguration
    net = cls(ccls.from_json(jconf.to_json())).init(
        params={k: {n: np.array(v) for n, v in d.items()} for k, d in jnet.params.items()},
        device="cpu")
    return jnet, net


def _batches(kind, n=3, nan_at=None):
    rng = np.random.default_rng(7)
    out = []
    for i in range(n):
        shape = (4, 8, 3) if kind.endswith("tbptt") else (4, 3)
        f = rng.normal(size=shape).astype(np.float32)
        if i == nan_at:
            f[0] = np.nan
        l = np.eye(3, dtype=np.float32)[rng.integers(0, 3, shape[:-1])]
        out.append((f, l))
    return out


class _Recorder:
    """Every hook call, as the JAX and the port listener both see it."""

    def __init__(self):
        self.events = []

    def iteration_done(self, model, iteration, score):
        self.events.append(("iteration", iteration, score))

    def on_epoch_start(self, model, epoch):
        self.events.append(("start", epoch))

    def on_epoch_end(self, model, epoch):
        self.events.append(("end", epoch))


class _PortRecorder(_Recorder, plisteners.TrainingListener):
    pass


class _JaxRecorder(_Recorder, jlisteners.TrainingListener):
    pass


KINDS = ["mln", "graph", "mln_tbptt", "graph_tbptt"]


@pytest.mark.parametrize("kind", KINDS)
def test_hooks_fire_as_in_jax(kind):
    """Two epochs of three minibatches: the epoch hooks around each epoch,
    ``iteration_done`` once a minibatch (once a batch of two TBPTT
    segments, at the second segment's iteration), the iteration numbers
    and scores of the JAX package."""
    jnet, net = _pair(kind)
    rec, jrec = _PortRecorder(), _JaxRecorder()
    net.set_listeners(rec)
    jnet.set_listeners(jrec)
    data = _batches(kind)
    net.fit(ListDataSetIterator([DataSet(f, l) for f, l in data]), epochs=2)
    jnet.fit(JListIterator([JDataSet(f, l) for f, l in data]), epochs=2)
    assert [e[:2] for e in rec.events] == [e[:2] for e in jrec.events]
    per_batch = 2 if kind.endswith("tbptt") else 1
    assert [e[1] for e in rec.events if e[0] == "iteration"] == \
        [per_batch * (i + 1) - 1 for i in range(6)]
    assert [e[0] for e in rec.events] == ["start"] + ["iteration"] * 3 + ["end", "start"] \
        + ["iteration"] * 3 + ["end"]
    for e, je in zip(rec.events, jrec.events):
        if e[0] == "iteration":
            assert e[2] == pytest.approx(je[2], rel=SCORE_RTOL)
    assert net.last_batch_size == 4 and get_health().snapshot()["last_iteration"] == 6 * \
        per_batch - 1


def test_stock_listeners_like_jax(caplog):
    """Score, CollectScores, Performance, Time and Sleepy listeners on one
    fit: the collected scores are JAX's; the score and ETA lines are
    logged; the performance listener measures samples and batches a
    second."""
    jnet, net = _pair("mln")
    collect, jcollect = (plisteners.CollectScoresIterationListener(2),
                         jlisteners.CollectScoresIterationListener(2))
    perf = plisteners.PerformanceListener(frequency=2, report_score=True)
    net.set_listeners(collect, plisteners.ScoreIterationListener(2), perf,
                      plisteners.TimeIterationListener(6, frequency=2),
                      plisteners.SleepyTrainingListener(1))
    jnet.set_listeners(jcollect)
    data = _batches("mln", n=6)
    with caplog.at_level(logging.INFO, logger=plisteners.__name__):
        net.fit(ListDataSetIterator([DataSet(f, l) for f, l in data]))
    jnet.fit(JListIterator([JDataSet(f, l) for f, l in data]))
    assert [i for i, _ in collect.scores] == [i for i, _ in jcollect.scores] == [0, 2, 4]
    np.testing.assert_allclose([s for _, s in collect.scores],
                               [s for _, s in jcollect.scores], rtol=SCORE_RTOL)
    text = caplog.text
    assert "Score at iteration 4" in text and "ETA" in text and "samples/sec" in text
    assert perf.last_samples_per_sec > 0 and perf.last_batches_per_sec > 0


def test_param_and_gradient_iteration_listener(tmp_path):
    """Per-iteration parameter and update statistics, collected and written
    tab-delimited (``test_solvers.py``), equal to the JAX listener's rows
    on the same net and data."""
    jnet, net = _pair("mln")
    path = os.path.join(str(tmp_path), "stats.tsv")
    lst = plisteners.ParamAndGradientIterationListener(output_to_console=False,
                                                       file_path=path)
    jlst = jlisteners.ParamAndGradientIterationListener(output_to_console=False)
    net.set_listeners(lst)
    jnet.set_listeners(jlst)
    f, l = _batches("mln", n=1)[0]
    for _ in range(3):
        net.fit(DataSet(f, l))
        jnet.fit(JDataSet(f, l))
    assert len(lst.rows) == 3 and abs(lst.rows[1][-1]) > 0    # updateMeanAbsValue
    np.testing.assert_allclose(np.array(lst.rows), np.array(jlst.rows), rtol=1e-4, atol=1e-7)
    lines = open(path).read().strip().splitlines()
    assert lines[0].startswith("iteration\tscore\tparamMean") and len(lines) == 4


def _adam_net(seed, n_in=6, n_out=3):
    conf = (NeuralNetConfiguration.builder().seed(seed).updater(Adam(learning_rate=1e-2))
            .activation("tanh").list()
            .layer(DenseLayer(n_in=n_in, n_out=12))
            .layer(OutputLayer(n_in=12, n_out=n_out, activation="softmax", loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf).init(device="cpu")


def test_checkpoint_listener_rotation_and_exact_resume(tmp_path):
    """Saves every 2 iterations keeping the last 2; the newest checkpoint
    restores a model (parameters and Adam state) that continues training
    exactly as the uninterrupted run."""
    rng = np.random.default_rng(19)
    ds = DataSet(rng.normal(size=(16, 6)).astype(np.float32),
                 np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)])
    ckdir = str(tmp_path / "ckpts")
    net = _adam_net(17)
    net.set_listeners(plisteners.CheckpointListener(ckdir, save_every_n_iterations=2,
                                                    save_every_n_epochs=0, keep_last=2))
    for _ in range(8):
        net.fit(ds)
    files = plisteners.CheckpointListener.checkpoints(ckdir)
    assert len(files) == 2 and files[-1].endswith("iter-8.zip")
    assert not any(p.endswith(".tmp") for p in os.listdir(ckdir))
    resumed = plisteners.CheckpointListener.last_checkpoint(ckdir, device="cpu")
    for _ in range(2):
        resumed.fit(ds)
    reference = _adam_net(17)
    for _ in range(10):
        reference.fit(ds)
    for k, ps in reference.params.items():
        for n, p in ps.items():
            np.testing.assert_allclose(resumed.params[k][n].numpy(), p.numpy(), rtol=1e-6,
                                       atol=1e-7)


def test_checkpoint_listener_adopts_existing_directory(tmp_path):
    """A new listener on a directory with earlier checkpoints continues the
    file index and rotates the old files out."""
    rng = np.random.default_rng(29)
    ds = DataSet(rng.normal(size=(8, 4)).astype(np.float32),
                 np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)])
    d = str(tmp_path / "ck")
    net = _adam_net(23, n_in=4, n_out=2)
    net.set_listeners(plisteners.CheckpointListener(d, save_every_n_iterations=1,
                                                    save_every_n_epochs=0, keep_last=2))
    for _ in range(3):
        net.fit(ds)
    resumed = plisteners.CheckpointListener.last_checkpoint(d, device="cpu")
    resumed.set_listeners(plisteners.CheckpointListener(d, save_every_n_iterations=1,
                                                        save_every_n_epochs=0, keep_last=2))
    resumed.fit(ds)
    files = [os.path.basename(p) for p in plisteners.CheckpointListener.checkpoints(d)]
    assert files[-1].startswith("checkpoint-00004-") and len(files) == 2
    assert plisteners.CheckpointListener.last_checkpoint(d, device="cpu").iteration_count == 4


# ------------------------------------------------- tests/test_monitor.py
class TestHealthListener:
    def test_nan_trigger_warn_records(self):
        lst = TrainingHealthListener(action="warn")
        net = _net()
        lst.iteration_done(net, 0, 0.5)
        lst.iteration_done(net, 1, float("nan"))
        assert [t[0] for t in lst.triggered] == ["nan"]
        assert get_health().snapshot()["nan"]

    def test_divergence_trigger_and_raise_action(self):
        lst = TrainingHealthListener(action="raise", divergence_window=3,
                                     divergence_factor=2.0)
        net = _net()
        for i, s in enumerate((1.0, 1.1, 1.05)):
            lst.iteration_done(net, i, s)
        with pytest.raises(TrainingHealthError, match="exceeds"):
            lst.iteration_done(net, 3, 5.0)

    def test_stall_trigger(self):
        lst = TrainingHealthListener(action="warn", stall_timeout=0.01)
        net = _net()
        lst.iteration_done(net, 0, 1.0)
        time.sleep(0.05)
        lst.iteration_done(net, 1, 1.0)
        assert [t[0] for t in lst.triggered] == ["stall"]

    def test_param_nan_scan(self):
        lst = TrainingHealthListener(action="warn", check_params_every=1)
        net = _net()
        with torch.no_grad():
            net.params["0"]["W"][0, 0] = float("inf")
        lst.iteration_done(net, 0, 0.5)
        assert [t[0] for t in lst.triggered] == ["nan"]

    def test_halt_action_stops_fit(self):
        class HaltNow(TrainingHealthListener):
            def iteration_done(self, model, iteration, score):
                self._fire(model, "nan", iteration, "injected halt")

        net = _net()
        net.set_listeners(HaltNow(action="halt"))
        net.fit(_ds(), epochs=5)          # halts after the first minibatch
        assert net.iteration_count == 1
        assert get_health().snapshot()["halted"]
        # a fresh fit supersedes the halt
        net.set_listeners()
        net.fit(_ds(), epochs=2)
        assert net.iteration_count == 3 and not net.halt_requested
        assert get_health().snapshot()["halted"] is None

    def test_bad_action_rejected(self):
        with pytest.raises(ValueError, match="action"):
            TrainingHealthListener(action="explode")


@pytest.mark.parametrize("kind", KINDS)
def test_health_halt_on_a_nan_batch(kind):
    """``TrainingHealthListener(action="halt")`` over an iterator whose
    second minibatch holds a NaN: both packages stop after that minibatch
    (two iterations, or four TBPTT segments), close the epoch and skip the
    rest; the next fit runs whole."""
    jnet, net = _pair(kind)
    rec, jrec = _PortRecorder(), _JaxRecorder()
    net.set_listeners(TrainingHealthListener(action="halt"), rec)
    jnet.set_listeners(jlisteners_health(), jrec)
    data = _batches(kind, n=3, nan_at=1)
    net.fit(ListDataSetIterator([DataSet(f, l) for f, l in data]), epochs=3)
    jnet.fit(JListIterator([JDataSet(f, l) for f, l in data]), epochs=3)
    assert net.halt_requested and net.iteration_count == jnet.iteration_count
    assert [e[:2] for e in rec.events] == [e[:2] for e in jrec.events]
    assert [e[0] for e in rec.events] == ["start", "iteration", "iteration", "end"]
    snap = get_health().snapshot()
    assert snap["halted"] and snap["nan"] and not snap["healthy"]
    net.set_listeners()
    net.fit(ListDataSetIterator([DataSet(f, l) for f, l in data[2:]]))
    assert not net.halt_requested and get_health().snapshot()["halted"] is None


def jlisteners_health():
    from deeplearning4j_tpu.monitor.health import TrainingHealthListener as JHealth
    return JHealth(action="halt")


def test_training_error_seam():
    """An exception out of ``fit`` reaches every listener's
    ``on_training_error`` before it leaves, a hook that fails is skipped,
    and the exception itself propagates."""
    seen = []

    class Boom(plisteners.TrainingListener):
        def iteration_done(self, model, iteration, score):
            raise RuntimeError("boom")

    class BadHook(plisteners.TrainingListener):
        def on_training_error(self, model, exception):
            raise ValueError("cleanup failed")

    class Cleanup(plisteners.TrainingListener):
        def on_training_error(self, model, exception):
            seen.append((model, str(exception)))

    for net in (_net(), _pair("graph")[1]):
        seen.clear()
        net.set_listeners(Boom(), BadHook(), Cleanup())
        f, l = (_ds().features, _ds().labels) if isinstance(net, MultiLayerNetwork) \
            else _batches("graph", n=1)[0]
        with pytest.raises(RuntimeError, match="boom"):
            net.fit(DataSet(f, l))
        assert seen == [(net, "boom")]


def test_no_host_read_of_the_loss_without_listeners(monkeypatch):
    """With the monitor switched off (``monitor.set_enabled(False)``), a fit
    with no listener never reads a tensor's value on the host (on the card
    that would be a device-to-host sync a minibatch); with one it reads the
    score once a minibatch. With the monitor on, the default, as in the
    JAX package, a bare fit reads it once a minibatch too."""
    from deeplearning4j_torch import monitor
    reads = []
    for name in ("__float__", "item"):
        real = getattr(torch.Tensor, name)

        def spy(self, *a, _real=real, **k):
            reads.append(1)
            return _real(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, spy)
    for kind in ("mln", "graph_tbptt"):
        _, net = _pair(kind)
        data = ListDataSetIterator([DataSet(f, l) for f, l in _batches(kind)])
        reads.clear()
        monitor.set_enabled(False)
        try:
            net.fit(data)
            assert reads == [], kind
            net.set_listeners(plisteners.CollectScoresIterationListener())
            net.fit(data)
            assert len(reads) == 3, kind
        finally:
            monitor.set_enabled(True)
        net.set_listeners()
        reads.clear()
        net.fit(data)
        assert len(reads) == 3, kind


def test_evaluative_listener_raises_only_when_it_fires():
    """EvaluativeListener runs only when it fires (every ``frequency``
    iterations, iteration 0 excepted) and then evaluates, as in the JAX
    package: before its first firing it has no evaluation, and an error in
    ``evaluate`` (here a bad iterator) surfaces only when it fires; once
    given data its evaluation is the container's ``evaluate``."""
    bad = plisteners.EvaluativeListener(iterator=None, frequency=2)
    net = _net()
    net.set_listeners(bad)
    net.fit(_ds())                      # iteration 0: does not fire
    net.fit(_ds())                      # iteration 1: does not fire
    assert bad.last_evaluation is None
    with pytest.raises(TypeError):
        net.fit(_ds())                  # iteration 2 fires on None
    val = ListDataSetIterator([_ds(7)])
    lst = plisteners.EvaluativeListener(iterator=val, frequency=2)
    net = _net()
    net.set_listeners(lst)
    for _ in range(3):
        net.fit(_ds())
    want = net.evaluate(val)
    assert lst.last_evaluation.total == want.total == 16
    np.testing.assert_array_equal(lst.last_evaluation.confusion.matrix,
                                  want.confusion.matrix)


def test_health_state_core():
    """The snapshot: the last iteration and score, the NaN latch, the halt,
    the newest eight problems; ``reset`` clears all of it."""
    h = HealthState()
    assert h.snapshot()["healthy"] and h.snapshot()["last_iteration_age_s"] is None
    h.record_iteration(5, 0.4)
    snap = h.snapshot()
    assert (snap["last_iteration"], snap["last_score"], snap["status"]) == (5, 0.4, "ok")
    h.record_iteration(6, float("inf"))
    assert h.snapshot()["nan"] and not h.snapshot()["healthy"]
    for i in range(10):
        h.record_problem("stall", f"p{i}")
    assert h.snapshot()["problems"] == [f"stall: p{i}" for i in range(2, 10)]
    h.record_halt("why")
    assert h.snapshot()["halted"] == "why"
    h.clear_halt()
    assert h.snapshot()["halted"] is None
    h.reset()
    assert h.snapshot()["healthy"] and h.snapshot()["last_iteration"] is None


# ----------------------------------------------- tests/test_listener_contract
def test_listener_subclasses_only_override_known_hooks():
    """Every TrainingListener subclass in the port overrides only hook
    names of the base class, with their signatures."""
    skipped = []
    for info in pkgutil.walk_packages(deeplearning4j_torch.__path__,
                                      deeplearning4j_torch.__name__ + "."):
        try:
            importlib.import_module(info.name)
        except Exception as e:
            skipped.append((info.name, repr(e)))
    hooks = {name: inspect.signature(fn)
             for name, fn in vars(plisteners.TrainingListener).items()
             if not name.startswith("_") and callable(fn)}
    assert {"iteration_done", "on_epoch_start", "on_epoch_end",
            "on_training_error"} <= set(hooks)

    def subclasses(cls):
        out = set()
        for sub in cls.__subclasses__():
            out |= {sub} | subclasses(sub)
        return out

    found = {c for c in subclasses(plisteners.TrainingListener)
             if c.__module__.startswith("deeplearning4j_torch")}
    names = {c.__name__ for c in found}
    assert {"ScoreIterationListener", "PerformanceListener", "CheckpointListener",
            "TrainingHealthListener", "EvaluativeListener"} <= names, (names, skipped)
    problems = []
    for cls in found:
        for name, member in vars(cls).items():
            if name.startswith("_") or not inspect.isfunction(member):
                continue
            if name in hooks:
                if list(inspect.signature(member).parameters) != list(hooks[name].parameters):
                    problems.append(f"{cls.__qualname__}.{name}")
            elif name.startswith("on_") or name == "iterationDone":
                problems.append(f"{cls.__qualname__}.{name} is no hook of the bus")
    assert not problems and not skipped, (problems, skipped)
