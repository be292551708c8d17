"""The LSTM's two routes, streaming and TBPTT for the recurrent family,
against the JAX package (gradient checks and model zips:
``test_torch_recurrent_checks.py``).

- ``lstm_cell.supported``: on the CPU only tanh/sigmoid LSTMs take K1/K2's
  plain versions, on the card tanh/sigmoid with H % 8 == 0.
- The kernel route: GravesBidirectionalLSTM and Bidirectional(GravesLSTM)
  at H = 128, b = 8, T = 5 with right-padded masks, JAX's Pallas kernels in
  interpret mode (``_FORCE_INTERPRET``) against the port's K1/K2 plain
  versions (reserve forward and backward both called), f32: output and
  gradients within 2e-5 of the largest entry.
- The step loop: softsign cells and hardsigmoid gates at H = 4 and 12,
  where both packages take their step loops (JAX's ``lax.scan``), masked,
  f64: output, gradients and an Adam step within 1e-10 (also both
  directions of a Bidirectional); the port's kernel wrappers are never
  called. A pair of GravesBidirectionalLSTMs, or of LSTMs the per-layer
  kernels decline, never fuses into K3/K4.
- ``rnn_time_step`` in chunks and TBPTT fits (equal segments and a ragged
  tail; ``iterations(2)``) of SimpleRnn and a step-loop GravesLSTM in both
  containers, f64 within 1e-10. A GravesBidirectionalLSTM streams each
  chunk afresh, as JAX's does; JAX's TBPTT over equal segments fails on it
  (its scan carry loses the layer's state), so its TBPTT is held on a
  ragged T only.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.ops.flash_attention as jfa
import deeplearning4j_tpu.ops.lstm_cell as jlk
from deeplearning4j_tpu import Adam as JAdam
from deeplearning4j_tpu import Sgd as JSgd
from deeplearning4j_tpu.compat import enable_x64
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet

from deeplearning4j_torch import DataSet
from deeplearning4j_torch.ops import lstm_cell

from test_torch_recurrent_family import rel, to_port, tree_errors

F64_TOL = 1e-10
KERNEL_TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _f64_batch(rng, b, t, f, c, masked=True):
    x = rng.normal(size=(b, t, f)).astype(np.float32).astype(np.float64)
    labels = np.eye(c)[rng.integers(0, c, (b, t))]
    m = None
    if masked:
        lengths = rng.integers(t // 2, t + 1, b)
        lengths[0] = t
        m = (np.arange(t)[None] < lengths[:, None]).astype(np.float64)
    return x, labels, m


# --------------------------------------------------------------- the predicate
def test_supported_predicate():
    s = lstm_cell.supported
    assert s(4, 7, 12, "tanh", "sigmoid", "cpu")
    assert s(4, 7, 12, "TANH", "Sigmoid", torch.device("cpu"))
    assert not s(4, 7, 12, "softsign", "sigmoid", "cpu")
    assert not s(4, 7, 12, "tanh", "hardsigmoid", "cpu")
    assert s(64, 200, 512, "tanh", "sigmoid", "cuda")
    assert not s(64, 200, 500, "tanh", "sigmoid", "cuda")
    assert not s(64, 200, 512, "softsign", "sigmoid", torch.device("cuda", 0))


# --------------------------------------------------------- the kernel route
@pytest.mark.parametrize("kind", ["graves_bidirectional", "bidirectional_graves"])
def test_kernel_route_against_interpret_kernels(kind, tmp_path, monkeypatch):
    H, b, t = 128, 8, 5
    layer = (jl.GravesBidirectionalLSTM(n_in=6, n_out=H, activation="tanh")
             if kind == "graves_bidirectional" else
             jl.Bidirectional(inner=jl.GravesLSTM(n_in=6, n_out=H, activation="tanh")))
    width = H if kind == "graves_bidirectional" else 2 * H
    conf = (JConf.builder().seed(11).updater(JSgd(learning_rate=0.1)).list()
            .layer(layer)
            .layer(jl.RnnOutputLayer(n_in=width, n_out=3, activation="softmax",
                                     loss="mcxent")).build())
    rng = np.random.default_rng(4)
    x = rng.normal(size=(b, t, 6)).astype(np.float32)
    labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (b, t))]
    lengths = np.array([5, 4, 3, 5, 2, 5, 1, 4])
    m = (np.arange(t)[None] < lengths[:, None]).astype(np.float32)
    jcalls, calls = [], []
    real_jscan, real_fwd, real_bwd = jlk.lstm_scan, lstm_cell.lstm_fwd_plain, lstm_cell.lstm_bwd_plain
    monkeypatch.setattr(jlk, "lstm_scan", lambda *a, **k: jcalls.append(1) or real_jscan(*a, **k))
    monkeypatch.setattr(lstm_cell, "lstm_fwd_plain",
                        lambda *a, **k: calls.append("fwd") or real_fwd(*a, **k))
    monkeypatch.setattr(lstm_cell, "lstm_bwd_plain",
                        lambda *a, **k: calls.append("bwd") or real_bwd(*a, **k))
    monkeypatch.setattr(jfa, "_FORCE_INTERPRET", True)
    jnet = JNet(conf).init()
    for p in jax.tree_util.tree_leaves(jnet.params):
        assert p.dtype == jnp.float32
    net = to_port(jnet, tmp_path)
    assert rel(net.output(x, mask=m).numpy(), jnet.output(x, mask=m)) <= KERNEL_TOL
    grads, score = net.compute_gradient_and_score(DataSet(x, labels, m, m))
    jgrads, jscore = jnet.compute_gradient_and_score(JDataSet(x, labels, m, m))
    assert rel(score, jscore) <= KERNEL_TOL
    errs = tree_errors(jgrads, grads)
    assert max(errs.values()) <= KERNEL_TOL, errs
    assert jcalls, "JAX took its scan route, not the kernels"
    assert calls.count("fwd") == 4 and calls.count("bwd") == 2   # 2 output + 2 reserve


# ------------------------------------------------------------ the step loop
def _step_loop_nets(cls, activation, gate, H, tmp_path):
    conf = (JConf.builder().seed(21).updater(JAdam(learning_rate=1e-2))
            .dtype("float64").compute_dtype("float64").list()
            .layer(getattr(jl, cls)(n_in=3, n_out=H, activation=activation,
                                    gate_activation=gate))
            .layer(jl.RnnOutputLayer(n_in=H, n_out=2, activation="softmax", loss="mcxent"))
            .build())
    jnet = JNet(conf).init()
    if cls == "GravesLSTM":
        rng = np.random.default_rng(H)
        for k in ("pi", "pf", "po"):
            jnet.params["0"][k] = jnp.asarray(0.3 * rng.standard_normal(H))
    return jnet, to_port(jnet, tmp_path)


def _no_kernel(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the step-loop route reached an LSTM kernel wrapper")
    for name in ("lstm_fwd", "lstm_bwd", "lstm_scan"):
        monkeypatch.setattr(lstm_cell, name, refuse)


@pytest.mark.parametrize("H", [4, 12])
@pytest.mark.parametrize("cls,activation,gate", [
    ("GravesLSTM", "softsign", "sigmoid"), ("GravesLSTM", "tanh", "hardsigmoid"),
    ("GravesLSTM", "softsign", "hardsigmoid"), ("LSTM", "softsign", "hardsigmoid")])
def test_step_loop_matches_scan(cls, activation, gate, H, tmp_path, monkeypatch):
    with enable_x64(True):
        jnet, net = _step_loop_nets(cls, activation, gate, H, tmp_path)
        _no_kernel(monkeypatch)
        assert not net.impls[0].kernel_route(torch.zeros(2, 3, 3))
        x, labels, m = _f64_batch(np.random.default_rng(H), 5, 7, 3, 2)
        assert rel(net.output(x, mask=m).numpy(), jnet.output(x, mask=m)) <= F64_TOL
        ds, jds = DataSet(x, labels, m, m), JDataSet(x, labels, m, m)
        grads, score = net.compute_gradient_and_score(ds)
        jgrads, jscore = jnet.compute_gradient_and_score(jds)
        assert rel(score, jscore) <= F64_TOL
        assert max(tree_errors(jgrads, grads).values()) <= F64_TOL
        net.fit(ds)
        jnet.fit(jds)
        assert max(tree_errors(jnet.params, net.params).values()) <= F64_TOL


def test_wrapped_step_loop_matches_scan(tmp_path, monkeypatch):
    """Bidirectional(GravesLSTM) with softsign cells and hardsigmoid gates,
    masked, f64: both directions on the step loop."""
    with enable_x64(True):
        conf = (JConf.builder().seed(5).updater(JAdam(learning_rate=1e-2))
                .dtype("float64").compute_dtype("float64").list()
                .layer(jl.Bidirectional(inner=jl.GravesLSTM(
                    n_in=3, n_out=6, activation="softsign", gate_activation="hardsigmoid"),
                    mode="ave"))
                .layer(jl.RnnOutputLayer(n_in=6, n_out=2, activation="softmax", loss="mcxent"))
                .build())
        jnet = JNet(conf).init()
        net = to_port(jnet, tmp_path)
        _no_kernel(monkeypatch)
        x, labels, m = _f64_batch(np.random.default_rng(6), 4, 6, 3, 2)
        assert rel(net.output(x, mask=m).numpy(), jnet.output(x, mask=m)) <= F64_TOL
        ds, jds = DataSet(x, labels, m, m), JDataSet(x, labels, m, m)
        grads, _ = net.compute_gradient_and_score(ds)
        jgrads, _ = jnet.compute_gradient_and_score(jds)
        assert max(tree_errors(jgrads, grads).values()) <= F64_TOL


def test_pair_fusion_routing(tmp_path):
    """Two GravesBidirectionalLSTM layers never fuse (K3/K4 run one
    direction), nor does a pair the per-layer kernels decline; two plain
    tanh/sigmoid GravesLSTMs do."""
    def net(layer):
        conf = (JConf.builder().seed(1).updater(JSgd(learning_rate=0.1)).list()
                .layer(layer(8)).layer(layer(8))
                .layer(jl.RnnOutputLayer(n_in=8, n_out=2, activation="softmax", loss="mcxent"))
                .build())
        for lc in conf.layers[:2]:
            lc.n_in = 8
        return to_port(JNet(conf).init(), tmp_path)
    x = torch.zeros(2, 3, 8)
    fusable = {name: net(make)._lstm_pair_fusable(0, x, None, train=True)
               for name, make in {
                   "graves": lambda n: jl.GravesLSTM(n_out=n, activation="tanh"),
                   "graves_bidi": lambda n: jl.GravesBidirectionalLSTM(n_out=n, activation="tanh"),
                   "softsign": lambda n: jl.GravesLSTM(n_out=n, activation="softsign"),
                   "hardsigmoid": lambda n: jl.LSTM(n_out=n, activation="tanh",
                                                    gate_activation="hardsigmoid")}.items()}
    assert fusable == {"graves": True, "graves_bidi": False, "softsign": False,
                       "hardsigmoid": False}


# ------------------------------------------------- streaming and truncated BPTT
def _stack_conf(builder, tbptt=None, iterations=1, graph=False, bidirectional=False):
    rnn = (jl.GravesBidirectionalLSTM(n_in=5, n_out=6, activation="tanh") if bidirectional
           else jl.GravesLSTM(n_in=5, n_out=6, activation="softsign",
                              gate_activation="hardsigmoid"))
    out = jl.RnnOutputLayer(n_in=6, n_out=3, activation="softmax", loss="mcxent")
    b = builder.iterations(iterations) if iterations > 1 else builder
    if graph:
        g = (b.graph_builder().add_inputs("in")
             .add_layer("s", jl.SimpleRnn(n_in=4, n_out=5, activation="tanh"), "in")
             .add_layer("g", rnn, "s").add_layer("out", out, "g").set_outputs("out"))
        if tbptt:
            g = g.backprop_type("tbptt").t_bptt_forward_length(tbptt).t_bptt_backward_length(tbptt)
        return g.build()
    lst = (b.list().layer(jl.SimpleRnn(n_in=4, n_out=5, activation="tanh")).layer(rnn)
           .layer(out))
    if tbptt:
        lst = lst.backprop_type("tbptt").t_bptt_forward_length(tbptt).t_bptt_backward_length(tbptt)
    return lst.build()


def _builder():
    return (JConf.builder().seed(8).updater(JAdam(learning_rate=1e-2))
            .dtype("float64").compute_dtype("float64"))


@pytest.mark.parametrize("graph", [False, True], ids=["multilayer", "graph"])
@pytest.mark.parametrize("bidirectional", [False, True], ids=["step_loop", "graves_bidi"])
def test_rnn_time_step_chunks(graph, bidirectional, tmp_path):
    with enable_x64(True):
        conf = _stack_conf(_builder(), graph=graph, bidirectional=bidirectional)
        jnet = (JGraph if graph else JNet)(conf).init()
        net = to_port(jnet, tmp_path)
        x = _f64_batch(np.random.default_rng(2), 3, 9, 4, 3, masked=False)[0]
        for chunk in (x[:, :4], x[:, 4:5], x[:, 5:]):
            assert rel(net.rnn_time_step(chunk).numpy(), jnet.rnn_time_step(chunk)) <= F64_TOL
        one = x[:, 0]
        assert rel(net.rnn_time_step(one).numpy(), jnet.rnn_time_step(one)) <= F64_TOL


@pytest.mark.parametrize("graph", [False, True], ids=["multilayer", "graph"])
@pytest.mark.parametrize("t,bidirectional", [(9, False), (8, False), (8, True)],
                         ids=["equal_segments", "ragged", "graves_bidi_ragged"])
def test_tbptt_fit(graph, t, bidirectional, tmp_path):
    with enable_x64(True):
        conf = _stack_conf(_builder(), tbptt=3, graph=graph, bidirectional=bidirectional)
        jnet = (JGraph if graph else JNet)(conf).init()
        net = to_port(jnet, tmp_path)
        x, labels, _ = _f64_batch(np.random.default_rng(t), 3, t, 4, 3, masked=False)
        net.fit(DataSet(x, labels))
        jnet.fit(JDataSet(x, labels))
        assert net.iteration_count == jnet.iteration_count == -(-t // 3)
        assert rel(float(net.score_), float(jnet.score_)) <= F64_TOL
        assert max(tree_errors(jnet.params, net.params).values()) <= F64_TOL


def test_tbptt_iterations_simple_rnn(tmp_path):
    """``tests/test_multilayer.py:308-315``: SimpleRnn under TBPTT with
    ``iterations(2)``, 2 segments x 2 updates, against JAX's fit (f32)."""
    conf = (JConf.builder().seed(4).updater(JSgd(learning_rate=0.05)).activation("tanh")
            .iterations(2).list()
            .layer(jl.SimpleRnn(n_in=3, n_out=5))
            .layer(jl.RnnOutputLayer(n_in=5, n_out=3, activation="softmax", loss="mcxent"))
            .backprop_type("tbptt").t_bptt_forward_length(4).t_bptt_backward_length(4)
            .build())
    jnet = JNet(conf).init()
    net = to_port(jnet, tmp_path)
    rng = np.random.default_rng(1)
    f = rng.normal(size=(2, 8, 3)).astype(np.float32)
    labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (2, 8))]
    net.fit(DataSet(f, labels))
    jnet.fit(JDataSet(f, labels))
    assert net.iteration_count == jnet.iteration_count == 4
    assert max(tree_errors(jnet.params, net.params).values()) <= KERNEL_TOL
