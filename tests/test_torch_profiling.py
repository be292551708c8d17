"""The port's ``utils/profiling.py``: JAX's four tests of
``tests/test_profiling.py`` on the port (``device="cpu"``), then the
port's own pins: ``step_cost``'s FLOPs equal the analytic GEMM count of a
Dense net's forward and backward (JAX's XLA figure, which also counts the
updater and elementwise work, is printed beside it, not asserted), it
leaves the parameters, layer state, updater state and training stream as
they were, and ``ProfilerListener`` writes and closes its trace when
``fit`` raises inside its window."""
import json
import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import DataSet as JDataSet
from deeplearning4j_tpu import MultiLayerNetwork as JNet
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu import Sgd as JSgd
from deeplearning4j_tpu.nn.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.utils import profiling as jprof

from deeplearning4j_torch import (Adam, ComputationGraph, DataSet, MultiDataSet,
                                  MultiLayerNetwork, NeuralNetConfiguration, Sgd)
from deeplearning4j_torch.nn.conf.layers import BatchNormalization, DenseLayer, OutputLayer
from deeplearning4j_torch.optimize.listeners import TrainingListener
from deeplearning4j_torch.utils import profiling
from deeplearning4j_torch.utils.profiling import (ProfilerListener, StepTimerListener,
                                                  step_cost, trace)

B, N_IN, H, N_OUT = 16, 4, 8, 3


def _conf(builder, updater, remat="off"):
    return (builder.seed(1).updater(updater).activation("tanh").remat(remat)
            .list()
            .layer(DenseLayer(n_in=N_IN, n_out=H))
            .layer(OutputLayer(n_in=H, n_out=N_OUT, activation="softmax", loss="mcxent"))
            .build())


def _net_and_ds(updater=None, remat="off"):
    net = MultiLayerNetwork(_conf(NeuralNetConfiguration.builder(),
                                  updater or Sgd(learning_rate=0.1), remat)).init(device="cpu")
    rng = np.random.default_rng(0)
    ds = DataSet(rng.normal(size=(B, N_IN)).astype(np.float32),
                 np.eye(N_OUT, dtype=np.float32)[rng.integers(0, N_OUT, B)])
    return net, ds


def _gemm_flops(fwd_recomputed=False):
    """2·m·n·k a product: the forward's two, the backward's weight
    gradients of both layers and the input gradient of the second (the
    first layer's input needs none); remat runs the forward once more."""
    fwd = 2 * B * N_IN * H + 2 * B * H * N_OUT
    bwd = 2 * B * N_IN * H + 2 * B * H * N_OUT + 2 * B * H * N_OUT
    return fwd * (2 if fwd_recomputed else 1) + bwd


# ------------------------------------------------- JAX's four, on the port
def test_step_timer_listener_collects_times():
    net, ds = _net_and_ds()
    timer = StepTimerListener()
    net.set_listeners(timer)
    for _ in range(6):
        net.fit(ds)
    s = timer.summary()
    assert s["n"] >= 4 and s["mean_ms"] > 0 and s["p95_ms"] >= s["p50_ms"]


def test_step_cost_reports_flops_and_bytes():
    net, ds = _net_and_ds()
    c = step_cost(net, ds)
    assert c["flops"] > 0 and c["bytes_accessed"] > 0
    assert c["gflop_per_example"] > 0 and c["batch"] == 16
    assert set(c) == {"flops", "bytes_accessed", "batch", "gflop_per_example",
                      "mb_per_example", "raw"}


def test_profiler_listener_writes_trace(tmp_path):
    net, ds = _net_and_ds()
    prof = ProfilerListener(str(tmp_path), start_iteration=1, num_iterations=2)
    net.set_listeners(prof)
    for _ in range(6):
        net.fit(ds)
    assert prof.done
    found = [f for _, _, files in os.walk(tmp_path) for f in files]
    assert found, "no trace files written"
    with open(prof.path) as fh:
        assert json.load(fh)["traceEvents"]


def test_trace_context_manager(tmp_path):
    with trace(str(tmp_path), device="cpu"):
        torch.ones((8, 8)).sum()
    assert any(files for _, _, files in os.walk(tmp_path))


# ------------------------------------------------------------ the port's
def test_trace_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default does not raise")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with trace(str(tmp_path)):
            pass


@pytest.mark.parametrize("remat", ["off", "on"])
def test_step_cost_flops_are_the_gemm_count(remat):
    net, ds = _net_and_ds(remat=remat)
    c = step_cost(net, ds)
    assert c["flops"] == _gemm_flops(fwd_recomputed=remat == "on")
    assert c["raw"] == {"aten.mm": c["flops"]}
    jconf = (JConf.builder().seed(1).updater(JSgd(learning_rate=0.1)).activation("tanh")
             .list().layer(JDense(n_in=N_IN, n_out=H))
             .layer(JOut(n_in=H, n_out=N_OUT, activation="softmax", loss="mcxent")).build())
    jc = jprof.step_cost(JNet(jconf).init(), JDataSet(ds.features, ds.labels))
    print(f"step_cost flops: port {c['flops']:.0f} (remat {remat}), JAX's XLA step "
          f"{jc['flops']:.0f} (updater and elementwise work included); bytes: port "
          f"{c['bytes_accessed']:.0f}, JAX {jc['bytes_accessed']:.0f}")


def test_step_cost_leaves_the_net_as_it_was():
    net, ds = _net_and_ds(updater=Adam(learning_rate=1e-2))
    net.fit(ds)
    net.fit(ds)
    before = (net.params_flat().clone(), [t.clone() for _, t in _leaves(net.updater_state)],
              net._gen.get_state().clone(), net.iteration_count, float(net.score_))
    step_cost(net, ds)
    after = (net.params_flat(), [t for _, t in _leaves(net.updater_state)], net._gen.get_state(),
             net.iteration_count, float(net.score_))
    assert torch.equal(before[0], after[0])
    assert len(before[1]) == len(after[1]) > 0
    assert all(torch.equal(a, b) for a, b in zip(before[1], after[1]))
    assert torch.equal(before[2], after[2])
    assert before[3:] == after[3:]
    assert all(p.grad is None for p in net.parameters())


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _leaves(t, f"{prefix}/{i}")
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree


def test_step_cost_of_a_graph_keeps_its_state_and_memoises():
    conf = (NeuralNetConfiguration.builder().seed(2).updater(Sgd(learning_rate=0.1))
            .graph_builder().add_inputs("x")
            .add_layer("d", DenseLayer(n_in=N_IN, n_out=H, activation="relu"), "x")
            .add_layer("bn", BatchNormalization(n_in=H, n_out=H), "d")
            .add_layer("out", OutputLayer(n_in=H, n_out=N_OUT, activation="softmax",
                                          loss="mcxent"), "bn")
            .set_outputs("out").build())
    net = ComputationGraph(conf).init(device="cpu")
    rng = np.random.default_rng(3)
    mds = MultiDataSet([rng.normal(size=(B, N_IN)).astype(np.float32)],
                       [np.eye(N_OUT, dtype=np.float32)[rng.integers(0, N_OUT, B)]])
    states = {k: t.clone() for k, t in net.states["bn"].items()}
    c = step_cost(net, mds)
    assert c["flops"] == _gemm_flops() and c["batch"] == B
    assert all(torch.equal(states[k], t) for k, t in net.states["bn"].items())
    assert step_cost(net, mds) == c
    assert len(getattr(net, profiling._STEP_COST_ATTR)) == 1


def test_profiler_listener_closes_its_trace_when_fit_raises(tmp_path):
    class Boom(TrainingListener):
        def iteration_done(self, model, iteration, score):
            if iteration == 2:
                raise RuntimeError("boom")

    net, ds = _net_and_ds()
    prof = ProfilerListener(str(tmp_path), start_iteration=1, num_iterations=5)
    net.set_listeners(prof, Boom())
    with pytest.raises(RuntimeError, match="boom"):
        for _ in range(6):
            net.fit(ds)
    assert prof.done and prof._prof is None
    assert os.path.exists(prof.path)
    # a new window can start after the one that closed
    with trace(str(tmp_path / "after"), device="cpu"):
        torch.ones(2).sum()


def test_param_server_listener_waits_for_the_parameter_server():
    with pytest.raises(AttributeError, match="A 15"):
        profiling.ParamServerMetricsListener
    assert "ParamServerMetricsListener" not in profiling.__all__
