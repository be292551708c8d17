"""Full-batch solvers and the gradient check, against the JAX package.

Held: the Armijo line search; line gradient descent, conjugate gradient
and LBFGS on the same float64 net and data as the JAX package's (under
x64), their loss at every evaluation, line-search probes included, and
the parameters after 30 iterations (the same host logic and the same
f64 arithmetic in another summation order: losses 1e-10 relative,
parameters 1e-9 absolute; in f32 the paths part after some iterations,
as a 1e-7 difference in a gradient grows through LBFGS's history);
``Solver``'s dispatch on the
configuration's ``optimization_algo`` (SGD runs ``fit``; an unknown name
raises); LBFGS against as many SGD steps (``tests/test_solvers.py``); and
the gradient check (``tests/test_gradientcheck.py``'s dense, CNN,
BatchNormalization and LSTM cases, and its f32 refusal, in float64 on the
CPU), which passes a net with dropout (the check draws nothing), fails a
layer whose backward is wrong, and checks a graph.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import Sgd as JSgd
from deeplearning4j_tpu.compat import enable_x64
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.optimize import solvers as jsolvers

from deeplearning4j_torch import DataSet, NeuralNetConfiguration, Sgd
from deeplearning4j_torch.nn.conf import InputType, MultiLayerConfiguration, OptimizationAlgorithm
from deeplearning4j_torch.nn.conf.dropout import DropConnect, Dropout
from deeplearning4j_torch.nn.conf.layers import (LSTM, BatchNormalization, ConvolutionLayer,
                                                 DenseLayer, OutputLayer, PoolingType,
                                                 RnnOutputLayer, SubsamplingLayer)
from deeplearning4j_torch.nn.gradientcheck import (GradientCheckUtil,
                                                   check_function_gradients)
from deeplearning4j_torch.nn.graph import ComputationGraph
from deeplearning4j_torch.nn.layers import feedforward
from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_torch.optimize.solvers import BackTrackLineSearch, BaseOptimizer, Solver

LOSS_RTOL = 1e-5
F64_LOSS_RTOL = 1e-10
F64_PARAM_ATOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _jconf(algo, dtype="float32"):
    return (JConf.builder().seed(5).updater(JSgd(learning_rate=0.1)).activation("tanh")
            .dtype(dtype).compute_dtype(dtype).optimization_algo(algo).list()
            .layer(jlayers.DenseLayer(n_in=4, n_out=8))
            .layer(jlayers.OutputLayer(n_in=8, n_out=3, activation="softmax", loss="mcxent"))
            .build())


def _pair(algo, dtype="float32"):
    jnet = JNet(_jconf(algo, dtype)).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(jnet.conf.to_json())).init(
        params={k: {n: np.array(v) for n, v in d.items()} for k, d in jnet.params.items()},
        device="cpu")
    return jnet, net


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(32, 4)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)])


def _record(monkeypatch, cls, attr, log):
    real = getattr(cls, attr)

    def rec(self, x):
        out = real(self, x)
        log.append(out if attr == "f" else out[0])
        return out
    monkeypatch.setattr(cls, attr, rec)


def test_backtrack_line_search_armijo():
    f = lambda x: float((x ** 2).sum())     # noqa: E731
    x = np.array([2.0, -3.0])
    g = 2 * x
    step, fnew = BackTrackLineSearch().search(f, x, f(x), g, -g)
    assert step > 0 and fnew < f(x)
    assert BackTrackLineSearch().search(f, x, f(x), g, g) == (0.0, f(x))   # ascent


@pytest.mark.parametrize("algo", [OptimizationAlgorithm.LBFGS,
                                  OptimizationAlgorithm.CONJUGATE_GRADIENT,
                                  OptimizationAlgorithm.LINE_GRADIENT_DESCENT])
def test_solver_iterates_match_jax(monkeypatch, algo):
    """``Solver`` runs the configured algorithm for 30 iterations: every
    loss it evaluates (line-search probes included) is JAX's, the
    parameters after are JAX's, and the loss falls by 10% at least
    (``test_full_batch_optimizers_reduce_loss``)."""
    f, l = _data()
    ds, jds = DataSet(f, l), JDataSet(f, l)
    losses, jlosses = [], []
    for attr in ("f", "f_g"):
        _record(monkeypatch, BaseOptimizer, attr, losses)
        _record(monkeypatch, jsolvers.BaseOptimizer, attr, jlosses)
    with enable_x64(True):
        jnet, net = _pair(algo, "float64")
        s0 = net.score(ds, training=True)
        assert Solver.builder().model(net).max_iterations(30).build().optimize(ds)
        assert jsolvers.Solver.builder().model(jnet).max_iterations(30).build().optimize(jds)
        jparams = {k: {n: np.asarray(p) for n, p in ps.items()}
                   for k, ps in jnet.params.items()}
    assert len(losses) == len(jlosses) > 30
    np.testing.assert_allclose(losses, jlosses, rtol=F64_LOSS_RTOL)
    s1 = net.score(ds, training=True)
    assert s1 < 0.9 * s0 and net.score() == pytest.approx(s1, rel=1e-12)
    for k, ps in jparams.items():
        for n, p in ps.items():
            np.testing.assert_allclose(net.params[k][n].numpy(), p, rtol=0,
                                       atol=F64_PARAM_ATOL, err_msg=f"{k}/{n}")


def test_lbfgs_beats_few_sgd_steps():
    """Full-batch LBFGS reaches a lower loss than 30 SGD steps."""
    f, l = _data(3)
    ds = DataSet(f, l)
    _, sgd_net = _pair(OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT)
    for _ in range(30):
        sgd_net.fit(ds)
    _, lbfgs_net = _pair(OptimizationAlgorithm.LBFGS)
    Solver.builder().model(lbfgs_net).max_iterations(30).build().optimize(ds)
    assert lbfgs_net.score(ds, training=True) < sgd_net.score(ds, training=True)


def test_solver_sgd_dispatch_and_unknown_algorithm():
    """SGD is one ``fit`` of the network (one update); an unknown name
    raises."""
    jnet, net = _pair(OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT)
    f, l = _data()
    s0 = net.score(DataSet(f, l))
    Solver.builder().model(net).build().optimize(DataSet(f, l))
    jsolvers.Solver.builder().model(jnet).build().optimize(JDataSet(f, l))
    assert net.iteration_count == 1 and net.score(DataSet(f, l)) < s0
    assert net.score(DataSet(f, l)) == pytest.approx(jnet.score(JDataSet(f, l)), rel=LOSS_RTOL)
    net.gc.optimization_algo = "newton"
    with pytest.raises(ValueError, match="newton"):
        Solver(net).optimize(DataSet(f, l))


def test_lbfgs_on_a_graph():
    """A ComputationGraph through the same solver: the loss falls and
    ``score_`` is the solver's last loss."""
    conf = (NeuralNetConfiguration.builder().seed(2).activation("tanh")
            .optimization_algo("lbfgs").graph_builder().add_inputs("in")
            .add_layer("h", DenseLayer(n_out=8), "in")
            .add_layer("out", OutputLayer(n_out=3, activation="softmax", loss="mcxent"), "h")
            .set_outputs("out").set_input_types(InputType.feed_forward(4)).build())
    net = ComputationGraph(conf).init(device="cpu")
    ds = DataSet(*_data(1))
    s0 = net.score(ds, training=True)
    Solver.builder().model(net).max_iterations(20).build().optimize(ds)
    assert net.score(ds, training=True) < 0.9 * s0
    assert net.score() == pytest.approx(net.score(ds, training=True), rel=1e-6)


# ------------------------------------------------------------ gradient check
def _f64_builder():
    return (NeuralNetConfiguration.builder().seed(12345).updater(Sgd(learning_rate=1.0))
            .dtype("float64").compute_dtype("float64"))


def _onehot(rng, n, c):
    return np.eye(c)[rng.integers(0, c, n)]


def _dense_net(**layer0):
    conf = (_f64_builder().activation("tanh").l2(0.01).list()
            .layer(DenseLayer(n_in=4, n_out=5, **layer0))
            .layer(OutputLayer(n_in=5, n_out=3, activation="softmax", loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf).init(device="cpu")


def _gc_ds(rng, shape, n_out):
    n = shape[0]
    return DataSet(rng.normal(size=shape).astype(np.float32), _onehot(rng, n, n_out))


def test_dense_gradients():
    ds = _gc_ds(np.random.default_rng(0), (6, 4), 3)
    assert GradientCheckUtil.check_gradients(_dense_net(), ds, print_results=True)


def test_cnn_gradients():
    conf = (_f64_builder().activation("tanh").list()
            .layer(ConvolutionLayer(n_out=3, kernel_size=(2, 2), stride=(1, 1)))
            .layer(SubsamplingLayer(pooling_type=PoolingType.MAX, kernel_size=(2, 2),
                                    stride=(2, 2)))
            .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.convolutional(6, 6, 1)).build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    ds = _gc_ds(np.random.default_rng(1), (4, 1, 6, 6), 2)
    assert GradientCheckUtil.check_gradients(net, ds, max_per_param=20, print_results=True)


def test_batchnorm_gradients():
    conf = (_f64_builder().activation("tanh").list()
            .layer(DenseLayer(n_in=4, n_out=6))
            .layer(BatchNormalization(n_in=6, n_out=6))
            .layer(OutputLayer(n_in=6, n_out=3, activation="softmax", loss="mcxent"))
            .build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    ds = _gc_ds(np.random.default_rng(2), (8, 4), 3)
    assert GradientCheckUtil.check_gradients(net, ds, max_per_param=20, print_results=True)


def test_lstm_gradients():
    conf = (_f64_builder().list()
            .layer(LSTM(n_in=3, n_out=4, activation="tanh"))
            .layer(RnnOutputLayer(n_in=4, n_out=2, activation="softmax", loss="mcxent"))
            .build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    rng = np.random.default_rng(3)
    f = rng.normal(size=(3, 4, 3)).astype(np.float32)
    ds = DataSet(f, np.stack([_onehot(rng, 4, 2) for _ in range(3)]))
    assert GradientCheckUtil.check_gradients(net, ds, max_per_param=15, print_results=True)


def test_f32_net_rejected():
    conf = (NeuralNetConfiguration.builder().updater(Sgd(learning_rate=1.0)).list()
            .layer(DenseLayer(n_in=4, n_out=5, activation="tanh"))
            .layer(OutputLayer(n_in=5, n_out=3, activation="softmax", loss="mcxent"))
            .build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    with pytest.raises(ValueError, match="float64"):
        GradientCheckUtil.check_gradients(net, _gc_ds(np.random.default_rng(0), (6, 4), 3))


def test_gradient_check_draws_no_dropout_and_catches_a_wrong_backward(monkeypatch):
    """With dropout and DropConnect configured the check passes (its loss
    draws nothing, as the reference requires); with a dense forward whose
    backward is wrong it fails; ``exit_on_first_error`` raises."""
    ds = _gc_ds(np.random.default_rng(4), (6, 4), 3)
    net = _dense_net(dropout=Dropout(0.5), weight_noise=DropConnect(0.5))
    assert GradientCheckUtil.check_gradients(net, ds)

    class _HalfGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, z):
            return z.clone()

        @staticmethod
        def backward(ctx, g):
            return 0.5 * g

    real = feedforward.DenseImpl.preout
    monkeypatch.setattr(feedforward.DenseImpl, "preout",
                        lambda self, x: _HalfGrad.apply(real(self, x)))
    assert not GradientCheckUtil.check_gradients(_dense_net(), ds, max_per_param=3)
    with pytest.raises(AssertionError, match="FAILED"):
        GradientCheckUtil.check_gradients(_dense_net(), ds, exit_on_first_error=True)


def test_function_gradients_and_a_graph():
    """``check_function_gradients`` on a loss of a dict tree (an
    ``expect_zero`` leaf must have an exactly zero gradient), and the
    container check on a ComputationGraph."""
    rng = np.random.default_rng(6)
    params = {"a": {"w": torch.from_numpy(rng.normal(size=(3, 2)))},
              "frozen": torch.from_numpy(rng.normal(size=(2,)))}
    x = torch.from_numpy(rng.normal(size=(5, 3)))

    def loss(p):
        return torch.tanh(x @ p["a"]["w"]).pow(2).sum() + 0.0 * p["frozen"].sum()
    assert check_function_gradients(loss, params, expect_zero={"frozen"})
    assert not check_function_gradients(lambda p: loss(p) + p["frozen"].sum(), params,
                                        expect_zero={"frozen"})
    conf = (_f64_builder().activation("tanh").graph_builder().add_inputs("in")
            .add_layer("h", DenseLayer(n_out=5), "in")
            .add_layer("out", OutputLayer(n_out=3, activation="softmax", loss="mcxent"), "h")
            .set_outputs("out").set_input_types(InputType.feed_forward(4)).build())
    net = ComputationGraph(conf).init(device="cpu")
    assert GradientCheckUtil.check_gradients(net, _gc_ds(rng, (6, 4), 3), print_results=True)
