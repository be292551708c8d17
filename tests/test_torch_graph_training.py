"""ComputationGraph's training surface on the CPU, against the JAX package.

Against ``tests/test_computation_graph.py``: a two-input, two-output
MultiDataSet fit (also under ``CacheMode.DEVICE``); the convolutional
branch merge; the seq2seq duplicate vertex; the RNN -> dense ->
RnnOutputLayer preprocessor chain; truncated BPTT over a graph with even
and ragged segments, every input stream, mask and label sliced; external
errors; ``feed_forward``. Each graph is built in the JAX package and
carried to the port through its JSON and its numpy weights. The vertices
and preprocessors one by one are in ``tests/test_torch_graph_vertices.py``.

Tolerances (f32; the same arithmetic in another summation order): scores
1e-5 relative, parameters after the fits 1e-5 absolute, outputs 1e-5
absolute, gradients 1e-4 of their largest entry.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import Adam as JAdam
from deeplearning4j_tpu import Sgd as JSgd
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.conf import graph as jgraph
from deeplearning4j_tpu.nn.conf import inputs as jinputs
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph

from deeplearning4j_torch import DataSet, MultiDataSet
from deeplearning4j_torch.nn.conf import ComputationGraphConfiguration
from deeplearning4j_torch.nn.graph import ComputationGraph

SCORE_RTOL = 1e-5
PARAM_ATOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(seed, *shape):
    return _rng(seed).normal(size=shape).astype(np.float32)


def _lengths_mask(lengths, T):
    return (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)


# ----------------------------------------------------------- whole graphs
def _pair(jconf):
    """(JAX graph, port graph on the CPU), same configuration and weights."""
    jnet = JGraph(jconf).init()
    net = ComputationGraph(ComputationGraphConfiguration.from_json(jconf.to_json())).init(
        params={k: {n: np.array(v) for n, v in d.items()} for k, d in jnet.params.items()},
        device="cpu")
    return jnet, net


def _check_params(net, jnet, atol=PARAM_ATOL):
    for n, ps in jnet.params.items():
        for k, p in ps.items():
            np.testing.assert_allclose(net.params[n][k].numpy(), np.asarray(p), rtol=0,
                                       atol=atol, err_msg=f"{n}/{k}")


def _two_in_two_out(cache_mode=None):
    b = JConf.builder().seed(1).updater(JAdam(learning_rate=1e-2))
    if cache_mode is not None:
        b = b.cache_mode(cache_mode)
    return (b.graph_builder()
            .add_inputs("inA", "inB")
            .add_layer("dA", jlayers.DenseLayer(n_out=8, activation="relu"), "inA")
            .add_layer("dB", jlayers.DenseLayer(n_out=8, activation="relu"), "inB")
            .add_vertex("merged", jgraph.MergeVertex(), "dA", "dB")
            .add_layer("outA", jlayers.OutputLayer(n_out=2, activation="softmax",
                                                   loss="mcxent"), "merged")
            .add_layer("outB", jlayers.OutputLayer(n_out=1, activation="identity", loss="mse"),
                       "merged")
            .set_outputs("outA", "outB")
            .set_input_types(jinputs.InputTypeFeedForward(4), jinputs.InputTypeFeedForward(6))
            .build())


def _two_in_two_out_data():
    rng = _rng(0)
    xa = rng.normal(size=(16, 4)).astype(np.float32)
    xb = rng.normal(size=(16, 6)).astype(np.float32)
    ya = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 16)]
    yb = rng.normal(size=(16, 1)).astype(np.float32)
    return [xa, xb], [ya, yb]


@pytest.mark.parametrize("cache_mode", [None, "device"])
def test_two_inputs_two_outputs_fit_matches_jax(cache_mode):
    """A MultiDataSet through two inputs and two output layers: scores and
    parameters after 10 epochs are the JAX package's; under
    ``CacheMode.DEVICE`` the set's tensors are made once and reused."""
    jnet, net = _pair(_two_in_two_out(cache_mode))
    xs, ys = _two_in_two_out_data()
    mds, jmds = MultiDataSet(xs, ys), JMultiDataSet(xs, ys)
    s0 = net.score(mds)
    assert s0 == pytest.approx(float(jnet.score(jmds)), rel=SCORE_RTOL)
    net.fit(mds, epochs=10)
    jnet.fit(jmds, epochs=10)
    assert net.iteration_count == jnet.iteration_count == 10
    assert net.score(mds) < s0
    assert net.score(mds) == pytest.approx(float(jnet.score(jmds)), rel=SCORE_RTOL)
    _check_params(net, jnet)
    if cache_mode == "device":
        first = mds.device_arrays(net.device)
        assert all(a is b for a, b in zip(first[0], mds.device_arrays(net.device)[0]))
    outs = net.output(*xs)
    assert [tuple(o.shape) for o in outs] == [(16, 2), (16, 1)]
    grads, score = net.compute_gradient_and_score(mds)
    jgrads, jscore = jnet.compute_gradient_and_score(jmds)
    assert score == pytest.approx(jscore, rel=SCORE_RTOL)
    for n, gs in jgrads.items():
        for k, g in gs.items():
            g = np.asarray(g)
            assert np.abs(grads[n][k].numpy() - g).max() <= GRAD_RTOL * np.abs(g).max(), (n, k)


def test_conv_branch_merge_matches_jax():
    conf = (JConf.builder().seed(5).updater(JAdam(learning_rate=1e-3))
            .graph_builder()
            .add_inputs("in")
            .add_layer("c3", jlayers.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                                      convolution_mode="same",
                                                      activation="relu"), "in")
            .add_layer("c5", jlayers.ConvolutionLayer(n_out=4, kernel_size=(5, 5),
                                                      convolution_mode="same",
                                                      activation="relu"), "in")
            .add_vertex("cat", jgraph.MergeVertex(), "c3", "c5")
            .add_layer("pool", jlayers.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)),
                       "cat")
            .add_layer("out", jlayers.OutputLayer(n_out=2, activation="softmax",
                                                  loss="mcxent"), "pool")
            .set_outputs("out")
            .set_input_types(jinputs.InputTypeConvolutional(8, 8, 1))
            .build())
    jnet, net = _pair(conf)
    assert net.conf.vertices["out"].n_in == 8 * 4 * 4
    x = _normal(30, 2, 1, 8, 8)
    y = np.eye(2, dtype=np.float32)[[0, 1]]
    net.fit(DataSet(x, y))
    jnet.fit(JDataSet(x, y))
    assert net.score(DataSet(x, y)) == pytest.approx(float(jnet.score(JDataSet(x, y))),
                                                     rel=SCORE_RTOL)
    _check_params(net, jnet)


def _seq2seq():
    return (JConf.builder().seed(3).updater(JAdam(learning_rate=1e-2))
            .graph_builder()
            .add_inputs("in")
            .add_layer("enc", jlayers.LSTM(n_out=8, activation="tanh"), "in")
            .add_vertex("last", jgraph.LastTimeStepVertex(mask_input="in"), "enc")
            .add_vertex("dup", jgraph.DuplicateToTimeSeriesVertex(reference_input="in"), "last")
            .add_layer("dec", jlayers.LSTM(n_out=8, activation="tanh"), "dup")
            .add_layer("out", jlayers.RnnOutputLayer(n_out=3, activation="softmax",
                                                     loss="mcxent"), "dec")
            .set_outputs("out")
            .set_input_types(jinputs.InputTypeRecurrent(4))
            .build())


def test_seq2seq_duplicate_vertex_matches_jax():
    """Encoder's last unmasked step, duplicated over the input's length
    into a decoder: output (with and without a mask), a masked fit's
    score and parameters."""
    jnet, net = _pair(_seq2seq())
    x = _normal(31, 2, 5, 4)
    m = _lengths_mask([5, 3], 5)
    out = net.output(x)
    assert tuple(out.shape) == (2, 5, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(jnet.output(x)), rtol=0, atol=1e-5)
    np.testing.assert_allclose(net.output(x, masks=[m]).numpy(),
                               np.asarray(jnet.output(x, masks=[m])), rtol=0, atol=1e-5)
    y = np.eye(3, dtype=np.float32)[_rng(32).integers(0, 3, (2, 5))]
    for _ in range(3):
        net.fit(DataSet(x, y, m, m))
        jnet.fit(JDataSet(x, y, m, m))
    assert net.score() == pytest.approx(float(jnet.score()), rel=SCORE_RTOL)
    _check_params(net, jnet)


def test_last_timestep_classifier_trains_like_jax():
    conf = (JConf.builder().seed(3).updater(JAdam(learning_rate=1e-2))
            .graph_builder()
            .add_inputs("in")
            .add_layer("lstm", jlayers.LSTM(n_out=8, activation="tanh"), "in")
            .add_vertex("last", jgraph.LastTimeStepVertex(mask_input="in"), "lstm")
            .add_layer("out", jlayers.OutputLayer(n_out=2, activation="softmax",
                                                  loss="mcxent"), "last")
            .set_outputs("out")
            .set_input_types(jinputs.InputTypeRecurrent(5))
            .build())
    jnet, net = _pair(conf)
    x = _normal(33, 6, 7, 5)
    y = np.eye(2, dtype=np.float32)[_rng(34).integers(0, 2, 6)]
    m = _lengths_mask([7, 3, 5, 7, 1, 6], 7)
    ds, jds = DataSet(x, y, m), JDataSet(x, y, m)
    s0 = net.score(ds)
    net.fit(ds, epochs=10)
    jnet.fit(jds, epochs=10)
    assert net.score(ds) < s0
    assert net.score(ds) == pytest.approx(float(jnet.score(jds)), rel=SCORE_RTOL)
    _check_params(net, jnet)
    assert tuple(net.output(x).shape) == (6, 2)


def test_rnn_dense_rnnoutput_preprocessor_ctx():
    """LSTM -> dense (RnnToFeedForward) -> RnnOutputLayer
    (FeedForwardToRnn by the ctx the first left): the port inserts the
    JAX package's preprocessors and trains as it does."""
    conf = (JConf.builder().seed(2).updater(JAdam(learning_rate=1e-2))
            .graph_builder()
            .add_inputs("in")
            .add_layer("lstm", jlayers.LSTM(n_out=6, activation="tanh"), "in")
            .add_layer("d", jlayers.DenseLayer(n_out=4, activation="relu"), "lstm")
            .add_layer("out", jlayers.RnnOutputLayer(n_out=2, activation="softmax",
                                                     loss="mcxent"), "d")
            .set_outputs("out")
            .set_input_types(jinputs.InputTypeRecurrent(3))
            .build())
    jnet, net = _pair(conf)
    assert {k: type(v).__name__ for k, v in net.conf.input_preprocessors.items()} == \
        {"d": "RnnToFeedForwardPreProcessor", "out": "FeedForwardToRnnPreProcessor"}
    x = _normal(35, 4, 5, 3)
    y = np.zeros((4, 5, 2), np.float32)
    y[..., 0] = 1.0
    net.fit(DataSet(x, y))
    jnet.fit(JDataSet(x, y))
    assert net.score(DataSet(x, y)) == pytest.approx(float(jnet.score(JDataSet(x, y))),
                                                     rel=SCORE_RTOL)
    _check_params(net, jnet)
    out = net.output(x)
    assert tuple(out.shape) == (4, 5, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(jnet.output(x)), rtol=0, atol=1e-5)


def _tbptt_graph(L):
    """Two sequence inputs (one through an LSTM, one through the duplicate
    of a dense summary of the first's last step) merged into an LSTM and a
    per-step output, and a second output on the last step: every stream
    TBPTT slices."""
    conf = (JConf.builder().seed(3).updater(JAdam(learning_rate=1e-2))
            .graph_builder()
            .add_inputs("seq", "side")
            .add_layer("enc", jlayers.GravesLSTM(n_in=5, n_out=8, activation="tanh"), "seq")
            .add_vertex("last", jgraph.LastTimeStepVertex(mask_input="seq"), "enc")
            .add_vertex("dup", jgraph.DuplicateToTimeSeriesVertex(reference_input="side"),
                        "last")
            .add_vertex("cat", jgraph.MergeVertex(), "enc", "dup", "side")
            .add_layer("dec", jlayers.LSTM(n_in=19, n_out=6, activation="tanh"), "cat")
            .add_layer("out", jlayers.RnnOutputLayer(n_in=6, n_out=3, activation="softmax",
                                                     loss="mcxent"), "dec")
            .add_layer("cls", jlayers.OutputLayer(n_in=8, n_out=2, activation="softmax",
                                                  loss="mcxent"), "last")
            .set_outputs("out", "cls")
            .build())
    conf.backprop_type = "tbptt"
    conf.tbptt_fwd_length = conf.tbptt_back_length = L
    return conf


@pytest.mark.parametrize("T", [12, 10], ids=["even", "ragged"])
def test_tbptt_over_a_graph_matches_jax(T):
    """Truncated BPTT with segments of 4 (T=12: three equal segments,
    which JAX runs as one scan; T=10: a ragged last segment): one update a
    segment, the LSTM carries by vertex name, both inputs, the features
    masks and the per-step labels sliced, the whole-sequence labels
    whole. Scores and parameters are the JAX package's."""
    jnet, net = _pair(_tbptt_graph(4))
    assert net.conf.backprop_type == jnet.conf.backprop_type == "tbptt"
    rng = _rng(40)
    xs = [rng.normal(size=(3, T, 5)).astype(np.float32),
          rng.normal(size=(3, T, 3)).astype(np.float32)]
    ys = [np.eye(3, dtype=np.float32)[rng.integers(0, 3, (3, T))],
          np.eye(2, dtype=np.float32)[rng.integers(0, 2, 3)]]
    m = _lengths_mask([T, T - 3, T - 5], T)
    mds, jmds = MultiDataSet(xs, ys, [m, m]), JMultiDataSet(xs, ys, [m, m])
    for _ in range(2):
        net.fit(mds)
        jnet.fit(jmds)
    assert net.iteration_count == jnet.iteration_count == 2 * -(-T // 4)
    assert net.score() == pytest.approx(float(jnet.score()), rel=SCORE_RTOL)
    _check_params(net, jnet)


def test_cg_tbptt_and_rnn_time_step():
    """Chunking and streaming parity on the graph container: 12 steps in
    chunks of 4 are 3 iterations, and stepping token by token gives the
    full-sequence output."""
    conf = (JConf.builder().seed(3).updater(JSgd(learning_rate=0.05))
            .graph_builder()
            .add_inputs("in")
            .add_layer("lstm", jlayers.LSTM(n_in=5, n_out=8, activation="tanh"), "in")
            .add_layer("out", jlayers.RnnOutputLayer(n_in=8, n_out=3, activation="softmax",
                                                     loss="mcxent"), "lstm")
            .set_outputs("out")
            .build())
    conf.backprop_type = "tbptt"
    conf.tbptt_fwd_length = 4
    jnet, net = _pair(conf)
    rng = _rng(0)
    f = rng.normal(size=(2, 12, 5)).astype(np.float32)
    l = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (2, 12))]
    net.fit(DataSet(f, l))
    jnet.fit(JDataSet(f, l))
    assert net.iteration_count == 3
    assert net.score() == pytest.approx(float(jnet.score()), rel=SCORE_RTOL)
    full = net.output(f).numpy()
    net.rnn_clear_previous_state()
    stepped = np.stack([net.rnn_time_step(f[:, t, :]).numpy() for t in range(12)], axis=1)
    np.testing.assert_allclose(stepped, full, rtol=1e-4, atol=1e-5)


def test_external_epsilon_step_matches_jax():
    """``fit_external_errors``: with SGD the update is lr x (x^T eps); with
    Adam on a two-layer graph the parameters follow the JAX package's."""
    conf = (JConf.builder().seed(9).updater(JSgd(learning_rate=0.5))
            .graph_builder()
            .add_inputs("in")
            .add_layer("d", jlayers.DenseLayer(n_out=4, activation="identity"), "in")
            .set_outputs("d")
            .set_input_types(jinputs.InputTypeFeedForward(3))
            .build())
    jnet, net = _pair(conf)
    before = net.params["d"]["W"].clone().numpy()
    x = _normal(50, 5, 3)
    eps = np.ones((5, 4), np.float32)
    net.fit_external_errors(x, eps)
    assert net.iteration_count == 1
    np.testing.assert_allclose(net.params["d"]["W"].numpy(), before - 0.5 * (x.T @ eps),
                               rtol=1e-5, atol=1e-6)

    conf = (JConf.builder().seed(9).updater(JAdam(learning_rate=1e-2))
            .graph_builder()
            .add_inputs("a", "b")
            .add_layer("h", jlayers.DenseLayer(n_out=6, activation="tanh"), "a", "b")
            .add_layer("y1", jlayers.DenseLayer(n_out=2, activation="identity"), "h")
            .add_vertex("y2", jgraph.L2NormalizeVertex(), "h")
            .set_outputs("y1", "y2")
            .set_input_types(jinputs.InputTypeFeedForward(3), jinputs.InputTypeFeedForward(2))
            .build())
    jnet, net = _pair(conf)
    xs = [_normal(51, 5, 3), _normal(52, 5, 2)]
    eps = [_normal(53, 5, 2), _normal(54, 5, 6)]
    for _ in range(2):
        net.fit_external_errors(xs, eps)
        jnet.fit_external_errors(xs, eps)
    _check_params(net, jnet)


def test_feed_forward_matches_jax():
    """Every vertex's activation by name, the inputs' included, in
    inference and in training mode."""
    jnet, net = _pair(_seq2seq())
    x = _normal(60, 2, 5, 4)
    for train in (False, True):
        acts = net.feed_forward(x, train=train)
        jacts = jnet.feed_forward(x, train=train)
        assert set(acts) == set(jacts) == {"in", "enc", "last", "dup", "dec", "out"}
        for k, a in jacts.items():
            np.testing.assert_allclose(acts[k].numpy(), np.asarray(a), rtol=0, atol=1e-5,
                                       err_msg=k)
    assert net.feedForward == net.feed_forward
