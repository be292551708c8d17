"""Both containers' evaluation and parameter surface against the JAX
package, the weights moved through the model zip.

Held, on the CPU: ``evaluate`` (confusion counts exactly, metrics within
1e-12) and ``evaluate_regression`` (1e-12) of the char-RNN in float64,
unmasked, with a labels mask and with a features mask only; a small
two-output ComputationGraph's ``evaluate`` on each output, from DataSets
and MultiDataSets; SimpleCNN at 3x32x32 (``tests/test_zoo.py:40``'s
shape) in f32 after a fit step, BatchNormalization's running statistics
included; ``feed_forward``/``feed_forward_to_layer`` (1e-12 in f64);
``params_flat`` against JAX's (same order, same values), the
``set_params_flat`` round trip (each parameter's dtype and device kept);
``clone``; ``summary``, ``param_table``, ``get_param`` and ``n_layers``.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import Adam as JAdam
from deeplearning4j_tpu.compat import enable_x64
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import ListDataSetIterator as JList
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.models.zoo import SimpleCNN as JSimpleCNN
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.utils.model_serializer import ModelSerializer as JSerializer

from deeplearning4j_torch import DataSet, ListDataSetIterator, MultiDataSet
from deeplearning4j_torch.models import ModelSelector, SimpleCNN
from deeplearning4j_torch.utils.model_serializer import restore_model

METRIC_ATOL = 1e-12
F64_ATOL = 1e-12
VOCAB, H, T = 6, 8, 7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _restored(jnet, tmp_path, name="m.zip"):
    path = str(tmp_path / name)
    JSerializer.write_model(jnet, path)
    return restore_model(path, device="cpu")


def _same_evaluation(ev, jev):
    np.testing.assert_array_equal(ev.confusion.matrix, jev.confusion.matrix)
    assert ev.total == jev.total
    for name in ("accuracy", "precision", "recall", "f1"):
        assert abs(getattr(ev, name)() - getattr(jev, name)()) <= METRIC_ATOL, name
    assert ev.stats() == jev.stats()


# ------------------------------------------------------------------- char-RNN
def _char_rnn_conf(dtype="float64"):
    return (JConf.builder().seed(3).updater(JAdam(learning_rate=1e-2)).activation("tanh")
            .dtype(dtype).compute_dtype(dtype).list()
            .layer(jlayers.GravesLSTM(n_in=VOCAB, n_out=H))
            .layer(jlayers.GravesLSTM(n_in=H, n_out=H))
            .layer(jlayers.RnnOutputLayer(n_in=H, n_out=VOCAB, activation="softmax",
                                          loss="mcxent"))
            .build())


def _series(seed, b=5):
    rng = np.random.default_rng(seed)
    f = np.eye(VOCAB, dtype=np.float32)[rng.integers(0, VOCAB, (b, T))]
    l = np.eye(VOCAB, dtype=np.float32)[rng.integers(0, VOCAB, (b, T))]
    lengths = rng.integers(2, T + 1, b)
    m = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    return f, l, m


@pytest.mark.parametrize("masks", ["none", "labels", "features"])
def test_char_rnn_evaluate_matches_jax(tmp_path, masks):
    """Three batches through ``evaluate``: the output stays a tensor, the
    labels mask (else the features mask) picks the steps; the counts are
    JAX's. ``evaluate_regression`` passes no mask in either package."""
    with enable_x64(True):
        jnet = JNet(_char_rnn_conf()).init()
        net = _restored(jnet, tmp_path)
        data = []
        for s in range(3):
            f, l, m = _series(s)
            fm = m if masks == "features" else None
            lm = m if masks == "labels" else None
            data.append((f, l, fm, lm))
        ev = net.evaluate(ListDataSetIterator([DataSet(*d) for d in data]))
        jev = jnet.evaluate(JList([JDataSet(*d) for d in data]))
        reg = net.evaluate_regression(ListDataSetIterator([DataSet(*d) for d in data]))
        jreg = jnet.evaluate_regression(JList([JDataSet(*d) for d in data]))
    _same_evaluation(ev, jev)
    assert ev.total == (15 * T if masks == "none" else int(sum(d[2 if masks == "features"
                                                                 else 3].sum() for d in data)))
    for name in ("mean_squared_error", "mean_absolute_error", "correlation_r2"):
        assert abs(getattr(reg, name)() - getattr(jreg, name)()) <= METRIC_ATOL
    assert reg.n == jreg.n == 15 * T


def test_feed_forward_and_parameter_surface_match_jax(tmp_path):
    """feed_forward (every activation), feed_forward_to_layer, params_flat
    in the JAX package's order (a layer's parameters in init order),
    param_table keys and values, get_param, n_layers and summary."""
    with enable_x64(True):
        jnet = JNet(_char_rnn_conf()).init()
        net = _restored(jnet, tmp_path)
        f, _, _ = _series(4)
        jacts = [np.asarray(a) for a in jnet.feed_forward(f)]
        jmid = np.asarray(jnet.feed_forward_to_layer(1, f))
        jflat = jnet.params_flat()
        jtable = {k: np.asarray(v) for k, v in jnet.param_table().items()}
        jsummary = jnet.summary()
    acts = net.feed_forward(f)
    assert len(acts) == len(jacts) == 4
    for a, ja in zip(acts, jacts):
        np.testing.assert_allclose(a.numpy(), ja, rtol=0, atol=F64_ATOL)
    np.testing.assert_allclose(net.feed_forward_to_layer(1, f).numpy(), jmid, rtol=0,
                               atol=F64_ATOL)
    flat = net.params_flat()
    assert flat.dtype == torch.float64 and flat.device.type == "cpu"
    np.testing.assert_array_equal(flat.numpy(), jflat)
    table = net.param_table()
    assert list(table) == list(jtable)
    for k, v in jtable.items():
        np.testing.assert_array_equal(table[k].numpy(), v)
        np.testing.assert_array_equal(net.get_param(k).numpy(), v)
    assert net.n_layers == jnet.n_layers == 3
    assert net.summary() == jsummary


def test_set_params_flat_round_trip_keeps_dtype_and_device(tmp_path):
    """``set_params_flat`` writes a vector in ``params_flat``'s order into
    the parameters in place (the same nn.Parameters, their dtype kept),
    as JAX's does; a wrong length raises."""
    jnet = JNet(_char_rnn_conf("float32")).init()
    net = _restored(jnet, tmp_path)
    f, _, _ = _series(5)
    before = {k: p for k, p in net.impls[0].param_dict().items()}
    v = net.params_flat()
    new = (v.double() * 0.5 + 0.01)          # an f64 vector into f32 parameters
    net.set_params_flat(new.numpy())
    jnet.set_params_flat(new.numpy())
    assert all(net.impls[0].param_dict()[k] is p for k, p in before.items())
    assert all(p.dtype == torch.float32 for ps in net.params.values() for p in ps.values())
    np.testing.assert_array_equal(net.params_flat().numpy(), new.float().numpy())
    np.testing.assert_allclose(net.output(f).numpy(), np.asarray(jnet.output(f)),
                               rtol=1e-5, atol=1e-6)
    net.set_params_flat(v)
    np.testing.assert_array_equal(net.params_flat().numpy(), v.numpy())
    with pytest.raises(ValueError, match="Param vector length"):
        net.set_params_flat(np.zeros(3))


def test_clone_is_an_independent_copy(tmp_path):
    """``clone``: same outputs, parameters, layer state and updater state
    (after a fit, so Adam's moments are nonzero), none of them shared, on
    the same device; counters start afresh, as in the JAX package."""
    jnet = JNet(_char_rnn_conf("float32")).init()
    net = _restored(jnet, tmp_path)
    f, l, _ = _series(6)
    net.fit(DataSet(f, l))
    twin = net.clone()
    assert twin.device == net.device and twin.iteration_count == 0
    np.testing.assert_array_equal(twin.output(f).numpy(), net.output(f).numpy())
    np.testing.assert_array_equal(twin.params_flat().numpy(), net.params_flat().numpy())
    for k, st in net.updater_state.items():
        for n, s in st.items():
            for a, b in zip(torch.utils._pytree.tree_leaves(s),
                            torch.utils._pytree.tree_leaves(twin.updater_state[k][n])):
                if isinstance(a, torch.Tensor):
                    assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    mine, theirs = net.params_flat().clone(), twin.params_flat().clone()
    twin.fit(DataSet(f, l))
    assert torch.equal(net.params_flat(), mine)
    assert not torch.equal(twin.params_flat(), theirs)
    net.fit(DataSet(f, l))
    assert not torch.equal(net.params_flat(), mine)


# ---------------------------------------------------------------------- graph
def _jgraph_conf():
    return (JConf.builder().seed(4).updater(JAdam(learning_rate=1e-2)).activation("tanh")
            .dtype("float64").compute_dtype("float64").graph_builder()
            .add_inputs("in")
            .add_layer("d0", jlayers.DenseLayer(n_in=5, n_out=7), "in")
            .add_layer("d1", jlayers.DenseLayer(n_in=7, n_out=6), "d0")
            .add_layer("out0", jlayers.OutputLayer(n_in=6, n_out=4, activation="softmax",
                                                   loss="mcxent"), "d1")
            .add_layer("out1", jlayers.OutputLayer(n_in=7, n_out=3, activation="softmax",
                                                   loss="mcxent"), "d0")
            .set_outputs("out0", "out1")
            .build())


@pytest.mark.parametrize("output_idx", [0, 1])
def test_graph_evaluate_and_surface_match_jax(tmp_path, output_idx):
    """``ComputationGraph.evaluate(iterator, output_idx)`` over MultiDataSets
    (two outputs) against JAX's; ``param_table`` (topological order) and
    ``summary`` as JAX's."""
    rng = np.random.default_rng(output_idx)
    with enable_x64(True):
        jnet = JGraph(_jgraph_conf()).init()
        net = _restored(jnet, tmp_path)
        sets = []
        for _ in range(3):
            f = rng.normal(size=(9, 5)).astype(np.float32)
            l0 = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 9)]
            l1 = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 9)]
            sets.append(([f], [l0, l1]))
        ev = net.evaluate(ListDataSetIterator([MultiDataSet(*s) for s in sets]), output_idx)
        jev = jnet.evaluate(JList([JMultiDataSet(*s) for s in sets]), output_idx)
        jtable = {k: np.asarray(v) for k, v in jnet.param_table().items()}
        jsummary = jnet.summary()
    _same_evaluation(ev, jev)
    assert ev.num_classes == (4, 3)[output_idx]
    table = net.param_table()
    assert list(table) == list(jtable)
    for k, v in jtable.items():
        np.testing.assert_array_equal(table[k].numpy(), v)
    assert net.summary() == jsummary


def test_graph_evaluate_takes_datasets_with_masks(tmp_path):
    """A one-input, one-output graph evaluates plain DataSets; a features
    mask stands in for the labels mask, as in the JAX package."""
    conf = (JConf.builder().seed(2).activation("tanh").dtype("float64")
            .compute_dtype("float64").graph_builder()
            .add_inputs("in")
            .add_layer("lstm", jlayers.GravesLSTM(n_in=VOCAB, n_out=H), "in")
            .add_layer("out", jlayers.RnnOutputLayer(n_in=H, n_out=VOCAB, activation="softmax",
                                                     loss="mcxent"), "lstm")
            .set_outputs("out")
            .build())
    with enable_x64(True):
        jnet = JGraph(conf).init()
        net = _restored(jnet, tmp_path)
        f, l, m = _series(9)
        ev = net.evaluate(ListDataSetIterator([DataSet(f, l, m)]))
        jev = jnet.evaluate(JList([JDataSet(f, l, m)]))
    _same_evaluation(ev, jev)
    assert ev.total == int(m.sum())


# ------------------------------------------------------------------ SimpleCNN
def test_simplecnn_matches_jax_and_trains(tmp_path):
    """SimpleCNN at 3x32x32, 5 classes (``tests/test_zoo.py:40``): the
    port's configuration is the JAX package's; a JAX-trained net (one fit
    step, so BN's running statistics moved) restored in the port evaluates
    to JAX's counts; ``ModelSelector.select("simplecnn")`` builds, fits
    (DropoutLayer drawing) and evaluates, its rows summing to 1."""
    rng = np.random.default_rng(0)
    f = rng.normal(size=(16, 3, 32, 32)).astype(np.float32)
    l = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 16)]
    jm = JSimpleCNN(num_classes=5, input_shape=(3, 32, 32))
    assert SimpleCNN(num_classes=5, input_shape=(3, 32, 32)).conf().to_json() == \
        jm.conf().to_json()
    jnet = jm.init()
    jnet.fit(JDataSet(f[:8], l[:8]))
    net = _restored(jnet, tmp_path)
    ev = net.evaluate(ListDataSetIterator([DataSet(f, l)], batch_size=8))
    jev = jnet.evaluate(JList([JDataSet(f, l)], batch_size=8))
    _same_evaluation(ev, jev)
    own = ModelSelector.select("simplecnn", num_classes=5, input_shape=(3, 32, 32)) \
        .init(device="cpu")
    assert own.num_params() == jnet.num_params()
    own.fit(DataSet(f, l))
    assert np.isfinite(float(own.score_))
    np.testing.assert_allclose(own.output(f).sum(-1).numpy(), 1.0, rtol=1e-4)
    assert own.evaluate(ListDataSetIterator([DataSet(f, l)])).total == 16


# ---------------------------------------------------------------- the exports
def test_top_level_exports_and_weight_distributions(tmp_path):
    """``deeplearning4j_torch`` exports every name of the JAX package's top
    level (a script switches packages by its import line), each the same
    kind of thing; ``WeightInit`` and
    the Distribution classes write the JAX package's configuration.json
    data, and a JAX configuration with a distribution initialises in the
    port from it."""
    import json
    import deeplearning4j_tpu as jax_pkg
    import deeplearning4j_torch as port
    from deeplearning4j_tpu.nn import weights as jweights
    from deeplearning4j_torch.nn import weights as pweights
    from deeplearning4j_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_torch.nn.conf.layers import DenseLayer, OutputLayer

    names = {n for n in dir(jax_pkg) if not n.startswith("_") and n[0].isupper()}
    missing = names - set(port.__all__)
    assert missing == set()
    assert all(hasattr(port, n) for n in port.__all__)
    assert port.__version__ == jax_pkg.__version__
    for n in names - missing:
        assert isinstance(getattr(port, n), type) == isinstance(getattr(jax_pkg, n), type), n
    assert {k: v for k, v in vars(port.WeightInit).items() if k.isupper()} == \
        {k: v for k, v in vars(jax_pkg.WeightInit).items() if k.isupper()}
    # (class, arguments, the distribution's mean and standard deviation)
    for name, args, mu, sd in [("NormalDistribution", (0.5, 0.1), 0.5, 0.1),
                               ("GaussianDistribution", (0.0, 2.0), 0.0, 2.0),
                               ("UniformDistribution", (-0.3, 0.3), 0.0, 0.6 / 12 ** 0.5),
                               ("ConstantDistribution", (0.25,), 0.25, 0.0),
                               ("BinomialDistribution", (3, 0.4), 1.2, (3 * 0.4 * 0.6) ** 0.5)]:
        jconf = (JConf.builder().seed(1).dist(getattr(jweights, name)(*args)).list()
                 .layer(jlayers.DenseLayer(n_in=30, n_out=40))
                 .layer(jlayers.OutputLayer(n_in=40, n_out=2)).build())
        pconf = (port.NeuralNetConfiguration.builder().seed(1)
                 .dist(getattr(pweights, name)(*args)).list()
                 .layer(DenseLayer(n_in=30, n_out=40)).layer(OutputLayer(n_in=40, n_out=2))
                 .build())
        assert json.loads(pconf.to_json())["global_conf"]["dist"] == \
            json.loads(jconf.to_json())["global_conf"]["dist"], name
        for conf in (pconf, MultiLayerConfiguration.from_json(jconf.to_json())):
            w = port.MultiLayerNetwork(conf).init(device="cpu").params["0"]["W"].double()
            # 1200 draws: the mean within 5 standard errors, the spread within 10%
            assert abs(float(w.mean()) - mu) <= 5 * sd / 1200 ** 0.5 + 1e-7, name
            assert abs(float(w.std()) - sd) <= 0.1 * sd + 1e-7, name
