"""Transfer learning in the port on the CPU, against the JAX package.

The transfer cases of ``tests/test_earlystopping_transfer.py`` and
``tests/test_transfer_graph.py`` (ResNet50's head at 32x32, JAX's own slow
case, on the port). A source network is built in JAX, trained a step (so
its Adam moments are not zero) and carried to the port through its zip;
each package then makes the same surgery (``TransferLearning.Builder`` or
``GraphBuilder``: freezing, ``n_out_replace`` and its cascade, removing and
adding layers and vertices, a fine-tune configuration). The results'
configuration.json must be byte-equal and their retained parameters
equal. A re-initialised or added layer draws from each package's own
generator, so JAX's fresh weights are copied into the port's network
before both fit: the frozen parameters stay bit-equal in both and the
others match. The helpers' ``featurize``, ``fit_featurized`` and
``output_from_featurized`` are held the same way.

Tolerances, as max |port - jax| over the layer's largest |jax| entry:
float64 1e-10, float32 1e-5, bfloat16 one bf16 unit (2^-8).
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import Adam as JAdam
from deeplearning4j_tpu import ComputationGraph as JGraph
from deeplearning4j_tpu import MultiLayerNetwork as JNet
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu import Sgd as JSgd
from deeplearning4j_tpu.compat import enable_x64
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.models.zoo import ResNet50 as JResNet50
from deeplearning4j_tpu.nn import transferlearning as jtl
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.utils.model_serializer import ModelSerializer as JSerializer

from deeplearning4j_torch import (Adam, DataSet, FineTuneConfiguration, MultiDataSet, Sgd,
                                  TransferLearning, TransferLearningHelper)
from deeplearning4j_torch.models.zoo import ResNet50
from deeplearning4j_torch.nn.conf import layers as pl
from deeplearning4j_torch.nn.layers.wrapper import FrozenImpl
from deeplearning4j_torch.nn.transferlearning import GraphTransferLearningHelper
from deeplearning4j_torch.utils.model_serializer import restore_model

TOL = {"float64": 1e-10, "float32": 1e-5}
BF16_UNIT = 2.0 ** -8
POLICY = {"float64": ("float64", "float64"), "float32": ("float32", "float32"),
          "bfloat16": ("float32", "bfloat16")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _close(got, want, dtype, what=""):
    want = np.asarray(want, np.float64)
    got = got.detach().double().cpu().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, np.float64)
    scale = max(np.abs(want).max(), 1e-300)
    limit = BF16_UNIT if dtype == "bfloat16" else TOL[dtype]
    err = float(np.abs(got - want).max() / scale)
    assert err <= limit, (what, err, limit)


def check_params(net, jnet, dtype):
    """Every layer's parameters at the dtype's tolerance of the layer's
    largest entry."""
    for k, ps in jnet.params.items():
        scale = max((float(np.abs(np.asarray(p, np.float64)).max()) for p in ps.values()),
                    default=0.0)
        for n, p in ps.items():
            err = float(np.abs(net.params[k][n].double().numpy()
                               - np.asarray(p, np.float64)).max())
            limit = (BF16_UNIT if dtype == "bfloat16" else TOL[dtype]) * scale
            assert err <= limit, (k, n, err, limit)


def _data(n=16, n_in=4, n_out=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, n_in)).astype(np.float32),
            np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out, n)])


def _source(tmp_path, jnet, f, l):
    """``jnet`` trained one step on (f, l) (its Adam moments then not
    zero), and the port's restore of its zip."""
    jnet.fit(JDataSet(f, l))
    path = tmp_path / "source.zip"
    JSerializer.write_model(jnet, str(path))
    return restore_model(str(path), device="cpu")


def _copy_fresh(net, jnet, keys):
    """JAX's freshly drawn weights of the layers ``keys`` into the port."""
    for k in keys:
        net._layers()[k].set_params({n: np.array(v) for n, v in jnet.params[k].items()}, "cpu")


def _fit_both(net, jnet, f, l, steps=2):
    for _ in range(steps):
        jnet.fit(JDataSet(f, l))
        net.fit(DataSet(f, l))


def _mln_jconf(dtype="float32", seed=7):
    pdt, cdt = POLICY[dtype]
    return (JConf.builder().seed(seed).updater(JAdam(learning_rate=1e-2)).activation("tanh")
            .dtype(pdt).compute_dtype(cdt).list()
            .layer(jl.DenseLayer(n_in=4, n_out=8))
            .layer(jl.DenseLayer(n_in=8, n_out=8))
            .layer(jl.OutputLayer(n_in=8, n_out=3, activation="softmax", loss="mcxent"))
            .build())


# -------------------------------------------------------- MultiLayerNetwork
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_builder_freeze_matches_jax(tmp_path, dtype):
    """``set_feature_extractor(0)`` under a fine-tune Sgd: the same JSON,
    every parameter carried over, a fresh (zero) updater state; two fits:
    layer 0 bit-equal in both packages and never given to the updater, the
    rest as in JAX. Freezing again does not wrap twice."""
    with enable_x64(dtype == "float64"):
        jnet = JNet(_mln_jconf(dtype)).init()
        f, l = _data()
        net = _source(tmp_path, jnet, f, l)
        ftc = jtl.FineTuneConfiguration.builder().updater(JSgd(learning_rate=0.5)).build()
        jnew = jtl.TransferLearning.Builder(jnet).fine_tune_configuration(ftc) \
            .set_feature_extractor(0).build()
        new = TransferLearning.Builder(net).fine_tune_configuration(
            FineTuneConfiguration.builder().updater(Sgd(learning_rate=0.5)).build()) \
            .set_feature_extractor(0).build()
        assert new.conf.to_json() == jnew.conf.to_json()
        assert isinstance(new.impls[0], FrozenImpl) and new.device == net.device
        check_params(new, jnew, dtype)
        before = {n: t.clone() for n, t in new.params["0"].items()}
        f2, l2 = _data(seed=5)
        _fit_both(new, jnew, f2, l2)
        for n, t in before.items():
            assert torch.equal(new.params["0"][n], t)
            np.testing.assert_array_equal(np.asarray(jnew.params["0"][n], np.float64),
                                          t.double().numpy())
        assert new._idle_frozen() == {"0"}
        check_params(new, jnew, dtype)
    again = TransferLearning.Builder(new).set_feature_extractor(1).build()
    assert [type(c).__name__ for c in again.conf.layers] == ["FrozenLayer", "FrozenLayer",
                                                              "OutputLayer"]
    assert type(again.conf.layers[0].inner).__name__ == "DenseLayer"


def test_builder_n_out_replace_cascades(tmp_path):
    """``n_out_replace(1, 12, "xavier_uniform")``: layer 1's width and init
    and layer 2's n_in change, both re-initialised, layer 0 carried; the
    fits match JAX once its fresh weights are copied."""
    jnet = JNet(_mln_jconf()).init()
    f, l = _data()
    net = _source(tmp_path, jnet, f, l)
    jnew = jtl.TransferLearning.Builder(jnet).n_out_replace(1, 12, "xavier_uniform").build()
    new = TransferLearning.Builder(net).nOutReplace(1, 12, "xavier_uniform").build()
    assert new.conf.to_json() == jnew.conf.to_json()
    assert new.conf.layers[1].n_out == 12 and new.conf.layers[2].n_in == 12
    assert tuple(new.params["1"]["W"].shape) == (8, 12)
    assert tuple(new.params["2"]["W"].shape) == (12, 3)
    assert torch.equal(new.params["0"]["W"], net.params["0"]["W"])
    _copy_fresh(new, jnew, ["1", "2"])
    _fit_both(new, jnew, f, l)
    check_params(new, jnew, "float32")


def test_builder_remove_and_add_layers(tmp_path):
    """A CNN (convolution, pooling, dense, output; NCHW input type):
    ``remove_layers_from_output(2)``, then a dense layer and a 5-way output
    added with their preprocessor and n_in inferred from the input type
    (``set_input_type``), layers 0-1 frozen; the same JSON, output and fits."""
    jconf = (JConf.builder().seed(3).updater(JAdam(learning_rate=1e-2)).activation("relu")
             .list()
             .layer(jl.ConvolutionLayer(n_out=4, kernel_size=(3, 3)))
             .layer(jl.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
             .layer(jl.DenseLayer(n_out=6))
             .layer(jl.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
             .set_input_type(JInputType.convolutional(6, 6, 2)).build())
    jnet = JNet(jconf).init()
    rng = np.random.default_rng(2)
    f = rng.normal(size=(6, 2, 6, 6)).astype(np.float32)
    l3 = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
    l5 = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 6)]
    net = _source(tmp_path, jnet, f, l3)
    jnew = (jtl.TransferLearning.Builder(jnet).set_feature_extractor(1)
            .remove_layers_from_output(2).add_layer(jl.DenseLayer(n_out=7))
            .add_layer(jl.OutputLayer(n_out=5, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.convolutional(6, 6, 2)).build())
    from deeplearning4j_torch.nn.conf.inputs import InputType
    new = (TransferLearning.Builder(net).setFeatureExtractor(1).removeLayersFromOutput(2)
           .addLayer(pl.DenseLayer(n_out=7))
           .addLayer(pl.OutputLayer(n_out=5, activation="softmax", loss="mcxent"))
           .setInputType(InputType.convolutional(6, 6, 2)).build())
    assert new.conf.to_json() == jnew.conf.to_json()
    _copy_fresh(new, jnew, ["2", "3"])
    _close(new.output(f), np.asarray(jnew.output(f)), "float32", "output")
    _fit_both(new, jnew, f, l5)
    check_params(new, jnew, "float32")
    one = TransferLearning.Builder(net).remove_output_layer().add_layer(
        pl.OutputLayer(n_in=6, n_out=5, activation="softmax", loss="mcxent")).build()
    assert len(one.conf.layers) == 4 and tuple(one.output(f).shape) == (6, 5)


def test_helper_matches_jax(tmp_path):
    """``TransferLearningHelper(net, 0)``: ``featurize`` is layer 0's
    activations (a host DataSet), two ``fit_featurized`` fits of the tail
    and ``output_from_featurized`` match JAX's; the tail is a network of
    its own (``unfrozen_mln``) and the source is untouched."""
    jnet = JNet(_mln_jconf()).init()
    f, l = _data()
    net = _source(tmp_path, jnet, f, l)
    jh, h = jtl.TransferLearningHelper(jnet, 0), TransferLearningHelper(net, 0)
    assert isinstance(h, TransferLearningHelper)
    jfeat, feat = jh.featurize(JDataSet(f, l)), h.featurize(DataSet(f, l))
    assert isinstance(feat.features, np.ndarray) and feat.features.shape == (16, 8)
    _close(feat.features, jfeat.features, "float32", "featurize")
    _close(feat.features, net.feed_forward_to_layer(0, f), "float32", "full forward")
    src = {k: {n: t.clone() for n, t in ps.items()} for k, ps in net.params.items()}
    for _ in range(2):
        jh.fit_featurized(jfeat)
        h.fitFeaturized(feat)
    check_params(h.unfrozen_mln(), jh.unfrozen_mln(), "float32")
    _close(h.outputFromFeaturized(feat.features),
           np.asarray(jh.output_from_featurized(jfeat.features)), "float32", "tail output")
    for k, ps in src.items():
        assert all(torch.equal(net.params[k][n], t) for n, t in ps.items())


def test_fine_tune_configuration():
    ftc = (FineTuneConfiguration.builder().seed(9).l2(1e-3).dropout(0.8)
           .gradient_normalization("clip_l2_per_layer").build())
    from deeplearning4j_torch.nn.conf import GlobalConfig
    gc = ftc.apply_to(GlobalConfig(seed=1, l1=0.5))
    assert (gc.seed, gc.l1, gc.l2, gc.dropout, gc.gradient_normalization) == (
        9, 0.5, 1e-3, 0.8, "clip_l2_per_layer")
    with pytest.raises(AttributeError, match="no field"):
        FineTuneConfiguration.builder().momentum(0.9)


# ---------------------------------------------------------- ComputationGraph
def _small_cg_jconf(seed=3):
    return (JConf.builder().seed(seed).updater(JSgd(learning_rate=1e-2)).activation("tanh")
            .graph_builder().add_inputs("in")
            .add_layer("d0", jl.DenseLayer(n_in=6, n_out=8), "in")
            .add_layer("d1", jl.DenseLayer(n_in=8, n_out=8), "d0")
            .add_layer("out", jl.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                             loss="mcxent"), "d1")
            .set_outputs("out").set_input_types(JInputType.feed_forward(6)).build())


def _graph_source(tmp_path):
    jnet = JGraph(_small_cg_jconf()).init()
    f, l = _data(n_in=6)
    return jnet, _source(tmp_path, jnet, f, l)


def test_graph_builder_freeze_and_replace(tmp_path):
    """``set_feature_extractor("d0")`` + ``n_out_replace("out", 4)`` under a
    fine-tune Sgd: the same JSON; d0 and d1 carried; two fits: d0
    bit-equal, the rest as in JAX."""
    jnet, net = _graph_source(tmp_path)
    ftc = jtl.FineTuneConfiguration.builder().updater(JSgd(learning_rate=5e-2)).build()
    jnew = (jtl.TransferLearning.GraphBuilder(jnet).fine_tune_configuration(ftc)
            .set_feature_extractor("d0").n_out_replace("out", 4).build())
    new = (TransferLearning.GraphBuilder(net).fineTuneConfiguration(
        FineTuneConfiguration.builder().updater(Sgd(learning_rate=5e-2)).build())
           .setFeatureExtractor("d0").nOutReplace("out", 4).build())
    assert new.conf.to_json() == jnew.conf.to_json()
    assert isinstance(new.impls["d0"], FrozenImpl) and not isinstance(new.impls["d1"], FrozenImpl)
    for k in ("d0", "d1"):
        assert torch.equal(new.params[k]["W"], net.params[k]["W"])
    _copy_fresh(new, jnew, ["out"])
    d0 = new.params["d0"]["W"].clone()
    f, l = _data(n_in=6, n_out=4, seed=1)
    _fit_both(new, jnew, f, l)
    assert torch.equal(new.params["d0"]["W"], d0)
    np.testing.assert_array_equal(np.asarray(jnew.params["d0"]["W"]), d0.numpy())
    check_params(new, jnew, "float32")


def test_graph_builder_remove_add_and_cascade(tmp_path):
    """Remove "out", add a two-input head (a "-merge" MergeVertex in front)
    and a new output; ``n_out_replace("d0", 12)`` re-derives d1's n_in
    through the cascade. The same JSON and fits."""
    jnet, net = _graph_source(tmp_path)
    jnew = (jtl.TransferLearning.GraphBuilder(jnet).remove_vertex_and_connections("out")
            .n_out_replace("d0", 12)
            .add_layer("head", jl.DenseLayer(n_out=5, activation="relu"), "d0", "d1")
            .add_layer("out2", jl.OutputLayer(n_in=5, n_out=2, activation="softmax",
                                              loss="mcxent"), "head")
            .set_outputs("out2").build())
    new = (TransferLearning.GraphBuilder(net).removeVertexAndConnections("out")
           .n_out_replace("d0", 12)
           .addLayer("head", pl.DenseLayer(n_out=5, activation="relu"), "d0", "d1")
           .addLayer("out2", pl.OutputLayer(n_in=5, n_out=2, activation="softmax",
                                            loss="mcxent"), "head")
           .setOutputs("out2").build())
    assert new.conf.to_json() == jnew.conf.to_json()
    assert "out" not in new.conf.vertices and "head-merge" in new.conf.vertices
    assert tuple(new.params["d1"]["W"].shape) == (12, 8)
    assert tuple(new.params["head"]["W"].shape) == (20, 5)
    _copy_fresh(new, jnew, ["d0", "d1", "head", "out2"])
    f, l = _data(n_in=6, n_out=2, seed=2)
    _fit_both(new, jnew, f, l)
    check_params(new, jnew, "float32")


def test_graph_helper_matches_jax(tmp_path):
    """``TransferLearningHelper(graph, "d0")`` is a
    GraphTransferLearningHelper: ``featurize`` gives a MultiDataSet of d0's
    activations; the tail's output on them is the full graph's; two
    ``fit_featurized`` fits and the output match JAX's."""
    jnet, net = _graph_source(tmp_path)
    jh, h = jtl.TransferLearningHelper(jnet, "d0"), TransferLearningHelper(net, "d0")
    assert isinstance(h, GraphTransferLearningHelper) and h.boundary == ["d0"]
    f, l = _data(8, n_in=6, seed=3)
    jm, m = jh.featurize(JDataSet(f, l)), h.featurize(DataSet(f, l))
    assert isinstance(m, MultiDataSet) and m.features[0].shape == (8, 8)
    _close(m.features[0], jm.features[0], "float32", "featurize")
    _close(h.output_from_featurized(m.features[0]), net.output(f).numpy(), "float32", "tail")
    # before JAX's tail fits: they donate buffers its source graph shares
    jm2 = jh.featurize(JMultiDataSet([f], [l]))
    _close(h.featurize(MultiDataSet([f], [l])).features[0], jm2.features[0], "float32", "mds")
    for _ in range(2):
        jh.fit_featurized(jm)
        h.fitFeaturized(m)
    check_params(h.unfrozenGraph(), jh.unfrozen_graph(), "float32")
    _close(h.output_from_featurized(m.features[0]),
           np.asarray(jh.output_from_featurized(jm.features[0])), "float32", "after fits")
    with pytest.raises(ValueError, match="inside the frozen subgraph"):
        TransferLearningHelper(net, "out")


def test_resnet50_head_fine_tunes():
    """JAX's slow case on the port: ResNet50 at 3x32x32 with the body frozen
    at "gap" and a 10-way head (``n_out_replace("output", 10)``, Adam): the
    transferred configuration.json equals JAX's; one fit leaves the stem
    convolution and every frozen parameter bit-equal, moves the head, and
    moves the frozen BN layers' running statistics (the training forward
    normalises by the batch, as in JAX)."""
    jnet = JResNet50(num_classes=4, input_shape=(3, 32, 32)).init()
    jnew = (jtl.TransferLearning.GraphBuilder(jnet).fine_tune_configuration(
        jtl.FineTuneConfiguration.builder().updater(JAdam(learning_rate=1e-3)).build())
            .set_feature_extractor("gap").n_out_replace("output", 10).build())
    net = ResNet50(num_classes=4, input_shape=(3, 32, 32)).init(device="cpu")
    new = (TransferLearning.GraphBuilder(net).fine_tune_configuration(
        FineTuneConfiguration.builder().updater(Adam(learning_rate=1e-3)).build())
           .set_feature_extractor("gap").n_out_replace("output", 10).build())
    assert new.conf.to_json() == jnew.conf.to_json()
    assert tuple(new.params["output"]["W"].shape)[-1] == 10
    frozen = {n for n, impl in new.impls.items() if isinstance(impl, FrozenImpl)}
    assert frozen == set(new.impls) - {"output"} and "stem-conv" in frozen
    before = {n: {k: t.clone() for k, t in new.params[n].items()} for n in frozen}
    stats = {n: {k: t.clone() for k, t in new.states[n].items()} for n in frozen
             if new.states[n]}
    head = new.params["output"]["W"].clone()
    rng = np.random.default_rng(0)
    f = rng.normal(size=(4, 3, 32, 32)).astype(np.float32)
    new.fit(DataSet(f, np.eye(10, dtype=np.float32)[rng.integers(0, 10, 4)]))
    assert np.isfinite(new.score())
    for n, ps in before.items():
        assert all(torch.equal(new.params[n][k], t) for k, t in ps.items()), n
    assert stats and all(not torch.equal(new.states[n]["mean"], s["mean"])
                         for n, s in stats.items())
    assert float((new.params["output"]["W"] - head).abs().max()) > 0
    assert new._idle_frozen() == frozen
