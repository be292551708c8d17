"""EmbeddingLayer, LossLayer, Yolo2OutputLayer and FrozenLayer in the port on
the CPU, against the JAX package; the new configurations' JSON and zips.

- every new layer kind and reconstruction distribution: a JAX
  configuration.json decodes in the port and encodes back byte for byte;
  zips of nets holding them go JAX -> port -> JAX and port -> JAX with the
  same arrays;
- EmbeddingLayer: [b], [b, 1] and one-hot input, and ``jnp.take``'s index
  rules (an index in [-nIn, 0) wraps, one outside [-nIn, nIn) gives a NaN
  row), forward and gradients, in f64, f32 and bf16, and a fitted net;
- LossLayer in a MultiLayerNetwork and as a graph's output vertex;
- Yolo2OutputLayer: loss and input gradient against JAX and the scalar
  oracle of ``tests/test_yolo_loss.py``, its other oracles, and a fitted
  convolutional trunk;
- FrozenLayer: the updater on frozen parameters (skipped from a zero
  state, bit-equal; run on the zero gradient from a JAX zip's non-zero Adam
  moments, as JAX does), a frozen BatchNormalization's running statistics,
  a frozen GravesLSTM on the per-layer kernel route (K1 without the
  reserve, no K2, no fused pair), and zeros without autograd only for a
  net with nothing left to train;
- the layer cases of ``tests/test_gradientcheck_extended.py``.

Tolerances, as max |port - jax| over the largest |jax| entry: float64
1e-10, float32 1e-5 (parameters after fits: of the layer's largest entry);
bfloat16 one bf16 unit (2^-8) of the largest entry.
"""
import io
import json
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu import Adam as JAdam
from deeplearning4j_tpu import ComputationGraph as JGraph
from deeplearning4j_tpu import MultiLayerNetwork as JNet
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu import Sgd as JSgd
from deeplearning4j_tpu.compat import enable_x64
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import GlobalConfig as JGlobalConfig
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf import reconstruction as jrec
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.layers.base import impl_for as jimpl_for
from deeplearning4j_tpu.utils.model_serializer import ModelSerializer as JSerializer

from deeplearning4j_torch import DataSet
from deeplearning4j_torch.nn.conf import (ComputationGraphConfiguration, GlobalConfig,
                                          MultiLayerConfiguration, serde)
from deeplearning4j_torch.nn.gradientcheck import GradientCheckUtil
from deeplearning4j_torch.nn.graph import ComputationGraph
from deeplearning4j_torch.nn.layers import impl_for
from deeplearning4j_torch.nn.layers.wrapper import FrozenImpl
from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_torch.ops import lstm_cell, lstm_fused
from deeplearning4j_torch.utils.model_serializer import (COEFFICIENTS_BIN, CONFIG_JSON,
                                                         STATES_BIN, UPDATER_BIN,
                                                         restore_model, write_model)

from test_yolo_loss import yolo_loss_oracle

TOL = {"float64": 1e-10, "float32": 1e-5}
BF16_UNIT = 2.0 ** -8
POLICY = {"float64": ("float64", "float64"), "float32": ("float32", "float32"),
          "bfloat16": ("float32", "bfloat16")}
TDT = {"float64": torch.float64, "float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def rel(got, want):
    got = np.asarray(got.detach().double().cpu() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _builder(dtype="float32", updater=None, seed=5):
    pdt, cdt = POLICY[dtype]
    return (JConf.builder().seed(seed).updater(updater or JSgd(learning_rate=0.1))
            .activation("tanh").dtype(pdt).compute_dtype(cdt))


def _mln(jconf, dtype="float32"):
    """(JAX net, port net on the CPU with JAX's parameters)."""
    with enable_x64(dtype == "float64"):
        jnet = JNet(jconf).init()
        params = {k: {n: np.array(v) for n, v in d.items()} for k, d in jnet.params.items()}
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(jconf.to_json())).init(
        params=params, device="cpu")
    return jnet, net


def check_params(net, jnet, dtype="float32", keys=None):
    for k, ps in jnet.params.items():
        if keys is not None and k not in keys:
            continue
        scale = max((float(np.abs(np.asarray(p, np.float64)).max()) for p in ps.values()),
                    default=0.0)
        for n, p in ps.items():
            err = float(np.abs(net.params[k][n].double().numpy()
                               - np.asarray(p, np.float64)).max())
            limit = BF16_UNIT * scale if dtype == "bfloat16" else TOL[dtype] * scale
            assert err <= limit, (k, n, err, limit)


def _onehot(rng, n, c):
    return np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]


# ---------------------------------------------------------- configurations
def _composite():
    return (jrec.CompositeReconstructionDistribution.builder()
            .add_distribution(2, jrec.GaussianReconstructionDistribution(activation="tanh"))
            .add_distribution(2, jrec.BernoulliReconstructionDistribution())
            .add_distribution(2, jrec.LossFunctionWrapper(loss="mae")).build())


def _vae(dist):
    return jl.VariationalAutoencoder(n_in=6, n_out=2, encoder_layer_sizes=(5, 4),
                                     decoder_layer_sizes=(3,), reconstruction_distribution=dist,
                                     num_samples=2, pzx_activation="sigmoid")


def _yolo_jconf(dtype="float32", updater=None):
    return (_builder(dtype, updater).list()
            .layer(jl.ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                       convolution_mode=jl.ConvolutionMode.Same))
            .layer(jl.ConvolutionLayer(n_out=2 * 5 + 3, kernel_size=(1, 1),
                                       activation="identity"))
            .layer(jl.Yolo2OutputLayer(boxes=[[1.0, 1.5], [2.5, 2.0]], lambda_no_obj=0.4))
            .set_input_type(JInputType.convolutional(4, 4, 3)).build())


CONFIGS = {
    "embedding_loss": lambda: (_builder().list()
                               .layer(jl.EmbeddingLayer(n_in=9, n_out=4, has_bias=False))
                               .layer(jl.DenseLayer(n_in=4, n_out=3))
                               .layer(jl.ActivationLayer(activation="softmax"))
                               .layer(jl.LossLayer(loss="mcxent", activation="identity"))
                               .build()),
    "autoencoder_rbm": lambda: (_builder().list()
                                .layer(jl.RBM(n_in=6, n_out=5, hidden_unit="rectified",
                                              visible_unit="gaussian", k=2, sparsity=0.1))
                                .layer(jl.AutoEncoder(n_in=5, n_out=4, corruption_level=0.2,
                                                      sparsity=0.05, loss="xent"))
                                .layer(jl.OutputLayer(n_in=4, n_out=2, activation="softmax"))
                                .pretrain(True).build()),
    **{f"vae_{n}": (lambda d=d: (_builder().list().layer(_vae(d()))
                                 .layer(jl.OutputLayer(n_in=2, n_out=2, activation="softmax"))
                                 .build()))
       for n, d in (("gaussian", jrec.GaussianReconstructionDistribution),
                    ("bernoulli", jrec.BernoulliReconstructionDistribution),
                    ("exponential", jrec.ExponentialReconstructionDistribution),
                    ("wrapper", lambda: jrec.LossFunctionWrapper(loss="mse",
                                                                  activation="sigmoid")),
                    ("composite", _composite), ("legacy", lambda: "bernoulli"))},
    "yolo2": _yolo_jconf,
    "frozen": lambda: (_builder("float32", JAdam(learning_rate=1e-2)).list()
                       .layer(jl.FrozenLayer(inner=jl.ConvolutionLayer(
                           n_out=3, kernel_size=(2, 2), l2=1e-3)))
                       .layer(jl.FrozenLayer(inner=jl.BatchNormalization()))
                       .layer(jl.FrozenLayer(inner=jl.DenseLayer(n_out=5)))
                       .layer(jl.OutputLayer(n_out=2, activation="softmax"))
                       .set_input_type(JInputType.convolutional(5, 5, 2)).build()),
}


def _graph_jconf():
    return (_builder().graph_builder().add_inputs("in")
            .add_layer("d0", jl.FrozenLayer(inner=jl.DenseLayer(n_in=4, n_out=6)), "in")
            .add_layer("d1", jl.DenseLayer(n_in=6, n_out=3, activation="softmax"), "d0")
            .add_layer("loss", jl.LossLayer(loss="mcxent", activation="identity"), "d1")
            .set_outputs("loss").set_input_types(JInputType.feed_forward(4)).build())


def test_configurations_round_trip_byte_equal():
    """Each JAX configuration.json decodes in the port (the new classes, a
    FrozenLayer's inner layer nested, each distribution, the pretrain flag)
    and encodes back byte for byte; the graph's too."""
    for name, make in CONFIGS.items():
        jconf = make()
        conf = MultiLayerConfiguration.from_json(jconf.to_json())
        assert conf.to_json() == jconf.to_json(), name
    frozen = MultiLayerConfiguration.from_json(CONFIGS["frozen"]().to_json()).layers[0]
    assert type(frozen).__name__ == "FrozenLayer" and frozen.inner.l2 == 1e-3
    jg = _graph_jconf()
    assert ComputationGraphConfiguration.from_json(jg.to_json()).to_json() == jg.to_json()
    layers = MultiLayerConfiguration.from_json(CONFIGS["autoencoder_rbm"]().to_json()).layers
    assert [l.is_pretrain_layer() for l in layers] == [True, True, False]


def _npz(z, member):
    if member not in z.namelist():
        return {}
    a = np.load(io.BytesIO(z.read(member)))
    return {k: a[k] for k in a.files}


def _same_zip(pa, pb):
    with zipfile.ZipFile(pa) as za, zipfile.ZipFile(pb) as zb:
        assert json.loads(za.read(CONFIG_JSON)) == json.loads(zb.read(CONFIG_JSON))
        for member in (COEFFICIENTS_BIN, UPDATER_BIN, STATES_BIN):
            a, b = _npz(za, member), _npz(zb, member)
            assert set(a) == set(b), member
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{member} {k}")


@pytest.mark.parametrize("name", ["embedding_loss", "autoencoder_rbm", "vae", "yolo2", "frozen"])
def test_zips_round_trip_both_ways(tmp_path, name):
    """A JAX zip (after one fit step: moments and BN statistics set)
    restores in the port and is written back the same; the port's zip after
    a step of its own restores in JAX with the port's arrays. "vae" runs
    the VAE with each reconstruction distribution."""
    if name == "vae":
        for n in [k for k in CONFIGS if k.startswith("vae_")]:
            (tmp_path / n).mkdir()
            test_zips_round_trip_both_ways(tmp_path / n, n)
        return
    jconf = CONFIGS[name]()
    jnet = JNet(jconf).init()
    rng = np.random.default_rng(0)
    if name == "embedding_loss":
        f, l = rng.integers(0, 9, (6, 1)).astype(np.float32), _onehot(rng, 6, 3)
    elif name == "yolo2":
        f, l = rng.normal(size=(2, 3, 4, 4)).astype(np.float32), _yolo_labels(rng, 2, 4, 4, 3)
    elif name == "frozen":
        f, l = rng.normal(size=(4, 2, 5, 5)).astype(np.float32), _onehot(rng, 4, 2)
    else:
        f, l = rng.random((6, 6)).astype(np.float32), _onehot(rng, 6, 2)
    if name != "autoencoder_rbm":       # fit would pretrain with JAX's draws
        jnet.fit(JDataSet(f, l))
    j1, p1, j2, p2 = (tmp_path / n for n in ("j1.zip", "p1.zip", "j2.zip", "p2.zip"))
    JSerializer.write_model(jnet, str(j1))
    net = restore_model(str(j1), device="cpu")
    write_model(net, str(p1))
    _same_zip(j1, p1)
    if name != "autoencoder_rbm":
        net.fit(DataSet(f, l))
    write_model(net, str(p2))
    back = JSerializer.restore_model(str(p2))
    JSerializer.write_model(back, str(j2))
    _same_zip(p2, j2)


# ---------------------------------------------------------------- embedding
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_embedding_matches_jax(dtype):
    """Forward of [b], [b, 1] (float ids truncating toward zero) and one-hot
    input, the wrap and NaN rows included, and the gradients of a seeded
    projection of the output over in-range ids."""
    pdt, cdt = POLICY[dtype]
    conf = jl.EmbeddingLayer(n_in=7, n_out=4, activation="tanh")
    rng = np.random.default_rng(2)
    with enable_x64(dtype == "float64"):
        jimpl = jimpl_for(conf, JGlobalConfig(dtype=pdt, compute_dtype=cdt))
        params, _ = jimpl.init(jax.random.PRNGKey(1))
        params = {k: jnp.asarray(np.asarray(v) + 0.1 * rng.normal(size=v.shape), v.dtype)
                  for k, v in params.items()}
    impl = impl_for(serde.decode(serde.encode(conf)), GlobalConfig(dtype=pdt, compute_dtype=cdt))
    impl.set_params({k: torch.from_numpy(np.array(v)) for k, v in params.items()}, "cpu")
    ids = np.array([0, 6, 3, 7, 9, -1, -7, -8, 2.7, -0.5, -1.5])
    inputs = {"flat": ids, "column": ids[:, None],
              "onehot": np.eye(7)[rng.integers(0, 7, 5)]}
    tol = BF16_UNIT if dtype == "bfloat16" else TOL[dtype]
    with enable_x64(dtype == "float64"):
        for label, x in inputs.items():
            want = np.asarray(jimpl.forward(params, {}, jnp.asarray(x))[0], np.float64)
            got = impl(torch.from_numpy(x)).detach().double().numpy()
            assert np.array_equal(np.isnan(got), np.isnan(want)), label
            ok = ~np.isnan(want)
            assert np.abs(got[ok] - want[ok]).max() <= tol * np.abs(want[ok]).max(), label
        nan_rows = np.isnan(impl(torch.from_numpy(ids)).detach().double().numpy()).all(1)
        assert nan_rows.tolist() == [False, False, False, True, True, False, False, True,
                                     False, False, False]
        x = np.array([0, 6, 3, -1, 2, 2])
        dy = rng.normal(size=(6, 4))
        out, vjp = jax.vjp(lambda p: jimpl.forward(p, {}, jnp.asarray(x))[0], params)
        jg = vjp(jnp.asarray(dy, out.dtype))[0]
        p = {k: v.detach().clone().requires_grad_() for k, v in impl.param_dict().items()}
        y = torch.func.functional_call(impl, p, (torch.from_numpy(x),))
        g = torch.autograd.grad(y, list(p.values()), torch.from_numpy(dy).to(y.dtype))
        for (k, want), got in zip(jg.items(), g):
            assert rel(got, np.asarray(want)) <= (
                BF16_UNIT if dtype == "bfloat16" else TOL[dtype]), k


def test_embedding_network_fits_like_jax():
    """Embedding -> Dense -> Output, three Adam steps on [b, 1] ids (f32)."""
    jconf = (_builder("float32", JAdam(learning_rate=1e-2)).list()
             .layer(jl.EmbeddingLayer(n_in=9, n_out=5))
             .layer(jl.DenseLayer(n_in=5, n_out=6))
             .layer(jl.OutputLayer(n_in=6, n_out=3, activation="softmax", loss="mcxent"))
             .build())
    jnet, net = _mln(jconf)
    rng = np.random.default_rng(4)
    f, l = rng.integers(0, 9, (12, 1)).astype(np.float32), _onehot(rng, 12, 3)
    for _ in range(3):
        jnet.fit(JDataSet(f, l))
        net.fit(DataSet(f, l))
    check_params(net, jnet)
    assert abs(net.score() - float(jnet.score_)) <= 1e-5 * abs(float(jnet.score_))


# ---------------------------------------------------------------- LossLayer
@pytest.mark.parametrize("container", ["multilayer", "graph"])
def test_loss_layer_matches_jax(container):
    """Dense (softmax) -> LossLayer(mcxent), the LossLayer last in a
    MultiLayerNetwork or the output vertex of a graph (its input preceded
    by a frozen layer): output, score, gradients and two fit steps."""
    rng = np.random.default_rng(6)
    f, l = rng.normal(size=(8, 4)).astype(np.float32), _onehot(rng, 8, 3)
    if container == "graph":
        jconf = _graph_jconf()
        jnet = JGraph(jconf).init()
        net = ComputationGraph(ComputationGraphConfiguration.from_json(jconf.to_json())).init(
            params={k: {n: np.array(v) for n, v in d.items()} for k, d in jnet.params.items()},
            device="cpu")
    else:
        jnet, net = _mln(CONFIGS["embedding_loss"]())
        f = rng.integers(0, 9, (8, 1)).astype(np.float32)
    assert rel(net.output(f), np.asarray(jnet.output(f))) <= 1e-5
    assert abs(net.score(DataSet(f, l)) - float(jnet.score(JDataSet(f, l)))) <= 1e-5
    grads, _ = net.compute_gradient_and_score(DataSet(f, l))
    jgrads, _ = jnet.compute_gradient_and_score(JDataSet(f, l))
    for k, gs in jgrads.items():
        for n, g in gs.items():
            assert rel(grads[k][n], np.asarray(g)) <= 1e-5, (k, n)
    for _ in range(2):
        jnet.fit(JDataSet(f, l))
        net.fit(DataSet(f, l))
    check_params(net, jnet)


# -------------------------------------------------------------------- Yolo2
def _yolo_labels(rng, b, gh, gw, c, per_image=2):
    """[b, 4 + C, gh, gw]: ``per_image`` boxes of 0.5-2.5 cells, each in the
    cell of its centre, with a one-hot class."""
    labels = np.zeros((b, 4 + c, gh, gw), np.float32)
    for m in range(b):
        for _ in range(per_image):
            i, j = rng.integers(0, gh), rng.integers(0, gw)
            w, h = rng.uniform(0.5, 2.5, 2)
            cx, cy = j + rng.uniform(0.1, 0.9), i + rng.uniform(0.1, 0.9)
            labels[m, :4, i, j] = [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]
            labels[m, 4:, i, j] = 0
            labels[m, 4 + rng.integers(0, c), i, j] = 1.0
    return labels


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_yolo2_matches_jax(dtype):
    """The loss and its gradient in the input, against JAX and the scalar
    oracle, and the forward (sigmoid xy and confidence, anchor x exp wh,
    class softmax)."""
    conf = jl.Yolo2OutputLayer(boxes=[[1.0, 1.5], [2.5, 2.0], [0.7, 0.6]], lambda_coord=4.0)
    anchors = np.asarray(conf.boxes, np.float32)
    rng = np.random.default_rng(42)
    x = rng.normal(scale=0.8, size=(3, 4, 5, 5 * 3 + 3))
    labels = _yolo_labels(rng, 3, 4, 5, 3).astype(np.float64 if dtype == "float64"
                                                   else np.float32)
    pdt, cdt = POLICY[dtype]
    impl = impl_for(serde.decode(serde.encode(conf)), GlobalConfig(dtype=pdt, compute_dtype=cdt))
    with enable_x64(dtype == "float64"):
        jimpl = jimpl_for(conf, JGlobalConfig(dtype=pdt, compute_dtype=cdt))
        xj = jnp.asarray(x, jnp.float64 if dtype == "float64" else jnp.float32)
        jloss, jg = jax.jit(jax.value_and_grad(
            lambda v: jimpl.loss_on({}, {}, v, jnp.asarray(labels))))(xj)
        jout = jax.jit(lambda v: jimpl.forward({}, {}, v)[0])(xj)
    xt = torch.from_numpy(x).to(TDT[dtype]).requires_grad_()
    loss = impl.loss_on(xt, torch.from_numpy(labels))
    (g,) = torch.autograd.grad(loss, xt)
    tol = TOL[dtype]
    assert rel(loss, np.asarray(jloss)) <= tol
    assert rel(g, np.asarray(jg)) <= tol
    assert rel(impl(xt), np.asarray(jout)) <= tol
    oracle = yolo_loss_oracle(np.asarray(x, np.float64 if dtype == "float64" else np.float32),
                              labels.astype(np.float64),
                              anchors.astype(np.float64), 4.0, 0.5)
    assert abs(float(loss) - oracle) <= (1e-10 if dtype == "float64" else 1e-5) * abs(oracle)


def test_yolo2_oracles():
    """``tests/test_yolo_loss.py``'s other cases on the port: no objects is
    pure lambda_noObj confidence, the best-matching anchor takes the
    coordinate loss, the forward's format."""
    impl = impl_for(serde.decode(serde.encode(jl.Yolo2OutputLayer(
        boxes=[[1.0, 1.0], [2.0, 2.0]]))), GlobalConfig())
    x = np.random.default_rng(3).normal(size=(1, 2, 2, 13)).astype(np.float32)
    got = float(impl.loss_on(torch.from_numpy(x), torch.zeros(1, 7, 2, 2)))
    want = 0.5 * (1 / (1 + np.exp(-x[0, :, :, [4, 9]].astype(np.float64))) ** 2).sum()
    assert got == pytest.approx(want, rel=1e-6)
    anchors = np.asarray([[1.0, 1.0], [3.0, 3.0]], np.float32)
    impl = impl_for(serde.decode(serde.encode(jl.Yolo2OutputLayer(boxes=anchors.tolist()))),
                    GlobalConfig())
    x = np.zeros((1, 4, 4, 13), np.float32)
    labels = np.zeros((1, 7, 4, 4), np.float32)
    labels[0, :4, 1, 1] = [0.0, 0.0, 3.0, 3.0]
    labels[0, 4, 1, 1] = 1.0
    got = float(impl.loss_on(torch.from_numpy(x), torch.from_numpy(labels)))
    assert got == pytest.approx(yolo_loss_oracle(x, labels, anchors), rel=1e-6)
    y = impl(torch.from_numpy(np.random.default_rng(5).normal(size=(2, 3, 3, 13)).astype(
        np.float32))).numpy()
    box = y[..., :10].reshape(2, 3, 3, 2, 5)
    assert ((box[..., :2] >= 0) & (box[..., :2] <= 1)).all() and (box[..., 2:4] > 0).all()
    np.testing.assert_allclose(y[..., 10:].sum(-1), 1.0, rtol=1e-5)


def test_yolo2_network_fits_like_jax():
    """A two-convolution trunk ending in Yolo2OutputLayer (labels [b, 4 + C,
    gh, gw]), three Adam steps (f32)."""
    jnet, net = _mln(_yolo_jconf("float32", JAdam(learning_rate=1e-2)))
    rng = np.random.default_rng(8)
    f, l = rng.normal(size=(3, 3, 4, 4)).astype(np.float32), _yolo_labels(rng, 3, 4, 4, 3)
    for _ in range(3):
        jnet.fit(JDataSet(f, l))
        net.fit(DataSet(f, l))
    check_params(net, jnet)
    assert abs(net.score() - float(jnet.score_)) <= 1e-5 * abs(float(jnet.score_))


# ---------------------------------------------------------------- frozen
def _frozen_dense_jconf(dtype="float32", updater=None, frozen=True):
    first = jl.DenseLayer(n_in=4, n_out=6, l2=1e-2)
    return (_builder(dtype, updater or JAdam(learning_rate=1e-2)).list()
            .layer(jl.FrozenLayer(inner=first) if frozen else first)
            .layer(jl.DenseLayer(n_in=6, n_out=5))
            .layer(jl.OutputLayer(n_in=5, n_out=3, activation="softmax", loss="mcxent"))
            .build())


def test_frozen_layer_skips_its_updater_from_a_zero_state(monkeypatch):
    """From a zero updater state the step skips the frozen layer (no
    gradient tensor, no updater call for it): its parameters and state stay
    bit-equal, as JAX's zero-gradient Adam update leaves them, and the rest
    trains as in JAX (f32, three steps)."""
    jnet, net = _mln(_frozen_dense_jconf())
    assert isinstance(net.impls[0], FrozenImpl)
    assert not any(p.requires_grad for p in net.impls[0].param_dict().values())
    seen = []
    real = net.updater.apply
    monkeypatch.setattr(net.updater, "apply",
                        lambda st, g, it: seen.append({k for k, v in g.items() if v})
                        or real(st, g, it))
    rng = np.random.default_rng(1)
    f, l = rng.normal(size=(8, 4)).astype(np.float32), _onehot(rng, 8, 3)
    before = {n: t.clone() for n, t in net.params["0"].items()}
    for _ in range(3):
        jnet.fit(JDataSet(f, l))
        net.fit(DataSet(f, l))
    assert seen == [{"1", "2"}] * 3 and net._idle_frozen() == {"0"}
    for n, t in before.items():
        assert torch.equal(net.params["0"][n], t)
        np.testing.assert_array_equal(np.asarray(jnet.params["0"][n]), t.numpy())
    check_params(net, jnet)
    grads, _ = net.compute_gradient_and_score(DataSet(f, l))
    assert all(float(g.abs().max()) == 0.0 for g in grads["0"].values())


def test_gradients_of_an_unrecorded_loss_raise_unless_all_is_frozen():
    """A loss that autograd did not record raises while any parameter
    trains (a detached loss is a fault, not a zero step); with every
    trainable layer frozen or skipped, the frozen one gets zeros and the
    skipped ones nothing, as JAX's zero gradient of a net frozen whole."""
    _, net = _mln(_frozen_dense_jconf())
    with pytest.raises(RuntimeError):
        net._grads(torch.zeros(()))
    grads = net._grads(torch.zeros(()), skip={"1", "2"})
    assert grads["1"] == {} and grads["2"] == {}
    assert set(grads["0"]) == set(net.params["0"])
    assert all(torch.equal(g, torch.zeros_like(net.params["0"][n]))
               for n, g in grads["0"].items())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_frozen_layer_with_adam_moments_moves_as_in_jax(tmp_path, dtype):
    """A JAX zip whose layer 0 was trained (non-zero Adam moments) and is
    then frozen (its configuration.json wrapped in a FrozenLayer): JAX's
    step runs Adam on the zero gradient, which moves the frozen parameters
    by its decaying moments. The port restores the zip, finds the state
    non-zero, runs the updater, and matches JAX's parameters, moments and
    zip (two steps)."""
    with enable_x64(dtype == "float64"):
        jnet = JNet(_frozen_dense_jconf(dtype, frozen=False)).init()
        rng = np.random.default_rng(2)
        f, l = rng.normal(size=(8, 4)).astype(np.float32), _onehot(rng, 8, 3)
        jnet.fit(JDataSet(f, l))
        JSerializer.write_model(jnet, str(tmp_path / "trained.zip"))
        with zipfile.ZipFile(tmp_path / "trained.zip") as z:
            members = {n: z.read(n) for n in z.namelist()}
        doc = json.loads(members[CONFIG_JSON])
        doc["config"]["layers"][0] = {"@class": "FrozenLayer", "name": None, "dropout": None,
                                      "inner": doc["config"]["layers"][0]}
        members[CONFIG_JSON] = json.dumps(doc, indent=2).encode()
        with zipfile.ZipFile(tmp_path / "frozen.zip", "w") as z:
            for n, data in members.items():
                z.writestr(n, data)
        jfrozen = JSerializer.restore_model(str(tmp_path / "frozen.zip"))
        net = restore_model(str(tmp_path / "frozen.zip"), device="cpu")
        assert isinstance(net.impls[0], FrozenImpl) and net._idle_frozen() == set()
        before = net.params["0"]["W"].clone()
        for _ in range(2):
            jfrozen.fit(JDataSet(f, l))
            net.fit(DataSet(f, l))
        assert not torch.equal(net.params["0"]["W"], before)
        check_params(net, jfrozen, dtype)
        for k, (m, v) in jfrozen.updater_state["0"].items():
            pm, pv = net.updater_state["0"][k]
            assert rel(pm, np.asarray(m)) <= TOL[dtype] and rel(pv, np.asarray(v)) <= TOL[dtype]


def test_frozen_batchnorm_updates_its_statistics_as_in_jax():
    """A frozen convolution and BatchNormalization (``frozen`` config): in
    training the BN normalises by the batch and its running statistics
    move, as in JAX; its gamma and beta and the convolution stay bit-equal;
    the rest trains as in JAX (f32, Adam, two steps)."""
    jnet, net = _mln(CONFIGS["frozen"]())
    rng = np.random.default_rng(3)
    f, l = rng.normal(size=(6, 2, 5, 5)).astype(np.float32), _onehot(rng, 6, 2)
    frozen = {k: {n: t.clone() for n, t in net.params[k].items()} for k in ("0", "1", "2")}
    mean0 = net.states["1"]["mean"].clone()
    for _ in range(2):
        jnet.fit(JDataSet(f, l))
        net.fit(DataSet(f, l))
    for k, ps in frozen.items():
        assert all(torch.equal(net.params[k][n], t) for n, t in ps.items()), k
    assert not torch.equal(net.states["1"]["mean"], mean0)
    for n, t in jnet.states["1"].items():
        assert rel(net.states["1"][n], np.asarray(t)) <= 1e-5, n
    check_params(net, jnet)


def test_frozen_lstm_takes_the_per_layer_kernel(monkeypatch):
    """A frozen GravesLSTM under a trained one (H=16): the pair is not
    fused; each layer runs K1 (``lstm_cell.lstm_fwd``), the frozen one
    without the reserve (no gradient needs it) and the trained one with
    it; K2 runs for the trained layer only; K3/K4 never. Parameters after
    two steps match JAX's (f32)."""
    jconf = (_builder("float32", JAdam(learning_rate=1e-2)).list()
             .layer(jl.FrozenLayer(inner=jl.GravesLSTM(n_in=5, n_out=16)))
             .layer(jl.GravesLSTM(n_in=16, n_out=16))
             .layer(jl.RnnOutputLayer(n_in=16, n_out=5, activation="softmax", loss="mcxent"))
             .build())
    jnet, net = _mln(jconf)
    calls = {"fwd": [], "bwd": 0, "fused": 0}
    real_fwd, real_bwd = lstm_cell.lstm_fwd, lstm_cell.lstm_bwd

    def fwd(*a, save_reserve=False, **k):
        calls["fwd"].append(save_reserve)
        return real_fwd(*a, save_reserve=save_reserve, **k)

    def bwd(*a, **k):
        calls["bwd"] += 1
        return real_bwd(*a, **k)

    def fused(*a, **k):
        calls["fused"] += 1
        raise AssertionError("the fused pair ran")
    monkeypatch.setattr(lstm_cell, "lstm_fwd", fwd)
    monkeypatch.setattr(lstm_cell, "lstm_bwd", bwd)
    monkeypatch.setattr(lstm_fused, "lstm_scan2", fused)
    rng = np.random.default_rng(5)
    f = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (4, 7))]
    l = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (4, 7))]
    x = torch.from_numpy(f)
    assert not net._lstm_pair_fusable(0, x, None, True)
    for _ in range(2):
        jnet.fit(JDataSet(f, l))
        net.fit(DataSet(f, l))
    assert calls == {"fwd": [False, True] * 2, "bwd": 2, "fused": 0}
    check_params(net, jnet)


# ------------------------------------------------------- gradient checks
def _f64_port(*layers, input_type=None):
    b = (JConf.builder().seed(12345).updater(JSgd(learning_rate=1.0)).dtype("float64")
         .compute_dtype("float64").activation("tanh").list())
    for layer in layers:
        b = b.layer(layer)
    if input_type is not None:
        b = b.set_input_type(input_type)
    return MultiLayerNetwork(MultiLayerConfiguration.from_json(b.build().to_json())).init(
        device="cpu")


def test_layer_gradient_checks():
    """The layer cases of ``tests/test_gradientcheck_extended.py`` on the
    port (f64): the embedding on integer input; a frozen layer's gradient
    exactly 0 and the rest checked; LossLayer after an ActivationLayer;
    Yolo2OutputLayer after a 1x1 convolution."""
    rng = np.random.default_rng(9)
    out3 = jl.OutputLayer(n_in=5, n_out=3, activation="softmax", loss="mcxent")
    net = _f64_port(jl.EmbeddingLayer(n_in=9, n_out=5), out3)
    f = rng.integers(0, 9, size=(6, 1)).astype(np.float64)
    assert GradientCheckUtil.check_gradients(net, DataSet(f, np.eye(3)[rng.integers(0, 3, 6)]),
                                             max_per_param=12)
    net = _f64_port(jl.FrozenLayer(inner=jl.DenseLayer(n_in=4, n_out=5)),
                    jl.DenseLayer(n_in=5, n_out=5), out3)
    ds = DataSet(rng.normal(size=(6, 4)), np.eye(3)[rng.integers(0, 3, 6)])
    grads, _ = net.compute_gradient_and_score(ds)
    assert all(float(v.abs().max()) == 0.0 for v in grads["0"].values())
    assert GradientCheckUtil.check_gradients(net, ds, max_per_param=12, exclude={"0/"})
    net = _f64_port(jl.DenseLayer(n_in=4, n_out=3), jl.ActivationLayer(activation="softmax"),
                    jl.LossLayer(loss="mcxent", activation="identity"))
    assert GradientCheckUtil.check_gradients(
        net, DataSet(rng.normal(size=(6, 4)), np.eye(3)[rng.integers(0, 3, 6)]),
        max_per_param=12)
    net = _f64_port(jl.ConvolutionLayer(n_out=2 * 5 + 2, kernel_size=(1, 1), stride=(1, 1)),
                    jl.Yolo2OutputLayer(boxes=[[1.0, 1.0], [2.0, 2.0]]),
                    input_type=JInputType.convolutional(3, 3, 4))
    labels = np.zeros((2, 6, 3, 3))
    for b in range(2):
        i, j = rng.integers(0, 3, 2)
        labels[b, :4, i, j] = [j + 0.2, i + 0.2, j + 0.8, i + 0.8]
        labels[b, 4 + rng.integers(0, 2), i, j] = 1.0
    assert GradientCheckUtil.check_gradients(net, DataSet(rng.normal(size=(2, 4, 3, 3)), labels),
                                             max_per_param=10, max_rel_error=5e-3)
