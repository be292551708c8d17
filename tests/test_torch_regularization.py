"""Dropout objects, weight noise and constraints in training, against the
JAX package.

The port draws from ``torch.Generator`` streams and the JAX package from
threefry keys, so every comparison replays the port's draws in JAX
(``_Replay``): the port records each ``nn/conf/dropout.bernoulli``/
``normal`` draw, grouped by training forward (a ``StepGenerators`` with a
generator starts one), and JAX's ``jax.random.bernoulli``/``normal`` take
them from a host callback (``jax.pure_callback``, so that one compiled step
gets fresh draws at each execution). A draw site of JAX's trace is matched
to the port's draw at the same position of a forward: per layer the
weight noise (parameters in sorted key order) and then the input dropout,
the output layer's dropout last. Every replayed draw's shape is checked.

Held: each dropout, noise and constraint object (f32 and bf16); the cases
of ``tests/test_regularization.py`` one by one, each also against JAX's
parameters; a Dense -> GravesLSTM pair -> RnnOutputLayer network and a
graph with a self-attention layer fitted 3 steps with dropout, DropConnect
and MaxNorm; the pair fusion under dropout and noise; ``score(training=
True)``, ``compute_gradient_and_score`` and ``fit_external_errors`` of
dropout nets (no draws, as in JAX); JAX zips holding every object,
DropoutLayer and the builder's knobs, restored and written back.

Tolerances: f32 objects 1e-6 relative (the same elementwise arithmetic);
bf16 objects bit-equal (scalars rounded to bf16 as JAX's weak types are);
f32 networks' parameters after their steps 1e-5 absolute (another
summation order); bf16 networks' one bf16 unit (2^-8) of the layer's
largest parameter entry. A layer's scale, not each parameter's own: the
JAX package on the CPU sums a bias's bf16 cotangent in bf16 (measured
here: dense and output biases 0.5-1.5% of their own largest entry apart,
0.2% of the layer's), and peepholes start at 0 and move by 1e-3, so their
own scale is rounding; weights stay within 5e-4 of their own largest
entry.
"""
import io
import json
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu import Sgd as JSgd
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.conf import dropout as jdrop
from deeplearning4j_tpu.nn.conf import inputs as jinputs
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.conf import preprocessors as jpre
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.utils.model_serializer import ModelSerializer as JSerializer

from deeplearning4j_torch import DataSet
from deeplearning4j_torch.nn.conf import ComputationGraphConfiguration, MultiLayerConfiguration
from deeplearning4j_torch.nn.conf import dropout as pdrop
from deeplearning4j_torch.nn.graph import ComputationGraph
from deeplearning4j_torch.nn.layers.base import StepGenerators
from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_torch.ops import lstm_cell, lstm_fused
from deeplearning4j_torch.nn.conf import preprocessors as ppre
from deeplearning4j_torch.utils.model_serializer import (COEFFICIENTS_BIN, CONFIG_JSON,
                                                         UPDATER_BIN, restore_model,
                                                         write_model)

OBJ_RTOL = 1e-6
PARAM_ATOL_F32 = 1e-5
BF16_UNIT = 2.0 ** -8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


class _Replay:
    """The port's draws recorded, and replayed in JAX once ``arm`` is
    called (the JAX nets draw their weights before that)."""

    def __init__(self, monkeypatch):
        self.steps = []
        self.sites = 0
        self.used = {}
        self.armed = False
        for name in ("bernoulli", "normal"):
            monkeypatch.setattr(pdrop, name, self._recording(getattr(pdrop, name)))
        real_init = StepGenerators.__init__

        def init(sg, gen):
            real_init(sg, gen)
            if gen is not None:
                self.steps.append([])
        monkeypatch.setattr(StepGenerators, "__init__", init)
        self.real = {n: getattr(jax.random, n) for n in ("bernoulli", "normal")}
        monkeypatch.setattr(jax.random, "bernoulli", self._bernoulli)
        monkeypatch.setattr(jax.random, "normal", self._normal)

    def arm(self):
        self.armed = True
        return self

    def _recording(self, real):
        def draw(*a, **k):
            out = real(*a, **k)
            if not self.steps:
                self.steps.append([])
            self.steps[-1].append(out.detach().cpu())
            return out
        return draw

    def _pop(self, site, shape):
        per_step = len(self.steps[0])
        k = site % per_step
        j = self.used.get(k, 0)
        self.used[k] = j + 1
        got = self.steps[j][k]
        assert tuple(got.shape) == tuple(shape), (site, tuple(got.shape), tuple(shape))
        return got

    def _site(self):
        self.sites += 1
        return self.sites - 1

    def _bernoulli(self, key, p=0.5, shape=None, **kw):
        if not self.armed:
            return self.real["bernoulli"](key, p, shape, **kw)
        site = self._site()
        keep = jax.pure_callback(
            lambda key: self._pop(site, shape).numpy().astype(np.uint8),
            jax.ShapeDtypeStruct(tuple(shape), jnp.uint8), key)
        return keep.astype(bool)

    def _normal(self, key, shape=(), dtype=jnp.float32, **kw):
        if not self.armed:
            return self.real["normal"](key, shape, dtype, **kw)
        site = self._site()
        z = jax.pure_callback(
            lambda key: self._pop(site, shape).float().numpy(),
            jax.ShapeDtypeStruct(tuple(shape), jnp.float32), key)
        return z.astype(dtype)


def _np(t):
    return t.detach().float().cpu().numpy()


def _jnp_in(x, dtype):
    return jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


# ------------------------------------------------------------------- objects
@pytest.mark.parametrize("name,args", [("Dropout", (0.8,)), ("AlphaDropout", (0.9,)),
                                        ("GaussianDropout", (0.3,)),
                                        ("GaussianNoise", (0.2,))])
def test_dropout_objects_against_jax(monkeypatch, name, args):
    """Each dropout object on f32 and bf16 activations: the port's result
    equals JAX's on the port's draws; inference and a missing generator
    are the identity, training is not (``test_dropout_objects_train_vs_
    inference``)."""
    obj, jobj = getattr(pdrop, name)(*args), getattr(jdrop, name)(*args)
    rp = _Replay(monkeypatch).arm()
    x = np.random.default_rng(0).normal(size=(64, 32)).astype(np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).to(dtype)
        assert obj.apply(xt, None, True) is xt and obj.apply(xt, torch.Generator(), False) is xt
        rp.steps, rp.used = [], {}
        y = obj.apply(xt, torch.Generator().manual_seed(1), True)
        assert y.dtype == dtype and not torch.equal(y, xt)
        want = np.asarray(jobj.apply(_jnp_in(x, dtype), jax.random.PRNGKey(0), True),
                          np.float32)
        if dtype == torch.float32:
            np.testing.assert_allclose(_np(y), want, rtol=OBJ_RTOL, atol=OBJ_RTOL)
        else:
            np.testing.assert_array_equal(_np(y), want)


def test_dropout_preserves_expectation():
    y = pdrop.Dropout(0.5).apply(torch.ones((200, 200)), torch.Generator().manual_seed(1), True)
    assert abs(float(y.mean()) - 1.0) < 0.02    # inverted dropout keeps E[x]


@pytest.mark.parametrize("name,kw", [("DropConnect", {"p": 0.7}),
                                      ("WeightNoise", {"stddev": 0.05}),
                                      ("WeightNoise", {"stddev": 0.05, "additive": False,
                                                       "apply_to_bias": True})])
def test_weight_noise_objects_against_jax(monkeypatch, name, kw):
    """DropConnect and WeightNoise on weights and on the keys the JAX
    package skips as biases (every key starting with "b", so "beta" too)
    unless ``apply_to_bias``."""
    obj, jobj = getattr(pdrop, name)(**kw), getattr(jdrop, name)(**kw)
    rp = _Replay(monkeypatch).arm()
    rng = np.random.default_rng(1)
    for key in ("W", "RW", "pi", "b", "beta"):
        w = rng.normal(size=(6, 5) if key.isupper() else (5,)).astype(np.float32)
        rp.steps, rp.used = [], {}
        got = obj.apply_to_weights(torch.from_numpy(w), key, torch.Generator().manual_seed(2),
                                   True)
        want = np.asarray(jobj.apply_to_weights(jnp.asarray(w), key, jax.random.PRNGKey(0),
                                                True))
        np.testing.assert_allclose(_np(got), want, rtol=OBJ_RTOL, atol=OBJ_RTOL)
        skipped = key.startswith("b") and not kw.get("apply_to_bias")
        assert np.array_equal(_np(got), w) == skipped, key
        wt = torch.from_numpy(w)
        assert obj.apply_to_weights(wt, key, None, True) is wt


def test_constraints_against_jax():
    """Every constraint on a dense weight, a conv kernel (HWIO: norms over
    all axes but the last), a peephole vector (axis 0) and the bias keys
    ("b", "*_b", "beta": left alone unless ``apply_to_bias``), through
    ``apply_constraints`` in order."""
    rng = np.random.default_rng(2)
    params = {"W": rng.normal(size=(6, 5)), "K": rng.normal(size=(3, 3, 2, 4)),
              "pi": rng.normal(size=(5,)), "b": rng.normal(size=(5,)),
              "x_b": rng.normal(size=(5,)), "beta": rng.normal(size=(5,))}
    params = {k: v.astype(np.float32) * 2 for k, v in params.items()}
    cases = [("MaxNormConstraint", {"max_norm": 1.5}),
             ("MinMaxNormConstraint", {"min_norm": 2.5, "max_norm": 3.0, "rate": 0.7}),
             ("NonNegativeConstraint", {}), ("UnitNormConstraint", {})]
    for name, kw in cases:
        for to_bias in (False, True):
            c, jc = getattr(pdrop, name)(**kw), getattr(jdrop, name)(**kw)
            c.apply_to_bias = jc.apply_to_bias = to_bias
            chain = [c, pdrop.MaxNormConstraint(2.0)]
            jchain = [jc, jdrop.MaxNormConstraint(2.0)]
            got = pdrop.apply_constraints(chain, {k: torch.from_numpy(v)
                                                  for k, v in params.items()})
            want = jdrop.apply_constraints(jchain, {k: jnp.asarray(v)
                                                    for k, v in params.items()})
            for k in params:
                np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=OBJ_RTOL,
                                           atol=OBJ_RTOL, err_msg=f"{name} {k}")
                if k in ("b", "x_b", "beta") and not to_bias:
                    np.testing.assert_array_equal(_np(got[k]), np.asarray(params[k] * 1))
    assert pdrop.apply_constraints(None, params) is params


# ------------------------------------------------- tests/test_regularization
def _jconf(layer0=None, out=None, lr=0.1, compute="float32"):
    return (JConf.builder().seed(3).updater(JSgd(learning_rate=lr)).activation("tanh")
            .compute_dtype(compute).list()
            .layer(jlayers.DenseLayer(n_in=6, n_out=12, **(layer0 or {})))
            .layer(jlayers.OutputLayer(n_in=12, n_out=3, activation="softmax", loss="mcxent",
                                       **(out or {})))
            .build())


def _mln_pair(jconf):
    """(JAX network, port network on the CPU): one configuration, one set of
    weights."""
    jnet = JNet(jconf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(jconf.to_json())).init(
        params={k: {n: np.array(v) for n, v in d.items()} for k, d in jnet.params.items()},
        device="cpu")
    return jnet, net


def _graph_pair(jconf):
    jnet = JGraph(jconf).init()
    net = ComputationGraph(ComputationGraphConfiguration.from_json(jconf.to_json())).init(
        params={k: {n: np.array(v) for n, v in d.items()} for k, d in jnet.params.items()},
        device="cpu")
    return jnet, net


def _ds(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(16, 6)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)])


def _check_params(net, jnet, compute="float32"):
    for k, ps in jnet.params.items():
        scale = max((float(np.abs(np.asarray(p, np.float32)).max()) for p in ps.values()),
                    default=0.0)
        for n, p in ps.items():
            want = np.asarray(p, np.float32)
            atol = PARAM_ATOL_F32 if compute == "float32" else BF16_UNIT * scale
            np.testing.assert_allclose(_np(net.params[k][n]), want, rtol=0, atol=atol,
                                       err_msg=f"{k}/{n}")


def _fit_both(net, jnet, f, l, steps, rp=None):
    """``steps`` single-batch fits of each, interleaved."""
    if rp is not None:
        rp.arm()
    for _ in range(steps):
        net.fit(DataSet(f, l))
        jnet.fit(JDataSet(f, l))


@pytest.mark.parametrize("case", ["alpha_dropout_trains", "dropconnect_inference_fixed",
                                  "weight_noise_trains"])
def test_noisy_nets_train_like_jax(monkeypatch, case):
    """``test_network_trains_with_dropout_objects`` (AlphaDropout on the
    output layer, 10 fits, score falls), ``test_dropconnect_changes_
    training_path_only`` (inference deterministic, a fit finite) and
    ``test_weight_noise_trains`` (10 fits, score falls), each also against
    JAX's parameters on the port's draws."""
    layer0, out, fits = {
        "alpha_dropout_trains": ({}, {"dropout": "AlphaDropout"}, 10),
        "dropconnect_inference_fixed": ({"weight_noise": "DropConnect"}, {}, 1),
        "weight_noise_trains": ({"weight_noise": "WeightNoise"}, {}, 10)}[case]
    make = {"AlphaDropout": lambda m: m.AlphaDropout(0.9),
            "DropConnect": lambda m: m.DropConnect(p=0.7),
            "WeightNoise": lambda m: m.WeightNoise(stddev=0.05)}
    jl0 = {k: make[v](jdrop) for k, v in layer0.items()}
    jout = {k: make[v](jdrop) for k, v in out.items()}
    rp = _Replay(monkeypatch)
    jnet, net = _mln_pair(_jconf(jl0, jout))
    f, l = _ds()
    s0 = net.score(DataSet(f, l))
    out1, out2 = net.output(f), net.output(f)
    assert torch.equal(out1, out2)
    _fit_both(net, jnet, f, l, fits, rp)
    assert np.isfinite(float(net.score_))
    if fits > 1:
        assert net.score(DataSet(f, l)) < s0
    _check_params(net, jnet)
    assert len(rp.steps) == fits and rp.sites == len(rp.steps[0])


@pytest.mark.parametrize("name,kw,lr,fits", [
    ("MaxNormConstraint", {"max_norm": 0.5}, 1.0, 5),
    ("NonNegativeConstraint", {}, 0.5, 3),
    ("UnitNormConstraint", {}, 0.1, 1),
    ("MinMaxNormConstraint", {"min_norm": 0.3, "max_norm": 0.6}, 1.0, 5)])
def test_constraint_nets_like_jax(name, kw, lr, fits):
    """``test_max_norm_constraint_enforced``, ``test_non_negative_
    constraint``, ``test_unit_norm_constraint`` and ``test_min_max_norm_
    constraint``: the property on layer 0's W after the fits (biases
    unconstrained), and every parameter against JAX's."""
    jnet, net = _mln_pair(_jconf({"constraints": [getattr(jdrop, name)(**kw)]}, lr=lr))
    f, l = _ds()
    _fit_both(net, jnet, f, l, fits)
    W = _np(net.params["0"]["W"])
    norms = np.linalg.norm(W, axis=0)
    if name == "MaxNormConstraint":
        assert np.all(norms <= 0.5 + 1e-5) and "b" in net.params["0"]
    elif name == "NonNegativeConstraint":
        assert np.all(W >= 0.0)
    elif name == "UnitNormConstraint":
        np.testing.assert_allclose(norms, 1.0, rtol=1e-5)
    else:
        assert np.all(norms <= 0.6 + 1e-5) and np.all(norms >= 0.3 - 1e-5)
    _check_params(net, jnet)


# ---------------------------------------------------------- whole networks
def _lstm_jconf(compute, pair_dropout=None, noise=True):
    """Dense -> GravesLSTM -> GravesLSTM -> RnnOutputLayer over [b, T, 5]:
    dropout on the Dense and the output, DropConnect on the first LSTM,
    MaxNorm on both LSTMs."""
    pair_dropout = pair_dropout or {}
    return (JConf.builder().seed(5).updater(JSgd(learning_rate=0.1)).activation("tanh")
            .compute_dtype(compute).list()
            .layer(jlayers.DenseLayer(n_out=8, dropout=jdrop.Dropout(0.8)))
            .layer(jlayers.GravesLSTM(n_out=8, dropout=pair_dropout.get(0),
                                      weight_noise=jdrop.DropConnect(0.9) if noise else None,
                                      constraints=[jdrop.MaxNormConstraint(0.8)]))
            .layer(jlayers.GravesLSTM(n_out=8, dropout=pair_dropout.get(1),
                                      constraints=[jdrop.MaxNormConstraint(0.8)]))
            .layer(jlayers.RnnOutputLayer(n_out=5, activation="softmax", loss="mcxent",
                                          dropout=0.9))
            .set_input_type(jinputs.InputType.recurrent(5)).build())


def _seq(seed=3, b=4, t=6, v=5):
    rng = np.random.default_rng(seed)
    eye = np.eye(v, dtype=np.float32)
    ids = rng.integers(0, v, (b, t + 1))
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_lstm_network_three_steps_match_jax(monkeypatch, compute):
    """The Dense -> GravesLSTM pair -> RnnOutputLayer network with dropout,
    DropConnect and MaxNorm: parameters after 3 SGD steps equal JAX's
    (f32 1e-5; bf16 one bf16 unit of the layer's largest entry), and the
    constraint holds on both LSTMs."""
    rp = _Replay(monkeypatch)
    jnet, net = _mln_pair(_lstm_jconf(compute))
    f, l = _seq()
    _fit_both(net, jnet, f, l, 3, rp)
    _check_params(net, jnet, compute)
    for k in ("1", "2"):
        assert np.linalg.norm(_np(net.params[k]["RW"]), axis=0).max() <= 0.8 + 1e-5


def _attention_jconf(compute):
    b = JConf.builder().seed(9).updater(JSgd(learning_rate=0.1)).compute_dtype(compute)
    return (b.graph_builder().add_inputs("in")
            .add_layer("proj", jlayers.DenseLayer(n_out=8, activation="tanh",
                                                  weight_noise=jdrop.DropConnect(0.9)), "in")
            .add_layer("attn", jlayers.SelfAttentionLayer(
                n_out=8, num_heads=2, activation="identity", dropout=jdrop.Dropout(0.85),
                constraints=[jdrop.MaxNormConstraint(0.7)]), "proj")
            .add_layer("out", jlayers.RnnOutputLayer(n_out=5, activation="softmax",
                                                     loss="mcxent",
                                                     dropout=jdrop.GaussianNoise(0.1)), "attn")
            .set_outputs("out").set_input_types(jinputs.InputType.recurrent(5)).build())


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_attention_graph_three_steps_match_jax(monkeypatch, compute):
    """A graph Dense(DropConnect) -> SelfAttention(Dropout, MaxNorm) ->
    RnnOutputLayer(GaussianNoise): parameters after 3 SGD steps equal
    JAX's (f32 1e-5; bf16 one bf16 unit of the layer's largest entry)."""
    rp = _Replay(monkeypatch)
    jnet, net = _graph_pair(_attention_jconf(compute))
    f, l = _seq(4, t=8)
    _fit_both(net, jnet, f, l, 3, rp)
    _check_params(net, jnet, compute)
    assert np.linalg.norm(_np(net.params["attn"]["Wq"]), axis=0).max() <= 0.7 + 1e-5


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(module, name, spy)
    return calls


def test_pair_fusion_under_dropout_and_noise(monkeypatch):
    """``_lstm_pair_fusable`` keeps its rule (JAX ``multilayer.py:316-
    322``): dropout on the pair's first layer keeps the fused launch (its
    dropout before the hoisted projection), dropout on the second or weight
    noise on either splits the pair in training only. With the routes
    stubbed to a card without a grid nothing fuses. The fused fit with
    layer-0 dropout matches JAX on the port's draws."""
    cases = {"dropout on 0": ({0: jdrop.Dropout(0.8)}, False, True),
             "dropout on 1": ({1: jdrop.Dropout(0.8)}, False, False),
             "noise on 0": ({}, True, False)}
    x = torch.zeros((4, 6, 8))
    for label, (drop, noise, fused) in cases.items():
        _, net = _mln_pair(_lstm_jconf("float32", drop, noise))
        assert net._lstm_pair_fusable(1, x, None, train=False), label
        assert net._lstm_pair_fusable(1, x, None, train=True) == fused, label
    rp = _Replay(monkeypatch)
    jnet, net = _mln_pair(_lstm_jconf("float32", {0: jdrop.Dropout(0.8)}, False))
    fused_calls = _spy(monkeypatch, lstm_fused, "lstm_scan2")
    layer_calls = _spy(monkeypatch, lstm_cell, "lstm_scan")
    f, l = _seq()
    _fit_both(net, jnet, f, l, 3, rp)
    assert len(fused_calls) == 3 and not layer_calls
    _check_params(net, jnet)
    with monkeypatch.context() as m:
        m.setattr(lstm_fused, "fwd_route", lambda *a, **k: (False, 0))
        assert not net._lstm_pair_fusable(1, x, None, train=False)


def test_score_gradient_and_external_errors_draw_nothing(monkeypatch):
    """``score(training=True)``, ``compute_gradient_and_score`` (both
    containers) and ``fit_external_errors`` of dropout and noise nets run
    without dropout or noise, as in the JAX package (``rng=None``), and
    equal JAX's: they raised before."""
    drawn = (_spy(monkeypatch, pdrop, "bernoulli"), _spy(monkeypatch, pdrop, "normal"))
    jnet, net = _mln_pair(_lstm_jconf("float32"))
    f, l = _seq()
    ds, jds = DataSet(f, l), JDataSet(f, l)
    assert net.score(ds, training=True) == pytest.approx(jnet.score(jds, training=True),
                                                         rel=1e-5)
    grads, score = net.compute_gradient_and_score(ds)
    jgrads, jscore = jnet.compute_gradient_and_score(jds)
    assert score == pytest.approx(jscore, rel=1e-5)
    for k, gs in jgrads.items():
        for n, g in gs.items():
            g = np.asarray(g)
            np.testing.assert_allclose(_np(grads[k][n]), g, rtol=0,
                                       atol=1e-4 * np.abs(g).max(), err_msg=f"{k}/{n}")
    jg, g = _graph_pair(_attention_jconf("float32"))
    f, l = _seq(4, t=8)
    assert g.score(DataSet(f, l), training=True) == pytest.approx(
        jg.score(JDataSet(f, l), training=True), rel=1e-5)
    assert g.compute_gradient_and_score(DataSet(f, l))[1] == pytest.approx(
        jg.compute_gradient_and_score(JDataSet(f, l))[1], rel=1e-5)
    eps = np.random.default_rng(5).normal(size=(4, 8, 5)).astype(np.float32)
    g.fit_external_errors(f, eps)
    jg.fit_external_errors(f, eps)
    _check_params(g, jg)
    assert drawn == ([], [])


# -------------------------------------------------------------- persistence
def _every_object_jconf(pre=None):
    return (JConf.builder().seed(2).updater(JSgd(learning_rate=0.1)).activation("tanh")
            .optimization_algo("lbfgs").max_num_line_search_iterations(7).mini_batch(False)
            .training_workspace_mode("separate").inference_workspace_mode("single")
            .remat("auto").list()
            .layer(jlayers.DenseLayer(n_in=6, n_out=8, dropout=jdrop.AlphaDropout(0.9),
                                      weight_noise=jdrop.WeightNoise(0.02, False, True),
                                      constraints=[jdrop.MinMaxNormConstraint(0.1, 2.0, 0.5),
                                                   jdrop.NonNegativeConstraint()]))
            .layer(jlayers.DropoutLayer(dropout=jdrop.GaussianDropout(0.2)))
            .layer(jlayers.DenseLayer(n_in=8, n_out=8, dropout=jdrop.GaussianNoise(0.05),
                                      weight_noise=jdrop.DropConnect(0.8, True),
                                      constraints=[jdrop.UnitNormConstraint(),
                                                   jdrop.MaxNormConstraint(1.5)]))
            .layer(jlayers.OutputLayer(n_in=8, n_out=3, activation="softmax", loss="mcxent",
                                       dropout=jdrop.Dropout(0.7)))
            .input_preprocessor(0, pre or jpre.CnnToFeedForwardPreProcessor(2, 3, 1))
            .backprop(True).pretrain(False).build())


def test_zip_with_every_object_round_trips(tmp_path, monkeypatch):
    """A JAX zip whose configuration holds every dropout, noise and
    constraint object, a DropoutLayer and every builder knob the port
    lacked restores in the port, writes back the same configuration.json
    and arrays, and trains (one step against JAX's on the port's draws);
    the port's builder makes the same JSON as the JAX builder."""
    jconf = _every_object_jconf(jpre.RnnToFeedForwardPreProcessor())
    jnet = JNet(jconf).init()
    jpath, ppath = tmp_path / "j.zip", tmp_path / "p.zip"
    JSerializer.write_model(jnet, str(jpath))
    net = restore_model(str(jpath), device="cpu")
    write_model(net, str(ppath))
    with zipfile.ZipFile(jpath) as zj, zipfile.ZipFile(ppath) as zp:
        assert json.loads(zp.read(CONFIG_JSON)) == json.loads(zj.read(CONFIG_JSON))
        for member in (COEFFICIENTS_BIN, UPDATER_BIN):
            a, b = (np.load(io.BytesIO(z.read(member))) for z in (zj, zp))
            assert set(a.files) == set(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
    gc = net.conf.global_conf
    assert (gc.optimization_algo, gc.max_num_line_search_iterations, gc.mini_batch, gc.remat,
            gc.training_workspace_mode) == ("lbfgs", 7, False, "auto", "separate")
    assert net.conf.to_json() == jconf.to_json()
    rp = _Replay(monkeypatch)
    jnet2, net2 = _mln_pair(jconf)
    f, l = _ds()
    _fit_both(net2, jnet2, f[:, None, :], l, 1, rp)
    _check_params(net2, jnet2)


def test_port_builder_writes_the_jax_json():
    """The port's builder, with the same calls, writes the JAX builder's
    JSON byte for byte, and a graph with ``input_preprocessor`` decodes."""
    from deeplearning4j_torch import NeuralNetConfiguration, Sgd
    from deeplearning4j_torch.nn.conf import InputType
    from deeplearning4j_torch.nn.conf import layers as players

    conf = (NeuralNetConfiguration.builder().seed(2).updater(Sgd(learning_rate=0.1))
            .activation("tanh").optimizationAlgo("lbfgs").maxNumLineSearchIterations(7)
            .miniBatch(False).trainingWorkspaceMode("separate")
            .inferenceWorkspaceMode("single").remat("auto").list()
            .layer(players.DenseLayer(n_in=6, n_out=8, dropout=pdrop.AlphaDropout(0.9),
                                      weight_noise=pdrop.WeightNoise(0.02, False, True),
                                      constraints=[pdrop.MinMaxNormConstraint(0.1, 2.0, 0.5),
                                                   pdrop.NonNegativeConstraint()]))
            .layer(players.DropoutLayer(dropout=pdrop.GaussianDropout(0.2)))
            .layer(players.DenseLayer(n_in=8, n_out=8, dropout=pdrop.GaussianNoise(0.05),
                                      weight_noise=pdrop.DropConnect(0.8, True),
                                      constraints=[pdrop.UnitNormConstraint(),
                                                   pdrop.MaxNormConstraint(1.5)]))
            .layer(players.OutputLayer(n_in=8, n_out=3, activation="softmax", loss="mcxent",
                                       dropout=pdrop.Dropout(0.7)))
            .inputPreProcessor(0, ppre.CnnToFeedForwardPreProcessor(2, 3, 1))
            .backprop(True).pretrain(False).build())
    jconf = _every_object_jconf()
    assert conf.to_json() == jconf.to_json()
    assert conf.clone().to_json() == conf.to_json() and conf.clone() is not conf
    jg = (JConf.builder().seed(1).graph_builder().add_inputs("in")
          .add_layer("d", jlayers.DenseLayer(n_out=4), "in",
                     preprocessor=jpre.CnnToFeedForwardPreProcessor(1, 3, 1))
          .add_layer("o", jlayers.OutputLayer(n_out=2, loss="mse"), "d")
          .input_preprocessor("o", jpre.CnnToFeedForwardPreProcessor(2, 2, 1))
          .set_outputs("o").set_input_types(jinputs.InputTypeFeedForward(3)).build())
    pg = (NeuralNetConfiguration.builder().seed(1).graphBuilder().addInputs("in")
          .addLayer("d", players.DenseLayer(n_out=4), "in",
                    preprocessor=ppre.CnnToFeedForwardPreProcessor(1, 3, 1))
          .addLayer("o", players.OutputLayer(n_out=2, loss="mse"), "d")
          .inputPreProcessor("o", ppre.CnnToFeedForwardPreProcessor(2, 2, 1))
          .setOutputs("o").setInputTypes(InputType.feed_forward(3)).build())
    assert pg.to_json() == jg.to_json()
