"""Remat (``GlobalConfig.remat``) in both containers of the port.

The JAX package's three pins of ``tests/test_remat.py`` on the port, then
the port's own: a fit step under remat "on" gives the same bits as without
it (losses, parameters and BatchNormalization's running statistics) in
both containers, with dropout and weight noise (each region replays its
generators), with the MoE TransformerLM (the auxiliary loss leaves its
region), with a TBPTT char-RNN (K1/K3's plain versions run again to
rebuild their reserve, ``lstm_fwd``/``lstm2_fwd`` counted) and with the
TransformerLM on the flash route (``fa._FORCE_SHORT_SEQ``: ``flash_fwd``
twice a layer a step, the backward once); "auto" leaves a recurrent net
as it was. Then the port against the JAX package with remat "on": a JAX
zip (configuration.json and weights) restored in the port, 3 fit steps in
each, losses within 1e-5 relative and parameters within 1e-5, the
training parity tests' f32 tolerances.
"""
import collections
import io

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import DataSet as JDataSet
from deeplearning4j_tpu import InputType as JInputType
from deeplearning4j_tpu import MultiLayerNetwork as JNet
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu import Sgd as JSgd
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.models import TransformerLM as JTransformerLM
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.utils.model_serializer import ModelSerializer as JSerializer

from deeplearning4j_torch import (Adam, BackpropType, DataSet, InputType, MultiDataSet,
                                  MultiLayerNetwork, NeuralNetConfiguration, Sgd)
from deeplearning4j_torch.models.zoo import TransformerLM
from deeplearning4j_torch.nn.conf import dropout as pdrop
from deeplearning4j_torch.nn.conf import layers as pl
from deeplearning4j_torch.nn.graph import ComputationGraph
from deeplearning4j_torch.nn.layers import base, impl_for
from deeplearning4j_torch.nn.layers.normalization import BatchNormImpl
from deeplearning4j_torch.ops import flash_attention as fa
from deeplearning4j_torch.ops import lstm_cell, lstm_fused
from deeplearning4j_torch.utils.model_serializer import restore_model

LOSS_RTOL = 1e-5
PARAM_ATOL_F32 = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _snapshot(net):
    """(score, flat parameters, layer state) after a fit."""
    states = {k: {n: t.clone() for n, t in v.items()} for k, v in net.states.items()}
    flat = torch.cat([p.detach().flatten().double() for p in net.parameters()])
    return float(net.score_), flat, states


def _assert_bitwise(off, on):
    assert off[0] == on[0]
    assert torch.equal(off[1], on[1])
    assert off[2].keys() == on[2].keys()
    for k in off[2]:
        for n in off[2][k]:
            assert torch.equal(off[2][k][n], on[2][k][n]), (k, n)


# --------------------------------------------------- the JAX package's pins
def _cnn_layers(L, weight_noise=None, dropout=None):
    kw = {} if weight_noise is None else {"weight_noise": weight_noise}
    return [L.ConvolutionLayer(n_out=4, kernel_size=(3, 3), **kw),
            L.BatchNormalization(),
            L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)),
            L.DenseLayer(n_out=16, **({} if dropout is None else {"dropout": dropout})),
            L.OutputLayer(n_out=3, activation="softmax", loss="mcxent")]


def _port_cnn(remat, graph=False, **kw):
    b = (NeuralNetConfiguration.builder().seed(9).updater(Sgd(learning_rate=0.05))
         .activation("relu").remat(remat))
    layers = _cnn_layers(pl, **kw)
    if not graph:
        lb = b.list()
        for layer in layers:
            lb = lb.layer(layer)
        return MultiLayerNetwork(lb.set_input_type(InputType.convolutional(10, 10, 1))
                                 .build()).init(device="cpu")
    g = b.graph_builder().add_inputs("in")
    prev = "in"
    for i, layer in enumerate(layers):
        g = g.add_layer(f"l{i}", layer, prev)
        prev = f"l{i}"
    conf = g.set_outputs(prev).set_input_types(InputType.convolutional(10, 10, 1)).build()
    return ComputationGraph(conf).init(device="cpu")


def _cnn_data(seed=0, b=8):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(b, 1, 10, 10)).astype(np.float32)
    l = np.eye(3, dtype=np.float32)[rng.integers(0, 3, b)]
    return f, l


@pytest.mark.parametrize("graph", [False, True], ids=["multilayer", "graph"])
def test_remat_on_equals_off_bitwise(graph):
    f, l = _cnn_data()
    snaps = {}
    for mode in ("off", "on"):
        net = _port_cnn(mode, graph=graph)
        for _ in range(3):
            net.fit(DataSet(f, l))
        snaps[mode] = _snapshot(net)
    _assert_bitwise(snaps["off"], snaps["on"])
    # BN's running statistics moved: the state the steps committed is compared
    key = "l1" if graph else "1"
    assert not torch.equal(snaps["on"][2][key]["mean"], torch.zeros(4))


def _impls(layers, gc):
    return [impl_for(c, gc) for c in layers]


def _gc(mode):
    return NeuralNetConfiguration.builder().remat(mode).list().layer(
        pl.DenseLayer(n_in=2, n_out=2)).build().global_conf


@pytest.mark.parametrize("layer,enabled", [
    (None, True),
    (lambda: pl.Bidirectional(inner=pl.LSTM(n_in=4, n_out=4)), False),
    (lambda: pl.LastTimeStep(inner=pl.LSTM(n_in=4, n_out=4)), False),
    (lambda: pl.FrozenLayer(inner=pl.GravesLSTM(n_in=4, n_out=4)), False),
    (lambda: pl.FrozenLayer(inner=pl.Bidirectional(inner=pl.SimpleRnn(n_in=4, n_out=4))), False),
    (lambda: pl.SimpleRnn(n_in=4, n_out=4), False),
    (lambda: pl.SelfAttentionLayer(n_in=4, n_out=4, num_heads=2), True),
    (lambda: pl.DenseLayer(n_in=4, n_out=4), True),
], ids=["conv", "bidirectional", "last-time-step", "frozen", "frozen-bidirectional",
        "simple-rnn", "attention", "dense"])
def test_remat_auto_excludes_recurrent(layer, enabled):
    gc = _gc("auto")
    conv = pl.ConvolutionLayer(n_in=4, n_out=4, kernel_size=(1, 1))
    layers = [conv] + ([] if layer is None else [layer()])
    assert base.remat_enabled(gc, _impls(layers, gc)) is enabled
    assert base.remat_enabled(_gc("on"), _impls(layers, gc))
    assert not base.remat_enabled(_gc("off"), _impls(layers, gc))
    if layer is not None:   # without a convolution "auto" stays off
        assert not base.remat_enabled(gc, _impls([layer()], gc))


def _lm_data(T=12, seed=4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 10, size=(2, T)).astype(np.float32)
    l = np.eye(10, dtype=np.float32)[np.roll(ids.astype(int), -1, axis=1)]
    return ids, l


def _fit_lm(mode, T=12, steps=3, **kw):
    ids, l = _lm_data(T)
    conf = TransformerLM(vocab_size=10, embed_dim=16, num_heads=2, num_blocks=2, seed=6,
                         **kw).conf()
    conf.global_conf.remat = mode
    net = ComputationGraph(conf).init(device="cpu")
    mds = MultiDataSet((ids,), (l,))
    for _ in range(steps):
        net.fit(mds)
    return _snapshot(net)


@pytest.mark.parametrize("kw", [{}, {"num_experts": 4}, {"dropout_rate": 0.1}],
                         ids=["dense", "moe", "attention-dropout"])
def test_remat_transformer_lm_bitwise(kw):
    _assert_bitwise(_fit_lm("off", **kw), _fit_lm("on", **kw))


# ------------------------------------------------------------- the port's
class _Calls:
    """Counts calls of module functions (the kernels' wrappers: on the CPU
    each call runs the plain version)."""

    def __init__(self, monkeypatch, *targets):
        self.n = collections.Counter()
        for mod, name in targets:
            orig = getattr(mod, name)

            def wrap(*a, _orig=orig, _name=name, **k):
                reserve = k.get("save_reserve", a[-1] if isinstance(a[-1], bool) else None)
                self.n[(_name, reserve)] += 1
                return _orig(*a, **k)
            monkeypatch.setattr(mod, name, wrap)


@pytest.mark.parametrize("graph", [False, True], ids=["multilayer", "graph"])
def test_remat_bitwise_with_dropout_and_weight_noise(graph):
    f, l = _cnn_data(seed=1)
    snaps = {}
    for mode in ("off", "on"):
        net = _port_cnn(mode, graph=graph, weight_noise=pdrop.DropConnect(p=0.8),
                        dropout=pdrop.GaussianDropout(rate=0.2))
        for _ in range(3):
            net.fit(DataSet(f, l))
        snaps[mode] = _snapshot(net) + (net._gen.get_state(),)
    _assert_bitwise(snaps["off"][:3], snaps["on"][:3])
    assert torch.equal(snaps["off"][3], snaps["on"][3])    # the step stream, too


def test_remat_recomputes_and_commits_state_once(monkeypatch):
    """Under "on" every layer's forward runs again in the backward (BN's
    too), while BN's new running statistics are committed once, from the
    first forward: after one step they are decay * init + (1 - decay) *
    batch statistics, as without remat."""
    calls = collections.Counter()
    orig = BatchNormImpl.forward

    def counted(self, *a, **k):
        calls[torch.is_grad_enabled()] += 1
        return orig(self, *a, **k)
    monkeypatch.setattr(BatchNormImpl, "forward", counted)
    f, l = _cnn_data(seed=2)
    snaps = {}
    for mode in ("off", "on"):
        calls.clear()
        net = _port_cnn(mode)
        net.fit(DataSet(f, l))
        snaps[mode] = (_snapshot(net), sum(calls.values()))
    assert snaps["off"][1] == 1 and snaps["on"][1] == 2
    _assert_bitwise(snaps["off"][0], snaps["on"][0])


def _char_rnn(mode, masked, H=16, V=8):
    conf = (NeuralNetConfiguration.builder().seed(3).updater(Adam(learning_rate=1e-2))
            .remat(mode).list()
            .layer(pl.GravesLSTM(n_in=V, n_out=H, activation="tanh", dropout=0.9))
            .layer(pl.GravesLSTM(n_in=H, n_out=H, activation="tanh"))
            .layer(pl.RnnOutputLayer(n_in=H, n_out=V, activation="softmax", loss="mcxent"))
            .backprop_type(BackpropType.TruncatedBPTT).t_bptt_forward_length(5)
            .t_bptt_backward_length(5).build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    rng = np.random.default_rng(0)
    f = np.eye(V, dtype=np.float32)[rng.integers(0, V, (4, 10))]
    l = np.eye(V, dtype=np.float32)[rng.integers(0, V, (4, 10))]
    mask = None
    if masked:
        mask = np.ones((4, 10), np.float32)
        mask[1, 7:] = 0
    return net, DataSet(f, l, mask, mask)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked-K3", "masked-K1"])
def test_remat_tbptt_char_rnn(masked, monkeypatch):
    """2 fits of 2 TBPTT segments. "on": the pair's forward (K3's plain
    version, with the reserve) twice a segment and its backward once;
    masked, each layer's forward (K1's) twice a segment. "auto" (no
    convolution) is the step without remat, counts included."""
    calls = _Calls(monkeypatch, (lstm_cell, "lstm_fwd"), (lstm_cell, "lstm_bwd"),
                   (lstm_fused, "lstm2_fwd"), (lstm_fused, "lstm2_bwd"))
    snaps, counts = {}, {}
    for mode in ("off", "on", "auto"):
        calls.n.clear()
        net, ds = _char_rnn(mode, masked)
        net.fit(ds)
        net.fit(ds)
        snaps[mode], counts[mode] = _snapshot(net), dict(calls.n)
    _assert_bitwise(snaps["off"], snaps["on"])
    _assert_bitwise(snaps["off"], snaps["auto"])
    assert counts["auto"] == counts["off"]
    if masked:
        assert counts["off"] == {("lstm_fwd", True): 8, ("lstm_bwd", None): 8}
        assert counts["on"] == {("lstm_fwd", True): 16, ("lstm_bwd", None): 8}
    else:
        assert counts["off"] == {("lstm2_fwd", True): 4, ("lstm2_bwd", None): 4}
        assert counts["on"] == {("lstm2_fwd", True): 8, ("lstm2_bwd", None): 4}


@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["flash", "flash-dropout"])
def test_remat_transformer_lm_flash_route(dropout, monkeypatch):
    """T=256 with ``_FORCE_SHORT_SEQ``: 2 blocks, 3 steps. The forward runs
    again in each attention region's recompute (with its keep bits: the
    dropout case is bitwise too); dq and dk/dv once a step."""
    monkeypatch.setattr(fa, "_FORCE_SHORT_SEQ", True)
    calls = _Calls(monkeypatch, (fa, "flash_fwd"), (fa, "dq_block"), (fa, "dkv_block"))
    snaps, counts = {}, {}
    for mode in ("off", "on"):
        calls.n.clear()
        snaps[mode] = _fit_lm(mode, T=256, dropout_rate=dropout)
        counts[mode] = {k[0]: v for k, v in calls.n.items()}
    _assert_bitwise(snaps["off"], snaps["on"])
    assert counts["off"] == {"flash_fwd": 6, "dq_block": 6, "dkv_block": 6}
    assert counts["on"] == {"flash_fwd": 12, "dq_block": 6, "dkv_block": 6}


# --------------------------------------------- port against JAX, remat "on"
def _jax_zip(jnet):
    buf = io.BytesIO()
    JSerializer.write_model(jnet, buf, save_updater=True)
    buf.seek(0)
    return buf


def test_port_matches_jax_under_remat_on_multilayer(tmp_path):
    jconf = (JConf.builder().seed(9).updater(JSgd(learning_rate=0.05)).activation("tanh")
             .remat("on").list()
             .layer(jl.ConvolutionLayer(n_out=4, kernel_size=(3, 3)))
             .layer(jl.BatchNormalization())
             .layer(jl.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                        pooling_type="avg"))
             .layer(jl.DenseLayer(n_out=16))
             .layer(jl.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
             .set_input_type(JInputType.convolutional(10, 10, 1)).build())
    jnet = JNet(jconf).init()
    path = tmp_path / "m.zip"
    path.write_bytes(_jax_zip(jnet).getvalue())
    net = restore_model(str(path), device="cpu")
    assert net.gc.remat == "on" and base.remat_enabled(net.gc, net.impls)
    f, l = _cnn_data(seed=5)
    for step in range(3):
        jnet.fit(JDataSet(f, l))
        net.fit(DataSet(f, l))
        assert float(net.score_) == pytest.approx(float(jnet.score_), rel=LOSS_RTOL), step
    for i, ps in jnet.params.items():
        for k, v in ps.items():
            np.testing.assert_allclose(net.params[i][k].numpy(), np.asarray(v), rtol=0,
                                       atol=PARAM_ATOL_F32, err_msg=f"{i}/{k}")
    for k in ("mean", "var"):
        np.testing.assert_allclose(net.states["1"][k].numpy(), np.asarray(jnet.states["1"][k]),
                                   rtol=0, atol=PARAM_ATOL_F32)


def test_port_matches_jax_under_remat_on_transformer_lm(tmp_path):
    jconf = JTransformerLM(vocab_size=10, embed_dim=16, num_heads=2, num_blocks=2,
                           seed=6).conf()
    jconf.global_conf.remat = "on"
    jnet = JGraph(jconf).init()
    path = tmp_path / "lm.zip"
    path.write_bytes(_jax_zip(jnet).getvalue())
    net = restore_model(str(path), device="cpu")
    assert net.gc.remat == "on"
    ids, l = _lm_data(seed=7)
    for step in range(3):
        jnet.fit(JMultiDataSet((ids,), (l,)))
        net.fit(MultiDataSet((ids,), (l,)))
        assert float(net.score_) == pytest.approx(float(jnet.score_), rel=LOSS_RTOL), step
    for name, ps in jnet.params.items():
        for k, v in ps.items():
            np.testing.assert_allclose(net.params[name][k].numpy(), np.asarray(v), rtol=0,
                                       atol=PARAM_ATOL_F32, err_msg=f"{name}/{k}")
