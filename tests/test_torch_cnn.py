"""The CNN layers of the port on the CPU, against the JAX package.

Each layer config is built in the JAX package, carried to the port through
its JSON, and given the same parameters (perturbed from their init) and
state in both packages. Forwards and their vector-Jacobian products (one
seeded cotangent, through ``jax.vjp`` and autograd) are compared layer by
layer: convolutions under Same at stride 1 and 2 on even and odd sizes (the
asymmetric (0, 1) and (2, 3) pads among them) and under Truncate with
padding and dilation; every pooling type under Same and Truncate; global
pooling on 4-D and masked 3-D input; BatchNormalization in training and
inference; ActivationLayer; both preprocessors. Small networks then hold
the NCHW adapter, the preprocessors inside a network and BatchNormalization's
running statistics after fit steps against the JAX package, and check that
neither container commits state outside a fit step.

Tolerances, as max |port - jax| over max |jax| (scores relative): f32 1e-5
on outputs and scores, 1e-4 on gradients and on running statistics; bf16
3e-2 on outputs, gradients and statistics (one bf16 unit is 2^-8 of a
value, and the two frameworks round at different places), 2e-3 on scores.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu import Adam as JAdam
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import GlobalConfig as JGlobalConfig
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf import preprocessors as jpre
from deeplearning4j_tpu.nn.conf import serde as jserde
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers.base import impl_for as jimpl_for
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet

from deeplearning4j_torch import DataSet
from deeplearning4j_torch.nn.conf import (ComputationGraphConfiguration, GlobalConfig,
                                          MultiLayerConfiguration, serde)
from deeplearning4j_torch.nn.conf import preprocessors as pre
from deeplearning4j_torch.nn.graph import ComputationGraph
from deeplearning4j_torch.nn.layers import impl_for
from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_torch.utils.model_serializer import params_from_numpy, states_from_numpy

OUT_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
SCORE_RTOL = {"float32": 1e-5, "bfloat16": 2e-3}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SAME, TRUNC = jl.ConvolutionMode.Same, jl.ConvolutionMode.Truncate


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    return float(np.abs(got.astype(np.float32) - want).max() / max(np.abs(want).max(), 1e-30))


def _port_conf(jobj):
    return serde.decode(json.loads(jserde.to_json(jobj)))


def _perturbed(tree, rng, scale=0.1):
    """Each parameter moved off its init; ``var`` kept positive."""
    out = {}
    for k, v in tree.items():
        v = np.asarray(v, np.float32)
        if k == "var":
            out[k] = v * rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        else:
            out[k] = v + scale * rng.standard_normal(v.shape).astype(np.float32)
    return out


def _layer_pair(jconf, compute, seed=0):
    """The JAX implementation of a layer config and the port's, with the
    same perturbed parameters and state."""
    jimpl = jimpl_for(jconf, JGlobalConfig(compute_dtype=compute))
    jp, js = jimpl.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params, state = _perturbed(jp, rng), _perturbed(js, rng)
    impl = impl_for(_port_conf(jconf), GlobalConfig(compute_dtype=compute))
    impl.index = 0
    impl.set_params({k: torch.from_numpy(v) for k, v in params.items()}, "cpu")
    impl.set_state({k: torch.from_numpy(v) for k, v in state.items()}, "cpu")
    return (jimpl, {k: jnp.asarray(v) for k, v in params.items()},
            {k: jnp.asarray(v) for k, v in state.items()}), impl


def _compare_layer(pair, x, compute, x_dtype=None, train=False, mask=None, seed=1):
    """Forward and vector-Jacobian product of both implementations on the
    same ``x`` (in ``x_dtype``, f32 by default) and cotangent; returns the
    port's training state offer and JAX's new state."""
    (jimpl, jp, js), impl = pair
    x_dtype = x_dtype or "float32"
    xj = jnp.asarray(x, JDT[x_dtype])
    mj = None if mask is None else jnp.asarray(mask)

    def f(p, xx):
        return jimpl.forward(p, js, xx, train=train, mask=mj)

    jy, vjp, jns = jax.vjp(f, jp, xj, has_aux=True)
    dy = np.random.default_rng(seed).standard_normal(jy.shape).astype(np.float32)
    jgp, jgx = vjp(jnp.asarray(dy, jy.dtype))

    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(TDT[x_dtype]).requires_grad_()
    ctx = {"train": train, "new_states": {}}
    y = impl(xt, mask=None if mask is None else torch.from_numpy(mask), ctx=ctx)
    assert tuple(y.shape) == tuple(jy.shape)
    assert y.dtype == TDT[str(jy.dtype)], (y.dtype, jy.dtype)
    y.backward(torch.from_numpy(dy).to(y.dtype))
    tol = OUT_TOL[compute] if compute == "float32" and x_dtype == "float32" else 3e-2
    gtol = GRAD_TOL[compute] if compute == "float32" and x_dtype == "float32" else 3e-2
    assert _rel(y, jy.astype(jnp.float32)) <= tol, _rel(y, jy.astype(jnp.float32))
    assert _rel(xt.grad, jgx.astype(jnp.float32)) <= gtol, _rel(xt.grad, jgx.astype(jnp.float32))
    for k, g in jgp.items():
        got = impl.param_dict()[k].grad
        assert _rel(got, g) <= gtol, (k, _rel(got, g))
    return ctx["new_states"].get(0), jns


CONV_CASES = [
    # (h, w, k, s, p, d, mode, bias)
    (8, 8, (3, 3), (1, 1), (0, 0), (1, 1), SAME, True),
    (7, 9, (3, 3), (1, 1), (0, 0), (1, 1), SAME, False),
    (8, 8, (3, 3), (2, 2), (0, 0), (1, 1), SAME, True),      # pads (0, 1)
    (7, 7, (3, 3), (2, 2), (0, 0), (1, 1), SAME, False),     # pads (1, 1)
    (16, 15, (7, 7), (2, 2), (0, 0), (1, 1), SAME, False),   # pads (2, 3) and (3, 3)
    (9, 10, (1, 1), (2, 2), (0, 0), (1, 1), SAME, False),    # the projection shortcut
    (9, 8, (3, 2), (1, 2), (1, 0), (2, 1), SAME, True),      # dilated SAME
    (9, 8, (3, 3), (2, 1), (1, 2), (2, 1), TRUNC, True),
    (6, 6, (5, 5), (1, 1), (0, 0), (1, 1), TRUNC, False),
]


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: f"{c[0]}x{c[1]}k{c[2][0]}s{c[3][0]}"
                         f"p{c[4][0]}d{c[5][0]}{c[6][0]}{'b' if c[7] else ''}")
def test_conv2d_matches_jax(case, compute):
    h, w, k, s, p, d, mode, bias = case
    conf = jl.ConvolutionLayer(n_in=3, n_out=5, kernel_size=k, stride=s, padding=p, dilation=d,
                               convolution_mode=mode, has_bias=bias, activation="tanh")
    x = np.random.default_rng(2).standard_normal((2, h, w, 3)).astype(np.float32)
    _compare_layer(_layer_pair(conf, compute), x, compute)


def test_same_pads_are_xla_s():
    from deeplearning4j_torch.nn.layers.convolution import same_pads
    assert same_pads((224, 224), (7, 7), (2, 2)) == [(2, 3), (2, 3)]
    assert same_pads((112, 112), (3, 3), (2, 2)) == [(0, 1), (0, 1)]
    assert same_pads((56, 56), (1, 1), (2, 2)) == [(0, 0), (0, 0)]
    assert same_pads((9, 8), (3, 2), (1, 2), (2, 1)) == [(2, 2), (0, 0)]


POOL_CASES = [
    # (h, w, k, s, p, mode)
    (8, 8, (2, 2), (2, 2), (0, 0), TRUNC),
    (9, 7, (3, 3), (2, 2), (1, 1), TRUNC),
    (8, 8, (3, 3), (2, 2), (0, 0), SAME),    # pads (0, 1): ResNet50's stem pool
    (7, 9, (3, 3), (1, 1), (0, 0), SAME),
    (7, 7, (2, 3), (2, 2), (0, 0), SAME),
]


@pytest.mark.parametrize("kind", ["max", "avg", "sum", "pnorm"])
@pytest.mark.parametrize("case", POOL_CASES, ids=lambda c: f"{c[0]}x{c[1]}k{c[2][0]}{c[2][1]}"
                         f"s{c[3][0]}p{c[4][0]}{c[5][0]}")
def test_subsampling_matches_jax(case, kind):
    h, w, k, s, p, mode = case
    conf = jl.SubsamplingLayer(pooling_type=kind, kernel_size=k, stride=s, padding=p,
                               convolution_mode=mode, pnorm=3 if kind == "pnorm" else None)
    x = np.random.default_rng(3).standard_normal((2, h, w, 4)).astype(np.float32)
    _compare_layer(_layer_pair(conf, "float32"), x, "float32")


@pytest.mark.parametrize("kind", ["max", "avg"])
def test_subsampling_bf16_activations(kind):
    """bf16 activations (the bf16 policy's), values distinct within each
    window so the max's gradient has one place to go in both packages."""
    conf = jl.SubsamplingLayer(pooling_type=kind, kernel_size=(3, 3), stride=(2, 2),
                               convolution_mode=SAME)
    x = (np.random.default_rng(4).permutation(2 * 8 * 8 * 4).reshape(2, 8, 8, 4) % 256 - 128)
    _compare_layer(_layer_pair(conf, "bfloat16"), (x / 16).astype(np.float32), "bfloat16",
                   x_dtype="bfloat16")


@pytest.mark.parametrize("kind", ["max", "avg", "sum", "pnorm"])
@pytest.mark.parametrize("rank", [3, 4])
def test_global_pooling_matches_jax(kind, rank):
    conf = jl.GlobalPoolingLayer(pooling_type=kind, pnorm=3)
    rng = np.random.default_rng(5)
    mask = None
    if rank == 4:
        x = rng.standard_normal((2, 5, 4, 3)).astype(np.float32)
    else:
        x = rng.standard_normal((3, 6, 4)).astype(np.float32)
        mask = np.ones((3, 6), np.float32)
        mask[1, 4:] = 0.0
        mask[2, 1:] = 0.0
    _compare_layer(_layer_pair(conf, "float32"), x, "float32", mask=mask)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("rank", [2, 4])
def test_batchnorm_matches_jax(compute, train, rank):
    """Training (batch statistics; the new running statistics offered to
    the container) and inference (running statistics), on NHWC and [b, f]
    input in the policy's activation dtype, with |mean| above the std so a
    one-pass variance in f32 would show."""
    conf = jl.BatchNormalization(n_in=4, n_out=4)
    shape = (2, 3, 3, 4) if rank == 4 else (6, 4)
    x = (np.random.default_rng(6).standard_normal(shape) * 2 + 3).astype(np.float32)
    offered, jns = _compare_layer(_layer_pair(conf, compute), x, compute, x_dtype=compute,
                                  train=train)
    if train:
        for k in ("mean", "var"):
            assert _rel(offered[k], jns[k]) <= GRAD_TOL[compute], (k, _rel(offered[k], jns[k]))
    else:
        assert offered is None


def test_batchnorm_locked_gamma_beta_and_no_penalty():
    conf = jl.BatchNormalization(n_in=3, n_out=3, lock_gamma_beta=True, gamma=2.0, beta=0.5)
    x = np.random.default_rng(7).standard_normal((4, 2, 2, 3)).astype(np.float32)
    pair = _layer_pair(conf, "float32")
    assert pair[1].param_dict() == {}
    _compare_layer(pair, x, "float32", train=True)
    gc = GlobalConfig(l1=0.5, l2=0.5)
    impl = impl_for(_port_conf(jl.BatchNormalization(n_in=3, n_out=3)), gc)
    impl.set_params(impl.init_params(None), "cpu")
    assert impl.regularization() == 0.0


@pytest.mark.parametrize("act", ["relu", "tanh", "leakyrelu"])
def test_activation_layer_matches_jax(act):
    conf = jl.ActivationLayer(activation=act)
    x = np.random.default_rng(8).standard_normal((2, 3, 3, 4)).astype(np.float32)
    _compare_layer(_layer_pair(conf, "float32"), x, "float32")


def test_preprocessors_match_jax():
    x = np.random.default_rng(9).standard_normal((2, 3, 4, 5)).astype(np.float32)
    flat = np.asarray(jpre.CnnToFeedForwardPreProcessor(3, 4, 5)(jnp.asarray(x), {}))
    mine = pre.CnnToFeedForwardPreProcessor(3, 4, 5)(torch.from_numpy(x), {})
    np.testing.assert_array_equal(mine.numpy(), flat)
    back = np.asarray(jpre.FeedForwardToCnnPreProcessor(3, 4, 5)(jnp.asarray(flat), {}))
    mine = pre.FeedForwardToCnnPreProcessor(3, 4, 5)(torch.from_numpy(flat), {})
    np.testing.assert_array_equal(mine.numpy(), back)
    np.testing.assert_array_equal(back, x)


def _jax_mln(layers, input_type, compute="float32", seed=3, updater=None):
    b = JConf.builder().seed(seed)
    if updater is not None:
        b = b.updater(updater)
    lb = b.list()
    for layer in layers:
        lb = lb.layer(layer)
    conf = lb.set_input_type(input_type).build()
    conf.global_conf.compute_dtype = compute
    return JNet(conf).init()


def _arrays(tree):
    return {f"{i}/{k}": np.asarray(v) for i, p in tree.items() for k, v in p.items()}


def _port_of(jnet, cls=MultiLayerNetwork, conf_cls=MultiLayerConfiguration):
    conf = conf_cls.from_json(jnet.conf.to_json())
    return cls(conf).init(params=params_from_numpy(conf, _arrays(jnet.params)),
                          states=states_from_numpy(conf, _arrays(jnet.states)), device="cpu")


@pytest.mark.parametrize("flat", [False, True])
def test_preprocessors_and_nchw_adapter_in_a_network(flat):
    """Conv -> pool -> dense -> output: the dense layer gets the
    CnnToFeedForward preprocessor; with a flat input type the first layer
    gets FeedForwardToCnn. NCHW input is adapted at the boundary, NHWC
    input (channels not at axis 1) passes through, as in the JAX package."""
    it = (JInputType.convolutional_flat(6, 6, 2) if flat else JInputType.convolutional(6, 6, 2))
    jnet = _jax_mln([jl.ConvolutionLayer(n_out=3, kernel_size=(3, 3), activation="relu"),
                     jl.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)),
                     jl.DenseLayer(n_out=5, activation="tanh"),
                     jl.OutputLayer(n_out=4, activation="softmax")], it)
    net = _port_of(jnet)
    want = {"0": jpre.FeedForwardToCnnPreProcessor} if flat else {}
    want["2"] = jpre.CnnToFeedForwardPreProcessor
    assert {k: type(v).__name__ for k, v in net.conf.input_preprocessors.items()} == \
        {k: v.__name__ for k, v in want.items()}
    rng = np.random.default_rng(10)
    feats = ([rng.standard_normal((3, 72)).astype(np.float32)] if flat else
             [rng.standard_normal((3, 2, 6, 6)).astype(np.float32),
              rng.standard_normal((3, 6, 6, 2)).astype(np.float32)])
    labels = np.eye(4, dtype=np.float32)[[0, 1, 3]]
    for f in feats:
        np.testing.assert_allclose(net.output(f).numpy(), np.asarray(jnet.output(f)), rtol=0,
                                   atol=OUT_TOL["float32"])
        jgrads, jscore = jnet.compute_gradient_and_score(JDataSet(f, labels))
        grads, score = net.compute_gradient_and_score(DataSet(f, labels))
        assert abs(score - jscore) <= SCORE_RTOL["float32"] * abs(jscore)
        for i, gs in jgrads.items():
            for k, g in gs.items():
                assert _rel(grads[i][k], g) <= GRAD_TOL["float32"], (i, k)


def _bn_net(compute, b=2, hw=5, seed=11):
    """Conv(3x3) -> BN -> output on [b, 1, hw, hw]: at b=2, hw=5 each
    channel's batch statistics come from n = 2 * 3 * 3 = 18 values, so a
    variance divided by n - 1 would be 6% off. The convolution has no bias,
    as in ResNet50: a bias before BN has a zero gradient, which Adam turns
    into steps of +-lr driven by rounding noise alone."""
    jnet = _jax_mln([jl.ConvolutionLayer(kernel_size=(3, 3), n_out=4, activation="identity",
                                         has_bias=False),
                     jl.BatchNormalization(),
                     jl.OutputLayer(n_out=2, activation="softmax")],
                    JInputType.convolutional(hw, hw, 1), compute, seed, JAdam(learning_rate=1e-3))
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, 1, hw, hw)) * 3 + 1).astype(np.float32)
    labels = np.eye(2, dtype=np.float32)[rng.integers(0, 2, b)]
    return jnet, x, labels


def test_bn_state_updates_in_training():
    """``tests/test_multilayer.py::TestCNN::test_bn_state_updates_in_training``
    of the JAX package, on the port, and the moved means held against
    JAX's."""
    x = np.random.default_rng(0).standard_normal((16, 1, 6, 6)).astype(np.float32) * 3 + 1
    labels = np.eye(2, dtype=np.float32)[np.zeros(16, int)]
    jconf = (JConf.builder().list()
             .layer(jl.ConvolutionLayer(kernel_size=(3, 3), n_out=4))
             .layer(jl.BatchNormalization())
             .layer(jl.OutputLayer(n_out=2, activation="softmax"))
             .set_input_type(JInputType.convolutional(6, 6, 1))
             .build())
    jnet = JNet(jconf).init()
    net = _port_of(jnet)
    mean_before = net.states["1"]["mean"].clone()
    net.fit(DataSet(x, labels))
    mean_after = net.states["1"]["mean"]
    assert not np.allclose(mean_before.numpy(), mean_after.numpy())
    jnet.fit(JDataSet(x, labels))
    assert _rel(mean_after, jnet.states["1"]["mean"]) <= GRAD_TOL["float32"]


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_bn_running_statistics_after_three_fit_steps(compute):
    jnet, x, labels = _bn_net(compute)
    net = _port_of(jnet)
    for _ in range(3):
        net.fit(DataSet(x, labels))
        jnet.fit(JDataSet(x, labels))
    assert abs(net.score() - float(jnet.score())) <= SCORE_RTOL[compute] * float(jnet.score())
    for k in ("mean", "var"):
        got, want = net.states["1"][k], jnet.states["1"][k]
        assert got.dtype == torch.float32
        assert _rel(got, want) <= GRAD_TOL[compute], (k, _rel(got, want))
    np.testing.assert_allclose(net.output(x).numpy(), np.asarray(jnet.output(x)), rtol=0,
                               atol=OUT_TOL[compute])


def _cg_bn_net():
    jconf = (JConf.builder().seed(4).graph_builder().add_inputs("in")
             .add_layer("conv", jl.ConvolutionLayer(kernel_size=(3, 3), n_out=4,
                                                    activation="identity"), "in")
             .add_layer("bn", jl.BatchNormalization(), "conv")
             .add_layer("gap", jl.GlobalPoolingLayer(pooling_type="avg"), "bn")
             .add_layer("out", jl.OutputLayer(n_out=2, activation="softmax"), "gap")
             .set_outputs("out").set_input_types(JInputType.convolutional(5, 5, 1)).build())
    return JGraph(jconf).init()


@pytest.mark.parametrize("container", ["MultiLayerNetwork", "ComputationGraph"])
def test_state_commits_only_in_fit(container):
    """``score(training=True)`` and ``compute_gradient_and_score`` use batch
    statistics and leave the running ones alone; ``fit`` commits them."""
    if container == "MultiLayerNetwork":
        jnet, x, labels = _bn_net("float32")
        net, key = _port_of(jnet), "1"
    else:
        jnet = _cg_bn_net()
        net = _port_of(jnet, ComputationGraph, ComputationGraphConfiguration)
        rng = np.random.default_rng(12)
        x = (rng.standard_normal((2, 1, 5, 5)) * 3 + 1).astype(np.float32)
        labels = np.eye(2, dtype=np.float32)[[0, 1]]
        key = "bn"
    ds = DataSet(x, labels)
    before = {k: v.clone() for k, v in net.states[key].items()}
    s_train, s_infer = net.score(ds, training=True), net.score(ds)
    assert s_train != s_infer
    assert abs(s_train - float(jnet.score(JDataSet(x, labels), training=True))) <= 1e-5 * s_train
    net.compute_gradient_and_score(ds)
    for k, v in net.states[key].items():
        assert torch.equal(v, before[k]), k
    net.fit(ds)
    jnet.fit(JDataSet(x, labels))
    for k, v in net.states[key].items():
        assert not torch.equal(v, before[k]), k
        assert _rel(v, jnet.states[key][k]) <= GRAD_TOL["float32"], k


def test_states_are_buffers_not_parameters():
    jnet, _, _ = _bn_net("float32")
    net = _port_of(jnet)
    assert set(net.params["1"]) == {"gamma", "beta"}
    assert set(net.states["1"]) == {"mean", "var"} and net.states["0"] == {}
    assert set(net.updater_state["1"]) == {"gamma", "beta"}
    assert {n for n, _ in net.named_buffers()} == {"impls.1.mean", "impls.1.var"}
    with pytest.raises(ValueError, match="state"):
        MultiLayerNetwork(net.conf).init(states={"1": {"mean": torch.zeros(4)}}, device="cpu")
