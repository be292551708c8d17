"""The rest of the CNN family in the port on the CPU, against the JAX package.

Each new layer config is built in the JAX package, carried to the port
through its JSON, and given the same parameters (moved off their init) in
both packages. The forward and its vector-Jacobian product (one seeded
cotangent: ``jax.vjp`` and autograd) are compared on the same numpy input:
the output, the input's gradient and every parameter's gradient.

- Deconvolution2D under Truncate (padding up to (k - 1) d) and Same at
  strides 1-3 and dilations 1-2, where XLA's transposed SAME pads are
  asymmetric or reach past the kernel; its output size against
  ``Deconvolution2D.get_output_type``;
- DepthwiseConvolution2D and SeparableConvolution2D at depth multipliers
  1 and 2, Same (asymmetric pads under stride 2 and dilation 2) and
  Truncate;
- Convolution1DLayer and Subsampling1DLayer (every pooling type) on [b, T,
  c], Upsampling1D/2D, ZeroPaddingLayer (four and two entries),
  ZeroPadding1DLayer, Cropping2D (a crop of 0 included), SpaceToDepthLayer
  (its channel order also checked cell by cell) and
  LocalResponseNormalization at n = 5, 4 (a window of 5 channels), 3 and 1.

Tolerances, as max |port - jax| over max |jax|: float64 1e-10 on outputs
and gradients; float32 1e-5 on outputs and 1e-4 on gradients; bfloat16 3e-2
(one bf16 unit is 2^-8 of a value, and the two frameworks round at
different places). A test walks its grid of cases and dtypes in a loop
(the failure names the case), so that the file holds 27 tests:
``test_torch_zoo_family.py``'s docstring says why. That file holds the new
layers in the containers and the zoo models.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.compat import enable_x64
from deeplearning4j_tpu.nn.conf import GlobalConfig as JGlobalConfig
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf import serde as jserde
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.layers.base import impl_for as jimpl_for

from deeplearning4j_torch.nn.conf import GlobalConfig, serde
from deeplearning4j_torch.nn.conf import layers as pl
from deeplearning4j_torch.nn.conf.inputs import InputTypeConvolutional, InputTypeRecurrent
from deeplearning4j_torch.nn.layers import impl_for

DTYPES = ["float64", "float32", "bfloat16"]
OUT_TOL = {"float64": 1e-10, "float32": 1e-5, "bfloat16": 3e-2}
GRAD_TOL = {"float64": 1e-10, "float32": 1e-4, "bfloat16": 3e-2}
# (parameter dtype, compute dtype) of each policy
POLICY = {"float64": ("float64", "float64"), "float32": ("float32", "float32"),
          "bfloat16": ("float32", "bfloat16")}
JDT = {"float64": jnp.float64, "float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float64": torch.float64, "float32": torch.float32, "bfloat16": torch.bfloat16}
SAME, TRUNC = jl.ConvolutionMode.Same, jl.ConvolutionMode.Truncate


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _rel(got, want):
    got = (got.detach().double().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float64))
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _port_conf(jobj):
    return serde.decode(json.loads(jserde.to_json(jobj)))


def _layer_pair(jconf, dtype, seed=0):
    """The JAX implementation of a layer config and the port's, with the
    same parameters (each moved off its init by 0.1 N(0, 1))."""
    pdt, cdt = POLICY[dtype]
    jimpl = jimpl_for(jconf, JGlobalConfig(dtype=pdt, compute_dtype=cdt))
    jp, _ = jimpl.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = {k: np.asarray(v, np.float64) + 0.1 * rng.standard_normal(v.shape)
              for k, v in jp.items()}
    impl = impl_for(_port_conf(jconf), GlobalConfig(dtype=pdt, compute_dtype=cdt))
    impl.index = 0
    impl.set_params({k: torch.from_numpy(v) for k, v in params.items()}, "cpu")
    return jimpl, {k: jnp.asarray(v, JDT[pdt]) for k, v in params.items()}, impl


def _compare_layer(jconf, x, dtype, x_dtype=None, seed=1, forward_mode=False):
    """Forward and vector-Jacobian product of both implementations of
    ``jconf`` on the same ``x`` (in ``x_dtype``: the policy's activation
    type by default) and cotangent; returns the port's output.
    ``forward_mode`` (a layer without parameters) takes JAX's input
    gradient from its Jacobian by ``jax.jacfwd`` instead of ``jax.vjp``."""
    with enable_x64(dtype == "float64"):
        jimpl, jp, impl = _layer_pair(jconf, dtype)
        x_dtype = x_dtype or ("float64" if dtype == "float64" else "float32")
        xj = jnp.asarray(x, JDT[x_dtype])
        jy, vjp = jax.vjp(lambda p, xx: jimpl.forward(p, {}, xx)[0], jp, xj)
        dy = np.random.default_rng(seed).standard_normal(jy.shape)
        jgp, jgx = vjp(jnp.asarray(dy, jy.dtype))
        if forward_mode:
            assert not jp
            jac = jax.jacfwd(lambda xx: jimpl.forward(jp, {}, xx)[0])(xj)
            jgx = jnp.tensordot(jnp.asarray(dy, jy.dtype), jac, axes=jy.ndim)
        y_dtype = str(jy.dtype)
        jy, jgx = np.asarray(jy.astype(jnp.float64)), np.asarray(jgx.astype(jnp.float64))
        jgp = {k: np.asarray(g.astype(jnp.float64)) for k, g in jgp.items()}
    xt = torch.from_numpy(np.asarray(x, np.float64)).to(TDT[x_dtype]).requires_grad_()
    y = impl(xt, mask=None, ctx={"train": False})
    assert tuple(y.shape) == jy.shape
    assert y.dtype == TDT[y_dtype], (y.dtype, y_dtype)
    y.backward(torch.from_numpy(dy).to(y.dtype))
    assert _rel(y, jy) <= OUT_TOL[dtype], _rel(y, jy)
    assert _rel(xt.grad, jgx) <= GRAD_TOL[dtype], _rel(xt.grad, jgx)
    assert set(impl.param_dict()) == set(jgp)
    for k, g in jgp.items():
        got = impl.param_dict()[k].grad
        assert _rel(got, g) <= GRAD_TOL[dtype], (k, _rel(got, g))
    return y


def _image(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape)


DECONV_CASES = [
    # (h, w, k, s, p, d, mode)
    (5, 4, (3, 3), (1, 1), (0, 0), (1, 1), TRUNC),
    (4, 5, (3, 3), (2, 2), (1, 1), (1, 1), TRUNC),
    (3, 4, (3, 3), (3, 3), (2, 4), (2, 2), TRUNC),      # padding (k - 1) d: crops to the input
    (4, 3, (2, 3), (2, 3), (1, 0), (2, 1), TRUNC),
    (4, 5, (3, 3), (1, 1), (0, 0), (1, 1), SAME),
    (4, 5, (3, 3), (2, 2), (0, 0), (1, 1), SAME),       # pads (2, 1): one crop at the end
    (4, 3, (3, 3), (3, 3), (0, 0), (1, 1), SAME),       # stride past k - 1: pads (2, 2)
    (3, 4, (3, 3), (2, 2), (0, 0), (2, 2), SAME),       # dilated k 5: pads (3, 2)
    (3, 4, (2, 2), (3, 3), (0, 0), (2, 1), SAME),       # pads (2, 3) and (1, 2): past the kernel
    (4, 3, (1, 4), (2, 3), (0, 0), (1, 1), SAME),       # pads (0, 1) and (3, 2)
]


@pytest.mark.parametrize("case", DECONV_CASES, ids=lambda c: f"{c[0]}x{c[1]}k{c[2][0]}{c[2][1]}"
                         f"s{c[3][0]}{c[3][1]}p{c[4][0]}d{c[5][0]}{c[5][1]}{c[6][0]}")
def test_deconvolution2d_matches_jax(case):
    h, w, k, s, p, d, mode = case
    conf = jl.Deconvolution2D(n_in=3, n_out=4, kernel_size=k, stride=s, padding=p, dilation=d,
                              convolution_mode=mode, activation="tanh")
    want = _port_conf(conf).get_output_type(0, InputTypeConvolutional(h, w, 3))
    for dtype in DTYPES:
        y = _compare_layer(conf, _image(2, (2, h, w, 3)), dtype)
        assert tuple(y.shape[1:]) == (want.height, want.width, want.channels)


GROUPED_CASES = [
    # (h, w, k, s, p, d, mode)
    (6, 5, (3, 3), (1, 1), (0, 0), (1, 1), SAME),
    (7, 6, (3, 2), (2, 2), (0, 0), (2, 2), SAME),       # asymmetric pads in both dims
    (7, 6, (3, 3), (2, 1), (1, 1), (1, 2), TRUNC),
]


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("kind", ["depthwise", "separable"])
def test_depthwise_and_separable_match_jax(kind, m):
    """Output channel j of a depthwise layer comes from input channel j //
    m, as the JAX package's ``feature_group_count``; a separable layer's
    ``dW`` and ``pW`` install under those names. Every GROUPED_CASES case
    in every dtype."""
    for h, w, k, s, p, d, mode in GROUPED_CASES:
        kw = dict(n_in=3, kernel_size=k, stride=s, padding=p, dilation=d, convolution_mode=mode,
                  depth_multiplier=m, activation="tanh")
        if kind == "depthwise":
            conf = jl.DepthwiseConvolution2D(**kw)
            conf.set_n_in(JInputType.convolutional(h, w, 3))
            assert conf.n_out == 3 * m
        else:
            conf = jl.SeparableConvolution2D(n_out=5, **kw)
        for dtype in DTYPES:
            _compare_layer(conf, _image(3, (2, h, w, 3)), dtype)


CONV1D_CASES = [
    # (T, k, s, p, d, mode)
    (9, 3, 1, 0, 1, SAME),
    (9, 4, 2, 0, 1, SAME),      # pads (1, 2)
    (10, 3, 2, 1, 2, TRUNC),
    (8, 3, 1, 0, 2, SAME),
]


@pytest.mark.parametrize("dtype", DTYPES)
def test_convolution1d_matches_jax(dtype):
    for T, k, s, p, d, mode in CONV1D_CASES:
        conf = jl.Convolution1DLayer(n_in=3, n_out=4, kernel_size=k, stride=s, padding=p,
                                     dilation=d, convolution_mode=mode, activation="tanh")
        y = _compare_layer(conf, _image(4, (2, T, 3)), dtype)
        want = _port_conf(conf).get_output_type(0, InputTypeRecurrent(3, T))
        assert tuple(y.shape[1:]) == (want.timeseries_length, want.size)


@pytest.mark.parametrize("kind", ["max", "avg", "sum", "pnorm"])
def test_subsampling1d_matches_jax(kind):
    """AVG divides by the real cells of each window, as in 2-D. JAX's f64
    max-pool VJP on the CPU drops some windows' cotangents (the T8k3s2 SAME
    case loses two of four in a channel; its f32 VJP and its forward mode
    agree with each other and with the port), so the f64 MAX reference is
    JAX's forward-mode Jacobian."""
    for T, k, s, p, mode in ((8, 2, 2, 0, TRUNC), (9, 3, 2, 1, TRUNC), (8, 3, 2, 0, SAME)):
        conf = jl.Subsampling1DLayer(pooling_type=kind, kernel_size=k, stride=s, padding=p,
                                     convolution_mode=mode,
                                     pnorm=3 if kind == "pnorm" else None)
        for dtype in ("float64", "float32"):
            _compare_layer(conf, _image(5, (2, T, 4)), dtype,
                           forward_mode=kind == "max" and dtype == "float64")


SHAPE_LAYERS = {
    "upsampling2d": (jl.Upsampling2D(size=(2, 3)), (2, 3, 4, 2)),
    "upsampling1d": (jl.Upsampling1D(size=3), (2, 4, 3)),
    "zeropadding4": (jl.ZeroPaddingLayer(padding=(1, 0, 2, 3)), (2, 3, 4, 2)),
    "zeropadding2": (jl.ZeroPaddingLayer(padding=(2, 1)), (2, 3, 4, 2)),
    "zeropadding1d": (jl.ZeroPadding1DLayer(padding=(2, 1)), (2, 4, 3)),
    # a crop of 0 keeps its edge
    "cropping4": (jl.Cropping2D(cropping=(1, 0, 2, 1)), (2, 5, 6, 2)),
    "cropping2": (jl.Cropping2D(cropping=(1, 2)), (2, 5, 6, 2)),
    "spacetodepth2": (jl.SpaceToDepthLayer(block_size=2), (2, 4, 6, 3)),
    "spacetodepth3": (jl.SpaceToDepthLayer(block_size=3), (2, 6, 3, 2)),
}


@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
def test_shape_layers_match_jax(dtype):
    """Pure data movement: equal to the bit in each dtype, gradients too;
    the output's shape is the config's output type."""
    for name, (conf, shape) in SHAPE_LAYERS.items():
        y = _compare_layer(conf, _image(6, shape), dtype, x_dtype=dtype)
        if len(shape) == 4:
            want = _port_conf(conf).get_output_type(0, InputTypeConvolutional(*shape[1:]))
            assert tuple(y.shape[1:]) == (want.height, want.width, want.channels), name
        else:
            want = _port_conf(conf).get_output_type(0, InputTypeRecurrent(shape[2], shape[1]))
            assert tuple(y.shape[1:]) == (want.timeseries_length, want.size), name


def test_space_to_depth_channel_order():
    """Output channel (i * bs + j) * c + ch holds cell (i, j) of the block:
    not ``F.pixel_unshuffle``'s NCHW order ch * bs^2 + i * bs + j."""
    bs, c = 2, 3
    x = torch.arange(2 * 4 * 6 * c, dtype=torch.float64).reshape(2, 4, 6, c)
    impl = impl_for(pl.SpaceToDepthLayer(block_size=bs), GlobalConfig())
    y = impl(x)
    for i in range(bs):
        for j in range(bs):
            for ch in range(c):
                assert torch.equal(y[:, :, :, (i * bs + j) * c + ch], x[:, i::bs, j::bs, ch])
    unshuffled = torch.nn.functional.pixel_unshuffle(x.permute(0, 3, 1, 2), bs)
    assert not torch.equal(unshuffled.permute(0, 2, 3, 1), y)


@pytest.mark.parametrize("dtype", DTYPES)
def test_local_response_normalization_matches_jax(dtype):
    """The window is 2 (n // 2) + 1 channels (5 for n = 4) and alpha is not
    divided by n: ``F.local_response_norm`` is another function."""
    x = _image(7, (2, 3, 3, 7)) * 2
    for n in (5, 4, 3, 1):
        conf = jl.LocalResponseNormalization(n=n, k=1.5, alpha=0.3, beta=0.75)
        y = _compare_layer(conf, x, dtype, x_dtype="bfloat16" if dtype == "bfloat16" else None)
        if dtype == "float64" and n > 1:
            torch_lrn = torch.nn.functional.local_response_norm(
                torch.from_numpy(x).permute(0, 3, 1, 2), n, alpha=0.3, beta=0.75, k=1.5)
            assert (torch_lrn.permute(0, 2, 3, 1) - y).abs().max() > 1e-3, n
