"""Every activation of the port against the JAX package's, value and
gradient, at the kinks and around them (ROADMAP Queue C 5).

The points are -2.5, -1, 0, 1, 2.5 and 6 (the kinks of relu6, hardtanh,
hardsigmoid, rectifiedtanh, leakyrelu, relu and thresholdedrelu lie on
them) and a spread of ordinary values, in float32 and float64; the
parametric spellings ride along. Values within 1e-6 (f32) / 1e-12 (f64);
gradients: ``jax.grad`` of the JAX function against autograd of the port's,
within the same tolerances. At a tie the JAX package's subgradient is the
rule: ``jnp.clip`` splits it 0.5/0.5 (relu6 at 0 and 6, hardtanh at +-1,
rectifiedtanh at 0; hardsigmoid 0.1 at +-2.5) and leakyrelu's
``where(x >= 0, ...)`` takes slope 1 at 0.
"""
import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.compat import enable_x64
from deeplearning4j_tpu.nn.activations import Activation as JActivation
from deeplearning4j_tpu.nn.activations import get_activation as jget

from deeplearning4j_torch.nn.activations import Activation, get_activation

KINKS = [-2.5, -1.0, 0.0, 1.0, 2.5, 6.0]
POINTS = KINKS + [-7.0, -3.3, -0.4, -1e-3, 1e-3, 0.3, 0.9, 1.7, 4.2, 5.9, 6.1, 9.0]
TOL = {"float32": 1e-6, "float64": 1e-12}
NAMES = sorted(set(JActivation.names()) - {"softmax"}) + [
    "leakyrelu:0.3", "elu:0.7", "thresholdedrelu:1.5"]


def _jax(name, dtype):
    with enable_x64(dtype == "float64"):
        x = jax.numpy.asarray(POINTS, dtype)
        f = jget(name)
        v = np.asarray(f(x), np.float64)
        g = np.asarray(jax.vmap(jax.grad(lambda t: f(t)))(x), np.float64)
    return v, g


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", NAMES)
def test_activation_value_and_gradient_match_jax(name, dtype):
    want_v, want_g = _jax(name, dtype)
    x = torch.tensor(POINTS, dtype=getattr(torch, dtype), requires_grad=True)
    y = get_activation(name)(x)
    (g,) = torch.autograd.grad(y.sum(), x)
    tol = TOL[dtype]
    np.testing.assert_allclose(y.detach().double().numpy(), want_v, rtol=tol, atol=tol)
    np.testing.assert_allclose(g.double().numpy(), want_g, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_the_kink_gradients_queue_c5_lists(dtype):
    """The ties ROADMAP Queue C 5 found, by number: 0.5 where a clip meets
    its bound, 0.1 for hardsigmoid at +-2.5, 1 for leakyrelu at 0."""
    def grad_at(name, at):
        x = torch.tensor([at], dtype=getattr(torch, dtype), requires_grad=True)
        return float(torch.autograd.grad(get_activation(name)(x).sum(), x)[0])
    for name, at, want in [("relu6", 0.0, 0.5), ("relu6", 6.0, 0.5), ("hardtanh", -1.0, 0.5),
                           ("hardtanh", 1.0, 0.5), ("hardsigmoid", -2.5, 0.1),
                           ("hardsigmoid", 2.5, 0.1), ("rectifiedtanh", 0.0, 0.5),
                           ("leakyrelu", 0.0, 1.0), ("leakyrelu:0.3", 0.0, 1.0)]:
        assert grad_at(name, at) == pytest.approx(want, rel=1e-6), (name, at)


def test_softmax_and_the_name_class():
    """softmax (a row function) against JAX's, and ``Activation`` names the
    same set as the JAX package's class."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5))
    with enable_x64(True):
        want = np.asarray(jget("softmax")(jax.numpy.asarray(x)))
    np.testing.assert_allclose(get_activation("softmax")(torch.tensor(x)).numpy(), want,
                               rtol=1e-12, atol=1e-15)
    assert Activation.names() == JActivation.names()
    assert {k: v for k, v in vars(Activation).items() if k.isupper()} == \
        {k: v for k, v in vars(JActivation).items() if k.isupper()}
