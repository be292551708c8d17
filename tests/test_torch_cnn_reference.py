"""The limits of ``chip_smoke.py``'s ResNet50 card-vs-CPU check, on the
CPU: the port's own f32 and bf16 runs hold them against its f64 run, on
the same kinks, and a deliberately broken layer in the run under test
breaks them.

The check runs the net under test (the card, here the CPU) in f64, f32 or
bf16 and the port in f64 on the CPU as the reference, from the same
weights, each with running statistics of its own, with the reference
replaying the tested run's ReLU signs and max-pool picks (``KinkPins``).
Each mutation below is entered only around the tested run's calls. bf16's
limits do not catch the BatchNormalization mutations that move a layer by
a percent or less (an unbiased variance, an eps of 1e-3 in place of
1e-5): its own rounding is as large. f32's do.
"""
import contextlib
import types

import pytest
import torch

import chip_smoke
from deeplearning4j_torch.nn.layers import convolution, normalization

QUANTITIES = ("output", "score", "grads", "grads_norm")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _limits(dtype):
    return dict(zip(QUANTITIES, chip_smoke.R50_REF_LIMITS[dtype]))


@contextlib.contextmanager
def _patched(module, name, fn):
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def _mirrored_pads(*args):
    """SAME's odd cell before the window instead of after it."""
    return [(hi, lo) for lo, hi in _conv_padding(*args)]


def _unbiased_normalisation(x, mean, var, gamma, beta, eps, train):
    """Training normalises with the unbiased batch variance: gamma and eps
    rescaled by (n - 1) / n give (x - mean) * gamma / sqrt(var * n / (n - 1)
    + eps) exactly, with the gradient through the statistics intact."""
    if not train:
        return _batch_norm(x, mean, var, gamma, beta, eps, train)
    n = x.numel() // x.shape[-1]
    r = (n - 1) / n
    return _batch_norm(x, mean, var, gamma * r ** 0.5, beta, eps * r, train)


def _unbiased_running_variance(x, mean, var, gamma, beta, eps, train):
    """The batch variance offered to the running statistics is unbiased."""
    out = _batch_norm(x, mean, var, gamma, beta, eps, train)
    if not train:
        return out
    n = x.numel() // x.shape[-1]
    return out[0], out[1], out[2] * n / (n - 1)


def _wide_eps(x, mean, var, gamma, beta, eps, train):
    return _batch_norm(x, mean, var, gamma, beta, 1e-3, train)


def _gradient_skips_statistics(x, mean, var, gamma, beta, eps, train):
    """Training normalises with the batch statistics, detached: their
    terms are missing from the gradient."""
    if not train:
        return _batch_norm(x, mean, var, gamma, beta, eps, train)
    _, m, v = _batch_norm(x.detach(), mean, var, gamma, beta, eps, train)
    return _batch_norm(x, m, v, gamma, beta, eps, False), m, v


_flipped_kernel = types.SimpleNamespace(
    conv2d=lambda x, w, *a: torch.nn.functional.conv2d(x, w.flip(2, 3), *a),
    pad=torch.nn.functional.pad)


_conv_padding = convolution.conv_padding
_batch_norm = normalization.batch_norm
MUTATIONS = {
    "mirrored SAME pads": (convolution, "conv_padding", _mirrored_pads),
    "unbiased normalisation": (normalization, "batch_norm", _unbiased_normalisation),
    "unbiased running variance": (normalization, "batch_norm", _unbiased_running_variance),
    "BN eps 1e-3": (normalization, "batch_norm", _wide_eps),
    "BN gradient skips the statistics": (normalization, "batch_norm",
                                         _gradient_skips_statistics),
    "flipped kernel": (convolution, "F", _flipped_kernel),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_limits_hold_on_the_cpu(dtype):
    errs = chip_smoke.r50_reference_errors(dtype, "cpu")
    lims = _limits(dtype)
    assert all(errs[q] <= lims[q] for q in QUANTITIES), (errs, lims)


@pytest.mark.parametrize("dtype,mutation", [
    (dtype, m) for dtype in ("float32", "bfloat16") for m in MUTATIONS
    if dtype == "float32" or m in ("mirrored SAME pads", "flipped kernel",
                                   "BN gradient skips the statistics")])
def test_reference_limits_catch_a_broken_layer(dtype, mutation):
    module, name, fn = MUTATIONS[mutation]
    errs = chip_smoke.r50_reference_errors(
        dtype, "cpu", mutate=lambda: _patched(module, name, fn))
    lims = _limits(dtype)
    assert any(errs[q] > lims[q] for q in QUANTITIES), (errs, lims)
