"""Activation functions.

Counterpart of ``deeplearning4j_tpu/nn/activations.py``: the same
string-keyed set, as PyTorch tensor functions (``gelu`` is the tanh
approximation, as ``jax.nn.gelu`` defaults to), and the :class:`Activation`
name class. Autograd gives each the JAX package's subgradient at its
kinks: the clipping activations are ``minimum(maximum(x, lo), hi)``, which
split a tie at a bound 0.5/0.5 as ``jnp.clip`` does (``torch.clamp`` passes
the whole gradient), and ``leakyrelu`` is ``where(x >= 0, x, a * x)``, slope
1 at 0 (``F.leaky_relu`` takes ``a`` there).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["Activation", "get_activation", "resolve_activation"]


def _clip(x, lo, hi):
    """``jnp.clip``'s max-then-min, with its tie rule in the gradient."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def _leakyrelu(x, alpha=0.01):
    return torch.where(x >= 0, x, alpha * x)


def _rationaltanh(x):
    a = torch.abs(x)
    p = 1.0 + a + x * x * (1.41645 + a * 0.052357)
    return torch.sign(x) * (1.0 - 1.0 / p) * 1.7159


_ACTIVATIONS = {
    "identity": lambda x: x,
    "linear": lambda x: x,
    "relu": torch.relu,
    "relu6": lambda x: _clip(x, 0.0, 6.0),
    "leakyrelu": _leakyrelu,
    "elu": F.elu,
    "selu": F.selu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "swish": F.silu,
    "silu": F.silu,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
    "sigmoid": torch.sigmoid,
    "hardsigmoid": lambda x: _clip(0.2 * x + 0.5, 0.0, 1.0),
    "tanh": torch.tanh,
    "hardtanh": lambda x: _clip(x, -1.0, 1.0),
    "rationaltanh": _rationaltanh,
    "rectifiedtanh": lambda x: torch.maximum(x.new_zeros(()), torch.tanh(x)),
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "softplus": F.softplus,
    "softsign": F.softsign,
    "cube": lambda x: x * x * x,
    "thresholdedrelu": lambda x: torch.where(x > 1.0, x, torch.zeros_like(x)),
}


class Activation:
    """String-keyed activation registry mirroring ND4J's ``Activation`` enum values."""

    CUBE = "cube"
    ELU = "elu"
    GELU = "gelu"
    HARDSIGMOID = "hardsigmoid"
    HARDTANH = "hardtanh"
    IDENTITY = "identity"
    LEAKYRELU = "leakyrelu"
    MISH = "mish"
    RATIONALTANH = "rationaltanh"
    RECTIFIEDTANH = "rectifiedtanh"
    RELU = "relu"
    RELU6 = "relu6"
    SELU = "selu"
    SIGMOID = "sigmoid"
    SOFTMAX = "softmax"
    SOFTPLUS = "softplus"
    SOFTSIGN = "softsign"
    SWISH = "swish"
    TANH = "tanh"
    THRESHOLDEDRELU = "thresholdedrelu"

    @staticmethod
    def names():
        return sorted(_ACTIVATIONS)


def get_activation(name):
    """Resolve an activation by name (case-insensitive); parametric
    spellings ``"leakyrelu:0.3"``, ``"elu:0.7"``, ``"thresholdedrelu:1.5"``
    bind the parameter."""
    if callable(name):
        return name
    key = str(name).lower()
    if ":" in key:
        base, _, arg = key.partition(":")
        val = float(arg)
        if base == "leakyrelu":
            return lambda x: _leakyrelu(x, val)
        if base == "elu":
            return lambda x: F.elu(x, val)
        if base == "thresholdedrelu":
            return lambda x: torch.where(x > val, x, torch.zeros_like(x))
        raise ValueError(f"Unknown parametric activation '{name}'")
    if key not in _ACTIVATIONS:
        raise ValueError(f"Unknown activation '{name}'. Known: {sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[key]


# Alias used by config code.
resolve_activation = get_activation
