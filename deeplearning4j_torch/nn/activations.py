"""Activation functions.

Counterpart of ``deeplearning4j_tpu/nn/activations.py``: the same
string-keyed set, as PyTorch tensor functions (``gelu`` is the tanh
approximation, as ``jax.nn.gelu`` defaults to).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["get_activation"]


def _rationaltanh(x):
    a = torch.abs(x)
    p = 1.0 + a + x * x * (1.41645 + a * 0.052357)
    return torch.sign(x) * (1.0 - 1.0 / p) * 1.7159


_ACTIVATIONS = {
    "identity": lambda x: x,
    "linear": lambda x: x,
    "relu": torch.relu,
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    "elu": F.elu,
    "selu": F.selu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "swish": F.silu,
    "silu": F.silu,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
    "sigmoid": torch.sigmoid,
    "hardsigmoid": lambda x: torch.clamp(0.2 * x + 0.5, 0.0, 1.0),
    "tanh": torch.tanh,
    "hardtanh": lambda x: torch.clamp(x, -1.0, 1.0),
    "rationaltanh": _rationaltanh,
    "rectifiedtanh": lambda x: torch.clamp(torch.tanh(x), min=0.0),
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "softplus": F.softplus,
    "softsign": F.softsign,
    "cube": lambda x: x * x * x,
    "thresholdedrelu": lambda x: torch.where(x > 1.0, x, torch.zeros_like(x)),
}


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
            return lambda x: F.leaky_relu(x, val)
        if base == "elu":
            return lambda x: F.elu(x, val)
        if base == "thresholdedrelu":
            return lambda x: torch.where(x > val, x, torch.zeros_like(x))
        raise ValueError(f"Unknown parametric activation '{name}'")
    if key not in _ACTIVATIONS:
        raise ValueError(f"Unknown activation '{name}'. Known: {sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[key]
