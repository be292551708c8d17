"""Dropout objects, weight noise and parameter constraints.

Counterpart of ``deeplearning4j_tpu/nn/conf/dropout.py``: ``Dropout``,
``AlphaDropout``, ``GaussianDropout`` and ``GaussianNoise`` transform a
layer's input activations in training; ``DropConnect`` and ``WeightNoise``
transform its parameters for one training forward; the constraints
project parameters after each update. Field names are the JAX package's,
so its JSON decodes unchanged. A float where a dropout object is expected
is the retain probability (reference 0.9.x semantics).

Where the JAX package takes a ``jax.random`` key these take a
``torch.Generator`` on the CPU (``gen``); every draw goes through
:func:`bernoulli`, :func:`normal` or :func:`exponential` (the last for the
VAE's exponential reconstruction samples), which draw on the tensor's
device (a device generator seeded from ``gen`` on a card). The streams differ from
JAX's threefry; the semantics are the same. Scalars meet a tensor in its
dtype, as JAX's weakly typed Python scalars do: under bf16, ``x / p``
divides by ``p`` rounded to bf16.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .serde import register

__all__ = ["Dropout", "AlphaDropout", "GaussianDropout", "GaussianNoise", "resolve_dropout",
           "DropConnect", "WeightNoise", "BaseConstraint", "MaxNormConstraint",
           "MinMaxNormConstraint", "NonNegativeConstraint", "UnitNormConstraint",
           "apply_constraints", "draw_seed", "bernoulli", "normal", "exponential"]

_INT32_MAX = 2 ** 31 - 1


def draw_seed(gen: torch.Generator) -> int:
    """One int32 seed from the CPU stream ``gen``."""
    return int(torch.randint(0, _INT32_MAX, (), generator=gen))


def _device_generator(gen, device):
    if torch.device(device).type == "cpu":
        return gen
    return torch.Generator(device=device).manual_seed(draw_seed(gen))


def bernoulli(gen, p, shape, device) -> torch.Tensor:
    """A bool mask of ``shape`` on ``device``, each entry True with
    probability ``p`` (``jax.random.bernoulli``)."""
    return torch.rand(shape, generator=_device_generator(gen, device), device=device) < p


def normal(gen, shape, dtype, device) -> torch.Tensor:
    """Standard normal draws of ``shape`` in ``dtype`` on ``device``
    (``jax.random.normal``)."""
    return torch.randn(shape, generator=_device_generator(gen, device), dtype=dtype,
                       device=device)


def exponential(gen, shape, dtype, device) -> torch.Tensor:
    """Standard exponential draws (rate 1) of ``shape`` in ``dtype`` on
    ``device`` (``jax.random.exponential``)."""
    return torch.empty(shape, dtype=dtype, device=device).exponential_(
        generator=_device_generator(gen, device))


def _in(v, dtype) -> float:
    """``v`` rounded to ``dtype``: how a Python scalar meets a tensor of
    that dtype in JAX."""
    return float(torch.tensor(v, dtype=dtype))


# ------------------------------------------------------------------ dropout
@register
@dataclasses.dataclass
class Dropout:
    """Inverted dropout; ``p`` = retain probability."""
    p: float = 0.5

    def apply(self, x, gen, train):
        if not train or gen is None or self.p >= 1.0:
            return x
        keep = bernoulli(gen, self.p, x.shape, x.device)
        return torch.where(keep, x / _in(self.p, x.dtype), torch.zeros_like(x))


@register
@dataclasses.dataclass
class AlphaDropout:
    """SELU-preserving dropout: dropped units go to alpha' and the output
    is affinely corrected. ``p`` = retain probability."""
    p: float = 0.95

    ALPHA = 1.6732632423543772
    SCALE = 1.0507009873554805

    def apply(self, x, gen, train):
        if not train or gen is None or self.p >= 1.0:
            return x
        alpha_p = -self.ALPHA * self.SCALE
        keep = bernoulli(gen, self.p, x.shape, x.device)
        a = (self.p + alpha_p ** 2 * self.p * (1 - self.p)) ** -0.5
        b = -a * alpha_p * (1 - self.p)
        dt = x.dtype
        return _in(a, dt) * torch.where(keep, x, _in(alpha_p, dt)) + _in(b, dt)


@register
@dataclasses.dataclass
class GaussianDropout:
    """Multiplicative 1 + N(0, rate / (1 - rate)) noise."""
    rate: float = 0.5

    def apply(self, x, gen, train):
        if not train or gen is None or self.rate <= 0:
            return x
        std = math.sqrt(self.rate / (1.0 - self.rate))
        return x * (1.0 + _in(std, x.dtype) * normal(gen, x.shape, x.dtype, x.device))


@register
@dataclasses.dataclass
class GaussianNoise:
    """Additive N(0, stddev) noise."""
    stddev: float = 0.1

    def apply(self, x, gen, train):
        if not train or gen is None or self.stddev <= 0:
            return x
        return x + _in(self.stddev, x.dtype) * normal(gen, x.shape, x.dtype, x.device)


def resolve_dropout(spec):
    """float (retain probability) -> Dropout, None at 1 or more; a dropout
    object passes through."""
    if spec is None:
        return None
    if isinstance(spec, (int, float)):
        return Dropout(p=float(spec)) if spec < 1.0 else None
    return spec


# -------------------------------------------------------------- weight noise
def _skips(key, apply_to_bias) -> bool:
    # the JAX package's test: every key starting with "b" counts as a bias
    return key.startswith("b") and not apply_to_bias


@register
@dataclasses.dataclass
class DropConnect:
    """Per-weight Bernoulli masking in a training forward; ``p`` = retain
    probability."""
    p: float = 0.5
    apply_to_bias: bool = False

    def apply_to_weights(self, w, key, gen, train):
        if not train or gen is None or _skips(key, self.apply_to_bias):
            return w
        keep = bernoulli(gen, self.p, w.shape, w.device)
        return torch.where(keep, w / _in(self.p, w.dtype), torch.zeros_like(w))


@register
@dataclasses.dataclass
class WeightNoise:
    """Additive or multiplicative Gaussian weight noise."""
    stddev: float = 0.01
    additive: bool = True
    apply_to_bias: bool = False

    def apply_to_weights(self, w, key, gen, train):
        if not train or gen is None or _skips(key, self.apply_to_bias):
            return w
        noise = _in(self.stddev, w.dtype) * normal(gen, w.shape, w.dtype, w.device)
        return w + noise if self.additive else w * (1.0 + noise)


# --------------------------------------------------------------- constraints
def _is_bias_key(k: str) -> bool:
    return k == "b" or k.endswith("_b") or k == "beta"


class BaseConstraint:
    """Projected onto parameters after each update; weights only unless
    ``apply_to_bias``."""
    apply_to_bias = False

    def applies_to(self, key: str) -> bool:
        return self.apply_to_bias or not _is_bias_key(key)

    def project(self, w):
        raise NotImplementedError

    @staticmethod
    def _norm(w):
        # per output unit (the last axis): over all other axes, over axis 0
        # for a rank-1 parameter (peepholes)
        dims = tuple(range(w.dim() - 1)) if w.dim() > 1 else (0,)
        return torch.sqrt(torch.sum(w * w, dim=dims, keepdim=True))


@register
@dataclasses.dataclass
class MaxNormConstraint(BaseConstraint):
    """Clip each unit's L2 norm to ``max_norm``."""
    max_norm: float = 2.0

    def project(self, w):
        norm = self._norm(w)
        return w * torch.clamp(self.max_norm / torch.clamp(norm, min=1e-8), max=1.0)


@register
@dataclasses.dataclass
class MinMaxNormConstraint(BaseConstraint):
    """Move each unit's norm into [min_norm, max_norm] with strength
    ``rate``."""
    min_norm: float = 0.0
    max_norm: float = 2.0
    rate: float = 1.0

    def project(self, w):
        norm = self._norm(w)
        target = self.rate * torch.clamp(norm, self.min_norm, self.max_norm) \
            + (1 - self.rate) * norm
        return w * target / torch.clamp(norm, min=1e-8)


@register
@dataclasses.dataclass
class NonNegativeConstraint(BaseConstraint):
    def project(self, w):
        return torch.clamp(w, min=0.0)


@register
@dataclasses.dataclass
class UnitNormConstraint(BaseConstraint):
    def project(self, w):
        return w / torch.clamp(self._norm(w), min=1e-8)


def apply_constraints(constraints, layer_params):
    """One layer's parameters projected through its constraint list, in
    order (a new dict; parameters no constraint applies to pass as they
    are)."""
    if not constraints:
        return layer_params
    out = dict(layer_params)
    for c in constraints:
        for k, v in out.items():
            if c.applies_to(k):
                out[k] = c.project(v)
    return out
