"""Weight initialization schemes.

Counterpart of ``deeplearning4j_tpu/nn/weights.py`` with the same formulas
(reference ``WeightInitUtil.initWeights``), drawn from an explicit
``torch.Generator``. The draws differ from the JAX package's (it seeds
numpy from jax key data); only the distributions agree. ``WeightInit``
names the schemes; the five ``Distribution`` classes (reference
``nn/conf/distribution/``) serialise to the JAX package's
``configuration.json`` data, ``{"@class": "NormalDistribution", "mean":
..., "std": ...}``, which a decoded configuration carries as
``serde.PlainConfig``; ``init_weight`` reads either through ``kind`` and
``fields``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["WeightInit", "Distribution", "NormalDistribution", "GaussianDistribution",
           "UniformDistribution", "ConstantDistribution", "BinomialDistribution",
           "init_weight"]


class WeightInit:
    DISTRIBUTION = "distribution"
    ZERO = "zero"
    ONES = "ones"
    CONSTANT = "constant"
    SIGMOID_UNIFORM = "sigmoid_uniform"
    NORMAL = "normal"
    LECUN_NORMAL = "lecun_normal"
    LECUN_UNIFORM = "lecun_uniform"
    UNIFORM = "uniform"
    XAVIER = "xavier"
    XAVIER_UNIFORM = "xavier_uniform"
    XAVIER_FAN_IN = "xavier_fan_in"
    XAVIER_LEGACY = "xavier_legacy"
    RELU = "relu"
    RELU_UNIFORM = "relu_uniform"
    IDENTITY = "identity"
    VAR_SCALING_NORMAL_FAN_IN = "var_scaling_normal_fan_in"
    VAR_SCALING_NORMAL_FAN_OUT = "var_scaling_normal_fan_out"
    VAR_SCALING_NORMAL_FAN_AVG = "var_scaling_normal_fan_avg"
    VAR_SCALING_UNIFORM_FAN_IN = "var_scaling_uniform_fan_in"
    VAR_SCALING_UNIFORM_FAN_OUT = "var_scaling_uniform_fan_out"
    VAR_SCALING_UNIFORM_FAN_AVG = "var_scaling_uniform_fan_avg"


@dataclasses.dataclass
class Distribution:
    """Base for WeightInit.DISTRIBUTION: its class name and fields are the
    data a configuration carries."""

    @property
    def kind(self) -> str:
        return type(self).__name__

    @property
    def fields(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass
class NormalDistribution(Distribution):
    mean: float = 0.0
    std: float = 1.0


# Reference has both GaussianDistribution and NormalDistribution (synonyms).
@dataclasses.dataclass
class GaussianDistribution(NormalDistribution):
    pass


@dataclasses.dataclass
class UniformDistribution(Distribution):
    lower: float = -1.0
    upper: float = 1.0


@dataclasses.dataclass
class ConstantDistribution(Distribution):
    value: float = 0.0


@dataclasses.dataclass
class BinomialDistribution(Distribution):
    trials: int = 1
    p: float = 0.5


def _normal(gen, shape, dtype, scale=1.0, shift=0.0):
    return torch.randn(shape, generator=gen, dtype=torch.float64) \
        .mul_(scale).add_(shift).to(dtype)


def _uniform(gen, shape, dtype, lo, hi):
    return torch.rand(shape, generator=gen, dtype=torch.float64) \
        .mul_(hi - lo).add_(lo).to(dtype)


def _from_dist(gen, dist, shape, dtype):
    """A weight-init distribution: a :class:`Distribution` or the same data
    decoded from JSON (``serde.PlainConfig``)."""
    f = dist.fields
    if dist.kind in ("NormalDistribution", "GaussianDistribution"):
        return _normal(gen, shape, dtype, f.get("std", 1.0), f.get("mean", 0.0))
    if dist.kind == "UniformDistribution":
        return _uniform(gen, shape, dtype, f.get("lower", -1.0), f.get("upper", 1.0))
    if dist.kind == "ConstantDistribution":
        return torch.full(shape, float(f.get("value", 0.0)), dtype=dtype)
    if dist.kind == "BinomialDistribution":
        p = torch.full(shape, float(f.get("p", 0.5)), dtype=torch.float64)
        n = torch.full(shape, float(f.get("trials", 1)), dtype=torch.float64)
        return torch.binomial(n, p, generator=gen).to(dtype)
    raise ValueError(f"Unknown weight distribution '{dist.kind}'")


def init_weight(gen: torch.Generator, shape, fan_in, fan_out,
                scheme="xavier", dist=None, dtype=torch.float32):
    """One weight tensor on the CPU, drawn from ``gen``."""
    scheme = str(scheme).lower()
    fan_in = max(float(fan_in), 1.0)
    fan_out = max(float(fan_out), 1.0)
    if scheme == "distribution":
        if dist is None:
            raise ValueError("WeightInit.DISTRIBUTION requires a Distribution")
        return _from_dist(gen, dist, shape, dtype)
    if scheme == "zero":
        return torch.zeros(shape, dtype=dtype)
    if scheme == "ones":
        return torch.ones(shape, dtype=dtype)
    if scheme == "identity":
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError("IDENTITY init requires a square 2-D shape")
        return torch.eye(shape[0], dtype=dtype)
    if scheme in ("normal", "xavier_fan_in"):
        return _normal(gen, shape, dtype, 1.0 / math.sqrt(fan_in))
    if scheme == "lecun_normal":
        return _normal(gen, shape, dtype, math.sqrt(1.0 / fan_in))
    if scheme == "uniform":
        a = math.sqrt(1.0 / fan_in)
        return _uniform(gen, shape, dtype, -a, a)
    if scheme == "lecun_uniform":
        a = math.sqrt(3.0 / fan_in)
        return _uniform(gen, shape, dtype, -a, a)
    if scheme == "xavier":
        return _normal(gen, shape, dtype, math.sqrt(2.0 / (fan_in + fan_out)))
    if scheme == "xavier_uniform":
        a = math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(gen, shape, dtype, -a, a)
    if scheme == "xavier_legacy":
        return _normal(gen, shape, dtype, math.sqrt(1.0 / (fan_in + fan_out)))
    if scheme == "relu":
        return _normal(gen, shape, dtype, math.sqrt(2.0 / fan_in))
    if scheme == "relu_uniform":
        a = math.sqrt(6.0 / fan_in)
        return _uniform(gen, shape, dtype, -a, a)
    if scheme == "sigmoid_uniform":
        a = 4.0 * math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(gen, shape, dtype, -a, a)
    if scheme.startswith("var_scaling"):
        if scheme.endswith("fan_in"):
            denom = fan_in
        elif scheme.endswith("fan_out"):
            denom = fan_out
        else:
            denom = 0.5 * (fan_in + fan_out)
        if "normal" in scheme:
            return _normal(gen, shape, dtype, math.sqrt(1.0 / denom))
        a = math.sqrt(3.0 / denom)
        return _uniform(gen, shape, dtype, -a, a)
    raise ValueError(f"Unknown weight init scheme '{scheme}'")
