"""VAE reconstruction distributions p(x|z).

Counterpart of ``deeplearning4j_tpu/nn/conf/reconstruction.py`` (reference
``ReconstructionDistribution.java`` and its Gaussian, Bernoulli,
Exponential and Composite implementations, and ``LossFunctionWrapper``).
Each is written once as its math, and autograd differentiates it:

- ``param_size(d)``: the decoder head's width for d data values;
- ``neg_log_prob(x, pre_out)``: -log p(x|z) per example, [b];
- ``sample(gen, pre_out)`` / ``mean(pre_out)``: ``generateRandom`` /
  ``generateAtMean``; the draws go through ``nn/conf/dropout.py``'s
  ``bernoulli``, ``normal`` and ``exponential`` from the ``torch.Generator``
  ``gen``.

All are config dataclasses with the JAX package's field names, so a VAE's
JSON round-trips byte for byte.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch

from . import dropout as _draws
from .serde import register
from ..activations import get_activation

__all__ = ["ReconstructionDistribution", "GaussianReconstructionDistribution",
           "BernoulliReconstructionDistribution", "ExponentialReconstructionDistribution",
           "CompositeReconstructionDistribution", "LossFunctionWrapper",
           "resolve_distribution"]

_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


class ReconstructionDistribution:
    """The contract (reference ``ReconstructionDistribution.java``)."""

    has_loss_function = False

    def param_size(self, data_size: int) -> int:
        raise NotImplementedError

    def neg_log_prob(self, x, pre_out):
        """-log p(x|z) per example, [b]."""
        raise NotImplementedError

    def sample(self, gen, pre_out):
        raise NotImplementedError

    def mean(self, pre_out):
        raise NotImplementedError


@register
@dataclasses.dataclass
class GaussianReconstructionDistribution(ReconstructionDistribution):
    """Diagonal Gaussian with a learned variance: the head emits [mean,
    log sigma^2] (2 values a data value), the activation on both."""

    activation: str = "identity"

    def param_size(self, data_size):
        return 2 * data_size

    def _split(self, pre_out):
        return get_activation(self.activation)(pre_out).chunk(2, dim=-1)

    def neg_log_prob(self, x, pre_out):
        mean, log_var = self._split(pre_out)
        per_elem = _HALF_LOG_2PI + 0.5 * log_var + (x - mean) ** 2 / (2 * torch.exp(log_var))
        return per_elem.sum(-1)

    def sample(self, gen, pre_out):
        mean, log_var = self._split(pre_out)
        eps = _draws.normal(gen, mean.shape, mean.dtype, mean.device)
        return mean + torch.exp(0.5 * log_var) * eps

    def mean(self, pre_out):
        return self._split(pre_out)[0]


@register
@dataclasses.dataclass
class BernoulliReconstructionDistribution(ReconstructionDistribution):
    """Bernoulli p(x|z) for binary data; with the sigmoid activation the
    log-probability takes the stable logits form."""

    activation: str = "sigmoid"

    def param_size(self, data_size):
        return data_size

    def neg_log_prob(self, x, pre_out):
        if self.activation == "sigmoid":
            # max(l, 0) - l x + log(1 + exp(-|l|))
            per_elem = (torch.maximum(pre_out, torch.zeros_like(pre_out)) - pre_out * x
                        + torch.log1p(torch.exp(-pre_out.abs())))
        else:
            p = torch.clamp(get_activation(self.activation)(pre_out), 1e-7, 1 - 1e-7)
            per_elem = -(x * torch.log(p) + (1 - x) * torch.log1p(-p))
        return per_elem.sum(-1)

    def sample(self, gen, pre_out):
        p = self.mean(pre_out)
        return (_draws.bernoulli(gen, p, p.shape, p.device)).to(pre_out.dtype)

    def mean(self, pre_out):
        return get_activation(self.activation)(pre_out)


@register
@dataclasses.dataclass
class ExponentialReconstructionDistribution(ReconstructionDistribution):
    """Exponential p(x|z) for non-negative data: the head models gamma =
    log(lambda), log p(x) = gamma - exp(gamma) x."""

    activation: str = "identity"

    def param_size(self, data_size):
        return data_size

    def _gamma(self, pre_out):
        return get_activation(self.activation)(pre_out)

    def neg_log_prob(self, x, pre_out):
        gamma = self._gamma(pre_out)
        return -(gamma - torch.exp(gamma) * x).sum(-1)

    def sample(self, gen, pre_out):
        lam = torch.exp(self._gamma(pre_out))
        return _draws.exponential(gen, lam.shape, lam.dtype, lam.device) / lam

    def mean(self, pre_out):
        return torch.exp(-self._gamma(pre_out))      # E[x] = 1 / lambda


@register
@dataclasses.dataclass
class CompositeReconstructionDistribution(ReconstructionDistribution):
    """Distributions over consecutive column ranges of x, built from
    (size, distribution) pairs in order."""

    distribution_sizes: Tuple[int, ...] = ()
    distributions: Tuple[ReconstructionDistribution, ...] = ()

    @property
    def has_loss_function(self):
        # the reference: any component wrapping a loss function leaves the
        # composite without a log-probability
        return any(d.has_loss_function for d in self.distributions)

    class Builder:
        def __init__(self):
            self._sizes: List[int] = []
            self._dists: List[ReconstructionDistribution] = []

        def add_distribution(self, size, dist):
            self._sizes.append(int(size))
            self._dists.append(dist)
            return self

        addDistribution = add_distribution

        def build(self):
            return CompositeReconstructionDistribution(tuple(self._sizes), tuple(self._dists))

    @staticmethod
    def builder():
        return CompositeReconstructionDistribution.Builder()

    def param_size(self, data_size):
        if sum(self.distribution_sizes) != data_size:
            raise ValueError(f"Composite distribution sizes {self.distribution_sizes} do "
                             f"not cover data size {data_size}")
        return sum(d.param_size(s) for s, d in zip(self.distribution_sizes, self.distributions))

    def _splits(self, x, pre_out):
        xi = pi = 0
        for s, d in zip(self.distribution_sizes, self.distributions):
            ps = d.param_size(s)
            yield d, None if x is None else x[..., xi:xi + s], pre_out[..., pi:pi + ps]
            xi, pi = xi + s, pi + ps

    def neg_log_prob(self, x, pre_out):
        return sum(d.neg_log_prob(xs, ps) for d, xs, ps in self._splits(x, pre_out))

    def sample(self, gen, pre_out):
        # one generator a part, split from gen in turn (jax.random.split)
        gens = [torch.Generator().manual_seed(_draws.draw_seed(gen)) for _ in self.distributions]
        return torch.cat([d.sample(g, ps) for g, (d, _, ps) in
                          zip(gens, self._splits(None, pre_out))], dim=-1)

    def mean(self, pre_out):
        return torch.cat([d.mean(ps) for d, _, ps in self._splits(None, pre_out)], dim=-1)


@register
@dataclasses.dataclass
class LossFunctionWrapper(ReconstructionDistribution):
    """A deterministic reconstruction through a loss function: no p(x|z);
    ``neg_log_prob`` is the loss of each example alone, a sample is the
    activated output."""

    loss: str = "mse"
    activation: str = "identity"

    has_loss_function = True

    def param_size(self, data_size):
        return data_size

    def neg_log_prob(self, x, pre_out):
        from ..losses import get_loss
        fn = get_loss(self.loss)
        # the batch-averaged loss of a batch of one, per example
        return torch.stack([fn(x[i:i + 1], pre_out[i:i + 1], self.activation, None)
                            for i in range(x.shape[0])])

    def sample(self, gen, pre_out):
        return self.mean(pre_out)

    def mean(self, pre_out):
        return get_activation(self.activation)(pre_out)


def resolve_distribution(spec) -> ReconstructionDistribution:
    """A distribution object as it is, or one from a legacy name."""
    if isinstance(spec, ReconstructionDistribution):
        return spec
    name = str(spec).lower()
    if name == "gaussian":
        return GaussianReconstructionDistribution()
    if name == "bernoulli":
        return BernoulliReconstructionDistribution()
    if name == "exponential":
        return ExponentialReconstructionDistribution()
    raise ValueError(f"Unknown reconstruction distribution {spec!r}")
