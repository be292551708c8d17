"""Variational autoencoder implementation.

Counterpart of ``deeplearning4j_tpu/nn/layers/variational.py`` (reference
``nn/layers/variational/VariationalAutoencoder.java``): an MLP encoder ->
diagonal Gaussian q(z|x) -> an MLP decoder -> a reconstruction
distribution p(x|z) of ``nn/conf/reconstruction.py``. A forward gives the
mean of q(z|x); ``pretrain_loss`` is the negative ELBO over
``num_samples`` reparameterised draws; ``reconstruction_log_probability``
is the importance-sampled log p(x) the reference scores anomalies with,
and ``reconstruction_error`` serves the loss-function distributions.

Parameters, in init order: ``eW{i}``/``eb{i}`` the encoder's, ``zW``/
``zb`` the [mean, log variance] head, ``dW{i}``/``db{i}`` the decoder's,
``xW``/``xb`` the distribution head. Every method takes the parameters
``p`` or, when it is None, the layer's own; the draws go through
``nn/conf/dropout.normal`` from the ``torch.Generator`` ``gen``.
"""
from __future__ import annotations

import math

import torch

from .base import LayerImpl, implements, train_rng
from .feedforward import _dot, _params
from ..activations import get_activation
from ..conf import dropout as _draws
from ..conf.reconstruction import resolve_distribution

__all__ = ["VAEImpl"]


@implements("VariationalAutoencoder")
class VAEImpl(LayerImpl):
    @property
    def recon_dist(self):
        return resolve_distribution(self.conf.reconstruction_distribution)

    def _sizes(self):
        c = self.conf
        return [c.n_in] + list(c.encoder_layer_sizes), [c.n_out] + list(c.decoder_layer_sizes)

    def param_shapes(self):
        c = self.conf
        enc, dec = self._sizes()
        shapes = {}
        for i in range(len(enc) - 1):
            shapes[f"eW{i}"], shapes[f"eb{i}"] = (enc[i], enc[i + 1]), (enc[i + 1],)
        shapes["zW"], shapes["zb"] = (enc[-1], 2 * c.n_out), (2 * c.n_out,)
        for i in range(len(dec) - 1):
            shapes[f"dW{i}"], shapes[f"db{i}"] = (dec[i], dec[i + 1]), (dec[i + 1],)
        px = self.recon_dist.param_size(c.n_in)
        shapes["xW"], shapes["xb"] = (dec[-1], px), (px,)
        return shapes

    def init_params(self, gen):
        return {k: (self._init_w(gen, s, s[0], s[1]) if len(s) == 2
                    else torch.full(s, self.bias_init, dtype=self.dtype))
                for k, s in self.param_shapes().items()}

    def encode(self, x, p=None):
        """(mean, log variance) of q(z|x)."""
        p = _params(self, p)
        h = x
        for i in range(len(self._sizes()[0]) - 1):
            h = self.activation(_dot(h, p[f"eW{i}"], self.compute_dtype) + p[f"eb{i}"])
        mean, log_var = (_dot(h, p["zW"], self.compute_dtype) + p["zb"]).chunk(2, dim=-1)
        return get_activation(self.conf.pzx_activation)(mean), log_var

    def decode(self, z, p=None):
        """z -> the distribution's parameters before its activation."""
        p = _params(self, p)
        h = z
        for i in range(len(self._sizes()[1]) - 1):
            h = self.activation(_dot(h, p[f"dW{i}"], self.compute_dtype) + p[f"db{i}"])
        return _dot(h, p["xW"], self.compute_dtype) + p["xb"]

    def forward(self, x, mask=None, ctx=None):
        x = self.maybe_dropout(x, *train_rng(ctx))
        return self.encode(x)[0].to(self.out_dtype)

    def has_loss_function(self):
        """Reference ``hasLossFunction()``: true for a LossFunctionWrapper."""
        return self.recon_dist.has_loss_function

    hasLossFunction = has_loss_function

    def _draw_z(self, mean, log_var, gen):
        eps = _draws.normal(gen, mean.shape, mean.dtype, mean.device)
        return mean + torch.exp(0.5 * log_var) * eps, eps

    def pretrain_loss(self, x, gen=None, p=None):
        """Negative ELBO: KL(q(z|x) || N(0, I)) + the mean over
        ``num_samples`` draws z = mean + sigma eps of -log p(x|z), averaged
        over the batch."""
        c = self.conf
        gen = torch.Generator().manual_seed(0) if gen is None else gen
        mean, log_var = self.encode(x, p)
        kl = -0.5 * (1 + log_var - mean * mean - torch.exp(log_var)).sum(-1)
        recon = 0.0
        for _ in range(c.num_samples):
            z, _ = self._draw_z(mean, log_var, gen)
            recon = recon + self.recon_dist.neg_log_prob(x, self.decode(z, p))
        return (recon / c.num_samples + kl).mean()

    def reconstruction_log_probability(self, x, gen=None, num_samples=None, p=None):
        """log p(x) per example, importance-sampled (reference
        ``reconstructionLogProbability``): logsumexp_k [log p(x|z_k) +
        log p(z_k) - log q(z_k|x)] - log K, z_k ~ q(z|x)."""
        if self.recon_dist.has_loss_function:
            raise ValueError("reconstruction_log_probability is undefined for "
                             "LossFunctionWrapper distributions: use reconstruction_error")
        n = num_samples or self.conf.num_samples
        gen = torch.Generator().manual_seed(0) if gen is None else gen
        mean, log_var = self.encode(x, p)
        log_2pi = math.log(2 * math.pi)
        logws = []
        for _ in range(n):
            z, eps = self._draw_z(mean, log_var, gen)
            log_p_xz = -self.recon_dist.neg_log_prob(x, self.decode(z, p))
            log_prior = -0.5 * (z * z + log_2pi).sum(-1)
            log_q = -0.5 * (eps * eps + log_2pi + log_var).sum(-1)
            logws.append(log_p_xz + log_prior - log_q)
        return torch.logsumexp(torch.stack(logws), dim=0) - math.log(float(n))

    def reconstruction_probability(self, x, gen=None, num_samples=None, p=None):
        """exp of :meth:`reconstruction_log_probability`."""
        return torch.exp(self.reconstruction_log_probability(x, gen, num_samples, p))

    def reconstruction_error(self, x, p=None):
        """The loss of each example's reconstruction at the mean of q(z|x)
        (reference ``reconstructionError``; LossFunctionWrapper only)."""
        if not self.recon_dist.has_loss_function:
            raise ValueError("reconstruction_error requires a LossFunctionWrapper "
                             "distribution: use reconstruction_log_probability")
        return self.recon_dist.neg_log_prob(x, self.decode(self.encode(x, p)[0], p))

    def generate_at_mean_given_z(self, z, p=None):
        """Reference ``generateAtMeanGivenZ``."""
        return self.recon_dist.mean(self.decode(z, p))

    generateAtMeanGivenZ = generate_at_mean_given_z

    def generate_random_given_z(self, z, gen, p=None):
        """Reference ``generateRandomGivenZ``."""
        return self.recon_dist.sample(gen, self.decode(z, p))

    generateRandomGivenZ = generate_random_given_z
