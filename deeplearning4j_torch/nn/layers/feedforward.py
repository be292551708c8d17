"""Feed-forward layer implementations.

Counterpart of ``deeplearning4j_tpu/nn/layers/feedforward.py`` (DenseLayer,
ActivationLayer, DropoutLayer, EmbeddingLayer, EmbeddingSequenceLayer, and
the pretrain layers AutoEncoder and RBM).

A pretrain layer's ``pretrain_loss(x, gen, p)`` is its unsupervised loss
on its input ``x``, drawing from the ``torch.Generator`` ``gen`` through
``nn/conf/dropout.py``; its methods take the parameters ``p`` ({name:
tensor}), or the layer's own when ``p`` is None, so that a gradient check
can differentiate them as a function of a parameter tree.
"""
from __future__ import annotations

import torch

from .base import LayerImpl, implements, train_rng
from ..conf import dropout as _draws
from ..losses import get_loss


def _dot(x, w, compute_dtype):
    """x @ w with both operands in the compute dtype; the result keeps that
    dtype, as the JAX ``_dot`` does (its bf16 product is returned in bf16)."""
    return torch.matmul(x.to(compute_dtype), w.to(compute_dtype))


@implements("DenseLayer")
class DenseImpl(LayerImpl):
    def param_shapes(self):
        c = self.conf
        shapes = {"W": (c.n_in, c.n_out)}
        if getattr(c, "has_bias", True):
            shapes["b"] = (c.n_out,)
        return shapes

    def init_params(self, gen):
        c = self.conf
        params = {"W": self._init_w(gen, (c.n_in, c.n_out), c.n_in, c.n_out)}
        if "b" in self.param_shapes():
            params["b"] = torch.full((c.n_out,), self.bias_init, dtype=self.dtype)
        return params

    def preout(self, x):
        z = _dot(x, self.W, self.compute_dtype)
        if "b" in self._parameters:
            z = z + self.b.to(z.dtype)
        return z

    def forward(self, x, mask=None, ctx=None):
        x = self.maybe_dropout(x, *train_rng(ctx))
        return self.activation(self.preout(x)).to(self.out_dtype)


@implements("ActivationLayer")
class ActivationImpl(LayerImpl):
    """The activation alone; the output keeps the input's dtype."""

    save_output = False  # recomputed under remat (GlobalConfig.remat)

    def forward(self, x, mask=None, ctx=None):
        return self.activation(x)


@implements("DropoutLayer")
class DropoutImpl(LayerImpl):
    """The layer's dropout on its input in training, else the identity."""

    save_output = False  # recomputed under remat (GlobalConfig.remat)

    def forward(self, x, mask=None, ctx=None):
        return self.maybe_dropout(x, *train_rng(ctx))


@implements("EmbeddingSequenceLayer")
class EmbeddingSequenceImpl(LayerImpl):
    """Index sequence [b, T] (or [b, T, 1]) -> [b, T, nOut] by a row gather
    of ``W`` (autograd scatter-adds the rows' gradients). Float ids
    truncate toward zero, as the JAX package's ``astype(int32)`` does."""

    def param_shapes(self):
        c = self.conf
        shapes = {"W": (c.n_in, c.n_out)}
        if c.has_bias:
            shapes["b"] = (c.n_out,)
        return shapes

    def init_params(self, gen):
        c = self.conf
        params = {"W": self._init_w(gen, (c.n_in, c.n_out), c.n_in, c.n_out)}
        if c.has_bias:
            params["b"] = torch.full((c.n_out,), self.bias_init, dtype=self.dtype)
        return params

    def forward(self, x, mask=None, ctx=None):
        if x.dim() == 3 and x.shape[-1] == 1:
            x = x[..., 0]
        z = self.W[x.long()]
        if "b" in self._parameters:
            z = z + self.b
        return self.activation(z).to(self.out_dtype)


@implements("EmbeddingLayer")
class EmbeddingImpl(DenseImpl):
    """One index an example -> [b, nOut] by a row gather of ``W`` (``W``
    [nIn, nOut] and ``b`` as a DenseLayer's). The input is [b] or [b, 1]
    indices (floats truncate toward zero) or a one-hot [b, nIn] (its
    argmax). As ``jnp.take`` in the JAX package, an index in [-nIn, 0)
    wraps to ``nIn + index`` and one outside [-nIn, nIn) gives a NaN row
    (and no gradient), where a plain gather would stop the card with a
    device-side assert. No input dropout, as in the JAX package."""

    def forward(self, x, mask=None, ctx=None):
        if x.dim() == 2 and x.shape[-1] == 1:
            x = x[..., 0]
        idx = x.argmax(-1) if x.dim() == 2 else x.long()
        n = self.conf.n_in
        rows = self.W[torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)]
        inside = ((idx >= -n) & (idx < n))[..., None]
        z = torch.where(inside, rows, torch.full((), float("nan"), dtype=rows.dtype,
                                                 device=rows.device))
        if "b" in self._parameters:
            z = z + self.b
        return self.activation(z).to(self.out_dtype)


def _params(impl, p):
    return impl.param_dict() if p is None else p


class _TiedImpl(LayerImpl):
    """``W`` [nIn, nOut], hidden bias ``b`` [nOut] and visible bias ``vb``
    [nIn] (the reference's pretrain parameter layout)."""

    def param_shapes(self):
        c = self.conf
        return {"W": (c.n_in, c.n_out), "b": (c.n_out,), "vb": (c.n_in,)}

    def init_params(self, gen):
        c = self.conf
        return {"W": self._init_w(gen, (c.n_in, c.n_out), c.n_in, c.n_out),
                "b": torch.full((c.n_out,), self.bias_init, dtype=self.dtype),
                "vb": torch.full((c.n_in,), self.bias_init, dtype=self.dtype)}


@implements("AutoEncoder")
class AutoEncoderImpl(_TiedImpl):
    """Denoising autoencoder (reference ``AutoEncoder.java``): a forward is
    the encoder act(x W + b); ``pretrain_loss`` decodes through the tied
    weights, act(h W^T + vb), and takes the layer's loss against the
    uncorrupted input, the input corrupted first by zeroing each entry with
    probability ``corruption_level`` (no corruption without ``gen``)."""

    def encode(self, x, p=None):
        p = _params(self, p)
        return self.activation(_dot(x, p["W"], self.compute_dtype) + p["b"])

    def decode(self, h, p=None):
        p = _params(self, p)
        return self.activation(_dot(h, p["W"].T, self.compute_dtype) + p["vb"])

    def forward(self, x, mask=None, ctx=None):
        x = self.maybe_dropout(x, *train_rng(ctx))
        return self.encode(x).to(self.out_dtype)

    def pretrain_loss(self, x, gen=None, p=None):
        c = self.conf
        if c.corruption_level and gen is not None:
            keep = _draws.bernoulli(gen, 1.0 - c.corruption_level, x.shape, x.device)
            xc = torch.where(keep, x, torch.zeros_like(x))
        else:
            xc = x
        recon = self.decode(self.encode(xc, p), p)
        return get_loss(c.loss)(x, recon, "identity", None)


@implements("RBM")
class RBMImpl(_TiedImpl):
    """Restricted Boltzmann Machine (reference ``RBM.java``: ``propUp``,
    ``propDown``, ``contrastiveDivergence``). A forward is ``prop_up``.
    ``pretrain_loss`` is CD-k as the surrogate mean(F(v0) - F(v_k)), the
    k-step Gibbs chain run without gradient: its gradient is the CD update
    <v0 h0> - <vk hk> for binary hidden units (softplus free energy) and
    for gaussian and identity ones (quadratic); rectified units take the
    softplus form too, as in the JAX package. ``sparsity`` adds the squared
    distance of the mean hidden activation from it."""

    _HIDDEN = ("binary", "rectified", "gaussian", "identity")
    _VISIBLE = ("binary", "gaussian", "linear", "identity")

    def __init__(self, conf, gc):
        super().__init__(conf, gc)
        if conf.hidden_unit not in self._HIDDEN:
            raise ValueError(f"RBM hidden_unit '{conf.hidden_unit}' not in {self._HIDDEN}")
        if conf.visible_unit not in self._VISIBLE:
            raise ValueError(f"RBM visible_unit '{conf.visible_unit}' not in {self._VISIBLE}")

    def _hidden_z(self, v, p):
        return _dot(v, p["W"], self.compute_dtype) + p["b"]

    def prop_up(self, v, p=None):
        """Mean hidden activation given the visible units."""
        z = self._hidden_z(v, _params(self, p))
        hu = self.conf.hidden_unit
        if hu == "binary":
            return torch.sigmoid(z)
        if hu == "rectified":
            return torch.relu(z)
        return z

    def prop_down(self, h, p=None):
        """Mean visible activation given the hidden units."""
        p = _params(self, p)
        z = _dot(h, p["W"].T, self.compute_dtype) + p["vb"]
        return torch.sigmoid(z) if self.conf.visible_unit == "binary" else z

    def _sample_h(self, v, gen, p):
        hu = self.conf.hidden_unit
        z = self._hidden_z(v, p)
        if hu == "binary":
            return _draws.bernoulli(gen, torch.sigmoid(z), z.shape, z.device).to(z.dtype)
        if hu == "rectified":
            # noisy rectified units: max(0, z + N(0, sigmoid(z)))
            return torch.relu(z + torch.sqrt(torch.sigmoid(z))
                              * _draws.normal(gen, z.shape, z.dtype, z.device))
        if hu == "gaussian":
            return z + _draws.normal(gen, z.shape, z.dtype, z.device)
        return z

    def _sample_v(self, h, gen, p):
        vu = self.conf.visible_unit
        mean = self.prop_down(h, p)
        if vu == "binary":
            return _draws.bernoulli(gen, mean, mean.shape, mean.device).to(mean.dtype)
        if vu == "gaussian":
            return mean + _draws.normal(gen, mean.shape, mean.dtype, mean.device)
        return mean

    def free_energy(self, v, p=None):
        """F(v): -v.vb (binary visible) or 0.5 ||v - vb||^2, then
        -sum softplus(z) or, for gaussian and identity hidden units,
        -0.5 sum z^2."""
        p = _params(self, p)
        z = self._hidden_z(v, p)
        if self.conf.hidden_unit in ("gaussian", "identity"):
            hidden = -0.5 * (z * z).sum(-1)
        else:
            hidden = -torch.logaddexp(z, torch.zeros_like(z)).sum(-1)
        if self.conf.visible_unit == "binary":
            dt = torch.promote_types(v.dtype, p["vb"].dtype)    # as JAX promotes v @ vb
            vis = -(v.to(dt) @ p["vb"].to(dt))
        else:
            diff = v - p["vb"]
            vis = 0.5 * (diff * diff).sum(-1)
        return vis + hidden

    def gibbs_chain(self, v0, gen, k, p=None):
        """k alternating steps, h | v then v | h, each drawn from ``gen``."""
        p = _params(self, p)
        v = v0
        for _ in range(k):
            v = self._sample_v(self._sample_h(v, gen, p), gen, p)
        return v

    def forward(self, x, mask=None, ctx=None):
        x = self.maybe_dropout(x, *train_rng(ctx))
        return self.prop_up(x).to(self.out_dtype)

    def pretrain_loss(self, x, gen=None, p=None):
        c = self.conf
        gen = torch.Generator().manual_seed(0) if gen is None else gen
        with torch.no_grad():
            vk = self.gibbs_chain(x, gen, max(1, int(c.k)), p)
        loss = (self.free_energy(x, p) - self.free_energy(vk, p)).mean()
        if c.sparsity:
            mean_h = self.prop_up(x, p).mean(0)
            loss = loss + ((mean_h - c.sparsity) ** 2).sum()
        return loss

    def reconstruction_error(self, x, p=None):
        """Mean squared error of v -> mean h -> mean v (a monitoring
        number: the CD surrogate is not one)."""
        recon = self.prop_down(self.prop_up(x, p), p)
        return ((recon - x) ** 2).mean()
