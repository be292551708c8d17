"""Feed-forward layer implementations.

Counterpart of ``deeplearning4j_tpu/nn/layers/feedforward.py`` (DenseLayer,
ActivationLayer, DropoutLayer, EmbeddingSequenceLayer).
"""
from __future__ import annotations

import torch

from .base import LayerImpl, implements, train_rng


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

    def forward(self, x, mask=None, ctx=None):
        return self.activation(x)


@implements("DropoutLayer")
class DropoutImpl(LayerImpl):
    """The layer's dropout on its input in training, else the identity."""

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
