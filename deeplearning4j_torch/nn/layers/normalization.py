"""Normalization layer implementations: LayerNormalization.

Counterpart of ``deeplearning4j_tpu/nn/layers/normalization.py``
(``LayerNormImpl``).
"""
from __future__ import annotations

import torch

from .base import LayerImpl, acc_dtype, implements


@implements("LayerNormalization")
class LayerNormImpl(LayerImpl):
    """Per-position LayerNorm over the last (feature) dim with learned
    ``gain``/``bias``, on [b, F] or [b, T, F]. Moments in f32 under bf16
    compute, the variance in two passes (the mean of (x - mean)^2, not
    E[x^2] - E[x]^2), ``rsqrt(var + eps)``, and the result cast back to the
    input's type. No L1/L2 on its parameters."""

    def param_shapes(self):
        n = self.conf.n_out
        return {"gain": (n,), "bias": (n,)}

    def init_params(self, gen):
        n = self.conf.n_out
        return {"gain": torch.ones(n, dtype=self.dtype), "bias": torch.zeros(n, dtype=self.dtype)}

    def forward(self, x, mask=None, ctx=None):
        sd = acc_dtype(self.compute_dtype)
        xs = x.to(sd)
        mean = xs.mean(dim=-1, keepdim=True)
        var = ((xs - mean) ** 2).mean(dim=-1, keepdim=True)
        y = (xs - mean) * torch.rsqrt(var + self.conf.eps)
        return (y * self.gain.to(sd) + self.bias.to(sd)).to(x.dtype)

    def regularization(self):
        return 0.0
