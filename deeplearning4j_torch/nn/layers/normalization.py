"""Normalization layer implementations: BatchNormalization,
LayerNormalization, LocalResponseNormalization.

Counterpart of ``deeplearning4j_tpu/nn/layers/normalization.py``
(``BatchNormImpl``, ``LayerNormImpl``, ``LRNImpl``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .base import LayerImpl, acc_dtype, implements


def batch_norm(x, mean, var, gamma, beta, eps, train):
    """Per-channel BN of ``x`` over all but its last axis, as one aten
    batch-norm call on the free [n, C] view: statistics accumulated in f32
    (f64 for f64 ``x``) by one Welford pass, ``(x - mean) * rsqrt(var + eps)
    * gamma + beta`` computed at that precision and rounded once to x's
    dtype (the JAX package rounds each step to it), and autograd saving
    only ``x`` and the [C] statistics (the JAX package's ``save_output =
    False``). Under ``train`` the batch's statistics normalise and are
    returned as (mean, biased var): aten's running update, at momentum 1
    into fresh buffers, yields the batch mean and the unbiased variance,
    which is rescaled by (n - 1) / n. Otherwise ``mean``/``var`` normalise."""
    c = x.shape[-1]
    n = x.numel() // c
    sd = torch.promote_types(x.dtype, torch.float32)
    if train:
        mean = torch.zeros(c, dtype=sd, device=x.device)
        var = torch.zeros(c, dtype=sd, device=x.device)
    else:
        mean, var = mean.to(sd), var.to(sd)
    y = torch.batch_norm(x.reshape(n, c), gamma.to(sd), beta.to(sd), mean, var, train, 1.0,
                         eps, torch.backends.cudnn.enabled).view(x.shape)
    if not train:
        return y
    return y, mean, (var * ((n - 1) / n) if n > 1 else torch.zeros_like(var))


@implements("BatchNormalization")
class BatchNormImpl(LayerImpl):
    """Per-channel BN over [b, f] and NHWC [b, h, w, c] (reference
    ``BatchNormalization.java``): parameters ``gamma``/``beta`` (none under
    ``lock_gamma_beta``: the config's constants), state ``mean``/``var`` in
    the statistics' dtype (f32 under bf16 compute). Training normalises with
    the batch's statistics and offers running = decay * running + (1 -
    decay) * batch, the variance biased, as the new state; inference uses
    the running ones. No L1/L2 on its parameters."""

    save_output = False  # recomputed under remat (GlobalConfig.remat)

    def param_shapes(self):
        n = self.conf.n_out
        return {} if self.conf.lock_gamma_beta else {"gamma": (n,), "beta": (n,)}

    def init_params(self, gen):
        c = self.conf
        return {k: torch.full(shape, getattr(c, k), dtype=self.dtype)
                for k, shape in self.param_shapes().items()}

    def init_state(self):
        sd = acc_dtype(self.compute_dtype)
        n = self.conf.n_out
        return {"mean": torch.zeros(n, dtype=sd), "var": torch.ones(n, dtype=sd)}

    def forward(self, x, mask=None, ctx=None):
        c = self.conf
        sd = acc_dtype(self.compute_dtype)
        if "gamma" in self._parameters:
            gamma, beta = self.gamma, self.beta
        else:
            gamma = torch.full((c.n_out,), c.gamma, dtype=self.dtype, device=x.device)
            beta = torch.full((c.n_out,), c.beta, dtype=self.dtype, device=x.device)
        if not (ctx or {}).get("train", False):
            return batch_norm(x, self.mean, self.var, gamma, beta, c.eps, False)
        y, mean, var = batch_norm(x, None, None, gamma, beta, c.eps, True)
        if "new_states" in ctx:
            ctx["new_states"][self.index] = {
                "mean": c.decay * self.mean + (1 - c.decay) * mean.to(sd),
                "var": c.decay * self.var + (1 - c.decay) * var.to(sd)}
        return y

    def regularization(self):
        return 0.0


@implements("LayerNormalization")
class LayerNormImpl(LayerImpl):
    """Per-position LayerNorm over the last (feature) dim with learned
    ``gain``/``bias``, on [b, F] or [b, T, F]. Moments in f32 under bf16
    compute, the variance in two passes (the mean of (x - mean)^2, not
    E[x^2] - E[x]^2), ``rsqrt(var + eps)``, and the result cast back to the
    input's type. No L1/L2 on its parameters."""

    save_output = False  # recomputed under remat (GlobalConfig.remat)

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


@implements("LocalResponseNormalization")
class LRNImpl(LayerImpl):
    """Across-channel LRN on NHWC (reference
    ``LocalResponseNormalization.java``): y = x / (k + alpha * s)^beta, s
    the sum of x^2 over the channels c - n // 2 ... c + n // 2 that exist
    (2 (n // 2) + 1 of them: n + 1 for an even n), alpha undivided. Not
    ``F.local_response_norm``, which divides alpha by n and takes a window
    of n. The sum is one windowed pool over the channel axis of the [N, 1,
    1, c] view (``avg_pool2d`` with ``divisor_override=1``, zero padded),
    and the arithmetic runs in f32 (f64 for f64 x), rounded once to x's
    dtype (the JAX package rounds each step to it). No parameters."""

    save_output = False  # recomputed under remat (GlobalConfig.remat)

    def forward(self, x, mask=None, ctx=None):
        c = self.conf
        half = int(c.n) // 2
        sd = torch.promote_types(x.dtype, torch.float32)
        xs = x.to(sd)
        ch = x.shape[-1]
        sq = (xs * xs).reshape(-1, 1, 1, ch)
        acc = F.avg_pool2d(sq, (1, 2 * half + 1), 1, (0, half), divisor_override=1)
        return (xs / (c.k + c.alpha * acc.view(x.shape)).pow(c.beta)).to(x.dtype)
