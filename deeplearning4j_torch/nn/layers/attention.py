"""Multi-head self-attention layer.

Counterpart of ``deeplearning4j_tpu/nn/layers/attention.py``: the routing
of ``mha`` (the flash-attention kernels of ``ops/flash_attention.py`` for
long, block-divisible sequences, the dense body otherwise), the dense body
``_dense_attention`` and the full-sequence forward of
``SelfAttentionImpl``. Streaming inference over the KV cache
(``_cached_attention``) and the sequence-parallel ring are not ported yet
and raise.

Attention dropout in training draws from the network's
``torch.Generator`` (``ctx["rng"]``): on the flash route one int32 seed per
call for the kernels' counter hash, on the dense route a keep mask from a
device generator seeded from it. The streams differ from the JAX
package's; the semantics are the same.
"""
from __future__ import annotations

import torch

from .base import LayerImpl, implements
from ...ops import flash_attention as fa

_INT32_MAX = 2 ** 31 - 1


def _draw_seed(gen: torch.Generator) -> int:
    return int(torch.randint(0, _INT32_MAX, (), generator=gen))


def mha(q, k, v, causal, compute_dtype, dropout_rate=0.0, gen=None, train=False,
        key_mask=None):
    """q, k, v: [b, T, h, d] -> [b, T, h, d]. Scaled dot-product attention
    with an f32 softmax; ``key_mask`` [b, S] (1 = a real key) excludes
    padded keys. Takes the flash kernels when ``q.shape == k.shape`` and
    :func:`ops.flash_attention.supported` holds (T >= ``MIN_SEQ``, T % 128
    == 0, d <= 256 in bf16 and <= 128 in f32, b x h <= 65535), else the
    dense body."""
    b, T, h, d = q.shape
    rate = dropout_rate if (train and gen is not None) else 0.0
    if q.shape == k.shape and fa.supported(T, d, rate, key_mask, dtype=compute_dtype,
                                           bh=b * h):
        seed = _draw_seed(gen) if rate > 0.0 else None
        return fa.flash_attention(q.to(compute_dtype), k.to(compute_dtype),
                                  v.to(compute_dtype), causal=causal, key_mask=key_mask,
                                  dropout_rate=rate, dropout_seed=seed)
    visible = None
    if causal:
        S = k.shape[1]
        visible = torch.tril(torch.ones((T, S), dtype=torch.bool, device=q.device))[None, None]
    if key_mask is not None:
        km = key_mask[:, None, None, :] > 0
        visible = km if visible is None else (visible & km)
    return _dense_attention(q, k, v, visible, compute_dtype, rate, gen)


def _dense_attention(q, k, v, visible, compute_dtype, rate=0.0, gen=None):
    """The dense body: logits from compute-dtype operands (bf16 logits under
    bf16 compute, as the JAX einsum without ``preferred_element_type``),
    divided by sqrt(d) in f32, masked to -1e30 where not ``visible``
    (broadcastable to [b, h, Tq, Tk]), softmax in f32; a query row with no
    visible key outputs 0, as the flash kernels do."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(compute_dtype), k.to(compute_dtype))
    logits = logits.float() / torch.sqrt(torch.tensor(float(d)))
    if visible is not None:
        logits = torch.where(visible, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    if visible is not None:
        probs = torch.where(visible.any(dim=-1, keepdim=True), probs, torch.zeros_like(probs))
    if rate > 0.0:
        g = torch.Generator(device=probs.device).manual_seed(_draw_seed(gen))
        keep = torch.rand(probs.shape, generator=g, device=probs.device) < 1.0 - rate
        probs = torch.where(keep, probs / (1.0 - rate), torch.zeros_like(probs))
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(compute_dtype), v.to(compute_dtype))


@implements("SelfAttentionLayer")
class SelfAttentionImpl(LayerImpl):
    """Parameters ``Wq``, ``Wk``, ``Wv`` [nIn, h*d], ``Wo`` [h*d, nOut] and
    ``b`` [nOut]: q/k/v projections in the activations' type, ``mha``, the
    output projection plus bias, the activation, cast to ``out_dtype``."""

    def _dims(self):
        c = self.conf
        h = c.num_heads
        return h, c.head_dim or (c.n_out // h)

    def param_shapes(self):
        c = self.conf
        h, d = self._dims()
        return {"Wq": (c.n_in, h * d), "Wk": (c.n_in, h * d), "Wv": (c.n_in, h * d),
                "Wo": (h * d, c.n_out), "b": (c.n_out,)}

    def init_params(self, gen):
        c = self.conf
        h, d = self._dims()
        params = {n: self._init_w(gen, (c.n_in, h * d), c.n_in, h * d) for n in ("Wq", "Wk", "Wv")}
        params["Wo"] = self._init_w(gen, (h * d, c.n_out), h * d, c.n_out)
        params["b"] = torch.full((c.n_out,), self.bias_init, dtype=self.dtype)
        return params

    def forward(self, x, mask=None, ctx=None):
        c = self.conf
        h, d = self._dims()
        b, T, _ = x.shape
        ctx = ctx or {}
        if self.index in ctx.get("rnn_state_in", {}):
            raise NotImplementedError("SelfAttentionLayer streaming over the KV cache "
                                      "(rnn_time_step, TBPTT) is not ported yet")
        q = (x @ self.Wq.to(x.dtype)).reshape(b, T, h, d)
        k = (x @ self.Wk.to(x.dtype)).reshape(b, T, h, d)
        v = (x @ self.Wv.to(x.dtype)).reshape(b, T, h, d)
        o = mha(q, k, v, c.causal, self.compute_dtype, c.dropout_rate, ctx.get("rng"),
                ctx.get("train", False), key_mask=mask)
        o = o.reshape(b, T, h * d)
        y = o @ self.Wo.to(o.dtype) + self.b.to(o.dtype)
        return self.activation(y).to(self.out_dtype)
