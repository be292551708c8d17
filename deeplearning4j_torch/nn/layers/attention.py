"""Multi-head self-attention layer.

Counterpart of ``deeplearning4j_tpu/nn/layers/attention.py``: the routing
of ``mha`` (the flash-attention kernels of ``ops/flash_attention.py`` for
long, block-divisible sequences, the dense body otherwise), the dense body
``_dense_attention``, the full-sequence forward of ``SelfAttentionImpl``
and streaming over its KV cache (``init_stream_state``,
``_cached_attention``: ``rnn_time_step`` of a ComputationGraph). The
sequence-parallel ring is not ported.

Attention dropout in training draws from the layer's ``torch.Generator``
for the step (``ctx["rng"]``, which also draws the layer's input dropout
before the q/k/v projections): on the flash route one int32 seed per call
for the kernels' counter hash, on the dense route a keep mask from a
device generator seeded from it. The streams differ from the JAX
package's; the semantics are the same.
"""
from __future__ import annotations

import torch

from .base import LayerImpl, implements, train_rng
from ..conf.dropout import draw_seed
from ...ops import flash_attention as fa


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
        seed = draw_seed(gen) if rate > 0.0 else None
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
        g = torch.Generator(device=probs.device).manual_seed(draw_seed(gen))
        keep = torch.rand(probs.shape, generator=g, device=probs.device) < 1.0 - rate
        probs = torch.where(keep, probs / (1.0 - rate), torch.zeros_like(probs))
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(compute_dtype), v.to(compute_dtype))


@implements("SelfAttentionLayer")
class SelfAttentionImpl(LayerImpl):
    """Parameters ``Wq``, ``Wk``, ``Wv`` [nIn, h*d], ``Wo`` [h*d, nOut] and
    ``b`` [nOut]: q/k/v projections in the activations' type, ``mha``, the
    output projection plus bias, the activation, cast to ``out_dtype``."""

    #: the training forward carries no state from step to step (the KV
    #: cache is inference's), so it does not turn "auto" remat off
    scan_free_training = True

    def draws(self) -> bool:
        return super().draws() or self.conf.dropout_rate > 0.0

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

    def init_stream_state(self, batch, device):
        """The KV cache of streaming inference: a circular buffer of
        ``stream_max_length`` slots of k and v [b, L, h, d] in the compute
        dtype, each example's global position per slot [b, L] (-1: empty
        or masked, kept per example so that uneven key padding stays
        exact), and the global token counter, a Python int so that
        building positions needs no sync."""
        h, d = self._dims()
        L = int(self.conf.stream_max_length)
        kv = torch.zeros((batch, L, h, d), dtype=self.compute_dtype, device=device)
        return (kv, kv.clone(), torch.full((batch, L), -1, dtype=torch.int64, device=device), 0)

    def _cached_attention(self, q, k, v, carry, key_mask, rate, gen):
        """Attention of one chunk against the KV cache, a sliding window:
        past capacity the oldest entries are evicted. The chunk attends
        over [retained cache | this chunk] before its writes land, so each
        causal query at global position p sees exactly the keys at
        positions in (p - L, p], as if the chunk were fed a token at a
        time; a non-causal query sees every key retained after the
        chunk's writes. Key-masked tokens advance time but are never
        visible. One dense body with ``mha``'s."""
        k_c, v_c, pos_c, n = carry
        b, T = q.shape[:2]
        L = k_c.shape[1]
        if T > L:
            raise ValueError(
                f"SelfAttentionLayer stream chunk of {T} tokens exceeds "
                f"stream_max_length={L}; raise stream_max_length on the "
                f"layer config (it must cover the TBPTT segment length)")
        qpos = torch.arange(n, n + T, device=q.device)                 # [T]
        chunk_pos = qpos.expand(b, T)
        if key_mask is not None:
            chunk_pos = torch.where(key_mask > 0, chunk_pos, -1)
        k, v = k.to(k_c.dtype), v.to(v_c.dtype)
        pos_all = torch.cat([pos_c, chunk_pos], dim=1)[:, None, :]      # [b, 1, L+T]
        visible = pos_all >= 0
        if self.conf.causal:
            p = qpos[None, :, None]
            visible = visible & (pos_all <= p) & (pos_all > p - L)     # [b, Tq, L+T]
        else:
            visible = visible & (pos_all > n + T - 1 - L)
        o = _dense_attention(q, torch.cat([k_c, k], dim=1), torch.cat([v_c, v], dim=1),
                             visible[:, None], self.compute_dtype, rate, gen)
        slots = qpos % L
        return o, (k_c.index_copy(1, slots, k), v_c.index_copy(1, slots, v),
                   pos_c.index_copy(1, slots, chunk_pos), n + T)

    def forward(self, x, mask=None, ctx=None):
        c = self.conf
        h, d = self._dims()
        b, T, _ = x.shape
        ctx = ctx or {}
        x = self.maybe_dropout(x, *train_rng(ctx))
        q = (x @ self.Wq.to(x.dtype)).reshape(b, T, h, d)
        k = (x @ self.Wk.to(x.dtype)).reshape(b, T, h, d)
        v = (x @ self.Wv.to(x.dtype)).reshape(b, T, h, d)
        carry = ctx.get("rnn_state_in", {}).get(self.index)
        if carry is not None:
            gen = ctx.get("rng")
            rate = c.dropout_rate if (ctx.get("train", False) and gen is not None) else 0.0
            o, carry = self._cached_attention(q, k, v, carry, mask, rate, gen)
            ctx.setdefault("rnn_state_out", {})[self.index] = carry
        else:
            o = mha(q, k, v, c.causal, self.compute_dtype, c.dropout_rate, ctx.get("rng"),
                    ctx.get("train", False), key_mask=mask)
        o = o.reshape(b, T, h * d)
        y = o @ self.Wo.to(o.dtype) + self.b.to(o.dtype)
        return self.activation(y).to(self.out_dtype)
