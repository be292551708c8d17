"""Mixture-of-experts dense layer.

Counterpart of ``deeplearning4j_tpu/nn/layers/moe.py``: a softmax router,
top-k gates renormalised over the kept experts, and two combines, both in
one-hot einsum form with the expert dimension as an array axis:

- the dense combine (every token through every expert, gate-weighted):
  inference, and training at ``capacity_factor`` 0;
- capacity dispatch in training (GShard/Switch): tokens in groups of
  ``group_size``, each expert a fixed buffer of C slots a group, filled
  slot-major (every token's first choice before any second choice), so an
  expert over capacity drops its lowest-gate assignments.

The Switch load-balancing loss (``aux_loss_weight`` x E x sum_e f_e P_e,
f_e the share of tokens whose top-1 expert is e, P_e the mean router
probability) goes into ``ctx["aux_loss"]``, which both containers add to
the training objective.

Top-k picks the larger gate first and, among equal gates, the lower expert
index (``jax.lax.top_k``'s order): a stable descending sort, so an
all-uniform row keeps experts 0..k-1 on any device. The router runs in at
least f32 (f64 under an f64 parameter dtype); the expert products run in
the compute dtype, and a bf16 product comes out in bf16 (f32 accumulation
inside it), as the JAX package's ``pet_dtype`` has it.
"""
from __future__ import annotations

import torch

from .base import LayerImpl, implements, train_rng

__all__ = ["MoEDenseImpl"]


def _top_k_indices(x, k):
    """Indices of the k largest entries of the last axis, largest first,
    ties to the lower index."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


@implements("MoEDenseLayer")
class MoEDenseImpl(LayerImpl):
    def __init__(self, conf, gc):
        super().__init__(conf, gc)
        E = conf.num_experts
        if E < 1 or not (1 <= conf.top_k <= E):
            raise ValueError(f"MoEDenseLayer needs 1 <= top_k <= num_experts "
                             f"(got top_k={conf.top_k}, num_experts={E})")
        if conf.capacity_factor < 0:
            raise ValueError(f"capacity_factor must be >= 0 (got {conf.capacity_factor})")

    def param_shapes(self):
        c = self.conf
        shapes = {"Wg": (c.n_in, c.num_experts), "W": (c.num_experts, c.n_in, c.n_out)}
        if c.has_bias:
            shapes["b"] = (c.num_experts, c.n_out)
        return shapes

    def init_params(self, gen):
        c = self.conf
        E = c.num_experts
        params = {"Wg": self._init_w(gen, (c.n_in, E), c.n_in, E),
                  "W": self._init_w(gen, (E, c.n_in, c.n_out), c.n_in, c.n_out)}
        if c.has_bias:
            params["b"] = torch.full((E, c.n_out), self.bias_init, dtype=self.dtype)
        return params

    def _router_dtype(self):
        return torch.promote_types(torch.float32, self.dtype)

    def _route(self, xr, Wg):
        """(gates [n, E], zero outside each row's top k and renormalised;
        the router's probabilities [n, E])."""
        c = self.conf
        probs = torch.softmax(xr @ Wg.to(xr.dtype), dim=-1)
        if c.top_k >= c.num_experts:
            return probs, probs
        keep = torch.zeros_like(probs).scatter_(-1, _top_k_indices(probs, c.top_k), 1.0)
        gates = probs * keep
        return gates / gates.sum(-1, keepdim=True), probs

    def _dense_combine(self, flat, gates, cd):
        """Every token through every expert, gate-weighted: the inference
        path and the oracle for the capacity dispatch."""
        h = torch.einsum("nf,efo->neo", flat.to(cd), self.W.to(cd))
        if "b" in self._parameters:
            h = h + self.b.to(h.dtype)
        return torch.einsum("ne,neo->no", gates.to(h.dtype), h)

    def _capacity(self, n):
        """Slots an expert has for a group of n tokens: the JAX package's
        arithmetic (a float ceiling, then a multiple of 8, at most n
        rounded up to 8), kept as it is so both pick the same C."""
        c = self.conf
        k = min(c.top_k, c.num_experts)
        cap = -(-k * n * c.capacity_factor // c.num_experts)
        return int(min(max(8, -(-cap // 8) * 8), max(8, -(-n // 8) * 8)))

    def _sparse_combine(self, flat, gates, cd):
        """Capacity dispatch over groups of ``group_size`` tokens (the last
        group padded with zero-gate rows that claim no slot): a one-hot
        dispatch tensor [g, G, E, C], the experts on their [C, F] buffers,
        and the gate-weighted combine back to the tokens."""
        c = self.conf
        n, E = flat.shape[0], c.num_experts
        k = min(c.top_k, E)
        G = max(8, min(n, int(c.group_size or 1024)))
        g = -(-n // G)
        pad = g * G - n
        if pad:
            flat = torch.cat([flat, flat.new_zeros((pad, flat.shape[1]))])
            gates = torch.cat([gates, gates.new_zeros((pad, E))])
        C = self._capacity(G)
        xg = flat.reshape(g, G, -1)
        gg = gates.reshape(g, G, E)
        experts = torch.arange(E, device=flat.device)
        mask = (_top_k_indices(gg, k)[..., None] == experts).to(torch.int32)   # [g, G, k, E]
        if pad:
            valid = (torch.arange(g * G, device=flat.device) < n).reshape(g, G)
            mask = mask * valid[:, :, None, None].to(torch.int32)
        mk = mask.permute(0, 2, 1, 3).reshape(g, k * G, E)                   # slot-major
        pos_t = ((torch.cumsum(mk, dim=1) - 1) * mk).sum(-1)                  # [g, k*G]
        keep = (pos_t < C) & (mk.sum(-1) > 0)
        # one-hot by comparison: an over-capacity position (>= C) matches no
        # slot, as jax.nn.one_hot's all-zero row for it
        slot = ((pos_t[..., None] == torch.arange(C, device=flat.device)) & keep[..., None]).to(cd)
        disp = (mk.to(cd)[..., None] * slot[..., None, :]).reshape(g, k, G, E, C).sum(1)
        combine = disp * gg.to(cd)[..., None]
        expert_in = torch.einsum("gnec,gnf->egcf", disp, xg.to(cd))
        h = torch.einsum("egcf,efo->egco", expert_in, self.W.to(cd))
        if "b" in self._parameters:
            h = h + self.b.to(h.dtype)[:, None, None, :]
        y = torch.einsum("gnec,egco->gno", combine, h)
        return y.reshape(g * G, -1)[:n]

    def forward(self, x, mask=None, ctx=None):
        c = self.conf
        x = self.maybe_dropout(x, *train_rng(ctx))
        flat = x.reshape(-1, x.shape[-1])
        rdt = self._router_dtype()
        gates, probs = self._route(flat.to(rdt), self.Wg)
        cd = self.compute_dtype
        train = bool((ctx or {}).get("train", False))
        if c.capacity_factor and c.capacity_factor > 0 and train:
            y = self._sparse_combine(flat, gates, cd)
        else:
            y = self._dense_combine(flat, gates, cd)
        y = y.reshape(x.shape[:-1] + (c.n_out,))
        if ctx is not None and c.aux_loss_weight > 0.0:
            top1 = torch.nn.functional.one_hot(probs.argmax(-1), c.num_experts).to(rdt)
            aux = c.aux_loss_weight * c.num_experts * (top1.mean(0) * probs.mean(0)).sum()
            ctx["aux_loss"] = ctx.get("aux_loss", 0.0) + aux
        return self.activation(y).to(self.out_dtype)
