"""Recurrent layer implementations: LSTM, GravesLSTM, GravesBidirectionalLSTM,
SimpleRnn, and the Bidirectional and LastTimeStep wrappers.

Counterpart of ``deeplearning4j_tpu/nn/layers/recurrent.py``. The input
projection is hoisted out of the time loop: one [b*T, nIn] x [nIn, 4H]
matmul (``recurrent.py:97-100``), left to ``torch.matmul``. The
sequential part of an LSTM takes one of two routes, chosen from the
configuration and the shape before anything launches
(``ops/lstm_cell.supported``, the JAX package's ``_lk.supported``):

- the persistent-LSTM kernels (``ops/lstm_cell.py``): K1 for inference
  and, while autograd records (training), K1 writing the BPTT reserve
  forward and K2 backward;
- the step loop (:meth:`_BaseLSTMImpl._step_loop`, the JAX package's
  ``lax.scan`` step body, ``recurrent.py:128-160``) for every layer the
  kernels do not take: another cell or gate activation, or on the card H
  % 8 != 0. Autograd gives its backward.

The step mask is data and gets no gradient (``recurrent.py:92``). A
``reverse`` run flips x and the mask over time and flips y back, so a
right-padded sequence's backward direction starts on masked steps that
carry the zero state.

Sequence layout is [batch, time, features]; gate order in the 4H dimension
is i, f, o, g. Param keys: "W" [nIn, 4H], "RW" [H, 4H], "b" [4H]; Graves
peepholes "pi", "pf", "po" [H]; GravesBidirectionalLSTM suffixes them "F"
and "B" per direction. A Bidirectional wrapper nests its two copies of the
inner layer's parameters under "fwd" and "bwd"; LastTimeStep has its inner
layer's parameters as they are.

Streaming state flows through ``ctx``: the network places per-layer
previous (h, c) (SimpleRnn: h) under ``ctx['rnn_state_in'][layer_index]``
and collects ``ctx['rnn_state_out']``.
"""
from __future__ import annotations

import torch

from .base import LayerImpl, acc_dtype, impl_for, implements, split_generator, train_rng
from ..activations import get_activation
from ...ops import lstm_cell

__all__ = ["LSTMImpl", "GravesLSTMImpl", "GravesBidirectionalLSTMImpl", "SimpleRnnImpl",
           "BidirectionalImpl", "LastTimeStepImpl"]


def _stream_in(ctx, index):
    if ctx is None or index is None:
        return None
    return ctx.get("rnn_state_in", {}).get(index)


def _stream_out(ctx, index, state):
    if ctx is not None and index is not None:
        ctx.setdefault("rnn_state_out", {})[index] = state


class _BaseLSTMImpl(LayerImpl):
    peepholes = False

    @property
    def gate_name(self) -> str:
        return str(getattr(self.conf, "gate_activation", "sigmoid"))

    def init_stream_state(self, batch, device):
        """Zero (h, c) carry for rnn_time_step."""
        z = torch.zeros((batch, self.conf.n_out), device=device,
                        dtype=acc_dtype(self.compute_dtype))
        return z, z.clone()

    def param_shapes(self):
        c = self.conf
        H = c.n_out
        shapes = {"W": (c.n_in, 4 * H), "RW": (H, 4 * H), "b": (4 * H,)}
        if self.peepholes:
            shapes.update(pi=(H,), pf=(H,), po=(H,))
        return shapes

    def init_params(self, gen):
        c = self.conf
        H = c.n_out
        params = {"W": self._init_w(gen, (c.n_in, 4 * H), c.n_in, H),
                  "RW": self._init_w(gen, (H, 4 * H), H, H),
                  "b": torch.full((4 * H,), self.bias_init, dtype=self.dtype)}
        # forget-gate bias init (reference LSTMParamInitializer)
        params["b"][H:2 * H] = getattr(c, "forget_gate_bias_init", 1.0)
        if self.peepholes:
            for k in ("pi", "pf", "po"):
                params[k] = torch.zeros((H,), dtype=self.dtype)
        return params

    def direction(self, suffix=""):
        """One direction's parameters under their plain names ("W", "RW",
        "b", peepholes): the attributes named with ``suffix``."""
        return {k: getattr(self, k + suffix) for k in _BaseLSTMImpl.param_shapes(self)}

    def peephole_params(self, p=None):
        p = self.direction() if p is None else p
        return (p["pi"], p["pf"], p["po"]) if self.peepholes else None

    def input_projection(self, x, p=None):
        """[b, T, nIn] -> xp [b, T, 4H] in the accumulation dtype, bias added.
        The product is rounded to the compute dtype first, as in the JAX
        package."""
        p = self.direction() if p is None else p
        b, T, _ = x.shape
        cd = self.compute_dtype
        ad = acc_dtype(cd)
        xp = torch.matmul(x.reshape(b * T, -1).to(cd), p["W"].to(cd)).to(ad)
        return xp.reshape(b, T, 4 * self.conf.n_out) + p["b"].to(ad)

    def kernel_route(self, x) -> bool:
        """Whether this layer runs on K1/K2 for input ``x`` (else the step
        loop)."""
        b, T, _ = x.shape
        return lstm_cell.supported(b, T, self.conf.n_out, self.activation_name,
                                   self.gate_name, x.device)

    def _run(self, x, mask, h0c0, reverse=False, p=None):
        p = self.direction() if p is None else p
        if mask is not None:
            mask = mask.detach()
        if reverse:
            x = x.flip(1)
            mask = None if mask is None else mask.flip(1)
        if h0c0 is None:
            h0c0 = self.init_stream_state(x.shape[0], x.device)
        xp = self.input_projection(x, p)
        rw = p["RW"].to(self.compute_dtype)
        run = lstm_cell.lstm_scan if self.kernel_route(x) else self._step_loop
        y, hc = run(xp, rw, self.peephole_params(p), h0c0[0], h0c0[1], mask)
        if reverse:
            y = y.flip(1)
        return y.to(self.out_dtype), hc

    def _step_loop(self, xp, rw, peep, h0, c0, mask=None):
        """The JAX package's scan step body over time, for any cell and gate
        activation: ``z = xp_t + h_{t-1} RW`` with h rounded to RW's
        (compute) dtype and the products accumulated in xp's dtype,
        peepholes on c_{t-1} for i and f and on c_t for o, and a fractional
        mask that carries h and c. Returns (ys [b, T, H], (hT, cT)) in xp's
        dtype."""
        H = self.conf.n_out
        act, gate = self.activation, get_activation(self.gate_name)
        ad = xp.dtype
        rwa = rw.to(ad)
        h, c = h0.to(ad), c0.to(ad)
        ys = []
        for t in range(xp.shape[1]):
            zi, zf, zo, zg = (xp[:, t] + h.to(rw.dtype).to(ad) @ rwa).split(H, dim=1)
            if peep is not None:
                zi = zi + c * peep[0]
                zf = zf + c * peep[1]
            c_new = gate(zf) * c + gate(zi) * act(zg)
            if peep is not None:
                zo = zo + c_new * peep[2]
            h_new = gate(zo) * act(c_new)
            if mask is not None:
                m = mask[:, t, None].to(ad)
                h_new = m * h_new + (1 - m) * h
                c_new = m * c_new + (1 - m) * c
            ys.append(h_new)
            h, c = h_new, c_new
        y = torch.stack(ys, 1) if ys else xp.new_zeros((xp.shape[0], 0, H))
        return y, (h, c)

    def forward(self, x, mask=None, ctx=None):
        x = self.maybe_dropout(x, *train_rng(ctx))
        y, hc = self._run(x, mask, _stream_in(ctx, self.index))
        _stream_out(ctx, self.index, hc)
        return y


@implements("LSTM")
class LSTMImpl(_BaseLSTMImpl):
    peepholes = False


@implements("GravesLSTM")
class GravesLSTMImpl(_BaseLSTMImpl):
    peepholes = True


@implements("GravesBidirectionalLSTM")
class GravesBidirectionalLSTMImpl(_BaseLSTMImpl):
    """Two GravesLSTM parameter sets, suffixed "F" and "B" (reference
    ``GravesBidirectionalLSTMParamInitializer``): the forward direction
    runs ``_run``, the backward ``_run(reverse=True)``, each on K1/K2 or
    the step loop by the route predicate, and their outputs are summed (the
    output stays [b, T, nOut]). As in the JAX package the forward neither
    reads nor writes the streaming state, so ``rnn_time_step`` runs each
    call's chunk afresh in both directions. Never fused into a pair (K3/K4
    run one direction)."""
    peepholes = True

    def param_shapes(self):
        one = super().param_shapes()
        return {k + s: v for s in "FB" for k, v in one.items()}

    def init_params(self, gen):
        out = {}
        for s in "FB":
            out.update({k + s: v for k, v in super().init_params(gen).items()})
        return out

    def forward(self, x, mask=None, ctx=None):
        x = self.maybe_dropout(x, *train_rng(ctx))
        yf, _ = self._run(x, mask, None, p=self.direction("F"))
        yb, _ = self._run(x, mask, None, reverse=True, p=self.direction("B"))
        return yf + yb


@implements("SimpleRnn")
class SimpleRnnImpl(LayerImpl):
    """``h_t = act(x_t W + h_{t-1} RW + b)`` (post-0.9 reference
    ``SimpleRnn``) as a loop over time, with the input product hoisted and
    the recurrent product's operands in the compute dtype, accumulated in
    the accumulation dtype. The JAX package has no kernel for it."""

    def param_shapes(self):
        c = self.conf
        return {"W": (c.n_in, c.n_out), "RW": (c.n_out, c.n_out), "b": (c.n_out,)}

    def init_params(self, gen):
        c = self.conf
        return {"W": self._init_w(gen, (c.n_in, c.n_out), c.n_in, c.n_out),
                "RW": self._init_w(gen, (c.n_out, c.n_out), c.n_out, c.n_out),
                "b": torch.full((c.n_out,), self.bias_init, dtype=self.dtype)}

    def init_stream_state(self, batch, device):
        """Zero h carry for rnn_time_step."""
        return torch.zeros((batch, self.conf.n_out), device=device,
                           dtype=acc_dtype(self.compute_dtype))

    def forward(self, x, mask=None, ctx=None):
        x = self.maybe_dropout(x, *train_rng(ctx))
        b, T, _ = x.shape
        H = self.conf.n_out
        cd = self.compute_dtype
        ad = acc_dtype(cd)
        xp = torch.matmul(x.reshape(b * T, -1).to(cd), self.W.to(cd)).to(ad)
        xp = xp.reshape(b, T, H) + self.b.to(ad)
        rwa = self.RW.to(cd).to(ad)
        if mask is not None:
            mask = mask.detach()
        h = _stream_in(ctx, self.index)
        h = self.init_stream_state(b, x.device) if h is None else h.to(ad)
        ys = []
        for t in range(T):
            h_new = self.activation(xp[:, t] + h.to(cd).to(ad) @ rwa)
            if mask is not None:
                m = mask[:, t, None].to(ad)
                h_new = m * h_new + (1 - m) * h
            ys.append(h_new)
            h = h_new
        _stream_out(ctx, self.index, h)
        y = torch.stack(ys, 1) if ys else xp.new_zeros((b, 0, H))
        return y.to(self.out_dtype)


@implements("Bidirectional")
class BidirectionalImpl(LayerImpl):
    """The inner layer twice, as submodules ``fwd`` and ``bwd``, with
    parameters ``{"fwd": {...}, "bwd": {...}}``: ``bwd`` runs on the
    sequence and mask flipped over time and its output is flipped back,
    then the two merge by ``mode`` (concat, add, mul, ave). Each direction
    runs without streaming state, and in training draws its dropout from
    its own half of the layer's generator (``split_generator``, the JAX
    package's ``jax.random.split``). Weight noise and constraints are the
    inner layer's: as in the JAX package the container noises no wrapper
    parameter."""

    def __init__(self, conf, gc):
        super().__init__(conf, gc)
        self.fwd = impl_for(conf.inner, gc)
        self.bwd = impl_for(conf.inner, gc)

    def param_shapes(self):
        return {"fwd": self.fwd.param_shapes(), "bwd": self.bwd.param_shapes()}

    def init_params(self, gen):
        return {"fwd": self.fwd.init_params(gen), "bwd": self.bwd.init_params(gen)}

    def set_params(self, params, device) -> None:
        if set(params) != {"fwd", "bwd"}:
            raise ValueError(f"layer {self.index} (Bidirectional): parameters "
                             f"{sorted(params)} do not match ['bwd', 'fwd']")
        self.fwd.set_params(params["fwd"], device)
        self.bwd.set_params(params["bwd"], device)

    def param_dict(self):
        return {"fwd": self.fwd.param_dict(), "bwd": self.bwd.param_dict()}

    def draws(self) -> bool:
        return self.fwd.draws()

    def constraint_sets(self):
        return self.fwd.constraint_sets() + self.bwd.constraint_sets()

    def regularization(self):
        return self.fwd.regularization() + self.bwd.regularization()

    def _merge(self, a, b):
        mode = self.conf.mode
        if mode == "concat":
            return torch.cat([a, b], dim=-1)
        if mode == "add":
            return a + b
        if mode == "mul":
            return a * b
        if mode == "ave":
            return 0.5 * (a + b)
        raise ValueError(f"Unknown Bidirectional mode {mode}")

    def _directions(self, x, mask, ctx):
        train, gen = train_rng(ctx)
        gf, gb = split_generator(gen)
        yf = self.fwd(x, mask=mask, ctx={"train": train, "rng": gf})
        yb = self.bwd(x.flip(1), mask=None if mask is None else mask.flip(1),
                      ctx={"train": train, "rng": gb})
        return yf, yb

    def forward(self, x, mask=None, ctx=None):
        yf, yb = self._directions(x, mask, ctx)
        return self._merge(yf, yb.flip(1))

    def forward_last(self, x, mask=None, ctx=None):
        """Each direction's final output, merged (Keras
        ``Bidirectional(..., return_sequences=False)``): the backward
        direction's last step is its state after the whole reversed
        sequence, not the t = T-1 slot of the flipped output. With
        right-padded masks each direction's final output is its last valid
        state (padding freezes the forward one; the backward one carries
        zeros through the leading padding)."""
        yf, yb = self._directions(x, mask, ctx)
        return self._merge(yf[:, -1], yb[:, -1])


@implements("LastTimeStep")
class LastTimeStepImpl(LayerImpl):
    """The inner layer's output at each sequence's last valid step:
    ``sum(mask > 0) - 1``, clamped at 0 (the last step without a mask); a
    Bidirectional inner layer gives its ``forward_last``. Its parameters
    are the inner layer's, as they are."""

    def __init__(self, conf, gc):
        super().__init__(conf, gc)
        self.inner = impl_for(conf.inner, gc)

    def param_shapes(self):
        return self.inner.param_shapes()

    def init_params(self, gen):
        return self.inner.init_params(gen)

    def set_params(self, params, device) -> None:
        self.inner.set_params(params, device)

    def param_dict(self):
        return self.inner.param_dict()

    def draws(self) -> bool:
        return self.inner.draws()

    def constraint_sets(self):
        return self.inner.constraint_sets()

    def regularization(self):
        return self.inner.regularization()

    def forward(self, x, mask=None, ctx=None):
        if hasattr(self.inner, "forward_last"):
            return self.inner.forward_last(x, mask=mask, ctx=ctx)
        y = self.inner(x, mask=mask, ctx=ctx)
        if mask is None:
            return y[:, -1]
        last = torch.clamp((mask > 0).sum(1) - 1, min=0)
        return y[torch.arange(y.shape[0], device=y.device), last]
