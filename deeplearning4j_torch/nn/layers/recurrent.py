"""Recurrent layer implementations: LSTM and GravesLSTM.

Counterpart of ``deeplearning4j_tpu/nn/layers/recurrent.py``. The input
projection is hoisted out of the time loop: one [b*T, nIn] x [nIn, 4H]
matmul (``recurrent.py:97-100``), left to ``torch.matmul``; the sequential
part runs in the persistent-LSTM kernels (``ops/lstm_cell.py``): K1 for
inference and, while autograd records (training), K1 writing the BPTT
reserve forward and K2 backward. The step mask is data and gets no
gradient (``recurrent.py:92``).

Sequence layout is [batch, time, features]; gate order in the 4H dimension
is i, f, o, g. Param keys: "W" [nIn, 4H], "RW" [H, 4H], "b" [4H]; Graves
peepholes "pi", "pf", "po" [H].

Streaming state flows through ``ctx``: the network places per-layer
previous (h, c) under ``ctx['rnn_state_in'][layer_index]`` and collects
``ctx['rnn_state_out']``.
"""
from __future__ import annotations

import torch

from .base import LayerImpl, implements, acc_dtype, train_rng
from ...ops import lstm_cell

__all__ = ["LSTMImpl", "GravesLSTMImpl"]


class _BaseLSTMImpl(LayerImpl):
    peepholes = False

    def kernel_ok(self) -> bool:
        """The kernels hard-code a tanh cell and sigmoid gates."""
        gate = str(getattr(self.conf, "gate_activation", "sigmoid")).lower()
        return str(self.activation_name).lower() == "tanh" and gate == "sigmoid"

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

    def peephole_params(self):
        return (self.pi, self.pf, self.po) if self.peepholes else None

    def input_projection(self, x):
        """[b, T, nIn] -> xp [b, T, 4H] in the accumulation dtype, bias added.
        The product is rounded to the compute dtype first, as in the JAX
        package."""
        b, T, _ = x.shape
        cd = self.compute_dtype
        ad = acc_dtype(cd)
        xp = torch.matmul(x.reshape(b * T, -1).to(cd), self.W.to(cd)).to(ad)
        return xp.reshape(b, T, 4 * self.conf.n_out) + self.b.to(ad)

    def _run(self, x, mask, h0c0):
        if not self.kernel_ok():
            raise NotImplementedError(
                f"layer {self.index}: the LSTM kernel takes tanh/sigmoid "
                f"activations only, got {self.activation_name}/"
                f"{getattr(self.conf, 'gate_activation', 'sigmoid')}")
        b = x.shape[0]
        if h0c0 is None:
            h0c0 = self.init_stream_state(b, x.device)
        xp = self.input_projection(x)
        y, hc = lstm_cell.lstm_scan(xp, self.RW.to(self.compute_dtype),
                                    self.peephole_params(), h0c0[0], h0c0[1],
                                    mask)
        return y.to(self.out_dtype), hc

    def forward(self, x, mask=None, ctx=None):
        x = self.maybe_dropout(x, *train_rng(ctx))
        h0c0 = None
        if ctx is not None and self.index is not None:
            h0c0 = ctx.get("rnn_state_in", {}).get(self.index)
        y, hc = self._run(x, mask, h0c0)
        if ctx is not None and self.index is not None:
            ctx.setdefault("rnn_state_out", {})[self.index] = hc
        return y


@implements("LSTM")
class LSTMImpl(_BaseLSTMImpl):
    peepholes = False


@implements("GravesLSTM")
class GravesLSTMImpl(_BaseLSTMImpl):
    peepholes = True

