"""MultiLayerNetwork: sequential network container (inference).

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py``: ``init``,
``output``, ``rnn_time_step``, ``rnn_clear_previous_state`` and the
pair-fusion routing of ``_apply_layers`` (``multilayer.py:272-374``). Two
consecutive plain LSTM layers run as one fused kernel (``ops/lstm_fused.py``,
K3) when :meth:`MultiLayerNetwork._lstm_pair_fusable` admits them; every
other recurrent layer runs the per-layer kernel (``ops/lstm_cell.py``, K1).

Training is not ported yet: the network is built for inference and runs
under ``torch.inference_mode``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from .conf import MultiLayerConfiguration
from .conf.layers import FeedForwardLayer
from .layers import impl_for
from .layers.recurrent import _BaseLSTMImpl
from ..ops import lstm_fused

__all__ = ["MultiLayerNetwork"]


class MultiLayerNetwork(nn.Module):
    def __init__(self, conf: MultiLayerConfiguration):
        super().__init__()
        self.conf = conf
        self.gc = conf.global_conf
        self.impls = None
        self.device = None
        self.iteration_count = 0
        self.epoch_count = 0
        self._rnn_state = None      # streaming state for rnn_time_step

    # ------------------------------------------------------------------ init
    def init(self, params: Optional[Dict[str, Dict]] = None, device="cuda"):
        """Build the layer implementations on ``device`` (the card unless
        ``device="cpu"``). ``params`` ({"0": {"W": ...}, ...}, tensors or
        arrays) installs given weights, shape-checked against the config;
        without it, weights are drawn from a ``torch.Generator`` seeded with
        the config's seed."""
        dev = resolve_device(device)
        layers = self.conf.layers
        it = self.conf.input_type
        if it is not None:
            for i, lc in enumerate(layers):
                lc.set_n_in(it, override=False)
                it = lc.get_output_type(i, it)
        for i, lc in enumerate(layers):
            if isinstance(lc, FeedForwardLayer):
                if lc.n_out is None or lc.n_in is None:
                    raise ValueError(f"Layer {i} ({type(lc).__name__}): n_in and "
                                     f"n_out must be set (or set_input_type)")
        if params is not None:
            extra = set(params) - {str(i) for i in range(len(layers))}
            if extra:
                raise ValueError(f"parameters for unknown layers {sorted(extra)}")
        gen = torch.Generator().manual_seed(int(self.gc.seed))
        impls = []
        for i, lc in enumerate(layers):
            impl = impl_for(lc, self.gc)
            impl.index = i
            p = (params.get(str(i), {}) if params is not None
                 else impl.init_params(gen))
            impl.set_params(p, dev)
            impls.append(impl)
        self.impls = nn.ModuleList(impls)
        self.device = dev
        self._rnn_state = None
        return self

    @property
    def params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {str(i): impl.param_dict() for i, impl in enumerate(self.impls)}

    # -------------------------------------------------------------- forward
    def _to_device(self, a):
        if a is None:
            return None
        t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a)
        if t.is_floating_point():
            t = t.float()
        return t.to(self.device)

    def _apply_layers(self, x, fmask, rnn_state_in=None):
        ctx = {}
        if rnn_state_in is not None:
            ctx["rnn_state_in"] = rnn_state_in
        n = len(self.impls)
        i = 0
        while i < n:
            if i + 1 < n and self._lstm_pair_fusable(i, x, fmask):
                x = self._fused_lstm_forward(x, ctx, i)
                i += 2
                continue
            x = self.impls[i](x, mask=fmask, ctx=ctx)
            i += 1
        return x, ctx

    def _lstm_pair_fusable(self, i, x, fmask) -> bool:
        """Whether layers (i, i+1) run as one K3 launch: no step mask, both
        plain LSTM layers with the kernel's activations, matching
        peepholes, ``n_out == n_in == n_out`` through the pair, and no
        dropout configured on the second layer."""
        if fmask is not None or x.dim() != 3:
            return False
        a, b = self.impls[i], self.impls[i + 1]
        if not (isinstance(a, _BaseLSTMImpl) and isinstance(b, _BaseLSTMImpl)):
            return False
        if a.peepholes != b.peepholes or not (a.kernel_ok() and b.kernel_ok()):
            return False
        if b.dropout_p is not None or a.compute_dtype != b.compute_dtype:
            return False
        return a.conf.n_out == b.conf.n_in == b.conf.n_out

    def _fused_lstm_forward(self, x, ctx, i):
        """Layers (i, i+1) through K3, with the hoisted layer-1 projection
        and the ctx-carried (h, c) state of both layer indices."""
        a, b = self.impls[i], self.impls[i + 1]
        cd = a.compute_dtype
        bsz = x.shape[0]
        xp1 = a.input_projection(x)
        sin = ctx.get("rnn_state_in", {})
        h01, c01 = sin.get(i) or a.init_stream_state(bsz, x.device)
        h02, c02 = sin.get(i + 1) or b.init_stream_state(bsz, x.device)
        ys2, hc1, hc2 = lstm_fused.lstm_scan2(
            xp1, a.RW.to(cd), a.peephole_params(), b.W.to(cd), b.b,
            b.RW.to(cd), b.peephole_params(), h01, c01, h02, c02)
        out = ctx.setdefault("rnn_state_out", {})
        out[i], out[i + 1] = hc1, hc2
        return ys2.to(b.out_dtype)

    # ------------------------------------------------------------- inference
    def output(self, x, mask=None) -> torch.Tensor:
        """Forward to the activations of the last layer. ``mask`` is the
        [b, T] features mask for sequence inputs (values in [0, 1]).
        Inputs may be arrays or tensors; the result is a tensor on the
        network's device."""
        with torch.inference_mode():
            y, _ = self._apply_layers(self._to_device(x), self._to_device(mask))
        return y

    def _init_rnn_state(self, batch):
        return {i: impl.init_stream_state(batch, self.device)
                for i, impl in enumerate(self.impls)
                if hasattr(impl, "init_stream_state")}

    def rnn_time_step(self, x) -> torch.Tensor:
        """Stateful streaming inference: ``x`` [b, T, f] (or one step
        [b, f]) continues from the state the previous call left."""
        with torch.inference_mode():
            x = self._to_device(x)
            single_step = x.dim() == 2
            if single_step:
                x = x[:, None, :]
            if self._rnn_state is None:
                self._rnn_state = self._init_rnn_state(int(x.shape[0]))
            y, ctx = self._apply_layers(x, None, self._rnn_state)
            self._rnn_state = ctx.get("rnn_state_out")
        return y[:, -1, :] if single_step else y

    rnnTimeStep = rnn_time_step

    def rnn_clear_previous_state(self):
        self._rnn_state = None

    rnnClearPreviousState = rnn_clear_previous_state

