"""MultiLayerNetwork: sequential network container.

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py``. Inference:
``init``, ``output``, ``rnn_time_step``, ``rnn_clear_previous_state``.
Training: ``fit`` (a DataSet, an iterator, or arrays), one update per
minibatch or, with truncated BPTT, per segment (``_fit_batch``,
``_fit_tbptt``), ``score`` and ``compute_gradient_and_score``. The update
is the JAX step core (``_raw_update_core``/``_raw_step``): loss ->
autograd gradients -> minimize flip -> ``normalize_gradients`` -> the
layer's updater -> ``p - u``, applied in place.

Two consecutive plain LSTM layers run as one fused kernel
(``ops/lstm_fused.py``: K3, and K4 backward in training) when
:meth:`MultiLayerNetwork._lstm_pair_fusable` admits them
(``multilayer.py:299-334``); every other recurrent layer runs the
per-layer kernel (``ops/lstm_cell.py``: K1, and K2 backward). Eager
PyTorch takes the place of the JAX package's jitted step and its
``lax.scan`` over TBPTT segments.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from .conf import BackpropType, CacheMode, MultiLayerConfiguration
from .conf.layers import FeedForwardLayer
from .layers import impl_for
from .layers.recurrent import _BaseLSTMImpl
from .updaters import Sgd
from ..datasets.dataset import DataSet, ListDataSetIterator, MultiDataSet, to_tensor
from ..datasets.prefetch import wrap_for_training
from ..ops import lstm_fused
from ..optimize.updater import NetworkUpdater, normalize_gradients

__all__ = ["MultiLayerNetwork"]

log = logging.getLogger(__name__)


def _n_iterations(gc) -> int:
    """Optimizer iterations per minibatch or TBPTT segment (0.9.x
    ``iterations``)."""
    return int(getattr(gc, "iterations", 1) or 1)


def _detached(state):
    return None if state is None else {i: tuple(t.detach() for t in hc)
                                       for i, hc in state.items()}


class MultiLayerNetwork(nn.Module):
    def __init__(self, conf: MultiLayerConfiguration):
        super().__init__()
        self.conf = conf
        self.gc = conf.global_conf
        self.impls = None
        self.device = None
        self.updater = None         # NetworkUpdater
        self.updater_state = None   # {"0": {"W": state, ...}, ...}
        self.iteration_count = 0
        self.epoch_count = 0
        self.score_ = float("nan")
        self.last_etl_ms = 0.0      # wait for the last minibatch in fit
        self._rnn_state = None      # streaming state for rnn_time_step
        self._warned_tbptt = False

    # ------------------------------------------------------------------ init
    def init(self, params: Optional[Dict[str, Dict]] = None, device="cuda"):
        """Build the layer implementations on ``device`` (the card unless
        ``device="cpu"``). ``params`` ({"0": {"W": ...}, ...}, tensors or
        arrays) installs copies of given weights, shape-checked against the
        config; without it, weights are drawn from a ``torch.Generator``
        seeded with the config's seed. Updater state starts at zero."""
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
        # one updater per layer: its own override or the global default
        self.updater = NetworkUpdater({
            str(i): getattr(lc, "updater", None) or self.gc.updater or Sgd(learning_rate=1e-1)
            for i, lc in enumerate(layers)})
        self.updater_state = self.updater.init_state(self.params)
        return self

    @property
    def params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{"0": {"W": tensor, ...}, ...}: detached views of the parameters
        (they share storage, so they follow training)."""
        return {i: {k: p.detach() for k, p in ps.items()}
                for i, ps in self._trainable().items()}

    def _trainable(self) -> Dict[str, Dict[str, nn.Parameter]]:
        return {str(i): impl.param_dict() for i, impl in enumerate(self.impls)}

    # -------------------------------------------------------------- forward
    def _to_device(self, a):
        """An input array as a tensor on the network's device (floating
        data as float32); an identity on a tensor the prefetch pipeline
        already put there."""
        return to_tensor(a, self.device)

    def _apply_layers(self, x, fmask, rnn_state_in=None, train=False, upto=None):
        """Run layers [0, upto). Returns (x, ctx); ``ctx["rnn_state_out"]``
        holds each recurrent layer's final (h, c)."""
        ctx = {}
        if rnn_state_in is not None:
            ctx["rnn_state_in"] = rnn_state_in
        n = len(self.impls) if upto is None else upto
        i = 0
        while i < n:
            if i + 1 < n and self._lstm_pair_fusable(i, x, fmask, train):
                x = self._fused_lstm_forward(x, ctx, i)
                i += 2
                continue
            x = self.impls[i](x, mask=fmask, ctx=ctx)
            i += 1
        return x, ctx

    def _lstm_pair_fusable(self, i, x, fmask, train=False) -> bool:
        """Whether layers (i, i+1) run as one fused launch (K3, and K4 in
        training): no step mask, both plain LSTM layers with the kernels'
        activations, matching peepholes and compute dtype, ``n_out == n_in
        == n_out`` through the pair, and, in training, no weight noise on
        either layer and no dropout on the second. The kernels must take
        the shape too (the role of the JAX package's ``supported2``): H %
        8 == 0, and a grid for K3 (with the reserve in training) and, in
        training, for K4 on x's device (``fwd_route``/``bwd_route``; the
        CPU's plain loops take every shape). A pair they cannot take runs
        as two per-layer calls, decided before any launch."""
        if fmask is not None or x.dim() != 3:
            return False
        a, b = self.impls[i], self.impls[i + 1]
        if not (isinstance(a, _BaseLSTMImpl) and isinstance(b, _BaseLSTMImpl)):
            return False
        if train and (a.weight_noise is not None or b.weight_noise is not None):
            return False
        if a.peepholes != b.peepholes or not (a.kernel_ok() and b.kernel_ok()):
            return False
        if train and b.dropout_active():
            return False
        if a.compute_dtype != b.compute_dtype:
            return False
        H = a.conf.n_out
        if not (H == b.conf.n_in == b.conf.n_out) or H % 8:
            return False
        bsz, wd = int(x.shape[0]), a.compute_dtype
        if lstm_fused.fwd_route(wd, bsz, H, reserve=train, device=x.device)[1] == 0:
            return False
        return not train or lstm_fused.bwd_route(wd, bsz, H, device=x.device)[1] > 0

    def _fused_lstm_forward(self, x, ctx, i):
        """Layers (i, i+1) through the fused kernel, with the hoisted
        layer-1 projection and the ctx-carried (h, c) state of both layer
        indices."""
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

    # -------------------------------------------------------------- training
    def _loss_fn(self, f, l, fm, lm, train, rnn_state_in=None):
        """Loss + L1/L2 penalty (``_loss_fn`` of the JAX package). Returns
        (loss, rnn_state_out)."""
        if train:
            for impl in self.impls:
                impl.check_trainable()
        n = len(self.impls)
        x, ctx = self._apply_layers(f, fm, rnn_state_in, train, upto=n - 1)
        out = self.impls[-1]
        if not hasattr(out, "loss_on"):
            raise ValueError(f"Last layer {type(out).__name__} is not an output layer")
        mask = lm if lm is not None else (fm if x.dim() == 3 else None)
        loss = out.loss_on(x, l, mask=mask)
        reg = 0.0
        for impl in self.impls:
            reg = reg + impl.regularization()
        return loss + reg, ctx.get("rnn_state_out")

    def _grads(self, loss) -> Dict[str, Dict[str, torch.Tensor]]:
        params = self._trainable()
        flat = [(i, k, p) for i, ps in params.items() for k, p in ps.items()]
        gs = torch.autograd.grad(loss, [p for _, _, p in flat], allow_unused=True)
        grads = {i: {} for i in params}
        for (i, k, p), g in zip(flat, gs):
            grads[i][k] = torch.zeros_like(p) if g is None else g
        return grads

    def _update(self, loss, iteration) -> None:
        """Gradients of ``loss`` -> minimize flip -> normalization -> the
        layers' updaters -> ``p - u`` in place."""
        grads = self._grads(loss)
        if not self.gc.minimize:
            grads = {i: {k: -g for k, g in gs.items()} for i, gs in grads.items()}
        grads = normalize_gradients(grads, self.gc.gradient_normalization,
                                    self.gc.gradient_normalization_threshold)
        updates, self.updater_state = self.updater.apply(self.updater_state, grads, iteration)
        with torch.no_grad():
            for i, ps in self._trainable().items():
                for k, p in ps.items():
                    p.sub_(updates[i][k].to(p.dtype))

    def _step(self, f, l, fm, lm, iteration, rnn_state_in=None):
        """One update. Returns (detached loss, detached rnn state out)."""
        loss, rnn_out = self._loss_fn(f, l, fm, lm, True, rnn_state_in)
        self._update(loss, iteration)
        return loss.detach(), _detached(rnn_out)

    def _steps(self, f, l, fm, lm, rnn_state_in=None):
        """``iterations(n)`` updates on one minibatch or segment, each from
        the same carried-in state; the last loss and state are kept."""
        for k in range(_n_iterations(self.gc)):
            loss, rnn_out = self._step(f, l, fm, lm, self.iteration_count + k, rnn_state_in)
        self.iteration_count += _n_iterations(self.gc)
        return loss, rnn_out

    def _tensors(self, ds: DataSet):
        return tuple(self._to_device(a) for a in
                     (ds.features, ds.labels, ds.features_mask, ds.labels_mask))

    def fit(self, data, labels=None, epochs=1):
        """Train (reference ``fit(DataSetIterator)``). Accepts a DataSet, a
        DataSetIterator (or any iterable of DataSets), or (features, labels)
        arrays. A DataSetIterator goes through the prefetch pipeline
        (``datasets/prefetch.py::wrap_for_training``: workers, put-ahead to
        the device, ``CacheMode.DEVICE``), shut down when fit ends."""
        return _fit_epochs(self, data, labels, epochs)

    def _batch_tensors(self, ds: DataSet):
        """A minibatch's (f, l, fm, lm) on the device: the DataSet's cached
        copies under ``CacheMode.DEVICE``, else the put-ahead view's
        tensors (or a synchronous copy)."""
        if self.gc.cache_mode == CacheMode.DEVICE and isinstance(ds, DataSet):
            return ds.device_arrays(self.device)
        return self._tensors(ds)

    def _fit_batch(self, ds: DataSet):
        f, l, fm, lm = self._batch_tensors(ds)
        if (self.conf.backprop_type == BackpropType.TruncatedBPTT and f.dim() == 3
                and f.shape[1] > self.conf.tbptt_fwd_length):
            self._fit_tbptt(f, l, fm, lm)
            return
        self.score_, _ = self._steps(f, l, fm, lm)

    def _fit_tbptt(self, f, l, fm, lm):
        """Truncated BPTT (reference ``doTruncatedBPTT``): segments of
        ``tbptt_fwd_length`` steps (the last one ragged), one update per
        segment, (h, c) carried detached from segment to segment; labels
        and masks are sliced per segment, ``score_`` is the last segment's
        loss. A differing ``tbptt_back_length`` is treated as the forward
        length (warned once), as in the JAX package."""
        L = self.conf.tbptt_fwd_length
        if self.conf.tbptt_back_length != L and not self._warned_tbptt:
            log.warning("tbptt_back_length=%d differs from tbptt_fwd_length=%d; "
                        "backprop truncation uses the forward chunk length",
                        self.conf.tbptt_back_length, L)
            self._warned_tbptt = True
        T = int(f.shape[1])
        state = self._init_rnn_state(int(f.shape[0]))
        for start in range(0, T, L):
            sl = slice(start, min(start + L, T))

            def seg(a):
                return None if a is None else a[:, sl]

            loss, state = self._steps(seg(f), seg(l) if l.dim() == 3 else l, seg(fm), seg(lm),
                                      state)
        self.score_ = loss

    def score(self, ds: Optional[DataSet] = None, training=False) -> float:
        """Loss (+ penalty) on a dataset (reference ``score(DataSet)``), or the
        last training score when called without arguments."""
        if ds is None:
            return float(self.score_)
        with torch.no_grad():
            loss, _ = self._loss_fn(*self._tensors(ds), training)
        return float(loss)

    def compute_gradient_and_score(self, ds: DataSet):
        """Reference ``computeGradientAndScore``: ({layer: {param: grad}},
        score) without updating the parameters."""
        loss, _ = self._loss_fn(*self._tensors(ds), True)
        grads = self._grads(loss)
        self.score_ = loss.detach()
        return grads, float(self.score_)


def _fit_epochs(net, data, labels, epochs):
    """The fit loop both containers share (``fit`` of the JAX package's
    ``MultiLayerNetwork`` and ``ComputationGraph``): wrap the iterator for
    training, time each wait for a minibatch (``last_etl_ms``), run
    ``net._fit_batch`` on each, and shut an owned pipeline down however
    the loop ends."""
    if labels is not None:
        data = DataSet(np.asarray(data), np.asarray(labels))
    if isinstance(data, (DataSet, MultiDataSet)):
        data = ListDataSetIterator([data])
    it, own_pipeline = wrap_for_training(
        data, net.device, cache_device=net.gc.cache_mode == CacheMode.DEVICE)
    try:
        for _ in range(epochs):
            t_etl = time.perf_counter()
            for ds in it:
                net.last_etl_ms = (time.perf_counter() - t_etl) * 1e3
                net._fit_batch(ds)
                t_etl = time.perf_counter()
            net.epoch_count += 1
    finally:
        if own_pipeline:
            it.shutdown()   # no prefetch worker outlives its fit
    return net
