"""MultiLayerNetwork: sequential network container.

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py``. Inference:
``init``, ``output``, ``rnn_time_step``, ``rnn_clear_previous_state``,
``feed_forward``/``feed_forward_to_layer`` (layer by layer, no fusion).
Evaluation: ``evaluate`` (the output ranked on the device,
``eval/evaluation.py``) and ``evaluate_regression``. Parameters:
``param_table``, ``get_param``, ``params_flat``/``set_params_flat``
(layer-major, a layer's parameters in init order), ``clone``,
``summary``. A wrapper layer's parameters nest (Bidirectional's ``{"fwd":
{...}, "bwd": {...}}``): every walk over them goes through
``utils/trees.py``, and a nested name joins its keys with "/"
(``param_table``'s ``"0_fwd/W"``).
Training: ``fit`` (a DataSet, an iterator, or arrays), one update per
minibatch or, with truncated BPTT, per segment (``_fit_batch``;
``_run_tbptt``, the loop both containers share), ``score`` and
``compute_gradient_and_score``. The loss adds the auxiliary losses layers
leave in ``ctx["aux_loss"]`` (MoE load balancing). The update
is the JAX step core (``_raw_update_core``/``_raw_step``): loss ->
autograd gradients -> minimize flip -> ``normalize_gradients`` -> the
layer's updater -> ``p - u``, applied in place -> the layers' constraints;
then the layers' new state (BatchNormalization's running statistics) is
committed. The parallel steps (``parallel/``) run its halves apart:
``_train_loss`` and ``_grads`` on each slot, then ``_apply_update`` once
on the slots' reduced gradients.

Frozen layers (``FrozenLayer``, ``nn/layers/wrapper.py``) hold parameters
with ``requires_grad`` off: autograd records nothing of them, and their
gradient is 0, as ``stop_gradient``'s in the JAX package, whose step then
runs each frozen layer's updater on that zero gradient. The step here skips
a frozen layer whose updater state is all zero (``_idle_frozen``): every
updater of ``nn/updaters.py`` leaves such state at zero and updates by
exactly 0, so skipping gives the same bits; a frozen layer with moments
(from a JAX zip) runs its updater on the zero gradient, as in JAX.

Pretraining (``pretrain``, ``pretrain_layer``, and ``fit``'s one-time
hook when the configuration says ``pretrain``): each pretrain layer
(AutoEncoder, RBM, VariationalAutoencoder) fits its own ``pretrain_loss``
on the activations of the layer before it, with its updater from a fresh
state and no gradient normalization or penalty, as in the JAX package;
the draws come from the network's generator.

Regularisation in training (``nn/conf/dropout.py``): the network's own
``torch.Generator`` (``_gen``) is the step's stream; each training forward
splits it per layer (``layers.base.StepGenerators``, the JAX package's
``jax.random.split``), and a layer draws its weight noise, then its input
dropout, from its own. Layers [0, n-1) run on noised parameters; the
output layer's parameters are not noised in the loss, and its input
dropout draws from the step's stream itself (JAX ``multilayer.py:399``).
``score``, ``compute_gradient_and_score`` and the gradient check pass no
generator, so nothing is dropped or noised there.

Listeners (``optimize/listeners.py``) hear ``on_epoch_start``/
``on_epoch_end`` around each epoch and ``iteration_done`` once a
minibatch (under TBPTT once a batch, with its last segment's loss). The
fit loop observes each minibatch as the JAX package's does, when a
listener is set or the monitor is on (``monitor.enabled()``, the
default): the loss's value, a device-to-host sync, is fetched inside the
``step`` span (``monitor.step_span``), then
``monitor.record_training_iteration`` writes the registry and the health
state (with the step's and the wait's ms), then the listeners run; an
``epoch`` span goes around each epoch. With the monitor off and no
listener, nothing is fetched.
``halt_requested`` (``monitor/health.py``'s halt) is cleared when ``fit``
starts and checked between minibatches; an exception out of ``fit`` goes
to every listener's ``on_training_error`` first.

Remat (``GlobalConfig.remat`` "on", or "auto" on a convolutional net
without a recurrent layer: ``layers.base.remat_enabled``) changes what a
fit step keeps: ``_remat_loss`` runs the forward in checkpointed regions
that end at each layer with ``save_output`` (the fused LSTM pair ends at
its second layer), the output layer's loss in the last one, so the
backward keeps those outputs and recomputes the rest (K1/K3 run again to
rebuild their reserve). Each region's draws replay from the generators'
states taken before its first run, and new layer state, carries and the
auxiliary loss come from the first run only, so the step's bits are those
of the step without remat.

Each layer's input preprocessor (``conf.input_preprocessors``) runs just
before it, and convolutional inputs arrive NCHW at the user boundary and
flow NHWC inside (``nchw_to_nhwc``).

Two consecutive plain LSTM layers run as one fused kernel
(``ops/lstm_fused.py``: K3, and K4 backward in training) when
:meth:`MultiLayerNetwork._lstm_pair_fusable` admits them
(``multilayer.py:299-334``); every other LSTM runs the per-layer kernel
(``ops/lstm_cell.py``: K1, and K2 backward) or, where
``lstm_cell.supported`` declines it, the layer's step loop. Eager
PyTorch takes the place of the JAX package's jitted step and its
``lax.scan`` over TBPTT segments.
"""
from __future__ import annotations

import copy
import logging
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from .conf import BackpropType, CacheMode, MultiLayerConfiguration
from .conf.dropout import apply_constraints
from .conf.inputs import InputTypeConvolutional
from .conf.layers import DropoutLayer, FeedForwardLayer, LossLayer
from .layers import impl_for
from .layers.base import (StepGenerators, checkpointed, generator_state, remat_enabled,
                          replay_generator)
from .layers.recurrent import GravesBidirectionalLSTMImpl, _BaseLSTMImpl
from .layers.wrapper import FrozenImpl
from .updaters import Sgd
from ..datasets.dataset import DataSet, ListDataSetIterator, MultiDataSet, to_tensor
from ..datasets.prefetch import wrap_for_training
from .. import monitor as _mon
from ..monitor.health import get_health
from ..monitor.jitwatch import monitored_jit
from ..ops import lstm_cell, lstm_fused
from ..optimize.listeners import dispatch_training_error
from ..optimize.updater import NetworkUpdater, normalize_gradients
from ..utils.trees import leaves, nest, tree_map

__all__ = ["MultiLayerNetwork"]

log = logging.getLogger(__name__)


def _n_iterations(gc) -> int:
    """Optimizer iterations per minibatch or TBPTT segment (0.9.x
    ``iterations``)."""
    return int(getattr(gc, "iterations", 1) or 1)


def nchw_to_nhwc(x, input_type):
    """Convolutional input arrives NCHW (the reference's convention) and
    flows NHWC: a permuted view at the boundary (the JAX package's
    ``_adapt_input``/``_adapt_inputs``). Other input, and input already
    NHWC, passes unchanged."""
    if (isinstance(input_type, InputTypeConvolutional) and x.dim() == 4
            and x.shape[1] == input_type.channels and x.shape[2] == input_type.height):
        return x.permute(0, 2, 3, 1)
    return x


def _detached(state):
    """A carry cut from the graph: tensors detached, other members (the KV
    cache's Python token counter) kept as they are. A carry is a tuple
    ((h, c) of an LSTM, a KV cache) or one tensor (SimpleRnn's h)."""
    def cut(t):
        return t.detach() if isinstance(t, torch.Tensor) else t
    return None if state is None else {
        i: cut(hc) if isinstance(hc, torch.Tensor) else tuple(cut(t) for t in hc)
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
        self.last_batch_size = 0
        self.listeners = []
        self.halt_requested = False  # TrainingHealthListener's "halt"
        self._gen = None            # the training step's stream (dropout, noise)
        self._rnn_state = None      # streaming state for rnn_time_step
        self._warned_tbptt = False
        self._idle_seen = {}        # frozen layer -> (updater state, all zero?)
        self._pretrained = False    # fit's one-time pretrain hook
        self._jit_output = {}       # (train, masked) -> "mln/output" watch
        self._jit_score = {}        # training -> "mln/score" watch

    # ------------------------------------------------------------------ init
    def init(self, params: Optional[Dict[str, Dict]] = None, device="cuda",
             states: Optional[Dict[str, Dict]] = None):
        """Build the layer implementations on ``device`` (the card unless
        ``device="cpu"``). ``params`` ({"0": {"W": ...}, ...}, tensors or
        arrays) installs copies of given weights, shape-checked against the
        config; without it, weights are drawn from a ``torch.Generator``
        seeded with the config's seed. ``states`` (same keys) installs the
        layers' state, else each layer starts from its initial state.
        Updater state starts at zero; the training draws start from a
        generator seeded with the config's seed + 1."""
        dev = resolve_device(device)
        layers = self.conf.layers
        it = self.conf.input_type
        if it is not None:
            for i, lc in enumerate(layers):
                pre = self.conf.preprocessor(i)
                if pre is not None:
                    it = pre.get_output_type(it)
                lc.set_n_in(it, override=False)
                it = lc.get_output_type(i, it)
        for i, lc in enumerate(layers):
            inner = getattr(lc, "inner", None) or lc
            if (isinstance(inner, FeedForwardLayer)
                    and not isinstance(inner, (DropoutLayer, LossLayer))):
                if inner.n_out is None or inner.n_in is None:
                    raise ValueError(f"Layer {i} ({type(inner).__name__}): n_in and "
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
            impl.set_state(states.get(str(i), {}) if states is not None
                           else impl.init_state(), dev)
            impls.append(impl)
        self.impls = nn.ModuleList(impls)
        self.device = dev
        self._rnn_state = None
        self._gen = torch.Generator().manual_seed(int(self.gc.seed) + 1)
        # one updater per layer: its own override or the global default
        self.updater = NetworkUpdater({
            str(i): getattr(lc, "updater", None) or self.gc.updater or Sgd(learning_rate=1e-1)
            for i, lc in enumerate(layers)})
        self.updater_state = self.updater.init_state(self.params)
        return self

    @property
    def params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{"0": {"W": tensor, ...}, ...}: detached views of the parameters
        (they share storage, so they follow training); a wrapper layer's
        nest."""
        return {i: tree_map(torch.Tensor.detach, ps) for i, ps in self._trainable().items()}

    def _layers(self) -> Dict[str, nn.Module]:
        """Each layer's implementation by its parameter key."""
        return {str(i): impl for i, impl in enumerate(self.impls)}

    def _trainable(self) -> Dict[str, Dict[str, nn.Parameter]]:
        return {k: impl.param_dict() for k, impl in self._layers().items()}

    @property
    def states(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{"0": {}, "1": {"mean": tensor, "var": tensor}, ...}: each layer's
        state (the JAX package's ``states``), live buffers that fit steps
        update in place."""
        return {str(i): impl.layer_state() for i, impl in enumerate(self.impls)}

    def num_params(self) -> int:
        return sum(p.numel() for _, p in leaves(self._trainable()))

    numParams = num_params

    def _commit_states(self, new_states) -> None:
        """Install the new layer state a training forward left in
        ``new_states`` (keyed by layer index or vertex name)."""
        for key, state in new_states.items():
            self.impls[key].commit_state(state)

    # -------------------------------------------------------------- forward
    def _to_device(self, a):
        """An input array as a tensor on the network's device (floating
        data as float32); an identity on a tensor the prefetch pipeline
        already put there."""
        return to_tensor(a, self.device)

    def _apply_layers(self, x, fmask, rnn_state_in=None, train=False, upto=None,
                      new_states=None, rng=None):
        """Run layers [0, upto), each after its input preprocessor. Returns
        (x, ctx); ``ctx["rnn_state_out"]`` holds each recurrent layer's
        final (h, c). In training, layers with state leave their new state
        in ``new_states`` when it is given, and ``rng`` (the step's
        generator) is split per layer for its weight noise and input
        dropout (``ctx["rng"]`` while the layer runs)."""
        ctx = {"train": train}
        gens = StepGenerators(rng if train else None)
        if rnn_state_in is not None:
            ctx["rnn_state_in"] = rnn_state_in
        if new_states is not None:
            ctx["new_states"] = new_states
        x = nchw_to_nhwc(x, self.conf.input_type)
        n = len(self.impls) if upto is None else upto
        i = 0
        while i < n:
            ctx["rng"] = gens.next(self.impls[i])
            x, j = self._layer_unit(x, i, n, fmask, ctx, train)
            if j == i + 2:
                gens.next(self.impls[i + 1])
            i = j
        ctx.pop("rng", None)
        return x, ctx

    def _layer_unit(self, x, i, n, fmask, ctx, train):
        """Layer i after its input preprocessor, or layers (i, i+1) as one
        fused LSTM launch when the pair is fusable and i + 1 < n; ``ctx["rng"]``
        is layer i's generator. Returns (x, the next layer's index)."""
        pre = self.conf.preprocessor(i)
        if pre is not None:
            x = pre(x, ctx)
        if (i + 1 < n and self.conf.preprocessor(i + 1) is None
                and self._lstm_pair_fusable(i, x, fmask, train)):
            return self._fused_lstm_forward(x, ctx, i, ctx["rng"]), i + 2
        return self.impls[i].noised_forward(x, fmask, ctx), i + 1

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
        as two per-layer calls, decided before any launch. Each layer must
        be one the per-layer kernels take (``lstm_cell.supported``), and
        neither may be a GravesBidirectionalLSTM, as in the JAX package."""
        if fmask is not None or x.dim() != 3:
            return False
        a, b = self.impls[i], self.impls[i + 1]
        for im in (a, b):
            if not isinstance(im, _BaseLSTMImpl) or isinstance(im, GravesBidirectionalLSTMImpl):
                return False
        if train and (a.weight_noise is not None or b.weight_noise is not None):
            return False
        bsz, T = int(x.shape[0]), int(x.shape[1])
        if a.peepholes != b.peepholes or not all(
                lstm_cell.supported(bsz, T, im.conf.n_out, im.activation_name, im.gate_name,
                                    x.device) for im in (a, b)):
            return False
        if train and b.dropout_obj is not None:
            return False
        if a.compute_dtype != b.compute_dtype:
            return False
        H = a.conf.n_out
        if not (H == b.conf.n_in == b.conf.n_out) or H % 8:
            return False
        wd = a.compute_dtype
        if lstm_fused.fwd_route(wd, bsz, H, reserve=train, device=x.device)[1] == 0:
            return False
        return not train or lstm_fused.bwd_route(wd, bsz, H, device=x.device)[1] > 0

    def _fused_lstm_forward(self, x, ctx, i, gen=None):
        """Layers (i, i+1) through the fused kernel, with layer i's input
        dropout (drawn from ``gen`` in training) before the hoisted layer-1
        projection and the ctx-carried (h, c) state of both layer
        indices."""
        a, b = self.impls[i], self.impls[i + 1]
        x = a.maybe_dropout(x, ctx.get("train", False), gen)
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
        key = (False, mask is not None)
        fn = self._jit_output.get(key)
        if fn is None:
            fn = self._jit_output[key] = monitored_jit(self._output_fwd, name="mln/output")
        with torch.inference_mode():
            return fn(as_tensor(x), as_tensor(mask))

    def _output_fwd(self, x, mask):
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
            y, self._rnn_state = watched(self, "_jit_rnn_step", "mln/rnn_step",
                                         self._rnn_step_fwd)(x, self._rnn_state)
        return y[:, -1, :] if single_step else y

    def _rnn_step_fwd(self, x, state):
        y, ctx = self._apply_layers(x, None, state)
        return y, ctx.get("rnn_state_out")

    rnnTimeStep = rnn_time_step

    def rnn_clear_previous_state(self):
        self._rnn_state = None

    rnnClearPreviousState = rnn_clear_previous_state

    # -------------------------------------------------------------- training
    def _loss_fn(self, f, l, fm, lm, train, rnn_state_in=None, new_states=None, rng=None,
                 remat=False):
        """Loss + L1/L2 penalty + the auxiliary losses the forward left in
        ``ctx["aux_loss"]`` (MoE load balancing), as ``_loss_fn`` of the
        JAX package. Returns (loss, rnn_state_out); a training forward's
        new layer state goes into ``new_states`` when it is given, the
        output layer's too where it has an ``update_state`` (the centres
        of a CenterLossOutputLayer, from its detached input). ``rng``
        (training only) draws dropout and weight noise. ``remat`` (a
        training step's) runs the forward in checkpointed regions."""
        rng = rng if train else None
        n = len(self.impls)
        if remat and train:
            loss, ctx = self._remat_loss(f, l, fm, lm, rnn_state_in, new_states, rng)
        else:
            x, ctx = self._apply_layers(f, fm, rnn_state_in, train, upto=n - 1,
                                        new_states=new_states, rng=rng)
            loss = self._output_loss(x, l, fm, lm, ctx, train, rng, new_states)
        reg = 0.0
        for impl in self.impls:
            reg = reg + impl.regularization()
        return loss + reg + ctx.get("aux_loss", 0.0), ctx.get("rnn_state_out")

    def _output_loss(self, x, l, fm, lm, ctx, train, gen, new_states):
        """The output layer's loss on the last hidden activations ``x``,
        after its preprocessor; its input dropout draws from ``gen``."""
        n = len(self.impls)
        pre = self.conf.preprocessor(n - 1)
        if pre is not None:
            x = pre(x, ctx)
        out = self.impls[-1]
        if not hasattr(out, "loss_on"):
            raise ValueError(f"Last layer {type(out).__name__} is not an output layer")
        mask = lm if lm is not None else (fm if x.dim() == 3 else None)
        loss = out.loss_on(x, l, mask=mask, train=train, gen=gen)
        if new_states is not None and hasattr(out, "update_state"):
            new_states[n - 1] = out.update_state(x, l)    # CenterLoss's centres
        return loss

    def _remat_loss(self, f, l, fm, lm, rnn_state_in, new_states, rng):
        """The training loss under remat: the forward of ``_apply_layers``
        in checkpointed regions (``layers.base.checkpointed``), each ending
        at a layer with ``save_output`` (a fused pair at its second), the
        output layer's loss in the last. Each layer's generator is drawn
        first, as ``_apply_layers`` draws them, and replayed from its state
        in every run of its region; the output layer's draws replay from
        the step stream's state, which the first run then advances as the
        step without remat does. Returns (loss, ctx)."""
        n = len(self.impls)
        ctx = {"train": True}
        if rnn_state_in is not None:
            ctx["rnn_state_in"] = rnn_state_in
        if new_states is not None:
            ctx["new_states"] = new_states
        gens = StepGenerators(rng)
        states = [generator_state(gens.next(impl)) for impl in self.impls[:n - 1]]
        out_state = generator_state(rng)

        def region(c, first, x, i):
            while i < n - 1:
                c["rng"] = replay_generator(states[i])
                x, i = self._layer_unit(x, i, n - 1, fm, c, True)
                if self.impls[i - 1].save_output:
                    return x, i
            gen = replay_generator(out_state)
            loss = self._output_loss(x, l, fm, lm, c, True, gen, c.get("new_states"))
            if first and rng is not None:
                rng.set_state(gen.get_state())
            return loss, n

        x, i = nchw_to_nhwc(f, self.conf.input_type), 0
        while i < n:
            x, i = checkpointed(region, ctx, x, i)
        return x, ctx

    def _grads(self, outputs, grad_outputs=None, skip=()) -> Dict[str, Dict[str, torch.Tensor]]:
        """{layer: {param: gradient}} of ``outputs`` (a loss, or tensors
        weighted by ``grad_outputs``: a vector-Jacobian product); zeros for
        a parameter that does not reach them or that is frozen
        (``requires_grad`` off). The layers in ``skip`` get {}: no tensor
        at all. Only a net frozen whole, with no parameter to differentiate,
        takes no autograd call; otherwise outputs that autograd did not
        record raise as autograd does."""
        params = self._trainable()
        flat = list(leaves({k: v for k, v in params.items() if k not in skip}))
        want = [p for _, p in flat if p.requires_grad]
        gs = (torch.autograd.grad(outputs, want, grad_outputs=grad_outputs, allow_unused=True)
              if want else [])
        got = {id(p): g for p, g in zip(want, gs)}
        grads = nest({path: torch.zeros_like(p) if got.get(id(p)) is None else got[id(p)]
                      for path, p in flat})
        return {i: grads.get(i, {}) for i in params}

    def _idle_frozen(self):
        """The keys of the frozen layers whose updater state is all zero,
        which a step skips (the module docstring). The verdict is kept
        beside the state object it was read from: a step passes a skipped
        layer's state on as it is, and records an updated frozen layer's as
        not zero, so only a state put in place from outside (init, a
        restore) is read, once (a device sync)."""
        idle = set()
        for k, impl in self._layers().items():
            if not isinstance(impl, FrozenImpl):
                continue
            st = self.updater_state.get(k)
            seen = self._idle_seen.get(k)
            if seen is None or seen[0] is not st:
                seen = (st, not any(bool(t.any()) for _, t in leaves(st or {})))
                self._idle_seen[k] = seen
            if seen[1]:
                idle.add(k)
        return idle

    def _update(self, loss, iteration) -> None:
        """Gradients of ``loss`` -> :meth:`_apply_update`."""
        self._apply_update(self._grads(loss, skip=self._idle_frozen()), iteration)

    def _apply_update(self, grads, iteration) -> None:
        """One update from gradients: minimize flip ->
        :meth:`_apply_gradients` -> :meth:`_apply_constraints`. The seam of
        the parallel steps (``parallel/``): each slot's gradients of
        :meth:`_train_loss`, reduced across the slots, are applied here
        once."""
        if not self.gc.minimize:
            grads = {i: tree_map(torch.neg, gs) for i, gs in grads.items()}
        self._apply_gradients(grads, iteration)
        self._apply_constraints()

    def _updates(self, grads, iteration):
        """Normalization -> the layers' updaters: the updates ``u`` of
        ``p - u`` (the updater state advances), nothing applied."""
        grads = normalize_gradients(grads, self.gc.gradient_normalization,
                                    self.gc.gradient_normalization_threshold)
        updates, self.updater_state = self.updater.apply(self.updater_state, grads, iteration)
        return grads, updates

    def _apply_gradients(self, grads, iteration) -> None:
        """Normalization -> the layers' updaters -> ``p - u`` in place; a
        layer whose gradient dict is empty (no parameters, or skipped)
        keeps its parameters and updater state."""
        grads, updates = self._updates(grads, iteration)
        with torch.no_grad():
            for i, ps in self._trainable().items():
                if updates[i]:
                    tree_map(lambda p, u: p.sub_(u.to(p.dtype)), ps, updates[i])
        for k, impl in self._layers().items():
            if isinstance(impl, FrozenImpl) and grads[k]:
                self._idle_seen[k] = (self.updater_state[k], False)

    def _apply_constraints(self) -> None:
        """Each layer's constraints projected onto its parameters in place,
        after an update (reference ``BaseConstraint.applyConstraint``); a
        wrapper's inner layers' constraints on their own parameters."""
        with torch.no_grad():
            for impl in self._layers().values():
                for cons, ps in impl.constraint_sets():
                    for k, t in apply_constraints(cons, ps).items():
                        if t is not ps[k]:
                            ps[k].copy_(t)

    def _train_loss(self, f, l, fm, lm, rnn_state_in=None, rng=None):
        """The training loss of one step, nothing updated: (loss, rnn state
        out, the layers' new state). ``rng`` defaults to the network's own
        step stream."""
        new_states = {}
        loss, rnn_out = self._loss_fn(f, l, fm, lm, True, rnn_state_in, new_states,
                                      rng=self._gen if rng is None else rng,
                                      remat=remat_enabled(self.gc, self.impls))
        return loss, rnn_out, new_states

    def _step(self, f, l, fm, lm, iteration, rnn_state_in=None, watch=True):
        """One update, then the layers' new state. Returns (detached loss,
        detached rnn state out). Watched as ``mln/step`` (a minibatch's
        step, and apart from it a TBPTT segment's, as the JAX package's two
        step functions) unless ``watch`` is False (inside ``nn/tbptt_scan``)."""
        if not watch:
            return self._step_body(f, l, fm, lm, iteration, rnn_state_in)
        slot = "_jit_step" if rnn_state_in is None else "_jit_tbptt_step"
        return watched(self, slot, "mln/step", self._step_body)(f, l, fm, lm, iteration,
                                                                rnn_state_in)

    def _step_body(self, f, l, fm, lm, iteration, rnn_state_in=None):
        loss, rnn_out, new_states = self._train_loss(f, l, fm, lm, rnn_state_in)
        self._update(loss, iteration)
        self._commit_states(new_states)
        return loss.detach(), _detached(rnn_out)

    def _steps(self, f, l, fm, lm, rnn_state_in=None, watch=True):
        """``iterations(n)`` updates on one minibatch or segment, each from
        the same carried-in state; the last loss and state are kept."""
        for k in range(_n_iterations(self.gc)):
            loss, rnn_out = self._step(f, l, fm, lm, self.iteration_count + k, rnn_state_in,
                                       watch=watch)
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
        the device, ``CacheMode.DEVICE``), shut down when fit ends. When the
        configuration says ``pretrain``, the first fit pretrains on the
        same data first (the JAX package's ``fit``)."""
        if self.conf.pretrain and not self._pretrained:
            if labels is not None:
                data, labels = DataSet(np.asarray(data), np.asarray(labels)), None
            if isinstance(data, DataSet):
                data = ListDataSetIterator([data])
            self.pretrain(data)
            self._pretrained = True
        return _fit_epochs(self, data, labels, epochs)

    # ------------------------------------------------------------- pretrain
    def pretrain(self, iterator, epochs=1):
        """Layerwise unsupervised pretraining (reference ``pretrain(iter)``):
        :meth:`pretrain_layer` on each layer whose config
        ``is_pretrain_layer``, in order."""
        for i, lc in enumerate(self.conf.layers):
            if lc.is_pretrain_layer():
                self.pretrain_layer(i, iterator, epochs=epochs)
        return self

    def pretrain_layer(self, layer_idx, iterator, epochs=1):
        """Reference ``pretrainLayer(int, DataSetIterator)``: ``epochs``
        passes over ``iterator``, one update a minibatch of the layer's
        ``pretrain_loss`` on ``feed_forward_to_layer(layer_idx - 1)`` of
        the features (the adapted features for layer 0), by the layer's
        updater from a fresh state at iterations 0, 1, ...; ``score_`` is
        the last loss."""
        impl = self.impls[layer_idx]
        if not hasattr(impl, "pretrain_loss"):
            raise ValueError(f"Layer {layer_idx} ({type(impl).__name__}) is not a "
                             f"pretrainable layer")
        updater = self.updater.layer_updaters[str(layer_idx)]
        params = impl.param_dict()
        state = updater.init_state(params)
        it = 0

        def step(x, it, state):
            loss = impl.pretrain_loss(x, self._gen)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            updates, state = updater.apply(state, grads, it)
            with torch.no_grad():
                for k, p in params.items():
                    p.sub_(updates[k].to(p.dtype))
            return loss, state

        jstep = monitored_jit(step, name="mln/pretrain_step")
        for _ in range(epochs):
            for ds in iterator:
                f = self._to_device(ds.features)
                x = (self.feed_forward_to_layer(layer_idx - 1, f) if layer_idx > 0
                     else nchw_to_nhwc(f, self.conf.input_type))
                loss, state = jstep(x, it, state)
                it += 1
        self.score_ = loss.detach()
        return self

    def set_listeners(self, *listeners):
        """Replace the listeners (``optimize/listeners.py``)."""
        self.listeners = list(listeners)
        return self

    setListeners = set_listeners

    def add_listeners(self, *listeners):
        self.listeners.extend(listeners)
        return self

    addListeners = add_listeners

    def _batch_tensors(self, ds: DataSet):
        """A minibatch's (f, l, fm, lm) on the device: the DataSet's cached
        copies under ``CacheMode.DEVICE``, else the put-ahead view's
        tensors (or a synchronous copy)."""
        if self.gc.cache_mode == CacheMode.DEVICE and isinstance(ds, DataSet):
            return ds.device_arrays(self.device)
        return self._tensors(ds)

    def _fit_batch(self, ds: DataSet):
        f, l, fm, lm = self._batch_tensors(ds)
        self.last_batch_size = int(f.shape[0])
        if (self.conf.backprop_type == BackpropType.TruncatedBPTT and f.dim() == 3
                and f.shape[1] > self.conf.tbptt_fwd_length):
            _run_tbptt(self, f, l, fm, lm)
            return
        _observed_steps(self, lambda: self._steps(f, l, fm, lm)[0])

    def score(self, ds: Optional[DataSet] = None, training=False) -> float:
        """Loss (+ penalty) on a dataset (reference ``score(DataSet)``), or the
        last training score when called without arguments."""
        if ds is None:
            return float(self.score_)
        fn = self._jit_score.get(bool(training))
        if fn is None:
            fn = self._jit_score[bool(training)] = monitored_jit(
                lambda f, l, fm, lm: self._loss_fn(f, l, fm, lm, training)[0],
                name="mln/score")
        with torch.no_grad():
            loss = fn(*self._tensors(ds))
        return float(loss)

    def compute_gradient_and_score(self, ds: DataSet):
        """Reference ``computeGradientAndScore``: ({layer: {param: grad}},
        score) without updating the parameters."""
        loss, _ = self._loss_fn(*self._tensors(ds), True)
        grads = self._grads(loss)
        self.score_ = loss.detach()
        return grads, float(self.score_)

    def feed_forward(self, x, train=False):
        """Every layer's activation, the (adapted) input first (reference
        ``feedForward``): each layer on its own, as in the JAX package (no
        pair fusion, no mask, nothing drawn); ``train`` runs the training
        forward (batch statistics) without changing any state."""
        return self._layer_walk(x, train, len(self.impls) - 1, keep_all=True)

    feedForward = feed_forward

    def feed_forward_to_layer(self, layer_idx, x, train=False):
        """The activation of layer ``layer_idx`` (reference
        ``feedForwardToLayer``), layer by layer as :meth:`feed_forward`."""
        return self._layer_walk(x, train, layer_idx, keep_all=False)

    feedForwardToLayer = feed_forward_to_layer

    def _layer_walk(self, x, train, last, keep_all):
        with torch.no_grad():
            x = nchw_to_nhwc(self._to_device(x), self.conf.input_type)
            acts = [x]
            ctx = {"train": train, "rng": None}
            for i in range(last + 1):
                pre = self.conf.preprocessor(i)
                if pre is not None:
                    x = pre(x, ctx)
                x = self.impls[i](x, mask=None, ctx=ctx)
                acts.append(x)
        return acts if keep_all else x

    # ------------------------------------------------------------ evaluation
    def evaluate(self, iterator):
        """Classification evaluation over ``iterator`` (reference
        ``evaluate``): each minibatch's ``output`` (with its features mask)
        stays on the device and goes to :class:`eval.Evaluation`, which
        copies only class indices to the host; the labels mask, else the
        features mask, picks the steps that count."""
        from ..eval.evaluation import Evaluation
        ev = Evaluation()
        for ds in iterator:
            out = self.output(ds.features, mask=ds.features_mask)
            ev.eval(ds.labels, out, mask=ds.labels_mask if ds.labels_mask is not None
                    else ds.features_mask)
        return ev

    def evaluate_regression(self, iterator):
        """Regression evaluation over ``iterator``; as in the JAX package no
        mask is passed, to ``output`` or to the evaluation."""
        from ..eval.regression import RegressionEvaluation
        ev = RegressionEvaluation()
        for ds in iterator:
            ev.eval(ds.labels, self.output(ds.features))
        return ev

    # ------------------------------------------------------------ parameters
    def param_table(self) -> Dict[str, torch.Tensor]:
        """{"0_W": tensor, ...} (reference ``paramTable()`` naming; a nested
        parameter "0_fwd/W"): the parameters' detached views, layer-major."""
        return {f"{i}_{k}": v for i, ps in self.params.items() for k, v in leaves(ps)}

    paramTable = param_table

    def get_param(self, key) -> torch.Tensor:
        i, k = key.split("_", 1)
        t = self.params[i]
        for part in k.split("/"):
            t = t[part]
        return t

    getParam = get_param

    def params_flat(self) -> torch.Tensor:
        """Every parameter in one vector on the network's device (reference
        flattened params buffer): layer-major, each layer's parameters in
        the order its init creates them (the JAX package's order before a
        jitted step hands them back key-sorted)."""
        chunks = [v.reshape(-1) for v in self.param_table().values()]
        if not chunks:
            return torch.zeros(0, device=self.device)
        return torch.cat(chunks)

    def set_params_flat(self, vec) -> None:
        """Write ``vec`` (in :meth:`params_flat`'s order; an array or a
        tensor) into the parameters in place, each slice cast to its
        parameter's dtype on its device."""
        vec = torch.as_tensor(vec).reshape(-1)
        total = self.num_params()
        if total != vec.numel():
            raise ValueError(f"Param vector length {vec.numel()} != model {total}")
        pos = 0
        with torch.no_grad():
            for _, p in leaves(self._trainable()):
                n = p.numel()
                p.copy_(vec[pos:pos + n].reshape(p.shape).to(device=p.device, dtype=p.dtype))
                pos += n

    # ------------------------------------------------------------------ misc
    def clone(self) -> "MultiLayerNetwork":
        """A new network of a copy of this configuration on the same device,
        with copies of the parameters, layer state and updater state (the
        JAX package's ``clone``: counters, listeners and the streaming state
        start afresh)."""
        net = MultiLayerNetwork(self.conf.clone()).init(params=self.params, device=self.device,
                                                        states=self.states)
        net.updater_state = copy.deepcopy(self.updater_state)
        return net

    @property
    def n_layers(self) -> int:
        return len(self.conf.layers)

    def summary(self) -> str:
        lines = [f"{'idx':>3}  {'type':<28} {'params':>10}"]
        for i, impl in enumerate(self.impls):
            n = sum(p.numel() for _, p in leaves(impl.param_dict()))
            lines.append(f"{i:>3}  {type(self.conf.layers[i]).__name__:<28} {n:>10}")
        lines.append(f"Total params: {self.num_params()}")
        return "\n".join(lines)


def _map_streams(fn, x):
    """``fn`` on every stream: a tensor (MultiLayerNetwork) or each member
    of a tuple of optional tensors (ComputationGraph); None passes."""
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return tuple(None if a is None else fn(a) for a in x)
    return fn(x)


def _run_tbptt(net, f, l, fm, lm):
    """Truncated BPTT, shared by both containers (reference
    ``doTruncatedBPTT``; the JAX package's ``multilayer._run_tbptt``):
    segments of ``tbptt_fwd_length`` steps (the last one ragged), each
    taking ``iterations(n)`` updates from the same carried-in state; every
    input stream, features mask and labels mask is sliced per segment, and
    every rank-3 label (a rank-2 one is whole-sequence and passes as it
    is). The recurrent carries ((h, c) of an LSTM, a KV cache) go from
    segment to segment detached, keyed by layer index or vertex name;
    ``score_`` is the last segment's loss. A differing
    ``tbptt_back_length`` is treated as the forward length (warned once),
    as in the JAX package. The JAX package runs equal segments as one
    ``lax.scan``, a compiler device; this loop has the same arithmetic and
    iteration counts."""
    L = net.conf.tbptt_fwd_length
    if net.conf.tbptt_back_length != L and not net._warned_tbptt:
        log.warning("tbptt_back_length=%d differs from tbptt_fwd_length=%d; "
                    "backprop truncation uses the forward chunk length",
                    net.conf.tbptt_back_length, L)
        net._warned_tbptt = True
    first = f[0] if isinstance(f, (tuple, list)) else f
    T = int(first.shape[1])
    if T % L == 0:
        loss = watched(net, "_jit_tbptt_scan", "nn/tbptt_scan",
                       lambda *a: _tbptt_segments(net, *a, watch=False))(f, l, fm, lm, L)
    else:
        loss = _tbptt_segments(net, f, l, fm, lm, L, watch=True)
    net.score_ = loss
    if net.listeners or _mon.enabled():
        # as the JAX package's TBPTT: no step span, the batch size only
        score = float(loss)
        _mon.record_training_iteration(net, net.iteration_count - 1, score,
                                       batch_size=int(first.shape[0]))
        for lst in net.listeners:
            lst.iteration_done(net, net.iteration_count - 1, score)


def _tbptt_segments(net, f, l, fm, lm, L, watch):
    """The segments of one TBPTT minibatch from a zero carry; returns the
    last segment's loss. Equal segments run as one watched
    ``nn/tbptt_scan`` call (the JAX package scans them in one program), a
    ragged tail as watched ``mln/step`` segments."""
    first = f[0] if isinstance(f, (tuple, list)) else f
    T = int(first.shape[1])
    state = net._init_rnn_state(int(first.shape[0]))
    for start in range(0, T, L):
        sl = slice(start, min(start + L, T))

        def seg(a):
            return a[:, sl]

        loss, state = net._steps(_map_streams(seg, f),
                                 _map_streams(lambda a: seg(a) if a.dim() == 3 else a, l),
                                 _map_streams(seg, fm), _map_streams(seg, lm), state,
                                 watch=watch)
    return loss


def as_tensor(a):
    """An input as a tensor where it lies, its dtype kept (None stays
    None): what a watched forward's signature reads."""
    if a is None or isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(np.asarray(a))


def watched(net, slot, name, fn):
    """``net``'s watched wrapper of ``fn`` in attribute ``slot`` under
    ``name`` (``monitor/jitwatch.py``), made at first use."""
    w = net.__dict__.get(slot)
    if w is None:
        w = net.__dict__[slot] = monitored_jit(fn, name=name)
    return w


def _observed_steps(net, run):
    """One minibatch's updates (``run`` makes them and returns the last
    loss), observed as the JAX package's ``_fit_batch`` observes them when
    a listener is set or the monitor is on: the loss's value is fetched
    inside the ``step`` span, so the span and ``step_ms`` cover the
    finished step; then ``record_training_iteration`` (with ``step_ms``
    and the minibatch's wait, ``etl_ms``), then the listeners at the last
    update's iteration. Otherwise the loss stays on the device unread."""
    if not (net.listeners or _mon.enabled()):
        net.score_ = run()
        return
    t0 = time.perf_counter()
    with _mon.step_span(net.iteration_count):
        loss = run()
        score = float(loss)   # device-to-host value fetch: the step's end
    net.score_ = loss
    _mon.record_training_iteration(net, net.iteration_count - 1, score,
                                   batch_size=net.last_batch_size,
                                   step_ms=(time.perf_counter() - t0) * 1e3,
                                   etl_ms=net.last_etl_ms)
    for lst in net.listeners:
        lst.iteration_done(net, net.iteration_count - 1, score)


def _observe(net):
    """ParallelWrapper's listener view of a round (the JAX wrapper calls
    the listeners only): with a listener set, the score's value goes to
    the health state and to each listener's ``iteration_done`` at the
    last update's iteration."""
    if not net.listeners:
        return
    score = float(net.score_)
    iteration = net.iteration_count - 1
    get_health().record_iteration(iteration, score)
    for lst in net.listeners:
        lst.iteration_done(net, iteration, score)


def _fit_epochs(net, data, labels, epochs):
    """The fit loop both containers share (``fit`` of the JAX package's
    ``MultiLayerNetwork`` and ``ComputationGraph``): wrap the iterator for
    training, run the listeners' epoch hooks around each epoch, time each
    wait for a minibatch (``last_etl_ms``), run ``net._fit_batch`` on
    each, stop between minibatches once ``halt_requested`` is set (cleared
    when fit starts), hand an exception to the listeners'
    ``on_training_error`` before it leaves, and shut an owned pipeline
    down however the loop ends. Each epoch's minibatches run inside an
    ``epoch`` span."""
    if labels is not None:
        data = DataSet(np.asarray(data), np.asarray(labels))
    if isinstance(data, (DataSet, MultiDataSet)):
        data = ListDataSetIterator([data])
    it, own_pipeline = wrap_for_training(
        data, net.device, cache_device=net.gc.cache_mode == CacheMode.DEVICE)
    # a new fit supersedes an earlier halt
    net.halt_requested = False
    get_health().clear_halt()
    try:
        for _ in range(epochs):
            for lst in net.listeners:
                lst.on_epoch_start(net, net.epoch_count)
            with _mon.get_tracer().span("epoch", cat="train", epoch=net.epoch_count):
                t_etl = time.perf_counter()
                for ds in it:
                    net.last_etl_ms = (time.perf_counter() - t_etl) * 1e3
                    net._fit_batch(ds)
                    if net.halt_requested:
                        break
                    t_etl = time.perf_counter()
            for lst in net.listeners:
                lst.on_epoch_end(net, net.epoch_count)
            net.epoch_count += 1
            if net.halt_requested:
                log.warning("fit halted at epoch %d (halt_requested; see "
                            "TrainingHealthListener)", net.epoch_count)
                break
    except BaseException as e:
        dispatch_training_error(net, net.listeners, e)
        raise
    finally:
        if own_pipeline:
            it.shutdown()   # no prefetch worker outlives its fit
    return net
