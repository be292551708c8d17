"""ComputationGraph: DAG network container.

Counterpart of ``deeplearning4j_tpu/nn/graph.py``: ``init``, ``output``,
``feed_forward``, ``fit`` (a DataSet or MultiDataSet, an iterator of
either, or arrays; several inputs and outputs with a mask a stream;
truncated BPTT), ``fit_external_errors``, ``score``,
``compute_gradient_and_score`` and ``params``. The forward walks the
configuration's topological order (``_apply_graph``); the training loss
skips the forward of output layers that nothing consumes and evaluates
their loss on the preoutput (``fused_softmax_skip_set``). An update is the
JAX step core: loss -> autograd gradients -> minimize flip ->
``normalize_gradients`` -> each layer vertex's updater -> ``p - u`` in
place, then the layers' new state (BatchNormalization's running
statistics) is committed. Frozen vertices (``FrozenLayer``) train as in
``MultiLayerNetwork`` (its docstring): no gradient, and no updater work
while their updater state is zero; a LossLayer may be an output vertex.
The loss adds the auxiliary losses layers leave in ``ctx["aux_loss"]``
(MoE load balancing). Truncated BPTT is the loop
both containers share (``multilayer._run_tbptt``): every input stream and
3-D label sliced per segment, the carries detached by vertex name. Each
layer vertex's input preprocessor runs just before it, and convolutional
inputs arrive NCHW and flow NHWC
(``nchw_to_nhwc``). ``rnn_time_step`` streams over the DAG under
``torch.inference_mode``: every vertex with a stream state (LSTM layers,
the attention layers' KV cache) carries it by vertex name from call to
call. Dropout, weight noise, constraints, listeners and the health halt
work as in ``MultiLayerNetwork`` (its docstring): each training forward
splits the graph's generator per layer vertex in topological order, and
the output layers' loss is taken on unnoised parameters with their input
dropout from the step's stream (JAX ``graph.py:201``). Remat works as in
``MultiLayerNetwork`` (its docstring) over the DAG (``_remat_loss``): a
fit step keeps every vertex's output except those of layers without
``save_output`` that feed one vertex, which are recomputed in that
vertex's region (the TransformerLM's attention regions run K5 again in
the backward). ``evaluate``
ranks the output on the device (``eval/evaluation.py``); ``param_table``
and ``summary`` walk the topological order.
"""
from __future__ import annotations

from collections import Counter
from functools import partial
from typing import Dict, Optional

import torch
from torch import nn

from .. import resolve_device
from .conf import BackpropType, CacheMode
from .conf.graph import ComputationGraphConfiguration
from .conf.layers import Layer
from .layers import impl_for
from .layers.base import (StepGenerators, checkpointed, generator_state, remat_enabled,
                          replay_generator)
from .multilayer import _detached, _fit_epochs, _observe, _run_tbptt, nchw_to_nhwc
from .multilayer import MultiLayerNetwork
from .updaters import Sgd
from ..datasets.dataset import DataSet, MultiDataSet
from ..optimize.updater import NetworkUpdater
from ..utils.trees import leaves, tree_map

__all__ = ["ComputationGraph", "fused_softmax_skip_set"]


def fused_softmax_skip_set(conf, impls):
    """Output-layer vertices whose forwards the loss pass skips: ``loss_on``
    consumes their input activations, so softmax + cross-entropy runs on
    the preoutput. Only those no other vertex consumes."""
    consumed = {i for ins in conf.vertex_inputs.values() for i in ins}
    return frozenset(n for n in conf.network_outputs
                     if hasattr(impls[n] if n in impls else None, "loss_on")
                     and n not in consumed)


class ComputationGraph(nn.Module):
    def __init__(self, conf: ComputationGraphConfiguration):
        super().__init__()
        self.conf = conf
        self.gc = conf.global_conf
        self.topo = conf.topological_order()
        self.impls = None
        self.device = None
        self.updater = None          # NetworkUpdater keyed by vertex name
        self.updater_state = None
        self.iteration_count = 0
        self.epoch_count = 0
        self.score_ = float("nan")
        self.last_etl_ms = 0.0       # wait for the last minibatch in fit
        self.last_batch_size = 0
        self.listeners = []
        self.halt_requested = False  # TrainingHealthListener's "halt"
        self._gen = None             # the training step's stream (dropout, noise)
        self._rnn_state = None       # streaming state for rnn_time_step, by vertex
        self._warned_tbptt = False
        self._idle_seen = {}         # frozen vertex -> (updater state, all zero?)

    # ------------------------------------------------------------------ init
    def init(self, params: Optional[Dict[str, Dict]] = None, device="cuda",
             states: Optional[Dict[str, Dict]] = None):
        """Build the layer vertices on ``device`` (the card unless
        ``device="cpu"``). ``params`` ({vertex name: {"W": ...}}) installs
        copies of given weights, shape-checked against the config; without
        it, weights are drawn from a ``torch.Generator`` seeded with the
        config's seed, in topological order. ``states`` (same keys)
        installs the layers' state, else each starts from its initial
        state. Updater state starts at zero; the training draws start from
        a generator seeded with the config's seed + 1."""
        dev = resolve_device(device)
        conf = self.conf
        conf.infer_shapes()
        layer_names = [n for n in self.topo if isinstance(conf.vertices[n], Layer)]
        if params is not None:
            extra = set(params) - set(layer_names)
            if extra:
                raise ValueError(f"parameters for unknown layer vertices {sorted(extra)}")
        gen = torch.Generator().manual_seed(int(self.gc.seed))
        impls = {}
        for name in layer_names:
            impl = impl_for(conf.vertices[name], self.gc)
            impl.index = name
            p = params.get(name, {}) if params is not None else impl.init_params(gen)
            impl.set_params(p, dev)
            impl.set_state(states.get(name, {}) if states is not None else impl.init_state(),
                           dev)
            impls[name] = impl
        self.impls = nn.ModuleDict(impls)
        self.device = dev
        self._rnn_state = None
        self._gen = torch.Generator().manual_seed(int(self.gc.seed) + 1)
        self.updater = NetworkUpdater({
            n: getattr(conf.vertices[n], "updater", None) or self.gc.updater
            or Sgd(learning_rate=1e-1) for n in layer_names})
        self.updater_state = self.updater.init_state(self.params)
        return self

    @property
    def params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{vertex name: {"W": tensor, ...}}: detached views of the
        parameters (they share storage, so they follow training); a wrapper
        layer's nest."""
        return {n: tree_map(torch.Tensor.detach, ps) for n, ps in self._trainable().items()}

    def _layers(self) -> Dict[str, nn.Module]:
        """Each layer vertex's implementation by name."""
        return dict(self.impls.items())

    @property
    def states(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{vertex name: {"mean": tensor, ...}} for every layer vertex ({}
        for a stateless one): live buffers that fit steps update in place."""
        return {n: impl.layer_state() for n, impl in self.impls.items()}

    # Shared with MultiLayerNetwork: they read only device, gc, updater,
    # updater_state, impls, listeners and _layers().
    _to_device = MultiLayerNetwork._to_device
    _trainable = MultiLayerNetwork._trainable
    _grads = MultiLayerNetwork._grads
    _idle_frozen = MultiLayerNetwork._idle_frozen
    _update = MultiLayerNetwork._update
    _apply_update = MultiLayerNetwork._apply_update
    _updates = MultiLayerNetwork._updates
    _apply_gradients = MultiLayerNetwork._apply_gradients
    _apply_constraints = MultiLayerNetwork._apply_constraints
    _steps = MultiLayerNetwork._steps
    _commit_states = MultiLayerNetwork._commit_states
    num_params = MultiLayerNetwork.num_params
    numParams = num_params
    set_listeners = setListeners = MultiLayerNetwork.set_listeners
    add_listeners = addListeners = MultiLayerNetwork.add_listeners

    # -------------------------------------------------------------- forward
    def _apply_graph(self, inputs, input_masks, train, rng=None, skip=(), new_states=None,
                     rnn_state_in=None):
        """Forward over the topological order. Returns (activations, masks,
        ctx). ``rng`` (the step's ``torch.Generator``, training only) is
        split per layer vertex (``ctx["rng"]`` while it runs) for its weight
        noise, input dropout and attention dropout; ``skip`` names vertices
        not to run (the loss pass skips output-layer forwards); in
        training, layers with state leave their new state in
        ``new_states`` when it is given. ``rnn_state_in`` ({vertex name:
        carry}) continues a stream; each carrying vertex leaves its new
        carry in ``ctx["rnn_state_out"]``."""
        conf = self.conf
        acts, masks, ctx = self._forward_context(inputs, input_masks, train, new_states,
                                                 rnn_state_in)
        gens = StepGenerators(rng if train else None)
        for name in self.topo:
            if name in skip:
                continue
            v = conf.vertices[name]
            in_names = conf.vertex_inputs[name]
            if isinstance(v, Layer):
                ctx["rng"] = gens.next(self.impls[name])
                masks[name] = masks.get(in_names[0])
            else:
                masks[name] = v.propagate_mask([masks.get(i) for i in in_names])
            acts[name] = self._vertex_forward(name, acts, masks, ctx)
        ctx.pop("rng", None)
        return acts, masks, ctx

    def _forward_context(self, inputs, input_masks, train, new_states, rnn_state_in):
        """(activations, masks, ctx) of a forward before its first vertex:
        the inputs (convolutional ones NHWC) and their masks by name."""
        conf = self.conf
        its = conf.input_types or [None] * len(inputs)
        acts = dict(zip(conf.network_inputs,
                        [nchw_to_nhwc(x, it) for x, it in zip(inputs, its)]))
        masks = dict(zip(conf.network_inputs, input_masks or [None] * len(conf.network_inputs)))
        ctx = {"inputs": acts, "input_masks": masks, "train": train}
        if new_states is not None:
            ctx["new_states"] = new_states
        if rnn_state_in is not None:
            ctx["rnn_state_in"] = rnn_state_in
        return acts, masks, ctx

    def _vertex_forward(self, name, acts, masks, ctx):
        """Vertex ``name``'s output from its inputs' entries of ``acts``: a
        layer after its input preprocessor, on its first input's mask, with
        ``ctx["rng"]`` as its generator."""
        in_names = self.conf.vertex_inputs[name]
        v = self.conf.vertices[name]
        if not isinstance(v, Layer):
            return v.forward([acts[i] for i in in_names], ctx)
        x = acts[in_names[0]]
        pre = self.conf.input_preprocessors.get(name)
        if pre is not None:
            x = pre(x, ctx)
        return self.impls[name].noised_forward(x, masks.get(in_names[0]), ctx)

    def output(self, *inputs, masks=None):
        """Activations of the output vertices; one tensor (on the network's
        device) when the graph has one output, else a list."""
        with torch.inference_mode():
            xs = [self._to_device(x) for x in inputs]
            ms = None if masks is None else [self._to_device(m) for m in masks]
            acts, _, _ = self._apply_graph(xs, ms, False)
            outs = [acts[n] for n in self.conf.network_outputs]
        return outs[0] if len(outs) == 1 else outs

    def feed_forward(self, *inputs, train=False):
        """Every vertex's activation, and the inputs', by name (reference
        ``feedForward``); ``train`` runs the training forward (batch
        statistics) without changing any state."""
        with torch.no_grad():
            acts, _, _ = self._apply_graph([self._to_device(x) for x in inputs], None, train)
        return dict(acts)

    feedForward = feed_forward

    # ------------------------------------------------------------- streaming
    def _init_rnn_state(self, batch):
        return {n: impl.init_stream_state(batch, self.device)
                for n, impl in self.impls.items() if hasattr(impl, "init_stream_state")}

    def rnn_time_step(self, *inputs):
        """Stateful streaming inference over the DAG (reference CG
        ``rnnTimeStep``): each input [b, T, f] (or one step [b, f]; token
        ids [b, 1] are one step too) continues from the state the previous
        call left. A single step's rank-3 outputs are squeezed to their
        last step. One tensor when the graph has one output, else a
        list."""
        with torch.inference_mode():
            xs = [self._to_device(x) for x in inputs]
            single_step = xs[0].dim() == 2
            if single_step:
                xs = [x[:, None, :] for x in xs]
            if self._rnn_state is None:
                self._rnn_state = self._init_rnn_state(int(xs[0].shape[0]))
            acts, _, ctx = self._apply_graph(xs, None, False, rnn_state_in=self._rnn_state)
            self._rnn_state = ctx.get("rnn_state_out")
            outs = [acts[n] for n in self.conf.network_outputs]
        if single_step:
            outs = [o[:, -1, :] if o.dim() == 3 else o for o in outs]
        return outs[0] if len(outs) == 1 else outs

    rnnTimeStep = rnn_time_step

    def rnn_clear_previous_state(self):
        self._rnn_state = None

    rnnClearPreviousState = rnn_clear_previous_state

    # -------------------------------------------------------------- training
    def _loss_fn(self, inputs, labels, input_masks, label_masks, train, rng=None,
                 new_states=None, rnn_state_in=None, rnn_state_out=None, remat=False):
        """Sum of the output layers' losses + L1/L2 + the auxiliary losses
        the forward left in ``ctx["aux_loss"]`` (``_loss_fn`` of the JAX
        package). A training forward's new layer state goes into
        ``new_states`` when it is given (an output layer's ``update_state``
        too, as in ``MultiLayerNetwork._loss_fn``); ``rnn_state_in`` continues the
        vertices' carries, and their new carries go into ``rnn_state_out``
        when it is given. ``remat`` (a training step's) runs the forward in
        checkpointed regions."""
        rng = rng if train else None
        if remat and train:
            total, ctx = self._remat_loss(inputs, labels, input_masks, label_masks, rng,
                                          new_states, rnn_state_in)
        else:
            out_set = fused_softmax_skip_set(self.conf, self.impls)
            acts, masks, ctx = self._apply_graph(inputs, input_masks, train, rng,
                                                 skip=out_set, new_states=new_states,
                                                 rnn_state_in=rnn_state_in)
            total = self._output_losses(
                [acts[self.conf.vertex_inputs[o][0]] for o in self.conf.network_outputs],
                labels, label_masks, masks, ctx, train, rng, new_states)
        reg = 0.0
        for impl in self.impls.values():
            reg = reg + impl.regularization()
        if rnn_state_out is not None:
            rnn_state_out.update(ctx.get("rnn_state_out") or {})
        return total + reg + ctx.get("aux_loss", 0.0)

    def _output_losses(self, xs, labels, label_masks, masks, ctx, train, gen, new_states):
        """The sum of the output layers' losses, each on its input vertex's
        activations ``xs[k]`` after its preprocessor, their input dropout
        drawn from ``gen`` in turn."""
        conf = self.conf
        total = 0.0
        for out_name, x, lbl, lm in zip(conf.network_outputs, xs, labels,
                                        label_masks or [None] * len(labels)):
            impl = self.impls[out_name] if out_name in self.impls else None
            if not hasattr(impl, "loss_on"):
                raise ValueError(f"Output vertex '{out_name}' is not an output "
                                 f"layer: cannot compute the training loss")
            in_name = conf.vertex_inputs[out_name][0]
            pre = conf.input_preprocessors.get(out_name)
            if pre is not None:
                x = pre(x, ctx)
            mask = lm if lm is not None else (masks.get(in_name) if x.dim() == 3 else None)
            total = total + impl.loss_on(x, lbl, mask=mask, train=train, gen=gen)
            if new_states is not None and hasattr(impl, "update_state"):
                new_states[out_name] = impl.update_state(x, lbl)    # CenterLoss
        return total

    def _remat_loss(self, inputs, labels, input_masks, label_masks, rng, new_states,
                    rnn_state_in):
        """The output layers' losses under remat (``MultiLayerNetwork.
        _remat_loss`` over the DAG). A layer vertex without ``save_output``
        that feeds exactly one vertex (and no loss) is recomputed: it runs
        in the region of the vertex it feeds, or of that vertex's consumer
        when it too is recomputed; every other vertex roots a region of its
        own, whose output is kept. Regions run in the topological order of
        their roots, the losses in one last region. Masks, which need no
        activation, are propagated first. Returns (loss, ctx)."""
        conf = self.conf
        out_set = fused_softmax_skip_set(conf, self.impls)
        run = [n for n in self.topo if n not in out_set]
        acts, masks, ctx = self._forward_context(inputs, input_masks, True, new_states,
                                                 rnn_state_in)
        gens = StepGenerators(rng)
        states, uses = {}, Counter()
        for name in run:
            in_names = conf.vertex_inputs[name]
            uses.update(in_names)
            if isinstance(conf.vertices[name], Layer):
                states[name] = generator_state(gens.next(self.impls[name]))
                masks[name] = masks.get(in_names[0])
            else:
                masks[name] = conf.vertices[name].propagate_mask(
                    [masks.get(i) for i in in_names])
        out_ins = [conf.vertex_inputs[o][0] for o in conf.network_outputs]
        uses.update({i: 2 for i in out_ins})
        out_state = generator_state(rng)

        def recomputed(name):
            return (name in states and not self.impls[name].save_output
                    and uses[name] == 1)

        def members(name, acc):
            for i in conf.vertex_inputs[name]:
                if recomputed(i):
                    members(i, acc)
            acc.append(name)
            return acc

        def region(names, boundary, c, first, *xs):
            local = dict(zip(boundary, xs))
            for name in names:
                c["rng"] = replay_generator(states.get(name))
                local[name] = self._vertex_forward(name, local, masks, c)
            return local[names[-1]]

        for name in run:
            if recomputed(name):
                continue
            names = sorted(members(name, []), key=run.index)
            inside = set(names)
            boundary = list(dict.fromkeys(i for n in names for i in conf.vertex_inputs[n]
                                          if i not in inside))
            acts[name] = checkpointed(partial(region, names, boundary), ctx,
                                      *[acts[i] for i in boundary])

        def losses(c, first, *xs):
            gen = replay_generator(out_state)
            total = self._output_losses(list(xs), labels, label_masks, masks, c, True, gen,
                                        c.get("new_states"))
            if first and rng is not None:
                rng.set_state(gen.get_state())
            return total

        return checkpointed(losses, ctx, *[acts[i] for i in out_ins]), ctx

    def _train_loss(self, inputs, labels, fms, lms, rnn_state_in=None, rng=None):
        """The training loss of one step, nothing updated: (loss, carries by
        vertex name, the layers' new state), as
        ``MultiLayerNetwork._train_loss``."""
        new_states, rnn_out = {}, {}
        loss = self._loss_fn(inputs, labels, fms, lms, True,
                             self._gen if rng is None else rng, new_states,
                             rnn_state_in, rnn_out,
                             remat=remat_enabled(self.gc, self.impls.values()))
        return loss, rnn_out, new_states

    def _step(self, inputs, labels, fms, lms, iteration, rnn_state_in=None):
        """One update, then the layers' new state. Returns (detached loss,
        detached carries by vertex name), as ``MultiLayerNetwork._step``."""
        loss, rnn_out, new_states = self._train_loss(inputs, labels, fms, lms, rnn_state_in)
        self._update(loss, iteration)
        self._commit_states(new_states)
        return loss.detach(), _detached(rnn_out)

    def _streams(self, ds, cached=False):
        """A DataSet's or MultiDataSet's (inputs, labels, features masks,
        labels masks) on the device: tuples, a masks entry None when the
        set has none. ``cached`` (``CacheMode.DEVICE`` in fit) keeps the
        copies on the caller's set (a DataSet's own cache, not a
        wrapper's, so that it hits on the next epoch); a put-ahead view's
        tensors pass as they are."""
        if isinstance(ds, DataSet):
            f, l, fm, lm = ds.device_arrays(self.device) if cached else self._tensors(ds)
            return (f,), (l,), None if fm is None else (fm,), None if lm is None else (lm,)
        if cached:
            return ds.device_arrays(self.device)

        def put(seq):
            return None if seq is None else tuple(
                None if a is None else self._to_device(a) for a in seq)
        return (put(ds.features), put(ds.labels), put(ds.features_masks),
                put(ds.labels_masks))

    def _tensors(self, ds: DataSet):
        return tuple(self._to_device(a) for a in
                     (ds.features, ds.labels, ds.features_mask, ds.labels_mask))

    def fit(self, data, labels=None, epochs=1):
        """Train. Accepts a DataSet or MultiDataSet, an iterator of either
        (or any iterable), or (features, labels) arrays; iterators go
        through the prefetch pipeline, as in ``MultiLayerNetwork.fit``.
        Under ``CacheMode.DEVICE`` the cache sits on the caller's set."""
        return _fit_epochs(self, data, labels, epochs)

    def _fit_batch(self, ds):
        inputs, labels, fms, lms = self._streams(ds, self.gc.cache_mode == CacheMode.DEVICE)
        self.last_batch_size = int(inputs[0].shape[0])
        if len(inputs) != len(self.conf.network_inputs):
            raise ValueError(f"the graph has {len(self.conf.network_inputs)} inputs, the "
                             f"minibatch {len(inputs)} feature arrays")
        if (self.conf.backprop_type == BackpropType.TruncatedBPTT
                and all(x.dim() == 3 for x in inputs)
                and inputs[0].shape[1] > self.conf.tbptt_fwd_length):
            _run_tbptt(self, inputs, labels, fms, lms)
            return
        self.score_, _ = self._steps(inputs, labels, fms, lms)
        _observe(self)

    def fit_external_errors(self, inputs, epsilons):
        """One update from errors computed outside the graph (reference
        ``calcBackpropGradients`` with external epsilons): the
        vector-Jacobian product of the output vertices' activations (a
        training forward) with ``epsilons`` (one per output, in
        ``network_outputs`` order) -> gradient normalization -> the
        updaters -> ``p - u``; one iteration. As in the JAX package the
        layers' state is not committed, there is no minimize flip and no
        constraint, and no dropout or weight noise is drawn."""
        xs = [self._to_device(x) for x in _as_list(inputs)]
        eps = [self._to_device(e) for e in _as_list(epsilons)]
        acts, _, _ = self._apply_graph(xs, None, True)
        outs = [acts[n] for n in self.conf.network_outputs]
        grads = self._grads(outs, [e.to(o.dtype) for o, e in zip(outs, eps)],
                            skip=self._idle_frozen())
        self._apply_gradients(grads, self.iteration_count)
        self.iteration_count += 1
        return self

    def score(self, ds=None, training=False) -> float:
        """Loss (+ penalty and auxiliary losses) on a DataSet or
        MultiDataSet, masks included, or the last training score when
        called without arguments."""
        if ds is None:
            return float(self.score_)
        inputs, labels, fms, lms = self._streams(ds)
        with torch.no_grad():
            loss = self._loss_fn(inputs, labels, fms, lms, training)
        return float(loss)

    def compute_gradient_and_score(self, ds):
        """({vertex: {param: grad}}, score) without updating the parameters.
        As in the JAX package, the masks are not used and dropout is off."""
        inputs, labels, _, _ = self._streams(ds)
        loss = self._loss_fn(inputs, labels, None, None, True)
        grads = self._grads(loss)
        self.score_ = loss.detach()
        return grads, float(self.score_)

    # ------------------------------------------------------------ evaluation
    def evaluate(self, iterator, output_idx=0):
        """Classification evaluation on output ``output_idx`` (reference
        ``evaluate``) over DataSets or MultiDataSets: each minibatch's
        ``output`` (with its features masks) stays on the device and goes
        to :class:`eval.Evaluation`, which copies only class indices to
        the host; that output's labels mask, else the first features mask,
        picks the steps that count."""
        from ..eval.evaluation import Evaluation
        ev = Evaluation()
        for ds in iterator:
            if isinstance(ds, DataSet):
                ds = MultiDataSet([ds.features], [ds.labels],
                                  None if ds.features_mask is None else [ds.features_mask],
                                  None if ds.labels_mask is None else [ds.labels_mask])
            outs = self.output(*ds.features, masks=ds.features_masks)
            out = outs[output_idx] if isinstance(outs, list) else outs
            lm = None if ds.labels_masks is None else ds.labels_masks[output_idx]
            if lm is None and ds.features_masks is not None:
                lm = ds.features_masks[0]
            ev.eval(ds.labels[output_idx], out, mask=lm)
        return ev

    # ------------------------------------------------------------ parameters
    def param_table(self) -> Dict[str, torch.Tensor]:
        """{"vertex_W": tensor, ...} in topological order (a nested parameter
        "vertex_fwd/W"): the parameters' detached views."""
        params = self.params
        return {f"{n}_{k}": v for n in self.topo if n in params for k, v in leaves(params[n])}

    paramTable = param_table

    def summary(self) -> str:
        lines = [f"{'vertex':<32} {'type':<28} {'params':>10}"]
        for name in self.topo:
            v = self.conf.vertices[name]
            n = (sum(p.numel() for _, p in leaves(self.impls[name].param_dict()))
                 if name in self.impls else 0)
            lines.append(f"{name:<32} {type(v).__name__:<28} {n:>10}")
        lines.append(f"Total params: {self.num_params()}")
        return "\n".join(lines)


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]
