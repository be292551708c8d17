"""ComputationGraph: DAG network container.

Counterpart of ``deeplearning4j_tpu/nn/graph.py`` for single-input,
single-output-set training with standard backprop: ``init``, ``output``,
``fit`` (a DataSet, an iterator of DataSets, or arrays), ``score``,
``compute_gradient_and_score`` and ``params``. The forward walks the
configuration's topological order (``_apply_graph``); the training loss
skips the forward of output layers that nothing consumes and evaluates
their loss on the preoutput (``fused_softmax_skip_set``). An update is the
JAX step core: loss -> autograd gradients -> minimize flip ->
``normalize_gradients`` -> each layer vertex's updater -> ``p - u`` in
place. Not ported yet: TBPTT over the graph, ``rnn_time_step``,
MultiDataSets, listeners, ``fit_external_errors`` and input preprocessors.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .. import resolve_device
from .conf import BackpropType
from .conf.graph import ComputationGraphConfiguration
from .conf.layers import Layer
from .layers import impl_for
from .multilayer import _fit_epochs, _n_iterations
from .multilayer import MultiLayerNetwork
from .updaters import Sgd
from ..datasets.dataset import DataSet, MultiDataSet
from ..optimize.updater import NetworkUpdater

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
        self._gen = None             # draws attention-dropout seeds in training

    # ------------------------------------------------------------------ init
    def init(self, params: Optional[Dict[str, Dict]] = None, device="cuda"):
        """Build the layer vertices on ``device`` (the card unless
        ``device="cpu"``). ``params`` ({vertex name: {"W": ...}}) installs
        copies of given weights, shape-checked against the config; without
        it, weights are drawn from a ``torch.Generator`` seeded with the
        config's seed, in topological order. Updater state starts at zero."""
        dev = resolve_device(device)
        conf = self.conf
        conf.infer_shapes()
        if conf.input_preprocessors:
            raise NotImplementedError("input preprocessors are not ported yet: "
                                      f"{sorted(conf.input_preprocessors)}")
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
            impls[name] = impl
        self.impls = nn.ModuleDict(impls)
        self.device = dev
        self._gen = torch.Generator().manual_seed(int(self.gc.seed) + 1)
        self.updater = NetworkUpdater({
            n: getattr(conf.vertices[n], "updater", None) or self.gc.updater
            or Sgd(learning_rate=1e-1) for n in layer_names})
        self.updater_state = self.updater.init_state(self.params)
        return self

    @property
    def params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{vertex name: {"W": tensor, ...}}: detached views of the
        parameters (they share storage, so they follow training)."""
        return {n: {k: p.detach() for k, p in ps.items()} for n, ps in self._trainable().items()}

    def _trainable(self) -> Dict[str, Dict[str, nn.Parameter]]:
        return {n: impl.param_dict() for n, impl in self.impls.items()}

    # Shared with MultiLayerNetwork: they read only device, gc, updater,
    # updater_state and _trainable().
    _to_device = MultiLayerNetwork._to_device
    _grads = MultiLayerNetwork._grads
    _update = MultiLayerNetwork._update
    _batch_tensors = MultiLayerNetwork._batch_tensors

    # -------------------------------------------------------------- forward
    def _apply_graph(self, inputs, input_masks, train, rng=None, skip=()):
        """Forward over the topological order. Returns (activations, masks).
        ``rng`` (a ``torch.Generator``, training only) draws attention
        dropout; ``skip`` names vertices not to run (the loss pass skips
        output-layer forwards)."""
        conf = self.conf
        acts = dict(zip(conf.network_inputs, inputs))
        masks = dict(zip(conf.network_inputs, input_masks or [None] * len(conf.network_inputs)))
        ctx = {"inputs": acts, "input_masks": masks, "train": train, "rng": rng}
        for name in self.topo:
            if name in skip:
                continue
            v = conf.vertices[name]
            in_names = conf.vertex_inputs[name]
            xs = [acts[i] for i in in_names]
            if isinstance(v, Layer):
                m = masks.get(in_names[0])
                acts[name] = self.impls[name](xs[0], mask=m, ctx=ctx)
                masks[name] = m
            else:
                acts[name] = v.forward(xs, ctx)
                masks[name] = v.propagate_mask([masks.get(i) for i in in_names])
        return acts, masks

    def output(self, *inputs, masks=None):
        """Activations of the output vertices; one tensor (on the network's
        device) when the graph has one output, else a list."""
        with torch.inference_mode():
            xs = [self._to_device(x) for x in inputs]
            ms = None if masks is None else [self._to_device(m) for m in masks]
            acts, _ = self._apply_graph(xs, ms, False)
            outs = [acts[n] for n in self.conf.network_outputs]
        return outs[0] if len(outs) == 1 else outs

    # -------------------------------------------------------------- training
    def _loss_fn(self, inputs, labels, input_masks, label_masks, train, rng=None):
        """Sum of the output layers' losses + L1/L2 (``_loss_fn`` of the JAX
        package, without the MoE auxiliary loss)."""
        conf = self.conf
        if train:
            for impl in self.impls.values():
                impl.check_trainable()
        out_set = fused_softmax_skip_set(conf, self.impls)
        acts, masks = self._apply_graph(inputs, input_masks, train, rng, skip=out_set)
        total = 0.0
        for out_name, lbl, lm in zip(conf.network_outputs, labels,
                                     label_masks or [None] * len(labels)):
            impl = self.impls[out_name] if out_name in self.impls else None
            if not hasattr(impl, "loss_on"):
                raise ValueError(f"Output vertex '{out_name}' is not an output "
                                 f"layer: cannot compute the training loss")
            in_name = conf.vertex_inputs[out_name][0]
            x = acts[in_name]
            mask = lm if lm is not None else (masks.get(in_name) if x.dim() == 3 else None)
            total = total + impl.loss_on(x, lbl, mask=mask)
        reg = 0.0
        for impl in self.impls.values():
            reg = reg + impl.regularization()
        return total + reg

    def _step(self, f, l, fm, lm, iteration):
        loss = self._loss_fn([f], [l], None if fm is None else [fm],
                             None if lm is None else [lm], True, self._gen)
        self._update(loss, iteration)
        return loss.detach()

    def _tensors(self, ds: DataSet):
        return tuple(self._to_device(a) for a in
                     (ds.features, ds.labels, ds.features_mask, ds.labels_mask))

    def fit(self, data, labels=None, epochs=1):
        """Train. Accepts a DataSet, a DataSetIterator (or any iterable of
        DataSets), or (features, labels) arrays; iterators go through the
        prefetch pipeline, as in ``MultiLayerNetwork.fit``. Under
        ``CacheMode.DEVICE`` the cache sits on the caller's DataSet."""
        return _fit_epochs(self, data, labels, epochs)

    def _fit_batch(self, ds: DataSet):
        if len(self.conf.network_inputs) != 1 or isinstance(ds, MultiDataSet):
            raise NotImplementedError("graphs with several inputs need MultiDataSets, "
                                      "whose fit is not ported yet")
        f, l, fm, lm = self._batch_tensors(ds)
        if (self.conf.backprop_type == BackpropType.TruncatedBPTT and f.dim() == 3
                and f.shape[1] > self.conf.tbptt_fwd_length):
            raise NotImplementedError("truncated BPTT over a ComputationGraph is not ported yet")
        n_iter = _n_iterations(self.gc)
        for k in range(n_iter):
            loss = self._step(f, l, fm, lm, self.iteration_count + k)
        self.iteration_count += n_iter
        self.score_ = loss

    def score(self, ds: Optional[DataSet] = None, training=False) -> float:
        """Loss (+ penalty) on a dataset, or the last training score when
        called without arguments."""
        if ds is None:
            return float(self.score_)
        f, l, fm, lm = self._tensors(ds)
        with torch.no_grad():
            loss = self._loss_fn([f], [l], None if fm is None else [fm],
                                 None if lm is None else [lm], training)
        return float(loss)

    def compute_gradient_and_score(self, ds: DataSet):
        """({vertex: {param: grad}}, score) without updating the parameters.
        As in the JAX package, the masks are not used and dropout is off."""
        f, l, _, _ = self._tensors(ds)
        loss = self._loss_fn([f], [l], None, None, True)
        grads = self._grads(loss)
        self.score_ = loss.detach()
        return grads, float(self.score_)
