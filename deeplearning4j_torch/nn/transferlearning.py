"""Transfer learning: fine-tune, freeze and edit trained networks.

Counterpart of ``deeplearning4j_tpu/nn/transferlearning.py`` (reference
``nn/transferlearning/``: ``TransferLearning.Builder`` and ``GraphBuilder``,
``FineTuneConfiguration``, ``TransferLearningHelper``). The built network
lives on the source network's device. Retained layers keep copies of the
source's parameters and layer state; a layer whose width changed, and an
added one, draws fresh weights from the new network's own generator (its
config's seed); frozen layers are wrapped in ``FrozenLayer``. The updater
state starts at zero, so a frozen layer costs no updater work
(``nn/multilayer.py``). The helpers run the frozen part once
(``featurize``: a DataSet or MultiDataSet of its activations on the host)
and train the rest as a network of its own.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional

from .conf import ComputationGraphConfiguration, GlobalConfig, MultiLayerConfiguration
from .conf.graph import MergeVertex
from .conf.layers import FeedForwardLayer, FrozenLayer, Layer
from .graph import ComputationGraph
from .multilayer import MultiLayerNetwork
from ..datasets.dataset import DataSet, MultiDataSet

__all__ = ["FineTuneConfiguration", "TransferLearning", "GraphTransferLearningHelper",
           "TransferLearningHelper"]


@dataclasses.dataclass
class FineTuneConfiguration:
    """Global-config overrides applied by the builders (reference
    ``FineTuneConfiguration.java``): the fields that are not None."""
    seed: Optional[int] = None
    updater: Optional[Any] = None
    activation: Optional[str] = None
    weight_init: Optional[str] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    dropout: Optional[float] = None
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: Optional[float] = None

    class Builder:
        def __init__(self):
            self._c = FineTuneConfiguration()

        def __getattr__(self, name):
            if name.startswith("_"):
                raise AttributeError(name)

            def setter(v):
                if not hasattr(self._c, name):
                    raise AttributeError(f"FineTuneConfiguration has no field '{name}'")
                setattr(self._c, name, v)
                return self
            return setter

        def build(self):
            return self._c

    @staticmethod
    def builder():
        return FineTuneConfiguration.Builder()

    def apply_to(self, gc: GlobalConfig) -> GlobalConfig:
        gc = copy.deepcopy(gc)
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is not None:
                setattr(gc, f.name, v)
        return gc


def _inner(layer):
    return getattr(layer, "inner", None) or layer


def _carry(new, old, keys, device):
    """Copies of ``old``'s parameters and layer state in ``new``'s layers
    (``keys``: new key -> old key), where the old layer has any."""
    layers = new._layers()
    for k, src in keys.items():
        if old.params.get(src):
            layers[k].set_params(old.params[src], device)
        if old.states.get(src):
            layers[k].set_state(old.states[src], device)


def _frozen_closure(names, vertices, vertex_inputs):
    """The named vertices and every vertex that feeds them."""
    frozen, stack = set(), list(names)
    while stack:
        n = stack.pop()
        if n in frozen or n not in vertices:
            continue
        frozen.add(n)
        stack.extend(i for i in vertex_inputs.get(n, []) if i in vertices)
    return frozen


def _host(t):
    """An activation as a host array (bf16 as f32, the dtype a DataSet
    would give the next layer anyway)."""
    t = t.detach()
    if t.is_floating_point() and t.dtype.itemsize < 4:
        t = t.float()
    return t.cpu().numpy()


class TransferLearning:
    """The reference's ``TransferLearning.Builder`` and ``GraphBuilder``."""

    class Builder:
        def __init__(self, net: MultiLayerNetwork):
            self._net = net
            self._fine_tune: Optional[FineTuneConfiguration] = None
            self._frozen_till = -1
            self._n_out_replace: Dict[int, tuple] = {}
            self._remove_from: Optional[int] = None
            self._added: List[Layer] = []
            self._input_type = net.conf.input_type

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._fine_tune = ftc
            return self

        fineTuneConfiguration = fine_tune_configuration

        def set_feature_extractor(self, layer_idx: int):
            """Freeze layers [0, layer_idx] (reference ``setFeatureExtractor``)."""
            self._frozen_till = int(layer_idx)
            return self

        setFeatureExtractor = set_feature_extractor

        def n_out_replace(self, layer_idx: int, n_out: int, weight_init: Optional[str] = None):
            """A new width for layer ``layer_idx``, re-initialised (with
            ``weight_init`` when given), and the next layer's n_in with it."""
            self._n_out_replace[int(layer_idx)] = (int(n_out), weight_init)
            return self

        nOutReplace = n_out_replace

        def remove_output_layer(self):
            return self.remove_layers_from_output(1)

        removeOutputLayer = remove_output_layer

        def remove_layers_from_output(self, n: int):
            self._remove_from = len(self._net.conf.layers) - int(n)
            return self

        removeLayersFromOutput = remove_layers_from_output

        def add_layer(self, layer: Layer):
            self._added.append(layer)
            return self

        addLayer = add_layer

        def set_input_type(self, it):
            self._input_type = it
            return self

        setInputType = set_input_type

        def build(self) -> MultiLayerNetwork:
            old_conf = self._net.conf
            gc = old_conf.global_conf
            if self._fine_tune is not None:
                gc = self._fine_tune.apply_to(gc)
            layers = [copy.deepcopy(l) for l in old_conf.layers]
            layers = layers[:len(layers) if self._remove_from is None else self._remove_from]
            reinit = set()
            for idx, (n_out, w_init) in sorted(self._n_out_replace.items()):
                inner = _inner(layers[idx])
                if not isinstance(inner, FeedForwardLayer):
                    raise ValueError(f"nOutReplace on layer {idx} ({type(inner).__name__}): "
                                     f"not a FeedForwardLayer")
                inner.n_out = n_out
                if w_init is not None:
                    inner.weight_init = w_init
                reinit.add(idx)
                # the next layer's nIn changes with it, and so its weights
                if idx + 1 < len(layers):
                    nxt = _inner(layers[idx + 1])
                    if isinstance(nxt, FeedForwardLayer):
                        nxt.n_in = n_out
                        reinit.add(idx + 1)
            n_old = len(layers)
            layers.extend(copy.deepcopy(l) for l in self._added)
            reinit.update(range(n_old, len(layers)))
            for i in range(min(self._frozen_till + 1, len(layers))):
                if not isinstance(layers[i], FrozenLayer):
                    layers[i] = FrozenLayer(inner=layers[i])
            new_conf = MultiLayerConfiguration(
                global_conf=gc, layers=layers,
                input_preprocessors={k: v for k, v in old_conf.input_preprocessors.items()
                                     if int(k) < len(layers)},
                input_type=self._input_type, backprop=old_conf.backprop, pretrain=False,
                backprop_type=old_conf.backprop_type,
                tbptt_fwd_length=old_conf.tbptt_fwd_length,
                tbptt_back_length=old_conf.tbptt_back_length)
            if self._input_type is not None:    # shape inference for the added layers
                it = self._input_type
                for i, lc in enumerate(layers):
                    pre = new_conf.preprocessor(i)
                    if pre is None:
                        pre = lc.preprocessor_for(it)
                        if pre is not None:
                            new_conf.input_preprocessors[str(i)] = pre
                    if pre is not None:
                        it = pre.get_output_type(it)
                    lc.set_n_in(it, override=False)
                    it = lc.get_output_type(i, it)
            dev = self._net.device
            new_net = MultiLayerNetwork(new_conf).init(device=dev)
            _carry(new_net, self._net, {str(i): str(i) for i in range(min(len(layers), n_old))
                                        if i not in reinit}, dev)
            return new_net

    class GraphBuilder:
        """ComputationGraph surgery (reference ``TransferLearning.GraphBuilder``):
        freeze a subgraph, replace widths, remove and add vertices."""

        def __init__(self, net: ComputationGraph):
            self._net = net
            self._fine_tune: Optional[FineTuneConfiguration] = None
            self._frozen_at: List[str] = []
            self._n_out_replace: Dict[str, tuple] = {}
            self._removed: List[str] = []
            self._added: List[tuple] = []  # (name, layer or vertex, inputs)
            self._outputs: Optional[List[str]] = None

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._fine_tune = ftc
            return self

        fineTuneConfiguration = fine_tune_configuration

        def set_feature_extractor(self, *vertex_names):
            """Freeze the named vertices and every vertex feeding them."""
            self._frozen_at = list(vertex_names)
            return self

        setFeatureExtractor = set_feature_extractor

        def n_out_replace(self, layer_name: str, n_out: int, weight_init: Optional[str] = None):
            self._n_out_replace[layer_name] = (int(n_out), weight_init)
            return self

        nOutReplace = n_out_replace

        def remove_vertex_and_connections(self, name: str):
            self._removed.append(name)
            return self

        removeVertexAndConnections = remove_vertex_and_connections

        def add_layer(self, name: str, layer: Layer, *inputs):
            self._added.append((name, layer, list(inputs)))
            return self

        addLayer = add_layer

        def add_vertex(self, name: str, vertex, *inputs):
            self._added.append((name, vertex, list(inputs)))
            return self

        addVertex = add_vertex

        def set_outputs(self, *names):
            self._outputs = list(names)
            return self

        setOutputs = set_outputs

        def build(self) -> ComputationGraph:
            old_conf = self._net.conf
            gc = old_conf.global_conf
            if self._fine_tune is not None:
                gc = self._fine_tune.apply_to(gc)
            vertices = {k: copy.deepcopy(v) for k, v in old_conf.vertices.items()}
            vertex_inputs = {k: list(v) for k, v in old_conf.vertex_inputs.items()}
            outputs = list(self._outputs if self._outputs is not None
                           else old_conf.network_outputs)
            for name in self._removed:
                vertices.pop(name, None)
                vertex_inputs.pop(name, None)
                if name in outputs:
                    outputs.remove(name)
            reinit = set()
            for name, layer, inputs in self._added:
                ins = list(inputs)
                if len(ins) > 1 and isinstance(layer, Layer):
                    merge = f"{name}-merge"
                    vertices[merge] = MergeVertex()
                    vertex_inputs[merge] = ins
                    ins = [merge]
                vertices[name] = copy.deepcopy(layer)
                vertex_inputs[name] = ins
                reinit.add(name)
            consumers: Dict[str, List[str]] = {}
            for v, ins in vertex_inputs.items():
                for i in ins:
                    consumers.setdefault(i, []).append(v)
            for name, (n_out, w_init) in self._n_out_replace.items():
                inner = _inner(vertices.get(name))
                if not isinstance(inner, FeedForwardLayer):
                    raise ValueError(f"nOutReplace on '{name}' ({type(inner).__name__}): "
                                     f"not a FeedForwardLayer")
                inner.n_out = n_out
                if w_init is not None:
                    inner.weight_init = w_init
                reinit.add(name)
                # the consumers (through vertices that are not layers, such
                # as a MergeVertex) get their nIn inferred anew
                stack = list(consumers.get(name, []))
                while stack:
                    c = stack.pop()
                    cv = vertices.get(c)
                    if isinstance(_inner(cv), FeedForwardLayer):
                        _inner(cv).n_in = None
                        reinit.add(c)
                    elif not isinstance(cv, Layer):
                        stack.extend(consumers.get(c, []))
            if self._frozen_at:
                for n in _frozen_closure(self._frozen_at, vertices, vertex_inputs):
                    if isinstance(vertices[n], Layer) and not isinstance(vertices[n], FrozenLayer):
                        vertices[n] = FrozenLayer(inner=vertices[n])
            new_conf = ComputationGraphConfiguration(
                global_conf=gc, network_inputs=list(old_conf.network_inputs),
                network_outputs=outputs, vertices=vertices, vertex_inputs=vertex_inputs,
                input_preprocessors={k: v for k, v in old_conf.input_preprocessors.items()
                                     if k in vertices},
                input_types=old_conf.input_types, backprop_type=old_conf.backprop_type,
                tbptt_fwd_length=old_conf.tbptt_fwd_length,
                tbptt_back_length=old_conf.tbptt_back_length)
            new_conf.infer_shapes()
            dev = self._net.device
            new_net = ComputationGraph(new_conf).init(device=dev)
            _carry(new_net, self._net, {n: n for n in new_net.impls
                                        if n in old_conf.vertices and n not in reinit}, dev)
            return new_net


class GraphTransferLearningHelper:
    """The featurization helper of a ComputationGraph (reference
    ``TransferLearningHelper(ComputationGraph, String... frozenOutputAt)``):
    the frozen subgraph is every vertex feeding the named boundary
    vertices, and the rest trains as a graph whose inputs are the boundary
    activations (and the network inputs it reads)."""

    def __init__(self, net: ComputationGraph, *frozen_output_at: str):
        if not frozen_output_at:
            raise ValueError("Name at least one frozen boundary vertex")
        self.orig = net
        conf = net.conf
        self.frozen = _frozen_closure(frozen_output_at, conf.vertices, conf.vertex_inputs)
        for out in conf.network_outputs:
            if out in self.frozen:
                raise ValueError(f"Output '{out}' is inside the frozen subgraph")
        tail_vertices = {n: copy.deepcopy(v) for n, v in conf.vertices.items()
                         if n not in self.frozen}
        tail_inputs: List[str] = []
        for n in tail_vertices:
            for i in conf.vertex_inputs[n]:
                if (i in self.frozen or i in conf.network_inputs) and i not in tail_inputs:
                    tail_inputs.append(i)
        self.boundary = tail_inputs     # featurize() emits these, in order
        tail_conf = ComputationGraphConfiguration(
            global_conf=conf.global_conf, network_inputs=tail_inputs,
            network_outputs=list(conf.network_outputs), vertices=tail_vertices,
            vertex_inputs={n: list(conf.vertex_inputs[n]) for n in tail_vertices},
            input_preprocessors={k: v for k, v in conf.input_preprocessors.items()
                                 if k in tail_vertices},
            input_types=None, backprop_type=conf.backprop_type,
            tbptt_fwd_length=conf.tbptt_fwd_length, tbptt_back_length=conf.tbptt_back_length)
        self.tail = ComputationGraph(tail_conf)
        layer_names = [n for n, v in tail_vertices.items() if isinstance(v, Layer)]
        self.tail.init(params={n: net.params[n] for n in layer_names}, device=net.device,
                       states={n: net.states[n] for n in layer_names})

    def featurize(self, ds):
        """The frozen subgraph run once: a MultiDataSet whose features are
        the boundary activations (host arrays) in the tail's input order."""
        if isinstance(ds, DataSet):
            ds = MultiDataSet([ds.features], [ds.labels],
                              None if ds.features_mask is None else [ds.features_mask],
                              None if ds.labels_mask is None else [ds.labels_mask])
        acts = self.orig.feed_forward(*ds.features, train=False)
        inputs = self.orig.conf.network_inputs
        feats = [ds.features[inputs.index(n)] if n in inputs else _host(acts[n])
                 for n in self.boundary]
        return MultiDataSet(feats, list(ds.labels), ds.features_masks, ds.labels_masks)

    def fit_featurized(self, mds):
        self.tail.fit(mds)
        return self

    fitFeaturized = fit_featurized

    def output_from_featurized(self, *features):
        return self.tail.output(*features)

    outputFromFeaturized = output_from_featurized

    def unfrozen_graph(self) -> ComputationGraph:
        return self.tail

    unfrozenGraph = unfrozen_graph


class TransferLearningHelper:
    """Featurize once through the frozen layers [0, frozen_till], then
    train only the rest as a network of its own (reference
    ``TransferLearningHelper.java``). Given a ComputationGraph and boundary
    vertex names it is a :class:`GraphTransferLearningHelper`."""

    def __new__(cls, net, frozen_till, *more):
        if not isinstance(net, MultiLayerNetwork):
            return GraphTransferLearningHelper(net, frozen_till, *more)
        return super().__new__(cls)

    def __init__(self, net: MultiLayerNetwork, frozen_till: int):
        self.orig = net
        self.frozen_till = int(frozen_till)
        conf = net.conf
        first = self.frozen_till + 1
        tail_layers = [copy.deepcopy(l) for l in conf.layers[first:]]
        tail_conf = MultiLayerConfiguration(
            global_conf=conf.global_conf, layers=tail_layers,
            input_preprocessors={str(int(k) - first): v
                                 for k, v in conf.input_preprocessors.items() if int(k) >= first},
            input_type=None, backprop=conf.backprop, pretrain=False,
            backprop_type=conf.backprop_type, tbptt_fwd_length=conf.tbptt_fwd_length,
            tbptt_back_length=conf.tbptt_back_length)
        keys = {str(i): str(i + first) for i in range(len(tail_layers))}
        self.tail = MultiLayerNetwork(tail_conf).init(
            params={k: net.params[s] for k, s in keys.items()}, device=net.device,
            states={k: net.states[s] for k, s in keys.items()})

    def featurize(self, ds: DataSet) -> DataSet:
        """The activations of layer ``frozen_till`` (a host array) with
        the set's labels and masks."""
        acts = self.orig.feed_forward_to_layer(self.frozen_till, ds.features)
        return DataSet(_host(acts), ds.labels, features_mask=ds.features_mask,
                       labels_mask=ds.labels_mask)

    def fit_featurized(self, ds: DataSet):
        self.tail.fit(ds)
        return self

    fitFeaturized = fit_featurized

    def output_from_featurized(self, features):
        return self.tail.output(features)

    outputFromFeaturized = output_from_featurized

    def unfrozen_mln(self) -> MultiLayerNetwork:
        return self.tail

    unfrozenMLN = unfrozen_mln
