"""ComputationGraph configuration: a DAG of layers and vertices.

Counterpart of ``deeplearning4j_tpu/nn/conf/graph.py``: the fourteen
vertex config classes, :class:`ComputationGraphConfiguration` (topological
order, shape inference, JSON) and :class:`GraphBuilder`. A vertex is one
serializable dataclass whose ``forward(inputs, ctx)`` is a torch function
(autograd derives its backward), with ``n_inputs``, ``propagate_mask`` and
``get_output_type``. ``ctx["inputs"]`` and ``ctx["input_masks"]`` hold the
forward's activations and masks by name, network inputs included.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional

import torch

from .serde import register, to_json, from_json
from .inputs import (InputTypeFeedForward, InputTypeRecurrent,
                     InputTypeConvolutional, InputTypeConvolutionalFlat)
from .layers import Layer

__all__ = ["GraphVertexConf", "MergeVertex", "ElementWiseVertex", "SubsetVertex",
           "StackVertex", "UnstackVertex", "ScaleVertex", "ShiftVertex",
           "L2NormalizeVertex", "L2Vertex", "PreprocessorVertex",
           "ReshapeVertex", "PoolHelperVertex", "LastTimeStepVertex",
           "DuplicateToTimeSeriesVertex", "ComputationGraphConfiguration",
           "GraphBuilder"]


@dataclasses.dataclass
class GraphVertexConf:
    """Base non-layer vertex: a function of its input activations."""

    def n_inputs(self):  # expected input arity; None = any
        return None

    def forward(self, inputs: List, ctx: Dict) -> Any:
        raise NotImplementedError

    def propagate_mask(self, in_masks: List):
        """Feature mask of this vertex's output given its inputs' masks."""
        return in_masks[0] if in_masks else None

    def get_output_type(self, input_types: List):
        return input_types[0]


@register
@dataclasses.dataclass
class MergeVertex(GraphVertexConf):
    """Concatenate along the feature (last) axis."""

    def forward(self, inputs, ctx):
        return torch.cat(inputs, dim=-1)

    def propagate_mask(self, in_masks):
        for m in in_masks:
            if m is not None:
                return m
        return None

    def get_output_type(self, input_types):
        t0 = input_types[0]
        if t0 is None:
            return None
        if isinstance(t0, InputTypeFeedForward):
            return InputTypeFeedForward(sum(t.size for t in input_types))
        if isinstance(t0, InputTypeRecurrent):
            return InputTypeRecurrent(sum(t.size for t in input_types), t0.timeseries_length)
        if isinstance(t0, InputTypeConvolutional):
            return InputTypeConvolutional(t0.height, t0.width,
                                          sum(t.channels for t in input_types))
        if isinstance(t0, InputTypeConvolutionalFlat):
            return InputTypeFeedForward(sum(t.arity() for t in input_types))
        raise ValueError(f"MergeVertex: unsupported input type {type(t0).__name__}")


@register
@dataclasses.dataclass
class ElementWiseVertex(GraphVertexConf):
    """Elementwise add / subtract / product / average / max."""
    op: str = "add"

    def forward(self, inputs, ctx):
        op = self.op.lower()
        if op in ("add", "average"):
            out = inputs[0]
            for x in inputs[1:]:
                out = out + x
            return out / len(inputs) if op == "average" else out
        if op == "subtract":
            if len(inputs) != 2:
                raise ValueError("subtract needs exactly 2 inputs")
            return inputs[0] - inputs[1]
        if op == "product":
            out = inputs[0]
            for x in inputs[1:]:
                out = out * x
            return out
        if op == "max":
            out = inputs[0]
            for x in inputs[1:]:
                out = torch.maximum(out, x)
            return out
        raise ValueError(f"Unknown ElementWiseVertex op '{self.op}'")


@register
@dataclasses.dataclass
class SubsetVertex(GraphVertexConf):
    """Features [from_idx, to_idx], both ends included (reference
    ``SubsetVertex``)."""
    from_idx: int = 0
    to_idx: int = 0

    def n_inputs(self):
        return 1

    def forward(self, inputs, ctx):
        return inputs[0][..., self.from_idx:self.to_idx + 1]

    def get_output_type(self, input_types):
        t = input_types[0]
        n = self.to_idx - self.from_idx + 1
        if isinstance(t, InputTypeRecurrent):
            return InputTypeRecurrent(n, t.timeseries_length)
        if isinstance(t, InputTypeConvolutional):
            return InputTypeConvolutional(t.height, t.width, n)
        return InputTypeFeedForward(n)


@register
@dataclasses.dataclass
class StackVertex(GraphVertexConf):
    """Concatenate along the minibatch axis (reference ``StackVertex``)."""

    def forward(self, inputs, ctx):
        return torch.cat(inputs, dim=0)

    def propagate_mask(self, in_masks):
        if all(m is None for m in in_masks):
            return None
        if any(m is None for m in in_masks):
            raise ValueError("StackVertex: either all or no inputs must have feature masks")
        return torch.cat(in_masks, dim=0)


@register
@dataclasses.dataclass
class UnstackVertex(GraphVertexConf):
    """Chunk ``from_idx`` of ``stack_size`` equal minibatch chunks: the
    inverse of StackVertex (reference ``UnstackVertex``)."""
    from_idx: int = 0
    stack_size: int = 1

    def n_inputs(self):
        return 1

    def _chunk(self, x):
        step = x.shape[0] // self.stack_size
        return x[self.from_idx * step:(self.from_idx + 1) * step]

    def forward(self, inputs, ctx):
        return self._chunk(inputs[0])

    def propagate_mask(self, in_masks):
        return None if in_masks[0] is None else self._chunk(in_masks[0])


@register
@dataclasses.dataclass
class ScaleVertex(GraphVertexConf):
    scale: float = 1.0

    def n_inputs(self):
        return 1

    def forward(self, inputs, ctx):
        return inputs[0] * self.scale


@register
@dataclasses.dataclass
class ShiftVertex(GraphVertexConf):
    shift: float = 0.0

    def n_inputs(self):
        return 1

    def forward(self, inputs, ctx):
        return inputs[0] + self.shift


@register
@dataclasses.dataclass
class L2NormalizeVertex(GraphVertexConf):
    """x / (||x||_2 + eps) over every axis but the minibatch's (reference
    ``L2NormalizeVertex``)."""
    eps: float = 1e-8

    def n_inputs(self):
        return 1

    def forward(self, inputs, ctx):
        x = inputs[0]
        norm = (x * x).sum(dim=tuple(range(1, x.dim())), keepdim=True).sqrt()
        return x / (norm + self.eps)


@register
@dataclasses.dataclass
class L2Vertex(GraphVertexConf):
    """Euclidean distance between two activations, example by example ->
    [b, 1] (reference ``L2Vertex``)."""
    eps: float = 1e-8

    def n_inputs(self):
        return 2

    def forward(self, inputs, ctx):
        d = inputs[0] - inputs[1]
        return ((d * d).sum(dim=tuple(range(1, d.dim()))) + self.eps).sqrt()[:, None]

    def get_output_type(self, input_types):
        return InputTypeFeedForward(1)


@register
@dataclasses.dataclass
class PreprocessorVertex(GraphVertexConf):
    """An input preprocessor as a vertex of its own (reference
    ``PreprocessorVertex``)."""
    preprocessor: Any = None

    def n_inputs(self):
        return 1

    def forward(self, inputs, ctx):
        return self.preprocessor(inputs[0], ctx)

    def get_output_type(self, input_types):
        return self.preprocessor.get_output_type(input_types[0])


@register
@dataclasses.dataclass
class ReshapeVertex(GraphVertexConf):
    """Reshape to ``shape`` (-1 for the minibatch keeps it; reference
    ``ReshapeVertex``)."""
    shape: Any = None

    def n_inputs(self):
        return 1

    def forward(self, inputs, ctx):
        return inputs[0].reshape(tuple(self.shape))


@register
@dataclasses.dataclass
class PoolHelperVertex(GraphVertexConf):
    """Drops the first row and column of an NHWC activation, the
    reference's shim for badly padded imported GoogLeNet models
    (``PoolHelperVertex``)."""

    def n_inputs(self):
        return 1

    def forward(self, inputs, ctx):
        return inputs[0][:, 1:, 1:, :]

    def get_output_type(self, input_types):
        t = input_types[0]
        return InputTypeConvolutional(t.height - 1, t.width - 1, t.channels)


@register
@dataclasses.dataclass
class LastTimeStepVertex(GraphVertexConf):
    """[b, T, s] -> [b, s]: each example's last unmasked step, by the mask
    of the network input named ``mask_input`` (the last step without one;
    reference ``rnn/LastTimeStepVertex``)."""
    mask_input: Optional[str] = None

    def n_inputs(self):
        return 1

    def forward(self, inputs, ctx):
        x = inputs[0]
        mask = (ctx or {}).get("input_masks", {}).get(self.mask_input)
        if mask is None:
            return x[:, -1, :]
        last = ((mask > 0).sum(dim=1) - 1).clamp(min=0)
        return x[torch.arange(x.shape[0], device=x.device), last]

    def propagate_mask(self, in_masks):
        return None     # the time axis is gone

    def get_output_type(self, input_types):
        t = input_types[0]
        return InputTypeFeedForward(t.size if isinstance(t, InputTypeRecurrent) else t.arity())


@register
@dataclasses.dataclass
class DuplicateToTimeSeriesVertex(GraphVertexConf):
    """[b, s] -> [b, T, s], T the time length of the network input named
    ``reference_input`` (under truncated BPTT, the segment's; reference
    ``rnn/DuplicateToTimeSeriesVertex``)."""
    reference_input: Optional[str] = None

    def n_inputs(self):
        return 1

    def forward(self, inputs, ctx):
        x = inputs[0]
        ref = (ctx or {}).get("inputs", {}).get(self.reference_input)
        if ref is None:
            raise ValueError(f"DuplicateToTimeSeriesVertex: reference input "
                             f"'{self.reference_input}' not found")
        return x[:, None, :].expand(x.shape[0], ref.shape[1], x.shape[1])

    def get_output_type(self, input_types):
        return InputTypeRecurrent(input_types[0].arity())


# ---------------------------------------------------------------------------


@register
@dataclasses.dataclass
class ComputationGraphConfiguration:
    """``vertices`` maps name -> Layer or GraphVertexConf; ``vertex_inputs``
    maps name -> input names (network inputs or other vertices). The field
    set and order are the JAX package's."""
    global_conf: Any = None
    network_inputs: List[str] = dataclasses.field(default_factory=list)
    network_outputs: List[str] = dataclasses.field(default_factory=list)
    vertices: Dict[str, Any] = dataclasses.field(default_factory=dict)
    vertex_inputs: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    input_preprocessors: Dict[str, Any] = dataclasses.field(default_factory=dict)
    input_types: Optional[List[Any]] = None
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20

    def topological_order(self) -> List[str]:
        """Kahn topological sort of vertex names, ties broken by name."""
        indeg = {}
        children = {n: [] for n in self.vertices}
        for name, ins in self.vertex_inputs.items():
            indeg[name] = 0
            for i in ins:
                if i in self.vertices:
                    indeg[name] += 1
                    children[i].append(name)
                elif i not in self.network_inputs:
                    raise ValueError(f"Vertex '{name}' input '{i}' is neither a "
                                     f"vertex nor a network input")
        ready = sorted(n for n in self.vertices if indeg.get(n, 0) == 0)
        order = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for ch in children[n]:
                indeg[ch] -= 1
                if indeg[ch] == 0:
                    ready.append(ch)
        if len(order) != len(self.vertices):
            cyc = set(self.vertices) - set(order)
            raise ValueError(f"Cycle in computation graph involving {sorted(cyc)}")
        return order

    def infer_shapes(self) -> Dict[str, Any]:
        """Propagate input types over the DAG: check vertex arity, record
        each layer's preprocessor in ``input_preprocessors`` (by vertex
        name), fill ``n_in``. Returns {vertex name -> InputType or None}."""
        types: Dict[str, Any] = {}
        if self.input_types is not None:
            if len(self.input_types) != len(self.network_inputs):
                raise ValueError(f"{len(self.network_inputs)} inputs but "
                                 f"{len(self.input_types)} input types")
            types.update(zip(self.network_inputs, self.input_types))
        for name in self.topological_order():
            v = self.vertices[name]
            in_types = [types.get(i) for i in self.vertex_inputs[name]]
            if isinstance(v, Layer):
                it = in_types[0] if in_types else None
                if it is None:
                    types[name] = None
                    continue
                if name not in self.input_preprocessors:
                    p = v.preprocessor_for(it)
                    if p is not None:
                        self.input_preprocessors[name] = p
                if name in self.input_preprocessors:
                    it = self.input_preprocessors[name].get_output_type(it)
                v.set_n_in(it, override=False)
                types[name] = v.get_output_type(0, it)
            else:
                exp = v.n_inputs()
                if exp is not None and len(self.vertex_inputs[name]) != exp:
                    raise ValueError(f"Vertex '{name}' expects {exp} inputs, "
                                     f"got {len(self.vertex_inputs[name])}")
                types[name] = (None if any(t is None for t in in_types)
                               else v.get_output_type(in_types))
        return types

    def to_json(self) -> str:
        return to_json(self)

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        obj = from_json(s)
        if not isinstance(obj, ComputationGraphConfiguration):
            raise ValueError("JSON does not describe a ComputationGraphConfiguration")
        return obj

    def clone(self):
        return copy.deepcopy(self)


class GraphBuilder:
    """``add_inputs`` / ``add_layer`` / ``add_vertex`` / ``set_outputs`` /
    ``set_input_types`` / ``build`` (and the reference camelCase names)."""

    def __init__(self, global_conf):
        self._global = global_conf
        self._inputs: List[str] = []
        self._outputs: List[str] = []
        self._vertices: Dict[str, Any] = {}
        self._vertex_inputs: Dict[str, List[str]] = {}
        self._preprocessors: Dict[str, Any] = {}
        self._input_types = None
        self._backprop_type = "standard"
        self._tbptt_fwd = 20
        self._tbptt_back = 20

    def add_inputs(self, *names) -> "GraphBuilder":
        for n in names:
            if n in self._inputs or n in self._vertices:
                raise ValueError(f"Duplicate input name '{n}'")
            self._inputs.append(n)
        return self

    addInputs = add_inputs

    def _check_name(self, name):
        if name in self._vertices:
            raise ValueError(f"Duplicate vertex name '{name}'")
        if name in self._inputs:
            raise ValueError(f"Vertex name '{name}' collides with a network input")

    def add_layer(self, name, layer, *inputs, preprocessor=None) -> "GraphBuilder":
        self._check_name(name)
        ins = list(inputs)
        if len(ins) > 1:
            # a layer with several inputs gets a MergeVertex in front
            merge_name = f"{name}-merge"
            self._vertices[merge_name] = MergeVertex()
            self._vertex_inputs[merge_name] = ins
            ins = [merge_name]
        self._vertices[name] = layer
        self._vertex_inputs[name] = ins
        if preprocessor is not None:
            self._preprocessors[name] = preprocessor
        return self

    addLayer = add_layer

    def add_vertex(self, name, vertex, *inputs) -> "GraphBuilder":
        self._check_name(name)
        self._vertices[name] = vertex
        self._vertex_inputs[name] = list(inputs)
        return self

    addVertex = add_vertex

    def set_outputs(self, *names) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    setOutputs = set_outputs

    def set_input_types(self, *types) -> "GraphBuilder":
        self._input_types = list(types)
        return self

    setInputTypes = set_input_types

    def input_preprocessor(self, layer_name, preproc) -> "GraphBuilder":
        """An explicit input preprocessor for a layer vertex (shape
        inference inserts none there)."""
        self._preprocessors[layer_name] = preproc
        return self

    inputPreProcessor = input_preprocessor

    def backprop_type(self, t) -> "GraphBuilder":
        self._backprop_type = t
        return self

    backpropType = backprop_type

    def t_bptt_forward_length(self, n) -> "GraphBuilder":
        self._tbptt_fwd = int(n)
        return self

    tBPTTForwardLength = t_bptt_forward_length

    def t_bptt_backward_length(self, n) -> "GraphBuilder":
        self._tbptt_back = int(n)
        return self

    tBPTTBackwardLength = t_bptt_backward_length

    def build(self) -> ComputationGraphConfiguration:
        if not self._inputs:
            raise ValueError("GraphBuilder: no network inputs (addInputs)")
        if not self._outputs:
            raise ValueError("GraphBuilder: no network outputs (setOutputs)")
        for out in self._outputs:
            if out not in self._vertices:
                raise ValueError(f"Output '{out}' is not a vertex")
        conf = ComputationGraphConfiguration(
            global_conf=self._global,
            network_inputs=list(self._inputs),
            network_outputs=list(self._outputs),
            vertices=dict(self._vertices),
            vertex_inputs=dict(self._vertex_inputs),
            input_preprocessors=dict(self._preprocessors),
            input_types=self._input_types,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
        )
        conf.infer_shapes()
        return conf
