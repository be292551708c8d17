"""Configuration DSL: fluent builder -> serializable network configurations.

Counterpart of ``deeplearning4j_tpu/nn/conf/__init__.py``. Global settings
live once in :class:`GlobalConfig` and per-layer configs override them,
resolved at network init. ``dtype``/``compute_dtype`` are the
mixed-precision policy (f32 parameters, bf16 matmul operands). Updater and
weight-distribution configs are carried as data (:class:`serde.PlainConfig`)
so that JSON written by the JAX package decodes; the port serves and does
not train yet.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional

from . import serde
from .serde import register, to_json, from_json
from .inputs import InputType
from .layers import Layer

__all__ = ["GlobalConfig", "MultiLayerConfiguration", "ListBuilder",
           "Builder", "NeuralNetConfiguration", "InputType"]

serde.register_plain(
    # updaters (deeplearning4j_tpu/nn/updaters.py)
    "Sgd", "Adam", "AdaMax", "Nadam", "Nesterovs", "RmsProp", "AdaGrad",
    "AdaDelta", "NoOp", "AMSGrad",
    # learning-rate schedules
    "FixedSchedule", "ExponentialSchedule", "InverseSchedule", "PolySchedule",
    "SigmoidSchedule", "StepSchedule", "MapSchedule", "WarmupCosineSchedule",
    # weight-init distributions (deeplearning4j_tpu/nn/weights.py)
    "NormalDistribution", "GaussianDistribution", "UniformDistribution",
    "ConstantDistribution", "BinomialDistribution")


@register
@dataclasses.dataclass
class GlobalConfig:
    """Defaults applied to every layer unless overridden per-layer. The
    field set is the JAX package's, so its JSON decodes unchanged."""
    seed: int = 12345
    updater: Any = None
    weight_init: str = "xavier"
    dist: Any = None
    activation: str = "sigmoid"
    bias_init: float = 0.0
    l1: float = 0.0
    l2: float = 0.0
    l1_bias: float = 0.0
    l2_bias: float = 0.0
    dropout: Optional[float] = None          # retain prob, reference semantics
    optimization_algo: str = "sgd"
    minimize: bool = True
    max_num_line_search_iterations: int = 5
    gradient_normalization: str = "none"
    gradient_normalization_threshold: float = 1.0
    mini_batch: bool = True
    dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: str = "off"
    iterations: int = 1
    training_workspace_mode: str = "enabled"
    inference_workspace_mode: str = "enabled"
    cache_mode: str = "none"


@register
@dataclasses.dataclass
class MultiLayerConfiguration:
    global_conf: GlobalConfig = None
    layers: List[Any] = dataclasses.field(default_factory=list)
    input_preprocessors: Dict[str, Any] = dataclasses.field(default_factory=dict)
    input_type: Any = None
    backprop: bool = True
    pretrain: bool = False
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20

    def to_json(self) -> str:
        return to_json(self)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        obj = from_json(s)
        if not isinstance(obj, MultiLayerConfiguration):
            raise ValueError("JSON does not describe a MultiLayerConfiguration")
        return obj


class ListBuilder:
    """Collects layers; ``set_input_type`` runs shape inference (n_in
    filling) and ``build`` emits a :class:`MultiLayerConfiguration`."""

    def __init__(self, global_conf: GlobalConfig):
        self._global = global_conf
        self._layers: List[Layer] = []
        self._input_type = None

    def layer(self, idx_or_layer, layer=None) -> "ListBuilder":
        if layer is None:
            self._layers.append(idx_or_layer)
        else:
            idx = int(idx_or_layer)
            while len(self._layers) <= idx:
                self._layers.append(None)
            self._layers[idx] = layer
        return self

    def set_input_type(self, input_type) -> "ListBuilder":
        self._input_type = input_type
        return self

    setInputType = set_input_type

    def build(self) -> MultiLayerConfiguration:
        layers = list(self._layers)
        if any(l is None for l in layers):
            raise ValueError("Gaps in layer list (indexed .layer(i, ...) left holes)")
        if self._input_type is not None:
            it = self._input_type
            for i, layer in enumerate(layers):
                layer.preprocessor_for(it)
                layer.set_n_in(it, override=False)
                it = layer.get_output_type(i, it)
        return MultiLayerConfiguration(global_conf=self._global, layers=layers,
                                       input_type=self._input_type)


class Builder:
    """Fluent global-config builder (snake_case and reference camelCase)."""

    def __init__(self):
        self._conf = GlobalConfig()

    def _set(self, field, value):
        setattr(self._conf, field, value)
        return self

    def seed(self, s):
        return self._set("seed", int(s))

    def updater(self, u):
        return self._set("updater", u)

    def weight_init(self, w):
        return self._set("weight_init", w)

    weightInit = weight_init

    def dist(self, d):
        self._conf.dist = d
        return self._set("weight_init", "distribution")

    def activation(self, a):
        return self._set("activation", a)

    def bias_init(self, b):
        return self._set("bias_init", float(b))

    biasInit = bias_init

    def drop_out(self, p):
        return self._set("dropout", float(p))

    dropOut = drop_out

    def dtype(self, d):
        return self._set("dtype", str(d))

    def compute_dtype(self, d):
        return self._set("compute_dtype", str(d))

    def list(self) -> ListBuilder:
        return ListBuilder(copy.deepcopy(self._conf))

    def build(self) -> GlobalConfig:
        return copy.deepcopy(self._conf)


class NeuralNetConfiguration:
    """Entry point: ``NeuralNetConfiguration.builder()``."""

    Builder = Builder

    @staticmethod
    def builder() -> Builder:
        return Builder()
