"""Configuration DSL: fluent builder -> serializable network configurations.

Counterpart of ``deeplearning4j_tpu/nn/conf/__init__.py``. Global settings
live once in :class:`GlobalConfig` and per-layer configs override them,
resolved at network init. ``dtype``/``compute_dtype`` are the
mixed-precision policy (f32 parameters, bf16 matmul operands). Updaters and
learning-rate schedules decode to the classes of ``nn/updaters.py``;
weight-distribution configs are carried as data (:class:`serde.PlainConfig`)
so that JSON written by the JAX package decodes.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional

from . import serde
from .serde import register, to_json, from_json
from .inputs import InputType
from .layers import Layer
from .graph import ComputationGraphConfiguration, GraphBuilder

from ..updaters import SCHEDULES, UPDATERS, Sgd

__all__ = ["GlobalConfig", "MultiLayerConfiguration", "ComputationGraphConfiguration",
           "ListBuilder", "GraphBuilder", "Builder", "NeuralNetConfiguration", "InputType",
           "GradientNormalization", "BackpropType", "CacheMode"]

for _cls in (*UPDATERS.values(), *SCHEDULES.values()):
    register(_cls)

serde.register_plain(
    # weight-init distributions (deeplearning4j_tpu/nn/weights.py)
    "NormalDistribution", "GaussianDistribution", "UniformDistribution",
    "ConstantDistribution", "BinomialDistribution")


class GradientNormalization:
    """Reference ``nn/conf/GradientNormalization.java``."""
    None_ = "none"
    RenormalizeL2PerLayer = "renormalize_l2_per_layer"
    RenormalizeL2PerParamType = "renormalize_l2_per_param_type"
    ClipElementWiseAbsoluteValue = "clip_elementwise_absolute_value"
    ClipL2PerLayer = "clip_l2_per_layer"
    ClipL2PerParamType = "clip_l2_per_param_type"


class BackpropType:
    Standard = "standard"
    TruncatedBPTT = "tbptt"


class CacheMode:
    """Reference ``nn/conf/CacheMode.java``: ``DEVICE`` keeps each fitted
    DataSet's arrays on the device (``DataSet.device_arrays``)."""
    NONE = "none"
    DEVICE = "device"
    HOST = "host"


@register
@dataclasses.dataclass
class GlobalConfig:
    """Defaults applied to every layer unless overridden per-layer. The
    field set is the JAX package's, so its JSON decodes unchanged."""
    seed: int = 12345
    updater: Any = None                      # IUpdater; Sgd(1e-1) if unset
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
    cache_mode: str = CacheMode.NONE


@register
@dataclasses.dataclass
class MultiLayerConfiguration:
    global_conf: GlobalConfig = None
    layers: List[Any] = dataclasses.field(default_factory=list)
    input_preprocessors: Dict[str, Any] = dataclasses.field(default_factory=dict)
    input_type: Any = None
    backprop: bool = True
    pretrain: bool = False
    backprop_type: str = BackpropType.Standard
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
        self._backprop_type = BackpropType.Standard
        self._tbptt_fwd = 20
        self._tbptt_back = 20

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

    def backprop_type(self, t) -> "ListBuilder":
        self._backprop_type = t
        return self

    backpropType = backprop_type

    def t_bptt_forward_length(self, n) -> "ListBuilder":
        self._tbptt_fwd = int(n)
        return self

    tBPTTForwardLength = t_bptt_forward_length

    def t_bptt_backward_length(self, n) -> "ListBuilder":
        self._tbptt_back = int(n)
        return self

    tBPTTBackwardLength = t_bptt_backward_length

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
                                       input_type=self._input_type,
                                       backprop_type=self._backprop_type,
                                       tbptt_fwd_length=self._tbptt_fwd,
                                       tbptt_back_length=self._tbptt_back)


class Builder:
    """Fluent global-config builder (snake_case and reference camelCase)."""

    def __init__(self):
        self._conf = GlobalConfig()

    def _set(self, field, value):
        setattr(self._conf, field, value)
        return self

    def seed(self, s):
        return self._set("seed", int(s))

    def iterations(self, n):
        """n optimizer iterations per minibatch (TBPTT segment)."""
        return self._set("iterations", int(n))

    def updater(self, u):
        return self._set("updater", u)

    def l1(self, v):
        return self._set("l1", float(v))

    def l2(self, v):
        return self._set("l2", float(v))

    def l1_bias(self, v):
        return self._set("l1_bias", float(v))

    def l2_bias(self, v):
        return self._set("l2_bias", float(v))

    def minimize(self, flag=True):
        return self._set("minimize", bool(flag))

    def gradient_normalization(self, g):
        return self._set("gradient_normalization", g)

    gradientNormalization = gradient_normalization

    def gradient_normalization_threshold(self, t):
        return self._set("gradient_normalization_threshold", float(t))

    gradientNormalizationThreshold = gradient_normalization_threshold

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

    def cache_mode(self, m):
        return self._set("cache_mode", m)

    cacheMode = cache_mode

    def _with_default_updater(self) -> GlobalConfig:
        if self._conf.updater is None:
            self._conf.updater = Sgd(learning_rate=1e-1)
        return copy.deepcopy(self._conf)

    def list(self) -> ListBuilder:
        return ListBuilder(self._with_default_updater())

    def graph_builder(self) -> GraphBuilder:
        return GraphBuilder(self._with_default_updater())

    graphBuilder = graph_builder

    def build(self) -> GlobalConfig:
        return self._with_default_updater()


class NeuralNetConfiguration:
    """Entry point: ``NeuralNetConfiguration.builder()``."""

    Builder = Builder

    @staticmethod
    def builder() -> Builder:
        return Builder()
