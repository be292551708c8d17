"""Layer configuration classes.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers.py``, holding only the
classes the ported slices run (the char-RNN's and the TransformerLM's).
Field names and order are unchanged so JSON written by the JAX package
decodes here and re-encodes byte for byte; any other layer ``@class``
fails to decode with the "Unknown config class" error.

Note on dropout: following the reference's 0.9.x semantics, ``dropout`` is
the **retain probability** (1.0 = keep everything / disabled).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

from .serde import register
from .inputs import InputTypeFeedForward, InputTypeRecurrent

__all__ = ["Layer", "BaseLayer", "FeedForwardLayer", "DenseLayer", "LayerNormalization",
           "EmbeddingSequenceLayer", "LSTM", "GravesLSTM", "SelfAttentionLayer", "OutputLayer",
           "RnnOutputLayer"]


@register
@dataclasses.dataclass
class Layer:
    """Base config: fields shared by every layer."""
    name: Optional[str] = None
    dropout: Optional[float] = None  # retain probability, reference semantics

    # shape inference hooks -------------------------------------------------
    def get_output_type(self, index, input_type):
        return input_type

    def set_n_in(self, input_type, override=False):
        pass

    def preprocessor_for(self, input_type):
        return None


@register
@dataclasses.dataclass
class BaseLayer(Layer):
    """Layers with weights: activation/init/regularization/updater overrides."""
    activation: Optional[str] = None
    weight_init: Optional[str] = None
    dist: Optional[Any] = None
    bias_init: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    l1_bias: Optional[float] = None
    l2_bias: Optional[float] = None
    updater: Optional[Any] = None  # per-layer updater override
    weight_noise: Optional[Any] = None
    constraints: Optional[List[Any]] = None


@register
@dataclasses.dataclass
class FeedForwardLayer(BaseLayer):
    """Has nIn/nOut."""
    n_in: Optional[int] = None
    n_out: Optional[int] = None

    def get_output_type(self, index, input_type):
        return InputTypeFeedForward(self.n_out)

    def set_n_in(self, input_type, override=False):
        if self.n_in is None or override:
            self.n_in = input_type.arity()

    def preprocessor_for(self, input_type):
        if not isinstance(input_type, InputTypeFeedForward):
            raise ValueError(
                f"{type(self).__name__} after {type(input_type).__name__} "
                f"needs an input preprocessor, and the port has none yet")
        return None


@register
@dataclasses.dataclass
class DenseLayer(FeedForwardLayer):
    """Fully connected layer."""
    has_bias: bool = True


@register
@dataclasses.dataclass
class LayerNormalization(FeedForwardLayer):
    """Per-token normalization over the feature dim with learned gain and
    bias; works on [b, F] and [b, T, F]."""
    eps: float = 1e-5

    def get_output_type(self, index, input_type):
        return input_type

    def set_n_in(self, input_type, override=False):
        if self.n_in is None or override:
            self.n_in = input_type.arity()
        self.n_out = self.n_in

    def preprocessor_for(self, input_type):
        return None


@register
@dataclasses.dataclass
class EmbeddingSequenceLayer(FeedForwardLayer):
    """Index sequence [b, T] -> vector sequence [b, T, nOut]."""
    has_bias: bool = False

    def get_output_type(self, index, input_type):
        t = (input_type.timeseries_length
             if isinstance(input_type, InputTypeRecurrent) else None)
        return InputTypeRecurrent(self.n_out, t)

    def preprocessor_for(self, input_type):
        # consumes [b, T] token ids: a recurrent input type describes the
        # sequence (vocab arity), never a tensor to flatten
        return None


@register
@dataclasses.dataclass
class BaseRecurrentLayer(FeedForwardLayer):
    def get_output_type(self, index, input_type):
        t = (input_type.timeseries_length
             if isinstance(input_type, InputTypeRecurrent) else None)
        return InputTypeRecurrent(self.n_out, t)

    def set_n_in(self, input_type, override=False):
        if self.n_in is None or override:
            self.n_in = input_type.size

    def preprocessor_for(self, input_type):
        if not isinstance(input_type, InputTypeRecurrent):
            raise ValueError(
                f"{type(self).__name__} after {type(input_type).__name__} "
                f"needs an input preprocessor, and the port has none yet")
        return None


@register
@dataclasses.dataclass
class LSTM(BaseRecurrentLayer):
    """Standard LSTM, no peepholes."""
    forget_gate_bias_init: float = 1.0
    gate_activation: str = "sigmoid"


@register
@dataclasses.dataclass
class GravesLSTM(LSTM):
    """LSTM with peephole connections."""


@register
@dataclasses.dataclass
class SelfAttentionLayer(BaseRecurrentLayer):
    """Multi-head self-attention over a sequence [b, T, nIn] -> [b, T, nOut];
    long sequences take the flash-attention kernels (``ops/flash_attention``).
    ``stream_max_length`` is the KV-cache capacity of streaming inference,
    which is not ported yet."""
    num_heads: int = 4
    head_dim: Optional[int] = None
    causal: bool = True
    dropout_rate: float = 0.0
    stream_max_length: int = 512


@register
@dataclasses.dataclass
class OutputLayer(FeedForwardLayer):
    """Dense + loss."""
    loss: str = "mcxent"
    has_bias: bool = True


@register
@dataclasses.dataclass
class RnnOutputLayer(OutputLayer):
    """Per-timestep output over [b, T, nIn]."""

    def get_output_type(self, index, input_type):
        t = (input_type.timeseries_length
             if isinstance(input_type, InputTypeRecurrent) else None)
        return InputTypeRecurrent(self.n_out, t)

    def set_n_in(self, input_type, override=False):
        if self.n_in is None or override:
            self.n_in = input_type.size

    def preprocessor_for(self, input_type):
        return BaseRecurrentLayer.preprocessor_for(self, input_type)
