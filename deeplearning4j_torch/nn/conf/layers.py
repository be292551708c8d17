"""Layer configuration classes.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers.py``, holding only the
classes the ported slices run (the char-RNN's, the TransformerLM's and its
MoE variant's, the CNN family's and the zoo's, DropoutLayer,
CenterLossOutputLayer, the rest of the recurrent family:
GravesBidirectionalLSTM, SimpleRnn and the Bidirectional and LastTimeStep
wrappers, and the pretraining and transfer layers: EmbeddingLayer,
LossLayer, AutoEncoder, RBM, VariationalAutoencoder, Yolo2OutputLayer and
the FrozenLayer wrapper; a wrapper's ``inner`` layer encodes as a nested
object). Field names
and order are unchanged so JSON written by the JAX package decodes here
and re-encodes byte for byte; any other layer ``@class`` fails to decode
with the "Unknown config class" error.

Convolutional activations are NHWC ``[b, h, w, c]``; the 1-D layers
(Convolution1DLayer, Subsampling1DLayer, Upsampling1D, ZeroPadding1DLayer)
take recurrent input ``[b, T, c]`` and ask for no preprocessor.

Note on dropout: following the reference's 0.9.x semantics, ``dropout`` is
the **retain probability** (1.0 = keep everything / disabled), or a dropout
object of ``nn/conf/dropout.py``; ``weight_noise`` and ``constraints`` hold
that module's weight-noise and constraint objects.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Tuple

from .serde import register
from .inputs import (InputTypeConvolutional, InputTypeConvolutionalFlat,
                     InputTypeFeedForward, InputTypeRecurrent)
from .preprocessors import (CnnToFeedForwardPreProcessor, CnnToRnnPreProcessor,
                            FeedForwardToCnnPreProcessor, FeedForwardToRnnPreProcessor,
                            RnnToFeedForwardPreProcessor)

__all__ = ["Layer", "BaseLayer", "FeedForwardLayer", "DenseLayer", "MoEDenseLayer",
           "ConvolutionLayer", "Convolution1DLayer", "DepthwiseConvolution2D",
           "SeparableConvolution2D", "Deconvolution2D",
           "SubsamplingLayer", "Subsampling1DLayer", "Upsampling2D", "Upsampling1D",
           "ZeroPaddingLayer", "ZeroPadding1DLayer", "Cropping2D", "SpaceToDepthLayer",
           "PoolingType", "BatchNormalization", "LayerNormalization",
           "LocalResponseNormalization",
           "ActivationLayer", "DropoutLayer", "EmbeddingSequenceLayer", "LSTM", "GravesLSTM",
           "GravesBidirectionalLSTM", "SimpleRnn", "Bidirectional", "LastTimeStep",
           "SelfAttentionLayer", "OutputLayer", "RnnOutputLayer", "CenterLossOutputLayer",
           "GlobalPoolingLayer", "ConvolutionMode", "EmbeddingLayer", "LossLayer",
           "AutoEncoder", "RBM", "VariationalAutoencoder", "PoolingDimension",
           "Yolo2OutputLayer", "FrozenLayer"]


class ConvolutionMode:
    """Reference ``nn/conf/ConvolutionMode.java``: Strict/Truncate/Same."""
    Strict = "strict"
    Truncate = "truncate"
    Same = "same"


class PoolingType:
    MAX = "max"
    AVG = "avg"
    SUM = "sum"
    PNORM = "pnorm"


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (list, tuple)):
        if len(v) == 1:
            return (int(v[0]), int(v[0]))
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def conv_out_size(in_size, k, s, p, d, mode):
    """Output spatial size (reference ``util/ConvolutionUtils.getOutputSize``)."""
    eff_k = (k - 1) * d + 1
    if mode == ConvolutionMode.Same:
        return int(math.ceil(in_size / s))
    return (in_size - eff_k + 2 * p) // s + 1


def _conv_output_type(layer, input_type, channels):
    k, s, p, d = (_pair(layer.kernel_size), _pair(layer.stride), _pair(layer.padding),
                  _pair(layer.dilation))
    h = conv_out_size(input_type.height, k[0], s[0], p[0], d[0], layer.convolution_mode)
    w = conv_out_size(input_type.width, k[1], s[1], p[1], d[1], layer.convolution_mode)
    return InputTypeConvolutional(h, w, channels)


@register
@dataclasses.dataclass
class Layer:
    """Base config: fields shared by every layer."""
    name: Optional[str] = None
    dropout: Optional[Any] = None  # retain probability or a dropout object

    # shape inference hooks -------------------------------------------------
    def get_output_type(self, index, input_type):
        return input_type

    def set_n_in(self, input_type, override=False):
        pass

    def preprocessor_for(self, input_type):
        return None

    def is_pretrain_layer(self):
        """Whether ``MultiLayerNetwork.pretrain`` trains this layer on its
        own unsupervised loss."""
        return False


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
        if isinstance(input_type, (InputTypeConvolutional, InputTypeConvolutionalFlat)):
            return CnnToFeedForwardPreProcessor(input_type.height, input_type.width,
                                                input_type.channels)
        if isinstance(input_type, InputTypeRecurrent):
            return RnnToFeedForwardPreProcessor()
        return None


@register
@dataclasses.dataclass
class DenseLayer(FeedForwardLayer):
    """Fully connected layer."""
    has_bias: bool = True


@register
@dataclasses.dataclass
class MoEDenseLayer(FeedForwardLayer):
    """Mixture-of-experts dense layer: a softmax router over
    ``num_experts`` experts keeps each token's ``top_k`` gates
    (renormalised), each expert a dense [n_in, n_out] map. The Switch
    load-balancing loss, scaled by ``aux_loss_weight``, enters the training
    objective through the forward's ``ctx``.

    ``capacity_factor`` > 0 turns on capacity dispatch in training: within
    each group of ``group_size`` tokens an expert takes at most
    ``ceil(top_k * group_size * capacity_factor / num_experts)`` (rounded
    up to a multiple of 8) assignments, and the lowest-gate assignments
    over that are dropped (Switch semantics). Inference always routes
    exactly, through the dense combine, so ``output``, ``score`` and
    ``rnn_time_step`` agree whatever the batch's shape; 0 keeps the dense
    combine everywhere."""
    num_experts: int = 4
    top_k: int = 2
    aux_loss_weight: float = 1e-2
    has_bias: bool = True
    capacity_factor: float = 0.0
    group_size: int = 1024


@register
@dataclasses.dataclass
class ConvolutionLayer(FeedForwardLayer):
    """2-D convolution over NHWC activations. ``n_in`` = input channels,
    ``n_out`` = output channels; the kernel ``W`` is HWIO [kh, kw, cin,
    cout], as in the JAX package."""
    kernel_size: Tuple[int, int] = (5, 5)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    convolution_mode: str = ConvolutionMode.Truncate
    has_bias: bool = True

    def get_output_type(self, index, input_type):
        if not isinstance(input_type, InputTypeConvolutional):
            raise ValueError(f"ConvolutionLayer '{self.name}' needs convolutional "
                             f"input, got {input_type}")
        return _conv_output_type(self, input_type, self.n_out)

    def set_n_in(self, input_type, override=False):
        if self.n_in is None or override:
            self.n_in = input_type.channels

    def preprocessor_for(self, input_type):
        if isinstance(input_type, InputTypeConvolutionalFlat):
            return FeedForwardToCnnPreProcessor(input_type.height, input_type.width,
                                                input_type.channels)
        return None


def _recurrent_length(layer, input_type):
    """The output length of a 1-D window (kernel, stride, padding and
    dilation's first entries) over a recurrent input; None for an unknown
    length."""
    t = input_type.timeseries_length
    if t is None:
        return None
    k, s, p, d = (_pair(layer.kernel_size)[0], _pair(layer.stride)[0], _pair(layer.padding)[0],
                  _pair(layer.dilation)[0])
    return conv_out_size(t, k, s, p, d, layer.convolution_mode)


@register
@dataclasses.dataclass
class Convolution1DLayer(ConvolutionLayer):
    """1-D convolution over recurrent input [b, T, nIn] -> [b, T', nOut];
    ``W`` is HIO [k, nIn, nOut] (the first entries of the 2-D fields)."""

    def get_output_type(self, index, input_type):
        if not isinstance(input_type, InputTypeRecurrent):
            raise ValueError("Convolution1DLayer needs recurrent input")
        return InputTypeRecurrent(self.n_out, _recurrent_length(self, input_type))

    def set_n_in(self, input_type, override=False):
        if self.n_in is None or override:
            self.n_in = input_type.size

    def preprocessor_for(self, input_type):
        return None


@register
@dataclasses.dataclass
class DepthwiseConvolution2D(ConvolutionLayer):
    """Each input channel convolved with ``depth_multiplier`` kernels of
    its own: nOut = nIn x depth_multiplier, output channel j from input
    channel j // depth_multiplier; ``W`` is [kh, kw, 1, nOut]."""
    depth_multiplier: int = 1

    def set_n_in(self, input_type, override=False):
        super().set_n_in(input_type, override)
        if self.n_out is None and self.n_in is not None:
            self.n_out = self.n_in * int(self.depth_multiplier)


@register
@dataclasses.dataclass
class SeparableConvolution2D(ConvolutionLayer):
    """A depthwise convolution (``dW`` [kh, kw, 1, nIn x depth_multiplier],
    the layer's stride, padding and dilation) then a pointwise 1x1 one
    (``pW`` [1, 1, nIn x depth_multiplier, nOut]), the bias after it."""
    depth_multiplier: int = 1


@register
@dataclasses.dataclass
class Deconvolution2D(ConvolutionLayer):
    """Transposed convolution: out = s (i - 1) + (k - 1) d + 1 - 2p under
    Truncate, i x s under Same; ``W`` is HWIO [kh, kw, nIn, nOut]."""

    def get_output_type(self, index, input_type):
        k, s, p, d = (_pair(self.kernel_size), _pair(self.stride), _pair(self.padding),
                      _pair(self.dilation))
        if self.convolution_mode == ConvolutionMode.Same:
            h, w = input_type.height * s[0], input_type.width * s[1]
        else:
            h = s[0] * (input_type.height - 1) + (k[0] - 1) * d[0] + 1 - 2 * p[0]
            w = s[1] * (input_type.width - 1) + (k[1] - 1) * d[1] + 1 - 2 * p[1]
        return InputTypeConvolutional(h, w, self.n_out)


@register
@dataclasses.dataclass
class SubsamplingLayer(Layer):
    """Spatial pooling (reference ``nn/conf/layers/SubsamplingLayer.java``).
    ``dilation`` enters the output size only: the pooling itself ignores
    it, as the JAX package's does."""
    pooling_type: str = PoolingType.MAX
    kernel_size: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    convolution_mode: str = ConvolutionMode.Truncate
    pnorm: Optional[int] = None
    eps: float = 1e-8

    def get_output_type(self, index, input_type):
        if not isinstance(input_type, InputTypeConvolutional):
            raise ValueError("SubsamplingLayer needs convolutional input")
        return _conv_output_type(self, input_type, input_type.channels)


@register
@dataclasses.dataclass
class Subsampling1DLayer(SubsamplingLayer):
    """Pooling over the time axis of recurrent input [b, T, c] (the first
    entries of the 2-D fields)."""

    def get_output_type(self, index, input_type):
        if not isinstance(input_type, InputTypeRecurrent):
            raise ValueError("Subsampling1DLayer needs recurrent input")
        return InputTypeRecurrent(input_type.size, _recurrent_length(self, input_type))


@register
@dataclasses.dataclass
class Upsampling2D(Layer):
    """Nearest-neighbour upsampling by ``size`` (rows, columns)."""
    size: Tuple[int, int] = (2, 2)

    def get_output_type(self, index, input_type):
        s = _pair(self.size)
        return InputTypeConvolutional(input_type.height * s[0], input_type.width * s[1],
                                      input_type.channels)


@register
@dataclasses.dataclass
class Upsampling1D(Layer):
    """Nearest-neighbour upsampling of the time axis by ``size``."""
    size: int = 2

    def get_output_type(self, index, input_type):
        t = input_type.timeseries_length
        return InputTypeRecurrent(input_type.size, None if t is None else t * int(self.size))


@register
@dataclasses.dataclass
class ZeroPaddingLayer(Layer):
    """Zero padding [top, bottom, left, right] (two entries: (rows,
    columns) on both sides)."""
    padding: Tuple[int, int, int, int] = (0, 0, 0, 0)

    def _pads(self):
        p = list(self.padding)
        if len(p) == 2:
            p = [p[0], p[0], p[1], p[1]]
        return p

    def get_output_type(self, index, input_type):
        p = self._pads()
        return InputTypeConvolutional(input_type.height + p[0] + p[1],
                                      input_type.width + p[2] + p[3], input_type.channels)


@register
@dataclasses.dataclass
class ZeroPadding1DLayer(Layer):
    """Zero padding (before, after) of the time axis."""
    padding: Tuple[int, int] = (0, 0)

    def get_output_type(self, index, input_type):
        p = _pair(self.padding)
        t = input_type.timeseries_length
        return InputTypeRecurrent(input_type.size, None if t is None else t + p[0] + p[1])


@register
@dataclasses.dataclass
class Cropping2D(Layer):
    """Cropping [top, bottom, left, right] (two entries: (rows, columns)
    on both sides)."""
    cropping: Tuple[int, int, int, int] = (0, 0, 0, 0)

    def _crops(self):
        c = list(self.cropping)
        if len(c) == 2:
            c = [c[0], c[0], c[1], c[1]]
        return c

    def get_output_type(self, index, input_type):
        c = self._crops()
        return InputTypeConvolutional(input_type.height - c[0] - c[1],
                                      input_type.width - c[2] - c[3], input_type.channels)


@register
@dataclasses.dataclass
class SpaceToDepthLayer(Layer):
    """Each ``block_size`` x ``block_size`` block of cells to one cell of
    block_size^2 x c channels, channel (i * block_size + j) * c + ch for
    the block's cell (i, j)."""
    block_size: int = 2

    def get_output_type(self, index, input_type):
        b = int(self.block_size)
        return InputTypeConvolutional(input_type.height // b, input_type.width // b,
                                      input_type.channels * b * b)


@register
@dataclasses.dataclass
class BatchNormalization(FeedForwardLayer):
    """Reference ``nn/conf/layers/BatchNormalization.java``. ``decay`` is the
    running statistics' momentum; gamma/beta are trainable unless
    ``lock_gamma_beta``."""
    decay: float = 0.9
    eps: float = 1e-5
    gamma: float = 1.0
    beta: float = 0.0
    lock_gamma_beta: bool = False

    def get_output_type(self, index, input_type):
        return input_type

    def set_n_in(self, input_type, override=False):
        if self.n_in is None or override:
            self.n_in = (input_type.channels if isinstance(input_type, InputTypeConvolutional)
                         else input_type.arity())
        self.n_out = self.n_in

    def preprocessor_for(self, input_type):
        return None


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
class LocalResponseNormalization(Layer):
    """Across-channel LRN: x / (k + alpha * sum of x^2 over the 2 (n // 2)
    + 1 channels centred on each)^beta (alpha not divided by n)."""
    k: float = 2.0
    n: float = 5.0
    alpha: float = 1e-4
    beta: float = 0.75


@register
@dataclasses.dataclass
class ActivationLayer(BaseLayer):
    """An activation function as a layer of its own."""


@register
@dataclasses.dataclass
class DropoutLayer(FeedForwardLayer):
    """Dropout as a layer of its own (reference ``DropoutLayer``): its
    ``dropout`` on the input in training, the identity otherwise; no
    parameters, and no n_in/n_out to infer."""

    def get_output_type(self, index, input_type):
        return input_type

    def set_n_in(self, input_type, override=False):
        pass

    def preprocessor_for(self, input_type):
        return None


@register
@dataclasses.dataclass
class EmbeddingLayer(FeedForwardLayer):
    """Index -> vector, one index per example: [b] or [b, 1] indices, or a
    one-hot [b, nIn] (its argmax), -> [b, nOut] (reference
    ``EmbeddingLayer.java``)."""
    has_bias: bool = True


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
        if isinstance(input_type, InputTypeFeedForward):
            return FeedForwardToRnnPreProcessor()
        if isinstance(input_type, InputTypeConvolutional):
            return CnnToRnnPreProcessor(input_type.height, input_type.width,
                                        input_type.channels)
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
class GravesBidirectionalLSTM(GravesLSTM):
    """Two GravesLSTMs over time, forward and backward, each with its own
    parameters; their outputs are summed, so the output stays nOut wide
    (reference ``GravesBidirectionalLSTM.java``)."""


@register
@dataclasses.dataclass
class SimpleRnn(BaseRecurrentLayer):
    """``h_t = act(x_t W + h_{t-1} RW + b)``."""


@register
@dataclasses.dataclass
class Bidirectional(Layer):
    """An inner recurrent layer run in both directions; ``mode`` merges
    them: concat | add | mul | ave (reference 1.0 line
    ``Bidirectional.java``)."""
    inner: Optional[Any] = None
    mode: str = "concat"

    def get_output_type(self, index, input_type):
        out = self.inner.get_output_type(index, input_type)
        if self.mode == "concat":
            out = InputTypeRecurrent(out.size * 2, out.timeseries_length)
        return out

    def set_n_in(self, input_type, override=False):
        self.inner.set_n_in(input_type, override)

    def preprocessor_for(self, input_type):
        return self.inner.preprocessor_for(input_type)


@register
@dataclasses.dataclass
class LastTimeStep(Layer):
    """The last (mask-aware) time step of an inner recurrent layer."""
    inner: Optional[Any] = None

    def get_output_type(self, index, input_type):
        return InputTypeFeedForward(self.inner.get_output_type(index, input_type).size)

    def set_n_in(self, input_type, override=False):
        self.inner.set_n_in(input_type, override)

    def preprocessor_for(self, input_type):
        return self.inner.preprocessor_for(input_type)


@register
@dataclasses.dataclass
class SelfAttentionLayer(BaseRecurrentLayer):
    """Multi-head self-attention over a sequence [b, T, nIn] -> [b, T, nOut];
    long sequences take the flash-attention kernels (``ops/flash_attention``).
    ``stream_max_length`` is the KV-cache capacity of streaming inference
    (``rnn_time_step``); longer streams roll over the tail."""
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
        if isinstance(input_type, InputTypeFeedForward):
            return FeedForwardToRnnPreProcessor()
        return None


@register
@dataclasses.dataclass
class LossLayer(FeedForwardLayer):
    """A loss on its input, without weights (reference ``LossLayer.java``):
    the activation of the input in inference, the loss on it in training."""
    loss: str = "mcxent"

    def get_output_type(self, index, input_type):
        return input_type

    def set_n_in(self, input_type, override=False):
        pass


@register
@dataclasses.dataclass
class CenterLossOutputLayer(OutputLayer):
    """Softmax loss + ``lambda_`` x the center loss 0.5 mean ||x - c_y||^2,
    with per-class centres c (layer state, f32) moved by an EMA of rate
    ``alpha`` toward each class's batch mean after every fit step.
    ``gradient_check`` is carried as configuration only."""
    alpha: float = 0.05
    lambda_: float = 2e-4
    gradient_check: bool = False


@register
@dataclasses.dataclass
class AutoEncoder(FeedForwardLayer):
    """Denoising autoencoder, a pretrain layer (reference ``AutoEncoder.java``):
    the encoder in a forward; ``pretrain`` fits the reconstruction of the
    input, a share ``corruption_level`` of it zeroed, through the tied
    weights. ``sparsity`` is carried as configuration."""
    corruption_level: float = 0.3
    sparsity: float = 0.0
    loss: str = "mse"

    def is_pretrain_layer(self):
        return True


@register
@dataclasses.dataclass
class RBM(FeedForwardLayer):
    """Restricted Boltzmann Machine, a pretrain layer (reference ``RBM.java``):
    a forward is ``propUp``, the mean hidden activation; ``pretrain`` runs
    CD-k as the free-energy surrogate ``mean(F(v0) - F(v_k))`` over a
    k-step Gibbs chain that carries no gradient. ``hidden_unit``: binary |
    rectified | gaussian | identity; ``visible_unit``: binary | gaussian |
    linear | identity."""
    hidden_unit: str = "binary"
    visible_unit: str = "binary"
    k: int = 1
    sparsity: float = 0.0

    def is_pretrain_layer(self):
        return True


@register
@dataclasses.dataclass
class VariationalAutoencoder(FeedForwardLayer):
    """Variational autoencoder, a pretrain layer (reference
    ``VariationalAutoencoder.java``): ``n_out`` is the latent size; a
    forward gives the mean of q(z|x), ``pretrain`` minimises the negative
    ELBO over ``num_samples`` draws. ``reconstruction_distribution`` is an
    object of ``conf/reconstruction.py`` or a name: gaussian | bernoulli |
    exponential."""
    encoder_layer_sizes: Tuple[int, ...] = (100,)
    decoder_layer_sizes: Tuple[int, ...] = (100,)
    pzx_activation: str = "identity"
    reconstruction_distribution: Any = "gaussian"
    num_samples: int = 1

    def is_pretrain_layer(self):
        return True


class PoolingDimension:
    pass


@register
@dataclasses.dataclass
class GlobalPoolingLayer(Layer):
    """Pool over space ([b, h, w, c] -> [b, c]) or time ([b, T, s] -> [b, s],
    mask-aware) (reference ``nn/conf/layers/GlobalPoolingLayer.java``)."""
    pooling_type: str = PoolingType.MAX
    pooling_dimensions: Optional[Tuple[int, ...]] = None
    collapse_dimensions: bool = True
    pnorm: int = 2

    def get_output_type(self, index, input_type):
        if isinstance(input_type, InputTypeConvolutional):
            return InputTypeFeedForward(input_type.channels)
        if isinstance(input_type, InputTypeRecurrent):
            return InputTypeFeedForward(input_type.size)
        return input_type


@register
@dataclasses.dataclass
class Yolo2OutputLayer(Layer):
    """YOLOv2 detection loss (reference ``Yolo2OutputLayer.java``): input
    [b, gh, gw, 5B + C] (B anchor blocks of x, y, w, h, confidence, then
    C class logits a cell), labels [b, 4 + C, gh, gw] (corners x1, y1, x2,
    y2 in grid units, then a one-hot class map). ``boxes``: the B anchors'
    [w, h] in grid units."""
    boxes: Optional[List[List[float]]] = None
    lambda_coord: float = 5.0
    lambda_no_obj: float = 0.5

    def get_output_type(self, index, input_type):
        return input_type


@register
@dataclasses.dataclass
class FrozenLayer(Layer):
    """The inner layer with its parameters held fixed (reference
    ``FrozenLayer.java``): it runs as it is, and no gradient reaches its
    parameters."""
    inner: Optional[Any] = None

    def get_output_type(self, index, input_type):
        return self.inner.get_output_type(index, input_type)

    def set_n_in(self, input_type, override=False):
        self.inner.set_n_in(input_type, override)

    def preprocessor_for(self, input_type):
        return self.inner.preprocessor_for(input_type)
