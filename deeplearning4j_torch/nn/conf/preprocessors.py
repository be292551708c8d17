"""Input preprocessors: shape adapters between layer families.

Counterpart of ``deeplearning4j_tpu/nn/conf/preprocessors.py``, holding the
two that the CNN slice runs. Each is a reshape/transpose whose backward
autograd derives. Convolutional activations are NHWC ``[b, h, w, c]``;
flattened ones keep the reference's channel-major (c, h, w) element order,
so a dense layer's weights after a convolution carry across from the JAX
package (and from reference/Keras checkpoints) unchanged.
"""
from __future__ import annotations

import dataclasses

from .serde import register
from .inputs import InputTypeConvolutional, InputTypeFeedForward

__all__ = ["InputPreProcessor", "CnnToFeedForwardPreProcessor",
           "FeedForwardToCnnPreProcessor"]


@dataclasses.dataclass
class InputPreProcessor:
    def __call__(self, x, ctx):
        raise NotImplementedError

    def get_output_type(self, input_type):
        raise NotImplementedError


@register
@dataclasses.dataclass
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    """[b, h, w, c] -> [b, c*h*w] in channel-major order (reference
    ``CnnToFeedForwardPreProcessor.java``)."""
    height: int = 0
    width: int = 0
    channels: int = 0

    def __call__(self, x, ctx):
        return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)

    def get_output_type(self, input_type):
        return InputTypeFeedForward(input_type.arity())


@register
@dataclasses.dataclass
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    """[b, c*h*w] (channel-major) -> [b, h, w, c] (reference
    ``FeedForwardToCnnPreProcessor.java``)."""
    height: int = 0
    width: int = 0
    channels: int = 0

    def __call__(self, x, ctx):
        return x.reshape(x.shape[0], self.channels, self.height, self.width).permute(0, 2, 3, 1)

    def get_output_type(self, input_type):
        return InputTypeConvolutional(self.height, self.width, self.channels)
