"""Input preprocessors: shape adapters between layer families.

Counterpart of ``deeplearning4j_tpu/nn/conf/preprocessors.py``, all seven
of its classes. Each is a reshape/transpose whose backward autograd
derives. Feed-forward activations are ``[b, size]``, recurrent ones
``[b, T, size]``, convolutional ones NHWC ``[b, h, w, c]``; flattened ones
keep the reference's channel-major (c, h, w) element order, so a dense
layer's weights after a convolution carry across from the JAX package (and
from reference/Keras checkpoints) unchanged.

A preprocessor that flattens time into the batch (``RnnToFeedForward``,
``RnnToCnn``) leaves the minibatch size and the sequence length in the
forward's ``ctx`` (``"minibatch"``, ``"timesteps"``), where the one that
restores the time axis further on reads them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .serde import register
from .inputs import InputTypeConvolutional, InputTypeFeedForward, InputTypeRecurrent

__all__ = ["InputPreProcessor", "CnnToFeedForwardPreProcessor",
           "FeedForwardToCnnPreProcessor", "RnnToFeedForwardPreProcessor",
           "FeedForwardToRnnPreProcessor", "CnnToRnnPreProcessor",
           "RnnToCnnPreProcessor", "ComposableInputPreProcessor"]


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


@register
@dataclasses.dataclass
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """[b, T, s] -> [b*T, s] (reference ``RnnToFeedForwardPreProcessor.java``)."""

    def __call__(self, x, ctx):
        b, t, s = x.shape
        ctx["minibatch"], ctx["timesteps"] = b, t
        return x.reshape(b * t, s)

    def get_output_type(self, input_type):
        return InputTypeFeedForward(input_type.size)


@register
@dataclasses.dataclass
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """[b*T, s] -> [b, T, s] by the ``ctx`` an earlier RnnToFeedForward
    left, or [b, s] -> [b, 1, s] without one (reference
    ``FeedForwardToRnnPreProcessor.java``)."""

    def __call__(self, x, ctx):
        n, s = x.shape
        b, t = ctx.get("minibatch"), ctx.get("timesteps")
        if b is None or t is None or b * t != n:
            return x.reshape(n, 1, s)
        return x.reshape(b, t, s)

    def get_output_type(self, input_type):
        return InputTypeRecurrent(input_type.arity())


@register
@dataclasses.dataclass
class CnnToRnnPreProcessor(InputPreProcessor):
    """[b*T, h, w, c] -> [b, T, c*h*w], channel-major (reference
    ``CnnToRnnPreProcessor.java``); b from ``ctx``, else the whole batch
    as one step each."""
    height: int = 0
    width: int = 0
    channels: int = 0

    def __call__(self, x, ctx):
        n = x.shape[0]
        b = ctx.get("minibatch", n)
        t = max(n // max(b, 1), 1)
        flat = x.permute(0, 3, 1, 2).reshape(n, -1)
        return flat.reshape(b, t, flat.shape[-1])

    def get_output_type(self, input_type):
        return InputTypeRecurrent(input_type.arity())


@register
@dataclasses.dataclass
class RnnToCnnPreProcessor(InputPreProcessor):
    """[b, T, c*h*w] (channel-major) -> [b*T, h, w, c] (reference
    ``RnnToCnnPreProcessor.java``)."""
    height: int = 0
    width: int = 0
    channels: int = 0

    def __call__(self, x, ctx):
        b, t, _ = x.shape
        ctx["minibatch"], ctx["timesteps"] = b, t
        return x.reshape(b * t, self.channels, self.height, self.width).permute(0, 2, 3, 1)

    def get_output_type(self, input_type):
        return InputTypeConvolutional(self.height, self.width, self.channels)


@register
@dataclasses.dataclass
class ComposableInputPreProcessor(InputPreProcessor):
    """Its ``processors`` one after another."""
    processors: Optional[list] = None

    def __call__(self, x, ctx):
        for p in self.processors or []:
            x = p(x, ctx)
        return x

    def get_output_type(self, input_type):
        for p in self.processors or []:
            input_type = p.get_output_type(input_type)
        return input_type
