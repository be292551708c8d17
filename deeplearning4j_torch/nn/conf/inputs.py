"""Input types for shape inference.

Counterpart of ``deeplearning4j_tpu/nn/conf/inputs.py``: the small algebra
the ListBuilder's ``set_input_type`` pass uses to infer ``n_in``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .serde import register

__all__ = ["InputType", "InputTypeFeedForward", "InputTypeRecurrent",
           "InputTypeConvolutional", "InputTypeConvolutionalFlat"]


@register
@dataclasses.dataclass
class InputTypeFeedForward:
    size: int = 0

    def arity(self):
        return self.size


@register
@dataclasses.dataclass
class InputTypeRecurrent:
    size: int = 0
    timeseries_length: Optional[int] = None

    def arity(self):
        return self.size


@register
@dataclasses.dataclass
class InputTypeConvolutional:
    height: int = 0
    width: int = 0
    channels: int = 0

    def arity(self):
        return self.height * self.width * self.channels


@register
@dataclasses.dataclass
class InputTypeConvolutionalFlat:
    height: int = 0
    width: int = 0
    channels: int = 0

    def arity(self):
        return self.height * self.width * self.channels


class InputType:
    """Factory namespace matching the reference's static methods."""

    FeedForward = InputTypeFeedForward
    Recurrent = InputTypeRecurrent
    Convolutional = InputTypeConvolutional
    ConvolutionalFlat = InputTypeConvolutionalFlat

    @staticmethod
    def feed_forward(size):
        return InputTypeFeedForward(int(size))

    feedForward = feed_forward

    @staticmethod
    def recurrent(size, timeseries_length=None):
        return InputTypeRecurrent(int(size), timeseries_length)

    @staticmethod
    def convolutional(height, width, channels):
        return InputTypeConvolutional(int(height), int(width), int(channels))

    @staticmethod
    def convolutional_flat(height, width, channels):
        return InputTypeConvolutionalFlat(int(height), int(width), int(channels))

    convolutionalFlat = convolutional_flat
