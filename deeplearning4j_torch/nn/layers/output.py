"""Output layer implementations: OutputLayer, RnnOutputLayer (inference).

Counterpart of ``deeplearning4j_tpu/nn/layers/output.py``: a dense
projection plus activation. The terminal output is cast back to the
parameter dtype (f32): user-facing predictions stay full precision
(``output.py:35-40`` of the JAX package).
"""
from __future__ import annotations

from .base import implements
from .feedforward import DenseImpl


@implements("OutputLayer", "RnnOutputLayer")
class OutputLayerImpl(DenseImpl):
    """Works on [b, nIn] and, per time step, on [b, T, nIn]."""

    def forward(self, x, mask=None, ctx=None):
        return self.activation(self.preout(x)).to(self.dtype)
