"""Output layer implementations: OutputLayer, RnnOutputLayer.

Counterpart of ``deeplearning4j_tpu/nn/layers/output.py``: a dense
projection plus activation for inference, and ``loss_on`` for training,
which evaluates the loss on the *preoutput* (computed in the compute dtype,
f32 accumulation) so that softmax + cross-entropy runs on the logits. The
terminal output is cast back to the parameter dtype (f32): user-facing
predictions stay full precision (``output.py:35-40`` of the JAX package).
"""
from __future__ import annotations

from .base import implements, train_rng
from .feedforward import DenseImpl
from ..losses import get_loss


@implements("OutputLayer", "RnnOutputLayer")
class OutputLayerImpl(DenseImpl):
    """Works on [b, nIn] and, per time step, on [b, T, nIn]; the loss is
    mask-aware over [b, T]. Both apply the layer's input dropout in
    training (``output.py:35-47`` of the JAX package)."""

    def forward(self, x, mask=None, ctx=None):
        x = self.maybe_dropout(x, *train_rng(ctx))
        return self.activation(self.preout(x)).to(self.dtype)

    def loss_on(self, x, labels, mask=None, train=False, gen=None):
        x = self.maybe_dropout(x, train, gen)
        return get_loss(self.conf.loss)(labels, self.preout(x), self.activation_name, mask)
