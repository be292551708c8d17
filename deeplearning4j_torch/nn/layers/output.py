"""Output layer implementations: OutputLayer, RnnOutputLayer, LossLayer,
CenterLossOutputLayer.

Counterpart of ``deeplearning4j_tpu/nn/layers/output.py``: a dense
projection plus activation for inference, and ``loss_on`` for training,
which evaluates the loss on the *preoutput* (computed in the compute dtype,
f32 accumulation) so that softmax + cross-entropy runs on the logits. The
terminal output is cast back to the parameter dtype (f32): user-facing
predictions stay full precision (``output.py:35-40`` of the JAX package).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .base import LayerImpl, implements, train_rng
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


@implements("LossLayer")
class LossLayerImpl(LayerImpl):
    """A loss without weights (reference ``LossLayer.java``): the
    activation of the input in inference (in the input's dtype), the loss
    of the input as the preoutput in training; no input dropout."""

    def forward(self, x, mask=None, ctx=None):
        return self.activation(x)

    def loss_on(self, x, labels, mask=None, train=False, gen=None):
        return get_loss(self.conf.loss)(labels, x, self.activation_name, mask)


@implements("CenterLossOutputLayer")
class CenterLossOutputImpl(OutputLayerImpl):
    """Softmax loss + ``lambda_`` x 0.5 mean_i ||x_i - c_{y_i}||^2 (reference
    ``CenterLossOutputLayer.java``; ``output.py:71-106`` of the JAX
    package), y_i the argmax of the labels. The centres are layer state,
    f32 [nOut, nIn] from zeros, so autograd carries the center loss to x
    only. The loss takes x without input dropout; inference is the
    ``OutputLayer``'s. After each fit step the container commits
    :meth:`update_state`'s new centres."""

    def init_state(self):
        c = self.conf
        return {"centers": torch.zeros(c.n_out, c.n_in, dtype=torch.float32)}

    def loss_on(self, x, labels, mask=None, train=False, gen=None):
        c = self.conf
        base = get_loss(c.loss)(labels, self.preout(x), self.activation_name, mask)
        diffs = x - self.centers[labels.argmax(-1)]
        return base + c.lambda_ * (0.5 * (diffs * diffs).sum(-1).mean())

    def update_state(self, x, labels):
        """The centres moved by ``alpha`` toward the mean of the detached
        ``x`` over each class in the batch (in f32); a class absent from the
        batch keeps its centre."""
        c = self.conf
        onehot = F.one_hot(labels.argmax(-1), c.n_out).float()
        counts = onehot.sum(0)
        means = (onehot.T @ x.detach().float()) / counts.clamp_min(1.0)[:, None]
        centers = self.centers
        return {"centers": torch.where((counts > 0)[:, None],
                                       centers + c.alpha * (means - centers), centers)}
