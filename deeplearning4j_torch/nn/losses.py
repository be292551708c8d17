"""Loss functions.

Counterpart of ``deeplearning4j_tpu/nn/losses.py``: the same string-keyed
set, each ``f(labels, preoutput, activation, mask) -> scalar`` on tensors,
differentiated by autograd. Softmax + MCXENT/NLL and sigmoid + XENT are
computed on the logits (``log_softmax`` / ``logsigmoid``), as there.

Conventions (the reference's): ``labels`` and ``preoutput`` are
``[batch, ..., nOut]``; ``mask`` is None or broadcastable to the
per-example (or per-step) loss; the score is the sum over examples divided
by the minibatch size only, so masked steps add 0 but do not shrink the
denominator.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .activations import get_activation

__all__ = ["LossFunction", "LossFunctions", "get_loss"]

_EPS = 1e-7


def _act(preout, activation):
    return get_activation(activation)(preout)


def _reduce(per_elem, mask):
    """Sum over the feature axis, apply the mask, divide by the minibatch."""
    per_ex = per_elem.sum(dim=-1)
    if mask is not None:
        per_ex = per_ex * torch.broadcast_to(mask.to(per_ex.dtype), per_ex.shape)
    batch = per_ex.shape[0] if per_ex.dim() > 0 else 1
    return per_ex.sum() / max(batch, 1)


def _mse(labels, preout, activation, mask):
    out = _act(preout, activation)
    return _reduce((out - labels) ** 2, mask)


def _mae(labels, preout, activation, mask):
    out = _act(preout, activation)
    return _reduce(torch.abs(out - labels), mask)


def _mape(labels, preout, activation, mask):
    out = _act(preout, activation)
    return _reduce(100.0 * torch.abs((labels - out) / (labels + _EPS)), mask)


def _msle(labels, preout, activation, mask):
    out = _act(preout, activation)
    d = (torch.log1p(torch.clamp(out, min=-1 + _EPS))
         - torch.log1p(torch.clamp(labels, min=-1 + _EPS)))
    return _reduce(d * d, mask)


def _mcxent(labels, preout, activation, mask):
    if str(activation).lower() == "softmax":
        return _reduce(-labels * F.log_softmax(preout, dim=-1), mask)
    out = _act(preout, activation)
    return _reduce(-labels * torch.log(torch.clamp(out, _EPS, 1.0)), mask)


def _sparse_mcxent(labels, preout, activation, mask):
    # labels: integer class indices [batch, ...]
    logp = F.log_softmax(preout, dim=-1)
    picked = torch.gather(logp, -1, labels.long()[..., None])
    return _reduce(-picked, mask)


def _xent(labels, preout, activation, mask):
    if str(activation).lower() == "sigmoid":
        per = -(labels * F.logsigmoid(preout) + (1.0 - labels) * F.logsigmoid(-preout))
        return _reduce(per, mask)
    out = torch.clamp(_act(preout, activation), _EPS, 1.0 - _EPS)
    return _reduce(-(labels * torch.log(out) + (1.0 - labels) * torch.log(1.0 - out)), mask)


def _kld(labels, preout, activation, mask):
    out = torch.clamp(_act(preout, activation), _EPS, 1.0)
    lab = torch.clamp(labels, _EPS, 1.0)
    return _reduce(lab * (torch.log(lab) - torch.log(out)), mask)


def _poisson(labels, preout, activation, mask):
    out = _act(preout, activation)
    return _reduce(out - labels * torch.log(torch.clamp(out, min=_EPS)), mask)


def _cosine_proximity(labels, preout, activation, mask):
    out = _act(preout, activation)
    dot = (labels * out).sum(dim=-1, keepdim=True)
    nl = torch.linalg.vector_norm(labels, dim=-1, keepdim=True)
    no = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
    return _reduce(-dot / torch.clamp(nl * no, min=_EPS), mask)


def _hinge(labels, preout, activation, mask):
    # labels in {-1, +1}
    out = _act(preout, activation)
    return _reduce(torch.clamp(1.0 - labels * out, min=0.0), mask)


def _squared_hinge(labels, preout, activation, mask):
    out = _act(preout, activation)
    return _reduce(torch.clamp(1.0 - labels * out, min=0.0) ** 2, mask)


_LOSSES = {
    "mse": _mse,
    "squared_loss": _mse,
    "l2": _mse,             # un-averaged squared error: MSE under this reduction
    "l1": _mae,
    "mean_absolute_error": _mae,
    "mean_absolute_percentage_error": _mape,
    "mean_squared_logarithmic_error": _msle,
    "mcxent": _mcxent,
    "sparse_mcxent": _sparse_mcxent,
    "negativeloglikelihood": _mcxent,
    "xent": _xent,
    "reconstruction_crossentropy": _xent,
    "kl_divergence": _kld,
    "poisson": _poisson,
    "cosine_proximity": _cosine_proximity,
    "hinge": _hinge,
    "squared_hinge": _squared_hinge,
}


class LossFunction:
    """String-keyed registry mirroring ND4J ``LossFunctions.LossFunction``."""

    MSE = "mse"
    L1 = "l1"
    L2 = "l2"
    XENT = "xent"
    MCXENT = "mcxent"
    SPARSE_MCXENT = "sparse_mcxent"
    SQUARED_LOSS = "squared_loss"
    RECONSTRUCTION_CROSSENTROPY = "reconstruction_crossentropy"
    NEGATIVELOGLIKELIHOOD = "negativeloglikelihood"
    COSINE_PROXIMITY = "cosine_proximity"
    HINGE = "hinge"
    SQUARED_HINGE = "squared_hinge"
    KL_DIVERGENCE = "kl_divergence"
    MEAN_ABSOLUTE_ERROR = "mean_absolute_error"
    MEAN_ABSOLUTE_PERCENTAGE_ERROR = "mean_absolute_percentage_error"
    MEAN_SQUARED_LOGARITHMIC_ERROR = "mean_squared_logarithmic_error"
    POISSON = "poisson"

    @staticmethod
    def names():
        return sorted(_LOSSES)


LossFunctions = LossFunction  # reference-style alias


def get_loss(name):
    """Resolve a loss by name; callables pass through."""
    if callable(name):
        return name
    key = str(name).lower()
    if key not in _LOSSES:
        raise ValueError(f"Unknown loss '{name}'. Known: {sorted(_LOSSES)}")
    return _LOSSES[key]
