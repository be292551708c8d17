"""Network-level updater: per-layer updater resolution + gradient normalization.

Counterpart of ``deeplearning4j_tpu/optimize/updater.py``: which updater
governs each layer (the global default or a per-layer override), the five
gradient-normalization modes (reference ``GradientNormalization.java``),
and the joint ``apply`` over ``{layer: {param: tensor}}`` dicts. Updater
state is keyed like the parameters.
"""
from __future__ import annotations

import torch

from ..nn.conf import GradientNormalization

__all__ = ["normalize_gradients", "NetworkUpdater"]


def _l2(tensors):
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def _clip_scale(norm, threshold):
    """threshold/norm where the norm exceeds the threshold, else 1."""
    return torch.where(norm > threshold, threshold / torch.clamp(norm, min=1e-8),
                       torch.ones_like(norm))


def normalize_gradients(grads_per_layer, mode, threshold):
    """``grads_per_layer``: {layer: {param: grad}}. Per-layer modes work over
    all parameters of one layer, per-param-type modes over each tensor."""
    if mode in (None, GradientNormalization.None_, "none"):
        return grads_per_layer
    out = {}
    for lk, g in grads_per_layer.items():
        if not g:
            out[lk] = g
            continue
        if mode == GradientNormalization.RenormalizeL2PerLayer:
            norm = torch.clamp(_l2(g.values()), min=1e-8)
            out[lk] = {k: v / norm for k, v in g.items()}
        elif mode == GradientNormalization.RenormalizeL2PerParamType:
            out[lk] = {k: v / torch.clamp(_l2([v]), min=1e-8) for k, v in g.items()}
        elif mode == GradientNormalization.ClipElementWiseAbsoluteValue:
            out[lk] = {k: torch.clamp(v, -threshold, threshold) for k, v in g.items()}
        elif mode == GradientNormalization.ClipL2PerLayer:
            scale = _clip_scale(_l2(g.values()), threshold)
            out[lk] = {k: v * scale for k, v in g.items()}
        elif mode == GradientNormalization.ClipL2PerParamType:
            out[lk] = {k: v * _clip_scale(_l2([v]), threshold) for k, v in g.items()}
        else:
            raise ValueError(f"Unknown gradient normalization mode {mode}")
    return out


class NetworkUpdater:
    """Maps each layer key to its resolved updater and applies them jointly."""

    def __init__(self, layer_updaters):
        self.layer_updaters = dict(layer_updaters)

    def init_state(self, params):
        return {k: self.layer_updaters[k].init_state(v) if v else {}
                for k, v in params.items()}

    def apply(self, state, grads, iteration):
        updates, new_state = {}, {}
        for k, g in grads.items():
            if not g:
                updates[k], new_state[k] = g, state.get(k, {})
                continue
            updates[k], new_state[k] = self.layer_updaters[k].apply(state[k], g, iteration)
        return updates, new_state
