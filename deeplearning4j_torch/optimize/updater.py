"""Network-level updater: per-layer updater resolution + gradient normalization.

Counterpart of ``deeplearning4j_tpu/optimize/updater.py``: which updater
governs each layer (the global default or a per-layer override), the five
gradient-normalization modes (reference ``GradientNormalization.java``),
and the joint ``apply`` over ``{layer: {param: tensor}}`` dicts. Updater
state is keyed like the parameters. A wrapper layer's dict nests
(``{"fwd": {...}, "bwd": {...}}``): the per-layer modes work over all of
its tensors, the per-parameter modes over each tensor.
"""
from __future__ import annotations

import torch

from ..nn.conf import GradientNormalization
from ..utils.trees import leaves, tree_map

__all__ = ["normalize_gradients", "NetworkUpdater"]


def _l2(tensors):
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def _layer_l2(g):
    """The L2 norm over every tensor of one layer's (possibly nested) dict."""
    return _l2([v for _, v in leaves(g)])


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
            norm = torch.clamp(_layer_l2(g), min=1e-8)
            out[lk] = tree_map(lambda v: v / norm, g)
        elif mode == GradientNormalization.RenormalizeL2PerParamType:
            out[lk] = tree_map(lambda v: v / torch.clamp(_l2([v]), min=1e-8), g)
        elif mode == GradientNormalization.ClipElementWiseAbsoluteValue:
            out[lk] = tree_map(lambda v: torch.clamp(v, -threshold, threshold), g)
        elif mode == GradientNormalization.ClipL2PerLayer:
            scale = _clip_scale(_layer_l2(g), threshold)
            out[lk] = tree_map(lambda v: v * scale, g)
        elif mode == GradientNormalization.ClipL2PerParamType:
            out[lk] = tree_map(lambda v: v * _clip_scale(_l2([v]), threshold), g)
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
