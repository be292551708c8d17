"""Pooling implementations: SubsamplingLayer (spatial), Subsampling1DLayer
(time) and GlobalPoolingLayer.

Counterpart of ``deeplearning4j_tpu/nn/layers/pooling.py``. Windowed pools
run as ``F.max_pool2d``/``F.avg_pool2d`` on the NCHW view of NHWC
activations (channels-last memory, no copy). Padding follows
``lax.reduce_window``: MAX pads with -inf, SUM/AVG/PNORM with 0, and AVG
divides by the count of real cells in each window. The padding is applied
explicitly (``pad_nchw``) whenever there is any, since the torch calls pad
only symmetrically.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .base import LayerImpl, implements
from .convolution import pad_nchw, same_pads
from ..conf.layers import ConvolutionMode, PoolingType, _pair


def _pool2d(x, kind, k, s, pads, pnorm=None, eps=1e-8):
    """``x`` [b, h, w, c] pooled over windows ``k`` at strides ``s`` with
    ``pads`` ((top, bottom), (left, right)) -> [b, h', w', c]."""
    xn = x.permute(0, 3, 1, 2)
    padded = any(lo or hi for lo, hi in pads)
    if kind == PoolingType.MAX:
        y = F.max_pool2d(pad_nchw(xn, pads, float("-inf")), k, s)
    elif kind in (PoolingType.AVG, PoolingType.SUM, PoolingType.PNORM):
        p = float(pnorm or 2)
        v = xn.abs().pow(p) if kind == PoolingType.PNORM else xn
        y = F.avg_pool2d(pad_nchw(v, pads), k, s, divisor_override=1)
        if kind == PoolingType.PNORM:
            y = (y + eps).pow(1.0 / p)
        elif kind == PoolingType.AVG:
            if padded:
                ones = torch.ones((1, 1) + tuple(xn.shape[2:]), dtype=x.dtype, device=x.device)
                counts = F.avg_pool2d(pad_nchw(ones, pads), k, s, divisor_override=1)
                y = y / counts.clamp_min(1.0)
            else:
                y = y / (k[0] * k[1])
    else:
        raise ValueError(f"Unknown pooling type {kind}")
    return y.permute(0, 2, 3, 1)


@implements("SubsamplingLayer")
class SubsamplingImpl(LayerImpl):
    def forward(self, x, mask=None, ctx=None):
        c = self.conf
        k, s, p = _pair(c.kernel_size), _pair(c.stride), _pair(c.padding)
        if c.convolution_mode == ConvolutionMode.Same:
            pads = same_pads(x.shape[1:3], k, s)
        else:
            pads = [(pi, pi) for pi in p]
        return _pool2d(x, c.pooling_type, k, s, pads, c.pnorm, c.eps)


@implements("Subsampling1DLayer")
class Subsampling1DImpl(LayerImpl):
    """``_pool2d`` on the [b, T, 1, c] view of [b, T, c] with window (k, 1):
    the first entries of the layer's kernel, stride and padding."""

    def forward(self, x, mask=None, ctx=None):
        c = self.conf
        k, s, p = _pair(c.kernel_size)[0], _pair(c.stride)[0], _pair(c.padding)[0]
        if c.convolution_mode == ConvolutionMode.Same:
            pads = same_pads(x.shape[1:2], (k,), (s,)) + [(0, 0)]
        else:
            pads = [(p, p), (0, 0)]
        return _pool2d(x[:, :, None, :], c.pooling_type, (k, 1), (s, 1), pads, c.pnorm,
                       c.eps)[:, :, 0, :]


@implements("GlobalPoolingLayer")
class GlobalPoolingImpl(LayerImpl):
    """Pool over time ([b, T, s] -> [b, s], mask-aware over [b, T]) or
    space ([b, h, w, c] -> [b, c]) (reference ``GlobalPoolingLayer.java`` +
    ``MaskedReductionUtil``)."""

    def forward(self, x, mask=None, ctx=None):
        c = self.conf
        kind = c.pooling_type
        p = float(c.pnorm)
        if x.dim() == 3:
            dims = (1,)
            if mask is not None:
                m = mask.to(x.dtype)[:, :, None]
                if kind == PoolingType.MAX:
                    return torch.where(m > 0, x, torch.full_like(x, -1e30)).amax(dim=1)
                if kind == PoolingType.SUM:
                    return (x * m).sum(dim=1)
                if kind == PoolingType.AVG:
                    return (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
                if kind == PoolingType.PNORM:
                    return (x.abs() * m).pow(p).sum(dim=1).pow(1.0 / p)
        elif x.dim() == 4:
            dims = (1, 2)
        else:
            raise ValueError(f"GlobalPoolingLayer: unsupported rank {x.dim()}")
        if kind == PoolingType.MAX:
            return x.amax(dim=dims)
        if kind == PoolingType.AVG:
            return x.mean(dim=dims)
        if kind == PoolingType.SUM:
            return x.sum(dim=dims)
        if kind == PoolingType.PNORM:
            return x.abs().pow(p).sum(dim=dims).pow(1.0 / p)
        raise ValueError(f"Unknown pooling type {kind}")
