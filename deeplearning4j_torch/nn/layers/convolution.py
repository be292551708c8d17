"""Convolution layer implementation: ConvolutionLayer.

Counterpart of ``deeplearning4j_tpu/nn/layers/convolution.py``
(``Conv2DImpl``). Activations flow NHWC ``[b, h, w, c]`` and ``W`` is HWIO
``[kh, kw, cin, cout]``, as in the JAX package, so a zip's arrays install
unchanged. cuDNN is handed ``permute`` views of both (channels-last
memory, no copy of the activations): the output comes back channels-last,
and its NHWC view is contiguous again.

Under bf16 compute the convolution's output is bf16 and the bias is added
in bf16 (the JAX ``pet_dtype`` is None for sub-32-bit compute). Under f32
compute cuDNN follows PyTorch's process-wide
``torch.backends.cudnn.allow_tf32`` (True by default, so f32 convolutions
run on TF32 tensor cores unless the caller turns it off).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .base import LayerImpl, implements, train_rng
from ..conf.layers import ConvolutionMode, _pair


def same_pads(size, k, s, d=(1, 1)):
    """Per spatial dim ``(lo, hi)`` of XLA's SAME padding: the output is
    ceil(size / s), the total pad is split with the odd cell at the end
    (stride 2 gives (2, 3) for a 7x7 window on 224, (0, 1) for 3x3 on 112)."""
    pads = []
    for n, ki, si, di in zip(size, k, s, d):
        eff = (ki - 1) * di + 1
        total = max((-(-n // si) - 1) * si + eff - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def conv_padding(mode, size, k, s, p, d):
    """Per spatial dim ``(lo, hi)``: SAME semantics under
    ``ConvolutionMode.Same``, the symmetric explicit padding otherwise
    (reference ``ConvolutionUtils``)."""
    if mode == ConvolutionMode.Same:
        return same_pads(size, k, s, d)
    return [(pi, pi) for pi in p]


def pad_nchw(x, pads, value=0.0):
    """``x`` [b, c, h, w] padded by ``pads`` ((top, bottom), (left, right))."""
    (t, b), (l, r) = pads
    return F.pad(x, (l, r, t, b), value=value) if t or b or l or r else x


@implements("ConvolutionLayer")
class Conv2DImpl(LayerImpl):
    """z = conv(x, W) + b, then the activation."""

    def param_shapes(self):
        c = self.conf
        kh, kw = _pair(c.kernel_size)
        shapes = {"W": (kh, kw, c.n_in, c.n_out)}
        if c.has_bias:
            shapes["b"] = (c.n_out,)
        return shapes

    def init_params(self, gen):
        c = self.conf
        kh, kw = _pair(c.kernel_size)
        params = {"W": self._init_w(gen, (kh, kw, c.n_in, c.n_out), c.n_in * kh * kw,
                                    c.n_out * kh * kw)}
        if c.has_bias:
            params["b"] = torch.full((c.n_out,), self.bias_init, dtype=self.dtype)
        return params

    def forward(self, x, mask=None, ctx=None):
        x = self.maybe_dropout(x, *train_rng(ctx))
        c = self.conf
        cd = self.compute_dtype
        k, s, p, d = (_pair(c.kernel_size), _pair(c.stride), _pair(c.padding),
                      _pair(c.dilation))
        pads = conv_padding(c.convolution_mode, x.shape[1:3], k, s, p, d)
        xn = x.to(cd).permute(0, 3, 1, 2)
        if all(lo == hi for lo, hi in pads):
            padding = tuple(lo for lo, _ in pads)
        else:   # F.conv2d pads symmetrically: pad the odd cell explicitly
            xn, padding = pad_nchw(xn, pads), (0, 0)
        # HWIO -> OHWI contiguous, viewed as OIHW: a channels-last kernel
        w = self.W.to(cd).permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
        z = F.conv2d(xn, w, None, s, padding, d).permute(0, 2, 3, 1)
        if "b" in self._parameters:
            z = z + self.b.to(z.dtype)
        return self.activation(z).to(self.out_dtype)
