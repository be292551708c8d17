"""Convolution family implementations: ConvolutionLayer, Convolution1DLayer,
Deconvolution2D, DepthwiseConvolution2D, SeparableConvolution2D, and the
shape layers ZeroPaddingLayer, ZeroPadding1DLayer, Cropping2D,
SpaceToDepthLayer, Upsampling2D and Upsampling1D.

Counterpart of ``deeplearning4j_tpu/nn/layers/convolution.py``.
Activations flow NHWC ``[b, h, w, c]`` (the 1-D layers ``[b, T, c]``) and
kernels are HWIO ``[kh, kw, cin, cout]`` (Convolution1DLayer's HIO ``[k,
cin, cout]``), as in the JAX package, so a zip's arrays install unchanged.
cuDNN is handed ``permute`` views of both (channels-last memory, no copy
of the activations; a kernel is copied once a call into channels-last
memory): the output comes back channels-last, and its NHWC view is
contiguous again. A 1-D convolution is a 2-D one on the [b, T, 1, c]
view, and a depthwise one a grouped convolution (``groups`` = cin).

Deconvolution2D is ``lax.conv_transpose`` without ``transpose_kernel``
(``convolution.py:99-135`` of the JAX package): the stride-dilated input,
padded by ``(k - 1) d - p`` a side under Truncate or by
``lax._conv_transpose_padding``'s SAME pads (asymmetric when the stride
exceeds the dilated kernel or their sum is odd), correlated with the
unflipped HWIO kernel. ``F.conv_transpose2d`` is the gradient of a
convolution: it correlates with the spatially flipped kernel, in and out
swapped, and crops ``padding`` a side and adds ``output_padding`` at the
end. So the kernel is flipped once, and the two pads become ``padding``
and ``output_padding``, with an explicit crop where they cannot say it.

Under bf16 compute a convolution's output is bf16 and the bias is added
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


def conv_nhwc(x, w, stride, pads, dilation, cd, groups=1):
    """NHWC ``x`` convolved with HWIO ``w`` (cin / groups input channels a
    kernel), both in ``cd``, under ``pads`` ((top, bottom), (left,
    right)) -> NHWC, through ``F.conv2d`` on channels-last views."""
    xn = x.to(cd).permute(0, 3, 1, 2)
    if all(lo == hi for lo, hi in pads):
        padding = tuple(lo for lo, _ in pads)
    else:   # F.conv2d pads symmetrically: pad the odd cell explicitly
        xn, padding = pad_nchw(xn, pads), (0, 0)
    # HWIO -> OHWI contiguous, viewed as OIHW: a channels-last kernel
    wn = w.to(cd).permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
    return F.conv2d(xn, wn, None, stride, padding, dilation, groups).permute(0, 2, 3, 1)


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
        k, s, p, d = (_pair(c.kernel_size), _pair(c.stride), _pair(c.padding),
                      _pair(c.dilation))
        pads = conv_padding(c.convolution_mode, x.shape[1:3], k, s, p, d)
        return self.finish(conv_nhwc(x, self.W, s, pads, d, self.compute_dtype))

    def finish(self, z):
        """+ b (in z's dtype), the activation, the output dtype."""
        if "b" in self._parameters:
            z = z + self.b.to(z.dtype)
        return self.activation(z).to(self.out_dtype)


@implements("Convolution1DLayer")
class Conv1DImpl(Conv2DImpl):
    """z = conv1d(x, W) + b over [b, T, c]: the 2-D convolution of the [b,
    T, 1, c] view with W [k, cin, cout] as [k, 1, cin, cout]."""

    def param_shapes(self):
        c = self.conf
        k = _pair(c.kernel_size)[0]
        shapes = {"W": (k, c.n_in, c.n_out)}
        if c.has_bias:
            shapes["b"] = (c.n_out,)
        return shapes

    def init_params(self, gen):
        c = self.conf
        k = _pair(c.kernel_size)[0]
        params = {"W": self._init_w(gen, (k, c.n_in, c.n_out), c.n_in * k, c.n_out * k)}
        if c.has_bias:
            params["b"] = torch.full((c.n_out,), self.bias_init, dtype=self.dtype)
        return params

    def forward(self, x, mask=None, ctx=None):
        x = self.maybe_dropout(x, *train_rng(ctx))
        c = self.conf
        k, s, p, d = (_pair(c.kernel_size)[0], _pair(c.stride)[0], _pair(c.padding)[0],
                      _pair(c.dilation)[0])
        pads = conv_padding(c.convolution_mode, x.shape[1:2], (k,), (s,), (p,), (d,))
        z = conv_nhwc(x[:, :, None, :], self.W[:, None], (s, 1), pads + [(0, 0)], (d, 1),
                      self.compute_dtype)
        return self.finish(z[:, :, 0, :])


@implements("Deconvolution2D")
class Deconv2DImpl(Conv2DImpl):
    """z = conv_transpose(x, W) + b (the JAX package's ``lax.conv_transpose``
    without ``transpose_kernel``: see the module docstring)."""

    def forward(self, x, mask=None, ctx=None):
        x = self.maybe_dropout(x, *train_rng(ctx))
        c = self.conf
        k, s, p, d = (_pair(c.kernel_size), _pair(c.stride), _pair(c.padding),
                      _pair(c.dilation))
        cd = self.compute_dtype
        # JAX's pads of the stride-dilated input, as crops of the full
        # transposed convolution (which pads (k - 1) d a side): lo and hi,
        # negative where JAX pads past it (zeros, since nothing reaches them)
        crops = []
        for i in range(2):
            eff = (k[i] - 1) * d[i] + 1
            if c.convolution_mode == ConvolutionMode.Same:
                lo_pad, hi_pad = transpose_same_pads(eff, s[i])
            else:
                lo_pad = hi_pad = eff - 1 - p[i]
            crops.append((eff - 1 - lo_pad, eff - 1 - hi_pad))
        # conv_transpose2d crops `padding` from both ends and extends the end
        # by `output_padding` (here stride - dilated k at most, below the
        # stride): crop the rest after
        padding = tuple(max(min(lo, hi), 0) for lo, hi in crops)
        out_pad = tuple(max(pd - hi, 0) for pd, (_, hi) in zip(padding, crops))
        # HWIO flipped in space -> IHWO contiguous, viewed as [I, O, H, W]:
        # the channels-last layout of conv_transpose2d's weight
        w = self.W.to(cd).flip(0, 1).permute(2, 0, 1, 3).contiguous().permute(0, 3, 1, 2)
        z = F.conv_transpose2d(x.to(cd).permute(0, 3, 1, 2), w, None, s, padding, out_pad, 1,
                               d).permute(0, 2, 3, 1)
        (lo_h, hi_h), (lo_w, hi_w) = [(lo - pd, hi - pd + op) for (lo, hi), pd, op
                                      in zip(crops, padding, out_pad)]
        if lo_h or hi_h or lo_w or hi_w:
            z = z[:, lo_h:z.shape[1] - hi_h, lo_w:z.shape[2] - hi_w]
        return self.finish(z)


def transpose_same_pads(k, s):
    """(lo, hi) pads of ``lax.conv_transpose``'s SAME mode for one dim of a
    dilated kernel size ``k`` and stride ``s`` (``_conv_transpose_padding``):
    the output is s times the input."""
    total = k + s - 2
    lo = k - 1 if s > k - 1 else -(-total // 2)
    return lo, total - lo


@implements("DepthwiseConvolution2D")
class DepthwiseConv2DImpl(Conv2DImpl):
    """A grouped convolution, ``groups`` = cin: W [kh, kw, 1, cin * m],
    output channel j from input channel j // m, as the JAX package's
    ``feature_group_count``."""

    def param_shapes(self):
        c = self.conf
        kh, kw = _pair(c.kernel_size)
        n = c.n_in * int(c.depth_multiplier)
        shapes = {"W": (kh, kw, 1, n)}
        if c.has_bias:
            shapes["b"] = (n,)
        return shapes

    def init_params(self, gen):
        c = self.conf
        kh, kw = _pair(c.kernel_size)
        m = int(c.depth_multiplier)
        params = {"W": self._init_w(gen, (kh, kw, 1, c.n_in * m), kh * kw, kh * kw * m)}
        if c.has_bias:
            params["b"] = torch.full((c.n_in * m,), self.bias_init, dtype=self.dtype)
        return params

    def forward(self, x, mask=None, ctx=None):
        x = self.maybe_dropout(x, *train_rng(ctx))
        c = self.conf
        k, s, p, d = (_pair(c.kernel_size), _pair(c.stride), _pair(c.padding),
                      _pair(c.dilation))
        pads = conv_padding(c.convolution_mode, x.shape[1:3], k, s, p, d)
        return self.finish(conv_nhwc(x, self.W, s, pads, d, self.compute_dtype, c.n_in))


@implements("SeparableConvolution2D")
class SeparableConv2DImpl(Conv2DImpl):
    """The depthwise convolution ``dW`` (the layer's stride, padding and
    dilation), its output in the compute dtype, then the pointwise 1x1
    ``pW``; the bias after both."""

    def param_shapes(self):
        c = self.conf
        kh, kw = _pair(c.kernel_size)
        n = c.n_in * int(c.depth_multiplier)
        shapes = {"dW": (kh, kw, 1, n), "pW": (1, 1, n, c.n_out)}
        if c.has_bias:
            shapes["b"] = (c.n_out,)
        return shapes

    def init_params(self, gen):
        c = self.conf
        kh, kw = _pair(c.kernel_size)
        m = int(c.depth_multiplier)
        n = c.n_in * m
        params = {"dW": self._init_w(gen, (kh, kw, 1, n), kh * kw, kh * kw * m),
                  "pW": self._init_w(gen, (1, 1, n, c.n_out), n, c.n_out)}
        if c.has_bias:
            params["b"] = torch.full((c.n_out,), self.bias_init, dtype=self.dtype)
        return params

    def forward(self, x, mask=None, ctx=None):
        x = self.maybe_dropout(x, *train_rng(ctx))
        c = self.conf
        k, s, p, d = (_pair(c.kernel_size), _pair(c.stride), _pair(c.padding),
                      _pair(c.dilation))
        cd = self.compute_dtype
        pads = conv_padding(c.convolution_mode, x.shape[1:3], k, s, p, d)
        z = conv_nhwc(x, self.dW, s, pads, d, cd, c.n_in)
        return self.finish(conv_nhwc(z, self.pW, (1, 1), [(0, 0), (0, 0)], (1, 1), cd))


@implements("ZeroPaddingLayer")
class ZeroPaddingImpl(LayerImpl):
    save_output = False  # recomputed under remat (GlobalConfig.remat)

    def forward(self, x, mask=None, ctx=None):
        t, b, l, r = self.conf._pads()
        return F.pad(x, (0, 0, l, r, t, b))


@implements("ZeroPadding1DLayer")
class ZeroPadding1DImpl(LayerImpl):
    save_output = False  # recomputed under remat (GlobalConfig.remat)

    def forward(self, x, mask=None, ctx=None):
        lo, hi = _pair(self.conf.padding)
        return F.pad(x, (0, 0, lo, hi))


@implements("Cropping2D")
class Cropping2DImpl(LayerImpl):
    """The JAX package's slice ``x[:, t:h - b or None, l:w - r or None]``."""

    save_output = False  # recomputed under remat (GlobalConfig.remat)

    def forward(self, x, mask=None, ctx=None):
        t, b, l, r = self.conf._crops()
        h, w = x.shape[1], x.shape[2]
        return x[:, t:h - b or None, l:w - r or None]


@implements("SpaceToDepthLayer")
class SpaceToDepthImpl(LayerImpl):
    """[b, h, w, c] -> [b, h/bs, w/bs, bs * bs * c], channel (i * bs + j) * c
    + ch holding cell (i, j) of the block (not ``F.pixel_unshuffle``'s
    NCHW order ch * bs^2 + i * bs + j)."""

    save_output = False  # recomputed under remat (GlobalConfig.remat)

    def forward(self, x, mask=None, ctx=None):
        bs = int(self.conf.block_size)
        b, h, w, c = x.shape
        x = x.reshape(b, h // bs, bs, w // bs, bs, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, h // bs, w // bs, bs * bs * c)


@implements("Upsampling2D")
class Upsampling2DImpl(LayerImpl):
    """Nearest-neighbour upsampling (``jnp.repeat`` on both spatial axes)."""

    save_output = False  # recomputed under remat (GlobalConfig.remat)

    def forward(self, x, mask=None, ctx=None):
        sh, sw = _pair(self.conf.size)
        return x.repeat_interleave(sh, dim=1).repeat_interleave(sw, dim=2)


@implements("Upsampling1D")
class Upsampling1DImpl(LayerImpl):
    save_output = False  # recomputed under remat (GlobalConfig.remat)

    def forward(self, x, mask=None, ctx=None):
        return x.repeat_interleave(int(self.conf.size), dim=1)
