"""Fused two-layer persistent LSTM (K3) and its fused BPTT (K4).

Counterpart of ``deeplearning4j_tpu/ops/lstm_fused.py``: the inference
primal ``_lstm2`` -> ``_fwd2(save_reserve=False)``, the training forward
``_lstm2_fwd`` -> ``_fwd2`` with the reserve, and ``_lstm2_bwd`` ->
``_bwd2_call``. The CUDA kernels are ``csrc/lstm_fused.cu`` (K3) and
``csrc/lstm_fused_bwd.cu`` (K4); their source notes give the design. Each
has two bodies, chosen statically by its C entry: tensor cores for bf16
weights at the shapes :func:`fwd_route` and :func:`bwd_route` name, CUDA
cores else.
Beside each is a plain PyTorch time loop (CPU tensors, the tests, and
``chip_smoke.py``'s oracle on the card).

Math: layer 1 is the K1 cell without a mask; layer 2's pre-activation is
``b2 + bf16(h1) @ W2 + bf16(h2) @ RW2``, both products accumulated in f32.
The backward adds the inter-layer term ``dh1_t += bf16(dz2_t) @ W2^T``.
Step masks never reach these kernels: masked pairs run K1/K2 per layer.

:class:`LSTM2Function` is the autograd seam: K3 with the reserve (ys1, g1,
c1, g2, c2) forward; K4 backward, with dRW1, dW2, dRW2 and db2 formed
outside the kernel. :func:`lstm_scan2` takes it whenever autograd records.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import cuda_build
from .lstm_cell import (_check_cuda, _same_device, cell, cell_bwd, pack_peepholes,
                        recording, stream_dtype, weight_grad)

__all__ = ["lstm_scan2", "lstm2_fwd", "lstm2_fwd_plain", "lstm2_bwd", "lstm2_bwd_plain",
           "LSTM2Function", "fwd_route", "bwd_route", "COUNTER", "TRAIN_COUNTER",
           "BWD_COUNTER"]

SOURCE = "lstm_fused.cu"
BWD_SOURCE = "lstm_fused_bwd.cu"
COUNTER = cuda_build.Counter("lstm2_fwd")              # K3, inference
TRAIN_COUNTER = cuda_build.Counter("lstm2_fwd_train")  # K3 writing the reserve
BWD_COUNTER = cuda_build.Counter("lstm2_bwd")          # K4
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] + [_P] * 12 + [_I] * 3 + [_P]
_BWD_ARGTYPES = [_P] * 8 + [_I] + [_P] * 8 + [_I] * 3 + [_P]
_FWD_ROUTE_ARGTYPES = [_I] * 4   # (w_bf16, b, H, reserve)
_ROUTE_ARGTYPES = [_I] * 3       # (w_bf16, b, H)


def lstm2_fwd_plain(xp, rw1, w2, rw2, b2, peep, h0, save_reserve=False):
    """Reference loop. ``xp`` [T, b, 4H], ``rw1``/``w2``/``rw2`` [H, 4H] (one
    dtype), ``b2`` [4H], ``peep`` [6, H] (rows 0-2 layer 1, 3-5 layer 2) or
    None, ``h0`` [4, b, H] (h1, c1, h2, c2) -> (ys2 [T, b, H], hc [4, b,
    H]), plus (ys1, g1, c1, g2, c2) with ``save_reserve``. Computed in
    xp's dtype."""
    T, b, H4 = xp.shape
    H = H4 // 4
    ad, wd = xp.dtype, rw1.dtype
    rw1a, w2a, rw2a = rw1.to(ad), w2.to(ad), rw2.to(ad)
    p1 = None if peep is None else peep[0:3]
    p2 = None if peep is None else peep[3:6]
    h1, c1, h2, c2 = (h0[k].to(ad) for k in range(4))
    ys2 = xp.new_empty((T, b, H))
    res = [xp.new_empty(s) for s in ((T, b, H), (T, b, H4), (T, b, H), (T, b, H4),
                                     (T, b, H))] if save_reserve else None
    for t in range(T):
        h1, c1, gts1 = cell(xp[t] + h1.to(wd).to(ad) @ rw1a, c1, H, p1)
        z2 = (b2 + h1.to(wd).to(ad) @ w2a) + h2.to(wd).to(ad) @ rw2a
        h2, c2, gts2 = cell(z2, c2, H, p2)
        ys2[t] = h2
        if save_reserve:
            for buf, v in zip(res, (h1, gts1, c1, gts2, c2)):
                buf[t] = v
    hc = torch.stack([h1, c1, h2, c2])
    if save_reserve:
        return (ys2, hc, *res)
    return ys2, hc


def lstm2_bwd_plain(dy, g1, c1, g2, c2, rw1, w2, rw2, peep, c0, dhcT):
    """Reference reverse loop (the JAX ``_bwd2_kernel``): ``dy`` [T, b, H]
    the gradient of ys2, the reserve of :func:`lstm2_fwd_plain`, the three
    weights [H, 4H], ``peep`` [6, H] or None, ``c0`` [2, b, H] (c1, c2
    before step 0), ``dhcT`` [4, b, H] -> (dz1, dz2 [T, b, 4H], dhc0 [4, b,
    H], dpeep [6, H] or None). Each dz is rounded to the weights' dtype
    before its ``. W^T`` products."""
    T, b, H = dy.shape
    ad, wd = dy.dtype, rw1.dtype
    rw1t, w2t, rw2t = rw1.to(ad).t(), w2.to(ad).t(), rw2.to(ad).t()
    p1 = None if peep is None else peep[0:3]
    p2 = None if peep is None else peep[3:6]
    dh1, dc1, dh2, dc2 = (dhcT[k].to(ad) for k in range(4))
    dz1 = dy.new_empty((T, b, 4 * H))
    dz2 = dy.new_empty((T, b, 4 * H))
    dpeep = dy.new_zeros((6, H)) if peep is not None else None
    for t in reversed(range(T)):
        c1p = c1[t - 1] if t > 0 else c0[0].to(ad)
        c2p = c2[t - 1] if t > 0 else c0[1].to(ad)
        # layer 2 first (it owns dy), then its dz feeds layer 1 through W2^T
        d2, dc2, dp2 = cell_bwd(dy[t] + dh2, dc2, g2[t], c2[t], c2p, H, p2)
        d2w = d2.to(wd).to(ad)
        dh2 = d2w @ rw2t
        d1, dc1, dp1 = cell_bwd(dh1 + d2w @ w2t, dc1, g1[t], c1[t], c1p, H, p1)
        dh1 = d1.to(wd).to(ad) @ rw1t
        dz1[t], dz2[t] = d1, d2
        if dpeep is not None:
            dpeep[0:3] += dp1
            dpeep[3:6] += dp2
    return dz1, dz2, torch.stack([dh1, dc1, dh2, dc2]), dpeep


def _check_weights(what, H, *ws):
    for name, w in zip(("rw1", "w2", "rw2"), ws):
        _check_cuda(name, w, (H, 4 * H), (torch.bfloat16, torch.float32))
        if w.dtype != ws[0].dtype:
            raise ValueError(f"{what}: rw1, w2 and rw2 must share a dtype")


def _lstm2_fwd_cuda(xp, rw1, w2, rw2, b2, peep, h0, save_reserve):
    T, b, H4 = xp.shape
    H = H4 // 4
    if H % 8:
        raise ValueError(f"the kernel needs H % 8 == 0, got H={H}")
    _check_cuda("xp", xp, (T, b, H4))
    _check_weights("lstm2_fwd", H, rw1, w2, rw2)
    _check_cuda("b2", b2, (H4,))
    if peep is not None:
        _check_cuda("peep", peep, (6, H))
    _check_cuda("h0", h0, (4, b, H))
    _same_device("lstm2_fwd", xp, rw1, w2, rw2, b2, peep, h0)
    f32 = dict(device=xp.device, dtype=torch.float32)
    ys2 = torch.empty((T, b, H), **f32)
    res = [torch.empty(s, **f32) for s in ((T, b, H), (T, b, H4), (T, b, H), (T, b, H4),
                                          (T, b, H))] if save_reserve else [None] * 5
    if T == 0:
        hc = h0.clone()
    else:
        hc = torch.empty((4, b, H), **f32)
        w_bf16 = rw1.dtype == torch.bfloat16
        # the CUDA-core body's h1 exchange (ys1 when the reserve is written)
        hx = None if save_reserve else torch.empty((2, b, H), **f32)
        # the tensor-core body's bf16 exchange of h1 and h2 (two slots each)
        hxb = torch.empty((2, 2, b, H), device=xp.device, dtype=torch.bfloat16) \
            if w_bf16 else None
        lib = cuda_build.library(SOURCE, "dl4j_lstm2_fwd", _ARGTYPES)
        P = cuda_build.ptr
        code = lib.dl4j_lstm2_fwd(P(xp), P(rw1), P(w2), P(rw2), int(w_bf16), P(b2), P(peep),
                                  P(h0), P(hx), P(hxb), P(ys2), *(P(r) for r in res), P(hc),
                                  T, b, H, cuda_build.stream_of(xp))
        cuda_build.check(lib, code, "lstm2_fwd kernel launch")
        (TRAIN_COUNTER if save_reserve else COUNTER).add()
    if save_reserve:
        return (ys2, hc, *res)
    return ys2, hc


def fwd_route(w_dtype, b, H, reserve=False, device=None) -> Tuple[bool, int]:
    """K3's static choice for weights of ``w_dtype`` at batch ``b`` and
    width ``H`` on ``device`` (the current card when None), for the serving
    instantiation or, with ``reserve``, the training one: whether it takes
    the tensor-core body (else the CUDA-core body), and the hidden units a
    block of that body takes (0 when no grid fits and the launch raises).
    The CUDA-core grid has H / units blocks, each running both layers; the
    tensor-core grid 2 H / units, half running layer 1 and half layer 2.
    Named by the C exports ``dl4j_lstm2_fwd_tc`` and
    ``dl4j_lstm2_fwd_units``; builds the kernel at first use, so it needs
    the card. On a CPU device the plain loop takes every shape: (False, H)."""
    if device is not None and torch.device(device).type == "cpu":
        return False, H
    args = (int(w_dtype == torch.bfloat16), b, H, int(reserve))
    lib = cuda_build.library(SOURCE, "dl4j_lstm2_fwd_tc", _FWD_ROUTE_ARGTYPES)
    cuda_build.library(SOURCE, "dl4j_lstm2_fwd_units", _FWD_ROUTE_ARGTYPES)
    return bool(lib.dl4j_lstm2_fwd_tc(*args)), lib.dl4j_lstm2_fwd_units(*args)


def lstm2_fwd(xp, rw1, w2, rw2, b2, peep, h0, save_reserve=False):
    """K3 on time-major inputs (shapes as :func:`lstm2_fwd_plain`). CUDA
    tensors launch the kernel (or raise); CPU tensors take the plain loop.
    ``save_reserve`` also returns (ys1, g1, c1, g2, c2)."""
    if xp.device.type == "cuda":
        return _lstm2_fwd_cuda(xp, rw1, w2, rw2, b2, peep, h0, save_reserve)
    if xp.device.type == "cpu":
        return lstm2_fwd_plain(xp, rw1, w2, rw2, b2, peep, h0, save_reserve)
    raise ValueError(f"lstm2_fwd: unsupported device {xp.device}")


def _lstm2_bwd_cuda(dy, g1, c1, g2, c2, rw1, w2, rw2, peep, c0, dhcT):
    T, b, H = dy.shape
    H4 = 4 * H
    if H % 8:
        raise ValueError(f"the kernel needs H % 8 == 0, got H={H}")
    _check_cuda("dy", dy, (T, b, H))
    for name, t, n in (("g1", g1, H4), ("c1", c1, H), ("g2", g2, H4), ("c2", c2, H)):
        _check_cuda(name, t, (T, b, n))
    _check_weights("lstm2_bwd", H, rw1, w2, rw2)
    if peep is not None:
        _check_cuda("peep", peep, (6, H))
    _check_cuda("c0", c0, (2, b, H))
    _check_cuda("dhcT", dhcT, (4, b, H))
    _same_device("lstm2_bwd", dy, g1, c1, g2, c2, rw1, w2, rw2, peep, c0, dhcT)
    f32 = dict(device=dy.device, dtype=torch.float32)
    dz1 = torch.empty((T, b, H4), **f32)
    dz2 = torch.empty((T, b, H4), **f32)
    dpeep = torch.zeros((6, H), **f32) if peep is not None else None
    if T == 0:
        return dz1, dz2, dhcT.clone(), dpeep
    dhc0 = torch.empty((4, b, H), **f32)
    dzx = torch.empty((2, 2, b, H4), device=dy.device, dtype=rw1.dtype)  # dz1/dz2 exchange
    lib = cuda_build.library(BWD_SOURCE, "dl4j_lstm2_bwd", _BWD_ARGTYPES)
    P = cuda_build.ptr
    code = lib.dl4j_lstm2_bwd(P(dy), P(g1), P(c1), P(g2), P(c2), P(rw1), P(w2), P(rw2),
                              int(rw1.dtype == torch.bfloat16), P(peep), P(c0), P(dhcT),
                              P(dzx), P(dz1), P(dz2), P(dhc0), P(dpeep), T, b, H,
                              cuda_build.stream_of(dy))
    cuda_build.check(lib, code, "lstm2_bwd kernel launch")
    BWD_COUNTER.add()
    return dz1, dz2, dhc0, dpeep


def bwd_route(w_dtype, b, H, device=None) -> Tuple[bool, int]:
    """K4's static choice for weights of ``w_dtype`` at batch ``b`` and
    width ``H`` on ``device`` (the current card when None): whether it
    takes the tensor-core body (else the CUDA-core body), and the hidden
    units a block of that body takes (the grid has H / units blocks; 0 when
    no grid fits). Named by the C exports ``dl4j_lstm2_bwd_tc`` and
    ``dl4j_lstm2_bwd_units``; builds the kernel at first use, so it needs
    the card. On a CPU device the plain loop takes every shape: (False, H)."""
    if device is not None and torch.device(device).type == "cpu":
        return False, H
    w_bf16 = int(w_dtype == torch.bfloat16)
    lib = cuda_build.library(BWD_SOURCE, "dl4j_lstm2_bwd_tc", _ROUTE_ARGTYPES)
    cuda_build.library(BWD_SOURCE, "dl4j_lstm2_bwd_units", _ROUTE_ARGTYPES)
    return bool(lib.dl4j_lstm2_bwd_tc(w_bf16, b, H)), lib.dl4j_lstm2_bwd_units(w_bf16, b, H)


def lstm2_bwd(dy, g1, c1, g2, c2, rw1, w2, rw2, peep, c0, dhcT):
    """K4 on time-major inputs (shapes as :func:`lstm2_bwd_plain`). CUDA
    tensors launch the kernel (or raise); CPU tensors take the plain loop."""
    if dy.device.type == "cuda":
        return _lstm2_bwd_cuda(dy, g1, c1, g2, c2, rw1, w2, rw2, peep, c0, dhcT)
    if dy.device.type == "cpu":
        return lstm2_bwd_plain(dy, g1, c1, g2, c2, rw1, w2, rw2, peep, c0, dhcT)
    raise ValueError(f"lstm2_bwd: unsupported device {dy.device}")


class LSTM2Function(torch.autograd.Function):
    """``(ys2, hc) = lstm2(xp, rw1, w2, rw2, b2, peep, h0)`` on time-major
    inputs: K3 with the reserve forward, K4 backward (``_lstm2_fwd`` /
    ``_lstm2_bwd`` of the JAX package; ``b2`` is [4H] here, not the
    [8, 4H] row pack)."""

    @staticmethod
    def forward(ctx, xp, rw1, w2, rw2, b2, peep, h0):
        ys2, hc, ys1, g1, c1, g2, c2 = lstm2_fwd(xp, rw1, w2, rw2, b2, peep, h0,
                                                 save_reserve=True)
        ctx.save_for_backward(rw1, w2, rw2, peep, h0, ys1, ys2, g1, c1, g2, c2)
        return ys2, hc

    @staticmethod
    def backward(ctx, dys2, dhc):
        rw1, w2, rw2, peep, h0, ys1, ys2, g1, c1, g2, c2 = ctx.saved_tensors
        c0 = torch.stack([h0[1], h0[3]]).to(dys2.dtype)
        dz1, dz2, dhc0, dpeep = lstm2_bwd(dys2.contiguous(), g1, c1, g2, c2, rw1, w2, rw2,
                                          peep, c0, dhc.contiguous())
        # z1 = xp + h1_{t-1} @ RW1;  z2 = h1_t @ W2 + b2 + h2_{t-1} @ RW2
        h1_prev = torch.cat([h0[0][None].to(ys1.dtype), ys1[:-1]])
        h2_prev = torch.cat([h0[2][None].to(ys2.dtype), ys2[:-1]])
        wd = rw1.dtype
        return (dz1, weight_grad(h1_prev, dz1, wd), weight_grad(ys1, dz2, wd),
                weight_grad(h2_prev, dz2, wd), dz2.sum(dim=(0, 1)), dpeep, dhc0)


def lstm_scan2(xp1, rw1, peep1, w2, b2, rw2, peep2, h01, c01, h02, c02
               ) -> Tuple[torch.Tensor, Tuple, Tuple]:
    """Layer-facing entry, batch-major like the JAX ``lstm_scan2``:
    ``xp1`` [b, T, 4H] layer-1 projection (+bias), ``rw1``/``w2``/``rw2``
    [H, 4H] in the compute dtype, ``b2`` [4H] layer-2 bias, ``peep1``/
    ``peep2`` (pi, pf, po) or both None, ``h01``..``c02`` [b, H]. Returns
    (ys2 [b, T, H] f32, (h1T, c1T), (h2T, c2T); f64 for an f64 ``xp1``).
    While autograd records, the call goes through :class:`LSTM2Function`
    (K3 with reserve, K4); otherwise through the inference kernel."""
    if (peep1 is None) != (peep2 is None):
        raise ValueError("lstm_scan2: both layers need peepholes, or neither")
    sd = stream_dtype(xp1)
    pk = None
    if peep1 is not None:
        pk = pack_peepholes(tuple(peep1) + tuple(peep2), sd)
    h0 = torch.stack([h01.to(sd), c01.to(sd), h02.to(sd), c02.to(sd)]).contiguous()
    args = (xp1.transpose(0, 1).to(sd).contiguous(), rw1.contiguous(), w2.contiguous(),
            rw2.contiguous(), b2.to(sd).contiguous(), pk, h0)
    fn = LSTM2Function.apply if recording(*args) else lstm2_fwd
    ys2, hc = fn(*args)
    return ys2.transpose(0, 1), (hc[0], hc[1]), (hc[2], hc[3])
