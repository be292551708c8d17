"""Persistent-LSTM forward (K1) and its BPTT backward (K2), one layer.

Counterpart of ``deeplearning4j_tpu/ops/lstm_cell.py``: the inference
primal ``_lstm`` -> ``_fwd(save_reserve=False)``, the training forward
``_lstm_fwd`` -> ``_fwd`` with the BPTT reserve, and ``_lstm_bwd`` ->
``_bwd_call``. The CUDA kernels are ``csrc/lstm_cell.cu`` (K1) and
``csrc/lstm_cell_bwd.cu`` (K2); their source notes give the design. Each
has two bodies, chosen statically by its C entry: tensor cores for bf16
weights at b <= 64 (``csrc/lstm_hopper.cuh``), CUDA cores otherwise;
:func:`fwd_route` and :func:`bwd_route` name the choice. Beside
each is a plain PyTorch time loop (:func:`lstm_fwd_plain`,
:func:`lstm_bwd_plain`): a wrapper takes it for CPU tensors only, the
tests compare it with the JAX kernels, and ``chip_smoke.py`` holds the
CUDA kernel against it on the card.

Math (gate layout i|f|o|g, four contiguous H-blocks): ``z = xp_t +
bf16(h) @ RW`` accumulated in f32, Graves peepholes ``zi,zf += c*pi,pf``
and ``zo += c_new*po``, fractional step mask ``h = m*h_new + (1-m)*h``
(same for c). h, c, ys and the reserve stay f32; the caller casts ys to
its out dtype. Only tanh cell activation and sigmoid gates exist in the
kernels: :func:`supported` is the route predicate (the JAX package's
``lstm_cell.supported``), and a layer it declines runs the step loop of
``nn/layers/recurrent.py`` instead, decided before any launch.

:class:`LSTMFunction` is the autograd seam: its forward launches K1 with
the reserve (post-activation gates, post-mask c sequence), its backward
launches K2 and forms ``dRW = sum_t h_{t-1}^T dz_t`` and ``dxp = dz``
outside the kernel. :func:`lstm_scan` takes it whenever autograd records.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import cuda_build

__all__ = ["supported", "lstm_scan", "lstm_fwd", "lstm_fwd_plain", "lstm_bwd", "lstm_bwd_plain",
           "fwd_route", "bwd_route", "LSTMFunction", "COUNTER", "TRAIN_COUNTER",
           "BWD_COUNTER"]

SOURCE = "lstm_cell.cu"
BWD_SOURCE = "lstm_cell_bwd.cu"
COUNTER = cuda_build.Counter("lstm_fwd")              # K1, inference
TRAIN_COUNTER = cuda_build.Counter("lstm_fwd_train")  # K1 writing the reserve
BWD_COUNTER = cuda_build.Counter("lstm_bwd")          # K2
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 2 + [_I] + [_P] * 10 + [_I] * 3 + [_P]
_BWD_ARGTYPES = [_P] * 4 + [_I] + [_P] * 10 + [_I] * 3 + [_P]
_FWD_ROUTE_ARGTYPES = [_I] * 4   # (w_bf16, b, H, reserve)
_ROUTE_ARGTYPES = [_I] * 3       # (w_bf16, b, H)


def cell(z, c, H, peep):
    """One LSTM cell from pre-activations ``z`` [b, 4H] (i|f|o|g): returns
    (h_new, c_new, gates [b, 4H] post-activation). ``peep`` is [3, H]
    (pi, pf, po) or None."""
    zi, zf, zo, zg = z.split(H, dim=1)
    if peep is not None:
        zi = zi + c * peep[0]
        zf = zf + c * peep[1]
    i, f, g = torch.sigmoid(zi), torch.sigmoid(zf), torch.tanh(zg)
    c_new = f * c + i * g
    if peep is not None:
        zo = zo + c_new * peep[2]
    o = torch.sigmoid(zo)
    return o * torch.tanh(c_new), c_new, torch.cat([i, f, o, g], dim=1)


def cell_bwd(dh, dc, gates, c_cand, c_prev, H, peep):
    """BPTT of one cell (the math of the JAX ``_bwd_kernel``): ``dh``/``dc``
    reach h_t/c_t, ``gates`` [b, 4H] are the saved i|f|o|g, ``c_cand`` the
    pre-mask c_t. Returns (dz [b, 4H], dc_prev, peephole sums [3, H] over
    the batch or None)."""
    i, f, o, g = gates.split(H, dim=1)
    tc = torch.tanh(c_cand)
    dzo = dh * tc * o * (1.0 - o)
    dcc = dc + dh * o * (1.0 - tc * tc)
    if peep is not None:
        dcc = dcc + dzo * peep[2]
    dzi = dcc * g * i * (1.0 - i)
    dzf = dcc * c_prev * f * (1.0 - f)
    dzg = dcc * i * (1.0 - g * g)
    dc_prev = dcc * f
    dp = None
    if peep is not None:
        dc_prev = dc_prev + dzi * peep[0] + dzf * peep[1]
        dp = torch.stack([(dzi * c_prev).sum(0), (dzf * c_prev).sum(0),
                          (dzo * c_cand).sum(0)])
    return torch.cat([dzi, dzf, dzo, dzg], dim=1), dc_prev, dp


def lstm_fwd_plain(xp, rw, peep, mask, h0, c0, save_reserve=False):
    """Reference loop. ``xp`` [T, b, 4H], ``rw`` [H, 4H], ``peep`` [3, H] or
    None, ``mask`` [T, b] or None, ``h0``/``c0`` [b, H] -> (ys [T, b, H],
    hT, cT), plus (gates [T, b, 4H], cseq [T, b, H]) with ``save_reserve``.
    Everything is computed in xp's dtype (f32; f64 for gradient checks)."""
    T, b, H4 = xp.shape
    H = H4 // 4
    ad = xp.dtype
    rwa = rw.to(ad)
    h, c = h0.to(ad), c0.to(ad)
    ys = xp.new_empty((T, b, H))
    gates = xp.new_empty((T, b, H4)) if save_reserve else None
    cseq = xp.new_empty((T, b, H)) if save_reserve else None
    for t in range(T):
        # the gemm operand is h cast to RW's dtype; products of two bf16
        # values are exact in f32, so an f32 matmul is the f32 accumulation
        h_new, c_new, gts = cell(xp[t] + h.to(rw.dtype).to(ad) @ rwa, c, H, peep)
        if mask is not None:
            m = mask[t][:, None]
            h_new = m * h_new + (1.0 - m) * h
            c_new = m * c_new + (1.0 - m) * c
        ys[t] = h_new
        if save_reserve:
            gates[t] = gts
            cseq[t] = c_new
        h, c = h_new, c_new
    if save_reserve:
        return ys, h, c, gates, cseq
    return ys, h, c


def lstm_bwd_plain(dy, gates, cseq, rw, peep, mask, c0, dhT, dcT):
    """Reference reverse loop (the JAX ``_bwd_kernel``): ``dy`` [T, b, H],
    the reserve of :func:`lstm_fwd_plain`, ``rw`` [H, 4H], ``peep`` [3, H]
    or None, ``mask`` [T, b] or None, ``c0``/``dhT``/``dcT`` [b, H] ->
    (dz [T, b, 4H], dh0, dc0, dpeep [3, H] or None). dz is rounded to RW's
    dtype before the ``. RW^T`` product; the mask gets no gradient."""
    T, b, H = dy.shape
    ad = dy.dtype
    rwt = rw.to(ad).t()
    dh, dc = dhT.to(ad), dcT.to(ad)
    dz = dy.new_empty((T, b, 4 * H))
    dpeep = dy.new_zeros((3, H)) if peep is not None else None
    for t in reversed(range(T)):
        c_prev = cseq[t - 1] if t > 0 else c0.to(ad)
        dh_tot, dc_tot = dy[t] + dh, dc
        if mask is None:
            dh_c, dc_c, c_cand = dh_tot, dc_tot, cseq[t]
        else:
            # cseq holds the post-mask c; the forward's tanh and peephole
            # used the candidate, recomputed from the gates
            m = mask[t][:, None]
            dh_c, dc_c = m * dh_tot, m * dc_tot
            i, f, _, g = gates[t].split(H, dim=1)
            c_cand = f * c_prev + i * g
        dzt, dc_prev, dp = cell_bwd(dh_c, dc_c, gates[t], c_cand, c_prev, H, peep)
        dz[t] = dzt
        if dp is not None:
            dpeep += dp
        dh_prev = dzt.to(rw.dtype).to(ad) @ rwt
        if mask is not None:
            # only the straight-through (1-m) residual: dz already carries m
            dh_prev = dh_prev + (1.0 - m) * dh_tot
            dc_prev = dc_prev + (1.0 - m) * dc_tot
        dh, dc = dh_prev, dc_prev
    return dz, dh, dc, dpeep


def _check_cuda(name, t, shape, dtypes=(torch.float32,)):
    if t.device.type != "cuda" or t.dtype not in dtypes \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous CUDA tensor of shape "
                         f"{tuple(shape)} and dtype in {dtypes}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _same_device(what, ref, *ts):
    for t in ts:
        if t is not None and t.device != ref.device:
            raise ValueError(f"{what}: all tensors must be on one device")


def _lstm_fwd_cuda(xp, rw, peep, mask, h0, c0, save_reserve):
    T, b, H4 = xp.shape
    H = H4 // 4
    if H % 8:
        raise ValueError(f"the kernel needs H % 8 == 0, got H={H}")
    _check_cuda("xp", xp, (T, b, H4))
    _check_cuda("rw", rw, (H, H4), (torch.bfloat16, torch.float32))
    if peep is not None:
        _check_cuda("peep", peep, (3, H))
    if mask is not None:
        _check_cuda("mask", mask, (T, b))
    _check_cuda("h0", h0, (b, H))
    _check_cuda("c0", c0, (b, H))
    _same_device("lstm_fwd", xp, rw, peep, mask, h0, c0)
    f32 = dict(device=xp.device, dtype=torch.float32)
    ys = torch.empty((T, b, H), **f32)
    hT = torch.empty((b, H), **f32)
    cT = torch.empty((b, H), **f32)
    gates = torch.empty((T, b, H4), **f32) if save_reserve else None
    cseq = torch.empty((T, b, H), **f32) if save_reserve else None
    w_bf16 = rw.dtype == torch.bfloat16
    # the tensor-core body's bf16 h exchange (two slots)
    hx = torch.empty((2, b, H), device=xp.device, dtype=torch.bfloat16) if w_bf16 else None
    if T == 0:
        hT.copy_(h0)
        cT.copy_(c0)
    else:
        lib = cuda_build.library(SOURCE, "dl4j_lstm_fwd", _ARGTYPES)
        P = cuda_build.ptr
        code = lib.dl4j_lstm_fwd(P(xp), P(rw), int(w_bf16), P(peep), P(mask), P(h0), P(c0),
                                 P(hx), P(ys), P(gates), P(cseq), P(hT), P(cT), T, b, H,
                                 cuda_build.stream_of(xp))
        cuda_build.check(lib, code, "lstm_fwd kernel launch")
        (TRAIN_COUNTER if save_reserve else COUNTER).add()
    if save_reserve:
        return ys, hT, cT, gates, cseq
    return ys, hT, cT


def fwd_route(w_dtype, b, H, reserve=False) -> Tuple[bool, int]:
    """K1's static choice for weights of ``w_dtype`` at batch ``b`` and
    width ``H`` on the current card, for the serving instantiation or, with
    ``reserve``, the training one: whether it takes the tensor-core body
    (else the CUDA-core body), and the hidden units a block of that body
    takes (the grid has H / units blocks). Named by the C exports
    ``dl4j_lstm_fwd_tc`` and ``dl4j_lstm_fwd_units``; builds the kernel at
    first use, so it needs the card."""
    args = (int(w_dtype == torch.bfloat16), b, H, int(reserve))
    lib = cuda_build.library(SOURCE, "dl4j_lstm_fwd_tc", _FWD_ROUTE_ARGTYPES)
    cuda_build.library(SOURCE, "dl4j_lstm_fwd_units", _FWD_ROUTE_ARGTYPES)
    return bool(lib.dl4j_lstm_fwd_tc(*args)), lib.dl4j_lstm_fwd_units(*args)


def bwd_route(w_dtype, b, H) -> Tuple[bool, int]:
    """K2's static choice for weights of ``w_dtype`` at batch ``b`` and
    width ``H`` on the current card, as :func:`fwd_route`; named by the C
    exports ``dl4j_lstm_bwd_tc`` and ``dl4j_lstm_bwd_units``."""
    w_bf16 = int(w_dtype == torch.bfloat16)
    lib = cuda_build.library(BWD_SOURCE, "dl4j_lstm_bwd_tc", _ROUTE_ARGTYPES)
    cuda_build.library(BWD_SOURCE, "dl4j_lstm_bwd_units", _ROUTE_ARGTYPES)
    return bool(lib.dl4j_lstm_bwd_tc(w_bf16, b, H)), lib.dl4j_lstm_bwd_units(w_bf16, b, H)


def supported(b: int, T: int, H: int, activation: str, gate_activation: str,
              device) -> bool:
    """Whether a layer of this shape and these activations on ``device``
    runs through K1/K2 (:func:`lstm_scan`): the kernels, and their plain
    versions on the CPU, hard-code a tanh cell and sigmoid gates; on the
    card the kernels also need H % 8 == 0 (every b and T has a grid).
    A layer this declines takes the step loop; a CUDA tensor this admits
    launches the kernels or raises."""
    if str(activation).lower() != "tanh" or str(gate_activation).lower() != "sigmoid":
        return False
    kind = torch.device(device).type
    if kind == "cuda":
        return H % 8 == 0
    return kind == "cpu"


def lstm_fwd(xp, rw, peep, mask, h0, c0, save_reserve=False):
    """K1 on time-major inputs (shapes as :func:`lstm_fwd_plain`). CUDA
    tensors launch the kernel (or raise); CPU tensors take the plain loop.
    ``save_reserve`` also returns the BPTT reserve (gates, cseq); without
    it the kernel writes no reserve."""
    if xp.device.type == "cuda":
        return _lstm_fwd_cuda(xp, rw, peep, mask, h0, c0, save_reserve)
    if xp.device.type == "cpu":
        return lstm_fwd_plain(xp, rw, peep, mask, h0, c0, save_reserve)
    raise ValueError(f"lstm_fwd: unsupported device {xp.device}")


def _lstm_bwd_cuda(dy, gates, cseq, rw, peep, mask, c0, dhT, dcT):
    T, b, H = dy.shape
    H4 = 4 * H
    if H % 8:
        raise ValueError(f"the kernel needs H % 8 == 0, got H={H}")
    _check_cuda("dy", dy, (T, b, H))
    _check_cuda("gates", gates, (T, b, H4))
    _check_cuda("cseq", cseq, (T, b, H))
    _check_cuda("rw", rw, (H, H4), (torch.bfloat16, torch.float32))
    if peep is not None:
        _check_cuda("peep", peep, (3, H))
    if mask is not None:
        _check_cuda("mask", mask, (T, b))
    for name, t in (("c0", c0), ("dhT", dhT), ("dcT", dcT)):
        _check_cuda(name, t, (b, H))
    _same_device("lstm_bwd", dy, gates, cseq, rw, peep, mask, c0, dhT, dcT)
    f32 = dict(device=dy.device, dtype=torch.float32)
    dz = torch.empty((T, b, H4), **f32)
    dh0 = torch.empty((b, H), **f32)
    dc0 = torch.empty((b, H), **f32)
    dpeep = torch.zeros((3, H), **f32) if peep is not None else None
    if T == 0:
        dh0.copy_(dhT)
        dc0.copy_(dcT)
        return dz, dh0, dc0, dpeep
    dzx = torch.empty((2, b, H4), device=dy.device, dtype=rw.dtype)   # dz exchange
    lib = cuda_build.library(BWD_SOURCE, "dl4j_lstm_bwd", _BWD_ARGTYPES)
    P = cuda_build.ptr
    code = lib.dl4j_lstm_bwd(P(dy), P(gates), P(cseq), P(rw), int(rw.dtype == torch.bfloat16),
                             P(peep), P(mask), P(c0), P(dhT), P(dcT), P(dzx), P(dz), P(dh0),
                             P(dc0), P(dpeep), T, b, H, cuda_build.stream_of(dy))
    cuda_build.check(lib, code, "lstm_bwd kernel launch")
    BWD_COUNTER.add()
    return dz, dh0, dc0, dpeep


def lstm_bwd(dy, gates, cseq, rw, peep, mask, c0, dhT, dcT):
    """K2 on time-major inputs (shapes as :func:`lstm_bwd_plain`). CUDA
    tensors launch the kernel (or raise); CPU tensors take the plain loop."""
    if dy.device.type == "cuda":
        return _lstm_bwd_cuda(dy, gates, cseq, rw, peep, mask, c0, dhT, dcT)
    if dy.device.type == "cpu":
        return lstm_bwd_plain(dy, gates, cseq, rw, peep, mask, c0, dhT, dcT)
    raise ValueError(f"lstm_bwd: unsupported device {dy.device}")


def weight_grad(a, dz, wdtype):
    """``sum_t a_t^T dz_t`` for ``a`` [T, b, n], ``dz`` [T, b, 4H]: operands
    rounded to the weight dtype, products accumulated in dz's dtype (exact
    products of bf16 values in f32), result rounded to the weight dtype,
    as the JAX backward's einsum with ``preferred_element_type=f32``."""
    ad = dz.dtype
    a2 = a.reshape(-1, a.shape[-1]).to(wdtype).to(ad)
    d2 = dz.reshape(-1, dz.shape[-1]).to(wdtype).to(ad)
    return (a2.t() @ d2).to(wdtype)


class LSTMFunction(torch.autograd.Function):
    """``(ys, hT, cT) = lstm(xp, rw, peep, h0, c0, mask)`` on time-major
    inputs, differentiable in everything but the mask: K1 with the reserve
    forward, K2 backward (``_lstm_fwd`` / ``_lstm_bwd`` of the JAX
    package)."""

    @staticmethod
    def forward(ctx, xp, rw, peep, h0, c0, mask):
        ys, hT, cT, gates, cseq = lstm_fwd(xp, rw, peep, mask, h0, c0, save_reserve=True)
        ctx.save_for_backward(rw, peep, h0, c0, mask, ys, gates, cseq)
        return ys, hT, cT

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        rw, peep, h0, c0, mask, ys, gates, cseq = ctx.saved_tensors
        dz, dh0, dc0, dpeep = lstm_bwd(dys.contiguous(), gates, cseq, rw, peep, mask, c0,
                                       dhT.contiguous(), dcT.contiguous())
        # z_t = xp_t + h_{t-1} @ RW  ->  dxp = dz,  dRW = sum_t h_{t-1}^T dz_t
        h_prev = torch.cat([h0[None].to(ys.dtype), ys[:-1]])
        return dz, weight_grad(h_prev, dz, rw.dtype), dpeep, dh0, dc0, None


def stream_dtype(t) -> torch.dtype:
    """The streams' and states' dtype for a projection ``t``: f32 (the
    kernels'), and f64 for a float64 network (a gradient check on the
    CPU; a CUDA tensor in f64 raises at the kernel)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def pack_peepholes(peep: Optional[Sequence[torch.Tensor]], dtype=torch.float32):
    """(pi, pf, po) -> one contiguous [3, H] tensor of ``dtype``, or None."""
    if peep is None:
        return None
    return torch.stack([p.to(dtype) for p in peep]).contiguous()


def recording(*ts) -> bool:
    """Whether autograd records an operation on these tensors."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


def lstm_scan(xp, rw, peep, h0, c0, mask=None
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Layer-facing entry, batch-major like the JAX ``lstm_scan``: ``xp``
    [b, T, 4H] hoisted input projection (+bias), ``rw`` [H, 4H] in the
    compute dtype, ``peep`` (pi, pf, po) or None, ``h0``/``c0`` [b, H],
    ``mask`` [b, T] (values in [0, 1], data: it gets no gradient) or None.
    Returns (ys [b, T, H] f32, (hT, cT) f32; f64 for an f64 ``xp``). While
    autograd records, the call goes through :class:`LSTMFunction` (K1 with
    reserve, K2); otherwise through the inference kernel, which writes no
    reserve."""
    sd = stream_dtype(xp)
    xp_tm = xp.transpose(0, 1).to(sd).contiguous()
    mk = None if mask is None else mask.detach().to(sd).transpose(0, 1).contiguous()
    args = (xp_tm, rw.contiguous(), pack_peepholes(peep, sd), h0.to(sd).contiguous(),
            c0.to(sd).contiguous())
    if recording(*args):
        ys, hT, cT = LSTMFunction.apply(*args, mk)
    else:
        xpa, rwa, pk, h0a, c0a = args
        ys, hT, cT = lstm_fwd(xpa, rwa, pk, mk, h0a, c0a)
    return ys.transpose(0, 1), (hT, cT)
