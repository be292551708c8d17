"""Persistent-LSTM forward (K1): one layer's whole time loop in one kernel.

Counterpart of ``deeplearning4j_tpu/ops/lstm_cell.py`` (its inference
primal ``_lstm`` -> ``_fwd(save_reserve=False)``). The CUDA kernel is
``csrc/lstm_cell.cu``; its source note gives the design. Beside it is
:func:`lstm_fwd_plain`, the same arithmetic as a PyTorch time loop: the
wrapper takes it for CPU tensors only, the tests compare it with the JAX
kernel, and ``chip_smoke.py`` holds the CUDA kernel against it on the card.

Math (gate layout i|f|o|g, four contiguous H-blocks): ``z = xp_t +
bf16(h) @ RW`` accumulated in f32, Graves peepholes ``zi,zf += c*pi,pf``
and ``zo += c_new*po``, fractional step mask ``h = m*h_new + (1-m)*h``
(same for c). h, c and ys stay f32; the caller casts ys to its out dtype.
Only tanh cell activation and sigmoid gates exist in the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import cuda_build

__all__ = ["lstm_scan", "lstm_fwd", "lstm_fwd_plain", "COUNTER"]

SOURCE = "lstm_cell.cu"
COUNTER = cuda_build.Counter("lstm_fwd")
_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 7
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def lstm_fwd_plain(xp, rw, peep, mask, h0, c0):
    """Reference loop. ``xp`` [T, b, 4H] f32, ``rw`` [H, 4H], ``peep``
    [3, H] f32 or None, ``mask`` [T, b] f32 or None, ``h0``/``c0`` [b, H]
    f32 -> (ys [T, b, H], hT, cT), all f32."""
    T, b, H4 = xp.shape
    H = H4 // 4
    rwf = rw.float()
    h, c = h0.float(), c0.float()
    ys = xp.new_empty((T, b, H))
    for t in range(T):
        # the gemm operand is h cast to RW's dtype; products of two bf16
        # values are exact in f32, so an f32 matmul is the f32 accumulation
        z = xp[t] + h.to(rw.dtype).float() @ rwf
        zi, zf, zo, zg = z.split(H, dim=1)
        if peep is not None:
            zi = zi + c * peep[0]
            zf = zf + c * peep[1]
        i, f, g = torch.sigmoid(zi), torch.sigmoid(zf), torch.tanh(zg)
        c_new = f * c + i * g
        if peep is not None:
            zo = zo + c_new * peep[2]
        h_new = torch.sigmoid(zo) * torch.tanh(c_new)
        if mask is not None:
            m = mask[t][:, None]
            h_new = m * h_new + (1.0 - m) * h
            c_new = m * c_new + (1.0 - m) * c
        ys[t] = h_new
        h, c = h_new, c_new
    return ys, h, c


def _check_cuda(name, t, shape, dtypes=(torch.float32,)):
    if t.device.type != "cuda" or t.dtype not in dtypes \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous CUDA tensor of shape "
                         f"{tuple(shape)} and dtype in {dtypes}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _lstm_fwd_cuda(xp, rw, peep, mask, h0, c0):
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
    for t in (rw, peep, mask, h0, c0):
        if t is not None and t.device != xp.device:
            raise ValueError("lstm_fwd: all tensors must be on one device")
    ys = torch.empty((T, b, H), device=xp.device, dtype=torch.float32)
    hT = torch.empty((b, H), device=xp.device, dtype=torch.float32)
    cT = torch.empty((b, H), device=xp.device, dtype=torch.float32)
    if T == 0:
        return ys, h0.clone(), c0.clone()
    lib = cuda_build.library(SOURCE, "dl4j_lstm_fwd", _ARGTYPES)
    P = cuda_build.ptr
    code = lib.dl4j_lstm_fwd(P(xp), P(rw), int(rw.dtype == torch.bfloat16), P(peep), P(mask),
              P(h0), P(c0), P(ys), P(hT), P(cT), T, b, H,
              cuda_build.stream_of(xp))
    cuda_build.check(lib, code, "lstm_fwd kernel launch")
    COUNTER.add()
    return ys, hT, cT


def lstm_fwd(xp, rw, peep, mask, h0, c0):
    """K1 on time-major inputs (shapes as :func:`lstm_fwd_plain`). CUDA
    tensors launch the kernel (or raise); CPU tensors take the plain loop."""
    if xp.device.type == "cuda":
        return _lstm_fwd_cuda(xp, rw, peep, mask, h0, c0)
    if xp.device.type == "cpu":
        return lstm_fwd_plain(xp, rw, peep, mask, h0, c0)
    raise ValueError(f"lstm_fwd: unsupported device {xp.device}")


def pack_peepholes(peep: Optional[Sequence[torch.Tensor]]):
    """(pi, pf, po) -> one contiguous [3, H] f32 tensor, or None."""
    if peep is None:
        return None
    return torch.stack([p.float() for p in peep]).contiguous()


def lstm_scan(xp, rw, peep, h0, c0, mask=None
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Layer-facing entry, batch-major like the JAX ``lstm_scan``: ``xp``
    [b, T, 4H] hoisted input projection (+bias), ``rw`` [H, 4H] in the
    compute dtype, ``peep`` (pi, pf, po) or None, ``h0``/``c0`` [b, H],
    ``mask`` [b, T] (values in [0, 1]) or None. Returns (ys [b, T, H] f32,
    (hT, cT) f32)."""
    xp_tm = xp.transpose(0, 1).float().contiguous()
    mk = None if mask is None else mask.float().transpose(0, 1).contiguous()
    ys, hT, cT = lstm_fwd(xp_tm, rw.contiguous(), pack_peepholes(peep), mk,
                          h0.float().contiguous(), c0.float().contiguous())
    return ys.transpose(0, 1), (hT, cT)
