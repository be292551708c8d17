"""Fused two-layer persistent-LSTM forward (K3): a stacked pair in one kernel.

Counterpart of ``deeplearning4j_tpu/ops/lstm_fused.py`` (its inference
primal ``_lstm2`` -> ``_fwd2(save_reserve=False)``). The CUDA kernel is
``csrc/lstm_fused.cu``; its source note gives the design. Beside it is
:func:`lstm2_fwd_plain`, the same arithmetic as a PyTorch time loop (CPU
tensors, the tests, and ``chip_smoke.py``'s oracle on the card).

Math: layer 1 is the K1 cell without a mask; layer 2's pre-activation is
``b2 + bf16(h1) @ W2 + bf16(h2) @ RW2``, both products accumulated in f32.
Step masks never reach this kernel: masked pairs run K1 per layer.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import cuda_build
from .lstm_cell import _check_cuda, pack_peepholes

__all__ = ["lstm_scan2", "lstm2_fwd", "lstm2_fwd_plain", "COUNTER"]

SOURCE = "lstm_fused.cu"
COUNTER = cuda_build.Counter("lstm2_fwd")
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 6
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _cell(z, c, H, peep):
    zi, zf, zo, zg = z.split(H, dim=1)
    if peep is not None:
        zi = zi + c * peep[0]
        zf = zf + c * peep[1]
    i, f, g = torch.sigmoid(zi), torch.sigmoid(zf), torch.tanh(zg)
    c_new = f * c + i * g
    if peep is not None:
        zo = zo + c_new * peep[2]
    return torch.sigmoid(zo) * torch.tanh(c_new), c_new


def lstm2_fwd_plain(xp, rw1, w2, rw2, b2, peep, h0):
    """Reference loop. ``xp`` [T, b, 4H] f32, ``rw1``/``w2``/``rw2`` [H, 4H]
    (one dtype), ``b2`` [4H] f32, ``peep`` [6, H] f32 (rows 0-2 layer 1,
    3-5 layer 2) or None, ``h0`` [4, b, H] f32 (h1, c1, h2, c2) ->
    (ys2 [T, b, H], hc [4, b, H]), f32."""
    T, b, H4 = xp.shape
    H = H4 // 4
    wd = rw1.dtype
    rw1f, w2f, rw2f = rw1.float(), w2.float(), rw2.float()
    p1 = None if peep is None else peep[0:3]
    p2 = None if peep is None else peep[3:6]
    h1, c1, h2, c2 = (h0[k].float() for k in range(4))
    ys2 = xp.new_empty((T, b, H))
    for t in range(T):
        h1, c1 = _cell(xp[t] + h1.to(wd).float() @ rw1f, c1, H, p1)
        z2 = (b2 + h1.to(wd).float() @ w2f) + h2.to(wd).float() @ rw2f
        h2, c2 = _cell(z2, c2, H, p2)
        ys2[t] = h2
    return ys2, torch.stack([h1, c1, h2, c2])


def _lstm2_fwd_cuda(xp, rw1, w2, rw2, b2, peep, h0):
    T, b, H4 = xp.shape
    H = H4 // 4
    if H % 8:
        raise ValueError(f"the kernel needs H % 8 == 0, got H={H}")
    _check_cuda("xp", xp, (T, b, H4))
    wdt = (torch.bfloat16, torch.float32)
    for name, w in (("rw1", rw1), ("w2", w2), ("rw2", rw2)):
        _check_cuda(name, w, (H, H4), wdt)
        if w.dtype != rw1.dtype:
            raise ValueError("lstm2_fwd: rw1, w2 and rw2 must share a dtype")
    _check_cuda("b2", b2, (H4,))
    if peep is not None:
        _check_cuda("peep", peep, (6, H))
    _check_cuda("h0", h0, (4, b, H))
    for t in (rw1, w2, rw2, b2, peep, h0):
        if t is not None and t.device != xp.device:
            raise ValueError("lstm2_fwd: all tensors must be on one device")
    ys2 = torch.empty((T, b, H), device=xp.device, dtype=torch.float32)
    if T == 0:
        return ys2, h0.clone()
    hc = torch.empty((4, b, H), device=xp.device, dtype=torch.float32)
    hx = torch.empty((2, b, H), device=xp.device, dtype=torch.float32)
    lib = cuda_build.library(SOURCE, "dl4j_lstm2_fwd", _ARGTYPES)
    P = cuda_build.ptr
    code = lib.dl4j_lstm2_fwd(P(xp), P(rw1), P(w2), P(rw2), int(rw1.dtype == torch.bfloat16),
              P(b2), P(peep), P(h0), P(hx), P(ys2), P(hc), T, b, H,
              cuda_build.stream_of(xp))
    cuda_build.check(lib, code, "lstm2_fwd kernel launch")
    COUNTER.add()
    return ys2, hc


def lstm2_fwd(xp, rw1, w2, rw2, b2, peep, h0):
    """K3 on time-major inputs (shapes as :func:`lstm2_fwd_plain`). CUDA
    tensors launch the kernel (or raise); CPU tensors take the plain loop."""
    if xp.device.type == "cuda":
        return _lstm2_fwd_cuda(xp, rw1, w2, rw2, b2, peep, h0)
    if xp.device.type == "cpu":
        return lstm2_fwd_plain(xp, rw1, w2, rw2, b2, peep, h0)
    raise ValueError(f"lstm2_fwd: unsupported device {xp.device}")


def lstm_scan2(xp1, rw1, peep1, w2, b2, rw2, peep2, h01, c01, h02, c02
               ) -> Tuple[torch.Tensor, Tuple, Tuple]:
    """Layer-facing entry, batch-major like the JAX ``lstm_scan2``:
    ``xp1`` [b, T, 4H] layer-1 projection (+bias), ``rw1``/``w2``/``rw2``
    [H, 4H] in the compute dtype, ``b2`` [4H] layer-2 bias, ``peep1``/
    ``peep2`` (pi, pf, po) or both None, ``h01``..``c02`` [b, H]. Returns
    (ys2 [b, T, H] f32, (h1T, c1T), (h2T, c2T))."""
    if (peep1 is None) != (peep2 is None):
        raise ValueError("lstm_scan2: both layers need peepholes, or neither")
    xp_tm = xp1.transpose(0, 1).float().contiguous()
    pk = None
    if peep1 is not None:
        pk = pack_peepholes(tuple(peep1) + tuple(peep2))
    h0 = torch.stack([h01.float(), c01.float(), h02.float(), c02.float()])
    ys2, hc = lstm2_fwd(xp_tm, rw1.contiguous(), w2.contiguous(),
                        rw2.contiguous(), b2.float().contiguous(), pk,
                        h0.contiguous())
    return ys2.transpose(0, 1), (hc[0], hc[1]), (hc[2], hc[3])
