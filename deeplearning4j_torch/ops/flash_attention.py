"""Flash attention: forward (K5) and backward (K6 dq, K7 dk/dv).

Counterpart of ``deeplearning4j_tpu/ops/flash_attention.py``. The CUDA
kernels are ``csrc/flash_attn_fwd.cu`` (K5: ``_fwd_kernel``/``_fwd``),
``csrc/flash_attn_dq.cu`` (K6: ``_dq_kernel``/``dq_block``) and
``csrc/flash_attn_dkv.cu`` (K7: ``_dkv_kernel``/``dkv_block``); their
source notes give the design. Beside
each is a plain PyTorch version of the same math (:func:`flash_fwd_plain`,
:func:`flash_dq_plain`, :func:`flash_dkv_plain`): a wrapper takes it for
CPU tensors only, the tests compare it with the JAX kernels, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.

Kernel operands are [bh, T, d] (batch x heads flattened) in one type, bf16
or f32; the log-sum-exp and delta are [bh, T] f32 and the key mask [bh, Tk]
f32 (1 = a real key). The JAX package lane-pads those three to [..., 8] for
the TPU's tiling; the port does not. The public :func:`flash_attention`
takes the layer's [b, T, h, d].

Semantics kept from the TPU kernels: s = (q . k^T) * scale in f32 from
operands in their own type; p rounded to v's type before p . v, ds and pd
to the operand type before their products; masked logits are -1e30; a
query row with no visible key gives o = 0, lse = -1e30 and exactly zero
gradients; attention dropout applies to the normalised probabilities, its
keep decision the counter hash :func:`_keep_from_coords` over global
positions (q_off + i, k_off + j), bit for bit the JAX package's.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import cuda_build

__all__ = ["flash_attention", "flash_fwd", "dq_block", "dkv_block", "flash_fwd_plain",
           "flash_dq_plain", "flash_dkv_plain", "FlashFunction", "rowwise_delta",
           "normalize_operand_dtypes", "dropout_keep_mask", "seed3", "supported",
           "pick_block", "MIN_SEQ", "MIN_BLOCK", "FWD_COUNTER", "DQ_COUNTER",
           "DKV_COUNTER"]

FWD_SOURCE = "flash_attn_fwd.cu"
DQ_SOURCE = "flash_attn_dq.cu"
DKV_SOURCE = "flash_attn_dkv.cu"
FWD_COUNTER = cuda_build.Counter("flash_fwd")   # K5
DQ_COUNTER = cuda_build.Counter("flash_dq")     # K6
DKV_COUNTER = cuda_build.Counter("flash_dkv")   # K7
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGTYPES = [_P] * 6 + [_I] * 4 + [_F, _I, _F, _F] + [_I] * 3 + [_P]
_DQ_ARGTYPES = [_P] * 8 + [_I] * 5 + [_F, _I, _F, _F] + [_I] * 3 + [_P]
_DKV_ARGTYPES = [_P] * 9 + [_I] * 5 + [_F, _I, _F, _F] + [_I] * 3 + [_P]
#: ``dl4j_flash_fwd_wgmma``/``dl4j_flash_bwd_wgmma(is_bf16, d)``: the route
#: the kernels' C entries take (1: wgmma/TMA, 0: mma.sync / CUDA cores).
_ROUTE_ARGTYPES = [_I, _I]

_NEG = -1e30
MIN_BLOCK = 128
#: The JAX package's q/k block cap (its import-time ``DL4J_TPU_FLASH_BLOCK``
#: knob at its default); the port's kernels tile by 64 rows on their own.
BLOCK = 128
#: Below this sequence length ``mha`` takes the dense path (the JAX routing
#: contract; the threshold was set on a TPU and is not re-measured here).
MIN_SEQ = 4096
#: Tests flip this to take the flash route from T = 2 * MIN_BLOCK, as the
#: JAX package's ``_FORCE_INTERPRET`` does for its own tests.
_FORCE_SHORT_SEQ = False


def pick_block(T: int, d: int) -> int:
    """Largest 128-multiple <= ``BLOCK`` that divides ``T``, within the TPU
    VMEM budget (``blk * d <= 64k`` elements, ``12 * blk^2 <= 8 MB``): the
    block the JAX kernels tile by. Dropout hashes global positions, so the
    block never changes a result."""
    cap = min(BLOCK, T)
    cap -= cap % MIN_BLOCK
    while cap > MIN_BLOCK and (cap * d > 65536 or 12 * cap * cap > 8 * 2 ** 20):
        cap -= MIN_BLOCK
    for b in range(cap, MIN_BLOCK, -MIN_BLOCK):
        if T % b == 0:
            return b
    return MIN_BLOCK


def supported(T: int, d: int, dropout_rate: float, key_mask) -> bool:
    """Whether the flash path applies: a block-divisible sequence of at
    least ``MIN_SEQ``, head dim <= 256, a [b, T] key mask if any, and a
    dropout rate in [0, 1)."""
    min_seq = 2 * MIN_BLOCK if _FORCE_SHORT_SEQ else MIN_SEQ
    if key_mask is not None and getattr(key_mask, "ndim", None) != 2:
        return False
    return (T % MIN_BLOCK == 0 and T >= min_seq and d <= 256
            and 0.0 <= dropout_rate < 1.0)


# ---------------------------------------------------------------- dropout RNG
# The keep decision for cell (bh, qpos, kpos) is a pure function of the
# seed and the global coordinates, so the forward and both backward kernels
# regenerate the same mask with no [T, T] mask in memory. The hash is
# murmur3's fmix32 in uint32 arithmetic. Here it runs in int64 holding
# values in [0, 2^32): shifts of non-negative int64 are logical, and each
# 32-bit product is formed from 16-bit halves so that no int64 overflows.
_M32 = 0xFFFFFFFF
_PHI = 0x9E3779B9      # golden-ratio odd constant
_FMIX1 = 0x85EBCA6B    # murmur3 fmix32
_FMIX2 = 0xC2B2AE35
_FNV = 0x01000193      # FNV prime: row stride > any kpos


def _mul32(h, c: int):
    """(h * c) mod 2^32 for int64 ``h`` in [0, 2^32) and a 32-bit constant."""
    return ((h & 0xFFFF) * c + ((((h >> 16) * c) & 0xFFFF) << 16)) & _M32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, _FMIX1)
    h = h ^ (h >> 13)
    h = _mul32(h, _FMIX2)
    return h ^ (h >> 16)


def _keep_from_coords(seed, bh, qpos, kpos, rate):
    """Keep mask (bool, broadcast shape of the int64 ``qpos``/``kpos``) for
    cells at global coordinates: the JAX package's ``_keep_from_coords``
    bit for bit. ``seed`` and ``bh`` are ints (the per-bh part is hashed
    in Python integers); positions wrap at 32 bits as int32 arithmetic
    does."""
    h = _fmix32((int(seed) & _M32) ^ ((int(bh) * _PHI) & _M32))
    qpos, kpos = qpos & _M32, kpos & _M32
    x = _fmix32(h ^ ((_mul32(qpos, _FNV) + kpos) & _M32))
    x = _fmix32(x ^ _mul32(kpos, _PHI))
    u = (x & 0x7FFFFF).to(torch.float32) * (1.0 / (1 << 23))
    return u >= torch.tensor(rate, dtype=torch.float32)


def seed3(seed, q_off=0, k_off=0) -> Tuple[int, int, int]:
    """The kernels' dropout operand: (seed, global q offset, global k
    offset), as int32 values."""
    def i32(x):
        x = int(x) & _M32
        return x - (1 << 32) if x >= 1 << 31 else x
    return i32(seed), i32(q_off), i32(k_off)


def _keep(seed, i, Tq, Tk, rate, device):
    """[Tq, Tk] keep mask of batch x head ``i``; ``seed`` is :func:`seed3`."""
    s, q_off, k_off = seed
    qpos = torch.arange(Tq, dtype=torch.int64, device=device)[:, None] + int(q_off)
    kpos = torch.arange(Tk, dtype=torch.int64, device=device)[None, :] + int(k_off)
    return _keep_from_coords(s, i, qpos, kpos, rate)


def dropout_keep_mask(bh, Tq, Tk, seed, rate, q_off=0, k_off=0, device="cpu"):
    """The exact [bh, Tq, Tk] keep mask (bool) the kernels regenerate
    tile by tile: a test oracle (O(T^2) memory)."""
    return torch.stack([_keep((seed, q_off, k_off), i, Tq, Tk, rate, device)
                        for i in range(bh)])


# ------------------------------------------------------------ plain versions
def _acc(t):
    """The plain versions' arithmetic type: f32 (f64 for f64 operands, as
    gradient checks use)."""
    return torch.promote_types(t.dtype, torch.float32)


def _scores(q, k, km, causal, scale):
    """Masked logits of one bh: [Tq, d] x [Tk, d] -> [Tq, Tk]. Products of
    two values of the operand type are exact in f32, so an f32 product is
    the kernels' f32 accumulation (the card runs it with TF32 off)."""
    a = _acc(q)
    s = (q.to(a) @ k.to(a).t()) * scale
    if causal:
        Tq, Tk = s.shape
        qpos = torch.arange(Tq, device=s.device)[:, None]
        kpos = torch.arange(Tk, device=s.device)[None, :]
        s = torch.where(kpos <= qpos, s, torch.full_like(s, _NEG))
    if km is not None:
        s = torch.where(km[None, :] > 0, s, torch.full_like(s, _NEG))
    return s


def _drop_scale(rate):
    return 1.0 / (1.0 - rate)


def flash_fwd_plain(q, k, v, km, causal, scale, rate=0.0, seed=None):
    """Reference forward, one bh at a time (the card's memory holds one
    [T, T] f32 score matrix at T = 8192, not 32). ``q``/``k``/``v`` [bh, T,
    d], ``km`` [bh, T] or None, ``seed`` :func:`seed3` when ``rate`` > 0 ->
    (o [bh, T, d] in q's type, lse [bh, T] f32)."""
    bh, T, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, T), dtype=_acc(q), device=q.device)
    for i in range(bh):
        s = _scores(q[i], k[i], None if km is None else km[i], causal, scale)
        m = s.max(dim=-1).values
        p = torch.exp(s - m[:, None])
        l = torch.clamp(p.sum(dim=-1), min=1e-30)
        if rate > 0.0:
            p = p * _keep(seed, i, T, T, rate, q.device) * _drop_scale(rate)
        acc = p.to(v.dtype).to(p.dtype) @ v[i].to(p.dtype)
        valid = m > _NEG * 0.5
        o[i] = (acc * (valid.to(p.dtype) / l)[:, None]).to(q.dtype)
        lse[i] = torch.where(valid, m + torch.log(l), torch.full_like(m, _NEG))
    return o, lse


def _probs_and_ds(q, k, v, km, do, delta, lse, causal, scale, keep, rate):
    """One bh of the backward: (p, ds) from the saved lse/delta, with the
    s-guard of the TPU kernels (cells at -1e30 get p = 0)."""
    s = _scores(q, k, km, causal, scale)
    p = torch.where(s > _NEG * 0.5, torch.exp(s - lse[:, None]), torch.zeros_like(s))
    dp = do.to(s.dtype) @ v.to(s.dtype).t()
    if keep is not None:
        dp = dp * keep * _drop_scale(rate)
    return p, p * (dp - delta[:, None]) * scale


def flash_dq_plain(q, k, v, km, do, delta, lse, causal, scale, seed=None, rate=0.0):
    """Reference dq (the math of ``_dq_kernel``), one bh at a time: ``q``,
    ``do`` [bh, Tq, d]; ``k``, ``v`` [bh, Tk, d]; ``delta``, ``lse`` [bh, Tq]
    f32 (global: see :func:`dq_block`) -> dq in q's type."""
    bh, Tq, _ = q.shape
    Tk = k.shape[1]
    dq = torch.empty_like(q)
    for i in range(bh):
        keep = _keep(seed, i, Tq, Tk, rate, q.device) if rate > 0.0 else None
        _, ds = _probs_and_ds(q[i], k[i], v[i], None if km is None else km[i], do[i], delta[i],
                              lse[i], causal, scale, keep, rate)
        dq[i] = (ds.to(k.dtype).to(ds.dtype) @ k[i].to(ds.dtype)).to(q.dtype)
    return dq


def flash_dkv_plain(q, k, v, km, do, delta, lse, causal, scale, seed=None, rate=0.0):
    """Reference (dk, dv) (the math of ``_dkv_kernel``), shapes as
    :func:`flash_dq_plain`."""
    bh, Tq, _ = q.shape
    Tk = k.shape[1]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for i in range(bh):
        keep = _keep(seed, i, Tq, Tk, rate, q.device) if rate > 0.0 else None
        p, ds = _probs_and_ds(q[i], k[i], v[i], None if km is None else km[i], do[i], delta[i],
                              lse[i], causal, scale, keep, rate)
        pd = p if keep is None else p * keep * _drop_scale(rate)
        dv[i] = (pd.to(do.dtype).to(pd.dtype).t() @ do[i].to(pd.dtype)).to(v.dtype)
        dk[i] = (ds.to(q.dtype).to(ds.dtype).t() @ q[i].to(ds.dtype)).to(k.dtype)
    return dk, dv


# ------------------------------------------------------------------ wrappers
def _check_cuda(name, t, shape, dtypes):
    if t.device.type != "cuda" or t.dtype not in dtypes or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a contiguous, 16-byte aligned CUDA tensor of shape "
                         f"{tuple(shape)} and dtype in {dtypes}, got {tuple(t.shape)} {t.dtype} "
                         f"on {t.device}")


def _common_checks(what, q, k, km, extra=()):
    bh, Tq, d = q.shape
    Tk = k.shape[1]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: the kernel takes bf16 or f32 operands, got {q.dtype}")
    if Tq % 64 or Tk % 64 or d > 256 or (q.dtype == torch.float32 and d > 128):
        raise ValueError(f"{what}: the kernel needs T % 64 == 0 and d <= 256 (d <= 128 for f32),"
                         f" got Tq={Tq} Tk={Tk} d={d} {q.dtype}")
    if bh > 65535:
        raise ValueError(f"{what}: at most 65535 batch x heads, got {bh}")
    if km is not None:
        _check_cuda("key mask", km, (bh, Tk), (torch.float32,))
    for t in (k, km, *extra):
        if t is not None and t.device != q.device:
            raise ValueError(f"{what}: all tensors must be on one device")


def _seed_args(seed, rate):
    s = seed if rate > 0.0 else (0, 0, 0)
    return [float(rate), float(_drop_scale(rate)) if rate > 0.0 else 1.0, *s]


def _fwd_cuda(q, k, v, km, causal, scale, rate, seed):
    bh, T, d = q.shape
    _common_checks("flash_fwd", q, k, km, (v,))
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_cuda(name, t, (bh, T, d), (q.dtype,))
    o = torch.empty_like(q)
    lse = torch.empty((bh, T), dtype=torch.float32, device=q.device)
    lib = cuda_build.library(FWD_SOURCE, "dl4j_flash_fwd", _FWD_ARGTYPES)
    P = cuda_build.ptr
    code = lib.dl4j_flash_fwd(P(q), P(k), P(v), P(km), P(o), P(lse), bh, T, d,
                              int(q.dtype == torch.bfloat16), float(scale), int(causal),
                              *_seed_args(seed, rate), cuda_build.stream_of(q))
    cuda_build.check(lib, code, "flash_fwd kernel launch")
    FWD_COUNTER.add()
    return o, lse


def flash_fwd(q, k, v, km, causal, scale, rate=0.0, seed=None):
    """K5 on [bh, T, d] operands (shapes as :func:`flash_fwd_plain`). CUDA
    tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    if q.device.type == "cuda":
        return _fwd_cuda(q, k, v, km, causal, scale, rate, seed)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, km, causal, scale, rate, seed)
    raise ValueError(f"flash_fwd: unsupported device {q.device}")


def _bwd_checks(what, q, k, v, km, do, delta, lse):
    bh, Tq, d = q.shape
    Tk = k.shape[1]
    _common_checks(what, q, k, km, (v, do, delta, lse))
    for name, t, shape in (("q", q, (bh, Tq, d)), ("k", k, (bh, Tk, d)), ("v", v, (bh, Tk, d)),
                           ("do", do, (bh, Tq, d))):
        _check_cuda(name, t, shape, (q.dtype,))
    for name, t in (("delta", delta), ("lse", lse)):
        _check_cuda(name, t, (bh, Tq), (torch.float32,))


def _dq_cuda(q, k, v, km, do, delta, lse, causal, scale, seed, rate):
    _bwd_checks("dq_block", q, k, v, km, do, delta, lse)
    bh, Tq, d = q.shape
    dq = torch.empty_like(q)
    lib = cuda_build.library(DQ_SOURCE, "dl4j_flash_dq", _DQ_ARGTYPES)
    P = cuda_build.ptr
    code = lib.dl4j_flash_dq(P(q), P(k), P(v), P(km), P(do), P(delta), P(lse), P(dq), bh, Tq,
                             k.shape[1], d, int(q.dtype == torch.bfloat16), float(scale),
                             int(causal), *_seed_args(seed, rate), cuda_build.stream_of(q))
    cuda_build.check(lib, code, "flash_dq kernel launch")
    DQ_COUNTER.add()
    return dq


def _dkv_cuda(q, k, v, km, do, delta, lse, causal, scale, seed, rate):
    _bwd_checks("dkv_block", q, k, v, km, do, delta, lse)
    bh, Tq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = cuda_build.library(DKV_SOURCE, "dl4j_flash_dkv", _DKV_ARGTYPES)
    P = cuda_build.ptr
    code = lib.dl4j_flash_dkv(P(q), P(k), P(v), P(km), P(do), P(delta), P(lse), P(dk), P(dv),
                              bh, Tq, k.shape[1], d, int(q.dtype == torch.bfloat16),
                              float(scale), int(causal), *_seed_args(seed, rate),
                              cuda_build.stream_of(q))
    cuda_build.check(lib, code, "flash_dkv kernel launch")
    DKV_COUNTER.add()
    return dk, dv


def dq_block(q, k, v, km, do, delta, lse, causal, scale, seed=None, rate=0.0):
    """K6: dq for one q shard against one k/v block ([bh, Tq, d] x [bh, Tk,
    d]). ``delta``/``lse`` [bh, Tq] are the GLOBAL rowwise delta and
    log-sum-exp: with them the per-block probabilities recompute exactly,
    so per-block gradients sum to the full gradient (the ring's contract).
    ``km`` [bh, Tk] or None; ``seed`` :func:`seed3` (with the shard
    offsets) when ``rate`` > 0. CUDA tensors launch the kernel (or raise);
    CPU tensors take the plain version."""
    if q.device.type == "cuda":
        return _dq_cuda(q, k, v, km, do, delta, lse, causal, scale, seed, rate)
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, km, do, delta, lse, causal, scale, seed, rate)
    raise ValueError(f"dq_block: unsupported device {q.device}")


def dkv_block(q, k, v, km, do, delta, lse, causal, scale, seed=None, rate=0.0):
    """K7: (dk, dv) for one k/v block against one q shard; see
    :func:`dq_block` for the global-``lse``/``delta`` contract."""
    if q.device.type == "cuda":
        return _dkv_cuda(q, k, v, km, do, delta, lse, causal, scale, seed, rate)
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, km, do, delta, lse, causal, scale, seed, rate)
    raise ValueError(f"dkv_block: unsupported device {q.device}")


def rowwise_delta(do, o):
    """delta_i = sum_d do * o in f32 (f64 for f64 operands): [bh, T, d] x 2
    -> [bh, T]."""
    a = _acc(do)
    return (do.to(a) * o.to(a)).sum(dim=-1)


class FlashFunction(torch.autograd.Function):
    """``o = attention(q, k, v)`` on [bh, T, d], differentiable in q, k, v:
    K5 forward saving (o, lse), K6 and K7 backward (``_flash_fwd`` /
    ``_bwd`` of the JAX package)."""

    @staticmethod
    def forward(ctx, q, k, v, km, causal, scale, rate, seed):
        o, lse = flash_fwd(q, k, v, km, causal, scale, rate, seed)
        ctx.save_for_backward(q, k, v, km, o, lse)
        ctx.args = (causal, scale, seed, rate)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, km, o, lse = ctx.saved_tensors
        causal, scale, seed, rate = ctx.args
        do = g.to(q.dtype).contiguous()     # the cotangent in q's type, as _bwd
        delta = rowwise_delta(do, o)
        dq = dq_block(q, k, v, km, do, delta, lse, causal, scale, seed, rate)
        dk, dv = dkv_block(q, k, v, km, do, delta, lse, causal, scale, seed, rate)
        return dq, dk, dv, None, None, None, None, None


def normalize_operand_dtypes(q, k, v):
    """Uniform operands for the single-type kernels: promote to the WIDEST
    operand type, so an f32 k/v beside a bf16 q keeps its precision.
    Returns ``(q, k, v, out_dtype)``, ``out_dtype`` q's original type, to
    which callers cast the result back."""
    out_dtype = q.dtype
    common = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    return q.to(common), k.to(common), v.to(common), out_dtype


def flash_attention(q, k, v, causal: bool = True, scale: Optional[float] = None,
                    key_mask=None, dropout_rate: float = 0.0, dropout_seed=None):
    """Blockwise attention, q/k/v [b, T, h, d] -> [b, T, h, d].
    ``key_mask`` [b, T] (1 = a real key, 0 = padding) is applied in the
    kernels; ``dropout_rate`` > 0 drops normalised probabilities in the
    kernels and needs ``dropout_seed`` (an int32 value). While autograd
    records, the call goes through :class:`FlashFunction` (K5, then K6 and
    K7 in the backward); otherwise K5 alone."""
    b, T, h, d = q.shape
    q, k, v, out_dtype = normalize_operand_dtypes(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    rate = float(dropout_rate)
    seed = None
    if rate > 0.0:
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 needs dropout_seed")
        seed = seed3(dropout_seed)

    def to_bh(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, T, d).contiguous()

    km = None
    if key_mask is not None:
        km = torch.as_tensor(key_mask, device=q.device).float()
        km = km[:, None, :].expand(b, h, T).reshape(b * h, T).contiguous()
    args = (to_bh(q), to_bh(k), to_bh(v), km, bool(causal), float(scale), rate, seed)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args[:3]):
        o = FlashFunction.apply(*args)
    else:
        o, _ = flash_fwd(*args)
    return o.reshape(b, h, T, d).permute(0, 2, 1, 3).to(out_dtype)
