"""Sequence (context) parallelism: ring attention and the Ulysses
all-to-all, on the flash kernels K5-K7.

Counterpart of ``deeplearning4j_tpu/parallel/sequence.py``. The sequence
dim is split over the ``sequence`` axis's slots, shard ``p`` holding
positions ``[p*Tl, (p+1)*Tl)``; the attention functions take the whole
``[b, T, h, d]`` tensors, split them over the slots (each shard on its
slot's device) and put the result back together.

- :func:`ring_flash_attention` (``:212-355``): slot ``p`` meets the key
  blocks in ring order ``blk = (p - i) % n``; each block is one K5 launch
  on the shard (diagonal block causal, earlier blocks full) with the
  dropout operand ``seed3(seed, p*Tl, blk*Tl)``, so the keep bits are the
  single kernel's at the same global coordinates. A block no causal query
  can see is not launched. The blocks' (o, lse) merge by log-sum-exp,
  gated on ``lse > -1e30/2`` (a row with no visible key gives lse
  -1e30). The backward is K6 and K7 a visible block against the global
  lse and delta; each block's dk/dv is added at the block's owner in the
  ring's order (the JAX package's travelling accumulators). Forward and
  backward are one ``torch.autograd.Function`` over the slots.
- :func:`ulysses_flash_attention` (``:155-192``): the all-to-all swaps
  sequence shards for head groups (slot ``p`` gets heads ``[p*h/n,
  (p+1)*h/n)`` over the whole T), one K5 (K6/K7 backward) a slot runs on
  its [b, T, h/n, d], and the inverse swap brings the shards back; the
  swaps are tensor slicing and concatenation, which autograd carries.
- :func:`ring_attention`/:func:`ulysses_attention`/:func:`full_attention`:
  the dense bodies (online softmax over 512-key chunks for the ring).

:func:`sequence_parallel_step` (``:461-674``) trains a container with
the time dim split over the slots. All slots of its mesh sit on the
network's device, and the per-token layers run once over the slots'
shards stacked slot-major on the batch dim ([n*b, Tl, ...]: shard ``s``
of example ``j`` at row ``s*b + j``); the slots meet only in attention,
where :func:`sp_attend` (routed by :func:`current_sp_axis`, scoped to the
step and to its thread) takes the stack apart into the slots' shards. The
stacked loss divides by n*b, so n times it is the JAX step's sum of the
shards' losses; that sum counts the l1/l2 term n times, and the step
removes the n-1 extra copies, as the JAX step does (``:583-593``).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch

from ..monitor.jitwatch import monitored_jit
from ..ops import flash_attention as fa
from .mesh import SEQUENCE_AXIS, Mesh, record_step, require_axes

__all__ = ["ring_attention", "ulysses_attention", "full_attention", "ring_flash_attention",
           "ring_flash_supported", "ulysses_flash_attention", "ulysses_flash_supported",
           "sp_attend", "current_sp_axis", "sequence_parallel_step", "SEQUENCE_AXIS"]

_NEG = -1e30
#: within-slot key chunk of the dense ring (live logits [b, h, Tl, 512])
_LOCAL_CHUNK = 512


# ------------------------------------------------------------- slot helpers
def _seq_shards(x, mesh: Mesh, axis: str):
    """``x`` [b, T, ...] split along T over ``axis``: shard p on slot p's
    device."""
    n = mesh.shape[axis]
    if x.shape[1] % n:
        raise ValueError(f"sequence length {x.shape[1]} not divisible by {n} slots")
    return [c.to(d) for c, d in zip(torch.chunk(x, n, dim=1), mesh.axis_devices(axis))]


def _join(parts, device):
    return torch.cat([p.to(device) for p in parts], dim=1)


def _to_bh(x):
    b, T, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, T, d).contiguous()


def _from_bh(x, b, h):
    bh, T, d = x.shape
    return x.reshape(b, h, T, d).permute(0, 2, 1, 3)


# ---------------------------------------------------------------- dense bodies
def full_attention(q, k, v, causal: bool = False):
    """Single-device dense reference (the tests' oracle): f32 softmax,
    the result in q's type."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if causal:
        T, S = s.shape[-2], s.shape[-1]
        mask = torch.tril(torch.ones((T, S), dtype=torch.bool, device=s.device))
        s = torch.where(mask, s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _ring_dense_slot(p, qp, ks, vs, causal, scale):
    """Slot p's output: online softmax over the ring's key blocks, each in
    chunks of ``_LOCAL_CHUNK`` keys (one chunk when that does not divide)."""
    n = len(ks)
    b, Tl, h, d = qp.shape
    dev = qp.device
    qf = qp.float()
    m = torch.full((b, h, Tl), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, Tl), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, Tl, h, d), dtype=torch.float32, device=dev)
    chunk = _LOCAL_CHUNK if Tl % _LOCAL_CHUNK == 0 else Tl
    iota_q = torch.arange(Tl, device=dev)
    for i in range(n):
        blk = (p - i) % n
        kb, vb = ks[blk].to(dev), vs[blk].to(dev)
        for c in range(Tl // chunk):
            kc = kb[:, c * chunk:(c + 1) * chunk].float()
            vc = vb[:, c * chunk:(c + 1) * chunk].float()
            s = torch.einsum("bqhd,bkhd->bhqk", qf, kc) * scale
            if causal:
                q_idx = p * Tl + iota_q
                k_idx = blk * Tl + c * chunk + torch.arange(chunk, device=dev)
                s = torch.where((q_idx[:, None] >= k_idx[None, :])[None, None], s,
                                torch.full_like(s, _NEG))
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            pexp = torch.exp(s - m_new[..., None])
            l = l * corr + pexp.sum(dim=-1)
            acc = acc * corr.permute(0, 2, 1)[..., None] + torch.einsum("bhqk,bkhd->bqhd",
                                                                         pexp, vc)
            m = m_new
    return (acc / l.permute(0, 2, 1)[..., None]).to(qp.dtype)


def ring_attention(q, k, v, mesh: Mesh, axis: str = SEQUENCE_AXIS, causal: bool = False):
    """Exact attention with the sequence dim split over ``axis``, the dense
    ring body (online softmax; no kernel). q, k, v: [b, T, h, d]."""
    require_axes(mesh, (axis,), style="ring_attention")
    scale = 1.0 / math.sqrt(q.shape[-1])
    qs, ks, vs = (_seq_shards(x, mesh, axis) for x in (q, k, v))
    return _join([_ring_dense_slot(p, qs[p], ks, vs, causal, scale)
                  for p in range(len(qs))], q.device)


def _seq_to_heads(xs, devices):
    """The Ulysses swap, [b, Tl, h, d] a slot -> [b, T, h/n, d] a slot:
    slot p gathers head group p of every sequence shard."""
    n = len(xs)
    hg = xs[0].shape[2] // n
    return [torch.cat([x[:, :, p * hg:(p + 1) * hg].to(devices[p]) for x in xs], dim=1)
            for p in range(n)]


def _heads_to_seq(ys, devices):
    """The inverse swap: slot s gathers its sequence shard of every head
    group."""
    n = len(ys)
    Tl = ys[0].shape[1] // n
    return [torch.cat([y[:, s * Tl:(s + 1) * Tl].to(devices[s]) for y in ys], dim=2)
            for s in range(n)]


def ulysses_attention(q, k, v, mesh: Mesh, axis: str = SEQUENCE_AXIS, causal: bool = False):
    """All-to-all (DeepSpeed-Ulysses) attention with dense bodies; the head
    count must divide by the axis extent."""
    require_axes(mesh, (axis,), style="ulysses_attention")
    devs = mesh.axis_devices(axis)
    qs, ks, vs = (_seq_to_heads(_seq_shards(x, mesh, axis), devs) for x in (q, k, v))
    ys = [full_attention(qs[p], ks[p], vs[p], causal) for p in range(len(qs))]
    return _join(_heads_to_seq(ys, devs), q.device)


# ---------------------------------------------------------------- ring flash
class _RingFlash(torch.autograd.Function):
    """The ring over the slots on the flash kernels: inputs the slots'
    [bh, Tl, d] q, k and v (3n tensors, each on its slot's device),
    outputs the slots' o. See the module docstring."""

    @staticmethod
    def forward(ctx, meta, *tensors):
        n, causal, scale, rate, seed = meta
        qs, ks, vs = tensors[:n], tensors[n:2 * n], tensors[2 * n:]
        Tl = qs[0].shape[1]
        outs, lses = [], []
        for p in range(n):
            qb = qs[p]
            dev = qb.device
            bh, _, d = qb.shape
            m_run = torch.full((bh, Tl), _NEG, dtype=torch.float32, device=dev)
            den = torch.zeros((bh, Tl), dtype=torch.float32, device=dev)
            num = torch.zeros((bh, Tl, d), dtype=torch.float32, device=dev)
            for i in range(n):
                blk = (p - i) % n
                if causal and blk > p:
                    continue        # no query of this shard sees the block: not launched
                s3 = None if rate == 0.0 else fa.seed3(seed, p * Tl, blk * Tl)
                o_i, lse_i = fa.flash_fwd(qb, ks[blk].to(dev), vs[blk].to(dev), None,
                                          causal and blk == p, scale, rate, s3)
                lse_i = lse_i.float()
                m_new = torch.maximum(m_run, lse_i)
                w_old = torch.exp(m_run - m_new)
                w_new = torch.where(lse_i > _NEG / 2, torch.exp(lse_i - m_new),
                                    torch.zeros_like(lse_i))
                num = num * w_old[..., None] + o_i.float() * w_new[..., None]
                den = den * w_old + w_new
                m_run = m_new
            outs.append((num / torch.clamp(den, min=1e-30)[..., None]).to(qb.dtype))
            lses.append(m_run + torch.log(torch.clamp(den, min=1e-30)))
        ctx.meta = meta
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        n, causal, scale, rate, seed = ctx.meta
        saved = ctx.saved_tensors
        qs, ks, vs = saved[:n], saved[n:2 * n], saved[2 * n:3 * n]
        outs, lses = saved[3 * n:4 * n], saved[4 * n:]
        Tl = qs[0].shape[1]
        dos = [g.to(q.dtype).contiguous() for g, q in zip(gs, qs)]
        deltas = [fa.rowwise_delta(do, o).float().contiguous() for do, o in zip(dos, outs)]
        dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
        dk = [torch.zeros(k.shape, dtype=torch.float32, device=k.device) for k in ks]
        dv = [torch.zeros(v.shape, dtype=torch.float32, device=v.device) for v in vs]
        # ring step outer, slot inner: block j's dk/dv gather their
        # contributions in the order the travelling accumulators would
        for i in range(n):
            for p in range(n):
                blk = (p - i) % n
                if causal and blk > p:
                    continue
                dev = qs[p].device
                s3 = None if rate == 0.0 else fa.seed3(seed, p * Tl, blk * Tl)
                kc, vc = ks[blk].to(dev), vs[blk].to(dev)
                diag = causal and blk == p
                lse = lses[p].contiguous()
                dq_i = fa.dq_block(qs[p], kc, vc, None, dos[p], deltas[p], lse, diag, scale,
                                   s3, rate)
                dk_i, dv_i = fa.dkv_block(qs[p], kc, vc, None, dos[p], deltas[p], lse, diag,
                                          scale, s3, rate)
                dq[p] += dq_i.float()
                dk[blk] += dk_i.float().to(dk[blk].device)
                dv[blk] += dv_i.float().to(dv[blk].device)
        return (None, *(g.to(q.dtype) for g, q in zip(dq, qs)),
                *(g.to(k.dtype) for g, k in zip(dk, ks)),
                *(g.to(v.dtype) for g, v in zip(dv, vs)))


def _ring_flash_slots(qs, ks, vs, causal, scale, rate, seed):
    """The ring on the slots' [b, Tl, h, d] shards -> the slots' outputs."""
    b, _, h, _ = qs[0].shape
    n = len(qs)
    args = [_to_bh(x) for x in (*qs, *ks, *vs)]
    outs = _RingFlash.apply((n, bool(causal), float(scale), float(rate), seed), *args)
    return [_from_bh(o, b, h) for o in outs]


def _check_seed(rate, seed):
    if rate > 0.0 and seed is None:
        raise ValueError("dropout_rate > 0 needs dropout_seed")
    return 0 if seed is None else int(seed)


def ring_flash_attention(q, k, v, mesh: Mesh, axis: str = SEQUENCE_AXIS,
                         causal: bool = False, dropout_rate: float = 0.0, dropout_seed=None):
    """Ring attention with the flash kernels as the per-block compute
    (module docstring); the shard length must divide by 128 and the head
    width fit the kernels (:func:`ring_flash_supported`). ``dropout_rate``
    > 0 drops attention probabilities in the kernels at global
    coordinates, equal to the single kernel's dropout at the same int32
    ``dropout_seed``, forward and backward."""
    require_axes(mesh, (axis,), style="ring_flash_attention")
    q, k, v, out_dtype = fa.normalize_operand_dtypes(q, k, v)
    rate = float(dropout_rate)
    seed = _check_seed(rate, dropout_seed)
    scale = 1.0 / math.sqrt(q.shape[-1])
    qs, ks, vs = (_seq_shards(x, mesh, axis) for x in (q, k, v))
    return _join(_ring_flash_slots(qs, ks, vs, causal, scale, rate, seed),
                 q.device).to(out_dtype)


def _max_d(dtype) -> int:
    return {torch.bfloat16: 256, torch.float32: 128}.get(dtype, 0)


def ring_flash_supported(T: int, n_shards: int, d: int, dtype=torch.bfloat16) -> bool:
    """Whether the ring's shards suit the kernels: T divides by the slots,
    the shard length by 128, and the head width fits ``dtype``'s kernels."""
    n = max(1, n_shards)
    Tl = T // n
    return T % n == 0 and Tl % fa.MIN_BLOCK == 0 and d <= _max_d(dtype)


def _ulysses_flash_slots(qs, ks, vs, causal, devices):
    qh, kh, vh = (_seq_to_heads(xs, devices) for xs in (qs, ks, vs))
    ys = [fa.flash_attention(qh[p], kh[p], vh[p], causal=causal) for p in range(len(qs))]
    return _heads_to_seq(ys, devices)


def ulysses_flash_attention(q, k, v, mesh: Mesh, axis: str = SEQUENCE_AXIS,
                            causal: bool = False):
    """Ulysses with the flash kernels over the gathered sequence (module
    docstring); h divisible by the slots, T by 128 x the slots."""
    require_axes(mesh, (axis,), style="ulysses_flash_attention")
    q, k, v, out_dtype = fa.normalize_operand_dtypes(q, k, v)
    devs = mesh.axis_devices(axis)
    qs, ks, vs = (_seq_shards(x, mesh, axis) for x in (q, k, v))
    return _join(_ulysses_flash_slots(qs, ks, vs, causal, devs), q.device).to(out_dtype)


def ulysses_flash_supported(T: int, n_shards: int, h: int, d: int, dtype=torch.bfloat16,
                            b: int = 1) -> bool:
    """Whether the Ulysses route applies: the heads and T divide by the
    slots, T by 128, and the kernels take the head width and the slot's
    b x h/n."""
    n = max(1, n_shards)
    return (h % n == 0 and T % n == 0 and T % fa.MIN_BLOCK == 0 and d <= _max_d(dtype)
            and b * (h // n) <= 65535)


# ------------------------------------------------------------------ the step
_SP_TLS = threading.local()


class _SpContext:
    def __init__(self, mesh: Mesh, axis: str, data_axis: Optional[str]):
        self.mesh, self.axis, self.data_axis = mesh, axis, data_axis
        self.n = int(mesh.shape[axis])
        self.nd = int(mesh.shape[data_axis]) if data_axis else 1


def current_sp_axis():
    """The sequence axis of the sequence-parallel step running in this
    thread, or None: attention layers route through :func:`sp_attend`
    only inside it, so ``output``/``fit`` keep their dense routes."""
    c = getattr(_SP_TLS, "ctx", None)
    return None if c is None else c.axis


@contextlib.contextmanager
def _sp_scope(c: _SpContext):
    prev = getattr(_SP_TLS, "ctx", None)
    _SP_TLS.ctx = c
    try:
        yield
    finally:
        _SP_TLS.ctx = prev


def sp_attend(q, k, v, causal: bool, compute_dtype=torch.bfloat16, dropout_rate: float = 0.0,
              dropout_seed=None):
    """The attention of a layer inside :func:`sequence_parallel_step`: q, k,
    v are the slots' shards stacked slot-major ([n*b, Tl, h, d]). Without
    dropout and with the heads divisible by the slots it takes Ulysses
    (two swaps and one kernel a slot beat the ring's n launches), else the
    ring on the kernels when the shard suits them, else the dense ring;
    attention dropout runs on the ring only (Ulysses re-indexes the
    heads, which the keep hash reads), so dropout on a shard the kernels
    cannot take raises."""
    c = getattr(_SP_TLS, "ctx", None)
    if c is None:
        raise RuntimeError("sp_attend runs inside sequence_parallel_step")
    n, nd = c.n, c.nd
    rows, Tl, h, d = q.shape
    b = rows // n
    rate = float(dropout_rate)
    seed = _check_seed(rate, dropout_seed)
    scale = 1.0 / math.sqrt(d)
    q, k, v = (x.to(compute_dtype) for x in (q, k, v))
    ulysses = rate == 0.0 and ulysses_flash_supported(Tl * n, n, h, d, compute_dtype, b // nd)
    ring_ok = ring_flash_supported(Tl * n, n, d, compute_dtype)
    if rate > 0.0 and not ring_ok:
        raise ValueError(f"attention dropout on the sp path needs the ring's kernels: local "
                         f"shard length {Tl} divisible by {fa.MIN_BLOCK} and head_dim {d} <= "
                         f"{_max_d(compute_dtype)} for {compute_dtype}")
    bd = b // nd
    qv, kv, vv = (x.view(n, b, Tl, h, d) for x in (q, k, v))
    parts = []
    for di in range(nd):
        devs = [c.mesh.device_at(**{c.axis: s, **({c.data_axis: di} if c.data_axis else {})})
                for s in range(n)]
        sl = slice(di * bd, (di + 1) * bd)
        qs, ks, vs = ([x[s, sl].to(devs[s]) for s in range(n)] for x in (qv, kv, vv))
        if ulysses:
            ys = _ulysses_flash_slots(qs, ks, vs, causal, devs)
        elif ring_ok:
            ys = _ring_flash_slots(qs, ks, vs, causal, scale, rate, seed)
        else:
            ys = [_ring_dense_slot(p, qs[p], ks, vs, causal, scale) for p in range(n)]
        parts.append(torch.stack([y.to(q.device) for y in ys]))
    out = torch.cat(parts, dim=1) if nd > 1 else parts[0]
    return out.reshape(rows, Tl, h, d)


_RECURRENT = ("LSTM", "GravesLSTM", "GravesBidirectionalLSTM", "SimpleRnn", "Bidirectional")
_TIME_COLLAPSING = ("GlobalPoolingLayer", "LastTimeStepVertex", "LastTimeStep", "ReshapeVertex",
                    "DuplicateToTimeSeriesVertex")


def _validate(layer_items):
    """The JAX step's v1 rules (``:495-552``), loud."""
    for i, lc in layer_items:
        for cand in (lc, getattr(lc, "inner", None)):
            if cand is None:
                continue
            name = type(cand).__name__
            if name in _RECURRENT:
                raise ValueError(f"layer {i} ({name}) is time-recurrent; the time dim cannot "
                                 f"be sharded across slots — use TBPTT/dp for RNNs")
            if name in _TIME_COLLAPSING:
                raise ValueError(f"layer/vertex {i} ({name}) collapses or reshapes the sharded "
                                 f"time dim — unsupported in the sp step (v1)")
            if name == "BatchNormalization":
                raise ValueError(f"layer {i} ({name}) computes train-time statistics over the "
                                 f"batch AND time dims; each time shard would normalize with "
                                 f"shard-local statistics — unsupported in the sp step (v1). "
                                 f"Use LayerNormalization instead")
            if getattr(cand, "aux_loss_weight", 0.0):
                raise ValueError(f"layer {i} ({name}) has an activation-dependent aux loss; "
                                 f"its token statistics do not decompose across time shards "
                                 f"(v1) — set aux_loss_weight=0")
            if getattr(cand, "dropout", None) or name == "DropoutLayer":
                raise ValueError(f"layer {i} ({name}) uses activation dropout; unsupported in "
                                 f"the sp step (v1). (Attention-probability dropout on "
                                 f"SelfAttentionLayer IS supported: it runs in the ring-flash "
                                 f"kernels at global coordinates.)")
            if getattr(cand, "dropout_rate", 0.0) and name != "SelfAttentionLayer":
                raise ValueError(f"layer {i} ({name}) uses dropout_rate; only "
                                 f"SelfAttentionLayer's attention-probability dropout is "
                                 f"threaded through the ring in the sp step")
            if name == "SelfAttentionLayer" and getattr(cand, "dropout_rate", 0.0):
                hd = getattr(cand, "head_dim", None) or cand.n_out // max(1, cand.num_heads)
                if hd > 256:
                    raise ValueError(f"layer {i}: attention dropout on the sp path runs in the "
                                     f"ring-flash kernel, which needs head_dim <= 256 (got "
                                     f"{hd})")


def _stack(x, n):
    """[b, T, ...] -> the slots' shards stacked slot-major, [n*b, T/n, ...]."""
    b, T = x.shape[:2]
    if T % n:
        raise ValueError(f"sequence length {T} not divisible by {n} slots")
    y = x.reshape(b, n, T // n, *x.shape[2:]).movedim(1, 0)
    return y.reshape(n * b, T // n, *x.shape[2:]).contiguous()


def sequence_parallel_step(net, mesh: Mesh, axis: str = SEQUENCE_AXIS, data_axis=None):
    """Container-level sequence parallelism (module docstring). Returns
    ``step``: ``step(f, l)`` takes one update of ``net`` on a
    batch whose every stream is [b, T, ...] ([b, T] for token ids feeding
    an EmbeddingSequenceLayer), with T split over ``axis`` (and the batch
    over ``data_axis`` when given), and returns the loss (the unsharded
    step's loss); the model state stays whole on the network, so there
    is no ``place`` (JAX's step returns one). Masks are not taken. Recurrent layers, layers that
    collapse time, BatchNormalization, auxiliary losses and activation
    dropout are rejected."""
    is_graph = hasattr(net.conf, "vertices")
    layer_items = (list(net.conf.vertices.items()) if is_graph
                   else list(enumerate(net.conf.layers)))
    _validate(layer_items)
    require_axes(mesh, (axis, data_axis), style="sequence_parallel_step")
    wrong = {str(d) for _, d in mesh.slots() if d != net.device}
    if wrong:
        raise ValueError(f"sequence_parallel_step runs the per-token layers over the slots' "
                         f"stacked shards on the network's device ({net.device}); the mesh "
                         f"has slots on {sorted(wrong)}")
    c = _SpContext(mesh, axis, data_axis)
    n = c.n
    impls = list(net._layers().values())
    has_reg = any(getattr(im, "l1", 0) or getattr(im, "l2", 0) or getattr(im, "l1_bias", 0)
                  or getattr(im, "l2_bias", 0) for im in impls)
    if is_graph:
        consumers = {}
        for name, ins in net.conf.vertex_inputs.items():
            for i_name in ins:
                consumers.setdefault(i_name, []).append(name)
        id_inputs = {i for i, nm in enumerate(net.conf.network_inputs)
                     if consumers.get(nm) and all(
                         type(net.conf.vertices[cn]).__name__ == "EmbeddingSequenceLayer"
                         for cn in consumers[nm])}
    else:
        id_inputs = ({0} if type(net.conf.layers[0]).__name__ == "EmbeddingSequenceLayer"
                     else set())
    record_step("sequence/step", mesh)

    def step(f, l):
        fs = tuple(f) if isinstance(f, (tuple, list)) else (f,)
        ls = tuple(l) if isinstance(l, (tuple, list)) else (l,)
        fs = tuple(net._to_device(x) for x in fs)
        ls = tuple(net._to_device(x) for x in ls)
        for si, leaf in enumerate(fs):
            if leaf.dim() < 3 and not (leaf.dim() == 2 and si in id_inputs):
                raise ValueError(f"sp step streams must be rank-3 [b, T, ...] (got shape "
                                 f"{tuple(leaf.shape)}); [b, T] is accepted only for token-id "
                                 f"inputs feeding EmbeddingSequenceLayer")
        for leaf in ls:
            if leaf.dim() < 3:
                raise ValueError(f"sp step labels must be rank-3 [b, T, ...] (got shape "
                                 f"{tuple(leaf.shape)})")
        fst = tuple(_stack(x, n) for x in fs)
        lst = tuple(_stack(x, n) for x in ls)
        if not is_graph:
            fst, lst = fst[0], lst[0]
        with _sp_scope(c):
            loss, _, new_states = net._train_loss(fst, lst, None, None)
        # n x the stacked loss is the sum of the n shards' losses
        total = loss * n
        if has_reg:
            reg = 0.0
            for im in impls:
                reg = reg + im.regularization()
            total = total - (n - 1) * reg
        grads = net._grads(total, skip=net._idle_frozen())
        net._apply_update(grads, net.iteration_count)
        net._commit_states(new_states)
        net.iteration_count += 1
        net.score_ = total.detach()
        return net.score_

    return monitored_jit(step, name="sequence/step")
