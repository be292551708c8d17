"""The port's flash-attention plain versions against the JAX Pallas kernels.

``deeplearning4j_torch/ops/flash_attention.py`` keeps, beside each CUDA
kernel (K5 forward, K6 dq, K7 dk/dv), a plain PyTorch version that CPU
tensors take. Here those run against ``deeplearning4j_tpu``'s Pallas
kernels in interpret mode on the same numpy inputs.

Tolerances, as max |port - jax| over max |jax| (lse absolute):
- f32: the same arithmetic with sums in another order (the kernels sum
  block by block with online rescaling, the plain versions over whole
  rows): 1e-5 (measured <= 1.1e-6).
- bf16 operands: p, ds and pd are rounded to bf16 before their products,
  and the kernel rounds exp(s - m) against the running max where the plain
  version uses the row's final max, so single entries may differ by one
  bf16 unit (2^-8 relative): 2e-2 of the largest entry.
- Rows with no visible key are exactly 0 (o, dq, dk, dv) on both sides,
  and the dropout keep mask is bit-equal.
"""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import deeplearning4j_tpu.ops.flash_attention as jfa
from deeplearning4j_torch.ops import flash_attention as fa

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LSE_ATOL = {"float32": 1e-5, "bfloat16": 1e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread per test worker leaves the other
    cores to the workers running other test files."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = jfa._FORCE_INTERPRET
    jfa._FORCE_INTERPRET = True
    yield
    jfa._FORCE_INTERPRET = old


def _operands(seed, bh, Tq, Tk, d, dtype):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((bh, Tq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((bh, Tk, d)).astype(np.float32) for _ in range(2))
    if dtype == "bfloat16":     # values exact in bf16 on both sides
        q, do, k, v = (np.asarray(torch.from_numpy(a).bfloat16().float()) for a in (q, do, k, v))
    return q, k, v, do


def _j(a, dtype):
    return jnp.asarray(a, dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(TORCH_DTYPE[dtype])


def _jkm(km):
    return None if km is None else jnp.broadcast_to(jnp.asarray(km)[..., None], km.shape + (8,))


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_all(q, k, v, do, km, causal, scale, dtype, rate=0.0, seed=None):
    """JAX forward, delta and both backward blocks."""
    jq, jk, jv, jdo = (_j(a, dtype) for a in (q, k, v, do))
    js = None if seed is None else jfa.seed3(*seed)
    o, lse = jfa._fwd(jq, jk, jv, _jkm(km), js, causal, scale, rate)
    delta = jfa.rowwise_delta(jdo, o)
    dq = jfa.dq_block(jq, jk, jv, _jkm(km), jdo, delta, lse, causal, scale, js, rate)
    dk, dv = jfa.dkv_block(jq, jk, jv, _jkm(km), jdo, delta, lse, causal, scale, js, rate)
    return o, lse[..., 0], dq, dk, dv


def _port_all(q, k, v, do, km, causal, scale, dtype, rate=0.0, seed=None):
    tq, tk, tv, tdo = (_t(a, dtype) for a in (q, k, v, do))
    tkm = None if km is None else torch.from_numpy(km)
    s3 = None if seed is None else fa.seed3(*seed)
    o, lse = fa.flash_fwd(tq, tk, tv, tkm, causal, scale, rate, s3)
    delta = fa.rowwise_delta(tdo, o)
    args = (tq, tk, tv, tkm, tdo, delta, lse, causal, scale, s3, rate)
    return (o, lse, fa.dq_block(*args), *fa.dkv_block(*args))


def _assert_match(port, jax_, dtype):
    for name, got, want in zip(("o", "lse", "dq", "dk", "dv"), port, jax_):
        if name == "lse":
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                       atol=LSE_ATOL[dtype])
        else:
            assert got.dtype == TORCH_DTYPE[dtype], name
            assert _rel(got, want) <= TOL[dtype], (name, _rel(got, want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,T", [(16, 384), (64, 256)])
def test_plain_versions_match_pallas(dtype, causal, d, T):
    """o, lse, dq, dk, dv: causal and not, f32 and bf16, d in {16, 64},
    T in {256, 384}."""
    q, k, v, do = _operands(1, 2, T, T, d, dtype)
    scale = 1.0 / np.sqrt(d)
    _assert_match(_port_all(q, k, v, do, None, causal, scale, dtype),
                  _jax_all(q, k, v, do, None, causal, scale, dtype), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_key_mask_and_fully_masked_rows(dtype):
    """A key mask with padded spans, and one batch x head with every key
    padded: its o, dq, dk, dv are exactly 0 and its lse is -1e30."""
    q, k, v, do = _operands(2, 3, 256, 256, 32, dtype)
    km = np.ones((3, 256), np.float32)
    km[0, 40:120] = 0.0
    km[2, 200:] = 0.0
    km[1] = 0.0
    port = _port_all(q, k, v, do, km, True, 0.2, dtype)
    _assert_match(port, _jax_all(q, k, v, do, km, True, 0.2, dtype), dtype)
    o, lse, dq, dk, dv = port
    for t in (o, dq, dk, dv):
        assert torch.count_nonzero(t[1]) == 0
    assert torch.all(lse[1] == -1e30)


@pytest.mark.parametrize("causal", [True, False])
def test_dropout_with_offsets(causal):
    """In-kernel dropout on the normalised probabilities, with a negative
    seed and global offsets near 2^31 (the hash wraps as int32 does)."""
    q, k, v, do = _operands(3, 2, 256, 256, 16, "float32")
    seed = (-123457, 2 ** 31 - 100, 77)
    _assert_match(_port_all(q, k, v, do, None, causal, 0.25, "float32", 0.2, seed),
                  _jax_all(q, k, v, do, None, causal, 0.25, "float32", 0.2, seed), "float32")


@pytest.mark.parametrize("Tq,Tk", [(128, 384), (384, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_dq_dkv_blocks_with_unequal_lengths(Tq, Tk, causal):
    """dq_block/dkv_block on a q shard against a k/v block of another
    length, with a global lse/delta, a key mask and dropout at ring-style
    offsets."""
    q, k, v, do = _operands(4, 2, Tq, Tk, 16, "float32")
    rng = np.random.default_rng(5)
    lse = (rng.standard_normal((2, Tq)) + 4.0).astype(np.float32)
    delta = rng.standard_normal((2, Tq)).astype(np.float32)
    km = np.ones((2, Tk), np.float32)
    km[1, 10:50] = 0.0
    seed = (99, Tk, 3 * Tq)
    jargs = (*(jnp.asarray(a) for a in (q, k, v)), _jkm(km), jnp.asarray(do),
             jnp.broadcast_to(jnp.asarray(delta)[..., None], (2, Tq, 8)),
             jnp.broadcast_to(jnp.asarray(lse)[..., None], (2, Tq, 8)), causal, 0.3,
             jfa.seed3(*seed), 0.1)
    targs = (*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(km),
             torch.from_numpy(do), torch.from_numpy(delta), torch.from_numpy(lse), causal, 0.3,
             fa.seed3(*seed), 0.1)
    dq = fa.dq_block(*targs)
    dk, dv = fa.dkv_block(*targs)
    jdk, jdv = jfa.dkv_block(*jargs)
    for got, want in ((dq, jfa.dq_block(*jargs)), (dk, jdk), (dv, jdv)):
        assert _rel(got, want) <= TOL["float32"]


@pytest.mark.parametrize("seed,bh,q_off,k_off,rate", [
    (0, 4, 0, 0, 0.1),
    (-1, 64, 0, 0, 0.5),
    (-2 ** 31, 3, 2 ** 31 - 40, 0, 0.25),
    (2 ** 31 - 1, 2, 17, 2 ** 31 - 33, 0.9),
    (123456789, 64, 2 ** 31 - 1, 2 ** 31 - 1, 0.3),
])
def test_keep_mask_bit_exact(seed, bh, q_off, k_off, rate):
    """The keep mask is bit for bit the JAX package's, for negative and
    extreme seeds, bh up to 64 and offsets near 2^31 (int32 wraparound)."""
    got = fa.dropout_keep_mask(bh, 64, 48, seed, rate, q_off, k_off)
    want = np.asarray(jfa.dropout_keep_mask(bh, 64, 48, seed, rate, q_off, k_off)) > 0
    assert np.array_equal(got.numpy(), want)


def test_flash_function_gradients_equal_autograd_through_plain_forward():
    """FlashFunction's backward (K6/K7 plain versions) equals autograd
    through the plain forward, f64, with a key mask."""
    rng = np.random.default_rng(6)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 128, 16))).requires_grad_()
                   for _ in range(4))
    km = torch.ones(2, 128, dtype=torch.float64)
    km[0, 50:70] = 0.0
    o = fa.FlashFunction.apply(q, k, v, km, True, 0.25, 0.0, None)
    got = torch.autograd.grad(o, (q, k, v), do.detach())

    def plain(q, k, v):
        outs = []
        for i in range(2):
            s = (q[i] @ k[i].t()) * 0.25
            qpos = torch.arange(128)[:, None]
            s = torch.where((torch.arange(128)[None, :] <= qpos) & (km[i][None, :] > 0), s,
                            torch.full_like(s, -1e30))
            outs.append(torch.softmax(s, -1) @ v[i])
        return torch.stack(outs)

    want = torch.autograd.grad(plain(q, k, v), (q, k, v), do.detach())
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)


def test_public_flash_attention_layout_and_dtype_promotion():
    """[b, T, h, d] in and out; an f32 v beside bf16 q/k promotes the
    kernel operands to f32 and the result comes back in q's type."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((2, 256, 2, 16)).astype(np.float32) for _ in range(3))
    km = np.ones((2, 256), np.float32)
    km[1, 100:] = 0.0
    want = np.asarray(jfa.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                                          key_mask=jnp.asarray(km)))
    got = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                             key_mask=torch.from_numpy(km))
    assert _rel(got, want) <= TOL["float32"]
    mixed = fa.flash_attention(torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16(),
                               torch.from_numpy(v), causal=True)
    assert mixed.dtype == torch.bfloat16
    assert fa.normalize_operand_dtypes(torch.zeros(1).bfloat16(), torch.zeros(1).bfloat16(),
                                       torch.zeros(1))[0].dtype == torch.float32
    with pytest.raises(ValueError, match="dropout_seed"):
        fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), dropout_rate=0.1)


@pytest.mark.parametrize("T,d", [(128, 64), (256, 64), (384, 32), (1024, 128), (768, 256),
                                 (8192, 64), (1920, 16)])
def test_pick_block_matches_jax(T, d):
    assert fa.pick_block(T, d) == jfa.pick_block(T, d)


def test_supported_contract(monkeypatch):
    """The JAX routing contract: T >= MIN_SEQ (4096) and T % 128 == 0, d <=
    256, a 2-D key mask, a rate in [0, 1); the test seam lowers MIN_SEQ to
    256 as the JAX package's interpret switch does."""
    assert fa.MIN_SEQ == jfa.MIN_SEQ == 4096 and fa.MIN_BLOCK == jfa.MIN_BLOCK == 128
    assert fa.supported(8192, 64, 0.0, None)
    assert not fa.supported(2048, 64, 0.0, None)
    assert not fa.supported(8192 + 64, 64, 0.0, None)
    assert not fa.supported(8192, 320, 0.0, None)
    assert not fa.supported(8192, 64, 1.0, None)
    assert not fa.supported(8192, 64, 0.0, torch.ones(2, 8192, 1))
    assert fa.supported(8192, 64, 0.5, torch.ones(2, 8192))
    monkeypatch.setattr(fa, "_FORCE_SHORT_SEQ", True)
    for T in (128, 256, 384, 4096):
        assert fa.supported(T, 64, 0.0, None) == jfa.supported(T, 64, 0.0, None)


def _c_parameters(entry):
    """The parameter list of ``extern "C" int <entry>(...)`` in the port's
    CUDA sources, one declaration a string."""
    csrc = Path(fa.__file__).resolve().parent.parent / "csrc"
    found = [m.group(1) for src in sorted(csrc.glob("*.cu"))
             for m in re.finditer(r'extern "C" int ' + entry + r"\(([^)]*)\)", src.read_text())]
    assert len(found) == 1, f"{entry}: {len(found)} definitions in {csrc}"
    return [" ".join(p.split()) for p in found[0].split(",")]


def _c_kind(decl):
    if "*" in decl:
        return "pointer"
    kind = decl.replace("const ", "").split()[0]
    assert kind in ("int", "float"), f"unexpected C parameter {decl!r}"
    return kind


@pytest.mark.parametrize("entry,argtypes", [("dl4j_flash_fwd", "_FWD_ARGTYPES"),
                                            ("dl4j_flash_dq", "_DQ_ARGTYPES"),
                                            ("dl4j_flash_dkv", "_DKV_ARGTYPES"),
                                            ("dl4j_flash_fwd_wgmma", "_ROUTE_ARGTYPES")])
def test_ctypes_argtypes_match_the_c_entries(entry, argtypes):
    """Each wrapper's ctypes declaration against its C entry's parameter
    list: the count, and for each parameter whether it is a pointer, an int
    or a float. ctypes passes an int where the C side reads a pointer as 32
    bits, which only a launch on the card would show."""
    kinds = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_float: "float"}
    declared = [kinds[t] for t in getattr(fa, argtypes)]
    params = _c_parameters(entry)
    assert declared == [_c_kind(p) for p in params], list(zip(params, declared))


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(monkeypatch):
    """A wrapper given CUDA tensors launches its kernel or raises: here the
    shape and type checks raise before any build or launch (no card is
    needed to reach them)."""
    q = torch.zeros(2, 96, 16)
    with pytest.raises(ValueError, match="T % 64"):
        fa._fwd_cuda(q, q, q, None, True, 0.25, 0.0, None)
    with pytest.raises(ValueError, match="bf16 or f32"):
        fa._dq_cuda(*(torch.zeros(2, 64, 16, dtype=torch.float64),) * 3, None,
                    torch.zeros(2, 64, 16, dtype=torch.float64), torch.zeros(2, 64),
                    torch.zeros(2, 64), True, 0.25, None, 0.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa._dkv_cuda(*(torch.zeros(2, 64, 16),) * 3, None, torch.zeros(2, 64, 16),
                     torch.zeros(2, 64), torch.zeros(2, 64), True, 0.25, None, 0.0)
