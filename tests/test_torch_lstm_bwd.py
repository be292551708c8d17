"""K1 training forward and K2 parity: the port's reserve and gradients
against the JAX kernels.

The same inputs, made with numpy from a seed, go through the JAX Pallas
kernels in interpret mode (``lstm_cell._fwd(save_reserve=True)`` and
``jax.grad`` through ``lstm_cell.lstm_scan``, whose custom VJP is
``_bwd_kernel``) and through the port (``lstm_fwd(save_reserve=True)``
and autograd through ``lstm_scan`` -> ``LSTMFunction``, which on CPU
tensors takes the plain versions of K1 and K2).

Tolerances, as max |port - jax| over max |jax| per tensor: 1e-5 with f32
weights (the same f32 arithmetic in another summation order; measured
<= 4e-7). With bf16 weights, h and dz are rounded to bf16 before each
product on both sides, so a last-bit f32 difference can move one operand
by one bf16 unit (2^-8 relative) and that carries back through the steps:
5e-4 (measured <= 4e-5), and for dRW, which is itself rounded to bf16 at
the end, 4e-3 = 2^-8, one unit at the largest entry (measured <= 8e-4).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.ops.flash_attention as fa
import deeplearning4j_tpu.ops.lstm_cell as jlk
from deeplearning4j_torch.ops import lstm_cell

B, T, H = 8, 6, 128
TOL = 1e-5
TOL_BF16 = 5e-4
TOL_DRW_BF16 = 4e-3
MASKS = [None, "binary", "fractional"]


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
    old = fa._FORCE_INTERPRET
    fa._FORCE_INTERPRET = True
    yield
    fa._FORCE_INTERPRET = old


def _inputs(seed, mask_kind):
    rng = np.random.default_rng(seed)
    d = {
        "xp": rng.standard_normal((B, T, 4 * H)).astype(np.float32),
        "rw": (rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32),
        "peep": (0.3 * rng.standard_normal((3, H))).astype(np.float32),
        "h0": (0.5 * rng.standard_normal((B, H))).astype(np.float32),
        "c0": (0.5 * rng.standard_normal((B, H))).astype(np.float32),
        # cotangents of ys, hT, cT
        "ry": rng.standard_normal((B, T, H)).astype(np.float32),
        "rh": rng.standard_normal((B, H)).astype(np.float32),
        "rc": rng.standard_normal((B, H)).astype(np.float32),
        "mask": None,
    }
    if mask_kind == "binary":
        m = np.ones((B, T), np.float32)
        m[:, T - 2:] = 0.0
        m[0, 1] = 0.0
        d["mask"] = m
    elif mask_kind == "fractional":
        d["mask"] = rng.uniform(0.0, 1.0, (B, T)).astype(np.float32)
    return d


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max())


def _jax_grads(d, wdtype, peep):
    names = ["xp", "rw", "h0", "c0"] + (["peep"] if peep else [])
    mask = None if d["mask"] is None else jnp.asarray(d["mask"])

    def loss(*args):
        a = dict(zip(names, args))
        pp = tuple(a["peep"]) if peep else None
        ys, (hT, cT) = jlk.lstm_scan(a["xp"], a["rw"].astype(wdtype), pp, a["h0"],
                                     a["c0"], mask)
        return jnp.sum(ys * d["ry"]) + jnp.sum(hT * d["rh"]) + jnp.sum(cT * d["rc"])

    grads = jax.grad(loss, argnums=tuple(range(len(names))))(
        *(jnp.asarray(d[n]) for n in names))
    return dict(zip(names, grads))


def _torch_grads(d, wdtype, peep):
    names = ["xp", "rw", "h0", "c0"] + (["peep"] if peep else [])
    t = {n: torch.tensor(d[n], requires_grad=True) for n in names}
    mask = None if d["mask"] is None else torch.from_numpy(d["mask"])
    ys, (hT, cT) = lstm_cell.lstm_scan(t["xp"], t["rw"].to(wdtype),
                                       tuple(t["peep"]) if peep else None,
                                       t["h0"], t["c0"], mask)
    loss = ((ys * torch.from_numpy(d["ry"])).sum() + (hT * torch.from_numpy(d["rh"])).sum()
            + (cT * torch.from_numpy(d["rc"])).sum())
    loss.backward()
    return {n: v.grad.numpy() for n, v in t.items()}


@pytest.mark.parametrize("wname", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("peep", [True, False])
def test_gradients_match_jax_kernel(peep, mask_kind, wname):
    d = _inputs(20 + MASKS.index(mask_kind) + 3 * int(peep), mask_kind)
    want = _jax_grads(d, getattr(jnp, wname), peep)
    got = _torch_grads(d, getattr(torch, wname), peep)
    for name, w in want.items():
        tol = TOL
        if wname == "bfloat16":
            tol = TOL_DRW_BF16 if name == "rw" else TOL_BF16
        assert got[name].shape == w.shape, name
        assert _rel(got[name], w) <= tol, (name, _rel(got[name], w))


@pytest.mark.parametrize("wname", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask_kind", MASKS)
def test_reserve_matches_jax_fwd(mask_kind, wname):
    """The training forward's reserve (gates, post-mask c sequence) against
    the JAX ``_fwd(save_reserve=True)``."""
    d = _inputs(30 + MASKS.index(mask_kind), mask_kind)
    xp_tm = np.swapaxes(d["xp"], 0, 1).copy()
    mask_tm = None if d["mask"] is None else np.swapaxes(d["mask"], 0, 1).copy()
    pk = np.zeros((8, H), np.float32)
    pk[:3] = d["peep"]
    jm = None if mask_tm is None else jnp.broadcast_to(jnp.asarray(mask_tm)[..., None],
                                                       (T, B, 8))
    ys, gates, cseq, hc = jlk._fwd(jnp.asarray(xp_tm),
                                   jnp.asarray(d["rw"]).astype(getattr(jnp, wname)),
                                   jnp.asarray(pk), jnp.asarray(d["h0"]), jnp.asarray(d["c0"]),
                                   jm, save_reserve=True)
    got = lstm_cell.lstm_fwd(torch.from_numpy(xp_tm),
                             torch.from_numpy(d["rw"]).to(getattr(torch, wname)),
                             torch.from_numpy(d["peep"]),
                             None if mask_tm is None else torch.from_numpy(mask_tm),
                             torch.from_numpy(d["h0"]), torch.from_numpy(d["c0"]),
                             save_reserve=True)
    want = (ys, hc[0], hc[1], gates, cseq)
    tol = TOL if wname == "float32" else TOL_BF16
    for name, g, w in zip(("ys", "hT", "cT", "gates", "cseq"), got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        assert _rel(g.numpy(), w) <= tol, (name, _rel(g.numpy(), w))


def test_backward_kernel_plain_matches_jax_bwd_call():
    """K2's plain version on its own, against ``_bwd_call`` on the same
    dy, reserve and state (bf16 weights, fractional mask)."""
    d = _inputs(40, "fractional")
    rng = np.random.default_rng(41)
    xp_tm = np.swapaxes(d["xp"], 0, 1).copy()
    mask_tm = np.swapaxes(d["mask"], 0, 1).copy()
    _, _, _, gates, cseq = lstm_cell.lstm_fwd_plain(
        torch.from_numpy(xp_tm), torch.from_numpy(d["rw"]).bfloat16(),
        torch.from_numpy(d["peep"]), torch.from_numpy(mask_tm), torch.from_numpy(d["h0"]),
        torch.from_numpy(d["c0"]), save_reserve=True)
    dy = rng.standard_normal((T, B, H)).astype(np.float32)
    dhT, dcT = (rng.standard_normal((B, H)).astype(np.float32) for _ in range(2))
    got = lstm_cell.lstm_bwd(torch.from_numpy(dy), gates, cseq,
                             torch.from_numpy(d["rw"]).bfloat16(), torch.from_numpy(d["peep"]),
                             torch.from_numpy(mask_tm), torch.from_numpy(d["c0"]),
                             torch.from_numpy(dhT), torch.from_numpy(dcT))
    pk = np.zeros((8, H), np.float32)
    pk[:3] = d["peep"]
    want = jlk._bwd_call(jnp.asarray(dy), jnp.asarray(gates.numpy()), jnp.asarray(cseq.numpy()),
                         jnp.asarray(d["rw"]).astype(jnp.bfloat16).T, jnp.asarray(pk),
                         jnp.broadcast_to(jnp.asarray(mask_tm)[..., None], (T, B, 8)),
                         jnp.asarray(d["c0"]), jnp.asarray(dhT), jnp.asarray(dcT))
    for name, g, w in zip(("dz", "dh0", "dc0", "dpeep"), got,
                          (want[0], want[1], want[2], want[3][:3])):
        assert _rel(g.numpy(), w) <= TOL_BF16, (name, _rel(g.numpy(), w))


def test_gradcheck_f64_plain_path():
    """Analytic gradients (the plain K2 and the dRW product) against finite
    differences of the plain K1, in f64 at a tiny size with peepholes and
    a fractional mask."""
    g = torch.Generator().manual_seed(0)
    b, t, h = 2, 3, 4
    f64 = dict(dtype=torch.float64)

    def rnd(*s, scale=1.0):
        return (torch.randn(s, generator=g, **f64) * scale).requires_grad_()

    args = (rnd(t, b, 4 * h), rnd(h, 4 * h, scale=0.5), rnd(3, h, scale=0.3),
            rnd(b, h, scale=0.5), rnd(b, h, scale=0.5),
            torch.rand((t, b), generator=g, **f64))
    assert torch.autograd.gradcheck(lstm_cell.LSTMFunction.apply, args, eps=1e-6,
                                    atol=1e-7, rtol=1e-5)


def test_inference_takes_no_reserve_and_training_takes_the_function(monkeypatch):
    """Under no_grad the inference forward runs (no reserve); while
    autograd records, LSTMFunction does."""
    d = _inputs(50, None)
    calls = []
    real = lstm_cell.lstm_fwd

    def spy(*a, **k):
        calls.append(bool(k.get("save_reserve", False)))
        return real(*a, **k)

    monkeypatch.setattr(lstm_cell, "lstm_fwd", spy)
    rw = torch.from_numpy(d["rw"]).requires_grad_()
    args = (torch.from_numpy(d["xp"]), rw, None, torch.from_numpy(d["h0"]),
            torch.from_numpy(d["c0"]))
    with torch.no_grad():
        lstm_cell.lstm_scan(*args)
    lstm_cell.lstm_scan(*args)
    assert calls == [False, True]


def test_backward_wrapper_refuses_other_devices():
    x = torch.empty((T, B, H), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lstm_cell.lstm_bwd(x, x, x, x, None, None, x, x, x)
