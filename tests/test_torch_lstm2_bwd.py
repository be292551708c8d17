"""K3 training forward and K4 parity: the port's fused-pair reserve and
gradients against the JAX kernels.

The same inputs, made with numpy from a seed, go through the JAX Pallas
kernels in interpret mode (``lstm_fused._fwd2(save_reserve=True)`` and
``jax.grad`` through ``lstm_fused.lstm_scan2``, whose custom VJP is
``_bwd2_kernel``) and through the port (``lstm2_fwd(save_reserve=True)``
and autograd through ``lstm_scan2`` -> ``LSTM2Function``, which on CPU
tensors takes the plain versions of K3 and K4).

Tolerances, as max |port - jax| over max |jax| per tensor, with the
reasoning of ``test_torch_lstm_bwd.py``: 1e-5 with f32 weights (measured
<= 1e-6), which pins the math. With bf16 weights, h1, h2, dz1 and dz2 are
rounded to bf16 before each of five products per step, so a last-bit f32
difference moves one operand by one bf16 unit (2^-8) and that carries back
through the steps and across the layers: 5e-3 for the inputs' and states'
gradients (measured <= 2.1e-3 over four seeds) and 1e-2, about two and a
half bf16 units at the largest entry, for the weight gradients, which are
themselves rounded to bf16 (measured <= 5.2e-3).
"""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.ops.flash_attention as fa
import deeplearning4j_tpu.ops.lstm_fused as jlf
from deeplearning4j_torch.ops import lstm_cell, lstm_fused

B, T, H = 8, 6, 128
TOL = 1e-5
TOL_BF16 = 5e-3
TOL_W_BF16 = 1e-2
WEIGHTS = ("rw1", "w2", "rw2")


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


def _inputs(seed):
    rng = np.random.default_rng(seed)
    w = lambda: (rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    st = lambda: (0.5 * rng.standard_normal((B, H))).astype(np.float32)
    return {
        "xp": rng.standard_normal((B, T, 4 * H)).astype(np.float32),
        "rw1": w(), "w2": w(), "rw2": w(),
        "b2": (0.1 * rng.standard_normal(4 * H)).astype(np.float32),
        "peep1": (0.3 * rng.standard_normal((3, H))).astype(np.float32),
        "peep2": (0.3 * rng.standard_normal((3, H))).astype(np.float32),
        "h01": st(), "c01": st(), "h02": st(), "c02": st(),
        # cotangents of ys2 and the four final states
        "ry": rng.standard_normal((B, T, H)).astype(np.float32),
        "rs": rng.standard_normal((4, B, H)).astype(np.float32),
    }


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max())


def _names(peep):
    return (["xp", *WEIGHTS, "b2", "h01", "c01", "h02", "c02"]
            + (["peep1", "peep2"] if peep else []))


def _jax_grads(d, wdtype, peep):
    names = _names(peep)

    def loss(*args):
        a = dict(zip(names, args))
        p1 = tuple(a["peep1"]) if peep else None
        p2 = tuple(a["peep2"]) if peep else None
        ys2, hc1, hc2 = jlf.lstm_scan2(a["xp"], a["rw1"].astype(wdtype), p1,
                                       a["w2"].astype(wdtype), a["b2"],
                                       a["rw2"].astype(wdtype), p2,
                                       a["h01"], a["c01"], a["h02"], a["c02"])
        states = jnp.stack([*hc1, *hc2])
        return jnp.sum(ys2 * d["ry"]) + jnp.sum(states * d["rs"])

    grads = jax.grad(loss, argnums=tuple(range(len(names))))(
        *(jnp.asarray(d[n]) for n in names))
    return dict(zip(names, grads))


def _torch_grads(d, wdtype, peep):
    t = {n: torch.tensor(d[n], requires_grad=True) for n in _names(peep)}
    ys2, hc1, hc2 = lstm_fused.lstm_scan2(
        t["xp"], t["rw1"].to(wdtype), tuple(t["peep1"]) if peep else None,
        t["w2"].to(wdtype), t["b2"], t["rw2"].to(wdtype),
        tuple(t["peep2"]) if peep else None, t["h01"], t["c01"], t["h02"], t["c02"])
    states = torch.stack([*hc1, *hc2])
    loss = (ys2 * torch.from_numpy(d["ry"])).sum() + (states * torch.from_numpy(d["rs"])).sum()
    loss.backward()
    return {n: v.grad.numpy() for n, v in t.items()}


@pytest.mark.parametrize("wname", ["float32", "bfloat16"])
@pytest.mark.parametrize("peep", [True, False])
def test_gradients_match_jax_kernel(peep, wname):
    d = _inputs(60 + int(peep))
    want = _jax_grads(d, getattr(jnp, wname), peep)
    got = _torch_grads(d, getattr(torch, wname), peep)
    for name, w in want.items():
        tol = TOL
        if wname == "bfloat16":
            tol = TOL_W_BF16 if name in WEIGHTS else TOL_BF16
        assert got[name].shape == w.shape, name
        assert _rel(got[name], w) <= tol, (name, _rel(got[name], w))


def _time_major(d):
    xp = np.swapaxes(d["xp"], 0, 1).copy()
    h0 = np.stack([d["h01"], d["c01"], d["h02"], d["c02"]])
    pk = np.zeros((8, H), np.float32)
    pk[:3], pk[3:6] = d["peep1"], d["peep2"]
    return xp, h0, pk


@pytest.mark.parametrize("wname", ["float32", "bfloat16"])
def test_reserve_matches_jax_fwd2(wname):
    """ys1, g1, c1, g2, c2 of the training forward against the JAX
    ``_fwd2(save_reserve=True)``."""
    d = _inputs(70)
    xp, h0, pk = _time_major(d)
    jw = [jnp.asarray(d[n]).astype(getattr(jnp, wname)) for n in WEIGHTS]
    b2row = jnp.zeros((8, 4 * H), jnp.float32).at[0].set(jnp.asarray(d["b2"]))
    ys1, ys2, g1, c1, g2, c2, hc = jlf._fwd2(jnp.asarray(xp), jw[0], jw[1], b2row, jw[2],
                                             jnp.asarray(pk), jnp.asarray(h0),
                                             save_reserve=True)
    tw = [torch.from_numpy(d[n]).to(getattr(torch, wname)) for n in WEIGHTS]
    got = lstm_fused.lstm2_fwd(torch.from_numpy(xp), *tw, torch.from_numpy(d["b2"]),
                               torch.from_numpy(pk[:6].copy()), torch.from_numpy(h0),
                               save_reserve=True)
    tol = TOL if wname == "float32" else TOL_BF16
    for name, g, w in zip(("ys2", "hc", "ys1", "g1", "c1", "g2", "c2"), got,
                          (ys2, hc, ys1, g1, c1, g2, c2)):
        assert tuple(g.shape) == tuple(w.shape), name
        assert _rel(g.numpy(), w) <= tol, (name, _rel(g.numpy(), w))


def test_backward_kernel_plain_matches_jax_bwd2_call():
    """K4's plain version on its own, against ``_bwd2_call`` on the same dy,
    reserve and state cotangents (bf16 weights, peepholes)."""
    d = _inputs(80)
    rng = np.random.default_rng(81)
    xp, h0, pk = _time_major(d)
    tw = [torch.from_numpy(d[n]).bfloat16() for n in WEIGHTS]
    peep = torch.from_numpy(pk[:6].copy())
    _, _, _, g1, c1, g2, c2 = lstm_fused.lstm2_fwd_plain(
        torch.from_numpy(xp), *tw, torch.from_numpy(d["b2"]), peep, torch.from_numpy(h0),
        save_reserve=True)
    dy = rng.standard_normal((T, B, H)).astype(np.float32)
    dhcT = rng.standard_normal((4, B, H)).astype(np.float32)
    c0 = np.stack([d["c01"], d["c02"]])
    got = lstm_fused.lstm2_bwd(torch.from_numpy(dy), g1, c1, g2, c2, *tw, peep,
                               torch.from_numpy(c0), torch.from_numpy(dhcT))
    jwt = [jnp.asarray(d[n]).astype(jnp.bfloat16).T for n in WEIGHTS]
    want = jlf._bwd2_call(jnp.asarray(dy), *(jnp.asarray(a.numpy()) for a in (g1, c1, g2, c2)),
                          *jwt, jnp.asarray(pk), jnp.asarray(c0), jnp.asarray(dhcT))
    for name, g, w in zip(("dz1", "dz2", "dhc0", "dpeep"), got,
                          (want[0], want[1], want[2], want[3][:6])):
        assert _rel(g.numpy(), w) <= TOL_BF16, (name, _rel(g.numpy(), w))


def test_gradcheck_f64_plain_path():
    """Analytic gradients (the plain K4 and the four weight products)
    against finite differences of the plain K3, in f64 at a tiny size."""
    g = torch.Generator().manual_seed(1)
    b, t, h = 2, 3, 4
    f64 = dict(dtype=torch.float64)

    def rnd(*s, scale=1.0):
        return (torch.randn(s, generator=g, **f64) * scale).requires_grad_()

    args = (rnd(t, b, 4 * h), rnd(h, 4 * h, scale=0.5), rnd(h, 4 * h, scale=0.5),
            rnd(h, 4 * h, scale=0.5), rnd(4 * h, scale=0.1), rnd(6, h, scale=0.3),
            rnd(4, b, h, scale=0.5))
    assert torch.autograd.gradcheck(lstm_fused.LSTM2Function.apply, args, eps=1e-6,
                                    atol=1e-7, rtol=1e-5)


def test_backward_wrapper_refuses_other_devices():
    x = torch.empty((T, B, H), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lstm_fused.lstm2_bwd(x, x, x, x, x, x, x, x, None, x, x)


def _c_parameters(entry):
    """The parameter list of ``extern "C" int <entry>(...)`` in the port's
    CUDA sources, one declaration a string."""
    csrc = Path(lstm_fused.__file__).resolve().parent.parent / "csrc"
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


@pytest.mark.parametrize("entry,module,argtypes", [
    ("dl4j_lstm_fwd", lstm_cell, "_ARGTYPES"),
    ("dl4j_lstm_bwd", lstm_cell, "_BWD_ARGTYPES"),
    ("dl4j_lstm2_fwd", lstm_fused, "_ARGTYPES"),
    ("dl4j_lstm2_bwd", lstm_fused, "_BWD_ARGTYPES"),
    ("dl4j_lstm2_bwd_tc", lstm_fused, "_ROUTE_ARGTYPES"),
    ("dl4j_lstm2_bwd_units", lstm_fused, "_ROUTE_ARGTYPES"),
    ("dl4j_lstm2_fwd_tc", lstm_fused, "_FWD_ROUTE_ARGTYPES"),
    ("dl4j_lstm2_fwd_units", lstm_fused, "_FWD_ROUTE_ARGTYPES"),
    ("dl4j_lstm_fwd_tc", lstm_cell, "_FWD_ROUTE_ARGTYPES"),
    ("dl4j_lstm_fwd_units", lstm_cell, "_FWD_ROUTE_ARGTYPES"),
    ("dl4j_lstm_bwd_tc", lstm_cell, "_ROUTE_ARGTYPES"),
    ("dl4j_lstm_bwd_units", lstm_cell, "_ROUTE_ARGTYPES")])
def test_ctypes_argtypes_match_the_c_entries(entry, module, argtypes):
    """Each LSTM wrapper's ctypes declaration against its C entry's
    parameter list: the count, and for each parameter whether it is a
    pointer, an int or a float. ctypes passes an int where the C side reads
    a pointer as 32 bits, which only a launch on the card would show."""
    kinds = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_float: "float"}
    declared = [kinds[t] for t in getattr(module, argtypes)]
    params = _c_parameters(entry)
    assert declared == [_c_kind(p) for p in params], list(zip(params, declared))
