"""K3 parity: the port's fused two-layer LSTM forward against the JAX kernel.

The same numpy inputs go through ``lstm_fused.lstm_scan2`` of the JAX
package (Pallas, interpret mode) and through the port's ``lstm_scan2``
(the kernel's plain version on CPU tensors). Tolerances as in
``test_torch_lstm_cell.py``: 1e-5 with f32 weights, 2e-2 with bf16 weights
(h1 and h2 are rounded to bf16 before each of the three products).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import deeplearning4j_tpu.ops.flash_attention as fa
import deeplearning4j_tpu.ops.lstm_fused as jlf
from deeplearning4j_torch.ops import lstm_cell, lstm_fused

B, T, H = 8, 6, 128
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}


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


def _inputs(seed, peep):
    rng = np.random.default_rng(seed)
    w = lambda: (rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    st = lambda: (0.5 * rng.standard_normal((B, H))).astype(np.float32)
    return {
        "xp1": rng.standard_normal((B, T, 4 * H)).astype(np.float32),
        "rw1": w(), "w2": w(), "rw2": w(),
        "b2": (0.1 * rng.standard_normal(4 * H)).astype(np.float32),
        "peep1": ((0.3 * rng.standard_normal((3, H))).astype(np.float32)
                  if peep else None),
        "peep2": ((0.3 * rng.standard_normal((3, H))).astype(np.float32)
                  if peep else None),
        "states": [st() for _ in range(4)],
    }


def _run(d, wdtype, lib, asarray, cast):
    peeps = [None if d[k] is None else tuple(asarray(p) for p in d[k])
             for k in ("peep1", "peep2")]
    ys2, hc1, hc2 = lib.lstm_scan2(
        asarray(d["xp1"]), cast(asarray(d["rw1"]), wdtype), peeps[0],
        cast(asarray(d["w2"]), wdtype), asarray(d["b2"]),
        cast(asarray(d["rw2"]), wdtype), peeps[1],
        *(asarray(s) for s in d["states"]))
    return [np.asarray(a, np.float32) for a in (ys2, *hc1, *hc2)]


def _jax(d, wname):
    return _run(d, getattr(jnp, wname), jlf, jnp.asarray, lambda a, t: a.astype(t))


def _torch(d, wname):
    return _run(d, getattr(torch, wname), lstm_fused, torch.from_numpy,
                lambda a, t: a.to(t))


@pytest.mark.parametrize("wname", ["float32", "bfloat16"])
@pytest.mark.parametrize("peep", [True, False])
def test_plain_matches_jax_kernel(peep, wname):
    d = _inputs(seed=int(peep), peep=peep)
    for name, g, w in zip(("ys2", "h1T", "c1T", "h2T", "c2T"), _torch(d, wname),
                          _jax(d, wname)):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL[wname], err_msg=name)


def test_fused_equals_two_single_layers():
    """With f32 weights the fused loop is exactly K1 twice, layer 2's
    projection taken in f32 from layer 1's output."""
    d = _inputs(seed=3, peep=True)
    t = {k: torch.from_numpy(v) for k, v in d.items() if k not in ("peep1", "peep2", "states")}
    p1 = tuple(torch.from_numpy(p) for p in d["peep1"])
    p2 = tuple(torch.from_numpy(p) for p in d["peep2"])
    h01, c01, h02, c02 = (torch.from_numpy(s) for s in d["states"])
    ys1, _ = lstm_cell.lstm_scan(t["xp1"], t["rw1"], p1, h01, c01)
    xp2 = ys1 @ t["w2"] + t["b2"]
    ys2_ref, (h2, c2) = lstm_cell.lstm_scan(xp2, t["rw2"], p2, h02, c02)
    ys2, _, (h2f, c2f) = lstm_fused.lstm_scan2(t["xp1"], t["rw1"], p1, t["w2"], t["b2"],
                                               t["rw2"], p2, h01, c01, h02, c02)
    torch.testing.assert_close(ys2, ys2_ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(h2f, h2, rtol=0, atol=1e-5)


def test_mixed_peepholes_refused():
    d = _inputs(seed=4, peep=True)
    d["peep2"] = None
    with pytest.raises(ValueError, match="peepholes"):
        _torch(d, "float32")
