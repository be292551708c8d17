"""K1 parity: the port's persistent-LSTM forward against the JAX kernel.

The same inputs, made with numpy from a seed, go through the JAX Pallas
kernel (``lstm_cell.lstm_scan`` in interpret mode, as the JAX package's own
tests run it) and through the port's ``lstm_scan``, which on CPU tensors
takes the kernel's plain version. Tolerances: 1e-5 with f32 recurrent
weights (the same f32 sums in another order); 2e-2 with bf16 weights, where
h is rounded to bf16 before every product and a last-bit difference can
move one operand by a bf16 unit.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import deeplearning4j_tpu.ops.flash_attention as fa
import deeplearning4j_tpu.ops.lstm_cell as jlk
from deeplearning4j_torch.ops import lstm_cell

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


def _inputs(seed, peep, mask_kind):
    rng = np.random.default_rng(seed)
    d = {
        "xp": rng.standard_normal((B, T, 4 * H)).astype(np.float32),
        "rw": (rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32),
        "h0": (0.5 * rng.standard_normal((B, H))).astype(np.float32),
        "c0": (0.5 * rng.standard_normal((B, H))).astype(np.float32),
        "peep": ((0.3 * rng.standard_normal((3, H))).astype(np.float32)
                 if peep else None),
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


def _jax(d, wdtype):
    peep = None if d["peep"] is None else tuple(jnp.asarray(p) for p in d["peep"])
    mask = None if d["mask"] is None else jnp.asarray(d["mask"])
    ys, (hT, cT) = jlk.lstm_scan(jnp.asarray(d["xp"]),
                                 jnp.asarray(d["rw"]).astype(wdtype), peep,
                                 jnp.asarray(d["h0"]), jnp.asarray(d["c0"]), mask)
    return [np.asarray(a, np.float32) for a in (ys, hT, cT)]


def _torch(d, wdtype):
    peep = None if d["peep"] is None else tuple(torch.from_numpy(p) for p in d["peep"])
    mask = None if d["mask"] is None else torch.from_numpy(d["mask"])
    ys, (hT, cT) = lstm_cell.lstm_scan(torch.from_numpy(d["xp"]),
                                       torch.from_numpy(d["rw"]).to(wdtype), peep,
                                       torch.from_numpy(d["h0"]),
                                       torch.from_numpy(d["c0"]), mask)
    return [a.numpy() for a in (ys, hT, cT)]


@pytest.mark.parametrize("wname", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask_kind", [None, "binary", "fractional"])
@pytest.mark.parametrize("peep", [True, False])
def test_plain_matches_jax_kernel(peep, mask_kind, wname):
    seed = 10 * int(peep) + [None, "binary", "fractional"].index(mask_kind)
    d = _inputs(seed, peep=peep, mask_kind=mask_kind)
    want = _jax(d, getattr(jnp, wname))
    got = _torch(d, getattr(torch, wname))
    for name, g, w in zip(("ys", "hT", "cT"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL[wname], err_msg=name)


def test_mask_zero_steps_carry_state():
    """A fully masked step leaves (h, c) unchanged: ys repeats the previous
    h, the property time-bucket padding relies on."""
    d = _inputs(seed=5, peep=True, mask_kind=None)
    m = np.ones((B, T), np.float32)
    m[:, 3:] = 0.0
    d["mask"] = m
    ys, hT, cT = _torch(d, torch.float32)
    np.testing.assert_array_equal(ys[:, 3], ys[:, 2])
    np.testing.assert_array_equal(hT, ys[:, 2])


def test_wrapper_refuses_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA card reaches no
    version of the kernel."""
    x = torch.empty((T, B, 4 * H), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lstm_cell.lstm_fwd(x, x, None, None, x, x)
