"""Routing by what the kernels take, decided before any launch.

- The LSTM pair: ``MultiLayerNetwork._lstm_pair_fusable`` fuses two
  layers into K3 (and K4 in training) only when ``lstm_fused.fwd_route``
  (with the reserve in training) and, in training, ``bwd_route`` name a
  grid, and H % 8 == 0, the role of the JAX package's
  ``lstm_fused.supported2``. Other pairs run as two per-layer calls, as in
  the reference. On the CPU the route functions answer for the plain loop
  (every shape), so the CPU tests stub them to stand for a card with no
  grid. f32: the fused and per-layer plain loops do the same arithmetic,
  so outputs agree within 1e-6 and parameters after a fit within 1e-5.
- Flash attention: ``ops/flash_attention.supported`` admits what K5-K7
  take: bf16 head dims up to 256, f32 up to 128, at most 65535 batch x
  heads. The JAX package admits f32 up to 256 and any bh; past the
  kernels' limits the port runs ``mha``'s dense body, which computes the
  same attention (held here against the flash plain version, f32, 1e-5).
"""
import numpy as np
import pytest
import torch

from deeplearning4j_torch import DataSet, NeuralNetConfiguration, Sgd
from deeplearning4j_torch.nn.conf.layers import GravesLSTM, RnnOutputLayer
from deeplearning4j_torch.nn.layers import attention
from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_torch.ops import flash_attention as fa
from deeplearning4j_torch.ops import lstm_cell, lstm_fused

V = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _pair_net(H=16):
    conf = (NeuralNetConfiguration.builder().seed(3).activation("tanh")
            .updater(Sgd(learning_rate=0.1)).list()
            .layer(GravesLSTM(n_in=V, n_out=H)).layer(GravesLSTM(n_in=H, n_out=H))
            .layer(RnnOutputLayer(n_in=H, n_out=V, activation="softmax", loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf).init(device="cpu")


def _data(seed=0, b=4, t=7):
    rng = np.random.default_rng(seed)
    eye = np.eye(V, dtype=np.float32)
    ids = rng.integers(0, V, (b, t + 1))
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(module, name, spy)
    return calls


def _no_grid(*args, **kwargs):
    return False, 0


def test_cpu_routes_take_every_shape():
    assert lstm_fused.fwd_route(torch.float32, 32, 512, reserve=True, device="cpu") == (False, 512)
    assert lstm_fused.bwd_route(torch.bfloat16, 65, 64, device=torch.device("cpu")) == (False, 64)
    net = _pair_net()
    x = torch.zeros((4, 7, V))
    assert net._lstm_pair_fusable(0, x, None, train=False)
    assert net._lstm_pair_fusable(0, x, None, train=True)


@pytest.mark.parametrize("stub", ["fwd_route", "bwd_route"])
def test_pair_without_a_grid_runs_per_layer(monkeypatch, stub):
    """No K3 grid: output, rnn_time_step and fit run per layer. No K4
    grid: inference still fuses, fit runs per layer."""
    f, l = _data()
    fused = _pair_net()
    want_out = fused.output(f)
    want_step = fused.rnn_time_step(f[:, :3])
    fused.fit(f, l)

    monkeypatch.setattr(lstm_fused, stub, _no_grid)
    net = _pair_net()
    x = torch.from_numpy(f)
    assert net._lstm_pair_fusable(0, x, None, train=False) == (stub == "bwd_route")
    assert not net._lstm_pair_fusable(0, x, None, train=True)
    pair = _spy(monkeypatch, lstm_fused, "lstm_scan2")
    per_layer = _spy(monkeypatch, lstm_cell, "lstm_scan")
    out = net.output(f)
    step = net.rnn_time_step(f[:, :3])
    assert (len(pair), len(per_layer)) == ((2, 0) if stub == "bwd_route" else (0, 4))
    torch.testing.assert_close(out, want_out, rtol=0, atol=1e-6)
    torch.testing.assert_close(step, want_step, rtol=0, atol=1e-6)
    del pair[:], per_layer[:]
    net.fit(f, l)
    assert (len(pair), len(per_layer)) == (0, 2)
    for i, ps in fused.params.items():
        for k, p in ps.items():
            torch.testing.assert_close(net.params[i][k], p, rtol=0, atol=1e-5)


def test_pair_with_h_not_a_multiple_of_8_runs_per_layer(monkeypatch):
    net = _pair_net(H=12)
    f, l = _data(1)
    assert not net._lstm_pair_fusable(0, torch.from_numpy(f), None, train=False)
    pair = _spy(monkeypatch, lstm_fused, "lstm_scan2")
    per_layer = _spy(monkeypatch, lstm_cell, "lstm_scan")
    assert tuple(net.output(f).shape) == (4, 7, V)
    net.fit(DataSet(f, l))
    assert np.isfinite(net.score())
    assert (len(pair), len(per_layer)) == (0, 4)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 128, True), (torch.bfloat16, 136, True), (torch.bfloat16, 256, True),
    (torch.bfloat16, 264, False), (torch.float32, 128, True), (torch.float32, 136, False),
    (torch.float32, 256, False), (torch.float16, 64, False)])
def test_flash_supported_says_what_the_kernels_take(dtype, d, want):
    assert fa.supported(8192, d, 0.0, None, dtype=dtype, bh=32) is want


def test_flash_supported_refuses_more_than_65535_heads():
    assert fa.supported(8192, 64, 0.0, None, dtype=torch.bfloat16, bh=65535)
    assert not fa.supported(8192, 64, 0.0, None, dtype=torch.bfloat16, bh=65536)


@pytest.mark.parametrize("dtype,d,flash", [(torch.float32, 136, False),
                                           (torch.float32, 64, True),
                                           (torch.bfloat16, 136, True)])
def test_mha_routes_f32_wide_heads_to_the_dense_body(monkeypatch, dtype, d, flash):
    """At T=256 with the short-sequence switch on (MIN_SEQ lowered to 256):
    f32 heads past 128 take the dense body, whose forward and gradients
    equal the flash plain versions' in f32."""
    monkeypatch.setattr(fa, "_FORCE_SHORT_SEQ", True)
    calls = _spy(monkeypatch, fa, "flash_attention")
    g = torch.Generator().manual_seed(5)
    b, T, h = 1, 256, 2
    q, k, v = (torch.randn((b, T, h, d), generator=g, requires_grad=True) for _ in range(3))
    o = attention.mha(q, k, v, True, dtype)
    assert len(calls) == int(flash)
    if dtype != torch.float32:
        return
    do = torch.randn(o.shape, generator=g)
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)

    def bh(x):
        return x.detach().permute(0, 2, 1, 3).reshape(b * h, T, d)

    scale = 1.0 / d ** 0.5
    o_ref, lse = fa.flash_fwd_plain(bh(q), bh(k), bh(v), None, True, scale)
    delta = fa.rowwise_delta(bh(do), o_ref)
    dq_ref = fa.flash_dq_plain(bh(q), bh(k), bh(v), None, bh(do), delta, lse, True, scale)
    dk_ref, dv_ref = fa.flash_dkv_plain(bh(q), bh(k), bh(v), None, bh(do), delta, lse, True,
                                        scale)
    for got, ref in ((o, o_ref), (dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        torch.testing.assert_close(bh(got), ref, rtol=0, atol=1e-5)
