"""Sequence parallelism of the port (``deeplearning4j_torch/parallel/
sequence.py``) against the JAX package's: the dense ring and Ulysses
bodies, the ring and Ulysses on the flash kernels (the port's plain
versions here, JAX's Pallas kernels in interpret mode), with and without
dropout at a seed, forward and gradients, and ``sequence_parallel_step``
against the unsharded step. Oracles: ``tests/test_parallel.py``'s ring
tests, ``tests/test_flash_attention.py:443-925`` and
``tests/test_flash_dropout.py:161-220``. The JAX side runs on its 8
virtual CPU devices, the port on ``cpu`` slots.

Tolerances: f32 operands; the ring merges per-block (o, lse) where the
single kernel normalises once, so results part by f32 rounding: ATOL
2e-5 on outputs of unit scale, GRAD_ATOL 2e-4 on gradients (the JAX
tests' own limits, measured 1e-7 to 5e-6). The steps' losses within
LOSS_RTOL 1e-5, parameters within 3e-4 of the unsharded step's (JAX's
limit; Adam's lr is 1e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.ops.flash_attention as jfa
from deeplearning4j_tpu.parallel import (full_attention as jfull, make_mesh as jmake,
                                         ring_attention as jring_dense,
                                         ring_flash_attention as jring,
                                         sequence_parallel_step as jsp,
                                         ulysses_attention as julysses_dense,
                                         ulysses_flash_attention as julysses)
from deeplearning4j_tpu.utils.model_serializer import ModelSerializer

from deeplearning4j_torch import Adam, DataSet, NeuralNetConfiguration, Sgd
from deeplearning4j_torch.nn.conf.layers import (LSTM, BatchNormalization, DenseLayer,
                                                 MoEDenseLayer, RnnOutputLayer,
                                                 SelfAttentionLayer)
from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_torch.ops import flash_attention as fa
from deeplearning4j_torch.parallel import (current_sp_axis, full_attention, make_mesh,
                                           ring_attention, ring_flash_attention,
                                           ring_flash_supported, sequence_parallel_step,
                                           ulysses_attention, ulysses_flash_attention,
                                           ulysses_flash_supported)
from deeplearning4j_torch.parallel import sequence as seq
from deeplearning4j_torch.utils.model_serializer import restore_model

ATOL, GRAD_ATOL = 2e-5, 2e-4
LOSS_RTOL, PARAM_ATOL = 1e-5, 3e-4
SEQ4 = ["cpu"] * 4


@pytest.fixture(autouse=True)
def _kernels_on_cpu():
    """JAX's Pallas kernels in interpret mode; the port's flash route from
    T = 256 (its plain versions on the CPU), as the other flash tests."""
    old = jfa._FORCE_INTERPRET, fa._FORCE_SHORT_SEQ, torch.get_num_threads()
    jfa._FORCE_INTERPRET, fa._FORCE_SHORT_SEQ = True, True
    torch.set_num_threads(1)
    yield
    jfa._FORCE_INTERPRET, fa._FORCE_SHORT_SEQ = old[:2]
    torch.set_num_threads(old[2])


@pytest.fixture
def launches(monkeypatch):
    """K5/K6/K7 calls by name (the plain versions run on the CPU)."""
    got = {"flash_fwd": 0, "dq_block": 0, "dkv_block": 0}
    for name in got:
        real = getattr(fa, name)

        def spy(*a, _real=real, _name=name, **k):
            got[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(fa, name, spy)
    return got


def _qkv(b, T, h, d, seed=31):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, T, h, d)).astype(np.float32) for _ in range(3)]


def _grads(fn, arrays):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    o = fn(*ts)
    (o ** 2).sum().backward()
    return o.detach().numpy(), [t.grad.numpy() for t in ts]


def _near(got, want, atol):
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


# ------------------------------------------------------------ functions
def test_dense_ring_ulysses_and_full_match_jax():
    """The dense bodies: the ring (causal, online softmax over the blocks)
    and Ulysses (non-causal) == JAX's; both == full attention."""
    q, k, v = _qkv(2, 4 * 16, 4, 8)
    mesh, jm = make_mesh(SEQ4, axes=("sequence",)), jmake(jax.devices()[:4], axes=("sequence",))
    ts = [torch.tensor(a) for a in (q, k, v)]
    js = [jnp.asarray(a) for a in (q, k, v)]
    for causal in (True, False):
        want = np.asarray(jfull(*js, causal=causal))
        _near(full_attention(*ts, causal=causal).numpy(), want, ATOL)
        _near(ring_attention(*ts, mesh, causal=causal).numpy(), want, ATOL)
        _near(ulysses_attention(*ts, mesh, causal=causal).numpy(), want, ATOL)
    _near(ring_attention(*ts, mesh, causal=True).numpy(),
          np.asarray(jring_dense(*js, jm, causal=True)), ATOL)
    _near(ulysses_attention(*ts, mesh).numpy(), np.asarray(julysses_dense(*js, jm)), ATOL)


def test_ring_flash_with_dropout_matches_jax_and_the_single_kernel():
    """The ring on the flash kernels with dropout 0.2 at a seed: JAX's ring
    forward (keep bits from the same hash at the same global coordinates),
    and the port's single kernel over the whole T, forward and gradients
    (the single kernel's dropout gradients are held against JAX's in
    ``test_torch_flash_attention.py``)."""
    arrs = _qkv(1, 4 * 128, 1, 16)
    mesh, jm = make_mesh(SEQ4, axes=("sequence",)), jmake(jax.devices()[:4], axes=("sequence",))
    o, g = _grads(lambda q, k, v: ring_flash_attention(q, k, v, mesh, causal=True,
                                                       dropout_rate=0.2, dropout_seed=7), arrs)
    jo = np.asarray(jring(*[jnp.asarray(a) for a in arrs], jm, causal=True, dropout_rate=0.2,
                          dropout_seed=7))
    so, sg = _grads(lambda q, k, v: fa.flash_attention(q, k, v, causal=True, dropout_rate=0.2,
                                                       dropout_seed=7), arrs)
    _near(o, jo, ATOL)
    _near(o, so, ATOL)
    for a, c in zip(g, sg):
        _near(a, c, GRAD_ATOL)
    no_drop = ring_flash_attention(*[torch.tensor(a) for a in arrs], mesh, causal=True)
    assert np.abs(no_drop.numpy() - o).max() > 1e-3            # dropout is active
    with pytest.raises(ValueError, match="dropout_seed"):
        ring_flash_attention(*[torch.tensor(a) for a in arrs], mesh, dropout_rate=0.1)


@pytest.mark.parametrize("causal, blocks", [(True, 10), (False, 16)])
def test_ring_flash_matches_full_and_skips_invisible_blocks(launches, causal, blocks):
    """Forward and gradients == dense full attention; a block no causal
    query sees is not launched (10 of 16 over 4 slots), backward too."""
    arrs = _qkv(2, 4 * 128, 2, 16)
    mesh = make_mesh(SEQ4, axes=("sequence",))
    o, g = _grads(lambda q, k, v: ring_flash_attention(q, k, v, mesh, causal=causal), arrs)
    assert launches == {"flash_fwd": blocks, "dq_block": blocks, "dkv_block": blocks}
    wo, wg = _grads(lambda q, k, v: full_attention(q, k, v, causal=causal), arrs)
    _near(o, wo, ATOL)
    for a, b in zip(g, wg):
        _near(a, b, GRAD_ATOL)


def test_ulysses_flash_matches_jax_and_full(launches):
    """Ulysses: the head/sequence swap, one kernel a slot over the whole T
    for h/n heads (4 launches), == JAX's Ulysses and full attention."""
    arrs = _qkv(1, 4 * 128, 4, 16, seed=3)
    mesh, jm = make_mesh(SEQ4, axes=("sequence",)), jmake(jax.devices()[:4], axes=("sequence",))
    o, g = _grads(lambda q, k, v: ulysses_flash_attention(q, k, v, mesh, causal=True), arrs)
    assert launches == {"flash_fwd": 4, "dq_block": 4, "dkv_block": 4}
    jo = np.asarray(julysses(*[jnp.asarray(a) for a in arrs], jm, causal=True))
    wo, wg = _grads(lambda q, k, v: full_attention(q, k, v, causal=True), arrs)
    _near(o, jo, ATOL)
    _near(o, wo, ATOL)
    for a, c in zip(g, wg):
        _near(a, c, GRAD_ATOL)


def test_supported_checks():
    from deeplearning4j_tpu.parallel import (ring_flash_supported as jrs,
                                             ulysses_flash_supported as jus)
    for T, n, d in ((4 * 128, 4, 32), (4 * 100, 4, 32), (4 * 128, 4, 300), (8 * 128, 3, 32)):
        assert ring_flash_supported(T, n, d) == jrs(T, n, d), (T, n, d)
    for T, n, h, d in ((4 * 128, 4, 4, 32), (4 * 128, 4, 2, 32), (4 * 100, 4, 4, 32)):
        assert ulysses_flash_supported(T, n, h, d) == jus(T, n, h, d), (T, n, h, d)
    assert not ring_flash_supported(4 * 128, 4, 192, torch.float32)   # f32 kernels: d <= 128


# ------------------------------------------------------------- the step
def _mln(heads=2, rate=0.0, l2=1e-3, dense=True, seed=5):
    b = (NeuralNetConfiguration.builder().seed(seed).updater(Adam(learning_rate=1e-3))
         .activation("identity").l2(l2).list()
         .layer(SelfAttentionLayer(n_in=16, n_out=16, num_heads=heads, causal=True,
                                   dropout_rate=rate)))
    if dense:
        b = b.layer(DenseLayer(n_in=16, n_out=16, activation="relu"))
    conf = b.layer(RnnOutputLayer(n_in=16, n_out=4, activation="softmax",
                                  loss="mcxent")).build()
    return MultiLayerNetwork(conf).init(device="cpu")


def _seq_data(b=2, T=4 * 128, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, T, 16)).astype(np.float32),
            np.eye(4, dtype=np.float32)[rng.integers(0, 4, (b, T))])


def _same(a, b, atol=PARAM_ATOL):
    for k in a.params:
        for p in a.params[k]:
            torch.testing.assert_close(a.params[k][p], b.params[k][p], rtol=3e-3, atol=atol)


def test_sp_step_ring_with_l2_matches_the_unsharded_step(launches):
    """Time-sharded MLN step (heads indivisible -> the ring): the n-1 extra
    copies of the l2 term removed, loss and parameters == the unsharded
    step's; the ring's causal blocks launched."""
    f, l = _seq_data()
    a, b = _mln(), _mln()
    step = sequence_parallel_step(a, make_mesh(SEQ4, axes=("sequence",)))
    loss = float(step(f, l))
    assert launches["flash_fwd"] == 10 and current_sp_axis() is None
    b.fit(DataSet(f, l))
    assert loss == pytest.approx(float(b.score()), rel=LOSS_RTOL)
    assert a.iteration_count == 1
    _same(a, b)


def test_sp_step_attention_dropout_matches_the_unsharded_step():
    """Attention dropout rides the ring at global coordinates with the seed
    the unsharded step draws: equal steps; rate 0 gives another loss."""
    f, l = _seq_data(seed=3)
    a, b, c = _mln(heads=4, rate=0.3), _mln(heads=4, rate=0.3), _mln(heads=4)
    step = sequence_parallel_step(a, make_mesh(SEQ4, axes=("sequence",)))
    loss_a = float(step(f, l))
    b.fit(DataSet(f, l))
    assert loss_a == pytest.approx(float(b.score()), rel=LOSS_RTOL)
    _same(a, b)
    step_c = sequence_parallel_step(c, make_mesh(SEQ4, axes=("sequence",)))
    assert abs(float(step_c(f, l)) - loss_a) > 1e-6


def test_sp_step_dp_composition_matches_the_unsharded_step():
    """DP x SP on 2 x 4 slots: batch over data, time over sequence."""
    f, l = _seq_data(b=4, seed=1)
    a, b = _mln(), _mln()
    mesh = make_mesh(["cpu"] * 8, axes=("data", "sequence"), shape=(2, 4))
    step = sequence_parallel_step(a, mesh, data_axis="data")
    loss = float(step(f, l))
    b.fit(DataSet(f, l))
    assert loss == pytest.approx(float(b.score()), rel=LOSS_RTOL)
    _same(a, b)


def test_sp_transformer_lm_matches_jax_and_routes_ulysses(tmp_path, monkeypatch):
    """The TransformerLM (a graph, [b, T] id stream): the port's sp step ==
    JAX's sp step (loss, parameters), through Ulysses (4 heads over 4
    slots), and == the port's unsharded step; output() afterwards keeps
    the dense route."""
    from deeplearning4j_tpu.models import TransformerLM as JLM
    calls = []
    real = seq._ulysses_flash_slots
    monkeypatch.setattr(seq, "_ulysses_flash_slots",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jn = JLM(vocab_size=12, embed_dim=16, num_heads=4, num_blocks=2, seed=9).init()
    path = str(tmp_path / "lm.zip")
    ModelSerializer.write_model(jn, path)
    net, ref = restore_model(path, device="cpu"), restore_model(path, device="cpu")
    rng = np.random.default_rng(4)
    T = 4 * 128
    ids = rng.integers(0, 12, size=(2, T)).astype(np.float32)
    l = np.eye(12, dtype=np.float32)[rng.integers(0, 12, (2, T))]
    step = sequence_parallel_step(net, make_mesh(SEQ4, axes=("sequence",)))
    loss = float(step((ids,), (l,)))
    assert len(calls) == 2                                  # one a block
    jstep, jplace = jsp(jn, jmake(jax.devices()[:4], axes=("sequence",)))
    jplace(jn)
    pa, _, _, jloss = jstep(jn.params, jn.states, jn.updater_state, jnp.asarray(0, jnp.int32),
                            jax.random.PRNGKey(0), (jnp.asarray(ids),), (jnp.asarray(l),))
    assert loss == pytest.approx(float(jloss), rel=1e-4)
    for k in pa:
        for p in pa[k]:
            np.testing.assert_allclose(net.params[k][p].numpy(), np.asarray(pa[k][p]),
                                       rtol=3e-3, atol=PARAM_ATOL)
    ref.fit(DataSet(ids, l))
    assert loss == pytest.approx(float(ref.score()), rel=LOSS_RTOL)
    _same(net, ref)
    calls.clear()
    out = net.output(ids[:, :64])
    assert tuple(out.shape) == (2, 64, 12) and torch.isfinite(out).all() and not calls


def test_sp_step_rejections():
    mesh = make_mesh(SEQ4, axes=("sequence",))

    def net(*layers):
        b = NeuralNetConfiguration.builder().seed(1).updater(Sgd(learning_rate=0.1)).list()
        for lay in layers:
            b = b.layer(lay)
        return MultiLayerNetwork(b.build()).init(device="cpu")
    out = RnnOutputLayer(n_in=8, n_out=2, activation="softmax", loss="mcxent")
    with pytest.raises(ValueError, match="time-recurrent"):
        sequence_parallel_step(net(LSTM(n_in=4, n_out=8), out), mesh)
    with pytest.raises(ValueError, match="aux"):
        sequence_parallel_step(net(MoEDenseLayer(n_in=4, n_out=8, num_experts=4, top_k=2,
                                                 aux_loss_weight=1e-2), out), mesh)
    with pytest.raises(ValueError, match="BatchNormalization"):
        sequence_parallel_step(net(DenseLayer(n_in=4, n_out=8), BatchNormalization(n_out=8),
                                   out), mesh)
    with pytest.raises(ValueError, match="activation dropout"):
        sequence_parallel_step(net(DenseLayer(n_in=4, n_out=8, dropout=0.5), out), mesh)
    with pytest.raises(ValueError, match="sequence"):
        sequence_parallel_step(net(DenseLayer(n_in=4, n_out=8), out),
                               make_mesh(SEQ4, axes=("data",)))
    a = _mln()
    step = sequence_parallel_step(a, make_mesh(SEQ4, axes=("sequence",)))
    f, l = _seq_data()
    with pytest.raises(ValueError, match="rank-3"):
        step(f[:, :, 0], l)
    with pytest.raises(RuntimeError, match="inside sequence_parallel_step"):
        seq.sp_attend(*[torch.zeros(2, 128, 2, 8)] * 3, causal=True)
