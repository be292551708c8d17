"""The training slice end to end on the CPU, against the JAX package.

A JAX ``MultiLayerNetwork`` (2 x GravesLSTM(128) + RnnOutputLayer softmax
+ mcxent, random peepholes, Adam, truncated BPTT) is written with
``ModelSerializer`` and restored by the port on ``device="cpu"``, where
every kernel is its plain version; the JAX package runs its Pallas kernels
in interpret mode. Both then compute gradients, train with TBPTT, and
resume from a checkpoint with updater state, on the same numpy inputs.

Tolerances (each compared as max |port - jax| over max |jax|, or absolute
where the quantity is O(1)):
- f32 compute: the same arithmetic in another summation order. Gradients
  and losses 1e-5, parameters after training 1e-5 absolute.
- bf16 compute (the model's policy): the recurrent products, the output
  layer's logits and its log-softmax are rounded to bf16 at places where
  the two frameworks round differently, so one bf16 unit (2^-8 relative)
  can move at a time. Gradients 3e-2 relative to their largest entry
  (measured <= 8.2e-3), losses 2e-3 relative (measured 0). Parameters
  after Adam steps: Adam divides by the gradient's running scale, so an
  entry whose gradient is near zero can move by up to lr in either
  direction on each side per step; the limit is 2 x lr x steps absolute
  (measured 2.1e-3 after 3 steps and 4.4e-3 after 4, limits 6e-3, 8e-3).
- f32 measured: gradients <= 7e-7, parameters <= 3.9e-6.
- The updaters, schedules, losses and gradient normalizations, on their
  own in f32: 1e-6 relative (measured <= 3e-7).
"""
import json
import zipfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import deeplearning4j_tpu.ops.flash_attention as fa
from deeplearning4j_tpu import Adam as JAdam
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import losses as jlosses
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.optimize.updater import normalize_gradients as j_normalize
from deeplearning4j_tpu.utils.model_serializer import ModelSerializer

from deeplearning4j_torch import DataSet, ListDataSetIterator, NeuralNetConfiguration
from deeplearning4j_torch.nn import losses, updaters
from deeplearning4j_torch.nn.conf import GradientNormalization, serde
from deeplearning4j_torch.nn.conf.layers import GravesLSTM, RnnOutputLayer
from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_torch.ops import lstm_cell, lstm_fused
from deeplearning4j_torch.optimize.updater import normalize_gradients
from deeplearning4j_torch.utils.model_serializer import restore_multi_layer_network

V, H, B, L = 16, 128, 8, 4
LR = 1e-3
TOL = {"float32": 1e-5, "bfloat16": 3e-2}         # gradients (measured below)
LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-3}
PARAM_ATOL_F32 = 1e-5


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


def _jax_net(compute="bfloat16", seed=7):
    conf = (JConf.builder().seed(seed).updater(JAdam(learning_rate=LR))
            .activation("tanh").compute_dtype(compute).list()
            .layer(jlayers.GravesLSTM(n_in=V, n_out=H))
            .layer(jlayers.GravesLSTM(n_in=H, n_out=H))
            .layer(jlayers.RnnOutputLayer(n_in=H, n_out=V, activation="softmax",
                                          loss="mcxent"))
            .backprop_type("tbptt").t_bptt_forward_length(L).t_bptt_backward_length(L)
            .build())
    net = JNet(conf).init()
    rng = np.random.default_rng(seed)
    for i in ("0", "1"):        # init draws zero peepholes: exercise them
        for k in ("pi", "pf", "po"):
            net.params[i][k] = jnp.asarray((0.3 * rng.standard_normal(H)).astype(np.float32))
    return net


def _port_from(jnet, tmp_path, name="net.zip"):
    path = tmp_path / name
    ModelSerializer.write_model(jnet, str(path))
    return restore_multi_layer_network(path, device="cpu"), path


def _batch(seed, t, masked):
    """One-hot next-character data; masked batches have variable lengths
    (features and labels masks, as a real corpus gives)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (B, t + 1))
    eye = np.eye(V, dtype=np.float32)
    fm = lm = None
    if masked:
        lengths = rng.integers(t // 2, t + 1, B)
        fm = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
        lm = fm.copy()
    return eye[ids[:, :-1]], eye[ids[:, 1:]], fm, lm


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max())


def _flat(params):
    return {f"{i}/{k}": np.asarray(v, np.float32) for i, p in params.items()
            for k, v in p.items()}


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
@pytest.mark.parametrize("masked", [False, True])
def test_gradient_and_score_match_jax(tmp_path, monkeypatch, compute, masked):
    """Unmasked batches take the fused pair (K3 + K4), masked batches the
    per-layer kernels (K1 + K2); both against ``jax.value_and_grad``."""
    jnet = _jax_net(compute)
    net, _ = _port_from(jnet, tmp_path)
    f, l, fm, lm = _batch(1, 6, masked)
    fused = _spy(monkeypatch, lstm_fused, "lstm2_bwd")
    per_layer = _spy(monkeypatch, lstm_cell, "lstm_bwd")
    jgrads, jscore = jnet.compute_gradient_and_score(JDataSet(f, l, fm, lm))
    grads, score = net.compute_gradient_and_score(DataSet(f, l, fm, lm))
    assert (len(fused), len(per_layer)) == ((0, 2) if masked else (1, 0))
    want = _flat(jgrads)
    got = _flat({i: {k: g.numpy() for k, g in p.items()} for i, p in grads.items()})
    assert set(got) == set(want)
    assert abs(score - jscore) <= LOSS_TOL[compute] * abs(jscore)
    for key, w in want.items():
        assert _rel(got[key], w) <= TOL[compute], (key, _rel(got[key], w))


def _record_segments(monkeypatch, jnet, net):
    """Per-segment losses of both sides: the JAX per-segment step (the
    ragged-T dispatch loop) and the port's ``_steps``."""
    jlosses_, losses_ = [], []
    real_j = jnet._ensure_tbptt_step

    def j_step(single_iteration=False):
        step = real_j(single_iteration)

        def rec(*a):
            out = step(*a)
            jlosses_.append(float(out[3]))
            return out
        return rec

    monkeypatch.setattr(jnet, "_ensure_tbptt_step", j_step)
    real_p = net._steps

    def p_steps(*a, **k):
        out = real_p(*a, **k)
        losses_.append(float(out[0]))
        return out

    monkeypatch.setattr(net, "_steps", p_steps)
    return jlosses_, losses_


def _assert_params_close(net, jnet, compute, steps):
    atol = PARAM_ATOL_F32 if compute == "float32" else 2 * LR * steps
    want = _flat(jnet.params)
    got = _flat(net.params)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=0, atol=atol, err_msg=key)


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
@pytest.mark.parametrize("t", [12, 10])
def test_tbptt_fit_matches_jax(tmp_path, monkeypatch, compute, t):
    """fit with TBPTT over several segments (T=12: three even segments of
    4; T=10: 4, 4 and a ragged 2): per-segment losses, the update count
    and the parameters after, on both sides."""
    jnet = _jax_net(compute)
    net, _ = _port_from(jnet, tmp_path)
    jl, pl = _record_segments(monkeypatch, jnet, net)
    f, l, _, _ = _batch(2, t, masked=False)
    jnet.fit(JDataSet(f, l))
    net.fit(DataSet(f, l))
    n_seg = -(-t // L)
    assert len(pl) == n_seg and net.iteration_count == jnet.iteration_count == n_seg
    if t % L:
        assert len(jl) == n_seg
        np.testing.assert_allclose(pl, jl, rtol=LOSS_TOL[compute], atol=0)
    np.testing.assert_allclose(float(net.score_), float(jnet.score_),
                               rtol=LOSS_TOL[compute], atol=0)
    _assert_params_close(net, jnet, compute, n_seg)


def test_jax_checkpoint_resumes_with_updater_state(tmp_path, monkeypatch):
    """A JAX net trained two segments, written with updaterState.bin and
    restored in the port, carries Adam's moments and the iteration count:
    further training gives the same losses and parameters on both sides."""
    jnet = _jax_net("float32")
    f, l, _, _ = _batch(3, 2 * L, masked=False)
    jnet.fit(JDataSet(f, l))
    net, path = _port_from(jnet, tmp_path)
    with zipfile.ZipFile(path) as z:
        assert "updaterState.bin" in z.namelist()
    assert net.iteration_count == jnet.iteration_count == 2
    for i, layer in jnet.updater_state.items():
        for k, (m, v) in layer.items():
            pm, pv = net.updater_state[i][k]
            np.testing.assert_array_equal(pm.numpy(), np.asarray(m))
            np.testing.assert_array_equal(pv.numpy(), np.asarray(v))
    jl, pl = _record_segments(monkeypatch, jnet, net)
    f, l, _, _ = _batch(4, L + 2, masked=False)        # a ragged second batch
    jnet.fit(JDataSet(f, l))
    net.fit(ListDataSetIterator([DataSet(f, l)]))
    assert net.iteration_count == jnet.iteration_count == 4
    np.testing.assert_allclose(pl, jl, rtol=LOSS_TOL["float32"], atol=0)
    _assert_params_close(net, jnet, "float32", 2)
    # without the moments (a fresh Adam at iteration 2) the update differs
    fresh = restore_multi_layer_network(path, device="cpu", load_updater=False)
    fresh.fit(DataSet(f, l))
    assert max(np.abs(_flat(fresh.params)[k] - _flat(net.params)[k]).max()
               for k in _flat(net.params)) > 100 * PARAM_ATOL_F32


def test_dropout_fuses_in_inference_and_refuses_training(monkeypatch):
    """Dropout on the pair's second layer blocks fusion only in training,
    as in the JAX package (multilayer.py:321); an inference ``output``
    still takes the fused kernel, and a training step runs the pair per
    layer (no fused launch) and trains."""
    conf = (NeuralNetConfiguration.builder().seed(3).activation("tanh").list()
            .layer(GravesLSTM(n_in=V, n_out=16))
            .layer(GravesLSTM(n_in=16, n_out=16, dropout=0.5))
            .layer(RnnOutputLayer(n_in=16, n_out=V, activation="softmax", loss="mcxent"))
            .build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    calls = _spy(monkeypatch, lstm_fused, "lstm_scan2")
    f, l, _, _ = _batch(5, 6, masked=False)
    net.output(f)
    assert calls == [1]
    x = torch.from_numpy(f)
    assert net._lstm_pair_fusable(0, x, None, train=False)
    assert not net._lstm_pair_fusable(0, x, None, train=True)
    before = {k: p.clone() for k, p in net.params["1"].items()}
    net.fit(f, l)
    assert calls == [1] and np.isfinite(net.score())
    assert all(not torch.equal(before[k], p) for k, p in net.params["1"].items())


def _rng_tree(seed):
    rng = np.random.default_rng(seed)
    return {"W": rng.standard_normal((5, 3)).astype(np.float32),
            "b": rng.standard_normal(3).astype(np.float32)}


def _close(got, want, tol=1e-6):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("name", sorted(updaters.UPDATERS))
def test_updaters_match_jax(name):
    """Three updates from zero state, with a learning-rate schedule on the
    Adam family, against the JAX updater (state too)."""
    kw = {}
    if name in ("Adam", "Nadam", "AMSGrad"):
        kw = {"lr_schedule": ("ExponentialSchedule", {"initial_value": 1e-2, "gamma": 0.9})}
    def make(mod):
        k = dict(kw)
        if "lr_schedule" in k:
            sname, sk = k["lr_schedule"]
            k["lr_schedule"] = getattr(mod, sname)(**sk)
        return getattr(mod, name)(**k)
    ju, pu = make(jupd), make(updaters)
    params = _rng_tree(0)
    js = ju.init_state({k: jnp.asarray(v) for k, v in params.items()})
    ps = pu.init_state({k: torch.from_numpy(v) for k, v in params.items()})
    for it in range(3):
        g = _rng_tree(it + 1)
        jup, js = ju.apply(js, {k: jnp.asarray(v) for k, v in g.items()}, it)
        pup, ps = pu.apply(ps, {k: torch.from_numpy(v) for k, v in g.items()}, it)
        for k in g:
            _close(pup[k].numpy(), jup[k])
            jst, pst = js[k], ps[k]
            for a, b in zip(pst if isinstance(pst, tuple) else (pst,),
                            jst if isinstance(jst, tuple) else (jst,)):
                _close(a.numpy(), b)


@pytest.mark.parametrize("name", sorted(updaters.SCHEDULES))
def test_schedules_match_jax(name):
    kw = {"MapSchedule": {"values": {"0": 0.1, "3": 0.05, "7": 0.01}},
          "WarmupCosineSchedule": {"warmup_steps": 3, "total_steps": 10},
          "PolySchedule": {"max_iter": 8}, "StepSchedule": {"step_size": 3},
          "SigmoidSchedule": {"step_size": 4}}.get(name, {})
    js, ps = getattr(jupd, name)(**kw), getattr(updaters, name)(**kw)
    for it in range(12):
        _close(ps.value(it), float(js.value(it)))


_LOSS_ACT = {"mcxent": "softmax", "negativeloglikelihood": "softmax",
             "sparse_mcxent": "softmax", "xent": "sigmoid",
             "reconstruction_crossentropy": "sigmoid", "kl_divergence": "softmax",
             "poisson": "softplus", "cosine_proximity": "tanh"}


@pytest.mark.parametrize("name", losses.LossFunction.names())
def test_losses_match_jax(name):
    """Each loss, its value and its gradient with respect to the
    preoutput, on [b, T, n] data with a [b, T] mask."""
    import jax
    rng = np.random.default_rng(9)
    pre = rng.standard_normal((3, 4, 5)).astype(np.float32)
    mask = (rng.uniform(size=(3, 4)) > 0.3).astype(np.float32)
    if name == "sparse_mcxent":
        lab = rng.integers(0, 5, (3, 4)).astype(np.float32)
    elif name in ("hinge", "squared_hinge"):
        lab = np.sign(rng.standard_normal((3, 4, 5))).astype(np.float32)
    else:
        lab = rng.uniform(0.05, 1.0, (3, 4, 5)).astype(np.float32)
    act = _LOSS_ACT.get(name, "identity")
    jf = jlosses.get_loss(name)
    jv, jg = jax.value_and_grad(lambda z: jf(jnp.asarray(lab), z, act, jnp.asarray(mask)))(
        jnp.asarray(pre))
    z = torch.from_numpy(pre).requires_grad_()
    v = losses.get_loss(name)(torch.from_numpy(lab), z, act, torch.from_numpy(mask))
    v.backward()
    _close(v.item(), float(jv))
    _close(z.grad.numpy(), jg)


@pytest.mark.parametrize("mode", [GradientNormalization.None_,
                                  GradientNormalization.RenormalizeL2PerLayer,
                                  GradientNormalization.RenormalizeL2PerParamType,
                                  GradientNormalization.ClipElementWiseAbsoluteValue,
                                  GradientNormalization.ClipL2PerLayer,
                                  GradientNormalization.ClipL2PerParamType])
def test_normalize_gradients_matches_jax(mode):
    grads = {"0": _rng_tree(11), "1": {k: 0.1 * v for k, v in _rng_tree(12).items()},
             "2": {}}
    want = j_normalize({i: {k: jnp.asarray(v) for k, v in g.items()}
                        for i, g in grads.items()}, mode, 0.5)
    got = normalize_gradients({i: {k: torch.from_numpy(v) for k, v in g.items()}
                               for i, g in grads.items()}, mode, 0.5)
    for i, g in want.items():
        assert set(got[i]) == set(g)
        for k, v in g.items():
            _close(got[i][k].numpy(), v)


def test_updater_config_decodes_to_port_classes_and_round_trips():
    """An updater with a schedule, as the JAX package writes it, decodes to
    the port's classes and re-encodes to the same JSON."""
    sched = jupd.MapSchedule(values={0: 1e-3, 5: 1e-4})
    jconf = (JConf.builder().seed(1).updater(JAdam(learning_rate=2e-3, lr_schedule=sched))
             .list().layer(jlayers.GravesLSTM(n_in=V, n_out=8))
             .layer(jlayers.RnnOutputLayer(n_in=8, n_out=V, activation="softmax"))
             .backprop_type("tbptt").t_bptt_forward_length(5).build())
    doc = json.loads(jconf.to_json())
    conf = serde.decode(doc)
    u = conf.global_conf.updater
    assert isinstance(u, updaters.Adam) and isinstance(u.lr_schedule, updaters.MapSchedule)
    assert u.lr_schedule.value(6) == 1e-4
    assert conf.backprop_type == "tbptt" and conf.tbptt_fwd_length == 5
    assert serde.encode(conf) == doc
