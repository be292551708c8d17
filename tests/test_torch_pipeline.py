"""GPipe of the port (``deeplearning4j_torch/parallel/pipeline.py``) against
the JAX package's (``deeplearning4j_tpu/parallel/pipeline.py``): the same
networks (JAX-initialised, carried over in the model zip), the same numpy
batches, the JAX side on its virtual CPU devices and the port on ``cpu``
slots. Oracles: ``tests/test_pipeline.py``; each pipelined step is also
held against the port's unpipelined step (``_train_loss`` ->
``_apply_update``, JAX's ``_raw_step``).

Tolerances: the packages sum gradients in different orders and the port
runs the microbatches one after another where XLA fuses them, so f32
results part by rounding: losses at LOSS_RTOL, parameters at PARAM_ATOL
(measured up to ~3e-7 on these nets).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu import (NeuralNetConfiguration as JConf, MultiLayerNetwork as JNet,
                                Sgd as JSgd, Adam as JAdam)
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.parallel import (GPipe as JGPipe, make_mesh as jmesh,
                                         partition_network as jpartition,
                                         pipeline_parallel_step as jpipeline,
                                         spmd_pipeline as jspmd,
                                         stack_stage_params as jstack)
from deeplearning4j_tpu.utils.model_serializer import ModelSerializer

from deeplearning4j_torch.nn.updaters import Adam, Sgd
from deeplearning4j_torch.parallel import (GPipe, PIPELINE_AXIS, make_mesh, partition_network,
                                           pipeline_parallel_step, spmd_pipeline,
                                           stack_stage_params)
from deeplearning4j_torch.utils.model_serializer import restore_model

LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _mesh(S, D=None):
    if D is None:
        return make_mesh(["cpu"] * S, axes=(PIPELINE_AXIS,))
    return make_mesh(["cpu"] * (S * D), axes=(PIPELINE_AXIS, "data"), shape=(S, D))


def _jmesh(S, D=None):
    if D is None:
        return jmesh(jax.devices()[:S], axes=("pipe",))
    return jmesh(jax.devices()[:S * D], axes=("pipe", "data"), shape=(S, D))


def _port(jnet, tmp_path, name="m.zip"):
    path = str(tmp_path / name)
    ModelSerializer.write_model(jnet, path)
    return restore_model(path, device="cpu")


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close_trees(got, want, atol=PARAM_ATOL):
    assert set(got) == set(want)
    for k in want:
        assert set(got[k]) == set(want[k]), k
        for name in want[k]:
            np.testing.assert_allclose(_np(got[k][name]), np.asarray(want[k][name]),
                                       rtol=0, atol=atol, err_msg=f"{k}/{name}")


def _raw_step(net, f, l, fm=None, lm=None):
    """The port's unpipelined step: one standard-backprop update."""
    put = net._to_device
    loss, _, new_states = net._train_loss(put(f), put(l), None if fm is None else put(fm),
                                          None if lm is None else put(lm))
    net._update(loss, net.iteration_count)
    net._commit_states(new_states)
    return float(loss)


# ------------------------------------------------------- the functional API
def _block(params, x):
    return torch.tanh(x @ params["W"] + params["b"])


def _jblock(params, x):
    return jnp.tanh(x @ params["W"] + params["b"])


def _head(head, feats, labels):
    logp = torch.log_softmax(feats @ head["W"] + head["b"], dim=-1)
    return -(labels * logp).sum(-1).mean()


def _jhead(head, feats, labels):
    logp = jax.nn.log_softmax(feats @ head["W"] + head["b"])
    return -jnp.mean(jnp.sum(labels * logp, axis=-1))


def _blocks(S, F, seed=0):
    rng = np.random.default_rng(seed)
    return [{"W": (rng.normal(size=(F, F)) / np.sqrt(F)).astype(np.float32),
             "b": (rng.normal(size=(F,)) * 0.1).astype(np.float32)} for _ in range(S)]


def _as_torch(tree):
    return {k: torch.as_tensor(v) for k, v in tree.items()}


def test_spmd_pipeline_forward_and_grad_match_jax_and_sequential():
    """The scheduled forward equals JAX's and the sequential stack; its
    autograd gradient equals the sequential one's (atol 1e-6)."""
    S, M, mb, F = 4, 5, 2, 6
    per = _blocks(S, F, seed=3)
    xs = np.random.default_rng(4).normal(size=(M, mb, F)).astype(np.float32)
    jys = jspmd(_jblock, _jmesh(S))(jstack([{k: jnp.asarray(v) for k, v in p.items()}
                                             for p in per]), jnp.asarray(xs))
    stacked = stack_stage_params([_as_torch(p) for p in per])
    stacked = {k: v.requires_grad_(True) for k, v in stacked.items()}
    calls = []

    def block(params, x):
        calls.append(1)
        return _block(params, x)

    ys = spmd_pipeline(block, _mesh(S))(stacked, torch.as_tensor(xs))
    assert len(calls) == S * M        # no bubble tick runs the stage
    np.testing.assert_allclose(_np(ys), np.asarray(jys), rtol=0, atol=1e-6)
    g = torch.autograd.grad((ys ** 2).sum(), [stacked["W"], stacked["b"]])
    seq = {k: v.detach().clone().requires_grad_(True) for k, v in stacked.items()}
    outs = []
    for m in range(M):
        x = torch.as_tensor(xs[m])
        for s in range(S):
            x = _block({k: v[s] for k, v in seq.items()}, x)
        outs.append(x)
    g2 = torch.autograd.grad((torch.stack(outs) ** 2).sum(), [seq["W"], seq["b"]])
    for a, b in zip(g, g2):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-6)


@pytest.mark.parametrize("updater", ["sgd", "adam", "dp_pp"])
def test_gpipe_train_step_matches_jax(updater):
    """GPipe's step (parameters and loss) equals JAX's, on a pipe mesh and
    on data x pipe."""
    S, M, F, C = 4, 4, 8, 5
    B = M * (4 if updater == "dp_pp" else 2)
    per = _blocks(S, F, seed=2)
    rng = np.random.default_rng(7)
    head = {"W": (rng.normal(size=(F, C)) / np.sqrt(F)).astype(np.float32),
            "b": np.zeros((C,), np.float32)}
    x = rng.normal(size=(B, F)).astype(np.float32)
    y = np.eye(C, dtype=np.float32)[rng.integers(0, C, B)]
    lr = 0.05
    jupd = JAdam(learning_rate=lr) if updater == "adam" else JSgd(learning_rate=lr)
    upd = Adam(learning_rate=lr) if updater == "adam" else Sgd(learning_rate=lr)
    D = 2 if updater == "dp_pp" else None
    jparams = {"blocks": jstack([{k: jnp.asarray(v) for k, v in p.items()} for p in per]),
               "head": {k: jnp.asarray(v) for k, v in head.items()}}
    jg = JGPipe(_jblock, _jhead, _jmesh(S, D), n_microbatches=M, updater=jupd,
                data_axis="data" if D else None)
    jp, js = jg.place(jparams, jupd.init_state(jparams))
    jp, js, jloss = jg.train_step(jp, js, 0, jnp.asarray(x), jnp.asarray(y))
    params = {"blocks": stack_stage_params([_as_torch(p) for p in per]),
              "head": _as_torch(head)}
    g = GPipe(_block, _head, _mesh(S, D), n_microbatches=M, updater=upd,
              data_axis="data" if D else None)
    p, st = g.place(params, upd.init_state(params))
    p, st, loss = g.train_step(p, st, 0, x, y)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    for part in ("blocks", "head"):
        _close_trees({"p": p[part]}, {"p": jp[part]})


# --------------------------------------------------- container pipelines
def _dense_net(seed=7, n_mid=4, lr=1e-2, updater=None, drop=None, extra=None):
    b = (JConf.builder().seed(seed).updater(updater or JSgd(learning_rate=lr))
         .activation("tanh").list().layer(jl.DenseLayer(n_in=6, n_out=16)))
    for _ in range(n_mid):
        b = b.layer(jl.DenseLayer(n_in=16, n_out=16, dropout=drop) if drop is not None
                    else jl.DenseLayer(n_in=16, n_out=16))
    b = b.layer(jl.OutputLayer(n_in=16, n_out=4, activation="softmax", loss="mcxent"))
    return JNet(b.build()).init()


def _dense_bn_net(seed=11, n_blocks=3, feat=16):
    b = (JConf.builder().seed(seed).updater(JSgd(learning_rate=0.05)).activation("tanh")
         .list().layer(jl.DenseLayer(n_in=6, n_out=feat)))
    for _ in range(n_blocks):
        b = (b.layer(jl.DenseLayer(n_in=feat, n_out=feat))
             .layer(jl.BatchNormalization(n_in=feat, n_out=feat)))
    b = b.layer(jl.OutputLayer(n_in=feat, n_out=4, activation="softmax", loss="mcxent"))
    return JNet(b.build()).init()


def test_partition_network_matches_jax(tmp_path):
    """The same (start, length, period) for identical layers and periodic
    blocks, and the same refusal."""
    for jnet, S in ((_dense_net(), 2), (_dense_net(), 4), (_dense_bn_net(), 2)):
        net = _port(jnet, tmp_path)
        assert partition_network(net, S) == jpartition(jnet, S)
    with pytest.raises(ValueError, match="periodic"):
        partition_network(_port(_dense_net(), tmp_path), 8)


@pytest.mark.parametrize("case", ["dense_adam", "bn_body", "bn_dp_pp"])
def test_pipelined_network_matches_jax_pipelined(case, tmp_path):
    """PipelinedNetwork's loss, parameters and layer state after two steps
    equal JAX's pipelined step's: Adam on a dense stack (two layers a
    stage), BatchNormalization in a period-2 body (per-microbatch
    statistics, running statistics in microbatch order), and that body
    under data x pipe (the shards' state averaged)."""
    if case == "dense_adam":
        jnet, S, D, M, n = _dense_net(updater=JAdam(learning_rate=1e-2)), 2, None, 2, 16
    elif case == "bn_body":
        jnet, S, D, M, n = _dense_bn_net(), 2, None, 2, 8
    else:
        jnet, S, D, M, n = _dense_bn_net(seed=13, n_blocks=2), 2, 2, 2, 8
    net = _port(jnet, tmp_path)
    rng = np.random.default_rng(4)
    f = rng.normal(size=(n, 6)).astype(np.float32)
    l = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    da = "data" if D else None
    jpp = jpipeline(jnet, _jmesh(S, D), n_microbatches=M, data_axis=da)
    pp = pipeline_parallel_step(net, _mesh(S, D), n_microbatches=M, data_axis=da)
    assert (pp.start, pp.body_len, pp.period) == (jpp.start, jpp.body_len, jpp.period)
    for _ in range(2):
        jl_ = float(jpp.fit_batch(f, l))
        loss = float(pp.fit_batch(f, l))
        np.testing.assert_allclose(loss, jl_, rtol=LOSS_RTOL)
    _close_trees(pp.export_params(), jpp.export_params())
    _close_trees(pp.export_states(), jpp.export_states())
    # the network given to the trainer is left as it was
    _close_trees(net.params, jnet.params, atol=0)


def test_pipelined_network_equals_unpipelined_step(tmp_path):
    """Without layer state the microbatch mean is the full-batch mean: a
    pipelined SGD step equals the port's unpipelined step."""
    jnet = _dense_net(seed=3, lr=0.1)
    net, ref = _port(jnet, tmp_path, "a.zip"), _port(jnet, tmp_path, "b.zip")
    rng = np.random.default_rng(5)
    f = rng.normal(size=(16, 6)).astype(np.float32)
    l = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 16)]
    pp = pipeline_parallel_step(net, _mesh(4), n_microbatches=4)
    loss = float(pp.fit_batch(f, l))
    np.testing.assert_allclose(loss, _raw_step(ref, f, l), rtol=LOSS_RTOL)
    _close_trees(pp.export_params(), {k: {n: _np(t) for n, t in v.items()}
                                      for k, v in ref.params.items()})


def test_pipelined_lstm_zoo_dp_pp_and_masks_match(tmp_path):
    """TextGenerationLSTM(num_layers=5) over pipe 4 x data 2 equals the
    unpipelined step; a masked 3-LSTM net equals JAX's pipelined masked
    step, and its mask changes the loss."""
    from deeplearning4j_tpu.models import TextGenerationLSTM as JText

    jnet = JNet(JText(total_unique_characters=12, lstm_size=16, num_layers=5).conf()).init()
    net, ref = _port(jnet, tmp_path, "a.zip"), _port(jnet, tmp_path, "b.zip")
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 12, size=(8, 6))
    f = np.eye(12, dtype=np.float32)[ids]
    l = np.eye(12, dtype=np.float32)[np.roll(ids, -1, axis=1)]
    pp = pipeline_parallel_step(net, _mesh(4, 2), n_microbatches=4)
    assert (pp.start, pp.body_len, pp.layers_per_stage) == (1, 4, 1)
    np.testing.assert_allclose(float(pp.fit_batch(f, l)), _raw_step(ref, f, l), rtol=LOSS_RTOL)
    _close_trees(pp.export_params(), {k: {n: _np(t) for n, t in v.items()}
                                      for k, v in ref.params.items()})

    conf = (JConf.builder().seed(4).updater(JSgd(learning_rate=0.1)).activation("tanh").list()
            .layer(jl.LSTM(n_in=5, n_out=8)).layer(jl.LSTM(n_in=8, n_out=8))
            .layer(jl.LSTM(n_in=8, n_out=8))
            .layer(jl.RnnOutputLayer(n_in=8, n_out=4, activation="softmax", loss="mcxent"))
            .build())
    jnet = JNet(conf).init()
    net, plain = _port(jnet, tmp_path, "c.zip"), _port(jnet, tmp_path, "d.zip")
    f = rng.normal(size=(4, 6, 5)).astype(np.float32)
    l = np.eye(4, dtype=np.float32)[rng.integers(0, 4, size=(4, 6))]
    fm = (np.arange(6)[None, :] < [[6], [4], [5], [3]]).astype(np.float32)
    jpp = jpipeline(jnet, _jmesh(2), n_microbatches=2)
    pp = pipeline_parallel_step(net, _mesh(2), n_microbatches=2)
    loss = float(pp.fit_batch(f, l, features_mask=fm, labels_mask=fm))
    np.testing.assert_allclose(loss, float(jpp.fit_batch(f, l, features_mask=fm,
                                                         labels_mask=fm)), rtol=LOSS_RTOL)
    _close_trees(pp.export_params(), jpp.export_params())
    unmasked = float(pipeline_parallel_step(plain, _mesh(2), n_microbatches=2).fit_batch(f, l))
    assert abs(unmasked - loss) > 1e-6


def test_pipeline_dropout_active_and_deterministic(tmp_path):
    """JAX's properties: dropout in the body fires (the loss differs from
    the dropout-free net's), one seed and iteration give one mask, and the
    next iteration draws a fresh one (lr 0: only the mask changes)."""
    nets = [_port(_dense_net(seed=11, lr=0.0, drop=d), tmp_path, f"{i}.zip")
            for i, d in enumerate((0.5, 0.5, 0.0))]
    rng = np.random.default_rng(8)
    f = rng.normal(size=(8, 6)).astype(np.float32)
    l = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 8)]
    pa, pb, pn = (pipeline_parallel_step(n, _mesh(2), n_microbatches=2) for n in nets)
    la0, lb0, ln0 = (float(p.fit_batch(f, l)) for p in (pa, pb, pn))
    assert la0 == lb0
    assert abs(la0 - ln0) > 1e-6
    assert abs(float(pa.fit_batch(f, l)) - la0) > 1e-9


def test_pipeline_refusals_and_iterations_warning(tmp_path, caplog):
    """Auxiliary losses and per-layer updaters are refused, as in JAX;
    iterations(n) is warned about and one update is taken."""
    conf = (JConf.builder().seed(1).updater(JSgd(learning_rate=0.1)).activation("relu").list()
            .layer(jl.MoEDenseLayer(n_in=6, n_out=8, num_experts=4, top_k=2,
                                    aux_loss_weight=1e-2))
            .layer(jl.MoEDenseLayer(n_in=8, n_out=8, num_experts=4, top_k=2,
                                    aux_loss_weight=1e-2))
            .layer(jl.OutputLayer(n_in=8, n_out=3, activation="softmax", loss="mcxent"))
            .build())
    with pytest.raises(ValueError, match="aux"):
        pipeline_parallel_step(_port(JNet(conf).init(), tmp_path, "moe.zip"), _mesh(2), 2)
    b = (JConf.builder().seed(1).updater(JSgd(learning_rate=0.1)).activation("tanh").list()
         .layer(jl.DenseLayer(n_in=6, n_out=8)).layer(jl.DenseLayer(n_in=8, n_out=8))
         .layer(jl.DenseLayer(n_in=8, n_out=8, updater=JAdam(learning_rate=1e-3)))
         .layer(jl.OutputLayer(n_in=8, n_out=3, activation="softmax", loss="mcxent")))
    with pytest.raises(ValueError, match="updater"):
        pipeline_parallel_step(_port(JNet(b.build()).init(), tmp_path, "u.zip"), _mesh(2), 2)
    net = _port(_dense_net(), tmp_path, "it.zip")
    net.gc.iterations = 3
    with caplog.at_level("WARNING"):
        pp = pipeline_parallel_step(net, _mesh(2), n_microbatches=2)
    assert "ignored" in caplog.text
    rng = np.random.default_rng(1)
    pp.fit_batch(rng.normal(size=(4, 6)).astype(np.float32),
                 np.eye(4, dtype=np.float32)[rng.integers(0, 4, 4)])
    assert pp.iteration_count == 1
