"""PipelinedGraph of the port against the JAX package's: linear chains of
layer vertices (with a skip connection around the body, an auxiliary
output hanging off the entry, masked LSTM chains) and the residual-block
body of the TransformerLM (``partition_graph_blocks``: a period of 7
vertices, masks, data x pipe, the MoE LM with zero auxiliary weight).
Networks are JAX-initialised and carried over in the model zip; the JAX
side runs on its virtual CPU devices, the port on ``cpu`` slots. Oracles:
``tests/test_pipeline.py``.

Tolerances as in ``test_torch_pipeline.py``: losses at LOSS_RTOL,
parameters at PARAM_ATOL (f32 rounding of differently ordered sums).
"""
import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu import (NeuralNetConfiguration as JConf, ComputationGraph as JGraph,
                                Sgd as JSgd, InputType as JInputType)
from deeplearning4j_tpu.models import TransformerLM as JLM
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf.graph import ElementWiseVertex as JElementWise
from deeplearning4j_tpu.parallel import (make_mesh as jmesh, partition_graph as jpartition,
                                         pipeline_parallel_step as jpipeline)
from deeplearning4j_tpu.utils.model_serializer import ModelSerializer

from deeplearning4j_torch.parallel import (PIPELINE_AXIS, make_mesh, partition_graph,
                                           pipeline_parallel_step)
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


def _port(jnet, tmp_path, name="g.zip"):
    path = str(tmp_path / name)
    ModelSerializer.write_model(jnet, path)
    return restore_model(path, device="cpu")


def _close_trees(got, want, atol=PARAM_ATOL):
    assert set(got) == set(want)
    for k in want:
        for name in want[k]:
            a = got[k][name]
            a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            np.testing.assert_allclose(a, np.asarray(want[k][name]), rtol=0, atol=atol,
                                       err_msg=f"{k}/{name}")


def _chain_graph(n_mid=4, feat=16, skip=False, seed=17, aux=False):
    gb = (JConf.builder().seed(seed).updater(JSgd(learning_rate=0.05)).activation("tanh")
          .graph_builder().add_inputs("in")
          .add_layer("d0", jl.DenseLayer(n_out=feat, activation="relu"), "in"))
    if aux:
        gb = gb.add_layer("aux", jl.OutputLayer(n_out=3, activation="softmax",
                                                loss="mcxent"), "d0")
    prev = "d0"
    for i in range(n_mid):
        gb = gb.add_layer(f"mid{i}", jl.DenseLayer(n_out=feat), prev)
        prev = f"mid{i}"
    if skip:
        gb = gb.add_vertex("sum", JElementWise("add"), "d0", prev)
        prev = "sum"
    gb = (gb.add_layer("out", jl.OutputLayer(n_out=3, activation="softmax", loss="mcxent"),
                       prev)
          .set_outputs(*(("out", "aux") if aux else ("out",)))
          .set_input_types(JInputType.feed_forward(8)))
    return JGraph(gb.build()).init()


def _lstm_graph(seed=14, n_mid=4):
    gb = (JConf.builder().seed(seed).updater(JSgd(learning_rate=0.1)).activation("tanh")
          .graph_builder().add_inputs("in").add_layer("l0", jl.LSTM(n_out=8), "in"))
    prev = "l0"
    for i in range(n_mid):
        gb = gb.add_layer(f"mid{i}", jl.LSTM(n_out=8), prev)
        prev = f"mid{i}"
    gb = (gb.add_layer("out", jl.RnnOutputLayer(n_out=4, activation="softmax",
                                                loss="mcxent"), prev)
          .set_outputs("out").set_input_types(JInputType.recurrent(5)))
    return JGraph(gb.build()).init()


def _step_both(jnet, net, S, M, f, l, D=None, steps=1, **masks):
    da = "data" if D else None
    jpp = jpipeline(jnet, _jmesh(S, D), n_microbatches=M, data_axis=da)
    pp = pipeline_parallel_step(net, _mesh(S, D), n_microbatches=M, data_axis=da)
    for _ in range(steps):
        want = float(jpp.fit_batch(f, l, **masks))
        got = float(pp.fit_batch(f, l, **masks))
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    return pp, jpp, got


@pytest.mark.parametrize("case", ["chain", "skip", "aux_entry_output"])
def test_pipelined_graph_chain_matches_jax(case, tmp_path):
    """A chain body (with a skip connection around it, or an auxiliary
    output fed from the entry): the partition, the loss and the parameters
    after two steps equal JAX's pipelined step's."""
    jnet = _chain_graph(skip=case == "skip", aux=case == "aux_entry_output", seed=3)
    net = _port(jnet, tmp_path)
    assert partition_graph(net, 2) == tuple(jpartition(jnet, 2))
    rng = np.random.default_rng(23)
    f = rng.normal(size=(8, 8)).astype(np.float32)
    lab = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    l = (lab, lab) if case == "aux_entry_output" else lab
    pp, jpp, _ = _step_both(jnet, net, 2, 2, f, l, steps=2)
    assert pp.body == jpp.body == ["mid0", "mid1", "mid2", "mid3"]
    assert (pp.entry_names, pp.head_names) == (jpp.entry_names, jpp.head_names)
    assert pp._entry_outputs == jpp._entry_outputs
    _close_trees(pp.export_params(), jpp.export_params())


def test_pipelined_graph_masked_lstm_chain_matches_jax(tmp_path):
    """Feature and label masks propagate through entry, body and head; the
    label-mask-free case falls back to the propagated feature mask."""
    rng = np.random.default_rng(7)
    f = rng.normal(size=(4, 6, 5)).astype(np.float32)
    l = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (4, 6))]
    fm = (np.arange(6)[None, :] < [[6], [4], [5], [3]]).astype(np.float32)
    jnet = _lstm_graph()
    pp, jpp, masked = _step_both(jnet, _port(jnet, tmp_path, "a.zip"), 2, 2, f, l,
                                 features_mask=fm, labels_mask=fm)
    _close_trees(pp.export_params(), jpp.export_params())
    jnet = _lstm_graph(seed=15, n_mid=2)
    _step_both(jnet, _port(jnet, tmp_path, "b.zip"), 2, 2, f, l, features_mask=fm)


def _lm(seed=21, blocks=4, **kw):
    return JLM(vocab_size=10, embed_dim=16, num_heads=2, num_blocks=blocks, seed=seed,
               **kw).init()


@pytest.mark.parametrize("case", ["plain", "masked", "dp_pp"])
def test_pipelined_graph_residual_blocks_match_jax(case, tmp_path):
    """The TransformerLM's residual blocks (period 7) pipeline: loss and
    parameters equal JAX's pipelined step's, with masks, and under data x
    pipe."""
    jnet = _lm(blocks=4 if case == "plain" else 2, seed=21 if case == "plain" else 31)
    net = _port(jnet, tmp_path)
    rng = np.random.default_rng(3)
    n = 8 if case == "dp_pp" else 4
    ids = rng.integers(0, 10, size=(n, 8)).astype(np.float32)
    l = np.eye(10, dtype=np.float32)[rng.integers(0, 10, (n, 8))]
    masks = {}
    if case == "masked":
        fm = (np.arange(8)[None, :] < [[8], [4], [5], [3]]).astype(np.float32)
        masks = {"features_mask": fm, "labels_mask": fm}
    pp, jpp, _ = _step_both(jnet, net, 2, 2, ids, l, D=2 if case == "dp_pp" else None,
                            **masks)
    assert pp.body_tmpl == jpp.body_tmpl and pp.period == 7
    assert pp.body == jpp.body and pp._block_masks_ok
    if case == "plain":
        assert pp.body_len == 28 and pp.body[0] == "b0-ln-a" and pp.body[-1] == "b3-res-f"
    _close_trees(pp.export_params(), jpp.export_params())


def test_pipelined_graph_residual_blocks_equal_unpipelined_step(tmp_path):
    """The block-body pipeline's SGD step equals the port's unpipelined
    step on the same batch (no layer state: the microbatch mean is the
    batch mean)."""
    jnet = _lm(seed=5, blocks=4)
    net, ref = _port(jnet, tmp_path, "a.zip"), _port(jnet, tmp_path, "b.zip")
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 10, size=(4, 8)).astype(np.float32)
    l = np.eye(10, dtype=np.float32)[rng.integers(0, 10, (4, 8))]
    pp = pipeline_parallel_step(net, _mesh(4), n_microbatches=4)
    loss = float(pp.fit_batch(ids, l))
    put = ref._to_device
    ref_loss, _, _ = ref._train_loss((put(ids),), (put(l),), None, None)
    ref._update(ref_loss, 0)
    np.testing.assert_allclose(loss, float(ref_loss), rtol=LOSS_RTOL)
    _close_trees(pp.export_params(), {k: {n: t.numpy() for n, t in v.items()}
                                      for k, v in ref.params.items()})


def test_pipelined_graph_moe_zero_aux_and_output_dropout(tmp_path):
    """The MoE TransformerLM is refused with an auxiliary weight and
    pipelines without one (finite loss, as in JAX); an output layer's input
    dropout stays active in the head and is deterministic."""
    from deeplearning4j_torch.models import TransformerLM

    with pytest.raises(ValueError, match="aux"):
        pipeline_parallel_step(TransformerLM(vocab_size=8, embed_dim=16, num_heads=2,
                                             num_blocks=2, num_experts=4, seed=3
                                             ).init(device="cpu"), _mesh(2), 2)
    net = TransformerLM(vocab_size=8, embed_dim=16, num_heads=2, num_blocks=2, num_experts=4,
                        aux_loss_weight=0.0, capacity_factor=0.0, seed=3).init(device="cpu")
    rng = np.random.default_rng(13)
    ids = rng.integers(0, 8, size=(4, 6)).astype(np.float32)
    lab = np.eye(8, dtype=np.float32)[ids.astype(int)]
    assert np.isfinite(float(pipeline_parallel_step(net, _mesh(2), 2).fit_batch(ids, lab)))

    def build(drop, name):
        gb = (JConf.builder().seed(9).updater(JSgd(learning_rate=0.0)).activation("tanh")
              .graph_builder().add_inputs("in").add_layer("d0", jl.DenseLayer(n_out=12), "in"))
        prev = "d0"
        for i in range(4):
            gb = gb.add_layer(f"mid{i}", jl.DenseLayer(n_out=12), prev)
            prev = f"mid{i}"
        gb = (gb.add_layer("out", jl.OutputLayer(n_out=3, activation="softmax",
                                                 loss="mcxent", dropout=drop), prev)
              .set_outputs("out").set_input_types(JInputType.feed_forward(8)))
        return pipeline_parallel_step(_port(JGraph(gb.build()).init(), tmp_path, name),
                                      _mesh(2), n_microbatches=2)

    f = rng.normal(size=(8, 8)).astype(np.float32)
    l = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    la, lb, ln = (float(build(d, f"{i}.zip").fit_batch(f, l))
                  for i, d in enumerate((0.5, 0.5, 0.0)))
    assert la == lb and abs(la - ln) > 1e-6
