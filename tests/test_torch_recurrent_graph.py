"""The rest of the recurrent family as ComputationGraph layer vertices,
against the JAX package: the layers and batches of
``test_torch_recurrent_family.py`` in a graph ``in -> rnn -> out``, moved
through the model zip. Held: ``output`` (with the features mask),
``score`` (masks used), ``compute_gradient_and_score`` (as in both
packages, without masks) and the parameters after three Adam fit steps,
at the tolerances stated there (f64 1e-10, f32 2e-5 relative to the
largest entry).
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import Adam as JAdam
from deeplearning4j_tpu.compat import enable_x64
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph

from deeplearning4j_torch import DataSet
from deeplearning4j_torch.nn.graph import ComputationGraph

from test_torch_recurrent_family import (C, KINDS, LR, TOL, batch, recurrent_layer, rel,
                                         to_port, tree_errors)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def jax_graph(kind, dtype, seed=5):
    layer, width, last = recurrent_layer(kind)
    out = (jl.OutputLayer if last else jl.RnnOutputLayer)(
        n_in=width, n_out=C, activation="softmax", loss="mcxent")
    conf = (JConf.builder().seed(seed).updater(JAdam(learning_rate=LR)).dtype(dtype)
            .compute_dtype(dtype).graph_builder()
            .add_inputs("in")
            .add_layer("rnn", layer, "in")
            .add_layer("out", out, "rnn")
            .set_outputs("out")
            .build())
    return JGraph(conf).init(), last


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kind", KINDS)
def test_layer_vertex_matches_jax(kind, dtype, masked, tmp_path):
    tol = TOL[dtype]
    with enable_x64(dtype == "float64"):
        jnet, last = jax_graph(kind, dtype)
        net = to_port(jnet, tmp_path)
        assert isinstance(net, ComputationGraph)
        assert net.num_params() == jnet.num_params()
        assert list(net.param_table()) == _jax_table_keys(jnet)
        f, labels, fm, lm = batch(dtype, masked, last)
        masks = None if fm is None else [fm]
        assert rel(net.output(f, masks=masks).numpy(), jnet.output(f, masks=masks)) <= tol
        ds, jds = DataSet(f, labels, fm, lm), JDataSet(f, labels, fm, lm)
        assert rel(net.score(ds), jnet.score(jds)) <= tol
        grads, score = net.compute_gradient_and_score(ds)
        jgrads, jscore = jnet.compute_gradient_and_score(jds)
        assert rel(score, jscore) <= tol
        errs = tree_errors(jgrads, grads)
        assert max(errs.values()) <= tol, errs
        for _ in range(3):
            net.fit(ds)
            jnet.fit(jds)
        errs = tree_errors(jnet.params, net.params)
        assert max(errs.values()) <= tol, errs


def _jax_table_keys(jnet):
    """The JAX graph's ``param_table`` keys with a nested layer's entries
    flattened to "vertex_fwd/W" (JAX keeps the nested dict under
    "vertex_fwd")."""
    out = []
    for key, v in jnet.param_table().items():
        if isinstance(v, dict):
            out += [f"{key}/{k}" for k in v]
        else:
            out.append(key)
    return out
