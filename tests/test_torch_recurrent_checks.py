"""Gradient checks and model zips of the recurrent family, against the
JAX package.

- ``GradientCheckUtil`` of the port on the JAX package's recurrent
  gradient-check nets (``tests/test_gradientcheck_extended.py:148-156``
  and ``:443``, ``tests/test_remat.py:51-60``'s Bidirectional(LSTM)) and
  a step-loop GravesLSTM, in f64, moved through the model zip.
- Model zips with nested keypaths ("0/fwd/W", Adam's "0/fwd/W/0") both
  ways after a fit, in a MultiLayerNetwork and a graph: parameters and
  updater state bit-equal, and the port's configuration JSON equal to
  JAX's.
"""
import io
import json
import zipfile

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu import Sgd as JSgd
from deeplearning4j_tpu.compat import enable_x64
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.utils.model_serializer import ModelSerializer

from deeplearning4j_torch import DataSet
from deeplearning4j_torch.nn.gradientcheck import GradientCheckUtil
from deeplearning4j_torch.utils.model_serializer import write_model

from test_torch_recurrent_family import KINDS, batch, jax_net, to_port, tree_errors
from test_torch_recurrent_graph import jax_graph


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ---------------------------------------------------------- gradient checks
def _gc_net(layer, n_out_rnn, tmp_path, extra=None):
    lst = (JConf.builder().seed(12345).updater(JSgd(learning_rate=1.0))
           .dtype("float64").compute_dtype("float64").list().layer(layer))
    for e in extra or ():
        lst = lst.layer(e)
    conf = lst.layer(jl.RnnOutputLayer(n_in=n_out_rnn, n_out=2, activation="softmax",
                                       loss="mcxent")).build()
    return to_port(JNet(conf).init(), tmp_path)


@pytest.mark.parametrize("layer,n_out", [
    (jl.GravesLSTM(n_in=3, n_out=4, activation="tanh"), 4),
    (jl.GravesBidirectionalLSTM(n_in=3, n_out=4, activation="tanh"), 4),
    (jl.SimpleRnn(n_in=3, n_out=4, activation="tanh"), 4),
    (jl.Bidirectional(inner=jl.LSTM(n_in=3, n_out=4, activation="tanh")), 8),
    (jl.Bidirectional(inner=jl.LSTM(n_in=4, n_out=4)), 8),
    (jl.GravesLSTM(n_in=3, n_out=4, activation="softsign", gate_activation="hardsigmoid"), 4),
], ids=["graves", "graves-bidi", "simple", "bidi-wrapper", "remat-bidi", "step-loop"])
def test_recurrent_family_gradient_check(layer, n_out, tmp_path):
    with enable_x64(True):
        net = _gc_net(layer, n_out, tmp_path)
    rng = np.random.default_rng(10)
    n_in = layer.inner.n_in if hasattr(layer, "inner") else layer.n_in
    f = rng.normal(size=(3, 4, n_in)).astype(np.float32)
    labels = np.eye(2)[rng.integers(0, 2, (3, 4))]
    assert GradientCheckUtil.check_gradients(net, DataSet(f, labels), max_per_param=8,
                                             print_results=True)


def test_simple_rnn_layer_norm_gradient_check(tmp_path):
    """``tests/test_gradientcheck_extended.py:443``: SimpleRnn ->
    LayerNormalization -> RnnOutputLayer."""
    with enable_x64(True):
        net = _gc_net(jl.SimpleRnn(n_in=3, n_out=6, activation="tanh"), 6, tmp_path,
                      extra=[jl.LayerNormalization(n_in=6, n_out=6)])
    rng = np.random.default_rng(3)
    f = rng.normal(size=(4, 5, 3)).astype(np.float32)
    labels = np.eye(2)[rng.integers(0, 2, (4, 5))]
    assert GradientCheckUtil.check_gradients(net, DataSet(f, labels), max_per_param=12)


# ------------------------------------------------------------------- zips
def _npz(path, member):
    with zipfile.ZipFile(path) as z, np.load(io.BytesIO(z.read(member))) as npz:
        return {k: npz[k] for k in npz.files}


def _same_npz(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def _config(path):
    with zipfile.ZipFile(path) as z:
        return json.loads(z.read("configuration.json"))["config"]


@pytest.mark.parametrize("kind", KINDS)
def test_zips_both_ways(kind, tmp_path):
    """JAX -> port after a JAX fit, and port -> JAX after a port fit: the
    parameters and the Adam state under nested keypaths, bit-equal."""
    with enable_x64(True):
        jnet, last = jax_net(kind, "float64")
        f, labels, fm, lm = batch("float64", True, last)
        jnet.fit(JDataSet(f, labels, fm, lm))
        jpath = tmp_path / "jax.zip"
        ModelSerializer.write_model(jnet, str(jpath))
        net = to_port(jnet, tmp_path, "jax_again.zip")
        ppath = tmp_path / "port.zip"
        write_model(net, str(ppath))
        for member in ("coefficients.bin", "updaterState.bin"):
            _same_npz(_npz(jpath, member), _npz(ppath, member))
        assert _config(ppath) == _config(jpath)
        if kind in ("bidirectional_graves", "last_bidirectional"):
            assert "0/fwd/W" in _npz(ppath, "coefficients.bin")
            assert "0/bwd/RW/1" in _npz(ppath, "updaterState.bin")
        net.fit(DataSet(f, labels, fm, lm))
        write_model(net, str(ppath))
        back = ModelSerializer.restore_multi_layer_network(str(ppath))
        assert back.iteration_count == net.iteration_count == 2
        for jtree, ptree in ((back.params, net.params), (back.updater_state, net.updater_state)):
            for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
                t = ptree
                for k in path:
                    t = t[k.key] if hasattr(k, "key") else t[k.idx]
                assert np.array_equal(np.asarray(leaf), t.numpy()), path


def test_graph_zip_both_ways(tmp_path):
    """A Bidirectional layer vertex: JAX -> port -> JAX after a fit each
    side, parameters and Adam state bit-equal under "rnn/fwd/W"."""
    with enable_x64(True):
        jnet, _ = jax_graph("bidirectional_graves", "float64")
        f, labels, fm, lm = batch("float64", True, False)
        jnet.fit(JDataSet(f, labels, fm, lm))
        net = to_port(jnet, tmp_path)
        net.fit(DataSet(f, labels, fm, lm))
        path = tmp_path / "port_graph.zip"
        write_model(net, str(path))
        assert "rnn/bwd/RW/1" in _npz(path, "updaterState.bin")
        back = ModelSerializer.restore_computation_graph(str(path))
        for jtree, ptree in ((back.params, net.params), (back.updater_state, net.updater_state)):
            errs = tree_errors(jtree, ptree)
            assert len(errs) > 0 and max(errs.values()) == 0.0, errs
