"""Model zips both ways between the port and the JAX package, on the CPU.

The port trains a char-RNN (MultiLayerNetwork, Adam), a bf16-compute
TransformerLM (ComputationGraph) and a small ResNet50 (BatchNormalization
state), writes each with ``write_model``, and the JAX package restores
it: every array bit-equal to the port's, outputs within the frameworks'
tolerance, and training resumes on the JAX side as it continues in the
port. Each updater's state restores in the JAX package. A JAX zip read by
the port and written again holds the same arrays bit for bit. Normalizers
round-trip; ``restore_model`` and ``ModelGuesser`` dispatch by what the
file holds.

Tolerances: f32, the same arithmetic in another summation order: outputs
and parameters after two more Adam steps 1e-5 absolute, scores 1e-5
relative (the training tests' limits). bf16 compute: outputs 3e-2
absolute, as tests/test_torch_graph.py (a logit may move by a bf16 unit).
"""
import io
import json
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import ResNet50 as JResNet50
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu.utils.model_serializer import ModelSerializer as JSerializer

from deeplearning4j_torch import (Adam, DataSet, MultiLayerNetwork, NeuralNetConfiguration,
                                  NormalizerStandardize)
from deeplearning4j_torch.models import ResNet50, TransformerLM
from deeplearning4j_torch.nn import updaters
from deeplearning4j_torch.nn.conf.layers import DenseLayer, GravesLSTM, OutputLayer, RnnOutputLayer
from deeplearning4j_torch.nn.graph import ComputationGraph
from deeplearning4j_torch.utils import model_serializer as ms
from deeplearning4j_torch.utils.model_guesser import (ModelGuesser, load_config_guess,
                                                      load_model_guess)

V, H, B, T = 12, 16, 4, 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _char_rnn(updater=None, seed=7):
    conf = (NeuralNetConfiguration.builder().seed(seed)
            .updater(updater or Adam(learning_rate=1e-2)).activation("tanh").list()
            .layer(GravesLSTM(n_in=V, n_out=H)).layer(GravesLSTM(n_in=H, n_out=H))
            .layer(RnnOutputLayer(n_in=H, n_out=V, activation="softmax", loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf).init(device="cpu")


def _text(seed):
    ids = np.random.default_rng(seed).integers(0, V, (B, T + 1))
    eye = np.eye(V, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def _lm_batch(seed, vocab=V, t=T):
    ids = np.random.default_rng(seed).integers(0, vocab, (2, t + 1))
    return ids[:, :-1].astype(np.float32), np.eye(vocab, dtype=np.float32)[ids[:, 1:]]


def _np(t):
    """A port tensor as the numpy array the JAX package holds (bf16 kept)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16.dtype)
    return t.numpy()


def _flat(tree, prefix=""):
    """{keypath: leaf} of nested dicts, lists and tuples (either package)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, sub in items:
        out.update(_flat(sub, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _assert_bit_equal(port_tree, jax_tree):
    port, jx = _flat(port_tree), _flat(jax_tree)
    assert set(port) == set(jx)
    for k, t in port.items():
        a, b = _np(t), np.asarray(jx[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


def _npz_members(path):
    """{member: {key: ndarray}} of a model zip's .npz members."""
    out = {}
    with zipfile.ZipFile(path) as z:
        for name in z.namelist():
            if name.endswith(".bin") and name != "normalizer.bin":
                with np.load(io.BytesIO(z.read(name))) as npz:
                    out[name] = {k: npz[k] for k in npz.files}
    return out


def test_char_rnn_written_by_the_port_restores_and_resumes_in_jax(tmp_path):
    """Two Adam steps in the port, the zip restored in the JAX package (its
    parameters, moments and counts bit-equal), then two more steps on each
    side: the same losses and parameters."""
    net = _char_rnn()
    f, l = _text(1)
    for _ in range(2):
        net.fit(DataSet(f, l))
    path = ms.write_model(net, tmp_path / "rnn.zip")
    with zipfile.ZipFile(path) as z:
        assert sorted(z.namelist()) == ["coefficients.bin", "configuration.json",
                                        "states.bin", "updaterState.bin"]
        doc = json.loads(z.read("configuration.json"))
    assert doc["type"] == "MultiLayerNetwork" and doc["iteration_count"] == 2
    assert doc["epoch_count"] == 2
    jnet = JSerializer.restore_multi_layer_network(str(path))
    _assert_bit_equal(net.params, jnet.params)
    _assert_bit_equal(net.updater_state, jnet.updater_state)
    assert jnet.iteration_count == 2 and jnet.epoch_count == 2
    np.testing.assert_allclose(net.output(f).numpy(), np.asarray(jnet.output(f)), rtol=0,
                               atol=1e-5)
    f2, l2 = _text(2)
    for _ in range(2):
        net.fit(DataSet(f2, l2))
        jnet.fit(JDataSet(f2, l2))
    assert abs(net.score() - float(jnet.score())) <= 1e-5 * float(jnet.score())
    for k, p in _flat(jnet.params).items():
        np.testing.assert_allclose(_flat(net.params)[k].numpy(), np.asarray(p), rtol=0,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", sorted(updaters.UPDATERS))
def test_every_updaters_state_restores_in_jax(tmp_path, name):
    """The writer emits each updater's slots at the JAX package's keypaths
    (its restore refuses a missing one), bit-equal."""
    conf = (NeuralNetConfiguration.builder().seed(3).updater(updaters.UPDATERS[name]()).list()
            .layer(DenseLayer(n_in=5, n_out=4, activation="tanh"))
            .layer(OutputLayer(n_in=4, n_out=3, activation="softmax")).build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    rng = np.random.default_rng(0)
    net.fit(rng.standard_normal((6, 5)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)])
    path = ms.write_model(net, tmp_path / f"{name}.zip")
    jnet = JSerializer.restore_model(str(path))
    _assert_bit_equal(net.updater_state, jnet.updater_state)
    _assert_bit_equal(net.params, jnet.params)


def test_bf16_transformer_lm_written_by_the_port_restores_in_jax(tmp_path):
    """A bf16-compute TransformerLM after one Adam step: a ComputationGraph
    zip the JAX package restores bit-equal, with outputs within bf16's
    tolerance."""
    conf = TransformerLM(vocab_size=V, embed_dim=16, num_heads=2, num_blocks=2, seed=5).conf()
    conf.global_conf.compute_dtype = "bfloat16"
    net = ComputationGraph(conf).init(device="cpu")
    f, l = _lm_batch(3)
    net.fit(DataSet(f, l))
    path = ms.ModelSerializer.writeModel(net, tmp_path / "lm.zip")
    jnet = JSerializer.restore_computation_graph(str(path))
    assert jnet.conf.global_conf.compute_dtype == "bfloat16"
    _assert_bit_equal(net.params, jnet.params)
    _assert_bit_equal(net.updater_state, jnet.updater_state)
    np.testing.assert_allclose(net.output(f).numpy(), np.asarray(jnet.output(f), np.float32),
                               rtol=0, atol=3e-2)


def test_resnet50_states_written_by_the_port_restore_in_jax(tmp_path):
    """A ResNet50 at 3x32x32 after one step: its BatchNormalization
    running statistics (states.bin) restore in the JAX package bit-equal,
    and the inference outputs agree."""
    net = ResNet50(num_classes=4, input_shape=(3, 32, 32)).init(device="cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    net.fit(x, np.eye(4, dtype=np.float32)[[0, 3]])
    means = _flat({n: s for n, s in net.states.items() if s})
    assert len(means) == 2 * 53 and any((t != 0).any() for k, t in means.items()
                                        if k.endswith("mean"))
    path = ms.write_model(net, tmp_path / "r50.zip", save_updater=False)
    with zipfile.ZipFile(path) as z:
        assert "updaterState.bin" not in z.namelist()
    jnet = JSerializer.restore_computation_graph(str(path))
    _assert_bit_equal(net.states, jnet.states)
    _assert_bit_equal(net.params, jnet.params)
    np.testing.assert_allclose(net.output(x).numpy(), np.asarray(jnet.output(x)), rtol=0,
                               atol=1e-5)


def _jax_bf16_rnn():
    conf = (JConf.builder().seed(4).updater(JAdam(learning_rate=1e-2)).activation("tanh")
            .dtype("bfloat16").compute_dtype("bfloat16").list()
            .layer(jlayers.GravesLSTM(n_in=V, n_out=H))
            .layer(jlayers.RnnOutputLayer(n_in=H, n_out=V, activation="softmax",
                                          loss="mcxent")).build())
    jnet = JNet(conf).init()
    f, l = _text(5)
    jnet.fit(JDataSet(f, l))
    return jnet


def _jax_r50():
    jnet = JGraph(JResNet50(num_classes=4, input_shape=(3, 32, 32)).conf()).init()
    rng = np.random.default_rng(1)
    jnet.states = jax.tree_util.tree_map(
        lambda s: s + jnp.asarray(rng.uniform(0.1, 1.0, s.shape), s.dtype), jnet.states)
    jnet.iteration_count, jnet.epoch_count = 7, 3
    return jnet


@pytest.mark.parametrize("make", [_jax_bf16_rnn, _jax_r50], ids=["bf16_rnn", "resnet50"])
def test_jax_to_port_to_jax_is_bit_identical(tmp_path, make):
    """A JAX zip (bf16 parameters and Adam moments; ResNet50 running
    statistics) read by the port and written again holds the same arrays,
    keys, dtypes and bytes; the JAX package restores it to the same net."""
    jnet = make()
    first = tmp_path / "jax.zip"
    JSerializer.write_model(jnet, str(first))
    net = ms.restore_model(first, device="cpu")
    second = ms.write_model(net, tmp_path / "port.zip")
    a, b = _npz_members(first), _npz_members(second)
    assert set(a) == set(b)
    for member, arrays in a.items():
        assert set(arrays) == set(b[member]), member
        for k, arr in arrays.items():
            assert arr.dtype == b[member][k].dtype and arr.tobytes() == b[member][k].tobytes()
    again = JSerializer.restore_model(str(second))
    assert (again.iteration_count, again.epoch_count) == (jnet.iteration_count,
                                                          jnet.epoch_count)
    for tree in ("params", "states", "updater_state"):
        ja, jb = _flat(getattr(jnet, tree)), _flat(getattr(again, tree))
        assert set(ja) == set(jb)
        for k in ja:
            assert np.asarray(ja[k]).tobytes() == np.asarray(jb[k]).tobytes(), (tree, k)


def test_normalizer_round_trips_both_ways(tmp_path):
    """A fitted NormalizerStandardize written by the port reads back in the
    port and in the JAX package; one written by the JAX package reads in
    the port."""
    from deeplearning4j_tpu.datasets.normalizers import NormalizerStandardize as JNorm

    f, l = _text(6)
    norm = NormalizerStandardize()
    norm.fit(DataSet(f + np.random.default_rng(0).standard_normal(f.shape).astype(np.float32),
                     l))
    net = _char_rnn()
    path = ms.write_model(net, tmp_path / "n.zip", normalizer=norm)
    back = ms.restore_normalizer(path)
    jback = JSerializer.restore_normalizer(str(path))
    assert ModelGuesser.loadNormalizer(path).to_bytes() == norm.to_bytes()
    for got in (back, jback):
        np.testing.assert_array_equal(np.asarray(got.mean), np.asarray(norm.mean))
        np.testing.assert_array_equal(np.asarray(got.std), np.asarray(norm.std))
    assert ms.restore_normalizer(ms.write_model(net, tmp_path / "none.zip")) is None
    jnorm = JNorm()
    jnorm.fit(JDataSet(f, l))
    jpath = tmp_path / "jn.zip"
    JSerializer.write_model(_jax_bf16_rnn(), str(jpath), normalizer=jnorm)
    assert ms.ModelSerializer.restoreNormalizer(jpath).to_bytes() == jnorm.to_bytes()


def test_restore_model_dispatches_by_type(tmp_path):
    rnn = ms.write_model(_char_rnn(), tmp_path / "rnn.zip")
    lm = TransformerLM(vocab_size=V, embed_dim=8, num_heads=2, num_blocks=1).init(device="cpu")
    graph = ms.write_model(lm, tmp_path / "lm.zip")
    assert isinstance(ms.restore_model(rnn, device="cpu"), MultiLayerNetwork)
    assert isinstance(ms.ModelSerializer.restoreModel(graph, device="cpu"), ComputationGraph)
    with pytest.raises(ValueError, match="is a ComputationGraph"):
        ms.restore_multi_layer_network(graph, device="cpu")
    with pytest.raises(ValueError, match="is a MultiLayerNetwork"):
        ms.restore_computation_graph(rnn, device="cpu")
    bad = tmp_path / "bad.zip"
    with zipfile.ZipFile(rnn) as src, zipfile.ZipFile(bad, "w") as dst:
        for name in src.namelist():
            data = src.read(name)
            if name == "configuration.json":
                data = json.dumps({**json.loads(data), "type": "Word2Vec"}).encode()
            dst.writestr(name, data)
    with pytest.raises(ValueError, match="Word2Vec"):
        ms.restore_model(bad, device="cpu")


def test_model_guesser_loads_a_zip_and_a_bare_json_and_refuses_hdf5(tmp_path):
    net = _char_rnn()
    f, l = _text(8)
    net.fit(DataSet(f, l))
    zpath = ms.write_model(net, tmp_path / "m.zip")
    got = load_model_guess(zpath, device="cpu")
    assert isinstance(got, MultiLayerNetwork) and got.iteration_count == 1
    np.testing.assert_array_equal(got.output(f).numpy(), net.output(f).numpy())
    assert ModelGuesser.loadModelGuess(zpath, load_updater=False, device="cpu") \
        .updater_state["0"]["W"][0].abs().sum() == 0

    mln_json = tmp_path / "mln.json"
    mln_json.write_text(net.conf.to_json())
    fresh = ModelGuesser.load_model_guess(mln_json, device="cpu")
    seeded = MultiLayerNetwork(load_config_guess(mln_json)).init(device="cpu")
    assert isinstance(fresh, MultiLayerNetwork) and fresh.iteration_count == 0
    _assert_bit_equal(fresh.params, {k: {n: _np(t) for n, t in p.items()}
                                     for k, p in seeded.params.items()})
    cg_json = tmp_path / "cg.json"
    cg_json.write_text(TransformerLM(vocab_size=V, embed_dim=8, num_heads=2,
                                     num_blocks=1).conf().to_json())
    assert isinstance(load_model_guess(cg_json, device="cpu"), ComputationGraph)

    h5 = tmp_path / "model.h5"
    h5.write_bytes(b"\x89HDF\r\n\x1a\n" + bytes(64))
    with pytest.raises(NotImplementedError, match="Keras"):
        load_model_guess(h5, device="cpu")
    junk = tmp_path / "junk.json"
    junk.write_text(json.dumps({"@class": "NotAConfig"}))
    with pytest.raises(ValueError, match="either container"):
        ModelGuesser.loadConfigGuess(junk)
