"""Keras import in the port on the CPU, against the JAX package and Keras.

Every case of ``tests/test_keras_import.py`` and ``tests/test_keras_golden.py``
imports the same ``.h5`` through both packages (the port with
``device="cpu"``): the two networks' parameter trees must agree keypath for
keypath, and their outputs at 1e-5 absolute (f32). The golden files, written
by real Keras with its own ``predict`` output, are also held against that
output at the JAX tests' ``rtol=1e-4, atol=1e-5``. The cases that need
TensorFlow to write their file (the extended mappers, ``use_bias=False``,
InceptionV3) keep a TensorFlow twin (skipped where TensorFlow is not
installed), and are also written directly in the Keras 2 HDF5 layout,
checked against a numpy oracle of Keras's semantics where one is short: ``use_bias=False`` LSTMs, a
BatchNormalization with ``scale=False``, and the Flatten -> Dense row
permutation on a map with h != w.
"""
import json
import os

import h5py
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import DataSet as JDataSet
from deeplearning4j_tpu.keras import model_import as jki
from deeplearning4j_tpu.nn.conf.layers import DenseLayer as JDense

from deeplearning4j_torch import DataSet, MultiLayerNetwork, ComputationGraph
from deeplearning4j_torch.keras import KerasModelImport, model_import as pki
from deeplearning4j_torch.nn.conf.layers import DenseLayer
from deeplearning4j_torch.utils.model_guesser import ModelGuesser

RES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "resources", "keras")
ATOL = 1e-5                       # port against the JAX package, f32
KERAS_RTOL, KERAS_ATOL = 1e-4, 1e-5   # against Keras's predict (the JAX tests')


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ----------------------------------------------------------------- helpers
def _write_keras_h5(path, model_config, layer_weights, training_config=None):
    """The Keras 2 full-model HDF5 layout: ``model_config`` JSON and
    ``model_weights`` groups with ``weight_names`` attrs
    (``layer_weights``: {layer: {'layer/kernel:0': array}})."""
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(model_config).encode("utf-8")
        f.attrs["keras_version"] = b"2.2.4"
        f.attrs["backend"] = b"tensorflow"
        if training_config is not None:
            f.attrs["training_config"] = json.dumps(training_config).encode("utf-8")
        mw = f.create_group("model_weights")
        mw.attrs["layer_names"] = [n.encode("utf-8") for n in layer_weights]
        for lname, weights in layer_weights.items():
            grp = mw.create_group(lname)
            grp.attrs["weight_names"] = [w.encode("utf-8") for w in weights]
            for wname, arr in weights.items():
                grp.create_dataset(wname, data=arr)
    return path


def _seq(layers):
    return {"class_name": "Sequential", "config": {"name": "sequential", "layers": layers}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = np.asarray(v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                                   else v)
    return out


def _same_trees(port, jax_tree, what):
    p, j = _flat(port), _flat(jax_tree)
    assert sorted(p) == sorted(j), (what, sorted(p), sorted(j))
    for k in j:
        assert p[k].shape == j[k].shape, (what, k)
        np.testing.assert_allclose(p[k], j[k], rtol=0, atol=ATOL, err_msg=f"{what} {k}")


def _both(path, sequential=True):
    """(port net, JAX net) imported from ``path``; their parameter and state
    trees equal keypath for keypath."""
    if sequential:
        port = KerasModelImport.import_keras_sequential_model_and_weights(path, device="cpu")
        jax_net = jki.KerasModelImport.import_keras_sequential_model_and_weights(path)
    else:
        port = KerasModelImport.import_keras_model_and_weights(path, device="cpu")
        jax_net = jki.KerasModelImport.import_keras_model_and_weights(path)
    _same_trees(port.params, jax_net.params, "parameters")
    _same_trees(port.states, jax_net.states, "states")
    return port, jax_net


def _outputs(port, jax_net, x):
    got = port.output(x).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_net.output(x)), rtol=0, atol=ATOL)
    return got


def _nchw(x):
    return np.transpose(x, (0, 3, 1, 2))


def _np_dense(x, k, b, act):
    z = x @ k + b
    if act == "relu":
        return np.maximum(z, 0)
    if act == "softmax":
        e = np.exp(z - z.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)
    return z


def _sigmoid(v):
    return 1.0 / (1.0 + np.exp(-v))


def _np_lstm(x, kernel, rkernel, bias, H, reverse=False):
    """Keras's LSTM in its own gate order (i, f, c, o): [b, T, H]."""
    b, T, _ = x.shape
    h = np.zeros((b, H), np.float64)
    c = np.zeros((b, H), np.float64)
    out = np.zeros((b, T, H))
    steps = range(T - 1, -1, -1) if reverse else range(T)
    for t in steps:
        z = x[:, t] @ kernel + h @ rkernel + bias
        i, fg = _sigmoid(z[:, :H]), _sigmoid(z[:, H:2 * H])
        g, o = np.tanh(z[:, 2 * H:3 * H]), _sigmoid(z[:, 3 * H:])
        c = fg * c + i * g
        h = o * np.tanh(c)
        out[:, t] = h
    return out


# ----------------------------------------------------- test_keras_import.py
def test_sequential_mlp_matches_jax_and_oracle(tmp_path):
    rng = np.random.default_rng(0)
    k1, b1 = rng.normal(size=(8, 16)).astype(np.float32), rng.normal(size=16).astype(np.float32)
    k2, b2 = rng.normal(size=(16, 3)).astype(np.float32), rng.normal(size=3).astype(np.float32)
    path = _write_keras_h5(str(tmp_path / "mlp.h5"), _seq([
        {"class_name": "Dense", "config": {"name": "dense_1", "units": 16, "activation": "relu",
                                           "use_bias": True, "batch_input_shape": [None, 8]}},
        {"class_name": "Dense", "config": {"name": "dense_2", "units": 3,
                                           "activation": "softmax", "use_bias": True}}]),
        {"dense_1": {"dense_1/kernel:0": k1, "dense_1/bias:0": b1},
         "dense_2": {"dense_2/kernel:0": k2, "dense_2/bias:0": b2}},
        training_config={"loss": "categorical_crossentropy"})
    port, jax_net = _both(path)
    x = rng.normal(size=(5, 8)).astype(np.float32)
    got = _outputs(port, jax_net, x)
    np.testing.assert_allclose(got, _np_dense(_np_dense(x, k1, b1, "relu"), k2, b2, "softmax"),
                               rtol=1e-5, atol=1e-6)
    assert isinstance(port, MultiLayerNetwork)
    assert type(port.conf.layers[-1]).__name__ == "OutputLayer"
    assert port.conf.layers[-1].loss == "mcxent"


def test_sequential_cnn_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    kconv = rng.normal(size=(3, 3, 2, 4)).astype(np.float32)
    bconv = rng.normal(size=4).astype(np.float32)
    kd = rng.normal(size=(4 * 4 * 4, 3)).astype(np.float32)
    bd = rng.normal(size=3).astype(np.float32)
    path = _write_keras_h5(str(tmp_path / "cnn.h5"), _seq([
        {"class_name": "Conv2D", "config": {"name": "conv", "filters": 4, "kernel_size": [3, 3],
                                            "strides": [1, 1], "padding": "same",
                                            "activation": "relu", "use_bias": True,
                                            "batch_input_shape": [None, 8, 8, 2]}},
        {"class_name": "MaxPooling2D", "config": {"name": "pool", "pool_size": [2, 2],
                                                  "strides": [2, 2], "padding": "valid"}},
        {"class_name": "Flatten", "config": {"name": "flatten"}},
        {"class_name": "Dense", "config": {"name": "dense", "units": 3, "activation": "softmax",
                                           "use_bias": True}}]),
        {"conv": {"conv/kernel:0": kconv, "conv/bias:0": bconv},
         "dense": {"dense/kernel:0": kd, "dense/bias:0": bd}})
    port, jax_net = _both(path)
    _outputs(port, jax_net, _nchw(rng.normal(size=(2, 8, 8, 2)).astype(np.float32)))


def test_sequential_lstm_gate_reorder(tmp_path):
    """Keras (i, f, c, o) -> the port's (i, f, o, g), held against a numpy
    LSTM in Keras's order on the unreordered arrays."""
    rng = np.random.default_rng(2)
    IN, H, T = 3, 4, 6
    kernel = rng.normal(size=(IN, 4 * H)).astype(np.float32)
    rkernel = rng.normal(size=(H, 4 * H)).astype(np.float32)
    bias = rng.normal(size=4 * H).astype(np.float32)
    kd, bd = rng.normal(size=(H, 2)).astype(np.float32), rng.normal(size=2).astype(np.float32)
    path = _write_keras_h5(str(tmp_path / "lstm.h5"), _seq([
        {"class_name": "LSTM", "config": {"name": "lstm", "units": H, "activation": "tanh",
                                          "recurrent_activation": "sigmoid",
                                          "return_sequences": True,
                                          "batch_input_shape": [None, T, IN]}},
        {"class_name": "Dense", "config": {"name": "dense", "units": 2, "activation": "softmax",
                                           "use_bias": True}}]),
        {"lstm": {"lstm/kernel:0": kernel, "lstm/recurrent_kernel:0": rkernel,
                  "lstm/bias:0": bias},
         "dense": {"dense/kernel:0": kd, "dense/bias:0": bd}})
    port, jax_net = _both(path)
    x = rng.normal(size=(2, T, IN)).astype(np.float32)
    got = _outputs(port, jax_net, x)
    seq = _np_lstm(x, kernel, rkernel, bias, H)
    want = _np_dense(seq.reshape(-1, H), kd, bd, "softmax").reshape(2, T, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert type(port.conf.layers[-1]).__name__ == "RnnOutputLayer"


def test_functional_model_with_add(tmp_path):
    rng = np.random.default_rng(3)
    k1, k2 = (rng.normal(size=(6, 8)).astype(np.float32) for _ in range(2))
    ko = rng.normal(size=(8, 2)).astype(np.float32)
    z8, z2 = np.zeros(8, np.float32), np.zeros(2, np.float32)

    def dense(name, units, act, src):
        return {"class_name": "Dense", "name": name,
                "config": {"name": name, "units": units, "activation": act, "use_bias": True},
                "inbound_nodes": [[[s, 0, 0, {}] for s in src]]}
    cfg = {"class_name": "Model", "config": {
        "name": "model",
        "layers": [{"class_name": "InputLayer", "name": "input_1",
                    "config": {"name": "input_1", "batch_input_shape": [None, 6]},
                    "inbound_nodes": []},
                   dense("branch_a", 8, "relu", ["input_1"]),
                   dense("branch_b", 8, "relu", ["input_1"]),
                   {"class_name": "Add", "name": "add", "config": {"name": "add"},
                    "inbound_nodes": [[["branch_a", 0, 0, {}], ["branch_b", 0, 0, {}]]]},
                   dense("out", 2, "softmax", ["add"])],
        "input_layers": [["input_1", 0, 0]], "output_layers": [["out", 0, 0]]}}
    path = _write_keras_h5(str(tmp_path / "func.h5"), cfg, {
        "branch_a": {"branch_a/kernel:0": k1, "branch_a/bias:0": z8},
        "branch_b": {"branch_b/kernel:0": k2, "branch_b/bias:0": z8},
        "out": {"out/kernel:0": ko, "out/bias:0": z2}},
        training_config={"loss": "categorical_crossentropy"})
    port, jax_net = _both(path, sequential=False)
    assert isinstance(port, ComputationGraph)
    x = rng.normal(size=(4, 6)).astype(np.float32)
    got = _outputs(port, jax_net, x)
    want = _np_dense(np.maximum(x @ k1, 0) + np.maximum(x @ k2, 0), ko, z2, "softmax")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_imported_model_trains_as_in_jax(tmp_path):
    rng = np.random.default_rng(4)
    path = _write_keras_h5(str(tmp_path / "train.h5"), _seq([
        {"class_name": "Dense", "config": {"name": "d1", "units": 8, "activation": "tanh",
                                           "use_bias": True, "batch_input_shape": [None, 4]}},
        {"class_name": "Dense", "config": {"name": "d2", "units": 3, "activation": "softmax",
                                           "use_bias": True}}]),
        {"d1": {"d1/kernel:0": rng.normal(size=(4, 8)).astype(np.float32),
                "d1/bias:0": np.zeros(8, np.float32)},
         "d2": {"d2/kernel:0": rng.normal(size=(8, 3)).astype(np.float32),
                "d2/bias:0": np.zeros(3, np.float32)}})
    port, jax_net = _both(path)
    f = rng.normal(size=(16, 4)).astype(np.float32)
    l = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    s0 = port.score(DataSet(f, l))
    assert s0 == pytest.approx(float(jax_net.score(JDataSet(f, l))), rel=1e-6)
    for _ in range(5):
        port.fit(DataSet(f, l))
        jax_net.fit(JDataSet(f, l))
    assert port.score(DataSet(f, l)) < s0
    _same_trees(port.params, jax_net.params, "parameters after 5 steps")


def test_unsupported_layer_raises(tmp_path):
    path = _write_keras_h5(str(tmp_path / "bad.h5"),
                           _seq([{"class_name": "Lambda", "config": {"name": "weird"}}]), {})
    with pytest.raises(ValueError, match="Unsupported Keras layer"):
        KerasModelImport.import_keras_sequential_model_and_weights(path, device="cpu")
    with pytest.raises(ValueError, match="Not a Sequential"):
        pki._import_sequential({"class_name": "Functional", "config": {"layers": []}}, None, {},
                               "cpu")


# ----------------------------------------------------- test_keras_golden.py
@pytest.mark.parametrize("name,sequential,image", [("seq_cnn", True, True),
                                                   ("functional_inception", False, True),
                                                   ("lstm_td", True, False)])
def test_golden_file_matches_keras_and_jax(name, sequential, image):
    port, jax_net = _both(os.path.join(RES, f"{name}.h5"), sequential)
    x = np.load(os.path.join(RES, f"{name}_in.npy"))
    want = np.load(os.path.join(RES, f"{name}_out.npy"))
    got = _outputs(port, jax_net, _nchw(x) if image else x)
    np.testing.assert_allclose(got, want, rtol=KERAS_RTOL, atol=KERAS_ATOL)


def test_model_guesser_imports_a_keras_file():
    net = ModelGuesser.load_model_guess(os.path.join(RES, "functional_inception.h5"),
                                        device="cpu")
    assert isinstance(net, ComputationGraph)
    x = np.load(os.path.join(RES, "functional_inception_in.npy"))
    np.testing.assert_allclose(net.output(_nchw(x)).numpy(),
                               np.load(os.path.join(RES, "functional_inception_out.npy")),
                               rtol=KERAS_RTOL, atol=KERAS_ATOL)


def test_keras1_dialect_sequential(tmp_path):
    rng = np.random.default_rng(7)
    cW = rng.normal(scale=0.2, size=(3, 3, 1, 2)).astype(np.float32)
    dW = rng.normal(scale=0.2, size=(2 * 4 * 4, 3)).astype(np.float32)
    model_config = {"class_name": "Sequential", "config": [
        {"class_name": "Convolution2D",
         "config": {"name": "conv", "nb_filter": 2, "nb_row": 3, "nb_col": 3,
                    "subsample": [1, 1], "border_mode": "same", "activation": "relu",
                    "batch_input_shape": [None, 4, 4, 1]}},
        {"class_name": "Dropout", "config": {"name": "drop", "p": 0.5}},
        {"class_name": "Flatten", "config": {"name": "flat"}},
        {"class_name": "Dense", "config": {"name": "fc", "output_dim": 3,
                                           "activation": "softmax"}}]}
    path = str(tmp_path / "keras1.h5")
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(model_config)
        mw = f.create_group("model_weights")
        for layer, w, b in (("conv", cW, np.zeros(2, np.float32)),
                            ("fc", dW, np.zeros(3, np.float32))):
            g = mw.create_group(layer)
            g.attrs["weight_names"] = np.asarray([f"{layer}/{layer}_W:0", f"{layer}/{layer}_b:0"],
                                                 dtype=object)
            g[f"{layer}/{layer}_W:0"] = w
            g[f"{layer}/{layer}_b:0"] = b
    port, jax_net = _both(path)
    np.testing.assert_array_equal(port.params["0"]["W"].numpy(), cW)
    x = rng.normal(size=(2, 1, 4, 4)).astype(np.float32)
    out = _outputs(port, jax_net, x)
    # conv(relu, SAME) -> flatten in (h, w, c) -> dense softmax
    xp = np.pad(x[:, 0], ((0, 0), (1, 1), (1, 1)))
    conv = np.zeros((2, 4, 4, 2), np.float32)
    for i in range(4):
        for j in range(4):
            conv[:, i, j, :] = np.tensordot(xp[:, i:i + 3, j:j + 3], cW[:, :, 0, :],
                                            ([1, 2], [0, 1]))
    want = _np_dense(np.maximum(conv, 0).reshape(2, -1), dW, 0.0, "softmax")
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-5)


def test_custom_layer_registration(tmp_path):
    """register_custom_layer maps an unknown class; its weight_setter gets
    numpy copies of the layer's trees and may assign numpy arrays."""
    calls = {}

    def mapper(cls):
        def map_mylayer(cfg):
            calls.setdefault("cfg", []).append(cfg["units"])
            return cls(n_out=int(cfg["units"]), activation="tanh")
        return map_mylayer

    def setter(port):
        def set_mylayer_weights(params, state, weights):
            calls.setdefault("weights", []).append(sorted(weights))
            if port:   # the port hands over numpy copies
                assert all(isinstance(v, np.ndarray) for v in params.values())
            params["W"] = weights["alpha"]
            params["b"] = weights["beta"]
        return set_mylayer_weights

    pki.register_custom_layer("MyProjection", mapper(DenseLayer), setter(True))
    jki.register_custom_layer("MyProjection", mapper(JDense), setter(False))
    rng = np.random.default_rng(3)
    W = rng.normal(size=(6, 4)).astype(np.float32)
    model_config = {"class_name": "Sequential", "config": [
        {"class_name": "MyProjection", "config": {"name": "proj", "units": 4,
                                                  "batch_input_shape": [None, 6]}},
        {"class_name": "Dense", "config": {"name": "out", "units": 2, "activation": "softmax"}}]}
    path = str(tmp_path / "custom.h5")
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(model_config)
        mw = f.create_group("model_weights")
        for layer, names, arrays in (("proj", ("alpha", "beta"), (W, np.zeros(4, np.float32))),
                                     ("out", ("kernel", "bias"),
                                      (rng.normal(size=(4, 2)).astype(np.float32),
                                       np.zeros(2, np.float32)))):
            g = mw.create_group(layer)
            g.attrs["weight_names"] = np.asarray([f"{layer}/{n}" for n in names], dtype=object)
            for n, a in zip(names, arrays):
                g[f"{layer}/{n}"] = a
    port, jax_net = _both(path)
    assert calls["cfg"] == [4, 4] and calls["weights"] == [["alpha", "beta"]] * 2
    np.testing.assert_array_equal(port.params["0"]["W"].numpy(), W)
    assert _outputs(port, jax_net, rng.normal(size=(3, 6)).astype(np.float32)).shape == (3, 2)

    def bad_setter(params, state, weights):
        params["W"] = weights["alpha"][:, :3]
    pki.register_custom_layer("MyProjection", mapper(DenseLayer), bad_setter)
    with pytest.raises(ValueError, match="shape"):
        KerasModelImport.import_keras_sequential_model_and_weights(path, device="cpu")


# ------------------------------------------ mappers written without Keras
def test_extended_cnn_mappers_match_jax(tmp_path):
    """SeparableConv2D, LeakyReLU, DepthwiseConv2D (multiplier 2, Keras 3's
    plain "kernel" name), Cropping2D, AveragePooling2D, Flatten, Dense."""
    rng = np.random.default_rng(11)

    def w(*s):
        return rng.normal(scale=0.3, size=s).astype(np.float32)
    path = _write_keras_h5(str(tmp_path / "ext_cnn.h5"), _seq([
        {"class_name": "SeparableConv2D",
         "config": {"name": "sep", "filters": 8, "kernel_size": [3, 3], "padding": "same",
                    "depth_multiplier": 1, "batch_input_shape": [None, 16, 16, 3]}},
        {"class_name": "LeakyReLU", "config": {"name": "lr", "negative_slope": 0.3}},
        {"class_name": "DepthwiseConv2D",
         "config": {"name": "dw", "kernel_size": [3, 3], "padding": "same",
                    "depth_multiplier": 2}},
        {"class_name": "Cropping2D", "config": {"name": "crop", "cropping": [[1, 1], [2, 2]]}},
        {"class_name": "AveragePooling2D", "config": {"name": "ap", "pool_size": [2, 2]}},
        {"class_name": "Flatten", "config": {"name": "fl"}},
        {"class_name": "Dense", "config": {"name": "d", "units": 4, "activation": "softmax"}}]),
        {"sep": {"sep/depthwise_kernel:0": w(3, 3, 3, 1), "sep/pointwise_kernel:0": w(1, 1, 3, 8),
                 "sep/bias:0": w(8)},
         "dw": {"dw/kernel:0": w(3, 3, 8, 2), "dw/bias:0": w(16)},
         "d": {"d/kernel:0": w(7 * 6 * 16, 4), "d/bias:0": w(4)}},
        training_config={"loss": "categorical_crossentropy"})
    port, jax_net = _both(path)
    assert port.params["2"]["W"].shape == (3, 3, 1, 16)
    _outputs(port, jax_net, _nchw(rng.normal(size=(2, 16, 16, 3)).astype(np.float32)))


def test_extended_rnn_mappers_match_jax_and_oracle(tmp_path):
    """Conv1D + MaxPooling1D + Bidirectional(LSTM, concat, last step) +
    Dense: the direction-split weights reordered per side."""
    rng = np.random.default_rng(12)

    def w(*s):
        return rng.normal(scale=0.4, size=s).astype(np.float32)
    H = 5
    kc, bc = w(3, 6, 8), w(8)
    fk, fr, fb, bk, br, bb = w(8, 4 * H), w(H, 4 * H), w(4 * H), w(8, 4 * H), w(H, 4 * H), w(4 * H)
    kd, bd = w(2 * H, 3), w(3)
    lstm = {"class_name": "LSTM", "config": {"name": "lstm", "units": H,
                                             "return_sequences": False}}
    path = _write_keras_h5(str(tmp_path / "ext_rnn.h5"), _seq([
        {"class_name": "Conv1D", "config": {"name": "c1", "filters": 8, "kernel_size": [3],
                                            "padding": "same", "activation": "relu",
                                            "batch_input_shape": [None, 12, 6]}},
        {"class_name": "MaxPooling1D", "config": {"name": "mp", "pool_size": [2]}},
        {"class_name": "Bidirectional", "config": {"name": "bd", "layer": lstm,
                                                   "merge_mode": "concat"}},
        {"class_name": "Dense", "config": {"name": "out", "units": 3,
                                           "activation": "softmax"}}]),
        {"c1": {"c1/kernel:0": kc, "c1/bias:0": bc},
         "bd": {"bd/forward_lstm/kernel:0": fk, "bd/forward_lstm/recurrent_kernel:0": fr,
                "bd/forward_lstm/bias:0": fb, "bd/backward_lstm/kernel:0": bk,
                "bd/backward_lstm/recurrent_kernel:0": br, "bd/backward_lstm/bias:0": bb},
         "out": {"out/kernel:0": kd, "out/bias:0": bd}})
    port, jax_net = _both(path)
    x = rng.normal(size=(2, 12, 6)).astype(np.float32)
    got = _outputs(port, jax_net, x)
    xp = np.pad(x, ((0, 0), (1, 1), (0, 0)))
    conv = np.maximum(np.stack([np.einsum("bkc,kco->bo", xp[:, t:t + 3], kc)
                                for t in range(12)], 1) + bc, 0)
    pooled = conv.reshape(2, 6, 2, 8).max(2)
    fwd = _np_lstm(pooled, fk, fr, fb, H)[:, -1]
    bwd = _np_lstm(pooled, bk, br, bb, H, reverse=True)[:, 0]
    want = _np_dense(np.concatenate([fwd, bwd], 1), kd, bd, "softmax")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_use_bias_false_lstms_zero_the_port_bias(tmp_path):
    """LSTM(use_bias=False, return_sequences) then Bidirectional(LSTM(
    use_bias=False)): no bias dataset, so the port's initialised bias (forget
    gate 1.0) must be zeroed, as the numpy LSTM without a bias computes."""
    rng = np.random.default_rng(13)

    def w(*s):
        return rng.normal(scale=0.5, size=s).astype(np.float32)
    k1, r1 = w(4, 20), w(5, 20)
    fk, fr, bk, br = w(5, 12), w(3, 12), w(5, 12), w(3, 12)
    kd, bd = w(6, 2), w(2)
    inner = {"class_name": "LSTM", "config": {"name": "i", "units": 3, "use_bias": False,
                                              "return_sequences": False}}
    path = _write_keras_h5(str(tmp_path / "nobias.h5"), _seq([
        {"class_name": "LSTM", "config": {"name": "l", "units": 5, "use_bias": False,
                                          "return_sequences": True,
                                          "batch_input_shape": [None, 6, 4]}},
        {"class_name": "Bidirectional", "config": {"name": "bi", "layer": inner}},
        {"class_name": "Dense", "config": {"name": "d", "units": 2, "activation": "softmax"}}]),
        {"l": {"l/kernel:0": k1, "l/recurrent_kernel:0": r1},
         "bi": {"bi/forward_i/kernel:0": fk, "bi/forward_i/recurrent_kernel:0": fr,
                "bi/backward_i/kernel:0": bk, "bi/backward_i/recurrent_kernel:0": br},
         "d": {"d/kernel:0": kd, "d/bias:0": bd}})
    port, jax_net = _both(path)
    assert float(port.params["0"]["b"].abs().max()) == 0.0
    assert float(port.params["1"]["fwd"]["b"].abs().max()) == 0.0
    x = rng.normal(size=(2, 6, 4)).astype(np.float32)
    got = _outputs(port, jax_net, x)
    seq = _np_lstm(x, k1, r1, 0.0, 5)
    last = np.concatenate([_np_lstm(seq, fk, fr, 0.0, 3)[:, -1],
                           _np_lstm(seq, bk, br, 0.0, 3, reverse=True)[:, 0]], 1)
    np.testing.assert_allclose(got, _np_dense(last, kd, bd, "softmax"), rtol=1e-4, atol=1e-5)


def test_batchnorm_scale_false_fills_beta_and_running_statistics(tmp_path):
    """BatchNormalization(scale=False) ships beta and the moving statistics
    only: gamma keeps its 1.0, beta is copied, the moving mean and variance
    land in the layer's state buffers, and inference uses them."""
    rng = np.random.default_rng(14)
    k1, b1 = rng.normal(size=(5, 6)).astype(np.float32), rng.normal(size=6).astype(np.float32)
    beta = rng.normal(size=6).astype(np.float32)
    mean = rng.normal(size=6).astype(np.float32)
    var = rng.uniform(0.5, 2.0, size=6).astype(np.float32)
    k2, b2 = rng.normal(size=(6, 3)).astype(np.float32), rng.normal(size=3).astype(np.float32)
    path = _write_keras_h5(str(tmp_path / "bn.h5"), _seq([
        {"class_name": "Dense", "config": {"name": "d1", "units": 6, "activation": "linear",
                                           "batch_input_shape": [None, 5]}},
        {"class_name": "BatchNormalization", "config": {"name": "bn", "momentum": 0.99,
                                                        "epsilon": 1e-3, "scale": False}},
        {"class_name": "Dense", "config": {"name": "d2", "units": 3, "activation": "softmax"}}]),
        {"d1": {"d1/kernel:0": k1, "d1/bias:0": b1},
         "bn": {"bn/beta:0": beta, "bn/moving_mean:0": mean, "bn/moving_variance:0": var},
         "d2": {"d2/kernel:0": k2, "d2/bias:0": b2}})
    port, jax_net = _both(path)
    np.testing.assert_array_equal(port.params["1"]["gamma"].numpy(), np.ones(6, np.float32))
    np.testing.assert_array_equal(port.params["1"]["beta"].numpy(), beta)
    np.testing.assert_array_equal(port.states["1"]["mean"].numpy(), mean)
    np.testing.assert_array_equal(port.states["1"]["var"].numpy(), var)
    x = rng.normal(size=(4, 5)).astype(np.float32)
    got = _outputs(port, jax_net, x)
    z = (x @ k1 + b1 - mean) / np.sqrt(var + 1e-3) + beta
    np.testing.assert_allclose(got, _np_dense(z, k2, b2, "softmax"), rtol=1e-4, atol=1e-5)


def test_flatten_dense_permutation_on_a_non_square_map(tmp_path):
    """A 6x4 map: Keras flattens (h, w, c), the port (c, h, w); the dense
    kernel's rows are permuted, which a square map would not show up."""
    rng = np.random.default_rng(15)
    kc, bc = rng.normal(size=(3, 3, 2, 3)).astype(np.float32), rng.normal(size=3).astype(np.float32)
    kd, bd = rng.normal(size=(4 * 2 * 3, 5)).astype(np.float32), rng.normal(size=5).astype(
        np.float32)
    path = _write_keras_h5(str(tmp_path / "flat.h5"), _seq([
        {"class_name": "Conv2D", "config": {"name": "c", "filters": 3, "kernel_size": [3, 3],
                                            "padding": "valid", "activation": "relu",
                                            "batch_input_shape": [None, 6, 4, 2]}},
        {"class_name": "Flatten", "config": {"name": "f"}},
        {"class_name": "Dense", "config": {"name": "d", "units": 5, "activation": "softmax"}}]),
        {"c": {"c/kernel:0": kc, "c/bias:0": bc}, "d": {"d/kernel:0": kd, "d/bias:0": bd}})
    port, jax_net = _both(path)
    assert not np.array_equal(port.params["1"]["W"].numpy(), kd)   # rows permuted
    x = rng.normal(size=(3, 6, 4, 2)).astype(np.float32)
    got = _outputs(port, jax_net, _nchw(x))
    conv = np.zeros((3, 4, 2, 3), np.float32)
    for i in range(4):
        for j in range(2):
            conv[:, i, j] = np.tensordot(x[:, i:i + 3, j:j + 3], kc, ([1, 2, 3], [0, 1, 2]))
    want = _np_dense(np.maximum(conv + bc, 0).reshape(3, -1), kd, bd, "softmax")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_import_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        KerasModelImport.import_keras_model_and_weights(os.path.join(RES, "lstm_td.h5"))


# -------------------------------------------------- written by TensorFlow
def _tf():
    tf = pytest.importorskip("tensorflow")
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "-1")
    return tf


def _keras_case(tmp_path, tf, model, x, name):
    want = model.predict(x, verbose=0)
    path = str(tmp_path / f"{name}.h5")
    model.save(path)
    port, jax_net = _both(path, sequential=isinstance(model, tf.keras.Sequential))
    got = _outputs(port, jax_net, _nchw(x) if x.ndim == 4 else x)
    return got, want


def test_tf_extended_layer_mappers(tmp_path):
    tf = _tf()
    tf.keras.utils.set_random_seed(11)
    L = tf.keras.layers
    m = tf.keras.Sequential([L.Input((16, 16, 3)), L.SeparableConv2D(8, 3, padding="same"),
                             L.LeakyReLU(), L.DepthwiseConv2D(3, padding="same",
                                                              depth_multiplier=2),
                             L.Cropping2D(((1, 1), (2, 2))), L.AveragePooling2D(2), L.Flatten(),
                             L.Dense(4, activation="softmax")])
    m.compile(loss="categorical_crossentropy", optimizer="sgd")
    x = np.random.default_rng(2).normal(size=(2, 16, 16, 3)).astype(np.float32)
    got, want = _keras_case(tmp_path, tf, m, x, "ext")
    np.testing.assert_allclose(got, want, rtol=KERAS_RTOL, atol=KERAS_ATOL)


def test_tf_extended_rnn_mappers(tmp_path):
    tf = _tf()
    tf.keras.utils.set_random_seed(12)
    L = tf.keras.layers
    m = tf.keras.Sequential([L.Input((12, 6)), L.Conv1D(8, 3, padding="same", activation="relu"),
                             L.MaxPooling1D(2), L.Bidirectional(L.LSTM(5)),
                             L.Dense(3, activation="softmax")])
    m.compile(loss="categorical_crossentropy", optimizer="sgd")
    x = np.random.default_rng(3).normal(size=(2, 12, 6)).astype(np.float32)
    got, want = _keras_case(tmp_path, tf, m, x, "ext_rnn")
    np.testing.assert_allclose(got, want, rtol=KERAS_RTOL, atol=KERAS_ATOL)


def test_tf_use_bias_false(tmp_path):
    tf = _tf()
    tf.keras.utils.set_random_seed(13)
    L = tf.keras.layers
    m = tf.keras.Sequential([L.Input((6, 4)), L.LSTM(5, use_bias=False, return_sequences=True),
                             L.Bidirectional(L.LSTM(3, use_bias=False)),
                             L.Dense(2, activation="softmax")])
    m.compile(loss="categorical_crossentropy", optimizer="sgd")
    x = np.random.default_rng(3).normal(size=(2, 6, 4)).astype(np.float32)
    got, want = _keras_case(tmp_path, tf, m, x, "nobias")
    np.testing.assert_allclose(got, want, rtol=KERAS_RTOL, atol=KERAS_ATOL)


@pytest.mark.slow
def test_real_inceptionv3_import_end_to_end(tmp_path):
    """InceptionV3 (313 layers, weights=None) saved by tf.keras, imported as
    a ComputationGraph by both packages (the JAX test's tolerance)."""
    tf = _tf()
    tf.keras.utils.set_random_seed(5)
    m = tf.keras.applications.InceptionV3(weights=None, input_shape=(75, 75, 3), classes=10)
    x = np.random.default_rng(0).normal(size=(2, 75, 75, 3)).astype(np.float32)
    got, want = _keras_case(tmp_path, tf, m, x, "iv3")
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
