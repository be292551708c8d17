"""The slice end to end on the CPU: a JAX-written model zip served by the port.

A JAX ``MultiLayerNetwork`` (2 x GravesLSTM(128) + RnnOutputLayer softmax,
bf16 compute, random peepholes) is written with ``ModelSerializer`` and
restored by the port on ``device="cpu"``. Its ``output`` (unmasked: the
fused pair, K3; masked: K1 per layer) and chunked ``rnn_time_step`` must
match the JAX package, which runs its Pallas kernels in interpret mode.
Tolerance 2e-3: both sides compute in bf16 but round at different places
(XLA vs PyTorch CPU matmuls and softmax). The measured disagreement is
about 5e-4, one bf16 unit at the probabilities' size (~1/V = 0.06) and at
the hidden activations' size, so the limit is four such units. The hidden
activations of the pair are compared too: near-uniform probabilities of a
random net would hide a wrong gate order or a lost peephole.
"""
import json
import zipfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import deeplearning4j_tpu.ops.flash_attention as fa
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.utils.model_serializer import ModelSerializer
from deeplearning4j_tpu import Adam

from deeplearning4j_torch.nn.conf import MultiLayerConfiguration, serde
from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_torch.ops import lstm_fused
from deeplearning4j_torch.utils.model_serializer import (
    params_from_numpy, restore_multi_layer_network)

V, H, B, T = 16, 128, 8, 6
ATOL = 2e-3


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


def _jax_net(seed=7):
    conf = (JConf.builder().seed(seed).updater(Adam(learning_rate=1e-3))
            .activation("tanh").compute_dtype("bfloat16").list()
            .layer(jlayers.GravesLSTM(n_in=V, n_out=H))
            .layer(jlayers.GravesLSTM(n_in=H, n_out=H))
            .layer(jlayers.RnnOutputLayer(n_in=H, n_out=V, activation="softmax",
                                          loss="mcxent"))
            .build())
    net = JNet(conf).init()
    rng = np.random.default_rng(seed)
    for i in ("0", "1"):        # init draws zero peepholes: exercise them
        for k in ("pi", "pf", "po"):
            net.params[i][k] = jnp.asarray(
                (0.3 * rng.standard_normal(H)).astype(np.float32))
    return net


def _onehot(seed, b=B, t=T):
    rng = np.random.default_rng(seed)
    return np.eye(V, dtype=np.float32)[rng.integers(0, V, (b, t))]


@pytest.fixture(scope="module")
def jax_zip(tmp_path_factory):
    path = tmp_path_factory.mktemp("zip") / "charrnn.zip"
    old = fa._FORCE_INTERPRET
    fa._FORCE_INTERPRET = True
    try:
        net = _jax_net()
        ModelSerializer.write_model(net, str(path))
    finally:
        fa._FORCE_INTERPRET = old
    return net, path


def _spy_scan2(monkeypatch):
    calls = []
    real = lstm_fused.lstm_scan2

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(lstm_fused, "lstm_scan2", spy)
    return calls


def test_restored_output_matches_jax_unmasked_through_fused_pair(jax_zip, monkeypatch):
    jnet, path = jax_zip
    net = restore_multi_layer_network(path, device="cpu")
    calls = _spy_scan2(monkeypatch)
    x = _onehot(0)
    got = net.output(x)
    assert calls == [1], "the unmasked stacked pair must take the fused kernel"
    want = np.asarray(jnet.output(x), np.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, T, V)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # the pair's own output, layer 2's h, before the softmax evens it out
    with torch.inference_mode():
        h2 = net._fused_lstm_forward(torch.from_numpy(x), {}, 0).float().numpy()
    want_h2 = np.asarray(jnet.feed_forward_to_layer(1, x), np.float32)
    assert np.abs(want_h2).max() > 20 * ATOL
    np.testing.assert_allclose(h2, want_h2, rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind", ["binary", "fractional"])
def test_restored_output_matches_jax_masked_per_layer(jax_zip, monkeypatch, kind):
    jnet, path = jax_zip
    net = restore_multi_layer_network(path, device="cpu")
    calls = _spy_scan2(monkeypatch)
    x = _onehot(1)
    rng = np.random.default_rng(2)
    if kind == "binary":
        m = np.ones((B, T), np.float32)
        m[::2, T - 2:] = 0.0
    else:
        m = rng.uniform(0.0, 1.0, (B, T)).astype(np.float32)
    got = net.output(x, mask=m).numpy()
    assert not calls, "a masked batch must run the layers one by one (K1)"
    want = np.asarray(jnet.output(x, mask=m), np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_rnn_time_step_chunks_equal_full_output(jax_zip):
    jnet, path = jax_zip
    net = restore_multi_layer_network(path, device="cpu")
    x = _onehot(3)
    full = net.output(x)
    parts = [net.rnn_time_step(x[:, :2]), net.rnn_time_step(x[:, 2:3]),
             net.rnn_time_step(x[:, 3:])]
    torch.testing.assert_close(torch.cat(parts, 1), full, rtol=0, atol=1e-6)
    one = net.rnn_time_step(x[:, 0])              # a single [b, f] step
    assert tuple(one.shape) == (B, V)
    net.rnn_clear_previous_state()
    torch.testing.assert_close(net.rnn_time_step(x), full, rtol=0, atol=1e-6)
    # and against the JAX package's own streaming path
    jnet.rnn_clear_previous_state()
    jparts = [np.asarray(jnet.rnn_time_step(x[:, :2])),
              np.asarray(jnet.rnn_time_step(x[:, 2:]))]
    np.testing.assert_allclose(full.numpy(), np.concatenate(jparts, 1), rtol=0,
                               atol=ATOL)


def test_config_json_round_trips_and_params_carry_across(jax_zip):
    jnet, path = jax_zip
    with zipfile.ZipFile(path) as z:
        doc = json.loads(z.read("configuration.json"))
    conf = serde.decode(doc["config"])
    assert isinstance(conf, MultiLayerConfiguration)
    # the updater is carried as data and re-encodes to the same JSON
    assert serde.encode(conf) == doc["config"]
    arrays = {f"{i}/{k}": np.asarray(v) for i, p in jnet.params.items()
              for k, v in p.items()}
    net = MultiLayerNetwork(conf).init(params=params_from_numpy(conf, arrays),
                                       device="cpu")
    for i, p in jnet.params.items():
        for k, v in p.items():
            np.testing.assert_array_equal(net.params[i][k].numpy(), np.asarray(v))


def test_bf16_stored_parameters_decode():
    conf = serde.decode(json.loads(_jax_net().conf.to_json()))
    a = np.linspace(-2, 2, 4 * H, dtype=np.float32)
    bits = torch.from_numpy(a).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    out = params_from_numpy(conf, {"__bf16__0/b": bits})
    np.testing.assert_array_equal(out["0"]["b"].numpy(),
                                  torch.from_numpy(a).to(torch.bfloat16).float().numpy())


def test_unknown_config_class_fails_loudly():
    # every layer class of the JAX package now decodes: a name neither
    # package registers stands for one the port does not know
    doc = json.loads(_jax_net().conf.to_json())
    doc["layers"][0]["@class"] = "UnregisteredLayer"
    with pytest.raises(ValueError, match="Unknown config class 'UnregisteredLayer'"):
        serde.decode(doc)


def test_wrong_parameter_shape_is_refused():
    conf = serde.decode(json.loads(_jax_net().conf.to_json()))
    params = MultiLayerNetwork(conf).init(device="cpu").params
    params["1"]["RW"] = torch.zeros(H, H)
    with pytest.raises(ValueError, match="shape"):
        MultiLayerNetwork(conf).init(params=params, device="cpu")
