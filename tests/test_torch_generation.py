"""Streaming generation on the CPU, against the JAX package.

A JAX ``TransformerLM`` (vocab 9, embed 16, 2 heads, 2 blocks) with its
weights perturbed from their init is written with ``ModelSerializer`` and
restored by the port on ``device="cpu"``; both then stream the same numpy
token ids through ``rnn_time_step`` (the KV cache): token by token, in
chunks, with a 4-slot cache that chunks roll past, with non-causal
attention, and, at the layer, with key-masked chunks. A ComputationGraph
with an LSTM vertex streams step by step. ``generate_tokens`` gives the
JAX package's greedy tokens for a TransformerLM and a TextGenerationLSTM.

Tolerances: f32, the same arithmetic in another summation order: rtol
2e-4, atol 2e-5 (the JAX package's own streaming test). bf16: the
activations, logits and attention operands round to bf16 at places where
the frameworks round differently, so an entry may move by a bf16 unit or
two: max |port - jax| <= 2e-2 of the largest |jax| entry.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu import Adam as JAdam
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import TextGenerationLSTM as JTextGenerationLSTM
from deeplearning4j_tpu.models import TransformerLM as JTransformerLM
from deeplearning4j_tpu.models import generate_tokens as jgenerate_tokens
from deeplearning4j_tpu.models.zoo import ZOO as JZOO
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.conf.layers import LSTM as JLSTM
from deeplearning4j_tpu.nn.conf.layers import RnnOutputLayer as JRnnOutputLayer
from deeplearning4j_tpu.nn.conf.layers import SelfAttentionLayer as JSelfAttentionLayer
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.utils.model_serializer import ModelSerializer as JSerializer

from deeplearning4j_torch import DataSet
from deeplearning4j_torch.models import (ModelSelector, TextGenerationLSTM, TransformerLM,
                                         ZOO, generate_tokens)
from deeplearning4j_torch.serving import ServedModel
from deeplearning4j_torch.utils.model_serializer import restore_model

V, E, HEADS, BLOCKS, B = 9, 16, 2, 2, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _perturbed(jnet, seed):
    """Weights moved off their init, so that LayerNorm gains and biases
    are not trivially 1 and 0."""
    rng = np.random.default_rng(seed)
    jnet.params = jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(0.05 * rng.standard_normal(p.shape), p.dtype), jnet.params)
    return jnet


def _jax_lm(compute="float32", window=512, causal=True, seed=3):
    conf = JTransformerLM(vocab_size=V, embed_dim=E, num_heads=HEADS, num_blocks=BLOCKS,
                          seed=seed).conf()
    conf.global_conf.compute_dtype = compute
    for v in conf.vertices.values():
        if type(v).__name__ == "SelfAttentionLayer":
            v.stream_max_length, v.causal = window, causal
    return _perturbed(JGraph(conf).init(), seed)


def _port(jnet, tmp_path, name="m.zip"):
    path = tmp_path / name
    JSerializer.write_model(jnet, str(path))
    return restore_model(path, device="cpu")


def _ids(seed, T, b=B):
    return np.random.default_rng(seed).integers(0, V, (b, T)).astype(np.float32)


def _stream(net, ids, chunks, to_numpy):
    """rnn_time_step over ``ids`` [b, T] in chunks of the given lengths
    (a chunk of 1 as the one-step input [b, 1]) -> [b, T, V]."""
    net.rnn_clear_previous_state()
    outs, t = [], 0
    for n in chunks:
        if n == 1:
            outs.append(to_numpy(net.rnn_time_step(ids[:, t:t + 1]))[:, None])
        else:
            outs.append(to_numpy(net.rnn_time_step(ids[:, t:t + n, None])))
        t += n
    assert t == ids.shape[1]
    return np.concatenate(outs, axis=1)


def _port_np(y):
    return y.float().numpy()


def _jax_np(y):
    return np.asarray(y, np.float32)


def _close(got, want, compute):
    if compute == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    else:
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel <= 2e-2, rel


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_stream_matches_jax_past_the_window(tmp_path, compute, causal):
    """A 4-slot cache: 10 tokens token by token and in chunks of 3, 1, 4
    and 2 (the chunk of 4 rolls the whole buffer), in both packages. For
    causal attention chunked streaming equals token-by-token streaming
    (each query sees the keys at (p - 4, p])."""
    jnet = _jax_lm(compute, window=4, causal=causal)
    net = _port(jnet, tmp_path)
    ids = _ids(1, 10)
    for chunks in ([1] * 10, [3, 1, 4, 2]):
        got = _stream(net, ids, chunks, _port_np)
        assert got.shape == (B, 10, V) and np.isfinite(got).all()
        _close(got, _stream(jnet, ids, chunks, _jax_np), compute)
    if causal:
        _close(_stream(net, ids, [3, 1, 4, 2], _port_np), _stream(net, ids, [1] * 10, _port_np),
               compute)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_key_masked_chunks_match_jax(tmp_path, compute):
    """The attention layer alone, streamed over three chunks with a 4-slot
    cache and per-example key masks: masked tokens advance time but are
    never visible, and a query with no visible key outputs exactly 0
    before the output projection (its row is the bias)."""
    jnet = _jax_lm(compute, window=4)
    net = _port(jnet, tmp_path)
    name = "b0-attn"
    jimpl, impl = jnet.impls[name], net.impls[name]
    rng = np.random.default_rng(4)
    xs = [rng.standard_normal((B, n, E)).astype(np.float32) for n in (3, 2, 3)]
    masks = [np.array([[1, 0, 1], [0, 0, 1]], np.float32), np.array([[0, 1], [1, 1]], np.float32),
             np.array([[1, 1, 0], [0, 1, 1]], np.float32)]
    jcarry, carry = jimpl.init_stream_state(B), impl.init_stream_state(B, "cpu")
    cd = jnp.bfloat16 if compute == "bfloat16" else jnp.float32
    for x, m in zip(xs, masks):
        jctx = {"rnn_state_in": {name: jcarry}}
        jy, _ = jimpl.forward(jnet.params[name], jnet.states[name], jnp.asarray(x, cd),
                              mask=jnp.asarray(m), ctx=jctx)
        jcarry = jctx["rnn_state_out"][name]
        ctx = {"rnn_state_in": {name: carry}}
        with torch.inference_mode():
            y = impl(torch.from_numpy(x).to(impl.compute_dtype), mask=torch.from_numpy(m),
                     ctx=ctx)
        carry = ctx["rnn_state_out"][name]
        _close(_port_np(y), _jax_np(jy), compute)
        assert carry[3] == int(jcarry[3])
        np.testing.assert_array_equal(carry[2].numpy(), np.asarray(jcarry[2]))
    # example 1's first query (its key masked, nothing cached) sees no key
    with torch.inference_mode():
        first = impl(torch.from_numpy(xs[0]).to(impl.compute_dtype),
                     mask=torch.from_numpy(masks[0]),
                     ctx={"rnn_state_in": {name: impl.init_stream_state(B, "cpu")}})
    np.testing.assert_array_equal(first[1, 0].float().numpy(),
                                  impl.b.detach().to(first.dtype).float().numpy())


def test_chunk_longer_than_the_window_raises(tmp_path):
    net = _port(_jax_lm(window=4), tmp_path)
    with pytest.raises(ValueError, match="exceeds stream_max_length=4"):
        net.rnn_time_step(_ids(2, 5)[:, :, None])


def test_stepped_matches_the_full_output():
    """Token by token through the 512-slot cache reproduces the full causal
    ``output`` (the JAX package's tests/test_zoo.py:247-268, in the port)."""
    net = TransformerLM(vocab_size=V, embed_dim=E, num_heads=HEADS, num_blocks=BLOCKS,
                        seed=13).init(device="cpu")
    ids = _ids(2, 7)
    full = net.output(ids).numpy()
    net.rnn_clear_previous_state()
    steps = [net.rnn_time_step(ids[:, t:t + 1]) for t in range(7)]
    assert all(tuple(s.shape) == (B, V) for s in steps)
    np.testing.assert_allclose(np.stack([s.numpy() for s in steps], 1), full, rtol=2e-4,
                               atol=2e-5)
    # a chunk after the steps continues the same stream
    more = _ids(3, 4)
    both = np.concatenate([ids, more], 1)
    tail = net.rnn_time_step(more[:, :, None]).numpy()
    np.testing.assert_allclose(tail, net.output(both).numpy()[:, 7:], rtol=2e-4, atol=2e-5)


def test_graph_with_an_lstm_vertex_streams_like_jax(tmp_path):
    """The streaming half of the JAX package's tests/test_computation_graph.py
    :325: a ComputationGraph LSTM -> RnnOutputLayer stepped with [b, f]
    inputs equals its full ``output`` and the JAX package's steps."""
    jconf = (JConf.builder().seed(3).graph_builder().add_inputs("in")
             .add_layer("lstm", JLSTM(n_in=5, n_out=8, activation="tanh"), "in")
             .add_layer("out", JRnnOutputLayer(n_in=8, n_out=3, activation="softmax",
                                               loss="mcxent"), "lstm")
             .set_outputs("out").build())
    jnet = _perturbed(JGraph(jconf).init(), 3)
    net = _port(jnet, tmp_path)
    f = np.random.default_rng(0).normal(size=(2, 12, 5)).astype(np.float32)
    steps = np.stack([net.rnn_time_step(f[:, t]).numpy() for t in range(12)], 1)
    jsteps = np.stack([np.asarray(jnet.rnn_time_step(f[:, t])) for t in range(12)], 1)
    np.testing.assert_allclose(steps, net.output(f).numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(steps, jsteps, rtol=2e-4, atol=2e-5)
    net.rnn_clear_previous_state()
    assert net._rnn_state is None


@pytest.mark.parametrize("t", [12, 10])
def test_attention_tbptt_fit_carries_the_kv_cache_like_jax(tmp_path, t):
    """A MultiLayerNetwork SelfAttentionLayer -> RnnOutputLayer fit under
    TBPTT (segments of 4; T=12 even, T=10 with a ragged tail) carries the
    KV cache, counter included, across segments with the gradient cut, as
    the JAX package does: the score and the parameters after the fit agree
    in f32 (rtol 2e-4, atol 2e-5)."""
    jconf = (JConf.builder().seed(4).updater(JAdam(learning_rate=1e-2)).list()
             .layer(JSelfAttentionLayer(n_in=5, n_out=8, num_heads=2, stream_max_length=6))
             .layer(JRnnOutputLayer(n_in=8, n_out=3, activation="softmax", loss="mcxent"))
             .backprop_type("tbptt").t_bptt_forward_length(4).t_bptt_backward_length(4)
             .build())
    jnet = _perturbed(JNet(jconf).init(), 4)
    net = _port(jnet, tmp_path)
    rng = np.random.default_rng(6)
    f = rng.normal(size=(B, t, 5)).astype(np.float32)
    lab = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (B, t))]
    jnet.fit(JDataSet(f, lab))
    net.fit(DataSet(f, lab))
    assert net.iteration_count == jnet.iteration_count == -(-t // 4)
    np.testing.assert_allclose(float(net.score_), float(jnet.score_), rtol=2e-4, atol=2e-5)
    for i, p in jnet.params.items():
        for k, w in p.items():
            np.testing.assert_allclose(net.params[i][k].detach().numpy(), np.asarray(w),
                                       rtol=2e-4, atol=2e-5, err_msg=f"{i}/{k}")


def _jax_char_rnn(seed=5):
    jconf = JTextGenerationLSTM(total_unique_characters=V, lstm_size=16, seed=seed).conf()
    return _perturbed(JNet(jconf).init(), seed)


@pytest.mark.parametrize("family", ["transformer", "lstm"])
def test_generate_tokens_greedy_matches_jax(tmp_path, family):
    """At temperature 1e-4 sampling is the argmax: the port's tokens are the
    JAX package's, from a 3-token prompt for 6 tokens."""
    jnet = _jax_lm() if family == "transformer" else _jax_char_rnn()
    net = _port(jnet, tmp_path)
    prompt = np.array([[1, 2, 3], [4, 5, 6]])
    got = generate_tokens(net, prompt, 6, temperature=1e-4, seed=1)
    assert got.dtype == np.int64 and got.shape == (2, 6)
    np.testing.assert_array_equal(got, jgenerate_tokens(jnet, prompt, 6, temperature=1e-4,
                                                        seed=1))
    np.testing.assert_array_equal(got, generate_tokens(net, prompt, 6, temperature=1e-4,
                                                       seed=99))


def test_generate_tokens_deterministic_per_seed():
    """Both families (the tests/test_zoo.py:271-306 checks, in the port)."""
    lm = TransformerLM(vocab_size=V, embed_dim=E, num_heads=HEADS, num_blocks=BLOCKS,
                       seed=2).init(device="cpu")
    lstm = ModelSelector.select("textgenlstm", total_unique_characters=V,
                                lstm_size=16).init(device="cpu")
    prompt = np.array([[1, 2, 3], [4, 5, 6]])
    for net in (lm, lstm):
        a = generate_tokens(net, prompt, 5, seed=7)
        assert a.shape == (2, 5) and (0 <= a).all() and (a < V).all()
        np.testing.assert_array_equal(a, generate_tokens(net, prompt, 5, seed=7))
        assert (a != generate_tokens(net, prompt, 5, seed=8)).any()
    one = generate_tokens(lm, [1, 2], 3, seed=7)          # a [T] prompt is one row
    assert one.shape == (1, 3)


def test_generate_tokens_degenerate_sizes():
    net = TransformerLM(vocab_size=7, embed_dim=16, num_heads=2, num_blocks=2,
                        seed=4).init(device="cpu")
    with pytest.raises(ValueError, match="non-empty prompt"):
        generate_tokens(net, np.zeros((2, 0)), 4)
    out = generate_tokens(net, np.array([[1, 2]]), 0)
    assert out.shape == (1, 0) and out.dtype == np.int64


def test_generate_tokens_advances_state_past_last_token():
    """After generate_tokens (advance_state=True), rnn_time_step continues
    from the whole returned sequence; with advance_state=False it is one
    token behind."""
    net = TransformerLM(vocab_size=V, embed_dim=E, num_heads=HEADS, num_blocks=BLOCKS,
                        seed=3).init(device="cpu")
    prompt = np.array([[1, 2, 3]])
    probe = np.array([[2.0]])
    gen = generate_tokens(net, prompt, 4, seed=11)
    cont = net.rnn_time_step(probe).numpy()
    net.rnn_clear_previous_state()
    full = np.concatenate([prompt, gen], axis=1).astype(np.float32)
    net.rnn_time_step(full[:, :, None])
    want = net.rnn_time_step(probe).numpy()
    np.testing.assert_allclose(cont, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(generate_tokens(net, prompt, 4, seed=11,
                                                  advance_state=False), gen)
    behind = net.rnn_time_step(probe).numpy()
    assert np.abs(behind - want).max() > 1e-4


def test_model_selector_knows_every_jax_name():
    """Every JAX zoo name selects its model, which builds the JAX model's
    configuration (its JSON, byte for byte)."""
    assert set(ZOO) == set(JZOO)
    for name in JZOO:
        model = ModelSelector.select(name)
        assert model.name == name
        assert model.conf().to_json() == JZOO[name]().conf().to_json(), name
    with pytest.raises(ValueError, match="Unknown zoo model"):
        ModelSelector.select("nosuchmodel")
    m = ModelSelector.select("TextGenLSTM")
    assert isinstance(m, TextGenerationLSTM) and m.num_classes == 47 and m.lstm_size == 256
    with pytest.raises(ValueError, match="num_layers"):
        TextGenerationLSTM(num_layers=1)


def test_text_generation_lstm_config_matches_jax():
    """The port's TextGenerationLSTM writes the JAX package's configuration
    JSON, byte for byte."""
    for kw in ({}, {"total_unique_characters": V, "lstm_size": 16, "num_layers": 3}):
        assert TextGenerationLSTM(**kw).conf().to_json() == \
            JTextGenerationLSTM(**kw).conf().to_json()


def test_served_zoo_model_is_built_on_the_device():
    """A ZooModel registers un-built: ServedModel initialises it on its
    device, and it answers as its output does."""
    sm = ServedModel("textgen", TextGenerationLSTM(total_unique_characters=V, lstm_size=16),
                     device="cpu")
    try:
        assert sm.model.device.type == "cpu"
        x = np.eye(V, dtype=np.float32)[np.random.default_rng(0).integers(0, V, (3, 5))]
        np.testing.assert_allclose(np.asarray(sm.predict(x)), sm.model.output(x).numpy(),
                                   rtol=0, atol=1e-6)
    finally:
        sm.close()
    with pytest.raises(TypeError, match="no callable output"):
        ServedModel("bad", object(), device="cpu")
