"""The rest of the recurrent family in a MultiLayerNetwork, against the JAX
package: GravesBidirectionalLSTM, SimpleRnn, Bidirectional(GravesLSTM),
LastTimeStep(LSTM) and LastTimeStep(Bidirectional(LSTM)).

Each case builds the JAX net from a seed, moves it to the port through the
model zip, and feeds both the same numpy batch (f32-representable values:
the port's DataSet holds floating data as f32), unmasked and with
right-padded masks (lengths 6, 4, 3, 5 of T = 6). Held: ``output``,
``score``, ``compute_gradient_and_score``'s gradients and score, and the
parameters after three Adam fit steps. On the CPU the LSTMs run the plain
versions of K1/K2 on the port's side and the ``lax.scan`` route on JAX's,
so the backward directions are the kernels' plain loops on time-reversed,
right-padded sequences (fully masked leading steps).

Tolerances, as max |port - jax| over max |jax|: float64 1e-10, float32
2e-5 (summation orders differ; measured <= 3e-15 in f64). The Adam steps
are exact in f64 once the bias corrections are the JAX package's f32
scalars (``nn/updaters.bias_correction``, ROADMAP C 6).
"""
import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu import Adam as JAdam
from deeplearning4j_tpu.compat import enable_x64
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.utils.model_serializer import ModelSerializer

from deeplearning4j_torch import DataSet
from deeplearning4j_torch.nn.layers.recurrent import BidirectionalImpl
from deeplearning4j_torch.utils.model_serializer import restore_model

TOL = {"float64": 1e-10, "float32": 2e-5}
B, T, F, H, C = 4, 6, 3, 5, 4
LENGTHS = np.array([6, 4, 3, 5])
LR = 1e-2
KINDS = ["graves_bidirectional", "simple_rnn", "bidirectional_graves", "last_time_step",
         "last_bidirectional"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def recurrent_layer(kind, mode="concat"):
    """(JAX layer config, its output width, whether it ends the sequence)."""
    if kind == "graves_bidirectional":
        return jl.GravesBidirectionalLSTM(n_in=F, n_out=H, activation="tanh"), H, False
    if kind == "simple_rnn":
        return jl.SimpleRnn(n_in=F, n_out=H, activation="tanh"), H, False
    if kind == "bidirectional_graves":
        inner = jl.GravesLSTM(n_in=F, n_out=H, activation="tanh")
        return jl.Bidirectional(inner=inner, mode=mode), 2 * H if mode == "concat" else H, False
    if kind == "last_time_step":
        return jl.LastTimeStep(inner=jl.LSTM(n_in=F, n_out=H, activation="tanh")), H, True
    inner = jl.Bidirectional(inner=jl.LSTM(n_in=F, n_out=H, activation="tanh"), mode="add")
    return jl.LastTimeStep(inner=inner), H, True


def jax_net(kind, dtype, mode="concat", seed=3):
    layer, width, last = recurrent_layer(kind, mode)
    out = (jl.OutputLayer if last else jl.RnnOutputLayer)(
        n_in=width, n_out=C, activation="softmax", loss="mcxent")
    conf = (JConf.builder().seed(seed).updater(JAdam(learning_rate=LR)).dtype(dtype)
            .compute_dtype(dtype).list().layer(layer).layer(out).build())
    net = JNet(conf).init()
    rng = np.random.default_rng(seed)
    # init draws zero peepholes: exercise them
    for key, p in net.params["0"].items():
        if isinstance(p, dict):
            for k in ("pi", "pf", "po"):
                if k in p:
                    p[k] = jax.numpy.asarray(0.3 * rng.standard_normal(H), dtype)
        elif key[:2] in ("pi", "pf", "po"):
            net.params["0"][key] = jax.numpy.asarray(0.3 * rng.standard_normal(H), dtype)
    return net, last


def batch(dtype, masked, last, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(B, T, F)).astype(np.float32).astype(dtype)
    if last:
        labels = np.eye(C, dtype=dtype)[rng.integers(0, C, B)]
    else:
        labels = np.eye(C, dtype=dtype)[rng.integers(0, C, (B, T))]
    fm = (np.arange(T)[None] < LENGTHS[:, None]).astype(dtype) if masked else None
    lm = None if last or not masked else fm
    return f, labels, fm, lm


def to_port(jnet, tmp_path, name="net.zip"):
    path = tmp_path / name
    ModelSerializer.write_model(jnet, str(path))
    return restore_model(str(path), device="cpu")


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def tree_errors(jtree, ptree):
    """{keypath: relative error} of every JAX leaf against the port's tensor
    at the same keys (dict keys, and tuple indices of updater state)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        keys = [str(k.key) if hasattr(k, "key") else k.idx for k in path]
        t = ptree
        for k in keys:
            t = t[k]
        out["/".join(map(str, keys))] = rel(t.detach().numpy(), leaf)
    return out


def assert_matches(net, jnet, arrays, tol, steps=3):
    f, labels, fm, lm = arrays
    assert rel(net.output(f, mask=fm).numpy(), jnet.output(f, mask=fm)) <= tol
    ds, jds = DataSet(f, labels, fm, lm), JDataSet(f, labels, fm, lm)
    assert rel(net.score(ds), jnet.score(jds)) <= tol
    grads, score = net.compute_gradient_and_score(ds)
    jgrads, jscore = jnet.compute_gradient_and_score(jds)
    assert rel(score, jscore) <= tol
    errs = tree_errors(jgrads, grads)
    assert len(errs) == sum(1 for _ in jax.tree_util.tree_leaves(jgrads))
    assert max(errs.values()) <= tol, errs
    for _ in range(steps):
        net.fit(ds)
        jnet.fit(jds)
    errs = tree_errors(jnet.params, net.params)
    assert max(errs.values()) <= tol, errs
    assert net.iteration_count == jnet.iteration_count == steps


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kind", KINDS)
def test_layer_matches_jax(kind, dtype, masked, tmp_path):
    with enable_x64(dtype == "float64"):
        jnet, last = jax_net(kind, dtype)
        net = to_port(jnet, tmp_path)
        assert net.num_params() == jnet.num_params()
        assert net.summary() == jnet.summary()
        assert_matches(net, jnet, batch(dtype, masked, last), TOL[dtype])


@pytest.mark.parametrize("mode", ["concat", "add", "mul", "ave"])
def test_bidirectional_modes_masked(mode, tmp_path):
    """Each merge mode, masked, in f64: output, gradients and Adam steps."""
    with enable_x64(True):
        jnet, _ = jax_net("bidirectional_graves", "float64", mode=mode)
        net = to_port(jnet, tmp_path)
        assert_matches(net, jnet, batch("float64", True, False), TOL["float64"], steps=1)


def test_unknown_bidirectional_mode_raises(tmp_path):
    with enable_x64(True):
        jnet, _ = jax_net("bidirectional_graves", "float64", mode="concat")
        net = to_port(jnet, tmp_path)
    net.conf.layers[0].mode = "max"
    with pytest.raises(ValueError, match="Unknown Bidirectional mode max"):
        net.output(batch("float64", False, False)[0])


def test_forward_last_is_each_directions_final_state(tmp_path):
    """LastTimeStep(Bidirectional(LSTM, add)) gives, with right-padded
    masks, the forward direction's output at each sequence's last valid
    step plus the backward direction's output after the whole reversed
    sequence (its t = 0 slot), not the merged sequence's last valid slot."""
    with enable_x64(True):
        jnet, _ = jax_net("last_bidirectional", "float64")
        net = to_port(jnet, tmp_path)
    f, _, fm, _ = batch("float64", True, True)
    x, m = torch.from_numpy(f.astype(np.float32)), torch.from_numpy(fm.astype(np.float32))
    bidi = net.impls[0].inner
    assert isinstance(bidi, BidirectionalImpl)
    with torch.no_grad():
        got = net.impls[0](x, mask=m, ctx={"train": False})
        yf = bidi.fwd(x, mask=m, ctx={"train": False})
        yb = bidi.bwd(x.flip(1), mask=m.flip(1), ctx={"train": False}).flip(1)
    rows = torch.arange(B)
    last = torch.from_numpy(LENGTHS - 1)
    want = yf[rows, last] + yb[:, 0]
    assert torch.equal(got, want)
    assert not torch.allclose(got, yf[rows, last] + yb[rows, last])
