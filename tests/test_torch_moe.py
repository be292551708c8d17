"""The MoE slice on the CPU, against the JAX package.

Case for case the JAX package's ``tests/test_moe.py`` that needs no mesh:
routing, tied probabilities, the dense combine, the auxiliary loss in the
objective, gradients (f64, against ``jax.grad``), training, serde, MoE in
a ComputationGraph, capacity dispatch against the dense oracle (values and
gradients), overflow, groups, tail padding, exact inference routing and
bad configurations. The two expert-parallel cases
(``test_expert_parallel_matches_replicated_training``,
``test_moe_sparse_expert_parallel_matches_replicated``) wait for the
port's expert sharding (ROADMAP Queue A 14). Each network is built in the
JAX package and carried to the port through its JSON and its numpy
weights (or a model zip), so both hold the same weights.

Then the MoE TransformerLM (2 blocks, embed 32, 4 experts, top 2),
restored from a JAX zip: output, score with the auxiliary loss, gradients
and three Adam steps on the dense attention route (T=64) and the flash
route (T=256, both packages' short-sequence seams flipped), in f32 and
bf16; ``rnn_time_step`` and ``generate_tokens``; zips both ways.

Tolerances:
- f64: 1e-10 relative to the largest entry (the same arithmetic).
- f32: the same arithmetic in another summation order: values rtol 2e-4
  / atol 2e-5; the LM as ``tests/test_torch_graph.py`` holds the dense
  LM (outputs 1e-5, scores 1e-5 relative, gradients 1e-4 of their largest
  entry, parameters after three Adam steps 1e-5).
- bf16: the router runs in f32 on a bf16 LayerNorm output, which can
  differ by one bf16 unit between the packages, so a near tie between two
  experts can send a token elsewhere and move its output far beyond
  bf16's rounding. The bf16 LM cases therefore pin the routing first, as
  ``utils/kink_pins.py`` pins ReLU kinks for ResNet50: the port records
  each MoE layer's kept experts a forward, and JAX replays them through a
  host callback (``_RoutePins``). They also run at capacity factor E/k,
  where no assignment can drop: which of a token's two gates ranks first
  decides drops, and two nearly equal gates may rank differently in the
  two packages. With that the bf16 limits are the dense LM's (outputs
  3e-2, scores 2e-3 relative, gradients 3e-2, parameters 2 x lr x steps).
  The f32 cases run at the model's capacity factor of 1.25, unpinned.
"""
import re

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.ops.flash_attention as jfa
from deeplearning4j_tpu import Adam as JAdam
from deeplearning4j_tpu import Sgd as JSgd
from deeplearning4j_tpu.compat import enable_x64
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import TransformerLM as JTransformerLM
from deeplearning4j_tpu.models.zoo import generate_tokens as jgenerate_tokens
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.conf.layers import MoEDenseLayer as JMoE
from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JOutputLayer
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.utils.model_serializer import ModelSerializer as JSerializer

from deeplearning4j_torch import DataSet
from deeplearning4j_torch.models import TransformerLM, generate_tokens
from deeplearning4j_torch.nn.conf import ComputationGraphConfiguration, MultiLayerConfiguration
from deeplearning4j_torch.nn.graph import ComputationGraph
from deeplearning4j_torch.nn.layers.moe import MoEDenseImpl
from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_torch.ops import flash_attention as fa
from deeplearning4j_torch.utils.model_serializer import restore_model, write_model

V, E_LM, HEADS, BLOCKS, EXPERTS, B = 12, 32, 2, 2, 4, 2
LR = 1e-3
OUT_ATOL = {"float32": 1e-5, "bfloat16": 3e-2}
SCORE_RTOL = {"float32": 1e-5, "bfloat16": 2e-3}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _jconf(n_in=6, n_out=8, experts=4, top_k=2, aux=0.0, seed=5, updater=None, cf=0.0,
           act="relu", dtype=None, n_classes=4, iterations=None):
    b = JConf.builder().seed(seed).updater(updater or JSgd(learning_rate=0.1))
    if dtype is not None:
        b = b.dtype(dtype).compute_dtype(dtype)
    if iterations is not None:
        b = b.iterations(iterations)
    return (b.activation("identity").list()
            .layer(JMoE(n_in=n_in, n_out=n_out, num_experts=experts, top_k=top_k,
                        aux_loss_weight=aux, capacity_factor=cf, activation=act))
            .layer(JOutputLayer(n_in=n_out, n_out=n_classes, activation="softmax",
                                loss="mcxent"))
            .build())


def _numpy_params(params):
    return {k: {n: np.array(v) for n, v in d.items()} for k, d in params.items()}


def _pair(jconf, graph=False):
    """(JAX net, port net on the CPU) from one configuration, same weights."""
    jnet = (JGraph if graph else JNet)(jconf).init()
    conf = (ComputationGraphConfiguration if graph else MultiLayerConfiguration).from_json(
        jconf.to_json())
    net = (ComputationGraph if graph else MultiLayerNetwork)(conf).init(
        params=_numpy_params(jnet.params), device="cpu")
    return jnet, net


def _x(seed, n, f=6):
    return np.random.default_rng(seed).normal(size=(n, f)).astype(np.float32)


def _close(got, want, rtol=2e-4, atol=2e-5):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float64), rtol=rtol, atol=atol)


def _rel(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _impls(cf, top_k=2, experts=4, n_in=6, n_out=8, seed=5, group_size=None):
    """(port impl with ``cf``, port impl at cf 0, JAX impl with ``cf``,
    JAX params), one set of weights: ``test_moe.py``'s ``_moe_impl``."""
    jnet, net = _pair(_jconf(n_in, n_out, experts, top_k, cf=cf, seed=seed, act="identity"))
    dense = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _jconf(n_in, n_out, experts, top_k, cf=0.0, seed=seed, act="identity").to_json())
    ).init(params=_numpy_params(jnet.params), device="cpu")
    if group_size is not None:
        net.impls[0].conf.group_size = jnet.impls[0].conf.group_size = group_size
    return net.impls[0], dense.impls[0], jnet.impls[0], jnet.params["0"]


def _train_fwd(impl, x):
    return impl(torch.as_tensor(x), ctx={"train": True})


def test_moe_forward_topk_routing_semantics():
    jnet, net = _pair(_jconf())
    x = _x(0, 7)
    gates, probs = net.impls[0]._route(torch.as_tensor(x), net.impls[0].Wg)
    g = gates.detach().numpy()
    assert (np.count_nonzero(g, axis=1) == 2).all()
    np.testing.assert_allclose(g.sum(axis=1), 1.0, rtol=1e-5)
    pr = probs.detach().numpy()
    for i in range(g.shape[0]):
        assert set(np.nonzero(g[i])[0]) == set(np.argsort(pr[i])[-2:])
    jg, jp = jnet.impls[0]._route(jnp.asarray(x), jnet.params["0"]["Wg"])
    _close(gates, jg, 1e-6, 1e-7)
    _close(probs, jp, 1e-6, 1e-7)


def test_moe_topk_exact_on_tied_probs():
    """An all-zero row gives a uniform softmax: exactly top_k experts are
    gated, the lower indices first (``jax.lax.top_k``'s order), so the
    gates are JAX's bit for bit."""
    jnet, net = _pair(_jconf())
    gates, _ = net.impls[0]._route(torch.zeros(3, 6), net.impls[0].Wg)
    g = gates.detach().numpy()
    assert (np.count_nonzero(g, axis=1) == 2).all()
    np.testing.assert_array_equal(g[:, :2], 0.5)
    jg, _ = jnet.impls[0]._route(jnp.zeros((3, 6)), jnet.params["0"]["Wg"])
    np.testing.assert_array_equal(g, np.asarray(jg))


def test_moe_output_matches_manual_dense_dispatch():
    jnet, net = _pair(_jconf(top_k=4))      # top_k == E: the gates are the softmax
    x = _x(1, 5)
    y = net.impls[0](torch.as_tensor(x), ctx={})
    p = _numpy_params(jnet.params)["0"]
    logits = x @ p["Wg"]
    probs = np.exp(logits - logits.max(1, keepdims=True))
    probs /= probs.sum(1, keepdims=True)
    want = sum(probs[:, e:e + 1] * (x @ p["W"][e] + p["b"][e]) for e in range(4))
    _close(y, np.maximum(want, 0.0), 1e-4, 1e-5)
    _close(y, jnet.impls[0].forward(jnet.params["0"], {}, jnp.asarray(x))[0])


def test_moe_aux_loss_enters_objective():
    rng = np.random.default_rng(2)
    f = rng.normal(size=(16, 6)).astype(np.float32)
    l = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 16)]
    scores = {}
    for aux in (0.0, 10.0):
        jnet, net = _pair(_jconf(aux=aux))
        scores[aux] = net.score(DataSet(f, l))
        assert scores[aux] == pytest.approx(float(jnet.score(JDataSet(f, l))), rel=1e-6)
    assert scores[10.0] > scores[0.0] + 0.1


def _f64_pair(top_k, aux, seed=9):
    return _pair(_jconf(top_k=top_k, aux=aux, seed=seed, dtype="float64", act="tanh",
                        updater=JSgd(learning_rate=1.0)))


def _f64_data():
    """f32 values (the port's DataSet holds floating data in f32), which
    both packages then compute on in f64."""
    rng = np.random.default_rng(3)
    return (rng.normal(size=(8, 6)).astype(np.float32),
            np.eye(4, dtype=np.float32)[rng.integers(0, 4, 8)])


@pytest.mark.parametrize("top_k,aux", [(4, 0.0), (2, 1e-2)])
def test_moe_gradients_match_jax_grad_in_f64(top_k, aux):
    """``test_moe_gradient_check_dense_routing`` (top_k == E) and
    ``..._topk_experts`` (top_k < E with the auxiliary loss): every
    parameter's gradient, the router's included, is ``jax.grad``'s at
    1e-10 of its largest entry. (The JAX package's central differences
    exclude the router at top_k < E, where the gate support jumps; the
    analytic gradient on a fixed routing is well defined.)"""
    f, l = _f64_data()
    with enable_x64(True):
        jnet, net = _f64_pair(top_k, aux)
        jg, js = jnet.compute_gradient_and_score(JDataSet(f, l))
        jg = _numpy_params(jg)
    g, s = net.compute_gradient_and_score(DataSet(f, l))
    assert net.params["0"]["W"].dtype == torch.float64
    assert s == pytest.approx(float(js), rel=1e-12)
    for k, gs in jg.items():
        for n, want in gs.items():
            assert _rel(g[k][n], want) <= 1e-10, (k, n)


def test_moe_trains_and_improves():
    rng = np.random.default_rng(4)
    f = rng.normal(size=(64, 6)).astype(np.float32)
    l = np.eye(4, dtype=np.float32)[(f[:, 0] + f[:, 1] > 0).astype(int)]
    jnet, net = _pair(_jconf(aux=1e-2, updater=JAdam(learning_rate=5e-3)))
    ds, jds = DataSet(f, l), JDataSet(f, l)
    s0 = net.score(ds)
    for _ in range(60):
        net.fit(ds)
        jnet.fit(jds)
    assert net.score(ds) < s0 * 0.6
    assert net.score(ds) == pytest.approx(float(jnet.score(jds)), rel=1e-3)


def test_moe_and_iterations_serde_round_trip(tmp_path):
    """A JAX-written MoE configuration with ``iterations(4)`` decodes and
    re-encodes byte for byte; a fit takes 4 iterations; the port's zip
    restores bit-equal in the port and in the JAX package, and a JAX zip
    restores bit-equal in the port, Adam moments included."""
    jconf = _jconf(aux=0.01, updater=JAdam(learning_rate=1e-3), act="relu", iterations=4,
                   seed=3, n_classes=3)
    text = jconf.to_json()
    conf = MultiLayerConfiguration.from_json(text)
    assert conf.to_json() == text
    l0 = conf.layers[0]
    assert (type(l0).__name__, l0.num_experts, l0.top_k, conf.global_conf.iterations) \
        == ("MoEDenseLayer", 4, 2, 4)
    jnet, net = _pair(jconf)
    rng = np.random.default_rng(0)
    f = rng.normal(size=(8, 6)).astype(np.float32)
    l = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    net.fit(DataSet(f, l))
    jnet.fit(JDataSet(f, l))
    assert net.iteration_count == jnet.iteration_count == 4
    write_model(net, tmp_path / "port.zip")
    back = restore_model(tmp_path / "port.zip", device="cpu")
    jback = JSerializer.restore_multi_layer_network(str(tmp_path / "port.zip"))
    JSerializer.write_model(jnet, str(tmp_path / "jax.zip"))
    from_jax = restore_model(tmp_path / "jax.zip", device="cpu")
    for k, ps in net.params.items():
        for n, p in ps.items():
            assert torch.equal(back.params[k][n], p)
            np.testing.assert_array_equal(np.asarray(jback.params[k][n]), p.numpy())
            np.testing.assert_array_equal(from_jax.params[k][n].numpy(),
                                          np.asarray(jnet.params[k][n]))
            for slot, m in zip(from_jax.updater_state[k][n], jnet.updater_state[k][n]):
                np.testing.assert_array_equal(slot.numpy(), np.asarray(m))


def _moe_graph(aux):
    g = (JConf.builder().seed(11).updater(JSgd(learning_rate=0.1)).activation("identity")
         .graph_builder().add_inputs("in"))
    g.add_layer("moe", JMoE(n_in=6, n_out=8, num_experts=4, top_k=2, aux_loss_weight=aux,
                            activation="relu"), "in")
    g.add_layer("out", JOutputLayer(n_in=8, n_out=3, activation="softmax", loss="mcxent"),
                "moe")
    g.set_outputs("out")
    return _pair(g.build(), graph=True)


def test_moe_in_computation_graph_aux_loss_and_training():
    """The auxiliary loss reaches the graph's objective and the graph
    trains; the scores and parameters follow the JAX package's."""
    rng = np.random.default_rng(8)
    f = rng.normal(size=(16, 6)).astype(np.float32)
    l = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    ds, jds = DataSet(f, l), JDataSet(f, l)
    (j0, net0), (j1, net1) = _moe_graph(0.0), _moe_graph(10.0)
    assert net1.score(ds) > net0.score(ds) + 0.1
    assert net1.score(ds) == pytest.approx(float(j1.score(jds)), rel=1e-6)
    s0 = net0.score(ds)
    for _ in range(30):
        net0.fit(ds)
        j0.fit(jds)
    assert net0.score(ds) < s0
    assert net0.score(ds) == pytest.approx(float(j0.score(jds)), rel=1e-5)
    for n, p in _numpy_params(j0.params)["moe"].items():
        _close(net0.params["moe"][n], p, 1e-4, 1e-5)


def test_moe_sparse_dispatch_matches_dense_oracle():
    """Ample capacity: the dispatch equals the dense combine, and JAX's
    dispatch (odd n on purpose)."""
    impl_s, impl_d, jimpl, jp = _impls(4.0)
    x = _x(7, 33)
    ys = _train_fwd(impl_s, x)
    _close(ys, impl_d(torch.as_tensor(x)).detach(), 1e-4, 1e-5)
    _close(ys, jimpl.forward(jp, {}, jnp.asarray(x), train=True)[0])


def test_moe_sparse_dispatch_grads_match_dense_oracle():
    impl_s, impl_d, jimpl, jp = _impls(4.0)
    x = _x(9, 16)
    gs = torch.autograd.grad((_train_fwd(impl_s, x) ** 2).sum(), list(impl_s.param_dict().values()))
    gd = torch.autograd.grad((_train_fwd(impl_d, x) ** 2).sum(), list(impl_d.param_dict().values()))
    jg = jax.grad(lambda p: jnp.sum(jimpl.forward(p, {}, jnp.asarray(x), train=True)[0] ** 2))(jp)
    for k, a, b in zip(impl_s.param_dict(), gs, gd):
        _close(a, b.detach(), 1e-3, 1e-4)
        _close(a, jg[k])


def test_moe_sparse_overflow_drops_lowest_gate_assignments():
    """At a tiny capacity every expert keeps only its first C slot-major
    assignments: the output is finite, bounded, differs from dense, and
    drops what JAX's dispatch drops."""
    impl_s, impl_d, jimpl, jp = _impls(1e-6)
    x = _x(11, 64)
    ys, yd = _train_fwd(impl_s, x).detach(), impl_d(torch.as_tensor(x)).detach()
    assert torch.isfinite(ys).all()
    assert ys.abs().max() <= yd.abs().max() * 2 + 1.0
    assert (ys - yd).abs().max() > 0
    _close(ys, jimpl.forward(jp, {}, jnp.asarray(x), train=True)[0])


def test_moe_sparse_dispatch_flops_drop():
    """The dispatch's matmul FLOPs (torch's FlopCounterMode over the
    forward) drop about E/k-fold against the dense combine, as XLA's cost
    analysis shows for the JAX package (E=8, k=1, n=128, F=O=1024)."""
    Ex, k, n, F = 8, 1, 128, 1024
    impl_s, impl_d, _, _ = _impls(1.0, top_k=k, experts=Ex, n_in=F, n_out=F)
    x = _x(13, n, F)

    def flops(impl):
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            _train_fwd(impl, x)
        return counter.get_total_flops()

    fd, fs = flops(impl_d), flops(impl_s)
    assert fd > 0 and fs > 0
    assert fs < fd / (Ex / k) * 2.0, (fd, fs)
    assert fd / fs > Ex / k / 2, (fd, fs)


def test_moe_inference_routes_exactly_despite_capacity():
    impl_s, impl_d, _, _ = _impls(1e-6)
    x = torch.as_tensor(_x(15, 32))
    y_inf = impl_s(x, ctx={"train": False}).detach()
    _close(y_inf, impl_d(x).detach(), 1e-5, 1e-6)
    assert (_train_fwd(impl_s, x.numpy()).detach() - y_inf).abs().max() > 1e-3


def test_moe_rejects_bad_routing_config():
    """top_k outside [1, num_experts] or a negative capacity factor raise
    at init, as in the JAX package."""
    def build(**kw):
        conf = _jconf(n_in=4, n_out=4, seed=1, n_classes=2)
        for k, v in kw.items():
            setattr(conf.layers[0], k, v)
        return MultiLayerNetwork(MultiLayerConfiguration.from_json(conf.to_json())).init(
            device="cpu")

    with pytest.raises(ValueError, match="top_k"):
        build(num_experts=4, top_k=0)
    with pytest.raises(ValueError, match="top_k"):
        build(num_experts=4, top_k=5)
    with pytest.raises(ValueError, match="capacity_factor"):
        build(num_experts=4, top_k=2, capacity_factor=-1.0)


def test_moe_sparse_grouped_dispatch_matches_dense():
    """Three full groups of 16 and a 5-token tail: ample capacity gives
    the dense answer for every token, and JAX's."""
    impl_s, impl_d, jimpl, jp = _impls(4.0, group_size=16)
    x = _x(13, 53)
    ys = _train_fwd(impl_s, x)
    assert ys.shape == (53, 8)
    _close(ys, impl_d(torch.as_tensor(x)).detach(), 1e-4, 1e-5)
    _close(ys, jimpl.forward(jp, {}, jnp.asarray(x), train=True)[0])


def test_moe_sparse_tail_padding_claims_no_capacity():
    """At tight capacity a 3-token tail group padded to 32 treats its
    tokens as a group of those 3 tokens alone: the padding claims no
    slot."""
    impl_s, _, jimpl, jp = _impls(1.0, group_size=32)
    x_main, x_tail = _x(17, 32), _x(18, 3)
    joint = _train_fwd(impl_s, np.concatenate([x_main, x_tail]))
    _close(joint[32:], _train_fwd(impl_s, x_tail).detach(), 1e-4, 1e-5)
    _close(joint, jimpl.forward(jp, {}, jnp.concatenate([x_main, x_tail]), train=True)[0])


class _LargestTensor(TorchDispatchMode):
    """The element count of the largest tensor any operation makes."""

    def __init__(self):
        super().__init__()
        self.worst = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else [out]):
            if isinstance(t, torch.Tensor):
                self.worst = max(self.worst, t.numel())
        return out


def test_moe_sparse_dispatch_memory_linear_in_tokens():
    """The dispatch's intermediates grow with n x G, not n^2: twice the
    tokens make no tensor 4x larger."""
    def worst(n):
        impl_s, _, _, _ = _impls(1.25, group_size=64)
        with _LargestTensor() as mode, torch.no_grad():
            _train_fwd(impl_s, np.zeros((n, 6), np.float32))
        return mode.worst

    m1, m2 = worst(256), worst(512)
    assert m2 <= m1 * 2.5, (m1, m2)


# ------------------------------------------------------------ the MoE LM
def _jax_lm(compute, cf=1.25, seed=3):
    conf = JTransformerLM(vocab_size=V, embed_dim=E_LM, num_heads=HEADS, num_blocks=BLOCKS,
                          num_experts=EXPERTS, top_k=2, capacity_factor=cf, seed=seed).conf()
    conf.global_conf.compute_dtype = compute
    jnet = JGraph(conf).init()
    rng = np.random.default_rng(seed)
    jnet.params = jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(0.05 * rng.standard_normal(p.shape), p.dtype), jnet.params)
    return jnet


def _lm_batch(seed, T):
    ids = np.random.default_rng(seed).integers(0, V, (B, T + 1))
    return ids[:, :-1].astype(np.float32), np.eye(V, dtype=np.float32)[ids[:, 1:]]


class _RoutePins:
    """The port's routing replayed in JAX: each port MoE layer records the
    experts it kept in its last forward; JAX's ``_route`` of the layer of
    that name takes them from a host callback at each execution instead of
    its own top-k, so one compiled step replays every step's routing."""

    def __init__(self, net, jnet):
        self.keep = {}
        for name, impl in net.impls.items():
            if isinstance(impl, MoEDenseImpl):
                impl._route = self._recording(name, impl._route)
                jnet.impls[name]._route = self._replaying(name)

    def _recording(self, name, route):
        def recorded(xr, Wg):
            gates, probs = route(xr, Wg)
            self.keep[name] = (gates != 0).numpy()
            return gates, probs
        return recorded

    def _replaying(self, name):
        def route(xr, Wg):
            probs = jax.nn.softmax(xr @ Wg.astype(xr.dtype), axis=-1)
            keep = jax.pure_callback(lambda: self.keep[name].astype(np.float32),
                                     jax.ShapeDtypeStruct(probs.shape, jnp.float32))
            gates = probs * keep.astype(probs.dtype)
            return gates / jnp.sum(gates, axis=-1, keepdims=True), probs
        return route


def _count_calls(monkeypatch):
    calls = {"flash_fwd": 0, "dq_block": 0, "dkv_block": 0}
    for name in calls:
        real = getattr(fa, name)

        def spy(*a, _name=name, _real=real, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(fa, name, spy)
    return calls


def _jax_gradient_and_score(jnet, f, l):
    """JAX's ``compute_gradient_and_score`` (no masks, training forward,
    no dropout), jitted: the eager one spends some 17 s dispatching the
    capacity dispatch op by op."""
    def loss(p):
        return jnet._loss_fn(p, jnet.states, [jnp.asarray(f)], [jnp.asarray(l)], None, None,
                             True, None)[0]

    score, grads = jax.jit(jax.value_and_grad(loss))(jnet.params)
    return grads, float(score)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,route", [(64, "dense"), (256, "flash")])
def test_moe_transformer_lm_matches_jax(tmp_path, monkeypatch, compute, T, route):
    """output, score with the auxiliary loss, gradients and the parameters
    after three Adam steps (capacity dispatch in training), on the dense
    attention route (T=64) and the flash route (T=256)."""
    monkeypatch.setattr(jfa, "_FORCE_INTERPRET", True)
    monkeypatch.setattr(fa, "_FORCE_SHORT_SEQ", True)
    bf16 = compute == "bfloat16"
    jnet = _jax_lm(compute, cf=2.0 if bf16 else 1.25)
    JSerializer.write_model(jnet, str(tmp_path / "lm.zip"))
    net = restore_model(tmp_path / "lm.zip", device="cpu")
    assert type(net.conf.vertices["b0-ffn"]).__name__ == "MoEDenseLayer"
    if bf16:
        _RoutePins(net, jnet)
    calls = _count_calls(monkeypatch)
    f, l = _lm_batch(1, T)
    out = net.output(f)
    assert out.shape == (B, T, V) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jnet.output(f)), rtol=0,
                               atol=OUT_ATOL[compute])
    ds, jds = DataSet(f, l), JDataSet(f, l)
    score = net.score(ds)
    assert score == pytest.approx(float(jnet.score(jds)), rel=SCORE_RTOL[compute])
    grads, gscore = net.compute_gradient_and_score(ds)
    jgrads, jscore = _jax_gradient_and_score(jnet, f, l)
    flash = route == "flash"
    assert calls == {"flash_fwd": 3 * BLOCKS * flash, "dq_block": BLOCKS * flash,
                     "dkv_block": BLOCKS * flash}
    assert abs(gscore - jscore) <= SCORE_RTOL[compute] * abs(jscore)
    for n, gs in jgrads.items():
        for k, g in gs.items():
            assert _rel(grads[n][k], g) <= GRAD_TOL[compute], (n, k, _rel(grads[n][k], g))
    for _ in range(3):
        net.fit(ds)
        jnet.fit(jds)
    assert net.iteration_count == jnet.iteration_count == 3
    assert abs(net.score() - float(jnet.score())) <= SCORE_RTOL[compute] * float(jnet.score())
    atol = 2 * LR * 3 if bf16 else 1e-5
    for n, ps in jnet.params.items():
        for k, p in ps.items():
            np.testing.assert_allclose(net.params[n][k].float().numpy(),
                                       np.asarray(p, np.float32), rtol=0, atol=atol,
                                       err_msg=f"{n}/{k}")


def test_moe_transformer_lm_streams_and_generates_like_jax(tmp_path):
    """``rnn_time_step`` token by token and in chunks (the dense combine,
    exact routing) and greedy ``generate_tokens`` give the JAX package's
    answers (f32)."""
    jnet = _jax_lm("float32")
    JSerializer.write_model(jnet, str(tmp_path / "lm.zip"))
    net = restore_model(tmp_path / "lm.zip", device="cpu")
    ids = np.random.default_rng(2).integers(0, V, (B, 9)).astype(np.float32)
    for chunks in ([1] * 9, [4, 1, 4]):
        net.rnn_clear_previous_state()
        jnet.rnn_clear_previous_state()
        t = 0
        for n in chunks:
            x = ids[:, t:t + 1] if n == 1 else ids[:, t:t + n, None]
            _close(net.rnn_time_step(x), jnet.rnn_time_step(x))
            t += n
    prompt = np.array([[1, 2, 3], [4, 5, 6]])
    np.testing.assert_array_equal(
        generate_tokens(net, prompt, 6, temperature=1e-4, seed=1),
        jgenerate_tokens(jnet, prompt, 6, temperature=1e-4, seed=1))


def test_moe_transformer_lm_config_and_zip_round_trip(tmp_path):
    """The port's MoE TransformerLM writes the JAX package's configuration
    bytes; a zip the port writes after an Adam step restores in the JAX
    package with the same parameters and moments."""
    mine = TransformerLM(vocab_size=V, embed_dim=E_LM, num_heads=HEADS, num_blocks=BLOCKS,
                         num_experts=EXPERTS, seed=3).conf().to_json()
    text = JTransformerLM(vocab_size=V, embed_dim=E_LM, num_heads=HEADS, num_blocks=BLOCKS,
                          num_experts=EXPERTS, seed=3).conf().to_json()
    assert mine == text and ComputationGraphConfiguration.from_json(text).to_json() == text
    assert re.search(r'"@class": "MoEDenseLayer"', text)
    net = TransformerLM(vocab_size=V, embed_dim=E_LM, num_heads=HEADS, num_blocks=BLOCKS,
                        num_experts=EXPERTS, seed=3).init(device="cpu")
    assert tuple(net.params["b0-ffn"]["W"].shape) == (EXPERTS, E_LM, 4 * E_LM)
    net.fit(DataSet(*_lm_batch(5, 16)))
    write_model(net, tmp_path / "port.zip")
    jback = JSerializer.restore_computation_graph(str(tmp_path / "port.zip"))
    for n, ps in net.params.items():
        for k, p in ps.items():
            np.testing.assert_array_equal(np.asarray(jback.params[n][k]), p.numpy())
            for slot, m in zip(net.updater_state[n][k], jback.updater_state[n][k]):
                np.testing.assert_array_equal(np.asarray(m), slot.numpy())
