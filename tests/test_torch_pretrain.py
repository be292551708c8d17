"""The pretrain layers in the port on the CPU, against the JAX package.

AutoEncoder, RBM and VariationalAutoencoder (with every reconstruction
distribution): each pretrain loss and its gradients at the same parameters
and input, the VAE's reconstruction and generation APIs, and the
containers' ``pretrain``/``pretrain_layer`` and ``fit`` with
``pretrain(True)`` over a stacked RBM -> AutoEncoder -> VAE network, the
parameters after each compared. The oracles of ``tests/test_rbm.py`` and
``tests/test_vae.py`` and the pretrain cases of
``tests/test_gradientcheck_extended.py`` run on the port too.

The random draws (the AutoEncoder's corruption, the RBM's Gibbs chain, the
VAE's reparameterisation and samples) are the port's: ``DrawReplay``
records each ``nn/conf/dropout.bernoulli``/``normal``/``exponential`` draw
in order and JAX's ``jax.random.bernoulli``/``normal``/``exponential``
return them in that order from an ordered host callback
(``jax.experimental.io_callback(..., ordered=True)``, which keeps a jitted
step's draws in program order; armed after the JAX network's weights are
drawn), each shape checked.

Tolerances, as max |port - jax| over the largest |jax| entry of the
tensor: float64 1e-10, float32 1e-5; bfloat16 compute one bf16 unit (2^-8)
of the layer's largest parameter entry after training.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import io_callback

from deeplearning4j_tpu import MultiLayerNetwork as JNet
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu import Adam as JAdam
from deeplearning4j_tpu import Sgd as JSgd
from deeplearning4j_tpu.compat import enable_x64
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import ListDataSetIterator as JList
from deeplearning4j_tpu.nn.conf import GlobalConfig as JGlobalConfig
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf import reconstruction as jrec
from deeplearning4j_tpu.nn.layers.base import impl_for as jimpl_for

from deeplearning4j_torch import DataSet, ListDataSetIterator
from deeplearning4j_torch.nn.conf import GlobalConfig, MultiLayerConfiguration, serde
from deeplearning4j_torch.nn.conf import dropout as pdrop
from deeplearning4j_torch.nn.gradientcheck import GradientCheckUtil, check_function_gradients
from deeplearning4j_torch.nn.layers import impl_for
from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork

TOL = {"float64": 1e-10, "float32": 1e-5}
BF16_UNIT = 2.0 ** -8
POLICY = {"float64": ("float64", "float64"), "float32": ("float32", "float32"),
          "bfloat16": ("float32", "bfloat16")}
TDT = {"float64": torch.float64, "float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float64": jnp.float64, "float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


class DrawReplay:
    """The port's draws recorded in order (``draws``), and returned in that
    order by JAX's ``jax.random.bernoulli``/``normal``/``exponential`` once
    :meth:`arm` is called (before it JAX draws its own)."""

    NAMES = ("bernoulli", "normal", "exponential")

    def __init__(self, monkeypatch):
        self.draws = []
        self.taken = 0
        self.armed = False
        for name in self.NAMES:
            monkeypatch.setattr(pdrop, name, self._recording(getattr(pdrop, name)))
        self.real = {n: getattr(jax.random, n) for n in self.NAMES}
        monkeypatch.setattr(jax.random, "bernoulli", self._bernoulli)
        monkeypatch.setattr(jax.random, "normal", self._real_valued("normal"))
        monkeypatch.setattr(jax.random, "exponential", self._real_valued("exponential"))

    def arm(self):
        self.armed = True
        return self

    def _recording(self, real):
        def draw(*a, **k):
            out = real(*a, **k)
            self.draws.append(out.detach().cpu())
            return out
        return draw

    def _pop(self, shape):
        got = self.draws[self.taken]
        self.taken += 1
        assert tuple(got.shape) == tuple(shape), (self.taken - 1, tuple(got.shape), shape)
        return got

    def _bernoulli(self, key, p=0.5, shape=None, **kw):
        if not self.armed:
            return self.real["bernoulli"](key, p, shape, **kw)
        shape = jnp.shape(p) if shape is None else tuple(shape)
        keep = io_callback(lambda key: self._pop(shape).numpy().astype(np.uint8),
                           jax.ShapeDtypeStruct(shape, jnp.uint8), key, ordered=True)
        return keep.astype(bool)

    def _real_valued(self, name):
        def draw(key, shape=(), dtype=jnp.float32, **kw):
            if not self.armed:
                return self.real[name](key, shape, dtype, **kw)
            shape = tuple(shape)
            wide = jnp.dtype(dtype) == jnp.float64
            host = np.float64 if wide else np.float32
            # the bits as uint32 words: a callback's float64 result is cut
            # to float32 when it runs on a thread where x64 is off
            bits = io_callback(
                lambda key: np.ascontiguousarray(self._pop(shape).double().numpy(), host)
                .view(np.uint32).reshape(shape + ((2,) if wide else ())),
                jax.ShapeDtypeStruct(shape + ((2,) if wide else ()), np.uint32), key,
                ordered=True)
            return jax.lax.bitcast_convert_type(bits, host).astype(dtype)
        return draw


def rel(got, want):
    """max |got - want| over the largest |want| entry."""
    got = np.asarray(got.detach().double().cpu() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def layer_pair(jconf, dtype, seed=0, spread=0.1):
    """(JAX impl, its parameters, port impl with the same parameters) of a
    layer config under the ``dtype`` policy, the parameters moved off their
    init (biases too) by N(0, spread)."""
    pdt, cdt = POLICY[dtype]
    with enable_x64(dtype == "float64"):
        jimpl = jimpl_for(jconf, JGlobalConfig(dtype=pdt, compute_dtype=cdt, activation="tanh"))
        params, _ = jimpl.init(jax.random.PRNGKey(seed))
        rng = np.random.default_rng(seed)
        params = {k: jnp.asarray(np.asarray(v, np.float64) + spread * rng.normal(size=v.shape),
                                 v.dtype) for k, v in params.items()}
    conf = serde.decode(serde.encode(jconf))
    impl = impl_for(conf, GlobalConfig(dtype=pdt, compute_dtype=cdt, activation="tanh"))
    impl.set_params({k: torch.from_numpy(np.asarray(v)) for k, v in params.items()}, "cpu")
    return jimpl, params, impl


def port_loss_and_grads(impl, x, fn):
    """``fn(x, p)`` and its gradients in the port at the layer's parameters."""
    p = {k: v.detach().clone().requires_grad_() for k, v in impl.param_dict().items()}
    loss = fn(x, p)
    return loss, dict(zip(p, torch.autograd.grad(loss, list(p.values()))))


def check_loss_and_grads(rp, jimpl, params, impl, x, dtype, jfn, pfn):
    """The port's ``pfn`` (recording its draws) and JAX's ``jfn`` (replaying
    them): loss and every parameter's gradient at the dtype's tolerance."""
    loss, grads = port_loss_and_grads(impl, torch.from_numpy(x).to(TDT[dtype]), pfn)
    rp.arm()
    with enable_x64(dtype == "float64"):
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p: jfn(p, jnp.asarray(x, JDT[dtype]))))(params)
        jloss, jgrads = np.asarray(jloss), {k: np.asarray(v) for k, v in jgrads.items()}
    assert rp.taken == len(rp.draws)
    tol = TOL[dtype]
    assert rel(loss, jloss) <= tol, (float(loss), jloss)
    for k, g in jgrads.items():
        assert rel(grads[k], g) <= tol, (k, rel(grads[k], g))


def _x(b, n, seed=1, kind="normal"):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n))
    if kind == "binary":
        x = (x > 0).astype(np.float64)
    elif kind == "positive":
        x = np.abs(x) + 0.1
    # f32-representable, so that every dtype reads the same values
    return x.astype(np.float32).astype(np.float64)


# ------------------------------------------------------------- AutoEncoder
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_autoencoder_pretrain_loss_matches_jax(monkeypatch, dtype):
    rp = DrawReplay(monkeypatch)
    conf = jl.AutoEncoder(n_in=7, n_out=5, corruption_level=0.3, activation="sigmoid")
    jimpl, params, impl = layer_pair(conf, dtype)
    x = _x(6, 7)
    check_loss_and_grads(rp, jimpl, params, impl, x, dtype,
                         lambda p, xj: jimpl.pretrain_loss(p, xj, jax.random.PRNGKey(0)),
                         lambda xt, p: impl.pretrain_loss(
                             xt, torch.Generator().manual_seed(3), p=p))
    assert len(rp.draws) == 1 and rp.draws[0].dtype == torch.bool


# -------------------------------------------------------------------- RBM
RBM_CASES = [dict(hidden_unit="binary", visible_unit="binary", k=1),
             dict(hidden_unit="rectified", visible_unit="gaussian", k=2, sparsity=0.1),
             dict(hidden_unit="gaussian", visible_unit="linear", k=1),
             dict(hidden_unit="identity", visible_unit="identity", k=1, sparsity=0.05),
             dict(hidden_unit="binary", visible_unit="gaussian", k=3)]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_rbm_pretrain_loss_matches_jax(monkeypatch, dtype):
    """Every RBM unit kind, k 1-3, sparsity on and off (in f32 the first
    two cases): the CD surrogate and its gradients on the same Gibbs chain;
    prop_up, prop_down, free_energy and reconstruction_error at the same
    parameters."""
    for case in RBM_CASES if dtype == "float64" else RBM_CASES[:2]:
        rp = DrawReplay(monkeypatch)
        conf = jl.RBM(n_in=6, n_out=5, **case)
        jimpl, params, impl = layer_pair(conf, dtype)
        kind = "binary" if case["visible_unit"] == "binary" else "normal"
        x = _x(8, 6, kind=kind)
        check_loss_and_grads(rp, jimpl, params, impl, x, dtype,
                             lambda p, xj: jimpl.pretrain_loss(p, xj, jax.random.PRNGKey(0)),
                             lambda xt, p: impl.pretrain_loss(
                                 xt, torch.Generator().manual_seed(4), p=p))
        n_draws = {"binary": 1, "rectified": 1, "gaussian": 1, "identity": 0}
        per_step = n_draws[case["hidden_unit"]] + (case["visible_unit"] in ("binary", "gaussian"))
        assert len(rp.draws) == per_step * case["k"], case
        xt = torch.from_numpy(x).to(TDT[dtype])
        with enable_x64(dtype == "float64"):
            xj = jnp.asarray(x, JDT[dtype])
            h = jimpl.prop_up(params, xj)
            ht = torch.from_numpy(np.asarray(h))
            for got, want in ((impl.prop_up(xt), h),
                              (impl.prop_down(ht), jimpl.prop_down(params, h)),
                              (impl.free_energy(xt), jimpl.free_energy(params, xj)),
                              (impl.reconstruction_error(xt),
                               jimpl.reconstruction_error(params, xj))):
                assert rel(got, np.asarray(want)) <= TOL[dtype], case


def test_rbm_rejects_unknown_units():
    for kw in ({"hidden_unit": "softmax"}, {"visible_unit": "softmax"}):
        with pytest.raises(ValueError, match="RBM"):
            impl_for(serde.decode(serde.encode(jl.RBM(n_in=3, n_out=2, **kw))), GlobalConfig())


def test_rbm_surrogate_gradient_is_cd_update():
    """The oracle of ``tests/test_rbm.py``: the surrogate's gradient is the
    CD-1 statistics <v0 h0> - <vk hk> computed by hand (port only)."""
    impl = impl_for(serde.decode(serde.encode(jl.RBM(n_in=12, n_out=8, activation="sigmoid"))),
                    GlobalConfig())
    impl.set_params(impl.init_params(torch.Generator().manual_seed(7)), "cpu")
    x = torch.from_numpy((np.random.default_rng(3).random((16, 12)) > 0.5).astype(np.float32))
    loss, g = port_loss_and_grads(impl, x, lambda xt, p: impl.pretrain_loss(
        xt, torch.Generator().manual_seed(5), p=p))
    vk = impl.gibbs_chain(x, torch.Generator().manual_seed(5), 1)
    with torch.no_grad():
        h0, hk = impl.prop_up(x), impl.prop_up(vk)
    n = x.shape[0]
    torch.testing.assert_close(g["W"], -(x.T @ h0) / n + (vk.T @ hk) / n, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(g["b"], -h0.mean(0) + hk.mean(0), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(g["vb"], -x.mean(0) + vk.mean(0), rtol=1e-5, atol=1e-6)


# -------------------------------------------------------------------- VAE
def _dists(pkg):
    r = pkg
    return {"gaussian": r.GaussianReconstructionDistribution(activation="tanh"),
            "bernoulli": r.BernoulliReconstructionDistribution(),
            "bernoulli_tanh": r.BernoulliReconstructionDistribution(activation="hardsigmoid"),
            "exponential": r.ExponentialReconstructionDistribution(),
            "composite": (r.CompositeReconstructionDistribution.builder()
                          .add_distribution(3, r.GaussianReconstructionDistribution())
                          .add_distribution(2, r.BernoulliReconstructionDistribution())
                          .add_distribution(2, r.ExponentialReconstructionDistribution())
                          .build()),
            "loss_wrapper": r.LossFunctionWrapper(loss="mse", activation="tanh"),
            "legacy": "exponential"}


def _vae_x(name, b=6):
    if name.startswith("bernoulli"):
        return _x(b, 7, kind="binary")
    if name in ("exponential", "legacy"):
        return _x(b, 7, kind="positive")
    if name == "composite":
        return np.concatenate([_x(b, 3), _x(b, 2, 2, "binary"), _x(b, 2, 3, "positive")], 1)
    return _x(b, 7)


def _vae(dist, samples=2):
    return jl.VariationalAutoencoder(n_in=7, n_out=3, encoder_layer_sizes=(6, 5),
                                     decoder_layer_sizes=(5,), reconstruction_distribution=dist,
                                     num_samples=samples, pzx_activation="tanh")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_vae_pretrain_loss_matches_jax(monkeypatch, dtype):
    """The negative ELBO over two reparameterised draws and its gradients,
    with each reconstruction distribution (a legacy name too; in f32 the
    gaussian and the composite)."""
    for name, dist in _dists(jrec).items():
        if dtype == "float32" and name not in ("gaussian", "composite"):
            continue
        rp = DrawReplay(monkeypatch)
        jimpl, params, impl = layer_pair(_vae(dist), dtype)
        check_loss_and_grads(rp, jimpl, params, impl, _vae_x(name), dtype,
                             lambda p, xj: jimpl.pretrain_loss(p, xj, jax.random.PRNGKey(0)),
                             lambda xt, p: impl.pretrain_loss(
                                 xt, torch.Generator().manual_seed(2), p=p))
        assert len(rp.draws) == 2, name


def test_vae_reconstruction_and_generation_match_jax(monkeypatch):
    """f64: ``reconstruction_log_probability`` (4 importance samples) and
    ``reconstruction_probability``, ``reconstruction_error`` (the loss
    wrapper; the others raise, as JAX), ``generate_at_mean_given_z`` and
    ``generate_random_given_z`` (each distribution's sampler, the composite
    drawing from one generator a part), the camelCase aliases, and the
    forward (the mean of q(z|x))."""
    for name, dist in _dists(jrec).items():
        rp = DrawReplay(monkeypatch)
        jimpl, params, impl = layer_pair(_vae(dist), "float64")
        x = _vae_x(name)
        xt = torch.from_numpy(x)
        z = torch.from_numpy(_x(6, 3, 9))
        wrapper = name == "loss_wrapper"
        got = {"at_mean": impl.generateAtMeanGivenZ(z), "forward": impl(xt),
               "random": impl.generateRandomGivenZ(z, torch.Generator().manual_seed(1))}
        if wrapper:
            got["error"] = impl.reconstruction_error(xt)
            with pytest.raises(ValueError, match="reconstruction_error"):
                impl.reconstruction_log_probability(xt)
        else:
            got["log_p"] = impl.reconstruction_log_probability(
                xt, torch.Generator().manual_seed(6), 4)
            got["p"] = impl.reconstruction_probability(xt, torch.Generator().manual_seed(6), 4)
            with pytest.raises(ValueError, match="LossFunctionWrapper"):
                impl.reconstruction_error(xt)
        assert impl.hasLossFunction() == wrapper
        rp.arm()

        def jax_apis(params, xj, zj, key):
            want = {"at_mean": jimpl.generateAtMeanGivenZ(params, zj),
                    "forward": jimpl.forward(params, {}, xj)[0],
                    "random": jimpl.generateRandomGivenZ(params, zj, key)}
            if wrapper:
                want["error"] = jimpl.reconstruction_error(params, xj)
            else:
                want["log_p"] = jimpl.reconstruction_log_probability(params, xj, key, 4)
                want["p"] = jimpl.reconstruction_probability(params, xj, key, 4)
            return want
        with enable_x64(True):
            want = jax.jit(jax_apis)(params, jnp.asarray(x), jnp.asarray(z.numpy()),
                                     jax.random.PRNGKey(0))
        assert rp.taken == len(rp.draws)
        for k, w in want.items():
            assert rel(got[k], np.asarray(w)) <= TOL["float64"], (name, k)


def test_vae_gaussian_neg_log_prob_oracle():
    """The diagonal-Gaussian -log p by hand (``tests/test_vae.py``)."""
    from deeplearning4j_torch.nn.conf.reconstruction import GaussianReconstructionDistribution
    rng = np.random.default_rng(3)
    x, pre = rng.normal(size=(4, 5)), rng.normal(size=(4, 10))
    mean, log_var = pre[:, :5], pre[:, 5:]
    oracle = np.sum(0.5 * np.log(2 * np.pi) + 0.5 * log_var
                    + (x - mean) ** 2 / (2 * np.exp(log_var)), axis=1)
    got = GaussianReconstructionDistribution().neg_log_prob(torch.from_numpy(x),
                                                            torch.from_numpy(pre))
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-12)
    assert GaussianReconstructionDistribution().param_size(5) == 10


# ------------------------------------------------------- gradient checks
def _f64(pkg_conf, *layers):
    b = (pkg_conf.builder().seed(12345).updater(JSgd(learning_rate=1.0))
         .dtype("float64").compute_dtype("float64").activation("tanh").list())
    for layer in layers:
        b = b.layer(layer)
    return b.build()


def _port_net(jconf, **init):
    return MultiLayerNetwork(MultiLayerConfiguration.from_json(jconf.to_json())).init(
        device="cpu", **init)


@pytest.mark.parametrize("case", ["autoencoder", "rbm_binary", "rbm_gaussian",
                                  "vae_gaussian", "vae_bernoulli", "vae_composite"])
def test_pretrain_loss_gradient_checks(case):
    """The pretrain cases of ``tests/test_gradientcheck_extended.py`` (and
    the RBM's): central differences of each pretrain loss against autograd
    in f64, the draws fixed by a generator made anew each evaluation. The
    RBMs have binary visible units: their chain's end is then a step
    function of the parameters, which the surrogate treats as a constant
    (a gaussian visible sample moves with them)."""
    out = jl.OutputLayer(n_in=3, n_out=2, activation="softmax", loss="mcxent")
    layer = {"autoencoder": jl.AutoEncoder(n_in=5, n_out=3, corruption_level=0.0),
             "rbm_binary": jl.RBM(n_in=5, n_out=3, k=2),
             "rbm_gaussian": jl.RBM(n_in=5, n_out=3, hidden_unit="gaussian", sparsity=0.1),
             "vae_gaussian": _vae(jrec.GaussianReconstructionDistribution(), 1),
             "vae_bernoulli": _vae(jrec.BernoulliReconstructionDistribution(), 1),
             "vae_composite": _vae(_dists(jrec)["composite"], 1)}[case]
    n_in = layer.n_in
    net = _port_net(_f64(JConf, layer, out))
    impl = net.impls[0]
    x = torch.from_numpy(_vae_x(case.split("_")[-1]) if case.startswith("vae")
                         else _x(5, n_in, kind="binary" if case.startswith("rbm") else "normal"))
    assert check_function_gradients(
        lambda p: impl.pretrain_loss(x, torch.Generator().manual_seed(0), p=p),
        net.params["0"], max_per_param=10)


def test_vae_supervised_gradient_check():
    """The VAE mid-network (its forward the mean of q(z|x)); the decoder
    takes no part in the supervised loss."""
    layer = jl.VariationalAutoencoder(n_in=6, n_out=3, encoder_layer_sizes=(7,),
                                      decoder_layer_sizes=(7,))
    net = _port_net(_f64(JConf, layer, jl.OutputLayer(n_in=3, n_out=2, activation="softmax",
                                                       loss="mcxent")))
    rng = np.random.default_rng(17)
    ds = DataSet(_x(6, 6, 17), np.eye(2)[rng.integers(0, 2, 6)])
    assert GradientCheckUtil.check_gradients(net, ds, max_per_param=12, exclude={"0/d", "0/x"})


# ------------------------------------------------------- the containers
def _stack_jconf(dtype, updater=None, pretrain=False):
    pdt, cdt = POLICY[dtype]
    b = (JConf.builder().seed(11).updater(updater or JAdam(learning_rate=5e-3))
         .activation("sigmoid").dtype(pdt).compute_dtype(cdt).list()
         .layer(jl.RBM(n_in=10, n_out=8))
         .layer(jl.AutoEncoder(n_in=8, n_out=6, corruption_level=0.25, loss="mse"))
         .layer(jl.VariationalAutoencoder(
             n_in=6, n_out=3, encoder_layer_sizes=(5,), decoder_layer_sizes=(5,),
             reconstruction_distribution=jrec.BernoulliReconstructionDistribution(),
             updater=JSgd(learning_rate=0.05)))
         .layer(jl.OutputLayer(n_in=3, n_out=2, activation="softmax", loss="mcxent")))
    return b.pretrain(pretrain).build()


def _stack_pair(dtype, **kw):
    with enable_x64(dtype == "float64"):
        jnet = JNet(_stack_jconf(dtype, **kw)).init()
        params = {k: {n: np.array(v) for n, v in d.items()} for k, d in jnet.params.items()}
    net = _port_net(_stack_jconf(dtype, **kw), params=params)
    return jnet, net


def _batches(n=3, b=8, seed=0):
    rng = np.random.default_rng(seed)
    return [((rng.random((b, 10)) > 0.5).astype(np.float32),
             np.eye(2, dtype=np.float32)[rng.integers(0, 2, b)]) for _ in range(n)]


def check_params(net, jnet, dtype):
    for k, ps in jnet.params.items():
        scale = max((float(np.abs(np.asarray(p, np.float64)).max()) for p in ps.values()),
                    default=0.0)
        for n, p in ps.items():
            want = np.asarray(p, np.float64)
            got = net.params[k][n].double().numpy()
            err = float(np.abs(got - want).max())
            limit = BF16_UNIT * scale if dtype == "bfloat16" else TOL[dtype] * scale
            assert err <= limit, (k, n, err, limit)


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_pretrain_matches_jax(monkeypatch, dtype):
    """``pretrain`` over RBM -> AutoEncoder -> VAE (its own updater), two
    epochs of three minibatches: each layer on the activations of the ones
    below, every parameter and ``score_`` against JAX; the output layer
    untouched."""
    rp = DrawReplay(monkeypatch)
    jnet, net = _stack_pair(dtype)
    out_before = net.params["3"]["W"].clone()
    sets = _batches()
    net.pretrain(ListDataSetIterator([DataSet(f, l) for f, l in sets]), epochs=2)
    assert len(rp.draws) == 3 * 2 * (2 + 1 + 1)
    rp.arm()
    with enable_x64(dtype == "float64"):
        jnet.pretrain(JList([JDataSet(f, l) for f, l in sets]), epochs=2)
        jscore = float(jnet.score_)
    assert rp.taken == len(rp.draws)
    check_params(net, jnet, dtype)
    assert torch.equal(net.params["3"]["W"], out_before)
    if dtype != "bfloat16":
        assert abs(net.score() - jscore) <= TOL[dtype] * abs(jscore)


def test_pretrain_layer_matches_jax(monkeypatch):
    """``pretrain_layer`` on layer 1 alone (f32): the AutoEncoder on the
    RBM's activations; the other layers untouched."""
    rp = DrawReplay(monkeypatch)
    jnet, net = _stack_pair("float32")
    before = {k: {n: t.clone() for n, t in ps.items()} for k, ps in net.params.items()}
    sets = _batches(2, seed=4)
    net.pretrain_layer(1, ListDataSetIterator([DataSet(f, l) for f, l in sets]), epochs=3)
    rp.arm()
    jnet.pretrain_layer(1, JList([JDataSet(f, l) for f, l in sets]), epochs=3)
    check_params(net, jnet, "float32")
    for k in ("0", "2", "3"):
        assert all(torch.equal(net.params[k][n], before[k][n]) for n in before[k])
    with pytest.raises(ValueError, match="not a pretrainable layer"):
        net.pretrain_layer(3, ListDataSetIterator([DataSet(*sets[0])]))


def test_fit_with_pretrain_flag_matches_jax(monkeypatch):
    """``pretrain(True)``: the first ``fit`` pretrains on its data, then
    trains (3 supervised steps of an f32 net under Sgd); a second fit does
    not pretrain again."""
    rp = DrawReplay(monkeypatch)
    jnet, net = _stack_pair("float32", updater=JSgd(learning_rate=0.1), pretrain=True)
    assert net.conf.pretrain
    sets = _batches(3, seed=7)
    net.fit(ListDataSetIterator([DataSet(f, l) for f, l in sets]))
    n_draws = len(rp.draws)
    net.fit(DataSet(*sets[0]))
    assert len(rp.draws) == n_draws == 3 * 4
    rp.arm()
    jnet.fit(JList([JDataSet(f, l) for f, l in sets]))
    jnet.fit(JDataSet(*sets[0]))
    check_params(net, jnet, "float32")


def test_pretraining_learns():
    """The oracles of ``tests/test_rbm.py`` and ``tests/test_vae.py``, on the
    port alone: RBM pretraining lowers the reconstruction error, and a VAE
    trained on inliers gives held-out outliers a lower log p(x)."""
    from deeplearning4j_torch import NeuralNetConfiguration, Sgd, Adam
    from deeplearning4j_torch.nn.conf import layers as pl
    rng = np.random.default_rng(0)
    protos = rng.random((2, 12)) > 0.5
    which = rng.integers(0, 2, 64)
    x = np.where(rng.random((64, 12)) < 0.05, ~protos[which], protos[which]).astype(np.float32)
    conf = (NeuralNetConfiguration.builder().seed(7).updater(Sgd(learning_rate=0.1)).list()
            .layer(pl.RBM(n_in=12, n_out=8, activation="sigmoid"))
            .layer(pl.OutputLayer(n_in=8, n_out=2, activation="softmax", loss="mcxent"))
            .build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    err0 = float(net.impls[0].reconstruction_error(torch.from_numpy(x)))
    net.pretrain_layer(0, ListDataSetIterator([DataSet(x, np.eye(2)[which])]), epochs=50)
    assert float(net.impls[0].reconstruction_error(torch.from_numpy(x))) < 0.7 * err0

    conf = (NeuralNetConfiguration.builder().seed(3).updater(Adam(learning_rate=5e-3))
            .activation("tanh").list()
            .layer(pl.VariationalAutoencoder(n_in=6, n_out=3, encoder_layer_sizes=(12,),
                                             decoder_layer_sizes=(12,), num_samples=2))
            .layer(pl.OutputLayer(n_in=3, n_out=2, activation="softmax", loss="mcxent"))
            .build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    inliers = (rng.normal(size=(128, 6)) * 0.3).astype(np.float32)
    net.pretrain_layer(0, ListDataSetIterator([DataSet(inliers, np.eye(2)[which[:1].repeat(128)])]),
                       epochs=150)
    impl = net.impls[0]
    outliers = torch.from_numpy((rng.normal(size=(32, 6)) * 3 + 4).astype(np.float32))
    lp_in = impl.reconstruction_log_probability(torch.from_numpy(inliers[:32]),
                                                torch.Generator().manual_seed(2), 16)
    lp_out = impl.reconstruction_log_probability(outliers, torch.Generator().manual_seed(2), 16)
    assert float(lp_in.mean()) > float(lp_out.mean()) + 1.0
