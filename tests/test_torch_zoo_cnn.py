"""LeNet (MultiLayerNetwork) and ResNet50 (ComputationGraph) on the CPU,
against the JAX package.

The JAX network is built from its zoo, the parameters its init sets to
constants (biases, BatchNormalization's gamma and beta) moved off them,
written with ``ModelSerializer`` and restored by the port from the zip.
ResNet50's running statistics are set to the statistics of 64 other
images before the zip is written, so that ``output`` (which normalises
with them) answers with probabilities that are not all 0 and 1, and so
that restoring ``states.bin`` matters.

Tolerances are those of ``test_torch_graph.py`` (max |port - jax| over max
|jax|, scores relative): f32 outputs 1e-5 absolute, scores 1e-5, gradients
1e-4; bf16 outputs 3e-2 absolute, scores 2e-3, gradients 3e-2; running
statistics f32 1e-4, bf16 3e-2. Parameters after Adam steps: within 2 x
lr x steps, and in f32 at most 1 entry in 10,000 beyond 1e-5. Adam's
first steps move an entry by about lr whatever its gradient's size, so an
entry whose gradient is at rounding level (a sum that cancels) moves apart
in two correct implementations: 1 of LeNet's 400,000 dense weights did,
by 2.1e-5.

Where the JAX reference is not accurate enough to be an oracle, the test
says so and uses a better one:

- bf16 bias gradients: on the CPU backend the JAX package sums a bias's
  bf16 cotangent over every position in bf16 (LeNet's first convolution:
  4,608 terms at b=8, 3.5% off its own forward-mode derivative); the port
  sums in f32. The reference for LeNet's bf16 bias gradients is JAX's
  forward-mode derivative (``jax.jvp``, one direction per bias entry),
  which reduces no bf16 cotangent. JAX's bf16 fit steps use its reverse-
  mode biases, so after them only the parameters are compared.
- ResNet50 (3x64x64, 10 classes, b=8, Adam at R50_LR) is compared in a
  well-conditioned state: the last BatchNormalization of every residual
  branch has its gamma times R50_BRANCH_GAMMA (the shrunk residual of
  common ResNet recipes). At gamma 1 the random net's backward explodes,
  and rounding alone moves its gradients by percents. Its gradient also
  jumps wherever a ReLU unit or a max-pool pick changes side, and rounding
  flips a few of the 6 million units, each moving the whole gradient far
  more than rounding does. So the JAX network replays the port's kinks (``KinkPins``
  records them in the port, ``_JaxReplay`` feeds them to JAX's ReLU and
  max pool at each execution), and both differentiate the same piece.
  With that, f64 (both packages in f64, JAX under ``enable_x64``) holds
  output, score and gradients at the f32 tolerances, and the scores,
  running statistics and parameters after each of three Adam steps at
  1e-5, 1e-4 and 1e-5; f32 holds the f32 tolerances, and its three steps
  are held as R50_STEP_LIMITS says: Adam's update is lr x sign(g) wherever
  |g| is well above its epsilon, so an entry whose gradient is at rounding
  level moves 2 x lr apart (the updates read 5.0e-4 apart norm-wise).
- ResNet50 in bf16: JAX's bf16 scores and gradients are less accurate
  than the port's (JAX sums BatchNormalization's bf16 cotangents in bf16),
  so the port's are held against JAX's f64 answer on the port's bf16
  kinks: training score at 2e-3 (reading 4.6e-4), gradients norm-wise at
  R50_BF16_GRAD_NORM (reading 3.7e-2; worst parameter 0.11 of its largest
  entry), inference score at R50_BF16_SCORE_INFERENCE (reading 2.2e-3,
  4.1e-3 against JAX's own bf16). The output is held against JAX's bf16
  at 3e-2 (reading 1.75e-2). After the three steps, whose bf16 gradients
  part at many entries' signs, the step scores (reading 1.4e-2), states
  (1.4e-2) and updates (0.19 norm-wise) are held as R50_STEP_LIMITS says.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu import Adam as JAdam
from deeplearning4j_tpu.compat import enable_x64
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import LeNet as JLeNet
from deeplearning4j_tpu.models import ResNet50 as JResNet50
from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration as JMLConf
from deeplearning4j_tpu.nn.conf.graph import ComputationGraphConfiguration as JCGConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.utils.model_serializer import ModelSerializer

from deeplearning4j_torch import DataSet
from deeplearning4j_torch.models import LeNet, ResNet50
from deeplearning4j_torch.nn.conf import ComputationGraphConfiguration, MultiLayerConfiguration
from deeplearning4j_torch.utils.kink_pins import KinkPins
from deeplearning4j_torch.utils.model_serializer import (restore_computation_graph,
                                                         restore_multi_layer_network)

from test_torch_zoo_family import _JaxReplay

LR, STEPS = 1e-3, 3
OUT_ATOL = {"float32": 1e-5, "bfloat16": 3e-2}
SCORE_RTOL = {"float32": 1e-5, "bfloat16": 2e-3}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
STATE_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
PARAM_F32_ATOL, PARAM_F32_SHARE = 1e-5, 1e-4
R50_SHAPE, R50_CLASSES, R50_B, R50_STATS_B = (3, 64, 64), 10, 8, 64
R50_LR, R50_BRANCH_GAMMA = 1e-5, 0.2
R50_BF16_GRAD_NORM, R50_BF16_SCORE_INFERENCE = 0.1, 1e-2
R50_STEP_LIMITS = {
    "float32": {"step_scores": SCORE_RTOL["float32"], "states_step1": STATE_TOL["float32"],
                "states": STATE_TOL["float32"], "params_max": 2 * R50_LR * STEPS,
                "update_norm": 5e-3},
    "bfloat16": {"step_scores": 5e-2, "states_step1": STATE_TOL["bfloat16"],
                 "states": STATE_TOL["bfloat16"], "update_norm": 0.5}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _rel(got, want):
    got = (got.detach().double().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float64))
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _batch(seed, b, shape, classes):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b,) + tuple(shape)).astype(np.float32),
            np.eye(classes, dtype=np.float32)[rng.integers(0, classes, b)])


def _perturb(jnet, seed):
    """The parameters that init sets to constants (biases, BN's gamma and
    beta) moved off them; the weights keep their random init."""
    rng = np.random.default_rng(seed)

    def move(path, p):
        if path[-1].key not in ("b", "gamma", "beta"):
            return p
        return p + jnp.asarray(0.05 * rng.standard_normal(p.shape), p.dtype)
    jnet.params = jax.tree_util.tree_map_with_path(move, jnet.params)


def _compare_grads(net, f, l, jgrads, jscore, tol):
    """``tol`` is (score rtol, gradient tolerance)."""
    grads, score = net.compute_gradient_and_score(DataSet(f, l))
    assert abs(score - jscore) <= tol[0] * abs(jscore), (score, jscore)
    assert set(grads) == set(jgrads)
    for n, gs in jgrads.items():
        assert set(grads[n]) == set(gs), n
        for k, g in gs.items():
            assert _rel(grads[n][k], g) <= tol[1], (n, k, _rel(grads[n][k], g))


def _compare_params(net, jparams, steps, f32_share):
    for n, ps in jparams.items():
        for k, p in ps.items():
            diff = np.abs(net.params[n][k].double().numpy() - np.asarray(p, np.float64))
            assert diff.max() <= 2 * LR * steps, (n, k, diff.max())
            if f32_share:
                assert (diff > PARAM_F32_ATOL).mean() <= PARAM_F32_SHARE, (n, k, diff.max())


def _compare_states(net, jstates, tol):
    for n, ss in jstates.items():
        assert set(net.states[n]) == set(ss), n
        for k, s in ss.items():
            assert _rel(net.states[n][k], s) <= tol, (n, k, _rel(net.states[n][k], s))


def _forward_mode_bias_grads(jnet, f, l):
    """d loss / d b of every bias by forward mode: one ``jax.jvp`` per
    entry, vmapped over the entries of each bias."""
    x, y = jnp.transpose(jnp.asarray(f), (0, 2, 3, 1)), jnp.asarray(l)

    def loss(p):
        return jnet._loss_fn(p, jnet.states, x, y, None, None, True, None)[0]

    out = {}
    for i, ps in jnet.params.items():
        if "b" not in ps:
            continue

        def directional(t, i=i):
            tan = jax.tree_util.tree_map(jnp.zeros_like, jnet.params)
            tan[i]["b"] = t
            return jax.jvp(loss, (jnet.params,), (tan,))[1]
        n = ps["b"].shape[0]
        out[i] = jax.jit(jax.vmap(directional))(jnp.eye(n, dtype=ps["b"].dtype))
    return out


def test_lenet_num_params():
    assert LeNet(num_classes=10).init(device="cpu").num_params() == 431080


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_lenet_matches_jax(tmp_path, compute):
    """output, score, gradients and three Adam steps at b=8."""
    conf = JLeNet(num_classes=10, seed=5).conf()
    conf.global_conf.compute_dtype = compute
    jnet = JNet(conf).init()
    _perturb(jnet, 5)
    path = tmp_path / "lenet.zip"
    ModelSerializer.write_model(jnet, str(path))
    net = restore_multi_layer_network(path, device="cpu")
    assert net.num_params() == jnet.num_params() == 431080
    f, l = _batch(1, 8, (1, 28, 28), 10)
    out = net.output(f)
    assert out.shape == (8, 10) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jnet.output(f)), rtol=0,
                               atol=OUT_ATOL[compute])
    jgrads, jscore = jnet.compute_gradient_and_score(JDataSet(f, l))
    if compute == "bfloat16":
        for i, g in _forward_mode_bias_grads(jnet, f, l).items():
            jgrads[i]["b"] = g
    _compare_grads(net, f, l, jgrads, jscore, (SCORE_RTOL[compute], GRAD_TOL[compute]))
    scores = []
    for _ in range(STEPS):
        net.fit(DataSet(f, l))
        jnet.fit(JDataSet(f, l))
        scores.append(net.score())
    assert net.iteration_count == jnet.iteration_count == STEPS
    assert scores[-1] < scores[0]
    _compare_params(net, jnet.params, STEPS, compute == "float32")
    if compute == "float32":
        assert abs(net.score() - float(jnet.score())) <= SCORE_RTOL[compute] * float(jnet.score())


def _jax_batch_statistics(jnet, f):
    """Each BatchNormalization's statistics of one training forward on
    ``f``: the new running values of a forward with ``decay`` 0."""
    bns = [impl.conf for impl in jnet.impls.values() if hasattr(impl.conf, "decay")]
    for c in bns:
        c.decay = 0.0
    try:
        x = jnp.transpose(jnp.asarray(f), (0, 2, 3, 1))
        return jax.jit(lambda p, s: jnet._apply_graph(p, s, [x], None, True, None)[1])(
            jnet.params, jnet.states)
    finally:
        for c in bns:
            c.decay = 0.9


def _jax_resnet50(compute, tmp_path_factory):
    """The JAX ResNet50 at R50_SHAPE and R50_CLASSES under Adam(R50_LR)
    (f64 parameters under f64 compute) in its well-conditioned state, its
    zip, and one batch of R50_B."""
    conf = JResNet50(num_classes=R50_CLASSES, input_shape=R50_SHAPE, seed=7).conf()
    conf.global_conf.compute_dtype = compute
    conf.global_conf.updater = JAdam(learning_rate=R50_LR)
    if compute == "float64":
        conf.global_conf.dtype = "float64"
    jnet = JGraph(conf).init()
    _perturb(jnet, 7)
    jnet.params = {n: ({**p, "gamma": p["gamma"] * R50_BRANCH_GAMMA} if n.endswith("-c-bn")
                       else p) for n, p in jnet.params.items()}
    jnet.states = _jax_batch_statistics(jnet, _batch(3, R50_STATS_B, R50_SHAPE, R50_CLASSES)[0])
    path = tmp_path_factory.mktemp("r50") / f"resnet50_{compute}.zip"
    ModelSerializer.write_model(jnet, str(path))
    f, l = _batch(2, R50_B, R50_SHAPE, R50_CLASSES)
    return jnet, path, f, l


def _flat(tree):
    return {(n, k): np.asarray(v.detach().double().numpy() if isinstance(v, torch.Tensor) else v,
                               np.float64) for n, d in tree.items() for k, v in d.items()}


def _norm_err(got, want):
    """||got - want|| / ||want|| over every leaf of the two trees at once."""
    got, want = _flat(got), _flat(want)
    return float(np.sqrt(sum(((got[k] - w) ** 2).sum() for k, w in want.items())
                         / sum((w ** 2).sum() for w in want.values())))


def _leaf_err(got, want):
    """The worst leaf's max |got - want| over its largest |want|."""
    got, want = _flat(got), _flat(want)
    return max(float(np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-30))
               for k, w in want.items())


@pytest.fixture(scope="module")
def resnet50_f64(tmp_path_factory):
    """Output, score and gradients of the JAX ResNet50 in f64, and its
    parameters, states and scores after each of STEPS Adam steps."""
    with enable_x64(True):
        jnet, path, f, l = _jax_resnet50("float64", tmp_path_factory)
        ref = {"path": path, "f": f, "l": l, "output": np.asarray(jnet.output(f)),
               "params0": jax.tree_util.tree_map(np.asarray, jnet.params)}
        xs, ls = [jnp.transpose(jnp.asarray(f), (0, 2, 3, 1))], [jnp.asarray(l)]
        loss = jax.jit(jax.value_and_grad(
            lambda p, s: jnet._loss_fn(p, s, xs, ls, None, None, True, None)[0]))
        score, grads = loss(jnet.params, jnet.states)
        ref.update(score=float(score), grads=jax.tree_util.tree_map(np.asarray, grads),
                   steps=[])
        for _ in range(STEPS):
            jnet.fit(JDataSet(f, l))
            ref["steps"].append({"score": float(jnet.score()),
                                 "params": jax.tree_util.tree_map(np.asarray, jnet.params),
                                 "states": jax.tree_util.tree_map(np.asarray, jnet.states)})
    return ref


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def resnet50_lowp(request, tmp_path_factory):
    """The port's ResNet50 in f32 or bf16, restored from the JAX zip, and
    the JAX network, on the port's kinks (recorded by ``KinkPins``,
    replayed by ``_JaxReplay``): inference output and score, training
    score and gradients, and STEPS Adam steps; the distances between the
    two, in ``errors``. Under bf16 the scores and gradients are held
    against the JAX network in f64 on the port's bf16 kinks, since JAX's
    bf16 ones are less accurate than the port's (see the module
    docstring)."""
    compute = request.param
    jnet, path, f, l = _jax_resnet50(compute, tmp_path_factory)
    jstates = jax.tree_util.tree_map(np.asarray, jnet.states)
    net = restore_computation_graph(path, device="cpu")
    restored = ({n: {k: v.clone() for k, v in p.items()} for n, p in net.params.items()},
                {n: {k: v.clone() for k, v in s.items()} for n, s in net.states.items()})
    pins = KinkPins()
    pins.attach(net)
    _JaxReplay(pins).attach(jnet)
    ds, jds = DataSet(f, l), JDataSet(f, l)
    out, jout = net.output(f), np.asarray(jnet.output(f))
    exact = jnet
    if compute == "bfloat16":
        with enable_x64(True):
            conf = JCGConf.from_json(jnet.conf.to_json())
            conf.global_conf.dtype = conf.global_conf.compute_dtype = "float64"
            exact = _JaxReplay(pins).attach(JGraph(conf).init())
            exact.params, exact.states = (
                jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float64), t)
                for t in (jnet.params, jnet.states))
    with enable_x64(compute == "bfloat16"):
        score_inf, jscore_inf = net.score(ds), float(exact.score(jds))
        grads, score = net.compute_gradient_and_score(ds)
        jgrads, jscore = exact.compute_gradient_and_score(jds)
        jgrads, jscore = jax.tree_util.tree_map(np.asarray, jgrads), float(jscore)
    params0 = _flat(net.params)
    steps = []
    for _ in range(STEPS):
        net.fit(ds)
        jnet.fit(jds)
        steps.append({"score": net.score(), "jscore": float(jnet.score()),
                      "states": _leaf_err(net.states, jnet.states)})
    update = {k: v - params0[k] for k, v in _flat(net.params).items()}
    jupdate = {k: v - params0[k] for k, v in _flat(jnet.params).items()}
    errors = {
        "output": float(np.abs(out.numpy() - jout).max()),
        "score_inference": abs(score_inf - jscore_inf) / jscore_inf,
        "score": abs(score - jscore) / jscore,
        "grads_leaf": _leaf_err(grads, jgrads),
        "grads_norm": _norm_err(grads, jgrads),
        "step_scores": max(abs(s["score"] - s["jscore"]) / s["jscore"] for s in steps),
        "states_step1": steps[0]["states"],
        "states": steps[-1]["states"],
        "params_max": max(float(np.abs(update[k] - u).max()) for k, u in jupdate.items()),
        "update_norm": float(np.sqrt(sum(((update[k] - u) ** 2).sum() for k, u in jupdate.items())
                                     / sum((u ** 2).sum() for u in jupdate.values())))}
    print(f"ResNet50 {compute} port vs JAX: {errors}")
    return {"compute": compute, "net": net, "path": path, "f": f, "l": l, "errors": errors,
            "restored": restored, "jstates": jstates, "jout": jout,
            "scores": [s["score"] for s in steps]}


def test_resnet50_matches_jax_in_float64(resnet50_f64):
    """output, score and gradients at the f32 tolerances; parameters,
    running statistics and scores after each of three Adam steps."""
    ref = resnet50_f64
    net = restore_computation_graph(ref["path"], device="cpu")
    assert net.params["stem-conv"]["W"].dtype == torch.float64
    f, l = ref["f"], ref["l"]
    out = net.output(f)
    assert out.shape == (R50_B, R50_CLASSES)
    np.testing.assert_allclose(out.numpy(), ref["output"], rtol=0, atol=OUT_ATOL["float32"])
    _compare_grads(net, f, l, ref["grads"], ref["score"],
                   (SCORE_RTOL["float32"], GRAD_TOL["float32"]))
    params0 = _flat(ref["params0"])
    for i, step in enumerate(ref["steps"]):
        net.fit(DataSet(f, l))
        assert abs(net.score() - step["score"]) <= SCORE_RTOL["float32"] * step["score"], i
        _compare_states(net, step["states"], STATE_TOL["float32"])
        update = {k: v - params0[k] for k, v in _flat(net.params).items()}
        jupdate = {k: v - params0[k] for k, v in _flat(step["params"]).items()}
        assert max(float(np.abs(update[k] - u).max()) for k, u in jupdate.items()) \
            <= PARAM_F32_ATOL, i
    assert net.iteration_count == STEPS


def test_resnet50_inference_matches_jax(resnet50_lowp):
    """A JAX-written zip's ``states.bin`` restores every BatchNormalization's
    running mean and var exactly, and the inference output and score, which
    normalise with them, are JAX's on the same kinks; without them they
    would not be."""
    ref = resnet50_lowp
    compute, err = ref["compute"], ref["errors"]
    assert sum(1 for s in ref["jstates"].values() if s) == 53
    params, states = ref["restored"]
    for n, s in ref["jstates"].items():
        assert set(states[n]) == set(s), n
        for k, v in s.items():
            np.testing.assert_array_equal(states[n][k].numpy(), v, err_msg=f"{n}/{k}")
    assert err["output"] <= OUT_ATOL[compute], err
    assert err["score_inference"] <= (SCORE_RTOL[compute] if compute == "float32"
                                      else R50_BF16_SCORE_INFERENCE), err
    fresh = ResNet50(num_classes=R50_CLASSES, input_shape=R50_SHAPE).conf()
    fresh.global_conf.compute_dtype = compute
    plain = type(ref["net"])(fresh).init(params=params, device="cpu")
    assert np.abs(plain.output(ref["f"]).numpy() - ref["jout"]).max() > 0.1


def test_resnet50_trains(resnet50_lowp):
    """Training score and gradients on the same kinks, then three Adam
    steps in f32 or bf16: the score of each step, the running statistics
    after the first and the last, and the parameters' updates; see
    R50_STEP_LIMITS and R50_BF16_GRAD_NORM."""
    ref = resnet50_lowp
    compute, err = ref["compute"], ref["errors"]
    assert err["score"] <= SCORE_RTOL[compute], err
    if compute == "float32":
        assert err["grads_leaf"] <= GRAD_TOL[compute], err
    else:
        assert err["grads_norm"] <= R50_BF16_GRAD_NORM, err
    lims = R50_STEP_LIMITS[compute]
    for q, lim in lims.items():
        assert err[q] <= lim, (q, err)
    assert ref["net"].iteration_count == STEPS and np.isfinite(ref["scores"]).all()
    assert ref["scores"][-1] < ref["scores"][0]


def test_resnet50_num_params_matches_jax():
    want = JResNet50(num_classes=1000, input_shape=(3, 64, 64)).init().num_params()
    assert ResNet50(num_classes=1000).init(device="cpu").num_params() == want == 25_557_032


@pytest.mark.parametrize("model", ["LeNet", "ResNet50"])
def test_configuration_json_round_trips_both_ways(model):
    """A JAX-written configuration decodes in the port and re-encodes
    byte-equal; the port's zoo writes the same bytes, which decode in the
    JAX package and re-encode byte-equal."""
    jcls, cls, jconf_cls, conf_cls = {
        "LeNet": (JLeNet, LeNet, JMLConf, MultiLayerConfiguration),
        "ResNet50": (JResNet50, ResNet50, JCGConf, ComputationGraphConfiguration)}[model]
    text = jcls(num_classes=10).conf().to_json()
    assert conf_cls.from_json(text).to_json() == text
    mine = cls(num_classes=10).conf().to_json()
    assert mine == text
    assert jconf_cls.from_json(mine).to_json() == mine
    if model == "LeNet":
        assert json.loads(mine)["input_preprocessors"] == {
            "4": {"@class": "CnnToFeedForwardPreProcessor", "height": 4, "width": 4,
                  "channels": 50}}
