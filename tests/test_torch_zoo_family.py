"""AlexNet, VGG16, VGG19, GoogLeNet, InceptionResNetV1 and FaceNetNN4Small2
in the port on the CPU, against the JAX package.

For each model: its parameter count at the zoo's own shape (VGG16
138,357,544 and VGG19 143,667,240, as ``tests/test_zoo.py`` states; the
others the JAX model's), counted from the configuration without allocating
the port's parameters; its configuration JSON both ways, byte for byte;
and its output, score and gradients through a JAX-written zip at a small
input (VGG and FaceNet 3x32x32, AlexNet 3x64x64, the smallest its pools
take, InceptionResNetV1 3x64x64 with one block of each kind, GoogLeNet
3x32x32; 5 classes, b=2), in float64 at 1e-9 (max |port - jax| over max
|jax|; the deepest model sums over 25 layers). Parameters that init sets to
constants (biases) are moved off them, and FaceNet's centres are set to
random values, so that ``states.bin`` matters.

Two things of the JAX reference on the CPU shape the comparison:

- its f64 max-pool VJP drops some windows' cotangents
  (``test_torch_cnn_family.py::test_subsampling1d_matches_jax``), and every
  model here max-pools. So gradients are compared on the port's kinks: the
  port records its ReLU signs and max-pool picks (``utils/kink_pins.py``)
  and the JAX net replays them (``_JaxReplay``: ReLU as x * mask, the pool
  as a gather at the recorded cells), so that no max-pool VJP of JAX runs
  and both differentiate the same piece;
- GoogLeNet's JAX gradient takes 37-43 s to compile on one core, so it is
  held by its output and score against JAX, and its gradient by the
  port's own central differences along two random directions on its
  pinned kinks (step 1e-4, 1e-7 relative: the loss is smooth there).

Then the new layers in the containers, against the JAX package: every new
config class's JSON both ways; CenterLossOutputLayer's score, gradients
and centres after 3 fit steps in both containers (float64, SGD: 1e-10
before the first step, then 1e-8 on scores, since the centres are f32
state in both packages and part in their last bits; float32, Adam: 1e-5 on
scores, 1e-4 on gradients; the centres 1e-6); two small networks of the
new layers through a JAX-written zip (output, score and gradients in
float64 at 1e-10) and back through the port's zip into the JAX package,
bit for bit; and bf16 parameters carried as uint16 bits.

The layers themselves are held in ``test_torch_cnn_family.py``. Each file
has at most 27 tests, fewer than ``test_monitor.py``'s 28, so that xdist's
largest-first file order hands out every file up to ``test_monitor.py``
as it did before them (ROADMAP Queue C, "intermittent").
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu import Adam as JAdam
from deeplearning4j_tpu import Sgd as JSgd
from deeplearning4j_tpu.compat import enable_x64
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration as JMLConf
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf import serde as jserde
from deeplearning4j_tpu.nn.conf.graph import ComputationGraphConfiguration as JCGConf
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.utils.model_serializer import ModelSerializer

from deeplearning4j_torch import DataSet
from deeplearning4j_torch.models import zoo
from deeplearning4j_torch.nn.conf import ComputationGraphConfiguration, MultiLayerConfiguration
from deeplearning4j_torch.nn.conf import layers as pl
from deeplearning4j_torch.nn.conf import serde
from deeplearning4j_torch.nn.conf.layers import ConvolutionMode, Layer, _pair
from deeplearning4j_torch.nn.layers import impl_for
from deeplearning4j_torch.nn.layers.convolution import same_pads
from deeplearning4j_torch.utils.kink_pins import KinkPins
from deeplearning4j_torch.utils.model_serializer import (restore_computation_graph,
                                                         restore_multi_layer_network,
                                                         write_model)

from test_torch_cnn_family import GRAD_TOL, OUT_TOL, POLICY, SAME, _rel

TOL = 1e-9
CLASSES, B = 5, 2
# name: (small input, extra builder arguments)
SMALL = {
    "alexnet": ((3, 64, 64), {}),
    "vgg16": ((3, 32, 32), {}),
    "vgg19": ((3, 32, 32), {}),
    "googlenet": ((3, 32, 32), {}),
    "inceptionresnetv1": ((3, 64, 64), {"blocks_a": 1, "blocks_b": 1, "blocks_c": 1}),
    "facenetnn4small2": ((3, 32, 32), {"embedding_size": 16}),
}
KNOWN_PARAMS = {"vgg16": 138_357_544, "vgg19": 143_667_240}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _counted(conf) -> int:
    """The port's parameter count of ``conf`` from its layers' parameter
    shapes, without allocating them."""
    if isinstance(conf, ComputationGraphConfiguration):
        conf.infer_shapes()
        layers = [v for v in conf.vertices.values() if isinstance(v, Layer)]
    else:
        layers = conf.layers
    return sum(int(np.prod(shape)) for layer in layers
               for shape in impl_for(layer, conf.global_conf).param_shapes().values())


@pytest.mark.parametrize("name", sorted(SMALL))
def test_num_params_at_the_zoo_shape(name):
    want = KNOWN_PARAMS.get(name)
    if want is None:
        want = jzoo.ZOO[name]().init().num_params()
    assert _counted(zoo.ZOO[name]().conf()) == want


@pytest.mark.parametrize("name", sorted(SMALL))
def test_configuration_json_round_trips_both_ways(name):
    """The JAX zoo's configuration decodes in the port and re-encodes
    byte-equal; the port's zoo writes the same bytes, which decode in the
    JAX package and re-encode byte-equal."""
    text = jzoo.ZOO[name]().conf().to_json()
    conf_cls, jconf_cls = ((MultiLayerConfiguration, JMLConf) if name in ("alexnet", "vgg16",
                                                                         "vgg19")
                           else (ComputationGraphConfiguration, JCGConf))
    assert conf_cls.from_json(text).to_json() == text
    mine = zoo.ZOO[name]().conf().to_json()
    assert mine == text
    assert jconf_cls.from_json(mine).to_json() == mine
    assert json.loads(mine)["global_conf"]["updater"]["@class"] == (
        "Nesterovs" if name == "alexnet" else "Adam")


class _JaxReplay:
    """Replays a port net's recorded kinks (``KinkPins``) in a JAX net of
    either container: ReLU as ``x * mask`` and max pooling (Same or
    Truncate) as a gather at the recorded cells of the padded plane, both
    fetched through a host callback at each execution."""

    def __init__(self, pins):
        self.pins = pins

    def attach(self, jnet):
        impls = (jnet.impls.items() if isinstance(jnet.impls, dict)
                 else ((str(i), impl) for i, impl in enumerate(jnet.impls)))
        for name, impl in impls:
            if getattr(impl, "activation_name", None) == "relu":
                impl.activation = self._relu(name)
            c = impl.conf
            if type(c).__name__ == "SubsamplingLayer" and c.pooling_type == "max":
                impl.forward = self._max_pool(name, c)
        return jnet

    def _fetch(self, table, name, shape, dtype):
        return jax.pure_callback(lambda: np.asarray(table[name].numpy(), dtype),
                                 jax.ShapeDtypeStruct(shape, dtype))

    def _relu(self, name):
        def relu(x):
            return x * self._fetch(self.pins.relu, name, x.shape, np.bool_).astype(x.dtype)
        return relu

    def _max_pool(self, name, c):
        k, s, p = _pair(c.kernel_size), _pair(c.stride), _pair(c.padding)

        def forward(params, state, x, train=False, rng=None, mask=None, ctx=None):
            pads = (same_pads(x.shape[1:3], k, s) if c.convolution_mode == ConvolutionMode.Same
                    else [(pi, pi) for pi in p])
            xp = jnp.pad(x, ((0, 0), *pads, (0, 0)), constant_values=-jnp.inf)
            n, hp, wp, ch = xp.shape
            shape = (n, ch, (hp - k[0]) // s[0] + 1, (wp - k[1]) // s[1] + 1)
            idx = self._fetch(self.pins.pool, name, shape, np.int32)
            y = jnp.take_along_axis(xp.transpose(0, 3, 1, 2).reshape(n, ch, hp * wp),
                                    idx.reshape(n, ch, -1), axis=2)
            return y.reshape(shape).transpose(0, 2, 3, 1), state
        return forward


def _jax_small(name):
    """The JAX model at its small input in f64, its biases moved off their
    constant init (and FaceNet's centres set), with one batch."""
    shape, kw = SMALL[name]
    conf = jzoo.ZOO[name](num_classes=CLASSES, input_shape=shape, seed=3, **kw).conf()
    conf.global_conf.dtype = conf.global_conf.compute_dtype = "float64"
    jnet = (JNet if isinstance(conf, JMLConf) else JGraph)(conf).init()
    rng = np.random.default_rng(4)

    def move(path, v):
        if path[-1].key != "b":
            return v
        return v + jnp.asarray(0.05 * rng.standard_normal(v.shape), v.dtype)
    jnet.params = jax.tree_util.tree_map_with_path(move, jnet.params)
    if name == "facenetnn4small2":
        jnet.states["output"] = {"centers": jnp.asarray(
            0.1 * rng.standard_normal((CLASSES, 16)), jnp.float32)}
    f = rng.standard_normal((B,) + shape).astype(np.float32)
    labels = np.eye(CLASSES, dtype=np.float32)[[1, 3]]
    return jnet, f, labels


def _restored(jnet, path):
    ModelSerializer.write_model(jnet, str(path))
    if isinstance(jnet, JNet):
        return restore_multi_layer_network(path, device="cpu")
    return restore_computation_graph(path, device="cpu")


def _port_directional(net, ds, pins, seed, step=1e-4):
    """(central difference of the loss along a random direction v on the
    port's pinned kinks, <gradient, v>), the direction scaled to each
    parameter's size."""
    pins.record = True
    grads, _ = net.compute_gradient_and_score(ds)
    pins.record = False
    rng = np.random.default_rng(seed)
    params = net._trainable()
    v = {n: {k: torch.from_numpy(rng.standard_normal(tuple(p.shape))) * (p.detach().abs().mean()
                                                                        + 1e-3)
             for k, p in ps.items()} for n, ps in params.items()}
    dot = sum(float((grads[n][k] * v[n][k]).sum()) for n in v for k in v[n])

    def loss_at(t):
        with torch.no_grad():
            for n, ps in params.items():
                for k, p in ps.items():
                    p.add_(t * v[n][k])
            s = net.score(ds, training=True)
            for n, ps in params.items():
                for k, p in ps.items():
                    p.sub_(t * v[n][k])
        return s
    return (loss_at(step) - loss_at(-step)) / (2 * step), dot


@pytest.mark.parametrize("name", sorted(SMALL))
def test_matches_jax_through_the_zip(tmp_path, name):
    """Output, score and gradients (float64) of the port restored from a
    JAX-written zip; FaceNet's centres come through ``states.bin`` and go
    back through the port's zip into the JAX package bit for bit."""
    with enable_x64(True):
        jnet, f, labels = _jax_small(name)
        net = _restored(jnet, tmp_path / f"{name}.zip")
        assert net.num_params() == jnet.num_params()
        assert net.params[next(iter(net.params))]["W"].dtype == torch.float64
        ds, jds = DataSet(f, labels), JDataSet(f, labels)
        pins = KinkPins()
        pins.attach(net)
        out = net.output(f)
        assert tuple(out.shape) == (B, CLASSES)
        assert _rel(out, jnet.output(f)) <= TOL
        if name == "googlenet":
            jscore = float(jnet.score(jds, training=True))
            assert abs(net.score(ds, training=True) - jscore) <= TOL * jscore
            for seed in (0, 1):
                fd, dot = _port_directional(net, ds, pins, seed)
                assert abs(fd - dot) <= 1e-7 * abs(dot), (seed, fd, dot)
            return
        _JaxReplay(pins).attach(jnet)
        grads, score = net.compute_gradient_and_score(ds)       # records the kinks
        jgrads, jscore = jnet.compute_gradient_and_score(jds)    # replays them
        assert abs(score - jscore) <= TOL * abs(jscore)
        assert set(grads) == set(jgrads)
        for n, gs in jgrads.items():
            assert set(grads[n]) == set(gs), n
            for k, g in gs.items():
                assert _rel(grads[n][k], g) <= TOL, (n, k, _rel(grads[n][k], g))
        if name == "facenetnn4small2":
            centers = net.states["output"]["centers"]
            assert centers.dtype == torch.float32
            np.testing.assert_array_equal(centers.numpy(),
                                          np.asarray(jnet.states["output"]["centers"]))
            back = tmp_path / "back.zip"
            write_model(net, back)
            again = ModelSerializer.restore_computation_graph(str(back))
            for tree, jtree in ((again.params, jnet.params), (again.states, jnet.states)):
                for n, d in jtree.items():
                    for k, v in d.items():
                        assert tree[n][k].dtype == v.dtype, (n, k)
                        np.testing.assert_array_equal(np.asarray(tree[n][k]), np.asarray(v))


NEW_CLASSES = {
    "Convolution1DLayer": dict(n_in=3, n_out=4, kernel_size=(5, 5), stride=(2, 2),
                               convolution_mode="same", dropout=0.8),
    "DepthwiseConvolution2D": dict(n_in=3, depth_multiplier=2, kernel_size=(3, 3)),
    "SeparableConvolution2D": dict(n_in=3, n_out=8, depth_multiplier=2, dilation=(2, 1)),
    "Deconvolution2D": dict(n_in=3, n_out=4, kernel_size=(2, 2), stride=(2, 2),
                            has_bias=False),
    "Subsampling1DLayer": dict(pooling_type="pnorm", pnorm=3, kernel_size=(3, 3)),
    "Upsampling2D": dict(size=(2, 3)),
    "Upsampling1D": dict(size=4),
    "ZeroPaddingLayer": dict(padding=(1, 2, 3, 4)),
    "ZeroPadding1DLayer": dict(padding=(1, 2)),
    "Cropping2D": dict(cropping=(1, 0, 2, 0)),
    "SpaceToDepthLayer": dict(block_size=3),
    "LocalResponseNormalization": dict(n=4.0, k=1.0, alpha=2e-4, beta=0.5),
    "CenterLossOutputLayer": dict(n_in=16, n_out=5, alpha=0.1, lambda_=1e-3,
                                  gradient_check=True, activation="softmax"),
}


def test_layer_config_json_round_trips_both_ways():
    """Each new layer class: a JAX-written layer decodes in the port and
    re-encodes byte-equal; the port's own writes the same bytes, which
    decode in the JAX package and re-encode byte-equal."""
    for name, kw in NEW_CLASSES.items():
        text = jserde.to_json(getattr(jl, name)(**kw))
        mine = serde.from_json(text)
        assert type(mine).__name__ == name
        assert serde.to_json(mine) == text, name
        assert serde.to_json(getattr(pl, name)(**kw)) == text, name
        assert jserde.to_json(jserde.from_json(text)) == text, name


def _center_loss_batch(dtype, b=12, n_in=6, classes=5):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((b, n_in)).astype(np.float32)
    labels = np.eye(classes, dtype=np.float32)[rng.choice([0, 1, 3], b)]   # 2 and 4 absent
    return x, labels


def _center_loss_net(container, dtype):
    pdt, cdt = POLICY[dtype]
    upd = JSgd(learning_rate=0.1) if dtype == "float64" else JAdam(learning_rate=1e-2)
    b = JConf.builder().seed(4).updater(upd)
    dense = jl.DenseLayer(n_in=6, n_out=8, activation="tanh")
    out = jl.CenterLossOutputLayer(n_in=8, n_out=5, activation="softmax", alpha=0.3,
                                   lambda_=0.5)
    if container == "MultiLayerNetwork":
        conf = b.list().layer(dense).layer(out).build()
        cls = JNet
    else:
        conf = (b.graph_builder().add_inputs("in").add_layer("dense", dense, "in")
                .add_layer("out", out, "dense").set_outputs("out").build())
        cls = JGraph
    conf.global_conf.dtype, conf.global_conf.compute_dtype = pdt, cdt
    return cls(conf).init()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("container", ["MultiLayerNetwork", "ComputationGraph"])
def test_center_loss_matches_jax_over_three_fit_steps(tmp_path, container, dtype):
    """The score (softmax loss + lambda x the center loss), its gradients
    (none to the centres), and after each of 3 fit steps the score and the
    centres, which move only for the classes in the batch; ``output`` is
    the plain softmax. Nothing but a fit step moves the centres."""
    tol_s, tol_g = (1e-10, 1e-10) if dtype == "float64" else (1e-5, 1e-4)
    # the centres are f32 state in both packages, f64 net or not: after a
    # step their last bits part (XLA and torch sum the class means in
    # another order), and through lambda they move an f64 score by ~3e-10
    tol_c, tol_step = 1e-6, max(tol_s, 1e-8)
    with enable_x64(dtype == "float64"):
        jnet = _center_loss_net(container, dtype)
        path = tmp_path / "cl.zip"
        ModelSerializer.write_model(jnet, str(path))
        restore = (restore_multi_layer_network if container == "MultiLayerNetwork"
                   else restore_computation_graph)
        net = restore(path, device="cpu")
        key = "1" if container == "MultiLayerNetwork" else "out"
        x, labels = _center_loss_batch(dtype)
        ds, jds = DataSet(x, labels), JDataSet(x, labels)
        assert net.states[key]["centers"].dtype == torch.float32
        assert not net.states[key]["centers"].any()
        jgrads, jscore = jnet.compute_gradient_and_score(jds)
        grads, score = net.compute_gradient_and_score(ds)
        assert abs(score - float(jscore)) <= tol_s * abs(float(jscore))
        for n, gs in jgrads.items():
            for k, g in gs.items():
                assert _rel(grads[n][k], g) <= tol_g, (n, k)
        assert abs(net.score(ds, training=True) - score) <= 1e-12 * score
        assert not net.states[key]["centers"].any()
        for step in range(3):
            net.fit(ds)
            jnet.fit(jds)
            js = float(jnet.score(jds))
            assert abs(net.score(ds) - js) <= tol_step * abs(js), step
            centers = net.states[key]["centers"]
            assert _rel(centers, jnet.states[key]["centers"]) <= tol_c, step
        moved = centers.abs().sum(1) > 0
        assert moved.tolist() == [True, True, False, True, False]
        out = net.output(x)
        assert _rel(out, jnet.output(x)) <= tol_step
        # with the centres far off, the center loss shows in the score
        near = float(jnet.score(jds))
        jnet.states[key] = {"centers": jnp.full_like(jnet.states[key]["centers"], 3.0)}
        net.states[key]["centers"].fill_(3.0)
        js = float(jnet.score(jds))
        assert abs(net.score(ds) - js) <= tol_step * abs(js)
        assert js > near + 1.0


def _family_mln(dtype):
    """A MultiLayerNetwork of the new 2-D layers on 3x10x10 images."""
    pdt, cdt = POLICY[dtype]
    conf = (JConf.builder().seed(6).updater(JSgd(learning_rate=0.05)).activation("tanh")
            .list()
            .layer(jl.ZeroPaddingLayer(padding=(1, 0, 0, 1)))
            .layer(jl.ConvolutionLayer(n_out=4, kernel_size=(3, 3), convolution_mode=SAME))
            .layer(jl.LocalResponseNormalization(n=4, alpha=0.1))
            .layer(jl.DepthwiseConvolution2D(depth_multiplier=2, kernel_size=(3, 3),
                                             stride=(2, 2), convolution_mode=SAME))
            .layer(jl.SeparableConvolution2D(n_out=6, kernel_size=(2, 2), dilation=(2, 2),
                                             convolution_mode=SAME))
            .layer(jl.Deconvolution2D(n_out=5, kernel_size=(3, 3), stride=(2, 2),
                                      convolution_mode=SAME))
            .layer(jl.Cropping2D(cropping=(1, 1, 0, 2)))
            .layer(jl.SpaceToDepthLayer(block_size=2))
            .layer(jl.Upsampling2D(size=(1, 2)))
            .layer(jl.SubsamplingLayer(pooling_type="avg", kernel_size=(2, 2), stride=(2, 2)))
            .layer(jl.DenseLayer(n_out=7))
            .layer(jl.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.convolutional(10, 10, 3)).build())
    conf.global_conf.dtype, conf.global_conf.compute_dtype = pdt, cdt
    return JNet(conf).init()


def _family_graph(dtype):
    """A ComputationGraph of the 1-D layers on [b, 12, 3] sequences, and a
    CenterLossOutputLayer."""
    pdt, cdt = POLICY[dtype]
    conf = (JConf.builder().seed(7).updater(JSgd(learning_rate=0.05)).activation("tanh")
            .graph_builder().add_inputs("seq")
            .add_layer("pad", jl.ZeroPadding1DLayer(padding=(2, 1)), "seq")
            .add_layer("conv", jl.Convolution1DLayer(n_out=5, kernel_size=3, stride=2,
                                                     convolution_mode=SAME), "pad")
            .add_layer("pool", jl.Subsampling1DLayer(pooling_type="max", kernel_size=2,
                                                     stride=1, convolution_mode=SAME), "conv")
            .add_layer("up", jl.Upsampling1D(size=2), "pool")
            .add_layer("conv2", jl.Convolution1DLayer(n_out=4, kernel_size=2, dilation=2),
                       "up")
            .add_layer("gap", jl.GlobalPoolingLayer(pooling_type="avg"), "conv2")
            .add_layer("out", jl.CenterLossOutputLayer(n_out=3, activation="softmax",
                                                       lambda_=0.1), "gap")
            .set_outputs("out").set_input_types(JInputType.recurrent(3, 12)).build())
    conf.global_conf.dtype, conf.global_conf.compute_dtype = pdt, cdt
    return JGraph(conf).init()


def _moved(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: v + jnp.asarray(0.1 * rng.standard_normal(v.shape), v.dtype), tree)


@pytest.mark.parametrize("net_kind", ["mln", "graph"])
def test_new_layers_in_networks_through_the_zip(tmp_path, net_kind):
    """Shape inference, the preprocessors and the layers inside both
    containers: a JAX-written zip restores in the port with the same
    configuration, output, score and gradients (float64), and the port's
    zip restores in the JAX package with every array bit for bit."""
    with enable_x64(True):
        jnet = _family_mln("float64") if net_kind == "mln" else _family_graph("float64")
        jnet.params = _moved(jnet.params, 8)
        if net_kind == "graph":
            jnet.states["out"] = {"centers": jnp.asarray(
                np.random.default_rng(9).standard_normal((3, 4)), jnp.float32)}
        path = tmp_path / "family.zip"
        ModelSerializer.write_model(jnet, str(path))
        rng = np.random.default_rng(10)
        if net_kind == "mln":
            f = rng.standard_normal((3, 3, 10, 10)).astype(np.float32)
            net = restore_multi_layer_network(path, device="cpu")
        else:
            f = rng.standard_normal((3, 12, 3)).astype(np.float32)
            net = restore_computation_graph(path, device="cpu")
        labels = np.eye(3, dtype=np.float32)[[0, 2, 1]]
        assert net.conf.to_json() == jnet.conf.to_json()
        assert net.num_params() == jnet.num_params()
        assert _rel(net.output(f), jnet.output(f)) <= OUT_TOL["float64"]
        jgrads, jscore = jnet.compute_gradient_and_score(JDataSet(f, labels))
        grads, score = net.compute_gradient_and_score(DataSet(f, labels))
        assert abs(score - float(jscore)) <= 1e-10 * abs(float(jscore))
        for n, gs in jgrads.items():
            for k, g in gs.items():
                assert _rel(grads[n][k], g) <= GRAD_TOL["float64"], (n, k)
        back = tmp_path / "back.zip"
        write_model(net, back)
        restore = (ModelSerializer.restore_multi_layer_network if net_kind == "mln"
                   else ModelSerializer.restore_computation_graph)
        again = restore(str(back))
        for tree, jtree in ((again.params, jnet.params), (again.states, jnet.states)):
            for n, d in jtree.items():
                for k, v in d.items():
                    assert tree[n][k].dtype == v.dtype, (n, k)
                    np.testing.assert_array_equal(np.asarray(tree[n][k]), np.asarray(v))


def test_bf16_parameters_install_from_uint16_bits(tmp_path):
    """A bf16-parameter JAX net's zip stores its arrays as uint16 bit
    patterns; the port installs the same bf16 values and answers as the
    JAX net does (bf16 tolerance)."""
    conf = (JConf.builder().seed(3).activation("tanh").list()
            .layer(jl.SeparableConvolution2D(n_out=4, kernel_size=(3, 3),
                                             convolution_mode=SAME))
            .layer(jl.Deconvolution2D(n_out=3, kernel_size=(2, 2), stride=(2, 2)))
            .layer(jl.LocalResponseNormalization())
            .layer(jl.OutputLayer(n_out=2, activation="softmax"))
            .set_input_type(JInputType.convolutional(4, 4, 2)).build())
    conf.global_conf.dtype = conf.global_conf.compute_dtype = "bfloat16"
    jnet = JNet(conf).init()
    path = tmp_path / "bf16.zip"
    ModelSerializer.write_model(jnet, str(path))
    with np.load(__import__("zipfile").ZipFile(path).open("coefficients.bin")) as z:
        assert {k for k in z.files} == {f"__bf16__{i}/{k}" for i, d in jnet.params.items()
                                        for k in d}
    net = restore_multi_layer_network(path, device="cpu")
    for i, d in jnet.params.items():
        for k, v in d.items():
            assert net.params[i][k].dtype == torch.bfloat16
            np.testing.assert_array_equal(net.params[i][k].float().numpy(),
                                          np.asarray(v.astype(jnp.float32)))
    f = np.random.default_rng(11).standard_normal((3, 2, 4, 4)).astype(np.float32)
    assert _rel(net.output(f), np.asarray(jnet.output(f).astype(jnp.float32))) <= 3e-2
