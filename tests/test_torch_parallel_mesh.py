"""The mesh substrate of the port (``deeplearning4j_torch/parallel/mesh.py``,
``sharding.py``, ``tensor.py``) against the JAX package's: MeshSpec's
auto-factorisation and loud validation, the ZeRO and tensor-parallel
spec machinery (specs compared as tuples), and the numerics pins of
``tests/test_mesh.py`` and ``tests/test_parallel.py``: DP on a 2-D mesh
bit-equal to its 1-D twin, ZeRO (``weight_update_sharding``/``fsdp``)
bit-equal to replicated DP, DP x TP and the tensor-parallel steps equal
to the replicated ones, JAX's parameters within PARAM_ATOL (the slots'
gradients reduced in rank order against XLA's global batch). The JAX
side runs on its 8 virtual CPU devices, the port on 8 ``cpu`` slots."""
import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import (NeuralNetConfiguration as JConf, MultiLayerNetwork as JNet,
                                Adam as JAdam, DataSet as JDataSet,
                                ListDataSetIterator as JList)
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.parallel import (ParallelWrapper as JPW, megatron_rules as jrules,
                                         make_mesh as jmake, zero_update_specs as jzero)
from deeplearning4j_tpu.parallel.mesh import (auto_factor as jauto, MeshSpec as JSpec,
                                              mirror_updater_shardings as jmirror)
from deeplearning4j_tpu.utils.model_serializer import ModelSerializer

from deeplearning4j_torch import DataSet, ListDataSetIterator
from deeplearning4j_torch.parallel import (DATA_AXIS, MODEL_AXIS, MeshSpec, P,
                                           ParallelWrapper, TrainingMode, data_parallel_step,
                                           make_mesh, megatron_rules, mesh_block,
                                           require_axes, tensor_parallel_step,
                                           zero_update_specs)
from deeplearning4j_torch.parallel.mesh import (auto_factor, mirror_updater_shardings,
                                                reset_mesh_registry)
from deeplearning4j_torch.utils.model_serializer import restore_model

CPU8 = ["cpu"] * 8
PARAM_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _jadam(seed=7):
    conf = (JConf.builder().seed(seed).updater(JAdam(learning_rate=1e-2)).activation("tanh")
            .list()
            .layer(jl.DenseLayer(n_in=6, n_out=16))
            .layer(jl.DenseLayer(n_in=16, n_out=16))
            .layer(jl.OutputLayer(n_in=16, n_out=4, activation="softmax", loss="mcxent"))
            .build())
    return JNet(conf).init()


_ZIPS = {}


def _adam_net(tmp_path_factory, seed=7):
    """A port net restored from the JAX net's zip (one zip per seed)."""
    if seed not in _ZIPS:
        path = str(tmp_path_factory.mktemp("zips") / f"adam{seed}.zip")
        ModelSerializer.write_model(_jadam(seed), path)
        _ZIPS[seed] = path
    return restore_model(_ZIPS[seed], device="cpu")


def _batches(n=4, size=32, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(size, 6)).astype(np.float32),
             np.eye(4, dtype=np.float32)[rng.integers(0, 4, size)]) for _ in range(n)]


def _fit(net, epochs=3, batches=None, **kw):
    pw = ParallelWrapper(net, **kw)
    pw.fit(ListDataSetIterator([DataSet(*b) for b in batches or _batches()]), epochs=epochs)
    return net, pw


def _equal(a, b, bitexact=True, atol=5e-7):
    for k in a.params:
        for p in a.params[k]:
            if bitexact:
                assert torch.equal(a.params[k][p], b.params[k][p]), (k, p)
            else:
                torch.testing.assert_close(a.params[k][p], b.params[k][p], rtol=1e-6, atol=atol)


def _specs(tree):
    """A Sharding tree (either package) as {keypath: spec tuple}."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else str(k))
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}" if path else str(i))
        else:
            spec = tuple(getattr(node, "spec", node))
            while spec and spec[-1] is None:
                spec = spec[:-1]
            out[path] = spec
    walk(tree, "")
    return out


# ----------------------------------------------------------- MeshSpec
def test_auto_factor_and_meshspec_match_jax():
    for n, k in ((8, 1), (8, 2), (8, 3), (12, 2), (1, 2), (16, 3), (6, 2)):
        assert auto_factor(n, k) == jauto(n, k)
    for axes, shape in (((DATA_AXIS, MODEL_AXIS), None), ((DATA_AXIS, MODEL_AXIS), (None, 2)),
                        ((DATA_AXIS, MODEL_AXIS), (-1, 4)), ((DATA_AXIS,), None)):
        assert MeshSpec(axes=axes, shape=shape).resolve_shape(8) == \
            JSpec(axes=axes, shape=shape).resolve_shape(8)
    m = make_mesh(CPU8, axes=(DATA_AXIS, MODEL_AXIS))
    assert m.shape == {"data": 4, "model": 2} == dict(jmake(axes=(DATA_AXIS, MODEL_AXIS)).shape)
    assert make_mesh(CPU8, axes=(DATA_AXIS, MODEL_AXIS), shape=(2, 4)).shape == \
        {"data": 2, "model": 4}
    assert make_mesh(CPU8).shape == {"data": 8} and m.size == 8
    assert [str(d) for d in m.axis_devices(DATA_AXIS)] == ["cpu"] * 4


def test_meshspec_validation_is_loud_and_actionable():
    with pytest.raises(ValueError, match="duplicate"):
        MeshSpec(axes=(DATA_AXIS, DATA_AXIS))
    with pytest.raises(ValueError, match="at least one axis"):
        MeshSpec(axes=())
    with pytest.raises(ValueError, match="non-positive"):
        MeshSpec(axes=(DATA_AXIS,), shape=(0,))
    with pytest.raises(ValueError, match="2 extents for 1 axes"):
        MeshSpec(axes=(DATA_AXIS,), shape=(4, 2))
    with pytest.raises(ValueError, match="multiple of 3.*8"):
        MeshSpec(axes=(DATA_AXIS, MODEL_AXIS), shape=(None, 3), devices=CPU8).build()
    with pytest.raises(ValueError, match="covers 4.*8 are available"):
        MeshSpec(axes=(DATA_AXIS, MODEL_AXIS), shape=(2, 2), devices=CPU8).build()
    m = make_mesh(CPU8)
    with pytest.raises(ValueError, match="model.*MeshSpec"):
        require_axes(m, (MODEL_AXIS,), style="composed step")
    assert require_axes(m, (DATA_AXIS, None)) is m
    if not torch.cuda.is_available():      # the default mesh spans the cards
        with pytest.raises(RuntimeError, match="devices=\\['cpu'"):
            make_mesh()


def test_zero_and_mirror_specs_match_jax():
    """zero_update_specs over a base TP split, and the updater state
    mirroring its parameter's spec, give JAX's specs leaf for leaf."""
    from jax.sharding import NamedSharding, PartitionSpec as JP
    jm = jmake(axes=(DATA_AXIS, MODEL_AXIS), shape=(4, 2))
    m = make_mesh(CPU8, axes=(DATA_AXIS, MODEL_AXIS), shape=(4, 2))
    shapes = {"w1": (16, 16), "w0": (6, 16), "b": (3,)}
    base = {"w1": (None, MODEL_AXIS), "w0": (None, MODEL_AXIS), "b": ()}
    jspecs = jzero({k: np.zeros(s) for k, s in shapes.items()}, jm, DATA_AXIS,
                   base={k: NamedSharding(jm, JP(*v)) for k, v in base.items()})
    specs = zero_update_specs({k: torch.zeros(s) for k, s in shapes.items()}, m, DATA_AXIS,
                              base={k: P(*v) for k, v in base.items()})
    assert _specs(specs) == _specs(jspecs)
    assert _specs(zero_update_specs({"w": torch.zeros(16, 16)}, m, DATA_AXIS)) == \
        {"w": (None, DATA_AXIS)}
    jn = _jadam()
    rules, jr = megatron_rules(jn), jrules(jn)
    assert {k: tuple(v) for k, v in rules.items()} == {k: tuple(v) for k, v in jr.items()}
    mm = make_mesh(["cpu"] * 2, axes=(MODEL_AXIS,))
    params = {k: {n: torch.as_tensor(np.asarray(t)) for n, t in d.items()}
              for k, d in jn.params.items()}
    state = {k: {n: tuple(torch.as_tensor(np.asarray(x)) for x in st) for n, st in d.items()}
             for k, d in jn.updater_state.items()}
    got = _specs(mirror_updater_shardings(params, state, mm, rules))
    want = _specs(jmirror(jn.params, jn.updater_state,
                          jmake(jax.devices()[:2], axes=(MODEL_AXIS,)), jr))
    assert got == want and got["0/W/0"] == (None, MODEL_AXIS)


# ------------------------------------------------------------ the pins
def test_2d_dp_and_zero_bit_identical_to_1d_twin_and_jax(tmp_path_factory):
    """DP on a 2-D data x model mesh changes nothing (bit-equal to the 1-D
    twin with the same data extent), ZeRO riding its data axis neither
    (bit-equal), while each slot holds a quarter of the updater state;
    the twin matches JAX's 4-device wrapper."""
    twin, _ = _fit(_adam_net(tmp_path_factory), devices=CPU8, workers=4)
    jn = _jadam()
    JPW(jn, workers=4).fit(JList([JDataSet(*b) for b in _batches()]), epochs=3)
    worst = max(float(np.abs(np.asarray(jn.params[k][p]) - twin.params[k][p].numpy()).max())
                for k in jn.params for p in jn.params[k])
    assert worst <= PARAM_ATOL
    mesh2 = make_mesh(CPU8, axes=(DATA_AXIS, MODEL_AXIS), shape=(4, 2))
    pure, _ = _fit(_adam_net(tmp_path_factory), mesh=mesh2)
    _equal(twin, pure)
    ws, pw = _fit(_adam_net(tmp_path_factory), mesh=mesh2, weight_update_sharding=True)
    _equal(twin, ws)
    full = sum(t.numel() * 4 for _, st in ws.updater_state.items() for d in st.values()
               for t in d)
    assert max(pw._sync_step.slot_bytes.values()) < full / 2
    f, pw = _fit(_adam_net(tmp_path_factory), mesh=mesh2, fsdp=True)
    _equal(twin, f)
    assert pw._sync_step.par_specs["1"]["W"].spec == P(None, DATA_AXIS)


def test_composed_dp_tp_and_zero_match_the_1d_twin(tmp_path_factory):
    """DP x TP on one 2-D mesh: the wrapper drives data while the Megatron
    rules split the model axis; ZeRO takes the dims TP left free. The
    forward runs on gathered parameters, so the composition is bit-equal
    to the 1-D twin."""
    twin, _ = _fit(_adam_net(tmp_path_factory), devices=CPU8, workers=4)
    comp, pw = _fit(_adam_net(tmp_path_factory), devices=CPU8, tensor_parallel=2)
    assert pw.mesh.shape == {"data": 4, "model": 2} and pw.workers_ == 4
    _equal(twin, comp)
    assert pw._sync_step.par_specs["0"]["W"].spec == P(None, MODEL_AXIS)
    ws, pw = _fit(_adam_net(tmp_path_factory), devices=CPU8, tensor_parallel=2,
                  weight_update_sharding=True)
    _equal(twin, ws)
    assert set(pw._sync_step.upd_specs["1"]["W"][0].spec) == {DATA_AXIS, MODEL_AXIS}
    f, pw = _fit(_adam_net(tmp_path_factory), devices=CPU8, tensor_parallel=2, fsdp=True)
    _equal(twin, f)
    assert np.isfinite(f.score(DataSet(*_batches(1)[0])))


def test_wrapper_tp_validation_is_loud(tmp_path_factory):
    net = _adam_net(tmp_path_factory)
    with pytest.raises(NotImplementedError, match="AVERAGING"):
        ParallelWrapper(net, devices=CPU8, tensor_parallel=2, averaging_frequency=2)
    with pytest.raises(NotImplementedError, match="AVERAGING"):
        ParallelWrapper(net, devices=CPU8, tensor_parallel=2,
                        training_mode=TrainingMode.SHARED_GRADIENTS)
    with pytest.raises(ValueError, match=">= 2"):
        ParallelWrapper(net, devices=CPU8, tensor_parallel=1)
    with pytest.raises(ValueError, match="data"):
        ParallelWrapper(net, mesh=make_mesh(["cpu"] * 2, axes=(MODEL_AXIS,)))
    with pytest.raises(ValueError, match="model axis"):
        ParallelWrapper(net, devices=CPU8, tp_rules={"^0/W$": None})
    with pytest.raises(ValueError, match="model extent 2"):
        ParallelWrapper(net, tensor_parallel=4,
                        mesh=make_mesh(CPU8, axes=(DATA_AXIS, MODEL_AXIS), shape=(4, 2)))
    with pytest.raises(ValueError, match="model.*MeshSpec"):
        data_parallel_step(net, make_mesh(CPU8), tp_rules={"^0/W$": P(None, MODEL_AXIS)})


def test_tensor_parallel_steps_match_replicated_and_jax(tmp_path_factory):
    """tensor_parallel_step on a model mesh == the replicated step (and
    JAX's tensor-parallel step); with the ZeRO flags on a data x model
    mesh too; without a data axis the flags reject."""
    from deeplearning4j_tpu.parallel import tensor_parallel_step as jtp
    import jax.numpy as jnp
    f, l = _batches(1, size=16)[0]
    jn = _jadam()
    jstep, jplace = jtp(jn, jmake(jax.devices()[:2], axes=(MODEL_AXIS,)))
    jplace(jn)
    jp, _, _, jloss = jstep(jn.params, jn.states, jn.updater_state, jnp.asarray(0, jnp.int32),
                            jax.random.PRNGKey(0), jnp.asarray(f), jnp.asarray(l), None, None)
    tp, ref = _adam_net(tmp_path_factory), _adam_net(tmp_path_factory)
    step, place = tensor_parallel_step(tp, make_mesh(["cpu"] * 2, axes=(MODEL_AXIS,)))
    place(tp)
    loss, _ = step(f, l)
    step.gather()
    ref.fit(DataSet(f, l))
    assert float(loss) == pytest.approx(float(ref.score()), rel=1e-6)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    _equal(tp, ref, bitexact=False, atol=1e-7)
    for k in jp:
        for p in jp[k]:
            np.testing.assert_allclose(tp.params[k][p].numpy(), np.asarray(jp[k][p]),
                                       rtol=1e-4, atol=1e-5)
    z = _adam_net(tmp_path_factory)
    step, place = tensor_parallel_step(
        z, make_mesh(CPU8, axes=(DATA_AXIS, MODEL_AXIS), shape=(4, 2)), shard_update=True)
    place(z)
    assert np.isfinite(float(step(f, l)[0]))
    assert DATA_AXIS in step.upd_specs["1"]["W"][0].spec
    with pytest.raises(ValueError, match="data"):
        tensor_parallel_step(z, make_mesh(["cpu"] * 2, axes=(MODEL_AXIS,)), shard_update=True)


def test_tensor_parallel_transformer_lm_matches_replicated(tmp_path):
    """megatron_rules on a ComputationGraph (JAX's rules, attention's
    Wq/Wk/Wv column and Wo row parallel), and its step == the replicated
    step."""
    from deeplearning4j_tpu.models import TransformerLM as JLM
    jn = JLM(vocab_size=10, embed_dim=16, num_heads=2, num_blocks=2, seed=17).init()
    path = str(tmp_path / "lm.zip")
    ModelSerializer.write_model(jn, path)
    net, ref = restore_model(path, device="cpu"), restore_model(path, device="cpu")
    rules = megatron_rules(net)
    assert {k: tuple(v) for k, v in rules.items()} == \
        {k: tuple(v) for k, v in jrules(jn).items()}
    assert any("W[qkv]" in r for r in rules)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 10, size=(4, 6)).astype(np.float32)
    l = np.eye(10, dtype=np.float32)[rng.integers(0, 10, (4, 6))]
    step, place = tensor_parallel_step(net, make_mesh(["cpu"] * 2, axes=(MODEL_AXIS,)))
    place(net)
    loss, _ = step((ids,), (l,))
    step.gather()
    ref.fit(DataSet(ids, l))
    assert float(loss) == pytest.approx(float(ref.score()), rel=1e-6)
    _equal(net, ref, bitexact=False, atol=1e-7)


def test_profile_mesh_block_reports_active_topology(tmp_path_factory):
    reset_mesh_registry()
    assert mesh_block() == {}
    net, pw = _fit(_adam_net(tmp_path_factory), epochs=1, devices=CPU8, tensor_parallel=2,
                   fsdp=True)
    row = mesh_block()["sharding/dp_step"]
    assert row["axes"] == {"data": 4, "model": 2} and row["devices"] == 8
    assert row["steps"] >= 1 and row["sharded_leaves"] > 0 and row["zero"] is True
    n_leaves = sum(1 for d in net.params.values() for _ in d.values()) + \
        sum(len(st) for d in net.updater_state.values() for st in d.values())
    assert row["sharded_leaves"] + row["replicated_leaves"] == n_leaves
