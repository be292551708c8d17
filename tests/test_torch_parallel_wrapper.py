"""ParallelWrapper of the port (``deeplearning4j_torch/parallel/wrapper.py``)
against the JAX package's (``deeplearning4j_tpu/parallel/wrapper.py``):
the same networks (JAX-initialised, carried over in the model zip), the
same numpy batches, the JAX side on its 8 virtual CPU devices and the port
on 8 ``cpu`` slots. Oracles: ``tests/test_parallel.py``.

Tolerances: the port reduces the slots' gradients in rank order where
XLA's partitioner sums the global batch, so f32 results part by rounding
(PARAM_ATOL, measured 1e-10 to 2e-7 on these nets); local SGD and TBPTT
add a few more steps of it. SHARED_GRADIENTS quantizes each update to
+-threshold, so a rounding difference can flip an entry across the
threshold: its trajectory is held to SHARED_ATOL = 2 x threshold.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import (NeuralNetConfiguration as JConf, MultiLayerNetwork as JNet,
                                Sgd as JSgd, Adam as JAdam, DataSet as JDataSet,
                                ListDataSetIterator as JList)
from deeplearning4j_tpu.nn.conf import BackpropType as JBackprop
from deeplearning4j_tpu.nn.conf.graph import MergeVertex as JMerge
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.parallel import (ParallelWrapper as JPW, TrainingMode as JTM,
                                         EncodedGradientsAccumulator as JAcc)
from deeplearning4j_tpu.utils.model_serializer import ModelSerializer

from deeplearning4j_torch import DataSet, ListDataSetIterator, MultiDataSet
from deeplearning4j_torch.nn.conf import CacheMode
from deeplearning4j_torch.parallel import (EncodedGradientsAccumulator, ParallelWrapper,
                                           TrainingMode)
from deeplearning4j_torch.utils.model_serializer import restore_model

SLOTS = ["cpu"] * 8
PARAM_ATOL = 1e-5
SHARED_THRESHOLD = 1e-3
SHARED_ATOL = 2 * SHARED_THRESHOLD


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _dense(seed=3, lr=1e-2, updater=None):
    conf = (JConf.builder().seed(seed).updater(updater or JSgd(learning_rate=lr))
            .activation("tanh").list()
            .layer(jl.DenseLayer(n_in=6, n_out=16))
            .layer(jl.DenseLayer(n_in=16, n_out=16))
            .layer(jl.OutputLayer(n_in=16, n_out=4, activation="softmax", loss="mcxent"))
            .build())
    return JNet(conf).init()


def _lstm(seed=29, lr=1e-2):
    conf = (JConf.builder().seed(seed).updater(JSgd(learning_rate=lr)).list()
            .backprop_type(JBackprop.TruncatedBPTT)
            .t_bptt_forward_length(4).t_bptt_backward_length(4)
            .layer(jl.LSTM(n_in=3, n_out=8, activation="tanh"))
            .layer(jl.RnnOutputLayer(n_in=8, n_out=2, activation="softmax", loss="mcxent"))
            .build())
    return JNet(conf).init()


def _port(jnet, tmp_path, name="m.zip"):
    path = str(tmp_path / name)
    ModelSerializer.write_model(jnet, path)
    return restore_model(path, device="cpu")


def _data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 6)).astype(np.float32),
            np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)])


def _seq(n=16, T=8, seed=31):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(n, T, 3)).astype(np.float32)
    l = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (n, T))]
    m = (np.arange(T)[None, :] < rng.integers(3, T + 1, (n, 1))).astype(np.float32)
    return f, l, m


def _close(net, jnet, atol=PARAM_ATOL):
    worst = 0.0
    for k in jnet.params:
        for p in jnet.params[k]:
            worst = max(worst, float(np.abs(np.asarray(jnet.params[k][p])
                                            - net.params[k][p].double().numpy()).max()))
    assert worst <= atol, worst
    return worst


def _both(tmp_path, make=_dense, **kw):
    j = make(**kw)
    return j, _port(j, tmp_path)


# ---------------------------------------------------------------- AVERAGING
def test_sync_matches_single_device_and_jax(tmp_path):
    """AVERAGING freq=1 over 8 slots == one net's step on the global batch,
    and == the JAX wrapper over 8 devices."""
    f, l = _data(64)
    jn, net = _both(tmp_path)
    single = _port(jn, tmp_path, "s.zip")
    JPW.Builder(jn).workers(8).training_mode(JTM.AVERAGING).build().fit(JList([JDataSet(f, l)]))
    pw = (ParallelWrapper.Builder(net).devices(SLOTS).training_mode(TrainingMode.AVERAGING)
          .averaging_frequency(1).build())
    assert pw.workers_ == 8 and pw.mesh.shape == {"data": 8}
    pw.fit(ListDataSetIterator([DataSet(f, l)]))
    single.fit(DataSet(f, l))
    _close(net, jn)
    for k in net.params:
        for p in net.params[k]:
            torch.testing.assert_close(net.params[k][p], single.params[k][p], rtol=0,
                                       atol=PARAM_ATOL)


def test_local_sgd_averages_params_and_updater_state_like_jax(tmp_path):
    """averaging_frequency=2 with Adam: each slot trains a replica on its
    shards, then parameters AND Adam's moments are averaged (JAX's pmean)."""
    batches = [_data(32, seed=i) for i in range(8)]
    jn, net = _both(tmp_path, updater=JAdam(learning_rate=5e-2))
    JPW.Builder(jn).workers(8).averaging_frequency(2).build().fit(
        JList([JDataSet(*b) for b in batches]), epochs=2)
    pw = ParallelWrapper.Builder(net).devices(SLOTS).averaging_frequency(2).build()
    pw.fit(ListDataSetIterator([DataSet(*b) for b in batches]), epochs=2)
    assert net.iteration_count == jn.iteration_count == 8 // 2 * 2 * 2
    assert np.isfinite(pw.last_score)
    _close(net, jn, atol=1e-5)
    m_port = net.updater_state["0"]["W"][0].numpy()
    m_jax = np.asarray(jn.updater_state["0"]["W"][0])
    np.testing.assert_allclose(m_port, m_jax, rtol=0, atol=1e-6)


def test_shared_gradients_follows_jax_and_encodes(tmp_path):
    """SHARED_GRADIENTS: the reduced update through the threshold codec
    (residual kept); the trajectory JAX's within SHARED_ATOL, different
    from AVERAGING, converging, with fewer wire bytes than dense."""
    batches = [_data(64, seed=i) for i in range(4)]
    jn, net = _both(tmp_path, seed=11, lr=5e-2)
    avg = _port(jn, tmp_path, "avg.zip")
    jacc = JAcc(initial_threshold=SHARED_THRESHOLD)
    (JPW.Builder(jn).workers(8).training_mode(JTM.SHARED_GRADIENTS).gradients_accumulator(jacc)
     .build().fit(JList([JDataSet(*b) for b in batches]), epochs=3))
    acc = EncodedGradientsAccumulator(initial_threshold=SHARED_THRESHOLD)
    pw = (ParallelWrapper.Builder(net).devices(SLOTS)
          .training_mode(TrainingMode.SHARED_GRADIENTS).gradients_accumulator(acc).build())
    s0 = net.score(DataSet(*batches[0]))
    pw.fit(ListDataSetIterator([DataSet(*b) for b in batches]), epochs=3)
    assert net.score(DataSet(*batches[0])) < s0
    _close(net, jn, atol=SHARED_ATOL)
    ParallelWrapper.Builder(avg).devices(SLOTS).build().fit(
        ListDataSetIterator([DataSet(*b) for b in batches]), epochs=3)
    assert max(float((avg.params[k][p] - net.params[k][p]).abs().max())
               for k in net.params for p in net.params[k]) > 0.0
    dense = sum(p.numel() * 4 for ps in net.params.values() for p in ps.values())
    assert 0 < acc.encoded_bytes() < dense
    assert float(np.abs(acc._residual).sum()) > 0


def test_odd_and_masked_tail_batches_train_unsharded_one_iteration(tmp_path):
    """A group the slots do not divide trains unsharded, one iteration, its
    masks and TBPTT segments as the container's own step (the JAX
    wrapper's ``:697``)."""
    jn, net = _both(tmp_path)
    f, l = _data(13)
    pw = ParallelWrapper(net, devices=SLOTS)
    pw.fit(ListDataSetIterator([DataSet(f, l)]))
    JPW(jn, workers=8).fit(JList([JDataSet(f, l)]))
    assert net.iteration_count == jn.iteration_count == 1
    _close(net, jn)
    jn2, net2 = _both(tmp_path, make=_lstm)
    fs, ls, m = _seq(n=5)
    ParallelWrapper(net2, devices=SLOTS).fit(ListDataSetIterator([DataSet(fs, ls, m, m)]))
    JPW(jn2, workers=8).fit(JList([JDataSet(fs, ls, m, m)]))
    assert net2.iteration_count == jn2.iteration_count == 2       # one per segment
    _close(net2, jn2)


def test_sharded_tbptt_matches_direct_fit_and_jax(tmp_path):
    """A divisible masked TBPTT group: one update a segment, each slot
    carrying its own state, as the container's own fit loop."""
    fs, ls, m = _seq(n=16)
    jn, net = _both(tmp_path, make=_lstm)
    direct = _port(jn, tmp_path, "d.zip")
    JPW.Builder(jn).workers(8).build().fit(JList([JDataSet(fs, ls, m, m)]))
    ParallelWrapper.Builder(net).devices(SLOTS).build().fit(
        ListDataSetIterator([DataSet(fs, ls, m, m)]))
    direct.fit(DataSet(fs, ls, m, m))
    assert net.iteration_count == jn.iteration_count == direct.iteration_count == 2
    _close(net, jn)
    for k in net.params:
        for p in net.params[k]:
            torch.testing.assert_close(net.params[k][p], direct.params[k][p], rtol=0,
                                       atol=PARAM_ATOL)


def test_shared_gradients_and_local_sgd_under_tbptt(tmp_path):
    """SHARED_GRADIENTS x TBPTT: one codec round a segment update; local
    SGD x TBPTT: segments count as iterations of each micro-batch."""
    fs, ls, m = _seq(n=16)
    jn, net = _both(tmp_path, make=_lstm)
    acc = EncodedGradientsAccumulator(initial_threshold=1e-4)
    pw = ParallelWrapper(net, devices=SLOTS, training_mode=TrainingMode.SHARED_GRADIENTS,
                         accumulator=acc)
    s0 = net.score(DataSet(fs, ls, m, m))
    pw.fit(ListDataSetIterator([DataSet(fs, ls, m, m)]), epochs=4)
    assert net.iteration_count == 8 and net.score(DataSet(fs, ls, m, m)) < s0
    assert acc.encoded_bytes() > 0
    jn2, net2 = _both(tmp_path, make=_lstm)
    sets = [DataSet(*_seq(n=16, seed=s)[:2]) for s in range(4)]
    JPW(jn2, workers=8, averaging_frequency=2).fit(
        JList([JDataSet(d.features, d.labels) for d in sets]))
    ParallelWrapper(net2, devices=SLOTS, averaging_frequency=2).fit(ListDataSetIterator(sets))
    assert net2.iteration_count == jn2.iteration_count == 4 // 2 * 2 * 2
    _close(net2, jn2)


def test_local_sgd_keeps_masks(tmp_path):
    """Masked micro-batches under local SGD train with their masks: the
    same parameters as JAX's masked run, not as an unmasked one."""
    jn, net = _both(tmp_path, make=_lstm)
    unmasked = _port(jn, tmp_path, "u.zip")
    sets = [_seq(n=16, T=4, seed=s) for s in range(2)]
    JPW(jn, workers=8, averaging_frequency=2).fit(JList([JDataSet(f, l, m, m)
                                                         for f, l, m in sets]))
    ParallelWrapper(net, devices=SLOTS, averaging_frequency=2).fit(
        ListDataSetIterator([DataSet(f, l, m, m) for f, l, m in sets]))
    ParallelWrapper(unmasked, devices=SLOTS, averaging_frequency=2).fit(
        ListDataSetIterator([DataSet(f, l) for f, l, _ in sets]))
    _close(net, jn)
    assert max(float((unmasked.params[k][p] - net.params[k][p]).abs().max())
               for k in net.params for p in net.params[k]) > 1e-6


def test_round_robin_merges_worker_batches(tmp_path):
    """Eight iterator batches of 8 make one global step of 64 (one batch a
    slot), as the reference's round-robin dispatch."""
    f, l = _data(64)
    jn, net = _both(tmp_path)
    whole = _port(jn, tmp_path, "w.zip")
    pw = ParallelWrapper(net, devices=SLOTS)
    pw.fit(ListDataSetIterator([DataSet(f[i:i + 8], l[i:i + 8]) for i in range(0, 64, 8)]))
    assert net.iteration_count == 1 and pw.iteration_count == 1
    ParallelWrapper(whole, devices=SLOTS).fit(ListDataSetIterator([DataSet(f, l)]))
    for k in net.params:
        for p in net.params[k]:
            torch.testing.assert_close(net.params[k][p], whole.params[k][p], rtol=0, atol=0)


def test_computation_graph_streams(tmp_path):
    """A ComputationGraph trains through the wrapper with tuple streams (a
    MultiDataSet), equal to JAX's wrapper on the same graph."""
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
    from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMDS
    gconf = (JConf.builder().seed(5).updater(JSgd(learning_rate=0.05)).activation("tanh")
             .graph_builder().add_inputs("a", "b")
             .add_layer("da", jl.DenseLayer(n_in=6, n_out=8), "a")
             .add_layer("db", jl.DenseLayer(n_in=3, n_out=8), "b")
             .add_vertex("m", JMerge(), "da", "db")
             .add_layer("out", jl.OutputLayer(n_in=16, n_out=4, activation="softmax",
                                              loss="mcxent"), "m")
             .set_outputs("out").build())
    jn = JCG(gconf).init()
    net = _port(jn, tmp_path)
    rng = np.random.default_rng(2)
    a, b = (rng.normal(size=(32, n)).astype(np.float32) for n in (6, 3))
    l = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 32)]
    JPW(jn, workers=8).fit(JList([JMDS([a, b], [l])]))
    ParallelWrapper(net, devices=SLOTS).fit(ListDataSetIterator([MultiDataSet([a, b], [l])]))
    assert net.iteration_count == 1
    _close(net, jn)


def test_integer_ids_keep_their_dtype(tmp_path):
    """Integer features (embedding ids) reach the slots as integers."""
    jconf = (JConf.builder().seed(4).updater(JSgd(learning_rate=0.1)).list()
             .layer(jl.EmbeddingLayer(n_in=10, n_out=5))
             .layer(jl.OutputLayer(n_in=5, n_out=3, activation="softmax", loss="mcxent"))
             .build())
    jn = JNet(jconf).init()
    net = _port(jn, tmp_path)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 10, (16, 1)).astype(np.int32)
    l = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    pw = ParallelWrapper(net, devices=SLOTS)
    fs, _, _, _ = pw._global_batch([DataSet(ids, l)])
    assert all(not t.is_floating_point() for t in fs)
    pw.fit(ListDataSetIterator([DataSet(ids, l)]))
    JPW(jn, workers=8).fit(JList([JDataSet(ids, l)]))
    _close(net, jn)


def test_device_cache_reuses_and_evicts(tmp_path, monkeypatch):
    """CacheMode.DEVICE: the sharded global batch is reused across epochs
    (same tensors), and the byte budget evicts least recently used."""
    net = _port(_dense(), tmp_path)
    net.gc.cache_mode = CacheMode.DEVICE
    sets = [DataSet(*_data(16, seed=i)) for i in range(3)]
    pw = ParallelWrapper(net, devices=SLOTS)
    first = pw._global_batch([sets[0]])
    assert pw._global_batch([sets[0]])[0][0] is first[0][0]
    one = pw._sharded_cache_bytes
    pw.sharded_cache_budget = 2 * one
    pw._global_batch([sets[1]])
    pw._global_batch([sets[2]])
    assert len(pw._sharded_batch_cache) == 2 and pw._sharded_cache_bytes <= 2 * one
    assert pw._global_batch([sets[0]])[0][0] is not first[0][0]     # evicted, rebuilt
    pw.clear_device_cache()
    assert pw._sharded_cache_bytes == 0
    monkeypatch.setenv("DL4J_TPU_PW_CACHE_BYTES", "1234")
    assert ParallelWrapper(net, devices=SLOTS).sharded_cache_budget == 1234
    pw.fit(ListDataSetIterator(sets), epochs=2)
    assert net.iteration_count == 2       # the 3 batches make one group an epoch


def test_host_transfer_dtype_bit_identical_under_bf16_compute(tmp_path, caplog):
    """host_transfer_dtype('bfloat16') with bf16 compute: the features are
    rounded on the host, which the layers would do anyway: bit-equal
    parameters; with f32 compute it warns that results change."""
    jn = _dense(updater=JAdam(learning_rate=1e-2))
    jn.conf.global_conf.compute_dtype = "bfloat16"
    a, b = _port(jn, tmp_path, "a.zip"), _port(jn, tmp_path, "b.zip")
    f, l = _data(32)
    ParallelWrapper(a, devices=SLOTS).fit(ListDataSetIterator([DataSet(f, l)]))
    ParallelWrapper(b, devices=SLOTS, host_transfer_dtype="bfloat16").fit(
        ListDataSetIterator([DataSet(f, l)]))
    for k in a.params:
        for p in a.params[k]:
            assert torch.equal(a.params[k][p], b.params[k][p])
    c = _port(_dense(), tmp_path, "c.zip")
    with caplog.at_level("WARNING"):
        ParallelWrapper(c, devices=SLOTS, host_transfer_dtype="bfloat16").fit(
            ListDataSetIterator([DataSet(f, l)]))
    assert "rounded BEFORE" in caplog.text
