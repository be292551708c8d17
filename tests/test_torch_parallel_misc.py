"""The rest of the port's parallel package against the JAX package's:
ParallelInference (``inference.py``), the gradient codec and accumulators
(``accumulation.py``), the update transport (``transport.py``), the
TrainingMaster SPI and distributed evaluation (``distributed.py``),
expert parallelism (``expert.py``), ``nlp/distributed.py`` and ``PrefetchDataSetIterator(sharding=)``.
Oracles: ``tests/test_parallel.py``, ``tests/test_moe.py:151,366``,
``tests/test_distributed_eval.py``. The JAX side runs on its 8 virtual
CPU devices, the port on ``cpu`` slots; a process group of two ranks
(gloo) is the one ``slow`` case.

Tolerances: inference rows are the same kernels' on fewer rows, f32:
OUT_ATOL 1e-6; the codec is exact (equal arrays and equal wire bytes);
the expert step computes what the replicated step does (each slot updates
its experts' block): equal parameters; PARAM_ATOL 1e-6 against JAX's
expert step (JAX's own test's limit).
"""
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import (NeuralNetConfiguration as JConf, MultiLayerNetwork as JNet,
                                Sgd as JSgd, Adam as JAdam, DataSet as JDataSet,
                                ListDataSetIterator as JList)
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.parallel import (ParallelInference as JPI, InferenceMode as JMode,
                                         EncodedGradientsAccumulator as JAcc,
                                         EncodingHandler as JHandler,
                                         threshold_encode as jenc, threshold_decode as jdec,
                                         serialize_encoded as jser,
                                         expert_parallel_step as jep, make_mesh as jmake)
from deeplearning4j_tpu.utils.model_serializer import ModelSerializer

from deeplearning4j_torch import DataSet, ListDataSetIterator, PrefetchDataSetIterator
from deeplearning4j_torch.parallel import (
    DistributedDataSetLossCalculator, DistributedEarlyStoppingTrainer,
    DistributedMultiLayerNetwork, EncodedGradientsAccumulator, EncodingHandler, InferenceMode,
    ParallelInference, ParameterAveragingTrainingMaster, PeerFailedError,
    ProcessLocalIterator, SharedTrainingMaster, SparkDl4jMultiLayer, UpdateChannel,
    allgather_objects, batch_sharded, data_parallel_step, deserialize_encoded,
    expert_parallel_step, expert_rules, initialize_distributed, is_chief, make_mesh,
    serialize_encoded, threshold_decode, threshold_encode)
from deeplearning4j_torch.utils.model_serializer import restore_model

CPU8 = ["cpu"] * 8
OUT_ATOL = 1e-6
PARAM_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _jdense(seed=3):
    conf = (JConf.builder().seed(seed).updater(JSgd(learning_rate=1e-2)).activation("tanh")
            .list()
            .layer(jl.DenseLayer(n_in=6, n_out=16))
            .layer(jl.OutputLayer(n_in=16, n_out=4, activation="softmax", loss="mcxent"))
            .build())
    return JNet(conf).init()


def _port(jnet, tmp_path, name="m.zip"):
    path = str(tmp_path / name)
    ModelSerializer.write_model(jnet, path)
    return restore_model(path, device="cpu")


def _x(n, seed=0, d=6):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


# ------------------------------------------------------------ inference
def test_parallel_inference_matches_output_and_jax(tmp_path):
    """SEQUENTIAL over 8 slots: 24 rows padded to a multiple of the slots,
    split, each slot's output, stripped: == output and == JAX's."""
    jn = _jdense()
    net = _port(jn, tmp_path)
    x = _x(21)
    pi = ParallelInference.Builder(net).inference_mode(InferenceMode.SEQUENTIAL).devices(
        CPU8).build()
    got = pi.output(x)
    np.testing.assert_allclose(got.numpy(), net.output(x).numpy(), rtol=0, atol=OUT_ATOL)
    jpi = JPI.Builder(jn).inference_mode(JMode.SEQUENTIAL).build()
    np.testing.assert_allclose(got.numpy(), np.asarray(jpi.output(x)), rtol=0, atol=1e-5)
    assert pi.submit(x[:3]).result(timeout=10).shape == (3, 4)


def test_parallel_inference_batched_timer_drain_and_oversize(tmp_path):
    """BATCHED: 16 examples fill the batch and flush; a lone request flushes
    after the linger; an oversize request runs alone; close(drain) serves
    the queue and a later submit starts the scheduler again."""
    net = _port(_jdense(), tmp_path)
    pi = (ParallelInference.Builder(net).inference_mode(InferenceMode.BATCHED).batch_limit(16)
          .queue_limit(1000).flush_after_ms(25).devices(["cpu"] * 4).build())
    futs = [pi.submit(_x(4, seed=i)) for i in range(4)]
    outs = [f.result(timeout=30) for f in futs]
    for i, o in enumerate(outs):
        np.testing.assert_allclose(o, net.output(_x(4, seed=i)).numpy(), rtol=0,
                                   atol=OUT_ATOL)
    t0 = time.perf_counter()
    assert pi.submit(_x(2)).result(timeout=30).shape == (2, 4)
    assert time.perf_counter() - t0 < 20.0
    big = _x(40, seed=9)
    np.testing.assert_allclose(pi.submit(big).result(timeout=30), net.output(big).numpy(),
                               rtol=0, atol=OUT_ATOL)
    futs = [pi.submit(_x(1, seed=i)) for i in range(3)]
    pi.close(drain=True)
    assert all(f.result(timeout=5).shape == (1, 4) for f in futs)
    assert pi.submit(_x(1)).result(timeout=30).shape == (1, 4)
    pi.close()


def test_parallel_inference_masked_requests_match_output(tmp_path):
    """Masked sequence requests through the slots == ``output`` with the
    mask (the K1 route on the card); unmasked ones alongside."""
    conf = (JConf.builder().seed(4).updater(JSgd(learning_rate=0.1)).list()
            .layer(jl.LSTM(n_in=3, n_out=8, activation="tanh"))
            .layer(jl.RnnOutputLayer(n_in=8, n_out=2, activation="softmax", loss="mcxent"))
            .build())
    net = _port(JNet(conf).init(), tmp_path)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(6, 5, 3)).astype(np.float32)
    m = (np.arange(5)[None, :] < rng.integers(2, 6, (6, 1))).astype(np.float32)
    pi = ParallelInference(net, mode=InferenceMode.BATCHED, devices=["cpu"] * 2,
                           flush_after_ms=5)
    fm, fu = pi.submit(x[:3], mask=m[:3]), pi.submit(x[3:])
    np.testing.assert_allclose(fm.result(timeout=30), net.output(x[:3], mask=m[:3]).numpy(),
                               rtol=0, atol=OUT_ATOL)
    np.testing.assert_allclose(fu.result(timeout=30), net.output(x[3:]).numpy(), rtol=0,
                               atol=OUT_ATOL)
    pi.close()


# ---------------------------------------------------------------- codec
def test_threshold_codec_and_wire_frames_match_jax():
    g = np.random.default_rng(0).normal(scale=1e-3, size=1000).astype(np.float32)
    idx, signs = threshold_encode(g, 1e-3)
    jidx, jsigns = jenc(g, 1e-3)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(signs, jsigns)
    np.testing.assert_array_equal(threshold_decode(idx, signs, 1e-3, (1000,)),
                                  np.asarray(jdec(jidx, jsigns, 1e-3, (1000,))))
    frame = serialize_encoded((idx, signs, 1e-3, 1000))
    assert frame == jser((jidx, jsigns, 1e-3, 1000))
    back = deserialize_encoded(frame)
    np.testing.assert_array_equal(back[0], idx)
    assert back[2] == pytest.approx(1e-3) and back[3] == 1000
    exact = serialize_encoded((idx, g[idx], 0.0, 1000))
    assert exact == jser((jidx, g[jidx], 0.0, 1000))
    with pytest.raises(ValueError, match="bad wire frame"):
        deserialize_encoded(b"\0" * 24)


def test_accumulators_and_handler_follow_jax():
    """Three rounds of store_update on a nested update: the decoded
    updates, the residual (mass conserved), the adapted threshold and the
    peer decode of the wire bytes equal JAX's; threshold 0 is lossless."""
    rng = np.random.default_rng(1)
    ups = [{"0": {"W": rng.normal(scale=2e-3, size=(5, 4)).astype(np.float32),
                  "b": rng.normal(scale=2e-3, size=(4,)).astype(np.float32)}}
           for _ in range(3)]
    acc, jacc = EncodedGradientsAccumulator(1e-3), JAcc(1e-3)
    total = np.zeros(24, np.float32)
    sent = np.zeros(24, np.float32)
    for u in ups:
        d = acc.store_update({k: {n: torch.as_tensor(a) for n, a in v.items()}
                              for k, v in u.items()})
        jd = jacc.store_update(u)
        for n in ("W", "b"):
            np.testing.assert_array_equal(d["0"][n], np.asarray(jd["0"][n]))
        total += np.concatenate([u["0"]["W"].ravel(), u["0"]["b"]])
        sent += np.concatenate([d["0"]["W"].ravel(), d["0"]["b"]])
        assert acc.encoded_bytes() == jacc.encoded_bytes()
        assert acc._handler.threshold == pytest.approx(jacc._handler.threshold)
    np.testing.assert_allclose(sent + acc._residual, total, rtol=0, atol=1e-7)
    peer = acc.decode_payload(acc.serialize_last())
    np.testing.assert_array_equal(peer["0"]["W"], np.asarray(jacc.decode_payload(
        jacc.serialize_last())["0"]["W"]))
    h, jh = EncodingHandler(1e-3, target_sparsity=1e-2), JHandler(1e-3, target_sparsity=1e-2)
    for s in (1e-1, 1e-6, 1e-2):
        g = rng.normal(scale=s, size=500).astype(np.float32)
        h.encode(g), jh.encode(g)
        assert h.threshold == pytest.approx(jh.threshold)
    lossless = EncodedGradientsAccumulator(0.0)
    d = lossless.store_update({"0": {"W": torch.tensor([1e-9, 0.0, -3.0])}})
    np.testing.assert_array_equal(d["0"]["W"], np.float32([1e-9, 0.0, -3.0]))
    assert lossless.lossless and not lossless.has_residual


# ------------------------------------------------------------- transport
def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def test_update_channel_exchanges_frames_and_names_a_dead_peer():
    """Three ranks on localhost: each exchange returns the peers' frames in
    rank order; a closed peer surfaces as PeerFailedError naming it."""
    addrs = [f"127.0.0.1:{p}" for p in _free_ports(3)]
    chans, errs = [None] * 3, []

    def make(r):
        try:
            chans[r] = UpdateChannel(r, addrs, timeout=20)
        except Exception as e:       # surfaced by the assert below
            errs.append(e)
    ts = [threading.Thread(target=make, args=(r,)) for r in range(3)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert not errs, errs
    got = [None] * 3

    def ex(r):
        got[r] = chans[r].exchange(bytes([r]) * (100_000 + r))
    ts = [threading.Thread(target=ex, args=(r,)) for r in range(3)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    for r in range(3):
        assert [f[0] for f in got[r]] == [q for q in range(3) if q != r]
        assert chans[r].stats["bytes_out"]
    chans[1].close()
    with pytest.raises(PeerFailedError) as e:
        chans[0].gather()
    assert e.value.rank == 1 and chans[0].stats["peer_failures"] == {1: 1}
    chans[0].close(), chans[2].close()


# ---------------------------------------------------- masters, evaluation
def test_masters_facades_and_single_process_helpers(tmp_path):
    """ParameterAveraging and Shared masters through the Spark facades on
    a slot mesh (the first == the wrapper's AVERAGING, bit for bit); the
    single-process helpers."""
    rng = np.random.default_rng(3)
    f, l = _x(64, seed=4), np.eye(4, dtype=np.float32)[rng.integers(0, 4, 64)]
    jn = _jdense()
    a, b = _port(jn, tmp_path, "a.zip"), _port(jn, tmp_path, "b.zip")
    SparkDl4jMultiLayer(a, ParameterAveragingTrainingMaster.Builder(32).devices(CPU8)
                        .build()).fit(ListDataSetIterator([DataSet(f, l)]))
    from deeplearning4j_torch.parallel import ParallelWrapper
    ParallelWrapper(b, devices=CPU8).fit(ListDataSetIterator([DataSet(f, l)]))
    for k in a.params:
        for p in a.params[k]:
            assert torch.equal(a.params[k][p], b.params[k][p])
    c = _port(jn, tmp_path, "c.zip")
    master = SharedTrainingMaster.Builder(1e-3).devices(CPU8).build()
    dist = DistributedMultiLayerNetwork(c, master)
    s0 = dist.calculate_score(ListDataSetIterator([DataSet(f, l)]))
    dist.fit(ListDataSetIterator([DataSet(f, l)]), epochs=3)
    assert dist.calculate_score(ListDataSetIterator([DataSet(f, l)])) < s0
    assert master.accumulator.encoded_bytes() > 0
    assert initialize_distributed() is False and is_chief()
    assert allgather_objects({"a": 1}) == [{"a": 1}]
    parts = [list(ProcessLocalIterator(range(7), process_index=p, process_count=3))
             for p in range(3)]
    assert parts == [[0, 3], [1, 4], [2, 5]]
    assert list(ProcessLocalIterator(range(7), process_index=0, process_count=3,
                                     drop_remainder=False)) == [0, 3, 6]


def test_distributed_loss_calculator_and_early_stopping_match_jax(tmp_path):
    from deeplearning4j_torch.earlystopping import (EarlyStoppingConfiguration,
                                                    InMemoryModelSaver,
                                                    MaxEpochsTerminationCondition)
    from deeplearning4j_tpu.earlystopping import MaxEpochsTerminationCondition as JMax
    from deeplearning4j_tpu.earlystopping import EarlyStoppingConfiguration as JConfES
    from deeplearning4j_tpu.earlystopping import LocalFileModelSaver as JSaver
    from deeplearning4j_tpu.parallel import (
        DistributedMultiLayerNetwork as JDist,
        ParameterAveragingTrainingMaster as JPA,
        DistributedDataSetLossCalculator as JCalc,
        DistributedEarlyStoppingTrainer as JTrainer)
    conf = (JConf.builder().seed(2).updater(JSgd(learning_rate=0.1)).activation("tanh").list()
            .layer(jl.DenseLayer(n_in=4, n_out=8))
            .layer(jl.OutputLayer(n_in=8, n_out=3, activation="softmax", loss="mcxent"))
            .build())
    jn = JNet(conf).init()
    net = _port(jn, tmp_path)
    rng = np.random.default_rng(3)
    f = rng.normal(size=(32, 4)).astype(np.float32)
    l = np.eye(3, dtype=np.float32)[(f[:, 0] > 0).astype(int)]
    halves = [(f[:16], l[:16]), (f[16:], l[16:])]
    dist = DistributedMultiLayerNetwork(
        net, ParameterAveragingTrainingMaster(batch_size_per_worker=16, devices=CPU8))
    calc = DistributedDataSetLossCalculator(ListDataSetIterator([DataSet(f, l)]))
    es = EarlyStoppingConfiguration(
        model_saver=InMemoryModelSaver(), score_calculator=calc,
        epoch_termination_conditions=[MaxEpochsTerminationCondition(4)])
    result = DistributedEarlyStoppingTrainer(
        es, dist, ListDataSetIterator([DataSet(*h) for h in halves])).fit()
    jdist = JDist(jn, JPA(batch_size_per_worker=16))
    jcalc = JCalc(JList([JDataSet(f, l)]))
    jes = JConfES(model_saver=JSaver(str(tmp_path / "best")), score_calculator=jcalc,
                  epoch_termination_conditions=[JMax(4)])
    jres = JTrainer(jes, jdist, JList([JDataSet(*h) for h in halves])).fit()
    assert result.total_epochs == jres.total_epochs
    assert result.best_model_score == pytest.approx(jres.best_model_score, rel=1e-5)
    assert calc.calculate_score(net) == pytest.approx(jcalc.calculate_score(jn), rel=1e-5)
    ev = dist.evaluate(ListDataSetIterator([DataSet(f, l)]))
    assert ev.accuracy() == pytest.approx(jdist.evaluate(JList([JDataSet(f, l)])).accuracy())


# --------------------------------------------------------------- experts
@pytest.mark.parametrize("capacity", [0.0, 2.0])
def test_expert_parallel_matches_replicated_and_jax(tmp_path, capacity):
    """The MoE layer's W/b split over 4 expert slots (each holding its
    experts' block of the parameters and updater state, updated a block):
    equal to the replicated step and == JAX's expert step; the dense
    combine (capacity 0) and the capacity dispatch (2.0)."""
    conf = (JConf.builder().seed(21).updater(JAdam(learning_rate=5e-3) if capacity == 0
                                              else JSgd(learning_rate=0.1))
            .activation("identity").list()
            .layer(jl.MoEDenseLayer(n_in=6, n_out=8, num_experts=4, top_k=2,
                                    capacity_factor=capacity, activation="relu"))
            .layer(jl.OutputLayer(n_in=8, n_out=4, activation="softmax", loss="mcxent"))
            .build())
    jn = JNet(conf).init()
    net, ref = _port(jn, tmp_path, "a.zip"), _port(jn, tmp_path, "b.zip")
    rng = np.random.default_rng(5)
    f = rng.normal(size=(16, 6)).astype(np.float32)
    l = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 16)]
    rules = expert_rules(net)
    assert set(rules) == {"^0/W$", "^0/b$"}
    step, place = expert_parallel_step(net, make_mesh(["cpu"] * 4, axes=("expert",)))
    place(net)
    loss, _ = step(f, l)
    if capacity == 0:         # Adam: slot 1 holds expert 1's moments
        assert tuple(step.store.state[(1,)]["0"]["W"][0].shape) == (1, 6, 8)
    step.gather()
    ref.fit(DataSet(f, l))
    assert float(loss) == float(ref.score())
    jstep, jplace = jep(jn, jmake(jax.devices()[:4], axes=("expert",)))
    jplace(jn)
    jp, _, _, jloss = jstep(jn.params, jn.states, jn.updater_state, jnp.asarray(0, jnp.int32),
                            jax.random.PRNGKey(0), jnp.asarray(f), jnp.asarray(l), None, None)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    for k in net.params:
        for p in net.params[k]:
            torch.testing.assert_close(net.params[k][p], ref.params[k][p], rtol=0, atol=0)
            np.testing.assert_allclose(net.params[k][p].numpy(), np.asarray(jp[k][p]),
                                       rtol=1e-4, atol=PARAM_ATOL)


# ------------------------------------------------------------- nlp, prefetch
def test_nlp_distributed_single_process_matches_jax():
    from deeplearning4j_tpu import nlp as jnlp
    from deeplearning4j_torch import nlp as pnlp
    sentences = [f"the cat sat on mat number {i % 5}" for i in range(40)]
    assert pnlp.partition_sentences(sentences, 1, 4) == jnlp.partition_sentences(sentences, 1, 4)
    w = pnlp.DistributedWord2Vec(pnlp.Word2Vec.builder().layer_size(8).window_size(2)
                                 .epochs(2).min_word_frequency(1).seed(1).device("cpu").build())
    w.fit(sentences)
    jw = jnlp.DistributedWord2Vec(jnlp.Word2Vec.builder().layer_size(8).window_size(2)
                                  .epochs(2).min_word_frequency(1).seed(1).build())
    jw.fit(sentences)
    assert w.epochs == 2                       # restored after the per-epoch loop
    np.testing.assert_allclose(w.getWordVector("cat"), np.asarray(jw.getWordVector("cat")),
                               rtol=0, atol=5e-5)
    g = pnlp.DistributedGlove(pnlp.Glove(vector_length=8, window=2, epochs=3, device="cpu"))
    g.fit(sentences)
    jg = jnlp.DistributedGlove(jnlp.Glove(vector_length=8, window=2, epochs=3))
    jg.fit(sentences)
    np.testing.assert_allclose(g.word_vector("mat"), np.asarray(jg.word_vector("mat")),
                               rtol=1e-4, atol=1e-5)
    assert pnlp.SparkWord2Vec is pnlp.DistributedWord2Vec and pnlp.SparkGlove is pnlp.DistributedGlove


def test_prefetch_sharding_places_batches_in_the_slots(tmp_path):
    """PrefetchDataSetIterator(sharding=batch_sharded(mesh)): each batch
    arrives as the slots' shards, which a data_parallel_step takes as they
    are: the same update as from whole batches."""
    rng = np.random.default_rng(6)
    sets = [DataSet(_x(16, seed=s), np.eye(4, dtype=np.float32)[rng.integers(0, 4, 16)])
            for s in range(2)]
    jn = _jdense()
    a, b = _port(jn, tmp_path, "a.zip"), _port(jn, tmp_path, "b.zip")
    mesh = make_mesh(["cpu"] * 4)
    it = PrefetchDataSetIterator(ListDataSetIterator(sets), workers=2,
                                 sharding=batch_sharded(mesh))
    step_a, step_b = data_parallel_step(a, mesh), data_parallel_step(b, mesh)
    try:
        for sb, ds in zip(it, sets):
            assert isinstance(sb.features, list) and len(sb.features) == 4
            assert [tuple(t.shape) for t in sb.features] == [(4, 6)] * 4
            assert sb.num_examples() == 16
            step_a(sb.features, sb.labels)
            step_b(torch.as_tensor(ds.features), torch.as_tensor(ds.labels))
    finally:
        it.shutdown()
    for k in a.params:
        for p in a.params[k]:
            assert torch.equal(a.params[k][p], b.params[k][p])
    with pytest.raises(ValueError, match="does not combine"):
        PrefetchDataSetIterator(ListDataSetIterator(sets), sharding=batch_sharded(mesh),
                                device="cpu")


# --------------------------------------------------------- two processes
_RANK = textwrap.dedent("""
    import sys, numpy as np, torch
    sys.path.insert(0, {repo!r})
    from deeplearning4j_torch import DataSet, ListDataSetIterator
    from deeplearning4j_torch.parallel import (DistributedMultiLayerNetwork,
        ParameterAveragingTrainingMaster, initialize_distributed, allgather_objects)
    from deeplearning4j_torch.utils.model_serializer import restore_model
    rank = int(sys.argv[1])
    assert initialize_distributed({addr!r}, 2, rank, backend="gloo")
    net = restore_model({zip!r}, device="cpu")
    data = np.load({data!r})
    sets = [DataSet(data["f"][i:i + 16], data["l"][i:i + 16]) for i in range(0, 64, 16)]
    DistributedMultiLayerNetwork(net, ParameterAveragingTrainingMaster(devices=["cpu"] * 2)
                                 ).fit(ListDataSetIterator(sets))
    flat = torch.cat([p.reshape(-1) for d in net.params.values() for p in d.values()])
    got = allgather_objects(flat.numpy())
    assert np.array_equal(got[0], got[1])
    np.save({out!r} + f"{{rank}}.npy", flat.numpy())
""")


@pytest.mark.slow
def test_two_process_parameter_averaging_matches_one_process(tmp_path):
    """Two ranks (gloo) each training its round-robin half through a
    2-slot mesh, gradients averaged across the processes: the ranks end
    equal, and equal to one process over all four slots."""
    jn = _jdense()
    path = str(tmp_path / "m.zip")
    ModelSerializer.write_model(jn, path)
    rng = np.random.default_rng(8)
    f, l = _x(64, seed=8), np.eye(4, dtype=np.float32)[rng.integers(0, 4, 64)]
    np.savez(str(tmp_path / "d.npz"), f=f, l=l)
    port = _free_ports(1)[0]
    script = _RANK.format(repo=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          addr=f"127.0.0.1:{port}", zip=path, data=str(tmp_path / "d.npz"),
                          out=str(tmp_path / "rank"))
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r)]) for r in range(2)]
    assert [p.wait(timeout=240) for p in procs] == [0, 0]
    r0 = np.load(str(tmp_path / "rank0.npy"))
    one = restore_model(path, device="cpu")
    from deeplearning4j_torch.parallel import ParallelWrapper
    sets = [DataSet(f[i:i + 16], l[i:i + 16]) for i in range(0, 64, 16)]
    ParallelWrapper(one, devices=["cpu"] * 4).fit(ListDataSetIterator([sets[0], sets[2],
                                                                       sets[1], sets[3]]))
    flat = torch.cat([p.reshape(-1) for d in one.params.values() for p in d.values()]).numpy()
    np.testing.assert_allclose(r0, flat, rtol=0, atol=1e-6)
