"""The parameter server's training hot loop in the port
(``paramserver/overlap.py`` and ``overlap(True)`` of
``paramserver/training.py``) against its oracles in
``tests/test_paramserver_overlap.py``: the comms pipeline's depth-1
contract, the device-to-host copy, the exact (threshold 0) wire frame, a
lossless one-worker run equal to local steps in sync and overlap mode
(``:115``, ``:181``), the quantized overlap loop one update behind the
sync one, failed mass re-injected mid-overlap (``:294``;
the port has no sharded fleet yet, so a client that loses half of each
push stands in for a dead shard server), and the drain at epoch end and
``close``. Networks are JAX-initialised and carried over in the model
zip; every socket binds port 0.
"""
import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import (NeuralNetConfiguration as JConf, MultiLayerNetwork as JNet,
                                Sgd as JSgd)
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.parallel.accumulation import (deserialize_encoded as jdeserialize,
                                                      serialize_encoded as jserialize)
from deeplearning4j_tpu.utils.model_serializer import ModelSerializer

from deeplearning4j_torch import DataSet, ListDataSetIterator
from deeplearning4j_torch.parallel.accumulation import (EncodedGradientsAccumulator,
                                                        deserialize_encoded, serialize_encoded,
                                                        threshold_decode)
from deeplearning4j_torch.paramserver import (CommsPipeline, ParameterServer,
                                              ParameterServerClient,
                                              ParameterServerTrainingMaster, TrainStepPhases,
                                              async_device_get, flatten_params)
from deeplearning4j_torch.paramserver.overlap import start_device_get
from deeplearning4j_torch.utils.model_serializer import restore_model


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _net(tmp_path, seed=11, name="m.zip"):
    conf = (JConf.builder().seed(seed).updater(JSgd(learning_rate=5e-2)).activation("tanh")
            .list().layer(jl.DenseLayer(n_in=6, n_out=16))
            .layer(jl.OutputLayer(n_in=16, n_out=4, activation="softmax", loss="mcxent"))
            .build())
    path = str(tmp_path / name)
    ModelSerializer.write_model(JNet(conf).init(), path)
    return restore_model(path, device="cpu")


def _batches(n=8, seed=3):
    rng = np.random.default_rng(seed)
    return [DataSet(rng.normal(size=(16, 6)).astype(np.float32),
                    np.eye(4, dtype=np.float32)[rng.integers(0, 4, 16)]) for _ in range(n)]


def _master(srv, threshold, **kw):
    return ParameterServerTrainingMaster(srv.address, staleness=0, threshold=threshold,
                                         backoff=0.01, **kw)


def test_comms_pipeline_depth_one_error_and_close():
    with CommsPipeline() as p:
        assert p.drain() is None and not p.inflight()
        gate = threading.Event()
        p.submit(lambda: gate.wait(5.0) and 7, label="a")
        with pytest.raises(RuntimeError, match="undrained"):
            p.submit(lambda: 8, label="b")
        gate.set()
        assert p.drain() == 7
        p.submit(lambda: 1 / 0, label="c")
        with pytest.raises(ZeroDivisionError):
            p.drain()
        assert not p.inflight()
    with pytest.raises(RuntimeError, match="closed"):
        p.submit(lambda: 1)


def test_device_get_and_exact_frames():
    """The copy returns the values (bf16 as f32) and is a copy; an exact
    frame is the JAX package's bytes and decodes bit for bit."""
    tree = {"a": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
            "b": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)}
    got = async_device_get(start_device_get(tree))
    np.testing.assert_array_equal(got["a"]["w"], tree["a"]["w"].numpy())
    assert got["b"].dtype == np.float32 and list(got["b"]) == [1.5, -2.25]
    tree["a"]["w"].add_(1)
    assert got["a"]["w"][0, 0] == 0.0
    idx = np.array([0, 3, 7], np.int32)
    vals = np.array([0.125, -2.5, 1e-8], np.float32)
    blob = serialize_encoded((idx, vals, 0.0, 9))
    assert blob == jserialize((idx, vals, 0.0, 9))
    for dec in (deserialize_encoded, jdeserialize):
        i2, s2, thr, n = dec(blob)
        np.testing.assert_array_equal(s2, vals)
    want = np.zeros(9, np.float32)
    want[idx] = vals
    np.testing.assert_array_equal(threshold_decode(idx, vals, 0.0, (9,)), want)


def _local_steps(net, batches):
    """The plain net's update steps (the container's own step)."""
    for ds in batches:
        f, l, fm, lm = net._tensors(ds)
        net._step(f, l, fm, lm, net.iteration_count)
        net.iteration_count += 1
    return net


@pytest.mark.parametrize("overlap", [False, True])
def test_lossless_one_worker_equals_local_steps(overlap, tmp_path):
    """Threshold 0, staleness 0, one worker: the parameters after 6 steps
    equal a plain net's 6 update steps bit for bit, in sync and overlap
    mode (the fast path applies the device's own update; the adopted pull
    is the server's p - u in f32); 6 pushes land, version 7."""
    batches = _batches(6)
    net, ref = _net(tmp_path, name="a.zip"), _net(tmp_path, name="b.zip")
    with ParameterServer(port=0) as srv:
        m = _master(srv, 0.0, overlap=overlap)
        m.execute_training(net, ListDataSetIterator(batches))
        assert m.accumulator.lossless and not m.accumulator.has_residual
        assert m.client.stats()["version"] == 7
        assert m.client.metrics.snapshot()["counters"]["pushes"] == 6
        phases = m.phases.snapshot()
        assert all(phases["phases"][p]["n"] == 6 for p in TrainStepPhases.PHASES)
        assert 0.0 <= m.phases.hidden_share() <= 1.0
        m.close()
    _local_steps(ref, batches)
    np.testing.assert_array_equal(flatten_params(net.params), flatten_params(ref.params))


def test_overlap_quantized_runs_one_update_behind(tmp_path):
    """Threshold 1e-3: overlap mode lands the same pushes and versions as
    sync mode, but step k+1 computes before step k's decoded update is
    applied at the drain (one step more of staleness, as in JAX), so the
    parameters part from the sync run's by less than the updates' scale."""
    batches = _batches(6)
    nets = [_net(tmp_path, name=f"{i}.zip") for i in range(2)]
    with ParameterServer(port=0) as sa, ParameterServer(port=0) as sb:
        for net, srv, ov in ((nets[0], sa, False), (nets[1], sb, True)):
            m = _master(srv, 1e-3, overlap=ov)
            m.execute_training(net, ListDataSetIterator(batches))
            assert m.client.stats()["version"] == 7
            assert m.client.metrics.snapshot()["counters"]["pushes"] == 6
            m.close()
    diff = np.abs(flatten_params(nets[0].params) - flatten_params(nets[1].params)).max()
    assert 0.0 < diff < 2e-2


class _LosingClient(ParameterServerClient):
    """Delivers half of each pushed update and hands the other half back
    as failed mass, as the sharded client does for a dead shard server."""

    def push_encoded(self, encoded):
        idx, signs, thr, n = encoded
        keep = idx % 2 == 0
        dense = threshold_decode(idx[~keep], signs[~keep], thr, (n,))
        version = self.push_update(serialize_encoded((idx[keep], signs[keep], thr, n)))
        return version, dense


def test_failed_mass_reinjected_mid_overlap(tmp_path):
    net = _net(tmp_path)
    with ParameterServer(port=0) as srv:
        client = _LosingClient(srv.address, staleness=0, max_retries=1, backoff=0.01)
        m = _master(srv, 1e-3, client=client, overlap=True)
        seen = []
        orig = m.accumulator.reinject

        def spy(mass):
            seen.append((threading.current_thread().name, float(np.abs(mass).sum())))
            return orig(mass)

        m.accumulator.reinject = spy
        m.execute_training(net, ListDataSetIterator(_batches(8)))
        m.close()
    assert len(seen) == 8 and max(s for _, s in seen) > 0.0
    assert {t for t, _ in seen} == {"ps-comms"}
    assert m.accumulator.has_residual


def test_overlap_drains_at_epoch_end_and_close_and_is_reusable(tmp_path):
    net = _net(tmp_path)
    with ParameterServer(port=0) as srv:
        client = ParameterServerClient(srv.address, staleness=0, max_retries=2, backoff=0.01)
        m = _master(srv, 1e-3, client=client, overlap=True)
        m.execute_training(net, ListDataSetIterator(_batches(6)))
        assert m._pipeline is not None and not m._pipeline.inflight()
        assert client.metrics.snapshot()["counters"]["pushes"] == 6
        m.execute_training(net, ListDataSetIterator(_batches(6)))
        assert client.metrics.snapshot()["counters"]["pushes"] == 12
        m.close()
        assert m._pipeline is None and m.client is None
        m.close()
    enc = EncodedGradientsAccumulator(initial_threshold=0.0)
    enc.store_update({"w": np.ones(3, np.float32)})
    assert enc.lossless and enc.last_encoded[1].dtype == np.float32
