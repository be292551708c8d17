"""The fit loops' input pipeline on the CPU, against the JAX package.

The semantics of the JAX package's ``tests/test_datasets.py`` (its
CacheMode.DEVICE, prefetch, async-iterator and shape-bucketing cases),
case for case, on the port's ``datasets/`` modules and fit loops:
the cached fit equals the uncached one; reassigning features invalidates
the cache; the graph caches on the caller's DataSet; order under N
workers across epochs; a worker's error arrives in order; dead workers
raise promptly; a dead worker with queued items drains first; a reset in
mid-epoch leaks no threads; put-ahead delivers tensors without mutating
the caller's DataSet, and fits with 0 and 3 workers give bit-identical
parameters; the dials; concurrent pull loses no tail batch and overlaps;
the padding cases, a padded fit equal to the unpadded one, and rank-2
sparse labels. On the CPU the put-ahead is a tensor conversion; the
pinned copies on the side stream run only on the card (``chip_smoke.py``).

Left out: the monitor-metrics cases (``test_pipeline_metrics_populated``,
``test_pipeline_wait_stats_honest_quantiles_on_seconds_geometry``: the
monitor is not ported) and the compile-count cases
(``TestBucketingClosesJitSignatures``' two retrace tests count
``jax.jit`` traces, which the port has none of).

Against the JAX package: a JAX ``MultiLayerNetwork`` and the port
restored from its zip train through their own pipelines on the same
iterator of numpy batches, f32, parameters within 1e-5 absolute (the
tolerance of ``test_torch_training.py``). The normalizers' statistics and
transforms agree within 1e-6, and bytes written by either package load in
the other.

No test bounds wall-clock time; every join and wait has a timeout.
"""
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_torch import (ComputationGraph, DataSet, MultiLayerNetwork,
                                  NeuralNetConfiguration, Sgd)
from deeplearning4j_torch.datasets.bucketing import ShapeBucketingDataSetIterator
from deeplearning4j_torch.datasets.dataset import (ExistingDataSetIterator,
                                                   ListDataSetIterator, MultiDataSet)
from deeplearning4j_torch.datasets.iterators import (AsyncDataSetIterator,
                                                     BenchmarkDataSetIterator,
                                                     EarlyTerminationDataSetIterator,
                                                     MultipleEpochsIterator)
from deeplearning4j_torch.datasets import normalizers, prefetch
from deeplearning4j_torch.datasets.prefetch import PrefetchDataSetIterator, wrap_for_training
from deeplearning4j_torch.nn.conf.layers import LSTM, DenseLayer, OutputLayer, RnnOutputLayer

JOIN_S = 30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _numbered(n, feat=3):
    """n single-example DataSets whose feature value is the index."""
    return [DataSet(np.full((1, feat), i, np.float32),
                    np.eye(2, dtype=np.float32)[[i % 2]]) for i in range(n)]


def _dense_net(seed=7, cache=False, n_in=3, n_out=2):
    b = (NeuralNetConfiguration.builder().seed(seed).updater(Sgd(learning_rate=0.1))
         .activation("tanh"))
    if cache:
        b = b.cache_mode("device")
    conf = (b.list().layer(DenseLayer(n_in=n_in, n_out=8))
            .layer(OutputLayer(n_in=8, n_out=n_out, activation="softmax", loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf).init(device="cpu")


def _flat(net):
    return {f"{i}/{k}": p.clone() for i, ps in net.params.items() for k, p in ps.items()}


def _pipeline_threads():
    return [t for t in threading.enumerate() if t.name.startswith("input-prefetch")]


def _no_pipeline_threads():
    deadline = time.monotonic() + JOIN_S
    while _pipeline_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    return not _pipeline_threads()


def _batches(n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [DataSet(rng.normal(size=(8, 3)).astype(np.float32),
                    np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)]) for _ in range(n)]


# ------------------------------------------------------------ CacheMode.DEVICE
def test_cache_mode_device_same_results_and_cached_transfer():
    rng = np.random.default_rng(0)
    ds = DataSet(rng.normal(size=(16, 4)).astype(np.float32),
                 np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)])
    a, b = _dense_net(cache=True, n_in=4, n_out=3), _dense_net(n_in=4, n_out=3)
    for _ in range(5):
        a.fit(ds)
        b.fit(ds)
    for k, p in _flat(b).items():
        assert torch.equal(_flat(a)[k], p), k
    first = ds.device_arrays(a.device)
    assert all(x is y for x, y in zip(first, ds.device_arrays(a.device)))
    assert ds._dev is ds._device_entry(a.device)        # one copy, kept across fits


def test_cache_mode_device_invalidated_by_reassign_not_by_write_in_place():
    ds = DataSet(np.ones((4, 3), np.float32), np.eye(2, dtype=np.float32)[[0, 1, 0, 1]])
    first = ds.device_arrays("cpu")
    ds.features[0, 0] = 5.0                        # same buffer: not detected
    assert ds.device_arrays("cpu")[0] is first[0]
    normalizers.ImagePreProcessingScaler(max_pixel=0.5).transform(ds)   # reassigns
    second = ds.device_arrays("cpu")
    assert second[0] is not first[0]
    assert float(second[0][1, 1]) == 2.0


def test_cache_mode_device_computation_graph_caches_on_dataset():
    g = (NeuralNetConfiguration.builder().seed(3).updater(Sgd(learning_rate=0.1))
         .activation("tanh").cache_mode("device").graph_builder().add_inputs("in"))
    g.add_layer("d", DenseLayer(n_in=4, n_out=8), "in")
    g.add_layer("out", OutputLayer(n_in=8, n_out=3, activation="softmax", loss="mcxent"), "d")
    g.set_outputs("out")
    net = ComputationGraph(g.build()).init(device="cpu")
    rng = np.random.default_rng(1)
    ds = DataSet(rng.normal(size=(8, 4)).astype(np.float32),
                 np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)])
    net.fit(ds)
    first = ds._dev
    net.fit(ds)
    assert ds._dev is first                          # cached across fits, on the DataSet
    assert first.arrays[0].dtype == torch.float32


# ------------------------------------------------------------------- prefetch
class TestPrefetch:
    def test_order_preserved_under_n_workers_across_epochs(self):
        pf = PrefetchDataSetIterator(ListDataSetIterator(_numbered(50)), workers=4)
        try:
            for _ in range(2):          # __iter__ resets: a fresh epoch
                assert [float(ds.features[0, 0]) for ds in pf] == [float(i) for i in range(50)]
        finally:
            pf.shutdown()

    def test_worker_exception_propagates_in_order(self):
        class Boom(ListDataSetIterator):
            def __next__(self):
                if self._pos == 5:
                    raise ValueError("boom")
                return super().__next__()

        pf = PrefetchDataSetIterator(Boom(_numbered(20)), workers=3)
        seen = []
        try:
            with pytest.raises(ValueError, match="boom"):
                for ds in pf:
                    seen.append(float(ds.features[0, 0]))
            assert seen == [0.0, 1.0, 2.0, 3.0, 4.0]
        finally:
            pf.shutdown()

    def test_transform_and_put_errors_arrive_in_order(self):
        def transform(ds):
            if float(ds.features[0, 0]) == 3.0:
                raise OSError("decode failed")
            return ds

        pf = PrefetchDataSetIterator(ListDataSetIterator(_numbered(10)), workers=3,
                                     transform=transform, device="cpu")
        seen = []
        try:
            with pytest.raises(OSError, match="decode failed"):
                for ds in pf:
                    seen.append(float(ds.features[0, 0]))
            assert seen == [0.0, 1.0, 2.0]
        finally:
            pf.shutdown()

    def test_dead_workers_raise_promptly_instead_of_hanging(self):
        """All workers dying without an end-of-stream marker surfaces as an
        error on the consumer: the consumer, run on a thread, is done well
        inside its join's timeout (each wait is bounded by _POLL_S)."""
        pf = PrefetchDataSetIterator(ListDataSetIterator(_numbered(4)), workers=2)
        pf._worker_loop = lambda ep: None       # dies at once, marks nothing
        raised = []

        def consume():
            try:
                next(iter(pf))
            except RuntimeError as e:
                raised.append(str(e))

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        t.join(timeout=JOIN_S)
        assert not t.is_alive()
        assert raised and "workers died" in raised[0]
        pf.shutdown()

    def test_reset_mid_epoch_no_leaked_threads(self):
        assert _no_pipeline_threads()
        pf = PrefetchDataSetIterator(ListDataSetIterator(_numbered(30)), workers=4)
        it = iter(pf)
        for _ in range(3):
            next(it)
        pf.reset()                          # mid-epoch: the old workers are joined
        assert [float(ds.features[0, 0]) for ds in pf] == [float(i) for i in range(30)]
        pf.shutdown()
        assert _no_pipeline_threads()

    def test_put_ahead_delivers_tensors_and_identical_fit(self, monkeypatch):
        batches = _batches()
        pf = PrefetchDataSetIterator(ListDataSetIterator(list(batches)), workers=2,
                                     device="cpu")
        try:
            ds = next(iter(pf))
            assert isinstance(ds.features, torch.Tensor)    # put ahead of the step
            assert isinstance(ds.labels, torch.Tensor)
            assert isinstance(batches[0].features, np.ndarray)   # caller's DataSet untouched
            assert torch.equal(ds.features, torch.from_numpy(batches[0].features))
        finally:
            pf.shutdown()
        monkeypatch.setenv("DL4J_TPU_PREFETCH_WORKERS", "0")
        a = _dense_net()
        a.fit(ListDataSetIterator(list(batches)), epochs=2)
        monkeypatch.setenv("DL4J_TPU_PREFETCH_WORKERS", "3")
        b = _dense_net()
        b.fit(ListDataSetIterator(list(batches)), epochs=2)
        for k, p in _flat(a).items():
            assert torch.equal(_flat(b)[k], p), k

    def test_put_ahead_keeps_the_synchronous_cast(self):
        """f64 features become the same f32 bits as the synchronous path's
        conversion; integer labels keep their type."""
        f = np.random.default_rng(2).normal(size=(4, 3))
        ds = DataSet(f, np.arange(4))
        pf = PrefetchDataSetIterator(ListDataSetIterator([ds]), workers=1, device="cpu")
        try:
            got = next(iter(pf))
        finally:
            pf.shutdown()
        net = _dense_net()
        assert got.features.dtype == torch.float32 and got.labels.dtype == torch.int64
        assert torch.equal(got.features, net._to_device(f))
        assert net._to_device(got.features) is got.features     # identity on the view

    def test_concurrent_pull_overlaps_slow_source(self):
        """A pull-thread-safe source is pulled by several workers at once:
        the first pull waits (bounded) for a second one to start, so a
        serialized pull would leave the peak at 1."""
        class SlowSafe(ListDataSetIterator):
            def __init__(self, dsets):
                super().__init__(dsets)
                self._lock = threading.Lock()
                self.in_flight = self.peak = 0
                self.second = threading.Event()

            def __next__(self):
                with self._lock:
                    self.in_flight += 1
                    self.peak = max(self.peak, self.in_flight)
                    if self.in_flight >= 2:
                        self.second.set()
                    first = self._pos == 0
                    if self._pos >= len(self._data):
                        self.in_flight -= 1
                        raise StopIteration
                    d = self._data[self._pos]
                    self._pos += 1
                if first:
                    self.second.wait(timeout=JOIN_S)
                with self._lock:
                    self.in_flight -= 1
                return d

            def concurrent_pull_supported(self):
                return True

        src = SlowSafe(_numbered(30))
        pf = PrefetchDataSetIterator(src, workers=6)
        try:
            got = [float(ds.features[0, 0]) for ds in pf]
        finally:
            pf.shutdown()
        assert sorted(got) == [float(i) for i in range(30)]   # none lost
        assert src.peak >= 2

    def test_concurrent_pull_never_loses_the_tail_batch(self):
        """When workers' next() calls complete out of claim order at the
        stream end, the racing last item is still delivered."""
        class SafeIter(ListDataSetIterator):
            def __init__(self, dsets):
                super().__init__(dsets)
                self._lock = threading.Lock()

            def __next__(self):
                with self._lock:
                    if self._pos >= len(self._data):
                        raise StopIteration
                    d = self._data[self._pos]
                    self._pos += 1
                return d

            def concurrent_pull_supported(self):
                return True

        pf = PrefetchDataSetIterator(SafeIter(_numbered(7)), workers=4)
        try:
            for _ in range(300):
                got = sorted(float(ds.features[0, 0]) for ds in pf)
                assert got == [float(i) for i in range(7)], got
        finally:
            pf.shutdown()

    def test_wrap_for_training_dials(self, monkeypatch):
        base = ListDataSetIterator(_numbered(4))
        monkeypatch.setenv("DL4J_TPU_PREFETCH_WORKERS", "0")
        it, owned = wrap_for_training(base, torch.device("cpu"))
        assert it is base and not owned            # 0: fully synchronous
        monkeypatch.setenv("DL4J_TPU_PREFETCH_WORKERS", "3")
        it, owned = wrap_for_training(base, torch.device("cpu"))
        assert isinstance(it, PrefetchDataSetIterator) and owned
        assert it._workers == 3 and it._device_put and it._qsize == 2
        it.shutdown()
        it2, owned2 = wrap_for_training(AsyncDataSetIterator(base), torch.device("cpu"))
        assert not owned2                          # never wrap an async iterator
        it3, owned3 = wrap_for_training(it, torch.device("cpu"))
        assert it3 is it and not owned3            # nor a pipeline
        monkeypatch.setenv("DL4J_TPU_PUT_AHEAD", "0")
        it4, owned4 = wrap_for_training(base, torch.device("cpu"))
        assert owned4 and not it4._device_put and it4._qsize == 6
        it4.shutdown()
        monkeypatch.setenv("DL4J_TPU_PREFETCH_QUEUE", "5")
        it5, _ = wrap_for_training(base, torch.device("cpu"))
        assert it5._qsize == 5
        it5.shutdown()
        assert wrap_for_training([1, 2], torch.device("cpu")) == ([1, 2], False)

    @pytest.mark.parametrize("cache", [False, True])
    def test_no_pipeline_thread_outlives_a_fit(self, cache):
        net = _dense_net(cache=cache)
        net.fit(ListDataSetIterator(_batches(4)), epochs=2)
        assert _no_pipeline_threads()
        bad = _batches(3)
        bad[1] = DataSet(np.zeros((8, 5), np.float32), bad[1].labels)   # wrong width
        with pytest.raises(RuntimeError):
            net.fit(ListDataSetIterator(bad))
        assert _no_pipeline_threads()

    def test_fit_records_the_wait_for_each_batch(self):
        net = _dense_net()
        assert net.last_etl_ms == 0.0
        net.fit(ListDataSetIterator(_batches(2)))
        assert net.last_etl_ms > 0.0


def test_pinned_staging_ring_reuses_a_buffer_only_after_its_copy(monkeypatch):
    """The put-ahead's staging ring (its copies need the card; its
    bookkeeping does not): at most ``slots`` buffers per shape and type, a
    completed buffer before a new one or a wait, and a buffer whose copy is
    still running waited for before reuse."""
    class Event:
        def __init__(self, done):
            self.done, self.waited = done, False

        def query(self):
            return self.done

        def synchronize(self):
            self.waited = self.done = True

    made = []

    def pinned(shape, dtype=None, pin_memory=False):
        assert pin_memory
        made.append(object())
        return made[-1]

    stager = prefetch._PinnedStager(torch.device("cuda", 0), slots=2, stream=None)
    monkeypatch.setattr(torch, "empty", pinned)
    key = ((4, 3), torch.float32)
    a, b = stager._acquire(key), stager._acquire(key)
    assert made == [a, b]
    busy_a, busy_b = Event(False), Event(False)
    stager._free[key].extend([(a, busy_a), (b, busy_b)])
    assert stager._acquire(key) is a and busy_a.waited      # the oldest, once copied
    stager._free[key].append((a, Event(True)))
    assert stager._acquire(key) is a and not busy_b.waited  # the completed one first
    assert stager._acquire(key) is b and busy_b.waited
    assert len(made) == 2
    other = ((8,), torch.int64)
    stager._acquire(other)
    stager._discard(other)                     # a failed copy gives its slot back
    assert stager._count[other] == 0 and len(made) == 3


def test_pinned_staging_put_takes_more_same_shape_arrays_than_slots(monkeypatch):
    """``put`` with the card's calls replaced by CPU stand-ins: three arrays
    of one shape and type through a ring of one slot, each copy waited for
    before its buffer is reused, the values delivered as they were."""
    import contextlib

    class Event:
        def __init__(self):
            self.done = False

        def record(self, stream):
            pass

        def query(self):
            return self.done

        def synchronize(self):
            self.done = True

    real_empty = torch.empty

    def empty(shape, dtype=None, device=None, pin_memory=False):
        return real_empty(shape, dtype=dtype)

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch, "empty", empty)
    stager = prefetch._PinnedStager(torch.device("cpu"), slots=1, stream=None)
    a = np.arange(12, dtype=np.float64).reshape(3, 4)
    done = []
    t = threading.Thread(target=lambda: done.append(stager.put([a, None, a * 2, a * 3])),
                         daemon=True)
    t.start()
    t.join(timeout=JOIN_S)
    assert not t.is_alive() and done
    got = done[0].arrays
    assert got[1] is None and stager._count[((3, 4), torch.float32)] == 1
    for i, k in ((0, 1), (2, 2), (3, 3)):
        assert got[i].dtype == torch.float32
        assert torch.equal(got[i], torch.from_numpy(a * k).float())


class TestAsyncIteratorLiveness:
    def test_dead_worker_raises_promptly(self, monkeypatch):
        monkeypatch.setattr(threading, "excepthook", lambda args: None)
        it = AsyncDataSetIterator(ListDataSetIterator(_numbered(4)))

        def dying_worker(q, stop):        # hard death: no _exc, no _STOP
            raise SystemExit

        it._worker = dying_worker
        raised = []

        def consume():
            try:
                next(iter(it))
            except RuntimeError as e:
                raised.append(str(e))

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        t.join(timeout=JOIN_S)
        assert not t.is_alive()
        assert raised and "died without" in raised[0]

    def test_worker_exception_reraised_on_consumer(self):
        class Boom(ListDataSetIterator):
            def __next__(self):
                if self._pos == 2:
                    raise OSError("decode failed")
                return super().__next__()

        seen = []
        with pytest.raises(OSError, match="decode failed"):
            for ds in AsyncDataSetIterator(Boom(_numbered(6))):
                seen.append(float(ds.features[0, 0]))
        assert seen == [0.0, 1.0]

    def test_dead_worker_with_queued_items_drains_before_raising(self):
        import queue as _queue
        it = AsyncDataSetIterator(ListDataSetIterator(_numbered(1)))
        dead = threading.Thread(target=lambda: None)
        dead.start()
        dead.join(timeout=JOIN_S)
        it._queue = _queue.Queue()
        it._queue.put(_numbered(1)[0])
        it._queue.put(it._STOP)
        it._thread = dead
        it._exc = None
        assert float(next(it).features[0, 0]) == 0.0
        with pytest.raises(StopIteration):
            next(it)

    def test_fit_through_an_async_iterator_is_not_wrapped_again(self):
        batches = _batches(3)
        a, b = _dense_net(), _dense_net()
        a.fit(AsyncDataSetIterator(ListDataSetIterator(list(batches))))
        b.fit(ListDataSetIterator(list(batches)))
        for k, p in _flat(a).items():
            assert torch.equal(_flat(b)[k], p), k


# ------------------------------------------------------------------ bucketing
class TestShapeBucketing:
    def test_batch_padding_shapes_and_masks(self):
        rng = np.random.default_rng(0)
        ds = DataSet(rng.normal(size=(5, 3)).astype(np.float32),
                     np.eye(2, dtype=np.float32)[rng.integers(0, 2, 5)])
        out = ShapeBucketingDataSetIterator(ListDataSetIterator([ds]),
                                            batch_buckets=(8, 16)).pad(ds)
        assert out.features.shape == (8, 3) and out.labels.shape == (8, 2)
        np.testing.assert_array_equal(out.features[5:], 0.0)
        np.testing.assert_allclose(out.labels_mask[:5], 8 / 5)
        np.testing.assert_array_equal(out.labels_mask[5:], 0.0)

    def test_time_and_batch_padding_for_sequences(self):
        rng = np.random.default_rng(1)
        ds = DataSet(rng.normal(size=(3, 5, 4)).astype(np.float32),
                     rng.normal(size=(3, 5, 2)).astype(np.float32),
                     features_mask=np.ones((3, 5), np.float32))
        out = ShapeBucketingDataSetIterator(ListDataSetIterator([ds]), batch_buckets=(4,),
                                            time_buckets=(4, 8)).pad(ds)
        assert out.features.shape == (4, 8, 4) and out.labels.shape == (4, 8, 2)
        assert out.features_mask.shape == (4, 8)
        np.testing.assert_array_equal(out.features_mask[:, 5:], 0.0)
        np.testing.assert_array_equal(out.features_mask[3:], 0.0)
        np.testing.assert_allclose(out.labels_mask[:3, :5], 4 / 3)

    def test_oversize_batch_rejected_loudly(self):
        ds = DataSet(np.zeros((32, 3), np.float32), np.eye(2, dtype=np.float32)[[0] * 32])
        it = ShapeBucketingDataSetIterator(ListDataSetIterator([ds]), batch_buckets=(8, 16))
        with pytest.raises(ValueError, match="exceeds the largest"):
            it.pad(ds)

    def test_padded_fit_numerically_matches_unpadded(self):
        rng = np.random.default_rng(2)
        ds = DataSet(rng.normal(size=(5, 3)).astype(np.float32),
                     np.eye(2, dtype=np.float32)[rng.integers(0, 2, 5)])
        a, b = _dense_net(), _dense_net()
        a.fit(ds)
        b.fit(ShapeBucketingDataSetIterator(ListDataSetIterator([ds]), batch_buckets=(8,)))
        for k, p in _flat(a).items():
            torch.testing.assert_close(_flat(b)[k], p, rtol=1e-5, atol=1e-6)

    def test_rank2_per_timestep_sparse_labels_pad_and_train(self):
        rng = np.random.default_rng(3)
        ds = DataSet(rng.normal(size=(3, 5, 4)).astype(np.float32),
                     rng.integers(0, 2, size=(3, 5)))
        it = ShapeBucketingDataSetIterator(ListDataSetIterator([ds]), batch_buckets=(4,),
                                           time_buckets=(8,))
        out = it.pad(ds)
        assert out.features.shape == (4, 8, 4)
        assert out.labels.shape == (4, 8) and out.labels_mask.shape == (4, 8)
        np.testing.assert_array_equal(out.labels_mask[:, 5:], 0.0)
        np.testing.assert_array_equal(out.labels_mask[3:], 0.0)
        conf = (NeuralNetConfiguration.builder().seed(5).updater(Sgd(learning_rate=0.05))
                .activation("tanh").list()
                .layer(LSTM(n_in=4, n_out=8))
                .layer(RnnOutputLayer(n_in=8, n_out=2, activation="softmax",
                                      loss="sparse_mcxent"))
                .build())
        net = MultiLayerNetwork(conf).init(device="cpu")
        net.fit(it)
        assert np.isfinite(net.score())


# ------------------------------------------------- containers and iterators
def test_dataset_merge_split_and_getters():
    a = DataSet(np.ones((2, 3, 4), np.float32), np.ones((2, 3, 2), np.float32),
                np.ones((2, 3), np.float32), None)
    b = DataSet(np.zeros((1, 3, 4), np.float32), np.zeros((1, 3, 2), np.float32))
    m = DataSet.merge([a, b])
    assert m.num_examples() == 3 and m.labels_mask is None
    np.testing.assert_array_equal(m.features_mask, np.ones((3, 3)))   # synthesized for b
    head, tail = m.split_test_and_train(2)
    assert head.num_examples() == 2 and tail.num_examples() == 1
    assert tail.get_features() is tail.features and tail.get_labels() is tail.labels
    np.testing.assert_array_equal(tail.features, 0.0)


def test_multidataset_merge_and_device_arrays():
    x = MultiDataSet([np.ones((2, 3)), np.ones((2, 1))], [np.ones((2, 2))],
                     features_masks=[np.ones((2, 3)), None])
    y = MultiDataSet([np.zeros((1, 3)), np.zeros((1, 1))], [np.zeros((1, 2))])
    m = MultiDataSet.merge([x, y])
    assert m.num_examples() == 3 and len(m.features) == 2 and m.labels_masks is None
    np.testing.assert_array_equal(m.features_masks[0], [[1, 1, 1]] * 3)
    f, l, fm, lm = m.device_arrays("cpu")
    assert len(f) == 2 and f[0].dtype == torch.float32 and lm is None
    assert m.device_arrays("cpu")[0][1] is f[1]


def test_iterator_wrappers():
    base = ListDataSetIterator(_numbered(5))
    assert base.async_supported() and not base.concurrent_pull_supported()
    assert len(list(EarlyTerminationDataSetIterator(base, 2))) == 2
    got = [float(d.features[0, 0]) for d in MultipleEpochsIterator(2, base)]
    assert got == [0.0, 1.0, 2.0, 3.0, 4.0] * 2
    assert [float(d.features[0, 0]) for d in ExistingDataSetIterator(_numbered(3))] == [
        0.0, 1.0, 2.0]
    bench = BenchmarkDataSetIterator((4, 3), 2, 3, seed=1)
    batches = list(bench)
    assert len(batches) == 3 and bench.batch() == 4 and batches[0].labels.shape == (4, 2)
    assert batches[0].features is batches[2].features


def test_prefetch_puts_multidatasets_ahead():
    mds = MultiDataSet([np.ones((2, 3), np.float32)], [np.ones((2, 2), np.float32)],
                       labels_masks=[np.ones((2,), np.float32)])
    pf = PrefetchDataSetIterator(ListDataSetIterator([mds]), workers=1, device="cpu")
    try:
        view = next(iter(pf))
    finally:
        pf.shutdown()
    assert isinstance(view.features[0], torch.Tensor) and view.features_masks is None
    assert isinstance(view.labels_masks[0], torch.Tensor)
    assert isinstance(mds.features[0], np.ndarray)


# ------------------------------------------------------- against the JAX package
def _jax_pair(kind):
    from deeplearning4j_tpu import Adam as JAdam
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
    from deeplearning4j_tpu.nn.conf import layers as jl
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet

    b = JConf.builder().seed(11).updater(JAdam(learning_rate=1e-2)).activation("tanh")
    if kind == "dense":
        conf = (b.list().layer(jl.DenseLayer(n_in=5, n_out=16))
                .layer(jl.OutputLayer(n_in=16, n_out=4, activation="softmax", loss="mcxent"))
                .build())
    else:
        conf = (b.list().layer(jl.GravesLSTM(n_in=5, n_out=8))
                .layer(jl.GravesLSTM(n_in=8, n_out=8))
                .layer(jl.RnnOutputLayer(n_in=8, n_out=4, activation="softmax",
                                         loss="mcxent"))
                .build())
    return JNet(conf).init()


def _numpy_batches(kind, n=3):
    rng = np.random.default_rng(4)
    out = []
    for _ in range(n):
        if kind == "dense":
            f = rng.normal(size=(6, 5)).astype(np.float32)
            out.append((f, np.eye(4, dtype=np.float32)[rng.integers(0, 4, 6)], None))
        else:
            f = rng.normal(size=(4, 7, 5)).astype(np.float32)
            lab = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (4, 7))]
            m = (np.arange(7)[None, :] < rng.integers(3, 8, 4)[:, None]).astype(np.float32)
            out.append((f, lab, m))
    return out


@pytest.mark.parametrize("kind", ["dense", "lstm_masked"])
def test_fit_through_the_pipeline_matches_jax_package(tmp_path, monkeypatch, kind):
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.datasets.dataset import ListDataSetIterator as JList
    from deeplearning4j_tpu.utils.model_serializer import ModelSerializer
    from deeplearning4j_torch.utils.model_serializer import restore_multi_layer_network

    monkeypatch.delenv("DL4J_TPU_PREFETCH_WORKERS", raising=False)
    jnet = _jax_pair(kind)
    ModelSerializer.write_model(jnet, str(tmp_path / "m.zip"))
    net = restore_multi_layer_network(tmp_path / "m.zip", device="cpu")
    data = _numpy_batches(kind)
    jnet.fit(JList([JDataSet(f, l, m, m) for f, l, m in data]), epochs=2)
    net.fit(ListDataSetIterator([DataSet(f, l, m, m) for f, l, m in data]), epochs=2)
    assert _no_pipeline_threads()
    for i, ps in jnet.params.items():
        for k, p in ps.items():
            np.testing.assert_allclose(net.params[i][k].numpy(), np.asarray(p), rtol=0,
                                       atol=1e-5, err_msg=f"{i}/{k}")


@pytest.mark.parametrize("name,args", [("NormalizerStandardize", ()),
                                       ("NormalizerMinMaxScaler", (-1.0, 2.0)),
                                       ("ImagePreProcessingScaler", (0.0, 1.0, 255.0))])
@pytest.mark.parametrize("shape", [(6, 4), (3, 5, 4), (2, 4, 3, 3)])
def test_normalizers_match_jax_package(name, args, shape):
    from deeplearning4j_tpu.datasets import normalizers as jn
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet

    rng = np.random.default_rng(8)
    batches = [(rng.normal(size=shape) * 3 + 1).astype(np.float32) for _ in range(3)]
    if name == "ImagePreProcessingScaler":
        batches = [np.abs(b) * 40 for b in batches]
    port = getattr(normalizers, name)(*args).fit(ListDataSetIterator(
        [DataSet(b) for b in batches]))
    ref = getattr(jn, name)(*args).fit([JDataSet(b) for b in batches])
    for k, v in ref._state().items():
        np.testing.assert_allclose(np.asarray(port._state()[k], np.float64),
                                   np.asarray(v, np.float64), rtol=1e-6, atol=1e-6)
    x = batches[0]
    got = port.transform(DataSet(x.copy())).features
    np.testing.assert_allclose(got, ref.transform(JDataSet(x.copy())).features,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(port.revert_features(got), x, rtol=1e-5, atol=1e-4)
    loaded = normalizers.Normalizer.from_bytes(ref.to_bytes())
    assert type(loaded) is type(port)
    np.testing.assert_allclose(loaded.transform(DataSet(x.copy())).features, got, rtol=1e-6,
                               atol=1e-6)
    back = jn.Normalizer.from_bytes(port.to_bytes())
    assert back.to_bytes() == ref.to_bytes()


def test_put_ahead_copy_is_held_for_the_backward_after_the_take():
    """A fit loop's put-ahead copy of batch k+1 waits (``prefetch.
    _hold_copy``) until the consumer has taken batch k and a backward was
    begun after that; a consumer waiting for a batch, or a stopped epoch,
    releases it; batch 0 never waits."""
    from deeplearning4j_torch.datasets import prefetch as pf

    def held(ep, seq):
        done = threading.Event()
        t = threading.Thread(target=lambda: (pf._hold_copy(ep, seq), done.set()), daemon=True)
        t.start()
        return done, t

    ep = pf._Epoch(iter(()))
    pf._hold_copy(ep, 0)
    done, t = held(ep, 2)
    pf.backward_begins()                     # step 0's backward: batch 2 is not next
    assert not done.wait(0.3)
    ep.take_gen, ep.emit_seq = pf._BACKWARDS, 2   # the consumer takes batch 1
    assert not done.wait(0.3)
    pf.backward_begins()                     # step 1's backward
    assert done.wait(5)
    t.join()
    ep = pf._Epoch(iter(()))
    done, t = held(ep, 1)
    assert not done.wait(0.3)
    ep.waiting = True                        # the consumer waits: release now
    assert done.wait(5)
    ep = pf._Epoch(iter(()))
    done, t = held(ep, 1)
    ep.stop.set()
    assert done.wait(5)
