"""The port's fetchers and dataset iterators (``datasets/{fetchers,impl}.py``)
against the JAX package's: the fetcher cases of ``tests/test_datasets.py``
(IDX round trip, MNIST/CIFAR from local files, the synthetic stand-in and
its flags, LFW/TinyImageNet folders, Iris training) on the port, and every
synthetic array bit-equal to the JAX package's from the same seed. Nothing
is downloaded: each case points ``DL4J_TPU_DATA_DIR`` at a temporary
directory.
"""
import logging
import os

import numpy as np
import pytest

from deeplearning4j_tpu.datasets import fetchers as jfetchers
from deeplearning4j_tpu.datasets import impl as jimpl

from deeplearning4j_torch.datasets import fetchers, impl
from deeplearning4j_torch.datasets.dataset import DataSet, DataSetIterator


@pytest.fixture(autouse=True)
def _empty_data_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    return tmp_path


def test_idx_roundtrip_and_jax_files(tmp_path):
    """Plain and gzipped IDX files round-trip, and each package reads the
    other's files."""
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 255, size=(10, 28, 28)).astype(np.uint8)
    for name in ("imgs-idx3-ubyte", "imgs-idx3-ubyte.gz"):
        p, jp = str(tmp_path / name), str(tmp_path / ("j" + name))
        fetchers.write_idx(p, arr)
        jfetchers.write_idx(jp, arr)
        np.testing.assert_array_equal(fetchers.read_idx(p), arr)
        np.testing.assert_array_equal(fetchers.read_idx(jp), arr)
        np.testing.assert_array_equal(jfetchers.read_idx(p), arr)
    signed = rng.integers(-100, 100, size=(3, 4)).astype(np.int8)
    fetchers.write_idx(str(tmp_path / "s"), signed)
    np.testing.assert_array_equal(fetchers.read_idx(str(tmp_path / "s")), signed)
    with pytest.raises(ValueError, match="uint8/int8"):
        fetchers.write_idx(str(tmp_path / "f"), np.zeros(3, np.float32))
    (tmp_path / "bad").write_bytes(b"\x01\x00\x08\x01\x00\x00\x00\x01\x05")
    with pytest.raises(ValueError, match="bad magic"):
        fetchers.read_idx(str(tmp_path / "bad"))


def test_mnist_fetcher_reads_real_idx_files(tmp_path):
    d = tmp_path / "mnist"
    os.makedirs(d)
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 255, size=(50, 28, 28)).astype(np.uint8)
    labels = rng.integers(0, 10, size=(50,)).astype(np.uint8)
    fetchers.write_idx(str(d / "train-images-idx3-ubyte"), imgs)
    fetchers.write_idx(str(d / "train-labels-idx1-ubyte"), labels)
    f, jf = fetchers.MnistDataFetcher(train=True), jfetchers.MnistDataFetcher(train=True)
    assert not f.is_synthetic and f.features.shape == (50, 784)
    np.testing.assert_allclose(f.features[0], imgs[0].reshape(-1).astype(np.float32) / 255.0)
    assert np.argmax(f.labels[3]) == labels[3]
    for a in ("features", "labels"):
        np.testing.assert_array_equal(getattr(f, a), getattr(jf, a))
    shuffled = fetchers.MnistDataFetcher(train=True, shuffle=True, binarize=True, seed=9)
    jshuffled = jfetchers.MnistDataFetcher(train=True, shuffle=True, binarize=True, seed=9)
    np.testing.assert_array_equal(shuffled.features, jshuffled.features)
    np.testing.assert_array_equal(shuffled.labels, jshuffled.labels)


@pytest.mark.parametrize("name,kwargs", [
    ("MnistDataFetcher", {}), ("MnistDataFetcher", {"train": False, "seed": 7,
                                                    "num_synthetic": 300, "shuffle": True}),
    ("MnistDataFetcher", {"binarize": True}),
    ("EmnistDataFetcher", {"split": "letters"}), ("EmnistDataFetcher", {"split": "byclass"}),
    ("CifarDataFetcher", {}), ("CifarDataFetcher", {"train": False, "seed": 3}),
    ("LFWDataFetcher", {"image_size": 32, "num_synthetic": 16}),
    ("TinyImageNetFetcher", {"num_synthetic": 8})])
def test_synthetic_stand_in_is_bit_equal_to_jax(name, kwargs, caplog):
    """Without files every fetcher builds the JAX package's stand-in: the
    same arrays bit for bit, ``is_synthetic`` set and the loud warning."""
    with caplog.at_level(logging.WARNING, logger="deeplearning4j_torch.datasets.fetchers"):
        f = getattr(fetchers, name)(**kwargs)
    jf = getattr(jfetchers, name)(**kwargs)
    assert f.is_synthetic and jf.is_synthetic
    assert any("SYNTHETIC" in r.message for r in caplog.records)
    for a in ("features", "labels"):
        got, want = getattr(f, a), getattr(jf, a)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert f.total_examples() == jf.total_examples()


def test_emnist_splits_and_labels_out_of_range(tmp_path):
    with pytest.raises(ValueError, match="Unknown EMNIST split"):
        fetchers.EmnistDataFetcher(split="nope")
    d = tmp_path / "emnist-letters"
    os.makedirs(d)
    fetchers.write_idx(str(d / "train-images-idx3-ubyte"), np.zeros((3, 28, 28), np.uint8))
    fetchers.write_idx(str(d / "train-labels-idx1-ubyte"), np.array([1, 26, 5], np.uint8))
    f = fetchers.EmnistDataFetcher(split="letters")
    assert f.labels.shape == (3, 26) and np.argmax(f.labels, 1).tolist() == [0, 25, 4]
    fetchers.write_idx(str(d / "train-labels-idx1-ubyte"), np.array([0, 3, 5], np.uint8))
    with pytest.raises(ValueError, match="outside"):
        fetchers.EmnistDataFetcher(split="letters")


def test_mnist_synthetic_fallback_and_iterator():
    """``test_mnist_synthetic_fallback_and_iterator`` and
    ``test_mnist_synthetic_flag_propagates`` on the port: batches, flags
    and the same batches as the JAX iterator's."""
    it = impl.MnistDataSetIterator(batch=32, num_examples=128)
    assert isinstance(it, DataSetIterator) and it.fetcher.is_synthetic
    batches = list(it)
    assert len(batches) == 4 and all(isinstance(b, DataSet) and b.synthetic for b in batches)
    assert batches[0].features.shape == (32, 784) and batches[0].labels.shape == (32, 10)
    it2 = impl.MnistDataSetIterator(batch=32, num_examples=128)
    np.testing.assert_array_equal(batches[0].features, next(iter(it2)).features)
    jbatches = list(jimpl.MnistDataSetIterator(batch=32, num_examples=128))
    for b, jb in zip(batches, jbatches):
        np.testing.assert_array_equal(b.features, jb.features)
        np.testing.assert_array_equal(b.labels, jb.labels)
    assert it.total_examples() == 128 and it.batch() == 32 and it.num_outcomes() == 10
    it.reset()
    assert len(list(it)) == 4


def test_cifar_iterator_shapes_and_binary_files(tmp_path):
    it = impl.CifarDataSetIterator(batch=16, num_examples=64)
    ds = next(iter(it))
    assert ds.features.shape == (16, 3, 32, 32) and ds.labels.shape == (16, 10)
    d = tmp_path / "cifar10"
    os.makedirs(d)
    rng = np.random.default_rng(2)
    for i in range(1, 6):
        rec = np.zeros((20, 3073), np.uint8)
        rec[:, 0] = rng.integers(0, 10, 20)
        rec[:, 1:] = rng.integers(0, 255, (20, 3072))
        (d / f"data_batch_{i}.bin").write_bytes(rec.tobytes())
    f, jf = fetchers.CifarDataFetcher(train=True), jfetchers.CifarDataFetcher(train=True)
    assert not f.is_synthetic and f.features.shape == (100, 3, 32, 32)
    np.testing.assert_array_equal(f.features, jf.features)
    np.testing.assert_array_equal(f.labels, jf.labels)


def test_lfw_tinyimagenet_iterators_and_synthetic_flag(caplog):
    with caplog.at_level(logging.WARNING, logger="deeplearning4j_torch.datasets.fetchers"):
        it = impl.LFWDataSetIterator(batch=8, num_examples=16, image_size=32, num_synthetic=16)
    assert any("SYNTHETIC" in r.message for r in caplog.records)
    ds = next(it)
    assert ds.synthetic is True and ds.features.shape == (8, 3, 32, 32)
    assert ds.labels.shape[1] == it.fetcher.num_classes
    tin = impl.TinyImageNetDataSetIterator(batch=4, num_examples=8, num_synthetic=8)
    ds2 = next(tin)
    assert ds2.synthetic is True
    assert ds2.features.shape == (4, 3, 64, 64) and ds2.labels.shape == (4, 200)


def test_image_folder_fetcher_reads_local_files(tmp_path):
    from PIL import Image
    base = tmp_path / "lfw"
    for person in ("alice", "bob"):
        d = base / person
        d.mkdir(parents=True)
        for i in range(3):
            arr = (np.random.default_rng(i).random((40, 40, 3)) * 255).astype("uint8")
            Image.fromarray(arr).save(d / f"img_{i}.jpg")
    (base / "bob" / "more").mkdir()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(base / "bob" / "more" / "x.png")
    it = impl.LFWDataSetIterator(batch=7, image_size=24)
    ds = next(it)
    assert ds.synthetic is False
    assert ds.features.shape == (7, 3, 24, 24) and ds.labels.shape == (7, 2)
    assert it.fetcher.class_names == ["alice", "bob"]
    jf = jfetchers.LFWDataFetcher(image_size=24)
    np.testing.assert_array_equal(it.fetcher.features, jf.features)
    (tmp_path / "tinyimagenet" / "n01").mkdir(parents=True)
    with pytest.raises(ValueError, match="no image files"):
        fetchers.TinyImageNetFetcher()


def test_iris_iterator_trains_and_evaluates():
    """``test_iris_iterator_trains`` on the port: 30 epochs of Adam on the
    bundled Iris data, then ``evaluate`` over the whole set above 0.8."""
    pytest.importorskip("sklearn")
    from deeplearning4j_torch import Adam, MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_torch.nn.conf.layers import DenseLayer, OutputLayer
    it = impl.IrisDataSetIterator(batch=50)
    assert sum(ds.num_examples() for ds in it) == 150
    f, jf = fetchers.IrisDataFetcher(), jfetchers.IrisDataFetcher()
    np.testing.assert_array_equal(f.features, jf.features)
    np.testing.assert_array_equal(f.labels, jf.labels)
    conf = (NeuralNetConfiguration.builder().seed(1)
            .updater(Adam(learning_rate=0.05)).activation("tanh")
            .list()
            .layer(DenseLayer(n_in=4, n_out=16))
            .layer(OutputLayer(n_in=16, n_out=3, activation="softmax", loss="mcxent"))
            .build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    net.fit(it, epochs=30)
    ev = net.evaluate(impl.IrisDataSetIterator(batch=150))
    assert ev.accuracy() > 0.8 and ev.total == 150
