"""The port's record readers (``deeplearning4j_torch/datasets/records.py``)
against the JAX package's, on the same CSV files written to a temporary
directory: the records, and every DataSet's features, labels and masks,
bit for bit (classification, regression, no labels; sequences of unequal
length right-padded with zeros and masked). Then a masked fit fed by the
sequence iterator: a GravesBidirectionalLSTM net in both packages over
the same files, f32, parameters within 2e-5 of the largest entry; and
``evaluate`` over the iterator in both containers, the same confusion
matrix as JAX's.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import Adam as JAdam
from deeplearning4j_tpu.datasets import records as jrec
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet

from deeplearning4j_torch.datasets import records as rec
from deeplearning4j_torch.datasets.dataset import DataSet

from test_torch_recurrent_family import rel, to_port, tree_errors


def _write_table(path, rng, n=11):
    rows = ["a,b,c,label"]
    for _ in range(n):
        x = rng.normal(size=3).round(4)
        rows.append(f"{x[0]},{x[1]},{x[2]},{int(rng.integers(0, 3))}")
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def _write_sequences(tmp_path, rng, lengths=(5, 3, 7, 4, 6), n_feat=2, classes=3):
    paths = []
    for i, t in enumerate(lengths):
        lines = [",".join(f"{v:.5f}" for v in rng.normal(size=n_feat)) +
                 f",{int(rng.integers(0, classes))}" for _ in range(t)]
        p = tmp_path / f"seq_{i}.csv"
        p.write_text("\n".join(lines) + "\n")
        paths.append(str(p))
    return paths


def _same_sets(port_sets, jax_sets):
    assert len(port_sets) == len(jax_sets) > 0
    for ds, jds in zip(port_sets, jax_sets):
        for name in ("features", "labels", "features_mask", "labels_mask"):
            a, b = getattr(ds, name), getattr(jds, name)
            if b is None:
                assert a is None, name
                continue
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), name


def test_csv_record_reader(tmp_path):
    path = _write_table(tmp_path / "t.csv", np.random.default_rng(0))
    (tmp_path / "s.csv").write_text("x;name\n1.5;alpha\n-2;beta\n")
    for args in ((path, 1), (str(tmp_path / "s.csv"), 1, ";")):
        got, want = list(rec.CSVRecordReader(*args)), list(jrec.CSVRecordReader(*args))
        assert got == want and len(got) > 0
    reader = rec.CollectionRecordReader([[1.0, 2.0], [3.0, 4.0]])
    assert list(reader) == list(reader) == [[1.0, 2.0], [3.0, 4.0]]


@pytest.mark.parametrize("mode", ["classification", "regression", "no_labels"])
def test_record_reader_iterator(mode, tmp_path):
    path = _write_table(tmp_path / "t.csv", np.random.default_rng(1))
    kw = {"classification": dict(label_index=3, num_classes=3),
          "regression": dict(label_index=2, regression=True, label_index_to=3),
          "no_labels": {}}[mode]
    port = list(rec.RecordReaderDataSetIterator(rec.CSVRecordReader(path, 1), 4, **kw))
    jax_sets = list(jrec.RecordReaderDataSetIterator(jrec.CSVRecordReader(path, 1), 4, **kw))
    _same_sets(port, jax_sets)
    assert [d.features.shape[0] for d in port] == [4, 4, 3]


def test_classification_needs_num_classes(tmp_path):
    path = _write_table(tmp_path / "t.csv", np.random.default_rng(2))
    for m in (rec, jrec):
        with pytest.raises(ValueError, match="num_classes is required"):
            next(iter(m.RecordReaderDataSetIterator(m.CSVRecordReader(path, 1), 4,
                                                    label_index=3)))


@pytest.mark.parametrize("regression", [False, True])
def test_sequence_iterator_pads_and_masks(regression, tmp_path):
    paths = _write_sequences(tmp_path, np.random.default_rng(3))
    kw = dict(num_classes=None if regression else 3, label_index=2, regression=regression)
    port = list(rec.SequenceRecordReaderDataSetIterator(rec.CSVSequenceRecordReader(paths), 2,
                                                        **kw))
    jax_sets = list(jrec.SequenceRecordReaderDataSetIterator(
        jrec.CSVSequenceRecordReader(paths), 2, **kw))
    _same_sets(port, jax_sets)
    first = port[0]
    assert first.features.shape == (2, 5, 2)
    np.testing.assert_array_equal(first.features_mask,
                                  [[1, 1, 1, 1, 1], [1, 1, 1, 0, 0]])
    assert not first.features[1, 3:].any() and not first.labels[1, 3:].any()
    assert isinstance(port[0], DataSet)


def test_masked_fit_from_sequence_files(tmp_path):
    """Both packages fit a GravesBidirectionalLSTM net over the same
    sequence files (two epochs of three masked minibatches)."""
    paths = _write_sequences(tmp_path, np.random.default_rng(4), lengths=(5, 3, 7, 4, 6, 2))
    conf = (JConf.builder().seed(9).updater(JAdam(learning_rate=1e-2)).list()
            .layer(jl.GravesBidirectionalLSTM(n_in=2, n_out=6, activation="tanh"))
            .layer(jl.RnnOutputLayer(n_in=6, n_out=3, activation="softmax", loss="mcxent"))
            .build())
    jnet = JNet(conf).init()
    net = to_port(jnet, tmp_path)
    jnet.fit(jrec.SequenceRecordReaderDataSetIterator(jrec.CSVSequenceRecordReader(paths), 2,
                                                      3, 2), epochs=2)
    net.fit(rec.SequenceRecordReaderDataSetIterator(rec.CSVSequenceRecordReader(paths), 2, 3, 2),
            epochs=2)
    assert net.iteration_count == jnet.iteration_count == 6
    assert rel(float(net.score_), float(jnet.score_)) <= 2e-5
    assert max(tree_errors(jnet.params, net.params).values()) <= 2e-5
    assert torch.isfinite(net.output(np.zeros((1, 4, 2), np.float32))).all()


@pytest.mark.parametrize("graph", [False, True], ids=["multilayer", "graph"])
def test_evaluate_from_sequence_files(graph, tmp_path):
    """``evaluate`` over the masked sequence iterator: a Bidirectional(LSTM)
    net's per-step predictions on the real steps only, counted as JAX
    counts them."""
    paths = _write_sequences(tmp_path, np.random.default_rng(5), lengths=(5, 3, 7, 4, 6, 2))
    layer = jl.Bidirectional(inner=jl.LSTM(n_in=2, n_out=5, activation="tanh"), mode="add")
    out = jl.RnnOutputLayer(n_in=5, n_out=3, activation="softmax", loss="mcxent")
    builder = JConf.builder().seed(2).updater(JAdam(learning_rate=1e-2))
    if graph:
        conf = (builder.graph_builder().add_inputs("in").add_layer("rnn", layer, "in")
                .add_layer("out", out, "rnn").set_outputs("out").build())
        jnet = JGraph(conf).init()
    else:
        jnet = JNet(builder.list().layer(layer).layer(out).build()).init()
    net = to_port(jnet, tmp_path)
    ev = net.evaluate(rec.SequenceRecordReaderDataSetIterator(
        rec.CSVSequenceRecordReader(paths), 4, 3, 2))
    jev = jnet.evaluate(jrec.SequenceRecordReaderDataSetIterator(
        jrec.CSVSequenceRecordReader(paths), 4, 3, 2))
    assert ev.total == jev.total == 27
    np.testing.assert_array_equal(ev.confusion.matrix, jev.confusion.matrix)
