"""Early stopping (``deeplearning4j_torch/earlystopping``) against the JAX
package's: the cases of ``tests/test_earlystopping_transfer.py`` (max
epochs, patience, the divergence guard, the file saver, the maximised
metric, the evaluate-every-N gate) and the single-process case of
``tests/test_distributed_eval.py:83``, each run by both packages' trainers
on the same float64 net (moved through the model zip) and the same data.

Held: the termination reason and details, the total epochs, the best
epoch, and the validation score of every evaluated epoch within 1e-12
relative; the best model's output as JAX's best model's (1e-12) where
JAX's can be read (the trained net itself, or from the file saver: JAX's
in-memory best model shares buffers that its next jitted step donates),
else the port's best model re-scored to the best score exactly. The nets train with SGD, and
the max-epochs case also with Adam: both packages take Adam's bias
corrections as float32 scalars (``jnp.power`` of a weak float and an f32
step; the port's ``updaters.bias_correction``) even for float64
parameters, so the f64 Adam runs agree at the same 1e-12. The JAX cases'
own Adam runs (f32) also run on the port alone here. Beside them: the savers on a
ComputationGraph (``InMemoryModelSaver`` deep-copies it: the graph has no
``clone`` in either package), ``LocalFileModelSaver`` restoring onto the
saved net's device, ``save_last_model``, and the time, best-score and
invalid-score conditions.
"""
import math

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import Adam as JAdam
from deeplearning4j_tpu import Sgd as JSgd
from deeplearning4j_tpu import earlystopping as jes
from deeplearning4j_tpu.compat import enable_x64
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import ListDataSetIterator as JList
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.utils.model_serializer import ModelSerializer as JSerializer

from deeplearning4j_torch import Adam, DataSet, ListDataSetIterator, NeuralNetConfiguration
from deeplearning4j_torch import earlystopping as es
from deeplearning4j_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_torch.nn.graph import ComputationGraph
from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_torch.utils.model_serializer import restore_model

SCORE_RTOL = 1e-12
OUT_ATOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _jnet(seed=7, lr=0.1, updater=JSgd):
    conf = (JConf.builder().seed(seed).updater(updater(learning_rate=lr)).activation("tanh")
            .dtype("float64").compute_dtype("float64")
            .list()
            .layer(jlayers.DenseLayer(n_in=4, n_out=8))
            .layer(jlayers.DenseLayer(n_out=8, n_in=8))
            .layer(jlayers.OutputLayer(n_in=8, n_out=3, activation="softmax", loss="mcxent"))
            .build())
    return JNet(conf).init()


def _jgraph(seed=7, lr=0.1):
    conf = (JConf.builder().seed(seed).updater(JSgd(learning_rate=lr)).activation("tanh")
            .dtype("float64").compute_dtype("float64").graph_builder()
            .add_inputs("in")
            .add_layer("d0", jlayers.DenseLayer(n_in=4, n_out=8), "in")
            .add_layer("out", jlayers.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                                  loss="mcxent"), "d0")
            .set_outputs("out")
            .build())
    return JGraph(conf).init()


def _arrays(n=32, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(n, 4)).astype(np.float32)
    return f, np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]


def _iters(n=32, seed=0, batch=16):
    f, l = _arrays(n, seed)
    return (ListDataSetIterator([DataSet(f, l)], batch_size=batch),
            JList([JDataSet(f, l)], batch_size=batch))


def _pair(tmp_path, jnet):
    path = str(tmp_path / "start.zip")
    JSerializer.write_model(jnet, path)
    return restore_model(path, device="cpu")


def _configs(build):
    """The port's and JAX's EarlyStoppingConfiguration from one recipe
    ``build(module, val_iterator)`` -> builder."""
    val, jval = _iters(seed=99)
    return build(es, val).build(), build(jes, jval).build()


def _run_both(tmp_path, build, jnet_fn=_jnet, train_seed=0, trainer="EarlyStoppingTrainer"):
    with enable_x64(True):
        jnet = jnet_fn()
        net = _pair(tmp_path, jnet)
        conf, jconf = _configs(build)
        train, jtrain = _iters(seed=train_seed)
        result = getattr(es, trainer)(conf, net, train).fit()
        jresult = getattr(jes, trainer)(jconf, jnet, jtrain).fit()
        x = _arrays(6, seed=5)[0]
        if jresult.best_model is jnet or isinstance(jconf.model_saver, jes.LocalFileModelSaver):
            outs = (result.best_model.output(x).numpy(),
                    np.asarray(jresult.best_model.output(x)))
        else:
            rescored = conf.score_calculator.calculate_score(result.best_model)
            outs = (np.float64(rescored), np.float64(result.best_model_score))
    return result, jresult, outs


def _assert_same_result(result, jresult, outs):
    assert result.termination_reason == jresult.termination_reason
    head, _, score = result.termination_details.partition(" at score ")
    jhead, _, jscore = jresult.termination_details.partition(" at score ")
    assert head == jhead
    if jscore:
        assert float(score) == pytest.approx(float(jscore), rel=SCORE_RTOL)
    assert result.total_epochs == jresult.total_epochs
    assert result.best_model_epoch == jresult.best_model_epoch
    assert sorted(result.score_vs_epoch) == sorted(jresult.score_vs_epoch)
    for e, s in jresult.score_vs_epoch.items():
        assert result.score_vs_epoch[e] == pytest.approx(s, rel=SCORE_RTOL), e
    assert result.best_model_score == pytest.approx(jresult.best_model_score, rel=SCORE_RTOL)
    np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=OUT_ATOL)


def test_early_stopping_max_epochs(tmp_path):
    def build(m, val):
        return (m.EarlyStoppingConfiguration.builder()
                .score_calculator(m.DataSetLossCalculator(val))
                .epoch_termination_conditions(m.MaxEpochsTerminationCondition(3))
                .model_saver(m.InMemoryModelSaver()))
    result, jresult, outs = _run_both(tmp_path, build)
    _assert_same_result(result, jresult, outs)
    assert result.termination_reason == es.TerminationReason.EpochTerminationCondition
    assert result.total_epochs == 3 and len(result.score_vs_epoch) == 3
    assert isinstance(result.best_model, MultiLayerNetwork)


def test_early_stopping_max_epochs_adam(tmp_path):
    """The max-epochs case on the float64 net trained with Adam (1e-2)."""
    def build(m, val):
        return (m.EarlyStoppingConfiguration.builder()
                .score_calculator(m.DataSetLossCalculator(val))
                .epoch_termination_conditions(m.MaxEpochsTerminationCondition(3))
                .model_saver(m.InMemoryModelSaver()))
    result, jresult, outs = _run_both(tmp_path, build, lambda: _jnet(lr=1e-2, updater=JAdam))
    _assert_same_result(result, jresult, outs)
    assert result.total_epochs == 3 and len(result.score_vs_epoch) == 3


def test_jax_cases_with_adam_on_the_port():
    """``tests/test_earlystopping_transfer.py``'s max-epochs and patience
    cases as written (Adam 1e-2; lr 0 for the patience case), on the port
    alone."""
    def net(lr):
        conf = (NeuralNetConfiguration.builder().seed(7).updater(Adam(learning_rate=lr))
                .activation("tanh").list()
                .layer(DenseLayer(n_in=4, n_out=8)).layer(DenseLayer(n_out=8, n_in=8))
                .layer(OutputLayer(n_in=8, n_out=3, activation="softmax", loss="mcxent"))
                .build())
        return MultiLayerNetwork(conf).init(device="cpu")
    conf = (es.EarlyStoppingConfiguration.builder()
            .score_calculator(es.DataSetLossCalculator(_iters(seed=99)[0]))
            .epoch_termination_conditions(es.MaxEpochsTerminationCondition(3))
            .model_saver(es.InMemoryModelSaver()).build())
    result = es.EarlyStoppingTrainer(conf, net(1e-2), _iters()[0]).fit()
    assert result.termination_reason == es.TerminationReason.EpochTerminationCondition
    assert result.total_epochs == 3 and len(result.score_vs_epoch) == 3
    assert result.best_model is not None
    conf = (es.EarlyStoppingConfiguration.builder()
            .score_calculator(es.DataSetLossCalculator(_iters(seed=99)[0]))
            .epoch_termination_conditions(es.ScoreImprovementEpochTerminationCondition(2),
                                          es.MaxEpochsTerminationCondition(50)).build())
    result = es.EarlyStoppingTrainer(conf, net(0.0), _iters()[0]).fit()
    assert result.total_epochs <= 5


def test_early_stopping_score_improvement_patience(tmp_path):
    """lr=0: no improvement ever, best at epoch 0, patience 2 stops it."""
    def build(m, val):
        return (m.EarlyStoppingConfiguration.builder()
                .score_calculator(m.DataSetLossCalculator(val))
                .epoch_termination_conditions(
                    m.ScoreImprovementEpochTerminationCondition(patience=2),
                    m.MaxEpochsTerminationCondition(50)))
    result, jresult, outs = _run_both(tmp_path, build, lambda: _jnet(lr=0.0))
    _assert_same_result(result, jresult, outs)
    assert result.total_epochs <= 5 and result.best_model_epoch == 0


def test_early_stopping_divergence_guard(tmp_path):
    def build(m, val):
        return (m.EarlyStoppingConfiguration.builder()
                .score_calculator(m.DataSetLossCalculator(val))
                .iteration_termination_conditions(m.MaxScoreIterationTerminationCondition(1e-12))
                .epoch_termination_conditions(m.MaxEpochsTerminationCondition(5)))
    result, jresult, outs = _run_both(tmp_path, build)
    _assert_same_result(result, jresult, outs)
    assert result.termination_reason == es.TerminationReason.IterationTerminationCondition


def test_early_stopping_local_file_saver(tmp_path):
    """The best model comes back from its zip onto the CPU, where the
    trained net lives (``restore_model`` alone defaults to the card), and
    ``save_last_model`` writes the latest one beside it."""
    def build(m, val):
        d = tmp_path / ("port" if m is es else "jax")
        return (m.EarlyStoppingConfiguration.builder()
                .score_calculator(m.DataSetLossCalculator(val))
                .epoch_termination_conditions(m.MaxEpochsTerminationCondition(2))
                .model_saver(m.LocalFileModelSaver(str(d)))
                .save_last_model())
    result, jresult, outs = _run_both(tmp_path, build)
    _assert_same_result(result, jresult, outs)
    best = result.best_model
    assert best.device.type == "cpu" and best.output(_arrays(4)[0]).shape == (4, 3)
    assert (tmp_path / "port" / "bestModel.bin").exists()
    assert (tmp_path / "port" / "latestModel.bin").exists()


def test_early_stopping_maximised_accuracy(tmp_path):
    """``ClassificationScoreCalculator`` (accuracy, maximised: ``evaluate``
    inside the trainer) with the patience condition turned to maximise."""
    def build(m, val):
        return (m.EarlyStoppingConfiguration.builder()
                .score_calculator(m.ClassificationScoreCalculator(val))
                .epoch_termination_conditions(
                    m.ScoreImprovementEpochTerminationCondition(patience=2),
                    m.MaxEpochsTerminationCondition(6)))
    result, jresult, outs = _run_both(tmp_path, build)
    _assert_same_result(result, jresult, outs)
    assert all(0.0 <= s <= 1.0 for s in result.score_vs_epoch.values())
    cond = es.ScoreImprovementEpochTerminationCondition(patience=2)
    cond.minimize = False
    cond.initialize()
    for epoch, acc in enumerate([0.5, 0.6, 0.7, 0.8, 0.9]):
        assert not cond.terminate(epoch, acc)
    assert not cond.terminate(5, 0.9)
    assert cond.terminate(7, 0.9)


def test_epoch_conditions_see_only_evaluated_epochs(tmp_path):
    """With ``evaluate_every_n_epochs(2)`` a score condition sees epochs 0
    and 2 only, in both packages, with the same scores."""
    seen = {}

    def build(m, val):
        log = seen.setdefault(m.__name__, [])

        class Spy(m.BestScoreEpochTerminationCondition):
            def terminate(self, epoch, score):
                log.append((epoch, score))
                return False
        return (m.EarlyStoppingConfiguration.builder()
                .score_calculator(m.DataSetLossCalculator(val))
                .epoch_termination_conditions(Spy(-1.0), m.MaxEpochsTerminationCondition(4))
                .evaluate_every_n_epochs(2))
    result, jresult, outs = _run_both(tmp_path, build)
    _assert_same_result(result, jresult, outs)
    mine, theirs = seen[es.__name__], seen[jes.__name__]
    assert [e for e, _ in mine] == [e for e, _ in theirs] == [0, 2]
    for (_, s), (_, js) in zip(mine, theirs):
        assert s == pytest.approx(js, rel=SCORE_RTOL)


@pytest.mark.parametrize("saver", ["memory", "file"])
def test_graph_trainer_and_savers(tmp_path, saver):
    """``EarlyStoppingGraphTrainer`` on a ComputationGraph: in memory the
    best graph is a deep copy (independent of the net that trains on), on
    file a restored graph on the CPU; both as JAX's best graph from its
    file saver (the JAX package's in-memory saver cannot deep-copy its
    graph: the jit wrappers hold locks)."""
    def build(m, val):
        s = (m.InMemoryModelSaver() if saver == "memory" and m is es
             else m.LocalFileModelSaver(str(tmp_path / m.__name__)))
        return (m.EarlyStoppingConfiguration.builder()
                .score_calculator(m.DataSetLossCalculator(val))
                .epoch_termination_conditions(m.MaxEpochsTerminationCondition(3))
                .model_saver(s))
    result, jresult, outs = _run_both(tmp_path, build, _jgraph,
                                      trainer="EarlyStoppingGraphTrainer")
    _assert_same_result(result, jresult, outs)
    best = result.best_model
    assert isinstance(best, ComputationGraph) and best.device.type == "cpu"
    w = best.params["d0"]["W"].clone()
    net = _pair(tmp_path, _jgraph())
    assert best is not net
    best.fit(DataSet(*_arrays(8)))              # the copy trains on its own
    assert not torch.equal(best.params["d0"]["W"], w)


def test_deepcopy_of_a_trained_streaming_graph(tmp_path):
    """``InMemoryModelSaver`` on a graph that has fitted and streamed:
    the deep copy carries the generator state, the updater state and the
    streaming carry, and answers as the original."""
    from deeplearning4j_torch.models import TransformerLM
    lm = TransformerLM(vocab_size=5, embed_dim=8, num_heads=2, num_blocks=1,
                       dropout_rate=0.1).init(device="cpu")
    ids = np.arange(8, dtype=np.float32).reshape(2, 4) % 5
    lm.fit(ids, np.eye(5, dtype=np.float32)[ids.astype(int)])
    lm.rnn_time_step(ids[:, :, None])
    saver = es.InMemoryModelSaver()
    saver.save_best_model(lm, 0.0)
    copy = saver.get_best_model()
    assert copy is not lm and not hasattr(ComputationGraph, "clone")
    np.testing.assert_array_equal(copy.output(ids).numpy(), lm.output(ids).numpy())
    np.testing.assert_array_equal(copy.rnn_time_step(ids[:, :1, None]).numpy(),
                                  lm.rnn_time_step(ids[:, :1, None]).numpy())
    labels = np.eye(5, dtype=np.float32)[ids.astype(int)]
    copy.fit(ids, labels)
    lm.fit(ids, labels)                      # same draws from the copied generator
    np.testing.assert_array_equal(copy.params["embed"]["W"].numpy(),
                                  lm.params["embed"]["W"].numpy())


def test_iteration_and_score_conditions(tmp_path):
    """The time, invalid-score and best-score conditions (the JAX
    classes' rules), and the single-process distributed case: a loss
    calculator over a validation set, four epochs, a best model."""
    t = es.MaxTimeIterationTerminationCondition(0.0)
    t.initialize()
    assert t.terminate(1.0)
    inv = es.InvalidScoreIterationTerminationCondition()
    assert inv.terminate(math.nan) and inv.terminate(math.inf) and not inv.terminate(1.0)
    best = es.BestScoreEpochTerminationCondition(0.5)
    assert best.terminate(0, 0.4) and not best.terminate(0, 0.6)
    assert es.BestScoreEpochTerminationCondition(0.5, minimize=False).terminate(0, 0.6)
    with enable_x64(True):
        net = _pair(tmp_path, _jnet(seed=2))
    f, l = _arrays(32, 3)
    l = np.eye(3, dtype=np.float32)[(f[:, 0] > 0).astype(int)]
    train = ListDataSetIterator([DataSet(f[:16], l[:16]), DataSet(f[16:], l[16:])])
    val = ListDataSetIterator([DataSet(f, l)])
    calc = es.DataSetLossCalculator(val)
    conf = es.EarlyStoppingConfiguration(model_saver=es.InMemoryModelSaver(),
                                         score_calculator=calc,
                                         epoch_termination_conditions=[
                                             es.MaxEpochsTerminationCondition(4)])
    result = es.EarlyStoppingTrainer(conf, net, train).fit()
    assert result.best_model is not None and result.total_epochs == 4
    assert np.isfinite(calc.calculate_score(net))
    assert 0.0 <= net.evaluate(val).accuracy() <= 1.0
    assert es.EarlyStoppingGraphTrainer is es.EarlyStoppingTrainer

