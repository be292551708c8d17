"""The port's evaluation classes (``deeplearning4j_torch/eval/``) against the
JAX package's on the same seeded numpy inputs.

Held: confusion counts, totals and every binary/calibration count exactly;
float metrics within 1e-12 (the JAX classes compute in float64 on the host,
the port's too). Inputs go to the port as numpy arrays, as CPU tensors and
as bf16 tensors (the JAX side gets the same values widened to f32, which
keeps every tie). Cases: masks and time series, ``merge``, first-index
ties, ``top_n`` with its tie rule, calibration values on the k/10 bin
boundaries, ROC in exact and thresholded modes, and the single-process
cases of ``tests/test_distributed_eval.py`` and ``tests/test_eval_extras.py``.
What crosses to the host for a tensor is checked by recording every copy
``eval/evaluation.py`` makes: class indices only.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.eval import (ROC as JROC, ROCBinary as JROCBinary,
                                     ROCMultiClass as JROCMultiClass,
                                     EvaluationBinary as JEvaluationBinary,
                                     EvaluationCalibration as JEvaluationCalibration)
from deeplearning4j_tpu.eval.evaluation import Evaluation as JEvaluation
from deeplearning4j_tpu.eval.regression import RegressionEvaluation as JRegressionEvaluation

from deeplearning4j_torch.eval import (ROC, EvaluationBinary, EvaluationCalibration,
                                       Evaluation, RegressionEvaluation, ROCBinary,
                                       ROCMultiClass)
from deeplearning4j_torch.eval import evaluation as peval

METRIC_ATOL = 1e-12


def _onehot(rng, n, c, dtype=np.float32):
    return np.eye(c, dtype=dtype)[rng.integers(0, c, n)]


def _as(kind, a):
    """``a`` as the port receives it: numpy, a CPU tensor, or bf16."""
    if kind == "numpy":
        return a
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.bfloat16) if kind == "bf16" else t


def _jax_view(kind, a):
    """The same values for the JAX class (bf16 widened to f32: exact)."""
    return _as(kind, a).float().numpy() if kind == "bf16" else a


def _assert_same_evaluation(ev, jev):
    np.testing.assert_array_equal(ev.confusion.matrix, jev.confusion.matrix)
    assert ev.total == jev.total and ev.top_n_correct == jev.top_n_correct
    assert ev.num_classes == jev.num_classes
    for name in ("accuracy", "top_n_accuracy", "precision", "recall", "f1"):
        assert abs(getattr(ev, name)() - getattr(jev, name)()) <= METRIC_ATOL, name
    for c in range(ev.num_classes):
        for name in ("precision", "recall", "f1", "false_positive_rate",
                     "matthews_correlation"):
            assert abs(getattr(ev, name)(c) - getattr(jev, name)(c)) <= METRIC_ATOL, (name, c)
    assert ev.stats() == jev.stats()


# ---------------------------------------------------------------- Evaluation
@pytest.mark.parametrize("kind", ["numpy", "tensor", "bf16"])
@pytest.mark.parametrize("shape", ["rows", "rows_masked", "series", "series_masked"])
def test_evaluation_matches_jax(kind, shape):
    """Rows [N, C] and time series [b, T, C], with and without a mask
    (fractional values: > 0 counts), over three eval calls."""
    rng = np.random.default_rng(sum(map(ord, kind + shape)))
    ev, jev = Evaluation(), JEvaluation()
    for _ in range(3):
        if shape.startswith("rows"):
            labels = _onehot(rng, 40, 5)
            preds = rng.random((40, 5)).astype(np.float32)
            mask = (rng.random(40) > 0.3).astype(np.float32) * 0.5
        else:
            labels = _onehot(rng, 4 * 7, 5).reshape(4, 7, 5)
            preds = rng.random((4, 7, 5)).astype(np.float32)
            mask = (rng.random((4, 7)) > 0.3).astype(np.float32)
        mask = mask if shape.endswith("masked") else None
        ev.eval(_as(kind, labels), _as(kind, preds), mask=mask)
        jev.eval(_jax_view(kind, labels), _jax_view(kind, preds), mask=mask)
    _assert_same_evaluation(ev, jev)


def test_evaluation_bf16_ties_go_to_the_first_index():
    """bf16 predictions on a coarse grid tie often; the port's argmax on
    the tensor takes the first of the tied classes, as ``np.argmax`` does
    on the JAX side."""
    rng = np.random.default_rng(3)
    preds = np.round(rng.random((500, 6)) * 4) / 4          # 5 levels: many ties
    labels = _onehot(rng, 500, 6)
    t = torch.tensor(preds, dtype=torch.bfloat16)
    assert (t == t.max(-1, keepdim=True).values).sum(-1).gt(1).sum() > 100
    ev, jev = Evaluation(), JEvaluation()
    ev.eval(labels, t)
    jev.eval(labels, t.float().numpy())
    _assert_same_evaluation(ev, jev)
    first = np.argmax(t.float().numpy(), axis=-1)
    assert ev.confusion.matrix.sum(0).tolist() == np.bincount(first, minlength=6).tolist()


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_evaluation_top_n_matches_jax_without_ties(kind):
    """top_n=3 on distinct scores (JAX ranks with ``np.argsort(-p)``, which
    is not stable, so ties are left to the next case)."""
    rng = np.random.default_rng(4)
    labels = _onehot(rng, 60, 7)
    preds = rng.permuted(np.tile(np.arange(7, dtype=np.float32), (60, 1)), axis=1)
    ev, jev = Evaluation(top_n=3), JEvaluation(top_n=3)
    ev.eval(_as(kind, labels), _as(kind, preds))
    jev.eval(labels, preds)
    _assert_same_evaluation(ev, jev)


def test_evaluation_top_n_ties_rank_the_lower_index_first():
    """The port's tie rule for ``top_n``: descending, ties to the lower
    class index (a stable sort), on the host and on a tensor alike."""
    labels = np.eye(4, dtype=np.float32)[[3, 2, 1]]
    preds = np.array([[0.5, 0.5, 0.5, 0.5],       # top 2: 0, 1 -> class 3 misses
                      [0.1, 0.7, 0.7, 0.1],       # top 2: 1, 2 -> class 2 hits
                      [0.9, 0.2, 0.2, 0.2]], np.float32)  # top 2: 0, 1 -> hits
    for p in (preds, torch.from_numpy(preds), torch.from_numpy(preds).to(torch.bfloat16)):
        ev = Evaluation(top_n=2)
        ev.eval(labels, p)
        assert ev.top_n_correct == 2 and ev.top_n_accuracy() == pytest.approx(2 / 3)


def test_evaluation_merge_equals_joint_eval():
    """``tests/test_distributed_eval.py::test_evaluation_merge_equals_joint_eval``
    on the port, and the merged port counts equal the merged JAX counts."""
    rng = np.random.default_rng(0)
    l1, p1 = _onehot(rng, 30, 4), rng.random((30, 4)).astype(np.float32)
    l2, p2 = _onehot(rng, 20, 4), rng.random((20, 4)).astype(np.float32)
    a, b, joint = Evaluation(), Evaluation(), Evaluation()
    a.eval(l1, torch.from_numpy(p1))
    b.eval(l2, p2)
    joint.eval(np.concatenate([l1, l2]), np.concatenate([p1, p2]))
    ja, jb = JEvaluation(), JEvaluation()
    ja.eval(l1, p1)
    jb.eval(l2, p2)
    a.merge(b)
    ja.merge(jb)
    assert a.total == joint.total == 50
    np.testing.assert_array_equal(a.confusion.matrix, joint.confusion.matrix)
    assert abs(a.accuracy() - joint.accuracy()) < METRIC_ATOL
    assert abs(a.f1() - joint.f1()) < METRIC_ATOL
    _assert_same_evaluation(a, ja)
    assert Evaluation().merge(a).total == 50 and a.merge(Evaluation()).total == 50


def test_only_class_indices_cross_to_the_host(monkeypatch):
    """A tensor's rows are reduced where they live: every copy the
    evaluation makes is an [N] index vector (an [N, top_n] ranking with
    top_n), never the [N, C] predictions."""
    copied = []
    real = peval._host

    def host(t, counter):
        copied.append(tuple(t.shape))
        return real(t, counter)
    monkeypatch.setattr(peval, "_host", host)
    rng = np.random.default_rng(5)
    labels = torch.from_numpy(_onehot(rng, 3 * 11, 9).reshape(3, 11, 9))
    preds = torch.from_numpy(rng.random((3, 11, 9)).astype(np.float32))
    ev = Evaluation(top_n=2)
    ev.eval(labels, preds, mask=np.ones((3, 11)))
    assert copied == [(33,), (33,), (33, 2)]
    assert ev.host_bytes == 0          # CPU tensors: nothing left a device
    assert set(ev.eval_ms) == {"labels", "predictions"}


# ------------------------------------------------------------------- regression
@pytest.mark.parametrize("kind", ["numpy", "tensor", "bf16"])
def test_regression_matches_jax(kind):
    """Every metric per column and averaged, over a time series with a
    mask and a row batch, and ``merge`` (the JAX package's
    ``test_regression_and_binary_merge`` half)."""
    rng = np.random.default_rng(1)
    la, pa = rng.random((10, 3)), rng.random((10, 3))
    lb, pb = rng.random((2, 5, 3)), rng.random((2, 5, 3))
    mb = (rng.random((2, 5)) > 0.4).astype(np.float32)
    if kind != "numpy":
        la, pa, lb, pb = (a.astype(np.float32) for a in (la, pa, lb, pb))
    r1, r2 = RegressionEvaluation(), RegressionEvaluation()
    r1.eval(_as(kind, la), _as(kind, pa))
    r2.eval(_as(kind, lb), _as(kind, pb), mask=mb)
    j1, j2 = JRegressionEvaluation(), JRegressionEvaluation()
    j1.eval(_jax_view(kind, la), _jax_view(kind, pa))
    j2.eval(_jax_view(kind, lb), _jax_view(kind, pb), mask=mb)
    r1.merge(r2)
    j1.merge(j2)
    assert r1.n == j1.n == 10 + int(mb.sum())
    for name in ("mean_squared_error", "mean_absolute_error", "root_mean_squared_error",
                 "correlation_r2", "pearson_correlation"):
        for col in (None, 0, 1, 2):
            assert abs(getattr(r1, name)(col) - getattr(j1, name)(col)) <= METRIC_ATOL
    assert r1.stats() == j1.stats()


# ---------------------------------------------------------------------- binary
@pytest.mark.parametrize("kind", ["numpy", "tensor", "bf16"])
def test_evaluation_binary_matches_jax(kind):
    """Per-label counts exactly, with a mask, a 1-D single-label input, and
    ``merge`` equal to the joint evaluation (``test_distributed_eval``)."""
    rng = np.random.default_rng(2)
    bl = (rng.random((25, 3)) > 0.5).astype(np.float32)
    bp = rng.random((25, 3)).astype(np.float32)
    m = (rng.random(25) > 0.2).astype(np.float32)
    e1, e2, ej = EvaluationBinary(), EvaluationBinary(), EvaluationBinary()
    e1.eval(_as(kind, bl[:10]), _as(kind, bp[:10]), mask=m[:10])
    e2.eval(_as(kind, bl[10:]), _as(kind, bp[10:]), mask=m[10:])
    ej.eval(_as(kind, bl), _as(kind, bp), mask=m)
    jev = JEvaluationBinary()
    jev.eval(_jax_view(kind, bl), _jax_view(kind, bp), mask=m)
    e1.merge(e2)
    for f in ("tp", "fp", "tn", "fn"):
        np.testing.assert_array_equal(getattr(e1, f), getattr(jev, f))
        np.testing.assert_array_equal(getattr(ej, f), getattr(jev, f))
    for i in range(3):
        for name in ("accuracy", "precision", "recall", "f1"):
            assert abs(getattr(e1, name)(i) - getattr(jev, name)(i)) <= METRIC_ATOL
    assert e1.stats() == jev.stats()
    one, jone = EvaluationBinary(0.3), JEvaluationBinary(0.3)
    one.eval(_as(kind, bl[:, 0]), _as(kind, bp[:, 0]))
    jone.eval(_jax_view(kind, bl[:, 0]), _jax_view(kind, bp[:, 0]))
    np.testing.assert_array_equal(one.tp, jone.tp)
    np.testing.assert_array_equal(one.tn, jone.tn)


def test_evaluation_binary_per_label():
    """``tests/test_eval_extras.py::test_evaluation_binary_per_label`` on
    the port."""
    ev = EvaluationBinary()
    labels = np.array([[1, 0], [1, 1], [0, 0], [0, 1]], dtype=np.float64)
    preds = np.array([[0.9, 0.1], [0.8, 0.4], [0.2, 0.3], [0.1, 0.9]])
    ev.eval(labels, preds)
    assert ev.num_labels() == 2
    assert ev.accuracy(0) == 1.0
    assert ev.accuracy(1) == 0.75
    assert ev.recall(1) == 0.5


# ----------------------------------------------------------------- calibration
@pytest.mark.parametrize("kind", ["numpy", "tensor", "bf16"])
def test_calibration_on_the_bin_boundaries_matches_jax(kind):
    """Probabilities k/10 in f32 (0.7f is 0.69999998 in f64, bin 6, where
    an f32 product 0.7f * 10 rounds to bin 7) and random ones: every bin
    count and sum as the JAX package's, and the reliability diagram, ECE,
    residual plot and histograms within 1e-12."""
    rng = np.random.default_rng(6)
    edges = np.tile(np.arange(11, dtype=np.float32) / 10, 4)
    p = np.concatenate([edges, rng.random(60).astype(np.float32)])
    probs = np.stack([1 - p, p], 1).astype(np.float32)
    labels = np.eye(2, dtype=np.float32)[(rng.random(len(p)) < p).astype(int)]
    ev, jev = EvaluationCalibration(), JEvaluationCalibration()
    ev.eval(_as(kind, labels), _as(kind, probs))
    jev.eval(_jax_view(kind, labels), _jax_view(kind, probs))
    # the trap: in f32 the product 0.7f * 10 rounds up into bin 7
    assert int(np.float32(0.7) * np.float32(10)) == 7 and int(float(np.float32(0.7)) * 10) == 6
    for f in ("_prob_sum", "_pos_count", "_total", "_residual_hist", "_prob_hist"):
        np.testing.assert_allclose(getattr(ev, f), getattr(jev, f), rtol=0, atol=METRIC_ATOL)
    np.testing.assert_array_equal(ev._total, jev._total)
    for c in range(2):
        for a, b in zip(ev.get_reliability_diagram(c), jev.get_reliability_diagram(c)):
            np.testing.assert_allclose(a, b, rtol=0, atol=METRIC_ATOL)
        assert abs(ev.expected_calibration_error(c) - jev.expected_calibration_error(c)) \
            <= METRIC_ATOL
        np.testing.assert_array_equal(ev.get_probability_histogram(c),
                                      jev.get_probability_histogram(c))
    np.testing.assert_array_equal(ev.get_residual_plot(), jev.get_residual_plot())


def test_calibration_reliability_well_calibrated_and_1d():
    """``test_calibration_reliability_well_calibrated`` and
    ``test_calibration_1d_input`` of ``tests/test_eval_extras.py`` on the
    port, series with a mask beside JAX's."""
    rng = np.random.default_rng(4)
    n = 20000
    probs = rng.random(n)
    truth = (rng.random(n) < probs).astype(np.float64)
    ev = EvaluationCalibration(reliability_bins=10)
    ev.eval(np.stack([1 - truth, truth], 1), np.stack([1 - probs, probs], 1))
    assert ev.expected_calibration_error(1) < 0.02
    mean_pred, frac_pos = ev.get_reliability_diagram(1)
    valid = ~np.isnan(mean_pred)
    np.testing.assert_allclose(mean_pred[valid], frac_pos[valid], atol=0.05)
    one = EvaluationCalibration()
    one.eval(np.array([0, 1, 1, 0], dtype=np.float64), np.array([0.2, 0.8, 0.6, 0.3]))
    assert one._total is not None
    series = rng.random((3, 5, 2)).astype(np.float32)
    lab = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (3, 5))]
    m = (rng.random((3, 5)) > 0.5).astype(np.float32)
    ev, jev = EvaluationCalibration(5, 4), JEvaluationCalibration(5, 4)
    ev.eval(torch.from_numpy(lab), torch.from_numpy(series), mask=m)
    jev.eval(lab, series, mask=m)
    np.testing.assert_array_equal(ev._total, jev._total)
    np.testing.assert_allclose(ev._prob_sum, jev._prob_sum, rtol=0, atol=METRIC_ATOL)


# -------------------------------------------------------------------------- ROC
@pytest.mark.parametrize("steps", [0, 200])
@pytest.mark.parametrize("kind", ["numpy", "tensor", "bf16"])
def test_roc_family_matches_jax(kind, steps):
    """ROC (2-column and 1-column), ROCBinary and ROCMultiClass in exact
    (``threshold_steps=0``) and thresholded mode, over a time series with
    a mask and a row batch: every curve point equal and AUC/AUPRC within
    1e-12."""
    rng = np.random.default_rng(7 + steps)
    l2 = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (3, 8))]
    p = rng.random((3, 8)).astype(np.float32)
    p2 = np.stack([1 - p, p], -1)
    m = (rng.random((3, 8)) > 0.25).astype(np.float32)
    lm = (rng.random((40, 3)) > 0.5).astype(np.float32)
    pm = rng.random((40, 3)).astype(np.float32)
    lc = _onehot(rng, 40, 4)
    pc = rng.random((40, 4)).astype(np.float32)
    pc /= pc.sum(1, keepdims=True)
    roc, jroc = ROC(steps), JROC(steps)
    roc.eval(_as(kind, l2), _as(kind, p2), mask=m)
    jroc.eval(_jax_view(kind, l2), _jax_view(kind, p2), mask=m)
    roc.eval(_as(kind, lm[:, :1]), _as(kind, pm[:, :1]))
    jroc.eval(_jax_view(kind, lm[:, :1]), _jax_view(kind, pm[:, :1]))
    for a, b in zip((roc.get_roc_curve(), roc.get_precision_recall_curve()),
                    (jroc.get_roc_curve(), jroc.get_precision_recall_curve())):
        for f in vars(b):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=0, atol=METRIC_ATOL)
    assert abs(roc.calculate_auc() - jroc.calculate_auc()) <= METRIC_ATOL
    assert abs(roc.calculate_auprc() - jroc.calculate_auprc()) <= METRIC_ATOL
    rb, jrb = ROCBinary(steps), JROCBinary(steps)
    rb.eval(_as(kind, lm), _as(kind, pm))
    jrb.eval(_jax_view(kind, lm), _jax_view(kind, pm))
    assert rb.num_labels() == jrb.num_labels() == 3
    assert abs(rb.calculate_average_auc() - jrb.calculate_average_auc()) <= METRIC_ATOL
    rm, jrm = ROCMultiClass(steps), JROCMultiClass(steps)
    rm.eval(_as(kind, lc), _as(kind, pc))
    jrm.eval(_jax_view(kind, lc), _jax_view(kind, pc))
    for c in range(4):
        assert abs(rm.calculate_auc(c) - jrm.calculate_auc(c)) <= METRIC_ATOL
    assert abs(rm.calculate_average_auc() - jrm.calculate_average_auc()) <= METRIC_ATOL


def test_roc_cases_of_the_jax_suite():
    """``tests/test_eval_extras.py``'s ROC cases on the port: AUC against
    sklearn (1-column, 2-column, 200k scores in exact mode), the perfect
    classifier, thresholded close to exact, the multi-class average."""
    from sklearn.metrics import roc_auc_score
    rng = np.random.default_rng(0)
    truth = rng.integers(0, 2, 200)
    scores = np.clip(truth * 0.3 + rng.random(200) * 0.7, 0, 1)
    roc = ROC()
    roc.eval(truth.astype(np.float64), torch.from_numpy(scores))
    assert abs(roc.calculate_auc() - roc_auc_score(truth, scores)) < 1e-9
    perfect = ROC()
    perfect.eval(np.array([0, 0, 1, 1.0]), np.array([0.1, 0.2, 0.8, 0.9]))
    assert abs(perfect.calculate_auc() - 1.0) < 1e-9 and perfect.calculate_auprc() > 0.99
    rng = np.random.default_rng(1)
    labels = np.eye(2)[rng.integers(0, 2, 100)]
    p = rng.random(100)
    two = ROC()
    two.eval(labels, np.stack([1 - p, p], axis=1))
    assert abs(two.calculate_auc() - roc_auc_score(labels[:, 1], p)) < 1e-9
    rng = np.random.default_rng(2)
    t = rng.integers(0, 2, 500).astype(np.float64)
    s = np.clip(t * 0.4 + rng.random(500) * 0.6, 0, 1)
    exact, stepped = ROC(0), ROC(200)
    exact.eval(t, s)
    stepped.eval(t, s)
    assert abs(exact.calculate_auc() - stepped.calculate_auc()) < 0.01
    rng = np.random.default_rng(3)
    lab = np.eye(3)[rng.integers(0, 3, 300)]
    logits = lab * 1.5 + rng.normal(size=(300, 3))
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    mc = ROCMultiClass()
    mc.eval(lab, probs)
    assert 0.7 < mc.calculate_average_auc() <= 1.0
    assert all(0.5 < mc.calculate_auc(i) <= 1.0 for i in range(3))
    rng = np.random.default_rng(7)
    n = 200_000
    big_t = rng.integers(0, 2, n).astype(np.float64)
    big_s = np.clip(big_t * 0.2 + rng.random(n) * 0.8, 0, 1)
    big = ROC()
    big.eval(big_t, big_s)
    assert abs(big.calculate_auc() - roc_auc_score(big_t, big_s)) < 1e-9
