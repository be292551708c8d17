"""ROC / AUC evaluation.

Counterpart of ``deeplearning4j_tpu/eval/roc.py`` (reference ``ROC.java``,
``ROCBinary.java``, ``ROCMultiClass.java``): exact mode (threshold_steps=0,
every distinct score a threshold, trapezoidal AUC) and thresholded mode (a
fixed threshold grid). Scores and labels are collected on the host in
float64, as ``_flatten_masked`` does in the JAX package: a tensor is masked
where it lives, copied in its own type and widened on the host (exact for
bf16, f16 and f32).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch


def host_f64(a) -> np.ndarray:
    """``a`` (numpy or a tensor anywhere) as a host float64 array."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):     # numpy has no bf16
            t = t.float()
        return t.numpy().astype(np.float64)
    return np.asarray(a, dtype=np.float64)


def _select(a, m):
    """Rows of ``a`` where the host bool ``m`` holds, picked where ``a``
    lives."""
    if isinstance(a, torch.Tensor):
        return a[torch.as_tensor(m, device=a.device)]
    return np.asarray(a)[m]


def _flatten_masked(labels, predictions, mask):
    labels, predictions = (a if isinstance(a, torch.Tensor) else np.asarray(a)
                           for a in (labels, predictions))

    def mask_rows(n):
        return (mask.detach().cpu().numpy() if isinstance(mask, torch.Tensor)
                else np.asarray(mask)).reshape(n) > 0

    if labels.ndim == 3:
        b, t, c = labels.shape
        labels = labels.reshape(b * t, c)
        predictions = predictions.reshape(b * t, c)
        if mask is not None:
            m = mask_rows(b * t)
            labels, predictions = _select(labels, m), _select(predictions, m)
    elif mask is not None:
        m = mask_rows(int(np.prod(mask.shape)))
        labels, predictions = _select(labels, m), _select(predictions, m)
    return host_f64(labels), host_f64(predictions)


def _auc(x: np.ndarray, y: np.ndarray) -> float:
    """Trapezoidal area under the curve, points already in sweep order
    (descending threshold → x ascending; vertical segments contribute 0)."""
    return float(np.trapezoid(y, x))


def _sweep_counts(scores: np.ndarray, truth: np.ndarray, threshold_steps: int):
    """(thresholds, tp, fp) for a descending-threshold sweep with ``>=``
    semantics, O(N log N): scores sorted descending, positives summed
    cumulatively. Endpoints: +inf (nothing positive) first, -inf
    (everything positive) last."""
    order = np.argsort(-scores, kind="stable")
    s_sorted = scores[order]
    t_sorted = truth[order] > 0
    cum_tp = np.cumsum(t_sorted)
    cum_fp = np.cumsum(~t_sorted)
    if threshold_steps > 0:
        thresholds = np.linspace(0.0, 1.0, threshold_steps + 1)[::-1]
    else:
        thresholds = np.unique(scores)[::-1]
    thresholds = np.concatenate([[np.inf], thresholds, [-np.inf]])
    # number of scores >= t  ==  position found by searchsorted on -s_sorted
    counts = np.searchsorted(-s_sorted, -thresholds, side="right")
    tp = np.where(counts > 0, cum_tp[np.maximum(counts - 1, 0)], 0)
    fp = np.where(counts > 0, cum_fp[np.maximum(counts - 1, 0)], 0)
    return thresholds, tp.astype(np.float64), fp.astype(np.float64)


def _roc_curve(scores: np.ndarray, truth: np.ndarray,
               threshold_steps: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(thresholds, fpr, tpr). Exact mode when threshold_steps == 0."""
    p = truth.sum()
    n = len(truth) - p
    thresholds, tp, fp = _sweep_counts(scores, truth, threshold_steps)
    tpr = tp / p if p else np.zeros_like(tp)
    fpr = fp / n if n else np.zeros_like(fp)
    return thresholds, fpr, tpr


def _pr_curve(scores: np.ndarray, truth: np.ndarray,
              threshold_steps: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(thresholds, recall, precision). The +inf start point pins
    (recall 0, precision 1) by convention."""
    p = truth.sum()
    thresholds, tp, fp = _sweep_counts(scores, truth, threshold_steps)
    pred_pos = tp + fp
    precision = np.where(pred_pos > 0, tp / np.maximum(pred_pos, 1), 1.0)
    recall = tp / p if p else np.zeros_like(tp)
    return thresholds, recall, precision


class RocCurve:
    def __init__(self, thresholds, fpr, tpr):
        self.thresholds = thresholds
        self.fpr = fpr
        self.tpr = tpr

    def calculate_auc(self) -> float:
        return _auc(self.fpr, self.tpr)

    calculateAUC = calculate_auc


class PrecisionRecallCurve:
    def __init__(self, thresholds, recall, precision):
        self.thresholds = thresholds
        self.recall = recall
        self.precision = precision

    def calculate_auprc(self) -> float:
        return _auc(self.recall, self.precision)

    calculateAUPRC = calculate_auprc


class ROC:
    """Binary ROC. Accepts single-column probabilities (positive class) or
    2-column one-hot/softmax output (column 1 = positive), like the reference.
    ``threshold_steps=0`` → exact mode."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = int(threshold_steps)
        self._scores: List[np.ndarray] = []
        self._truth: List[np.ndarray] = []

    def eval(self, labels, predictions, mask=None):
        labels, predictions = _flatten_masked(labels, predictions, mask)
        if labels.ndim == 2 and labels.shape[1] == 2:
            truth = labels[:, 1]
            scores = predictions[:, 1]
        else:
            truth = labels.ravel()
            scores = predictions.ravel()
        self._truth.append(truth)
        self._scores.append(scores)

    def _collect(self):
        if not self._scores:
            return np.zeros(0), np.zeros(0)
        return np.concatenate(self._scores), np.concatenate(self._truth)

    def get_roc_curve(self) -> RocCurve:
        scores, truth = self._collect()
        return RocCurve(*_roc_curve(scores, truth, self.threshold_steps))

    getRocCurve = get_roc_curve

    def get_precision_recall_curve(self) -> PrecisionRecallCurve:
        scores, truth = self._collect()
        return PrecisionRecallCurve(*_pr_curve(scores, truth,
                                               self.threshold_steps))

    getPrecisionRecallCurve = get_precision_recall_curve

    def calculate_auc(self) -> float:
        return self.get_roc_curve().calculate_auc()

    calculateAUC = calculate_auc

    def calculate_auprc(self) -> float:
        return self.get_precision_recall_curve().calculate_auprc()

    calculateAUPRC = calculate_auprc


class ROCBinary:
    """Per-output independent binary ROC (reference ``ROCBinary.java``) for
    multi-label sigmoid outputs [n, L]."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = int(threshold_steps)
        self._per_label: Optional[List[ROC]] = None

    def eval(self, labels, predictions, mask=None):
        labels, predictions = _flatten_masked(labels, predictions, mask)
        n_labels = labels.shape[1]
        if self._per_label is None:
            self._per_label = [ROC(self.threshold_steps) for _ in range(n_labels)]
        for i in range(n_labels):
            self._per_label[i].eval(labels[:, i], predictions[:, i])

    def num_labels(self) -> int:
        return 0 if self._per_label is None else len(self._per_label)

    def calculate_auc(self, label_idx: int) -> float:
        return self._per_label[label_idx].calculate_auc()

    calculateAUC = calculate_auc

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self._per_label]))

    calculateAverageAUC = calculate_average_auc


class ROCMultiClass:
    """One-vs-all ROC per class on softmax output (reference
    ``ROCMultiClass.java``)."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = int(threshold_steps)
        self._per_class: Optional[List[ROC]] = None

    def eval(self, labels, predictions, mask=None):
        labels, predictions = _flatten_masked(labels, predictions, mask)
        n_classes = labels.shape[1]
        if self._per_class is None:
            self._per_class = [ROC(self.threshold_steps) for _ in range(n_classes)]
        for i in range(n_classes):
            self._per_class[i].eval(labels[:, i], predictions[:, i])

    def calculate_auc(self, class_idx: int) -> float:
        return self._per_class[class_idx].calculate_auc()

    calculateAUC = calculate_auc

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self._per_class]))

    calculateAverageAUC = calculate_average_auc


def merge_summed_fields(dst, src, fields, empty):
    """Shared evaluation-merge machinery: field-wise count summation with
    empty-side handling (the reduce step of distributed evaluation). ``empty``
    tests whether an evaluation has seen data yet."""
    if empty(src):
        return dst
    if empty(dst):
        for f in fields:
            setattr(dst, f, np.zeros_like(getattr(src, f)))
    for f in fields:
        setattr(dst, f, getattr(dst, f) + getattr(src, f))
    return dst
