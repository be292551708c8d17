"""Per-label binary evaluation (multi-label sigmoid outputs).

Counterpart of ``deeplearning4j_tpu/eval/binary.py`` (reference
``eval/EvaluationBinary.java``): independent binary counts (TP/FP/TN/FN at
a decision threshold, default 0.5) per output column, with
accuracy/precision/recall/F1 per label. Inputs go through
``roc._flatten_masked`` (host float64), as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .roc import _flatten_masked, merge_summed_fields


class EvaluationBinary:
    def __init__(self, decision_threshold: float = 0.5):
        self.decision_threshold = float(decision_threshold)
        self.tp: Optional[np.ndarray] = None
        self.fp: Optional[np.ndarray] = None
        self.tn: Optional[np.ndarray] = None
        self.fn: Optional[np.ndarray] = None

    def _ensure(self, n):
        if self.tp is None:
            self.tp = np.zeros(n, np.int64)
            self.fp = np.zeros(n, np.int64)
            self.tn = np.zeros(n, np.int64)
            self.fn = np.zeros(n, np.int64)

    def merge(self, other: "EvaluationBinary"):
        """Sum per-label counts (reference ``EvaluationBinary.merge``)."""
        return merge_summed_fields(self, other, ("tp", "fp", "tn", "fn"),
                                   empty=lambda e: e.tp is None)

    def eval(self, labels, predictions, mask=None):
        labels, predictions = _flatten_masked(labels, predictions, mask)
        if labels.ndim == 1:
            labels = labels[:, None]
            predictions = predictions[:, None]
        self._ensure(labels.shape[1])
        pred = predictions >= self.decision_threshold
        truth = labels > 0.5
        self.tp += (pred & truth).sum(axis=0)
        self.fp += (pred & ~truth).sum(axis=0)
        self.tn += (~pred & ~truth).sum(axis=0)
        self.fn += (~pred & truth).sum(axis=0)

    # ------------------------------------------------------------- metrics
    def num_labels(self) -> int:
        return 0 if self.tp is None else len(self.tp)

    numLabels = num_labels

    def total_count(self, i) -> int:
        return int(self.tp[i] + self.fp[i] + self.tn[i] + self.fn[i])

    def accuracy(self, i) -> float:
        t = self.total_count(i)
        return float(self.tp[i] + self.tn[i]) / t if t else 0.0

    def precision(self, i) -> float:
        d = self.tp[i] + self.fp[i]
        return float(self.tp[i]) / d if d else 0.0

    def recall(self, i) -> float:
        d = self.tp[i] + self.fn[i]
        return float(self.tp[i]) / d if d else 0.0

    def f1(self, i) -> float:
        p, r = self.precision(i), self.recall(i)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def average_accuracy(self) -> float:
        return float(np.mean([self.accuracy(i) for i in range(self.num_labels())]))

    averageAccuracy = average_accuracy

    def average_f1(self) -> float:
        return float(np.mean([self.f1(i) for i in range(self.num_labels())]))

    averageF1 = average_f1

    def stats(self) -> str:
        lines = [f"{'label':>5} {'acc':>8} {'prec':>8} {'rec':>8} {'f1':>8}"]
        for i in range(self.num_labels()):
            lines.append(f"{i:>5} {self.accuracy(i):>8.4f} {self.precision(i):>8.4f} "
                         f"{self.recall(i):>8.4f} {self.f1(i):>8.4f}")
        return "\n".join(lines)
