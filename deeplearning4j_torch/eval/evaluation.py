"""Classification evaluation: accuracy/precision/recall/F1 + confusion matrix.

Counterpart of ``deeplearning4j_tpu/eval/evaluation.py`` (reference
``eval/Evaluation.java``). ``eval(labels, predictions, mask)`` takes numpy
arrays or tensors; time series [b, T, C] are flattened to [b*T, C] and the
[b, T] mask picks the rows that count. Each of labels and predictions is
reduced where it lives: a tensor on the card is ranked on the card and only
its [N] class indices (and, with ``top_n`` > 1, its [N, top_n] ranking)
cross to the host, so a [4, 8192, 4096] prediction is never copied whole;
the mask is applied to those indices on the host. The confusion matrix is
host int64, as in the JAX package, so ``merge`` and every metric are its
code. Ties go to the first index (``np.argmax``'s rule; ``torch.argmax``
keeps it on the card), and ``top_n`` ranks descending with ties to the
lower index (a stable sort). ``host_bytes`` counts the bytes this
evaluation copied from a device to the host (indices, and a mask that
lies there), and ``eval_ms`` the host
clock spent reducing labels and predictions (the predictions' includes
their device work, which the copy waits for).
"""
from __future__ import annotations

import time

import numpy as np
import torch


def _rows(a):
    """``a`` as [N, C] rows (a time series [b, T, C] flattened), numpy or
    tensor as given."""
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
    return a.reshape(-1, a.shape[-1]) if a.ndim == 3 else a


def _host(t: torch.Tensor, counter) -> np.ndarray:
    """A tensor's values on the host; a copy off a device adds its bytes
    to ``counter.host_bytes``."""
    if t.device.type != "cpu":
        counter.host_bytes += t.numel() * t.element_size()
    return t.detach().cpu().numpy()


def argmax_rows(a, counter):
    """[N] int64 class index of each row, first index on ties, computed
    where ``a`` lives."""
    if isinstance(a, torch.Tensor):
        return _host(torch.argmax(a.detach(), dim=-1), counter).astype(np.int64)
    return np.argmax(a, axis=-1).astype(np.int64)


def top_n_rows(a, n, counter):
    """[N, n] the n highest classes of each row, descending, ties to the
    lower index, computed where ``a`` lives."""
    if isinstance(a, torch.Tensor):
        order = torch.sort(a.detach(), dim=-1, descending=True, stable=True).indices
        return _host(order[:, :n], counter)
    return np.argsort(-a, axis=-1, kind="stable")[:, :n]


def row_mask(mask, n_rows, counter):
    """The host bool [N] of rows that count, or None (``mask > 0``)."""
    if mask is None:
        return None
    m = _host(mask, counter) if isinstance(mask, torch.Tensor) else np.asarray(mask)
    return m.reshape(n_rows) > 0


class ConfusionMatrix:
    def __init__(self, num_classes):
        self.matrix = np.zeros((num_classes, num_classes), dtype=np.int64)

    def add(self, actual, predicted):
        np.add.at(self.matrix, (actual, predicted), 1)

    def get_count(self, actual, predicted):
        return int(self.matrix[actual, predicted])


class Evaluation:
    def __init__(self, num_classes=None, top_n=1):
        self.num_classes = num_classes
        self.top_n = top_n
        self.confusion = None
        self.top_n_correct = 0
        self.total = 0
        self.host_bytes = 0
        self.eval_ms = {"labels": 0.0, "predictions": 0.0}

    # ------------------------------------------------------------------
    def _ensure(self, n):
        if self.confusion is None:
            self.num_classes = self.num_classes or n
            self.confusion = ConfusionMatrix(self.num_classes)

    def eval(self, labels, predictions, mask=None):
        labels, predictions = _rows(labels), _rows(predictions)
        # the JAX package applies a mask to flattened series and to [N, C]
        # rows alike
        keep = row_mask(mask, labels.shape[0], self)
        t0 = time.perf_counter()
        actual = argmax_rows(labels, self)
        t1 = time.perf_counter()
        pred = argmax_rows(predictions, self)
        topn = top_n_rows(predictions, self.top_n, self) if self.top_n > 1 else None
        t2 = time.perf_counter()
        self.eval_ms["labels"] += (t1 - t0) * 1e3
        self.eval_ms["predictions"] += (t2 - t1) * 1e3
        if keep is not None:
            actual, pred = actual[keep], pred[keep]
            topn = None if topn is None else topn[keep]
        self._ensure(labels.shape[-1])
        self.confusion.add(actual, pred)
        self.total += len(actual)
        if topn is not None:
            self.top_n_correct += int(np.sum(topn == actual[:, None]))

    def merge(self, other: "Evaluation"):
        """Combine another Evaluation's counts into this one (reference
        ``Evaluation.merge`` — the reduce step of Spark's distributed
        evaluation, ``IEvaluationReduceFunction.java``)."""
        if other.confusion is None:
            return self
        if self.confusion is None:
            self._ensure(other.num_classes)
        self.confusion.matrix += other.confusion.matrix
        self.total += other.total
        self.top_n_correct += other.top_n_correct
        return self

    # ------------------------------------------------------------- metrics
    def _tp(self, i):
        return self.confusion.matrix[i, i]

    def _fp(self, i):
        return self.confusion.matrix[:, i].sum() - self._tp(i)

    def _fn(self, i):
        return self.confusion.matrix[i, :].sum() - self._tp(i)

    def accuracy(self) -> float:
        if self.total == 0:
            return 0.0
        return float(np.trace(self.confusion.matrix)) / self.total

    def top_n_accuracy(self) -> float:
        if self.total == 0 or self.top_n <= 1:
            return self.accuracy()
        return self.top_n_correct / self.total

    def precision(self, cls=None) -> float:
        if cls is not None:
            d = self._tp(cls) + self._fp(cls)
            return float(self._tp(cls)) / d if d else 0.0
        vals = [self.precision(i) for i in range(self.num_classes)
                if (self.confusion.matrix[i, :].sum() + self.confusion.matrix[:, i].sum()) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, cls=None) -> float:
        if cls is not None:
            d = self._tp(cls) + self._fn(cls)
            return float(self._tp(cls)) / d if d else 0.0
        vals = [self.recall(i) for i in range(self.num_classes)
                if self.confusion.matrix[i, :].sum() > 0]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, cls=None) -> float:
        p = self.precision(cls)
        r = self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def false_positive_rate(self, cls) -> float:
        tn = self.total - self._tp(cls) - self._fp(cls) - self._fn(cls)
        d = self._fp(cls) + tn
        return float(self._fp(cls)) / d if d else 0.0

    def matthews_correlation(self, cls) -> float:
        tp, fp, fn = self._tp(cls), self._fp(cls), self._fn(cls)
        tn = self.total - tp - fp - fn
        num = tp * tn - fp * fn
        den = np.sqrt(float((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)))
        return float(num) / den if den else 0.0

    def stats(self) -> str:
        lines = [
            "==========================Scores========================================",
            f" Accuracy:        {self.accuracy():.4f}",
            f" Precision:       {self.precision():.4f}",
            f" Recall:          {self.recall():.4f}",
            f" F1 Score:        {self.f1():.4f}",
            "========================================================================",
        ]
        if self.top_n > 1:
            lines.insert(2, f" Top {self.top_n} Accuracy: {self.top_n_accuracy():.4f}")
        return "\n".join(lines)
