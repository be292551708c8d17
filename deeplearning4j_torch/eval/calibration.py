"""Probability calibration evaluation.

Counterpart of ``deeplearning4j_tpu/eval/calibration.py`` (reference
``eval/EvaluationCalibration.java``): reliability diagram bins (mean
predicted probability vs observed frequency per bin), residual-plot
histogram and probability histograms, accumulated over ``eval`` calls. The
bins are ``(p * bins).astype(int)`` of the host float64 values
(``roc._flatten_masked``): binned in f32 on the card, values near k/bins
would fall into other bins than the JAX package's.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .roc import _flatten_masked


class EvaluationCalibration:
    def __init__(self, reliability_bins: int = 10, histogram_bins: int = 10):
        self.reliability_bins = int(reliability_bins)
        self.histogram_bins = int(histogram_bins)
        # per class: sums of predicted prob, counts of positives, totals per bin
        self._prob_sum: Optional[np.ndarray] = None     # [C, bins]
        self._pos_count: Optional[np.ndarray] = None    # [C, bins]
        self._total: Optional[np.ndarray] = None        # [C, bins]
        self._residual_hist: Optional[np.ndarray] = None  # [hist_bins]
        self._prob_hist: Optional[np.ndarray] = None      # [C, hist_bins]

    def _ensure(self, c):
        if self._prob_sum is None:
            b = self.reliability_bins
            self._prob_sum = np.zeros((c, b))
            self._pos_count = np.zeros((c, b))
            self._total = np.zeros((c, b))
            self._residual_hist = np.zeros(self.histogram_bins)
            self._prob_hist = np.zeros((c, self.histogram_bins))

    def eval(self, labels, predictions, mask=None):
        labels, predictions = _flatten_masked(labels, predictions, mask)
        if labels.ndim == 1:  # single-output sigmoid model
            labels = labels[:, None]
            predictions = predictions[:, None]
        c = labels.shape[1]
        self._ensure(c)
        bins = np.clip((predictions * self.reliability_bins).astype(int), 0,
                       self.reliability_bins - 1)
        for cls in range(c):
            np.add.at(self._prob_sum[cls], bins[:, cls], predictions[:, cls])
            np.add.at(self._pos_count[cls], bins[:, cls], labels[:, cls])
            np.add.at(self._total[cls], bins[:, cls], 1.0)
        resid = np.abs(labels - predictions).mean(axis=1)
        rbins = np.clip((resid * self.histogram_bins).astype(int), 0,
                        self.histogram_bins - 1)
        np.add.at(self._residual_hist, rbins, 1.0)
        pbins = np.clip((predictions * self.histogram_bins).astype(int), 0,
                        self.histogram_bins - 1)
        for cls in range(c):
            np.add.at(self._prob_hist[cls], pbins[:, cls], 1.0)

    # ------------------------------------------------------------------
    def get_reliability_diagram(self, class_idx: int):
        """(mean predicted prob per bin, observed positive frequency per bin)."""
        t = self._total[class_idx]
        with np.errstate(invalid="ignore", divide="ignore"):
            mean_pred = np.where(t > 0, self._prob_sum[class_idx] / np.maximum(t, 1), np.nan)
            frac_pos = np.where(t > 0, self._pos_count[class_idx] / np.maximum(t, 1), np.nan)
        return mean_pred, frac_pos

    getReliabilityDiagram = get_reliability_diagram

    def expected_calibration_error(self, class_idx: int) -> float:
        mean_pred, frac_pos = self.get_reliability_diagram(class_idx)
        t = self._total[class_idx]
        n = t.sum()
        if n == 0:
            return 0.0
        valid = t > 0
        return float(np.sum(t[valid] * np.abs(mean_pred[valid] - frac_pos[valid])) / n)

    def get_residual_plot(self):
        return self._residual_hist.copy()

    getResidualPlot = get_residual_plot

    def get_probability_histogram(self, class_idx: int):
        return self._prob_hist[class_idx].copy()

    getProbabilityHistogram = get_probability_histogram
