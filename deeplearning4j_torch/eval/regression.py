"""Regression evaluation: MSE, MAE, RMSE, RSE, PC, R^2 per column.

Counterpart of ``deeplearning4j_tpu/eval/regression.py`` (reference
``eval/RegressionEvaluation.java``). The sums run in float64 on the host,
as in the JAX package; a tensor is copied in its own type and widened
there. As in the JAX package, a mask applies to time series only.
"""
from __future__ import annotations

import numpy as np

from .roc import host_f64, merge_summed_fields


class RegressionEvaluation:
    def __init__(self, n_columns=None):
        self.n = 0
        self.sum_sq_err = None
        self.sum_abs_err = None
        self.sum_label = None
        self.sum_label_sq = None
        self.sum_pred = None
        self.sum_pred_sq = None
        self.sum_label_pred = None

    _STAT_FIELDS = ("sum_sq_err", "sum_abs_err", "sum_label", "sum_label_sq",
                    "sum_pred", "sum_pred_sq", "sum_label_pred")

    def merge(self, other: "RegressionEvaluation"):
        """Sum another evaluation's sufficient statistics into this one
        (reference ``RegressionEvaluation.merge``)."""
        merge_summed_fields(self, other, self._STAT_FIELDS,
                            empty=lambda e: e.n == 0)
        self.n += other.n
        return self

    def eval(self, labels, predictions, mask=None):
        labels = host_f64(labels)
        predictions = host_f64(predictions)
        if labels.ndim == 3:
            b, t, c = labels.shape
            labels = labels.reshape(b * t, c)
            predictions = predictions.reshape(b * t, c)
            if mask is not None:
                m = host_f64(mask).reshape(b * t) > 0
                labels, predictions = labels[m], predictions[m]
        if self.sum_sq_err is None:
            c = labels.shape[-1]
            self.sum_sq_err = np.zeros(c)
            self.sum_abs_err = np.zeros(c)
            self.sum_label = np.zeros(c)
            self.sum_label_sq = np.zeros(c)
            self.sum_pred = np.zeros(c)
            self.sum_pred_sq = np.zeros(c)
            self.sum_label_pred = np.zeros(c)
        err = predictions - labels
        self.sum_sq_err += np.sum(err ** 2, axis=0)
        self.sum_abs_err += np.sum(np.abs(err), axis=0)
        self.sum_label += np.sum(labels, axis=0)
        self.sum_label_sq += np.sum(labels ** 2, axis=0)
        self.sum_pred += np.sum(predictions, axis=0)
        self.sum_pred_sq += np.sum(predictions ** 2, axis=0)
        self.sum_label_pred += np.sum(labels * predictions, axis=0)
        self.n += labels.shape[0]

    def mean_squared_error(self, col=None):
        mse = self.sum_sq_err / max(self.n, 1)
        return float(mse[col]) if col is not None else float(np.mean(mse))

    def mean_absolute_error(self, col=None):
        mae = self.sum_abs_err / max(self.n, 1)
        return float(mae[col]) if col is not None else float(np.mean(mae))

    def root_mean_squared_error(self, col=None):
        mse = self.sum_sq_err / max(self.n, 1)
        rmse = np.sqrt(mse)
        return float(rmse[col]) if col is not None else float(np.mean(rmse))

    def correlation_r2(self, col=None):
        n = max(self.n, 1)
        ss_tot = self.sum_label_sq - (self.sum_label ** 2) / n
        ss_res = self.sum_sq_err
        r2 = 1.0 - ss_res / np.maximum(ss_tot, 1e-12)
        return float(r2[col]) if col is not None else float(np.mean(r2))

    def pearson_correlation(self, col=None):
        n = max(self.n, 1)
        cov = self.sum_label_pred - self.sum_label * self.sum_pred / n
        vl = self.sum_label_sq - self.sum_label ** 2 / n
        vp = self.sum_pred_sq - self.sum_pred ** 2 / n
        pc = cov / np.maximum(np.sqrt(vl * vp), 1e-12)
        return float(pc[col]) if col is not None else float(np.mean(pc))

    def stats(self) -> str:
        return (f"MSE: {self.mean_squared_error():.6f}  "
                f"MAE: {self.mean_absolute_error():.6f}  "
                f"RMSE: {self.root_mean_squared_error():.6f}  "
                f"R^2: {self.correlation_r2():.6f}")
