"""Evaluation suite: counterpart of ``deeplearning4j_tpu/eval/``
(Evaluation, EvaluationBinary, EvaluationCalibration, the ROC family,
RegressionEvaluation). Each class takes numpy arrays or tensors, on the
card or the CPU; see ``evaluation.py`` for what crosses to the host."""
from .evaluation import Evaluation, ConfusionMatrix
from .regression import RegressionEvaluation
from .roc import ROC, ROCBinary, ROCMultiClass, RocCurve, PrecisionRecallCurve
from .binary import EvaluationBinary
from .calibration import EvaluationCalibration

__all__ = ["Evaluation", "ConfusionMatrix", "RegressionEvaluation", "ROC",
           "ROCBinary", "ROCMultiClass", "RocCurve", "PrecisionRecallCurve",
           "EvaluationBinary", "EvaluationCalibration"]
