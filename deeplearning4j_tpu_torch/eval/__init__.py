"""Evaluation metrics of the port (``deeplearning4j_tpu.eval``): the
accumulators live on the device of the predictions they are handed and
are read to the host once, by the first metric getter."""

from .calibration import EvaluationCalibration
from .classification import ConfusionMatrix, Evaluation, EvaluationBinary
from .regression import RegressionEvaluation
from .roc import ROC, ROCBinary, ROCMultiClass

__all__ = ["ConfusionMatrix", "Evaluation", "EvaluationBinary",
           "EvaluationCalibration", "ROC", "ROCBinary", "ROCMultiClass",
           "RegressionEvaluation"]
