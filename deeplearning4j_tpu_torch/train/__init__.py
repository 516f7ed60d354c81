"""Training utilities of the port: the in-place updaters, learning-rate
schedules, weight constraints and gradient-anomaly detection."""

from .anomaly import GradientAnomaly, GradientAnomalyDetector
from .constraints import (MaxNormConstraint, MinMaxNormConstraint,
                          NonNegativeConstraint, UnitNormConstraint)
from .schedules import (CycleSchedule, ExponentialSchedule, FixedSchedule,
                        InverseSchedule, MapSchedule, PolySchedule,
                        Schedule, ScheduleType, SigmoidSchedule,
                        StepSchedule, WarmupCosineSchedule)
from .updaters import (AMSGrad, AdaDelta, AdaGrad, AdaMax, Adam, AdamW,
                       GradientNormalization, Lamb, Lion, Momentum, Nadam,
                       Nesterovs, NoOp, RmsProp, Sgd, Updater,
                       build_optimizer)

__all__ = ["AMSGrad", "AdaDelta", "AdaGrad", "AdaMax", "Adam", "AdamW",
           "CycleSchedule", "ExponentialSchedule", "FixedSchedule",
           "GradientAnomaly", "GradientAnomalyDetector",
           "GradientNormalization", "InverseSchedule", "Lamb", "Lion",
           "MapSchedule", "MaxNormConstraint", "MinMaxNormConstraint",
           "Momentum", "Nadam", "Nesterovs", "NoOp", "NonNegativeConstraint",
           "PolySchedule", "RmsProp", "Schedule", "ScheduleType", "Sgd",
           "SigmoidSchedule", "StepSchedule", "UnitNormConstraint",
           "Updater", "WarmupCosineSchedule", "build_optimizer"]
