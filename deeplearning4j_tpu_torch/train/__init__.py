"""Training utilities of the port: the functional updaters."""

from .updaters import (Adam, AdamW, GradientNormalization, Momentum,
                       Nesterovs, NoOp, Sgd, Updater, build_optimizer)

__all__ = ["Adam", "AdamW", "GradientNormalization", "Momentum",
           "Nesterovs", "NoOp", "Sgd", "Updater", "build_optimizer"]
