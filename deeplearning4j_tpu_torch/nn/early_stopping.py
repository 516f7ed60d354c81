"""Early stopping — port of ``deeplearning4j_tpu/nn/early_stopping.py``
(``org.deeplearning4j.earlystopping``).

``EarlyStoppingConfiguration`` + ``EarlyStoppingTrainer`` with epoch
termination conditions (MaxEpochs, ScoreImprovementEpochs patience,
MaxTime, MaxScore, InvalidScore) and score calculators (the loss, or
1 − accuracy, on a held-out iterator). Each epoch is one ``fit`` of the
net (the compiled, replayed step on the card); at a new best score the
params and states are snapshotted on the device, and the result's
``best_model`` is a clone of the net holding that snapshot, as the
reference restores it.

``EarlyStoppingParallelTrainer`` runs the same loop around a parallel
trainer (``parallel.ParallelWrapper`` or
``parallel.ParameterAveragingTrainer``): each epoch is one
``trainer.fit``, and the scores and the snapshots are taken on the
trainer's net, whose params every rank holds whole.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, List

from ..train.updaters import tree_map


# --- termination conditions -------------------------------------------------

class MaxEpochsTerminationCondition:
    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch, score, history) -> bool:
        return epoch + 1 >= self.max_epochs


class ScoreImprovementEpochTerminationCondition:
    def __init__(self, max_epochs_without_improvement: int,
                 min_improvement: float = 0.0):
        self.patience = max_epochs_without_improvement
        self.min_improvement = min_improvement

    def terminate(self, epoch, score, history) -> bool:
        if len(history) <= self.patience:
            return False
        best_older = min(history[:-self.patience])
        best_recent = min(history[-self.patience:])
        return best_recent > best_older - self.min_improvement


class MaxTimeTerminationCondition:
    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds
        self._start = time.monotonic()

    def terminate(self, epoch, score, history) -> bool:
        return (time.monotonic() - self._start) > self.max_seconds


class MaxScoreTerminationCondition:
    """Terminate (failure) when score exceeds a bound — divergence guard."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def terminate(self, epoch, score, history) -> bool:
        return score > self.max_score


class InvalidScoreTerminationCondition:
    def terminate(self, epoch, score, history) -> bool:
        return math.isnan(score) or math.isinf(score)


# --- score calculators ------------------------------------------------------

class DataSetLossCalculator:
    """Average loss over an iterator (reference DataSetLossCalculator)."""

    def __init__(self, iterator):
        self.iterator = iterator

    def calculate_score(self, model) -> float:
        total, n = 0.0, 0
        for ds in self.iterator:
            total += model.score(ds) * ds.num_examples()
            n += ds.num_examples()
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        return total / max(n, 1)


class ClassificationScoreCalculator:
    """1 - accuracy so that lower is better (consistent with loss)."""

    def __init__(self, iterator):
        self.iterator = iterator

    def calculate_score(self, model) -> float:
        return 1.0 - model.evaluate(self.iterator).accuracy()


@dataclass
class EarlyStoppingConfiguration:
    epoch_termination_conditions: List[Any] = field(default_factory=list)
    iteration_termination_conditions: List[Any] = field(default_factory=list)
    score_calculator: Any = None
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False


@dataclass
class EarlyStoppingResult:
    termination_reason: str
    termination_details: str
    best_model_epoch: int
    best_model_score: float
    total_epochs: int
    best_model: Any
    score_vs_epoch: dict = field(default_factory=dict)


def _snapshot(tree):
    """Copies on the device of a params or states tree."""
    return tree_map(lambda t: t.detach().clone(), tree)


class EarlyStoppingTrainer:
    def __init__(self, config: EarlyStoppingConfiguration, model,
                 train_iterator):
        self.config = config
        self.model = model
        self.iterator = train_iterator

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        best_score = math.inf
        best_epoch = -1
        best_params = None
        best_states = None
        history: List[float] = []
        scores = {}
        epoch = 0
        reason, details = "MaxEpochs", ""
        while True:
            self._fit_epoch()
            if (epoch + 1) % cfg.evaluate_every_n_epochs == 0:
                score = cfg.score_calculator.calculate_score(self.model) \
                    if cfg.score_calculator else self._train_score()
                history.append(score)
                scores[epoch] = score
                if score < best_score:
                    best_score, best_epoch = score, epoch
                    # copies: the next epoch's steps update the net's
                    # tensors in place
                    best_params = _snapshot(self.model.params)
                    best_states = _snapshot(self.model.states)
                stop = False
                for cond in cfg.epoch_termination_conditions:
                    if cond.terminate(epoch, score, history):
                        reason = type(cond).__name__
                        details = f"epoch={epoch} score={score}"
                        stop = True
                        break
                if stop:
                    break
            epoch += 1
        best_model = self.model
        if best_params is not None and not cfg.save_last_model:
            best_model = self.model.clone() if hasattr(self.model, "clone") \
                else self.model
            best_model.params = tree_map(
                lambda t: t.requires_grad_(t.is_floating_point()),
                best_params)
            best_model.states = best_states
        return EarlyStoppingResult(reason, details, best_epoch, best_score,
                                   epoch + 1, best_model, scores)

    def _fit_epoch(self):
        self.model.fit(self.iterator, epochs=1)

    def _train_score(self):
        ds = next(iter(self.iterator))
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        return self.model.score(ds)


class EarlyStoppingParallelTrainer(EarlyStoppingTrainer):
    """Early stopping around a multi-device trainer (reference:
    ``org.deeplearning4j.earlystopping.trainer.EarlyStoppingParallelTrainer``
    wrapping ParallelWrapper). Accepts any trainer with
    ``fit(iterator, epochs=1)`` and a ``.net`` (ParallelWrapper,
    ParameterAveragingTrainer); scoring and the conditions run on the
    wrapped net, whose params the trainer keeps in sync."""

    def __init__(self, config: EarlyStoppingConfiguration, trainer,
                 train_iterator):
        if not hasattr(trainer, "net") or not hasattr(trainer, "fit"):
            raise TypeError("trainer must expose .net and .fit (e.g. "
                            "ParallelWrapper / ParameterAveragingTrainer)")
        super().__init__(config, trainer.net, train_iterator)
        self.trainer = trainer

    def _fit_epoch(self):
        self.trainer.fit(self.iterator, epochs=1)
