"""Training listeners — port of ``deeplearning4j_tpu/nn/listeners.py``
(``org.deeplearning4j.optimize.listeners``).

Listeners run on the host between steps. A listener with
``deferred_score_ok`` (the pure logging ones) lets ``fit`` report the
(step, score) pair one step late: the loss is read through pinned memory
after the next step is queued, so the read never stalls the card (see
``nn/_fit_loop.py``). A listener that reads the model at the reported
step (checkpointing, evaluation, the NaN watchdog) keeps the synchronous
read.

Not ported yet (raise, naming what is missing): ``MetricsListener``,
``NumericsListener``, ``ProfilingListener`` and ``StatsListener``, which
need the observability plane (metrics registry, numerics sentinel,
profiler, stats storage).
"""

from __future__ import annotations

import math
import os
import time
from pathlib import Path
from typing import Callable, List, Optional


class TrainingListener:
    def iteration_done(self, model, iteration: int, epoch: int, score: float):
        pass

    def on_epoch_end(self, model):
        pass


class ScoreIterationListener(TrainingListener):
    """Print score every N iterations (reference ScoreIterationListener)."""
    deferred_score_ok = True

    def __init__(self, print_iterations: int = 10, log_fn: Callable = print):
        self.print_iterations = max(1, print_iterations)
        self.log_fn = log_fn

    def iteration_done(self, model, iteration, epoch, score):
        if iteration % self.print_iterations == 0:
            self.log_fn(f"Score at iteration {iteration} is {score}")


class PerformanceListener(TrainingListener):
    """Throughput reporting: iterations/sec + examples/sec."""
    deferred_score_ok = True

    def __init__(self, frequency: int = 10, report_batch: bool = True,
                 log_fn: Callable = print):
        self.frequency = max(1, frequency)
        self.report_batch = report_batch
        self.log_fn = log_fn
        self._last_time = None
        self._last_iter = 0

    def iteration_done(self, model, iteration, epoch, score):
        now = time.perf_counter()
        if self._last_time is None:
            self._last_time, self._last_iter = now, iteration
            return
        if iteration - self._last_iter >= self.frequency:
            dt = now - self._last_time
            its = (iteration - self._last_iter) / dt
            self.log_fn(f"iteration {iteration}; iterations/sec: {its:.2f}; "
                        f"score: {score:.5f}")
            self._last_time, self._last_iter = now, iteration


class TimeIterationListener(TrainingListener):
    """ETA logging based on expected total iteration count."""
    deferred_score_ok = True

    def __init__(self, total_iterations: int, frequency: int = 100,
                 log_fn: Callable = print):
        self.total = total_iterations
        self.frequency = max(1, frequency)
        self.log_fn = log_fn
        self._start = time.perf_counter()

    def iteration_done(self, model, iteration, epoch, score):
        if iteration % self.frequency == 0 and iteration > 0:
            elapsed = time.perf_counter() - self._start
            rate = iteration / elapsed
            remaining = (self.total - iteration) / rate if rate > 0 \
                else float("inf")
            self.log_fn(f"iteration {iteration}/{self.total}; "
                        f"ETA {remaining:.0f}s")


class CollectScoresListener(TrainingListener):
    deferred_score_ok = True

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.iterations: List[int] = []
        self.scores: List[float] = []

    def iteration_done(self, model, iteration, epoch, score):
        if iteration % self.frequency == 0:
            self.iterations.append(iteration)
            self.scores.append(score)


class EvaluativeListener(TrainingListener):
    """Periodically evaluate on a held-out iterator (reference
    EvaluativeListener)."""

    def __init__(self, iterator, frequency: int = 100,
                 log_fn: Callable = print):
        self.iterator = iterator
        self.frequency = max(1, frequency)
        self.log_fn = log_fn
        self.last_evaluation = None

    def iteration_done(self, model, iteration, epoch, score):
        if iteration % self.frequency == 0:
            self.last_evaluation = model.evaluate(self.iterator)
            self.log_fn(f"Evaluation at iteration {iteration}: "
                        f"accuracy={self.last_evaluation.accuracy():.4f}")


class CheckpointListener(TrainingListener):
    """Periodic checkpoints with retention (reference CheckpointListener):
    save_every_n_iterations / save_every_n_epochs; keep_last."""

    def __init__(self, model_dir, save_every_n_iterations: Optional[int] = None,
                 save_every_n_epochs: Optional[int] = None, keep_last: int = 3):
        self.dir = Path(model_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.every_iter = save_every_n_iterations
        self.every_epoch = save_every_n_epochs
        self.keep_last = keep_last
        self._saved: List[Path] = []

    def _save(self, model, tag: str):
        path = self.dir / f"checkpoint_{tag}.zip"
        model.save(path, save_updater=True)
        self._saved.append(path)
        while len(self._saved) > self.keep_last:
            old = self._saved.pop(0)
            try:
                os.remove(old)
            except OSError:
                pass

    def iteration_done(self, model, iteration, epoch, score):
        if self.every_iter and iteration % self.every_iter == 0:
            self._save(model, f"iter_{iteration}")

    def on_epoch_end(self, model):
        if self.every_epoch and model.epoch_count % self.every_epoch == 0:
            self._save(model, f"epoch_{model.epoch_count}")


class NanScoreWatchdog(TrainingListener):
    """Failure detection: abort (or callback) on NaN/Inf score — the
    reference's FailureTestingListener /
    InvalidScoreIterationTerminationCondition."""

    def __init__(self, on_failure: Optional[Callable] = None):
        self.on_failure = on_failure
        self.triggered = False

    def iteration_done(self, model, iteration, epoch, score):
        if math.isnan(score) or math.isinf(score):
            self.triggered = True
            if self.on_failure is not None:
                self.on_failure(model, iteration, score)
            else:
                raise FloatingPointError(
                    f"NaN/Inf score at iteration {iteration}: {score}")


class _NeedsObs(TrainingListener):
    needs = ""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} (deeplearning4j_tpu/nn/listeners.py) "
            f"needs the observability plane ({self.needs}), which is not "
            "ported yet")


class MetricsListener(_NeedsObs):
    needs = "the obs metrics registry and memory census"


class NumericsListener(_NeedsObs):
    needs = "the obs numerics sentinel and stat engine"


class ProfilingListener(_NeedsObs):
    needs = "the obs profiler"


class StatsListener(_NeedsObs):
    needs = "the stats storage and UI"
