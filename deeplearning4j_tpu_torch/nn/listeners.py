"""Training listeners — port of ``deeplearning4j_tpu/nn/listeners.py``
(``org.deeplearning4j.optimize.listeners``).

Listeners run on the host between steps. A listener with
``deferred_score_ok`` (the pure logging ones) lets ``fit`` report the
(step, score) pair one step late: the loss is read through pinned memory
after the next step is queued, so the read never stalls the card (see
``nn/_fit_loop.py``). A listener that reads the model at the reported
step (checkpointing, evaluation, the NaN watchdog) keeps the synchronous
read.

``MetricsListener`` feeds the observability plane (``obs``): the
train-step histogram, loss, examples/s, device memory and the memory
census, and its own cost.

Not ported yet (raise, naming what is missing): ``NumericsListener``,
``ProfilingListener`` and ``StatsListener``, which need the parts of the
observability plane the port does not have (the numerics sentinel and
stat engine, the per-layer profiler, the stats storage and UI).
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


class MetricsListener(TrainingListener):
    """Observability-plane listener: feeds the process-wide ``obs``
    registry (step-time histogram, loss, examples/s, device memory, the
    memory census) so that a running fit is scrapeable.

    Budgeted: the body is increments and one histogram observe on the
    host between steps (~µs); its own cumulative cost is exported as
    ``dl4j_obs_overhead_seconds_total``. Device-memory stats and the
    census are polled every ``memory_frequency`` iterations only (the
    one call that can cost more than µs; None on the CPU, where the
    census still attributes)."""

    deferred_score_ok = True  # pure metrics: fit() may report the
    # (step, score) pair one dispatch late to keep the device busy

    def __init__(self, registry=None, memory_frequency: int = 50):
        from ..obs import get_registry
        reg = registry or get_registry()
        self.registry = reg
        self.memory_frequency = max(1, memory_frequency)
        self._step_seconds = reg.histogram(
            "dl4j_train_step_seconds",
            "Wall time between training iterations (host-observed)")
        self._iterations = reg.counter(
            "dl4j_train_iterations_total", "Optimizer steps taken")
        self._examples = reg.counter(
            "dl4j_train_examples_total", "Training examples consumed")
        self._epochs = reg.counter(
            "dl4j_train_epochs_total", "Epochs completed")
        self._loss = reg.gauge("dl4j_train_loss", "Last reported score")
        self._eps = reg.gauge(
            "dl4j_train_examples_per_second",
            "Examples/s over the last inter-iteration interval")
        self._mem = reg.gauge(
            "dl4j_device_memory_bytes",
            "jax device memory stats (polled every memory_frequency "
            "iterations; absent on backends without memory_stats)",
            labelnames=("stat",))
        self._overhead = reg.counter(
            "dl4j_obs_overhead_seconds_total",
            "Cumulative host time spent inside MetricsListener "
            "(budget: <2% of step time, tests/test_obs.py)")
        self._last_t: Optional[float] = None

    @property
    def overhead_seconds(self) -> float:
        return self._overhead.value()

    def _poll_memory(self, model=None):
        """The allocator's stats into ``dl4j_device_memory_bytes{stat=}``
        where there is a card, and the component census — params,
        optimizer state, running states — into
        ``dl4j_mem_component_bytes{component, replica}`` on every
        device."""
        try:
            from ..obs import memory as obs_memory
        except Exception:  # noqa: BLE001 — memory stats are decoration
            return
        stats = obs_memory.device_memory_stats()
        if stats:
            for key in ("bytes_in_use", "peak_bytes_in_use",
                        "bytes_limit"):
                if key in stats:
                    self._mem.set(float(stats[key]), stat=key)
        if model is None:
            return
        components = {}
        if getattr(model, "params", None) is not None:
            components["params"] = model.params
        if getattr(model, "_opt_state", None) is not None:
            components["optimizer"] = model._opt_state
        if getattr(model, "states", None) is not None:
            components["states"] = model.states
        if components:
            try:
                # per_replica: the replica label means "bytes this device
                # holds" (one card: the whole tree)
                obs_memory.emit_census(components, source="train",
                                       registry=self.registry,
                                       per_replica=True)
            except Exception:  # noqa: BLE001 — census is decoration
                pass

    def iteration_done(self, model, iteration, epoch, score):
        t0 = time.perf_counter()
        batch = getattr(model, "_last_batch_size", None)
        if self._last_t is not None:
            dt = t0 - self._last_t
            self._step_seconds.observe(dt)
            if batch and dt > 0:
                self._eps.set(batch / dt)
        self._last_t = t0
        self._iterations.inc()
        if batch:
            self._examples.inc(batch)
        self._loss.set(float(score))
        if iteration % self.memory_frequency == 0:
            self._poll_memory(model)
        self._overhead.inc(time.perf_counter() - t0)

    def on_epoch_end(self, model):
        self._epochs.inc()
        self._last_t = None  # epoch boundary work is not a step interval


class _NeedsObs(TrainingListener):
    needs = ""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} (deeplearning4j_tpu/nn/listeners.py) "
            f"needs a part of the observability plane that is not ported "
            f"yet ({self.needs})")


class NumericsListener(_NeedsObs):
    needs = "obs.numerics: the numerics sentinel and stat engine"


class ProfilingListener(_NeedsObs):
    needs = "obs.profiler: per-layer time attribution"


class StatsListener(_NeedsObs):
    needs = "the stats storage and UI"
