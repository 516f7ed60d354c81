"""Learning-rate schedules — port of ``deeplearning4j_tpu/train/schedules.py``
(``org.nd4j.linalg.schedule.ISchedule``).

Each schedule is a dataclass with two forms of one function:

- ``value_at(iteration, epoch)`` — the DL4J contract, a host float;
- ``at(step, iters_per_epoch)`` — the step-side form: ``step`` is an
  int32 0-d tensor on the device (an updater's count) and the result an
  f32 0-d tensor there, computed with torch ops only, so that a captured
  train step recomputes it at every replay (a host float computed at
  capture would replay as one step's value forever).

``_value(t)`` is written once for both: ``t`` is a Python int (the host
form) or an int32 tensor (the step form). Where the reference calls a
``jnp`` function it computes in f32, here :func:`_f32` does the same; where
it keeps Python arithmetic (``Exponential``, ``Inverse``), so does the port.
EPOCH-typed schedules divide the step by ``iters_per_epoch`` on the step
side (the reference's ``to_optax``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch


class ScheduleType:
    ITERATION = "iteration"
    EPOCH = "epoch"


def _f32(x):
    """The reference's ``jnp.asarray(x, float32)``: a tensor stays where it
    is (cast to f32), a Python number becomes a host f32 tensor."""
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.tensor(x, dtype=torch.float32)


def _full(x, like):
    """An f32 constant beside ``like`` (a fill, never a host copy: it is
    safe inside a captured step)."""
    if isinstance(like, torch.Tensor):
        return torch.full((), x, dtype=torch.float32, device=like.device)
    return torch.tensor(x, dtype=torch.float32)


def _host(v) -> float:
    return float(v.item()) if isinstance(v, torch.Tensor) else float(v)


@dataclass
class Schedule:
    schedule_type: str = ScheduleType.ITERATION

    def value_at(self, iteration, epoch) -> float:
        t = iteration if self.schedule_type == ScheduleType.ITERATION \
            else epoch
        return _host(self._value(t))

    def _value(self, t):  # pragma: no cover — abstract
        raise NotImplementedError

    def at(self, step, iters_per_epoch: int = 1):
        """The lr at updater step ``step`` (int32 device tensor) as an f32
        0-d tensor on its device."""
        if self.schedule_type == ScheduleType.EPOCH:
            step = torch.div(step, iters_per_epoch, rounding_mode="floor")
        v = self._value(step)
        if not isinstance(v, torch.Tensor):
            return _full(v, step)
        return v.float()


@dataclass
class FixedSchedule(Schedule):
    value: float = 1e-3

    def _value(self, t):
        return self.value


@dataclass
class StepSchedule(Schedule):
    """lr * decay^floor(t / step)."""

    initial_value: float = 1e-3
    decay_rate: float = 0.1
    step: float = 1000.0

    def _value(self, t):
        return self.initial_value * self.decay_rate ** torch.floor(
            _f32(t / self.step))


@dataclass
class ExponentialSchedule(Schedule):
    initial_value: float = 1e-3
    gamma: float = 0.99

    def _value(self, t):
        return self.initial_value * self.gamma ** t


@dataclass
class InverseSchedule(Schedule):
    """lr / (1 + gamma*t)^power."""

    initial_value: float = 1e-3
    gamma: float = 0.001
    power: float = 1.0

    def _value(self, t):
        return self.initial_value / (1.0 + self.gamma * t) ** self.power


@dataclass
class PolySchedule(Schedule):
    """lr * (1 - t/maxIter)^power."""

    initial_value: float = 1e-3
    power: float = 1.0
    max_iter: int = 10000

    def _value(self, t):
        frac = torch.clamp(_f32(t / self.max_iter), 0.0, 1.0)
        return self.initial_value * (1.0 - frac) ** self.power


@dataclass
class SigmoidSchedule(Schedule):
    initial_value: float = 1e-3
    gamma: float = 0.01
    step_size: int = 1000

    def _value(self, t):
        return self.initial_value / (
            1.0 + torch.exp(_f32(self.gamma * (t - self.step_size))))


@dataclass
class MapSchedule(Schedule):
    """Piecewise-constant: {t: lr}; value holds from each key onward."""

    values: dict = field(default_factory=dict)

    def _value(self, t):
        keys = sorted(self.values)
        out = _full(self.values[keys[0]], t)
        for k in keys:
            out = torch.where(_f32(t) >= k, _full(self.values[k], t), out)
        return out


@dataclass
class CycleSchedule(Schedule):
    """1cycle: warmup to max_lr, anneal down, final decay (DL4J
    CycleSchedule)."""

    initial_value: float = 1e-4
    max_value: float = 1e-2
    cycle_length: int = 1000
    annealing_start_fraction: float = 0.9
    annealing_decay: float = 0.1

    def _value(self, t):
        up = self.cycle_length * (1 - self.annealing_start_fraction) / 2
        ann_start = self.cycle_length * self.annealing_start_fraction
        t = _f32(t)
        lr_up = self.initial_value + (self.max_value - self.initial_value) \
            * (t / max(up, 1))
        lr_down = self.max_value - (self.max_value - self.initial_value) \
            * torch.clamp((t - up) / max(ann_start - up, 1), 0, 1)
        lr_ann = self.initial_value * self.annealing_decay ** torch.clamp(
            (t - ann_start) / max(self.cycle_length - ann_start, 1), 0, 1)
        return torch.where(t < up, lr_up,
                           torch.where(t < ann_start, lr_down, lr_ann))


@dataclass
class WarmupCosineSchedule(Schedule):
    """Linear warmup → cosine decay (not in DL4J)."""

    peak_value: float = 1e-3
    warmup_steps: int = 1000
    total_steps: int = 10000
    end_value: float = 0.0

    def _value(self, t):
        t = _f32(t)
        warm = self.peak_value * t / max(self.warmup_steps, 1)
        frac = torch.clamp((t - self.warmup_steps) / max(
            self.total_steps - self.warmup_steps, 1), 0, 1)
        cos = self.end_value + 0.5 * (self.peak_value - self.end_value) * (
            1 + torch.cos(math.pi * frac))
        return torch.where(t < self.warmup_steps, warm, cos)


def resolve(lr_or_schedule, iters_per_epoch: int = 1):
    """float → the float; Schedule → ``step -> lr`` (the step-side form)."""
    if isinstance(lr_or_schedule, Schedule):
        return lambda step: lr_or_schedule.at(step, iters_per_epoch)
    return lr_or_schedule
