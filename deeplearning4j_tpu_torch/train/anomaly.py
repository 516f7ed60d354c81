"""Gradient anomaly detection — port of ``deeplearning4j_tpu/train/anomaly.py``.

Per-layer gradient statistics are computed inside the train step, and the
step gates its own update on their finiteness: a poisoned batch is a
no-op (params, updater state and running states as they were), not a
lost run. The port's updaters work in place, so the gate selects, with
``torch.where`` on the device, between the values after the update and a
copy saved before it (:func:`save_for_gate` / :func:`gate_`): no host
read, so a captured step gates at every replay. The copy costs one set of
params and states, and is made only while a detector is attached.

The statistics leave the step as one (G, 4) f32 tensor (:data:`FIELDS`
per group, groups in sorted order), staged to pinned host memory, and the
host checks them one step late (:class:`DelayedAnomalyCheck`), so the fit
loop never waits for the step it just queued.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List

import torch

from .._device import HostRead
from ..nn._compiled import tensors

FIELDS = ("l2", "max_abs", "nonfinite", "size")


def grad_stats(grads):
    """Per top-level group (a layer or node) of ``grads``: its L2 norm,
    largest |g|, count of non-finite elements and element count, as a
    (G, 4) f32 tensor (rows in sorted group order; groups without leaves
    are left out). :func:`stats_dict` names them."""
    rows = []
    for group in sorted(grads):
        leaves = [t.float() for t in tensors(grads[group])]
        if not leaves:
            continue
        sq = torch.stack([torch.sum(torch.square(t)) for t in leaves]).sum()
        mx = torch.stack([torch.max(torch.abs(t)) for t in leaves]).max()
        nf = torch.stack([torch.sum(~torch.isfinite(t))
                          for t in leaves]).sum().float()
        size = torch.full((), float(sum(t.numel() for t in leaves)),
                          device=sq.device)
        rows.append(torch.stack([torch.sqrt(sq), mx, nf, size]))
    return torch.stack(rows)


def stat_groups(grads):
    """The group names of :func:`grad_stats`'s rows."""
    return [g for g in sorted(grads) if tensors(grads[g])]


def stats_dict(groups, rows):
    """Host rows of :func:`grad_stats` as the reference's
    ``{group: {"l2", "max_abs", "nonfinite", "size"}}``."""
    return {g: {"l2": float(r[0]), "max_abs": float(r[1]),
                "nonfinite": int(r[2]), "size": float(r[3])}
            for g, r in zip(groups, rows)}


def save_for_gate(trees):
    """Copies of every tensor of ``trees``, taken before the update."""
    return [t.detach().clone() for t in tensors(trees)]


def gate_(stats, trees, saved):
    """Where any gradient element was non-finite, put every tensor of
    ``trees`` back to its ``saved`` value, in place, on the device."""
    ok = stats[:, 2].sum() == 0
    with torch.no_grad():
        for t, old in zip(tensors(trees), saved):
            t.copy_(torch.where(ok, t, old))


class DelayedAnomalyCheck:
    """Host-side: checks each step's stats ONE step late so the fit loop
    never blocks on the step it just queued. Call push() after each step
    and flush() when the loop ends."""

    def __init__(self, detector: "GradientAnomalyDetector", groups):
        self.detector = detector
        self.groups = list(groups)
        self._pending = None

    def push(self, stats, iteration: int):
        staged = (HostRead(stats), iteration)
        self.flush()
        self._pending = staged

    def flush(self):
        if self._pending is not None:
            read, iteration = self._pending
            self._pending = None
            self.detector.check(stats_dict(self.groups, read.get()),
                                iteration)


@dataclass
class GradientAnomaly:
    kind: str        # "nonfinite" | "explosion" | "vanishing"
    layer: str
    iteration: int
    detail: str

    def __str__(self):
        return (f"[{self.kind}] layer '{self.layer}' at iteration "
                f"{self.iteration}: {self.detail}")


@dataclass
class GradientAnomalyDetector:
    """Host-side thresholds over the in-step stats.

    - nonfinite: any NaN/Inf gradient element → always an anomaly.
    - explosion: per-layer grad L2 exceeding `explosion_abs`, or exceeding
      `explosion_ratio` × its own EMA (warmup-gated so init noise is ignored).
    - vanishing: per-layer max|g| below `vanishing_abs` for
      `vanishing_patience` consecutive checks (a dead/saturated layer).

    `strict=True` raises FloatingPointError on nonfinite/explosion;
    otherwise anomalies are recorded in `.anomalies` (listener-style).
    `gate_updates=False` observes without gating: a non-finite step is
    applied (the numerics sentinel's "warn" policy).
    """

    explosion_abs: float = 1e4
    explosion_ratio: float = 100.0
    vanishing_abs: float = 1e-10
    vanishing_patience: int = 10
    ema_decay: float = 0.9
    warmup_iters: int = 5
    strict: bool = True
    gate_updates: bool = True
    anomalies: List[GradientAnomaly] = field(default_factory=list)
    _ema: Dict[str, float] = field(default_factory=dict)
    _seen: Dict[str, int] = field(default_factory=dict)
    _dead_streak: Dict[str, int] = field(default_factory=dict)

    def check(self, stats: Dict[str, Dict],
              iteration: int) -> List[GradientAnomaly]:
        """stats: host dict of :func:`stats_dict`. Returns new anomalies."""
        new: List[GradientAnomaly] = []
        for layer, s in stats.items():
            l2 = float(s["l2"])
            mx = float(s["max_abs"])
            nf = int(s["nonfinite"])
            if nf > 0 or math.isnan(l2) or math.isinf(l2):
                new.append(GradientAnomaly(
                    "nonfinite", layer, iteration,
                    f"{nf} non-finite gradient elements (l2={l2})"))
                continue
            seen = self._seen.get(layer, 0)
            ema = self._ema.get(layer)
            exploded = l2 > self.explosion_abs or (
                ema is not None and seen >= self.warmup_iters
                and ema > 0 and l2 > self.explosion_ratio * ema)
            if exploded:
                new.append(GradientAnomaly(
                    "explosion", layer, iteration,
                    f"grad l2={l2:.3e} (ema="
                    f"{ema if ema is None else f'{ema:.3e}'}, "
                    f"abs threshold={self.explosion_abs:.0e})"))
            self._ema[layer] = l2 if ema is None else (
                self.ema_decay * ema + (1 - self.ema_decay) * l2)
            self._seen[layer] = seen + 1
            if mx < self.vanishing_abs:
                streak = self._dead_streak.get(layer, 0) + 1
                self._dead_streak[layer] = streak
                if streak == self.vanishing_patience:
                    new.append(GradientAnomaly(
                        "vanishing", layer, iteration,
                        f"max|g|={mx:.1e} for {streak} consecutive checks"))
            else:
                self._dead_streak[layer] = 0
        self.anomalies.extend(new)
        if self.strict:
            fatal = [a for a in new if a.kind in ("nonfinite", "explosion")]
            if fatal:
                raise FloatingPointError(
                    "gradient anomaly detected:\n  "
                    + "\n  ".join(map(str, fatal)))
        return new
