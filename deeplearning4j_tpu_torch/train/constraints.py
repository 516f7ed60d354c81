"""Parameter constraints — port of ``deeplearning4j_tpu/train/constraints.py``
(``org.deeplearning4j.nn.conf.constraint.{MaxNormConstraint,
MinMaxNormConstraint, NonNegativeConstraint, UnitNormConstraint}``).

A constraint is ``apply(w) -> w`` on a tensor. The nets apply them in
place, under ``no_grad``, right after the updater's ``apply_updates``
inside the train step (:func:`apply_constraints_`), so a captured step
clamps at every replay; frozen layers are skipped.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Union

import torch

# param keys treated as biases / norm-statistics, excluded by constrain-weights
NON_WEIGHT_KEYS = ("b", "bias", "beta", "gamma", "mean", "var", "centers")


def _norm(w, dims):
    return torch.sqrt(torch.sum(torch.square(w), dim=dims, keepdim=True)
                      + 1e-12)


@dataclass
class BaseConstraint:
    """dims: axes reduced when computing the per-unit norm (reference
    BaseConstraint.dimensions; default 0 = fan-in axis of a (nIn,nOut) W)."""

    dims: Union[int, Sequence[int]] = 0

    def apply(self, w):  # pragma: no cover — abstract
        raise NotImplementedError


@dataclass
class MaxNormConstraint(BaseConstraint):
    max_norm: float = 1.0

    def __init__(self, max_norm=1.0, dims=0):
        self.max_norm = float(max_norm)
        self.dims = dims

    def apply(self, w):
        n = _norm(w, self.dims)
        return w * torch.clamp(n, max=self.max_norm) / n


@dataclass
class MinMaxNormConstraint(BaseConstraint):
    min_norm: float = 0.0
    max_norm: float = 1.0
    rate: float = 1.0

    def __init__(self, min_norm=0.0, max_norm=1.0, rate=1.0, dims=0):
        self.min_norm = float(min_norm)
        self.max_norm = float(max_norm)
        self.rate = float(rate)
        self.dims = dims

    def apply(self, w):
        n = _norm(w, self.dims)
        clipped = torch.clamp(n, self.min_norm, self.max_norm)
        target = self.rate * clipped + (1.0 - self.rate) * n
        return w * target / n


@dataclass
class NonNegativeConstraint(BaseConstraint):
    def apply(self, w):
        return torch.clamp(w, min=0.0)


@dataclass
class UnitNormConstraint(BaseConstraint):
    def apply(self, w):
        return w / _norm(w, self.dims)


def apply_constraints(layer_params: dict, constraints, *, weights=True,
                      biases=False):
    """Apply each constraint to the matching params of one layer's dict;
    returns a new dict (the reference's form)."""
    if not constraints:
        return layer_params
    out = {}
    for k, w in layer_params.items():
        if isinstance(w, dict):
            out[k] = apply_constraints(w, constraints, weights=weights,
                                       biases=biases)
            continue
        is_bias = k in NON_WEIGHT_KEYS
        if (is_bias and biases) or (not is_bias and weights):
            for c in constraints:
                w = c.apply(w)
        out[k] = w
    return out


def apply_constraints_(layer_params: dict, constraints, *, weights=True,
                       biases=False):
    """:func:`apply_constraints` written back into ``layer_params``'
    tensors (call under ``no_grad``)."""
    if not constraints:
        return
    new = apply_constraints(layer_params, constraints, weights=weights,
                            biases=biases)

    def copy(dst, src):
        for k, v in dst.items():
            if isinstance(v, dict):
                copy(v, src[k])
            elif src[k] is not v:
                v.copy_(src[k])
    copy(layer_params, new)
