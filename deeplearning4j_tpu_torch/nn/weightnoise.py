"""Weight noise — port of ``deeplearning4j_tpu/nn/weightnoise.py``
(``org.deeplearning4j.nn.conf.weightnoise.{IWeightNoise, WeightNoise,
DropConnect}`` and the distributions they sample).

Noise is a function ``params -> noisy params`` applied where the net
calls a layer in a train step, split in two so that the tests can feed
the reference's own draws to the second half:

- ``draw(params, gen)`` samples every noise tensor from ``gen`` (the
  net's ``torch.Generator``, on the net's device: a captured step
  registers it, so each replay draws anew);
- ``apply(params, noise)`` is plain arithmetic on the params and those
  draws; gradients flow to the clean params through it.

Leaves with ndim >= 2 are weights (W, RW, conv kernels); 1-d/0-d leaves
are bias-like and only touched with ``apply_to_bias``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch


# ---------------------------------------------------------------- samplers
@dataclass
class NormalDistribution:
    """org.nd4j...impl.NormalDistribution(mean, std)."""

    mean: float = 0.0
    std: float = 1.0

    def sample(self, gen, shape, dtype, device):
        return (self.mean + self.std * torch.randn(
            shape, generator=gen, device=device)).to(dtype)


@dataclass
class UniformDistribution:
    """org.nd4j...impl.UniformDistribution(lower, upper)."""

    lower: float = 0.0
    upper: float = 1.0

    def sample(self, gen, shape, dtype, device):
        u = torch.rand(shape, generator=gen, device=device)
        return (self.lower + (self.upper - self.lower) * u).to(dtype)


@dataclass
class BernoulliDistribution:
    """org.nd4j...impl.BernoulliDistribution(p) — samples {0, 1}."""

    p: float = 0.5

    def sample(self, gen, shape, dtype, device):
        return (torch.rand(shape, generator=gen, device=device)
                < self.p).to(dtype)


# ------------------------------------------------------------ noise configs
def _map(fn, params, noise):
    if isinstance(params, dict):
        return {k: _map(fn, params[k], noise[k]) for k in params}
    return params if noise is None else fn(params, noise)


class IWeightNoise:
    """Contract: ``draw(params, gen) -> noise`` (a tree like ``params``,
    None where a leaf is left as it is) and ``apply(params, noise) ->
    params``."""

    apply_to_bias = False

    def _draw_one(self, w, gen):  # pragma: no cover — abstract
        raise NotImplementedError

    def draw(self, params, gen):
        if isinstance(params, dict):
            return {k: self.draw(params[k], gen) for k in sorted(params)}
        w = params
        if not w.is_floating_point() or (w.dim() < 2
                                          and not self.apply_to_bias):
            return None
        return self._draw_one(w, gen)


@dataclass
class WeightNoise(IWeightNoise):
    """Additive or multiplicative distribution noise on weights
    (reference WeightNoise(Distribution, applyToBias, additive))."""

    distribution: Any = None
    apply_to_bias: bool = False
    additive: bool = True

    def __post_init__(self):
        if self.distribution is None:
            self.distribution = NormalDistribution(0.0, 0.01)

    def _draw_one(self, w, gen):
        return self.distribution.sample(gen, tuple(w.shape), w.dtype,
                                        w.device)

    def apply(self, params, noise):
        return _map(lambda w, n: w + n if self.additive else w * n,
                    params, noise)


@dataclass
class DropConnect(IWeightNoise):
    """Bernoulli weight masking (reference DropConnect(weightRetainProb)):
    each weight kept with prob p and scaled 1/p."""

    weight_retain_prob: float = 0.5
    apply_to_bias: bool = False

    def _draw_one(self, w, gen):
        return torch.rand(tuple(w.shape), generator=gen,
                          device=w.device) < self.weight_retain_prob

    def apply(self, params, noise):
        p = self.weight_retain_prob
        return _map(lambda w, m: torch.where(m, w / p, 0.0).to(w.dtype),
                    params, noise)


def _effective_noise(layer):
    """Weight noise set on a layer nested inside a wrapper still fires:
    walk the wrapper chain (wrappers share their inner layer's params)."""
    seen = set()
    while layer is not None and id(layer) not in seen:
        wn = getattr(layer, "weight_noise", None)
        if wn is not None:
            return wn
        seen.add(id(layer))
        layer = (getattr(layer, "layer", None) or getattr(layer, "fwd", None)
                 or getattr(layer, "inner", None))
    return None


def maybe_apply_weight_noise(layer, params, gen, train):
    """The params to apply ``layer`` with: noisy in a train step of a
    layer with weight noise (drawn from ``gen``), else ``params``."""
    if not train or gen is None:
        return params
    wn = _effective_noise(layer)
    if wn is None:
        return params
    return wn.apply(params, wn.draw(params, gen))
