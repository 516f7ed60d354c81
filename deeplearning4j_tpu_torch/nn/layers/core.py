"""Core feed-forward layers — port of the part of
``deeplearning4j_tpu/nn/layers/core.py`` that ResNet-50, LeNet and the
char-RNN need: ``DenseLayer``, ``ActivationLayer``, ``LossLayer``,
``OutputLayer``, ``RnnOutputLayer``; and the dropout family
(``DropoutLayer``, ``GaussianDropout``, ``GaussianNoise``,
``AlphaDropout``, ``SpatialDropout``).

Each random layer splits its work in two: a draw from the train step's
generator (``ctx.rng``, a ``torch.Generator`` on the net's device) and a
plain ``*_apply`` function of the input and those draws, which the tests
hold against the reference on the reference's own draws. The layers are
the identity at inference and where no generator is threaded.

Not ported yet: embeddings, ElementWiseMultiplication,
PReLU and the other heads (CnnLoss, CenterLoss, OCNN), Mask, Reshape and
Permute layers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from .. import losses as _losses
from .base import Ctx, Layer, apply_time_mask


@dataclass
class DenseLayer(Layer):
    """Fully connected: y = act(x @ W + b). W: (nIn, nOut) like the reference."""

    n_in: Optional[int] = None
    n_out: int = 0
    activation: Any = "identity"
    has_bias: bool = True

    def init(self, gen, input_shape):
        n_in = self.n_in or input_shape[-1]
        params = {"W": self._make_weight(gen, (n_in, self.n_out), n_in,
                                         self.n_out)}
        if self.has_bias:
            params["b"] = self._make_bias((self.n_out,))
        return params, {}, tuple(input_shape[:-1]) + (self.n_out,)

    def apply(self, params, state, x, ctx: Ctx):
        x = self._cast_in(x)
        y = x @ params["W"].to(x.dtype)
        if self.has_bias:
            y = y + params["b"].to(x.dtype)
        return self.activation_fn()(y), state


@dataclass
class ActivationLayer(Layer):
    activation: Any = "relu"

    def init(self, gen, input_shape):
        return {}, {}, input_shape

    def apply(self, params, state, x, ctx: Ctx):
        return self.activation_fn()(x), state

    def has_params(self):
        return False


# ------------------------------------------------------ the dropout family
# The reference's SELU fixed point: AlphaDropout's dropped value.
ALPHA_P = -1.7580993408473766


def keep_mask(shape, keep, gen, device):
    """Bernoulli(keep) draws of ``shape`` (bool)."""
    return torch.rand(shape, generator=gen, device=device) < keep


def dropout_apply(x, mask, keep):
    """Inverted dropout: kept entries scaled by 1/keep, the rest 0."""
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def gaussian_dropout_apply(x, z, rate):
    """x · (1 + std·z), std = sqrt(rate / (1 − rate)), z ~ N(0, 1)."""
    std = (rate / (1.0 - rate)) ** 0.5
    return x * (1.0 + std * z)


def gaussian_noise_apply(x, z, stddev):
    return x + stddev * z


def alpha_dropout_apply(x, mask, rate):
    """SELU-compatible dropout: dropped entries set to ALPHA_P, then the
    affine correction that keeps mean and variance."""
    keep = 1.0 - rate
    a = (keep + ALPHA_P ** 2 * keep * (1 - keep)) ** -0.5
    b = -a * ALPHA_P * (1 - keep)
    return (a * torch.where(mask, x, ALPHA_P) + b).to(x.dtype)


def spatial_mask_shape(x):
    """One draw per (example, channel): (B, 1, ..., 1, C)."""
    return (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)


@dataclass
class _NoiseLayer(Layer):
    def init(self, gen, input_shape):
        return {}, {}, input_shape

    def has_params(self):
        return False


@dataclass
class DropoutLayer(_NoiseLayer):
    """Inverted dropout; ``rate`` is the DROP probability (DL4J's
    ``dropOut(p)`` retains with p: :meth:`from_retain`)."""

    rate: float = 0.5

    @classmethod
    def from_retain(cls, retain_prob):
        return cls(rate=1.0 - retain_prob)

    def apply(self, params, state, x, ctx: Ctx):
        if not ctx.train or self.rate <= 0.0 or ctx.rng is None:
            return x, state
        keep = 1.0 - self.rate
        return dropout_apply(x, keep_mask(x.shape, keep, ctx.rng, x.device),
                             keep), state


@dataclass
class GaussianDropout(_NoiseLayer):
    rate: float = 0.5

    def apply(self, params, state, x, ctx: Ctx):
        if not ctx.train or self.rate <= 0.0 or ctx.rng is None:
            return x, state
        z = torch.randn(x.shape, generator=ctx.rng, device=x.device,
                        dtype=x.dtype)
        return gaussian_dropout_apply(x, z, self.rate), state


@dataclass
class GaussianNoise(_NoiseLayer):
    stddev: float = 0.1

    def apply(self, params, state, x, ctx: Ctx):
        if not ctx.train or ctx.rng is None:
            return x, state
        z = torch.randn(x.shape, generator=ctx.rng, device=x.device,
                        dtype=x.dtype)
        return gaussian_noise_apply(x, z, self.stddev), state


@dataclass
class AlphaDropout(_NoiseLayer):
    """SELU-compatible dropout (keeps the self-normalizing property)."""

    rate: float = 0.1

    def apply(self, params, state, x, ctx: Ctx):
        if not ctx.train or self.rate <= 0.0 or ctx.rng is None:
            return x, state
        m = keep_mask(x.shape, 1.0 - self.rate, ctx.rng, x.device)
        return alpha_dropout_apply(x, m, self.rate), state


@dataclass
class SpatialDropout(_NoiseLayer):
    """Drops whole channels of (B, ..., C). DL4J SpatialDropout."""

    rate: float = 0.5

    def apply(self, params, state, x, ctx: Ctx):
        if not ctx.train or self.rate <= 0.0 or ctx.rng is None:
            return x, state
        keep = 1.0 - self.rate
        m = keep_mask(spatial_mask_shape(x), keep, ctx.rng, x.device)
        return dropout_apply(x, m, keep), state


def _logits_loss(loss, activation):
    """The stable fused-logits variant when the loss has one and the
    activation is softmax/sigmoid, else None."""
    lf = str(loss).lower() if not callable(loss) else None
    if lf in _losses.LOGITS_VARIANTS and \
            str(activation).lower() in ("softmax", "sigmoid"):
        return _losses.LOGITS_VARIANTS[lf]
    return None


@dataclass
class LossLayer(Layer):
    """No params: applies activation + computes loss vs labels (LossLayer)."""

    activation: Any = "identity"
    loss: Any = "mse"

    def init(self, gen, input_shape):
        return {}, {}, input_shape

    def apply(self, params, state, x, ctx: Ctx):
        return self.activation_fn()(x), state

    def compute_loss(self, pre_activation, labels, mask=None):
        fused = _logits_loss(self.loss, self.activation)
        if fused is not None:
            return fused(labels, pre_activation, mask=mask)
        return _losses.get(self.loss)(
            labels, self.activation_fn()(pre_activation), mask=mask)

    def has_params(self):
        return False


@dataclass
class OutputLayer(DenseLayer):
    """Dense + loss head (org.deeplearning4j.nn.conf.layers.OutputLayer).

    ``apply`` returns activated predictions; the training path calls
    ``pre_activation`` + ``compute_loss`` so softmax/sigmoid losses fuse
    with logits for numerical stability.
    """

    loss: Any = "mcxent"
    activation: Any = "softmax"

    def pre_activation(self, params, x):
        y = x @ params["W"].to(x.dtype)
        if self.has_bias:
            y = y + params["b"].to(x.dtype)
        return y

    def compute_loss(self, params, x, labels, mask=None):
        logits = self.pre_activation(params, x)
        fused = _logits_loss(self.loss, self.activation)
        if fused is not None:
            return fused(labels, logits, mask=mask)
        return _losses.get(self.loss)(labels, self.activation_fn()(logits),
                                      mask=mask)


@dataclass
class RnnOutputLayer(OutputLayer):
    """Per-timestep output head: (B, T, nIn) → (B, T, nOut). ``apply``
    zeroes masked steps; the loss flattens (B, T) into rows, the label
    mask (B, T) weighting them."""

    def init(self, gen, input_shape):
        params, state, _ = super().init(gen, input_shape)
        t = input_shape[0] if len(input_shape) == 2 else None
        return params, state, (t, self.n_out)

    def apply(self, params, state, x, ctx: Ctx):
        y, state = DenseLayer.apply(self, params, state, x, ctx)
        return apply_time_mask(y, ctx.mask), state

    def compute_loss(self, params, x, labels, mask=None):
        logits = self.pre_activation(params, x)           # (B, T, C)
        fused = _logits_loss(self.loss, self.activation)
        if fused is None:
            return _losses.get(self.loss)(
                labels, self.activation_fn()(logits), mask=mask)
        b, t = logits.shape[0], logits.shape[1]
        flat_labels = labels.reshape(b * t, -1) if labels.dim() == 3 \
            else labels.reshape(b * t)
        return fused(flat_labels, logits.reshape(b * t, -1),
                     mask=None if mask is None else mask.reshape(b * t))
