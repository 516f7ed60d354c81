"""Core feed-forward layers — port of
``deeplearning4j_tpu/nn/layers/core.py``: ``DenseLayer``,
``ActivationLayer``, the embeddings, ``ElementWiseMultiplicationLayer``,
``PReLULayer``; the heads ``LossLayer``, ``OutputLayer``,
``RnnOutputLayer``, ``CnnLossLayer``, ``CenterLossOutputLayer`` and
``OCNNOutputLayer``; ``MaskLayer``, ``ReshapeLayer``, ``PermuteLayer``;
and the dropout family (``DropoutLayer``, ``GaussianDropout``,
``GaussianNoise``, ``AlphaDropout``, ``SpatialDropout``).

Each random layer splits its work in two: a draw from the train step's
generator (``ctx.rng``, a ``torch.Generator`` on the net's device) and a
plain ``*_apply`` function of the input and those draws, which the tests
hold against the reference on the reference's own draws. The layers are
the identity at inference and where no generator is threaded.

``CenterLossOutputLayer`` and ``OCNNOutputLayer`` keep a running state
(class centers; the margin r) that the network's loss updates from the
batch (``update_state``), as the reference's does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from ... import _dist
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

    def compute_loss(self, pre_activation, labels, mask=None,
                     groups=_dist.NONE):
        """The loss; under a parallel step's ``groups`` this rank's share
        of the global batch's (``nn.losses.score``)."""
        fused = _logits_loss(self.loss, self.activation)
        if fused is not None:
            return fused(labels, pre_activation, mask=mask,
                         group=groups.batch)
        return _losses.score(self.loss, labels,
                             self.activation_fn()(pre_activation), mask,
                             groups.batch)

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

    def compute_loss(self, params, x, labels, mask=None,
                     groups=_dist.NONE):
        """The loss; under a parallel step's ``groups`` this rank's share
        of the global batch's (``nn.losses.score``)."""
        return self.logits_loss(self.pre_activation(params, x), labels,
                                mask, groups.batch)

    def logits_loss(self, logits, labels, mask=None, group=None):
        """The loss of the pre-activation ``logits``, over the batch
        ``group``."""
        fused = _logits_loss(self.loss, self.activation)
        if fused is not None:
            return fused(labels, logits, mask=mask, group=group)
        return _losses.score(self.loss, labels, self.activation_fn()(logits),
                             mask, group)


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

    def logits_loss(self, logits, labels, mask=None, group=None):
        """The loss of the (B, T, C) ``logits``, over the batch
        ``group``."""
        fused = _logits_loss(self.loss, self.activation)
        if fused is None:
            return _losses.score(self.loss, labels,
                                 self.activation_fn()(logits), mask, group)
        b, t = logits.shape[0], logits.shape[1]
        flat_labels = labels.reshape(b * t, -1) if labels.dim() == 3 \
            else labels.reshape(b * t)
        return fused(flat_labels, logits.reshape(b * t, -1),
                     mask=None if mask is None else mask.reshape(b * t),
                     group=group)


# ---------------------------------------------------------- embeddings
@dataclass
class EmbeddingLayer(Layer):
    """Index → vector. Input (B,) int ids (or (B, 1)); output (B, nOut)."""

    n_in: Optional[int] = None   # vocab size
    n_out: int = 0
    has_bias: bool = False
    activation: Any = "identity"

    def init(self, gen, input_shape):
        params = {"W": self._make_weight(gen, (self.n_in, self.n_out),
                                         self.n_in, self.n_out)}
        if self.has_bias:
            params["b"] = self._make_bias((self.n_out,))
        return params, {}, (self.n_out,)

    def apply(self, params, state, x, ctx: Ctx):
        ids = x.to(torch.int64)
        if ids.dim() > 1 and ids.shape[-1] == 1:
            ids = ids[..., 0]
        y = params["W"][ids]
        if self.has_bias:
            y = y + params["b"]
        return self.activation_fn()(y), state


@dataclass
class EmbeddingSequenceLayer(EmbeddingLayer):
    """Sequence of ids (B, T) → (B, T, nOut) [NTC]."""

    def init(self, gen, input_shape):
        params, state, _ = super().init(gen, input_shape)
        t = input_shape[0] if input_shape else None
        return params, state, (t, self.n_out)


@dataclass
class ElementWiseMultiplicationLayer(Layer):
    """y = act(x * w + b), elementwise learned scaling (nIn == nOut)."""

    n_in: Optional[int] = None
    n_out: int = 0
    activation: Any = "identity"

    def init(self, gen, input_shape):
        n = self.n_out or self.n_in or input_shape[-1]
        return ({"W": torch.ones((n,), dtype=self.dtype),
                 "b": self._make_bias((n,))},
                {}, tuple(input_shape[:-1]) + (n,))

    def apply(self, params, state, x, ctx: Ctx):
        return self.activation_fn()(x * params["W"] + params["b"]), state


@dataclass
class PReLULayer(Layer):
    """Parametric ReLU with a learned alpha per feature; ``shared_axes``
    (per-example dims, 0-based) share one alpha."""

    alpha_init: float = 0.0
    shared_axes: tuple = ()

    def init(self, gen, input_shape):
        shape = tuple(1 if i in self.shared_axes else s
                      for i, s in enumerate(input_shape))
        return ({"alpha": torch.full(shape, self.alpha_init,
                                     dtype=self.dtype)}, {}, input_shape)

    def apply(self, params, state, x, ctx: Ctx):
        return torch.where(x >= 0, x, params["alpha"] * x), state


# ---------------------------------------------------------------- heads
@dataclass
class CnnLossLayer(LossLayer):
    """Per-pixel loss over (B, H, W, C) activations, no params
    (CnnLossLayer). Labels are (B, H, W, C); a mask (B, H, W) drops
    pixels. Space folds into the batch, so every loss sees (N, C)."""

    def compute_loss(self, pre_activation, labels, mask=None,
                     groups=_dist.NONE):
        c = pre_activation.shape[-1]
        flat = pre_activation.reshape(-1, c)
        flat_labels = labels.reshape(-1, labels.shape[-1])
        flat_mask = mask.reshape(-1) if mask is not None else None
        return super().compute_loss(flat, flat_labels, mask=flat_mask,
                                    groups=groups)


@dataclass
class CenterLossOutputLayer(OutputLayer):
    """Softmax + center loss (intra-class compactness). The per-class
    centers live in ``state`` and move toward each batch's features at
    rate ``alpha`` (:meth:`update_state`)."""

    alpha: float = 0.05
    lambda_: float = 2e-4

    def init(self, gen, input_shape):
        params, state, out = super().init(gen, input_shape)
        n_in = self.n_in or input_shape[-1]
        state = dict(state)
        state["centers"] = torch.zeros((self.n_out, n_in), dtype=self.dtype)
        return params, state, out

    def compute_loss(self, params, x, labels, mask=None, state=None,
                     groups=_dist.NONE):
        base = super().compute_loss(params, x, labels, mask, groups)
        if state is None:
            return base
        cls = torch.argmax(labels, dim=-1)
        diff = x - state["centers"][cls]
        center_loss = 0.5 * torch.mean(torch.sum(diff * diff, dim=-1))
        return base + self.lambda_ * _dist.share(center_loss,
                                                 groups.batch)

    def update_state(self, state, x, labels):
        cls = torch.argmax(labels, dim=-1)
        centers = state["centers"]
        diff = centers[cls] - x
        counts = torch.zeros((self.n_out,), dtype=x.dtype,
                             device=x.device).index_add(
            0, cls, torch.ones_like(diff[:, 0]))
        delta = torch.zeros_like(centers).index_add(0, cls, diff)
        delta = delta / (1.0 + counts)[:, None]
        return {**state, "centers": centers - self.alpha * delta}


@dataclass
class MaskLayer(Layer):
    """Zeroes activations at masked steps (or examples) and otherwise
    passes through (MaskLayer)."""

    def init(self, gen, input_shape):
        return {}, {}, input_shape

    def apply(self, params, state, x, ctx: Ctx):
        if ctx.mask is None:
            return x, state
        if x.dim() == 3:
            return apply_time_mask(x, ctx.mask), state
        m = ctx.mask.reshape((ctx.mask.shape[0],) + (1,) * (x.dim() - 1))
        return x * m.to(x.dtype), state

    def has_params(self):
        return False


@dataclass
class OCNNOutputLayer(Layer):
    """One-class neural network output layer for anomaly detection
    (OCNNOutputLayer; Chalapathy et al. 2018).

    score(x) = w · act(V x); loss = 0.5‖V‖² + 0.5‖w‖² + mean(relu(r −
    score)) / nu − r. The margin r follows the nu-quantile of the batch
    scores through an EMA held in ``state`` (:meth:`update_state`).
    Labels are ignored; ``score < r`` marks an anomaly."""

    n_in: Optional[int] = None
    hidden_size: int = 32
    nu: float = 0.04
    activation: Any = "sigmoid"
    window_size: int = 10000      # kept for the reference's API
    initial_r_value: float = 0.1
    r_update_rate: float = 0.1    # EMA rate of the quantile target

    def init(self, gen, input_shape):
        n_in = self.n_in or input_shape[-1]
        params = {"V": self._make_weight(gen, (n_in, self.hidden_size)),
                  "w": self._make_weight(gen, (self.hidden_size, 1))}
        state = {"r": torch.tensor(self.initial_r_value, dtype=self.dtype)}
        return params, state, (1,)

    def ocnn_score(self, params, x):
        h = self.activation_fn()(x @ params["V"])
        return (h @ params["w"])[..., 0]

    def apply(self, params, state, x, ctx: Ctx):
        return self.ocnn_score(params, x)[:, None], state

    def compute_loss(self, params, x, labels, mask=None, state=None):
        score = self.ocnn_score(params, x)
        r = state["r"] if state is not None else torch.tensor(
            self.initial_r_value, dtype=score.dtype, device=score.device)
        reg = 0.5 * torch.sum(params["V"] ** 2) \
            + 0.5 * torch.sum(params["w"] ** 2)
        hinge = torch.mean(torch.relu(r - score)) / self.nu
        return reg + hinge - r

    def update_state(self, state, x, params):
        with torch.no_grad():
            score = self.ocnn_score(params, x)
            q = torch.quantile(score, self.nu)
            r = state["r"] * (1.0 - self.r_update_rate) \
                + self.r_update_rate * q
        return {**state, "r": r.to(state["r"].dtype)}


# --------------------------------------------------------------- shapes
@dataclass
class ReshapeLayer(Layer):
    """Reshape each example's activations (keras Reshape); ``target_shape``
    excludes the batch and may hold one -1."""

    target_shape: Any = None

    def init(self, gen, input_shape):
        if self.target_shape is None:
            raise ValueError("target_shape required")
        tgt = tuple(int(t) for t in self.target_shape)
        n_in = int(np.prod(input_shape))
        if tgt.count(-1) > 1:
            raise ValueError(f"at most one -1 wildcard allowed, got {tgt}")
        if -1 in tgt:
            known = int(-np.prod(tgt))      # product of the fixed dims
            if known == 0 or n_in % known:
                raise ValueError(f"cannot reshape {input_shape} -> {tgt}")
            tgt = tuple(n_in // known if t == -1 else t for t in tgt)
        elif int(np.prod(tgt)) != n_in:
            raise ValueError(f"cannot reshape {input_shape} -> {tgt}")
        return {}, {}, tgt

    def apply(self, params, state, x, ctx: Ctx):
        return x.reshape((x.shape[0],) + tuple(self.target_shape)), state

    def has_params(self):
        return False


@dataclass
class PermuteLayer(Layer):
    """Permute each example's dims, 1-indexed like keras Permute((2, 1))."""

    dims: Any = None

    def init(self, gen, input_shape):
        if self.dims is None:
            raise ValueError("dims required")
        d = tuple(int(i) for i in self.dims)
        if sorted(d) != list(range(1, len(input_shape) + 1)):
            raise ValueError(f"dims {d} must permute 1..{len(input_shape)}")
        return {}, {}, tuple(input_shape[i - 1] for i in d)

    def apply(self, params, state, x, ctx: Ctx):
        return x.permute((0,) + tuple(self.dims)), state

    def has_params(self):
        return False
