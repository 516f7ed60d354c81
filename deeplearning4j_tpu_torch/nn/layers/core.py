"""Core feed-forward layers — port of the part of
``deeplearning4j_tpu/nn/layers/core.py`` that ResNet-50, LeNet and the
char-RNN need: ``DenseLayer``, ``ActivationLayer``, ``LossLayer``,
``OutputLayer``, ``RnnOutputLayer``.

Not ported yet: the dropout family, embeddings, ElementWiseMultiplication,
PReLU and the other heads (CnnLoss, CenterLoss, OCNN), Mask, Reshape and
Permute layers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

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
