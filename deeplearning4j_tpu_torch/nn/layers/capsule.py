"""Capsule network layers — port of
``deeplearning4j_tpu/nn/layers/capsule.py``: ``PrimaryCapsules``,
``CapsuleLayer`` (dynamic routing), ``CapsuleStrengthLayer``.

Routing is the reference's unrolled loop: the agreement logits are built
from detached predictions, and only the last iteration's weighted sum
carries the gradient to the predictions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from .base import Ctx, Layer
from .conv import ConvolutionLayer


def squash(s, dim=-1, eps=1e-9):
    """v = |s|²/(1+|s|²) · s/|s| — the capsule nonlinearity."""
    sq = torch.sum(s * s, dim=dim, keepdim=True)
    return (sq / (1.0 + sq)) * s / torch.sqrt(sq + eps)


@dataclass
class PrimaryCapsules(Layer):
    """Conv2D → (B, nCaps, capDim) → squash (PrimaryCapsules)."""

    capsules: int = 8            # capsule channels (filters = capsules·dim)
    capsule_dimensions: int = 8
    kernel_size: Tuple = (9, 9)
    stride: Tuple = (2, 2)

    def _conv_layer(self):
        return ConvolutionLayer(
            n_out=self.capsules * self.capsule_dimensions,
            kernel_size=self.kernel_size, stride=self.stride,
            convolution_mode="truncate", activation="identity",
            dtype=self.dtype, weight_init=self.weight_init)

    def init(self, gen, input_shape):
        params, state, (h, w, c) = self._conv_layer().init(gen, input_shape)
        return params, state, (h * w * self.capsules,
                               self.capsule_dimensions)

    def apply(self, params, state, x, ctx: Ctx):
        y, state = self._conv_layer().apply(params, state, x, ctx)
        return squash(y.reshape(y.shape[0], -1, self.capsule_dimensions)), \
            state


@dataclass
class CapsuleLayer(Layer):
    """Fully connected capsules with dynamic routing (CapsuleLayer): input
    (B, nIn, dIn) → predictions û = W·x per (in, out) pair → ``routings``
    rounds of softmax agreement → (B, nOut, dOut). W (1, nIn, nOut, dOut,
    dIn)."""

    capsules: int = 10
    capsule_dimensions: int = 16
    routings: int = 3

    def init(self, gen, input_shape):
        n_in, d_in = input_shape
        w = torch.randn((1, n_in, self.capsules, self.capsule_dimensions,
                         d_in), generator=gen, dtype=self.dtype) * 0.01
        return {"W": w}, {}, (self.capsules, self.capsule_dimensions)

    def apply(self, params, state, x, ctx: Ctx):
        u_hat = torch.einsum("iokd,bid->biok", params["W"][0], x)
        logits = torch.zeros(u_hat.shape[:3], dtype=u_hat.dtype,
                             device=u_hat.device)           # (B, nIn, nOut)
        u_detached = u_hat.detach()
        v = None
        for r in range(self.routings):
            c = torch.softmax(logits, dim=2)[..., None]
            uh = u_hat if r == self.routings - 1 else u_detached
            v = squash(torch.sum(c * uh, dim=1))            # (B, nOut, dOut)
            if r < self.routings - 1:
                logits = logits + torch.sum(u_detached * v[:, None], dim=-1)
        return v, state


@dataclass
class CapsuleStrengthLayer(Layer):
    """(B, nCaps, dim) → each capsule's L2 norm (B, nCaps)."""

    def init(self, gen, input_shape):
        return {}, {}, (input_shape[0],)

    def apply(self, params, state, x, ctx: Ctx):
        return torch.sqrt(torch.sum(x * x, dim=-1) + 1e-9), state

    def has_params(self):
        return False
