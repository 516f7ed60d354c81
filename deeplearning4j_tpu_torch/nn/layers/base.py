"""Layer protocol + InputType — port of
``deeplearning4j_tpu/nn/layers/base.py``.

A layer is a config dataclass with two functions on tensors:
``init(gen, input_shape) -> (params, state, output_shape)`` and
``apply(params, state, x, ctx) -> (y, new_state)``. Reverse mode comes
from autograd over the composed forward. Params/state are plain dicts of
tensors named like the reference ("W", "b", "gamma", ...), in the
reference's layouts (NHWC activations, HWIO conv kernels), so weights
carry over by a plain copy. ``init`` draws on the host from a
``torch.Generator``; the network moves the trees to its device.

Shape convention (batch dim excluded everywhere):
  feed-forward: (nIn,)
  recurrent:    (T, nIn)  [NTC]
  convolutional:(H, W, C) [NHWC]

:func:`apply_time_mask` zeroes the padded steps of an NTC sequence.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from ... import _dist
from .. import activations as _act
from .. import weights as _winit


@dataclass
class Ctx:
    """Per-call context threaded through apply(): train flag, rng (a
    ``torch.Generator``), masks, and a parallel step's groups
    (``_dist.Groups``: BatchNormalization's statistics span the batch
    group, the layers of ``parallel/tp.py`` split over the tp group)."""

    train: bool = False
    rng: Any = None
    mask: Any = None          # feature/time mask (B,) or (B, T)
    label_mask: Any = None
    groups: _dist.Groups = _dist.NONE


class InputType:
    """DL4J InputType factory — plain shape tuples + kind tags."""

    @staticmethod
    def feed_forward(n):
        return ("ff", (int(n),))

    @staticmethod
    def recurrent(n, timesteps=None):
        return ("rnn", (timesteps, int(n)))

    @staticmethod
    def convolutional(height, width, channels):
        """NHWC output shape; accepts DL4J's (h, w, c) argument order."""
        return ("cnn", (int(height), int(width), int(channels)))

    @staticmethod
    def convolutional_3d(d, h, w, c):
        return ("cnn3d", (int(d), int(h), int(w), int(c)))


@dataclass
class Layer:
    """Base layer config. Subclasses define init/apply."""

    name: Optional[str] = None
    dtype: Any = torch.float32        # parameter dtype
    compute_dtype: Any = None         # if set, inputs cast before apply (bf16 policy)
    weight_init: Any = None           # None → inherit global default (xavier)
    bias_init: float = 0.0
    l1: float = 0.0                   # per-layer overrides picked up by the net
    l2: float = 0.0
    updater: Any = None               # per-layer updater override
    frozen: bool = False
    dropout: float = 0.0              # input dropout (DL4J layer dropOut)
    weight_noise: Any = None          # IWeightNoise (WeightNoise/DropConnect)
    constraints: Any = None           # weight constraints (constrainWeights)
    bias_constraints: Any = None      # bias constraints (constrainBias)

    def __post_init__(self):
        # Fail fast on config typos — apply-time is too late to learn an
        # activation or weight-init name is wrong.
        act = getattr(self, "activation", None)
        if act is not None:
            _act.get(act)
        if self.weight_init is not None:
            _winit.get(self.weight_init)

    # ---- to be overridden -------------------------------------------------
    def init(self, gen, input_shape):
        """Returns (params: dict, state: dict, output_shape)."""
        return {}, {}, input_shape

    def apply(self, params, state, x, ctx: Ctx):
        return x, state

    # ---- helpers ----------------------------------------------------------
    def _winit_fn(self):
        return _winit.get(self.weight_init or "xavier")

    def _make_weight(self, gen, shape, fan_in=None, fan_out=None):
        fi, fo = _winit.compute_fans(shape)
        fn = self._winit_fn()
        return fn(gen, shape, fan_in or fi, fan_out or fo, self.dtype)

    def _make_bias(self, shape):
        return torch.full(tuple(shape), self.bias_init, dtype=self.dtype)

    def _cast_in(self, x):
        if self.compute_dtype is not None and x.is_floating_point():
            return x.to(self.compute_dtype)
        return x

    def activation_fn(self):
        return _act.get(getattr(self, "activation", "identity"))

    def has_params(self):
        return True

    def n_params(self, input_shape):
        params, _, _ = self.init(torch.Generator().manual_seed(0),
                                 input_shape)
        return sum(p.numel() for p in params.values())



def apply_time_mask(y, mask):
    """Zero padded timesteps: y (B, T, C), mask (B, T) → masked y."""
    if mask is None:
        return y
    return y * mask[..., None].to(y.dtype)
