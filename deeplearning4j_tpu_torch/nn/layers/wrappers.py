"""Wrapper layers — port of ``deeplearning4j_tpu/nn/layers/wrappers.py``:
``FrozenLayer`` (and its alias ``FrozenLayerWithBackprop``),
``TimeDistributedLayer``, ``MaskZeroLayer``, ``RepeatVector``.

Freezing detaches the wrapped params in the forward (autograd gives them
no gradient, which the train step reads as zero) and labels them for the
NoOp updater (the nets route ``frozen`` layers to it), so a frozen leaf
takes no update, eager or replayed. The gradient still flows through the
layer to the layers before it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ...train.updaters import tree_map
from .base import Ctx, Layer


def unwrap(layer):
    """Peel wrapper layers to the innermost config (for type dispatch)."""
    while isinstance(layer, BaseWrapperLayer):
        layer = layer.layer
    return layer


@dataclass
class BaseWrapperLayer(Layer):
    """Delegates init/apply to ``layer``; subclasses adjust in/out."""

    layer: Any = None

    def init(self, gen, input_shape):
        return self.layer.init(gen, input_shape)

    def apply(self, params, state, x, ctx: Ctx):
        return self.layer.apply(params, state, x, ctx)

    def has_params(self):
        return self.layer.has_params()

    def activation_fn(self):
        return self.layer.activation_fn()


@dataclass
class FrozenLayer(BaseWrapperLayer):
    """The wrapped layer runs forward, its params get no gradient and no
    update (FrozenLayer / FrozenLayerWithBackprop: with autograd the two
    coincide, the upstream gradient always flows through)."""

    def __post_init__(self):
        super().__post_init__()
        self.frozen = True
        if self.layer is not None:
            self.layer.frozen = True

    def apply(self, params, state, x, ctx: Ctx):
        return self.layer.apply(tree_map(torch.Tensor.detach, params),
                                state, x, ctx)


FrozenLayerWithBackprop = FrozenLayer


@dataclass
class TimeDistributedLayer(BaseWrapperLayer):
    """Applies any per-sample layer at each timestep by folding time into
    the batch: (B, T, *S) → (B·T, *S) → layer → (B, T, *S')."""

    def init(self, gen, input_shape):
        t = input_shape[0]
        params, state, out = self.layer.init(gen, tuple(input_shape[1:]))
        out_t = tuple(out) if isinstance(out, tuple) else (out,)
        return params, state, (t,) + out_t

    def apply(self, params, state, x, ctx: Ctx):
        b, t = x.shape[0], x.shape[1]
        y, state = self.layer.apply(
            params, state, x.reshape((b * t,) + tuple(x.shape[2:])), ctx)
        return y.reshape((b, t) + tuple(y.shape[1:])), state


@dataclass
class MaskZeroLayer(BaseWrapperLayer):
    """Sets masked steps to ``mask_value`` on the way into the wrapped
    recurrent layer (MaskZeroLayer); the mask is ``ctx.mask`` (B, T)."""

    mask_value: float = 0.0

    def apply(self, params, state, x, ctx: Ctx):
        if ctx.mask is not None:
            keep = ctx.mask[..., None].to(x.dtype)
            x = x * keep + self.mask_value * (1.0 - keep)
        return self.layer.apply(params, state, x, ctx)


@dataclass
class RepeatVector(Layer):
    """(B, C) → (B, n, C), the input repeated n times (RepeatVector)."""

    n: int = 1

    def init(self, gen, input_shape):
        return {}, {}, (self.n, input_shape[-1])

    def apply(self, params, state, x, ctx: Ctx):
        return x[:, None, :].expand(-1, self.n, -1).contiguous(), state

    def has_params(self):
        return False
