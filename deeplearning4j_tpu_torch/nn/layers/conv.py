"""2-D convolution family — port of the part of
``deeplearning4j_tpu/nn/layers/conv.py`` that ResNet-50 needs:
``ConvolutionLayer``, ``SubsamplingLayer``, ``GlobalPoolingLayer``,
``ZeroPaddingLayer``, ``SpaceToDepthLayer``.

Activations stay NHWC and kernels HWIO, as in the reference. A conv runs
``F.conv2d`` on ``x.permute(0, 3, 1, 2)`` — a channels_last NCHW view of
the contiguous NHWC tensor, so no copy — and permutes the channels_last
result back, which gives a contiguous NHWC tensor again. SAME padding is
XLA's: ``lo = total // 2, hi = total - lo``, asymmetric when the total is
odd (the 7×7/s2 stem on 224 pads (2, 3)); PyTorch's ``padding=`` is
symmetric, so SAME pads explicitly with ``F.pad`` (−inf for max pooling)
and then convolves or pools with padding 0.

Not ported yet: 1-D/3-D convolution and pooling, deconvolution,
depthwise/separable convolution, upsampling, cropping, depth-to-space and
locally-connected layers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn.functional as F

from .base import Ctx, Layer


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def same_pads(size: int, k: int, s: int, d: int = 1):
    """XLA's SAME padding of one spatial dim: (lo, hi), lo = total // 2."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _spatial_pads(x, kernel, stride, dilation, pad, mode):
    """((top, bottom), (left, right)) for an NHWC x: SAME when ``mode`` is
    "same" or ``pad`` is the string "same", none for "valid", else the
    explicit symmetric ``pad``."""
    (kh, kw), (sh, sw), (dh, dw) = kernel, stride, dilation
    if isinstance(pad, str):
        mode = pad.lower()
        if mode not in ("same", "valid"):
            raise ValueError(f"unknown padding {pad!r}")
        if mode == "valid":
            return (0, 0), (0, 0)
    if mode == "same":
        return (same_pads(x.shape[1], kh, sh, dh),
                same_pads(x.shape[2], kw, sw, dw))
    ph, pw = _pair(pad)
    return (ph, ph), (pw, pw)


def _pad_nhwc(x, pads, value=0.0):
    (pt, pb), (pl, pr) = pads
    if pt == pb == pl == pr == 0:
        return x
    return F.pad(x, (0, 0, pl, pr, pt, pb), value=value)


def _nchw(x):
    """The channels_last NCHW view of a contiguous NHWC tensor (no copy)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(y):
    """Back to NHWC: contiguous when ``y`` is channels_last."""
    return y.permute(0, 2, 3, 1)


@dataclass
class ConvolutionLayer(Layer):
    """2D conv. Kernel stored HWIO ("W": (kh,kw,cin/groups,cout)), bias (cout,)."""

    n_in: Optional[int] = None
    n_out: int = 0
    kernel_size: Any = (3, 3)
    stride: Any = (1, 1)
    padding: Any = 0
    dilation: Any = (1, 1)
    groups: int = 1
    convolution_mode: str = "truncate"   # DL4J ConvolutionMode.{Same,Truncate}
    activation: Any = "identity"
    has_bias: bool = True

    def _kernel_shape(self, c_in):
        kh, kw = _pair(self.kernel_size)
        return (kh, kw, c_in // self.groups, self.n_out)

    def init(self, gen, input_shape):
        h, w, c = input_shape
        c = self.n_in or c
        kshape = self._kernel_shape(c)
        fan_in = kshape[0] * kshape[1] * kshape[2]
        fan_out = kshape[0] * kshape[1] * self.n_out
        params = {"W": self._make_weight(gen, kshape, fan_in, fan_out)}
        if self.has_bias:
            params["b"] = self._make_bias((self.n_out,))
        oh, ow = self._out_hw(h, w)
        return params, {}, (oh, ow, self.n_out)

    def _out_hw(self, h, w):
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        dh, dw = _pair(self.dilation)
        if self.convolution_mode == "same" or (
                isinstance(self.padding, str)
                and self.padding.lower() == "same"):
            return -(-h // sh), -(-w // sw)
        ph, pw = (0, 0) if isinstance(self.padding, str) \
            else _pair(self.padding)
        eh, ew = dh * (kh - 1) + 1, dw * (kw - 1) + 1
        return (h + 2 * ph - eh) // sh + 1, (w + 2 * pw - ew) // sw + 1

    def apply(self, params, state, x, ctx: Ctx):
        x = self._cast_in(x)
        kernel, stride = _pair(self.kernel_size), _pair(self.stride)
        dilation = _pair(self.dilation)
        x = _pad_nhwc(x, _spatial_pads(x, kernel, stride, dilation,
                                       self.padding, self.convolution_mode))
        # HWIO -> OIHW in the channels_last layout cuDNN prefers
        w = params["W"].to(x.dtype).permute(3, 2, 0, 1) \
            .contiguous(memory_format=torch.channels_last)
        y = _nhwc(F.conv2d(_nchw(x), w, stride=stride, dilation=dilation,
                           groups=self.groups))
        if self.has_bias:
            y = y + params["b"].to(x.dtype)
        return self.activation_fn()(y), state


class PoolingType:
    MAX = "max"
    AVG = "avg"
    SUM = "sum"
    PNORM = "pnorm"


@dataclass
class SubsamplingLayer(Layer):
    """Pooling (SubsamplingLayer). NHWC."""

    kernel_size: Any = (2, 2)
    stride: Any = None
    padding: Any = 0
    pooling_type: str = PoolingType.MAX
    convolution_mode: str = "truncate"
    pnorm: int = 2

    def init(self, gen, input_shape):
        h, w, c = input_shape
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride if self.stride is not None
                       else self.kernel_size)
        if self.convolution_mode == "same":
            out = (-(-h // sh), -(-w // sw), c)
        else:
            ph, pw = _pair(self.padding)
            out = ((h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1, c)
        return {}, {}, out

    def apply(self, params, state, x, ctx: Ctx):
        kernel = _pair(self.kernel_size)
        stride = _pair(self.stride if self.stride is not None
                       else self.kernel_size)
        pads = _spatial_pads(x, kernel, stride, (1, 1), self.padding,
                             self.convolution_mode)
        if self.pooling_type == PoolingType.MAX:
            pad_value = -math.inf if x.is_floating_point() \
                else torch.iinfo(x.dtype).min
            y = F.max_pool2d(_nchw(_pad_nhwc(x, pads, pad_value)), kernel,
                             stride)
        else:
            xp = _nchw(_pad_nhwc(x, pads))
            if self.pooling_type == PoolingType.AVG:
                # under SAME the pad counts: the sum is divided by kh*kw
                y = F.avg_pool2d(xp, kernel, stride)
            elif self.pooling_type == PoolingType.SUM:
                y = F.avg_pool2d(xp, kernel, stride, divisor_override=1)
            else:
                p = float(self.pnorm)
                y = F.avg_pool2d(torch.abs(xp) ** p, kernel, stride,
                                 divisor_override=1) ** (1.0 / p)
        return _nhwc(y).to(x.dtype), state

    def has_params(self):
        return False


@dataclass
class ZeroPaddingLayer(Layer):
    padding: Any = (1, 1)  # (ph, pw) or ((pt,pb),(pl,pr))

    def _pads(self):
        p = self.padding
        if isinstance(p, int):
            return (p, p), (p, p)
        if isinstance(p[0], (tuple, list)):
            return tuple(p[0]), tuple(p[1])
        return (p[0], p[0]), (p[1], p[1])

    def init(self, gen, input_shape):
        h, w, c = input_shape
        (pt, pb), (pl, pr) = self._pads()
        return {}, {}, (h + pt + pb, w + pl + pr, c)

    def apply(self, params, state, x, ctx: Ctx):
        return _pad_nhwc(x, self._pads()), state

    def has_params(self):
        return False


@dataclass
class SpaceToDepthLayer(Layer):
    block_size: int = 2

    def init(self, gen, input_shape):
        h, w, c = input_shape
        b = self.block_size
        return {}, {}, (h // b, w // b, c * b * b)

    def apply(self, params, state, x, ctx: Ctx):
        n, h, w, c = x.shape
        b = self.block_size
        y = x.reshape(n, h // b, b, w // b, b, c)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(n, h // b, w // b, c * b * b)
        return y, state

    def has_params(self):
        return False


@dataclass
class GlobalPoolingLayer(Layer):
    """Global pooling over spatial/time dims (GlobalPoolingLayer).

    Supports masked mean/max for RNN inputs (B,T,C) with mask (B,T).
    """

    pooling_type: str = PoolingType.AVG
    pnorm: int = 2
    collapse_dimensions: bool = True

    def init(self, gen, input_shape):
        return {}, {}, (input_shape[-1],)

    def apply(self, params, state, x, ctx: Ctx):
        axes = tuple(range(1, x.dim() - 1))
        mask = ctx.mask
        if mask is not None and x.dim() == 3:
            m = mask[..., None].to(x.dtype)
            if self.pooling_type == PoolingType.MAX:
                y = torch.amax(torch.where(m > 0, x, torch.full_like(
                    x, -math.inf)), dim=1)
            elif self.pooling_type == PoolingType.SUM:
                y = torch.sum(x * m, dim=1)
            elif self.pooling_type == PoolingType.PNORM:
                p = float(self.pnorm)
                y = torch.sum((torch.abs(x) * m) ** p, dim=1) ** (1.0 / p)
            else:
                y = torch.sum(x * m, dim=1) / torch.clamp(
                    torch.sum(m, dim=1), min=1.0)
            return y, state
        if self.pooling_type == PoolingType.MAX:
            y = torch.amax(x, dim=axes)
        elif self.pooling_type == PoolingType.SUM:
            y = torch.sum(x, dim=axes)
        elif self.pooling_type == PoolingType.PNORM:
            p = float(self.pnorm)
            y = torch.sum(torch.abs(x) ** p, dim=axes) ** (1.0 / p)
        else:
            # jnp.mean accumulates a bf16 input in f32
            y = torch.mean(x, dim=axes, dtype=torch.float32).to(x.dtype)
        return y, state

    def has_params(self):
        return False
