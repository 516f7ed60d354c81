"""Convolution family — port of ``deeplearning4j_tpu/nn/layers/conv.py``:
convolution (1-D, 2-D, 3-D, transposed 2-D and 3-D, depthwise,
separable), pooling (1-D, 2-D, 3-D, global), upsampling, cropping and
zero padding (1-D, 2-D, 3-D), space-to-depth and depth-to-space, and the
locally connected layers.

Activations stay NHWC and kernels HWIO, as in the reference. A conv runs
``F.conv2d`` on ``x.permute(0, 3, 1, 2)`` — a channels_last NCHW view of
the contiguous NHWC tensor, so no copy — and permutes the channels_last
result back, which gives a contiguous NHWC tensor again. SAME padding is
XLA's: ``lo = total // 2, hi = total - lo``, asymmetric when the total is
odd (the 7×7/s2 stem on 224 pads (2, 3)); PyTorch's ``padding=`` is
symmetric, so SAME pads explicitly with ``F.pad`` (−inf for max pooling)
and then convolves or pools with padding 0.

The other ranks and kinds go through :func:`conv_nd` on channels-last
tensors: explicit ``F.pad`` (:func:`nd_pads`: XLA's SAME, or the
symmetric ``padding``), then ``F.conv{1,2,3}d`` on the channels-first
view; every pooling layer through :func:`_pool_nd`. A transposed
convolution is XLA's ``conv_transpose``: the input dilated by the stride
(zeros between the rows), padded, and correlated with the un-flipped
kernel. The locally connected layers take patches with ``F.unfold``, in
``conv_general_dilated_patches``' order (channel-major, then the window).
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


def _triple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v, v)


def _single(v):
    return v if isinstance(v, int) else v[0]


def nd_pads(x, kernel, stride, dilation, pad, mode):
    """Per spatial dim (lo, hi) of a channels-last ``x``: XLA's SAME when
    ``mode`` or the string ``pad`` is "same", none for "valid", else the
    explicit symmetric ``pad`` (an int or one per dim)."""
    n = len(kernel)
    if isinstance(pad, str):
        if pad.lower() not in ("same", "valid"):
            raise ValueError(f"unknown padding {pad!r}")
        if pad.lower() == "valid":
            return [(0, 0)] * n
        mode = "same"
    if mode == "same":
        return [same_pads(x.shape[1 + i], kernel[i], stride[i], dilation[i])
                for i in range(n)]
    p = (pad,) * n if isinstance(pad, int) else tuple(pad)
    return [(q, q) for q in p]


def pad_channels_last(x, pads, value=0.0):
    """``F.pad`` of the spatial dims of (B, *S, C) by ``pads`` [(lo, hi)];
    negative amounts crop."""
    if all(lo == 0 and hi == 0 for lo, hi in pads):
        return x
    flat = [0, 0]
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(x, flat, value=value)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def conv_nd(x, w, stride, dilation=None, pads=None, groups=1):
    """Correlate channels-last ``x`` (B, *S, C) with ``w`` (*K, C/groups,
    O) after padding by ``pads``: (B, *S', O)."""
    n = w.dim() - 2
    x = pad_channels_last(x, pads or [(0, 0)] * n)
    wc = w.permute(n + 1, n, *range(n))
    y = _CONV[n](x.movedim(-1, 1), wc, stride=tuple(stride),
                 dilation=tuple(dilation or (1,) * n), groups=groups)
    return y.movedim(1, -1)


def transpose_pads(kernel, stride, pad, mode):
    """XLA ``conv_transpose``'s (lo, hi) per dim: SAME and VALID from
    ``_conv_transpose_padding``; the reference's explicit ``padding`` p is
    (k − 1 − p) on both sides."""
    out = []
    for i, (k, s) in enumerate(zip(kernel, stride)):
        if mode == "same":
            pad_len = k + s - 2
            lo = k - 1 if s > k - 1 else -(-pad_len // 2)
            out.append((lo, pad_len - lo))
        else:
            p = pad if isinstance(pad, int) else pad[i]
            out.append((k - 1 - p, k - 1 - p))
    return out


def conv_transpose_nd(x, w, stride, pads):
    """XLA's ``conv_transpose`` (kernel not flipped) of channels-last
    ``x`` with ``w`` (*K, C, O): the input dilated by ``stride``, padded
    by ``pads``, correlated with ``w``."""
    n = len(stride)
    if any(s != 1 for s in stride):
        size = [x.shape[0]] + [(d - 1) * s + 1 for d, s in
                               zip(x.shape[1:-1], stride)] + [x.shape[-1]]
        dil = x.new_zeros(size)
        dil[(slice(None),) + tuple(slice(None, None, s) for s in stride)
            + (slice(None),)] = x
        x = dil
    return conv_nd(x, w, (1,) * n, None, pads)


def _pool_nd(x, kernel, stride, pads, kind, pnorm=2):
    """Pool a channels-last (B, *S, C) ``x`` (1-, 2- or 3-D) over
    ``kernel`` after padding by ``pads`` (−inf for max): max, avg (the sum
    over the window, pads included, over its size), sum or pnorm."""
    n = len(kernel)
    if n == 1:                       # 1-D pools as 2-D over (1, T)
        y = _pool_nd(x[:, None], (1,) + tuple(kernel), (1,) + tuple(stride),
                     [(0, 0)] + list(pads), kind, pnorm)
        return y[:, 0]
    pool_max = F.max_pool2d if n == 2 else F.max_pool3d
    pool_avg = F.avg_pool2d if n == 2 else F.avg_pool3d
    if kind == PoolingType.MAX:
        pad_value = -math.inf if x.is_floating_point() \
            else torch.iinfo(x.dtype).min
        y = pool_max(pad_channels_last(x, pads, pad_value).movedim(-1, 1),
                     kernel, stride)
    else:
        xp = pad_channels_last(x, pads).movedim(-1, 1)
        if kind == PoolingType.AVG:
            y = pool_avg(xp, kernel, stride)
        elif kind == PoolingType.SUM:
            y = pool_avg(xp, kernel, stride, divisor_override=1)
        else:
            p = float(pnorm)
            y = pool_avg(torch.abs(xp) ** p, kernel, stride,
                         divisor_override=1) ** (1.0 / p)
    return y.movedim(1, -1).to(x.dtype)


def same_pads(size: int, k: int, s: int, d: int = 1):
    """XLA's SAME padding of one spatial dim: (lo, hi), lo = total // 2."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


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
        x = pad_channels_last(x, nd_pads(x, kernel, stride, dilation,
                                         self.padding,
                                         self.convolution_mode))
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
        pads = nd_pads(x, kernel, stride, (1, 1), self.padding,
                       self.convolution_mode)
        return _pool_nd(x, kernel, stride, pads, self.pooling_type,
                        self.pnorm), state

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
        return pad_channels_last(x, self._pads()), state

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


# ------------------------------------------------- other ranks and kinds
@dataclass
class Convolution1DLayer(Layer):
    """1D conv over (B, T, C) [NTC]; W (k, C, nOut)."""

    n_in: Optional[int] = None
    n_out: int = 0
    kernel_size: int = 3
    stride: int = 1
    padding: Any = 0
    dilation: int = 1
    convolution_mode: str = "same"
    activation: Any = "identity"
    has_bias: bool = True

    def init(self, gen, input_shape):
        t, c = input_shape
        c = self.n_in or c
        k = _single(self.kernel_size)
        params = {"W": self._make_weight(gen, (k, c, self.n_out), k * c,
                                         k * self.n_out)}
        if self.has_bias:
            params["b"] = self._make_bias((self.n_out,))
        if self.convolution_mode == "same":
            ot = None if t is None else -(-t // self.stride)
        else:
            p = _single(self.padding)
            e = self.dilation * (k - 1) + 1
            ot = None if t is None else (t + 2 * p - e) // self.stride + 1
        return params, {}, (ot, self.n_out)

    def apply(self, params, state, x, ctx: Ctx):
        x = self._cast_in(x)
        k = _single(self.kernel_size)
        pad = self.padding if isinstance(self.padding, str) \
            else _single(self.padding)
        pads = nd_pads(x, (k,), (self.stride,), (self.dilation,), pad,
                       self.convolution_mode)
        y = conv_nd(x, params["W"].to(x.dtype), (self.stride,),
                    (self.dilation,), pads)
        if self.has_bias:
            y = y + params["b"].to(x.dtype)
        return self.activation_fn()(y), state


@dataclass
class Convolution3DLayer(Layer):
    """3D conv over (B, D, H, W, C) [NDHWC]; W DHWIO."""

    n_in: Optional[int] = None
    n_out: int = 0
    kernel_size: Any = (3, 3, 3)
    stride: Any = (1, 1, 1)
    padding: Any = 0
    dilation: Any = (1, 1, 1)
    convolution_mode: str = "same"
    activation: Any = "identity"
    has_bias: bool = True

    def init(self, gen, input_shape):
        d, h, w, c = input_shape
        c = self.n_in or c
        kd, kh, kw = _triple(self.kernel_size)
        params = {"W": self._make_weight(
            gen, (kd, kh, kw, c, self.n_out), kd * kh * kw * c,
            kd * kh * kw * self.n_out)}
        if self.has_bias:
            params["b"] = self._make_bias((self.n_out,))
        sd, sh, sw = _triple(self.stride)
        if self.convolution_mode == "same":
            out = (-(-d // sd), -(-h // sh), -(-w // sw), self.n_out)
        else:
            pd, ph, pw = _triple(self.padding)
            dd, dh, dw = _triple(self.dilation)
            out = ((d + 2 * pd - (dd * (kd - 1) + 1)) // sd + 1,
                   (h + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1,
                   (w + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1, self.n_out)
        return params, {}, out

    def apply(self, params, state, x, ctx: Ctx):
        x = self._cast_in(x)
        kernel, stride = _triple(self.kernel_size), _triple(self.stride)
        dilation = _triple(self.dilation)
        pads = nd_pads(x, kernel, stride, dilation, self.padding,
                       self.convolution_mode)
        y = conv_nd(x, params["W"].to(x.dtype), stride, dilation, pads)
        if self.has_bias:
            y = y + params["b"].to(x.dtype)
        return self.activation_fn()(y), state


@dataclass
class Deconvolution2D(ConvolutionLayer):
    """Transposed conv (Deconvolution2D); W HWIO (kh, kw, C, nOut)."""

    def init(self, gen, input_shape):
        h, w, c = input_shape
        c = self.n_in or c
        kh, kw = _pair(self.kernel_size)
        params = {"W": self._make_weight(gen, (kh, kw, c, self.n_out),
                                         kh * kw * c, kh * kw * self.n_out)}
        if self.has_bias:
            params["b"] = self._make_bias((self.n_out,))
        sh, sw = _pair(self.stride)
        if self.convolution_mode == "same":
            out = (None if h is None else h * sh,
                   None if w is None else w * sw, self.n_out)
        else:
            ph, pw = _pair(self.padding)
            out = (None if h is None else sh * (h - 1) + kh - 2 * ph,
                   None if w is None else sw * (w - 1) + kw - 2 * pw,
                   self.n_out)
        return params, {}, out

    def apply(self, params, state, x, ctx: Ctx):
        x = self._cast_in(x)
        stride = _pair(self.stride)
        pads = transpose_pads(_pair(self.kernel_size), stride,
                              _pair(self.padding), self.convolution_mode)
        y = conv_transpose_nd(x, params["W"].to(x.dtype), stride, pads)
        if self.has_bias:
            y = y + params["b"].to(x.dtype)
        return self.activation_fn()(y), state


@dataclass
class Deconvolution3D(Convolution3DLayer):
    """Transposed 3-D conv over (B, D, H, W, C) [NDHWC]; W DHWIO."""

    def init(self, gen, input_shape):
        d, h, w, c = input_shape
        c = self.n_in or c
        kd, kh, kw = _triple(self.kernel_size)
        params = {"W": self._make_weight(
            gen, (kd, kh, kw, c, self.n_out), kd * kh * kw * c,
            kd * kh * kw * self.n_out)}
        if self.has_bias:
            params["b"] = self._make_bias((self.n_out,))
        sd, sh, sw = _triple(self.stride)
        if self.convolution_mode == "same":
            out = (d * sd, h * sh, w * sw, self.n_out)
        else:
            pd, ph, pw = _triple(self.padding)
            out = (sd * (d - 1) + kd - 2 * pd, sh * (h - 1) + kh - 2 * ph,
                   sw * (w - 1) + kw - 2 * pw, self.n_out)
        return params, {}, out

    def apply(self, params, state, x, ctx: Ctx):
        x = self._cast_in(x)
        stride = _triple(self.stride)
        pads = transpose_pads(_triple(self.kernel_size), stride,
                              _triple(self.padding), self.convolution_mode)
        y = conv_transpose_nd(x, params["W"].to(x.dtype), stride, pads)
        if self.has_bias:
            y = y + params["b"].to(x.dtype)
        return self.activation_fn()(y), state


def _out_hw_2d(h, w, kernel, stride, padding, mode):
    kh, kw = kernel
    sh, sw = stride
    if mode == "same":
        return -(-h // sh), -(-w // sw)
    ph, pw = _pair(padding)
    return (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1


@dataclass
class DepthwiseConvolution2D(Layer):
    """One (kh, kw) filter per input channel and multiplier; W (kh, kw, 1,
    C·m), output channel o from input channel o // m."""

    n_in: Optional[int] = None
    depth_multiplier: int = 1
    kernel_size: Any = (3, 3)
    stride: Any = (1, 1)
    padding: Any = 0
    convolution_mode: str = "same"
    activation: Any = "identity"
    has_bias: bool = True

    def init(self, gen, input_shape):
        h, w, c = input_shape
        c = self.n_in or c
        kh, kw = _pair(self.kernel_size)
        n_out = c * self.depth_multiplier
        params = {"W": self._make_weight(gen, (kh, kw, 1, n_out), kh * kw,
                                         kh * kw * self.depth_multiplier)}
        if self.has_bias:
            params["b"] = self._make_bias((n_out,))
        oh, ow = _out_hw_2d(h, w, (kh, kw), _pair(self.stride),
                            self.padding, self.convolution_mode)
        return params, {}, (oh, ow, n_out)

    def apply(self, params, state, x, ctx: Ctx):
        x = self._cast_in(x)
        kernel, stride = _pair(self.kernel_size), _pair(self.stride)
        pads = nd_pads(x, kernel, stride, (1, 1), self.padding,
                       self.convolution_mode)
        y = conv_nd(x, params["W"].to(x.dtype), stride, None, pads,
                    groups=x.shape[-1])
        if self.has_bias:
            y = y + params["b"].to(x.dtype)
        return self.activation_fn()(y), state


@dataclass
class SeparableConvolution2D(Layer):
    """Depthwise (dW) then pointwise 1×1 (pW) conv
    (SeparableConvolution2D)."""

    n_in: Optional[int] = None
    n_out: int = 0
    depth_multiplier: int = 1
    kernel_size: Any = (3, 3)
    stride: Any = (1, 1)
    padding: Any = 0
    convolution_mode: str = "same"
    activation: Any = "identity"
    has_bias: bool = True

    def init(self, gen, input_shape):
        h, w, c = input_shape
        c = self.n_in or c
        kh, kw = _pair(self.kernel_size)
        m = self.depth_multiplier
        params = {
            "dW": self._make_weight(gen, (kh, kw, 1, c * m), kh * kw,
                                    kh * kw * m),
            "pW": self._make_weight(gen, (1, 1, c * m, self.n_out), c * m,
                                    self.n_out),
        }
        if self.has_bias:
            params["b"] = self._make_bias((self.n_out,))
        oh, ow = _out_hw_2d(h, w, (kh, kw), _pair(self.stride),
                            self.padding, self.convolution_mode)
        return params, {}, (oh, ow, self.n_out)

    def apply(self, params, state, x, ctx: Ctx):
        x = self._cast_in(x)
        kernel, stride = _pair(self.kernel_size), _pair(self.stride)
        pads = nd_pads(x, kernel, stride, (1, 1), self.padding,
                       self.convolution_mode)
        y = conv_nd(x, params["dW"].to(x.dtype), stride, None, pads,
                    groups=x.shape[-1])
        y = conv_nd(y, params["pW"].to(x.dtype), (1, 1))
        if self.has_bias:
            y = y + params["b"].to(x.dtype)
        return self.activation_fn()(y), state


@dataclass
class Subsampling1DLayer(Layer):
    """1-D pooling over (B, T, C)."""

    kernel_size: int = 2
    stride: int = None
    padding: int = 0
    pooling_type: str = PoolingType.MAX
    convolution_mode: str = "truncate"
    pnorm: int = 2

    def init(self, gen, input_shape):
        t, c = input_shape
        k = self.kernel_size
        s = self.stride or k
        if t is None:
            return {}, {}, (None, c)
        if self.convolution_mode == "same":
            return {}, {}, (-(-t // s), c)
        return {}, {}, ((t + 2 * self.padding - k) // s + 1, c)

    def apply(self, params, state, x, ctx: Ctx):
        k, s = self.kernel_size, self.stride or self.kernel_size
        pads = nd_pads(x, (k,), (s,), (1,), self.padding,
                       self.convolution_mode)
        return _pool_nd(x, (k,), (s,), pads, self.pooling_type,
                        self.pnorm), state

    def has_params(self):
        return False


@dataclass
class Subsampling3DLayer(Layer):
    """3-D pooling (Subsampling3DLayer), NDHWC."""

    kernel_size: Any = (2, 2, 2)
    stride: Any = None
    padding: Any = 0
    pooling_type: str = PoolingType.MAX
    convolution_mode: str = "truncate"
    pnorm: int = 2

    def init(self, gen, input_shape):
        d, h, w, c = input_shape
        kd, kh, kw = _triple(self.kernel_size)
        sd, sh, sw = _triple(self.stride if self.stride is not None
                             else self.kernel_size)
        if self.convolution_mode == "same":
            out = (-(-d // sd), -(-h // sh), -(-w // sw), c)
        else:
            pd, ph, pw = _triple(self.padding)
            out = ((d + 2 * pd - kd) // sd + 1, (h + 2 * ph - kh) // sh + 1,
                   (w + 2 * pw - kw) // sw + 1, c)
        return {}, {}, out

    def apply(self, params, state, x, ctx: Ctx):
        kernel = _triple(self.kernel_size)
        stride = _triple(self.stride if self.stride is not None
                         else self.kernel_size)
        pads = nd_pads(x, kernel, stride, (1, 1, 1), _triple(self.padding),
                       self.convolution_mode)
        return _pool_nd(x, kernel, stride, pads, self.pooling_type,
                        self.pnorm), state

    def has_params(self):
        return False


@dataclass
class Upsampling1D(Layer):
    size: int = 2

    def init(self, gen, input_shape):
        t, c = input_shape
        return {}, {}, (None if t is None else t * self.size, c)

    def apply(self, params, state, x, ctx: Ctx):
        return torch.repeat_interleave(x, self.size, dim=1), state

    def has_params(self):
        return False


@dataclass
class Upsampling2D(Layer):
    size: Any = (2, 2)

    def init(self, gen, input_shape):
        h, w, c = input_shape
        sh, sw = _pair(self.size)
        return {}, {}, (None if h is None else h * sh,
                        None if w is None else w * sw, c)

    def apply(self, params, state, x, ctx: Ctx):
        sh, sw = _pair(self.size)
        y = torch.repeat_interleave(torch.repeat_interleave(x, sh, dim=1),
                                    sw, dim=2)
        return y, state

    def has_params(self):
        return False


@dataclass
class Upsampling3D(Layer):
    size: Any = (2, 2, 2)

    def init(self, gen, input_shape):
        d, h, w, c = input_shape
        sd, sh, sw = _triple(self.size)
        return {}, {}, (d * sd, h * sh, w * sw, c)

    def apply(self, params, state, x, ctx: Ctx):
        for dim, s in zip((1, 2, 3), _triple(self.size)):
            x = torch.repeat_interleave(x, s, dim=dim)
        return x, state

    def has_params(self):
        return False


def _amount_pair(v):
    """int → symmetric pair; else (before, after)."""
    return (v, v) if isinstance(v, int) else tuple(v)


def _amount_triple(v):
    """int / (a, b, c) / ((a0, a1), (b0, b1), (c0, c1)) → 3 (before,
    after) pairs."""
    if isinstance(v, int):
        return ((v, v),) * 3
    if isinstance(v[0], (tuple, list)):
        return tuple(tuple(q) for q in v)
    return tuple((q, q) for q in v)


@dataclass
class Cropping2D(Layer):
    cropping: Any = (1, 1)

    def _crops(self):
        c = self.cropping
        if isinstance(c, int):
            return (c, c), (c, c)
        if isinstance(c[0], (tuple, list)):
            return tuple(c[0]), tuple(c[1])
        return (c[0], c[0]), (c[1], c[1])

    def init(self, gen, input_shape):
        h, w, c = input_shape
        (ct, cb), (cl, cr) = self._crops()
        return {}, {}, (h - ct - cb, w - cl - cr, c)

    def apply(self, params, state, x, ctx: Ctx):
        (ct, cb), (cl, cr) = self._crops()
        return x[:, ct:x.shape[1] - cb, cl:x.shape[2] - cr, :], state

    def has_params(self):
        return False


@dataclass
class Cropping1D(Layer):
    """(B, T, C) sequence cropping."""

    cropping: Any = 1

    def init(self, gen, input_shape):
        t, c = input_shape
        cl, cr = _amount_pair(self.cropping)
        return {}, {}, (t - cl - cr, c)

    def apply(self, params, state, x, ctx: Ctx):
        cl, cr = _amount_pair(self.cropping)
        return x[:, cl:x.shape[1] - cr, :], state

    def has_params(self):
        return False


@dataclass
class Cropping3D(Layer):
    """NDHWC cropping."""

    cropping: Any = 1

    def init(self, gen, input_shape):
        d, h, w, c = input_shape
        (df, db), (ht, hb), (wl, wr) = _amount_triple(self.cropping)
        return {}, {}, (d - df - db, h - ht - hb, w - wl - wr, c)

    def apply(self, params, state, x, ctx: Ctx):
        (df, db), (ht, hb), (wl, wr) = _amount_triple(self.cropping)
        return x[:, df:x.shape[1] - db, ht:x.shape[2] - hb,
                 wl:x.shape[3] - wr, :], state

    def has_params(self):
        return False


@dataclass
class ZeroPadding1DLayer(Layer):
    """(B, T, C) sequence padding."""

    padding: Any = 1  # int or (left, right)

    def init(self, gen, input_shape):
        t, c = input_shape
        lo, hi = _amount_pair(self.padding)
        return {}, {}, (t + lo + hi, c)

    def apply(self, params, state, x, ctx: Ctx):
        return pad_channels_last(x, [_amount_pair(self.padding)]), state

    def has_params(self):
        return False


@dataclass
class ZeroPadding3DLayer(Layer):
    """NDHWC padding."""

    padding: Any = 1

    def init(self, gen, input_shape):
        d, h, w, c = input_shape
        (df, db), (ht, hb), (wl, wr) = _amount_triple(self.padding)
        return {}, {}, (d + df + db, h + ht + hb, w + wl + wr, c)

    def apply(self, params, state, x, ctx: Ctx):
        return pad_channels_last(x, list(_amount_triple(self.padding))), \
            state

    def has_params(self):
        return False


@dataclass
class DepthToSpaceLayer(Layer):
    block_size: int = 2

    def init(self, gen, input_shape):
        h, w, c = input_shape
        b = self.block_size
        return {}, {}, (h * b, w * b, c // (b * b))

    def apply(self, params, state, x, ctx: Ctx):
        n, h, w, c = x.shape
        b = self.block_size
        y = x.reshape(n, h, w, b, b, c // (b * b))
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(n, h * b, w * b,
                                                c // (b * b))
        return y, state

    def has_params(self):
        return False


@dataclass
class LocallyConnected2D(Layer):
    """Per-position filters (no weight sharing): W (oh, ow, kh·kw·C,
    nOut), b (oh, ow, nOut)."""

    n_in: Optional[int] = None
    n_out: int = 0
    kernel_size: Any = (3, 3)
    stride: Any = (1, 1)
    activation: Any = "identity"
    has_bias: bool = True

    def init(self, gen, input_shape):
        h, w, c = input_shape
        c = self.n_in or c
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
        params = {"W": self._make_weight(gen, (oh, ow, kh * kw * c,
                                               self.n_out),
                                         kh * kw * c, self.n_out)}
        if self.has_bias:
            params["b"] = self._make_bias((oh, ow, self.n_out))
        return params, {}, (oh, ow, self.n_out)

    def apply(self, params, state, x, ctx: Ctx):
        n = x.shape[0]
        w = params["W"]
        patches = F.unfold(_nchw(x), _pair(self.kernel_size),
                           stride=_pair(self.stride))
        patches = patches.transpose(1, 2).reshape(n, w.shape[0], w.shape[1],
                                                  -1)
        y = torch.einsum("nhwp,hwpo->nhwo", patches, w.to(x.dtype))
        if self.has_bias:
            y = y + params["b"].to(x.dtype)
        return self.activation_fn()(y), state


@dataclass
class LocallyConnected1D(Layer):
    """Per-step filters over (B, T, C): W (oT, k·C, nOut), b (oT, nOut)."""

    n_in: Optional[int] = None
    n_out: int = 0
    kernel_size: int = 3
    stride: int = 1
    activation: Any = "identity"
    has_bias: bool = True

    def init(self, gen, input_shape):
        t, c = input_shape
        c = self.n_in or c
        k = self.kernel_size
        ot = (t - k) // self.stride + 1
        params = {"W": self._make_weight(gen, (ot, k * c, self.n_out),
                                         k * c, self.n_out)}
        if self.has_bias:
            params["b"] = self._make_bias((ot, self.n_out))
        return params, {}, (ot, self.n_out)

    def apply(self, params, state, x, ctx: Ctx):
        patches = F.unfold(x.transpose(1, 2)[:, :, None],
                           (1, self.kernel_size), stride=(1, self.stride))
        y = torch.einsum("ntp,tpo->nto", patches.transpose(1, 2),
                         params["W"].to(x.dtype))
        if self.has_bias:
            y = y + params["b"].to(x.dtype)
        return self.activation_fn()(y), state
