"""ONNX import (opset-13 core subset and its long tail) → SameDiff graph —
port of ``deeplearning4j_tpu/autodiff/onnx_import.py``.

Reference parity: ``samediff-import-onnx``, which maps ONNX NodeProtos
onto SameDiff ops. The .onnx file is read with the port's protobuf
wire-format reader (``_protowire``; no ``onnx`` package is needed, and
the field numbers are the public onnx.proto3 schema's), and each node
becomes an op of the port's SameDiff whose function is the reference's
handler in plain torch, in the ONNX layouts (NCHW activations, OIHW
kernels).

Covered: Gemm/MatMul, Conv and pooling (1-3 spatial dims), batch and
instance normalization, LRN, Resize/Upsample, the activations,
elementwise and logical ops, shape ops (Reshape, Transpose, Concat,
Split, Slice, Gather, Expand, Tile, Pad ...), reductions, Cast, Where,
LSTM/GRU/TopK (several outputs), scatter/gather (ND and elements), DFT
and the opset-17 long tail. Unknown ops raise with the op name.

Nodes whose inputs are all build-time constants are folded at import, on
the host (torch exports put shapes behind Shape → Gather → Concat
chains), so the ops that need a value at build time — a shape, axes,
sizes — read it from the constant's host copy, never from the card. A
value that is not such a constant raises, as the reference's does under
its trace.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import sd_ops
from ._protowire import Msg
from .samediff import _HOST, SameDiff, SDVariable, set_host_value
from .tf_import import _getitem, _host_tensor, _numpy
from ..nn.layers.conv import same_pads

# onnx.proto3 field numbers (public, fixed):
#   ModelProto.graph = 7
#   GraphProto: node=1 name=2 initializer=5 input=11 output=12
#   NodeProto: input=1 output=2 name=3 op_type=4 attribute=5
#   AttributeProto: name=1 f=2 i=3 s=4 t=5 floats=7 ints=8 strings=9
#   TensorProto: dims=1 data_type=2 float_data=4 int32_data=5
#                int64_data=7 name=8 raw_data=9 double_data=10
#   ValueInfoProto: name=1 type=2 ; TypeProto.tensor_type=1
#   TypeProto.Tensor: elem_type=1 shape=2 ; TensorShapeProto.dim=1
#   TensorShapeProto.Dimension: dim_value=1 dim_param=2

_ONNX_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16,
                5: np.int16, 6: np.int32, 7: np.int64, 9: np.bool_,
                10: np.float16, 11: np.float64, 12: np.uint32, 13: np.uint64}


def _torch_dtype(code):
    """An ONNX element type as the torch dtype the reference computes in
    (64-bit types narrowed to 32, as JAX narrows them)."""
    if code == 16:
        return torch.bfloat16
    return sd_ops.dtype_of(_ONNX_DTYPES.get(code, np.float32))


def _tensor_to_np(t: Msg) -> np.ndarray:
    dims = tuple(t.ints(1))
    dtype_code = t.int(2, 1)
    raw = t.bytes_(9)
    if raw:
        if dtype_code == 16:                  # bfloat16: upcast via uint16
            u16 = np.frombuffer(raw, np.uint16)
            arr = (u16.astype(np.uint32) << 16).view(np.float32)
        else:
            arr = np.frombuffer(raw, _ONNX_DTYPES.get(dtype_code,
                                                      np.float32)).copy()
    elif t.floats(4):
        arr = np.asarray(t.floats(4), np.float32)
    elif t.ints(7):
        arr = np.asarray(t.ints(7), np.int64)
    elif t.ints(5):
        arr = np.asarray(t.ints(5), _ONNX_DTYPES.get(dtype_code, np.int32))
    elif t.doubles(10):
        arr = np.asarray(t.doubles(10), np.float64)
    else:
        arr = np.zeros(0, _ONNX_DTYPES.get(dtype_code, np.float32))
    return arr.reshape(dims) if dims else arr.reshape(())


class OnnxAttr:
    def __init__(self, m: Msg):
        self.name = m.str_(1)
        self.f = m.float(2)
        self.i = m.int(3)
        self.s = m.bytes_(4)
        self.t = m.msg(5)
        self.floats = m.floats(7)
        self.ints = m.ints(8)
        self.strings = m.strs(9)


class OnnxNode:
    def __init__(self, m: Msg):
        self.inputs = m.strs(1)
        self.outputs = m.strs(2)
        self.name = m.str_(3) or (self.outputs[0] if self.outputs else "?")
        self.op_type = m.str_(4)
        self.attrs = {a.name: a for a in (OnnxAttr(x) for x in m.msgs(5))}

    def ai(self, name, default=0):
        a = self.attrs.get(name)
        return a.i if a else default

    def af(self, name, default=0.0):
        a = self.attrs.get(name)
        return a.f if a else default

    def aints(self, name, default=()):
        a = self.attrs.get(name)
        return list(a.ints) if a and a.ints else list(default)

    def astr(self, name, default=""):
        a = self.attrs.get(name)
        return a.s.decode() if a and a.s else default


def _vi_shape(vi: Msg):
    """ValueInfoProto → (name, shape tuple with None for dynamic dims)."""
    name = vi.str_(1)
    tt = vi.msg(2)
    tt = tt.msg(1) if tt else None            # TypeProto.tensor_type
    shape = None
    if tt is not None:
        sh = tt.msg(2)
        if sh is not None:
            shape = tuple(d.int(1, 0) if d.int(1, 0) > 0 else None
                          for d in sh.msgs(1))
    return name, shape


class OnnxGraph:
    def __init__(self, m: Msg):
        self.name = m.str_(2)
        self.nodes = [OnnxNode(x) for x in m.msgs(1)]
        self.initializers: Dict[str, np.ndarray] = {}
        for t in m.msgs(5):
            self.initializers[t.str_(8)] = _tensor_to_np(t)
        self.inputs = [_vi_shape(v) for v in m.msgs(11)]
        self.outputs = [_vi_shape(v)[0] for v in m.msgs(12)]


def parse_onnx(data: bytes) -> OnnxGraph:
    g = Msg(data).msg(7)
    if g is None:
        raise ValueError("not an ONNX ModelProto (no graph field)")
    return OnnxGraph(g)


# ============================================================== op handlers
def _static(v):
    """The value of an op input that must be known at build time (a
    shape, axes, sizes): a constant's host copy. Anything else raises —
    dynamic shape chains are not supported, as in the reference."""
    got = _HOST.get(id(v)) if isinstance(v, torch.Tensor) else None
    if got is None:
        if isinstance(v, torch.Tensor):
            raise NotImplementedError(
                "onnx_import: this op needs a compile-time-constant input, "
                "but got a computed (data-dependent) value — dynamic shape "
                "chains like Shape->Gather->Reshape are not supported; "
                "re-export the model with static shapes")
        return np.asarray(v)
    return got


def _ints(v):
    return np.asarray(_static(v)).astype(np.int64).ravel().tolist()


def _pads_attr(node, rank):
    """pads [b1..bk, e1..ek] → [(b1, e1), ...]."""
    pads = node.aints("pads", [0] * 2 * rank)
    return [(pads[d], pads[d + rank]) for d in range(rank)]


def _pad_spatial(x, pads, value=0.0):
    """``F.pad`` of an NC* tensor's spatial dims by [(lo, hi), ...]."""
    if all(lo == 0 and hi == 0 for lo, hi in pads):
        return x
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(x, flat, value=value)


def _same(x, kernel, strides, dil):
    return [same_pads(x.shape[2 + d], kernel[d], strides[d], dil[d])
            for d in range(len(kernel))]


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _conv(i, n):
    x, w = i[0], i[1]                         # NC*, OI* (onnx layout)
    rank = x.dim() - 2
    strides = n.aints("strides", [1] * rank)
    dil = n.aints("dilations", [1] * rank)
    if n.astr("auto_pad", "NOTSET").startswith("SAME"):
        pads = _same(x, w.shape[2:], strides, dil)
    else:
        pads = _pads_attr(n, rank)
    y = _CONV[rank](_pad_spatial(x, pads), w, stride=strides, dilation=dil,
                    groups=n.ai("group", 1))
    if len(i) > 2 and i[2] is not None:
        y = y + i[2].reshape((1, -1) + (1,) * rank)
    return y


def _pool(i, n, kind):
    x = i[0]
    rank = x.dim() - 2
    if n.ai("ceil_mode", 0):
        raise NotImplementedError(
            "onnx_import: ceil_mode=1 pooling is not supported (floor-mode "
            "pooling would silently change the output shape)")
    if n.aints("dilations", [1] * rank) != [1] * rank:
        raise NotImplementedError("onnx_import: pooling dilations "
                                  "unsupported")
    k = n.aints("kernel_shape")
    strides = n.aints("strides", [1] * rank)
    if n.astr("auto_pad", "NOTSET").startswith("SAME"):
        pads = _same(x, k, strides, [1] * rank)
    else:
        pads = _pads_attr(n, rank)
    if rank == 1:                             # pool (1, T)
        x, k, strides, pads = x[:, :, None], [1] + k, [1] + strides, \
            [(0, 0)] + pads
    avg = F.avg_pool2d if len(k) == 2 else F.avg_pool3d
    if kind == "max":
        mx = F.max_pool2d if len(k) == 2 else F.max_pool3d
        y = mx(_pad_spatial(x, pads, -math.inf), k, strides)
    else:
        y = avg(_pad_spatial(x, pads), k, strides, divisor_override=1)
        if n.ai("count_include_pad", 0) == 0:
            cnt = avg(_pad_spatial(torch.ones_like(x[:1, :1]), pads), k,
                      strides, divisor_override=1)
            y = y / cnt
        else:
            y = y / float(np.prod(k))
    return y[:, :, 0] if rank == 1 else y


def _gemm(i, n):
    a, b = i[0], i[1]
    if n.ai("transA"):
        a = a.T
    if n.ai("transB"):
        b = b.T
    y = n.af("alpha", 1.0) * (a @ b)
    if len(i) > 2 and i[2] is not None:
        y = y + n.af("beta", 1.0) * i[2]
    return y


def _reshape(i, n):
    x, shape = i[0], _ints(i[1])
    out = [x.shape[d] if s == 0 and n.ai("allowzero", 0) == 0 else s
           for d, s in enumerate(shape)]
    return x.reshape(out)


def _slice_op(i, n):
    x = i[0]
    starts, ends = _ints(i[1]), _ints(i[2])
    axes = _ints(i[3]) if len(i) > 3 and i[3] is not None \
        else list(range(len(starts)))
    steps = _ints(i[4]) if len(i) > 4 and i[4] is not None \
        else [1] * len(starts)
    idx = [slice(None)] * x.dim()
    for s, e, a, st in zip(starts, ends, axes, steps):
        # onnx uses INT64_MAX/MIN sentinels for "to the end"
        e = None if abs(e) >= (1 << 62) else e
        idx[a % x.dim()] = slice(s, e, st)
    return _getitem(x, idx)


def _bn(i, n):
    x, gamma, beta, mean, var = i[:5]
    eps = n.af("epsilon", 1e-5)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return ((x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + eps)
            * gamma.reshape(shape) + beta.reshape(shape))


def _dims(x, axes):
    return tuple(range(x.dim())) if axes is None else \
        tuple(a % x.dim() for a in axes)


def _prod(x, dim, keepdim):
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


_REDUCERS = {
    "mean": lambda x, d, k: torch.mean(x, dim=d, keepdim=k),
    "sum": lambda x, d, k: torch.sum(x, dim=d, keepdim=k),
    "max": lambda x, d, k: torch.amax(x, dim=d, keepdim=k),
    "min": lambda x, d, k: torch.amin(x, dim=d, keepdim=k),
    "prod": _prod,
    "l1": lambda x, d, k: torch.sum(torch.abs(x), dim=d, keepdim=k),
    "l2": lambda x, d, k: torch.sqrt(torch.sum(x * x, dim=d, keepdim=k)),
    "sumsquare": lambda x, d, k: torch.sum(x * x, dim=d, keepdim=k),
    "logsumexp": lambda x, d, k: torch.logsumexp(x, dim=d, keepdim=k),
}


def _reduce(kind, axes_as_input=False):
    def h(i, n):
        if axes_as_input and len(i) > 1 and i[1] is not None:
            axes = tuple(_ints(i[1]))
        else:
            axes = tuple(n.aints("axes")) or None
        x = i[0]
        return _REDUCERS[kind](x, _dims(x, axes), bool(n.ai("keepdims", 1)))
    return h


def _edge_index(size, lo, hi, mode, device):
    """Source indices of a dim padded by (lo, hi) in reflect or edge
    mode."""
    j = np.arange(-lo, size + hi)
    if mode == "edge":
        j = np.clip(j, 0, size - 1)
    else:
        period = 2 * (size - 1)
        j = np.abs(j) % period if period else np.zeros_like(j)
        j = np.where(j >= size, period - j, j)
    return torch.as_tensor(j, device=device)


def _pad_op(i, n):
    x = i[0]
    pads = _ints(i[1]) if len(i) > 1 and i[1] is not None \
        else n.aints("pads")
    k = x.dim()
    cfg = [(pads[d], pads[d + k]) for d in range(k)]
    mode = n.astr("mode", "constant")
    if mode == "constant":
        cval = float(np.asarray(_static(i[2])).reshape(())) \
            if len(i) > 2 and i[2] is not None else 0.0
        flat = []
        for lo, hi in reversed(cfg):
            flat += [lo, hi]
        return F.pad(x, flat, value=cval)
    if mode not in ("reflect", "edge"):
        raise KeyError(mode)
    for d, (lo, hi) in enumerate(cfg):
        if lo or hi:
            x = x.index_select(d, _edge_index(x.shape[d], lo, hi, mode,
                                              x.device))
    return x


# -------------------------------------------------------------- resize
def _nearest_index(old, new, device, fn):
    """Source index of each output position along one dim: ``fn`` of the
    float64 coordinate ``i · old / new``, as the reference computes it."""
    src = torch.arange(new, dtype=torch.float64, device=device) * (old / new)
    return torch.clamp(fn(src).long(), 0, old - 1)


_NEAREST_IDX = {
    # ONNX nearest_mode → index of the source coordinate x
    "floor": torch.floor,
    "ceil": torch.ceil,
    "round_prefer_floor": lambda x: torch.ceil(x - 0.5),
    "round_prefer_ceil": lambda x: torch.floor(x + 0.5),
}


def _resize_weights(old, new, kernel):
    """``jax.image.resize``'s (old, new) weight matrix of one dim
    (half-pixel centres, antialiased when shrinking), in float64."""
    scale = new / old
    inv = 1.0 / scale
    kscale = max(inv, 1.0)
    sample = (np.arange(new) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(old)[:, None]) / kscale
    w = kernel(x)
    tot = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(tot) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(tot != 0, tot, 1), 0)
    inside = (sample >= -0.5) & (sample <= old - 0.5)
    return np.where(inside[None, :], w, 0)


def _triangle(x):
    return np.maximum(0.0, 1.0 - x)


def _keys_cubic(x):
    """Keys' cubic with a = -0.5 (``jax.image.resize``'s "cubic")."""
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0,
                   ((1.5 * x - 2.5) * x) * x + 1.0)
    return np.where(x >= 2.0, 0.0, out)


def _resize(i, n):
    """ONNX Resize / Upsample across opsets: Resize-11+ inputs are [X,
    roi?, scales?, sizes?], Resize-10 and Upsample-9 are [X, scales],
    Upsample-7 has a ``scales`` attribute. Nearest (asymmetric with the
    four nearest modes, or half-pixel) and linear/cubic (half-pixel, as
    ``jax.image.resize``)."""
    x = i[0]
    sizes = None
    if len(i) > 3 and i[3] is not None:
        sizes = _ints(i[3])
    else:
        scales = None
        if len(i) > 2 and i[2] is not None and \
                np.size(_static(i[2])):
            scales = np.asarray(_static(i[2])).ravel().tolist()
        elif len(i) == 2 and i[1] is not None and np.size(_static(i[1])):
            scales = np.asarray(_static(i[1])).ravel().tolist()
        elif "scales" in n.attrs:
            scales = list(n.attrs["scales"].floats)
        if scales is not None:
            # spec: output dim = floor(input_dim * scale)
            sizes = [int(np.floor(d * s)) for d, s in zip(x.shape, scales)]
    if sizes is None:
        raise NotImplementedError("Resize needs constant scales or sizes")
    mode = n.astr("mode", "nearest")
    coord = n.astr("coordinate_transformation_mode", "half_pixel")
    if mode == "nearest":
        if coord not in ("asymmetric", "half_pixel"):
            raise NotImplementedError(
                f"Resize nearest with coordinate mode '{coord}'")
        if coord == "asymmetric":
            nearest = n.astr("nearest_mode", "round_prefer_floor")
            if nearest not in _NEAREST_IDX:
                raise NotImplementedError(f"nearest_mode '{nearest}'")
        out = x
        for ax, (old, new) in enumerate(zip(x.shape, sizes)):
            if new == old:
                continue
            if coord == "asymmetric":
                ix = _nearest_index(old, new, x.device,
                                    _NEAREST_IDX[nearest])
            else:  # jax.image.resize "nearest": floor((i + 0.5) · old/new)
                ix = torch.floor((torch.arange(new, dtype=torch.float64,
                                               device=x.device) + 0.5)
                                 * old / new).long()
            out = out.index_select(ax, ix)
        return out
    if mode in ("linear", "cubic"):
        if coord not in ("half_pixel", "pytorch_half_pixel"):
            raise NotImplementedError(
                f"Resize {mode} with coordinate mode '{coord}'")
        kernel = _triangle if mode == "linear" else _keys_cubic
        y = x.float()
        for ax, (old, new) in enumerate(zip(x.shape, sizes)):
            if new == old:
                continue
            w = torch.as_tensor(_resize_weights(old, new, kernel),
                                dtype=torch.float32, device=x.device)
            y = torch.tensordot(y, w, dims=([ax], [0])).movedim(-1, ax)
        return y.to(x.dtype)
    raise NotImplementedError(f"Resize mode '{mode}'")


# -------------------------------------------------------------- others
def _variadic(fn, vals):
    out = vals[0]
    for v in vals[1:]:
        out = fn(out, v)
    return out


def _argminmax(fn, i, n):
    axis = n.ai("axis", 0)
    out = fn(i[0], dim=axis, keepdim=bool(n.ai("keepdims", 1)))
    return out.to(torch.int32)


def _unsqueeze(x, axes):
    # negative axes are relative to the OUTPUT rank (input rank + len(axes))
    out_rank = x.dim() + len(axes)
    for a in sorted(int(a) % out_rank for a in axes):
        x = x.unsqueeze(a)
    return x


def _squeeze(x, axes):
    if axes is None:
        return x.squeeze()
    for a in sorted((a % x.dim() for a in axes), reverse=True):
        x = x.squeeze(a)
    return x


def _gather(x, idx, axis):
    """``jnp.take``: out[.., idx, ..] with negative indices wrapped."""
    axis %= x.dim()
    idx = idx.long()
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    out = x.index_select(axis, idx.reshape(-1))
    return out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                       + tuple(x.shape[axis + 1:]))


def _lrn(i, n):
    x = i[0]
    size, alpha = n.ai("size", 5), n.af("alpha", 1e-4)
    beta, bias = n.af("beta", 0.75), n.af("bias", 1.0)
    half = size // 2
    sq = F.pad(x * x, (0, 0, 0, 0, half, size - 1 - half))
    acc = sum(sq[:, j:j + x.shape[1]] for j in range(size))
    return x / torch.pow(bias + alpha / size * acc, beta)


def _instance_norm(i, n):
    x, gamma, beta = i[:3]
    eps = n.af("epsilon", 1e-5)
    ax = tuple(range(2, x.dim()))
    mu = x.mean(dim=ax, keepdim=True)
    var = x.var(dim=ax, keepdim=True, unbiased=False)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return (x - mu) * torch.rsqrt(var + eps) * gamma.reshape(shape) \
        + beta.reshape(shape)


def _onnx_dft(i, n):
    """ONNX DFT (opset-17 attributes): input (..., 1|2) with a trailing
    real/imag dim, optional dft_length; axis, inverse and onesided.
    The output keeps the trailing complex-pair dim."""
    x = i[0]
    axis = n.ai("axis", 1)
    if axis < 0:
        # the ONNX axis counts the trailing real/imag dim, which the
        # complex view drops
        axis += x.dim()
    dft_len = None if len(i) < 2 or i[1] is None \
        else int(np.asarray(_static(i[1])).reshape(()))
    if x.shape[-1] == 2:
        xc = torch.complex(x[..., 0], x[..., 1])
    else:
        xc = x[..., 0].to(torch.complex64)
    if n.ai("inverse", 0):
        y = torch.fft.ifft(xc, n=dft_len, dim=axis)
    elif n.ai("onesided", 0):
        y = torch.fft.rfft(xc.real, n=dft_len, dim=axis)
    else:
        y = torch.fft.fft(xc, n=dft_len, dim=axis)
    return torch.stack([y.real, y.imag], dim=-1)


def _onnx_cumsum(x, axis, exclusive, reverse):
    if reverse:
        x = torch.flip(x, (axis,))
    out = torch.cumsum(x, dim=axis)
    if exclusive:
        out = out - x           # shift: exclusive prefix sum
    if reverse:
        out = torch.flip(out, (axis,))
    return out


def _onnx_gather_nd(params, indices):
    return sd_ops._gather_nd(params, indices)


def _onnx_scatter_nd(data, indices, updates):
    idx = indices.long()
    return data.index_put(tuple(idx[..., k] for k in range(idx.shape[-1])),
                          updates)


def _onnx_scatter_elements(data, indices, updates, axis):
    return torch.scatter(data, axis, indices.long(), updates)


def _onnx_one_hot(i, n):
    indices, values = i[0], i[2]
    depth = int(np.asarray(_static(i[1])).reshape(()))
    axis = n.ai("axis", -1)
    off, on = values[0], values[1]
    idx = indices.long()
    idx = torch.where(idx < 0, idx + depth, idx)   # negatives wrap
    oh = (idx[..., None] == torch.arange(depth, device=idx.device)).float()
    oh = oh.movedim(-1, axis % oh.dim())
    return oh * (on - off) + off


def _space_to_depth_nchw(x, bs):
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // bs, bs, w // bs, bs)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(b, c * bs * bs, h // bs,
                                               w // bs)


def _depth_to_space_nchw(x, bs, mode="DCR"):
    b, c, h, w = x.shape
    if mode == "DCR":
        x = x.reshape(b, bs, bs, c // (bs * bs), h, w)
        x = x.permute(0, 3, 4, 1, 5, 2)
    else:  # CRD
        x = x.reshape(b, c // (bs * bs), bs, bs, h, w)
        x = x.permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, c // (bs * bs), h * bs, w * bs)


def _expand(x, shape):
    return x.expand(np.broadcast_shapes(tuple(shape), tuple(x.shape)))


def _full(shape, value):
    """``jnp.full`` of a Python scalar: float32 or int32."""
    arr = np.full(tuple(shape), value)
    return sd_ops._t(arr)


HANDLERS: Dict[str, Any] = {
    "Resize": _resize,
    "Upsample": _resize,   # opset<10 alias (scales input or attribute)
    # --- elementwise math
    "Add": lambda i, n: i[0] + i[1], "Sub": lambda i, n: i[0] - i[1],
    "Mul": lambda i, n: i[0] * i[1], "Div": lambda i, n: i[0] / i[1],
    "Pow": lambda i, n: torch.pow(i[0], i[1]),
    "Neg": lambda i, n: -i[0], "Abs": lambda i, n: torch.abs(i[0]),
    "Exp": lambda i, n: torch.exp(i[0]), "Log": lambda i, n: torch.log(i[0]),
    "Sqrt": lambda i, n: torch.sqrt(i[0]),
    "Reciprocal": lambda i, n: 1.0 / i[0],
    "Floor": lambda i, n: torch.floor(i[0]),
    "Ceil": lambda i, n: torch.ceil(i[0]),
    "Round": lambda i, n: torch.round(i[0]),
    "Sign": lambda i, n: torch.sign(i[0]),
    "Erf": lambda i, n: torch.erf(i[0]),
    "Min": lambda i, n: _variadic(torch.minimum, i),
    "Max": lambda i, n: _variadic(torch.maximum, i),
    "Sum": lambda i, n: sum(i),
    "Clip": lambda i, n: i[0] if (len(i) < 2 or i[1] is None) and (
        len(i) < 3 or i[2] is None) else torch.clamp(
        i[0], None if len(i) < 2 or i[1] is None else i[1],
        None if len(i) < 3 or i[2] is None else i[2]),
    # --- activations
    "Relu": lambda i, n: torch.relu(i[0]),
    "LeakyRelu": lambda i, n: F.leaky_relu(i[0], n.af("alpha", 0.01)),
    "Elu": lambda i, n: F.elu(i[0], n.af("alpha", 1.0)),
    "Selu": lambda i, n: F.selu(i[0]),
    "Celu": lambda i, n: F.celu(i[0], n.af("alpha", 1.0)),
    "Sigmoid": lambda i, n: torch.sigmoid(i[0]),
    "HardSigmoid": lambda i, n: torch.clamp(
        n.af("alpha", 0.2) * i[0] + n.af("beta", 0.5), 0, 1),
    "Tanh": lambda i, n: torch.tanh(i[0]),
    "Softmax": lambda i, n: torch.softmax(i[0], dim=n.ai("axis", -1)),
    "LogSoftmax": lambda i, n: torch.log_softmax(i[0], dim=n.ai("axis", -1)),
    "Softplus": lambda i, n: F.softplus(i[0]),
    "Softsign": lambda i, n: F.softsign(i[0]),
    "Gelu": lambda i, n: F.gelu(i[0], approximate=(
        "tanh" if n.astr("approximate", "none") == "tanh" else "none")),
    "PRelu": lambda i, n: torch.where(i[0] >= 0, i[0], i[0] * i[1]),
    "Dropout": lambda i, n: i[0],             # inference: identity
    "Identity": lambda i, n: i[0],
    # --- matmul family
    "MatMul": lambda i, n: torch.matmul(i[0], i[1]),
    "Gemm": _gemm,
    # --- conv/pool/norm (NCHW)
    "Conv": _conv,
    "MaxPool": lambda i, n: _pool(i, n, "max"),
    "AveragePool": lambda i, n: _pool(i, n, "avg"),
    "GlobalAveragePool": lambda i, n: torch.mean(
        i[0], dim=tuple(range(2, i[0].dim())), keepdim=True),
    "GlobalMaxPool": lambda i, n: torch.amax(
        i[0], dim=tuple(range(2, i[0].dim())), keepdim=True),
    "BatchNormalization": _bn,
    "LRN": _lrn,
    "InstanceNormalization": _instance_norm,
    # --- shape ops
    "Reshape": _reshape,
    "Flatten": lambda i, n: i[0].reshape(
        (int(np.prod(i[0].shape[:n.ai("axis", 1)])) or 1, -1)),
    "Transpose": lambda i, n: i[0].permute(
        n.aints("perm") or tuple(reversed(range(i[0].dim())))),
    "Squeeze": lambda i, n: _squeeze(
        i[0], _ints(i[1]) if len(i) > 1 and i[1] is not None else None),
    "Unsqueeze": lambda i, n: _unsqueeze(
        i[0], _ints(i[1]) if len(i) > 1 else n.aints("axes")),
    "Concat": lambda i, n: torch.cat(i, dim=n.ai("axis", 0)),
    "Split": None,                            # handled specially
    "Slice": _slice_op,
    "Gather": lambda i, n: _gather(i[0], i[1], n.ai("axis", 0)),
    "GatherElements": lambda i, n: torch.gather(
        i[0], n.ai("axis", 0), i[1].long()),
    "Expand": lambda i, n: _expand(i[0], _ints(i[1])),
    "Tile": lambda i, n: torch.tile(i[0], tuple(_ints(i[1]))),
    "Shape": lambda i, n: sd_ops._t(np.asarray(i[0].shape, np.int64)),
    "Size": lambda i, n: sd_ops._t(np.asarray(i[0].numel(), np.int64)),
    "Pad": _pad_op,
    "Cast": lambda i, n: i[0].to(_torch_dtype(n.ai("to", 1))),
    "Where": lambda i, n: torch.where(i[0].bool(), i[1], i[2]),
    "Equal": lambda i, n: i[0] == i[1],
    "Greater": lambda i, n: i[0] > i[1],
    "GreaterOrEqual": lambda i, n: i[0] >= i[1],
    "Less": lambda i, n: i[0] < i[1],
    "LessOrEqual": lambda i, n: i[0] <= i[1],
    "Not": lambda i, n: ~i[0],
    "And": lambda i, n: i[0] & i[1],
    "Or": lambda i, n: i[0] | i[1],
    # --- reductions
    "ReduceMean": _reduce("mean"),
    "ReduceSum": _reduce("sum", axes_as_input=True),
    "ReduceMax": _reduce("max"),
    "ReduceMin": _reduce("min"),
    "ReduceProd": _reduce("prod"),
    "ReduceL2": _reduce("l2"),
    "ArgMax": lambda i, n: _argminmax(torch.argmax, i, n),
    "ArgMin": lambda i, n: _argminmax(torch.argmin, i, n),
    "ConstantOfShape": lambda i, n: _full(
        _ints(i[0]), _tensor_to_np(n.attrs["value"].t).item()
        if "value" in n.attrs else 0.0),
    "Range": lambda i, n: sd_ops._t(np.arange(
        np.asarray(_static(i[0])).item(), np.asarray(_static(i[1])).item(),
        np.asarray(_static(i[2])).item())),
    # --- opset-13 long tail
    "Einsum": lambda i, n: torch.einsum(n.astr("equation"), *i),
    "CumSum": lambda i, n: _onnx_cumsum(
        i[0], int(np.asarray(_static(i[1])).reshape(())),
        n.ai("exclusive", 0), n.ai("reverse", 0)),
    "Mod": lambda i, n: (torch.fmod(i[0], i[1]) if n.ai("fmod", 0)
                         else torch.remainder(i[0], i[1])),
    "Trilu": lambda i, n: (torch.triu if n.ai("upper", 1) else torch.tril)(
        i[0], int(np.asarray(_static(i[1])).reshape(()))
        if len(i) > 1 and i[1] is not None else 0),
    "HardSwish": lambda i, n: F.hardswish(i[0]),
    "Mish": lambda i, n: F.mish(i[0]),
    "Xor": lambda i, n: i[0] ^ i[1],
    "BitShift": lambda i, n: (torch.bitwise_left_shift(i[0], i[1])
                              if n.astr("direction") == "LEFT"
                              else torch.bitwise_right_shift(i[0], i[1])),
    "GatherND": lambda i, n: _onnx_gather_nd(i[0], i[1]),
    "ScatterND": lambda i, n: _onnx_scatter_nd(i[0], i[1], i[2]),
    "ScatterElements": lambda i, n: _onnx_scatter_elements(
        i[0], i[1], i[2], n.ai("axis", 0)),
    "OneHot": _onnx_one_hot,
    "DepthToSpace": lambda i, n: _depth_to_space_nchw(
        i[0], n.ai("blocksize", 2), n.astr("mode", "DCR")),
    "SpaceToDepth": lambda i, n: _space_to_depth_nchw(
        i[0], n.ai("blocksize", 2)),
    "ReduceL1": _reduce("l1"),
    "ReduceSumSquare": _reduce("sumsquare"),
    "ReduceLogSumExp": _reduce("logsumexp"),
    "IsNaN": lambda i, n: torch.isnan(i[0]),
    "IsInf": lambda i, n: torch.isinf(i[0]),
    # --- opset-17/18 long tail
    "DFT": _onnx_dft,
    "Shrink": lambda i, n: torch.where(
        i[0] > n.af("lambd", 0.5), i[0] - n.af("bias", 0.0),
        torch.where(i[0] < -n.af("lambd", 0.5), i[0] + n.af("bias", 0.0),
                    torch.zeros_like(i[0]))),
    "ThresholdedRelu": lambda i, n: torch.where(
        i[0] > n.af("alpha", 1.0), i[0], torch.zeros_like(i[0])),
    "MeanVarianceNormalization": lambda i, n: (
        (i[0] - torch.mean(i[0], dim=tuple(n.aints("axes", (0, 2, 3))),
                           keepdim=True))
        / torch.sqrt(torch.var(i[0], dim=tuple(n.aints("axes", (0, 2, 3))),
                               keepdim=True, unbiased=False) + 1e-9)),
    "Det": lambda i, n: torch.linalg.det(i[0]),
}


# ----------------------------------------------------------- RNN ops
# ONNX gate orders: LSTM iofc, GRU zrh; weights [num_dir, gates·hidden,
# in]. A loop over time; bidirectional runs a reversed second pass.
def _rnn_unsupported(n, kind, peephole=None):
    """Reject inputs and attributes that would silently miscompute."""
    acts = n.attrs.get("activations")
    defaults = {"LSTM": ["Sigmoid", "Tanh", "Tanh"],
                "GRU": ["Sigmoid", "Tanh"]}[kind]
    if acts and acts.strings not in ([], defaults, defaults * 2):
        raise NotImplementedError(
            f"ONNX {kind}: non-default activations {acts.strings}")
    if n.af("clip", 0.0):
        raise NotImplementedError(f"ONNX {kind}: cell clip not supported")
    if peephole is not None:
        raise NotImplementedError("ONNX LSTM: peephole weights (P) not "
                                  "supported")


def _opt(i, k):
    return i[k] if len(i) > k and i[k] is not None else None


def _run_time(cell, carry, xs, reverse):
    ys = []
    steps = range(xs.shape[0] - 1, -1, -1) if reverse \
        else range(xs.shape[0])
    for t in steps:
        carry, y = cell(carry, xs[t])
        ys.append(y)
    if reverse:
        ys = ys[::-1]
    return carry, torch.stack(ys)


def _onnx_lstm(i, n):
    X, W, R, B = i[0], i[1], i[2], _opt(i, 3)
    if _opt(i, 4) is not None:
        raise NotImplementedError(
            "ONNX LSTM: per-example sequence_lens not supported (pad-free "
            "batches only) — would silently miscompute padded examples")
    h0, c0 = _opt(i, 5), _opt(i, 6)
    _rnn_unsupported(n, "LSTM", peephole=_opt(i, 7))
    hidden = R.shape[-1]
    direction = n.astr("direction", "forward")

    def run(d, reverse):
        w, r = W[d].T, R[d].T                        # [in, 4h], [h, 4h]
        b = (B[d][:4 * hidden] + B[d][4 * hidden:]) if B is not None \
            else 0.0
        zero = X.new_zeros((X.shape[1], hidden))
        hi = h0[d] if h0 is not None else zero
        ci = c0[d] if c0 is not None else zero

        def cell(carry, xt):
            h, c = carry
            z = xt @ w + h @ r + b
            zi, zo, zf, zg = torch.chunk(z, 4, dim=-1)   # iofc
            c2 = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zg)
            h2 = torch.sigmoid(zo) * torch.tanh(c2)
            return (h2, c2), h2

        (h_t, c_t), ys = _run_time(cell, (hi, ci), X, reverse)
        return ys, h_t, c_t

    dirs = [run(0, direction == "reverse")]
    if W.shape[0] == 2:
        dirs.append(run(1, True))
    return (torch.stack([d[0] for d in dirs], dim=1),   # [seq, dir, B, h]
            torch.stack([d[1] for d in dirs], dim=0),
            torch.stack([d[2] for d in dirs], dim=0))


def _onnx_gru(i, n):
    X, W, R, B = i[0], i[1], i[2], _opt(i, 3)
    if _opt(i, 4) is not None:
        raise NotImplementedError(
            "ONNX GRU: per-example sequence_lens not supported")
    h0 = _opt(i, 5)
    _rnn_unsupported(n, "GRU")
    hidden = R.shape[-1]
    direction = n.astr("direction", "forward")
    lbr = n.ai("linear_before_reset", 0)

    def run(d, reverse):
        w, r = W[d].T, R[d].T                        # [in, 3h], [h, 3h]
        wb = B[d][:3 * hidden] if B is not None else X.new_zeros(3 * hidden)
        rb = B[d][3 * hidden:] if B is not None else X.new_zeros(3 * hidden)
        hi = h0[d] if h0 is not None else X.new_zeros((X.shape[1], hidden))

        def cell(h, xt):
            xz = xt @ w + wb
            hz = h @ r
            z = torch.sigmoid(xz[..., :hidden] + hz[..., :hidden]
                              + rb[:hidden])
            rr = torch.sigmoid(xz[..., hidden:2 * hidden]
                               + hz[..., hidden:2 * hidden]
                               + rb[hidden:2 * hidden])
            if lbr:
                nh = torch.tanh(xz[..., 2 * hidden:]
                                + rr * (hz[..., 2 * hidden:]
                                        + rb[2 * hidden:]))
            else:
                nh = torch.tanh(xz[..., 2 * hidden:]
                                + (rr * h) @ r[:, 2 * hidden:]
                                + rb[2 * hidden:])
            h2 = (1 - z) * nh + z * h
            return h2, h2

        h_t, ys = _run_time(cell, hi, X, reverse)
        return ys, h_t

    dirs = [run(0, direction == "reverse")]
    if W.shape[0] == 2:
        dirs.append(run(1, True))
    return (torch.stack([d[0] for d in dirs], dim=1),
            torch.stack([d[1] for d in dirs], dim=0))


def _onnx_topk(i, n):
    k = int(np.asarray(_static(i[1])).reshape(-1)[0])
    axis = n.ai("axis", -1)
    largest = n.ai("largest", 1)
    x = i[0] if largest else -i[0]
    vals, idxs = torch.topk(x, k, dim=axis, largest=True, sorted=True)
    if not largest:
        vals = -vals
    return vals, idxs.to(torch.int32)


MULTI_OUTPUT = {
    "LSTM": _onnx_lstm,
    "GRU": _onnx_gru,
    "TopK": _onnx_topk,
}


# ================================================================= importer
def _with_slots(handler, node, present):
    """``fn(*present_values)`` calling ``handler(full, node)``, where an
    empty input name ('' — a skipped optional input) keeps its slot as
    None so later inputs do not shift."""
    def fn(*vals):
        it = iter(vals)
        return handler([next(it) if m else None for m in present], node)
    return fn


class OnnxImporter:
    def import_graph(self, graph: OnnxGraph,
                     sd: Optional[SameDiff] = None,
                     device=None) -> SameDiff:
        sd = sd or SameDiff.create(device=device)
        produced: Dict[str, SDVariable] = {}
        const_np: Dict[str, np.ndarray] = {}   # values known at build time
        consumed = {name for node in graph.nodes for name in node.inputs}

        def constant(name, arr, suffix=""):
            v = sd.constant(_safe(name) + suffix, np.asarray(arr))
            if suffix:
                v.rename(_safe(name))
            produced[name] = v
            const_np[name] = np.asarray(arr)

        for name, arr in graph.initializers.items():
            constant(name, arr)
        for name, shape in graph.inputs:
            if name not in produced:          # real inputs only
                produced[name] = sd.placeholder(_safe(name), shape)

        for node in graph.nodes:
            op = node.op_type
            if op == "Constant":
                constant(node.outputs[0], self._constant_value(node))
                continue
            if op == "Split":
                self._split(sd, node, produced, const_np)
                continue
            # ---- build-time constant folding (torch exports put shapes
            # behind Shape → Gather → Concat → ConstantOfShape chains)
            if op == "Shape" and node.inputs[0] in produced:
                src = produced[node.inputs[0]]
                shp = const_np[node.inputs[0]].shape \
                    if node.inputs[0] in const_np else src.shape
                if shp is not None and all(
                        isinstance(d, int) and d >= 0 for d in shp):
                    constant(node.outputs[0], np.asarray(shp, np.int64),
                             "_shape")
                    continue
            if (HANDLERS.get(op) is not None and node.inputs
                    and len(node.outputs) == 1
                    and all((not x) or x in const_np for x in node.inputs)):
                vals = [_host_tensor(const_np[x]) if x else None
                        for x in node.inputs]
                try:
                    folded = _numpy(HANDLERS[op](vals, node))
                except Exception:
                    folded = None
                if folded is not None:
                    constant(node.outputs[0], folded, "_folded")
                    continue
            present = tuple(bool(x) for x in node.inputs)
            ins = [produced[x] for x in node.inputs if x]
            if op in MULTI_OUTPUT:
                tup = sd._op(_safe(node.outputs[0]) + "_tuple",
                             _with_slots(MULTI_OUTPUT[op], node, present),
                             ins)
                for j, out_name in enumerate(node.outputs):
                    if not out_name:          # optional output, unused
                        continue
                    view = sd._op(_safe(out_name) + "_op",
                                  (lambda jj: lambda t: t[jj])(j), [tup])
                    view.rename(_safe(out_name))
                    produced[out_name] = view
                continue
            handler = HANDLERS.get(op)
            if handler is None:
                raise NotImplementedError(
                    f"ONNX op '{op}' (node '{node.name}') not mapped; "
                    f"supported: {sorted(k for k, v in HANDLERS.items() if v)}")
            # secondary outputs (e.g. Dropout's mask) must not be consumed
            for extra in node.outputs[1:]:
                if extra in consumed:
                    raise NotImplementedError(
                        f"secondary output '{extra}' of op '{op}' is "
                        "consumed downstream — not supported")
            v = sd._op(_safe(node.outputs[0]) + "_op",
                       _with_slots(handler, node, present), ins)
            v.rename(_safe(node.outputs[0]))
            produced[node.outputs[0]] = v
        self.produced = produced
        return sd

    @staticmethod
    def _constant_value(node):
        a = node.attrs
        if "value" in a:
            return _tensor_to_np(a["value"].t)
        if "value_float" in a:
            return np.float32(a["value_float"].f)
        if "value_int" in a:
            return np.int64(a["value_int"].i)
        if "value_ints" in a:
            return np.asarray(a["value_ints"].ints, np.int64)
        if "value_floats" in a:
            return np.asarray(a["value_floats"].floats, np.float32)
        raise NotImplementedError("Constant without value attr")

    @staticmethod
    def _split(sd, node, produced, const_np):
        x = produced[node.inputs[0]]
        axis = node.ai("axis", 0)
        if len(node.inputs) > 1 and node.inputs[1]:
            name = node.inputs[1]
            if name not in const_np:
                raise NotImplementedError(
                    f"Split sizes '{name}' must be a build-time constant "
                    "(initializer or Constant node)")
            sizes = const_np[name].astype(int).ravel().tolist()
        else:
            sizes = node.aints("split") or None
        count = len(node.outputs)

        def part(j):
            def fn(xv):
                if sizes:
                    return torch.split(xv, sizes, dim=axis)[j]
                return torch.chunk(xv, count, dim=axis)[j]
            return fn

        for j, out_name in enumerate(node.outputs):
            v = sd._op(_safe(out_name) + "_op", part(j), [x])
            v.rename(_safe(out_name))
            produced[out_name] = v


def _safe(name: str) -> str:
    return name.replace("/", "_").replace(":", "_").replace(".", "_")


def import_onnx(path_or_bytes, sd: Optional[SameDiff] = None, device=None):
    """Load an .onnx file (a path or its bytes) → (SameDiff, [output
    SDVariables]), on ``device`` (None → CUDA) unless ``sd`` is given.
    Feed the graph with ``sd.eval(outputs[0], {input_name: array})``;
    input names have '/', ':' and '.' replaced by '_'."""
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    graph = parse_onnx(data)
    imp = OnnxImporter()
    sd = imp.import_graph(graph, sd, device=device)
    return sd, [imp.produced[o] for o in graph.outputs]
