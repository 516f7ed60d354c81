"""ND4J factory — port of ``deeplearning4j_tpu/ndarray/factory.py``
(``org.nd4j.linalg.factory.Nd4j`` and the ``INDArray`` method surface:
creation, arithmetic, reductions, shape ops, transforms, sorting,
gather/scatter, linalg, conv primitives).

Arrays are plain ``torch.Tensor``s, no wrapper object; the DL4J method
names are module functions, so ``a.mmul(b)`` reads ``nd.mmul(a, b)``.

- Creation takes ``device=``; ``None`` means the CUDA card
  (``_device.resolve_device``), only an explicit ``"cpu"`` runs on the
  host. Creation functions without a ``dtype`` use :func:`default_dtype`
  (float32 unless :func:`set_default_dtype` changed it), as the
  reference's do.
- The other functions take tensors and run where the tensors live. A
  numpy array or a Python value handed to one becomes a host tensor with
  the reference's 32-bit dtypes (JAX's default: float64 → float32,
  int64 → int32).
- Layouts are the reference's: ``conv2d`` takes NHWC inputs and HWIO
  kernels, the pools and ``im2col`` NHWC.
- ``unique(size=, fill_value=)`` keeps JAX's fixed output size (graphs
  need static shapes): it runs on the device with no host read.
"""

from __future__ import annotations

import builtins

import numpy as _np
import torch
import torch.nn.functional as F

from .._device import resolve_device

# ---------------------------------------------------------------------------
# dtypes
# ---------------------------------------------------------------------------
bfloat16 = torch.bfloat16
float16 = torch.float16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
bool_ = torch.bool

_DEFAULT_DTYPE = torch.float32
_NP_TO_TORCH = {_np.dtype(k): v for k, v in (
    ("float16", torch.float16), ("float32", torch.float32),
    ("float64", torch.float64), ("int8", torch.int8),
    ("int16", torch.int16), ("int32", torch.int32), ("int64", torch.int64),
    ("uint8", torch.uint8), ("bool", torch.bool))}


def _as_dtype(dtype):
    """A torch dtype from a torch dtype, a numpy dtype or its name."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype in ("bfloat16", "bf16"):
        return torch.bfloat16
    return _NP_TO_TORCH[_np.dtype(dtype)]


def set_default_dtype(dtype) -> None:
    """The dtype creation functions use without an explicit one."""
    global _DEFAULT_DTYPE
    _DEFAULT_DTYPE = _as_dtype(dtype)


def default_dtype():
    return _DEFAULT_DTYPE


def _dt(dtype):
    return _DEFAULT_DTYPE if dtype is None else _as_dtype(dtype)


_CANON = {torch.float64: torch.float32, torch.int64: torch.int32}


def _t(a):
    """A tensor as it is; anything else as a host tensor in the
    reference's 32-bit dtypes."""
    if isinstance(a, torch.Tensor):
        return a
    t = torch.as_tensor(_np.array(a))
    return t.to(_CANON[t.dtype]) if t.dtype in _CANON else t


def _shape(shape):
    return tuple(shape[0]) if len(shape) == 1 and isinstance(
        shape[0], (tuple, list)) else tuple(shape)


def _axes(axis, ndim):
    """A reduction's dims: None → every dim, an int or a tuple as given."""
    if axis is None:
        return tuple(range(ndim))
    return (axis,) if isinstance(axis, int) else tuple(axis)


# ---------------------------------------------------------------------------
# Creation (Nd4j.create / zeros / ones / ...)
# ---------------------------------------------------------------------------

def create(data, dtype=None, device=None):
    """Nd4j.create: a tensor on ``device`` from nested lists, numpy or a
    tensor; without a ``dtype`` the reference's 32-bit dtypes."""
    dev = resolve_device(device)
    if isinstance(data, torch.Tensor):
        t = data
    else:
        t = _t(data)
    return t.to(device=dev, dtype=_as_dtype(dtype) or t.dtype)


asarray = create


def zeros(*shape, dtype=None, device=None):
    return torch.zeros(_shape(shape), dtype=_dt(dtype),
                       device=resolve_device(device))


def ones(*shape, dtype=None, device=None):
    return torch.ones(_shape(shape), dtype=_dt(dtype),
                      device=resolve_device(device))


def full(shape, value, dtype=None, device=None):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return torch.full(shape, value, dtype=_dt(dtype),
                      device=resolve_device(device))


def value_array_of(shape, value, dtype=None, device=None):  # Nd4j.valueArrayOf
    return full(shape, value, dtype, device)


def empty(shape, dtype=None, device=None):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return torch.empty(shape, dtype=_dt(dtype), device=resolve_device(device))


def zeros_like(a):
    return torch.zeros_like(_t(a))


def ones_like(a):
    return torch.ones_like(_t(a))


def eye(n, m=None, dtype=None, device=None):
    return torch.eye(n, n if m is None else m, dtype=_dt(dtype),
                     device=resolve_device(device))


def arange(*args, dtype=None, device=None):
    """numpy's arange; integer arguments give int32, as the reference."""
    if dtype is None:
        dtype = torch.int32 if builtins.all(
            isinstance(a, (int, _np.integer)) for a in args) else _DEFAULT_DTYPE
    return torch.arange(*args, dtype=_as_dtype(dtype),
                        device=resolve_device(device))


def linspace(start, stop, num, dtype=None, device=None):
    return torch.linspace(start, stop, num, dtype=_dt(dtype),
                          device=resolve_device(device))


def scalar(value, dtype=None, device=None):
    return create(value, dtype, device)


def diag(v, k=0):
    return torch.diag(_t(v), k)


def meshgrid(*arrays, indexing="ij"):
    return list(torch.meshgrid(*(_t(a) for a in arrays), indexing=indexing))


def tri(n, m=None, k=0, dtype=None, device=None):
    m = n if m is None else m
    return torch.tril(torch.ones((n, m), dtype=_dt(dtype),
                                 device=resolve_device(device)), k)


def one_hot(indices, depth, dtype=None, axis=-1):
    idx = _t(indices).long()
    out = (idx.unsqueeze(-1) == torch.arange(depth, device=idx.device)
           ).to(_dt(dtype))
    return out if axis in (-1, out.dim() - 1) else torch.movedim(out, -1, axis)


# ---------------------------------------------------------------------------
# Arithmetic / linear algebra (INDArray.mmul / tensorMmul / dot ...)
# ---------------------------------------------------------------------------

def mmul(a, b):
    """Matrix multiply (INDArray.mmul)."""
    return torch.matmul(_t(a), _t(b))


matmul = mmul


def dot(a, b):
    a, b = _t(a), _t(b)
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    if b.dim() == 1 or a.dim() == 1:
        return torch.matmul(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [b.dim() - 2]))


def tensor_mmul(a, b, axes):
    """INDArray.tensorMmul: tensordot over the given axes."""
    if isinstance(axes, int):
        return torch.tensordot(_t(a), _t(b), dims=axes)
    return torch.tensordot(_t(a), _t(b), dims=(list(axes[0]), list(axes[1])))


def einsum(subscripts, *operands, precision=None):
    return torch.einsum(subscripts, *(_t(o) for o in operands))


def outer(a, b):
    return torch.outer(_t(a).reshape(-1), _t(b).reshape(-1))


def kron(a, b):
    return torch.kron(_t(a), _t(b))


def batch_mmul(a, b):
    return torch.einsum("bij,bjk->bik", _t(a), _t(b))


def _binary(fn):
    def op(a, b):
        return fn(_t(a) if not isinstance(a, (int, float)) else a,
                  _t(b) if not isinstance(b, (int, float)) else b)
    op.__name__ = getattr(fn, "__name__", "op")
    return op


def _unary(fn):
    def op(a):
        return fn(_t(a))
    op.__name__ = getattr(fn, "__name__", "op")
    return op


add = _binary(torch.add)
sub = _binary(torch.subtract)
mul = _binary(torch.multiply)
div = _binary(torch.true_divide)
rdiv = _binary(lambda a, b: torch.true_divide(b, a))
rsub = _binary(lambda a, b: torch.subtract(b, a))
pow = _binary(torch.pow)
mod = _binary(torch.remainder)
floor_div = _binary(torch.floor_divide)
neg = _unary(torch.negative)
reciprocal = _unary(torch.reciprocal)
fmod = _binary(torch.fmod)
remainder = _binary(torch.remainder)
maximum = _binary(torch.maximum)
minimum = _binary(torch.minimum)


def squared_difference(a, b):
    d = torch.subtract(_t(a), _t(b))
    return d * d


# comparison
eq = _binary(torch.eq)
neq = _binary(torch.ne)
gt = _binary(torch.gt)
gte = _binary(torch.ge)
lt = _binary(torch.lt)
lte = _binary(torch.le)
logical_and = _binary(torch.logical_and)
logical_or = _binary(torch.logical_or)
logical_not = _unary(torch.logical_not)
logical_xor = _binary(torch.logical_xor)
isnan = _unary(torch.isnan)
isinf = _unary(torch.isinf)
isfinite = _unary(torch.isfinite)


# ---------------------------------------------------------------------------
# Reductions (INDArray.sum / norm1 / norm2 / normmax / ...)
# ---------------------------------------------------------------------------

def sum(a, axis=None, keepdims=False, dtype=None):
    a = _t(a)
    return torch.sum(a, dim=_axes(axis, a.dim()), keepdim=keepdims,
                     dtype=_as_dtype(dtype))


def mean(a, axis=None, keepdims=False):
    a = _t(a)
    return torch.mean(a, dim=_axes(axis, a.dim()), keepdim=keepdims)


def std(a, axis=None, keepdims=False, ddof=0):
    a = _t(a)
    return torch.std(a, dim=_axes(axis, a.dim()), correction=ddof,
                     keepdim=keepdims)


def var(a, axis=None, keepdims=False, ddof=0):
    a = _t(a)
    return torch.var(a, dim=_axes(axis, a.dim()), correction=ddof,
                     keepdim=keepdims)


def max(a, axis=None, keepdims=False):
    a = _t(a)
    return torch.amax(a, dim=_axes(axis, a.dim()), keepdim=keepdims)


def min(a, axis=None, keepdims=False):
    a = _t(a)
    return torch.amin(a, dim=_axes(axis, a.dim()), keepdim=keepdims)


def _each_dim(fn, a, axis, keepdims):
    """``fn(a, dim, keepdim)`` over each reduced dim, last first (the
    torch ops that take one dim at a time)."""
    for d in sorted({x % builtins.max(a.dim(), 1)
                     for x in _axes(axis, a.dim())}, reverse=True):
        a = fn(a, dim=d, keepdim=keepdims)
    return a


def prod(a, axis=None, keepdims=False):
    return _each_dim(torch.prod, _t(a), axis, keepdims)


def argmax(a, axis=None):
    a = _t(a)
    return torch.argmax(a if axis is not None else a.reshape(-1),
                        dim=0 if axis is None else axis)


def argmin(a, axis=None):
    a = _t(a)
    return torch.argmin(a if axis is not None else a.reshape(-1),
                        dim=0 if axis is None else axis)


def norm1(a, axis=None, keepdims=False):
    """L1 norm (INDArray.norm1)."""
    return sum(torch.abs(_t(a)), axis, keepdims)


def norm2(a, axis=None, keepdims=False):
    """L2 norm (INDArray.norm2)."""
    return torch.sqrt(sum(torch.square(_t(a)), axis, keepdims))


def normmax(a, axis=None, keepdims=False):
    """Max-abs norm (INDArray.normmax)."""
    return max(torch.abs(_t(a)), axis, keepdims)


def squared_norm(a, axis=None, keepdims=False):
    return sum(torch.square(_t(a)), axis, keepdims)


def cumsum(a, axis=None):
    a = _t(a)
    return torch.cumsum(a.reshape(-1) if axis is None else a,
                        dim=0 if axis is None else axis)


def cumprod(a, axis=None):
    a = _t(a)
    return torch.cumprod(a.reshape(-1) if axis is None else a,
                         dim=0 if axis is None else axis)


def all(a, axis=None, keepdims=False):
    return _each_dim(torch.all, _t(a).bool(), axis, keepdims)


def any(a, axis=None, keepdims=False):
    return _each_dim(torch.any, _t(a).bool(), axis, keepdims)


def count_nonzero(a, axis=None):
    a = _t(a)
    return torch.count_nonzero(a, dim=_axes(axis, a.dim()))


def entropy(a, axis=None):
    a = _t(a)
    p = a / torch.sum(a, dim=_axes(axis, a.dim()), keepdim=True)
    return -torch.sum(p * torch.log(torch.clamp(p, min=1e-12)),
                      dim=_axes(axis, a.dim()))


def log_sum_exp(a, axis=None, keepdims=False):
    a = _t(a)
    return torch.logsumexp(a, dim=_axes(axis, a.dim()), keepdim=keepdims)


# ---------------------------------------------------------------------------
# Shape ops
# ---------------------------------------------------------------------------

def reshape(a, *shape):
    return torch.reshape(_t(a), _shape(shape))


def ravel(a):
    return torch.ravel(_t(a))


def flatten(a):
    return torch.ravel(_t(a))


def transpose(a, axes=None):
    a = _t(a)
    return a.permute(*(reversed(range(a.dim())) if axes is None else axes))


def permute(a, *axes):
    """INDArray.permute: axis permutation."""
    return _t(a).permute(*_shape(axes))


def swap_axes(a, ax1, ax2):
    return torch.swapaxes(_t(a), ax1, ax2)


def move_axis(a, src, dst):
    return torch.movedim(_t(a), src, dst)


def expand_dims(a, axis):
    a = _t(a)
    for ax in sorted((axis,) if isinstance(axis, int) else axis):
        a = torch.unsqueeze(a, ax)
    return a


def squeeze(a, axis=None):
    a = _t(a)
    return torch.squeeze(a) if axis is None else torch.squeeze(a, axis)


def concat(arrays, axis=0):
    return torch.cat([_t(a) for a in arrays], dim=axis)


concatenate = concat


def hstack(arrays):
    return torch.hstack([_t(a) for a in arrays])


def vstack(arrays):
    return torch.vstack([_t(a) for a in arrays])


def stack(arrays, axis=0):
    return torch.stack([_t(a) for a in arrays], dim=axis)


def unstack(a, axis=0):
    return list(torch.unbind(_t(a), dim=axis))


def split(a, n_or_sections, axis=0):
    """numpy's split: n equal parts, or cuts at the given indices."""
    a = _t(a)
    if isinstance(n_or_sections, int) and a.shape[axis] % n_or_sections:
        raise ValueError("array split does not result in an equal division")
    return list(torch.tensor_split(a, n_or_sections if isinstance(
        n_or_sections, int) else list(n_or_sections), dim=axis))


def tile(a, reps):
    return torch.tile(_t(a), tuple(reps) if not isinstance(reps, int)
                      else (reps,))


def repeat(a, repeats, axis=None):
    a = _t(a)
    if axis is None:
        return torch.repeat_interleave(a.reshape(-1), repeats)
    return torch.repeat_interleave(a, repeats, dim=axis)


def _pad_axis(a, ax, before, after, mode, value):
    n = a.shape[ax]
    parts = []
    if mode == "constant":
        shp = list(a.shape)
        for w in (before, after):
            shp[ax] = w
            parts.append(torch.full(shp, value, dtype=a.dtype,
                                    device=a.device))
        return torch.cat([parts[0], a, parts[1]], dim=ax)
    if mode == "edge":
        lo = a.narrow(ax, 0, 1).repeat_interleave(before, dim=ax)
        hi = a.narrow(ax, n - 1, 1).repeat_interleave(after, dim=ax)
    elif mode == "reflect":
        lo = torch.flip(a.narrow(ax, 1, before), [ax])
        hi = torch.flip(a.narrow(ax, n - 1 - after, after), [ax])
    elif mode == "symmetric":
        lo = torch.flip(a.narrow(ax, 0, before), [ax])
        hi = torch.flip(a.narrow(ax, n - after, after), [ax])
    elif mode == "wrap":
        lo = a.narrow(ax, n - before, before)
        hi = a.narrow(ax, 0, after)
    else:
        raise ValueError(f"unsupported pad mode {mode!r}")
    return torch.cat([lo, a, hi], dim=ax)


def pad(a, pad_width, mode="constant", constant_values=0):
    """numpy's pad (constant, edge, reflect, symmetric, wrap)."""
    a = _t(a)
    if isinstance(pad_width, int):
        pad_width = [(pad_width, pad_width)] * a.dim()
    pad_width = [tuple(p) if not isinstance(p, int) else (p, p)
                 for p in pad_width]
    if len(pad_width) == 1:
        pad_width = pad_width * a.dim()
    for ax, (lo, hi) in enumerate(pad_width):
        if lo or hi:
            a = _pad_axis(a, ax, lo, hi, mode, constant_values)
    return a


def flip(a, axis=None):
    a = _t(a)
    return torch.flip(a, list(_axes(axis, a.dim())))


def roll(a, shift, axis=None):
    a = _t(a)
    if axis is None:
        return torch.roll(a.reshape(-1), shift).reshape(a.shape)
    return torch.roll(a, shift, axis)


def broadcast_to(a, shape):
    return torch.broadcast_to(_t(a), tuple(shape))


def size(a):
    return _t(a).numel()


def shape(a):
    return tuple(_t(a).shape)


def rank(a):
    return _t(a).dim()


def length(a):
    return _t(a).numel()


def dup(a):
    """INDArray.dup: a copy."""
    return _t(a).clone()


def cast(a, dtype):
    return _t(a).to(_as_dtype(dtype))


astype = cast


# ---------------------------------------------------------------------------
# Elementwise transforms (org.nd4j.linalg.ops.transforms.Transforms)
# ---------------------------------------------------------------------------
abs = _unary(torch.abs)
sign = _unary(torch.sign)
exp = _unary(torch.exp)
expm1 = _unary(torch.expm1)
log = _unary(torch.log)
log1p = _unary(torch.log1p)
log2 = _unary(torch.log2)
log10 = _unary(torch.log10)
sqrt = _unary(torch.sqrt)
rsqrt = _unary(torch.rsqrt)
square = _unary(torch.square)
cbrt = _unary(lambda a: torch.sign(a) * torch.abs(a) ** (1.0 / 3.0))
floor = _unary(torch.floor)
ceil = _unary(torch.ceil)
round = _unary(torch.round)
trunc = _unary(torch.trunc)
sin = _unary(torch.sin)
cos = _unary(torch.cos)
tan = _unary(torch.tan)
asin = _unary(torch.asin)
acos = _unary(torch.acos)
atan = _unary(torch.atan)
atan2 = _binary(torch.atan2)
sinh = _unary(torch.sinh)
cosh = _unary(torch.cosh)
tanh = _unary(torch.tanh)
asinh = _unary(torch.asinh)
acosh = _unary(torch.acosh)
atanh = _unary(torch.atanh)
erf = _unary(torch.erf)
erfc = _unary(torch.erfc)
sigmoid = _unary(torch.sigmoid)
softplus = _unary(F.softplus)
relu = _unary(torch.relu)
relu6 = _unary(F.relu6)
silu = _unary(F.silu)
hard_sigmoid = _unary(F.hardsigmoid)
hard_tanh = _unary(F.hardtanh)


def softmax(a, axis=-1):
    return torch.softmax(_t(a), dim=axis)


def log_softmax(a, axis=-1):
    return torch.log_softmax(_t(a), dim=axis)


def leaky_relu(a, negative_slope=0.01):
    return F.leaky_relu(_t(a), negative_slope)


def elu(a, alpha=1.0):
    return F.elu(_t(a), alpha)


def gelu(a, approximate=True):
    """jax.nn.gelu: the tanh approximation by default."""
    return F.gelu(_t(a), approximate="tanh" if approximate else "none")


def clip(a, min=None, max=None):
    return torch.clamp(_t(a), min, max)


clip_by_value = clip


def clip_by_norm(a, clip_norm, axis=None):
    a = _t(a)
    n = norm2(a, axis=axis, keepdims=True)
    return torch.where(n > clip_norm,
                       a * (clip_norm / torch.clamp(n, min=1e-12)), a)


def step(a):  # heaviside step used by DL4J Transforms.step
    a = _t(a)
    return (a > 0).to(a.dtype)


def pow_scalar(a, p):
    return torch.pow(_t(a), p)


# ---------------------------------------------------------------------------
# Sorting / searching / selection
# ---------------------------------------------------------------------------

def sort(a, axis=-1, descending=False):
    """Ascending sort, flipped for ``descending`` (the reference's
    order among equal elements)."""
    out = torch.sort(_t(a), dim=axis, stable=True).values
    return torch.flip(out, [axis]) if descending else out


def argsort(a, axis=-1, descending=False):
    out = torch.sort(_t(a), dim=axis, stable=True).indices
    return torch.flip(out, [axis]) if descending else out


def top_k(a, k, axis=-1):
    """(values, indices) of the k largest along ``axis``; among equal
    values the lower index first, as ``lax.top_k``."""
    v, i = torch.sort(_t(a), dim=axis, descending=True, stable=True)
    return v.narrow(axis, 0, k), i.narrow(axis, 0, k).to(torch.int32)


def where(cond, x=None, y=None):
    cond = _t(cond)
    if x is None and y is None:
        return torch.where(cond)
    return torch.where(cond, _t(x) if not isinstance(x, (int, float)) else x,
                       _t(y) if not isinstance(y, (int, float)) else y)


def searchsorted(a, v, side="left"):
    return torch.searchsorted(_t(a), _t(v), right=(side == "right"))


def unique(a, size=None, fill_value=None):
    """Sorted unique values of the flattened input. With ``size`` the
    result has exactly ``size`` entries (extra uniques dropped, missing
    ones ``fill_value``, by default the smallest value), computed on the
    device without a host read, so it is safe inside a captured graph."""
    a = _t(a)
    if size is None:
        return torch.unique(a)
    s = torch.sort(a.reshape(-1)).values
    if s.numel() == 0:
        return torch.full((size,), 0 if fill_value is None else fill_value,
                          dtype=a.dtype, device=a.device)
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    pos = torch.cumsum(first.to(torch.int64), 0) - 1
    fill = s[0] if fill_value is None else torch.as_tensor(
        fill_value, dtype=a.dtype, device=a.device)
    out = fill.expand(size + 1).clone()
    # every non-first entry and every first past ``size`` lands in the
    # dropped slot ``size``
    slot = torch.where(first & (pos < size), pos, torch.full_like(pos, size))
    out.scatter_(0, slot, s)
    return out[:size]


def take(a, indices, axis=None):
    a, idx = _t(a), _t(indices).long()
    if axis is None:
        return a.reshape(-1)[idx]
    return torch.index_select(a, axis, idx.reshape(-1)).reshape(
        a.shape[:axis] + idx.shape + a.shape[axis + 1:]) \
        if idx.dim() != 1 else torch.index_select(a, axis, idx)


def take_along_axis(a, indices, axis):
    return torch.take_along_dim(_t(a), _t(indices).long(), dim=axis)


def gather(a, indices, axis=0):
    return take(a, indices, axis=axis)


def _index(indices):
    if isinstance(indices, (tuple, list)):
        return tuple(_t(i).long() if not isinstance(i, (int, slice)) else i
                     for i in indices)
    return indices if isinstance(indices, (int, slice)) else \
        _t(indices).long()


def scatter_update(a, indices, updates):
    """``a.at[indices].set(updates)``: a new tensor."""
    out = _t(a).clone()
    out[_index(indices)] = _t(updates).to(out.dtype)
    return out


def scatter_add(a, indices, updates):
    """``a.at[indices].add(updates)``: repeated indices accumulate."""
    out = _t(a).clone()
    idx = _index(indices)
    upd = _t(updates).to(out.dtype)
    if isinstance(idx, torch.Tensor):
        idx = (idx,)
    elif not isinstance(idx, tuple):
        out[idx] += upd
        return out
    out.index_put_(idx, torch.broadcast_to(upd, out[idx].shape),
                   accumulate=True)
    return out


def scatter_max(a, indices, updates):
    """``a.at[indices].max(updates)`` along the first axis."""
    out = _t(a).clone()
    idx = _index(indices)
    if not isinstance(idx, torch.Tensor):
        out[idx] = torch.maximum(out[idx], _t(updates).to(out.dtype))
        return out
    idx = idx.reshape(-1)
    upd = torch.broadcast_to(_t(updates).to(out.dtype),
                             (idx.numel(),) + tuple(out.shape[1:]))
    return out.index_reduce_(0, idx, upd, "amax", include_self=True)


def segment_sum(data, segment_ids, num_segments):
    """Sums of ``data`` rows by segment id; ids outside
    [0, num_segments) are dropped, as jax.ops.segment_sum drops them."""
    data, ids = _t(data), _t(segment_ids).long()
    ok = (ids >= 0) & (ids < num_segments)
    w = ok.reshape(ok.shape + (1,) * (data.dim() - ok.dim())).to(data.dtype)
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, torch.where(ok, ids, 0), data * w)


# ---------------------------------------------------------------------------
# Linear algebra (Nd4j.linalg / lapack)
# ---------------------------------------------------------------------------

def _solve_triangular(a, b, lower=False, trans=0, unit_diagonal=False):
    """scipy's solve_triangular: ``a x = b`` (``trans`` 1: ``aᵀ x = b``)."""
    a, b = _t(a), _t(b)
    if trans in (1, "T"):
        a, lower = a.transpose(-1, -2), not lower
    vec = b.dim() == a.dim() - 1
    x = torch.linalg.solve_triangular(a, b.unsqueeze(-1) if vec else b,
                                      upper=not lower,
                                      unitriangular=unit_diagonal)
    return x.squeeze(-1) if vec else x


class linalg:
    cholesky = staticmethod(_unary(torch.linalg.cholesky))
    qr = staticmethod(_unary(torch.linalg.qr))
    svd = staticmethod(lambda a, full_matrices=True, compute_uv=True:
                       torch.linalg.svd(_t(a), full_matrices=full_matrices)
                       if compute_uv else torch.linalg.svdvals(_t(a)))
    inv = staticmethod(_unary(torch.linalg.inv))
    pinv = staticmethod(_unary(torch.linalg.pinv))
    det = staticmethod(_unary(torch.linalg.det))
    slogdet = staticmethod(_unary(torch.linalg.slogdet))
    solve = staticmethod(_binary(torch.linalg.solve))
    lstsq = staticmethod(_binary(torch.linalg.lstsq))
    eig = staticmethod(_unary(torch.linalg.eig))
    eigh = staticmethod(_unary(torch.linalg.eigh))
    norm = staticmethod(lambda a, ord=None, axis=None, keepdims=False:
                        torch.linalg.norm(_t(a), ord, axis, keepdims))
    matrix_rank = staticmethod(_unary(torch.linalg.matrix_rank))
    triangular_solve = staticmethod(_solve_triangular)


# ---------------------------------------------------------------------------
# Conv primitives (libnd4j conv ops). NHWC activations, HWIO kernels.
# ---------------------------------------------------------------------------

def _same_pads(size, k, s, d=1):
    """TF/XLA SAME padding of one spatial dim: (before, after)."""
    eff = (k - 1) * d + 1
    out = -(-size // s)
    total = builtins.max((out - 1) * s + eff - size, 0)
    return total // 2, total - total // 2


def _spatial_pads(padding, hw, window, stride, dilation=(1, 1)):
    """[(top, bottom), (left, right)] of "SAME" / "VALID" / explicit pairs."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0), (0, 0)]
        return [_same_pads(hw[i], window[i], stride[i], dilation[i])
                for i in range(2)]
    return [tuple(p) for p in padding]


def conv2d(x, w, stride=(1, 1), padding="SAME", dilation=(1, 1),
           feature_group_count=1,
           dimension_numbers=("NHWC", "HWIO", "NHWC")):
    """The reference's ``lax.conv_general_dilated`` in NHWC/HWIO; a bf16
    input gives an f32 result, as its ``preferred_element_type``."""
    if tuple(dimension_numbers) != ("NHWC", "HWIO", "NHWC"):
        raise ValueError("conv2d takes NHWC inputs and HWIO kernels")
    x, w = _t(x), _t(w)
    (pt, pb), (pl, pr) = _spatial_pads(padding, x.shape[1:3], w.shape[:2],
                                       stride, dilation)
    xn = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    y = F.conv2d(xn, w.permute(3, 2, 0, 1).to(x.dtype), stride=tuple(stride),
                 dilation=tuple(dilation), groups=feature_group_count)
    y = y.permute(0, 2, 3, 1)
    return y.float() if x.dtype == torch.bfloat16 else y


def _pool_input(x, window, stride, padding, value):
    x = _t(x)
    (pt, pb), (pl, pr) = _spatial_pads(padding, x.shape[1:3], window, stride)
    return F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb), value=value)


def max_pool2d(x, window=(2, 2), stride=None, padding="VALID"):
    stride = window if stride is None else stride
    x = _t(x)
    low = float("-inf") if x.is_floating_point() else \
        torch.iinfo(x.dtype).min
    xn = _pool_input(x, window, stride, padding, low)
    return F.max_pool2d(xn, tuple(window), tuple(stride)).permute(0, 2, 3, 1)


def avg_pool2d(x, window=(2, 2), stride=None, padding="VALID",
               count_include_pad=True):
    stride = window if stride is None else stride
    x = _t(x)
    s = F.avg_pool2d(_pool_input(x, window, stride, padding, 0.0),
                     tuple(window), tuple(stride)).permute(0, 2, 3, 1)
    if count_include_pad or (isinstance(padding, str)
                             and padding.upper() == "VALID"):
        return s
    ones_ = torch.ones(x.shape[:3] + (1,), dtype=x.dtype, device=x.device)
    cnt = F.avg_pool2d(_pool_input(ones_, window, stride, padding, 0.0),
                       tuple(window), tuple(stride)).permute(0, 2, 3, 1)
    return s / cnt


def im2col(x, kernel, stride=(1, 1), padding="VALID"):
    """Patches: (N, H, W, C) → (N, OH, OW, C·kh·kw), channel-major within
    a patch (the reference's ``conv_general_dilated_patches`` order)."""
    x = _t(x)
    kh, kw = kernel
    (pt, pb), (pl, pr) = _spatial_pads(padding, x.shape[1:3], kernel, stride)
    xn = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    oh = (xn.shape[2] - kh) // stride[0] + 1
    ow = (xn.shape[3] - kw) // stride[1] + 1
    cols = F.unfold(xn, (kh, kw), stride=tuple(stride))
    return cols.reshape(x.shape[0], -1, oh, ow).permute(0, 2, 3, 1)


def col2im(cols, x_shape, kernel, stride=(1, 1)):
    """Scatter-add :func:`im2col`'s patches (VALID) back into ``x_shape``."""
    cols = _t(cols)
    n, h, w, c = x_shape
    kh, kw = kernel
    oh = (h - kh) // stride[0] + 1
    ow = (w - kw) // stride[1] + 1
    cols = cols.reshape(n, oh, ow, c, kh, kw)   # patches: C major
    out = torch.zeros(tuple(x_shape), dtype=cols.dtype, device=cols.device)
    for i in range(kh):
        for j in range(kw):
            out[:, i:i + oh * stride[0]:stride[0],
                j:j + ow * stride[1]:stride[1], :] += cols[:, :, :, :, i, j]
    return out


# host transfer helpers
def to_numpy(a):
    """A host numpy copy (bf16 widened to float32: numpy has no bf16)."""
    t = _t(a).detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def device_put(a, device=None):
    """``a`` on ``device`` (None → the CUDA card)."""
    return _t(a).to(resolve_device(device))
