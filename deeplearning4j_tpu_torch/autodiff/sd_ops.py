"""SameDiff op registry — port of ``deeplearning4j_tpu/autodiff/sd_ops.py``.

The same namespaces and the same op names (``op_count()`` 739), each op
a plain torch function. JAX runs with 64-bit types off, so the reference's
ops return 32-bit results, and so do these: indices, ``argmax``,
``shape_of`` and ``size`` are int32, integer sums stay int32, and a numpy
float64 or int64 argument is read as float32 or int32 (:func:`_t`).

Arguments are what the reference's ops take: tensors, numpy arrays,
Python lists and scalars for array arguments (an array argument that is
not a tensor goes to the default device, which ``SameDiff`` sets to its
own while it runs a graph), Python ints and tuples for the static ones.
A dtype is a torch dtype, a numpy dtype or its name.

Random ops take a ``torch.Generator`` where the reference takes a JAX
key: same distributions, other bits. The ``bp`` namespace derives every
backprop op from its forward op with ``torch.autograd.grad``, as the
reference derives it with ``jax.vjp``. The ``assert`` namespace and
``check_numerics`` check eagerly and raise; a graph that holds one is
run eagerly by ``SameDiff`` (:data:`HOST_OPS` names them, with every
other op whose torch form reads a value back to the host).
"""

from __future__ import annotations

import itertools
import math as _math

import numpy
import torch
import torch.nn.functional as F

# ------------------------------------------------------------------ dtypes

_NP_TORCH = {numpy.dtype(k): v for k, v in (
    ("float16", torch.float16), ("float32", torch.float32),
    ("float64", torch.float32), ("int8", torch.int8),
    ("int16", torch.int16), ("int32", torch.int32), ("int64", torch.int32),
    ("uint8", torch.uint8), ("uint16", torch.uint16),
    ("uint32", torch.uint32), ("uint64", torch.uint32),
    ("bool", torch.bool), ("complex64", torch.complex64),
    ("complex128", torch.complex64))}
# 64-bit results narrowed to the reference's 32-bit ones
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32,
           torch.complex128: torch.complex64, torch.uint64: torch.uint32}


def dtype_of(d):
    """A torch dtype from a torch dtype, a numpy dtype, a scalar type or a
    name (64-bit types narrowed, as JAX narrows them)."""
    if d is None or isinstance(d, torch.dtype):
        return _NARROW.get(d, d)
    if str(d) in ("bfloat16", "bf16") or getattr(d, "__name__", "") == \
            "bfloat16":
        return torch.bfloat16
    return _NP_TORCH[numpy.dtype(d)]


def _t(x, dtype=None):
    """A tensor as it is (cast to ``dtype`` when given); anything else —
    numpy arrays and scalars, lists, Python numbers — as a tensor on the
    default device in the reference's 32-bit dtypes (:func:`_const`)."""
    if not isinstance(x, torch.Tensor):
        if isinstance(x, (list, tuple)) and any(
                isinstance(v, torch.Tensor) for v in x):
            x = torch.stack([_t(v) for v in x])
        else:
            a = numpy.asarray(x)
            if a.dtype == object:
                raise TypeError(f"cannot make a tensor of {type(x).__name__}")
            if a.dtype.kind == "f" and a.dtype.itemsize == 8:
                a = a.astype(numpy.float32)
            elif a.dtype.kind == "i" and a.dtype.itemsize == 8:
                a = a.astype(numpy.int32)
            elif a.dtype.kind == "c" and a.dtype.itemsize == 16:
                a = a.astype(numpy.complex64)
            elif a.dtype.kind == "u" and a.dtype.itemsize > 1:
                a = a.astype(numpy.int64).astype(numpy.int32)
            x = _const(a)
    if dtype is not None:
        x = x.to(dtype_of(dtype))
    return x


# host arrays copied to the card, by value: the copy happens once, on a
# graph's first (eager) run, never inside a CUDA graph capture, which
# forbids a copy from pageable host memory
_CONSTS = {}
_CONST_MAX = 1 << 16


def _const(a):
    """Numpy array ``a`` as a tensor on the default device; on a CUDA
    device a small array is copied once and the copy reused (callers
    never write into it)."""
    dev = torch.get_default_device()
    if dev.type != "cuda" or a.size > _CONST_MAX:
        return torch.as_tensor(a)
    key = (a.dtype.str, a.shape, a.tobytes(), str(dev))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.as_tensor(a)
    return t


def _scalar(v, dtype, device):
    """A Python number as a 0-d tensor: a fill on the device, no copy."""
    return torch.full((), v, dtype=dtype, device=device)


def _idx(x):
    """Integer indices as an int64 tensor for torch's indexing."""
    return _t(x).long()


def _i32(t):
    return t.to(torch.int32)


def _fl(x):
    """Integers and bools promoted to float32 (JAX's promotion to an
    inexact type)."""
    x = _t(x)
    return x if x.is_floating_point() or x.is_complex() else x.float()


def _like(v, ref):
    """A Python scalar or array ``v`` as a tensor of ``ref``'s dtype."""
    return _t(v).to(device=ref.device, dtype=ref.dtype)


def _axes(a):
    return tuple(a) if isinstance(a, (list, tuple)) else a


def _dims(x, axes):
    """``*axes`` of a reduction (the reference's ``_axes(axes) or None``):
    None for every dim, else a tuple of ints."""
    axes = _axes(axes)
    if axes is None or axes == ():
        return None
    if isinstance(axes, int):
        return (axes,)
    return tuple(int(a) for a in axes)


def _all(x, dims):
    return tuple(range(x.ndim)) if dims is None else dims


def _int_acc(x, out):
    """A sum-like reduction's dtype as JAX gives it: bools and integers
    up to 32 bits sum in int32, unsigned 8-bit in uint32 (int32 here)."""
    if not (x.is_floating_point() or x.is_complex()):
        return out.to(torch.int32)
    return out


def _sum(x, axis=None, keepdims=False):
    x = _t(x)
    dims = _dims(x, axis)
    if x.ndim == 0:
        return _int_acc(x, x.clone() if x.dtype != torch.bool else x.int())
    out = torch.sum(x, dim=_all(x, dims), keepdim=keepdims)
    return _int_acc(x, out)


def _mean(x, axis=None, keepdims=False):
    x = _fl(x)
    dims = _dims(x, axis)
    if x.ndim == 0:
        return x.clone()
    return torch.mean(x, dim=_all(x, dims), keepdim=keepdims)


def _prod(x, axis=None, keepdims=False):
    x = _t(x)
    dims = _all(x, _dims(x, axis))
    out = x if x.dtype != torch.bool else x.int()
    for d in sorted((d % max(x.ndim, 1) for d in dims), reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdims)
    return _int_acc(x, out)


def _amax(x, axis=None, keepdims=False):
    x = _t(x)
    dims = _dims(x, axis)
    if x.ndim == 0:
        return x.clone()
    if x.dtype == torch.bool:
        return torch.any(x, dim=_all(x, dims), keepdim=keepdims)
    return torch.amax(x, dim=_all(x, dims), keepdim=keepdims)


def _amin(x, axis=None, keepdims=False):
    x = _t(x)
    dims = _dims(x, axis)
    if x.ndim == 0:
        return x.clone()
    if x.dtype == torch.bool:
        return torch.all(x, dim=_all(x, dims), keepdim=keepdims)
    return torch.amin(x, dim=_all(x, dims), keepdim=keepdims)


def _var(x, axis=None, ddof=0, keepdims=False):
    x = _fl(x)
    dims = _dims(x, axis)
    return torch.var(x, dim=_all(x, dims), correction=ddof, keepdim=keepdims)


def _std(x, axis=None, ddof=0, keepdims=False):
    x = _fl(x)
    dims = _dims(x, axis)
    return torch.std(x, dim=_all(x, dims), correction=ddof, keepdim=keepdims)


def _any(x, axis=None, keepdims=False):
    x = _t(x).bool()
    dims = _dims(x, axis)
    if x.ndim == 0:
        return x.clone()
    return torch.any(x, dim=_all(x, dims), keepdim=keepdims)


def _alls(x, axis=None, keepdims=False):
    x = _t(x).bool()
    dims = _dims(x, axis)
    if x.ndim == 0:
        return x.clone()
    return torch.all(x, dim=_all(x, dims), keepdim=keepdims)


def _logsumexp(x, axis=None, keepdims=False):
    x = _fl(x)
    dims = _dims(x, axis)
    if x.ndim == 0:
        return x.clone()
    return torch.logsumexp(x, dim=_all(x, dims), keepdim=keepdims)


def _argmax(x, axis=None, keepdims=False):
    x = _t(x)
    if x.dtype == torch.bool:
        x = x.int()
    if axis is None:
        return _i32(torch.argmax(x.reshape(-1)))
    return _i32(torch.argmax(x, dim=int(axis), keepdim=keepdims))


def _argmin(x, axis=None, keepdims=False):
    x = _t(x)
    if x.dtype == torch.bool:
        x = x.int()
    if axis is None:
        return _i32(torch.argmin(x.reshape(-1)))
    return _i32(torch.argmin(x, dim=int(axis), keepdim=keepdims))


def _count_nonzero(x, axis=None):
    x = _t(x)
    dims = _dims(x, axis)
    return _i32(torch.count_nonzero(x, dim=dims)) if dims is not None \
        else _i32(torch.count_nonzero(x))


def _cum(fn):
    def f(x, axis=None):
        x = _t(x)
        if axis is None:
            x, axis = x.reshape(-1), 0
        src = x.int() if x.dtype == torch.bool else x
        return _int_acc(x, fn(src, dim=int(axis)))
    return f


_cumsum = _cum(torch.cumsum)
_cumprod = _cum(torch.cumprod)


def _where(cond, x=None, y=None):
    cond = _t(cond)
    if x is None:
        return tuple(_i32(i) for i in torch.nonzero(cond, as_tuple=True))
    x, y = _bin(x, y)
    return torch.where(cond.bool(), x, y)


def _bin(a, b):
    """Two operands as tensors, Python scalars left for torch's weak
    promotion to match JAX's."""
    if isinstance(a, (int, float, bool)) and not isinstance(b, (
            int, float, bool)):
        b = _t(b)
        return _scalar(a, _scalar_dtype(a, b), b.device), b
    if isinstance(b, (int, float, bool)) and not isinstance(a, (
            int, float, bool)):
        a = _t(a)
        return a, _scalar(b, _scalar_dtype(b, a), a.device)
    return _t(a), _t(b)


def _scalar_dtype(s, ref):
    """A Python scalar's dtype beside ``ref`` (JAX's weak type): ref's
    own when of the same kind or wider, else the scalar's default."""
    if isinstance(s, bool):
        return ref.dtype
    if isinstance(s, int):
        return ref.dtype if ref.dtype != torch.bool else torch.int32
    if ref.is_floating_point() or ref.is_complex():
        return ref.dtype
    return torch.float32


def _binop(fn):
    def f(a, b):
        a, b = _bin(a, b)
        return fn(a, b)
    return f


def _unop(fn, inexact=False):
    def f(x):
        return fn(_fl(x) if inexact else _t(x))
    return f


# ---------------------------------------------------------------- SDBaseOps
def _scatter(op):
    def f(ref, indices, updates):
        ref = _t(ref)
        idx = _idx(indices)
        upd = _like(updates, ref) if not isinstance(updates, torch.Tensor) \
            else updates.to(ref.dtype)
        upd = torch.broadcast_to(upd, idx.shape + ref.shape[1:])
        out = ref.clone()
        if op == "set":
            out[idx] = upd
            return out
        if op == "add":
            return out.index_put((idx,), upd, accumulate=True)
        flat_idx = idx.reshape(-1)
        u = upd.reshape((-1,) + ref.shape[1:])
        if op == "divide":          # x / u1 / u2 = x · (1/u1) · (1/u2)
            u = 1.0 / u
        red = {"multiply": "prod", "divide": "prod", "max": "amax",
               "min": "amin"}[op]
        index = flat_idx.reshape((-1,) + (1,) * (ref.ndim - 1)).expand(
            u.shape)
        return out.scatter_reduce(0, index, u, reduce=red, include_self=True)
    return f


def _nd_index(idx):
    idx = _idx(idx)
    return tuple(idx[..., i] for i in range(idx.shape[-1]))


def _gather_nd(params, indices):
    params = _t(params)
    return params[_nd_index(indices)]


def _scatter_nd(indices, updates, shape):
    upd = _t(updates)
    out = torch.zeros(tuple(int(s) for s in shape), dtype=upd.dtype,
                      device=upd.device)
    return out.index_put(_nd_index(indices), upd, accumulate=True)


def _dynamic_partition(x, partitions, num_partitions):
    x, p = _t(x), _t(partitions)
    return [torch.where((p == i).reshape((-1,) + (1,) * (x.ndim - 1)), x,
                        torch.zeros((), dtype=x.dtype, device=x.device))
            for i in range(num_partitions)]


def _dynamic_stitch(indices, data):
    n = sum(_t(i).numel() for i in indices)
    first = _t(data[0])
    out = torch.zeros((n,) + tuple(first.shape[1:]), dtype=first.dtype,
                      device=first.device)
    for idx, d in zip(indices, data):
        out[_idx(idx).reshape(-1)] = _t(d).reshape(
            (-1,) + tuple(first.shape[1:])).to(first.dtype)
    return out


def _sequence_mask(lengths, maxlen=None):
    lengths = _t(lengths)
    maxlen = int(maxlen) if maxlen is not None else int(lengths.max())
    return torch.arange(maxlen, device=lengths.device) < lengths[..., None]


def _reverse_sequence(x, seq_lengths, seq_axis=1, batch_axis=0):
    x = _t(x)
    t = x.shape[seq_axis]
    idx = torch.arange(t, device=x.device)
    lens = _t(seq_lengths).to(x.device).long()
    rev = torch.where(idx[None, :] < lens[:, None],
                      lens[:, None] - 1 - idx[None, :], idx[None, :])
    x_b = torch.movedim(x, (batch_axis, seq_axis), (0, 1))
    rev = rev.reshape(rev.shape + (1,) * (x_b.ndim - 2)).expand(
        (x_b.shape[0], t) + tuple(x_b.shape[2:]))
    out = torch.gather(x_b, 1, rev)
    return torch.movedim(out, (0, 1), (batch_axis, seq_axis))


def _bincount(x, length, weights=None):
    """``jnp.bincount(x, length=...)``: fixed length, ids past it dropped,
    negative ids clipped to 0 (as JAX clips them)."""
    x = _idx(x).reshape(-1)
    length = int(length)
    x = x.clamp_min(0)
    keep = x < length
    if weights is None:
        w = keep.to(torch.int32)
    else:
        w = torch.where(keep, _t(weights).reshape(-1),
                        torch.zeros((), dtype=_t(weights).dtype,
                                    device=x.device))
    out = torch.zeros(length, dtype=w.dtype, device=x.device)
    return out.index_add(0, x.clamp_max(length - 1), w)


def _confusion_matrix(labels, predictions, num_classes):
    idx = _t(labels).long() * num_classes + _t(predictions).long()
    return _bincount(idx, num_classes * num_classes).reshape(
        num_classes, num_classes)


def _clip_by_norm(x, clip_norm, axes=None):
    x = _t(x)
    n = torch.sqrt(_sum(torch.square(x), axes, keepdims=True))
    return torch.where(n > clip_norm, x * clip_norm / torch.clamp_min(
        n, 1e-12), x)


def _clip_by_global_norm(tensors, clip_norm):
    g = torch.sqrt(sum(torch.sum(torch.square(_t(t))) for t in tensors))
    scale = torch.clamp_max(clip_norm / torch.clamp_min(g, 1e-12), 1.0)
    return [_t(t) * scale for t in tensors]


def _top_k(x, k, sorted=True):  # noqa: A002 — upstream arg name
    v, i = torch.topk(_t(x), int(k), dim=-1, largest=True, sorted=True)
    return v, _i32(i)


def _unique_sized(x, size, fill=None):
    """``jnp.unique(x, size=...)``: the sorted unique values padded to
    ``size`` with ``fill`` (the smallest value by default)."""
    x = _t(x).reshape(-1)
    vals, counts = torch.unique(x, sorted=True, return_counts=True)
    size = int(size)
    n = vals.shape[0]
    fillv = vals[0] if fill is None else _like(fill, vals)
    if n >= size:
        return vals[:size], _i32(counts[:size])
    pad = fillv.expand(size - n) if fillv.ndim == 0 else fillv
    return torch.cat([vals, pad.to(vals.dtype)]), torch.cat(
        [_i32(counts), torch.zeros(size - n, dtype=torch.int32,
                                   device=x.device)])


def _unique_with_counts(x, size):
    return _unique_sized(x, size)


def _batch_mmul(a, b, transpose_a=False, transpose_b=False):
    a, b = _t(a), _t(b)
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


def _matmul(a, b):
    a, b = _promote(_t(a), _t(b))
    return torch.matmul(a, b)


def _promote(*xs):
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return tuple(x.to(dt) for x in xs)


def _tensordot(a, b, axes=2):
    a, b = _promote(_t(a), _t(b))
    if isinstance(axes, (list, tuple)):
        axes = [list(_axes(axes[0])) if isinstance(axes[0], (list, tuple))
                else [axes[0]],
                list(_axes(axes[1])) if isinstance(axes[1], (list, tuple))
                else [axes[1]]]
    return torch.tensordot(a, b, dims=axes)


def _dot(a, b):
    a, b = _promote(_t(a), _t(b))
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    if b.ndim == 1:
        return torch.matmul(a, b)
    return torch.tensordot(a, b, dims=([a.ndim - 1], [b.ndim - 2]))


def _vdot(a, b):
    a, b = _promote(_t(a).reshape(-1), _t(b).reshape(-1))
    return torch.sum(a.conj() * b)


def _einsum(eq, *ops):
    ops = _promote(*[_t(o) for o in ops])
    return torch.einsum(eq, *ops)


def _cross(a, b):
    a, b = _promote(_t(a), _t(b))
    return torch.linalg.cross(a, b, dim=-1)


def _kron(a, b):
    a, b = _promote(_t(a), _t(b))
    return torch.kron(a, b)


def _outer(a, b):
    a, b = _promote(_t(a).reshape(-1), _t(b).reshape(-1))
    return torch.outer(a, b)


def _space_to_depth(x, bs):
    x = _t(x)
    b, h, w, c = x.shape
    return x.reshape(b, h // bs, bs, w // bs, bs, c).permute(
        0, 1, 3, 2, 4, 5).reshape(b, h // bs, w // bs, bs * bs * c)


def _depth_to_space(x, bs):
    x = _t(x)
    b, h, w, c = x.shape
    return x.reshape(b, h, w, bs, bs, c // (bs * bs)).permute(
        0, 1, 3, 2, 4, 5).reshape(b, h * bs, w * bs, c // (bs * bs))


def _pad(x, paddings, mode="constant", value=0.0):
    """``jnp.pad``: ``paddings`` an int, a pair or a pair per dim."""
    x = _t(x)
    p = numpy.asarray(paddings, dtype=numpy.int64)
    if p.ndim == 0:
        p = numpy.full((x.ndim, 2), int(p))
    elif p.ndim == 1:
        p = numpy.tile(p.reshape(1, 2), (x.ndim, 1))
    flat = []
    for lo, hi in p[::-1]:
        flat += [int(lo), int(hi)]
    mode = {"constant": "constant", "reflect": "reflect",
            "symmetric": "symmetric", "edge": "replicate",
            "wrap": "circular"}[mode]
    if mode == "constant":
        return F.pad(x, flat, value=float(value) if x.is_floating_point()
                     else value)
    if mode == "symmetric":
        return _pad_symmetric(x, p)
    # torch pads the trailing dims of a (N, C, ...) tensor only: pad as a
    # batch of one channel, dim by dim
    out = x
    for d in range(x.ndim):
        lo, hi = int(p[d][0]), int(p[d][1])
        if lo == 0 and hi == 0:
            continue
        moved = out.movedim(d, -1)
        shp = moved.shape
        flat1 = moved.reshape(1, -1, shp[-1])
        if not flat1.is_floating_point():
            padded = F.pad(flat1.double(), (lo, hi), mode=mode).to(
                flat1.dtype)
        else:
            padded = F.pad(flat1, (lo, hi), mode=mode)
        out = padded.reshape(shp[:-1] + (shp[-1] + lo + hi,)).movedim(-1, d)
    return out


def _pad_symmetric(x, p):
    out = x
    for d in range(x.ndim):
        lo, hi = int(p[d][0]), int(p[d][1])
        n = out.shape[d]
        idx = list(range(lo - 1, -1, -1)) + list(range(n)) + \
            list(range(n - 1, n - 1 - hi, -1))
        out = out.index_select(d, _t([i % n for i in idx]).to(
            out.device).long())
    return out


def _flip(x, *axes):
    x = _t(x)
    dims = _dims(x, axes)
    return torch.flip(x, dims=_all(x, dims))


def _roll(x, shift, axis=None):
    x = _t(x)
    if axis is None:
        return torch.roll(x.reshape(-1), _axes(shift)).reshape(x.shape)
    return torch.roll(x, _axes(shift), _axes(axis))


def _split(x, num_or_sections, axis=0):
    """``jnp.split``: an int is that many equal parts; a list is the
    indices to split at."""
    x = _t(x)
    axis = int(axis)
    if isinstance(num_or_sections, int):
        if x.shape[axis] % num_or_sections:
            raise ValueError("array split does not result in an equal "
                             "division")
        return list(torch.tensor_split(x, num_or_sections, dim=axis))
    return list(torch.tensor_split(x, [int(i) for i in num_or_sections],
                                   dim=axis))


def _unstack(x, axis=0, num=None):
    x = _t(x)
    return list(torch.unbind(x, dim=axis))


def _linspace(start, stop, num):
    return torch.linspace(float(start), float(stop), int(num),
                          dtype=torch.float32)


def _arange(start, stop=None, step=1):
    vals = (start,) if stop is None else (start, stop, step)
    is_int = all(isinstance(v, (int, numpy.integer)) for v in vals)
    dt = torch.int32 if is_int else torch.float32
    if stop is None:
        return torch.arange(start, dtype=dt)
    return torch.arange(start, stop, step, dtype=dt)


def _full(shape, value):
    """``jnp.full``: the value's dtype (a Python int fills int32)."""
    return torch.broadcast_to(_t(value), _shape(shape)).clone()


def _meshgrid(*xs, indexing="xy"):
    return list(torch.meshgrid(*[_t(x) for x in xs], indexing=indexing))


def _slice(x, begin, size):
    """``lax.dynamic_slice``: starts clamped so the slice stays inside."""
    x = _t(x)
    sl = []
    for d, (b, s) in enumerate(zip(begin, size)):
        b = min(max(int(b), 0), x.shape[d] - int(s))
        sl.append(slice(b, b + int(s)))
    return x[tuple(sl)]


def _strided_slice(x, begin, end, strides=None):
    x = _t(x)
    strides = strides or [1] * len(begin)
    idx = []
    for d, (b, e, s) in enumerate(zip(begin, end, strides)):
        if s > 0:
            idx.append(slice(b, e, s))
        else:                       # numpy's negative stride
            n = x.shape[d]
            r = list(range(n))[slice(b, e, s)]
            idx.append(_t(numpy.asarray(r, numpy.int64)).to(
                x.device).long())
    if any(isinstance(i, torch.Tensor) for i in idx):
        out = x
        for d, i in enumerate(idx):
            out = out[(slice(None),) * d + (i,)] if isinstance(
                i, slice) else out.index_select(d, i)
        return out
    return x[tuple(idx)]


def _boolean_mask(x, mask, size):
    x, mask = _t(x), _t(mask).bool()
    flat = x.reshape((-1,) + tuple(x.shape[mask.ndim:]))
    m = mask.reshape(-1)
    sel = flat[m]
    size = int(size)
    if sel.shape[0] >= size:
        return sel[:size]
    pad = torch.zeros((size - sel.shape[0],) + tuple(sel.shape[1:]),
                      dtype=x.dtype, device=x.device)
    return torch.cat([sel, pad])


def _take_along_axis(x, idx, axis):
    """``jnp.take_along_axis`` (its default mode: out-of-bounds indices
    give NaN for floats — fill — and negative ones count from the end)."""
    x = _t(x)
    idx = _idx(idx)
    axis = int(axis) % x.ndim
    n = x.shape[axis]
    neg = idx < 0
    idx = torch.where(neg, idx + n, idx)
    oob = (idx < 0) | (idx >= n)
    shape = list(torch.broadcast_shapes(
        tuple(x.shape[:axis]) + (1,) + tuple(x.shape[axis + 1:]),
        tuple(idx.shape[:axis]) + (1,) + tuple(idx.shape[axis + 1:])))
    shape[axis] = idx.shape[axis]
    xs = list(shape)
    xs[axis] = n
    out = torch.gather(x.expand(xs), axis, idx.clamp(0, n - 1).expand(shape))
    return _fill_oob(out, oob.expand(shape))


def _fill_oob(out, oob):
    """JAX's gather fill for out-of-bounds indices: NaN for floats, the
    type's minimum for signed ints (its maximum for unsigned), True for
    bools."""
    if out.is_floating_point() or out.is_complex():
        fill = float("nan")
    elif out.dtype == torch.bool:
        fill = True
    elif out.dtype == torch.uint8:
        fill = 255
    else:
        fill = torch.iinfo(out.dtype).min
    return torch.where(oob, torch.full((), fill, dtype=out.dtype,
                                       device=out.device), out)


def _take(x, indices, axis=None, mode=None):
    """``jnp.take`` (default mode "fill": an out-of-bounds index gives the
    fill value; negative ones count from the end)."""
    x = _t(x)
    idx = _idx(indices)
    if axis is None:
        x, axis = x.reshape(-1), 0
    axis = int(axis) % x.ndim
    n = x.shape[axis]
    idx = torch.where(idx < 0, idx + n, idx)
    oob = (idx < 0) | (idx >= n)
    safe = idx.clamp(0, max(n - 1, 0))
    out = x[(slice(None),) * axis + (safe,)]
    shp = (1,) * axis + tuple(oob.shape) + (1,) * (x.ndim - axis - 1)
    return _fill_oob(out, oob.reshape(shp))


def _gather(x, indices, axis=0):
    return _take(x, indices, axis=int(axis))


def _one_hot(idx, depth, on=1.0, off=0.0):
    idx = _idx(idx)
    depth = int(depth)
    oh = (idx[..., None] == torch.arange(depth, device=idx.device)).float()
    return oh * (on - off) + off


def _searchsorted(a, v, side="left"):
    a, v = _t(a), _t(v)
    v = v.to(a.dtype)
    return _i32(torch.searchsorted(a, v, right=(side == "right")))


def _diag(x):
    x = _t(x)
    if x.ndim <= 1:
        return torch.diag(x) if x.ndim == 1 else torch.diag(x.reshape(1))
    return torch.diag(x.reshape(-1))


def _assign(x, y):
    x = _t(x)
    return torch.broadcast_to(_t(y), x.shape).to(x.dtype).clone()


def _count_zero(x, *axes):
    x = _t(x)
    total = _math.prod(x.shape[a] for a in axes) if axes else x.numel()
    return total - _count_nonzero(x, axes if axes else None)


def _segment(reducer):
    def f(data, ids, num_segments, **_):
        data = _t(data)
        ids = _idx(ids)
        n = int(num_segments)
        keep = (ids >= 0) & (ids < n)
        ids_c = ids.clamp(0, n - 1)
        shape = (n,) + tuple(data.shape[1:])
        idx = ids_c.reshape((-1,) + (1,) * (data.ndim - 1)).expand(
            data.shape)
        kshape = (-1,) + (1,) * (data.ndim - 1)
        if reducer == "sum":
            src = torch.where(keep.reshape(kshape), data, torch.zeros(
                (), dtype=data.dtype, device=data.device))
            out = torch.zeros(shape, dtype=data.dtype, device=data.device)
            return out.scatter_add(0, idx, src)
        ident = {"prod": 1, "amax": _lowest(data.dtype),
                 "amin": _highest(data.dtype)}[reducer]
        src = torch.where(keep.reshape(kshape), data, torch.full(
            (), ident, dtype=data.dtype, device=data.device))
        out = torch.full(shape, ident, dtype=data.dtype, device=data.device)
        return out.scatter_reduce(0, idx, src, reduce=reducer,
                                  include_self=True)
    return f


def _lowest(dt):
    if dt.is_floating_point:
        return float("-inf")
    return torch.iinfo(dt).min if dt != torch.bool else False


def _highest(dt):
    if dt.is_floating_point:
        return float("inf")
    return torch.iinfo(dt).max if dt != torch.bool else True


_seg_sum, _seg_prod = _segment("sum"), _segment("prod")
_seg_max, _seg_min = _segment("amax"), _segment("amin")


def _seg_mean(data, ids, num_segments):
    data = _t(data)
    s = _seg_sum(data, ids, num_segments)
    c = _seg_sum(torch.ones_like(data), ids, num_segments)
    return s / torch.clamp_min(c, 1)


def _sort(x, axis=-1, descending=False):
    x = _t(x)
    if descending:
        return -torch.sort(-x, dim=axis, stable=True).values
    return torch.sort(x, dim=axis, stable=True).values


def _argsort(x, axis=-1):
    return _i32(torch.sort(_t(x), dim=axis, stable=True).indices)


def _in_top_k(predictions, targets, k):
    idx = torch.topk(_t(predictions), int(k), dim=-1).indices
    return torch.any(idx == _idx(targets)[..., None], dim=-1)


def _clip(x, lo=None, hi=None):
    x = _t(x)
    lo = None if lo is None else _t(lo)
    hi = None if hi is None else _t(hi)
    if lo is not None and not (x.is_floating_point() or x.is_complex()) \
            and lo.is_floating_point():
        x = x.float()
    if hi is not None and not (x.is_floating_point() or x.is_complex()) \
            and hi.is_floating_point():
        x = x.float()
    out = x
    if lo is not None:
        out = torch.maximum(out, lo.to(out.dtype))
    if hi is not None:
        out = torch.minimum(out, hi.to(out.dtype))
    return out


def _nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    x = _t(x)
    if not x.is_floating_point():
        return x
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


def _invert_permutation(p):
    return _argsort(p)


def _reshape(x, shape):
    shape = _axes(shape)
    return _t(x).reshape(shape if isinstance(shape, tuple) else (shape,))


def _transpose(x, *axes):
    x = _t(x)
    if not axes:
        return x.permute(*reversed(range(x.ndim)))
    if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
        axes = tuple(axes[0])
    return x.permute(*axes)


def _squeeze(x, axis=None):
    x = _t(x)
    if axis is None:
        return x.squeeze()
    axes = _axes(axis)
    return x.squeeze(axes if isinstance(axes, int) else tuple(axes))


def _broadcast_to(x, shape):
    return torch.broadcast_to(_t(x), _axes(shape)).clone()


def _tile(x, reps):
    reps = _axes(reps)
    return torch.tile(_t(x), reps if isinstance(reps, tuple) else (reps,))


def _repeat(x, repeats, axis=None):
    x = _t(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    r = repeats if isinstance(repeats, int) else _idx(repeats)
    return torch.repeat_interleave(x, r, dim=axis)


def _eye(n, m=None, dtype=torch.float32):
    return torch.eye(int(n), int(n) if m is None else int(m),
                     dtype=dtype_of(dtype))


def _cast(x, dtype):
    x = _t(x)
    dt = dtype_of(dtype)
    if dt == torch.bool:
        return x != 0
    if x.is_floating_point() and not (dt.is_floating_point
                                      or dt.is_complex):
        t = x.trunc()
        if dt == torch.uint8:       # XLA saturates a float into uint8
            t = t.clamp(0, 255)
        return t.to(dt)
    return x.to(dt)


BASE = {
    # shape surgery
    "reshape": _reshape,
    "permute": _transpose,
    "transpose": _transpose,
    "expand_dims": lambda x, axis: torch.unsqueeze(_t(x), int(axis)),
    "squeeze": _squeeze,
    "concat": lambda *xs, axis=0: torch.cat(_promote(*[_t(x) for x in xs]),
                                            dim=int(axis)),
    "stack": lambda *xs, axis=0: torch.stack(_promote(*[_t(x) for x in xs]),
                                             dim=int(axis)),
    "parallel_stack": lambda *xs: torch.stack(_promote(*[_t(x) for x in xs]),
                                              dim=0),
    "unstack": _unstack,
    "split": _split,
    "tile": _tile,
    "repeat": _repeat,
    "pad": _pad,
    "reverse": _flip,
    "flip": _flip,
    "roll": _roll,
    "broadcast_to": _broadcast_to,
    "moveaxis": lambda x, src, dst: torch.movedim(_t(x), src, dst),
    "swapaxes": lambda x, a, b: torch.swapaxes(_t(x), int(a), int(b)),
    "ravel": lambda x: _t(x).reshape(-1),
    "atleast_2d": lambda x: torch.atleast_2d(_t(x)),
    # creation
    "zeros_like": lambda x: torch.zeros_like(_t(x)),
    "ones_like": lambda x: torch.ones_like(_t(x)),
    "full_like": lambda x, v: torch.full_like(_t(x), v),
    "eye": lambda n, m=None: _eye(n, m),
    "fill": _full,
    "linspace": _linspace,
    "range": _arange,
    "meshgrid": _meshgrid,
    # dtype / identity
    "cast": _cast,
    "identity": lambda x: _t(x),
    "shape_of": lambda x: _t(numpy.asarray(tuple(_t(x).shape), numpy.int32)),
    "size": lambda x: _t(numpy.int32(_t(x).numel())),
    "size_at": lambda x, dim: _t(numpy.int32(_t(x).shape[int(dim)])),
    "rank": lambda x: _t(numpy.int32(_t(x).ndim)),
    # indexing / gather / scatter
    "gather": _gather,
    "gather_nd": _gather_nd,
    "scatter_update": _scatter("set"),
    "scatter_add": _scatter("add"),
    "scatter_sub": lambda ref, i, u: _scatter("add")(ref, i, -_t(u)),
    "scatter_mul": _scatter("multiply"),
    "scatter_div": _scatter("divide"),
    "scatter_max": _scatter("max"),
    "scatter_min": _scatter("min"),
    "scatter_nd": _scatter_nd,
    "slice": _slice,
    "strided_slice": _strided_slice,
    "where": _where,
    "boolean_mask": _boolean_mask,
    "take_along_axis": _take_along_axis,
    "one_hot": _one_hot,
    "searchsorted": _searchsorted,
    "diag": _diag,
    "diag_part": lambda x: torch.diagonal(_t(x), dim1=-2, dim2=-1).clone(),
    "trace": lambda x: _int_acc(_t(x), torch.diagonal(
        _t(x), dim1=-2, dim2=-1).sum(-1)),
    "tril": lambda x, k=0: torch.tril(_t(x), int(k)),
    "triu": lambda x, k=0: torch.triu(_t(x), int(k)),
    # reductions
    "sum": lambda x, *axes, keepdims=False: _sum(x, axes, keepdims),
    "mean": lambda x, *axes, keepdims=False: _mean(x, axes, keepdims),
    "prod": lambda x, *axes, keepdims=False: _prod(x, axes, keepdims),
    "max": lambda x, *axes, keepdims=False: _amax(x, axes, keepdims),
    "min": lambda x, *axes, keepdims=False: _amin(x, axes, keepdims),
    "std": lambda x, *axes, ddof=0, keepdims=False: _std(x, axes, ddof,
                                                         keepdims),
    "variance": lambda x, *axes, ddof=0, keepdims=False: _var(x, axes, ddof,
                                                              keepdims),
    "norm1": lambda x, *axes: _sum(torch.abs(_t(x)), axes),
    "norm2": lambda x, *axes: torch.sqrt(_fl(_sum(torch.square(_t(x)),
                                                  axes))),
    "norm_max": lambda x, *axes: _amax(torch.abs(_t(x)), axes),
    "squared_norm": lambda x, *axes: _sum(torch.square(_t(x)), axes),
    "count_nonzero": lambda x, *axes: _count_nonzero(x, axes or None),
    "count_zero": _count_zero,
    "any": lambda x, *axes: _any(x, axes),
    "all": lambda x, *axes: _alls(x, axes),
    "argmax": lambda x, axis=-1: _argmax(x, axis),
    "argmin": lambda x, axis=-1: _argmin(x, axis),
    "iamax": lambda x: _argmax(torch.abs(_t(x))),
    "iamin": lambda x: _argmin(torch.abs(_t(x))),
    "cumsum": _cumsum,
    "cumprod": _cumprod,
    "logsumexp": lambda x, *axes: _logsumexp(x, axes),
    # segment ops (static num_segments)
    "segment_sum": _seg_sum,
    "segment_prod": _seg_prod,
    "segment_max": _seg_max,
    "segment_min": _seg_min,
    "segment_mean": _seg_mean,
    "unsorted_segment_sum": _seg_sum,
    # sorting & sets
    "sort": _sort,
    "argsort": _argsort,
    "top_k": _top_k,
    "unique": lambda x, size: _unique_sized(x, size)[0],
    "unique_with_counts": _unique_with_counts,
    "in_top_k": _in_top_k,
    # matmul family
    "mmul": _matmul,
    "matmul": _matmul,
    "batch_mmul": _batch_mmul,
    "tensor_mmul": _tensordot,
    "dot": _dot,
    "vdot": _vdot,
    "outer": _outer,
    "kron": _kron,
    "cross": _cross,
    "einsum": _einsum,
    # batch/space rearrangement
    "space_to_depth": _space_to_depth,
    "depth_to_space": _depth_to_space,
    # misc
    "dynamic_partition": _dynamic_partition,
    "dynamic_stitch": _dynamic_stitch,
    "sequence_mask": _sequence_mask,
    "reverse_sequence": _reverse_sequence,
    "confusion_matrix": _confusion_matrix,
    "clip_by_value": _clip,
    "clip_by_norm": _clip_by_norm,
    "clip_by_global_norm": _clip_by_global_norm,
    "stop_gradient": lambda x: _t(x).detach(),
    "assign": _assign,
    "invert_permutation": _invert_permutation,
    "bincount": lambda x, length: _bincount(x, length),
    "nan_to_num": _nan_to_num,
}

# ------------------------------------------------------------------ SDMath


def _floor_divide(a, b):
    a, b = _bin(a, b)
    if a.is_floating_point() or b.is_floating_point():
        return torch.floor(a / b)
    return torch.floor_divide(a, b)


def _remainder(a, b):
    a, b = _bin(a, b)
    return torch.remainder(a, b)


def _fmod(a, b):
    a, b = _bin(a, b)
    return torch.fmod(a, b)


def _trunc_div(a, b):
    a, b = _bin(a, b)
    return torch.trunc(_fl(a) / b)


def _cos_sim(a, b, axis=-1):
    a, b = _t(a), _t(b)
    return torch.sum(a * b, axis) / torch.clamp_min(
        torch.linalg.vector_norm(a, dim=axis)
        * torch.linalg.vector_norm(b, dim=axis), 1e-12)


def _is_close(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
    a, b = _promote(_fl(a), _fl(b))
    return torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


def _heaviside(x, v):
    x, v = _bin(x, v)
    return torch.heaviside(x, v.to(x.dtype))


def _ldexp(x, e):
    x = _fl(x)
    return x * torch.pow(2.0, _t(e).to(x.dtype))


def _frexp(x):
    m, e = torch.frexp(_fl(x))
    return m, _i32(e)


def _moving_average(x, n):
    x = _fl(x)
    n = int(n)
    k = torch.ones(n, dtype=x.dtype, device=x.device) / n
    return F.conv1d(x.reshape(1, 1, -1), k.reshape(1, 1, -1)).reshape(-1)


def _diff(x, n=1, axis=-1):
    x = _t(x)
    out = x
    for _ in range(n):
        out = torch.diff(out.int() if out.dtype == torch.bool else out,
                         dim=axis) if out.dtype != torch.bool else \
            torch.diff(out, dim=axis)
    return out


def _interp(x, xp, fp):
    """``jnp.interp``: piecewise-linear, flat outside [xp[0], xp[-1]]."""
    x, xp, fp = _fl(x), _fl(xp), _fl(fp)
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1,
                    xp.shape[0] - 1)
    x0, x1 = xp[i - 1], xp[i]
    y0, y1 = fp[i - 1], fp[i]
    dx = x1 - x0
    w = torch.where(dx != 0, (x - x0) / torch.where(dx != 0, dx, 1.0), 0.0)
    out = y0 + w * (y1 - y0)
    out = torch.where(x < xp[0], fp[0], out)
    return torch.where(x > xp[-1], fp[-1], out)


def _logaddexp(a, b):
    a, b = _promote(_fl(a), _fl(b))
    return torch.logaddexp(a, b)


def _hamming(a, b, axis=-1):
    return torch.sum((_t(a) != _t(b)).float(), axis)


def _jaccard(a, b, axis=-1):
    a, b = _t(a), _t(b)
    return 1.0 - (torch.sum(torch.minimum(a, b), axis) / torch.clamp_min(
        torch.sum(torch.maximum(a, b), axis), 1e-12))


def _is_numeric(x):
    x = _t(x)
    return _t(numpy.bool_(x.dtype != torch.bool))


def _is_max(x):
    x = _t(x)
    return x == torch.max(x)


def _polygamma(n, x):
    return torch.special.polygamma(int(n), _fl(x))


def _betaln(a, b):
    a, b = _promote(_fl(a), _fl(b))
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def _gamma_fn(x):
    """Γ(x): exp(lnΓ) with Γ's sign on the negative axis."""
    x = _fl(x)
    sign = torch.where((x < 0) & (torch.remainder(torch.floor(x), 2) == 1),
                       -1.0, 1.0).to(x.dtype)
    return sign * torch.exp(torch.lgamma(x))


def _betainc(a, b, x):
    """The regularized incomplete beta I_x(a, b): Lentz's continued
    fraction (Numerical Recipes' betacf), in float64 and back."""
    a, b, x = torch.broadcast_tensors(_fl(a), _fl(b), _fl(x))
    dt = a.dtype
    a, b, x = a.double(), b.double(), x.double()
    swap = x > (a + 1.0) / (a + b + 2.0)
    aa = torch.where(swap, b, a)
    bb = torch.where(swap, a, b)
    xx = torch.where(swap, 1.0 - x, x)
    tiny = 1e-300
    qab, qap, qam = aa + bb, aa + 1.0, aa - 1.0
    c = torch.ones_like(xx)
    d = 1.0 - qab * xx / qap
    d = torch.where(d.abs() < tiny, tiny, d)
    d = 1.0 / d
    h = d
    for m in range(1, 300):
        m2 = 2 * m
        an = m * (bb - m) * xx / ((qam + m2) * (aa + m2))
        d = 1.0 + an * d
        d = torch.where(d.abs() < tiny, tiny, d)
        c = 1.0 + an / c
        c = torch.where(c.abs() < tiny, tiny, c)
        d = 1.0 / d
        h = h * d * c
        an = -(aa + m) * (qab + m) * xx / ((aa + m2) * (qap + m2))
        d = 1.0 + an * d
        d = torch.where(d.abs() < tiny, tiny, d)
        c = 1.0 + an / c
        c = torch.where(c.abs() < tiny, tiny, c)
        d = 1.0 / d
        h = h * d * c
    lbeta = torch.lgamma(aa + bb) - torch.lgamma(aa) - torch.lgamma(bb)
    front = torch.exp(lbeta + aa * torch.log(xx.clamp_min(tiny))
                      + bb * torch.log1p(-xx)) / aa
    val = front * h
    val = torch.where(swap, 1.0 - val, val)
    val = torch.where(x <= 0, 0.0, torch.where(x >= 1, 1.0, val))
    return val.to(dt)


def _spence(x):
    """Spence's function (scipy's convention: ∫₁ˣ log t / (1 − t) dt),
    Cephes' rational approximation, in float64 and back."""
    x = _fl(x)
    dt = x.dtype
    x0 = x.double()
    A = [4.65128586073990045278E-5, 7.31589045238094711071E-3,
         1.33847639578309018650E-1, 8.79691311754530315341E-1,
         2.71149851196553469920E0, 4.25697156008121755724E0,
         3.29771340985225106936E0, 1.00000000000000000126E0]
    B = [6.90990488912553276999E-4, 2.54043763932544379113E-2,
         2.82974860602568089943E-1, 1.41172597751831069617E0,
         3.63800533345137075418E0, 5.03278880143316990390E0,
         3.54771340985225096217E0, 9.99999999999999998740E-1]

    def polevl(v, coef):
        out = torch.zeros_like(v)
        for cf in coef:
            out = out * v + cf
        return out

    safe = torch.where(x0 > 0, x0, torch.ones_like(x0))
    inv = safe > 2.0
    x1 = torch.where(inv, 1.0 / safe, safe)
    gt15 = x1 > 1.5
    lt05 = (~gt15) & (x1 < 0.5)
    w = torch.where(gt15, 1.0 / x1 - 1.0, torch.where(lt05, -x1, x1 - 1.0))
    y = -w * polevl(w, A) / polevl(w, B)
    y = torch.where(lt05, (_math.pi ** 2) / 6.0 - torch.log(x1)
                    * torch.log1p(-x1) - y, y)
    z = torch.log(x1)
    y = torch.where(inv | gt15, -0.5 * z * z - y, y)
    y = torch.where(x0 == 1.0, 0.0, y)
    y = torch.where(x0 == 0.0, (_math.pi ** 2) / 6.0, y)
    y = torch.where(x0 < 0.0, float("nan"), y)
    return y.to(dt)


def _rel_entr(x, y):
    x, y = _promote(_fl(x), _fl(y))
    out = x * torch.log(x / y)
    out = torch.where((x > 0) & (y > 0), out, torch.where(
        (x == 0) & (y >= 0), 0.0, float("inf")).to(out.dtype))
    return out


def _kl_div(x, y):
    x, y = _promote(_fl(x), _fl(y))
    out = x * torch.log(x / y) - x + y
    out = torch.where((x > 0) & (y > 0), out, torch.where(
        (x == 0) & (y >= 0), y, torch.full_like(y, float("inf"))))
    return out


def _entr(x):
    x = _fl(x)
    return torch.where(x > 0, -x * torch.log(x), torch.where(
        x == 0, 0.0, float("-inf")).to(x.dtype))


def _xlogy(x, y):
    x, y = _promote(_fl(x), _fl(y))
    return torch.special.xlogy(x, y)


def _igamma(a, x):
    a, x = _promote(_fl(a), _fl(x))
    return torch.special.gammainc(a, x)


def _igammac(a, x):
    a, x = _promote(_fl(a), _fl(x))
    return torch.special.gammaincc(a, x)


def _zeta(x, q):
    x, q = _promote(_fl(x), _fl(q))
    return torch.special.zeta(x, q)


def _atan2(a, b):
    a, b = _promote(_fl(a), _fl(b))
    return torch.atan2(a, b)


def _copysign(a, b):
    a, b = _promote(_fl(a), _fl(b))
    return torch.copysign(a, b)


def _hypot(a, b):
    a, b = _promote(_fl(a), _fl(b))
    return torch.hypot(a, b)


def _cbrt(x):
    x = _fl(x)
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


MATH_EXT = {
    # inverse/hyperbolic trig
    "atan2": _atan2, "asinh": _unop(torch.asinh, True),
    "acosh": _unop(torch.acosh, True), "atanh": _unop(torch.atanh, True),
    # exp/log family
    "expm1": _unop(torch.expm1, True), "log2": _unop(torch.log2, True),
    "log10": _unop(torch.log10, True), "rsqrt": _unop(torch.rsqrt, True),
    "cbrt": _cbrt, "exp2": _unop(torch.exp2, True),
    "logaddexp": _logaddexp,
    # special functions
    "erfc": _unop(torch.special.erfc, True),
    "erfinv": _unop(torch.special.erfinv, True),
    "lgamma": _unop(torch.lgamma, True),
    "digamma": _unop(torch.special.digamma, True),
    "polygamma": _polygamma,
    "igamma": _igamma, "igammac": _igammac, "zeta": _zeta,
    "betainc": _betainc, "xlogy": _xlogy, "entr": _entr,
    "logit": _unop(torch.special.logit, True),
    "expit": _unop(torch.special.expit, True),
    # integer-ish arithmetic
    "mod": _remainder, "fmod": _fmod, "floor_div": _floor_divide,
    "floor_mod": _remainder, "truncate_div": _trunc_div,
    "rdiv": lambda a, b: _binop(torch.true_divide)(b, a),
    "rsub": lambda a, b: _binop(torch.sub)(b, a),
    "remainder": _remainder,
    # comparisons & predicates
    "eq": _binop(torch.eq), "neq": _binop(torch.ne), "gt": _binop(torch.gt),
    "gte": _binop(torch.ge), "lt": _binop(torch.lt), "lte": _binop(torch.le),
    "is_finite": _unop(torch.isfinite), "is_nan": _unop(torch.isnan),
    "is_inf": _unop(torch.isinf),
    "is_numeric_tensor": _is_numeric,
    "is_close": _is_close,
    "is_max": _is_max,
    # logical
    "logical_and": _binop(torch.logical_and),
    "logical_or": _binop(torch.logical_or),
    "logical_xor": _binop(torch.logical_xor),
    "logical_not": _unop(torch.logical_not),
    # pairwise distances / similarities
    "cosine_similarity": _cos_sim,
    "cosine_distance": lambda a, b, axis=-1: 1.0 - _cos_sim(a, b, axis),
    "euclidean_distance": lambda a, b, axis=-1: torch.sqrt(torch.sum(
        torch.square(_t(a) - _t(b)), axis)),
    "manhattan_distance": lambda a, b, axis=-1: torch.sum(torch.abs(
        _t(a) - _t(b)), axis),
    "hamming_distance": _hamming,
    "jaccard_distance": _jaccard,
    "squared_difference": lambda a, b: torch.square(_binop(torch.sub)(a, b)),
    # rounding & manipulation
    "trunc": _unop(torch.trunc), "rint": _unop(torch.round),
    "copysign": _copysign, "heaviside": _heaviside,
    "deg2rad": _unop(torch.deg2rad, True),
    "rad2deg": _unop(torch.rad2deg, True),
    "hypot": _hypot, "ldexp": _ldexp, "frexp": _frexp,
    "step": lambda x: (_t(x) > 0).to(_t(x).dtype),
    "moving_average": _moving_average,
    "diff": _diff,
    "interp": _interp,
}

# ---------------------------------------------------------------- SDLinalg


def _solve_triangular(a, b, lower=True):
    a, b = _promote(_t(a), _t(b))
    vec = b.ndim == a.ndim - 1
    if vec:
        b = b[..., None]
    out = torch.linalg.solve_triangular(a, b, upper=not lower)
    return out[..., 0] if vec else out


def _qr(a, mode="reduced"):
    q, r = torch.linalg.qr(_t(a), mode=mode)
    return q, r


def _svd(a, full_matrices=True, compute_uv=True):
    a = _t(a)
    if not compute_uv:
        return torch.linalg.svdvals(a)
    u, s, vh = torch.linalg.svd(a, full_matrices=full_matrices)
    return u, s, vh


def _eigh(a):
    w, v = torch.linalg.eigh(_t(a))
    return w, v


def _lstsq(a, b, rcond=None):
    a, b = _promote(_t(a), _t(b))
    vec = b.ndim == 1
    bb = b[:, None] if vec else b
    sol = torch.linalg.pinv(a) @ bb
    resid = torch.sum(torch.square(a @ sol - bb), 0)
    rank = _i32(torch.linalg.matrix_rank(a))
    s = torch.linalg.svdvals(a)
    return (sol[:, 0] if vec else sol), resid, rank, s


def _slogdet(x):
    s, l = torch.linalg.slogdet(_t(x))
    return s, l


def _matrix_rank(x, tol=None):
    return _i32(torch.linalg.matrix_rank(_t(x), atol=tol))


def _norm(x, ord=None, axis=None, keepdims=False):  # noqa: A002
    x = _fl(x)
    if axis is None and ord is None:
        return torch.linalg.vector_norm(x.reshape(-1), keepdim=False) \
            if not keepdims else torch.linalg.vector_norm(
                x, dim=tuple(range(x.ndim)), keepdim=True)
    if axis is None:
        axis = tuple(range(x.ndim)) if x.ndim <= 2 else None
    axis = _axes(axis)
    if isinstance(axis, tuple) and len(axis) == 2:
        return torch.linalg.matrix_norm(x, ord="fro" if ord is None else ord,
                                        dim=axis, keepdim=keepdims)
    return torch.linalg.vector_norm(x, ord=2 if ord is None else ord,
                                    dim=axis, keepdim=keepdims)


def _lu(a):
    p, l, u = torch.linalg.lu(_t(a))
    return p, l, u


def _lu_factor(a):
    lu, piv = torch.linalg.lu_factor(_t(a))
    return lu, _i32(piv) - 1


def _lu_solve(a, b):
    a, b = _promote(_t(a), _t(b))
    lu, piv = torch.linalg.lu_factor(a)
    vec = b.ndim == a.ndim - 1
    bb = b[..., None] if vec else b
    out = torch.linalg.lu_solve(lu, piv, bb)
    return out[..., 0] if vec else out


def _cho_factor(a, lower=True):
    """The Cholesky factor, the other triangle zero (as JAX returns it)."""
    return torch.linalg.cholesky(_t(a), upper=not lower)


def _cho_solve(c, b, lower=True):
    c, b = _promote(_t(c), _t(b))
    c = torch.tril(c) if lower else torch.triu(c)
    vec = b.ndim == c.ndim - 1
    bb = b[..., None] if vec else b
    out = torch.cholesky_solve(bb, c, upper=not lower)
    return out[..., 0] if vec else out


def _sqrtm(a):
    """Principal square root through the eigendecomposition; complex, as
    JAX's ``sqrtm`` returns it."""
    a = _t(a)
    w, v = torch.linalg.eig(a)
    r = v @ torch.diag_embed(torch.sqrt(w)) @ torch.linalg.inv(v)
    return r.to(torch.complex64 if a.dtype in (torch.float32, torch.float16,
                                               torch.bfloat16)
                else torch.complex128)


def _toeplitz(c, r=None):
    c = _t(c).reshape(-1)
    r = c.conj() if r is None else _t(r).reshape(-1)
    n, m = c.shape[0], r.shape[0]
    vals = torch.cat([r.flip(0)[:-1], c]) if r.shape[0] > 0 else c
    i = torch.arange(n, device=c.device)[:, None]
    j = torch.arange(m, device=c.device)[None, :]
    return vals[(m - 1) + i - j]


def _block_diag(*ms):
    return torch.block_diag(*_promote(*[torch.atleast_2d(_t(m))
                                        for m in ms]))


def _matrix_power(x, n):
    return torch.linalg.matrix_power(_t(x), int(n))


def _tri(n, m=None, k=0):
    n = int(n)
    m = n if m is None else int(m)
    return torch.tril(torch.ones((n, m), dtype=torch.float32), int(k))


def _matrix_diag(d):
    d = _t(d)
    return d[..., None] * torch.eye(d.shape[-1], dtype=d.dtype,
                                    device=d.device)


LINALG = {
    "cholesky": lambda x: torch.linalg.cholesky(_t(x)),
    "qr": _qr,
    "svd": _svd,
    "eigh": _eigh,
    "eigvalsh": lambda x: torch.linalg.eigvalsh(_t(x)),
    "solve": lambda a, b: torch.linalg.solve(*_promote(_t(a), _t(b))),
    "lstsq": _lstsq,
    "inv": lambda x: torch.linalg.inv(_t(x)),
    "pinv": lambda x: torch.linalg.pinv(_t(x)),
    "det": lambda x: torch.linalg.det(_t(x)),
    "slogdet": _slogdet,
    "matrix_rank": _matrix_rank,
    "norm": _norm,
    "matrix_power": _matrix_power,
    "triangular_solve": _solve_triangular,
    "expm": lambda x: torch.linalg.matrix_exp(_t(x)),
    "matrix_transpose": lambda x: torch.swapaxes(_t(x), -1, -2),
    "matrix_diag": _matrix_diag,
    "matrix_diag_part": lambda x: torch.diagonal(_t(x), dim1=-2,
                                                 dim2=-1).clone(),
    "logdet": lambda x: torch.linalg.slogdet(_t(x))[1],
    "mmul": _matmul,
    "tri": _tri,
}

# ---------------------------------------------------------------- SDBitwise


def _shift_right_logical(x, n):
    """A logical right shift of a signed tensor: the high bits that an
    arithmetic shift fills with the sign are cleared."""
    x = _t(x)
    n = _like(n, x) if not isinstance(n, torch.Tensor) else n.to(x.dtype)
    bits = x.element_size() * 8
    wide = x.long() & ((1 << bits) - 1)
    out = torch.where(n >= bits, torch.zeros_like(wide), wide >> n.long())
    return _wrap_to(out, x.dtype, bits)


def _wrap_to(v, dtype, bits):
    """An int64 tensor of ``bits``-bit patterns back into ``dtype``."""
    v = v & ((1 << bits) - 1)
    if dtype in (torch.int8, torch.int16, torch.int32):
        v = torch.where(v >= (1 << (bits - 1)), v - (1 << bits), v)
    return v.to(dtype)


def _shift_left(x, n):
    x, n = _bin(x, n)
    bits = x.element_size() * 8
    out = torch.where(n.long() >= bits, torch.zeros_like(x.long()),
                      x.long() << n.long().clamp(0, 63))
    return _wrap_to(out, x.dtype, bits)


def _shift_right(x, n):
    x, n = _bin(x, n)
    bits = x.element_size() * 8
    sh = n.long().clamp(0, bits - 1)
    return (x.long() >> sh).to(x.dtype)


def _popcount(x):
    x = _t(x)
    c = torch.zeros_like(x)
    for i in range(x.element_size() * 8):
        c = c + ((x >> i) & 1)
    return c


def _cyclic_left(x, n, bits=32):
    x = _t(x)
    return _shift_left(x, n) | _shift_right_logical(x, bits - n)


def _cyclic_right(x, n, bits=32):
    x = _t(x)
    return _shift_right_logical(x, n) | _shift_left(x, bits - n)


BITWISE = {
    "and_": _binop(torch.bitwise_and), "or_": _binop(torch.bitwise_or),
    "xor": _binop(torch.bitwise_xor), "invert": _unop(torch.bitwise_not),
    "left_shift": _shift_left, "right_shift": _shift_right,
    "bits_hamming_distance": lambda a, b: _sum(_popcount(
        _binop(torch.bitwise_xor)(a, b))),
    "bit_count": _popcount,
    "cyclic_shift_left": _cyclic_left,
    "cyclic_shift_right": _cyclic_right,
}


# ----------------------------------------------------------------- SDRandom
# The first argument is a ``torch.Generator`` (the reference's JAX key).

def _shape(s):
    s = _axes(s)
    if s is None:
        return ()
    return (int(s),) if isinstance(s, (int, numpy.integer)) else tuple(
        int(v) for v in s)


def _gdev(gen):
    return gen.device if gen is not None else torch.device("cpu")


def _uniform(gen, shape, lo=0.0, hi=1.0, dtype=torch.float32):
    u = torch.rand(_shape(shape), generator=gen, dtype=dtype,
                   device=_gdev(gen))
    return u * (hi - lo) + lo


def _normal(gen, shape, dtype=torch.float32):
    return torch.randn(_shape(shape), generator=gen, dtype=dtype,
                       device=_gdev(gen))


def _truncated_normal(gen, shape, lo=-2.0, hi=2.0):
    t = torch.empty(_shape(shape), dtype=torch.float32, device=_gdev(gen))
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, lo, hi, generator=gen)
    return t


def _bernoulli(gen, p, shape):
    p = _t(p, torch.float32).to(_gdev(gen))
    u = torch.rand(_shape(shape), generator=gen, device=_gdev(gen))
    return u < p


def _std_gamma(gen, alpha, shape):
    """Γ(α, 1) draws by Marsaglia and Tsang's method (α < 1 boosted by
    U^(1/α)), rejection rounds until every element is accepted."""
    dev = _gdev(gen)
    alpha = _t(alpha, torch.float32).to(dev)
    shape = _shape(shape) or tuple(alpha.shape)
    a = torch.broadcast_to(alpha, shape)
    boost = a < 1.0
    aa = torch.where(boost, a + 1.0, a)
    d = aa - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    todo = torch.ones(shape, dtype=torch.bool, device=dev)
    while bool(todo.any()):
        x = torch.randn(shape, generator=gen, device=dev)
        v = (1.0 + c * x) ** 3
        u = torch.rand(shape, generator=gen, device=dev)
        ok = (v > 0) & (torch.log(u.clamp_min(1e-30))
                        < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp_min(1e-30)))
        take = ok & todo
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    u = torch.rand(shape, generator=gen, device=dev)
    return torch.where(boost, out * u.clamp_min(1e-30) ** (1.0 / a), out)


def _poisson(gen, lam, shape):
    dev = _gdev(gen)
    lam = torch.broadcast_to(_t(lam, torch.float32).to(dev),
                             _shape(shape) or tuple(_t(lam).shape))
    return _i32(torch.poisson(lam.contiguous(), generator=gen))


def _beta(gen, a, b, shape):
    x = _std_gamma(gen, a, shape)
    y = _std_gamma(gen, b, shape)
    return x / (x + y)


def _randint(gen, shape, lo, hi):
    return _i32(torch.randint(int(lo), int(hi), _shape(shape),
                              generator=gen, device=_gdev(gen)))


def _shuffle(gen, x, axis=0):
    x = _t(x)
    perm = torch.randperm(x.shape[axis], generator=gen,
                          device=_gdev(gen)).to(x.device)
    return x.index_select(axis, perm)


def _permutation(gen, n):
    return _i32(torch.randperm(int(n), generator=gen, device=_gdev(gen)))


def _choice(gen, x, shape, replace=True):
    x = _t(x)
    if x.ndim == 0:
        x = torch.arange(int(x), dtype=torch.int32, device=_gdev(gen))
    n = x.shape[0]
    k = _math.prod(_shape(shape))
    if replace:
        i = torch.randint(0, n, (k,), generator=gen, device=_gdev(gen))
    else:
        i = torch.randperm(n, generator=gen, device=_gdev(gen))[:k]
    return x[i.to(x.device)].reshape(_shape(shape) + tuple(x.shape[1:]))


def _gumbel(gen, shape):
    u = torch.rand(_shape(shape), generator=gen, device=_gdev(gen))
    return -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))


def _categorical(gen, logits, shape=(), axis=-1):
    logits = _fl(logits)
    shape = _shape(shape)
    batch = tuple(logits.shape[:-1])
    full = shape if shape else batch
    g = _gumbel(gen, full + (logits.shape[-1],)).to(logits.device)
    return _i32(torch.argmax(logits + g, dim=-1))


def _exponential(gen, shape, rate=1.0):
    u = torch.rand(_shape(shape), generator=gen, device=_gdev(gen))
    return -torch.log1p(-u) / rate


def _laplace(gen, shape):
    u = torch.rand(_shape(shape), generator=gen, device=_gdev(gen)) * 2 - 1
    u = u.clamp(-1 + 1e-7, 1 - 1e-7)
    return -torch.sign(u) * torch.log1p(-torch.abs(u))


def _cauchy(gen, shape):
    u = torch.rand(_shape(shape), generator=gen, device=_gdev(gen))
    return torch.tan(_math.pi * (u.clamp(1e-7, 1 - 1e-7) - 0.5))


RANDOM = {
    "uniform": lambda gen, shape, minval=0.0, maxval=1.0: _uniform(
        gen, shape, minval, maxval),
    "normal": lambda gen, shape, mean=0.0, stddev=1.0: mean + stddev
    * _normal(gen, shape),
    "log_normal": lambda gen, shape, mean=0.0, stddev=1.0: torch.exp(
        mean + stddev * _normal(gen, shape)),
    "truncated_normal": lambda gen, shape, mean=0.0, stddev=1.0: mean
    + stddev * _truncated_normal(gen, shape),
    "bernoulli": _bernoulli,
    "binomial": lambda gen, n, p, shape: _sum(
        _bernoulli(gen, p, (int(n),) + _shape(shape)), 0),
    "gamma": _std_gamma,
    "beta": _beta,
    "poisson": _poisson,
    "exponential": _exponential,
    "laplace": _laplace,
    "gumbel": _gumbel,
    "cauchy": _cauchy,
    "randint": _randint,
    "shuffle": _shuffle,
    "permutation": _permutation,
    "choice": _choice,
    "categorical": _categorical,
}

# -------------------------------------------------------------------- SDCNN


def _same_pads(in_shape, window, strides, dilation=None):
    """``lax.padtype_to_pads(..., "SAME")``: TF's asymmetric SAME, the odd
    pad on the high side."""
    pads = []
    dilation = dilation or (1,) * len(window)
    for n, k, s, d in zip(in_shape, window, strides, dilation):
        eff = (k - 1) * d + 1
        out = -(-n // s)
        total = max((out - 1) * s + eff - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _resolve_pads(padding, in_shape, window, strides, dilation=None):
    if isinstance(padding, str):
        p = padding.upper()
        if p == "VALID":
            return [(0, 0)] * len(window)
        if p in ("SAME", "SAME_LOWER"):
            pads = _same_pads(in_shape, window, strides, dilation)
            if p == "SAME_LOWER":
                pads = [(hi, lo) for lo, hi in pads]
            return pads
        raise ValueError(f"unknown padding {padding!r}")
    return [tuple(int(v) for v in p) for p in padding]


def _pad_spatial(x, pads, value=0.0):
    """Pad (or, for negative pads, crop) the spatial dims 1..n of a
    channel-last tensor."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    flat = [0, 0] + flat            # the channel dim
    if all(v == 0 for v in flat):
        return x
    return F.pad(x, flat, value=value)


def _dilate(x, rates):
    """Insert ``rate - 1`` zeros between the elements of the spatial
    dims (``lhs_dilation``)."""
    for i, r in enumerate(rates):
        if r == 1:
            continue
        d = i + 1
        n = x.shape[d]
        shape = list(x.shape)
        shape[d] = (n - 1) * r + 1
        out = torch.zeros(shape, dtype=x.dtype, device=x.device)
        idx = [slice(None)] * x.ndim
        idx[d] = slice(0, None, r)
        out[tuple(idx)] = x
        x = out
    return x


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _conv_general(x, w, strides, padding, lhs_dilation=None,
                  rhs_dilation=None, groups=1):
    """``lax.conv_general_dilated`` for channel-last inputs and
    (spatial..., I, O) weights: cross-correlation, TF's SAME padding,
    explicit (lo, hi) pads (negative ones crop), input and kernel
    dilation, feature groups."""
    x, w = _promote(_t(x), _t(w))
    n = x.ndim - 2
    strides = tuple(strides) if isinstance(strides, (list, tuple)) else \
        (strides,) * n
    rhs_dilation = tuple(rhs_dilation or (1,) * n)
    lhs_dilation = tuple(lhs_dilation or (1,) * n)
    x = _dilate(x, lhs_dilation)
    pads = _resolve_pads(padding, x.shape[1:-1], w.shape[:n], strides,
                         rhs_dilation)
    x = _pad_spatial(x, pads)
    xc = x.movedim(-1, 1)
    wc = w.permute(n + 1, n, *range(n))          # (O, I/groups, k...)
    out = _CONV[n](xc, wc, stride=strides, dilation=rhs_dilation,
                   groups=groups)
    return out.movedim(1, -1)


def _conv_transpose_pad(k, s, padding):
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else int(_math.ceil(pad_len / 2))
    elif padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    else:
        raise ValueError(padding)
    return pad_a, pad_len - pad_a


def _conv_transpose(x, w, strides, padding):
    """``lax.conv_transpose`` (kernel not flipped): a dilated-input
    convolution with the transpose padding."""
    n = _t(x).ndim - 2
    strides = tuple(strides) if isinstance(strides, (list, tuple)) else \
        (strides,) * n
    w = _t(w)
    if isinstance(padding, str):
        pads = [_conv_transpose_pad(k, s, padding.upper())
                for k, s in zip(w.shape[:n], strides)]
    else:
        pads = padding
    return _conv_general(x, w, (1,) * n, pads, lhs_dilation=strides)


def _windows(x, k, s):
    """Sliding windows of the spatial dims 1..n: (B, o..., C, k...)."""
    out = x
    for i, (kk, ss) in enumerate(zip(k, s)):
        out = out.unfold(i + 1, kk, ss)
    return out


def _reduce_window(x, k, s, padding, op):
    x = _t(x)
    n = x.ndim - 2
    pads = _resolve_pads(padding, x.shape[1:-1], k, s)
    init = _lowest(x.dtype) if op == "max" else 0.0
    xp = _pad_spatial(x, pads, value=init)
    win = _windows(xp, k, s)
    dims = tuple(range(-n, 0))
    if op == "max":
        return torch.amax(win, dim=dims)
    return torch.sum(win, dim=dims)


def _pool(kind, rank):
    def f(x, k, s=None, padding="VALID"):
        x = _t(x)
        k = (k,) * rank if isinstance(k, int) else tuple(k)
        s = k if s is None else ((s,) * rank if isinstance(s, int)
                                 else tuple(s))
        if kind == "max":
            return _reduce_window(x, k, s, padding, "max")
        out = _reduce_window(x, k, s, padding, "sum")
        ones = torch.ones((1,) + tuple(x.shape[1:-1]) + (1,),
                          dtype=x.dtype, device=x.device)
        denom = _reduce_window(ones, k, s, padding, "sum")
        return out / denom
    return f


def _lrn(x, depth_radius=5, bias=1.0, alpha=1.0, beta=0.5):
    x = _t(x)
    k = 2 * depth_radius + 1
    sq = torch.square(x)
    # SAME along the channel dim only
    sqc = sq.unsqueeze(-2)          # (..., 1, C): the channel as spatial
    flat = sqc.reshape(-1, 1, x.shape[-1])
    pads = _same_pads((x.shape[-1],), (k,), (1,))[0]
    flat = F.pad(flat, pads)
    summed = flat.unfold(-1, k, 1).sum(-1).reshape(x.shape)
    return x / torch.pow(bias + alpha * summed, beta)


def _patches(x, k, s, padding, dilation=(1, 1)):
    """``lax.conv_general_dilated_patches`` for NHWC: (B, oh, ow, C·kh·kw),
    the feature dim channel-major."""
    x = _t(x)
    pads = _resolve_pads(padding, x.shape[1:3], k, s, dilation)
    xp = _pad_spatial(x, pads)
    win = _windows(xp, k, s)                   # (B, oh, ow, C, kh, kw)
    b, oh, ow = win.shape[:3]
    return win.reshape(b, oh, ow, -1)


def _batch_norm(x, mean, var, gamma, beta, eps=1e-5):
    x = _t(x)
    return (x - _t(mean)) * torch.rsqrt(_t(var) + eps) * _t(gamma) + _t(beta)


def _upsampling2d(x, scale=2):
    x = _t(x)
    return torch.repeat_interleave(torch.repeat_interleave(
        x, scale, dim=1), scale, dim=2)


CNN = {
    "conv1d": lambda x, w, stride=1, padding="SAME", dilation=1:
        _conv_general(x, w, (stride,), padding, rhs_dilation=(dilation,)),
    "conv2d": lambda x, w, stride=(1, 1), padding="SAME", dilation=(1, 1):
        _conv_general(x, w, tuple(stride), padding,
                      rhs_dilation=tuple(dilation)),
    "conv3d": lambda x, w, stride=(1, 1, 1), padding="SAME":
        _conv_general(x, w, tuple(stride), padding),
    "depthwise_conv2d": lambda x, w, stride=(1, 1), padding="SAME":
        _conv_general(x, w, tuple(stride), padding,
                      groups=_t(x).shape[-1]),
    "separable_conv2d": lambda x, wd, wp, stride=(1, 1), padding="SAME":
        _conv_general(_conv_general(x, wd, tuple(stride), padding,
                                    groups=_t(x).shape[-1]),
                      wp, (1, 1), "VALID"),
    "deconv2d": lambda x, w, stride=(2, 2), padding="SAME":
        _conv_transpose(x, w, tuple(stride), padding),
    "max_pooling1d": _pool("max", 1),
    "max_pooling2d": _pool("max", 2),
    "max_pooling3d": _pool("max", 3),
    "avg_pooling1d": _pool("avg", 1),
    "avg_pooling2d": _pool("avg", 2),
    "avg_pooling3d": _pool("avg", 3),
    "global_avg_pooling": lambda x: torch.mean(
        _fl(x), dim=tuple(range(1, _t(x).ndim - 1))),
    "global_max_pooling": lambda x: torch.amax(
        _t(x), dim=tuple(range(1, _t(x).ndim - 1))),
    "upsampling2d": _upsampling2d,
    "local_response_normalization": _lrn,
    "im2col": lambda x, kh, kw: _patches(x, (kh, kw), (1, 1), "VALID"),
    "batch_norm": _batch_norm,
}

# -------------------------------------------------------------------- SDRNN


def _lstm_cell(x, h, c, w_ih, w_hh, b):
    z = _t(x) @ _t(w_ih) + _t(h) @ _t(w_hh) + _t(b)
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    c2 = torch.sigmoid(f) * _t(c) + torch.sigmoid(i) * torch.tanh(g)
    h2 = torch.sigmoid(o) * torch.tanh(c2)
    return h2, c2


def _gru_cell(x, h, w_ih, w_hh, b):
    x, h, w_ih, w_hh, b = (_t(v) for v in (x, h, w_ih, w_hh, b))
    n2 = 2 * h.shape[-1]
    zr = x @ w_ih[:, :n2] + h @ w_hh[:, :n2] + b[:n2]
    z, r = torch.chunk(torch.sigmoid(zr), 2, dim=-1)
    n = torch.tanh(x @ w_ih[:, n2:] + (r * h) @ w_hh[:, n2:] + b[n2:])
    return (1 - z) * n + z * h


def _rnn_layer(cell_has_c, cell=None):
    """Run a cell over (B, T, ...) step by step (the reference's
    ``lax.scan``)."""
    def f(x, h0, *args):
        x, h0 = _t(x), _t(h0)
        if cell_has_c:
            h, c = h0, torch.zeros_like(h0)
        else:
            h = h0
        hs = []
        for t in range(x.shape[1]):
            if cell_has_c:
                h, c = (cell or _lstm_cell)(x[:, t], h, c, *args)
            else:
                h = (cell or _gru_cell)(x[:, t], h, *args)
            hs.append(h)
        return torch.stack(hs, dim=1)
    return f


RNN = {
    "lstm_cell": _lstm_cell,
    "gru_cell": _gru_cell,
    "simple_rnn_cell": lambda x, h, w_ih, w_hh, b: torch.tanh(
        _t(x) @ _t(w_ih) + _t(h) @ _t(w_hh) + _t(b)),
    "lstm_layer": _rnn_layer(cell_has_c=True),
    "gru_layer": _rnn_layer(cell_has_c=False),
}

# ------------------------------------------------------------------ SDImage


def _tri_kernel(x):
    return torch.clamp_min(1 - torch.abs(x), 0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.
    out = torch.where(x >= 1., ((-0.5 * x + 2.5) * x - 4.) * x + 2., out)
    return torch.where(x >= 2., 0., out)


def _lanczos(radius):
    def k(x):
        y = radius * torch.sin(_math.pi * x) * torch.sin(_math.pi * x
                                                         / radius)
        out = torch.where(x > 1e-3, y / torch.where(
            x != 0, _math.pi ** 2 * x ** 2, 1.0), 1.0)
        return torch.where(x > radius, 0., out)
    return k


_RESIZE_KERNELS = {"linear": _tri_kernel, "cubic": _keys_cubic,
                   "lanczos3": _lanczos(3.0), "lanczos5": _lanczos(5.0)}


def _weight_mat(m, n, kernel, device):
    """``jax.image``'s weight matrix (m, n) for one dim: the kernel
    widened by 1/scale when downsampling (antialiased)."""
    scale = n / m
    inv = 1.0 / scale
    kscale = max(inv, 1.0)
    sample = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) \
        * inv - 0.5
    x = torch.abs(sample[None, :] - torch.arange(
        m, dtype=torch.float32, device=device)[:, None]) / kscale
    w = kernel(x)
    tot = torch.sum(w, dim=0, keepdim=True)
    eps = 1000.0 * float(numpy.finfo(numpy.float32).eps)
    w = torch.where(torch.abs(tot) > eps, w / torch.where(
        tot != 0, tot, 1.0), 0.0)
    ok = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(ok[None, :], w, 0.0)


def _jax_resize(x, shape, method):
    """``jax.image.resize`` (antialiased) for a tensor and a full output
    shape."""
    x = _t(x)
    shape = tuple(int(s) for s in shape)
    if method == "nearest":
        out = x
        for d in range(x.ndim):
            m, n = x.shape[d], shape[d]
            if m == n:
                continue
            off = torch.floor((torch.arange(n, dtype=torch.float32,
                                            device=x.device) + 0.5)
                              * m / n).long()
            out = out.index_select(d, off)
        return out
    if not (x.is_floating_point() or x.is_complex()):
        x = x.float()
    kernel = _RESIZE_KERNELS[method]
    out = x
    for d in range(x.ndim):
        m, n = x.shape[d], shape[d]
        if m == n:
            continue
        w = _weight_mat(m, n, kernel, x.device).to(x.dtype)
        out = torch.tensordot(out, w, dims=([d], [0])).movedim(-1, d)
    return out


def _resize_to(method):
    def f(x, h, w):
        x = _t(x)
        return _jax_resize(x, (x.shape[0], int(h), int(w), x.shape[3]),
                           method)
    return f


def _per_image_standardization(x):
    x = _fl(x)
    mu = torch.mean(x, dim=(1, 2, 3), keepdim=True)
    sd = torch.std(x, dim=(1, 2, 3), correction=0, keepdim=True)
    return (x - mu) / torch.clamp_min(sd, 1.0 / _math.sqrt(x[0].numel()))


def _central_crop(x, frac):
    x = _t(x)
    h0 = int(x.shape[1] * (1 - frac) / 2)
    w0 = int(x.shape[2] * (1 - frac) / 2)
    return x[:, h0:h0 + int(x.shape[1] * frac),
             w0:w0 + int(x.shape[2] * frac)]


def _random_crop(gen, x, h, w):
    x = _t(x)
    dev = _gdev(gen)
    y0 = int(torch.randint(0, x.shape[1] - int(h) + 1, (), generator=gen,
                           device=dev))
    x0 = int(torch.randint(0, x.shape[2] - int(w) + 1, (), generator=gen,
                           device=dev))
    return x[:, y0:y0 + int(h), x0:x0 + int(w)]


def _adjust_contrast(x, factor):
    x = _t(x)
    m = torch.mean(x, dim=(1, 2), keepdim=True)
    return (x - m) * factor + m


IMAGE = {
    "resize_bilinear": _resize_to("linear"),
    "resize_nearest": _resize_to("nearest"),
    "resize_bicubic": _resize_to("cubic"),
    "flip_left_right": lambda x: torch.flip(_t(x), dims=(2,)),
    "flip_up_down": lambda x: torch.flip(_t(x), dims=(1,)),
    "rot90": lambda x, k=1: torch.rot90(_t(x), k, dims=(1, 2)),
    "adjust_brightness": lambda x, delta: _t(x) + delta,
    "adjust_contrast": _adjust_contrast,
    "rgb_to_grayscale": lambda x: torch.sum(_t(x) * _t(numpy.asarray(
        [0.2989, 0.587, 0.114], numpy.float32)).to(_t(x).device,
                                                   _t(x).dtype),
        dim=-1, keepdim=True),
    "per_image_standardization": _per_image_standardization,
    "central_crop": _central_crop,
    "extract_patches": lambda x, kh, kw: _patches(x, (int(kh), int(kw)),
                                                  (1, 1), "VALID"),
    "random_crop": _random_crop,
}

# ------------------------------------------------------------------- SDLoss


def _relu(x):
    return torch.clamp_min(x, 0)


def _log1pexp_neg_abs(x):
    return torch.log1p(torch.exp(-torch.abs(x)))


LOSS_EXT = {
    "hinge_loss": lambda labels, logits: torch.mean(
        _relu(1.0 - (2.0 * _t(labels) - 1.0) * _t(logits))),
    "squared_hinge_loss": lambda labels, logits: torch.mean(torch.square(
        _relu(1.0 - (2.0 * _t(labels) - 1.0) * _t(logits)))),
    "poisson_loss": lambda labels, preds, eps=1e-7: torch.mean(
        _t(preds) - _t(labels) * torch.log(_t(preds) + eps)),
    "kl_divergence": lambda labels, preds, eps=1e-7: torch.mean(torch.sum(
        _t(labels) * (torch.log(_t(labels) + eps)
                      - torch.log(_t(preds) + eps)), -1)),
    "smooth_l1_loss": lambda labels, preds, beta=1.0: torch.mean(
        torch.where(torch.abs(_t(preds) - _t(labels)) < beta,
                    0.5 * torch.square(_t(preds) - _t(labels)) / beta,
                    torch.abs(_t(preds) - _t(labels)) - 0.5 * beta)),
    "weighted_cross_entropy_with_logits": lambda labels, logits, weight:
        torch.mean((1 - _t(labels)) * _t(logits)
                   + (1 + (weight - 1) * _t(labels))
                   * _log1pexp_neg_abs(_t(logits))
                   + _relu(-_t(logits)) * (1 + (weight - 1) * _t(labels))),
    "focal_loss": lambda labels, logits, gamma=2.0, alpha=0.25: torch.mean(
        -alpha * _t(labels) * torch.pow(1 - torch.sigmoid(_t(logits)), gamma)
        * F.logsigmoid(_t(logits))
        - (1 - alpha) * (1 - _t(labels))
        * torch.pow(torch.sigmoid(_t(logits)), gamma)
        * F.logsigmoid(-_t(logits))),
    "ctc_loss": lambda log_probs, labels, logit_lengths, label_lengths:
        _ctc(log_probs, labels, logit_lengths, label_lengths),
    "l2_loss": lambda x: 0.5 * torch.sum(torch.square(_t(x))),
    "log_poisson_loss": lambda labels, log_preds, full=False: torch.mean(
        torch.exp(_t(log_preds)) - _t(labels) * _t(log_preds)),
}


def _ctc(log_probs, labels, logit_lengths, label_lengths):
    """``optax.ctc_loss`` averaged over the batch: optax normalizes the
    logits with a log-softmax and uses blank id 0."""
    lp = torch.log_softmax(_fl(log_probs), dim=-1)
    labels = _idx(labels)
    ll = _idx(logit_lengths)
    tl = _idx(label_lengths)
    per = F.ctc_loss(lp.transpose(0, 1), labels, ll, tl, blank=0,
                     reduction="none", zero_infinity=False)
    return torch.mean(per)


# ------------------------------------------------------------- NN extensions


def _dpa(q, k, v, mask=None, bias=None, is_causal=False):
    """``jax.nn.dot_product_attention`` over (B, T, N, H): the logits and
    the softmax in f32 (at least), masked logits at −0.7·max."""
    q, k, v = _t(q), _t(k), _t(v)
    ldt = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / _math.sqrt(q.shape[-1])
    logits = torch.einsum("btnh,bsnh->bnts", q.to(ldt), k.to(ldt)) * scale
    if bias is not None:
        logits = logits + _t(bias).to(ldt)
    neg = -0.7 * torch.finfo(ldt).max
    if mask is not None:
        logits = torch.where(_t(mask).bool(), logits,
                             torch.full((), neg, dtype=ldt,
                                        device=logits.device))
    if is_causal:
        t, s = logits.shape[-2], logits.shape[-1]
        causal = torch.tril(torch.ones((t, s), dtype=torch.bool,
                                       device=q.device))
        logits = torch.where(causal, logits, torch.full(
            (), neg, dtype=ldt, device=logits.device))
    probs = torch.softmax(logits.float(), dim=-1).to(v.dtype)
    return torch.einsum("bnts,bsnh->btnh", probs, v)


def _l2_normalize(x, axis=-1, eps=1e-12):
    x = _t(x)
    return x / torch.sqrt(torch.clamp_min(torch.sum(
        torch.square(x), dim=axis, keepdim=True), eps))


def _glu(x, axis=-1):
    a, b = torch.chunk(_t(x), 2, dim=axis)
    return a * torch.sigmoid(b)


def _hard_swish(x):
    x = _t(x)
    return x * F.relu6(x + 3.0) / 6.0


def _celu(x, alpha=1.0):
    return F.celu(_t(x), alpha)


NN_EXT = {
    "softsign": lambda x: F.softsign(_t(x)),
    "hard_tanh": lambda x: torch.clamp(_t(x), -1.0, 1.0),
    "hard_swish": _hard_swish,
    "log_sigmoid": lambda x: F.logsigmoid(_t(x)),
    "prelu": lambda x, alpha: torch.where(_t(x) >= 0, _t(x),
                                          _t(alpha) * _t(x)),
    "glu": _glu,
    "celu": _celu,
    "normalize_moments": lambda counts, means_ss, variance_ss, shift=None: (
        _t(means_ss) / _t(counts),
        _t(variance_ss) / _t(counts) - torch.square(
            _t(means_ss) / _t(counts))),
    "moments": lambda x, axes: (_mean(x, _axes(axes)), _var(x, _axes(axes))),
    "l2_normalize": _l2_normalize,
    "bias_add": lambda x, b: _t(x) + _t(b),
    "dot_product_attention": lambda q, k, v, mask=None: _dpa(q, k, v, mask),
    "pad": lambda x, paddings, value=0.0: _pad(x, paddings, value=value),
    "dropout_train": lambda gen, x, rate: _t(x) * _bernoulli(
        gen, 1 - rate, _t(x).shape).to(_t(x).device) / (1 - rate),
    "layer_norm_no_bias": lambda x, gain, eps=1e-5: (
        _t(x) - torch.mean(_t(x), -1, keepdim=True)) * torch.rsqrt(
        torch.var(_t(x), -1, correction=0, keepdim=True) + eps) * _t(gain),
    "rms_norm": lambda x, gain, eps=1e-6: _t(x) * torch.rsqrt(torch.mean(
        torch.square(_t(x)), -1, keepdim=True) + eps) * _t(gain),
    "softmax_with_temperature": lambda x, t=1.0: torch.softmax(_t(x) / t,
                                                               -1),
}


# -------------------------------------------------------- r2 long tail ----
_CONDS = {
    "lt": torch.lt, "lte": torch.le, "gt": torch.gt,
    "gte": torch.ge, "eq": torch.eq, "neq": torch.ne,
}


def _isin(x, test):
    x, test = _t(x), _t(test)
    return torch.isin(x, test.to(x.device))


def _list_diff(x, y, size):
    """Upstream listDiff: (values, indices), the indices padded with −1
    beyond the true count."""
    x = _t(x)
    keep = ~_isin(x, y)
    idx = torch.nonzero(keep.reshape(-1)).reshape(-1)
    size = int(size)
    idx = idx[:size]
    idx = torch.cat([idx, torch.full((size - idx.shape[0],), -1,
                                     dtype=idx.dtype, device=x.device)])
    vals = torch.where(idx >= 0, x.reshape(-1)[idx.clamp_min(0)],
                       torch.zeros((), dtype=x.dtype, device=x.device))
    return vals, _i32(idx)


def _clip_by_avg_norm(x, clip, axes=None):
    x = _t(x)
    rms = torch.sqrt(_mean(torch.square(x), _axes(axes), keepdims=True))
    return torch.where(rms > clip, x * clip / torch.clamp_min(rms, 1e-12), x)


def _match_condition(x, cond, value):
    if cond not in _CONDS:
        raise ValueError(f"unknown condition {cond!r}; one of {sorted(_CONDS)}")
    x, v = _bin(x, value)
    return _CONDS[cond](x, v)


def _space_to_batch(x, block, paddings=((0, 0), (0, 0))):
    x = _t(x)
    b, h, w, c = x.shape
    x = _pad(x, ((0, 0), tuple(paddings[0]), tuple(paddings[1]), (0, 0)))
    h2, w2 = x.shape[1], x.shape[2]
    x = x.reshape(b, h2 // block, block, w2 // block, block, c)
    return x.permute(2, 4, 0, 1, 3, 5).reshape(
        b * block * block, h2 // block, w2 // block, c)


def _batch_to_space(x, block, crops=((0, 0), (0, 0))):
    x = _t(x)
    bb, h, w, c = x.shape
    b = bb // (block * block)
    x = x.reshape(block, block, b, h, w, c).permute(2, 3, 0, 4, 1, 5)
    x = x.reshape(b, h * block, w * block, c)
    (ct, cb), (cl, cr) = crops
    return x[:, ct:h * block - cb, cl:w * block - cr, :]


def _mh_attention(q, k, v, wq, wk, wv, wo, mask=None):
    """Upstream multiHeadDotProductAttention: (H, Dp, Din) projections,
    per-head scaled dot attention, (Dout, H·Dp) output projection."""
    q, k, v, wq, wk, wv, wo = (_t(a) for a in (q, k, v, wq, wk, wv, wo))
    qh = torch.einsum("btd,hpd->bhtp", q, wq)
    kh = torch.einsum("btd,hpd->bhtp", k, wk)
    vh = torch.einsum("btd,hpd->bhtp", v, wv)
    s = torch.einsum("bhqp,bhkp->bhqk", qh, kh) / _math.sqrt(qh.shape[-1])
    if mask is not None:
        s = torch.where(_t(mask).bool(), s, torch.full(
            (), -1e30, dtype=s.dtype, device=s.device))
    att = torch.softmax(s, -1)
    out = torch.einsum("bhqk,bhkp->bhqp", att, vh)
    b, h, t, p = out.shape
    return torch.einsum("btx,ox->bto",
                        out.permute(0, 2, 1, 3).reshape(b, t, h * p), wo)


def _greedy_nms(scores, max_out, overlap_of, threshold, score_threshold):
    """Greedy NMS over ``max_out`` rounds: (indices padded with −1,
    count), as the reference's ``lax.scan``. The pick of a round is a
    one-element index tensor (a 0-d one would be read on the host)."""
    scores = _t(scores)
    n = scores.shape[0]
    live = torch.ones(n, dtype=torch.bool, device=scores.device)
    count = torch.zeros((), dtype=torch.int32, device=scores.device)
    picks = []
    ninf = torch.full((), float("-inf"), dtype=scores.dtype,
                      device=scores.device)
    for _ in range(int(max_out)):
        masked = torch.where(live, scores, ninf)
        i = torch.argmax(masked).reshape(1)
        best = masked.index_select(0, i)[0]
        ok = (best > score_threshold) & torch.isfinite(best)
        suppress = overlap_of(i) > threshold
        live = torch.where(ok, live & ~suppress, live).index_fill(0, i, False)
        count = count + ok.to(torch.int32)
        picks.append(torch.where(ok, i[0], torch.full_like(i[0], -1)))
    idx = torch.stack(picks).to(torch.int32) if picks else torch.zeros(
        0, dtype=torch.int32, device=scores.device)
    return idx, count


def _nms(boxes, scores, max_out, iou_threshold=0.5,
         score_threshold=float("-inf")):
    boxes = _t(boxes)
    y1, x1, y2, x2 = (boxes[:, i] for i in range(4))
    area = torch.clamp_min(y2 - y1, 0) * torch.clamp_min(x2 - x1, 0)

    def iou(i):
        def at(t):
            return t.index_select(0, i)
        yy1 = torch.maximum(at(y1), y1)
        xx1 = torch.maximum(at(x1), x1)
        yy2 = torch.minimum(at(y2), y2)
        xx2 = torch.minimum(at(x2), x2)
        inter = torch.clamp_min(yy2 - yy1, 0) * torch.clamp_min(xx2 - xx1, 0)
        return inter / torch.clamp_min(at(area) + area - inter, 1e-9)

    return _greedy_nms(scores, max_out, iou, iou_threshold, score_threshold)


def _crop_and_resize(images, boxes, box_indices, crop_size,
                     extrapolation_value=0.0):
    """tf.image.crop_and_resize: normalized [y1, x1, y2, x2] boxes,
    bilinear samples on a (ch, cw) grid per box, a crop dim of 1 at the
    box centre, samples outside the image at ``extrapolation_value``."""
    images = _t(images)
    boxes = _t(boxes)
    bidx = _idx(box_indices)
    ch, cw = int(crop_size[0]), int(crop_size[1])
    _, h, w, _ = images.shape

    def grid(lo, hi, n, extent):
        if n == 1:
            return (0.5 * (lo + hi) * (extent - 1))[..., None]
        ar = torch.arange(n, dtype=boxes.dtype, device=boxes.device)
        return lo[..., None] * (extent - 1) + (ar / (n - 1)) \
            * (hi - lo)[..., None] * (extent - 1)

    outs = []
    for k in range(boxes.shape[0]):
        y1, x1, y2, x2 = boxes[k]
        ys = grid(y1, y2, ch, h)
        xs = grid(x1, x2, cw, w)
        y0 = torch.clamp(torch.floor(ys).long(), 0, h - 1)
        x0 = torch.clamp(torch.floor(xs).long(), 0, w - 1)
        y1i = torch.clamp(y0 + 1, 0, h - 1)
        x1i = torch.clamp(x0 + 1, 0, w - 1)
        wy = (ys - y0)[:, None, None]
        wx = (xs - x0)[None, :, None]
        img = images.index_select(0, bidx[k:k + 1])[0]
        top, bot = img[y0], img[y1i]
        a, b = top[:, x0], top[:, x1i]
        c, d = bot[:, x0], bot[:, x1i]
        out = (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
               + c * wy * (1 - wx) + d * wy * wx)
        inside = ((ys >= 0) & (ys <= h - 1))[:, None, None] \
            & ((xs >= 0) & (xs <= w - 1))[None, :, None]
        outs.append(torch.where(inside, out, torch.full(
            (), extrapolation_value, dtype=out.dtype, device=out.device)))
    return torch.stack(outs)


BASE.update({
    "space_to_batch": _space_to_batch,
    "batch_to_space": _batch_to_space,
    "unsorted_segment_min": _seg_min,
    "unsorted_segment_max": _seg_max,
    "unsorted_segment_prod": _seg_prod,
    "unsorted_segment_mean": lambda x, ids, num: _seg_sum(x, ids, num)
    / torch.clamp_min(_seg_sum(torch.ones_like(_t(x), dtype=torch.float32),
                               ids, num), 1),
    "unsorted_segment_sqrt_n": lambda x, ids, num: _seg_sum(x, ids, num)
    / torch.sqrt(torch.clamp_min(_seg_sum(torch.ones_like(
        _t(x), dtype=torch.float32), ids, num), 1)),
    "merge_add": lambda *xs: sum(_t(x) for x in xs),
    "merge_avg": lambda *xs: sum(_t(x) for x in xs) / len(xs),
    "merge_max": lambda *xs: torch.stack([_t(x) for x in xs]).amax(0),
    "list_diff": _list_diff,
})

MATH_EXT.update({
    "amax": lambda x, axis=None: _amax(torch.abs(_t(x)), axis),
    "amin": lambda x, axis=None: _amin(torch.abs(_t(x)), axis),
    "amean": lambda x, axis=None: _mean(torch.abs(_t(x)), axis),
    "asum": lambda x, axis=None: _sum(torch.abs(_t(x)), axis),
    "logaddexp2": lambda a, b: torch.logaddexp2(*_promote(_fl(a), _fl(b))),
    "match_condition": _match_condition,
    "match_condition_count": lambda x, cond, value: _sum(
        _match_condition(x, cond, value).to(torch.int32)),
    "zero_fraction": lambda x: torch.mean((_t(x) == 0).float()),
    "entropy": lambda x, axis=None: -_sum(
        _t(x) * torch.log(torch.clamp_min(_t(x), 1e-30)), axis),
    "log_entropy": lambda x, axis=None: torch.log(-_sum(
        _t(x) * torch.log(torch.clamp_min(_t(x), 1e-30)), axis)),
    "shannon_entropy": lambda x, axis=None: -_sum(
        _t(x) * torch.log2(torch.clamp_min(_t(x), 1e-30)), axis),
    "standardize": lambda x, axis=-1, eps=1e-12: (
        _t(x) - _mean(x, _axes(axis), keepdims=True)) / torch.sqrt(
        _var(x, _axes(axis), keepdims=True) + eps),
    "is_non_decreasing": lambda x: torch.all(torch.diff(
        _t(x).reshape(-1)) >= 0),
    "is_strictly_increasing": lambda x: torch.all(torch.diff(
        _t(x).reshape(-1)) > 0),
    "clip_by_avg_norm": _clip_by_avg_norm,
})


def _matrix_band_part(x, lower, upper):
    x = _t(x)
    r = torch.arange(x.shape[-2], device=x.device)[:, None]
    c = torch.arange(x.shape[-1], device=x.device)[None, :]
    keep = ((r - c) <= (lower if lower >= 0 else x.shape[-2])) & \
        ((c - r) <= (upper if upper >= 0 else x.shape[-1]))
    return x * keep


LINALG.update({
    "matrix_band_part": _matrix_band_part,
    "lu": _lu,
})

NN_EXT.update({
    "multi_head_dot_product_attention": _mh_attention,
})

IMAGE.update({
    "non_max_suppression": _nms,
    "crop_and_resize": _crop_and_resize,
})


NAMESPACES = {
    "base": BASE, "math": MATH_EXT, "nn": NN_EXT, "loss": LOSS_EXT,
    "linalg": LINALG, "bitwise": BITWISE, "random": RANDOM, "cnn": CNN,
    "rnn": RNN, "image": IMAGE,
}


def op_count():
    return sum(len(t) for t in NAMESPACES.values())


# -------------------------------------------------------- r2 widening #3 --
_YIQ_M = numpy.array([[0.299, 0.587, 0.114],
                      [0.59590059, -0.27455667, -0.32134392],
                      [0.21153661, -0.52273617, 0.31119955]], numpy.float32)
_YUV_M = numpy.array([[0.299, 0.587, 0.114],
                      [-0.14714119, -0.28886916, 0.43601035],
                      [0.61497538, -0.51496512, -0.10001026]], numpy.float32)
# the inverses as the reference computes them: float32 matrices inverted
_YIQ_INV = numpy.linalg.inv(_YIQ_M).astype(numpy.float32)
_YUV_INV = numpy.linalg.inv(_YUV_M).astype(numpy.float32)


def _color(m):
    def f(x):
        x = _t(x)
        return torch.einsum("...c,kc->...k", x, _t(m).to(x.device,
                                                          x.dtype))
    return f


def _rgb_to_hsv(rgb):
    rgb = _fl(rgb)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = torch.amax(rgb, -1)
    mn = torch.amin(rgb, -1)
    d = mx - mn
    safe = torch.where(d == 0, 1.0, d)
    h = torch.where(
        mx == r, torch.remainder((g - b) / safe, 6.0),
        torch.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0))
    h = torch.where(d == 0, 0.0, h) / 6.0
    s = torch.where(mx == 0, 0.0, d / torch.where(mx == 0, 1.0, mx))
    return torch.stack([h, s, mx], -1)


def _hsv_to_rgb(hsv):
    hsv = _fl(hsv)
    h, s, v = hsv[..., 0] * 6.0, hsv[..., 1], hsv[..., 2]
    i = torch.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = torch.remainder(i.to(torch.int32), 6).clamp(0, 5).long()

    def choose(opts):
        st = torch.stack(opts, -1)
        return torch.gather(st, -1, i[..., None])[..., 0]
    r = choose([v, q, p, p, t, v])
    g = choose([t, v, v, q, p, p])
    b = choose([p, p, t, v, v, q])
    return torch.stack([r, g, b], -1)


def _adjust_hue(img, delta):
    hsv = _rgb_to_hsv(img)
    h = torch.remainder(hsv[..., 0] + delta, 1.0)
    return _hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], -1))


def _adjust_saturation(img, factor):
    hsv = _rgb_to_hsv(img)
    s = torch.clamp(hsv[..., 1] * factor, 0.0, 1.0)
    return _hsv_to_rgb(torch.stack([hsv[..., 0], s, hsv[..., 2]], -1))


def _group_norm(x, gamma, beta, groups, eps=1e-5):
    x = _t(x)
    shp = x.shape
    c = shp[-1]
    g = int(groups)
    xg = x.reshape(shp[0], -1, g, c // g)
    mu = torch.mean(xg, (1, 3), keepdim=True)
    var = torch.var(xg, (1, 3), correction=0, keepdim=True)
    xn = ((xg - mu) * torch.rsqrt(var + eps)).reshape(shp)
    return xn * _t(gamma) + _t(beta)


def _instance_norm(x, gamma, beta, eps=1e-5):
    x = _t(x)
    axes = tuple(range(1, x.ndim - 1))
    mu = torch.mean(x, axes, keepdim=True)
    var = torch.var(x, axes, correction=0, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * _t(gamma) + _t(beta)


def _adaptive_pool2d(x, out_h, out_w, op):
    x = _t(x)
    B, H, W, C = x.shape
    oh, ow = int(out_h), int(out_w)
    rows = []
    for i in range(oh):
        h0, h1 = (i * H) // oh, -((-(i + 1) * H) // oh)
        cols = []
        for j in range(ow):
            w0, w1 = (j * W) // ow, -((-(j + 1) * W) // ow)
            cols.append(op(x[:, h0:h1, w0:w1, :], (1, 2)))
        rows.append(torch.stack(cols, 1))
    return torch.stack(rows, 1)


def _sd_col2im(cols, x_shape, kh, kw, sh=1, sw=1):
    from ..ndarray.factory import col2im as _c2i
    return _c2i(_t(cols), tuple(x_shape), (int(kh), int(kw)),
                (int(sh), int(sw)))


IMAGE.update({
    "rgb_to_hsv": _rgb_to_hsv,
    "hsv_to_rgb": _hsv_to_rgb,
    "rgb_to_yiq": _color(_YIQ_M),
    "yiq_to_rgb": _color(_YIQ_INV),
    "rgb_to_yuv": _color(_YUV_M),
    "yuv_to_rgb": _color(_YUV_INV),
    "adjust_hue": _adjust_hue,
    "adjust_saturation": _adjust_saturation,
})

NN_EXT.update({
    "group_norm": _group_norm,
    "instance_norm": _instance_norm,
})

CNN.update({
    "adaptive_avg_pooling2d": lambda x, oh, ow: _adaptive_pool2d(
        x, oh, ow, lambda w, d: torch.mean(w, d)),
    "adaptive_max_pooling2d": lambda x, oh, ow: _adaptive_pool2d(
        x, oh, ow, lambda w, d: torch.amax(w, d)),
    "col2im": _sd_col2im,
})


# -------------------------------------------------------- r3 widening ------

def _fft_n(x, n, axis, fn):
    x = _t(x)
    if not x.is_complex() and fn in (torch.fft.fft, torch.fft.ifft):
        x = _fl(x).to(torch.complex64)
    return fn(x, n=n, dim=axis)


def _fft_axes(fn, default):
    def f(x, axes=default):
        x = _t(x)
        if not x.is_complex() and fn in (torch.fft.fft2, torch.fft.ifft2,
                                         torch.fft.fftn, torch.fft.ifftn):
            x = _fl(x).to(torch.complex64)
        elif not x.is_complex():
            x = _fl(x)
        axes = _axes(axes)
        return fn(x, dim=axes)
    return f


def _rfft(x, n=None, axis=-1):
    return torch.fft.rfft(_fl(x), n=n, dim=axis)


FFT = {
    "fft": lambda x, n=None, axis=-1: _fft_n(x, n, axis, torch.fft.fft),
    "ifft": lambda x, n=None, axis=-1: _fft_n(x, n, axis, torch.fft.ifft),
    "rfft": _rfft,
    "irfft": lambda x, n=None, axis=-1: torch.fft.irfft(
        _t(x).to(torch.complex64) if not _t(x).is_complex() else _t(x),
        n=n, dim=axis),
    "hfft": lambda x, n=None, axis=-1: torch.fft.hfft(
        _t(x).to(torch.complex64) if not _t(x).is_complex() else _t(x),
        n=n, dim=axis),
    "ihfft": lambda x, n=None, axis=-1: torch.fft.ihfft(
        _fl(x), n=n, dim=axis).resolve_conj(),
    "fft2": _fft_axes(torch.fft.fft2, (-2, -1)),
    "ifft2": _fft_axes(torch.fft.ifft2, (-2, -1)),
    "rfft2": _fft_axes(torch.fft.rfft2, (-2, -1)),
    "irfft2": lambda x, axes=(-2, -1): torch.fft.irfft2(_t(x),
                                                        dim=_axes(axes)),
    "fftn": _fft_axes(torch.fft.fftn, None),
    "ifftn": _fft_axes(torch.fft.ifftn, None),
    "rfftn": _fft_axes(torch.fft.rfftn, None),
    "irfftn": lambda x, axes=None: torch.fft.irfftn(_t(x), dim=_axes(axes)),
    "fftshift": lambda x, axes=None: torch.fft.fftshift(_t(x),
                                                        dim=_axes(axes)),
    "ifftshift": lambda x, axes=None: torch.fft.ifftshift(_t(x),
                                                          dim=_axes(axes)),
    "fftfreq": lambda n, d=1.0: torch.fft.fftfreq(int(n), d,
                                                  dtype=torch.float32),
    "rfftfreq": lambda n, d=1.0: torch.fft.rfftfreq(int(n), d,
                                                    dtype=torch.float32),
}


def _unwrap(p, axis=-1):
    p = _fl(p)
    dd = torch.diff(p, dim=axis)
    ddmod = torch.remainder(dd + _math.pi, 2 * _math.pi) - _math.pi
    ddmod = torch.where((ddmod == -_math.pi) & (dd > 0), _math.pi, ddmod)
    corr = torch.where(torch.abs(dd) < _math.pi, 0.0, ddmod - dd)
    first = p.narrow(axis, 0, 1)
    return torch.cat([first, first + torch.cumsum(dd + corr, dim=axis)],
                     dim=axis) if p.shape[axis] > 1 else p


def _correlate(a, v, mode="full"):
    """``jnp.correlate``: c[k] = Σ a[n+k] · conj(v[n]); numpy's
    convention reverses the output when v is the longer one."""
    a, v = _promote(_fl(a), _fl(v))
    n, m = a.shape[0], v.shape[0]
    swap = m > n
    if swap:
        a, v = v, a
        n, m = m, n
    if mode == "full":
        lo, hi = m - 1, m - 1
    elif mode == "same":
        lo, hi = m // 2, m - 1 - m // 2
    else:
        lo = hi = 0
    out = F.conv1d(F.pad(a.reshape(1, 1, -1), (lo, hi)),
                   v.reshape(1, 1, -1)).reshape(-1)
    return torch.flip(out, (0,)) if swap else out


def _full_convolve(a, v, mode="full"):
    """``jnp.convolve``: the flipped kernel slid over the longer input."""
    a, v = _promote(_fl(a), _fl(v))
    if v.shape[0] > a.shape[0]:
        a, v = v, a
    m = v.shape[0]
    if mode == "full":
        lo, hi = m - 1, m - 1
    elif mode == "same":
        lo, hi = (m - 1) // 2, m - 1 - (m - 1) // 2
    else:
        lo = hi = 0
    return F.conv1d(F.pad(a.reshape(1, 1, -1), (lo, hi)),
                    torch.flip(v, (0,)).reshape(1, 1, -1)).reshape(-1)


def _trapz(y, x=None, dx=1.0, axis=-1):
    y = _fl(y)
    if x is None:
        return torch.trapezoid(y, dx=dx, dim=axis)
    return torch.trapezoid(y, _fl(x), dim=axis)


def _nextafter(a, b):
    a, b = _promote(_fl(a), _fl(b))
    return torch.nextafter(a, b)


def _gcd(a, b):
    a, b = _bin(a, b)
    return torch.gcd(a, b)


def _lcm(a, b):
    a, b = _bin(a, b)
    return torch.lcm(a, b)


def _fmax(a, b):
    a, b = _promote(*_bin(a, b))
    return torch.fmax(a, b)


def _fmin(a, b):
    a, b = _promote(*_bin(a, b))
    return torch.fmin(a, b)


def _float_power(a, b):
    a, b = _promote(_fl(a), _fl(b))
    return torch.pow(a, b)


def _divmod(a, b):
    return _floor_divide(a, b), _remainder(a, b)


def _modf(x):
    x = _fl(x)
    i = torch.trunc(x)
    return x - i, i


def _cumext(fn):
    def f(x, axis=0):
        return fn(_t(x), dim=int(axis)).values
    return f


def _polyval(p, x):
    x = _t(x)
    p = _t(p).to(x.device)
    out = torch.zeros_like(x, dtype=torch.promote_types(p.dtype, x.dtype))
    for c in p:
        out = out * x + c
    return out


def _select(conds, vals, default=0.0):
    conds = [_t(c).bool() for c in conds]
    vals = [_t(v) for v in vals]
    out = torch.broadcast_to(_t(default), torch.broadcast_shapes(
        *[c.shape for c in conds], *[v.shape for v in vals])).to(
        torch.promote_types(vals[0].dtype, _t(default).dtype))
    for c, v in reversed(list(zip(conds, vals))):
        out = torch.where(c, v.to(out.dtype), out)
    return out


def _factorial(n):
    n = _fl(n)
    return torch.where(n < 0, 0.0, torch.exp(torch.lgamma(n + 1)))


def _multigammaln(a, d):
    a = _fl(a)
    return torch.special.multigammaln(a, int(d))


MATH_EXT.update({
    "real": lambda x: torch.real(_t(x)).clone() if _t(x).is_complex()
    else _t(x),
    "imag": lambda x: torch.imag(_t(x)).clone() if _t(x).is_complex()
    else torch.zeros_like(_t(x)),
    "conj": lambda x: torch.conj_physical(_t(x)),
    "angle": lambda x: torch.angle(_fl(x)),
    "complex": lambda re, im: torch.complex(*_promote(_fl(re), _fl(im))),
    "complex_abs": lambda x: torch.abs(_t(x)),
    "unwrap": _unwrap,
    "convolve": _full_convolve,
    "correlate": _correlate,
    "trapz": _trapz,
    "sinc": _unop(torch.sinc, True), "signbit": _unop(torch.signbit),
    "nextafter": _nextafter,
    "fabs": _unop(torch.abs, True), "gcd": _gcd, "lcm": _lcm,
    "fmax": _fmax, "fmin": _fmin,
    "float_power": _float_power,
    "divmod": _divmod, "modf": _modf,
    "cummax": _cumext(torch.cummax),
    "cummin": _cumext(torch.cummin),
    "relative_error": lambda a, b, eps=1e-12: torch.abs(_t(a) - _t(b))
    / torch.clamp_min(torch.maximum(torch.abs(_t(a)), torch.abs(_t(b))),
                      eps),
    "polyval": _polyval,
    "ediff1d": lambda x: torch.diff(_t(x).reshape(-1)),
    "select": _select,
    # special functions
    "i0": _unop(torch.special.i0, True), "i0e": _unop(torch.special.i0e,
                                                      True),
    "i1": _unop(torch.special.i1, True), "i1e": _unop(torch.special.i1e,
                                                      True),
    "betaln": _betaln,
    "gamma_fn": _gamma_fn,
    "factorial": _factorial,
    "ndtr": _unop(torch.special.ndtr, True),
    "ndtri": _unop(torch.special.ndtri, True),
    "log_ndtr": _unop(torch.special.log_ndtr, True),
    "rel_entr": _rel_entr, "kl_div_elem": _kl_div,
    "spence": _spence,
})


def _histogram_fixed_width(x, range_, nbins):
    lo, hi = range_
    x = _t(x)
    idx = torch.clamp(((x - lo) / (hi - lo) * nbins).to(torch.int32), 0,
                      int(nbins) - 1)
    return _bincount(idx.reshape(-1), int(nbins))


def _nonzero(x, size):
    x = _t(x).reshape(-1)
    idx = torch.nonzero(x).reshape(-1)[:int(size)]
    return _i32(torch.cat([idx, torch.full((int(size) - idx.shape[0],), -1,
                                           dtype=idx.dtype,
                                           device=x.device)]))


def _matrix_set_diag(x, diag):
    x = _t(x).clone()
    m, nn = x.shape[-2], x.shape[-1]
    k = torch.arange(min(m, nn), device=x.device)
    x[..., k, k] = _t(diag).to(x.dtype)
    return x


def _scatter_nd_onto(op):
    def f(ref, indices, updates):
        ref = _t(ref)
        ix = _nd_index(indices)
        upd = _t(updates).to(ref.dtype)
        if op == "set":
            out = ref.clone()
            out[ix] = upd
            return out
        return ref.index_put(ix, upd, accumulate=True)
    return f


def _nanred(fn):
    def f(x, *axes):
        return fn(_fl(x), _dims(_t(x), axes))
    return f


def _nanmax(x, dims):
    filled = torch.where(torch.isnan(x), float("-inf"), x)
    out = torch.amax(filled, dim=_all(x, dims))
    allnan = torch.all(torch.isnan(x), dim=_all(x, dims))
    return torch.where(allnan, float("nan"), out)


def _nanmin(x, dims):
    filled = torch.where(torch.isnan(x), float("inf"), x)
    out = torch.amin(filled, dim=_all(x, dims))
    allnan = torch.all(torch.isnan(x), dim=_all(x, dims))
    return torch.where(allnan, float("nan"), out)


def _nanvar(x, dims):
    ok = ~torch.isnan(x)
    n = torch.sum(ok, dim=_all(x, dims), keepdim=True)
    mean = torch.nansum(x, dim=_all(x, dims), keepdim=True) / n
    d = torch.where(ok, x - mean, 0.0)
    return torch.sum(d * d, dim=_all(x, dims)) / torch.sum(
        ok, dim=_all(x, dims))


def _quantile(x, q, axis=None):
    """``jnp.quantile`` (linear): q read as host numbers, one
    ``torch.quantile`` a value (a tensor q is checked on the host)."""
    x = _fl(x)
    qs = numpy.asarray(_host(q) if isinstance(q, torch.Tensor) else q,
                       numpy.float64)
    if axis is None:
        x, dim = x.reshape(-1), 0
    else:
        dim = int(_axes(axis)) if isinstance(_axes(axis), int) else \
            _axes(axis)[0]
    outs = [torch.quantile(x, float(v), dim=dim) for v in qs.reshape(-1)]
    if qs.ndim == 0:
        return outs[0]
    return torch.stack(outs).reshape(qs.shape + tuple(outs[0].shape))


def _median(x, axis=None):
    return _quantile(x, 0.5, axis)


def _average(x, weights=None, axis=None):
    x = _fl(x)
    if weights is None:
        return _mean(x, axis)
    w = _t(weights).to(x.dtype)
    if axis is not None and w.ndim == 1 and x.ndim > 1:
        shp = [1] * x.ndim
        shp[int(axis)] = -1
        w = w.reshape(shp)
    return _sum(x * w, axis) / _sum(torch.broadcast_to(w, x.shape), axis)


def _digitize(x, bins):
    x, bins = _t(x), _t(bins)
    inc = bins[-1] >= bins[0]
    if bool(inc):
        return _i32(torch.searchsorted(bins.contiguous(), x.to(bins.dtype),
                                       right=True))
    rb = torch.flip(bins, (0,)).contiguous()
    return _i32(bins.shape[0] - torch.searchsorted(rb, x.to(bins.dtype),
                                                   right=False))


def _split_sizes(x, sizes, axis=0):
    x = _t(x)
    idx = list(numpy.cumsum(sizes))[:-1]
    return list(torch.tensor_split(x, [int(i) for i in idx], dim=int(axis)))


def _batch_gather(x, idx):
    x, idx = _t(x), _idx(idx)
    return torch.stack([_take(x[b], idx[b], axis=0)
                        for b in range(x.shape[0])])


def _tri_indices(fn):
    def f(n, k=0):
        ij = fn(int(n), int(n), int(k))
        return _i32(ij[0]), _i32(ij[1])
    return f


BASE.update({
    # nan-aware reductions
    "nanmax": _nanred(_nanmax),
    "nanmin": _nanred(_nanmin),
    "nansum": _nanred(lambda x, d: torch.nansum(x, dim=_all(x, d))),
    "nanmean": _nanred(lambda x, d: torch.nanmean(x, dim=_all(x, d))),
    "nanstd": _nanred(lambda x, d: torch.sqrt(_nanvar(x, d))),
    "nanvar": _nanred(_nanvar),
    # order statistics
    "percentile": lambda x, q, axis=None: _quantile(
        x, numpy.asarray(_host(q) if isinstance(q, torch.Tensor) else q,
                         numpy.float32) / numpy.float32(100.0), axis),
    "quantile": _quantile,
    "median": _median,
    "ptp": lambda x, axis=None: _amax(x, _axes(axis)) - _amin(x, _axes(axis)),
    "average": _average,
    "histogram_fixed_width": _histogram_fixed_width,
    "digitize": _digitize,
    # stacking / shaping long tail
    "hstack": lambda *xs: torch.hstack(_promote(*[_t(x) for x in xs])),
    "vstack": lambda *xs: torch.vstack(_promote(*[_t(x) for x in xs])),
    "dstack": lambda *xs: torch.dstack(_promote(*[_t(x) for x in xs])),
    "column_stack": lambda *xs: torch.column_stack(
        _promote(*[_t(x) for x in xs])),
    "atleast_1d": lambda x: torch.atleast_1d(_t(x)),
    "atleast_3d": lambda x: torch.atleast_3d(_t(x)),
    "split_sizes": _split_sizes,
    "eye_like": lambda x: torch.eye(_t(x).shape[-2], _t(x).shape[-1],
                                    dtype=_t(x).dtype, device=_t(x).device),
    "tril_indices": _tri_indices(torch.tril_indices),
    "triu_indices": _tri_indices(torch.triu_indices),
    "nonzero": _nonzero,
    "take": lambda x, idx, axis=None: _take(x, idx, axis),
    "batch_gather": _batch_gather,
    "isin": _isin,
    # scatter-nd family onto an existing tensor
    "scatter_nd_add": _scatter_nd_onto("add"),
    "scatter_nd_sub": lambda ref, i, u: _scatter_nd_onto("add")(
        ref, i, -_t(u)),
    "scatter_nd_update": _scatter_nd_onto("set"),
    "matrix_set_diag": _matrix_set_diag,
})


def _vander(x, n=None):
    return torch.vander(_t(x), N=n)


def _multi_dot(*ms):
    return torch.linalg.multi_dot(list(_promote(*[_t(m) for m in ms])))


LINALG.update({
    "block_diag": _block_diag,
    "toeplitz": _toeplitz,
    "sqrtm": _sqrtm,
    "cho_factor": _cho_factor,
    "cho_solve": _cho_solve,
    "lu_factor": _lu_factor,
    "lu_solve": _lu_solve,
    "multi_dot": _multi_dot,
    "cond": lambda a: torch.linalg.cond(_t(a)),
    "svdvals": lambda a: torch.linalg.svdvals(_t(a)),
    "norm_nuclear": lambda a: torch.sum(torch.linalg.svdvals(_t(a)), -1),
    "vander": _vander,
    "khatri_rao": lambda a, b: torch.einsum(
        "ik,jk->ijk", _t(a), _t(b)).reshape(
        _t(a).shape[0] * _t(b).shape[0], _t(a).shape[1]),
})


def _alpha_dropout(gen, x, rate):
    """SELU-preserving alpha dropout: dropped units go to
    α' = −scale·α, then an affine correction restores the moments."""
    x = _t(x)
    keep = 1.0 - rate
    alpha_p = -1.7580993408473766
    mask = _bernoulli(gen, keep, x.shape).to(x.device)
    a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
    b = -a * (1 - keep) * alpha_p
    return a * torch.where(mask, x, torch.full((), alpha_p, dtype=x.dtype,
                                               device=x.device)) + b


def _gumbel_softmax(gen, logits, tau=1.0):
    logits = _t(logits)
    g = _gumbel(gen, logits.shape).to(logits.device)
    return torch.softmax((logits + g) / tau, -1)


def _swiglu(x, axis=-1):
    a, b = torch.chunk(_t(x), 2, dim=axis)
    return F.silu(a) * b


NN_EXT.update({
    "gelu_tanh": lambda x: F.gelu(_t(x), approximate="tanh"),
    "gelu_exact": lambda x: F.gelu(_t(x), approximate="none"),
    "hard_shrink": lambda x, lambd=0.5: torch.where(
        torch.abs(_t(x)) > lambd, _t(x), 0.0),
    "soft_shrink": lambda x, lambd=0.5: torch.sign(_t(x)) * _relu(
        torch.abs(_t(x)) - lambd),
    "tanh_shrink": lambda x: _t(x) - torch.tanh(_t(x)),
    "threshold": lambda x, threshold, value: torch.where(
        _t(x) > threshold, _t(x), _like(value, _t(x))),
    "lp_normalize": lambda x, p=2, axis=-1, eps=1e-12: _t(x)
    / torch.clamp_min(torch.sum(torch.abs(_t(x)) ** p, dim=axis,
                                keepdim=True) ** (1.0 / p), eps),
    "pairwise_distance": lambda a, b, p=2.0, eps=1e-6: torch.sum(
        torch.abs(_t(a) - _t(b) + eps) ** p, -1) ** (1.0 / p),
    "gumbel_softmax": _gumbel_softmax,
    "swiglu": _swiglu,
    "alpha_dropout_train": _alpha_dropout,
    "spatial_dropout_train": lambda gen, x, rate: _t(x) * _bernoulli(
        gen, 1 - rate, (_t(x).shape[0],) + (1,) * (_t(x).ndim - 2)
        + (_t(x).shape[-1],)).to(_t(x).device) / (1 - rate),
})


def _max_pool_with_argmax(x, k, s=None, padding="VALID"):
    """(values, argmax within each window) via extracted patches."""
    kh, kw = (k, k) if isinstance(k, int) else tuple(k)
    s = (kh, kw) if s is None else ((s, s) if isinstance(s, int)
                                    else tuple(s))
    x = _t(x)
    c = x.shape[-1]
    patches = _patches(x, (kh, kw), tuple(s), padding)
    b, oh, ow, _ = patches.shape
    p = patches.reshape(b, oh, ow, c, kh * kw)
    return p.amax(-1), _i32(p.argmax(-1))


def _lp_pool2d(x, k, s=None, p=2.0, padding="VALID"):
    kh, kw = (k, k) if isinstance(k, int) else tuple(k)
    s = (kh, kw) if s is None else ((s, s) if isinstance(s, int)
                                    else tuple(s))
    summed = _reduce_window(torch.abs(_t(x)) ** p, (kh, kw), s, padding,
                            "sum")
    return summed ** (1.0 / p)


CNN.update({
    "deconv1d": lambda x, w, stride=2, padding="SAME": _conv_transpose(
        x, w, (stride,), padding),
    "deconv3d": lambda x, w, stride=(2, 2, 2), padding="SAME":
        _conv_transpose(x, w, tuple(stride), padding),
    "max_pool_with_argmax": _max_pool_with_argmax,
    "lp_pool2d": _lp_pool2d,
    "pixel_shuffle": lambda x, r: _depth_to_space(x, int(r)),
    "pixel_unshuffle": lambda x, r: _space_to_depth(x, int(r)),
    "upsampling1d": lambda x, scale=2: torch.repeat_interleave(
        _t(x), int(scale), dim=1),
    "upsampling3d": lambda x, scale=2: torch.repeat_interleave(
        torch.repeat_interleave(torch.repeat_interleave(
            _t(x), int(scale), dim=1), int(scale), dim=2), int(scale),
        dim=3),
})


def _sobel_edges(img):
    """(B, H, W, C) → (B, H, W, C, 2) [dy, dx], reflect-padded."""
    img = _t(img)
    ky = _t(numpy.asarray([[-1, -2, -1], [0, 0, 0], [1, 2, 1]],
                          numpy.float32)).to(img.device, img.dtype)
    kx = ky.T
    c = img.shape[-1]
    k = torch.stack([ky, kx], -1)
    w = torch.zeros((3, 3, c, 2 * c), dtype=img.dtype, device=img.device)
    for ch in range(c):
        w[:, :, ch, 2 * ch:2 * ch + 2] = k
    padded = _pad(img, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="reflect")
    out = _conv_general(padded, w, (1, 1), "VALID")
    return out.reshape(tuple(img.shape[:-1]) + (c, 2))


def _image_gradients(img):
    img = _t(img)
    dy = torch.cat([img[:, 1:] - img[:, :-1], torch.zeros_like(img[:, :1])],
                   1)
    dx = torch.cat([img[:, :, 1:] - img[:, :, :-1],
                    torch.zeros_like(img[:, :, :1])], 2)
    return dy, dx


IMAGE.update({
    "sobel_edges": _sobel_edges,
    "image_gradients": _image_gradients,
    "adjust_gamma": lambda x, gamma=1.0, gain=1.0: gain * _t(x) ** gamma,
    "grayscale_to_rgb": lambda x: torch.broadcast_to(
        _t(x), tuple(_t(x).shape[:-1]) + (3,)).clone(),
    "rgb_to_bgr": lambda x: torch.flip(_t(x), (-1,)),
    "total_variation": lambda x: (
        torch.sum(torch.abs(_t(x)[:, 1:] - _t(x)[:, :-1]), dim=(1, 2, 3))
        + torch.sum(torch.abs(_t(x)[:, :, 1:] - _t(x)[:, :, :-1]),
                    dim=(1, 2, 3))),
    "pad_to_bounding_box": lambda x, off_h, off_w, th, tw: _pad(
        x, ((0, 0), (int(off_h), int(th) - _t(x).shape[1] - int(off_h)),
            (int(off_w), int(tw) - _t(x).shape[2] - int(off_w)), (0, 0))),
    "crop_to_bounding_box": lambda x, off_h, off_w, th, tw: _t(x)[
        :, int(off_h):int(off_h) + int(th),
        int(off_w):int(off_w) + int(tw), :],
})


def _dirichlet(gen, alpha, shape=()):
    alpha = _t(alpha, torch.float32)
    g = _std_gamma(gen, alpha, _shape(shape) + tuple(alpha.shape))
    return g / g.sum(-1, keepdim=True)


def _mvn(gen, mean, cov, shape=()):
    mean, cov = _fl(mean), _fl(cov)
    shape = _shape(shape) or tuple(mean.shape[:-1])
    z = torch.randn(shape + (mean.shape[-1],), generator=gen,
                    device=_gdev(gen)).to(mean.device)
    u, s, _ = torch.linalg.svd(cov)
    factor = u * torch.sqrt(s)[..., None, :]
    return mean + torch.einsum("...ij,...j->...i", factor, z)


def _student_t(gen, df, shape):
    n = _normal(gen, shape)
    g = _std_gamma(gen, torch.full(_shape(shape), df / 2.0), shape)
    return n * torch.sqrt(df / (2.0 * g))


RANDOM.update({
    "dirichlet": _dirichlet,
    "multivariate_normal": _mvn,
    "student_t": _student_t,
    "chisquare": lambda gen, df, shape: 2.0 * _std_gamma(
        gen, torch.full(_shape(shape), df / 2.0), shape),
    "rayleigh": lambda gen, scale, shape: scale * torch.sqrt(
        -2.0 * torch.log1p(-_uniform(gen, shape))),
    "logistic": lambda gen, shape: torch.logit(
        _uniform(gen, shape).clamp(1e-7, 1 - 1e-7)),
    "pareto": lambda gen, b, shape: torch.exp(_exponential(gen, shape) / b),
    "geometric": lambda gen, p, shape: _i32(torch.floor(
        torch.log1p(-_uniform(gen, shape)) / _math.log1p(-p)) + 1),
    "rademacher": lambda gen, shape: _i32(2 * _bernoulli(
        gen, 0.5, shape).to(torch.int32) - 1),
})

LOSS_EXT.update({
    "dice_loss": lambda labels, preds, eps=1e-7: 1.0 - (
        2.0 * torch.sum(_t(labels) * _t(preds)) + eps) / (
        torch.sum(_t(labels)) + torch.sum(_t(preds)) + eps),
    "log_cosh_loss": lambda labels, preds: torch.mean(
        torch.log(torch.cosh(_t(preds) - _t(labels)))),
    "quantile_loss": lambda labels, preds, q=0.5: torch.mean(torch.maximum(
        q * (_t(labels) - _t(preds)), (q - 1.0) * (_t(labels) - _t(preds)))),
    "triplet_margin_loss": lambda anchor, pos, neg, margin=1.0: torch.mean(
        _relu(torch.linalg.vector_norm(_t(anchor) - _t(pos), dim=-1)
              - torch.linalg.vector_norm(_t(anchor) - _t(neg), dim=-1)
              + margin)),
    "margin_ranking_loss": lambda x1, x2, y, margin=0.0: torch.mean(
        _relu(-_t(y) * (_t(x1) - _t(x2)) + margin)),
    "cosine_embedding_loss": lambda x1, x2, y, margin=0.0: torch.mean(
        torch.where(_t(y) > 0, 1.0 - _cos_sim(x1, x2),
                    _relu(_cos_sim(x1, x2) - margin))),
})


def _set_bit(op):
    def f(x, pos):
        x = _t(x)
        bit = _shift_left(torch.ones_like(x), pos)
        return op(x, bit)
    return f


BITWISE.update({
    "set_bit": _set_bit(torch.bitwise_or),
    "clear_bit": _set_bit(lambda x, b: x & ~b),
    "toggle_bit": _set_bit(torch.bitwise_xor),
    "test_bit": lambda x, pos: (_shift_right_logical(x, pos) & 1) != 0,
})

NAMESPACES["fft"] = FFT

MATH_EXT.update({
    "fft": FFT["fft"], "ifft": FFT["ifft"],
    "rfft": FFT["rfft"], "irfft": FFT["irfft"],
})


# -------------------------------------------------------- r4 widening #4 --

def _cond_mask(x, cond, value=0.0):
    x = _t(x)
    c = str(cond).lower()
    table = {
        "eq": lambda: x == value, "neq": lambda: x != value,
        "gt": lambda: x > value, "gte": lambda: x >= value,
        "lt": lambda: x < value, "lte": lambda: x <= value,
        "abs_gt": lambda: torch.abs(x) > value,
        "abs_lt": lambda: torch.abs(x) < value,
        "is_nan": lambda: torch.isnan(x), "is_inf": lambda: torch.isinf(x),
        "not_finite": lambda: ~torch.isfinite(x),
    }
    if c not in table:
        raise ValueError(f"unknown condition '{cond}' "
                         f"(known: {sorted(table)})")
    return table[c]()


def _replace_where(x, replacement, cond, value=0.0):
    x = _t(x)
    return torch.where(_cond_mask(x, cond, value), torch.broadcast_to(
        _like(replacement, x), x.shape), x)


def _compare_and_set(x, compare, set_value, eps=1e-7):
    x = _t(x)
    return torch.where(torch.abs(x - compare) <= eps, _like(set_value, x), x)


def _first_index(x, cond, value=0.0):
    m = _cond_mask(_t(x).reshape(-1), cond, value)
    idx = torch.argmax(m.int())
    return _i32(torch.where(torch.any(m), idx, -1))


def _last_index(x, cond, value=0.0):
    m = _cond_mask(_t(x).reshape(-1), cond, value)
    n = m.shape[0]
    idx = n - 1 - torch.argmax(torch.flip(m, (0,)).int())
    return _i32(torch.where(torch.any(m), idx, -1))


def _merge_max_index(*xs):
    return _i32(torch.argmax(torch.stack([_t(x) for x in xs]), dim=0))


def _rational_tanh(x):
    x = _t(x)
    y = 2.0 * x / 3.0
    a = 1.0 - 1.0 / (1.0 + torch.abs(y) + y * y + 1.41645 * y ** 4)
    return 1.7159 * torch.sign(y) * a


def _check_numerics(x, message="CheckNumerics failed"):
    """Passes ``x`` through; raises on a NaN or an infinity (read on the
    host: a graph that holds it runs eagerly)."""
    x = _t(x)
    if not (x.is_floating_point() or x.is_complex()):
        return x
    if not bool(torch.isfinite(x).all()):
        raise FloatingPointError(f"{message}: non-finite values present")
    return x


def _all_pairs(fn):
    """x (N, D), y (M, D) → (N, M)."""
    def f(x, y):
        x, y = _t(x), _t(y)
        return fn(x[:, None, :], y[None, :, :])
    return f


def _histogram(x, nbins, range=None):  # noqa: A002
    x = _fl(x).reshape(-1)
    lo, hi = (float(x.min()), float(x.max())) if range is None else \
        (float(range[0]), float(range[1]))
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    edges = torch.linspace(lo, hi, int(nbins) + 1, dtype=torch.float32,
                           device=x.device)
    idx = torch.searchsorted(edges, x, right=True) - 1
    idx = torch.where(x == edges[-1], int(nbins) - 1, idx)
    keep = (idx >= 0) & (idx < int(nbins))
    return _bincount(torch.where(keep, idx, int(nbins)),
                     int(nbins)).float()


BASE.update({
    "replace_where": _replace_where,
    "compare_and_set": _compare_and_set,
    "standard_deviation": BASE["std"],
    "histogram": _histogram,
    "check_numerics": _check_numerics,
})

MATH_EXT.update({
    "cube": lambda x: _t(x) * _t(x) * _t(x),
    "lerp": lambda a, b, w: a + w * (b - a) if all(
        isinstance(v, (int, float)) for v in (a, b, w))
    else _t(a) + w * (_t(b) - _t(a)),   # Python numbers stay numbers
    "rational_tanh": _rational_tanh,
    "rectified_tanh": lambda x: torch.clamp_min(torch.tanh(_t(x)), 0.0),
    "first_index": _first_index,
    "last_index": _last_index,
    "merge_max_index": _merge_max_index,
    "all_euclidean": _all_pairs(lambda a, b: torch.sqrt(torch.sum(
        torch.square(a - b), -1))),
    "all_manhattan": _all_pairs(lambda a, b: torch.sum(torch.abs(a - b),
                                                       -1)),
    "all_cosine_similarity": _all_pairs(
        lambda a, b: torch.sum(a * b, -1) / torch.clamp_min(
            torch.linalg.vector_norm(a, dim=-1)
            * torch.linalg.vector_norm(b, dim=-1), 1e-12)),
    "all_cosine_distance": _all_pairs(
        lambda a, b: 1.0 - torch.sum(a * b, -1) / torch.clamp_min(
            torch.linalg.vector_norm(a, dim=-1)
            * torch.linalg.vector_norm(b, dim=-1), 1e-12)),
    "all_dot": _all_pairs(lambda a, b: torch.sum(a * b, -1)),
    "all_hamming": _all_pairs(lambda a, b: _sum(a != b, -1)),
    "all_jaccard": _all_pairs(lambda a, b: 1.0 - torch.sum(
        torch.minimum(a, b), -1) / torch.clamp_min(torch.sum(
            torch.maximum(a, b), -1), 1e-12)),
})


def _fake_quant(x, min=-6.0, max=6.0, num_bits=8,  # noqa: A002
                narrow_range=False):
    x = _t(x)
    qmin = 1 if narrow_range else 0
    qmax = 2 ** int(num_bits) - 1
    scale = (max - min) / (qmax - qmin)
    zero = qmin - min / scale
    nudged_zero = _clip(torch.round(_t(zero, torch.float32).to(x.device)),
                        qmin, qmax)
    nudged_min = (qmin - nudged_zero) * scale
    nudged_max = (qmax - nudged_zero) * scale
    clipped = torch.clamp(x, nudged_min, nudged_max)
    q = torch.round((clipped - nudged_min) / scale)
    return q * scale + nudged_min


def _quantize(x, scale, zero_point, num_bits=8, signed=False):
    x = _t(x)
    qmin = -(2 ** (num_bits - 1)) if signed else 0
    qmax = 2 ** (num_bits - 1) - 1 if signed else 2 ** num_bits - 1
    dt = (torch.int8 if signed and num_bits <= 8 else
          torch.uint8 if num_bits <= 8 else torch.int32)
    return torch.clamp(torch.round(x / scale) + zero_point, qmin,
                       qmax).to(dt)


NN_EXT.update({
    "crelu": lambda x, axis=-1: torch.cat(
        [_relu(_t(x)), _relu(-_t(x))], dim=axis),
    "relu_layer": lambda x, w, b: _relu(_t(x) @ _t(w) + _t(b)),
    "fake_quant_with_min_max_args": _fake_quant,
    "fake_quant_with_min_max_vars": _fake_quant,
    "quantize": _quantize,
    "dequantize": lambda q, scale, zero_point: (
        _t(q).float() - zero_point) * scale,
})


def _sru_cell(x, c, w, b):
    x, c, w, b = (_t(v) for v in (x, c, w, b))
    d = c.shape[-1]
    z = x @ w
    xt, f_in, r_in = z[..., :d], z[..., d:2 * d], z[..., 2 * d:]
    f = torch.sigmoid(f_in + b[:d])
    r = torch.sigmoid(r_in + b[d:])
    c2 = f * c + (1.0 - f) * xt
    h = r * torch.tanh(c2) + (1.0 - r) * x[..., :d]
    return h, c2


def _sru(x, c0, w, b):
    """SRU over (B, T, D): the matmuls batched over T first, then the
    elementwise recurrence step by step."""
    x, c, w, b = (_t(v) for v in (x, c0, w, b))
    d = c.shape[-1]
    z = x @ w
    f = torch.sigmoid(z[..., d:2 * d] + b[:d])
    r = torch.sigmoid(z[..., 2 * d:] + b[d:])
    xt = z[..., :d]
    hs = []
    for t in range(x.shape[1]):
        c = f[:, t] * c + (1.0 - f[:, t]) * xt[:, t]
        hs.append(r[:, t] * torch.tanh(c) + (1.0 - r[:, t])
                  * x[:, t, ..., :d])
    return torch.stack(hs, dim=1)


RNN.update({
    "sru_cell": _sru_cell,
    "sru": _sru,
    "simple_rnn_layer": _rnn_layer(cell_has_c=False,
                                   cell=RNN["simple_rnn_cell"]),
    "lstm_block_cell": _lstm_cell,
    "lstm_block": _rnn_layer(cell_has_c=True),
})


def _dilation2d(x, filt, strides=(1, 1), rates=(1, 1), padding="SAME"):
    """out[b,y,x,c] = max over the taps of in[b, y·s+dy·r, x·s+dx·r, c] +
    filt[dy, dx, c]; TF's SAME padding with −inf."""
    x, filt = _t(x), _t(filt)
    kh, kw = filt.shape[0], filt.shape[1]
    sh, sw = strides
    rh, rw = rates
    if padding.upper() == "SAME":
        pads = _same_pads(x.shape[1:3], (kh, kw), (sh, sw), (rh, rw))
        x = _pad_spatial(x, pads, value=float("-inf"))
    h_out = (x.shape[1] - (kh - 1) * rh - 1) // sh + 1
    w_out = (x.shape[2] - (kw - 1) * rw - 1) // sw + 1
    taps = []
    for dy in range(kh):
        for dx in range(kw):
            sl = x[:, dy * rh:dy * rh + h_out * sh:sh,
                   dx * rw:dx * rw + w_out * sw:sw, :]
            taps.append(sl + filt[dy, dx])
    return torch.amax(torch.stack(taps), dim=0)


def _erosion2d(x, filt, strides=(1, 1), rates=(1, 1), padding="SAME"):
    return -_dilation2d(-_t(x), torch.flip(_t(filt), (0, 1)), strides,
                        rates, padding)


CNN.update({
    "dilation2d": _dilation2d,
    "erosion2d": _erosion2d,
    "pnorm_pool2d": CNN["lp_pool2d"],
})


def _nms_overlaps(overlaps, scores, max_out, overlap_threshold=0.5,
                  score_threshold=float("-inf")):
    overlaps = _t(overlaps)
    return _greedy_nms(scores, max_out,
                       lambda i: overlaps.index_select(0, i)[0],
                       overlap_threshold, score_threshold)


def _resize_area(x, h, w):
    """Block mean for integer downscale factors, else bilinear."""
    x = _t(x)
    b, ih, iw, c = x.shape
    h, w = int(h), int(w)
    if ih % h == 0 and iw % w == 0:
        fh, fw = ih // h, iw // w
        return x.reshape(b, h, fh, w, fw, c).mean(dim=(2, 4))
    return _jax_resize(x, (b, h, w, c), "linear")


def _draw_bounding_boxes(images, boxes, colors=None):
    images, boxes = _t(images), _t(boxes)
    b, h, w, c = images.shape
    n = boxes.shape[1]
    if colors is None:                  # max intensity in channel 0
        colors = (torch.arange(c, device=images.device) == 0).to(
            images.dtype)[None]
    colors = _t(colors).to(images.dtype)
    ys = torch.arange(h, device=images.device)[:, None]
    xs = torch.arange(w, device=images.device)[None, :]
    out = []
    for bi in range(b):
        img = images[bi]
        for i in range(n):
            box = boxes[bi, i]
            y1 = (box[0] * (h - 1)).to(torch.int32)
            x1 = (box[1] * (w - 1)).to(torch.int32)
            y2 = (box[2] * (h - 1)).to(torch.int32)
            x2 = (box[3] * (w - 1)).to(torch.int32)
            in_y = (ys >= y1) & (ys <= y2)
            in_x = (xs >= x1) & (xs <= x2)
            edge = (in_y & in_x) & ((ys == y1) | (ys == y2) | (xs == x1)
                                    | (xs == x2))
            img = torch.where(edge[..., None], colors[i % colors.shape[0]],
                              img)
        out.append(img)
    return torch.stack(out)


IMAGE.update({
    "non_max_suppression_overlaps": _nms_overlaps,
    "resize_area": _resize_area,
    "draw_bounding_boxes": _draw_bounding_boxes,
})


def _wrap_loss(name):
    def f(*args, **kw):
        from ..nn import losses as _nnl
        return _nnl.get(name)(*[_t(a) if isinstance(a, (
            numpy.ndarray, list)) else a for a in args], **kw)
    return f


def _mpse(labels, preds):
    d = (_t(preds) - _t(labels)).reshape(_t(labels).shape[0], -1)
    n = d.shape[1]
    per = torch.sum(torch.square(d[:, :, None] - d[:, None, :]), dim=(1, 2)) \
        / 2.0 / max(n * (n - 1) / 2.0, 1.0)
    return torch.mean(per)


LOSS_EXT.update({
    "mean_pairwise_squared_error": _mpse,
    "multi_label_loss": _wrap_loss("multi_label"),
    "mae_loss": _wrap_loss("mae"),
    "mape_loss": _wrap_loss("mape"),
    "msle_loss": _wrap_loss("msle"),
    "wasserstein_loss": _wrap_loss("wasserstein"),
    "fmeasure_loss": _wrap_loss("fmeasure"),
    "mixture_density_loss": _wrap_loss("mixture_density"),
})

LINALG.update({
    "adjoint": lambda x: torch.conj_physical(torch.swapaxes(_t(x), -1, -2)),
    "matrix_inverse": LINALG["inv"],
    "matrix_determinant": LINALG["det"],
})


def _multinomial(gen, logits, num_samples):
    """tf.multinomial: logits (B, K), an int → (B, num_samples) draws."""
    logits = _fl(logits)
    batch = tuple(logits.shape[:-1])
    out = _categorical(gen, logits.expand((int(num_samples),) + batch
                                          + (logits.shape[-1],)))
    return torch.movedim(out, 0, -1)


RANDOM.update({
    "multinomial": _multinomial,
})

BITWISE.update({
    "bit_rotl": BITWISE["cyclic_shift_left"],
    "bit_rotr": BITWISE["cyclic_shift_right"],
})


def _space_to_batch_nd(x, block_shape, paddings):
    x = _t(x)
    bs = [int(b) for b in block_shape]
    pads = [(0, 0)] + [tuple(int(v) for v in p) for p in paddings] \
        + [(0, 0)] * (x.ndim - 1 - len(bs))
    x = _pad(x, pads)
    b = x.shape[0]
    spatial = x.shape[1:1 + len(bs)]
    rest = list(x.shape[1 + len(bs):])
    shape = [b]
    for s, blk in zip(spatial, bs):
        shape += [s // blk, blk]
    x = x.reshape(shape + rest)
    perm = [2 * i + 2 for i in range(len(bs))] + [0] \
        + [2 * i + 1 for i in range(len(bs))] \
        + list(range(1 + 2 * len(bs), x.ndim))
    x = x.permute(perm)
    return x.reshape([b * _math.prod(bs)] + [s // blk for s, blk in
                                             zip(spatial, bs)] + rest)


def _batch_to_space_nd(x, block_shape, crops):
    x = _t(x)
    bs = [int(b) for b in block_shape]
    nb = x.shape[0] // _math.prod(bs)
    spatial = list(x.shape[1:1 + len(bs)])
    rest = list(x.shape[1 + len(bs):])
    x = x.reshape(bs + [nb] + spatial + rest)
    perm = [len(bs)]
    for i in range(len(bs)):
        perm += [len(bs) + 1 + i, i]
    perm += list(range(1 + 2 * len(bs), x.ndim))
    x = x.permute(perm)
    x = x.reshape([nb] + [s * blk for s, blk in zip(spatial, bs)] + rest)
    sl = [slice(None)]
    for (c0, c1), s in zip(crops, x.shape[1:1 + len(bs)]):
        sl.append(slice(int(c0), s - int(c1)))
    return x[tuple(sl)]


def _image_resize(x, h, w, method="bilinear"):
    m = str(method).lower()
    if m in ("area",):
        return _resize_area(x, h, w)
    table = {"bilinear": "linear", "linear": "linear",
             "nearest": "nearest", "neighbor": "nearest",
             "bicubic": "cubic", "cubic": "cubic",
             "lanczos3": "lanczos3", "lanczos5": "lanczos5"}
    if m not in table:
        raise ValueError(f"unknown resize method '{method}'")
    x = _t(x)
    b, _, _, c = x.shape
    return _jax_resize(x, (b, int(h), int(w), c), table[m])


BASE.update({
    "space_to_batch_nd": _space_to_batch_nd,
    "batch_to_space_nd": _batch_to_space_nd,
    "tear": BASE["unstack"],
})

MATH_EXT.update({
    "eps": lambda x, y, eps=1e-5: torch.abs(_t(x) - _t(y)) < eps,
    "axpy": lambda a, x, y: a * _t(x) + _t(y),
    "to_degrees": MATH_EXT["rad2deg"],
    "to_radians": MATH_EXT["deg2rad"],
})

NN_EXT.update({
    "precise_gelu": NN_EXT["gelu_exact"],
    "thresholded_relu": lambda x, theta=1.0: torch.where(
        _t(x) > theta, _t(x), 0.0),
})

RNN.update({
    "gru": RNN["gru_layer"],
})

IMAGE.update({
    "image_resize": _image_resize,
    "adjust_contrast_v2": IMAGE["adjust_contrast"],
})

LOSS_EXT.update({
    "log_poisson": LOSS_EXT["log_poisson_loss"],
})


# ------------------------------------------------------- r4 widening #4b --
# updater ops: (grad, *state, hyperparams...) -> (update, *new_state)

def _adam_moments(g, m, v, b1, b2):
    m2 = b1 * _t(m) + (1 - b1) * _t(g)
    v2 = b2 * _t(v) + (1 - b2) * torch.square(_t(g))
    return m2, v2


def _u_sgd(g, lr=0.1):
    return (lr * _t(g),)


def _u_momentum(g, v, lr=0.1, momentum=0.9):
    v2 = momentum * _t(v) + _t(g)
    return lr * v2, v2


def _u_nesterovs(g, v, lr=0.1, momentum=0.9):
    v2 = momentum * _t(v) + _t(g)
    return lr * (_t(g) + momentum * v2), v2


def _u_adagrad(g, s, lr=0.01, eps=1e-6):
    s2 = _t(s) + torch.square(_t(g))
    return lr * _t(g) / (torch.sqrt(s2) + eps), s2


def _u_rmsprop(g, s, lr=0.001, rho=0.95, eps=1e-8):
    s2 = rho * _t(s) + (1 - rho) * torch.square(_t(g))
    return lr * _t(g) / torch.sqrt(s2 + eps), s2


def _u_adadelta(g, s, d, rho=0.95, eps=1e-6):
    s2 = rho * _t(s) + (1 - rho) * torch.square(_t(g))
    u = _t(g) * torch.sqrt(_t(d) + eps) / torch.sqrt(s2 + eps)
    d2 = rho * _t(d) + (1 - rho) * torch.square(u)
    return u, s2, d2


def _u_adam(g, m, v, t, lr=0.001, beta1=0.9, beta2=0.999, eps=1e-8):
    m2, v2 = _adam_moments(g, m, v, beta1, beta2)
    mhat = m2 / (1 - beta1 ** t)
    vhat = v2 / (1 - beta2 ** t)
    return lr * mhat / (torch.sqrt(vhat) + eps), m2, v2


def _u_adamax(g, m, u, t, lr=0.002, beta1=0.9, beta2=0.999, eps=1e-8):
    m2 = beta1 * _t(m) + (1 - beta1) * _t(g)
    u2 = torch.maximum(beta2 * _t(u), torch.abs(_t(g)))
    return lr / (1 - beta1 ** t) * m2 / (u2 + eps), m2, u2


def _u_nadam(g, m, v, t, lr=0.001, beta1=0.9, beta2=0.999, eps=1e-8):
    m2, v2 = _adam_moments(g, m, v, beta1, beta2)
    mhat = m2 / (1 - beta1 ** t)
    vhat = v2 / (1 - beta2 ** t)
    nud = beta1 * mhat + (1 - beta1) * _t(g) / (1 - beta1 ** t)
    return lr * nud / (torch.sqrt(vhat) + eps), m2, v2


def _u_amsgrad(g, m, v, vmax, t, lr=0.001, beta1=0.9, beta2=0.999,
               eps=1e-8):
    m2, v2 = _adam_moments(g, m, v, beta1, beta2)
    vmax2 = torch.maximum(_t(vmax), v2)
    mhat = m2 / (1 - beta1 ** t)
    return lr * mhat / (torch.sqrt(vmax2) + eps), m2, v2, vmax2


UPDATER = {
    "sgd_updater": _u_sgd,
    "momentum_updater": _u_momentum,
    "nesterovs_updater": _u_nesterovs,
    "ada_grad_updater": _u_adagrad,
    "rms_prop_updater": _u_rmsprop,
    "ada_delta_updater": _u_adadelta,
    "adam_updater": _u_adam,
    "ada_max_updater": _u_adamax,
    "nadam_updater": _u_nadam,
    "ams_grad_updater": _u_amsgrad,
}

# ----------------------------------------------------------- signal ops --


def _np_window(kind, n):
    """numpy's symmetric windows, as ``jnp.hanning`` & co. compute them
    (in float32)."""
    if n == 1:
        return torch.ones(1, dtype=torch.float32)
    k = torch.arange(n, dtype=torch.float32)
    if kind == "hann":
        return 0.5 - 0.5 * torch.cos(2.0 * _math.pi * k / (n - 1))
    if kind == "hamming":
        return 0.54 - 0.46 * torch.cos(2.0 * _math.pi * k / (n - 1))
    if kind == "blackman":
        return (0.42 - 0.5 * torch.cos(2.0 * _math.pi * k / (n - 1))
                + 0.08 * torch.cos(4.0 * _math.pi * k / (n - 1)))
    if kind == "bartlett":
        return 1.0 - torch.abs(2.0 * k / (n - 1) - 1.0)
    raise ValueError(kind)


def _window(kind, n, periodic=True):
    n = int(n)
    if kind == "kaiser":
        raise ValueError("use kaiser_window(n, beta)")
    if n < 1:
        return torch.zeros(0, dtype=torch.float32)
    return _np_window(kind, n + 1)[:-1] if periodic else _np_window(kind, n)


def _kaiser(n, beta=12.0):
    n = int(n)
    if n == 1:
        return torch.ones(1, dtype=torch.float32)
    k = torch.arange(n, dtype=torch.float32)
    alpha = (n - 1) / 2.0
    arg = beta * torch.sqrt(1 - ((k - alpha) / alpha) ** 2)
    return torch.special.i0(arg) / torch.special.i0(
        torch.full((), float(beta)))


def _frame(x, frame_length, frame_step, pad_end=False, pad_value=0.0):
    x = _t(x)
    fl, fs = int(frame_length), int(frame_step)
    n = x.shape[-1]
    if pad_end:
        n_frames = -(-n // fs)
        need = (n_frames - 1) * fs + fl
        x = F.pad(x, (0, max(0, need - n)), value=pad_value)
    else:
        n_frames = 1 + (n - fl) // fs
    idx = (torch.arange(n_frames, device=x.device)[:, None] * fs
           + torch.arange(fl, device=x.device)[None, :])
    return x[..., idx]


def _overlap_and_add(frames, frame_step):
    frames = _t(frames)
    fs = int(frame_step)
    n_frames, fl = frames.shape[-2], frames.shape[-1]
    out_len = (n_frames - 1) * fs + fl
    idx = (torch.arange(n_frames, device=frames.device)[:, None] * fs
           + torch.arange(fl, device=frames.device)[None, :]).reshape(-1)
    lead = tuple(frames.shape[:-2])
    out = torch.zeros(lead + (out_len,), dtype=frames.dtype,
                      device=frames.device)
    return out.index_add(out.ndim - 1, idx, frames.reshape(lead + (-1,)))


def _stft(x, frame_length=256, frame_step=128, fft_length=None,
          window="hann", pad_end=False):
    fl = int(frame_length)
    nfft = int(fft_length or fl)
    frames = _frame(_fl(x), fl, frame_step, pad_end=pad_end)
    if window is not None:
        frames = frames * _window(window, fl, periodic=True).to(
            frames.device)
    return torch.fft.rfft(frames, n=nfft, dim=-1)


def _istft(spec, frame_length=256, frame_step=128, fft_length=None,
           window="hann"):
    spec = _t(spec)
    fl, fs = int(frame_length), int(frame_step)
    nfft = int(fft_length or fl)
    frames = torch.fft.irfft(spec, n=nfft, dim=-1)[..., :fl]
    w = (_window(window, fl, periodic=True) if window is not None
         else torch.ones((fl,))).to(frames.device)
    frames = frames * w
    n_frames = frames.shape[-2]
    out = _overlap_and_add(frames, fs)
    norm = _overlap_and_add(torch.broadcast_to(torch.square(w),
                                               (n_frames, fl)), fs)
    return out / torch.clamp_min(norm, 1e-12)


def _mel_matrix(num_mel_bins=20, num_spectrogram_bins=129,
                sample_rate=8000, lower_edge_hertz=125.0,
                upper_edge_hertz=3800.0):
    def hz_to_mel(f):
        return 2595.0 * torch.log10(1.0 + f / 700.0)

    def hz_to_mel_host(f):            # the band edges, f32 on the host
        f = numpy.float32(f)
        return float(numpy.float32(2595.0) * numpy.log10(
            numpy.float32(1.0) + f / numpy.float32(700.0)))
    nyq = sample_rate / 2.0
    freqs = torch.linspace(0.0, nyq, int(num_spectrogram_bins),
                           dtype=torch.float32)
    mel_f = hz_to_mel(freqs)
    edges = torch.linspace(hz_to_mel_host(lower_edge_hertz),
                           hz_to_mel_host(upper_edge_hertz),
                           int(num_mel_bins) + 2, dtype=torch.float32)
    lo, ctr, hi = edges[:-2], edges[1:-1], edges[2:]
    up = (mel_f[:, None] - lo[None, :]) / (ctr - lo)[None, :]
    down = (hi[None, :] - mel_f[:, None]) / (hi - ctr)[None, :]
    return torch.clamp_min(torch.minimum(up, down), 0.0)


def _mfcc(log_mel, n_mfcc=13):
    log_mel = _t(log_mel)
    n = log_mel.shape[-1]
    k = torch.arange(n, dtype=torch.float32, device=log_mel.device)
    basis = torch.cos(_math.pi / n * (k[:, None] + 0.5) * k[None, :])
    scale = torch.cat([torch.full((1,), 1.0 / _math.sqrt(float(n))),
                       torch.full((n - 1,), _math.sqrt(2.0 / n))]).to(
        log_mel.device)
    return (log_mel @ basis * scale)[..., :int(n_mfcc)]


SIGNAL = {
    "stft": _stft,
    "istft": _istft,
    "frame": _frame,
    "overlap_and_add": lambda frames, frame_step: _overlap_and_add(
        frames, frame_step),
    "hann_window": lambda n, periodic=True: _window("hann", n, periodic),
    "hamming_window": lambda n, periodic=True: _window(
        "hamming", n, periodic),
    "blackman_window": lambda n, periodic=True: _window(
        "blackman", n, periodic),
    "bartlett_window": lambda n, periodic=True: _window(
        "bartlett", n, periodic),
    "kaiser_window": _kaiser,
    "linear_to_mel_weight_matrix": _mel_matrix,
    "mfcc": _mfcc,
}

# ----------------------------------------------------------- assert ops --
# Eager checks that raise (the reference's eager path; its traced
# ``checkify`` path has no counterpart: a graph holding one runs eagerly).


def _assert_all(ok, msg, ret):
    if not bool(torch.all(_t(ok))):
        raise AssertionError(msg)
    return ret


def _assert2(name, fn):
    def op(x, y):
        a, b = _bin(x, y)
        return _assert_all(fn(a, b), f"assert_{name} failed", x)
    return op


ASSERT = {
    "assert_true": lambda cond, msg="assertion failed": _assert_all(
        cond, msg, cond),
    "assert_eq": _assert2("eq", torch.eq),
    "assert_neq": _assert2("neq", torch.ne),
    "assert_gt": _assert2("gt", torch.gt),
    "assert_gte": _assert2("gte", torch.ge),
    "assert_lt": _assert2("lt", torch.lt),
    "assert_lte": _assert2("lte", torch.le),
    "assert_finite": lambda x: _assert_all(
        torch.isfinite(_t(x)), "assert_finite failed", x),
    "assert_positive": lambda x: _assert_all(
        _t(x) > 0, "assert_positive failed", x),
    "assert_non_negative": lambda x: _assert_all(
        _t(x) >= 0, "assert_non_negative failed", x),
    "assert_rank": lambda x, rank: _assert_all(
        torch.as_tensor(_t(x).ndim == int(rank)),
        "assert_rank failed", x),
    "assert_shapes_equal": lambda x, y: _assert_all(
        torch.as_tensor(tuple(_t(x).shape) == tuple(_t(y).shape)),
        "assert_shapes_equal failed", x),
}

# ------------------------------------- image augmentation + affine ops --


def _map_coordinates(img, ys, xs, order=1, cval=0.0):
    """``jax.scipy.ndimage.map_coordinates`` on a 2-D array, constant
    mode: each tap outside the array is ``cval``."""
    h, w = img.shape
    if order == 0:
        def taps(c):
            i = torch.where(c >= 0, torch.floor(c + 0.5),
                            torch.ceil(c - 0.5)).long()
            return [(i, torch.ones_like(c))]
    else:
        def taps(c):
            lo = torch.floor(c)
            up = c - lo
            return [(lo.long(), 1.0 - up), (lo.long() + 1, up)]
    out = torch.zeros_like(ys, dtype=img.dtype)
    for (iy, wy), (ix, wx) in itertools.product(taps(ys), taps(xs)):
        valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
        v = img[iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
        v = torch.where(valid, v, torch.full((), cval, dtype=img.dtype,
                                             device=img.device))
        out = out + wy * wx * v
    return out.to(img.dtype)


def _affine_sample(img, matrix, order=1, cval=0.0):
    """Sample (H, W, C) or (B, H, W, C) through a 2x3 inverse affine map
    (output pixel → input coordinates)."""
    img = _t(img)
    m = _t(matrix, torch.float32).to(img.device).reshape(2, 3)

    def one(im):
        h, w = im.shape[0], im.shape[1]
        ys, xs = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=im.device),
            torch.arange(w, dtype=torch.float32, device=im.device),
            indexing="ij")
        xin = m[0, 0] * xs + m[0, 1] * ys + m[0, 2]
        yin = m[1, 0] * xs + m[1, 1] * ys + m[1, 2]
        return torch.stack([_map_coordinates(im[..., i], yin, xin, order,
                                             cval)
                            for i in range(im.shape[-1])], dim=-1)
    if img.ndim == 4:
        return torch.stack([one(im) for im in img])
    return one(img)


def _rotate_img(img, angle, order=1, cval=0.0):
    img = _t(img)
    h, w = img.shape[-3], img.shape[-2]
    a = _t(angle, torch.float32)
    c, s = torch.cos(a), torch.sin(a)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    m = torch.stack([torch.stack([c, -s, cx - c * cx + s * cy]),
                     torch.stack([s, c, cy - s * cx - c * cy])])
    return _affine_sample(img, m, order=order, cval=cval)


def _translate_img(img, dx, dy, order=1, cval=0.0):
    m = numpy.asarray([[1.0, 0.0, -float(dx)], [0.0, 1.0, -float(dy)]],
                      numpy.float32)
    return _affine_sample(img, m, order=order, cval=cval)


def _per_image_mask(gen, img, p=0.5):
    if img.ndim == 4:
        return _bernoulli(gen, p, (img.shape[0], 1, 1, 1)).to(img.device)
    return _bernoulli(gen, p, ()).to(img.device)


def _rand_scalar(gen, lo, hi):
    return _uniform(gen, (), lo, hi)


IMAGE.update({
    "random_flip_left_right": lambda gen, img: torch.where(
        _per_image_mask(gen, _t(img)), torch.flip(_t(img), (-2,)), _t(img)),
    "random_flip_up_down": lambda gen, img: torch.where(
        _per_image_mask(gen, _t(img)), torch.flip(_t(img), (-3,)), _t(img)),
    "random_brightness": lambda gen, img, max_delta: _t(img) + _rand_scalar(
        gen, -max_delta, max_delta).to(_t(img).device),
    "random_contrast": lambda gen, img, lower, upper: _adjust_contrast(
        img, _rand_scalar(gen, lower, upper).to(_t(img).device)),
    "random_hue": lambda gen, img, max_delta: _adjust_hue(
        img, _rand_scalar(gen, -max_delta, max_delta).to(_t(img).device)),
    "random_saturation": lambda gen, img, lower, upper: _adjust_saturation(
        img, _rand_scalar(gen, lower, upper).to(_t(img).device)),
    "rotate": _rotate_img,
    "translate": _translate_img,
    "affine_transform": _affine_sample,
})

# ------------------------------------------------------ mechanical tail --


def _mirror_pad(x, paddings, mode="REFLECT"):
    return _pad(x, paddings, mode={"REFLECT": "reflect",
                                   "SYMMETRIC": "symmetric"}[
        str(mode).upper()])


def _nth_element(x, n, reverse=False):
    x = _t(x)
    s = torch.sort(x, dim=-1).values
    return s[..., x.shape[-1] - 1 - int(n)] if reverse else s[..., int(n)]


def _sparse_to_dense(indices, output_shape, values, default_value=0):
    idx = _idx(indices)
    if idx.ndim == 1:
        idx = idx[:, None]
    vals = _t(values)
    out = torch.full(tuple(int(s) for s in output_shape), default_value,
                     dtype=vals.dtype, device=vals.device)
    out[tuple(idx[..., i] for i in range(idx.shape[-1]))] = vals
    return out


def _sufficient_statistics(x, axes, shift=None):
    x = _t(x)
    axes = tuple(_axes(axes)) if not isinstance(axes, int) else (axes,)
    count = _scalar(float(_math.prod(x.shape[a] for a in axes)),
                    torch.float32, x.device)
    xs = x - shift if shift is not None else x
    return count, torch.sum(xs, axes), torch.sum(torch.square(xs), axes), \
        shift


def _mode(x, axis=-1):
    x = _t(x)
    s = torch.sort(torch.movedim(x, axis, -1), dim=-1).values
    counts = torch.sum(s[..., :, None] == s[..., None, :], dim=-1)
    return torch.gather(s, -1, torch.argmax(counts, dim=-1)[..., None])[..., 0]


def _hashcode(x):
    """Java-style polynomial fold of the raw 32-bit patterns, in uint32
    wraparound (held in int64 and masked)."""
    b = _t(x)
    if b.dtype == torch.bool:
        b = b.to(torch.int32)
    if b.element_size() != 4:
        b = b.to(torch.float32)
    bits = b.view(torch.int32).reshape(-1).long() & 0xFFFFFFFF
    n = bits.numel()
    # the reference's weights: the uint32 cumprod of 31 (31 ** k mod
    # 2**32, k = 1..n), reversed, floor-divided by 31
    vals, acc = [], 1
    for _ in range(n):
        acc = (acc * 31) & 0xFFFFFFFF
        vals.append(acc // 31)
    p = _t(numpy.asarray(vals[::-1], numpy.int64)).to(bits.device).long()
    tot = torch.sum((bits * p) & 0xFFFFFFFF) & 0xFFFFFFFF
    return _wrap_to(tot, torch.int32, 32)


def _set_fill(dtype):
    return float("inf") if dtype.is_floating_point else \
        torch.iinfo(dtype).max


def _array_equal(a, b):
    a, b = _t(a), _t(b)
    if tuple(a.shape) != tuple(b.shape):
        return torch.zeros((), dtype=torch.bool, device=a.device)
    a, b = _promote(a, b)
    return torch.all(torch.eq(a, b))


def _intersect1d(a, b, size):
    a = _t(a)
    fill = _set_fill(a.dtype)
    av = _unique_sized(a, size, fill=fill)[0]
    mask = _isin(av, b)
    return torch.where(mask, av, torch.full((), fill, dtype=av.dtype,
                                            device=av.device))


def _union1d(a, b, size):
    c = torch.cat(_promote(_t(a).reshape(-1), _t(b).reshape(-1)))
    return _unique_sized(c, size, fill=_set_fill(c.dtype))[0]


def _unravel_index(flat, shape):
    flat = _t(flat)
    shape = tuple(int(s) for s in shape)
    total = _math.prod(shape)
    f = torch.clamp(flat.long(), -total, total - 1)
    f = torch.where(f < 0, f + total, f)
    out = []
    for s in reversed(shape):
        out.append(_i32(torch.remainder(f, s)))
        f = torch.div(f, s, rounding_mode="floor")
    return tuple(reversed(out))


def _ravel_multi_index(multi, shape):
    shape = tuple(int(s) for s in shape)
    out = None
    for m, s in zip(multi, shape):
        m = torch.clamp(_t(m).long(), 0, s - 1)
        out = m if out is None else out * s + m
    return _i32(out)


def _put_along_axis(x, idx, vals, axis):
    x = _t(x).clone()
    idx = _idx(idx)
    v = torch.broadcast_to(_like(vals, x) if not isinstance(
        vals, torch.Tensor) else vals.to(x.dtype), idx.shape)
    return x.scatter(int(axis), idx, v)


def _bitcast(x, dtype):
    x = _t(x)
    dt = dtype_of(dtype)
    return x.view(dt)


BASE.update({
    "add_n": lambda *xs: sum((_t(x) for x in xs[1:]), start=_t(xs[0])),
    "accumulate_n": lambda *xs: sum((_t(x) for x in xs[1:]),
                                    start=_t(xs[0])),
    "identity_n": lambda *xs: [_t(x) for x in xs],
    "mirror_pad": _mirror_pad,
    "nth_element": _nth_element,
    "bitcast": _bitcast,
    "broadcast_shapes": lambda *shapes: _t(numpy.asarray(
        torch.broadcast_shapes(*(tuple(s) for s in shapes)), numpy.int32)),
    "broadcast_dynamic_shape": lambda s1, s2: _t(numpy.asarray(
        torch.broadcast_shapes(tuple(int(v) for v in _host(s1)),
                               tuple(int(v) for v in _host(s2))),
        numpy.int32)),
    "sparse_to_dense": _sparse_to_dense,
    "sufficient_statistics": _sufficient_statistics,
    "mode": _mode,
    "hashcode": _hashcode,
    "array_equal": lambda a, b: _array_equal(a, b),
    "setdiff1d": BASE["list_diff"],
    "intersect1d": _intersect1d,
    "union1d": lambda a, b, size: _union1d(a, b, size),
    "unravel_index": _unravel_index,
    "ravel_multi_index": _ravel_multi_index,
    "put_along_axis": _put_along_axis,
    "bucketize": BASE["digitize"],
    "reverse_v2": BASE["reverse"],
    "take_nd": BASE["gather_nd"],
})


def _host(v):
    """A small value read as host numbers (a tensor on the card is read
    back: only ever a shape or an index list)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().reshape(-1).tolist()
    return numpy.asarray(v).reshape(-1).tolist()


def _log1mexp(x):
    x = _fl(x)
    return torch.where(x > -_math.log(2.0), torch.log(-torch.expm1(x)),
                       torch.log1p(-torch.exp(x)))


MATH_EXT.update({
    "multigammaln": _multigammaln,
    "realdiv": lambda x, y: _binop(torch.true_divide)(x, y),
    "truncate_mod": _fmod,
    "squared_subtract": MATH_EXT["squared_difference"],
    "floordiv": MATH_EXT["floor_div"],
    "cot": lambda x: 1.0 / torch.tan(_fl(x)),
    "sec": lambda x: 1.0 / torch.cos(_fl(x)),
    "csc": lambda x: 1.0 / torch.sin(_fl(x)),
    "log1mexp": _log1mexp,
})


def _orth(a, rcond=None):
    a = _t(a)
    u, s, _ = torch.linalg.svd(a, full_matrices=False)
    tol = (rcond if rcond is not None
           else torch.finfo(a.dtype).eps * max(a.shape)) * torch.max(s)
    return torch.where((s > tol)[None, :], u, 0.0)


def _null_space(a, rcond=None):
    a = _t(a)
    _, s, vh = torch.linalg.svd(a, full_matrices=True)
    tol = (rcond if rcond is not None
           else torch.finfo(a.dtype).eps * max(a.shape)) * torch.max(s)
    rank_mask = torch.cat([s, torch.zeros(vh.shape[0] - s.shape[0],
                                          dtype=s.dtype,
                                          device=s.device)]) > tol
    return torch.where(~rank_mask[None, :], vh.T, 0.0)


def _tensorinv(x, ind=2):
    x = _t(x)
    ind = int(ind)
    out_shape = tuple(x.shape[ind:]) + tuple(x.shape[:ind])
    n = _math.prod(x.shape[:ind])
    return torch.linalg.inv(x.reshape(n, -1)).reshape(out_shape)


def _tensorsolve(a, b):
    a, b = _promote(_t(a), _t(b))
    out_shape = tuple(a.shape[b.ndim:])
    n = _math.prod(out_shape)
    return torch.linalg.solve(a.reshape(-1, n), b.reshape(-1)).reshape(
        out_shape)


LINALG.update({
    "log_matrix_determinant": _slogdet,
    "tensorinv": _tensorinv,
    "tensorsolve": _tensorsolve,
    "orth": _orth,
    "null_space": _null_space,
})


def _r_triangular(gen, shape, left, mode, right):
    u = _uniform(gen, shape)
    fc = (mode - left) / (right - left)
    return torch.where(
        u < fc,
        left + torch.sqrt(u * (right - left) * (mode - left)),
        right - torch.sqrt((1 - u) * (right - left) * (right - mode)))


def _r_f(gen, shape, dfnum, dfden):
    num = 2.0 * _std_gamma(gen, torch.full(_shape(shape), dfnum / 2.0),
                           shape) / dfnum
    den = 2.0 * _std_gamma(gen, torch.full(_shape(shape), dfden / 2.0),
                           shape) / dfden
    return num / den


def _r_negbin(gen, shape, n, p):
    lam = _std_gamma(gen, torch.full(_shape(shape), float(n)), shape) \
        * (1 - p) / p
    return _i32(torch.poisson(lam, generator=gen))


RANDOM.update({
    "weibull": lambda gen, shape, a=1.0, scale=1.0: scale * torch.pow(
        -torch.log1p(-_uniform(gen, shape)), 1.0 / a),
    "triangular": lambda gen, shape, left=0.0, mode=0.5, right=1.0:
        _r_triangular(gen, shape, left, mode, right),
    "f": lambda gen, shape, dfnum, dfden: _r_f(gen, shape, dfnum, dfden),
    "negative_binomial": lambda gen, shape, n, p: _r_negbin(gen, shape, n,
                                                            p),
    "standard_t": RANDOM["student_t"],
})

CNN.update({
    "conv2d_transpose": CNN["deconv2d"],
    "conv1d_transpose": CNN["deconv1d"],
    "conv3d_transpose": CNN["deconv3d"],
    "atrous_conv2d": lambda x, w, rate, padding="SAME": CNN["conv2d"](
        x, w, stride=(1, 1), padding=padding,
        dilation=(int(rate), int(rate))),
})


def _bidirectional(layer_fn, concat_axis=-1):
    def f(x, h0_fwd, h0_bwd, *args):
        n = len(args) // 2
        x = _t(x)
        fwd = layer_fn(x, h0_fwd, *args[:n])
        bwd = layer_fn(torch.flip(x, (1,)), h0_bwd, *args[n:])
        return torch.cat([fwd, torch.flip(bwd, (1,))], dim=concat_axis)
    return f


RNN.update({
    "bidirectional_lstm_layer": _bidirectional(RNN["lstm_layer"]),
    "bidirectional_gru_layer": _bidirectional(RNN["gru_layer"]),
    "dynamic_rnn": RNN["simple_rnn_layer"],
})

NAMESPACES.update({
    "updater": UPDATER, "signal": SIGNAL, "assert": ASSERT,
})

# ------------------------------------------------------ *_bp op family --
# Each backprop op derived from its forward op with torch.autograd.grad:
# (*primals, dL/dOut, **static kwargs) -> the input cotangent(s).


def _leaf(p):
    if isinstance(p, torch.Tensor) or isinstance(p, numpy.ndarray):
        t = _fl(p).detach().clone()
        return t.requires_grad_(True)
    return p


def _vjp(fn, primals, g, kwargs, n):
    with torch.enable_grad():
        leaves = [_leaf(p) for p in primals]
        out = fn(*leaves, **kwargs)
        want = [p for p in leaves[:n]]
        grads = torch.autograd.grad(
            out, want, grad_outputs=_t(g).to(out.dtype).to(out.device),
            allow_unused=True)
    return [torch.zeros_like(w) if gr is None else gr
            for w, gr in zip(want, grads)]


def _bp_of(fn, n_grads=1):
    """``fn``'s backprop op: (*primals, grad, **kw) → the cotangent of the
    first primal, or a tuple of the first ``n_grads``."""
    def bp_op(*args, **kwargs):
        *primals, g = args
        grads = _vjp(fn, primals, g, kwargs, n_grads)
        return grads[0] if n_grads == 1 else tuple(grads[:n_grads])
    return bp_op


def _reduce_bp(fn):
    """Reduction backprop: (x, grad, axis=..., keepdims=...)."""
    def bp_op(x, g, **kwargs):
        return _vjp(fn, [x], g, kwargs, 1)[0]
    return bp_op


def _leaky_relu(x, negative_slope=0.01):
    return F.leaky_relu(_t(x), negative_slope)


def _hard_sigmoid(x):
    return F.relu6(_t(x) + 3.0) / 6.0


def _gelu_tanh(x):
    return F.gelu(_t(x), approximate="tanh")


def _softmax(x, axis=-1):
    return torch.softmax(_t(x), dim=axis)


def _log_softmax(x, axis=-1):
    return torch.log_softmax(_t(x), dim=axis)


def _elu(x, alpha=1.0):
    return F.elu(_t(x), alpha)


_ACT_FWD = {
    "relu": lambda x: F.relu(_t(x)), "relu6": lambda x: F.relu6(_t(x)),
    "elu": _elu, "selu": lambda x: F.selu(_t(x)), "gelu": _gelu_tanh,
    "sigmoid": lambda x: torch.sigmoid(_t(x)),
    "tanh": lambda x: torch.tanh(_t(x)),
    "softplus": lambda x: F.softplus(_t(x)),
    "softsign": lambda x: F.softsign(_t(x)),
    "swish": lambda x: F.silu(_t(x)),
    "hard_swish": _hard_swish, "hard_sigmoid": _hard_sigmoid,
    "leaky_relu": _leaky_relu, "mish": lambda x: F.mish(_t(x)),
    "softmax": _softmax, "log_softmax": _log_softmax,
    "cube": lambda x: _t(x) ** 3,
    "rational_tanh": MATH_EXT["rational_tanh"],
    "rectified_tanh": MATH_EXT["rectified_tanh"],
}

BP = {}
for _n, _f in _ACT_FWD.items():
    BP[f"{_n}_bp"] = _bp_of(_f)

for _n in ("conv1d", "conv2d", "conv3d", "deconv1d", "deconv2d", "deconv3d",
           "depthwise_conv2d", "separable_conv2d"):
    BP[f"{_n}_bp"] = _bp_of(CNN[_n], n_grads=2)

for _n in ("max_pooling1d", "max_pooling2d", "max_pooling3d",
           "avg_pooling1d", "avg_pooling2d", "avg_pooling3d",
           "lp_pool2d", "local_response_normalization", "im2col",
           "upsampling2d", "pixel_shuffle"):
    BP[f"{_n}_bp"] = _bp_of(CNN[_n])

BP["batch_norm_bp"] = _bp_of(CNN["batch_norm"], n_grads=5)
BP["layer_norm_bp"] = _bp_of(NN_EXT["layer_norm_no_bias"], n_grads=1)
BP["bias_add_bp"] = _bp_of(NN_EXT["bias_add"], n_grads=2)
BP["l2_normalize_bp"] = _bp_of(NN_EXT["l2_normalize"])
BP["lstm_layer_bp"] = _bp_of(RNN["lstm_layer"], n_grads=2)
BP["gru_layer_bp"] = _bp_of(RNN["gru_layer"], n_grads=2)


def _kw_reduce(fn):
    """A reduction taking numpy-style ``axis``/``keepdims`` keywords."""
    def f(x, axis=None, keepdims=False):
        return fn(x, axis, keepdims=keepdims)
    return f


def _norm_kw(x, axis=None, keepdims=False):
    return _norm(x, axis=axis, keepdims=keepdims)


for _n, _fn in (("sum", _kw_reduce(_sum)), ("mean", _kw_reduce(_mean)),
                ("max", _kw_reduce(_amax)), ("min", _kw_reduce(_amin)),
                ("prod", _kw_reduce(_prod)),
                ("variance", _kw_reduce(_var)), ("std", _kw_reduce(_std)),
                ("norm2", _norm_kw),
                ("logsumexp", _kw_reduce(_logsumexp))):
    BP[f"reduce_{_n}_bp"] = _reduce_bp(_fn)

BP["squared_norm_bp"] = _reduce_bp(lambda x, **kw: _sum(
    _t(x) * _t(x), kw.get("axis"), kw.get("keepdims", False)))
BP["matmul_bp"] = _bp_of(_matmul, n_grads=2)
BP["mmul_bp"] = BP["matmul_bp"]

NAMESPACES["bp"] = BP

# --------------------------------------------------- r4 widening tail --


def _sample_distorted_bounding_box(gen, image_size, min_object_covered=0.1,
                                   area_range=(0.05, 1.0),
                                   aspect_ratio_range=(0.75, 1.33)):
    h, w = int(image_size[0]), int(image_size[1])
    area = _rand_scalar(gen, area_range[0], area_range[1]) * (h * w)
    ar = torch.exp(_rand_scalar(gen, _math.log(aspect_ratio_range[0]),
                                _math.log(aspect_ratio_range[1])))
    ch = torch.clamp(torch.sqrt(area / ar), 1, h).to(torch.int32)
    cw = torch.clamp(torch.sqrt(area * ar), 1, w).to(torch.int32)
    y0 = _i32(torch.floor(_uniform(gen, ()) * torch.clamp_min(
        h - ch, 1).float()))
    x0 = _i32(torch.floor(_uniform(gen, ()) * torch.clamp_min(
        w - cw, 1).float()))
    return torch.stack([y0, x0]), torch.stack([ch, cw])


def _nms_with_scores(boxes, scores, max_output_size, iou_threshold=0.5,
                     score_threshold=float("-inf")):
    idx, valid = _nms(boxes, scores, max_output_size, iou_threshold,
                      score_threshold)
    scores = _t(scores)
    return idx, scores[idx.clamp_min(0).long()] * (idx >= 0)


IMAGE.update({
    "sample_distorted_bounding_box": _sample_distorted_bounding_box,
    "non_max_suppression_with_scores": _nms_with_scores,
})


def _log_mel(x, frame_length=256, frame_step=128, num_mel_bins=40,
             sample_rate=16000, **kw):
    spec = torch.square(torch.abs(_stft(x, frame_length, frame_step, **kw)))
    mel = _mel_matrix(num_mel_bins, (int(kw.get("fft_length")
                                         or frame_length)) // 2 + 1,
                      sample_rate).to(spec.device)
    return torch.log(spec @ mel + 1e-6)


SIGNAL.update({
    "spectrogram": lambda x, frame_length=256, frame_step=128, **kw:
        torch.square(torch.abs(_stft(x, frame_length, frame_step, **kw))),
    "log_mel_spectrogram": _log_mel,
})

BASE.update({
    "reduce_sum": BASE["sum"], "reduce_mean": BASE["mean"],
    "reduce_max": BASE["max"], "reduce_min": BASE["min"],
    "reduce_prod": BASE["prod"], "reduce_any": BASE["any"],
    "reduce_all": BASE["all"], "reduce_logsumexp": BASE["logsumexp"],
})

RANDOM.update({
    "stateless_uniform": RANDOM["uniform"],
    "stateless_normal": RANDOM["normal"],
    "stateless_truncated_normal": RANDOM["truncated_normal"],
    "stateless_bernoulli": RANDOM["bernoulli"],
})

LINALG.update({
    "cholesky_solve": LINALG["cho_solve"],
    "matrix_triangular_solve": LINALG["triangular_solve"],
})

RNN.update({
    "static_rnn": RNN["simple_rnn_layer"],
    "bidirectional_dynamic_rnn": RNN["bidirectional_lstm_layer"],
})

NN_EXT.update({
    "scaled_dot_product_attention": NN_EXT["dot_product_attention"],
})


# ------------------------------------------------- r5 straggler closers --
# The TensorArray family as a fixed-capacity stack + an element count.

def _list_create(capacity, element_shape, dtype=torch.float32):
    return (torch.zeros((int(capacity),) + tuple(element_shape),
                        dtype=dtype_of(dtype)),
            torch.zeros((), dtype=torch.int32))


def _list_write(tarr, index, value):
    """A write past the capacity is dropped (count pinned at capacity)."""
    stack, count = tarr
    cap = stack.shape[0]
    idx = _t(index, torch.int32).to(stack.device)
    ok = idx < cap
    new = _put_row(stack, torch.clamp_max(idx, cap - 1), value)
    stack = torch.where(ok, new, stack)
    return stack, torch.clamp_max(torch.maximum(count, idx + 1), cap)


def _put_row(stack, pos, value):
    """``stack`` with row ``pos`` (a 0-d index on the device, never read
    on the host) set to ``value``."""
    row = _t(value).to(stack.device, stack.dtype).reshape(
        (1,) + tuple(stack.shape[1:]))
    return stack.index_copy(0, pos.reshape(1).long(), row)


def _list_read(tarr, index):
    stack, _ = tarr
    i = _t(index, torch.int32).to(stack.device).long()
    return stack.index_select(0, torch.clamp(
        i, 0, stack.shape[0] - 1).reshape(1))[0]


def _list_push(tarr, value):
    stack, count = tarr
    cap = stack.shape[0]
    ok = count < cap
    new = _put_row(stack, torch.clamp_max(count, cap - 1), value)
    return torch.where(ok, new, stack), torch.clamp_max(count + 1, cap)


def _list_stack(tarr):
    stack, count = tarr
    mask = torch.arange(stack.shape[0], device=stack.device) < count
    return torch.where(mask.reshape((-1,) + (1,) * (stack.ndim - 1)), stack,
                       torch.zeros((), dtype=stack.dtype,
                                   device=stack.device))


def _list_unstack(tarr, values):
    stack, _ = tarr
    v = _t(values).to(stack.dtype)
    n = min(v.shape[0], stack.shape[0])
    stack = stack.clone()
    stack[:n] = v[:n]
    return stack, _scalar(n, torch.int32, stack.device)


def _list_gather(tarr, indices):
    stack, _ = tarr
    return _take(stack, indices, axis=0)


def _list_scatter(tarr, indices, values):
    stack, count = tarr
    idx = _idx(indices).to(stack.device)
    stack = stack.clone()
    if idx.numel():
        stack[idx] = _t(values).to(stack.dtype)
    hi = (idx.max() + 1).to(torch.int32) if idx.numel() else \
        torch.zeros((), dtype=torch.int32, device=stack.device)
    return stack, torch.clamp_max(torch.maximum(count, hi), stack.shape[0])


def _list_split(tarr, values, sizes):
    sizes = [int(s) for s in sizes]
    stack, _ = tarr
    width = stack.shape[1] if stack.ndim > 1 else max(sizes)
    v = _t(values).to(stack.dtype)
    stack = stack.clone()
    off = 0
    for i, s in enumerate(sizes):
        chunk = v[off:off + s]
        pad = [0, 0] * (chunk.ndim - 1) + [0, width - s]
        stack[i] = F.pad(chunk, pad)
        off += s
    return stack, _scalar(len(sizes), torch.int32, stack.device)


LIST = {
    "create_list": _list_create,
    "write_list": _list_write,
    "read_list": _list_read,
    "push_list": _list_push,
    "stack_list": _list_stack,
    "unstack_list": _list_unstack,
    "gather_list": _list_gather,
    "scatter_list": _list_scatter,
    "split_list": _list_split,
    "size_list": lambda tarr: tarr[1],
}
NAMESPACES["list"] = LIST


def _embedding_lookup(params, ids, max_norm=None):
    out = _take(params, ids, axis=0)
    if max_norm is not None:
        norms = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
        out = out * torch.clamp_max(max_norm / torch.clamp_min(norms, 1e-12),
                                    1.0)
    return out


def _compare_and_bitpack(x, threshold):
    x = _t(x)
    bits = (x > threshold).to(torch.int32)
    b8 = bits.reshape(tuple(x.shape[:-1]) + (x.shape[-1] // 8, 8))
    weights = _t(numpy.asarray([128, 64, 32, 16, 8, 4, 2, 1],
                               numpy.int32)).to(x.device)
    return torch.sum(b8 * weights, dim=-1).to(torch.uint8)


def _batched_gemm(a, b, transpose_a=False, transpose_b=False,
                  alpha=1.0, beta=0.0, c=None):
    a, b = _t(a), _t(b)
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    out = alpha * torch.matmul(a, b)
    if c is not None and beta != 0.0:
        out = out + beta * _t(c)
    return out


def _choose(x, mode, scalar):
    x = _t(x)
    cmp = [lambda a: a < scalar, lambda a: a <= scalar,
           lambda a: a == scalar, lambda a: a != scalar,
           lambda a: a > scalar, lambda a: a >= scalar][int(mode)]
    m = cmp(x)
    return torch.where(m, x, torch.zeros((), dtype=x.dtype,
                                         device=x.device)), \
        _sum(m.to(torch.int32))


NN_EXT.update({
    "embedding_lookup": _embedding_lookup,
    "xw_plus_b": lambda x, w, b: _t(x) @ _t(w) + _t(b),
})
BASE.update({
    "compare_and_bitpack": _compare_and_bitpack,
    "choose": _choose,
})
LINALG.update({
    "batched_gemm": _batched_gemm,
})

# Ops whose torch form reads a value back to the host (a data-dependent
# shape or count, a check that raises, a rejection loop) or draws from a
# generator: a graph holding one runs eagerly, never as a CUDA graph.
# (``base.where`` needs the host in its one-argument form only; the
# graph builder checks that form.)
HOST_OPS = frozenset(
    [("assert", n) for n in ASSERT]
    + [("random", n) for n in RANDOM]
    + [("base", n) for n in (
        "check_numerics", "sequence_mask", "unique", "unique_with_counts",
        "boolean_mask", "list_diff", "setdiff1d", "intersect1d",
        "union1d", "nonzero", "histogram", "digitize", "bucketize",
        "broadcast_dynamic_shape", "dynamic_stitch")]
    + [("nn", n) for n in ("dropout_train", "gumbel_softmax",
                           "alpha_dropout_train", "spatial_dropout_train")]
    + [("image", n) for n in (
        "random_crop", "random_flip_left_right", "random_flip_up_down",
        "random_brightness", "random_contrast", "random_hue",
        "random_saturation", "sample_distorted_bounding_box")]
    + [("loss", "ctc_loss"), ("bp", "reduce_prod_bp")]
    # torch's factorizations read their status back to the host; the
    # arithmetic ones run on the card
    + [("linalg", n) for n in LINALG if n not in (
        "matrix_transpose", "matrix_diag", "matrix_diag_part", "mmul",
        "tri", "matrix_band_part", "batched_gemm", "khatri_rao", "adjoint",
        "block_diag", "toeplitz", "vander", "multi_dot")])
