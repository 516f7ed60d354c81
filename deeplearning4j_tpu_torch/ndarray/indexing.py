"""NDArrayIndex — port of ``deeplearning4j_tpu/ndarray/indexing.py``
(``org.nd4j.linalg.indexing.NDArrayIndex``: interval, point, all,
newAxis, ``INDArray.get/put``, and BooleanIndexing).

The helpers build ordinary index tuples for torch tensors. ``put`` is
functional, as the reference's ``.at[].set`` is: it returns a new tensor
and leaves its input as it was. ``first_index`` / ``last_index`` stay on
the device (-1 where nothing matches).
"""

from __future__ import annotations

import torch

from .factory import _t


class _All:
    def resolve(self):
        return slice(None)


class _NewAxis:
    def resolve(self):
        return None


class Interval:
    def __init__(self, start, end, step=1):
        self.start, self.end, self.step = start, end, step

    def resolve(self):
        return slice(self.start, self.end, self.step)


class Point:
    def __init__(self, i):
        self.i = i

    def resolve(self):
        return self.i


class Indices:
    """Fancy index by an integer array along one axis."""

    def __init__(self, idx):
        self.idx = idx

    def resolve(self):
        return _t(self.idx).long()


def all():
    return _All()


def new_axis():
    return _NewAxis()


def interval(start, end, step=1):
    return Interval(start, end, step)


def point(i):
    return Point(i)


def indices(idx):
    return Indices(idx)


def _resolve(ixs):
    return tuple(ix.resolve() if hasattr(ix, "resolve") else ix for ix in ixs)


def _on(ix, device):
    return ix.to(device) if isinstance(ix, torch.Tensor) else ix


def get(a, *ixs):
    """INDArray.get(NDArrayIndex...)"""
    a = _t(a)
    return a[tuple(_on(ix, a.device) for ix in _resolve(ixs))]


def put(a, *ixs_and_value):
    """INDArray.put(NDArrayIndex..., value): a new tensor."""
    *ixs, value = ixs_and_value
    out = _t(a).clone()
    out[tuple(_on(ix, out.device) for ix in _resolve(ixs))] = \
        value if isinstance(value, (int, float, bool)) else \
        _t(value).to(device=out.device, dtype=out.dtype)
    return out


def put_scalar(a, idx, value):
    out = _t(a).clone()
    out[tuple(idx) if isinstance(idx, (list, tuple)) else idx] = value
    return out


def get_scalar(a, *idx):
    return _t(a)[tuple(idx)]


# --- BooleanIndexing -------------------------------------------------------

def replace_where(a, replacement, cond_mask):
    """BooleanIndexing.replaceWhere: a new tensor."""
    a = _t(a)
    rep = replacement if isinstance(replacement, (int, float)) else \
        _t(replacement).to(a.device)
    return torch.where(_t(cond_mask).to(a.device), rep, a)


def apply_where(a, cond_mask, fn):
    a = _t(a)
    return torch.where(_t(cond_mask).to(a.device), fn(a), a)


def first_index(cond_mask, axis=None):
    """Index of the first True (BooleanIndexing.firstIndex); -1 if none."""
    m = _t(cond_mask).bool()
    flat = m if axis is not None else m.reshape(-1)
    dim = 0 if axis is None else axis
    idx = torch.argmax(flat.to(torch.uint8), dim=dim)
    return torch.where(torch.any(flat, dim=dim), idx, -1)


def last_index(cond_mask, axis=None):
    m = _t(cond_mask).bool()
    flat = m if axis is not None else m.reshape(-1)
    dim = 0 if axis is None else axis
    n = flat.shape[dim]
    idx = n - 1 - torch.argmax(torch.flip(flat, [dim]).to(torch.uint8),
                               dim=dim)
    return torch.where(torch.any(flat, dim=dim), idx, -1)


# --- slicing at tensor-valued starts ---------------------------------------

def _starts(a, starts):
    """Start indices clamped as ``lax.dynamic_slice`` clamps them."""
    return [int(s) for s in (starts.tolist() if isinstance(
        starts, torch.Tensor) else starts)]


def dynamic_slice(a, starts, sizes):
    """``lax.dynamic_slice``: starts clamped so the slice fits."""
    a = _t(a)
    out = a
    for ax, (s, n) in enumerate(zip(_starts(a, starts), sizes)):
        s = min(max(s, 0), a.shape[ax] - n)
        out = out.narrow(ax, s, n)
    return out


def dynamic_update_slice(a, update, starts):
    """``lax.dynamic_update_slice``: a new tensor with ``update`` written
    at ``starts`` (clamped so it fits)."""
    out = _t(a).clone()
    update = _t(update).to(device=out.device, dtype=out.dtype)
    view = out
    for ax, s in enumerate(_starts(out, starts)):
        s = min(max(s, 0), out.shape[ax] - update.shape[ax])
        view = view.narrow(ax, s, update.shape[ax])
    view.copy_(update)
    return out


def tensor_along_dimension(a, index, dim):
    """INDArray.tensorAlongDimension: the slice at ``index`` along ``dim``."""
    return torch.select(_t(a), dim, index)


def slice_along_first(a, i):
    """INDArray.slice(i)."""
    return _t(a)[i]
