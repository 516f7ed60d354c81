"""SameDiff — port of ``deeplearning4j_tpu/autodiff/samediff.py``.

Reference parity: ``org.nd4j.autodiff.samediff.SameDiff`` (SDVariable,
placeholders/variables/constants, op namespaces sd.math/sd.nn/...,
reverse-mode ``grad``, TrainingConfig + fit, exec/output sessions).

The graph is the reference's lightweight symbolic DAG; running it walks
the DAG once, op by op, in plain torch, in an order planned without
recursion (deep imported graphs exceed Python's recursion limit) and
dropping each value after its last use. Gradients come from
``torch.autograd.grad`` of that walk. Where the reference jits the walk
per (outputs, feed names, feed shapes) and jits ``fit``'s whole step,
the port runs each through ``nn/_compiled.py``'s :class:`CompiledStep`:
on the card one CUDA graph per signature, replayed, the same kernels as
the eager walk. A graph whose nodes need the host while they run (a
``while_loop`` or ``cond`` predicate, an ``assert`` op, a random draw, an
op with a data-dependent shape; see ``sd_ops.HOST_OPS``) is known to be
one before its first call, from its nodes' kinds, and runs eagerly.

Variables are tensors on the graph's device (``SameDiff.create(device=
None)`` is the card; ``device="cpu"`` the host) that require grad; ``fit``
updates them in place, so that a captured step keeps reading them.

``export`` gives a ``torch.export`` program of the graph, the
counterpart of ``to_stablehlo``/``to_jaxpr``, which raise here.
"""

from __future__ import annotations

import io
import pickle
import weakref
import zipfile
import zlib
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .._device import HostRead, resolve_device
from . import sd_ops
from .sd_ops import _t


class SDVariable:
    """Symbolic node. Operator overloads build graph nodes (like SDVariable
    arithmetic in the reference)."""

    def __init__(self, sd: "SameDiff", name: str, kind: str, shape=None,
                 dtype=None, op: Optional[Callable] = None,
                 inputs: Sequence["SDVariable"] = (), meta=None,
                 host=False):
        self.sd = sd
        self.name = name
        self.kind = kind            # placeholder | variable | constant | op
        self.shape = shape
        self.dtype = dtype
        self.op = op
        self.inputs = list(inputs)
        self.meta = meta            # replay record for serialization
        self.host = host            # the op needs the host while it runs

    # --- arithmetic sugar --------------------------------------------------
    def _bin(self, other, fn, opname):
        other = self.sd._wrap(other)
        return self.sd._op(opname, fn, [self, other],
                           meta=("operator", opname))

    def __add__(self, o):
        return self._bin(o, torch.add, "add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._bin(o, torch.sub, "sub")

    def __rsub__(self, o):
        return self.sd._wrap(o)._bin(self, torch.sub, "rsub")

    def __mul__(self, o):
        return self._bin(o, torch.mul, "mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._bin(o, torch.true_divide, "div")

    def __rtruediv__(self, o):
        return self.sd._wrap(o)._bin(self, torch.true_divide, "rdiv")

    def __pow__(self, o):
        return self._bin(o, _power, "pow")

    def __neg__(self):
        return self.sd._op("neg", torch.neg, [self],
                           meta=("operator", "neg"))

    def __matmul__(self, o):
        return self._bin(o, sd_ops._matmul, "mmul")

    # --- common methods (SDVariable surface) -------------------------------
    def add(self, o):
        return self.__add__(o)

    def sub(self, o):
        return self.__sub__(o)

    def mul(self, o):
        return self.__mul__(o)

    def div(self, o):
        return self.__truediv__(o)

    def mmul(self, o):
        return self.__matmul__(o)

    def _method(self, name, fn, axes, kw):
        return self.sd._op(name, fn, [self],
                           meta=("method", name, axes, kw))

    def sum(self, *axes, keepdims=False):
        return self._method("sum", lambda x: sd_ops._sum(x, axes, keepdims),
                            axes, {"keepdims": keepdims})

    def mean(self, *axes, keepdims=False):
        return self._method("mean",
                            lambda x: sd_ops._mean(x, axes, keepdims),
                            axes, {"keepdims": keepdims})

    def std(self, *axes):
        return self._method("std", lambda x: sd_ops._std(x, axes), axes, {})

    def max(self, *axes):
        return self._method("max", lambda x: sd_ops._amax(x, axes), axes, {})

    def min(self, *axes):
        return self._method("min", lambda x: sd_ops._amin(x, axes), axes, {})

    def argmax(self, axis=-1):
        return self._method("argmax", lambda x: sd_ops._argmax(x, axis),
                            (axis,), {})

    def reshape(self, *shape):
        return self._method("reshape", lambda x: x.reshape(shape), shape, {})

    def transpose(self, *axes):
        return self._method("transpose",
                            lambda x: sd_ops._transpose(x, *axes), axes, {})

    def norm2(self, *axes):
        return self._method("norm2", lambda x: torch.sqrt(
            sd_ops._fl(sd_ops._sum(torch.square(x), axes))), axes, {})

    def rename(self, new_name):
        self.sd._rename(self, new_name)
        return self

    def eval(self, feeds: Optional[dict] = None):
        return self.sd.eval(self, feeds)

    def __repr__(self):
        return f"SDVariable({self.name!r}, {self.kind}, shape={self.shape})"


def _power(a, b):
    a, b = sd_ops._bin(a, b)
    if not (a.is_floating_point() or a.is_complex()) and \
            (b.is_floating_point() or b.is_complex()):
        a = a.to(b.dtype)
    return torch.pow(a, b)


class _Namespace:
    """Op namespace (sd.math / sd.nn / sd.loss ...)."""

    def __init__(self, sd, table: Dict[str, Callable], ns_name: str = ""):
        self._sd = sd
        self._table = table
        self._name = ns_name

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        fn = self._table.get(name)
        if fn is None:
            raise AttributeError(f"unknown op '{name}'; known: {sorted(self._table)}")
        host = (self._name, name) in sd_ops.HOST_OPS

        def make(*args, **kw):
            # where(cond) alone lists the true positions: a shape the
            # host reads
            needs_host = host or ((self._name, name) == ("base", "where")
                                  and len(args) == 1)
            vars_ = [a for a in args if isinstance(a, SDVariable)]
            vi = iter(range(len(vars_)))
            pattern = [("$var", next(vi)) if isinstance(a, SDVariable) else a
                       for a in args]
            # numpy array arguments become tensors on the graph's device
            # once, on the first run (never inside a capture)
            arrays = {}

            def apply_fn(*vals):
                it = iter(vals)
                full = []
                for k, a in enumerate(args):
                    if isinstance(a, SDVariable):
                        full.append(next(it))
                    elif isinstance(a, (np.ndarray, np.generic)):
                        if k not in arrays:
                            arrays[k] = _t(a)
                        full.append(arrays[k])
                    else:
                        full.append(a)
                return fn(*full, **kw)

            return self._sd._op(name, apply_fn, vars_,
                                meta=("ns", self._name, name, pattern, kw),
                                host=needs_host)
        return make


# ----------------------------------------------------- the core op tables

def _gelu(x, approximate=True):
    return F.gelu(_t(x), approximate="tanh" if approximate else "none")


def _leaky_relu(x, negative_slope=0.01):
    return F.leaky_relu(_t(x), negative_slope)


def _softmax(x, axis=-1):
    return torch.softmax(sd_ops._fl(x), dim=axis)


def _log_softmax(x, axis=-1):
    return torch.log_softmax(sd_ops._fl(x), dim=axis)


def _layer_norm(x, gain, bias=None, eps=1e-5):
    x = _t(x)
    out = (x - torch.mean(x, -1, keepdim=True)) / torch.sqrt(
        torch.var(x, -1, correction=0, keepdim=True) + eps) * _t(gain)
    return out + (0 if bias is None else _t(bias))


def _linear(x, w, b=None):
    out = _t(x) @ _t(w)
    return out + _t(b) if b is not None else out


_MATH = {
    "abs": sd_ops._unop(torch.abs), "exp": sd_ops._unop(torch.exp, True),
    "log": sd_ops._unop(torch.log, True),
    "log1p": sd_ops._unop(torch.log1p, True),
    "sqrt": sd_ops._unop(torch.sqrt, True),
    "square": sd_ops._unop(torch.square),
    "sin": sd_ops._unop(torch.sin, True), "cos": sd_ops._unop(torch.cos, True),
    "tan": sd_ops._unop(torch.tan, True),
    "tanh": sd_ops._unop(torch.tanh, True),
    "sinh": sd_ops._unop(torch.sinh, True),
    "cosh": sd_ops._unop(torch.cosh, True),
    "asin": sd_ops._unop(torch.asin, True),
    "acos": sd_ops._unop(torch.acos, True),
    "atan": sd_ops._unop(torch.atan, True),
    "erf": sd_ops._unop(torch.special.erf, True),
    "floor": sd_ops._unop(torch.floor, True),
    "ceil": sd_ops._unop(torch.ceil, True),
    "round": sd_ops._unop(torch.round), "sign": sd_ops._unop(torch.sign),
    "reciprocal": sd_ops._unop(torch.reciprocal, True),
    "pow": _power, "maximum": sd_ops._binop(torch.maximum),
    "minimum": sd_ops._binop(torch.minimum),
    "clip_by_value": sd_ops._clip, "cumsum": sd_ops._cumsum,
    "cumprod": sd_ops._cumprod,
    "matmul": sd_ops._matmul, "tensordot": sd_ops._tensordot,
    "einsum": sd_ops._einsum,
    "add": sd_ops._binop(torch.add), "sub": sd_ops._binop(torch.sub),
    "mul": sd_ops._binop(torch.mul),
    "div": sd_ops._binop(torch.true_divide),
    "neg": sd_ops._unop(torch.neg), "isnan": sd_ops._unop(torch.isnan),
    "isinf": sd_ops._unop(torch.isinf),
    "log_sum_exp": lambda x, axis=None: sd_ops._logsumexp(x, axis),
}

_NN = {
    "relu": lambda x: F.relu(_t(x)), "relu6": lambda x: F.relu6(_t(x)),
    "sigmoid": lambda x: torch.sigmoid(sd_ops._fl(x)),
    "tanh": lambda x: torch.tanh(sd_ops._fl(x)),
    "softmax": _softmax, "log_softmax": _log_softmax,
    "elu": sd_ops._elu, "selu": lambda x: F.selu(_t(x)), "gelu": _gelu,
    "leaky_relu": _leaky_relu, "softplus": lambda x: F.softplus(_t(x)),
    "swish": lambda x: F.silu(_t(x)), "silu": lambda x: F.silu(_t(x)),
    "mish": lambda x: F.mish(_t(x)),
    "hard_sigmoid": sd_ops._hard_sigmoid,
    "linear": _linear,
    "layer_norm": _layer_norm,
    "dropout": lambda x, rate=0.5: _t(x),  # inference no-op
    "batch_norm": lambda x, mean, var, gamma, beta, eps=1e-5: (
        (_t(x) - _t(mean)) / torch.sqrt(_t(var) + eps) * _t(gamma)
        + _t(beta)),
    "conv2d": lambda x, w, stride=(1, 1), padding="SAME":
        sd_ops._conv_general(x, w, tuple(stride), padding),
    "max_pool2d": lambda x, k=(2, 2), s=None, padding="VALID":
        sd_ops._reduce_window(x, tuple(k), tuple(s or k), padding, "max"),
    "avg_pool2d": lambda x, k=(2, 2), s=None, padding="VALID":
        sd_ops._reduce_window(sd_ops._fl(x), tuple(k), tuple(s or k),
                              padding, "sum") / (k[0] * k[1]),
    "embedding_lookup": lambda table, ids: sd_ops._take(table, ids, axis=0),
    "multi_head_dot_product_attention": None,  # assigned below
}


def _mhdpa(q, k, v, n_heads=1, causal=False):
    q, k, v = _t(q), _t(k), _t(v)
    b, t, d = q.shape
    hd = d // n_heads
    qh = q.reshape(b, t, n_heads, hd)
    kh = k.reshape(b, t, n_heads, hd)
    vh = v.reshape(b, t, n_heads, hd)
    return sd_ops._dpa(qh, kh, vh, is_causal=causal).reshape(b, t, d)


_NN["multi_head_dot_product_attention"] = _mhdpa


def _sparse_xent(labels, logits):
    lp = torch.log_softmax(sd_ops._fl(logits), -1)
    return -torch.mean(sd_ops._take_along_axis(
        lp, sd_ops._idx(labels)[..., None], -1))


_LOSS = {
    "softmax_cross_entropy": lambda labels, logits: -torch.mean(
        torch.sum(_t(labels) * torch.log_softmax(sd_ops._fl(logits), -1),
                  -1)),
    "sparse_softmax_cross_entropy": _sparse_xent,
    "sigmoid_cross_entropy": lambda labels, logits: torch.mean(
        F.relu(_t(logits)) - _t(logits) * _t(labels)
        + torch.log1p(torch.exp(-torch.abs(_t(logits))))),
    "mean_squared_error": lambda labels, preds: torch.mean(
        torch.square(_t(preds) - _t(labels))),
    "absolute_difference": lambda labels, preds: torch.mean(
        torch.abs(_t(preds) - _t(labels))),
    "cosine_distance": lambda a, b: 1.0 - torch.mean(torch.sum(
        _t(a) * _t(b), -1) / torch.clamp_min(
            torch.linalg.vector_norm(_t(a), dim=-1)
            * torch.linalg.vector_norm(_t(b), dim=-1), 1e-9)),
    "log_loss": lambda labels, preds, eps=1e-7: -torch.mean(
        _t(labels) * torch.log(_t(preds) + eps)
        + (1 - _t(labels)) * torch.log(1 - _t(preds) + eps)),
    "huber_loss": lambda labels, preds, delta=1.0: torch.mean(torch.where(
        torch.abs(_t(preds) - _t(labels)) <= delta,
        0.5 * torch.square(_t(preds) - _t(labels)),
        delta * (torch.abs(_t(preds) - _t(labels)) - 0.5 * delta))),
}


class History:
    """Training record returned by ``SameDiff.fit`` (reference:
    ``org.nd4j.autodiff.listeners.records.History``): per-iteration loss
    curve, per-epoch means, optional per-epoch validation scores."""

    def __init__(self):
        self.loss_curve: List[float] = []
        self.epoch_losses: List[float] = []
        self.validation: List[float] = []

    def final_loss(self):
        return self.loss_curve[-1] if self.loss_curve else None

    def __repr__(self):
        return (f"History(iterations={len(self.loss_curve)}, "
                f"epochs={len(self.epoch_losses)}, "
                f"final_loss={self.final_loss()})")


class TrainingConfig:
    """Reference parity: org.nd4j.autodiff.samediff.TrainingConfig."""

    def __init__(self, updater=None, data_set_feature_mapping=None,
                 data_set_label_mapping=None, l1=0.0, l2=0.0,
                 loss_variables=None):
        from ..train.updaters import Adam
        self.updater = updater or Adam(1e-3)
        self.feature_mapping = data_set_feature_mapping or []
        self.label_mapping = data_set_label_mapping or []
        self.l1 = l1
        self.l2 = l2
        self.loss_variables = loss_variables or []


# host copies of constants: a static argument (a shape, an axis, an
# index list) that a graph keeps as a constant is read from here, never
# back from the card
_HOST = {}


def set_host_value(t: torch.Tensor, value) -> torch.Tensor:
    """Remember ``value`` (numpy) as the host copy of tensor ``t``."""
    key = id(t)
    if key not in _HOST:
        weakref.finalize(t, _HOST.pop, key, None)
    _HOST[key] = np.asarray(value)
    return t


def host_value(v):
    """``v`` as a numpy array: a tensor's host copy where it has one, a
    CPU tensor's own values, else a copy back from the card (a graph
    that needs that is run eagerly)."""
    if isinstance(v, torch.Tensor):
        got = _HOST.get(id(v))
        if got is not None:
            return got
        t = v.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(v)


def _flatten(out):
    """An op output's tensors in order, and its structure (non-tensor
    leaves kept as they are)."""
    leaves = []

    def walk(o):
        if isinstance(o, torch.Tensor):
            leaves.append(o)
            return ("t",)
        if isinstance(o, (tuple, list)):
            return (type(o), [walk(v) for v in o])
        return ("c", o)
    return leaves, walk(out)


def _unflatten(spec, leaves):
    it = iter(leaves)

    def build(s):
        if s[0] == "t":
            return next(it)
        if s[0] == "c":
            return s[1]
        return s[0](build(v) for v in s[1])
    return build(spec)


class _Runner:
    """One (outputs, feed names, feed shapes) signature of a graph: a
    :class:`CompiledStep` over the walk (replayed CUDA graphs on the card,
    a direct call on the host) or, for a graph that needs the host while
    it runs, the eager walk."""

    def __init__(self, sd, fn, eager, name):
        from ..nn._compiled import Bound, CompiledStep
        self.spec = None
        # the device, for a call without feeds (passed through, not copied)
        self._anchor = Bound(torch.zeros((), device=sd.device))

        def step(_anchor, *feeds):
            with torch.no_grad():
                leaves, spec = _flatten(fn(sd._values_snapshot(), *feeds))
            self.spec = spec
            return tuple(leaves)

        self.step = step
        self.compiled = None if eager else CompiledStep(
            step, lambda: list(sd._values.values()), name)

    def __call__(self, *feeds):
        out = self.step(None, *feeds) if self.compiled is None else \
            self.compiled(self._anchor, *feeds)
        return _unflatten(self.spec, out)


class SameDiff:
    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._vars: Dict[str, SDVariable] = {}
        self._values: Dict[str, torch.Tensor] = {}   # variables + constants
        self._counter = 0
        self.math = _Namespace(self, {**_MATH, **sd_ops.MATH_EXT}, "math")
        self.nn = _Namespace(self, {**_NN, **sd_ops.NN_EXT}, "nn")
        self.loss = _Namespace(self, {**_LOSS, **sd_ops.LOSS_EXT}, "loss")
        # SDBaseOps methods live on SameDiff itself as well (__getattr__)
        self.base = _Namespace(self, sd_ops.BASE, "base")
        self.linalg = _Namespace(self, sd_ops.LINALG, "linalg")
        self.bitwise = _Namespace(self, sd_ops.BITWISE, "bitwise")
        self.random = _Namespace(self, sd_ops.RANDOM, "random")
        self.cnn = _Namespace(self, sd_ops.CNN, "cnn")
        self.rnn = _Namespace(self, sd_ops.RNN, "rnn")
        self.image = _Namespace(self, sd_ops.IMAGE, "image")
        self.fft = _Namespace(self, sd_ops.FFT, "fft")
        self.signal = _Namespace(self, sd_ops.SIGNAL, "signal")
        # `updater` is the training-config field; `assert` is a keyword
        self.updaters = _Namespace(self, sd_ops.UPDATER, "updater")
        self.assertions = _Namespace(self, sd_ops.ASSERT, "assert")
        self.bp = _Namespace(self, sd_ops.BP, "bp")
        self.list = _Namespace(self, sd_ops.LIST, "list")
        self._training_config: Optional[TrainingConfig] = None
        self._loss_vars: List[str] = []
        self._opt_state = None
        self._optimizer = None
        self._restored_updater = None
        self._compiled = {}
        # True -> fit()'s loss runs under activation checkpointing (the
        # backward recomputes the forward): the reference's
        # jax.checkpoint of the whole graph
        self.remat = False

    @staticmethod
    def create(device=None) -> "SameDiff":
        return SameDiff(device)

    def __getattr__(self, name):
        if not name.startswith("_"):
            base = self.__dict__.get("base")
            if base is not None and name in base._table:
                return getattr(base, name)
        raise AttributeError(
            f"'SameDiff' object has no attribute {name!r}")

    # ------------------------------------------------------------ node mgmt
    def _fresh(self, base):
        self._counter += 1
        return f"{base}_{self._counter}"

    def _register(self, v: SDVariable):
        if v.name in self._vars:
            raise ValueError(f"duplicate variable name {v.name}")
        self._vars[v.name] = v
        self._compiled = {}
        return v

    def _rename(self, v: SDVariable, new):
        del self._vars[v.name]
        if v.name in self._values:
            self._values[new] = self._values.pop(v.name)
        v.name = new
        self._vars[new] = v
        self._compiled = {}

    def _wrap(self, value) -> SDVariable:
        if isinstance(value, SDVariable):
            return value
        return self.constant(self._fresh("const"), value)

    def _op(self, opname, fn, inputs, meta=None, host=False) -> SDVariable:
        return self._register(SDVariable(self, self._fresh(opname), "op",
                                         op=fn, inputs=inputs, meta=meta,
                                         host=host))

    def _tensor(self, value, dtype=None):
        """``value`` as a tensor on the graph's device, in the
        reference's 32-bit dtypes, with its host copy remembered."""
        if isinstance(value, torch.Tensor):
            t = value.detach()
            host = t.cpu().numpy() if t.device.type == "cpu" and \
                t.dtype != torch.bfloat16 else None
        else:
            t = _t(value)
            host = t.numpy() if t.dtype != torch.bfloat16 else None
        if dtype is not None:
            t = t.to(sd_ops.dtype_of(dtype))
            host = None if host is None or t.dtype == torch.bfloat16 \
                else t.cpu().numpy()
        t = t.to(self.device)
        if host is not None:
            set_host_value(t, host)
        return t

    # ------------------------------------------------------- public surface
    def placeholder(self, name, shape=None, dtype=torch.float32) -> SDVariable:
        return self._register(SDVariable(self, name, "placeholder", shape,
                                         sd_ops.dtype_of(dtype)))

    def var(self, name, shape=None, initializer="xavier", value=None,
            dtype=torch.float32, seed=0) -> SDVariable:
        """Trainable variable (reference: sd.var). The initializer draws
        from a ``torch.Generator`` seeded by ``seed`` and the crc32 of the
        name (stable across runs, as the reference's key is)."""
        dtype = sd_ops.dtype_of(dtype)
        if value is None:
            from ..nn import weights as _w
            fan_in, fan_out = _w.compute_fans(tuple(shape))
            gen = torch.Generator().manual_seed(
                (int(seed) << 32) ^ zlib.crc32(name.encode()))
            value = _w.get(initializer)(gen, tuple(shape), fan_in, fan_out,
                                        dtype)
        t = self._tensor(value, dtype).clone()
        t.requires_grad_(t.is_floating_point())
        self._values[name] = t
        return self._register(SDVariable(self, name, "variable",
                                         tuple(t.shape), dtype))

    def constant(self, name, value) -> SDVariable:
        t = self._tensor(value)
        self._values[name] = t
        return self._register(SDVariable(self, name, "constant",
                                         tuple(t.shape), t.dtype))

    def variables(self):
        return {n: v for n, v in self._vars.items() if v.kind == "variable"}

    @property
    def params(self):
        """Trainable values, grouped like a network's param table."""
        return {"variables": self._values_snapshot()}

    def get_variable(self, name):
        return self._vars[name]

    # --------------------------------------------------------------- tracing
    def _trace(self, out: SDVariable, var_values: dict, feeds: dict):
        """The value of ``out`` (the reference's walk; see :meth:`_run`)."""
        return self._run(_plan([out]), var_values, feeds)[out]

    def _run(self, plan, var_values: dict, feeds: dict):
        """Evaluate a :func:`_plan` in order, dropping each value after
        its last use (as XLA frees a buffer once its users have run), so
        that a forward holds only what is still needed. Returns the
        planned outputs' values by node."""
        order, frees = plan
        vals = {}
        for v, free in zip(order, frees):
            if v.kind == "placeholder":
                if v.name not in feeds:
                    raise KeyError(f"missing placeholder feed '{v.name}'")
                vals[v] = feeds[v.name]
            elif v.kind == "variable":
                vals[v] = var_values[v.name]
            elif v.kind == "constant":
                vals[v] = self._values[v.name]
            else:
                vals[v] = v.op(*[vals[i] for i in v.inputs])
            for d in free:
                del vals[d]
        return vals

    def _outputs(self, outputs):
        outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        return [o if isinstance(o, SDVariable) else self._vars[o]
                for o in outs]

    def make_function(self, outputs, placeholders: Sequence[str]):
        """Lower the graph to a plain fn(var_values, *feeds) → outputs; it
        creates tensors on the graph's device."""
        outs = self._outputs(outputs)
        single = not isinstance(outputs, (list, tuple))
        plan = _plan(outs)

        def fn(var_values, *feed_vals):
            feeds = dict(zip(placeholders, feed_vals))
            with torch.device(self.device):
                vals = self._run(plan, var_values, feeds)
            return vals[outs[0]] if single else [vals[o] for o in outs]

        return fn

    def needs_host(self, outputs) -> bool:
        """True when a node that ``outputs`` depend on needs the host
        while it runs (such a graph is never captured)."""
        return any(v.host for v in _topo(self._outputs(outputs)))

    # ------------------------------------------------------------- execution
    def _feed(self, value):
        return _t(value).to(self.device)

    def _runner(self, outputs, names, feeds, tag="eval"):
        key = (tag, tuple(o.name for o in self._outputs(outputs)),
               isinstance(outputs, (list, tuple)), tuple(names),
               tuple(tuple(feeds[n].shape) for n in names))
        r = self._compiled.get(key)
        if r is None:
            r = self._compiled[key] = _Runner(
                self, self.make_function(outputs, names),
                self.needs_host(outputs), f"SameDiff.{tag}")
        return r

    def eval(self, output, feeds: Optional[dict] = None):
        feeds = {n: self._feed(v) for n, v in (feeds or {}).items()}
        names = sorted(feeds)
        return self._runner(output, names, feeds)(*[feeds[n] for n in names])

    output = eval
    exec = eval

    def runner(self, output, feeds: Optional[dict] = None):
        """The :class:`_Runner` ``eval`` uses for these outputs and feeds
        (its ``compiled.calls`` say how each call ran)."""
        feeds = {n: self._feed(v) for n, v in (feeds or {}).items()}
        return self._runner(output, sorted(feeds), feeds)

    def _values_snapshot(self):
        return {n: self._values[n] for n, v in self._vars.items()
                if v.kind == "variable"}

    def batch_output(self, outputs, feeds):
        return self.eval(list(outputs), feeds)

    # ------------------------------------------------------------- gradients
    def grad(self, loss, wrt=None, feeds: Optional[dict] = None):
        """Gradients of `loss` w.r.t. variables (reference: sd.grad /
        calculateGradients); zeros for a variable the loss does not use."""
        feeds = {n: self._feed(v) for n, v in (feeds or {}).items()}
        names = sorted(feeds)
        fn = self.make_function(loss, names)
        vv = self._values_snapshot()
        keys = [k for k, v in vv.items() if v.requires_grad]
        with torch.enable_grad():
            out = fn(vv, *[feeds[n] for n in names])
            gs = torch.autograd.grad(out, [vv[k] for k in keys],
                                     allow_unused=True)
        grads = {k: torch.zeros_like(vv[k]) if g is None else g
                 for k, g in zip(keys, gs)}
        if wrt is None:
            return grads
        if isinstance(wrt, (str, SDVariable)):
            wrt = [wrt]
        names = [w.name if isinstance(w, SDVariable) else w for w in wrt]
        return {k: grads[k] for k in names}

    # ------------------------------------------------------------- training
    def set_training_config(self, config: TrainingConfig):
        self._training_config = config
        self._optimizer = None
        return self

    def set_loss_variables(self, *names):
        self._loss_vars = [n.name if isinstance(n, SDVariable) else n
                           for n in names]
        return self

    def _build_optimizer(self):
        from ..train.updaters import build_optimizer
        cfg = self._training_config
        self._optimizer = build_optimizer(cfg.updater, l1=cfg.l1, l2=cfg.l2)
        with torch.no_grad():
            self._opt_state = self._optimizer.init(self._trainable())
        if self._restored_updater is not None:
            _restore_updater(self._opt_state, self._restored_updater)
            self._restored_updater = None

    def _trainable(self):
        return {k: v for k, v in self._values_snapshot().items()
                if v.requires_grad}

    def fit_step(self):
        """The compiled train step ``fit`` runs: a :class:`CompiledStep`
        over one batch (feature then label arrays, in the training
        config's order) → the loss; its ``calls`` say how each ran."""
        from ..nn._compiled import CompiledStep, tensors
        from ..nn._remat import checkpoint_segment
        from ..train.updaters import apply_updates, tree_leaves
        cfg = self._training_config
        if cfg is None:
            raise ValueError("call set_training_config first")
        if not self._loss_vars:
            raise ValueError("call set_loss_variables first")
        if self._optimizer is None:
            self._build_optimizer()
        ph_names = cfg.feature_mapping + cfg.label_mapping
        loss_var = self._vars[self._loss_vars[0]]
        key = ("__fit_step__", tuple(ph_names), loss_var.name,
               bool(self.remat), id(self._optimizer))
        if key in self._compiled:
            return self._compiled[key]
        fn = self.make_function(loss_var, ph_names)
        params = self._trainable()
        names = sorted(params)
        leaves = [params[n] for n in names]
        frozen = {k: v for k, v in self._values_snapshot().items()
                  if not v.requires_grad}
        optimizer = self._optimizer
        remat = bool(self.remat)
        n_vars = len(leaves)

        def loss_of(*vals):
            return fn({**frozen, **dict(zip(names, vals[:n_vars]))},
                      *vals[n_vars:])

        def step(*feed_vals):
            with torch.enable_grad():
                args = (*leaves, *feed_vals)
                loss = (checkpoint_segment(loss_of, *args) if remat
                        else loss_of(*args))
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            gtree = {n: torch.zeros_like(p) if g is None else g
                     for n, p, g in zip(names, leaves, grads)}
            with torch.no_grad():
                updates, _ = optimizer.update(gtree, self._opt_state, params)
                apply_updates(tree_leaves(params), tree_leaves(updates))
            return loss.detach()

        def bindings():
            return list(self._values.values()) + tensors(self._opt_state)

        self._compiled[key] = CompiledStep(step, bindings, "SameDiff.fit")
        return self._compiled[key]

    def _arrays(self, x):
        return [self._feed(a) for a in (x if isinstance(x, list) else [x])]

    def fit(self, dataset=None, epochs: int = 1, iterator=None, feeds_fn=None,
            listeners=None, validation_iterator=None, validation_fn=None):
        """Train on a DataSet/iterator using TrainingConfig mappings.

        Returns a `History`. `listeners` take the nn TrainingListener
        protocol (iteration_done/on_epoch_end); `validation_fn(sd) ->
        float` (or a validation_iterator scored with the training loss)
        records a per-epoch validation metric in the history. When every
        listener takes deferred scores, step k's loss is read while step
        k+1 runs (``HostRead``)."""
        step = self.fit_step()
        if self.needs_host(self._vars[self._loss_vars[0]]):
            step = step.step            # the eager walk, never captured
        cfg = self._training_config
        ph_names = cfg.feature_mapping + cfg.label_mapping
        data = iterator if iterator is not None else (
            [dataset] if dataset is not None else None)
        if data is None:
            raise ValueError("provide dataset or iterator")
        listeners = list(listeners or [])
        history = History()
        defer_ok = all(getattr(l, "deferred_score_ok", False)
                       for l in listeners)
        pending = None

        def flush_pending():
            nonlocal pending
            if pending is not None:
                read, it_i, ep_i = pending
                pending = None
                lv = float(read.get())
                for l in listeners:
                    l.iteration_done(self, it_i, ep_i, lv)

        val_run = None
        if validation_iterator is not None and validation_fn is None:
            loss_var = self._vars[self._loss_vars[0]]
            val_fn = self.make_function(loss_var, ph_names)
            val_eager = self.needs_host(loss_var)
        for epoch in range(epochs):
            epoch_losses = []
            for ds in data:
                feed_vals = self._arrays(ds.features) + self._arrays(ds.labels)
                loss = step(*feed_vals)
                epoch_losses.append(loss)      # device value; read lazily
                self._iter_count = getattr(self, "_iter_count", 0) + 1
                if listeners:
                    if defer_ok:
                        staged = (HostRead(loss), self._iter_count, epoch)
                        flush_pending()
                        pending = staged
                    else:
                        lv = float(loss)
                        for l in listeners:
                            l.iteration_done(self, self._iter_count, epoch,
                                             lv)
            if hasattr(data, "reset"):
                data.reset()
            flush_pending()
            history.loss_curve.extend(float(l) for l in epoch_losses)
            if epoch_losses:
                history.epoch_losses.append(
                    sum(history.loss_curve[-len(epoch_losses):])
                    / len(epoch_losses))
            if validation_fn is not None:
                history.validation.append(float(validation_fn(self)))
            elif validation_iterator is not None:
                vs = []
                for ds in validation_iterator:
                    feeds = self._arrays(ds.features) + \
                        self._arrays(ds.labels)
                    if val_run is None:
                        val_run = _Runner(self, val_fn, val_eager,
                                          "SameDiff.validation")
                    vs.append(float(val_run(*feeds)))
                if hasattr(validation_iterator, "reset"):
                    validation_iterator.reset()
                if vs:
                    history.validation.append(sum(vs) / len(vs))
            for l in listeners:
                if hasattr(l, "on_epoch_end"):
                    l.on_epoch_end(self)
        return history

    def evaluate(self, iterator, output, label_index: int = 0,
                 evaluation=None):
        """Accumulate an Evaluation over an iterator (reference:
        SameDiff.evaluate(DataSetIterator, outputVariable, Evaluation))."""
        cfg = self._training_config
        if cfg is None:
            raise ValueError("call set_training_config first "
                             "(feature_mapping names the input placeholders)")
        if evaluation is None:
            from ..eval.classification import Evaluation as _Eval
            evaluation = _Eval()
        out = output if isinstance(output, SDVariable) else self._vars[output]
        run = None
        for ds in iterator:
            feats = self._arrays(ds.features)
            labs = (ds.labels if not isinstance(ds.labels, list)
                    else ds.labels[label_index])
            if run is None:
                run = _Runner(self, self.make_function(
                    out, cfg.feature_mapping), self.needs_host(out),
                    "SameDiff.evaluate")
            evaluation.eval(labs, run(*feats))
        if hasattr(iterator, "reset"):
            iterator.reset()
        return evaluation

    # ----------------------------------------------------------- control flow
    def lambda_op(self, name, fn, *inputs) -> SDVariable:
        """Any fn over the inputs' tensors (the escape hatch; it may read
        the host, so a graph holding one runs eagerly)."""
        return self._op(name, fn, [self._wrap(i) for i in inputs], host=True)

    def while_loop(self, cond_fn, body_fn, init) -> SDVariable:
        """``while cond_fn(v): v = body_fn(v)`` over the value of `init`
        (reference: SameDiff.whileLoop); the predicate is read on the
        host each trip."""
        def run(v):
            while bool(cond_fn(v)):
                v = body_fn(v)
            return v
        return self._op("while", run, [self._wrap(init)], host=True)

    def cond(self, pred, true_fn, false_fn, operand) -> SDVariable:
        return self._op("cond",
                        lambda p, o: true_fn(o) if bool(p) else false_fn(o),
                        [self._wrap(pred), self._wrap(operand)], host=True)

    def scan(self, f, init, xs) -> SDVariable:
        """``f(carry, x) -> (carry, y)`` over the leading dim of `xs`;
        returns the (carry, ys) tuple value."""
        def run(c, xs_):
            ys = []
            for i in range(xs_.shape[0]):
                c, y = f(c, xs_[i])
                ys.append(y)
            return c, _stack_tree(ys)
        return self._op("scan", run, [self._wrap(init), self._wrap(xs)],
                        host=True)

    def stop_gradient(self, v) -> SDVariable:
        return self._op("stop_gradient", lambda t: t.detach(),
                        [self._wrap(v)])

    # ------------------------------------------------------------- lowering
    def export(self, output, placeholder_shapes: dict, dtypes=None):
        """The graph as a ``torch.export`` program of the placeholders (in
        sorted name order), its variables and constants as buffers."""
        names = sorted(placeholder_shapes)
        fn = self.make_function(output, names)
        keys = list(self._values)
        sd = self

        class _Graph(torch.nn.Module):
            def __init__(self):
                super().__init__()
                for i, k in enumerate(keys):
                    self.register_buffer(f"v{i}",
                                         sd._values[k].detach().clone())

            def forward(self, *feeds):
                vals = {k: getattr(self, f"v{i}")
                        for i, k in enumerate(keys)}
                saved = dict(sd._values)
                sd._values.update(vals)
                try:
                    return fn(vals, *feeds)
                finally:
                    sd._values.update(saved)

        dtypes = dtypes or {}
        args = tuple(torch.zeros(tuple(placeholder_shapes[n]),
                                 dtype=sd_ops.dtype_of(dtypes.get(
                                     n, torch.float32)), device=self.device)
                     for n in names)
        with torch.no_grad():
            return torch.export.export(_Graph(), args)

    def to_jaxpr(self, output, placeholder_shapes: dict):
        raise NotImplementedError(
            "the torch port has no jaxpr; use SameDiff.export for a "
            "torch.export program of the graph")

    def to_stablehlo(self, output, placeholder_shapes: dict) -> str:
        raise NotImplementedError(
            "the torch port lowers no StableHLO; use SameDiff.export for a "
            "torch.export program of the graph")

    # ---------------------------------------------------------- serialization
    def save(self, path, save_training_config: bool = True,
             save_updater: bool = False):
        """Serialize graph + values in the reference's zip layout
        (``graph.pkl`` replay records, ``values.npz``, ``training.pkl``,
        ``updater.pkl``). Ops built from raw closures (``lambda_op``,
        control flow, importer internals) have no replay record and
        raise."""
        unserializable = [v.name for v in self._vars.values()
                          if v.kind == "op" and v.meta is None]
        if unserializable:
            raise ValueError(
                "graph has op nodes without replay records (built via "
                f"lambda_op/control-flow/closures): {unserializable[:8]} — "
                "use export() for a compiler-level artifact instead")
        records = []
        for v in _topo(list(self._vars.values())):
            rec = {"name": v.name, "kind": v.kind}
            if v.kind == "placeholder":
                rec["shape"] = v.shape
                rec["dtype"] = _np_name(v.dtype)
            elif v.kind == "variable":
                rec["dtype"] = _np_name(v.dtype)
            elif v.kind == "op":
                rec["meta"] = v.meta
                rec["inputs"] = [i.name for i in v.inputs]
            records.append(rec)
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr("graph.pkl", pickle.dumps(
                {"records": records, "loss_vars": self._loss_vars}))
            buf = io.BytesIO()
            np.savez(buf, **{n: _to_numpy(val)
                             for n, val in self._values.items()})
            zf.writestr("values.npz", buf.getvalue())
            if save_training_config and self._training_config is not None:
                zf.writestr("training.pkl",
                            pickle.dumps(self._training_config))
            if save_updater and self._opt_state is not None:
                from ..nn._compiled import tensors
                zf.writestr("updater.pkl", pickle.dumps(
                    {"format": "deeplearning4j_tpu_torch",
                     "leaves": [_to_numpy(t)
                                for t in tensors(self._opt_state)]}))
        return path

    _OPERATOR_REPLAY = {
        "add": lambda a, b: a + b, "sub": lambda a, b: a - b,
        "rsub": lambda a, b: a - b, "mul": lambda a, b: a * b,
        "div": lambda a, b: a / b, "rdiv": lambda a, b: a / b,
        "pow": lambda a, b: a ** b, "mmul": lambda a, b: a @ b,
        "neg": lambda a: -a,
    }

    @classmethod
    def load(cls, path, device=None) -> "SameDiff":
        """Rebuild a saved graph by replaying its op records. Reads the
        port's zips and the JAX package's (its pickles through a
        restricted unpickler that maps its classes onto the port's and
        its optax updater state onto the port's updater state)."""
        from ..serde import jax_pickles as jp
        with zipfile.ZipFile(path) as zf:
            graph = jp.load_samediff_pickle(zf.read("graph.pkl"))
            values = dict(np.load(io.BytesIO(zf.read("values.npz")),
                                  allow_pickle=False))
            training = (jp.load_samediff_pickle(zf.read("training.pkl"))
                        if "training.pkl" in zf.namelist() else None)
            updater = (jp.load_samediff_pickle(zf.read("updater.pkl"))
                       if "updater.pkl" in zf.namelist() else None)
        sd = cls.create(device)
        for rec in graph["records"]:
            tail = rec["name"].rsplit("_", 1)
            if len(tail) == 2 and tail[1].isdigit():
                sd._counter = max(sd._counter, int(tail[1]))
        for rec in graph["records"]:
            name, kind = rec["name"], rec["kind"]
            if kind == "placeholder":
                dt = rec.get("dtype")
                sd.placeholder(name, rec.get("shape"),
                               np.dtype(dt) if dt else torch.float32)
            elif kind == "variable":
                dt = rec.get("dtype")
                sd.var(name, value=values[name],
                       dtype=np.dtype(dt) if dt else torch.float32)
            elif kind == "constant":
                sd.constant(name, values[name])
            else:
                ins = [sd._vars[i] for i in rec["inputs"]]
                meta = rec["meta"]
                if meta[0] == "operator":
                    v = cls._OPERATOR_REPLAY[meta[1]](*ins)
                elif meta[0] == "method":
                    _, mname, consts, kw = meta
                    v = getattr(ins[0], mname)(*consts, **kw)
                else:   # ("ns", ns_name, op_name, pattern, kw)
                    _, ns_name, op_name, pattern, kw = meta
                    args = [ins[a[1]] if (isinstance(a, tuple) and len(a) == 2
                                          and a[0] == "$var") else a
                            for a in pattern]
                    ns = {"updater": "updaters", "assert": "assertions"}.get(
                        ns_name, ns_name)
                    v = getattr(getattr(sd, ns), op_name)(*args, **kw)
                sd._rename(v, name)
        sd._loss_vars = list(graph.get("loss_vars") or [])
        if training is not None:
            sd._training_config = training
        if updater is not None:
            sd._restored_updater = updater
        return sd

    def summary(self) -> str:
        lines = [f"{'name':<24}{'kind':<12}{'shape'}"]
        for n, v in self._vars.items():
            lines.append(f"{n:<24}{v.kind:<12}{v.shape}")
        return "\n".join(lines)


def _topo(roots):
    """The nodes ``roots`` depend on, each after its inputs (an iterative
    walk: a deep imported graph exceeds Python's recursion limit)."""
    order, seen = [], set()
    for root in roots:
        stack = [(root, False)]
        while stack:
            v, expanded = stack.pop()
            if id(v) in seen:
                continue
            if expanded:
                seen.add(id(v))
                order.append(v)
            else:
                stack.append((v, True))
                stack.extend((i, False) for i in v.inputs
                             if id(i) not in seen)
    return order


def _plan(outs):
    """(order, frees): the nodes ``outs`` need in evaluation order, and
    beside each the nodes whose last use it is (outputs are kept)."""
    order = _topo(outs)
    last = {}
    for k, v in enumerate(order):
        for i in v.inputs:
            last[i] = k
    frees = [[] for _ in order]
    for node, k in last.items():
        if not any(node is o for o in outs):
            frees[k].append(node)
    return order, frees


def _stack_tree(ys):
    if not ys:
        return ys
    if isinstance(ys[0], (tuple, list)):
        return type(ys[0])(_stack_tree([y[i] for y in ys])
                           for i in range(len(ys[0])))
    return torch.stack([_t(y) for y in ys])


def _np_name(dtype):
    if dtype is None:
        return None
    if dtype == torch.bfloat16:
        return "bfloat16"
    return str(dtype).replace("torch.", "")


def _to_numpy(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _restore_updater(opt_state, saved):
    """Copy a saved updater state into a freshly built one: the port's
    own (its leaves in order) or the JAX package's optax state."""
    from ..nn._compiled import tensors
    from ..serde import jax_pickles as jp
    if isinstance(saved, dict) and saved.get("format") == \
            "deeplearning4j_tpu_torch":
        leaves = tensors(opt_state)
        if len(leaves) != len(saved["leaves"]):
            raise ValueError(f"updater state: {len(saved['leaves'])} saved "
                             f"arrays, {len(leaves)} in the updater")
        with torch.no_grad():
            for t, a in zip(leaves, saved["leaves"]):
                t.copy_(torch.as_tensor(a).to(t.dtype))
        return
    jp.restore_optax_state_(opt_state, saved)
