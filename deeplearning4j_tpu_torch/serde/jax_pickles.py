"""Reading the JAX package's pickles without JAX: its updater state
(``updater.pkl``), its normalizer (``normalizer.pkl``) and the pickles of
a SameDiff zip (:func:`load_samediff_pickle`).

The reference pickles ``jax.tree_util.tree_map(np.asarray, opt_state)``
(``deeplearning4j_tpu/serde/model_serializer.py:102-104``): optax's state
namedtuples holding numpy arrays. A restricted :class:`pickle.Unpickler`
reads it: each optax state class becomes a plain stand-in with the same
fields, numpy's array reconstruction and a few builtins are allowed (a bf16
array's ``ml_dtypes`` type is read as its uint16 bits), and every other
global is refused, so nothing of optax, JAX or the JAX package
is imported. :func:`restore_updater_` then copies the state into the
port's updater state (``train/updaters.py``), which keeps optax's tree
shape: a chain is a tuple and each transform's state a dict named by
optax's fields (``count``, ``mu``, ``nu``, ``nu_max``, ``trace``,
``sum_of_squares``, ``e_g``, ``e_x``), and ``multi_transform`` a dict by
label. Stateless entries (``EmptyState``, masked leaves) carry nothing
and are matched past, so chains that differ only in stateless transforms
(optax's ``rmsprop`` and ``adadelta`` add one) line up.

A JAX-written normalizer is read the same way, its classes mapped onto
``data/normalizers.py``'s, which keep the reference's attributes.
"""

from __future__ import annotations

import collections
import importlib
import io
import pickle

import numpy as np
import torch

# optax state classes (by class name, whatever the optax module) and
# their fields
OPTAX_FIELDS = {
    "EmptyState": (), "MaskedNode": (),
    "ScaleByAdamState": ("count", "mu", "nu"),
    "ScaleByAmsgradState": ("count", "mu", "nu", "nu_max"),
    "ScaleByLionState": ("count", "mu"),
    "ScaleByRmsState": ("nu",),
    "ScaleByRssState": ("sum_of_squares",),
    "ScaleByAdaDeltaState": ("e_g", "e_x"),
    "ScaleByScheduleState": ("count",),
    "TraceState": ("trace",),
    "PartitionState": ("inner_states",),
    "MaskedState": ("inner_state",),
}
_STANDINS = {name: collections.namedtuple(name, fields)
             for name, fields in OPTAX_FIELDS.items()}
_NUMPY = {("numpy", "dtype"), ("numpy", "ndarray"),
          ("numpy.core.multiarray", "_reconstruct"),
          ("numpy._core.multiarray", "_reconstruct"),
          ("numpy.core.multiarray", "scalar"),
          ("numpy._core.multiarray", "scalar")}
_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "int", "float",
             "complex", "bool", "str", "bytes", "bytearray", "slice",
             "range"}
_JAX_NORMALIZERS = "deeplearning4j_tpu.data.normalizers"
# a bf16 array (ml_dtypes' scalar type) is read as its raw uint16 bits,
# the reference's own npz convention, and reinterpreted on the copy
_BF16_BITS = ("ml_dtypes", "bfloat16")


class _Restricted(pickle.Unpickler):
    """Numpy arrays, plain builtins and ``extra`` (module, name) → object;
    every other global raises."""

    def __init__(self, raw, extra):
        super().__init__(io.BytesIO(raw))
        self._extra = extra

    def find_class(self, module, name):
        if (module, name) in _NUMPY:
            return super().find_class(module, name)
        if module == "builtins" and name in _BUILTINS:
            return super().find_class(module, name)
        if (module, name) == _BF16_BITS:
            return np.uint16
        found = self._extra(module, name)
        if found is not None:
            return found
        raise pickle.UnpicklingError(
            f"refusing to load {module}.{name} from a JAX package pickle")


def _optax_class(module, name):
    if (module == "optax" or module.startswith("optax.")) \
            and name in _STANDINS:
        return _STANDINS[name]
    return None


def load_optax_state(raw: bytes):
    """An ``updater.pkl`` as stand-in namedtuples of numpy arrays."""
    return _Restricted(raw, _optax_class).load()


def load_jax_normalizer(raw: bytes):
    """A ``normalizer.pkl`` of the JAX package as the port's normalizer."""
    from ..data import normalizers as port

    def extra(module, name):
        if module == _JAX_NORMALIZERS and isinstance(
                getattr(port, name, None), type):
            return getattr(port, name)
        return None
    return _Restricted(raw, extra).load()


def _is_state(x):
    return type(x) in _STANDINS.values()


def _empty(x) -> bool:
    """A stateless entry: an optax state without fields, or a (possibly
    nested) tuple of stateless entries (the port's ``()`` among them)."""
    if _is_state(x):
        return not x._fields
    if isinstance(x, tuple):
        return all(_empty(v) for v in x)
    return False


def _copy_leaf(t, a, path):
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"updater {path}: the JAX state has an array, the "
                         f"port's state {type(t).__name__}")
    a = np.asarray(a)
    if a.dtype == np.uint16 and t.dtype == torch.bfloat16:
        src = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        src = torch.as_tensor(a)
    if tuple(src.shape) != tuple(t.shape):
        raise ValueError(f"updater {path}: JAX shape {tuple(src.shape)}, "
                         f"port {tuple(t.shape)}")
    t.copy_(src.to(t.dtype))


def _walk_tree(port, jx, path):
    """A params-shaped tree: dicts by key, arrays onto tensors; a masked
    leaf (another label's) must be absent or empty on the port's side."""
    if _is_state(jx) and not jx._fields:        # MaskedNode
        if isinstance(port, torch.Tensor):
            raise ValueError(f"updater {path}: masked in the JAX state")
        return
    if isinstance(jx, dict):
        if not isinstance(port, dict):
            raise ValueError(f"updater {path}: structure differs")
        for k in port:
            if k not in jx:
                raise KeyError(f"the JAX updater state has no {path}|{k}")
            _walk_tree(port[k], jx[k], f"{path}|{k}")
        return
    _copy_leaf(port, jx, path)


def _walk(port, jx, path):
    if _is_state(jx) and type(jx).__name__ == "PartitionState":
        for lab in port:
            _walk(port[lab], jx.inner_states[lab], f"{path}|{lab}")
        return
    if _is_state(jx) and type(jx).__name__ == "MaskedState":
        _walk(port, jx.inner_state, path)
        return
    if _empty(port) and _empty(jx):
        return
    if isinstance(port, tuple):
        if not isinstance(jx, tuple) or _is_state(jx):
            raise ValueError(f"updater {path}: the port has a chain, the "
                             f"JAX state {type(jx).__name__}")
        ps = [p for p in port if not _empty(p)]
        js = [j for j in jx if not _empty(j)]
        if len(ps) != len(js):
            raise ValueError(
                f"updater {path}: {len(ps)} stateful transforms in the "
                f"port's chain, {len(js)} in the JAX one")
        for i, (p, j) in enumerate(zip(ps, js)):
            _walk(p, j, f"{path}#{i}")
        return
    if isinstance(port, dict) and _is_state(jx):
        for k in port:
            if k not in jx._fields:
                raise KeyError(f"updater {path}: {type(jx).__name__} has no "
                               f"field {k}")
            _walk_tree(port[k], getattr(jx, k), f"{path}.{k}")
        return
    raise ValueError(f"updater {path}: cannot map {type(jx).__name__} onto "
                     f"{type(port).__name__}")


def restore_optax_state_(opt_state, jax_state):
    """Copy a JAX updater state (:func:`load_optax_state`) into the port's
    ``opt_state`` tensors, in place."""
    with torch.no_grad():
        _walk(opt_state, jax_state, "")


class JaxUpdaterState:
    """A JAX package's updater state waiting for the net's updater to be
    built (``fit`` builds it): ``_build_optimizer`` restores it."""

    def __init__(self, state):
        self.state = state


# --------------------------------------------------------------- SameDiff
# A SameDiff zip (``autodiff/samediff.py``'s ``save``, the JAX package's or
# the port's) pickles its replay records, its TrainingConfig (an updater
# dataclass, maybe a schedule inside) and its updater state. Both
# packages' classes map onto the port's; JAX's dtype scalar types onto
# numpy's; optax states onto the stand-ins above.
_JAX_PREFIX = "deeplearning4j_tpu."
_PORT_PREFIX = "deeplearning4j_tpu_torch."
_SD_MODULES = {"autodiff.samediff": ("TrainingConfig", "History"),
               "train.updaters": None, "train.schedules": None}


def _port_class(module, name):
    """The port's class for a (module, name) of either package."""
    for prefix in (_JAX_PREFIX, _PORT_PREFIX):
        if not module.startswith(prefix):
            continue
        sub = module[len(prefix):]
        if sub not in _SD_MODULES:
            return None
        allowed = _SD_MODULES[sub]
        if allowed is not None and name not in allowed:
            return None
        mod = importlib.import_module(_PORT_PREFIX + sub)
        obj = getattr(mod, name, None)
        return obj if isinstance(obj, type) else None
    return None


def _samediff_class(module, name):
    found = _port_class(module, name) or _optax_class(module, name)
    if found is not None:
        return found
    if (module.startswith("jax") or module == "numpy") and \
            name in _DTYPE_NAMES:
        return getattr(np, name)
    if module == "torch" and isinstance(getattr(torch, name, None),
                                        torch.dtype):
        return getattr(torch, name)
    return None


_DTYPE_NAMES = {"bool_", "int8", "int16", "int32", "int64", "uint8",
                "uint16", "uint32", "uint64", "float16", "float32",
                "float64", "complex64", "complex128"}


def load_samediff_pickle(raw: bytes):
    """A SameDiff zip's ``graph.pkl``, ``training.pkl`` or
    ``updater.pkl``, written by either package."""
    return _Restricted(raw, _samediff_class).load()
