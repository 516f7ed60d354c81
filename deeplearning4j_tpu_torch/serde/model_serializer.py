"""ModelSerializer — port of ``deeplearning4j_tpu/serde/model_serializer.py``
(``org.deeplearning4j.util.ModelSerializer``: writeModel / restore*,
addNormalizerToModel).

A checkpoint is a zip with the reference's array layout:

- ``params.npz`` / ``states.npz`` (and ``updater.npz`` with
  ``save_updater=True``): each tree flattened to ``|``-joined path keys
  (dict keys; ``#i`` for a tuple's i-th entry), bf16 arrays stored as
  uint16 under the ``__bf16__`` key prefix;
- the port's own record, ``conf_torch.pkl``: the configuration, the
  preprocessors, shapes, counters and the train step's generator state;
  and ``normalizer_torch.pkl`` when a normalizer is given.

The JAX package writes ``conf.pkl`` (its configuration, whose classes
import JAX: never unpickled here), ``normalizer.pkl`` and, with its
updater, ``updater.pkl`` (a pickled optax state). Such a zip's params and
states load into a port net built from the equivalent port configuration
with :func:`load_params`; with ``updater=True`` its optax state is read
without optax or JAX and mapped onto the port's updater state
(``serde/jax_pickles.py``), so ``fit`` resumes where the JAX net would
have; :func:`restore_normalizer` reads its normalizer the same way.
:func:`load_model` also restores an upstream DL4J zip
(``configuration.json`` + ``coefficients.bin``, the format the Java DL4J
writes: ``serde/upstream_dl4j.py``) and a SameDiff zip (``graph.pkl``);
a JAX package's zip, which holds neither nor the port's record, raises
and names :func:`load_params`.

:func:`load_model` builds a new net (no graphs yet). :func:`load_params`
copies into an existing net's tensors in place, so graphs captured on
them stay valid. The arrays are stored uncompressed: weights do not
compress, and deflating them costs seconds at ResNet-50's size.
"""

from __future__ import annotations

import io
import os
import pickle
import zipfile
from pathlib import Path

import numpy as np
import torch

from .._device import resolve_device

SEP = "|"
BF16 = "__bf16__"
RECORD = "conf_torch.pkl"
NORMALIZER = "normalizer_torch.pkl"
JAX_RECORD = "conf.pkl"
JAX_UPDATER = "updater.pkl"
JAX_NORMALIZER = "normalizer.pkl"
UPSTREAM_CONF = "configuration.json"
UPSTREAM_NORMALIZER = "normalizer.bin"


def flatten_with_paths(tree, prefix=""):
    """{path key: tensor} of nested dicts (keys in sorted order), tuples
    and lists (``#i``), as ``jax.tree_util`` paths print."""
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (tuple, list)):
        items = ((f"#{i}", v) for i, v in enumerate(tree))
    else:
        return {prefix: tree} if isinstance(tree, torch.Tensor) else {}
    out = {}
    for k, v in items:
        out.update(flatten_with_paths(v, f"{prefix}{SEP}{k}" if prefix
                                      else k))
    return out


def _save_npz(zf, name, tree):
    packed = {}
    for k, t in flatten_with_paths(tree).items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            packed[BF16 + k] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            packed[k] = t.numpy()
    buf = io.BytesIO()
    np.savez(buf, **packed)
    zf.writestr(name, buf.getvalue())


def _load_npz(zf, name):
    """{path key: CPU tensor} of one npz member (bf16 restored)."""
    with zf.open(name) as f:
        z = np.load(io.BytesIO(f.read()))
        out = {}
        for k in z.files:
            if k.startswith(BF16):
                out[k[len(BF16):]] = torch.from_numpy(
                    z[k].view(np.int16)).view(torch.bfloat16)
            else:
                out[k] = torch.from_numpy(z[k])
        return out


def restore_updater_(opt_state, saved):
    """Put a restored updater state into a built updater's state, in
    place: a port checkpoint's ({path key: tensor}), a JAX package's
    (:class:`~.jax_pickles.JaxUpdaterState`) or an upstream DL4J zip's
    Adam m/v (:class:`~.upstream_dl4j.UpstreamAdamState`)."""
    from .jax_pickles import JaxUpdaterState, restore_optax_state_
    from .upstream_dl4j import UpstreamAdamState, graft_adam_state
    if isinstance(saved, JaxUpdaterState):
        restore_optax_state_(opt_state, saved.state)
    elif isinstance(saved, UpstreamAdamState):
        graft_adam_state(opt_state, saved)
    else:
        restore_tree_(opt_state, saved, "updater")


def restore_tree_(tree, flat, what):
    """Copy ``flat``'s entries into the tensors of ``tree`` in place (cast
    to each tensor's dtype); every tensor of ``tree`` must be there."""
    with torch.no_grad():
        for k, t in flatten_with_paths(tree).items():
            if k not in flat:
                raise KeyError(f"the checkpoint's {what} has no {k}")
            src = flat[k]
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{what} {k}: checkpoint shape "
                                 f"{tuple(src.shape)}, net {tuple(t.shape)}")
            t.copy_(src.to(t.dtype))


def _nest(flat, device, grad):
    out = {}
    for key, v in flat.items():
        parts = key.split(SEP)
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        t = v.to(device)
        d[parts[-1]] = t.requires_grad_(grad and t.is_floating_point())
    return out


def _kind(model):
    from ..nn.computation_graph import ComputationGraph
    from ..nn.multi_layer_network import MultiLayerNetwork
    for cls in (MultiLayerNetwork, ComputationGraph):
        if isinstance(model, cls):
            return cls
    raise TypeError(f"cannot save a {type(model).__name__}")


def save_model(model, path, save_updater: bool = False, normalizer=None):
    """Write ``model`` (an initialized MultiLayerNetwork or
    ComputationGraph) to the zip at ``path``; with ``save_updater`` also
    its updater state, so that ``fit`` after :func:`load_model` continues
    where this net would have."""
    cls = _kind(model)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    gen = model._gen
    record = {
        "kind": cls.__name__, "conf": model.conf,
        "preprocessors": model._preprocessors,
        "epoch_count": model.epoch_count, "step_count": model._step_count,
        "rng": None if gen is None else (gen.device.type,
                                         gen.get_state().numpy().tobytes()),
    }
    if cls.__name__ == "MultiLayerNetwork":
        record["shapes"] = (model._init_input_shape, model.output_shape)
    else:
        record["shapes"] = (model._init_shapes, model.output_shapes)
        record["output_loss_weights"] = model.output_loss_weights
    # write-then-rename: a crash mid-save never corrupts a checkpoint
    tmp = path.with_name(path.name + ".tmp")
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr(RECORD, pickle.dumps(record))
        _save_npz(zf, "params.npz", model.params)
        _save_npz(zf, "states.npz", model.states)
        if save_updater:
            if model._opt_state is not None:
                _save_npz(zf, "updater.npz", model._opt_state)
            elif isinstance(model._restored_opt_state, dict):
                _save_npz(zf, "updater.npz", model._restored_opt_state)
            elif model._restored_opt_state is not None:
                raise ValueError(
                    "the net holds a JAX package's updater state that no "
                    "updater has taken yet: build it (fit) before saving")
        if normalizer is not None:
            zf.writestr(NORMALIZER, pickle.dumps(normalizer))
    os.replace(tmp, path)


def _not_ours(path):
    return ValueError(
        f"{path} holds no {RECORD}, the port's record: it was not written "
        "by deeplearning4j_tpu_torch. A zip of the JAX package loads into a "
        "port net built from the equivalent port configuration with "
        "deeplearning4j_tpu_torch.serde.load_params(net, path)")


def load_model(path, device=None):
    """A new net from a zip :func:`save_model` wrote, on ``device`` (None →
    CUDA). Its updater state, if saved, is put into the updater when
    ``fit`` builds it; a saved normalizer is ``net.normalizer``. An
    upstream DL4J zip (MultiLayerNetwork or ComputationGraph) and a
    SameDiff zip are recognized and restored too."""
    from ..nn.computation_graph import ComputationGraph
    from ..nn.multi_layer_network import MultiLayerNetwork
    dev = resolve_device(device)
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        if RECORD not in names and "graph.pkl" in names:
            from ..autodiff.samediff import SameDiff
            return SameDiff.load(path, device=dev)
        if RECORD not in names and UPSTREAM_CONF in names:
            import json
            from .upstream_dl4j import (
                restore_upstream_computation_graph,
                restore_upstream_multi_layer_network)
            conf = json.loads(zf.read(UPSTREAM_CONF))
            if "vertices" in conf:
                return restore_upstream_computation_graph(path, device=dev)
            return restore_upstream_multi_layer_network(path, device=dev)
        if RECORD not in names:
            raise _not_ours(path)
        meta = pickle.loads(zf.read(RECORD))
        cls = {"MultiLayerNetwork": MultiLayerNetwork,
               "ComputationGraph": ComputationGraph}[meta["kind"]]
        net = cls(meta["conf"])
        net._bind_device(dev)
        net.params = _nest(_load_npz(zf, "params.npz"), dev, True)
        net.states = _nest(_load_npz(zf, "states.npz"), dev, False)
        # layers without params or state leave no keys in the npz
        keys = [f"layer_{i}" for i in range(len(net.layers))] \
            if cls is MultiLayerNetwork else list(net.conf.nodes)
        for k in keys:
            net.params.setdefault(k, {})
            net.states.setdefault(k, {})
        net._preprocessors = meta["preprocessors"]
        if cls is MultiLayerNetwork:
            net._init_input_shape, net.output_shape = meta["shapes"]
        else:
            net._init_shapes, net.output_shapes = meta["shapes"]
            net.output_loss_weights = meta["output_loss_weights"]
        net.epoch_count = meta["epoch_count"]
        net._step_count = meta["step_count"]
        rng = meta["rng"]
        if rng is not None and rng[0] == dev.type:
            net._gen.set_state(torch.frombuffer(bytearray(rng[1]),
                                                dtype=torch.uint8))
        net.initialized = True
        if "updater.npz" in names:
            net._restored_opt_state = _load_npz(zf, "updater.npz")
        if NORMALIZER in names:
            net.normalizer = pickle.loads(zf.read(NORMALIZER))
    return net


def load_params(net, path, updater: bool = False):
    """Copy the params and states of the zip at ``path`` — the port's or
    one the JAX package wrote — into ``net``'s tensors, in place (graphs
    captured on them stay valid). ``net`` is an initialized port net of
    the equivalent configuration; every one of its tensors must be in the
    zip, at its shape (values are cast to its dtypes). With ``updater``
    the updater state is restored too, a port zip's or a JAX zip's
    (``updater.pkl``, mapped onto the port's updater of the same kind):
    into the built updater, or when ``fit`` builds it. Returns ``net``."""
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        restore_tree_(net.params, _load_npz(zf, "params.npz"), "params")
        restore_tree_(net.states, _load_npz(zf, "states.npz"), "states")
        if updater:
            if "updater.npz" in names:
                saved = _load_npz(zf, "updater.npz")
            elif JAX_UPDATER in names:
                from .jax_pickles import JaxUpdaterState, load_optax_state
                saved = JaxUpdaterState(load_optax_state(
                    zf.read(JAX_UPDATER)))
            else:
                raise ValueError(f"{path} holds no updater state")
            if net._opt_state is None:
                net._restored_opt_state = saved
            else:
                restore_updater_(net._opt_state, saved)
    return net


def restore_normalizer(path):
    """The normalizer saved with the model at ``path`` (None without one):
    the port's, a JAX package's ``normalizer.pkl`` read as the port's
    normalizer of the same class, without importing that package, or an
    upstream DL4J zip's ``normalizer.bin``."""
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        if NORMALIZER in names:
            return pickle.loads(zf.read(NORMALIZER))
        if JAX_NORMALIZER in names:
            from .jax_pickles import load_jax_normalizer
            return load_jax_normalizer(zf.read(JAX_NORMALIZER))
        if UPSTREAM_NORMALIZER in names:
            from .upstream_dl4j import read_normalizer_upstream_format
            return read_normalizer_upstream_format(
                zf.read(UPSTREAM_NORMALIZER))
    return None
