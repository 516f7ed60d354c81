"""Transfer learning — port of ``deeplearning4j_tpu/nn/transfer.py``
(``org.deeplearning4j.nn.transferlearning``).

``TransferLearning.Builder(net)`` (MultiLayerNetwork) and
``TransferLearning.GraphBuilder(net)`` (ComputationGraph):
fine_tune_configuration, set_feature_extractor (freeze), nout_replace,
remove layers or vertices, add layers. Frozen layers are labelled for the
NoOp updater, so a frozen leaf takes no update in the compiled step,
eager or replayed. Retained, shape-compatible weights are copied (never
aliased) into the new net on the source's device.

``TransferLearningHelper`` splits a MultiLayerNetwork at its frozen
prefix: ``featurize`` runs the frozen trunk once per DataSet (a compiled
forward), ``fit_featurized`` trains a head net whose params are the
source's own tensors, so the source sees the trained head at once.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional

import torch

from ..train.updaters import tree_leaves, tree_map
from ._compiled import CompiledStep, tensors
from .conf import GlobalConf, MultiLayerConfiguration, resolve_layer_defaults
from .layers.base import Ctx, Layer
from .multi_layer_network import MultiLayerNetwork


class FineTuneConfiguration:
    """The part of the global configuration a transfer may override."""

    def __init__(self, updater=None, seed=None, l1=None, l2=None,
                 dropout=None, weight_init=None):
        self.updater = updater
        self.seed = seed
        self.l1 = l1
        self.l2 = l2
        self.dropout = dropout
        self.weight_init = weight_init

    def apply_to(self, g: GlobalConf):
        for name in ("updater", "seed", "l1", "l2", "dropout",
                     "weight_init"):
            value = getattr(self, name)
            if value is not None:
                setattr(g, name, value)


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_structure(v) for v in tree]
    return None


def _copy_if_compatible(src_p, dst_p, src_s):
    """(params, states) real copies when the trees' structure and leaf
    shapes match, else None."""
    if _structure(src_p) != _structure(dst_p):
        return None
    if not all(a.shape == b.shape for a, b in zip(tree_leaves(src_p),
                                                   tree_leaves(dst_p))):
        return None
    return (tree_map(lambda t: t.detach().clone().requires_grad_(
                t.is_floating_point()), src_p),
            tree_map(lambda t: t.detach().clone(), src_s))


class TransferLearning:
    class GraphBuilder:
        """ComputationGraph transfer (``TransferLearning.GraphBuilder``):
        freeze up to named vertices (their ancestors included),
        nOutReplace by layer name, remove vertices with their
        connections, graft new layers and vertices, re-point outputs."""

        def __init__(self, net):
            from .computation_graph import ComputationGraph
            if not isinstance(net, ComputationGraph) or not net.initialized:
                raise ValueError("source must be an initialized "
                                 "ComputationGraph")
            self._src = net
            self._fine_tune: Optional[FineTuneConfiguration] = None
            self._freeze_at: List[str] = []
            self._nout_replace: List = []
            self._removed: List[str] = []
            self._added: List = []          # (name, op, inputs, is_layer)
            self._outputs: Optional[List[str]] = None
            self._input_shapes = None

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._fine_tune = ftc
            return self

        def set_feature_extractor(self, *vertex_names: str):
            """Freeze the named vertices and everything feeding them."""
            self._freeze_at.extend(vertex_names)
            return self

        def nout_replace(self, layer_name: str, n_out: int,
                         weight_init=None):
            self._nout_replace.append((layer_name, n_out, weight_init))
            return self

        def remove_vertex_and_connections(self, name: str):
            self._removed.append(name)
            return self

        def add_layer(self, name: str, layer: Layer, *inputs: str):
            self._added.append((name, layer, list(inputs), True))
            return self

        def add_vertex(self, name: str, vertex, *inputs: str):
            self._added.append((name, vertex, list(inputs), False))
            return self

        def set_outputs(self, *names: str):
            self._outputs = list(names)
            return self

        def set_input_shapes(self, *shapes):
            self._input_shapes = [tuple(s) for s in shapes]
            return self

        @staticmethod
        def _ancestors(nodes, names):
            out = set()
            stack = list(names)
            while stack:
                n = stack.pop()
                if n in out or n not in nodes:
                    continue
                out.add(n)
                stack.extend(nodes[n].inputs)
            return out

        def build(self):
            from .computation_graph import ComputationGraph
            from .graph import GraphBuilder as ConfBuilder
            src = self._src
            g = copy.deepcopy(src.conf.globals_)
            if self._fine_tune is not None:
                self._fine_tune.apply_to(g)
            kept = {n: copy.deepcopy(d) for n, d in src.conf.nodes.items()
                    if n not in self._removed}
            # a removed name that is re-added is not dangling
            readded = {n for n, _, _, _ in self._added}
            gone = set(self._removed) - readded
            dangling = [n for n, d in kept.items()
                        if any(i in gone for i in d.inputs)]
            if dangling:
                raise ValueError(
                    f"nodes {dangling} still consume removed vertices — "
                    "remove them too or re-point their inputs via add_*")
            frozen = self._ancestors(kept, self._freeze_at)
            missing = [n for n in self._freeze_at if n not in kept]
            if missing:
                raise ValueError(f"unknown feature-extractor nodes {missing}")
            invalid = set()                 # nodes whose weights can't copy

            def touch_consumers(name, n_out):
                """Invalidate the consumers of ``name``: a direct layer
                consumer gets the new n_in, a layer behind a vertex
                n_in=None (init infers it from the real shape)."""
                for n, d in kept.items():
                    if name not in d.inputs:
                        continue
                    invalid.add(n)
                    if isinstance(d.op, Layer):
                        if getattr(d.op, "n_in", None) is not None:
                            d.op = dataclasses.replace(d.op, n_in=n_out)
                    else:
                        touch_consumers(n, None)

            for lname, n_out, winit in self._nout_replace:
                if lname not in kept or not isinstance(kept[lname].op, Layer):
                    raise ValueError(f"nout_replace: no layer '{lname}'")
                kept[lname].op = dataclasses.replace(kept[lname].op,
                                                     n_out=n_out)
                if winit is not None:
                    kept[lname].op.weight_init = winit
                invalid.add(lname)
                touch_consumers(lname, n_out)

            b = ConfBuilder(g)
            b.add_inputs(*src.conf.inputs)
            for name in src.conf.topo_order:
                if name not in kept:
                    continue
                d = kept[name]
                if isinstance(d.op, Layer):
                    if name in frozen:
                        d.op.frozen = True
                    b.add_layer(name, d.op, *d.inputs)
                else:
                    b.add_vertex(name, d.op, *d.inputs)
            for name, op, inputs, is_layer in self._added:
                (b.add_layer if is_layer else b.add_vertex)(name, op,
                                                            *inputs)
            outputs = self._outputs if self._outputs is not None else [
                o for o in src.conf.outputs if o not in gone]
            if not outputs:
                raise ValueError("no outputs left — set_outputs() required")
            b.set_outputs(*outputs)
            if src.conf.input_types is not None:
                b.set_input_types(*src.conf.input_types)
            net = ComputationGraph(b.build())
            shapes = self._input_shapes or getattr(src, "_init_shapes", None)
            net.init(shapes, device=src.device)
            for name in kept:
                if name in invalid or name not in net.params \
                        or name not in src.params:
                    continue
                copied = _copy_if_compatible(src.params[name],
                                             net.params[name],
                                             src.states[name])
                if copied is not None:
                    net.params[name], net.states[name] = copied
            return net

    class Builder:
        """MultiLayerNetwork transfer (``TransferLearning.Builder``)."""

        def __init__(self, net: MultiLayerNetwork):
            if not net.initialized:
                raise ValueError("source network must be initialized")
            self._src = net
            self._fine_tune: Optional[FineTuneConfiguration] = None
            self._freeze_until: Optional[int] = None
            self._nout_replace: List = []
            self._remove_from: Optional[int] = None
            self._added: List[Layer] = []
            self._input_shape = None

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._fine_tune = ftc
            return self

        def set_feature_extractor(self, layer_idx: int):
            """Freeze layers [0..layer_idx]."""
            self._freeze_until = layer_idx
            return self

        def nout_replace(self, layer_idx: int, n_out: int, weight_init=None):
            self._nout_replace.append((layer_idx, n_out, weight_init))
            return self

        def remove_output_layer(self):
            self._remove_from = len(self._src.layers) - 1
            return self

        def remove_layers_from_output(self, n: int):
            self._remove_from = len(self._src.layers) - n
            return self

        def add_layer(self, layer: Layer):
            self._added.append(layer)
            return self

        def set_input_shape(self, shape):
            self._input_shape = tuple(shape)
            return self

        def build(self) -> MultiLayerNetwork:
            src = self._src
            g = copy.deepcopy(src.conf.globals_)
            if self._fine_tune is not None:
                self._fine_tune.apply_to(g)
            keep_n = self._remove_from if self._remove_from is not None \
                else len(src.layers)
            layers = [copy.deepcopy(lyr) for lyr in src.layers[:keep_n]]
            for idx, n_out, winit in self._nout_replace:
                layers[idx] = dataclasses.replace(layers[idx], n_out=n_out)
                if winit is not None:
                    layers[idx].weight_init = winit
            for i, lyr in enumerate(layers):
                if self._freeze_until is not None and i <= self._freeze_until:
                    lyr.frozen = True
                resolve_layer_defaults(lyr, g)
            new_layers = layers + [copy.deepcopy(lyr) for lyr in self._added]
            for lyr in new_layers[len(layers):]:
                resolve_layer_defaults(lyr, g)
            conf = MultiLayerConfiguration(g, new_layers, src.conf.input_type)
            net = MultiLayerNetwork(conf)
            in_shape = self._input_shape
            if in_shape is None and src.conf.input_type is not None:
                in_shape = tuple(src.conf.input_type[1])
            if in_shape is None:
                in_shape = getattr(src, "_init_input_shape", None)
            if in_shape is None:
                raise ValueError("set_input_shape() required when source "
                                 "conf has no input type")
            net.init(in_shape, device=src.device)
            # an nOut change at idx invalidates idx and idx + 1
            invalid = set()
            for idx, _, _ in self._nout_replace:
                invalid.update((idx, idx + 1))
            for i in range(keep_n):
                if i in invalid:
                    continue
                key = f"layer_{i}"
                copied = _copy_if_compatible(src.params[key],
                                             net.params[key],
                                             src.states[key])
                if copied is not None:
                    net.params[key], net.states[key] = copied
            return net


class TransferLearningHelper:
    """Featurized transfer learning (``TransferLearningHelper``): the
    frozen trunk runs once per DataSet (``featurize``), and only the
    unfrozen head trains (``fit_featurized``), in place on the source's
    own tensors."""

    def __init__(self, net: MultiLayerNetwork,
                 frozen_till: Optional[int] = None):
        if not net.initialized:
            raise ValueError("initialize the network first (net.init(...))")
        if frozen_till is None:
            if not net.layers[0].frozen:
                raise ValueError(
                    "no frozen PREFIX: layer 0 is trainable — pass "
                    "frozen_till explicitly or freeze a prefix "
                    "(TransferLearning builder / FrozenLayer)")
            frozen_till = 0
            while (frozen_till + 1 < len(net.layers)
                   and net.layers[frozen_till + 1].frozen):
                frozen_till += 1
        self._src = net
        self._k = int(frozen_till) + 1
        if not 0 < self._k < len(net.layers):
            raise ValueError(f"frozen_till={frozen_till} must leave at least "
                             "one frozen and one trainable layer")
        self._trunk = CompiledStep(
            self._trunk_forward, lambda: tensors((net.params, net.states)),
            "TransferLearningHelper.featurize")
        g = copy.deepcopy(net.conf.globals_)
        head_layers = [copy.deepcopy(lyr) for lyr in net.layers[self._k:]]
        for lyr in head_layers:
            lyr.frozen = False
        conf = MultiLayerConfiguration(g, head_layers, None)
        self._head = MultiLayerNetwork(conf).init(self._feature_shape(),
                                                  device=net.device)
        for i in range(len(head_layers)):
            self._head.params[f"layer_{i}"] = \
                net.params[f"layer_{self._k + i}"]
            self._head.states[f"layer_{i}"] = \
                net.states[f"layer_{self._k + i}"]

    def _trunk_forward(self, x):
        net = self._src
        h = x
        with torch.no_grad():
            for i in range(self._k):
                if i in net._preprocessors:
                    h = net._preprocessors[i](h)
                h, _ = net.layers[i].apply(net.params[f"layer_{i}"],
                                           net.states[f"layer_{i}"], h,
                                           Ctx(train=False))
        return h

    def _feature_shape(self):
        net = self._src
        in_shape = getattr(net, "_init_input_shape", None)
        if in_shape is None and net.conf.input_type is not None:
            in_shape = tuple(net.conf.input_type[1])
        if in_shape is None:
            raise ValueError("source net has no recorded input shape")
        x = torch.zeros((1,) + tuple(in_shape), device=net.device)
        return tuple(self._trunk_forward(x).shape[1:])

    # ------------------------------------------------------------------- api
    def featurize(self, ds):
        """DataSet → DataSet whose features are the frozen trunk's output
        (featurize)."""
        from ..data.dataset import DataSet
        feats = self._trunk(torch.as_tensor(ds.features,
                                            device=self._src.device))
        return DataSet(feats, ds.labels, features_mask=ds.features_mask,
                       labels_mask=ds.labels_mask)

    def fit_featurized(self, data, *, epochs: int = 1):
        """Train the head on featurized DataSets or iterators; its params
        are the source's tensors (fitFeaturized)."""
        return self._head.fit(data, epochs=epochs)

    def output_from_featurized(self, feats):
        return self._head.output(feats)

    def unfrozen_mln(self) -> MultiLayerNetwork:
        """The trainable submodel (unfrozenMLN)."""
        return self._head
