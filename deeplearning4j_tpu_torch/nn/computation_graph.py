"""ComputationGraph — port of ``deeplearning4j_tpu/nn/computation_graph.py``
(DAG network runtime: init / fit / fit_scanned / output / score).

The topological order runs on one device. A train step
(:meth:`_train_step`, the static step of ``nn/_compiled.py``) updates
everything in place:

1. the loss, with ``torch.autograd.grad`` on the leaves of ``params``;
2. the in-place updater (``train/updaters.py``) under ``no_grad``, its
   updates added to the params with one ``_foreach_add_`` per dtype;
3. the new running states copied into ``states``.

Constraints, if any are set, raise before the first step (not ported
yet). ``fit`` and ``fit_scanned`` run the step through a
:class:`CompiledStep`: on CUDA each batch signature's first step is eager,
its second is captured as a CUDA graph, and later steps replay it
(``disable_graphs()`` keeps every step eager); on the CPU the step is
called directly.

``device=None`` means the CUDA card (``_device.resolve_device``); only an
explicit ``"cpu"`` runs on the host. Params and states are nested dicts
of tensors in the reference's layout, so :func:`params_from_numpy` takes
the JAX net's ``net.params`` / ``net.states`` as numpy trees.

Not ported yet (raise where the reference has the knob): remat segments,
``rnn_time_step``, gradient-anomaly detection, ``evaluate``,
``save``/``load``, ``clone``, dropout and weight noise, multi-input
layers, and async prefetch of the iterator (``fit`` iterates directly).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from .._device import resolve_device, tree_to
from ..train.updaters import (NoOp, apply_updates, build_optimizer,
                              tree_leaves, tree_map)
from ._compiled import CompiledStep, copy_into, tensors
from ._scan_common import check_scan_listeners, replay_scan_listeners
from .graph import ComputationGraphConfiguration
from .layers.base import Ctx, Layer
from .layers.core import LossLayer, OutputLayer
from .multi_layer_network import _is_ff_layer, _unflatten
from .preprocessors import CnnToFeedForwardPreProcessor


def params_from_numpy(params, states, device=None):
    """The JAX net's ``net.params`` / ``net.states`` (nested dicts of numpy
    arrays, layouts kept: HWIO conv kernels, (nIn, nOut) dense, BN
    gamma/beta and mean/var) → the port's ``(params, states)`` on
    ``device``; float params require grad."""
    dev = resolve_device(device)

    def conv(a, grad):
        t = torch.as_tensor(np.array(a), device=dev)
        if grad and t.is_floating_point():
            t.requires_grad_(True)
        return t

    return (tree_map(lambda a: conv(a, True), params),
            tree_map(lambda a: conv(a, False), states))


class ComputationGraph:
    def __init__(self, conf: ComputationGraphConfiguration):
        self.conf = conf
        self._g = conf.globals_
        self.params: Dict[str, dict] = {}
        self.states: Dict[str, dict] = {}
        self._preprocessors: Dict[str, Any] = {}
        self._optimizer = None
        self._opt_state = None
        self.listeners: List[Any] = []
        self.initialized = False
        self.device = None
        self.epoch_count = 0
        self._step_count = 0
        self._gen = torch.Generator().manual_seed(self._g.seed)
        self.output_loss_weights = {name: 1.0 for name in conf.outputs}
        self._remat_segments = None
        self._step_fn = None

    @property
    def remat_segments(self):
        return self._remat_segments

    @remat_segments.setter
    def remat_segments(self, n):
        if n is not None:
            raise NotImplementedError(
                "ComputationGraph.remat_segments / _forward_remat "
                "(deeplearning4j_tpu/nn/computation_graph.py) is not "
                "ported yet")
        self._remat_segments = n

    # ------------------------------------------------------------------ init
    def init(self, input_shapes=None, device=None):
        """Draw every layer's params on the host from a generator seeded
        with the configuration's seed, then move them to ``device``."""
        self.device = resolve_device(device)
        if input_shapes is None:
            if self.conf.input_types is None:
                raise ValueError("Provide input_shapes or set_input_types")
            input_shapes = [tuple(t[1]) for t in self.conf.input_types]
        shapes = {name: tuple(s) for name, s in zip(self.conf.inputs,
                                                    input_shapes)}
        gen = torch.Generator().manual_seed(self._g.seed)
        for name in self.conf.topo_order:
            node = self.conf.nodes[name]
            in_shapes = [shapes[i] for i in node.inputs]
            if isinstance(node.op, Layer):
                if getattr(node.op, "multi_input", False):
                    raise NotImplementedError(
                        "multi-input layers are not ported yet")
                s = in_shapes[0]
                if _is_ff_layer(node.op) and len(s) == 3:
                    pp = CnnToFeedForwardPreProcessor()
                    self._preprocessors[name] = pp
                    s = pp.out_shape(s)
                p, st, out = node.op.init(gen, s)
                self.params[name] = tree_map(
                    lambda t: t.to(self.device).requires_grad_(
                        t.is_floating_point()), p)
                self.states[name] = tree_to(st, self.device)
                shapes[name] = out
            else:
                shapes[name] = node.op.out_shape(in_shapes)
                self.params[name] = {}
                self.states[name] = {}
        self.output_shapes = {o: shapes[o] for o in self.conf.outputs}
        self.initialized = True
        return self

    # -------------------------------------------------------------- forward
    def _apply_node(self, name, params, states, acts, pre_acts, new_states,
                    *, train, rng, fmask, lmask, stop_at_output_preact):
        node = self.conf.nodes[name]
        xs = [acts[i] for i in node.inputs]
        if not isinstance(node.op, Layer):
            acts[name] = node.op.apply(xs)
            new_states[name] = states[name]
            return
        op = node.op
        if train and (op.dropout > 0.0 or op.weight_noise is not None):
            raise NotImplementedError(
                f"node '{name}': dropout and weight noise (reference "
                "_apply_node_inner, nn/weightnoise.py) are not ported yet")
        h = xs[0]
        if name in self._preprocessors:
            h = self._preprocessors[name](h)
        if stop_at_output_preact and name in self.conf.outputs and \
                isinstance(op, (OutputLayer, LossLayer)):
            pre_acts[name] = h
            new_states[name] = states[name]
            acts[name] = h
            return
        ctx = Ctx(train=train, rng=rng, mask=fmask, label_mask=lmask)
        h, s_new = op.apply(params[name], states[name], h, ctx)
        new_states[name] = s_new
        acts[name] = h

    def _as_input_dict(self, inputs):
        """Accept {name: tensor}, [tensor, ...] (zipped with conf.inputs),
        or a bare tensor (single-input graphs)."""
        if isinstance(inputs, dict):
            return inputs
        if isinstance(inputs, (list, tuple)):
            if len(inputs) != len(self.conf.inputs):
                raise ValueError(
                    f"got {len(inputs)} feature arrays for a graph with "
                    f"{len(self.conf.inputs)} inputs {self.conf.inputs}")
            return {n: v for n, v in zip(self.conf.inputs, inputs)}
        return {self.conf.inputs[0]: inputs}

    def _as_label_dict(self, labels):
        if isinstance(labels, dict):
            return labels
        if isinstance(labels, (list, tuple)):
            if len(labels) != len(self.conf.outputs):
                raise ValueError(
                    f"got {len(labels)} label arrays for a graph with "
                    f"{len(self.conf.outputs)} outputs {self.conf.outputs}")
            return {n: v for n, v in zip(self.conf.outputs, labels)}
        return {self.conf.outputs[0]: labels}

    def _forward(self, params, states, inputs, *, train, rng,
                 fmask=None, lmask=None, stop_at_output_preact=False):
        acts = dict(self._as_input_dict(inputs))
        new_states = {}
        pre_acts = {}
        for name in self.conf.topo_order:
            self._apply_node(name, params, states, acts, pre_acts,
                             new_states, train=train, rng=rng, fmask=fmask,
                             lmask=lmask,
                             stop_at_output_preact=stop_at_output_preact)
        return acts, pre_acts, new_states

    def _to_device(self, x):
        return torch.as_tensor(x, device=self.device)

    def output(self, *inputs):
        """Inference on the net's device; numpy arrays or tensors in, one
        tensor per graph output (a bare tensor for one output)."""
        ins = {n: self._to_device(x) for n, x in zip(self.conf.inputs,
                                                     inputs)}
        with torch.no_grad():
            acts, _, _ = self._forward(self.params, self.states, ins,
                                       train=False, rng=None)
        outs = [acts[o] for o in self.conf.outputs]
        return outs[0] if len(outs) == 1 else outs

    def rnn_time_step(self, *inputs):
        raise NotImplementedError(
            "ComputationGraph.rnn_time_step is not ported yet")

    def rnn_clear_previous_state(self):
        raise NotImplementedError(
            "ComputationGraph.rnn_clear_previous_state is not ported yet")

    # ----------------------------------------------------------------- loss
    def _loss(self, params, states, inputs, labels, rng, fmask, lmask):
        labels = self._as_label_dict(labels)
        acts, pre_acts, new_states = self._forward(
            params, states, inputs, train=True, rng=rng, fmask=fmask,
            lmask=lmask, stop_at_output_preact=True)
        total = 0.0
        for name in self.conf.outputs:
            op = self.conf.nodes[name].op
            y = labels[name]
            w = self.output_loss_weights.get(name, 1.0)
            if isinstance(op, OutputLayer):
                total = total + w * op.compute_loss(
                    params[name], pre_acts[name], y, mask=lmask)
            elif isinstance(op, LossLayer):
                total = total + w * op.compute_loss(
                    pre_acts[name], y, mask=lmask)
            else:
                raise ValueError(
                    f"output node '{name}' is not an output/loss layer")
        total = total + self._reg_score(params)
        return total, new_states

    def _reg_score(self, params):
        reg = 0.0
        for name, node in self.conf.nodes.items():
            op = node.op
            if not isinstance(op, Layer) or (op.l1 == 0.0 and op.l2 == 0.0):
                continue
            for k, w in params[name].items():
                if k in ("b", "beta", "mean", "var"):
                    continue
                if op.l1:
                    reg = reg + op.l1 * torch.sum(torch.abs(w))
                if op.l2:
                    reg = reg + 0.5 * op.l2 * torch.sum(torch.square(w))
        return reg

    # ------------------------------------------------------------ optimizer
    def _build_optimizer(self, ipe=1):
        g = self._g
        labels = {}
        has_override = False
        per_label = {"__default__": g.updater, "__frozen__": NoOp()}
        for name, node in self.conf.nodes.items():
            if isinstance(node.op, Layer) and node.op.frozen:
                lab = "__frozen__"
                has_override = True
            elif isinstance(node.op, Layer) and node.op.updater is not None:
                lab = f"__{name}__"
                per_label[lab] = node.op.updater
                has_override = True
            else:
                lab = "__default__"
            labels[name] = tree_map(lambda _, lab=lab: lab, self.params[name])
        self._optimizer = build_optimizer(
            g.updater, grad_norm=g.grad_norm,
            grad_norm_threshold=g.grad_norm_threshold, iters_per_epoch=ipe,
            param_labels=labels if has_override else None,
            per_label_updaters=per_label if has_override else None)
        with torch.no_grad():
            self._opt_state = self._optimizer.init(self.params)

    def _apply_constraints(self):
        for name, node in self.conf.nodes.items():
            op = node.op
            if isinstance(op, Layer) and not op.frozen and (
                    op.constraints or op.bias_constraints):
                raise NotImplementedError(
                    f"node '{name}': weight constraints (deeplearning4j_tpu/"
                    "train/constraints.py) are not ported yet")

    def _train_step(self, inputs, labels, fmask, lmask):
        """The static step: one batch, the params, the updater's state and
        the running states updated in place. Returns the loss (0-d)."""
        leaves = tree_leaves(self.params)
        loss, new_states = self._loss(self.params, self.states, inputs,
                                      labels, self._gen, fmask, lmask)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        gtree = _unflatten(self.params, iter(
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)))
        with torch.no_grad():
            updates, _ = self._optimizer.update(gtree, self._opt_state,
                                                self.params)
            apply_updates(leaves, tree_leaves(updates))
            copy_into(self.states, new_states)
        return loss.detach()

    def _compiled_step(self):
        """The net's :class:`CompiledStep` over :meth:`_train_step`, fed
        the batch as (inputs in ``conf.inputs`` order, labels in
        ``conf.outputs`` order, features mask, labels mask)."""
        if self._step_fn is None:
            ins, outs = self.conf.inputs, self.conf.outputs

            def step(*flat):
                return self._train_step(
                    dict(zip(ins, flat[:len(ins)])),
                    dict(zip(outs, flat[len(ins):-2])), flat[-2], flat[-1])
            self._step_fn = CompiledStep(
                step,
                lambda: tensors((self.params, self.states, self._opt_state)),
                "ComputationGraph")
        return self._step_fn

    def enable_gradient_anomaly_detection(self, detector=None):
        raise NotImplementedError(
            "gradient anomaly detection (deeplearning4j_tpu/train/anomaly.py)"
            " is not ported yet")

    # ------------------------------------------------------------------ fit
    def fit(self, data, *, epochs: int = 1, device=None):
        """fit(DataSet | MultiDataSet | iterable of them). An uninitialized
        net is initialized from the first batch's shapes on ``device``
        (``None`` → CUDA); an initialized one trains where it lives.
        Returns the last loss as a float."""
        from ..data.dataset import DataSet, MultiDataSet
        if isinstance(data, (DataSet, MultiDataSet)):
            iterator = [data]
        else:
            iterator = data
        if not self.initialized:
            first = next(iter(iterator))
            feats = first.features if isinstance(first, MultiDataSet) \
                else [first.features]
            self.init([tuple(f.shape[1:]) for f in feats], device=device)
            if hasattr(iterator, "reset"):
                iterator.reset()
        elif device is not None and \
                torch.device(device).type != self.device.type:
            raise ValueError(f"the net lives on {self.device}, not {device}")
        if self._optimizer is None:
            try:
                ipe = len(iterator)
            except TypeError:
                ipe = 1
            self._build_optimizer(max(int(ipe), 1))
        last = self._fit_epochs(iterator, epochs)
        return None if last is None else float(last)

    def fit_scanned(self, data, *, epochs: int = 1):
        """The reference's epoch loop in one dispatch
        (``computation_graph.py:596``), here one replay of the compiled
        step a batch, with ``MultiLayerNetwork.fit_scanned``'s contract:
        the batches stacked once on the device and fed by device-to-device
        copies, equally shaped and mask-free; listeners that take deferred
        scores, replayed from the epoch's losses (one fetch an epoch); the
        trajectory of ``fit``, bit for bit. Returns the last loss as a
        float."""
        from ..data.dataset import DataSet, MultiDataSet
        if isinstance(data, (DataSet, MultiDataSet)):
            batches = [data]
        else:
            batches = list(data)
        if not batches:
            return None

        def unpack(ds):
            if isinstance(ds, MultiDataSet):
                if ds.features_masks is not None or \
                        ds.labels_masks is not None:
                    raise ValueError("fit_scanned does not support masked "
                                     "batches; use fit()")
                return ds.features, ds.labels
            if ds.features_mask is not None or ds.labels_mask is not None:
                raise ValueError("fit_scanned does not support masked "
                                 "batches; use fit()")
            return [ds.features], [ds.labels]

        pairs = [unpack(ds) for ds in batches]
        shapes = {tuple(tuple(a.shape) for a in (*fs, *ls))
                  for fs, ls in pairs}
        if len(shapes) > 1:
            raise ValueError("fit_scanned needs equally-shaped batches; "
                             "use fit()")
        check_scan_listeners(self)
        if not self.initialized:
            self.init([tuple(f.shape[1:]) for f in pairs[0][0]])
        if self._optimizer is None:
            self._build_optimizer(max(len(batches), 1))
        self._apply_constraints()
        # one (K, B, ...) tensor per input, then per output
        cols = [[fs[i] for fs, _ in pairs] for i in range(len(pairs[0][0]))] \
            + [[ls[i] for _, ls in pairs] for i in range(len(pairs[0][1]))]
        stacked = [torch.stack([self._to_device(a) for a in col])
                   for col in cols]
        step = self._compiled_step()
        losses = None
        for _ in range(epochs):
            losses = torch.stack([step(*(a[k] for a in stacked), None, None)
                                  for k in range(len(batches))])
            self._step_count += len(batches)
            self.epoch_count += 1
            replay_scan_listeners(self, losses, len(batches))
        return float(losses[-1])

    def _fit_epochs(self, iterator, epochs):
        from ..data.dataset import MultiDataSet
        self._apply_constraints()
        step = self._compiled_step()
        last = None
        for e in range(epochs):
            for ds in iterator:
                if isinstance(ds, MultiDataSet):
                    feats, labs = ds.features, ds.labels
                    fmask = None if ds.features_masks is None \
                        else ds.features_masks[0]
                    lmask = None if ds.labels_masks is None \
                        else ds.labels_masks[0]
                else:
                    feats, labs = [ds.features], [ds.labels]
                    fmask, lmask = ds.features_mask, ds.labels_mask
                fm = None if fmask is None else self._to_device(fmask)
                lm = None if lmask is None else self._to_device(lmask)
                loss = step(*(self._to_device(a) for a in (*feats, *labs)),
                            fm, lm)
                self._step_count += 1
                last = loss
                if self.listeners:
                    lv = float(loss)
                    for listener in self.listeners:
                        listener.iteration_done(self, self._step_count,
                                                self.epoch_count, lv)
            self.epoch_count += 1
            if hasattr(iterator, "reset"):
                iterator.reset()
            for listener in self.listeners:
                if hasattr(listener, "on_epoch_end"):
                    listener.on_epoch_end(self)
        return last

    def score(self, ds):
        from ..data.dataset import MultiDataSet
        if isinstance(ds, MultiDataSet):
            feats, labs = ds.features, ds.labels
        else:
            feats, labs = [ds.features], [ds.labels]
        inputs = {n: self._to_device(f) for n, f in zip(self.conf.inputs,
                                                        feats)}
        labels = {n: self._to_device(l) for n, l in zip(self.conf.outputs,
                                                        labs)}
        with torch.no_grad():
            loss, _ = self._loss(self.params, self.states, inputs, labels,
                                 None, None, None)
        return float(loss)

    def evaluate(self, iterator, top_n: int = 1):
        raise NotImplementedError(
            "ComputationGraph.evaluate (deeplearning4j_tpu/eval/) is not "
            "ported yet")

    def set_listeners(self, *listeners):
        self.listeners = list(listeners)

    def num_params(self):
        return sum(int(p.numel()) for p in tree_leaves(self.params))

    def params_flat(self):
        """Single flat vector, in the reference's order (sorted node name,
        then sorted param name within a node)."""
        leaves = tree_leaves(self.params)
        if not leaves:
            return torch.zeros((0,), device=self.device)
        return torch.cat([p.detach().reshape(-1) for p in leaves])

    def set_params_flat(self, flat):
        flat = self._to_device(flat)
        off = 0
        with torch.no_grad():
            for p in tree_leaves(self.params):
                n = p.numel()
                p.copy_(flat[off:off + n].reshape(p.shape).to(p.dtype))
                off += n

    def clone(self):
        raise NotImplementedError("ComputationGraph.clone is not ported yet")

    def summary(self):
        lines = ["=" * 72, f"{'Node':<26}{'Type':<26}{'Params':<12}", "=" * 72]
        total = 0
        for name in self.conf.topo_order:
            node = self.conf.nodes[name]
            n = sum(int(v.numel())
                    for v in tree_leaves(self.params.get(name, {})))
            total += n
            lines.append(f"{name:<26}{type(node.op).__name__:<26}{n:<12}")
        lines += ["=" * 72, f"Total params: {total}", "=" * 72]
        return "\n".join(lines)

    def save(self, path, save_updater: bool = False):
        raise NotImplementedError(
            "ComputationGraph.save (deeplearning4j_tpu/serde/"
            "model_serializer.py) is not ported yet")

    @staticmethod
    def load(path):
        raise NotImplementedError(
            "ComputationGraph.load (deeplearning4j_tpu/serde/"
            "model_serializer.py) is not ported yet")
