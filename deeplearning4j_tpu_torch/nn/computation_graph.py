"""ComputationGraph — port of ``deeplearning4j_tpu/nn/computation_graph.py``
(DAG network runtime: init / fit / fit_scanned / output / evaluate /
score / save / load / clone).

The topological order runs on one device. A train step
(:meth:`_train_step`, the static step of ``nn/_compiled.py``) updates
everything in place, as ``MultiLayerNetwork``'s does: the loss and its
grads (input dropout and weight noise drawn from the net's generator),
the grad stats and the gate's copy with a detector attached, the
in-place updater, the weight constraints, the running states, the gate.

``fit`` and ``fit_scanned`` run the step through a
:class:`CompiledStep`: on CUDA each batch signature's first step is eager,
its second is captured as a CUDA graph, and later steps replay it
(``disable_graphs()`` keeps every step eager); on the CPU the step is
called directly; either way inside the compile sentinel
``cg_train_step`` (``obs.compiles``). ``fit`` reports steps to the listeners one step late
where they allow it (``nn/_fit_loop.py``); ``output()`` is a compiled
step of its own, one graph per input signature.

``device=None`` means the CUDA card (``_device.resolve_device``); only an
explicit ``"cpu"`` runs on the host. Params and states are nested dicts
of tensors in the reference's layout, so :func:`params_from_numpy` takes
the JAX net's ``net.params`` / ``net.states`` as numpy trees.

``remat_segments = n`` runs the train-time forward as n segments cut
where the fewest activations cross (:meth:`_segment_plan`), each under
``nn/_remat.py``'s checkpoint: loss, grads, states and dropout draws equal
the monolithic walk's. ``fit`` prefetches a ``BaseDatasetIterator``
through ``data/async_iter.py`` (``nn/_fit_loop.py``).
:meth:`rnn_time_step` streams through the recurrent nodes, one compiled
step per input signature, their carries on the device.

A layer with ``multi_input`` (``AttentionVertex``) takes the list of its
input nodes' activations, as in the reference; its input dropout draws
one mask per input.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from .. import _dist
from .._device import resolve_device, tree_to
from ..train.constraints import apply_constraints_
from ..train.updaters import NoOp, build_optimizer, tree_leaves, tree_map
from ..obs.compiles import CompileSentinel
from ._compiled import CompiledStep, tensors
from ._fit_loop import fit_epochs
from ._remat import checkpoint_segment
from ._scan_common import check_scan_listeners, replay_scan_listeners
from .graph import ComputationGraphConfiguration
from .layers.base import Ctx, Layer
from .layers.core import LossLayer, OutputLayer, dropout_apply, keep_mask
from .layers.recurrent import Bidirectional, LastTimeStep, TimeDistributed
from .layers.samediff_layer import SameDiffOutputLayer, needs_host
from .layers.wrappers import unwrap
from .multi_layer_network import (_copy_params, _is_ff_layer, _unflatten,
                                  _update_in_place)
from .preprocessors import CnnToFeedForwardPreProcessor
from .weightnoise import maybe_apply_weight_noise


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


def _like(like, leaves):
    """A carry shaped like ``like`` (a tensor or a tuple of them) from an
    iterator over tensors."""
    if isinstance(like, tuple):
        return tuple(next(leaves) for _ in like)
    return next(leaves)


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
        self._gen = None
        self.output_loss_weights = {name: 1.0 for name in conf.outputs}
        self._remat_segments = None
        self._step_fn = None
        self._sentinel = None
        self._infer_fn = None
        self._anomaly_detector = None
        self._restored_opt_state = None
        self._remat_plan_cache = {}
        self._rnn_stream_fn = None
        self._rnn_carries = None
        self._rnn_carry_batch = None

    @property
    def remat_segments(self):
        return self._remat_segments

    @remat_segments.setter
    def remat_segments(self, n):
        """Changing the remat policy drops every compiled step that ran
        the old forward."""
        if self._remat_segments != n:
            self._invalidate()
            self._remat_plan_cache = {}
        self._remat_segments = n

    def _needs_host(self):
        """A node's SameDiff graph needs the host while it runs: every
        step runs eagerly (``layers/samediff_layer.py``)."""
        return needs_host(node.op for node in self.conf.nodes.values())

    def _invalidate(self):
        """Drop the compiled steps (each is made anew on its next use)."""
        self._step_fn = None
        self._sentinel = None
        self._infer_fn = None
        self._rnn_stream_fn = None

    # ------------------------------------------------------------------ init
    def init(self, input_shapes=None, device=None):
        """Draw every layer's params on the host from a generator seeded
        with the configuration's seed, then move them to ``device``."""
        self._bind_device(resolve_device(device))
        if input_shapes is None:
            if self.conf.input_types is None:
                raise ValueError("Provide input_shapes or set_input_types")
            input_shapes = [tuple(t[1]) for t in self.conf.input_types]
        shapes = {name: tuple(s) for name, s in zip(self.conf.inputs,
                                                    input_shapes)}
        self._init_shapes = [tuple(s) for s in input_shapes]
        gen = torch.Generator().manual_seed(self._g.seed)
        for name in self.conf.topo_order:
            node = self.conf.nodes[name]
            in_shapes = [shapes[i] for i in node.inputs]
            if isinstance(node.op, Layer):
                if getattr(node.op, "multi_input", False):
                    s = in_shapes
                else:
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

    def _bind_device(self, device):
        """Live on ``device``, with the train step's generator there."""
        self.device = device
        self._gen = torch.Generator(device=device).manual_seed(self._g.seed)

    # -------------------------------------------------------------- forward
    def _apply_node(self, name, params, states, acts, pre_acts, new_states,
                    *, train, rng, fmask, lmask, stop_at_output_preact,
                    groups=_dist.NONE):
        node = self.conf.nodes[name]
        xs = [acts[i] for i in node.inputs]
        if not isinstance(node.op, Layer):
            acts[name] = node.op.apply(xs)
            new_states[name] = states[name]
            return
        op = node.op
        noisy = train and rng is not None
        keep = 1.0 - op.dropout
        if getattr(op, "multi_input", False):
            h = [dropout_apply(x, keep_mask(x.shape, keep, rng, x.device),
                               keep) for x in xs] \
                if noisy and op.dropout > 0.0 else xs
        else:
            h = xs[0]
            if name in self._preprocessors:
                h = self._preprocessors[name](h)
            if noisy and op.dropout > 0.0:
                h = dropout_apply(h, keep_mask(h.shape, keep, rng, h.device),
                                  keep)
        if stop_at_output_preact and name in self.conf.outputs and \
                isinstance(unwrap(op), (OutputLayer, LossLayer,
                                        SameDiffOutputLayer)):
            pre_acts[name] = h
            new_states[name] = states[name]
            acts[name] = h
            return
        p_n = maybe_apply_weight_noise(op, params[name], rng, noisy)
        ctx = Ctx(train=train, rng=rng, mask=fmask, label_mask=lmask,
                  groups=groups)
        h, s_new = op.apply(p_n, states[name], h, ctx)
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
                 fmask=None, lmask=None, stop_at_output_preact=False,
                 groups=_dist.NONE):
        """(acts, pre_acts, new_states). ``groups``: a parallel step's
        (``_dist.Groups``), handed to every node's ``Ctx``."""
        inputs = self._as_input_dict(inputs)
        if train and self.remat_segments:
            return self._forward_remat(
                params, states, inputs, train=train, rng=rng, fmask=fmask,
                lmask=lmask, stop_at_output_preact=stop_at_output_preact,
                groups=groups)
        acts = dict(inputs)
        new_states = {}
        pre_acts = {}
        for name in self.conf.topo_order:
            self._apply_node(name, params, states, acts, pre_acts,
                             new_states, train=train, rng=rng, fmask=fmask,
                             lmask=lmask,
                             stop_at_output_preact=stop_at_output_preact,
                             groups=groups)
        return acts, pre_acts, new_states

    # ------------------------------------------------------- segmented remat
    def _segment_plan(self, n_segments, input_names):
        """Partition topo_order into ``n_segments`` contiguous segments,
        cutting where the cross-boundary live set is smallest (the
        reference's plan).

        Liveness: an activation is live after position i if its producer
        is at <= i and some consumer is at > i (graph outputs live to the
        end). Each cut carries exactly the live set, so any cut is valid;
        the live set's size decides what the checkpoint keeps. On a chain
        of residual blocks (ResNet) the minimal cuts land on block
        boundaries, where one tensor crosses."""
        order = self.conf.topo_order
        n = len(order)
        last_use = {}
        for idx, name in enumerate(order):
            for i in self.conf.nodes[name].inputs:
                last_use[i] = idx
        for o in self.conf.outputs:
            last_use[o] = n
        producers = list(input_names) + order
        pos = {a: -1 for a in input_names}
        pos.update({name: idx for idx, name in enumerate(order)})

        def live_after(idx):
            return [a for a in producers
                    if pos[a] <= idx and last_use.get(a, -1) > idx]

        cuts = []
        span = n / n_segments
        for k in range(1, n_segments):
            ideal = int(round(k * span)) - 1
            lo = max((cuts[-1] + 1) if cuts else 0, int(ideal - span // 2))
            hi = min(n - 2, int(ideal + span // 2))
            if lo > hi:
                continue
            best = min(range(lo, hi + 1),
                       key=lambda i: (len(live_after(i)), abs(i - ideal)))
            cuts.append(best)
        if len(cuts) + 1 < n_segments:
            import warnings
            warnings.warn(
                f"remat_segments={n_segments} exceeds what this "
                f"{n}-node graph supports; using {len(cuts) + 1} "
                "checkpoint segments (activation footprint will be larger "
                "than configured)", stacklevel=3)
        bounds = [-1] + cuts + [n - 1]
        segments = []
        for a, b in zip(bounds[:-1], bounds[1:]):
            nodes = [(i, order[i]) for i in range(a + 1, b + 1)]
            carry_in = sorted(live_after(a)) if a >= 0 else \
                sorted(input_names)
            carry_out = sorted(live_after(b)) if b < n - 1 else \
                sorted(set(self.conf.outputs))
            segments.append({"nodes": nodes, "carry_in": carry_in,
                             "carry_out": carry_out})
        return segments

    def _forward_remat(self, params, states, inputs, *, train, rng,
                       fmask=None, lmask=None, stop_at_output_preact=False,
                       groups=_dist.NONE):
        """:meth:`_forward` with each planned segment under
        ``checkpoint_segment``: only the activations that cross a segment
        boundary are kept for the backward; the rest is recomputed there."""
        key = (int(self.remat_segments), tuple(sorted(inputs)))
        plan = self._remat_plan_cache.get(key)
        if plan is None:
            plan = self._remat_plan_cache[key] = self._segment_plan(
                self.remat_segments, sorted(inputs))
        acts = dict(inputs)
        pre_acts, new_states = {}, {}
        for seg in plan:
            def seg_fn(carry, _seg=seg):
                a, pre, ns = dict(carry), {}, {}
                for _, nm in _seg["nodes"]:
                    self._apply_node(
                        nm, params, states, a, pre, ns, train=train, rng=rng,
                        fmask=fmask, lmask=lmask,
                        stop_at_output_preact=stop_at_output_preact,
                        groups=groups)
                return ({k: a[k] for k in _seg["carry_out"] if k in a},
                        ns, pre)

            out, ns, pre = checkpoint_segment(
                seg_fn, {k: acts[k] for k in seg["carry_in"]})
            acts.update(out)
            new_states.update(ns)
            pre_acts.update(pre)
        return acts, pre_acts, new_states

    def _to_device(self, x):
        return torch.as_tensor(x, device=self.device)

    def _infer_step(self):
        """The compiled inference forward: one CUDA graph per input
        signature, fresh output tensors a call."""
        if self._infer_fn is None:
            def infer(*xs):
                with torch.no_grad():
                    acts, _, _ = self._forward(
                        self.params, self.states,
                        dict(zip(self.conf.inputs, xs)), train=False,
                        rng=None)
                return tuple(acts[o] for o in self.conf.outputs)
            self._infer_fn = CompiledStep(
                infer, lambda: tensors((self.params, self.states)),
                "ComputationGraph.output", eager=self._needs_host())
        return self._infer_fn

    def output(self, *inputs):
        """Inference on the net's device; numpy arrays or tensors in, one
        tensor per graph output (a bare tensor for one output)."""
        outs = list(self._infer_step()(*(self._to_device(x)
                                         for x in inputs)))
        return outs[0] if len(outs) == 1 else outs

    # ------------------------------------------------------- rnn streaming
    def rnn_time_step(self, *inputs):
        """Streaming inference through the DAG (reference
        ComputationGraph.rnnTimeStep): a (B, T, C) chunk, or a (B, C) float
        single step, per graph input; every recurrent node's carry stays
        on the device across calls until :meth:`rnn_clear_previous_state`
        (a new batch size restarts it). Each step runs the recurrent
        layers' single-step ``step_apply`` (not K4), inside one compiled
        step per input signature (``nn/_compiled.py``: a CUDA graph on the
        card). Returns one tensor per graph output (a bare tensor for one
        output)."""
        from .layers.recurrent import BaseRecurrent
        for name in self.conf.topo_order:
            op = self.conf.nodes[name].op
            if isinstance(op, Layer) and isinstance(
                    unwrap(op), (Bidirectional, LastTimeStep,
                                 TimeDistributed)):
                raise NotImplementedError(
                    f"rnn_time_step cannot stream through node '{name}' "
                    f"({type(unwrap(op)).__name__}): it needs the full "
                    "sequence "
                    "(reference rnnTimeStep has the same limit)")
        xs = [self._to_device(x) for x in inputs]
        integer = not xs[0].is_floating_point()
        single = (xs[0].dim() == 2 and not integer) or \
            (xs[0].dim() == 1 and integer)
        if single:
            xs = [x[:, None] if x.dim() == 1 else x[:, None, :] for x in xs]
        batch = xs[0].shape[0]
        old = self._rnn_carries or {}
        if self._rnn_carry_batch != batch:
            old = {}                   # batch changed: stale state is void
        carries = {}
        for name in self.conf.topo_order:
            op = self.conf.nodes[name].op
            op = unwrap(op) if isinstance(op, Layer) else op
            if isinstance(op, BaseRecurrent):
                c = old.get(name)
                carries[name] = c if c is not None else op.init_carry(
                    batch, op.compute_dtype or (
                        xs[0].dtype if not integer else torch.float32),
                    self.device)
        names = sorted(carries)
        flat = tensors([carries[n] for n in names])
        out = self._rnn_stream(names, carries)(*xs, *flat)
        n_out = len(self.conf.outputs)
        ys, new_flat = list(out[:n_out]), iter(out[n_out:])
        self._rnn_carries = {n: _like(carries[n], new_flat) for n in names}
        self._rnn_carry_batch = batch
        ys = [y[:, 0] for y in ys] if single else ys
        return ys[0] if len(ys) == 1 else ys

    def _rnn_stream(self, names, like):
        """The compiled stream: (inputs..., carries...) → (outputs...,
        new carries...), the carries flattened in ``names`` order."""
        if self._rnn_stream_fn is None:
            from .layers.recurrent import BaseRecurrent
            n_in = len(self.conf.inputs)

            def stream(*flat):
                xs = flat[:n_in]
                rest = iter(flat[n_in:])
                cs = {n: _like(like[n], rest) for n in names}
                ys = []
                with torch.no_grad():
                    for t in range(xs[0].shape[1]):
                        acts = {n: x[:, t] for n, x in
                                zip(self.conf.inputs, xs)}
                        for name in self.conf.topo_order:
                            node = self.conf.nodes[name]
                            vals = [acts[i] for i in node.inputs]
                            if not isinstance(node.op, Layer):
                                acts[name] = node.op.apply(vals)
                                continue
                            h = vals if getattr(node.op, "multi_input",
                                                False) else vals[0]
                            if name in self._preprocessors:
                                h = self._preprocessors[name](h)
                            if isinstance(unwrap(node.op), BaseRecurrent):
                                h, cs[name] = unwrap(node.op).step_apply(
                                    self.params[name], cs[name], h,
                                    Ctx(train=False))
                            else:
                                h, _ = node.op.apply(
                                    self.params[name], self.states[name], h,
                                    Ctx(train=False))
                            acts[name] = h
                        ys.append([acts[o] for o in self.conf.outputs])
                outs = [torch.stack([y[i] for y in ys], dim=1)
                        for i in range(len(self.conf.outputs))]
                return tuple(outs) + tuple(tensors([cs[n] for n in names]))
            self._rnn_stream_fn = CompiledStep(
                stream, lambda: tensors((self.params, self.states)),
                "ComputationGraph.rnn_time_step")
        return self._rnn_stream_fn

    def rnn_clear_previous_state(self):
        """Reference rnnClearPreviousState: drop all streaming state."""
        self._rnn_carries = None
        self._rnn_carry_batch = None

    # ----------------------------------------------------------------- loss
    def _loss(self, params, states, inputs, labels, rng, fmask, lmask,
              groups=_dist.NONE):
        """(loss, new states); under a parallel step's ``groups`` this
        rank's share of the global batch's loss."""
        labels = self._as_label_dict(labels)
        group = groups.batch
        acts, pre_acts, new_states = self._forward(
            params, states, inputs, train=True, rng=rng, fmask=fmask,
            lmask=lmask, stop_at_output_preact=True, groups=groups)
        total = 0.0
        for name in self.conf.outputs:
            op = unwrap(self.conf.nodes[name].op)
            y = labels[name]
            w = self.output_loss_weights.get(name, 1.0)
            if isinstance(op, OutputLayer):
                total = total + w * op.compute_loss(
                    params[name], pre_acts[name], y, mask=lmask,
                    groups=groups)
            elif isinstance(op, SameDiffOutputLayer):
                total = total + w * _dist.share(op.compute_loss(
                    params[name], pre_acts[name], y, mask=lmask), group)
            elif isinstance(op, LossLayer):
                total = total + w * op.compute_loss(
                    pre_acts[name], y, mask=lmask, groups=groups)
            else:
                raise ValueError(
                    f"output node '{name}' is not an output/loss layer")
        total = total + self._reg_score(params, group)
        return total, new_states

    def _reg_score(self, params, group=None):
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
        return _dist.share(reg, group)

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
        if self._restored_opt_state is not None:
            from ..serde.model_serializer import restore_updater_
            restore_updater_(self._opt_state, self._restored_opt_state)
            self._restored_opt_state = None

    def _apply_constraints(self):
        """Each unfrozen layer node's constraints, in place."""
        for name, node in self.conf.nodes.items():
            op = node.op
            if not isinstance(op, Layer) or op.frozen:
                continue
            apply_constraints_(self.params[name], op.constraints,
                               weights=True)
            apply_constraints_(self.params[name], op.bias_constraints,
                               weights=False, biases=True)

    def _train_step(self, inputs, labels, fmask, lmask):
        """The static step: one batch, the params, the updater's state and
        the running states updated in place. Returns the loss (0-d), and
        the grad stats with a detector attached."""
        leaves = tree_leaves(self.params)
        loss, new_states = self._loss(self.params, self.states, inputs,
                                      labels, self._gen, fmask, lmask)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        gtree = _unflatten(self.params, iter(
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)))
        return _update_in_place(self, loss, new_states, gtree)

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
                lambda: tensors((self.params, self.states, self._opt_state))
                + [self._gen], "ComputationGraph",
                eager=self._needs_host())
        return self._step_fn

    def _train_sentinel(self):
        """The compile sentinel ``cg_train_step`` around
        :meth:`_compiled_step` (made anew with it): ``fit`` and
        ``fit_scanned`` call the step through it."""
        step = self._compiled_step()
        if self._sentinel is None or self._sentinel._fn is not step:
            self._sentinel = CompileSentinel("cg_train_step", step)
        return self._sentinel

    def enable_gradient_anomaly_detection(self, detector=None):
        """See ``MultiLayerNetwork.enable_gradient_anomaly_detection``."""
        from ..train.anomaly import GradientAnomalyDetector
        self._anomaly_detector = None if detector is False else \
            (detector or GradientAnomalyDetector())
        self._step_fn = None
        return self

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
        # one (K, B, ...) tensor per input, then per output
        cols = [[fs[i] for fs, _ in pairs] for i in range(len(pairs[0][0]))] \
            + [[ls[i] for _, ls in pairs] for i in range(len(pairs[0][1]))]
        stacked = [torch.stack([self._to_device(a) for a in col])
                   for col in cols]
        self._last_batch_size = int(stacked[0].shape[1])
        step = self._train_sentinel()
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
        step = self._train_sentinel()

        def step_batch(ds):
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
            # examples-throughput telemetry (MetricsListener)
            self._last_batch_size = int(feats[0].shape[0])
            return step(*(self._to_device(a) for a in (*feats, *labs)),
                        fm, lm)
        return fit_epochs(self, iterator, epochs, step_batch)

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
        """Classification metrics of the first output over ``iterator``,
        accumulated on the device (reference: ``preds[0]`` of a
        multi-output graph; no label mask)."""
        from ..eval.classification import Evaluation
        ev = Evaluation(top_n=top_n)
        for ds in iterator:
            preds = self.output(ds.features)
            if isinstance(preds, list):
                preds = preds[0]
            ev.eval(self._to_device(ds.labels), preds)
        if hasattr(iterator, "reset"):
            iterator.reset()
        return ev

    def set_listeners(self, *listeners):
        self.listeners = list(listeners)

    def add_listeners(self, *listeners):
        self.listeners.extend(listeners)

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
        """A copy on the same device (reference clone()): config deep-
        copied, params and states real copies, its own compiled steps and
        generator, loss weights and ``remat_segments`` copied; no updater
        state."""
        import copy
        net = ComputationGraph(copy.deepcopy(self.conf))
        if self.initialized:
            net._bind_device(self.device)
            net.params = _copy_params(self.params)
            net.states = tree_map(lambda t: t.detach().clone(), self.states)
            net._preprocessors = dict(self._preprocessors)
            net.output_shapes = dict(self.output_shapes)
            net._init_shapes = list(self._init_shapes)
            net.initialized = True
        # execution policy and loss weighting are config-level: copied
        # for an uninitialized graph too (the reference's clone)
        net.remat_segments = self.remat_segments
        net.output_loss_weights = dict(self.output_loss_weights)
        return net

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

    def save(self, path, save_updater: bool = False, normalizer=None):
        from ..serde.model_serializer import save_model
        save_model(self, path, save_updater=save_updater,
                   normalizer=normalizer)

    @staticmethod
    def load(path, device=None):
        from ..serde.model_serializer import load_model
        return load_model(path, device=device)
