"""MultiLayerNetwork — port of ``deeplearning4j_tpu/nn/multi_layer_network.py``
(the sequential network: init / fit / fit_scanned / output / evaluate /
score / save / load / clone / rnn_time_step).

The layer stack runs on one device. A train step (:meth:`_train_step`,
the static step of ``nn/_compiled.py``) updates everything in place:

1. the loss (output head and L1/L2 terms), with ``torch.autograd.grad``
   on the leaves of ``params``; input dropout and weight noise draw from
   the net's generator (``_gen``, on the net's device);
2. with a gradient-anomaly detector, the per-layer grad stats, and a copy
   of params, updater state and running states to gate on
   (``train/anomaly.py``);
3. the in-place updater (``train/updaters.py``) under ``no_grad``, its
   updates added to the params with one ``_foreach_add_`` per dtype, then
   the weight constraints (``train/constraints.py``);
4. the new running states copied into ``states``, and the gate: a step
   with a non-finite gradient puts everything back.

``fit`` and ``fit_scanned`` run it through a :class:`CompiledStep`: on
CUDA each batch signature's first step is eager, its second is captured
as a CUDA graph, and later steps replay it (``disable_graphs()`` keeps
every step eager); on the CPU the step is called directly, inside the
compile sentinel ``mln_train_step`` (``obs.compiles``: a capture, or a
new signature of a direct call, counts as a compile). The generator
is registered with each graph, so every replay draws new masks. ``fit``
reports steps to the listeners one step late where they allow it
(``nn/_fit_loop.py``). ``output()`` (and ``evaluate*`` over it) is a
compiled step of its own, one graph per input signature.

``device=None`` means the CUDA card (``_device.resolve_device``); only an
explicit ``"cpu"`` runs on the host. Params and states are nested dicts
``layer_{i}`` of tensors in the reference's layout, so
``nn.params_from_numpy`` takes the JAX net's ``net.params`` /
``net.states`` as numpy trees.

A layer's Python attributes (``fused``, ``dropout``, …) are baked into a
captured graph: after changing one, drop the graphs (``net._step_fn`` and
``net._infer_fn``'s ``reset()``).

``remat_segments = n`` runs the train-time forward as n even chunks of
the layer list, each under ``nn/_remat.py``'s checkpoint (loss, grads,
states and dropout draws equal the monolithic walk's); ``fit`` prefetches
a ``BaseDatasetIterator`` through ``data/async_iter.py``
(``nn/_fit_loop.py``).
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from .. import _dist
from .._device import resolve_device, tree_to
from ..train.anomaly import gate_, grad_stats, save_for_gate
from ..train.constraints import apply_constraints_
from ..train.updaters import (NoOp, apply_updates, build_optimizer,
                              tree_leaves, tree_map)
from ..obs.compiles import CompileSentinel
from ._compiled import CompiledStep, copy_into, tensors
from ._fit_loop import fit_epochs
from ._remat import checkpoint_segment
from ._scan_common import check_scan_listeners, replay_scan_listeners
from .conf import MultiLayerConfiguration
from .layers.base import Ctx, Layer
from .layers.core import (CenterLossOutputLayer, DenseLayer,
                          ElementWiseMultiplicationLayer, LossLayer,
                          OCNNOutputLayer, OutputLayer, dropout_apply,
                          keep_mask)
from .layers.recurrent import (BaseRecurrent, Bidirectional, LastTimeStep,
                               TimeDistributed)
from .layers.samediff_layer import SameDiffOutputLayer, needs_host
from .layers.wrappers import unwrap
from .preprocessors import CnnToFeedForwardPreProcessor
from .weightnoise import maybe_apply_weight_noise


def _is_ff_layer(layer: Layer) -> bool:
    """The reference's ``_is_ff_layer``: a dense-like layer under any
    wrappers (output heads included: they are DenseLayers)."""
    return isinstance(unwrap(layer), (DenseLayer,
                                      ElementWiseMultiplicationLayer))


def _unflatten(like, leaves):
    """Nested dicts and lists shaped like ``like`` from an iterator over
    leaves in ``tree_leaves`` order (sorted keys)."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, list):
        return [_unflatten(v, leaves) for v in like]
    return next(leaves)


class MultiLayerNetwork:
    def __init__(self, conf: MultiLayerConfiguration):
        self.conf = conf
        self.layers: List[Layer] = conf.layers
        self._g = conf.globals_
        self.params: Dict[str, dict] = {}
        self.states: Dict[str, dict] = {}
        self._preprocessors: Dict[int, Any] = {}
        self._optimizer = None
        self._opt_state = None
        self._iters_per_epoch = 1
        self._step_count = 0
        self.epoch_count = 0
        self.listeners: List[Any] = []
        self.initialized = False
        self.device = None
        self._gen = None
        self._remat_segments = None
        self._rnn_carries = None
        self._rnn_carry_batch = None
        self._step_fn = None
        self._sentinel = None
        self._infer_fn = None
        self._anomaly_detector = None
        self._restored_opt_state = None

    @property
    def remat_segments(self):
        return self._remat_segments

    @remat_segments.setter
    def remat_segments(self, n):
        """Changing the remat policy drops every compiled step that ran
        the old forward."""
        if self._remat_segments != n:
            self._step_fn = None
            self._sentinel = None
            self._infer_fn = None
        self._remat_segments = n

    # ------------------------------------------------------------------ init
    def init(self, input_shape=None, device=None):
        """Resolve shapes layer by layer and draw every layer's params on
        the host from a generator seeded with the configuration's seed,
        then move them to ``device`` (None → CUDA)."""
        self._bind_device(resolve_device(device))
        if input_shape is None:
            if self.conf.input_type is not None:
                input_shape = tuple(self.conf.input_type[1])
            else:
                n_in = getattr(unwrap(self.layers[0]), "n_in", None)
                if not n_in:
                    raise ValueError("Provide input_shape or set_input_type "
                                     "on the config")
                input_shape = (int(n_in),)
        gen = torch.Generator().manual_seed(self._g.seed)
        shape = tuple(input_shape)
        self._init_input_shape = shape
        for i, layer in enumerate(self.layers):
            # conv activations into a flat feed-forward layer (the
            # reference's second, OutputLayer-only test never fires: an
            # OutputLayer is a DenseLayer, flattened here already)
            if _is_ff_layer(layer) and len(shape) in (3, 4):
                pp = CnnToFeedForwardPreProcessor()
                self._preprocessors[i] = pp
                shape = pp.out_shape(shape)
            p, s, shape = layer.init(gen, shape)
            self.params[f"layer_{i}"] = tree_map(
                lambda t: t.to(self.device).requires_grad_(
                    t.is_floating_point()), p)
            self.states[f"layer_{i}"] = tree_to(s, self.device)
        self.output_shape = shape
        self.initialized = True
        return self

    def _bind_device(self, device):
        """Live on ``device``, with the train step's generator there (a
        CPU generator cannot draw a CUDA tensor), seeded from the
        configuration's seed."""
        self.device = device
        self._gen = torch.Generator(device=device).manual_seed(self._g.seed)

    # -------------------------------------------------------------- forward
    def _apply_one(self, i, params, states, h, new_states, *, train, rng,
                   fmask, lmask, stop_before_output, groups=_dist.NONE):
        """Apply layer ``i`` to ``h``; returns (h, stopped)."""
        layer = self.layers[i]
        key = f"layer_{i}"
        if stop_before_output and i == len(self.layers) - 1 and \
                isinstance(unwrap(layer), (OutputLayer, LossLayer,
                                           OCNNOutputLayer,
                                           SameDiffOutputLayer)):
            new_states[key] = states[key]
            return h, True
        if i in self._preprocessors:
            h = self._preprocessors[i](h)
        p_i = params[key]
        if train and rng is not None:
            if layer.dropout > 0.0:
                keep = 1.0 - layer.dropout
                h = dropout_apply(h, keep_mask(h.shape, keep, rng, h.device),
                                  keep)
            p_i = maybe_apply_weight_noise(layer, p_i, rng, train)
        ctx = Ctx(train=train, rng=rng, mask=fmask, label_mask=lmask,
                  groups=groups)
        h, new_states[key] = layer.apply(p_i, states[key], h, ctx)
        return h, False

    def _forward(self, params, states, x, *, train, rng, fmask=None,
                 lmask=None, stop_before_output=False, groups=_dist.NONE):
        """Returns (activation, new_states). ``groups``: a parallel
        step's (``_dist.Groups``), handed to every layer's ``Ctx``."""
        if train and self.remat_segments:
            return self._forward_remat(
                params, states, x, train=train, rng=rng, fmask=fmask,
                lmask=lmask, stop_before_output=stop_before_output,
                groups=groups)
        new_states = {}
        h = x
        for i in range(len(self.layers)):
            h, stopped = self._apply_one(
                i, params, states, h, new_states, train=train, rng=rng,
                fmask=fmask, lmask=lmask,
                stop_before_output=stop_before_output, groups=groups)
            if stopped:
                break
        return h, new_states

    def _forward_remat(self, params, states, x, *, train, rng, fmask=None,
                       lmask=None, stop_before_output=False,
                       groups=_dist.NONE):
        """:meth:`_forward` with contiguous layer chunks under
        ``checkpoint_segment``: only chunk-boundary activations are kept
        for the backward. The sequential counterpart of
        ``ComputationGraph._forward_remat`` (one carried tensor, so the
        plan is an even index split)."""
        n = len(self.layers)
        if int(self.remat_segments) > n:
            import warnings
            warnings.warn(
                f"remat_segments={int(self.remat_segments)} exceeds what "
                f"this {n}-layer net supports; using {n} checkpoint "
                "segments (activation footprint will be larger than "
                "configured)", stacklevel=3)
        nseg = max(1, min(int(self.remat_segments), n))
        bounds = [round(k * n / nseg) for k in range(nseg + 1)]
        h = x
        new_states = {}
        for a, b in zip(bounds[:-1], bounds[1:]):
            if a == b:
                continue

            def seg_fn(hh, _a=a, _b=b):
                ns = {}
                for i in range(_a, _b):
                    hh, stopped = self._apply_one(
                        i, params, states, hh, ns, train=train, rng=rng,
                        fmask=fmask, lmask=lmask,
                        stop_before_output=stop_before_output,
                        groups=groups)
                    if stopped:
                        break
                return hh, ns

            h, ns = checkpoint_segment(seg_fn, h)
            new_states.update(ns)
        return h, new_states

    def _to_device(self, x):
        return None if x is None else torch.as_tensor(x, device=self.device)

    def _infer_step(self):
        """The compiled inference forward (the reference's ``jax.jit``-ed
        ``_get_infer_fn``): one CUDA graph per input signature, a fresh
        output tensor a call."""
        if self._infer_fn is None:
            def infer(x):
                with torch.no_grad():
                    y, _ = self._forward(self.params, self.states, x,
                                         train=False, rng=None)
                return y
            self._infer_fn = CompiledStep(
                infer, lambda: tensors((self.params, self.states)),
                "MultiLayerNetwork.output", eager=needs_host(self.layers))
        return self._infer_fn

    def output(self, x, train: bool = False):
        """Inference forward on the net's device (reference output())."""
        return self._infer_step()(self._to_device(x))

    def feed_forward(self, x, train: bool = False):
        """Per-layer activations list (reference feedForward())."""
        h = self._to_device(x)
        acts = [h]
        with torch.no_grad():
            for i, layer in enumerate(self.layers):
                if i in self._preprocessors:
                    h = self._preprocessors[i](h)
                h, _ = layer.apply(self.params[f"layer_{i}"],
                                   self.states[f"layer_{i}"], h,
                                   Ctx(train=train))
                acts.append(h)
        return acts

    # ----------------------------------------------------------------- loss
    def _loss(self, params, states, x, y, rng, fmask, lmask,
              groups=_dist.NONE):
        """(loss, new states); under a parallel step's ``groups`` this
        rank's share of the global batch's loss."""
        h, new_states = self._forward(params, states, x, train=True, rng=rng,
                                      fmask=fmask, lmask=lmask,
                                      stop_before_output=True, groups=groups)
        i = len(self.layers) - 1
        return self._loss_tail(unwrap(self.layers[i]), i, params, new_states,
                               h, y, lmask, groups)

    def _loss_tail(self, out_layer, i, params, new_states, h, y, lmask,
                   groups=_dist.NONE):
        """The output layer's loss. The forward stopped before it, so
        ``new_states`` still holds its old state, which the heads with a
        running state (center loss, OCNN) read and replace. ``groups``: a
        parallel step's."""
        group = groups.batch
        key = f"layer_{i}"
        if isinstance(out_layer, (OutputLayer, OCNNOutputLayer)) and \
                i in self._preprocessors:
            h = self._preprocessors[i](h)
        if isinstance(out_layer, CenterLossOutputLayer):
            loss = out_layer.compute_loss(params[key], h, y, mask=lmask,
                                          state=new_states[key],
                                          groups=groups)
            new_states[key] = out_layer.update_state(new_states[key],
                                                     h.detach(), y)
        elif isinstance(out_layer, OutputLayer):
            loss = out_layer.compute_loss(params[key], h, y, mask=lmask,
                                          groups=groups)
        elif isinstance(out_layer, SameDiffOutputLayer):
            loss = _dist.share(out_layer.compute_loss(params[key], h, y,
                                                      mask=lmask), group)
        elif isinstance(out_layer, OCNNOutputLayer):
            loss = _dist.share(out_layer.compute_loss(
                params[key], h, y, mask=lmask, state=new_states[key]), group)
            new_states[key] = out_layer.update_state(new_states[key], h,
                                                     params[key])
        elif isinstance(out_layer, LossLayer):
            loss = out_layer.compute_loss(h, y, mask=lmask, groups=groups)
        else:
            raise ValueError("Last layer must be an OutputLayer or LossLayer "
                             "for fit()")
        return loss + self._reg_score(params, group), new_states

    def _reg_score(self, params, group=None):
        reg = 0.0
        for i, layer in enumerate(self.layers):
            if layer.l1 == 0.0 and layer.l2 == 0.0:
                continue
            for k, w in params[f"layer_{i}"].items():
                if k in ("b", "beta", "mean", "var"):
                    continue
                if layer.l1:
                    reg = reg + layer.l1 * torch.sum(torch.abs(w))
                if layer.l2:
                    reg = reg + 0.5 * layer.l2 * torch.sum(torch.square(w))
        return _dist.share(reg, group)

    # ------------------------------------------------------------ optimizer
    def _param_labels(self):
        labels = {}
        has_override = False
        for i, layer in enumerate(self.layers):
            if layer.frozen:
                lab = "__frozen__"
                has_override = True
            elif layer.updater is not None:
                lab = f"__layer_{i}__"
                has_override = True
            else:
                lab = "__default__"
            labels[f"layer_{i}"] = tree_map(lambda _, lab=lab: lab,
                                            self.params[f"layer_{i}"])
        return labels if has_override else None

    def _build_optimizer(self, iters_per_epoch=1):
        g = self._g
        labels = self._param_labels()
        per_label = None
        if labels is not None:
            per_label = {"__default__": g.updater, "__frozen__": NoOp()}
            for i, layer in enumerate(self.layers):
                if layer.updater is not None and not layer.frozen:
                    per_label[f"__layer_{i}__"] = layer.updater
        # L1/L2 live in the loss (_reg_score), not in the optimizer chain
        self._optimizer = build_optimizer(
            g.updater, grad_norm=g.grad_norm,
            grad_norm_threshold=g.grad_norm_threshold,
            iters_per_epoch=iters_per_epoch, param_labels=labels,
            per_label_updaters=per_label)
        with torch.no_grad():
            self._opt_state = self._optimizer.init(self.params)
        if self._restored_opt_state is not None:
            from ..serde.model_serializer import restore_updater_
            restore_updater_(self._opt_state, self._restored_opt_state)
            self._restored_opt_state = None

    def _apply_constraints(self):
        """Each unfrozen layer's constraints, in place (reference
        ``_apply_constraints``; frozen params stay bit-identical)."""
        for i, layer in enumerate(self.layers):
            if layer.frozen:
                continue
            apply_constraints_(self.params[f"layer_{i}"], layer.constraints,
                               weights=True)
            apply_constraints_(self.params[f"layer_{i}"],
                               layer.bias_constraints, weights=False,
                               biases=True)

    def _grads(self, x, y, fmask, lmask, rng=None):
        """(loss, new_states, grads tree) of one batch; ``rng`` drives
        dropout and weight noise (None: none)."""
        leaves = tree_leaves(self.params)
        loss, new_states = self._loss(self.params, self.states, x, y,
                                      rng, fmask, lmask)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        gtree = _unflatten(self.params, iter(
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)))
        return loss, new_states, gtree

    def _train_step(self, x, y, fmask, lmask):
        """The static step: one batch, the params, the updater's state and
        the running states updated in place. Returns the loss (0-d), and
        the grad stats with a detector attached."""
        loss, new_states, grads = self._grads(x, y, fmask, lmask, self._gen)
        return _update_in_place(self, loss, new_states, grads)

    def _compiled_step(self):
        """The net's :class:`CompiledStep` over :meth:`_train_step`; its
        bindings include the generator, which each graph registers."""
        if self._step_fn is None:
            self._step_fn = CompiledStep(
                self._train_step,
                lambda: tensors((self.params, self.states, self._opt_state))
                + [self._gen], "MultiLayerNetwork",
                eager=needs_host(self.layers))
        return self._step_fn

    def _train_sentinel(self):
        """The compile sentinel ``mln_train_step`` around
        :meth:`_compiled_step` (made anew with it): ``fit`` and
        ``fit_scanned`` call the step through it."""
        step = self._compiled_step()
        if self._sentinel is None or self._sentinel._fn is not step:
            self._sentinel = CompileSentinel("mln_train_step", step)
        return self._sentinel

    def enable_gradient_anomaly_detection(self, detector=None):
        """Per-layer gradient stats computed inside the train step and
        checked on the host one step late; a non-finite step is a no-op.
        Pass a ``train.anomaly.GradientAnomalyDetector`` (None: defaults)
        or False to disable. Drops the compiled step's graphs."""
        from ..train.anomaly import GradientAnomalyDetector
        self._anomaly_detector = None if detector is False else \
            (detector or GradientAnomalyDetector())
        self._step_fn = None
        return self

    # ------------------------------------------------------------------ fit
    def fit(self, data, labels=None, *, epochs: int = 1, device=None):
        """fit(DataSetIterator) | fit(DataSet) | fit(features, labels). An
        uninitialized net is initialized from the first batch's shapes on
        ``device`` (None → CUDA); an initialized one trains where it lives.
        Returns the last loss as a float."""
        from ..data.dataset import DataSet
        if labels is not None:
            data = DataSet(data, labels)
        iterator = [data] if isinstance(data, DataSet) else data
        if not self.initialized:
            first = next(iter(iterator))
            self.init(tuple(first.features.shape[1:]), device=device)
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
            self._iters_per_epoch = max(int(ipe), 1)
            self._build_optimizer(self._iters_per_epoch)
        step = self._train_sentinel()

        def step_batch(ds):
            x = self._to_device(ds.features)
            self._last_batch_size = int(x.shape[0])
            return step(x, self._to_device(ds.labels),
                        self._to_device(ds.features_mask),
                        self._to_device(ds.labels_mask))
        last = fit_epochs(self, iterator, epochs, step_batch)
        return None if last is None else float(last)

    def fit_scanned(self, data, *, epochs: int = 1):
        """The reference's epoch loop in one dispatch
        (``multi_layer_network.py:538``), here one replay of the compiled
        step a batch: the epoch's batches are stacked once on the device,
        each step is fed by a device-to-device copy into the graph's
        inputs, and the epoch's losses are gathered in one tensor and
        fetched once, after its last step. The trajectory is ``fit``'s,
        bit for bit. Batches must be equally shaped and mask-free, and
        every listener must take deferred scores (``deferred_score_ok``):
        they are replayed from the losses after the epoch. Returns the
        last loss as a float."""
        from ..data.dataset import DataSet
        batches = [data] if isinstance(data, DataSet) else list(data)
        if not batches:
            return None
        if any(b.features_mask is not None or b.labels_mask is not None
               for b in batches):
            raise ValueError("fit_scanned does not support masked batches; "
                             "use fit()")
        shapes = {(tuple(b.features.shape), tuple(b.labels.shape))
                  for b in batches}
        if len(shapes) > 1:
            raise ValueError(f"fit_scanned needs equally-shaped batches, "
                             f"got {sorted(shapes)}; use fit()")
        check_scan_listeners(self)
        if not self.initialized:
            self.init(tuple(batches[0].features.shape[1:]))
        if self._optimizer is None:
            self._iters_per_epoch = len(batches)
            self._build_optimizer(self._iters_per_epoch)
        xs = torch.stack([self._to_device(b.features) for b in batches])
        ys = torch.stack([self._to_device(b.labels) for b in batches])
        self._last_batch_size = int(xs.shape[1])
        step = self._train_sentinel()
        losses = None
        for _ in range(epochs):
            losses = torch.stack([step(xs[i], ys[i], None, None)
                                  for i in range(len(batches))])
            self._step_count += len(batches)
            self.epoch_count += 1
            replay_scan_listeners(self, losses, len(batches))
        return float(losses[-1])

    # ---------------------------------------------------------------- score
    def score(self, dataset=None):
        """Loss (incl. regularization) on a DataSet (reference score())."""
        if dataset is None:
            raise ValueError("score() requires a DataSet")
        with torch.no_grad():
            loss, _ = self._loss(
                self.params, self.states, self._to_device(dataset.features),
                self._to_device(dataset.labels), None,
                self._to_device(dataset.features_mask),
                self._to_device(dataset.labels_mask))
        return float(loss)

    def gradient_and_score(self, dataset):
        """(gradients tree, score) — reference computeGradientAndScore()."""
        loss, _, grads = self._grads(self._to_device(dataset.features),
                                     self._to_device(dataset.labels), None,
                                     None)
        return grads, float(loss.detach())

    # ------------------------------------------------------------- evaluate
    def _evaluate(self, ev, iterator, masked=True):
        """Accumulate ``ev`` over ``iterator``'s batches on the device:
        the compiled ``output()`` per batch, no host read per batch."""
        for ds in iterator:
            preds = self.output(ds.features)
            mask = self._to_device(ds.labels_mask) if masked else None
            ev.eval(self._to_device(ds.labels), preds, mask=mask)
        if hasattr(iterator, "reset"):
            iterator.reset()
        return ev

    def evaluate(self, iterator, top_n: int = 1):
        from ..eval.classification import Evaluation
        return self._evaluate(Evaluation(top_n=top_n), iterator)

    def evaluate_regression(self, iterator):
        from ..eval.regression import RegressionEvaluation
        return self._evaluate(RegressionEvaluation(), iterator, masked=False)

    def evaluate_roc(self, iterator, threshold_steps: int = 0):
        from ..eval.roc import ROC
        return self._evaluate(ROC(threshold_steps), iterator, masked=False)

    # ------------------------------------------------- streaming inference
    def rnn_time_step(self, x):
        """Stateful streaming inference (reference rnnTimeStep): feed one
        step (B, C) or a chunk (B, T, C); every recurrent layer's state
        persists across calls until rnn_clear_previous_state(). Each step
        runs the layers' single-step ``step_apply`` (not K4)."""
        for layer in self.layers:
            if isinstance(unwrap(layer), (Bidirectional, LastTimeStep,
                                          TimeDistributed)):
                raise NotImplementedError(
                    f"rnn_time_step cannot stream through "
                    f"{type(unwrap(layer)).__name__}: it needs the full "
                    "sequence "
                    "(reference rnnTimeStep has the same limit)")
        x = self._to_device(x)
        single = x.dim() == 2
        if single:
            x = x[:, None, :]
        batch = x.shape[0]
        old = self._rnn_carries or {}
        if self._rnn_carry_batch != batch:
            old = {}                   # batch changed: stale state is void
        carries = {}
        for i, layer in enumerate(self.layers):
            ul = unwrap(layer)
            if isinstance(ul, BaseRecurrent):
                c = old.get(f"layer_{i}")
                # the carry dtype is what the cell emits: the post-cast
                # compute dtype
                carries[f"layer_{i}"] = c if c is not None else \
                    ul.init_carry(batch, ul.compute_dtype or x.dtype,
                                  self.device)
        ys = []
        with torch.no_grad():
            for t in range(x.shape[1]):
                h = x[:, t]
                for i, layer in enumerate(self.layers):
                    key = f"layer_{i}"
                    if i in self._preprocessors:
                        h = self._preprocessors[i](h)
                    if isinstance(unwrap(layer), BaseRecurrent):
                        h, carries[key] = unwrap(layer).step_apply(
                            self.params[key], carries[key], h,
                            Ctx(train=False))
                    else:
                        h, _ = layer.apply(self.params[key], self.states[key],
                                           h, Ctx(train=False))
                ys.append(h)
        self._rnn_carries = carries
        self._rnn_carry_batch = batch
        y = torch.stack(ys, dim=1)
        return y[:, 0] if single else y

    def rnn_clear_previous_state(self):
        """Reference rnnClearPreviousState: drop all streaming state."""
        self._rnn_carries = None
        self._rnn_carry_batch = None

    def rnn_get_previous_state(self, layer_idx: int):
        return (self._rnn_carries or {}).get(f"layer_{layer_idx}")

    def rnn_set_previous_state(self, layer_idx: int, state):
        carries = dict(self._rnn_carries or {})
        if isinstance(state, (tuple, list)):
            state = tuple(self._to_device(s) for s in state)
            batch = state[0].shape[0]
        else:
            state = self._to_device(state)
            batch = state.shape[0]
        carries[f"layer_{layer_idx}"] = state
        self._rnn_carries = carries
        # the injected state's batch, so the next rnn_time_step keeps it
        self._rnn_carry_batch = batch

    def set_listeners(self, *listeners):
        self.listeners = list(listeners)

    def add_listeners(self, *listeners):
        self.listeners.extend(listeners)

    # ----------------------------------------------------------- params API
    def num_params(self) -> int:
        return sum(int(p.numel()) for p in tree_leaves(self.params))

    def get_param(self, layer_idx: int, name: str):
        return self.params[f"layer_{layer_idx}"][name]

    def set_param(self, layer_idx: int, name: str, value):
        old = self.params[f"layer_{layer_idx}"][name]
        new = torch.as_tensor(value, dtype=old.dtype, device=self.device)
        self.params[f"layer_{layer_idx}"][name] = \
            new.detach().clone().requires_grad_(new.is_floating_point())

    def params_flat(self):
        """Single flat vector in the reference's order (sorted keys, as
        jax.tree_util flattens a dict)."""
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
        """A copy on the same device (reference clone()): the config deep-
        copied, params and states real copies, its own compiled steps and
        generator, and ``remat_segments``; the updater state is not copied
        (the reference's)."""
        import copy
        net = MultiLayerNetwork(copy.deepcopy(self.conf))
        if self.initialized:
            net._bind_device(self.device)
            net.params = _copy_params(self.params)
            net.states = tree_map(lambda t: t.detach().clone(), self.states)
            net._preprocessors = dict(self._preprocessors)
            net._init_input_shape = self._init_input_shape
            net.output_shape = self.output_shape
            net.initialized = True
        net.remat_segments = self.remat_segments
        return net

    def summary(self) -> str:
        lines = ["=" * 72,
                 f"{'LayerName (idx)':<28}{'Output Shape':<20}"
                 f"{'Param Count':<12}",
                 "=" * 72]
        total = 0
        for i, layer in enumerate(self.layers):
            n = sum(int(v.numel())
                    for v in tree_leaves(self.params.get(f"layer_{i}", {})))
            total += n
            name = layer.name or type(layer).__name__
            lines.append(f"{name + f' ({i})':<28}{'-':<20}{n:<12}")
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


def _copy_params(params):
    """Real copies of a params tree, float leaves requiring grad."""
    return tree_map(lambda t: t.detach().clone().requires_grad_(
        t.is_floating_point()), params)


def _update_in_place(net, loss, new_states, grads):
    """The update half of both nets' static step (see the module
    docstring): grad stats and the gate's copy when a detector is
    attached, the updater, the constraints, the running states, the gate.
    Returns the loss, or (loss, stats) with a detector."""
    det = net._anomaly_detector
    trees = (net.params, net.states, net._opt_state)
    with torch.no_grad():
        stats = saved = None
        if det is not None:
            stats = grad_stats(grads)
            if det.gate_updates:
                saved = save_for_gate(trees)
        updates, _ = net._optimizer.update(grads, net._opt_state, net.params)
        apply_updates(tree_leaves(net.params), tree_leaves(updates))
        net._apply_constraints()
        copy_into(net.states, new_states)
        if saved is not None:
            gate_(stats, trees, saved)
    return loss.detach() if det is None else (loss.detach(), stats)
