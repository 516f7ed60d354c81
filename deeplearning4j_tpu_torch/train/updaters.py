"""Updaters — port of ``deeplearning4j_tpu/train/updaters.py``.

The reference builds optax chains. Here each updater is the same config
dataclass, and ``to_transform()`` gives a functional
:class:`GradientTransformation`: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)`` over nested dicts of
tensors, with optax's semantics, not ``torch.optim``'s: ``Sgd`` scales by
−lr; ``Momentum``/``Nesterovs`` keep optax's trace ``v = g + m·v``
(v₀ = 0); ``Adam`` keeps eps outside the square root; ``AdamW`` adds
``wd·p`` to the Adam direction before the −lr scale. Updates are applied
by the caller (``p += u``). :func:`build_optimizer` composes
gradient normalization → L2 → L1 → weight decay → the updater (or a
per-label ``multi_transform``), as the reference does.

Not ported yet (raise): learning-rate ``Schedule`` objects, AMSGrad,
Nadam, AdaMax, AdaDelta, AdaGrad, RmsProp, Lion, Lamb.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


# ------------------------------------------------------------ tree helpers

def tree_map(fn, tree, *rest):
    """Map over the tensor leaves of nested dicts (``rest`` alike)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _zeros_like(tree, dtype=None):
    return tree_map(lambda p: torch.zeros_like(p, dtype=dtype), tree)


# --------------------------------------------------------------- transforms

def identity() -> GradientTransformation:
    return GradientTransformation(lambda params: (),
                                  lambda u, state, params=None: (u, state))


def scale(step_size: float) -> GradientTransformation:
    def update(u, state, params=None):
        return tree_map(lambda g: step_size * g, u), state
    return GradientTransformation(lambda params: (), update)


def scale_by_learning_rate(lr) -> GradientTransformation:
    if not isinstance(lr, (int, float)):
        raise NotImplementedError(
            "learning-rate schedules (deeplearning4j_tpu/train/schedules.py "
            "resolve) are not ported yet; pass a number")
    return scale(-lr)


def trace(decay: float, nesterov: bool = False,
          accumulator_dtype=None) -> GradientTransformation:
    """optax.trace: t ← g + decay·t; the update is t (or g + decay·t with
    Nesterov)."""
    def init(params):
        return {"trace": _zeros_like(params, accumulator_dtype)}

    def update(u, state, params=None):
        f = lambda g, t: g + decay * t  # noqa: E731
        new_trace = tree_map(f, u, state["trace"])
        out = tree_map(f, u, new_trace) if nesterov else new_trace
        if accumulator_dtype is not None:
            new_trace = tree_map(lambda t: t.to(accumulator_dtype), new_trace)
        return out, {"trace": new_trace}
    return GradientTransformation(init, update)


def scale_by_adam(b1=0.9, b2=0.999, eps=1e-8) -> GradientTransformation:
    """optax.scale_by_adam (eps_root 0): bias-corrected m / (sqrt(v) + eps)."""
    def init(params):
        return {"count": 0, "mu": _zeros_like(params),
                "nu": _zeros_like(params)}

    def update(u, state, params=None):
        mu = tree_map(lambda g, t: (1 - b1) * g + b1 * t, u, state["mu"])
        nu = tree_map(lambda g, t: (1 - b2) * (g ** 2) + b2 * t, u,
                      state["nu"])
        count = state["count"] + 1
        c1 = 1 - torch.tensor(b1, dtype=torch.float32) ** count
        c2 = 1 - torch.tensor(b2, dtype=torch.float32) ** count
        out = tree_map(lambda m, v: (m / c1.to(m.device, m.dtype))
                       / (torch.sqrt(v / c2.to(v.device, v.dtype)) + eps),
                       mu, nu)
        return out, {"count": count, "mu": mu, "nu": nu}
    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(u, state, params=None):
        return tree_map(lambda g, p: g + weight_decay * p, u, params), state
    return GradientTransformation(lambda params: (), update)


def set_to_zero() -> GradientTransformation:
    return GradientTransformation(
        lambda params: (),
        lambda u, state, params=None: (tree_map(torch.zeros_like, u), state))


def clip(max_delta: float) -> GradientTransformation:
    def update(u, state, params=None):
        return tree_map(lambda g: torch.clamp(g, -max_delta, max_delta),
                        u), state
    return GradientTransformation(lambda params: (), update)


def chain(*transforms) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(u, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            u, s = t.update(u, s, params)
            new_state.append(s)
        return u, tuple(new_state)
    return GradientTransformation(init, update)


def multi_transform(transforms, param_labels) -> GradientTransformation:
    """optax.multi_transform: each leaf goes through the transform of its
    label; every transform sees only its own leaves."""
    def select(tree, lab, labels):
        if isinstance(tree, dict):
            out = {k: select(tree[k], lab, labels[k]) for k in tree}
            return {k: v for k, v in out.items() if v is not None}
        return tree if labels == lab else None

    def merge(parts, labels, path=()):
        if isinstance(labels, dict):
            return {k: merge(parts, labels[k], path + (k,)) for k in labels}
        leaf = parts[labels]
        for k in path:
            leaf = leaf[k]
        return leaf

    def init(params):
        return {lab: t.init(select(params, lab, param_labels))
                for lab, t in transforms.items()}

    def update(u, state, params=None):
        parts, new_state = {}, {}
        for lab, t in transforms.items():
            parts[lab], new_state[lab] = t.update(
                select(u, lab, param_labels), state[lab],
                None if params is None else select(params, lab, param_labels))
        return merge(parts, param_labels), new_state
    return GradientTransformation(init, update)


# ----------------------------------------------------------------- updaters

@dataclass
class Updater:
    learning_rate: Any = 1e-3  # float (schedules are not ported yet)

    def to_transform(self, iters_per_epoch: int = 1) -> GradientTransformation:
        raise NotImplementedError(
            f"{type(self).__name__} (deeplearning4j_tpu/train/updaters.py) "
            "is not ported yet")

    def with_lr(self, lr):
        return dataclasses.replace(self, learning_rate=lr)


@dataclass
class Sgd(Updater):
    learning_rate: Any = 1e-1  # DL4J Sgd.DEFAULT_LR

    def to_transform(self, iters_per_epoch=1):
        return chain(identity(), scale_by_learning_rate(self.learning_rate))


@dataclass
class Nesterovs(Updater):
    learning_rate: Any = 0.1
    momentum: Any = 0.9
    accumulator_dtype: Any = None   # e.g. torch.bfloat16 halves momentum memory

    def to_transform(self, iters_per_epoch=1):
        return chain(trace(self.momentum, True, self.accumulator_dtype),
                     scale_by_learning_rate(self.learning_rate))


@dataclass
class Momentum(Updater):
    learning_rate: Any = 0.1
    momentum: Any = 0.9
    accumulator_dtype: Any = None   # e.g. torch.bfloat16 halves momentum memory

    def to_transform(self, iters_per_epoch=1):
        return chain(trace(self.momentum, False, self.accumulator_dtype),
                     scale_by_learning_rate(self.learning_rate))


@dataclass
class Adam(Updater):
    learning_rate: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def to_transform(self, iters_per_epoch=1):
        return chain(scale_by_adam(self.beta1, self.beta2, self.epsilon),
                     scale_by_learning_rate(self.learning_rate))


@dataclass
class AdamW(Adam):
    weight_decay: float = 1e-2

    def to_transform(self, iters_per_epoch=1):
        return chain(scale_by_adam(self.beta1, self.beta2, self.epsilon),
                     add_decayed_weights(self.weight_decay),
                     scale_by_learning_rate(self.learning_rate))


@dataclass
class NoOp(Updater):
    def to_transform(self, iters_per_epoch=1):
        return set_to_zero()


# --- gradient normalization (org.deeplearning4j.nn.conf.GradientNormalization)

class GradientNormalization:
    NONE = "none"
    RENORMALIZE_L2_PER_LAYER = "renormalize_l2_per_layer"
    RENORMALIZE_L2_PER_PARAM_TYPE = "renormalize_l2_per_param_type"
    CLIP_ELEMENT_WISE_ABSOLUTE_VALUE = "clip_element_wise_absolute_value"
    CLIP_L2_PER_LAYER = "clip_l2_per_layer"
    CLIP_L2_PER_PARAM_TYPE = "clip_l2_per_param_type"


def _map_transform(fn):
    return GradientTransformation(
        lambda params: (),
        lambda u, state, params=None: (tree_map(fn, u), state))


def gradient_normalization(kind: str,
                           threshold: float = 1.0) -> GradientTransformation:
    """The transform for a GradientNormalization enum value; per-layer ==
    per-leaf, as in the reference."""
    kind = (kind or "none").lower()
    if kind == GradientNormalization.NONE:
        return identity()
    if kind in (GradientNormalization.RENORMALIZE_L2_PER_LAYER,
                GradientNormalization.RENORMALIZE_L2_PER_PARAM_TYPE):
        def renorm(u):
            n = torch.sqrt(torch.sum(torch.square(u)))
            return u / torch.clamp(n, min=1e-8)
        return _map_transform(renorm)
    if kind == GradientNormalization.CLIP_ELEMENT_WISE_ABSOLUTE_VALUE:
        return clip(threshold)
    if kind in (GradientNormalization.CLIP_L2_PER_LAYER,
                GradientNormalization.CLIP_L2_PER_PARAM_TYPE):
        def clipl2(u):
            n = torch.sqrt(torch.sum(torch.square(u)))
            return torch.where(n > threshold,
                               u * (threshold / torch.clamp(n, min=1e-8)), u)
        return _map_transform(clipl2)
    raise ValueError(f"Unknown gradient normalization: {kind}")


def build_optimizer(updater: Updater, *, grad_norm: str = "none",
                    grad_norm_threshold: float = 1.0,
                    l1: float = 0.0, l2: float = 0.0,
                    weight_decay: float = 0.0,
                    iters_per_epoch: int = 1,
                    param_labels=None, per_label_updaters=None
                    ) -> GradientTransformation:
    """Compose: grad-norm → L1/L2 regularization gradients → updater, with
    per-label updaters through :func:`multi_transform` (reference
    ``build_optimizer``)."""
    parts = [gradient_normalization(grad_norm, grad_norm_threshold)]
    if l2:
        parts.append(add_decayed_weights(l2))
    if l1:
        parts.append(GradientTransformation(
            lambda params: (),
            lambda u, state, params=None: (
                tree_map(lambda g, p: g + l1 * torch.sign(p), u, params),
                state)))
    if weight_decay:
        parts.append(add_decayed_weights(weight_decay))
    if param_labels is not None and per_label_updaters:
        parts.append(multi_transform(
            {k: u.to_transform(iters_per_epoch)
             for k, u in per_label_updaters.items()}, param_labels))
    else:
        parts.append(updater.to_transform(iters_per_epoch))
    return chain(*parts)
