"""Updaters — port of ``deeplearning4j_tpu/train/updaters.py``.

The reference builds optax chains. Here each updater is the same config
dataclass, and ``to_transform()`` gives a :class:`GradientTransformation`
with optax's semantics, not ``torch.optim``'s: ``Sgd`` scales by −lr;
``Momentum``/``Nesterovs`` keep optax's trace ``v = g + m·v`` (v₀ = 0);
``Adam`` keeps eps outside the square root and its step ``count`` as an
int32 device tensor; ``AdamW`` adds ``wd·p`` to the Adam direction before
the −lr scale. :func:`build_optimizer` composes gradient normalization →
L2 → L1 → weight decay → the updater (or a per-label
``multi_transform``), as the reference does.

Unlike optax, everything happens in place, so that one train step can
be captured as a CUDA graph and replayed (``nn/_compiled.py``):

- ``init(params)`` allocates the state's tensors once, on the params'
  device;
- ``update(grads, state, params) -> (updates, state)`` overwrites the
  leaves of ``grads`` with the updates and the state's tensors with the
  new state, and returns the same two objects. The caller hands its
  grads over. Each transform is a few ``torch._foreach_*`` calls over the
  leaves it sees (the leaves of one label group under
  ``multi_transform``) and reads nothing back to the host;
- :func:`apply_updates` adds the updates to the params, one
  ``_foreach_add_`` per dtype group.

Trees are nested dicts of tensors, their leaves in sorted-key order
(:func:`tree_leaves`), as ``jax.tree_util`` flattens a dict.

A learning rate is a number or a ``Schedule`` (``train/schedules.py``):
:func:`scale_by_learning_rate` then keeps its own int32 ``count`` on the
device, as optax's ``scale_by_schedule`` does, and computes the lr of each
step there, so a replayed step takes the lr of its own step.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from .schedules import Schedule


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


# ------------------------------------------------------------ tree helpers

def tree_map(fn, tree, *rest):
    """Map over the tensor leaves of nested dicts and lists (``rest``
    alike)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def _zeros_like(tree, dtype=None):
    return tree_map(lambda p: torch.zeros_like(p, dtype=dtype), tree)


def apply_updates(params, updates):
    """``p += u`` over two aligned leaf lists, in place: one
    ``_foreach_add_`` per parameter dtype, each update cast to its
    param's dtype first."""
    groups = {}
    for p, u in zip(params, updates):
        ps, us = groups.setdefault(p.dtype, ([], []))
        ps.append(p)
        us.append(u if u.dtype == p.dtype else u.to(p.dtype))
    for ps, us in groups.values():
        torch._foreach_add_(ps, us)


def _stateless(fn):
    """A transform without state whose ``fn(leaves, param_leaves)``
    overwrites the update leaves in place (never called on none)."""
    def update(u, state, params=None):
        us = tree_leaves(u)
        if us:
            fn(us, None if params is None else tree_leaves(params))
        return u, state
    return GradientTransformation(lambda params: (), update)


# --------------------------------------------------------------- transforms

def identity() -> GradientTransformation:
    return GradientTransformation(lambda params: (),
                                  lambda u, state, params=None: (u, state))


def scale(step_size: float) -> GradientTransformation:
    return _stateless(lambda us, ps: torch._foreach_mul_(us, step_size))


def _count(params):
    """A transform's int32 step count: a 0-d tensor on the params' device."""
    leaves = tree_leaves(params)
    return torch.zeros((), dtype=torch.int32,
                       device=leaves[0].device if leaves else None)


def _by_dtype(us):
    groups = {}
    for u in us:
        groups.setdefault(u.dtype, []).append(u)
    return groups.items()


def scale_by_schedule(step_size_fn) -> GradientTransformation:
    """optax.scale_by_schedule: update k is scaled by ``step_size_fn(k)``
    (an f32 0-d tensor computed on the device from the int32 ``count``),
    cast to each update's dtype; the count is incremented after use."""
    def init(params):
        return {"count": _count(params)}

    def update(u, state, params=None):
        us = tree_leaves(u)
        count = state["count"]
        if us:
            step = step_size_fn(count)
            for dtype, group in _by_dtype(us):
                torch._foreach_mul_(group, step.to(dtype))
        count.add_(1)
        return u, state
    return GradientTransformation(init, update)


def scale_by_learning_rate(lr, iters_per_epoch: int = 1
                           ) -> GradientTransformation:
    """−lr: a number scales by a constant; a ``Schedule`` by its value at
    each step (EPOCH-typed ones at ``step // iters_per_epoch``)."""
    if isinstance(lr, Schedule):
        return scale_by_schedule(
            lambda count: -lr.at(count, iters_per_epoch))
    if not isinstance(lr, (int, float)):
        raise TypeError(
            f"learning rate {lr!r}: pass a number or a train.schedules."
            "Schedule (its step-side form runs on the device)")
    return scale(-lr)


def trace(decay: float, nesterov: bool = False,
          accumulator_dtype=None) -> GradientTransformation:
    """optax.trace: t ← g + decay·t; the update is t (or g + decay·t with
    Nesterov). With an ``accumulator_dtype`` the sum is taken in the
    grads' dtype and only the stored trace is rounded to it."""
    def init(params):
        return {"trace": _zeros_like(params, accumulator_dtype)}

    def update(u, state, params=None):
        us, ts = tree_leaves(u), tree_leaves(state["trace"])
        if not us:
            return u, state
        if accumulator_dtype is None:
            torch._foreach_mul_(ts, decay)
            torch._foreach_add_(ts, us)
            new = ts
        else:
            new = torch._foreach_add(
                us, [t.to(g.dtype) for t, g in zip(ts, us)], alpha=decay)
            torch._foreach_copy_(ts, new)
        if nesterov:
            torch._foreach_add_(us, new, alpha=decay)
        else:
            torch._foreach_copy_(us, new)
        return u, state
    return GradientTransformation(init, update)


def scale_by_adam(b1=0.9, b2=0.999, eps=1e-8) -> GradientTransformation:
    """optax.scale_by_adam (eps_root 0): bias-corrected m / (sqrt(v) + eps).
    ``count`` is an int32 0-d tensor on the params' device, and the bias
    corrections ``1 − βᵏ`` are computed there."""
    def init(params):
        return {"count": _count(params), "mu": _zeros_like(params),
                "nu": _zeros_like(params)}

    def update(u, state, params=None):
        us = tree_leaves(u)
        if not us:
            return u, state
        mu, nu = tree_leaves(state["mu"]), tree_leaves(state["nu"])
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, us, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, us, us, value=1 - b2)
        count = state["count"]
        count.add_(1)
        k = count.float()
        den = torch._foreach_div(nu, 1 - b2 ** k)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        torch._foreach_copy_(us, mu)
        torch._foreach_div_(us, 1 - b1 ** k)
        torch._foreach_div_(us, den)
        return u, state
    return GradientTransformation(init, update)


def _moment(ms, us, decay, order):
    """optax's ``update_moment``: m ← (1 − decay)·gᵒʳᵈᵉʳ + decay·m."""
    torch._foreach_mul_(ms, decay)
    if order == 1:
        torch._foreach_add_(ms, us, alpha=1 - decay)
    else:
        torch._foreach_addcmul_(ms, us, us, value=1 - decay)


def scale_by_nadam(b1=0.9, b2=0.999, eps=1e-8) -> GradientTransformation:
    """optax.scale_by_adam(nesterov=True): the bias-corrected Nesterov
    moment b1·m/(1 − b1ᵏ⁺¹) + (1 − b1)·g/(1 − b1ᵏ) over sqrt(v̂) + eps."""
    def init(params):
        return {"count": _count(params), "mu": _zeros_like(params),
                "nu": _zeros_like(params)}

    def update(u, state, params=None):
        us = tree_leaves(u)
        if not us:
            return u, state
        mu, nu = tree_leaves(state["mu"]), tree_leaves(state["nu"])
        _moment(mu, us, b1, 1)
        _moment(nu, us, b2, 2)
        count = state["count"]
        count.add_(1)
        k = count.float()
        mhat = torch._foreach_div(mu, 1 - b1 ** (k + 1))
        torch._foreach_mul_(mhat, b1)
        torch._foreach_div_(us, 1 - b1 ** k)
        torch._foreach_mul_(us, 1 - b1)
        torch._foreach_add_(us, mhat)
        den = torch._foreach_div(nu, 1 - b2 ** k)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        torch._foreach_div_(us, den)
        return u, state
    return GradientTransformation(init, update)


def scale_by_amsgrad(b1=0.9, b2=0.999, eps=1e-8) -> GradientTransformation:
    """optax.scale_by_amsgrad: m̂ / (sqrt(max over steps of v̂) + eps)."""
    def init(params):
        return {"count": _count(params), "mu": _zeros_like(params),
                "nu": _zeros_like(params), "nu_max": _zeros_like(params)}

    def update(u, state, params=None):
        us = tree_leaves(u)
        if not us:
            return u, state
        mu, nu = tree_leaves(state["mu"]), tree_leaves(state["nu"])
        nu_max = tree_leaves(state["nu_max"])
        _moment(mu, us, b1, 1)
        _moment(nu, us, b2, 2)
        count = state["count"]
        count.add_(1)
        k = count.float()
        torch._foreach_maximum_(nu_max, torch._foreach_div(nu, 1 - b2 ** k))
        den = torch._foreach_sqrt(nu_max)
        torch._foreach_add_(den, eps)
        torch._foreach_copy_(us, mu)
        torch._foreach_div_(us, 1 - b1 ** k)
        torch._foreach_div_(us, den)
        return u, state
    return GradientTransformation(init, update)


def scale_by_adamax(b1=0.9, b2=0.999, eps=1e-8) -> GradientTransformation:
    """optax.scale_by_adamax: m̂ / v with v ← max(|g| + eps, b2·v)."""
    def init(params):
        return {"count": _count(params), "mu": _zeros_like(params),
                "nu": _zeros_like(params)}

    def update(u, state, params=None):
        us = tree_leaves(u)
        if not us:
            return u, state
        mu, nu = tree_leaves(state["mu"]), tree_leaves(state["nu"])
        count = state["count"]
        count.add_(1)
        _moment(mu, us, b1, 1)
        absg = torch._foreach_abs(us)
        torch._foreach_add_(absg, eps)
        torch._foreach_mul_(nu, b2)
        torch._foreach_maximum_(nu, absg)
        torch._foreach_copy_(us, mu)
        torch._foreach_div_(us, 1 - b1 ** count.float())
        torch._foreach_div_(us, nu)
        return u, state
    return GradientTransformation(init, update)


def scale_by_adadelta(rho=0.9, eps=1e-6) -> GradientTransformation:
    """optax.scale_by_adadelta: u = sqrt(E[x²] + eps) / sqrt(E[g²] + eps)·g
    (E[g²] updated first, E[x²] from the new u)."""
    def init(params):
        return {"e_g": _zeros_like(params), "e_x": _zeros_like(params)}

    def update(u, state, params=None):
        us = tree_leaves(u)
        if not us:
            return u, state
        e_g, e_x = tree_leaves(state["e_g"]), tree_leaves(state["e_x"])
        _moment(e_g, us, rho, 2)
        num = torch._foreach_add(e_x, eps)
        torch._foreach_sqrt_(num)
        den = torch._foreach_add(e_g, eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(num, den)
        torch._foreach_mul_(us, num)
        _moment(e_x, us, rho, 2)
        return u, state
    return GradientTransformation(init, update)


def scale_by_rss(initial_accumulator_value=0.1,
                 eps=1e-7) -> GradientTransformation:
    """optax.scale_by_rss (AdaGrad): s ← s + g², starting at
    ``initial_accumulator_value``; u = g·rsqrt(s + eps) where s > 0, else
    0."""
    def init(params):
        return {"sum_of_squares": tree_map(
            lambda p: torch.full_like(p, initial_accumulator_value), params)}

    def update(u, state, params=None):
        us = tree_leaves(u)
        if not us:
            return u, state
        ss = tree_leaves(state["sum_of_squares"])
        torch._foreach_addcmul_(ss, us, us)
        inv = torch._foreach_add(ss, eps)
        torch._foreach_rsqrt_(inv)
        torch._foreach_mul_(inv, [s.gt(0) for s in ss])
        torch._foreach_mul_(us, inv)
        return u, state
    return GradientTransformation(init, update)


def scale_by_rms(decay=0.9, eps=1e-8) -> GradientTransformation:
    """optax.scale_by_rms (initial scale 0, eps inside the root, no bias
    correction): u = g·rsqrt(v + eps), v ← (1 − decay)·g² + decay·v."""
    def init(params):
        return {"nu": _zeros_like(params)}

    def update(u, state, params=None):
        us = tree_leaves(u)
        if not us:
            return u, state
        nu = tree_leaves(state["nu"])
        _moment(nu, us, decay, 2)
        scale_ = torch._foreach_add(nu, eps)
        torch._foreach_rsqrt_(scale_)
        torch._foreach_mul_(us, scale_)
        return u, state
    return GradientTransformation(init, update)


def scale_by_lion(b1=0.9, b2=0.99) -> GradientTransformation:
    """optax.scale_by_lion: u = sign((1 − b1)·g + b1·m), then
    m ← (1 − b2)·g + b2·m."""
    def init(params):
        return {"count": _count(params), "mu": _zeros_like(params)}

    def update(u, state, params=None):
        us = tree_leaves(u)
        if not us:
            return u, state
        mu = tree_leaves(state["mu"])
        new = torch._foreach_mul(us, 1 - b1)
        torch._foreach_add_(new, mu, alpha=b1)
        torch._foreach_sign_(new)
        _moment(mu, us, b2, 1)
        torch._foreach_copy_(us, new)
        state["count"].add_(1)
        return u, state
    return GradientTransformation(init, update)


def scale_by_trust_ratio() -> GradientTransformation:
    """optax.scale_by_trust_ratio (min_norm 0, coefficient 1, eps 0): each
    leaf's update times ‖p‖ / ‖u‖, or 1 where either norm is 0."""
    def fn(us, ps):
        pn, un = torch._foreach_norm(ps), torch._foreach_norm(us)
        ratio = [torch.where((p == 0) | (n == 0), 1.0, p / n).to(u.dtype)
                 for p, n, u in zip(pn, un, us)]
        torch._foreach_mul_(us, ratio)
    return _stateless(fn)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    return _stateless(
        lambda us, ps: torch._foreach_add_(us, ps, alpha=weight_decay))


def add_l1_sign(l1: float) -> GradientTransformation:
    """g + l1·sign(p): the L1 regularization gradient."""
    return _stateless(lambda us, ps: torch._foreach_add_(
        us, torch._foreach_sign(ps), alpha=l1))


def set_to_zero() -> GradientTransformation:
    return _stateless(lambda us, ps: torch._foreach_zero_(us))


def clip(max_delta: float) -> GradientTransformation:
    def fn(us, ps):
        torch._foreach_clamp_min_(us, -max_delta)
        torch._foreach_clamp_max_(us, max_delta)
    return _stateless(fn)


def chain(*transforms) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(u, state, params=None):
        for t, s in zip(transforms, state):
            u, _ = t.update(u, s, params)
        return u, state
    return GradientTransformation(init, update)


def multi_transform(transforms, param_labels) -> GradientTransformation:
    """optax.multi_transform: each leaf goes through the transform of its
    label; every transform sees only its own leaves (and updates them in
    place, so the result is ``u`` itself)."""
    def select(tree, lab, labels):
        if isinstance(tree, dict):
            out = {k: select(tree[k], lab, labels[k]) for k in tree}
            return {k: v for k, v in out.items() if v is not None}
        return tree if labels == lab else None

    def init(params):
        return {lab: t.init(select(params, lab, param_labels))
                for lab, t in transforms.items()}

    def update(u, state, params=None):
        for lab, t in transforms.items():
            t.update(select(u, lab, param_labels), state[lab],
                     None if params is None
                     else select(params, lab, param_labels))
        return u, state
    return GradientTransformation(init, update)


# ----------------------------------------------------------------- updaters

@dataclass
class Updater:
    learning_rate: Any = 1e-3  # float or Schedule

    def _lr(self, iters_per_epoch=1):
        return scale_by_learning_rate(self.learning_rate, iters_per_epoch)

    def to_transform(self, iters_per_epoch: int = 1) -> GradientTransformation:
        raise NotImplementedError(
            f"{type(self).__name__} is an abstract updater: use one of "
            "train/updaters.py's subclasses")

    def with_lr(self, lr):
        return dataclasses.replace(self, learning_rate=lr)


@dataclass
class Sgd(Updater):
    learning_rate: Any = 1e-1  # DL4J Sgd.DEFAULT_LR

    def to_transform(self, iters_per_epoch=1):
        return chain(identity(), self._lr(iters_per_epoch))


@dataclass
class Nesterovs(Updater):
    learning_rate: Any = 0.1
    momentum: Any = 0.9
    accumulator_dtype: Any = None   # e.g. torch.bfloat16 halves momentum memory

    def to_transform(self, iters_per_epoch=1):
        return chain(trace(self.momentum, True, self.accumulator_dtype),
                     self._lr(iters_per_epoch))


@dataclass
class Momentum(Updater):
    learning_rate: Any = 0.1
    momentum: Any = 0.9
    accumulator_dtype: Any = None   # e.g. torch.bfloat16 halves momentum memory

    def to_transform(self, iters_per_epoch=1):
        return chain(trace(self.momentum, False, self.accumulator_dtype),
                     self._lr(iters_per_epoch))


@dataclass
class Adam(Updater):
    learning_rate: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def to_transform(self, iters_per_epoch=1):
        return chain(scale_by_adam(self.beta1, self.beta2, self.epsilon),
                     self._lr(iters_per_epoch))


@dataclass
class AdamW(Adam):
    weight_decay: float = 1e-2

    def to_transform(self, iters_per_epoch=1):
        return chain(scale_by_adam(self.beta1, self.beta2, self.epsilon),
                     add_decayed_weights(self.weight_decay),
                     self._lr(iters_per_epoch))


@dataclass
class AMSGrad(Adam):
    def to_transform(self, iters_per_epoch=1):
        return chain(scale_by_amsgrad(self.beta1, self.beta2, self.epsilon),
                     self._lr(iters_per_epoch))


@dataclass
class Nadam(Adam):
    def to_transform(self, iters_per_epoch=1):
        return chain(scale_by_nadam(self.beta1, self.beta2, self.epsilon),
                     self._lr(iters_per_epoch))


@dataclass
class AdaMax(Adam):
    learning_rate: Any = 2e-3

    def to_transform(self, iters_per_epoch=1):
        return chain(scale_by_adamax(self.beta1, self.beta2, self.epsilon),
                     self._lr(iters_per_epoch))


@dataclass
class AdaDelta(Updater):
    learning_rate: Any = 1.0  # AdaDelta ignores lr in DL4J; keep 1.0 scale
    rho: float = 0.95
    epsilon: float = 1e-6

    def to_transform(self, iters_per_epoch=1):
        return chain(scale_by_adadelta(self.rho, self.epsilon),
                     self._lr(iters_per_epoch))


@dataclass
class AdaGrad(Updater):
    learning_rate: Any = 1e-1
    epsilon: float = 1e-6

    def to_transform(self, iters_per_epoch=1):
        return chain(scale_by_rss(0.1, self.epsilon),
                     self._lr(iters_per_epoch))


@dataclass
class RmsProp(Updater):
    learning_rate: Any = 1e-1
    rms_decay: float = 0.95
    epsilon: float = 1e-8

    def to_transform(self, iters_per_epoch=1):
        return chain(scale_by_rms(self.rms_decay, self.epsilon),
                     self._lr(iters_per_epoch))


@dataclass
class Lion(Updater):
    learning_rate: Any = 1e-4
    beta1: float = 0.9
    beta2: float = 0.99
    weight_decay: float = 0.0

    def to_transform(self, iters_per_epoch=1):
        return chain(scale_by_lion(self.beta1, self.beta2),
                     add_decayed_weights(self.weight_decay),
                     self._lr(iters_per_epoch))


@dataclass
class Lamb(Updater):
    learning_rate: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-6
    weight_decay: float = 0.0

    def to_transform(self, iters_per_epoch=1):
        return chain(scale_by_adam(self.beta1, self.beta2, self.epsilon),
                     add_decayed_weights(self.weight_decay),
                     scale_by_trust_ratio(), self._lr(iters_per_epoch))


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


def _l2_norms(us):
    """Each leaf's L2 norm, floored at 1e-8: a list of 0-d tensors."""
    norms = torch._foreach_norm(us)
    torch._foreach_clamp_min_(norms, 1e-8)
    return norms


def _clip_l2(threshold):
    """u · min(threshold / ‖u‖, 1) per leaf: unchanged at or under the
    threshold, scaled onto it above."""
    def fn(us, ps):
        factors = torch._foreach_reciprocal(_l2_norms(us))
        torch._foreach_mul_(factors, threshold)
        torch._foreach_clamp_max_(factors, 1.0)
        torch._foreach_mul_(us, factors)
    return _stateless(fn)


def gradient_normalization(kind: str,
                           threshold: float = 1.0) -> GradientTransformation:
    """The transform for a GradientNormalization enum value; per-layer ==
    per-leaf, as in the reference."""
    kind = (kind or "none").lower()
    if kind == GradientNormalization.NONE:
        return identity()
    if kind in (GradientNormalization.RENORMALIZE_L2_PER_LAYER,
                GradientNormalization.RENORMALIZE_L2_PER_PARAM_TYPE):
        return _stateless(
            lambda us, ps: torch._foreach_div_(us, _l2_norms(us)))
    if kind == GradientNormalization.CLIP_ELEMENT_WISE_ABSOLUTE_VALUE:
        return clip(threshold)
    if kind in (GradientNormalization.CLIP_L2_PER_LAYER,
                GradientNormalization.CLIP_L2_PER_PARAM_TYPE):
        return _clip_l2(threshold)
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
        parts.append(add_l1_sign(l1))
    if weight_decay:
        parts.append(add_decayed_weights(weight_decay))
    if param_labels is not None and per_label_updaters:
        parts.append(multi_transform(
            {k: u.to_transform(iters_per_epoch)
             for k, u in per_label_updaters.items()}, param_labels))
    else:
        parts.append(updater.to_transform(iters_per_epoch))
    return chain(*parts)
