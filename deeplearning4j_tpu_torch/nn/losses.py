"""Loss functions — port of ``deeplearning4j_tpu/nn/losses.py``
(``LossFunctions``).

Every loss is ``fn(labels, preds, weights=None, mask=None, group=None)
-> scalar``; with a parallel step's batch ``group`` it is this rank's
share of the global batch's loss (the ranks' shares sum to it).
``preds`` are the layer's *activated* outputs (DL4J convention) except
the ``*_with_logits`` variants. DL4J reduction: score = sum over output
units, mean over (unmasked) examples. Mixed dtypes promote as in the
reference: bf16 logits meet f32 labels in f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import _dist

_EPS = 1e-7


def _weighted(per_unit, weights):
    if weights is not None:
        per_unit = per_unit * weights
    return per_unit


def _reduce(per_unit, mask):
    """Sum over trailing dims → per-example score."""
    return per_unit.reshape(per_unit.shape[0], -1).sum(dim=1)


def _mean(per_ex, mask, g=None):
    """Mean over the (unmasked) examples. With a parallel step's batch
    group ``g`` this rank's share of the global batch's mean."""
    m = None if mask is None else \
        mask.reshape(mask.shape[0], -1).amax(dim=1)  # example present at all?
    if g is not None:
        return _dist.global_mean(per_ex, m, g)
    if m is None:
        return per_ex.mean()
    return (per_ex * m).sum() / torch.clamp(m.sum(), min=1.0)


def _apply_mask(per_unit, mask):
    """Mask shape (B,) / (B,T) / full — broadcast against per-unit scores."""
    if mask is None:
        return per_unit
    m = mask
    while m.dim() < per_unit.dim():
        m = m[..., None]
    return per_unit * m


def _logsumexp(a, dim, b=None):
    """jax.scipy.special.logsumexp with optional weights ``b``: the max is
    taken over the entries ``b`` keeps, so a sparse sum stays finite."""
    if b is not None:
        a = torch.where(b != 0, a, torch.full_like(a, -math.inf))
    amax = torch.amax(a, dim=dim, keepdim=True).detach()
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    e = torch.exp(a - amax)
    if b is not None:
        e = e * b
    return torch.log(torch.abs(e.sum(dim=dim))) + amax.squeeze(dim)


# --- classification --------------------------------------------------------

def mcxent_per_unit(labels, preds, weights=None, mask=None):
    p = torch.clamp(preds, _EPS, 1.0 - _EPS)
    per_unit = -labels * torch.log(p)
    return _apply_mask(_weighted(per_unit, weights), mask)


def mcxent(labels, preds, weights=None, mask=None, group=None):
    """Multi-class cross entropy vs softmax output (LossMCXENT)."""
    per_unit = mcxent_per_unit(labels, preds, weights, mask)
    return _mean(_reduce(per_unit, mask), mask, group)


negative_log_likelihood = mcxent  # DL4J NEGATIVELOGLIKELIHOOD == MCXENT vs softmax


def _take_last(t, labels):
    return torch.gather(t, -1, labels.long()[..., None])[..., 0]


def sparse_mcxent(labels, preds, weights=None, mask=None, group=None):
    """Labels are int class ids (SparseMCXENT)."""
    p = torch.clamp(_take_last(preds, labels), _EPS, 1.0)
    per_unit = -torch.log(p)
    if weights is not None:
        per_unit = per_unit * weights[labels.long()]
    per_unit = _apply_mask(per_unit, mask)
    if per_unit.dim() == 1:
        per_ex = per_unit
    else:
        per_ex = per_unit.reshape(per_unit.shape[0], -1).sum(dim=1)
    return _mean(per_ex, mask, group)


def softmax_cross_entropy_with_logits(labels, logits, weights=None, mask=None,
                                      group=None):
    """Numerically-stable fused path (what the OutputLayer trains through):
    log_softmax in the logits' dtype, then promotion by the labels."""
    logp = torch.log_softmax(logits, dim=-1)
    per_unit = _apply_mask(_weighted(-labels * logp, weights), mask)
    return _mean(_reduce(per_unit, mask), mask, group)


def sparse_softmax_cross_entropy_with_logits(labels, logits, weights=None, mask=None,
                                             group=None):
    logp = torch.log_softmax(logits, dim=-1)
    per_unit = -_take_last(logp, labels)
    per_unit = _apply_mask(per_unit, mask)
    per_ex = per_unit if per_unit.dim() == 1 \
        else per_unit.reshape(per_unit.shape[0], -1).sum(dim=1)
    return _mean(per_ex, mask, group)


def binary_xent(labels, preds, weights=None, mask=None, group=None):
    """LossBinaryXENT vs sigmoid output."""
    p = torch.clamp(preds, _EPS, 1.0 - _EPS)
    per_unit = -(labels * torch.log(p) + (1.0 - labels) * torch.log1p(-p))
    per_unit = _apply_mask(_weighted(per_unit, weights), mask)
    return _mean(_reduce(per_unit, mask), mask, group)


def sigmoid_cross_entropy_with_logits(labels, logits, weights=None, mask=None,
                                      group=None):
    z = F.relu(logits) - logits * labels \
        + torch.log1p(torch.exp(-torch.abs(logits)))
    per_unit = _apply_mask(_weighted(z, weights), mask)
    return _mean(_reduce(per_unit, mask), mask, group)


def hinge(labels, preds, weights=None, mask=None, group=None):
    """Labels in {-1,1} (LossHinge)."""
    per_unit = F.relu(1.0 - labels * preds)
    per_unit = _apply_mask(_weighted(per_unit, weights), mask)
    return _mean(_reduce(per_unit, mask), mask, group)


def squared_hinge(labels, preds, weights=None, mask=None, group=None):
    per_unit = torch.square(F.relu(1.0 - labels * preds))
    per_unit = _apply_mask(_weighted(per_unit, weights), mask)
    return _mean(_reduce(per_unit, mask), mask, group)


def fmeasure(labels, preds, beta=1.0, weights=None, mask=None, group=None):
    """LossFMeasure — differentiable soft-F_beta (binary). Returns 1 - F."""
    preds = _apply_mask(preds, mask)
    labels = _apply_mask(labels, mask)
    tp = torch.sum(labels * preds)
    fp = torch.sum((1.0 - labels) * preds)
    fn = torch.sum(labels * (1.0 - preds))
    if group is not None:       # the global batch's counts
        tp, fp, fn = _dist.all_reduce_sum(torch.stack([tp, fp, fn]), group)
    b2 = beta * beta
    f = (1.0 + b2) * tp / torch.clamp((1.0 + b2) * tp + b2 * fn + fp,
                                      min=_EPS)
    return 1.0 - f if group is None else (1.0 - f) / group.size


# --- regression ------------------------------------------------------------

def mse(labels, preds, weights=None, mask=None, group=None):
    per_unit = _apply_mask(_weighted(torch.square(preds - labels), weights), mask)
    return _mean(_reduce(per_unit, mask), mask, group)


l2 = mse  # DL4J LossL2 = sum of squares (no mean over units); score matches via _reduce


def rmse(labels, preds, weights=None, mask=None, group=None):
    if group is None:
        return torch.sqrt(mse(labels, preds, weights, mask))
    # the global batch's root, in a 1/size share a rank
    share = mse(labels, preds, weights, mask, group).reshape(1)
    return torch.sqrt(_dist.all_reduce_sum(share, group))[0] / group.size


def mae(labels, preds, weights=None, mask=None, group=None):
    per_unit = _apply_mask(_weighted(torch.abs(preds - labels), weights), mask)
    return _mean(_reduce(per_unit, mask), mask, group)


l1 = mae


def msle(labels, preds, weights=None, mask=None, group=None):
    per_unit = torch.square(torch.log1p(torch.clamp(preds, min=-1 + _EPS))
                            - torch.log1p(torch.clamp(labels, min=-1 + _EPS)))
    per_unit = _apply_mask(_weighted(per_unit, weights), mask)
    return _mean(_reduce(per_unit, mask), mask, group)


def mape(labels, preds, weights=None, mask=None, group=None):
    per_unit = 100.0 * torch.abs((preds - labels)
                                 / torch.clamp(torch.abs(labels), min=_EPS))
    per_unit = _apply_mask(_weighted(per_unit, weights), mask)
    return _mean(_reduce(per_unit, mask), mask, group)


def kl_divergence(labels, preds, weights=None, mask=None, group=None):
    p = torch.clamp(labels, _EPS, 1.0)
    q = torch.clamp(preds, _EPS, 1.0)
    per_unit = _apply_mask(_weighted(p * (torch.log(p) - torch.log(q)),
                                     weights), mask)
    return _mean(_reduce(per_unit, mask), mask, group)


def poisson(labels, preds, weights=None, mask=None, group=None):
    per_unit = preds - labels * torch.log(torch.clamp(preds, min=_EPS))
    per_unit = _apply_mask(_weighted(per_unit, weights), mask)
    return _mean(_reduce(per_unit, mask), mask, group)


def cosine_proximity(labels, preds, weights=None, mask=None, group=None):
    ln = labels / torch.clamp(torch.linalg.norm(labels, dim=-1, keepdim=True),
                              min=_EPS)
    pn = preds / torch.clamp(torch.linalg.norm(preds, dim=-1, keepdim=True),
                             min=_EPS)
    per_unit = _apply_mask(_weighted(-ln * pn, weights), mask)
    return _mean(_reduce(per_unit, mask), mask, group)


def wasserstein(labels, preds, weights=None, mask=None, group=None):
    """LossWasserstein: mean(labels * preds) — critic loss for WGAN."""
    per_unit = _apply_mask(_weighted(labels * preds, weights), mask)
    return _mean(_reduce(per_unit, mask), mask, group)


def mixture_density(labels, preds, n_mixtures, weights=None, mask=None,
                    group=None):
    """LossMixtureDensity: negative log-likelihood of a GMM head.

    preds packs [alpha_logits(K), mu(K*D), log_sigma(K)] along the last axis.
    """
    d = labels.shape[-1]
    k = n_mixtures
    alpha = torch.log_softmax(preds[..., :k], dim=-1)
    mu = preds[..., k:k + k * d].reshape(*preds.shape[:-1], k, d)
    log_sigma = preds[..., k + k * d:k + k * d + k]
    y = labels[..., None, :]
    sq = torch.sum(torch.square(y - mu), dim=-1)
    log_prob = alpha - 0.5 * sq / torch.exp(2.0 * log_sigma) \
        - d * (log_sigma + 0.5 * math.log(2.0 * math.pi))
    nll = -_logsumexp(log_prob, -1)
    nll = _apply_mask(_weighted(nll, weights), mask)
    per_ex = nll if nll.dim() == 1 else nll.reshape(nll.shape[0], -1).sum(dim=1)
    return _mean(per_ex, mask, group)


def multi_label(labels, preds, weights=None, mask=None, group=None):
    """LossMultiLabel: pairwise ranking loss over (positive, negative)
    label pairs per example, in log space —
    ``exp(logsumexp_l(o_l) + logsumexp_k(-o_k)) / (|Y||Ybar|)``. Examples
    with an empty positive OR negative set contribute 0; a per-output
    mask shrinks the label sets, a per-example (B,) mask drops whole
    examples."""
    if weights is not None:
        raise ValueError(
            "multi_label has no per-output weighting (pairwise ranking has "
            "no per-unit term; upstream LossMultiLabel takes no weights)")
    pos = (labels > 0.5).to(preds.dtype)
    neg = 1.0 - pos
    ex_mask = None
    if mask is not None:
        if mask.dim() == preds.dim():      # per-output mask: shrink the sets
            pos = pos * mask.to(preds.dtype)
            neg = neg * mask.to(preds.dtype)
        else:                              # (B,)-style example mask
            ex_mask = mask
    lse_neg = _logsumexp(preds, -1, b=neg)
    lse_pos = _logsumexp(-preds, -1, b=pos)
    n_pairs = torch.sum(pos, dim=-1) * torch.sum(neg, dim=-1)
    log_loss = lse_neg + lse_pos - torch.log(torch.clamp(n_pairs, min=1.0))
    per_ex = torch.where(n_pairs > 0, torch.exp(log_loss),
                         torch.zeros_like(log_loss))
    if per_ex.dim() > 1:  # time-distributed (B, T) -> sum over time
        per_ex = per_ex.reshape(per_ex.shape[0], -1).sum(dim=1)
    return _mean(per_ex, ex_mask, group)


class Loss:
    """DL4J-style enum: LossFunctions.LossFunction.* (string-valued)."""

    MCXENT = "mcxent"
    NEGATIVELOGLIKELIHOOD = "negativeloglikelihood"
    SPARSE_MCXENT = "sparse_mcxent"
    XENT = "binary_xent"  # DL4J XENT = binary cross entropy
    MSE = "mse"
    SQUARED_LOSS = "mse"
    L1 = "l1"
    MAE = "mae"
    L2 = "l2"
    RMSE = "rmse"
    MSLE = "msle"
    MAPE = "mape"
    KL_DIVERGENCE = "kl_divergence"
    RECONSTRUCTION_CROSSENTROPY = "binary_xent"
    POISSON = "poisson"
    HINGE = "hinge"
    SQUARED_HINGE = "squared_hinge"
    COSINE_PROXIMITY = "cosine_proximity"
    WASSERSTEIN = "wasserstein"
    FMEASURE = "fmeasure"
    MIXTURE_DENSITY = "mixture_density"
    MULTI_LABEL = "multi_label"


_REGISTRY = {
    "mcxent": mcxent, "negativeloglikelihood": negative_log_likelihood,
    "sparse_mcxent": sparse_mcxent, "binary_xent": binary_xent, "xent": binary_xent,
    "mse": mse, "l2": l2, "rmse": rmse, "mae": mae, "l1": l1,
    "msle": msle, "mape": mape, "kl_divergence": kl_divergence,
    "poisson": poisson, "hinge": hinge, "squared_hinge": squared_hinge,
    "cosine_proximity": cosine_proximity, "wasserstein": wasserstein,
    "fmeasure": fmeasure, "mixture_density": mixture_density,
    "multi_label": multi_label, "multilabel": multi_label,
}

# losses whose stable fused-logits variant exists; OutputLayer uses these
LOGITS_VARIANTS = {
    "mcxent": softmax_cross_entropy_with_logits,
    "negativeloglikelihood": softmax_cross_entropy_with_logits,
    "sparse_mcxent": sparse_softmax_cross_entropy_with_logits,
    "binary_xent": sigmoid_cross_entropy_with_logits,
    "xent": sigmoid_cross_entropy_with_logits,
}


def score(loss, labels, preds, mask=None, group=None):
    """``loss`` (a name or a callable) of ``preds`` against ``labels``.
    With a batch ``group`` the port's losses give this rank's share of
    the global batch's; a callable of the user's, which takes no group,
    gives its rows' loss over the group's size (the share of a mean over
    examples, every rank holding as many rows)."""
    fn = get(loss)
    if group is None:
        return fn(labels, preds, mask=mask)
    if fn in _REGISTRY.values():
        return fn(labels, preds, mask=mask, group=group)
    return _dist.share(fn(labels, preds, mask=mask), group)


def get(name_or_fn):
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown loss '{name_or_fn}'. Known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]
