"""Logit-fidelity probes — candidate-vs-reference model paths measured,
not guessed. Port of ``deeplearning4j_tpu/obs/fidelity.py``: the same
reports, gauges and bounds, over tensors (any device) and numpy arrays.

Every inference lever — a kernel against its plain version, bf16 vs
f32, int8 KV cache, int8 weights, speculative drafts — is a *numerics
trade*: it changes the logits a little in exchange for bytes or latency.
This module turns "a little" into recorded numbers:

- :class:`FidelityProbe` runs (or is handed) two logit tensors over the
  SAME inputs and reports per-position max-abs logit error, KL
  divergence of the predicted distributions, top-k set agreement, and
  the greedy-token-match prefix length — the acceptance oracle of
  spec-decode and the quantized KV cache (greedy spec-decode must be
  token-exact; a quantized cache must hold KL under a budget).
  Reports publish as ``dl4j_fidelity_*{kind}`` gauges and are kept
  (:func:`latest_reports`).
- :func:`compare_trees` + :class:`MeasuredBound` +
  :func:`assert_trees_close` replace ad-hoc test tolerances: the bound
  asserted in a test is ``margin ×`` a RECORDED measurement (value,
  device, date in ``source``), and a failure prints the probe's
  actual measured report instead of an element dump.

All comparison math is host-side f64 numpy over logits that were
coming to the host anyway — the probe adds no device work to the paths
it judges.

Label discipline: ``dl4j_fidelity_*`` labels by ``kind`` only (the
probe pair's name, a small fixed vocabulary like ``flash_vs_xla``) —
``scripts/check_metric_names.py`` enforces.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List


def _f64(x):
    """A tensor (any device, any float dtype) or array-like as f64 numpy."""
    import numpy as np
    if hasattr(x, "detach"):                     # a torch.Tensor
        import torch
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, np.float64)


def _tree_leaves(tree):
    """Leaves of nested dicts (sorted keys), lists and tuples; None is an
    empty subtree — the reference's tree-flattening order and rules."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def _as_positions(logits):
    """(…, V) → (N, V) f64 numpy, position order preserved (a (B, T, V)
    tensor flattens batch-major so per-sequence prefixes stay
    contiguous)."""
    a = _f64(logits)
    if a.ndim == 1:
        a = a[None, :]
    return a.reshape(-1, a.shape[-1])


def _log_softmax(a):
    import numpy as np
    m = a.max(axis=-1, keepdims=True)
    z = a - m
    return z - np.log(np.exp(z).sum(axis=-1, keepdims=True))


def compare_logits(ref_logits, cand_logits, *, top_k: int = 5
                   ) -> Dict[str, Any]:
    """Fidelity report of candidate vs reference logits over the same
    inputs. Shapes must match ((T, V), (B, T, V), (N, V) — anything
    with a trailing vocab axis).

    - ``max_abs_err`` / ``mean_abs_err``: raw logit error (the number a
      kernel-equivalence claim quotes);
    - ``kl_mean`` / ``kl_max``: KL(ref ‖ cand) per position, nats —
      the distribution-level damage sampling actually sees;
    - ``topk_agreement``: mean |top-k(ref) ∩ top-k(cand)| / k;
    - ``greedy_match_frac`` and ``greedy_prefix_len``: argmax agreement
      overall and the longest matching prefix in position order — the
      spec-decode acceptance quantity.
    """
    import numpy as np
    ref = _as_positions(ref_logits)
    cand = _as_positions(cand_logits)
    if ref.shape != cand.shape:
        raise ValueError(f"shape mismatch: reference {ref.shape} vs "
                         f"candidate {cand.shape}")
    n, v = ref.shape
    k = max(1, min(int(top_k), v))
    err = np.abs(ref - cand)
    lp_ref = _log_softmax(ref)
    lp_cand = _log_softmax(cand)
    kl = (np.exp(lp_ref) * (lp_ref - lp_cand)).sum(axis=-1)
    kl = np.maximum(kl, 0.0)          # clamp -0.0 float noise
    # top-k set agreement per position
    tk_ref = np.argpartition(-ref, k - 1, axis=-1)[:, :k]
    tk_cand = np.argpartition(-cand, k - 1, axis=-1)[:, :k]
    agree = np.empty((n,), np.float64)
    for i in range(n):              # n is a probe length, not a corpus
        agree[i] = len(np.intersect1d(tk_ref[i], tk_cand[i],
                                      assume_unique=True)) / k
    greedy = ref.argmax(-1) == cand.argmax(-1)
    mismatches = np.nonzero(~greedy)[0]
    prefix = int(mismatches[0]) if mismatches.size else n
    return {
        "positions": int(n), "vocab": int(v), "top_k": int(k),
        "max_abs_err": float(err.max()),
        "mean_abs_err": float(err.mean()),
        "kl_mean": float(kl.mean()), "kl_max": float(kl.max()),
        "topk_agreement": float(agree.mean()),
        "greedy_match_frac": float(greedy.mean()),
        "greedy_prefix_len": prefix,
    }


# latest report per probe kind
_LATEST: Dict[str, Dict[str, Any]] = {}
_LOCK = threading.Lock()


class FidelityProbe:
    """One named candidate-vs-reference comparison channel.

    ``kind`` names the pair (``flash_vs_xla``, ``bf16_vs_fp32``,
    ``int8kv_vs_fp32`` …) and is the ONLY metric label — keep it a
    small fixed vocabulary. ``compare`` takes precomputed logits;
    ``run`` calls the two paths itself over shared inputs."""

    def __init__(self, kind: str, *, top_k: int = 5, registry=None):
        self.kind = str(kind)
        self.top_k = int(top_k)
        self._registry = registry
        self._m_cache = None

    def _m(self):
        # cached per probe (the NumericsSentinel._m discipline) — a
        # probe wired into a bench or test loop observes repeatedly
        if self._m_cache is not None:
            return self._m_cache
        reg = self._registry
        if reg is None:
            from . import get_registry
            reg = get_registry()
        lab = ("kind",)
        self._m_cache = {
            "probes": reg.counter(
                "dl4j_fidelity_probes_total",
                "Fidelity-probe comparisons run, by probe kind",
                labelnames=lab),
            "max_abs_err": reg.gauge(
                "dl4j_fidelity_max_abs_err",
                "Max |candidate − reference| logit error over the "
                "probe's positions", labelnames=lab),
            "kl_mean": reg.gauge(
                "dl4j_fidelity_kl_mean",
                "Mean per-position KL(ref ‖ cand), nats",
                labelnames=lab),
            "kl_max": reg.gauge(
                "dl4j_fidelity_kl_max",
                "Max per-position KL(ref ‖ cand), nats",
                labelnames=lab),
            "topk_agreement": reg.gauge(
                "dl4j_fidelity_topk_agreement",
                "Mean top-k set agreement between the two paths",
                labelnames=lab),
            "greedy_match_frac": reg.gauge(
                "dl4j_fidelity_greedy_match_frac",
                "Fraction of positions where argmax agrees",
                labelnames=lab),
            "greedy_prefix": reg.gauge(
                "dl4j_fidelity_greedy_prefix",
                "Longest position prefix with matching greedy tokens",
                labelnames=lab),
        }
        return self._m_cache

    def compare(self, ref_logits, cand_logits, *, observe: bool = True
                ) -> Dict[str, Any]:
        report = compare_logits(ref_logits, cand_logits,
                                top_k=self.top_k)
        report["kind"] = self.kind
        report["ts"] = time.time()
        if observe:
            self.observe(report)
        return report

    def run(self, ref_fn: Callable, cand_fn: Callable, *inputs,
            observe: bool = True) -> Dict[str, Any]:
        """Run both paths over the same inputs and compare. The
        reference runs FIRST (so a candidate crash still leaves the
        reference logits computed for debugging)."""
        ref = ref_fn(*inputs)
        cand = cand_fn(*inputs)
        return self.compare(ref, cand, observe=observe)

    def observe(self, report: Dict[str, Any]):
        m = self._m()
        m["probes"].inc(kind=self.kind)
        for key, gauge_key in (("max_abs_err", "max_abs_err"),
                               ("kl_mean", "kl_mean"),
                               ("kl_max", "kl_max"),
                               ("topk_agreement", "topk_agreement"),
                               ("greedy_match_frac",
                                "greedy_match_frac"),
                               ("greedy_prefix_len", "greedy_prefix")):
            if key in report:
                m[gauge_key].set(float(report[key]), kind=self.kind)
        with _LOCK:
            _LATEST[self.kind] = dict(report)


def latest_reports() -> List[Dict[str, Any]]:
    """Every probe kind's most recent report, stable order."""
    with _LOCK:
        return [_LATEST[k] for k in sorted(_LATEST)]


def reset_reports():
    """Drop recorded reports (tests)."""
    with _LOCK:
        _LATEST.clear()


# ----------------------------------------------- measured test bounds

def compare_trees(ref_tree, got_tree) -> Dict[str, float]:
    """Element-wise error measurement over two matching pytrees (grads,
    params): max/mean abs error, max relative error (|Δ|/|ref|, zeros
    excluded), rms error, and the reference scale — the measurement a
    :class:`MeasuredBound` records and :func:`assert_trees_close`
    re-asserts."""
    import numpy as np
    leaves_r = _tree_leaves(ref_tree)
    leaves_g = _tree_leaves(got_tree)
    if len(leaves_r) != len(leaves_g):
        raise ValueError("tree structures differ")
    max_abs = mean_num = mean_den = rms_num = 0.0
    max_rel = 0.0
    ref_absmax = 0.0
    for a, b in zip(leaves_r, leaves_g):
        a = _f64(a)
        b = _f64(b)
        d = np.abs(a - b)
        if d.size == 0:
            continue
        max_abs = max(max_abs, float(d.max()))
        mean_num += float(d.sum())
        rms_num += float((d * d).sum())
        mean_den += d.size
        ref_absmax = max(ref_absmax, float(np.abs(a).max()) if a.size
                         else 0.0)
        nz = np.abs(a) > 0
        if nz.any():
            max_rel = max(max_rel, float((d[nz] / np.abs(a[nz])).max()))
    return {
        "max_abs_err": max_abs,
        "mean_abs_err": mean_num / max(mean_den, 1.0),
        "rms_err": (rms_num / max(mean_den, 1.0)) ** 0.5,
        "max_rel_err": max_rel,
        "ref_absmax": ref_absmax,
    }


@dataclass(frozen=True)
class MeasuredBound:
    """A test tolerance that is a recorded measurement, not a magic
    constant: ``measured_abs`` / ``measured_rel`` are the errors
    actually observed when the bound was calibrated (``source`` says
    where and when), and the asserted tolerance is ``margin ×`` that —
    the margin is the only judgement call, and it is explicit."""

    measured_abs: float
    measured_rel: float
    source: str
    margin: float = 8.0

    @property
    def atol(self) -> float:
        return self.margin * self.measured_abs

    @property
    def rtol(self) -> float:
        return self.margin * self.measured_rel


def assert_trees_close(ref_tree, got_tree, bound: MeasuredBound,
                       what: str = "") -> Dict[str, float]:
    """allclose with measured tolerances: every element must satisfy
    ``|got − ref| ≤ bound.atol + bound.rtol·|ref|``. On failure the
    error message is the probe's measured report next to the recorded
    calibration — the drift is quantified, not just flagged. Returns
    the measurement (tests can additionally log or assert on it)."""
    import numpy as np
    report = compare_trees(ref_tree, got_tree)
    worst = 0.0
    for a, b in zip(_tree_leaves(ref_tree), _tree_leaves(got_tree)):
        a = _f64(a)
        b = _f64(b)
        if a.size == 0:
            continue
        excess = np.abs(a - b) - (bound.atol + bound.rtol * np.abs(a))
        worst = max(worst, float(excess.max()))
    if worst > 0:
        raise AssertionError(
            f"{what or 'trees'} drifted past the measured bound: "
            f"measured now {report}, bound = {bound.margin}x recorded "
            f"(abs {bound.measured_abs:g}, rel {bound.measured_rel:g}) "
            f"from {bound.source}; worst excess {worst:.3e}")
    return report
