"""EvaluationCalibration — port of ``deeplearning4j_tpu/eval/calibration.py``
(``org.nd4j.evaluation.classification.EvaluationCalibration``:
reliability diagram per class, residual plot, probability histograms).

Each ``eval`` is one pass on the predictions' device: per-class
histograms as ``index_add_`` over ``class·bins + bin`` into f64
accumulators there; masked rows carry weight 0 (shapes stay static). The
accumulators are read to the host once, by the first query.
"""

from __future__ import annotations

import numpy as np
import torch

from .classification import as_pair

# accumulator name → bins it has ("rel": reliability, "hist": histogram)
_ACC = {"_counts": "rel", "_prob_sums": "rel", "_pos": "rel",
        "_residual_hist": "hist", "_prob_hist_pos": "hist",
        "_prob_hist_all": "hist"}


class EvaluationCalibration:
    """Reliability/residual/probability-histogram accumulator."""

    def __init__(self, reliability_bins: int = 10, histogram_bins: int = 50):
        self.reliability_bins = int(reliability_bins)
        self.histogram_bins = int(histogram_bins)
        self._n_classes = None
        self._dev = None
        self._host = None

    def _ensure(self, n_classes, device):
        if self._n_classes is None:
            self._n_classes = n_classes
            bins = {"rel": self.reliability_bins, "hist": self.histogram_bins}
            self._dev = {k: torch.zeros(n_classes * bins[kind],
                                        dtype=torch.float64, device=device)
                         for k, kind in _ACC.items()}
        elif n_classes != self._n_classes:
            raise ValueError(f"class count changed: {self._n_classes} → "
                             f"{n_classes}")

    def _require_data(self):
        if self._n_classes is None:
            raise ValueError(
                "EvaluationCalibration has no data — eval() was never "
                "called (empty iterator?)")

    # ------------------------------------------------------------ accumulate
    def eval(self, labels, predictions, mask=None):
        """labels (N, C) one-hot (or (N,) indices), predictions (N, C)
        probabilities. RNN shapes (B, T, C) are flattened with `mask`
        (B, T) selecting valid steps — same convention as Evaluation."""
        y, p = as_pair(labels, predictions)
        w = None
        if p.dim() == 3:
            b, t, c = p.shape
            p = p.reshape(b * t, c)
            y = y.reshape(b * t, -1) if y.dim() == 3 else y.reshape(b * t)
            if mask is not None:
                w = (torch.as_tensor(mask, device=p.device).reshape(b * t)
                     > 0).float()
        n, c = p.shape
        if y.dim() == 1:
            y = torch.nn.functional.one_hot(y.long(), c)
        if w is None:
            w = torch.ones(n, device=p.device)
        self._ensure(c, p.device)
        w = w[:, None].expand(n, c)
        # zero masked rows BEFORE accumulating: padded steps can hold NaN
        # (softmax over fully-masked logits) and NaN * 0 is NaN
        p = torch.where(w > 0, p.float(), 0.0)
        y = torch.where(w > 0, (y > 0.5).float(), 0.0)
        rb, hb = self.reliability_bins, self.histogram_bins
        cls = torch.arange(c, device=p.device)

        def add(name, bins, idx, vals):
            self._dev[name].index_add_(
                0, (torch.clamp(idx, 0, bins - 1) + cls * bins).reshape(-1),
                vals.reshape(-1).to(torch.float64))
        ridx = (p * rb).int()
        add("_counts", rb, ridx, w)
        add("_prob_sums", rb, ridx, p * w)
        add("_pos", rb, ridx, y * w)
        add("_residual_hist", hb, (torch.abs(y - p) * hb).int(), w)
        pidx = (p * hb).int()
        add("_prob_hist_all", hb, pidx, w)
        add("_prob_hist_pos", hb, pidx, y * w)
        self._host = None
        return self

    def merge(self, other: "EvaluationCalibration") -> "EvaluationCalibration":
        if (other.reliability_bins != self.reliability_bins
                or other.histogram_bins != self.histogram_bins):
            raise ValueError(
                f"cannot merge: bin configs differ "
                f"({self.reliability_bins}/{self.histogram_bins} vs "
                f"{other.reliability_bins}/{other.histogram_bins})")
        if other._n_classes is None:
            return self
        dev = next(iter(other._dev.values())).device
        self._ensure(other._n_classes, dev)
        for k in _ACC:
            self._dev[k] = self._dev[k] + other._dev[k].to(
                self._dev[k].device)
        self._host = None
        return self

    def _read(self, name):
        if self._host is None:
            c = self._n_classes
            self._host = {k: v.cpu().numpy().reshape(c, -1)
                          for k, v in self._dev.items()}
        return self._host[name]

    # --------------------------------------------------------------- queries
    def reliability_info(self, class_idx: int):
        """(bin_centers, mean_predicted, fraction_positives, counts) — the
        reliability diagram for one class (reference getReliabilityInfo)."""
        self._require_data()
        rb = self.reliability_bins
        counts = self._read("_counts")[class_idx]
        safe = np.maximum(counts, 1)
        return ((np.arange(rb) + 0.5) / rb,
                self._read("_prob_sums")[class_idx] / safe,
                self._read("_pos")[class_idx] / safe,
                counts.astype(np.int64))

    def expected_calibration_error(self, class_idx: int = None) -> float:
        """ECE: count-weighted |mean predicted − fraction positive|."""
        self._require_data()
        classes = (range(self._n_classes) if class_idx is None
                   else [class_idx])
        num, denom = 0.0, 0.0
        for c in classes:
            _, mean_p, frac_pos, counts = self.reliability_info(c)
            num += float(np.sum(counts * np.abs(mean_p - frac_pos)))
            denom += float(np.sum(counts))
        return num / max(denom, 1.0)

    def residual_plot(self, class_idx: int):
        """(bin_centers, counts) histogram of |label − prob|."""
        self._require_data()
        hb = self.histogram_bins
        return ((np.arange(hb) + 0.5) / hb,
                self._read("_residual_hist")[class_idx].astype(np.int64))

    def probability_histogram(self, class_idx: int, positive: bool = True):
        """(bin_centers, counts) of predicted probability, split by the
        true label (reference's positive/negative histograms)."""
        self._require_data()
        hb = self.histogram_bins
        pos = self._read("_prob_hist_pos")[class_idx]
        hist = pos if positive else self._read("_prob_hist_all")[class_idx] \
            - pos
        return (np.arange(hb) + 0.5) / hb, hist.astype(np.int64)

    def stats(self) -> str:
        if self._n_classes is None:
            return "EvaluationCalibration: no data"
        lines = [f"EvaluationCalibration ({self.reliability_bins} bins, "
                 f"{int(self._read('_counts')[0].sum())} samples/class)"]
        for c in range(self._n_classes):
            lines.append(f"  class {c}: ECE="
                         f"{self.expected_calibration_error(c):.4f}")
        lines.append(f"  overall ECE={self.expected_calibration_error():.4f}")
        return "\n".join(lines)
