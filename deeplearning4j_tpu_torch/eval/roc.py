"""ROC / ROCBinary / ROCMultiClass — port of ``deeplearning4j_tpu/eval/roc.py``
(``org.nd4j.evaluation.classification.{ROC, ROCBinary, ROCMultiClass}``).

``threshold_steps=0`` is the EXACT mode: every score is kept, on the
device, and the curve is the reference's numpy code over them, read once.
``threshold_steps=N`` keeps two histograms of N+1 bins on the device (one
``index_add_`` a batch). A mask weights rows; the exact mode drops the
masked ones when it reads its scores.
"""

from __future__ import annotations

import numpy as np
import torch

from .classification import as_pair


def _auc(x, y):
    """Trapezoidal area; x must already be monotone non-decreasing."""
    return float(np.trapezoid(np.asarray(y), np.asarray(x)))


def _column(a):
    """The positive class's column of (N,), (N, 1) or (N, 2) scores."""
    if a.dim() == 2 and a.shape[-1] == 2:
        return a[:, 1]
    if a.dim() == 2:
        return a[:, 0]
    return a


class ROC:
    """Binary ROC: labels (N,) or one-hot (N,2); probs of positive class."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = threshold_steps
        self._hist = None           # (2, steps+1) int64: positives, negatives
        self._kept = []             # exact mode: (scores, labels, keep)
        self._host = None

    def eval(self, labels, predictions, mask=None):
        y, p = as_pair(labels, predictions)
        keep = None
        if p.dim() == 3:
            p = p.reshape(-1, p.shape[-1])
            y = y.reshape(-1, y.shape[-1]) if y.dim() == 3 else y.reshape(-1)
            if mask is not None:
                keep = torch.as_tensor(mask, device=p.device).reshape(-1) > 0
        p, y = _column(p), (_column(y) > 0.5).long()
        if keep is None:
            keep = torch.ones_like(y, dtype=torch.bool)
        if self.threshold_steps:
            steps = self.threshold_steps
            if self._hist is None:
                self._hist = torch.zeros((2, steps + 1), dtype=torch.int64,
                                         device=p.device)
            bins = torch.clamp((p * steps).long(), 0, steps)
            w = keep.long()
            self._hist[0].index_add_(0, bins, y * w)
            self._hist[1].index_add_(0, bins, (1 - y) * w)
        else:
            self._kept.append((p, y, keep))
        self._host = None

    def _read(self):
        """Host arrays: the two histograms, or the kept scores and labels."""
        if self._host is None:
            if self.threshold_steps:
                self._host = self._hist.cpu().numpy()
            else:
                p, y, keep = (torch.cat(c).cpu().numpy()
                              for c in zip(*self._kept))
                self._host = (p[keep], y[keep])
        return self._host

    def _curve(self):
        """Returns (fpr, tpr, precision) with fpr/tpr monotone ascending."""
        if self.threshold_steps:
            pos_hist, neg_hist = self._read()
            # tp[i] = positives with score-bin >= i (threshold descending as
            # i ascends) — reverse so the curve ascends from (0,0) to (1,1)
            pos = pos_hist[::-1].cumsum()[::-1].astype(np.float64)
            neg = neg_hist[::-1].cumsum()[::-1].astype(np.float64)
            tp = pos[::-1]
            fp = neg[::-1]
            p_total = pos_hist.sum() or 1
            n_total = neg_hist.sum() or 1
            tpr = np.concatenate([[0.0], tp / p_total])
            fpr = np.concatenate([[0.0], fp / n_total])
            prec = np.concatenate([[1.0], tp / np.maximum(tp + fp, 1)])
            return fpr, tpr, prec
        s, y = self._read()
        order = np.argsort(-s)
        y = y[order]
        tp = y.cumsum()
        fp = (1 - y).cumsum()
        p_total = y.sum() or 1
        n_total = (1 - y).sum() or 1
        tpr = np.concatenate([[0.0], tp / p_total])
        fpr = np.concatenate([[0.0], fp / n_total])
        prec = np.concatenate([[1.0], tp / np.maximum(tp + fp, 1)])
        return fpr, tpr, prec

    def calculate_auc(self) -> float:
        fpr, tpr, _ = self._curve()
        return _auc(fpr, tpr)

    def calculate_auprc(self) -> float:
        _, tpr, prec = self._curve()
        return _auc(tpr, prec)

    def get_roc_curve(self):
        fpr, tpr, _ = self._curve()
        return fpr, tpr


class _PerColumn:
    """One ROC per output column."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = threshold_steps
        self._rocs = None

    def _eval_columns(self, y, p):
        c = p.shape[-1]
        if self._rocs is None:
            self._rocs = [ROC(self.threshold_steps) for _ in range(c)]
        for i in range(c):
            self._rocs[i].eval(y[..., i], p[..., i])

    def calculate_auc(self, i: int) -> float:
        return self._rocs[i].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self._rocs]))


class ROCBinary(_PerColumn):
    """Per-output ROC for multi-label sigmoid outputs."""

    def eval(self, labels, predictions, mask=None):
        self._eval_columns(*as_pair(labels, predictions))


class ROCMultiClass(_PerColumn):
    """One-vs-all ROC per class (reference ROCMultiClass)."""

    def eval(self, labels, predictions, mask=None):
        y, p = as_pair(labels, predictions)
        if y.dim() == 1:
            y = torch.nn.functional.one_hot(y.long(), p.shape[-1]).to(
                p.dtype)
        self._eval_columns(y, p)
