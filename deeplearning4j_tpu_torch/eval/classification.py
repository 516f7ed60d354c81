"""Evaluation — port of ``deeplearning4j_tpu/eval/classification.py``
(``org.nd4j.evaluation.classification.Evaluation`` and
``EvaluationBinary``).

The per-batch update runs on the device of the predictions: the confusion
matrix is one ``index_add_`` over ``label·n + pred`` (the reference's
jitted scatter-add), top-N hits and the example count are device
scalars, and a label mask weights the rows instead of dropping them (no
data-dependent shape, no host read). Nothing is read to the host until a
metric is asked for; then the counts are read once, and the metrics are
the reference's numpy code over them. Accumulators merge across batches
and evaluators.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def as_pair(labels, predictions):
    """(labels, predictions) as tensors on the predictions' device."""
    preds = torch.as_tensor(predictions)
    return torch.as_tensor(labels, device=preds.device), preds


def flatten_time(labels, preds, mask):
    """(B, T, C) predictions flattened to rows, with a (B·T,) 0/1 weight
    from the (B, T) mask (None without one); 2-D input passes through."""
    if preds.dim() != 3:
        return labels, preds, None
    b, t, c = preds.shape
    preds = preds.reshape(b * t, c)
    labels = labels.reshape(b * t, -1) if labels.dim() == 3 \
        else labels.reshape(b * t)
    w = None
    if mask is not None:
        w = torch.as_tensor(mask, device=preds.device).reshape(b * t) > 0
    return labels, preds, w


class ConfusionMatrix:
    def __init__(self, num_classes: int):
        self.matrix = np.zeros((num_classes, num_classes), np.int64)

    def add(self, actual: int, predicted: int, count: int = 1):
        self.matrix[actual, predicted] += count

    def get_count(self, actual: int, predicted: int) -> int:
        return int(self.matrix[actual, predicted])

    def to_numpy(self):
        return self.matrix


class Evaluation:
    def __init__(self, num_classes: Optional[int] = None, top_n: int = 1,
                 labels_list=None):
        self.num_classes = num_classes
        self.top_n = top_n
        self.labels_list = labels_list
        self._conf = None           # (n·n,) int64 on the device
        self._topn = None           # int64 0-d
        self._count = None          # int64 0-d
        self._host = None

    # ------------------------------------------------------------------ eval
    def eval(self, labels, predictions, mask=None):
        """labels: one-hot or int ids; predictions: probabilities/logits.

        RNN shapes (B,T,C) are flattened with `mask` (B,T) selecting steps.
        """
        labels, preds = as_pair(labels, predictions)
        labels, preds, keep = flatten_time(labels, preds, mask)
        c = preds.shape[-1]
        if self._conf is None:
            if self.num_classes is None:
                self.num_classes = int(c)
            n = self.num_classes
            z = torch.zeros((), dtype=torch.int64, device=preds.device)
            self._conf = torch.zeros(n * n, dtype=torch.int64,
                                     device=preds.device)
            self._topn, self._count = z.clone(), z.clone()
        li = labels.argmax(-1) if labels.dim() > 1 else labels.long()
        pi = preds.argmax(-1)
        w = torch.ones_like(li) if keep is None else keep.long()
        self._conf.index_add_(0, li * self.num_classes + pi, w)
        if self.top_n > 1:
            top = preds.topk(min(self.top_n, c), dim=-1).indices
            self._topn += ((top == li[:, None]).any(1).long() * w).sum()
        self._count += w.sum()
        self._host = None

    def merge(self, other: "Evaluation"):
        if other._conf is not None:
            if self._conf is None:
                self.num_classes = other.num_classes
                self._conf, self._topn, self._count = (
                    other._conf.clone(), other._topn.clone(),
                    other._count.clone())
            else:
                self._conf += other._conf.to(self._conf.device)
                self._topn += other._topn.to(self._topn.device)
                self._count += other._count.to(self._count.device)
        self._host = None
        return self

    def _read(self):
        """The counts on the host, read once after the last eval."""
        if self._host is None:
            if self._conf is None:
                self._host = (np.zeros((0, 0), np.int64), 0, 0)
            else:
                n = self.num_classes
                self._host = (self._conf.cpu().numpy().reshape(n, n),
                              int(self._topn), int(self._count))
        return self._host

    # ---------------------------------------------------------------- stats
    @property
    def confusion(self) -> np.ndarray:
        return self._read()[0]

    def accuracy(self) -> float:
        m = self.confusion
        tot = m.sum()
        return float(np.trace(m) / tot) if tot else 0.0

    def top_n_accuracy(self) -> float:
        _, hits, count = self._read()
        return hits / count if count else 0.0

    def _tp(self):
        return np.diag(self.confusion).astype(np.float64)

    def _fp(self):
        return self.confusion.sum(0) - self._tp()

    def _fn(self):
        return self.confusion.sum(1) - self._tp()

    def precision(self, cls: Optional[int] = None,
                  average: str = "macro") -> float:
        tp, fp = self._tp(), self._fp()
        if cls is not None:
            d = tp[cls] + fp[cls]
            return float(tp[cls] / d) if d else 0.0
        if average == "micro":
            d = tp.sum() + fp.sum()
            return float(tp.sum() / d) if d else 0.0
        per = np.divide(tp, tp + fp, out=np.zeros_like(tp),
                        where=(tp + fp) > 0)
        seen = (self.confusion.sum(1) + self.confusion.sum(0)) > 0
        return float(per[seen].mean()) if seen.any() else 0.0

    def recall(self, cls: Optional[int] = None,
               average: str = "macro") -> float:
        tp, fn = self._tp(), self._fn()
        if cls is not None:
            d = tp[cls] + fn[cls]
            return float(tp[cls] / d) if d else 0.0
        if average == "micro":
            d = tp.sum() + fn.sum()
            return float(tp.sum() / d) if d else 0.0
        per = np.divide(tp, tp + fn, out=np.zeros_like(tp),
                        where=(tp + fn) > 0)
        seen = (self.confusion.sum(1) + self.confusion.sum(0)) > 0
        return float(per[seen].mean()) if seen.any() else 0.0

    def f1(self, cls: Optional[int] = None, average: str = "macro") -> float:
        if cls is not None:
            p, r = self.precision(cls), self.recall(cls)
            return 2 * p * r / (p + r) if (p + r) else 0.0
        if average == "micro":
            p = self.precision(average="micro")
            r = self.recall(average="micro")
            return 2 * p * r / (p + r) if (p + r) else 0.0
        tp, fp, fn = self._tp(), self._fp(), self._fn()
        per_p = np.divide(tp, tp + fp, out=np.zeros_like(tp),
                          where=(tp + fp) > 0)
        per_r = np.divide(tp, tp + fn, out=np.zeros_like(tp),
                          where=(tp + fn) > 0)
        s = per_p + per_r
        per_f = np.divide(2 * per_p * per_r, s, out=np.zeros_like(tp),
                          where=s > 0)
        seen = (self.confusion.sum(1) + self.confusion.sum(0)) > 0
        return float(per_f[seen].mean()) if seen.any() else 0.0

    def gmeasure(self, cls: Optional[int] = None) -> float:
        p = self.precision(cls) if cls is not None \
            else self.precision(average="macro")
        r = self.recall(cls) if cls is not None \
            else self.recall(average="macro")
        return math.sqrt(p * r)

    def matthews_correlation(self) -> float:
        """Multiclass MCC (R_k statistic), like the reference."""
        c = self.confusion.astype(np.float64)
        t = c.sum()
        if t == 0:
            return 0.0
        s = np.trace(c)
        pk = c.sum(0)
        tk = c.sum(1)
        num = s * t - tk @ pk
        den = math.sqrt(max(t * t - (pk @ pk), 0)) \
            * math.sqrt(max(t * t - (tk @ tk), 0))
        return float(num / den) if den else 0.0

    def false_positive_rate(self, cls: int) -> float:
        m = self.confusion
        fp = self._fp()[cls]
        tn = m.sum() - m.sum(0)[cls] - m.sum(1)[cls] + m[cls, cls]
        return float(fp / (fp + tn)) if (fp + tn) else 0.0

    def false_negative_rate(self, cls: int) -> float:
        fn, tp = self._fn()[cls], self._tp()[cls]
        return float(fn / (fn + tp)) if (fn + tp) else 0.0

    def stats(self) -> str:
        m = self.confusion
        n = m.shape[0]
        names = self.labels_list or [str(i) for i in range(n)]
        lines = ["", "========================Evaluation Metrics"
                 "========================",
                 f" # of classes:    {n}",
                 f" Accuracy:        {self.accuracy():.4f}"]
        if self.top_n > 1:
            lines.append(f" Top {self.top_n} Accuracy:  "
                         f"{self.top_n_accuracy():.4f}")
        lines += [f" Precision:       {self.precision(average='macro'):.4f}",
                  f" Recall:          {self.recall(average='macro'):.4f}",
                  f" F1 Score:        {self.f1(average='macro'):.4f}",
                  f" MCC:             {self.matthews_correlation():.4f}",
                  "", "=========================Confusion Matrix"
                  "========================="]
        header = "     " + " ".join(f"{nm:>6}" for nm in names)
        lines.append(header)
        for i in range(n):
            lines.append(f"{names[i]:>4} " + " ".join(
                f"{int(m[i, j]):>6}" for j in range(n)))
        lines.append("=================================================="
                     "================")
        return "\n".join(lines)

    def __str__(self):
        return self.stats()


class EvaluationBinary:
    """Per-output binary metrics for multi-label sigmoid outputs
    (reference EvaluationBinary); tp/fp/fn/tn per column accumulate on
    the device in f64."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self._sums = None           # (4, C) f64: tp, fp, fn, tn
        self._host = None

    def eval(self, labels, predictions, mask=None):
        labels, p = as_pair(labels, predictions)
        preds = p > self.threshold
        lab = labels > 0.5
        if mask is None:
            w = torch.ones(lab.shape, dtype=torch.float64, device=p.device)
        else:
            w = torch.as_tensor(mask, device=p.device).to(
                torch.float64).reshape(labels.shape[0], -1).expand(
                lab.shape)
        sums = torch.stack([((preds & lab) * w).sum(0),
                            ((preds & ~lab) * w).sum(0),
                            ((~preds & lab) * w).sum(0),
                            ((~preds & ~lab) * w).sum(0)])
        self._sums = sums if self._sums is None else self._sums + sums
        self._host = None

    def _read(self):
        if self._host is None:
            self._host = self._sums.cpu().numpy()
        return self._host

    @property
    def tp(self):
        return self._read()[0]

    @property
    def fp(self):
        return self._read()[1]

    @property
    def fn(self):
        return self._read()[2]

    @property
    def tn(self):
        return self._read()[3]

    def accuracy(self, i: int) -> float:
        tot = self.tp[i] + self.fp[i] + self.fn[i] + self.tn[i]
        return float((self.tp[i] + self.tn[i]) / tot) if tot else 0.0

    def precision(self, i: int) -> float:
        d = self.tp[i] + self.fp[i]
        return float(self.tp[i] / d) if d else 0.0

    def recall(self, i: int) -> float:
        d = self.tp[i] + self.fn[i]
        return float(self.tp[i] / d) if d else 0.0

    def f1(self, i: int) -> float:
        p, r = self.precision(i), self.recall(i)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def stats(self) -> str:
        n = len(self.tp)
        lines = ["Label  Acc     Prec    Rec     F1"]
        for i in range(n):
            lines.append(f"{i:<6}{self.accuracy(i):<8.4f}"
                         f"{self.precision(i):<8.4f}"
                         f"{self.recall(i):<8.4f}{self.f1(i):<8.4f}")
        return "\n".join(lines)
