"""RegressionEvaluation — port of ``deeplearning4j_tpu/eval/regression.py``
(``org.nd4j.evaluation.regression.RegressionEvaluation``: MSE, MAE, RMSE,
RSE, pearson correlation, R^2, per column).

The streaming sums accumulate on the predictions' device in f64 (a mask
weights rows instead of dropping them) and are read to the host once, by
the first metric getter, so batches merge exactly as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .classification import as_pair

_SUMS = ("err2", "abs_err", "label", "label2", "pred", "pred2", "lp")


class RegressionEvaluation:
    def __init__(self, n_columns=None, column_names=None):
        self.n_columns = n_columns
        self.column_names = column_names
        self._dev = None            # (7, C) f64 sums and the row count
        self._count = None
        self._host = None

    def eval(self, labels, predictions, mask=None):
        y, p = as_pair(labels, predictions)
        y, p = y.to(torch.float64), p.to(torch.float64)
        keep = None
        if y.dim() == 3:
            y = y.reshape(-1, y.shape[-1])
            p = p.reshape(-1, p.shape[-1])
            if mask is not None:
                keep = (torch.as_tensor(mask, device=p.device).reshape(-1)
                        > 0)[:, None]
        d = p - y
        rows = [d * d, d.abs(), y, y * y, p, p * p, y * p]
        if keep is not None:
            rows = [torch.where(keep, r, 0.0) for r in rows]
        sums = torch.stack([r.sum(0) for r in rows])
        n = keep.sum() if keep is not None else torch.full(
            (), y.shape[0], dtype=torch.int64, device=y.device)
        if self._dev is None:
            self.n_columns = y.shape[-1]
            self._dev, self._count = sums, n
        else:
            self._dev, self._count = self._dev + sums, self._count + n
        self._host = None

    def merge(self, other):
        if other._dev is not None:
            if self._dev is None:
                self.n_columns = other.n_columns
                self._dev, self._count = other._dev, other._count
            else:
                self._dev = self._dev + other._dev.to(self._dev.device)
                self._count = self._count + other._count.to(
                    self._count.device)
        self._host = None
        return self

    def _read(self):
        if self._host is None:
            sums = self._dev.cpu().numpy()
            self._host = ({k: sums[i] for i, k in enumerate(_SUMS)},
                          int(self._count))
        return self._host

    @property
    def _sums(self):
        return None if self._dev is None else self._read()[0]

    @property
    def n(self) -> int:
        return 0 if self._dev is None else self._read()[1]

    def mean_squared_error(self, col: int) -> float:
        return float(self._sums["err2"][col] / self.n)

    def mean_absolute_error(self, col: int) -> float:
        return float(self._sums["abs_err"][col] / self.n)

    def root_mean_squared_error(self, col: int) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def relative_squared_error(self, col: int) -> float:
        s = self._sums
        mean_label = s["label"][col] / self.n
        denom = s["label2"][col] - 2 * mean_label * s["label"][col] \
            + self.n * mean_label ** 2
        return float(s["err2"][col] / denom) if denom else 0.0

    def pearson_correlation(self, col: int) -> float:
        s = self._sums
        n = self.n
        cov = s["lp"][col] - s["label"][col] * s["pred"][col] / n
        vl = s["label2"][col] - s["label"][col] ** 2 / n
        vp = s["pred2"][col] - s["pred"][col] ** 2 / n
        d = np.sqrt(max(vl * vp, 0.0))
        return float(cov / d) if d else 0.0

    def r_squared(self, col: int) -> float:
        return 1.0 - self.relative_squared_error(col)

    def average_mean_squared_error(self) -> float:
        return float(np.mean([self.mean_squared_error(i)
                              for i in range(self.n_columns)]))

    def average_mean_absolute_error(self) -> float:
        return float(np.mean([self.mean_absolute_error(i)
                              for i in range(self.n_columns)]))

    def average_root_mean_squared_error(self) -> float:
        return float(np.mean([self.root_mean_squared_error(i)
                              for i in range(self.n_columns)]))

    def average_r_squared(self) -> float:
        return float(np.mean([self.r_squared(i)
                              for i in range(self.n_columns)]))

    def stats(self) -> str:
        names = self.column_names or [f"col_{i}"
                                      for i in range(self.n_columns)]
        lines = [f"{'Column':<12}{'MSE':>12}{'MAE':>12}{'RMSE':>12}"
                 f"{'RSE':>12}{'PC':>12}{'R^2':>12}"]
        for i in range(self.n_columns):
            lines.append(f"{names[i]:<12}{self.mean_squared_error(i):>12.5f}"
                         f"{self.mean_absolute_error(i):>12.5f}"
                         f"{self.root_mean_squared_error(i):>12.5f}"
                         f"{self.relative_squared_error(i):>12.5f}"
                         f"{self.pearson_correlation(i):>12.5f}"
                         f"{self.r_squared(i):>12.5f}")
        return "\n".join(lines)

    def __str__(self):
        return self.stats()
