"""Gradient sharing — threshold-encoded sparse gradient exchange. Port of
``deeplearning4j_tpu/parallel/grad_sharing.py``
(``org.deeplearning4j.optimize.solvers.accumulation.
EncodedGradientsAccumulator`` and the reference's
``AdaptiveThresholdAlgorithm``): each worker quantizes its update to
±threshold sparse tokens with residual error feedback, shares the encoded
stream, and applies the decoded sum.

Host numpy over the port's native codec (``utils/native.py``
``threshold_encode`` / ``threshold_decode``, built from the repository's
C++ source). A caller on the card moves its update to the host first
(``.cpu().numpy()``) and the decoded result back
(``torch.from_numpy(...).to(device)``); nothing here touches a device.
Within one host's ranks the dense all-reduce of ``ParallelWrapper`` is the
path; this codec is for the slow-interconnect regime the reference built
it for.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from ..utils.native import threshold_decode, threshold_encode


class AdaptiveThreshold:
    """Adjust the threshold toward a target encoded share (reference
    AdaptiveThresholdAlgorithm: keep ~1e-3 of entries encoded)."""

    def __init__(self, initial: float = 1e-3, target_sparsity: float = 1e-3,
                 decay: float = 1.2, min_threshold: float = 1e-6,
                 max_threshold: float = 1.0):
        self.threshold = initial
        self.target = target_sparsity
        self.decay = decay
        self.min = min_threshold
        self.max = max_threshold

    def update(self, encoded: int, total: int):
        frac = encoded / max(total, 1)
        if frac > 4 * self.target:
            self.threshold = min(self.threshold * self.decay, self.max)
        elif frac < self.target / 4:
            self.threshold = max(self.threshold / self.decay, self.min)
        return self.threshold


class GradientSharingAccumulator:
    """N-worker accumulator: encode each worker's flat gradient, exchange
    (in-process here; the transport is pluggable), decode-sum, keep the
    residuals.

    ``transport`` is a callable ``List[np.ndarray(int64)] -> List[np.ndarray]``
    that delivers every worker's tokens to every worker (default: a local
    all-gather).
    """

    def __init__(self, n_params: int, n_workers: int, threshold: float = 1e-3,
                 adaptive: bool = True,
                 transport: Optional[Callable] = None):
        self.n_params = n_params
        self.n_workers = n_workers
        self.residuals = [np.zeros(n_params, np.float32)
                          for _ in range(n_workers)]
        self.adaptive = AdaptiveThreshold(threshold) if adaptive else None
        self.threshold = threshold
        self.transport = transport or (lambda msgs: msgs)

    def step(self, worker_grads: List[np.ndarray]) -> np.ndarray:
        """One sharing round -> the dense mean update every worker applies."""
        if len(worker_grads) != self.n_workers:
            raise ValueError(f"expected {self.n_workers} gradients, got "
                             f"{len(worker_grads)}")
        msgs = []
        encoded_total = 0
        for w, g in enumerate(worker_grads):
            tokens = threshold_encode(np.asarray(g, np.float32).ravel(),
                                      self.residuals[w], self.threshold)
            encoded_total += tokens.size
            msgs.append(tokens)
        delivered = self.transport(msgs)
        update = np.zeros(self.n_params, np.float32)
        for tokens in delivered:
            update += threshold_decode(tokens, self.threshold, self.n_params)
        if self.adaptive is not None:
            self.threshold = self.adaptive.update(
                encoded_total, self.n_params * self.n_workers)
        return update / self.n_workers

    def residual_norm(self, worker: int) -> float:
        return float(np.linalg.norm(self.residuals[worker]))
