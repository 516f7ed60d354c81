"""Normalization layers — port of ``deeplearning4j_tpu/nn/layers/norm.py``:
BatchNorm (with its ``fused`` dispatch to K3), LayerNorm, RMSNorm, LRN.

BatchNorm keeps running mean/var in layer ``state``, threaded through
train steps and used verbatim at inference. Dispatch of ``fused``:

- ``False``: the plain path (shifted one-pass moments, autograd through
  them);
- ``True``: the K3 kernels (``kernels/fused_ops.py``) at inference and in
  training, for every activation they support; a CPU tensor takes their
  plain versions, which is the port's analogue of the reference's
  interpret mode;
- ``"auto"`` (default): the inference kernel when the activation is not
  identity and x is a CUDA tensor; training stays on the plain path, as
  in the reference.

Inside a parallel step (a batch group on ``ctx.groups``) the training
statistics are the global batch's, as the reference's BN over a
dp-sharded batch computes them: each rank's shifted sums (the plain
path's, and K3's stats kernel's rows 0-1) are summed over the group
before ``fused_ops.global_moments`` finishes them, and their cotangents
in the backward. The running mean, which shifts the sums, is the same on every
rank, so the running statistics stay replicated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from ...kernels import fused_ops
from .base import Ctx, Layer


@dataclass
class BatchNormalization(Layer):
    """Normalizes the trailing (channel) axis — works for FF (B,C) and
    conv NHWC (B,H,W,C) inputs alike."""

    n_out: Optional[int] = None  # channels; inferred
    decay: float = 0.9           # DL4J's `decay` for running stats EMA
    eps: float = 1e-5
    gamma_init: float = 1.0
    beta_init: float = 0.0
    lock_gamma_beta: bool = False
    use_log_std: bool = False
    # DL4J BatchNormalization inherits activation from FeedForwardLayer;
    # the fused kernels apply it in the same pass
    activation: Any = "identity"
    fused: Any = "auto"

    def _fuse_ok(self, supported, x) -> bool:
        """Shared fused/auto gating; ``supported`` is the kernel's
        activation predicate (inference and training support differ)."""
        if self.fused is False or not supported(self.activation):
            return False
        if self.fused is True:
            return True
        # "auto" fuses only when there IS an activation to fuse
        return self.activation != "identity" and x.device.type == "cuda"

    def _can_fuse(self, x) -> bool:
        return self._fuse_ok(fused_ops.supported_activation, x)

    def _can_fuse_train(self, x) -> bool:
        # opt-in only (fused=True), never "auto", as in the reference
        if self.fused is not True:
            return False
        return self._fuse_ok(fused_ops.supported_train_activation, x)

    def init(self, gen, input_shape):
        c = self.n_out or input_shape[-1]
        params = {}
        if not self.lock_gamma_beta:
            params = {"gamma": torch.full((c,), self.gamma_init,
                                          dtype=self.dtype),
                      "beta": torch.full((c,), self.beta_init,
                                         dtype=self.dtype)}
        state = {"mean": torch.zeros((c,), dtype=torch.float32),
                 "var": torch.ones((c,), dtype=torch.float32)}
        return params, state, input_shape

    def _rows(self, x):
        """The (N, C) view the kernels take; never a hidden copy."""
        if not x.is_contiguous():
            raise ValueError("BatchNormalization's fused path takes a "
                             "contiguous (..., C) input")
        return x.view(-1, x.shape[-1])

    def _gamma_beta(self, params, c, device):
        if self.lock_gamma_beta:
            return (torch.ones((c,), dtype=torch.float32, device=device),
                    torch.zeros((c,), dtype=torch.float32, device=device))
        return params["gamma"], params["beta"]

    def apply(self, params, state, x, ctx: Ctx):
        axes = tuple(range(x.dim() - 1))
        if ctx.train:
            c = state["mean"].detach()
            group = ctx.groups.batch
            if self._can_fuse_train(x):
                gamma, beta = self._gamma_beta(params, x.shape[-1], x.device)
                y, mean, var = fused_ops.fused_bn_act_train(
                    self._rows(x), gamma, beta, c, self.eps, self.activation,
                    group)
                new_state = {
                    "mean": self.decay * state["mean"]
                            + (1 - self.decay) * mean,
                    "var": self.decay * state["var"]
                           + (1 - self.decay) * var,
                }
                return y.view(x.shape), new_state
            # one-pass moments shifted by the running mean c: the
            # subtraction cancels (std² + drift²) − drift², not the
            # catastrophic E[x²] − mean²; the clamp guards first-batch
            # roundoff while c is still cold
            xf = x.float()
            d = xf - c
            if group is None:
                dmean = torch.mean(d, dim=axes)
                d2mean = torch.mean(d * d, dim=axes)
                mean = c + dmean
                var = torch.clamp(d2mean - dmean * dmean, min=0.0)
            else:
                mean, var = fused_ops.global_moments(
                    torch.sum(d, dim=axes), torch.sum(d * d, dim=axes), c,
                    d.numel() // d.shape[-1], group)
            new_state = {
                "mean": (self.decay * state["mean"]
                         + (1 - self.decay) * mean).detach(),
                "var": (self.decay * state["var"]
                        + (1 - self.decay) * var).detach(),
            }
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
            if self._can_fuse(x):
                # inference BN+act folds to act(x*scale + shift): one pass
                inv = torch.rsqrt(var + self.eps)
                scale, shift = inv, -mean * inv
                if not self.lock_gamma_beta:
                    scale = inv * params["gamma"].float()
                    shift = params["beta"].float() - mean * scale
                y = fused_ops.fused_bn_act(self._rows(x), scale, shift,
                                           self.activation)
                return y.view(x.shape), new_state
        # normalize as one multiply-add with per-channel scale/shift
        inv = torch.rsqrt(var + self.eps)
        if not self.lock_gamma_beta:
            scale = inv * params["gamma"].float()
            shift = params["beta"].float() - mean * scale
        else:
            scale, shift = inv, -mean * inv
        y = x.float() * scale + shift
        if self.activation != "identity":
            from .. import activations as _a
            y = _a.get(self.activation)(y)
        return y.to(x.dtype), new_state


@dataclass
class LayerNormalization(Layer):
    """LayerNorm over the channel axis (SameDiff standardize + gain/bias)."""

    eps: float = 1e-5
    use_bias: bool = True

    def init(self, gen, input_shape):
        c = input_shape[-1]
        params = {"gamma": torch.ones((c,), dtype=self.dtype)}
        if self.use_bias:
            params["beta"] = torch.zeros((c,), dtype=self.dtype)
        return params, {}, input_shape

    def apply(self, params, state, x, ctx: Ctx):
        xf = x.float()
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * params["gamma"].float()
        if self.use_bias:
            y = y + params["beta"].float()
        return y.to(x.dtype), state


@dataclass
class RMSNorm(Layer):
    """RMS normalization (no mean subtraction) — transformer staple."""

    eps: float = 1e-6

    def init(self, gen, input_shape):
        return {"gamma": torch.ones((input_shape[-1],), dtype=self.dtype)}, \
            {}, input_shape

    def apply(self, params, state, x, ctx: Ctx):
        xf = x.float()
        ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + self.eps) * params["gamma"].float()
        return y.to(x.dtype), state


@dataclass
class LocalResponseNormalization(Layer):
    """LRN across channels (AlexNet-era). NHWC; elementwise + window."""

    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75

    def init(self, gen, input_shape):
        return {}, {}, input_shape

    def apply(self, params, state, x, ctx: Ctx):
        xf = x.float()
        sq = torch.square(xf)
        half = self.n // 2
        pad = torch.nn.functional.pad(sq, (half, half))
        c = x.shape[-1]
        win = sum(pad[..., i:i + c] for i in range(self.n))
        y = xf / torch.pow(self.k + self.alpha * win, self.beta)
        return y.to(x.dtype), state

    def has_params(self):
        return False
