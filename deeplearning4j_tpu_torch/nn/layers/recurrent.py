"""Recurrent layers — port of ``deeplearning4j_tpu/nn/layers/recurrent.py``:
SimpleRnn, LSTM, GravesLSTM (peepholes), GRU, Bidirectional,
GravesBidirectionalLSTM, LastTimeStep, TimeDistributed, ConvLSTM2D.

Layout is NTC (batch, time, channels). The input projection x @ W + b for
all steps is one (B·T, nIn) × (nIn, gates·H) product up front; a Python
loop over t then runs only the small recurrent product and the gate math
(``_cell``, shared with :meth:`BaseRecurrent.step_apply`, the streaming
single step of ``MultiLayerNetwork.rnn_time_step``). Gate order is
[i, f, o, g] for the LSTM and [r, z, n] for the GRU; params are the
reference's ``W``, ``RW``, ``b``, ``pI``/``pF``/``pO`` and GRU's optional
``rb``.

``LSTM(fused=True)`` runs the whole sequence through the K4 kernel
(``kernels/fused_lstm.py``) where the reference dispatches to its Pallas
kernel: no mask, tanh/sigmoid, and the kernel's capacity predicate true.
``fused="auto"`` means the scan, as in the reference.

Masking: ``ctx.mask`` (B, T) freezes the state on padded steps and zeroes
their outputs.

``ConvLSTM2D`` hoists its input convolution over all steps into one
(B·T) conv and loops over t for the recurrent conv (stride 1, SAME on
the output grid), in plain torch as in the reference (K4 is a dense
LSTM kernel).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from .. import activations as _act
from ...kernels import fused_lstm as _k4
from .base import Ctx, Layer, apply_time_mask
from .conv import _pair, conv_nd, nd_pads


def _keep(mask_t, new, old):
    """``new`` where the step is valid, ``old`` on padded rows."""
    return torch.where(mask_t[:, None] > 0, new, old)


def _scan(cell, carry, xs, mask):
    """Run ``cell(carry, x_t) -> (carry, y_t)`` over t of (B, T, ·) ``xs``;
    masked rows keep their carry. Returns the stacked (B, T, H) outputs."""
    ys = []
    for t in range(xs.shape[1]):
        new, y = cell(carry, xs[:, t])
        if mask is not None:
            mt = mask[:, t]
            if isinstance(new, tuple):
                new = tuple(_keep(mt, n, o) for n, o in zip(new, carry))
            else:
                new = _keep(mt, new, carry)
            y = new[0] if isinstance(new, tuple) else new
        carry = new
        ys.append(y)
    return torch.stack(ys, dim=1)


@dataclass
class BaseRecurrent(Layer):
    n_in: Optional[int] = None
    n_out: int = 0
    activation: Any = "tanh"

    # Subclasses implement _cell(params, carry, xproj) -> (new_carry, y);
    # apply()'s loop and step_apply() share it, so the cell math lives once.

    def init_carry(self, batch: int, dtype, device=None):
        return torch.zeros((batch, self.n_out), dtype=dtype, device=device)

    def step_apply(self, params, carry, xt, ctx: Ctx):
        """One timestep of stateful inference: xt (B, C) → (y (B, H),
        carry) — the per-layer state of ``rnn_time_step``."""
        xt = self._cast_in(xt)
        xproj = xt @ params["W"].to(xt.dtype) + params["b"].to(xt.dtype)
        new_carry, y = self._cell(params, carry, xproj)
        # keep the carry dtype stable across steps
        if isinstance(carry, tuple):
            new_carry = tuple(n.to(o.dtype) for n, o in zip(new_carry, carry))
        else:
            new_carry = new_carry.to(carry.dtype)
        return y, new_carry

    def _project(self, params, x):
        """The hoisted input projection x @ W + b, in the compute dtype."""
        x = self._cast_in(x)
        return x, x @ params["W"].to(x.dtype) + params["b"].to(x.dtype)

    def apply(self, params, state, x, ctx: Ctx):
        x, xw = self._project(params, x)
        carry = self.init_carry(x.shape[0], x.dtype, x.device)
        y = _scan(lambda c, xt: self._cell(params, c, xt), carry, xw,
                  ctx.mask)
        return apply_time_mask(y, ctx.mask), state


@dataclass
class SimpleRnn(BaseRecurrent):
    """h_t = act(x_t W + h_{t-1} R + b)."""

    def init(self, gen, input_shape):
        t, c = input_shape
        c = self.n_in or c
        params = {
            "W": self._make_weight(gen, (c, self.n_out), c, self.n_out),
            "RW": self._make_weight(gen, (self.n_out, self.n_out),
                                    self.n_out, self.n_out),
            "b": self._make_bias((self.n_out,)),
        }
        return params, {}, (t, self.n_out)

    def _cell(self, params, h_prev, xproj):
        """xproj = x_t @ W + b already applied."""
        h = self.activation_fn()(xproj + h_prev @ params["RW"].to(xproj.dtype))
        return h, h


@dataclass
class LSTM(BaseRecurrent):
    """Standard LSTM (no peepholes), gate order [i, f, o, g] like the
    reference. ``forget_gate_bias``: DL4J initializes the forget bias to
    1.0. ``fused``: True runs the K4 kernel where it applies (a CPU tensor
    takes its plain version), False and "auto" the scan."""

    forget_gate_bias: float = 1.0
    gate_activation: Any = "sigmoid"
    fused: Any = "auto"

    def _has_peepholes(self):
        return False

    def _can_fuse(self, mask) -> bool:
        if self.fused is False or mask is not None:
            return False
        if self.activation != "tanh" or self.gate_activation != "sigmoid":
            return False
        return self.fused is True

    def init(self, gen, input_shape):
        t, c = input_shape
        c = self.n_in or c
        h = self.n_out
        params = {
            "W": self._make_weight(gen, (c, 4 * h), c, h),
            "RW": self._make_weight(gen, (h, 4 * h), h, h),
        }
        b = torch.zeros((4 * h,), dtype=self.dtype)
        b[h:2 * h] = self.forget_gate_bias
        params["b"] = b
        if self._has_peepholes():
            for k in ("pI", "pF", "pO"):
                params[k] = torch.zeros((h,), dtype=self.dtype)
        return params, {}, (t, h)

    def _cell(self, params, carry, xproj):
        """xproj = x_t @ W + b; carry (h, c); returns ((h', c'), h')."""
        h = self.n_out
        act = self.activation_fn()
        gate_act = _act.get(self.gate_activation)
        h_prev, c_prev = carry
        z = xproj + h_prev @ params["RW"].to(xproj.dtype)
        zi, zf = z[:, :h], z[:, h:2 * h]
        zo, zg = z[:, 2 * h:3 * h], z[:, 3 * h:]
        if self._has_peepholes():
            zi = zi + c_prev * params["pI"].to(xproj.dtype)
            zf = zf + c_prev * params["pF"].to(xproj.dtype)
        c_new = gate_act(zf) * c_prev + gate_act(zi) * act(zg)
        if self._has_peepholes():
            zo = zo + c_new * params["pO"].to(xproj.dtype)
        h_new = gate_act(zo) * act(c_new)
        return (h_new, c_new), h_new

    def apply(self, params, state, x, ctx: Ctx):
        h = self.n_out
        if self._can_fuse(ctx.mask) and _k4.fits_smem(x.shape[0], h):
            x, xw = self._project(params, x)
            rw = params["RW"].to(x.dtype)
            if self._has_peepholes():
                peep = torch.stack([params["pI"], params["pF"],
                                    params["pO"]]).float()
            else:
                peep = torch.zeros((3, h), dtype=torch.float32,
                                   device=x.device)
            z0 = torch.zeros((x.shape[0], h), dtype=x.dtype, device=x.device)
            return _k4.fused_lstm_seq(xw, rw, peep, z0, z0), state
        return super().apply(params, state, x, ctx)

    def init_carry(self, batch, dtype, device=None):
        z = torch.zeros((batch, self.n_out), dtype=dtype, device=device)
        return (z, z.clone())


@dataclass
class GravesLSTM(LSTM):
    """LSTM with peephole connections (Graves 2013) — the reference's
    GravesLSTM: diagonal cell→gate weights pI, pF (on c_{t-1}), pO (on
    c_t)."""

    def _has_peepholes(self):
        return True


@dataclass
class GRU(BaseRecurrent):
    """GRU, gate order [r, z, n]. ``reset_after=True`` (keras v3): n uses
    r * (h @ RWn + rb_n), one (h, 3H) recurrent product per step;
    ``reset_after=False`` (classic GRU): n uses (r * h) @ RWn. An optional
    recurrent bias ``rb`` (a keras import) is added inside the reset
    gate's product."""

    gate_activation: Any = "sigmoid"
    reset_after: bool = True

    def init(self, gen, input_shape):
        t, c = input_shape
        c = self.n_in or c
        h = self.n_out
        params = {
            "W": self._make_weight(gen, (c, 3 * h), c, h),
            "RW": self._make_weight(gen, (h, 3 * h), h, h),
            "b": torch.zeros((3 * h,), dtype=self.dtype),
        }
        return params, {}, (t, h)

    def _cell(self, params, h_prev, xproj):
        h = self.n_out
        act = self.activation_fn()
        gate_act = _act.get(self.gate_activation)
        rw = params["RW"].to(xproj.dtype)
        rb = params["rb"].to(xproj.dtype) if "rb" in params else None
        if self.reset_after:
            hr = h_prev @ rw
            if rb is not None:
                hr = hr + rb
            r = gate_act(xproj[:, :h] + hr[:, :h])
            z = gate_act(xproj[:, h:2 * h] + hr[:, h:2 * h])
            n = act(xproj[:, 2 * h:] + r * hr[:, 2 * h:])
        else:
            hg = h_prev @ rw[:, :2 * h]
            r = gate_act(xproj[:, :h] + hg[:, :h])
            z = gate_act(xproj[:, h:2 * h] + hg[:, h:2 * h])
            n = act(xproj[:, 2 * h:] + (r * h_prev) @ rw[:, 2 * h:])
        h_new = (1 - z) * n + z * h_prev
        return h_new, h_new


class BidirectionalMode:
    CONCAT = "concat"
    ADD = "add"
    MUL = "mul"
    AVERAGE = "average"


def _lengths(mask):
    return (mask > 0).sum(dim=1).long()


@dataclass
class Bidirectional(Layer):
    """Wraps a recurrent layer; runs a forward and a time-reversed copy
    (reference ``recurrent.Bidirectional(Mode, layer)``). The mask-aware
    reversal flips only the valid prefix of each sequence.

    ``last_step=True`` is keras ``Bidirectional(return_sequences=False)``:
    merge(fwd state at the last valid step, bwd state after its full
    reverse pass — at t = 0 of the re-aligned bwd sequence)."""

    fwd: Any = None
    mode: str = BidirectionalMode.CONCAT
    last_step: bool = False

    def __init__(self, fwd=None, mode=BidirectionalMode.CONCAT,
                 last_step=False, **kw):
        super().__init__(**kw)
        self.fwd = fwd
        self.mode = mode
        self.last_step = last_step

    def init(self, gen, input_shape):
        pf, sf, out = self.fwd.init(gen, input_shape)
        pb, sb, _ = self.fwd.init(gen, input_shape)
        t, h = out
        h_out = 2 * h if self.mode == BidirectionalMode.CONCAT else h
        out = (h_out,) if self.last_step else (t, h_out)
        return {"fwd": pf, "bwd": pb}, {"fwd": sf, "bwd": sb}, out

    def _reverse(self, x, mask):
        if mask is None:
            return torch.flip(x, dims=(1,))
        # flip the valid prefix: index t -> len-1-t for t < len
        t_idx = torch.arange(x.shape[1], device=x.device)
        rev = torch.clamp(_lengths(mask)[:, None] - 1 - t_idx[None, :], 0,
                          x.shape[1] - 1)
        return torch.take_along_dim(x, rev[:, :, None], dim=1)

    def apply(self, params, state, x, ctx: Ctx):
        yf, sf = self.fwd.apply(params["fwd"], state["fwd"], x, ctx)
        xr = self._reverse(x, ctx.mask)
        yb, sb = self.fwd.apply(params["bwd"], state["bwd"], xr, ctx)
        yb = self._reverse(yb, ctx.mask)
        if self.last_step:
            if ctx.mask is None:
                yf = yf[:, -1]
            else:  # the last VALID fwd step
                idx = torch.clamp(_lengths(ctx.mask) - 1, min=0)
                yf = torch.take_along_dim(yf, idx[:, None, None], dim=1)[:, 0]
            yb = yb[:, 0]
        if self.mode == BidirectionalMode.CONCAT:
            y = torch.cat([yf, yb], dim=-1)
        elif self.mode == BidirectionalMode.ADD:
            y = yf + yb
        elif self.mode == BidirectionalMode.MUL:
            y = yf * yb
        else:
            y = 0.5 * (yf + yb)
        return y, {"fwd": sf, "bwd": sb}


@dataclass
class GravesBidirectionalLSTM(Bidirectional):
    """Bidirectional(CONCAT, GravesLSTM), the reference's parity alias."""

    def __init__(self, n_in=None, n_out=0, activation="tanh", **kw):
        super().__init__(fwd=GravesLSTM(n_in=n_in, n_out=n_out,
                                        activation=activation),
                         mode=BidirectionalMode.CONCAT, **kw)


@dataclass
class LastTimeStep(Layer):
    """Wraps a recurrent layer, returning only the last (unmasked) step."""

    inner: Any = None

    def __init__(self, inner=None, **kw):
        super().__init__(**kw)
        self.inner = inner

    def init(self, gen, input_shape):
        p, s, out = self.inner.init(gen, input_shape)
        return p, s, (out[-1],)

    def apply(self, params, state, x, ctx: Ctx):
        y, s = self.inner.apply(params, state, x, ctx)
        if ctx.mask is None:
            return y[:, -1], s
        idx = torch.clamp(_lengths(ctx.mask) - 1, 0, y.shape[1] - 1)
        return torch.take_along_dim(y, idx[:, None, None], dim=1)[:, 0], s


@dataclass
class TimeDistributed(Layer):
    """Applies a feed-forward layer independently at each timestep."""

    inner: Any = None

    def __init__(self, inner=None, **kw):
        super().__init__(**kw)
        self.inner = inner

    def init(self, gen, input_shape):
        p, s, out = self.inner.init(gen, input_shape[1:])
        return p, s, (input_shape[0],) + tuple(out)

    def apply(self, params, state, x, ctx: Ctx):
        b, t = x.shape[0], x.shape[1]
        y, s = self.inner.apply(params, state,
                                x.reshape((b * t,) + tuple(x.shape[2:])), ctx)
        return y.reshape((b, t) + tuple(y.shape[1:])), s


@dataclass
class ConvLSTM2D(Layer):
    """Convolutional LSTM (Shi et al. 2015) over (B, T, H, W, C)
    sequences (the keras ``ConvLSTM2D`` the reference imports). Gate order
    [i, f, o, g]; W (kh, kw, C, 4F), RW (kh, kw, F, 4F), b (4F,) with the
    forget gate's slice at ``forget_gate_bias``.

    ``return_sequences=True`` yields (B, T, H', W', F); False yields the
    (masked) last step (B, H', W', F)."""

    n_in: Optional[int] = None
    n_out: int = 0
    kernel_size: Any = (3, 3)
    stride: Any = (1, 1)
    convolution_mode: str = "same"   # "same" | "truncate" (keras "valid")
    activation: Any = "tanh"
    gate_activation: Any = "sigmoid"
    forget_gate_bias: float = 1.0
    return_sequences: bool = True
    has_bias: bool = True

    def _out_hw(self, h, w):
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        if self.convolution_mode == "same":
            return -(-h // sh), -(-w // sw)
        return (h - kh) // sh + 1, (w - kw) // sw + 1

    def init(self, gen, input_shape):
        t, h, w, c = input_shape
        c = self.n_in or c
        kh, kw = _pair(self.kernel_size)
        f = self.n_out
        params = {
            "W": self._make_weight(gen, (kh, kw, c, 4 * f), kh * kw * c,
                                   kh * kw * f),
            "RW": self._make_weight(gen, (kh, kw, f, 4 * f), kh * kw * f,
                                    kh * kw * f),
        }
        if self.has_bias:
            b = torch.zeros((4 * f,), dtype=self.dtype)
            b[f:2 * f] = self.forget_gate_bias
            params["b"] = b
        ho, wo = self._out_hw(h, w)
        out = (t, ho, wo, f) if self.return_sequences else (ho, wo, f)
        return params, {}, out

    def apply(self, params, state, x, ctx: Ctx):
        x = self._cast_in(x)
        bsz, t = x.shape[0], x.shape[1]
        f = self.n_out
        kernel, stride = _pair(self.kernel_size), _pair(self.stride)
        frames = x.reshape((bsz * t,) + tuple(x.shape[2:]))
        pad = "same" if self.convolution_mode == "same" else "valid"
        xw = conv_nd(frames, params["W"].to(x.dtype), stride, None,
                     nd_pads(frames, kernel, stride, (1, 1), pad, pad))
        if self.has_bias:
            xw = xw + params["b"].to(x.dtype)
        ho, wo = xw.shape[1], xw.shape[2]
        xw = xw.reshape(bsz, t, ho, wo, 4 * f)
        rw = params["RW"].to(x.dtype)
        act, gate_act = self.activation_fn(), _act.get(self.gate_activation)
        h = torch.zeros((bsz, ho, wo, f), dtype=x.dtype, device=x.device)
        c = h
        hs = []
        for step in range(t):
            z = xw[:, step] + conv_nd(h, rw, (1, 1), None,
                                      nd_pads(h, kernel, (1, 1), (1, 1),
                                              "same", "same"))
            i = gate_act(z[..., :f])
            fg = gate_act(z[..., f:2 * f])
            o = gate_act(z[..., 2 * f:3 * f])
            g = act(z[..., 3 * f:])
            c_new = fg * c + i * g
            h_new = o * act(c_new)
            if ctx.mask is not None:
                keep = ctx.mask[:, step, None, None, None] > 0
                h_new = torch.where(keep, h_new, h)
                c_new = torch.where(keep, c_new, c)
            h, c = h_new, c_new
            hs.append(h)
        if not self.return_sequences:
            return h, state    # masked steps froze the state
        y = torch.stack(hs, dim=1)
        if ctx.mask is not None:
            y = y * ctx.mask[:, :, None, None, None].to(y.dtype)
        return y, state
