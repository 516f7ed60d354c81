"""Attention layers — port of ``deeplearning4j_tpu/nn/layers/attention.py``:
``SelfAttentionLayer``, ``LearnedSelfAttentionLayer``, ``AttentionVertex``
(1, 2 or 3 inputs) and ``RecurrentAttentionLayer``, on
:func:`multi_head_attention`.

``impl="pallas"`` routes to the flash kernels
(``kernels/flash_attention.py``: ``flash_attention_ntc`` on the (B, T, H,
D) views of the projections) where the reference takes its kernel: no
key mask and Tq == Tk. On a CUDA tensor that is K1 forward and dQ, dK/dV
backward (in f32 the narrow split-TF32 kernels up to D 128, the bf16
tensor-core kernels under ``compute_dtype=torch.bfloat16``), with no
fallback; on a CPU tensor the wrapper's plain version. Every other case —
``impl=None``, a key mask, Tq != Tk — runs the plain softmax(QKᵀ/√d)·V,
the reference's ``jax.nn.dot_product_attention`` branch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch

from ...kernels import flash_attention as _fa
from .base import Ctx, Layer, apply_time_mask


def _mha_params(layer, gen, n_in, n_out, n_heads, head_dim):
    proj = n_heads * head_dim
    return {
        "Wq": layer._make_weight(gen, (n_in, proj), n_in, proj),
        "Wk": layer._make_weight(gen, (n_in, proj), n_in, proj),
        "Wv": layer._make_weight(gen, (n_in, proj), n_in, proj),
        "Wo": layer._make_weight(gen, (proj, n_out), proj, n_out),
    }


def dot_product_attention(q, k, v, mask=None, is_causal=False):
    """Plain attention over (B, T, H, D) q/k/v (``jax.nn.
    dot_product_attention``'s math): scores in f32, a key mask (B, Tk)
    and the causal mask as -inf-like fills, output in q's dtype."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    big = torch.finfo(torch.float32).min
    if mask is not None:
        s = s.masked_fill(~mask.bool()[:, None, None, :], big)
    if is_causal:
        tq, tk = s.shape[-2], s.shape[-1]
        keep = torch.ones((tq, tk), dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~keep, big)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def multi_head_attention(params, q_in, kv_in, n_heads, head_dim, mask=None,
                         is_causal=False, impl=None, dtype=None, v_in=None):
    """q_in (B, Tq, C), kv_in (B, Tk, C) → (B, Tq, nOut); ``mask`` (B, Tk)
    masks keys; ``v_in`` (B, Tk, Cv) lets values come from another input
    than keys (AttentionVertex's 3-input form)."""
    dt = dtype or q_in.dtype
    b, tq = q_in.shape[0], q_in.shape[1]
    tk = kv_in.shape[1]
    v_src = kv_in if v_in is None else v_in
    q = (q_in @ params["Wq"].to(dt)).reshape(b, tq, n_heads, head_dim)
    k = (kv_in @ params["Wk"].to(dt)).reshape(b, tk, n_heads, head_dim)
    v = (v_src @ params["Wv"].to(dt)).reshape(b, tk, n_heads, head_dim)
    if impl in ("pallas", "pallas_interpret") and mask is None and tq == tk:
        out = _fa.flash_attention_ntc(q, k, v, causal=is_causal)
    else:
        out = dot_product_attention(q, k, v, mask, is_causal)
    return out.reshape(b, tq, n_heads * head_dim) @ params["Wo"].to(dt)


@dataclass
class SelfAttentionLayer(Layer):
    """Multi-head self attention over (B, T, C) [NTC]."""

    n_in: Optional[int] = None
    n_out: int = 0
    n_heads: int = 1
    head_size: Optional[int] = None
    project_input: bool = True
    is_causal: bool = False
    impl: Optional[str] = None  # None → plain; "pallas" → the flash kernels

    def _head_dim(self, n_in):
        return self.head_size or (self.n_out or n_in) // self.n_heads

    def init(self, gen, input_shape):
        t, c = input_shape
        c = self.n_in or c
        n_out = self.n_out or c
        params = _mha_params(self, gen, c, n_out, self.n_heads,
                             self._head_dim(c))
        return params, {}, (t, n_out)

    def apply(self, params, state, x, ctx: Ctx):
        x = self._cast_in(x)
        y = multi_head_attention(params, x, x, self.n_heads,
                                 self._head_dim(x.shape[-1]), mask=ctx.mask,
                                 is_causal=self.is_causal, impl=self.impl)
        return apply_time_mask(y, ctx.mask), state


@dataclass
class LearnedSelfAttentionLayer(Layer):
    """Attention with ``n_queries`` learned query vectors: (B, nQueries,
    nOut) whatever the sequence length."""

    n_in: Optional[int] = None
    n_out: int = 0
    n_heads: int = 1
    head_size: Optional[int] = None
    n_queries: int = 1
    impl: Optional[str] = None

    def init(self, gen, input_shape):
        t, c = input_shape
        c = self.n_in or c
        n_out = self.n_out or c
        hd = self.head_size or n_out // self.n_heads
        params = _mha_params(self, gen, c, n_out, self.n_heads, hd)
        params["Q"] = self._make_weight(gen, (self.n_queries, c), c, c)
        return params, {}, (self.n_queries, n_out)

    def apply(self, params, state, x, ctx: Ctx):
        x = self._cast_in(x)
        q = params["Q"].to(x.dtype).expand((x.shape[0],)
                                           + tuple(params["Q"].shape))
        hd = self.head_size or (self.n_out or x.shape[-1]) // self.n_heads
        y = multi_head_attention(params, q, x, self.n_heads, hd,
                                 mask=ctx.mask, impl=self.impl)
        return y, state


@dataclass
class AttentionVertex(Layer):
    """Multi-head dot-product attention as a ComputationGraph vertex
    (AttentionVertex), a multi-input layer. Inputs (all NTC): 1 → self
    attention; 2 → (queries, keys-and-values); 3 → (queries, keys,
    values). ``project_input=False`` (``n_heads == 1``) runs scaled
    dot-product attention without projections."""

    multi_input = True

    n_out: int = 0
    n_heads: int = 1
    head_size: Optional[int] = None
    project_input: bool = True
    n_in_queries: Optional[int] = None
    n_in_keys: Optional[int] = None
    n_in_values: Optional[int] = None

    @staticmethod
    def _norm_shapes(input_shapes):
        if input_shapes and not isinstance(input_shapes[0], (tuple, list)):
            input_shapes = [input_shapes]
        if len(input_shapes) == 1:
            input_shapes = list(input_shapes) * 3
        elif len(input_shapes) == 2:
            input_shapes = [input_shapes[0], input_shapes[1],
                            input_shapes[1]]
        elif len(input_shapes) != 3:
            raise ValueError(
                f"AttentionVertex takes 1-3 inputs, got {len(input_shapes)}")
        return input_shapes

    def init(self, gen, input_shapes):
        (tq, cq), (_, ck), (_, cv) = self._norm_shapes(input_shapes)
        cq = self.n_in_queries or cq
        ck = self.n_in_keys or ck
        cv = self.n_in_values or cv
        if not self.project_input:
            if self.n_heads != 1:
                raise ValueError(
                    "AttentionVertex(project_input=False) requires "
                    f"n_heads == 1, got {self.n_heads}")
            if cq != ck:
                raise ValueError(
                    "AttentionVertex(project_input=False): query size "
                    f"{cq} must equal key size {ck}")
            if self.n_out and self.n_out != cv:
                raise ValueError(
                    "AttentionVertex(project_input=False) outputs the value "
                    f"width {cv}; n_out={self.n_out} needs project_input="
                    "True (there is no projection to change the width)")
            return {}, {}, (tq, self.n_out or cv)
        n_out = self.n_out or cv
        hd = self.head_size or n_out // self.n_heads
        proj = self.n_heads * hd
        params = {
            "Wq": self._make_weight(gen, (cq, proj), cq, proj),
            "Wk": self._make_weight(gen, (ck, proj), ck, proj),
            "Wv": self._make_weight(gen, (cv, proj), cv, proj),
            "Wo": self._make_weight(gen, (proj, n_out), proj, n_out),
        }
        return params, {}, (tq, n_out)

    def apply(self, params, state, xs, ctx: Ctx):
        if not isinstance(xs, (list, tuple)):
            xs = [xs]
        xs = [self._cast_in(x) for x in xs]
        if len(xs) == 1:
            q_in = k_in = v_src = xs[0]
        elif len(xs) == 2:
            q_in, k_in = xs
            v_src = k_in
        else:
            q_in, k_in, v_src = xs
        mask = ctx.mask
        if mask is not None and (mask.dim() != 2
                                 or mask.shape[1] != k_in.shape[1]):
            mask = None  # a feature mask does not span the key axis
        if not self.project_input:
            scale = 1.0 / math.sqrt(q_in.shape[-1])
            scores = torch.einsum("bqc,bkc->bqk", q_in, k_in) * scale
            if mask is not None:
                scores = torch.where(mask[:, None, :] > 0, scores,
                                     torch.finfo(scores.dtype).min)
            return torch.softmax(scores, dim=-1) @ v_src, state
        n_out = self.n_out or v_src.shape[-1]
        hd = self.head_size or n_out // self.n_heads
        y = multi_head_attention(params, q_in, k_in, self.n_heads, hd,
                                 mask=mask, v_in=v_src)
        return y, state


@dataclass
class RecurrentAttentionLayer(Layer):
    """A SimpleRnn cell whose input at each step also carries attention
    over the whole input sequence (RecurrentAttentionLayer)."""

    n_in: Optional[int] = None
    n_out: int = 0
    n_heads: int = 1
    activation: Any = "tanh"

    def init(self, gen, input_shape):
        t, c = input_shape
        c = self.n_in or c
        hd = self.n_out // self.n_heads
        params = _mha_params(self, gen, c, self.n_out, self.n_heads,
                             max(hd, 1))
        params["W"] = self._make_weight(gen, (c, self.n_out), c, self.n_out)
        params["RW"] = self._make_weight(gen, (self.n_out, self.n_out),
                                         self.n_out, self.n_out)
        params["Wa"] = self._make_weight(gen, (self.n_out, self.n_out),
                                         self.n_out, self.n_out)
        params["b"] = self._make_bias((self.n_out,))
        return params, {}, (t, self.n_out)

    def apply(self, params, state, x, ctx: Ctx):
        x = self._cast_in(x)
        act = self.activation_fn()
        hd = max(self.n_out // self.n_heads, 1)
        attn = multi_head_attention(params, x, x, self.n_heads, hd,
                                    mask=ctx.mask)
        w, rw, wa, b = (params[k].to(x.dtype) for k in ("W", "RW", "Wa", "b"))
        xw = x @ w + b
        aw = attn @ wa
        h = torch.zeros((x.shape[0], self.n_out), dtype=x.dtype,
                        device=x.device)
        hs = []
        for t in range(x.shape[1]):
            h_new = act(xw[:, t] + aw[:, t] + h @ rw)
            if ctx.mask is not None:
                h_new = torch.where(ctx.mask[:, t, None] > 0, h_new, h)
            h = h_new
            hs.append(h)
        return apply_time_mask(torch.stack(hs, dim=1), ctx.mask), state
