"""Ring attention — sequence parallelism for long sequences; port of
``deeplearning4j_tpu/parallel/ring_attention.py``.

Queries stay on their rank; the key/value blocks travel around the sp
ring (``_dist.shift``: a send to the next rank and a receive from the
previous one, the cotangents travelling back the other way), and each
rank merges the partials it computes in (out, lse) form by ``logaddexp``
of their log-sum-exps — exact, equal to full attention, with O(T/n)
memory a rank.

- Hop 0 attends the rank's own block: the query and key blocks are
  aligned, so plain causal attention applies.
- Later hops hold the block of source rank ``(i - hop) mod n``: below
  the local rank it is a full (unmasked) block; above it lies entirely
  above the diagonal and contributes the zero partial (0, −inf) — no
  products run for it.
- The local attention is K1 through its lse
  (``kernels.flash_attention``, the (B, T, H, D) layout, no copies):
  the merge weights each partial by exp(lse_i − lse), so the backward
  feeds a nonzero lse cotangent into the flash backward (dQ and dK/dV
  with delta − dlse). CUDA tensors always take K1, whatever their
  length and ``use_flash``: the card has no plain arm. On CPU tensors
  ``use_flash=True`` runs K1's plain version, and ``False`` or
  ``"auto"`` the reference's plain f32 attention with its lse.

:func:`ring_hop` is the per-hop step (attend one key block, merge): the
ranks call it, and a single device can call it over the chunks of one
sequence (``chip_smoke.py`` phase 21 does).
"""

from __future__ import annotations

import math

import torch

from .. import _dist


def _plain_attn_lse(q, k, v, causal):
    """(B, T, H, D) attention → (out f32, lse (B, H, T) f32)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        keep = torch.ones((tq, tk), dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~keep, -1e30)
    m = torch.clamp(torch.amax(s, dim=-1), min=-1e30)
    p = torch.exp(s - m[..., None])
    den = torch.clamp(p.sum(-1), min=1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    out = out / den.transpose(1, 2)[..., None]
    return out, m + torch.log(den)


def _flash_attn_lse(q, k, v, causal):
    """K1 with its lse in the ring's (B, T, H, D) layout."""
    from ..kernels.flash_attention import _dispatch
    out, lse = _dispatch(q, k, v, None, causal, "bthd")
    return out.float(), lse


def _use_flash(use_flash, q):
    return q.device.type == "cuda" or use_flash is True


def merge(acc, new):
    """Merge two (out, lse) online-softmax partials."""
    out_a, lse_a = acc
    out_n, lse_n = new
    lse = torch.logaddexp(lse_a, lse_n)                        # (B, H, T)
    ca = torch.exp(lse_a - lse).transpose(1, 2)[..., None]     # (B, T, H, 1)
    cn = torch.exp(lse_n - lse).transpose(1, 2)[..., None]
    return out_a * ca + out_n * cn, lse


def ring_hop(acc, q, k, v, mode: str, use_flash="auto"):
    """One hop: attend ``q`` to the key block (``k``, ``v``) and merge into
    ``acc`` ((out f32, lse), or None before the first hop). ``mode``:
    ``"diag"`` the aligned block (causal), ``"full"`` a block before the
    queries (unmasked), ``"skip"`` a block after them (nothing to add)."""
    if mode == "skip":
        if acc is None:
            raise ValueError("the first hop cannot be skipped")
        return acc
    attn = _flash_attn_lse if _use_flash(use_flash, q) else _plain_attn_lse
    new = attn(q, k, v, mode == "diag")
    return new if acc is None else merge(acc, new)


def ring_attention_sharded(q, k, v, group, causal: bool = True,
                           use_flash="auto"):
    """On each rank of the sp ring ``group`` (``_dist.Group``): q/k/v are
    its sequence block (B, T_local, H, D); exact attention across the
    whole sequence, in q's dtype."""
    n, idx = group.size, group.index
    acc = ring_hop(None, q, k, v, "diag" if causal else "full", use_flash)
    kv = (k, v)
    for hop in range(1, n):
        kv = _dist.shift(kv, group)
        src = (idx - hop) % n          # whose k/v this rank now holds
        mode = "full" if not causal or src < idx else "skip"
        acc = ring_hop(acc, q, kv[0], kv[1], mode, use_flash)
    out = acc[0].to(q.dtype)
    # the last hop's blocks are skipped on some ranks: tie them to the
    # output so that every rank runs every hop's backward
    return _dist.tie(out, *kv) if n > 1 and torch.is_grad_enabled() \
        else out


def ring_attention_inner(q, k, v, causal: bool = True, use_flash="auto",
                         group=None):
    """The ring over the sp ``group`` (the reference finds its 'sp' axis
    in scope); with none, attention over the whole sequence: K1 (on CPU
    tensors with ``use_flash=True``, its plain version), else the
    reference's ``jax.nn.dot_product_attention`` arm."""
    if group is not None:
        return ring_attention_sharded(q, k, v, group, causal, use_flash)
    if _use_flash(use_flash, q):
        from ..kernels.flash_attention import flash_attention_ntc
        return flash_attention_ntc(q, k, v, causal=causal)
    from ..zoo.transformer import dot_product_attention
    return dot_product_attention(q, k, v, is_causal=causal)


def ring_attention(mesh, q, k, v, causal: bool = True, use_flash="auto"):
    """Host-callable: q/k/v (B, T, H, D) are the global arrays on every
    rank of ``mesh``; each rank takes its rows ('dp') and sequence block
    ('sp'), runs the ring, and the blocks are gathered back — every rank
    returns the global (B, T, H, D), differentiable in q, k and v (a
    rank's gradient is nonzero on its own block only)."""
    sp = mesh.group("sp")
    dp = mesh.group("dp")
    q, k, v = (_dist.scatter_to(_dist.scatter_to(t, dp, 0), sp, 1)
               for t in (q, k, v))
    out = ring_attention_sharded(q, k, v, sp, causal, use_flash)
    return _dist.gather_from(_dist.gather_from(out, sp, 1), dp, 0)
