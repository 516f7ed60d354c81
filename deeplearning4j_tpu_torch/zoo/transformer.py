"""Transformer-LM — the inference half of the flagship model, in PyTorch.

Port of ``deeplearning4j_tpu/zoo/transformer.py``. The param tree keeps
the reference's layout and key names (stacked ``blocks`` with a leading L
axis), so a checkpoint of the JAX package loads 1:1 through
:func:`params_from_numpy`. The blocks run as a plain Python loop over L;
dense matmuls are ``torch.matmul``; the attention arms the reference left
to XLA stay plain torch ops, and the flash arm is the port's CUDA kernel
(``kernels.flash_attention``).

bf16 rounding follows the reference at each point it rounds: ``embed``
scales by √d in the compute dtype, ``_rmsnorm`` runs in f32 and casts
back, the bf16-scores arm pre-scales q in f32, masks at half the bf16
minimum and takes the softmax in f32, the head matmul runs in the compute
dtype and then goes to f32. ``gelu`` is the tanh approximation (the
``jax.nn.gelu`` default).

The training half: :func:`lm_loss` (the naive loss over the full
logits, or the fused chunked cross-entropy that never holds the (N, V)
f32 logits), per-block rematerialization over ``torch.utils.checkpoint``
(:func:`_remat_wrap`), and :func:`make_train_step`, one AdamW step in
place on the params dict. With flash attention engaged, the backward runs
the port's dQ and dK/dV kernels.

MoE blocks (``n_experts`` > 0): a top-k router with capacity
(:func:`_moe_mlp`), dispatched by index — the reference's one-hot
``(N, K, E, C)`` einsum would hold 5.4e9 elements a layer at B32 T1024
E8 — and the Switch-style aux loss. Over a mesh (``make_train_step(...,
mesh=)``) every rank runs the same program on its rows (dp) and its
sequence block (sp), with the reference's ``param_pspecs`` split: heads,
the MLP's hidden units and the vocabulary over tp (Megatron's maps in
``_dist``), experts over ep; the attention gathers the sequence's keys
and values over sp, or runs the ring (``use_ring_attention``,
``parallel/ring_attention.py``). ``make_ring_train_step`` is that step
over (dp, sp) with the ring.

The BERT family (the reference's ``BertConfig`` through
``make_bert_mlm_train_step``): the bidirectional encoder over the LM's
block (learned positions and token types, no embedding scale, the
padding mask as an additive bias on either attention arm), the
classifier and MLM losses (the MLM decoder tied to ``embed``; the fused
form over :func:`_chunked_ce`), on-device masking from a
``torch.Generator``, and the compiled MLM pretrain step. It runs no
hand-written kernel, as the reference's runs no Pallas one: at BERT's
lengths both attention arms are plain torch ops.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from .. import _dist
from .._device import resolve_device


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 8
    d_ff: int = 2048
    max_seq: int = 1024
    n_experts: int = 0          # 0 → dense MLP
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    dtype: Any = torch.bfloat16         # activation/compute dtype
    param_dtype: Any = torch.float32
    # per-block rematerialization when grad is enabled (inference never
    # remats): "full" saves only the block input; "save_attn" also keeps
    # the attention output; "dots" / "dots_no_batch" save the matmul
    # outputs (all, or those without batch dims) and recompute the rest
    remat: bool = True
    remat_policy: str = "full"
    # fused (chunked) LM cross-entropy: per chunk of ``loss_chunk`` rows
    # the head matmul, logsumexp and target gather run under a checkpoint,
    # so the (N, V) f32 logits never exist. True | False | "auto" (fuse
    # once the f32 logits would pass 64 MiB)
    fused_loss: Any = "auto"
    loss_chunk: int = 1024
    use_ring_attention: bool = False
    # True = always the flash kernel; False = plain attention; "auto" =
    # the kernel on CUDA from ``flash_min_seq`` up. 1024 is the
    # reference's threshold, kept until an H100 measurement replaces it.
    use_flash_attention: Any = "auto"
    flash_min_seq: int = 1024
    # materialize bf16 scores on the non-flash arm (reference default)
    attn_scores_bf16: bool = True
    tie_embeddings: bool = False
    # a parallel step's groups (``_dist.Groups``): ``make_train_step``
    # over a mesh runs its loss on a copy of the config that carries
    # them, so every function below, and the backward, read them here
    groups: Any = dataclasses.field(default=_dist.NONE, compare=False,
                                    repr=False)

    @property
    def head_dim(self):
        return self.d_model // self.n_heads


# ---------------------------------------------------------------- params

def init_params(cfg: TransformerConfig, generator: Optional[torch.Generator]
                = None, device=None):
    """Stacked-block params with the reference's names and shapes, drawn
    from ``generator`` (scaled normals like the reference's init — torch
    cannot reproduce ``jax.random`` draws, so parity tests share weights
    through :func:`params_from_numpy` instead)."""
    dev = resolve_device(device)
    d, f, h, L = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.head_dim, \
        cfg.n_layers
    pd = cfg.param_dtype

    def norm(shape, fan_in):
        x = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (x / math.sqrt(fan_in)).to(device=dev, dtype=pd)

    params = {
        "embed": norm((cfg.vocab_size, d), d),
        "pos_embed": (0.02 * torch.randn((cfg.max_seq, d),
                                         generator=generator)
                      ).to(device=dev, dtype=pd),
        "blocks": {
            "ln1": torch.ones((L, d), dtype=pd, device=dev),
            "wqkv": norm((L, d, 3 * h), d),
            "wo": norm((L, h, d), h),
            "ln2": torch.ones((L, d), dtype=pd, device=dev),
        },
        "ln_f": torch.ones((d,), dtype=pd, device=dev),
    }
    if cfg.n_experts:
        E = cfg.n_experts
        params["blocks"]["router"] = norm((L, d, E), d)
        params["blocks"]["we_in"] = norm((L, E, d, f), d)
        params["blocks"]["we_out"] = norm((L, E, f, d), f)
    else:
        params["blocks"]["w_in"] = norm((L, d, f), d)
        params["blocks"]["w_out"] = norm((L, f, d), f)
    if not cfg.tie_embeddings:
        params["head"] = norm((d, cfg.vocab_size), d)
    return params


def params_from_numpy(tree, cfg: TransformerConfig, device=None):
    """The JAX package's parameter pytree, as numpy arrays, → the port's
    tensors in ``cfg.param_dtype`` on ``device``. numpy has no bfloat16,
    so bf16 leaves arrive as f32; the cast back to bf16 is exact."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, cfg, dev) for k, v in tree.items()}
    arr = np.array(tree, order="C")    # an owned, writable copy
    if arr.dtype.kind not in "fiu":
        arr = arr.astype(np.float32)   # e.g. ml_dtypes bfloat16
    t = torch.from_numpy(arr)
    if t.is_floating_point():
        t = t.to(cfg.param_dtype)
    return t.to(dev)


def draft_config(cfg: TransformerConfig,
                 n_layers: int = 2) -> TransformerConfig:
    """Config of a layer-truncated draft: the first ``n_layers`` blocks,
    everything else as the target."""
    n = int(n_layers)
    if not (1 <= n <= cfg.n_layers):
        raise ValueError(f"draft n_layers={n} outside 1..{cfg.n_layers}")
    return dataclasses.replace(cfg, n_layers=n)


def draft_params(params, cfg: TransformerConfig, n_layers: int = 2):
    """``(draft_cfg, draft_params)``: the first ``n_layers`` slices of
    the stacked blocks (views, no copy), embed/pos/ln_f/head shared."""
    dcfg = draft_config(cfg, n_layers)
    blocks = {name: w[:dcfg.n_layers] for name, w in params["blocks"].items()}
    return dcfg, dict(params, blocks=blocks)


# ---------------------------------------------------------------- forward

def param_pspecs(cfg: TransformerConfig):
    """The reference's split of each param over the mesh axes (tuples
    for its PartitionSpecs; tp/ep, with fsdp composing on top)."""
    specs = {
        "embed": ("tp", None),           # vocab-split embedding
        "pos_embed": (),
        "blocks": {"ln1": (), "wqkv": (None, None, "tp"),
                   "wo": (None, "tp", None), "ln2": ()},
        "ln_f": (),
    }
    if cfg.n_experts:
        specs["blocks"].update(router=(), we_in=(None, "ep", None, "tp"),
                               we_out=(None, "ep", "tp", None))
    else:
        specs["blocks"].update(w_in=(None, None, "tp"),
                               w_out=(None, "tp", None))
    if not cfg.tie_embeddings:
        specs["head"] = (None, "tp")
    return specs


def shardings_for(mesh, cfg: TransformerConfig, params_like=None):
    """:func:`param_pspecs` placed on ``mesh`` (``parallel.mesh.Sharding``
    each; axes the mesh lacks become None)."""
    from ..parallel.mesh import Sharding

    def place(spec):
        return Sharding(mesh, tuple(a if (a is None or a in mesh.axis_names)
                                    else None for a in spec))

    def walk(t):
        return {k: walk(v) for k, v in t.items()} if isinstance(t, dict) \
            else place(t)
    return walk(param_pspecs(cfg))


def _constrain(x, *spec):
    """The reference's GSPMD hint (``with_sharding_constraint``): each
    rank here computes its own split explicitly, so it is the identity."""
    return x


def flash_engages(cfg, t, device) -> bool:
    """True when :func:`_attention` runs the flash kernel for a length-t
    sequence on ``device``: explicit ``True`` always (on a CPU tensor the
    kernel's plain version runs), ``"auto"`` on CUDA from
    ``cfg.flash_min_seq`` up. Ring attention wins over flash (the ring
    runs K1 itself, per hop)."""
    if cfg.use_ring_attention:
        return False
    if cfg.use_flash_attention is True:
        return True
    return (cfg.use_flash_attention == "auto" and t >= cfg.flash_min_seq
            and torch.device(device).type == "cuda")


def _attention(cfg, q, k, v, n_heads=None):
    """Causal self-attention of (B, T, H·Dh) q/k/v → (B, T, H·Dh), over
    ``n_heads`` heads (a tp rank's share; default all). Under an sp group
    (``cfg.groups.sp``) the sequence is split: the ring (``use_ring_attention``), or
    every rank's keys and values gathered and the causal mask shifted by
    the block's offset."""
    b, t = q.shape[0], q.shape[1]
    nh = n_heads or cfg.n_heads
    q = q.reshape(b, t, nh, cfg.head_dim)
    k = k.reshape(b, t, nh, cfg.head_dim)
    v = v.reshape(b, t, nh, cfg.head_dim)
    sp = cfg.groups.sp
    if cfg.use_ring_attention:
        from ..parallel.ring_attention import ring_attention_inner
        out = ring_attention_inner(q, k, v, causal=True,
                                   use_flash=cfg.use_flash_attention,
                                   group=sp)
    elif sp is not None and sp.size > 1:
        out = _offset_causal_attention(q, _dist.gather_sum(k, sp, 1),
                                       _dist.gather_sum(v, sp, 1),
                                       sp.index, cfg.use_flash_attention)
    elif flash_engages(cfg, t, q.device):
        from ..kernels.flash_attention import flash_attention_ntc
        out = flash_attention_ntc(q, k, v, causal=True)
    elif cfg.attn_scores_bf16 and q.dtype == torch.bfloat16:
        out = _xla_attention_bf16_scores(q, k, v)
    else:
        out = dot_product_attention(q, k, v, is_causal=True)
    return out.reshape(b, t, nh * cfg.head_dim)


def _offset_causal_attention(q, k, v, index, use_flash="auto"):
    """Queries of sequence block ``index`` (B, T, H, D) attend the keys of
    blocks 0..index of the whole sequence (B, n·T, H, D), causally: the
    ring's hops over the gathered blocks (the aligned block causal, the
    earlier ones full, merged by their lse), so CUDA tensors run K1."""
    from ..parallel.ring_attention import ring_hop
    t = q.shape[1]
    acc = None
    for j in range(index, -1, -1):
        acc = ring_hop(acc, q, k[:, j * t:(j + 1) * t],
                       v[:, j * t:(j + 1) * t],
                       "diag" if j == index else "full", use_flash)
    return acc[0].to(q.dtype)


def dot_product_attention(q, k, v, is_causal=True, bias=None):
    """The ``jax.nn.dot_product_attention`` arm: (B, T, H, D) in, logits
    in f32 (at least), f32 softmax, probs cast to v's dtype. ``bias``
    (broadcastable to (B, H, T, S), e.g. BERT's padding mask) is added to
    the logits in their dtype after the scale, before the causal mask, as
    JAX adds it."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    ldt = torch.promote_types(q.dtype, torch.float32)
    logits = torch.einsum("btnh,bsnh->bnts", q.to(ldt), k.to(ldt)) * scale
    if bias is not None:
        logits = logits + bias.to(ldt)
    if is_causal:
        t, s = logits.shape[2], logits.shape[3]
        mask = torch.tril(torch.ones((t, s), dtype=torch.bool,
                                     device=q.device))
        neg = torch.finfo(ldt).min * 0.7
        logits = logits.masked_fill(~mask, neg)
    probs = torch.softmax(logits.float(), dim=-1).to(v.dtype)
    return torch.einsum("bnts,bsnh->btnh", probs, v)


def _xla_attention_bf16_scores(q, k, v, causal=True, bias=None):
    """Attention with the (B, H, T, S) scores materialized in bf16:
    q pre-scaled in f32 then cast, QK^T stored bf16, ``bias``
    (broadcastable to (B, H, T, S)) cast to bf16 and added to the bf16
    logits (BERT's padding −1e9 becomes −998244352, as in the reference),
    then masked at half the bf16 minimum, softmax in f32, probs cast back.
    (B, T, H, D) in/out."""
    t = q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    q = (q.float() * scale).to(q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if bias is not None:
        logits = logits + bias.to(torch.bfloat16)
    if causal:
        # half the bf16 minimum is a bf16 value: the fill is exact
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                     device=q.device))
        logits = logits.masked_fill(~mask,
                                    torch.finfo(torch.bfloat16).min / 2)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _rmsnorm(x, scale, eps=1e-6):
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def gelu(x):
    """tanh-approximate gelu — ``jax.nn.gelu``'s default."""
    return F.gelu(x, approximate="tanh")


def _tp_slice(g, n):
    """(g, lo, hi) when there is a tp group ``g`` and it splits ``n``."""
    if g is None or n % g.size:
        return None
    return (g, *g.slice_of(n))


def _dense_mlp(cfg, x, w_in, w_out):
    sl = _tp_slice(cfg.groups.tp, w_in.shape[-1])
    if sl is None:
        h = gelu(x @ w_in.to(x.dtype))
        return h @ w_out.to(x.dtype)
    g, lo, hi = sl
    h = gelu(_dist.copy_to(x, g) @ w_in[:, lo:hi].to(x.dtype))
    return _dist.reduce_from(h @ w_out[lo:hi].to(x.dtype), g)


def _top_k(gates, k):
    """``lax.top_k``: the k largest along the last axis, ties in index
    order (a stable descending sort)."""
    v, i = torch.sort(gates, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _moe_mlp(cfg, x, router, we_in, we_out, topi=None):
    """Top-k routed MoE with capacity (reference ``_moe_mlp``): the same
    function as its one-hot einsum dispatch, by index.

    Each token's k-th choice takes position p in its expert's buffer from
    the token-major cumulative count over the (N·K, E) choice rows;
    choices at p ≥ capacity are dropped. The kept rows are scattered into
    an (E, C + 1, d) buffer (no two share a slot; dropped ones add zeros
    to the spare last slot), the experts run as one batched product, and
    each token sums its kept choices' outputs weighted by its top-k gates
    renormalised over all k. The Switch-style aux loss is E · Σ_e
    density_e · mean gate_e.

    Inside a parallel step the capacity, the positions and the aux loss
    are the global batch's (each rank's counts offset by the batch ranks
    before it); an ep group splits the experts and a tp group their
    hidden units, each rank computing its share of every token's output
    (summed over the two). ``topi`` (N, K), where given, are the choices
    taken in place of the router's top-k (their gates still the
    router's): two paths whose arithmetic differs are held on the same
    routing so. Returns ((B, T, d), aux f32)."""
    b, t, d = x.shape
    E, K = cfg.n_experts, cfg.expert_top_k
    n = b * t
    tokens = x.reshape(n, d)
    gates = torch.softmax(tokens.float() @ router.float(), dim=-1)
    if topi is None:
        topv, topi = _top_k(gates, K)                            # (N, K)
    else:
        topv = gates.gather(-1, topi)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    # the choices one-hot, experts by rows: (E, N·K), so that the
    # token-major running count is a scan along the inner axis
    onehot = (torch.arange(E, device=x.device)[:, None]
              == topi.reshape(1, -1)).float()
    counts = onehot.sum(1)
    bg, sp = cfg.groups.batch, cfg.groups.sp
    n_all, offset = n, torch.zeros_like(counts)
    if bg is not None:
        if sp is not None and sp.size > 1:
            raise NotImplementedError(
                "MoE over a sequence-split batch is not ported (the "
                "capacity order is token-major over whole rows)")
        every = bg.all_gather(counts[None])                      # (R, E)
        offset = every[:bg.index].sum(0)
        n_all = n * bg.size
    cap = max(1, int(cfg.capacity_factor * n_all * K / E))
    local = onehot.cumsum(1).gather(0, topi.reshape(1, -1)).reshape(n, K) \
        - 1.0                         # each choice's place in its expert
    keep = (local + offset[topi]) < cap
    c = min(cap, n * K)
    slot = torch.where(keep, topi * (c + 1) + local.long(),
                       topi * (c + 1) + c).reshape(-1)
    src = tokens[:, None, :].expand(n, K, d).reshape(n * K, d)
    src = src * keep.reshape(-1, 1).to(x.dtype)
    # copies, not sums: every kept row has a slot of its own, and the
    # dropped ones all write zeros into their expert's spare slot
    buf = torch.zeros((E * (c + 1), d), dtype=x.dtype, device=x.device)
    buf = buf.index_copy(0, slot, src).reshape(E, c + 1, d)
    split = _expert_split(cfg.groups, E, we_in.shape[-1])
    y = _experts(buf, we_in, we_out, split).reshape(E * (c + 1), d)
    w = (topv * keep).to(x.dtype)
    if split is not None:
        # the gates weight every rank's share of the outputs: their
        # cotangent is the sum of the ranks'
        w = _dist.copy_to(w, split[0])
    rows = _SlotRows.apply(y, slot).reshape(n, K, d)
    out = (rows.float() * w[..., None].float()).sum(1)
    if split is not None:
        out = _dist.reduce_from(out, split[0])
    # aux load-balancing loss (Switch-style), over the global batch
    dens, proxy = counts / (n * K), gates.mean(0)
    if bg is not None:
        dens = bg.all_reduce_(counts.clone()) / (n_all * K)
        proxy = _dist.all_reduce_sum(gates.sum(0), bg) / n_all
    aux = E * torch.sum(dens * proxy)
    return out.to(x.dtype).reshape(b, t, d), aux


class _SlotRows(torch.autograd.Function):
    """``y[slot]`` where no two kept rows share a slot: the backward
    copies each row's cotangent back to its slot (the dropped rows, all
    in the spare slots, carry zero cotangents), with no accumulation."""

    @staticmethod
    def forward(ctx, y, slot):
        ctx.save_for_backward(slot)
        ctx.rows = y.shape[0]
        return y.index_select(0, slot)

    @staticmethod
    def backward(ctx, g):
        (slot,) = ctx.saved_tensors
        return g.new_zeros((ctx.rows,) + tuple(g.shape[1:])).index_copy(
            0, slot, g), None


def _expert_split(groups, E, f):
    """(group, e0, e1, f0, f1): the experts [e0, e1) and hidden units
    [f0, f1) this rank computes when the ep and/or tp group of ``groups``
    split them, over the group of the axes that split; None when none
    does."""
    ep, tp = groups.ep, groups.tp
    by_e = ep is not None and ep.size > 1 and E % ep.size == 0
    by_f = tp is not None and tp.size > 1 and f % tp.size == 0
    if not (by_e or by_f):
        return None
    g = groups.expert if by_e and by_f else ep if by_e else tp
    e0, e1 = ep.slice_of(E) if by_e else (0, E)
    f0, f1 = tp.slice_of(f) if by_f else (0, f)
    return g, e0, e1, f0, f1


def _experts(buf, we_in, we_out, split):
    """The experts' MLP over their (E, C, d) buffers; under a ``split``
    (:func:`_expert_split`) this rank's experts and hidden units only,
    zeros for the other experts."""
    if split is None:
        h = gelu(torch.einsum("ecd,edf->ecf", buf, we_in.to(buf.dtype)))
        return torch.einsum("ecf,efd->ecd", h, we_out.to(buf.dtype))
    g, e0, e1, f0, f1 = split
    mine = _dist.copy_to(buf, g)[e0:e1]
    h = gelu(torch.einsum("ecd,edf->ecf", mine,
                          we_in[e0:e1, :, f0:f1].to(buf.dtype)))
    y = torch.einsum("ecf,efd->ecd", h, we_out[e0:e1, f0:f1].to(buf.dtype))
    rest = tuple(buf.shape[1:])
    return torch.cat([buf.new_zeros((e0,) + rest), y,
                      buf.new_zeros((buf.shape[0] - e1,) + rest)])


def scale_embedding(cfg, x):
    """x · √d_model in the compute dtype. JAX multiplies a weakly-typed
    Python scalar, which takes the array's dtype first — so the constant
    rounds to bf16 before the product, and so does it here. The constant
    is a host scalar (a 0-d CPU tensor), never a copy to the card, so
    that a captured step holds no host-to-device copy."""
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)


def embed(params, cfg: TransformerConfig, ids, pos_offset=0):
    """ids (B, T) → embedded activations (B, T, d) in compute dtype."""
    t = ids.shape[1]
    if pos_offset < 0 or pos_offset + t > cfg.max_seq:
        raise ValueError(f"positions [{pos_offset}, {pos_offset + t}) "
                         f"outside the {cfg.max_seq}-row position table")
    table = params["embed"]
    sl = _tp_slice(cfg.groups.tp, table.shape[0])
    if sl is None:
        x = table[ids]
    else:
        # each tp rank looks up the ids in its rows of the table
        g, lo, hi = sl
        local = ids - lo
        inside = ((local >= 0) & (local < hi - lo))[..., None]
        x = _dist.reduce_from(
            table[lo:hi][local.clamp(0, hi - lo - 1)] * inside, g)
    x = scale_embedding(cfg, x.to(cfg.dtype))
    pos = params["pos_embed"][pos_offset:pos_offset + t]
    return x + pos.to(cfg.dtype)


def _resolve_head(params, cfg: TransformerConfig):
    if "head" in params:
        return params["head"]
    if cfg.tie_embeddings:
        return params["embed"].T
    raise KeyError("params hold no 'head' and tie_embeddings is off")


def _head_product(x, head, tp=None):
    """x @ head (d, V) in x's dtype; over a tp group each rank's
    vocabulary columns, gathered."""
    sl = _tp_slice(tp, head.shape[1])
    if sl is None:
        return x @ head.to(x.dtype)
    g, lo, hi = sl
    return _dist.gather_from(_dist.copy_to(x, g) @ head[:, lo:hi]
                             .to(x.dtype), g)


def head_logits(params, cfg: TransformerConfig, x):
    """Final norm + LM head → f32 logits (B, T, V)."""
    x = _rmsnorm(x, params["ln_f"])
    return _head_product(x, _resolve_head(params, cfg),
                         cfg.groups.tp).float()


def head_logits_rows(params, cfg: TransformerConfig, x):
    """head_logits for (N, d) hidden rows → (N, V) f32."""
    x = _rmsnorm(x, params["ln_f"])
    return (x @ _resolve_head(params, cfg).to(x.dtype)).float()


def hidden_rows(params, cfg: TransformerConfig, x):
    """The final-norm hidden rows, (N, d) f32, no head matmul."""
    return _rmsnorm(x, params["ln_f"]).float()


def _heads_split(cfg):
    """(tp group, heads a rank) when a tp group splits the heads."""
    g = cfg.groups.tp
    if g is None or cfg.n_heads % g.size:
        return None
    return g, cfg.n_heads // g.size


def _attn_half(cfg, x, ln1, wqkv):
    """The block up to its attention output (B, T, H·Dh); also k and v.
    Under tp this rank's heads only (their q/k/v columns of wqkv)."""
    h = _rmsnorm(x, ln1)
    sp = _heads_split(cfg)
    if sp is None:
        q, k, v = (h @ wqkv.to(h.dtype)).chunk(3, dim=-1)
        return _attention(cfg, q, k, v), k, v
    g, nh = sp
    w = nh * cfg.head_dim
    cols = wqkv.reshape(wqkv.shape[0], 3, -1)[:, :, g.index * w:
                                              (g.index + 1) * w]
    q, k, v = (_dist.copy_to(h, g) @ cols.reshape(wqkv.shape[0], 3 * w)
               .to(h.dtype)).chunk(3, dim=-1)
    return _attention(cfg, q, k, v, nh), k, v


def _mlp_half(cfg, x, a, wo, ln2, *mlp):
    """The block after its attention: out-projection, residual, MLP
    (``mlp`` = (w_in, w_out), or (router, we_in, we_out) for MoE).
    Returns (x, aux) — aux None for a dense block."""
    sp = _heads_split(cfg)
    if sp is None:
        x = x + a @ wo.to(x.dtype)
    else:
        g, nh = sp
        w = nh * cfg.head_dim
        x = x + _dist.reduce_from(
            a @ wo[g.index * w:(g.index + 1) * w].to(x.dtype), g)
    h2 = _rmsnorm(x, ln2)
    if len(mlp) == 3:
        m, aux = _moe_mlp(cfg, h2, *mlp)
        return x + m, aux
    return x + _dense_mlp(cfg, h2, *mlp), None


def _mlp_weights(w):
    return (w["router"], w["we_in"], w["we_out"]) if "router" in w \
        else (w["w_in"], w["w_out"])


def _lm_attn(cfg, x, ln1, wqkv):
    """The LM block's attention half (causal), its output only."""
    return _attn_half(cfg, x, ln1, wqkv)[0]


def _block_of(attn):
    """The block ``(cfg, x, w) → (x, aux)`` around the attention half
    ``attn(cfg, x, ln1, wqkv) → a``: the LM's (:func:`_lm_attn`) or
    BERT's (bidirectional, with its padding bias); aux is the MoE loss
    (None for a dense block)."""
    def block(cfg, x, w):
        a = attn(cfg, x, w["ln1"], w["wqkv"])
        return _mlp_half(cfg, x, a, w["wo"], w["ln2"], *_mlp_weights(w))
    return block


_block = _block_of(_lm_attn)


def _checkpoint(fn, *args, **kw):
    # the LM draws no random numbers, so there is no RNG state to stash
    # and restore (which a CUDA graph capture refuses)
    return _ckpt.checkpoint(fn, *args, use_reentrant=False,
                            preserve_rng_state=False, **kw)


def _save_ops(ops):
    """A selective-checkpoint context that saves the outputs of ``ops``
    and recomputes every other op."""
    def policy(ctx, op, *args, **kwargs):
        return (_ckpt.CheckpointPolicy.MUST_SAVE if op in ops
                else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)
    return functools.partial(_ckpt.create_selective_checkpoint_contexts,
                             policy)


def _remat_wrap(policy: str, attn=_lm_attn):
    """The block ``(cfg, x, w) → (x, aux)`` (:func:`_block_of` ``attn``: the
    LM's by default, BERT's with its own attention half) under
    ``torch.utils.checkpoint`` with one of the reference's
    rematerialization policies:

    - ``"full"``: save only the block input, recompute everything;
    - ``"save_attn"``: also keep the attention output. The block is split
      by hand around the attention — a checkpoint selection policy sees
      only dispatcher ops, and the flash kernel is a ctypes launch inside
      an autograd Function — into two checkpointed halves: the first
      (norm, qkv, attention) saves only its inputs and returns the
      attention output, which the second half keeps. As in the
      reference, backward re-runs the attention forward to rebuild its
      residuals, and nothing downstream of it re-runs it;
    - ``"dots"`` / ``"dots_no_batch"``: save the outputs of every matrix
      product (``mm``/``addmm``/``bmm``/``baddbmm``), or only of those
      without batch dims (``mm``/``addmm``), and recompute the rest.

    An unknown policy raises ``ValueError``."""
    aten = torch.ops.aten
    mm = {aten.mm.default, aten.addmm.default}
    dots = {"dots": mm | {aten.bmm.default, aten.baddbmm.default},
            "dots_no_batch": mm}
    block = _block_of(attn)
    if policy == "full":
        return lambda cfg, x, w: _checkpoint(block, cfg, x, w)
    if policy == "save_attn":
        def run(cfg, x, w):
            a = _checkpoint(attn, cfg, x, w["ln1"], w["wqkv"])
            return _checkpoint(_mlp_half, cfg, x, a, w["wo"], w["ln2"],
                               *_mlp_weights(w))
        return run
    if policy in dots:
        ctx = _save_ops(dots[policy])
        return lambda cfg, x, w: _checkpoint(block, cfg, x, w,
                                             context_fn=ctx)
    raise ValueError(f"Unknown remat_policy {policy!r}; expected one of "
                     f"{sorted(['full', 'save_attn', *dots])}")


def _layers(blocks, n_layers):
    """The stacked blocks as a list of per-layer dicts, the first
    ``n_layers``; one unbind per leaf, so that its backward stacks the L
    grads once."""
    layers = [dict(zip(blocks, ws))
              for ws in zip(*(w.unbind(0) for w in blocks.values()))]
    return layers[:n_layers]


def apply_blocks(blocks, cfg: TransformerConfig, x, *, return_kv=False):
    """Run the stacked blocks over x (B, T, d). Returns (x, aux_sum);
    ``return_kv=True`` adds each layer's per-head keys/values stacked
    ``(L, B, T, H, Dh)`` in compute dtype: ``(x, aux_sum, (k, v))``.
    Each block is rematerialized under ``cfg.remat_policy`` when
    ``cfg.remat`` is on, grad is enabled and ``return_kv`` is off. The
    aux sum is the MoE blocks' load-balancing loss (0 for dense)."""
    b, t = x.shape[0], x.shape[1]
    layers = _layers(blocks, cfg.n_layers)
    block = _block
    if cfg.remat and torch.is_grad_enabled() and not return_kv:
        block = _remat_wrap(cfg.remat_policy)
    ks, vs, auxes = [], [], []
    for w in layers:
        if return_kv:
            a, k, v = _attn_half(cfg, x, w["ln1"], w["wqkv"])
            x, aux = _mlp_half(cfg, x, a, w["wo"], w["ln2"],
                               *_mlp_weights(w))
            ks.append(k.reshape(b, t, cfg.n_heads, cfg.head_dim))
            vs.append(v.reshape(b, t, cfg.n_heads, cfg.head_dim))
        else:
            x, aux = block(cfg, x, w)
        if aux is not None:
            auxes.append(aux)
    aux = torch.stack(auxes).sum() if auxes else \
        torch.zeros((), dtype=torch.float32, device=x.device)
    if return_kv:
        return x, aux, (torch.stack(ks), torch.stack(vs))
    return x, aux


def forward(params, cfg: TransformerConfig, ids, *, train=False,
            pos_offset=0):
    """ids (B, T) int → logits (B, T, vocab) f32. Returns (logits, aux).
    Runs under ``torch.no_grad()`` unless ``train=True``."""
    with contextlib.nullcontext() if train else torch.no_grad():
        x = embed(params, cfg, ids, pos_offset)
        x, aux = apply_blocks(params["blocks"], cfg, x)
        return head_logits(params, cfg, x), aux


# ---------------------------------------------------------------- training

def _use_fused_loss(cfg: TransformerConfig, n_rows: int) -> bool:
    if cfg.fused_loss is True:
        return True
    if cfg.fused_loss is False:
        return False
    # "auto": fuse once the f32 logits would pass ~64 MiB
    return n_rows * cfg.vocab_size * 4 > 64 * 2 ** 20


def _chunk_nll(xc, head, tc, wc, bias, tp):
    # the product in the compute dtype, then f32 — the reference's rounding
    logits = _head_product(xc, head, tp).float()
    if bias is not None:
        logits = logits + bias.float()
    lse = torch.logsumexp(logits, dim=-1)
    tl = logits.gather(-1, tc[:, None].long())[:, 0]
    return ((lse - tl) * wc).sum()          # pad rows weighted out


def _chunked_ce(x, head, targets, chunk, weights=None, bias=None,
                tp=None):
    """Weighted-sum NLL of (N, d) hidden rows against (N,) targets without
    ever holding the (N, V) f32 logits: a loop over row chunks, each under
    a checkpoint, so backward recomputes the chunk's logits from its
    (small) saved rows. Returns sum(w·nll); the caller divides by its own
    denominator. ``weights`` default to 1 per row; ``bias`` (V,) is an
    output bias; ``tp`` a tp group the head's columns split over."""
    n, d = x.shape
    chunk = min(chunk, n)
    pad = (-n) % chunk
    w = (torch.ones((n,), dtype=torch.float32, device=x.device)
         if weights is None else weights.float())
    if pad:
        x = torch.cat([x, x.new_zeros((pad, d))])
        targets = torch.cat([targets, targets.new_zeros((pad,))])
        w = torch.cat([w, w.new_zeros((pad,))])
    nll = (_checkpoint if torch.is_grad_enabled() else
           lambda fn, *a: fn(*a))
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, n + pad, chunk):
        sl = slice(c0, c0 + chunk)
        total = total + nll(_chunk_nll, x[sl], head, targets[sl], w[sl],
                            bias, tp)
    return total


def lm_loss(params, cfg: TransformerConfig, ids, targets, *,
            aux_weight=1e-2, pos_offset=0):
    """Mean next-token NLL of ``targets`` (B, T) given ``ids`` (B, T),
    plus ``aux_weight`` · the blocks' auxiliary loss (0 for dense
    blocks). Differentiable in the params. In a parallel step (a batch
    group on ``cfg.groups``) this rank's share: its tokens' NLL over the
    global token count, and ``1/size`` of the aux term (itself the
    global batch's)."""
    b, t = ids.shape
    g = cfg.groups.batch
    share = 1 if g is None else g.size
    if _use_fused_loss(cfg, b * t):
        x = embed(params, cfg, ids, pos_offset)
        x, aux = apply_blocks(params["blocks"], cfg, x)
        x = _rmsnorm(x, params["ln_f"])
        head = _resolve_head(params, cfg)
        nll = _chunked_ce(x.reshape(b * t, -1), head.to(x.dtype),
                          targets.reshape(b * t), cfg.loss_chunk,
                          tp=cfg.groups.tp) / (b * t * share)
        return nll + aux_weight * aux / share
    logits, aux = forward(params, cfg, ids, train=True,
                          pos_offset=pos_offset)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    if g is None:
        return nll.mean() + aux_weight * aux
    return nll.sum() / (b * t * share) + aux_weight * aux / share


def param_leaves(params):
    """The params dict's tensors, in the order of its keys, each set to
    require grad — what an optimizer for :func:`make_train_step` takes."""
    if isinstance(params, dict):
        return [t for v in params.values() for t in param_leaves(v)]
    return [params.requires_grad_(True)]


def make_train_step(cfg: TransformerConfig, optimizer, mesh=None):
    """One training step: ``step(params, ids, targets) → loss`` runs
    ``zero_grad(set_to_none=True)``, the backward of :func:`lm_loss` and
    ``optimizer.step()``, updating the params dict's leaves in place.
    ``ids``/``targets`` (B, T) may be numpy or tensors.

    The step is compiled (``nn/_compiled.py``, the counterpart of the
    reference's ``jax.jit`` with donation): on CUDA the first call of an
    (ids, targets) signature runs eagerly, the second is captured as a
    CUDA graph — ``zero_grad``, the loss, the backward and the optimizer
    step — and replayed, and later calls copy ids and targets into the
    graph's static buffers and replay it. The optimizer must then be
    capturable (``torch.optim.AdamW(..., capturable=True)``); one that is
    not raises on CUDA. On the CPU, and under ``disable_graphs()``, every
    call runs eagerly. After a replay the grads (``p.grad``) are the
    graph's own buffers: read them after an eager step.

    With a ``mesh`` (``parallel.make_mesh``; every rank calls the step
    with the same global batch and its own copy of the params) the step
    is the reference's ``jit(make_train_step)`` over ``shardings_for``:
    each rank takes its rows (dp) and sequence block (sp, at its position
    offset), runs the loss with the tp and ep splits of
    :func:`param_pspecs` (``cfg.groups``), then sums every gradient
    over the batch axes and the axes its param is split over (a split
    param's gradient is nonzero on its rank's part only) and steps; the
    loss returned is the global batch's. A gloo group cannot be captured:
    on CUDA over gloo every step runs eagerly.

    The caller builds the optimizer over :func:`param_leaves`. The
    reference's ``optax.adamw(lr)`` is
    ``torch.optim.AdamW(param_leaves(params), lr=lr, betas=(0.9, 0.999),
    eps=1e-8, weight_decay=1e-4)``: the same moments, eps outside the
    square root, and optax's default decay of 1e-4 (torch's default is
    1e-2) on every leaf, as optax's mask is None. Torch decays the
    params before the Adam update, optax adds ``wd·p`` to it; the two
    agree to rounding."""
    from ..nn._compiled import CompiledStep, graphs_enabled, tensors

    bound = {}
    plan = None if mesh is None else _MeshPlan(mesh, cfg)

    def static_step(ids, targets):
        optimizer.zero_grad(set_to_none=True)
        if plan is None:
            loss = lm_loss(bound["params"], cfg, ids, targets)
            loss.backward()
        else:
            loss = plan.loss_and_grads(bound["params"], ids, targets)
        optimizer.step()
        return loss.detach()

    def bindings():
        # the params the step reads, the optimizer's params and state, and
        # the host values (lr, betas, ...) a capture bakes in
        groups = optimizer.param_groups
        return [*tensors(bound["params"]),
                *(p for g in groups for p in g["params"]),
                *tensors(list(optimizer.state.values())),
                *(g[k] for g in groups for k in sorted(g) if k != "params")]

    compiled = CompiledStep(static_step, bindings, "make_train_step",
                            eager=plan is not None and plan.eager)

    def step(params, ids, targets):
        dev = params["embed"].device
        ids = torch.as_tensor(ids).long()
        targets = torch.as_tensor(targets).long()
        if plan is not None:
            ids, targets = plan.local(ids), plan.local(targets)
        ids, targets = ids.to(dev), targets.to(dev)
        if dev.type == "cuda" and graphs_enabled() and not compiled.eager \
                and not all(g.get("capturable", False)
                            for g in optimizer.param_groups):
            raise ValueError(
                "make_train_step captures the step as a CUDA graph on CUDA, "
                f"and {type(optimizer).__name__} is not capturable: build "
                "it with capturable=True (torch.optim.AdamW(..., "
                "capturable=True)), or run the step under "
                "deeplearning4j_tpu_torch.disable_graphs()")
        bound["params"] = params
        return compiled(ids, targets)

    step.compiled = compiled
    return step


class _MeshPlan:
    """How the LM's step runs on one rank of ``mesh`` (see
    :func:`make_train_step`): its groups, its block of the batch, and the
    group each param's gradient is summed over."""

    def __init__(self, mesh, cfg):
        import torch.distributed as dist
        self.mesh = mesh
        size = mesh.shape.get

        def live(a):
            return mesh.group(a) if size(a, 1) > 1 else None
        self.dp, self.sp = mesh.group("dp"), mesh.group("sp")
        ring = cfg.use_ring_attention
        self.cfg = dataclasses.replace(cfg, groups=_dist.Groups(
            batch=mesh.group("dp", "sp"), tp=live("tp"),
            sp=self.sp if (ring or size("sp", 1) > 1) else None,
            ep=live("ep"),
            expert=mesh.group("ep", "tp") if size("ep", 1) > 1
            and size("tp", 1) > 1 else None))
        self.eager = mesh.device.type == "cuda" and \
            dist.get_backend() != "nccl"
        self.split = _split_axes(cfg, mesh)
        self.batch_axes = [a for a in ("dp", "sp") if a in mesh.axis_names]

    def local(self, a):
        """This rank's rows (dp) and sequence block (sp) of a (B, T)
        global batch."""
        for g, dim in ((self.dp, 0), (self.sp, 1)):
            if a.shape[dim] % g.size:
                raise ValueError(f"axis {dim} of {tuple(a.shape)} does not "
                                 f"split over {g.size} ranks")
            lo, hi = g.slice_of(a.shape[dim])
            a = a.narrow(dim, lo, hi - lo)
        return a

    def loss_and_grads(self, params, ids, targets):
        t = ids.shape[1]
        loss = lm_loss(params, self.cfg, ids, targets,
                       pos_offset=self.sp.index * t)
        loss.backward()
        by = {}
        for p, axes in _by_key(params, self.split):
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            by.setdefault(tuple(axes), []).append(p.grad)
        for axes, grads in by.items():
            _dist.sum_(grads, self.mesh.group(*self.batch_axes, *axes))
        return self.cfg.groups.batch.all_reduce_(
            loss.detach().reshape(1).clone()).reshape(())


def _split_axes(cfg, mesh):
    """The mesh axes each param's computation is split over (a tree like
    the params, tuples of axes): :func:`param_pspecs`' tp and ep, where
    the split divides — the same tests the forward makes."""
    tp, ep = mesh.shape.get("tp", 1), mesh.shape.get("ep", 1)
    t = ("tp",) if tp > 1 else ()
    heads = t if cfg.n_heads % tp == 0 else ()
    vocab = t if cfg.vocab_size % tp == 0 else ()
    hidden = t if cfg.d_ff % tp == 0 else ()
    blocks = {"ln1": (), "wqkv": heads, "wo": heads, "ln2": ()}
    if cfg.n_experts:
        e = ("ep",) if ep > 1 and cfg.n_experts % ep == 0 else ()
        blocks.update(router=(), we_in=e + hidden, we_out=e + hidden)
    else:
        blocks.update(w_in=hidden, w_out=hidden)
    out = {"embed": vocab, "pos_embed": (), "blocks": blocks, "ln_f": ()}
    if not cfg.tie_embeddings:
        out["head"] = vocab
    return out


def _by_key(params, tree):
    """(param, leaf of ``tree`` at the same keys), in the params' order."""
    if isinstance(params, dict):
        return [x for k, v in params.items() for x in _by_key(v, tree[k])]
    return [(params, tree)]


def make_ring_train_step(cfg: TransformerConfig, optimizer, mesh):
    """The train step with explicit ring sequence parallelism
    (reference ``make_ring_train_step``): :func:`make_train_step` over
    the mesh's ('dp', 'sp') axes, the batch split over dp and the
    sequence over sp, each block at its global position offset, the
    attention on the sp ring (``parallel/ring_attention.py``), loss and
    gradients summed over both axes. Dense blocks only; requires
    ``cfg.use_ring_attention``; a global T past ``cfg.max_seq`` raises."""
    if not cfg.use_ring_attention:
        raise ValueError("make_ring_train_step requires "
                         "cfg.use_ring_attention=True")
    if getattr(cfg, "n_experts", 0):
        raise NotImplementedError(
            "ring step is dense-only; MoE routes through make_train_step "
            "over a mesh without sp")
    inner = make_train_step(cfg, optimizer, mesh)

    def step(params, ids, targets):
        if ids.shape[1] > cfg.max_seq:
            raise ValueError(
                f"global sequence length {ids.shape[1]} exceeds "
                f"cfg.max_seq={cfg.max_seq}")
        return inner(params, ids, targets)

    step.compiled = inner.compiled
    return step


def generate(params, cfg: TransformerConfig, prompt_ids, max_new_tokens=32,
             *, generator=None, temperature=0.0, top_k=0, eos_id=None,
             max_len=None, device=None):
    """Autoregressive generation — the zoo-level serving entry point.
    Prefills the prompt into a KV cache, then decodes one token per
    step; ``temperature=0`` is greedy, ``top_k`` restricts sampling, and
    randomness comes from the explicit ``torch.Generator``. Returns the
    generated ids as numpy: ``(B, n)`` for a batched prompt, ``(n,)`` for
    one sequence. ``device=None`` means the CUDA card."""
    from ..serving.engine import GenerationEngine
    eng = GenerationEngine(cfg, params, max_len=max_len, device=device)
    return eng.generate(prompt_ids, max_new_tokens, generator=generator,
                        temperature=temperature, top_k=top_k,
                        eos_id=eos_id)


# ------------------------------------------------------------- BERT family

@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    d_ff: int = 3072
    max_seq: int = 512
    type_vocab: int = 2
    num_labels: int = 2
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    # per-block rematerialization when grad is enabled, under the LM's
    # policies ("full" | "dots" | "dots_no_batch" | "save_attn")
    remat: bool = False
    remat_policy: str = "full"
    # materialize bf16 scores (the bf16-scores arm; off = the
    # jax.nn.dot_product_attention arm)
    attn_scores_bf16: bool = False
    # the blocks' groups (``_dist.Groups``; BERT runs on one device)
    groups: Any = dataclasses.field(default=_dist.NONE, compare=False,
                                    repr=False)


def bert_init(cfg: BertConfig, generator: Optional[torch.Generator] = None,
              device=None):
    """The BERT encoder's params with the reference's names and shapes:
    learned positions and token types, stacked blocks, the pooler and a
    zero classification head, and the MLM head (dense, norm scale,
    decoder bias; the decoder weight is ``embed``, tied). Drawn from
    ``generator`` as :func:`init_params` draws the LM's."""
    dev = resolve_device(device)
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    pd = cfg.param_dtype

    def norm(shape, fan_in):
        x = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (x / math.sqrt(fan_in)).to(device=dev, dtype=pd)

    def small(shape):
        x = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (0.02 * x).to(device=dev, dtype=pd)

    return {
        "embed": norm((cfg.vocab_size, d), d),
        "pos_embed": small((cfg.max_seq, d)),
        "type_embed": small((cfg.type_vocab, d)),
        "blocks": {
            "ln1": torch.ones((L, d), dtype=pd, device=dev),
            "wqkv": norm((L, d, 3 * d), d),
            "wo": norm((L, d, d), d),
            "ln2": torch.ones((L, d), dtype=pd, device=dev),
            "w_in": norm((L, d, f), d),
            "w_out": norm((L, f, d), f),
        },
        "pooler": norm((d, d), d),
        "cls": torch.zeros((d, cfg.num_labels), dtype=pd, device=dev),
        "mlm_dense": norm((d, d), d),
        "mlm_ln": torch.ones((d,), dtype=pd, device=dev),
        "mlm_bias": torch.zeros((cfg.vocab_size,), dtype=pd, device=dev),
    }


def bert_params_from_numpy(tree, cfg: BertConfig, device=None):
    """The JAX package's BERT params, as numpy arrays, → the port's
    tensors (as :func:`params_from_numpy`). The tree has no decoder
    leaf: the MLM head projects on ``embed``, so the tie holds in the
    port as one tensor."""
    return params_from_numpy(tree, cfg, device)


def _bert_attn(bias):
    """BERT's attention half ``(cfg, x, ln1, wqkv) → a``: bidirectional,
    the padding ``bias`` (None, or (B, 1, 1, T) f32) on the logits; the
    bf16-scores arm when ``cfg.attn_scores_bf16`` and the compute dtype
    is bf16, else the ``jax.nn.dot_product_attention`` arm."""
    def attn(cfg, x, ln1, wqkv):
        b, t = x.shape[0], x.shape[1]
        nh = cfg.n_heads
        hd = cfg.d_model // nh
        h = _rmsnorm(x, ln1)
        q, k, v = (h @ wqkv.to(h.dtype)).chunk(3, dim=-1)
        q = q.reshape(b, t, nh, hd)
        k = k.reshape(b, t, nh, hd)
        v = v.reshape(b, t, nh, hd)
        if cfg.attn_scores_bf16 and q.dtype == torch.bfloat16:
            a = _xla_attention_bf16_scores(q, k, v, causal=False, bias=bias)
        else:
            a = dot_product_attention(q, k, v, is_causal=False, bias=bias)
        return a.reshape(b, t, nh * hd)
    return attn


def bert_forward(params, cfg: BertConfig, ids, type_ids=None,
                 attn_mask=None, *, train=False):
    """ids (B, T) int → ``(logits, hidden)``: the classifier's (B,
    num_labels) f32 logits (tanh pooler on position 0, then ``cls``) and
    the final hidden states (B, T, d) in the compute dtype. Learned
    positions and no embedding scale; ``type_ids`` (B, T) add the token
    type embedding; ``attn_mask`` (B, T), > 0 where a token is real, masks
    the padded keys with a −1e9 bias. Each block is rematerialized under
    ``cfg.remat_policy`` when ``cfg.remat`` is on and grad is enabled.
    Runs under ``torch.no_grad()`` unless ``train=True``."""
    with contextlib.nullcontext() if train else torch.no_grad():
        t = ids.shape[1]
        # indexing, not F.embedding: on CUDA the latter's backward sums
        # repeated ids in an order that varies from run to run, and a
        # replayed step must equal the eager one bit for bit
        x = params["embed"][ids.long()].to(cfg.dtype)
        x = x + params["pos_embed"][:t].to(cfg.dtype)
        if type_ids is not None:
            x = x + params["type_embed"][type_ids.long()].to(cfg.dtype)
        bias = None
        if attn_mask is not None:
            bias = torch.where(attn_mask[:, None, None, :] > 0, 0.0, -1e9
                               ).to(torch.float32)
        attn = _bert_attn(bias)
        block = _block_of(attn)
        if cfg.remat and torch.is_grad_enabled():
            block = _remat_wrap(cfg.remat_policy, attn)
        for w in _layers(params["blocks"], cfg.n_layers):
            x = block(cfg, x, w)[0]
        pooled = torch.tanh(x[:, 0] @ params["pooler"].to(x.dtype))
        logits = pooled @ params["cls"].to(x.dtype)
        return logits.float(), x


def bert_classifier_loss(params, cfg: BertConfig, ids, labels,
                         type_ids=None, attn_mask=None):
    """Mean NLL of ``labels``: integer class ids (B,) or one-hot (B,
    num_labels), which ``BertIterator`` emits. Differentiable in the
    params."""
    logits, _ = bert_forward(params, cfg, ids, type_ids, attn_mask,
                             train=True)
    logp = torch.log_softmax(logits, dim=-1)
    if labels.ndim == 2:
        return -(logp * labels.to(logp.dtype)).sum(-1).mean()
    return -logp.gather(-1, labels[:, None].long())[:, 0].mean()


def _mlm_transform(params, hidden):
    """The MLM head's dense + gelu + norm, in the compute dtype."""
    h = gelu(hidden @ params["mlm_dense"].to(hidden.dtype))
    return _rmsnorm(h, params["mlm_ln"])


def bert_mlm_logits(params, cfg: BertConfig, hidden):
    """The MLM decoder over the final hidden states: dense + gelu + norm,
    then the projection on the tied ``embed`` plus ``mlm_bias`` in the
    compute dtype → (B, T, vocab) f32."""
    h = _mlm_transform(params, hidden)
    logits = h @ params["embed"].to(h.dtype).T
    return (logits + params["mlm_bias"].to(logits.dtype)).float()


def bert_mask_tokens(generator, ids, cfg: BertConfig, mask_token_id,
                     mask_prob: float = 0.15, special_mask=None):
    """BERT's masking: each position is selected with ``mask_prob``
    (never where ``special_mask`` (B, T) bool is set); of the selected,
    80% become ``mask_token_id``, 10% a uniform random id and 10% stay.
    Returns ``(masked_ids, labels, weights)``: labels are the original
    ids, weights 1.0 at the selected positions (f32). Draws from
    ``generator`` (on ``ids``' device), three draws over (B, T) in the
    reference's order; static shapes, no host sync, so a captured step
    draws afresh at every replay."""
    dev = ids.device
    sel = torch.rand(ids.shape, generator=generator, device=dev) < mask_prob
    if special_mask is not None:
        sel = sel & ~special_mask
    op = torch.rand(ids.shape, generator=generator, device=dev)
    rand_ids = torch.randint(0, cfg.vocab_size, ids.shape,
                             generator=generator, device=dev,
                             dtype=ids.dtype)
    masked = torch.where(op < 0.8, mask_token_id,
                         torch.where(op < 0.9, rand_ids, ids))
    return torch.where(sel, masked, ids), ids, sel.float()


def bert_mlm_loss(params, cfg: BertConfig, masked_ids, labels, weights,
                  type_ids=None, attn_mask=None, fused: bool = True):
    """Weighted cross-entropy over the selected positions, divided by
    max(Σ weights, 1). ``fused`` runs the vocab projection through the
    chunked cross-entropy (:func:`_chunked_ce`, chunks of 1024 rows, the
    ``mlm_bias`` added in f32), so the (B, T, V) f32 logits never exist;
    the head's dense + norm runs full size. Differentiable in the
    params."""
    _, hidden = bert_forward(params, cfg, masked_ids, type_ids, attn_mask,
                             train=True)
    denom = weights.sum().clamp_min(1.0)
    if fused:
        h = _mlm_transform(params, hidden)
        b, t, d = h.shape
        total = _chunked_ce(h.reshape(b * t, d),
                            params["embed"].T.to(h.dtype),
                            labels.reshape(b * t), 1024,
                            weights=weights.reshape(b * t),
                            bias=params["mlm_bias"])
        return total / denom
    logp = torch.log_softmax(bert_mlm_logits(params, cfg, hidden), dim=-1)
    nll = -logp.gather(-1, labels[..., None].long())[..., 0]
    return (nll * weights).sum() / denom


def make_bert_mlm_train_step(cfg: BertConfig, optimizer, mask_token_id,
                             mask_prob: float = 0.15, special_ids=None,
                             generator=None):
    """One MLM pretrain step: ``step(params, ids, type_ids=None,
    attn_mask=None) → loss`` masks ``ids`` on the device
    (:func:`bert_mask_tokens`, never at ``special_ids`` such as PAD, CLS
    and SEP, which ``BertIterator.special_ids`` gives), runs
    ``zero_grad(set_to_none=True)``, the backward of the fused
    :func:`bert_mlm_loss` and ``optimizer.step()``, updating the params
    dict's leaves in place. Pass ``attn_mask`` so that attention ignores
    padding (``BertIterator`` gives it as the first features mask).

    The masks come from ``generator`` (``step.generator``; by default a
    generator on the params' device seeded with 0, made at the first
    call). The step is compiled as :func:`make_train_step`'s is: on CUDA
    one CUDA graph per (ids, type_ids, attn_mask) signature after an
    eager first call, the optimizer then capturable (one that is not
    raises), and the generator registered with every graph, so that each
    replay draws fresh masks from the generator's state, as an eager
    step from that state would."""
    from ..nn._compiled import CompiledStep, graphs_enabled, tensors

    bound = {"gen": generator}

    def static_step(ids, type_ids, attn_mask):
        optimizer.zero_grad(set_to_none=True)
        special_mask = (None if bound["specials"] is None
                        else torch.isin(ids, bound["specials"]))
        masked, labels, weights = bert_mask_tokens(
            bound["gen"], ids, cfg, mask_token_id, mask_prob,
            special_mask=special_mask)
        loss = bert_mlm_loss(bound["params"], cfg, masked, labels, weights,
                             type_ids, attn_mask)
        loss.backward()
        optimizer.step()
        return loss.detach()

    def bindings():
        groups = optimizer.param_groups
        return [*tensors(bound["params"]), bound["gen"],
                *(p for g in groups for p in g["params"]),
                *tensors(list(optimizer.state.values())),
                *(g[k] for g in groups for k in sorted(g) if k != "params")]

    compiled = CompiledStep(static_step, bindings,
                            "make_bert_mlm_train_step")

    def step(params, ids, type_ids=None, attn_mask=None):
        dev = params["embed"].device
        if dev.type == "cuda" and graphs_enabled() and not all(
                g.get("capturable", False) for g in optimizer.param_groups):
            raise ValueError(
                "make_bert_mlm_train_step captures the step as a CUDA graph "
                f"on CUDA, and {type(optimizer).__name__} is not "
                "capturable: build it with capturable=True, or run the "
                "step under deeplearning4j_tpu_torch.disable_graphs()")
        if "specials" not in bound:        # made once, outside any capture
            if bound["gen"] is None:
                bound["gen"] = torch.Generator(device=dev).manual_seed(0)
            bound["specials"] = (None if special_ids is None else
                                 torch.tensor(list(special_ids),
                                              dtype=torch.long, device=dev))
        bound["params"] = params
        ids = torch.as_tensor(ids, device=dev).long()
        type_ids = (None if type_ids is None
                    else torch.as_tensor(type_ids, device=dev).long())
        attn_mask = (None if attn_mask is None
                     else torch.as_tensor(attn_mask, device=dev))
        step.generator = bound["gen"]
        return compiled(ids, type_ids, attn_mask)

    step.compiled = compiled
    step.generator = generator
    return step
