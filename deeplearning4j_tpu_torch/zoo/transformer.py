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
the port's dQ and dK/dV kernels. MoE, ring/sharded attention and BERT
are not ported yet and raise ``NotImplementedError``.
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

from .._device import resolve_device


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 8
    d_ff: int = 2048
    max_seq: int = 1024
    n_experts: int = 0          # 0 → dense MLP (the only kind ported)
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
    if cfg.n_experts:
        raise NotImplementedError("MoE blocks are not ported yet")
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
            "w_in": norm((L, d, f), d),
            "w_out": norm((L, f, d), f),
        },
        "ln_f": torch.ones((d,), dtype=pd, device=dev),
    }
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

def flash_engages(cfg, t, device) -> bool:
    """True when :func:`_attention` runs the flash kernel for a length-t
    sequence on ``device``: explicit ``True`` always (on a CPU tensor the
    kernel's plain version runs), ``"auto"`` on CUDA from
    ``cfg.flash_min_seq`` up. Ring attention is not ported and raises."""
    if cfg.use_ring_attention:
        raise NotImplementedError("ring attention is not ported yet")
    if cfg.use_flash_attention is True:
        return True
    return (cfg.use_flash_attention == "auto" and t >= cfg.flash_min_seq
            and torch.device(device).type == "cuda")


def _attention(cfg, q, k, v):
    """Causal self-attention of (B, T, H·Dh) q/k/v → (B, T, H·Dh)."""
    b, t = q.shape[0], q.shape[1]
    q = q.reshape(b, t, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, t, cfg.n_heads, cfg.head_dim)
    v = v.reshape(b, t, cfg.n_heads, cfg.head_dim)
    if flash_engages(cfg, t, q.device):
        from ..kernels.flash_attention import flash_attention_ntc
        out = flash_attention_ntc(q, k, v, causal=True)
    elif cfg.attn_scores_bf16 and q.dtype == torch.bfloat16:
        out = _xla_attention_bf16_scores(q, k, v)
    else:
        out = dot_product_attention(q, k, v, is_causal=True)
    return out.reshape(b, t, cfg.n_heads * cfg.head_dim)


def dot_product_attention(q, k, v, is_causal=True):
    """The ``jax.nn.dot_product_attention`` arm: (B, T, H, D) in, logits
    in f32 (at least), f32 softmax, probs cast to v's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    ldt = torch.promote_types(q.dtype, torch.float32)
    logits = torch.einsum("btnh,bsnh->bnts", q.to(ldt), k.to(ldt)) * scale
    if is_causal:
        t, s = logits.shape[2], logits.shape[3]
        mask = torch.tril(torch.ones((t, s), dtype=torch.bool,
                                     device=q.device))
        neg = torch.finfo(ldt).min * 0.7
        logits = logits.masked_fill(~mask, neg)
    probs = torch.softmax(logits.float(), dim=-1).to(v.dtype)
    return torch.einsum("bnts,bsnh->btnh", probs, v)


def _xla_attention_bf16_scores(q, k, v, causal=True):
    """Attention with the (B, H, T, S) scores materialized in bf16:
    q pre-scaled in f32 then cast, QK^T stored bf16, masked at half the
    bf16 minimum, softmax in f32, probs cast back. (B, T, H, D) in/out."""
    t = q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    q = (q.float() * scale).to(q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
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


def _dense_mlp(cfg, x, w_in, w_out):
    h = gelu(x @ w_in.to(x.dtype))
    return h @ w_out.to(x.dtype)


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
    x = params["embed"][ids].to(cfg.dtype)
    x = scale_embedding(cfg, x)
    pos = params["pos_embed"][pos_offset:pos_offset + t]
    return x + pos.to(cfg.dtype)


def _resolve_head(params, cfg: TransformerConfig):
    if "head" in params:
        return params["head"]
    if cfg.tie_embeddings:
        return params["embed"].T
    raise KeyError("params hold no 'head' and tie_embeddings is off")


def head_logits(params, cfg: TransformerConfig, x):
    """Final norm + LM head → f32 logits (B, T, V)."""
    x = _rmsnorm(x, params["ln_f"])
    return (x @ _resolve_head(params, cfg).to(x.dtype)).float()


def head_logits_rows(params, cfg: TransformerConfig, x):
    """head_logits for (N, d) hidden rows → (N, V) f32."""
    x = _rmsnorm(x, params["ln_f"])
    return (x @ _resolve_head(params, cfg).to(x.dtype)).float()


def hidden_rows(params, cfg: TransformerConfig, x):
    """The final-norm hidden rows, (N, d) f32, no head matmul."""
    return _rmsnorm(x, params["ln_f"]).float()


def _attn_half(cfg, x, ln1, wqkv):
    """The block up to its attention output (B, T, H·Dh); also k and v."""
    h = _rmsnorm(x, ln1)
    q, k, v = (h @ wqkv.to(h.dtype)).chunk(3, dim=-1)
    return _attention(cfg, q, k, v), k, v


def _mlp_half(cfg, x, a, wo, ln2, w_in, w_out):
    """The block after its attention: out-projection, residual, MLP."""
    x = x + a @ wo.to(x.dtype)
    h2 = _rmsnorm(x, ln2)
    return x + _dense_mlp(cfg, h2, w_in, w_out)


def _block(cfg, x, w):
    a = _attn_half(cfg, x, w["ln1"], w["wqkv"])[0]
    return _mlp_half(cfg, x, a, w["wo"], w["ln2"], w["w_in"], w["w_out"])


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


def _remat_wrap(policy: str):
    """The block ``(cfg, x, w) → x`` under ``torch.utils.checkpoint``
    with one of the reference's rematerialization policies:

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
    if policy == "full":
        return lambda cfg, x, w: _checkpoint(_block, cfg, x, w)
    if policy == "save_attn":
        def run(cfg, x, w):
            a = _checkpoint(lambda *xs: _attn_half(*xs)[0], cfg, x,
                            w["ln1"], w["wqkv"])
            return _checkpoint(_mlp_half, cfg, x, a, w["wo"], w["ln2"],
                               w["w_in"], w["w_out"])
        return run
    if policy in dots:
        ctx = _save_ops(dots[policy])
        return lambda cfg, x, w: _checkpoint(_block, cfg, x, w,
                                             context_fn=ctx)
    raise ValueError(f"Unknown remat_policy {policy!r}; expected one of "
                     f"{sorted(['full', 'save_attn', *dots])}")


def apply_blocks(blocks, cfg: TransformerConfig, x, *, return_kv=False):
    """Run the stacked blocks over x (B, T, d). Returns (x, aux_sum);
    ``return_kv=True`` adds each layer's per-head keys/values stacked
    ``(L, B, T, H, Dh)`` in compute dtype: ``(x, aux_sum, (k, v))``.
    Each block is rematerialized under ``cfg.remat_policy`` when
    ``cfg.remat`` is on, grad is enabled and ``return_kv`` is off."""
    if cfg.n_experts:
        raise NotImplementedError("MoE blocks are not ported yet")
    b, t = x.shape[0], x.shape[1]
    # one unbind per leaf: its backward stacks the L grads once
    layers = [dict(zip(blocks, ws))
              for ws in zip(*(w.unbind(0) for w in blocks.values()))]
    layers = layers[:cfg.n_layers]
    block = _block
    if cfg.remat and torch.is_grad_enabled() and not return_kv:
        block = _remat_wrap(cfg.remat_policy)
    ks, vs = [], []
    for w in layers:
        if return_kv:
            a, k, v = _attn_half(cfg, x, w["ln1"], w["wqkv"])
            x = _mlp_half(cfg, x, a, w["wo"], w["ln2"], w["w_in"],
                          w["w_out"])
            ks.append(k.reshape(b, t, cfg.n_heads, cfg.head_dim))
            vs.append(v.reshape(b, t, cfg.n_heads, cfg.head_dim))
        else:
            x = block(cfg, x, w)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
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


def _chunk_nll(xc, head, tc, wc, bias):
    # the product in the compute dtype, then f32 — the reference's rounding
    logits = (xc @ head).float()
    if bias is not None:
        logits = logits + bias.float()
    lse = torch.logsumexp(logits, dim=-1)
    tl = logits.gather(-1, tc[:, None].long())[:, 0]
    return ((lse - tl) * wc).sum()          # pad rows weighted out


def _chunked_ce(x, head, targets, chunk, weights=None, bias=None):
    """Weighted-sum NLL of (N, d) hidden rows against (N,) targets without
    ever holding the (N, V) f32 logits: a loop over row chunks, each under
    a checkpoint, so backward recomputes the chunk's logits from its
    (small) saved rows. Returns sum(w·nll); the caller divides by its own
    denominator. ``weights`` default to 1 per row; ``bias`` (V,) is an
    output bias."""
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
                            bias)
    return total


def lm_loss(params, cfg: TransformerConfig, ids, targets, *,
            aux_weight=1e-2, pos_offset=0):
    """Mean next-token NLL of ``targets`` (B, T) given ``ids`` (B, T),
    plus ``aux_weight`` · the blocks' auxiliary loss (0 for dense
    blocks). Differentiable in the params."""
    b, t = ids.shape
    if _use_fused_loss(cfg, b * t):
        x = embed(params, cfg, ids, pos_offset)
        x, aux = apply_blocks(params["blocks"], cfg, x)
        x = _rmsnorm(x, params["ln_f"])
        head = _resolve_head(params, cfg)
        nll = _chunked_ce(x.reshape(b * t, -1), head.to(x.dtype),
                          targets.reshape(b * t), cfg.loss_chunk) / (b * t)
        return nll + aux_weight * aux
    logits, aux = forward(params, cfg, ids, train=True,
                          pos_offset=pos_offset)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    return nll.mean() + aux_weight * aux


def param_leaves(params):
    """The params dict's tensors, in the order of its keys, each set to
    require grad — what an optimizer for :func:`make_train_step` takes."""
    if isinstance(params, dict):
        return [t for v in params.values() for t in param_leaves(v)]
    return [params.requires_grad_(True)]


def make_train_step(cfg: TransformerConfig, optimizer):
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

    def static_step(ids, targets):
        optimizer.zero_grad(set_to_none=True)
        loss = lm_loss(bound["params"], cfg, ids, targets)
        loss.backward()
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

    compiled = CompiledStep(static_step, bindings, "make_train_step")

    def step(params, ids, targets):
        dev = params["embed"].device
        ids = torch.as_tensor(ids, device=dev).long()
        targets = torch.as_tensor(targets, device=dev).long()
        if dev.type == "cuda" and graphs_enabled() and not all(
                g.get("capturable", False) for g in optimizer.param_groups):
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
