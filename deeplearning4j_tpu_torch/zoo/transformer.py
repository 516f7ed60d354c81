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

Training (``lm_loss``, the chunked CE, the train step, remat), MoE,
ring/sharded attention and BERT are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

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
    # kept for config parity with the reference; inference never remats
    remat: bool = True
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
        neg = torch.tensor(torch.finfo(torch.bfloat16).min / 2,
                           dtype=torch.bfloat16, device=q.device)
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                     device=q.device))
        logits = torch.where(mask, logits, neg)
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
    rounds to bf16 before the product, and so does it here."""
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                            device=x.device)


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


def apply_blocks(blocks, cfg: TransformerConfig, x, *, return_kv=False):
    """Run the stacked blocks over x (B, T, d). Returns (x, aux_sum);
    ``return_kv=True`` adds each layer's per-head keys/values stacked
    ``(L, B, T, H, Dh)`` in compute dtype: ``(x, aux_sum, (k, v))``."""
    if cfg.n_experts:
        raise NotImplementedError("MoE blocks are not ported yet")
    b, t = x.shape[0], x.shape[1]
    ks, vs = [], []
    for l in range(cfg.n_layers):
        h = _rmsnorm(x, blocks["ln1"][l])
        qkv = h @ blocks["wqkv"][l].to(h.dtype)
        q, k, v = qkv.chunk(3, dim=-1)
        a = _attention(cfg, q, k, v)
        x = x + a @ blocks["wo"][l].to(h.dtype)
        h2 = _rmsnorm(x, blocks["ln2"][l])
        x = x + _dense_mlp(cfg, h2, blocks["w_in"][l], blocks["w_out"][l])
        if return_kv:
            ks.append(k.reshape(b, t, cfg.n_heads, cfg.head_dim))
            vs.append(v.reshape(b, t, cfg.n_heads, cfg.head_dim))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_kv:
        return x, aux, (torch.stack(ks), torch.stack(vs))
    return x, aux


def forward(params, cfg: TransformerConfig, ids, *, pos_offset=0):
    """ids (B, T) int → logits (B, T, vocab) f32. Returns (logits, aux)."""
    with torch.no_grad():
        x = embed(params, cfg, ids, pos_offset)
        x, aux = apply_blocks(params["blocks"], cfg, x)
        return head_logits(params, cfg, x), aux


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
