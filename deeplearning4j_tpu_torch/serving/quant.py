"""The quantization plane: int8 KV pages and int8 decode weights behind
the fidelity gate. Port of ``deeplearning4j_tpu/serving/quant.py``.

- **int8 KV pages** — rows quantize at page append (symmetric, one
  ``amax/127`` scale a row and head) and dequantize where the attention
  gathers them. The scales share the pool's page axis
  (``kvcache.init_paged_cache(quantized=True)``), so CoW copies, prefix
  sharing, release and rollback move them with their rows.
- **int8 weights, compute-dtype math** — the block stack's matmul weights
  (wqkv, wo, w_in, w_out) quantize once an engine with one scale an output
  channel and dequantize a layer at a time in the decode body (the
  engine's ``_wload``); embeddings, norms and the head stay as they are,
  and prefills never see the int8 weights.

Neither mode is dispatched on faith. ``race_*`` runs the int8 arm against
the full-precision arm on identical probe content, gates on the
FidelityProbe's ``kl_max`` under :data:`PROMOTION_MAX_KL`, keeps the
verdict as a sha-stamped ``quant_kv:*`` / ``quant_w:*`` cost record in the
port's autotune store and counts it in
``dl4j_autotune_promotions_total{kernel,verdict}``.

Where the port differs from the reference:

- ``auto`` resolves to bf16 on every device (the reference races on the
  TPU): a race runs only when asked (``mode="race"``, the engine's
  ``quant_kv=``/``quant_weights="race"`` or ``$DL4J_QUANT_KV`` /
  ``$DL4J_QUANT_W``);
- :func:`race_kv`'s bf16 arm is the engine's own bf16 dispatch for the
  geometry — K2 on the card (gather on the CPU) — against the int8 pool's
  gather-dequant path; the reference times gather against gather, a path
  the card never runs. The record's meta names both arms.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..kernels import autotune
from ..kernels import paged_attention as pa
from ..kernels.paged_attention import PROMOTION_MAX_KL
from ..nn._compiled import Bound
from . import kvcache

#: symmetric int8 range: scales are amax/127, values clip to ±127
QMAX = 127.0

#: env knobs for the two dispatch modes when the engine pins none:
#: auto (bf16) | race | on | off
_KV_MODE_ENV = "DL4J_QUANT_KV"
_W_MODE_ENV = "DL4J_QUANT_W"

_OFF = ("off", "0", "bf16", "none")
_ON = ("on", "1", "int8")

#: the block-stack matmul weights the int8 weight path stores quantized
_W_NAMES = ("wqkv", "wo", "w_in", "w_out")


# --------------------------------------------------------- primitives --

def quantize_rows(rows):
    """Symmetric int8 quantization of k/v rows ``(..., H, Dh)``: one scale
    ``amax(|row|)/127`` (f32) a row and head, values rounded half to even
    (as ``jnp.round``) after a true division by the scale and clipped to
    ±127. Returns ``(int8 rows (..., H, Dh), f32 scales (..., H))``."""
    r = rows.float()
    amax = r.abs().amax(dim=-1)
    scale = amax.clamp(min=1e-8) / QMAX
    q = torch.round(r / scale[..., None]).clamp(-QMAX, QMAX)
    return q.to(torch.int8), scale


def dequantize_rows(q, scale, dtype=torch.float32):
    """Inverse of :func:`quantize_rows` (the gather-side dequant)."""
    return (q.float() * scale[..., None].float()).to(dtype)


def quantize_block_weights(blocks) -> Dict:
    """The stacked block matmul weights ``(L, in, out)`` as int8 with one
    scale an output channel ``(L, 1, out)`` under ``name + "_scale"`` —
    the layout the engine's ``_wload`` dequantizes. The other entries
    (norms) are the same tensors, not copies."""
    out = dict(blocks)
    for name in _W_NAMES:
        w = blocks[name].float()
        amax = w.abs().amax(dim=1, keepdim=True)            # (L, 1, out)
        scale = amax.clamp(min=1e-12) / QMAX
        out[name] = torch.round(w / scale).clamp(-QMAX, QMAX).to(torch.int8)
        out[name + "_scale"] = scale
    return out


def quantized_params(params) -> Dict:
    """Params with ONLY the block stack replaced by its int8 form; embed,
    pos_embed, ln_f and head are the same tensors."""
    return dict(params, blocks=quantize_block_weights(params["blocks"]))


def quant_sha() -> str:
    """Fingerprint stamped on every ``quant_kv:*``/``quant_w:*`` record:
    editing the quantization math invalidates the stale verdicts."""
    return autotune.source_sha(quantize_rows, quantize_block_weights)


# ---------------------------------------------------------- promotion --

def kv_bucket_key(cfg, n_slots: int, n_pages: int, page_len: int,
                  backend: str = "cuda") -> str:
    """Shape-bucket cost-record key of one paged-pool geometry."""
    return (f"quant_kv:L{cfg.n_layers}H{cfg.n_heads}D{cfg.head_dim}"
            f":PL{int(page_len)}:NP{int(n_pages)}:S{int(n_slots)}"
            f":{autotune.dtype_name(cfg.dtype)}:{backend}")


def w_bucket_key(cfg, backend: str = "cuda") -> str:
    """Shape-bucket cost-record key of one block-stack geometry."""
    return (f"quant_w:L{cfg.n_layers}H{cfg.n_heads}D{cfg.head_dim}"
            f"F{cfg.d_ff}:{autotune.dtype_name(cfg.dtype)}:{backend}")


def _probe_paged(cfg, n_slots: int, n_pages: int, page_len: int,
                 max_len: int, device):
    """Two probe pools of one geometry, on ``device``: the compute-dtype
    pool and the int8 pool of the SAME content (``default_rng(0)``, the
    reference's draws) pushed through :func:`quantize_rows`, so that the
    fidelity diff measures quantization and nothing else; the paged
    race's table and cursors (``paged_attention._probe_layout``). Returns
    (full cache, int8 cache, tokens)."""
    rng = np.random.default_rng(0)
    per_slot = -(-int(max_len) // int(page_len))
    kshape = (cfg.n_layers, int(n_pages), int(page_len), cfg.n_heads,
              cfg.head_dim)
    meta = pa._probe_layout(n_slots, per_slot, n_pages, page_len, device)
    k = torch.from_numpy(rng.standard_normal(kshape).astype(np.float32)) \
        .to(device)
    v = torch.from_numpy(rng.standard_normal(kshape).astype(np.float32)) \
        .to(device)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (n_slots,))
                            .astype(np.int64)).to(device)
    full = dict(meta, k=k.to(cfg.dtype), v=v.to(cfg.dtype))
    qk, sk = quantize_rows(k)
    qv, sv = quantize_rows(v)
    quant = dict(meta, k=qk, v=qv, k_scale=sk, v_scale=sv)
    return full, quant, toks


def _promote(key: str, kernel: str, arms: Dict[str, float],
             cand: str, ref: str, fid: Dict, fidelity_ok: bool,
             max_kl: float, backend: str,
             extra: Optional[Dict] = None) -> Dict:
    """The verdict, record and counter every race here ends in: the
    candidate wins only when fidelity holds AND it measured faster."""
    from ..obs import get_registry

    if fidelity_ok:
        chosen = cand if arms[cand] < arms[ref] else ref
        verdict = "promoted" if chosen == cand else "fallback_slower"
    else:
        chosen, verdict = ref, "fallback_fidelity"
    meta = {
        "verdict": verdict,
        f"{ref}_s": arms.get(ref),
        f"{cand}_s": arms.get(cand),
        "speedup": (round(arms[ref] / arms[cand], 3)
                    if arms.get(cand) else None),
        "max_kl": max_kl,
        "fidelity": pa._fid_compact(fid),
        "backend": backend,
    }
    if extra:
        meta.update(extra)
    autotune.put(key, (chosen,), meta=meta, sha=quant_sha())
    get_registry().counter(
        "dl4j_autotune_promotions_total",
        "Fidelity-gated kernel-vs-XLA promotion races, by verdict",
        labelnames=("kernel", "verdict")).inc(
            kernel=kernel, verdict=verdict)
    return dict(meta, choice=chosen, key=key)


def race_kv(engine, n_slots: int, n_pages: int,
            page_len: int = kvcache.DEFAULT_PAGE_LEN, *,
            max_kl: float = PROMOTION_MAX_KL) -> Dict:
    """Race the int8 pool against the engine's bf16 dispatch on identical
    probe content at one geometry; gate on ``kl_max``; persist the
    verdict. Verdicts: ``promoted`` (fidelity holds, int8 decode measured
    faster), ``fallback_slower``, ``fallback_fidelity``."""
    from ..obs.fidelity import FidelityProbe

    cfg = engine.cfg
    backend = engine.device.type
    key = kv_bucket_key(cfg, n_slots, n_pages, page_len, backend)
    full, quant, toks = _probe_paged(cfg, n_slots, n_pages, page_len,
                                     engine.max_len, engine.device)
    wmode = engine._decode_params()
    ref_fn = engine._paged_entry(full)
    fns = {"bf16": ref_fn, "int8": engine._decode_paged}
    probes = {"bf16": full, "int8": quant}
    logits = {name: fns[name](Bound(pa._clone(probes[name])), toks, wmode)
              for name in ("bf16", "int8")}
    fid = FidelityProbe("quant_kv_vs_bf16").compare(
        logits["bf16"].float(), logits["int8"].float())
    fidelity_ok = fid["kl_max"] <= max_kl

    arms = {name: pa._timed(fns[name], probes[name], toks, wmode)
            for name in ("bf16", "int8")}
    bpt = {name: kvcache.token_nbytes(
        kvcache.init_paged_cache(cfg, 1, 1, page_len, engine.max_len,
                                 quantized=(name == "int8"),
                                 device=engine.device))
        for name in ("bf16", "int8")}
    return _promote(key, "quant_kv", arms, "int8", "bf16", fid,
                    fidelity_ok, max_kl, backend,
                    extra={"bytes_per_token": bpt, "arms": {
                        "bf16": ref_fn.name, "int8": "decode_paged"}})


def race_weights(engine, *, max_kl: float = PROMOTION_MAX_KL) -> Dict:
    """Race int8-weight decode against full-weight decode on one dense
    probe cache; gate on ``kl_max``; persist the verdict (the vocabulary
    of :func:`race_kv`)."""
    from ..obs.fidelity import FidelityProbe

    cfg = engine.cfg
    backend = engine.device.type
    key = w_bucket_key(cfg, backend)
    probe_len = min(engine.max_len, 256)
    dev = engine.device
    r = np.random.default_rng(0)
    shape = (cfg.n_layers, 2, probe_len, cfg.n_heads, cfg.head_dim)
    probe = {"k": torch.from_numpy(r.standard_normal(shape)).to(dev)
             .to(cfg.dtype),
             "v": torch.from_numpy(r.standard_normal(shape)).to(dev)
             .to(cfg.dtype),
             "pos": torch.full((2,), probe_len // 2, dtype=torch.int32,
                               device=dev)}
    toks = torch.from_numpy(r.integers(0, cfg.vocab_size, (2,))
                            .astype(np.int64)).to(dev)
    engine._quantized_weights()       # the int8 stack, built once
    logits = {name: engine._decode(Bound(pa._clone(probe)), toks, name)
              for name in ("bf16", "int8")}
    fid = FidelityProbe("quant_w_vs_bf16").compare(
        logits["bf16"].float(), logits["int8"].float())
    fidelity_ok = fid["kl_max"] <= max_kl

    arms = {name: pa._timed(engine._decode, probe, toks, name)
            for name in ("bf16", "int8")}
    return _promote(key, "quant_w", arms, "int8", "bf16", fid,
                    fidelity_ok, max_kl, backend)


# ----------------------------------------------------------- dispatch --

def _resolve_mode(pinned: Optional[str], env: str) -> str:
    mode = pinned if pinned is not None else os.environ.get(env, "auto")
    return str(mode).lower()


def _check_mode(mode: str, knob: str):
    if mode not in _OFF + _ON + ("auto", "race"):
        raise ValueError(f"unknown {knob} mode {mode!r}; expected "
                         "off|on|auto|race")


def decide_kv(engine, n_slots: int, n_pages: int,
              page_len: int = kvcache.DEFAULT_PAGE_LEN,
              mode: Optional[str] = None) -> str:
    """``"int8"`` or ``"bf16"`` for one pool geometry. ``mode`` (or the
    engine's pinned ``quant_kv_mode``, or ``$DL4J_QUANT_KV``, default
    ``auto``): ``off`` → bf16, ``on`` → int8, ``auto`` → bf16 (never a
    race), ``race`` → the sha-matching cost record, else :func:`race_kv`.
    Every resolution counts into ``dl4j_quant_pool_total{kernel,mode}``."""
    from ..obs import get_registry
    if mode is None:
        mode = _resolve_mode(getattr(engine, "quant_kv_mode", None),
                             _KV_MODE_ENV)
    mode = str(mode).lower()
    _check_mode(mode, "quant_kv")
    if mode in _ON:
        choice = "int8"
    elif mode == "race":
        rec = autotune.lookup(
            kv_bucket_key(engine.cfg, n_slots, n_pages, page_len,
                          engine.device.type),
            sha=quant_sha())
        if rec is not None and rec["choice"]:
            choice = str(rec["choice"][0])
        else:
            choice = str(race_kv(engine, n_slots, n_pages,
                                 page_len)["choice"])
    else:
        choice = "bf16"
    get_registry().counter(
        "dl4j_quant_pool_total",
        "KV pools allocated, by resolved storage mode",
        labelnames=("kernel", "mode")).inc(kernel="quant_kv", mode=choice)
    return choice


def decide_weights(engine, mode: Optional[str] = None) -> str:
    """``"int8"`` or ``"bf16"`` for the engine's decode weights — the
    ladder of :func:`decide_kv` over ``quant_weights_mode`` /
    ``$DL4J_QUANT_W``, the verdict cached a block-stack geometry. Counts
    into ``dl4j_quant_weights_total{kernel,mode}``."""
    from ..obs import get_registry
    if mode is None:
        mode = _resolve_mode(getattr(engine, "quant_weights_mode", None),
                             _W_MODE_ENV)
    mode = str(mode).lower()
    _check_mode(mode, "quant_weights")
    if mode in _ON:
        choice = "int8"
    elif mode == "race":
        rec = autotune.lookup(
            w_bucket_key(engine.cfg, engine.device.type),
            sha=quant_sha())
        if rec is not None and rec["choice"]:
            choice = str(rec["choice"][0])
        else:
            choice = str(race_weights(engine)["choice"])
    else:
        choice = "bf16"
    get_registry().counter(
        "dl4j_quant_weights_total",
        "Engine decode-weight resolutions, by storage mode",
        labelnames=("kernel", "mode")).inc(kernel="quant_w", mode=choice)
    return choice
