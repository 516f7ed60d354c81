"""Paged-KV decode attention (K2): the CUDA kernel ``csrc/paged_attention.cu``
and its plain PyTorch version.

Port of ``deeplearning4j_tpu/kernels/paged_attention.py``. One decode
token per slot attends over that slot's pages of a block-paged pool:
``q`` (B, H, Dh); ``k_pages``/``v_pages`` (n_pages, page_len, H, Dh) —
ONE layer's pool; ``table`` (B, P) int32 per-slot page-table rows with
the sentinel ``n_pages`` for unmapped entries; ``pos`` (B,) int32 cursors
(rows ``<= pos[b]`` are valid). Returns (B, H, Dh) in q's dtype.

The kernel is split-K flash-decoding in two passes
(``csrc/paged_attention.cu``): pass 1 cuts each slot's page-table row
into splits of ``pages_per_split`` logical pages and writes each (split,
head)'s partial softmax state (m, l, acc) in f32 to a workspace this
wrapper allocates; pass 2 merges a slot's splits in a fixed order, so a
second launch is bit-identical. :func:`split_plan` is the launcher's
choice of split, in plain Python. The kernel skips sentinel pages and
pages past the cursor, gives zeros for a slot with no live row, and
takes every head dim whose pass-1 block fits in a block's shared memory
at one head and one staged row (:func:`partial_smem`; ``MAX_HEAD_DIM``,
11621, in both dtypes), as the reference's Pallas blocks take any head
dim. The plain version
is the gather path the engine runs with the kernel off: it gathers every
table entry, CLAMPING the sentinel to the last pool page as a JAX gather
does, so a sentinel entry below the cursor reads masked-in garbage
there, exactly as in the reference. Keep every position up to the cursor
mapped and the two agree.

Dispatch (:func:`decide`) is ``off`` → gather, ``on`` → kernel, ``auto``
→ kernel on CUDA and gather on the CPU, ``race`` → the fidelity-gated
promotion race (:func:`race`): on probe caches of the live geometry the
kernel's logits must hold ``kl_max`` under :data:`PROMOTION_MAX_KL` with
greedy tokens identical to the gather path's, and then the faster arm
wins. The verdict is a cost record in the port's autotune store
(``kernels/autotune.py``, key :func:`bucket_key`) stamped with
:func:`kernel_sha` — the bytes of ``csrc/paged_attention.cu`` and the
wrapper's source — and counted in
``dl4j_autotune_promotions_total{kernel,verdict}``.

Where the port differs from the reference: ``auto`` never races (the
reference races on the TPU). The main path takes K2 on a CUDA pool
whatever a timing says; a race runs only when asked (``mode="race"``, the
engine's ``paged_kernel="race"`` or ``$DL4J_PAGED_KERNEL=race``). A race
catches nothing: a build or launch error of the kernel propagates, and
``fallback_fidelity`` comes only from a measured ``kl_max`` or greedy
mismatch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import _build, autotune

NEG_INF = -1e30

#: promotion fidelity budget: max per-position KL(gather ‖ kernel), nats —
#: the reference's bound; greedy tokens must match as well
PROMOTION_MAX_KL = 1e-3

#: env knob for the dispatch mode when the engine pins none:
#: auto (the kernel on CUDA, gather on the CPU) | race | on | off
_MODE_ENV = "DL4J_PAGED_KERNEL"

_SOURCE = "paged_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: shared memory a block may use on the H100 (sm_90): 227 KiB
SMEM_PER_BLOCK = 232448

#: the most splits a slot's row is cut into (pass 2 merges one a thread)
MAX_SPLITS = 256
#: pass-1 blocks per SM the split plan aims at when every table entry is
#: live (the host cannot see the cursors without a sync)
BLOCKS_PER_SM = 8
#: f32 elements of q and of the accumulator one pass-1 block holds in
#: shared memory: heads beyond them go to another block (a head group)
BLOCK_ELEMS = 4096
#: bytes of K and V rows one pass-1 stage holds in shared memory
STAGE_BYTES = 32768

#: launches of the CUDA kernel since the last reset (the plain version on
#: CPU tensors does not count); one count covers both passes
LAUNCHES = 0


def reset_launches():
    global LAUNCHES
    LAUNCHES = 0


def paged_attention(q, k_pages, v_pages, table, pos):
    """Fused single-token attention over a block-paged KV pool. CPU
    tensors take :func:`paged_attention_reference`; CUDA tensors launch
    the kernel (or raise) — there is no fallback between the two."""
    dev = q.device.type
    if dev == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, table, pos)
    if dev != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda tensors, "
                         f"got {q.device}")
    return _paged_attention_cuda(q, k_pages, v_pages, table, pos)


def partial_smem(item: int, vec: bool, hb: int, dh: int, rows: int) -> int:
    """Shared bytes of one pass-1 block (csrc/paged_attention.cu
    ``partial_smem``): ``rows`` staged K and V rows of ``hb`` heads of
    ``dh`` elements of ``item`` bytes, then f32 q, the accumulator, the
    partial dots (one a 16-byte load when ``vec``, else one an element),
    the scores of a stage and three per-head values."""
    per_load = 16 // item if vec else 1
    return 2 * rows * hb * dh * item + 4 * (
        2 * hb * dh + rows * hb * dh // per_load + rows * hb + 3 * hb)


#: the largest head dim the kernel takes in both dtypes: pass 1's block at
#: one head and one staged row fits in SMEM_PER_BLOCK (f32, scalar loads,
#: is the largest case)
MAX_HEAD_DIM = max(d for d in range(1, 16384)
                   if partial_smem(4, False, 1, d, 1) <= SMEM_PER_BLOCK)


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """How the two passes cut one call: each slot's table row into
    ``n_splits`` runs of ``pages_per_split`` logical pages, its heads into
    groups of ``heads_per_block``, and a page's rows into stages of
    ``rows_per_stage``."""
    pages_per_split: int
    n_splits: int
    heads_per_block: int
    rows_per_stage: int


def split_plan(b: int, h: int, dh: int, item: int, page_len: int,
               per_slot: int, n_sms: int) -> SplitPlan:
    """The launcher's split for ``b`` slots of ``per_slot`` table entries,
    ``h`` heads of ``dh`` elements of ``item`` bytes, on a card of
    ``n_sms`` SMs: the fewest pages a split (at least one) that still
    puts ``BLOCKS_PER_SM`` pass-1 blocks on every SM when the table is
    full, and at most ``MAX_SPLITS`` splits a slot. At the 120M decode
    shape (8 slots, 128 entries, H 8, Dh 64 bf16, 132 SMs) that is one
    page a split: 1024 blocks, one for each live page. The heads a block
    and the rows a stage shrink, rows first, until pass 1's block fits in
    ``SMEM_PER_BLOCK`` (scalar loads, the larger case), which they do at
    one of each for every head dim up to ``MAX_HEAD_DIM``."""
    hpb = min(h, max(1, BLOCK_ELEMS // dh))
    rows = max(1, min(page_len, STAGE_BYTES // (2 * hpb * dh * item)))
    while partial_smem(item, False, hpb, dh, rows) > SMEM_PER_BLOCK \
            and rows * hpb > 1:
        if rows > 1:
            rows -= 1
        else:
            hpb -= 1
    groups = -(-h // hpb)
    pps = max(1, (b * groups * per_slot) // (BLOCKS_PER_SM * n_sms),
              -(-per_slot // MAX_SPLITS))
    return SplitPlan(pages_per_split=pps, n_splits=-(-per_slot // pps),
                     heads_per_block=hpb, rows_per_stage=rows)


def _paged_attention_cuda(q, k_pages, v_pages, table, pos):
    global LAUNCHES
    b, h, dh = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"k/v pages must share a (n_pages, page_len, H, "
                         f"Dh) shape, got {tuple(k_pages.shape)} and "
                         f"{tuple(v_pages.shape)}")
    npg, plen, hk, dk = k_pages.shape
    if (hk, dk) != (h, dh):
        raise ValueError(f"pages hold (H, Dh)=({hk}, {dk}), q has "
                         f"({h}, {dh})")
    if table.dim() != 2 or table.shape[0] != b or pos.shape != (b,):
        raise ValueError(f"table must be (B, P) and pos (B,) for B={b}, "
                         f"got {tuple(table.shape)}, {tuple(pos.shape)}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"kernel takes float32 or bfloat16 q and pages of "
                         f"one dtype, got {q.dtype}/{k_pages.dtype}/"
                         f"{v_pages.dtype}")
    if table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("table and pos must be int32")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(
            f"head dim {dh} outside 1..{MAX_HEAD_DIM}: pass 1's block needs "
            f"{partial_smem(4, False, 1, max(dh, 1), 1)} bytes of shared "
            f"memory at one head and one staged row (f32), and a block may "
            f"use 227 KiB ({SMEM_PER_BLOCK} bytes) on the H100")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("table", table), ("pos", pos)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError("paged_attention is a decode kernel and "
                                  "has no backward")
    lib = _load()
    item = q.element_size()
    plan = split_plan(b, h, dh, item, plen, table.shape[1],
                      _n_sms(q.device))
    # 16-byte loads where a head's row is a whole number of them
    vec = (dh * item) % 16 == 0 and k_pages.data_ptr() % 16 == 0 \
        and v_pages.data_ptr() % 16 == 0
    out = torch.empty_like(q)
    # the partials of pass 1: m and l (n_splits, B, H), acc (.., Dh)
    rows = plan.n_splits * b * h
    ws = torch.empty(rows * (dh + 2), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.dl4j_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        table.data_ptr(), pos.data_ptr(), out.data_ptr(), ws.data_ptr(),
        ws.data_ptr() + 4 * rows, ws.data_ptr() + 8 * rows, b, h, dh, npg,
        plen, table.shape[1], plan.pages_per_split, plan.n_splits,
        plan.heads_per_block, plan.rows_per_stage, 1.0 / math.sqrt(dh),
        _DTYPES[q.dtype], int(vec), stream)
    _build.check(rc, "paged_attention")
    LAUNCHES += 1
    return out


_SMS = {}


def _n_sms(device) -> int:
    """The card's SM count, read once per device (every launch, and every
    capture of a decode step, plans with it)."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx) \
            .multi_processor_count
    return _SMS[idx]


def _load():
    lib = _build.load(_SOURCE)
    fn = lib.dl4j_paged_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i] * 10 + [ctypes.c_float, i, i, p]
        fn.restype = i
    return lib


def paged_attention_reference(q, k_pages, v_pages, table, pos):
    """The gather path: materialize each slot's fixed-width table row
    (sentinel entries clamp to the last pool page — garbage the pos mask
    never exposes while the slot's rows up to pos are mapped), f32
    softmax over the masked scores."""
    b, h, dh = q.shape
    npg, plen = k_pages.shape[0], k_pages.shape[1]
    per_slot = table.shape[1]
    idx = table.long().clamp(0, npg - 1)
    kg = k_pages[idx].reshape(b, per_slot * plen, h, dh)
    vg = v_pages[idx].reshape(b, per_slot * plen, h, dh)
    scale = 1.0 / math.sqrt(dh)
    scores = torch.einsum("bhd,bshd->bhs", q.float() * scale, kg.float())
    s = kg.shape[1]
    mask = torch.arange(s, device=q.device)[None, :] <= pos.long()[:, None]
    # a Python fill value, not a tensor copied to the card: the gather
    # path runs inside a captured decode step
    scores = scores.masked_fill(~mask[:, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", probs, vg.float())
    return out.to(q.dtype)


def kernel_sha() -> str:
    """Fingerprint stamped on every ``paged_decode:*`` cost record: the
    bytes of ``csrc/paged_attention.cu`` and the source of the wrapper
    that plans and launches it. Editing either invalidates the stale
    verdicts at their next lookup."""
    return autotune.source_sha(_build.SRC_DIR / f"{_SOURCE}.cu",
                               paged_attention, _paged_attention_cuda,
                               split_plan, partial_smem)


# --------------------------------------------------------- promotion --

def bucket_key(cfg, cache, backend: Optional[str] = None) -> str:
    """The shape-bucket cost-record key of one engine geometry: kernel
    kind, model shape, pool geometry, dtype and backend (the pool's
    device type unless given) — the JAX package's key where both run on
    the CPU."""
    if backend is None:
        backend = cache["k"].device.type
    npg, plen = cache["k"].shape[1], cache["k"].shape[2]
    slots, per_slot = cache["pages"].shape
    dt = autotune.dtype_name(cache["k"].dtype)
    return (f"paged_decode:L{cfg.n_layers}H{cfg.n_heads}D{cfg.head_dim}"
            f":PL{plen}:P{per_slot}:NP{npg}:S{slots}:{dt}:{backend}")


def _probe_layout(slots: int, per_slot: int, npg: int, plen: int,
                  device) -> Dict:
    """The page table and cursors of a race's probe pool: every slot
    mapped to ~3/4 of its table width with contiguous distinct pages
    (while the pool lasts), its cursor mid-way into its last page."""
    table = np.full((slots, per_slot), npg, np.int32)
    nxt = 0
    pos = np.zeros((slots,), np.int32)
    for s in range(slots):
        want = max(1, (3 * per_slot) // 4)
        got = min(want, npg - nxt)
        if got < 1:                       # pool exhausted: leave empty
            continue
        table[s, :got] = np.arange(nxt, nxt + got)
        nxt += got
        pos[s] = (got - 1) * plen + plen // 2
    return {"pos": torch.from_numpy(pos).to(device),
            "pages": torch.from_numpy(table).to(device)}


def _probe_cache(cfg, cache) -> Tuple[Dict, torch.Tensor]:
    """A probe cache of the live cache's exact shapes, on its device:
    random k/v content (``np.random.default_rng(0)``, the reference's
    draws) over :func:`_probe_layout`. Returns (cache, probe tokens)."""
    rng = np.random.default_rng(0)
    kshape = tuple(cache["k"].shape)
    dev, dt = cache["k"].device, cache["k"].dtype
    slots, per_slot = cache["pages"].shape

    def pool():
        return torch.from_numpy(rng.standard_normal(kshape)).to(dev).to(dt)
    probe = dict(_probe_layout(slots, per_slot, kshape[1], kshape[2], dev),
                 k=pool(), v=pool())
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (slots,))
                            .astype(np.int64)).to(dev)
    return probe, toks


def _clone(tree):
    return {k: v.clone() for k, v in tree.items()}


def _timed(fn, probe, toks, wmode) -> float:
    """:func:`autotune._time_once` of the decode entry point ``fn`` on its
    own copy of ``probe`` (the race's arms run the same content)."""
    from ..nn._compiled import Bound
    state = _clone(probe)
    return autotune._time_once(lambda: fn(Bound(state), toks, wmode))


def _fid_compact(rep: Dict) -> Dict:
    keep = ("max_abs_err", "mean_abs_err", "kl_mean", "kl_max",
            "topk_agreement", "greedy_match_frac", "greedy_prefix_len",
            "positions")
    return {k: rep[k] for k in keep if k in rep}


def race(engine, cache, *, max_kl: float = PROMOTION_MAX_KL) -> Dict:
    """Race K2 against the gather path on probe caches of ``cache``'s
    geometry; gate on fidelity; persist the verdict as a sha-stamped
    cost record; count it in
    ``dl4j_autotune_promotions_total{kernel,verdict}``.

    Returns the record's meta with ``choice`` and ``key``: ``{verdict,
    gather_s, kernel_s, speedup, max_kl, fidelity, backend}``. Verdicts:
    ``promoted`` (fidelity holds and the kernel measured faster),
    ``fallback_slower`` (fidelity holds, gather measured faster),
    ``fallback_fidelity`` (``kl_max`` or greedy equivalence failed).
    Both arms run on the full weights and are timed whatever the
    fidelity says; the probes are new caches, so their graphs are their
    own and go with them. Nothing is caught: a kernel that fails to
    build or launch raises."""
    from ..obs import get_registry
    from ..obs.fidelity import FidelityProbe
    from ..nn._compiled import Bound

    cfg = engine.cfg
    key = bucket_key(cfg, cache)
    sha = kernel_sha()
    arms = (("gather", engine._decode_paged),
            ("kernel", engine._decode_paged_kernel))
    # fidelity first: one step from IDENTICAL probe content through both
    probe, toks = _probe_cache(cfg, cache)
    logits = {name: fn(Bound(_clone(probe)), toks, "bf16")
              for name, fn in arms}
    fid = FidelityProbe("paged_kernel_vs_xla").compare(
        logits["gather"].float(), logits["kernel"].float())
    fidelity_ok = (fid["kl_max"] <= max_kl
                   and fid["greedy_match_frac"] == 1.0)

    # both arms are timed whatever the fidelity outcome: fidelity gates
    # the promotion, never the measurement
    timings = {name: _timed(fn, probe, toks, "bf16") for name, fn in arms}
    if fidelity_ok:
        chosen = ("kernel" if timings["kernel"] < timings["gather"]
                  else "gather")
        verdict = "promoted" if chosen == "kernel" else "fallback_slower"
    else:
        chosen, verdict = "gather", "fallback_fidelity"

    meta = {
        "verdict": verdict,
        "gather_s": timings["gather"],
        "kernel_s": timings["kernel"],
        "speedup": round(timings["gather"] / timings["kernel"], 3),
        "max_kl": max_kl,
        "fidelity": _fid_compact(fid),
        "backend": cache["k"].device.type,
    }
    autotune.put(key, (chosen,), meta=meta, sha=sha)
    get_registry().counter(
        "dl4j_autotune_promotions_total",
        "Fidelity-gated kernel-vs-XLA promotion races, by verdict",
        labelnames=("kernel", "verdict")).inc(
            kernel="paged_decode", verdict=verdict)
    return dict(meta, choice=chosen, key=key)


def decide(engine, cache, mode: Optional[str] = None) -> str:
    """``"kernel"`` or ``"gather"`` for one engine × cache. ``mode`` (or
    the engine's pinned mode, or ``$DL4J_PAGED_KERNEL``, default
    ``auto``): ``off`` → gather, ``on`` → kernel, ``auto`` → the kernel
    when the pool lies on a CUDA device, else gather (never a race);
    ``race`` → the cost record of this geometry while its sha matches
    the kernel's source, else :func:`race`. A CUDA pool the kernel cannot
    take (head dim past ``MAX_HEAD_DIM``, 11621) is refused by the
    kernel's wrapper, never handed to the gather path."""
    if mode is None:
        mode = getattr(engine, "paged_kernel_mode", None) \
            or os.environ.get(_MODE_ENV, "auto")
    mode = str(mode).lower()
    if mode in ("off", "0", "gather"):
        return "gather"
    if mode in ("on", "1", "kernel"):
        return "kernel"
    if mode == "auto":
        return "kernel" if cache["k"].device.type == "cuda" else "gather"
    if mode == "race":
        rec = autotune.lookup(bucket_key(engine.cfg, cache),
                              sha=kernel_sha())
        if rec is not None and rec["choice"]:
            return str(rec["choice"][0])
        return str(race(engine, cache)["choice"])
    raise ValueError(f"unknown paged-kernel mode {mode!r}; expected "
                     "off|on|auto|race")
