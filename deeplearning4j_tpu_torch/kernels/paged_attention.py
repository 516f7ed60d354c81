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
→ kernel on CUDA and gather on the CPU. The reference's fidelity-gated
promotion race and its autotune store are not ported yet.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30

#: the reference's promotion fidelity budget: max per-position KL, nats
PROMOTION_MAX_KL = 1e-3

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


def decide(engine, cache, mode: Optional[str] = None) -> str:
    """``"kernel"`` or ``"gather"`` for one engine × cache. ``mode`` (or
    the engine's pinned mode, default ``auto``): ``off`` → gather, ``on``
    → kernel, ``auto`` → the kernel when the pool lies on a CUDA device,
    else gather. A CUDA pool the kernel cannot take (head dim past
    ``MAX_HEAD_DIM``, 11621) is refused by the kernel's wrapper, never
    handed to the gather path."""
    if mode is None:
        mode = getattr(engine, "paged_kernel_mode", None) or "auto"
    mode = str(mode).lower()
    if mode in ("off", "0", "gather"):
        return "gather"
    if mode in ("on", "1", "kernel"):
        return "kernel"
    if mode == "auto":
        return "kernel" if cache["k"].device.type == "cuda" else "gather"
    if mode == "race":
        raise NotImplementedError(
            "the fidelity-gated promotion race is not ported yet; use "
            "paged_kernel='on'|'off'|'auto'")
    raise ValueError(f"unknown paged-kernel mode {mode!r}; expected "
                     "off|on|auto")
