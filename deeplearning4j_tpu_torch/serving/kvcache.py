"""Per-layer KV cache for the serving plane — dense slots and block-paged
pages. Port of ``deeplearning4j_tpu/serving/kvcache.py``.

**Dense layout**: one pool of decode SLOTS, each preallocated to
``max_len`` rows, stacked over layers like the model's blocks::

    {"k":   (L, n_slots, max_len, H, Dh)   compute dtype,
     "v":   (L, n_slots, max_len, H, Dh)   compute dtype,
     "pos": (n_slots,)                     int32}

``pos[s]`` is the number of tokens resident in slot ``s`` — the index the
next token's k/v is written at.

**Paged layout**: a fixed set of fixed-size PAGES shared by every slot,
plus a per-slot page table::

    {"k":     (L, n_pages, page_len, H, Dh)  compute dtype,
     "v":     (L, n_pages, page_len, H, Dh)  compute dtype,
     "pos":   (n_slots,)                      int32,
     "pages": (n_slots, pages_per_slot)       int32}

``pages[s, j]`` is the pool page holding slot ``s``'s tokens
``[j*page_len, (j+1)*page_len)``; unmapped entries hold the sentinel
``n_pages``. The engine masks writes that land on the sentinel (a JAX
scatter drops them) and clamps gathers through it (a JAX gather clamps),
so a freed lane can never corrupt a neighbour's page.

The engine updates these tensors in place — the port's counterpart of
the reference's buffer donation. Only bf16/f32 pools are ported; the
int8 layout and the ``PrefixCache`` are not yet. :class:`PageTable` is the
host-side (numpy) mapping, ported nearly verbatim.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .._device import resolve_device

DEFAULT_PAGE_LEN = 16
DEFAULT_PREFILL_CHUNK = 128


def _pool_dtype(cfg, dtype):
    dt = cfg.dtype if dtype is None else dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"KV pool dtype {dt}: only bfloat16 and "
                                  "float32 pools are ported")
    return dt


def init_cache(cfg, n_slots: int, max_len=None, dtype=None, device=None):
    """Allocate an empty dense cache for ``n_slots`` sequences.
    ``max_len`` defaults to ``cfg.max_seq`` and may not exceed it.
    ``device=None`` means the CUDA card (raises without one)."""
    max_len = int(cfg.max_seq if max_len is None else max_len)
    if max_len > cfg.max_seq:
        raise ValueError(
            f"max_len {max_len} exceeds cfg.max_seq={cfg.max_seq}: the "
            "position-embedding table has no rows past max_seq")
    if max_len < 1 or n_slots < 1:
        raise ValueError(f"need max_len >= 1 and n_slots >= 1, got "
                         f"max_len={max_len}, n_slots={n_slots}")
    dt = _pool_dtype(cfg, dtype)
    device = resolve_device(device)
    shape = (cfg.n_layers, int(n_slots), max_len, cfg.n_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "pos": torch.zeros((int(n_slots),), dtype=torch.int32,
                               device=device)}


def is_paged(cache) -> bool:
    return "pages" in cache


def cache_len(cache) -> int:
    """Static per-slot capacity (tokens); for a paged cache the
    page-table ceiling ``pages_per_slot * page_len``."""
    if is_paged(cache):
        return cache["pages"].shape[1] * cache["k"].shape[2]
    return cache["k"].shape[2]


def cache_slots(cache) -> int:
    return cache["pos"].shape[0]


def page_len(cache) -> int:
    return cache["k"].shape[2]


def n_pages(cache) -> int:
    return cache["k"].shape[1]


def pages_per_slot(cache) -> int:
    return cache["pages"].shape[1]


def cache_nbytes(cache) -> int:
    """Total device bytes held by the cache (a paged cache: the pool)."""
    return int(sum(a.numel() * a.element_size() for a in cache.values()))


def token_nbytes(cache) -> int:
    """Bytes ONE resident token occupies: k + v rows across layers."""
    layers, _, _, heads, head_dim = cache["k"].shape
    return int(2 * layers * heads * head_dim * cache["k"].element_size())


def page_nbytes(cache) -> int:
    return page_len(cache) * token_nbytes(cache)


def init_paged_cache(cfg, n_slots: int, n_pages: int,
                     page_len: int = DEFAULT_PAGE_LEN, max_len=None,
                     dtype=None, device=None):
    """Allocate an empty block-paged pool: ``n_pages`` pages of
    ``page_len`` tokens, per-slot cursors, and a per-slot page table of
    ``ceil(max_len / page_len)`` entries, all the sentinel ``n_pages``.
    ``device=None`` means the CUDA card (raises without one)."""
    max_len = int(cfg.max_seq if max_len is None else max_len)
    if max_len > cfg.max_seq:
        raise ValueError(
            f"max_len {max_len} exceeds cfg.max_seq={cfg.max_seq}: the "
            "position-embedding table has no rows past max_seq")
    if page_len < 1 or n_pages < 1 or n_slots < 1 or max_len < 1:
        raise ValueError(
            f"need page_len/n_pages/n_slots/max_len >= 1, got "
            f"page_len={page_len}, n_pages={n_pages}, n_slots={n_slots}, "
            f"max_len={max_len}")
    per_slot = -(-max_len // int(page_len))
    dt = _pool_dtype(cfg, dtype)
    device = resolve_device(device)
    shape = (cfg.n_layers, int(n_pages), int(page_len), cfg.n_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "pos": torch.zeros((int(n_slots),), dtype=torch.int32,
                               device=device),
            "pages": torch.full((int(n_slots), per_slot), int(n_pages),
                                dtype=torch.int32, device=device)}


class PageTable:
    """Host side of the paged mapping: the free list, per-page refcounts,
    and the numpy mirror of the device ``pages`` table. The scheduler
    maps pages before a dispatch needs them and releases them when a
    request finishes or is preempted; :meth:`sync` copies the mirror into
    the device table only when it changed.

    Pages are ref-counted: a page is FREE xor held, slot mappings never
    exceed a page's refcount, and slot maps plus external holds equal the
    refcount exactly (``check()`` asserts it).

    ``pinned=True`` (what :meth:`for_cache` passes for a CUDA cache) keeps
    the mirror in pinned host memory: :meth:`sync` then copies it into
    the device table without blocking, and every change of the mirror
    first waits for the last such copy to have read it."""

    def __init__(self, n_slots: int, n_pages: int, page_len: int,
                 pages_per_slot: int, pinned: bool = False):
        self.n_slots = int(n_slots)
        self.n_pages = int(n_pages)
        self.page_len = int(page_len)
        self.pages_per_slot = int(pages_per_slot)
        # pop() from the end → pages hand out in increasing id order
        self._free: List[int] = list(range(self.n_pages - 1, -1, -1))
        self._host = torch.full((self.n_slots, self.pages_per_slot),
                                self.n_pages, dtype=torch.int32,
                                pin_memory=pinned)
        self._copied = None      # CUDA event after the last sync's copy
        self.table = self._host.numpy()
        self.mapped = np.zeros((self.n_slots,), np.int32)
        self.refcount = np.zeros((self.n_pages,), np.int32)
        self.fill = np.zeros((self.n_pages,), np.int32)
        self._dirty = True

    @classmethod
    def for_cache(cls, cache) -> "PageTable":
        return cls(cache_slots(cache), n_pages(cache), page_len(cache),
                   pages_per_slot(cache), pinned=cache["pages"].is_cuda)

    def _before_write(self):
        """Wait until the last sync's copy has read the mirror."""
        if self._copied is not None:
            self._copied.synchronize()
            self._copied = None

    # ------------------------------------------------------- geometry
    def pages_for(self, tokens: int) -> int:
        """Pages required to hold ``tokens`` rows."""
        return -(-max(0, int(tokens)) // self.page_len)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def mapped_pages(self) -> int:
        """Per-slot mapping count summed (a shared page counts once per
        slot mapping it)."""
        return int(self.mapped.sum())

    @property
    def used_pages(self) -> int:
        """Pool pages with at least one holder, each counted once."""
        return self.n_pages - len(self._free)

    @property
    def shared_pages(self) -> int:
        return int((self.refcount > 1).sum())

    @property
    def resident_tokens(self) -> int:
        return int(self.fill.sum())

    def slot_tokens_capacity(self, slot: int) -> int:
        return int(self.mapped[slot]) * self.page_len

    def slot_pages(self, slot: int) -> List[int]:
        """The pool pages ``slot`` maps, in logical order."""
        return [int(p) for p in self.table[slot, :int(self.mapped[slot])]]

    # -------------------------------------------------------- mapping
    def can_map(self, slot: int, tokens: int) -> bool:
        need = self.pages_for(tokens) - int(self.mapped[slot])
        return need <= len(self._free)

    def _alloc(self) -> int:
        p = self._free.pop()
        self.refcount[p] = 1
        self.fill[p] = 0
        return p

    def map(self, slot: int, tokens: int) -> bool:
        """Grow ``slot``'s mapping to cover ``tokens`` rows with fresh
        pages. All-or-nothing: False (mapping untouched) when the free
        list cannot cover the growth."""
        want = self.pages_for(tokens)
        if want > self.pages_per_slot:
            raise ValueError(
                f"slot {slot} wants {want} pages ({tokens} tokens), page "
                f"table holds {self.pages_per_slot}")
        have = int(self.mapped[slot])
        need = want - have
        if need <= 0:
            return True
        if need > len(self._free):
            return False
        self._before_write()
        for j in range(have, want):
            self.table[slot, j] = self._alloc()
        self.mapped[slot] = want
        self._dirty = True
        return True

    def map_shared(self, slot: int, pages) -> None:
        """Map already-resident ``pages`` as ``slot``'s logical pages
        ``0..len-1``, each gaining one ref (the slot must map nothing)."""
        if int(self.mapped[slot]):
            raise ValueError(f"slot {slot} already maps "
                             f"{int(self.mapped[slot])} pages")
        pages = [int(p) for p in pages]
        if len(pages) > self.pages_per_slot:
            raise ValueError(f"{len(pages)} shared pages exceed the "
                             f"{self.pages_per_slot}-entry page table")
        for p in pages:
            if not (0 <= p < self.n_pages) or self.refcount[p] < 1:
                raise ValueError(f"page {p} is not resident")
        self._before_write()
        for j, p in enumerate(pages):
            self.table[slot, j] = p
            self.refcount[p] += 1
        if pages:
            self.mapped[slot] = len(pages)
            self._dirty = True

    def incref(self, page: int):
        if not (0 <= int(page) < self.n_pages) or self.refcount[page] < 1:
            raise ValueError(f"page {page} is not resident")
        self.refcount[page] += 1

    def decref(self, page: int) -> int:
        """Drop one ref; at zero the page returns to the free list.
        Returns 1 if the page freed, else 0."""
        r = int(self.refcount[page]) - 1
        if r < 0:
            raise ValueError(f"page {page} is already free")
        self.refcount[page] = r
        if r == 0:
            self.fill[page] = 0
            self._free.append(int(page))
            return 1
        return 0

    def cow(self, slot: int, j: int):
        """Copy-on-write split of ``slot``'s logical page ``j`` (which
        has other holders): remap it to a fresh page and return
        ``(src, dst)`` for the device copy, or None when no page is
        free."""
        if not (0 <= j < int(self.mapped[slot])):
            raise ValueError(f"slot {slot} logical page {j} is unmapped")
        old = int(self.table[slot, j])
        if int(self.refcount[old]) <= 1:
            raise ValueError(
                f"page {old} is exclusively owned — no split needed")
        if not self._free:
            return None
        self._before_write()
        new = self._alloc()
        self.fill[new] = int(self.fill[old])
        self.table[slot, j] = new
        self.refcount[old] -= 1
        self._dirty = True
        return old, new

    def note_fill(self, slot: int, tokens: int):
        """Record the tokens ``slot``'s mapping holds into the per-page
        fill census (shared pages counted once via the per-page max)."""
        t = max(0, int(tokens))
        for j in range(min(self.pages_for(t), int(self.mapped[slot]))):
            p = int(self.table[slot, j])
            f = min(self.page_len, t - j * self.page_len)
            if f > self.fill[p]:
                self.fill[p] = f

    def release(self, slot: int) -> int:
        """Drop ``slot``'s hold on every page it maps and reset its row
        to the sentinel. Returns the mappings removed."""
        have = int(self.mapped[slot])
        if have == 0:
            return 0
        self._before_write()
        for j in range(have - 1, -1, -1):     # LIFO: reuse hot pages
            self.decref(int(self.table[slot, j]))
        self.table[slot, :have] = self.n_pages
        self.mapped[slot] = 0
        self._dirty = True
        return have

    def trim(self, slot: int, tokens: int) -> int:
        """Shrink ``slot``'s mapping to cover exactly ``tokens`` rows.
        Returns mappings removed."""
        keep = self.pages_for(tokens)
        have = int(self.mapped[slot])
        if keep >= have:
            return 0
        self._before_write()
        for j in range(have - 1, keep - 1, -1):
            self.decref(int(self.table[slot, j]))
        self.table[slot, keep:have] = self.n_pages
        self.mapped[slot] = keep
        self._dirty = True
        return have - keep

    def reset(self):
        """Release everything."""
        self._before_write()
        self._free = list(range(self.n_pages - 1, -1, -1))
        self.table[:] = self.n_pages
        self.mapped[:] = 0
        self.refcount[:] = 0
        self.fill[:] = 0
        self._dirty = True

    # --------------------------------------------------------- device
    def sync(self, cache):
        """Copy the host mirror into the cache's device ``pages`` table,
        in place, iff the mapping changed since the last sync. The table
        keeps its address (the captured decode and chunk steps read it);
        from a pinned mirror the copy does not block the host."""
        if self._dirty:
            dst = cache["pages"]
            if dst.is_cuda and self._host.is_pinned():
                dst.copy_(self._host, non_blocking=True)
                self._copied = torch.cuda.Event()
                self._copied.record(torch.cuda.current_stream(dst.device))
            else:
                dst.copy_(self._host)
            self._dirty = False
        return cache

    # ------------------------------------------------------ invariant
    def check(self, external=None):
        """Assert the free-XOR-refcounted invariant (AssertionError with
        a diagnosis on violation). ``external`` maps page → holds owed by
        layers above the table."""
        ext = dict(external or {})
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate page in free list"
        for p in free:
            assert self.refcount[p] == 0, \
                f"page {p} free with refcount {int(self.refcount[p])}"
            assert self.fill[p] == 0, \
                f"page {p} free with fill {int(self.fill[p])}"
        slot_refs = np.zeros((self.n_pages,), np.int64)
        for s in range(self.n_slots):
            m = int(self.mapped[s])
            for j in range(self.pages_per_slot):
                p = int(self.table[s, j])
                if j < m:
                    assert 0 <= p < self.n_pages, \
                        f"slot {s} entry {j} unmapped below mapped count"
                    assert p not in free, \
                        f"page {p} mapped by slot {s} AND free"
                    slot_refs[p] += 1
                else:
                    assert p == self.n_pages, \
                        f"slot {s} entry {j} holds {p} past mapped count"
        for p in range(self.n_pages):
            assert int(slot_refs[p]) <= int(self.refcount[p]), (
                f"page {p} double-mapped: {int(slot_refs[p])} slot maps "
                f"exceed refcount {int(self.refcount[p])}")
            want = int(slot_refs[p]) + int(ext.get(p, 0))
            assert int(self.refcount[p]) == want, (
                f"page {p} refcount {int(self.refcount[p])} != "
                f"{int(slot_refs[p])} slot maps + {int(ext.get(p, 0))} "
                f"external holds")
        held = int((self.refcount > 0).sum())
        assert held + len(free) == self.n_pages, \
            f"lost pages: {self.n_pages - held - len(free)}"
        return True

    def report(self) -> dict:
        return {"n_pages": self.n_pages, "page_len": self.page_len,
                "pages_per_slot": self.pages_per_slot,
                "mapped_pages": self.mapped_pages,
                "used_pages": self.used_pages,
                "shared_pages": self.shared_pages,
                "free_pages": self.free_pages}
