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
int8 layout is not yet. :class:`PageTable` is the host-side (numpy)
mapping and :class:`PrefixCache` the copy-on-write prefix index and
session retention over it, both ported nearly verbatim.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

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


# --------------------------------------------------------------------------
# Prefix index over resident pages
# --------------------------------------------------------------------------

#: hash-chain root: the parent digest of a prompt's first block
_ROOT = b"dl4j-prefix-root"


def _chain_hash(parent: bytes, block: np.ndarray) -> bytes:
    """Digest of one page-aligned token block chained on its
    predecessor's digest — radix-style, so a block's key encodes its
    entire prefix, and two prompts share an entry iff they share every
    token up to and including that block."""
    h = hashlib.blake2b(digest_size=16)
    h.update(parent)
    h.update(np.ascontiguousarray(block, dtype=np.int32).tobytes())
    return h.digest()


class _PrefixEntry:
    """One FULL page of tokens resident in the pool, keyed by its chained
    block hash. Holds one table ref on its page for as long as it lives
    in the index."""

    __slots__ = ("page", "tokens", "parent", "children", "last_used")

    def __init__(self, page: int, tokens: np.ndarray,
                 parent: Optional[bytes], last_used: int):
        self.page = int(page)
        self.tokens = np.array(tokens, dtype=np.int32)  # defensive copy
        self.parent = parent          # predecessor's digest (chain walk)
        self.children = 0             # resident entries chained on us
        self.last_used = last_used


class _SessionEntry:
    """A finished request's written context retained verbatim so that the
    session's next turn resumes append-only. Holds one table ref per page
    (the final partial page included — unlike the block index, which
    keeps only full pages)."""

    __slots__ = ("tokens", "pages", "last_used")

    def __init__(self, tokens: np.ndarray, pages: List[int],
                 last_used: int):
        self.tokens = np.array(tokens, dtype=np.int32)
        self.pages = [int(p) for p in pages]
        self.last_used = last_used


class PrefixCache:
    """Longest-prefix index + session retention over a :class:`PageTable`.

    Host-side bookkeeping only: entries key page-aligned token blocks by
    their chained hash and pin the backing pool page with one table ref
    (``incref``). Admission walks the chain over the incoming prompt's
    full blocks (:meth:`match`), maps whatever matched straight into the
    new slot's page table (``map_shared``) and prefills only the tail —
    the chunk body and the paged-decode kernel read whatever pages a
    slot's table row names, so sharing changes no device code. Sessions
    (:meth:`retain_session`) keep a finished request's ENTIRE written
    context, partial tail page included, so that a follow-up turn resumes
    append-only (the boundary page is copied on write when appended to).

    Under page pressure the scheduler calls :meth:`evict`: cached pages
    no slot maps are dropped LRU, leaves first (an inner chain entry
    never outlives its children — a dangling parent digest would match
    prompts whose earlier blocks are gone). Eviction runs BEFORE
    preemption — a cold cache goes before a live request.

    A digest match alone never shares a page: every hit re-checks token
    equality against the entry's stored block before the page is mapped.
    """

    def __init__(self, table: PageTable):
        self.table = table
        self.entries: Dict[bytes, _PrefixEntry] = {}
        self.sessions: Dict[str, _SessionEntry] = {}
        self._holds: Dict[int, int] = {}   # page -> cache hold count
        self._clock = 0                    # LRU tick, monotonic
        self.hits = 0                      # admissions with >0 shared pages
        self.hit_tokens = 0                # prefill tokens skipped
        self.cow_copies = 0                # device page copies performed
        self.evictions = 0                 # pages freed by evict()

    # ------------------------------------------------------------ refs
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _hold(self, page: int):
        self.table.incref(page)
        self._holds[page] = self._holds.get(page, 0) + 1

    def _unhold(self, page: int) -> int:
        n = self._holds[page] - 1
        if n:
            self._holds[page] = n
        else:
            del self._holds[page]
        return self.table.decref(page)

    def holds(self) -> Dict[int, int]:
        """Page -> hold count owed by this cache — feed straight into
        ``PageTable.check(external=...)``."""
        return dict(self._holds)

    # ----------------------------------------------------------- match
    def match(self, tokens: np.ndarray) -> List[int]:
        """Longest resident prefix of ``tokens``: walk the chain over its
        full page-aligned blocks, checking token equality at each hop,
        and return the matched pages in logical order. Bumps the LRU
        tick of every entry touched."""
        tokens = np.asarray(tokens, dtype=np.int32)
        plen = self.table.page_len
        pages: List[int] = []
        parent = _ROOT
        now = self._tick()
        for j in range(len(tokens) // plen):
            block = tokens[j * plen:(j + 1) * plen]
            h = _chain_hash(parent, block)
            e = self.entries.get(h)
            if e is None or not np.array_equal(e.tokens, block):
                break
            e.last_used = now
            pages.append(e.page)
            parent = h
        return pages

    def insert(self, tokens: np.ndarray, pages: List[int]) -> int:
        """Register ``tokens``' full page-aligned blocks, backed by the
        slot's ``pages`` (logical order), into the index. Idempotent:
        blocks already resident keep their FIRST page (the latecomer's
        copy stays slot-owned and frees on release); new blocks gain a
        cache hold on theirs. Returns the number of new entries."""
        tokens = np.asarray(tokens, dtype=np.int32)
        plen = self.table.page_len
        parent = _ROOT
        now = self._tick()
        added = 0
        prev: Optional[_PrefixEntry] = None
        for j in range(min(len(tokens) // plen, len(pages))):
            block = tokens[j * plen:(j + 1) * plen]
            h = _chain_hash(parent, block)
            e = self.entries.get(h)
            if e is None or not np.array_equal(e.tokens, block):
                if e is not None:       # true digest collision: keep old
                    break
                e = _PrefixEntry(pages[j], block,
                                 None if parent is _ROOT else parent, now)
                self._hold(e.page)
                self.entries[h] = e
                if prev is not None:
                    prev.children += 1
                added += 1
            else:
                e.last_used = now
            parent = h
            prev = e
        return added

    def note_hit(self, tokens_matched: int):
        """Account one admission that skipped ``tokens_matched`` prefill
        tokens through the index or a session."""
        self.hits += 1
        self.hit_tokens += int(tokens_matched)

    # -------------------------------------------------------- sessions
    def session_match(self, session_id: str,
                      tokens: np.ndarray) -> Optional[Tuple[int, List[int]]]:
        """If ``session_id``'s retained context is a prefix of ``tokens``,
        return ``(n_retained_tokens, pages)`` — the whole retained
        mapping, partial tail page included. None on an unknown session
        or a divergence (the caller falls back to the block index)."""
        s = self.sessions.get(session_id)
        if s is None:
            return None
        n = len(s.tokens)
        tokens = np.asarray(tokens, dtype=np.int32)
        if n > len(tokens) or not np.array_equal(s.tokens, tokens[:n]):
            return None
        s.last_used = self._tick()
        return n, list(s.pages)

    def retain_session(self, session_id: str, tokens: np.ndarray,
                       pages: List[int]):
        """Pin a finished request's written context under its session id
        (one hold per page). Replaces any previous retention for the id —
        each turn's retention supersedes the last."""
        self.drop_session(session_id)
        s = _SessionEntry(np.asarray(tokens, dtype=np.int32), pages,
                          self._tick())
        for p in s.pages:
            self._hold(p)
        self.sessions[session_id] = s

    def drop_session(self, session_id: str) -> bool:
        """Release a session's holds (end of the conversation, or
        supersession by the next turn)."""
        s = self.sessions.pop(session_id, None)
        if s is None:
            return False
        for p in reversed(s.pages):
            self._unhold(p)
        return True

    # -------------------------------------------------------- eviction
    def _slot_free(self, page: int) -> bool:
        """True when only this cache holds the page — no slot maps it, so
        dropping our hold(s) frees it."""
        return int(self.table.refcount[page]) == self._holds.get(page, 0)

    @property
    def cached_pages(self) -> int:
        """Pages resident ONLY because this cache holds them — the
        evictable headroom the scheduler taps before preempting."""
        return sum(1 for p in self._holds if self._slot_free(p))

    def _drop_entry(self, h: bytes) -> int:
        e = self.entries.pop(h)
        if e.parent is not None:
            parent = self.entries.get(e.parent)
            if parent is not None:
                parent.children -= 1
        return self._unhold(e.page)

    def evict(self, need: int, protect=frozenset()) -> int:
        """Free up to ``need`` pages by dropping cold cache state, LRU
        first: leaf index entries whose page no slot maps, and (by age
        among them) whole sessions whose every page is slot-free.
        ``protect`` pins pages the caller just matched but has not yet
        mapped. Returns the pages actually freed."""
        freed = 0
        while freed < need:
            # candidates: evictable index leaves (inner nodes wait for
            # their subtree) and whole sessions
            cand = []
            for h, e in self.entries.items():
                if (e.children == 0 and e.page not in protect
                        and self._slot_free(e.page)):
                    cand.append((e.last_used, 0, h))
            for sid, s in self.sessions.items():
                if s.pages and all(p not in protect and self._slot_free(p)
                                   for p in s.pages):
                    cand.append((s.last_used, 1, sid))
                elif not s.pages:
                    cand.append((s.last_used, 1, sid))
            if not cand:
                break
            cand.sort(key=lambda c: (c[0], c[1]))
            _, kind, key = cand[0]
            if kind == 0:
                freed += self._drop_entry(key)
            else:
                s = self.sessions.pop(key)
                for p in reversed(s.pages):
                    freed += self._unhold(p)
        self.evictions += freed
        return freed

    def release_page_holds(self, page: int) -> int:
        """Ownership transfer for copy-on-write starvation: drop EVERY
        index entry and session touching ``page`` so that the one slot
        still mapping it becomes its sole owner and writes in place — no
        copy, no free page needed. Entries chained below a dropped one go
        too (their prefix is gone). Returns the holds removed from
        ``page``."""
        before = self._holds.get(page, 0)
        if not before:
            return 0
        # the subtree rooted at every entry on this page: a child
        # entry's parent digest would dangle otherwise
        doomed = {h for h, e in self.entries.items() if e.page == page}
        while True:
            grew = {h for h, e in self.entries.items()
                    if e.parent in doomed and h not in doomed}
            if not grew:
                break
            doomed |= grew
        for h in doomed:
            self._drop_entry(h)
        for sid in [sid for sid, s in self.sessions.items()
                    if page in s.pages]:
            self.drop_session(sid)
        return before - self._holds.get(page, 0)

    # ------------------------------------------------------------ misc
    @property
    def n_entries(self) -> int:
        return len(self.entries)

    @property
    def n_sessions(self) -> int:
        return len(self.sessions)

    def forget(self):
        """Drop all bookkeeping WITHOUT touching table refcounts — the
        companion of ``PageTable.reset()``, which already zeroed them."""
        self.entries.clear()
        self.sessions.clear()
        self._holds.clear()

    def report(self) -> dict:
        return {"entries": self.n_entries, "sessions": self.n_sessions,
                "cached_pages": self.cached_pages,
                "prefix_hits": self.hits,
                "prefix_hit_tokens": self.hit_tokens,
                "cow_copies": self.cow_copies,
                "evictions": self.evictions}
