"""Copy-on-write prefix sharing of the port (``deeplearning4j_tpu_torch.
serving``: ``PrefixCache``, ``ContinuousBatchingScheduler(prefix_cache=
True)``, sessions) against the JAX package's, on the CPU.

The tests of ``tests/test_prefix_cache.py`` ported to the port, on the same
tiny f32 model (vocab 61, d_model 32, 2 heads, 2 layers, max_seq 32,
``prefill_chunk=8``), weights drawn by the JAX package and shared through
``params_from_numpy``. Where a schedule is greedy, the JAX scheduler runs
the same submits step for step beside the port's (:class:`Pair`): after
every step both hold the same page table, refcounts and fill census, and
at the end the same greedy tokens and ``kv_report()["prefix"]`` counters
(hits, hit tokens, copy-on-write copies, evictions). Greedy tokens also
equal the port's own cold ``engine.generate``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving import (
    ContinuousBatchingScheduler as JSched, GenerationEngine as JEngine)
from deeplearning4j_tpu.serving.kvcache import PageTable as JPageTable
from deeplearning4j_tpu.serving.kvcache import PrefixCache as JPrefixCache
from deeplearning4j_tpu.zoo import transformer as jtfm
from deeplearning4j_tpu_torch.serving import (
    ContinuousBatchingScheduler, GenerationEngine, PageTable, PrefixCache,
    kvcache)
from deeplearning4j_tpu_torch.zoo import transformer as ttfm

torch.set_num_threads(2)

VOCAB = 61
TINY = dict(vocab_size=VOCAB, d_model=32, n_heads=2, n_layers=2, d_ff=64,
            max_seq=32, remat=False, attn_scores_bf16=False)


@pytest.fixture(scope="module")
def model():
    jcfg = jtfm.TransformerConfig(dtype=jnp.float32, **TINY)
    tcfg = ttfm.TransformerConfig(dtype=torch.float32, **TINY)
    jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = ttfm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def engine(model):
    _, _, tcfg, tp = model
    return GenerationEngine(tcfg, tp, device="cpu", prefill_chunk=8)


@pytest.fixture(scope="module")
def jengine(model):
    jcfg, jp, _, _ = model
    return JEngine(jcfg, jp, prefill_chunk=8)


def _toks(shape, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, shape).astype(
        np.int32)


def _sched(engine, n_slots=2, page_len=4, n_pages=16, **kw):
    return ContinuousBatchingScheduler(engine, n_slots=n_slots,
                                       page_len=page_len, n_pages=n_pages,
                                       prefix_cache=True, **kw)


def _census(pt):
    return (pt.used_pages, pt.mapped_pages, pt.shared_pages,
            pt.free_pages, pt.table.tolist(), pt.refcount.tolist(),
            pt.fill.tolist())


class Pair:
    """The port's prefix-sharing scheduler and the JAX package's, driven
    through the same submits and steps. Every step compares the page
    census; ``submit`` returns both futures."""

    def __init__(self, engine, jengine, **kw):
        self.ours = _sched(engine, **kw)
        self.ref = JSched(jengine, prefix_cache=True,
                          **{"n_slots": 2, "page_len": 4, "n_pages": 16,
                             **kw})
        self.steps = 0

    def submit(self, *a, **k):
        return self.ours.submit(*a, **k), self.ref.submit(*a, **k)

    def step(self):
        did = self.ours.step()
        assert self.ref.step() == did
        self.steps += 1
        assert _census(self.ours._pages) == _census(self.ref._pages), \
            f"page census parted at step {self.steps}"
        assert self.ours.check_pages() and self.ref.check_pages()
        return did

    def run_until_idle(self, limit=2000):
        for _ in range(limit):
            if not self.step():
                return
        raise AssertionError("the pair did not drain")

    def prefix(self):
        ours = self.ours.kv_report()["prefix"]
        assert ours == self.ref.kv_report()["prefix"]
        return ours


def _same_tokens(engine, prompt, n, pair_futs):
    ours, ref = (f.result(5).tokens.tolist() for f in pair_futs)
    assert ours == np.asarray(ref).tolist()
    assert ours == engine.generate(prompt, n).tolist()


# --------------------------------------------- PageTable refcount unit

def test_page_table_refcount_and_map_shared():
    pt = PageTable(n_slots=3, n_pages=8, page_len=4, pages_per_slot=4)
    assert pt.map(0, 10)                        # 3 fresh pages, 1 ref each
    assert pt.used_pages == 3 and pt.shared_pages == 0
    pages = [int(pt.table[0, j]) for j in range(3)]
    pt.map_shared(1, pages[:2])                 # slot 1 shares 2 of them
    assert pt.shared_pages == 2
    assert pt.mapped_pages == 5                 # per-slot view double counts
    assert pt.used_pages == 3                   # residency view does not
    pt.check()
    assert pt.release(1) == 2
    assert pt.used_pages == 3 and pt.free_pages == 5
    pt.check()
    pt.map_shared(1, pages[:1])
    with pytest.raises(ValueError, match="already maps"):
        pt.map_shared(1, pages[:1])
    pt.release(1)
    pt.release(0)
    with pytest.raises(ValueError, match="not resident"):
        pt.map_shared(2, pages[:1])
    assert pt.free_pages == 8


def test_page_table_cow_and_fill_census():
    pt = PageTable(n_slots=2, n_pages=6, page_len=4, pages_per_slot=3)
    pt.map(0, 8)
    pt.note_fill(0, 8)
    pages = [int(pt.table[0, j]) for j in range(2)]
    pt.map_shared(1, pages)
    assert pt.resident_tokens == 8              # shared counted once
    assert pt.map(0, 12)
    with pytest.raises(ValueError, match="exclusively owned"):
        pt.cow(0, 2)
    src, dst = pt.cow(1, 1)
    assert src == pages[1] and dst not in pages
    assert int(pt.fill[dst]) == int(pt.fill[src])   # census rides along
    assert int(pt.refcount[src]) == 1
    pt.check()
    while pt._free:                             # exhaust the free list
        pt._free.pop()
    assert pt.cow(1, 0) is None                 # None instead of raising


def test_check_external_catches_leaked_hold():
    pt = PageTable(n_slots=1, n_pages=4, page_len=4, pages_per_slot=2)
    pc = PrefixCache(pt)
    pt.map(0, 4)
    page = int(pt.table[0, 0])
    pc._hold(page)
    pt.check(pc.holds())                        # balanced: passes
    with pytest.raises(AssertionError, match="external holds"):
        pt.check()                              # census withheld: leak
    pt.incref(page)                             # phantom ref, no holder
    with pytest.raises(AssertionError, match="external holds"):
        pt.check(pc.holds())


def test_prefix_cache_index_match_insert_evict():
    """The index against the JAX package's on the same pages: the same
    matches, entry counts, evictions and refcounts at every step."""
    caches = []
    for table_cls, cache_cls in ((PageTable, PrefixCache),
                                 (JPageTable, JPrefixCache)):
        pt = table_cls(n_slots=2, n_pages=8, page_len=4, pages_per_slot=4)
        caches.append((pt, cache_cls(pt)))
    toks = _toks((12,), seed=5)
    probe = toks.copy()
    probe[5] = (probe[5] + 1) % VOCAB
    seen = []
    for pt, pc in caches:
        pt.map(0, 12)
        pages = [int(pt.table[0, j]) for j in range(3)]
        got = [pc.insert(toks, pages), pc.insert(toks, pages)]
        assert got == [3, 0]                    # idempotent
        # the longest-prefix walk stops at the first differing block
        assert pc.match(probe) == pages[:1]
        assert pc.match(toks) == pages
        pt.release(0)
        pt.check(pc.holds())
        got.append(pc.cached_pages)
        # LRU eviction drops leaves first and frees what it reclaims
        got.append(pc.evict(1))
        got.append(pc.n_entries)
        got.append(pc.evict(100))
        pt.check(pc.holds())
        got += [pc.n_entries, pt.free_pages, pc.report()]
        seen.append(got)
    assert seen[0] == seen[1]
    assert seen[0][:7] == [3, 0, 3, 1, 2, 2, 0]


# ------------------------------------------ tokens and census vs the JAX

def test_prefix_hit_and_miss_bit_identical(engine, jengine):
    """Hit (identical full-block prefix), miss (disjoint prompt), and a
    divergence inside a page all give cold prefill's tokens, and the
    JAX scheduler's tokens, census and counters."""
    pair = Pair(engine, jengine, n_slots=2, page_len=4, n_pages=24)
    prefix = _toks((12,), seed=1)               # 3 full pages
    first = np.concatenate([prefix, _toks((3,), seed=2)])
    f0 = pair.submit(first, max_new_tokens=5)
    pair.run_until_idle()
    _same_tokens(engine, first, 5, f0)
    assert pair.prefix()["entries"] > 0
    cases = [
        np.concatenate([prefix, _toks((6,), seed=3)]),       # hit: 3 pages
        _toks((9,), seed=4),                                 # miss
        np.concatenate([prefix[:10], _toks((5,), seed=5)]),  # partial page
    ]
    futs = [pair.submit(p, max_new_tokens=5) for p in cases]
    pair.run_until_idle()
    for p, f in zip(cases, futs):
        _same_tokens(engine, p, 5, f)
    rep = pair.prefix()
    assert rep["prefix_hits"] >= 2
    assert rep["prefix_hit_tokens"] >= 12 + 8


def test_divergent_page_cow_isolation(engine, jengine):
    """Two live requests share prefix pages; the one that diverges and
    keeps writing never corrupts what the other still reads."""
    pair = Pair(engine, jengine, n_slots=3, page_len=4, n_pages=24)
    prefix = _toks((8,), seed=11)
    seed_req = np.concatenate([prefix, _toks((2,), seed=12)])
    f_seed = pair.submit(seed_req, max_new_tokens=3)
    pair.run_until_idle()
    a = np.concatenate([prefix, _toks((1,), seed=13)])
    b = np.concatenate([prefix, _toks((1,), seed=14)])
    fa = pair.submit(a, max_new_tokens=10)
    fb = pair.submit(b, max_new_tokens=10)
    pair.run_until_idle()
    _same_tokens(engine, seed_req, 3, f_seed)
    _same_tokens(engine, a, 10, fa)
    _same_tokens(engine, b, 10, fb)
    assert pair.prefix()["prefix_hits"] >= 2


def test_session_multi_turn_append_only_equivalence(engine, jengine):
    """Each turn's prompt extends the retained context, maps it whole
    (the partial tail page copied on write) and gives the tokens of a
    cold prefill of the whole conversation."""
    pair = Pair(engine, jengine, n_slots=2, page_len=4, n_pages=24)
    convo = _toks((5,), seed=21)
    # 5 prompt + 5 generated: the written context of 9 tokens ends inside
    # a page, so turn 2's append must split the retained tail
    f1 = pair.submit(convo, max_new_tokens=5, session_id="s")
    pair.run_until_idle()
    _same_tokens(engine, convo, 5, f1)
    r1 = f1[0].result(5)
    assert pair.prefix()["sessions"] == 1
    turn2 = np.concatenate([convo, r1.tokens, _toks((3,), seed=22)])
    f2 = pair.submit(turn2, max_new_tokens=4, session_id="s")
    pair.run_until_idle()
    _same_tokens(engine, turn2, 4, f2)
    rep = pair.prefix()
    assert rep["prefix_hit_tokens"] >= convo.size + r1.tokens.size - 1
    assert rep["cow_copies"] >= 1
    turn3 = np.concatenate([turn2, f2[0].result(5).tokens,
                            _toks((2,), seed=23)])
    f3 = pair.submit(turn3, max_new_tokens=3, session_id="s")
    pair.run_until_idle()
    _same_tokens(engine, turn3, 3, f3)
    pair.prefix()
    sched = pair.ours
    assert sched.drop_session("s") is True
    assert sched.drop_session("s") is False
    sched._prefix.evict(10 ** 6)
    sched.check_pages()
    assert sched._pages.free_pages == sched._pages.n_pages


def test_identical_resubmit_same_session_cows_last_page(engine, jengine):
    """Resubmitting the retained context verbatim still prefills one
    token (the first-token logits) into a copy of the shared page."""
    pair = Pair(engine, jengine, n_slots=1, page_len=4, n_pages=16)
    p = _toks((6,), seed=31)
    f1 = pair.submit(p, max_new_tokens=3, session_id="rs")
    pair.run_until_idle()
    retained = np.concatenate([p, f1[0].result(5).tokens])[:-1]
    f2 = pair.submit(retained, max_new_tokens=3, session_id="rs")
    pair.run_until_idle()
    _same_tokens(engine, retained, 3, f2)
    assert pair.prefix()["cow_copies"] >= 1


# ------------------------------------------------- pressure + eviction

def test_lru_eviction_under_page_pressure(engine, jengine):
    """Cached pages no slot maps are reclaimed LRU under page pressure
    BEFORE any live request is preempted."""
    pair = Pair(engine, jengine, n_slots=2, page_len=4, n_pages=10)
    for s in (41, 42):
        p = _toks((9,), seed=s)
        f = pair.submit(p, max_new_tokens=2)
        pair.run_until_idle()
        _same_tokens(engine, p, 2, f)
    assert pair.ours._prefix.cached_pages >= 4
    # 24 prompt + 4 generated = 7 pages against 6 free
    big = _toks((24,), seed=43)
    f = pair.submit(big, max_new_tokens=4)
    pair.run_until_idle()
    _same_tokens(engine, big, 4, f)
    assert pair.prefix()["evictions"] >= 1
    assert pair.ours.stats["preemptions"] == 0   # the cold cache paid


def test_shared_pages_counted_once_in_accounting(engine, jengine):
    """With several slots sharing one prefix, allocated bytes follow the
    UNIQUE pages while the per-slot mapping view double counts."""
    pair = Pair(engine, jengine, n_slots=3, page_len=4, n_pages=24)
    prefix = _toks((12,), seed=51)
    f0 = pair.submit(np.concatenate([prefix, _toks((2,), seed=52)]),
                     max_new_tokens=2)
    pair.run_until_idle()
    f0[0].result(5)
    tails = [np.concatenate([prefix, _toks((2,), seed=53 + i)])
             for i in range(3)]
    futs = [pair.submit(t, max_new_tokens=8) for t in tails]
    for _ in range(4):
        pair.step()
    sched = pair.ours
    with sched._lock:
        shared = sched._pages.shared_pages
        used = sched._pages.used_pages
        mapped = sched._pages.mapped_pages
    assert shared >= 1            # all three admitted and still active
    assert mapped > used          # the per-slot view double counts
    rep, jrep = sched.kv_report(), pair.ref.kv_report()
    assert rep["allocated_bytes"] == used * kvcache.page_nbytes(sched.cache)
    assert rep["allocated_bytes"] == jrep["allocated_bytes"]
    assert rep["resident_bytes_last"] == jrep["resident_bytes_last"]
    pair.run_until_idle()
    for t, f in zip(tails, futs):
        _same_tokens(engine, t, 8, f)
    rep, jrep = sched.kv_report(), pair.ref.kv_report()
    for key in ("allocated_bytes", "resident_bytes_last", "snapshots",
                "peak_concurrent", "finished_requests", "paged",
                "prefix", "kv_dtype"):
        assert rep[key] == jrep[key], key
    for key in ("waste_ratio_mean", "final_residency_mean"):
        assert rep[key] == pytest.approx(jrep[key], abs=1e-6), key
    assert rep["waste_ratio_mean"] >= 0.0
    assert rep["paged"]["used_pages"] <= rep["paged"]["n_pages"]


# ------------------------------------------------------------- fuzzing

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzz_refcount_invariant_random_schedules(engine, jengine, seed):
    """Random prompts (seeded to collide on prefixes), sessions, cancels
    and starvation preemption through admit/chunk/decode/finish, the same
    schedule on both schedulers: the invariant holds and the census
    agrees at every step, the tokens are cold prefill's, and after a full
    cache drain the pool is whole."""
    rng = np.random.default_rng(seed)
    n_pages = int(rng.integers(12, 24))
    pair = Pair(engine, jengine, n_slots=int(rng.integers(1, 4)),
                page_len=int(rng.choice([2, 4])), n_pages=n_pages,
                starvation_ms=0.0 if seed % 2 else None)
    sched = pair.ours
    bases = [_toks((int(rng.integers(4, 10)),), seed=100 + seed),
             _toks((int(rng.integers(4, 10)),), seed=200 + seed)]
    prompts, futs, budgets = [], [], []
    for i in range(int(rng.integers(4, 9))):
        base = bases[int(rng.integers(0, 2))]
        tail = _toks((int(rng.integers(1, 6)),),
                     seed=int(rng.integers(0, 1 << 16)))
        p = np.concatenate([base, tail])
        mnt = int(rng.integers(1, 5))
        if sched._pages.pages_for(p.size + mnt - 1) > n_pages:
            continue
        sid = f"s{i % 2}" if rng.random() < 0.3 else None
        fut = pair.submit(p, max_new_tokens=mnt, session_id=sid)
        if rng.random() < 0.15:
            for f in fut:
                f.cancel()
        else:
            prompts.append(p)
            budgets.append(mnt)
            futs.append(fut)
        if rng.random() < 0.5:
            pair.step()
    pair.run_until_idle()
    for p, mnt, f in zip(prompts, budgets, futs):
        _same_tokens(engine, p, mnt, f)
    pair.prefix()
    with sched._lock:
        for sid in list(sched._prefix.sessions):
            sched._prefix.drop_session(sid)
        sched._prefix.evict(10 ** 6)
    sched.check_pages()
    assert sched._pages.free_pages == n_pages
    assert sched._pages.mapped_pages == 0


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_crash_forgets_prefix_holds(engine, monkeypatch):
    """_fail_all with the prefix cache: the pool reset zeroes refcounts
    and the cache forgets its holds with it — a restarted loop starts
    from a whole free list and an empty index."""
    sched = _sched(engine, n_slots=1, page_len=4, n_pages=12)
    warm = sched.submit(_toks((6,), seed=61), max_new_tokens=2,
                        session_id="crash")
    sched.run_until_idle()
    warm.result(5)
    assert sched._prefix.n_sessions == 1 and sched._prefix.n_entries > 0
    fut = sched.submit(_toks((6,), seed=62), max_new_tokens=6)
    sched.step()

    def boom(cache, tokens):
        raise RuntimeError("injected prefix-cache crash")
    monkeypatch.setattr(sched.engine, "decode_step", boom)
    sched.start(poll_s=0.001)
    with pytest.raises(RuntimeError, match="injected prefix-cache"):
        fut.result(timeout=30)
    sched._thread.join(timeout=30)
    sched.check_pages()
    assert sched._pages.free_pages == 12
    assert sched._prefix.n_entries == 0
    assert sched._prefix.n_sessions == 0


# ---------------------------------------------------- retrace pinning

def test_zero_retraces_with_prefix_cache_enabled(model):
    """With sharing on — hits, session turns, copy-on-write splits —
    traffic after warm-up compiles nothing: ``copy_page`` is warmed at
    construction (a self-copy), so even a first split after mark_warm is
    no compile."""
    _, _, tcfg, tp = model
    eng = GenerationEngine(tcfg, tp, device="cpu", prefill_chunk=8)
    sched = _sched(eng, n_slots=2, page_len=4, n_pages=20)
    w1 = sched.submit(_toks((9,), seed=71), max_new_tokens=3,
                      session_id="warm")
    sched.run_until_idle()
    t2 = np.concatenate([_toks((9,), seed=71), w1.result(5).tokens,
                         _toks((2,), seed=72)])
    w2 = sched.submit(t2, max_new_tokens=3, session_id="warm")
    sched.run_until_idle()
    w2.result(5)
    eng.mark_warm()
    base = _toks((11,), seed=73)
    futs = [sched.submit(np.concatenate([base, _toks((k,), seed=74 + k)]),
                         max_new_tokens=4) for k in (1, 3, 5)]
    t3 = np.concatenate([t2, w2.result(5).tokens, _toks((2,), seed=79)])
    futs.append(sched.submit(t3, max_new_tokens=3, session_id="warm"))
    sched.run_until_idle()
    for f in futs:
        f.result(5)
    rep = eng.compile_report()
    retraces = {k: v["retraces_after_warm"] for k, v in rep.items()}
    assert all(v == 0 for v in retraces.values()), retraces
    assert rep["copy_page"]["compiles"] == 1
    assert sched._prefix.cow_copies >= 1
    sched.check_pages()


def test_prefix_cache_needs_the_paged_pool(engine):
    with pytest.raises(ValueError, match="paged pool"):
        ContinuousBatchingScheduler(engine, n_slots=1, prefix_cache=True)
    dense = ContinuousBatchingScheduler(engine, n_slots=1)
    with pytest.raises(ValueError, match="prefix_cache=True"):
        dense.submit(_toks((4,)), 2, session_id="s")
    assert dense.drop_session("s") is False
    assert "prefix" not in dense.kv_report()
