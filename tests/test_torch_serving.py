"""Parity of the port's serving plane (``deeplearning4j_tpu_torch.serving``)
with the JAX package: KV cache, engine, continuous-batching scheduler.

Tiny f32 model (vocab 61, d_model 32, H 2, L 2, d_ff 64, max_seq 64),
weights drawn by the JAX package and shared through
``params_from_numpy``. Logits agree at atol = rtol = 1e-5 (summation
order); greedy tokens must be identical. The port runs with
``device="cpu"``, where its kernels' plain versions run.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving import (
    ContinuousBatchingScheduler as JSched, GenerationEngine as JEngine)
from deeplearning4j_tpu.serving.kvcache import PageTable as JPageTable
from deeplearning4j_tpu.zoo import transformer as jtfm
from deeplearning4j_tpu_torch.kernels.paged_attention import decide
from deeplearning4j_tpu_torch.serving import (
    ContinuousBatchingScheduler, GenerationEngine, PageTable, kvcache,
    sample_tokens)
from deeplearning4j_tpu_torch.zoo import transformer as ttfm

torch.set_num_threads(2)

F32_TOL = dict(atol=1e-5, rtol=1e-5)
VOCAB = 61
TINY = dict(vocab_size=VOCAB, d_model=32, n_heads=2, n_layers=2, d_ff=64,
            max_seq=64, remat=False, attn_scores_bf16=False)


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
    return GenerationEngine(tcfg, tp, device="cpu")


@pytest.fixture(scope="module")
def jengine(model):
    jcfg, jp, _, _ = model
    return JEngine(jcfg, jp)


def _toks(shape, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, shape).astype(
        np.int32)


def _np(t):
    return t.detach().cpu().numpy()


# ----------------------------------------------------------- PageTable

def test_page_table_fuzz_lockstep_with_reference():
    """Random map / release / map_shared / cow / trim / note_fill /
    external holds driven through both PageTables in lock step: same
    tables, refcounts, free counts, and check() passes on both."""
    rng = np.random.default_rng(0)
    args = (4, 12, 4, 5)
    ours, ref = PageTable(*args), JPageTable(*args)
    ext = {}
    for step in range(400):
        op = rng.integers(0, 7)
        slot = int(rng.integers(0, 4))
        if op == 0:
            n = int(rng.integers(0, 24))
            try:
                want = ref.map(slot, n)
            except ValueError:
                with pytest.raises(ValueError):
                    ours.map(slot, n)
                continue
            assert ours.map(slot, n) == want
        elif op == 1:
            assert ours.release(slot) == ref.release(slot)
        elif op == 2:
            donor = int(rng.integers(0, 4))
            if ref.mapped[slot] == 0 and donor != slot:
                pages = ref.slot_pages(donor)
                ours.map_shared(slot, pages)
                ref.map_shared(slot, pages)
        elif op == 3:
            shared = [j for j in range(int(ref.mapped[slot]))
                      if ref.refcount[ref.table[slot, j]] > 1]
            if shared:
                assert ours.cow(slot, shared[0]) == ref.cow(slot, shared[0])
        elif op == 4:
            n = int(rng.integers(0, 20))
            assert ours.trim(slot, n) == ref.trim(slot, n)
        elif op == 5:
            n = int(rng.integers(0, 20))
            ours.note_fill(slot, n)
            ref.note_fill(slot, n)
        else:
            held = [p for p in range(12) if ref.refcount[p] > 0]
            if held and rng.random() < 0.5:
                p = held[int(rng.integers(0, len(held)))]
                ours.incref(p)
                ref.incref(p)
                ext[p] = ext.get(p, 0) + 1
            elif ext:
                p = sorted(ext)[0]
                assert ours.decref(p) == ref.decref(p)
                ext[p] -= 1
                if not ext[p]:
                    del ext[p]
        np.testing.assert_array_equal(ours.table, ref.table)
        np.testing.assert_array_equal(ours.mapped, ref.mapped)
        np.testing.assert_array_equal(ours.refcount, ref.refcount)
        np.testing.assert_array_equal(ours.fill, ref.fill)
        assert ours.free_pages == ref.free_pages
        assert ours.check(ext) and ref.check(ext)
    assert ours.report() == ref.report()


def test_page_table_sync_copies_in_place(model):
    _, _, tcfg, _ = model
    cache = kvcache.init_paged_cache(tcfg, 2, 6, 4, max_len=16,
                                     device="cpu")
    pages = cache["pages"]
    t = PageTable.for_cache(cache)
    t.map(1, 7)
    assert t.sync(cache) is cache and cache["pages"] is pages
    np.testing.assert_array_equal(_np(pages), t.table)
    assert kvcache.cache_len(cache) == 16
    assert kvcache.page_nbytes(cache) == 4 * kvcache.token_nbytes(cache) \
        == 4 * 2 * 2 * 2 * 16 * 4


# -------------------------------------------------------------- engine

def test_prefill_decode_equals_full_forward_every_position(model, engine):
    """The cache is an optimization, never a different model: prefill +
    per-token decode logits equal the full forward at every position,
    and equal the JAX package's forward."""
    jcfg, jp, tcfg, tp = model
    seq = _toks((2, 14), seed=1)
    full, _ = ttfm.forward(tp, tcfg, torch.as_tensor(seq).long())
    jfull, _ = jtfm.forward(jp, jcfg, jnp.asarray(seq))
    np.testing.assert_allclose(_np(full), np.asarray(jfull), **F32_TOL)
    cache = engine.init_cache(2)
    logits, cache = engine.prefill(cache, seq[:, :5])
    np.testing.assert_allclose(_np(logits), _np(full[:, 4]), **F32_TOL)
    for t in range(5, 14):
        logits, cache = engine.decode_step(cache, seq[:, t])
        np.testing.assert_allclose(_np(logits), _np(full[:, t]), **F32_TOL)
    np.testing.assert_array_equal(_np(cache["pos"]), [14, 14])


def test_paged_decode_and_chunked_prefill_equal_dense(model):
    """A paged pool (page_len 4) prefilled in chunks of 5, then decoded —
    through the gather path and through the kernel wrapper (its plain
    version on the CPU) — gives the dense path's logits."""
    _, _, tcfg, tp = model
    dense = GenerationEngine(tcfg, tp, device="cpu")
    seqs = [_toks((13,), seed=2), _toks((7,), seed=3)]
    ref = []
    for s in seqs:
        cache = dense.init_cache(1)
        lg, cache = dense.prefill_slot(cache, s[:9] if len(s) > 9 else s, 0)
        rows = [_np(lg)]
        for tok in s[9:]:
            lg, cache = dense.decode_step(cache, [tok])
            rows.append(_np(lg)[0])
        ref.append(rows)
    for mode in ("off", "on"):
        eng = GenerationEngine(tcfg, tp, device="cpu", prefill_chunk=5,
                               paged_kernel=mode)
        cache = eng.init_paged_cache(2, 12, 4)
        table = PageTable.for_cache(cache)
        got = [[], []]
        for slot, s in enumerate(seqs):
            n = min(9, len(s))
            table.map(slot, len(s))
            table.sync(cache)
            for c0 in range(0, n, 5):
                lg, cache = eng.prefill_chunk(cache, s[c0:min(n, c0 + 5)],
                                              slot, start=c0)
            got[slot].append(_np(lg))
        # decode slot 0's tail while slot 1 (done) rides along; its rows
        # stay mapped so its garbage writes land in its own pages
        for i, tok in enumerate(seqs[0][9:]):
            lg, cache = eng.decode_step(cache, [tok, 0])
            got[0].append(_np(lg)[0])
        for r, g in zip(ref[0] + ref[1], got[0] + got[1]):
            np.testing.assert_allclose(g, r, **F32_TOL, err_msg=mode)
        assert decide(eng, cache) == ("kernel" if mode == "on"
                                      else "gather")


def test_paged_sentinel_write_is_dropped_like_jax(model, engine, jengine):
    """A slot whose write position is unmapped (its table row is all
    sentinel) writes NOTHING — JAX drops that scatter — even when a live
    slot writes the clamped target (last page, same offset) in the same
    step. Pool contents match the JAX engine's after the step."""
    _, _, _, _ = model
    cache = engine.init_paged_cache(3, 4, 4)
    jcache = jengine.init_paged_cache(3, 4, 4, quantized=False)
    table = np.full((3, 16), 4, np.int32)
    table[0, 0] = 3                     # slot 0 lives on the LAST page
    pos = np.asarray([0, 0, 5], np.int32)
    cache["pages"].copy_(torch.as_tensor(table))
    cache["pos"].copy_(torch.as_tensor(pos))
    jcache = dict(jcache, pages=jnp.asarray(table), pos=jnp.asarray(pos))
    toks = np.asarray([7, 11, 13], np.int32)
    logits, cache = engine.decode_step(cache, toks)
    jlogits, jcache = jengine.decode_step(jcache, toks)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(cache[name]),
                                   np.asarray(jcache[name]), **F32_TOL)
    assert _np(cache["k"])[:, 3, 0].any()          # slot 0's row landed
    assert not _np(cache["k"])[:, :3].any()        # nothing else moved
    assert not _np(cache["k"])[:, 3, 1:].any()
    np.testing.assert_allclose(_np(logits)[0], np.asarray(jlogits)[0],
                               **F32_TOL)


def test_dense_past_capacity_write_is_dropped(model, engine, jengine):
    """A dense slot at capacity decodes without raising and without
    writing (the reference's out-of-bounds scatter drops); its neighbour
    is served normally."""
    eng = GenerationEngine(engine.cfg, engine.params, max_len=8,
                           device="cpu")
    jeng = JEngine(jengine.cfg, jengine.params, max_len=8)
    cache, jcache = eng.init_cache(2), jeng.init_cache(2)
    prompt = _toks((2, 8), seed=4)
    _, cache = eng.prefill(cache, prompt, lengths=[3, 8])
    _, jcache = jeng.prefill(jcache, prompt, lengths=np.asarray([3, 8]))
    before = _np(cache["k"]).copy()
    logits, cache = eng.decode_step(cache, [5, 6])
    jlogits, jcache = jeng.decode_step(jcache, np.asarray([5, 6]))
    after = _np(cache["k"])
    np.testing.assert_array_equal(after[:, 1], before[:, 1])
    np.testing.assert_allclose(after, np.asarray(jcache["k"]), **F32_TOL)
    np.testing.assert_allclose(_np(logits)[0], np.asarray(jlogits)[0],
                               **F32_TOL)
    np.testing.assert_array_equal(_np(cache["pos"]), [4, 9])


def test_dynamic_slices_are_bounds_checked(engine):
    """``lax.dynamic_update_slice`` clamps its start; the port refuses."""
    dense = engine.init_cache(2)
    paged = engine.init_paged_cache(2, 8, 8)
    with pytest.raises(ValueError, match="slot"):
        engine.prefill_slot(dense, _toks((4,)), 2)
    with pytest.raises(ValueError, match="capacity"):
        engine.prefill_slot(dense, _toks((65,)), 0)
    with pytest.raises(ValueError, match="past cache"):
        engine.prefill_chunk(paged, _toks((8,)), 0, start=60)
    with pytest.raises(ValueError, match="slot"):
        engine.prefill_chunk(paged, _toks((8,)), 5, start=0)
    with pytest.raises(ValueError, match="paged"):
        engine.prefill_chunk(dense, _toks((4,)), 0)
    with pytest.raises(ValueError, match="dense"):
        engine.prefill(paged, _toks((2, 4)))
    with pytest.raises(ValueError, match="outside"):
        engine.copy_page(paged, 0, 8)


def test_copy_page_duplicates_every_layer(engine):
    cache = engine.init_paged_cache(1, 4, 4)
    cache["k"][:, 1] = torch.randn(cache["k"][:, 1].shape)
    cache["v"][:, 1] = torch.randn(cache["v"][:, 1].shape)
    out = engine.copy_page(cache, 1, 3)
    assert out is cache
    torch.testing.assert_close(cache["k"][:, 3], cache["k"][:, 1])
    torch.testing.assert_close(cache["v"][:, 3], cache["v"][:, 1])


def test_generate_matches_jax_engine_greedy(model, engine, jengine):
    jcfg, jp, tcfg, tp = model
    prompts = _toks((3, 6), seed=5)
    ours = engine.generate(prompts, 12)
    ref = np.asarray(jengine.generate(prompts, 12))
    np.testing.assert_array_equal(ours, ref)
    one = ttfm.generate(tp, tcfg, prompts[0], 12, device="cpu")
    np.testing.assert_array_equal(one, ref[0])
    eos = int(ref[1, 3])
    np.testing.assert_array_equal(
        engine.generate(prompts, 12, eos_id=eos),
        np.asarray(jengine.generate(prompts, 12, eos_id=eos)))


# ----------------------------------------------------------- sampling

def test_sampling_greedy_topk_and_determinism():
    g = torch.Generator().manual_seed(0)
    logits = torch.randn((6, VOCAB), generator=g)
    logits[0, 3] = logits[0, 9] = logits[0].max() + 1.0     # a tie
    greedy = sample_tokens(logits, np.zeros(6), np.zeros(6))
    assert greedy[0].item() == 3                              # first index
    torch.testing.assert_close(greedy.long(), logits.argmax(-1))
    temps, topk = np.full(6, 1.5, np.float32), np.full(6, 3)
    top3 = torch.topk(logits, 3, dim=-1).indices
    draws = []
    for seed in range(3):
        gen = torch.Generator().manual_seed(seed)
        rows = [sample_tokens(logits, temps, topk, gen) for _ in range(40)]
        draws.append(torch.stack(rows))
        for r in rows:
            assert (top3 == r.long()[:, None]).any(-1).all()
    again = torch.Generator().manual_seed(0)
    rep = torch.stack([sample_tokens(logits, temps, topk, again)
                       for _ in range(40)])
    torch.testing.assert_close(rep, draws[0])
    assert not torch.equal(draws[0], draws[1])
    mixed = sample_tokens(logits, np.asarray([0, 1, 0, 1, 0, 1.0]),
                          np.asarray([0, 2, 0, 2, 0, 2]),
                          torch.Generator().manual_seed(1))
    assert mixed[0].item() == 3 and mixed[2] == logits[2].argmax()


# ---------------------------------------------------------- scheduler

def _serve(sched, reqs):
    futs = [sched.submit(p, max_new_tokens=n) for p, n in reqs]
    sched.run_until_idle()
    return [f.result(timeout=5) for f in futs]


REQS = [(_toks((5,), seed=10), 8), (_toks((12,), seed=11), 6),
        (_toks((3,), seed=12), 9), (_toks((20,), seed=13), 5),
        (_toks((9,), seed=14), 7)]


@pytest.fixture(scope="module")
def oracle(engine):
    return [engine.generate(p, n) for p, n in REQS]


@pytest.fixture(scope="module")
def reference_out(jengine):
    return [r.tokens for r in _serve(JSched(jengine, n_slots=2), REQS)]


@pytest.mark.parametrize("kw", [{}, {"page_len": 4},
                                {"page_len": 4, "n_pages": 8}],
                         ids=["dense", "paged", "paged_tight"])
def test_scheduler_greedy_matches_generate_and_reference(
        model, oracle, reference_out, kw):
    _, _, tcfg, tp = model
    eng = GenerationEngine(tcfg, tp, device="cpu", prefill_chunk=8)
    sched = ContinuousBatchingScheduler(eng, n_slots=2, **kw)
    got = _serve(sched, REQS)
    for r, want, ref in zip(got, oracle, reference_out):
        assert r.tokens.tolist() == want.tolist()
        assert r.tokens.tolist() == np.asarray(ref).tolist()
        assert r.finish_reason == "length" and r.ttft_s is not None
    assert sched.check_pages()
    if sched.paged:
        assert sched._pages.free_pages == sched._pages.n_pages
    if kw.get("n_pages") == 8:
        assert sched.stats["preemptions"] >= 1   # page pressure preempted


@pytest.mark.parametrize("paged", [False, True])
def test_scheduler_preemption_is_output_transparent(engine, paged):
    kw = {"page_len": 4} if paged else {}
    sched = ContinuousBatchingScheduler(engine, n_slots=1,
                                        starvation_ms=0.0, **kw)
    long_p, short_p = _toks((5,), seed=41), _toks((3,), seed=42)
    f_long = sched.submit(long_p, max_new_tokens=10)
    sched.step()
    sched.step()
    time.sleep(0.002)
    f_short = sched.submit(short_p, max_new_tokens=2)
    time.sleep(0.002)
    sched.run_until_idle()
    r_long, r_short = f_long.result(5), f_short.result(5)
    assert r_long.preemptions >= 1
    assert sched.stats["preemptions"] >= 1
    assert r_long.tokens.tolist() == engine.generate(long_p, 10).tolist()
    assert r_short.tokens.tolist() == engine.generate(short_p, 2).tolist()


@pytest.mark.parametrize("paged", [False, True])
def test_scheduler_eos_stops_at_first_eos(engine, jengine, paged):
    """The contract of the reference's test_scheduler_eos_stops_early
    docstring: pick the greedy continuation's own 2nd token as eos — the
    scheduler must stop THERE (its first occurrence, which may come
    earlier when the continuation repeats it) and label the reason.
    The reference scheduler stops at the same token."""
    prompt = _toks((1, 6), seed=31)[0]
    oracle = engine.generate(prompt, 6)
    eos = int(oracle[2])
    first = int(np.flatnonzero(oracle == eos)[0])
    kw = {"page_len": 4} if paged else {}
    sched = ContinuousBatchingScheduler(engine, n_slots=1, **kw)
    fut = sched.submit(prompt, max_new_tokens=6, eos_id=eos)
    sched.run_until_idle()
    res = fut.result(timeout=5)
    assert res.finish_reason == "eos"
    assert res.tokens.tolist() == oracle[:first + 1].tolist()
    jsched = JSched(jengine, n_slots=1)
    jfut = jsched.submit(prompt, max_new_tokens=6, eos_id=eos)
    jsched.run_until_idle()
    assert jfut.result(timeout=5).tokens.tolist() == res.tokens.tolist()


@pytest.mark.parametrize("paged", [False, True])
def test_scheduler_warmup_leaves_a_seeded_generator_alone(engine, paged):
    """Construction warms the masked sampler through the scheduler's own
    generator and puts its state back: a seeded scheduler's tempered
    requests draw what ``engine.sample`` draws on a generator seeded the
    same, from each request's prefill logits in turn."""
    gen = torch.Generator().manual_seed(5)
    before = gen.get_state().clone()
    kw = {"page_len": 4} if paged else {}
    sched = ContinuousBatchingScheduler(engine, n_slots=1, generator=gen,
                                        **kw)
    assert torch.equal(gen.get_state(), before)
    prompts = [_toks((7,), seed=60 + i) for i in range(6)]
    futs = [sched.submit(p, max_new_tokens=1, temperature=1.5)
            for p in prompts]
    sched.run_until_idle()
    ref = torch.Generator().manual_seed(5)
    for p, fut in zip(prompts, futs):
        logits, _ = engine.prefill_slot(engine.init_cache(1), p, 0)
        want = engine.sample(logits[None], 1.5, 0, ref)
        assert fut.result(timeout=0).tokens.tolist() == _np(want).tolist()


def test_scheduler_background_thread_and_drain(engine, oracle):
    sched = ContinuousBatchingScheduler(engine, n_slots=2).start()
    try:
        futs = [sched.submit(p, max_new_tokens=n) for p, n in REQS[:3]]
        got = [f.result(timeout=60).tokens.tolist() for f in futs]
    finally:
        sched.stop()
    assert got == [o.tolist() for o in oracle[:3]]
    sched2 = ContinuousBatchingScheduler(engine, n_slots=1)
    sched2.submit(*REQS[0])
    sched2.step()
    queued = sched2.submit(*REQS[1])
    left = sched2.drain()
    assert [r.future for r in left] == [queued]
    assert not any(sched2.slots)


def test_scheduler_rejects_what_could_never_run(engine):
    sched = ContinuousBatchingScheduler(engine, n_slots=1, page_len=4,
                                        n_pages=3)
    with pytest.raises(ValueError, match="max_len"):
        sched.submit(_toks((60,)), max_new_tokens=10)
    with pytest.raises(ValueError, match="pool holds"):
        sched.submit(_toks((14,)), max_new_tokens=2)
    with pytest.raises(ValueError, match="vocabulary"):
        sched.submit(np.asarray([VOCAB]), 2)
    with pytest.raises(ValueError, match="unknown keyword"):
        sched.submit(_toks((3,)), 2, bogus=1)


def test_unported_knobs_raise(model, engine):
    """``key`` (a JAX PRNG key) is the one scheduler knob still refused.
    The int8 knobs are ported: the engine's ``quant_kv``/
    ``quant_weights`` and the scheduler's ``quant_kv`` give an int8 pool
    and int8 decode weights (``tests/test_torch_quant.py``); a dense pool
    stays in the compute dtype."""
    _, _, tcfg, tp = model
    eng = GenerationEngine(tcfg, tp, device="cpu", quant_kv="on")
    assert kvcache.is_quantized(eng.init_paged_cache(1, 4, 4))
    eng = GenerationEngine(tcfg, tp, device="cpu", quant_weights="int8")
    assert eng._decode_params() == "int8"
    sched = ContinuousBatchingScheduler(engine, n_slots=1, page_len=4,
                                        quant_kv="int8")
    assert sched.kv_report()["kv_dtype"] == "int8"
    with pytest.raises(NotImplementedError, match="not ported"):
        ContinuousBatchingScheduler(engine, n_slots=1, page_len=4,
                                    key=object())
    with pytest.raises(TypeError):
        ContinuousBatchingScheduler(engine, n_slots=1, bogus=1)
    with pytest.raises(NotImplementedError, match="int8"):
        kvcache.init_cache(tcfg, 1, dtype=torch.int8, device="cpu")


def test_engine_raises_without_a_card(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, tcfg, tp = model
    with pytest.raises(RuntimeError, match="CUDA"):
        GenerationEngine(tcfg, tp)
    with pytest.raises(RuntimeError, match="CUDA"):
        GenerationEngine(tcfg, tp, device="cuda")
    # the cache allocators follow the same rule: no device → the card
    with pytest.raises(RuntimeError, match="CUDA"):
        kvcache.init_cache(tcfg, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        kvcache.init_paged_cache(tcfg, 1, 4, 4)
