"""The compiled serving step of the port (``serving/engine.py`` entry points
run by ``nn/_compiled.py``'s ``CompiledStep`` inside ``obs/compiles.py``'s
``CompileSentinel``) against the JAX engine's jitted entry points, on the
CPU, where the step bodies run directly (the same bodies the card
captures).

Small f32 model (vocab 61, d_model 64, 4 heads, 2 layers, d_ff 128,
max_seq 64), weights drawn by the JAX package and shared through
``params_from_numpy``; tokens from a numpy seed. Logits agree at atol =
rtol = 1e-5 (summation order); the k/v rows the two engines write agree
at the same tolerance, and every row neither wrote, every cursor and every
page-table entry is equal. Greedy tokens must be identical.
"""

from __future__ import annotations

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.obs.compiles import CompileSentinel as JSentinel
from deeplearning4j_tpu.serving import (
    ContinuousBatchingScheduler as JSched, GenerationEngine as JEngine)
from deeplearning4j_tpu.zoo import transformer as jtfm
from deeplearning4j_tpu_torch.nn._compiled import (Bound, CompiledStep,
                                                   signature)
from deeplearning4j_tpu_torch.obs.compiles import CompileSentinel
from deeplearning4j_tpu_torch.serving import (
    ContinuousBatchingScheduler, GenerationEngine, PageTable)
from deeplearning4j_tpu_torch.zoo import transformer as ttfm

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
VOCAB = 61
SMALL = dict(vocab_size=VOCAB, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq=64, remat=False, attn_scores_bf16=False)
ENTRY_POINTS = {"decode_step", "decode_paged", "decode_paged_kernel",
                "prefill", "prefill_slot", "prefill_chunk", "sample_tokens",
                "copy_page"}


@pytest.fixture(scope="module")
def model():
    jcfg = jtfm.TransformerConfig(dtype=jnp.float32, **SMALL)
    tcfg = ttfm.TransformerConfig(dtype=torch.float32, **SMALL)
    jp = jtfm.init_params(jax.random.PRNGKey(3), jcfg)
    tp = ttfm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _toks(n, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, n).astype(np.int32)


def _np(t):
    return t.detach().cpu().numpy()


def _assert_cache(cache, jcache):
    """Cursors and tables equal; k/v rows at f32 tolerance, and rows the
    JAX engine left at zero are zero in the port's too."""
    for name in cache:
        got, want = _np(cache[name]), np.asarray(jcache[name])
        if name in ("pos", "pages"):
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, **TOL, err_msg=name)
            np.testing.assert_array_equal(got == 0, want == 0, err_msg=name)


def _paged_pair(eng, jeng, n_slots, n_pages, page_len, maps):
    """A paged cache on each engine with the same table: slot → tokens
    mapped (through the port's PageTable)."""
    cache = eng.init_paged_cache(n_slots, n_pages, page_len)
    jcache = jeng.init_paged_cache(n_slots, n_pages, page_len,
                                   quantized=False)
    table = PageTable.for_cache(cache)
    for slot, n in maps.items():
        table.map(slot, n)
    table.sync(cache)
    return cache, dict(jcache, pages=jnp.asarray(table.table)), table


# ------------------------------------------- step bodies vs the JAX engine

# (slot, start, length) chunks through ONE engine and ONE cache: several
# slots, starts that are and are not page aligned, every chunk bucket
CHUNKS = [(0, 0, 8), (2, 0, 3), (0, 8, 5), (1, 0, 8), (2, 3, 8), (0, 13, 1),
          (1, 8, 7), (2, 11, 2)]


def test_prefill_chunk_matches_jax_at_varied_slot_start_length(model):
    jcfg, jp, tcfg, tp = model
    eng = GenerationEngine(tcfg, tp, device="cpu", prefill_chunk=8)
    jeng = JEngine(jcfg, jp, prefill_chunk=8)
    ctx = {s: _toks(24, seed=10 + s) for s in range(3)}
    cache, jcache, _ = _paged_pair(eng, jeng, 3, 20, 4,
                                   {s: 24 for s in range(3)})
    for slot, start, n in CHUNKS:
        toks = ctx[slot][start:start + n]
        lg, cache = eng.prefill_chunk(cache, toks, slot, start=start)
        jlg, jcache = jeng.prefill_chunk(jcache, toks, slot, start=start)
        np.testing.assert_allclose(_np(lg), np.asarray(jlg), **TOL,
                                   err_msg=str((slot, start, n)))
        _assert_cache(cache, jcache)
    rep = eng.compile_report()["prefill_chunk"]
    assert rep["compiles"] == rep["signatures"] == 1     # one bucket, 8


@pytest.mark.parametrize("kernel", ["off", "on"])
def test_paged_decode_and_copy_page_match_jax(model, kernel):
    """After chunked prefills, paged decode steps (the gather path, and
    the kernel's entry point, whose wrapper runs its plain version on the
    CPU) and a copy-on-write page copy match the JAX engine."""
    jcfg, jp, tcfg, tp = model
    eng = GenerationEngine(tcfg, tp, device="cpu", prefill_chunk=8,
                           paged_kernel=kernel)
    jeng = JEngine(jcfg, jp, prefill_chunk=8)
    lens = [11, 5, 17]
    cache, jcache, table = _paged_pair(eng, jeng, 3, 24, 4,
                                       {s: n + 4 for s, n in enumerate(lens)})
    for s, n in enumerate(lens):
        ctx = _toks(n, seed=20 + s)
        for c0 in range(0, n, 8):
            _, cache = eng.prefill_chunk(cache, ctx[c0:c0 + 8], s, start=c0)
            _, jcache = jeng.prefill_chunk(jcache, ctx[c0:c0 + 8], s,
                                           start=c0)
    for step in range(3):
        toks = _toks(3, seed=30 + step)
        lg, cache = eng.decode_step(cache, toks)
        jlg, jcache = jeng.decode_step(jcache, toks)
        np.testing.assert_allclose(_np(lg), np.asarray(jlg), **TOL)
        _assert_cache(cache, jcache)
    src, dst = int(table.table[2, 1]), int(table._free[-1])
    cache = eng.copy_page(cache, src, dst)
    jcache = jeng.copy_page(jcache, src, dst)
    _assert_cache(cache, jcache)
    name = "decode_paged_kernel" if kernel == "on" else "decode_paged"
    rep = eng.compile_report()
    assert rep[name]["compiles"] == 1 and rep["copy_page"]["compiles"] == 1


def test_prefill_slot_at_two_slots_and_dense_decode_match_jax(model):
    jcfg, jp, tcfg, tp = model
    eng = GenerationEngine(tcfg, tp, device="cpu")
    jeng = JEngine(jcfg, jp)
    cache, jcache = eng.init_cache(3), jeng.init_cache(3)
    for slot, n in ((2, 13), (0, 40)):        # buckets 32 and 64
        prompt = _toks(n, seed=40 + slot)
        lg, cache = eng.prefill_slot(cache, prompt, slot)
        jlg, jcache = jeng.prefill_slot(jcache, prompt, slot)
        np.testing.assert_allclose(_np(lg), np.asarray(jlg), **TOL)
        _assert_cache(cache, jcache)
    for step in range(3):
        toks = _toks(3, seed=50 + step)
        lg, cache = eng.decode_step(cache, toks)
        jlg, jcache = jeng.decode_step(jcache, toks)
        np.testing.assert_allclose(_np(lg), np.asarray(jlg), **TOL)
        _assert_cache(cache, jcache)
    rep = eng.compile_report()
    assert rep["prefill_slot"]["compiles"] == 2       # one per bucket
    assert rep["decode_step"]["compiles"] == 1


def test_whole_pool_prefill_matches_jax(model):
    jcfg, jp, tcfg, tp = model
    eng = GenerationEngine(tcfg, tp, device="cpu")
    jeng = JEngine(jcfg, jp)
    prompt = np.stack([_toks(12, seed=60), _toks(12, seed=61)])
    lens = np.asarray([12, 7], np.int32)
    lg, cache = eng.prefill(eng.init_cache(2), prompt, lens)
    jlg, jcache = jeng.prefill(jeng.init_cache(2), prompt, lens)
    np.testing.assert_allclose(_np(lg), np.asarray(jlg), **TOL)
    _assert_cache(cache, jcache)


# ---------------------------------------------------------- signatures

def _paged_sched(eng, **kw):
    return ContinuousBatchingScheduler(eng, **kw)


def test_zero_retraces_across_page_growth_and_chunks(model):
    """Port of the reference's sentinel contract
    (``tests/test_paged_kv.py``): after warmup, page-table growth is a
    data change — zero retraces across many admissions — and chunked
    prefill compiles at most once per chunk bucket."""
    _, _, cfg, params = model
    eng = GenerationEngine(cfg, params, prefill_chunk=8, device="cpu")
    sched = _paged_sched(eng, n_slots=2, page_len=4, n_pages=16)
    warm = sched.submit(_toks(9, seed=70), max_new_tokens=3)
    sched.run_until_idle()
    warm.result(5)
    eng.mark_warm()
    prompts = [_toks(n, seed=71 + n) for n in (2, 7, 15, 20, 11)]
    futs = [sched.submit(p, max_new_tokens=4) for p in prompts]
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        sched.run_until_idle()
    for f in futs:
        f.result(5)
    rep = eng.compile_report()
    assert sum(s["retraces_after_warm"] for s in rep.values()) == 0
    assert rep["prefill_chunk"]["compiles"] <= len(eng.chunk_buckets)
    assert rep["decode_paged"]["compiles"] == 1


def test_second_cache_and_refresh(model):
    """A second cache of the same shapes starts new signatures (a graph
    bakes its cache's addresses). ``refresh`` at the same shapes copies
    the new weights into the engine's own tensors — no new signature,
    the caller's params untouched — and the next decode's logits equal a
    fresh engine's on the new params. Nothing else starts one."""
    _, _, cfg, params = model
    eng = GenerationEngine(cfg, params, device="cpu")
    a, b = eng.init_cache(2), eng.init_cache(2)
    prompt = np.stack([_toks(6, seed=80), _toks(6, seed=81)])
    _, a = eng.prefill(a, prompt)
    _, b = eng.prefill(b, prompt)
    for c in (a, b, a, b):
        eng.decode_step(c, [1, 2])
    rep = eng.compile_report()
    assert rep["prefill"]["compiles"] == 2
    assert rep["decode_step"]["compiles"] == 2
    eng.mark_warm()
    new = jax.tree_util.tree_map(lambda t: t * 1.5, params)
    before = {k: v.clone() for k, v in params["blocks"].items()}
    bound = [id(t) for t in eng._decode.bindings()]
    eng.refresh(new)
    assert [id(t) for t in eng._decode.bindings()] == bound   # in place
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        got, _ = eng.decode_step(a, [3, 4])
    for k, v in params["blocks"].items():
        assert torch.equal(v, before[k])             # the caller's params
    fresh = GenerationEngine(cfg, new, device="cpu")
    c = fresh.init_cache(2)
    _, c = fresh.prefill(c, prompt)
    c["k"].copy_(a["k"])
    c["v"].copy_(a["v"])
    c["pos"].copy_(a["pos"] - 1)
    want, _ = fresh.decode_step(c, [3, 4])
    assert torch.equal(got, want)
    assert all(s["retraces_after_warm"] == 0
               for s in eng.compile_report().values())
    eng.refresh({**new, "pos_embed": new["pos_embed"][:32]})
    assert [id(t) for t in eng._decode.bindings()] != bound   # new tensors
    assert set(eng.sentinels) == ENTRY_POINTS


def test_scheduler_greedy_equals_jax_scheduler_under_compiled_steps(model):
    """The greedy scheduler through the compiled entry points equals the
    JAX scheduler token for token, dense and paged, with one compile per
    decode signature and per bucket."""
    jcfg, jp, tcfg, tp = model
    reqs = [(_toks(5, seed=90), 8), (_toks(12, seed=91), 6),
            (_toks(3, seed=92), 9), (_toks(20, seed=93), 5)]
    jsched = JSched(JEngine(jcfg, jp), n_slots=2)
    jf = [jsched.submit(p, max_new_tokens=n) for p, n in reqs]
    jsched.run_until_idle()
    want = [np.asarray(f.result(5).tokens).tolist() for f in jf]
    for kw in ({}, {"page_len": 4}):
        eng = GenerationEngine(tcfg, tp, device="cpu", prefill_chunk=8)
        sched = ContinuousBatchingScheduler(eng, n_slots=2, **kw)
        futs = [sched.submit(p, max_new_tokens=n) for p, n in reqs]
        sched.run_until_idle()
        assert [f.result(5).tokens.tolist() for f in futs] == want
        rep = eng.compile_report()
        decode = "decode_paged" if kw else "decode_step"
        admit = "prefill_chunk" if kw else "prefill_slot"
        assert rep[decode]["compiles"] == 1
        assert rep[admit]["compiles"] <= len(
            eng.chunk_buckets if kw else eng.prefill_buckets)
        # greedy: one signature for a first token, one for a sweep
        assert rep["sample_tokens"]["compiles"] == 2


# ------------------------------------------------------------ sentinel

def test_sentinel_report_keys_match_the_reference():
    ours = CompileSentinel("x", CompiledStep(lambda t: t + 1, tuple, "x"))
    ref = JSentinel("x", lambda t: t + 1)
    assert set(ours.report()) == set(ref.report())


def test_sentinel_counts_new_signatures_and_warns_after_warm():
    s = CompileSentinel("f", CompiledStep(lambda t, k: t * k, tuple, "f"))
    s(torch.ones(2), 2)
    s(torch.zeros(2), 2)
    s(torch.ones(3), 2)
    assert (s.compiles, len(s.signatures)) == (2, 2)
    s.mark_warm()
    with pytest.warns(RuntimeWarning, match="retrace #1 of 'f'"):
        s(torch.ones(2), 3)                   # a static argument drifted
    assert s.report() == {"name": "f", "compiles": 3, "signatures": 3,
                          "warm": True, "retraces_after_warm": 1}


def test_compiled_step_signature_binds_by_identity_and_hooks_see_calls():
    """A :class:`Bound` argument is keyed by identity, a tensor by shape,
    anything else by repr; on the CPU every call is direct and reaches the
    hooks with its signature, which the sentinel counts."""
    seen = []
    step = CompiledStep(lambda c, x, k: c["a"].add_(x * k).sum(),
                        tuple, "t")
    step.hooks.append(lambda kind, key: seen.append(kind))
    sent = CompileSentinel("t", step)
    c1, c2 = {"a": torch.zeros(2)}, {"a": torch.zeros(2)}
    x = torch.ones(2)
    assert signature((Bound(c1), x, 2)) != signature((Bound(c2), x, 2))
    assert signature((Bound(c1), x, 2)) == signature((Bound(c1),
                                                      x + 1, 2))
    assert signature((Bound(c1), x, 2)) != signature((Bound(c1), x, 3))
    for c in (c1, c1, c2):
        sent(Bound(c), x, 2)
    assert torch.equal(c1["a"], torch.full((2,), 4.0))
    assert seen == ["direct"] * 3 and step.calls["direct"] == 3
    assert sent.compiles == 2
