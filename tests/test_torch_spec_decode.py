"""The port's speculative decoding (``deeplearning4j_tpu_torch.serving.spec``:
``SpeculativeDecoder``, ``EngineDraft``, ``NgramDraft``, ``plain_generate``,
``race_spec``) against the JAX package's, on the CPU.

Every test of ``tests/test_spec_decode.py``, ported on a small f32 model
(2 layers, d_model 64, 4 heads, vocab 61, max_seq 64, ``prefill_chunk=8``),
weights drawn by the JAX package and shared through ``params_from_numpy``.
The same prompt and the same drafts go through the JAX package's
``SpeculativeDecoder``: the tokens, ``stats()`` and the ``dl4j_spec_*``
counts are equal. Greedy speculative output equals ``generate()`` for
every draft; the rollback fuzz holds ``PageTable.check()`` after every
round. Every test has its own autotune stores.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import obs as jobs
from deeplearning4j_tpu.kernels import autotune as jat
from deeplearning4j_tpu.serving import GenerationEngine as JEngine
from deeplearning4j_tpu.serving import spec as jspec
from deeplearning4j_tpu.zoo import transformer as jtfm
from deeplearning4j_tpu_torch import obs as tobs
from deeplearning4j_tpu_torch.kernels import autotune as at
from deeplearning4j_tpu_torch.serving import (
    EngineDraft, GenerationEngine, NgramDraft, PageTable, SpeculativeDecoder)
from deeplearning4j_tpu_torch.serving import spec
from deeplearning4j_tpu_torch.zoo import transformer as ttfm

torch.set_num_threads(2)

VOCAB = 61
SMALL = dict(vocab_size=VOCAB, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq=64, remat=False, attn_scores_bf16=False)
SPEC_COUNTERS = ("dl4j_spec_rounds_total", "dl4j_spec_proposed_total",
                 "dl4j_spec_accepted_total",
                 "dl4j_spec_rollback_pages_total")


@pytest.fixture(scope="module")
def model():
    jcfg = jtfm.TransformerConfig(dtype=jnp.float32, **SMALL)
    tcfg = ttfm.TransformerConfig(dtype=torch.float32, **SMALL)
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


@pytest.fixture(autouse=True)
def _isolated_stores(tmp_path, monkeypatch):
    monkeypatch.setattr(at, "_CACHE_PATH", tmp_path / "torch.json")
    monkeypatch.setattr(jat, "_CACHE_PATH", tmp_path / "jax.json")
    at._memory_cache.clear()
    jat._memory_cache.clear()
    yield
    at._memory_cache.clear()
    jat._memory_cache.clear()


def _toks(shape, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, shape).astype(
        np.int32)


class RandomDraft:
    """Adversarial draft: uniform noise — near-total rejection every
    round, the rollback path's worst case."""

    name = "random"

    def __init__(self, seed=0):
        self.rng = np.random.default_rng(seed)

    def reset(self):
        pass

    def propose(self, ids, k):
        return [int(t) for t in self.rng.integers(0, VOCAB, (k,))]


def _counts(reg, mode):
    return {n: (reg.get(n).value(mode=mode) if reg.get(n) else 0.0)
            for n in SPEC_COUNTERS}


# --------------------------------------------- PageTable.trim (unit)

def test_trim_frees_exclusive_pages_lifo():
    pt = PageTable(n_slots=1, n_pages=6, page_len=4, pages_per_slot=6)
    assert pt.map(0, 20)
    pt.note_fill(0, 20)
    pt.check()
    assert pt.trim(0, 9) == 2
    assert int(pt.mapped[0]) == 3 and pt.free_pages == 3
    assert pt.table[0, 3:].tolist() == [6, 6, 6]
    pt.check()
    assert pt.trim(0, 9) == 0 and pt.trim(0, 12) == 0
    assert pt.map(0, 20)
    pt.check()


def test_trim_shared_pages_survive():
    pt = PageTable(n_slots=2, n_pages=6, page_len=4, pages_per_slot=4)
    assert pt.map(0, 12)
    shared = [int(p) for p in pt.table[0, :3]]
    for p in shared:
        pt.incref(p)
    holds = {p: 1 for p in shared}
    pt.check(external=holds)
    assert pt.trim(0, 4) == 2
    assert pt.free_pages == 3
    assert all(int(pt.refcount[p]) == (2 if p == shared[0] else 1)
               for p in shared)
    pt.check(external=holds)


# -------------------------------------------------- bit-identity

DRAFTS = {
    "engine": (lambda eng: EngineDraft(eng), lambda jeng: jspec.EngineDraft(
        jeng)),
    "ngram": (lambda eng: NgramDraft(3), lambda jeng: jspec.NgramDraft(3)),
    "random": (lambda eng: RandomDraft(), lambda jeng: RandomDraft()),
}


@pytest.mark.parametrize("which", list(DRAFTS))
def test_spec_greedy_bit_identical(engine, jengine, which):
    """Greedy speculative output == ``generate()`` for every draft, and
    the JAX decoder's tokens, stats and ``dl4j_spec_*`` counts on the
    same prompt and draft."""
    mk, jmk = DRAFTS[which]
    prompt = _toks((12,))
    want = [int(t) for t in engine.generate(prompt, 24)]
    treg, jreg = tobs.get_registry(), jobs.get_registry()
    treg.reset()
    jreg.reset()
    dec = SpeculativeDecoder(engine, mk(engine), k=4)
    got = [int(t) for t in dec.generate(prompt, 24)]
    jdec = jspec.SpeculativeDecoder(jengine, jmk(jengine), k=4)
    jgot = [int(t) for t in jdec.generate(prompt, 24)]
    assert got == want == jgot
    st = dec.stats()
    assert st == jdec.stats()
    assert st["rounds"] >= 1
    assert st["accepted_per_step"] == pytest.approx(
        (len(got) - 1) / st["rounds"])
    mode = dec.draft.name
    assert _counts(treg, mode) == _counts(jreg, mode)
    dec.release()
    dec.table.check()
    assert dec.table.free_pages == dec.table.n_pages


def test_self_draft_accepts_everything(engine):
    prompt = _toks((10,), seed=2)
    dec = SpeculativeDecoder(engine, EngineDraft(engine), k=4)
    out = dec.generate(prompt, 21)          # 1 prefill token + 5 rounds
    st = dec.stats()
    assert len(out) == 21
    assert st["rounds"] == 5 and st["accepted"] == 20
    assert st["accepted_per_step"] == 4.0 > 1.0
    assert st["rollback_pages"] == 0
    dec.release()


def test_eos_truncation(engine, jengine):
    prompt = _toks((8,), seed=1)
    want = [int(t) for t in engine.generate(prompt, 24)]
    eos = want[7]
    dec = SpeculativeDecoder(engine, EngineDraft(engine), k=4)
    got = [int(t) for t in dec.generate(prompt, 24, eos_id=eos)]
    assert got == want[:want.index(eos) + 1]
    jdec = jspec.SpeculativeDecoder(jengine, jspec.EngineDraft(jengine), k=4)
    assert [int(t) for t in jdec.generate(prompt, 24, eos_id=eos)] == got
    dec.release()


def test_engine_draft_reuses_its_cache_across_requests(engine):
    """A draft serves request after request from one cache (a new cache
    is a new graph signature on the card), each from its own prompt."""
    draft = EngineDraft(engine)
    for seed in (3, 4):
        prompt = _toks((9,), seed=seed)
        want = [int(t) for t in engine.generate(prompt, 13)]
        dec = SpeculativeDecoder(engine, draft, k=3)
        assert [int(t) for t in dec.generate(prompt, 13)] == want
        assert dec.stats()["accepted_per_step"] == 3.0
        dec.release()
    first = draft.cache
    dec = SpeculativeDecoder(engine, draft, k=3)
    dec.generate(_toks((9,), seed=5), 8)
    assert draft.cache is first


# ------------------------------------------------- rollback fuzz

def test_rollback_fuzz_refcounts_hold(engine, jengine):
    """Adversarial drafts force a rejection (and a page rollback) nearly
    every round; the table invariants hold after each one, and every
    round's mapping equals the JAX decoder's."""
    prompt = _toks((9,), seed=5)
    want = [int(t) for t in engine.generate(prompt, 28)]
    for seed in range(3):
        tables = {}

        def audit(rnd, dec, key):
            dec.table.check()
            tables.setdefault(key, []).append(
                (dec.table.table.tolist(), dec.table.refcount.tolist(),
                 dec.table.free_pages))

        dec = SpeculativeDecoder(engine, RandomDraft(seed), k=5)
        got = [int(t) for t in dec.generate(
            prompt, 28, fault_hook=lambda r, d: audit(r, d, "port"))]
        jdec = jspec.SpeculativeDecoder(jengine, RandomDraft(seed), k=5)
        jgot = [int(t) for t in jdec.generate(
            prompt, 28, fault_hook=lambda r, d: audit(r, d, "jax"))]
        assert got == want == jgot
        assert tables["port"] == tables["jax"]
        st = dec.stats()
        assert st == jdec.stats()
        assert st["rounds"] >= 20
        dec.table.check()
        dec.release()
        dec.table.check()
        assert dec.table.free_pages == dec.table.n_pages


def test_metrics_census(engine):
    reg = tobs.get_registry()
    reg.reset()
    dec = SpeculativeDecoder(engine, RandomDraft(), k=4)
    dec.generate(_toks((9,), seed=5), 16)
    st = dec.stats()
    dec.release()
    assert _counts(reg, "random") == {
        "dl4j_spec_rounds_total": st["rounds"],
        "dl4j_spec_proposed_total": st["proposed"],
        "dl4j_spec_accepted_total": st["accepted"],
        "dl4j_spec_rollback_pages_total": st["rollback_pages"]}


# -------------------------------------- preemption / cancel safety

def test_preempt_resume_mid_generation_bit_identical(engine):
    prompt = _toks((11,), seed=6)
    want = [int(t) for t in engine.generate(prompt, 24)]

    def fault(rnd, dec):
        if rnd == 2:
            dec.preempt()
            assert dec.table.free_pages == dec.table.n_pages
            dec.table.check()
            dec.resume()

    dec = SpeculativeDecoder(engine, NgramDraft(3), k=4)
    got = [int(t) for t in dec.generate(prompt, 24, fault_hook=fault)]
    assert got == want
    dec.release()
    dec.table.check()


def test_cancel_releases_everything(engine):
    def fault(rnd, dec):
        if rnd == 1:
            dec.cancel()

    dec = SpeculativeDecoder(engine, NgramDraft(3), k=4)
    out = dec.generate(_toks((11,), seed=6), 24, fault_hook=fault)
    assert 1 <= len(out) < 24
    dec.table.check()
    assert dec.table.free_pages == dec.table.n_pages


def test_pool_exhaustion_raises(engine):
    dec = SpeculativeDecoder(engine, NgramDraft(3), k=4, n_pages=2,
                             page_len=4)
    with pytest.raises(RuntimeError, match="exhausted"):
        dec.generate(_toks((12,)), 8)
    dec.release()
    dec.table.check()


def test_decoder_rejects_bad_k(engine):
    with pytest.raises(ValueError):
        SpeculativeDecoder(engine, NgramDraft(), k=0)
    with pytest.raises(ValueError):
        SpeculativeDecoder(engine, NgramDraft(), k=engine.chunk_len)


def test_spec_over_an_int8_pool_equals_int8_plain_decode(model):
    """Speculation over an int8 pool: verify and decode read the same
    dequantized pages, so the output is the int8 pool's plain greedy
    decode."""
    _, _, tcfg, tp = model
    eng = GenerationEngine(tcfg, tp, device="cpu", prefill_chunk=8,
                           quant_kv="on")
    prompt = _toks((10,), seed=8)
    want, _ = spec.plain_generate(eng, prompt, 16, page_len=4)
    dec = SpeculativeDecoder(eng, NgramDraft(3), k=3, page_len=4)
    assert spec.kvcache.is_quantized(dec.cache)
    assert dec.generate(prompt, 16).tolist() == want.tolist()
    dec.release()
    dec.table.check()


# ------------------------------------------------------ draft zoo

def test_engine_draft_from_truncated_zoo_model(model):
    _, _, tcfg, tp = model
    dcfg, dparams = ttfm.draft_params(tp, tcfg, n_layers=1)
    assert dcfg.n_layers == 1
    assert dparams["embed"] is tp["embed"]
    target = GenerationEngine(tcfg, tp, device="cpu", prefill_chunk=8)
    draft = EngineDraft(GenerationEngine(dcfg, dparams, device="cpu",
                                         prefill_chunk=8))
    prompt = _toks((10,), seed=8)
    want = [int(t) for t in target.generate(prompt, 16)]
    dec = SpeculativeDecoder(target, draft, k=3)
    assert [int(t) for t in dec.generate(prompt, 16)] == want
    dec.release()
    dec.table.check()


def test_ngram_draft_proposals():
    for d in (NgramDraft(3), jspec.NgramDraft(3)):
        assert d.propose([5, 1, 2, 3, 9, 1, 2, 3], 2) == [9, 1]
        assert d.propose([1, 2, 3], 3) == [3, 3, 3]


# -------------------------------------------------- promotion race

def test_race_spec_verdicts_records_counters(engine):
    reg = tobs.get_registry()
    reg.reset()
    prompt = _toks((10,), seed=4)
    res = spec.race_spec(engine, {"engine": EngineDraft(engine),
                                  "random": RandomDraft()},
                         prompt, max_new_tokens=20, k=4, reps=1)
    assert res["choice"] in ("plain", "engine", "random")
    assert res["backend"] == "cpu" and res["tokens"] == 20
    arms = res["arms"]
    assert arms["engine"]["bit_identical"]
    assert arms["random"]["bit_identical"]
    assert arms["engine"]["accepted_per_step"] > 1.0
    assert arms["random"]["verdict"] == "fallback_slower"
    for name, a in arms.items():
        assert a["verdict"] in ("promoted", "fallback_slower",
                                "fallback_fidelity")
        rec = at.lookup(spec.spec_bucket_key(engine.cfg, name, 4, "cpu"),
                        sha=spec.spec_sha())
        assert rec is not None
        assert rec["choice"][0] == (name if a["verdict"] == "promoted"
                                    else "plain")
        assert reg.get("dl4j_autotune_promotions_total").value(
            kernel="spec_decode", verdict=a["verdict"]) >= 1


def test_plain_generate_matches_engine_generate(engine, jengine):
    prompt = _toks((10,), seed=4)
    want = [int(t) for t in engine.generate(prompt, 20)]
    toks, dt = spec.plain_generate(engine, prompt, 20)
    assert [int(t) for t in toks] == want and dt > 0
    jtoks, _ = jspec.plain_generate(jengine, prompt, 20)
    assert jtoks.tolist() == want
    # a reused pool gives the same tokens and is left with nothing mapped
    pool = engine.init_paged_cache(1, 4, 16)
    for _ in range(2):
        toks, _ = spec.plain_generate(engine, prompt, 20, cache=pool)
        assert toks.tolist() == want
    assert int(pool["pages"].min()) == 4
