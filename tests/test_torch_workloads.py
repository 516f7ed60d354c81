"""Typed serving requests of the port (SCORE / EMBED / BEAM / CONSTRAINED,
``deeplearning4j_tpu_torch.serving.workloads`` and the scheduler's
``submit(kind=...)``) against the JAX package's, on the CPU.

The tests of ``tests/test_workloads.py`` (the metrics-and-census and the
int8-KV SCORE tests run on both schedulers; the three fleet tests run
every kind through the port's ``FleetRouter``), ported to the port on the same tiny f32 model (vocab 61, d_model 32, 2
heads, 2 layers, max_seq 32, ``prefill_chunk=8``, page_len 4), weights
drawn by the JAX package and shared through ``params_from_numpy``. The
same requests go through the JAX scheduler: SCORE logprobs (on the int8
pool too) and EMBED vectors agree at atol 1e-5, BEAM
sequences are identical and their logprobs agree at 1e-5, greedy
CONSTRAINED tokens are identical, and malformed submits raise the same
``ValueError``. The reference's own oracles (the full forward, greedy
``generate``) hold as in its tests.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving import (
    ContinuousBatchingScheduler as JSched, GenerationEngine as JEngine)
from deeplearning4j_tpu.serving import workloads as jworkloads
from deeplearning4j_tpu.zoo import transformer as jtfm
from deeplearning4j_tpu_torch.serving import (
    BeamResult, ContinuousBatchingScheduler, EmbedResult, FleetRouter,
    GenerationEngine, RequestKind, ScoreResult, vocab_mask, workloads)
from deeplearning4j_tpu_torch.zoo import transformer as ttfm

torch.set_num_threads(2)

ATOL = 2e-4          # against the full forward, the reference's own bar
PARITY = 1e-5        # against the JAX scheduler
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


def _toks(n, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, (n,)).astype(
        np.int32)


def paged(engine, sched_cls=ContinuousBatchingScheduler, **kw):
    kw.setdefault("n_slots", 4)
    kw.setdefault("page_len", 4)
    kw.setdefault("n_pages", 32)
    return sched_cls(engine, **kw)


def run(sched, *reqs):
    futs = [sched.submit(*a, **k) for a, k in reqs]
    sched.run_until_idle()
    return [f.result(timeout=30) for f in futs]


def both(engine, jengine, *reqs, **kw):
    """The same requests through a fresh port scheduler and a fresh JAX
    one; the port's results, then the JAX package's."""
    return (run(paged(engine, **kw), *reqs),
            run(paged(jengine, JSched, **kw), *reqs))


def full_logprobs(params, cfg, toks):
    """(T, V) log-softmax of the JAX full forward — the SCORE oracle."""
    lg, _ = jtfm.forward(params, cfg, jnp.asarray(toks)[None])
    lg = np.asarray(lg, np.float32)[0]
    mx = lg.max(axis=-1, keepdims=True)
    return lg - mx - np.log(np.exp(lg - mx).sum(-1, keepdims=True))


def full_hidden(params, cfg, toks):
    """The JAX full forward's post-``ln_f`` rows — the EMBED oracle."""
    x = jtfm.embed(params, cfg, jnp.asarray(toks)[None])
    x, _ = jtfm.apply_blocks(params["blocks"], cfg, x)
    return np.asarray(jtfm.hidden_rows(params, cfg, x[0]), np.float32)


# ----------------------------------------------------------- SCORE

@pytest.mark.parametrize("n,seed", [(13, 1), (21, 2)],
                         ids=["one_chunk_and_a_bit", "three_chunks"])
def test_score_matches_reference_every_position(model, engine, jengine, n,
                                                seed):
    """SCORE logprobs at every position, and across chunk boundaries (21
    tokens are 3 chunks of 8: the target of row chunk_end-1 lives in the
    NEXT chunk), against the JAX scheduler and the full forward."""
    jcfg, jp, _, _ = model
    toks = _toks(n, seed=seed)
    (res,), (jres,) = both(engine, jengine, ((toks,), dict(kind="score")))
    assert isinstance(res, ScoreResult)
    assert res.logprobs.shape == (n - 1,) and res.logprobs.dtype == np.float32
    np.testing.assert_allclose(res.logprobs, jres.logprobs, atol=PARITY,
                               rtol=0)
    lsm = full_logprobs(jp, jcfg, toks)
    ref = lsm[np.arange(n - 1), toks[1:]]
    np.testing.assert_allclose(res.logprobs, ref, atol=ATOL)
    assert res.perplexity == pytest.approx(jres.perplexity, rel=1e-5)
    assert res.perplexity == pytest.approx(
        float(np.exp(-ref.mean())), rel=1e-3)
    assert res.finish_reason == "complete"
    assert res.prompt_tokens == n and res.tokens.size == 0


@pytest.mark.parametrize("which", ["port", "reference"])
def test_score_quantized_kv_stays_close(model, engine, jengine, which):
    """The reference's ``test_score_quantized_kv_stays_close`` on both
    schedulers: over an int8 pool SCORE scores with the pages (and
    weights) it decodes with — bounded, not bit-exact, against the full
    forward (atol 0.3) — and the port's logprobs equal the JAX
    scheduler's int8 path within 1e-5."""
    jcfg, jp, _, _ = model
    toks = _toks(13, seed=3)
    eng, cls = (engine, ContinuousBatchingScheduler) if which == "port" \
        else (jengine, JSched)
    (res,) = run(paged(eng, cls, quant_kv="int8"),
                 ((toks,), dict(kind="score")))
    lsm = full_logprobs(jp, jcfg, toks)
    ref = lsm[np.arange(12), toks[1:]]
    assert np.isfinite(res.perplexity)
    np.testing.assert_allclose(res.logprobs, ref, atol=0.3)
    if which == "port":
        (jres,) = run(paged(jengine, JSched, quant_kv="int8"),
                      ((toks,), dict(kind="score")))
        np.testing.assert_allclose(res.logprobs, jres.logprobs, atol=PARITY,
                                   rtol=0)


# ----------------------------------------------------------- EMBED

@pytest.mark.parametrize("pooling,n,seed", [("mean", 11, 4),
                                            ("last", 9, 5)])
def test_embed_pooling_matches_reference(model, engine, jengine, pooling,
                                         n, seed):
    jcfg, jp, tcfg, _ = model
    toks = _toks(n, seed=seed)
    kw = dict(kind="embed") if pooling == "mean" \
        else dict(kind="embed", pooling="last")
    (res,), (jres,) = both(engine, jengine, ((toks,), kw))
    assert isinstance(res, EmbedResult) and res.pooling == pooling
    assert res.embedding.shape == (tcfg.d_model,)
    assert res.embedding.dtype == np.float32
    np.testing.assert_allclose(res.embedding, jres.embedding, atol=PARITY,
                               rtol=0)
    hid = full_hidden(jp, jcfg, toks)
    want = hid.mean(axis=0) if pooling == "mean" else hid[-1]
    np.testing.assert_allclose(res.embedding, want, atol=ATOL)


# ------------------------------------------------------------ BEAM

def test_beam_width1_bit_identical_to_generate(engine, jengine):
    toks = _toks(12, seed=6)
    oracle = np.asarray(engine.generate(toks, max_new_tokens=6))
    (res,), (jres,) = both(engine, jengine,
                           ((toks, 6), dict(kind="beam", beam_width=1)))
    assert isinstance(res, BeamResult)
    assert res.tokens.tolist() == oracle.tolist()
    assert res.tokens.tolist() == np.asarray(jres.tokens).tolist()
    assert len(res.sequences) == 1


def test_beam_never_loses_to_greedy(engine, jengine):
    """Width 4: the same hypotheses as the JAX beam search (logprobs at
    1e-5), best first, and the best at least greedy's logprob over the
    same horizon (greedy re-scored through SCORE)."""
    toks = _toks(12, seed=7)
    sched = paged(engine)
    (beam,) = run(sched, ((toks, 6), dict(kind="beam", beam_width=4)))
    (jbeam,) = run(paged(jengine, JSched),
                   ((toks, 6), dict(kind="beam", beam_width=4)))
    assert len(beam.sequences) == 4
    assert [s.tolist() for s in beam.sequences] == \
        [np.asarray(s).tolist() for s in jbeam.sequences]
    np.testing.assert_allclose(beam.scores, jbeam.scores, atol=PARITY,
                               rtol=0)
    assert beam.scores == sorted(beam.scores, reverse=True)
    (greedy,) = run(sched, ((toks, 6), {}))
    (score,) = run(sched, ((np.concatenate([toks, greedy.tokens]),),
                           dict(kind="score")))
    greedy_lp = float(np.sum(score.logprobs[toks.size - 1:]))
    assert beam.best_logprob >= greedy_lp - 1e-4


def test_beam_page_sharing_census(engine, jengine):
    """k beams of length T hold about T + k·divergent pages: the prompt's
    full pages are mapped ONCE; the free/refcount invariant holds and the
    census equals the JAX scheduler's at every step."""
    toks = _toks(12, seed=8)
    width, new = 4, 6
    sched, jsched = paged(engine), paged(jengine, JSched)
    fut = sched.submit(toks, max_new_tokens=new, kind="beam",
                       beam_width=width)
    jfut = jsched.submit(toks, max_new_tokens=new, kind="beam",
                         beam_width=width)
    pt, jpt = sched._pages, jsched._pages
    shr = toks.size // pt.page_len            # full prompt pages
    saw_shared = 0
    while sched.step():
        assert jsched.step()
        assert sched.check_pages()
        assert (pt.used_pages, pt.mapped_pages, pt.shared_pages) == \
            (jpt.used_pages, jpt.mapped_pages, jpt.shared_pages)
        assert pt.table.tolist() == jpt.table.tolist()
        saw_shared = max(saw_shared, pt.shared_pages)
        div = pt.pages_for(toks.size + new) - shr + 1
        assert pt.used_pages <= shr + width * div
    assert not jsched.step()
    assert fut.result(timeout=30).tokens.tolist() == \
        np.asarray(jfut.result(timeout=30).tokens).tolist()
    assert saw_shared >= shr > 0
    assert sched.check_pages()
    assert pt.used_pages == 0


def test_beam_preempt_and_drain_release_every_lane(engine, jengine):
    toks = _toks(12, seed=9)
    # page pressure: a width-3 group and a generate compete for 12 pages
    reqs = (((toks, 10), dict(kind="beam", beam_width=3)), ((toks, 6), {}))
    sched = paged(engine, n_pages=12)
    res = run(sched, *reqs)
    jres = run(paged(jengine, JSched, n_pages=12), *reqs)
    assert isinstance(res[0], BeamResult) and len(res[1].tokens) == 6
    for r, j in zip(res, jres):
        assert r.tokens.tolist() == np.asarray(j.tokens).tolist()
    assert sched.check_pages() and sched._pages.used_pages == 0
    # drain mid-flight: every lane's pages come back, the future resolves
    sched2 = paged(engine)
    fut = sched2.submit(toks, max_new_tokens=18, kind="beam",
                        beam_width=4)
    for _ in range(3):
        sched2.step()
    sched2.drain()
    assert fut.done()
    assert sched2.check_pages() and sched2._pages.used_pages == 0


# ----------------------------------------------------- CONSTRAINED

def test_constrained_all_true_bit_identical_to_greedy(engine, jengine):
    toks = _toks(12, seed=10)
    oracle = np.asarray(engine.generate(toks, max_new_tokens=6))
    (res,), (jres,) = both(engine, jengine, (
        (toks, 6), dict(kind="constrained",
                        token_mask=np.ones(VOCAB, bool))))
    assert res.tokens.tolist() == oracle.tolist()
    assert res.tokens.tolist() == np.asarray(jres.tokens).tolist()


def test_constrained_allowlist_matches_reference(engine, jengine):
    """Greedy under an allowlist, beside an unconstrained request in the
    same sweeps (its lane stays all-true): the JAX scheduler's tokens."""
    allowed = [3, 5, 7, 11, 40]
    reqs = (((_toks(10, seed=13), 6),
             dict(kind="constrained",
                  token_mask=vocab_mask(allowed, VOCAB))),
            ((_toks(9, seed=14), 6), {}))
    res, jres = both(engine, jengine, *reqs)
    assert set(res[0].tokens.tolist()) <= set(allowed)
    for r, j in zip(res, jres):
        assert r.tokens.tolist() == np.asarray(j.tokens).tolist()
    assert res[1].tokens.tolist() == \
        engine.generate(_toks(9, seed=14), 6).tolist()


def test_constrained_tokens_always_in_mask_under_fuzz(engine):
    rng = np.random.default_rng(11)
    sched = paged(engine)
    for trial in range(4):
        allowed = rng.choice(VOCAB, size=rng.integers(2, 8),
                             replace=False)
        (res,) = run(sched, ((_toks(10, seed=trial), 6),
                             dict(kind="constrained",
                                  token_mask=vocab_mask(allowed, VOCAB),
                                  temperature=0.8, top_k=5)))
        assert set(res.tokens.tolist()) <= set(allowed.tolist()), trial


def test_constrained_callable_grammar_steps(engine, jengine):
    calls = []

    def alternate(generated):
        # grammar stepping: even positions admit evens, odd admit odds
        calls.append(len(generated))
        m = np.zeros(VOCAB, bool)
        m[len(generated) % 2::2] = True
        return m

    req = ((_toks(9, seed=12), 6),
           dict(kind="constrained", token_mask=alternate))
    (res,), (jres,) = both(engine, jengine, req)
    assert [t % 2 for t in res.tokens] == [0, 1, 0, 1, 0, 1]
    assert res.tokens.tolist() == np.asarray(jres.tokens).tolist()
    assert calls and calls[0] == 0    # consulted before EVERY token


# ------------------------------------------- zero-retrace contract

def test_zero_retraces_after_warm_across_all_kinds(model):
    _, _, tcfg, tp = model
    eng = GenerationEngine(tcfg, tp, device="cpu", prefill_chunk=8)
    sched = paged(eng)
    mask = np.ones(VOCAB, bool)
    warm = [((_toks(12), 5), {}),
            ((_toks(12), 1), dict(kind="score")),
            ((_toks(12), 1), dict(kind="embed")),
            ((_toks(12), 5), dict(kind="beam", beam_width=3)),
            ((_toks(12), 5), dict(kind="constrained", token_mask=mask))]
    run(sched, *warm)
    eng.mark_warm()
    varied = [((_toks(7, seed=1), 6), {}),
              ((_toks(9, seed=2), 1), dict(kind="score")),
              ((_toks(5, seed=3), 1), dict(kind="embed", pooling="last")),
              ((_toks(7, seed=4), 7), dict(kind="beam", beam_width=4)),
              ((_toks(6, seed=5), 4), dict(kind="constrained",
                                           token_mask=mask,
                                           temperature=0.5))]
    run(sched, *varied)
    rep = eng.compile_report()
    retraced = {k: v for k, v in rep.items() if v["retraces_after_warm"]}
    assert not retraced, retraced
    for name in ("verify_chunk", "embed_chunk", "sample_tokens_masked"):
        assert rep[name]["compiles"] >= 1, name


# -------------------------------------------------- submit contract

MALFORMED = [
    ("unknown_keyword", (), dict(bogus=1)),
    ("float_ids", ("float",), {}),
    ("vocabulary", ("oov",), {}),
    ("beam_knob", (), dict(beam_width=2)),
    ("constrained_knob", (), dict(token_mask=np.ones(VOCAB, bool))),
    ("embed_knob", (), dict(pooling="last")),
    ("score_one_token", ("one",), dict(kind="score")),
    ("pooling", (), dict(kind="embed", pooling="max")),
    ("no_mask", (), dict(kind="constrained")),
    ("empty_mask", (), dict(kind="constrained",
                            token_mask=np.zeros(VOCAB, bool))),
    ("mask_shape", (), dict(kind="constrained",
                            token_mask=np.ones(VOCAB + 1, bool))),
    ("beam_width", (), dict(kind="beam", beam_width=99)),
    ("beam_temperature", (), dict(kind="beam", beam_width=2,
                                  temperature=0.5)),
    ("kind", (), dict(kind="translate")),
    ("kind_wire", (), dict(kind=99)),
    ("budget", ("max_len",), {}),
    ("beam_pages", ("beam_pages",), dict(kind="beam", beam_width=4)),
]


def test_submit_rejects_malformed_requests(engine, jengine):
    """Every malformed submit raises the JAX scheduler's ValueError, word
    for word."""
    ours = paged(engine, n_pages=12)
    ref = paged(jengine, JSched, n_pages=12)
    toks = _toks(10)
    # spec -> (prompt, max_new_tokens); the default is (toks, 4)
    special = {"float": (np.asarray([0.5, 1.5]), 4),
               "oov": (np.asarray([0, VOCAB], np.int32), 4),
               "one": (toks[:1], 4),
               "max_len": (_toks(30), 8),           # 37 tokens > 32
               "beam_pages": (_toks(20), 10)}       # 5 + 4 x 3 > 12 pages
    for name, spec, kw in MALFORMED:
        prompt, n = special[spec[0]] if spec else (toks, 4)
        with pytest.raises(ValueError) as mine:
            ours.submit(prompt, n, **kw)
        with pytest.raises(ValueError) as theirs:
            ref.submit(prompt, n, **kw)
        assert str(mine.value) == str(theirs.value), name
    assert ours.queue_depth() == 0


def test_typed_kinds_need_the_paged_pool(engine):
    dense = ContinuousBatchingScheduler(engine, n_slots=2)
    for kind in ("score", "embed", "beam"):
        with pytest.raises(ValueError, match="paged"):
            dense.submit(_toks(10), kind=kind)
    # CONSTRAINED runs on the dense pool, greedy as generate
    (res,) = run(dense, ((_toks(10, seed=3), 5),
                         dict(kind="constrained",
                              token_mask=np.ones(VOCAB, bool))))
    assert res.tokens.tolist() == \
        engine.generate(_toks(10, seed=3), 5).tolist()


def test_request_kind_coercion():
    assert RequestKind.coerce("BEAM") is RequestKind.BEAM
    assert RequestKind.coerce(RequestKind.SCORE) is RequestKind.SCORE
    assert RequestKind.coerce(2) is RequestKind.EMBED
    for k in RequestKind:
        assert RequestKind.coerce(k.wire) is k
        # the port's wire bytes and values are the reference's
        jk = jworkloads.RequestKind.coerce(k.value)
        assert (jk.wire, jk.value) == (k.wire, k.value)
    assert workloads.ALL_KINDS == jworkloads.ALL_KINDS
    assert workloads.POOLING_WIRE == jworkloads.POOLING_WIRE
    with pytest.raises(ValueError, match="wire byte"):
        RequestKind.coerce(99)
    with pytest.raises(ValueError, match="coerce"):
        RequestKind.coerce(1.5)
    with pytest.raises(ValueError, match="empty allowlist"):
        vocab_mask([], VOCAB)
    np.testing.assert_array_equal(vocab_mask([1, 4], VOCAB),
                                  jworkloads.vocab_mask([1, 4], VOCAB))


@pytest.mark.parametrize("which", ["port", "reference"])
def test_workload_metrics_and_kind_census(engine, jengine, which):
    """The reference's ``test_workload_metrics_and_kind_census`` on both
    schedulers: a BEAM and a SCORE request add one each to
    ``dl4j_workload_requests_total{kind}``, and the snapshot after the
    beam's first step counts it once in ``request_kinds`` — the port's
    registry and recorder read as the reference's do."""
    if which == "port":
        from deeplearning4j_tpu_torch.obs import get_registry
        eng, cls, kinds = engine, ContinuousBatchingScheduler, \
            workloads.ALL_KINDS
    else:
        from deeplearning4j_tpu.obs import get_registry
        eng, cls, kinds = jengine, JSched, jworkloads.ALL_KINDS
    reg = get_registry()
    base = reg.counter("dl4j_workload_requests_total",
                       "Typed serving requests, by kind",
                       labelnames=("kind",))
    before = {k: base.value(kind=k) for k in kinds}
    sched = paged(eng, cls)
    toks = _toks(12)
    fut = sched.submit(toks, max_new_tokens=6, kind="beam", beam_width=2)
    sched.step()
    census = [s for s in sched.flight_recorder.snapshots()
              if s.get("request_kinds")]
    run(sched, ((toks,), dict(kind="score")))
    fut.result(timeout=30)
    assert base.value(kind="beam") == before["beam"] + 1
    assert base.value(kind="score") == before["score"] + 1
    assert census and census[-1]["request_kinds"].get("beam") == 1


# ------------------------------------------------------- fleet wire

@pytest.fixture(scope="module")
def fleet(engine):
    return FleetRouter(engine, n_replicas=2, n_slots=4,
                       scheduler_kwargs={"page_len": 4, "n_pages": 32})


def test_fleet_roundtrips_every_kind(fleet):
    toks = _toks(12, seed=20)
    futs = {
        "generate": fleet.submit(toks, max_new_tokens=5),
        "score": fleet.submit(toks, kind="score"),
        "embed": fleet.submit(toks, kind="embed", pooling="last"),
        "beam": fleet.submit(toks, max_new_tokens=5, kind="beam",
                             beam_width=3),
        "constrained": fleet.submit(toks, max_new_tokens=5,
                                    kind="constrained",
                                    allowed_ids=[3, 5, 7]),
    }
    fleet.run_until_idle()
    res = {k: f.result(timeout=30) for k, f in futs.items()}
    for kind, r in res.items():
        assert r.kind == kind, (kind, r.kind)
    assert len(res["score"].logprobs) == toks.size - 1
    assert len(res["embed"].embedding) == 32
    assert np.isfinite(res["beam"].best_logprob)
    assert len(res["beam"].tokens) == 5
    assert set(res["constrained"].tokens.tolist()) <= {3, 5, 7}
    assert res["generate"].logprobs is None
    assert res["generate"].embedding is None


def test_fleet_constrained_is_allowlist_only(fleet):
    with pytest.raises(ValueError, match="allowed_ids"):
        fleet.submit(_toks(10), kind="constrained")
    with pytest.raises(ValueError, match="CONSTRAINED knob"):
        fleet.submit(_toks(10), allowed_ids=[1, 2])


def test_fleet_kill_reprefills_mid_flight_beam(engine):
    fl = FleetRouter(engine, n_replicas=2, n_slots=4,
                     scheduler_kwargs={"page_len": 4, "n_pages": 32})
    fut = fl.submit(_toks(12, seed=21), max_new_tokens=8, kind="beam",
                    beam_width=3)
    for _ in range(3):
        fl.step()
    rid = next(rec.rid for rec in fl.outstanding.values())
    fl.kill_replica(rid)
    fl.run_until_idle()
    res = fut.result(timeout=30)
    assert res.kind == "beam" and res.reprefills == 1
    assert len(res.tokens) == 8 and np.isfinite(res.best_logprob)
    for rep in fl.replicas.values():
        if rep.status == "live":
            assert rep.scheduler.check_pages()
