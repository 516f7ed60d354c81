"""The port's quantization plane (``deeplearning4j_tpu_torch.serving.quant``:
int8 KV pages and int8 decode weights behind the fidelity gate) against
the JAX package's, on the CPU.

Every test of ``tests/test_quant.py``, ported to the port on a small f32
model (2 layers, d_model 64, 4 heads, vocab 61, max_seq 32,
``prefill_chunk=8``, page_len 4), weights drawn by the JAX package and
shared through ``params_from_numpy``. Added: ``quantize_rows`` and
``quantize_block_weights`` of the same numpy inputs give the JAX
package's int8 codes exactly and its scales within 1e-7 relative, and the
int8-pool decode logits hold ``kl_max`` <= 1e-5 against the JAX package's
int8-pool decode. The scheduler test that fails on the reference's own
tree (``test_scheduler_quant_kv_greedy_equivalence``: greedy tokens of
the int8 pool equal to the bf16 pool's) is held here, as the port's bar
is, against the JAX scheduler's int8 path: the same tokens, and by KL on
the engine's int8 decode. Every test has its own autotune stores.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import autotune as jat
from deeplearning4j_tpu.serving import (
    ContinuousBatchingScheduler as JSched, GenerationEngine as JEngine)
from deeplearning4j_tpu.serving import quant as jquant
from deeplearning4j_tpu.serving.kvcache import PageTable as JPageTable
from deeplearning4j_tpu.zoo import transformer as jtfm
from deeplearning4j_tpu_torch import obs as tobs
from deeplearning4j_tpu_torch.kernels import autotune as at
from deeplearning4j_tpu_torch.kernels.paged_attention import PROMOTION_MAX_KL
from deeplearning4j_tpu_torch.obs import compare_logits
from deeplearning4j_tpu_torch.serving import (
    ContinuousBatchingScheduler, GenerationEngine, PageTable,
    init_paged_cache, is_quantized, kvcache, quant, token_nbytes)
from deeplearning4j_tpu_torch.zoo import transformer as ttfm

torch.set_num_threads(2)

VOCAB = 61
SMALL = dict(vocab_size=VOCAB, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq=32, remat=False, attn_scores_bf16=False)
PARITY_KL = 1e-5     # int8-pool decode, port vs the JAX package


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


# ----------------------------------------------------- primitives

def test_quantize_rows_roundtrip_bound():
    rows = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 5, 4, 8)).astype(np.float32))
    q, s = quant.quantize_rows(rows)
    assert q.dtype == torch.int8 and q.shape == rows.shape
    assert s.dtype == torch.float32 and s.shape == rows.shape[:-1]
    back = quant.dequantize_rows(q, s)
    bound = s[..., None] * 0.5 + 1e-7
    assert bool(((back - rows).abs() <= bound).all())
    qz, sz = quant.quantize_rows(torch.zeros((2, 4, 8)))
    assert bool((qz == 0).all()) and bool(torch.isfinite(sz).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_codes_equal_the_jax_packages(dtype):
    """The same rows (f32, or rounded to bf16 first) quantize to the same
    int8 codes; the scales agree within 1e-7 relative."""
    rows = np.random.default_rng(1).standard_normal(
        (2, 7, 4, 16)).astype(np.float32) * 3.0
    rows[0, 0, 0] = 0.0                          # a zero row
    jrows = jnp.asarray(rows, getattr(jnp, dtype))
    trows = torch.from_numpy(rows).to(getattr(torch, dtype))
    jq, js = jquant.quantize_rows(jrows)
    tq, ts = quant.quantize_rows(trows)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7,
                               atol=0)
    np.testing.assert_array_equal(
        quant.dequantize_rows(tq, ts).numpy(),
        np.asarray(jquant.dequantize_rows(jq, js)))


def test_quantize_block_weights_layout_and_sharing(model):
    _, jp, _, tp = model
    qb = quant.quantize_block_weights(tp["blocks"])
    jqb = jquant.quantize_block_weights(jp["blocks"])
    for name in ("wqkv", "wo", "w_in", "w_out"):
        w = tp["blocks"][name].float()
        assert qb[name].dtype == torch.int8 and qb[name].shape == w.shape
        s = qb[name + "_scale"]
        assert s.shape == (w.shape[0], 1, w.shape[2])
        back = qb[name].float() * s
        assert float((back - w).abs().max()) <= float(s.max()) * 0.5 + 1e-7
        # the JAX package's codes exactly, its scales within 1e-7
        np.testing.assert_array_equal(qb[name].numpy(), np.asarray(jqb[name]))
        np.testing.assert_allclose(s.numpy(),
                                   np.asarray(jqb[name + "_scale"]),
                                   rtol=1e-7, atol=0)
    assert qb["ln1"] is tp["blocks"]["ln1"]
    qp = quant.quantized_params(tp)
    assert qp["embed"] is tp["embed"]
    assert qp["ln_f"] is tp["ln_f"]


# ------------------------------------------------- pool geometry

def test_quantized_pool_shapes_and_byte_accounting(model):
    jcfg, _, tcfg, _ = model
    cache = init_paged_cache(tcfg, n_slots=2, n_pages=8, page_len=4,
                             quantized=True, device="cpu")
    assert is_quantized(cache) and kvcache.is_paged(cache)
    assert cache["k"].dtype == torch.int8
    assert cache["k_scale"].shape == cache["k"].shape[:-1]
    assert cache["k_scale"].dtype == torch.float32
    expect = (2 * tcfg.n_layers * tcfg.d_model
              + 2 * tcfg.n_layers * tcfg.n_heads * 4)
    assert token_nbytes(cache) == expect
    jcache = jquant.kvcache.init_paged_cache(jcfg, 2, 8, 4, quantized=True)
    assert token_nbytes(cache) == jquant.kvcache.token_nbytes(jcache)
    assert kvcache.cache_nbytes(cache) == jquant.kvcache.cache_nbytes(jcache)
    base = init_paged_cache(tcfg, n_slots=2, n_pages=8, page_len=4,
                            device="cpu")
    assert not is_quantized(base)
    assert token_nbytes(cache) < token_nbytes(base)


def test_token_bytes_at_the_120m_lm():
    """The 120M LM (L8 H8 Dh64): 8704 bytes a token in int8 against
    16384 in bf16 (53%)."""
    cfg = ttfm.TransformerConfig(vocab_size=32000, d_model=512, n_heads=8,
                                 n_layers=8, d_ff=2048, max_seq=64,
                                 dtype=torch.bfloat16, remat=False)
    got = {q: token_nbytes(init_paged_cache(cfg, 1, 1, 16, quantized=q,
                                            device="cpu"))
           for q in (False, True)}
    assert got == {False: 16384, True: 8704}


# ------------------------------------------------ decode oracles

def _paged_greedy(eng, prompt, n, quantized, table_cls=PageTable):
    """Greedy decode of one request over a private paged pool; the
    tokens and every decode step's logits."""
    per_slot = -(-eng.max_len // 4)
    cache = eng.init_paged_cache(1, per_slot, 4, quantized=quantized)
    assert is_quantized(cache) == quantized
    pt = table_cls.for_cache(cache)
    assert pt.map(0, len(prompt) + n - 1)
    cache = pt.sync(cache)
    logits = None
    for s in range(0, len(prompt), eng.chunk_len):
        logits, cache = eng.prefill_chunk(cache, prompt[s:s + eng.chunk_len],
                                          0, s)
    out = [int(np.argmax(np.asarray(logits, np.float32)))]
    steps = []
    while len(out) < n:
        logits, cache = eng.decode_step(cache,
                                        np.asarray([out[-1]], np.int32))
        steps.append(np.asarray(logits, np.float32)[0])
        out.append(int(np.argmax(steps[-1])))
    return out, np.stack(steps)


def test_quantized_paged_decode_matches_generate(engine):
    prompt = _toks((12,))
    want = [int(t) for t in engine.generate(prompt, 16)]
    assert _paged_greedy(engine, prompt, 16, quantized=False)[0] == want
    assert _paged_greedy(engine, prompt, 16, quantized=True)[0] == want


def test_int8_pool_decode_logits_match_the_jax_packages(engine, jengine):
    """The int8 pool's decode logits, step by step, against the JAX
    package's int8 pool on the same prompt: kl_max <= 1e-5, the same
    greedy tokens."""
    prompt = _toks((12,), seed=11)
    toks, got = _paged_greedy(engine, prompt, 12, quantized=True)
    jtoks, want = _paged_greedy(jengine, prompt, 12, quantized=True,
                                table_cls=JPageTable)
    assert toks == jtoks
    rep = compare_logits(want, got)
    assert rep["kl_max"] <= PARITY_KL, rep


def test_quantized_weight_decode_argmax_matches(engine):
    """int8 weights dequantized a layer at a time: logits close, the
    greedy choice identical."""
    from deeplearning4j_tpu_torch.nn._compiled import Bound
    cache_a, cache_b = engine.init_cache(1), engine.init_cache(1)
    prompt = _toks((1, 10), seed=3)
    engine.prefill(cache_a, prompt)
    engine.prefill(cache_b, prompt)
    engine._quantized_weights()
    toks = torch.from_numpy(_toks((1,), seed=4).astype(np.int64))
    ref = engine._decode(Bound(cache_a), toks, "bf16")
    got = engine._decode(Bound(cache_b), toks, "int8")
    assert float((ref - got).abs().max()) < 0.1
    assert ref.argmax(-1).tolist() == got.argmax(-1).tolist()


def test_quantized_weight_decode_equals_the_jax_packages(model, engine,
                                                         jengine):
    """The same int8 block stack through both decode bodies (dense pool):
    logits within 1e-5."""
    from deeplearning4j_tpu_torch.nn._compiled import Bound
    _, jp, _, _ = model
    prompt = _toks((1, 10), seed=3)
    cache = engine.init_cache(1)
    engine.prefill(cache, prompt)
    jcache = jengine.init_cache(1)
    _, jcache = jengine.prefill(jcache, prompt)
    engine._quantized_weights()
    tok = _toks((1,), seed=4)
    got = engine._decode(Bound(cache), torch.from_numpy(
        tok.astype(np.int64)), "int8")
    want, _ = jengine._decode(jquant.quantized_params(jp), jcache,
                              jnp.asarray(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_copy_page_carries_scales(model, engine):
    _, _, tcfg, _ = model
    cache = engine.init_paged_cache(2, 6, 4, quantized=True)
    rows = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (tcfg.n_layers, 4, tcfg.n_heads, tcfg.head_dim)).astype(np.float32))
    q, s = quant.quantize_rows(rows)
    for name, val in (("k", q), ("k_scale", s), ("v", q), ("v_scale", s)):
        cache[name][:, 1] = val
    cache = engine.copy_page(cache, 1, 4)
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(cache[name][:, 4], cache[name][:, 1])


def test_kernel_refuses_an_int8_pool(engine):
    """K2 reads compute-dtype pages: its entry point refuses an int8
    pool, and ``decode_step`` routes one to the gather-dequant body."""
    from deeplearning4j_tpu_torch.nn._compiled import Bound
    cache = engine.init_paged_cache(1, 8, 4, quantized=True)
    toks = torch.zeros((1,), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="int8 pool"):
        engine._decode_paged_kernel(Bound(cache), toks, "bf16")
    assert engine._paged_entry(cache) is engine._decode_paged


# -------------------------------------------- scheduler integration

def _quant_wave(engine, sched_cls, mode):
    prompts = [_toks((14,), seed=7), _toks((9,), seed=8)]
    prompts.append(np.concatenate([prompts[0][:8], _toks((4,), seed=9)]))
    sched = sched_cls(engine, n_slots=2, page_len=4, n_pages=16,
                      prefix_cache=True, quant_kv=mode)
    futs = [sched.submit(p, max_new_tokens=6) for p in prompts]
    sched.run_until_idle()
    return sched, [f.result(timeout=600).tokens.tolist() for f in futs]


@pytest.mark.parametrize("mode", ["off", "on"])
def test_scheduler_quant_kv_equals_the_jax_scheduler(engine, jengine, mode):
    """A scheduler over an int8 pool (prefix sharing on: scales ride
    shared pages and CoW splits) serves the JAX scheduler's tokens on its
    int8 pool (``on``), as the bf16 pool serves its bf16 pool's
    (``off``); the page invariants hold and ``kv_report`` names the
    dtype."""
    sched, got = _quant_wave(engine, ContinuousBatchingScheduler, mode)
    jsched, want = _quant_wave(jengine, JSched, mode)
    assert is_quantized(sched.cache) == (mode == "on")
    assert got == want
    assert sched.check_pages()
    assert sched.kv_report()["kv_dtype"] == jsched.kv_report()["kv_dtype"] \
        == ("int8" if mode == "on" else "float32")
    assert sched.kv_report()["token_bytes"] == \
        jsched.kv_report()["token_bytes"]


def test_scheduler_quant_kv_requires_paged_pool(engine):
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatchingScheduler(engine, n_slots=2, quant_kv="on")


# ------------------------------------------------ promotion races

def test_race_kv_verdict_record_counter(engine, jengine):
    reg = tobs.get_registry()
    reg.reset()
    res = quant.race_kv(engine, 2, 10, 4)
    assert res["fidelity"]["kl_max"] <= PROMOTION_MAX_KL == 1e-3
    assert res["verdict"] in ("promoted", "fallback_slower")
    assert res["bf16_s"] > 0 and res["int8_s"] > 0
    bpt = res["bytes_per_token"]
    assert bpt["int8"] < bpt["bf16"]
    # on the CPU the engine's bf16 dispatch is the gather body
    assert res["arms"] == {"bf16": "decode_paged", "int8": "decode_paged"}
    key = quant.kv_bucket_key(engine.cfg, 2, 10, 4, "cpu")
    assert res["key"] == key
    rec = at.lookup(key, sha=quant.quant_sha())
    assert rec is not None and rec["choice"][0] in ("int8", "bf16")
    assert reg.get("dl4j_autotune_promotions_total").value(
        kernel="quant_kv", verdict=res["verdict"]) == 1
    # the JAX race on the same probe content measures the same fidelity
    jres = jquant.race_kv(jengine, 2, 10, 4)
    assert jres["key"] == key and jres["bytes_per_token"] == bpt
    assert abs(jres["fidelity"]["kl_max"]
               - res["fidelity"]["kl_max"]) <= 1e-6


def test_race_weights_verdict_record_counter(engine, jengine):
    reg = tobs.get_registry()
    reg.reset()
    res = quant.race_weights(engine)
    assert res["fidelity"]["kl_max"] <= PROMOTION_MAX_KL
    assert res["verdict"] in ("promoted", "fallback_slower")
    rec = at.lookup(quant.w_bucket_key(engine.cfg, "cpu"),
                    sha=quant.quant_sha())
    assert rec is not None
    assert reg.get("dl4j_autotune_promotions_total").value(
        kernel="quant_w", verdict=res["verdict"]) == 1
    jres = jquant.race_weights(jengine)
    assert abs(jres["fidelity"]["kl_max"]
               - res["fidelity"]["kl_max"]) <= 1e-6


def test_decide_mode_ladder(engine, monkeypatch):
    reg = tobs.get_registry()
    reg.reset()
    assert quant.decide_kv(engine, 2, 10, 4, mode="off") == "bf16"
    assert quant.decide_kv(engine, 2, 10, 4, mode="int8") == "int8"
    assert quant.decide_weights(engine, mode="bf16") == "bf16"
    assert quant.decide_weights(engine, mode="on") == "int8"
    # auto: bf16 on every device, no race
    assert quant.decide_kv(engine, 2, 10, 4, mode="auto") == "bf16"
    assert at.lookup(quant.kv_bucket_key(engine.cfg, 2, 10, 4, "cpu")) \
        is None
    monkeypatch.setattr(engine, "quant_kv_mode", None)
    monkeypatch.setenv("DL4J_QUANT_KV", "int8")
    assert quant.decide_kv(engine, 2, 10, 4) == "int8"
    choice = quant.decide_kv(engine, 2, 10, 4, mode="race")
    assert sum(reg.get("dl4j_autotune_promotions_total").value(
        kernel="quant_kv", verdict=v)
        for v in ("promoted", "fallback_slower", "fallback_fidelity")) == 1
    assert quant.decide_kv(engine, 2, 10, 4, mode="race") == choice
    assert sum(reg.get("dl4j_autotune_promotions_total").value(
        kernel="quant_kv", verdict=v)
        for v in ("promoted", "fallback_slower", "fallback_fidelity")) == 1
    assert reg.get("dl4j_quant_pool_total").value(
        kernel="quant_kv", mode="bf16") >= 2
    with pytest.raises(ValueError, match="quant_kv"):
        quant.decide_kv(engine, 2, 10, 4, mode="bogus")


def test_engine_pinned_quant_modes(model):
    """Engine-constructor pinning flows through ``init_paged_cache``'s
    ``quantized=None`` and the decode weight set; ``refresh`` re-quantizes
    the int8 stack in place."""
    _, _, tcfg, tp = model
    eng = GenerationEngine(tcfg, tp, device="cpu", prefill_chunk=8,
                           quant_kv="on", quant_weights="on")
    assert is_quantized(eng.init_paged_cache(1, 4, 4))
    assert eng._decode_params() == "int8"
    stack = eng._qrun["blocks"]["wqkv"]
    before = stack.clone()
    eng.refresh({**tp, "blocks": {**tp["blocks"],
                                  "wqkv": tp["blocks"]["wqkv"] * 2}})
    assert eng._qrun["blocks"]["wqkv"] is stack          # in place
    assert torch.equal(stack, before)                    # codes: x2 scale
    assert torch.allclose(eng._qrun["blocks"]["wqkv_scale"],
                          2 * quant.quantize_block_weights(tp["blocks"])[
                              "wqkv_scale"])
    eng_off = GenerationEngine(tcfg, tp, device="cpu", prefill_chunk=8,
                               quant_kv="off")
    assert not is_quantized(eng_off.init_paged_cache(1, 4, 4))
    assert eng_off._decode_params() == "bf16"
