"""The port's scheduler against the JAX package's on the observability
plane, on the CPU: the same greedy workload — with a prefix hit, page
pressure that preempts, and SCORE and BEAM requests beside GENERATE —
through both schedulers gives equal counter deltas, equal histogram
counts, equal end-of-run gauges and equal per-request traces (events and
summaries, timestamps aside), and the same tokens.

Tiny f32 model (vocab 61, d_model 32, 2 heads, 2 layers, max_seq 32,
``prefill_chunk=8``), weights drawn by the JAX package and shared through
``params_from_numpy``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.obs as jobs
import deeplearning4j_tpu_torch.obs as tobs
from deeplearning4j_tpu.serving import (
    ContinuousBatchingScheduler as JSched, GenerationEngine as JEngine)
from deeplearning4j_tpu.zoo import transformer as jtfm
from deeplearning4j_tpu_torch.serving import (ContinuousBatchingScheduler,
                                              GenerationEngine, SLOConfig)
from deeplearning4j_tpu_torch.zoo import transformer as ttfm

torch.set_num_threads(2)

VOCAB = 61
TINY = dict(vocab_size=VOCAB, d_model=32, n_heads=2, n_layers=2, d_ff=64,
            max_seq=32, remat=False, attn_scores_bf16=False)
SAMPLE_EVERY = 3


@pytest.fixture(scope="module")
def engines():
    jcfg = jtfm.TransformerConfig(dtype=jnp.float32, **TINY)
    tcfg = ttfm.TransformerConfig(dtype=torch.float32, **TINY)
    jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = ttfm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                tcfg, device="cpu")
    return (GenerationEngine(tcfg, tp, device="cpu", prefill_chunk=8),
            JEngine(jcfg, jp, prefill_chunk=8))


def _requests():
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, VOCAB, 12).astype(np.int32)

    def tail(n):
        return np.concatenate([prefix, rng.integers(0, VOCAB, n)
                               .astype(np.int32)])
    return [((tail(3),), dict(max_new_tokens=10)),
            ((tail(5),), dict(max_new_tokens=12)),
            ((tail(2),), dict(max_new_tokens=9, top_k=5)),
            ((rng.integers(0, VOCAB, 9).astype(np.int32),),
             dict(kind="score")),
            ((tail(1),), dict(max_new_tokens=6, kind="beam",
                              beam_width=2)),
            ((tail(4),), dict(max_new_tokens=11))]


def _serve(engine, cls, obs, replica):
    reg = obs.get_registry()
    sched = cls(engine, n_slots=3, page_len=4, n_pages=9,
                prefix_cache=True, replica=replica,
                slo=obs.SLOConfig(ttft_s=60.0, itl_s=60.0),
                sample_obs_every=SAMPLE_EVERY)
    before = reg.snapshot()
    futs = []
    for i, (a, k) in enumerate(_requests()):
        futs.append(sched.submit(*a, **k))
        if i == 0:                  # the leader's pages become the prefix
            sched.run_until_idle()
    sched.run_until_idle()
    sched.step()                    # one idle step
    after = reg.snapshot()
    return sched, [f.result(timeout=30) for f in futs], before, after


def _delta(before, after, name):
    """What moved: each label set's counter (or histogram count) change,
    those that did not move left out (a label set another test of the
    same process registered moves by 0 here)."""
    if name not in after:
        return None
    b = before.get(name, {})
    out = {}
    for key, v in after[name].items():
        if isinstance(v, dict):                  # a histogram
            out[key] = v["count"] - b.get(key, {}).get("count", 0)
        else:
            out[key] = v - b.get(key, 0.0)
    return {k: v for k, v in out.items() if v}


def _tokens(res):
    if hasattr(res, "sequences"):
        return [s.tolist() for s in res.sequences]
    if hasattr(res, "logprobs"):
        return len(res.logprobs)
    return res.tokens.tolist()


def test_counter_deltas_and_histogram_counts_equal(engines):
    eng, jeng = engines
    t, tres, tb, ta = _serve(eng, ContinuousBatchingScheduler, tobs, "par")
    j, jres, jb, ja = _serve(jeng, JSched, jobs, "par")
    assert [_tokens(r) for r in tres] == [_tokens(r) for r in jres]
    counters = [n for n in ta if n.endswith("_total") and n.startswith(
        ("dl4j_serving_", "dl4j_workload_", "dl4j_kv_"))]
    hists = [n for n in ta if n in (
        "dl4j_serving_ttft_seconds", "dl4j_serving_queue_wait_seconds",
        "dl4j_serving_decode_step_seconds", "dl4j_serving_itl_seconds",
        "dl4j_serving_request_latency_seconds",
        "dl4j_kv_final_residency_ratio", "dl4j_serving_sample_entropy",
        "dl4j_serving_topk_mass")]
    assert len(counters) == 13 and len(hists) == 8
    for name in counters + hists:
        assert _delta(tb, ta, name) == _delta(jb, ja, name), name
    got = {n: _delta(tb, ta, n) for n in counters}
    # the workload exercised what it is for
    assert got["dl4j_serving_preemptions_total"][""] > 0
    assert got["dl4j_kv_prefix_hits_total"][""] > 0
    assert got["dl4j_serving_requests_total"][""] == 6
    assert got["dl4j_workload_requests_total"] == {
        "generate": 4, "score": 1, "beam": 1}
    assert _delta(tb, ta, "dl4j_serving_topk_mass")[""] > 0
    n_ev = _delta(tb, ta, "dl4j_serving_sample_entropy")[""]
    assert n_ev == (t._obs_events // SAMPLE_EVERY) == \
        (j._obs_events // SAMPLE_EVERY) > 0
    for name in ("dl4j_serving_ttft_seconds",):
        assert _delta(tb, ta, name)[""] == 6
    # per-replica gauges at the end of the run
    for name in ("dl4j_kv_allocated_bytes", "dl4j_kv_resident_bytes",
                 "dl4j_kv_waste_ratio", "dl4j_kv_shared_pages",
                 "dl4j_kv_cached_pages", "dl4j_serving_queue_depth",
                 "dl4j_serving_slot_occupancy",
                 "dl4j_serving_active_requests", "dl4j_slo_window_requests",
                 "dl4j_slo_goodput_ratio"):
        mine = {k: v for k, v in ta[name].items() if "par" in k.split(",")}
        theirs = {k: v for k, v in ja[name].items()
                  if "par" in k.split(",")}
        assert mine == theirs and mine, name
    assert t.kv_report() == j.kv_report()


def test_traces_and_snapshots_equal(engines):
    eng, jeng = engines
    t, *_ = _serve(eng, ContinuousBatchingScheduler, tobs, "tr")
    j, *_ = _serve(jeng, JSched, jobs, "tr")

    def events(sched):
        return {tr.request_id: [(n, {k: v for k, v in a.items()
                                     if k != "time_s"})
                                for n, _, a in tr.events]
                for tr in sched.flight_recorder.requests()}

    def summaries(sched):
        return {tr.request_id: {k: v for k, v in tr.summary().items()
                                if k not in ("ttft_s", "latency_s",
                                             "itl_s")}
                for tr in sched.flight_recorder.requests()}
    assert events(t) == events(j)
    assert summaries(t) == summaries(j)
    ignore = ("ts",)
    snaps_t = [{k: v for k, v in s.items() if k not in ignore}
               for s in t.flight_recorder.snapshots()]
    snaps_j = [{k: v for k, v in s.items() if k not in ignore}
               for s in j.flight_recorder.snapshots()]
    assert snaps_t == snaps_j
    rep_t, rep_j = t.slo.report(), j.slo.report()
    assert rep_t["window"]["requests"] == rep_j["window"]["requests"] == 6
    assert rep_t["goodput"] == rep_j["goodput"] == 1.0
    assert rep_t["by_kind"] == rep_j["by_kind"]
