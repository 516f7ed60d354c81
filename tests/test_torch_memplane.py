"""The port's memory and compile plane (``obs.memory``, the compile
sentinel's metrics on the engine and both nets) and the scheduler's
plane wiring (``dl4j_kv_*`` gauges, snapshots, the flight recorder, the
sampler observation, transparency), against the JAX package's on the CPU.

Tiny f32 model (vocab 61, d_model 32, 2 heads, 2 layers, max_seq 32),
weights drawn by the JAX package and shared through ``params_from_numpy``.
Wall-clock budgets stay out of this tier: the plane's 2% budget is held
on the card (``chip_smoke.py`` phase 14); here only that the self-timing
counters move.
"""

from __future__ import annotations

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.obs as jobs
import deeplearning4j_tpu_torch.obs as tobs
from deeplearning4j_tpu.obs import memory as jmem
from deeplearning4j_tpu.serving import (
    ContinuousBatchingScheduler as JSched, GenerationEngine as JEngine)
from deeplearning4j_tpu.zoo import transformer as jtfm
from deeplearning4j_tpu_torch.obs import memory as tmem
from deeplearning4j_tpu_torch.serving import (
    ContinuousBatchingScheduler, GenerationEngine, SLOConfig, SLOTracker)
from deeplearning4j_tpu_torch.serving import kvcache
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


def _toks(n, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, (n,)).astype(
        np.int32)


# ------------------------------------------------------------ census

def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((4, 8)).astype(np.float32),
            "b": [rng.integers(0, 9, (3,)).astype(np.int32), None],
            "c": (rng.standard_normal(5).astype(np.float16),)}


def test_tree_bytes_equals_the_reference():
    arr = _arrays()
    jt = jax.tree_util.tree_map(jnp.asarray, arr)
    tt = {"a": torch.as_tensor(arr["a"]),
          "b": [torch.as_tensor(arr["b"][0]), None],
          "c": (torch.as_tensor(arr["c"][0]),)}
    assert tmem.tree_bytes(tt) == jmem.tree_bytes(jt) == \
        4 * 8 * 4 + 3 * 4 + 5 * 2
    assert tmem.tree_bytes(None) == jmem.tree_bytes(None) == 0
    # bf16 (no numpy twin) and a module's state_dict
    assert tmem.tree_bytes(torch.zeros(3, 7, dtype=torch.bfloat16)) == 42
    lin = torch.nn.Linear(4, 3)
    assert tmem.tree_bytes(lin) == tmem.tree_bytes(lin.state_dict()) == \
        (4 * 3 + 3) * 4
    by = tmem.component_bytes({"params": tt, "kv_cache": torch.zeros(2)})
    assert by == jmem.component_bytes({"params": jt,
                                       "kv_cache": jnp.zeros((2,))})
    assert tmem.per_replica_bytes(tt) == {"0": by["params"]}


def test_census_vocabulary_is_the_reference():
    assert tmem.KNOWN_COMPONENTS == jmem.KNOWN_COMPONENTS
    with pytest.raises(ValueError) as terr:
        tmem.emit_census({"blorp": torch.zeros(2)})
    with pytest.raises(ValueError) as jerr:
        jmem.emit_census({"blorp": jnp.zeros((2,))})
    assert str(terr.value) == str(jerr.value)


def test_emit_census_gauges_and_cpu_degradation():
    treg, jreg = tobs.MetricsRegistry(), jobs.MetricsRegistry()
    t = tmem.emit_census({"params": torch.zeros(10, 10),
                          "optimizer": torch.zeros(10)},
                         replica="7", source="test", registry=treg)
    j = jmem.emit_census({"params": jnp.zeros((10, 10)),
                          "optimizer": jnp.zeros((10,))},
                         replica="7", source="test", registry=jreg)
    assert treg.to_prometheus() == jreg.to_prometheus()
    assert t["component_bytes"] == j["component_bytes"] == \
        {"params": 400, "optimizer": 40, "total": 440}
    assert tmem.device_memory_stats() is None
    assert t["device"] is None and t["device_source"] == "pytree"
    assert {k: v for k, v in t.items() if k not in ("ts", "device")} == \
        {k: v for k, v in j.items() if k not in ("ts", "device")}
    assert ("test", "7") in [(c["source"], c["replica"])
                             for c in tmem.latest_censuses()]
    split = tmem.emit_census({"params": torch.zeros(4)}, replica="5",
                             registry=treg, per_replica=True)
    assert split["per_replica_bytes"] == {"0": {"params": 16,
                                                "total": 16}}
    tmem.reset_censuses()
    assert tmem.latest_censuses() == []


# ---------------------------------------------------- compile sentinel

def test_engine_sentinels_feed_the_registry(engine):
    reg = tobs.get_registry()
    before = {n: reg.get("dl4j_compile_total").value(component=n)
              if reg.get("dl4j_compile_total") else 0.0
              for n in engine.sentinels}
    sched = ContinuousBatchingScheduler(engine, n_slots=2, page_len=4,
                                        n_pages=16)
    for seed in (1, 2):
        sched.submit(_toks(11, seed), max_new_tokens=4)
    sched.run_until_idle()
    engine.mark_warm()
    compiles = {n: s.compiles for n, s in engine.sentinels.items()}
    for seed in (3, 4):
        sched.submit(_toks(11, seed), max_new_tokens=4)
    sched.run_until_idle()
    rep = engine.compile_report()
    assert sum(r["retraces_after_warm"] for r in rep.values()) == 0
    assert {n: s.compiles for n, s in engine.sentinels.items()} == compiles
    total = reg.get("dl4j_compile_total")
    for n, s in engine.sentinels.items():
        assert total.value(component=n) - before[n] <= s.compiles
    assert total.value(component="decode_paged") > 0
    assert sum(s.overhead_seconds for s in engine.sentinels.values()) > 0
    # disarm: the module's other tests bring new caches (new signatures)
    for s in engine.sentinels.values():
        s.warm = False


def _mlp(m, t):
    return m.MultiLayerNetwork(
        m.NeuralNetConfiguration.builder().seed(1).updater(t.Adam(1e-3))
        .list().layer(m.DenseLayer(n_in=6, n_out=8, activation="relu"))
        .layer(m.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
        .build())


def _graph(m, t):
    return m.ComputationGraph(
        m.NeuralNetConfiguration.builder().seed(1).updater(t.Adam(1e-3))
        .graph_builder().add_inputs("in")
        .add_layer("h", m.DenseLayer(n_in=6, n_out=8, activation="relu"),
                   "in")
        .add_layer("out", m.OutputLayer(n_in=8, n_out=3), "h")
        .set_outputs("out").build())


def _ds(n=8, seed=0):
    from deeplearning4j_tpu_torch.data import DataSet
    rng = np.random.default_rng(seed)
    x = rng.random((n, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return DataSet(x, y)


@pytest.mark.parametrize("kind,name", [("mln", "mln_train_step"),
                                       ("cg", "cg_train_step")])
def test_net_train_step_sentinels(kind, name):
    import deeplearning4j_tpu_torch.nn as tnn
    import deeplearning4j_tpu_torch.train as ttrain
    net = (_mlp if kind == "mln" else _graph)(tnn, ttrain)
    net = net.init((6,) if kind == "mln" else [(6,)], device="cpu")
    reg = tobs.get_registry()
    net.fit(_ds())
    net.fit([_ds(seed=1), _ds(seed=2)])
    sent = net._train_sentinel()
    assert sent.name == name and sent.compiles == 1
    assert sent._fn is net._step_fn and sent.calls["direct"] == 3
    assert reg.get("dl4j_compile_total").value(component=name) >= 1
    sent.mark_warm()
    net.fit(_ds(seed=3))
    assert sent.retraces_after_warm == 0
    with pytest.warns(RuntimeWarning, match="retrace"):
        net.fit(_ds(n=5, seed=4))
    assert sent.retraces_after_warm == 1
    assert reg.get("dl4j_compile_retraces_total").value(
        component=name) >= 1
    if kind == "mln":
        net.fit_scanned([_ds(seed=5), _ds(seed=6)])
        assert net._train_sentinel() is sent and sent.calls["direct"] == 7
    # a new compiled step (a detector toggled) gets its own sentinel, and
    # the old step goes at once — sentinel and step form no cycle that
    # only a collection (perhaps one in the middle of a capture) frees
    net.enable_gradient_anomaly_detection()
    net.fit(_ds(seed=7))
    assert net._train_sentinel() is not sent and \
        net._train_sentinel().compiles == 1
    old = weakref.ref(net._step_fn)
    del sent
    gc.disable()
    try:
        net.enable_gradient_anomaly_detection(False)
        net.fit(_ds(seed=8))
        assert old() is None
    finally:
        gc.enable()


# ------------------------------------------------- scheduler wiring

@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_kv_gauges_snapshots_and_final_residency(engine, paged):
    reg = tobs.get_registry()
    kw = dict(page_len=4, n_pages=24) if paged else {}
    sched = ContinuousBatchingScheduler(engine, n_slots=2,
                                        replica=f"kv{paged}", **kw)
    h = reg.get("dl4j_kv_final_residency_ratio")
    base = h.count()
    futs = [sched.submit(_toks(4 + i, 60 + i), max_new_tokens=4)
            for i in range(4)]
    sched.run_until_idle()
    for f in futs:
        f.result(timeout=10)
    rep = sched.kv_report()
    r = f"kv{paged}"
    assert h.count() - base == 4
    assert reg.get("dl4j_kv_allocated_bytes").value(replica=r) == \
        rep["allocated_bytes"]
    assert reg.get("dl4j_kv_resident_bytes").value(replica=r) == \
        rep["resident_bytes_last"]
    snaps = sched.flight_recorder.snapshots()
    assert len(snaps) == rep["snapshots"] and snaps[-1]["step"] == \
        len(snaps)
    per_tok = kvcache.token_nbytes(sched.cache)
    for s in snaps:
        assert s["kv_resident_bytes"] % per_tok == 0
        assert set(s["request_kinds"]) <= {"generate"}
        assert s["kv_token_bytes"] == per_tok
    if paged:
        assert all("kv_mapped_pages" in s for s in snaps)
    sched.step()          # idle: occupancy and residency drain
    assert reg.get("dl4j_serving_slot_occupancy").value(replica=r) == 0.0
    assert reg.get("dl4j_kv_resident_bytes").value(replica=r) == 0.0
    assert reg.get("dl4j_kv_waste_ratio").value(replica=r) == \
        (0.0 if paged else 1.0)
    if not paged:
        assert rep["final_residency_mean"] == pytest.approx(
            np.mean([(4 + i + 4) / 32 for i in range(4)]))


def test_census_at_construction_and_dump_round_trip(engine, tmp_path):
    sched = ContinuousBatchingScheduler(engine, n_slots=2, replica="mr",
                                        page_len=4, n_pages=16)
    fut = sched.submit(_toks(5, 80), max_new_tokens=3)
    sched.run_until_idle()
    fut.result(timeout=10)
    census = next(c for c in tmem.latest_censuses()
                  if (c["source"], c["replica"]) == ("serving", "mr"))
    assert census["component_bytes"]["kv_cache"] == \
        kvcache.cache_nbytes(sched.cache)
    assert census["component_bytes"]["params"] == \
        tmem.tree_bytes(engine.params) > 0
    mine = [k for k in tmem.debug_state()["kv"] if k["replica"] == "mr"]
    assert mine and mine[0]["pool_bytes"] == \
        kvcache.cache_nbytes(sched.cache)
    path = sched.flight_recorder.dump(tmp_path / "bb.jsonl")
    recs = jobs.load_flight_records(path)       # the reference reads it
    assert {"flightrec", "memcensus", "snapshot", "reqtrace"} <= \
        {r["kind"] for r in recs}
    st = sched.flight_recorder.debug_state()
    assert st["replica"] == "mr" and st["kv"]["finished_requests"] == 1
    assert "compiles" in st and st["trace_overhead_seconds"] > 0


def test_fail_all_leaves_a_black_box(engine, tmp_path):
    dump = tmp_path / "crash.jsonl"
    sched = ContinuousBatchingScheduler(engine, n_slots=1, page_len=4,
                                        n_pages=16, crash_dump_path=dump)
    futs = [sched.submit(_toks(6, 90 + i), max_new_tokens=8)
            for i in range(2)]
    sched.step()
    sched._fail_all(RuntimeError("device lost"))
    for f in futs:
        with pytest.raises(RuntimeError, match="device lost"):
            f.result(timeout=1)
    recs = tobs.load_flight_records(dump)
    assert recs[0]["reason"] == "fail_all"
    crash = [r for r in recs if r["kind"] == "snapshot" and r.get("crash")]
    assert crash and "device lost" in crash[0]["error"]
    traces = [r for r in recs if r["kind"] == "reqtrace"]
    assert {t["summary"]["status"] for t in traces} == {"fail"}
    assert sched.check_pages() and sched.queue_depth() == 0


def test_plane_is_output_transparent(engine):
    """Greedy tokens with every part of the plane on (SLO, span trees, a
    sampler observation at every event) equal the plane's minimum and
    ``generate()``; the self-timing counters move."""
    prompts = [_toks(n, 200 + n) for n in (3, 6, 13)]

    def serve(**kw):
        sched = ContinuousBatchingScheduler(engine, n_slots=2, page_len=4,
                                            n_pages=24, **kw)
        futs = [sched.submit(p, max_new_tokens=5) for p in prompts]
        sched.run_until_idle()
        return sched, [f.result(10).tokens.tolist() for f in futs]
    full, got = serve(slo=SLOConfig(ttft_s=60.0, itl_s=60.0),
                      trace_spans=True, sample_obs_every=1)
    _, bare = serve(trace_spans=False, sample_obs_every=0)
    assert got == bare == [engine.generate(p, 5).tolist() for p in prompts]
    assert isinstance(full.slo, SLOTracker)
    assert full.slo.report()["window"]["requests"] == 3
    assert full.trace_overhead_seconds > 0
    assert all(full._plane_s[k] > 0 for k in
               ("registry", "trace", "spans", "sampler", "slo")), \
        full._plane_s


def test_sampler_observation_equals_the_reference_formula(model):
    """The port reduces the sampler observation with tensors (on the card,
    two floats come back); the reference's host numpy formula on the same
    logits gives the same entropy and top-k mass."""
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()

    def hists(reg):
        return {"sample_entropy": reg.histogram("dl4j_e", ""),
                "topk_mass": reg.histogram("dl4j_m", "")}
    jm, tm = hists(jreg), hists(treg)
    rng = np.random.default_rng(5)
    for rows, topks in ((rng.standard_normal((3, VOCAB)) * 4, [0, 5, 2]),
                        (rng.standard_normal((VOCAB,)), [7]),
                        (rng.standard_normal((2, VOCAB)) * 9, [0, 0]),
                        (rng.standard_normal((2, VOCAB)), [VOCAB + 3, 1])):
        lg = rows.astype(np.float32)
        JSched._sample_obs(jm, lg, topks)
        ContinuousBatchingScheduler._sample_obs(tm, torch.as_tensor(lg),
                                                topks)
    for k in ("sample_entropy", "topk_mass"):
        assert tm[k].count() == jm[k].count() > 0
        assert tm[k].sum() == pytest.approx(jm[k].sum(), abs=1e-4)


def test_scheduler_registers_the_reference_instruments(model, engine):
    """Every instrument the scheduler registers carries the reference
    scheduler's name, kind, help and label names."""
    jcfg, jp, _, _ = model
    ContinuousBatchingScheduler(engine, n_slots=1)
    JSched(JEngine(jcfg, jp), n_slots=1)
    treg, jreg = tobs.get_registry(), jobs.get_registry()
    mine = {n: treg.get(n) for n in treg.names()
            if n.startswith(("dl4j_serving_", "dl4j_kv_",
                             "dl4j_workload_"))}
    assert len(mine) == 30
    for n, inst in mine.items():
        ref = jreg.get(n)
        assert ref is not None, n
        assert (inst.kind, inst.help, inst.labelnames) == \
            (ref.kind, ref.help, ref.labelnames), n
        if inst.kind == "histogram":
            assert inst.buckets == ref.buckets, n
