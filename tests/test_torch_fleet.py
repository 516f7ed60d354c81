"""The port's fleet fabric (``deeplearning4j_tpu_torch.serving.fleet`` and
``traffic``) on the CPU: every test of ``tests/test_fleet_fast.py``, and
the port held against the JAX package on the same inputs.

The model is the reference suite's tiny f32 LM (vocab 61, d_model 32, 2
heads, 2 layers, max_seq 32), weights drawn by the JAX package and shared
through ``params_from_numpy``. Bars: fleet frames packed by either package
are byte-identical and unpack in the other; the request lease tables give
the same grants under one seeded failure schedule; ``poisson_arrivals``
is equal draw for draw; a fleet with a replica killed mid-decode gives
GENERATE, CONSTRAINED and BEAM tokens identical to the JAX package's, and
SCORE, EMBED and BEAM log-probs within 1e-5; ``scripts/slo_report.py
--fleet`` reads the port's dump. A dead or retired replica frees its
pool. The burst episode sizes its trace from a service rate it measures
first, so that it holds on a loaded host. Every blocking wait is bounded.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import pathlib
import threading
import time
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.parallel import leases as jleases
from deeplearning4j_tpu.parallel import transport as jtransport
from deeplearning4j_tpu.serving import FleetRouter as JFleetRouter
from deeplearning4j_tpu.serving import GenerationEngine as JEngine
from deeplearning4j_tpu.serving import TrafficConfig as JTrafficConfig
from deeplearning4j_tpu.serving import poisson_arrivals as jpoisson
from deeplearning4j_tpu.zoo import transformer as jtfm
from deeplearning4j_tpu_torch.parallel.leases import RequestLeaseTable
from deeplearning4j_tpu_torch.parallel.transport import (pack_fleet_result,
                                                         pack_fleet_submit,
                                                         unpack_fleet_result,
                                                         unpack_fleet_submit)
from deeplearning4j_tpu_torch.serving import (Autoscaler, AutoscalerConfig,
                                              ContinuousBatchingScheduler,
                                              FleetRouter, GenerationEngine,
                                              SLOConfig, TrafficConfig,
                                              poisson_arrivals, run_episode)
from deeplearning4j_tpu_torch.zoo import transformer as ttfm

torch.set_num_threads(2)

WAIT_S = 30.0       # per-future guard: generous against tiny-model work,
#                     tiny against a hang
PARITY = 1e-5
VOCAB = 61
TINY = dict(vocab_size=VOCAB, d_model=32, n_heads=2, n_layers=2, d_ff=64,
            max_seq=32, remat=False, attn_scores_bf16=False)
REPO = pathlib.Path(__file__).resolve().parent.parent


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
    eng = GenerationEngine(tcfg, tp, device="cpu")
    eng.generate(np.arange(1, 9, dtype=np.int32), 4)
    return eng


@pytest.fixture(scope="module")
def jengine(model):
    jcfg, jp, _, _ = model
    return JEngine(jcfg, jp)


def _prompts(n, seed=0, lo=4, hi=12):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, size=int(rng.integers(lo, hi + 1)))
            .astype(np.int32) for _ in range(n)]


def _oracle(engine, prompt, n):
    return np.asarray(engine.generate(prompt, n)).reshape(-1)


def _weak_pool(router, rid):
    """Weak references to every tensor of replica ``rid``'s KV pool."""
    cache = router.replicas[rid].scheduler.cache
    return [weakref.ref(t) for t in cache.values()
            if isinstance(t, torch.Tensor)]


# ----------------------------------------------------- lease table

def test_request_lease_exactly_once():
    lt = RequestLeaseTable()
    a, b = lt.add(), lt.add()
    assert lt.lease(a, 0) and lt.lease(b, 0)
    assert not lt.lease(a, 1)           # already leased
    assert lt.complete(0, a)
    assert not lt.complete(0, a)        # double completion ignored
    # replica 0 dies holding b; re-lease to 1; 0's ghost DONE is dropped
    released = lt.release_replica(0)
    assert released == [b]
    assert lt.lease(b, 1)
    assert not lt.complete(0, b)        # ghost from the dead replica
    assert lt.complete(1, b)
    assert lt.all_done()
    assert lt.counts()["reassigned"] == 1


def test_request_lease_ghost_done_before_regrant():
    lt = RequestLeaseTable()
    a = lt.add()
    assert lt.lease(a, 0)
    assert lt.release_replica(0) == [a]
    assert lt.complete(0, a)
    assert lt.all_done()
    assert not lt.lease(a, 1)           # done items never re-lease


def test_request_lease_tables_match_reference_under_failures():
    """One seeded schedule of add / lease / complete / replica deaths
    through both packages' tables: every answer and count equal."""
    rng = np.random.default_rng(3)
    ours, ref = RequestLeaseTable(), jleases.RequestLeaseTable()
    items = []
    for _ in range(400):
        op = rng.integers(0, 5)
        rep = int(rng.integers(0, 3))
        if op == 0 or not items:
            a, b = ours.add(), ref.add()
            assert a == b
            items.append(a)
        elif op == 1:
            it = int(rng.choice(items))
            assert ours.lease(it, rep) == ref.lease(it, rep)
        elif op == 2:
            it = int(rng.choice(items))
            assert ours.complete(rep, it) == ref.complete(rep, it)
        elif op == 3:
            assert ours.release_replica(rep) == ref.release_replica(rep)
        else:
            it = int(rng.choice(items))
            assert ours.owner_of(it) == ref.owner_of(it)
        assert ours.counts() == ref.counts()
    assert ours.all_done() == ref.all_done()


# ----------------------------------------------------- wire frames

def test_fleet_frames_round_trip():
    prompt = np.array([3, 1, 4, 1, 5, 9], np.int32)
    payload = pack_fleet_submit(7, prompt, 16, temperature=0.5, top_k=3,
                                eos_id=2, session_id="chat-42")
    sub = unpack_fleet_submit(payload)
    assert sub["item"] == 7 and sub["max_new_tokens"] == 16
    assert sub["temperature"] == pytest.approx(0.5)
    assert sub["top_k"] == 3 and sub["eos_id"] == 2
    assert sub["session_id"] == "chat-42"
    np.testing.assert_array_equal(sub["prompt_ids"], prompt)
    sub = unpack_fleet_submit(pack_fleet_submit(0, prompt, 4))
    assert sub["top_k"] is None and sub["eos_id"] is None
    assert sub["session_id"] is None
    out = unpack_fleet_result(pack_fleet_result(
        7, np.array([8, 6, 7], np.int32), "eos"))
    assert out["item"] == 7 and out["reason"] == "eos"
    np.testing.assert_array_equal(out["token_ids"],
                                  np.array([8, 6, 7], np.int32))


@pytest.mark.parametrize("case", range(4))
def test_fleet_frames_byte_identical_to_reference(case):
    """Either package packs the same bytes, and each unpacks the other's."""
    rng = np.random.default_rng(case)
    prompt = rng.integers(0, 32000, size=int(rng.integers(1, 40)))
    kw = [dict(),
          dict(temperature=0.7, top_k=5, eos_id=3, session_id="sé-1"),
          dict(kind=3, beam_width=4),
          dict(kind=4, allowed_ids=[1, 5, 9], pooling=1)][case]
    ours = pack_fleet_submit(case, prompt, 12, **kw)
    ref = jtransport.pack_fleet_submit(case, prompt, 12, **kw)
    assert ours == ref
    a, b = unpack_fleet_submit(ref), jtransport.unpack_fleet_submit(ours)
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k
    floats = [None, rng.standard_normal(7), [1.5], rng.standard_normal(32)][
        case]
    toks = rng.integers(0, 32000, size=case * 3)
    ours = pack_fleet_result(case, toks, ("eos", "length", "complete",
                                          "stop")[case], kind=case,
                             floats=floats)
    ref = jtransport.pack_fleet_result(case, toks, ("eos", "length",
                                                    "complete",
                                                    "stop")[case],
                                       kind=case, floats=floats)
    assert ours == ref
    a, b = unpack_fleet_result(ref), jtransport.unpack_fleet_result(ours)
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


# -------------------------------------------------- scheduler drain

def test_scheduler_drain_finishes_inflight_returns_queued(engine):
    sched = ContinuousBatchingScheduler(engine, n_slots=2)
    prompts = _prompts(5, seed=3)
    futs = [sched.submit(p, 6) for p in prompts]
    sched.step()                        # 2 admitted, 3 queued
    leftover = sched.drain()
    done = [f for f in futs if f.done()]
    assert len(done) == 2
    for p, f in zip(prompts, futs):
        if f.done():
            np.testing.assert_array_equal(
                f.result(timeout=WAIT_S).tokens, _oracle(engine, p, 6))
    assert len(leftover) == 3
    assert all(not r.future.done() for r in leftover)
    with pytest.raises(RuntimeError):
        sched._draining = True
        try:
            sched.submit(prompts[0], 2)
        finally:
            sched._draining = False
    assert sched.submit(prompts[0], 2) is not None
    sched.run_until_idle()


# ------------------------------------------------------ fault matrix

def test_kill_replica_mid_decode_bit_identical(engine):
    router = FleetRouter(engine, n_replicas=2, n_slots=2)
    prompts = _prompts(6, seed=1)
    futs = [router.submit(p, 8) for p in prompts]
    for _ in range(3):                  # get requests mid-decode
        router.step()
    held = {}
    for rec in router.outstanding.values():
        held[rec.rid] = held.get(rec.rid, 0) + 1
    victim = max(held, key=lambda rid: held[rid])
    pool = _weak_pool(router, victim)
    moved = router.kill_replica(victim)
    assert moved, "victim replica held no leases — test setup broken"
    gc.collect()
    # the dead replica's pool is freed; its recorder stays for dump()
    assert all(r() is None for r in pool)
    assert router.replicas[victim].scheduler.flight_recorder is not None
    router.run_until_idle()
    for p, f in zip(prompts, futs):
        res = f.result(timeout=WAIT_S)
        np.testing.assert_array_equal(res.tokens, _oracle(engine, p, 8))
    assert router.leases.all_done()
    counts = router.leases.counts()
    assert counts["done"] == len(prompts)
    assert counts["reassigned"] == len(moved)
    assert router.reprefills == len(moved)
    moved_results = [f.result(timeout=WAIT_S) for f in futs]
    assert sum(r.reprefills for r in moved_results) == len(moved)
    with pytest.raises(RuntimeError, match="released"):
        router.replicas[victim].scheduler.step()


def test_kill_last_replica_fails_futures_never_hangs(engine):
    router = FleetRouter(engine, n_replicas=1, n_slots=2)
    futs = [router.submit(p, 8) for p in _prompts(3, seed=2)]
    router.step()
    router.kill_replica(0)
    for f in futs:
        with pytest.raises(RuntimeError, match="no live replicas"):
            f.result(timeout=WAIT_S)


def test_kill_under_traffic_episode(engine):
    router = FleetRouter(engine, n_replicas=2, n_slots=2)
    tc = TrafficConfig(rate_rps=60.0, duration_s=0.8, prompt_lens=(4, 8),
                       max_new_tokens=(4, 8), vocab=VOCAB, seed=4)
    rep = run_episode(router, tc, kill_at_s=0.2, max_wall_s=60)
    assert rep.killed_rid is not None
    assert rep.submitted > 0
    assert rep.completed == rep.submitted and rep.failed == 0
    assert router.leases.all_done()
    assert router.reprefills > 0
    arrivals = poisson_arrivals(tc)
    for a, f in zip(arrivals, rep.futures):
        np.testing.assert_array_equal(
            f.result(timeout=WAIT_S).tokens,
            _oracle(engine, a.prompt, a.max_new_tokens))


# --------------------------------------------------------- affinity

def test_session_affinity_hit_and_miss(engine):
    router = FleetRouter(engine, n_replicas=3, n_slots=2)
    p = _prompts(1, seed=5)[0]
    f1 = router.submit(p, 4, session_id="alice")
    rid = router.outstanding[max(router.outstanding)].rid
    router.run_until_idle()
    f2 = router.submit(p, 4, session_id="alice")
    rec = router.outstanding[max(router.outstanding)]
    assert rec.rid == rid and rec.routed_reason == "affinity"
    router.run_until_idle()
    router.kill_replica(rid)
    router.submit(p, 4, session_id="alice")
    rec = router.outstanding[max(router.outstanding)]
    assert rec.rid != rid
    router.run_until_idle()
    for f in (f1, f2):
        assert f.result(timeout=WAIT_S).finish_reason in ("eos", "length")


def test_prefix_affinity_and_least_burn_fallback(engine):
    router = FleetRouter(engine, n_replicas=2, n_slots=2,
                         affinity_prefix_len=8)
    shared = np.arange(1, 13, dtype=np.int32)
    f1 = router.submit(shared, 4)
    first = router.outstanding[max(router.outstanding)]
    assert first.routed_reason == "least_burn"
    f2 = router.submit(np.concatenate([shared[:8], np.array([7, 9],
                                                            np.int32)]), 4)
    rec = router.outstanding[max(router.outstanding)]
    assert rec.routed_reason == "affinity" and rec.rid == first.rid
    f3 = router.submit(np.arange(40, 52, dtype=np.int32), 4)
    assert router.outstanding[max(router.outstanding)].routed_reason \
        == "least_burn"
    router.run_until_idle()
    for f in (f1, f2, f3):
        assert f.result(timeout=WAIT_S).finish_reason in ("eos", "length")


# ------------------------------------------------------- autoscaler

def test_autoscaler_synthetic_burn_up_down():
    asc = Autoscaler(AutoscalerConfig(min_replicas=1, max_replicas=3,
                                      high_burn=1.0, low_burn=0.5,
                                      patience=2, cooldown=1))
    assert asc.evaluate(5.0, 0.0, 1) == 0
    assert asc.evaluate(5.0, 0.0, 1) == 1
    assert asc.evaluate(5.0, 0.0, 2) == 0
    assert asc.evaluate(0.0, 0.0, 2) == 0
    assert asc.evaluate(5.0, 0.0, 2) == 0
    assert asc.evaluate(0.0, 0.0, 2) == 0
    assert asc.evaluate(0.0, 0.0, 2) == -1
    assert asc.evaluate(0.0, 0.0, 1) == 0
    assert asc.evaluate(0.0, 0.0, 1) == 0
    assert asc.evaluate(0.0, 0.0, 1) == 0
    assert asc.evaluate(None, 10.0, 1) == 0
    assert asc.evaluate(None, 10.0, 1) == 1
    assert asc.events == ["up", "down", "up"]
    asc2 = Autoscaler(AutoscalerConfig(max_replicas=2, patience=1,
                                       cooldown=0))
    assert asc2.evaluate(9.0, 0.0, 2) == 0


def test_autoscaler_config_validation():
    with pytest.raises(ValueError):
        AutoscalerConfig(min_replicas=3, max_replicas=2)
    with pytest.raises(ValueError):
        AutoscalerConfig(patience=0)


# ------------------------------------------- retire / drain via router

def test_retire_replica_reroutes_without_failing(engine):
    router = FleetRouter(engine, n_replicas=2, n_slots=1)
    prompts = _prompts(6, seed=6)
    futs = [router.submit(p, 6) for p in prompts]
    router.step()
    with router._lock:
        live = router._live_locked()
    victim = max(live, key=lambda rep: rep.scheduler.queue_depth())
    pool = _weak_pool(router, victim.rid)
    moved = router.retire_replica(victim.rid)
    assert moved > 0
    assert router.replicas[victim.rid].status == "retired"
    gc.collect()
    assert all(r() is None for r in pool)
    router.run_until_idle()
    for p, f in zip(prompts, futs):
        np.testing.assert_array_equal(
            f.result(timeout=WAIT_S).tokens, _oracle(engine, p, 6))
    assert router.leases.all_done()


def test_spawn_kill_retire_cycles_free_every_pool(engine):
    """Three spawn → serve → kill/retire cycles: each gone replica's pool
    is freed (weakly referenced tensors die), the live pools stay one."""
    router = FleetRouter(engine, n_replicas=1, n_slots=2,
                         scheduler_kwargs={"page_len": 4, "n_pages": 32})
    gone = []
    for cycle in range(3):
        with router._lock:
            rid = router._spawn_locked(reason="test")
        gone += _weak_pool(router, rid)
        futs = [router.submit(p, 4) for p in _prompts(4, seed=10 + cycle)]
        router.run_until_idle()
        assert all(f.result(timeout=WAIT_S).finish_reason in
                   ("eos", "length") for f in futs)
        if cycle % 2:
            router.retire_replica(rid)
        else:
            router.kill_replica(rid)
        gc.collect()
        assert all(r() is None for r in gone), cycle
        assert router.n_live() == 1
    live = [rep for rep in router.replicas.values() if rep.status == "live"]
    assert len(live) == 1 and live[0].scheduler.check_pages()


# ----------------------------------- episode + slo_report --fleet gate

def _service(engine, n_slots, tc):
    """Warm closed-loop service of a one-replica fleet on ``tc``'s mix:
    (requests a second, the warm single-request TTFT)."""
    router = FleetRouter(engine, n_replicas=1, n_slots=n_slots)
    arr = poisson_arrivals(TrafficConfig(
        rate_rps=100.0, duration_s=0.5, prompt_lens=tc.prompt_lens,
        max_new_tokens=tc.max_new_tokens, vocab=tc.vocab, seed=99))[:32]
    futs = [router.submit(a.prompt, a.max_new_tokens) for a in arr[:4]]
    router.run_until_idle()             # warm every bucket once
    t = time.perf_counter()
    futs = [router.submit(a.prompt, a.max_new_tokens) for a in arr]
    router.run_until_idle()
    rate = len(futs) / (time.perf_counter() - t)
    f = router.submit(arr[0].prompt, 1)
    router.run_until_idle()
    return rate, f.result(timeout=WAIT_S).ttft_s


def _slo_report():
    spec = importlib.util.spec_from_file_location(
        "slo_report", REPO / "scripts" / "slo_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_burst_episode_scales_and_replays(engine, tmp_path, capsys):
    """The burst's rate is a multiple of a service rate measured on this
    host just before, so the burst overloads one replica and the tail
    calms the fleet however loaded the host is."""
    mix = TrafficConfig(prompt_lens=(4, 8, 12), max_new_tokens=(8, 12),
                        vocab=VOCAB)
    rate, ttft0 = _service(engine, 2, mix)
    router = FleetRouter(
        engine, n_replicas=1, n_slots=2,
        slo=SLOConfig(ttft_s=max(20 * ttft0, 0.2), itl_s=10.0,
                      window_s=0.6),
        autoscaler=AutoscalerConfig(min_replicas=1, max_replicas=3,
                                    high_burn=1.0, low_burn=0.5,
                                    high_queue=3.0, patience=2,
                                    cooldown=3),
        autoscale_every=4)
    # base 0.2 R, a burst of 2.5 R for 0.6 s: a backlog of ~R requests
    # that two or three replicas drain well inside the calm tail
    tc = TrafficConfig(rate_rps=0.2 * rate, duration_s=5.0,
                       prompt_lens=mix.prompt_lens,
                       max_new_tokens=mix.max_new_tokens, vocab=VOCAB,
                       burst_start_s=0.3, burst_end_s=0.9,
                       burst_mult=12.5, seed=1)
    dump = tmp_path / "fleet_episode.jsonl"
    rep = run_episode(router, tc, dump_path=dump, max_wall_s=90)
    assert rep.completed == rep.submitted and rep.failed == 0
    assert router.scale_ups >= 1, ("burst never tripped a scale-up", rate)
    assert router.scale_downs >= 1, ("calm tail never scaled down", rate)
    assert router.fleet_report()["live"] < router.autoscaler.config \
        .max_replicas + 1

    mod = _slo_report()
    rc = mod.main([str(dump), "--fleet", "--ttft", "60", "--itl", "60"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "FLEET" in out
    assert f"{rep.submitted:>5}" in out
    lines = [ln for ln in out.splitlines() if "scale events:" in ln]
    assert lines, out
    ups = int(lines[0].split("scale events:")[1].split("up")[0].strip())
    downs = int(lines[0].split("up,")[1].split("down")[0].strip())
    assert ups >= 1 and downs >= 1
    assert "replicas 1→" in lines[0]
    rc = mod.main([str(dump), "--fleet", "--ttft", "60", "--itl", "60",
                   "--json"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 0
    evs = [e["scale_event"] for e in payload["scale_events"]]
    assert "up" in evs and "down" in evs
    assert payload["replica_range"][0] == 1
    assert payload["reports"]["FLEET"]["window"]["requests"] \
        == rep.submitted


# ------------------------------------------------- never-hang plumbing

def test_no_future_hangs_under_concurrent_submit(engine):
    router = FleetRouter(engine, n_replicas=2, n_slots=2)
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            router.step()
            time.sleep(0.001)

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    try:
        futs = [router.submit(p, 6) for p in _prompts(8, seed=7)]
        for f in futs:
            assert f.result(timeout=WAIT_S).finish_reason in (
                "eos", "length")
    finally:
        stop.set()
        t.join(timeout=10)
    assert router.leases.all_done()


def test_traffic_trace_is_seeded_and_bursty():
    tc = TrafficConfig(rate_rps=50.0, duration_s=2.0,
                       burst_start_s=0.5, burst_end_s=1.0,
                       burst_mult=8.0, sessions=3, seed=9)
    a1, a2 = poisson_arrivals(tc), poisson_arrivals(tc)
    assert len(a1) == len(a2)
    assert all(x.t == y.t and np.array_equal(x.prompt, y.prompt)
               for x, y in zip(a1, a2))
    in_burst = sum(1 for a in a1 if 0.5 <= a.t < 1.0)
    out_burst = sum(1 for a in a1 if a.t < 0.5 or a.t >= 1.0)
    assert in_burst > out_burst
    assert {a.session_id for a in a1} <= {"s0", "s1", "s2"}
    assert all(y.t > x.t for x, y in zip(a1, a1[1:]))


@pytest.mark.parametrize("seed", [0, 1, 9])
def test_poisson_arrivals_equal_reference(seed):
    kw = dict(rate_rps=30.0, duration_s=3.0, prompt_lens=(8, 16, 32),
              max_new_tokens=(6, 8), vocab=32000, burst_start_s=1.0,
              burst_end_s=2.0, burst_mult=4.0, sessions=8, seed=seed)
    ours = poisson_arrivals(TrafficConfig(**kw))
    ref = jpoisson(JTrafficConfig(**kw))
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert a.t == b.t and a.max_new_tokens == b.max_new_tokens
        assert a.session_id == b.session_id
        np.testing.assert_array_equal(a.prompt, b.prompt)


# ---------------------------------------------- parity with the JAX fleet

def _fleet_requests():
    rng = np.random.default_rng(30)
    toks = [rng.integers(1, VOCAB, size=n).astype(np.int32)
            for n in (12, 9, 14, 11, 10, 13)]
    return [
        (toks[0], dict(max_new_tokens=8)),
        (toks[1], dict(max_new_tokens=8)),
        (toks[2], dict(max_new_tokens=6, kind="constrained",
                       allowed_ids=[3, 5, 7, 11])),
        (toks[3], dict(max_new_tokens=6, kind="beam", beam_width=3)),
        (toks[4], dict(kind="score")),
        (toks[5], dict(kind="embed", pooling="last")),
        (toks[2], dict(max_new_tokens=7)),
        (toks[0], dict(kind="embed", pooling="mean")),
    ]


def _run_fleet(router, reqs, kill_after=3):
    futs = [router.submit(p, **kw) for p, kw in reqs]
    for _ in range(kill_after):
        router.step()
    held = {}
    for rec in router.outstanding.values():
        held[rec.rid] = held.get(rec.rid, 0) + 1
    moved = router.kill_replica(max(held, key=lambda r: (held[r], -r)))
    router.run_until_idle()
    return [f.result(timeout=WAIT_S) for f in futs], moved


def test_fleet_kill_mid_decode_matches_reference_fleet(engine, jengine):
    """Every kind through a 2-replica paged fleet of each package with the
    busier replica killed mid-decode: tokens identical, log-probs and
    embeddings within 1e-5, and GENERATE equal to the JAX engine's
    ``generate`` oracle."""
    reqs = _fleet_requests()
    kw = dict(n_replicas=2, n_slots=4,
              scheduler_kwargs={"page_len": 4, "n_pages": 32})
    ours, moved = _run_fleet(FleetRouter(engine, **kw), reqs)
    ref, jmoved = _run_fleet(JFleetRouter(jengine, **kw), reqs)
    assert moved and sorted(moved) == sorted(jmoved)
    for (p, k), a, b in zip(reqs, ours, ref):
        assert a.kind == b.kind and a.reprefills == b.reprefills
        assert a.finish_reason == b.finish_reason
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))
        if k.get("kind") is None:
            np.testing.assert_array_equal(
                a.tokens, _oracle(jengine, p, k["max_new_tokens"]))
        for field in ("logprobs", "embedding"):
            if getattr(b, field) is not None:
                np.testing.assert_allclose(getattr(a, field),
                                           getattr(b, field), atol=PARITY)
            else:
                assert getattr(a, field) is None
        if b.best_logprob is not None:
            assert abs(a.best_logprob - b.best_logprob) < PARITY
    assert sum(r.reprefills for r in ours) == len(moved)


def test_slo_report_reads_the_port_fleet_dump(engine, tmp_path, capsys):
    router = FleetRouter(engine, n_replicas=2, n_slots=2,
                         slo=SLOConfig(ttft_s=60, itl_s=60))
    futs = [router.submit(p, 5) for p in _prompts(6, seed=12)]
    for _ in range(2):
        router.step()
    router.kill_replica(0)
    router.run_until_idle()
    assert all(f.result(timeout=WAIT_S).finish_reason in ("eos", "length")
               for f in futs)
    dump = router.dump(tmp_path / "fleet.jsonl")
    rc = _slo_report().main([dump, "--fleet", "--ttft", "60", "--itl", "60",
                             "--json"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert payload["reports"]["FLEET"]["window"]["requests"] == len(futs)
    assert "r1" in payload["reports"]
