"""The port's autotune store and the fidelity-gated paged-kernel promotion
race (``deeplearning4j_tpu_torch.kernels.autotune``,
``kernels.paged_attention.race``/``decide``) against the JAX package's, on
the CPU.

Ported: ``tests/test_kernels.py::test_autotune_picks_and_caches``,
``tests/test_obs.py::test_autotune_records_measurement_metadata`` and the
promotion and cost-record tests of ``tests/test_paged_attention.py`` (race
record, sha invalidation, ``auto`` without a race, the public API, the
deprecated shims, ``source_sha``). Added: the cost-record keys equal the
JAX package's letter for letter on the CPU, and the paged race's fidelity
report on the same probe content equals the JAX race's (``kl_max`` within
1e-6). The model is small and f32 (2 layers, d_model 64, 4 heads, page_len
4), weights drawn by the JAX package and shared through
``params_from_numpy``. Every test has its own stores (both packages'
``_CACHE_PATH`` under ``tmp_path``), so no record leaks between tests or
from the home directory.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import autotune as jat
from deeplearning4j_tpu.serving import GenerationEngine as JEngine
from deeplearning4j_tpu.serving import quant as jquant
from deeplearning4j_tpu.serving import spec as jspec
from deeplearning4j_tpu.serving import tune as jtune
from deeplearning4j_tpu.zoo import transformer as jtfm
from deeplearning4j_tpu_torch import obs as tobs
from deeplearning4j_tpu_torch.kernels import autotune as at
from deeplearning4j_tpu_torch.kernels import paged_attention as tpa
from deeplearning4j_tpu_torch.serving import GenerationEngine, PageTable
from deeplearning4j_tpu_torch.serving import quant, spec, tune
from deeplearning4j_tpu_torch.zoo import transformer as ttfm

jpa = importlib.import_module("deeplearning4j_tpu.kernels.paged_attention")

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
VOCAB = 61
SMALL = dict(vocab_size=VOCAB, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq=32, remat=False, attn_scores_bf16=False)
VERDICTS = ("promoted", "fallback_slower", "fallback_fidelity")


@pytest.fixture(scope="module")
def model():
    jcfg = jtfm.TransformerConfig(dtype=jnp.float32, **SMALL)
    tcfg = ttfm.TransformerConfig(dtype=torch.float32, **SMALL)
    jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = ttfm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(autouse=True)
def _isolated_stores(tmp_path, monkeypatch):
    """Each test its own stores, for both packages."""
    monkeypatch.setattr(at, "_CACHE_PATH", tmp_path / "torch.json")
    monkeypatch.setattr(jat, "_CACHE_PATH", tmp_path / "jax.json")
    at._memory_cache.clear()
    jat._memory_cache.clear()
    yield
    at._memory_cache.clear()
    jat._memory_cache.clear()


def _races(reg, kernel):
    c = reg.get("dl4j_autotune_promotions_total")
    return 0 if c is None else sum(c.value(kernel=kernel, verdict=v)
                                   for v in VERDICTS)


def _race_cache(eng):
    """The reference test's geometry: 2 slots of 16 pages of 4, 8 rows
    mapped each, cursors 5 and 3."""
    cache = eng.init_paged_cache(2, 16, 4)
    pt = PageTable.for_cache(cache)
    assert pt.map(0, 8) and pt.map(1, 8)
    cache = pt.sync(cache)
    eng.set_positions(cache, [0], 5)
    eng.set_positions(cache, [1], 3)
    return cache


# ------------------------------------------------------------ the store

def test_autotune_picks_and_caches():
    calls = []

    def make_run(cand):
        if cand == (9, 9):
            return None                     # invalid for the shape

        def run():
            calls.append(cand)
            time.sleep(0.02 if cand == (1, 1) else 0.0)
            return torch.zeros(1)
        return run

    assert at.autotune("k1", [(1, 1), (2, 2), (9, 9)], make_run) == (2, 2)
    n = len(calls)
    assert at.autotune("k1", [(1, 1), (2, 2)], make_run) == (2, 2)
    assert len(calls) == n                  # cached: no timing
    at._memory_cache.clear()                # the disk record serves
    assert at.autotune("k1", [(1, 1), (2, 2)], make_run) == (2, 2)
    assert len(calls) == n
    assert at.autotune("k2", [(3, 3), (4, 4)], make_run,
                       enabled=False) == (3, 3)
    assert len(calls) == n


def test_autotune_records_measurement_metadata():
    def make_run(cand):
        if cand == (9, 9):
            return None
        return lambda: torch.zeros(1)

    assert at.autotune("meta_k", [(1, 1), (2, 2), (9, 9)], make_run) in (
        (1, 1), (2, 2))
    meta = at.measurement_meta("meta_k")
    assert meta["candidates"] == 3 and meta["measured_at"] > 0
    timed = [m for m in meta["measurements"] if m[1] is not None]
    assert len(timed) == 2
    assert any(m[0] == [9, 9] and m[1] is None
               for m in meta["measurements"])
    # legacy bare-list entries still load
    disk = json.loads(at._CACHE_PATH.read_text())
    disk["legacy_k"] = [4, 4]
    at._CACHE_PATH.write_text(json.dumps(disk))
    at._memory_cache.clear()
    assert at.autotune("legacy_k", [(8, 8)], make_run) == (4, 4)
    assert at.measurement_meta("legacy_k") is None


def test_autotune_raises_what_a_candidate_raises():
    """A candidate that fails (a kernel's build or launch) propagates: it
    is never recorded as a slow candidate."""
    def make_run(cand):
        def run():
            raise RuntimeError("launch failed")
        return run

    with pytest.raises(RuntimeError, match="launch failed"):
        at.autotune("bad", [(1,)], make_run)
    assert at.records() == {}


def test_store_is_the_ports_own(tmp_path):
    """``$DL4J_TORCH_DATA`` (else ``~/.deeplearning4j_tpu_torch``) holds
    the store — never the JAX package's directory."""
    code = ("from deeplearning4j_tpu_torch.kernels import autotune as a; "
            "print(a._CACHE_PATH)")
    env = dict(os.environ, DL4J_TORCH_DATA=str(tmp_path),
               DL4J_TPU_DATA=str(tmp_path / "jax"))

    def store(env):
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             text=True, capture_output=True, cwd=ROOT,
                             timeout=120)
        assert out.returncode == 0, out.stderr
        return out.stdout.strip()

    assert store(env) == str(tmp_path / "autotune.json")
    env.pop("DL4J_TORCH_DATA")
    env["HOME"] = str(tmp_path / "home")
    assert store(env) == str(tmp_path / "home" / ".deeplearning4j_tpu_torch"
                             / "autotune.json")


def test_records_choice_lookup_public_api():
    at.put("flash5:cpu:1x2x3x4:f32:True", (128, 256),
           meta={"best_s": 1e-3})
    at.put("serving_page_len:L2H2D16:T32:S4:float32:cpu", (16,))
    at.put("paged_decode:L2H2D16:PL4:P8:NP16:S2:float32:cpu",
           ("kernel",), sha="abc")
    assert set(at.records(kind="serving")) == \
        {"serving_page_len:L2H2D16:T32:S4:float32:cpu"}
    assert len(at.records()) == 3
    assert at.choice("flash5:cpu:1x2x3x4:f32:True") == (128, 256)
    rec = at.lookup("paged_decode:L2H2D16:PL4:P8:NP16:S2:float32:cpu",
                    sha="abc")
    assert rec["choice"] == ["kernel"] and rec["sha"] == "abc"
    assert at.lookup("paged_decode:L2H2D16:PL4:P8:NP16:S2:float32:cpu",
                     sha="xyz") is None
    assert "paged_decode:L2H2D16:PL4:P8:NP16:S2:float32:cpu" \
        not in at.records()
    assert at.choice("serving_page_len:L2H2D16:T32:S4:float32:cpu",
                     sha="whatever") == (16,)
    assert at.invalidate("flash5:cpu:1x2x3x4:f32:True") is True
    assert at.invalidate("flash5:cpu:1x2x3x4:f32:True") is False


def test_deprecated_shims_still_serve_old_callers():
    at.put("serving_decode_slots:L2H2D16:T32:float32:cpu", (8,),
           meta={"best_s": 2e-3})
    with pytest.warns(DeprecationWarning):
        store = at._disk_cache()
    entry = store["serving_decode_slots:L2H2D16:T32:float32:cpu"]
    with pytest.warns(DeprecationWarning):
        assert at._entry_choice(entry) == (8,)
    with pytest.warns(DeprecationWarning):
        assert at._entry_choice([4, 2]) == (4, 2)


def test_source_sha_changes_with_source(tmp_path):
    def f():
        return 1

    def g():
        return 2

    assert at.source_sha(f) != at.source_sha(g)
    assert at.source_sha(f) == at.source_sha(f)
    assert len(at.source_sha(f)) == 16
    # files hash by their bytes (a .cu source stamps its records)
    cu = tmp_path / "k.cu"
    cu.write_text("__global__ void k() {}\n")
    before = at.source_sha(cu, f)
    assert at.source_sha(str(cu), f) == before
    cu.write_text("__global__ void k() { }\n")
    assert at.source_sha(cu, f) != before


def test_kernel_sha_follows_the_cuda_source(monkeypatch, tmp_path):
    """K2's records are stamped with the bytes of ``csrc/
    paged_attention.cu``: an edited source gives another sha."""
    src = tpa._build.SRC_DIR / "paged_attention.cu"
    fake = tmp_path / "csrc"
    fake.mkdir()
    (fake / "paged_attention.cu").write_bytes(src.read_bytes())
    monkeypatch.setattr(tpa._build, "SRC_DIR", fake)
    same = tpa.kernel_sha()
    (fake / "paged_attention.cu").write_bytes(src.read_bytes() + b"\n")
    assert tpa.kernel_sha() != same


# ------------------------------------------------------ keys = the JAX's

def test_bucket_keys_equal_the_jax_packages(model):
    jcfg, jp, tcfg, tp = model
    eng = GenerationEngine(tcfg, tp, device="cpu", prefill_chunk=8)
    jeng = JEngine(jcfg, jp, prefill_chunk=8)
    tcache = eng.init_paged_cache(2, 16, 4)
    jcache = jeng.init_paged_cache(2, 16, 4)
    assert tpa.bucket_key(tcfg, tcache) == jpa.bucket_key(jcfg, jcache) \
        == "paged_decode:L2H4D16:PL4:P8:NP16:S2:float32:cpu"
    assert quant.kv_bucket_key(tcfg, 2, 10, 4, "cpu") == \
        jquant.kv_bucket_key(jcfg, 2, 10, 4)
    assert quant.w_bucket_key(tcfg, "cpu") == jquant.w_bucket_key(jcfg)
    assert spec.spec_bucket_key(tcfg, "ngram", 4, "cpu") == \
        jspec.spec_bucket_key(jcfg, "ngram", 4)
    for kind, dims in (("page_len", dict(T=32, S=4)),
                       ("prefill_chunk", dict(T=32)),
                       ("decode_slots", dict(T=32))):
        assert tune._key(kind, tcfg, "cpu", **dims) == \
            jtune._key(kind, jcfg, "cpu", **dims)
    # the dtype segment of a bf16 engine, as jnp names it
    assert at.dtype_name(torch.bfloat16) == jnp.dtype(jnp.bfloat16).name


# ------------------------------------------------ promotion lifecycle

def test_promotion_race_records_sha_stamped_verdict(model):
    """A decode over a fresh geometry in race mode runs the race once:
    a ``paged_decode:*`` record stamped with the kernel's sha, fidelity
    within the KL budget with identical greedy tokens, the promotions
    counter labelled with the verdict; a second decode does not race."""
    _, _, tcfg, tp = model
    reg = tobs.get_registry()
    reg.reset()
    eng = GenerationEngine(tcfg, tp, device="cpu", prefill_chunk=8,
                           paged_kernel="race")
    cache = _race_cache(eng)
    eng.decode_step(cache, [1, 2])
    recs = at.records(kind="paged_decode")
    assert len(recs) == 1
    key, rec = next(iter(recs.items()))
    assert key == tpa.bucket_key(eng.cfg, cache)
    assert rec["sha"] == tpa.kernel_sha()
    assert rec["choice"][0] in ("kernel", "gather")
    meta = rec["meta"]
    assert meta["verdict"] in ("promoted", "fallback_slower")
    assert meta["fidelity"]["kl_max"] <= tpa.PROMOTION_MAX_KL
    assert meta["fidelity"]["greedy_match_frac"] == 1.0
    assert meta["gather_s"] > 0 and meta["kernel_s"] > 0
    assert meta["backend"] == "cpu"
    assert reg.get("dl4j_autotune_promotions_total").value(
        kernel="paged_decode", verdict=meta["verdict"]) == 1
    eng.decode_step(cache, [1, 2])
    assert _races(reg, "paged_decode") == 1
    # a second engine serves the record without a race
    eng2 = GenerationEngine(tcfg, tp, device="cpu", prefill_chunk=8,
                            paged_kernel="race")
    assert tpa.decide(eng2, _race_cache(eng2)) == rec["choice"][0]
    assert _races(reg, "paged_decode") == 1


def test_sha_bump_invalidates_record_and_reraces(model, monkeypatch):
    _, _, tcfg, tp = model
    reg = tobs.get_registry()
    reg.reset()
    eng = GenerationEngine(tcfg, tp, device="cpu", prefill_chunk=8,
                           paged_kernel="race")
    cache = _race_cache(eng)
    eng.decode_step(cache, [1, 2])
    key = tpa.bucket_key(eng.cfg, cache)
    assert at.records(kind="paged_decode")[key]["sha"] == tpa.kernel_sha()
    assert _races(reg, "paged_decode") == 1
    monkeypatch.setattr(tpa, "kernel_sha", lambda: "deadbeef00000000")
    eng2 = GenerationEngine(tcfg, tp, device="cpu", prefill_chunk=8,
                            paged_kernel="race")
    eng2.decode_step(_race_cache(eng2), [1, 2])
    assert reg.get("dl4j_autotune_invalidations_total").value(
        kernel="paged_decode", reason="sha") == 1
    assert _races(reg, "paged_decode") == 2
    assert at.records(kind="paged_decode")[key]["sha"] == \
        "deadbeef00000000"


@pytest.mark.parametrize("how", ["default", "env_auto"])
def test_auto_mode_never_races(model, monkeypatch, how):
    """``auto`` (the default, or ``$DL4J_PAGED_KERNEL=auto``) never races:
    on the CPU the gather path, with no cost record and no kernel
    compile; on a CUDA pool the kernel (tests/test_torch_kernels.py)."""
    _, _, tcfg, tp = model
    if how == "env_auto":
        monkeypatch.setenv("DL4J_PAGED_KERNEL", "auto")
    eng = GenerationEngine(tcfg, tp, device="cpu", prefill_chunk=8)
    cache = eng.init_paged_cache(1, 8, 4)
    pt = PageTable.for_cache(cache)
    assert pt.map(0, 4)
    cache = pt.sync(cache)
    eng.set_positions(cache, [0], 3)
    eng.decode_step(cache, [1])
    assert list(eng._paged_plan.values()) == ["gather"]
    assert at.records(kind="paged_decode") == {}
    assert eng.compile_report()["decode_paged_kernel"]["compiles"] == 0


def test_env_race_mode_races(model, monkeypatch):
    """``$DL4J_PAGED_KERNEL=race`` asks for the race when the engine pins
    no mode."""
    _, _, tcfg, tp = model
    reg = tobs.get_registry()
    reg.reset()
    monkeypatch.setenv("DL4J_PAGED_KERNEL", "race")
    eng = GenerationEngine(tcfg, tp, device="cpu", prefill_chunk=8)
    eng.decode_step(_race_cache(eng), [1, 2])
    assert _races(reg, "paged_decode") == 1


def test_race_fidelity_equals_the_jax_race(model):
    """The same geometry raced by both packages: the probes hold the same
    content and tokens, both verdicts are timing verdicts, and the
    fidelity reports agree (``kl_max`` within 1e-6; on the CPU the port's
    kernel arm is K2's plain version, the JAX one its interpret-mode
    kernel)."""
    jcfg, jp, tcfg, tp = model
    eng = GenerationEngine(tcfg, tp, device="cpu", prefill_chunk=8)
    jeng = JEngine(jcfg, jp, prefill_chunk=8)
    tcache = eng.init_paged_cache(2, 16, 4)
    jcache = jeng.init_paged_cache(2, 16, 4)
    tprobe, ttoks = tpa._probe_cache(tcfg, tcache)
    jprobe, jtoks = jpa._probe_cache(jcfg, jcache)
    for name in ("k", "v", "pos", "pages"):
        np.testing.assert_array_equal(tprobe[name].numpy(),
                                      np.asarray(jprobe[name]))
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    mine = tpa.race(eng, tcache)
    ref = jpa.race(jeng, jcache)
    assert mine["key"] == ref["key"]
    for res in (mine, ref):
        assert res["verdict"] in ("promoted", "fallback_slower")
        assert res["fidelity"]["greedy_match_frac"] == 1.0
    assert abs(mine["fidelity"]["kl_max"]
               - ref["fidelity"]["kl_max"]) <= 1e-6
    assert mine["fidelity"]["positions"] == ref["fidelity"]["positions"]
    assert mine["fidelity"]["max_abs_err"] <= 1e-5


def test_race_propagates_a_kernel_error(model, monkeypatch):
    """A race catches nothing: a K2 build or launch error propagates and
    no verdict is recorded."""
    _, _, tcfg, tp = model

    def broken(*a, **k):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(tpa, "paged_attention", broken)
    eng = GenerationEngine(tcfg, tp, device="cpu", prefill_chunk=8,
                           paged_kernel="race")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        eng.decode_step(_race_cache(eng), [1, 2])
    assert at.records() == {}
