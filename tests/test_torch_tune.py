"""The port's serving-knob sweep (``deeplearning4j_tpu_torch.serving.tune``)
on the CPU: ``tests/test_paged_kv.py::test_serving_knob_sweep_writes_cost_
records`` ported, with the records in a temporary store, and
``recommended_serving_knobs`` reading back what the sweep wrote — the
keys those of the JAX package's sweep of the same model. The model is
small and f32 (2 layers, d_model 64, 4 heads, vocab 61, max_seq 64),
weights drawn by the JAX package and shared through ``params_from_numpy``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import autotune as jat
from deeplearning4j_tpu.serving import GenerationEngine as JEngine
from deeplearning4j_tpu.serving import tune as jtune
from deeplearning4j_tpu.zoo import transformer as jtfm
from deeplearning4j_tpu_torch.kernels import autotune as at
from deeplearning4j_tpu_torch.serving import GenerationEngine, tune
from deeplearning4j_tpu_torch.zoo import transformer as ttfm

torch.set_num_threads(2)

SMALL = dict(vocab_size=61, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq=64, remat=False, attn_scores_bf16=False)
KINDS = {"serving_page_len", "serving_prefill_chunk", "serving_decode_slots"}


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
    monkeypatch.setattr(at, "_CACHE_PATH", tmp_path / "torch.json")
    monkeypatch.setattr(jat, "_CACHE_PATH", tmp_path / "jax.json")
    at._memory_cache.clear()
    jat._memory_cache.clear()
    yield
    at._memory_cache.clear()
    jat._memory_cache.clear()


def test_serving_knob_sweep_writes_cost_records(model):
    """The sweep lands cost records in the port's store — choice and
    per-candidate measurements, keyed by shape, dtype and backend — and
    ``recommended_serving_knobs`` reads them back; the choice is the
    fastest measured candidate."""
    _, _, tcfg, tp = model
    eng = GenerationEngine(tcfg, tp, device="cpu", prefill_chunk=8)
    knobs = tune.sweep_serving_knobs(eng, prompt_len=32)
    assert knobs["page_len"] in tune.PAGE_LEN_CANDIDATES
    assert knobs["prefill_chunk"] in tune.PREFILL_CHUNK_CANDIDATES
    assert knobs["decode_slots"] in tune.DECODE_SLOT_CANDIDATES
    recs = tune.recommended_serving_knobs(tcfg)
    assert {k.split(":")[0] for k in recs} == KINDS
    for key, rec in recs.items():
        assert key.endswith(":float32:cpu")
        assert rec["meta"]["best_s"] > 0
        timed = [m for m in rec["meta"]["measurements"] if m[1] is not None]
        assert timed, key
        assert rec["choice"] == list(min(timed, key=lambda m: m[1])[0])
    # a second sweep is served from the records
    assert tune.sweep_serving_knobs(eng, prompt_len=32) == knobs
    # the prefill-chunk candidate past the prompt is recorded untimed
    pc = next(r for k, r in recs.items()
              if k.startswith("serving_prefill_chunk"))
    assert [[256], None] in pc["meta"]["measurements"]


def test_recommended_knobs_read_back_what_the_sweep_wrote(model):
    """Short candidate lists (as the card's smoke run sweeps them): the
    records read back name exactly the knobs the sweep returned, under
    the JAX package's keys, filtered field for field by shape and
    ``max_len``."""
    jcfg, jp, tcfg, tp = model
    eng = GenerationEngine(tcfg, tp, device="cpu", prefill_chunk=8)
    knobs = tune.sweep_serving_knobs(eng, prompt_len=32, page_lens=(8, 16),
                                     prefill_chunks=(16, 32),
                                     decode_slots=(2, 4))
    recs = tune.recommended_serving_knobs(tcfg, max_len=64)
    by_kind = {k.split(":")[0]: r for k, r in recs.items()}
    assert {k: r["choice"] for k, r in by_kind.items()} == {
        "serving_page_len": [knobs["page_len"]],
        "serving_decode_slots": [knobs["decode_slots"]]}
    assert set(tune.recommended_serving_knobs(tcfg)) == set(recs) | {
        next(k for k in at.records() if k.startswith(
            "serving_prefill_chunk"))}
    # the JAX package's sweep of the same model writes the same keys
    jeng = JEngine(jcfg, jp, prefill_chunk=8)
    jtune.sweep_page_len(jeng, candidates=(8, 16))
    jtune.sweep_prefill_chunk(jeng, prompt_len=32, candidates=(16, 32))
    jtune.sweep_decode_slots(jeng, candidates=(2, 4))
    assert set(jtune.recommended_serving_knobs(jcfg)) == set(
        tune.recommended_serving_knobs(tcfg))
    # another shape reads none of them
    other = ttfm.TransformerConfig(dtype=torch.float32,
                                   **dict(SMALL, d_model=640, n_heads=40))
    assert tune.recommended_serving_knobs(other) == {}
    assert tune.recommended_serving_knobs(tcfg, max_len=128) == {}


def test_disabled_sweep_takes_the_first_candidate_untimed(model):
    _, _, tcfg, tp = model
    eng = GenerationEngine(tcfg, tp, device="cpu", prefill_chunk=8)
    assert tune.sweep_page_len(eng, candidates=(16, 8), enabled=False) == 16
    assert at.records() == {}
