"""The reference's multi-chip dry run (``__graft_entry__._dryrun_impl``)
on the port at world 4 over gloo on the CPU: every case's sharded loss
against the monolithic JAX loss of the same weights and data.

The reference factors its device count into (a, b, c) = (2, 2, 1) at 4
devices, so A is dense dp2 × tp2, B the MoE dp2 × tp2 (plus dp2 × ep2
here, so that its experts split), C/H the pipelined LM over pp2 × dp2,
D the tp MLN and the generic pipeline, E the CG pipeline, F remat under
dp, G fsdp (and a net whose first layer fsdp splits), I a checkpoint and
resume under dp, K the ring step over dp2 × sp2, M the serving plane.
Case L, the elastic scale-out job, belongs to the socket half of
``parallel/`` (``scaleout.py``), which the port does not have yet.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.parallel as jpar
import deeplearning4j_tpu.train as jtrain
from deeplearning4j_tpu.data import DataSet as JDataSet
from deeplearning4j_tpu.zoo import transformer as jtfm

from torch_parallel_ranks import RankPool, build

JPKG = (jnn, jtrain, jpar, False)
WORLD = 4
A, B = 2, 2
KEY = jax.random.PRNGKey(0)
LM = dict(vocab_size=128, d_model=64, n_heads=4, n_layers=2, d_ff=128)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(WORLD)
    yield p
    p.close()


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def data(bsz, seq, vocab):
    ids = jax.random.randint(KEY, (bsz, seq), 0, vocab)
    tgt = jax.random.randint(jax.random.PRNGKey(1), (bsz, seq), 0, vocab)
    return np.asarray(ids), np.asarray(tgt)


def _mlp_data():
    x = np.asarray(jax.random.uniform(jax.random.PRNGKey(4), (8 * A, 16)))
    y = np.asarray(jax.nn.one_hot(jax.random.randint(
        jax.random.PRNGKey(5), (8 * A,), 0, 4), 4))
    return x, y


def _jmlp():
    net = build(JPKG, "dry_mlp", jnn.DenseLayer, jnn.DenseLayer)
    return net, {"params": _np(net.params), "states": _np(net.states)}


def test_dryrun_lm_steps(pool):
    """A: the dense LM's step over dp2 × tp2; B: the MoE LM (2 experts,
    top-1) over dp2 × tp2 and dp2 × ep2; K: the ring step over dp2 × sp2
    against the monolithic step. Each loss is the monolithic JAX loss of
    the same weights and batch."""
    cfg_a = dict(LM, max_seq=8)
    cfg_b = dict(LM, max_seq=8, n_experts=2, expert_top_k=1)
    cfg_k = dict(LM, max_seq=16)
    pa = jtfm.init_params(KEY, jtfm.TransformerConfig(
        **cfg_a, dtype=jnp.float32, remat=False))
    pb = jtfm.init_params(jax.random.PRNGKey(2), jtfm.TransformerConfig(
        **cfg_b, dtype=jnp.float32, remat=False))
    pk = jtfm.init_params(KEY, jtfm.TransformerConfig(
        **cfg_k, dtype=jnp.float32, remat=False))
    ids_a, tgt_a = data(4 * A, 8, 128)
    ids_k, tgt_k = data(2 * A, 16, 128)
    runs = [("a", {"dp": A, "tp": B}, {}), ("b", {"dp": A, "tp": B}, {}),
            ("b2", {"dp": A, "ep": B}, {}),
            ("k", {"dp": A, "sp": B},
             {"use_ring_attention": True, "fused_loss": False})]
    payload = {"runs": runs}
    for name, cfg, p, ids, tgt in (("a", cfg_a, pa, ids_a, tgt_a),
                                   ("b", cfg_b, pb, ids_a, tgt_a),
                                   ("b2", cfg_b, pb, ids_a, tgt_a),
                                   ("k", cfg_k, pk, ids_k, tgt_k)):
        payload.update({"cfg_" + name: cfg, "params_" + name: _np(p),
                        "ids_" + name: ids, "tgt_" + name: tgt})
    r = pool.run("dryrun_lm", payload)

    def mono(cfg, p, ids, tgt, **over):
        c = jtfm.TransformerConfig(**cfg, dtype=jnp.float32, remat=False,
                                   **over)
        return float(jax.jit(lambda q: jtfm.lm_loss(
            q, c, jnp.asarray(ids), jnp.asarray(tgt)))(p))
    want = {"a": mono(cfg_a, pa, ids_a, tgt_a),
            "b": mono(cfg_b, pb, ids_a, tgt_a),
            "b2": mono(cfg_b, pb, ids_a, tgt_a)}
    opt = optax.adam(1e-3)
    ck = jtfm.TransformerConfig(**cfg_k, dtype=jnp.float32, remat=False,
                                fused_loss=False)
    _, _, lk = jax.jit(jtfm.make_train_step(ck, opt))(
        pk, opt.init(pk), jnp.asarray(ids_k), jnp.asarray(tgt_k))
    want["k"] = float(lk)
    for x in r:
        for name in ("a", "b", "b2"):
            assert np.isfinite(x[name])
            assert abs(x[name] - want[name]) < 1e-4, (name, x[name])
        assert abs(x["k"] - want["k"]) < 1e-5


def test_dryrun_pipelines(pool):
    """C/H: the pipelined LM step over pp2 × dp2 computes the monolithic
    loss; D: the generic MLN pipeline over pp2 × dp2; E: a linear-chain
    graph through it."""
    cfg = dict(LM, n_layers=4, max_seq=8)
    params = jtfm.init_params(jax.random.PRNGKey(3), jtfm.TransformerConfig(
        **cfg, dtype=jnp.float32, remat=False))
    ids, tgt = data(2 * 2 * B, 8, 128)
    ch = jtfm.TransformerConfig(**cfg, dtype=jnp.float32, remat=False)
    mono_h = float(jax.jit(lambda p: jtfm.lm_loss(
        p, ch, jnp.asarray(ids), jnp.asarray(tgt)))(params))
    x, y = _mlp_data()
    x_mb, y_mb = jpar.microbatches(x[:8 * B], y[:8 * B], 4 * B)
    net, w = _jmlp()
    cg = build(JPKG, "linear_cg")
    r = pool.run("dryrun_pipeline", dict(
        w, cfg=cfg, lm_params=_np(params), ids_mb=ids.reshape(2, 2 * B, 8),
        tgt_mb=tgt.reshape(2, 2 * B, 8), x_mb=x_mb, y_mb=y_mb, mb=4 * B,
        cg_params=_np(cg.params), cg_states=_np(cg.states)))

    def mb_mean(loss_fn):
        return float(np.mean([float(loss_fn(jnp.asarray(a), jnp.asarray(b)))
                              for a, b in zip(x_mb, y_mb)]))
    want_d = mb_mean(lambda a, b: net._loss(net.params, net.states, a, b,
                                            None, None, None)[0])
    want_e = mb_mean(lambda a, b: cg._loss(cg.params, cg.states, {"in": a},
                                           {"out": b}, None, None, None)[0])
    for x_ in r:
        assert abs(x_["C"] - mono_h) < 1e-4, (x_["C"], mono_h)
        assert abs(x_["D"] - want_d) < 1e-5
        assert abs(x_["E"] - want_e) < 1e-5


def test_dryrun_wrapper_cases(pool):
    """D: ParallelWrapper over dp2 × tp2; F: remat under dp equals plain;
    G: fsdp over 4 ranks equals the monolithic loss, and a net whose
    first layer fsdp splits (its updater state split, its params gathered
    after each update) tracks the single-device fit; I: a checkpoint
    restored mid-run resumes as the uninterrupted run."""
    x, y = _mlp_data()
    net, w = _jmlp()
    mono = float(net.score(JDataSet(x, y)))
    wide = build(JPKG, "wide_mlp")
    rng = np.random.default_rng(0)
    wx = rng.standard_normal((16, 128)).astype(np.float32)
    wy = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 16)]
    r = pool.run("dryrun_wrapper", dict(
        w, x=x, y=y, wide_params=_np(wide.params),
        wide_states=_np(wide.states), wx=wx, wy=wy))
    want = [wide.fit(JDataSet(wx, wy)) for _ in range(3)]
    for rank, x_ in enumerate(r):
        assert abs(x_["D"] - mono) < 1e-5
        assert abs(x_["G"] - mono) < 1e-5
        np.testing.assert_allclose(x_["G_wide"], want, atol=1e-5)
        assert x_["G_specs"]["layer_0"]["W"] == (None, "fsdp")
        assert (128, 64) in x_["G_state"] and (128, 256) not in \
            x_["G_state"]
        jax.tree_util.tree_map(lambda a, b: np.testing.assert_allclose(
            a, np.asarray(b), rtol=1e-4, atol=1e-5), x_["G_params"],
            wide.params)
        if rank < 2:
            assert abs(x_["F"][0] - x_["F"][1]) < 1e-5
            assert abs(x_["I"][0] - x_["I"][1]) < 1e-5


def test_dryrun_serving_plane():
    """M: mixed-length greedy traffic through a 2-slot scheduler equals
    the one-shot ``generate`` oracle (the port's engine; one process)."""
    import torch
    from deeplearning4j_tpu_torch.serving import (ContinuousBatchingScheduler,
                                                  GenerationEngine)
    from deeplearning4j_tpu_torch.zoo import transformer as ttfm
    kw = dict(vocab_size=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
              max_seq=32, attn_scores_bf16=False)
    jp = jtfm.init_params(jax.random.PRNGKey(9), jtfm.TransformerConfig(
        **kw, dtype=jnp.float32, remat=False))
    cfg = ttfm.TransformerConfig(**kw, dtype=torch.float32, remat=False)
    eng = GenerationEngine(cfg, ttfm.params_from_numpy(_np(jp), cfg,
                                                       device="cpu"),
                           device="cpu")
    sched = ContinuousBatchingScheduler(eng, n_slots=2)
    prompts = [np.asarray(jax.random.randint(jax.random.PRNGKey(40 + i),
                                             (3 + 2 * i,), 0, 128))
               for i in range(3)]
    futs = [sched.submit(p, max_new_tokens=4 + i)
            for i, p in enumerate(prompts)]
    sched.run_until_idle()
    for i, (p, f) in enumerate(zip(prompts, futs)):
        res = f.result(timeout=5)
        assert list(res.tokens) == list(eng.generate(p, 4 + i))
    assert sched.queue_depth() == 0
