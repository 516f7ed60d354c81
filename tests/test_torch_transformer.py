"""Parity of the port's Transformer-LM (``deeplearning4j_tpu_torch.zoo``)
with the JAX package on shared weights.

Weights are drawn once by the JAX package's ``init_params``, passed as
numpy through ``params_from_numpy``, and the same token ids go through
both. Tolerances: f32 logits atol = rtol = 1e-5 (matmul summation order
differs between XLA and PyTorch); bf16 paths are judged by per-position
KL <= 1e-3, the reference's own promotion bar, or to one bf16 ulp where a
single op is compared.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.zoo import transformer as jtfm
from deeplearning4j_tpu_torch.zoo import transformer as ttfm

torch.set_num_threads(2)

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_ULP = dict(atol=1e-2, rtol=1e-2)   # ~one bf16 ulp (2^-7) relative
MAX_KL = 1e-3

TINY = dict(vocab_size=61, d_model=32, n_heads=2, n_layers=2, d_ff=64,
            max_seq=64, remat=False)


def configs(dtype="f32", **kw):
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    base = dict(TINY, attn_scores_bf16=False)
    base.update(kw)
    return (jtfm.TransformerConfig(dtype=jdt, **base),
            ttfm.TransformerConfig(dtype=tdt, **base))


@pytest.fixture(scope="module")
def shared():
    jcfg, tcfg = configs()
    jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = ttfm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                tcfg, device="cpu")
    return jp, tp


def _ids(shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], shape).astype(np.int32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _kl(ref, cand):
    lp = ref - jax.nn.logsumexp(ref, axis=-1, keepdims=True)
    lq = cand - jax.nn.logsumexp(cand, axis=-1, keepdims=True)
    return np.asarray((jnp.exp(lp) * (lp - lq)).sum(-1))


# ------------------------------------------------------------- params

def test_params_from_numpy_keeps_layout_and_round_trips_bf16(shared):
    jp, tp = shared
    _, tcfg = configs()
    ref = ttfm.init_params(tcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat_j) == 10      # embed, pos, 6 block leaves, ln_f, head
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        t, r = tp, ref
        for k in keys:
            t, r = t[k], r[k]
        assert tuple(t.shape) == leaf.shape == tuple(r.shape), keys
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    # bf16 leaves arrive as f32; the cast back to bf16 is exact
    wb = jnp.asarray(jp["blocks"]["wqkv"], jnp.bfloat16)
    _, bcfg = configs(param_dtype=torch.bfloat16)
    got = ttfm.params_from_numpy(
        {"w": np.asarray(wb.astype(jnp.float32))}, bcfg, device="cpu")["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(wb.astype(jnp.float32)))


def test_init_params_distribution():
    """init cannot reproduce jax.random draws; it must match the
    reference's scaled-normal distribution instead."""
    _, tcfg = configs(vocab_size=4000, d_model=64)
    p = ttfm.init_params(tcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    assert abs(p["embed"].std().item() - 1 / 8) < 5e-3
    assert abs(p["pos_embed"].std().item() - 0.02) < 2e-3
    assert torch.equal(p["ln_f"], torch.ones(64))


# ------------------------------------------------------------- forward

def test_forward_matches_jax_every_position(shared):
    jp, tp = shared
    jcfg, tcfg = configs()
    ids = _ids((2, 24))
    jl, _ = jtfm.forward(jp, jcfg, jnp.asarray(ids))
    tl, _ = ttfm.forward(tp, tcfg, _t(ids).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)


def test_apply_blocks_return_kv_matches_jax(shared):
    jp, tp = shared
    jcfg, tcfg = configs()
    ids = _ids((2, 16), seed=1)
    jx = jtfm.embed(jp, jcfg, jnp.asarray(ids))
    tx = ttfm.embed(tp, tcfg, _t(ids).long())
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **F32_TOL)
    jo, _, (jk, jv) = jtfm.apply_blocks(jp["blocks"], jcfg, jx,
                                        return_kv=True)
    with torch.no_grad():
        to, _, (tk, tv) = ttfm.apply_blocks(tp["blocks"], tcfg, tx,
                                            return_kv=True)
    assert tuple(tk.shape) == jk.shape == (2, 2, 16, 2, 16)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **F32_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **F32_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **F32_TOL)
    to2, _ = ttfm.apply_blocks(tp["blocks"], tcfg, tx)
    torch.testing.assert_close(to2, to, rtol=0, atol=0)


def test_head_logits_rows_and_hidden_rows_match_jax(shared):
    jp, tp = shared
    jcfg, tcfg = configs()
    x = np.random.default_rng(2).standard_normal((5, 32)).astype(np.float32)
    np.testing.assert_allclose(
        ttfm.head_logits_rows(tp, tcfg, _t(x)).numpy(),
        np.asarray(jtfm.head_logits_rows(jp, jcfg, jnp.asarray(x))),
        **F32_TOL)
    np.testing.assert_allclose(
        ttfm.hidden_rows(tp, tcfg, _t(x)).numpy(),
        np.asarray(jtfm.hidden_rows(jp, jcfg, jnp.asarray(x))), **F32_TOL)
    x3 = x.reshape(1, 5, 32)
    np.testing.assert_allclose(
        ttfm.head_logits(tp, tcfg, _t(x3)).numpy(),
        np.asarray(jtfm.head_logits(jp, jcfg, jnp.asarray(x3))), **F32_TOL)


@pytest.mark.parametrize("arm", ["dot_product_f32", "dot_product_bf16",
                                 "bf16_scores"])
def test_attention_arms_match_jax(arm):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
               for _ in range(3))
    if arm == "dot_product_f32":
        ref = jax.nn.dot_product_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), is_causal=True)
        got = ttfm.dot_product_attention(_t(q), _t(k), _t(v))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)
        return
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    tb = [_t(a).to(torch.bfloat16) for a in (q, k, v)]
    if arm == "bf16_scores":
        ref = jtfm._xla_attention_bf16_scores(*jb)
        got = ttfm._xla_attention_bf16_scores(*tb)
    else:
        ref = jax.nn.dot_product_attention(*jb, is_causal=True)
        got = ttfm.dot_product_attention(*tb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               **BF16_ULP)


def test_flash_arm_forward_matches_jax_interpret(shared, monkeypatch):
    """use_flash_attention=True on both sides: the JAX package runs its
    Pallas kernel in interpret mode, the port its kernel's plain version
    (CPU tensors). Under this suite's 8 host devices the JAX gate
    ``flash_engages`` returns False (its Pallas call is single-device
    only), so it is patched to True here, and the Pallas forward's
    calls are counted to show that it ran."""
    import importlib
    jfa = importlib.import_module(
        "deeplearning4j_tpu.kernels.flash_attention")
    calls = []
    orig = jfa._fwd

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(jtfm, "flash_engages", lambda cfg, t: True)
    monkeypatch.setattr(jfa, "_fwd", counting)
    jp, tp = shared
    jcfg, tcfg = configs(use_flash_attention=True)
    ids = _ids((1, 32), seed=4)
    jl, _ = jtfm.forward(jp, jcfg, jnp.asarray(ids))
    tl, _ = ttfm.forward(tp, tcfg, _t(ids).long())
    assert calls
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)


def test_bf16_forward_within_kl(shared):
    """The bf16 model (bf16-scores arm, the reference default) through
    both packages: per-position KL <= 1e-3."""
    jp, tp = shared
    jcfg, tcfg = configs("bf16", attn_scores_bf16=True)
    ids = _ids((2, 20), seed=5)
    jl, _ = jtfm.forward(jp, jcfg, jnp.asarray(ids))
    tl, _ = ttfm.forward(tp, tcfg, _t(ids).long())
    assert tl.dtype == torch.float32
    kl = _kl(np.asarray(jl), tl.numpy())
    assert kl.max() <= MAX_KL, kl.max()


def test_bf16_rounding_points_match_jax(shared):
    """embed scales by sqrt(d) in bf16 (the constant rounds first, as a
    JAX weak-typed scalar does); _rmsnorm runs in f32 and casts back."""
    jp, tp = shared
    jcfg, tcfg = configs("bf16")
    ids = _ids((1, 10), seed=6)
    je = np.asarray(jtfm.embed(jp, jcfg, jnp.asarray(ids))
                    .astype(jnp.float32))
    te = ttfm.embed(tp, tcfg, _t(ids).long())
    assert te.dtype == torch.bfloat16
    np.testing.assert_allclose(te.float().numpy(), je, **BF16_ULP)
    x = np.random.default_rng(7).standard_normal((4, 32)).astype(np.float32)
    jn = jtfm._rmsnorm(jnp.asarray(x, jnp.bfloat16), jp["blocks"]["ln1"][0])
    tn = ttfm._rmsnorm(_t(x).to(torch.bfloat16), tp["blocks"]["ln1"][0])
    np.testing.assert_array_equal(tn.float().numpy(),
                                  np.asarray(jn.astype(jnp.float32)))


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 241).astype(np.float32)
    np.testing.assert_allclose(ttfm.gelu(_t(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               atol=1e-6)
    erf = torch.nn.functional.gelu(_t(x))
    assert (erf - ttfm.gelu(_t(x))).abs().max() > 1e-4


def test_flash_engages_gate():
    _, cfg = configs()
    assert not ttfm.flash_engages(cfg, 4096, "cpu")
    assert ttfm.flash_engages(cfg, 1024, "cuda")
    assert not ttfm.flash_engages(cfg, 1023, "cuda")
    assert ttfm.flash_engages(dataclasses.replace(
        cfg, use_flash_attention=True), 8, "cpu")
    assert not ttfm.flash_engages(dataclasses.replace(
        cfg, use_flash_attention=False), 4096, "cuda")
    # ring wins over flash (the reference's gate): the ring runs K1 per hop
    ring = dataclasses.replace(cfg, use_ring_attention=True)
    assert not ttfm.flash_engages(ring, 4096, "cuda")
    assert not ttfm.flash_engages(dataclasses.replace(
        ring, use_flash_attention=True), 8, "cpu")


def test_draft_params_share_prefix(shared):
    _, tp = shared
    _, tcfg = configs()
    dcfg, dp = ttfm.draft_params(tp, tcfg, 1)
    assert dcfg.n_layers == 1
    assert dp["blocks"]["wqkv"].shape[0] == 1
    assert dp["embed"] is tp["embed"]
    with pytest.raises(ValueError):
        ttfm.draft_config(tcfg, 3)


def test_entry_points_raise_without_a_card(shared, monkeypatch):
    """device=None means the CUDA card; without one the entry points
    raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tp = shared
    _, tcfg = configs()
    with pytest.raises(RuntimeError, match="CUDA"):
        ttfm.init_params(tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttfm.generate(tp, tcfg, _ids((4,)), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttfm.params_from_numpy({"w": np.zeros(2, np.float32)}, tcfg)
    out = ttfm.generate(tp, tcfg, _ids((4,)), 2, device="cpu")
    assert out.shape == (2,)
