"""Parity of the port's BERT family (``deeplearning4j_tpu_torch.zoo
.transformer``) with the JAX package on shared weights.

Weights are drawn once by the JAX package's ``bert_init``, carried across
as numpy through ``bert_params_from_numpy``, and the same seeded numpy
ids, token types, masks and labels go through both. Tolerances: f32
logits and hidden states atol 1e-5, f32 losses 1e-5 and grads 1e-4
(matmul summation order differs between XLA and PyTorch); the fused MLM
loss against the naive one under the reference's ``MeasuredBound``s; the
bf16 paths to the reference's 0.05 (loss, relative to max(1, |loss|)) and
0.08 (grads, relative to max(1, max |grad|)); remat bit for bit.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning4j_tpu.zoo import transformer as J
from deeplearning4j_tpu_torch.obs import fidelity
from deeplearning4j_tpu_torch.zoo import transformer as T

torch.set_num_threads(2)

F32 = dict(atol=1e-5, rtol=0)
GRAD = dict(atol=1e-4, rtol=0)
BF16_LOSS_REL, BF16_GRAD_REL = 0.05, 0.08     # tests/test_bert.py:274-279
TINY = dict(vocab_size=96, d_model=32, n_heads=2, n_layers=2, d_ff=64,
            max_seq=16, num_labels=2)
MASK_ID = 95


def configs(dtype="f32", **kw):
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    base = dict(TINY, **kw)
    return J.BertConfig(dtype=jdt, **base), T.BertConfig(dtype=tdt, **base)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def shared():
    """JAX params with a perturbed classification head (the zero init
    makes the classifier logits degenerate) and the port's copy."""
    jc, tc = configs()
    jp = J.bert_init(jax.random.PRNGKey(3), jc)
    jp["cls"] = 0.1 * jax.random.normal(jax.random.PRNGKey(4),
                                        jp["cls"].shape)
    jp["mlm_bias"] = 0.1 * jax.random.normal(jax.random.PRNGKey(5),
                                             jp["mlm_bias"].shape)
    return jp, _np_tree(jp)


def _port(np_tree, cfg):
    return T.bert_params_from_numpy(np_tree, cfg, device="cpu")


def _inputs(seed=0, b=4, t=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, MASK_ID, (b, t)).astype(np.int32)
    type_ids = rng.integers(0, 2, (b, t)).astype(np.int32)
    mask = (rng.random((b, t)) < 0.8).astype(np.int32)
    mask[:, 0] = 1
    return ids, type_ids, mask


def _flat(tree, prefix=""):
    """{path: leaf} of nested dicts (sorted keys), for either package."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _np(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _port_grads(loss_fn, params):
    leaves = T.param_leaves(params)
    for p in leaves:
        p.grad = None
    loss = loss_fn(params)
    loss.backward()
    # a leaf the loss does not read has no grad; JAX's is zeros
    return float(loss.detach()), {
        k: torch.zeros_like(v) if v.grad is None else v.grad
        for k, v in _flat(params).items()}


def _assert_grads(jg, tg, tol):
    jf, tf = _flat(jg), _flat(tg)
    assert sorted(jf) == sorted(tf)
    for k in jf:
        np.testing.assert_allclose(_np(tf[k]), _np(jf[k]), err_msg=k, **tol)


def _t(a):
    return None if a is None else torch.as_tensor(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# ------------------------------------------------------------- params

def test_bert_init_has_the_reference_layout():
    jc, tc = configs()
    jp = J.bert_init(jax.random.PRNGKey(0), jc)
    tp = T.bert_init(tc, torch.Generator().manual_seed(0), device="cpu")
    jf, tf = _flat(jp), _flat(tp)
    assert sorted(jf) == sorted(tf)
    for k in jf:
        assert tuple(tf[k].shape) == tuple(jf[k].shape), k
        assert tf[k].dtype == torch.float32
    # the zero and one inits are the reference's exactly
    for k in ("cls", "mlm_bias", "mlm_ln", "blocks/ln1", "blocks/ln2"):
        np.testing.assert_array_equal(_np(tf[k]), np.asarray(jf[k]))
    assert "decoder" not in " ".join(tf)       # the MLM decoder is embed


def test_entry_points_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs on it")
    _, tc = configs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.bert_init(tc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.bert_params_from_numpy({"embed": np.zeros((2, 2))}, tc)


def test_mlm_decoder_is_tied_to_embed(shared):
    _, npp = shared
    _, tc = configs()
    tp = _port(npp, tc)
    ids, _, _ = _inputs()
    _, hidden = T.bert_forward(tp, tc, _t(ids))
    logits = T.bert_mlm_logits(tp, tc, hidden)
    assert logits.shape == (4, 16, TINY["vocab_size"])
    assert logits.dtype == torch.float32
    with torch.no_grad():
        tp["embed"][17] += 1.0
    diff = (T.bert_mlm_logits(tp, tc, hidden) - logits).abs()
    assert float(diff[..., 17].max()) > 0
    assert float(torch.cat([diff[..., :17], diff[..., 18:]], -1).max()) \
        == 0.0


# ------------------------------------------------------------- forward

@pytest.mark.parametrize("with_types", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_bert_forward_matches_jax(shared, with_types, with_mask):
    jp, npp = shared
    jc, tc = configs()
    tp = _port(npp, tc)
    ids, tids, mask = _inputs(1)
    tids = tids if with_types else None
    mask = mask if with_mask else None
    jl, jh = J.bert_forward(jp, jc, _j(ids), _j(tids), _j(mask))
    tl, th = T.bert_forward(tp, tc, _t(ids), _t(tids), _t(mask))
    assert not tl.requires_grad and not th.requires_grad   # no_grad
    assert tl.dtype == torch.float32 and th.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **F32)
    np.testing.assert_allclose(_np(th), np.asarray(jh), **F32)


@pytest.mark.parametrize("arm", ["stock", "bf16_scores"])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_bias_matches_jax(arm, causal):
    """Each attention arm with a padding bias against the JAX package's,
    at one bf16 rounding: the stock arm adds the f32 bias to the f32
    logits after the scale; the bf16-scores arm casts it to bf16 (−1e9 →
    −998244352) and adds it to the bf16 logits before the causal fill."""
    rng = np.random.default_rng(2)
    b, t, h, d = 2, 12, 2, 16
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32)
               for _ in range(3))
    mask = (rng.random((b, t)) < 0.7).astype(np.float32)
    mask[:, 0] = 1
    jbias = jnp.where(jnp.asarray(mask)[:, None, None, :] > 0, 0.0,
                      -1e9).astype(jnp.float32)
    tbias = torch.where(torch.as_tensor(mask)[:, None, None, :] > 0, 0.0,
                        -1e9).to(torch.float32)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v))
    if arm == "stock":
        want = jax.nn.dot_product_attention(
            jq, jk, jv, bias=jnp.broadcast_to(jbias, (b, h, t, t)),
            is_causal=causal)
        got = T.dot_product_attention(tq, tk, tv, is_causal=causal,
                                      bias=tbias)
    else:
        want = J._xla_attention_bf16_scores(jq, jk, jv, causal=causal,
                                            bias=jbias)
        got = T._xla_attention_bf16_scores(tq, tk, tv, causal=causal,
                                           bias=tbias)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=1e-2, rtol=1e-2)


def test_bias_none_leaves_the_lm_arms_unchanged():
    rng = np.random.default_rng(3)
    q, k, v = (torch.as_tensor(rng.standard_normal((2, 8, 2, 16))
                               .astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    zero = torch.zeros((2, 1, 1, 8))
    assert torch.equal(T.dot_product_attention(q, k, v),
                       T.dot_product_attention(q, k, v, bias=zero))
    assert torch.equal(T._xla_attention_bf16_scores(q, k, v),
                       T._xla_attention_bf16_scores(q, k, v, bias=zero))


# ------------------------------------------------------------- losses

@pytest.mark.parametrize("one_hot", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_classifier_loss_and_grads_match_jax(shared, one_hot, with_mask):
    jp, npp = shared
    jc, tc = configs()
    tp = _port(npp, tc)
    ids, tids, mask = _inputs(4)
    mask = mask if with_mask else None
    labels = np.random.default_rng(5).integers(0, 2, 4).astype(np.int32)
    if one_hot:
        labels = np.eye(2, dtype=np.float32)[labels]
    jl, jg = jax.value_and_grad(J.bert_classifier_loss)(
        jp, jc, _j(ids), _j(labels), _j(tids), _j(mask))
    tl, tg = _port_grads(lambda p: T.bert_classifier_loss(
        p, tc, _t(ids), _t(labels), _t(tids), _t(mask)), tp)
    np.testing.assert_allclose(tl, float(jl), **F32)
    _assert_grads(jg, tg, GRAD)


def _mlm_batch(seed=6):
    ids, tids, mask = _inputs(seed)
    weights = (np.random.default_rng(seed + 1).random(ids.shape) < 0.3
               ).astype(np.float32)
    labels = np.random.default_rng(seed + 2).integers(
        0, MASK_ID, ids.shape).astype(np.int32)
    return ids, labels, weights, tids, mask


@pytest.mark.parametrize("fused", [True, False])
def test_mlm_loss_and_grads_match_jax(shared, fused):
    jp, npp = shared
    jc, tc = configs()
    tp = _port(npp, tc)
    ids, labels, weights, tids, mask = _mlm_batch()
    jl, jg = jax.value_and_grad(J.bert_mlm_loss)(
        jp, jc, _j(ids), _j(labels), _j(weights), _j(tids), _j(mask),
        fused=fused)
    tl, tg = _port_grads(lambda p: T.bert_mlm_loss(
        p, tc, _t(ids), _t(labels), _t(weights), _t(tids), _t(mask),
        fused=fused), tp)
    np.testing.assert_allclose(tl, float(jl), **F32)
    _assert_grads(jg, tg, GRAD)
    # the tied embedding's grad sums the input and the decoder paths
    assert float(tg["embed"].abs().sum()) > 0


def test_fused_mlm_loss_matches_naive_under_measured_bounds():
    """The reference's fused-vs-naive test (tests/test_bert.py:197-236)
    on the port, with its recorded bounds."""
    jc, tc = configs(dtype="bf16")
    jp = J.bert_init(jax.random.PRNGKey(0), jc)
    tp = _port(_np_tree(jp), tc)
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (3, 16), 0,
                                        96))
    weights = np.asarray((jax.random.uniform(jax.random.PRNGKey(2), (3, 16))
                          < 0.3).astype(jnp.float32))
    ref = T.bert_mlm_loss(tp, tc, _t(ids), _t(ids), _t(weights),
                          fused=False)
    got = T.bert_mlm_loss(tp, tc, _t(ids), _t(ids), _t(weights), fused=True)
    loss_bound = fidelity.MeasuredBound(
        measured_abs=0.0, measured_rel=1.06e-4, margin=4,
        source="XLA:CPU 2026-08-04, compare of fused/naive bert_mlm_loss "
               "at 5.29 nats (tests/test_bert.py)")
    fidelity.assert_trees_close(float(ref), float(got), loss_bound,
                                what="fused-MLM loss")
    _, gr = _port_grads(lambda p: T.bert_mlm_loss(
        p, tc, _t(ids), _t(ids), _t(weights), fused=False), tp)
    gr = {k: v.clone() for k, v in gr.items()}
    _, gf = _port_grads(lambda p: T.bert_mlm_loss(
        p, tc, _t(ids), _t(ids), _t(weights), fused=True), tp)
    grad_bound = fidelity.MeasuredBound(
        measured_abs=3.9e-3, measured_rel=9.3e-3, margin=4,
        source="XLA:CPU 2026-08-04, compare_trees(fused, naive) MLM grads "
               "(tests/test_bert.py)")
    fidelity.assert_trees_close([gr[k] for k in sorted(gr)],
                                [gf[k] for k in sorted(gf)], grad_bound,
                                what="fused-MLM grads")


@pytest.mark.parametrize("policy", ["full", "save_attn", "dots",
                                    "dots_no_batch"])
def test_remat_is_bit_identical(shared, policy):
    _, npp = shared
    _, tc = configs()
    ids, tids, mask = _inputs(7)
    labels = np.random.default_rng(8).integers(0, 2, 4)
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tc, remat=remat, remat_policy=policy)
        tp = _port(npp, cfg)
        out[remat] = _port_grads(lambda p: T.bert_classifier_loss(
            p, cfg, _t(ids), _t(labels), _t(tids), _t(mask)), tp)
    (l0, g0), (l1, g1) = out[False], out[True]
    assert l0 == l1
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def _bf16_close(l_a, g_a, l_b, g_b):
    assert abs(l_a - l_b) < BF16_LOSS_REL * max(1.0, abs(l_b)), (l_a, l_b)
    fa, fb = _flat(g_a), _flat(g_b)
    for k in fb:
        a, b = _np(fa[k]), _np(fb[k])
        scale = max(1.0, float(np.abs(b).max()))
        assert float(np.abs(a - b).max()) < BF16_GRAD_REL * scale, k


def _bf16_case():
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(4), (16, 16), 0,
                                        60))
    labels = np.asarray(jax.random.randint(jax.random.PRNGKey(5), (16,), 0,
                                           2))
    mask = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(6), 0.8,
                                           ids.shape).astype(jnp.int32))
    return ids, labels, mask


def test_bf16_scores_close_to_stock_bf16(shared):
    """The port's bf16-scores arm against its stock bf16 arm, loss and
    grads, with padding (tests/test_bert.py:239-279's bounds)."""
    _, npp = shared
    ids, labels, mask = _bf16_case()
    out = {}
    for scores in (True, False):
        _, tc = configs(dtype="bf16", attn_scores_bf16=scores)
        out[scores] = _port_grads(lambda p: T.bert_classifier_loss(
            p, tc, _t(ids), _t(labels), attn_mask=_t(mask)), _port(npp, tc))
    _bf16_close(*out[True], *out[False])


@pytest.mark.parametrize("scores", [False, True])
def test_bf16_port_close_to_bf16_jax(shared, scores):
    jp, npp = shared
    ids, labels, mask = _bf16_case()
    jc, tc = configs(dtype="bf16", attn_scores_bf16=scores)
    jl, jg = jax.value_and_grad(J.bert_classifier_loss)(
        jp, jc, _j(ids), _j(labels), attn_mask=_j(mask))
    tl, tg = _port_grads(lambda p: T.bert_classifier_loss(
        p, tc, _t(ids), _t(labels), attn_mask=_t(mask)), _port(npp, tc))
    _bf16_close(tl, tg, float(jl), jg)


# ------------------------------------------------------------- masking

def test_mask_tokens_statistics():
    """tests/test_bert.py:26-41 on the port's generator draws."""
    _, tc = configs()
    ids = torch.as_tensor(np.random.default_rng(0).integers(0, 60, (64, 16)))
    masked, labels, weights = T.bert_mask_tokens(
        torch.Generator().manual_seed(1), ids, tc, MASK_ID, mask_prob=0.15)
    assert torch.equal(labels, ids)
    assert weights.dtype == torch.float32
    assert 0.10 < float(weights.mean()) < 0.20
    sel = weights > 0
    assert torch.equal(masked[~sel], ids[~sel])
    assert 0.6 < float((masked[sel] == MASK_ID).float().mean()) < 0.95
    assert int(masked.max()) < tc.vocab_size


def test_mask_tokens_respects_special_mask():
    _, tc = configs()
    ids = torch.as_tensor(np.random.default_rng(2).integers(0, 60, (8, 16)))
    special = torch.zeros(ids.shape, dtype=torch.bool)
    special[:, 0] = True
    _, _, weights = T.bert_mask_tokens(torch.Generator().manual_seed(3),
                                       ids, tc, MASK_ID, mask_prob=0.5,
                                       special_mask=special)
    assert float(weights[:, 0].sum()) == 0.0
    assert float(weights.sum()) > 0


def test_mask_tokens_draw_from_the_generator():
    _, tc = configs()
    ids = torch.as_tensor(np.random.default_rng(4).integers(0, 60, (8, 16)))
    a = T.bert_mask_tokens(torch.Generator().manual_seed(9), ids, tc,
                           MASK_ID)
    b = T.bert_mask_tokens(torch.Generator().manual_seed(9), ids, tc,
                           MASK_ID)
    c = T.bert_mask_tokens(torch.Generator().manual_seed(10), ids, tc,
                           MASK_ID)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[2], c[2])


# ------------------------------------------------------------- train step

def _adamw_pair(tp, lr=1e-3):
    """optax.adamw(lr) and its torch counterpart (the LM step's mapping:
    betas 0.9/0.999, eps 1e-8, decay 1e-4 on every leaf)."""
    return optax.adamw(lr), torch.optim.AdamW(
        T.param_leaves(tp), lr=lr, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=1e-4)


@pytest.mark.parametrize("with_mask", [False, True])
def test_mlm_train_step_matches_jax_step(shared, monkeypatch, with_mask):
    """One ``make_bert_mlm_train_step`` step against the JAX step on the
    same params and ids; the port's ``bert_mask_tokens`` is patched to
    return the masks the JAX step drew (a JAX key and a torch generator
    draw different numbers)."""
    jp, npp = shared
    jc, tc = configs()
    tp = _port(npp, tc)
    ids, tids, mask = _inputs(9)
    ids[:, 0] = 2                               # a CLS column
    specials = (0, 2, 3)
    mask = mask if with_mask else None
    jopt, topt = _adamw_pair(tp)
    jstep = J.make_bert_mlm_train_step(jc, jopt, MASK_ID,
                                       special_ids=specials)
    rng = jax.random.PRNGKey(11)
    # the JAX step's own draw: its key split, then bert_mask_tokens
    _, sub = jax.random.split(rng)
    jids = _j(ids)
    drawn = J.bert_mask_tokens(sub, jids, jc, MASK_ID, 0.15,
                               special_mask=jnp.isin(
                                   jids, jnp.asarray(specials)))
    seen = []

    def patched(gen, ids_t, cfg, mask_token_id, mask_prob=0.15,
                special_mask=None):
        seen.append(special_mask)
        return tuple(torch.as_tensor(np.asarray(a)).to(dt) for a, dt in
                     zip(drawn, (ids_t.dtype, ids_t.dtype, torch.float32)))

    monkeypatch.setattr(T, "bert_mask_tokens", patched)
    tstep = T.make_bert_mlm_train_step(tc, topt, MASK_ID,
                                       special_ids=specials)
    jp2, _, _, jl = jstep(jp, jopt.init(jp), rng, jids, _j(tids), _j(mask))
    tl = tstep(tp, ids, tids, mask)
    assert float(drawn[2].sum()) > 0
    np.testing.assert_array_equal(
        seen[0].numpy(), np.isin(ids, specials))   # the special mask
    np.testing.assert_allclose(float(tl), float(jl), **F32)
    jf, tf = _flat(jp2), _flat(tp)
    for k in jf:
        np.testing.assert_allclose(_np(tf[k]), np.asarray(jf[k]),
                                   err_msg=k, **GRAD)


def test_mlm_train_step_draws_fresh_masks_from_its_generator(shared):
    _, npp = shared
    _, tc = configs()
    ids, _, _ = _inputs(10)

    def run(seed, steps=3):
        tp = _port(npp, tc)
        opt = torch.optim.AdamW(T.param_leaves(tp), lr=0.0)
        step = T.make_bert_mlm_train_step(
            tc, opt, MASK_ID, mask_prob=0.3,
            generator=torch.Generator().manual_seed(seed))
        return [float(step(tp, ids)) for _ in range(steps)], step

    a, step = run(0)
    b, _ = run(0)
    c, _ = run(1)
    assert a == b                       # the generator decides the masks
    assert a != c
    assert len(set(a)) == 3             # lr 0: only the masks move it
    assert step.compiled.calls["direct"] == 3


def test_mlm_train_step_default_generator_and_loss_drops():
    """BertIterator-free pretraining on a learnable corpus (token t is
    followed by t + 1): the default generator (seed 0), loss falling as
    in tests/test_bert.py:55-71."""
    _, tc = configs()
    tp = T.bert_init(tc, torch.Generator().manual_seed(0), device="cpu")
    opt = torch.optim.Adam(T.param_leaves(tp), lr=3e-3)
    step = T.make_bert_mlm_train_step(tc, opt, MASK_ID)
    assert step.generator is None
    start = np.arange(16) % 60
    ids = (start[:, None] + np.arange(16)[None, :]) % 60
    losses = [float(step(tp, ids)) for _ in range(60)]
    assert isinstance(step.generator, torch.Generator)
    assert np.mean(losses[-5:]) < 0.75 * np.mean(losses[:5]), losses


def test_finetune_trajectory_matches_jax(shared):
    """Three Adam steps of the classifier fine-tune in both packages from
    the same params: losses within 1e-5 and params within 1e-4."""
    jp, npp = shared
    jc, tc = configs()
    tp = _port(npp, tc)
    ids, tids, mask = _inputs(12)
    labels = np.eye(2, dtype=np.float32)[
        np.random.default_rng(13).integers(0, 2, 4)]
    jopt, topt = _adamw_pair(tp, lr=1e-3)
    ost = jopt.init(jp)
    for _ in range(3):
        jl, g = jax.value_and_grad(J.bert_classifier_loss)(
            jp, jc, _j(ids), _j(labels), _j(tids), _j(mask))
        upd, ost = jopt.update(g, ost, jp)
        jp = optax.apply_updates(jp, upd)
        topt.zero_grad(set_to_none=True)
        tl = T.bert_classifier_loss(tp, tc, _t(ids), _t(labels), _t(tids),
                                    _t(mask))
        tl.backward()
        topt.step()
        np.testing.assert_allclose(float(tl.detach()), float(jl), **F32)
    jf, tf = _flat(jp), _flat(tp)
    for k in jf:
        np.testing.assert_allclose(_np(tf[k]), np.asarray(jf[k]),
                                   err_msg=k, **GRAD)
