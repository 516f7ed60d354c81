"""The port's MoE blocks and ring attention against the JAX package's
(``zoo/transformer.py`` ``_moe_mlp``, ``parallel/ring_attention.py``,
``make_ring_train_step``; the ring and MoE cases of
``tests/test_parallel.py``).

In this process: ``_moe_mlp`` (values, aux loss and gradients, with a
capacity that drops tokens) and the MoE LM's forward against the JAX
functions on shared weights, and the ring's per-hop step over the chunks
of one sequence against monolithic attention. Over gloo at world 4 (ranks
spawned once for the file, importing the port only): ``ring_attention``
on (dp, sp) meshes, plain and through the flash wrapper's lse, forward
and gradients; the ring train step against the JAX monolithic step; the
MoE LM's sharded loss and gradients over dp, dp × ep and dp × tp, with
the capacity and aux loss of the global batch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning4j_tpu.zoo import transformer as jtfm
from deeplearning4j_tpu_torch.parallel.ring_attention import ring_hop
from deeplearning4j_tpu_torch.zoo import transformer as ttfm

from torch_parallel_ranks import RankPool

torch.set_num_threads(2)
WORLD = 4


@pytest.fixture(scope="module")
def pool():
    p = RankPool(WORLD)
    yield p
    p.close()


def close(got, want, **tol):
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), **tol), got, want)


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


# ----------------------------------------------------------------- MoE

MOE = dict(vocab_size=61, d_model=16, n_heads=2, n_layers=2, d_ff=32,
           max_seq=8, n_experts=4, expert_top_k=2)


def _moe_cfgs(**over):
    kw = dict(MOE, **over)
    return (jtfm.TransformerConfig(**kw, dtype=jnp.float32, remat=False),
            ttfm.TransformerConfig(**kw, dtype=torch.float32, remat=False))


def _kept(cfg, x, router):
    """How many (token, choice) rows the reference's capacity keeps."""
    n = x.shape[0] * x.shape[1]
    gates = jax.nn.softmax(x.reshape(n, -1) @ router, -1)
    _, topi = jax.lax.top_k(gates, cfg.expert_top_k)
    oh = jax.nn.one_hot(topi, cfg.n_experts).reshape(-1, cfg.n_experts)
    pos = jnp.cumsum(oh, 0) - 1
    cap = max(1, int(cfg.capacity_factor * n * cfg.expert_top_k
                     / cfg.n_experts))
    return int(((pos < cap) & (oh > 0)).sum()), n * cfg.expert_top_k


@pytest.mark.parametrize("capacity", [1.25, 0.5])
def test_moe_mlp_matches_jax(capacity):
    """Values, aux loss and the gradients of x, the router and both
    expert tensors; at capacity 0.5 the capacity drops tokens."""
    jcfg, tcfg = _moe_cfgs(capacity_factor=capacity)
    p = jtfm.init_params(jax.random.PRNGKey(0), jcfg)["blocks"]
    w = [p[k][0] for k in ("router", "we_in", "we_out")]
    x = np.random.default_rng(0).standard_normal((4, 8, 16)).astype(
        np.float32)
    kept, total = _kept(jcfg, jnp.asarray(x), w[0])
    if capacity < 1:
        assert kept < total

    def jf(x_, *w_):
        out, aux = jtfm._moe_mlp(jcfg, x_, *w_)
        return jnp.sum(out ** 2) + aux
    jout, jaux = jax.jit(lambda *a: jtfm._moe_mlp(jcfg, *a))(
        jnp.asarray(x), *w)
    jg = jax.jit(jax.grad(jf, argnums=(0, 1, 2, 3)))(jnp.asarray(x), *w)
    tx = torch.tensor(x, requires_grad=True)
    tw = [torch.tensor(np.asarray(a), requires_grad=True) for a in w]
    tout, taux = ttfm._moe_mlp(tcfg, tx, *tw)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    tg = torch.autograd.grad((tout ** 2).sum() + taux, [tx, *tw])
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_moe_top_k_ties_in_index_order():
    """Equal gates (a zero router) pick the lowest expert ids first, as
    ``lax.top_k``."""
    g = torch.full((3, 4), 0.25)
    v, i = ttfm._top_k(g, 2)
    jv, ji = jax.lax.top_k(jnp.full((3, 4), 0.25), 2)
    assert i.tolist() == np.asarray(ji).tolist()


def test_moe_forward_and_balance():
    """The MoE LM's forward: logits of the JAX forward, a live aux loss,
    the loss of ``lm_loss``; and ``init_params`` draws the experts'
    tensors in the reference's layout."""
    jcfg, tcfg = _moe_cfgs()
    jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = ttfm.params_from_numpy(_np(jp), tcfg, device="cpu")
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 8), 0,
                                        61))
    jl, ja = jax.jit(lambda p, i: jtfm.forward(p, jcfg, i))(
        jp, jnp.asarray(ids))
    tl, ta = ttfm.forward(tp, tcfg, torch.tensor(ids))
    assert tuple(tl.shape) == (4, 8, 61) and float(ta) > 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)
    mine = ttfm.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    assert {k: tuple(v.shape) for k, v in mine["blocks"].items()} == \
        {k: tuple(v.shape) for k, v in jp["blocks"].items()}


def test_moe_dp_ep_tp_match_single(pool):
    """The MoE LM's step over dp4, dp2 × ep2 and dp2 × tp2: the global
    batch's loss (capacity over its tokens, in token-major order) and the
    gradients of the single-device function."""
    jcfg, _ = _moe_cfgs(capacity_factor=0.5)
    params = jtfm.init_params(jax.random.PRNGKey(3), jcfg)
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 8), 0,
                                        61))
    tgt = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (8, 8), 0,
                                        61))
    ref, grads = jax.jit(jax.value_and_grad(lambda p: jtfm.lm_loss(
        p, jcfg, jnp.asarray(ids), jnp.asarray(tgt))))(params)
    meshes = [{"dp": 4}, {"dp": 2, "ep": 2}, {"dp": 2, "tp": 2}]
    r = pool.run("moe_dp", {"cfg": dict(MOE, capacity_factor=0.5),
                            "params": _np(params), "ids": ids, "tgt": tgt,
                            "meshes": meshes})
    for x in r:
        for m in meshes:
            assert abs(x[str(m)]["loss"] - float(ref)) < 2e-5, m
            close(x[str(m)]["grads"], grads["blocks"], atol=1e-5)


# ---------------------------------------------------------------- ring

def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _ref(q, k, v, causal):
    return jax.nn.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), is_causal=causal)


def _ref_grads(q, k, v):
    return jax.grad(lambda a, b, c: jnp.sum(jax.nn.dot_product_attention(
        a, b, c, is_causal=True) ** 2), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


def _payload(runs, **arrays):
    p = {"runs": runs}
    for name, (q, k, v, grads) in arrays.items():
        p.update({name + "_q": q, name + "_k": k, name + "_v": v,
                  name + "_grads": grads})
    return p


def test_ring_attention_exact(pool):
    q, k, v = _qkv(0, (4, 32, 2, 8))
    runs = [("a", {"dp": 2, "sp": 2}, c, False) for c in (True, False)]
    r = pool.run("ring", _payload(runs, a=(q, k, v, False)))
    for x in r:
        for causal in (True, False):
            got = x[f"a/{causal}/False"]["out"]
            assert np.abs(got - np.asarray(_ref(q, k, v, causal))).max() \
                < 2e-5


def test_ring_attention_long_context(pool):
    """Exact at T 4096 over sp4, and at T 16384 finite with the first
    block equal to local causal attention."""
    q, k, v = _qkv(1, (1, 4096, 2, 8))
    q2, k2, v2 = _qkv(2, (1, 16384, 1, 8))
    runs = [("a", {"sp": 4}, True, False), ("b", {"sp": 4}, True, False)]
    r = pool.run("ring", _payload(runs, a=(q, k, v, False),
                                  b=(q2, k2, v2, False)), timeout=240)
    got = r[0]["a/True/False"]["out"]
    assert np.abs(got - np.asarray(_ref(q, k, v, True))).max() < 5e-5
    out = r[0]["b/True/False"]["out"]
    assert out.shape == (1, 16384, 1, 8) and np.isfinite(out).all()
    blk = 2048
    local = _ref(q2[:, :blk], k2[:, :blk], v2[:, :blk], True)
    assert np.abs(out[:, :blk] - np.asarray(local)).max() < 5e-5


def test_ring_attention_flash_path_exact(pool):
    """The ring through the flash wrapper's lse (its plain version on the
    CPU), forward and the q/k/v gradients of sum(out²): the merge feeds
    the lse cotangent into the flash backward."""
    q, k, v = _qkv(7, (2, 32, 2, 8))
    runs = [("a", {"dp": 2, "sp": 2}, c, True) for c in (True, False)]
    r = pool.run("ring", _payload(runs, a=(q, k, v, True)))
    for causal in (True, False):
        got = r[0][f"a/{causal}/True"]["out"]
        assert np.abs(got - np.asarray(_ref(q, k, v, causal))).max() < 2e-5
    for a, b in zip(r[0]["a/True/True"]["grads"], _ref_grads(q, k, v)):
        assert np.abs(a - np.asarray(b)).max() < 5e-4


def test_ring_attention_xla_path_grads(pool):
    q, k, v = _qkv(8, (2, 32, 2, 8))
    runs = [("a", {"dp": 1, "sp": 4}, True, False)]
    r = pool.run("ring", _payload(runs, a=(q, k, v, True)))
    for x in r:
        for a, b in zip(x["a/True/False"]["grads"], _ref_grads(q, k, v)):
            assert np.abs(a - np.asarray(b)).max() < 5e-5


def test_ring_hop_over_chunks_matches_monolithic():
    """One device: ``ring_hop`` over 4 chunks of a causal sequence (the
    flash wrapper's lse on the CPU) equals monolithic attention, forward
    and gradients — the per-hop step chip_smoke.py runs on the card."""
    q, k, v = (torch.tensor(a, requires_grad=True)
               for a in _qkv(3, (2, 64, 2, 8)))
    n, t = 4, 16
    outs = []
    for i in range(n):
        qi = q[:, i * t:(i + 1) * t]
        acc = None
        for j in range(i, -1, -1):
            acc = ring_hop(acc, qi, k[:, j * t:(j + 1) * t],
                                 v[:, j * t:(j + 1) * t],
                                 "diag" if j == i else "full",
                                 use_flash=True)
        outs.append(acc[0])
    got = torch.cat(outs, 1)
    ref = _ref(q.detach().numpy(), k.detach().numpy(), v.detach().numpy(),
               True)
    assert (got.detach().numpy() - np.asarray(ref)).__abs__().max() < 2e-5
    g = torch.autograd.grad((got ** 2).sum(), [q, k, v])
    for a, b in zip(g, _ref_grads(*(t_.detach().numpy()
                                    for t_ in (q, k, v)))):
        assert np.abs(a.numpy() - np.asarray(b)).max() < 5e-5


def test_ring_train_step_matches_monolithic(pool):
    """``make_ring_train_step`` over dp2 × sp2 (the ring, per-shard
    position offsets, loss and gradients over both axes) equals the JAX
    monolithic step for two steps; its guards refuse the dense flag, MoE
    and a sequence past the position table."""
    kw = dict(vocab_size=61, d_model=32, n_heads=2, n_layers=2, d_ff=64,
              max_seq=32)
    cfg = jtfm.TransformerConfig(**kw, dtype=jnp.float32, remat=False,
                                 fused_loss=False)
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 61, (4, 32))
    tgt = rng.integers(0, 61, (4, 32))
    params = jtfm.init_params(jax.random.PRNGKey(0), cfg)
    opt = optax.adam(1e-2)
    step = jax.jit(jtfm.make_train_step(cfg, opt))
    p, o = params, opt.init(params)
    losses = []
    for _ in range(2):
        p, o, loss = step(p, o, jnp.asarray(ids), jnp.asarray(tgt))
        losses.append(float(loss))
    r = pool.run("ring_train_step", {"cfg": kw, "params": _np(params),
                                     "ids": ids, "tgt": tgt})
    for x in r:
        np.testing.assert_allclose(x["losses"], losses, atol=1e-5)
        close(x["params"], p, rtol=2e-4, atol=2e-5)
        assert all(x["guards"].values()), x["guards"]
