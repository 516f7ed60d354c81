"""The port's DL4J attention layers against the JAX package's, on the
CPU: ``multi_head_attention`` (key masks, causal, Tq != Tk, values from
a third input), ``SelfAttentionLayer`` with ``impl="pallas"`` (the
port's flash wrapper, which on a CPU tensor runs its plain version)
against the reference's ``impl="pallas_interpret"`` (its Pallas kernel
in interpret mode), ``LearnedSelfAttentionLayer``,
``RecurrentAttentionLayer``, ``AttentionVertex`` (1, 2 and 3 inputs,
``project_input=False``) inside a ComputationGraph, and a
MultiLayerNetwork trained through the attention layer.

The JAX layer's params go to the port with ``nn.params_from_numpy``.
Tolerances, f32: values atol 1e-5, gradients and fit losses atol 1e-4
(the Pallas kernel's blockwise softmax sums in another order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.data as jdata
import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.train as jtrain
import deeplearning4j_tpu_torch.data as tdata
import deeplearning4j_tpu_torch.nn as tnn
import deeplearning4j_tpu_torch.train as ttrain
from deeplearning4j_tpu.nn.layers import attention as jatt
from deeplearning4j_tpu.nn.layers.base import Ctx as JCtx
from deeplearning4j_tpu_torch.kernels import flash_attention as fa
from deeplearning4j_tpu_torch.nn import params_from_numpy
from deeplearning4j_tpu_torch.nn.layers import attention as tatt
from deeplearning4j_tpu_torch.nn.layers.base import Ctx
from deeplearning4j_tpu_torch.train.updaters import tree_leaves

torch.set_num_threads(2)

ATOL = 1e-5
GRAD_ATOL = 1e-4


def _np(t):
    return t.detach().float().numpy()


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _run(jl, tl, in_shape, x, mask=None, grads=True, jimpl=None):
    jp, js, jout = jl.init(jax.random.PRNGKey(0), in_shape)
    _, _, tout = tl.init(torch.Generator().manual_seed(0), in_shape)
    assert tuple(tout) == tuple(jout)
    tp, ts = params_from_numpy(_np_tree(jp), _np_tree(js), "cpu")
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.as_tensor(mask)
    yj, _ = jl.apply(jp, js, jnp.asarray(x), JCtx(mask=jm))
    xt = torch.as_tensor(x).requires_grad_(True)
    yt, _ = tl.apply(tp, ts, xt, Ctx(mask=tm))
    np.testing.assert_allclose(_np(yt), np.asarray(yj), atol=ATOL)
    if grads:
        g = np.random.default_rng(1).standard_normal(yj.shape).astype(
            np.float32)
        jg = jax.grad(lambda p, xx: jnp.sum(
            jl.apply(p, js, xx, JCtx(mask=jm))[0] * g), argnums=(0, 1))(
            jp, jnp.asarray(x))
        tg = torch.autograd.grad((yt * torch.as_tensor(g)).sum(),
                                 tree_leaves(tp) + [xt])
        jls = jax.tree_util.tree_leaves(jg[0]) + [jg[1]]
        for a, b in zip(jls, tg):
            np.testing.assert_allclose(_np(b), np.asarray(a),
                                       atol=GRAD_ATOL)
    return yt


def _x(b=2, t=16, c=32, seed=0):
    return np.random.default_rng(seed).standard_normal((b, t, c)).astype(
        np.float32)


@pytest.mark.parametrize("causal", [False, True])
def test_self_attention_flash_route_matches_pallas_interpret(causal,
                                                             monkeypatch):
    """``impl="pallas"`` in the port against the reference's Pallas kernel
    in interpret mode: values and grads, and the port went through the
    flash wrapper."""
    calls = []
    real = fa.flash_attention_ntc

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)
    monkeypatch.setattr(fa, "flash_attention_ntc", spy)
    jl = jatt.SelfAttentionLayer(n_in=32, n_out=32, n_heads=4,
                                 is_causal=causal, impl="pallas_interpret")
    tl = tatt.SelfAttentionLayer(n_in=32, n_out=32, n_heads=4,
                                 is_causal=causal, impl="pallas")
    _run(jl, tl, (16, 32), _x())
    assert calls and calls[0] == (2, 16, 4, 8)


def test_self_attention_plain_and_masked(monkeypatch):
    """A key mask takes the plain attention in both packages, with or
    without ``impl``; so does ``impl=None``."""
    called = []
    monkeypatch.setattr(fa, "flash_attention_ntc",
                        lambda *a, **k: called.append(1))
    mask = np.ones((2, 16), np.float32)
    mask[0, 11:] = 0
    mask[1, 5:] = 0
    for impl in (None, "pallas"):
        jl = jatt.SelfAttentionLayer(n_in=32, n_out=24, n_heads=3,
                                     impl=None)
        tl = tatt.SelfAttentionLayer(n_in=32, n_out=24, n_heads=3,
                                     impl=impl)
        _run(jl, tl, (16, 32), _x(), mask=mask)
        _run(jatt.SelfAttentionLayer(n_in=32, n_out=24, n_heads=3,
                                     is_causal=True),
             tatt.SelfAttentionLayer(n_in=32, n_out=24, n_heads=3,
                                     is_causal=True), (16, 32), _x())
    assert not called


def test_multi_head_attention_cross_and_values():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 5, 8)).astype(np.float32)
    kv = rng.standard_normal((2, 7, 8)).astype(np.float32)
    v = rng.standard_normal((2, 7, 6)).astype(np.float32)
    params = {"Wq": rng.standard_normal((8, 12)), "Wk":
              rng.standard_normal((8, 12)), "Wv": rng.standard_normal((6, 12)),
              "Wo": rng.standard_normal((12, 4))}
    params = {k: a.astype(np.float32) * 0.3 for k, a in params.items()}
    mask = np.ones((2, 7), np.float32)
    mask[1, 4:] = 0
    for m in (None, mask):
        yj = jatt.multi_head_attention(
            {k: jnp.asarray(a) for k, a in params.items()}, jnp.asarray(q),
            jnp.asarray(kv), 3, 4,
            mask=None if m is None else jnp.asarray(m), v_in=jnp.asarray(v))
        yt = tatt.multi_head_attention(
            {k: torch.as_tensor(a) for k, a in params.items()},
            torch.as_tensor(q), torch.as_tensor(kv), 3, 4,
            mask=None if m is None else torch.as_tensor(m),
            v_in=torch.as_tensor(v), impl="pallas")
        np.testing.assert_allclose(_np(yt), np.asarray(yj), atol=ATOL)


def test_learned_and_recurrent_attention():
    mask = np.ones((2, 9), np.float32)
    mask[1, 6:] = 0
    for m in (None, mask):
        _run(jatt.LearnedSelfAttentionLayer(n_out=12, n_heads=2,
                                            n_queries=3),
             tatt.LearnedSelfAttentionLayer(n_out=12, n_heads=2,
                                            n_queries=3),
             (9, 10), _x(t=9, c=10), mask=m)
        _run(jatt.RecurrentAttentionLayer(n_out=6, n_heads=2),
             tatt.RecurrentAttentionLayer(n_out=6, n_heads=2),
             (9, 10), _x(t=9, c=10), mask=m)


def _vertex_graph(nn, train, n_inputs, project=True):
    g = (nn.NeuralNetConfiguration.builder().seed(5)
         .updater(train.Adam(1e-2)).graph_builder())
    names = ["q", "k", "v"][:n_inputs]
    g.add_inputs(*names)
    g.add_layer("att", nn.AttentionVertex(
        n_out=0 if not project else 8, n_heads=2 if project else 1,
        project_input=project), *names)
    g.add_layer("pool", nn.GlobalPoolingLayer(pooling_type="avg"), "att")
    g.add_layer("out", nn.OutputLayer(n_out=3, activation="softmax",
                                      loss="mcxent"), "pool")
    g.set_outputs("out")
    return g.build()


@pytest.mark.parametrize("n_inputs,project", [(1, True), (2, True),
                                              (3, True), (2, False)])
def test_attention_vertex_in_graph(n_inputs, project):
    """AttentionVertex as a multi-input layer of a ComputationGraph:
    output and three fit steps against the JAX graph."""
    rng = np.random.default_rng(0)
    shapes = [(6, 8), (7, 8), (7, 5)][:n_inputs]
    if n_inputs == 2 and not project:
        shapes = [(6, 8), (7, 8)]
    jnet = jnn.ComputationGraph(_vertex_graph(jnn, jtrain, n_inputs,
                                              project)).init(shapes)
    tnet = tnn.ComputationGraph(_vertex_graph(tnn, ttrain, n_inputs,
                                              project)).init(shapes,
                                                             device="cpu")
    tnet.params, tnet.states = params_from_numpy(
        _np_tree(jnet.params), _np_tree(jnet.states), "cpu")
    xs = [rng.standard_normal((4,) + s).astype(np.float32) for s in shapes]
    np.testing.assert_allclose(_np(tnet.output(*xs)),
                               np.asarray(jnet.output(*xs)), atol=ATOL)
    for _ in range(3):
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
        lj = jnet.fit(jdata.MultiDataSet(xs, [y]))
        lt = tnet.fit(tdata.MultiDataSet(xs, [y]))
        assert abs(lt - lj) <= GRAD_ATOL


def _attn_net(nn, train, impl, causal=True, compute_dtype=None):
    b = nn.NeuralNetConfiguration.builder().seed(2).updater(
        train.Adam(1e-2))
    if compute_dtype is not None:
        b.data_type(torch.float32 if nn is tnn else jnp.float32,
                    compute_dtype)
    return (b.list()
            .layer(nn.SelfAttentionLayer(n_out=32, n_heads=4,
                                         is_causal=causal, impl=impl))
            .layer(nn.RnnOutputLayer(n_out=5, activation="softmax",
                                     loss="mcxent"))
            .build())


@pytest.mark.parametrize("causal", [True, False])
def test_attention_net_fit_matches_jax(causal):
    """A MultiLayerNetwork trained through SelfAttentionLayer: the port's
    flash route (plain version here) against the reference's Pallas
    kernel in interpret mode, three Adam steps."""
    jnet = jnn.MultiLayerNetwork(_attn_net(jnn, jtrain, "pallas_interpret",
                                           causal)).init((16, 32))
    tnet = tnn.MultiLayerNetwork(_attn_net(tnn, ttrain, "pallas",
                                           causal)).init((16, 32),
                                                         device="cpu")
    tnet.params, tnet.states = params_from_numpy(
        _np_tree(jnet.params), _np_tree(jnet.states), "cpu")
    rng = np.random.default_rng(0)
    for _ in range(3):
        x = rng.standard_normal((2, 16, 32)).astype(np.float32)
        y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (2, 16))]
        lj = jnet.fit(jdata.DataSet(x, y))
        lt = tnet.fit(tdata.DataSet(x, y))
        assert abs(lt - lj) <= GRAD_ATOL
    for a, b in zip(jax.tree_util.tree_leaves(jnet.params),
                    tree_leaves(tnet.params)):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=GRAD_ATOL)


def test_attention_net_bf16_trains_on_the_host():
    net = tnn.MultiLayerNetwork(_attn_net(
        tnn, ttrain, "pallas", compute_dtype=torch.bfloat16)).init(
        (16, 32), device="cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (2, 16))]
    losses = [net.fit(tdata.DataSet(x, y)) for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
