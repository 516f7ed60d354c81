"""The port's recurrent layers and the K4 plain version against the JAX
package's, on the CPU.

Inputs and params come from numpy seeds at a small size (B ≤ 4, T ≤ 12,
H ≤ 16) and go through both sides; the JAX side's K4 runs as its own
tests run it (``fused_lstm_seq(..., True)``: the Pallas kernel in
interpret mode). Tolerances, f32: values atol 1e-5, gradients atol 1e-4
(the reference's own bars, ``tests/test_kernels.py:63-125``; the two
sides sum the recurrent products in another order). In bf16 the port's
plain version and JAX's reference round the same carries at the same
points; they are held to 2e-2 (one bf16 rounding of values of order 1,
the products summed in another order before it).

- K4: ``lstm_seq_reference`` and the ``fused_lstm_seq`` Function against
  JAX's Pallas kernel and its reference, with and without peepholes and
  with nonzero h0/c0; the Function's recompute backward against autograd
  through the plain version (bit for bit: the same ops); the capacity
  predicate at the char-RNN shape.
- Every recurrent layer against JAX from the same params, forward and
  parameter gradients, with and without a mask: SimpleRnn; LSTM and
  GravesLSTM with ``fused`` False and True (a mask routes to the scan);
  GRU with ``reset_after`` True/False and a recurrent bias; Bidirectional
  in its four modes and with ``last_step``; LastTimeStep; TimeDistributed.
- The nested-defaults repair: a global compute dtype reaches the layer
  inside Bidirectional and LastTimeStep, as in the reference.
- ``ComputationGraph.rnn_time_step`` on every cell: single steps and
  chunks reproduce ``output()`` and the JAX graph's stream (f32 1e-5;
  bf16 2e-2), a new batch restarts it, Bidirectional is refused.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.train as jtrain
import deeplearning4j_tpu_torch.nn as tnn
import deeplearning4j_tpu_torch.train as ttrain
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.layers.base import Ctx as JCtx
from deeplearning4j_tpu_torch.kernels import fused_lstm as tk4
from deeplearning4j_tpu_torch.nn import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import core as tcore
from deeplearning4j_tpu_torch.nn.layers import recurrent as trec
from deeplearning4j_tpu_torch.nn.layers.base import Ctx, apply_time_mask
from deeplearning4j_tpu_torch.train.updaters import tree_leaves

jk4 = importlib.import_module("deeplearning4j_tpu.kernels.fused_lstm")

torch.set_num_threads(2)

ATOL = 1e-5
GRAD_ATOL = 1e-4
BF16_ATOL = 2e-2


def _np(t):
    return t.detach().float().numpy()


def _k4_inputs(seed, b, t, h, peep=True, state=False):
    rng = np.random.default_rng(seed)
    xproj = rng.standard_normal((b, t, 4 * h)).astype(np.float32)
    rw = (rng.standard_normal((h, 4 * h)) * 0.3).astype(np.float32)
    p = (rng.standard_normal((3, h)) * 0.1 if peep
         else np.zeros((3, h))).astype(np.float32)
    h0 = (rng.standard_normal((b, h)) * 0.5 if state
          else np.zeros((b, h))).astype(np.float32)
    c0 = (rng.standard_normal((b, h)) if state
          else np.zeros((b, h))).astype(np.float32)
    w = rng.standard_normal((b, t, h)).astype(np.float32)
    return (xproj, rw, p, h0, c0), w


# ---------------------------------------------------------------- K4

K4_CASES = [(True, False), (False, False), (True, True), (False, True)]


@pytest.mark.parametrize("peep,state", K4_CASES)
def test_k4_plain_matches_pallas_and_reference(peep, state):
    ins, _ = _k4_inputs(0, 3, 12, 16, peep, state)
    jins = [jnp.asarray(a) for a in ins]
    pallas = np.asarray(jk4.fused_lstm_seq(*jins, True))   # interpret mode
    jref = np.asarray(jk4.lstm_seq_reference(*jins))
    ours = _np(tk4.lstm_seq_reference(*(torch.as_tensor(a) for a in ins)))
    fn = _np(tk4.fused_lstm_seq(*(torch.as_tensor(a) for a in ins)))
    np.testing.assert_allclose(ours, pallas, atol=ATOL)
    np.testing.assert_allclose(ours, jref, atol=ATOL)
    np.testing.assert_array_equal(fn, ours)


@pytest.mark.parametrize("peep,state", K4_CASES)
def test_k4_grads_match_pallas_custom_vjp(peep, state):
    ins, w = _k4_inputs(1, 2, 8, 8, peep, state)
    jins = [jnp.asarray(a) for a in ins]
    jg = jax.grad(lambda *a: jnp.sum(jk4.fused_lstm_seq(*a, True) * w),
                  argnums=(0, 1, 2, 3, 4))(*jins)
    leaves = [torch.tensor(a, requires_grad=True) for a in ins]
    out = tk4.fused_lstm_seq(*leaves)
    tg = torch.autograd.grad((out * torch.as_tensor(w)).sum(), leaves)
    for name, a, b in zip(("xproj", "rw", "peep", "h0", "c0"), tg, jg):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=GRAD_ATOL,
                                   err_msg=name)


def test_k4_function_backward_is_autograd_through_plain():
    ins, w = _k4_inputs(2, 4, 10, 16, True, True)
    wt = torch.as_tensor(w)

    def grads(fn):
        leaves = [torch.tensor(a, requires_grad=True) for a in ins]
        return torch.autograd.grad((fn(*leaves) * wt).sum(), leaves)

    for a, b in zip(grads(tk4.fused_lstm_seq),
                    grads(tk4.lstm_seq_reference)):
        assert torch.equal(a, b)


def test_k4_function_grads_only_where_needed():
    ins, w = _k4_inputs(3, 2, 5, 8, True, False)
    xp = torch.tensor(ins[0], requires_grad=True)
    rest = [torch.as_tensor(a) for a in ins[1:]]
    (g,) = torch.autograd.grad(
        (tk4.fused_lstm_seq(xp, *rest) * torch.as_tensor(w)).sum(), [xp])
    assert g.shape == xp.shape and torch.isfinite(g).all()


def test_k4_bf16_plain_matches_jax_reference():
    ins, _ = _k4_inputs(4, 3, 12, 16, True, True)
    bf = [jnp.asarray(a).astype(jnp.bfloat16) for a in ins[:2]] + \
        [jnp.asarray(ins[2])] + \
        [jnp.asarray(a).astype(jnp.bfloat16) for a in ins[3:]]
    jref = np.asarray(jk4.lstm_seq_reference(*bf).astype(jnp.float32))
    tins = [torch.as_tensor(a) for a in ins]
    tb = [tins[0].bfloat16(), tins[1].bfloat16(), tins[2],
          tins[3].bfloat16(), tins[4].bfloat16()]
    out = tk4.lstm_seq_reference(*tb)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), jref, atol=BF16_ATOL)


def test_k4_capacity_predicate():
    # the char-RNN shape: 128 blocks of 2 rows, 1024 threads
    assert tk4.fits_smem(256, 256)
    assert tk4.lstm_plan(256, 256) == (2, 4, 1024, 39936)
    assert tk4.lstm_plan(3, 40) == (1, 1, 64, 1440)
    for b, h in ((1, 1), (7, 16), (1024, 512), (64, 2048)):
        rows, ks, threads, smem = tk4.lstm_plan(b, h)
        assert threads % ks == 0 and threads <= 1024 and smem <= 232448
        assert -(-b // rows) <= 132 or rows == 4
    assert not tk4.fits_smem(4, 8192)


def test_k4_wrapper_takes_cuda_tensors_only():
    ins, _ = _k4_inputs(5, 2, 3, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tk4.lstm_seq(*(torch.as_tensor(a) for a in ins))


def test_apply_time_mask():
    y = torch.ones((2, 3, 4))
    m = torch.tensor([[1.0, 1.0, 0.0], [1.0, 0.0, 0.0]])
    out = apply_time_mask(y, m)
    assert out[:, :, 0].tolist() == m.tolist()
    assert apply_time_mask(y, None) is y


# ------------------------------------------------------------- the layers

def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), requires_grad=True)


def _mask(b, t):
    m = np.ones((b, t), np.float32)
    m[0, t - 3:] = 0.0
    m[-1, t - 1:] = 0.0
    return m


def _layer_parity(jlayer, tlayer, input_shape, seed=0, masked=False,
                  mutate=None, b=3):
    """Forward and parameter grads of one layer, JAX vs port, from the JAX
    layer's params (``mutate`` edits them first, e.g. nonzero peepholes)."""
    rng = np.random.default_rng(seed)
    jp, js, _ = jlayer.init(jax.random.PRNGKey(seed), input_shape)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    if mutate is not None:
        jp = mutate(jp, rng)
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    x = rng.standard_normal((b,) + tuple(input_shape)).astype(np.float32)
    mask = _mask(b, input_shape[0]) if masked else None
    jctx = JCtx(mask=None if mask is None else jnp.asarray(mask))
    jy, _ = jlayer.apply(jp, js, jnp.asarray(x), jctx)
    w = rng.standard_normal(jy.shape).astype(np.float32)

    def jloss(p):
        y, _ = jlayer.apply(p, js, jnp.asarray(x), jctx)
        return jnp.sum(y * w)

    jg = jax.grad(jloss)(jp)
    tp = _to_torch(jp)
    ts = jax.tree_util.tree_map(np.asarray, js)
    ctx = Ctx(mask=None if mask is None else torch.as_tensor(mask))
    ty, _ = tlayer.apply(tp, ts, torch.as_tensor(x), ctx)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=ATOL)
    leaves = tree_leaves(tp)
    tg = torch.autograd.grad((ty * torch.as_tensor(w)).sum(), leaves,
                             allow_unused=True)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(leaves)
    for a, b_ in zip(tg, jleaves):
        got = np.zeros(b_.shape, np.float32) if a is None else _np(a)
        np.testing.assert_allclose(got, np.asarray(b_), atol=GRAD_ATOL)
    return ty


def _peepholes(p, rng):
    p = dict(p)
    for k in ("pI", "pF", "pO"):
        p[k] = (rng.standard_normal(p[k].shape) * 0.2).astype(np.float32)
    return p


def _rb(p, rng):
    p = dict(p)
    p["rb"] = (rng.standard_normal(p["b"].shape) * 0.2).astype(np.float32)
    return p


@pytest.mark.parametrize("masked", [False, True])
def test_simple_rnn_matches_jax(masked):
    _layer_parity(jrec.SimpleRnn(n_in=5, n_out=7),
                  trec.SimpleRnn(n_in=5, n_out=7), (9, 5), masked=masked)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("graves", [False, True])
def test_lstm_matches_jax(graves, fused, masked):
    jcls, tcls = ((jrec.GravesLSTM, trec.GravesLSTM) if graves
                  else (jrec.LSTM, trec.LSTM))
    _layer_parity(jcls(n_in=5, n_out=8, fused=fused),
                  tcls(n_in=5, n_out=8, fused=fused), (11, 5), seed=2,
                  masked=masked, mutate=_peepholes if graves else None)


def test_lstm_fused_true_routes_through_k4_only_unmasked(monkeypatch):
    calls = []
    real = tk4.fused_lstm_seq

    def spy(*a):
        calls.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr(tk4, "fused_lstm_seq", spy)
    layer = trec.GravesLSTM(n_in=3, n_out=4, fused=True)
    p, s, _ = layer.init(torch.Generator().manual_seed(0), (6, 3))
    x = torch.randn((2, 6, 3), generator=torch.Generator().manual_seed(1))
    layer.apply(p, s, x, Ctx())
    assert calls == [(2, 6, 16)]
    layer.apply(p, s, x, Ctx(mask=torch.ones((2, 6))))
    trec.GravesLSTM(n_in=3, n_out=4, fused="auto").apply(p, s, x, Ctx())
    trec.GravesLSTM(n_in=3, n_out=4, fused=True,
                    gate_activation="hardsigmoid").apply(p, s, x, Ctx())
    assert len(calls) == 1


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("reset_after,rb", [(True, False), (True, True),
                                            (False, False)])
def test_gru_matches_jax(reset_after, rb, masked):
    _layer_parity(jrec.GRU(n_in=4, n_out=6, reset_after=reset_after),
                  trec.GRU(n_in=4, n_out=6, reset_after=reset_after),
                  (8, 4), seed=3, masked=masked,
                  mutate=_rb if rb else None)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode,last_step", [
    ("concat", False), ("add", False), ("mul", False), ("average", False),
    ("concat", True), ("average", True)])
def test_bidirectional_matches_jax(mode, last_step, masked):
    def both_peepholes(p, rng):
        return {k: _peepholes(v, rng) for k, v in p.items()}

    _layer_parity(
        jrec.Bidirectional(fwd=jrec.GravesLSTM(n_in=4, n_out=5), mode=mode,
                           last_step=last_step),
        trec.Bidirectional(fwd=trec.GravesLSTM(n_in=4, n_out=5), mode=mode,
                           last_step=last_step),
        (7, 4), seed=4, masked=masked, mutate=both_peepholes)


def test_graves_bidirectional_lstm_matches_jax():
    _layer_parity(jrec.GravesBidirectionalLSTM(n_in=3, n_out=4),
                  trec.GravesBidirectionalLSTM(n_in=3, n_out=4), (6, 3),
                  seed=5, masked=True)


@pytest.mark.parametrize("masked", [False, True])
def test_last_time_step_matches_jax(masked):
    y = _layer_parity(jrec.LastTimeStep(inner=jrec.LSTM(n_in=4, n_out=5)),
                      trec.LastTimeStep(inner=trec.LSTM(n_in=4, n_out=5)),
                      (7, 4), seed=6, masked=masked)
    assert y.shape == (3, 5)


def test_time_distributed_matches_jax():
    y = _layer_parity(
        jrec.TimeDistributed(inner=jcore.DenseLayer(n_in=4, n_out=3,
                                                    activation="tanh")),
        trec.TimeDistributed(inner=tcore.DenseLayer(n_in=4, n_out=3,
                                                    activation="tanh")),
        (5, 4), seed=7)
    assert y.shape == (3, 5, 3)


@pytest.mark.parametrize("masked", [False, True])
def test_rnn_output_layer_matches_jax(masked):
    """Forward (masked steps zeroed) and the flattened masked logits loss
    with its gradients."""
    rng = np.random.default_rng(8)
    jl = jcore.RnnOutputLayer(n_in=5, n_out=4, activation="softmax",
                              loss="mcxent")
    tl = tcore.RnnOutputLayer(n_in=5, n_out=4, activation="softmax",
                              loss="mcxent")
    jp, _, out = jl.init(jax.random.PRNGKey(0), (6, 5))
    assert tl.init(torch.Generator(), (6, 5))[2] == out == (6, 4)
    x = rng.standard_normal((3, 6, 5)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (3, 6))]
    m = _mask(3, 6) if masked else None
    jy, _ = jl.apply(jp, {}, jnp.asarray(x),
                     JCtx(mask=None if m is None else jnp.asarray(m)))
    tp = _to_torch(jp)
    tm = None if m is None else torch.as_tensor(m)
    ty, _ = tl.apply(tp, {}, torch.as_tensor(x), Ctx(mask=tm))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=ATOL)
    jloss, jg = jax.value_and_grad(lambda p: jl.compute_loss(
        p, jnp.asarray(x), jnp.asarray(y),
        mask=None if m is None else jnp.asarray(m)))(jp)
    tloss = tl.compute_loss(tp, torch.as_tensor(x), torch.as_tensor(y),
                            mask=tm)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), atol=ATOL)
    tg = torch.autograd.grad(tloss, [tp["W"], tp["b"]])
    np.testing.assert_allclose(_np(tg[0]), np.asarray(jg["W"]),
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(_np(tg[1]), np.asarray(jg["b"]),
                               atol=GRAD_ATOL)


@pytest.mark.parametrize("cls", ["SimpleRnn", "LSTM", "GravesLSTM", "GRU"])
def test_step_apply_matches_apply(cls):
    """The streaming single step (rnn_time_step's cell) walked over t
    equals the layer's whole-sequence apply."""
    layer = getattr(trec, cls)(n_in=3, n_out=5)
    p, s, _ = layer.init(torch.Generator().manual_seed(0), (6, 3))
    x = torch.randn((2, 6, 3), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        full, _ = layer.apply(p, s, x, Ctx())
        carry = layer.init_carry(2, x.dtype)
        steps = []
        for t in range(6):
            y, carry = layer.step_apply(p, carry, x[:, t], Ctx())
            steps.append(y)
    torch.testing.assert_close(torch.stack(steps, 1), full, atol=1e-6,
                               rtol=0)


# ----------------------------------------------------- nested defaults

def _nested_confs(jmod, tmod, jbuilder, tbuilder):
    jc = (jbuilder.list()
          .layer(jmod.Bidirectional(fwd=jmod.GravesLSTM(n_in=3, n_out=4)))
          .layer(jmod.LastTimeStep(inner=jmod.LSTM(n_in=8, n_out=4)))
          .build())
    tc = (tbuilder.list()
          .layer(tmod.Bidirectional(fwd=tmod.GravesLSTM(n_in=3, n_out=4)))
          .layer(tmod.LastTimeStep(inner=tmod.LSTM(n_in=8, n_out=4)))
          .build())
    return jc, tc


def test_global_defaults_reach_wrapped_layers():
    """Bidirectional(GravesLSTM) and LastTimeStep(LSTM) under a global
    bf16 compute dtype, weight init and L2: the wrapped layer gets them,
    as in the reference (which recurses into ``fwd``/``inner``)."""
    jc, tc = _nested_confs(
        jrec, trec,
        JNNC.builder().data_type(jnp.float32, jnp.bfloat16)
        .weight_init("relu").l2(1e-3),
        NeuralNetConfiguration.builder()
        .data_type(torch.float32, torch.bfloat16).weight_init("relu")
        .l2(1e-3))
    jinner = [jc.layers[0].fwd, jc.layers[1].inner]
    tinner = [tc.layers[0].fwd, tc.layers[1].inner]
    for j, t in zip(jinner, tinner):
        assert j.compute_dtype == jnp.bfloat16
        assert t.compute_dtype == torch.bfloat16
        assert (t.weight_init, t.l2) == (j.weight_init, j.l2) == ("relu",
                                                                   1e-3)
    x = torch.randn((2, 5, 3), generator=torch.Generator().manual_seed(0))
    layer = tc.layers[0]
    p, s, _ = layer.init(torch.Generator().manual_seed(0), (5, 3))
    y, _ = layer.apply(p, s, x, Ctx())
    assert y.dtype == torch.bfloat16


# ------------------------------------------------ ComputationGraph streaming

def _rnn_graph(m, t, make, seed=11, compute_dtype=None):
    """in → recurrent node → RnnOutputLayer, as a ComputationGraph."""
    b = m.NeuralNetConfiguration.builder().seed(seed).updater(t.Adam(1e-3))
    if compute_dtype is not None:
        b = b.data_type(jnp.float32 if m is jnn else torch.float32,
                        compute_dtype)
    g = b.graph_builder().add_inputs("in")
    g.add_layer("rnn", make(m), "in")
    g.add_layer("out", m.RnnOutputLayer(n_in=6, n_out=4,
                                        activation="softmax",
                                        loss="mcxent"), "rnn")
    g.set_outputs("out")
    return m.ComputationGraph(g.build())


_CELLS = {"SimpleRnn": lambda m: m.SimpleRnn(n_in=3, n_out=6),
          "LSTM": lambda m: m.LSTM(n_in=3, n_out=6),
          "GravesLSTM": lambda m: m.GravesLSTM(n_in=3, n_out=6),
          "GRU": lambda m: m.GRU(n_in=3, n_out=6)}


def _graph_pair(cell, compute=(None, None)):
    jnet = _rnn_graph(jnn, jtrain, _CELLS[cell],
                      compute_dtype=compute[0]).init([(5, 3)])
    tnet = _rnn_graph(tnn, ttrain, _CELLS[cell],
                      compute_dtype=compute[1]).init([(5, 3)], device="cpu")
    tnet.params, tnet.states = tnn.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.states), "cpu")
    return jnet, tnet


@pytest.mark.parametrize("cell", sorted(_CELLS))
def test_cg_rnn_time_step_matches_full_forward(cell):
    """ComputationGraph.rnn_time_step (tests/test_layers.py:249 on a
    graph) fed one step at a time, then in two chunks, reproduces
    output() over the whole sequence, and the JAX graph's stream."""
    rng = np.random.default_rng(7)
    jnet, net = _graph_pair(cell)
    x = rng.standard_normal((2, 5, 3)).astype(np.float32)
    full = _np(net.output(x))
    np.testing.assert_allclose(full, np.asarray(jnet.output(x)), atol=ATOL)
    net.rnn_clear_previous_state()
    jnet.rnn_clear_previous_state()
    got = np.stack([_np(net.rnn_time_step(x[:, t, :])) for t in range(5)], 1)
    want = np.stack([np.asarray(jnet.rnn_time_step(x[:, t, :]))
                     for t in range(5)], 1)
    np.testing.assert_allclose(got, full, atol=ATOL)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert net._rnn_stream_fn.last == "direct"
    net.rnn_clear_previous_state()
    first = _np(net.rnn_time_step(x[:, :3, :]))
    rest = _np(net.rnn_time_step(x[:, 3:, :]))
    np.testing.assert_allclose(np.concatenate([first, rest], axis=1), full,
                               atol=ATOL)
    net.rnn_clear_previous_state()
    again = _np(net.rnn_time_step(x[:, 0, :]))
    np.testing.assert_allclose(again, full[:, 0], atol=ATOL)
    # a new batch size restarts the stream
    one = _np(net.rnn_time_step(x[:1, 0, :]))
    np.testing.assert_allclose(one, full[:1, 0], atol=ATOL)


def test_cg_rnn_time_step_bf16_and_refusals():
    """tests/test_layers.py:288 on a graph: a bf16 compute dtype streams
    (finite, within 2e-2 of the JAX graph's stream), and a Bidirectional
    node is refused with the reference's message."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 5, 3)).astype(np.float32)
    jnet, net = _graph_pair("LSTM", (jnp.bfloat16, torch.bfloat16))
    y = net.rnn_time_step(x[:, 0, :])
    assert y.shape == (2, 4) and bool(torch.isfinite(y.float()).all())
    np.testing.assert_allclose(
        _np(y), np.asarray(jnet.rnn_time_step(x[:, 0, :]), np.float32),
        atol=BF16_ATOL)
    b = tnn.NeuralNetConfiguration.builder().seed(2)
    g = b.graph_builder().add_inputs("in")
    g.add_layer("bi", tnn.Bidirectional(fwd=tnn.LSTM(n_in=3, n_out=6)), "in")
    g.add_layer("out", tnn.RnnOutputLayer(n_in=12, n_out=4,
                                          activation="softmax",
                                          loss="mcxent"), "bi")
    g.set_outputs("out")
    netbi = tnn.ComputationGraph(g.build()).init([(5, 3)], device="cpu")
    with pytest.raises(NotImplementedError, match="Bidirectional"):
        netbi.rnn_time_step(x[:, 0, :])
