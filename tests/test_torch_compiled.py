"""The compiled train step of the port (``nn/_compiled.py``), its in-place
updaters and ``fit_scanned`` against the JAX package, on the CPU.

On the CPU a compiled step calls its static step directly — the very code
that CUDA captures into a graph — so these tests hold that code:

- the five cases of ``tests/test_fit_scanned.py`` (MLN ``fit_scanned``
  against ``fit``, the listener replay, the inputs it rejects, CG
  ``fit_scanned``, BN state threading), each against the reference's
  ``fit_scanned`` on shared weights (losses and final params and states
  within 1e-5) and the port's own ``fit`` (bit for bit). The reference's
  nets drop their dropout: the port trains without it (not ported), and
  dropout is no part of what ``fit_scanned`` promises. ``nn/listeners.py``
  is not ported yet, so the port's side collects scores with a listener
  defined here, held against the reference's ``CollectScoresListener``;
- every ``_foreach`` updater against optax through the JAX package's
  ``build_optimizer``, 5 steps within 1e-6: Sgd, Momentum, Nesterovs,
  Adam, AdamW, a frozen label, a per-layer updater and each gradient
  normalization kind; the state is updated in place;
- the static step over 3 steps, called through its ``CompiledStep``,
  against the same step called directly (bit for bit) and the JAX
  package (1e-5; the LM 1e-4, AdamW's tolerance in
  ``test_torch_train.py``), for an MLN with an LSTM, a CG with BN and the
  LM;
- the LM with ``tie_embeddings=True``: ``lm_loss`` and its grads, fused
  and unfused, and greedy ``generate`` against the JAX package.
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.train.updaters as jupd
import deeplearning4j_tpu_torch as tpkg
import deeplearning4j_tpu_torch.nn as tnn
import deeplearning4j_tpu_torch.train.updaters as tupd
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.computation_graph import \
    ComputationGraph as JComputationGraph
from deeplearning4j_tpu.zoo import transformer as jtfm
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.nn import params_from_numpy
from deeplearning4j_tpu_torch.nn._compiled import (CompiledStep,
                                                   graphs_enabled, tensors)
from deeplearning4j_tpu_torch.zoo import transformer as ttfm

torch.set_num_threads(2)


def _import_dynamo_beside_onnx_stub():
    """``torch.utils.checkpoint`` (the LM's remat and fused loss) imports
    ``torch._dynamo``, whose import breaks on the spec-less ``onnx`` stub
    that the ONNX import tests leave in ``sys.modules``: import it with
    the stub set aside (as ``test_torch_train.py`` does)."""
    stub = sys.modules.pop("onnx", None)
    try:
        import torch._dynamo  # noqa: F401
    finally:
        if stub is not None:
            sys.modules["onnx"] = stub


_import_dynamo_beside_onnx_stub()

ATOL = 1e-5
UPDATER_ATOL = 1e-6


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _leaves(tree):
    return tupd.tree_leaves(tree)


def _leaves_of(state):
    """The tensors of an updater's state (dicts and tuples)."""
    return tensors(state)


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _assert_close_to_jax(tree, jtree, atol=ATOL):
    jl = jax.tree_util.tree_leaves(jtree)
    tl = _leaves(tree)
    assert len(jl) == len(tl)
    for x, y in zip(tl, jl):
        np.testing.assert_allclose(x.detach().numpy(), np.asarray(y),
                                   atol=atol)


class _Scores:
    """Collects (iteration, score) pairs; takes deferred scores."""
    deferred_score_ok = True

    def __init__(self):
        self.iterations, self.scores = [], []

    def iteration_done(self, model, iteration, epoch, score):
        self.iterations.append(iteration)
        self.scores.append(score)


class _Strict:
    """A listener that reads model state at each step (not deferred)."""

    def iteration_done(self, model, iteration, epoch, score):
        pass


# ----------------------------------------------------------- fit_scanned

def _batches(k=6, b=8, seed=0):
    r = np.random.default_rng(seed)
    return [(r.random((b, 20)).astype(np.float32),
             np.eye(4, dtype=np.float32)[r.integers(0, 4, b)])
            for _ in range(k)]


def _mln_conf(nn, train, bn=False, seed=5):
    # with BN after it, the dense bias's grad is rounding noise, which
    # Adam would scale up to the learning rate: Momentum keeps it noise
    b = (nn.NeuralNetConfiguration.builder().seed(seed)
         .updater(train.Momentum(0.1, 0.9) if bn else train.Adam(1e-3))
         .list()
         .layer(nn.DenseLayer(n_in=20, n_out=16,
                              activation="identity" if bn else "relu")))
    if bn:
        b = b.layer(nn.BatchNormalization(activation="relu"))
    return b.layer(nn.OutputLayer(n_in=16, n_out=4,
                                  activation="softmax")).build()


def _cg_conf(nn, train):
    b = (nn.NeuralNetConfiguration.builder().seed(9)
         .updater(train.Adam(1e-3)).graph_builder().add_inputs("in"))
    b.add_layer("d", nn.DenseLayer(n_in=20, n_out=16, activation="relu"),
                "in")
    b.add_layer("out", nn.OutputLayer(n_in=16, n_out=4,
                                      activation="softmax"), "d")
    b.set_outputs("out")
    return b.build()


def _nets(kind):
    """The reference net and two port nets with its params and states."""
    import deeplearning4j_tpu.train as jtrain
    import deeplearning4j_tpu_torch.train as ttrain
    if kind == "cg":
        jnet = JComputationGraph(_cg_conf(jnn, jtrain)).init([(20,)])
        mk = lambda: tnn.ComputationGraph(  # noqa: E731
            _cg_conf(tnn, ttrain)).init([(20,)], device="cpu")
    else:
        bn = kind == "bn"
        jnet = jnn.MultiLayerNetwork(_mln_conf(jnn, jtrain, bn)).init((20,))
        mk = lambda: tnn.MultiLayerNetwork(  # noqa: E731
            _mln_conf(tnn, ttrain, bn)).init((20,), device="cpu")
    nets = []
    for _ in range(2):
        net = mk()
        net.params, net.states = params_from_numpy(
            _np_tree(jnet.params), _np_tree(jnet.states), "cpu")
        nets.append(net)
    return jnet, nets


@pytest.mark.parametrize("kind", ["mln", "cg", "bn"])
def test_fit_scanned_matches_fit_and_the_reference(kind):
    """MLN (``test_fit_scanned_matches_fit_bitwise``), CG
    (``test_cg_fit_scanned_matches_fit_bitwise``) and an MLN with a BN
    layer (``test_fit_scanned_threads_bn_state``), 2 epochs of 6 batches:
    the port's ``fit_scanned`` equals its ``fit`` bit for bit in params
    and running states, and the reference's ``fit_scanned`` within 1e-5
    in loss, params and states."""
    data = _batches()
    jnet, (a, b) = _nets(kind)
    jl = jnet.fit_scanned([JDataSet(x, y) for x, y in data], epochs=2)
    la = a.fit([DataSet(x, y) for x, y in data], epochs=2)
    lb = b.fit_scanned([DataSet(x, y) for x, y in data], epochs=2)
    assert la == lb
    _assert_trees_equal(a.params, b.params)
    _assert_trees_equal(a.states, b.states)
    assert abs(lb - jl) <= ATOL
    _assert_close_to_jax(b.params, jnet.params)
    _assert_close_to_jax(b.states, jnet.states)
    assert (b._step_count, b.epoch_count) == (12, 2) == \
        (jnet._step_count, jnet.epoch_count)


def test_fit_scanned_listener_replay():
    """12 iterations replayed after the two epochs, numbered as the
    reference numbers them, with the reference's scores (1e-5) and the
    port's ``fit`` scores (bit for bit)."""
    data = _batches()
    jnet, (a, b) = _nets("mln")
    jlis = jnn.CollectScoresListener()
    jnet.set_listeners(jlis)
    jnet.fit_scanned([JDataSet(x, y) for x, y in data], epochs=2)
    alis, blis = _Scores(), _Scores()
    a.set_listeners(alis)
    b.set_listeners(blis)
    a.fit([DataSet(x, y) for x, y in data], epochs=2)
    b.fit_scanned([DataSet(x, y) for x, y in data], epochs=2)
    assert len(blis.scores) == 12
    assert blis.iterations == alis.iterations == jlis.iterations
    assert blis.scores == alis.scores
    np.testing.assert_allclose(blis.scores, jlis.scores, atol=ATOL)


def test_fit_scanned_rejects_unsupported():
    """A listener that is not deferred, unequal shapes and a masked batch
    raise ValueError on both sides, before any step."""
    data = _batches()
    jnet, (net, _) = _nets("mln")
    jnet.set_listeners(jnn.EvaluativeListener(
        JDataSet(*data[0]), frequency=1))
    net.set_listeners(_Strict())
    for n, ds in ((jnet, JDataSet), (net, DataSet)):
        with pytest.raises(ValueError, match="per-.?iteration"):
            n.fit_scanned([ds(x, y) for x, y in data])
        n.set_listeners()
    r = np.random.default_rng(1)
    ragged = data + [(r.random((4, 20)).astype(np.float32),
                      np.eye(4, dtype=np.float32)[r.integers(0, 4, 4)])]
    masked = (data[0][0], data[0][1], None, np.ones((8, 1), np.float32))
    before = [t.clone() for t in _leaves(net.params)]
    for n, ds in ((jnet, JDataSet), (net, DataSet)):
        with pytest.raises(ValueError, match="equally-shaped"):
            n.fit_scanned([ds(x, y) for x, y in ragged])
        with pytest.raises(ValueError, match="masked"):
            n.fit_scanned([ds(*masked)])
    assert net._step_count == 0
    _assert_trees_equal(dict(enumerate(before)),
                        dict(enumerate(_leaves(net.params))))


# -------------------------------------------------------------- updaters

def _tree(rng):
    return {"a": {"W": rng.standard_normal((3, 4)).astype(np.float32),
                  "b": rng.standard_normal(4).astype(np.float32)},
            "c": {},
            "d": {"gamma": rng.standard_normal(5).astype(np.float32)}}


_LABELS = {"a": {"W": "__default__", "b": "__default__"}, "c": {},
           "d": {"gamma": "__d__"}}
UPDATER_CASES = {
    "sgd": lambda u: dict(updater=u.Sgd(0.1)),
    "momentum": lambda u: dict(updater=u.Momentum(0.1, 0.9)),
    "nesterovs": lambda u: dict(updater=u.Nesterovs(0.05, 0.8)),
    "adam": lambda u: dict(updater=u.Adam(1e-2)),
    "adamw": lambda u: dict(updater=u.AdamW(1e-2, weight_decay=0.1)),
    "frozen_label": lambda u: dict(
        updater=u.Adam(1e-2), param_labels=_LABELS,
        per_label_updaters={"__default__": u.Adam(1e-2),
                            "__d__": u.NoOp()}),
    "per_layer_updater": lambda u: dict(
        updater=u.Adam(1e-2), param_labels=_LABELS,
        per_label_updaters={"__default__": u.Adam(1e-2),
                            "__d__": u.Nesterovs(0.05, 0.9)}),
    **{f"grad_norm_{kind}": (lambda kind: lambda u: dict(
        updater=u.Momentum(0.1, 0.9), grad_norm=kind,
        grad_norm_threshold=0.5))(kind)
       for kind in ("renormalize_l2_per_layer",
                    "renormalize_l2_per_param_type",
                    "clip_element_wise_absolute_value",
                    "clip_l2_per_layer", "clip_l2_per_param_type")},
}


@pytest.mark.parametrize("case", sorted(UPDATER_CASES))
def test_foreach_updaters_match_optax(case):
    """5 steps through ``build_optimizer`` on both sides: params within
    1e-6 at every step. The port's update overwrites the grads it was
    handed and its state tensors in place, and a step allocates no new
    state."""
    kw = UPDATER_CASES[case]
    jopt = jupd.build_optimizer(**kw(jupd))
    topt = tupd.build_optimizer(**kw(tupd))
    rng = np.random.default_rng(21)
    p0 = _tree(rng)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = jopt.init(jp)
    tp = tupd.tree_map(lambda a: torch.tensor(a), p0)
    ts = topt.init(tp)
    state_leaves = _leaves_of(ts)
    counts = [t for t in state_leaves if t.dtype == torch.int32]
    for step in range(5):
        g = _tree(rng)
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tg = tupd.tree_map(lambda a: torch.tensor(a), g)
        tu, ts2 = topt.update(tg, ts, tp)
        assert ts2 is ts and tu is tg
        assert all(a is b for a, b in zip(_leaves_of(ts), state_leaves))
        tupd.apply_updates(_leaves(tp), _leaves(tu))
        _assert_close_to_jax(tp, jp, atol=UPDATER_ATOL)
    for c in counts:                     # Adam's step count, on device
        assert c.shape == () and int(c) == 5


# ---------------------------------------------------------- static steps

def _charnn_conf(nn, train):
    return (nn.NeuralNetConfiguration.builder().seed(0)
            .updater(train.Adam(5e-3)).list()
            .layer(nn.LSTM(n_in=7, n_out=12))
            .layer(nn.RnnOutputLayer(n_in=12, n_out=7, activation="softmax",
                                     loss="mcxent"))
            .build())


def _cg_bn_conf(nn, train):
    b = (nn.NeuralNetConfiguration.builder().seed(3)
         .updater(train.Momentum(0.1, 0.9)).graph_builder()
         .add_inputs("in"))
    b.add_layer("d", nn.DenseLayer(n_in=20, n_out=16,
                                   activation="identity"), "in")
    b.add_layer("bn", nn.BatchNormalization(activation="relu"), "d")
    b.add_layer("out", nn.OutputLayer(n_in=16, n_out=4,
                                      activation="softmax"), "bn")
    b.set_outputs("out")
    return b.build()


def _static_nets(kind):
    import deeplearning4j_tpu.train as jtrain
    import deeplearning4j_tpu_torch.train as ttrain
    r = np.random.default_rng(4)
    if kind == "mln_lstm":
        jnet = jnn.MultiLayerNetwork(_charnn_conf(jnn, jtrain)).init((5, 7))
        mk = lambda: tnn.MultiLayerNetwork(  # noqa: E731
            _charnn_conf(tnn, ttrain)).init((5, 7), device="cpu")
        eye = np.eye(7, dtype=np.float32)
        data = [(eye[r.integers(0, 7, (3, 5))], eye[r.integers(0, 7, (3, 5))])
                for _ in range(3)]
    else:
        jnet = JComputationGraph(_cg_bn_conf(jnn, jtrain)).init([(20,)])
        mk = lambda: tnn.ComputationGraph(  # noqa: E731
            _cg_bn_conf(tnn, ttrain)).init([(20,)], device="cpu")
        data = _batches(k=3, seed=5)
    nets = []
    for _ in range(2):
        net = mk()
        net.params, net.states = params_from_numpy(
            _np_tree(jnet.params), _np_tree(jnet.states), "cpu")
        nets.append(net)
    return jnet, nets, data


@pytest.mark.parametrize("kind", ["mln_lstm", "cg_bn"])
def test_static_step_trajectory(kind):
    """3 steps of the net's compiled step (on the CPU: its static step,
    called directly) against ``_train_step`` called by hand: losses,
    params, states and the updater's state bit for bit; and against the
    reference's ``fit`` within 1e-5. Params and states stay the same
    tensors (updated in place)."""
    jnet, (a, b), data = _static_nets(kind)
    a.fit([DataSet(*data[0])])        # builds the optimizer, one step
    b.fit([DataSet(*data[0])])
    jnet.fit([JDataSet(*data[0])])
    ids = [id(t) for t in _leaves(b.params) + _leaves(b.states)]
    step = a._compiled_step()
    assert isinstance(step, CompiledStep)
    calls = step.calls["direct"]
    for x, y in data[1:]:
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        la = step(x, y, None, None)
        lb = (b._train_step({"in": x}, {"out": y}, None, None)
              if kind == "cg_bn" else b._train_step(x, y, None, None))
        assert torch.equal(la, lb)
        jl = jnet.fit(JDataSet(np.asarray(x), np.asarray(y)))
        assert abs(float(la) - jl) <= ATOL
    assert step.calls["direct"] == calls + 2 and step.last == "direct"
    _assert_trees_equal(a.params, b.params)
    _assert_trees_equal(a.states, b.states)
    assert all(torch.equal(p, q) for p, q in zip(_leaves_of(a._opt_state),
                                                  _leaves_of(b._opt_state)))
    assert ids == [id(t) for t in _leaves(b.params) + _leaves(b.states)]
    _assert_close_to_jax(a.params, jnet.params)
    _assert_close_to_jax(a.states, jnet.states)


LM = dict(vocab_size=61, d_model=32, n_heads=2, n_layers=2, d_ff=64,
          max_seq=64, attn_scores_bf16=False)


def _lm_configs(**kw):
    base = dict(LM, **kw)
    return (jtfm.TransformerConfig(dtype=jnp.float32, **base),
            ttfm.TransformerConfig(dtype=torch.float32, **base))


def _lm_batch(seed, shape=(2, 24)):
    r = np.random.default_rng(seed)
    return (r.integers(0, LM["vocab_size"], shape).astype(np.int32),
            r.integers(0, LM["vocab_size"], shape).astype(np.int32))


def test_lm_static_step_trajectory():
    """3 steps of ``make_train_step`` (fused loss, remat "save_attn",
    AdamW) against the same step written out by hand — ``zero_grad``,
    ``lm_loss``, ``backward``, ``optimizer.step`` — bit for bit, and
    against the JAX package's ``make_train_step`` with ``optax.adamw``
    within 1e-4. Under ``disable_graphs()`` the step runs the same way."""
    jcfg, tcfg = _lm_configs(fused_loss=True, loss_chunk=20, remat=True,
                             remat_policy="save_attn")
    jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    tree = _np_tree(jp)
    pa = ttfm.params_from_numpy(tree, tcfg, device="cpu")
    pb = ttfm.params_from_numpy(tree, tcfg, device="cpu")
    kw = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    oa = torch.optim.AdamW(ttfm.param_leaves(pa), **kw)
    ob = torch.optim.AdamW(ttfm.param_leaves(pb), **kw)
    step = ttfm.make_train_step(tcfg, oa)
    jopt = optax.adamw(1e-3)
    jstate = jopt.init(jp)
    jstep = jtfm.make_train_step(jcfg, jopt)
    for i in range(3):
        ids, tgt = _lm_batch(i)
        if i == 1:
            with tpkg.disable_graphs():
                la = step(pa, ids, tgt)
        else:
            la = step(pa, ids, tgt)
        ob.zero_grad(set_to_none=True)
        lb = ttfm.lm_loss(pb, tcfg, torch.as_tensor(ids).long(),
                          torch.as_tensor(tgt).long())
        lb.backward()
        ob.step()
        assert torch.equal(la, lb.detach())
        jp, jstate, jl = jstep(jp, jstate, jnp.asarray(ids),
                               jnp.asarray(tgt))
        np.testing.assert_allclose(la.item(), float(jl), atol=1e-4)
    assert step.compiled.calls["direct"] == 3
    for x, y in zip(ttfm.param_leaves(pa), ttfm.param_leaves(pb)):
        assert torch.equal(x, y)
    _assert_close_to_jax(pa, jp, atol=1e-4)


def test_compiled_step_on_cpu_calls_its_step_directly():
    """A CPU batch never captures: every call runs the static step and
    returns what it returns; ``disable_graphs`` nests."""
    seen = []
    step = CompiledStep(lambda x, m: seen.append((x, m)) or x.sum(),
                        lambda: [], "test")
    x = torch.ones(3)
    assert step(x, None) == 3 and seen == [(x, None)]
    with tpkg.disable_graphs():
        with tpkg.disable_graphs():
            assert step(x, None) == 3
        assert not graphs_enabled()
    assert graphs_enabled()
    assert step.calls == {"direct": 2, "eager": 0, "capture": 0,
                          "replay": 0}


# ------------------------------------------------------- tied embeddings

@pytest.mark.parametrize("fused", [True, False])
def test_tied_embeddings_loss_grads_and_generate_match_jax(fused):
    """``tie_embeddings=True`` (the head is ``embed.T``, no ``head``
    leaf): ``lm_loss`` and every grad (the embedding's collects the head's
    share) against ``jax.value_and_grad`` within 1e-5, fused chunked CE
    or the full logits, and greedy ``generate`` token for token."""
    jcfg, tcfg = _lm_configs(tie_embeddings=True, fused_loss=fused,
                             loss_chunk=20, remat=False)
    jp = jtfm.init_params(jax.random.PRNGKey(1), jcfg)
    assert "head" not in jp
    tree = _np_tree(jp)
    tp = ttfm.params_from_numpy(tree, tcfg, device="cpu")
    ttfm.param_leaves(tp)                # every leaf requires grad
    ids, tgt = _lm_batch(7)
    jl, jg = jax.value_and_grad(jtfm.lm_loss)(jp, jcfg, jnp.asarray(ids),
                                              jnp.asarray(tgt))
    loss = ttfm.lm_loss(tp, tcfg, torch.as_tensor(ids).long(),
                        torch.as_tensor(tgt).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), atol=ATOL)
    _assert_close_to_jax({k: v for k, v in _grads(tp).items()},
                         jg, atol=ATOL)
    prompt = ids[:, :5]
    want = jtfm.generate(jp, jcfg, jnp.asarray(prompt), 6)
    got = ttfm.generate(tp, tcfg, prompt, 6, device="cpu")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _grads(tree):
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    return tree.grad
