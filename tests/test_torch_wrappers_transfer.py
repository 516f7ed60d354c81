"""The port's wrapper layers and transfer learning against the JAX
package's, on the CPU: ``FrozenLayer`` (no gradient to its params, the
gradient through it kept), ``TimeDistributedLayer``, ``MaskZeroLayer``,
``RepeatVector``; ``TransferLearning.Builder`` and ``.GraphBuilder``
(freeze, nOutReplace, remove, graft, copies not aliases) and
``TransferLearningHelper`` (featurize, fit_featurized).

Nets are compared after syncing the port's params from the JAX net with
``nn.params_from_numpy`` (re-initialized layers draw from different
generators in the two packages). Tolerances, f32: values atol 1e-5,
gradients and params after fit steps atol 1e-4; frozen params must stay
bit for bit.
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
from deeplearning4j_tpu.nn.layers import wrappers as jwrap
from deeplearning4j_tpu.nn.layers.base import Ctx as JCtx
from deeplearning4j_tpu_torch.nn import params_from_numpy
from deeplearning4j_tpu_torch.nn.layers import wrappers as twrap
from deeplearning4j_tpu_torch.nn.layers.base import Ctx
from deeplearning4j_tpu_torch.train.updaters import tree_leaves

torch.set_num_threads(2)

ATOL = 1e-5
GRAD_ATOL = 1e-4
R = np.random.default_rng(0)
X = R.standard_normal((32, 6)).astype(np.float32)
Y = np.eye(3, dtype=np.float32)[R.integers(0, 3, 32)]


def _np(t):
    return t.detach().float().numpy()


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _sync(jnet, tnet):
    tnet.params, tnet.states = params_from_numpy(
        _np_tree(jnet.params), _np_tree(jnet.states), "cpu")


def _assert_close(jtree, ttree, atol):
    jl, tl = jax.tree_util.tree_leaves(jtree), tree_leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=atol)


# ------------------------------------------------------------- wrappers
def _wrapped(kind, pkg):
    nn = jnn if pkg == "jax" else tnn
    w = jwrap if pkg == "jax" else twrap
    inner = nn.DenseLayer(n_out=4, activation="tanh")
    if kind == "frozen":
        return w.FrozenLayer(layer=inner)
    if kind == "time":
        return w.TimeDistributedLayer(layer=inner)
    if kind == "maskzero":
        return w.MaskZeroLayer(layer=nn.SimpleRnn(n_out=4), mask_value=0.5)
    return w.RepeatVector(n=3)


@pytest.mark.parametrize("kind,shape", [("frozen", (5,)),
                                        ("time", (7, 5)),
                                        ("maskzero", (7, 5)),
                                        ("repeat", (5,))])
def test_wrappers_match_jax(kind, shape):
    jl, tl = _wrapped(kind, "jax"), _wrapped(kind, "torch")
    jp, js, jout = jl.init(jax.random.PRNGKey(0), shape)
    _, _, tout = tl.init(torch.Generator().manual_seed(0), shape)
    assert tuple(tout) == tuple(jout)
    tp, ts = params_from_numpy(_np_tree(jp), _np_tree(js), "cpu")
    x = R.standard_normal((2,) + shape).astype(np.float32)
    mask = np.array([[1, 1, 1, 1, 0, 0, 0], [1, 1, 1, 1, 1, 1, 1]],
                    np.float32) if kind == "maskzero" else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.as_tensor(mask)
    yj, _ = jl.apply(jp, js, jnp.asarray(x), JCtx(mask=jm))
    xt = torch.as_tensor(x).requires_grad_(True)
    yt, _ = tl.apply(tp, ts, xt, Ctx(mask=tm))
    np.testing.assert_allclose(_np(yt), np.asarray(yj), atol=ATOL)
    g = R.standard_normal(yj.shape).astype(np.float32)
    jg = jax.grad(lambda p, xx: jnp.sum(jl.apply(
        p, js, xx, JCtx(mask=jm))[0] * g), argnums=(0, 1))(
        jp, jnp.asarray(x))
    leaves = tree_leaves(tp)
    tg = torch.autograd.grad((yt * torch.as_tensor(g)).sum(),
                             leaves + [xt], allow_unused=True)
    for a, b in zip(jax.tree_util.tree_leaves(jg[0]) + [jg[1]], tg):
        b = torch.zeros(a.shape) if b is None else b
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=GRAD_ATOL)
    if kind == "frozen":
        assert tl.frozen and tl.layer.frozen
        assert all(g is None for g in tg[:len(leaves)])
        assert float(np.abs(_np(tg[-1])).sum()) > 0   # flows through


def _frozen_mln(nn, train):
    return (nn.NeuralNetConfiguration.builder().seed(4)
            .updater(train.Adam(1e-2)).list()
            .layer(nn.FrozenLayer(layer=nn.DenseLayer(n_out=8,
                                                      activation="relu")))
            .layer(nn.DenseLayer(n_out=6, activation="tanh"))
            .layer(nn.OutputLayer(n_out=3, activation="softmax",
                                  loss="mcxent")).build())


def test_frozen_layer_in_a_net_fits_like_jax():
    jnet = jnn.MultiLayerNetwork(_frozen_mln(jnn, jtrain)).init((6,))
    tnet = tnn.MultiLayerNetwork(_frozen_mln(tnn, ttrain)).init(
        (6,), device="cpu")
    _sync(jnet, tnet)
    w0 = tnet.params["layer_0"]["W"].detach().clone()
    for _ in range(3):
        lj = jnet.fit(jdata.DataSet(X, Y))
        lt = tnet.fit(tdata.DataSet(X, Y))
        assert abs(lt - lj) <= ATOL
    assert torch.equal(tnet.params["layer_0"]["W"], w0)
    _assert_close(jnet.params, tnet.params, GRAD_ATOL)


# ------------------------------------------------------- transfer (MLN)
def _src_conf(nn, train):
    return (nn.NeuralNetConfiguration.builder().seed(7)
            .updater(train.Adam(1e-2)).list()
            .layer(nn.DenseLayer(n_in=6, n_out=10, activation="relu"))
            .layer(nn.DenseLayer(n_in=10, n_out=8, activation="tanh"))
            .layer(nn.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                  loss="mcxent")).build())


def _src_pair():
    jnet = jnn.MultiLayerNetwork(_src_conf(jnn, jtrain)).init((6,))
    tnet = tnn.MultiLayerNetwork(_src_conf(tnn, ttrain)).init(
        (6,), device="cpu")
    _sync(jnet, tnet)
    jnet.fit(X, Y, epochs=2)
    tnet.fit(X, Y, epochs=2)
    _assert_close(jnet.params, tnet.params, GRAD_ATOL)
    return jnet, tnet


def _mln_builder(nn, train, src, kind):
    b = nn.TransferLearning.Builder(src)
    if kind == "replace":
        return (b.fine_tune_configuration(
            nn.FineTuneConfiguration(updater=train.Sgd(1e-2)))
                .set_feature_extractor(0).nout_replace(2, 5)
                .set_input_shape((6,)).build())
    return (b.remove_output_layer()
            .add_layer(nn.DenseLayer(n_in=8, n_out=4, activation="relu"))
            .add_layer(nn.OutputLayer(n_in=4, n_out=2, activation="softmax",
                                      loss="mcxent"))
            .set_input_shape((6,)).build())


@pytest.mark.parametrize("kind", ["replace", "graft"])
def test_mln_transfer_matches_jax(kind):
    jsrc, tsrc = _src_pair()
    jnew = _mln_builder(jnn, jtrain, jsrc, kind)
    tnew = _mln_builder(tnn, ttrain, tsrc, kind)
    assert len(tnew.layers) == len(jnew.layers)
    assert [lyr.frozen for lyr in tnew.layers] == \
        [lyr.frozen for lyr in jnew.layers]
    kept = (0, 1) if kind == "replace" else (0, 1)
    for i in kept:   # retained weights copied, not aliased
        w = tnew.params[f"layer_{i}"]["W"]
        assert torch.equal(w, tsrc.params[f"layer_{i}"]["W"])
        assert w.data_ptr() != tsrc.params[f"layer_{i}"]["W"].data_ptr()
    _sync(jnew, tnew)
    n_out = 5 if kind == "replace" else 2
    y = np.eye(n_out, dtype=np.float32)[R.integers(0, n_out, 32)]
    w0 = tnew.params["layer_0"]["W"].detach().clone()
    for _ in range(3):
        lj = jnew.fit(jdata.DataSet(X, y))
        lt = tnew.fit(tdata.DataSet(X, y))
        assert abs(lt - lj) <= GRAD_ATOL
    _assert_close(jnew.params, tnew.params, GRAD_ATOL)
    if kind == "replace":
        assert torch.equal(tnew.params["layer_0"]["W"], w0)
    assert tuple(tnew.output(X).shape) == (32, n_out)
    # the source is untouched by the new net's training
    _assert_close(jsrc.params, tsrc.params, GRAD_ATOL)


# ---------------------------------------------------- transfer (graph)
def _src_graph(nn, train):
    b = (nn.NeuralNetConfiguration.builder().seed(3)
         .updater(train.Adam(1e-2)).graph_builder())
    b.add_inputs("in")
    b.add_layer("trunk", nn.DenseLayer(n_in=6, n_out=10, activation="relu"),
                "in")
    b.add_layer("mid", nn.DenseLayer(n_in=10, n_out=8, activation="tanh"),
                "trunk")
    b.add_layer("out", nn.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                      loss="mcxent"), "mid")
    b.set_outputs("out")
    return b.build()


def _graph_pair():
    jnet = jnn.ComputationGraph(_src_graph(jnn, jtrain)).init([(6,)])
    tnet = tnn.ComputationGraph(_src_graph(tnn, ttrain)).init(
        [(6,)], device="cpu")
    _sync(jnet, tnet)
    return jnet, tnet


@pytest.mark.parametrize("kind", ["freeze_head", "nout", "same_name"])
def test_graph_transfer_matches_jax(kind):
    jsrc, tsrc = _graph_pair()

    def build(nn, train, src):
        b = nn.TransferLearning.GraphBuilder(src)
        if kind == "freeze_head":
            return (b.fine_tune_configuration(
                nn.FineTuneConfiguration(updater=train.Sgd(1e-2)))
                .set_feature_extractor("mid")
                .remove_vertex_and_connections("out")
                .add_layer("new_out", nn.OutputLayer(
                    n_in=8, n_out=4, activation="softmax", loss="mcxent"),
                    "mid")
                .set_outputs("new_out").build())
        if kind == "nout":
            return b.nout_replace("mid", 12).build()
        return (b.remove_vertex_and_connections("out")
                .add_layer("out", nn.OutputLayer(
                    n_in=8, n_out=2, activation="softmax", loss="mcxent"),
                    "mid").build())

    jnew, tnew = build(jnn, jtrain, jsrc), build(tnn, ttrain, tsrc)
    assert tnew.conf.outputs == jnew.conf.outputs
    assert tnew.conf.topo_order == jnew.conf.topo_order
    for name, node in tnew.conf.nodes.items():
        assert node.op.frozen == jnew.conf.nodes[name].op.frozen
        for k, v in tnew.params[name].items():
            assert tuple(v.shape) == jnew.params[name][k].shape
    assert torch.equal(tnew.params["trunk"]["W"], tsrc.params["trunk"]["W"])
    _sync(jnew, tnew)
    n_out = {"freeze_head": 4, "nout": 3, "same_name": 2}[kind]
    y = np.eye(n_out, dtype=np.float32)[R.integers(0, n_out, 32)]
    wt = tnew.params["trunk"]["W"].detach().clone()
    for _ in range(3):
        lj = jnew.fit(jdata.DataSet(X, y))
        lt = tnew.fit(tdata.DataSet(X, y))
        assert abs(lt - lj) <= GRAD_ATOL
    _assert_close(jnew.params, tnew.params, GRAD_ATOL)
    if kind == "freeze_head":
        assert torch.equal(tnew.params["trunk"]["W"], wt)


def test_graph_transfer_validation_errors():
    _, tsrc = _graph_pair()
    with pytest.raises(ValueError, match="still consume"):
        tnn.TransferLearning.GraphBuilder(tsrc) \
            .remove_vertex_and_connections("mid").build()
    with pytest.raises(ValueError, match="unknown feature-extractor"):
        tnn.TransferLearning.GraphBuilder(tsrc) \
            .set_feature_extractor("nope").build()
    with pytest.raises(ValueError, match="no layer"):
        tnn.TransferLearning.GraphBuilder(tsrc).nout_replace("x", 3).build()


# ----------------------------------------------------------- the helper
def test_transfer_learning_helper_matches_jax():
    jsrc, tsrc = _src_pair()
    jfroz = jnn.TransferLearning.Builder(jsrc).set_feature_extractor(
        0).set_input_shape((6,)).build()
    tfroz = tnn.TransferLearning.Builder(tsrc).set_feature_extractor(
        0).set_input_shape((6,)).build()
    _sync(jfroz, tfroz)
    jh = jnn.TransferLearningHelper(jfroz)
    th = tnn.TransferLearningHelper(tfroz)
    jf = jh.featurize(jdata.DataSet(X, Y))
    tf = th.featurize(tdata.DataSet(X, Y))
    np.testing.assert_allclose(_np(tf.features), np.asarray(jf.features),
                               atol=ATOL)
    w0 = tfroz.params["layer_0"]["W"].detach().clone()
    for _ in range(3):
        lj = jh.fit_featurized(jf)
        lt = th.fit_featurized(tf)
        assert abs(lt - lj) <= GRAD_ATOL
    # the head trained in place on the source's tensors; the trunk did not
    assert torch.equal(tfroz.params["layer_0"]["W"], w0)
    _assert_close(jfroz.params, tfroz.params, GRAD_ATOL)
    np.testing.assert_allclose(
        _np(th.output_from_featurized(tf.features)),
        np.asarray(jh.output_from_featurized(jf.features)), atol=GRAD_ATOL)
    assert th.unfrozen_mln() is th._head
    with pytest.raises(ValueError, match="no frozen PREFIX"):
        tnn.TransferLearningHelper(tsrc)
