"""The port's SameDiff layers (``deeplearning4j_tpu_torch/nn/layers/
samediff_layer.py``) against the JAX package's: ``tests/
test_samediff_layers.py`` mirrored, each layer run on the JAX layer's
params and the same seeded inputs in both (outputs and losses 1e-5,
grads 1e-5), inside a MultiLayerNetwork and a ComputationGraph fit; the
mask rules of ``SameDiffOutputLayer``; a user graph that needs the host
makes the network's steps eager (``CompiledStep(eager=True)``)."""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu_torch.nn as tnn
from deeplearning4j_tpu.data import DataSet as JDataSet
from deeplearning4j_tpu.nn.computation_graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.multi_layer_network import \
    MultiLayerNetwork as JMLN
from deeplearning4j_tpu.train import Adam as JAdam
from deeplearning4j_tpu_torch.data import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.train import Adam

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(0)
GEN = torch.Generator().manual_seed(0)
ATOL = 1e-5


def _dense_cls(base):
    @dataclass
    class MyDense(base):
        """Custom dense+relu, the canonical SameDiffLayer example."""

        n_in: int = 4
        n_out: int = 8

        def define_parameters(self, p):
            p.add_weight_param("W", self.n_in, self.n_out)
            p.add_bias_param("b", self.n_out)

        def define_layer(self, sd, x, params, mask=None):
            return sd.nn.relu(sd.nn.linear(x, params["W"], params["b"]))
    return MyDense


def _softmax_out_cls(base):
    @dataclass
    class MySoftmaxOut(base):
        n_in: int = 8
        n_out: int = 3

        def define_parameters(self, p):
            p.add_weight_param("W", self.n_in, self.n_out)
            p.add_bias_param("b", self.n_out)

        def define_layer(self, sd, x, labels, params):
            logits = sd.nn.linear(x, params["W"], params["b"]).rename(
                "logits")
            sd.nn.softmax(logits).rename("out")
            return sd.loss.softmax_cross_entropy(labels, logits).rename(
                "loss")

        def activations_vertex_name(self):
            return "out"
    return MySoftmaxOut


def _masked_mse_cls(base):
    @dataclass
    class MaskedMseOut(base):
        n_in: int = 4
        n_out: int = 2

        def define_parameters(self, p):
            p.add_weight_param("W", self.n_in, self.n_out)

        def define_layer(self, sd, x, labels, params, mask=None):
            pred = x.mmul(params["W"]).rename("out")
            se = ((pred - labels) ** 2.0).sum(-1)
            if mask is not None:
                return ((se * mask).sum() / mask.sum()).rename("loss")
            return se.mean().rename("loss")

        def activations_vertex_name(self):
            return "out"
    return MaskedMseOut


def _bilinear_cls(base):
    @dataclass
    class BilinearMerge(base):
        n_in1: int = 4
        n_in2: int = 4
        n_out: int = 8

        def define_parameters(self, p):
            p.add_weight_param("W1", self.n_in1, self.n_out)
            p.add_weight_param("W2", self.n_in2, self.n_out)
            p.add_bias_param("b", self.n_out)

        def define_vertex(self, sd, inputs, params):
            x1, x2 = inputs
            return sd.nn.relu(x1.mmul(params["W1"]) + x2.mmul(params["W2"])
                              + params["b"])
    return BilinearMerge


JDense, TDense = _dense_cls(jnn.SameDiffLayer), _dense_cls(tnn.SameDiffLayer)
JOut = _softmax_out_cls(jnn.SameDiffOutputLayer)
TOut = _softmax_out_cls(tnn.SameDiffOutputLayer)
JMse = _masked_mse_cls(jnn.SameDiffOutputLayer)
TMse = _masked_mse_cls(tnn.SameDiffOutputLayer)
JBil = _bilinear_cls(jnn.SameDiffVertex)
TBil = _bilinear_cls(tnn.SameDiffVertex)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def test_samediff_layer_matches_dense_and_the_reference():
    jl, tl = JDense(n_in=4, n_out=8), TDense(n_in=4, n_out=8)
    jp, js, jshape = jl.init(KEY, (4,))
    tp, ts, tshape = tl.init(GEN, (4,))
    assert tshape == jshape == (8,)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    x = np.random.default_rng(0).standard_normal((5, 4)).astype(np.float32)
    yj, _ = jl.apply(jp, js, jnp.asarray(x), jnn.Ctx())
    yt, _ = tl.apply(_t(jp), ts, torch.from_numpy(x), tnn.Ctx())
    np.testing.assert_allclose(_np(yt), np.asarray(yj), atol=ATOL)
    ref = np.maximum(x @ np.asarray(jp["W"]) + np.asarray(jp["b"]), 0)
    np.testing.assert_allclose(_np(yt), ref, rtol=1e-6, atol=1e-6)


def test_samediff_layer_grads_match_the_reference():
    jl, tl = JDense(n_in=3, n_out=4), TDense(n_in=3, n_out=4)
    jp, js, _ = jl.init(KEY, (3,))
    x = np.random.default_rng(1).standard_normal((2, 3)).astype(np.float32)

    def jloss(p):
        y, _ = jl.apply(p, js, jnp.asarray(x), jnn.Ctx())
        return jnp.sum(jnp.square(y))

    gj = jax.grad(jloss)(jp)
    tp = {k: v.requires_grad_() for k, v in _t(jp).items()}
    y, _ = tl.apply(tp, {}, torch.from_numpy(x), tnn.Ctx())
    gt = torch.autograd.grad(torch.sum(torch.square(y)), [tp["W"], tp["b"]])
    np.testing.assert_allclose(_np(gt[0]), np.asarray(gj["W"]), atol=ATOL)
    np.testing.assert_allclose(_np(gt[1]), np.asarray(gj["b"]), atol=ATOL)
    # and a numeric check of the port's own grad
    eps = 1e-3
    W = np.asarray(jp["W"], np.float64)
    for idx in [(0, 0), (2, 3), (1, 2)]:
        Wp, Wm = W.copy(), W.copy()
        Wp[idx] += eps
        Wm[idx] -= eps
        num = (float(jloss({"W": jnp.asarray(Wp, jnp.float32),
                            "b": jp["b"]}))
               - float(jloss({"W": jnp.asarray(Wm, jnp.float32),
                              "b": jp["b"]}))) / (2 * eps)
        np.testing.assert_allclose(num, float(gt[0][idx]), rtol=5e-2,
                                   atol=1e-4)


def _mln_pair(first, second, seed=7, lr=5e-2):
    j = (jnn.NeuralNetConfiguration.builder().seed(seed).updater(JAdam(lr))
         .list().layer(first[0]).layer(second[0])
         .set_input_type(jnn.InputType.feed_forward(4)).build())
    t = (tnn.NeuralNetConfiguration.builder().seed(seed).updater(Adam(lr))
         .list().layer(first[1]).layer(second[1])
         .set_input_type(tnn.InputType.feed_forward(4)).build())
    jnet = JMLN(j).init()
    tnet = tnn.MultiLayerNetwork(t).init(device="cpu")
    params, states = tnn.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.states), device="cpu")
    tnet.params, tnet.states = params, states
    return jnet, tnet


def _fit_both(jnet, tnet, x, labels, steps):
    for _ in range(steps):
        jnet.fit(JDataSet(x, labels))
        tnet.fit(DataSet(x, labels))
    return np.asarray(jnet.output(x)), _np(tnet.output(x))


def test_samediff_layer_in_mln_fit():
    jnet, tnet = _mln_pair(
        (JDense(n_in=4, n_out=16), TDense(n_in=4, n_out=16)),
        (jnn.OutputLayer(n_in=16, n_out=3, activation="softmax",
                         loss="mcxent"),
         tnn.OutputLayer(n_in=16, n_out=3, activation="softmax",
                         loss="mcxent")))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((64, 4)).astype(np.float32)
    labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 64)]
    s0 = tnet.score(DataSet(x, labels))
    np.testing.assert_allclose(s0, jnet.score(JDataSet(x, labels)),
                               atol=ATOL)
    oj, ot = _fit_both(jnet, tnet, x, labels, 3)
    np.testing.assert_allclose(ot, oj, atol=ATOL)
    tnet.fit(DataSet(x, labels), epochs=57)
    assert tnet.score(DataSet(x, labels)) < s0 * 0.6


def test_lambda_layer():
    jlam = jnn.SameDiffLambdaLayer(fn=lambda sd, x: x * 2.0 + 1.0)
    lam = tnn.SameDiffLambdaLayer(fn=lambda sd, x: x * 2.0 + 1.0)
    params, state, out_shape = lam.init(GEN, (5,))
    assert params == {} and out_shape == (5,) == jlam.init(KEY, (5,))[2]
    y, _ = lam.apply(params, state, torch.ones((3, 5)), tnn.Ctx())
    np.testing.assert_allclose(_np(y), 3.0)


def test_samediff_output_layer_matches_reference_head():
    jh, th = JOut(n_in=6, n_out=3), TOut(n_in=6, n_out=3)
    jp, js, jshape = jh.init(KEY, (6,))
    _, _, tshape = th.init(GEN, (6,))
    assert tshape == jshape == (3,)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((10, 6)).astype(np.float32)
    labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 10)]
    tp = _t(jp)
    y, _ = th.apply(tp, {}, torch.from_numpy(x), tnn.Ctx())
    np.testing.assert_allclose(_np(y.sum(-1)), 1.0, rtol=1e-5)
    yj, _ = jh.apply(jp, js, jnp.asarray(x), jnn.Ctx())
    np.testing.assert_allclose(_np(y), np.asarray(yj), atol=ATOL)
    ref = tnn.OutputLayer(n_in=6, n_out=3, activation="softmax",
                          loss="mcxent")
    ref_loss = ref.compute_loss(tp, torch.from_numpy(x),
                                torch.from_numpy(labels))
    got = th.compute_loss(tp, torch.from_numpy(x), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(float(got), float(jh.compute_loss(
        jp, jnp.asarray(x), jnp.asarray(labels))), atol=ATOL)


def test_samediff_output_layer_mln_fit():
    jnet, tnet = _mln_pair(
        (jnn.DenseLayer(n_in=4, n_out=16, activation="relu"),
         tnn.DenseLayer(n_in=4, n_out=16, activation="relu")),
        (JOut(n_in=16, n_out=3), TOut(n_in=16, n_out=3)), seed=1)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, 4)).astype(np.float32)
    labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 64)]
    s0 = tnet.score(DataSet(x, labels))
    np.testing.assert_allclose(s0, jnet.score(JDataSet(x, labels)),
                               atol=ATOL)
    oj, ot = _fit_both(jnet, tnet, x, labels, 3)
    np.testing.assert_allclose(ot, oj, atol=ATOL)
    tnet.fit(DataSet(x, labels), epochs=57)
    assert tnet.score(DataSet(x, labels)) < s0 * 0.6
    out = tnet.output(x)
    assert tuple(out.shape) == (64, 3)
    np.testing.assert_allclose(_np(out.sum(-1)), 1.0, rtol=1e-5)


def _bilinear_graphs():
    def build(nn, tr, cls, cg, **init):
        b = (nn.NeuralNetConfiguration.builder().seed(3)
             .updater(tr(3e-2)).graph_builder())
        b.add_inputs("a", "b")
        b.add_layer("merge", cls(n_in1=4, n_in2=3, n_out=16), "a", "b")
        b.add_layer("out", nn.OutputLayer(n_in=16, n_out=2,
                                          activation="softmax",
                                          loss="mcxent"), "merge")
        b.set_outputs("out")
        return cg(b.build()).init([(4,), (3,)], **init)
    jg = build(jnn, JAdam, JBil, JCG)
    tg = build(tnn, Adam, TBil, tnn.ComputationGraph, device="cpu")
    tg.params, tg.states = tnn.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jg.params),
        jax.tree_util.tree_map(np.asarray, jg.states), device="cpu")
    return jg, tg


def test_samediff_vertex_in_graph():
    from deeplearning4j_tpu.data import MultiDataSet as JMDS
    jg, g = _bilinear_graphs()
    assert tuple(g.params["merge"]["W1"].shape) == (4, 16)
    assert tuple(g.params["merge"]["W2"].shape) == (3, 16)
    rng = np.random.default_rng(5)
    a = rng.standard_normal((32, 4)).astype(np.float32)
    b = rng.standard_normal((32, 3)).astype(np.float32)
    labels = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 32)]
    out = g.output(a, b)
    assert tuple(out.shape) == (32, 2)
    np.testing.assert_allclose(_np(out), np.asarray(jg.output(a, b)),
                               atol=ATOL)
    mds = MultiDataSet([a, b], [labels])
    s0 = g.score(mds)
    np.testing.assert_allclose(s0, jg.score(JMDS([a, b], [labels])),
                               atol=ATOL)
    for _ in range(3):
        g.fit(mds)
        jg.fit(JMDS([a, b], [labels]))
    np.testing.assert_allclose(_np(g.output(a, b)),
                               np.asarray(jg.output(a, b)), atol=ATOL)
    g.fit(mds, epochs=57)
    assert g.score(mds) < s0 * 0.6


def test_lambda_vertex():
    v = tnn.SameDiffLambdaVertex(lambda sd, x1, x2: x1 * x2)
    jv = jnn.SameDiffLambdaVertex(lambda sd, x1, x2: x1 * x2)
    assert v.out_shape([(4,), (4,)]) == (4,) == jv.out_shape([(4,), (4,)])
    got = v.apply([torch.full((2, 4), 3.0), torch.full((2, 4), 2.0)])
    np.testing.assert_allclose(_np(got), 6.0)
    b = (tnn.NeuralNetConfiguration.builder().seed(3).updater(Adam(1e-2))
         .graph_builder())
    b.add_inputs("a", "b")
    b.add_vertex("prod", v, "a", "b")
    b.add_layer("out", tnn.OutputLayer(n_in=4, n_out=2,
                                       activation="softmax", loss="mcxent"),
                "prod")
    b.set_outputs("out")
    g = tnn.ComputationGraph(b.build()).init([(4,), (4,)], device="cpu")
    out = g.output(torch.ones((2, 4)), torch.ones((2, 4)))
    assert tuple(out.shape) == (2, 2)


def test_samediff_output_layer_mask():
    jh, th = JMse(n_in=3, n_out=2), TMse(n_in=3, n_out=2)
    jp, _, _ = jh.init(KEY, (3,))
    rng = np.random.default_rng(6)
    x = rng.standard_normal((6, 3)).astype(np.float32)
    labels = rng.standard_normal((6, 2)).astype(np.float32)
    mask = np.asarray([1, 1, 0, 1, 0, 1], np.float32)
    got = float(th.compute_loss(_t(jp), torch.from_numpy(x),
                                torch.from_numpy(labels),
                                mask=torch.from_numpy(mask)))
    pred = x @ np.asarray(jp["W"])
    se = ((pred - labels) ** 2).sum(-1)
    np.testing.assert_allclose(got, (se * mask).sum() / mask.sum(),
                               rtol=1e-5)
    np.testing.assert_allclose(got, float(jh.compute_loss(
        jp, jnp.asarray(x), jnp.asarray(labels), mask=jnp.asarray(mask))),
        atol=ATOL)


def test_samediff_output_layer_rejects_unhandled_mask():
    head = TOut(n_in=4, n_out=3)   # define_layer has no mask kwarg
    params, _, _ = head.init(GEN, (4,))
    labels = torch.from_numpy(np.eye(3, dtype=np.float32)[[0, 1]])
    with pytest.raises(ValueError, match="mask"):
        head.compute_loss(params, torch.ones((2, 4)), labels,
                          mask=torch.ones((2,)))


def test_a_host_graph_makes_the_steps_eager():
    """A user graph with a host op (here ``check_numerics``, which reads
    its input on the host) is seen before
    the first call: the network's compiled steps are made eager (run
    directly on the card, never captured), as SameDiff.eval runs such a
    graph; a graph without one is captured."""
    @dataclass
    class Noisy(tnn.SameDiffLayer):
        def define_layer(self, sd, x, params, mask=None):
            return x + sd.base.check_numerics(x)

    for layer, host in ((Noisy(), True), (TDense(n_in=4, n_out=4), False)):
        conf = (tnn.NeuralNetConfiguration.builder().list().layer(layer)
                .layer(tnn.OutputLayer(n_in=4, n_out=2, activation="softmax",
                                       loss="mcxent")).build())
        net = tnn.MultiLayerNetwork(conf).init((4,), device="cpu")
        assert layer.needs_host() is host
        assert net._compiled_step().eager is host
        assert net._infer_step().eager is host
