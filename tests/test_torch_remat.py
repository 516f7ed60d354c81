"""Segmented remat (``remat_segments``) on the port's ComputationGraph and
MultiLayerNetwork against the monolithic forward and against the JAX
package (``tests/test_remat_cg.py``'s cases), on the CPU.

The remat path is an execution strategy only: at n_segments 2, 3 and 5
the loss, every grad and the BN running states equal the monolithic walk
bit for bit, dropout included (the recompute is handed the forward's
masks, ``nn/_remat.py``), and the fit trajectory too. Against the JAX
package on shared weights the loss and the states agree at 1e-5 and the
grads at 1e-4 (f32), with and without remat. The segment plan cuts where
the reference cuts (one tensor crosses on a residual chain), an
oversized ``remat_segments`` is clamped with the reference's warning,
inference ignores remat, a changed setting drops the compiled step, and
``clone`` keeps the setting (and the loss weights).
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu_torch.nn as tnn
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.train.updaters import tree_leaves


def _import_dynamo_beside_onnx_stub():
    """``torch.utils.checkpoint`` imports ``torch._dynamo`` on first use,
    whose import probes optional packages such as ``onnx``; the ONNX
    import tests put a spec-less stub ``onnx`` into ``sys.modules``, which
    makes that probe raise. Import it here with the stub set aside."""
    stub = sys.modules.pop("onnx", None)
    try:
        import torch._dynamo  # noqa: F401
    finally:
        if stub is not None:
            sys.modules["onnx"] = stub


_import_dynamo_beside_onnx_stub()

ATOL, GRAD_ATOL = 1e-5, 1e-4


def _residual_cnn(m, seed=7, dropout=0.0):
    """Small ResNet-shaped CG: stem conv + two residual blocks + head."""
    b = m.NeuralNetConfiguration.builder().seed(seed)
    g = b.graph_builder().add_inputs("in")
    g.add_layer("stem", m.ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                           convolution_mode="same",
                                           activation="identity"), "in")
    g.add_layer("stem_bn", m.BatchNormalization(activation="relu"), "stem")
    x = "stem_bn"
    for i in range(2):
        g.add_layer(f"b{i}_conv", m.ConvolutionLayer(
            n_out=8, kernel_size=(3, 3), convolution_mode="same",
            activation="identity", dropout=dropout), x)
        g.add_layer(f"b{i}_bn", m.BatchNormalization(activation="identity"),
                    f"b{i}_conv")
        g.add_vertex(f"b{i}_add", m.ElementWiseVertex(op="add"),
                     f"b{i}_bn", x)
        g.add_layer(f"b{i}_out", m.ActivationLayer(activation="relu"),
                    f"b{i}_add")
        x = f"b{i}_out"
    g.add_layer("gap", m.GlobalPoolingLayer(pooling_type="avg"), x)
    g.add_layer("out", m.OutputLayer(n_in=8, n_out=5, activation="softmax",
                                     loss="mcxent"), "gap")
    g.set_outputs("out")
    g.set_input_types(m.InputType.convolutional(8, 8, 3))
    return m.ComputationGraph(g.build())


def _mln(m, seed=9, dropout=0.0):
    conf = (m.NeuralNetConfiguration.builder().seed(seed).list()
            .layer(m.ConvolutionLayer(n_out=6, kernel_size=(3, 3),
                                      convolution_mode="same",
                                      activation="relu", dropout=dropout))
            .layer(m.BatchNormalization())
            .layer(m.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(m.DenseLayer(n_out=16, activation="tanh", dropout=dropout))
            .layer(m.OutputLayer(n_out=5, activation="softmax",
                                 loss="mcxent"))
            .set_input_type(m.InputType.convolutional(8, 8, 3)).build())
    return m.MultiLayerNetwork(conf)


def _pair(kind, dropout=0.0):
    """(JAX net, port net on its weights)."""
    make = _residual_cnn if kind == "cg" else _mln
    jnet = make(jnn, dropout=dropout).init()
    tnet = make(tnn, dropout=dropout).init(device="cpu")
    tnet.params, tnet.states = tnn.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.states), "cpu")
    return jnet, tnet


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 4)]
    return x, y


def _port_lg(net, x, y, seed=None):
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    if isinstance(net, tnn.ComputationGraph):
        loss, st = net._loss(net.params, net.states, {"in": xt}, {"out": yt},
                             gen, None, None)
    else:
        loss, st = net._loss(net.params, net.states, xt, yt, gen, None, None)
    leaves = tree_leaves(net.params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [None if g is None else g.detach() for g in grads], \
        [t.detach().clone() for t in tree_leaves(st)]


def _jax_lg(net, x, y):
    def f(params):
        if isinstance(net, jnn.ComputationGraph):
            return net._loss(params, net.states, {"in": jnp.asarray(x)},
                             {"out": jnp.asarray(y)}, None, None, None)
        return net._loss(params, net.states, jnp.asarray(x),
                         jnp.asarray(y), None, None, None)
    (loss, st), g = jax.value_and_grad(f, has_aux=True)(net.params)
    return float(loss), [np.asarray(a) for a in jax.tree_util.tree_leaves(g)], \
        [np.asarray(a) for a in jax.tree_util.tree_leaves(st)]


def _equal_lists(a, b):
    assert len(a) == len(b)
    for p, q in zip(a, b):
        assert (p is None and q is None) or torch.equal(p, q)


@pytest.mark.parametrize("kind", ["cg", "mln"])
@pytest.mark.parametrize("n_segments", [2, 3, 5])
def test_remat_loss_grads_states_identical(data, kind, n_segments):
    x, y = data
    jnet, tnet = _pair(kind)
    l0, g0, s0 = _port_lg(tnet, x, y)
    tnet.remat_segments = n_segments
    l1, g1, s1 = _port_lg(tnet, x, y)
    assert torch.equal(l0, l1)
    _equal_lists(g0, g1)
    _equal_lists(s0, s1)
    jnet.remat_segments = n_segments
    jl, jg, js = _jax_lg(jnet, x, y)
    np.testing.assert_allclose(float(l1), jl, atol=ATOL)
    for g, w in zip(g1, jg):
        np.testing.assert_allclose(
            np.zeros_like(w) if g is None else g.numpy(), w, atol=GRAD_ATOL)
    for s, w in zip(s1, js):
        np.testing.assert_allclose(s.numpy(), w, atol=ATOL)


@pytest.mark.parametrize("kind", ["cg", "mln"])
def test_remat_dropout_rng_matches_monolithic(data, kind):
    """The recompute replays the forward's masks: loss and grads equal the
    monolithic walk bit for bit, and the generator advances as much."""
    x, y = data
    _, tnet = _pair(kind, dropout=0.3)
    l0, g0, _ = _port_lg(tnet, x, y, seed=42)
    for n in (2, 3):
        tnet.remat_segments = n
        l1, g1, _ = _port_lg(tnet, x, y, seed=42)
        assert torch.equal(l0, l1)
        _equal_lists(g0, g1)
    gen_a, gen_b = torch.Generator().manual_seed(1), \
        torch.Generator().manual_seed(1)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    args = ({"in": xt}, {"out": yt}) if kind == "cg" else (xt, yt)
    tnet.remat_segments = None
    tnet._loss(tnet.params, tnet.states, *args, gen_a, None, None)
    tnet.remat_segments = 3
    loss, _ = tnet._loss(tnet.params, tnet.states, *args, gen_b, None, None)
    torch.autograd.grad(loss, tree_leaves(tnet.params), allow_unused=True)
    assert torch.equal(gen_a.get_state(), gen_b.get_state())


@pytest.mark.parametrize("kind", ["cg", "mln"])
def test_remat_fit_trajectory_matches(data, kind):
    """Two nets on the same weights, one remat'd: fit() lands on identical
    params (and within 1e-5 of the JAX package's trajectory)."""
    x, y = data
    jnet, a = _pair(kind)
    _, b = _pair(kind)
    b.remat_segments = 3
    ds = DataSet(x, y)
    for _ in range(3):
        a.fit([ds])
        b.fit([ds])
        jnet.fit([JDataSet(x, y)])
    _equal_lists(tree_leaves(a.params), tree_leaves(b.params))
    for p, w in zip(tree_leaves(b.params),
                    jax.tree_util.tree_leaves(jnet.params)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                   atol=ATOL, rtol=1e-4)
    assert torch.equal(a.output(x), b.output(x))


def test_segment_plan_cuts_at_block_boundaries():
    """Minimal-live cuts on a residual chain land where ONE tensor crosses,
    and where the reference's plan cuts."""
    jnet, tnet = _pair("cg")
    for n in (2, 3, 4):
        plan = tnet._segment_plan(n, ["in"])
        assert plan == jnet._segment_plan(n, ["in"])
    plan = tnet._segment_plan(3, ["in"])
    assert len(plan) == 3
    assert [len(s["carry_in"]) for s in plan] == [1, 1, 1]
    flat = [nm for seg in plan for _, nm in seg["nodes"]]
    assert flat == list(tnet.conf.topo_order)


def test_remat_segments_clamped_with_warning():
    _, tnet = _pair("cg")
    with pytest.warns(UserWarning, match="exceeds what this"):
        tnet._segment_plan(50, ["in"])
    _, mln = _pair("mln")
    mln.remat_segments = 50
    with pytest.warns(UserWarning, match="exceeds what this"):
        _port_lg(mln, np.zeros((2, 8, 8, 3), np.float32),
                 np.eye(5, dtype=np.float32)[:2])


def test_inference_ignores_remat_and_setting_drops_steps(data):
    x, y = data
    _, net = _pair("cg")
    out0 = net.output(x)
    net.fit([DataSet(x, y)])
    assert net._step_fn is not None and net._infer_fn is not None
    net.remat_segments = 4
    assert net._step_fn is None and net._infer_fn is None
    net.fit([DataSet(x, y)])                  # the new step still trains
    _, twin = _pair("cg")
    twin.remat_segments = 4
    assert torch.equal(twin.output(x), out0)
    mln = _pair("mln")[1]
    mln.fit([DataSet(x, y)])
    assert mln._step_fn is not None
    mln.remat_segments = 2
    assert mln._step_fn is None
    mln.fit([DataSet(x, y)])


def test_clone_preserves_loss_weights_and_remat():
    _, net = _pair("cg")
    net.output_loss_weights = {"out": 0.25}
    net.remat_segments = 3
    twin = net.clone()
    assert twin.output_loss_weights == {"out": 0.25}
    assert twin.remat_segments == 3
    assert _residual_cnn(tnn).clone().remat_segments is None
    mln = _pair("mln")[1]
    mln.remat_segments = 2
    assert mln.clone().remat_segments == 2


def test_resnet50_config_carries_remat():
    from deeplearning4j_tpu_torch.zoo.resnet import ResNet50
    net = ResNet50(num_classes=10, input_shape=(32, 32, 3),
                   remat_segments=3).init(device="cpu")
    assert net.remat_segments == 3
    plan = net._segment_plan(3, ["in"])
    assert [len(s["carry_in"]) for s in plan] == [1, 1, 1]


def test_remat_replays_in_place_and_out_draws():
    """A segment that draws in place (``uniform_``, ``trunc_normal_``),
    into ``out=``, and by result then edits the draw in place: under
    checkpoint_segment its value and grads equal the plain call's on the
    same seed, and the generator advances as much."""
    from deeplearning4j_tpu_torch.nn._remat import checkpoint_segment

    def seg(gen):
        def fn(x):
            a = torch.empty(x.shape).uniform_(-1.0, 1.0, generator=gen)
            b = torch.nn.init.trunc_normal_(torch.empty(x.shape),
                                            generator=gen)
            c = torch.empty(x.shape)
            torch.rand(x.shape, generator=gen, out=c)
            d = torch.rand(x.shape, generator=gen)
            d.mul_(3.0)
            return torch.tanh(x * a + b) * c + d * x
        return fn

    x0 = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (5, 4)).astype(np.float32))
    outs = []
    for remat in (False, True):
        gen = torch.Generator().manual_seed(11)
        x = x0.clone().requires_grad_(True)
        y = checkpoint_segment(seg(gen), x) if remat else seg(gen)(x)
        (gx,) = torch.autograd.grad(y.square().sum(), x)
        outs.append((y.detach(), gx, gen.get_state()))
    (y0, g0, s0), (y1, g1, s1) = outs
    assert torch.equal(y0, y1) and torch.equal(g0, g1)
    assert torch.equal(s0, s1)
