"""The port's YOLOv2 head and detection zoo against the JAX package's,
on the CPU: ``Yolo2OutputLayer`` (activation, loss and its gradient,
with objects in some cells and several anchors), the IoU helpers,
``get_predicted_objects`` and ``nms``; TinyYOLO (a MultiLayerNetwork) and
YOLO2 (a ComputationGraph, the passthrough included) at 64×64: loss and
every parameter's gradient of one step, then three Adam ``fit`` steps from synced params.

The JAX nets' params go to the port with ``nn.params_from_numpy``.
Tolerances, f32: values atol 1e-5, a detector's training loss 1e-5 of
its size plus four times the reference's own one-ulp spread, per-layer
gradients 1e-4 of the leaf's largest entry (a training-mode BN's
output also rtol 1e-5: its one-pass batch variance over thousands of
rows cancels), gradients atol 1e-4 (the port's other layer tests'
tolerances); fit losses after the first step atol 1e-4 (BN in training
mode, ~20 layers deep).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.data as jdata
import deeplearning4j_tpu_torch.data as tdata
from deeplearning4j_tpu import zoo as jzoo
from deeplearning4j_tpu.nn.layers import objdetect as jod
from deeplearning4j_tpu_torch import zoo as tzoo
from deeplearning4j_tpu_torch.nn import params_from_numpy
from deeplearning4j_tpu_torch.nn.layers import objdetect as tod
from deeplearning4j_tpu_torch.nn.layers.base import Ctx
from deeplearning4j_tpu_torch.train.updaters import tree_leaves

torch.set_num_threads(2)

ATOL = 1e-5
GRAD_ATOL = 1e-4
ANCHORS = [(1.0, 1.0), (2.5, 1.2), (0.7, 2.1)]


def _np(t):
    return t.detach().float().numpy()


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def yolo_label(b, h, w, c, boxes):
    """boxes: per image, (cell_y, cell_x, x1, y1, x2, y2, class)."""
    lab = np.zeros((b, h, w, 4 + c), np.float32)
    for bi, items in enumerate(boxes):
        for (cy, cx, x1, y1, x2, y2, cls) in items:
            lab[bi, cy, cx, :4] = [x1, y1, x2, y2]
            lab[bi, cy, cx, 4 + cls] = 1.0
    return lab


def _volume(b=2, h=4, w=4, c=3, seed=0):
    x = np.random.default_rng(seed).standard_normal(
        (b, h, w, len(ANCHORS) * (5 + c))).astype(np.float32)
    lab = yolo_label(b, h, w, c, [[(1, 2, 1.8, 0.5, 2.6, 1.5, 0),
                                   (3, 3, 2.2, 2.1, 4.0, 3.9, 1)],
                                  [(3, 0, 0.1, 2.9, 0.9, 3.8, 2)]])
    return x, lab


def test_yolo2_activation_loss_and_grad_match_jax():
    x, lab = _volume()
    jl = jod.Yolo2OutputLayer(anchors=ANCHORS, lambda_coord=4.0)
    tl = tod.Yolo2OutputLayer(anchors=ANCHORS, lambda_coord=4.0)
    yj, _ = jl.apply({}, {}, jnp.asarray(x), None)
    yt, _ = tl.apply({}, {}, torch.as_tensor(x), Ctx())
    np.testing.assert_allclose(_np(yt), np.asarray(yj), atol=ATOL)
    lj, gj = jax.value_and_grad(lambda a: jl.compute_loss(
        a, jnp.asarray(lab)))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    lt = tl.compute_loss(xt, torch.as_tensor(lab))
    assert np.isfinite(float(lt)) and float(lt) > 0
    np.testing.assert_allclose(float(lt), float(lj), atol=ATOL)
    (gt,) = torch.autograd.grad(lt, xt)
    np.testing.assert_allclose(_np(gt), np.asarray(gj), atol=GRAD_ATOL)


def test_iou_helpers_match_jax():
    rng = np.random.default_rng(0)
    a = np.sort(rng.random((5, 4)).astype(np.float32) * 4, axis=-1)
    b = np.sort(rng.random((5, 4)).astype(np.float32) * 4, axis=-1)
    a, b = a[:, [0, 2, 1, 3]], b[:, [0, 2, 1, 3]]
    np.testing.assert_allclose(
        _np(tod.box_iou_xyxy(torch.as_tensor(a), torch.as_tensor(b))),
        np.asarray(jod._box_iou_xyxy(jnp.asarray(a), jnp.asarray(b))),
        atol=ATOL)
    wh1, wh2 = rng.random((6, 2)) + 0.1, rng.random((6, 2)) + 0.1
    np.testing.assert_allclose(
        _np(tod.box_iou_wh(torch.as_tensor(wh1), torch.as_tensor(wh2))),
        np.asarray(jod._box_iou_wh(jnp.asarray(wh1), jnp.asarray(wh2))),
        atol=ATOL)


def test_yolo2_loss_decreases_with_sgd():
    layer = tod.Yolo2OutputLayer(anchors=[(1.0, 1.0)])
    lab = torch.as_tensor(yolo_label(1, 3, 3, 2,
                                     [[(1, 1, 1.2, 1.2, 1.8, 1.8, 1)]]))
    x = torch.zeros((1, 3, 3, 7), requires_grad=True)
    l0 = float(layer.compute_loss(x, lab))
    for _ in range(60):
        (g,) = torch.autograd.grad(layer.compute_loss(x, lab), x)
        with torch.no_grad():
            x -= 0.5 * g
    assert float(layer.compute_loss(x, lab)) < 0.3 * l0


def test_decode_and_nms_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 5, len(ANCHORS) * 7)).astype(np.float32)
    x[..., 4::7] += 1.5                      # many confident boxes
    jl = jod.Yolo2OutputLayer(anchors=ANCHORS)
    tl = tod.Yolo2OutputLayer(anchors=ANCHORS)
    for thr in (0.5, 0.8):
        jd = jod.get_predicted_objects(jl, jnp.asarray(x), threshold=thr)
        td = tod.get_predicted_objects(tl, torch.as_tensor(x), threshold=thr)
        assert [len(d) for d in td] == [len(d) for d in jd]
        for tdi, jdi in zip(td, jd):
            for a, b in zip(tdi, jdi):
                assert a.predicted_class == b.predicted_class
                np.testing.assert_allclose(
                    [a.center_x, a.center_y, a.width, a.height,
                     a.confidence],
                    [b.center_x, b.center_y, b.width, b.height,
                     b.confidence], atol=ATOL)
            for iou in (0.2, 0.45):
                kt = tod.nms(tdi, iou)
                kj = jod.nms(jdi, iou)
                assert [(d.predicted_class, round(d.confidence, 5))
                        for d in kt] == \
                    [(d.predicted_class, round(d.confidence, 5))
                     for d in kj]
    # a crafted single detection; its duplicate is suppressed
    one = np.full((1, 3, 3, 7), -6.0, np.float32)
    one[0, 1, 1, 4] = 6.0
    one[0, 1, 1, 0:4] = 0.0
    one[0, 1, 1, 5:] = [0.0, 5.0]
    dets = tod.get_predicted_objects(tod.Yolo2OutputLayer(
        anchors=[(1.0, 1.0)]), torch.as_tensor(one))[0]
    assert len(dets) == 1 and dets[0].predicted_class == 1
    assert abs(dets[0].center_x - 1.5) < 1e-3
    assert len(tod.nms(dets + dets)) == 1


def _detector(kind, pkg):
    z = jzoo if pkg == "jax" else tzoo
    if kind == "tiny":
        return z.TinyYOLO(num_classes=3, input_shape=(64, 64, 3))
    return z.YOLO2(num_classes=4, input_shape=(64, 64, 3))


def _layer_vjps(jnet, tnet, tparams, x, graph):
    """Each layer's (and vertex's) backward on the JAX net's own
    activations: the JAX layer's VJP w.r.t. its input and params against
    autograd of the port's layer, for a seeded cotangent; the forward at
    each layer too. Returns the number of layers held."""
    from deeplearning4j_tpu.nn.layers.base import Ctx as JCtx
    from deeplearning4j_tpu_torch.nn.layers.base import Layer
    rng = np.random.default_rng(5)
    if graph:
        order = [(n, jnet.conf.nodes[n].op, tnet.conf.nodes[n].op,
                  jnet.conf.nodes[n].inputs) for n in jnet.conf.topo_order]
        acts = {"in": jnp.asarray(x)}
    else:
        order = [(f"layer_{i}", lj, lt, None) for i, (lj, lt) in
                 enumerate(zip(jnet.layers, tnet.layers))]
        h = jnp.asarray(x)
    held = 0
    for name, jl, tl, inputs in order:
        xs = [acts[i] for i in inputs] if graph else [h]
        if not isinstance(tl, Layer):           # a vertex
            y = jl.apply(xs)
            yt = tl.apply([torch.as_tensor(np.array(a)) for a in xs])
            np.testing.assert_allclose(_np(yt), np.asarray(y), atol=ATOL)
        else:
            jp, js = jnet.params[name], jnet.states[name]

            def f(p, a):
                return jl.apply(p, js, a, JCtx(train=True))[0]
            y, vjp = jax.vjp(f, jp, xs[0])
            g = rng.standard_normal(y.shape).astype(np.float32)
            gp, gx = vjp(jnp.asarray(g))
            xt = torch.as_tensor(np.array(xs[0])).requires_grad_(True)
            yt, _ = tl.apply(tparams[name], tnet.states[name], xt,
                             Ctx(train=True))
            # a BN's one-pass batch variance over thousands of rows cancels
            # in f32: its output is held relatively as well
            np.testing.assert_allclose(_np(yt), np.asarray(y), atol=ATOL,
                                       rtol=1e-5)
            leaves = tree_leaves(tparams[name])
            got = torch.autograd.grad((yt * torch.as_tensor(g)).sum(),
                                      leaves + [xt])
            want = jax.tree_util.tree_leaves(gp) + [gx]
            for a, b in zip(want, got):
                a = np.asarray(a)
                scale = max(1.0, float(np.abs(a).max()))
                np.testing.assert_allclose(_np(b), a, atol=GRAD_ATOL * scale)
            held += 1
        if graph:
            acts[name] = y
        else:
            h = y
    return held


@pytest.mark.parametrize("kind", ["tiny", "yolo2"])
def test_detector_loss_grads_and_fit_match_jax(kind):
    """Output of the whole net at 1e-5; every layer's gradient (params and
    input) on the JAX net's activations at 1e-4 of the leaf's largest
    entry; the training loss, and three Adam fit steps each from synced
    params, at 1e-5 of the loss plus four times the reference's own
    spread (its loss when the input moves by one ulp: ~20 training-mode
    BNs over a few rows each amplify f32 rounding). The whole
    net's gradients are not held leaf by leaf, nor its trajectory: a max
    pool routes its gradient to its window's argmax, and an f32 rounding
    difference in a BN upstream (the order of the batch sums) flips
    near-ties there, so the early layers' step-1 gradients part by ~1%
    between any two implementations (the ResNet-50 tests note the same
    of deep nets)."""
    jm, tm = _detector(kind, "jax"), _detector(kind, "torch")
    jnet = jm.init()
    tnet = tm.init(device="cpu")
    tnet.params, tnet.states = params_from_numpy(
        _np_tree(jnet.params), _np_tree(jnet.states), "cpu")
    c = tm.num_classes
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    lab = yolo_label(2, 2, 2, c, [[(1, 1, 1.1, 1.2, 1.9, 1.8, 0)],
                                  [(0, 1, 1.0, 0.2, 1.9, 0.9, c - 1)]])
    y_j = jnet.output(jnp.asarray(x))
    y_t = tnet.output(x)
    assert tuple(y_t.shape) == y_j.shape == (2, 2, 2, 5 * (5 + c))
    np.testing.assert_allclose(_np(y_t), np.asarray(y_j), atol=ATOL)
    graph = kind == "yolo2"
    wrap = (lambda a: [a]) if graph else (lambda a: a)
    lj = jnet._loss(jnet.params, jnet.states, wrap(jnp.asarray(x)),
                    wrap(jnp.asarray(lab)), None, None, None)[0]
    lt = tnet._loss(tnet.params, tnet.states, wrap(torch.as_tensor(x)),
                    wrap(torch.as_tensor(lab)), None, None, None)[0]
    n_layers = len(jnet.conf.nodes) if graph else len(jnet.layers)
    assert _layer_vjps(jnet, tnet, tnet.params, x, graph) >= \
        n_layers - (1 if graph else 0)

    def tol():
        """1e-5 of the loss plus four times the reference's own spread:
        its loss on the input moved by one ulp, at its current params."""
        loss = [float(jnet._loss(jnet.params, jnet.states, wrap(
            jnp.asarray(a)), wrap(jnp.asarray(lab)), None, None, None)[0])
            for a in (x, x * np.float32(1 + 1e-7))]
        return ATOL * max(1.0, abs(loss[0])) + 4 * abs(loss[1] - loss[0])

    assert abs(float(lt) - float(lj)) <= tol()
    # three fit steps, each from the JAX net's params and running stats
    # (the loss fit returns is the step's own, before its update)
    for step in range(3):
        tnet.params, tnet.states = params_from_numpy(
            _np_tree(jnet.params), _np_tree(jnet.states), "cpu")
        bound = tol()
        lj = jnet.fit(jdata.DataSet(x, lab))
        lt = tnet.fit(tdata.DataSet(x, lab))
        assert abs(lt - lj) <= bound
        assert tnet._step_fn.last == "direct"


def test_yolo2_passthrough_shapes():
    net = tzoo.YOLO2(num_classes=4, input_shape=(64, 64, 3)).init(
        device="cpu")
    names = list(net.conf.nodes)
    assert sum(n.endswith("_bn") for n in names) == 22
    assert net.output_shapes["out"] == (2, 2, 5 * (5 + 4))
    reorg = [n for n in names if n == "reorg"]
    assert reorg and net.conf.nodes["merge"].inputs[0] == "reorg"
