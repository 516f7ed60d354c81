"""The port's layer API against the JAX package's, on the CPU.

Same inputs and params (numpy from a seed) through both sides: every
named activation and loss; the conv family with XLA's asymmetric SAME
padding at stride 1 and 2 on odd and even sizes, SAME max and average
pooling; global pooling, dense/output heads, every vertex and
preprocessor; BatchNormalization in training and inference with the
fused kernels on (the JAX side in interpret mode) and off; 5 steps of
every ported updater and of ``build_optimizer`` compositions against
optax. Tolerances, f32: values atol 1e-5 (summation order), gradients
atol 1e-4 relative to values of order 1-30 (conv and BN backward sums in
another order), updater trajectories atol 1e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning4j_tpu.nn import activations as jact
from deeplearning4j_tpu.nn import losses as jloss
from deeplearning4j_tpu.nn import preprocessors as jpre
from deeplearning4j_tpu.nn import vertices as jvert
from deeplearning4j_tpu.nn.layers import conv as jconv
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.layers import norm as jnorm
from deeplearning4j_tpu.nn.layers.base import Ctx as JCtx
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu_torch.nn import activations as tact
from deeplearning4j_tpu_torch.nn import losses as tloss
from deeplearning4j_tpu_torch.nn import preprocessors as tpre
from deeplearning4j_tpu_torch.nn import vertices as tvert
from deeplearning4j_tpu_torch.nn import weights as twts
from deeplearning4j_tpu_torch.nn.layers import conv as tconv
from deeplearning4j_tpu_torch.nn.layers import core as tcore
from deeplearning4j_tpu_torch.nn.layers import norm as tnorm
from deeplearning4j_tpu_torch.nn.layers.base import Ctx
from deeplearning4j_tpu_torch.train import updaters as tupd

torch.set_num_threads(2)

ATOL = 1e-5
GRAD_ATOL = 1e-4


def _t(a, grad=False):
    t = torch.as_tensor(np.array(a, dtype=np.float32))
    return t.requires_grad_(True) if grad else t


def _np(t):
    return t.detach().float().numpy()


# --------------------------------------------------------------- activations

@pytest.mark.parametrize("name", jact.names())
def test_activation_matches_jax(name):
    assert tact.names() == jact.names()
    x = np.random.default_rng(0).standard_normal((4, 37)).astype(np.float32) * 3
    x[0, :5] = [0.0, 1.0, -1.0, 6.0, 0.5]
    got = tact.get(name)(_t(x))
    want = jact.get(name)(jnp.asarray(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL,
                               rtol=1e-6)


def test_activation_get_refuses_unknown_names():
    with pytest.raises(ValueError, match="Unknown activation"):
        tact.get("nope")
    assert tact.get(torch.tanh) is torch.tanh


# -------------------------------------------------------------------- losses

def _loss_inputs(name, rng):
    b, k = 6, 5
    if name in ("sparse_mcxent",):
        return rng.integers(0, k, b), rng.dirichlet(np.ones(k), b)
    if name in ("hinge", "squared_hinge"):
        return rng.choice([-1.0, 1.0], (b, k)), rng.standard_normal((b, k))
    if name in ("mcxent", "negativeloglikelihood", "kl_divergence"):
        return (np.eye(k)[rng.integers(0, k, b)],
                rng.dirichlet(np.ones(k), b))
    if name in ("binary_xent", "xent", "fmeasure"):
        return (rng.integers(0, 2, (b, k)).astype(float),
                rng.uniform(0.05, 0.95, (b, k)))
    if name in ("multi_label", "multilabel"):
        return (rng.integers(0, 2, (b, k)).astype(float),
                rng.standard_normal((b, k)))
    if name == "poisson":
        return rng.poisson(2.0, (b, k)).astype(float), rng.uniform(0.1, 3, (b, k))
    if name == "msle":
        return rng.uniform(0, 2, (b, k)), rng.uniform(0, 2, (b, k))
    return rng.standard_normal((b, k)), rng.standard_normal((b, k))


LOSSES = sorted(set(jloss._REGISTRY) - {"mixture_density"})


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", LOSSES)
def test_loss_matches_jax(name, masked):
    rng = np.random.default_rng(1)
    labels, preds = _loss_inputs(name, rng)
    mask = (rng.random(labels.shape[0]) > 0.3).astype(np.float32) \
        if masked else None
    lab_dtype = np.int32 if name == "sparse_mcxent" else np.float32
    want = jloss.get(name)(jnp.asarray(labels, lab_dtype),
                           jnp.asarray(preds, np.float32),
                           mask=None if mask is None else jnp.asarray(mask))
    tl = torch.as_tensor(labels.astype(lab_dtype))
    got = tloss.get(name)(tl, _t(preds),
                          mask=None if mask is None else _t(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                               atol=ATOL)


@pytest.mark.parametrize("name", sorted(jloss.LOGITS_VARIANTS))
def test_logits_losses_match_jax_with_grads(name):
    rng = np.random.default_rng(2)
    b, k = 6, 5
    logits = rng.standard_normal((b, k)).astype(np.float32) * 2
    if name == "sparse_mcxent":
        labels = rng.integers(0, k, b).astype(np.int32)
        tl = torch.as_tensor(labels)
    else:
        labels = np.eye(k, dtype=np.float32)[rng.integers(0, k, b)]
        tl = _t(labels)
    jfn, tfn = jloss.LOGITS_VARIANTS[name], tloss.LOGITS_VARIANTS[name]
    jv, jg = jax.value_and_grad(lambda z: jfn(jnp.asarray(labels), z))(
        jnp.asarray(logits))
    z = _t(logits, grad=True)
    v = tfn(tl, z)
    (g,) = torch.autograd.grad(v, z)
    np.testing.assert_allclose(v.item(), float(jv), rtol=1e-6, atol=ATOL)
    np.testing.assert_allclose(_np(g), np.asarray(jg), atol=ATOL)


def test_mixture_density_matches_jax():
    rng = np.random.default_rng(3)
    k, d, b = 3, 2, 5
    labels = rng.standard_normal((b, d)).astype(np.float32)
    preds = rng.standard_normal((b, k + k * d + k)).astype(np.float32)
    want = jloss.mixture_density(jnp.asarray(labels), jnp.asarray(preds), k)
    got = tloss.mixture_density(_t(labels), _t(preds), k)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# ----------------------------------------------------------------- layers

def _layer_parity(jl, tl, x, train=True, state=None, params=None,
                  rng_seed=0):
    """Forward value and grads (x and every param) of sum(y * w) on both
    sides from the same params; returns the port's (y, new_state)."""
    rng = np.random.default_rng(rng_seed)
    jp, js, _ = jl.init(jax.random.PRNGKey(0), x.shape[1:])
    if params is not None:
        jp = params
    else:
        jp = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32)
                             * (0.5 if v.ndim > 1 else 1.0))
              for k, v in jp.items()}
    if state is not None:
        js = state
    jy, jns = jl.apply(jp, js, jnp.asarray(x), JCtx(train=train))
    w = rng.standard_normal(jy.shape).astype(np.float32)

    def f(p, x_):
        y, _ = jl.apply(p, js, x_, JCtx(train=train))
        return jnp.sum(y * w)

    jgp, jgx = jax.grad(f, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: _t(v, grad=True) for k, v in jp.items()}
    ts = {k: _t(v) for k, v in js.items()}
    xt = _t(x, grad=True)
    y, ns = tl.apply(tp, ts, xt, Ctx(train=train))
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=ATOL, rtol=1e-6)
    grads = torch.autograd.grad((y * _t(w)).sum(), [xt, *tp.values()])
    np.testing.assert_allclose(_np(grads[0]), np.asarray(jgx),
                               atol=GRAD_ATOL, rtol=1e-5)
    for k, g in zip(tp, grads[1:]):
        np.testing.assert_allclose(_np(g), np.asarray(jgp[k]),
                                   atol=GRAD_ATOL, rtol=1e-5, err_msg=k)
    for k in jns:
        np.testing.assert_allclose(_np(ns[k]), np.asarray(jns[k]),
                                   atol=ATOL, err_msg=k)
    return y, ns


@pytest.mark.parametrize("size", [7, 8, 16])
@pytest.mark.parametrize("k,stride", [(1, 1), (3, 1), (3, 2), (7, 2), (1, 2)])
def test_conv_same_padding_matches_jax(size, k, stride):
    """XLA's SAME: lo = total // 2, hi = total - lo, asymmetric for an odd
    total (7x7/s2 on an even size pads (2, 3))."""
    kw = dict(n_out=6, kernel_size=(k, k), stride=(stride, stride),
              convolution_mode="same", has_bias=True)
    x = np.random.default_rng(size).standard_normal(
        (2, size, size, 5)).astype(np.float32)
    y, _ = _layer_parity(jconv.ConvolutionLayer(**kw),
                         tconv.ConvolutionLayer(**kw), x)
    assert y.shape == (2, -(-size // stride), -(-size // stride), 6)
    assert y.is_contiguous()


@pytest.mark.parametrize("kw", [
    dict(n_out=4, kernel_size=(3, 3), padding=(1, 1)),
    dict(n_out=4, kernel_size=(3, 2), stride=(2, 1), padding=0),
    dict(n_out=4, kernel_size=(3, 3), dilation=(2, 2),
         convolution_mode="same"),
    dict(n_out=6, kernel_size=(3, 3), groups=3, convolution_mode="same"),
], ids=["explicit", "truncate", "dilated-same", "grouped"])
def test_conv_variants_match_jax(kw):
    x = np.random.default_rng(4).standard_normal((2, 9, 9, 6)) \
        .astype(np.float32)
    _layer_parity(jconv.ConvolutionLayer(**kw), tconv.ConvolutionLayer(**kw),
                  x)


def test_conv_bf16_compute_casts_input_and_weight():
    layer = tconv.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                   convolution_mode="same",
                                   compute_dtype=torch.bfloat16)
    params, _, out = layer.init(torch.Generator().manual_seed(0), (8, 8, 3))
    y, _ = layer.apply(params, {}, torch.randn(2, 8, 8, 3), Ctx())
    assert y.dtype == torch.bfloat16 and tuple(y.shape[1:]) == out


@pytest.mark.parametrize("size", [7, 8, 112 // 8])
@pytest.mark.parametrize("ptype", ["max", "avg", "sum", "pnorm"])
def test_pooling_same_stride2_matches_jax(size, ptype):
    """The stem's 3x3/s2 SAME pool (pads (0, 1) on an even size, with
    -inf for max)."""
    kw = dict(kernel_size=(3, 3), stride=(2, 2), convolution_mode="same",
              pooling_type=ptype)
    x = np.random.default_rng(5).standard_normal((2, size, size, 3)) \
        .astype(np.float32)
    if ptype == "pnorm":
        x = np.abs(x) + 0.1
    y, _ = _layer_parity(jconv.SubsamplingLayer(**kw),
                         tconv.SubsamplingLayer(**kw), x)
    assert y.shape == (2, -(-size // 2), -(-size // 2), 3)


def test_pooling_truncate_matches_jax():
    kw = dict(kernel_size=(2, 2), pooling_type="max")
    x = np.random.default_rng(6).standard_normal((2, 9, 9, 3)) \
        .astype(np.float32)
    _layer_parity(jconv.SubsamplingLayer(**kw), tconv.SubsamplingLayer(**kw),
                  x)


@pytest.mark.parametrize("ptype", ["avg", "max", "sum", "pnorm"])
def test_global_pooling_matches_jax(ptype):
    x = np.abs(np.random.default_rng(7).standard_normal((3, 5, 4, 6))) \
        .astype(np.float32) + 0.1
    _layer_parity(jconv.GlobalPoolingLayer(pooling_type=ptype),
                  tconv.GlobalPoolingLayer(pooling_type=ptype), x)


@pytest.mark.parametrize("ptype", ["avg", "max", "sum"])
def test_global_pooling_masked_rnn_matches_jax(ptype):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 6, 4)).astype(np.float32)
    mask = np.ones((3, 6), np.float32)
    mask[0, 4:] = 0
    mask[2, 1:] = 0
    jy, _ = jconv.GlobalPoolingLayer(pooling_type=ptype).apply(
        {}, {}, jnp.asarray(x), JCtx(mask=jnp.asarray(mask)))
    y, _ = tconv.GlobalPoolingLayer(pooling_type=ptype).apply(
        {}, {}, _t(x), Ctx(mask=_t(mask)))
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=ATOL)


def test_zero_padding_and_space_to_depth_match_jax():
    x = np.random.default_rng(9).standard_normal((2, 6, 4, 3)) \
        .astype(np.float32)
    for pad in (1, (1, 2), ((0, 1), (2, 3))):
        _layer_parity(jconv.ZeroPaddingLayer(padding=pad),
                      tconv.ZeroPaddingLayer(padding=pad), x)
        assert tconv.ZeroPaddingLayer(padding=pad).init(None, (6, 4, 3))[2] \
            == jconv.ZeroPaddingLayer(padding=pad).init(None, (6, 4, 3))[2]
    _layer_parity(jconv.SpaceToDepthLayer(block_size=2),
                  tconv.SpaceToDepthLayer(block_size=2), x)


@pytest.mark.parametrize("act", ["identity", "relu", "softmax", "tanh"])
def test_dense_matches_jax(act):
    x = np.random.default_rng(10).standard_normal((4, 7)).astype(np.float32)
    _layer_parity(jcore.DenseLayer(n_out=5, activation=act),
                  tcore.DenseLayer(n_out=5, activation=act), x)


def test_activation_layer_matches_jax():
    x = np.random.default_rng(11).standard_normal((4, 7)).astype(np.float32)
    _layer_parity(jcore.ActivationLayer(activation="relu"),
                  tcore.ActivationLayer(activation="relu"), x)


@pytest.mark.parametrize("act,loss", [("softmax", "mcxent"),
                                      ("sigmoid", "xent"),
                                      ("identity", "mse"),
                                      ("softmax", "kl_divergence")])
def test_output_layer_loss_and_grads_match_jax(act, loss):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((4, 7)).astype(np.float32)
    labels = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 4)]
    jl = jcore.OutputLayer(n_out=5, activation=act, loss=loss)
    tl = tcore.OutputLayer(n_out=5, activation=act, loss=loss)
    jp, _, _ = jl.init(jax.random.PRNGKey(0), (7,))
    jv, jg = jax.value_and_grad(
        lambda p, x_: jl.compute_loss(p, x_, jnp.asarray(labels)),
        argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: _t(v, grad=True) for k, v in jp.items()}
    xt = _t(x, grad=True)
    v = tl.compute_loss(tp, xt, _t(labels))
    g = torch.autograd.grad(v, [xt, tp["W"], tp["b"]])
    np.testing.assert_allclose(v.item(), float(jv), rtol=1e-6, atol=ATOL)
    for a, b in zip(g, (jg[1], jg[0]["W"], jg[0]["b"])):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=ATOL)
    y, _ = tl.apply(tp, {}, xt, Ctx())
    jy, _ = jl.apply(jp, {}, jnp.asarray(x), JCtx())
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=ATOL)


def test_loss_layer_matches_jax():
    rng = np.random.default_rng(13)
    x = rng.standard_normal((4, 5)).astype(np.float32)
    labels = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 4)]
    jv = jcore.LossLayer(activation="softmax", loss="mcxent").compute_loss(
        jnp.asarray(x), jnp.asarray(labels))
    v = tcore.LossLayer(activation="softmax", loss="mcxent").compute_loss(
        _t(x), _t(labels))
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-6)


def test_dense_init_shapes_and_fans_match_jax():
    from deeplearning4j_tpu.nn import weights as jw
    for shape in [(), (5,), (3, 4), (3, 3, 2, 8)]:
        assert twts.compute_fans(shape) == jw.compute_fans(shape)
    layer = tcore.DenseLayer(n_out=3)
    p, _, out = layer.init(torch.Generator().manual_seed(0), (4,))
    assert p["W"].shape == (4, 3) and out == (3,)
    assert layer.n_params((4,)) == 15


@pytest.mark.parametrize("name", sorted(twts._REGISTRY))
def test_weight_inits_have_the_reference_distribution(name):
    """Draws are not JAX's bits; each initializer must give the shape,
    dtype and (for the random ones) the scale of the reference's."""
    from deeplearning4j_tpu.nn import weights as jw
    shape = (3, 3, 16, 32)
    fi, fo = twts.compute_fans(shape)
    got = twts.get(name)(torch.Generator().manual_seed(0), shape, fi, fo)
    want = np.asarray(jw.get(name)(jax.random.PRNGKey(0), shape, fi, fo))
    assert tuple(got.shape) == shape and got.dtype == torch.float32
    np.testing.assert_allclose(float(got.std()), float(want.std()),
                               rtol=0.1, atol=1e-6)
    np.testing.assert_allclose(float(got.mean()), float(want.mean()),
                               atol=0.1 * max(float(want.std()), 1e-3) + 1e-6)


# ----------------------------------------------------------------- vertices

@pytest.mark.parametrize("jv,tv,n_in", [
    (jvert.MergeVertex(), tvert.MergeVertex(), 2),
    (jvert.ElementWiseVertex("add"), tvert.ElementWiseVertex("add"), 3),
    (jvert.ElementWiseVertex("sub"), tvert.ElementWiseVertex("sub"), 2),
    (jvert.ElementWiseVertex("mul"), tvert.ElementWiseVertex("mul"), 2),
    (jvert.ElementWiseVertex("avg"), tvert.ElementWiseVertex("avg"), 3),
    (jvert.ElementWiseVertex("max"), tvert.ElementWiseVertex("max"), 2),
    (jvert.SubsetVertex(1, 3), tvert.SubsetVertex(1, 3), 1),
    (jvert.StackVertex(), tvert.StackVertex(), 2),
    (jvert.UnstackVertex(1, 2), tvert.UnstackVertex(1, 2), 1),
    (jvert.L2NormalizeVertex(), tvert.L2NormalizeVertex(), 1),
    (jvert.L2Vertex(), tvert.L2Vertex(), 2),
    (jvert.ScaleVertex(2.5), tvert.ScaleVertex(2.5), 1),
    (jvert.ShiftVertex(-1.5), tvert.ShiftVertex(-1.5), 1),
    (jvert.ReshapeVertex((3, 2)), tvert.ReshapeVertex((3, 2)), 1),
    (jvert.PreprocessorVertex(jpre.CnnToFeedForwardPreProcessor()),
     tvert.PreprocessorVertex(tpre.CnnToFeedForwardPreProcessor()), 1),
], ids=lambda v: type(v).__name__ if not isinstance(v, int) else str(v))
def test_vertex_matches_jax(jv, tv, n_in):
    rng = np.random.default_rng(14)
    xs = [rng.standard_normal((4, 6)).astype(np.float32) for _ in range(n_in)]
    got = tv.apply([_t(x) for x in xs])
    want = jv.apply([jnp.asarray(x) for x in xs])
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    shapes = [(6,)] * n_in
    assert tuple(tv.out_shape(shapes)) == tuple(jv.out_shape(shapes))


@pytest.mark.parametrize("jp,tp,shape", [
    (jpre.CnnToFeedForwardPreProcessor(), tpre.CnnToFeedForwardPreProcessor(),
     (2, 3, 4, 5)),
    (jpre.FeedForwardToCnnPreProcessor(3, 4, 5),
     tpre.FeedForwardToCnnPreProcessor(3, 4, 5), (2, 60)),
    (jpre.RnnToFeedForwardPreProcessor(), tpre.RnnToFeedForwardPreProcessor(),
     (2, 7, 5)),
    (jpre.FeedForwardToRnnPreProcessor(7), tpre.FeedForwardToRnnPreProcessor(7),
     (14, 5)),
    (jpre.CnnToRnnPreProcessor(), tpre.CnnToRnnPreProcessor(), (2, 3, 4, 5)),
    (jpre.RnnToCnnPreProcessor(3, 4, 5), tpre.RnnToCnnPreProcessor(3, 4, 5),
     (2, 3, 20)),
], ids=lambda p: type(p).__name__ if not isinstance(p, tuple) else "x")
def test_preprocessor_matches_jax(jp, tp, shape):
    x = np.random.default_rng(15).standard_normal(shape).astype(np.float32)
    np.testing.assert_allclose(_np(tp(_t(x))), np.asarray(jp(jnp.asarray(x))))
    assert tuple(tp.out_shape(shape[1:])) == tuple(jp.out_shape(shape[1:]))


# -------------------------------------------------------------- batch norm

def _bn_state(c, rng):
    return {"mean": jnp.asarray(rng.standard_normal(c).astype(np.float32)
                                * 0.3),
            "var": jnp.asarray(rng.uniform(0.5, 2.0, c).astype(np.float32))}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("act", ["relu", "identity", "tanh"])
def test_batchnorm_train_matches_jax(fused, act):
    """Batch-stats BN from a warm running mean: output, running-stat
    updates and grads; ``fused=True`` is the K3 path on both sides
    (plain versions here, the Pallas kernels in interpret mode there)."""
    rng = np.random.default_rng(16)
    x = (rng.standard_normal((8, 4, 4, 12)) * 2 + 1).astype(np.float32)
    state = _bn_state(12, rng)
    params = {"gamma": jnp.asarray(rng.uniform(0.5, 2, 12).astype(np.float32)),
              "beta": jnp.asarray(rng.standard_normal(12).astype(np.float32))}
    kw = dict(activation=act, fused=fused)
    _layer_parity(jnorm.BatchNormalization(**kw),
                  tnorm.BatchNormalization(**kw), x, train=True,
                  state=state, params=params)


@pytest.mark.parametrize("fused", [False, True, "auto"])
@pytest.mark.parametrize("act", ["relu", "identity", "swish"])
def test_batchnorm_inference_matches_jax(fused, act):
    rng = np.random.default_rng(17)
    x = rng.standard_normal((6, 5, 5, 8)).astype(np.float32)
    state = _bn_state(8, rng)
    kw = dict(activation=act, fused=fused)
    y, ns = _layer_parity(jnorm.BatchNormalization(**kw),
                          tnorm.BatchNormalization(**kw), x, train=False,
                          state=state)
    if act == "relu":
        assert y.min().item() >= 0.0


def test_batchnorm_fused_and_plain_agree_in_the_port():
    """The reference's fused-vs-plain checks (tests/test_kernels.py:147,
    :262) on the port's side, through the layer."""
    rng = np.random.default_rng(18)
    x = torch.as_tensor(rng.standard_normal((8, 4, 4, 12)).astype(np.float32))
    plain = tnorm.BatchNormalization(activation="relu", fused=False)
    fused = tnorm.BatchNormalization(activation="relu", fused=True)
    params, state, _ = plain.init(torch.Generator().manual_seed(0), (4, 4, 12))
    _, state = plain.apply(params, state, x, Ctx(train=True))
    y_p, st_p = plain.apply(params, state, x, Ctx(train=True))
    y_f, st_f = fused.apply(params, state, x, Ctx(train=True))
    torch.testing.assert_close(y_f, y_p, atol=1e-4, rtol=0)
    for k in ("mean", "var"):
        torch.testing.assert_close(st_f[k], st_p[k], atol=1e-5, rtol=1e-4)
    y_p, _ = plain.apply(params, state, x, Ctx(train=False))
    y_f, _ = fused.apply(params, state, x, Ctx(train=False))
    torch.testing.assert_close(y_f, y_p, atol=1e-5, rtol=0)


def test_batchnorm_fused_path_refuses_a_strided_input():
    layer = tnorm.BatchNormalization(activation="relu", fused=True)
    params, state, _ = layer.init(torch.Generator(), (4, 4, 6))
    x = torch.randn(2, 6, 4, 4).permute(0, 2, 3, 1)   # NHWC view of NCHW
    with pytest.raises(ValueError, match="contiguous"):
        layer.apply(params, state, x, Ctx(train=True))


def test_batchnorm_lock_gamma_beta_matches_jax():
    rng = np.random.default_rng(19)
    x = rng.standard_normal((6, 3, 3, 4)).astype(np.float32)
    for train in (True, False):
        _layer_parity(jnorm.BatchNormalization(lock_gamma_beta=True),
                      tnorm.BatchNormalization(lock_gamma_beta=True), x,
                      train=train, state=_bn_state(4, rng))


@pytest.mark.parametrize("jl,tl", [
    (jnorm.LayerNormalization(), tnorm.LayerNormalization()),
    (jnorm.RMSNorm(), tnorm.RMSNorm()),
    (jnorm.LocalResponseNormalization(), tnorm.LocalResponseNormalization()),
], ids=["layernorm", "rmsnorm", "lrn"])
def test_other_norms_match_jax(jl, tl):
    x = np.random.default_rng(20).standard_normal((2, 3, 3, 7)) \
        .astype(np.float32)
    _layer_parity(jl, tl, x)


# ------------------------------------------------------------------ updaters

UPDATERS = [
    (jupd.Sgd(0.1), tupd.Sgd(0.1)),
    (jupd.Momentum(0.1, 0.9), tupd.Momentum(0.1, 0.9)),
    (jupd.Nesterovs(0.05, 0.8), tupd.Nesterovs(0.05, 0.8)),
    (jupd.Adam(1e-2), tupd.Adam(1e-2)),
    (jupd.AdamW(1e-2, weight_decay=0.1), tupd.AdamW(1e-2, weight_decay=0.1)),
    (jupd.NoOp(), tupd.NoOp()),
]


def _tree(rng):
    return {"a": {"W": rng.standard_normal((3, 4)).astype(np.float32),
                  "b": rng.standard_normal(4).astype(np.float32)},
            "c": {},
            "d": {"gamma": rng.standard_normal(5).astype(np.float32)}}


def _run_both(jopt, topt, steps=5):
    rng = np.random.default_rng(21)
    p0 = _tree(rng)
    grads = [_tree(rng) for _ in range(steps)]
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = jopt.init(jp)
    tp = tupd.tree_map(lambda a: torch.as_tensor(a.copy()), p0)
    ts = topt.init(tp)
    for g in grads:
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update(tupd.tree_map(torch.as_tensor, g), ts, tp)
        tp = tupd.tree_map(lambda p, u: p + u, tp, tu)
        for n in p0:
            for k in p0[n]:
                np.testing.assert_allclose(tp[n][k].numpy(),
                                           np.asarray(jp[n][k]), atol=ATOL,
                                           err_msg=f"{n}/{k}")


@pytest.mark.parametrize("jupdater,tupdater", UPDATERS,
                         ids=lambda u: type(u).__name__)
def test_updater_5_steps_match_optax(jupdater, tupdater):
    _run_both(jupdater.to_optax(), tupdater.to_transform())


@pytest.mark.parametrize("kw", [
    dict(grad_norm="renormalize_l2_per_layer"),
    dict(grad_norm="clip_element_wise_absolute_value",
         grad_norm_threshold=0.5),
    dict(grad_norm="clip_l2_per_param_type", grad_norm_threshold=1.0),
    dict(l2=1e-2), dict(l1=1e-3), dict(weight_decay=5e-3),
    dict(l1=1e-3, l2=1e-2, weight_decay=1e-3,
         grad_norm="clip_l2_per_layer"),
], ids=lambda kw: "+".join(sorted(kw)))
def test_build_optimizer_compositions_match_optax(kw):
    _run_both(jupd.build_optimizer(jupd.Momentum(0.1, 0.9), **kw),
              tupd.build_optimizer(tupd.Momentum(0.1, 0.9), **kw))


def test_build_optimizer_per_label_multi_transform_matches_optax():
    labels = {"a": {"W": "__default__", "b": "__default__"}, "c": {},
              "d": {"gamma": "__frozen__"}}
    jopt = jupd.build_optimizer(
        jupd.Adam(1e-2), param_labels=labels,
        per_label_updaters={"__default__": jupd.Adam(1e-2),
                            "__frozen__": jupd.NoOp()})
    topt = tupd.build_optimizer(
        tupd.Adam(1e-2), param_labels=labels,
        per_label_updaters={"__default__": tupd.Adam(1e-2),
                            "__frozen__": tupd.NoOp()})
    _run_both(jopt, topt)


def test_unported_updater_features_raise():
    # schedules are ported (tests/test_torch_updaters.py); an lr must be a
    # number or a Schedule, whose step-side form runs on the device
    with pytest.raises(TypeError, match="Schedule"):
        tupd.Sgd(learning_rate=lambda step: 0.1).to_transform()
    with pytest.raises(NotImplementedError, match="abstract"):
        tupd.Updater().to_transform()
