"""The port's layer breadth against the JAX package's, on the CPU: the
core layers (embeddings, PReLU, elementwise scaling, mask, reshape,
permute and the CnnLoss, CenterLoss and OCNN heads), the convolution
family (1-D, 3-D, transposed, depthwise, separable, pooling, upsampling,
cropping, padding, depth-to-space, locally connected), ``ConvLSTM2D``,
the capsule layers and the variational autoencoder.

Each case inits the JAX layer, copies its params to the port with
``nn.params_from_numpy`` (so the port runs the JAX package's weights),
feeds both the same seeded numpy input and holds the outputs, and the
gradients of a seeded linear functional of them with respect to params
and input. Tolerances, f32: values atol 1e-5, gradients atol 1e-4 (the
port's other layer tests' tolerances); shapes exactly.
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
from deeplearning4j_tpu.nn.layers import capsule as jcap
from deeplearning4j_tpu.nn.layers import conv as jconv
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.layers import variational as jvae
from deeplearning4j_tpu.nn.layers.base import Ctx as JCtx
from deeplearning4j_tpu_torch.nn import params_from_numpy
from deeplearning4j_tpu_torch.nn.layers import capsule as tcap
from deeplearning4j_tpu_torch.nn.layers import conv as tconv
from deeplearning4j_tpu_torch.nn.layers import core as tcore
from deeplearning4j_tpu_torch.nn.layers import recurrent as trec
from deeplearning4j_tpu_torch.nn.layers import variational as tvae
from deeplearning4j_tpu_torch.nn.layers.base import Ctx
from deeplearning4j_tpu_torch.train.updaters import tree_leaves

torch.set_num_threads(2)

ATOL = 1e-5
GRAD_ATOL = 1e-4


def _np(t):
    return t.detach().float().numpy()


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _port_trees(jp, js):
    return params_from_numpy(_np_tree(jp), _np_tree(js), "cpu")


def check_layer(jlayer, tlayer, in_shape, x=None, batch=2, mask=None,
                grads=True, atol=ATOL, seed=0):
    """Init the JAX layer, run both on its params and the same input;
    hold output shapes, values and (``grads``) the gradients of
    sum(y · g) for a seeded g w.r.t. params and a float input."""
    rng = np.random.default_rng(seed)
    jp, js, jout = jlayer.init(jax.random.PRNGKey(seed), in_shape)
    _, _, tout = tlayer.init(torch.Generator().manual_seed(seed), in_shape)
    assert tuple(tout) == tuple(jout)
    tp, ts = _port_trees(jp, js)
    if x is None:
        x = rng.standard_normal((batch,) + tuple(in_shape)).astype(
            np.float32)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.as_tensor(mask)
    yj, _ = jlayer.apply(jp, js, jnp.asarray(x), JCtx(mask=jmask))
    xt = torch.as_tensor(x)
    floating = xt.is_floating_point()
    if floating and grads:
        xt.requires_grad_(True)
    yt, _ = tlayer.apply(tp, ts, xt, Ctx(mask=tmask))
    assert tuple(yt.shape) == tuple(yj.shape)
    np.testing.assert_allclose(_np(yt), np.asarray(yj), atol=atol,
                               rtol=1e-5)
    if not grads:
        return yt
    g = rng.standard_normal(tuple(yj.shape)).astype(np.float32)

    def f(p, xx):
        y, _ = jlayer.apply(p, js, xx, JCtx(mask=jmask))
        return jnp.sum(y * g)

    argnums = (0, 1) if floating else (0,)
    jg = jax.grad(f, argnums=argnums)(jp, jnp.asarray(x))
    leaves = tree_leaves(tp) + ([xt] if floating else [])
    tg = torch.autograd.grad((yt * torch.as_tensor(g)).sum(), leaves,
                             allow_unused=True)
    jl = jax.tree_util.tree_leaves(jg[0]) + ([jg[1]] if floating else [])
    assert len(jl) == len(tg)
    for a, b in zip(jl, tg):
        b = torch.zeros(a.shape) if b is None else b
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=GRAD_ATOL,
                                   rtol=1e-4)
    return yt


def _pair(name, **kw):
    """The same layer config in both packages (module by class name)."""
    for jm, tm in ((jcore, tcore), (jconv, tconv), (jrec, trec),
                   (jcap, tcap), (jvae, tvae)):
        if hasattr(jm, name) and hasattr(tm, name):
            return getattr(jm, name)(**kw), getattr(tm, name)(**kw)
    raise KeyError(name)


# ---------------------------------------------------------------- core
def test_embedding_layers():
    ids = np.random.default_rng(0).integers(0, 11, (5,)).astype(np.int32)
    check_layer(*_pair("EmbeddingLayer", n_in=11, n_out=6, has_bias=True,
                       activation="tanh"), (1,), x=ids[:, None])
    seq = np.random.default_rng(1).integers(0, 11, (3, 7)).astype(np.int32)
    check_layer(*_pair("EmbeddingSequenceLayer", n_in=11, n_out=6),
                (7,), x=seq)


@pytest.mark.parametrize("shared", [(), (0, 1)])
def test_prelu(shared):
    j, t = _pair("PReLULayer", alpha_init=0.1, shared_axes=shared)
    check_layer(j, t, (4, 5, 3))


def test_elementwise_multiplication():
    check_layer(*_pair("ElementWiseMultiplicationLayer", n_out=7,
                       activation="sigmoid"), (7,))


@pytest.mark.parametrize("rank", [2, 3])
def test_mask_layer(rank):
    mask = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], np.float32) if rank == 3 \
        else np.array([1.0, 0.0], np.float32)
    shape = (4, 5) if rank == 3 else (5,)
    check_layer(*_pair("MaskLayer"), shape, mask=mask)


def test_reshape_and_permute():
    check_layer(*_pair("ReshapeLayer", target_shape=(3, -1)), (4, 6))
    check_layer(*_pair("PermuteLayer", dims=(2, 3, 1)), (4, 5, 3))


def test_cnn_loss_layer():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    y = (rng.random((2, 4, 4, 3)) > 0.5).astype(np.float32)
    mask = (rng.random((2, 4, 4)) > 0.3).astype(np.float32)
    j, t = _pair("CnnLossLayer", activation="sigmoid", loss="binary_xent")
    xt = torch.as_tensor(x).requires_grad_(True)
    lt = t.compute_loss(xt, torch.as_tensor(y), torch.as_tensor(mask))
    lj, gj = jax.value_and_grad(lambda a: j.compute_loss(
        a, jnp.asarray(y), jnp.asarray(mask)))(jnp.asarray(x))
    np.testing.assert_allclose(float(lt), float(lj), atol=ATOL)
    (gt,) = torch.autograd.grad(lt, xt)
    np.testing.assert_allclose(_np(gt), np.asarray(gj), atol=GRAD_ATOL)


def test_center_loss_head_loss_and_state():
    rng = np.random.default_rng(0)
    j, t = _pair("CenterLossOutputLayer", n_out=4, alpha=0.3, lambda_=0.1)
    jp, js, _ = j.init(jax.random.PRNGKey(0), (6,))
    js = {"centers": jnp.asarray(rng.standard_normal((4, 6)), jnp.float32)}
    tp, ts = _port_trees(jp, js)
    x = rng.standard_normal((5, 6)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 5)]
    lj = j.compute_loss(jp, jnp.asarray(x), jnp.asarray(y), state=js)
    lt = t.compute_loss(tp, torch.as_tensor(x), torch.as_tensor(y),
                        state=ts)
    np.testing.assert_allclose(float(lt), float(lj), atol=ATOL)
    sj = j.update_state(js, jnp.asarray(x), jnp.asarray(y))
    st = t.update_state(ts, torch.as_tensor(x), torch.as_tensor(y))
    np.testing.assert_allclose(_np(st["centers"]), np.asarray(sj["centers"]),
                               atol=ATOL)


def test_ocnn_head_loss_and_state():
    rng = np.random.default_rng(0)
    j, t = _pair("OCNNOutputLayer", hidden_size=5, nu=0.2)
    jp, js, jout = j.init(jax.random.PRNGKey(0), (6,))
    tp, ts = _port_trees(jp, js)
    x = rng.standard_normal((9, 6)).astype(np.float32)
    check_layer(j, t, (6,), x=x)
    lj, gj = jax.value_and_grad(lambda p: j.compute_loss(
        p, jnp.asarray(x), None, state=js))(jp)
    lt = t.compute_loss(tp, torch.as_tensor(x), None, state=ts)
    np.testing.assert_allclose(float(lt), float(lj), atol=ATOL)
    gt = torch.autograd.grad(lt, tree_leaves(tp))
    for a, b in zip(jax.tree_util.tree_leaves(gj), gt):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=GRAD_ATOL)
    sj = j.update_state(js, jnp.asarray(x), jp)
    st = t.update_state(ts, torch.as_tensor(x), tp)
    np.testing.assert_allclose(_np(st["r"]), np.asarray(sj["r"]), atol=ATOL)


def _head_net(nn, train, head):
    return (nn.NeuralNetConfiguration.builder().seed(3)
            .updater(train.Adam(1e-2)).list()
            .layer(nn.DenseLayer(n_out=8, activation="tanh"))
            .layer(head).build())


@pytest.mark.parametrize("head", ["center", "ocnn"])
def test_stateful_heads_fit_like_jax(head):
    """Three fit steps of a net ending in CenterLossOutputLayer or
    OCNNOutputLayer: losses, params and the head's running state."""
    def mk(nn):
        if head == "center":
            return nn.CenterLossOutputLayer(n_out=3, alpha=0.5, lambda_=0.5)
        return nn.OCNNOutputLayer(hidden_size=4, nu=0.3)
    jnet = jnn.MultiLayerNetwork(_head_net(jnn, jtrain, mk(jnn))).init((5,))
    tnet = tnn.MultiLayerNetwork(_head_net(tnn, ttrain, mk(tnn))).init(
        (5,), device="cpu")
    tnet.params, tnet.states = _port_trees(jnet.params, jnet.states)
    rng = np.random.default_rng(0)
    for _ in range(3):
        x = rng.standard_normal((6, 5)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
        if head == "ocnn":
            y = np.zeros((6, 1), np.float32)
        lj = jnet.fit(jdata.DataSet(x, y))
        lt = tnet.fit(tdata.DataSet(x, y))
        assert abs(lt - lj) <= ATOL
    for a, b in zip(jax.tree_util.tree_leaves(jnet.params),
                    tree_leaves(tnet.params)):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=ATOL)
    for a, b in zip(jax.tree_util.tree_leaves(jnet.states),
                    tree_leaves(tnet.states)):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=ATOL)


# ---------------------------------------------------------------- conv
@pytest.mark.parametrize("kw", [
    dict(kernel_size=3, stride=1, convolution_mode="same"),
    dict(kernel_size=3, stride=2, convolution_mode="same"),
    dict(kernel_size=4, stride=2, padding=1, convolution_mode="truncate"),
    dict(kernel_size=3, dilation=2, convolution_mode="truncate"),
])
def test_convolution_1d(kw):
    check_layer(*_pair("Convolution1DLayer", n_out=5, activation="relu",
                       **kw), (9, 3))


@pytest.mark.parametrize("kw", [
    dict(kernel_size=(3, 3, 3), convolution_mode="same"),
    dict(kernel_size=(2, 3, 3), stride=(1, 2, 2), convolution_mode="same"),
    dict(kernel_size=(3, 3, 3), padding=(1, 0, 1),
         convolution_mode="truncate"),
])
def test_convolution_3d(kw):
    check_layer(*_pair("Convolution3DLayer", n_out=4, **kw), (5, 6, 7, 2))


@pytest.mark.parametrize("kw", [
    dict(kernel_size=(3, 3), stride=(2, 2), convolution_mode="same"),
    dict(kernel_size=(2, 2), stride=(2, 2), convolution_mode="same"),
    dict(kernel_size=(3, 3), stride=(2, 1), padding=(1, 0),
         convolution_mode="truncate"),
    dict(kernel_size=(4, 4), stride=(3, 3), convolution_mode="truncate"),
])
def test_deconvolution_2d(kw):
    check_layer(*_pair("Deconvolution2D", n_out=3, **kw), (5, 6, 2))


@pytest.mark.parametrize("kw", [
    dict(kernel_size=(3, 3, 3), stride=(2, 2, 2), convolution_mode="same"),
    dict(kernel_size=(2, 3, 3), stride=(1, 2, 2), padding=(0, 1, 1),
         convolution_mode="truncate"),
])
def test_deconvolution_3d(kw):
    check_layer(*_pair("Deconvolution3D", n_out=3, **kw), (3, 4, 5, 2))


@pytest.mark.parametrize("mode,stride", [("same", (1, 1)), ("same", (2, 2)),
                                         ("truncate", (2, 1))])
def test_depthwise_and_separable(mode, stride):
    check_layer(*_pair("DepthwiseConvolution2D", depth_multiplier=2,
                       stride=stride, convolution_mode=mode), (7, 8, 3))
    check_layer(*_pair("SeparableConvolution2D", n_out=5,
                       depth_multiplier=2, stride=stride,
                       convolution_mode=mode, activation="relu"), (7, 8, 3))


@pytest.mark.parametrize("ptype", ["max", "avg", "sum", "pnorm"])
@pytest.mark.parametrize("mode", ["same", "truncate"])
def test_subsampling_1d_and_3d(ptype, mode):
    check_layer(*_pair("Subsampling1DLayer", kernel_size=3, stride=2,
                       pooling_type=ptype, convolution_mode=mode,
                       padding=0 if mode == "same" else 1), (9, 3))
    check_layer(*_pair("Subsampling3DLayer", kernel_size=(2, 3, 2),
                       stride=(2, 2, 1), pooling_type=ptype,
                       convolution_mode=mode), (4, 7, 5, 2))


def test_upsampling_cropping_padding():
    check_layer(*_pair("Upsampling1D", size=3), (4, 2))
    check_layer(*_pair("Upsampling2D", size=(2, 3)), (3, 4, 2))
    check_layer(*_pair("Upsampling3D", size=(2, 1, 2)), (2, 3, 2, 2))
    check_layer(*_pair("Cropping1D", cropping=(1, 2)), (7, 2))
    check_layer(*_pair("Cropping2D", cropping=((1, 0), (2, 1))), (6, 7, 2))
    check_layer(*_pair("Cropping3D", cropping=1), (4, 5, 6, 2))
    check_layer(*_pair("ZeroPadding1DLayer", padding=(2, 1)), (5, 2))
    check_layer(*_pair("ZeroPadding3DLayer", padding=((1, 0), (0, 2),
                                                      (1, 1))), (2, 3, 4, 2))
    check_layer(*_pair("DepthToSpaceLayer", block_size=2), (3, 4, 8))


def test_space_depth_roundtrip():
    x = np.random.default_rng(0).standard_normal((2, 4, 6, 3)).astype(
        np.float32)
    s2d = tconv.SpaceToDepthLayer(block_size=2)
    d2s = tconv.DepthToSpaceLayer(block_size=2)
    y, _ = s2d.apply({}, {}, torch.as_tensor(x), Ctx())
    back, _ = d2s.apply({}, {}, y, Ctx())
    np.testing.assert_array_equal(back.numpy(), x)


def test_locally_connected():
    check_layer(*_pair("LocallyConnected2D", n_out=4, kernel_size=(3, 2),
                       stride=(1, 2), activation="tanh"), (6, 7, 3))
    check_layer(*_pair("LocallyConnected1D", n_out=4, kernel_size=3,
                       stride=2), (9, 3))


# ------------------------------------------------------------ ConvLSTM2D
@pytest.mark.parametrize("seqs", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", ["same", "truncate"])
def test_conv_lstm_2d(seqs, masked, mode):
    mask = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], np.float32) \
        if masked else None
    check_layer(*_pair("ConvLSTM2D", n_out=3, kernel_size=(3, 3),
                       return_sequences=seqs, convolution_mode=mode),
                (4, 5, 6, 2), mask=mask)


# -------------------------------------------------------------- capsules
def test_capsule_stack():
    x = np.random.default_rng(0).standard_normal((2, 12, 12, 2)).astype(
        np.float32)
    jprim, tprim = _pair("PrimaryCapsules", capsules=4, capsule_dimensions=6,
                         kernel_size=(3, 3), stride=(2, 2))
    y1 = check_layer(jprim, tprim, (12, 12, 2), x=x)
    caps_in = tuple(y1.shape[1:])
    check_layer(*_pair("CapsuleLayer", capsules=3, capsule_dimensions=4,
                       routings=3), caps_in)
    check_layer(*_pair("CapsuleStrengthLayer"), (3, 4))
    v = tcap.squash(torch.as_tensor(np.random.default_rng(1)
                                    .standard_normal((4, 5, 8))
                                    .astype(np.float32)))
    assert bool((torch.linalg.norm(v, dim=-1) < 1.0).all())


# ------------------------------------------------------------------- VAE
@pytest.mark.parametrize("dist", ["gaussian", "bernoulli"])
def test_vae_matches_jax(dist):
    j, t = _pair("VariationalAutoencoder", n_in=10, n_out=3,
                 encoder_layer_sizes=(8, 6), decoder_layer_sizes=(7,),
                 reconstruction_distribution=dist, num_samples=2)
    check_layer(j, t, (10,))
    jp, js, _ = j.init(jax.random.PRNGKey(0), (10,))
    tp, _ = _port_trees(jp, js)
    rng = np.random.default_rng(0)
    x = rng.random((4, 10)).astype(np.float32)
    if dist == "bernoulli":
        x = (x > 0.5).astype(np.float32)
    key = jax.random.PRNGKey(7)
    eps = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), (4, 3), jnp.float32)) for i in range(2)])
    lj, gj = jax.value_and_grad(lambda p: j.elbo_loss(
        p, jnp.asarray(x), key))(jp)
    lt = t.elbo_loss(tp, torch.as_tensor(x), eps=torch.as_tensor(eps))
    np.testing.assert_allclose(float(lt), float(lj), atol=ATOL, rtol=1e-5)
    gt = torch.autograd.grad(lt, tree_leaves(tp))
    for a, b in zip(jax.tree_util.tree_leaves(gj), gt):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=GRAD_ATOL)
    with torch.no_grad():
        np.testing.assert_allclose(
            _np(t.reconstruct(tp, torch.as_tensor(x))),
            np.asarray(j.reconstruct(jp, jnp.asarray(x))), atol=ATOL)
        z = rng.standard_normal((4, 3)).astype(np.float32)
        np.testing.assert_allclose(
            _np(t.generate_given_z(tp, torch.as_tensor(z))),
            np.asarray(j.generate_given_z(jp, jnp.asarray(z))), atol=ATOL)
        eps5 = np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(key, i), (4, 3), jnp.float32))
            for i in range(5)])
        np.testing.assert_allclose(
            _np(t.reconstruction_probability(tp, torch.as_tensor(x),
                                             eps=torch.as_tensor(eps5))),
            np.asarray(j.reconstruction_probability(jp, jnp.asarray(x),
                                                    key)), atol=1e-4)


def test_vae_pretrain_lowers_the_elbo():
    vae = tvae.VariationalAutoencoder(n_in=12, n_out=3,
                                      encoder_layer_sizes=(16,),
                                      decoder_layer_sizes=(16,))
    gen = torch.Generator().manual_seed(0)
    p, _, _ = vae.init(gen, (12,))
    p, _ = params_from_numpy(jax.tree_util.tree_map(
        lambda t: t.numpy(), p), {}, "cpu")
    x = np.random.default_rng(0).random((32, 12)).astype(np.float32)
    eps = torch.zeros((1, 32, 3))
    l0 = float(vae.elbo_loss(p, torch.as_tensor(x), eps=eps))
    p, _ = vae.pretrain_fit(p, [x] * 40, updater=ttrain.Adam(1e-2),
                            gen=torch.Generator().manual_seed(1))
    assert float(vae.elbo_loss(p, torch.as_tensor(x), eps=eps)) < l0
