"""The port's fused BatchNorm + activation (K3) against the JAX package's.

On the CPU the port's wrappers run their kernels' plain versions; the
JAX side runs ``fused_bn_act`` / ``fused_bn_act_train`` with
``interpret=True``, so its Pallas kernels really execute (in interpret
mode) wherever ``plan_blocks`` finds a block. Shapes and tolerances are
those of ``tests/test_kernels.py``: f32 forward atol 1e-5, mean/var
atol 1e-5, gradients atol 5e-4 (the kernels' analytic backward against
autodiff summation order); bf16 outputs and gradients atol 2e-2 (one
bf16 rounding of values of order 1). The CUDA kernels are held to these
same plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 7).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import fused_ops as jfo
from deeplearning4j_tpu_torch.kernels import fused_ops as tfo

torch.set_num_threads(2)

FWD_ATOL = 1e-5
GRAD_ATOL = 5e-4
BF16_ATOL = 2e-2


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float32))


def _np(t):
    return t.detach().float().numpy()


def _affine(rng, n, c):
    x = rng.standard_normal((n, c)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, c).astype(np.float32)
    shift = rng.standard_normal(c).astype(np.float32)
    return x, scale, shift


def _train_inputs(rng, n, c):
    x = rng.standard_normal((n, c)).astype(np.float32) * 2 + 1.5
    gamma = rng.uniform(0.5, 2.0, c).astype(np.float32)
    beta = rng.standard_normal(c).astype(np.float32)
    center = rng.standard_normal(c).astype(np.float32) * 0.1
    return x, gamma, beta, center


def test_activation_tables_match_the_reference():
    assert list(tfo._ACTS) == list(jfo._ACTS)
    assert set(tfo._ACT_GRADS) == set(jfo._ACT_GRADS)
    for name in list(jfo._ACTS) + ["gelu_exact", None, 3]:
        assert tfo.supported_activation(name) == jfo.supported_activation(name)
        assert tfo.supported_train_activation(name) == \
            jfo.supported_train_activation(name)
    z = np.linspace(-8, 8, 401).astype(np.float32)
    for name, fn in jfo._ACTS.items():
        np.testing.assert_allclose(_np(tfo._ACTS[name](_t(z))),
                                   np.asarray(fn(jnp.asarray(z))),
                                   atol=1e-6, err_msg=name)
    for name, fn in jfo._ACT_GRADS.items():
        np.testing.assert_allclose(_np(tfo._ACT_GRADS[name](_t(z))),
                                   np.asarray(fn(jnp.asarray(z))),
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("act", sorted(jfo._ACTS))
def test_fused_bn_act_matches_jax_kernel(act):
    rng = np.random.default_rng(0)
    x, scale, shift = _affine(rng, 384, 24)
    ref = jfo.fused_bn_act(jnp.asarray(x), jnp.asarray(scale),
                           jnp.asarray(shift), act, True)
    got = tfo.fused_bn_act(_t(x), _t(scale), _t(shift), act)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=FWD_ATOL)
    np.testing.assert_allclose(
        _np(tfo.bn_act_reference(_t(x), _t(scale), _t(shift), act)),
        np.asarray(jfo.bn_act_reference(jnp.asarray(x), jnp.asarray(scale),
                                        jnp.asarray(shift), act)),
        atol=FWD_ATOL)


@pytest.mark.parametrize("act", sorted(jfo._ACTS))
def test_fused_bn_act_grads_match_jax_recompute_vjp(act):
    rng = np.random.default_rng(1)
    x, scale, shift = _affine(rng, 384, 24)
    w = rng.standard_normal((384, 24)).astype(np.float32)

    def jloss(x_, sc, sh):
        return jnp.sum(jfo.fused_bn_act(x_, sc, sh, act, True) * w)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale),
                                            jnp.asarray(shift))
    ts = [_t(a).requires_grad_(True) for a in (x, scale, shift)]
    y = tfo.fused_bn_act(*ts, act)
    tg = torch.autograd.grad((y * _t(w)).sum(), ts)
    for a, b, tag in zip(tg, jg, ("dx", "dscale", "dshift")):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=GRAD_ATOL,
                                   err_msg=f"{act}:{tag}")


@pytest.mark.parametrize("n,c", [(1000, 3), (1000, 5), (256, 64)])
def test_fused_bn_act_odd_shapes(n, c):
    rng = np.random.default_rng(2)
    x, scale, shift = _affine(rng, n, c)
    ref = jfo.fused_bn_act(jnp.asarray(x), jnp.asarray(scale),
                           jnp.asarray(shift), "relu", True)
    got = tfo.fused_bn_act(_t(x), _t(scale), _t(shift), "relu")
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=FWD_ATOL)


def test_fused_bn_act_bf16_cotangent_gives_bf16_grad():
    """The reference's r4 regression (tests/test_kernels.py:292): a bf16
    x accepts the bf16 cotangent and returns a bf16 gradient, and it
    agrees with the JAX gradient."""
    rng = np.random.default_rng(0)
    xn = rng.standard_normal((8, 128))
    scale = np.random.default_rng(1).random(128).astype(np.float32)
    shift = np.random.default_rng(2).random(128).astype(np.float32)

    def f(x_):
        y = jfo.fused_bn_act(x_, jnp.asarray(scale), jnp.asarray(shift),
                             "relu", True)
        return jnp.sum(y * y)

    jg = jax.grad(f)(jnp.asarray(xn, jnp.bfloat16))
    x = torch.as_tensor(xn).to(torch.bfloat16).requires_grad_(True)
    y = tfo.fused_bn_act(x, _t(scale), _t(shift), "relu")
    assert y.dtype == torch.bfloat16
    (g,) = torch.autograd.grad((y * y).sum(), x)
    assert g.dtype == torch.bfloat16
    assert bool(torch.isfinite(g.float()).all())
    np.testing.assert_allclose(_np(g), np.asarray(jg, np.float32),
                               atol=BF16_ATOL, rtol=BF16_ATOL)


@pytest.mark.parametrize("act", sorted(jfo._ACT_GRADS))
def test_fused_bn_act_train_matches_jax_kernels(act):
    """Values, batch mean/var and dx/dgamma/dbeta of the training BN
    against the JAX Pallas kernels (stats, normalize, reduce, dx) in
    interpret mode, with a warm center so the shift matters."""
    rng = np.random.default_rng(3)
    x, gamma, beta, center = _train_inputs(rng, 512, 16)
    eps = 1e-5
    y, mean, var = jfo.fused_bn_act_train(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
        jnp.asarray(center), eps, act, True)
    ty, tmean, tvar = tfo.fused_bn_act_train(_t(x), _t(gamma), _t(beta),
                                             _t(center), eps, act)
    np.testing.assert_allclose(_np(ty), np.asarray(y), atol=FWD_ATOL)
    np.testing.assert_allclose(_np(tmean), np.asarray(mean), atol=FWD_ATOL)
    np.testing.assert_allclose(_np(tvar), np.asarray(var), atol=FWD_ATOL)
    assert not tmean.requires_grad and not tvar.requires_grad

    def jloss(x_, g_, b_):
        y_, _, _ = jfo.fused_bn_act_train(x_, g_, b_, jnp.asarray(center),
                                          eps, act, True)
        return jnp.sum(jnp.square(y_) * 0.5 + y_ * 0.25)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    ts = [_t(a).requires_grad_(True) for a in (x, gamma, beta)]
    ty, _, _ = tfo.fused_bn_act_train(*ts, _t(center), eps, act)
    tg = torch.autograd.grad((torch.square(ty) * 0.5 + ty * 0.25).sum(), ts)
    for a, b, tag in zip(tg, jg, ("dx", "dgamma", "dbeta")):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=GRAD_ATOL,
                                   err_msg=f"{act}:{tag}")


@pytest.mark.parametrize("act", ["identity", "relu"])
def test_fused_bn_act_train_plain_pieces_match_jax(act):
    """The plain stats and backward formulas, piece by piece, against the
    reference's (fused_ops.py:157-167 and :292-302, the path its kernels
    implement)."""
    rng = np.random.default_rng(4)
    x, gamma, beta, center = _train_inputs(rng, 300, 7)
    g = rng.standard_normal((300, 7)).astype(np.float32)
    mean, var = jfo._train_stats(jnp.asarray(x), jnp.asarray(center))
    tmean, tvar = tfo.train_stats_reference(_t(x), _t(center))
    np.testing.assert_allclose(_np(tmean), np.asarray(mean), atol=FWD_ATOL)
    np.testing.assert_allclose(_np(tvar), np.asarray(var), atol=FWD_ATOL)
    inv = 1.0 / np.sqrt(np.asarray(var) + 1e-5)
    res = (jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), mean,
           jnp.asarray(inv))
    jdx, jdg, jdb, jdc = jfo._train_bwd(1e-5, act, True, res,
                                        (jnp.asarray(g), None, None))
    tdx, tdg, tdb = tfo.bn_bwd_reference(_t(x), _t(g), _t(gamma), _t(beta),
                                         tmean, _t(inv), act)
    for a, b in ((tdx, jdx), (tdg, jdg), (tdb, jdb)):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=GRAD_ATOL)
    assert float(jnp.abs(jdc).max()) == 0.0


def test_fused_bn_act_train_bf16_matches_jax():
    rng = np.random.default_rng(5)
    x, gamma, beta, center = _train_inputs(rng, 256, 32)
    xb = jnp.asarray(x, jnp.bfloat16)
    y, mean, var = jfo.fused_bn_act_train(
        xb, jnp.asarray(gamma), jnp.asarray(beta), jnp.asarray(center),
        1e-5, "relu", True)
    tx = torch.as_tensor(np.array(xb.astype(jnp.float32))) \
        .to(torch.bfloat16).requires_grad_(True)
    ty, tmean, tvar = tfo.fused_bn_act_train(tx, _t(gamma), _t(beta),
                                             _t(center), 1e-5, "relu")
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(ty), np.asarray(y, np.float32),
                               atol=BF16_ATOL)
    np.testing.assert_allclose(_np(tmean), np.asarray(mean), atol=1e-5)
    np.testing.assert_allclose(_np(tvar), np.asarray(var), rtol=1e-5)
    (gx,) = torch.autograd.grad(ty.float().sum(), tx)
    assert gx.dtype == torch.bfloat16

    def jloss(x_):
        return jnp.sum(jfo.fused_bn_act_train(
            x_, jnp.asarray(gamma), jnp.asarray(beta), jnp.asarray(center),
            1e-5, "relu", True)[0].astype(jnp.float32))

    np.testing.assert_allclose(_np(gx), np.asarray(jax.grad(jloss)(xb),
                                                   np.float32),
                               atol=BF16_ATOL)


def test_unsupported_activations_are_refused():
    x = torch.zeros((4, 3))
    v = torch.ones(3)
    with pytest.raises(ValueError, match="no fused BN kernel"):
        tfo.fused_bn_act(x, v, v, "selu")
    with pytest.raises(ValueError, match="no fused BN kernel"):
        tfo.fused_bn_act_train(x, v, v, v, 1e-5, "gelu")


def test_cpu_tensors_never_count_a_launch():
    tfo.reset_launches()
    rng = np.random.default_rng(6)
    x, gamma, beta, center = _train_inputs(rng, 64, 8)
    xs = _t(x).requires_grad_(True)
    y, _, _ = tfo.fused_bn_act_train(xs, _t(gamma), _t(beta), _t(center),
                                     1e-5, "relu")
    y.sum().backward()
    tfo.fused_bn_act(_t(x), _t(gamma), _t(beta), "relu")
    assert (tfo.LAUNCHES, tfo.LAUNCHES_STATS, tfo.LAUNCHES_BWD_REDUCE,
            tfo.LAUNCHES_BWD_DX) == (0, 0, 0, 0)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers take CUDA rows only: a CPU tensor handed to a
    kernel wrapper raises instead of running anything."""
    x = torch.zeros((4, 8))
    v = torch.ones(8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfo.bn_act(x, v, v, "relu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfo.bn_stats(x, v, v, v)


@pytest.mark.parametrize("n,c,width", [(1605632, 64, 8), (401408, 256, 8),
                                       (6272, 2048, 8), (1000, 3, 1),
                                       (100352, 512, 4)])
def test_reduce_plan_covers_every_row_once(n, c, width):
    tcv, rows, chunks = tfo.reduce_plan(n, c, width, 4)
    lanes = 256 // tcv
    assert 1 <= tcv <= 32 and tcv * lanes <= 256
    assert (chunks - 1) * rows < n <= chunks * rows
    cv = -(-c // width)
    assert -(-cv // tcv) * tcv >= cv


# every (N, C) a ResNet-50 BN hands K3 at batch 128 (chip_smoke.py phase
# 7), with the 16-byte widths of bf16 (8) and f32 (4), plus odd shapes
PLAN_SHAPES = [(128 * hw * hw, c, w)
               for hw, c in ((112, 64), (56, 64), (56, 256), (28, 128),
                             (28, 512), (14, 256), (14, 1024), (7, 512),
                             (7, 2048))
               for w in (8, 4)] + [(1000, 3, 1), (1000, 5, 1), (1000, 24, 8),
                                   (384, 24, 4), (7, 2048, 1), (1, 64, 8)]


@pytest.mark.parametrize("depth", [4, 3])
@pytest.mark.parametrize("n,c,width", PLAN_SHAPES)
def test_reduce_plan_reckons_bytes(n, c, width, depth):
    """The one-launch reductions' plan: a function of (n, c, width) and
    the kernel's depth alone (the fixed summation order rests on it);
    every row in exactly one chunk; 128-byte channel tiles (8 vectors, or
    32 scalars); no more blocks than one wave ``depth`` deep holds; every
    block streams at least _MIN_BLOCK_ELEMS elements unless the plan has
    one chunk; one chunk for tiny N; and at least 2 blocks per SM
    wherever N allows it."""
    plan = tfo.reduce_plan(n, c, width, depth)
    assert plan == tfo.reduce_plan(n, c, width, depth)
    tcv, rows, chunks = plan
    cv = -(-c // width)
    assert tcv == min(cv, 8 if width > 1 else 32)
    tiles = -(-cv // tcv)
    assert (chunks - 1) * rows < n <= chunks * rows
    assert chunks * tiles <= 132 * depth or chunks == 1
    elems = tcv * width
    if chunks > 1:
        assert rows * elems >= tfo._MIN_BLOCK_ELEMS
    if n * elems < 2 * tfo._MIN_BLOCK_ELEMS:
        assert chunks == 1
    lanes = 256 // tcv
    if n * elems >= 2 * 132 * tfo._MIN_BLOCK_ELEMS and n >= 264 * lanes:
        assert chunks * tiles >= 2 * 132


def test_reduce_plan_at_the_smallest_resnet_shape():
    """(6272, 512) bf16, the s3 a/b BNs: about 200 blocks (was 1046),
    and a workspace of under 0.5 MB (was 2.1 MB)."""
    for kernel, depth in tfo._DEPTH.items():
        tcv, rows, chunks = tfo.reduce_plan(6272, 512, 8, depth)
        tiles = 512 // (8 * tcv)
        assert (tcv, tiles) == (8, 8) and 100 <= chunks * tiles <= 200
        assert chunks * 2 * 512 * 4 < 500_000
