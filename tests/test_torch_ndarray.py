"""The port's ND4J layer (``deeplearning4j_tpu_torch/ndarray/``) against
the JAX package's (``deeplearning4j_tpu/ndarray/``) on the CPU.

Every function of ``tests/test_ndarray.py``'s ten cases runs through both
packages on the same numpy inputs, made from a seed, and the results
agree at 1e-5 (f32). The random module cannot reproduce JAX's bit
streams: it is held to shapes, dtypes, supports, moments (stated
tolerances) and the same draws from the same seed. Creation with
``device=None`` means the card: without one it raises.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nd as jnd
from deeplearning4j_tpu_torch import nd

ATOL = 1e-5
CPU = "cpu"


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy() if a.dtype == torch.bfloat16 \
            else a.detach().numpy()
    return np.asarray(a)


def _close(got, want, atol=ATOL, rtol=1e-5):
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=atol,
                               rtol=rtol)


def test_creation():
    assert nd.zeros(3, 4, device=CPU).shape == (3, 4)
    assert nd.ones((2, 5), device=CPU).shape == (2, 5)
    for name, args in (("full", ((2, 2), 7.0)), ("eye", (3,)),
                       ("arange", (5,)), ("linspace", (0, 1, 5)),
                       ("value_array_of", ((3,), 2.5)),
                       ("tri", (3, 4, 1)), ("zeros", ((2, 3),)),
                       ("ones", (4,))):
        got = getattr(nd, name)(*args, device=CPU)
        want = np.asarray(getattr(jnd, name)(*args))
        _close(got, want)
        assert str(got.dtype).split(".")[-1] == str(want.dtype), name
    data = [[1.0, 2.0], [3.0, 4.0]]
    _close(nd.create(data, device=CPU), jnd.create(data))
    assert nd.create(data, device=CPU).dtype == torch.float32
    assert nd.create(np.arange(3), device=CPU).dtype == torch.int32
    _close(nd.one_hot(np.array([0, 2]), 3), jnd.one_hot(np.array([0, 2]), 3))
    _close(nd.diag(np.arange(3.0), 1), jnd.diag(np.arange(3.0), 1))


def test_default_dtype_and_device():
    nd.set_default_dtype(np.float16)
    try:
        assert nd.default_dtype() == torch.float16
        assert nd.zeros(2, device=CPU).dtype == torch.float16
    finally:
        nd.set_default_dtype(torch.float32)
    assert nd.default_dtype() == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            nd.zeros(2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            nd.random.key(0)


def test_mmul_and_reductions():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((4, 5)).astype(np.float32)
    b = rng.standard_normal((5, 3)).astype(np.float32)
    _close(nd.mmul(a, b), jnd.mmul(a, b))
    _close(nd.dot(a, b), jnd.dot(a, b))
    for fn in ("norm1", "norm2", "normmax", "squared_norm", "sum", "mean",
               "max", "min", "prod", "std", "var", "log_sum_exp"):
        for axis in (None, 0, 1, (0, 1)):
            if fn in ("norm1", "norm2", "normmax", "squared_norm") and \
                    isinstance(axis, tuple):
                continue
            _close(getattr(nd, fn)(a, axis=axis),
                   getattr(jnd, fn)(a, axis=axis), atol=1e-4)
    for fn in ("argmax", "argmin", "cumsum", "cumprod", "count_nonzero"):
        for axis in (None, 0, 1):
            _close(getattr(nd, fn)(a, axis=axis),
                   getattr(jnd, fn)(a, axis=axis), atol=1e-4)
    _close(nd.all(a > -3, axis=1), jnd.all(a > -3, axis=1))
    _close(nd.any(a > 1, axis=0), jnd.any(a > 1, axis=0))
    p = np.abs(a) + 0.1
    _close(nd.entropy(p, axis=1), jnd.entropy(p, axis=1))
    _close(nd.std(a, axis=1, ddof=1), jnd.std(a, axis=1, ddof=1))
    _close(nd.clip_by_norm(a, 1.0, axis=1), jnd.clip_by_norm(a, 1.0, axis=1))


def test_tensor_mmul_einsum_batch():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((2, 3, 4)).astype(np.float32)
    b = rng.standard_normal((4, 3, 5)).astype(np.float32)
    _close(nd.tensor_mmul(a, b, axes=([1, 2], [1, 0])),
           jnd.tensor_mmul(a, b, axes=([1, 2], [1, 0])), atol=1e-4)
    c = rng.standard_normal((2, 4, 3)).astype(np.float32)
    _close(nd.batch_mmul(a, c), jnd.batch_mmul(a, c), atol=1e-4)
    _close(nd.einsum("bij,bjk->bik", a, c),
           jnd.einsum("bij,bjk->bik", a, c), atol=1e-4)
    _close(nd.outer(a[0, 0], b[0, 0]), jnd.outer(a[0, 0], b[0, 0]))
    _close(nd.kron(a[0], b[0, :2]), jnd.kron(a[0], b[0, :2]))


def test_shape_ops():
    a = np.arange(24).reshape(2, 3, 4).astype(np.float32)
    for fn, args in (("permute", (2, 0, 1)), ("reshape", (6, 4)),
                     ("expand_dims", (0,)), ("flip", (1,)),
                     ("tile", ((1, 2, 1),)), ("transpose", ()),
                     ("swap_axes", (0, 2)), ("move_axis", (0, 2)),
                     ("roll", (2, 1)), ("repeat", (2, 1)), ("ravel", ()),
                     ("broadcast_to", ((3, 2, 3, 4),))):
        _close(getattr(nd, fn)(a, *args), getattr(jnd, fn)(a, *args))
    parts, jparts = nd.split(a, 3, axis=1), jnd.split(a, 3, axis=1)
    assert len(parts) == 3 and parts[0].shape == (2, 1, 4)
    for p, q in zip(parts, jparts):
        _close(p, q)
    for p, q in zip(nd.split(a, [1, 3], axis=2), jnd.split(a, [1, 3], axis=2)):
        _close(p, q)
    st = nd.stack([a, a], axis=0)
    _close(st, jnd.stack([a, a], axis=0))
    us = nd.unstack(st, axis=0)
    assert len(us) == 2 and us[0].shape == (2, 3, 4)
    _close(nd.concat([a, a], axis=2), jnd.concat([a, a], axis=2))
    for mode in ("constant", "edge", "reflect", "symmetric", "wrap"):
        _close(nd.pad(a, ((0, 0), (1, 2), (2, 1)), mode=mode),
               jnd.pad(a, ((0, 0), (1, 2), (2, 1)), mode=mode))
    _close(nd.squeeze(a[:, :1]), jnd.squeeze(a[:, :1]))
    assert nd.rank(a) == 3 and nd.size(a) == 24 and nd.shape(a) == (2, 3, 4)
    assert nd.cast(a, np.int32).dtype == torch.int32


def test_elementwise_transforms():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((3, 7)).astype(np.float32)
    pos = np.abs(a) + 0.5
    for name in ("abs", "sign", "exp", "expm1", "sqrt", "rsqrt", "square",
                 "floor", "ceil", "round", "trunc", "sin", "cos", "tan",
                 "atan", "sinh", "cosh", "tanh", "asinh", "erf", "erfc",
                 "sigmoid", "softplus", "softmax", "log_softmax", "relu",
                 "relu6", "leaky_relu", "elu", "gelu", "silu",
                 "hard_sigmoid", "hard_tanh", "cbrt", "step", "neg",
                 "reciprocal"):
        x = pos if name in ("sqrt", "rsqrt", "reciprocal") else a
        _close(getattr(nd, name)(x), getattr(jnd, name)(x), atol=1e-5)
    for name in ("log", "log1p", "log2", "log10", "acosh"):
        _close(getattr(nd, name)(pos + 1), getattr(jnd, name)(pos + 1))
    for name in ("add", "sub", "mul", "div", "maximum", "minimum", "pow",
                 "atan2", "squared_difference", "rdiv", "rsub"):
        _close(getattr(nd, name)(pos, pos[::-1]),
               getattr(jnd, name)(pos, pos[::-1]), atol=1e-4)
    _close(nd.clip(a, -0.5, 0.5), jnd.clip(a, -0.5, 0.5))


def test_indexing():
    from deeplearning4j_tpu.ndarray import indexing as jix
    from deeplearning4j_tpu_torch.ndarray import indexing as ix
    a = np.arange(20).reshape(4, 5).astype(np.float32)
    _close(ix.get(a, ix.interval(1, 3), ix.all()),
           jix.get(a, jix.interval(1, 3), jix.all()))
    _close(ix.get(a, ix.point(2), ix.interval(0, 4, 2)),
           jix.get(a, jix.point(2), jix.interval(0, 4, 2)))
    _close(ix.get(a, ix.indices([0, 3]), ix.all()),
           jix.get(a, jix.indices([0, 3]), jix.all()))
    _close(ix.get(a, ix.all(), ix.new_axis(), ix.point(1)),
           jix.get(a, jix.all(), jix.new_axis(), jix.point(1)))
    t = torch.as_tensor(a)
    put = ix.put(t, ix.point(0), ix.all(), 9.0)
    _close(put, jix.put(a, jix.point(0), jix.all(), 9.0))
    assert float(t[0, 0]) == 0.0                # functional
    _close(ix.replace_where(a, 0.0, a > 10), jix.replace_where(a, 0.0, a > 10))
    for cond in (a > 10, a > 1000, a > -1):
        assert int(ix.first_index(cond)) == int(jix.first_index(cond))
        assert int(ix.last_index(cond)) == int(jix.last_index(cond))
        _close(ix.first_index(cond, axis=1), jix.first_index(cond, axis=1))
        _close(ix.last_index(cond, axis=0), jix.last_index(cond, axis=0))
    _close(ix.dynamic_slice(a, (1, 3), (2, 2)),
           jix.dynamic_slice(a, (1, 3), (2, 2)))
    _close(ix.dynamic_slice(a, (3, 4), (2, 2)),      # clamped
           jix.dynamic_slice(a, (3, 4), (2, 2)))
    upd = -np.ones((2, 2), np.float32)
    _close(ix.dynamic_update_slice(a, upd, (3, 1)),
           jix.dynamic_update_slice(a, upd, (3, 1)))
    _close(ix.tensor_along_dimension(a, 2, 1),
           jix.tensor_along_dimension(a, 2, 1))
    _close(ix.put_scalar(a, (1, 1), 5.0), jix.put_scalar(a, (1, 1), 5.0))


def test_random_explicit_keys():
    """Moments and supports (not JAX's bits) and determinism by seed."""
    from deeplearning4j_tpu_torch.ndarray import random as rnd
    k = rnd.key(42, device=CPU)
    u = rnd.uniform(k, (20000,))
    assert u.dtype == torch.float32 and u.shape == (20000,)
    assert 0.0 <= float(u.min()) and float(u.max()) <= 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01
    n = rnd.normal(rnd.key(42, device=CPU), (20000,), std=2.0)
    assert abs(float(n.std()) - 2.0) < 0.05 and abs(float(n.mean())) < 0.05
    t = rnd.truncated_normal(rnd.key(1, device=CPU), (5000,))
    assert float(t.abs().max()) <= 2.0
    g = rnd.gamma(rnd.key(2, device=CPU), 3.0, (20000,))
    assert abs(float(g.mean()) - 3.0) < 0.1 and float(g.min()) > 0
    g = rnd.gamma(rnd.key(2, device=CPU), 0.5, (20000,))
    assert abs(float(g.mean()) - 0.5) < 0.03
    bt = rnd.beta(rnd.key(3, device=CPU), 2.0, 5.0, (20000,))
    assert abs(float(bt.mean()) - 2 / 7) < 0.01
    e = rnd.exponential(rnd.key(4, device=CPU), (20000,), rate=2.0)
    assert abs(float(e.mean()) - 0.5) < 0.02
    p = rnd.poisson(rnd.key(5, device=CPU), 3.0, (20000,))
    assert p.dtype == torch.int32 and abs(float(p.float().mean()) - 3) < 0.1
    bn = rnd.binomial(rnd.key(6, device=CPU), 10, 0.3, (20000,))
    assert abs(float(bn.float().mean()) - 3.0) < 0.1
    ri = rnd.randint(rnd.key(7, device=CPU), (1000,), 2, 5)
    assert ri.dtype == torch.int32 and set(ri.tolist()) == {2, 3, 4}
    lap = rnd.laplace(rnd.key(8, device=CPU), (20000,))
    assert abs(float(lap.abs().mean()) - 1.0) < 0.05
    gum = rnd.gumbel(rnd.key(9, device=CPU), (20000,))
    assert abs(float(gum.mean()) - 0.5772) < 0.05
    ber = rnd.bernoulli(rnd.key(10, device=CPU), 0.25, (20000,))
    assert ber.dtype == torch.bool and abs(float(ber.float().mean()) - 0.25) < 0.02
    logits = torch.log(torch.tensor([0.1, 0.6, 0.3]))
    c = rnd.categorical(rnd.key(11, device=CPU), logits, shape=(20000,))
    freq = torch.bincount(c.long(), minlength=3).float() / 20000
    assert torch.allclose(freq, torch.tensor([0.1, 0.6, 0.3]), atol=0.02)
    perm = rnd.permutation(rnd.key(12, device=CPU), 10)
    assert sorted(perm.tolist()) == list(range(10))
    ch = rnd.choice(rnd.key(13, device=CPU), 5, (4,), replace=False)
    assert len(set(ch.tolist())) == 4
    # the same seed gives the same draws; split and fold_in are pure
    a = rnd.normal(rnd.key(3, device=CPU), (5,))
    b = rnd.normal(rnd.key(3, device=CPU), (5,))
    assert torch.equal(a, b)
    k = rnd.key(3, device=CPU)
    s1 = [rnd.uniform(x, (3,)) for x in rnd.split(k, 3)]
    s2 = [rnd.uniform(x, (3,)) for x in rnd.split(k, 3)]
    assert all(torch.equal(x, y) for x, y in zip(s1, s2))
    assert not torch.equal(s1[0], s1[1])
    assert torch.equal(rnd.uniform(rnd.fold_in(k, 7), (3,)),
                       rnd.uniform(rnd.fold_in(k, 7), (3,)))
    assert not torch.equal(rnd.uniform(rnd.fold_in(k, 7), (3,)),
                           rnd.uniform(rnd.fold_in(k, 8), (3,)))
    # stateful facade reproducibility
    rnd.set_seed(7)
    a = rnd.randn(5, device=CPU)
    rnd.set_seed(7)
    b = rnd.randn(5, device=CPU)
    assert torch.equal(a, b)
    sh = rnd.shuffle(torch.arange(6))
    assert sorted(sh.tolist()) == list(range(6))


def test_linalg():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((4, 4)).astype(np.float32)
    spd = a @ a.T + 4 * np.eye(4, dtype=np.float32)
    c = nd.linalg.cholesky(spd)
    _close(c, jnd.linalg.cholesky(spd), atol=1e-4)
    one = np.ones(4, np.float32)
    _close(nd.linalg.solve(spd, one), jnd.linalg.solve(spd, one), atol=1e-4)
    _close(nd.linalg.inv(spd), jnd.linalg.inv(spd), atol=1e-4)
    _close(nd.linalg.det(spd), jnd.linalg.det(spd), atol=1e-2, rtol=1e-4)
    _close(nd.linalg.norm(a), jnd.linalg.norm(a), atol=1e-4)
    w = nd.linalg.eigh(spd)[0]
    _close(w, jnd.linalg.eigh(spd)[0], atol=1e-4)
    _close(nd.linalg.triangular_solve(np.asarray(c), one, lower=True),
           jnd.linalg.triangular_solve(np.asarray(c), one, lower=True),
           atol=1e-4)
    s = nd.linalg.svd(a)[1]
    _close(s, jnd.linalg.svd(a)[1], atol=1e-4)


def test_sort_topk_unique_gather_scatter():
    a = np.array([3.0, 1.0, 2.0, 3.0], np.float32)
    _close(nd.sort(a), jnd.sort(a))
    _close(nd.sort(a, descending=True), jnd.sort(a, descending=True))
    _close(nd.argsort(a), jnd.argsort(a))
    v, i = nd.top_k(a, 2)
    jv, ji = jnd.top_k(a, 2)
    _close(v, jv)
    _close(i, ji)
    _close(nd.unique(a), jnd.unique(a))
    for size, fill in ((5, None), (2, None), (5, -1.0)):
        _close(nd.unique(a, size=size, fill_value=fill),
               jnd.unique(a, size=size, fill_value=fill))
    _close(nd.searchsorted(np.sort(a), a, side="right"),
           jnd.searchsorted(np.sort(a), a, side="right"))
    m = np.arange(12, dtype=np.float32).reshape(4, 3)
    idx = np.array([0, 2, 2])
    _close(nd.take(m, idx, axis=0), jnd.take(m, idx, axis=0))
    _close(nd.gather(m, idx, axis=1), jnd.gather(m, idx, axis=1))
    _close(nd.take_along_axis(m, np.array([[0], [1], [2], [0]]), 1),
           jnd.take_along_axis(m, np.array([[0], [1], [2], [0]]), 1))
    upd = np.ones((3, 3), np.float32) * 5
    jm = jnd.create(m)
    _close(nd.scatter_update(m, idx, upd), jnd.scatter_update(jm, idx, upd))
    _close(nd.scatter_add(m, idx, upd), jnd.scatter_add(jm, idx, upd))
    _close(nd.scatter_max(m, idx, upd), jnd.scatter_max(jm, idx, upd))
    seg = np.array([0, 1, 0, 5])
    _close(nd.segment_sum(m, seg, 3), jnd.segment_sum(m, seg, 3))
    cond = m > 5
    for got, want in zip(nd.where(cond), jnd.where(cond)):
        _close(got, want)
    _close(nd.where(cond, m, 0.0), jnd.where(cond, m, 0.0))
    oh = nd.one_hot(np.array([0, 2]), 3)
    _close(oh, [[1, 0, 0], [0, 0, 1]])


def test_im2col_col2im_roundtrip():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 6, 3)).astype(np.float32)
    cols = nd.im2col(x, (2, 2), stride=(2, 2))
    assert cols.shape == (2, 3, 3, 12)
    _close(cols, jnd.im2col(x, (2, 2), stride=(2, 2)))
    _close(nd.im2col(x, (3, 3), padding="SAME"),
           jnd.im2col(x, (3, 3), padding="SAME"))
    back = nd.col2im(cols, x.shape, (2, 2), stride=(2, 2))
    _close(back, x)
    c3 = np.asarray(jnd.im2col(x, (3, 3)))
    _close(nd.col2im(c3, x.shape, (3, 3)), jnd.col2im(c3, x.shape, (3, 3)),
           atol=1e-4)


def test_conv_pool_primitives():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 8, 8, 2)).astype(np.float32)
    w = rng.standard_normal((3, 3, 2, 4)).astype(np.float32)
    for pad in ("SAME", "VALID"):
        for stride in ((1, 1), (2, 2)):
            _close(nd.conv2d(x, w, stride=stride, padding=pad),
                   jnd.conv2d(x, w, stride=stride, padding=pad), atol=1e-4)
    _close(nd.conv2d(x, w, dilation=(2, 2)),
           jnd.conv2d(x, w, dilation=(2, 2)), atol=1e-4)
    for pad in ("VALID", "SAME"):
        _close(nd.max_pool2d(x, (3, 3), (2, 2), pad),
               jnd.max_pool2d(x, (3, 3), (2, 2), pad))
        for cip in (True, False):
            _close(nd.avg_pool2d(x, (3, 3), (2, 2), pad, cip),
                   jnd.avg_pool2d(x, (3, 3), (2, 2), pad, cip))
    assert nd.max_pool2d(x, (2, 2)).shape == (1, 4, 4, 2)


def test_host_helpers_and_workspace():
    from deeplearning4j_tpu_torch.ndarray import workspace as ws
    t = torch.arange(4, dtype=torch.bfloat16)
    assert nd.to_numpy(t).dtype == np.float32
    assert nd.device_put(np.ones(2), device=CPU).device.type == "cpu"
    cfg = ws.WorkspaceConfig(name="W", donate_argnums=(0,))
    with ws.workspace(cfg) as c:
        assert ws.current() is c
    assert ws.current() is None
    if not torch.cuda.is_available():
        assert ws.live_buffer_bytes() == 0
        assert ws.device_memory_stats() == {}

    def step(acc, x, scale):
        acc.add_(x * scale)
        return acc.sum()
    fn = ws.jit_in_workspace(step, donate_argnums=(0,), static_argnums=(2,))
    acc = torch.zeros(3)
    out = fn(acc, torch.ones(3), 2.0)
    assert float(out) == 6.0 and torch.equal(acc, torch.full((3,), 2.0))
    assert fn.compiled.last == "direct"
