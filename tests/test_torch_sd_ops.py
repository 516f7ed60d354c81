"""The port's SameDiff op registry against the JAX package's, op by op.

Every (namespace, op) of the reference — the 739 of ``sd_ops.NAMESPACES``
and the core ``_MATH``/``_NN``/``_LOSS`` tables of ``samediff.py`` — has
at least one case here, and ``test_every_op_has_a_parity_case`` holds
that. A case calls the reference's op and the port's on the same seeded
numpy inputs (jnp arrays on one side, tensors on the other) and compares
each output's dtype and values, f32 atol = rtol = 1e-5 unless the case
states another bar. Random ops (a JAX key on one side, a
``torch.Generator`` on the other) are held by shape, dtype, support and
moments; ``bp`` ops against the reference's ``bp`` ops; ``assert`` ops by
passing and raising alike. The cases live in ``torch_sd_cases.py``
(numpy only: the card-only tests run them too). The reference's own case
tables (``test_sd_ops.py``, ``test_sd_ops_r3.py``) are run through both
SameDiffs as well.
"""

import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff import samediff as JS
from deeplearning4j_tpu.autodiff import sd_ops as J
from deeplearning4j_tpu_torch.autodiff import samediff as PS
from deeplearning4j_tpu_torch.autodiff import sd_ops as P

from torch_sd_cases import (ASSERT_CASES, BP_CASES, CASES,  # noqa: E402
                            RANDOM_CASES, R, _Key)


def _jax(a):
    if isinstance(a, _Key):
        return jax.random.PRNGKey(a.seed)
    if isinstance(a, (np.ndarray, np.generic)):
        return jnp.asarray(a)
    if isinstance(a, tuple) and any(isinstance(v, (np.ndarray, np.generic))
                                    for v in a):
        return tuple(_jax(v) for v in a)
    if isinstance(a, list) and any(isinstance(v, np.ndarray) for v in a):
        return [_jax(v) for v in a]
    return a


def _port(a):
    if isinstance(a, _Key):
        return torch.Generator().manual_seed(a.seed)
    if isinstance(a, (np.ndarray, np.generic)):
        return P._t(a)
    if isinstance(a, tuple) and any(isinstance(v, (np.ndarray, np.generic))
                                    for v in a):
        return tuple(_port(v) for v in a)
    if isinstance(a, list) and any(isinstance(v, np.ndarray) for v in a):
        return [_port(v) for v in a]
    if isinstance(a, type) and hasattr(a, "dtype"):     # jnp scalar types
        return np.dtype(a)
    return a


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [x]


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def compare(want, got, atol=1e-5, rtol=1e-5, dtype=True):
    """Each output leaf: same dtype (the reference's 32-bit types), same
    shape, values within the bar."""
    wl, gl = _leaves(want), _leaves(got)
    assert len(wl) == len(gl), (len(wl), len(gl))
    for w, g in zip(wl, gl):
        if w is None:
            assert g is None
            continue
        w, g = np.asarray(w), _np(g)
        if w.dtype.name == "bfloat16":
            w = w.astype(np.float32)
        if dtype:
            assert g.dtype == w.dtype, (g.dtype, w.dtype)
        assert g.shape == w.shape, (g.shape, w.shape)
        if w.dtype.kind in "biuSO":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=atol, rtol=rtol,
                                       equal_nan=True)


def table(mod_ops, mod_sd, ns):
    core = {"math": mod_sd._MATH, "nn": mod_sd._NN, "loss": mod_sd._LOSS}
    return {**core.get(ns, {}), **mod_ops.NAMESPACES[ns]}


def run_both(ns, op, args, kw):
    want = table(J, JS, ns)[op](*[_jax(a) for a in args],
                                **{k: _jax(v) for k, v in kw.items()})
    got = table(P, PS, ns)[op](*[_port(a) for a in args],
                               **{k: _port(v) for k, v in kw.items()})
    return want, got


@pytest.mark.parametrize("ns,op,args,kw,opts", CASES,
                         ids=[f"{c[0]}.{c[1]}_{i}" for i, c in
                              enumerate(CASES)])
def test_op_parity(ns, op, args, kw, opts):
    want, got = run_both(ns, op, args, kw)
    compare(want, got, opts["atol"], opts["rtol"], opts["dtype"])


def _moment_ok(w, g):
    w = np.asarray(w, np.float64).ravel()
    g = np.asarray(g, np.float64).ravel()
    if w.size < 1000:
        return
    if np.isinf(w).any() or np.std(w) > 50:        # heavy tails: medians
        assert abs(np.median(w) - np.median(g)) < 0.1 * (
            1 + abs(np.median(w))), (np.median(w), np.median(g))
        return
    se = math.sqrt(np.var(w) / w.size + np.var(g) / g.size) + 1e-6
    assert abs(w.mean() - g.mean()) < 6 * se + 1e-3, (w.mean(), g.mean())
    if np.std(w) > 1e-6:
        assert abs(np.std(g) / np.std(w) - 1) < 0.1, (np.std(w), np.std(g))


@pytest.mark.parametrize("ns,op,args,kw,support", RANDOM_CASES,
                         ids=[f"{c[0]}.{c[1]}_{i}" for i, c in
                              enumerate(RANDOM_CASES)])
def test_random_op_moments(ns, op, args, kw, support):
    want, got = run_both(ns, op, args, kw)
    for w, g in zip(_leaves(want), _leaves(got)):
        w, g = np.asarray(w), _np(g)
        assert g.shape == w.shape and g.dtype == w.dtype, (
            g.shape, w.shape, g.dtype, w.dtype)
        if support is not None:
            lo, hi = support
            if lo is not None:
                assert g.min() >= lo and w.min() >= lo
            if hi is not None:
                assert g.max() <= hi and w.max() <= hi
        if op not in ("sample_distorted_bounding_box", "random_crop"):
            _moment_ok(w, g)
    # the same generator seed draws the same values again
    again = table(P, PS, ns)[op](*[_port(a) for a in args], **kw)
    for g1, g2 in zip(_leaves(got), _leaves(again)):
        np.testing.assert_array_equal(_np(g1), _np(g2))


@pytest.mark.parametrize("n_heads,causal", [(2, False), (1, True),
                                            (4, True)])
def test_samediff_mhdpa_parity(n_heads, causal):
    """samediff.py's ``_mhdpa`` (``jax.nn.dot_product_attention`` over
    heads split from D); ``sd.nn`` reaches the long-tail version, so it
    is held directly."""
    q, k, v = (R.standard_normal((2, 6, 8)).astype(np.float32)
               for _ in range(3))
    want = JS._mhdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     n_heads=n_heads, causal=causal)
    got = PS._mhdpa(P._t(q), P._t(k), P._t(v), n_heads=n_heads,
                    causal=causal)
    compare(want, got)


def test_permutation_and_shuffle_are_permutations():
    g = torch.Generator().manual_seed(3)
    p = P.RANDOM["permutation"](g, 50).numpy()
    assert sorted(p.tolist()) == list(range(50))
    s = P.RANDOM["shuffle"](g, torch.arange(10.0)).numpy()
    assert sorted(s.tolist()) == list(range(10))
    ch = P.RANDOM["choice"](g, torch.arange(30.0), (30,), False).numpy()
    assert sorted(ch.tolist()) == list(range(30))


@pytest.mark.parametrize("op,args,kw", BP_CASES,
                         ids=[f"bp.{c[0]}_{i}" for i, c in
                              enumerate(BP_CASES)])
def test_bp_op_parity(op, args, kw):
    want, got = run_both("bp", op, args, kw)
    compare(want, got, 1e-4, 1e-4)


@pytest.mark.parametrize("op,ok,bad", ASSERT_CASES,
                         ids=[c[0] for c in ASSERT_CASES])
def test_assert_op_parity(op, ok, bad):
    want, got = run_both("assert", op, ok, {})
    compare(want, got)
    for mod, conv in ((J, _jax), (P, _port)):
        with pytest.raises(AssertionError):
            mod.ASSERT[op](*[conv(a) for a in bad])


def test_check_numerics_raises_like_the_reference():
    for mod, conv in ((J, _jax), (P, _port)):
        with pytest.raises(FloatingPointError):
            mod.BASE["check_numerics"](conv(np.array([1.0, np.nan],
                                                     np.float32)))


# ----------------------------------------------------- the gates

def _all_keys(mod_ops, mod_sd):
    keys = {(ns, op) for ns, t in mod_ops.NAMESPACES.items() for op in t}
    for ns, t in (("math", mod_sd._MATH), ("nn", mod_sd._NN),
                  ("loss", mod_sd._LOSS)):
        keys |= {(ns, op) for op in t}
    return keys


def test_key_set_equals_the_reference():
    assert P.op_count() == J.op_count() == 739
    assert {(ns, op) for ns, t in P.NAMESPACES.items() for op in t} == \
        {(ns, op) for ns, t in J.NAMESPACES.items() for op in t}
    assert _all_keys(P, PS) == _all_keys(J, JS)


def test_every_op_has_a_parity_case():
    covered = {(c[0], c[1]) for c in CASES}
    covered |= {(c[0], c[1]) for c in RANDOM_CASES}
    covered |= {("bp", c[0]) for c in BP_CASES}
    covered |= {("assert", c[0]) for c in ASSERT_CASES}
    assert _all_keys(J, JS) - covered == set()


def test_host_ops_are_known_ops():
    keys = _all_keys(P, PS)
    assert P.HOST_OPS <= keys


# ------------------------------------ the reference's case tables, mirrored

def _load(name):
    path = Path(__file__).resolve().parent / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_mirror_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MIRRORED = []
for _name, _bar in (("test_sd_ops", 2e-5), ("test_sd_ops_r3", 3e-5)):
    for _i, _c in enumerate(_load(_name).CASES):
        MIRRORED.append(pytest.param(_c[0], _c[1], _c[2], _c[3], _bar,
                                     id=f"{_name}.{_c[0]}.{_c[1]}_{_i}"))


@pytest.mark.parametrize("ns,op,args,kw,bar", MIRRORED)
def test_reference_case_through_both_samediffs(ns, op, args, kw, bar):
    """The reference's case, driven through each SameDiff's namespace
    dispatch as its test drives it, the port held to the reference."""
    sdj = JS.SameDiff.create()
    want = np.asarray(getattr(getattr(sdj, ns), op)(*args, **kw).eval())
    sdp = PS.SameDiff.create(device="cpu")
    got = getattr(getattr(sdp, ns), op)(*[_port(a) for a in args],
                                        **kw).eval()
    compare(want, got, atol=bar, rtol=bar)


# ------------------------- graph-level tests of the reference, mirrored

def _graph_ops(mod, sd):
    """test_sd_ops_r4b's namespaces-on-a-graph and test_sd_ops_r5's list
    namespace, built the same way in either package."""
    x = sd.placeholder("x")
    rec = sd.signal.istft(sd.signal.stft(x, 64, 32), 64, 32)
    g = sd.placeholder("g")
    upd = sd.updaters.sgd_updater(g, 0.5)
    y = sd.placeholder("y")
    relu_bp = sd.bp.relu_bp(y, y)
    c = sd.constant("c", np.asarray([1.0, 2.0], np.float32))
    ta = sd.list.create_list(3, (2,))
    ta = sd.list.push_list(ta, c)
    ta = sd.list.push_list(ta, c * 2.0)
    return [rec, upd, relu_bp, sd.list.size_list(ta), sd.list.stack_list(ta),
            sd.fft.rfft(x)]


def test_graph_level_namespaces_equal_the_reference():
    wave = np.random.default_rng(0).standard_normal(256).astype(np.float32)
    feeds = {"x": wave, "g": np.asarray([2.0], np.float32),
             "y": np.asarray([-1.0, 2.0], np.float32)}
    sdj = JS.SameDiff.create()
    sdp = PS.SameDiff.create(device="cpu")
    oj, op = _graph_ops(J, sdj), _graph_ops(P, sdp)
    for a, b in zip(oj, op):
        want = sdj.eval(a, {k: v for k, v in feeds.items()})
        got = sdp.eval(b, feeds)
        compare(want, got, atol=1e-4, rtol=1e-4)
    rec = _np(sdp.eval(op[0], feeds))
    np.testing.assert_allclose(rec[64:192], wave[64:192], atol=1e-4)
    np.testing.assert_array_equal(_np(sdp.eval(op[4], feeds)),
                                  [[1, 2], [2, 4], [0, 0]])
    # an assert node (which the reference's jitted eval cannot stage
    # without checkify) makes the port's graph one that runs eagerly
    chk = sdp.assertions.assert_finite(sdp.get_variable("x"))
    assert sdp.needs_host(chk) and not sdp.needs_host(op[5])
    np.testing.assert_array_equal(_np(sdp.eval(chk, feeds)), wave)
    with pytest.raises(AssertionError):
        sdp.eval(chk, {**feeds, "x": np.asarray([np.inf], np.float32)})


def test_stft_istft_roundtrip():
    x = np.random.default_rng(1).standard_normal(1024).astype(np.float32)
    spec = P.SIGNAL["stft"](P._t(x), 256, 128)
    assert tuple(spec.shape) == (7, 129) and spec.dtype == torch.complex64
    rec = P.SIGNAL["istft"](spec, 256, 128)
    np.testing.assert_allclose(_np(rec)[256:768], x[256:768], atol=1e-5)


def test_bp_activation_list_is_the_reference_s():
    from torch_sd_cases import ACTIVATIONS
    assert set(ACTIVATIONS) == set(J._ACT_FWD) == set(P._ACT_FWD)


# --------- multi-step flows of test_sd_ops_r4b.py and r5.py, in both packages
# Each flow takes a namespace table and the package's array maker, so the
# same steps run on the reference and on the port.

def _flow_adam_two_steps(S, a):
    g, m, v = a([0.1, -0.2, 0.3]), a([0.0, 0.0, 0.0]), a([0.0, 0.0, 0.0])
    out = []
    for t in (1, 2):
        u, m, v = S["updater"]["adam_updater"](g, m, v, t, 0.001, 0.9,
                                               0.999, 1e-8)
        out.append(u)
    return out + [m, v]


def _flow_list_write_read(S, a):
    L = S["list"]
    ta = L["create_list"](4, (3,))
    ta = L["write_list"](ta, 0, a([1.0, 2.0, 3.0]))
    ta = L["write_list"](ta, 2, a([7.0, 8.0, 9.0]))
    return [L["size_list"](ta), L["read_list"](ta, 2), L["stack_list"](ta)]


def _flow_list_push_gather_scatter(S, a):
    L = S["list"]
    ta = L["create_list"](5, (2,))
    ta = L["push_list"](ta, a([1.0, 1.0]))
    ta = L["push_list"](ta, a([2.0, 2.0]))
    got = L["gather_list"](ta, a(np.asarray([1, 0], np.int32)))
    ta = L["scatter_list"](ta, a(np.asarray([4], np.int32)), a([[9.0, 9.0]]))
    ta2 = L["unstack_list"](L["create_list"](3, (2,)),
                            a(np.full((3, 2), 5.0, np.float32)))
    return [got, L["size_list"](ta), L["read_list"](ta, 4),
            L["size_list"](ta2), L["read_list"](ta2, 1)]


def _flow_list_split(S, a):
    L = S["list"]
    ta = L["split_list"](L["create_list"](2, (3, 2)),
                         a(np.arange(10, dtype=np.float32).reshape(5, 2)),
                         [3, 2])
    return [L["size_list"](ta), L["read_list"](ta, 0), L["read_list"](ta, 1)]


def _flow_list_overflow(S, a):
    L = S["list"]
    ta = L["create_list"](2, (2,))
    for v in ([1.0, 1.0], [2.0, 2.0], [3.0, 3.0]):
        ta = L["push_list"](ta, a(v))
    ta = L["write_list"](ta, 5, a([9.0, 9.0]))
    empty = L["scatter_list"](ta, a(np.zeros((0,), np.int32)),
                              a(np.zeros((0, 2), np.float32)))
    return [ta[0], L["size_list"](ta), empty[0], L["size_list"](empty)]


def _flow_sru_cells(S, a):
    rng = np.random.default_rng(3)
    x = a(rng.standard_normal((2, 5, 4)).astype(np.float32))
    w = a(rng.standard_normal((4, 12)).astype(np.float32))
    bias = a(rng.standard_normal(8).astype(np.float32))
    c = a(np.zeros((2, 4), np.float32))
    hs = []
    for i in range(5):
        h, c = S["rnn"]["sru_cell"](x[:, i], c, w, bias)
        hs.append(h)
    return hs


FLOWS = {"adam_two_steps": _flow_adam_two_steps,
         "list_write_read": _flow_list_write_read,
         "list_push_gather_scatter": _flow_list_push_gather_scatter,
         "list_split": _flow_list_split,
         "list_overflow": _flow_list_overflow,
         "sru_cells": _flow_sru_cells}


@pytest.mark.parametrize("name", sorted(FLOWS))
def test_reference_flow_parity(name):
    def ja(v):
        return jnp.asarray(np.asarray(v, np.float32) if isinstance(
            v, list) else v)

    def pa(v):
        return P._t(np.asarray(v, np.float32) if isinstance(v, list)
                    else v)
    want = FLOWS[name](J.NAMESPACES, ja)
    got = FLOWS[name](P.NAMESPACES, pa)
    compare(want, got)


def test_unknown_conditions_and_methods_raise_like_the_reference():
    x = np.asarray([1.0, -2.0], np.float32)
    for mod, conv in ((J, _jax), (P, _port)):
        with pytest.raises(ValueError, match="unknown condition"):
            mod.BASE["replace_where"](conv(x), 0.0, "wat")
        with pytest.raises(ValueError, match="unknown resize method"):
            mod.IMAGE["image_resize"](conv(np.ones((1, 4, 4, 3),
                                                   np.float32)), 8, 8,
                                      method="wat")
        with pytest.raises(ValueError, match="unknown condition"):
            mod.MATH_EXT["match_condition"](conv(x), "wat", 0.0)
