"""The port's kernel modules against the JAX package's kernels.

On the CPU each wrapper runs its kernel's plain version (the CUDA kernels
themselves run only on the card: ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold them against these same plain
versions). Here the plain versions are held against the JAX package's
Pallas kernels in interpret mode and its own references, in f32 at
atol 1e-5 (summation order), and the wrappers' refusal paths are pinned:
no card → raise, never a silent CPU fallback for a CUDA request.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels.paged_attention import (
    paged_attention as jpaged, paged_attention_reference as jpaged_ref)
from deeplearning4j_tpu_torch.kernels import _build
from deeplearning4j_tpu_torch.kernels import flash_attention as tfa
from deeplearning4j_tpu_torch.kernels import paged_attention as tpa

# the JAX package re-exports the flash_attention FUNCTION under the
# module's name; import_module reaches the module itself
jfa = importlib.import_module("deeplearning4j_tpu.kernels.flash_attention")

torch.set_num_threads(2)

KERNEL_ATOL = 1e-5


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _pool(rng, npg, plen, h, dh, dtype=np.float32):
    k = rng.standard_normal((npg, plen, h, dh)).astype(dtype)
    v = rng.standard_normal((npg, plen, h, dh)).astype(dtype)
    return k, v


# ------------------------------------------------------ paged decode (K2)

def test_paged_plain_matches_jax_kernel_at_every_position():
    """Every decode position of a slot — mapped, partial-fill and
    sentinel-after-cursor tables, non-contiguous page ids — with the
    next page mapped as headroom (the verify notes: a slot decoded past
    its mapped pages differs between kernel and gather by contract)."""
    rng = np.random.default_rng(0)
    h, dh, npg, plen, per_slot = 2, 16, 12, 4, 4
    n = per_slot * plen                  # one slot per position, one call
    q = rng.standard_normal((n, h, dh)).astype(np.float32)
    k, v = _pool(rng, npg, plen, h, dh)
    ids = rng.permutation(npg)[:per_slot]
    table = np.full((n, per_slot), npg, np.int32)
    for pos in range(n):
        mapped = min(per_slot, -(-(pos + 1) // plen) + 1)
        table[pos, :mapped] = ids[:mapped]
    p = np.arange(n, dtype=np.int32)
    ref = jpaged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 jnp.asarray(table), jnp.asarray(p), interpret=True)
    got = tpa.paged_attention(_t(q), _t(k), _t(v), _t(table), _t(p))
    for pos in range(n):
        np.testing.assert_allclose(got.numpy()[pos], np.asarray(ref)[pos],
                                   atol=KERNEL_ATOL, err_msg=f"pos={pos}")


def test_paged_plain_matches_jax_mixed_and_cow_slots():
    """A batch mixing a full slot, partial fills, a single-page slot and
    two slots SHARING their first pages (a copy-on-write prefix)."""
    rng = np.random.default_rng(1)
    b, h, dh, npg, plen, per_slot = 5, 2, 8, 24, 4, 5
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    k, v = _pool(rng, npg, plen, h, dh)
    table = np.full((b, per_slot), npg, np.int32)
    table[0, :5] = [3, 7, 1, 9, 11]          # full
    table[1, :3] = [0, 2, 4]                 # partial
    table[2, :1] = [5]                       # single page
    table[3, :4] = [3, 7, 13, 14]            # shares pages 3, 7 with slot 0
    table[4, :2] = [3, 15]                   # shares page 3
    pos = np.asarray([19, 9, 2, 14, 6], np.int32)
    args = [jnp.asarray(a) for a in (q, k, v, table, pos)]
    ref = jpaged(*args, interpret=True)
    got = tpa.paged_attention(*(_t(a) for a in (q, k, v, table, pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=KERNEL_ATOL)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_paged_plain_matches_jax_kernel_at_head_dim_320(dtype):
    """Head dim 320 (d_model 640, 2 heads), which the CUDA kernel took
    only up to 256 before: the plain version against the JAX package's
    paged kernel in interpret mode, at every position of a slot, in f32
    and with bf16 q and pools."""
    rng = np.random.default_rng(7)
    h, dh, npg, plen, per_slot = 2, 320, 9, 4, 3
    n = per_slot * plen
    q = rng.standard_normal((n, h, dh)).astype(np.float32)
    k, v = _pool(rng, npg, plen, h, dh)
    ids = rng.permutation(npg)[:per_slot]
    table = np.full((n, per_slot), npg, np.int32)
    for pos in range(n):
        mapped = min(per_slot, -(-(pos + 1) // plen) + 1)
        table[pos, :mapped] = ids[:mapped]
    p = np.arange(n, dtype=np.int32)
    if dtype == "bfloat16":
        jargs = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
        targs = [_t(a).to(torch.bfloat16) for a in (q, k, v)]
        atol = 1e-2
    else:
        jargs = [jnp.asarray(a) for a in (q, k, v)]
        targs = [_t(a) for a in (q, k, v)]
        atol = KERNEL_ATOL
    ref = jpaged(*jargs, jnp.asarray(table), jnp.asarray(p), interpret=True)
    got = tpa.paged_attention(*targs, _t(table), _t(p))
    assert got.shape == (n, h, dh) and got.dtype == targs[0].dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=atol, rtol=atol if atol > 1e-4 else 0)


def test_paged_plain_clamps_sentinel_like_jax_gather():
    """A sentinel entry BELOW the cursor: the plain version gathers the
    clamped last pool page exactly as the JAX gather reference does."""
    rng = np.random.default_rng(2)
    h, dh, npg, plen, per_slot = 2, 8, 6, 4, 3
    q = rng.standard_normal((2, h, dh)).astype(np.float32)
    k, v = _pool(rng, npg, plen, h, dh)
    table = np.asarray([[1, npg, 2], [npg, npg, npg]], np.int32)
    pos = np.asarray([9, 0], np.int32)
    ref = jpaged_ref(*(jnp.asarray(a) for a in (q, k, v, table, pos)))
    got = tpa.paged_attention_reference(
        *(_t(a) for a in (q, k, v, table, pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=KERNEL_ATOL)


def test_paged_plain_bf16_pool_matches_jax():
    rng = np.random.default_rng(3)
    h, dh, npg, plen, per_slot = 2, 16, 10, 8, 3
    q = rng.standard_normal((3, h, dh)).astype(np.float32)
    k, v = _pool(rng, npg, plen, h, dh)
    table = np.asarray([[4, 1, 0], [2, npg, npg], [5, 6, npg]], np.int32)
    pos = np.asarray([20, 3, 12], np.int32)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    ref = jpaged(*jb, jnp.asarray(table), jnp.asarray(pos), interpret=True)
    tb = [_t(a).to(torch.bfloat16) for a in (q, k, v)]
    got = tpa.paged_attention(*tb, _t(table), _t(pos))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)


def test_paged_decide_modes(monkeypatch, tmp_path):
    from types import SimpleNamespace

    from deeplearning4j_tpu_torch.kernels import autotune as tat

    class Eng:
        paged_kernel_mode = None
        cfg = SimpleNamespace(n_layers=1, n_heads=2, head_dim=8)

    cpu_cache = {"k": torch.zeros((1, 2, 4, 2, 8)),
                 "pages": torch.zeros((1, 2), dtype=torch.int32)}
    meta_cuda = {"k": torch.empty((1, 2, 4, 2, 8), device="meta")}
    assert tpa.decide(Eng(), cpu_cache, "off") == "gather"
    assert tpa.decide(Eng(), cpu_cache, "on") == "kernel"
    assert tpa.decide(Eng(), cpu_cache, "auto") == "gather"
    assert tpa.decide(Eng(), meta_cuda, "auto") == "gather"
    Eng.paged_kernel_mode = "on"                # the engine's pinned mode
    assert tpa.decide(Eng(), cpu_cache) == "kernel"
    # race: the cost record while its sha matches, else one race (the
    # race itself: tests/test_torch_autotune.py)
    monkeypatch.setattr(tat, "_CACHE_PATH", tmp_path / "autotune.json")
    tat._memory_cache.clear()
    races = []

    def race(engine, cache):
        races.append(tpa.bucket_key(engine.cfg, cache))
        tat.put(races[-1], ("gather",), sha=tpa.kernel_sha())
        return {"choice": "gather"}

    monkeypatch.setattr(tpa, "race", race)
    assert tpa.decide(Eng(), cpu_cache, "race") == "gather"
    assert tpa.decide(Eng(), cpu_cache, "race") == "gather"
    assert races == ["paged_decode:L1H2D8:PL4:P2:NP2:S1:float32:cpu"]
    Eng.paged_kernel_mode = None                # the env var's mode
    monkeypatch.setenv("DL4J_PAGED_KERNEL", "off")
    assert tpa.decide(Eng(), cpu_cache) == "gather"
    with pytest.raises(ValueError):
        tpa.decide(Eng(), cpu_cache, "bogus")
    tat._memory_cache.clear()


# ----------------------------------------------------- flash forward (K1)

@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_jax_flash_interpret(causal):
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 2, 32, 16)).astype(np.float32)
               for _ in range(3))
    ref = jfa.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                              causal=causal, block_q=8, block_k=8,
                              interpret=True)
    got = tfa.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=KERNEL_ATOL)
    mha = jfa.mha_reference(*(jnp.asarray(a) for a in (q, k, v)),
                            causal=causal)
    np.testing.assert_allclose(
        tfa.mha_reference(_t(q), _t(k), _t(v), causal=causal).numpy(),
        np.asarray(mha), atol=KERNEL_ATOL)


def test_flash_lse_matches_jax_flash_lse_interpret():
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((1, 2, 24, 16)).astype(np.float32)
               for _ in range(3))
    ref_o, ref_lse = jfa.flash_attention_lse(
        *(jnp.asarray(a) for a in (q, k, v)), causal=True, block_q=8,
        block_k=8, interpret=True)
    o, lse = tfa.flash_attention_lse(_t(q), _t(k), _t(v), causal=True)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (1, 2, 24)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o),
                               atol=KERNEL_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse),
                               atol=KERNEL_ATOL)
    o2, lse2 = tfa.mha_reference_lse(_t(q), _t(k), _t(v), causal=True)
    torch.testing.assert_close(o2, o, rtol=0, atol=0)
    torch.testing.assert_close(lse2, lse, rtol=0, atol=0)


def test_flash_ntc_matches_jax_ntc_interpret():
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((2, 16, 2, 16)).astype(np.float32)
               for _ in range(3))
    ref = jfa.flash_attention_ntc(*(jnp.asarray(a) for a in (q, k, v)),
                                  causal=True, interpret=True)
    got = tfa.flash_attention_ntc(_t(q), _t(k), _t(v), causal=True)
    assert tuple(got.shape) == (2, 16, 2, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=KERNEL_ATOL)


# ------------------------------------------- flash backward (dQ, dK/dV)

def _jax_vjp(fn, arrays, cotangent, **kw):
    _, vjp = jax.vjp(lambda *xs: fn(*xs, **kw),
                     *(jnp.asarray(a) for a in arrays))
    return [np.asarray(g) for g in vjp(cotangent)]


def _torch_grads(fn, arrays, cotangents, **kw):
    xs = [_t(a).requires_grad_(True) for a in arrays]
    outs = fn(*xs, **kw)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, [_t(c) for c in cotangents])
    return [x.grad.numpy() for x in xs]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_matches_jax_pallas_vjp(causal):
    """The Function's grads and flash_attention_bwd_reference itself
    against jax.vjp through the JAX package's Pallas backward kernels
    (interpret mode, 8-row blocks, so several tiles per pass)."""
    rng = np.random.default_rng(8)
    q, k, v, g = (rng.standard_normal((2, 2, 32, 16)).astype(np.float32)
                  for _ in range(4))
    ref = _jax_vjp(jfa.flash_attention, (q, k, v), jnp.asarray(g),
                   causal=causal, block_q=8, block_k=8, interpret=True)
    got = _torch_grads(tfa.flash_attention, (q, k, v), (g,), causal=causal)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=KERNEL_ATOL)
    o, lse = tfa.mha_reference_lse(_t(q), _t(k), _t(v), causal=causal)
    delta = (_t(g) * o).sum(-1)
    plain = tfa.flash_attention_bwd_reference(
        _t(q), _t(k), _t(v), _t(g), lse, delta, 0.25, causal)
    for a, b in zip(plain, ref):
        np.testing.assert_allclose(a.numpy(), b, atol=KERNEL_ATOL)


def test_flash_lse_bwd_folds_dlse_like_jax():
    """A nonzero lse cotangent: delta − dLSE, as the JAX package's
    ``_flash_bwd_lse`` folds it."""
    rng = np.random.default_rng(9)
    q, k, v, g = (rng.standard_normal((1, 2, 24, 16)).astype(np.float32)
                  for _ in range(4))
    gl = rng.standard_normal((1, 2, 24)).astype(np.float32)
    ref = _jax_vjp(jfa.flash_attention_lse, (q, k, v),
                   (jnp.asarray(g), jnp.asarray(gl)), causal=True,
                   block_q=8, block_k=8, interpret=True)
    got = _torch_grads(tfa.flash_attention_lse, (q, k, v), (g, gl),
                       causal=True)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=KERNEL_ATOL)
    only_o = _torch_grads(lambda *x, **kw: tfa.flash_attention_lse(
        *x, **kw)[0], (q, k, v), (g,), causal=True)
    assert np.abs(only_o[0] - got[0]).max() > 1e-3   # dLSE did matter


def test_flash_ntc_bwd_matches_jax_ntc_vjp():
    """The (B, T, H, D) layout through strided views of one qkv buffer,
    against jax.vjp of the JAX package's ``flash_attention_ntc``."""
    rng = np.random.default_rng(10)
    b, t, h, d = 2, 16, 2, 16
    qkv = rng.standard_normal((b, t, 3 * h * d)).astype(np.float32)
    g = rng.standard_normal((b, t, h, d)).astype(np.float32)
    q, k, v = (a.reshape(b, t, h, d) for a in np.split(qkv, 3, axis=-1))
    ref = _jax_vjp(jfa.flash_attention_ntc, (q, k, v), jnp.asarray(g),
                   causal=True, interpret=True)
    x = _t(qkv).requires_grad_(True)
    out = tfa.flash_attention_ntc(
        *(c.reshape(b, t, h, d) for c in x.chunk(3, dim=-1)), causal=True)
    out.backward(_t(g))
    got = [c.reshape(b, t, h, d).numpy() for c in x.grad.chunk(3, dim=-1)]
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a, r, atol=KERNEL_ATOL)


def test_flash_bwd_bf16_matches_jax_within_2e2():
    """bf16 inputs: dS and P round to bf16 before their products on both
    sides; grads agree within 2e-2 (bf16 ulps of values of order 1)."""
    rng = np.random.default_rng(11)
    q, k, v, g = (rng.standard_normal((1, 2, 32, 16)).astype(np.float32)
                  for _ in range(4))
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    _, vjp = jax.vjp(lambda *xs: jfa.flash_attention(
        *xs, causal=True, block_q=8, block_k=8, interpret=True), *jb)
    ref = vjp(jnp.asarray(g, jnp.bfloat16))
    xs = [_t(a).to(torch.bfloat16).requires_grad_(True) for a in (q, k, v)]
    tfa.flash_attention(*xs, causal=True).backward(_t(g).to(torch.bfloat16))
    for x, r in zip(xs, ref):
        assert x.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(x.grad.float().numpy(),
                                   np.asarray(r.astype(jnp.float32)),
                                   atol=2e-2, rtol=2e-2)


def test_flash_bwd_per_kernel_wrappers_split_the_plain_backward():
    """On CPU tensors the dQ and dK/dV wrappers return the plain
    backward's outputs and count no launch."""
    rng = np.random.default_rng(12)
    q, k, v, g = (_t(rng.standard_normal((1, 2, 16, 16))
                     .astype(np.float32)) for _ in range(4))
    o, lse = tfa.mha_reference_lse(q, k, v, causal=True)
    delta = (g * o).sum(-1)
    tfa.reset_launches()
    dq = tfa.flash_attention_bwd_dq(q, k, v, g, lse, delta, 0.25, True)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, 0.25, True)
    ref = tfa.flash_attention_bwd_reference(q, k, v, g, lse, delta, 0.25,
                                            True)
    for a, b in zip((dq, dk, dv), ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (tfa.LAUNCHES, tfa.LAUNCHES_BWD_DQ, tfa.LAUNCHES_BWD_DKV) == \
        (0, 0, 0)


# ------------------------------------------------- the refusal paths

def _paged_args():
    q = torch.zeros((1, 2, 8))
    k = torch.zeros((3, 4, 2, 8))
    table = torch.zeros((1, 2), dtype=torch.int32)
    pos = torch.zeros((1,), dtype=torch.int32)
    return q, k, k.clone(), table, pos


def test_cuda_requests_raise_without_a_card():
    """The CUDA launch paths, asked to run with no card, raise — they
    never hand the request to the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpa._paged_attention_cuda(*_paged_args())
    q = torch.zeros((1, 2, 8, 16))
    with pytest.raises(RuntimeError, match="CUDA"):
        tfa._flash_cuda(q, q, q, 0.25, True, "bhtd")
    with pytest.raises(RuntimeError, match="CUDA"):
        _build.load("paged_attention")
    q, lse = q.to("meta"), torch.zeros((1, 2, 8), device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        tfa.flash_attention_bwd_dq(q, q, q, q, lse, lse, 0.25, True)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfa.flash_attention_bwd_dkv(q, q, q, q, lse, lse, 0.25, True)


def test_wrappers_refuse_other_devices():
    meta = [t.to("meta") for t in _paged_args()]
    with pytest.raises(ValueError, match="cpu or cuda"):
        tpa.paged_attention(*meta)
    q = torch.empty((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfa.flash_attention(q, q, q)


def test_flash_kernel_refuses_grad_and_bad_inputs():
    """Inputs the kernels do not take raise before any launch: K1's and
    the backward wrappers' head-dim, alignment, dtype and device checks.
    A bf16 view the tensor-core kernels cannot copy in 16-byte chunks and
    a head dim whose tiles overflow a block's shared memory (1300: past
    1200 for dK/dV, past 1424 for dQ, past 1808 for K1) are refused.
    (Inputs that require grad are no longer refused: the Function runs
    them through K1 and the backward kernels.)"""
    odd = torch.zeros((1, 2, 8, 17), dtype=torch.bfloat16)[..., 1:]
    with pytest.raises(ValueError, match="aligned"):
        tfa._flash_cuda(odd, odd, odd, 0.25, True, "bhtd")
    q = torch.zeros((1, 2, 8, 1900))
    with pytest.raises(ValueError, match="head dim 1900.*227 KiB"):
        tfa._flash_cuda(q, q, q, 0.25, True, "bhtd")
    q = torch.zeros((1, 2, 8, 16), dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfa._flash_cuda(q, q, q, 0.25, True, "bhtd")
    lse = torch.zeros((1, 2, 8))
    for bwd in (tfa.flash_attention_bwd_dq, tfa.flash_attention_bwd_dkv):
        q = torch.zeros((1, 2, 8, 1500), device="meta")
        with pytest.raises(ValueError, match="head dim 1500.*227 KiB"):
            bwd(q, q, q, q, lse.to("meta"), lse.to("meta"), 0.2, True)
        q = torch.zeros((1, 2, 8, 17), dtype=torch.bfloat16,
                        device="meta")[..., 1:]
        with pytest.raises(ValueError, match="aligned"):
            bwd(q, q, q, q, lse.to("meta"), lse.to("meta"), 0.2, True)
        q = torch.zeros((1, 2, 8, 16), dtype=torch.float16, device="meta")
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            bwd(q, q, q, q, lse.to("meta"), lse.to("meta"), 0.25, True)
        q = torch.zeros((1, 2, 8, 16), device="meta")
        with pytest.raises(ValueError, match="dout on cpu"):
            bwd(q, q, q, torch.zeros((1, 2, 8, 16)), lse.to("meta"),
                lse.to("meta"), 0.25, True)
        with pytest.raises(ValueError, match="lse must be"):
            bwd(q, q, q, q, lse, lse.to("meta"), 0.25, True)
        with pytest.raises(ValueError, match="delta must be"):
            bwd(q, q, q, q, lse.to("meta"), lse.to("meta").double(), 0.25,
                True)


@pytest.mark.parametrize("d", [8, 24, 40, 80, 96, 120])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_take_every_head_dim_up_to_128(d, dtype):
    """Up to 128 the fast kernels run: the checks pass every D in both
    layouts and for each kernel, bf16 multiples of 8 on the tensor cores,
    f32 K1, dQ and dK/dV in split TF32 (the narrow kernels, padded to 64
    or 128); a D that is not a multiple of 8 runs the same f32 kernels and
    the general kernel in bf16 (rows that are not whole 16-byte chunks).
    Each kernel's route is its own."""
    q = torch.zeros((1, 2, 8, d), dtype=dtype)
    for kernel in ("fwd", "dq", "dkv"):
        for layout in ("bhtd", "bthd"):
            (b, h, t, dd), views = tfa._check_qkv(layout, kernel, q, q, q,
                                                  q)
            assert dd == d and len(views) == 4
    bf16 = dtype == torch.bfloat16
    for kernel in ("fwd", "dq", "dkv"):
        assert tfa.route(d, dtype, kernel) == ("wgmma" if bf16 else "tf32x3")
        tfa.check_head_dim(d - 3, dtype, kernel)
        assert tfa.route(d - 3, dtype, kernel) == ("general" if bf16
                                                   else "tf32x3")


def test_flash_head_dim_rule_bounds():
    """No D in 1..512 is refused, in either dtype, by any kernel; the
    refusals start where the general kernels' 8-row tiles overflow the
    227 KiB of shared memory a block may use, and name that limit."""
    assert tfa.FAST_MAX_HEAD_DIM == 128 and tfa.MAX_HEAD_DIM == 1200
    for d in range(1, 513):
        for dtype in (torch.float32, torch.bfloat16):
            for kernel in ("fwd", "dq", "dkv"):
                tfa.check_head_dim(d, dtype, kernel)
    for d in (0, -3):
        with pytest.raises(ValueError, match=f"head dim {d} must be"):
            tfa.check_head_dim(d, torch.float32)
    for kernel, last in (("dkv", 1200), ("dq", 1424), ("fwd", 1808)):
        for dtype in (torch.float32, torch.bfloat16):
            tfa.check_head_dim(last, dtype, kernel)
            with pytest.raises(ValueError,
                               match=rf"head dim {last + 1}: the {kernel} "
                                     r"kernel.*227 KiB \(232448 bytes\)"):
                tfa.check_head_dim(last + 1, dtype, kernel)


@pytest.mark.parametrize("d,rows", [(12, (64, 64, 64)), (128, (64, 64, 64)),
                                    (160, (64, 32, 32)), (256, (32, 32, 32)),
                                    (320, (32, 32, 16)), (512, (16, 16, 16)),
                                    (1024, (8, 8, 8))])
def test_flash_general_rows_shrink_as_head_dim_grows(d, rows):
    """The general kernels' tile rows (fwd, dq, dkv) at each head dim:
    the largest of 64, 32, 16, 8 whose tiles fit in a block's shared
    memory, so every D up to 512 fits; a row stride meets 32 banks
    (odd, or congruent to the lanes that share a dot product)."""
    assert tuple(tfa.general_rows(k, d) for k in ("fwd", "dq", "dkv")) \
        == rows
    for kernel, r in zip(("fwd", "dq", "dkv"), rows):
        assert tfa.general_smem_bytes(kernel, r, d) <= tfa.SMEM_PER_BLOCK
        if r < 64:
            assert tfa.general_smem_bytes(kernel, 2 * r, d) \
                > tfa.SMEM_PER_BLOCK
        ld = tfa._general_ld(r, d)
        assert d <= ld < d + 32
        assert ld % 2 == 1 if r >= 32 else ld % 32 == (4 if r == 16 else 16)


_TC, _GN, _TF = "wgmma", "general", "tf32x3"
_TCW, _TFW = "wgmma-wide", "tf32x3-wide"


@pytest.mark.parametrize("d,dtype,kinds", [
    (64, torch.bfloat16, (_TC, _TC, _TC)),
    (128, torch.bfloat16, (_TC, _TC, _TC)),
    (12, torch.bfloat16, (_GN, _GN, _GN)),
    (130, torch.bfloat16, (_GN, _GN, _GN)),
    (136, torch.bfloat16, (_TC, _TC, _TC)),
    (256, torch.bfloat16, (_TC, _TC, _TC)),
    (264, torch.bfloat16, (_TCW, _TCW, _TCW)),
    (320, torch.bfloat16, (_TCW, _TCW, _TCW)),
    (324, torch.bfloat16, (_GN, _GN, _GN)),
    (512, torch.bfloat16, (_TCW, _TCW, _TCW)),
    (520, torch.bfloat16, (_GN, _GN, _GN)),
    (12, torch.float32, (_TF, _TF, _TF)),
    (64, torch.float32, (_TF, _TF, _TF)),
    (80, torch.float32, (_TF, _TF, _TF)),
    (128, torch.float32, (_TF, _TF, _TF)),
    (129, torch.float32, (_TF, _TF, _TF)),
    (160, torch.float32, (_TF, _TF, _TF)),
    (256, torch.float32, (_TF, _TF, _TF)),
    (257, torch.float32, (_TFW, _TFW, _TFW)),
    (320, torch.float32, (_TFW, _TFW, _TFW)),
    (512, torch.float32, (_TFW, _TFW, _TFW)),
    (513, torch.float32, (_GN, _GN, _GN))])
def test_flash_route_by_head_dim_and_dtype(d, dtype, kinds):
    """Which kernel family a (D, dtype) runs in K1, dQ and dK/dV: bf16
    on the tensor cores up to 256 (multiples of 8); f32 K1, dQ and dK/dV
    in split TF32 at 1..256 (the narrow kernels up to 128); all three
    past 256 up to 512 on their wide
    kernels (bf16 multiples of 8 on the tensor cores, f32 in split TF32),
    general past 512; only the bf16 tensor-core routes
    check 16-byte alignment, so a general bf16 D and every f32 D take any
    strides, in each of the three wrappers."""
    assert tuple(tfa.route(d, dtype, kn) for kn in ("fwd", "dq", "dkv")) \
        == kinds
    buf = torch.zeros((1, 8, 3 * 2 * d + 1), dtype=dtype)
    q, k, v = (buf[..., 1 + i * 2 * d:1 + (i + 1) * 2 * d]
               .reshape(1, 8, 2, d) for i in range(3))
    if kinds[0] in (_TC, _TCW):
        with pytest.raises(ValueError, match="aligned"):
            tfa._flash_cuda(q, k, v, 0.25, True, "bthd")
    elif not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tfa._flash_cuda(q, k, v, 0.25, True, "bthd")
    meta = buf.to("meta")
    mq, mk, mv = (meta[..., 1 + i * 2 * d:1 + (i + 1) * 2 * d]
                  .reshape(1, 8, 2, d) for i in range(3))
    lse = torch.zeros((1, 2, 8), device="meta")
    for kind, bwd in zip(kinds[1:], (tfa.flash_attention_bwd_dq,
                                     tfa.flash_attention_bwd_dkv)):
        if kind in (_TC, _TCW):
            with pytest.raises(ValueError, match="aligned"):
                bwd(mq, mk, mv, mq, lse, lse, 0.25, True, "bthd")
        elif not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                bwd(mq, mk, mv, mq, lse, lse, 0.25, True, "bthd")


_CSRC = Path(tfa.__file__).resolve().parent.parent / "csrc"


def _csrc_smem(struct, **params):
    """``struct``'s ``SMEM`` as the csrc sources define it, evaluated from
    their text for the template arguments ``params``: each ``static
    constexpr int`` field of the struct, and of the ``Tile<D, R>`` it
    names by ``using``, is read and evaluated on demand."""
    src = "".join(f.read_text() for f in sorted(_CSRC.glob("flash_*")))

    def fields(name):
        body = re.search(rf"struct {name} {{(.*?)\n}};", src, re.S)[1]
        body = re.sub(r"//[^\n]*", "", body)
        out = dict(re.findall(r"static constexpr int (\w+) = ([^;]+);",
                              body))
        for alias, d, r in re.findall(
                r"using (\w+) = (?:\w+::)?Tile<(\w+), (\w+)>;", body):
            out.update({f"{alias}__{k}": (e, (d, r))
                        for k, e in fields("Tile").items()})
        return out

    def value(name, env, defs):
        if name in env:
            return env[name]
        expr = defs[name]
        if isinstance(expr, tuple):     # a Tile's field: Tile<D, R>
            expr, (d, r) = expr
            tile_env = {"D": value(d, env, defs), "R": value(r, env, defs)}
            return value(name.split("__")[1], tile_env, fields("Tile"))
        names = set(re.findall(r"[A-Za-z_]\w*(?:::\w+)?", expr))
        scope = {n.replace("::", "__"): value(n.replace("::", "__"), env,
                                              defs) for n in names}
        return eval(expr.replace("::", "__"), {}, scope)

    return value("SMEM", dict(params), fields(struct))


@pytest.mark.parametrize("struct, params, kib", [
    ("FwdCfg", {"D": 256, "BK": 64}, 161),
    ("DkvSplitCfg", {}, 226),
    ("DqSplitCfg", {"DP": 256, "KB": 64}, 225),
    ("Tf32FwdCfg", {}, 201),
    ("Tf32DqCfg", {"DP": 256, "CTAS": 1}, 192),
    ("Tf32DkvCfg", {"DP": 256, "CTAS": 1}, 196.5),
    ("DkvCfg", {"D": 128}, 98),
    ("DqCfg", {"D": 128}, 97),
    ("FwdCfg", {"D": 64, "BK": 128}, 73),
])
def test_tensor_core_configs_fit_shared_memory(struct, params, kib):
    """The tensor-core kernels' shared memory, read from the csrc configs
    themselves: K1 at padded D 256 takes 161 KiB (Q, two stages of K and
    V at 64-key steps; one block an SM), the two-warpgroup dK/dV 226 KiB
    (K, V, two stages of Q and dO, its 32 KiB exchange, the lse and delta
    rows), the two-warpgroup dQ 225 KiB (Q, dO, two stages of K and V,
    the exchange), the f32 split-TF32 K1 201 KiB (Q, two stages of K and
    V at 32-key steps, rows padded by 16 and 4 floats), the split-TF32 dQ
    192 KiB (Q and dO of 32 rows, two stages of K and V at 32-key steps)
    and dK/dV 196.5 KiB (K and V of 32 keys, two stages of Q and dO of
    32 rows, the lse and delta rows, the pairs' Pᵀ); each fits in the
    227 KiB a block may use."""
    smem = _csrc_smem(struct, **params)
    assert smem == kib * 1024
    assert smem <= tfa.SMEM_PER_BLOCK == 232448


# -------------------------------- the tensor-core tiles' layouts (CPU side)

def _tile_off(d, rows, r, c):
    """Byte offset of 16-byte chunk ``c`` of row ``r`` of a
    ``Tile<d, rows>`` (csrc/flash_mma.cuh ``Tile::off``)."""
    panel = 64 if d > 64 else d
    nc = panel // 8
    rpl = 1 if nc >= 8 else 8 // nc
    sw = 8 if nc >= 8 else nc
    return (c // nc) * rows * panel * 2 \
        + (r * nc + ((c % nc) ^ ((r // rpl) % sw))) * 16


def _elem(d, rows, r, col):
    return _tile_off(d, rows, r, col // 8) + 2 * (col % 8)


def _sw128(addr):
    """Hopper's 128-byte swizzle: address bits 4-6 XOR bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _hw_k_major(start, sbo, m, k):
    """The byte a 128-byte-swizzled K-major wgmma operand reads for row
    ``m``, column ``k`` of one 16-wide k-step from a descriptor at
    ``start`` (8-row groups ``sbo`` apart)."""
    return _sw128(start + (m // 8) * sbo + (m % 8) * 128 + 2 * k)


def _hw_mn_major(start, lbo, sbo, k, n):
    """The byte a 128-byte-swizzled MN-major wgmma B operand reads for
    row ``k`` (of 16), column ``n``: 64-column atoms ``lbo`` apart,
    8-row groups ``sbo`` apart."""
    return _sw128(start + (n // 64) * lbo + (k // 8) * sbo + (k % 8) * 128
                  + 2 * (n % 64))


@pytest.mark.parametrize("d,rows", [(64, 64), (128, 64), (256, 64),
                                    (256, 32)])
def test_tile_layout_matches_wgmma_descriptors(d, rows):
    """``Tile<d, rows>`` lane by lane against the addresses wgmma reads
    through the descriptors the kernels build (``desc_k``, ``desc_mn``),
    on the hardware's 128-byte swizzle: every element of every k-step of
    a K-major operand (Q·Kᵀ, K·Qᵀ), of the MN-major B operand over all
    of D (K1's P·V, N = D) and over each 128-column half (the
    two-warpgroup dK/dV's dV += Pᵀ·dO, dK += dSᵀ·Q). D 64 and 128 are
    the layouts the card already runs; D 256 is four 64-column panels,
    each laid out as a D 64 tile at its panel offset."""
    panel = 64 if d > 64 else d
    panel_bytes = rows * panel * 2
    sbo = 8 * panel * 2
    offs = sorted(_tile_off(d, rows, r, c)
                  for r in range(rows) for c in range(d // 8))
    assert offs == list(range(0, rows * d * 2, 16))    # a bijection
    for r in range(rows):
        for c in range(d // 8):
            assert _tile_off(d, rows, r, c) == (c // 8) * panel_bytes \
                + _tile_off(64, rows, r, c % 8)
    for kk in range(d // 16):                 # desc_k(s, kk)
        start = (16 * kk // panel) * panel_bytes + (16 * kk % panel) * 2
        for m in range(rows):
            for k in range(16):
                assert _hw_k_major(start, sbo, m, k) \
                    == _elem(d, rows, m, 16 * kk + k)
    lbo = sbo if panel == d else panel_bytes
    halves = [(0, d)] + ([(0, 128), (128, 128)] if d == 256 else [])
    for n0, width in halves:                  # desc_mn(s + n0 panels, kk)
        for kk in range(rows // 16):
            start = (n0 // 64) * panel_bytes + 16 * kk * panel * 2
            for k in range(16):
                for n in range(width):
                    assert _hw_mn_major(start, lbo, sbo, k, n) \
                        == _elem(d, rows, 16 * kk + k, n0 + n)


def _dkv_split_emulation(q, k, v, do, lse, delta, scale, causal):
    """``flash_bwd_dkv_wgmma_split_kernel``'s schedule in torch on bf16
    (B, H, T, D), D <= 256: columns zero-padded to 256; per 64-key tile
    and 64-query step (from the diagonal down when causal), Sᵀ = K·Qᵀ and
    dPᵀ = V·dOᵀ as the f32 partials of the two 128-column halves added
    half 0 + half 1; Pᵀ = exp(Sᵀ·scale − lse), masked; each half of the
    columns of dV += bf16(Pᵀ)·dO and dK += bf16(Pᵀ∘(dPᵀ − delta)·scale)·Q
    on its own, f32 sums, bf16 out."""
    b, h, t, d = q.shape
    qf, kf, vf, dof = (torch.nn.functional.pad(x.float(), (0, 256 - d))
                       for x in (q, k, v, do))
    dk = torch.zeros((b, h, t, 256))
    dv = torch.zeros((b, h, t, 256))
    halves = (slice(0, 128), slice(128, 256))
    for k0 in range(0, t, 64):
        ks = slice(k0, min(k0 + 64, t))
        keys = torch.arange(k0, ks.stop)
        for i0 in range(k0 if causal else 0, t, 64):
            qs = slice(i0, min(i0 + 64, t))
            rows = torch.arange(i0, qs.stop)
            st, dpt = (
                sum(a[..., ks, c] @ o[..., qs, c].transpose(-1, -2)
                    for c in halves)
                for a, o in ((kf, qf), (vf, dof)))
            p = torch.exp(st * scale - lse[..., None, qs])
            if causal:
                p = torch.where(rows[None, :] >= keys[:, None], p,
                                torch.zeros(()))
            ds = (p * (dpt - delta[..., None, qs]) * scale) \
                .to(torch.bfloat16).float()
            pb = p.to(torch.bfloat16).float()
            for c in halves:
                dv[..., ks, c] += pb @ dof[..., qs, c]
                dk[..., ks, c] += ds @ qf[..., qs, c]
    return dk[..., :d].to(torch.bfloat16), dv[..., :d].to(torch.bfloat16)


@pytest.mark.parametrize("d", [160, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_dkv_column_split_matches_plain_backward(d, causal):
    """Part of the two-warpgroup dK/dV at padded D 256, emulated: the
    halves' partials of Sᵀ and dPᵀ added in the fixed order give the
    plain backward's dK and dV within the kernels' bf16 bar (relative L2
    1e-2), at D 160 (zero-padded columns) and 256, T 200 (a ragged last
    tile)."""
    rng = np.random.default_rng(11)
    b, h, t = 1, 2, 200
    q, k, v, do = (torch.as_tensor(rng.standard_normal((b, h, t, d))
                                   .astype(np.float32)).to(torch.bfloat16)
                   for _ in range(4))
    scale = d ** -0.5
    _, lse = tfa.mha_reference_lse(q, k, v, scale, causal)
    delta = torch.as_tensor(rng.standard_normal((b, h, t))
                            .astype(np.float32))
    _, ref_dk, ref_dv = tfa.flash_attention_bwd_reference(
        q, k, v, do, lse, delta, scale, causal)
    dk, dv = _dkv_split_emulation(q, k, v, do, lse, delta, scale, causal)
    for got, want in ((dk, ref_dk), (dv, ref_dv)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        rel = ((got.float() - want.float()).norm()
               / want.float().norm()).item()
        assert rel <= 1e-2


def _dq_split_emulation(q, k, v, do, lse, delta, scale, causal):
    """``flash_bwd_dq_wgmma_split_kernel``'s schedule in torch on bf16
    (B, H, T, D), D <= 256: columns zero-padded to 256; per 64-query tile
    and 64-key step (up to the diagonal when causal), S = Q·Kᵀ and
    dP = dO·Vᵀ as the f32 partials of the two 128-column halves added
    half 0 + half 1; P = exp(S·scale − lse), masked; each half of the
    columns of dQ += bf16(P∘(dP − delta)·scale)·K on its own, f32 sums,
    bf16 out."""
    b, h, t, d = q.shape
    qf, kf, vf, dof = (torch.nn.functional.pad(x.float(), (0, 256 - d))
                       for x in (q, k, v, do))
    dq = torch.zeros((b, h, t, 256))
    halves = (slice(0, 128), slice(128, 256))
    for q0 in range(0, t, 64):
        qs = slice(q0, min(q0 + 64, t))
        rows = torch.arange(q0, qs.stop)
        for k0 in range(0, min(t, q0 + 64) if causal else t, 64):
            ks = slice(k0, min(k0 + 64, t))
            keys = torch.arange(k0, ks.stop)
            s, dp = (
                sum(a[..., qs, c] @ o[..., ks, c].transpose(-1, -2)
                    for c in halves)
                for a, o in ((qf, kf), (dof, vf)))
            p = torch.exp(s * scale - lse[..., qs, None])
            if causal:
                p = torch.where(keys[None, :] <= rows[:, None], p,
                                torch.zeros(()))
            ds = (p * (dp - delta[..., qs, None]) * scale) \
                .to(torch.bfloat16).float()
            for c in halves:
                dq[..., qs, c] += ds @ kf[..., ks, c]
    return dq[..., :d].to(torch.bfloat16)


@pytest.mark.parametrize("d", [160, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_dq_column_split_matches_plain_backward(d, causal):
    """Part of the two-warpgroup dQ at padded D 256, emulated: the halves'
    partials of S and dP added in the fixed order give the plain
    backward's dQ within the kernels' bf16 bar (relative L2 1e-2), at D
    160 (zero-padded columns) and 256, T 200 (a ragged last tile)."""
    rng = np.random.default_rng(12)
    b, h, t = 1, 2, 200
    q, k, v, do = (torch.as_tensor(rng.standard_normal((b, h, t, d))
                                   .astype(np.float32)).to(torch.bfloat16)
                   for _ in range(4))
    scale = d ** -0.5
    _, lse = tfa.mha_reference_lse(q, k, v, scale, causal)
    delta = torch.as_tensor(rng.standard_normal((b, h, t))
                            .astype(np.float32))
    ref_dq = tfa.flash_attention_bwd_reference(q, k, v, do, lse, delta,
                                               scale, causal)[0]
    dq = _dq_split_emulation(q, k, v, do, lse, delta, scale, causal)
    assert dq.dtype == torch.bfloat16 and dq.shape == ref_dq.shape
    rel = ((dq.float() - ref_dq.float()).norm()
           / ref_dq.float().norm()).item()
    assert rel <= 1e-2


def _tf32(x):
    """f32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it, and as
    the kernel's two integer operations do: to nearest, ties away from
    zero, 10 mantissa bits (add half of the 13 dropped bits' range to the
    magnitude, then clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x):
    """f32 ``x`` as the tensor core reads an f32 register as TF32: its low
    13 mantissa bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a, b, passes):
    """a @ b in f32 from TF32 products: ``passes`` 3 splits each operand
    into hi = tf32(x) and lo = x − hi (read as TF32) and sums lo·hi +
    hi·lo + hi·hi; ``passes`` 1 is one product of the TF32-rounded
    operands."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _tf32x3_fwd_emulation(q, k, v, scale, causal, passes=3):
    """``flash_fwd_tf32x3_kernel``'s schedule in torch on f32 (B, H, T,
    D), D <= 256: columns zero-padded to 256; per 64-query tile, two
    online softmaxes, one over the first 16 keys of every 32-key step and
    one over the second 16 (up to the diagonal when causal): S = Q·Kᵀ in
    split TF32, scaled into log2 units, masked; exp2, running max and row
    sum of the f32 P; O = O·corr + P·V in split TF32 (P split too); then
    the two halves merged. Returns O and the lse."""
    b, h, t, d = q.shape
    qf, kf, vf = (torch.nn.functional.pad(x, (0, 256 - d))
                  for x in (q, k, v))
    sl2 = scale * math.log2(math.e)
    o = torch.zeros((b, h, t, 256))
    lse = torch.zeros((b, h, t))
    for q0 in range(0, t, 64):
        qs = slice(q0, min(q0 + 64, t))
        rows = torch.arange(q0, qs.stop)
        n = qs.stop - q0
        state = []
        for half in (0, 1):
            m = torch.full((b, h, n), -math.inf)
            l = torch.zeros((b, h, n))
            acc = torch.zeros((b, h, n, 256))
            for k0 in range(16 * half, min(t, q0 + 64) if causal else t,
                            32):
                ks = slice(k0, min(k0 + 16, t))
                keys = torch.arange(k0, ks.stop)
                s = _mm_tf32(qf[..., qs, :],
                             kf[..., ks, :].transpose(-1, -2), passes) * sl2
                if causal:
                    s = torch.where(keys[None, :] <= rows[:, None], s,
                                    torch.tensor(-math.inf))
                mn = torch.maximum(m, s.max(-1).values)
                base = torch.where(mn == -math.inf, torch.zeros(()), mn)
                corr = torch.exp2(m - base)
                p = torch.exp2(s - base[..., None])
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] \
                    + _mm_tf32(p, vf[..., ks, :], passes)
                m = mn
            state.append((m, l, acc))
        (m0, l0, o0), (m1, l1, o1) = state
        mt = torch.maximum(m0, m1)
        a0, a1 = torch.exp2(m0 - mt), torch.exp2(m1 - mt)
        lt = l0 * a0 + l1 * a1
        o[..., qs, :] = (o0 * a0[..., None] + o1 * a1[..., None]) \
            / lt[..., None]
        lse[..., qs] = (mt + torch.log2(lt)) * math.log(2.0)
    return o[..., :d], lse


def test_tf32_rounding_is_to_nearest_ties_away():
    """The emulated ``cvt.rna``: 10 mantissa bits kept, the 13 dropped
    ones rounded to nearest with ties away from zero, in both signs."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 4, one + ulp / 2, one + 3 * ulp / 4,
                      -(one + ulp / 2), one + 1.5 * ulp, 3.0],
                     dtype=torch.float32)
    want = torch.tensor([one, one + ulp, one + ulp, -(one + ulp),
                         one + 2 * ulp, 3.0], dtype=torch.float32)
    assert torch.equal(_tf32(x), want)
    y = torch.as_tensor(np.random.default_rng(0).standard_normal(1000)
                        .astype(np.float32))
    hi = _tf32(y)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((hi - y).abs() <= y.abs() * 2.0 ** -11).all()


@pytest.mark.parametrize("d", [130, 160, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_tf32x3_forward_meets_the_f32_bars(d, causal):
    """The split-TF32 f32 K1, emulated on its own schedule (64-query tiles,
    two 16-key halves of each 32-key step with their own online softmax,
    merged at the end; three TF32 products for Q·Kᵀ and for P·V), against
    ``mha_reference_lse`` at T 200: O within the f32 atol 1e-4 and lse
    within 1e-3, at D 130, 160 and 256 (zero-padded to 256); one TF32
    product instead of three misses the O bar."""
    rng = np.random.default_rng(13)
    b, h, t = 1, 2, 200
    q, k, v = (torch.as_tensor(rng.standard_normal((b, h, t, d))
                               .astype(np.float32)) for _ in range(3))
    scale = d ** -0.5
    ref, ref_lse = tfa.mha_reference_lse(q, k, v, scale, causal)
    o, lse = _tf32x3_fwd_emulation(q, k, v, scale, causal)
    err = (o - ref).abs().max().item()
    assert o.shape == ref.shape and err <= 1e-4
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    o1, _ = _tf32x3_fwd_emulation(q, k, v, scale, causal, passes=1)
    assert (o1 - ref).abs().max().item() > 1e-4


def _tf32x3_bwd_emulation(q, k, v, do, lse, delta, scale, causal,
                          passes=3):
    """``flash_bwd_dq_tf32x3_kernel``'s and ``flash_bwd_dkv_tf32x3_kernel``'s
    schedules in torch on f32 (B, H, T, D), D <= 256, columns zero-padded
    to 256; every product in split TF32 (P and dS split too). dQ: per
    32-query tile and 32-key step (up to the diagonal when causal), one
    partial per 8 keys of each step: S = Q·Kᵀ, dP = dO·Vᵀ, P = exp2(S·scale
    ·log2 e − lse·log2 e) masked, dS = P∘(dP − delta)·scale, partial +=
    dS·K; the four summed 0 + 1 + 2 + 3. dK/dV: per 32-key tile and
    32-query step (from the diagonal down when causal), one partial of each
    output per 16 queries of each step: Sᵀ = K·Qᵀ, Pᵀ masked, dV += Pᵀ·dO;
    dPᵀ = V·dOᵀ, dSᵀ = Pᵀ∘(dPᵀ − delta)·scale, dK += dSᵀ·Q; the two summed
    0 + 1. Returns dq, dk, dv."""
    b, h, t, d = q.shape
    qf, kf, vf, dof = (torch.nn.functional.pad(x, (0, 256 - d))
                       for x in (q, k, v, do))
    log2e = math.log2(math.e)
    sl2, l2 = scale * log2e, lse * log2e
    zero = torch.zeros(())

    def mm(a, b_):
        return _mm_tf32(a, b_, passes)

    dq = torch.zeros((b, h, t, 256))
    for q0 in range(0, t, 32):
        qs = slice(q0, min(q0 + 32, t))
        rows = torch.arange(q0, qs.stop)
        parts = [torch.zeros((b, h, qs.stop - q0, 256)) for _ in range(4)]
        for k0 in range(0, min(t, q0 + 32) if causal else t, 32):
            for part in range(4):
                ks = slice(k0 + 8 * part, min(k0 + 8 * part + 8, t))
                if ks.start >= t:       # zero-filled keys, masked
                    continue
                keys = torch.arange(ks.start, ks.stop)
                kt = kf[..., ks, :]
                s = mm(qf[..., qs, :], kt.transpose(-1, -2))
                dp = mm(dof[..., qs, :], vf[..., ks, :].transpose(-1, -2))
                p = torch.exp2(s * sl2 - l2[..., qs, None])
                if causal:
                    p = torch.where(keys[None, :] <= rows[:, None], p, zero)
                ds = p * (dp - delta[..., qs, None]) * scale
                parts[part] += mm(ds, kt)
        dq[..., qs, :] = ((parts[0] + parts[1]) + parts[2]) + parts[3]

    dk = torch.zeros((b, h, t, 256))
    dv = torch.zeros((b, h, t, 256))
    for k0 in range(0, t, 32):
        ks = slice(k0, min(k0 + 32, t))
        keys = torch.arange(k0, ks.stop)
        kt, vt = kf[..., ks, :], vf[..., ks, :]
        pk = [torch.zeros((b, h, ks.stop - k0, 256)) for _ in range(2)]
        pv = [torch.zeros((b, h, ks.stop - k0, 256)) for _ in range(2)]
        for i0 in range(k0 if causal else 0, t, 32):
            for half in (0, 1):
                qs = slice(i0 + 16 * half, min(i0 + 16 * half + 16, t))
                if qs.start >= t:       # zero-filled queries, masked
                    continue
                rows = torch.arange(qs.start, qs.stop)
                qt, dot = qf[..., qs, :], dof[..., qs, :]
                p = torch.exp2(mm(kt, qt.transpose(-1, -2)) * sl2
                               - l2[..., None, qs])
                if causal:
                    p = torch.where(rows[None, :] >= keys[:, None], p, zero)
                pv[half] += mm(p, dot)
                dpt = mm(vt, dot.transpose(-1, -2))
                pk[half] += mm(p * (dpt - delta[..., None, qs]) * scale, qt)
        dk[..., ks, :] = pk[0] + pk[1]
        dv[..., ks, :] = pv[0] + pv[1]
    return dq[..., :d], dk[..., :d], dv[..., :d]


def _bwd_case(d, causal, seed=14, b=1, h=2, t=200):
    """Seeded f32 (B, H, T, D) q, k, v, dO as numpy, and the plain
    forward's lse and delta = rowsum(dO·O) on them."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((b, h, t, d)).astype(np.float32)
              for _ in range(4)]
    q, k, v, do = (_t(a) for a in arrays)
    o, lse = tfa.mha_reference_lse(q, k, v, causal=causal)
    return arrays, (q, k, v, do), lse, (do * o).sum(-1)


@pytest.mark.parametrize("d", [130, 160, 200, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_tf32x3_backward_meets_the_f32_bars(d, causal):
    """The split-TF32 f32 dQ and dK/dV, emulated on their own schedules
    (32-query tiles with four 8-key partials a step; 32-key tiles with two
    16-query partials a step; fixed-order sums), at T 200 (a ragged last
    tile) and D 130, 160, 200 (zero-padded to 256) and 256: dq, dk and dv
    within the f32 atol 1e-4 of ``flash_attention_bwd_reference`` and of
    jax.vjp through the JAX package's Pallas backward kernels (interpret
    mode, 40-row blocks)."""
    arrays, (q, k, v, do), lse, delta = _bwd_case(d, causal)
    scale = d ** -0.5
    got = _tf32x3_bwd_emulation(q, k, v, do, lse, delta, scale, causal)
    plain = tfa.flash_attention_bwd_reference(q, k, v, do, lse, delta,
                                              scale, causal)
    pallas = _jax_vjp(jfa.flash_attention, arrays[:3],
                      jnp.asarray(arrays[3]), causal=causal, block_q=40,
                      block_k=40, interpret=True)
    for g, p, j in zip(got, plain, pallas):
        assert g.shape == p.shape
        assert (g - p).abs().max().item() <= 1e-4
        np.testing.assert_allclose(g.numpy(), j, rtol=0, atol=1e-4)


def test_one_tf32_product_misses_the_backward_bar():
    """One TF32 product instead of three (P and dS rounded to one TF32)
    misses the f32 atol 1e-4 at D 256: the backward needs the split."""
    _, (q, k, v, do), lse, delta = _bwd_case(256, True)
    scale = 256 ** -0.5
    plain = tfa.flash_attention_bwd_reference(q, k, v, do, lse, delta,
                                              scale, True)
    one = _tf32x3_bwd_emulation(q, k, v, do, lse, delta, scale, True,
                                passes=1)
    assert max((g - p).abs().max().item() for g, p in zip(one, plain)) \
        > 1e-4


# The swizzled tiles of the backward and of the narrow K1
# (csrc/flash_tf32.cuh swz and ld4): chunk c of row r at chunk c ^ swz(r)
# of a row of ``ld`` floats (256; the narrow kernels' 64 and 128).

def _swz(r):
    return (r & 6) ^ ((r & 1) << 2)


def _ld4(r, c, ld=256):
    """Float offsets (physical) of the float4 ``ld4<ld>(tile, r, c)``
    reads."""
    return [r * ld + 4 * (c ^ _swz(r)) + i for i in range(4)]


def _phys_to_logical(off, ld=256):
    r, x = divmod(off, ld)
    return r, 4 * ((x // 4) ^ _swz(r)) + x % 4


def _lanes():
    return [(lane, lane >> 2, lane & 3) for lane in range(32)]


def _mma_m16n8k8(a_regs, b_regs):
    """The hardware's m16n8k8: lane (g, t) holds A (g, t), (g + 8, t),
    (g, t + 4), (g + 8, t + 4) and B (k t, n g), (k t + 4, n g); returns
    each lane's (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1) of
    A·B."""
    a = np.zeros((16, 8))
    b = np.zeros((8, 8))
    for lane, g, t in _lanes():
        a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = a_regs[lane]
        b[t, g], b[t + 4, g] = b_regs[lane]
    d = a @ b
    return [(d[g, 2 * t], d[g, 2 * t + 1], d[g + 8, 2 * t],
             d[g + 8, 2 * t + 1]) for _, g, t in _lanes()]


def _quarter_conflicts(reads):
    """Bank conflicts of a warp's float4 reads (lane -> float offsets): the
    extra wavefronts over one a quarter-warp (8 lanes, 16 bytes each, on 8
    distinct 16-byte bank groups when conflict-free)."""
    extra = 0
    for j in range(4):
        groups = [(reads[lane][0] // 4) % 8 for lane in range(8 * j, 8 * j + 8)]
        extra += max(groups.count(x) for x in set(groups)) - 1
    return extra


def _check_fragment_reads(rng, ld):
    """The split-TF32 backward's fragment reads, lane by lane, from
    swizzled tiles of rows of ``ld`` floats through the hardware's
    m16n8k8 layout (as the tests below describe): every lane's
    accumulators are the products they feed, and every float4 read
    meets all 8 bank groups in each quarter-warp."""
    a = rng.integers(-4, 5, (32, ld)).astype(np.float64)
    bt = rng.integers(-4, 5, (32, ld)).astype(np.float64)
    # the tiles as the loader lays them out: logical (r, col) at its
    # swizzled offset
    phys_a, phys_b = np.zeros(32 * ld), np.zeros(32 * ld)
    for r in range(32):
        for col in range(ld):
            off = _ld4(r, col // 4, ld)[col % 4]
            assert _phys_to_logical(off, ld) == (r, col)
            phys_a[off], phys_b[off] = a[r, col], bt[r, col]

    # S = A·Bᵀ over the head dim: A rows ra, ra + 8; B rows rb .. rb + 7
    for ra, rb in ((0, 8), (16, 24), (16, 0)):
        acc = [(0.0,) * 4] * 32
        for kp in range(ld // 16):
            a_regs = [[], []]
            b_regs = [[], []]
            reads = {"a": {}, "a8": {}, "b": {}}
            for lane, g, t in _lanes():
                x = _ld4(ra + g, 4 * kp + t, ld)
                y = _ld4(ra + g + 8, 4 * kp + t, ld)
                z = _ld4(rb + g, 4 * kp + t, ld)
                reads["a"][lane], reads["a8"][lane], reads["b"][lane] = \
                    x, y, z
                xa, ya, zb = phys_a[x], phys_a[y], phys_b[z]
                a_regs[0].append((xa[0], ya[0], xa[1], ya[1]))
                a_regs[1].append((xa[2], ya[2], xa[3], ya[3]))
                b_regs[0].append((zb[0], zb[1]))
                b_regs[1].append((zb[2], zb[3]))
            assert all(_quarter_conflicts(r) == 0 for r in reads.values())
            for s in (0, 1):
                d = _mma_m16n8k8(a_regs[s], b_regs[s])
                acc = [tuple(p + q for p, q in zip(u, w))
                       for u, w in zip(acc, d)]
        want = a[ra:ra + 16] @ bt[rb:rb + 8].T
        for lane, g, t in _lanes():
            assert acc[lane] == (want[g, 2 * t], want[g, 2 * t + 1],
                                 want[g + 8, 2 * t], want[g + 8, 2 * t + 1])

    # acc (16 x ld) += X·B over B's rows r0 .. r0 + 7, X an accumulator
    x = rng.integers(-4, 5, (16, 8)).astype(np.float64)
    for r0 in (0, 8, 24):
        out = np.zeros((16, ld))
        xa = [(x[g, 2 * t], x[g + 8, 2 * t], x[g, 2 * t + 1],
               x[g + 8, 2 * t + 1]) for _, g, t in _lanes()]
        for c in range(ld // 32):
            reads0 = {lane: _ld4(r0 + 2 * t, 8 * c + g, ld)
                      for lane, g, t in _lanes()}
            reads1 = {lane: _ld4(r0 + 2 * t + 1, 8 * c + g, ld)
                      for lane, g, t in _lanes()}
            assert _quarter_conflicts(reads0) == 0
            assert _quarter_conflicts(reads1) == 0
            for u in range(4):
                b_regs = [(phys_b[reads0[lane][u]], phys_b[reads1[lane][u]])
                          for lane in range(32)]
                d = _mma_m16n8k8(xa, b_regs)
                for lane, g, t in _lanes():
                    for i in range(4):
                        col = 32 * c + 8 * t + 4 * (i & 1) + u
                        out[g + 8 * (i >> 1), col] = d[lane][i]
        np.testing.assert_array_equal(out, x @ bt[r0:r0 + 8])


def test_tf32x3_bwd_fragments_read_what_the_products_need():
    """The split-TF32 backward's fragment reads, lane by lane, from the
    swizzled tiles through the hardware's m16n8k8 fragment layout: over the
    head dim (a_frags on rows r, r + 8 and mma_dims on row r of B, the
    permuted k indices 4t, 4t+1 | 4t+2, 4t+3 of each 16 dims) every lane's
    accumulators are S = A·Bᵀ at (g, 2t), (g, 2t + 1), (g + 8, ..); over a
    tile's rows (mma_rows: S's accumulators as A fragments, B's rows 2t and
    2t + 1 at columns 32 c + 4 g + u) they are X·B at the permuted columns
    32 c + 8 t + u and 32 c + 8 t + 4 + u that store_sum writes. Every
    float4 read of either pattern meets all 8 bank groups in each
    quarter-warp; a padded row of D + 16 floats (K1's Q and K) would leave
    3 extra wavefronts a quarter-warp on the second, D + 4 (K1's V) 1 on
    the first."""
    _check_fragment_reads(np.random.default_rng(15), 256)

    def padded(ld, rows_of, chunk_of):
        return _quarter_conflicts({lane: [rows_of(g, t) * ld
                                          + 4 * chunk_of(g, t)]
                                   for lane, g, t in _lanes()})
    assert padded(272, lambda g, t: g, lambda g, t: t) == 0
    assert padded(272, lambda g, t: 2 * t, lambda g, t: g) == 12
    assert padded(260, lambda g, t: g, lambda g, t: t) == 4
    assert padded(260, lambda g, t: 2 * t, lambda g, t: g) == 0


@pytest.mark.parametrize("ld", [64, 128])
def test_tf32x3_narrow_bwd_fragments_read_what_the_products_need(ld):
    """The narrow split-TF32 dQ and dK/dV (f32 D <= 128) read tiles of
    rows of 64 (D 1-64) or 128 (D 65-128) floats, 16 or 32 float4 chunks,
    under the same swizzle and fragment layouts as the D-256 kernels:
    lane by lane through the hardware's m16n8k8, the A fragments of a
    warp's resident rows (rows g, g + 8, split once), the B reads over the
    head dim and over a tile's rows give the products they feed, and
    every float4 read meets all 8 bank groups in each quarter-warp. Rows
    left unswizzled would put the over-rows read's four rows on one bank
    group pair: 12 extra wavefronts a warp."""
    _check_fragment_reads(np.random.default_rng(15), ld)
    plain = _quarter_conflicts({lane: [2 * t * ld + 4 * g]
                                for lane, g, t in _lanes()})
    assert plain == 12


def _narrow_pad(d):
    """The narrow kernels' padded width: 64 up to D 64, else 128."""
    return 64 if d <= 64 else 128


# rows (keys for K1 and dQ, queries for dK/dV) of a sub-step of the
# narrow kernels' plans (csrc/flash_attention_fwd.cu NarrowFwd64 ..,
# csrc/flash_attention_bwd.cu NarrowDq64 ..: 8 x the n-tiles a sub-step),
# by kernel and padded width
NARROW_SUB = {("fwd", 64): 64, ("fwd", 128): 32, ("dq", 64): 32,
              ("dq", 128): 32, ("dkv", 64): 32, ("dkv", 128): 16}
NARROW_STRUCTS = {"fwd": "Tf32NarrowFwdCfg", "dq": "Tf32NarrowDqCfg",
                  "dkv": "Tf32NarrowDkvCfg"}


def _narrow_plans():
    """The narrow kernels' plans as csrc/flash_attention_fwd.cu and
    csrc/flash_attention_bwd.cu name them: (kernel, DP) -> (rows a stage,
    n-tiles a sub-step)."""
    src = "".join((_CSRC / f"flash_attention_{x}.cu").read_text()
                  for x in ("fwd", "bwd"))
    plans = re.findall(r"using Narrow(Fwd|Dq|Dkv)(64|128) = "
                       r"Tf32Narrow\w+Cfg<\d+, (\d+), (\d+)>;",
                       src)
    return {(k.lower(), int(dp)): (int(rows), int(nb))
            for k, dp, rows, nb in plans}


@pytest.mark.parametrize("kernel,dp,kib", [("fwd", 64, 80), ("fwd", 128, 96),
                                           ("dq", 64, 96), ("dq", 128, 128),
                                           ("dkv", 64, 97),
                                           ("dkv", 128, 96.25)])
def test_tf32x3_narrow_plans_fit_and_match_the_emulation(kernel, dp, kib):
    """The narrow split-TF32 K1, dQ and dK/dV plans, read from the csrc
    text: their shared memory (K1: Q, two stages of K and V; dQ: Q, dO,
    two stages of K and V; dK/dV: K, V, two stages of Q, dO and the lse
    and delta rows) fits the 227 KiB a block may use (two blocks an SM at
    DP 64), and the sub-step the emulations sum by (``NARROW_SUB``) is
    the plan's 8 x its n-tiles."""
    rows, nb = _narrow_plans()[(kernel, dp)]
    smem = _csrc_smem(NARROW_STRUCTS[kernel], DP_=dp, BK_=rows, BQ_=rows,
                      NB_=nb)
    assert smem == kib * 1024 <= tfa.SMEM_PER_BLOCK
    if dp == 64:
        assert 2 * smem <= 228 * 1024
    assert NARROW_SUB[(kernel, dp)] == 8 * nb and rows % (8 * nb) == 0


def _tf32x3_narrow_bwd_emulation(q, k, v, do, lse, delta, scale, causal,
                                 passes=3):
    """``flash_bwd_dq_tf32x3_narrow_kernel``'s and
    ``flash_bwd_dkv_tf32x3_narrow_kernel``'s schedules in torch on f32
    (B, H, T, D), D <= 128, columns zero-padded to 64 or 128; every
    product in split TF32 (P and dS split too). Each warp owns whole rows
    of its outputs, so a row's sum runs in one fixed order: dQ over the
    keys in sub-steps of ``NARROW_SUB`` keys from key 0 (up to the
    diagonal when causal), S = Q·Kᵀ and dP = dO·Vᵀ, P = exp2(S·scale·log2
    e − lse·log2 e) masked, dS = P∘(dP − delta)·scale, and the
    sub-step's dS·K added to dQ; dK/dV over the queries in sub-steps,
    Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, Pᵀ masked, dSᵀ = Pᵀ∘(dPᵀ − delta)·scale,
    the sub-step's Pᵀ·dO and dSᵀ·Q added to dV and dK. (A sub-step that
    causal masking hides from a warp, which the kernels skip, adds exact
    zeros.) Returns dq, dk, dv."""
    b, h, t, d = q.shape
    dp_ = _narrow_pad(d)
    qf, kf, vf, dof = (torch.nn.functional.pad(x, (0, dp_ - d))
                       for x in (q, k, v, do))
    log2e = math.log2(math.e)
    sl2, l2 = scale * log2e, lse * log2e
    zero = torch.zeros(())
    rows = torch.arange(t)

    def mm(a, b_):
        return _mm_tf32(a, b_, passes)

    dq = torch.zeros((b, h, t, dp_))
    sub = NARROW_SUB[("dq", dp_)]
    for j0 in range(0, t, sub):
        js = slice(j0, min(j0 + sub, t))
        idx = torch.arange(js.start, js.stop)
        kt = kf[..., js, :]
        s = mm(qf, kt.transpose(-1, -2))
        dpm = mm(dof, vf[..., js, :].transpose(-1, -2))
        p = torch.exp2(s * sl2 - l2[..., None])
        if causal:
            p = torch.where(idx[None, :] <= rows[:, None], p, zero)
        dq += mm(p * (dpm - delta[..., None]) * scale, kt)
    dk = torch.zeros((b, h, t, dp_))
    dv = torch.zeros((b, h, t, dp_))
    sub = NARROW_SUB[("dkv", dp_)]
    for j0 in range(0, t, sub):
        js = slice(j0, min(j0 + sub, t))
        idx = torch.arange(js.start, js.stop)
        qt, dot = qf[..., js, :], dof[..., js, :]
        pt = torch.exp2(mm(kf, qt.transpose(-1, -2)) * sl2
                        - l2[..., None, js])
        if causal:
            pt = torch.where(idx[None, :] >= rows[:, None], pt, zero)
        dpt = mm(vf, dot.transpose(-1, -2))
        dv += mm(pt, dot)
        dk += mm(pt * (dpt - delta[..., None, js]) * scale, qt)
    return dq[..., :d], dk[..., :d], dv[..., :d]


@pytest.mark.parametrize("d", [12, 64, 80, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_tf32x3_narrow_backward_meets_the_f32_bars(d, causal):
    """The narrow split-TF32 f32 dQ and dK/dV (D <= 128, padded to 64 or
    128), emulated on their own schedules (each row's sum in sub-steps,
    in order), at T 200 (a ragged last tile) and D 12, 64, 80
    and 128: dq, dk and dv within the f32 atol 1e-4 of
    ``flash_attention_bwd_reference`` and of jax.vjp through the JAX
    package's Pallas backward kernels (interpret mode, 40-row blocks), on
    the same numpy-seeded inputs."""
    arrays, (q, k, v, do), lse, delta = _bwd_case(d, causal)
    scale = d ** -0.5
    got = _tf32x3_narrow_bwd_emulation(q, k, v, do, lse, delta, scale,
                                       causal)
    plain = tfa.flash_attention_bwd_reference(q, k, v, do, lse, delta,
                                              scale, causal)
    pallas = _jax_vjp(jfa.flash_attention, arrays[:3],
                      jnp.asarray(arrays[3]), causal=causal, block_q=40,
                      block_k=40, interpret=True)
    for g, p, j in zip(got, plain, pallas):
        assert g.shape == p.shape
        assert (g - p).abs().max().item() <= 1e-4
        np.testing.assert_allclose(g.numpy(), j, rtol=0, atol=1e-4)


@pytest.mark.parametrize("d", [64, 128])
def test_one_tf32_product_misses_the_narrow_backward_bar(d):
    """One TF32 product instead of three (P and dS rounded to one TF32)
    misses the f32 atol 1e-4 at D 64 and 128 as well: the narrow
    backward needs the split."""
    _, (q, k, v, do), lse, delta = _bwd_case(d, True)
    scale = d ** -0.5
    plain = tfa.flash_attention_bwd_reference(q, k, v, do, lse, delta,
                                              scale, True)
    one = _tf32x3_narrow_bwd_emulation(q, k, v, do, lse, delta, scale,
                                       True, passes=1)
    assert max((g - p).abs().max().item() for g, p in zip(one, plain)) \
        > 1e-4


def _tf32x3_narrow_fwd_emulation(q, k, v, scale, causal, passes=3):
    """``flash_fwd_tf32x3_narrow_kernel``'s schedule in torch on f32 (B,
    H, T, D), D <= 128, columns zero-padded to 64 or 128. Each warp owns
    whole query rows, so each row's sum runs in one fixed order: over the
    keys in sub-steps of ``NARROW_SUB`` keys from key 0, S = Q·Kᵀ in split
    TF32 scaled into log2 units and masked; an online softmax a sub-step
    (the running max, corr = exp2(m_old − m_new), the row sum over the f32
    P); P split for P·V, and the sub-step's P·V summed apart and added to
    O·corr in f32; at the end O / l and lse = (m + log2 l)·ln 2. (A
    sub-step that causal masking hides from all of a warp's rows, which
    the kernel skips, changes nothing here: corr 1, P 0.) Returns O and
    the lse."""
    b, h, t, d = q.shape
    dp_ = _narrow_pad(d)
    qf, kf, vf = (torch.nn.functional.pad(x, (0, dp_ - d))
                  for x in (q, k, v))
    sl2 = scale * math.log2(math.e)
    rows = torch.arange(t)
    m = torch.full((b, h, t), -math.inf)
    l = torch.zeros((b, h, t))
    acc = torch.zeros((b, h, t, dp_))
    sub = NARROW_SUB[("fwd", dp_)]
    for j0 in range(0, t, sub):
        js = slice(j0, min(j0 + sub, t))
        idx = torch.arange(js.start, js.stop)
        s = _mm_tf32(qf, kf[..., js, :].transpose(-1, -2), passes) * sl2
        if causal:
            s = torch.where(idx[None, :] <= rows[:, None], s,
                            torch.tensor(-math.inf))
        mn = torch.maximum(m, s.max(-1).values)
        base = torch.where(mn == -math.inf, torch.zeros(()), mn)
        corr = torch.exp2(m - base)
        p = torch.exp2(s - base[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + _mm_tf32(p, vf[..., js, :], passes)
        m = mn
    lt = torch.where(l == 0, torch.ones(()), l)
    return (acc / lt[..., None])[..., :d], (m + torch.log2(lt)) * math.log(2.0)


def _fwd_case(d, t, h, seed=16):
    """Seeded f32 (1, H, T, D) q, k, v as numpy arrays and as tensors."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((1, h, t, d)).astype(np.float32)
              for _ in range(3)]
    return arrays, [_t(a) for a in arrays]


@pytest.mark.parametrize("t,h", [(200, 2), (2048, 1)])
@pytest.mark.parametrize("d", [12, 64, 80, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_tf32x3_narrow_forward_meets_the_f32_bars(d, causal, t, h):
    """The narrow split-TF32 f32 K1 (D <= 128, padded to 64 or 128),
    emulated on its own schedule (each row's sum in sub-steps, in order,
    an online softmax a sub-step, each sub-step's P·V added in f32 after
    the rescale), at D 12, 64, 80 and 128, causal and not, at T 200 (a
    ragged last tile) and at B1 H1 T2048 (the longest sum): O within the
    f32 atol 1e-4 and the lse within 1e-3 of ``mha_reference_lse`` and of
    the JAX package's Pallas forward (interpret mode, 40- and 128-row
    blocks) on the same numpy-seeded inputs."""
    arrays, (q, k, v) = _fwd_case(d, t, h)
    scale = d ** -0.5
    o, lse = _tf32x3_narrow_fwd_emulation(q, k, v, scale, causal)
    ref, ref_lse = tfa.mha_reference_lse(q, k, v, scale, causal)
    assert o.shape == ref.shape and lse.shape == ref_lse.shape
    assert (o - ref).abs().max().item() <= 1e-4
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    blk = 40 if t == 200 else 128
    jo, jlse = jfa.flash_attention_lse(
        *(jnp.asarray(a) for a in arrays), scale=scale, causal=causal,
        block_q=blk, block_k=blk, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=1e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("d", [64, 128])
def test_one_tf32_product_misses_the_narrow_forward_bar(d):
    """One TF32 product instead of three (P rounded to one TF32 too)
    misses the f32 atol 1e-4 on O at D 64 and 128: the narrow K1 needs
    the split."""
    _, (q, k, v) = _fwd_case(d, 200, 2)
    scale = d ** -0.5
    ref, _ = tfa.mha_reference_lse(q, k, v, scale, True)
    one, _ = _tf32x3_narrow_fwd_emulation(q, k, v, scale, True, passes=1)
    assert (one - ref).abs().max().item() > 1e-4


def _quad(vals, op):
    """Each lane's value reduced over its quad (lanes 4g .. 4g + 3, one
    accumulator row) as two xor shuffles, by 1 and by 2, reduce it."""
    for x in (1, 2):
        vals = [op(vals[lane], vals[lane ^ x]) for lane in range(32)]
    return vals


@pytest.mark.parametrize("ld", [64, 128])
def test_tf32x3_narrow_fwd_fragments_read_what_the_products_need(ld):
    """The narrow split-TF32 K1 (f32 D <= 128), one warp's sub-step of 4
    n-tiles lane by lane through the hardware's m16n8k8 layout, from
    swizzled tiles of rows of 64 or 128 floats: S = Q·Kᵀ from the warp's
    rows g and g + 8 (a_frags) and K's rows 8 n + g (mma_dims); each row's
    max and sum over the quad that holds it (lanes 4g .. 4g + 3, xor
    shuffles by 1 and 2) on S's fragments; P's fragments, as they stand,
    as the A operand of P·V over V's rows 8 n + 2t and 8 n + 2t + 1
    (mma_rows_rn); O stored at the columns 32 c + 8 t + 4 e + u
    (store_rows). The warp's O tile and row sums equal exp(S − max)·V and
    its sums computed whole, and every float4 read of Q, K and V meets all
    8 bank groups in each quarter-warp."""
    rng = np.random.default_rng(17)
    nb = 4
    q = rng.integers(-4, 5, (16, ld)).astype(np.float64)
    kt = rng.integers(-4, 5, (8 * nb, ld)).astype(np.float64)
    vt = rng.integers(-4, 5, (8 * nb, ld)).astype(np.float64)

    def phys(a):        # a tile as the loader lays it out
        out = np.zeros(a.size)
        for r in range(a.shape[0]):
            for col in range(ld):
                out[_ld4(r, col // 4, ld)[col % 4]] = a[r, col]
        return out
    pq, pk, pv = phys(q), phys(kt), phys(vt)

    s = [[np.zeros(4) for _ in range(32)] for _ in range(nb)]
    for kp in range(ld // 16):
        reads = {lane: _ld4(g, 4 * kp + t, ld) for lane, g, t in _lanes()}
        reads8 = {lane: _ld4(g + 8, 4 * kp + t, ld)
                  for lane, g, t in _lanes()}
        assert _quarter_conflicts(reads) == _quarter_conflicts(reads8) == 0
        a_regs = [[], []]
        for lane in range(32):
            x, y = pq[reads[lane]], pq[reads8[lane]]
            a_regs[0].append((x[0], y[0], x[1], y[1]))
            a_regs[1].append((x[2], y[2], x[3], y[3]))
        for n in range(nb):
            kr = {lane: _ld4(8 * n + g, 4 * kp + t, ld)
                  for lane, g, t in _lanes()}
            assert _quarter_conflicts(kr) == 0
            zb = [pk[kr[lane]] for lane in range(32)]
            b_regs = [[(z[0], z[1]) for z in zb], [(z[2], z[3]) for z in zb]]
            for st in (0, 1):
                for lane, frag in enumerate(_mma_m16n8k8(a_regs[st],
                                                         b_regs[st])):
                    s[n][lane] += frag
    scale = 1.0 / 16
    p = [[np.zeros(4) for _ in range(32)] for _ in range(nb)]
    sums = []
    for r in (0, 1):
        mx = _quad([max(s[n][lane][2 * r + e] for n in range(nb)
                        for e in (0, 1)) for lane in range(32)], max)
        for n in range(nb):
            for lane in range(32):
                for e in (0, 1):
                    p[n][lane][2 * r + e] = math.exp(
                        (s[n][lane][2 * r + e] - mx[lane]) * scale)
        sums.append(_quad([sum(p[n][lane][2 * r + e] for n in range(nb)
                               for e in (0, 1)) for lane in range(32)],
                          lambda a, b_: a + b_))

    out = np.zeros((16, ld))
    for c in range(ld // 32):
        acc = [[np.zeros(4) for _ in range(32)] for _ in range(4)]
        for n in range(nb):
            xa = [(p[n][lane][0], p[n][lane][2], p[n][lane][1], p[n][lane][3])
                  for lane in range(32)]
            r0 = {lane: _ld4(8 * n + 2 * t, 8 * c + g, ld)
                  for lane, g, t in _lanes()}
            r1 = {lane: _ld4(8 * n + 2 * t + 1, 8 * c + g, ld)
                  for lane, g, t in _lanes()}
            assert _quarter_conflicts(r0) == _quarter_conflicts(r1) == 0
            for u in range(4):
                b_regs = [(pv[r0[lane][u]], pv[r1[lane]][u])
                          for lane in range(32)]
                for lane, frag in enumerate(_mma_m16n8k8(xa, b_regs)):
                    acc[u][lane] += frag
        for u in range(4):
            for lane, g, t in _lanes():
                for i in range(4):
                    out[g + 8 * (i >> 1), 32 * c + 8 * t + 4 * (i & 1) + u] \
                        = acc[u][lane][i]
    sc = q @ kt.T
    pw = np.exp((sc - sc.max(1, keepdims=True)) * scale)
    np.testing.assert_allclose(out, pw @ vt, rtol=1e-12, atol=0)
    for lane, g, t in _lanes():
        for r in (0, 1):
            assert math.isclose(sums[r][lane], pw[g + 8 * r].sum(),
                                rel_tol=1e-12)


def test_f32_k1_runs_split_tf32_at_every_head_dim_up_to_256():
    """f32 K1 takes the split-TF32 family at every D in 1..256, as dQ and
    dK/dV do: no CUDA-core family or counter is left, and a launch of the
    family at D <= 128 counts in K1's narrow counter too, past 128 not."""
    for d in range(1, 257):
        assert tfa.route(d, torch.float32, "fwd") == "tf32x3"
    assert "cuda-core" not in tfa.FAMILY_SUFFIX
    assert not any("CUDA_CORE" in n for n in tfa.COUNTERS)
    narrow = tfa.launch_counter("fwd", "tf32x3", narrow=True)
    assert narrow == "LAUNCHES_TF32X3_NARROW" and narrow in tfa.COUNTERS
    saved = {n: getattr(tfa, n) for n in tfa.COUNTERS}
    try:
        tfa.reset_launches()
        for d in (12, 64, 128, 129, 256):
            tfa._count("fwd", tfa.route(d, torch.float32, "fwd"), d)
        assert (tfa.LAUNCHES, tfa.LAUNCHES_TF32X3,
                tfa.LAUNCHES_TF32X3_NARROW) == (5, 5, 3)
        assert tfa.LAUNCHES_BWD_DQ_TF32X3_NARROW == 0
    finally:
        for n, x in saved.items():
            setattr(tfa, n, x)


# --------------------------------------------- K2 split-K plan (CPU side)

# chip_smoke.py phase 2's slots: (cursor, case), 8 slots, page_len 16,
# 128 table entries, H 8, Dh 64
PHASE2_CASES = [(1023, "mapped"), (700, "partial-tail"), (5, "single-page"),
                (900, "cow-shared"), (0, "empty"), (511, "page-boundary"),
                (512, "page-start"), (333, "sentinel-after-cursor")]


def _phase2_pool(h=8, dh=64, plen=16, per_slot=128, npg=256, seed=0):
    rng = np.random.default_rng(seed)
    k, v = (torch.as_tensor(a) for a in _pool(rng, npg, plen, h, dh))
    q = torch.as_tensor(rng.standard_normal((len(PHASE2_CASES), h, dh))
                        .astype(np.float32))
    perm = rng.permutation(npg)
    table = torch.full((len(PHASE2_CASES), per_slot), npg, dtype=torch.int32)
    pos = torch.tensor([p for p, _ in PHASE2_CASES], dtype=torch.int32)
    nxt = 0
    for s, (p, case) in enumerate(PHASE2_CASES):
        if case == "empty":
            continue                   # every entry stays the sentinel
        need = p // plen + 1           # pages up to the cursor only
        share = 20 if case == "cow-shared" else 0
        table[s, :share] = table[0, :share]
        table[s, share:need] = torch.as_tensor(perm[nxt:nxt + need - share])
        nxt += need - share
    return q, k, v, table, pos


def _split_k_emulation(q, k, v, table, pos, plan):
    """The kernel's two passes in plain torch, f32: pass 1 gives each
    (split, slot, head) the softmax partial (m, l, acc) of the live rows
    of its ``pages_per_split`` logical pages, skipping sentinel pages and
    pages past the cursor (m = -inf, l = 0 where none is live); pass 2
    merges each slot's splits in split order with weights exp(m - max m),
    zeros where no split is live."""
    b, h, dh = q.shape
    npg, plen = k.shape[:2]
    ns, pps = plan.n_splits, plan.pages_per_split
    assert ns * pps >= table.shape[1]
    m = torch.full((ns, b, h), float("-inf"))
    l = torch.zeros((ns, b, h))
    acc = torch.zeros((ns, b, h, dh))
    for s in range(ns):
        for slot in range(b):
            p = int(pos[slot])
            ks, vs = [], []
            for j in range(s * pps, min((s + 1) * pps, table.shape[1])):
                page = int(table[slot, j])
                if j * plen > p or not 0 <= page < npg:
                    continue
                live = min(plen, p - j * plen + 1)
                ks.append(k[page, :live])
                vs.append(v[page, :live])
            if not ks:
                continue
            sc = torch.einsum("hd,nhd->hn", q[slot] / dh ** 0.5,
                              torch.cat(ks))
            m[s, slot] = sc.max(-1).values
            pr = torch.exp(sc - m[s, slot][:, None])
            l[s, slot] = pr.sum(-1)
            acc[s, slot] = torch.einsum("hn,nhd->hd", pr, torch.cat(vs))
    mx = m.max(0).values
    w = torch.where(l > 0, torch.exp(m - mx), torch.zeros(()))
    out = torch.zeros((b, h, dh))
    tot = torch.zeros((b, h))
    for s in range(ns):                # the fixed order of pass 2
        out = out + w[s][..., None] * acc[s]
        tot = tot + w[s] * l[s]
    return torch.where(tot[..., None] > 0,
                       out / tot.clamp_min(1e-30)[..., None],
                       torch.zeros(()))


def test_paged_split_plan_at_the_decode_shapes():
    """The launcher's split: one page a split at the 120M decode shape (8
    slots, 128 entries, H 8, Dh 64, 132 SMs), all heads in one block,
    whole pages a stage in bf16; on a full table at least BLOCKS_PER_SM
    blocks an SM unless a split is already one page; never more than
    MAX_SPLITS splits a slot, and the splits cover the row."""
    plan = tpa.split_plan(8, 8, 64, 2, 16, 128, 132)
    assert plan == tpa.SplitPlan(pages_per_split=1, n_splits=128,
                                 heads_per_block=8, rows_per_stage=16)
    assert tpa.split_plan(8, 8, 64, 4, 16, 128, 132).rows_per_stage == 8
    # Dh 512 (f32): eight heads of one staged row a block, 82048 bytes
    big = tpa.split_plan(8, 8, 512, 4, 16, 128, 132)
    assert (big.heads_per_block, big.rows_per_stage) == (8, 1)
    assert tpa.partial_smem(4, False, 8, 512, 1) == 82048
    for b, h, dh, item, plen, per_slot in (
            (8, 8, 64, 2, 16, 128), (64, 8, 64, 2, 16, 128),
            (1, 8, 64, 2, 16, 4096), (4, 64, 256, 4, 16, 512),
            (2, 3, 20, 2, 5, 7), (32, 32, 128, 2, 256, 64),
            (8, 2, 320, 2, 16, 128), (8, 8, 512, 4, 16, 128),
            (8, 8, 512, 2, 16, 128), (2, 2, tpa.MAX_HEAD_DIM, 4, 16, 8)):
        p = tpa.split_plan(b, h, dh, item, plen, per_slot, 132)
        for vec in (False, True):
            assert tpa.partial_smem(item, vec, p.heads_per_block, dh,
                                    p.rows_per_stage) <= tpa.SMEM_PER_BLOCK
        groups = -(-h // p.heads_per_block)
        assert 1 <= p.n_splits <= tpa.MAX_SPLITS
        assert p.n_splits * p.pages_per_split >= per_slot
        assert (p.n_splits - 1) * p.pages_per_split < per_slot
        assert p.heads_per_block * dh <= max(tpa.BLOCK_ELEMS, dh)
        assert 1 <= p.rows_per_stage <= plen
        assert p.rows_per_stage == 1 or 2 * p.rows_per_stage \
            * p.heads_per_block * dh * item <= tpa.STAGE_BYTES
        assert p.pages_per_split == 1 or p.n_splits == tpa.MAX_SPLITS \
            or b * groups * p.n_splits >= tpa.BLOCKS_PER_SM * 132 // 2


@pytest.mark.parametrize("pages_per_split", [None, 3, 128])
def test_paged_split_k_emulation_matches_reference(pages_per_split):
    """Pass 1 and pass 2 of the split-K kernel, emulated in torch on the
    phase-2 cases (mapped, partial tail, single page, CoW-shared, empty,
    page boundary, page start, sentinel after the cursor) with the
    launcher's plan (and with 3 pages and one split a slot), against the
    gather path at f32 atol 1e-5; the empty slot gives zeros."""
    q, k, v, table, pos = _phase2_pool()
    plan = tpa.split_plan(8, 8, 64, 4, 16, 128, 132)
    if pages_per_split is not None:
        plan = dataclasses.replace(
            plan, pages_per_split=pages_per_split,
            n_splits=-(-128 // pages_per_split))
    got = _split_k_emulation(q, k, v, table, pos, plan)
    ref = tpa.paged_attention_reference(q, k, v, table, pos)
    live = [s for s, (_, c) in enumerate(PHASE2_CASES) if c != "empty"]
    empty = [s for s, (_, c) in enumerate(PHASE2_CASES) if c == "empty"]
    np.testing.assert_allclose(got[live].numpy(), ref[live].numpy(),
                               atol=KERNEL_ATOL, rtol=0)
    assert got[empty].abs().max().item() == 0.0


def test_paged_auto_on_cuda_pool_past_max_head_dim_raises():
    """``auto`` picks the kernel for ANY pool on the card, and the kernel
    refuses a head dim it cannot take: past ``MAX_HEAD_DIM`` (11621, where
    pass 1's block at one head and one staged f32 row overflows the 227
    KiB of shared memory a block may use) a CUDA pool raises, naming the
    limit, rather than running the gather path on the card."""
    assert tpa.MAX_HEAD_DIM == 11621
    assert tpa.partial_smem(4, False, 1, tpa.MAX_HEAD_DIM, 1) \
        <= tpa.SMEM_PER_BLOCK < tpa.partial_smem(4, False, 1,
                                                 tpa.MAX_HEAD_DIM + 1, 1)
    dh = tpa.MAX_HEAD_DIM + 8

    class CudaTyped:                  # a pool tensor's device, without a card
        device = torch.device("cuda")
        shape = (1, 3, 4, 2, dh)

    class Eng:
        paged_kernel_mode = None

    assert tpa.decide(Eng(), {"k": CudaTyped()}, "auto") == "kernel"
    assert tpa.decide(Eng(), {"k": CudaTyped()}) == "kernel"
    q = torch.zeros((1, 2, dh))
    k = torch.zeros((3, 4, 2, dh))
    table = torch.zeros((1, 2), dtype=torch.int32)
    pos = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"head dim 11629 outside "
                                         r"1\.\.11621.*232448 bytes"):
        tpa._paged_attention_cuda(q, k, k.clone(), table, pos)


def test_paged_kernel_refuses_bad_inputs():
    q, k, v, table, pos = _paged_args()
    with pytest.raises(ValueError, match="int32"):
        tpa._paged_attention_cuda(q, k, v, table.long(), pos)
    with pytest.raises(ValueError, match="contiguous"):
        tpa._paged_attention_cuda(q, k.transpose(0, 1), v.transpose(0, 1),
                                  table, pos)
    with pytest.raises(ValueError, match="share"):
        tpa._paged_attention_cuda(q, k, v[:2], table, pos)


def test_nvcc_missing_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_build_dir_is_beside_the_package(monkeypatch, tmp_path):
    monkeypatch.delenv("DL4J_TORCH_BUILD_DIR", raising=False)
    assert _build.build_dir() == (_build.PKG_DIR.parent / "build"
                                  / "dl4j_torch_kernels")
    monkeypatch.setenv("DL4J_TORCH_BUILD_DIR", str(tmp_path))
    assert _build.build_dir() == tmp_path
    assert sorted(p.stem for p in _build.SRC_DIR.glob("*.cu")) == \
        ["flash_attention_bwd", "flash_attention_fwd", "fused_bn_act",
         "fused_lstm", "paged_attention"]


def _fake_sources(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "a.cuh"\n#include <math.h>\n')
    (src / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (src / "b.cuh").write_text("// b\n")
    (src / "other.cuh").write_text("// not included\n")
    monkeypatch.setattr(_build, "SRC_DIR", src)
    monkeypatch.setenv("DL4J_TORCH_BUILD_DIR", str(tmp_path / "build"))
    return src


def test_build_target_covers_included_headers(monkeypatch, tmp_path):
    """The library's name hashes the source AND every csrc header it
    includes, directly or through another header: an edited header is
    never served from a stale build; a header it does not include does
    not move the name."""
    assert [p.name for p in _build._sources("flash_attention_fwd")] == \
        ["flash_attention_fwd.cu", "flash_general.cuh", "flash_mma.cuh",
         "flash_tf32.cuh"]
    assert [p.name for p in _build._sources("flash_attention_bwd")] == \
        ["flash_attention_bwd.cu", "flash_general.cuh", "flash_mma.cuh",
         "flash_tf32.cuh"]
    src = _fake_sources(tmp_path, monkeypatch)
    assert [p.name for p in _build._sources("k")] == \
        ["k.cu", "a.cuh", "b.cuh"]
    first = _build._target("k")
    assert first.parent == tmp_path / "build"
    assert first.name.startswith("k-") and first.suffix == ".so"
    (src / "other.cuh").write_text("// edited, still not included\n")
    assert _build._target("k") == first
    (src / "b.cuh").write_text("// b, edited\n")
    second = _build._target("k")
    assert second != first
    (src / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n// x\n')
    assert _build._target("k") not in (first, second)


def test_nvcc_flags_reach_the_command_and_move_the_target(monkeypatch,
                                                          tmp_path):
    """``NVCC_FLAGS`` stand on every source's nvcc line, before the
    output, and are hashed into the library's name: a changed flag is
    never served from a stale build."""
    _fake_sources(tmp_path, monkeypatch)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc-stub")
    out = tmp_path / "k.so"
    assert _build._nvcc_cmd("k", out) == [
        "nvcc-stub", *_build.NVCC_FLAGS, "-o", str(out),
        str(tmp_path / "csrc" / "k.cu")]
    first = _build._target("k")
    flags = [f for f in _build.NVCC_FLAGS if f != "-lineinfo"]
    monkeypatch.setattr(_build, "NVCC_FLAGS", flags)
    assert _build._nvcc_cmd("k", out) == [
        "nvcc-stub", *flags, "-o", str(out), str(tmp_path / "csrc" / "k.cu")]
    assert _build._target("k") != first


def test_tc_alignment_passes_the_transformers_qkv_views(monkeypatch):
    """The q/k/v the transformer hands the flash kernel (views of one
    (B, T, 3·H·D) bf16 buffer at whole-head offsets, time stride 3·H·D)
    pass the tensor-core kernels' alignment check, at every head dim;
    a view one element off, or with an odd time stride, fails it."""
    from deeplearning4j_tpu_torch.zoo import transformer as ttfm
    seen = []
    ntc = tfa.flash_attention_ntc

    def spy(q, k, v, causal=False, scale=None):
        seen.append((q, k, v))
        return ntc(q, k, v, causal, scale)

    monkeypatch.setattr(tfa, "flash_attention_ntc", spy)
    dims = (8, 16, 24, 32, 64, 80, 120, 128)
    for d in dims:
        cfg = ttfm.TransformerConfig(vocab_size=64, d_model=2 * d, n_heads=2,
                                     n_layers=1, d_ff=64, max_seq=24,
                                     dtype=torch.bfloat16,
                                     use_flash_attention=True)
        params = ttfm.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
        ids = torch.as_tensor(np.arange(24).reshape(2, 12) % 64)
        ttfm.forward(params, cfg, ids)
    assert len(seen) == len(dims)
    for q, k, v in seen:
        assert q.dtype == torch.bfloat16 and q.stride(1) == 3 * q.shape[2] \
            * q.shape[3]
        for x in (q, k, v):
            assert tfa.tc_aligned(x) and tfa.tc_aligned(x.transpose(1, 2))
        tfa.check_tc_alignment(q=q, k=k, v=v)
    b, t, h, d = 2, 12, 2, 16
    buf = torch.zeros((b, t, 3 * h * d + 8), dtype=torch.bfloat16)
    ok = buf[..., 8:8 + h * d].reshape(b, t, h, d)          # 16 bytes in
    off = buf[..., 1:1 + h * d].reshape(b, t, h, d)         # 2 bytes in
    assert tfa.tc_aligned(ok) and not tfa.tc_aligned(off)
    odd = torch.zeros((b, t, 3 * h * d + 1), dtype=torch.bfloat16)
    odd_t = odd[..., :h * d].reshape(b, t, h, d)            # stride 97
    assert odd_t.data_ptr() % 16 == 0 and not tfa.tc_aligned(odd_t)
    with pytest.raises(ValueError, match="k .*16-byte aligned"):
        tfa.check_tc_alignment(q=ok, k=off, v=ok)
    with pytest.raises(ValueError, match="v .*16-byte aligned"):
        tfa.check_tc_alignment(q=ok, k=ok, v=odd_t)


def test_bf16_kernels_refuse_misaligned_views_before_loading():
    """K1's and dK/dV's bf16 wrappers raise ValueError on a misaligned
    operand before they build or launch anything (no card needed to
    reach the check); the counts do not move. f32 keeps taking any
    strides (it reaches the build, which needs a card)."""
    b, t, h, d = 1, 8, 2, 16
    counts = (tfa.LAUNCHES, tfa.LAUNCHES_TC, tfa.LAUNCHES_BWD_DKV,
              tfa.LAUNCHES_BWD_DKV_TC)
    buf = torch.zeros((b, t, 3 * h * d + 1), dtype=torch.bfloat16)
    q, k, v = (buf[..., 1 + i * h * d:1 + (i + 1) * h * d]
               .reshape(b, t, h, d) for i in range(3))
    with pytest.raises(ValueError, match="aligned"):
        tfa._flash_cuda(q, k, v, 0.25, True, "bthd")
    meta = buf.to("meta")
    mq, mk, mv = (meta[..., 1 + i * h * d:1 + (i + 1) * h * d]
                  .reshape(b, t, h, d) for i in range(3))
    lse = torch.zeros((b, h, t), device="meta")
    with pytest.raises(ValueError, match="aligned"):
        tfa.flash_attention_bwd_dkv(mq, mk, mv, mq, lse, lse, 0.25, True,
                                    "bthd")
    assert (tfa.LAUNCHES, tfa.LAUNCHES_TC, tfa.LAUNCHES_BWD_DKV,
            tfa.LAUNCHES_BWD_DKV_TC) == counts
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tfa._flash_cuda(q.float(), k.float(), v.float(), 0.25, True,
                            "bthd")
