"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided inside
the test, never at import). On a machine with one:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the repository's conftest imports jax, which the
port's machines need not have.)

Tolerances: bf16 outputs atol 2e-2 (one bf16 rounding of values of
order 1), f32 atol 1e-4 (f32 accumulation order), lse atol 1e-3. The
backward's bf16 gradients are held to a relative L2 error of 1e-2: the
kernels and the plain backward round dS and P to bf16 at the same points,
but a product that lands near a rounding boundary flips one ulp. The
fused BN kernels (K3): outputs as above; their f32 per-channel sums are
held to a relative 1e-5 elementwise, or 1e-4 of the largest sum (the
same terms summed in another order), the stats kernel's fused mean, var
and inv to a relative 1e-6 of the plain versions on the same sums, and
both reductions must repeat bit for bit from launch to launch (no
atomics on the sums; a fixed-order last-block finish). The LSTM
kernel (K4), both routes: f32 atol 1e-5 against its plain version; bf16
atol 2e-2 — the kernels keep h and c in f32 over all T steps while the
plain version rounds both to bf16 at every step, so they part by a few
bf16 ulps (5.9e-3 measured at B256 T60 H256, ``chip_smoke.py`` phase 9).
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch
from torch_sd_cases import BP_CASES, CASES

from deeplearning4j_tpu_torch.kernels import flash_attention as fa
from deeplearning4j_tpu_torch.kernels import fused_lstm as fl
from deeplearning4j_tpu_torch.kernels import fused_ops as fo
from deeplearning4j_tpu_torch.kernels import paged_attention as pa

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

ATOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh,plen", [(64, 16), (128, 8), (16, 4), (80, 16),
                                     (256, 16), (20, 6), (320, 16),
                                     (512, 8)])
def test_paged_kernel_matches_plain(gen, dtype, dh, plen):
    b, h, per_slot = 4, 2, 6
    npg = b * per_slot
    k = torch.randn((npg, plen, h, dh), generator=gen, device="cuda") \
        .to(dtype)
    v = torch.randn_like(k)
    q = torch.randn((b, h, dh), generator=gen, device="cuda").to(dtype)
    table = torch.full((b, per_slot), npg, dtype=torch.int32)
    pos = torch.tensor([per_slot * plen - 1, plen // 2, 2 * plen, 0],
                       dtype=torch.int32)
    perm = torch.randperm(npg)
    for s in range(3):
        need = int(pos[s]) // plen + 1
        table[s, :need] = perm[s * per_slot:s * per_slot + need].int()
    table[2, 0] = table[0, 0]                 # a shared (CoW) page
    table, pos = table.cuda(), pos.cuda()
    before = pa.LAUNCHES
    out = pa.paged_attention(q, k, v, table, pos)
    ref = pa.paged_attention_reference(q, k, v, table, pos)
    torch.cuda.synchronize()
    assert pa.LAUNCHES == before + 1
    torch.testing.assert_close(out[:3].float(), ref[:3].float(),
                               atol=ATOL[dtype], rtol=0)
    assert out[3].abs().max().item() == 0.0   # empty slot → zeros
    assert torch.equal(out, pa.paged_attention(q, k, v, table, pos))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", [64, 80, 128, 256, 320, 512])
def test_paged_split_k_long_contexts(gen, dtype, dh):
    """Split-K at contexts up to 2048 (many splits a slot, several pages
    a split on the wide tables), CoW-shared pages, a slot with no live
    row, against the gather path; a second launch is bit-identical."""
    b, h, plen, per_slot = 6, 4, 16, 160
    npg = b * per_slot
    k = torch.randn((npg, plen, h, dh), generator=gen, device="cuda") \
        .to(dtype)
    v = torch.randn_like(k)
    q = torch.randn((b, h, dh), generator=gen, device="cuda").to(dtype)
    pos = torch.tensor([2047, 1500, 16, 0, 999, 2559], dtype=torch.int32)
    table = torch.full((b, per_slot), npg, dtype=torch.int32)
    perm = torch.randperm(npg)
    for s in (0, 1, 2, 4, 5):
        need = int(pos[s]) // plen + 1
        table[s, :need] = perm[s * per_slot:s * per_slot + need].int()
    table[4, :30] = table[0, :30]             # CoW-shared with slot 0
    table, pos = table.cuda(), pos.cuda()
    plan = pa.split_plan(b, h, dh, k.element_size(), plen, per_slot,
                         torch.cuda.get_device_properties(0)
                         .multi_processor_count)
    assert plan.n_splits > 1
    out = pa.paged_attention(q, k, v, table, pos)
    ref = pa.paged_attention_reference(q, k, v, table, pos)
    again = pa.paged_attention(q, k, v, table, pos)
    torch.cuda.synchronize()
    live = [0, 1, 2, 4, 5]
    torch.testing.assert_close(out[live].float(), ref[live].float(),
                               atol=ATOL[dtype], rtol=0)
    assert out[3].abs().max().item() == 0.0
    assert torch.equal(out, again)


FLASH_GRID = [(64, True), (200, True), (1000, True), (256, False),
              (200, False), (1000, False)]


# the instantiated widths and head dims padded to them inside the kernels
HEAD_DIMS = [8, 16, 24, 32, 64, 80, 120, 128]
# head dims past 128: bf16 K1, dQ and dK/dV on the tensor cores padded to
# 256 (136, 160, 200, 256), f32 K1, dQ and dK/dV in split TF32 padded to
# 256 (130: rows of whole elements, not 16-byte chunks; 136-256); at 320
# all three on their wide kernels (bf16 padded to 384, f32 to 320); every
# kernel general past 512 (520) and for bf16 rows that are not whole
# 16-byte chunks (12, 130; f32 runs the narrow split-TF32 kernel at 12)
GENERAL_HEAD_DIMS = [12, 130, 136, 160, 200, 256, 320, 520]
# the wide kernels of K1, dQ and dK/dV: bf16 padded to 384 (264, 320, 328,
# 384) and to 512 (392, 512); f32 to 320 (264, 320), 384 (328, 384) and
# 512 (392, 512)
WIDE_HEAD_DIMS = [264, 320, 328, 384, 392, 512]


def _counts(kernel):
    """``kernel``'s ("fwd", "dq", "dkv") launch counters: its total, then
    one per kernel family."""
    return [getattr(fa, fa.launch_counter(kernel))] + [
        getattr(fa, fa.launch_counter(kernel, f), 0)
        for f in fa.FAMILY_SUFFIX]


def _added(kernel, d, dtype):
    """What one call of ``kernel`` at (d, dtype) adds to :func:`_counts`:
    one launch, on the family ``fa.route`` names."""
    kind = fa.route(d, dtype, kernel)
    return [1] + [int(f == kind) for f in fa.FAMILY_SUFFIX]


def _moved(before, kernel, d, dtype):
    return [a - b for a, b in zip(_counts(kernel), before)] \
        == _added(kernel, d, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,causal", FLASH_GRID)
@pytest.mark.parametrize("d", HEAD_DIMS + GENERAL_HEAD_DIMS)
def test_flash_kernel_matches_plain(gen, dtype, t, causal, d):
    """K1 (the tensor-core kernel in bf16 up to 256, the narrow split-TF32
    one in f32 up to 128, the split-TF32 one in f32 at 129-256, the general
    kernel past them and for bf16 rows of odd chunks) at every head dim,
    in the (B, H, T, D) layout and through strided (B, T, H, D) views of
    one qkv buffer; a second launch repeats the first bit for bit; the
    counters name the kernel that ran."""
    b, h = 2, 3
    q, k, v = (torch.randn((b, h, t, d), generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    before = _counts("fwd")
    out, lse = fa.flash_attention_lse(q, k, v, causal=causal)
    assert _moved(before, "fwd", d, dtype)
    ref, ref_lse = fa.mha_reference_lse(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL[dtype],
                               rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    again, lse_again = fa.flash_attention_lse(q, k, v, causal=causal)
    assert torch.equal(out, again) and torch.equal(lse, lse_again)
    qkv = torch.cat([x.transpose(1, 2).reshape(b, t, h * d)
                     for x in (q, k, v)], dim=-1)
    qn, kn, vn = (x.reshape(b, t, h, d) for x in qkv.chunk(3, dim=-1))
    ntc = fa.flash_attention_ntc(qn, kn, vn, causal=causal)
    torch.testing.assert_close(ntc.transpose(1, 2).float(), ref.float(),
                               atol=ATOL[dtype], rtol=0)


def test_flash_d256_fwd_matches_plain_over_many_waves(gen):
    """K1 at padded D 256 (one 161 KiB block an SM) on a grid of 512
    query tiles, several waves of the SMs, causal, T 1000 (a ragged last
    tile), against the plain version; counted as a tensor-core launch."""
    b, h, t, d = 8, 4, 1000, 200
    q, k, v = (torch.randn((b, h, t, d), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    before = fa.LAUNCHES_TC
    out, lse = fa.flash_attention_lse(q, k, v, causal=True)
    assert fa.LAUNCHES_TC == before + 1
    ref, ref_lse = fa.mha_reference_lse(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


def test_flash_tf32x3_fwd_matches_plain_over_many_waves(gen):
    """f32 K1 in split TF32 (one 201 KiB block an SM) on a grid of 512
    query tiles, several waves of the SMs, causal, T 1000 (a ragged last
    tile), D 200, against the plain version at the f32 bars; counted as a
    split-TF32 launch."""
    b, h, t, d = 8, 4, 1000, 200
    q, k, v = (torch.randn((b, h, t, d), generator=gen, device="cuda")
               for _ in range(3))
    before = fa.LAUNCHES_TF32X3
    out, lse = fa.flash_attention_lse(q, k, v, causal=True)
    assert fa.LAUNCHES_TF32X3 == before + 1
    ref, ref_lse = fa.mha_reference_lse(q, k, v, causal=True)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,causal", [(200, True), (200, False),
                                      (1000, True)])
@pytest.mark.parametrize("d", WIDE_HEAD_DIMS)
def test_flash_wide_fwd_matches_plain(gen, dtype, t, causal, d):
    """K1's wide kernels at D 264-512 (bf16 on two warpgroups that split
    O's columns, f32 in split TF32 on pairs of warps that split them),
    padded to 384 and 512 (f32 also 320), T 200 (a ragged last tile) and 1000, against
    the plain version: O at the dtype's atol, lse at 1e-3; counted on
    the wide family and nowhere else; through strided (B, T, H, D) views
    of one qkv buffer (the transformer's layout); a second launch, in
    either layout, repeats the first bit for bit."""
    b, h = 2, 3
    q, k, v = (torch.randn((b, h, t, d), generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    kind = "wgmma-wide" if dtype == torch.bfloat16 else "tf32x3-wide"
    assert fa.route(d, dtype, "fwd") == kind
    before = _counts("fwd")
    out, lse = fa.flash_attention_lse(q, k, v, causal=causal)
    assert _moved(before, "fwd", d, dtype)
    ref, ref_lse = fa.mha_reference_lse(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL[dtype],
                               rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    again, lse_again = fa.flash_attention_lse(q, k, v, causal=causal)
    assert torch.equal(out, again) and torch.equal(lse, lse_again)
    qkv = torch.cat([x.transpose(1, 2).reshape(b, t, h * d)
                     for x in (q, k, v)], dim=-1)
    qn, kn, vn = (x.reshape(b, t, h, d) for x in qkv.chunk(3, dim=-1))
    before = _counts("fwd")
    ntc = fa.flash_attention_ntc(qn, kn, vn, causal=causal)
    assert _moved(before, "fwd", d, dtype)
    torch.testing.assert_close(ntc.transpose(1, 2).float(), ref.float(),
                               atol=ATOL[dtype], rtol=0)
    assert torch.equal(ntc, fa.flash_attention_ntc(qn, kn, vn,
                                                   causal=causal))


def test_flash_wide_fwd_over_many_waves(gen):
    """Both wide kernels on grids of several waves of the SMs (B8 H4
    T1000 D320, causal: 512 query tiles of 64 rows), against the plain
    version; the bf16 one from a time stride of 3·H·D (the transformer's
    qkv buffer), the f32 one from a view whose rows are not 16-byte
    chunks (element-wise copies)."""
    b, h, t, d = 8, 4, 1000, 320
    qkv = torch.randn((b, t, 3 * h * d), generator=gen, device="cuda")
    for dtype, off, dd in ((torch.bfloat16, 0, d), (torch.float32, 1, 318)):
        x = qkv.to(dtype)
        q, k, v = (x[..., off + i * h * dd:off + (i + 1) * h * dd]
                   .reshape(b, t, h, dd) for i in range(3))
        before = _counts("fwd")
        out = fa.flash_attention_ntc(q, k, v, causal=True)
        assert _moved(before, "fwd", dd, dtype)
        ref = fa.mha_reference(*(y.transpose(1, 2) for y in (q, k, v)),
                               causal=True)
        torch.testing.assert_close(out.transpose(1, 2).float(), ref.float(),
                                   atol=ATOL[dtype], rtol=0)


def test_flash_wide_bf16_refuses_misaligned_views(gen):
    """The bf16 wide K1 copies 16-byte chunks: a view that starts off a
    16-byte boundary raises before any launch."""
    b, t, h, d = 1, 70, 2, 320
    raw = torch.randn((b, t, 3 * h * d + 1), generator=gen,
                      device="cuda").to(torch.bfloat16)
    odd = [raw[..., 1 + i * h * d:1 + (i + 1) * h * d].reshape(b, t, h, d)
           for i in range(3)]
    before = _counts("fwd")
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_ntc(*odd, causal=True)
    assert _counts("fwd") == before


def test_flash_tf32x3_bwd_matches_plain_over_many_waves(gen):
    """f32 dQ and dK/dV in split TF32 (192 and 196.5 KiB, one block an
    SM) on grids of 1024 query or key tiles, several waves of the SMs,
    causal, T 1000 (a ragged last tile), D 200, against the plain backward
    at the f32 bar; counted as split-TF32 launches; a second launch
    repeats the first bit for bit."""
    b, h, t, d = 8, 4, 1000, 200
    scale = d ** -0.5
    q, k, v, do = (torch.randn((b, h, t, d), generator=gen, device="cuda")
                   for _ in range(4))
    o, lse = fa.mha_reference_lse(q, k, v, causal=True)
    delta = (do * o).sum(-1).contiguous()
    ref = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, scale,
                                           True)
    before = (fa.LAUNCHES_BWD_DQ_TF32X3, fa.LAUNCHES_BWD_DKV_TF32X3)
    runs = [(fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, True),
             *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale,
                                         True)) for _ in range(2)]
    assert (fa.LAUNCHES_BWD_DQ_TF32X3, fa.LAUNCHES_BWD_DKV_TF32X3) == \
        (before[0] + 2, before[1] + 2)
    torch.cuda.synchronize()
    for got, again, want in zip(*runs, ref):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
        assert torch.equal(got, again)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [1, 63, 200, 2048])
@pytest.mark.parametrize("d", [16, 64, 80, 128])
def test_flash_tf32x3_narrow_bwd_matches_plain(gen, d, t, causal, aligned):
    """f32 dQ and dK/dV at D <= 128 in split TF32 (the narrow kernels,
    padded to 64 or 128) on strided (B, T, H, D) views of one qkv buffer,
    16-byte aligned rows (16-byte copies) or a buffer one float in (4-byte
    copies), T 1, 63, 200 (ragged tiles) and 2048, causal and not: within
    the f32 atol 1e-4 of the plain backward, counted as split-TF32
    launches of the narrow kernels (no other family's counter moves), and
    a second launch repeats the first bit for bit."""
    b, h = (1, 2) if t == 2048 else (2, 3)
    scale = d ** -0.5
    off = 0 if aligned else 1
    raw = torch.randn((b, t, 3 * h * d + off), generator=gen, device="cuda")
    q, k, v = (raw[..., off + i * h * d:off + (i + 1) * h * d]
               .reshape(b, t, h, d) for i in range(3))
    do = torch.randn((b, t, h, d), generator=gen, device="cuda")
    qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do))
    o, lse = fa.mha_reference_lse(qh, kh, vh, causal=causal)
    delta = (doh * o).sum(-1).contiguous()
    ref = fa.flash_attention_bwd_reference(qh, kh, vh, doh, lse, delta,
                                           scale, causal)
    assert fa.route(d, torch.float32, "dq") == "tf32x3"
    assert fa.route(d, torch.float32, "dkv") == "tf32x3"
    narrow = [fa.launch_counter(kn, "tf32x3", narrow=True)
              for kn in ("dq", "dkv")]
    before = _counts("dq"), _counts("dkv")
    narrow_before = [getattr(fa, n) for n in narrow]
    runs = [(fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale,
                                       causal, "bthd"),
             *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale,
                                         causal, "bthd")) for _ in range(2)]
    torch.cuda.synchronize()
    for kernel, was in zip(("dq", "dkv"), before):
        moved = [a - b_ for a, b_ in zip(_counts(kernel), was)]
        assert moved == [2 * x for x in _added(kernel, d, torch.float32)]
    assert [getattr(fa, n) - b_ for n, b_ in zip(narrow, narrow_before)] \
        == [2, 2]
    for got, again, want in zip(*runs, ref):
        torch.testing.assert_close(got.transpose(1, 2), want, atol=1e-4,
                                   rtol=0)
        assert torch.equal(got, again)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [1, 63, 200, 2048])
@pytest.mark.parametrize("d", [16, 64, 80, 128])
def test_flash_tf32x3_narrow_fwd_matches_plain(gen, d, t, causal, aligned):
    """f32 K1 at D <= 128 in split TF32 (the narrow kernel, padded to 64
    or 128) on strided (B, T, H, D) views of one qkv buffer, 16-byte
    aligned rows (16-byte copies) or a buffer one float in (4-byte
    copies), T 1, 63, 200 (ragged tiles) and 2048, causal and not: O
    within the f32 atol 1e-4 and the lse within 1e-3 of the plain
    version, counted as a split-TF32 launch of the narrow kernel (no other
    family's counter moves), and a second launch repeats the first bit
    for bit."""
    b, h = (1, 2) if t == 2048 else (2, 3)
    off = 0 if aligned else 1
    raw = torch.randn((b, t, 3 * h * d + off), generator=gen, device="cuda")
    qkv = [raw[..., off + i * h * d:off + (i + 1) * h * d]
           .reshape(b, t, h, d).transpose(1, 2) for i in range(3)]
    ref, ref_lse = fa.mha_reference_lse(*qkv, causal=causal)
    assert fa.route(d, torch.float32, "fwd") == "tf32x3"
    narrow = fa.launch_counter("fwd", "tf32x3", narrow=True)
    before, narrow_before = _counts("fwd"), getattr(fa, narrow)
    runs = [fa.flash_attention_lse(*qkv, causal=causal) for _ in range(2)]
    torch.cuda.synchronize()
    moved = [a - b_ for a, b_ in zip(_counts("fwd"), before)]
    assert moved == [2 * x for x in _added("fwd", d, torch.float32)]
    assert getattr(fa, narrow) - narrow_before == 2
    (out, lse), (again, lse_again) = runs
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    assert torch.equal(out, again) and torch.equal(lse, lse_again)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,causal", [(200, True), (200, False),
                                      (1000, True)])
@pytest.mark.parametrize("d", WIDE_HEAD_DIMS)
def test_flash_wide_bwd_matches_plain(gen, dtype, t, causal, d):
    """dQ and dK/dV past D 256 (bf16: dQ on two warpgroups that split its
    columns, dK/dV on a cluster of two CTAs whose four warpgroups each
    own a quarter of the columns; f32: both in split TF32 on a cluster of
    two CTAs that split every operand's columns), padded to 384 and 512
    (f32 also 320), T 200 (a ragged last tile) and 1000, against the
    plain backward: counted on the wide family and nowhere else; through
    strided (B, T, H, D) views of one qkv buffer too; a second launch
    repeats the first bit for bit."""
    b, h = 2, 3
    scale = d ** -0.5
    kind = "wgmma-wide" if dtype == torch.bfloat16 else "tf32x3-wide"
    assert fa.route(d, dtype, "dq") == fa.route(d, dtype, "dkv") == kind
    q, k, v, do = (torch.randn((b, h, t, d), generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    _, lse = fa.mha_reference_lse(q, k, v, causal=causal)
    delta = torch.randn((b, h, t), generator=gen, device="cuda")
    ref = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, scale,
                                           causal)
    before = _counts("dq"), _counts("dkv")
    runs = [(fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale,
                                       causal),
             *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale,
                                         causal)) for _ in range(2)]
    assert [a - b_ for a, b_ in zip(_counts("dq"), before[0])] \
        == [2 * x for x in _added("dq", d, dtype)]
    assert [a - b_ for a, b_ in zip(_counts("dkv"), before[1])] \
        == [2 * x for x in _added("dkv", d, dtype)]
    torch.cuda.synchronize()
    for got, again, want in zip(*runs, ref):
        _close(got, want, dtype)
        assert torch.equal(got, again)
    qkv = torch.cat([x.transpose(1, 2).reshape(b, t, h * d)
                     for x in (q, k, v)], dim=-1)
    qn, kn, vn = (x.reshape(b, t, h, d) for x in qkv.chunk(3, dim=-1))
    got = fa.flash_attention_bwd(qn, kn, vn, do.transpose(1, 2), lse, delta,
                                 scale, causal, layout="bthd")
    torch.cuda.synchronize()
    for g, want in zip(got, ref):
        _close(g.transpose(1, 2), want, dtype)


def test_flash_wide_bwd_over_many_waves(gen):
    """The wide dQ and dK/dV on grids of several waves of the SMs (B8 H4
    T1000 D320, causal), against the plain backward: bf16 from a time
    stride of 3·H·D (the transformer's qkv buffer), f32 from views whose
    rows are not 16-byte chunks (D 318: element-wise copies); the
    autograd Function's grads against autograd through the plain
    forward."""
    b, h, t = 8, 4, 1000
    for dtype, off, d in ((torch.bfloat16, 0, 320), (torch.float32, 1, 318)):
        raw = torch.randn((b, t, off + 3 * h * d), generator=gen,
                          device="cuda").to(dtype)
        x = raw[..., off:].detach().requires_grad_(True)
        q, k, v = (x[..., i * h * d:(i + 1) * h * d].reshape(b, t, h, d)
                   for i in range(3))
        do = torch.randn((b, t, h, d), generator=gen, device="cuda") \
            .to(dtype)
        before = _counts("dq"), _counts("dkv")
        (g_fn,) = torch.autograd.grad(
            fa.flash_attention_ntc(q, k, v, causal=True), x, do)
        assert _moved(before[0], "dq", d, dtype) \
            and _moved(before[1], "dkv", d, dtype)
        ref = fa.mha_reference(*(y.transpose(1, 2) for y in (q, k, v)),
                               causal=True)
        (g_ref,) = torch.autograd.grad(ref, x, do.transpose(1, 2))
        _close(g_fn, g_ref, dtype)


def test_flash_misaligned_bf16_views_raise_before_launch(gen):
    """A bf16 view that starts off a 16-byte boundary (or has a time
    stride of an odd number of elements) raises in K1, in dQ and in
    dK/dV, and nothing is launched; the f32 kernels (split TF32) take
    it."""
    b, t, h, d = 1, 70, 2, 16
    buf = torch.randn((b, t, 3 * h * d + 1), generator=gen, device="cuda")
    views = [buf[..., 1 + i * h * d:1 + (i + 1) * h * d].reshape(b, t, h, d)
             for i in range(3)]
    bf = [x.to(torch.bfloat16) for x in views]          # contiguous copies
    raw = buf.to(torch.bfloat16)
    odd = [raw[..., 1 + i * h * d:1 + (i + 1) * h * d].reshape(b, t, h, d)
           for i in range(3)]
    lse = torch.zeros((b, h, t), device="cuda")
    counts = (fa.LAUNCHES, fa.LAUNCHES_TC, fa.LAUNCHES_BWD_DQ,
              fa.LAUNCHES_BWD_DQ_TC, fa.LAUNCHES_BWD_DKV,
              fa.LAUNCHES_BWD_DKV_TC)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_ntc(*odd, causal=True)
    for bwd in (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
        with pytest.raises(ValueError, match="aligned"):
            bwd(*odd, bf[0], lse, lse, 0.25, True, "bthd")
        with pytest.raises(ValueError, match="dout .*aligned"):
            bwd(*bf, odd[0], lse, lse, 0.25, True, "bthd")
    assert (fa.LAUNCHES, fa.LAUNCHES_TC, fa.LAUNCHES_BWD_DQ,
            fa.LAUNCHES_BWD_DQ_TC, fa.LAUNCHES_BWD_DKV,
            fa.LAUNCHES_BWD_DKV_TC) == counts
    out = fa.flash_attention_ntc(*views, causal=True)   # f32: any strides
    ref = fa.mha_reference(*(x.transpose(1, 2) for x in views), causal=True)
    torch.testing.assert_close(out.transpose(1, 2), ref, atol=1e-4, rtol=0)
    assert fa.LAUNCHES == counts[0] + 1


def _rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _close(got, ref, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)
    else:
        assert got.dtype == dtype
        assert _rel_l2(got, ref) <= 1e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,causal", FLASH_GRID)
@pytest.mark.parametrize("d", HEAD_DIMS + GENERAL_HEAD_DIMS)
def test_flash_bwd_kernels_match_plain(gen, dtype, t, causal, d):
    """dQ and dK/dV (on the tensor cores in bf16 up to 256, each on two
    warpgroups that split the columns past 128; f32 in split TF32, on
    the narrow kernels up to 128 and padded to 256 at 129-256; the wide
    kernels at
    257-512; the general kernels past them) against the plain
    backward on the same inputs, in the (B, H, T, D) layout and through
    strided (B, T, H, D) views of one qkv buffer (the transformer's
    layout); a second launch of each repeats the first bit for bit; the
    counters name the kernel that ran."""
    b, h = 2, 3
    scale = d ** -0.5
    q, k, v, do = (torch.randn((b, h, t, d), generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    _, lse = fa.mha_reference_lse(q, k, v, causal=causal)
    delta = torch.randn((b, h, t), generator=gen, device="cuda")
    ref = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, scale,
                                           causal)
    before = _counts("dq"), _counts("dkv")
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, causal)
    assert _moved(before[0], "dq", d, dtype) and _counts("dkv") == before[1]
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale,
                                        causal)
    assert _moved(before[0], "dq", d, dtype) \
        and _moved(before[1], "dkv", d, dtype)
    torch.cuda.synchronize()
    for got, want in zip((dq, dk, dv), ref):
        _close(got, want, dtype)
    dq2 = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, causal)
    dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale,
                                          causal)
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) \
        and torch.equal(dv, dv2)
    qkv = torch.cat([x.transpose(1, 2).reshape(b, t, h * d)
                     for x in (q, k, v)], dim=-1)
    qn, kn, vn = (x.reshape(b, t, h, d) for x in qkv.chunk(3, dim=-1))
    don = do.transpose(1, 2)                  # a non-contiguous view
    got = fa.flash_attention_bwd(qn, kn, vn, don, lse, delta, scale, causal,
                                 layout="bthd")
    torch.cuda.synchronize()
    for g, want in zip(got, ref):
        assert g.shape == (b, t, h, d)
        _close(g.transpose(1, 2), want, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_function_grads_match_autograd_reference(gen, dtype, causal):
    """The autograd Function (K1 forward, dQ and dK/dV backward) through
    the strided (B, T, H, D) views, against autograd of mha_reference;
    the lse variant with a nonzero lse cotangent too."""
    b, t, h, d = 2, 200, 2, 64
    qkv = torch.randn((b, t, 3 * h * d), generator=gen, device="cuda") \
        .to(dtype).requires_grad_(True)
    do = torch.randn((b, t, h, d), generator=gen, device="cuda").to(dtype)
    counts = (fa.LAUNCHES, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKV)
    qn, kn, vn = (x.reshape(b, t, h, d) for x in qkv.chunk(3, dim=-1))
    out = fa.flash_attention_ntc(qn, kn, vn, causal=causal)
    (g,) = torch.autograd.grad(out, qkv, do)
    assert (fa.LAUNCHES, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKV) == \
        tuple(c + 1 for c in counts)
    ref_out = fa.mha_reference(*(x.transpose(1, 2) for x in (qn, kn, vn)),
                               causal=causal).transpose(1, 2)
    (ref_g,) = torch.autograd.grad(ref_out, qkv, do)
    torch.cuda.synchronize()
    _close(g, ref_g, dtype)

    q, k, v = (x.transpose(1, 2).detach().requires_grad_(True)
               for x in (qn, kn, vn))
    dl = torch.randn((b, h, t), generator=gen, device="cuda")
    o, lse = fa.flash_attention_lse(q, k, v, causal=causal)
    got = torch.autograd.grad((o, lse), (q, k, v), (do.transpose(1, 2), dl))
    ro, rl = fa.mha_reference_lse(q, k, v, causal=causal)
    want = torch.autograd.grad((ro, rl), (q, k, v), (do.transpose(1, 2), dl))
    for a, w in zip(got, want):
        _close(a, w, dtype)


def test_head_dim_80_lm_train_step_matches_plain_path(gen):
    """A bf16 LM with head dim 80 (d_model 640, 8 heads), which raised on
    the card before the kernels zero-padded D: one train step's grads on
    the flash kernels (K1, dQ and dK/dV, all on the tensor cores) agree
    with the plain path's (plain attention, f32 scores) from the same
    params, relative L2 <= 2e-2 per leaf (chip_smoke.py phase 6's
    bar)."""
    import dataclasses

    import numpy as np

    from deeplearning4j_tpu_torch.zoo import transformer as tfm
    cfg = tfm.TransformerConfig(vocab_size=512, d_model=640, n_heads=8,
                                n_layers=2, d_ff=1024, max_seq=256,
                                dtype=torch.bfloat16, remat=False,
                                use_flash_attention=True)
    plain = dataclasses.replace(cfg, use_flash_attention=False,
                                attn_scores_bf16=False)
    assert cfg.head_dim == 80
    init = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    ids, tgt = (torch.as_tensor(rng.integers(0, 512, (4, 256)),
                                device="cuda") for _ in range(2))
    grads = {}
    for name, c in (("kernel", cfg), ("plain", plain)):
        params = {k: (v.clone() if torch.is_tensor(v)
                      else {n: w.clone() for n, w in v.items()})
                  for k, v in init.items()}
        leaves = tfm.param_leaves(params)
        fa.reset_launches()
        tfm.lm_loss(params, c, ids, tgt).backward()
        torch.cuda.synchronize()
        if name == "kernel":
            assert (fa.LAUNCHES_TC, fa.LAUNCHES_BWD_DQ_TC,
                    fa.LAUNCHES_BWD_DKV_TC) == (2, 2, 2)
        grads[name] = [p.grad.float() for p in leaves]
    for got, want in zip(grads["kernel"], grads["plain"]):
        assert torch.isfinite(got).all()
        assert _rel_l2(got, want) <= 2e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_head_dim_256_lm_train_step_matches_plain_path(gen, dtype):
    """An LM with head dim 256 (d_model 512, 2 heads) at T 1024, which
    raised on the card before the general kernels: one train step's loss
    and grads on the flash kernels (bf16: K1, dQ and dK/dV on the tensor
    cores padded to 256; f32: K1, dQ and dK/dV in split TF32 on the
    tensor cores) agree with the plain path's (plain
    attention, f32 scores) from the same params: loss within 2e-2 nats,
    grads relative L2 <= 2e-2 per leaf (chip_smoke.py phase 6's
    bars)."""
    import dataclasses

    import numpy as np

    from deeplearning4j_tpu_torch.zoo import transformer as tfm
    cfg = tfm.TransformerConfig(vocab_size=512, d_model=512, n_heads=2,
                                n_layers=2, d_ff=1024, max_seq=1024,
                                dtype=dtype, remat=False,
                                use_flash_attention=True)
    plain = dataclasses.replace(cfg, use_flash_attention=False,
                                attn_scores_bf16=False)
    assert cfg.head_dim == 256
    init = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    ids, tgt = (torch.as_tensor(rng.integers(0, 512, (2, 1024)),
                                device="cuda") for _ in range(2))
    losses, grads = {}, {}
    for name, c in (("kernel", cfg), ("plain", plain)):
        params = {k: (v.clone() if torch.is_tensor(v)
                      else {n: w.clone() for n, w in v.items()})
                  for k, v in init.items()}
        leaves = tfm.param_leaves(params)
        fa.reset_launches()
        loss = tfm.lm_loss(params, c, ids, tgt)
        loss.backward()
        torch.cuda.synchronize()
        if name == "kernel":
            tc = int(dtype == torch.bfloat16)
            assert (fa.LAUNCHES_TC, fa.LAUNCHES_BWD_DQ_TC,
                    fa.LAUNCHES_BWD_DKV_TC) == (2 * tc, 2 * tc, 2 * tc)
            assert (fa.LAUNCHES_TF32X3, fa.LAUNCHES_BWD_DQ_TF32X3,
                    fa.LAUNCHES_BWD_DKV_TF32X3) == (2 * (1 - tc),) * 3
            assert (fa.LAUNCHES_GENERAL, fa.LAUNCHES_BWD_DQ_GENERAL,
                    fa.LAUNCHES_BWD_DKV_GENERAL) == (0, 0, 0)
        losses[name] = loss.item()
        grads[name] = [p.grad.float() for p in leaves]
    assert abs(losses["kernel"] - losses["plain"]) <= 2e-2
    for got, want in zip(grads["kernel"], grads["plain"]):
        assert torch.isfinite(got).all()
        assert _rel_l2(got, want) <= 2e-2


def _bn_inputs(gen, n, c, dtype, offset=1.5):
    x = (torch.randn((n, c), generator=gen, device="cuda") * 2 + offset) \
        .to(dtype)
    gamma = torch.rand((c,), generator=gen, device="cuda") * 1.5 + 0.5
    beta = torch.randn((c,), generator=gen, device="cuda")
    center = torch.randn((c,), generator=gen, device="cuda") * 0.1
    return x, gamma, beta, center


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,c", [(1000, 3), (384, 24), (517, 64),
                                 (4096, 256), (98, 2048)])
@pytest.mark.parametrize("act", sorted(fo._ACTS))
def test_bn_act_kernel_matches_plain(gen, dtype, n, c, act):
    x, gamma, beta, _ = _bn_inputs(gen, n, c, dtype)
    before = fo.LAUNCHES
    y = fo.bn_act(x, gamma, beta, act)
    assert fo.LAUNCHES == before + 1
    ref = fo.bn_act_reference(x, gamma, beta, act).to(dtype)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == x.shape
    torch.testing.assert_close(y.float(), ref.float(), atol=ATOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bn_act_swish_rounds_as_silu(gen, dtype):
    """swish as ``F.silu`` computes it, z / (1 + exp(-z)), on 2^24
    pre-activations of up to |z| ~ 12: the f32 kernel equals the plain
    version bit for bit, so the bf16 one never parts from it by a bf16
    ulp where one ulp passes the atol (|y| >= 4: 0.03125 > 2e-2); z ·
    sigmoid(z), rounded twice, did now and then."""
    x, gamma, beta, _ = _bn_inputs(gen, 16384, 1024, dtype, offset=0.0)
    y = fo.bn_act(x, gamma * 2, beta, "swish")
    ref = fo.bn_act_reference(x, gamma * 2, beta, "swish")
    torch.cuda.synchronize()
    assert ref.abs().max().item() >= 8
    assert torch.equal(y.float(), ref.to(dtype).float())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,c", [(1000, 3), (1000, 5), (384, 24),
                                 (50176, 64), (6272, 2048)])
def test_bn_stats_kernel_matches_plain_and_repeats(gen, dtype, n, c):
    x, gamma, beta, center = _bn_inputs(gen, n, c, dtype)
    s = fo.bn_stats(x, center, gamma, beta)
    s_again = fo.bn_stats(x, center, gamma, beta)
    d = x.float() - center
    ref = torch.stack([d.sum(0), (d * d).sum(0)])
    torch.cuda.synchronize()
    assert s.shape == (7, c) and torch.equal(s, s_again)
    torch.testing.assert_close(s[:2], ref, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,c", [(1000, 3), (384, 24), (50176, 64),
                                 (6272, 2048)])
@pytest.mark.parametrize("act", sorted(fo._ACT_GRADS))
def test_bn_backward_kernels_match_plain(gen, dtype, n, c, act):
    x, gamma, beta, center = _bn_inputs(gen, n, c, dtype)
    g = torch.randn((n, c), generator=gen, device="cuda").to(dtype)
    mean, var = fo.train_stats_reference(x, center)
    inv = torch.rsqrt(var + 1e-5)
    scale = gamma * inv
    shift = beta - mean * scale
    r = fo.bn_bwd_reduce(x, g, scale, shift, mean, inv, act)
    r_again = fo.bn_bwd_reduce(x, g, scale, shift, mean, inv, act)
    dx = fo.bn_bwd_dx(x, g, scale, shift, mean, inv, r[2:], act)
    dx_ref, dgamma, dbeta = fo.bn_bwd_reference(x, g, gamma, beta, mean,
                                                inv, act)
    torch.cuda.synchronize()
    assert r.shape == (4, c) and torch.equal(r, r_again)
    torch.testing.assert_close(r[:2], torch.stack([dbeta, dgamma]),
                               rtol=1e-4, atol=1e-2)
    assert dx.dtype == dtype
    _close(dx, dx_ref, dtype)


# every (N, C) a ResNet-50 BN hands K3 at batch 128, and odd channel counts
K3_PATH_SHAPES = [(128 * hw * hw, c) for hw, c in (
    (112, 64), (56, 64), (56, 256), (28, 128), (28, 512), (14, 256),
    (14, 1024), (7, 512), (7, 2048))]
K3_ODD_SHAPES = [(1000, 3), (1000, 5), (1000, 24)]


def _max_rel(got, want):
    """max |got - want| over the largest |want| (0 when both are 0)."""
    top = want.abs().max().item()
    return (got - want).abs().max().item() / (top if top else 1.0)


def _reductions(x, g, gamma, beta, center):
    st = fo.bn_stats(x, center, gamma, beta, 1e-5)
    r = fo.bn_bwd_reduce(x, g, st[5], st[6], st[2], st[4], "relu")
    return st, r


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,c", K3_PATH_SHAPES + K3_ODD_SHAPES)
def test_bn_reductions_one_launch_repeat_and_fuse_the_epilogue(gen, dtype,
                                                               n, c):
    """The stats and backward-reduce kernels, one launch each: their sums
    within 1e-4 of the largest plain sum (another order of the same f32
    terms); the fused epilogue (mean, var, inv, then scale and shift;
    the sums over N) against the plain versions on the kernel's own sums,
    relative 1e-6; and 100 back-to-back relaunches of each bit for bit
    equal to the first (the last-block finish sums in a fixed order and
    leaves its arrival counters at zero)."""
    x, gamma, beta, center = _bn_inputs(gen, n, c, dtype)
    g = torch.randn((n, c), generator=gen, device="cuda").to(dtype)
    before = (fo.LAUNCHES_STATS, fo.LAUNCHES_BWD_REDUCE)
    st, r = _reductions(x, g, gamma, beta, center)
    assert (fo.LAUNCHES_STATS, fo.LAUNCHES_BWD_REDUCE) == \
        (before[0] + 1, before[1] + 1)
    d = x.float() - center
    assert _max_rel(st[:2], torch.stack([d.sum(0), (d * d).sum(0)])) <= 1e-4
    del d
    mean, var = fo._finish_moments(st[0], st[1], center, n)
    inv = torch.rsqrt(var + 1e-5)
    scale, shift = fo._scale_shift(gamma, beta, mean, inv)
    for got, want in zip(st[2:5], (mean, var, inv)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    for got, want in zip(st[5:], (scale, shift)):
        assert _max_rel(got, want) <= 1e-6
    _, dgamma, dbeta = fo.bn_bwd_reference(x, g, gamma, beta, st[2], st[4],
                                           "relu")
    assert _max_rel(r[:2], torch.stack([dbeta, dgamma])) <= 1e-4
    # torch divides by a scalar as a product with its f32 reciprocal, the
    # kernel exactly: an ulp apart at most
    assert _max_rel(r[2:], r[:2] / n) <= 1e-6
    same = torch.ones((), dtype=torch.bool, device="cuda")
    for _ in range(100):
        st2, r2 = _reductions(x, g, gamma, beta, center)
        same &= (st2 == st).all() & (r2 == r).all()
    assert bool(same)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("a,b", [((1605632, 64), (6272, 2048)),
                                 ((1000, 3), (25088, 256)),
                                 ((100352, 512), (1000, 24))])
def test_bn_reductions_repeat_across_alternating_shapes(gen, dtype, a, b):
    """Launches alternating between two shapes (other channel tiles and
    other chunk counts G, one counter buffer) give each shape its first
    result bit for bit: a counter left non-zero by one launch would hand
    the next launch's finish to a block that arrived early."""
    cases = []
    for n, c in (a, b):
        x, gamma, beta, center = _bn_inputs(gen, n, c, dtype)
        g = torch.randn((n, c), generator=gen, device="cuda").to(dtype)
        cases.append(((x, g, gamma, beta, center),
                      _reductions(x, g, gamma, beta, center)))
    same = torch.ones((), dtype=torch.bool, device="cuda")
    for _ in range(20):
        for args, (st, r) in cases:
            st2, r2 = _reductions(*args)
            same &= (st2 == st).all() & (r2 == r).all()
    assert bool(same)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("act", ["identity", "relu"])
def test_fused_bn_functions_match_plain_autograd(gen, dtype, act):
    """The two autograd Functions on CUDA (kernels) against the same
    Functions on the CPU (plain versions), values and grads."""
    n, c = 2048, 64
    x, gamma, beta, center = _bn_inputs(gen, n, c, dtype)
    g = torch.randn((n, c), generator=gen, device="cuda").to(dtype)
    counts = (fo.LAUNCHES, fo.LAUNCHES_STATS, fo.LAUNCHES_BWD_REDUCE,
              fo.LAUNCHES_BWD_DX)
    outs = {}
    for dev in ("cuda", "cpu"):
        xs, gs, bs = (t.to(dev).detach().requires_grad_(True)
                      for t in (x, gamma, beta))
        y, mean, var = fo.fused_bn_act_train(xs, gs, bs, center.to(dev),
                                             1e-5, act)
        grads = torch.autograd.grad(y, (xs, gs, bs), g.to(dev))
        outs[dev] = [t.cpu() for t in (y, mean, var, *grads)]
    assert (fo.LAUNCHES, fo.LAUNCHES_STATS, fo.LAUNCHES_BWD_REDUCE,
            fo.LAUNCHES_BWD_DX) == tuple(k + 1 for k in counts)
    for got, want in zip(outs["cuda"], outs["cpu"]):
        if got.dtype == torch.float32 and dtype == torch.bfloat16 \
                and got.shape != (n, c):
            torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-2)
        else:
            _close(got, want, dtype)
    xs = x.detach().requires_grad_(True)
    y = fo.fused_bn_act(xs, gamma, beta, act)
    (gx,) = torch.autograd.grad(y, xs, g)
    assert fo.LAUNCHES == counts[0] + 2 and gx.dtype == dtype


def _lstm_inputs(gen, b, t, h, dtype, state, peep=True):
    x = torch.randn((b, t, 4 * h), generator=gen, device="cuda").to(dtype)
    rw = (torch.randn((h, 4 * h), generator=gen, device="cuda")
          * h ** -0.5).to(dtype)
    peep = (torch.randn((3, h), generator=gen, device="cuda") * 0.1 if peep
            else torch.zeros((3, h), device="cuda"))
    z = torch.zeros((b, h), device="cuda")
    h0 = (torch.randn((b, h), generator=gen, device="cuda") * 0.5 if state
          else z).to(dtype)
    c0 = (torch.randn((b, h), generator=gen, device="cuda") if state
          else z).to(dtype)
    return x, rw, peep, h0, c0


LSTM_ATOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t,h,state", [(256, 60, 256, False),
                                         (3, 7, 40, True), (5, 1, 16, True),
                                         (133, 4, 64, True)])
def test_lstm_kernel_matches_plain(gen, dtype, b, t, h, state):
    ins = _lstm_inputs(gen, b, t, h, dtype, state)
    before = fl.LAUNCHES
    out = fl.lstm_seq(*ins)
    ref = fl.lstm_seq_reference(*ins)
    again = fl.lstm_seq(*ins)
    torch.cuda.synchronize()
    assert fl.LAUNCHES == before + 2
    assert out.dtype == dtype and out.shape == (b, t, h)
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=LSTM_ATOL[dtype], rtol=0)
    assert torch.equal(out, again)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_lstm_function_grads_match_plain_autograd(gen, dtype):
    """The Function's forward is the kernel, its backward recomputes the
    plain version: grads equal autograd through the plain version."""
    ins = _lstm_inputs(gen, 8, 12, 64, dtype, True)
    w = torch.randn((8, 12, 64), generator=gen, device="cuda").to(dtype)

    def grads(fn):
        leaves = [v.detach().clone().requires_grad_(True) for v in ins]
        return torch.autograd.grad((fn(*leaves) * w).float().sum(), leaves)

    before = fl.LAUNCHES
    cluster = fl.LAUNCHES_BY_ROUTE["cluster"]
    got = grads(fl.fused_lstm_seq)
    assert fl.LAUNCHES == before + 1
    assert fl.LAUNCHES_BY_ROUTE["cluster"] == cluster + 1
    for a, b_ in zip(got, grads(fl.lstm_seq_reference)):
        torch.testing.assert_close(a, b_, atol=1e-6, rtol=0)


# (B, T, H, peepholes, nonzero state): the char-RNN's shape, a ragged
# last cluster (B 133), B 1, T 1, no peepholes, and the route boundary:
# the largest H the cluster route takes in each dtype and the next, and
# f32 sequences just short of the cluster route
LSTM_ROUTE_SHAPES = [(256, 60, 256, True, False), (133, 4, 64, True, True),
                     (1, 5, 256, True, True), (5, 1, 16, True, True),
                     (17, 7, 64, False, True), (33, 6, 256, True, True),
                     (33, 6, 264, True, True), (33, 6, 384, True, True),
                     (33, 6, 392, True, True),
                     # f32's T boundary: one wave from T 4, two from T 32
                     (33, 3, 256, True, True), (256, 24, 256, True, False)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t,h,peep,state", LSTM_ROUTE_SHAPES)
def test_lstm_routes_match_plain(gen, dtype, b, t, h, peep, state):
    """Each route that takes the shape (the block route takes them all)
    against the plain version; a second launch bit for bit equal; the
    launch counted on its route; ``lstm_seq`` takes the route
    ``lstm_route`` names."""
    ins = _lstm_inputs(gen, b, t, h, dtype, state, peep)
    ref = fl.lstm_seq_reference(*ins)
    routes = {"block": fl.lstm_seq_block}
    if fl.lstm_cluster_plan(b, h, dtype) is not None:
        routes["cluster"] = fl.lstm_seq_cluster
    edge = {torch.bfloat16: 384, torch.float32: 256}[dtype]
    if h in (edge, edge + 8):
        assert ("cluster" in routes) == (h == edge)
    for route, kernel in routes.items():
        before = fl.LAUNCHES_BY_ROUTE[route]
        out = kernel(*ins)
        again = kernel(*ins)
        torch.cuda.synchronize()
        assert fl.LAUNCHES_BY_ROUTE[route] == before + 2
        assert out.dtype == dtype and out.shape == (b, t, h)
        torch.testing.assert_close(out.float(), ref.float(),
                                   atol=LSTM_ATOL[dtype], rtol=0)
        assert torch.equal(out, again)
    want = fl.lstm_route(b, t, h, dtype)
    before = dict(fl.LAUNCHES_BY_ROUTE)
    fl.lstm_seq(*ins)
    assert fl.LAUNCHES_BY_ROUTE[want] == before[want] + 1


@pytest.mark.parametrize("route", ["cluster", "block"])
def test_lstm_state_views_at_any_offset(gen, route):
    """f32 h0/c0 views that start 4 bytes past a 16-byte boundary run on
    both routes and give the result of their aligned copies."""
    x, rw, peep, h0, c0 = _lstm_inputs(gen, 17, 5, 64, torch.bfloat16, True)
    kernel = {"cluster": fl.lstm_seq_cluster, "block": fl.lstm_seq_block}
    views = []
    for v in (h0, c0):
        flat = torch.empty(1 + v.numel(), device="cuda")
        flat[1:] = v.float().flatten()
        views.append(flat[1:].view(v.shape))
        assert views[-1].data_ptr() % 16
    got = kernel[route](x, rw, peep, *views)
    want = kernel[route](x, rw, peep, h0.float(), c0.float())
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_lstm_cluster_graph_replay_equals_eager(gen, dtype):
    """A CUDA graph captured around the cluster kernel replays to the
    bits of an eager launch on the same inputs."""
    ins = _lstm_inputs(gen, 133, 9, 256, dtype, True)
    eager = fl.lstm_seq_cluster(*ins)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fl.lstm_seq_cluster(*ins)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fl.lstm_seq_cluster(*ins)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


# ------------------------------------------------- compiled steps (graphs)

def _mln_on_card(layers, n_in, seed=0, updater=None):
    from deeplearning4j_tpu_torch import nn, train
    b = (nn.NeuralNetConfiguration.builder().seed(seed)
         .updater(updater or train.Adam(1e-2)).list())
    for layer in layers:
        b = b.layer(layer)
    return nn.MultiLayerNetwork(b.build()).init(n_in, device="cuda")


def _fit_both_ways(make, batches, counters):
    """Train two nets built by ``make`` on ``batches`` one step a fit
    call: under ``disable_graphs()`` and with graphs. Returns the two
    nets, their losses, each graph step's kind and the launch counters'
    deltas of each graph step."""
    import deeplearning4j_tpu_torch as tpkg
    from deeplearning4j_tpu_torch.data import DataSet
    eager, graph = make(), make()
    le, lg, kinds, deltas = [], [], [], []
    for x, y in batches:
        with tpkg.disable_graphs():
            le.append(eager.fit(DataSet(x, y)))
        before = counters()
        lg.append(graph.fit(DataSet(x, y)))
        deltas.append(counters() - before)
        kinds.append(graph._step_fn.last)
    torch.cuda.synchronize()
    assert eager._step_fn.calls["direct"] == len(batches)
    return eager, graph, le, lg, kinds, deltas


def _assert_nets_equal(a, b):
    from deeplearning4j_tpu_torch.nn._compiled import tensors
    for tree in ("params", "states", "_opt_state"):
        ta, tb = tensors(getattr(a, tree)), tensors(getattr(b, tree))
        assert len(ta) == len(tb)
        for x, y in zip(ta, tb):
            assert torch.equal(x, y), tree


def test_graph_replay_equals_eager_with_k3(gen):
    """An MLN with a fused BN (K3 in both passes): 5 fit steps replayed
    from a CUDA graph (eager, capture, replay ×3) equal 5 steps under
    ``disable_graphs()`` bit for bit (losses, params, running stats,
    Adam's state). K3's wrappers run only at the eager step and the
    capture (one stats, normalize, reduce and dx launch each), and the
    arrival counters of the capture stream are zero after the replays."""
    from deeplearning4j_tpu_torch import nn
    x = [torch.randn((64, 24), generator=gen, device="cuda")
         for _ in range(5)]
    y = torch.eye(6, device="cuda")[torch.arange(64, device="cuda") % 6]

    def make():
        return _mln_on_card(
            [nn.DenseLayer(n_in=24, n_out=32, activation="identity"),
             nn.BatchNormalization(activation="relu", fused=True),
             nn.OutputLayer(n_in=32, n_out=6, activation="softmax")],
            (24,))

    counts = lambda: torch.tensor([fo.LAUNCHES, fo.LAUNCHES_STATS,  # noqa
                                   fo.LAUNCHES_BWD_REDUCE,
                                   fo.LAUNCHES_BWD_DX])
    eager, graph, le, lg, kinds, deltas = _fit_both_ways(
        make, [(xi, y) for xi in x], counts)
    assert kinds == ["eager", "capture", "replay", "replay", "replay"]
    assert [d.tolist() for d in deltas] == [[1] * 4] * 2 + [[0] * 4] * 3
    assert le == lg
    _assert_nets_equal(eager, graph)
    side = graph._step_fn._stream
    buf = fo._COUNTERS[(torch.cuda.current_device(), side.cuda_stream)]
    assert int(buf.abs().sum()) == 0


def test_graph_replay_equals_eager_with_k4(gen):
    """An MLN with a fused LSTM (K4) and an RNN output: 4 replayed steps
    equal 4 eager ones bit for bit; K4 launches at the eager step and the
    capture only."""
    from deeplearning4j_tpu_torch import nn
    eye = torch.eye(11, device="cuda")
    idx = lambda: torch.randint(0, 11, (16, 9), generator=gen,  # noqa
                                device="cuda")
    batches = [(eye[idx()], eye[idx()]) for _ in range(4)]

    def make():
        net = _mln_on_card(
            [nn.LSTM(n_in=11, n_out=32),
             nn.RnnOutputLayer(n_in=32, n_out=11, activation="softmax",
                               loss="mcxent")], (9, 11))
        net.layers[0].fused = True
        return net

    eager, graph, le, lg, kinds, deltas = _fit_both_ways(
        make, batches, lambda: torch.tensor(fl.LAUNCHES))
    assert kinds == ["eager", "capture", "replay", "replay"]
    assert [int(d) for d in deltas] == [1, 1, 0, 0]
    assert le == lg
    _assert_nets_equal(eager, graph)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_lm_step_replay_equals_eager_with_flash(gen, dtype):
    """A small LM on the flash kernels (K1 twice a layer with remat
    "save_attn", dQ and dK/dV once) and AdamW(capturable=True): 4 steps
    of ``make_train_step`` replayed from a CUDA graph equal 4 under
    ``disable_graphs()`` bit for bit, losses and params; the flash
    wrappers run at the eager step and the capture only."""
    import numpy as np

    import deeplearning4j_tpu_torch as tpkg
    from deeplearning4j_tpu_torch.zoo import transformer as tfm
    cfg = tfm.TransformerConfig(vocab_size=256, d_model=128, n_heads=2,
                                n_layers=2, d_ff=256, max_seq=256,
                                dtype=dtype, use_flash_attention=True,
                                fused_loss=True, loss_chunk=128,
                                remat=True, remat_policy="save_attn")
    init = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cuda")
    rng = np.random.default_rng(0)
    batches = [tuple(rng.integers(0, 256, (2, 256)) for _ in range(2))
               for _ in range(4)]
    runs = {}
    for way in ("eager", "graph"):
        params = {k: (v.clone() if torch.is_tensor(v)
                      else {n: w.clone() for n, w in v.items()})
                  for k, v in init.items()}
        opt = torch.optim.AdamW(tfm.param_leaves(params), lr=1e-3,
                                weight_decay=1e-4, capturable=True)
        step = tfm.make_train_step(cfg, opt)
        losses, launches = [], []
        for ids, tgt in batches:
            before = fa.LAUNCHES + fa.LAUNCHES_BWD_DQ + fa.LAUNCHES_BWD_DKV
            if way == "eager":
                with tpkg.disable_graphs():
                    losses.append(step(params, ids, tgt))
            else:
                losses.append(step(params, ids, tgt))
            launches.append(fa.LAUNCHES + fa.LAUNCHES_BWD_DQ
                            + fa.LAUNCHES_BWD_DKV - before)
        torch.cuda.synchronize()
        runs[way] = (losses, tfm.param_leaves(params), launches,
                     step.compiled.calls)
    (le, pe, ne, ce), (lg, pg, ng, cg) = runs["eager"], runs["graph"]
    assert ce["direct"] == 4 and ne == [8] * 4
    assert (cg["eager"], cg["capture"], cg["replay"]) == (1, 1, 2)
    assert ng == [8, 8, 0, 0]
    for a, b in zip(le, lg):
        assert torch.equal(a, b)
    for a, b in zip(pe, pg):
        assert torch.equal(a, b)


def test_lm_step_refuses_an_optimizer_that_is_not_capturable(gen):
    """On CUDA the compiled LM step needs ``capturable=True``: without it
    the step raises before it runs, and runs under ``disable_graphs()``."""
    import numpy as np

    import deeplearning4j_tpu_torch as tpkg
    from deeplearning4j_tpu_torch.zoo import transformer as tfm
    cfg = tfm.TransformerConfig(vocab_size=64, d_model=32, n_heads=2,
                                n_layers=1, d_ff=64, max_seq=16,
                                dtype=torch.float32, remat=False)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cuda")
    opt = torch.optim.AdamW(tfm.param_leaves(params), lr=1e-3)
    step = tfm.make_train_step(cfg, opt)
    ids = np.zeros((1, 16), np.int64)
    with pytest.raises(ValueError, match="capturable"):
        step(params, ids, ids)
    assert step.compiled.calls == {"direct": 0, "eager": 0, "capture": 0,
                                   "replay": 0}
    with tpkg.disable_graphs():
        assert torch.isfinite(step(params, ids, ids))


def test_capture_failure_raises_and_never_runs_eagerly(gen):
    """A step that reads a value back to the host (``.item()``) runs its
    first, eager call; the second call's capture fails and raises
    ``CaptureError`` chained to the sync's error, and so does every later
    call: the step is never run eagerly again on its own. The card is
    usable afterwards."""
    from deeplearning4j_tpu_torch.nn._compiled import (CaptureError,
                                                       CompiledStep)
    w = torch.zeros((), device="cuda")
    runs = []

    def step(x):
        runs.append(1)
        w.add_(x.sum())
        return torch.full((), w.item(), device="cuda")

    compiled = CompiledStep(step, lambda: [w], "syncing step")
    x = torch.ones(4, device="cuda")
    assert float(compiled(x)) == 4.0
    for _ in range(2):
        with pytest.raises(CaptureError, match="syncing step") as err:
            compiled(x)
        assert err.value.__cause__ is not None
    assert compiled.calls == {"direct": 0, "eager": 1, "capture": 0,
                              "replay": 0}
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
    torch.cuda.synchronize()
    assert float(w) == 4.0
    assert float((x * 2).sum()) == 8.0


# ------------------------------------------- the compiled serving step

def _serving_engine(dtype, **kw):
    from deeplearning4j_tpu_torch.serving import GenerationEngine
    from deeplearning4j_tpu_torch.zoo import transformer as tfm
    cfg = tfm.TransformerConfig(vocab_size=64, d_model=64, n_heads=4,
                                n_layers=2, d_ff=128, max_seq=64,
                                dtype=dtype, remat=False)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cuda")
    return GenerationEngine(cfg, params, prefill_chunk=8, **kw)


def _twin(cache):
    return {k: v.clone() for k, v in cache.items()}


def _replay_and_eager(eng, name, call, cache):
    """``call(cache)`` on ``cache`` through the compiled step and on a
    clone of it under ``disable_graphs()``: logits and every cache tensor
    bit for bit equal. Returns how the compiled call ran."""
    import deeplearning4j_tpu_torch as tpkg
    twin = _twin(cache)
    got = call(cache)
    kind = eng.sentinels[name].last
    with tpkg.disable_graphs():
        want = call(twin)
    torch.cuda.synchronize()
    assert torch.equal(got, want), name
    for k in cache:
        assert torch.equal(cache[k], twin[k]), (name, k)
    return kind


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel", ["on", "off"])
def test_serving_chunk_and_paged_decode_replay_equal_eager(gen, dtype,
                                                           kernel):
    """Chunks at varied (slot, start, length) of one bucket, then paged
    decode sweeps whose cursors and page tables change between calls:
    every replay equals an eager call on a cloned cache, bit for bit (a
    Python value baked into a capture would show here)."""
    import numpy as np

    from deeplearning4j_tpu_torch.serving import PageTable
    eng = _serving_engine(dtype, paged_kernel=kernel)
    cache = eng.init_paged_cache(3, 24, 4)
    table = PageTable.for_cache(cache)
    rng = np.random.default_rng(0)
    ctx = [rng.integers(0, 64, 40) for _ in range(3)]
    done = [0, 0, 0]
    kinds = []
    for slot, n in ((0, 8), (1, 5), (2, 8), (0, 3), (1, 8), (2, 1),
                    (0, 8), (1, 2)):
        table.map(slot, done[slot] + n)
        table.sync(cache)
        s0 = done[slot]
        kinds.append(_replay_and_eager(
            eng, "prefill_chunk", lambda c: eng.prefill_chunk(
                c, ctx[slot][s0:s0 + n], slot, start=s0)[0], cache))
        done[slot] += n
    assert kinds[:2] == ["eager", "capture"] and set(kinds[2:]) == {"replay"}
    name = "decode_paged_kernel" if kernel == "on" else "decode_paged"
    kinds = []
    for step in range(6):
        for slot in range(3):          # page growth between sweeps
            table.map(slot, done[slot] + step + 1)
        table.sync(cache)
        toks = rng.integers(0, 64, 3)
        kinds.append(_replay_and_eager(
            eng, name, lambda c: eng.decode_step(c, toks)[0], cache))
    assert kinds[2:] == ["replay"] * 4
    kinds = [_replay_and_eager(eng, "copy_page", lambda c: (
        eng.copy_page(c, src, dst), c["pos"].clone())[1], cache)
        for src, dst in ((0, 20), (5, 21), (1, 22))]
    assert kinds == ["eager", "capture", "replay"]


@pytest.mark.parametrize("kv,w", [("on", "off"), ("off", "on"),
                                  ("on", "on")])
def test_serving_int8_paths_replay_equal_eager(gen, kv, w):
    """An int8 pool (quantized at append, dequantized at gather) and int8
    weights (dequantized a layer at a time) through the compiled chunk,
    paged decode and verify steps: every replay equals an eager call on a
    cloned cache (scales included), bit for bit; a graph captured with
    one weight set is never replayed with the other."""
    import numpy as np

    from deeplearning4j_tpu_torch.nn._compiled import Bound
    from deeplearning4j_tpu_torch.serving import PageTable
    eng = _serving_engine(torch.bfloat16, quant_kv=kv, quant_weights=w)
    cache = eng.init_paged_cache(3, 24, 4)
    assert ("k_scale" in cache) == (kv == "on")
    table = PageTable.for_cache(cache)
    for slot in range(3):
        table.map(slot, 20)
    table.sync(cache)
    rng = np.random.default_rng(2)
    kinds = []
    for slot in range(3):
        toks = rng.integers(0, 64, 8)
        kinds.append(_replay_and_eager(
            eng, "prefill_chunk",
            lambda c: eng.prefill_chunk(c, toks, slot, 0)[0], cache))
    assert kinds == ["eager", "capture", "replay"]
    name = "decode_paged" if kv == "on" else "decode_paged_kernel"
    kinds = []
    for _ in range(4):
        toks = rng.integers(0, 64, 3)
        kinds.append(_replay_and_eager(
            eng, name, lambda c: eng.decode_step(c, toks)[0], cache))
    assert kinds[2:] == ["replay"] * 2
    kinds = []
    for slot in range(3):
        toks = rng.integers(0, 64, 5)
        kinds.append(_replay_and_eager(
            eng, "verify_chunk",
            lambda c: eng.verify_chunk(c, toks, slot, 12)[0], cache))
    assert kinds == ["eager", "capture", "replay"]
    # the other weight set is another signature of the same cache
    eng._quantized_weights()
    other = "bf16" if eng._decode_params() == "int8" else "int8"
    sentinel = eng.sentinels[name]
    n = len(sentinel.signatures)
    t = torch.zeros((3,), dtype=torch.int64, device="cuda")
    for _ in range(2):
        getattr(eng, "_" + name)(Bound(cache), t, other)
    assert sentinel.last == "capture" and len(sentinel.signatures) == n + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_serving_slot_prefill_and_dense_decode_replay_equal_eager(gen,
                                                                  dtype):
    """Dense admission at varied slots and lengths of one bucket, then
    dense decode sweeps: replays equal eager calls on cloned caches."""
    import numpy as np
    eng = _serving_engine(dtype)
    cache = eng.init_cache(4)
    rng = np.random.default_rng(1)
    kinds = []
    for slot, n in ((0, 20), (3, 9), (1, 32), (2, 17)):   # bucket 32
        prompt = rng.integers(0, 64, n)
        kinds.append(_replay_and_eager(
            eng, "prefill_slot",
            lambda c: eng.prefill_slot(c, prompt, slot)[0], cache))
    assert kinds == ["eager", "capture", "replay", "replay"]
    kinds = []
    for _ in range(5):
        toks = rng.integers(0, 64, 4)
        kinds.append(_replay_and_eager(
            eng, "decode_step", lambda c: eng.decode_step(c, toks)[0],
            cache))
    assert kinds[2:] == ["replay"] * 3
    kinds = []
    for _ in range(3):
        prompt = rng.integers(0, 64, (4, 16))
        lens = rng.integers(1, 17, 4)
        kinds.append(_replay_and_eager(
            eng, "prefill", lambda c: eng.prefill(c, prompt, lens)[0],
            cache))
    assert kinds == ["eager", "capture", "replay"]


def test_serving_sampled_replays_draw_what_eager_draws(gen):
    """A sampled signature draws from the engine's generator inside its
    graph: replays from a seeded generator give the tokens eager calls
    give from a twin generator of the same seed."""
    import numpy as np

    import deeplearning4j_tpu_torch as tpkg
    eng = _serving_engine(torch.float32)
    logits = torch.randn((4, 64), generator=gen, device="cuda")
    temps, topk = np.asarray([0.7, 1.0, 0.0, 1.3]), np.asarray([0, 5, 0, 3])
    g1, g2 = eng.make_generator(7), eng.make_generator(7)
    got = [eng.sample(logits, temps, topk, g1) for _ in range(6)]
    assert eng.sentinels["sample_tokens"].last == "replay"
    with tpkg.disable_graphs():
        want = [eng.sample(logits, temps, topk, g2) for _ in range(6)]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not all(torch.equal(got[0], g) for g in got[1:])


def test_serving_graph_never_replays_on_a_second_cache(gen):
    """A graph bakes its cache's addresses: a second cache of the same
    shapes starts its own signature (eager, then its own capture), and a
    cache's graphs go when the cache is freed."""
    import gc

    import numpy as np
    eng = _serving_engine(torch.bfloat16)
    step = eng.sentinels["decode_step"]._fn
    a, b = eng.init_cache(2), eng.init_cache(2)
    toks = np.asarray([3, 4])
    kinds = [_replay_and_eager(eng, "decode_step",
                               lambda c: eng.decode_step(c, toks)[0], a)
             for _ in range(3)]
    assert kinds == ["eager", "capture", "replay"]
    kinds = [_replay_and_eager(eng, "decode_step",
                               lambda c: eng.decode_step(c, toks)[0], b)
             for _ in range(3)]
    assert kinds == ["eager", "capture", "replay"]
    assert step.calls["capture"] == 2          # one graph for each cache
    n = len(step._graphs)
    del a
    gc.collect()
    assert len(step._graphs) == n - 1


def test_serving_capture_failure_raises_and_restores_the_stream(gen):
    """A serving step whose body reads a value back to the host fails at
    capture with ``CaptureError`` chained to the sync's error; the
    caller's stream is current again and the card usable."""
    from deeplearning4j_tpu_torch.nn._compiled import (Bound, CaptureError,
                                                       CompiledStep)

    def body(cache, x):
        cache["pos"].add_(x)
        return torch.full((1,), cache["pos"].sum().item(), device="cuda")

    step = CompiledStep(body, tuple, "syncing serving step")
    cache = {"pos": torch.zeros(2, dtype=torch.int32, device="cuda")}
    x = torch.ones(2, dtype=torch.int32, device="cuda")
    step(Bound(cache), x)
    with pytest.raises(CaptureError, match="syncing serving step") as err:
        step(Bound(cache), x)
    assert err.value.__cause__ is not None
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
    torch.cuda.synchronize()
    assert cache["pos"].tolist() == [1, 1]


# ------------------------------------- shared pages and typed requests

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_kernel_on_pages_shared_by_four_slots(gen, dtype):
    """K2 over a page table in which 4 slots map the same prefix pages
    (as prefix followers and beam lanes do) and each its own tail, at
    cursors ending in different pages: its plain version's output, and
    a second launch equal bit for bit."""
    b, h, dh, plen, per_slot = 4, 8, 64, 16, 8
    npg = 40
    # every draw from the fixture's generator: the default one may be
    # left registered with a graph by the capture tests above
    k, v = (torch.randn((npg, plen, h, dh), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    q = torch.randn((b, h, dh), generator=gen, device="cuda").to(dtype)
    shared = [7, 3, 19, 30, 11]               # five full prefix pages
    table = torch.full((b, per_slot), npg, dtype=torch.int32)
    pos = torch.tensor([5 * plen, 5 * plen + 3, 6 * plen + 9, 7 * plen - 1],
                       dtype=torch.int32)
    for s in range(b):
        need = int(pos[s]) // plen + 1
        own = [20 + 3 * s + j for j in range(need - len(shared))]
        table[s, :need] = torch.tensor(shared + own, dtype=torch.int32)
    table, pos = table.cuda(), pos.cuda()
    before = pa.LAUNCHES
    out = pa.paged_attention(q, k, v, table, pos)
    ref = pa.paged_attention_reference(q, k, v, table, pos)
    torch.cuda.synchronize()
    assert pa.LAUNCHES == before + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL[dtype],
                               rtol=0)
    assert torch.equal(out, pa.paged_attention(q, k, v, table, pos))


def _result_values(r):
    """A typed result's numbers, for an exact comparison."""
    from deeplearning4j_tpu_torch.serving import (BeamResult, EmbedResult,
                                                  ScoreResult)
    if isinstance(r, ScoreResult):
        return r.logprobs.tolist()
    if isinstance(r, EmbedResult):
        return r.embedding.tolist()
    if isinstance(r, BeamResult):
        return [s.tolist() for s in r.sequences], r.scores
    return r.tokens.tolist()


def _typed_serve(eng, kind):
    """Two rounds of ``kind``'s requests through one paged scheduler (the
    first round compiles, the second replays); each round's values."""
    import numpy as np

    from deeplearning4j_tpu_torch.serving import (
        ContinuousBatchingScheduler, vocab_mask)
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, 64, 24)
    prompts = [np.concatenate([prefix, rng.integers(0, 64, n)])
               for n in (3, 5, 9)]
    sched = ContinuousBatchingScheduler(
        eng, n_slots=4, page_len=4, n_pages=96,
        prefix_cache=kind in ("prefix", "session"))
    reqs = {"prefix": [((p, 6), {}) for p in prompts],
            "score": [((p,), {"kind": "score"}) for p in prompts],
            "embed": [((prompts[0],), {"kind": "embed"}),
                      ((prompts[1],), {"kind": "embed", "pooling": "last"})],
            "beam": [((prompts[0], 6), {"kind": "beam", "beam_width": 3})],
            "constrained": [
                ((prompts[0], 6), {"kind": "constrained",
                                   "token_mask": vocab_mask(range(0, 64, 3),
                                                            64)}),
                ((prompts[1], 6), {})]}
    rounds = []
    for r in range(2):
        if kind == "session":
            ctx, vals = prompts[r], []
            for turn in range(3):
                f = sched.submit(ctx, 4, session_id=f"s{r}")
                sched.run_until_idle()
                toks = f.result(30).tokens
                vals.append(toks.tolist())
                ctx = np.concatenate([ctx, toks, rng.integers(0, 64, 3)])
            rounds.append(vals)
            continue
        futs = [sched.submit(*a, **k) for a, k in reqs[kind]]
        sched.run_until_idle()
        rounds.append([_result_values(f.result(30)) for f in futs])
    assert sched.check_pages()
    return rounds


@pytest.mark.parametrize("kind", ["prefix", "session", "score", "embed",
                                  "beam", "constrained"])
def test_serving_typed_kinds_replay_equal_eager(gen, kind):
    """Each request kind served through the replayed steps equals the
    same serve on a twin engine under ``disable_graphs()``, bit for bit;
    the kind's own entry point replayed, and the decoding kinds ran K2."""
    import deeplearning4j_tpu_torch as tpkg
    eng = _serving_engine(torch.bfloat16, paged_kernel="on")
    twin = _serving_engine(torch.bfloat16, paged_kernel="on")
    pa.reset_launches()
    got = _typed_serve(eng, kind)
    with tpkg.disable_graphs():
        want = _typed_serve(twin, kind)
    assert got == want
    own = {"score": "verify_chunk", "embed": "embed_chunk",
           "constrained": "sample_tokens_masked"}.get(
        kind, "decode_paged_kernel")
    assert eng.sentinels[own].calls["replay"] > 0, own
    if kind not in ("score", "embed"):
        assert pa.LAUNCHES > 0
    if kind == "session":
        assert eng.sentinels["copy_page"].calls["replay"] > 0


# -------------------------------------- the DL4J workflow in the graphs
# The workflow modules run inside the replayed step; each check below is
# one way that can break silently on the card: (A) an lr baked at capture,
# (B) a dropout mask drawn once and replayed, (C) an anomaly gate that
# reads back to the host, (D) a load that leaves graphs on stale tensors,
# (E) the deferred score read, (F) a replayed output() that hands out the
# graph's static buffer.

def _batch(gen, n=32, d=12, c=4):
    x = torch.randn((n, d), generator=gen, device="cuda")
    y = torch.eye(c, device="cuda")[torch.randint(0, c, (n,), generator=gen,
                                                  device="cuda")]
    return x, y


def _small(updater, dropout=0.0, seed=3, bn=False):
    from deeplearning4j_tpu_torch import nn
    layers = [nn.DenseLayer(n_in=12, n_out=16, activation="tanh")]
    if bn:
        layers.append(nn.BatchNormalization(fused=True))
    layers += [nn.DenseLayer(n_in=16, n_out=16, activation="relu",
                             dropout=dropout),
               nn.OutputLayer(n_in=16, n_out=4, activation="softmax")]
    return _mln_on_card(layers, (12,), seed=seed, updater=updater)


def test_scheduled_lr_trace_over_replays(gen):
    """(A) Sgd under an ExponentialSchedule: over 10 steps (eager,
    capture, 8 replays) each step's lr, recovered from the update and the
    step's gradient, is ``value_at`` of its own step; the run equals one
    under ``disable_graphs()`` bit for bit."""
    import deeplearning4j_tpu_torch as tpkg
    from deeplearning4j_tpu_torch import train
    from deeplearning4j_tpu_torch.data import DataSet
    sched = train.ExponentialSchedule(initial_value=0.2, gamma=0.8)
    batches = [_batch(gen) for _ in range(10)]
    graph, eager = _small(train.Sgd(sched)), _small(train.Sgd(sched))
    kinds = []
    for k, (x, y) in enumerate(batches):
        grads, _ = graph.gradient_and_score(DataSet(x, y))
        w0 = graph.params["layer_0"]["W"].detach().clone()
        graph.fit(DataSet(x, y))
        kinds.append(graph._step_fn.last)
        g = grads["layer_0"]["W"]
        delta = graph.params["layer_0"]["W"].detach() - w0
        lr = -float((delta * g).sum() / (g * g).sum())
        assert abs(lr - sched.value_at(k, 0)) <= 1e-4 * sched.value_at(k, 0)
        with tpkg.disable_graphs():
            eager.fit(DataSet(x, y))
    assert kinds == ["eager", "capture"] + ["replay"] * 8
    _assert_nets_equal(eager, graph)


def test_dropout_masks_differ_between_replays_and_equal_eager(gen):
    """(B) Input dropout with lr 0 (the params stay put, so a loss moves
    only with its mask): the replays' losses on one batch differ from
    step to step, and equal the eager run's, step for step, under the
    same seed (the generator is registered with the graph)."""
    import deeplearning4j_tpu_torch as tpkg
    from deeplearning4j_tpu_torch import train
    from deeplearning4j_tpu_torch.data import DataSet
    x, y = _batch(gen, n=64)
    graph = _small(train.Sgd(0.0), dropout=0.5)
    eager = _small(train.Sgd(0.0), dropout=0.5)
    assert graph._gen.device.type == "cuda"
    lg = [graph.fit(DataSet(x, y)) for _ in range(6)]
    with tpkg.disable_graphs():
        le = [eager.fit(DataSet(x, y)) for _ in range(6)]
    assert graph._step_fn.calls == {"direct": 0, "eager": 1, "capture": 1,
                                    "replay": 4}
    assert lg == le
    assert len(set(lg)) == len(lg)


def test_anomaly_gate_in_a_replay(gen):
    """(C) A NaN batch at a replayed step leaves params, updater state and
    BN states (K3 fused) bit-identical with no host read in the step; the
    strict detector raises at the next step, one step late."""
    from deeplearning4j_tpu_torch import train
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn._compiled import tensors
    good = [_batch(gen) for _ in range(4)]
    bad = (good[0][0].clone(), good[0][1])
    bad[0][0, 0] = float("nan")
    net = _small(train.Adam(1e-2), bn=True)
    net.enable_gradient_anomaly_detection(
        train.GradientAnomalyDetector(strict=False))
    for x, y in good[:2]:
        net.fit(DataSet(x, y))
    before = [t.clone() for t in tensors((net.params, net.states,
                                          net._opt_state))]
    net.fit(DataSet(*bad))
    assert net._step_fn.last == "replay"
    after = tensors((net.params, net.states, net._opt_state))
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert {a.kind for a in net._anomaly_detector.anomalies} == \
        {"nonfinite"}
    strict = _small(train.Adam(1e-2), bn=True)
    strict.enable_gradient_anomaly_detection()
    with pytest.raises(FloatingPointError):
        strict.fit([DataSet(*good[0]), DataSet(*good[1]), DataSet(*bad),
                    DataSet(*good[2])])
    assert strict._step_count == 4 and strict._step_fn.last == "replay"


def test_load_into_a_net_with_graphs(gen, tmp_path):
    """(D) ``load_params`` into a net whose train step and ``output()``
    have graphs copies into its tensors in place: the graphs replay on
    the loaded values — the next step and ``output()`` equal those of a
    net ``load``-ed from the same zip, run eagerly."""
    import deeplearning4j_tpu_torch as tpkg
    from deeplearning4j_tpu_torch import nn, serde, train
    from deeplearning4j_tpu_torch.data import DataSet
    batches = [_batch(gen) for _ in range(4)]
    src = _small(train.Adam(1e-2), seed=9, bn=True)
    src.fit([DataSet(x, y) for x, y in batches[:2]])
    path = tmp_path / "src.zip"
    src.save(path, save_updater=True)
    net = _small(train.Adam(1e-2), seed=1, bn=True)
    for x, y in batches[:3]:
        net.fit(DataSet(x, y))
        net.output(x)
    assert net._step_fn.last == "replay" and net._infer_fn.last == "replay"
    serde.load_params(net, path, updater=True)
    x, y = batches[3]
    net.fit(DataSet(x, y))
    out = net.output(batches[0][0])
    assert net._step_fn.last == "replay" and net._infer_fn.last == "replay"
    ref = nn.MultiLayerNetwork.load(path, device="cuda")
    with tpkg.disable_graphs():
        ref.fit(DataSet(x, y))
        want = ref.output(batches[0][0])
    assert torch.equal(out, want)
    _assert_nets_equal(ref, net)


def test_deferred_score_read_order(gen):
    """(E) A deferred listener gets step k after step k+1 is queued, the
    epoch's last before ``on_epoch_end``, each score equal to the loss a
    synchronous listener reads; a raise mid-epoch still delivers the
    finished step."""
    from deeplearning4j_tpu_torch import train
    from deeplearning4j_tpu_torch.data import DataSet
    batches = [DataSet(*_batch(gen)) for _ in range(4)]

    class Log:
        def __init__(self, deferred):
            self.deferred_score_ok = deferred
            self.rows = []

        def iteration_done(self, net, it, ep, score):
            self.rows.append((it, score, net._step_count))

        def on_epoch_end(self, net):
            self.rows.append(("end", net._step_count))

    a, b = _small(train.Adam(1e-2)), _small(train.Adam(1e-2))
    la, lb = Log(True), Log(False)
    a.set_listeners(la)
    b.set_listeners(lb)
    a.fit(batches, epochs=2)
    b.fit(batches, epochs=2)
    assert [r[1] for r in la.rows if r[0] != "end"] == \
        [r[1] for r in lb.rows if r[0] != "end"]
    lags = [r[2] - r[0] for r in la.rows if r[0] != "end"]
    assert lags == [1, 1, 1, 0] * 2
    assert [r[0] for r in la.rows][4] == "end"

    def boom():
        yield batches[0]
        yield batches[1]
        raise RuntimeError("source failed")
    c = _small(train.Adam(1e-2))
    lc = Log(True)
    c.set_listeners(lc)
    with pytest.raises(RuntimeError, match="source failed"):
        c.fit(boom())
    assert [r[0] for r in lc.rows] == [1, 2]


def test_replayed_output_equals_eager_and_stays_put(gen):
    """(F) ``output()`` over 5 batches of one shape and a last partial
    one (its own signature), BN on K3: eager, capture, replays; each
    result equals ``disable_graphs()``'s bit for bit, and the results
    handed out earlier are unchanged after later batches; ``evaluate``
    accumulates on the card and counts what ``output()`` predicts."""
    import deeplearning4j_tpu_torch as tpkg
    from deeplearning4j_tpu_torch import train
    from deeplearning4j_tpu_torch.data import DataSet
    net = _small(train.Adam(1e-2), bn=True)
    net.layers[1].fused = "auto"
    xs = [_batch(gen)[0] for _ in range(5)] + [_batch(gen, n=7)[0]]
    outs = [net.output(x) for x in xs]
    kept = [o.clone() for o in outs]
    assert net._infer_fn.calls == {"direct": 0, "eager": 2, "capture": 1,
                                   "replay": 3}
    with tpkg.disable_graphs():
        want = [net.output(x) for x in xs]
    for o, k, w in zip(outs, kept, want):
        assert torch.equal(o, k) and torch.equal(o, w)
    ys = [torch.eye(4, device="cuda")[torch.randint(
        0, 4, (len(x),), generator=gen, device="cuda")] for x in xs]
    ev = net.evaluate([DataSet(x, y) for x, y in zip(xs, ys)])
    assert ev._conf.device.type == "cuda"
    conf = torch.zeros((4, 4), dtype=torch.int64)
    for o, y in zip(want, ys):
        for t, p in zip(y.argmax(-1).tolist(), o.argmax(-1).tolist()):
            conf[t, p] += 1
    assert (ev.confusion == conf.numpy()).all()


# ------------------------------------------------- observability plane

def test_span_sync_waits_on_its_streams_event(gen):
    """A span's ``sync`` on CUDA tensors waits for their work (its end
    timestamp covers the device), through an event on the tensor's
    stream — a side stream's kernel is covered, not only the default
    stream's."""
    from deeplearning4j_tpu_torch.obs import Tracer
    tracer = Tracer()
    a = torch.randn((2048, 2048), generator=gen, device="cuda")
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        with tracer.span("side", sync={"out": [a @ a]}) as sp:
            out = a @ a
            for _ in range(8):
                out = out @ a / 64
            sp.set_sync(out)
        # the span ended after the stream's work: nothing left to wait on
        assert side.query()
    assert sp.synced and sp.time_s > 0


def test_span_never_waits_during_capture(gen):
    """Inside a graph capture the span records, but never waits (a wait
    would break the capture): it stays unsynced, and the graph replays."""
    from deeplearning4j_tpu_torch.obs import Tracer
    tracer = Tracer()
    x = torch.randn((64, 64), generator=gen, device="cuda")
    g = torch.cuda.CUDAGraph()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        y = x @ x                        # warm the kernel off the capture
    torch.cuda.current_stream().wait_stream(s)
    with torch.cuda.graph(g):
        with tracer.span("captured") as sp:
            y = x @ x
            sp.set_sync(y)
    g.replay()
    torch.cuda.synchronize()
    assert not sp.synced
    assert torch.equal(y, x @ x)


def test_sampler_observation_replayed_equals_eager(gen):
    """The sampler observation of a replayed decode sweep equals the one
    of the same sweep run eagerly on a cloned cache, and both equal the
    reference's host formula (numpy, f32) on the same logits."""
    import numpy as np

    import deeplearning4j_tpu_torch as tpkg
    from deeplearning4j_tpu_torch.obs import MetricsRegistry
    from deeplearning4j_tpu_torch.serving import (
        ContinuousBatchingScheduler as Sched, PageTable)
    eng = _serving_engine(torch.bfloat16)
    cache = eng.init_paged_cache(4, 32, 8)
    table = PageTable.for_cache(cache)
    rng = np.random.default_rng(0)
    for s in range(4):
        p = rng.integers(0, 64, 20 + 3 * s).astype(np.int32)
        table.map(s, len(p) + 3)
        table.sync(cache)
        for c0 in range(0, len(p), eng.chunk_len):
            eng.prefill_chunk(cache, p[c0:c0 + eng.chunk_len], s, start=c0)
    toks = rng.integers(0, 64, 4).astype(np.int32)
    for _ in range(2):                    # eager, then capture: a graph
        eng.decode_step(cache, toks)      # is a signature of its cache
    twin = _twin(cache)
    logits, _ = eng.decode_step(cache, toks)
    assert eng.sentinels["decode_paged_kernel"].last == "replay"
    with tpkg.disable_graphs():
        eager, _ = eng.decode_step(twin, toks)
    torch.cuda.synchronize()
    assert torch.equal(logits, eager)

    def observe(lg, topks):
        reg = MetricsRegistry()
        m = {"sample_entropy": reg.histogram("dl4j_e", ""),
             "topk_mass": reg.histogram("dl4j_m", "")}
        Sched._sample_obs(m, lg, topks)
        return m["sample_entropy"].sum(), m["topk_mass"].sum()
    topks = [0, 5, 2, 40]
    rep, eag = observe(logits, topks), observe(eager, topks)
    assert rep == eag
    host = logits.float().cpu().numpy()
    p = host - host.max(-1, keepdims=True)
    p = np.exp(p)
    p /= p.sum(-1, keepdims=True)
    ent = float((-(p * np.log(p + 1e-30)).sum(-1)).mean())
    mass = np.mean([np.partition(r, r.size - k)[r.size - k:].sum()
                    for r, k in zip(p, topks) if k > 0])
    assert abs(rep[0] - ent) <= 1e-4 and abs(rep[1] - mass) <= 1e-4


def test_device_memory_stats_match_the_allocator(gen):
    from deeplearning4j_tpu_torch.obs import device_memory_stats
    keep = torch.empty((1 << 20,), device="cuda")
    torch.cuda.synchronize()
    got = device_memory_stats()
    stats = torch.cuda.memory_stats()
    assert got == {
        "bytes_in_use": float(stats["allocated_bytes.all.current"]),
        "peak_bytes_in_use": float(stats["allocated_bytes.all.peak"]),
        "bytes_limit": float(torch.cuda.mem_get_info()[1])}
    assert got["bytes_in_use"] == torch.cuda.memory_allocated() > 0
    assert device_memory_stats("cpu") is None
    del keep


def test_sentinels_count_captures_as_compiles(gen):
    """On the card a compile is a graph capture: a signature's eager call
    compiles nothing, its capture counts one (into the registry and the
    compile spans), its replays none; after ``mark_warm`` a new signature
    warns at its capture, not at its eager call."""
    import numpy as np

    from deeplearning4j_tpu_torch.obs import get_registry
    eng = _serving_engine(torch.float32)
    s = eng.sentinels["decode_step"]
    reg = get_registry()
    total = reg.get("dl4j_compile_total")
    before = total.value(component="decode_step") if total else 0.0
    cache = eng.init_cache(2)
    toks = np.zeros((2,), np.int32)
    kinds = []
    for _ in range(4):
        eng.decode_step(cache, toks)
        kinds.append(s.last)
    assert kinds == ["eager", "capture", "replay", "replay"]
    assert s.compiles == 1
    assert get_registry().get("dl4j_compile_total").value(
        component="decode_step") == before + 1
    s.mark_warm()
    other = eng.init_cache(2)          # a new cache: a new signature
    eng.decode_step(other, toks)       # eager: no compile yet
    assert s.retraces_after_warm == 0
    with pytest.warns(RuntimeWarning, match="retrace"):
        eng.decode_step(other, toks)   # its capture
    assert s.retraces_after_warm == 1 and s.overhead_seconds > 0


# ------------------------------------------------- BERT and ParallelInference

# every (N, C) a relu BN of ResNet-50 hands K3's normalize at batch 1,
# 224x224 (the stem's and each stage's a/b BNs)
RESNET_B1_RELU_SHAPES = [(112 * 112, 64), (56 * 56, 64), (28 * 28, 128),
                         (14 * 14, 256), (7 * 7, 512)]


@pytest.mark.parametrize("n,c", RESNET_B1_RELU_SHAPES)
def test_bn_act_kernel_at_resnet50_batch1_shapes(gen, n, c):
    """K3's normalize at the shapes a ResNet-50 served at batch 1 gives
    it: against its plain version, a second launch bit for bit equal."""
    x, gamma, beta, _ = _bn_inputs(gen, n, c, torch.bfloat16)
    y = fo.bn_act(x, gamma, beta, "relu")
    ref = fo.bn_act_reference(x, gamma, beta, "relu").to(torch.bfloat16)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), ref.float(),
                               atol=ATOL[torch.bfloat16], rtol=0)
    assert torch.equal(y, fo.bn_act(x, gamma, beta, "relu"))


def _bert_small(tfm, **kw):
    cfg = tfm.BertConfig(vocab_size=512, d_model=128, n_heads=2, n_layers=2,
                         d_ff=256, max_seq=64, **kw)
    params = tfm.bert_init(cfg, torch.Generator().manual_seed(0),
                           device="cuda")
    with torch.no_grad():
        params["cls"].normal_(0.0, 0.02, generator=torch.Generator(
            device="cuda").manual_seed(1))
    return cfg, params


def _clone_tree(t):
    return {k: _clone_tree(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in t.items()}


def _adamw(tfm, params, lr=1e-3):
    return torch.optim.AdamW(tfm.param_leaves(params), lr=lr,
                             weight_decay=1e-4, capturable=True)


def test_bert_finetune_step_replay_equals_eager(gen):
    """The classifier fine-tune (remat "full", bf16 scores, a padding
    mask) compiled as the port's steps are: 4 steps replayed from a CUDA
    graph equal 4 under ``disable_graphs()`` bit for bit."""
    import deeplearning4j_tpu_torch as tpkg
    from deeplearning4j_tpu_torch.nn._compiled import CompiledStep, tensors
    from deeplearning4j_tpu_torch.zoo import transformer as tfm
    cfg, init = _bert_small(tfm, remat=True, attn_scores_bf16=True)
    ids = torch.randint(0, 512, (8, 64), generator=gen, device="cuda")
    mask = (torch.rand((8, 64), generator=gen, device="cuda") < 0.8).float()
    labels = torch.randint(0, 2, (8,), generator=gen, device="cuda")
    runs = {}
    for way in ("eager", "graph"):
        params = _clone_tree(init)
        opt = _adamw(tfm, params)

        def static_step(ids, labels, mask):
            opt.zero_grad(set_to_none=True)
            loss = tfm.bert_classifier_loss(params, cfg, ids, labels,
                                            attn_mask=mask)
            loss.backward()
            opt.step()
            return loss.detach()

        step = CompiledStep(static_step, lambda: [
            *tensors(params), *tfm.param_leaves(params),
            *tensors(list(opt.state.values()))], "bert_finetune")
        with (tpkg.disable_graphs() if way == "eager"
              else contextlib.nullcontext()):
            losses = [step(ids, labels, mask) for _ in range(4)]
        torch.cuda.synchronize()
        runs[way] = (losses, tfm.param_leaves(params), step.calls)
    (le, pe, ce), (lg, pg, cg) = runs["eager"], runs["graph"]
    assert ce["direct"] == 4
    assert (cg["eager"], cg["capture"], cg["replay"]) == (1, 1, 2)
    assert all(torch.equal(a, b) for a, b in zip(le, lg))
    assert all(torch.equal(a, b) for a, b in zip(pe, pg))
    assert all(torch.isfinite(x) for x in lg)


def test_bert_mlm_step_replay_equals_eager_and_draws_fresh_masks(gen):
    """``make_bert_mlm_train_step`` with special ids, token types (mostly
    one id, so that their embedding's backward sums many repeats) and a
    mask: 5 steps replayed equal 5 eager from the same generator state
    bit for bit, and the generator moves at every replay."""
    import deeplearning4j_tpu_torch as tpkg
    from deeplearning4j_tpu_torch.zoo import transformer as tfm
    cfg, init = _bert_small(tfm, remat=True, attn_scores_bf16=True)
    ids = torch.randint(5, 512, (8, 64), generator=gen, device="cuda")
    ids[:, 0] = 2
    ids[:, 50:] = 0
    mask = (ids != 0).float()
    type_ids = torch.zeros_like(ids)
    type_ids[:, 30:50] = 1
    runs = {}
    for way in ("eager", "graph"):
        params = _clone_tree(init)
        g = torch.Generator(device="cuda").manual_seed(3)
        step = tfm.make_bert_mlm_train_step(
            cfg, _adamw(tfm, params), 4, special_ids=(0, 2, 3),
            generator=g)
        states = []
        with (tpkg.disable_graphs() if way == "eager"
              else contextlib.nullcontext()):
            losses = []
            for _ in range(5):
                states.append(g.get_state())
                losses.append(step(params, ids, type_ids, mask))
        torch.cuda.synchronize()
        runs[way] = (losses, tfm.param_leaves(params), step.compiled.calls,
                     states)
    (le, pe, _, se), (lg, pg, cg, _) = runs["eager"], runs["graph"]
    assert (cg["eager"], cg["capture"], cg["replay"]) == (1, 1, 3)
    assert all(torch.equal(a, b) for a, b in zip(le, lg))
    assert all(torch.equal(a, b) for a, b in zip(pe, pg))
    assert len({bytes(s.numpy()) for s in se}) == 5


def test_bert_mlm_step_refuses_an_optimizer_that_is_not_capturable(gen):
    from deeplearning4j_tpu_torch.zoo import transformer as tfm
    cfg, params = _bert_small(tfm)
    opt = torch.optim.AdamW(tfm.param_leaves(params), lr=1e-3)
    step = tfm.make_bert_mlm_train_step(cfg, opt, 4)
    with pytest.raises(ValueError, match="capturable"):
        step(params, torch.zeros((2, 64), dtype=torch.long, device="cuda"))


def _served_bert(tfm, max_wait_ms=None):
    from deeplearning4j_tpu_torch.parallel import ParallelInference
    from deeplearning4j_tpu_torch.serving import FunctionalInferenceModel
    cfg, params = _bert_small(tfm)
    model = FunctionalInferenceModel(
        params, lambda p, ids: tfm.bert_forward(p, cfg, ids)[0])
    return cfg, params, ParallelInference(model, max_batch=64,
                                          max_wait_ms=max_wait_ms)


def test_parallel_inference_captures_once_per_signature(gen):
    """Three batch sizes, each warmed (eager, capture): one capture a
    signature, every later call a replay, 0 retraces after warm, the
    served logits equal the eager forward's."""
    from deeplearning4j_tpu_torch.obs import CompileSentinel
    from deeplearning4j_tpu_torch.zoo import transformer as tfm
    cfg, params, pi = _served_bert(tfm)
    sentinel = CompileSentinel("served_bert", pi._build())
    xs = {b: torch.randint(0, 512, (b, 64), generator=gen, device="cuda")
          for b in (1, 4, 16)}
    for x in xs.values():
        pi.output(x)
        pi.output(x)
    sentinel.mark_warm()
    for _ in range(3):
        for b, x in xs.items():
            assert torch.equal(pi.output(x),
                               tfm.bert_forward(params, cfg, x)[0])
            assert pi._infer.last == "replay"
    assert pi._infer.calls["capture"] == 3
    assert sentinel.retraces_after_warm == 0


def test_parallel_inference_refresh_after_a_training_step(gen):
    """Served weights are a snapshot: an in-place training step leaves
    what is served unchanged; ``refresh()`` serves the new weights from
    the same storage, through the same graph."""
    from deeplearning4j_tpu_torch.zoo import transformer as tfm
    cfg, params, pi = _served_bert(tfm)
    x = torch.randint(0, 512, (4, 64), generator=gen, device="cuda")
    for _ in range(3):
        before = pi.output(x)
    labels = torch.tensor([0, 1, 0, 1], device="cuda")
    opt = torch.optim.SGD(tfm.param_leaves(params), lr=0.5)
    loss = tfm.bert_classifier_loss(params, cfg, x, labels)
    loss.backward()
    opt.step()
    assert torch.equal(pi.output(x), before)
    captures = pi._infer.calls["capture"]
    after = pi.refresh().output(x)
    assert not torch.equal(after, before)
    assert torch.equal(after, tfm.bert_forward(params, cfg, x)[0])
    assert pi._infer.calls["capture"] == captures
    assert pi._infer.last == "replay"


def test_parallel_inference_timer_never_captures(gen):
    """The deadline timer's flush at a signature no caller captured runs
    the eager stage (twice: no capture on the timer thread) while a
    second thread runs its own CUDA work; a caller's ``output`` captures
    it; the timer's next flush replays, the second thread busy again."""
    import threading

    from deeplearning4j_tpu_torch.zoo import transformer as tfm
    cfg, params, pi = _served_bert(tfm, max_wait_ms=5)
    errors = []

    @contextlib.contextmanager
    def busy_thread():
        stop = threading.Event()

        def noise():
            try:
                a = torch.randn((512, 512), device="cuda")
                while not stop.is_set():
                    a = (a @ a).tanh()
                    torch.empty((1 << 20,), device="cuda")
                torch.cuda.synchronize()
            except Exception as e:     # noqa: BLE001 — asserted below
                errors.append(e)

        t = threading.Thread(target=noise)
        t.start()
        try:
            yield
        finally:
            stop.set()
            t.join(timeout=60)
        assert not t.is_alive()

    x = torch.randint(0, 512, (3, 64), generator=gen, device="cuda")
    want = tfm.bert_forward(params, cfg, x)[0]
    kinds = []
    with busy_thread():
        for _ in range(2):
            fut = pi.submit(x)
            assert torch.equal(fut.result(timeout=60), want)
            kinds.append(pi._infer.last)
    assert kinds == ["eager", "eager"]
    assert torch.equal(pi.output(x), want)
    assert pi._infer.last == "capture"
    with busy_thread():
        fut = pi.submit(x)
        assert torch.equal(fut.result(timeout=60), want)
        assert pi._infer.last == "replay"
    assert not errors


# ------------------------------------------- the rest of the DL4J workflow

def _remat_graph(dropout):
    """A small residual CG with dropout and fused K3 BNs, on the card."""
    from deeplearning4j_tpu_torch import nn
    b = nn.NeuralNetConfiguration.builder().seed(7)
    g = b.graph_builder().add_inputs("in")
    g.add_layer("stem", nn.ConvolutionLayer(
        n_out=16, kernel_size=(3, 3), convolution_mode="same",
        activation="identity"), "in")
    g.add_layer("stem_bn", nn.BatchNormalization(activation="relu",
                                                 fused=True), "stem")
    x = "stem_bn"
    for i in range(2):
        g.add_layer(f"b{i}_conv", nn.ConvolutionLayer(
            n_out=16, kernel_size=(3, 3), convolution_mode="same",
            activation="identity", dropout=dropout), x)
        g.add_layer(f"b{i}_bn", nn.BatchNormalization(activation="identity",
                                                      fused=True),
                    f"b{i}_conv")
        g.add_vertex(f"b{i}_add", nn.ElementWiseVertex(op="add"),
                     f"b{i}_bn", x)
        g.add_layer(f"b{i}_out", nn.ActivationLayer(activation="relu"),
                    f"b{i}_add")
        x = f"b{i}_out"
    g.add_layer("gap", nn.GlobalPoolingLayer(pooling_type="avg"), x)
    g.add_layer("out", nn.OutputLayer(n_in=16, n_out=5, activation="softmax",
                                      loss="mcxent"), "gap")
    g.set_outputs("out")
    g.set_input_types(nn.InputType.convolutional(16, 16, 3))
    return nn.ComputationGraph(g.build()).init()


def test_remat_with_dropout_replayed_equals_monolithic(gen):
    """remat_segments=3 on a CG with dropout: 4 replayed steps (eager,
    capture, replays) land bit for bit where the monolithic net's 4
    replayed steps land, the dropout masks of each recompute being the
    forward's; K3's stats and normalize launch twice as often."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn._compiled import tensors
    x = torch.rand(8, 16, 16, 3, device="cuda", generator=gen)
    y = torch.nn.functional.one_hot(torch.randint(
        0, 5, (8,), device="cuda", generator=gen), 5).float()
    runs = {}
    for remat in (None, 3):
        net = _remat_graph(0.3)
        net.remat_segments = remat
        fo.reset_launches()
        losses = [net.fit(DataSet(x, y)) for _ in range(4)]
        assert net._step_fn.calls == {"direct": 0, "eager": 1, "capture": 1,
                                      "replay": 2}
        runs[remat] = (losses, [t.detach().clone() for t in tensors(
            (net.params, net.states, net._opt_state))],
            (fo.LAUNCHES_STATS, fo.LAUNCHES, fo.LAUNCHES_BWD_DX))
    assert runs[None][0] == runs[3][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[None][1], runs[3][1]))
    (s0, n0, d0), (s1, n1, d1) = runs[None][2], runs[3][2]
    assert (s1, n1, d1) == (2 * s0, 2 * n0, d0) and s0 > 0


def test_async_prefetch_during_a_capture(gen):
    """fit over a host ListDataSetIterator: the producer packs the next
    batches (on the host, never touching the card) while the step is
    captured, and the prefetched fit equals fit over the same batches in
    a list, bit for bit; a device-resident iterator is iterated directly
    (nothing to prefetch) and lands on the same params."""
    from deeplearning4j_tpu_torch import nn, train
    from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
    x = torch.randn(64, 6, device="cuda", generator=gen)
    y = torch.nn.functional.one_hot(torch.randint(
        0, 3, (64,), device="cuda", generator=gen), 3).float()
    xh, yh = x.cpu().numpy(), y.cpu().numpy()

    def net():
        conf = (nn.NeuralNetConfiguration.builder().seed(3)
                .updater(train.Adam(1e-2)).list()
                .layer(nn.DenseLayer(n_in=6, n_out=16, activation="tanh"))
                .layer(nn.OutputLayer(n_in=16, n_out=3, activation="softmax",
                                      loss="mcxent")).build())
        return nn.MultiLayerNetwork(conf).init()
    a, b, c = net(), net(), net()
    a.fit(ListDataSetIterator(DataSet(xh, yh), 8), epochs=2)
    b.fit([DataSet(x[i:i + 8], y[i:i + 8]) for i in range(0, 64, 8)],
          epochs=2)
    c.fit(ListDataSetIterator(DataSet(x, y), 8), epochs=2)
    assert a._step_fn.calls["capture"] == 1
    assert a._prefetch.counts[a._prefetch.buffer] == 16
    assert c._prefetch is None and c._step_fn.calls["capture"] == 1
    assert torch.equal(a.params_flat(), b.params_flat())
    assert torch.equal(c.params_flat(), b.params_flat())


def test_cg_rnn_time_step_on_the_k4_path(gen):
    """A GravesLSTM graph (fused, K4 for the full sequence): rnn_time_step
    over single steps (a replayed graph) and over two chunks against
    output(), bf16 within 2e-2."""
    from deeplearning4j_tpu_torch import nn
    b = nn.NeuralNetConfiguration.builder().seed(4)
    b.data_type(torch.float32, torch.bfloat16)
    g = b.graph_builder().add_inputs("in")
    g.add_layer("l0", nn.GravesLSTM(n_in=11, n_out=64, fused=True), "in")
    g.add_layer("out", nn.RnnOutputLayer(n_in=64, n_out=11,
                                         activation="softmax",
                                         loss="mcxent"), "l0")
    g.set_outputs("out")
    net = nn.ComputationGraph(g.build()).init([(12, 11)])
    x = torch.randn(4, 12, 11, device="cuda", generator=gen)
    fl.reset_launches()
    full = net.output(x)
    assert fl.LAUNCHES >= 1
    net.rnn_clear_previous_state()
    stepped = torch.stack([net.rnn_time_step(x[:, t]) for t in range(12)], 1)
    assert net._rnn_stream_fn.calls["replay"] == 10
    net.rnn_clear_previous_state()
    chunked = torch.cat([net.rnn_time_step(x[:, :5]),
                         net.rnn_time_step(x[:, 5:])], 1)
    for got in (stepped, chunked):
        assert float((got.float() - full.float()).abs().max()) <= 2e-2


def test_jit_in_workspace_replayed_equals_eager(gen):
    from deeplearning4j_tpu_torch import disable_graphs, nd

    def step(acc, x, w):
        acc.add_(torch.tanh(x @ w).sum(0))
        return acc.sum()
    fn = nd.workspace.jit_in_workspace(step, donate_argnums=(0,))
    w = torch.randn(32, 32, device="cuda", generator=gen)
    xs = [torch.randn(8, 32, device="cuda", generator=gen) for _ in range(4)]
    acc, acc_e = nd.zeros(32), nd.zeros(32)
    outs = [fn(acc, x, w) for x in xs]
    with disable_graphs():
        outs_e = [step(acc_e, x, w) for x in xs]
    assert fn.compiled.calls["replay"] == 2
    assert all(torch.equal(a, b) for a, b in zip(outs, outs_e))
    assert torch.equal(acc, acc_e)
    assert nd.workspace.live_buffer_bytes() > 0
    assert "cuda:0" in nd.workspace.device_memory_stats()


# ------------------------------------------------- SameDiff and the importer

def _sd_mlp(SameDiff, device=None):
    import numpy as np
    sd = SameDiff.create(device)
    x = sd.placeholder("input", (None, 4))
    y = sd.placeholder("label", (None, 3))
    w0 = sd.var("w0", (4, 16), seed=3)
    b0 = sd.var("b0", value=np.zeros(16, np.float32))
    w1 = sd.var("w1", (16, 3), seed=4)
    h = sd.nn.relu(sd.nn.linear(x, w0, b0))
    logits = sd.nn.linear(h, w1).rename("logits")
    sd.nn.softmax(logits).rename("out")
    sd.loss.softmax_cross_entropy(y, logits).rename("loss")
    return sd


def test_samediff_eval_and_fit_replayed_equal_eager(gen):
    """eval: one capture a signature, then replays equal to the eager
    walk bit for bit; fit: a replayed trajectory equal to the eager one
    bit for bit; no hand-written kernel launched."""
    import numpy as np

    from deeplearning4j_tpu_torch import disable_graphs
    from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.train.updaters import Adam
    for m in (fa, pa, fo, fl):
        m.reset_launches()
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((32, 4)).astype(np.float32)
    labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)]
    runs = []
    for graphs in (True, False):
        sd = _sd_mlp(SameDiff)
        sd.set_loss_variables("loss")
        sd.set_training_config(TrainingConfig(
            updater=Adam(1e-2), data_set_feature_mapping=["input"],
            data_set_label_mapping=["label"]))
        ctx = contextlib.nullcontext() if graphs else disable_graphs()
        with ctx:
            outs = [sd.eval("out", {"input": feats}) for _ in range(4)]
            hist = sd.fit(iterator=[DataSet(feats, labels)] * 5)
        runs.append((outs, hist.loss_curve,
                     {k: v.detach().clone() for k, v in sd._values.items()},
                     sd))
    (og, lg, vg, sdg), (oe, le, ve, _) = runs
    calls = sdg.runner("out", {"input": feats}).compiled.calls
    assert calls["capture"] == 1 and calls["replay"] >= 2, calls
    for a in og:
        assert torch.equal(a, oe[0])
    assert lg == le
    for k in vg:
        assert torch.equal(vg[k], ve[k]), k
    assert sdg.fit_step().calls["replay"] >= 3
    assert (fa.LAUNCHES, pa.LAUNCHES, fl.LAUNCHES) == (0, 0, 0)


def test_samediff_while_loop_runs_eagerly_by_structure(gen):
    import numpy as np

    from deeplearning4j_tpu_torch.autodiff import SameDiff
    sd = SameDiff.create()
    x = sd.var("x", value=np.asarray(1.0, np.float32))
    w = sd.while_loop(lambda v: v < 100.0, lambda v: v * 2.0, x)
    y = (w * 3.0).rename("y")
    assert sd.needs_host(y)
    assert sd.runner(y).compiled is None
    assert float(sd.eval(y)) == 384.0
    plain = (x * 3.0).rename("plain")
    assert sd.runner(plain).compiled is not None


def test_phase18_holds_at_two_layers(gen):
    """chip_smoke's phase 18 at 2 layers and narrow width: the imported
    GraphDef's forward against ``bert_forward`` (1e-3), replayed = eager;
    the SameDiff-built step 1 against autograd of
    ``bert_classifier_loss`` (loss 1e-4 relative, grads 1e-3 rel-L2)."""
    import importlib.util
    from pathlib import Path

    import numpy as np

    from deeplearning4j_tpu_torch import disable_graphs
    from deeplearning4j_tpu_torch.autodiff import (SameDiff,
                                                   import_frozen_graph)
    from deeplearning4j_tpu_torch.zoo import transformer as tfm
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_cuda", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = tfm.BertConfig(vocab_size=512, d_model=64, n_heads=4, n_layers=2,
                         d_ff=128, max_seq=32, dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    params = tfm.bert_init(cfg, g, device="cuda")
    with torch.no_grad():
        params["cls"].copy_(0.1 * torch.randn(params["cls"].shape,
                                              generator=g))
    b, t = 4, 32
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, 512, (b, t), dtype=np.int32),
                          device="cuda")
    sd, _ = import_frozen_graph(cs.bert_graphdef(params, cfg, b, t))
    got = [sd.eval(["logits", "hidden"], {"ids": ids}) for _ in range(3)]
    with disable_graphs():
        eager = sd.eval(["logits", "hidden"], {"ids": ids})
    ref = tfm.bert_forward(params, cfg, ids)
    for a, e, r in zip(got[-1], eager, ref):
        assert torch.equal(a, e)
        assert float((a - r).abs().max()) <= 1e-3
    onehot = torch.nn.functional.one_hot(torch.as_tensor(
        rng.integers(0, 2, b)), 2).to("cuda", torch.float32)
    sdc = SameDiff.create()
    cs._sd_bert_graph(sdc, params, cfg, b, t)
    feeds = {"ids": ids, "labels": onehot}
    loss = float(sdc.eval("loss", feeds))
    ref_loss = float(tfm.bert_classifier_loss(params, cfg, ids, onehot))
    assert abs(loss - ref_loss) <= 1e-4 * abs(ref_loss)
    grads = sdc.grad("loss", feeds=feeds)
    leaves = dict(params)
    ps = {k: v.detach().clone().requires_grad_(True)
          for k, v in (("embed", params["embed"]),
                       ("pooler", params["pooler"]),
                       ("cls", params["cls"]))}
    full = {**leaves, **ps}
    rg = torch.autograd.grad(tfm.bert_classifier_loss(
        full, cfg, ids, onehot), list(ps.values()))
    for (k, _), r in zip(ps.items(), rg):
        err = float((grads[k] - r).norm() / r.norm().clamp_min(1e-30))
        assert err <= 1e-3, (k, err)


# every SameDiff op case on the card: the op inside a graph, its first
# call eager, its second captured, its third replayed (an op that needs
# the host runs eagerly all three times), held to the same op on the
# host; factorizations whose factors are defined up to sign or order are
# held by shape and dtype only
_SD_CARD_CASES = CASES + [("bp", op, args, kw, {"atol": 1e-4, "rtol": 1e-4})
                          for op, args, kw in BP_CASES]
_UP_TO_SIGN = {("linalg", n) for n in ("qr", "svd", "eigh", "lu",
                                       "lu_factor", "orth", "null_space",
                                       "sqrtm", "lstsq")}
_NS_ATTR = {"updater": "updaters", "assert": "assertions"}


def _on(a, device):
    from deeplearning4j_tpu_torch.autodiff import sd_ops
    if isinstance(a, (np.ndarray, np.generic)):
        return sd_ops._t(a).to(device)
    if isinstance(a, (tuple, list)) and any(
            isinstance(v, (np.ndarray, np.generic)) for v in a):
        return type(a)(_on(v, device) for v in a)
    return a


def _sd_leaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in _sd_leaves(v)]
    return [x]


@pytest.mark.parametrize("ns,op,args,kw,opts", _SD_CARD_CASES,
                         ids=[f"{c[0]}.{c[1]}_{i}" for i, c in
                              enumerate(_SD_CARD_CASES)])
def test_sd_op_on_the_card_equals_the_host(gen, ns, op, args, kw, opts,
                                           monkeypatch):
    from deeplearning4j_tpu_torch.autodiff import SameDiff
    # f32 convolutions and matmuls in f32, as on the host (TF32 would
    # part from it by ~1e-3); cuDNN's deterministic algorithms, so that a
    # replay can equal the eager call bit for bit (its default weight
    # gradient sums with atomics)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    attr = _NS_ATTR.get(ns, ns)
    host = SameDiff.create(device="cpu")
    want = host.eval(getattr(getattr(host, attr), op)(
        *[_on(a, "cpu") for a in args], **kw))
    sd = SameDiff.create()
    node = getattr(getattr(sd, attr), op)(*[_on(a, "cuda") for a in args],
                                          **kw)
    outs = [sd.eval(node) for _ in range(3)]
    run = sd.runner(node)
    if sd.needs_host(node):
        assert run.compiled is None
    else:
        assert run.compiled.calls["capture"] == 1
        assert run.compiled.calls["replay"] == 1
    wl, gl = _sd_leaves(want), _sd_leaves(outs[-1])
    assert len(wl) == len(gl)
    for w, g, first in zip(wl, gl, _sd_leaves(outs[0])):
        if not isinstance(w, torch.Tensor):
            assert w == g
            continue
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert tuple(g.shape) == tuple(w.shape)
        # the replay is the eager call's kernels on the same inputs
        assert torch.equal(g, first) or (
            g.is_floating_point() and torch.equal(g.isnan(), first.isnan())
            and torch.equal(g.nan_to_num(), first.nan_to_num()))
        if (ns, op) in _UP_TO_SIGN:
            continue
        tol = max(opts.get("atol", 1e-5), 1e-4)
        if w.dtype == torch.bool or not (w.is_floating_point()
                                         or w.is_complex()):
            assert torch.equal(g.cpu(), w), (g.cpu(), w)
        else:
            torch.testing.assert_close(g.cpu(), w, atol=tol, rtol=tol,
                                       equal_nan=True)


# ------------------------------------------- layer and zoo breadth, ONNX
def _net_tensors(net):
    from deeplearning4j_tpu_torch.nn._compiled import tensors
    return [t.detach().clone() for t in tensors((net.params, net.states,
                                                 net._opt_state))]


def _attn_conf(dtype, causal=True):
    from deeplearning4j_tpu_torch import nn, train
    b = nn.NeuralNetConfiguration.builder().seed(2).updater(train.Adam(1e-3))
    if dtype == torch.bfloat16:
        b.data_type(torch.float32, torch.bfloat16)
    return (b.list()
            .layer(nn.SelfAttentionLayer(n_out=128, n_heads=2,
                                         is_causal=causal, impl="pallas"))
            .layer(nn.RnnOutputLayer(n_out=8, activation="softmax",
                                     loss="mcxent")).build())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_layer_flash_route_matches_host(gen, dtype):
    """SelfAttentionLayer(impl="pallas") on the card launches K1, dQ and
    dK/dV once each, each on its own route (f32 D 64: all three in split
    TF32 on the narrow kernels; bf16: all three on the tensor cores) and
    agrees with the same layer on the host, forward and grads;
    a key mask takes the plain attention."""
    from deeplearning4j_tpu_torch.nn.layers.attention import \
        SelfAttentionLayer
    from deeplearning4j_tpu_torch.nn.layers.base import Ctx
    layer = SelfAttentionLayer(n_in=128, n_out=128, n_heads=2,
                               is_causal=True, impl="pallas",
                               compute_dtype=dtype)
    p, _, _ = layer.init(torch.Generator().manual_seed(0), (256, 128))
    x = torch.randn((2, 256, 128), generator=torch.Generator()
                    .manual_seed(1))
    outs = {}
    for dev in ("cpu", "cuda"):
        pd = {k: v.to(dev).requires_grad_(True) for k, v in p.items()}
        xd = x.to(dev).requires_grad_(True)
        fa.reset_launches()
        y, _ = layer.apply(pd, {}, xd, Ctx())
        grads = torch.autograd.grad(y.float().sum(), [xd, *pd.values()])
        outs[dev] = (y.float().cpu(), [g.float().cpu() for g in grads])
        if dev == "cuda":
            want = (("tf32x3",) * 3 if dtype == torch.float32
                    else ("wgmma",) * 3)
            for k, fam in zip(("fwd", "dq", "dkv"), want):
                assert fa.route(64, dtype, k) == fam
                assert _counts(k) == _added(k, 64, dtype)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(outs["cuda"][0], outs["cpu"][0], atol=tol,
                               rtol=tol)
    for a, b in zip(outs["cuda"][1], outs["cpu"][1]):
        torch.testing.assert_close(a, b, atol=tol * 10, rtol=tol * 10)
    fa.reset_launches()
    mask = torch.ones((2, 256), device="cuda")
    layer.apply({k: v.cuda() for k, v in p.items()}, {}, x.cuda(),
                Ctx(mask=mask))
    assert fa.LAUNCHES == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_net_replay_equals_eager(gen, dtype):
    """Three fit steps of a MultiLayerNetwork through the flash route,
    replayed from a CUDA graph and eager, bit for bit; the eager steps
    launch K1, dQ and dK/dV once a step each, each on its own route."""
    from deeplearning4j_tpu_torch import disable_graphs
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 256, 64)).astype(np.float32)
    y = np.eye(8, dtype=np.float32)[rng.integers(0, 8, (2, 256))]
    runs = []
    for graphs in (True, False):
        net = MultiLayerNetwork(_attn_conf(dtype)).init((256, 64))
        fa.reset_launches()
        with contextlib.nullcontext() if graphs else disable_graphs():
            losses = [net.fit(DataSet(x, y)) for _ in range(3)]
        runs.append((losses, _net_tensors(net), net._step_fn.last))
    for k in ("fwd", "dq", "dkv"):
        assert _counts(k) == [3 * n for n in _added(k, 64, dtype)]
    assert runs[0][2] == "replay" and runs[1][2] == "direct"
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_yolo2_small_on_the_card(gen, monkeypatch):
    """YOLO2 at 64×64 B2: with its BNs' ``fused=True`` (``"auto"`` leaves
    an identity BN plain) output() launches K3's bn_act once per BN (22)
    and agrees with the host; three fit steps replayed equal eager bit
    for bit."""
    from deeplearning4j_tpu_torch import disable_graphs
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.zoo import YOLO2
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    model = YOLO2(num_classes=4, input_shape=(64, 64, 3))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    host = model.init(device="cpu")
    net = model.init()
    for node in net.conf.nodes.values():
        if type(node.op).__name__ == "BatchNormalization":
            node.op.fused = True
    fo.reset_launches()
    out = net.output(x)
    assert fo.LAUNCHES == 22
    torch.testing.assert_close(out.cpu(), host.output(x), atol=1e-4,
                               rtol=1e-4)
    lab = np.zeros((2, 2, 2, 8), np.float32)
    lab[0, 1, 1, :5] = [1.1, 1.2, 1.9, 1.8, 1.0]
    runs = []
    for graphs in (True, False):
        n = model.init()
        with contextlib.nullcontext() if graphs else disable_graphs():
            losses = [n.fit(DataSet(x, lab)) for _ in range(3)]
        runs.append((losses, _net_tensors(n)))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_layer_breadth_on_the_card_equals_the_host(gen, monkeypatch):
    """The conv breadth (1-D, 3-D, transposed, depthwise, separable,
    locally connected) and ConvLSTM2D on the card against the host, f32
    without TF32."""
    from deeplearning4j_tpu_torch.nn.layers import conv, recurrent
    from deeplearning4j_tpu_torch.nn.layers.base import Ctx
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cases = [
        (conv.Convolution1DLayer(n_out=8, kernel_size=3, stride=2), (17, 4)),
        (conv.Convolution3DLayer(n_out=4, kernel_size=(3, 3, 3)),
         (5, 6, 7, 2)),
        (conv.Deconvolution2D(n_out=4, kernel_size=(3, 3), stride=(2, 2),
                              convolution_mode="same"), (5, 6, 3)),
        (conv.Deconvolution3D(n_out=3, kernel_size=(2, 3, 3),
                              stride=(2, 2, 2), convolution_mode="same"),
         (3, 4, 5, 2)),
        (conv.DepthwiseConvolution2D(depth_multiplier=2), (7, 8, 3)),
        (conv.SeparableConvolution2D(n_out=5), (7, 8, 3)),
        (conv.LocallyConnected2D(n_out=4, kernel_size=(3, 3)), (6, 7, 3)),
        (recurrent.ConvLSTM2D(n_out=3), (4, 5, 6, 2)),
    ]
    for layer, shape in cases:
        p, s, _ = layer.init(torch.Generator().manual_seed(0), shape)
        x = torch.randn((2,) + shape, generator=torch.Generator()
                        .manual_seed(1))
        want, _ = layer.apply(p, s, x, Ctx())
        got, _ = layer.apply({k: v.cuda() for k, v in p.items()}, s,
                             x.cuda(), Ctx())
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


def test_onnx_import_served_on_the_card(gen, monkeypatch):
    """An ONNX CNN imported onto the card: eval agrees with the host
    import, replays its graph, and launches no hand-written kernel."""
    import io
    import sys
    import types
    if "onnx" not in sys.modules:
        stub = types.ModuleType("onnx")
        stub.load_model_from_string = lambda b: types.SimpleNamespace(
            graph=types.SimpleNamespace(node=()))
        monkeypatch.setitem(sys.modules, "onnx", stub)
    from deeplearning4j_tpu_torch.autodiff import import_onnx
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    torch.manual_seed(0)
    model = torch.nn.Sequential(
        torch.nn.Conv2d(3, 8, 3, padding=1), torch.nn.BatchNorm2d(8),
        torch.nn.ReLU(), torch.nn.MaxPool2d(2), torch.nn.Flatten(),
        torch.nn.Linear(8 * 8 * 8, 10)).eval()
    x = torch.randn(4, 3, 16, 16)
    buf = io.BytesIO()
    torch.onnx.export(model, x, buf, opset_version=13, dynamo=False,
                      input_names=["input"], output_names=["out"])
    sd_h, outs_h = import_onnx(buf.getvalue(), device="cpu")
    sd, outs = import_onnx(buf.getvalue())
    fa.reset_launches()
    fo.reset_launches()
    got = [sd.eval(outs[0], {"input": x.numpy()}) for _ in range(3)]
    assert sd.runner(outs[0], {"input": x.numpy()}).compiled.calls[
        "replay"] >= 1
    assert fa.LAUNCHES == 0 and fo.LAUNCHES == 0
    want = sd_h.eval(outs_h[0], {"input": x.numpy()})
    assert torch.equal(got[1], got[2])
    torch.testing.assert_close(got[-1].cpu(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(want, model(x).detach(), atol=1e-4,
                               rtol=1e-4)


def _chip_smoke_module(name):
    import importlib.util
    import sys
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location(name, path)
    cs = importlib.util.module_from_spec(spec)
    # registered, so that the dataclasses the script defines resolve
    sys.modules[name] = cs
    spec.loader.exec_module(cs)
    return cs


def test_phase20_keras_resnet50_small(gen, monkeypatch, tmp_path):
    """chip_smoke's phase 20 Keras ResNet50 at 64×64 B2: imported onto
    the card (53 BNs), ``output()`` with the BNs ``fused=True`` launches
    K3's bn_act 53 times and agrees with the host import and with the
    plain BN path (1e-4); three fine-tune steps replayed equal eager bit
    for bit, each eager step launching every K3 kernel 53 times."""
    from deeplearning4j_tpu_torch import disable_graphs
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.import_ import import_keras_model
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cs = _chip_smoke_module("chip_smoke_phase20")
    path = tmp_path / "resnet50.h5"
    cs.write_keras_resnet50(path, hw=64)
    rng = np.random.default_rng(0)
    x = rng.random((2, 64, 64, 3)).astype(np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, 2)]
    host = import_keras_model(path, device="cpu")
    net = import_keras_model(path)
    cs._set_fused(net, True)
    fo.reset_launches()
    out = net.output(x)
    torch.cuda.synchronize()
    assert fo.LAUNCHES == 53 and fo.LAUNCHES_STATS == 0
    torch.testing.assert_close(out.cpu(), host.output(x), atol=1e-4,
                               rtol=1e-4)
    cs._set_fused(net, False)
    net._infer_fn = None
    torch.testing.assert_close(out, net.output(x), atol=1e-4, rtol=1e-4)
    runs = []
    for graphs in (True, False):
        src = import_keras_model(path)
        cs._set_fused(src, True)
        n = cs.keras_finetune_net(src)
        fo.reset_launches()
        with contextlib.nullcontext() if graphs else disable_graphs():
            losses = [n.fit(DataSet(x, y)) for _ in range(3)]
        torch.cuda.synchronize()
        if not graphs:
            assert (fo.LAUNCHES, fo.LAUNCHES_STATS, fo.LAUNCHES_BWD_REDUCE,
                    fo.LAUNCHES_BWD_DX) == (3 * 53,) * 4
        runs.append((losses, _net_tensors(n)))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_phase20_charnn_upstream_zip_small(gen, tmp_path):
    """The char-RNN (T 8) fitted 2 steps on K4, written as an upstream
    DL4J zip with its Adam state and restored by ``load_model``: its
    output equals the writer's bit for bit, K4 twice a forward, and its
    step 3 equals the writer's (params, states, updater state)."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.serde import (load_model,
                                                write_model_upstream_format)
    from deeplearning4j_tpu_torch.train import Adam
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    v, t = 11, 8
    rng = np.random.default_rng(0)
    eye = np.eye(v, dtype=np.float32)
    x = eye[rng.integers(0, v, (16, t))]
    y = eye[rng.integers(0, v, (16, t))]
    net = TextGenerationLSTM(num_classes=v, input_shape=(t, v), units=32,
                             updater=Adam(1e-3)).init()
    for layer in net.layers[:2]:
        layer.fused = True
    for _ in range(2):
        net.fit(DataSet(x, y))
    path = tmp_path / "charnn.zip"
    write_model_upstream_format(net, path, save_updater=True)
    restored = load_model(path)
    assert type(restored).__name__ == "MultiLayerNetwork"
    for layer in restored.layers[:2]:
        layer.fused = True
    fl.reset_launches()
    out = restored.output(x)
    torch.cuda.synchronize()
    assert fl.LAUNCHES == 2
    assert torch.equal(out, net.output(x))
    assert net.fit(DataSet(x, y)) == restored.fit(DataSet(x, y))
    assert all(torch.equal(a, b) for a, b in zip(_net_tensors(net),
                                                 _net_tensors(restored)))


def test_phase20_samediff_layer_mln_replay_equals_eager(gen):
    cs = _chip_smoke_module("chip_smoke_phase20_sd")
    failed = []
    rec = cs.import_samediff_layer(failed)
    assert not failed, failed
    assert rec["replay_equals_eager"]


# ------------------------------------------------ parallel (one card)

def _world_of_one():
    """``make_mesh(dp=1)``: the NCCL world of one it starts (or the world
    already started)."""
    from deeplearning4j_tpu_torch.parallel import make_mesh
    return make_mesh(dp=1)


@pytest.mark.parametrize("act", ["relu", "identity"])
def test_parallel_global_bn_k3_sums_on_a_world_of_one(gen, act):
    """K3's global-batch path over the NCCL world of one: its summed
    stats and backward sums are the kernel's own (mean, var, y, dx,
    dgamma, dbeta equal to the local path), inside a captured graph too
    (replay equal to the eager call bit for bit)."""
    import torch.distributed as dist
    mesh = _world_of_one()
    assert dist.get_backend() == "nccl"
    group = mesh.group("dp")
    n, c = 4096, 256
    x = torch.randn((n, c), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    gamma, beta, center = (torch.randn(c, generator=gen, device="cuda")
                           for _ in range(3))
    gy = torch.randn((n, c), generator=gen, device="cuda",
                     dtype=torch.bfloat16)

    def run(grp):
        xs, gs, bs = (t.detach().clone().requires_grad_()
                      for t in (x, gamma, beta))
        y, mean, var = fo.fused_bn_act_train(xs, gs, bs, center, 1e-5, act,
                                             grp)
        return (y, mean, var, *torch.autograd.grad(y, (xs, gs, bs), gy))

    local, glob = run(None), run(group)
    for a, b in zip(local, glob):
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-5,
                                   atol=1e-5)
    # captured: the all-reduces inside the graph
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = run(group)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # on the stream the eager call ran on: K3's arrival counters are
    # allocated per stream, before a capture
    with torch.cuda.graph(graph, stream=side):
        static = run(group)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(eager, static):
        assert torch.equal(a, b)


def test_parallel_wrapper_replays_bn_net_on_a_world_of_one(gen):
    """ParallelWrapper over make_mesh(dp=1) (NCCL) trains a conv + fused BN
    graph with its steps replayed from a CUDA graph, bit for bit the
    eager steps', K3's four kernels once each a step."""
    from deeplearning4j_tpu_torch import disable_graphs
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn import (BatchNormalization,
                                             ComputationGraph,
                                             ConvolutionLayer, InputType,
                                             NeuralNetConfiguration,
                                             OutputLayer)
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.train import Sgd
    mesh = _world_of_one()

    def net():
        g = (NeuralNetConfiguration.builder().seed(3).updater(Sgd(0.1))
             .graph_builder().add_inputs("in"))
        g.add_layer("c", ConvolutionLayer(n_out=64, kernel_size=(3, 3),
                                          convolution_mode="same"), "in")
        g.add_layer("bn", BatchNormalization(activation="relu", fused=True),
                    "c")
        g.add_layer("out", OutputLayer(n_out=10, activation="softmax",
                                       loss="mcxent"), "bn")
        g.set_outputs("out")
        g.set_input_types(InputType.convolutional(16, 16, 8))
        return ComputationGraph(g.build()).init()

    x = torch.randn((32, 16, 16, 8), generator=gen, device="cuda")
    y = torch.eye(10, device="cuda")[torch.randint(
        0, 10, (32,), generator=gen, device="cuda")]
    ds = DataSet(x, y)
    a, b = net(), net()
    pa_, pb_ = ParallelWrapper(a, mesh), ParallelWrapper(b, mesh)
    assert pa_.graphs.startswith("captured")
    fo.reset_launches()
    losses_a = [pa_.fit([ds]) for _ in range(4)]
    assert pa_._step.calls["replay"] == 2
    assert (fo.LAUNCHES, fo.LAUNCHES_STATS, fo.LAUNCHES_BWD_REDUCE,
            fo.LAUNCHES_BWD_DX) == (2, 2, 2, 2)   # eager step + capture
    with disable_graphs():
        losses_b = [pb_.fit([ds]) for _ in range(4)]
    assert losses_a == losses_b
    from deeplearning4j_tpu_torch.nn._compiled import tensors
    for s, t in zip(tensors((a.params, a.states)),
                    tensors((b.params, b.states))):
        assert torch.equal(s, t)


@pytest.mark.parametrize("t,use_flash", [(2048, True), (512, "auto"),
                                         (256, False)])
def test_parallel_ring_hop_merge_on_k1(gen, t, use_flash):
    """ring_hop over two chunks of a causal sequence (K1 through its lse,
    merged by logaddexp) against one K1: output, lse and the q/k/v
    gradients of a loss that reads both (a nonzero lse cotangent into dQ
    and dK/dV). K1 runs on CUDA tensors at any chunk length and
    ``use_flash``."""
    from deeplearning4j_tpu_torch.parallel.ring_attention import ring_hop
    b, h, d = 2, 4, 64
    q, k, v, go = (torch.randn((b, t, h, d), generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    gl = torch.randn((b, h, t), generator=gen, device="cuda")
    q, k, v = (a.requires_grad_() for a in (q, k, v))
    c = t // 2
    fa.reset_launches()
    parts = []
    for i in range(2):
        acc = None
        for j in range(i, -1, -1):
            acc = ring_hop(acc, q[:, i * c:(i + 1) * c],
                           k[:, j * c:(j + 1) * c], v[:, j * c:(j + 1) * c],
                           "diag" if i == j else "full",
                           use_flash=use_flash)
        parts.append(acc)
    out = torch.cat([p[0] for p in parts], 1)
    lse = torch.cat([p[1] for p in parts], 2)
    grads = torch.autograd.grad((out * go.float()).sum() + (lse * gl).sum(),
                                (q, k, v))
    assert (fa.LAUNCHES, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKV) == \
        (3, 3, 3)
    ref, ref_lse = fa._dispatch(q, k, v, None, True, "bthd")
    ref_grads = torch.autograd.grad(
        (ref.float() * go.float()).sum() + (ref_lse * gl).sum(), (q, k, v))
    assert (out - ref.float()).abs().max().item() <= ATOL[torch.bfloat16]
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    for a, r in zip(grads, ref_grads):
        rel = ((a.float() - r.float()).norm() / r.float().norm()).item()
        assert rel <= 1e-2, rel


def test_parallel_offset_causal_attention_runs_k1(gen):
    """A sequence-split block's attention over the gathered keys (the sp
    path without the ring): block 2 of 4 at T 256 a block, as the ring's
    hops over blocks 2, 1 and 0 on K1, equals those rows of one causal K1
    over the whole sequence, output and q/k/v grads."""
    from deeplearning4j_tpu_torch.zoo import transformer as tfm
    b, t, h, d, n, idx = 2, 256, 4, 64, 4, 2
    q, k, v, go = (torch.randn((b, n * t, h, d), generator=gen,
                               device="cuda", dtype=torch.bfloat16)
                   for _ in range(4))
    q, k, v = (a.requires_grad_() for a in (q, k, v))
    rows = slice(idx * t, (idx + 1) * t)
    fa.reset_launches()
    out = tfm._offset_causal_attention(q[:, rows], k, v, idx)
    grads = torch.autograd.grad(out, (q, k, v), go[:, rows])
    assert (fa.LAUNCHES, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKV) == \
        (idx + 1,) * 3
    ref = fa.flash_attention_ntc(q, k, v, causal=True)[:, rows]
    ref_grads = torch.autograd.grad(ref, (q, k, v), go[:, rows])
    assert (out.float() - ref.float()).abs().max().item() \
        <= ATOL[torch.bfloat16]
    for a, r in zip(grads, ref_grads):
        rel = ((a.float() - r.float()).norm() / r.float().norm()).item()
        assert rel <= 1e-2, rel


def test_parallel_ring_inner_without_a_group_runs_k1(gen):
    """ring_attention_inner with no sp group active: one K1 over the whole
    sequence, whatever ``use_flash``."""
    from deeplearning4j_tpu_torch.parallel.ring_attention import \
        ring_attention_inner
    q, k, v = (torch.randn((2, 128, 4, 64), generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    fa.reset_launches()
    out = ring_attention_inner(q, k, v, causal=True, use_flash=False)
    assert fa.LAUNCHES == 1
    assert torch.equal(out, fa.flash_attention_ntc(q, k, v, causal=True))


def test_parallel_moe_train_step_replay_equals_eager(gen):
    """The MoE LM's compiled step (index dispatch, flash attention) on the
    card: replayed from a CUDA graph, bit for bit its eager steps."""
    from deeplearning4j_tpu_torch import disable_graphs
    from deeplearning4j_tpu_torch.zoo import transformer as tfm
    cfg = tfm.TransformerConfig(vocab_size=512, d_model=128, n_heads=2,
                                n_layers=2, d_ff=256, max_seq=256,
                                n_experts=4, use_flash_attention=True)
    init = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    ids = torch.randint(0, 512, (4, 256), generator=gen, device="cuda")
    tgt = torch.randint(0, 512, (4, 256), generator=gen, device="cuda")
    runs = []
    for graphs in (True, False):
        params = {kk: (vv.clone() if torch.is_tensor(vv) else
                       {n: w.clone() for n, w in vv.items()})
                  for kk, vv in init.items()}
        opt = torch.optim.AdamW(tfm.param_leaves(params), lr=1e-3,
                                capturable=True, fused=True)
        step = tfm.make_train_step(cfg, opt)
        with contextlib.nullcontext() if graphs else disable_graphs():
            losses = [step(params, ids, tgt).item() for _ in range(4)]
        if graphs:
            assert step.compiled.calls["replay"] == 2
        runs.append((losses, [p.detach().clone()
                              for p in tfm.param_leaves(params)]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


# ------------------------------------------- scale-out threads, the fleet

def _bn_cg(seed=3):
    from deeplearning4j_tpu_torch.nn import (BatchNormalization,
                                             ComputationGraph,
                                             ConvolutionLayer, InputType,
                                             NeuralNetConfiguration,
                                             OutputLayer)
    from deeplearning4j_tpu_torch.train import Sgd
    g = (NeuralNetConfiguration.builder().seed(seed).updater(Sgd(0.1))
         .graph_builder().add_inputs("in"))
    g.add_layer("c", ConvolutionLayer(n_out=64, kernel_size=(3, 3),
                                      convolution_mode="same"), "in")
    g.add_layer("bn", BatchNormalization(activation="relu", fused=True),
                "c")
    g.add_layer("out", OutputLayer(n_out=10, activation="softmax",
                                   loss="mcxent"), "bn")
    g.set_outputs("out")
    g.set_input_types(InputType.convolutional(16, 16, 8))
    return ComputationGraph(g.build()).init()


def test_scaleout_threads_capture_and_replay_bit_identical(gen):
    """Two threads each fit their own clone through eager, capture and
    replay at the same time, with their schedules offset by one step:
    thread B first takes an eager step on a batch of another shape, so
    that a barrier before every step starts A's capture with B's first
    eager step of A's shape (its allocations and its loss's host read),
    and B's capture with A's replay. Every clone ends bit for bit where
    the same fits run one after the other end, and each captured once."""
    import threading
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn._compiled import tensors
    net = _bn_cg()

    def batch(n):
        return DataSet(torch.randn((n, 16, 16, 8), generator=gen,
                                   device="cuda"),
                       torch.eye(10, device="cuda")[torch.randint(
                           0, 10, (n,), generator=gen, device="cuda")])
    batches = [[batch(32) for _ in range(6)],
               [batch(16)] + [batch(32) for _ in range(5)]]

    def fit(clone, mine, barrier=None):
        out = []
        for ds in mine:
            if barrier is not None:
                barrier.wait(timeout=60)
            out.append(clone.fit(ds))
        return out

    seq = [net.clone(), net.clone()]
    seq_losses = [fit(c, b) for c, b in zip(seq, batches)]
    par = [net.clone(), net.clone()]
    par_losses, errs = [None, None], []
    barrier = threading.Barrier(2)

    def run(i):
        try:
            par_losses[i] = fit(par[i], batches[i], barrier)
        except BaseException as e:          # noqa: BLE001 — asserted
            errs.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and errs == [], errs
    assert par_losses == seq_losses
    for a, b in zip(seq, par):
        for s, t in zip(tensors((a.params, a.states)),
                        tensors((b.params, b.states))):
            assert torch.equal(s, t)
    # A: eager, capture, 4 replays; B: one eager step at B16, then at B32
    # eager, capture, 3 replays
    want = [{"eager": 1, "capture": 1, "replay": 4},
            {"eager": 2, "capture": 1, "replay": 3}]
    for b, w in zip(par, want):
        calls = b._step_fn.calls
        assert {k: calls[k] for k in w} == w, calls


def _fleet_engine(dtype=torch.float32):
    from deeplearning4j_tpu_torch.serving import GenerationEngine
    from deeplearning4j_tpu_torch.zoo import transformer as tfm
    cfg = tfm.TransformerConfig(vocab_size=61, d_model=64, n_heads=2,
                                n_layers=2, d_ff=128, max_seq=64,
                                dtype=dtype, remat=False,
                                attn_scores_bf16=False)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cuda")
    return GenerationEngine(cfg, params, device="cuda")


def _fleet_prompts(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 61, size=int(rng.integers(4, 20)))
            .astype(np.int32) for _ in range(n)]


def test_fleet_kill_reprefills_to_the_oracle_on_the_card(gen):
    """An f32 fleet of two paged replicas on the card (decode through K2):
    the busier replica killed mid-decode (the only replica dead after),
    its requests re-prefilled on the survivor, every request's tokens
    equal ``engine.generate``'s."""
    from deeplearning4j_tpu_torch.serving import FleetRouter
    eng = _fleet_engine()
    router = FleetRouter(eng, n_replicas=2, n_slots=4,
                         scheduler_kwargs={"page_len": 8, "n_pages": 64})
    prompts = _fleet_prompts(8, seed=1)
    pa.reset_launches()
    futs = [router.submit(p, 10) for p in prompts]
    for _ in range(4):
        router.step()
    held = {}
    for rec in router.outstanding.values():
        held[rec.rid] = held.get(rec.rid, 0) + 1
    killed = max(held, key=lambda r: held[r])
    moved = router.kill_replica(killed)
    assert moved
    router.run_until_idle()
    # the router kills a replica whose step raises: none but this one
    assert [r.rid for r in router.replicas.values()
            if r.status == "dead"] == [killed]
    assert pa.LAUNCHES > 0
    for p, f in zip(prompts, futs):
        np.testing.assert_array_equal(
            f.result(timeout=60).tokens,
            np.asarray(eng.generate(p, 10)).reshape(-1))
    assert router.leases.all_done() and router.ghost_results == 0


def test_fleet_spawn_kill_retire_frees_pools_and_graphs(gen):
    """A replica spawned, served (its signatures captured on its own
    pool), then killed or retired, three times: each time its pool's
    tensors are freed, the engine's graphs fall back to the live
    replica's, and the card's allocated memory does not grow."""
    import gc
    import weakref
    from deeplearning4j_tpu_torch.serving import FleetRouter
    eng = _fleet_engine()
    # a pool of 4 MiB, so that a leaked one shows against the slack
    router = FleetRouter(eng, n_replicas=1, n_slots=4,
                         scheduler_kwargs={"page_len": 8, "n_pages": 512})

    def serve(seed):
        futs = [router.submit(p, 6) for p in _fleet_prompts(4, seed)]
        router.run_until_idle()
        assert all(f.result(timeout=60).finish_reason in ("eos", "length")
                   for f in futs)

    def graphs():
        return sum(len(s._graphs) for s in eng.sentinels.values())

    for seed in range(2):               # the live replica: warm, captured
        serve(seed)
    gc.collect()
    base_graphs, base_mem = graphs(), None
    for cycle in range(3):
        with router._lock:
            rid = router._spawn_locked(reason="test")
        pool = [weakref.ref(t) for t in router.replicas[rid].scheduler
                .cache.values() if isinstance(t, torch.Tensor)]
        for seed in range(3):
            serve(10 * cycle + seed)
        assert graphs() > base_graphs
        if cycle % 2:
            router.retire_replica(rid)
        else:
            router.kill_replica(rid)
        gc.collect()
        torch.cuda.synchronize()
        assert all(r() is None for r in pool), cycle
        assert graphs() == base_graphs, (cycle, graphs(), base_graphs)
        mem = torch.cuda.memory_allocated()
        if base_mem is None:
            base_mem = mem
        assert mem <= base_mem + (256 << 10), (cycle, mem, base_mem)
