"""The wide flash backward (dQ and dK/dV at head dims 257-512) on the CPU,
against the JAX package's Pallas backward in interpret mode.

The kernels run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Here each one's schedule is emulated in torch as the
kernel runs it, and held to ``jax.vjp`` through the JAX package's Pallas
backward kernels at D 264, 320, 328, 384, 392 and 512, causal and not, at
T 200 (a ragged last tile), on the same seeded inputs:

- bf16 dQ (``flash_bwd_dq_wgmma_split_kernel`` on ``DqSplitCfg``): padded to
  384 or 512; per 64-query tile, 32-key steps at 384 and 16-key steps at
  512; S and dP as the f32 partials of the two column halves added half
  0 + half 1; bf16 dS; each half of dQ's columns on its own;
- bf16 dK/dV (``flash_bwd_dkv_wgmma_cluster_kernel``): a cluster of two
  CTAs whose four warpgroups own a quarter of the columns each; per
  64-key tile, 32-query steps; Sᵀ and dPᵀ as the four quarters' partials
  summed (u0 + u1) + (u2 + u3); bf16 Pᵀ and dSᵀ; each quarter of dK and
  dV on its own;
- f32 dQ and dK/dV (``flash_bwd_*_tf32x3_kernel`` on ``Tf32DqCfg`` and
  ``Tf32DkvCfg`` with a cluster of two CTAs that split the columns):
  padded to 320, 384 or 512,
  the padded-256 kernels' schedules (32-query tiles with four 8-key
  partials a step; 32-key tiles with two 16-query partials a step) with
  S, dP (Sᵀ, dPᵀ) the sum of the two CTAs' halves, every product in
  three TF32 products.

The bars are the card's: bf16 grads relative L2 1e-2, f32 atol 1e-4. The
shared-memory configs are read from the csrc, the routes pinned, the
cluster's quarter tiles checked against the wgmma descriptors lane by
lane.
"""

from __future__ import annotations

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.kernels import flash_attention as tfa
from test_torch_kernels import (_csrc_smem, _elem, _hw_k_major,
                                _hw_mn_major, _lanes, _mm_tf32,
                                _mma_m16n8k8, _quarter_conflicts, _swz)

# the JAX package re-exports the flash_attention FUNCTION under the
# module's name; import_module reaches the module itself
jfa = importlib.import_module("deeplearning4j_tpu.kernels.flash_attention")

torch.set_num_threads(2)

WIDE_DIMS = [264, 320, 328, 384, 392, 512]
T = 200
BF16_REL_L2 = 1e-2
F32_ATOL = 1e-4
LOG2E = math.log2(math.e)


def _padded(d, f32=False):
    """The width the wide kernels run head dim ``d`` at: 384 or 512
    (csrc/flash_mma.cuh ``wide_padded_dim``), f32 also 320."""
    return 320 if f32 and d <= 320 else 384 if d <= 384 else 512


def _case(d, dtype, causal, seed):
    """Seeded (1, 2, T, d) q, k, v, dO in ``dtype``; the plain forward's
    O and lse on them and delta = rowsum(dO·O) in f32, as the Function
    computes them; and jax.vjp's (dq, dk, dv) through the JAX package's
    Pallas kernels (interpret mode, 40-row blocks) on the same inputs."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((1, 2, T, d)).astype(np.float32)
              for _ in range(4)]
    q, k, v, do = (torch.as_tensor(a).to(dtype) for a in arrays)
    o, lse = tfa.mha_reference_lse(q, k, v, causal=causal)
    delta = (do.float() * o.float()).sum(-1)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx = [jnp.asarray(t.float().numpy()).astype(jdt) for t in (q, k, v, do)]
    _, vjp = jax.vjp(lambda *xs: jfa.flash_attention(
        *xs, causal=causal, block_q=40, block_k=40, interpret=True), *jx[:3])
    ref = [torch.as_tensor(np.array(g.astype(jnp.float32)))
           for g in vjp(jx[3])]
    return (q, k, v, do), lse, delta, ref


def _pad(xs, dp):
    return [torch.nn.functional.pad(x.float(), (0, dp - x.shape[-1]))
            for x in xs]


def _p(s, lse, scale, rows, keys, causal):
    """P = exp2(S·scale·log2 e − lse·log2 e) on (.., rows, keys) scores,
    0 above the diagonal when causal."""
    p = torch.exp2(s * (scale * LOG2E) - lse[..., :, None] * LOG2E)
    if causal:
        p = torch.where(keys[None, :] <= rows[:, None], p, torch.zeros(()))
    return p


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _wgmma_wide_dq_emulation(q, k, v, do, lse, delta, scale, causal):
    """bf16 dQ on two warpgroups past D 256: padded to 384 (32-key steps)
    or 512 (16-key steps); per 64-query tile and key step up to the
    diagonal, S and dP as half 0's partial + half 1's; dS rounded to bf16;
    dQ's halves each += bf16(dS)·K[:, half]."""
    t, d = q.shape[-2:]
    dp = _padded(d)
    bk = 32 if dp == 384 else 16
    qf, kf, vf, dof = _pad((q, k, v, do), dp)
    halves = (slice(0, dp // 2), slice(dp // 2, dp))
    dq = torch.zeros(qf.shape)
    for q0 in range(0, t, 64):
        qs = slice(q0, min(q0 + 64, t))
        rows = torch.arange(q0, qs.stop)
        for k0 in range(0, min(t, q0 + 64) if causal else t, bk):
            ks = slice(k0, min(k0 + bk, t))
            s, dpp = (
                sum(a[..., qs, c] @ b[..., ks, c].transpose(-1, -2)
                    for c in halves)
                for a, b in ((qf, kf), (dof, vf)))
            p = _p(s, lse[..., qs], scale, rows, torch.arange(k0, ks.stop),
                   causal)
            ds = _bf16(p * (dpp - delta[..., qs, None]) * scale)
            for c in halves:
                dq[..., qs, c] += ds @ kf[..., ks, c]
    return dq[..., :d].to(torch.bfloat16)


def _wgmma_wide_dkv_emulation(q, k, v, do, lse, delta, scale, causal):
    """bf16 dK/dV on a cluster of two CTAs, four warpgroups: padded to 384
    or 512, quarter u of the columns (D / 4 of them) to warpgroup u % 2 of
    CTA u // 2; per 64-key tile and 32-query step (from the tile's first
    key down when causal), Sᵀ and dPᵀ as (u0 + u1) + (u2 + u3) of the
    quarters' partials; Pᵀ and dSᵀ rounded to bf16; each quarter of dV
    += bf16(Pᵀ)·dO and of dK += bf16(dSᵀ)·Q on its own."""
    t, d = q.shape[-2:]
    dp = _padded(d)
    dw = dp // 4
    qf, kf, vf, dof = _pad((q, k, v, do), dp)
    quarters = [slice(u * dw, (u + 1) * dw) for u in range(4)]
    dk, dv = torch.zeros(kf.shape), torch.zeros(vf.shape)
    for k0 in range(0, t, 64):
        ks = slice(k0, min(k0 + 64, t))
        keys = torch.arange(k0, ks.stop)
        for i0 in range(k0 if causal else 0, t, 32):
            qs = slice(i0, min(i0 + 32, t))
            st, dpt = (
                [a[..., ks, c] @ b[..., qs, c].transpose(-1, -2)
                 for c in quarters]
                for a, b in ((kf, qf), (vf, dof)))
            st, dpt = ((x[0] + x[1]) + (x[2] + x[3]) for x in (st, dpt))
            # (keys, queries): the mask of _p with rows and keys swapped
            pt = _p(st.transpose(-1, -2), lse[..., qs], scale,
                    torch.arange(i0, qs.stop), keys, causal) \
                .transpose(-1, -2)
            dst = _bf16(pt * (dpt - delta[..., None, qs]) * scale)
            pt = _bf16(pt)
            for c in quarters:
                dv[..., ks, c] += pt @ dof[..., qs, c]
                dk[..., ks, c] += dst @ qf[..., qs, c]
    return dk[..., :d].to(torch.bfloat16), dv[..., :d].to(torch.bfloat16)


def _tf32x3_wide_emulation(q, k, v, do, lse, delta, scale, causal,
                           passes=3):
    """f32 dQ and dK/dV on a cluster of two CTAs that split the columns:
    padded to 320, 384 or 512, CTA c holding columns [c DP / 2, (c + 1)
    DP / 2); every product in split TF32 (``passes`` 3; 1: one product of
    the rounded operands). dQ: per 32-query tile and 32-key step, one
    partial per 8 keys: S and dP each CTA 0's half + CTA 1's, P masked,
    dS = P∘(dP − delta)·scale, partial += dS·K; the four summed 0 + 1 +
    2 + 3. dK/dV: per 32-key tile and 32-query step, one partial of each
    output per 16 queries: Sᵀ and dPᵀ each half 0 + half 1, dV += Pᵀ·dO,
    dK += dSᵀ·Q; the two summed 0 + 1. Returns dq, dk, dv."""
    t, d = q.shape[-2:]
    dp = _padded(d, f32=True)
    qf, kf, vf, dof = _pad((q, k, v, do), dp)
    halves = (slice(0, dp // 2), slice(dp // 2, dp))

    def mm(a, b):
        return _mm_tf32(a, b, passes)

    def over_halves(a, b):             # a·bᵀ, summed CTA 0 + CTA 1
        return sum(mm(a[..., c], b[..., c].transpose(-1, -2))
                   for c in halves)

    dq = torch.zeros(qf.shape)
    for q0 in range(0, t, 32):
        qs = slice(q0, min(q0 + 32, t))
        rows = torch.arange(q0, qs.stop)
        parts = [torch.zeros(qf[..., qs, :].shape) for _ in range(4)]
        for k0 in range(0, min(t, q0 + 32) if causal else t, 32):
            for part in range(4):
                ks = slice(k0 + 8 * part, min(k0 + 8 * part + 8, t))
                if ks.start >= t:       # zero-filled keys, masked
                    continue
                p = _p(over_halves(qf[..., qs, :], kf[..., ks, :]),
                       lse[..., qs], scale, rows,
                       torch.arange(ks.start, ks.stop), causal)
                dpp = over_halves(dof[..., qs, :], vf[..., ks, :])
                parts[part] += mm(p * (dpp - delta[..., qs, None]) * scale,
                                  kf[..., ks, :])
        dq[..., qs, :] = ((parts[0] + parts[1]) + parts[2]) + parts[3]

    dk, dv = torch.zeros(kf.shape), torch.zeros(vf.shape)
    for k0 in range(0, t, 32):
        ks = slice(k0, min(k0 + 32, t))
        keys = torch.arange(k0, ks.stop)
        kt, vt = kf[..., ks, :], vf[..., ks, :]
        pk = [torch.zeros(kt.shape) for _ in range(2)]
        pv = [torch.zeros(kt.shape) for _ in range(2)]
        for i0 in range(k0 if causal else 0, t, 32):
            for half in (0, 1):
                qs = slice(i0 + 16 * half, min(i0 + 16 * half + 16, t))
                if qs.start >= t:       # zero-filled queries, masked
                    continue
                qt, dot = qf[..., qs, :], dof[..., qs, :]
                # Sᵀ = K·Qᵀ, masked on its transpose
                pt = _p(over_halves(kt, qt).transpose(-1, -2), lse[..., qs],
                        scale, torch.arange(qs.start, qs.stop), keys,
                        causal).transpose(-1, -2)
                pv[half] += mm(pt, dot)
                dpt = over_halves(vt, dot)
                pk[half] += mm(pt * (dpt - delta[..., None, qs]) * scale, qt)
        dk[..., ks, :] = pk[0] + pk[1]
        dv[..., ks, :] = pv[0] + pv[1]
    return dq[..., :d], dk[..., :d], dv[..., :d]


def _rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_wgmma_wide_bwd_schedules_match_jax_pallas(d, causal):
    """bf16 dQ (two warpgroups, column halves, 32- or 16-key steps) and
    dK/dV (a cluster of two CTAs, column quarters, 32-query steps),
    emulated on their schedules, against jax.vjp through the JAX
    package's Pallas backward in interpret mode on the same bf16 inputs:
    each grad within relative L2 1e-2."""
    assert [tfa.route(d, torch.bfloat16, kn) for kn in ("dq", "dkv")] \
        == ["wgmma-wide"] * 2
    (q, k, v, do), lse, delta, ref = _case(d, torch.bfloat16, causal,
                                           seed=d + 20)
    scale = d ** -0.5
    dq = _wgmma_wide_dq_emulation(q, k, v, do, lse, delta, scale, causal)
    dk, dv = _wgmma_wide_dkv_emulation(q, k, v, do, lse, delta, scale,
                                       causal)
    for got, want in zip((dq, dk, dv), ref):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert _rel_l2(got, want) <= BF16_REL_L2


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_tf32x3_wide_bwd_schedules_match_jax_pallas(d, causal):
    """f32 dQ and dK/dV in split TF32 on a cluster of two CTAs that split
    the columns (S, dP the sum of the CTAs' halves), emulated on their
    schedules, against jax.vjp through the JAX package's Pallas backward
    in interpret mode: each grad within the f32 atol 1e-4."""
    assert [tfa.route(d, torch.float32, kn) for kn in ("dq", "dkv")] \
        == ["tf32x3-wide"] * 2
    (q, k, v, do), lse, delta, ref = _case(d, torch.float32, causal,
                                           seed=d + 21)
    got = _tf32x3_wide_emulation(q, k, v, do, lse, delta, d ** -0.5, causal)
    for g, want in zip(got, ref):
        assert g.shape == want.shape
        assert (g - want).abs().max().item() <= F32_ATOL


@pytest.mark.parametrize("d", [320, 512])
def test_one_tf32_product_misses_the_wide_backward_bar(d):
    """Why the f32 wide backward keeps three TF32 products: one product of
    the rounded operands misses the f32 atol of 1e-4 at D 320 and 512."""
    (q, k, v, do), lse, delta, ref = _case(d, torch.float32, True,
                                           seed=d + 22)
    one = _tf32x3_wide_emulation(q, k, v, do, lse, delta, d ** -0.5, True,
                                 passes=1)
    assert max((g - r).abs().max().item() for g, r in zip(one, ref)) \
        > F32_ATOL


def test_wide_backward_routes_follow_the_forward():
    """dQ and dK/dV take the forward's wide families at every D in
    257-512: bf16 a multiple of 8 (264-512) ``wgmma-wide``, f32
    ``tf32x3-wide``; ``general`` only past 512 and for bf16 D % 8 != 0;
    and a bf16 wide backward checks its operands' 16-byte alignment."""
    for d in range(129, 530):
        for dtype in (torch.bfloat16, torch.float32):
            kinds = {tfa.route(d, dtype, kn) for kn in ("fwd", "dq", "dkv")}
            assert len(kinds) == 1
            (kind,) = kinds
            if d > 512 or (dtype == torch.bfloat16 and d % 8):
                assert kind == "general"
            elif d > 256:
                assert kind == ("wgmma-wide" if dtype == torch.bfloat16
                                else "tf32x3-wide")
    assert "wgmma-wide" in tfa.TC_FAMILIES
    for kernel in ("dq", "dkv"):
        for fam in ("wgmma-wide", "tf32x3-wide"):
            assert hasattr(tfa, tfa.launch_counter(kernel, fam))


@pytest.mark.parametrize("struct, params, kib", [
    ("DqSplitCfg", {"DP": 384, "KB": 32}, 209),
    ("DqSplitCfg", {"DP": 512, "KB": 16}, 201),
    ("DkvClusterCfg", {"DW": 96}, 193.5),
    ("DkvClusterCfg", {"DW": 128}, 193.5),
    ("Tf32DqCfg", {"DP": 320, "CTAS": 2}, 136),
    ("Tf32DqCfg", {"DP": 384, "CTAS": 2}, 160),
    ("Tf32DqCfg", {"DP": 512, "CTAS": 2}, 208),
    ("Tf32DkvCfg", {"DP": 320, "CTAS": 2}, 140.5),
    ("Tf32DkvCfg", {"DP": 384, "CTAS": 2}, 164.5),
    ("Tf32DkvCfg", {"DP": 512, "CTAS": 2}, 212.5),
])
def test_wide_backward_configs_fit_shared_memory(struct, params, kib):
    """The wide backward's shared memory, read from the csrc configs: the
    bf16 dQ's resident Q and dO, two stages of K and V (32 keys at 384, 16
    at 512) and its exchange; a cluster CTA of the bf16 dK/dV (its two
    quarters of K and V, two stages of Q and dO at 32 queries, the
    double-buffered exchange of Sᵀ and dPᵀ partials, the lse and delta
    rows); a cluster CTA of the f32 dQ and dK/dV (the padded-256 blocks'
    tiles at half the columns, plus a 16 KiB exchange); each within the
    227 KiB a block may use."""
    smem = _csrc_smem(struct, **params)
    assert smem == kib * 1024
    assert smem <= tfa.SMEM_PER_BLOCK == 232448


@pytest.mark.parametrize("dw", [96, 128])
def test_cluster_quarter_tiles_match_wgmma_descriptors(dw):
    """The bf16 dK/dV cluster's tiles lane by lane: the loader puts global
    8-column chunk (2 rank + w) dw / 8 + j of a row at chunk 16 w + j of
    CTA ``rank``'s 256-column tile, so every real chunk of the padded D
    (4 dw columns) lands in exactly one CTA; quarter u = 2 rank + w is
    read as the K-major operand of its partials (dw / 16 k-steps from
    panel 2 w) and as the MN-major B operand of its dV and dK products
    (N = dw from panel 2 w), at exactly the global columns u dw .. (u + 1)
    dw, on the hardware's 128-byte swizzle."""
    cw = dw // 8
    landed = {}                               # global chunk -> (CTA, chunk)
    for rank in (0, 1):
        for w in (0, 1):
            for j in range(cw):
                landed[(2 * rank + w) * cw + j] = (rank, 16 * w + j)
    assert sorted(landed) == list(range(4 * cw))
    for rows in (64, 32):                     # K, V; Q, dO
        panel_bytes = rows * 64 * 2
        for w in (0, 1):
            for kk in range(dw // 16):        # desc_k(s + 2 w panels, kk)
                start = 2 * w * panel_bytes + (16 * kk // 64) * panel_bytes \
                    + (16 * kk % 64) * 2
                for m in range(rows):
                    for kx in range(16):
                        col = 128 * w + 16 * kk + kx
                        assert _hw_k_major(start, 1024, m, kx) \
                            == _elem(256, rows, m, col)
                for rank in (0, 1):           # quarter u's global columns
                    u = 2 * rank + w
                    for kx in range(0, 16, 8):
                        gcol = u * dw + 16 * kk + kx
                        assert landed[gcol // 8] \
                            == (rank, (128 * w + 16 * kk + kx) // 8)
    rows, panel_bytes = 32, 32 * 128
    for w in (0, 1):                          # desc_mn(s + 2 w panels, kk)
        for kk in range(rows // 16):
            start = 2 * w * panel_bytes + 16 * kk * 128
            for kx in range(16):
                for n in range(dw):
                    assert _hw_mn_major(start, panel_bytes, 1024, kx, n) \
                        == _elem(256, rows, 16 * kk + kx, 128 * w + n)


@pytest.mark.parametrize("ld", [160, 192, 256])
def test_f32_cluster_tiles_read_without_bank_conflicts(ld):
    """A cluster CTA of the f32 wide backward holds rows of D / 2 floats
    (160, 192, 256) in the padded-256 kernels' swizzle (chunk c of row r
    at chunk c ^ swz(r)): a bijection on every row, and both of the
    backward's float4 read patterns (rows g at chunks 4 kp + t over the
    head dim; rows 2t and 2t + 1 at chunks 8 c + g over a tile's rows)
    meet all 8 bank groups in each quarter-warp."""
    def ld4(r, c):
        return [r * ld + 4 * (c ^ _swz(r)) + i for i in range(4)]
    for r in range(32):
        assert sorted(ld4(r, c)[0] for c in range(ld // 4)) \
            == list(range(r * ld, (r + 1) * ld, 4))
    for base in (0, 8, 16):
        for kp in range(ld // 16):
            reads = {lane: ld4(base + g, 4 * kp + t) for lane, g, t in _lanes()}
            assert _quarter_conflicts(reads) == 0
        for c in range(ld // 32):
            for odd in (0, 1):
                reads = {lane: ld4(base + 2 * t + odd, 8 * c + g)
                         for lane, g, t in _lanes()}
                assert _quarter_conflicts(reads) == 0


@pytest.mark.parametrize("ld", [160, 192])
def test_f32_cluster_halves_sum_to_the_whole_product(ld):
    """Lane by lane through the hardware's m16n8k8 layout: each CTA of the
    f32 cluster runs the padded-256 kernels' S = A·Bᵀ fragments (a_frags
    on rows g, g + 8 and mma_dims on row g of B, k indices 4t, 4t+1 |
    4t+2, 4t+3 of each 16 dims) over its own ld columns; each lane's sum
    of its own accumulators and its peer's is S over all 2 ld columns, in
    the accumulator layout the kernels then read (row g, columns 2t,
    2t + 1; row g + 8)."""
    rng = np.random.default_rng(17)
    a = rng.integers(-4, 5, (16, 2 * ld)).astype(np.float64)
    b = rng.integers(-4, 5, (8, 2 * ld)).astype(np.float64)
    halves = []
    for rank in (0, 1):
        cols = slice(rank * ld, (rank + 1) * ld)
        acc = [(0.0,) * 4] * 32
        for kp in range(ld // 16):
            for s in (0, 1):              # dims 4t, 4t+1 | 4t+2, 4t+3
                a_regs, b_regs = [], []
                for _, g, t in _lanes():
                    d0 = 16 * kp + 4 * t + 2 * s
                    a_regs.append((a[g, cols][d0], a[g + 8, cols][d0],
                                   a[g, cols][d0 + 1], a[g + 8, cols][d0 + 1]))
                    b_regs.append((b[g, cols][d0], b[g, cols][d0 + 1]))
                acc = [tuple(p + q for p, q in zip(u, w)) for u, w in
                       zip(acc, _mma_m16n8k8(a_regs, b_regs))]
        halves.append(acc)
    want = a @ b.T
    for lane, g, t in _lanes():
        got = tuple(x + y for x, y in zip(halves[0][lane], halves[1][lane]))
        assert got == (want[g, 2 * t], want[g, 2 * t + 1],
                       want[g + 8, 2 * t], want[g + 8, 2 * t + 1])
