"""K1's wide kernels (head dims 257-512) on the CPU, against the JAX
package's Pallas forward in interpret mode.

``flash_fwd_wgmma_kernel`` at padded 384 and 512 (bf16, a multiple of 8,
two warpgroups) and
``flash_fwd_tf32x3_wide_kernel`` (f32) run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``). Here each one's schedule
is emulated in torch as the kernel runs it, and held to the JAX
package's forward at D 264, 320, 328, 384, 392 and 512, causal and not, at T
200 (a ragged last tile): the bf16 kernel's two warpgroups, each with
its own S over the whole D and its own online softmax over 32-key steps,
each holding one half of O's columns, bf16 P before P·V; the f32 kernel's
pairs of warps, each computing one 8-key n-tile of S over the whole D in
three TF32 products and swapping it with its partner, each holding one
half of O's columns. The tolerances are the card's: O bf16 atol 2e-2, f32
1e-4; lse 1e-3. The shared-memory configs are read from the csrc; the
f32 kernel's fragments and the bf16 kernel's tile descriptors are checked
lane by lane. The slice as a whole: an LM of head dim 320 (d_model 640, 2
heads), the one ``chip_smoke.py`` serves and trains, against the JAX
package's with flash attention on both sides.
"""

from __future__ import annotations

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.zoo import transformer as jtfm
from deeplearning4j_tpu_torch.kernels import flash_attention as tfa
from deeplearning4j_tpu_torch.zoo import transformer as ttfm
from test_torch_kernels import (_csrc_smem, _elem, _hw_k_major,
                                _hw_mn_major, _lanes, _mm_tf32,
                                _mma_m16n8k8, _quarter_conflicts,
                                _tile_off)

# the JAX package re-exports the flash_attention FUNCTION under the
# module's name; import_module reaches the module itself
jfa = importlib.import_module("deeplearning4j_tpu.kernels.flash_attention")

torch.set_num_threads(2)

WIDE_DIMS = [264, 320, 328, 384, 392, 512]
T = 200
ATOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
LSE_ATOL = 1e-3
#: Pallas blocks of the JAX forward at T 200 (5 x 5 tiles a head)
BLOCK = 40


def _padded(d, f32=False):
    """The width the wide kernels run head dim ``d`` at: 384 or 512
    (csrc/flash_mma.cuh ``wide_padded_dim``), the f32 kernel also 320
    (``launch_tf32x3_wide``)."""
    return 320 if f32 and d <= 320 else 384 if d <= 384 else 512


def _inputs(d, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((1, 2, T, d)).astype(np.float32)
            for _ in range(3)]
    ts = [torch.as_tensor(a).to(dtype) for a in arrs]
    return ts, [jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
        for t in ts]


def _jax_fwd(jq, jk, jv, causal):
    o, lse = jfa.flash_attention_lse(jq, jk, jv, causal=causal,
                                     block_q=BLOCK, block_k=BLOCK,
                                     interpret=True)
    return (torch.as_tensor(np.array(o.astype(jnp.float32))),
            torch.as_tensor(np.array(lse)))


def _online_step(s, m, l):
    """One step of the kernels' online softmax on log2-scaled, masked
    scores ``s`` (rows, keys): the new max, the rescale of the old state,
    exp2(s - max) in f32 and the new row sum."""
    mn = torch.maximum(m, s.max(-1).values)
    base = torch.where(mn == -math.inf, torch.zeros(()), mn)
    corr = torch.exp2(m - base)
    p = torch.exp2(s - base[..., None])
    return mn, corr, p, l * corr + p.sum(-1)


def _masked(s, q0, k0, causal):
    rows = torch.arange(q0, q0 + s.shape[-2])
    keys = torch.arange(k0, k0 + s.shape[-1])
    live = (keys[None, :] < T) & ((keys[None, :] <= rows[:, None])
                                  if causal else True)
    return torch.where(live, s, torch.tensor(-math.inf))


def _wgmma_wide_emulation(q, k, v, scale, causal):
    """``flash_fwd_wgmma_kernel<384|512, 32>``'s schedule on bf16 (B, H,
    T, D): columns zero-padded to 384 or 512, rows past T zero; per
    64-query tile,
    two warpgroups, each on its own: S = Q·Kᵀ over the whole padded D in
    f32 (bf16 products) for each 32-key step up to the diagonal, scaled
    into log2 units and masked, the online softmax, then its half of O's
    columns ·corr + bf16(P)·V[:, half]. Both warpgroups' row state must
    come out bit for bit equal (they share no state). Returns O (bf16)
    and the lse."""
    b, h, t, d = q.shape
    dp = _padded(d)
    qf, kf, vf = (torch.nn.functional.pad(x.float(), (0, dp - d, 0, 64))
                  for x in (q, k, v))
    sl2 = scale * math.log2(math.e)
    o = torch.zeros((b, h, t, dp))
    lse = torch.zeros((b, h, t))
    for q0 in range(0, t, 64):
        kend = min(t, q0 + 64) if causal else t
        state = []
        for half in (slice(0, dp // 2), slice(dp // 2, dp)):
            m = torch.full((b, h, 64), -math.inf)
            l = torch.zeros((b, h, 64))
            acc = torch.zeros((b, h, 64, dp // 2))
            for k0 in range(0, kend, 32):
                s = qf[..., q0:q0 + 64, :] @ kf[..., k0:k0 + 32, :] \
                    .transpose(-1, -2)
                s = _masked(s * sl2, q0, k0, causal)
                m, corr, p, l = _online_step(s, m, l)
                pb = p.to(torch.bfloat16).float()
                acc = acc * corr[..., None] + pb @ vf[..., k0:k0 + 32, half]
            state.append((m, l, acc))
        (m0, l0, a0), (m1, l1, a1) = state
        assert torch.equal(m0, m1) and torch.equal(l0, l1)
        n = min(64, t - q0)
        ls = torch.where(l0 == 0, torch.ones(()), l0)
        o[..., q0:q0 + n, :] = (torch.cat([a0, a1], -1)
                                / ls[..., None])[..., :n, :]
        lse[..., q0:q0 + n] = ((m0 + torch.log2(ls)) * math.log(2.0))[..., :n]
    return o[..., :d].to(torch.bfloat16), lse


def _tf32x3_wide_emulation(q, k, v, scale, causal, passes=3):
    """``flash_fwd_tf32x3_wide_kernel``'s schedule on f32 (B, H, T, D):
    columns zero-padded to 320 or 384 (64-query tiles) or 512 (32-query
    tiles); per 16-key step up to the diagonal, the two warps of a row
    group each compute one 8-key n-tile of S over the whole padded D in
    split TF32 (``passes`` 3: hi·hi + hi·lo + lo·hi; the kernel's four
    partial sums over D are one product here) and swap them, so both hold
    the same S; scaled into log2 units, masked, the online softmax; each
    warp then takes its half of O's columns ·corr + P·V[:, half] in split
    TF32 (P split too). Returns O and the lse."""
    b, h, t, d = q.shape
    dp = _padded(d, f32=True)
    bq = 64 if dp == 384 else 32
    qf, kf, vf = (torch.nn.functional.pad(x, (0, dp - d, 0, 64))
                  for x in (q, k, v))
    sl2 = scale * math.log2(math.e)
    o = torch.zeros((b, h, t, dp))
    lse = torch.zeros((b, h, t))
    for q0 in range(0, t, bq):
        kend = min(t, q0 + bq) if causal else t
        m = torch.full((b, h, bq), -math.inf)
        l = torch.zeros((b, h, bq))
        halves = [torch.zeros((b, h, bq, dp // 2)) for _ in range(2)]
        for k0 in range(0, kend, 16):
            tiles = [_mm_tf32(qf[..., q0:q0 + bq, :],
                              kf[..., k0 + 8 * w:k0 + 8 * w + 8, :]
                              .transpose(-1, -2), passes)
                     for w in (0, 1)]               # warp w's n-tile
            s = _masked(torch.cat(tiles, -1) * sl2, q0, k0, causal)
            m, corr, p, l = _online_step(s, m, l)
            for w in (0, 1):
                cols = slice(w * dp // 2, (w + 1) * dp // 2)
                halves[w] = halves[w] * corr[..., None] + _mm_tf32(
                    p, vf[..., k0:k0 + 16, cols], passes)
        n = min(bq, t - q0)
        ls = torch.where(l == 0, torch.ones(()), l)
        o[..., q0:q0 + n, :] = (torch.cat(halves, -1)
                                / ls[..., None])[..., :n, :]
        lse[..., q0:q0 + n] = ((m + torch.log2(ls)) * math.log(2.0))[..., :n]
    return o[..., :d], lse


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_wgmma_wide_schedule_matches_jax_pallas(d, causal):
    """The bf16 wide K1, emulated on its schedule (two warpgroups with
    their own S and softmax, column halves of O, 32-key steps, bf16 P),
    against the JAX package's Pallas forward in interpret mode on the same
    bf16 inputs: O within the bf16 atol 2e-2, lse within 1e-3."""
    (q, k, v), jx = _inputs(d, torch.bfloat16, seed=d)
    assert tfa.route(d, torch.bfloat16, "fwd") == "wgmma-wide"
    o, lse = _wgmma_wide_emulation(q, k, v, d ** -0.5, causal)
    ref, ref_lse = _jax_fwd(*jx, causal)
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    assert (o.float() - ref).abs().max().item() <= ATOL[torch.bfloat16]
    assert (lse - ref_lse).abs().max().item() <= LSE_ATOL


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_tf32x3_wide_schedule_matches_jax_pallas(d, causal):
    """The f32 wide K1, emulated on its schedule (S n-tiles split between
    a pair of warps and swapped, column halves of O, 16-key steps, three
    TF32 products a product), against the JAX package's Pallas forward in
    interpret mode: O within the f32 atol 1e-4, lse within 1e-3."""
    (q, k, v), jx = _inputs(d, torch.float32, seed=d + 1)
    assert tfa.route(d, torch.float32, "fwd") == "tf32x3-wide"
    o, lse = _tf32x3_wide_emulation(q, k, v, d ** -0.5, causal)
    ref, ref_lse = _jax_fwd(*jx, causal)
    assert o.shape == q.shape
    assert (o - ref).abs().max().item() <= ATOL[torch.float32]
    assert (lse - ref_lse).abs().max().item() <= LSE_ATOL


@pytest.mark.parametrize("d", [320, 512])
def test_one_tf32_product_misses_the_wide_f32_bar(d):
    """Why the f32 wide kernel keeps three TF32 products: one product of
    the rounded operands misses the f32 atol of 1e-4 at D 320 and 512."""
    (q, k, v), jx = _inputs(d, torch.float32, seed=d + 2)
    ref, _ = _jax_fwd(*jx, True)
    o1, _ = _tf32x3_wide_emulation(q, k, v, d ** -0.5, True, passes=1)
    assert (o1 - ref).abs().max().item() > ATOL[torch.float32]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [320, 512])
def test_plain_forward_matches_jax_pallas_at_wide_dims(d, causal):
    """The port's plain forward (what the wrappers run on CPU tensors) at
    D 320 and 512 against the JAX package's Pallas forward in interpret
    mode, f32, atol 1e-5 (summation order)."""
    (q, k, v), jx = _inputs(d, torch.float32, seed=d + 3)
    o, lse = tfa.flash_attention_lse(q, k, v, causal=causal)
    ref, ref_lse = _jax_fwd(*jx, causal)
    np.testing.assert_allclose(o.numpy(), ref.numpy(), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=1e-5)


@pytest.mark.parametrize("struct, params, kib", [
    ("FwdCfg", {"D": 384, "BK": 32}, 145),
    ("FwdCfg", {"D": 512, "BK": 32}, 193),
    ("Tf32WideCfg", {"D": 320, "BQ": 64}, 170.5),
    ("Tf32WideCfg", {"D": 384, "BQ": 64}, 202.5),
    ("Tf32WideCfg", {"D": 512, "BQ": 32}, 198.5),
])
def test_wide_configs_fit_shared_memory(struct, params, kib):
    """The wide kernels' shared memory, read from the csrc configs: bf16 Q
    and two stages of K and V at 32-key steps, 1 KiB to align (145 KiB at
    padded 384, 193 at 512); f32 Q and two stages of K and V at 16-key
    steps, rows padded by 16 and 4 floats, and the pairs' S exchange
    (170.5 and 202.5 KiB at 320 and 384 with 64 query rows, 198.5 at 512
    with 32); each within the 227 KiB a block may use."""
    smem = _csrc_smem(struct, **params)
    assert smem == kib * 1024
    assert smem <= tfa.SMEM_PER_BLOCK == 232448


@pytest.mark.parametrize("d", [384, 512])
def test_wide_tile_layout_matches_wgmma_descriptors(d):
    """The bf16 wide kernel's tiles lane by lane against what wgmma reads
    through its descriptors, on the hardware's 128-byte swizzle: Q (64
    rows) and K (32 rows) as K-major operands over every 16-column k-step
    of the padded D (S over the whole D), and V (32 rows) as the MN-major
    B operand of each warpgroup's half, N = D / 2 columns from the half's
    first 64-column panel (the kernel's ``v_off``)."""
    for rows in (64, 32):
        panel_bytes = rows * 64 * 2
        for kk in range(d // 16):
            start = (16 * kk // 64) * panel_bytes + (16 * kk % 64) * 2
            for m in range(rows):
                for kx in range(16):
                    assert _hw_k_major(start, 1024, m, kx) \
                        == _elem(d, rows, m, 16 * kk + kx)
    rows, panel_bytes, half = 32, 32 * 128, d // 2
    for wg in (0, 1):
        v_off = (half // 64) * wg * panel_bytes
        for kk in range(rows // 16):
            start = v_off + 16 * kk * 128
            for kx in range(16):
                for n in range(half):
                    assert _hw_mn_major(start, panel_bytes, 1024, kx, n) \
                        == _elem(d, rows, 16 * kk + kx, wg * half + n)
    offs = sorted(_tile_off(d, rows, r, c)
                  for r in range(rows) for c in range(d // 8))
    assert offs == list(range(0, rows * d * 2, 16))


@pytest.mark.parametrize("d", [320, 384, 512])
def test_tf32x3_wide_fragments_read_what_the_products_need(d):
    """The f32 wide kernel's fragments, lane by lane, through the
    hardware's m16n8k8 layout, from tiles of row strides D + 16 (Q, K)
    and D + 4 (V) floats: warp ``ch`` of a pair computes S's n-tile ch
    (keys 8 ch .. 8 ch + 7) over the whole D from float4 reads of Q's rows
    g, g + 8 and K's row 8 ch + g at dims 16 kp + 4 t (k indices t, t + 4
    of two k-steps), and after the swap both warps hold all 16 keys; each
    warp's P·V over its half reads float4s of V's rows 2t, 2t + 1 at
    columns c0 + 32 c + 4 g and leaves O's row g at columns c0 + 32 c +
    8 t + 4 e + u, which the epilogue writes; every read meets all 8 bank
    groups of each quarter-warp."""
    rng = np.random.default_rng(16)
    ldq, ldv, half = d + 16, d + 4, d // 2
    qm = rng.integers(-4, 5, (16, d)).astype(np.float64)
    km = rng.integers(-4, 5, (16, d)).astype(np.float64)
    vm = rng.integers(-4, 5, (16, d)).astype(np.float64)
    posted = {}
    for ch in (0, 1):
        acc = [(0.0,) * 4] * 32
        for kp in range(d // 16):
            qa = {lane: [g * ldq + 16 * kp + 4 * t + i for i in range(4)]
                  for lane, g, t in _lanes()}
            kr = {lane: [(8 * ch + g) * ldq + 16 * kp + 4 * t + i
                         for i in range(4)] for lane, g, t in _lanes()}
            assert _quarter_conflicts(qa) == 0 and _quarter_conflicts(kr) == 0
            for s in (0, 1):          # dims 4t, 4t+1 | 4t+2, 4t+3
                a_regs = [(qm[g, 16 * kp + 4 * t + 2 * s],
                           qm[g + 8, 16 * kp + 4 * t + 2 * s],
                           qm[g, 16 * kp + 4 * t + 2 * s + 1],
                           qm[g + 8, 16 * kp + 4 * t + 2 * s + 1])
                          for _, g, t in _lanes()]
                b_regs = [(km[8 * ch + g, 16 * kp + 4 * t + 2 * s],
                           km[8 * ch + g, 16 * kp + 4 * t + 2 * s + 1])
                          for _, g, t in _lanes()]
                acc = [tuple(p + r for p, r in zip(u, w)) for u, w in
                       zip(acc, _mma_m16n8k8(a_regs, b_regs))]
        posted[ch] = acc
    s_full = qm @ km.T                              # (16 rows, 16 keys)
    for ch in (0, 1):
        for n in (0, 1):              # s[n] after the swap
            got = posted[ch] if n == ch else posted[1 - ch]
            for lane, g, t in _lanes():
                assert got[lane] == (s_full[g, 8 * n + 2 * t],
                                     s_full[g, 8 * n + 2 * t + 1],
                                     s_full[g + 8, 8 * n + 2 * t],
                                     s_full[g + 8, 8 * n + 2 * t + 1])
    p = rng.integers(-4, 5, (16, 16)).astype(np.float64)
    for ch in (0, 1):
        c0 = ch * half
        out = np.full((16, d), np.nan)
        acc = {}
        for n in (0, 1):
            pa = [(p[g, 8 * n + 2 * t], p[g + 8, 8 * n + 2 * t],
                   p[g, 8 * n + 2 * t + 1], p[g + 8, 8 * n + 2 * t + 1])
                  for _, g, t in _lanes()]
            for c in range(half // 32):
                r0 = {lane: [(8 * n + 2 * t) * ldv + c0 + 32 * c + 4 * g + u
                             for u in range(4)] for lane, g, t in _lanes()}
                r1 = {lane: [x + ldv for x in r0[lane]] for lane in r0}
                assert _quarter_conflicts(r0) == 0
                assert _quarter_conflicts(r1) == 0
                for u in range(4):
                    b_regs = [(vm[8 * n + 2 * t, c0 + 32 * c + 4 * g + u],
                               vm[8 * n + 2 * t + 1, c0 + 32 * c + 4 * g + u])
                              for _, g, t in _lanes()]
                    d_ = _mma_m16n8k8(pa, b_regs)
                    acc[(c, u)] = [tuple(x + y for x, y in zip(a_, b_))
                                   for a_, b_ in zip(acc.get(
                                       (c, u), [(0.0,) * 4] * 32), d_)]
        for (c, u), regs in acc.items():
            for lane, g, t in _lanes():
                for i in range(4):
                    col = c0 + 32 * c + 8 * t + 4 * (i & 1) + u
                    out[g + 8 * (i >> 1), col] = regs[lane][i]
        want = p @ vm
        np.testing.assert_array_equal(out[:, c0:c0 + half],
                                      want[:, c0:c0 + half])
        assert np.isnan(out[:, :c0]).all() and np.isnan(out[:, c0 + half:]) \
            .all()


#: an LM of head dim 320 (d_model 640, 2 heads), cut to one layer, a
#: small vocabulary and T 24; flash attention on both sides
D320_LM = dict(vocab_size=61, d_model=640, n_heads=2, n_layers=1, d_ff=64,
               max_seq=32, remat=False, attn_scores_bf16=False,
               use_flash_attention=True)


def test_d320_lm_loss_and_grads_match_jax_flash(monkeypatch):
    """The slice end to end on the CPU: the D 320 LM's loss and every
    leaf's grad against ``jax.value_and_grad`` of the JAX package's, f32,
    flash attention on both sides (the port's Function over its plain
    forward and backward, the JAX package's Pallas kernels in interpret
    mode: its ``flash_engages`` is patched to True, as under this suite's
    8 host devices it returns False); atol 1e-5, rtol 1e-4 (summation
    order). On the card this LM's K1, dQ and dK/dV take the wide kernels
    in both dtypes."""
    monkeypatch.setattr(jtfm, "flash_engages", lambda cfg, t: True)
    jcfg = jtfm.TransformerConfig(dtype=jnp.float32, **D320_LM)
    tcfg = ttfm.TransformerConfig(dtype=torch.float32, **D320_LM)
    assert tcfg.head_dim == 320
    assert [tfa.route(320, dt, kn) for dt in (torch.bfloat16, torch.float32)
            for kn in ("fwd", "dq", "dkv")] == [
        "wgmma-wide", "wgmma-wide", "wgmma-wide",
        "tf32x3-wide", "tf32x3-wide", "tf32x3-wide"]
    jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = ttfm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                tcfg, device="cpu")
    ttfm.param_leaves(tp)            # each leaf now requires grad
    rng = np.random.default_rng(7)
    ids, tgt = (rng.integers(0, D320_LM["vocab_size"], (2, 24))
                .astype(np.int32) for _ in range(2))
    jl, jg = jax.value_and_grad(jtfm.lm_loss)(jp, jcfg, jnp.asarray(ids),
                                              jnp.asarray(tgt))
    loss = ttfm.lm_loss(tp, tcfg, torch.as_tensor(ids).long(),
                        torch.as_tensor(tgt).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), atol=1e-5, rtol=1e-4)

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            return {n: x for k, v in tree.items()
                    for n, x in leaves(v, f"{prefix}/{k}").items()}
        return {prefix: tree}
    want = leaves(jax.tree_util.tree_map(np.asarray, jg))
    got = leaves(tp)
    assert set(want) == set(got)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), g, err_msg=name,
                                   atol=1e-5, rtol=1e-4)
