"""K4's cluster route on the CPU: its plan, its route choice, and a plain
emulation of its schedule against the JAX package.

The cluster kernel itself runs only on the card (``tests/test_torch_cuda
.py``). Here:

- the plan (:func:`lstm_cluster_plan`): C divides the grid, 16 rows a
  cluster, shared memory within 232,448 bytes and equal to the sizing the
  CUDA source states, the bf16 and f32 limits of H, and every (B, H) the
  block plan takes still has a route;
- :func:`_emulate`, used by these tests only, runs the kernel's schedule
  in plain torch: CTA k of a cluster gathers the four gate columns of its
  units from rw, updates its own cells (peepholes of its units, c kept
  per CTA), and writes its slice of round(h) into the next buffer of
  every CTA's double-buffered h, reading only its own copy of the
  current one. In f32 it adds the K slices' partial sums in the kernel's
  order. It is held against JAX's ``fused_lstm_seq(..., True)`` (the
  Pallas kernel in interpret mode) and against ``lstm_seq_reference``.

Tolerances: f32 atol 1e-5 (the port's ``LSTM_ATOL``: the same products
summed in another order); bf16 atol 2e-2 (``BF16_ATOL`` of
``tests/test_torch_recurrent.py``: the emulation, like the kernel, keeps
h and c in f32 over all T steps while the plain version rounds both to
bf16 at every step).
"""

from __future__ import annotations

import functools
import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.kernels import fused_lstm as tk4

jk4 = importlib.import_module("deeplearning4j_tpu.kernels.fused_lstm")

torch.set_num_threads(2)

ATOL = 1e-5
BF16_ATOL = 2e-2
MAX_SMEM = 232448
CSRC = Path(tk4.__file__).resolve().parents[1] / "csrc" / "fused_lstm.cu"


def _inputs(b, t, h, peep, state, seed=0):
    rng = np.random.default_rng(seed * 1000 + b * 37 + t * 7 + h)
    xproj = rng.standard_normal((b, t, 4 * h)).astype(np.float32)
    rw = (rng.standard_normal((h, 4 * h)) * h ** -0.5).astype(np.float32)
    p = (rng.standard_normal((3, h)) * 0.1 if peep
         else np.zeros((3, h))).astype(np.float32)
    h0 = (rng.standard_normal((b, h)) * 0.5 if state
          else np.zeros((b, h))).astype(np.float32)
    c0 = (rng.standard_normal((b, h)) if state
          else np.zeros((b, h))).astype(np.float32)
    return xproj, rw, p, h0, c0


@functools.lru_cache(maxsize=None)
def _jax_outputs(b, t, h, peep, state):
    """JAX's Pallas kernel (interpret mode) and its reference, f32."""
    jins = [jnp.asarray(a) for a in _inputs(b, t, h, peep, state)]
    return (np.asarray(jk4.fused_lstm_seq(*jins, True)),
            np.asarray(jk4.lstm_seq_reference(*jins)))


def _emulate(xproj, rw, peep, h0, c0, cluster, k_slices=1):
    """The cluster kernel's schedule on the CPU: clusters of ``cluster``
    CTAs over tiles of 16 batch rows; (B, T, H) in xproj's dtype."""
    b, n_t, g4 = xproj.shape
    h = g4 // 4
    u = h // cluster
    r = tk4.CLUSTER_ROWS
    dt = rw.dtype
    p = peep.float()
    # CTA k's columns, gate-major: q*H + k*U + [0, U) for q = i, f, o, g
    cols = [torch.cat([torch.arange(q * h + k * u, q * h + (k + 1) * u)
                       for q in range(4)]) for k in range(cluster)]
    w = [rw[:, c].float() for c in cols]
    kc = h // k_slices
    out = torch.zeros((b, n_t, h), dtype=xproj.dtype)
    for b0 in range(0, b, r):
        rows = min(r, b - b0)
        # every CTA's own copy of round(h), double-buffered; rows past B 0
        hbuf = torch.zeros((cluster, 2, r, h))
        hbuf[:, 0, :rows] = h0[b0:b0 + rows].float().to(dt).float()
        c = [torch.zeros((r, u)) for _ in range(cluster)]
        for k in range(cluster):
            c[k][:rows] = c0[b0:b0 + rows, k * u:(k + 1) * u].float()
        for t in range(n_t):
            cur = t % 2
            x = torch.zeros((r, g4))
            x[:rows] = xproj[b0:b0 + rows, t].float()
            new = []
            for k in range(cluster):
                hk = hbuf[k, cur]
                z = x[:, cols[k]]
                for s in range(k_slices):
                    z = z + hk[:, s * kc:(s + 1) * kc] @ w[k][s * kc:
                                                             (s + 1) * kc]
                zi, zf, zo, zg = z.split(u, dim=1)
                pk = p[:, k * u:(k + 1) * u]
                ig = torch.sigmoid(zi + c[k] * pk[0])
                fg = torch.sigmoid(zf + c[k] * pk[1])
                cn = fg * c[k] + ig * torch.tanh(zg)
                hn = torch.sigmoid(zo + cn * pk[2]) * torch.tanh(cn)
                c[k] = cn
                hn[rows:] = 0.0
                new.append(hn)
            # the DSMEM exchange: each CTA's slice into every CTA's next
            # buffer; the current one is only read this step
            for k, hn in enumerate(new):
                hbuf[:, 1 - cur, :, k * u:(k + 1) * u] = hn.to(dt).float()
            out[b0:b0 + rows, t] = torch.cat(new, 1)[:rows].to(xproj.dtype)
    return out


# ------------------------------------------------------------------ plan

def test_cluster_plan_at_the_char_rnn_shape():
    # 16 clusters of 8 CTAs (128 CTAs); each holds 32 units' 128 columns,
    # bf16 in 4 groups of two warps that split K, f32 in 4 K slices
    assert tk4.lstm_cluster_plan(256, 256, torch.bfloat16) == \
        tk4.ClusterPlan(8, 16, 128, 256, 2, 94720)
    assert tk4.lstm_cluster_plan(256, 256, torch.float32) == \
        tk4.ClusterPlan(8, 16, 128, 256, 4, 198656)
    # 16 clusters: two waves of the 15 f32 clusters an H100 holds
    for dt in (torch.bfloat16, torch.float32):
        assert tk4.lstm_route(256, 60, 256, dt, resident=15) == "cluster"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cluster_plan_invariants(dtype):
    for b in (1, 3, 16, 17, 133, 256, 1000):
        for h in range(1, 520):
            plan = tk4.lstm_cluster_plan(b, h, dtype)
            if plan is None:
                continue
            c, u = plan.cluster, h // plan.cluster
            assert c in (1, 2, 4, 8) and h % c == 0 and u % 8 == 0
            assert plan.rows == 16
            assert plan.ctas == -(-b // 16) * c and plan.ctas % c == 0
            assert plan.smem <= MAX_SMEM
            assert plan.smem == tk4.cluster_smem(h, c, dtype, plan.k_slices)
            if dtype == torch.bfloat16:
                assert plan.k_slices == 2 and plan.threads == 8 * u <= 768
                assert h > 16                   # two 16-deep k steps
            else:
                ks = plan.k_slices
                assert ks in (1, 2, 4, 8) and h % ks == 0
                assert plan.threads == 2 * u * ks <= 256
            # the largest cluster whose slice is a multiple of 8 units
            assert all(h % cc or h // cc % 8 for cc in (8, 4, 2) if cc > c)


@pytest.mark.parametrize("dtype,largest,following", [
    (torch.bfloat16, 384, 392), (torch.float32, 256, 264)])
def test_cluster_route_limits(dtype, largest, following):
    hs = [h for h in range(8, 2049, 8)
          if tk4.lstm_cluster_plan(64, h, dtype) is not None]
    assert max(hs) == largest
    assert tk4.lstm_route(64, 8, largest, dtype, resident=4) == "cluster"
    assert tk4.lstm_route(64, 8, following, dtype, resident=4) == "block"
    # past the limit the rw slice (and h) pass a CTA's shared memory
    assert tk4.cluster_smem(448, 8, torch.bfloat16) > MAX_SMEM
    assert tk4.cluster_smem(320, 8, torch.float32, 1) > MAX_SMEM


def test_cluster_route_needs_slices_of_8_units():
    for dt in (torch.bfloat16, torch.float32):
        # 12: no C gives a multiple of 8; 40: only C 1; 48: C 2 (U 24)
        assert tk4.lstm_cluster_plan(8, 12, dt) is None
        assert tk4.lstm_route(8, 8, 12, dt) == "block"
        assert tk4.lstm_cluster_plan(8, 40, dt).cluster == 1
        assert tk4.lstm_cluster_plan(8, 48, dt).cluster == 2
        assert tk4.lstm_cluster_plan(8, 64, dt).cluster == 8
    # H 16: f32 C 2; bf16 has one 16-deep k step for its two warps
    assert tk4.lstm_cluster_plan(8, 16, torch.float32).cluster == 2
    assert tk4.lstm_route(8, 8, 16, torch.bfloat16) == "block"
    assert tk4.lstm_cluster_plan(8, 64, torch.float16) is None


def test_every_block_shape_still_has_a_route():
    for b in (1, 2, 5, 133, 256, 4096):
        for h in (*range(1, 130), 200, 256, 264, 384, 392, 512, 1000, 2048,
                  6000):
            for dt in (torch.bfloat16, torch.float32):
                # T 60 and one wave: the cluster route wherever it plans
                route = tk4.lstm_route(b, 60, h, dt, resident=1000)
                if tk4.lstm_plan(b, h) is not None:
                    assert route in ("cluster", "block")
                else:
                    assert route is None
                assert (route == "cluster") == (
                    tk4.lstm_cluster_plan(b, h, dt) is not None)
                # a short f32 sequence: the block route wherever it plans
                if dt == torch.float32:
                    assert tk4.lstm_route(b, 1, h, dt, resident=1000) == (
                        "block" if route else None)


@pytest.mark.parametrize("b,t,resident,route", [
    # f32 B 64: 4 clusters, one wave; the cluster route from T 4
    (64, 3, 15, "block"), (64, 4, 15, "cluster"), (64, 1000, 15, "cluster"),
    # B 256: 16 clusters, two waves of 15; from T 32
    (256, 4, 15, "block"), (256, 31, 15, "block"), (256, 32, 15, "cluster"),
    (256, 4, 16, "cluster"),
    # B 512: 32 clusters, three waves; the block route at any T
    (512, 1000, 15, "block"), (512, 32, 16, "cluster")])
def test_f32_route_needs_a_long_enough_sequence(b, t, resident, route):
    assert tk4.lstm_route(b, t, 256, torch.float32, resident) == route


def test_bf16_route_takes_the_cluster_at_any_t():
    # no card query: bf16 needs no resident count
    for b in (1, 256, 4096):
        assert tk4.lstm_route(b, 1, 256, torch.bfloat16) == "cluster"
    assert tk4.F32_CLUSTER_MIN_T == (4, 32)


def test_route_refuses_a_card_that_holds_no_cluster():
    with pytest.raises(RuntimeError, match="no cluster"):
        tk4.lstm_route(64, 60, 256, torch.float32, resident=0)


def test_cluster_sizing_matches_the_cuda_source():
    src = CSRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)
                   .group(1))

    assert const("kClusterRows") == tk4.CLUSTER_ROWS
    assert const("kMaxCluster") == max(tk4._CLUSTER_SIZES)
    assert const("kMmaThreads") == tk4._CLUSTER_THREADS[torch.bfloat16]
    assert const("kFfmaThreads") == tk4._CLUSTER_THREADS[torch.float32]
    for name in ("lstm_seq_cluster_mma_kernel", "lstm_seq_cluster_ffma_kernel",
                 "st.async.shared::cluster.mbarrier::complete_tx::bytes",
                 "mbarrier.try_wait.parity", "mapa.shared::cluster",
                 "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32"):
        assert name in src


@pytest.mark.parametrize("wrapper", ["lstm_seq_cluster", "lstm_seq_block"])
def test_route_wrappers_take_cuda_tensors_only(wrapper):
    ins = [torch.as_tensor(a) for a in _inputs(2, 3, 16, True, False)]
    with pytest.raises(ValueError, match="CUDA"):
        getattr(tk4, wrapper)(*ins)


def test_state_is_read_from_an_aligned_f32_copy():
    # an f32 view at an offset of one float (4 bytes) is copied to an
    # aligned address; an aligned contiguous f32 tensor is passed as is
    base = torch.arange(1 + 3 * 16, dtype=torch.float32)
    view = base[1:].view(3, 16)
    assert view.data_ptr() % 16
    got = tk4._state(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)
    aligned = torch.zeros((3, 16))
    assert tk4._state(aligned) is aligned
    half = tk4._state(aligned.bfloat16())
    assert half.dtype == torch.float32 and half.data_ptr() % 16 == 0


def test_reset_clears_the_route_counts():
    tk4.LAUNCHES_BY_ROUTE["cluster"] += 3
    tk4.LAUNCHES_BY_ROUTE["block"] += 1
    tk4.reset_launches()
    assert tk4.LAUNCHES == 0
    assert tk4.LAUNCHES_BY_ROUTE == {"cluster": 0, "block": 0}


# ------------------------------------------------------------- emulation

# (H, C): C the plan's at H 16 and 40, and every C H 64 divides into
# slices of 8 units
EMU_HC = [(16, 2), (40, 1), (64, 2), (64, 4), (64, 8)]


@pytest.mark.parametrize("h,c", EMU_HC)
@pytest.mark.parametrize("b", [3, 17, 33])
@pytest.mark.parametrize("t", [1, 7])
@pytest.mark.parametrize("peep,state", [(True, True), (False, False)])
def test_emulated_schedule_matches_pallas_and_reference(h, c, b, t, peep,
                                                        state):
    ins = [torch.as_tensor(a) for a in _inputs(b, t, h, peep, state)]
    # the f32 kernel's K slices at this C
    ks = tk4._cluster_plan_at(b, h, torch.float32, c).k_slices
    got = _emulate(*ins, c, k_slices=ks).numpy()
    pallas, jref = _jax_outputs(b, t, h, peep, state)
    np.testing.assert_allclose(got, pallas, atol=ATOL)
    np.testing.assert_allclose(got, jref, atol=ATOL)
    ref = tk4.lstm_seq_reference(*ins).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("h,c", EMU_HC)
@pytest.mark.parametrize("b", [3, 33])
def test_emulated_schedule_bf16_matches_plain(h, c, b):
    ins = [torch.as_tensor(a) for a in _inputs(b, 7, h, True, True, seed=1)]
    bf = [ins[0].bfloat16(), ins[1].bfloat16(), ins[2], ins[3].bfloat16(),
          ins[4].bfloat16()]
    got = _emulate(*bf, c)
    ref = tk4.lstm_seq_reference(*bf)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(),
                               atol=BF16_ATOL)


def test_emulated_ragged_tile_keeps_padding_rows_out():
    # B 17: the second cluster holds one real row; its 15 others never
    # reach the output and stay zero in h, so the real row is the same as
    # when it runs alone
    ins = [torch.as_tensor(a) for a in _inputs(17, 7, 64, True, True)]
    full = _emulate(*ins, 8, k_slices=8)
    alone = _emulate(*(v[16:] if v.dim() == 3 or v.shape[0] == 17 else v
                       for v in ins), 8, k_slices=8)
    assert torch.equal(full[16:], alone)
