// Flash-attention backward for Hopper (sm_90a), plain C interface: two
// kernels, dQ and dK/dV, each in a family chosen by dtype and head dim.
//
// Replaces the TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel` of
// deeplearning4j_tpu/kernels/flash_attention.py (launched by
// `_flash_bwd_impl`). Both rebuild the probabilities tile by tile from
// the forward's log-sum-exp, so the (T, T) matrices never reach device
// memory:
//   P  = exp(S - lse), S = Q K^T * scale, masked causally
//   dP = dO V^T
//   dS = P * (dP - delta) * scale       (delta = rowsum(dO * O), f32)
//   dQ = dS K            (dq kernel, one block per query tile)
//   dV = P^T dO, dK = dS^T Q   (dkv kernel, one block per key tile)
// dS (and P, for dV) round to the input dtype before their products, as
// the TPU kernels cast them before the MXU; every sum is f32.
//
// What bounds it on the card: operations. dQ does 3*D*T(T+1) flops per
// causal head and dK/dV 4*D*T(T+1) over ~5-7 * T * D * 2 bytes, hundreds
// of operations per byte: at the train path's B32 H8 T1024 D64 bf16 the
// floors are 0.0522 ms (dQ) and 0.0696 ms (dK/dV) at 989 TFLOP/s.
//
// bf16: both kernels run their products on the tensor cores as
// wgmma.mma_async (m64nNk16, bf16 -> f32), as the TPU kernels fed their
// MXU, one warpgroup (4 warps of 16 rows) a block, operands copied by
// 16-byte cp.async into the swizzled layouts wgmma reads through its
// descriptors (K-major for the score products, MN-major, i.e. transposed,
// for the operand a gradient is summed over).
//
// dK/dV (flash_bwd_dkv_wgmma_kernel). One block owns one (b*h, 64-key
// tile); per query tile of 64 rows, from the diagonal down:
//   Sᵀ = K·Qᵀ·scale, masked; Pᵀ = exp(Sᵀ - lse); dV += bf16(Pᵀ)·dO;
//   dPᵀ = V·dOᵀ; dSᵀ = bf16(Pᵀ ∘ (dPᵀ - delta)·scale); dK += dSᵀ·Q.
// The block's K and V tiles load once into shared memory; Q, dO and the
// lse and delta rows stream through a double-buffered cp.async ring. dK
// and dV stay in f32 registers; Pᵀ and dSᵀ go from accumulator fragments
// to bf16 register A operands, rounded where the TPU kernel cast them;
// dV's product and dPᵀ's are issued together. The grid's slow dimension
// walks the key tiles, the heaviest (first) ones first under causal
// masking. (An mma.sync m16n8k16 version with ldmatrix fragments measured
// 1.1-1.3x slower; PERF.md.)
//
// dQ (flash_bwd_dq_wgmma_kernel), its mirror image. One block owns one
// (b*h, 64-query tile); per key tile of 64 rows, from key 0 up to the
// diagonal: S = Q·Kᵀ·scale, masked; P = exp(S - lse); dP = dO·Vᵀ;
// dS = bf16(P ∘ (dP - delta)·scale); dQ += dS·K. Q and dO stay in shared
// memory and each thread keeps the lse and delta of its two rows in
// registers; K and V stream through the double-buffered cp.async ring; S
// and dP are issued together; dS goes from S's accumulator fragments to
// a bf16 register A operand and dQ += dS·K reads the same K tile through
// an MN-major descriptor; dQ stays in f32 registers. The grid's slow
// dimension walks the query tiles, the heaviest (last) first.
// In both, only tiles that cross the diagonal or T are masked, and rows
// >= T read as zeros.
//
// f32: every product on the tensor cores in split TF32 (three TF32
// products per f32 product, mma.sync m16n8k8; one TF32 pass would break
// the f32 atol of 1e-4), in the kernels below: at D 1..128 padded to 64 or
// 128 (flash_bwd_dq_tf32x3_narrow_kernel,
// flash_bwd_dkv_tf32x3_narrow_kernel: each warp owns 16 whole rows of its
// outputs), past 128 padded to 256 or wider. The Pallas grids (b*h,
// q-block, k-block) and (b*h, k-block, q-block) streamed the other
// operand through VMEM in order with the accumulator in scratch; here, as
// in bf16, one block owns one (b*h, row tile) of its output and a loop
// inside it walks the other operand's tiles: the dq kernel the key tiles
// up to the diagonal, the dkv kernel the query tiles from the diagonal
// down (the steps the TPU skipped with pl.when are never visited).
//
// Keeping the TPU's two-pass schedule means no atomics, so all three
// gradients are deterministic: a second launch is bit-identical. A T that
// is not a multiple of the tile is masked. The kernels take the batch,
// head and time strides of every (B, H, T, D) operand (the last dimension
// must be contiguous), so the (B, T, H, D) views of one qkv buffer the
// transformer holds need no copies; the bf16 kernels need 16-byte aligned
// bases and strides (the Python wrapper checks them and raises).
//
// Head dims: any D whose tiles fit in a block's shared memory, as the
// Pallas block (1, bq, d) takes any d. The bf16 kernels above take D up
// to 128 (a multiple of 8), each instantiated on the padded width
// DP = padded_dim(D) in {16, 32, 64, 128} and told the real D (the f32
// narrow kernels: DP 64 or 128): loaders fill the columns in [D, DP) with
// zeros (cp.async src-size 0), which add nothing to any dot product, and
// stores write only the D real columns. They keep their accumulators in
// registers, so
// past 128 one warpgroup's f32 accumulators would need DP (dQ) or 2 DP
// (dK/dV) registers a thread: bf16 dQ and dK/dV at D 136..256 (a multiple
// of 8) run padded to 256 on two warpgroups that split the columns
// (flash_bwd_dq_wgmma_split_kernel, flash_bwd_dkv_wgmma_split_kernel),
// and f32 dQ and dK/dV at D 129..256 padded to 256 in split TF32
// (flash_bwd_dq_tf32x3_kernel, flash_bwd_dkv_tf32x3_kernel). Past 256, up
// to 512 (the wide family, as K1's): bf16 (a multiple of 8) padded to 384
// or 512, dQ on the same two warpgroups at 32- and 16-key steps, dK/dV on
// a cluster of two CTAs whose four warpgroups each own a quarter of the
// columns (flash_bwd_dkv_wgmma_cluster_kernel); f32 padded to 320, 384 or
// 512, the split-TF32 kernels on a cluster of two CTAs that each hold
// one half of the columns. Every other D (past 512, a bf16 D that is not
// a multiple of 8) runs the head-dim-general CUDA-core kernels
// (flash_bwd_dq_general_kernel, flash_bwd_dkv_general_kernel;
// flash_general.cuh): the same two passes with every tile and accumulator
// in dynamic shared memory, R = 64..8 rows by D, element-by-element loads.

#include "flash_general.cuh"
#include "flash_mma.cuh"
#include "flash_tf32.cuh"

#include <math.h>

namespace {

using dl4j_mma::Str;
using dl4j_tf32::a_frags;
using dl4j_tf32::ld4;
using dl4j_tf32::mma_dims;
using dl4j_tf32::mma_rows_rn;
using dl4j_tf32::store_rows;

// ----------------------------- bf16 dK/dV, warpgroup MMA (wgmma)

template <int D>
struct DkvCfg {
  static constexpr int BKV = 64;  // keys per block: one warpgroup
  static constexpr int BQ = 64;   // query rows per step
  static constexpr int THREADS = 128;
  using KT = dl4j_mma::Tile<D, BKV>;
  using QT = dl4j_mma::Tile<D, BQ>;
  // K, V, two stages of (Q, dO), then two stages of (lse, delta) rows
  static constexpr int ROWS = 2 * KT::BYTES + 4 * QT::BYTES;
  static constexpr int SMEM = ROWS + 4 * BQ * 4 + 1024;
};

template <int D>
__global__ void __launch_bounds__(DkvCfg<D>::THREADS)
flash_bwd_dkv_wgmma_kernel(const dl4j_mma::bf16* __restrict__ q,
                           const dl4j_mma::bf16* __restrict__ k,
                           const dl4j_mma::bf16* __restrict__ v,
                           const dl4j_mma::bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           dl4j_mma::bf16* __restrict__ dk,
                           dl4j_mma::bf16* __restrict__ dv, int H, int Tlen,
                           int dr, Str sq, Str sk, Str sv, Str sdo, Str sdk,
                           Str sdv, float scale, int causal) {
  using namespace dl4j_mma;
  using C = DkvCfg<D>;
  using KT = typename C::KT;
  using QT = typename C::QT;
  constexpr int BQ = C::BQ;
  constexpr int NS = BQ / 2;  // Sᵀ / dPᵀ accumulators a thread holds
  constexpr int ND = D / 8;   // n-tiles of dK and dV (dc of them real)
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t s_k = base;
  const uint32_t s_v = s_k + KT::BYTES;
  const uint32_t s_ring = s_v + KT::BYTES;  // stage st: Q, then dO
  const uint32_t s_rows = base + C::ROWS;   // stage st: lse, then delta
  const unsigned char* rows_ptr = smem + (s_rows - smem_u32(smem));

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * C::BKV;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wkey = k0 + warp * 16;  // this warp's first key
  const int dc = dr >> 3;           // real 8-column chunks of a row
  const float sl2 = scale * kLog2e;

  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* dob = dout + b * sdo.b + h * sdo.h;
  const float* lseb = lse + (long long)bh * Tlen;
  const float* deltab = delta + (long long)bh * Tlen;
  // causal: query tiles above the block's first key see none of its keys
  const int first = causal ? k0 / BQ : 0;
  const int nqt = (Tlen + BQ - 1) / BQ;

  // query tile `it` into ring stage `st`
  auto fetch = [&](int it, int st) {
    const uint32_t tq = s_ring + st * 2 * QT::BYTES;
    const int i0 = it * BQ;
    QT::template load<C::THREADS>(tq, qb, sq.t, i0, Tlen, dc, tid);
    QT::template load<C::THREADS>(tq + QT::BYTES, dob, sdo.t, i0, Tlen, dc,
                                  tid);
    if (tid < BQ) {
      const int row = i0 + tid;
      const bool ok = row < Tlen;
      const uint32_t r = s_rows + st * 2 * BQ * 4;
      cp_async4(r + 4 * tid, lseb + (ok ? row : 0), ok);
      cp_async4(r + 4 * (BQ + tid), deltab + (ok ? row : 0), ok);
    }
  };

  KT::template load<C::THREADS>(s_k, k + b * sk.b + h * sk.h, sk.t, k0,
                                Tlen, dc, tid);
  KT::template load<C::THREADS>(s_v, v + b * sv.b + h * sv.h, sv.t, k0,
                                Tlen, dc, tid);
  fetch(first, 0);
  cp_async_commit();

  float dka[D / 2], dva[D / 2];  // n-tile d of this warp's keys at [4d..]
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  for (int it = first; it < nqt; ++it) {
    const int st = (it - first) & 1;
    if (it + 1 < nqt) fetch(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this stage (and K, V) have landed
    __syncthreads();
    const uint32_t s_q = s_ring + st * 2 * QT::BYTES;
    const uint32_t s_do = s_q + QT::BYTES;
    const float* ls = reinterpret_cast<const float*>(rows_ptr) + st * 2 * BQ;
    const float* dl = ls + BQ;
    const int i0 = it * BQ;

    // Sᵀ = K·Qᵀ
    float sacc[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sacc[i] = 0.f;
    fence_regs(sacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BQ>(sacc, KT::desc_k(s_k, kk), QT::desc_k(s_q, kk));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sacc);
    // Pᵀ = exp(Sᵀ·scale - lse); only tiles that cross the diagonal or T
    // are masked
    const bool edge = i0 + BQ > Tlen || (causal && i0 < wkey + 15);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int qi = 8 * (i >> 2) + 2 * t4 + (i & 1);
      float p = exp2_approx(fmaf(sacc[i], sl2, -ls[qi] * kLog2e));
      if (edge) {
        const int row = i0 + qi;
        const int key = wkey + g + 8 * ((i >> 1) & 1);
        if (row >= Tlen || (causal && row < key)) p = 0.f;
      }
      sacc[i] = p;
    }
    // dV += bf16(Pᵀ)·dO and dPᵀ = V·dOᵀ, issued together
    uint32_t pa[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kk][i] = pack_bf16(sacc[8 * kk + 2 * i], sacc[8 * kk + 2 * i + 1]);
    float dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) dp[i] = 0.f;
    fence_regs(dva);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<D>(dva, pa[kk], QT::desc_mn(s_do, kk));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BQ>(dp, KT::desc_k(s_v, kk), QT::desc_k(s_do, kk));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dva);
    fence_regs(dp);
    // dSᵀ = Pᵀ ∘ (dPᵀ - delta)·scale, rounded to bf16 for dK += dSᵀ·Q
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 8 * kk + 2 * i;
        const int qi = 8 * (j >> 2) + 2 * t4;
        pa[kk][i] = pack_bf16(sacc[j] * (dp[j] - dl[qi]) * scale,
                              sacc[j + 1] * (dp[j + 1] - dl[qi + 1]) * scale);
      }
    fence_regs(dka);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<D>(dka, pa[kk], QT::desc_mn(s_q, kk));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dka);
    __syncthreads();  // this stage is consumed before it is refilled
  }

  bf16* dkb = dk + b * sdk.b + h * sdk.h;
  bf16* dvb = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = wkey + g + 8 * r;
    if (key < Tlen) {
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        if (d < dc) {  // the padded columns are never written
          *reinterpret_cast<uint32_t*>(dkb + key * sdk.t + 8 * d + 2 * t4) =
              pack_bf16(dka[4 * d + 2 * r], dka[4 * d + 2 * r + 1]);
          *reinterpret_cast<uint32_t*>(dvb + key * sdv.t + 8 * d + 2 * t4) =
              pack_bf16(dva[4 * d + 2 * r], dva[4 * d + 2 * r + 1]);
        }
      }
    }
  }
}

// ------------- bf16 dK/dV at padded D 256, two warpgroups (wgmma)

// At padded D 256 one warpgroup's dK and dV would be 2 x 128 f32
// accumulators a thread, past the 255 registers a thread may hold. Two
// consumer warpgroups (256 threads) share the block's 64 keys instead:
// warpgroup w owns columns [128 w, 128 w + 128) of dK and dV, 64 + 64
// accumulators a thread. Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ are computed once,
// split along their depth D: each warpgroup forms the f32 partial over its
// own 128 columns (k-steps 8 w .. 8 w + 7), the two trade partials through
// shared memory (Sᵀ, then dPᵀ; 16 KiB a warpgroup, stored in the
// accumulators' own fragment order, since thread t of either warpgroup
// holds the same elements of the 64 x 64 product), and both add the two
// halves, so both hold bit-identical Pᵀ and dSᵀ. Each feeds them
// from registers as the A operand of its own N = 128 products, dV += Pᵀ·dO
// and dK += dSᵀ·Q, reading its column half of dO and Q (panels 2 w and
// 2 w + 1 of the four) through MN-major descriptors. Shared memory: K and
// V 64 KiB, two stages of (Q, dO) 128 KiB, the exchange 32 KiB, the lse
// and delta rows 1 KiB and 1 KiB of alignment, 226 KiB: one block an SM.
struct DkvSplitCfg {
  static constexpr int D = 256;
  static constexpr int DH = D / 2;  // columns of dK, dV a warpgroup owns
  static constexpr int BKV = 64;    // keys per block
  static constexpr int BQ = 64;     // query rows per step
  static constexpr int THREADS = 256;
  using KT = dl4j_mma::Tile<D, BKV>;
  using QT = dl4j_mma::Tile<D, BQ>;
  // K, V, two stages of (Q, dO), the exchange (a 64 x 64 f32 partial a
  // warpgroup), then two stages of (lse, delta) rows
  static constexpr int ROWS = 2 * KT::BYTES + 4 * QT::BYTES;
  static constexpr int XCH = 2 * BKV * BQ * 4;
  static constexpr int SMEM = ROWS + XCH + 4 * BQ * 4 + 1024;
};
static_assert(DkvSplitCfg::SMEM <= 232448, "227 KiB a block on sm_90");

// x = half 0 + half 1 of a 64 x 64 product of which this warpgroup holds
// one half in x: post it to `mine` (fragment order: float4 j of thread wt
// at j * 128 + wt), wait for the other warpgroup's, and add the two. One
// f32 addition of two terms is commutative, so both warpgroups get the
// same bits.
template <int N>
__device__ __forceinline__ void trade_halves(float (&x)[N], float4* mine,
                                             const float4* theirs,
                                             int wt) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
    mine[j * 128 + wt] =
        make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float4 o = theirs[j * 128 + wt];
    x[4 * j] += o.x;
    x[4 * j + 1] += o.y;
    x[4 * j + 2] += o.z;
    x[4 * j + 3] += o.w;
  }
}

__global__ void __launch_bounds__(DkvSplitCfg::THREADS, 1)
flash_bwd_dkv_wgmma_split_kernel(const dl4j_mma::bf16* __restrict__ q,
                                 const dl4j_mma::bf16* __restrict__ k,
                                 const dl4j_mma::bf16* __restrict__ v,
                                 const dl4j_mma::bf16* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 dl4j_mma::bf16* __restrict__ dk,
                                 dl4j_mma::bf16* __restrict__ dv, int H,
                                 int Tlen, int dr, Str sq, Str sk, Str sv,
                                 Str sdo, Str sdk, Str sdv, float scale,
                                 int causal) {
  using namespace dl4j_mma;
  using C = DkvSplitCfg;
  using KT = C::KT;
  using QT = C::QT;
  constexpr int BQ = C::BQ;
  constexpr int NS = BQ / 2;        // Sᵀ / dPᵀ accumulators a thread holds
  constexpr int NX = NS / 4;        // float4s of them
  constexpr int KH = C::DH / 16;    // k-steps of a half's partial
  constexpr int NDH = C::DH / 8;    // n-tiles of a warpgroup's dK and dV
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  unsigned char* const gbase = smem + (base - smem_u32(smem));
  const uint32_t s_k = base;
  const uint32_t s_v = s_k + KT::BYTES;
  const uint32_t s_ring = s_v + KT::BYTES;  // stage st: Q, then dO
  const uint32_t s_rows = base + C::ROWS + C::XCH;  // stage st: lse, delta
  float4* const xch = reinterpret_cast<float4*>(gbase + C::ROWS);
  const float* const rows_ptr =
      reinterpret_cast<const float*>(gbase + C::ROWS + C::XCH);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * C::BKV;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;           // this warpgroup's column half
  const int wt = tid & 127;          // the thread within its warpgroup
  const int warp = wt >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wkey = k0 + warp * 16;  // this warp's first key
  const int dc = dr >> 3;           // real 8-column chunks of a row
  const float sl2 = scale * kLog2e;
  // this warpgroup's partials go to `mine`, the other's come from `theirs`
  float4* const mine = xch + wg * NX * 128;
  const float4* const theirs = xch + (wg ^ 1) * NX * 128;
  // the byte offset of this warpgroup's column half (panels 2 wg, 2 wg + 1)
  // in a tile: its k-steps of Sᵀ and dPᵀ, and its N = 128 of dV and dK
  const uint32_t half = 2 * wg * QT::PANEL_BYTES;
  static_assert(KT::PANEL_BYTES == QT::PANEL_BYTES, "one panel size");

  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* dob = dout + b * sdo.b + h * sdo.h;
  const float* lseb = lse + (long long)bh * Tlen;
  const float* deltab = delta + (long long)bh * Tlen;
  // causal: query tiles above the block's first key see none of its keys
  const int first = causal ? k0 / BQ : 0;
  const int nqt = (Tlen + BQ - 1) / BQ;

  // query tile `it` into ring stage `st`
  auto fetch = [&](int it, int st) {
    const uint32_t tq = s_ring + st * 2 * QT::BYTES;
    const int i0 = it * BQ;
    QT::template load<C::THREADS>(tq, qb, sq.t, i0, Tlen, dc, tid);
    QT::template load<C::THREADS>(tq + QT::BYTES, dob, sdo.t, i0, Tlen, dc,
                                  tid);
    if (tid < BQ) {
      const int row = i0 + tid;
      const bool ok = row < Tlen;
      const uint32_t r = s_rows + st * 2 * BQ * 4;
      cp_async4(r + 4 * tid, lseb + (ok ? row : 0), ok);
      cp_async4(r + 4 * (BQ + tid), deltab + (ok ? row : 0), ok);
    }
  };
  KT::template load<C::THREADS>(s_k, k + b * sk.b + h * sk.h, sk.t, k0,
                                Tlen, dc, tid);
  KT::template load<C::THREADS>(s_v, v + b * sv.b + h * sv.h, sv.t, k0,
                                Tlen, dc, tid);
  fetch(first, 0);
  cp_async_commit();

  // n-tile d of this warp's keys, columns 128 wg + 8 d .., at [4d..4d+3]
  float dka[C::DH / 2], dva[C::DH / 2];
#pragma unroll
  for (int i = 0; i < C::DH / 2; ++i) dka[i] = dva[i] = 0.f;

  for (int it = first; it < nqt; ++it) {
    const int st = (it - first) & 1;
    if (it + 1 < nqt) fetch(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this stage (and K, V) have landed
    __syncthreads();
    const uint32_t s_q = s_ring + st * 2 * QT::BYTES;
    const uint32_t s_do = s_q + QT::BYTES;
    const float* ls = rows_ptr + st * 2 * BQ;
    const float* dl = ls + BQ;
    const int i0 = it * BQ;

    // this half's partials of Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, issued together
    float sacc[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sacc[i] = dp[i] = 0.f;
    fence_regs(sacc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KH; ++kk)
      wgmma_ss<BQ>(sacc, KT::desc_k(s_k + half, kk),
                   QT::desc_k(s_q + half, kk));
#pragma unroll
    for (int kk = 0; kk < KH; ++kk)
      wgmma_ss<BQ>(dp, KT::desc_k(s_v + half, kk),
                   QT::desc_k(s_do + half, kk));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sacc);
    fence_regs(dp);
    trade_halves(sacc, mine, theirs, wt);
    __syncthreads();  // both have read the exchange before it is reused
    trade_halves(dp, mine, theirs, wt);

    // Pᵀ = exp(Sᵀ·scale - lse); only tiles that cross the diagonal or T
    // are masked
    const bool edge = i0 + BQ > Tlen || (causal && i0 < wkey + 15);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int qi = 8 * (i >> 2) + 2 * t4 + (i & 1);
      float p = exp2_approx(fmaf(sacc[i], sl2, -ls[qi] * kLog2e));
      if (edge) {
        const int row = i0 + qi;
        const int key = wkey + g + 8 * ((i >> 1) & 1);
        if (row >= Tlen || (causal && row < key)) p = 0.f;
      }
      sacc[i] = p;
    }
    // bf16(Pᵀ) and dSᵀ = bf16(Pᵀ ∘ (dPᵀ - delta)·scale) as A fragments
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 8 * kk + 2 * i;
        const int qi = 8 * (j >> 2) + 2 * t4;
        pa[kk][i] = pack_bf16(sacc[j], sacc[j + 1]);
        da[kk][i] = pack_bf16(sacc[j] * (dp[j] - dl[qi]) * scale,
                              sacc[j + 1] * (dp[j + 1] - dl[qi + 1]) * scale);
      }
    // dV += Pᵀ·dO and dK += dSᵀ·Q over this warpgroup's column half
    fence_regs(dva);
    fence_regs(dka);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<C::DH>(dva, pa[kk], QT::desc_mn(s_do + half, kk));
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<C::DH>(dka, da[kk], QT::desc_mn(s_q + half, kk));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dva);
    fence_regs(dka);
    __syncthreads();  // this stage and the exchange are free again
  }

  bf16* dkb = dk + b * sdk.b + h * sdk.h;
  bf16* dvb = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = wkey + g + 8 * r;
    if (key < Tlen) {
#pragma unroll
      for (int d = 0; d < NDH; ++d) {
        const int c = NDH * wg + d;  // the 8-column chunk of the row
        if (c < dc) {  // the padded columns are never written
          *reinterpret_cast<uint32_t*>(dkb + key * sdk.t + 8 * c + 2 * t4) =
              pack_bf16(dka[4 * d + 2 * r], dka[4 * d + 2 * r + 1]);
          *reinterpret_cast<uint32_t*>(dvb + key * sdv.t + 8 * c + 2 * t4) =
              pack_bf16(dva[4 * d + 2 * r], dva[4 * d + 2 * r + 1]);
        }
      }
    }
  }
}

// ------- bf16 dK/dV at padded D 384 and 512, a cluster of two CTAs

// Past D 256 a block's dK and dV (64 keys x 2 D f32) and its tiles (K, V
// and two stages of Q and dO, 240 KiB at padded 384 with 32 queries a
// step) fit neither in two warpgroups' registers nor in one block's
// shared memory. So a thread-block cluster of two CTAs (adjacent in x)
// shares the 64 keys: CTA c and its warpgroup w own quarter u = 2 c + w of
// D's columns, DW = D / 4 of them (96 at 384, 128 at 512), and hold only
// their two quarters of K, V, Q and dO; each warpgroup keeps its quarter's
// dK and dV, DW / 2 + DW / 2 accumulators a thread. Per 32-query step each
// warpgroup forms the f32 partials of Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ over its
// quarter (DW / 16 k-steps), posts them to its CTA's shared memory in
// fragment order, and after one cluster barrier reads the three other
// quarters' (its sibling's here, two from the peer CTA through distributed
// shared memory) and sums them as (u0 + u1) + (u2 + u3), the same order in
// all four warpgroups, so all four hold bit-identical Pᵀ and dSᵀ; then dV
// += bf16(Pᵀ)·dO and dK += bf16(dSᵀ)·Q over its quarter from registers
// (m64nDWk16). The exchange is double-buffered by step parity, so the one
// barrier a step also frees the buffer of the step before: a warpgroup
// posts to buffer b only after every warpgroup of the cluster has passed
// the barrier of the step that read it last. A CTA's tiles are 256
// columns wide, quarter w at columns 128 w (panels 2 w, 2 w + 1), so each
// quarter starts on a 64-column panel (an MN-major operand cannot start
// inside one); at DW 96 columns 96..127 of each quarter are never copied
// nor read. Shared memory: K and V 64 KiB, two stages of (Q, dO) 64, the
// exchange 64, the lse and delta rows 0.5 and 1 of alignment: 193.5 KiB,
// one CTA an SM, at both widths.
// DW: the columns of dK and dV a warpgroup owns (96, 128), D = 4 DW
template <int DW>
struct DkvClusterCfg {
  static constexpr int DT = 256;    // a CTA's tile: two quarters of 128
  static constexpr int BKV = 64;    // keys per cluster
  static constexpr int BQ = 32;     // query rows per step
  static constexpr int THREADS = 256;
  using KT = dl4j_mma::Tile<DT, BKV>;
  using QT = dl4j_mma::Tile<DT, BQ>;
  // K, V, two stages of (Q, dO), the exchange (two buffers of Sᵀ and dPᵀ
  // partials, 64 x 32 f32 a warpgroup), then two stages of (lse, delta)
  static constexpr int ROWS = 2 * KT::BYTES + 4 * QT::BYTES;
  static constexpr int XCH = 2 * 2 * 2 * BKV * BQ * 4;
  static constexpr int SMEM = ROWS + XCH + 4 * BQ * 4 + 1024;
};
static_assert(DkvClusterCfg<96>::SMEM <= 232448, "227 KiB a block on sm_90");
static_assert(DkvClusterCfg<128>::SMEM <= 232448, "227 KiB a block on sm_90");

// rows [r0, r0 + R) of the CTA's two quarters (global 8-column chunks
// (2 rank + w) DW / 8 + j, j < DW / 8) of a (T, d) operand into a
// Tile<256, R> at columns 128 w + 8 j; rows >= T and chunks past the dc
// real ones read as 0
template <int R, int DW, int NT>
__device__ __forceinline__ void load_quarters(uint32_t s,
                                              const dl4j_mma::bf16* g,
                                              long long st, int r0, int T,
                                              int dc, int rank, int tid) {
  using TT = dl4j_mma::Tile<256, R>;
  constexpr int CW = DW / 8;  // chunks of a quarter
  constexpr int N = R * 2 * CW;
#pragma unroll
  for (int i = 0; i < (N + NT - 1) / NT; ++i) {
    const int e = tid + i * NT;
    if (N % NT != 0 && e >= N) break;
    const int r = e / (2 * CW);
    const int j = e - r * 2 * CW;
    const int w = j / CW;
    const int c = j - w * CW;
    const int gc = (2 * rank + w) * CW + c;
    const int row = r0 + r;
    const bool ok = row < T && gc < dc;
    dl4j_mma::cp_async16(s + TT::off(r, 16 * w + c),
                         g + (ok ? row * st + gc * 8 : 0), ok);
  }
}

// x = (u0 + u1) + (u2 + u3) of a 64 x 32 product of which this warpgroup
// holds quarter u's partial in x, the others' posted in fragment order
// (float4 j of thread wt of quarter v at slot v & 1 of CTA v >> 1:
// slots + (v & 1) * 4 * 128 + j * 128, `slots` at thread wt already)
template <int N>
__device__ __forceinline__ void sum_quarters(float (&x)[N],
                                             const float4* slots, int u) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    float4 part[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      if (v == u) {
        part[v] = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2],
                              x[4 * j + 3]);
      } else {
        const float4* const src = slots + (v & 1) * (N / 4) * 128 + j * 128;
        part[v] = dl4j_mma::ld_cluster_f4(
            dl4j_mma::peer_addr(dl4j_mma::smem_u32(src), v >> 1));
      }
    }
    x[4 * j] = (part[0].x + part[1].x) + (part[2].x + part[3].x);
    x[4 * j + 1] = (part[0].y + part[1].y) + (part[2].y + part[3].y);
    x[4 * j + 2] = (part[0].z + part[1].z) + (part[2].z + part[3].z);
    x[4 * j + 3] = (part[0].w + part[1].w) + (part[2].w + part[3].w);
  }
}

// launched in clusters of two CTAs along x (launch_clusters<2>)
template <int DW>
__global__ void __launch_bounds__(DkvClusterCfg<DW>::THREADS, 1)
flash_bwd_dkv_wgmma_cluster_kernel(const dl4j_mma::bf16* __restrict__ q,
                                   const dl4j_mma::bf16* __restrict__ k,
                                   const dl4j_mma::bf16* __restrict__ v,
                                   const dl4j_mma::bf16* __restrict__ dout,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ delta,
                                   dl4j_mma::bf16* __restrict__ dk,
                                   dl4j_mma::bf16* __restrict__ dv, int H,
                                   int Tlen, int dr, Str sq, Str sk, Str sv,
                                   Str sdo, Str sdk, Str sdv, float scale,
                                   int causal) {
  using namespace dl4j_mma;
  using C = DkvClusterCfg<DW>;
  using KT = typename C::KT;
  using QT = typename C::QT;
  constexpr int BQ = C::BQ;
  constexpr int NT = C::THREADS;
  constexpr int NS = BQ / 2;        // Sᵀ / dPᵀ accumulators a thread holds
  constexpr int NX = NS / 4;        // float4s of them
  constexpr int KQ = DW / 16;       // k-steps of a quarter's partial
  constexpr int NDW = DW / 8;       // n-tiles of a warpgroup's dK and dV
  // float4s of one warpgroup's partial of one product
  constexpr int SLOT = NX * 128;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  unsigned char* const gbase = smem + (base - smem_u32(smem));
  const uint32_t s_k = base;
  const uint32_t s_v = s_k + KT::BYTES;
  const uint32_t s_ring = s_v + KT::BYTES;  // stage st: Q, then dO
  const uint32_t s_rows = base + C::ROWS + C::XCH;  // stage st: lse, delta
  // buffer b, product p (Sᵀ, dPᵀ), warpgroup w at slot (2 b + p) 2 + w
  float4* const xch = reinterpret_cast<float4*>(gbase + C::ROWS);
  const float* const rows_ptr =
      reinterpret_cast<const float*>(gbase + C::ROWS + C::XCH);

  const int rank = (int)cluster_ctarank();  // this CTA's half of D
  const int bh = blockIdx.x >> 1;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * C::BKV;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int wt = tid & 127;          // the thread within its warpgroup
  const int warp = wt >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int u = 2 * rank + wg;       // this warpgroup's quarter of D
  const int wkey = k0 + warp * 16;   // this warp's first key
  const int dc = dr >> 3;            // real 8-column chunks of a row
  const float sl2 = scale * kLog2e;
  // the byte offsets of this warpgroup's quarter (panels 2 wg, 2 wg + 1)
  // in the K, V and in the Q, dO tiles
  const uint32_t qk = 2 * wg * KT::PANEL_BYTES;
  const uint32_t qq = 2 * wg * QT::PANEL_BYTES;

  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* dob = dout + b * sdo.b + h * sdo.h;
  const float* lseb = lse + (long long)bh * Tlen;
  const float* deltab = delta + (long long)bh * Tlen;
  // causal: query tiles above the cluster's first key see none of its keys
  const int first = causal ? k0 / BQ : 0;
  const int nqt = (Tlen + BQ - 1) / BQ;

  // query tile `it` into ring stage `st`
  auto fetch = [&](int it, int st) {
    const uint32_t tq = s_ring + st * 2 * QT::BYTES;
    const int i0 = it * BQ;
    load_quarters<BQ, DW, NT>(tq, qb, sq.t, i0, Tlen, dc, rank, tid);
    load_quarters<BQ, DW, NT>(tq + QT::BYTES, dob, sdo.t, i0, Tlen, dc,
                              rank, tid);
    if (tid < BQ) {
      const int row = i0 + tid;
      const bool ok = row < Tlen;
      const uint32_t r = s_rows + st * 2 * BQ * 4;
      cp_async4(r + 4 * tid, lseb + (ok ? row : 0), ok);
      cp_async4(r + 4 * (BQ + tid), deltab + (ok ? row : 0), ok);
    }
  };
  load_quarters<C::BKV, DW, NT>(s_k, k + b * sk.b + h * sk.h, sk.t, k0,
                                Tlen, dc, rank, tid);
  load_quarters<C::BKV, DW, NT>(s_v, v + b * sv.b + h * sv.h, sv.t, k0,
                                Tlen, dc, rank, tid);
  fetch(first, 0);
  cp_async_commit();

  // n-tile d of this warp's keys, columns DW u + 8 d .., at [4d..4d+3]
  float dka[DW / 2], dva[DW / 2];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) dka[i] = dva[i] = 0.f;

  for (int it = first; it < nqt; ++it) {
    const int st = (it - first) & 1;
    if (it + 1 < nqt) fetch(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this stage (and K, V) have landed
    __syncthreads();
    const uint32_t s_q = s_ring + st * 2 * QT::BYTES;
    const uint32_t s_do = s_q + QT::BYTES;
    const float* ls = rows_ptr + st * 2 * BQ;
    const float* dl = ls + BQ;
    const int i0 = it * BQ;

    // this quarter's partials of Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ
    float sacc[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sacc[i] = dp[i] = 0.f;
    fence_regs(sacc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk)
      wgmma_ss<BQ>(sacc, KT::desc_k(s_k + qk, kk), QT::desc_k(s_q + qq, kk));
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk)
      wgmma_ss<BQ>(dp, KT::desc_k(s_v + qk, kk), QT::desc_k(s_do + qq, kk));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sacc);
    fence_regs(dp);

    // post both to buffer st, meet the cluster, then sum the four
    // quarters' partials as (u0 + u1) + (u2 + u3)
    float4* const mine = xch + (4 * st + wg) * SLOT + wt;
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      mine[j * 128] = make_float4(sacc[4 * j], sacc[4 * j + 1],
                                  sacc[4 * j + 2], sacc[4 * j + 3]);
      mine[2 * SLOT + j * 128] = make_float4(dp[4 * j], dp[4 * j + 1],
                                             dp[4 * j + 2], dp[4 * j + 3]);
    }
    cluster_sync();
    sum_quarters(sacc, xch + 4 * st * SLOT + wt, u);
    sum_quarters(dp, xch + (4 * st + 2) * SLOT + wt, u);

    // Pᵀ = exp(Sᵀ·scale - lse); only tiles that cross the diagonal or T
    // are masked
    const bool edge = i0 + BQ > Tlen || (causal && i0 < wkey + 15);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int qi = 8 * (i >> 2) + 2 * t4 + (i & 1);
      float p = exp2_approx(fmaf(sacc[i], sl2, -ls[qi] * kLog2e));
      if (edge) {
        const int row = i0 + qi;
        const int key = wkey + g + 8 * ((i >> 1) & 1);
        if (row >= Tlen || (causal && row < key)) p = 0.f;
      }
      sacc[i] = p;
    }
    // bf16(Pᵀ) and dSᵀ = bf16(Pᵀ ∘ (dPᵀ - delta)·scale) as A fragments
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 8 * kk + 2 * i;
        const int qi = 8 * (j >> 2) + 2 * t4;
        pa[kk][i] = pack_bf16(sacc[j], sacc[j + 1]);
        da[kk][i] = pack_bf16(sacc[j] * (dp[j] - dl[qi]) * scale,
                              sacc[j + 1] * (dp[j + 1] - dl[qi + 1]) * scale);
      }
    // dV += Pᵀ·dO and dK += dSᵀ·Q over this warpgroup's quarter
    fence_regs(dva);
    fence_regs(dka);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<DW>(dva, pa[kk], QT::desc_mn(s_do + qq, kk));
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<DW>(dka, da[kk], QT::desc_mn(s_q + qq, kk));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dva);
    fence_regs(dka);
    __syncthreads();  // this stage is free again
  }
  // no CTA leaves while its peer may still read its exchange
  cluster_sync();

  bf16* dkb = dk + b * sdk.b + h * sdk.h;
  bf16* dvb = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = wkey + g + 8 * r;
    if (key < Tlen) {
#pragma unroll
      for (int d = 0; d < NDW; ++d) {
        const int c = NDW * u + d;  // the 8-column chunk of the row
        if (c < dc) {  // the padded columns are never written
          *reinterpret_cast<uint32_t*>(dkb + key * sdk.t + 8 * c + 2 * t4) =
              pack_bf16(dka[4 * d + 2 * r], dka[4 * d + 2 * r + 1]);
          *reinterpret_cast<uint32_t*>(dvb + key * sdv.t + 8 * c + 2 * t4) =
              pack_bf16(dva[4 * d + 2 * r], dva[4 * d + 2 * r + 1]);
        }
      }
    }
  }
}

// ------------------------------- bf16 dQ, warpgroup MMA (wgmma)

template <int D>
struct DqCfg {
  static constexpr int BQ = 64;  // query rows per block: one warpgroup
  static constexpr int BK = 64;  // keys per step
  static constexpr int THREADS = 128;
  using QT = dl4j_mma::Tile<D, BQ>;
  using KT = dl4j_mma::Tile<D, BK>;
  // Q, dO, then two stages of (K, V), and room to align to 1024 bytes
  static constexpr int SMEM = 2 * QT::BYTES + 4 * KT::BYTES + 1024;
};

// dQ, bf16: one block per (b*h, 64-query tile), one warpgroup (4 warps of
// 16 rows); per key tile of 64 rows, from key 0 up to the diagonal:
//   S = Q·Kᵀ·scale, masked; P = exp(S - lse); dP = dO·Vᵀ;
//   dS = bf16(P ∘ (dP - delta)·scale); dQ += dS·K.
// The mirror image of flash_bwd_dkv_wgmma_kernel: Q and dO stay in shared
// memory, K and V stream through the double-buffered cp.async ring, S and
// dP are issued together from K-major descriptors, dS goes from S's
// accumulator fragments to a bf16 register A operand and meets the same K
// tile through an MN-major (transposed) descriptor.
template <int D>
__global__ void __launch_bounds__(DqCfg<D>::THREADS)
flash_bwd_dq_wgmma_kernel(const dl4j_mma::bf16* __restrict__ q,
                          const dl4j_mma::bf16* __restrict__ k,
                          const dl4j_mma::bf16* __restrict__ v,
                          const dl4j_mma::bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          dl4j_mma::bf16* __restrict__ dq, int H, int Tlen,
                          int dr, Str sq, Str sk, Str sv, Str sdo, Str sdq,
                          float scale, int causal) {
  using namespace dl4j_mma;
  using C = DqCfg<D>;
  using QT = typename C::QT;
  using KT = typename C::KT;
  constexpr int BQ = C::BQ;
  constexpr int BK = C::BK;
  constexpr int NS = BK / 2;  // S / dP accumulators a thread holds
  constexpr int ND = D / 8;   // n-tiles of dQ (dc of them real)
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t s_q = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t s_do = s_q + QT::BYTES;
  const uint32_t s_kv = s_do + QT::BYTES;  // stage st: K, then V

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  // query tiles on the slow dimension, the heaviest (last) first
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wrow = q0 + warp * 16;  // this warp's first query row
  const int dc = dr >> 3;           // real 8-column chunks of a row
  const float sl2 = scale * kLog2e;

  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const int kend = causal ? min(Tlen, q0 + BQ) : Tlen;
  const int nkt = (kend + BK - 1) / BK;

  QT::template load<C::THREADS>(s_q, q + b * sq.b + h * sq.h, sq.t, q0, Tlen,
                                dc, tid);
  QT::template load<C::THREADS>(s_do, dout + b * sdo.b + h * sdo.h, sdo.t,
                                q0, Tlen, dc, tid);
  KT::template load<C::THREADS>(s_kv, kb, sk.t, 0, Tlen, dc, tid);
  KT::template load<C::THREADS>(s_kv + KT::BYTES, vb, sv.t, 0, Tlen, dc,
                                tid);
  cp_async_commit();

  // the lse (times log2 e) and delta of this thread's rows g and g + 8
  float lr[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + g + 8 * r;
    const bool ok = row < Tlen;
    lr[r] = ok ? lse[(long long)bh * Tlen + row] * kLog2e : 0.f;
    dl[r] = ok ? delta[(long long)bh * Tlen + row] : 0.f;
  }
  float acc[D / 2];  // dQ: n-tile d of this warp's rows in acc[4d..4d+3]
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int j = 0; j < nkt; ++j) {
    const uint32_t s_k = s_kv + (j & 1) * 2 * KT::BYTES;
    const uint32_t s_v = s_k + KT::BYTES;
    if (j + 1 < nkt) {
      const uint32_t n_k = s_kv + ((j + 1) & 1) * 2 * KT::BYTES;
      KT::template load<C::THREADS>(n_k, kb, sk.t, (j + 1) * BK, Tlen, dc,
                                    tid);
      KT::template load<C::THREADS>(n_k + KT::BYTES, vb, sv.t, (j + 1) * BK,
                                    Tlen, dc, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and Q, dO) have landed
    __syncthreads();
    const int k0 = j * BK;

    // S = Q·Kᵀ and dP = dO·Vᵀ, issued together
    float sacc[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sacc[i] = dp[i] = 0.f;
    fence_regs(sacc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BK>(sacc, QT::desc_k(s_q, kk), KT::desc_k(s_k, kk));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BK>(dp, QT::desc_k(s_do, kk), KT::desc_k(s_v, kk));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sacc);
    fence_regs(dp);

    // dS = P ∘ (dP - delta)·scale, P = exp(S·scale - lse); only tiles that
    // cross the diagonal or T are masked
    const bool edge = k0 + BK > Tlen || (causal && k0 + BK - 1 > wrow);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i >> 1) & 1;
      float p = exp2_approx(fmaf(sacc[i], sl2, -lr[r]));
      if (edge) {
        const int key = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        const int row = wrow + g + 8 * r;
        if (key >= Tlen || (causal && key > row)) p = 0.f;
      }
      sacc[i] = p * (dp[i] - dl[r]) * scale;
    }
    // bf16(dS) as the A fragments of dQ += dS·K, K read transposed
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        da[kk][i] = pack_bf16(sacc[8 * kk + 2 * i], sacc[8 * kk + 2 * i + 1]);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<D>(acc, da[kk], KT::desc_mn(s_k, kk));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    __syncthreads();  // stage j & 1 is consumed before it is refilled
  }

  bf16* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + g + 8 * r;
    if (row < Tlen) {
#pragma unroll
      for (int d = 0; d < ND; ++d)
        if (d < dc)  // the padded columns are never written
          *reinterpret_cast<uint32_t*>(dqb + row * sdq.t + 8 * d + 2 * t4) =
              pack_bf16(acc[4 * d + 2 * r], acc[4 * d + 2 * r + 1]);
    }
  }
}

// ---------------- bf16 dQ at padded D 256, two warpgroups (wgmma)

// The mirror image of flash_bwd_dkv_wgmma_split_kernel. At padded D 256
// one warpgroup's dQ would be 128 f32 accumulators a thread beside S and
// dP's 2 x 32, past the 255 registers a thread may hold. Two consumer
// warpgroups (256 threads) share the block's 64 query rows instead:
// warpgroup w owns columns [128 w, 128 w + 128) of dQ, 64 accumulators a
// thread. S = Q·Kᵀ and dP = dO·Vᵀ are computed once, split along their
// depth D: each warpgroup forms the f32 partial over its own 128 columns
// (k-steps 8 w .. 8 w + 7), the two trade partials through shared memory
// (trade_halves: S, then dP), and both add the two halves, so both hold
// bit-identical P and dS. Each feeds bf16(dS) from registers as the A
// operand of its own N = 128 product dQ += dS·K, reading its column half
// of the K tile (panels 2 w and 2 w + 1) through an MN-major descriptor.
// Shared memory: Q and dO 64 KiB, two stages of (K, V) 128 KiB, the
// exchange 32 KiB and 1 KiB of alignment, 225 KiB: one block an SM. Each
// thread keeps the lse and delta of its two rows in registers.
//
// The same kernel past D 256, padded to 384 or 512 (wide_padded_dim): each
// warpgroup owns one half of dQ's columns, 192 or 256 (three or four
// 64-column panels, so a half starts on a panel: 96 or 128 accumulators a
// thread), and forms the f32 partials of S and dP over its half (design
// (a) of K1's wide kernels: the depth split traded through shared memory,
// as at 256, not S whole in each warpgroup; the trade costs two barriers
// a step, S whole would cost 2.5 / 1.5 of the products). Q and dO stay
// resident (96 / 128 KiB), so K and V stream in shorter steps: 32 keys at
// 384 (two stages 96 KiB, the exchange 16: 209 KiB), 16 at 512 (64 and 8:
// 201 KiB); one block an SM. DP is the padded D, KB the keys a step.
template <int DP, int KB>
struct DqSplitCfg {
  static constexpr int D = DP;
  static constexpr int DH = D / 2;  // columns of dQ a warpgroup owns
  static constexpr int BQ = 64;     // query rows per block
  static constexpr int BK = KB;     // keys per step
  static constexpr int THREADS = 256;
  using QT = dl4j_mma::Tile<D, BQ>;
  using KT = dl4j_mma::Tile<D, BK>;
  // Q, dO, two stages of (K, V), then the exchange (a 64 x BK f32 partial
  // a warpgroup)
  static constexpr int ROWS = 2 * QT::BYTES + 4 * KT::BYTES;
  static constexpr int XCH = 2 * BQ * BK * 4;
  static constexpr int SMEM = ROWS + XCH + 1024;
};
static_assert(DqSplitCfg<256, 64>::SMEM <= 232448, "227 KiB a block on sm_90");
static_assert(DqSplitCfg<384, 32>::SMEM <= 232448, "227 KiB a block on sm_90");
static_assert(DqSplitCfg<512, 16>::SMEM <= 232448, "227 KiB a block on sm_90");

template <typename C>
__global__ void __launch_bounds__(C::THREADS, 1)
flash_bwd_dq_wgmma_split_kernel(const dl4j_mma::bf16* __restrict__ q,
                                const dl4j_mma::bf16* __restrict__ k,
                                const dl4j_mma::bf16* __restrict__ v,
                                const dl4j_mma::bf16* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                dl4j_mma::bf16* __restrict__ dq, int H,
                                int Tlen, int dr, Str sq, Str sk, Str sv,
                                Str sdo, Str sdq, float scale, int causal) {
  using namespace dl4j_mma;
  using QT = typename C::QT;
  using KT = typename C::KT;
  constexpr int BK = C::BK;
  constexpr int NS = BK / 2;        // S / dP accumulators a thread holds
  constexpr int NX = NS / 4;        // float4s of them
  constexpr int KH = C::DH / 16;    // k-steps of a half's partial
  constexpr int NDH = C::DH / 8;    // n-tiles of a warpgroup's dQ
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  unsigned char* const gbase = smem + (base - smem_u32(smem));
  const uint32_t s_q = base;
  const uint32_t s_do = s_q + QT::BYTES;
  const uint32_t s_kv = s_do + QT::BYTES;  // stage st: K, then V
  float4* const xch = reinterpret_cast<float4*>(gbase + C::ROWS);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  // query tiles on the slow dimension, the heaviest (last) first
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * C::BQ;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;           // this warpgroup's column half
  const int wt = tid & 127;          // the thread within its warpgroup
  const int warp = wt >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wrow = q0 + warp * 16;  // this warp's first query row
  const int dc = dr >> 3;           // real 8-column chunks of a row
  const float sl2 = scale * kLog2e;
  // this warpgroup's partials go to `mine`, the other's come from `theirs`
  float4* const mine = xch + wg * NX * 128;
  const float4* const theirs = xch + (wg ^ 1) * NX * 128;
  // the byte offsets of this warpgroup's column half (DH / 64 panels from
  // panel wg DH / 64) in the Q and dO tiles and in the K and V tiles: its
  // k-steps of S and dP, and its N = DH of dQ
  const uint32_t half_q = (C::DH / 64) * wg * QT::PANEL_BYTES;
  const uint32_t half_k = (C::DH / 64) * wg * KT::PANEL_BYTES;

  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const int kend = causal ? min(Tlen, q0 + C::BQ) : Tlen;
  const int nkt = (kend + BK - 1) / BK;

  QT::template load<C::THREADS>(s_q, q + b * sq.b + h * sq.h, sq.t, q0, Tlen,
                                dc, tid);
  QT::template load<C::THREADS>(s_do, dout + b * sdo.b + h * sdo.h, sdo.t,
                                q0, Tlen, dc, tid);
  KT::template load<C::THREADS>(s_kv, kb, sk.t, 0, Tlen, dc, tid);
  KT::template load<C::THREADS>(s_kv + KT::BYTES, vb, sv.t, 0, Tlen, dc,
                                tid);
  cp_async_commit();

  // the lse (times log2 e) and delta of this thread's rows g and g + 8
  float lr[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + g + 8 * r;
    const bool ok = row < Tlen;
    lr[r] = ok ? lse[(long long)bh * Tlen + row] * kLog2e : 0.f;
    dl[r] = ok ? delta[(long long)bh * Tlen + row] : 0.f;
  }
  // dQ: n-tile d of this warp's rows, columns DH wg + 8 d .., at [4d..]
  float acc[C::DH / 2];
#pragma unroll
  for (int i = 0; i < C::DH / 2; ++i) acc[i] = 0.f;

  for (int j = 0; j < nkt; ++j) {
    const uint32_t s_k = s_kv + (j & 1) * 2 * KT::BYTES;
    const uint32_t s_v = s_k + KT::BYTES;
    if (j + 1 < nkt) {
      const uint32_t n_k = s_kv + ((j + 1) & 1) * 2 * KT::BYTES;
      KT::template load<C::THREADS>(n_k, kb, sk.t, (j + 1) * BK, Tlen, dc,
                                    tid);
      KT::template load<C::THREADS>(n_k + KT::BYTES, vb, sv.t, (j + 1) * BK,
                                    Tlen, dc, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and Q, dO) have landed
    __syncthreads();
    const int k0 = j * BK;

    // this half's partials of S = Q·Kᵀ and dP = dO·Vᵀ, issued together
    float sacc[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sacc[i] = dp[i] = 0.f;
    fence_regs(sacc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KH; ++kk)
      wgmma_ss<BK>(sacc, QT::desc_k(s_q + half_q, kk),
                   KT::desc_k(s_k + half_k, kk));
#pragma unroll
    for (int kk = 0; kk < KH; ++kk)
      wgmma_ss<BK>(dp, QT::desc_k(s_do + half_q, kk),
                   KT::desc_k(s_v + half_k, kk));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sacc);
    fence_regs(dp);
    trade_halves(sacc, mine, theirs, wt);
    __syncthreads();  // both have read the exchange before it is reused
    trade_halves(dp, mine, theirs, wt);

    // dS = P ∘ (dP - delta)·scale, P = exp(S·scale - lse); only tiles that
    // cross the diagonal or T are masked
    const bool edge = k0 + BK > Tlen || (causal && k0 + BK - 1 > wrow);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i >> 1) & 1;
      float p = exp2_approx(fmaf(sacc[i], sl2, -lr[r]));
      if (edge) {
        const int key = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        const int row = wrow + g + 8 * r;
        if (key >= Tlen || (causal && key > row)) p = 0.f;
      }
      sacc[i] = p * (dp[i] - dl[r]) * scale;
    }
    // bf16(dS) as the A fragments of dQ += dS·K over this warpgroup's
    // column half, K read transposed
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        da[kk][i] = pack_bf16(sacc[8 * kk + 2 * i], sacc[8 * kk + 2 * i + 1]);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<C::DH>(acc, da[kk], KT::desc_mn(s_k + half_k, kk));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    __syncthreads();  // stage j & 1 and the exchange are free again
  }

  bf16* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + g + 8 * r;
    if (row < Tlen) {
#pragma unroll
      for (int d = 0; d < NDH; ++d) {
        const int c = NDH * wg + d;  // the 8-column chunk of the row
        if (c < dc)  // the padded columns are never written
          *reinterpret_cast<uint32_t*>(dqb + row * sdq.t + 8 * c + 2 * t4) =
              pack_bf16(acc[4 * d + 2 * r], acc[4 * d + 2 * r + 1]);
      }
    }
  }
}

Str str_at(const long long* s, int i) { return Str{s[3 * i], s[3 * i + 1],
                                                    s[3 * i + 2]}; }

// launch `kern` on `grid`, in thread-block clusters of NC CTAs along x
// where NC > 1 (a grid of whole clusters); cudaGetLastError() after it
template <int NC, typename... Params, typename... Args>
int launch_clusters(void (*kern)(Params...), dim3 grid, int threads,
                    int smem, cudaStream_t st, Args... args) {
  if constexpr (NC == 1) {
    kern<<<grid, threads, smem, st>>>(args...);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = NC;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, args...);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// bf16 only: f32 runs the split-TF32 kernels (launch_dq_tf32x3_any)
template <typename T, int D>
int launch_dq(int BH, int Tlen, int dr, cudaStream_t st, const void* q,
              const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int H,
              const long long* s, float scale, int causal) {
  static_assert(sizeof(T) == 2, "the bf16 kernels");
  if constexpr (D >= 256) {  // two warpgroups
    // 64 keys a step at padded 256, 32 at 384, 16 at 512
    using C = DqSplitCfg<D, D == 256 ? 64 : D == 384 ? 32 : 16>;
    auto kern = flash_bwd_dq_wgmma_split_kernel<C>;
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(BH, (Tlen + C::BQ - 1) / C::BQ);
    kern<<<grid, C::THREADS, C::SMEM, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dq), H, Tlen, dr, str_at(s, 0), str_at(s, 1),
        str_at(s, 2), str_at(s, 3), str_at(s, 4), scale, causal);
  } else {  // bf16 D <= 128: one warpgroup
    using C = DqCfg<D>;
    static_assert(C::SMEM <= 232448, "227 KiB a block on sm_90");
    auto kern = flash_bwd_dq_wgmma_kernel<D>;
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(BH, (Tlen + C::BQ - 1) / C::BQ);
    kern<<<grid, C::THREADS, C::SMEM, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dq), H, Tlen, dr, str_at(s, 0), str_at(s, 1),
        str_at(s, 2), str_at(s, 3), str_at(s, 4), scale, causal);
  }
  return (int)cudaGetLastError();
}

// bf16 only: f32 runs the split-TF32 kernels (launch_dkv_tf32x3_any)
template <typename T, int D>
int launch_dkv(int BH, int Tlen, int dr, cudaStream_t st, const void* q,
               const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int H,
               const long long* s, float scale, int causal) {
  static_assert(sizeof(T) == 2, "the bf16 kernels");
  if constexpr (D > 256) {  // a cluster of two CTAs
    using C = DkvClusterCfg<D / 4>;
    auto kern = flash_bwd_dkv_wgmma_cluster_kernel<D / 4>;
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    // key tiles on the slow dimension: the heaviest (first) go first
    const dim3 grid(2 * BH, (Tlen + C::BKV - 1) / C::BKV);
    return launch_clusters<2>(
        kern, grid, C::THREADS, C::SMEM, st, static_cast<const T*>(q),
        static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dk),
        static_cast<T*>(dv), H, Tlen, dr, str_at(s, 0), str_at(s, 1),
        str_at(s, 2), str_at(s, 3), str_at(s, 4), str_at(s, 5), scale,
        causal);
  } else if constexpr (D == 256) {  // two warpgroups
    using C = DkvSplitCfg;
    auto kern = flash_bwd_dkv_wgmma_split_kernel;
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(BH, (Tlen + C::BKV - 1) / C::BKV);
    kern<<<grid, C::THREADS, C::SMEM, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dk), static_cast<T*>(dv), H, Tlen, dr, str_at(s, 0),
        str_at(s, 1), str_at(s, 2), str_at(s, 3), str_at(s, 4),
        str_at(s, 5), scale, causal);
  } else {  // bf16 D <= 128: one warpgroup
    using C = DkvCfg<D>;
    static_assert(C::SMEM <= 232448, "227 KiB a block on sm_90");
    auto kern = flash_bwd_dkv_wgmma_kernel<D>;
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    // key tiles on the slow dimension: the heaviest (first) go first
    const dim3 grid(BH, (Tlen + C::BKV - 1) / C::BKV);
    kern<<<grid, C::THREADS, C::SMEM, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dk), static_cast<T*>(dv), H, Tlen, dr, str_at(s, 0),
        str_at(s, 1), str_at(s, 2), str_at(s, 3), str_at(s, 4),
        str_at(s, 5), scale, causal);
  }
  return (int)cudaGetLastError();
}

// --------- f32 dQ and dK/dV at D 129..256, split-TF32 tensor-core products

// Both kernels run every product on the tensor cores as three TF32
// products per f32 product (flash_tf32.cuh), mma.sync m16n8k8, padded to
// D 256 (columns past D zero-filled, never stored); P and dS (and Pᵀ,
// dSᵀ) split into hi and lo too, as the f32 reference rounds neither.
// Every tile lives in shared memory as rows of 256 floats in the
// swizzled layout of flash_tf32.cuh (swz), because each streamed operand
// is read two ways: K in dQ as the B operand of S = Q·Kᵀ (k = dim) and of
// dQ += dS·K (k = key), Q and dO in dK/dV as the B operands of Sᵀ = K·Qᵀ
// and dPᵀ = V·dOᵀ (k = dim) and of dK += dSᵀ·Q and dV += Pᵀ·dO (k =
// query). The k index of each product is permuted as in K1's split-TF32
// kernel: over the head dim a pair of k-steps covers 16 dims and thread
// (g, t) reads a float4 at dims 4t..4t+3 (the first k-step taking 4t,
// 4t+1 as k indices t, t + 4, the second 4t+2, 4t+3); over a tile's rows,
// the accumulator fragments of S (dP, Sᵀ, dPᵀ) are the A fragments of the
// next product with row 2t as k index t and 2t + 1 as t + 4, so thread
// (g, t) reads rows 2t and 2t + 1 of the B operand, and the output's
// columns are permuted (n-tile u of column group c holds columns
// 32 c + 4 n + u) so that it reads them as float4s at columns 32 c + 4 g.
// A thread holds an output row g at columns 32 c + 8 t .. + 7. The fixed
// tiles and fixed-order merges make a second launch bit-identical; there
// are no atomics.
//
// What bounds them: operations, 3 TF32 products per f32 multiply-add
// (495 TFLOP/s dense) against 67 TFLOP/s of f32 on the CUDA cores, and
// the shared-memory reads: every warp re-reads the resident operand of
// each step's products and splits it again.

// dQ: a block owns one (b*h, 32-query tile) and 8 warps: two row groups of
// 16 rows and in each four warps that split every step's 32 keys, 8 each.
// Q and dO stay in shared memory (64 KiB); K and V stream through a
// double-buffered cp.async ring of 32-key stages (128 KiB); each thread
// keeps the lse (times log2 e) and delta of its rows g and g + 8 in
// registers. Per step a warp forms S = Q·Kᵀ and dP = dO·Vᵀ (16 x 8 each),
// then P = exp2(S·scale·log2 e - lse·log2 e) and dS = P∘(dP - delta)·scale
// on S's fragments, and adds dQ += dS·K to its 16 x 256 partial (128 f32
// registers a thread). At the end the four warps of a row group post
// their partials through the ring's 128 KiB in fragment order and each
// sums two column groups of the four in order 0 + 1 + 2 + 3 and stores
// them. 32-query tiles (not 64) halve the causal grid's heaviest block,
// which sets the time of a one-wave grid (B1 H8 T1024: 256 blocks, not
// 128); the grid's slow dimension walks the query tiles, the heaviest
// (last) first. 192 KiB: one block an SM.
//
// f32 dQ and dK/dV past D 256, padded to DP = 320, 384 or 512 (a half is
// whole 32-column groups): a warp's 16-row partial of D columns would be
// DP / 2 f32 registers a thread (160 to 256) and Q and dO of 32 rows with
// two stages of K and V 240 KiB at 320. So the split-TF32 kernels below
// run on a thread-block cluster of two CTAs (adjacent in x) that split D's
// columns:
// CTA c holds columns [c DP / 2, (c + 1) DP / 2) of every operand, tiles
// of D = DP / 2 floats a row (the same swizzle: every row starts on bank
// 0), and each warp's partials of S and dP (dQ) or of Sᵀ and dPᵀ (dK/dV)
// are over those columns only. Once a step, after both products, each
// warp posts its two 16 x 8 tiles (a float4 a lane each) to its CTA's
// exchange, one cluster barrier, and adds its peer warp's, read through
// distributed shared memory: x = mine + peer's, one f32 addition, which is
// commutative, so both CTAs hold the same S and dP bit for bit and
// compute the same P and dS. The exchange is double-buffered by step
// parity (the one barrier a step also frees the buffer of the step
// before). Then each CTA adds its columns of dQ (or dK, dV) as at 256. At
// DP 512 a CTA is the padded-256 block plus its 16 KiB exchange (dQ 208,
// dK/dV 212.5 KiB); at 320 and 384 136 / 160 KiB (dQ) and 140.5 / 164.5
// KiB (dK/dV). One CTA an SM. DP is the padded D, CTAS the CTAs a
// cluster: (256, 1) is the one-CTA block above, (320 | 384 | 512, 2) a
// cluster.
template <int DP, int CTAS>
struct Tf32DqCfg {
  static constexpr int NC = CTAS;      // CTAs a cluster
  static constexpr int D = DP / NC;    // the columns a CTA holds
  static constexpr int BQ = 32;        // query rows: 2 groups of 16
  static constexpr int BK = 32;        // keys per step: 4 warps of 8
  static constexpr int THREADS = 256;  // 8 warps: 2 row groups x 4 key parts
  static constexpr int TILE = D * 4;   // bytes a row
  // on a cluster, two buffers of each warp's S and dP partials (a float4 a
  // lane each)
  static constexpr int XS = (NC - 1) * 2 * 8 * 2 * 32 * 16;
  // Q, dO, two stages of (K, V), then the exchange
  static constexpr int SMEM = 2 * BQ * TILE + 2 * 2 * BK * TILE + XS;
};
static_assert(Tf32DqCfg<256, 1>::D == dl4j_tf32::kD,
              "the split-TF32 padded width");
static_assert(Tf32DqCfg<256, 1>::BQ == 32 && Tf32DqCfg<256, 1>::BK == 32,
              "the warps: two 16-row groups, four 8-key parts");

// x += y, elementwise
__device__ __forceinline__ void add4(float (&x)[4], float4 y) {
  x[0] += y.x;
  x[1] += y.y;
  x[2] += y.z;
  x[3] += y.w;
}

// acc (16 x 32 NG, permuted columns) += X·B, X an accumulator fragment
// (16 x 8: rows g, g + 8 of columns 2t, 2t + 1) summed over B's rows
// r0 .. r0 + 7 of a swizzled tile: column 2t of X is k index t (B's row
// r0 + 2t), 2t + 1 is k index t + 4
template <int LD = dl4j_tf32::kD, int NG = LD / 32>
__device__ __forceinline__ void mma_rows(float (&acc)[NG][4][4],
                                         const float (&x)[4],
                                         const float* tile, int r0, int g,
                                         int t4) {
  using dl4j_tf32::split_tf32;
  uint32_t xh[4], xl[4];
  split_tf32(x[0], xh[0], xl[0]);  // row g, column 2t: k index t
  split_tf32(x[2], xh[1], xl[1]);  // row g + 8, column 2t
  split_tf32(x[1], xh[2], xl[2]);  // row g, column 2t + 1: k index t + 4
  split_tf32(x[3], xh[3], xl[3]);  // row g + 8, column 2t + 1
  const int r = r0 + 2 * t4;
#pragma unroll
  for (int c = 0; c < NG; ++c) {
    const float4 b0 = ld4<LD>(tile, r, 8 * c + g);
    const float4 b1 = ld4<LD>(tile, r + 1, 8 * c + g);
    const float x0[4] = {b0.x, b0.y, b0.z, b0.w};
    const float x1[4] = {b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(x0[u], bh0, bl0);
      split_tf32(x1[u], bh1, bl1);
      dl4j_tf32::mma_3xtf32(acc[c][u], xh, xl, bh0, bh1, bl0, bl1);
    }
  }
}

// post this warp's 16 x 32 NG partial at slot w of a fragment-ordered
// exchange (float4 i of lane x at (4 NG w + i) * 32 + x)
template <int NG>
__device__ __forceinline__ void post_acc(float4* xo, int w, int lane,
                                         const float (&acc)[NG][4][4]) {
#pragma unroll
  for (int c = 0; c < NG; ++c)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      xo[(4 * NG * w + 4 * c + u) * 32 + lane] =
          make_float4(acc[c][u][0], acc[c][u][1], acc[c][u][2], acc[c][u][3]);
}

// sum column group c (n-tiles 4c .. 4c + 3) of the N partials of NG
// groups posted at slots w0, w0 + stride, ..., in that order, and store
// rows row0 + g and row0 + g + 8 (those < T) at the columns < dr
template <int N, int NG>
__device__ __forceinline__ void store_sum(float* out, long long st,
                                          const float4* xo, int w0,
                                          int stride, int c, int lane,
                                          int row0, int Tlen, int dr) {
  const int g = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    float4 x = xo[(4 * NG * w0 + 4 * c + u) * 32 + lane];
#pragma unroll
    for (int n = 1; n < N; ++n) {
      const float4 y =
          xo[(4 * NG * (w0 + n * stride) + 4 * c + u) * 32 + lane];
      x.x += y.x;
      x.y += y.y;
      x.z += y.z;
      x.w += y.w;
    }
    const float val[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + g + 8 * (i >> 1);
      const int col = 32 * c + 8 * t4 + 4 * (i & 1) + u;
      if (row < Tlen && col < dr)  // the padded columns are never written
        out[row * st + col] = val[i];
    }
  }
}

// C: a Tf32DqCfg (one CTA, or a cluster of C::NC = 2 CTAs)
template <typename C>
__global__ void __launch_bounds__(C::THREADS, 1)
flash_bwd_dq_tf32x3_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq, int H, int Tlen, int dr,
                           Str sq, Str sk, Str sv, Str sdo, Str sdq,
                           float scale, int causal, int vec) {
  using namespace dl4j_mma;
  using dl4j_tf32::load_f32_tile;
  constexpr int NC = C::NC;
  constexpr int BQ = C::BQ;
  constexpr int BK = C::BK;
  constexpr int D = C::D;             // the columns this CTA holds
  constexpr int NG = D / 32;          // their column groups
  constexpr int NT = C::THREADS;
  constexpr int KW = 8;               // keys of a step a warp takes
  constexpr int STAGE = 2 * BK * D;   // floats: K, then V
  extern __shared__ __align__(16) float fsm[];
  float* const qs = fsm;
  float* const dos = qs + BQ * D;
  float* const kvs = dos + BQ * D;
  // the cluster's exchange: warp w's S (then dP) of buffer b, lane x at
  // float4 (8 b + w) 64 + x (+ 32)
  float4* const xs = reinterpret_cast<float4*>(kvs + 2 * STAGE);

  // this CTA's columns [rank D, rank D + D) and how many of them are real
  const int rank = NC > 1 ? (int)cluster_ctarank() : 0;
  const int col0 = rank * D;
  dr = min(max(dr - col0, 0), D);
  const int bh = blockIdx.x / NC;
  const int b = bh / H;
  const int h = bh - b * H;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int rg = warp & 1;           // this warp's 16 query rows
  const int kw = (warp >> 1) * KW;   // and its 8 keys of each step
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wrow = q0 + rg * 16;     // this warp's first query row
  const float sl2 = scale * kLog2e;

  const float* kb = k + b * sk.b + h * sk.h + col0;
  const float* vb = v + b * sv.b + h * sv.h + col0;
  const int kend = causal ? min(Tlen, q0 + BQ) : Tlen;
  const int nkt = (kend + BK - 1) / BK;

  load_f32_tile<BQ, D, NT, true, D>(qs, q + b * sq.b + h * sq.h + col0, sq.t,
                                    q0, Tlen, dr, vec, tid);
  load_f32_tile<BQ, D, NT, true, D>(dos, dout + b * sdo.b + h * sdo.h + col0,
                                    sdo.t, q0, Tlen, dr, vec, tid);
  load_f32_tile<BK, D, NT, true, D>(kvs, kb, sk.t, 0, Tlen, dr, vec, tid);
  load_f32_tile<BK, D, NT, true, D>(kvs + BK * D, vb, sv.t, 0, Tlen, dr, vec,
                                    tid);
  cp_async_commit();

  // the lse (times log2 e) and delta of this thread's rows g and g + 8
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + g + 8 * r;
    const bool ok = row < Tlen;
    l2[r] = ok ? lse[(long long)bh * Tlen + row] * kLog2e : 0.f;
    dl[r] = ok ? delta[(long long)bh * Tlen + row] : 0.f;
  }
  float acc[NG][4][4];
#pragma unroll
  for (int c = 0; c < NG; ++c)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][u][e] = 0.f;

  for (int j = 0; j < nkt; ++j) {
    if (j + 1 < nkt) {
      float* nk = kvs + ((j + 1) & 1) * STAGE;
      load_f32_tile<BK, D, NT, true, D>(nk, kb, sk.t, (j + 1) * BK, Tlen, dr,
                                        vec, tid);
      load_f32_tile<BK, D, NT, true, D>(nk + BK * D, vb, sv.t, (j + 1) * BK,
                                        Tlen, dr, vec, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // stage j (and Q, dO) have landed
    __syncthreads();
    const float* ks = kvs + (j & 1) * STAGE;
    const float* vs = ks + BK * D;
    const int k0 = j * BK + kw;

    // S = Q·Kᵀ and dP = dO·Vᵀ over this warp's 8 keys
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kp = 0; kp < D / 16; ++kp) {
      uint32_t ah[2][4], al[2][4];
      a_frags<D>(qs, rg * 16 + g, kp, t4, ah, al);
      mma_dims<D>(s, ks, kw + g, kp, t4, ah, al);
    }
#pragma unroll
    for (int kp = 0; kp < D / 16; ++kp) {
      uint32_t ah[2][4], al[2][4];
      a_frags<D>(dos, rg * 16 + g, kp, t4, ah, al);
      mma_dims<D>(dp, vs, kw + g, kp, t4, ah, al);
    }
    if constexpr (NC > 1) {
      // S and dP over the whole D: this CTA's columns + the peer's
      float4* const mine = xs + (8 * (j & 1) + warp) * 64 + lane;
      mine[0] = make_float4(s[0], s[1], s[2], s[3]);
      mine[32] = make_float4(dp[0], dp[1], dp[2], dp[3]);
      cluster_sync();
      const uint32_t peer = peer_addr(smem_u32(mine), rank ^ 1);
      add4(s, ld_cluster_f4(peer));
      add4(dp, ld_cluster_f4(peer + 32 * 16));
    }

    // P = exp2(S·scale·log2 e - lse·log2 e) and dS = P∘(dP - delta)·scale
    // in s; only key ranges that cross the diagonal or T are masked
    const bool edge = k0 + KW > Tlen || (causal && k0 + KW - 1 > wrow);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float p = exp2_approx(fmaf(s[e], sl2, -l2[r]));
      if (edge) {
        const int key = k0 + 2 * t4 + (e & 1);
        if (key >= Tlen || (causal && key > wrow + g + 8 * r)) p = 0.f;
      }
      s[e] = p * (dp[e] - dl[r]) * scale;
    }
    // dQ += dS·K over this warp's 8 keys (rows kw .. kw + 7 of the stage)
    mma_rows<D>(acc, s, ks, kw, g, t4);
    __syncthreads();  // stage j & 1 is consumed before it is refilled
  }
  // no CTA leaves while its peer may still read its exchange
  if constexpr (NC > 1) cluster_sync();

  // the four partials of each row group through the ring (the size of all
  // eight), summed in order 0 + 1 + 2 + 3; warp (rg, part p) stores column
  // groups p, p + 4, ...
  cp_async_wait<0>();
  float4* const xo = reinterpret_cast<float4*>(kvs);
  post_acc(xo, warp, lane, acc);
  __syncthreads();
  float* dqb = dq + b * sdq.b + h * sdq.h + col0;
#pragma unroll
  for (int c = warp >> 1; c < NG; c += 4)
    store_sum<4, NG>(dqb, sdq.t, xo, rg, 2, c, lane, wrow, Tlen, dr);
}

// dK/dV: a block owns one (b*h, 32-key tile) and 8 warps in pairs: a dV
// warp and a dK warp for each of two 16-key groups and each 16-query half
// of every step. K and V stay in shared memory (64 KiB); Q, dO and the
// lse and delta rows stream through a double-buffered cp.async ring of
// 32-query stages (128 KiB), from the diagonal down when causal. Per step
// the dV warp forms Sᵀ = K·Qᵀ (16 x 16), Pᵀ = exp2(Sᵀ·scale·log2 e -
// lse·log2 e), posts Pᵀ to its dK warp (1 KiB in fragment order, a named
// barrier of the two warps) and adds dV += Pᵀ·dO; the dK warp forms
// dPᵀ = V·dOᵀ meanwhile, takes Pᵀ, and adds dK += dSᵀ·Q with dSᵀ =
// Pᵀ∘(dPᵀ - delta)·scale. So each warp does two products a step and
// holds one 16 x 256 f32 partial (128 registers a thread), where dK and dV
// together would be 256. At the end the two query halves' partials of
// each output meet through the ring in fragment order, summed in order
// 0 + 1, each warp storing four of the eight column groups. The grid's
// slow dimension walks the key tiles, the heaviest (first) first under
// causal masking. 196.5 KiB: one block an SM.
//
// Past D 256 the same on a cluster of two CTAs that split D's columns
// (Tf32DqCfg above): DP the padded D, CTAS the CTAs a cluster, D = DP /
// CTAS columns a CTA.
template <int DP, int CTAS>
struct Tf32DkvCfg {
  static constexpr int NC = CTAS;      // CTAs a cluster
  static constexpr int D = DP / NC;    // the columns a CTA holds
  static constexpr int BKV = 32;       // keys per block: 2 groups of 16
  static constexpr int BQ = 32;        // query rows per step: 2 halves of 16
  static constexpr int THREADS = 256;  // 8 warps: (dV, dK) x 2 x 2
  static constexpr int TILE = D * 4;   // bytes a row
  // K, V, then two stages of (Q, dO)
  static constexpr int ROWS = 2 * BKV * TILE + 2 * 2 * BQ * TILE;
  // on a cluster, two buffers of each warp's Sᵀ or dPᵀ partial (two
  // n-tiles, a float4 a lane each)
  static constexpr int XS = (NC - 1) * 2 * 8 * 2 * 32 * 16;
  // then two stages of (lse, delta) rows, each pair's Pᵀ (two n-tiles of
  // 32 lanes' float4s), the exchange
  static constexpr int SMEM = ROWS + 2 * 2 * BQ * 4 + 4 * 2 * 32 * 16 + XS;
};
static_assert(Tf32DkvCfg<256, 1>::D == dl4j_tf32::kD,
              "the split-TF32 padded width");
static_assert(Tf32DkvCfg<256, 1>::BQ == 32 && Tf32DkvCfg<256, 1>::BKV == 32,
              "the warps: two 16-key groups, two 16-query halves");

// named barrier `id` of n threads: bar_sync waits, bar_arrive does not
// (both order this thread's earlier shared-memory writes before the
// barrier completes)
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// C: a Tf32DkvCfg (one CTA, or a cluster of C::NC = 2 CTAs)
template <typename C>
__global__ void __launch_bounds__(C::THREADS, 1)
flash_bwd_dkv_tf32x3_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv,
                            int H, int Tlen, int dr, Str sq, Str sk, Str sv,
                            Str sdo, Str sdk, Str sdv, float scale,
                            int causal, int vec) {
  using namespace dl4j_mma;
  using dl4j_tf32::load_f32_tile;
  constexpr int NC = C::NC;
  constexpr int BKV = C::BKV;
  constexpr int BQ = C::BQ;
  constexpr int D = C::D;            // the columns this CTA holds
  constexpr int NG = D / 32;         // their column groups
  constexpr int NT = C::THREADS;
  constexpr int STAGE = 2 * BQ * D;  // floats: Q, then dO
  extern __shared__ __align__(16) float fsm[];
  float* const ks = fsm;
  float* const vs = ks + BKV * D;
  float* const ring = vs + BKV * D;
  float* const rows = ring + 2 * STAGE;  // stage st: lse, then delta
  float4* const xch = reinterpret_cast<float4*>(rows + 2 * 2 * BQ);
  // the cluster's exchange: warp w's two n-tiles of buffer b, lane x at
  // float4 (8 b + w) 64 + 32 n + x
  float4* const xs = xch + 4 * 2 * 32;

  // this CTA's columns [rank D, rank D + D) and how many of them are real
  const int rank = NC > 1 ? (int)cluster_ctarank() : 0;
  const int col0 = rank * D;
  dr = min(max(dr - col0, 0), D);
  const int bh = blockIdx.x / NC;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * BKV;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int pair = warp & 3;        // (key group, query half)
  const int kg = warp & 1;          // this warp's 16 keys
  const int qh = (warp >> 1) & 1;   // and its 16 queries of each step
  const bool dk_warp = warp >= 4;   // else the dV warp of the pair
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wkey = k0 + kg * 16;    // this warp's first key
  const float sl2 = scale * kLog2e;

  const float* qb = q + b * sq.b + h * sq.h + col0;
  const float* dob = dout + b * sdo.b + h * sdo.h + col0;
  const float* lseb = lse + (long long)bh * Tlen;
  const float* deltab = delta + (long long)bh * Tlen;
  // causal: query tiles above the block's first key see none of its keys
  const int first = causal ? k0 / BQ : 0;
  const int nqt = (Tlen + BQ - 1) / BQ;

  // query tile `it` into ring stage `st`: Q, dO, and the lse and delta
  // rows (threads 0 .. 31 and 32 .. 63)
  auto fetch = [&](int it, int st) {
    float* tq = ring + st * STAGE;
    const int i0 = it * BQ;
    load_f32_tile<BQ, D, NT, true, D>(tq, qb, sq.t, i0, Tlen, dr, vec, tid);
    load_f32_tile<BQ, D, NT, true, D>(tq + BQ * D, dob, sdo.t, i0, Tlen, dr,
                                      vec, tid);
    if (tid < 2 * BQ) {
      const int row = i0 + (tid & (BQ - 1));
      const bool ok = row < Tlen;
      const float* src = tid < BQ ? lseb : deltab;
      cp_async4(smem_u32(rows + st * 2 * BQ + tid), src + (ok ? row : 0),
                ok);
    }
  };
  load_f32_tile<BKV, D, NT, true, D>(ks, k + b * sk.b + h * sk.h + col0,
                                     sk.t, k0, Tlen, dr, vec, tid);
  load_f32_tile<BKV, D, NT, true, D>(vs, v + b * sv.b + h * sv.h + col0,
                                     sv.t, k0, Tlen, dr, vec, tid);
  fetch(first, 0);
  cp_async_commit();

  // dV (dV warps) or dK (dK warps) of this warp's keys over its queries
  float acc[NG][4][4];
#pragma unroll
  for (int c = 0; c < NG; ++c)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][u][e] = 0.f;
  // the A operand of this warp's first product: K (Sᵀ) or V (dPᵀ)
  const float* at = dk_warp ? vs : ks;
  float4* const px = xch + pair * 2 * 32;  // this pair's Pᵀ

  for (int it = first; it < nqt; ++it) {
    const int st = (it - first) & 1;
    if (it + 1 < nqt) fetch(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this stage (and K, V) have landed
    __syncthreads();
    const float* qst = ring + st * STAGE;
    const float* dost = qst + BQ * D;
    const float* ls = rows + st * 2 * BQ + qh * 16;  // this warp's queries
    const float* dls = ls + BQ;
    const int wq = it * BQ + qh * 16;  // this warp's first query

    // Sᵀ = K·Qᵀ (dV warp) or dPᵀ = V·dOᵀ (dK warp): n-tile n holds
    // queries wq + 8 n ..
    const float* bt = dk_warp ? dost : qst;
    float x[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
#pragma unroll
    for (int kp = 0; kp < D / 16; ++kp) {
      uint32_t ah[2][4], al[2][4];
      a_frags<D>(at, kg * 16 + g, kp, t4, ah, al);
#pragma unroll
      for (int n = 0; n < 2; ++n)
        mma_dims<D>(x[n], bt, qh * 16 + 8 * n + g, kp, t4, ah, al);
    }
    if constexpr (NC > 1) {
      // Sᵀ or dPᵀ over the whole D: this CTA's columns + the peer's
      float4* const mine = xs + (8 * st + warp) * 64 + lane;
      mine[0] = make_float4(x[0][0], x[0][1], x[0][2], x[0][3]);
      mine[32] = make_float4(x[1][0], x[1][1], x[1][2], x[1][3]);
      cluster_sync();
      const uint32_t peer = peer_addr(smem_u32(mine), rank ^ 1);
      add4(x[0], ld_cluster_f4(peer));
      add4(x[1], ld_cluster_f4(peer + 32 * 16));
    }

    if (!dk_warp) {
      // Pᵀ; only tiles that cross the diagonal or T are masked
      const bool edge = wq + 16 > Tlen || wkey + 16 > Tlen
                        || (causal && wq < wkey + 15);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * n + 2 * t4 + (e & 1);
          float p = exp2_approx(fmaf(x[n][e], sl2, -ls[qi] * kLog2e));
          if (edge) {
            const int row = wq + qi;
            const int key = wkey + g + 8 * (e >> 1);
            if (row >= Tlen || key >= Tlen || (causal && row < key))
              p = 0.f;
          }
          x[n][e] = p;
        }
        px[n * 32 + lane] = make_float4(x[n][0], x[n][1], x[n][2], x[n][3]);
      }
      bar_arrive(1 + pair, 64);
    } else {
      bar_sync(1 + pair, 64);  // the dV warp has posted Pᵀ
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float4 p = px[n * 32 + lane];
        const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * n + 2 * t4 + (e & 1);
          x[n][e] = pv[e] * (x[n][e] - dls[qi]) * scale;  // dSᵀ
        }
      }
    }
    // dV += Pᵀ·dO or dK += dSᵀ·Q over this warp's queries: k-step n takes
    // rows qh·16 + 8 n .. of the stage
    const float* ct = dk_warp ? qst : dost;
#pragma unroll
    for (int n = 0; n < 2; ++n)
      mma_rows<D>(acc, x[n], ct, qh * 16 + 8 * n, g, t4);
    __syncthreads();  // this stage and the pairs' Pᵀ are free again
  }
  // no CTA leaves while its peer may still read its exchange
  if constexpr (NC > 1) cluster_sync();

  // the two query halves' partials of each output through the ring (the
  // size of all eight), summed in order 0 + 1; warp (kg, qh) of each role
  // stores column groups qh, qh + 2, ...
  cp_async_wait<0>();
  float4* const xo = reinterpret_cast<float4*>(ring);
  post_acc(xo, warp, lane, acc);
  __syncthreads();
  float* out = dk_warp ? dk + b * sdk.b + h * sdk.h + col0
                       : dv + b * sdv.b + h * sdv.h + col0;
  const long long ot = dk_warp ? sdk.t : sdv.t;
  const int w0 = warp & ~2;  // this output's query half 0
#pragma unroll
  for (int c = qh; c < NG; c += 2)
    store_sum<2, NG>(out, ot, xo, w0, 2, c, lane, wkey, Tlen, dr);
}

// ------ f32 dQ and dK/dV at D <= 128, split-TF32 tensor-core products

// Replace `_bwd_dq_kernel` and `_bwd_dkv_kernel` of
// deeplearning4j_tpu/kernels/flash_attention.py (:146, :186) in f32 at
// head dims 1..128, padded to DP = 64 (D 1..64) or 128 (D 65..128): the
// loader zero-fills the columns past D, which are never stored. Every
// product runs on the tensor cores in split TF32 (flash_tf32.cuh: three
// mma.sync m16n8k8 a product, P and dS split too), in the fragment
// layouts, k-index permutations and swizzle of the D-256 kernels above
// (a_frags and mma_dims of flash_tf32.cuh, mma_rows): swz permutes only
// a chunk index's low three bits, so rows of 16 (DP 64) and 32 (DP 128)
// float4 chunks, like rows of 64, meet all 8 bank groups in each
// quarter-warp in both read patterns (over the head dim, and over a
// tile's rows).
//
// What bounds them on the card: the tensor cores' operations, three TF32
// products per f32 multiply-add (495 TFLOP/s dense), and beside them the
// instructions that split each operand (three a float) and the
// shared-memory reads that feed the products. The D-256 plan (two row
// groups x four key parts, each warp re-reading and re-splitting the
// block's resident rows, partial sums traded between warps at the end)
// was shaped by a 256-wide partial's registers. At D <= 128 a warp's 16
// rows of an output are DP / 2 f32 registers a thread, so here each warp
// owns 16 whole rows of its outputs for the whole loop: no exchange, no
// partial sums, one fixed order of summation, and each resident row
// (Q and dO for dQ, K and V for dK/dV) is read and split by the one warp
// that owns it, once a sub-step, each A fragment then feeding the
// sub-step's NB n-tiles. The streamed tiles are split as they are read,
// by each warp that reads them. Both ways of splitting each operand only
// once measured no faster on the H100 (PERF.md): the resident rows kept
// split in registers for the whole loop (2 x 64 registers a thread at DP
// 64, 256 at DP 128), and each landed stage split once into hi and lo
// planes in shared memory (twice the streamed tiles' shared-memory reads,
// a pass and a barrier a stage). Each output's long sum over T is added once
// a sub-step in f32 (mma_rows_rn, flash_tf32.cuh). Four warps a block (64
// rows), two blocks an SM at DP 64; the streamed tiles go through a
// double-buffered cp.async ring (16-byte copies where every row is 16-byte
// aligned, else 4-byte ones). A warp skips the sub-steps causal masking
// hides from all of its rows, and the grid's slow dimension walks the
// heaviest tiles first. No atomics, one owner a row: a second launch is
// bit-identical. On the H100 they run at 3.1-3.2x their TF32 bound
// (PERF.md).

// dQ: a block owns one (b*h, 64-query tile) and warp w its rows 16 w ..
// 16 w + 15. K and V stream in stages of BK keys, each taken in sub-steps
// of NB n-tiles of 8 keys: S = Q·Kᵀ and dP = dO·Vᵀ (16 x 8 NB), then
// P = exp2(S·scale·log2 e - lse·log2 e) masked and dS = P∘(dP -
// delta)·scale on S's fragments, then dQ += dS·K. Each thread keeps the
// lse (times log2 e) and delta of its rows g and g + 8 in registers. DP
// is the padded D.
template <int DP_, int BK_, int NB_>
struct Tf32NarrowDqCfg {
  static constexpr int NC = 1;          // one CTA, no cluster
  static constexpr int DP = DP_;
  static constexpr int BQ = 64;         // query rows: 4 warps of 16
  static constexpr int BK = BK_;        // keys a stage
  static constexpr int NB = NB_;        // 8-key n-tiles a sub-step
  static constexpr int THREADS = 128;
  // Q, dO, then two stages of (K, V)
  static constexpr int SMEM = (2 * BQ * DP + 2 * 2 * BK * DP) * 4;
  static_assert(BK % (8 * NB) == 0, "whole sub-steps a stage");
};

template <typename C>
__global__ void __launch_bounds__(C::THREADS, 2)
flash_bwd_dq_tf32x3_narrow_kernel(const float* __restrict__ q,
                                  const float* __restrict__ k,
                                  const float* __restrict__ v,
                                  const float* __restrict__ dout,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ delta,
                                  float* __restrict__ dq, int H, int Tlen,
                                  int dr, Str sq, Str sk, Str sv, Str sdo,
                                  Str sdq, float scale, int causal,
                                  int vec) {
  using namespace dl4j_mma;
  using dl4j_tf32::load_f32_tile;
  constexpr int DP = C::DP;
  constexpr int BQ = C::BQ;
  constexpr int BK = C::BK;
  constexpr int NB = C::NB;
  constexpr int KP = DP / 16;           // k-step pairs over the head dim
  constexpr int NG = DP / 32;           // column groups of dQ
  constexpr int NT = C::THREADS;
  constexpr int SUB = 8 * NB;           // keys a sub-step
  constexpr int STAGE = 2 * BK * DP;    // floats: K, then V
  extern __shared__ __align__(16) float fsm[];
  float* const qs = fsm;
  float* const dos = qs + BQ * DP;
  float* const kvs = dos + BQ * DP;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wr = (tid >> 5) * 16;       // this warp's rows of the tile
  const int wrow = q0 + wr;             // and its first query
  const float sl2 = scale * kLog2e;

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int kend = causal ? min(Tlen, q0 + BQ) : Tlen;
  const int nkt = (kend + BK - 1) / BK;

  load_f32_tile<BQ, DP, NT, true, DP>(qs, q + b * sq.b + h * sq.h, sq.t, q0,
                                      Tlen, dr, vec, tid);
  load_f32_tile<BQ, DP, NT, true, DP>(dos, dout + b * sdo.b + h * sdo.h,
                                      sdo.t, q0, Tlen, dr, vec, tid);
  cp_async_commit();
  load_f32_tile<BK, DP, NT, true, DP>(kvs, kb, sk.t, 0, Tlen, dr, vec, tid);
  load_f32_tile<BK, DP, NT, true, DP>(kvs + BK * DP, vb, sv.t, 0, Tlen, dr,
                                      vec, tid);
  cp_async_commit();

  // the lse (times log2 e) and delta of this thread's rows g and g + 8
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + g + 8 * r;
    const bool ok = row < Tlen;
    l2[r] = ok ? lse[(long long)bh * Tlen + row] * kLog2e : 0.f;
    dl[r] = ok ? delta[(long long)bh * Tlen + row] : 0.f;
  }
  float acc[NG][4][4];
#pragma unroll
  for (int c = 0; c < NG; ++c)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][u][e] = 0.f;

  for (int j = 0; j < nkt; ++j) {
    if (j + 1 < nkt) {
      float* nk = kvs + ((j + 1) & 1) * STAGE;
      load_f32_tile<BK, DP, NT, true, DP>(nk, kb, sk.t, (j + 1) * BK, Tlen,
                                          dr, vec, tid);
      load_f32_tile<BK, DP, NT, true, DP>(nk + BK * DP, vb, sv.t,
                                          (j + 1) * BK, Tlen, dr, vec, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // stage j (and Q, dO) have landed
    __syncthreads();
    const float* ks = kvs + (j & 1) * STAGE;
    const float* vs = ks + BK * DP;
#pragma unroll 1
    for (int r0 = 0; r0 < BK; r0 += SUB) {
      const int k0 = j * BK + r0;  // the sub-step's first key
      // past T, or (causal) past every row of this warp: nothing left
      if (k0 >= Tlen || (causal && k0 > wrow + 15)) break;

      // S = Q·Kᵀ and dP = dO·Vᵀ over the sub-step's keys: n-tile n holds
      // keys k0 + 8 n ..
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kp = 0; kp < KP; ++kp) {
        uint32_t ah[2][4], al[2][4];
        a_frags<DP>(qs, wr + g, kp, t4, ah, al);
#pragma unroll
        for (int n = 0; n < NB; ++n)
          mma_dims<DP>(s[n], ks, r0 + 8 * n + g, kp, t4, ah, al);
        a_frags<DP>(dos, wr + g, kp, t4, ah, al);
#pragma unroll
        for (int n = 0; n < NB; ++n)
          mma_dims<DP>(dp[n], vs, r0 + 8 * n + g, kp, t4, ah, al);
      }

      // P and dS = P∘(dP - delta)·scale in s; only sub-steps that cross
      // the diagonal or T are masked
      const bool edge = k0 + SUB > Tlen || (causal && k0 + SUB - 1 > wrow);
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float p = exp2_approx(fmaf(s[n][e], sl2, -l2[r]));
          if (edge) {
            const int key = k0 + 8 * n + 2 * t4 + (e & 1);
            if (key >= Tlen || (causal && key > wrow + g + 8 * r)) p = 0.f;
          }
          s[n][e] = p * (dp[n][e] - dl[r]) * scale;
        }
      // dQ += dS·K over the sub-step's keys (rows r0 .. of the stage)
      mma_rows_rn<DP>(acc, s, ks, r0, g, t4);
    }
    __syncthreads();  // stage j & 1 is consumed before it is refilled
  }
  store_rows(dq + b * sdq.b + h * sdq.h, sdq.t, acc, wrow, g, t4, Tlen, dr);
}

// dK/dV: a block owns one (b*h, 64-key tile) and warp w its keys 16 w ..
// 16 w + 15, of both dK and dV. Q, dO and the lse and delta rows stream
// in stages of BQ queries (from the diagonal down when causal), each taken
// in sub-steps of NB n-tiles of 8 queries: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ
// (16 x 8 NB), then Pᵀ = exp2(Sᵀ·scale·log2 e - lse·log2 e) masked and
// dSᵀ = Pᵀ∘(dPᵀ - delta)·scale, then dV += Pᵀ·dO and dK += dSᵀ·Q. DP the
// padded D.
template <int DP_, int BQ_, int NB_>
struct Tf32NarrowDkvCfg {
  static constexpr int NC = 1;          // one CTA, no cluster
  static constexpr int DP = DP_;
  static constexpr int BKV = 64;        // keys: 4 warps of 16
  static constexpr int BQ = BQ_;        // query rows a stage
  static constexpr int NB = NB_;        // 8-query n-tiles a sub-step
  static constexpr int THREADS = 128;
  // K, V, two stages of (Q, dO), then two stages of (lse, delta) rows
  static constexpr int SMEM = (2 * BKV * DP + 4 * BQ * DP + 4 * BQ) * 4;
  static_assert(BQ % (8 * NB) == 0, "whole sub-steps a stage");
};

template <typename C>
__global__ void __launch_bounds__(C::THREADS, 2)
flash_bwd_dkv_tf32x3_narrow_kernel(const float* __restrict__ q,
                                   const float* __restrict__ k,
                                   const float* __restrict__ v,
                                   const float* __restrict__ dout,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ delta,
                                   float* __restrict__ dk,
                                   float* __restrict__ dv, int H, int Tlen,
                                   int dr, Str sq, Str sk, Str sv, Str sdo,
                                   Str sdk, Str sdv, float scale, int causal,
                                   int vec) {
  using namespace dl4j_mma;
  using dl4j_tf32::load_f32_tile;
  constexpr int DP = C::DP;
  constexpr int BKV = C::BKV;
  constexpr int BQ = C::BQ;
  constexpr int NB = C::NB;
  constexpr int KP = DP / 16;           // k-step pairs over the head dim
  constexpr int NG = DP / 32;           // column groups of dK and dV
  constexpr int NT = C::THREADS;
  constexpr int SUB = 8 * NB;           // queries a sub-step
  constexpr int STAGE = 2 * BQ * DP;    // floats: Q, then dO
  extern __shared__ __align__(16) float fsm[];
  float* const ks = fsm;
  float* const vs = ks + BKV * DP;
  float* const ring = vs + BKV * DP;
  float* const rows = ring + 2 * STAGE;  // stage st: lse, then delta

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * BKV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wr = (tid >> 5) * 16;       // this warp's keys of the tile
  const int wkey = k0 + wr;             // and its first key
  const float sl2 = scale * kLog2e;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const float* lseb = lse + (long long)bh * Tlen;
  const float* deltab = delta + (long long)bh * Tlen;
  // causal: query tiles above the block's first key see none of its keys
  const int first = causal ? k0 / BQ : 0;
  const int nqt = (Tlen + BQ - 1) / BQ;

  // query tile `it` into ring stage `st`: Q, dO, the lse and delta rows
  auto fetch = [&](int it, int st) {
    float* tq = ring + st * STAGE;
    const int i0 = it * BQ;
    load_f32_tile<BQ, DP, NT, true, DP>(tq, qb, sq.t, i0, Tlen, dr, vec,
                                        tid);
    load_f32_tile<BQ, DP, NT, true, DP>(tq + BQ * DP, dob, sdo.t, i0, Tlen,
                                        dr, vec, tid);
    for (int e = tid; e < 2 * BQ; e += NT) {
      const int row = i0 + (e < BQ ? e : e - BQ);
      const bool ok = row < Tlen;
      const float* src = e < BQ ? lseb : deltab;
      cp_async4(smem_u32(rows + st * 2 * BQ + e), src + (ok ? row : 0), ok);
    }
  };
  load_f32_tile<BKV, DP, NT, true, DP>(ks, k + b * sk.b + h * sk.h, sk.t,
                                       k0, Tlen, dr, vec, tid);
  load_f32_tile<BKV, DP, NT, true, DP>(vs, v + b * sv.b + h * sv.h, sv.t,
                                       k0, Tlen, dr, vec, tid);
  cp_async_commit();
  fetch(first, 0);
  cp_async_commit();

  float dka[NG][4][4], dva[NG][4][4];
#pragma unroll
  for (int c = 0; c < NG; ++c)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[c][u][e] = dva[c][u][e] = 0.f;

  for (int it = first; it < nqt; ++it) {
    const int st = (it - first) & 1;
    if (it + 1 < nqt) fetch(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this stage (and K, V) have landed
    __syncthreads();
    const float* qst = ring + st * STAGE;
    const float* dost = qst + BQ * DP;
    const float* ls = rows + st * 2 * BQ;
    const float* dls = ls + BQ;
#pragma unroll 1
    for (int r0 = 0; r0 < BQ; r0 += SUB) {
      const int i0 = it * BQ + r0;  // the sub-step's first query
      if (i0 >= Tlen) break;
      // causal: every query of the sub-step is above this warp's keys
      if (causal && i0 + SUB - 1 < wkey) continue;

      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: n-tile n holds queries i0 + 8 n ..
      float x[NB][4], y[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[n][e] = y[n][e] = 0.f;
#pragma unroll
      for (int kp = 0; kp < KP; ++kp) {
        uint32_t ah[2][4], al[2][4];
        a_frags<DP>(ks, wr + g, kp, t4, ah, al);
#pragma unroll
        for (int n = 0; n < NB; ++n)
          mma_dims<DP>(x[n], qst, r0 + 8 * n + g, kp, t4, ah, al);
        a_frags<DP>(vs, wr + g, kp, t4, ah, al);
#pragma unroll
        for (int n = 0; n < NB; ++n)
          mma_dims<DP>(y[n], dost, r0 + 8 * n + g, kp, t4, ah, al);
      }

      // Pᵀ in x, dSᵀ in y; only sub-steps that cross the diagonal or T
      // are masked
      const bool edge = i0 + SUB > Tlen || wkey + 16 > Tlen
                        || (causal && i0 < wkey + 15);
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = r0 + 8 * n + 2 * t4 + (e & 1);
          float p = exp2_approx(fmaf(x[n][e], sl2, -ls[qi] * kLog2e));
          if (edge) {
            const int row = it * BQ + qi;
            const int key = wkey + g + 8 * (e >> 1);
            if (row >= Tlen || key >= Tlen || (causal && row < key))
              p = 0.f;
          }
          x[n][e] = p;
          y[n][e] = p * (y[n][e] - dls[qi]) * scale;
        }
      // dV += Pᵀ·dO and dK += dSᵀ·Q over the sub-step's queries (rows
      // r0 .. of the stage)
      mma_rows_rn<DP>(dva, x, dost, r0, g, t4);
      mma_rows_rn<DP>(dka, y, qst, r0, g, t4);
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
  store_rows(dk + b * sdk.b + h * sdk.h, sdk.t, dka, wkey, g, t4, Tlen, dr);
  store_rows(dv + b * sdv.b + h * sdv.h, sdv.t, dva, wkey, g, t4, Tlen, dr);
}

// the narrow plans: (DP, keys or queries a stage, n-tiles a sub-step),
// the fastest that -Xptxas -v shows in 255 registers with no spill
// (scripts/flash_tf32_narrow_sweep.py; PERF.md): dQ 170 and 219
// registers, dK/dV 218 and 255; shared memory 96 and 128 KiB (dQ), 97 and
// 96.25 KiB (dK/dV)
using NarrowDq64 = Tf32NarrowDqCfg<64, 64, 4>;
using NarrowDq128 = Tf32NarrowDqCfg<128, 32, 4>;
using NarrowDkv64 = Tf32NarrowDkvCfg<64, 64, 4>;
using NarrowDkv128 = Tf32NarrowDkvCfg<128, 16, 2>;

// kern: flash_bwd_dq_tf32x3_kernel<C> (C::NC CTAs a cluster) or
// flash_bwd_dq_tf32x3_narrow_kernel<C> (one CTA)
template <typename C, typename K>
int launch_dq_tf32x3(K kern, int BH, int Tlen, int dr, cudaStream_t st,
                     const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int H, const long long* s, float scale,
                     int causal) {
  static_assert(C::SMEM <= 232448, "227 KiB a block on sm_90");
  const Str sq = str_at(s, 0), sk = str_at(s, 1), sv = str_at(s, 2),
            sdo = str_at(s, 3);
  const bool vec = dl4j_tf32::rows_16b(dr, {q, k, v, dout},
                                       {sq, sk, sv, sdo});
  constexpr int NC = C::NC;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  // query tiles on the slow dimension: the heaviest (last) go first
  const dim3 grid(NC * BH, (Tlen + C::BQ - 1) / C::BQ);
  return launch_clusters<NC>(
      kern, grid, C::THREADS, C::SMEM, st, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), H, Tlen, dr,
      sq, sk, sv, sdo, str_at(s, 4), scale, causal, int(vec));
}

template <typename C, typename K>
int launch_dkv_tf32x3(K kern, int BH, int Tlen, int dr, cudaStream_t st,
                      const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int H, const long long* s,
                      float scale, int causal) {
  static_assert(C::SMEM <= 232448, "227 KiB a block on sm_90");
  const Str sq = str_at(s, 0), sk = str_at(s, 1), sv = str_at(s, 2),
            sdo = str_at(s, 3);
  const bool vec = dl4j_tf32::rows_16b(dr, {q, k, v, dout},
                                       {sq, sk, sv, sdo});
  constexpr int NC = C::NC;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  // key tiles on the slow dimension: the heaviest (first) go first
  const dim3 grid(NC * BH, (Tlen + C::BKV - 1) / C::BKV);
  return launch_clusters<NC>(
      kern, grid, C::THREADS, C::SMEM, st, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), H, Tlen, dr, sq, sk, sv, sdo, str_at(s, 4),
      str_at(s, 5), scale, causal, int(vec));
}

// f32 D 1..512: padded to 64 or 128 on the narrow kernels, to 256 on one
// CTA, else to 320, 384 or 512 on a cluster of two that split the columns
int launch_dq_tf32x3_any(int BH, int Tlen, int dr, cudaStream_t st,
                         const void* q, const void* k, const void* v,
                         const void* dout, const void* lse,
                         const void* delta, void* dq, int H,
                         const long long* s, float scale, int causal) {
  using Dq256 = Tf32DqCfg<256, 1>;
  using Dq320 = Tf32DqCfg<320, 2>;
  using Dq384 = Tf32DqCfg<384, 2>;
  using Dq512 = Tf32DqCfg<512, 2>;
#define DL4J_TF32_DQ(KERNEL, C)                                              \
  return launch_dq_tf32x3<C>(KERNEL<C>, BH, Tlen, dr, st, q, k, v, dout,     \
                             lse, delta, dq, H, s, scale, causal)
  if (dr <= 64) DL4J_TF32_DQ(flash_bwd_dq_tf32x3_narrow_kernel, NarrowDq64);
  if (dr <= 128) DL4J_TF32_DQ(flash_bwd_dq_tf32x3_narrow_kernel, NarrowDq128);
  if (dr <= 256) DL4J_TF32_DQ(flash_bwd_dq_tf32x3_kernel, Dq256);
  if (dr <= 320) DL4J_TF32_DQ(flash_bwd_dq_tf32x3_kernel, Dq320);
  if (dr <= 384) DL4J_TF32_DQ(flash_bwd_dq_tf32x3_kernel, Dq384);
  if (dr <= 512) DL4J_TF32_DQ(flash_bwd_dq_tf32x3_kernel, Dq512);
#undef DL4J_TF32_DQ
  return (int)cudaErrorInvalidValue;
}

int launch_dkv_tf32x3_any(int BH, int Tlen, int dr, cudaStream_t st,
                          const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv, int H,
                          const long long* s, float scale, int causal) {
  using Dkv256 = Tf32DkvCfg<256, 1>;
  using Dkv320 = Tf32DkvCfg<320, 2>;
  using Dkv384 = Tf32DkvCfg<384, 2>;
  using Dkv512 = Tf32DkvCfg<512, 2>;
#define DL4J_TF32_DKV(KERNEL, C)                                             \
  return launch_dkv_tf32x3<C>(KERNEL<C>, BH, Tlen, dr, st, q, k, v, dout,    \
                              lse, delta, dk, dv, H, s, scale, causal)
  if (dr <= 64) DL4J_TF32_DKV(flash_bwd_dkv_tf32x3_narrow_kernel, NarrowDkv64);
  if (dr <= 128)
    DL4J_TF32_DKV(flash_bwd_dkv_tf32x3_narrow_kernel, NarrowDkv128);
  if (dr <= 256) DL4J_TF32_DKV(flash_bwd_dkv_tf32x3_kernel, Dkv256);
  if (dr <= 320) DL4J_TF32_DKV(flash_bwd_dkv_tf32x3_kernel, Dkv320);
  if (dr <= 384) DL4J_TF32_DKV(flash_bwd_dkv_tf32x3_kernel, Dkv384);
  if (dr <= 512) DL4J_TF32_DKV(flash_bwd_dkv_tf32x3_kernel, Dkv512);
#undef DL4J_TF32_DKV
  return (int)cudaErrorInvalidValue;
}

// ------------------------------ any D, CUDA cores (flash_general.cuh)

// dQ: one block per (b*h, R-query tile), the heaviest first under causal
// masking; per key tile of R rows up to the diagonal: S = Q·Kᵀ and
// dP = dO·Vᵀ, then P = exp(S·scale - lse) and dS = P·(dP - delta)·scale
// rounded to T, then dQ += dS·K; Q, dO and dQ stay in shared memory.
template <typename T, int R>
__global__ void __launch_bounds__(dl4j_gen::kGenThreads)
flash_bwd_dq_general_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            T* __restrict__ dq, int H, int Tlen, int D,
                            Str sq, Str sk, Str sv, Str sdo, Str sdq,
                            float scale, int causal) {
  using namespace dl4j_gen;
  extern __shared__ float gsm[];
  constexpr int SLD = R + 1;
  const int ld = gen_ld(R, D);
  float* qs = gsm;
  float* dos = qs + R * ld;
  float* dqs = dos + R * ld;
  float* ks = dqs + R * ld;
  float* vs = ks + R * ld;
  float* ss = vs + R * ld;  // S, then dS
  float* dps = ss + R * SLD;
  float* lses = dps + R * SLD;
  float* dls = lses + R;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * R;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  load_tile<T>(qs, ld, q + b * sq.b + h * sq.h, sq.t, q0, R, Tlen, D);
  load_tile<T>(dos, ld, dout + b * sdo.b + h * sdo.h, sdo.t, q0, R, Tlen, D);
  zero_tile(dqs, R * ld);
  load_rows(lses, lse + (long long)bh * Tlen, q0, R, Tlen);
  load_rows(dls, delta + (long long)bh * Tlen, q0, R, Tlen);
  const int kend = causal ? min(Tlen, q0 + R) : Tlen;
  for (int k0 = 0; k0 < kend; k0 += R) {
    __syncthreads();  // the previous tiles are consumed
    load_tile<T>(ks, ld, kb, sk.t, k0, R, Tlen, D);
    load_tile<T>(vs, ld, vb, sv.t, k0, R, Tlen, D);
    __syncthreads();
    tile_nt<R>(qs, ks, ld, D, ss, SLD);
    tile_nt<R>(dos, vs, ld, D, dps, SLD);
    __syncthreads();
    for (int e = threadIdx.x; e < R * R; e += kGenThreads) {
      const int m = e / R;
      const int j = e - m * R;
      const int qi = q0 + m;
      const int key = k0 + j;
      const bool live =
          qi < Tlen && key < Tlen && (!causal || key <= qi);
      const float p =
          live ? __expf(ss[m * SLD + j] * scale - lses[m]) : 0.f;
      ss[m * SLD + j] = round_to<T>(p * (dps[m * SLD + j] - dls[m]) * scale);
    }
    __syncthreads();
    tile_nn_acc<R>(ss, SLD, ks, ld, dqs, ld, D, min(R, kend - k0), nullptr);
  }
  __syncthreads();
  store_tile<T>(dq + b * sdq.b + h * sdq.h, sdq.t, dqs, ld, q0, R, Tlen, D,
                nullptr);
}

// dK, dV: one block per (b*h, R-key tile); per query tile of R rows from
// the diagonal down: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, then Pᵀ = exp(Sᵀ·scale -
// lse) and dSᵀ = Pᵀ·(dPᵀ - delta)·scale, both rounded to T, then
// dV += Pᵀ·dO and dK += dSᵀ·Q; K, V, dK and dV stay in shared memory.
template <typename T, int R>
__global__ void __launch_bounds__(dl4j_gen::kGenThreads)
flash_bwd_dkv_general_kernel(const T* __restrict__ q,
                             const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             T* __restrict__ dk, T* __restrict__ dv, int H,
                             int Tlen, int D, Str sq, Str sk, Str sv,
                             Str sdo, Str sdk, Str sdv, float scale,
                             int causal) {
  using namespace dl4j_gen;
  extern __shared__ float gsm[];
  constexpr int SLD = R + 1;
  const int ld = gen_ld(R, D);
  float* ks = gsm;
  float* vs = ks + R * ld;
  float* dks = vs + R * ld;
  float* dvs = dks + R * ld;
  float* qs = dvs + R * ld;
  float* dos = qs + R * ld;
  float* pts = dos + R * ld;  // Sᵀ, then Pᵀ
  float* dsts = pts + R * SLD;  // dPᵀ, then dSᵀ
  float* lses = dsts + R * SLD;
  float* dls = lses + R;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * R;  // the heaviest (first) key tiles first
  const T* qb = q + b * sq.b + h * sq.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;

  load_tile<T>(ks, ld, k + b * sk.b + h * sk.h, sk.t, k0, R, Tlen, D);
  load_tile<T>(vs, ld, v + b * sv.b + h * sv.h, sv.t, k0, R, Tlen, D);
  zero_tile(dks, R * ld);
  zero_tile(dvs, R * ld);
  // causal: query rows above the tile's first key see none of its keys
  for (int i0 = causal ? k0 : 0; i0 < Tlen; i0 += R) {
    __syncthreads();  // the previous tiles are consumed
    load_tile<T>(qs, ld, qb, sq.t, i0, R, Tlen, D);
    load_tile<T>(dos, ld, dob, sdo.t, i0, R, Tlen, D);
    load_rows(lses, lse + (long long)bh * Tlen, i0, R, Tlen);
    load_rows(dls, delta + (long long)bh * Tlen, i0, R, Tlen);
    __syncthreads();
    tile_nt<R>(ks, qs, ld, D, pts, SLD);
    tile_nt<R>(vs, dos, ld, D, dsts, SLD);
    __syncthreads();
    for (int e = threadIdx.x; e < R * R; e += kGenThreads) {
      const int n = e / R;  // key
      const int m = e - n * R;  // query
      const int key = k0 + n;
      const int qi = i0 + m;
      const bool live =
          key < Tlen && qi < Tlen && (!causal || qi >= key);
      const float p =
          live ? __expf(pts[n * SLD + m] * scale - lses[m]) : 0.f;
      dsts[n * SLD + m] =
          round_to<T>(p * (dsts[n * SLD + m] - dls[m]) * scale);
      pts[n * SLD + m] = round_to<T>(p);
    }
    __syncthreads();
    const int in = min(R, Tlen - i0);
    tile_nn_acc<R>(pts, SLD, dos, ld, dvs, ld, D, in, nullptr);
    tile_nn_acc<R>(dsts, SLD, qs, ld, dks, ld, D, in, nullptr);
  }
  __syncthreads();
  store_tile<T>(dk + b * sdk.b + h * sdk.h, sdk.t, dks, ld, k0, R, Tlen, D,
                nullptr);
  store_tile<T>(dv + b * sdv.b + h * sdv.h, sdv.t, dvs, ld, k0, R, Tlen, D,
                nullptr);
}

template <typename T>
int launch_dq_general(int BH, int Tlen, int D, cudaStream_t st,
                      const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int H, const long long* s, float scale,
                      int causal) {
  using namespace dl4j_gen;
  const int R = gen_rows(kGenDq, D);
  const size_t smem = gen_smem_bytes(kGenDq, R, D);
#define DL4J_GEN_DQ(RR)                                                      \
  case RR:                                                                   \
    return launch_gen(                                                       \
        flash_bwd_dq_general_kernel<T, RR>, (Tlen + RR - 1) / RR, BH, smem,  \
        st, static_cast<const T*>(q), static_cast<const T*>(k),              \
        static_cast<const T*>(v), static_cast<const T*>(dout),               \
        static_cast<const float*>(lse), static_cast<const float*>(delta),    \
        static_cast<T*>(dq), H, Tlen, D, str_at(s, 0), str_at(s, 1),         \
        str_at(s, 2), str_at(s, 3), str_at(s, 4), scale, causal);
  switch (R) {
    DL4J_GEN_DQ(64)
    DL4J_GEN_DQ(32)
    DL4J_GEN_DQ(16)
    DL4J_GEN_DQ(8)
    default:
      return (int)cudaErrorInvalidValue;  // no tile fits: D too large
  }
#undef DL4J_GEN_DQ
}

template <typename T>
int launch_dkv_general(int BH, int Tlen, int D, cudaStream_t st,
                       const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int H, const long long* s,
                       float scale, int causal) {
  using namespace dl4j_gen;
  const int R = gen_rows(kGenDkv, D);
  const size_t smem = gen_smem_bytes(kGenDkv, R, D);
#define DL4J_GEN_DKV(RR)                                                     \
  case RR:                                                                   \
    return launch_gen(                                                       \
        flash_bwd_dkv_general_kernel<T, RR>, (Tlen + RR - 1) / RR, BH, smem, \
        st, static_cast<const T*>(q), static_cast<const T*>(k),              \
        static_cast<const T*>(v), static_cast<const T*>(dout),               \
        static_cast<const float*>(lse), static_cast<const float*>(delta),    \
        static_cast<T*>(dk), static_cast<T*>(dv), H, Tlen, D, str_at(s, 0),  \
        str_at(s, 1), str_at(s, 2), str_at(s, 3), str_at(s, 4),              \
        str_at(s, 5), scale, causal);
  switch (R) {
    DL4J_GEN_DKV(64)
    DL4J_GEN_DKV(32)
    DL4J_GEN_DKV(16)
    DL4J_GEN_DKV(8)
    default:
      return (int)cudaErrorInvalidValue;  // no tile fits: D too large
  }
#undef DL4J_GEN_DKV
}

// the kernel for (dtype, D) that the entries have not taken (they take
// f32 D 1..512 to their split-TF32 kernels and bf16 D 136..512 to their
// two-warpgroup and cluster kernels first): dtype 0 = float32, 1 =
// bfloat16. bf16 D <= 128, a multiple of 8 (16-byte rows), runs on the
// kernel instantiated on the padded width padded_dim(D); every other D on
// the general kernel
#define DL4J_BWD_DISPATCH(LAUNCH, LAUNCH_GENERAL, ...)                       \
  if (dtype == 0) return LAUNCH_GENERAL<float>(__VA_ARGS__);                 \
  if (D > 128 || D % 8 != 0)                                                 \
    return LAUNCH_GENERAL<__nv_bfloat16>(__VA_ARGS__);                       \
  switch (dl4j_mma::padded_dim(D)) {                                         \
    case 16: return LAUNCH<__nv_bfloat16, 16>(__VA_ARGS__);                  \
    case 32: return LAUNCH<__nv_bfloat16, 32>(__VA_ARGS__);                  \
    case 64: return LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__);                  \
    case 128: return LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__);                \
    default: return (int)cudaErrorInvalidValue;                              \
  }

}  // namespace

// q, k, v, dout, dq: (B, H, T, D) addressed by the element strides in
// `strides` (batch, head, time of each, in that order; the D stride is
// 1); lse, delta: contiguous (B, H, T) f32. Returns cudaGetLastError()
// after the launch.
extern "C" int dl4j_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int T,
    int D, const long long* strides, float scale, int causal, int dtype,
    void* stream) {
  if (B < 1 || H < 1 || T < 1 || D < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D <= 512)
    return launch_dq_tf32x3_any(B * H, T, D, st, q, k, v, dout, lse, delta,
                                dq, H, strides, scale, causal);
  if (dtype == 1 && D > 128 && D <= 512 && D % 8 == 0) {
#define DL4J_BF16_DQ(DP)                                                     \
  return launch_dq<__nv_bfloat16, DP>(B * H, T, D, st, q, k, v, dout, lse,   \
                                      delta, dq, H, strides, scale, causal)
    if (D <= 256) DL4J_BF16_DQ(256);
    if (dl4j_mma::wide_padded_dim(D) == 384) DL4J_BF16_DQ(384);
    DL4J_BF16_DQ(512);
#undef DL4J_BF16_DQ
  }
  DL4J_BWD_DISPATCH(launch_dq, launch_dq_general, B * H, T, D, st, q, k, v,
                    dout, lse, delta, dq, H, strides, scale, causal)
}

// As above, with the strides of q, k, v, dout, dk, dv.
extern "C" int dl4j_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int T, int D, const long long* strides, float scale, int causal,
    int dtype, void* stream) {
  if (B < 1 || H < 1 || T < 1 || D < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D <= 512)
    return launch_dkv_tf32x3_any(B * H, T, D, st, q, k, v, dout, lse, delta,
                                 dk, dv, H, strides, scale, causal);
  if (dtype == 1 && D > 128 && D <= 512 && D % 8 == 0) {
#define DL4J_BF16_DKV(DP)                                                    \
  return launch_dkv<__nv_bfloat16, DP>(B * H, T, D, st, q, k, v, dout, lse,  \
                                       delta, dk, dv, H, strides, scale,     \
                                       causal)
    if (D <= 256) DL4J_BF16_DKV(256);
    if (dl4j_mma::wide_padded_dim(D) == 384) DL4J_BF16_DKV(384);
    DL4J_BF16_DKV(512);
#undef DL4J_BF16_DKV
  }
  DL4J_BWD_DISPATCH(launch_dkv, launch_dkv_general, B * H, T, D, st, q, k,
                    v, dout, lse, delta, dk, dv, H, strides, scale, causal)
}
