// Causal flash-attention forward (K1) for Hopper (sm_90a), plain C
// interface: a bf16 kernel on the tensor cores (warpgroup MMA; two
// warpgroups past D 256) and f32 kernels of split-TF32 tensor-core
// products (one warp a 16-row group up to D 128, a key split at D
// 129..256, a column split at 257..512), chosen by dtype and head dim.
//
// Replaces the TPU kernel `_fwd_kernel` of
// deeplearning4j_tpu/kernels/flash_attention.py (launched by `_fwd`):
// FlashAttention-2 forward with an online softmax, writing O in the input
// dtype and the per-row log-sum-exp in f32, so the (T, T) score matrix
// never reaches device memory.
//
// What bounds it on the card: operations. A causal head does
// 4 * D * T (T + 1) / 2 flops over ~4 * T * D * 2 bytes, hundreds of
// operations per byte: at B1 H8 T2048 D64 bf16 the floor is 0.00434 ms
// (989 TFLOP/s); at the train path's B32 H8 T1024 D64 it is 0.0404 ms,
// set by the bytes (3.35 TB/s).
//
// bf16 (flash_fwd_wgmma_kernel). The TPU kernel fed its MXU bf16 operands
// with f32 sums; here both products are wgmma.mma_async (m64nNk16, bf16 ->
// f32), the only path to Hopper's full tensor-core rate. A block owns one
// (b*h, 64-row query tile), one warpgroup (4 warps, 16 rows each), and a
// loop inside it walks the key tiles, 64 or 128 rows a step (the Pallas
// grid's sequential key dimension), stopping at the diagonal when causal,
// so the tiles the TPU kernel skipped with pl.when are never visited and
// only tiles that cross the diagonal or T are masked. Q, K and V come into
// shared memory by 16-byte cp.async in the layouts wgmma reads through
// its descriptors (rows swizzled in 32/64/128-byte atoms at D 16/32/64; at
// D 128 and 256 two and four 64-column panels); K/V are double-buffered,
// so the next tile's copy overlaps this tile's products, and a proxy fence
// hands the copied tiles to wgmma. S = Q·Kᵀ reads both operands from
// shared memory and lands in registers; the online softmax runs there
// (row max and sum by quad shuffles, exp2 with the scale folded into
// log2 e); S's
// accumulator fragments, packed to bf16x2, are the register A operand of
// O += P·V (V read transposed from shared memory), so P never touches
// shared memory and is rounded to bf16 exactly where the TPU kernel cast
// it (`p.astype(v.dtype)`); the row sums use the f32 P, as there. Under
// causal masking the grid's slow dimension walks the query tiles
// heaviest first, to shorten the tail. Rows >= T read as zeros and are
// never written; keys >= T are masked. (An mma.sync m16n8k16 kernel with
// ldmatrix fragments measured 1.3x slower at the train shape; PERF.md.)
//
// bf16 past D 256 (the same kernel at padded 384 and 512): O is 64 x 384
// or 64 x 512 f32, 192 or 256 accumulators a thread on one warpgroup,
// past the 255 registers a thread may hold. So the block runs two
// warpgroups on the same 64 rows, each holding one half of O's columns
// (at most 128 accumulators a thread, as at 256), its P·V an m64n192k16
// or m64n256k16 product over its half's 64-column panels of V. Each
// warpgroup computes S = Q·Kᵀ over the whole D itself (design (b)) rather
// than one computing it and posting bf16 P and the row rescale to the
// other through shared memory (design (a), FlashMLA's): the two run the
// same products on the same tiles, so their S, running max and row sums
// agree bit for bit with no exchange and no barrier between them, at 1.5x
// the products of one S; a step of 32 keys is short and the block far
// from the tensor cores' rate, so the extra products cost less than a
// round trip through shared memory and a barrier every step would. Q
// stays resident and K and V stream in 32-key steps through two stages:
// at 512, 64 + 2 x (32 + 32) KiB; at 384, 48 + 2 x (24 + 24) (64-key
// steps would take 240 KiB there). A half starts on a 64-column panel,
// so D 264..384 pads to 384 and 392..512 to 512.
//
// f32 up to D 128 (flash_fwd_tf32x3_narrow_kernel) and at D 129..256
// (flash_fwd_tf32x3_kernel): the tensor cores in three TF32 products per f32
// product (hi·hi + hi·lo + lo·hi of each operand's split into two TF32
// halves), whose error stays near f32's own and inside the f32 tolerance of
// 1e-4 that one TF32 product would break.
//
// All take the batch, head and time strides of q, k, v and o (the last
// dimension contiguous), so the (B, T, H, D) views of one qkv buffer the
// transformer holds need no copies; the bf16 kernel needs 16-byte aligned
// bases and strides (the Python wrapper checks them and raises).
//
// Head dims: like the Pallas block (1, bq, d), any D whose tiles fit in a
// block's shared memory. The bf16 kernel takes D up to 512 (a multiple of 8,
// 16-byte rows), instantiated on the padded width DP in {16, 32, 64, 128,
// 256, 384, 512} (padded_dim, wide_padded_dim); the narrow f32 kernel D up
// to 128 on DP 64 or 128. Each is told the real D: loaders fill the columns
// in [D, DP) with zeros (the cp.async src-size 0 of flash_mma.cuh), the
// zeros add nothing to Q·Kᵀ, the padded columns of O stay zero and are never
// stored, and the scale is the real 1/sqrt(D) the wrapper passes. At DP 256,
// O is 128 f32 accumulators a thread (m64n256k16, four 64-column panels of V
// in one product) beside S's 32. The D 129..256 split-TF32 kernel runs
// padded to 256 too; the f32 kernels take any strides (element-wise copies
// where rows are not whole 16-byte chunks); f32 D 257..512 runs its
// column-split form (flash_fwd_tf32x3_wide_kernel, padded to 320, 384 or
// 512). Every other D (past 512, or bf16 not a multiple of 8) runs the
// head-dim-general CUDA-core kernel (flash_fwd_general_kernel,
// flash_general.cuh): tiles and the O accumulator in dynamic shared memory,
// R = 64..8 query and key rows by D, element-by-element loads in the input
// dtype, f32 math.

#include "flash_general.cuh"
#include "flash_mma.cuh"
#include "flash_tf32.cuh"

#include <math.h>

namespace {

using namespace dl4j_mma;
using namespace dl4j_tf32;

// ---------------------------------- bf16, warpgroup MMA (wgmma.mma_async)

template <int D, int BK>
struct FwdCfg {
  static constexpr int BQ = 64;  // query rows: the wgmma M, 16 a warp
  // warpgroups, each holding DH of O's columns: two past padded 256
  static constexpr int NWG = D > 256 ? 2 : 1;
  static constexpr int THREADS = 128 * NWG;
  static constexpr int DH = D / NWG;
  using QT = Tile<D, BQ>;
  using KT = Tile<D, BK>;
  // Q, two stages of (K, V), and room to align the start to 1024 bytes
  static constexpr int SMEM = QT::BYTES + 4 * KT::BYTES + 1024;
};

template <int D, int BK>
__global__ void __launch_bounds__(FwdCfg<D, BK>::THREADS)
flash_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       float* __restrict__ lse, int H, int Tlen, int dr,
                       Str sq, Str sk, Str sv, Str so, float scale_log2,
                       int causal) {
  using C = FwdCfg<D, BK>;
  using QT = typename C::QT;
  using KT = typename C::KT;
  constexpr int BQ = C::BQ;
  constexpr int DH = C::DH;
  constexpr int NS = BK / 2;  // S accumulators a thread holds
  constexpr int NO = DH / 8;  // n-tiles of this warpgroup's O
  extern __shared__ __align__(1024) unsigned char smem[];
  // the swizzle atoms repeat every 1024 bytes: align the tiles to that
  const uint32_t s_q = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t s_kv = s_q + QT::BYTES;  // stage s: K, then V

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int wg = C::NWG > 1 ? tid >> 7 : 0;  // this warpgroup's columns
  const int warp = (tid >> 5) & 3;           // and its warp's 16 rows
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wrow = q0 + warp * 16;  // this warp's first query row
  const int dc = dr >> 3;           // real 8-column chunks of a row
  const int c0 = wg * DH;           // the warpgroup's first column of O
  // and its first 64-column panel of V
  const uint32_t v_off = (DH / 64) * wg * KT::PANEL_BYTES;

  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const int kend = causal ? min(Tlen, q0 + BQ) : Tlen;
  const int nkt = (kend + BK - 1) / BK;

  QT::template load<C::THREADS>(s_q, q + b * sq.b + h * sq.h, sq.t, q0, Tlen,
                                dc, tid);
  KT::template load<C::THREADS>(s_kv, kb, sk.t, 0, Tlen, dc, tid);
  KT::template load<C::THREADS>(s_kv + KT::BYTES, vb, sv.t, 0, Tlen, dc,
                                tid);
  cp_async_commit();

  float acc[DH / 2];  // O: n-tile d of the warpgroup's columns, this
                      // warp's rows, in acc[4d..4d+3]
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of s·scale·log2 e
  float l[2] = {0.f, 0.f};              // this lane's share of the row sum

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
    cp_async_wait<1>();  // tile j (and Q) have landed
    __syncthreads();
    const int k0 = j * BK;
    float s[NS];  // S over all of D: n-tile n of this warp's rows, 4n..
                  // (each warpgroup computes it whole)
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BK>(s, QT::desc_k(s_q, kk), KT::desc_k(s_k, kk));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] *= scale_log2;
    // only tiles that cross the diagonal or T are masked
    if (k0 + BK > Tlen || (causal && k0 + BK - 1 > wrow)) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        const int row = wrow + g + 8 * ((i >> 1) & 1);
        if (key >= Tlen || (causal && key > row)) s[i] = -INFINITY;
      }
    }
    // the online softmax, rows g (r = 0) and g + 8 (r = 1)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
        mx = fmaxf(mx, fmaxf(s[4 * n + 2 * r], s[4 * n + 2 * r + 1]));
      const float mn = fmaxf(m[r], quad_max(mx));
      const float base = mn == -INFINITY ? 0.f : mn;  // no live key yet
      const float corr = exp2_approx(m[r] - base);
      m[r] = mn;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[4 * n + e] = exp2_approx(s[4 * n + e] - base);
          sum += s[4 * n + e];
        }
      }
      l[r] = l[r] * corr + sum;
#pragma unroll
      for (int d = 0; d < NO; ++d) {
        acc[4 * d + 2 * r] *= corr;
        acc[4 * d + 2 * r + 1] *= corr;
      }
    }
    // bf16(P) as the A fragments of P·V, straight from S's registers
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<DH>(acc, pa[kk], KT::desc_mn(s_v + v_off, kk));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    __syncthreads();  // stage j & 1 is consumed before it is refilled
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    if (l[r] == 0.f) l[r] = 1.f;
    inv[r] = 1.f / l[r];
  }
  bf16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + g + 8 * r;
    if (row < Tlen) {
#pragma unroll
      for (int d = 0; d < NO; ++d)
        if (c0 / 8 + d < dc)  // the padded columns are never written
          *reinterpret_cast<uint32_t*>(ob + row * so.t + c0 + 8 * d
                                       + 2 * t4) =
              pack_bf16(acc[4 * d + 2 * r] * inv[r],
                        acc[4 * d + 2 * r + 1] * inv[r]);
      if (wg == 0 && t4 == 0)  // every warpgroup holds the same row state
        lse[(long long)bh * Tlen + row] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

template <int D, int BK>
int launch_wgmma(int BH, int Tlen, int dr, cudaStream_t s, const void* q,
                 const void* k, const void* v, void* o, void* lse, int H,
                 Str sq, Str sk, Str sv, Str so, float scale, int causal) {
  using C = FwdCfg<D, BK>;
  static_assert(C::SMEM <= 232448, "227 KiB a block on sm_90");
  auto kern = flash_fwd_wgmma_kernel<D, BK>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (Tlen + C::BQ - 1) / C::BQ);
  kern<<<grid, C::THREADS, C::SMEM, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), H, Tlen, dr, sq, sk, sv, so, scale * kLog2e,
      causal);
  return (int)cudaGetLastError();
}

// The kernel of each padded head dim DP: key tiles of 64 rows, except at
// DP 64 on a grid of fewer than two query tiles per SM, where each
// block's walk along its row is the critical path and 128-key steps halve
// its iterations (PERF.md has the tilings measured), and at DP 384 and
// 512, on two warpgroups, where two stages of 64 keys would not fit
// (240 KiB at 384). DP 256 takes 161 KiB, 384 145 KiB and 512 193 KiB,
// one block an SM.
int launch_bf16(int D, int BH, int Tlen, cudaStream_t s, const void* q,
                const void* k, const void* v, void* o, void* lse, int H,
                Str sq, Str sk, Str sv, Str so, float scale, int causal) {
#define DL4J_WGMMA(DD, BK)                                                   \
  return launch_wgmma<DD, BK>(BH, Tlen, D, s, q, k, v, o, lse, H, sq, sk,    \
                              sv, so, scale, causal)
  if (D % 8 != 0) return (int)cudaErrorInvalidValue;  // 16-byte rows
  switch (D <= 256 ? padded_dim(D) : wide_padded_dim(D)) {
    case 16: DL4J_WGMMA(16, 64);
    case 32: DL4J_WGMMA(32, 64);
    case 64: {
      int dev = 0, sms = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if ((long long)BH * ((Tlen + 63) / 64) < 2LL * sms)
        DL4J_WGMMA(64, 128);
      DL4J_WGMMA(64, 64);
    }
    case 128: DL4J_WGMMA(128, 64);
    case 256: DL4J_WGMMA(256, 64);
    case 384: DL4J_WGMMA(384, 32);
    case 512: DL4J_WGMMA(512, 32);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DL4J_WGMMA
}

// ------------- f32 at D 1..128, split TF32, a warp owns 16 whole rows

// Three TF32 products for each f32 product (flash_tf32.cuh), padded to
// DP = 64 (D 1..64) or 128 (D 65..128): the loaders zero-fill the columns
// past D, which add nothing to Q·Kᵀ, stay zero in O and are never stored.
//
// What bounds it on the card: the tensor cores' operations, three TF32
// products per f32 multiply-add (495 TFLOP/s dense; 3 x 4·D per live
// (query, key) pair), and beside them the instructions that split each
// operand (three a float) and the shared-memory reads that feed the
// products. The D 129..256 kernel below splits every step's keys between
// two warps of each 16-row group and merges their (max, sum, O) at the
// end, a plan shaped by a 256-wide O's 128 registers a thread; at D <= 128
// a warp's 16 rows of O are DP / 2 f32 registers a thread, so here, as in
// the narrow dQ and dK/dV (flash_attention_bwd.cu), warp w owns query
// rows 16 w .. 16 w + 15 whole for the whole loop: no key split, no merge,
// each row's sum taken in one fixed order.
//
// A block owns one (b*h, 64-query tile), four warps. Q stays in shared
// memory; K and V stream in stages of BK keys through a double-buffered
// cp.async ring (16-byte copies where every row is 16-byte aligned, else
// 4-byte ones), every tile in rows of DP floats under the swizzle of
// flash_tf32.cuh. A stage is taken in sub-steps of NB n-tiles of 8 keys:
//   S (16 x 8 NB) = Q·Kᵀ in split TF32, Q's rows g and g + 8 read and
//     split by the warp that owns them once a sub-step (a_frags), each A
//     fragment feeding the NB n-tiles, K split as it is read (mma_dims);
//   S scaled into log2 units (scale·log2 e folded in), masked where the
//     sub-step crosses the diagonal or T;
//   the online softmax on S's fragments in f32: the running max and sum
//     of rows g and g + 8 in registers, exp2, the row sums over the f32 P;
//   O = O·corr + P·V: P splits into hi and lo as the A fragments of P·V
//     (S's accumulators as they stand: key 2t is k index t, 2t + 1 is
//     t + 4) over V's rows of the sub-step (mma_rows_rn); the sub-step's
//     terms are summed on the tensor cores into a zeroed fragment and
//     added to O in f32, since the tensor cores' accumulation truncates
//     and a 2048-key sum kept in it drifts past the f32 atol.
// A warp skips the sub-steps that causal masking hides from all of its
// rows; the block stops at the diagonal, and the grid's slow dimension
// walks the query tiles heaviest first. No atomics: a second launch is
// bit-identical. The plans (BK and NB) are the NarrowFwd64 and
// NarrowFwd128 lines below; the launch bounds ask for as many blocks an
// SM as the shared memory allows, at most 2, which caps the registers a
// thread. On the H100 it runs at 3.4x its TF32
// bound at B8 H8 T2048 D64 causal, 0.6x SDPA's forward (PERF.md).
template <int DP_, int BK_, int NB_>
struct Tf32NarrowFwdCfg {
  static constexpr int DP = DP_;
  static constexpr int BQ = 64;         // query rows: 4 warps of 16
  static constexpr int BK = BK_;        // keys a stage
  static constexpr int NB = NB_;        // 8-key n-tiles a sub-step
  static constexpr int THREADS = 128;
  // Q, then two stages of (K, V)
  static constexpr int SMEM = (BQ * DP + 2 * 2 * BK * DP) * 4;
  // blocks an SM the shared memory allows (228 KiB an SM, 1 KiB of it
  // reserved a block)
  static constexpr int FIT = 233472 / (SMEM + 1024);
  // the launch bounds' blocks an SM
  static constexpr int BLOCKS_SM = FIT < 2 ? FIT : 2;
  static_assert(BK % (8 * NB) == 0, "whole sub-steps a stage");
  static_assert(BLOCKS_SM >= 1, "a block fits an SM");
};

template <typename C>
__global__ void __launch_bounds__(C::THREADS, C::BLOCKS_SM)
flash_fwd_tf32x3_narrow_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ o,
                               float* __restrict__ lse, int H, int Tlen,
                               int dr, Str sq, Str sk, Str sv, Str so,
                               float scale_log2, int causal, int vec) {
  constexpr int DP = C::DP;
  constexpr int BQ = C::BQ;
  constexpr int BK = C::BK;
  constexpr int NB = C::NB;
  constexpr int KP = DP / 16;           // k-step pairs over the head dim
  constexpr int NG = DP / 32;           // column groups of O
  constexpr int NT = C::THREADS;
  constexpr int SUB = 8 * NB;           // keys a sub-step
  constexpr int STAGE = 2 * BK * DP;    // floats: K, then V
  extern __shared__ __align__(16) float fsm[];
  float* const qs = fsm;
  float* const kvs = qs + BQ * DP;

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

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int kend = causal ? min(Tlen, q0 + BQ) : Tlen;
  const int nkt = (kend + BK - 1) / BK;

  load_f32_tile<BQ, DP, NT, true, DP>(qs, q + b * sq.b + h * sq.h, sq.t, q0,
                                      Tlen, dr, vec, tid);
  load_f32_tile<BK, DP, NT, true, DP>(kvs, kb, sk.t, 0, Tlen, dr, vec, tid);
  load_f32_tile<BK, DP, NT, true, DP>(kvs + BK * DP, vb, sv.t, 0, Tlen, dr,
                                      vec, tid);
  cp_async_commit();

  float acc[NG][4][4];
#pragma unroll
  for (int c = 0; c < NG; ++c)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][u][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of s·scale·log2 e
  float l[2] = {0.f, 0.f};              // this lane's share of the row sum

  for (int j = 0; j < nkt; ++j) {
    if (j + 1 < nkt) {
      float* nk = kvs + ((j + 1) & 1) * STAGE;
      load_f32_tile<BK, DP, NT, true, DP>(nk, kb, sk.t, (j + 1) * BK, Tlen,
                                          dr, vec, tid);
      load_f32_tile<BK, DP, NT, true, DP>(nk + BK * DP, vb, sv.t,
                                          (j + 1) * BK, Tlen, dr, vec, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // stage j (and Q) have landed
    __syncthreads();
    const float* ks = kvs + (j & 1) * STAGE;
    const float* vs = ks + BK * DP;
#pragma unroll 1
    for (int r0 = 0; r0 < BK; r0 += SUB) {
      const int k0 = j * BK + r0;  // the sub-step's first key
      // past T, or (causal) past every row of this warp: nothing left
      if (k0 >= Tlen || (causal && k0 > wrow + 15)) break;

      // S = Q·Kᵀ over the sub-step's keys: n-tile n holds keys k0 + 8 n ..
      float s[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kp = 0; kp < KP; ++kp) {
        uint32_t ah[2][4], al[2][4];
        a_frags<DP>(qs, wr + g, kp, t4, ah, al);
#pragma unroll
        for (int n = 0; n < NB; ++n)
          mma_dims<DP>(s[n], ks, r0 + 8 * n + g, kp, t4, ah, al);
      }

      // in log2 units; only sub-steps that cross the diagonal or T are
      // masked
      const bool edge = k0 + SUB > Tlen || (causal && k0 + SUB - 1 > wrow);
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] *= scale_log2;
          if (edge) {
            const int key = k0 + 8 * n + 2 * t4 + (e & 1);
            if (key >= Tlen || (causal && key > wrow + g + 8 * (e >> 1)))
              s[n][e] = -INFINITY;
          }
        }
      // the online softmax, rows g (r = 0) and g + 8 (r = 1): P in s
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < NB; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        const float mn = fmaxf(m[r], quad_max(mx));
        const float base = mn == -INFINITY ? 0.f : mn;  // no live key yet
        const float corr = exp2_approx(m[r] - base);
        m[r] = mn;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            s[n][e] = exp2_approx(s[n][e] - base);
            sum += s[n][e];
          }
        l[r] = l[r] * corr + sum;
#pragma unroll
        for (int c = 0; c < NG; ++c)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[c][u][2 * r] *= corr;
            acc[c][u][2 * r + 1] *= corr;
          }
      }
      // O += P·V over the sub-step's keys (rows r0 .. of the stage)
      mma_rows_rn<DP>(acc, s, vs, r0, g, t4);
    }
    __syncthreads();  // stage j & 1 is consumed before it is refilled
  }

  // O / l and the lse of rows g and g + 8 (a row past T is not written)
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = quad_sum(l[r]);
    if (lt == 0.f) lt = 1.f;
    inv[r] = 1.f / lt;
    const int row = wrow + g + 8 * r;
    if (t4 == 0 && row < Tlen)
      lse[(long long)bh * Tlen + row] = (m[r] + log2f(lt)) * kLn2;
  }
#pragma unroll
  for (int c = 0; c < NG; ++c)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][u][e] *= inv[e >> 1];
  store_rows(o + b * so.b + h * so.h, so.t, acc, wrow, g, t4, Tlen, dr);
}

// the narrow plans: (DP, keys a stage, n-tiles a sub-step), the fastest
// that -Xptxas -v shows with no spill (scripts/flash_tf32_narrow_sweep.py;
// PERF.md): 216 and 237 registers, 80 and 96 KiB of shared memory, two
// blocks an SM
using NarrowFwd64 = Tf32NarrowFwdCfg<64, 64, 8>;
using NarrowFwd128 = Tf32NarrowFwdCfg<128, 32, 4>;

template <typename C>
int launch_tf32x3_narrow(int BH, int Tlen, int dr, cudaStream_t s,
                         const void* q, const void* k, const void* v,
                         void* o, void* lse, int H, Str sq, Str sk, Str sv,
                         Str so, float scale, int causal) {
  static_assert(C::SMEM <= 232448, "227 KiB a block on sm_90");
  const bool vec = rows_16b(dr, {q, k, v}, {sq, sk, sv});
  auto kern = flash_fwd_tf32x3_narrow_kernel<C>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  // query tiles on the slow dimension: the heaviest (last) go first
  const dim3 grid(BH, (Tlen + C::BQ - 1) / C::BQ);
  kern<<<grid, C::THREADS, C::SMEM, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), H, Tlen, dr, sq, sk, sv, so, scale * kLog2e,
      causal, int(vec));
  return (int)cudaGetLastError();
}

// ------------------- f32 at D 129..256, split-TF32 tensor-core products

// Three TF32 products for each f32 product (flash_tf32.cuh says why and
// how).
//
// A block owns one (b*h, 64-row query tile) and 8 warps: four row groups
// of 16 rows, and in each row group two warps that split every step's 32
// keys, 16 each, each with its own online softmax (running max and sum)
// and its own O, so that two warps share each scheduler. A loop walks the
// key tiles, stopping at the diagonal when causal (heaviest query tiles
// first). Q (64 x 256) stays in shared memory; K and V stream through a
// double-buffered cp.async ring (16-byte copies when every row is whole
// 16-byte chunks, else one element at a time; columns past D and rows
// past T are zero-filled). A warp keeps its 16 rows of O (16 x 256) in 128
// f32 registers a thread and S (16 x 16) in 8; the online softmax runs on
// S's fragments in f32 (exp2 with the scale folded into log2 e), the row
// sums take the f32 P, and P itself splits into hi and lo for P·V (it is
// not rounded to one TF32). At the end the second warp of each row group
// posts its (max, sum, O) through shared memory in fragment order, and the
// first merges the two in a fixed order: a second launch is bit-identical.
//
// Fragment orders. A sum's terms can be taken in any order, so the k index
// of each m16n8k8 product is permuted to what a thread can load at once:
//   S = Q·Kᵀ: a pair of k-steps covers 16 dims; thread (g, t) reads a
//     float4 of Q's rows g and g + 8 and of K's row g at dims 4t..4t+3,
//     the first k-step taking dims 4t, 4t+1 as its k indices t, t + 4, the
//     second 4t+2, 4t+3;
//   O += P·V: S's accumulator fragments (row g, keys 2t and 2t + 1) are
//     P's A fragments as they stand when key 2t is k index t and key
//     2t + 1 is k index t + 4; so thread (g, t) reads V's rows 2t and
//     2t + 1. O's columns are permuted too: n-tile u of column group c
//     (32 columns) holds columns 32 c + 4 n + u, so thread g reads a float4
//     of V at columns 32 c + 4 g .. + 3 for the group's four n-tiles, and
//     holds O's row g at columns 32 c + 8 t .. 32 c + 8 t + 7.
// Row strides of D + 16 floats (Q, K) and D + 4 (V) make each of those
// float4 reads meet all 32 banks.
//
// What bounds it: operations, 3 TF32 products for each f32 multiply-add
// (495 TFLOP/s dense, 165 of f32-exact products) against 67 TFLOP/s of
// f32 on the CUDA cores; a block holds 201 KiB of shared memory, one block
// an SM.
struct Tf32FwdCfg {
  static constexpr int D = 256;        // the padded head dim
  static constexpr int BQ = 64;        // query rows: 4 groups of 16
  static constexpr int BK = 32;        // keys per step
  static constexpr int THREADS = 256;  // 8 warps: 4 row groups x 2 key halves
  static constexpr int LDQ = D + 16;   // row stride (floats) of Q and K
  static constexpr int LDV = D + 4;    // row stride of V
  static constexpr int Q_BYTES = BQ * LDQ * 4;
  static constexpr int K_BYTES = BK * LDQ * 4;
  static constexpr int V_BYTES = BK * LDV * 4;
  // Q, then two stages of (K, V)
  static constexpr int SMEM = Q_BYTES + 2 * (K_BYTES + V_BYTES);
};
static_assert(Tf32FwdCfg::SMEM <= 232448, "227 KiB a block on sm_90");
static_assert(Tf32FwdCfg::D == kD, "the split-TF32 padded width");

__global__ void __launch_bounds__(Tf32FwdCfg::THREADS, 1)
flash_fwd_tf32x3_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int H, int Tlen, int dr,
                        Str sq, Str sk, Str sv, Str so, float scale_log2,
                        int causal, int vec) {
  using C = Tf32FwdCfg;
  constexpr int BQ = C::BQ;
  constexpr int BK = C::BK;
  constexpr int LDQ = C::LDQ;
  constexpr int LDV = C::LDV;
  constexpr int KW = BK / 2;      // keys of a step a warp takes
  constexpr int NS = KW / 8;      // its n-tiles of S (8 keys each)
  constexpr int NG = C::D / 32;   // column groups of O (4 n-tiles each)
  constexpr int STAGE = BK * (LDQ + LDV);  // floats: K, then V
  extern __shared__ __align__(16) float fsm[];
  float* const qs = fsm;
  float* const kvs = fsm + BQ * LDQ;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int rg = warp & 3;          // this warp's 16 query rows
  const int kh = warp >> 2;         // and its half of each step's keys
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wrow = q0 + rg * 16;    // this warp's first query row

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int kend = causal ? min(Tlen, q0 + BQ) : Tlen;
  const int nkt = (kend + BK - 1) / BK;

  constexpr int NT = C::THREADS;
  load_f32_tile<BQ, LDQ, NT>(qs, q + b * sq.b + h * sq.h, sq.t, q0, Tlen, dr,
                             vec, tid);
  load_f32_tile<BK, LDQ, NT>(kvs, kb, sk.t, 0, Tlen, dr, vec, tid);
  load_f32_tile<BK, LDV, NT>(kvs + BK * LDQ, vb, sv.t, 0, Tlen, dr, vec,
                             tid);
  cp_async_commit();

  // O over this warp's keys: n-tile u of column group c in acc[c][u]
  float acc[NG][4][4];
#pragma unroll
  for (int c = 0; c < NG; ++c)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][u][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of s·scale·log2 e
  float l[2] = {0.f, 0.f};              // this lane's share of the row sum
  // this thread's float4 of Q's row g (row g + 8 is 8 rows on)
  const float* qrow = qs + (rg * 16 + g) * LDQ + 4 * t4;

  for (int j = 0; j < nkt; ++j) {
    if (j + 1 < nkt) {
      float* nk = kvs + ((j + 1) & 1) * STAGE;
      load_f32_tile<BK, LDQ, NT>(nk, kb, sk.t, (j + 1) * BK, Tlen, dr, vec,
                                 tid);
      load_f32_tile<BK, LDV, NT>(nk + BK * LDQ, vb, sv.t, (j + 1) * BK,
                                 Tlen, dr, vec, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and Q) have landed
    __syncthreads();
    // this warp's keys of the step: rows kw .. kw + KW - 1 of the stage
    const int kw = kh * KW;
    const float* ks = kvs + (j & 1) * STAGE + kw * LDQ;
    const float* vs = kvs + (j & 1) * STAGE + BK * LDQ + kw * LDV;
    const int k0 = j * BK + kw;

    // S = Q·Kᵀ: n-tile n (keys k0 + 8n ..) in s[n]
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kp = 0; kp < C::D / 16; ++kp) {
      const float4 qa = *reinterpret_cast<const float4*>(qrow + 16 * kp);
      const float4 qb =
          *reinterpret_cast<const float4*>(qrow + 8 * LDQ + 16 * kp);
      uint32_t ah[2][4], al[2][4];
      split_tf32(qa.x, ah[0][0], al[0][0]);
      split_tf32(qb.x, ah[0][1], al[0][1]);
      split_tf32(qa.y, ah[0][2], al[0][2]);
      split_tf32(qb.y, ah[0][3], al[0][3]);
      split_tf32(qa.z, ah[1][0], al[1][0]);
      split_tf32(qb.z, ah[1][1], al[1][1]);
      split_tf32(qa.w, ah[1][2], al[1][2]);
      split_tf32(qb.w, ah[1][3], al[1][3]);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float4 kv = *reinterpret_cast<const float4*>(
            ks + (8 * n + g) * LDQ + 16 * kp + 4 * t4);
        uint32_t bh[4], bl[4];
        split_tf32(kv.x, bh[0], bl[0]);
        split_tf32(kv.y, bh[1], bl[1]);
        split_tf32(kv.z, bh[2], bl[2]);
        split_tf32(kv.w, bh[3], bl[3]);
        mma_3xtf32(s[n], ah[0], al[0], bh[0], bh[1], bl[0], bl[1]);
        mma_3xtf32(s[n], ah[1], al[1], bh[2], bh[3], bl[2], bl[3]);
      }
    }

#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= scale_log2;
    // only key ranges that cross the diagonal or T are masked
    if (k0 + KW > Tlen || (causal && k0 + KW - 1 > wrow)) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * n + 2 * t4 + (e & 1);
          const int row = wrow + g + 8 * (e >> 1);
          if (key >= Tlen || (causal && key > row)) s[n][e] = -INFINITY;
        }
    }
    // the online softmax, rows g (r = 0) and g + 8 (r = 1)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NS; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      const float mn = fmaxf(m[r], quad_max(mx));
      const float base = mn == -INFINITY ? 0.f : mn;  // no live key yet
      const float corr = exp2_approx(m[r] - base);
      m[r] = mn;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[n][e] = exp2_approx(s[n][e] - base);
          sum += s[n][e];
        }
      l[r] = l[r] * corr + sum;
#pragma unroll
      for (int c = 0; c < NG; ++c)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[c][u][2 * r] *= corr;
          acc[c][u][2 * r + 1] *= corr;
        }
    }

    // O += P·V, keys 8 n .. 8 n + 7 of this warp's a k-step
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      uint32_t ph[4], pl[4];
      split_tf32(s[n][0], ph[0], pl[0]);  // row g, key 2t: k index t
      split_tf32(s[n][2], ph[1], pl[1]);  // row g + 8, key 2t
      split_tf32(s[n][1], ph[2], pl[2]);  // row g, key 2t + 1: k index t + 4
      split_tf32(s[n][3], ph[3], pl[3]);  // row g + 8, key 2t + 1
      const float* v0 = vs + (8 * n + 2 * t4) * LDV + 4 * g;
#pragma unroll
      for (int c = 0; c < NG; ++c) {
        const float4 va = *reinterpret_cast<const float4*>(v0 + 32 * c);
        const float4 vn =
            *reinterpret_cast<const float4*>(v0 + LDV + 32 * c);
        const float x0[4] = {va.x, va.y, va.z, va.w};
        const float x1[4] = {vn.x, vn.y, vn.z, vn.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(x0[u], bh0, bl0);
          split_tf32(x1[u], bh1, bl1);
          mma_3xtf32(acc[c][u], ph, pl, bh0, bh1, bl0, bl1);
        }
      }
    }
    __syncthreads();  // stage j & 1 is consumed before it is refilled
  }

  // merge the two key halves of each row group: the second half's warp
  // posts its (m, l, O) in fragment order (float4 i of lane x at
  // 32 i + x), the first combines them in a fixed order and stores
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
  float4* const xo = reinterpret_cast<float4*>(kvs) + rg * (NG * 4 + 1) * 32;
  if (kh == 1) {
#pragma unroll
    for (int c = 0; c < NG; ++c)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        xo[(4 * c + u) * 32 + lane] = make_float4(
            acc[c][u][0], acc[c][u][1], acc[c][u][2], acc[c][u][3]);
    xo[NG * 4 * 32 + lane] = make_float4(m[0], m[1], l[0], l[1]);
  }
  __syncthreads();
  if (kh == 1) return;
  const float4 ml = xo[NG * 4 * 32 + lane];
  const float m1[2] = {ml.x, ml.y}, l1[2] = {ml.z, ml.w};
  float a0[2], a1[2], inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mt = fmaxf(m[r], m1[r]);
    const float base = mt == -INFINITY ? 0.f : mt;  // a row past T
    a0[r] = exp2_approx(m[r] - base);
    a1[r] = exp2_approx(m1[r] - base);
    float lt = l[r] * a0[r] + l1[r] * a1[r];
    if (lt == 0.f) lt = 1.f;
    inv[r] = 1.f / lt;
    m[r] = mt;
    l[r] = lt;
  }
  float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + g + 8 * r;
    if (row < Tlen) {
#pragma unroll
      for (int c = 0; c < NG; ++c)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 x = xo[(4 * c + u) * 32 + lane];
          const float o1[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 32 * c + 8 * t4 + 4 * e + u;
            const int i = 2 * r + e;
            if (col < dr)  // the padded columns are never written
              ob[row * so.t + col] =
                  (acc[c][u][i] * a0[r] + o1[i] * a1[r]) * inv[r];
          }
        }
      if (t4 == 0)
        lse[(long long)bh * Tlen + row] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

int launch_tf32x3(int BH, int Tlen, int dr, cudaStream_t s, const void* q,
                  const void* k, const void* v, void* o, void* lse, int H,
                  Str sq, Str sk, Str sv, Str so, float scale, int causal) {
  using C = Tf32FwdCfg;
  const bool vec = rows_16b(dr, {q, k, v}, {sq, sk, sv});
  auto kern = flash_fwd_tf32x3_kernel;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (Tlen + C::BQ - 1) / C::BQ);
  kern<<<grid, C::THREADS, C::SMEM, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), H, Tlen, dr, sq, sk, sv, so, scale * kLog2e,
      causal, int(vec));
  return (int)cudaGetLastError();
}

// ----------- f32 at D 257..512, split TF32 on two warps' column halves

// Three TF32 products for each f32 product, as flash_fwd_tf32x3_kernel
// (flash_tf32.cuh), padded to 320, 384 or 512 (a half is whole 32-column
// groups, so D itself where it is a multiple of 64: no fifth of the work
// on zero columns at D 320). Past 256 one warp cannot hold its 16 rows
// of O (16 x 320 is 160 f32 registers a thread), so the two warps of
// each 16-row group split O's columns, at most 256 each (128 registers a
// thread), instead of the keys.
//
// S over the whole D: each step's 16 keys are two n-tiles of 8, and each
// warp of the pair computes one of them over all of D (its K rows and Q's
// rows as float4 reads, split on the fly), posts its 16 x 8 tile to
// shared memory in fragment order (a float4 a lane) and reads its
// partner's after a barrier of the pair's 64 threads (bar.sync, not the
// block's). Both then hold the same S and run the same online softmax,
// bit for bit; this halves S's products against computing S in both
// warps, which here would cost more than P·V itself (three TF32 products
// each), for one named barrier and 1 KiB of shared memory a pair. P
// splits too; each warp runs P·V on its half of V's columns.
//
// Fragment orders as flash_fwd_tf32x3_kernel: S's k index permuted to a
// float4 of Q and K rows; P's A fragments straight from S's accumulators
// (key 2t as k index t, 2t + 1 as t + 4); O's n-tile u of column group c
// (32 columns of the warp's half) holds columns c0 + 32 c + 4 n + u, so
// thread g reads a float4 of V at c0 + 32 c + 4 g and holds O's row g at
// c0 + 32 c + 8 t .. + 7. Row strides D + 16 (Q, K) and D + 4 (V) floats.
//
// Each warp's n-tile of S sums 3 D / 8 products; as one chain of
// dependent mma.sync it is the step's critical path (measured, PERF.md),
// so it runs as four partial sums added in a fixed order.
//
// Shared memory: Q stays resident, K and V stream in 16-key steps through
// two stages, and the pairs' S exchange: at 320 with 64 query rows, Q 84
// KiB, a stage 41.25 KiB, 4 KiB of exchange: 170.5 KiB; at 384 Q 100, a
// stage 49.25, 4: 202.5 KiB; at 512 Q alone would be 132 KiB at 64 rows,
// so 32 rows (two row groups): Q 66, a stage 65.25, 2 KiB: 198.5 KiB. One
// block an SM. Causal query tiles heaviest first; fixed-order sums, so a
// second launch is bit-identical.
template <int D, int BQ>
struct Tf32WideCfg {
  static constexpr int BK = 16;            // keys a step: two n-tiles
  static constexpr int RG = BQ / 16;       // row groups of 16 rows
  static constexpr int THREADS = RG * 64;  // a pair of warps a row group
  static constexpr int DH = D / 2;         // O's columns a warp holds
  static constexpr int LDQ = D + 16;       // row stride (floats) of Q and K
  static constexpr int LDV = D + 4;        // row stride of V
  static constexpr int Q_BYTES = BQ * LDQ * 4;
  static constexpr int K_BYTES = BK * LDQ * 4;
  static constexpr int V_BYTES = BK * LDV * 4;
  static constexpr int X_BYTES = RG * 2 * 32 * 16;  // a float4 a lane
  // Q, two stages of (K, V), the S exchange
  static constexpr int SMEM = Q_BYTES + 2 * (K_BYTES + V_BYTES) + X_BYTES;
};

// the barrier of the two warps of row group rg (0 is __syncthreads')
__device__ __forceinline__ void pair_sync(int rg) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + rg) : "memory");
}

template <int D, int BQ>
__global__ void __launch_bounds__(Tf32WideCfg<D, BQ>::THREADS, 1)
flash_fwd_tf32x3_wide_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             float* __restrict__ o, float* __restrict__ lse,
                             int H, int Tlen, int dr, Str sq, Str sk, Str sv,
                             Str so, float scale_log2, int causal, int vec) {
  using C = Tf32WideCfg<D, BQ>;
  constexpr int BK = C::BK;
  constexpr int RG = C::RG;
  constexpr int LDQ = C::LDQ;
  constexpr int LDV = C::LDV;
  constexpr int NT = C::THREADS;
  constexpr int NG = C::DH / 32;  // column groups of O (4 n-tiles each)
  constexpr int STAGE = BK * (LDQ + LDV);  // floats: K, then V
  extern __shared__ __align__(16) float fsm[];
  float* const qs = fsm;
  float* const kvs = fsm + BQ * LDQ;
  float4* const xs = reinterpret_cast<float4*>(kvs + 2 * STAGE);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int rg = warp % RG;          // this warp's 16 query rows
  const int ch = warp / RG;          // its half of O's columns, its S n-tile
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wrow = q0 + rg * 16;     // this warp's first query row
  const int c0 = ch * C::DH;         // the half's first column

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int kend = causal ? min(Tlen, q0 + BQ) : Tlen;
  const int nkt = (kend + BK - 1) / BK;

  load_f32_tile<BQ, LDQ, NT, false, D>(qs, q + b * sq.b + h * sq.h, sq.t,
                                       q0, Tlen, dr, vec, tid);
  load_f32_tile<BK, LDQ, NT, false, D>(kvs, kb, sk.t, 0, Tlen, dr, vec, tid);
  load_f32_tile<BK, LDV, NT, false, D>(kvs + BK * LDQ, vb, sv.t, 0, Tlen,
                                       dr, vec, tid);
  cp_async_commit();

  // O, this warp's half: n-tile u of column group c in acc[c][u]
  float acc[NG][4][4];
#pragma unroll
  for (int c = 0; c < NG; ++c)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][u][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of s·scale·log2 e
  float l[2] = {0.f, 0.f};              // this lane's share of the row sum
  // this thread's float4 of Q's row g (row g + 8 is 8 rows on)
  const float* qrow = qs + (rg * 16 + g) * LDQ + 4 * t4;
  float4* const x_mine = xs + (rg * 2 + ch) * 32 + lane;
  const float4* const x_other = xs + (rg * 2 + (ch ^ 1)) * 32 + lane;

  for (int j = 0; j < nkt; ++j) {
    if (j + 1 < nkt) {
      float* nk = kvs + ((j + 1) & 1) * STAGE;
      load_f32_tile<BK, LDQ, NT, false, D>(nk, kb, sk.t, (j + 1) * BK, Tlen,
                                           dr, vec, tid);
      load_f32_tile<BK, LDV, NT, false, D>(nk + BK * LDQ, vb, sv.t,
                                           (j + 1) * BK, Tlen, dr, vec, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and Q) have landed
    __syncthreads();
    const float* ks = kvs + (j & 1) * STAGE;
    const float* vs = ks + BK * LDQ;
    const int k0 = j * BK;

    // this warp's n-tile of S = Q·Kᵀ: keys k0 + 8 ch .., in four partial
    // sums over every fourth 16-dim pair (four independent mma chains,
    // not one chain of 3 D / 8 dependent products), added in a fixed order
    float sp[4][4] = {};
    const float* krow = ks + (8 * ch + g) * LDQ + 4 * t4;
    for (int k4 = 0; k4 < D / 16; k4 += 4)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int kp = k4 + r;
      float (&sm)[4] = sp[r];
      const float4 qa = *reinterpret_cast<const float4*>(qrow + 16 * kp);
      const float4 qb =
          *reinterpret_cast<const float4*>(qrow + 8 * LDQ + 16 * kp);
      const float4 kv = *reinterpret_cast<const float4*>(krow + 16 * kp);
      uint32_t ah[2][4], al[2][4], kh[4], kl[4];
      split_tf32(qa.x, ah[0][0], al[0][0]);
      split_tf32(qb.x, ah[0][1], al[0][1]);
      split_tf32(qa.y, ah[0][2], al[0][2]);
      split_tf32(qb.y, ah[0][3], al[0][3]);
      split_tf32(qa.z, ah[1][0], al[1][0]);
      split_tf32(qb.z, ah[1][1], al[1][1]);
      split_tf32(qa.w, ah[1][2], al[1][2]);
      split_tf32(qb.w, ah[1][3], al[1][3]);
      split_tf32(kv.x, kh[0], kl[0]);
      split_tf32(kv.y, kh[1], kl[1]);
      split_tf32(kv.z, kh[2], kl[2]);
      split_tf32(kv.w, kh[3], kl[3]);
      mma_3xtf32(sm, ah[0], al[0], kh[0], kh[1], kl[0], kl[1]);
      mma_3xtf32(sm, ah[1], al[1], kh[2], kh[3], kl[2], kl[3]);
    }
    float sm[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sm[e] = (sp[0][e] + sp[1][e]) + (sp[2][e] + sp[3][e]);
    // swap n-tiles with the pair's other warp: both hold all of S
    *x_mine = make_float4(sm[0], sm[1], sm[2], sm[3]);
    pair_sync(rg);
    const float4 xo = *x_other;
    const float so4[4] = {xo.x, xo.y, xo.z, xo.w};
    float s[2][4];  // S: n-tile n (keys k0 + 8n ..) in s[n]
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[0][e] = (ch == 0 ? sm[e] : so4[e]) * scale_log2;
      s[1][e] = (ch == 0 ? so4[e] : sm[e]) * scale_log2;
    }
    // only key ranges that cross the diagonal or T are masked
    if (k0 + BK > Tlen || (causal && k0 + BK - 1 > wrow)) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * n + 2 * t4 + (e & 1);
          const int row = wrow + g + 8 * (e >> 1);
          if (key >= Tlen || (causal && key > row)) s[n][e] = -INFINITY;
        }
    }
    // the online softmax, rows g (r = 0) and g + 8 (r = 1)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mx = fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                             fmaxf(s[1][2 * r], s[1][2 * r + 1]));
      const float mn = fmaxf(m[r], quad_max(mx));
      const float base = mn == -INFINITY ? 0.f : mn;  // no live key yet
      const float corr = exp2_approx(m[r] - base);
      m[r] = mn;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[n][e] = exp2_approx(s[n][e] - base);
          sum += s[n][e];
        }
      l[r] = l[r] * corr + sum;
#pragma unroll
      for (int c = 0; c < NG; ++c)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[c][u][2 * r] *= corr;
          acc[c][u][2 * r + 1] *= corr;
        }
    }

    // O += P·V on this warp's half, keys 8 n .. 8 n + 7 a k-step
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      uint32_t ph[4], pl[4];
      split_tf32(s[n][0], ph[0], pl[0]);  // row g, key 2t: k index t
      split_tf32(s[n][2], ph[1], pl[1]);  // row g + 8, key 2t
      split_tf32(s[n][1], ph[2], pl[2]);  // row g, key 2t + 1: k index t + 4
      split_tf32(s[n][3], ph[3], pl[3]);  // row g + 8, key 2t + 1
      const float* v0 = vs + (8 * n + 2 * t4) * LDV + c0 + 4 * g;
#pragma unroll
      for (int c = 0; c < NG; ++c) {
        const float4 va = *reinterpret_cast<const float4*>(v0 + 32 * c);
        const float4 vn =
            *reinterpret_cast<const float4*>(v0 + LDV + 32 * c);
        const float x0[4] = {va.x, va.y, va.z, va.w};
        const float x1[4] = {vn.x, vn.y, vn.z, vn.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(x0[u], bh0, bl0);
          split_tf32(x1[u], bh1, bl1);
          mma_3xtf32(acc[c][u], ph, pl, bh0, bh1, bl0, bl1);
        }
      }
    }
    // stage j & 1 (and the exchange) are consumed before they are refilled
    __syncthreads();
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    if (l[r] == 0.f) l[r] = 1.f;
    inv[r] = 1.f / l[r];
  }
  float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + g + 8 * r;
    if (row < Tlen) {
#pragma unroll
      for (int c = 0; c < NG; ++c)
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = c0 + 32 * c + 8 * t4 + 4 * e + u;
            if (col < dr)  // the padded columns are never written
              ob[row * so.t + col] = acc[c][u][2 * r + e] * inv[r];
          }
      if (ch == 0 && t4 == 0)  // both halves hold the same row state
        lse[(long long)bh * Tlen + row] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

template <int D, int BQ>
int launch_tf32x3_wide_at(int BH, int Tlen, int dr, cudaStream_t s,
                          const void* q, const void* k, const void* v,
                          void* o, void* lse, int H, Str sq, Str sk, Str sv,
                          Str so, float scale, int causal) {
  using C = Tf32WideCfg<D, BQ>;
  static_assert(C::SMEM <= 232448, "227 KiB a block on sm_90");
  const bool vec = rows_16b(dr, {q, k, v}, {sq, sk, sv});
  auto kern = flash_fwd_tf32x3_wide_kernel<D, BQ>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (Tlen + BQ - 1) / BQ);
  kern<<<grid, C::THREADS, C::SMEM, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), H, Tlen, dr, sq, sk, sv, so, scale * kLog2e,
      causal, int(vec));
  return (int)cudaGetLastError();
}

// Padded to 320 (five 32-column groups a half) up to D 320, else to 384
// or 512 (wide_padded_dim); 64 query rows at 320 and 384, 32 at 512 (Q's
// 132 KiB at 64 rows leaves no room for two stages)
int launch_tf32x3_wide(int BH, int Tlen, int dr, cudaStream_t s,
                       const void* q, const void* k, const void* v, void* o,
                       void* lse, int H, Str sq, Str sk, Str sv, Str so,
                       float scale, int causal) {
  if (dr <= 320)
    return launch_tf32x3_wide_at<320, 64>(BH, Tlen, dr, s, q, k, v, o, lse,
                                          H, sq, sk, sv, so, scale, causal);
  switch (wide_padded_dim(dr)) {
    case 384:
      return launch_tf32x3_wide_at<384, 64>(BH, Tlen, dr, s, q, k, v, o,
                                            lse, H, sq, sk, sv, so, scale,
                                            causal);
    case 512:
      return launch_tf32x3_wide_at<512, 32>(BH, Tlen, dr, s, q, k, v, o,
                                            lse, H, sq, sk, sv, so, scale,
                                            causal);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ------------------------------------ any D, CUDA cores (flash_general.cuh)

// One block per (b*h, R-row query tile), the heaviest first under causal
// masking; per key tile of R rows up to the diagonal: S = Q·Kᵀ, the online
// softmax row by row (a warp a row, exp in f32, P rounded to T for P·V,
// the row sum of the f32 P), O = O·corr + P·V; O and the row state stay
// in shared memory.
template <typename T, int R>
__global__ void __launch_bounds__(dl4j_gen::kGenThreads)
flash_fwd_general_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o,
                         float* __restrict__ lse, int H, int Tlen, int D,
                         Str sq, Str sk, Str sv, Str so, float scale,
                         int causal) {
  using namespace dl4j_gen;
  extern __shared__ float gsm[];
  constexpr int SLD = R + 1;
  const int ld = gen_ld(R, D);
  float* qs = gsm;
  float* os = qs + R * ld;
  float* ks = os + R * ld;
  float* vs = ks + R * ld;
  float* ss = vs + R * ld;
  float* ms = ss + R * SLD;  // running max of the scaled scores
  float* ls = ms + R;        // running row sum
  float* cs = ls + R;        // this step's correction exp(m_old - m_new)

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * R;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  load_tile<T>(qs, ld, q + b * sq.b + h * sq.h, sq.t, q0, R, Tlen, D);
  zero_tile(os, R * ld);
  for (int r = threadIdx.x; r < R; r += kGenThreads) {
    ms[r] = -INFINITY;
    ls[r] = 0.f;
  }
  const int kend = causal ? min(Tlen, q0 + R) : Tlen;
  for (int k0 = 0; k0 < kend; k0 += R) {
    __syncthreads();  // the previous tiles are consumed
    load_tile<T>(ks, ld, kb, sk.t, k0, R, Tlen, D);
    load_tile<T>(vs, ld, vb, sv.t, k0, R, Tlen, D);
    __syncthreads();
    tile_nt<R>(qs, ks, ld, D, ss, SLD);
    __syncthreads();
    for (int m = warp; m < R; m += kGenThreads / 32) {
      const int qi = q0 + m;
      float sv_[2];
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = lane + 32 * jj;
        const int key = k0 + j;
        const bool ok = j < R && key < Tlen && (!causal || key <= qi);
        sv_[jj] = ok ? ss[m * SLD + j] * scale : -INFINITY;
        mx = fmaxf(mx, sv_[jj]);
      }
      mx = warp_max(mx);
      const float m_old = ms[m];
      const float mn = fmaxf(m_old, mx);
      const float base = mn == -INFINITY ? 0.f : mn;  // no live key yet
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = lane + 32 * jj;
        const float p = __expf(sv_[jj] - base);
        if (j < R) {
          sum += p;
          ss[m * SLD + j] = round_to<T>(p);
        }
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = __expf(m_old - base);
        cs[m] = corr;
        ls[m] = ls[m] * corr + sum;
        ms[m] = mn;
      }
    }
    __syncthreads();
    tile_nn_acc<R>(ss, SLD, vs, ld, os, ld, D, min(R, kend - k0), cs);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += kGenThreads) {
    if (ls[r] == 0.f) ls[r] = 1.f;
    if (q0 + r < Tlen) lse[(long long)bh * Tlen + q0 + r] = ms[r] + logf(ls[r]);
  }
  __syncthreads();
  store_tile<T>(o + b * so.b + h * so.h, so.t, os, ld, q0, R, Tlen, D, ls);
}

template <typename T>
int launch_general(int D, int BH, int Tlen, cudaStream_t s, const void* q,
                   const void* k, const void* v, void* o, void* lse, int H,
                   Str sq, Str sk, Str sv, Str so, float scale, int causal) {
  using namespace dl4j_gen;
  const int R = gen_rows(kGenFwd, D);
  const size_t smem = gen_smem_bytes(kGenFwd, R, D);
#define DL4J_GEN_FWD(RR)                                                     \
  case RR:                                                                   \
    return launch_gen(flash_fwd_general_kernel<T, RR>, (Tlen + RR - 1) / RR, \
                      BH, smem, s, static_cast<const T*>(q),                 \
                      static_cast<const T*>(k), static_cast<const T*>(v),    \
                      static_cast<T*>(o), static_cast<float*>(lse), H, Tlen, \
                      D, sq, sk, sv, so, scale, causal);
  switch (R) {
    DL4J_GEN_FWD(64)
    DL4J_GEN_FWD(32)
    DL4J_GEN_FWD(16)
    DL4J_GEN_FWD(8)
    default:
      return (int)cudaErrorInvalidValue;  // no tile fits: D too large
  }
#undef DL4J_GEN_FWD
}

}  // namespace

// q, k, v, o: (B, H, T, D) addressed by the given element strides (the D
// stride is 1); lse: contiguous (B, H, T) f32. dtype: 0 = float32 (the
// narrow split-TF32 kernel for D <= 128, padded to 64 or 128, the
// split-TF32 kernel for D <= 256 and its column-split wide kernel for
// D <= 512), 1 = bfloat16 (the
// tensor-core kernel for D <= 512, a multiple of 8, on two warpgroups
// past 256); every other D runs the head-dim-general
// kernel in its dtype. Returns cudaGetLastError() after the launch.
extern "C" int dl4j_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int T, int D, long long sqb, long long sqh, long long sqt,
    long long skb, long long skh, long long skt, long long svb,
    long long svh, long long svt, long long sob, long long soh,
    long long sot, float scale, int causal, int dtype, void* stream) {
  if (B < 1 || H < 1 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Str sq{sqb, sqh, sqt}, sk{skb, skh, skt}, sv{svb, svh, svt},
      so{sob, soh, sot};
  if (dtype == 0) {
    if (D <= 64)
      return launch_tf32x3_narrow<NarrowFwd64>(B * H, T, D, s, q, k, v, o,
                                               lse, H, sq, sk, sv, so, scale,
                                               causal);
    if (D <= 128)
      return launch_tf32x3_narrow<NarrowFwd128>(B * H, T, D, s, q, k, v, o,
                                                lse, H, sq, sk, sv, so,
                                                scale, causal);
    if (D <= 256)
      return launch_tf32x3(B * H, T, D, s, q, k, v, o, lse, H, sq, sk, sv,
                           so, scale, causal);
    if (wide_padded_dim(D))
      return launch_tf32x3_wide(B * H, T, D, s, q, k, v, o, lse, H, sq, sk,
                                sv, so, scale, causal);
    return launch_general<float>(D, B * H, T, s, q, k, v, o, lse, H, sq, sk,
                                 sv, so, scale, causal);
  }
  if (dtype == 1) {
    if (D % 8 == 0 && (D <= 256 || wide_padded_dim(D)))
      return launch_bf16(D, B * H, T, s, q, k, v, o, lse, H, sq, sk, sv, so,
                         scale, causal);
    return launch_general<__nv_bfloat16>(D, B * H, T, s, q, k, v, o, lse, H,
                                         sq, sk, sv, so, scale, causal);
  }
  return (int)cudaErrorInvalidValue;
}
