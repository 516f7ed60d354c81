// Causal flash-attention forward (K1) for Hopper (sm_90a), plain C
// interface: a bf16 kernel on the tensor cores (warpgroup MMA) and an f32
// kernel on the CUDA cores, chosen by dtype.
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
// f32 (flash_fwd_kernel): tensor cores would mean TF32, which would break
// the f32 tolerance of 1e-4, so f32 keeps the CUDA-core kernel: two
// threads per query row, K/V tiles through shared memory as f32, f32 FMAs.
//
// Both take the batch, head and time strides of q, k, v and o (the last
// dimension contiguous), so the (B, T, H, D) views of one qkv buffer the
// transformer holds need no copies; the bf16 kernel needs 16-byte aligned
// bases and strides (the Python wrapper checks them and raises).
//
// Head dims: like the Pallas block (1, bq, d), any D whose tiles fit in a
// block's shared memory. The bf16 kernel takes D up to 256 and the f32
// kernel D up to 128 (bf16: a multiple of 8, 16-byte rows); each is
// instantiated on the padded width DP in {16, 32, 64, 128} (bf16 also
// 256; padded_dim) and told the real D: loaders fill the columns in
// [D, DP) with zeros (the cp.async src-size 0 of flash_mma.cuh in bf16, a
// guard in f32), the zeros add nothing to Q·Kᵀ, the padded columns of O
// stay zero and are never stored, and the scale is the real 1/sqrt(D) the
// wrapper passes. At DP 256, O is 128 f32 accumulators a thread
// (m64n256k16, four 64-column panels of V in one product) beside S's 32.
// Every other D (f32 D > 128, bf16 D > 256 or not a multiple of 8) runs
// the head-dim-general CUDA-core kernel (flash_fwd_general_kernel,
// flash_general.cuh): tiles and the O accumulator in dynamic shared
// memory, R = 64..8 query and key rows by D, element-by-element loads in
// the input dtype, f32 math.

#include "flash_general.cuh"
#include "flash_mma.cuh"

#include <math.h>

namespace {

using namespace dl4j_mma;

// ---------------------------------- bf16, warpgroup MMA (wgmma.mma_async)

template <int D, int BK>
struct FwdCfg {
  static constexpr int BQ = 64;  // query rows: one warpgroup, 16 a warp
  static constexpr int THREADS = 128;
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
  constexpr int NS = BK / 2;  // S accumulators a thread holds
  constexpr int NO = D / 8;   // n-tiles of O (of which dc are real)
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
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wrow = q0 + warp * 16;  // this warp's first query row
  const int dc = dr >> 3;           // real 8-column chunks of a row

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

  float acc[D / 2];  // O: n-tile d of this warp's rows in acc[4d..4d+3]
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
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
    float s[NS];  // S: n-tile n of this warp's rows in s[4n..4n+3]
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
      wgmma_rs<D>(acc, pa[kk], KT::desc_mn(s_v, kk));
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
        if (d < dc)  // the padded columns are never written
          *reinterpret_cast<uint32_t*>(ob + row * so.t + 8 * d + 2 * t4) =
              pack_bf16(acc[4 * d + 2 * r] * inv[r],
                        acc[4 * d + 2 * r + 1] * inv[r]);
      if (t4 == 0)
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
// its iterations (PERF.md has the tilings measured). DP 256 takes 161 KiB,
// one block an SM.
int launch_bf16(int D, int BH, int Tlen, cudaStream_t s, const void* q,
                const void* k, const void* v, void* o, void* lse, int H,
                Str sq, Str sk, Str sv, Str so, float scale, int causal) {
#define DL4J_WGMMA(DD, BK)                                                   \
  return launch_wgmma<DD, BK>(BH, Tlen, D, s, q, k, v, o, lse, H, sq, sk,    \
                              sv, so, scale, causal)
  if (D % 8 != 0) return (int)cudaErrorInvalidValue;  // 16-byte rows
  switch (padded_dim(D)) {
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
    default: return (int)cudaErrorInvalidValue;
  }
#undef DL4J_WGMMA
}

// --------------------------------------------------- f32, CUDA cores

constexpr int kThreads = 128;
constexpr int kBQ = 64;  // query rows per block (two threads per row)

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int H, int Tlen, int dr, Str sq,
                 Str sk, Str sv, Str so, float scale, int causal) {
  constexpr int BK = (D <= 64) ? 64 : 32;  // key rows per tile
  constexpr int HALF = D / 2;              // dims held per thread
  constexpr int NC = D / 8;                // 4-float slices per thread
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int part = tid & 1;
  const int qi = q0 + (tid >> 1);

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  float qr[HALF];
  float acc[HALF];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 8 * c + 4 * part + e;
      qr[4 * c + e] = qi < Tlen && d < dr ? qb[qi * sq.t + d] : 0.f;
      acc[4 * c + e] = 0.f;
    }
  }
  float m = -INFINITY;
  float l = 0.f;

  const int kend = causal ? min(Tlen, q0 + kBQ) : Tlen;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < BK * D; e += kThreads) {
      const int r = e / D;
      const int d = e - r * D;
      const int kj = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kj < Tlen && d < dr) {
        kv = kb[kj * sk.t + d];
        vv = vb[kj * sv.t + d];
      }
      ks[r][d] = kv;
      vs[r][d] = vv;
    }
    __syncthreads();

    float s[BK];
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float p = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 kk =
            *reinterpret_cast<const float4*>(&ks[j][8 * c + 4 * part]);
        p += qr[4 * c] * kk.x + qr[4 * c + 1] * kk.y
             + qr[4 * c + 2] * kk.z + qr[4 * c + 3] * kk.w;
      }
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      const int kj = k0 + j;
      const bool ok = kj < Tlen && (!causal || kj <= qi);
      s[j] = ok ? p * scale : -INFINITY;
      mt = fmaxf(mt, s[j]);
    }
    const float mn = fmaxf(m, mt);
    if (mn != -INFINITY) {  // the row has a live key so far
      const float corr = __expf(m - mn);
      l *= corr;
#pragma unroll
      for (int i = 0; i < HALF; ++i) acc[i] *= corr;
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        const float pj = __expf(s[j] - mn);
        l += pj;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv =
              *reinterpret_cast<const float4*>(&vs[j][8 * c + 4 * part]);
          acc[4 * c] += pj * vv.x;
          acc[4 * c + 1] += pj * vv.y;
          acc[4 * c + 2] += pj * vv.z;
          acc[4 * c + 3] += pj * vv.w;
        }
      }
      m = mn;
    }
  }

  if (qi < Tlen) {
    const float ls = l == 0.f ? 1.f : l;
    const float inv = 1.f / ls;
    float* ob = o + b * so.b + h * so.h + qi * so.t;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * c + 4 * part + e < dr)
          ob[8 * c + 4 * part + e] = acc[4 * c + e] * inv;
    }
    if (part == 0) lse[(long long)bh * Tlen + qi] = m + logf(ls);
  }
}

int launch_f32(int D, int BH, int Tlen, cudaStream_t s, const void* q,
               const void* k, const void* v, void* o, void* lse, int H,
               Str sq, Str sk, Str sv, Str so, float scale, int causal) {
  const dim3 grid((Tlen + kBQ - 1) / kBQ, BH);
#define DL4J_FLASH_CASE(DD)                                                  \
  case DD:                                                                   \
    flash_fwd_kernel<DD><<<grid, kThreads, 0, s>>>(                          \
        static_cast<const float*>(q), static_cast<const float*>(k),          \
        static_cast<const float*>(v), static_cast<float*>(o),                \
        static_cast<float*>(lse), H, Tlen, D, sq, sk, sv, so, scale,         \
        causal);                                                             \
    break;
  switch (padded_dim(D)) {
    DL4J_FLASH_CASE(16)
    DL4J_FLASH_CASE(32)
    DL4J_FLASH_CASE(64)
    DL4J_FLASH_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DL4J_FLASH_CASE
  return (int)cudaGetLastError();
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
// CUDA-core kernel for D <= 128), 1 = bfloat16 (the tensor-core kernel
// for D <= 256, a multiple of 8); every other D runs the head-dim-general
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
  if (dtype == 0)
    return D <= 128 ? launch_f32(D, B * H, T, s, q, k, v, o, lse, H, sq, sk,
                                 sv, so, scale, causal)
                    : launch_general<float>(D, B * H, T, s, q, k, v, o, lse,
                                            H, sq, sk, sv, so, scale, causal);
  if (dtype == 1)
    return D <= 256 && D % 8 == 0
               ? launch_bf16(D, B * H, T, s, q, k, v, o, lse, H, sq, sk, sv,
                             so, scale, causal)
               : launch_general<__nv_bfloat16>(D, B * H, T, s, q, k, v, o,
                                               lse, H, sq, sk, sv, so, scale,
                                               causal);
  return (int)cudaErrorInvalidValue;
}
