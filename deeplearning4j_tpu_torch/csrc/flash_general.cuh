// The head-dim-general CUDA-core flash kernels' building blocks, shared by
// flash_attention_fwd.cu (flash_fwd_general_kernel) and
// flash_attention_bwd.cu (flash_bwd_dq_general_kernel,
// flash_bwd_dkv_general_kernel).
//
// These kernels take every head dim the fast paths do not: D > 512 in
// both dtypes (K1, dQ and dK/dV run their wide kernels at 257..512) and a
// bf16 D that is not a multiple of 8 (rows that are not whole 16-byte
// chunks, so every load is one element). Like the Pallas
// block (1, bq, d) of the reference, they take any D whose tiles fit in
// the 227 KiB of shared memory a block may use.
//
// Design. Every operand tile, every accumulator (O, dQ, dK, dV) and the
// score tiles live in dynamic shared memory as f32; loads convert from the
// element type T (float or bf16), stores round to it once. A block of
// kGenThreads threads owns R rows of its output; R, the tile rows of every
// operand, is the largest of 64, 32, 16, 8 whose tiles fit (gen_rows), so
// it shrinks as D grows and registers do not grow with D at all. Two
// block-wide products do the work:
//   tile_nt:     C[m][n] = sum_d A[m][d] B[n][d]   (S = Q·Kᵀ, dP = dO·Vᵀ),
//                each thread an MT-strided micro-tile of C, a D-slice of
//                KS lanes finished by a shuffle tree when R is small;
//   tile_nn_acc: Acc[m][d] = Acc[m][d]·rowscale[m] + sum_j P[m][j] B[j][d]
//                (O += P·V, dQ += dS·K, dV += Pᵀ·dO, dK += dSᵀ·Q), each
//                thread two columns of R / 8 rows in registers per pass.
// Row strides are chosen (gen_ld, R + 1) so that the lanes of a warp meet
// 32 different banks. Every sum runs in a fixed order: a second launch is
// bit-identical. In bf16, P and dS are rounded to bf16 before their
// products (round_to), as the TPU kernels cast them before the MXU; the
// softmax's row sums use the f32 P, as there.
//
// What bounds them: shared-memory bandwidth. Each multiply-add reads one
// or two shared operands (the micro-tiles reuse some), far from the tensor
// cores' rate; this is the simple version that is right, kept for the D
// the tensor-core kernels do not take.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "flash_mma.cuh"

namespace dl4j_gen {

using dl4j_mma::Str;

constexpr int kGenThreads = 256;
// shared memory a block may use on sm_90: 227 KiB
constexpr size_t kGenSmemMax = 232448;

enum GenKernel { kGenFwd = 0, kGenDq = 1, kGenDkv = 2 };

// lanes that split one dot product of tile_nt over D at R tile rows
__host__ __device__ constexpr int gen_ks(int R) {
  return R >= 32 ? 1 : R == 16 ? 4 : 16;
}

// the row stride of a D-wide tile at R rows: odd when one lane sums a
// whole dot product (a column walked across rows meets 32 banks), else
// KS mod 32, so the KS lanes of a row and the 32 / KS rows of a warp in
// tile_nt meet 32 different banks
__host__ __device__ constexpr int gen_ld(int R, int D) {
  return gen_ks(R) == 1 ? (D | 1) : D + (gen_ks(R) - D % 32 + 32) % 32;
}

// shared bytes of kernel `kern` at R tile rows and head dim D: its D-wide
// f32 tiles (fwd: Q, O, K, V; dq: Q, dO, dQ, K, V; dkv: K, V, dK, dV, Q,
// dO), its R x R score tiles and its per-row vectors. Mirrored by
// kernels/flash_attention.py (GENERAL_TILES, general_smem_bytes).
inline size_t gen_smem_bytes(int kern, int R, int D) {
  static const int tiles[3][3] = {{4, 1, 3}, {5, 2, 2}, {6, 2, 2}};
  const size_t ld = (size_t)gen_ld(R, D);
  return 4 * ((size_t)tiles[kern][0] * R * ld
              + (size_t)tiles[kern][1] * R * (R + 1)
              + (size_t)tiles[kern][2] * R);
}

// the tile rows of kernel `kern` at head dim D: the largest of 64, 32, 16,
// 8 whose tiles fit in kGenSmemMax, 0 when none does
inline int gen_rows(int kern, int D) {
  for (int R = 64; R >= 8; R /= 2)
    if (gen_smem_bytes(kern, R, D) <= kGenSmemMax) return R;
  return 0;
}

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// x as the element type rounds it (bf16: to nearest even), back in f32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// rows [r0, r0 + R) of one (T, D) operand (element strides: row `st`,
// column 1) into an f32 tile of row stride ld; zeros past Tlen
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const T* __restrict__ src,
                                          long long st, int r0, int R,
                                          int Tlen, int D) {
  for (int e = threadIdx.x; e < R * D; e += kGenThreads) {
    const int r = e / D;
    const int d = e - r * D;
    const int row = r0 + r;
    dst[r * ld + d] = row < Tlen ? to_f32<T>(src[row * st + d]) : 0.f;
  }
}

// rows [r0, r0 + R) below Tlen of an f32 tile to the operand, each value
// divided by rdiv[r] when rdiv is given
template <typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ dst, long long st,
                                           const float* src, int ld, int r0,
                                           int R, int Tlen, int D,
                                           const float* rdiv) {
  for (int e = threadIdx.x; e < R * D; e += kGenThreads) {
    const int r = e / D;
    const int d = e - r * D;
    const int row = r0 + r;
    if (row < Tlen) {
      const float x = src[r * ld + d];
      dst[row * st + d] = from_f32<T>(rdiv ? x / rdiv[r] : x);
    }
  }
}

// C[m][n] = sum_{d < D} A[m][d] B[n][d] for m, n < R; A and B of row
// stride ld, C of row stride cld. Thread (tm, tn, ks) sums the TM x TM
// entries (tm + MT i, tn + MT j) over d = ks, ks + KS, ...; the KS lanes
// of an entry are adjacent and meet by a shuffle tree.
template <int R>
struct NtShape {
  static constexpr int TM = R >= 32 ? R / 16 : 2;
  static constexpr int MT = R / TM;
  static constexpr int KS = kGenThreads / (MT * MT);
  static_assert(KS == gen_ks(R) && (KS & (KS - 1)) == 0, "tile shape");
};

template <int R>
__device__ __forceinline__ void tile_nt(const float* A, const float* B,
                                        int ld, int D, float* C, int cld) {
  using S = NtShape<R>;
  constexpr int TM = S::TM, MT = S::MT, KS = S::KS;
  const int ks = threadIdx.x % KS;
  const int u = threadIdx.x / KS;
  const int tm = u / MT;
  const int tn = u - tm * MT;
  float acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = ks; d < D; d += KS) {
    float a[TM], b[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      a[i] = A[(tm + MT * i) * ld + d];
      b[i] = B[(tn + MT * i) * ld + d];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      float x = acc[i][j];
#pragma unroll
      for (int o = KS / 2; o > 0; o >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, o);
      if (ks == 0) C[(tm + MT * i) * cld + tn + MT * j] = x;
    }
}

// Acc[m][d] = Acc[m][d] * rowscale[m] (when given) + sum_{j < jn}
// P[m][j] B[j][d], for m < R, d < D. Warp w owns rows w, w + 8, ...; lane
// l columns l + 64 c and l + 32 + 64 c, summed in registers over j.
template <int R>
__device__ __forceinline__ void tile_nn_acc(const float* P, int pld,
                                            const float* B, int bld,
                                            float* Acc, int ald, int D,
                                            int jn, const float* rowscale) {
  constexpr int RM = R / 8;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  for (int d0 = lane; d0 < D; d0 += 64) {
    const bool two = d0 + 32 < D;
    const int d1 = two ? d0 + 32 : d0;
    float a0[RM], a1[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int m = w + 8 * i;
      const float sc = rowscale ? rowscale[m] : 1.f;
      a0[i] = Acc[m * ald + d0] * sc;
      a1[i] = Acc[m * ald + d1] * sc;
    }
#pragma unroll 4
    for (int j = 0; j < jn; ++j) {
      const float b0 = B[j * bld + d0];
      const float b1 = B[j * bld + d1];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float p = P[(w + 8 * i) * pld + j];
        a0[i] = fmaf(p, b0, a0[i]);
        a1[i] = fmaf(p, b1, a1[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int m = w + 8 * i;
      Acc[m * ald + d0] = a0[i];
      if (two) Acc[m * ald + d1] = a1[i];
    }
  }
}

__device__ __forceinline__ void zero_tile(float* t, int n) {
  for (int e = threadIdx.x; e < n; e += kGenThreads) t[e] = 0.f;
}

// f32 per-row values [r0, r0 + R) of a contiguous (B*H, Tlen) array (lse,
// delta) into shared memory; zeros past Tlen
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int R, int Tlen) {
  for (int r = threadIdx.x; r < R; r += kGenThreads)
    dst[r] = r0 + r < Tlen ? src[r0 + r] : 0.f;
}

// launch `kern` on a (tiles, BH) grid with its dynamic shared memory
// raised to `smem` bytes; returns the launch's cudaError_t
template <typename K, typename... Args>
int launch_gen(K kern, int tiles, int BH, size_t smem, cudaStream_t s,
               Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(tiles, BH), kGenThreads, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace dl4j_gen
