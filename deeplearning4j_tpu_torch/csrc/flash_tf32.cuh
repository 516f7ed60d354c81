// Split-TF32 tensor-core products shared by the f32 flash kernels (K1 in
// flash_attention_fwd.cu, dQ and dK/dV in flash_attention_bwd.cu, at head
// dims 1..512), sm_90a: the split of an f32 operand into two TF32
// halves, mma.sync m16n8k8 (TF32 -> f32) in one and in three products,
// the loader of a 64- to 512-column f32 tile, and the fragment reads and
// products on swizzled tiles that the narrow kernels (D <= 128) and the
// backward's D-256 kernels share.
//
// One TF32 product keeps 10 of f32's 23 mantissa bits, an error near 1e-3
// relative, past the f32 atol of 1e-4. Three keep the f32 bar: each f32
// operand x splits into hi = tf32(x) (rounded to nearest, ties away, as
// cvt.rna rounds) and lo = x - hi, which the tensor core reads as TF32,
// and a·b = hi·hi + hi·lo + lo·hi (lo·lo, below 2^-20 relative, is
// dropped), each product exact in the f32 accumulator ("3xTF32"). The
// products run as mma.sync m16n8k8, not wgmma, because wgmma reads TF32
// operands K-major only, and every kernel here also sums over the rows of
// a tile (P·V, dS·K, Pᵀ·dO, dSᵀ·Q).
//
// Fragments of m16n8k8 (lane = 4 g + t): A a0 (row g, k t), a1 (row g + 8,
// k t), a2 (row g, k t + 4), a3 (row g + 8, k t + 4); B b0 (k t, column
// g), b1 (k t + 4, column g); the accumulator c0 (row g, column 2t), c1
// (row g, 2t + 1), c2 (row g + 8, 2t), c3 (row g + 8, 2t + 1). A sum's
// terms can be taken in any order, so each kernel permutes the k index of
// its products to what a thread can load as one float4, and an
// accumulator's (c0, c2, c1, c3) are the A fragment of a product summed
// over its columns when column 2t is k index t and 2t + 1 is k index t + 4.

#pragma once

#include "flash_mma.cuh"

#include <initializer_list>

namespace dl4j_tf32 {

using dl4j_mma::cp_async16;
using dl4j_mma::cp_async4;
using dl4j_mma::smem_u32;

constexpr int kD = 256;  // the padded head dim of the split-TF32 kernels
                         // up to D 256 (K1's wide one takes its own)

// x as hi + lo: hi is x rounded to TF32 as cvt.rna.tf32.f32 rounds a
// finite x (to nearest, ties away: half of the dropped 13 bits' range
// added to the magnitude, then the 13 bits cleared) in two integer
// operations (two cvt instructions a split made the kernel about 1.5x slower
// on the H100, PERF.md); lo = x - hi is exact in f32, and the tensor core
// reads it as TF32 by dropping its low 13 bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
// d (16 x 8, f32) += a (16 x 8) · b (8 x 8), TF32 operands
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a·b in three TF32 products, the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// The swizzled tile layout of the backward and of the narrow K1: rows of kD
// floats (the narrow kernels' 64 or 128, a wide kernel's CTA its half),
// unpadded, whose 16-byte chunk c of row r sits at chunk c ^ swz(r). These
// kernels read every streamed tile two ways as a float4 a thread, each
// quarter-warp (lanes with g in {2j, 2j + 1}) at once: as the B operand of a
// product over the head dim (rows g, chunks 4 k + t) and as the B operand of
// a product over the tile's rows (rows 2t and 2t + 1, chunks 8 c + g). No
// row padding spreads both over the 8 bank groups of 16 bytes (D + 16 floats
// suits the first, D + 4 the second); this swizzle does: swz(r) of rows 2t
// over t, and of rows 2t + 1, are 0, 2, 4, 6 in some order, and rows 2j and
// 2j + 1 differ in bit 2. It permutes only a chunk index's low three bits,
// so it serves any row of a whole number of 8-chunk bank lines (16 chunks at
// 64 floats, 32 at 128).
__device__ __forceinline__ int swz(int r) { return (r & 6) ^ ((r & 1) << 2); }

// rows [r0, r0 + R) of a (T, dr) f32 operand (time stride st) into a
// shared tile of row stride LD floats, D columns (kD, or K1's wide 384 or
// 512), by THREADS threads:
// rows >= T and columns >= dr read as 0 (a zero-fill copy touches no
// global memory); 16-byte copies when `vec` (dr % 4 == 0, 16-byte aligned
// rows), else 4-byte ones; chunk c of row r lands at chunk c ^ swz(r)
// when SWZ
template <int R, int LD, int THREADS, bool SWZ = false, int D = kD>
__device__ __forceinline__ void load_f32_tile(float* dst, const float* src,
                                              long long st, int r0, int T,
                                              int dr, bool vec, int tid) {
  constexpr int CH = D / 4;  // 16-byte chunks a row
#pragma unroll 4
  for (int e = tid; e < R * CH; e += THREADS) {
    const int r = e / CH;
    const int c = e - r * CH;
    const int row = r0 + r;
    const uint32_t s = smem_u32(dst + r * LD + 4 * (SWZ ? c ^ swz(r) : c));
    const float* g = src + (row < T ? row * st + 4 * c : 0);
    if (vec) {
      const bool ok = row < T && 4 * c < dr;
      cp_async16(s, ok ? g : src, ok);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = row < T && 4 * c + i < dr;
        cp_async4(s + 4 * i, ok ? g + i : src, ok);
      }
    }
  }
}

// 16-byte copies need every row of every operand on a 16-byte boundary
inline bool rows_16b(int dr, std::initializer_list<const void*> ptrs,
                     std::initializer_list<dl4j_mma::Str> strides) {
  if (dr % 4 != 0) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (const dl4j_mma::Str& x : strides)
    if (x.b % 4 != 0 || x.h % 4 != 0 || x.t % 4 != 0) return false;
  return true;
}

// ------- fragment reads and products on swizzled tiles (the narrow f32
// kernels, K1 in flash_attention_fwd.cu and dQ and dK/dV in
// flash_attention_bwd.cu, and the backward's D-256 kernels)

// the float4 at chunk c of row r of a swizzled tile of rows of LD floats
// (a multiple of 32: every row starts on bank 0)
template <int LD = kD>
__device__ __forceinline__ float4 ld4(const float* tile, int r, int c) {
  static_assert(LD % 32 == 0, "rows of whole 32-float bank lines");
  return *reinterpret_cast<const float4*>(tile + r * LD + 4 * (c ^ swz(r)));
}

// the A fragments of a pair of k-steps (16 dims at 16 kp) of rows r and
// r + 8 of a swizzled tile, split: k-step 0 takes dims 4t, 4t+1, k-step 1
// 4t+2, 4t+3
template <int LD = kD>
__device__ __forceinline__ void a_frags(const float* tile, int r, int kp,
                                        int t4, uint32_t (&ah)[2][4],
                                        uint32_t (&al)[2][4]) {
  const float4 x = ld4<LD>(tile, r, 4 * kp + t4);
  const float4 y = ld4<LD>(tile, r + 8, 4 * kp + t4);
  split_tf32(x.x, ah[0][0], al[0][0]);
  split_tf32(y.x, ah[0][1], al[0][1]);
  split_tf32(x.y, ah[0][2], al[0][2]);
  split_tf32(y.y, ah[0][3], al[0][3]);
  split_tf32(x.z, ah[1][0], al[1][0]);
  split_tf32(y.z, ah[1][1], al[1][1]);
  split_tf32(x.w, ah[1][2], al[1][2]);
  split_tf32(y.w, ah[1][3], al[1][3]);
}

// d (16 x 8) += A·Bᵀ over that pair of k-steps, with B's row r of a
// swizzled tile (column g of the product) at the same dims
template <int LD = kD>
__device__ __forceinline__ void mma_dims(float (&d)[4], const float* tile,
                                         int r, int kp, int t4,
                                         const uint32_t (&ah)[2][4],
                                         const uint32_t (&al)[2][4]) {
  const float4 x = ld4<LD>(tile, r, 4 * kp + t4);
  uint32_t bh[4], bl[4];
  split_tf32(x.x, bh[0], bl[0]);
  split_tf32(x.y, bh[1], bl[1]);
  split_tf32(x.z, bh[2], bl[2]);
  split_tf32(x.w, bh[3], bl[3]);
  mma_3xtf32(d, ah[0], al[0], bh[0], bh[1], bl[0], bl[1]);
  mma_3xtf32(d, ah[1], al[1], bh[2], bh[3], bl[2], bl[3]);
}

// acc (16 x 32 NG, permuted columns) += Σ_n X_n·B_n, X_n an accumulator
// fragment (16 x 8: rows g, g + 8 of columns 2t, 2t + 1) summed over B's
// rows r0 + 8 n .. r0 + 8 n + 7 of a swizzled tile (column 2t of X_n is k
// index t, B's row r0 + 8 n + 2t; 2t + 1 is k index t + 4), read at
// columns 32 c + 4 g + u into n-tile u of column group c. The NB terms
// are summed on the tensor cores into a zeroed fragment, then added to
// acc by one f32 addition. The tensor cores' accumulation truncates
// (rounds toward zero), so a sum over thousands of keys or queries kept
// in their accumulator drifts by a bias that grows with T (1.3e-4 at T
// 2048, past the f32 atol); added in f32 once a sub-step, the long sum
// rounds to nearest.
template <int LD, int NB, int NG = LD / 32>
__device__ __forceinline__ void mma_rows_rn(float (&acc)[NG][4][4],
                                            const float (&x)[NB][4],
                                            const float* tile, int r0, int g,
                                            int t4) {
#pragma unroll
  for (int c = 0; c < NG; ++c) {
    float part[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[u][e] = 0.f;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      uint32_t xh[4], xl[4];
      split_tf32(x[n][0], xh[0], xl[0]);  // row g, column 2t: k index t
      split_tf32(x[n][2], xh[1], xl[1]);  // row g + 8, column 2t
      split_tf32(x[n][1], xh[2], xl[2]);  // row g, 2t + 1: k index t + 4
      split_tf32(x[n][3], xh[3], xl[3]);  // row g + 8, column 2t + 1
      const int r = r0 + 8 * n + 2 * t4;
      const float4 b0 = ld4<LD>(tile, r, 8 * c + g);
      const float4 b1 = ld4<LD>(tile, r + 1, 8 * c + g);
      const float x0[4] = {b0.x, b0.y, b0.z, b0.w};
      const float x1[4] = {b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(x0[u], bh0, bl0);
        split_tf32(x1[u], bh1, bl1);
        mma_3xtf32(part[u], xh, xl, bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][u][e] += part[u][e];
  }
}

// store a warp's 16 rows (row0 + g, row0 + g + 8: those < T) of an
// output held as mma_rows_rn accumulates it (column 32 c + 8 t + 4 e + u
// in acc[c][u][2 r + e] of row g + 8 r), the columns < dr
template <int NG>
__device__ __forceinline__ void store_rows(float* out, long long st,
                                           const float (&acc)[NG][4][4],
                                           int row0, int g, int t4,
                                           int Tlen, int dr) {
#pragma unroll
  for (int c = 0; c < NG; ++c)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + g + 8 * (i >> 1);
        const int col = 32 * c + 8 * t4 + 4 * (i & 1) + u;
        if (row < Tlen && col < dr)  // the padded columns are never written
          out[row * st + col] = acc[c][u][i];
      }
}

}  // namespace dl4j_tf32
