// Split-TF32 tensor-core products shared by the f32 flash kernels (K1 in
// flash_attention_fwd.cu at head dims 129..512; dQ and dK/dV in
// flash_attention_bwd.cu at 1..512), sm_90a: the split of an
// f32 operand into two TF32 halves, mma.sync m16n8k8 (TF32 -> f32) in one
// and in three products, and the loader of a 256-column (or, for K1's
// wide kernel, 384- or 512-column) f32 tile.
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

// The backward's tile layout: rows of kD floats (the narrow kernels' 64
// or 128, a wide kernel's CTA its half), unpadded, whose 16-byte
// chunk c of row r sits at chunk c ^ swz(r). The backward reads every
// streamed tile two ways as a float4 a thread, each quarter-warp (lanes
// with g in {2j, 2j + 1}) at once: as the B operand of a product over the
// head dim (rows g, chunks 4 k + t) and as the B operand of a product over
// the tile's rows (rows 2t and 2t + 1, chunks 8 c + g). No row padding
// spreads both over the 8 bank groups of 16 bytes (D + 16 floats suits
// the first, D + 4 the second); this swizzle does: swz(r) of rows 2t over
// t, and of rows 2t + 1, are 0, 2, 4, 6 in some order, and rows 2j and
// 2j + 1 differ in bit 2. It permutes only a chunk index's low three
// bits, so it serves any row of a whole number of 8-chunk bank lines
// (16 chunks at 64 floats, 32 at 128).
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

}  // namespace dl4j_tf32
