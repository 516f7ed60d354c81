// Paged-KV decode attention (K2) for Hopper (sm_90a), plain C interface:
// split-K flash-decoding in two passes.
//
// Replaces the TPU kernel `_decode_kernel` of
// deeplearning4j_tpu/kernels/paged_attention.py (launched by
// `paged_attention`): one decode token per slot attends over that slot's
// pages of a block-paged KV pool, without gathering the pages into a
// contiguous copy first. Rows > pos are masked, unmapped pages (the
// sentinel n_pages) are skipped, and a slot with no live row gives zeros.
//
// What bounds it on the card: bytes. Each live K/V row is read once and
// used for 2*Dh multiply-adds (q.k and p.v), far below the ~295 operations
// per byte at which an H100 stops being memory-bound, so the floor is the
// live K/V bytes over 3.35 TB/s. At the 120M decode shape (8 slots, H 8,
// Dh 64) that is a few microseconds, so the kernel has to spread one
// slot's pages over many SMs and keep many loads in flight.
//
// Design. The Pallas grid (slot, logical page) ran a slot's pages in order
// and carried the online-softmax state in VMEM scratch; blocks on a GPU
// run in no order, and one block per (slot, head) left most SMs idle and
// walked each slot's pages serially. Here:
//  - Pass 1 (paged_partial_kernel), grid (split, slot, head group). A
//    split is a fixed run of `pages_per_split` logical pages of the slot's
//    page-table row (the launcher picks it so a full table puts several
//    blocks on every SM). One block covers all heads of its slot (a group
//    of them when H*Dh is large), so the heads share one read of the
//    page-table row and of pos. A page row across the block's heads is
//    contiguous (H*Dh elements, 1 KiB at the 120M shape): K and V rows are
//    staged in shared memory together, `rows_per_stage` at a time, by
//    16-byte cp.async whenever Dh*item is a multiple of 16 (the VEC
//    instantiation), else by scalar loads. Each 16-byte vector of K is
//    dotted with q there, the partial dots of a (row, head) are summed in a
//    fixed order, and the online softmax and the f32 accumulator (one
//    element per thread, H*Dh per block) update once per stage. Dead pages
//    (the sentinel, or starting past the cursor) cost neither bytes nor
//    math. Each (split, head) writes its partial (m, l, acc[Dh]) in f32 to
//    a workspace the wrapper allocates; a split with no live row writes
//    m = -inf, l = 0 and no acc.
//  - Pass 2 (paged_combine_kernel), grid (head, slot): merges the slot's
//    splits with weights exp(m_s - max m), in a fixed order (a fixed
//    reduction tree for the row sum, fixed split groups for acc), so a
//    second launch is bit-identical, and writes out in q's dtype; a slot
//    with no live row writes zeros.
// Head dims: any Dh, as the reference's Pallas blocks (1, h, dh) and
// (1, plen, h, dh) take any dh, whose pass-1 block fits in the 227 KiB
// (232448 bytes) of shared memory a block may use at one head and one
// staged row (partial_smem(1, Dh, 1): Dh <= 11621 in f32): q and the
// accumulator live in shared memory, not in one thread's registers, and
// pass 2 walks Dh in strides of its 256 threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // both passes
constexpr int kSmemPerBlock = 232448;  // 227 KiB, sm_90
constexpr int kMaxSplits = kThreads;  // pass 2: one split per thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// elements one load of the VEC instantiation moves (16 bytes), else 1
template <typename T, bool VEC>
__host__ __device__ constexpr int vec_elems() {
  return VEC ? 16 / static_cast<int>(sizeof(T)) : 1;
}

// Shared memory of one pass-1 block: K and V stages (T), then f32 q, acc,
// the partial dots, the scores of a stage, and m, l, corr per head. The
// launcher sizes it with the same function.
template <typename T, bool VEC>
__host__ __device__ constexpr size_t partial_smem(int hb, int D, int R) {
  return 2 * (size_t)R * hb * D * sizeof(T)
         + 4 * ((size_t)2 * hb * D + (size_t)R * hb * D / vec_elems<T, VEC>()
                + (size_t)R * hb + 3 * hb);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
paged_partial_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                     const T* __restrict__ v_pages,
                     const int* __restrict__ table,
                     const int* __restrict__ pos, float* __restrict__ ws_m,
                     float* __restrict__ ws_l, float* __restrict__ ws_acc,
                     int H, int D, int n_pages, int page_len, int per_slot,
                     int pages_per_split, int heads_per_block, int R,
                     float scale) {
  constexpr int V = vec_elems<T, VEC>();
  const int split = blockIdx.x;
  const int b = blockIdx.y;
  const int B = gridDim.y;
  const int h0 = blockIdx.z * heads_per_block;
  const int hg = min(heads_per_block, H - h0);  // this block's heads
  const int Wb = heads_per_block * D;           // layout width of a row
  const int W = hg * D;                         // this block's row width
  const int nv = W / V;                         // loads per staged row
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + (size_t)R * Wb;
  float* qs = reinterpret_cast<float*>(vs + (size_t)R * Wb);
  float* acc = qs + Wb;
  float* part = acc + Wb;                 // R * Wb / V partial dots
  float* ss = part + (size_t)R * Wb / V;  // R * heads_per_block scores
  float* m_s = ss + R * heads_per_block;
  float* l_s = m_s + heads_per_block;
  float* corr_s = l_s + heads_per_block;

  const long long row_elems = (long long)H * D;  // between two page rows
  for (int e = tid; e < W; e += kThreads) {
    qs[e] = to_f(q[(long long)b * row_elems + (long long)h0 * D + e]) * scale;
    acc[e] = 0.f;
  }
  for (int i = tid; i < hg; i += kThreads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }
  __syncthreads();

  const int p = pos[b];
  const int* trow = table + (long long)b * per_slot;
  const int j0 = split * pages_per_split;
  const int j1 = min(j0 + pages_per_split, per_slot);
  for (int j = j0; j < j1; ++j) {
    const int base = j * page_len;
    if (base > p) break;  // this page and the rest lie past the cursor
    const int page = trow[j];
    if (page < 0 || page >= n_pages) continue;  // unmapped: the sentinel
    const int live = min(page_len, p - base + 1);
    const long long poff =
        (long long)page * page_len * row_elems + (long long)h0 * D;
    for (int c0 = 0; c0 < live; c0 += R) {
      const int n = min(R, live - c0);
      // stage rows [c0, c0 + n) of K and V, all of the block's heads
      for (int e = tid; e < n * nv; e += kThreads) {
        const int r = e / nv;
        const int c = e - r * nv;
        const long long g = poff + (long long)(c0 + r) * row_elems
                            + (long long)c * V;
        const int s = r * Wb + c * V;
        if constexpr (VEC) {
          cp_async16(ks + s, k_pages + g);
          cp_async16(vs + s, v_pages + g);
        } else {
          ks[s] = k_pages[g];
          vs[s] = v_pages[g];
        }
      }
      if constexpr (VEC) {
        asm volatile("cp.async.commit_group;\n" ::);
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncthreads();
      // q . k over each load's V elements
      for (int e = tid; e < n * nv; e += kThreads) {
        const int r = e / nv;
        const int c = e - r * nv;
        float d = 0.f;
        if constexpr (VEC) {  // one 16-byte shared load of k, V / 4 of q
          const uint4 raw = *reinterpret_cast<const uint4*>(ks + r * Wb
                                                            + c * V);
          const T* kr = reinterpret_cast<const T*>(&raw);
          const float4* qr = reinterpret_cast<const float4*>(qs + c * V);
#pragma unroll
          for (int i = 0; i < V / 4; ++i) {
            const float4 qq = qr[i];
            d += qq.x * to_f(kr[4 * i]) + qq.y * to_f(kr[4 * i + 1])
                 + qq.z * to_f(kr[4 * i + 2]) + qq.w * to_f(kr[4 * i + 3]);
          }
        } else {
          d = qs[c] * to_f(ks[r * Wb + c]);
        }
        part[r * (Wb / V) + c] = d;
      }
      __syncthreads();
      // the score of each (row, head): its D / V partials, in order
      const int dv = D / V;
      for (int e = tid; e < n * hg; e += kThreads) {
        const int r = e / hg;
        const int hh = e - r * hg;
        const float* pp = part + r * (Wb / V) + hh * dv;
        float s = 0.f;
        for (int i = 0; i < dv; ++i) s += pp[i];
        ss[r * heads_per_block + hh] = s;
      }
      __syncthreads();
      // the online softmax, one thread a head
      for (int hh = tid; hh < hg; hh += kThreads) {
        float mc = m_s[hh];
        for (int r = 0; r < n; ++r)
          mc = fmaxf(mc, ss[r * heads_per_block + hh]);
        const float corr = expf(m_s[hh] - mc);  // 0 on the first stage
        float sum = 0.f;
        for (int r = 0; r < n; ++r) {
          const float pr = expf(ss[r * heads_per_block + hh] - mc);
          ss[r * heads_per_block + hh] = pr;
          sum += pr;
        }
        l_s[hh] = l_s[hh] * corr + sum;
        m_s[hh] = mc;
        corr_s[hh] = corr;
      }
      __syncthreads();
      // acc = acc * corr + sum_r p_r v_r, one element a thread
      for (int e = tid; e < W; e += kThreads) {
        const int hh = e / D;
        float a = acc[e] * corr_s[hh];
        for (int r = 0; r < n; ++r)
          a += ss[r * heads_per_block + hh] * to_f(vs[r * Wb + e]);
        acc[e] = a;
      }
      __syncthreads();  // the next stage overwrites ks, vs, part and ss
    }
  }

  // the partials of (split, slot, h0 + hh); a split with no live row
  // writes m = -inf, l = 0 and leaves its acc unwritten
  const long long sh = ((long long)split * B + b) * H + h0;
  for (int hh = tid; hh < hg; hh += kThreads) {
    ws_m[sh + hh] = m_s[hh];
    ws_l[sh + hh] = l_s[hh];
  }
  if (l_s[0] > 0.f)
    for (int e = tid; e < W; e += kThreads) ws_acc[sh * D + e] = acc[e];
}

// the sum (or, max_ != 0, the max) of x over the block, by a fixed tree:
// every thread gets the same bits on every launch
__device__ float block_reduce(float x, float* red, bool max_) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = max_ ? fmaxf(x, y) : x + y;
  }
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // red is free
  if ((threadIdx.x & 31) == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kThreads / 32; ++w)
    r = max_ ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ ws_m,
                     const float* __restrict__ ws_l,
                     const float* __restrict__ ws_acc, T* __restrict__ out,
                     int H, int D, int n_splits) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int B = gridDim.y;
  const int tid = threadIdx.x;
  __shared__ float w[kMaxSplits];
  __shared__ float red[kThreads];

  // split tid's weight exp(m - M), 0 where the split has no live row
  const long long stride = (long long)B * H;  // between two splits
  const long long sh = (long long)b * H + h;
  float m = -INFINITY, l = 0.f;
  if (tid < n_splits) {  // every split wrote its m and l: load both at once
    m = ws_m[tid * stride + sh];
    l = ws_l[tid * stride + sh];
  }
  const float M = block_reduce(m, red, true);
  const float ws = l > 0.f ? expf(m - M) : 0.f;
  w[tid] = ws;
  const float L = block_reduce(ws * l, red, false);  // syncs w too
  __syncthreads();  // red is reused below

  // acc. Dh <= kThreads: group g of NG sums splits g, g + NG, ... for its
  // element d, in order; then the groups' sums, in order. Past kThreads:
  // one group, each thread its elements d = tid, tid + kThreads, ...,
  // each summing the splits in order.
  if (D > kThreads) {
    for (int d = tid; d < D; d += kThreads) {
      float a = 0.f;
#pragma unroll 4
      for (int s = 0; s < n_splits; ++s)
        if (w[s] != 0.f) a += w[s] * ws_acc[(s * stride + sh) * D + d];
      out[sh * D + d] = from_f<T>(L > 0.f ? a / L : 0.f);
    }
    return;
  }
  const int DP = (D + 31) & ~31;
  const int NG = kThreads / DP;
  const int g = tid / DP;
  const int d = tid - g * DP;
  if (g < NG && d < D) {
    float a = 0.f;
#pragma unroll 4
    for (int s = g; s < n_splits; s += NG)
      if (w[s] != 0.f) a += w[s] * ws_acc[(s * stride + sh) * D + d];
    red[g * DP + d] = a;
  }
  __syncthreads();
  if (g == 0 && d < D) {
    float a = red[d];
    for (int gg = 1; gg < NG; ++gg) a += red[gg * DP + d];
    out[sh * D + d] = from_f<T>(L > 0.f ? a / L : 0.f);
  }
}

template <typename T, bool VEC>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* table, const int* pos, void* out, float* ws_m,
           float* ws_l, float* ws_acc, int B, int H, int D, int n_pages,
           int page_len, int per_slot, int pps, int n_splits, int hb, int R,
           float scale, cudaStream_t s) {
  const size_t smem = partial_smem<T, VEC>(hb, D, R);
  if (smem > (size_t)kSmemPerBlock) return (int)cudaErrorInvalidValue;
  auto kern = paged_partial_kernel<T, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid1(n_splits, B, (H + hb - 1) / hb);
  kern<<<grid1, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), table, pos, ws_m, ws_l, ws_acc, H, D,
      n_pages, page_len, per_slot, pps, hb, R, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_combine_kernel<T><<<dim3(H, B), kThreads, 0, s>>>(
      ws_m, ws_l, ws_acc, static_cast<T*>(out), H, D, n_splits);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, D), k_pages/v_pages (n_pages, page_len, H, D), table (B,
// per_slot) int32, pos (B,) int32, out (B, H, D), all contiguous; ws_m and
// ws_l (n_splits, B, H) and ws_acc (n_splits, B, H, D) f32 workspaces.
// The split plan (pages_per_split, n_splits, heads_per_block,
// rows_per_stage) comes from the wrapper; vec selects 16-byte loads (D *
// item a multiple of 16, 16-byte aligned pools). dtype: 0 = float32, 1 =
// bfloat16. Refuses a plan whose pass-1 block overflows shared memory.
// Returns the first cudaError_t of the two launches (0 = launched).
extern "C" int dl4j_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* table, const void* pos, void* out, void* ws_m, void* ws_l,
    void* ws_acc, int B, int H, int D, int n_pages, int page_len,
    int per_slot, int pages_per_split, int n_splits, int heads_per_block,
    int rows_per_stage, float scale, int dtype, int vec, void* stream) {
  const int item = dtype == 0 ? 4 : 2;
  if (D < 1 || B < 1 || H < 1 || page_len < 1 || per_slot < 1
      || pages_per_split < 1 || n_splits < 1 || n_splits > kMaxSplits
      || (long long)n_splits * pages_per_split < per_slot
      || heads_per_block < 1 || heads_per_block > H || rows_per_stage < 1
      || (dtype != 0 && dtype != 1) || (vec && (D * item) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DL4J_PAGED(TT, VV)                                                   \
  return launch<TT, VV>(q, k_pages, v_pages, static_cast<const int*>(table), \
                        static_cast<const int*>(pos), out,                   \
                        static_cast<float*>(ws_m), static_cast<float*>(ws_l),\
                        static_cast<float*>(ws_acc), B, H, D, n_pages,       \
                        page_len, per_slot, pages_per_split, n_splits,       \
                        heads_per_block, rows_per_stage, scale, s)
  if (dtype == 0) {
    if (vec) DL4J_PAGED(float, true);
    DL4J_PAGED(float, false);
  }
  if (vec) DL4J_PAGED(__nv_bfloat16, true);
  DL4J_PAGED(__nv_bfloat16, false);
#undef DL4J_PAGED
}
