// Paged-KV decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_decode_kernel` of
// deeplearning4j_tpu/kernels/paged_attention.py (launched by
// `paged_attention`): one decode token per slot attends over that slot's
// pages of a block-paged KV pool, without gathering the pages into a
// contiguous copy first.
//
// What bounds it on the card: bytes. Each live K/V row is read once and
// used for 2*Dh multiply-adds (q.k and p.v), far below the ~295 operations
// per byte at which an H100 stops being memory-bound, so the floor is the
// live K/V bytes over 3.35 TB/s.
//
// Design. The Pallas grid (slot, logical page) ran the pages of a slot in
// order, carrying the online-softmax state in VMEM scratch; blocks on a GPU
// run in no order, so here ONE block owns one (slot, head) and a loop
// inside it walks the slot's page-table row, which the block reads itself
// (the TPU's scalar prefetch has no counterpart). A page is skipped when
// its entry is the sentinel (== n_pages) or it starts past the cursor, so
// dead pages cost neither bytes nor math. Live rows of a page are staged
// in shared memory 16 at a time (coalesced row loads, converted to f32);
// each warp scores a quarter of the rows with a shuffle reduction over Dh;
// the running max, sum and the f32 accumulator (one dimension per thread)
// are updated once per staged chunk. Rows past the cursor are never
// staged, which is the tail mask. A slot with no live row writes zeros.
// Grid: (heads, slots). This first version leaves the bytes bound far off:
// slots*heads blocks (64 at the 120M decode shape) fill half the SMs and
// each block streams its pages serially. Splitting a slot's pages over
// several blocks (a second reduction pass) is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;   // rows staged per pass
constexpr int kMaxD = 128;   // head dim limit (one accumulator per thread)

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ table,
                    const int* __restrict__ pos, T* __restrict__ out, int H,
                    int D, int n_pages, int page_len, int per_slot,
                    float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  __shared__ float qs[kMaxD];
  __shared__ float ks[kChunk][kMaxD];
  __shared__ float vs[kChunk][kMaxD];
  __shared__ float ss[kChunk];

  const long long qoff = ((long long)b * H + h) * D;
  for (int d = tid; d < D; d += kThreads) qs[d] = to_f(q[qoff + d]) * scale;
  __syncthreads();

  const int p = pos[b];
  const long long row_stride = (long long)H * D;  // elements between rows
  const int* trow = table + (long long)b * per_slot;
  float m = -INFINITY;  // running max (identical in every thread)
  float l = 0.f;        // running sum
  float acc = 0.f;      // output dimension `tid` (tid < D)

  for (int j = 0; j < per_slot; ++j) {
    const int page = trow[j];
    const int base = j * page_len;
    if (page < 0 || page >= n_pages || base > p) continue;  // dead page
    const int live = min(page_len, p - base + 1);
    const long long poff = (long long)page * page_len * row_stride
                           + (long long)h * D;
    const T* kp = k_pages + poff;
    const T* vp = v_pages + poff;
    for (int c0 = 0; c0 < live; c0 += kChunk) {
      const int n = min(kChunk, live - c0);
      for (int e = tid; e < n * D; e += kThreads) {
        const int r = e / D;
        const int d = e - r * D;
        const long long off = (long long)(c0 + r) * row_stride + d;
        ks[r][d] = to_f(kp[off]);
        vs[r][d] = to_f(vp[off]);
      }
      __syncthreads();
      for (int r = warp; r < n; r += kWarps) {
        float part = 0.f;
        for (int d = lane; d < D; d += 32) part += qs[d] * ks[r][d];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        if (lane == 0) ss[r] = part;
      }
      __syncthreads();
      float mc = m;
      for (int r = 0; r < n; ++r) mc = fmaxf(mc, ss[r]);
      const float corr = expf(m - mc);  // m == -inf on the first chunk: 0
      l *= corr;
      acc *= corr;
      for (int r = 0; r < n; ++r) {
        const float pr = expf(ss[r] - mc);
        l += pr;
        if (tid < D) acc += pr * vs[r][tid];
      }
      m = mc;
      __syncthreads();  // the next chunk overwrites ks/vs/ss
    }
  }
  if (tid < D) out[qoff + tid] = from_f<T>(l > 0.f ? acc / l : 0.f);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int dl4j_paged_attention(const void* q, const void* k_pages,
                                    const void* v_pages, const void* table,
                                    const void* pos, void* out, int B, int H,
                                    int D, int n_pages, int page_len,
                                    int per_slot, float scale, int dtype,
                                    void* stream) {
  if (D < 1 || D > kMaxD || B < 1 || H < 1 || page_len < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    paged_decode_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_pages),
        static_cast<const float*>(v_pages), static_cast<const int*>(table),
        static_cast<const int*>(pos), static_cast<float*>(out), H, D,
        n_pages, page_len, per_slot, scale);
  } else if (dtype == 1) {
    paged_decode_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k_pages),
        static_cast<const __nv_bfloat16*>(v_pages),
        static_cast<const int*>(table), static_cast<const int*>(pos),
        static_cast<__nv_bfloat16*>(out), H, D, n_pages, page_len, per_slot,
        scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
