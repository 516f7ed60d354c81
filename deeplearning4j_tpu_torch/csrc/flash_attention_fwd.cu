// Causal flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_fwd_kernel` of
// deeplearning4j_tpu/kernels/flash_attention.py (launched by `_fwd`):
// FlashAttention-2 forward with an online softmax, writing O in the input
// dtype and the per-row log-sum-exp in f32, so the (T, T) score matrix
// never reaches device memory.
//
// What bounds it on the card: operations. At T = 1024-2048 and D = 64 a
// causal head does ~T*T*D*2 flops over ~4*T*D*2 bytes, hundreds of
// operations per byte, so the floor is the flops over the bf16 tensor-core
// rate. This first version does its products with f32 FMAs on the CUDA
// cores (no mma.sync / wgmma yet), so it stays well above that floor; the
// tensor-core rewrite (wgmma fed by TMA) is later work.
//
// Design. The Pallas grid (b*h, q-block, k-block) streamed key blocks
// through VMEM in order with the softmax state in scratch; here one block
// owns one (b*h, 64-row query tile) and a loop inside it walks the key
// tiles, stopping at the diagonal when causal (the tiles the TPU kernel
// skipped with pl.when and clamped its DMA for are never visited). Each
// K/V tile goes through shared memory as f32. Two threads share a query
// row, each holding half of the row's q and accumulator in registers, in
// interleaved 4-float slices so a warp's shared reads are broadcast float4
// loads without bank conflicts; one shuffle completes each score. The
// softmax statistics are f32. A T that is not a multiple of the tile is
// handled by masking keys and not writing rows past T. The kernel takes
// the batch, head and time strides of q, k, v and o (the last dimension
// must be contiguous), so the (B, T, H, D) layout the transformer holds
// needs no transposes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;  // query rows per block (two threads per row)

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Tlen, long long sqb,
                 long long sqh, long long sqt, long long skb, long long skh,
                 long long skt, long long svb, long long svh, long long svt,
                 long long sob, long long soh, long long sot, float scale,
                 int causal) {
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

  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;

  float qr[HALF];
  float acc[HALF];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 8 * c + 4 * part + e;
      qr[4 * c + e] = qi < Tlen ? to_f(qb[qi * sqt + d]) : 0.f;
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
      if (kj < Tlen) {
        kv = to_f(kb[kj * skt + d]);
        vv = to_f(vb[kj * svt + d]);
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
    T* ob = o + b * sob + h * soh + qi * sot;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ob[8 * c + 4 * part + e] = from_f<T>(acc[4 * c + e] * inv);
    }
    if (part == 0) lse[(long long)bh * Tlen + qi] = m + logf(ls);
  }
}

template <typename T>
int launch(int D, dim3 grid, cudaStream_t s, const void* q, const void* k,
           const void* v, void* o, void* lse, int H, int Tlen, long long sqb,
           long long sqh, long long sqt, long long skb, long long skh,
           long long skt, long long svb, long long svh, long long svt,
           long long sob, long long soh, long long sot, float scale,
           int causal) {
#define DL4J_FLASH_CASE(DD)                                                  \
  case DD:                                                                   \
    flash_fwd_kernel<T, DD><<<grid, kThreads, 0, s>>>(                       \
        static_cast<const T*>(q), static_cast<const T*>(k),                  \
        static_cast<const T*>(v), static_cast<T*>(o),                        \
        static_cast<float*>(lse), H, Tlen, sqb, sqh, sqt, skb, skh, skt, svb,\
        svh, svt, sob, soh, sot, scale, causal);                             \
    break;
  switch (D) {
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

}  // namespace

// q, k, v, o: (B, H, T, D) addressed by the given element strides (the D
// stride is 1); lse: contiguous (B, H, T) f32. dtype: 0 = float32,
// 1 = bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int dl4j_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int T, int D, long long sqb, long long sqh, long long sqt,
    long long skb, long long skh, long long skt, long long svb,
    long long svh, long long svt, long long sob, long long soh,
    long long sot, float scale, int causal, int dtype, void* stream) {
  if (B < 1 || H < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + kBQ - 1) / kBQ, B * H);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(D, grid, s, q, k, v, o, lse, H, T, sqb, sqh, sqt,
                         skb, skh, skt, svb, svh, svt, sob, soh, sot, scale,
                         causal);
  if (dtype == 1)
    return launch<__nv_bfloat16>(D, grid, s, q, k, v, o, lse, H, T, sqb, sqh,
                                 sqt, skb, skh, skt, svb, svh, svt, sob, soh,
                                 sot, scale, causal);
  return (int)cudaErrorInvalidValue;
}
