// Fused BatchNorm + activation (K3) for Hopper (sm_90a), plain C interface.
//
// Replaces the four TPU kernel bodies of deeplearning4j_tpu/kernels/
// fused_ops.py:
//   bn_act_kernel    <- `_kernel` (inference `fused_bn_act`, and the
//                       normalize pass of `fused_bn_act_train`):
//                       y = act(x * scale + shift) over (N, C) rows;
//   bn_reduce_kernel <- `_stats_kernel` (mode 0: per channel sum(d) and
//                       sum(d*d), d = x - center) and
//                       `_bn_bwd_reduce_kernel` (mode 1: per channel
//                       sum(dz) and sum(dz * xhat), z, xhat and act'(z)
//                       recomputed from x);
//   bn_dx_kernel     <- `_bn_bwd_dx_kernel`:
//                       dx = scale * (dz - sum(dz)/N - xhat * sum(dz*xhat)/N).
//
// What bounds them on the card: bytes. Each element costs a few f32
// operations against 2 (bf16) or 4 (f32) bytes moved, far below the ~40
// f32 operations per byte at which an H100 stops being memory-bound, so
// the floor of each pass is its (N, C) tensors over 3.35 TB/s.
//
// Design. The elementwise passes walk the (N, C) array as a flat run of
// 16-byte vectors (8 bf16 or 4 f32, all of one row since C is a multiple
// of the width), with a scalar variant when C or a pointer does not allow
// that. The per-channel vectors are read 16 bytes at a time too, through
// the read-only cache: scalar reads, 32 bytes apart across a warp, made
// the passes at C >= 256 run 3-4x their bound. Math is f32 and each product
// and sum is rounded as the plain PyTorch version rounds it (no
// contraction into FMAs), then cast on store.
//
// The TPU kernels carried the (2, C) accumulator resident across a
// sequential grid axis. Blocks on the card run in no order, so a
// reduction is one launch finished by its last block, with no atomics on
// the sums: block (g, t) of bn_reduce_kernel sums rows [g*rows_per_chunk,
// (g+1)*rows_per_chunk) of channel tile t (each thread over a fixed
// stride of rows, then the block's row lanes in a fixed order) into a
// partial (G, 2, C) workspace, fences it, and bumps the tile's arrival
// counter. The block that arrives last at tile t sums the tile's G
// partials in the fixed order g = 0..G-1, spread over its threads (a
// fixed stride of g each, in float4s where C allows) and finished by a
// fixed reduction tree, writes the sums and the fused epilogue, and
// resets the counter to zero for the next launch. The sum's order does
// not depend on which block arrives last, and the plan (tile width, rows
// per chunk, G) depends only on N, C and the load width, so two launches
// on the same input give bit-identical sums. The plan (reduce_plan in
// kernels/fused_ops.py) reckons bytes: every block streams at least 16384
// elements (32 KiB of bf16), channel tiles are 64 bf16 / 32 f32 columns
// (128-byte row segments), and the grid fills the 132 SMs 4 (stats) or 3
// (backward reduce) blocks deep in one wave where N allows, so the
// workspace, and the last block's read of it, stay small (a few hundred
// KiB at most). The epilogue rounds each step as the plain PyTorch
// version does (__fdiv_rn, __fmul_rn, no FMA contraction; rsqrtf as
// torch.rsqrt on the card):
//   stats (MODE 0): out (7, C) = [sum d; sum d*d; mean = center + s1/N;
//     var = max(s2/N - (s1/N)^2, 0); inv = rsqrt(var + eps);
//     scale = gamma * inv; shift = beta - mean * scale];
//   backward reduce (MODE 1): out (4, C) = [sum dz; sum dz*xhat;
//     sum dz / N; sum dz*xhat / N] (dbeta, dgamma, and the dx kernel's
//     corr).
// The arrival counters are a persistent int32 buffer of the caller's, one
// entry per channel tile, zeroed once and cleaned by the kernel itself:
// no memset launch per call, and nothing to re-zero under CUDA-graph
// capture. Concurrency: launches that share a counter buffer must run in
// stream order (one stream at a time, as the module gives each (device,
// stream) its own buffer); two launches in flight at once on one buffer
// would mix their arrivals.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

enum Act {
  kIdentity = 0,
  kRelu = 1,
  kRelu6 = 2,
  kSigmoid = 3,
  kTanh = 4,
  kSwish = 5,
  kLeakyRelu = 6,
  kElu = 7,
  kGelu = 8,
  kSoftplus = 9,
};

__device__ __forceinline__ float sigmoidf_(float z) {
  return 1.0f / (1.0f + expf(-z));
}

// fused_ops._ACTS, letter for letter
template <int A>
__device__ __forceinline__ float act_fwd(float z) {
  if (A == kIdentity) return z;
  if (A == kRelu) return fmaxf(z, 0.0f);
  if (A == kRelu6) return fminf(fmaxf(z, 0.0f), 6.0f);
  if (A == kSigmoid) return sigmoidf_(z);
  if (A == kTanh) return tanhf(z);
  // F.silu's own rounding, z / (1 + exp(-z)): z * sigmoid(z) rounds twice
  // and parts from it by one bf16 ulp now and then (0.03125 at |z| >= 4)
  if (A == kSwish) return __fdiv_rn(z, __fadd_rn(1.0f, expf(-z)));
  if (A == kLeakyRelu) return z >= 0.0f ? z : 0.01f * z;
  if (A == kElu) return z > 0.0f ? z : expm1f(z);
  if (A == kGelu) {
    const float u = 0.7978845608028654f * (z + 0.044715f * (z * z * z));
    return z * (0.5f * (1.0f + tanhf(u)));
  }
  // softplus = logaddexp(z, 0)
  return fmaxf(z, 0.0f) + log1pf(expf(-fabsf(z)));
}

// fused_ops._ACT_GRADS: act'(z) from the PRE-activation z (7 entries)
template <int A>
__device__ __forceinline__ float act_grad(float z) {
  if (A == kIdentity) return 1.0f;
  if (A == kRelu) return z > 0.0f ? 1.0f : 0.0f;
  if (A == kRelu6) return (z > 0.0f && z < 6.0f) ? 1.0f : 0.0f;
  if (A == kSigmoid) {
    const float s = sigmoidf_(z);
    return s * (1.0f - s);
  }
  if (A == kTanh) {
    const float t = tanhf(z);
    return 1.0f - t * t;
  }
  if (A == kLeakyRelu) return z > 0.0f ? 1.0f : 0.01f;
  return sigmoidf_(z);  // softplus
}

// ---- V elements of T as f32: one 16-byte access when V > 1
template <typename T, int V>
struct Io;

template <>
struct Io<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* o) {
    o[0] = *p;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *p = v[0];
  }
};

template <>
struct Io<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* o) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    o[0] = u.x;
    o[1] = u.y;
    o[2] = u.z;
    o[3] = u.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Io<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* o) {
    o[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    *p = __float2bfloat16(v[0]);
  }
};

template <>
struct Io<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* o) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      o[2 * k] = f.x;
      o[2 * k + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

// V per-channel f32 values from c (a multiple of V): 16-byte loads through
// the read-only cache when V > 1, so a warp's per-channel reads are as
// wide as its row reads
template <int V>
__device__ __forceinline__ void load_ch(const float* __restrict__ p,
                                        float* o) {
  if constexpr (V == 1) {
    o[0] = __ldg(p);
  } else {
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(p + k));
      o[k] = u.x;
      o[k + 1] = u.y;
      o[k + 2] = u.z;
      o[k + 3] = u.w;
    }
  }
}

// ---------------------------------------------------------------- kernels

// y = act(x * scale + shift)
template <typename T, int A, int V>
__global__ void __launch_bounds__(kThreads)
bn_act_kernel(const T* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ shift, T* __restrict__ y,
              unsigned total_vec, unsigned C) {
  for (unsigned v = blockIdx.x * blockDim.x + threadIdx.x; v < total_vec;
       v += gridDim.x * blockDim.x) {
    const unsigned e = v * V;
    const unsigned c = e % C;
    float xv[V], sc[V], sh[V], out[V];
    Io<T, V>::load(x + e, xv);
    load_ch<V>(scale + c, sc);
    load_ch<V>(shift + c, sh);
#pragma unroll
    for (int k = 0; k < V; ++k)
      out[k] = act_fwd<A>(__fadd_rn(__fmul_rn(xv[k], sc[k]), sh[k]));
    Io<T, V>::store(y + e, out);
  }
}

// The finish of channel tile blockIdx.y, run by the block that arrived
// last: sum the tile's G partials (2 x W channels from cw0) in the fixed
// order g = 0..G-1, then the epilogue. VF floats per load (4 when C and
// the tile are whole float4s). Thread t owns slot u = t % S of the
// S = 2W / VF slots and the g = j, j + P, ... of group j = t / S; the P
// groups (a power of two) meet in a fixed tree in shared memory `red`.
template <int MODE, int VF>
__device__ __forceinline__ void finish_tile(
    const float* __restrict__ partial, float* __restrict__ out, float* red,
    const float* __restrict__ p0, const float* __restrict__ p1,
    const float* __restrict__ p2, int N, int C, int cw0, int W, float eps) {
  const int t = threadIdx.x;
  const int S = 2 * W / VF;
  int P = 1;
  while (2 * P * S <= (int)blockDim.x) P *= 2;
  const int u = t % S;
  const int j = t / S;
  const int G = gridDim.x;
  if (j < P) {
    const int which = u * VF / W;
    const float* src = partial + (long long)which * C + cw0 + u * VF % W;
    float acc[VF];
#pragma unroll
    for (int e = 0; e < VF; ++e) acc[e] = 0.0f;
    // kBatch loads in flight before their adds: the partials sit in L2,
    // and one at a time the last block would wait out G / P round trips
    constexpr int kBatch = 8;
    for (int g0 = j; g0 < G; g0 += kBatch * P) {
      float v[kBatch][VF];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        // past G, reload row j (a valid address); it is never added
        const int g = g0 + b * P < G ? g0 + b * P : j;
        const float* p = src + (long long)g * 2 * C;
        if constexpr (VF == 4) {
          const float4 q = __ldcg(reinterpret_cast<const float4*>(p));
          v[b][0] = q.x;
          v[b][1] = q.y;
          v[b][2] = q.z;
          v[b][3] = q.w;
        } else {
          v[b][0] = __ldcg(p);
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (g0 + b * P < G)
#pragma unroll
          for (int e = 0; e < VF; ++e) acc[e] = __fadd_rn(acc[e], v[b][e]);
    }
#pragma unroll
    for (int e = 0; e < VF; ++e) red[j * 2 * W + u * VF + e] = acc[e];
  }
  for (int half = P / 2; half > 0; half /= 2) {
    __syncthreads();
    if (j < half)
#pragma unroll
      for (int e = 0; e < VF; ++e)
        red[j * 2 * W + u * VF + e] = __fadd_rn(
            red[j * 2 * W + u * VF + e], red[(j + half) * 2 * W + u * VF + e]);
  }
  __syncthreads();
  if (t < W) {
    const int c = cw0 + t;
    const float s1 = red[t], s2 = red[W + t];
    const float nf = (float)N;
    out[c] = s1;
    out[C + c] = s2;
    if (MODE == 0) {  // p0 = center, p1 = gamma, p2 = beta
      const float m1 = __fdiv_rn(s1, nf);
      const float mean = __fadd_rn(__ldg(p0 + c), m1);
      const float var =
          fmaxf(__fsub_rn(__fdiv_rn(s2, nf), __fmul_rn(m1, m1)), 0.0f);
      const float inv = rsqrtf(__fadd_rn(var, eps));
      const float scale = __fmul_rn(__ldg(p1 + c), inv);
      out[2 * C + c] = mean;
      out[3 * C + c] = var;
      out[4 * C + c] = inv;
      out[5 * C + c] = scale;
      out[6 * C + c] = __fsub_rn(__ldg(p2 + c), __fmul_rn(mean, scale));
    } else {
      out[2 * C + c] = __fdiv_rn(s1, nf);
      out[3 * C + c] = __fdiv_rn(s2, nf);
    }
  }
}

// Per-channel sums of one (row chunk, channel tile) into the partial
// workspace; the block that arrives last at its tile finishes it
// (finish_tile).
// MODE 0 (stats):    p0 = center, p1 = gamma, p2 = beta; sums d, d*d.
// MODE 1 (backward): p0 = scale, p1 = shift,
//                    p2 = mean, p3 = inv, g = dy; sums dz, dz*xhat.
// blockDim = tcv * R: thread t owns channel vector t % tcv of the tile and
// rows r0 + t / tcv, r0 + t / tcv + R, ...
// At most 85 registers a thread, so 3 blocks fit on an SM in every
// variant; the plan sizes the grid to that depth (4 for the stats kernel,
// which needs fewer), one wave.
template <typename T, int MODE, int A, int V>
__global__ void __launch_bounds__(kThreads, 3)
bn_reduce_kernel(const T* __restrict__ x, const T* __restrict__ g,
                 const float* __restrict__ p0, const float* __restrict__ p1,
                 const float* __restrict__ p2, const float* __restrict__ p3,
                 float* __restrict__ partial, float* __restrict__ out,
                 int* __restrict__ counters, int N, int C, int tcv,
                 int rows_per_chunk, float eps) {
  extern __shared__ float sm[];  // [R][tcv][2][V], then the finish's tree
  __shared__ int last;
  const int t = threadIdx.x;
  const int R = blockDim.x / tcv;
  const int cvl = t % tcv;
  const int rl = t / tcv;
  const int c0 = (blockIdx.y * tcv + cvl) * V;
  float s1[V], s2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s1[k] = s2[k] = 0.0f;
  if (c0 < C) {
    float a0[V], a1[V], a2[V], a3[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      a0[k] = __ldg(p0 + c0 + k);
      if (MODE == 1) {
        a1[k] = __ldg(p1 + c0 + k);
        a2[k] = __ldg(p2 + c0 + k);
        a3[k] = __ldg(p3 + c0 + k);
      }
    }
    const long long r0 = (long long)blockIdx.x * rows_per_chunk;
    const long long r1 = min((long long)N, r0 + rows_per_chunk);
#pragma unroll 4
    for (long long r = r0 + rl; r < r1; r += R) {
      float xv[V];
      Io<T, V>::load(x + r * C + c0, xv);
      if (MODE == 0) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float d = __fsub_rn(xv[k], a0[k]);
          s1[k] = __fadd_rn(s1[k], d);
          s2[k] = __fadd_rn(s2[k], __fmul_rn(d, d));
        }
      } else {
        float gv[V];
        Io<T, V>::load(g + r * C + c0, gv);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float z = __fadd_rn(__fmul_rn(xv[k], a0[k]), a1[k]);
          const float dz = __fmul_rn(gv[k], act_grad<A>(z));
          const float xhat = __fmul_rn(__fsub_rn(xv[k], a2[k]), a3[k]);
          s1[k] = __fadd_rn(s1[k], dz);
          s2[k] = __fadd_rn(s2[k], __fmul_rn(dz, xhat));
        }
      }
    }
  }
  float* mine = sm + (rl * tcv + cvl) * 2 * V;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    mine[k] = s1[k];
    mine[V + k] = s2[k];
  }
  __syncthreads();
  // sum the row lanes of each (channel vector, which, k) in a fixed order
  const int width = tcv * 2 * V;
  for (int i = t; i < width; i += blockDim.x) {
    float acc = 0.0f;
    for (int q = 0; q < R; ++q) acc = __fadd_rn(acc, sm[q * width + i]);
    const int cv = i / (2 * V);
    const int which = (i % (2 * V)) / V;
    const int c = (blockIdx.y * tcv + cv) * V + i % V;
    if (c < C) partial[((long long)blockIdx.x * 2 + which) * C + c] = acc;
  }
  // publish this block's partial, then take a ticket at the tile's counter
  __threadfence();
  __syncthreads();
  if (t == 0)
    last = atomicAdd(counters + blockIdx.y, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();  // the other blocks' partials are visible past here
  const int cw0 = blockIdx.y * tcv * V;
  const int W = min(tcv * V, C - cw0);
  if (V > 1)
    finish_tile<MODE, 4>(partial, out, sm, p0, p1, p2, N, C, cw0, W, eps);
  else
    finish_tile<MODE, 1>(partial, out, sm, p0, p1, p2, N, C, cw0, W, eps);
  if (t == 0) counters[blockIdx.y] = 0;  // clean for the next launch
}

// dx = scale * ((dz - corr0) - xhat * corr1), corr = [sum dz; sum dz*xhat]/N
template <typename T, int A, int V>
__global__ void __launch_bounds__(kThreads)
bn_dx_kernel(const T* __restrict__ x, const T* __restrict__ g,
             const float* __restrict__ scale, const float* __restrict__ shift,
             const float* __restrict__ mean, const float* __restrict__ inv,
             const float* __restrict__ corr, T* __restrict__ dx,
             unsigned total_vec, unsigned C) {
  for (unsigned v = blockIdx.x * blockDim.x + threadIdx.x; v < total_vec;
       v += gridDim.x * blockDim.x) {
    const unsigned e = v * V;
    const unsigned c = e % C;
    float xv[V], gv[V], sc[V], sh[V], mu[V], iv[V], c0[V], c1[V], out[V];
    Io<T, V>::load(x + e, xv);
    Io<T, V>::load(g + e, gv);
    load_ch<V>(scale + c, sc);
    load_ch<V>(shift + c, sh);
    load_ch<V>(mean + c, mu);
    load_ch<V>(inv + c, iv);
    load_ch<V>(corr + c, c0);
    load_ch<V>(corr + C + c, c1);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float z = __fadd_rn(__fmul_rn(xv[k], sc[k]), sh[k]);
      const float dz = __fmul_rn(gv[k], act_grad<A>(z));
      const float xhat = __fmul_rn(__fsub_rn(xv[k], mu[k]), iv[k]);
      const float t = __fsub_rn(__fsub_rn(dz, c0[k]), __fmul_rn(xhat, c1[k]));
      out[k] = __fmul_rn(sc[k], t);
    }
    Io<T, V>::store(dx + e, out);
  }
}

// ------------------------------------------------------------- launchers

inline unsigned elementwise_blocks(unsigned total_vec) {
  const unsigned b = (total_vec + kThreads - 1) / kThreads;
  return b < (unsigned)kMaxBlocks ? b : (unsigned)kMaxBlocks;
}

template <typename T, int V>
int launch_act(int act, const void* x, const void* scale, const void* shift,
               void* y, unsigned total_vec, unsigned C, cudaStream_t s) {
  const unsigned blocks = elementwise_blocks(total_vec);
#define DL4J_ACT_CASE(A)                                                    \
  case A:                                                                   \
    bn_act_kernel<T, A, V><<<blocks, kThreads, 0, s>>>(                     \
        static_cast<const T*>(x), static_cast<const float*>(scale),         \
        static_cast<const float*>(shift), static_cast<T*>(y), total_vec, C); \
    break;
  switch (act) {
    DL4J_ACT_CASE(kIdentity)
    DL4J_ACT_CASE(kRelu)
    DL4J_ACT_CASE(kRelu6)
    DL4J_ACT_CASE(kSigmoid)
    DL4J_ACT_CASE(kTanh)
    DL4J_ACT_CASE(kSwish)
    DL4J_ACT_CASE(kLeakyRelu)
    DL4J_ACT_CASE(kElu)
    DL4J_ACT_CASE(kGelu)
    DL4J_ACT_CASE(kSoftplus)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DL4J_ACT_CASE
  return (int)cudaGetLastError();
}

// the reduction's launch: (G, channel tiles) blocks of tcv * R threads;
// the finish (2W floats for each of P <= blockDim / S groups) fits in the
// [R][tcv][2][V] floats of the block's own sums
template <typename T, int MODE, int A, int V>
int launch_reduce_one(const void* x, const void* g, const float* p0,
                      const float* p1, const float* p2, const float* p3,
                      float* partial, float* out, int* counters, int N, int C,
                      int tcv, int rows_per_chunk, int G, float eps,
                      cudaStream_t s) {
  const int R = kThreads / tcv;
  const int threads = tcv * R;
  const int cv = C / V;
  const dim3 grid(G, (cv + tcv - 1) / tcv);
  const size_t smem = (size_t)threads * 2 * V * sizeof(float);
  bn_reduce_kernel<T, MODE, A, V><<<grid, threads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), p0, p1, p2, p3,
      partial, out, counters, N, C, tcv, rows_per_chunk, eps);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_bwd_reduce(int act, const void* x, const void* g,
                      const float* scale, const float* shift,
                      const float* mean, const float* inv, float* partial,
                      float* out, int* counters, int N, int C, int tcv,
                      int rows_per_chunk, int G, cudaStream_t s) {
#define DL4J_RED_CASE(A)                                                    \
  case A:                                                                   \
    return launch_reduce_one<T, 1, A, V>(x, g, scale, shift, mean, inv,     \
                                         partial, out, counters, N, C, tcv, \
                                         rows_per_chunk, G, 0.0f, s);
  switch (act) {
    DL4J_RED_CASE(kIdentity)
    DL4J_RED_CASE(kRelu)
    DL4J_RED_CASE(kRelu6)
    DL4J_RED_CASE(kSigmoid)
    DL4J_RED_CASE(kTanh)
    DL4J_RED_CASE(kLeakyRelu)
    DL4J_RED_CASE(kSoftplus)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DL4J_RED_CASE
}

template <typename T, int V>
int launch_dx(int act, const void* x, const void* g, const void* scale,
              const void* shift, const void* mean, const void* inv,
              const void* corr, void* dx, unsigned total_vec, unsigned C,
              cudaStream_t s) {
  const unsigned blocks = elementwise_blocks(total_vec);
#define DL4J_DX_CASE(A)                                                     \
  case A:                                                                   \
    bn_dx_kernel<T, A, V><<<blocks, kThreads, 0, s>>>(                      \
        static_cast<const T*>(x), static_cast<const T*>(g),                 \
        static_cast<const float*>(scale), static_cast<const float*>(shift), \
        static_cast<const float*>(mean), static_cast<const float*>(inv),    \
        static_cast<const float*>(corr), static_cast<T*>(dx), total_vec, C); \
    break;
  switch (act) {
    DL4J_DX_CASE(kIdentity)
    DL4J_DX_CASE(kRelu)
    DL4J_DX_CASE(kRelu6)
    DL4J_DX_CASE(kSigmoid)
    DL4J_DX_CASE(kTanh)
    DL4J_DX_CASE(kLeakyRelu)
    DL4J_DX_CASE(kSoftplus)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DL4J_DX_CASE
  return (int)cudaGetLastError();
}

bool bad_shape(int N, int C, int vec, int dtype) {
  if (N < 1 || C < 1 || (dtype != 0 && dtype != 1)) return true;
  if ((long long)N * C > 0x7fffffffLL) return true;
  return vec && C % (dtype == 0 ? 4 : 8) != 0;
}

}  // namespace

// All (N, C) arrays are contiguous rows of x's dtype (0 = float32,
// 1 = bfloat16); per-channel arrays are contiguous f32. vec = 1 selects
// the 16-byte access (C a multiple of 8 for bf16 / 4 for f32, every (N, C)
// pointer 16-byte aligned). act: the index of fused_ops._ACTS. Each
// returns cudaGetLastError() after its launches.

extern "C" int dl4j_bn_act(const void* x, const void* scale, const void* shift,
                           void* y, int N, int C, int act, int dtype, int vec,
                           void* stream) {
  if (bad_shape(N, C, vec, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned total = (unsigned)N * (unsigned)C;
  if (dtype == 0)
    return vec ? launch_act<float, 4>(act, x, scale, shift, y, total / 4, C, s)
               : launch_act<float, 1>(act, x, scale, shift, y, total, C, s);
  return vec ? launch_act<__nv_bfloat16, 8>(act, x, scale, shift, y, total / 8,
                                            C, s)
             : launch_act<__nv_bfloat16, 1>(act, x, scale, shift, y, total, C,
                                            s);
}

// partial: (G, 2, C) f32 workspace; counters: int32, one per channel
// tile, zero on entry and left zero; center, gamma, beta: (C,) f32;
// out: (7, C) f32 = [sum d; sum d*d; mean; var; inv; scale; shift].
extern "C" int dl4j_bn_stats(const void* x, const void* center,
                             const void* gamma, const void* beta,
                             void* partial, void* out, void* counters, int N,
                             int C, int dtype, int vec, int tcv,
                             int rows_per_chunk, int G, float eps,
                             void* stream) {
  if (bad_shape(N, C, vec, dtype) || tcv < 1 || tcv > kThreads || G < 1 ||
      rows_per_chunk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *c = static_cast<const float*>(center),
              *ga = static_cast<const float*>(gamma),
              *be = static_cast<const float*>(beta);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  int* k = static_cast<int*>(counters);
  if (dtype == 0)
    return vec ? launch_reduce_one<float, 0, 0, 4>(x, x, c, ga, be, c, p, o,
                                                   k, N, C, tcv,
                                                   rows_per_chunk, G, eps, s)
               : launch_reduce_one<float, 0, 0, 1>(x, x, c, ga, be, c, p, o,
                                                   k, N, C, tcv,
                                                   rows_per_chunk, G, eps, s);
  return vec ? launch_reduce_one<__nv_bfloat16, 0, 0, 8>(
                   x, x, c, ga, be, c, p, o, k, N, C, tcv, rows_per_chunk, G,
                   eps, s)
             : launch_reduce_one<__nv_bfloat16, 0, 0, 1>(
                   x, x, c, ga, be, c, p, o, k, N, C, tcv, rows_per_chunk, G,
                   eps, s);
}

// As above; out: (4, C) f32 = [sum dz; sum dz*xhat; sum dz / N;
// sum dz*xhat / N].
extern "C" int dl4j_bn_bwd_reduce(const void* x, const void* g,
                                  const void* scale, const void* shift,
                                  const void* mean, const void* inv,
                                  void* partial, void* out, void* counters,
                                  int N, int C, int act, int dtype, int vec,
                                  int tcv, int rows_per_chunk, int G,
                                  void* stream) {
  if (bad_shape(N, C, vec, dtype) || tcv < 1 || tcv > kThreads || G < 1 ||
      rows_per_chunk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *sc = static_cast<const float*>(scale),
              *sh = static_cast<const float*>(shift),
              *mu = static_cast<const float*>(mean),
              *iv = static_cast<const float*>(inv);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  int* k = static_cast<int*>(counters);
  if (dtype == 0)
    return vec ? launch_bwd_reduce<float, 4>(act, x, g, sc, sh, mu, iv, p, o,
                                             k, N, C, tcv, rows_per_chunk, G,
                                             s)
               : launch_bwd_reduce<float, 1>(act, x, g, sc, sh, mu, iv, p, o,
                                             k, N, C, tcv, rows_per_chunk, G,
                                             s);
  return vec ? launch_bwd_reduce<__nv_bfloat16, 8>(act, x, g, sc, sh, mu, iv,
                                                   p, o, k, N, C, tcv,
                                                   rows_per_chunk, G, s)
             : launch_bwd_reduce<__nv_bfloat16, 1>(act, x, g, sc, sh, mu, iv,
                                                   p, o, k, N, C, tcv,
                                                   rows_per_chunk, G, s);
}

// corr: (2, C) f32 = [sum dz; sum dz*xhat] / N.
extern "C" int dl4j_bn_bwd_dx(const void* x, const void* g, const void* scale,
                              const void* shift, const void* mean,
                              const void* inv, const void* corr, void* dx,
                              int N, int C, int act, int dtype, int vec,
                              void* stream) {
  if (bad_shape(N, C, vec, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned total = (unsigned)N * (unsigned)C;
  if (dtype == 0)
    return vec ? launch_dx<float, 4>(act, x, g, scale, shift, mean, inv, corr,
                                     dx, total / 4, C, s)
               : launch_dx<float, 1>(act, x, g, scale, shift, mean, inv, corr,
                                     dx, total, C, s);
  return vec ? launch_dx<__nv_bfloat16, 8>(act, x, g, scale, shift, mean, inv,
                                           corr, dx, total / 8, C, s)
             : launch_dx<__nv_bfloat16, 1>(act, x, g, scale, shift, mean, inv,
                                           corr, dx, total, C, s);
}
