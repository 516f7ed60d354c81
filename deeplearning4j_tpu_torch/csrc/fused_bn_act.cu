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
// reduction runs in two launches and uses no atomics: block (g, t) of
// bn_reduce_kernel sums rows [g*rows_per_chunk, (g+1)*rows_per_chunk) of
// channel tile t into a partial (G, 2, C) workspace, each thread over a
// fixed stride of rows, then the block's row lanes in a fixed order; and
// bn_finish_kernel sums the G partials of each channel in a fixed order.
// The plan (tile width, rows per chunk, G) depends only on N, C and the
// load width, so two launches on the same input give bit-identical sums.
// This first version leaves the finish pass serial over G within a
// thread group; it reads G*2*C floats that sit in L2.

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
  if (A == kSwish) return z * sigmoidf_(z);
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

// Partial per-channel sums of one (row chunk, channel tile).
// MODE 0 (stats):    p0 = center;                 sums d, d*d.
// MODE 1 (backward): p0 = scale, p1 = shift,
//                    p2 = mean, p3 = inv, g = dy; sums dz, dz*xhat.
// blockDim = tcv * R: thread t owns channel vector t % tcv of the tile and
// rows r0 + t / tcv, r0 + t / tcv + R, ...
template <typename T, int MODE, int A, int V>
__global__ void __launch_bounds__(kThreads)
bn_reduce_kernel(const T* __restrict__ x, const T* __restrict__ g,
                 const float* __restrict__ p0, const float* __restrict__ p1,
                 const float* __restrict__ p2, const float* __restrict__ p3,
                 float* __restrict__ partial, int N, int C, int tcv,
                 int rows_per_chunk) {
  extern __shared__ float sm[];  // [R][tcv][2][V]
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
}

// out[w, c] = sum over g of partial[g, w, c], g in a fixed order: lane
// (threadIdx.x) picks the (w, c) slot, row j of the block sums g = j,
// j + 8, ..., then the 8 rows add in order.
__global__ void __launch_bounds__(kThreads)
bn_finish_kernel(const float* __restrict__ partial, float* __restrict__ out,
                 int G, int C) {
  __shared__ float sm[8][32];
  const int slot = blockIdx.x * 32 + threadIdx.x;
  const int j = threadIdx.y;
  float acc = 0.0f;
  if (slot < 2 * C) {
    const int which = slot / C, c = slot % C;
#pragma unroll 4
    for (int gi = j; gi < G; gi += 8)
      acc = __fadd_rn(acc, partial[((long long)gi * 2 + which) * C + c]);
  }
  sm[j][threadIdx.x] = acc;
  __syncthreads();
  if (j == 0 && slot < 2 * C) {
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < 8; ++q) s = __fadd_rn(s, sm[q][threadIdx.x]);
    out[slot] = s;
  }
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

template <typename T, int MODE, int A, int V>
void launch_reduce_one(const void* x, const void* g, const float* p0,
                       const float* p1, const float* p2, const float* p3,
                       float* partial, int N, int C, int tcv,
                       int rows_per_chunk, int G, cudaStream_t s) {
  const int R = kThreads / tcv;
  const int threads = tcv * R;
  const int cv = C / V;
  const dim3 grid(G, (cv + tcv - 1) / tcv);
  const size_t smem = (size_t)threads * 2 * V * sizeof(float);
  bn_reduce_kernel<T, MODE, A, V><<<grid, threads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), p0, p1, p2, p3,
      partial, N, C, tcv, rows_per_chunk);
}

int launch_finish(const float* partial, float* out, int G, int C,
                  cudaStream_t s) {
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  bn_finish_kernel<<<(2 * C + 31) / 32, dim3(32, 8), 0, s>>>(partial, out,
                                                              G, C);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_bwd_reduce(int act, const void* x, const void* g,
                      const float* scale, const float* shift,
                      const float* mean, const float* inv, float* partial,
                      int N, int C, int tcv, int rows_per_chunk, int G,
                      cudaStream_t s) {
#define DL4J_RED_CASE(A)                                                    \
  case A:                                                                   \
    launch_reduce_one<T, 1, A, V>(x, g, scale, shift, mean, inv, partial, N, \
                                  C, tcv, rows_per_chunk, G, s);            \
    break;
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
  return 0;
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

// partial: (G, 2, C) f32 workspace; out: (2, C) f32 = [sum d; sum d*d].
extern "C" int dl4j_bn_stats(const void* x, const void* center, void* partial,
                             void* out, int N, int C, int dtype, int vec,
                             int tcv, int rows_per_chunk, int G,
                             void* stream) {
  if (bad_shape(N, C, vec, dtype) || tcv < 1 || tcv > kThreads || G < 1 ||
      rows_per_chunk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(center);
  float* p = static_cast<float*>(partial);
  if (dtype == 0) {
    if (vec)
      launch_reduce_one<float, 0, 0, 4>(x, x, c, c, c, c, p, N, C, tcv,
                                        rows_per_chunk, G, s);
    else
      launch_reduce_one<float, 0, 0, 1>(x, x, c, c, c, c, p, N, C, tcv,
                                        rows_per_chunk, G, s);
  } else {
    if (vec)
      launch_reduce_one<__nv_bfloat16, 0, 0, 8>(x, x, c, c, c, c, p, N, C, tcv,
                                                rows_per_chunk, G, s);
    else
      launch_reduce_one<__nv_bfloat16, 0, 0, 1>(x, x, c, c, c, c, p, N, C, tcv,
                                                rows_per_chunk, G, s);
  }
  return launch_finish(p, static_cast<float*>(out), G, C, s);
}

// out: (2, C) f32 = [sum dz; sum dz*xhat].
extern "C" int dl4j_bn_bwd_reduce(const void* x, const void* g,
                                  const void* scale, const void* shift,
                                  const void* mean, const void* inv,
                                  void* partial, void* out, int N, int C,
                                  int act, int dtype, int vec, int tcv,
                                  int rows_per_chunk, int G, void* stream) {
  if (bad_shape(N, C, vec, dtype) || tcv < 1 || tcv > kThreads || G < 1 ||
      rows_per_chunk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *sc = static_cast<const float*>(scale),
              *sh = static_cast<const float*>(shift),
              *mu = static_cast<const float*>(mean),
              *iv = static_cast<const float*>(inv);
  float* p = static_cast<float*>(partial);
  int rc;
  if (dtype == 0)
    rc = vec ? launch_bwd_reduce<float, 4>(act, x, g, sc, sh, mu, iv, p, N, C,
                                           tcv, rows_per_chunk, G, s)
             : launch_bwd_reduce<float, 1>(act, x, g, sc, sh, mu, iv, p, N, C,
                                           tcv, rows_per_chunk, G, s);
  else
    rc = vec ? launch_bwd_reduce<__nv_bfloat16, 8>(act, x, g, sc, sh, mu, iv,
                                                   p, N, C, tcv,
                                                   rows_per_chunk, G, s)
             : launch_bwd_reduce<__nv_bfloat16, 1>(act, x, g, sc, sh, mu, iv,
                                                   p, N, C, tcv,
                                                   rows_per_chunk, G, s);
  if (rc != 0) return rc;
  return launch_finish(p, static_cast<float*>(out), G, C, s);
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
