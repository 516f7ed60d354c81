// Fused whole-sequence LSTM forward (K4) for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel body `_lstm_kernel` of deeplearning4j_tpu/
// kernels/fused_lstm.py (run by `_lstm_pallas`): given the hoisted input
// projection xproj (B, T, 4H) = x @ W + b, the recurrent weights rw
// (H, 4H), the peepholes peep (3, H) f32 = [pI; pF; pO] and the initial
// state h0, c0 (B, H) f32, it writes hs (B, T, H) in xproj's dtype:
//
//   z  = xproj_t + round(h_{t-1}) @ rw           (f32 accumulation)
//   i  = sigmoid(z_i + c_{t-1} * pI)    f = sigmoid(z_f + c_{t-1} * pF)
//   g  = tanh(z_g)                      c_t = f * c_{t-1} + i * g
//   o  = sigmoid(z_o + c_t * pO)        h_t = o * tanh(c_t)
//
// with gate order [i, f, o, g] and round() to rw's dtype, as the TPU
// kernel feeds its matrix unit. The state stays f32 across all T steps;
// only the output is rounded. h enters the next step only through the
// product, so the kernel keeps it as round(h).
//
// What bounds it on the card. The roofline of one call at the char-RNN
// shape (B 256, T 60, H 256, bf16): ~40 MB moved (xproj in, hs out, rw,
// the state) is 0.012 ms over 3.35 TB/s, and the recurrent products,
// 2*B*H*4H*T = 8.05 GFLOP, 0.008 ms at the bf16 tensor-core peak. Neither
// is the real limit: the T steps form a chain, each step needs the whole
// of rw (512 KiB in bf16 at H 256), and rw does not fit one SM's 227 KB
// of shared memory, where the TPU kernel kept it resident in VMEM.
//
// Design. Batch rows are independent, so a block owns a tile of R batch
// rows and walks t in a loop inside the kernel: no synchronisation
// between blocks and no atomics. Per step the block computes z for its R
// rows and all 4H columns: a thread takes 4 adjacent columns (one 8- or
// 16-byte load of an rw row, neighbouring threads on neighbouring
// columns) and a slice of the K = H reduction; the KS slices' partial
// sums meet in shared memory, and the cell update adds them in a fixed
// order and applies the gates per hidden unit. rw is re-read from L2 at
// every step (it stays there: 0.5-1 MiB against 50 MB). The split of K
// over KS slices puts up to 1024 threads on an SM to keep enough of those
// L2 reads in flight. FMAs run on the CUDA cores in f32; the tensor
// cores, and rw split over a cluster's shared memory, are the way to a
// faster kernel. Two launches on the same input give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 4;  // adjacent gate columns per thread

// sigmoid without overflow for large |z|: exp of a non-positive argument
__device__ __forceinline__ float sigmoid_(float z) {
  if (z >= 0.0f) return 1.0f / (1.0f + expf(-z));
  const float e = expf(z);
  return e / (1.0f + e);
}

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ void load4(const float* p, float* o) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                               float* o) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.y));
    o[0] = a.x;
    o[1] = a.y;
    o[2] = b.x;
    o[3] = b.y;
  }
  // round to nearest even, as an f32 -> bf16 cast does in XLA and PyTorch
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
};

// Shared memory, f32: part (KS, R, 4H) partial sums of z; hr (R, H) the
// rounded h; c (R, H) the cell state; p (3, H) the peepholes.
// Thread tid takes column group tid % GP (and every GP-th after it) and
// K slice tid / GP; blockDim.x == GP * KS.
template <typename T, int R>
__global__ void __launch_bounds__(1024) lstm_seq_kernel(const T* __restrict__ xproj,
                                const T* __restrict__ rw,
                                const float* __restrict__ peep,
                                const float* __restrict__ h0,
                                const float* __restrict__ c0,
                                T* __restrict__ out, int B, int Tn, int H,
                                int GP, int KS) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* part = smem;
  float* hr = part + (size_t)KS * R * G;
  float* cs = hr + R * H;
  float* ps = cs + R * H;
  const int b0 = blockIdx.x * R;
  const int rows = min(R, B - b0);
  const int tid = threadIdx.x;
  const int gi = tid % GP;
  const int slice = tid / GP;
  const int kchunk = (H + KS - 1) / KS;
  const int k_lo = min(H, slice * kchunk);
  const int k_hi = min(H, k_lo + kchunk);

  for (int i = tid; i < R * H; i += blockDim.x) {
    const int r = i / H;
    float h = 0.0f, c = 0.0f;
    if (r < rows) {
      const size_t at = (size_t)(b0 + r) * H + (i - r * H);
      h = h0[at];
      c = c0[at];
    }
    hr[i] = Io<T>::round(h);  // rows past B stay 0 and are never written
    cs[i] = c;
  }
  for (int i = tid; i < 3 * H; i += blockDim.x) ps[i] = peep[i];
  __syncthreads();

  for (int t = 0; t < Tn; ++t) {
    // partial z of this thread's K slice; slice 0 starts from xproj_t
    for (int g = gi; g < H; g += GP) {
      const int col = g * kCols;
      float acc[R][kCols];
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[r][j] = 0.0f;
        if (slice == 0 && r < rows)
          Io<T>::load4(xproj + ((size_t)(b0 + r) * Tn + t) * G + col,
                       acc[r]);
      }
      const T* w = rw + col;
#pragma unroll 4
      for (int k = k_lo; k < k_hi; ++k) {
        float wv[kCols];
        Io<T>::load4(w + (size_t)k * G, wv);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float hk = hr[r * H + k];
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[r][j] = fmaf(hk, wv[j], acc[r][j]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float* dst = part + ((size_t)slice * R + r) * G + col;
#pragma unroll
        for (int j = 0; j < kCols; ++j) dst[j] = acc[r][j];
      }
    }
    __syncthreads();

    // the cell update, one hidden unit of one row per thread
    for (int i = tid; i < rows * H; i += blockDim.x) {
      const int r = i / H;
      const int j = i - r * H;
      float z[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float s = 0.0f;
        for (int sl = 0; sl < KS; ++sl)
          s += part[((size_t)sl * R + r) * G + q * H + j];
        z[q] = s;
      }
      const float c = cs[i];
      const float ig = sigmoid_(z[0] + c * ps[j]);
      const float fg = sigmoid_(z[1] + c * ps[H + j]);
      const float gg = tanhf(z[3]);
      const float cn = fg * c + ig * gg;
      const float og = sigmoid_(z[2] + cn * ps[2 * H + j]);
      const float hn = og * tanhf(cn);
      cs[i] = cn;
      hr[i] = Io<T>::round(hn);
      Io<T>::store(out + ((size_t)(b0 + r) * Tn + t) * H + j, hn);
    }
    __syncthreads();
  }
}

template <typename T, int R>
int launch(const void* xproj, const void* rw, const void* peep,
           const void* h0, const void* c0, void* out, int B, int Tn, int H,
           int threads, int KS, int smem, cudaStream_t s) {
  auto kernel = lstm_seq_kernel<T, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + R - 1) / R;
  kernel<<<blocks, threads, smem, s>>>(
      static_cast<const T*>(xproj), static_cast<const T*>(rw),
      static_cast<const float*>(peep), static_cast<const float*>(h0),
      static_cast<const float*>(c0), static_cast<T*>(out), B, Tn, H,
      threads / KS, KS);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rows(int rows, const void* xproj, const void* rw, const void* peep,
                const void* h0, const void* c0, void* out, int B, int Tn,
                int H, int threads, int KS, int smem, cudaStream_t s) {
  switch (rows) {
    case 1:
      return launch<T, 1>(xproj, rw, peep, h0, c0, out, B, Tn, H, threads, KS,
                          smem, s);
    case 2:
      return launch<T, 2>(xproj, rw, peep, h0, c0, out, B, Tn, H, threads, KS,
                          smem, s);
    case 4:
      return launch<T, 4>(xproj, rw, peep, h0, c0, out, B, Tn, H, threads, KS,
                          smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// xproj (B, T, 4H) and rw (H, 4H) of `dtype` (0 f32, 1 bf16), 16-byte
// aligned; peep (3, H), h0 and c0 (B, H) f32; out (B, T, H) of `dtype`.
// `rows` batch rows per block (1, 2 or 4), `threads` = column groups per
// K slice times `k_slices`, `smem` bytes of dynamic shared memory, as
// kernels/fused_lstm.py's lstm_plan sizes them.
extern "C" int dl4j_lstm_seq(const void* xproj, const void* rw,
                             const void* peep, const void* h0, const void* c0,
                             void* out, int B, int Tn, int H, int dtype,
                             int rows, int k_slices, int threads, int smem,
                             void* stream) {
  if (B < 1 || Tn < 1 || H < 1 || k_slices < 1 || threads < k_slices ||
      threads > 1024 || threads % k_slices != 0 || smem < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_rows<float>(rows, xproj, rw, peep, h0, c0, out, B, Tn, H,
                              threads, k_slices, smem, s);
  if (dtype == 1)
    return launch_rows<__nv_bfloat16>(rows, xproj, rw, peep, h0, c0, out, B,
                                      Tn, H, threads, k_slices, smem, s);
  return (int)cudaErrorInvalidValue;
}
