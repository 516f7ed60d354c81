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
// product, so the kernels keep it as round(h).
//
// What bounds it on the card. The roofline of one call at the char-RNN
// shape (B 256, T 60, H 256, bf16): ~40 MB moved (xproj in, hs out, rw,
// the state) is 0.012 ms over 3.35 TB/s, and the recurrent products,
// 2*B*H*4H*T = 8.05 GFLOP, 0.008 ms at the bf16 tensor-core peak. Neither
// is the real limit: the T steps form a chain, each step needs the whole
// of rw (512 KiB in bf16 at H 256), and rw does not fit one SM's 227 KB
// of shared memory, where the TPU kernel kept it resident in VMEM.
//
// Two routes, chosen by shape in kernels/fused_lstm.py (`lstm_route`):
//
// The cluster route (lstm_seq_cluster_mma_kernel in bf16,
// lstm_seq_cluster_ffma_kernel in f32) keeps rw resident across a thread
// block cluster. A cluster of C CTAs (C <= 8, the portable maximum) owns
// 16 batch rows; CTA k owns the hidden units [k*H/C, (k+1)*H/C) and the
// four gate columns of each, copies that slice of rw into its shared
// memory once (cp.async in bf16), and walks t in a loop. Holding all four
// gates of its units keeps the cell update local: c never leaves the CTA.
// Each step every CTA needs the whole of round(h_{t-1}) for the product,
// so it sends its new slice of h into the next buffer of a double-
// buffered h in every CTA's shared memory (DSMEM, st.async in 16-byte
// pieces), each piece counted off that CTA's mbarrier for the buffer
// (complete_tx); a CTA waits on its own mbarrier before the next
// product. That is the step's only synchronisation: no cluster-wide
// barrier, whose release would also drain the step's global loads and
// stores. rw is read from device memory once per CTA per call, not once
// a step (8 MiB of L2 reads at the char-RNN shape against ~4 GB).
//
// In bf16 the product runs on the tensor cores: mma.sync m16n8k16 with
// f32 accumulation, M = the 16 rows. A group of two warps owns 8 hidden
// units; the two split the H/16 k steps, so each warp's four n-tiles are
// the four gates of its units, and each updates the cells of 8 of the 16
// rows in registers after adding the other warp's partial sums (one CTA
// barrier a step). Its sigmoid and tanh use __expf and an approximate
// division. In f32 the product runs FFMA from shared memory in a fixed
// order (TF32 would miss atol 1e-5), exact transcendentals. xproj is
// loaded into registers two steps ahead. At B 256 the bf16 grid (16
// clusters of 8) is resident at once; the f32 one needs 198 KiB a CTA,
// one CTA an SM, and its 16 clusters run in two waves (15 resident).
// What is left a step is a short dependent chain: the product, the cell
// update and the exchange's latency.
//
// The block route (lstm_seq_kernel) takes every other shape the block
// plan fits (H/C never a multiple of 8, or an rw slice too large for a
// CTA). Batch rows are independent, so a block owns a tile of R batch
// rows and walks t in a loop inside the kernel: no synchronisation
// between blocks and no atomics. Per step the block computes z for its R
// rows and all 4H columns: a thread takes 4 adjacent columns (one 8- or
// 16-byte load of an rw row, neighbouring threads on neighbouring
// columns) and a slice of the K = H reduction; the KS slices' partial
// sums meet in shared memory, and the cell update adds them in a fixed
// order and applies the gates per hidden unit. rw is re-read from L2 at
// every step (it stays there: 0.5-1 MiB against 50 MB), which bounds it:
// at the char-RNN shape ~4 GB of L2 reads a call. FMAs run on the CUDA
// cores in f32.
//
// Both routes use no atomics and a fixed order of every sum: two
// launches on the same input give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

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

// ------------------------------------------------------- the cluster route

constexpr int kClusterRows = 16;     // batch rows a cluster owns (mma M)
constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr int kMmaThreads = 768;     // most threads a bf16 CTA runs
constexpr int kFfmaThreads = 256;    // most threads an f32 CTA runs

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}

// the shared::cluster address of shared offset `addr` in CTA `rank`
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// an asynchronous 16-byte store (addr 16-byte aligned) into a peer's
// shared memory that, once it lands, counts its bytes off the peer's
// mbarrier `bar` (complete_tx)
__device__ __forceinline__ void st_async(uint32_t addr, uint4 v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

// the 16 bytes of a lane quad (4 bytes a lane, lane order), in every lane
// of the quad
__device__ __forceinline__ uint4 quad_gather(uint32_t v) {
  const int base = (threadIdx.x & 31) & ~3;
  return make_uint4(__shfl_sync(0xffffffffu, v, base),
                    __shfl_sync(0xffffffffu, v, base + 1),
                    __shfl_sync(0xffffffffu, v, base + 2),
                    __shfl_sync(0xffffffffu, v, base + 3));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// arrive once and expect `bytes` more of complete_tx in this phase
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// until the phase of parity `parity` has completed; acquire at cluster
// scope, so that the peers' stores it counted are visible
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], "
      "%1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// every thread of the cluster meets here (once at the start, once at the
// end of a call: the steps meet at mbarriers)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a (16x16, row-major) * b (16x8, col-major), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// sigmoid and tanh of the cell update: exact (expf, tanhf) for f32, held
// to 1e-5; in bf16 from __expf and an approximate division (a few f32
// ulps, far under the bf16 output's rounding), whose MUFU instructions
// keep the step's dependent chain short
template <bool kFast>
__device__ __forceinline__ float sigm(float z) {
  if constexpr (kFast)
    return __fdividef(1.0f, 1.0f + __expf(-z));
  else
    return sigmoid_(z);
}

template <bool kFast>
__device__ __forceinline__ float tanh_(float x) {
  if constexpr (kFast)
    return 2.0f * sigm<true>(2.0f * x) - 1.0f;
  else
    return tanhf(x);
}

// the cell update of one (row, unit): z[q] the gate pre-activations
// without the peepholes, c the cell state in and out; returns h_t
template <bool kFast>
__device__ __forceinline__ float cell(const float* z, float& c, float pi,
                                      float pf, float po) {
  const float ig = sigm<kFast>(z[0] + c * pi);
  const float fg = sigm<kFast>(z[1] + c * pf);
  const float gg = tanh_<kFast>(z[3]);
  const float cn = fg * c + ig * gg;
  const float og = sigm<kFast>(z[2] + cn * po);
  c = cn;
  return og * tanh_<kFast>(cn);
}

// Shared memory of a bf16 CTA, in bytes (kernels/fused_lstm.py
// cluster_smem mirrors it): w (Kp, 4U + 8) bf16, this CTA's rw columns
// gate-major (column q*U + u is rw's column q*H + rank*U + u), rows
// k >= H zero; h (2, 16, Kp + 8) bf16, round(h) of the cluster's rows,
// double-buffered; part (U/8, 2, 8, 32) f32, each warp's partial sums
// of the other warp's rows. Rows of w and h are padded by 16 bytes so
// that ldmatrix's eight row addresses fall in distinct banks. Kp = H
// rounded up to 16.
constexpr int mma_smem(int H, int C) {
  return 2 * (((H + 15) / 16 * 16) * (4 * (H / C) + 8) +
              2 * kClusterRows * ((H + 15) / 16 * 16 + 8)) +
         256 * (H / C);
}

// The exchange of one step. Step t reads round(h_{t-1}) from buffer t % 2
// and sends its slice of round(h_t) into buffer (t + 1) % 2 of every CTA
// with st.async; mbarrier b of each CTA completes a phase when all the
// slices of the h bound for buffer b have landed (bf16: all C, 32H
// bytes, its own too; f32: the C - 1 others', 64U(C - 1) bytes, its own
// written in place before a CTA barrier; every row, the zero rows past B
// too). A CTA sends h_t only
// after its product has read buffer t % 2, and a peer can send h_{t+1}
// into that buffer only after it has h_t from every CTA, so one wait a
// step orders both the data and the reuse of the buffers. The last step
// sends nothing.
struct Exchange {
  uint32_t bar[2];  // this CTA's mbarriers, shared addresses

  __device__ void init(uint64_t* bars) {
    bar[0] = smem_addr(bars);
    bar[1] = smem_addr(bars + 1);
    if (threadIdx.x == 0) {
      mbar_init(bar[0], 1);
      mbar_init(bar[1], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  // before step t (> 0): round(h_{t-1}), sent at step t - 1, has landed
  __device__ void wait(int t) const {
    if (t > 0) mbar_wait(bar[t & 1], ((t - 1) >> 1) & 1);
  }
  // at step t: one arrival that expects the phase's bytes
  __device__ void expect(int t, uint32_t bytes) const {
    if (threadIdx.x == 0) mbar_expect(bar[(t + 1) & 1], bytes);
  }
};

// bf16. blockDim.x = 64 * U / 8. The U / 8 warp groups own 8 units each;
// a group's two warps (kw 0, 1) split the Kp / 16 k steps. Each warp's
// four n-tiles of 8 columns are its units' i, f, o and g columns, so
// lane l's accumulators hold all four gates of rows l/4 and l/4 + 8 at
// units 8 * group + 2(l%4) and the one after. Warp kw updates the cells
// of rows l/4 + 8kw, adding the other warp's partial sums for them from
// shared memory.
__global__ void __launch_bounds__(kMmaThreads) lstm_seq_cluster_mma_kernel(
    const __nv_bfloat16* __restrict__ xproj,
    const __nv_bfloat16* __restrict__ rw, const float* __restrict__ peep,
    const float* __restrict__ h0, const float* __restrict__ c0,
    __nv_bfloat16* __restrict__ out, int B, int Tn, int H, int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t bars[2];
  const int U = H / C, G = 4 * H;
  const int Kp = (H + 15) / 16 * 16;
  const int WS = 4 * U + 8, HS = Kp + 8;  // row strides, elements
  __nv_bfloat16* w = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* hb = w + (size_t)Kp * WS;
  float* part = reinterpret_cast<float*>(hb + 2 * kClusterRows * HS);
  const int col0 = (int)cluster_ctarank() * U;  // this CTA's first unit
  const int b0 = (int)cluster_id() * kClusterRows;
  const int rows = min(kClusterRows, B - b0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int groups = U / 8, grp = warp % groups, kw = warp / groups;
  Exchange ex;
  ex.init(bars);

  // the rw slice, once, with cp.async: 16-byte chunks of 8 units of one
  // gate; rows k >= H zero-filled
  const int chunks = U / 8;
  const uint32_t w_s = smem_addr(w);
  for (int i = tid; i < Kp * 4 * chunks; i += blockDim.x) {
    const int k = i / (4 * chunks);
    const int q = (i / chunks) % 4;
    const int u = (i % chunks) * 8;
    const __nv_bfloat16* src =
        rw + (size_t)min(k, H - 1) * G + q * H + col0 + u;
    cp_async16(w_s + (k * WS + q * U + u) * 2, src, k < H ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  // h: buffer 0 round(h0) of the rows, four units a thread; the rest of
  // both buffers (buffer 1, rows past B, columns past H) zero
  const int quads = HS / 4;
  for (int i = tid; i < 2 * kClusterRows * quads; i += blockDim.x) {
    const int r = (i / quads) % kClusterRows, k = (i % quads) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (i < kClusterRows * quads && r < rows && k < H)
      v = __ldg(reinterpret_cast<const float4*>(h0 + (size_t)(b0 + r) * H +
                                                k));
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 packed;
    packed.x = *reinterpret_cast<const uint32_t*>(&lo);
    packed.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(hb + (size_t)(i / quads) * HS + k) = packed;
  }

  const int g = lane >> 2;                        // rows g and g + 8
  const int j = col0 + grp * 8 + (lane & 3) * 2;  // units j and j + 1
  const int row = g + 8 * kw;  // the row whose cells this lane updates
  // c of this lane's cells: units j and j + 1 of its row
  float pi[2], pf[2], po[2], c[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    pi[e] = peep[j + e];
    pf[e] = peep[H + j + e];
    po[e] = peep[2 * H + j + e];
  }
#pragma unroll
  for (int e = 0; e < 2; ++e)
    c[e] = row < rows ? c0[(size_t)(b0 + row) * H + j + e] : 0.0f;
  // xproj of this lane's row, two steps ahead: per gate, units j, j + 1
  uint32_t x1[4], x2[4];
  auto load_x = [&](uint32_t(&xn)[4], int t) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      xn[q] = row < rows && t < Tn
                  ? __ldg(reinterpret_cast<const unsigned int*>(
                        xproj + ((size_t)(b0 + row) * Tn + t) * G + q * H +
                        j))
                  : 0u;
  };
  load_x(x1, 0);
  load_x(x2, 1);

  // ldmatrix row addresses: lane l gives row l % 8 of matrix l / 8. A
  // (h): (rows 0-7, k 0-7) (rows 8-15, k 0-7) (rows 0-7, k 8-15) (rows
  // 8-15, k 8-15); B (w, transposed on load), for the gate pairs (0, 1)
  // and (2, 3): (k 0-7, first) (k 8-15, first) (k 0-7, second) (k 8-15,
  // second)
  const int mi = lane >> 3, mr = lane & 7;
  const int nks = Kp / 16, per = (nks + 1) / 2;
  const int ks_lo = kw * per, ks_hi = min(nks, ks_lo + per);
  const uint32_t h_s = smem_addr(hb);
  const uint32_t buf_bytes = kClusterRows * HS * 2;
  const uint32_t a_off =
      (((mi & 1) * 8 + mr) * HS + (mi >> 1) * 8 + ks_lo * 16) * 2;
  const int bk = (mi & 1) * 8 + mr + ks_lo * 16, bn = grp * 8;
  const uint32_t b01 = w_s + (bk * WS + (mi >> 1) * U + bn) * 2;
  const uint32_t b23 = w_s + (bk * WS + (2 + (mi >> 1)) * U + bn) * 2;
  const uint32_t kstep_w = 16 * WS * 2;  // bytes of 16 rows of w
  const int steps = ks_hi - ks_lo;
  // this warp's partial sums of the other warp's rows go to
  // part[grp][kw], its own rows' from the other warp come from
  // part[grp][1 - kw]; (gate, column of the pair) major, lane minor
  float* part_out = part + ((size_t)(grp * 2 + kw) * 8) * 32 + lane;
  const float* part_in = part + ((size_t)(grp * 2 + 1 - kw) * 8) * 32 + lane;

  asm volatile("cp.async.wait_all;" ::: "memory");
  cluster_arrive();  // every CTA of the cluster has started, filled its
  cluster_wait();    // buffers and set up its mbarriers

  for (int t = 0; t < Tn; ++t) {
    const int cur = t & 1;
    float acc[4][4];  // [gate][(row half) * 2 + unit]; xproj on own rows
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&x1[q]));
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        acc[q][2 * hh] = hh == kw ? v.x : 0.0f;
        acc[q][2 * hh + 1] = hh == kw ? v.y : 0.0f;
      }
      x1[q] = x2[q];
    }
    load_x(x2, t + 2);  // in flight for two steps
    ex.wait(t);

    // z += round(h_{t-1}) @ w over this warp's k steps, each step's
    // fragments loaded before the previous step's four mma
    const uint32_t a_base = h_s + cur * buf_bytes + a_off;
    uint32_t fa[4], fb[8];
    ldsm_x4(fa, a_base);
    ldsm_x4_trans(fb, b01);
    ldsm_x4_trans(fb + 4, b23);
    for (int s = 0; s < steps; ++s) {
      const int sn = s + 1 < steps ? s + 1 : s;
      uint32_t na[4], nb[8];
      ldsm_x4(na, a_base + sn * 32);
      ldsm_x4_trans(nb, b01 + sn * kstep_w);
      ldsm_x4_trans(nb + 4, b23 + sn * kstep_w);
      mma_bf16(acc[0], fa, fb);
      mma_bf16(acc[1], fa, fb + 2);
      mma_bf16(acc[2], fa, fb + 4);
      mma_bf16(acc[3], fa, fb + 6);
#pragma unroll
      for (int e = 0; e < 4; ++e) fa[e] = na[e];
#pragma unroll
      for (int e = 0; e < 8; ++e) fb[e] = nb[e];
    }
    // z of this lane's cells: its own sums plus the other warp's
    // (the previous step's readers of part have all sent their h, so
    // passed this step's wait, before any warp writes it again)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        part_out[(q * 2 + e) * 32] = kw == 0 ? acc[q][2 + e] : acc[q][e];
    __syncthreads();
    float z[4][2];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        z[q][e] = (kw == 0 ? acc[q][e] : acc[q][2 + e]) +
                  part_in[(q * 2 + e) * 32];

    // the cell update of this lane's row; rows past B stay zero
    float hn[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float zc[4] = {z[0][e], z[1][e], z[2][e], z[3][e]};
      const float h = cell<true>(zc, c[e], pi[e], pf[e], po[e]);
      hn[e] = row < rows ? h : 0.0f;
    }
    const __nv_bfloat162 hp = __floats2bfloat162_rn(hn[0], hn[1]);
    const uint32_t hv = *reinterpret_cast<const uint32_t*>(&hp);
    // round(h_t) into every CTA's next buffer, then the output
    // (a lane quad's 8 units of a row, 16 bytes, one store a peer; the
    // quad's lanes take the peers in turn)
    if (t + 1 < Tn) {
      ex.expect(t, 32 * H);
      const uint32_t nxt = h_s + (cur ^ 1) * buf_bytes +
                           (row * HS + col0 + grp * 8) * 2;
      const uint32_t bar = ex.bar[cur ^ 1];
      const uint4 quad = quad_gather(hv);
      for (int p = lane & 3; p < C; p += 4)
        st_async(peer_addr(nxt, p), quad, peer_addr(bar, p));
    }
    if (row < rows)
      *reinterpret_cast<uint32_t*>(
          out + ((size_t)(b0 + row) * Tn + t) * H + j) = hv;
  }
  cluster_arrive();  // no CTA leaves while a peer may still address it
  cluster_wait();
}

// Shared memory of an f32 CTA, in bytes (kernels/fused_lstm.py
// cluster_smem mirrors it): w (H, U, 4), each unit's four gate columns
// side by side; h (2, H, 16), round(h) transposed so that a thread's 8
// rows are two float4; part (KS, 16, 4U) the K slices' partial sums;
// c (16, U) the cell state.
constexpr int ffma_smem(int H, int C, int KS) {
  return 4 * (H * 4 * (H / C) + 2 * H * kClusterRows +
              KS * kClusterRows * 4 * (H / C) + kClusterRows * (H / C));
}

// f32. blockDim.x = 2 * U * KS: thread tid takes K slice tid / (2U), the
// rows 8 * ((tid / U) % 2) + [0, 8) and unit tid % U, all four gates (32
// accumulators over k ascending); then the cell update of the pairs
// p = tid + m * blockDim.x, m < 8 / KS, (row, unit) = (p / U, p % U).
template <int KS>
__global__ void __launch_bounds__(kFfmaThreads) lstm_seq_cluster_ffma_kernel(
    const float* __restrict__ xproj, const float* __restrict__ rw,
    const float* __restrict__ peep, const float* __restrict__ h0,
    const float* __restrict__ c0, float* __restrict__ out, int B, int Tn,
    int H, int C) {
  constexpr int P = 8 / KS;  // cell-update pairs a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t bars[2];
  const int U = H / C, N = 4 * U, G = 4 * H;
  float* w = reinterpret_cast<float*>(smem_raw);
  float* hb = w + (size_t)H * N;
  float* part = hb + 2 * H * kClusterRows;
  float* cs = part + KS * kClusterRows * N;
  const int col0 = (int)cluster_ctarank() * U;
  const int b0 = (int)cluster_id() * kClusterRows;
  const int rows = min(kClusterRows, B - b0);
  const int tid = threadIdx.x, nt = blockDim.x;
  Exchange ex;
  ex.init(bars);

#pragma unroll 8
  for (int i = tid; i < H * N; i += nt) {
    const int k = i / N, q = (i % N) / U, u = i % U;
    w[((size_t)k * U + u) * 4 + q] = rw[(size_t)k * G + q * H + col0 + u];
  }
#pragma unroll 4
  for (int i = tid; i < 2 * H * kClusterRows; i += nt) {
    const int k = (i / kClusterRows) % H, r = i % kClusterRows;
    hb[i] = i < H * kClusterRows && r < rows
                ? h0[(size_t)(b0 + r) * H + k]
                : 0.0f;
  }
  for (int i = tid; i < kClusterRows * U; i += nt) {
    const int r = i / U;
    cs[i] = r < rows ? c0[(size_t)(b0 + r) * H + col0 + i % U] : 0.0f;
  }

  const int slice = tid / (2 * U), rg = (tid / U) % 2, u = tid % U;
  const int k_lo = slice * (H / KS), k_hi = k_lo + H / KS;
  float pp[P][3], x1[P][4], x2[P][4];  // xproj two steps ahead
#pragma unroll
  for (int m = 0; m < P; ++m) {
    const int jj = col0 + (tid + m * nt) % U;
#pragma unroll
    for (int e = 0; e < 3; ++e) pp[m][e] = peep[e * H + jj];
  }
  auto load_x = [&](float(&xn)[P][4], int t) {
#pragma unroll
    for (int m = 0; m < P; ++m) {
      const int pr = tid + m * nt, r = pr / U;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        xn[m][q] = r < rows && t < Tn
                       ? __ldg(xproj + ((size_t)(b0 + r) * Tn + t) * G +
                               q * H + col0 + pr % U)
                       : 0.0f;
    }
  };
  load_x(x1, 0);
  load_x(x2, 1);
  const uint32_t h_s = smem_addr(hb);

  cluster_arrive();
  cluster_wait();

  for (int t = 0; t < Tn; ++t) {
    const int cur = t & 1;
    float x[P][4];
#pragma unroll
    for (int m = 0; m < P; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        x[m][q] = x1[m][q];
        x1[m][q] = x2[m][q];
      }
    load_x(x2, t + 2);
    ex.wait(t);

    const float* hc = hb + cur * H * kClusterRows + rg * 8;
    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
#pragma unroll 2
    for (int k = k_lo; k < k_hi; ++k) {
      const float4 wv =
          *reinterpret_cast<const float4*>(w + ((size_t)k * U + u) * 4);
      const float4 h_lo =
          *reinterpret_cast<const float4*>(hc + k * kClusterRows);
      const float4 h_hi =
          *reinterpret_cast<const float4*>(hc + k * kClusterRows + 4);
      const float hr[8] = {h_lo.x, h_lo.y, h_lo.z, h_lo.w,
                           h_hi.x, h_hi.y, h_hi.z, h_hi.w};
      const float wq[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(hr[r], wq[q], acc[r][q]);
    }
    // (the previous step's readers of part have all sent their h, and so
    // passed this step's wait, before any thread gets here)
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        part[((size_t)slice * kClusterRows + rg * 8 + r) * N + q * U + u] =
            acc[r][q];
    __syncthreads();

    // z = xproj + the slices' partial sums in slice order; the cell
    // update; h_t (f32: round(h_t) is h_t) into this CTA's own slice of
    // its next buffer
    float* nxt = hb + (cur ^ 1) * H * kClusterRows;
#pragma unroll
    for (int m = 0; m < P; ++m) {
      const int pr = tid + m * nt, r = pr / U, uu = pr % U;
      float z[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float s = x[m][q];
#pragma unroll
        for (int sl = 0; sl < KS; ++sl)
          s += part[((size_t)sl * kClusterRows + r) * N + q * U + uu];
        z[q] = s;
      }
      float cc = cs[r * U + uu];
      const float h = cell<false>(z, cc, pp[m][0], pp[m][1], pp[m][2]);
      cs[r * U + uu] = cc;
      nxt[(col0 + uu) * kClusterRows + r] = r < rows ? h : 0.0f;
      if (r < rows) out[((size_t)(b0 + r) * Tn + t) * H + col0 + uu] = h;
    }
    // the slice (U units x 16 rows, contiguous) to the other CTAs in
    // 16-byte chunks
    if (t + 1 < Tn) {
      ex.expect(t, 64 * U * (C - 1));
      __syncthreads();
      const int chunks = 4 * U;
      const uint32_t base = smem_addr(nxt + col0 * kClusterRows);
      const uint32_t bar = ex.bar[cur ^ 1];
      for (int i = tid; i < chunks * (C - 1); i += nt) {
        const int k = i % chunks, pi = i / chunks;
        const int p = pi < col0 / U ? pi : pi + 1;  // not this CTA
        const uint4 v = *reinterpret_cast<const uint4*>(
            nxt + col0 * kClusterRows + k * 4);
        st_async(peer_addr(base + k * 16, p), v, peer_addr(bar, p));
      }
    }
  }
  cluster_arrive();
  cluster_wait();
}

// The cluster kernel for a plan, or nullptr where the plan is not one
// this route takes (the wrapper's plan is checked again here).
const void* cluster_kernel(int H, int dtype, int C, int ks, int threads,
                           int smem) {
  if (H < 8 || C < 1 || C > kMaxCluster || H % C != 0 || (H / C) % 8 != 0)
    return nullptr;
  const int U = H / C;
  if (dtype == 1)
    return ks == 2 && threads == 8 * U && threads <= kMmaThreads &&
                   smem >= mma_smem(H, C) && (H + 15) / 16 >= 2
               ? reinterpret_cast<const void*>(lstm_seq_cluster_mma_kernel)
               : nullptr;
  if (dtype != 0 || threads != 2 * U * ks || threads > kFfmaThreads ||
      H % ks != 0 || smem < ffma_smem(H, C, ks))
    return nullptr;
  switch (ks) {
    case 1:
      return reinterpret_cast<const void*>(lstm_seq_cluster_ffma_kernel<1>);
    case 2:
      return reinterpret_cast<const void*>(lstm_seq_cluster_ffma_kernel<2>);
    case 4:
      return reinterpret_cast<const void*>(lstm_seq_cluster_ffma_kernel<4>);
    case 8:
      return reinterpret_cast<const void*>(lstm_seq_cluster_ffma_kernel<8>);
    default:
      return nullptr;
  }
}

// cudaFuncSetAttribute for the dynamic shared memory once per kernel,
// device and larger size: a host call, legal under stream capture, that
// no later launch pays again.
cudaError_t reserve_smem(const void* kernel, int smem) {
  struct Done {
    const void* kernel;
    int dev, smem;
  };
  static std::mutex mu;
  static Done done[32];
  static int n_done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_done; ++i)
    if (done[i].kernel == kernel && done[i].dev == dev &&
        done[i].smem >= smem)
      return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess && n_done < 32) done[n_done++] = {kernel, dev, smem};
  return err;
}

// a grid of ceil(B / 16) clusters of C CTAs
cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int B, int C,
                                  int threads, int smem, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim =
      dim3((unsigned)(((B + kClusterRows - 1) / kClusterRows) * C), 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
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

// The cluster route: the same arguments as dl4j_lstm_seq, with
// `cluster` CTAs a cluster (H / cluster a multiple of 8), `k_slices`
// slices of the K reduction (bf16: 2, the warps of a group of 8 units;
// f32: 1, 2, 4 or 8), `threads` a CTA and `smem`
// bytes of dynamic shared memory, as kernels/fused_lstm.py's
// lstm_cluster_plan sizes them. A plan the route does not take, or a
// launch the card refuses, returns the error; nothing falls back.
extern "C" int dl4j_lstm_seq_cluster(const void* xproj, const void* rw,
                                     const void* peep, const void* h0,
                                     const void* c0, void* out, int B,
                                     int Tn, int H, int dtype, int cluster,
                                     int k_slices, int threads, int smem,
                                     void* stream) {
  const void* kernel =
      cluster_kernel(H, dtype, cluster, k_slices, threads, smem);
  if (B < 1 || Tn < 1 || kernel == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = reserve_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      attr, B, cluster, threads, smem, static_cast<cudaStream_t>(stream));
  void* args[] = {&xproj, &rw, &peep, &h0, &c0, &out,
                  &B,     &Tn, &H,    &cluster};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of the plan the card keeps resident at once
// (cudaOccupancyMaxActiveClusters), or minus the error.
extern "C" int dl4j_lstm_cluster_max_active(int B, int H, int dtype,
                                            int cluster, int k_slices,
                                            int threads, int smem) {
  const void* kernel =
      cluster_kernel(H, dtype, cluster, k_slices, threads, smem);
  if (B < 1 || kernel == nullptr) return -(int)cudaErrorInvalidValue;
  cudaError_t err = reserve_smem(kernel, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(attr, B, cluster, threads, smem, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}
