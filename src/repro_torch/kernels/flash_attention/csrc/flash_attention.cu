// Flash-attention forward for Hopper (sm_90a): causal / sliding-window
// GQA attention with an online softmax.
//
// Replaces _flash_fwd_kernel behind flash_attention_fwd_pallas
// (src/repro/kernels/flash_attention/flash_attention.py:89).  For query
// head h = kh*G + g of batch b:
//
//   s[i, j]   = (q[b, i, h, :] . k[b, j, kh, :]) * scale      (fp32 inputs)
//   visible   = j < S  &&  (!causal || i >= j)  &&  (window < 0 || i - j < window)
//   out[b, i, h, :] = sum_j softmax_j(visible ? s : -1e30) * v[b, j, kh, :]
//
// computed over KV tiles with the running (m, l, acc) of each row in
// fp32, exactly as the TPU kernel does across its sequential n_kv grid
// axis, and written as acc / max(l, 1e-30) in v's dtype.
//
// What bounds it on the card.  At the serve path's prefill (B = 4,
// S = 2000, 24 query heads over 8 KV heads, D = 128, bf16) a launch does
// 4*B*H*D*S(S+1)/2 = 98 GFLOP over 12 MB of q, k, v and o: 8,000 flops a
// byte, far above the ~295 where the card turns compute-bound.  The
// least time is the flops at the bf16 tensor-core peak (about 0.1 ms).
//
// What this design does about it.  It is the simple, right version, the
// port's first: fp32 FMA on the CUDA cores (67 TFLOP/s at best, a
// fifteenth of the tensor-core rate), so it stays well off the bound.  It
// is on no route: the tensor-core kernels take every input
// (flash_attention_sm90.cu 16-bit ones that TMA takes,
// flash_attention_mma.cu every other 16-bit one, flash_attention_tf32x3.cu
// every fp32 one), and this one runs only when named (variant "simt"), as
// the yardstick they are timed against.  Within that:
//   * one 256-thread block per (64-row query tile, head, batch); the loop
//     over KV tiles inside the block takes the place of the TPU's
//     sequential kv grid axis, and nothing carries between blocks;
//   * q, k, v are read strided in the (B, S, K, G, D) / (B, S, K, D)
//     layout of the model; no transpose is materialised;
//   * the Q tile and each K tile sit in shared memory transposed ([d][row],
//     rows padded to 68 floats), so each step of the dot loads one float4
//     of Q and one of K and does 16 FMAs: thread (ty, tx) owns the 4 x 4
//     scores of rows 4ty.. and keys 4tx..; the 16 threads of a row are one
//     half-warp, so the row max and sum are four xor-shuffles;
//   * P goes to shared memory transposed over the K tile's space (dead by
//     then) and P.V runs the same way into 4 x (4 NG) fp32 accumulators a
//     thread, NG = ceil(Dv / 64); at D = Dv = 128 a block takes 100 KB, so
//     two blocks share an SM;
//   * KV tiles wholly above the diagonal (causal) or wholly outside the
//     window are skipped: the TPU kernel visits them, but a wholly masked
//     tile before the first visible one is wiped by corr = exp(-1e30 - m)
//     = 0 and one after it adds p = 0, so the result is the same.  The
//     masked value stays -1e30, never -inf (which would make that first
//     case NaN);
//   * the query tiles run last-first, so the longest (causal) blocks start
//     first and the short ones fill the tail.
// expf is the IEEE one (no fast math): the fp32 tolerance is 2e-6.
//
// dtype code: 0 fp32, 1 bf16, 2 fp16 (q, k, v and out share it).  D and
// Dv up to 256.  The entry returns cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per KV tile
constexpr int kThreads = 256;    // 16 x 16 threads, 4 x 4 scores each
constexpr int kTS = kBQ + 4;     // row stride of the transposed tiles
constexpr int kMaxDim = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half narrow<__half>(float x) {
  return __float2half_rn(x);
}

// Copy rows [s0, s0 + 64) x [0, width) of a strided (row, col) source
// into shared memory, widened to fp32 and zero past S or past width.
// Transposed: dst[c * kTS + r]; else dst[r * ld + c].  The (r, c)
// walk steps by the thread count without a division per element.
template <typename T, bool kTransposed>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src,
                                          int64_t row_stride, int s0, int S,
                                          int width, int ld) {
  const int r_step = kThreads / ld, c_step = kThreads % ld;
  int r = threadIdx.x / ld, c = threadIdx.x % ld;
  for (; r < 64; r += r_step) {
    const int s = s0 + r;
    const float x =
        (s < S && c < width) ? widen(src[(int64_t)s * row_stride + c]) : 0.f;
    if (kTransposed) {
      dst[c * kTS + r] = x;
    } else {
      dst[r * ld + c] = x;
    }
    c += c_step;
    if (c >= ld) {
      c -= ld;
      ++r;
    }
  }
}

template <typename T, int NG>
__global__ void __launch_bounds__(kThreads, NG <= 2 ? 2 : 1)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int S,
                     int H, int KH, int D, int Dv, float scale, int window,
                     int causal) {
  constexpr int DVP = NG * 64;   // Vs row stride
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);          // [D][kTS]
  float* Vs = Qt + D * kTS;                             // [kBK][DVP]
  float* Kt = Vs + kBK * DVP;                           // [D][kTS]
  float* Pt = Kt;                                       // [kBK][kTS]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // long tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  const int64_t q_rs = (int64_t)H * D, k_rs = (int64_t)KH * D;
  const int64_t v_rs = (int64_t)KH * Dv, o_rs = (int64_t)H * Dv;
  const T* qb = q + ((int64_t)b * S * H + h) * D;
  const T* kb = k + ((int64_t)b * S * KH + kh) * D;
  const T* vb = v + ((int64_t)b * S * KH + kh) * Dv;
  T* ob = o + ((int64_t)b * S * H + h) * Dv;

  load_tile<T, true>(Qt, qb, q_rs, q0, S, D, D);

  float m[4], l[4], acc[4][4 * NG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) acc[i][c] = 0.f;
  }

  const int n_kv = (S + kBK - 1) / kBK;
  for (int t = 0; t < n_kv; ++t) {
    const int kv0 = t * kBK;
    if (causal && kv0 > q0 + kBQ - 1) break;            // above the diagonal
    if (window >= 0 && kv0 + kBK - 1 <= q0 - window) continue;  // too old

    __syncthreads();          // the last tile's Pt / Vs reads are done
    load_tile<T, true>(Kt, kb, k_rs, kv0, S, D, D);
    load_tile<T, false>(Vs, vb, v_rs, kv0, S, Dv, DVP);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * kTS + 4 * ty);
      const float4 c = *reinterpret_cast<const float4*>(Kt + d * kTS + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(av[i], cv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kv0 + 4 * tx + j;
        bool ok = col < S;
        if (causal) ok = ok && row >= col;
        if (window >= 0) ok = ok && row - col < window;
        sc[i][j] = ok ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        ps += sc[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NG; ++c) acc[i][c] *= corr;
    }

    __syncthreads();          // every thread is done reading Kt
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(Pt + (4 * tx + j) * kTS + 4 * ty) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    }
    __syncthreads();

    for (int jj = 0; jj < kBK; ++jj) {
      const float4 p4 = *reinterpret_cast<const float4*>(Pt + jj * kTS + 4 * ty);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(Vs + jj * DVP + 64 * g + 4 * tx);
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[i][4 * g + c] = fmaf(pv[i], vv[c], acc[i][4 * g + c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 64 * g + 4 * tx + c;
        if (col < Dv) ob[(int64_t)row * o_rs + col] = narrow<T>(acc[i][4 * g + c] / denom);
      }
  }
}

template <typename T, int NG>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int KH, int D, int Dv, float scale,
                   int window, int causal, cudaStream_t stream) {
  const int kt = (D > kBK ? D : kBK) * kTS;   // Kt, and Pt over it
  const size_t smem = sizeof(float) * ((size_t)D * kTS + kBK * NG * 64 + kt);
  auto kern = flash_fwd_kernel<T, NG>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KH, D, Dv, scale,
      window, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dv(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int KH, int D, int Dv,
                        float scale, int window, int causal,
                        cudaStream_t stream) {
  switch ((Dv + 63) / 64) {
    case 1: return launch<T, 1>(q, k, v, o, B, S, H, KH, D, Dv, scale, window, causal, stream);
    case 2: return launch<T, 2>(q, k, v, o, B, S, H, KH, D, Dv, scale, window, causal, stream);
    case 3: return launch<T, 3>(q, k, v, o, B, S, H, KH, D, Dv, scale, window, causal, stream);
    case 4: return launch<T, 4>(q, k, v, o, B, S, H, KH, D, Dv, scale, window, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, S, H, D), k (B, S, KH, D), v (B, S, KH, Dv), out (B, S, H, Dv),
// all contiguous; H a multiple of KH; window < 0 is GLOBAL.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int KH, int D, int Dv,
                        float scale, int window, int causal, int dtype,
                        void* stream) {
  if (B <= 0 || S <= 0 || KH <= 0 || H % KH != 0 || D <= 0 || Dv <= 0 ||
      D > kMaxDim || Dv > kMaxDim)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = dispatch_dv<float>(q, k, v, o, B, S, H, KH, D, Dv, scale, window, causal, st); break;
    case 1: err = dispatch_dv<__nv_bfloat16>(q, k, v, o, B, S, H, KH, D, Dv, scale, window, causal, st); break;
    case 2: err = dispatch_dv<__half>(q, k, v, o, B, S, H, KH, D, Dv, scale, window, causal, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"
