// FedAvg fold kernels for Hopper (sm_90a): the aggregation hot loop.
//
// Three streaming passes over flat fp32 model updates, each the port of
// a Pallas TPU kernel in src/repro/kernels/fedavg/fedavg.py.  All three
// are bound by device memory: they do 1-2 flops per element moved, far
// below the ~20 flops/byte where an H100 stops being memory-bound in
// fp32.  The least time is the bytes each must move over 3.35 TB/s:
//
//   eager_accumulate     acc[i] += w * u[i]                12 N bytes (f32 u)
//   fedavg_accumulate_k  acc[i] += sum_k w[k] * U[k, i]    (8 + 4K) N bytes (f32 U)
//   fedavg_reduce        out[i]  = sum_k wn[k] * U[k, i]   4 (K + 1) N bytes (f32 U)
//
// Design: the TPU kernels walk N in sequential 8192-element VMEM blocks;
// on the GPU no state carries between blocks, so each thread owns its
// elements outright, with int64 offsets, and the grid is capped at eight
// 256-thread blocks per SM (a full SM; the SM count is queried once),
// except the eager fold's, which is one pass.  No atomics: a fold gives
// the same bits on every run.
//
// The eager fold is the path's most frequent launch and streams 12 bytes
// an element (f32 wire), so it is built for the memory system: 16-byte
// loads and stores (a float4 of acc, and 16 bytes of u: 4 fp32 values, or
// 8 bf16 / fp16 ones covering two float4s of acc), four independent
// 16-byte accesses of each in flight per thread before any is used, one
// pass over the vectors (a block for every 4 x 256 of them: a
// grid-stride loop over a capped grid measured a few percent slower).  A contiguous
// view may start anywhere: a scalar head runs up to the first element
// where acc (and, where it can be, u) is 16-byte aligned, and a scalar
// tail past the last whole vector.  Where acc and u cannot both be
// aligned (acc[1:] against u[3:] in bf16), u is read element by element
// and acc still by float4.  Its first design (one 4-byte access a thread
// per step, the SM count queried at every launch) stays below as
// fedavg_eager_accumulate_previous, for timing against the new one.
//
// The burst and the reduce read one element per thread per step.  The K
// rows of a burst are summed in ascending k into an fp32 register and
// added to the accumulator once, so the accumulator is read and written
// once per burst, not K times.
//
// Products and sums use __fmul_rn / __fadd_rn, which nvcc never
// contracts into an FMA: the kernels round where the plain PyTorch
// versions (ref.py) round.
//
// Wire dtypes: u / U may be fp32, bf16 or fp16 (dtype code 0 / 1 / 2);
// every element is widened to fp32 in registers.  Each entry returns
// cudaGetLastError() so the caller sees a refused launch at once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libfedavg.so fedavg.cu

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;  // 8 x 256 threads fill an SM's 2048

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

// Replaces _accum_kernel (fedavg.py:66) behind eager_accumulate_pallas
// (fedavg.py:112).  In place on acc: the counterpart of the Pallas
// kernel's input_output_aliases={0: 0}.  Elements [0, head) and
// [head + kVec nvec, n) one a thread; the body in nvec vectors of kVec
// elements, acc + head 16-byte aligned, and u + head too when kVecU.
constexpr int kUnroll = 4;

template <typename T>
struct Wire {
  static constexpr int kVec = 16 / sizeof(T);   // values in 16 bytes
};

// The kVec values of u at p, from one 16-byte load or from kVec loads.
template <typename T, bool kVecU>
__device__ __forceinline__ void load_u(const T* __restrict__ p,
                                       float (&f)[Wire<T>::kVec]) {
  if constexpr (kVecU) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    const T* x = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < Wire<T>::kVec; ++i) f[i] = widen(x[i]);
  } else {
#pragma unroll
    for (int i = 0; i < Wire<T>::kVec; ++i) f[i] = widen(p[i]);
  }
}

template <typename T, bool kVecU>
__global__ void __launch_bounds__(kThreads) eager_accumulate_kernel(
    float* __restrict__ acc, const T* __restrict__ u, float w, int64_t head,
    int64_t nvec, int64_t n) {
  constexpr int V = Wire<T>::kVec;     // elements a vector of u
  constexpr int A = V / 4;             // float4s of acc it covers
  const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t tail0 = head + nvec * V;
  if (gid < head) acc[gid] = __fadd_rn(acc[gid], __fmul_rn(w, widen(u[gid])));
  if (tail0 + gid < n) {
    const int64_t i = tail0 + gid;
    acc[i] = __fadd_rn(acc[i], __fmul_rn(w, widen(u[i])));
  }
  // block b owns vectors [b kUnroll kThreads, (b + 1) kUnroll kThreads):
  // every load of the block is issued before any is used
  float4* __restrict__ a4 = reinterpret_cast<float4*>(acc + head);
  const T* __restrict__ ub = u + head;
  const int64_t base = (int64_t)blockIdx.x * kThreads * kUnroll + threadIdx.x;
  float4 a[kUnroll][A];
  float f[kUnroll][V];
#pragma unroll
  for (int r = 0; r < kUnroll; ++r) {
    const int64_t v = base + r * kThreads;
    if (v < nvec) {
#pragma unroll
      for (int c = 0; c < A; ++c) a[r][c] = a4[v * A + c];
      load_u<T, kVecU>(ub + v * V, f[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kUnroll; ++r) {
    const int64_t v = base + r * kThreads;
    if (v < nvec) {
#pragma unroll
      for (int c = 0; c < A; ++c) {
        float4 x = a[r][c];
        x.x = __fadd_rn(x.x, __fmul_rn(w, f[r][4 * c]));
        x.y = __fadd_rn(x.y, __fmul_rn(w, f[r][4 * c + 1]));
        x.z = __fadd_rn(x.z, __fmul_rn(w, f[r][4 * c + 2]));
        x.w = __fadd_rn(x.w, __fmul_rn(w, f[r][4 * c + 3]));
        a4[v * A + c] = x;
      }
    }
  }
}

// The eager fold's first design, kept only to time the new one
// against: one 4-byte access a thread per grid-stride step.
template <typename T>
__global__ void eager_accumulate_previous_kernel(float* __restrict__ acc,
                                                 const T* __restrict__ u,
                                                 float w, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    acc[i] = __fadd_rn(acc[i], __fmul_rn(w, widen(u[i])));
  }
}

// Replaces _accum_k_kernel (fedavg.py:74) behind
// fedavg_accumulate_k_pallas (fedavg.py:82).  Weights are raw and live
// in device memory; every thread reads the same K values (L1 broadcast).
template <typename T>
__global__ void accumulate_k_kernel(float* __restrict__ acc,
                                    const T* __restrict__ U,
                                    const float* __restrict__ w, int64_t k,
                                    int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float s = 0.0f;
    for (int64_t r = 0; r < k; ++r) {
      s = __fadd_rn(s, __fmul_rn(__ldg(w + r), widen(U[r * n + i])));
    }
    acc[i] = __fadd_rn(acc[i], s);
  }
}

// Replaces _reduce_kernel (fedavg.py:33) behind fedavg_reduce_pallas
// (fedavg.py:40).  Weights arrive normalized (ops.py divides by their
// sum), so the Pallas kernel's "* inv_total" (1.0) is dropped.
template <typename T>
__global__ void reduce_kernel(float* __restrict__ out,
                              const T* __restrict__ U,
                              const float* __restrict__ wn, int64_t k,
                              int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float s = 0.0f;
    for (int64_t r = 0; r < k; ++r) {
      s = __fadd_rn(s, __fmul_rn(__ldg(wn + r), widen(U[r * n + i])));
    }
    out[i] = s;
  }
}

// The SM count, queried once.
int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return sms;
}

int grid_for(int64_t n) {
  const int64_t need = (n + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sm_count() * kBlocksPerSM;
  return (int)(need < cap ? need : cap);
}

// The first design's grid, with its per-launch device queries.
int grid_for_previous(int64_t n) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int64_t need = (n + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * kBlocksPerSM;
  return (int)(need < cap ? need : cap);
}

template <typename T>
void launch_eager(float* acc, const T* u, float w, int64_t n,
                  cudaStream_t s) {
  constexpr int V = Wire<T>::kVec;
  const uintptr_t pa = reinterpret_cast<uintptr_t>(acc);
  const uintptr_t pu = reinterpret_cast<uintptr_t>(u);
  // acc's head to 16 bytes; then, stepping by whole float4s of acc, the
  // first offset where u is 16-byte aligned too, if there is one
  int64_t head = (int64_t)(((16 - (pa & 15)) & 15) / 4);
  bool vec_u = false;
  for (int64_t h = head; h < head + V; h += 4) {
    if (((pu + h * sizeof(T)) & 15) == 0) {
      head = h;
      vec_u = true;
      break;
    }
  }
  if (head > n) head = n;
  const int64_t nvec = (n - head) / V;
  // one pass: a block for every kUnroll x kThreads vectors (at least one,
  // for the head and tail)
  const int64_t blocks = (nvec + (int64_t)kThreads * kUnroll - 1) /
                         ((int64_t)kThreads * kUnroll);
  const int grid = (int)(blocks < 1 ? 1 : blocks);
  if (vec_u) {
    eager_accumulate_kernel<T, true><<<grid, kThreads, 0, s>>>(acc, u, w, head,
                                                               nvec, n);
  } else {
    eager_accumulate_kernel<T, false><<<grid, kThreads, 0, s>>>(acc, u, w,
                                                                head, nvec, n);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16, 2 = fp16 (the type of u).
int fedavg_eager_accumulate(void* acc, const void* u, int64_t n, int dtype,
                            float w, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* a = (float*)acc;
  switch (dtype) {
    case 0: launch_eager(a, (const float*)u, w, n, s); break;
    case 1: launch_eager(a, (const __nv_bfloat16*)u, w, n, s); break;
    case 2: launch_eager(a, (const __half*)u, w, n, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The first design of the eager fold (timing only; see the header).
int fedavg_eager_accumulate_previous(void* acc, const void* u, int64_t n,
                                     int dtype, float w, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = grid_for_previous(n);
  float* a = (float*)acc;
  switch (dtype) {
    case 0:
      eager_accumulate_previous_kernel<<<grid, kThreads, 0, s>>>(
          a, (const float*)u, w, n);
      break;
    case 1:
      eager_accumulate_previous_kernel<<<grid, kThreads, 0, s>>>(
          a, (const __nv_bfloat16*)u, w, n);
      break;
    case 2:
      eager_accumulate_previous_kernel<<<grid, kThreads, 0, s>>>(
          a, (const __half*)u, w, n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int fedavg_accumulate_k(void* acc, const void* U, const void* w, int64_t k,
                        int64_t n, int dtype, void* stream) {
  if (n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = grid_for(n);
  float* a = (float*)acc;
  const float* wf = (const float*)w;
  switch (dtype) {
    case 0:
      accumulate_k_kernel<<<grid, kThreads, 0, s>>>(a, (const float*)U, wf,
                                                    k, n);
      break;
    case 1:
      accumulate_k_kernel<<<grid, kThreads, 0, s>>>(
          a, (const __nv_bfloat16*)U, wf, k, n);
      break;
    case 2:
      accumulate_k_kernel<<<grid, kThreads, 0, s>>>(a, (const __half*)U, wf,
                                                    k, n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int fedavg_reduce(void* out, const void* U, const void* wn, int64_t k,
                  int64_t n, int dtype, void* stream) {
  if (n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = grid_for(n);
  float* o = (float*)out;
  const float* wf = (const float*)wn;
  switch (dtype) {
    case 0:
      reduce_kernel<<<grid, kThreads, 0, s>>>(o, (const float*)U, wf, k, n);
      break;
    case 1:
      reduce_kernel<<<grid, kThreads, 0, s>>>(o, (const __nv_bfloat16*)U, wf,
                                              k, n);
      break;
    case 2:
      reduce_kernel<<<grid, kThreads, 0, s>>>(o, (const __half*)U, wf, k, n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
