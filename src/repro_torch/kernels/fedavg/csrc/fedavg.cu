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
// Design: one element per thread per step of a grid-stride loop with
// int64 offsets, the grid sized from N and capped at eight 256-thread
// blocks per SM (a full SM).  The TPU kernels walk N in sequential
// 8192-element VMEM blocks; on the GPU no state carries between blocks,
// so each thread owns its elements outright.  No atomics: a fold gives
// the same bits on every run.  The K rows of a burst are summed in
// ascending k into an fp32 register and added to the accumulator once,
// so the accumulator is read and written once per burst, not K times.
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
// kernel's input_output_aliases={0: 0}.
template <typename T>
__global__ void eager_accumulate_kernel(float* __restrict__ acc,
                                        const T* __restrict__ u, float w,
                                        int64_t n) {
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

int grid_for(int64_t n) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int64_t need = (n + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * kBlocksPerSM;
  return (int)(need < cap ? need : cap);
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16, 2 = fp16 (the type of u).
int fedavg_eager_accumulate(void* acc, const void* u, int64_t n, int dtype,
                            float w, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = grid_for(n);
  float* a = (float*)acc;
  switch (dtype) {
    case 0:
      eager_accumulate_kernel<<<grid, kThreads, 0, s>>>(a, (const float*)u,
                                                        w, n);
      break;
    case 1:
      eager_accumulate_kernel<<<grid, kThreads, 0, s>>>(
          a, (const __nv_bfloat16*)u, w, n);
      break;
    case 2:
      eager_accumulate_kernel<<<grid, kThreads, 0, s>>>(a, (const __half*)u,
                                                        w, n);
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
