// Per-row int8 quantize and dequantize for Hopper (sm_90a).
//
// Replaces the TPU kernels quantize_pallas (_quant_kernel) and
// dequantize_pallas (_dequant_kernel) of
// src/repro/kernels/quantize/quantize.py.  A row is one quantization
// block of b elements (1 <= b <= 256): the TPU kernel's QBLOCK = 256 is
// the case b = 256, and the narrower rows are what the compression of a
// leaf whose last axis is under 256 produces.
//
//   quantize:    s = amax > 0 ? amax * (1/127) : 1,  q = clip(rint(x / s), -127, 127)
//   dequantize:  out = (float)q * s, cast to the output dtype
//
// Bound: both stream memory (5 bytes an element plus 4 a row, one pass,
// a handful of operations an element), so bytes over the card's rate
// bound them.  Design: one warp per row, eight rows a block; lane l takes
// elements l, l + 32, ... of its row (each step of the warp reads 32
// neighbouring elements), finds its part of amax, and the warp folds
// amax with four xor-shuffles.  The TPU grid walked its rows in order;
// here the rows are independent blocks in any order, so nothing carries
// over between them.  Row offsets are 64-bit: a full-width embedding
// delta alone is 1,539,072 rows.
//
// Bit-equality with the plain version and the JAX package: the scale is
// amax times the fp32 reciprocal of 127, rounded once (__fmul_rn), which
// is what XLA compiles the JAX package's `amax / 127.0` to (it rewrites a
// division by a constant into a product with its reciprocal; an IEEE
// division differs by one ulp in about 3 % of rows); x / s is an IEEE
// division (__fdiv_rn, no fast math); rintf rounds half to even, as
// jnp.round; dequantize's product is __fmul_rn.  Rows are zero-padded by
// the caller; zeros never raise amax.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxRow = 256;
constexpr int kPerLane = kMaxRow / 32;
constexpr float kInv127 = 1.0f / 127.0f;  // 0x3c010204, rounded once

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ s, long long rows, int b) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const T* xr = x + row * b;
  float v[kPerLane];
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int c = lane + 32 * j;
    v[j] = c < b ? to_f32(xr[c]) : 0.0f;
    amax = fmaxf(amax, fabsf(v[j]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = amax > 0.0f ? __fmul_rn(amax, kInv127) : 1.0f;
  int8_t* qr = q + row * b;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int c = lane + 32 * j;
    if (c < b) {
      const float r = rintf(__fdiv_rn(v[j], scale));
      qr[c] = (int8_t)(int)fminf(fmaxf(r, -127.0f), 127.0f);
    }
  }
  if (lane == 0) s[row] = scale;
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                  T* __restrict__ out, long long rows, int b) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float scale = s[row];
  const int8_t* qr = q + row * b;
  T* orow = out + row * b;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int c = lane + 32 * j;
    if (c < b) store(orow + c, __fmul_rn((float)qr[c], scale));
  }
}

inline dim3 grid_for(long long rows) {
  return dim3((unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
}

}  // namespace

// dtype codes (kernels/build.py): 0 fp32, 1 bf16.
extern "C" int quantize_rows(const void* x, void* q, void* s, long long rows,
                             int b, int dtype, void* stream) {
  if (b < 1 || b > kMaxRow || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 block(kWarpsPerBlock * 32);
  switch (dtype) {
    case 0:
      quantize_kernel<float><<<grid_for(rows), block, 0, st>>>(
          (const float*)x, (int8_t*)q, (float*)s, rows, b);
      break;
    case 1:
      quantize_kernel<__nv_bfloat16><<<grid_for(rows), block, 0, st>>>(
          (const __nv_bfloat16*)x, (int8_t*)q, (float*)s, rows, b);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int dequantize_rows(const void* q, const void* s, void* out,
                               long long rows, int b, int dtype,
                               void* stream) {
  if (b < 1 || b > kMaxRow || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 block(kWarpsPerBlock * 32);
  switch (dtype) {
    case 0:
      dequantize_kernel<float><<<grid_for(rows), block, 0, st>>>(
          (const int8_t*)q, (const float*)s, (float*)out, rows, b);
      break;
    case 1:
      dequantize_kernel<__nv_bfloat16><<<grid_for(rows), block, 0, st>>>(
          (const int8_t*)q, (const float*)s, (__nv_bfloat16*)out, rows, b);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
