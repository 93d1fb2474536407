// Shared helpers for the port's CUDA kernels: float <-> storage-type
// conversion and rounding through the storage type (bf16 or float).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace vdt {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// Round a float to the storage type and back: where the JAX kernels cast a
// float32 intermediate to the input dtype, these kernels do the same.
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f<T>(from_f<T>(v)); }

constexpr int kThreads = 256;

// The second pass of every backward kernel's weight gradients. Each CTA of
// the first pass owns one float32 partial (rows, cols) at `partial + b *
// stride`; this sums the `nblk` partials in block order, so the result does
// not depend on how the CTAs were scheduled, and writes row r to
// `out + r * ld` (ld > cols writes into a slice of a wider matrix).
__global__ void __launch_bounds__(kThreads) reduce_partials_kernel(
    const float* __restrict__ partial, int nblk, size_t stride, int rows, int cols,
    float* __restrict__ out, int ld) {
  const size_t total = (size_t)rows * cols;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < nblk; ++b) s += partial[(size_t)b * stride + i];
    const size_t r = i / cols, c = i - r * cols;
    out[r * ld + c] = s;
  }
}

static inline int launch_reduce(const float* partial, int nblk, size_t stride, int rows, int cols,
                                float* out, int ld, cudaStream_t stream) {
  const size_t total = (size_t)rows * cols;
  const int grid = (int)(total < (size_t)1024 * kThreads ? (total + kThreads - 1) / kThreads : 1024);
  reduce_partials_kernel<<<grid, kThreads, 0, stream>>>(partial, nblk, stride, rows, cols, out, ld);
  return (int)cudaGetLastError();
}

}  // namespace vdt
