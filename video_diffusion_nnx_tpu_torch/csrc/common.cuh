// Shared helpers for the port's CUDA kernels: float <-> storage-type
// conversion and rounding through the storage type (bf16 or float), the
// register-blocked product `mm` of the online-softmax kernels, and the
// reduction of per-CTA weight-gradient partials.
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

// C(m, n) = sum_k A(m, k) B(k, n) for m < M, n < N, by the `nth` threads
// `tid` of a group. Each thread owns TM x TN outputs, rows mi + i * MC and
// columns ni + j * NC (strided, so that neighbouring threads touch
// neighbouring columns and rows), sums over k in order, and hands each to
// `store(m, n, value)` exactly once. Indices past the edge are clamped for
// the loads and not stored.
template <int TM, int TN, class FA, class FB, class FS>
__device__ __forceinline__ void mm(int tid, int nth, int M, int N, int K, FA a, FB b, FS store) {
  const int MC = (M + TM - 1) / TM, NC = (N + TN - 1) / TN;
  for (int item = tid; item < MC * NC; item += nth) {
    const int mi = item / NC, ni = item - mi * NC;
    int ms[TM], ns[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) ms[i] = min(mi + i * MC, M - 1);
#pragma unroll
    for (int j = 0; j < TN; ++j) ns[j] = min(ni + j * NC, N - 1);
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < K; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = a(ms[i], k);
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = b(k, ns[j]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += av[i] * bv[j];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (mi + i * MC < M && ni + j * NC < N) store(mi + i * MC, ni + j * NC, acc[i][j]);
  }
}

// Sum of `v` over the 8 neighbouring lanes that share a row (every lane ends with the same value).
__device__ __forceinline__ float sum8(float v) {
  for (int o = 4; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float max8(float v) {
  for (int o = 4; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

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
