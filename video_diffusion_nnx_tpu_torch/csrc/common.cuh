// Shared helpers for the port's CUDA kernels: float <-> storage-type
// conversion and rounding through the storage type (bf16 or float), the
// register-blocked product `mm` of the online-softmax kernels, the tensor-core
// products and staging of the bf16 backward kernels, and the reduction of
// per-CTA weight-gradient partials.
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
constexpr size_t kSmemMax = 232448;  // 227 KB, the most shared memory one CTA may use on the H100

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

// ---------------------------------------------------------------------------
// Tensor-core products on bf16 panels in shared memory (sm_80 and later).
//
// `mma.sync.m16n8k16` multiplies a 16x16 bf16 A fragment by a 16x8 bf16 B
// fragment into a 16x8 float32 accumulator; `ldmatrix` loads the fragments
// from shared memory, four 8x8 matrices per instruction, transposing them on
// the way where the panel is stored the other way round. Every panel's
// leading dimension is a multiple of 8 elements (16 bytes, which `ldmatrix`
// needs for its row addresses) and should be an odd number of 16-byte units,
// so that the 8 rows of one matrix fall in 8 different bank groups
// (`pad_ld`). Shapes are padded by the caller to multiples of 16, with zeros
// wherever a padded element enters a sum.

typedef __nv_bfloat16 bf16;

// A leading dimension for a panel of `n` bf16 columns: n rounded up to 16, plus 8.
__host__ __device__ constexpr int pad_ld(int n) { return (n + 15) / 16 * 16 + 8; }
__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp's 16 x 16 block (m0, n0) of C = A B, summed over K in order, into the m16n8k16
// accumulator fragments acc[0] (columns n0..n0+7) and acc[1] (n0+8..n0+15). A is stored (M, K)
// row-major with leading dimension lda, or with AT as (K, M); B is stored (K, N) with BK, or
// (N, K) without. K is a multiple of 16.
template <bool AT, bool BK>
__device__ __forceinline__ void mma_block(const bf16* A, int lda, const bf16* B, int ldb, int m0,
                                          int n0, int K, float (&acc)[2][4]) {
  const int lane = threadIdx.x & 31;
  // Per-lane offsets of the ldmatrix row addresses (see the fragment layouts of m16n8k16).
  const int a_r = AT ? (lane & 7) + ((lane >> 4) << 3) : (lane & 15);  // k if AT, else m
  const int a_c = AT ? ((lane >> 3) & 1) << 3 : (lane >> 4) << 3;       // m if AT, else k
  const int b_r = BK ? (lane & 7) + (((lane >> 3) & 1) << 3) : (lane & 7) + ((lane >> 4) << 3);
  const int b_c = BK ? (lane >> 4) << 3 : ((lane >> 3) & 1) << 3;       // BK: (k, n); else (n, k)
#pragma unroll
  for (int j = 0; j < 2; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int k0 = 0; k0 < K; k0 += 16) {
    unsigned a[4], b[4];
    if (AT) ldsm_x4_t(a, A + (size_t)(k0 + a_r) * lda + m0 + a_c);
    else ldsm_x4(a, A + (size_t)(m0 + a_r) * lda + k0 + a_c);
    if (BK) ldsm_x4_t(b, B + (size_t)(k0 + b_r) * ldb + n0 + b_c);
    else ldsm_x4(b, B + (size_t)(n0 + b_r) * ldb + k0 + b_c);
    mma_bf16(acc[0], a, b[0], b[1]);
    mma_bf16(acc[1], a, b[2], b[3]);
  }
}

// C = A B over M x N x K by all the warps of the block, each owning 16 x 16 blocks round
// robin; every pair of neighbouring outputs goes to `epi(row, col, v0, v1)` (columns col and
// col + 1) exactly once. M, N and K are multiples of 16. (Blocks of 16 x 32, which load A
// half as often, were no faster at these kernels' shapes and need more registers than two
// CTAs per SM leave.)
template <bool AT, bool BK, class Epi>
__device__ __forceinline__ void tc_mma(const bf16* A, int lda, const bf16* B, int ldb, int M, int N,
                                       int K, Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int blk = warp; blk < (M / 16) * (N / 16); blk += nwarps) {
    const int m0 = (blk / (N / 16)) * 16, n0 = (blk % (N / 16)) * 16;
    float acc[2][4];
    mma_block<AT, BK>(A, lda, B, ldb, m0, n0, K, acc);
    const int r = m0 + (lane >> 2), c = n0 + (lane & 3) * 2;
    epi(r, c, acc[0][0], acc[0][1]);
    epi(r + 8, c, acc[0][2], acc[0][3]);
    epi(r, c + 8, acc[1][0], acc[1][1]);
    epi(r + 8, c + 8, acc[1][2], acc[1][3]);
  }
}

// dst(r, c) += (A B)(r, c) for r < Mv, c < Nv, dst float32 with leading dimension ldd (shared or
// device memory; each element belongs to one thread). A thread first reads all eight of its
// elements of a block, then writes them, so that the reads of device memory overlap.
template <bool AT, bool BK>
__device__ __forceinline__ void tc_mma_add(const bf16* A, int lda, const bf16* B, int ldb, int M,
                                           int N, int K, float* dst, size_t ldd, int Mv, int Nv) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int blk = warp; blk < (M / 16) * (N / 16); blk += nwarps) {
    const int m0 = (blk / (N / 16)) * 16, n0 = (blk % (N / 16)) * 16;
    float acc[2][4];
    mma_block<AT, BK>(A, lda, B, ldb, m0, n0, K, acc);
    const int r0 = m0 + (lane >> 2), c0 = n0 + (lane & 3) * 2;
    float old[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + (e >> 1) * 8, c = c0 + 8 * j + (e & 1);
        old[j][e] = (r < Mv && c < Nv) ? dst[(size_t)r * ldd + c] : 0.f;
      }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + (e >> 1) * 8, c = c0 + 8 * j + (e & 1);
        if (r < Mv && c < Nv) dst[(size_t)r * ldd + c] = old[j][e] + acc[j][e];
      }
  }
}

// The same two products for float32 panels, on the CUDA cores: each thread owns four rows
// (m, m + M/4, ...) by two neighbouring columns, sums over K in order, and hands the pairs to
// `epi` as tc_mma does. M a multiple of 4, N of 2.
template <bool AT, bool BK, class Epi>
__device__ __forceinline__ void simt_mma(const float* A, int lda, const float* B, int ldb, int M,
                                         int N, int K, Epi epi) {
  const int MC = M / 4, NC = N / 2;
  for (int item = threadIdx.x; item < MC * NC; item += blockDim.x) {
    const int mi = item / NC, n = (item - mi * NC) * 2;
    // Offsets of the four rows within a column of A (AT) or of their starts (row-major A).
    const int am = AT ? 1 : lda, bs = BK ? 1 : ldb;  // step between the rows of A, the two columns of B
    float acc[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
    for (int k = 0; k < K; ++k) {
      const float* ak = AT ? A + k * lda + mi : A + mi * lda + k;
      const float* bk = BK ? B + k * ldb + n : B + n * ldb + k;
      const float b0 = bk[0], b1 = bk[bs];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = ak[i * MC * am];
        acc[i][0] += a * b0;
        acc[i][1] += a * b1;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) epi(mi + i * MC, n, acc[i][0], acc[i][1]);
  }
}

// C = A B handed to `epi` in pairs: on the tensor cores for bf16 panels, on the CUDA cores for
// float32 ones.
template <bool AT, bool BK, class Epi>
__device__ __forceinline__ void panel_mma(const bf16* A, int lda, const bf16* B, int ldb, int M,
                                          int N, int K, Epi epi) {
  tc_mma<AT, BK>(A, lda, B, ldb, M, N, K, epi);
}
template <bool AT, bool BK, class Epi>
__device__ __forceinline__ void panel_mma(const float* A, int lda, const float* B, int ldb, int M,
                                          int N, int K, Epi epi) {
  simt_mma<AT, BK>(A, lda, B, ldb, M, N, K, epi);
}

// dst(r, c) += (A B)(r, c) for r < Mv, c < Nv (see tc_mma_add), for either panel type.
template <bool AT, bool BK>
__device__ __forceinline__ void panel_mma_add(const bf16* A, int lda, const bf16* B, int ldb, int M,
                                              int N, int K, float* dst, size_t ldd, int Mv, int Nv) {
  tc_mma_add<AT, BK>(A, lda, B, ldb, M, N, K, dst, ldd, Mv, Nv);
}
template <bool AT, bool BK>
__device__ __forceinline__ void panel_mma_add(const float* A, int lda, const float* B, int ldb,
                                              int M, int N, int K, float* dst, size_t ldd, int Mv,
                                              int Nv) {
  simt_mma<AT, BK>(A, lda, B, ldb, M, N, K, [=](int r, int c, float v0, float v1) {
    if (r < Mv && c < Nv) dst[(size_t)r * ldd + c] += v0;
    if (r < Mv && c + 1 < Nv) dst[(size_t)r * ldd + c + 1] += v1;
  });
}

// Asynchronous 8-byte copy from device to shared memory; `valid` false fills the 8 bytes with zeros.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// Stage a (rows, cols) block of a row-major matrix of T (leading dimension ld) into a shared
// panel (rows_p, cols_p) with leading dimension lds, zeros past (rows, cols), by all the
// block's threads: asynchronous 8-byte copies where ld and cols are multiples of their
// element count (the source then 8-byte aligned; the caller commits the group and waits for
// it before the next barrier), plain loads otherwise (visible after the next barrier).
template <typename T>
__device__ __forceinline__ void stage(T* dst, int lds, const T* src, size_t ld, int rows, int cols,
                                      int rows_p, int cols_p) {
  constexpr int U = 8 / sizeof(T);  // elements per copy
  if (ld % U == 0 && cols % U == 0) {
    const int q = cols_p / U;
    for (int i = threadIdx.x; i < rows_p * q; i += blockDim.x) {
      const int r = i / q, c = (i - r * q) * U;
      const bool valid = r < rows && c < cols;
      cp_async8(dst + (size_t)r * lds + c, valid ? src + (size_t)r * ld + c : src, valid);
    }
    return;
  }
  for (int i = threadIdx.x; i < rows_p * cols_p; i += blockDim.x) {
    const int r = i / cols_p, c = i - r * cols_p;
    dst[(size_t)r * lds + c] = (r < rows && c < cols) ? src[(size_t)r * ld + c] : from_f<T>(0.f);
  }
}

// Store two neighbouring values, rounded to the panel's type.
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  p[0] = a;
  p[1] = b;
}

// sum_d a[d] b[d] over two rows, in order of d. bf16: 16 bytes at a time where D is a multiple of 8
// (both rows 16-byte aligned; with a row stride of an odd number of 16-byte units the lanes of a
// warp reading one row each do not share banks), else 4 bytes at a time (D even).
__device__ __forceinline__ float dot_rows(const bf16* a, const bf16* b, int D) {
  float s = 0.f;
  if (D % 8 == 0) {
    for (int d = 0; d < D; d += 8) {
      const uint4 ua = *reinterpret_cast<const uint4*>(a + d);
      const uint4 ub = *reinterpret_cast<const uint4*>(b + d);
      const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&ua);
      const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&ub);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 fa = __bfloat1622float2(pa[u]), fb = __bfloat1622float2(pb[u]);
        s += fa.x * fb.x;
        s += fa.y * fb.y;
      }
    }
  } else {
    for (int d = 0; d < D; d += 2) {
      const float2 fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a + d));
      const float2 fb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b + d));
      s += fa.x * fb.x;
      s += fa.y * fb.y;
    }
  }
  return s;
}

__device__ __forceinline__ float dot_rows(const float* a, const float* b, int D) {
  float s = 0.f;
  for (int d = 0; d < D; ++d) s += a[d] * b[d];
  return s;
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
