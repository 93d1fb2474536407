// Shared helpers for the port's CUDA kernels: float <-> storage-type
// conversion and rounding through the storage type (bf16 or float), the
// register-blocked product `mm` of the online-softmax kernels, the tensor-core
// products and staging of the staged kernels (bf16 through mma.sync m16n8k16,
// float32 in the temporal kernels in split-precision TF32), the warp-level
// attention fragments, and the reduction of per-CTA weight-gradient partials.
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
// A byte offset rounded up to 16 (shared-memory layouts).
__host__ __device__ inline size_t al16(size_t b) { return (b + 15) / 16 * 16; }

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

// The halves of a bf16 pair of B rows (k, k + 1) to keep where only the keys [kb, ke) enter a sum.
__device__ __forceinline__ unsigned key_mask(int k, int kb, int ke) {
  return (k >= kb && k < ke ? 0x0000ffffu : 0u) | (k + 1 >= kb && k + 1 < ke ? 0xffff0000u : 0u);
}

// mma_block<false, true> over the keys [kb, ke) alone: B's rows outside them are read as zeros (their halves of
// the ldmatrix fragments cleared), so that no product reaches them (0 x NaN would be a NaN). The 16-deep steps are
// mma_block's from k = 0, the ones that meet [kb, ke); for finite B the sums equal mma_block's over the whole K.
__device__ __forceinline__ void mma_keys(const bf16* A, int lda, const bf16* B, int ldb, int m0, int n0, int kb,
                                         int ke, float (&acc)[2][4]) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int a_r = lane & 15, a_c = (lane >> 4) << 3;
  const int b_r = (lane & 7) + (((lane >> 3) & 1) << 3), b_c = (lane >> 4) << 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int k0 = kb & ~15; k0 < ke; k0 += 16) {
    unsigned a[4], b[4];
    ldsm_x4(a, A + (size_t)(m0 + a_r) * lda + k0 + a_c);
    ldsm_x4_t(b, B + (size_t)(k0 + b_r) * ldb + n0 + b_c);
    // b[0] and b[2] hold the keys k0 + 2t and k0 + 2t + 1 (low and high half), b[1] and b[3] those 8 further
    const unsigned lo = key_mask(k0 + 2 * t, kb, ke), hi = key_mask(k0 + 8 + 2 * t, kb, ke);
    mma_bf16(acc[0], a, b[0] & lo, b[1] & hi);
    mma_bf16(acc[1], a, b[2] & lo, b[3] & hi);
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

// The same two products for float32 panels, on the CUDA cores (the spatial and cross kernels' float32 products;
// the temporal kernels take `tensor_mma`, below, in 3xTF32): each thread owns four rows
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

// ---------------------------------------------------------------------------
// Split-precision TF32 ("3xTF32") on the tensor cores, for float32 operands.
//
// `mma.sync.m16n8k8` in TF32 with float32 accumulators; each operand a is split into a_hi = tf32(a)
// (round to nearest) and a_lo = a - a_hi, which the tensor cores read to TF32 by truncation, and a
// product takes three TF32 products lo*hi + hi*lo + hi*hi. What is left out (lo*lo and lo's
// truncation) is about 2^-21 of each product, inside the float32 gates; single-pass TF32 (2^-11) is not. The m16n8k8 accumulator fragment has
// the m16n8k16 one's layout: element e of n8 block j at row (lane >> 2) + 8 * (e >> 1), column
// 8 * j + 2 * (lane & 3) + (e & 1).

// v rounded to TF32 (10 mantissa bits; round to nearest, ties away from zero): the bits of
// `cvt.rna.tf32.f32` for every finite v, in two integer operations (half a TF32 unit added, the 13
// low bits cleared), which cost the kernels less than the conversion. Not for a NaN: the GPU's NaN
// 0x7fffffff carries into the sign bit and comes out -0.
__device__ __forceinline__ unsigned tf32(float v) { return (__float_as_uint(v) + 0x1000u) & 0xffffe000u; }

// lo is left whole: rounding it too cost the split-bound kernels 2-5% (PERF.md §6, PR 22), and a guard
// for NaN on both halves 24-55%. A NaN v gives a NaN lo (v - hi), so every product with it is a NaN.
__device__ __forceinline__ void split(float v, unsigned& hi, unsigned& lo) {
  hi = tf32(v);
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32: the two small terms first, then hi * hi, into a fresh accumulator that is then added to
// c on the CUDA cores. The tensor cores round toward zero where they add into an accumulator, so a sum kept
// in one over a long K drifts by up to an ulp a step; added here, each 8-deep step rounds to nearest.
__device__ __forceinline__ void mma3(float (&c)[4], const unsigned (&ah)[4], const unsigned (&al)[4],
                                     const unsigned (&bh)[2], const unsigned (&bl)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, al, bh[0], bh[1]);
  mma_tf32(t, ah, bl[0], bl[1]);
  mma_tf32(t, ah, bh[0], bh[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
}

__device__ __forceinline__ void split4(const float (&v)[4], unsigned (&hi)[4], unsigned (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(v[e], hi[e], lo[e]);
}

// An A fragment (16 x 8) of a row-major float panel at (row 0, column 0 of `a`), split.
__device__ __forceinline__ void frag_a(const float* a, int ld, unsigned (&hi)[4], unsigned (&lo)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float v[4] = {a[g * ld + t], a[(g + 8) * ld + t], a[g * ld + t + 4], a[(g + 8) * ld + t + 4]};
  split4(v, hi, lo);
}

// The same fragment with the k index of the 8-step permuted (k = t taken from column 2t, k = t + 4 from
// 2t + 1): each row's two values are one 8-byte load (ld even, `a` 8-byte aligned). The other operand of the
// product takes the same order.
__device__ __forceinline__ void frag_a_pair(const float* a, int ld, unsigned (&hi)[4], unsigned (&lo)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float2 r0 = *reinterpret_cast<const float2*>(a + g * ld + 2 * t);
  const float2 r1 = *reinterpret_cast<const float2*>(a + (g + 8) * ld + 2 * t);
  const float v[4] = {r0.x, r1.x, r0.y, r1.y};
  split4(v, hi, lo);
}

// s (16 x 8NJ) = A (16 rows at `a`) B^T, B's 8NJ rows at `b`, over DP columns of both (row-major panels).
// PAIR: the k order of `frag_a_pair`, for panels whose leading dimensions are 8 mod 32 floats (no bank
// conflict for the 8-byte loads, where one-float loads at row stride 8 mod 32 would conflict two ways).
template <int NJ, int DP, bool PAIR = false>
__device__ __forceinline__ void nt3(float (&s)[NJ][4], const float* a, int lda, const float* b, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < DP; k0 += 8) {
    unsigned ah[4], al[4];
    if (PAIR) frag_a_pair(a + k0, lda, ah, al);
    else frag_a(a + k0, lda, ah, al);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      unsigned bh[2], bl[2];
      if (PAIR) {
        const float2 v = *reinterpret_cast<const float2*>(b + (8 * j + g) * ldb + k0 + 2 * t);
        split(v.x, bh[0], bl[0]);
        split(v.y, bh[1], bl[1]);
      } else {
        split(b[(8 * j + g) * ldb + k0 + t], bh[0], bl[0]);
        split(b[(8 * j + g) * ldb + k0 + t + 4], bh[1], bl[1]);
      }
      mma3(s[j], ah, al, bh, bl);
    }
  }
}

// o (16 x 8NB) += P (16 x 8KC, accumulator fragments) B, B's 8KC rows at `b` (row-major, 8NB columns).
// The k index of each 8-step is taken in the accumulator's column order (lane quad t holds columns
// 2t and 2t + 1), so P's fragments serve as the A operand as they are and B's rows are read alike.
template <int NB, int KC>
__device__ __forceinline__ void pv3(float (&o)[NB][4], const float (&p)[KC][4], const float* b, int ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    const float v[4] = {p[j][0], p[j][2], p[j][1], p[j][3]};
    unsigned ah[4], al[4];
    split4(v, ah, al);
    const float* b0 = b + (8 * j + 2 * t) * ld + g;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      unsigned bh[2], bl[2];
      split(b0[8 * n], bh[0], bl[0]);
      split(b0[ld + 8 * n], bh[1], bl[1]);
      mma3(o[n], ah, al, bh, bl);
    }
  }
}

// One warp's 16 x 8NJ strip (m0, n0) of C = A B in 3xTF32, the float32 counterpart of `mma_block` (NJ = 2):
// A stored (M, K) with leading dimension lda, or with AT as (K, M); B stored (K, N) with BK, or (N, K)
// without; K a multiple of 8. Where A is stored along k (not AT) the k order of `frag_a_pair` is taken, so A's
// rows load 8 bytes at a time, and B's too where it is stored (N, K); the panels' leading dimensions are 8
// mod 32 floats (`pad_ld`), where these loads, and the one-float loads along M or N, do not conflict. The NJ
// n8 blocks share each split A fragment and are NJ independent chains of products.
template <bool AT, bool BK, int NJ>
__device__ __forceinline__ void mma3_strip(const float* A, int lda, const float* B, int ldb, int m0, int n0,
                                           int K, float (&acc)[NJ][4]) {
  constexpr bool PAIR = !AT;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kl = PAIR ? 2 * t : t, kh = PAIR ? 2 * t + 1 : t + 4;  // the fragments' two k of the lane
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int k0 = 0; k0 < K; k0 += 8) {
    unsigned ah[4], al[4];
    if (AT) {
      const float* a = A + (size_t)k0 * lda + m0 + g;
      const float v[4] = {a[kl * lda], a[kl * lda + 8], a[kh * lda], a[kh * lda + 8]};
      split4(v, ah, al);
    } else {
      frag_a_pair(A + (size_t)m0 * lda + k0, lda, ah, al);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = n0 + 8 * j + g;
      float b0, b1;
      if (BK) {
        b0 = B[(size_t)(k0 + kl) * ldb + n];
        b1 = B[(size_t)(k0 + kh) * ldb + n];
      } else if (PAIR) {
        const float2 v = *reinterpret_cast<const float2*>(B + (size_t)n * ldb + k0 + 2 * t);
        b0 = v.x;
        b1 = v.y;
      } else {
        b0 = B[(size_t)n * ldb + k0 + t];
        b1 = B[(size_t)n * ldb + k0 + t + 4];
      }
      unsigned bh[2], bl[2];
      split(b0, bh[0], bl[0]);
      split(b1, bh[1], bl[1]);
      mma3(acc[j], ah, al, bh, bl);
    }
  }
}

// One warp's 16 x 16 block (m0, n0) of A B in 3xTF32 over the keys [kb, ke) alone: A (16 rows at m0, row-major,
// leading dimension lda; the k order of `frag_a_pair`) times B (K, N) row-major, whose rows outside [kb, ke) are read
// as zeros, so that no product reaches them (0 x NaN would be a NaN). The 8-deep steps are those of `mma3_strip`
// from k = 0, the ones that meet [kb, ke); for finite B the sums equal `mma3_strip`'s over the whole K.
__device__ __forceinline__ void mma3_keys(const float* A, int lda, const float* B, int ldb, int m0, int n0, int kb,
                                          int ke, float (&acc)[2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int k0 = kb & ~7; k0 < ke; k0 += 8) {
    unsigned ah[4], al[4];
    frag_a_pair(A + (size_t)m0 * lda + k0, lda, ah, al);
    const int k_lo = k0 + 2 * t, k_hi = k_lo + 1;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + 8 * j + g;
      const float b0 = k_lo >= kb && k_lo < ke ? B[(size_t)k_lo * ldb + n] : 0.f;
      const float b1 = k_hi >= kb && k_hi < ke ? B[(size_t)k_hi * ldb + n] : 0.f;
      unsigned bh[2], bl[2];
      split(b0, bh[0], bl[0]);
      split(b1, bh[1], bl[1]);
      mma3(acc[j], ah, al, bh, bl);
    }
  }
}

// C = A B in 3xTF32 by all the warps of the block, each owning 16 x 8NJ strips round robin; every pair of
// neighbouring outputs goes to `epi(row, col, v0, v1)` exactly once (as tc_mma). M, N multiples of 16.
template <bool AT, bool BK, int NJ, class Epi>
__device__ __forceinline__ void tf3_strips(const float* A, int lda, const float* B, int ldb, int M, int N, int K,
                                           Epi epi) {
  constexpr int BN = 8 * NJ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int blk = warp; blk < (M / 16) * (N / BN); blk += nwarps) {
    const int m0 = (blk / (N / BN)) * 16, n0 = (blk % (N / BN)) * BN;
    float acc[NJ][4];
    mma3_strip<AT, BK, NJ>(A, lda, B, ldb, m0, n0, K, acc);
    const int r = m0 + (lane >> 2), c = n0 + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      epi(r, c + 8 * j, acc[j][0], acc[j][1]);
      epi(r + 8, c + 8 * j, acc[j][2], acc[j][3]);
    }
  }
}

// tc_mma for float32 panels in 3xTF32: strips of 16 x 32 where they still give every warp one, else 16 x 16.
template <bool AT, bool BK, class Epi>
__device__ __forceinline__ void tf3_mma(const float* A, int lda, const float* B, int ldb, int M, int N, int K,
                                        Epi epi) {
  if (N % 32 == 0 && (M / 16) * (N / 32) >= (int)(blockDim.x >> 5)) tf3_strips<AT, BK, 4>(A, lda, B, ldb, M, N, K, epi);
  else tf3_strips<AT, BK, 2>(A, lda, B, ldb, M, N, K, epi);
}

// tc_mma_add for float32 panels: dst(r, c) += (A B)(r, c) for r < Mv, c < Nv (shared or device memory; each
// element belongs to one thread).
template <bool AT, bool BK>
__device__ __forceinline__ void tf3_mma_add(const float* A, int lda, const float* B, int ldb, int M, int N,
                                            int K, float* dst, size_t ldd, int Mv, int Nv) {
  tf3_mma<AT, BK>(A, lda, B, ldb, M, N, K, [=](int r, int c, float v0, float v1) {
    if (r < Mv && c < Nv) dst[(size_t)r * ldd + c] += v0;
    if (r < Mv && c + 1 < Nv) dst[(size_t)r * ldd + c + 1] += v1;
  });
}

// *p += v in device memory without waiting for it (`red`: the warp goes on; the add completes in L2). Where
// each element of a CTA's partial is added to by one thread only, its adds take that thread's program order,
// so the sums stay in a fixed order and two runs are bit-equal.
__device__ __forceinline__ void red_add(float* p, float v) {
  asm volatile("red.global.add.f32 [%0], %1;\n" ::"l"(p), "f"(v) : "memory");
}

// tf3_mma_add into a CTA's float32 partial in device memory, through `red_add`: the read-modify-write of each
// element no longer stalls the warp that owns it. A given (M, N) gives each element the same thread at every
// call, so each element's adds keep one order.
template <bool AT, bool BK>
__device__ __forceinline__ void tf3_mma_red(const float* A, int lda, const float* B, int ldb, int M, int N,
                                            int K, float* dst, size_t ldd, int Mv, int Nv) {
  tf3_mma<AT, BK>(A, lda, B, ldb, M, N, K, [=](int r, int c, float v0, float v1) {
    if (r < Mv && c < Nv) red_add(dst + (size_t)r * ldd + c, v0);
    if (r < Mv && c + 1 < Nv) red_add(dst + (size_t)r * ldd + c + 1, v1);
  });
}

// The attention core of temporal_tf32x3.cu (`attn_bwd_kernel`): shared memory for one (token, head) at f frames
// and head dim padded to dp, its four (round32(f), dp + 4) panels and its row statistics.
__host__ __device__ constexpr int round32(int n) { return (n + 31) / 32 * 32; }

__host__ __device__ inline size_t attn_smem(int f, int dp) {
  return sizeof(float) * ((size_t)4 * round32(f) * (dp + 4) + 2 * round32(f));
}

// The float32 backward design of temporal_tf32x3.cu takes head dims up to 64 and lengths whose attention core
// fits (ops/temporal_attention.py `_tf32x3_fits`).
__host__ __device__ inline bool tf32x3_fits(int f, int dim) {
  return f >= 1 && dim >= 1 && dim <= 64 && attn_smem(f, dim <= 32 ? 32 : 64) <= kSmemMax;
}

// Where both 3xTF32 designs take a float32 backward, the faster by measurement on the H100 (PERF.md, PR 22):
// the staged dense kernel up to c = 64 at f <= 64, the streaming kernel up to c = 32 at f > 64; wider columns
// the chain of temporal_tf32x3.cu, whose GEMMs keep no c-wide panel and whose grid follows tokens x heads.
// Measured at the recipes' shapes alone (PERF.md §6): off them (few tokens at a small c) it may pick the slower.
// ops/temporal_attention.py `_f32_takes_tf32x3` is the same rule; the staged and streaming C entries refuse a
// float32 shape it gives to the other design, except in a build with VDT_ANY_F32_ROUTE defined, which
// scripts/torch_f32_bwd_routes.py makes to time each design at every shape (`_build.library(name, defines)`).
__host__ __device__ inline bool f32_takes_tf32x3(int f, int c, int dim) {
  return tf32x3_fits(f, dim) && c > (f <= 64 ? 64 : 32);
}
#ifdef VDT_ANY_F32_ROUTE
constexpr bool kF32RuleChecked = false;
#else
constexpr bool kF32RuleChecked = true;
#endif

// The temporal kernels' width-scaling products, forward and backward, on the tensor cores in either type: bf16
// panels through tc_mma / tc_mma_add, float32 panels in 3xTF32. (The spatial and cross kernels keep `panel_mma`,
// whose float32 products run on the CUDA cores.)
template <bool AT, bool BK, class Epi>
__device__ __forceinline__ void tensor_mma(const bf16* A, int lda, const bf16* B, int ldb, int M, int N, int K,
                                        Epi epi) {
  tc_mma<AT, BK>(A, lda, B, ldb, M, N, K, epi);
}
template <bool AT, bool BK, class Epi>
__device__ __forceinline__ void tensor_mma(const float* A, int lda, const float* B, int ldb, int M, int N, int K,
                                        Epi epi) {
  tf3_mma<AT, BK>(A, lda, B, ldb, M, N, K, epi);
}
template <bool AT, bool BK>
__device__ __forceinline__ void tensor_mma_add(const bf16* A, int lda, const bf16* B, int ldb, int M, int N,
                                            int K, float* dst, size_t ldd, int Mv, int Nv) {
  tc_mma_add<AT, BK>(A, lda, B, ldb, M, N, K, dst, ldd, Mv, Nv);
}
template <bool AT, bool BK>
__device__ __forceinline__ void tensor_mma_add(const float* A, int lda, const float* B, int ldb, int M, int N,
                                            int K, float* dst, size_t ldd, int Mv, int Nv) {
  tf3_mma_add<AT, BK>(A, lda, B, ldb, M, N, K, dst, ldd, Mv, Nv);
}
// tensor_mma_add into a CTA's float32 weight-gradient partial in device memory: bf16 as tc_mma_add, float32
// through `tf3_mma_red`.
template <bool AT, bool BK>
__device__ __forceinline__ void tensor_mma_red(const bf16* A, int lda, const bf16* B, int ldb, int M, int N,
                                            int K, float* dst, size_t ldd, int Mv, int Nv) {
  tc_mma_add<AT, BK>(A, lda, B, ldb, M, N, K, dst, ldd, Mv, Nv);
}
template <bool AT, bool BK>
__device__ __forceinline__ void tensor_mma_red(const float* A, int lda, const float* B, int ldb, int M, int N,
                                            int K, float* dst, size_t ldd, int Mv, int Nv) {
  tf3_mma_red<AT, BK>(A, lda, B, ldb, M, N, K, dst, ldd, Mv, Nv);
}
// One warp's 16 x 16 block (m0, n0) of A B, A stored (M, K) row-major, B stored (K, N) with BK, else (N, K): bf16
// panels through mma_block, float32 ones in 3xTF32 (`mma3_strip`). K a multiple of 16.
template <bool BK>
__device__ __forceinline__ void tensor_block(const bf16* A, int lda, const bf16* B, int ldb, int m0, int n0, int K,
                                             float (&acc)[2][4]) {
  mma_block<false, BK>(A, lda, B, ldb, m0, n0, K, acc);
}
template <bool BK>
__device__ __forceinline__ void tensor_block(const float* A, int lda, const float* B, int ldb, int m0, int n0, int K,
                                             float (&acc)[2][4]) {
  mma3_strip<false, BK, 2>(A, lda, B, ldb, m0, n0, K, acc);
}
// One warp's 16 x 16 block (m0, n0) of A B over the keys [kb, ke) alone, B (K, N) row-major with its other rows
// read as zeros: bf16 panels through mma_keys, float32 ones in 3xTF32 (`mma3_keys`).
__device__ __forceinline__ void tensor_keys(const bf16* A, int lda, const bf16* B, int ldb, int m0, int n0, int kb,
                                            int ke, float (&acc)[2][4]) {
  mma_keys(A, lda, B, ldb, m0, n0, kb, ke, acc);
}
__device__ __forceinline__ void tensor_keys(const float* A, int lda, const float* B, int ldb, int m0, int n0, int kb,
                                            int ke, float (&acc)[2][4]) {
  mma3_keys(A, lda, B, ldb, m0, n0, kb, ke, acc);
}

// Asynchronous 8-byte copy from device to shared memory; `valid` false fills the 8 bytes with zeros.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 8 : 0));
}
// Asynchronous 16-byte copy from device to shared memory, bypassing L1 (data read once); `valid` false
// fills the 16 bytes with zeros. Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
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

// ---------------------------------------------------------------------------
// Warp-level attention fragments (flash-attention style), shared by the streaming temporal kernels
// and the cross-attention kernels: each warp owns 16 query rows and keeps S, P and its accumulators in
// m16n8k16 fragments. In float32 `warp_nt` / `warp_pv` compute the same fragments on the CUDA cores (the
// cross kernels); the temporal kernels take `tensor_nt` / `tensor_pv`, in 3xTF32.

// Per-lane place of an m16n8k16 accumulator fragment: element e of n8 block j lies at row
// (lane >> 2) + 8 * (e >> 1), column 8 * j + 2 * (lane & 3) + (e & 1).

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// s (16 x 8NB) = A (16 rows) B (8NB rows)^T over K, both row-major panels in shared memory.
template <int NB>
__device__ __forceinline__ void warp_nt(float (&s)[NB][4], const bf16* A, int lda, const bf16* B, int ldb,
                                        int K) {
  const int lane = threadIdx.x & 31;
  const int a_r = lane & 15, a_c = (lane >> 4) << 3;
  const int b_r = (lane & 7) + ((lane >> 4) << 3), b_c = ((lane >> 3) & 1) << 3;
#pragma unroll
  for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  for (int k0 = 0; k0 < K; k0 += 16) {
    unsigned a[4];
    ldsm_x4(a, A + (size_t)a_r * lda + k0 + a_c);
#pragma unroll
    for (int jb = 0; jb < NB / 2; ++jb) {
      unsigned b[4];
      ldsm_x4(b, B + (size_t)(16 * jb + b_r) * ldb + k0 + b_c);
      mma_bf16(s[2 * jb], a, b[0], b[1]);
      mma_bf16(s[2 * jb + 1], a, b[2], b[3]);
    }
  }
}

template <int NB>
__device__ __forceinline__ void warp_nt(float (&s)[NB][4], const float* A, int lda, const float* B, int ldb,
                                        int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  const float* a0 = A + (size_t)g * lda;
  const float* a1 = A + (size_t)(g + 8) * lda;
  const float* b0 = B + (size_t)(2 * q) * ldb;
  for (int k = 0; k < K; ++k) {
    const float x0 = a0[k], x1 = a1[k];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float y0 = b0[(size_t)(8 * j) * ldb + k], y1 = b0[(size_t)(8 * j + 1) * ldb + k];
      s[j][0] += x0 * y0;
      s[j][1] += x0 * y1;
      s[j][2] += x1 * y0;
      s[j][3] += x1 * y1;
    }
  }
}

// o (16 x 8NB) += P (16 x 8KC, accumulator fragments holding values already rounded to x's type)
// B (8KC rows, 8NB columns, row-major in shared memory). bf16: P packs into the A fragments; float:
// P goes through the warp's scratch (16 x (8KC + 4) floats).
template <int NB, int KC>
__device__ __forceinline__ void warp_pv(float (&o)[NB][4], const float (&p)[KC][4], const bf16* B, int ldb,
                                        float*) {
  const int lane = threadIdx.x & 31;
  const int b_r = (lane & 7) + (((lane >> 3) & 1) << 3), b_c = (lane >> 4) << 3;
#pragma unroll
  for (int t = 0; t < KC / 2; ++t) {
    const unsigned a[4] = {pack_bf16(p[2 * t][0], p[2 * t][1]), pack_bf16(p[2 * t][2], p[2 * t][3]),
                           pack_bf16(p[2 * t + 1][0], p[2 * t + 1][1]),
                           pack_bf16(p[2 * t + 1][2], p[2 * t + 1][3])};
#pragma unroll
    for (int jb = 0; jb < NB / 2; ++jb) {
      unsigned b[4];
      ldsm_x4_t(b, B + (size_t)(16 * t + b_r) * ldb + 16 * jb + b_c);
      mma_bf16(o[2 * jb], a, b[0], b[1]);
      mma_bf16(o[2 * jb + 1], a, b[2], b[3]);
    }
  }
}

template <int NB, int KC>
__device__ __forceinline__ void warp_pv(float (&o)[NB][4], const float (&p)[KC][4], const float* B, int ldb,
                                        float* scr) {
  constexpr int LD = 8 * KC + 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  __syncwarp();  // the warp is done reading the scratch's previous contents
#pragma unroll
  for (int j = 0; j < KC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) scr[(g + 8 * (e >> 1)) * LD + 8 * j + 2 * q + (e & 1)] = p[j][e];
  __syncwarp();
  const float* a0 = scr + g * LD;
  const float* a1 = scr + (g + 8) * LD;
  for (int k = 0; k < 8 * KC; ++k) {
    const float x0 = a0[k], x1 = a1[k];
    const float* b = B + (size_t)k * ldb + 2 * q;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float y0 = b[8 * j], y1 = b[8 * j + 1];
      o[j][0] += x0 * y0;
      o[j][1] += x0 * y1;
      o[j][2] += x1 * y0;
      o[j][3] += x1 * y1;
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Sum over the 16 rows of a fragment's columns: on return lanes 0-3 hold, for each n8 block j, the
// sums of columns 8j + 2 * lane and 8j + 2 * lane + 1 in cs[j][0], cs[j][1].
template <int NB>
__device__ __forceinline__ void column_sums(const float (&a)[NB][4], float (&cs)[NB][2]) {
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float v = a[j][u] + a[j][u + 2];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      cs[j][u] = v;
    }
}

// The streaming temporal kernels' attention fragments, forward and backward: bf16 as warp_nt / warp_pv, float32
// in 3xTF32 with P kept in registers (no scratch). K is the depth of s = A B^T (a multiple of 8); the float32 panels' leading
// dimensions are even and 8 mod 32 floats (`pad_ld`), for `nt3`'s 8-byte loads.
template <int NB, int K>
__device__ __forceinline__ void tensor_nt(float (&s)[NB][4], const bf16* A, int lda, const bf16* B, int ldb) {
  warp_nt<NB>(s, A, lda, B, ldb, K);
}
template <int NB, int K>
__device__ __forceinline__ void tensor_nt(float (&s)[NB][4], const float* A, int lda, const float* B, int ldb) {
  nt3<NB, K, true>(s, A, lda, B, ldb);
}
template <int NB, int KC>
__device__ __forceinline__ void tensor_pv(float (&o)[NB][4], const float (&p)[KC][4], const bf16* B, int ldb) {
  warp_pv<NB, KC>(o, p, B, ldb, nullptr);
}
template <int NB, int KC>
__device__ __forceinline__ void tensor_pv(float (&o)[NB][4], const float (&p)[KC][4], const float* B, int ldb) {
  pv3<NB, KC>(o, p, B, ldb);
}

// The online-softmax sweep of one head for 16 query rows (one warp): q (16 rows, leading dimension ldq)
// against the F keys k and values v (rows of leading dimension ldkv; whole KV blocks of rows, zero past
// F). On return o holds sum_j round(exp(s_j - m)) v_j with l the row sums of the unrounded exp
// (BLOCKWISE, KV blocks of 32), or round(P) V with P = exp(s - m) / l normalised before its rounding
// (DENSE, one block of all keys); m and l for the lane's rows g and g + 8. `bias_h` (F, F), where given,
// is added to the logits of rows m0 + g and m0 + g + 8 below F. TF3 takes the temporal kernels' fragments
// (`tensor_nt`, `tensor_pv`: float32 in 3xTF32, no scratch); the cross kernels keep `warp_nt` / `warp_pv`, whose
// float32 P goes through `scr`.
template <typename T, bool DENSE, int DP, bool TF3 = false>
__device__ __forceinline__ void sweep_rows(const T* q, int ldq, const T* k, const T* v, int ldkv, int F,
                                           int m0, const float* bias_h, float (&o)[DP / 8][4],
                                           float (&m)[2], float (&l)[2], float* scr) {
  constexpr int KB = DENSE ? 64 : 32, KC = KB / 8, NB = DP / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, qd = lane & 3;
#pragma unroll
  for (int j = 0; j < NB; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  m[0] = m[1] = -1e30f;
  l[0] = l[1] = 0.f;
  for (int kb0 = 0; kb0 < F; kb0 += KB) {
    float s[KC][4];
    if (TF3) tensor_nt<KC, DP>(s, q, ldq, k + (size_t)kb0 * ldkv, ldkv);
    else warp_nt<KC>(s, q, ldq, k + (size_t)kb0 * ldkv, ldkv, DP);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < KC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + g + 8 * (e >> 1), key = kb0 + 8 * j + 2 * qd + (e & 1);
        float t = s[j][e];
        if (key >= F) t = -INFINITY;
        else if (bias_h && row < F) t += bias_h[(size_t)row * F + key];
        s[j][e] = t;
        mx[e >> 1] = fmaxf(mx[e >> 1], t);
      }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    float sum[2] = {0.f, 0.f};
    if (DENSE) {
#pragma unroll
      for (int j = 0; j < KC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - mx[e >> 1]);
          sum[e >> 1] += s[j][e];
        }
      for (int i = 0; i < 2; ++i) {
        m[i] = mx[i];
        l[i] = quad_sum(sum[i]);
      }
#pragma unroll
      for (int j = 0; j < KC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = rnd<T>(s[j][e] / l[e >> 1]);
    } else {
      float mn[2], alpha[2];
      for (int i = 0; i < 2; ++i) {
        mn[i] = fmaxf(m[i], mx[i]);
        alpha[i] = expf(m[i] - mn[i]);
      }
#pragma unroll
      for (int j = 0; j < KC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ev = expf(s[j][e] - mn[e >> 1]);
          sum[e >> 1] += ev;
          s[j][e] = rnd<T>(ev);
        }
      for (int i = 0; i < 2; ++i) {
        l[i] = l[i] * alpha[i] + quad_sum(sum[i]);
        m[i] = mn[i];
      }
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
    }
    if (TF3) tensor_pv<NB, KC>(o, s, v + (size_t)kb0 * ldkv, ldkv);
    else warp_pv<NB, KC>(o, s, v + (size_t)kb0 * ldkv, ldkv, scr);
  }
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
