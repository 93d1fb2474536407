// The float32 temporal-attention backward on the tensor cores, for Hopper (sm_90a): split-precision
// TF32 ("3xTF32") products in a short chain of kernels.
//
// Replaces, for float32 only, the TPU kernels of video_diffusion_nnx_tpu/ops/temporal_attention.py
// `_bwd_kernel` (line 175; with `bias_ref`, `dbias_ref` at :204-205, :245-248) where the staged dense
// tile of temporal_attention.cu does not fit one token (D2's temporal attention, f = 10 at c = 384 and
// head dim 64; the fixed flagship's bottleneck, f = 64 at c = 256), and `_bwd_blockwise_kernel`
// (line 432; biased at :512-513, :530-535) where the streaming plan of temporal_blockwise.cu does not
// fit (f >= 145 at head dim 32, as D1's spatial attention over 256 patches). Those shapes ran the
// first-design kernels there: scalar FP32 products on the CUDA cores, whole float32 row panels in
// shared memory, and grids capped below the SM count by a full weight-gradient partial per CTA.
//
// The function is the block's backward: with q|k|v = x W_qkv + b_qkv (q scaled by 1/sqrt(D)),
// P = softmax(q k^T [+ bias]) per head, o = P v, y = o W_o + b_o and g = dL/d(x + y):
//     do = g W_o^T, dW_o = o^T g, db_o = sum g,
//     ds = P (do v^T - rowsum(do o)), dq = ds k scale, dk = ds^T q, dv = P^T do,
//     dW_qkv = x^T dqkv, db_qkv = sum dqkv, dx = g + dqkv W_qkv^T, dbias = sum over tokens of ds.
// In float32 every rounding point of the TPU kernels is the identity, so the dense and the blockwise
// backward are one function; the plain oracles beside the wrapper hold this chain to it.
//
// What bounds it: at D1's shape (8, 16, 256, 256) 73 GFLOP (the width-scaling products 22 c HD per
// row, attention 12 f HD) and about 0.2 GB to move; at D2's and the fixed bottleneck's, 8.4 GFLOP each.
// All are operation-bound: 1.09 / 0.126 / 0.125 ms at 67 TFLOP/s on the CUDA cores, a third of that at
// the 3xTF32 tensor-core rate (495 / 3 = 165 TFLOP/s).
//
// Design.
// - Products: `mma.sync.m16n8k8` in TF32 with float32 accumulators, each operand a split into
//   a_hi = tf32(a) (round to nearest) and a_lo = a - a_hi (read to TF32 by truncation), and three
//   products lo*hi + hi*lo + hi*hi per step. What is left out (lo*lo and lo's truncation) is about
//   2^-21 of each product, inside the float32 gates; single-pass TF32 (2^-11) is not. The split, the
//   product and the warp fragments (`split`, `mma3`, `nt3`, `pv3`) live in common.cuh, shared with the
//   staged dense and the streaming backwards, whose float32 products take the same math.
// - The width-scaling products are GEMMs through device memory (`gemm3_kernel`): q|k|v = x W_qkv + b,
//   do = g W_o^T, dW_qkv = x^T dqkv, dW_o = o^T g and dx = g + dqkv W_qkv^T. Each streams its K
//   dimension through a three-slot `cp.async` ring of 128 x 32 float32 tiles, so no panel of c columns
//   is ever resident. The weight gradients (K = the rows of every token) split K over CTAs so that the
//   grid is about two CTAs per SM whatever the token count, each split writing a float32 partial that
//   `reduce_partials_kernel` sums in split order.
// - The attention core (`attn_bwd_kernel`) takes one (token, head) per CTA: q, k, v and do of that
//   head (f x D each) in shared memory, never the c-wide rows. A FlashAttention-2-style backward over
//   16-row blocks: query-row warps rebuild the online softmax (lse, o, di = rowsum(do o)) and then dq;
//   after one barrier key-row warps walk the query blocks for dk and dv (and dbias). The products take
//   the score fragments straight from the accumulators (the k index of P v is permuted to the
//   accumulator's column order, so no shuffle is needed). dq|dk|dv overwrite q|k|v and o overwrites do
//   in device memory: each (token, head) reads its panels before it writes the same addresses.
// - Deterministic: every sum runs in a fixed order (splits and dbias partials reduced in index order).
//
// Fit rule (`tf32x3_fits` in common.cuh, ops/temporal_attention.py `_tf32x3_fits` alike): head dim <= 64
// and the attention core's four (round32(f), D + 4) panels fit 227 KB: f <= 384 at head dim 32, f <= 192 at
// 64. Where the staged dense or the streaming float32 backward also takes a shape, `f32_takes_tf32x3` (the
// measured rule, common.cuh) decides.
// The GEMMs take any shape; a leading dimension that is not a multiple of 4 floats loads by element.

#include "common.cuh"

namespace vdt {
namespace tf {

constexpr int BM = 128, BN = 128, BK = 32, NSTAGE = 3;
constexpr int LD_ROW = BK + 4;   // a (rows, BK) tile: A stored (M, K), B stored (N, K)
constexpr int LD_COL = BN + 8;   // a (BK, 128) tile: A stored (K, M), B stored (K, N)
constexpr int TILE = BM * LD_ROW > BK * LD_COL ? BM * LD_ROW : BK * LD_COL;
constexpr size_t GEMM_SMEM = sizeof(float) * NSTAGE * 2 * TILE;
constexpr int COLSUM_ROWS = 256;  // rows per partial of the bias gradients' column sums

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage the (TR, TC) block at (r0, c0) of a row-major float matrix (rows_total, cols_total, leading
// dimension ld) into dst (leading dimension lds), zeros outside: 16-byte copies where a chunk of four
// lies inside and ld allows it, else one copy per element.
template <int TR, int TC>
__device__ __forceinline__ void load_tile(float* dst, int lds, const float* src, int ld, int rows_total,
                                          int cols_total, int r0, int c0) {
  constexpr int Q = TC / 4;
  const bool vec = (ld & 3) == 0;
  for (int i = threadIdx.x; i < TR * Q; i += blockDim.x) {
    const int r = i / Q, cc = (i - r * Q) * 4;
    const int gr = r0 + r, gc = c0 + cc;
    float* d = dst + r * lds + cc;
    const int valid = gr < rows_total ? min(max(cols_total - gc, 0), 4) : 0;
    const float* s = src + (size_t)gr * ld + gc;
    if (valid == 4 && vec) {
      cp_async16(d, s, true);
    } else if (valid == 0) {
      cp_async16(d, src, false);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) cp_async4(d + e, e < valid ? s + e : src, e < valid);
    }
  }
}

// C = A B (+ bias[col]) (+ addend[row, col]) over rows [0, M), columns [0, N) and the K range of split
// blockIdx.z, [z * kchunk, min(K, (z + 1) * kchunk)), written at C + z * split_stride. A is stored (M, K)
// row-major, or with AKM (K, M); B (K, N), or with BNK (N, K). 128 x 128 output tiles, 8 warps of
// 64 x 32, the K dimension through a three-slot cp.async ring of 32-deep tiles.
template <bool AKM, bool BNK>
__global__ void __launch_bounds__(256, 2) gemm3_kernel(const float* __restrict__ A, int lda,
                                                       const float* __restrict__ B, int ldb,
                                                       float* __restrict__ C, int ldc, int M, int N, int K,
                                                       int kchunk, size_t split_stride,
                                                       const float* __restrict__ bias,
                                                       const float* __restrict__ addend, int ldadd) {
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * kchunk, kend = min(K, kbeg + kchunk);
  const int nk = (kend - kbeg + BK - 1) / BK;

  auto load = [&](int stage, int k0) {
    float* as = sm + (size_t)stage * 2 * TILE;
    float* bs = as + TILE;
    if (AKM) load_tile<BK, BM>(as, LD_COL, A, lda, kend, M, k0, m0);
    else load_tile<BM, BK>(as, LD_ROW, A, lda, M, kend, m0, k0);
    if (BNK) load_tile<BN, BK>(bs, LD_ROW, B, ldb, N, kend, n0, k0);
    else load_tile<BK, BN>(bs, LD_COL, B, ldb, kend, N, k0, n0);
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nk) load(s, kbeg + s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // tile kt has landed for every thread; the slot refilled below is no longer read
    if (kt + NSTAGE - 1 < nk) load((kt + NSTAGE - 1) % NSTAGE, kbeg + (kt + NSTAGE - 1) * BK);
    cp_async_commit();
    const float* as = sm + (size_t)(kt % NSTAGE) * 2 * TILE;
    const float* bs = as + TILE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      unsigned bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn * 32 + 8 * j + g;
        const float b0 = BNK ? bs[n * LD_ROW + kk + t] : bs[(kk + t) * LD_COL + n];
        const float b1 = BNK ? bs[n * LD_ROW + kk + t + 4] : bs[(kk + t + 4) * LD_COL + n];
        split(b0, bh[j][0], bl[j][0]);
        split(b1, bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = wm * 64 + 16 * i + g;
        float a[4];
        if (AKM) {
          a[0] = as[(kk + t) * LD_COL + m];
          a[1] = as[(kk + t) * LD_COL + m + 8];
          a[2] = as[(kk + t + 4) * LD_COL + m];
          a[3] = as[(kk + t + 4) * LD_COL + m + 8];
        } else {
          a[0] = as[m * LD_ROW + kk + t];
          a[1] = as[(m + 8) * LD_ROW + kk + t];
          a[2] = as[m * LD_ROW + kk + t + 4];
          a[3] = as[(m + 8) * LD_ROW + kk + t + 4];
        }
        unsigned ah[4], al[4];
        split4(a, ah, al);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma3(acc[i][j], ah, al, bh[j], bl[j]);
      }
    }
  }
  cp_async_wait<0>();

  float* out = C + (size_t)blockIdx.z * split_stride;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * 64 + 16 * i + g + 8 * (e >> 1);
        const int col = n0 + wn * 32 + 8 * j + 2 * t + (e & 1);
        if (row < M && col < N) {
          float v = acc[i][j][e];
          if (bias) v += bias[col];
          if (addend) v += addend[(size_t)row * ldadd + col];
          out[(size_t)row * ldc + col] = v;
        }
      }
}

// partial[y, col] = sum of A[r, col] over rows r of chunk y (COLSUM_ROWS rows), in row order.
__global__ void __launch_bounds__(256) colsum_kernel(const float* __restrict__ A, int ld, int rows, int cols,
                                                     float* __restrict__ partial) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  const int r0 = blockIdx.y * COLSUM_ROWS, r1 = min(rows, r0 + COLSUM_ROWS);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += A[(size_t)r * ld + col];
  partial[(size_t)blockIdx.y * cols + col] = s;
}

// --- the attention core -------------------------------------------------------------------------------

__host__ __device__ inline int attn_warps(int f) { return round16(f) / 16 < 8 ? round16(f) / 16 : 8; }

// One (token, head) per CTA; a CTA walks tokens blockIdx.x, + gridDim.x, ... of head blockIdx.y.
// P (rows, 3HD): q|k|v in, dq|dk|dv out; Q (rows, HD): do in, o out. With BIAS, the CTA's dbias
// partial (heads, f, f) at dbias_partial + blockIdx.x * heads * f * f: the sum of ds over its tokens.
template <int DP, bool BIAS>
__global__ void __launch_bounds__(256) attn_bwd_kernel(float* __restrict__ P, float* __restrict__ Q,
                                                       const float* __restrict__ bias,
                                                       float* __restrict__ dbias_partial, int tokens, int F,
                                                       int H, int D, float scale) {
  constexpr int LD = DP + 4, NB = DP / 8;
  extern __shared__ __align__(16) float sm[];
  const int Fk = round32(F), Fq = round16(F);
  float* qs = sm;
  float* ks = qs + Fk * LD;
  float* vs = ks + Fk * LD;
  float* dos = vs + Fk * LD;
  float* lse_s = dos + Fk * LD;
  float* di_s = lse_s + Fk;
  const int HD = H * D, W3 = 3 * HD, h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float* bias_h = BIAS ? bias + (size_t)h * F * F : nullptr;
  float* dbias_h = BIAS ? dbias_partial + ((size_t)blockIdx.x * H + h) * F * F : nullptr;

  for (int tk = blockIdx.x, it = 0; tk < tokens; tk += gridDim.x, ++it) {
    const size_t row0 = (size_t)tk * F;
    __syncthreads();  // the previous token's panels are read no more
    for (int i = threadIdx.x; i < Fk * DP; i += blockDim.x) {
      const int r = i / DP, d = i - r * DP;
      const bool ok = r < F && d < D;
      const size_t off = (row0 + r) * W3 + h * D + d;
      qs[r * LD + d] = ok ? P[off] * scale : 0.f;
      ks[r * LD + d] = ok ? P[off + HD] : 0.f;
      vs[r * LD + d] = ok ? P[off + 2 * HD] : 0.f;
      dos[r * LD + d] = ok ? Q[(row0 + r) * HD + h * D + d] : 0.f;
    }
    for (int r = F + threadIdx.x; r < Fk; r += blockDim.x) {  // padded queries carry no probability
      lse_s[r] = INFINITY;
      di_s[r] = 0.f;
    }
    __syncthreads();

    // Phase A, query-row warps: the online softmax (lse, o, di), then dq.
    for (int qb = warp; qb < Fq / 16; qb += nw) {
      const int r0 = qb * 16;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
      for (int kb0 = 0; kb0 < Fk; kb0 += 32) {
        float s[4][4];
        nt3<4, DP>(s, qs + r0 * LD, LD, ks + kb0 * LD, LD);
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = r0 + g + 8 * (e >> 1), key = kb0 + 8 * j + 2 * t + (e & 1);
            float v = s[j][e];
            if (key >= F) v = -INFINITY;
            else if (BIAS && row < F) v += bias_h[(size_t)row * F + key];
            s[j][e] = v;
            mx[e >> 1] = fmaxf(mx[e >> 1], v);
          }
        float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float mn = fmaxf(m[u], quad_max(mx[u]));
          alpha[u] = expf(m[u] - mn);
          m[u] = mn;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] = expf(s[j][e] - m[e >> 1]);
            sum[e >> 1] += s[j][e];
          }
#pragma unroll
        for (int u = 0; u < 2; ++u) l[u] = l[u] * alpha[u] + quad_sum(sum[u]);
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
        pv3<NB, 4>(o, s, vs + kb0 * LD, LD);
      }
      float lse[2], di[2] = {0.f, 0.f};
#pragma unroll
      for (int u = 0; u < 2; ++u) lse[u] = m[u] + logf(l[u]);
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + g + 8 * (e >> 1), d = 8 * n + 2 * t + (e & 1);
          o[n][e] /= l[e >> 1];
          di[e >> 1] += dos[row * LD + d] * o[n][e];
          if (row < F && d < D) Q[(row0 + row) * HD + h * D + d] = o[n][e];
        }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        di[u] = quad_sum(di[u]);
        const int row = r0 + g + 8 * u;
        if (t == 0 && row < F) {
          lse_s[row] = lse[u];
          di_s[row] = di[u];
        }
      }

      float dq[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
      for (int kb0 = 0; kb0 < Fk; kb0 += 32) {
        float s[4][4], dp[4][4];
        nt3<4, DP>(s, qs + r0 * LD, LD, ks + kb0 * LD, LD);
        nt3<4, DP>(dp, dos + r0 * LD, LD, vs + kb0 * LD, LD);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = r0 + g + 8 * (e >> 1), key = kb0 + 8 * j + 2 * t + (e & 1);
            float v = s[j][e];
            if (BIAS && row < F && key < F) v += bias_h[(size_t)row * F + key];
            const float p = key < F ? expf(v - lse[e >> 1]) : 0.f;
            s[j][e] = F > 1 ? p * (dp[j][e] - di[e >> 1]) : 0.f;  // one key: the softmax is constant
          }
        pv3<NB, 4>(dq, s, ks + kb0 * LD, LD);
      }
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + g + 8 * (e >> 1), d = 8 * n + 2 * t + (e & 1);
          if (row < F && d < D) P[(row0 + row) * W3 + h * D + d] = dq[n][e] * scale;
        }
    }
    __syncthreads();  // every row's lse and di

    // Phase B, key-row warps: dk and dv over all query blocks (and dbias).
    for (int kb = warp; kb < Fq / 16; kb += nw) {
      const int k0 = kb * 16;
      float dk[NB][4], dv[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
      for (int q0 = 0; q0 < Fk; q0 += 32) {
        float st[4][4], dpt[4][4];
        nt3<4, DP>(st, ks + k0 * LD, LD, qs + q0 * LD, LD);   // s^T: rows keys, columns queries
        nt3<4, DP>(dpt, vs + k0 * LD, LD, dos + q0 * LD, LD);  // (do v^T)^T
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + g + 8 * (e >> 1), qr = q0 + 8 * j + 2 * t + (e & 1);
            float v = st[j][e];
            if (BIAS && qr < F && key < F) v += bias_h[(size_t)qr * F + key];
            const float p = expf(v - lse_s[qr]);
            const float ds = F > 1 ? p * (dpt[j][e] - di_s[qr]) : 0.f;
            if (BIAS && qr < F && key < F) {
              float* dst = dbias_h + (size_t)qr * F + key;
              *dst = it ? *dst + ds : ds;
            }
            st[j][e] = p;
            dpt[j][e] = ds;
          }
        pv3<NB, 4>(dv, st, dos + q0 * LD, LD);
        pv3<NB, 4>(dk, dpt, qs + q0 * LD, LD);
      }
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + g + 8 * (e >> 1), d = 8 * n + 2 * t + (e & 1);
          if (key < F && d < D) {
            float* out = P + (row0 + key) * W3 + h * D + d;
            out[HD] = dk[n][e];
            out[2 * HD] = dv[n][e];
          }
        }
    }
  }
}

// The weight-gradient GEMMs' K splits for about two CTAs per SM: (splits, K per split).
__host__ inline void splits_for(int tiles, int K, int sms, int* splits, int* kchunk) {
  const int kt = (K + BK - 1) / BK;
  int s = (2 * sms + tiles - 1) / tiles;
  s = s < kt ? s : kt;
  s = s > 1 ? s : 1;
  const int per = (kt + s - 1) / s;
  *splits = (kt + per - 1) / per;
  *kchunk = per * BK;
}

__host__ inline size_t al64(size_t n) { return (n + 63) / 64 * 64; }

struct Layout {
  size_t p, q, w, o, bq, bo, floats;  // offsets (floats) of the workspace's regions, and its size
  int s_w, kc_w, s_o, kc_o, s_b;
};

__host__ inline Layout layout(int tokens, int f, int c, int heads, int dim, int sms) {
  const size_t rows = (size_t)tokens * f, hd = (size_t)heads * dim;
  Layout L;
  splits_for(((c + BM - 1) / BM) * ((3 * (int)hd + BN - 1) / BN), (int)rows, sms, &L.s_w, &L.kc_w);
  splits_for((((int)hd + BM - 1) / BM) * ((c + BN - 1) / BN), (int)rows, sms, &L.s_o, &L.kc_o);
  L.s_b = (int)((rows + COLSUM_ROWS - 1) / COLSUM_ROWS);
  L.p = 0;
  L.q = L.p + al64(rows * 3 * hd);
  L.w = L.q + al64(rows * hd);
  L.o = L.w + al64((size_t)L.s_w * c * 3 * hd);
  L.bq = L.o + al64((size_t)L.s_o * hd * c);
  L.bo = L.bq + al64((size_t)L.s_b * 3 * hd);
  L.floats = L.bo + al64((size_t)L.s_b * c);
  return L;
}

template <bool AKM, bool BNK>
static int gemm(const float* A, int lda, const float* B, int ldb, float* C, int ldc, int M, int N, int K,
                int splits, int kchunk, const float* bias, const float* addend, int ldadd, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(gemm3_kernel<AKM, BNK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)GEMM_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  gemm3_kernel<AKM, BNK><<<grid, 256, GEMM_SMEM, s>>>(A, lda, B, ldb, C, ldc, M, N, K, kchunk,
                                                      (size_t)M * N, bias, addend, ldadd);
  return (int)cudaGetLastError();
}

static int colsum(const float* A, int ld, int rows, int cols, int splits, float* partial, float* out,
                  cudaStream_t s) {
  colsum_kernel<<<dim3((cols + 255) / 256, splits), 256, 0, s>>>(A, ld, rows, cols, partial);
  const int err = (int)cudaGetLastError();
  return err ? err : launch_reduce(partial, splits, (size_t)cols, 1, cols, out, cols, s);
}

template <int DP, bool BIAS>
static int attn(float* P, float* Q, const float* bias, float* dbias_partial, int tokens, int f, int heads,
                int dim, int groups, float scale, cudaStream_t s) {
  const size_t smem = attn_smem(f, DP);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_kernel<DP, BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_kernel<DP, BIAS><<<dim3(groups, heads), 32 * attn_warps(f), smem, s>>>(P, Q, bias, dbias_partial,
                                                                                 tokens, f, heads, dim, scale);
  return (int)cudaGetLastError();
}

}  // namespace tf

}  // namespace vdt

// The float32 backward of the block (both families' function): dx (tokens * f, c); `grads` receives
// dW_qkv (c, 3HD) | db_qkv (3HD) | dW_o (HD, c) | db_o (c). With `bias` (heads, f, f), `dbias` receives
// the sum of the `groups` CTAs' partials in `dbias_partial` (groups x heads*f*f). `work` holds
// `work_bytes` of scratch (the layout's; the planner's `scratch`), `sms` the SM count the splits are
// taken for. x, g, wqkv and wo must be 16-byte aligned. Returns the cudaError_t of the launches;
// `*route` is set to 2 (this design) where they ran.
extern "C" int temporal_tf32x3_bwd(const void* x, const void* g, const void* wqkv, const void* bqkv,
                                   const void* wo, const void* bias, void* dbias_partial, void* dbias,
                                   void* dx, void* grads, void* work, size_t work_bytes, int tokens, int f,
                                   int c, int heads, int dim, int sms, int groups, float scale, void* stream,
                                   int* route) {
  using namespace vdt;
  *route = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!tf32x3_fits(f, dim) || tokens < 1 || c < 1 || heads < 1 || sms < 1 || groups < 1 || groups > tokens)
    return (int)cudaErrorInvalidValue;
  if (bias && !(dbias_partial && dbias)) return (int)cudaErrorInvalidValue;
  const void* aligned[] = {x, g, wqkv, wo, work};
  for (const void* p : aligned)
    if (reinterpret_cast<size_t>(p) % 16) return (int)cudaErrorMisalignedAddress;
  const tf::Layout L = tf::layout(tokens, f, c, heads, dim, sms);
  if (work_bytes < L.floats * sizeof(float)) return (int)cudaErrorInvalidValue;
  const int rows = tokens * f, hd = heads * dim, w3 = 3 * hd;
  const float *X = static_cast<const float*>(x), *G = static_cast<const float*>(g);
  const float *Wqkv = static_cast<const float*>(wqkv), *Wo = static_cast<const float*>(wo);
  float* W = static_cast<float*>(work);
  float *Pb = W + L.p, *Qb = W + L.q, *out = static_cast<float*>(grads);
  int rc;
  // q|k|v = x W_qkv + b_qkv; do = g W_o^T
  if ((rc = tf::gemm<false, false>(X, c, Wqkv, w3, Pb, w3, rows, w3, c, 1, c, static_cast<const float*>(bqkv),
                                   nullptr, 0, s)))
    return rc;
  if ((rc = tf::gemm<false, true>(G, c, Wo, c, Qb, hd, rows, hd, c, 1, c, nullptr, nullptr, 0, s))) return rc;
  // dq|dk|dv over q|k|v and o over do, per (token, head)
  const float* B = static_cast<const float*>(bias);
  float* DBp = static_cast<float*>(dbias_partial);
  if (dim <= 32) rc = bias ? tf::attn<32, true>(Pb, Qb, B, DBp, tokens, f, heads, dim, groups, scale, s)
                           : tf::attn<32, false>(Pb, Qb, B, DBp, tokens, f, heads, dim, groups, scale, s);
  else rc = bias ? tf::attn<64, true>(Pb, Qb, B, DBp, tokens, f, heads, dim, groups, scale, s)
                 : tf::attn<64, false>(Pb, Qb, B, DBp, tokens, f, heads, dim, groups, scale, s);
  if (rc) return rc;
  // dW_qkv = x^T dqkv and dW_o = o^T g over K splits of the rows; dx = g + dqkv W_qkv^T
  if ((rc = tf::gemm<true, false>(X, c, Pb, w3, W + L.w, w3, c, w3, rows, L.s_w, L.kc_w, nullptr, nullptr, 0, s)))
    return rc;
  if ((rc = tf::gemm<true, false>(Qb, hd, G, c, W + L.o, c, hd, c, rows, L.s_o, L.kc_o, nullptr, nullptr, 0, s)))
    return rc;
  if ((rc = tf::gemm<false, true>(Pb, w3, Wqkv, w3, static_cast<float*>(dx), c, rows, c, w3, 1, w3, nullptr, G,
                                  c, s)))
    return rc;
  // the partials summed in split order, and the bias gradients' column sums
  const size_t o_w = 0, o_bq = (size_t)c * w3, o_wo = o_bq + w3, o_bo = o_wo + (size_t)hd * c;
  if ((rc = launch_reduce(W + L.w, L.s_w, (size_t)c * w3, 1, c * w3, out + o_w, c * w3, s))) return rc;
  if ((rc = launch_reduce(W + L.o, L.s_o, (size_t)hd * c, 1, hd * c, out + o_wo, hd * c, s))) return rc;
  if ((rc = tf::colsum(Pb, w3, rows, w3, L.s_b, W + L.bq, out + o_bq, s))) return rc;
  if ((rc = tf::colsum(G, c, rows, c, L.s_b, W + L.bo, out + o_bo, s))) return rc;
  if (bias) {
    const int panel = heads * f * f;
    if ((rc = launch_reduce(DBp, groups, (size_t)panel, 1, panel, static_cast<float*>(dbias), panel, s)))
      return rc;
  }
  *route = 2;
  return 0;
}
