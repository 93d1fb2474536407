// Fused temporal-attention block, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel video_diffusion_nnx_tpu/ops/temporal_attention.py
// `_fwd_kernel` (line 111, reached through `_forward`). For x of shape
// (tokens, f, c), packed wqkv (c, 3*H*D) and wo (H*D, c) in x's type, and
// float32 biases, it computes per token
//
//     out = x + sum_h softmax(q_h k_h^T / sqrt(D)) v_h W_o,h + b_o
//
// over the f axis, with the rounding points of the TPU kernel: the q|k|v
// projection accumulates in float32, adds its bias and rounds to x's type;
// q is then scaled in x's type; logits and softmax are float32 and the
// probabilities round to x's type; each head's output rounds to x's type
// before its W_o product, which accumulates in float32 over heads; finally
// out = x + round(y + b_o).
//
// Design. One CTA owns a tile of `bt` tokens: it reads the tile's
// (bt*f, c) rows into shared memory once, runs every head on it there, and
// writes only the result, so device memory sees x once and out once. The
// TPU pads f to a multiple of 8 sublanes and masks the padded keys; here
// the ragged f is the loop bound and nothing is padded. The tile is sized
// from c and f by the caller so that the float32 panels fit in shared
// memory (at most 227 KB; the caller aims at about 100 KB so that two CTAs
// share an SM).
//
// Bias. The BIAS instantiations take `bias` (H, f, f) float32, the fixed-math
// relative position bias, and add bias[h, i, j] to the float32 logit of
// query frame i and key frame j before the row maximum (the TPU kernel's
// `bias_ref`; its padding of the bias to 8 sublanes is dropped, the bias is
// read with its own stride f). The unbiased instantiations compile without
// any of it.
//
// Bound on this card. Per token the block moves 2*f*c elements and does
// 8*f*c*H*D FLOPs in its four projections plus 4*f*f*H*D in attention: with
// H*D = 256 that is 520-600 FLOP per bf16 byte at every Unet3D shape, above
// the H100's ~295 FLOP/byte ridge (989 TFLOP/s over 3.35 TB/s), so the
// bound is the bf16 tensor-core rate. This first version multiplies on the
// CUDA cores in float32 (no tensor cores), so it is far from that bound;
// wgmma tiles and TMA loads are later work.

#include "common.cuh"

namespace vdt {

template <typename T, bool BIAS>
__global__ void __launch_bounds__(kThreads) temporal_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ wqkv, const float* __restrict__ bqkv,
    const T* __restrict__ wo, const float* __restrict__ bo, const float* __restrict__ bias,
    T* __restrict__ out, int tokens, int F, int C, int H, int D, int BT, float scale_in) {
  extern __shared__ float smem[];
  const int R = BT * F;
  const int QS = 3 * D + 1;  // odd row strides keep the per-row loops free of bank conflicts
  const int PS = F + 1;
  float* xs = smem;                  // (R, C)   the tile's input rows
  float* ys = xs + (size_t)R * C;    // (R, C)   float32 sum over heads of o_h W_o,h
  float* qkv = ys + (size_t)R * C;   // (R, QS)  one head's q|k|v; o_h over the q slots
  float* pr = qkv + (size_t)R * QS;  // (R, PS)  one head's attention probabilities

  const int tid = threadIdx.x, nth = blockDim.x;
  const int t0 = blockIdx.x * BT;
  const int nt = min(BT, tokens - t0);
  const int rows = nt * F;
  const size_t base = (size_t)t0 * F * C;
  const int HD = H * D, W3 = 3 * HD;
  const float scale = rnd<T>(scale_in);

  for (int i = tid; i < rows * C; i += nth) {
    xs[i] = to_f(x[base + i]);
    ys[i] = 0.f;
  }
  __syncthreads();

  const int RG = (rows + 3) / 4;  // row groups of 4: each weight load feeds 4 rows
  for (int h = 0; h < H; ++h) {
    // 1. q|k|v projection of head h.
    for (int item = tid; item < RG * 3 * D; item += nth) {
      const int rg = item / (3 * D), j = item - rg * 3 * D;
      const int part = j / D, d = j - part * D;
      const int col = part * HD + h * D + d;
      const int r0 = rg * 4;
      const float* x0 = xs + (size_t)r0 * C;
      const float* x1 = xs + (size_t)min(r0 + 1, rows - 1) * C;
      const float* x2 = xs + (size_t)min(r0 + 2, rows - 1) * C;
      const float* x3 = xs + (size_t)min(r0 + 3, rows - 1) * C;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < C; ++k) {
        const float w = to_f(wqkv[(size_t)k * W3 + col]);
        a[0] += x0[k] * w;
        a[1] += x1[k] * w;
        a[2] += x2[k] * w;
        a[3] += x3[k] * w;
      }
      const float bias = bqkv[col];
      for (int u = 0; u < 4; ++u) {
        const int r = r0 + u;
        if (r < rows) {
          float v = rnd<T>(a[u] + bias);
          if (part == 0) v = rnd<T>(v * scale);
          qkv[(size_t)r * QS + j] = v;
        }
      }
    }
    __syncthreads();

    // 2. Logits over the token's f frames and their softmax, one row per thread.
    for (int row = tid; row < rows; row += nth) {
      const int tk = row / F;
      const float* q = qkv + (size_t)row * QS;
      const float* kb = qkv + (size_t)tk * F * QS + D;
      float* p = pr + (size_t)row * PS;
      const float* brow = BIAS ? bias + ((size_t)h * F + (row - tk * F)) * F : nullptr;
      float m = -INFINITY;
      for (int j = 0; j < F; ++j) {
        const float* kj = kb + (size_t)j * QS;
        float s = 0.f;
        for (int d = 0; d < D; ++d) s += q[d] * kj[d];
        if (BIAS) s += brow[j];
        p[j] = s;
        m = fmaxf(m, s);
      }
      float sum = 0.f;
      for (int j = 0; j < F; ++j) {
        const float e = expf(p[j] - m);
        p[j] = e;
        sum += e;
      }
      for (int j = 0; j < F; ++j) p[j] = rnd<T>(p[j] / sum);
    }
    __syncthreads();

    // 3. o_h = P V, written over the q slots (q is no longer read).
    for (int item = tid; item < rows * D; item += nth) {
      const int row = item / D, d = item - row * D;
      const int tk = row / F;
      const float* p = pr + (size_t)row * PS;
      const float* vb = qkv + (size_t)tk * F * QS + 2 * D + d;
      float s = 0.f;
      for (int j = 0; j < F; ++j) s += p[j] * vb[(size_t)j * QS];
      qkv[(size_t)row * QS + d] = rnd<T>(s);
    }
    __syncthreads();

    // 4. y += o_h W_o,h.
    for (int item = tid; item < RG * C; item += nth) {
      const int rg = item / C, cc = item - rg * C;
      const int r0 = rg * 4;
      const float* o0 = qkv + (size_t)r0 * QS;
      const float* o1 = qkv + (size_t)min(r0 + 1, rows - 1) * QS;
      const float* o2 = qkv + (size_t)min(r0 + 2, rows - 1) * QS;
      const float* o3 = qkv + (size_t)min(r0 + 3, rows - 1) * QS;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      for (int d = 0; d < D; ++d) {
        const float w = to_f(wo[(size_t)(h * D + d) * C + cc]);
        a[0] += o0[d] * w;
        a[1] += o1[d] * w;
        a[2] += o2[d] * w;
        a[3] += o3[d] * w;
      }
      for (int u = 0; u < 4; ++u) {
        const int r = r0 + u;
        if (r < rows) ys[(size_t)r * C + cc] += a[u];
      }
    }
    __syncthreads();
  }

  // 5. out = x + round(y + b_o).
  for (int i = tid; i < rows * C; i += nth) {
    const int cc = i % C;
    out[base + i] = from_f<T>(xs[i] + rnd<T>(ys[i] + bo[cc]));
  }
}

template <typename T, bool BIAS>
static int launch(const void* x, const void* wqkv, const void* bqkv, const void* wo,
                  const void* bo, const void* bias, void* out, int tokens, int f, int c, int heads,
                  int dim, int bt, float scale, cudaStream_t stream) {
  const size_t rows = (size_t)bt * f;
  const size_t smem = sizeof(float) * rows * (2 * c + 3 * dim + 1 + f + 1);
  cudaError_t err = cudaFuncSetAttribute(
      temporal_fwd_kernel<T, BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (tokens + bt - 1) / bt;
  temporal_fwd_kernel<T, BIAS><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv), static_cast<const float*>(bqkv),
      static_cast<const T*>(wo), static_cast<const float*>(bo), static_cast<const float*>(bias),
      static_cast<T*>(out), tokens, f, c, heads, dim, bt, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward.
//
// Replaces the TPU kernel `_bwd_kernel` (temporal_attention.py line 175,
// reached through `_backward`). Given x and the output cotangent g, both
// (tokens, f, c), it recomputes each head's attention and emits
//
//     dx = g + sum_h dqkv_h W_qkv,h^T,  dW_qkv, db_qkv, dW_o, db_o,
//
// with the rounding points of the TPU kernel: q|k|v as in the forward; the
// softmax and its VJP in float32 on the unrounded probabilities; the
// probabilities, o_h, do, ds and dqkv rounded to x's type before each
// product; db_qkv summed from the unrounded dqkv; every weight gradient in
// float32. The BIAS instantiation adds bias[h] to the logits as the forward
// does and also emits dbias (H, f, f) float32: for every head the sum over
// tokens of ds, the logit gradient, taken from the float32 values before
// they round to x's type (the TPU kernel's `dbias_ref`).
//
// Weight gradients cross CTAs. The TPU kernel adds them into one block over
// a grid that runs in order; here the grid is persistent (about one or two
// CTAs per SM, each looping over token tiles), and each CTA adds into its
// own float32 partial (dW_qkv | db_qkv | dW_o | db_o) in a workspace the
// caller allocates, so the workspace scales with the CTA count and not the
// token count. `reduce_partials_kernel` then sums the partials in a fixed
// order: the result is deterministic. dbias crosses CTAs the same way, through
// an (H, f, f) partial per CTA in a workspace of its own (`dbias_partial`) and
// a second call of the reduction.
//
// Shared memory per tile row: x and the float32 dx accumulator (2c), q|k|v
// and dq|dk|dv (2 * (3D + 1)), the f x f probabilities, then ds (f + 1),
// o_h, then do (D + 1). g is read from device memory where it is needed
// (twice per head, through L2). At the bottleneck (f = 64, c = 256) one
// token takes 201 KB, under the 227 KB a CTA may use. The ragged f is a
// loop bound, as in the forward; nothing is padded.
//
// Bound: per token the backward does about twice the forward's FLOPs (the
// projections again, their two transposed products, and the attention
// products), above the card's FLOP-per-byte ridge, so it is bound by the
// tensor-core rate. This first version multiplies on the CUDA cores in
// float32, far from it.

template <typename T, bool BIAS>
__global__ void __launch_bounds__(kThreads) temporal_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ wqkv,
    const float* __restrict__ bqkv, const T* __restrict__ wo, const float* __restrict__ bias,
    float* __restrict__ dbias_partial, T* __restrict__ dx, float* __restrict__ partial, int tokens,
    int F, int C, int H, int D, int BT, float scale) {
  extern __shared__ float smem[];
  const int R = BT * F;
  const int QS = 3 * D + 1, PS = F + 1, OS = D + 1;
  float* xs = smem;                   // (R, C)   the tile's input rows
  float* dxs = xs + (size_t)R * C;    // (R, C)   float32 sum over heads of dqkv_h W_h^T
  float* qkv = dxs + (size_t)R * C;   // (R, QS)  one head's q|k|v (rounded)
  float* dqk = qkv + (size_t)R * QS;  // (R, QS)  its dq|dk|dv
  float* pr = dqk + (size_t)R * QS;   // (R, PS)  probabilities, then ds (rounded)
  float* os = pr + (size_t)R * PS;    // (R, OS)  o_h, then do (both rounded)

  const int tid = threadIdx.x, nth = blockDim.x;
  const int HD = H * D, W3 = 3 * HD, D3 = 3 * D;
  const int DQ = D / 4, JQ = D3 / 4;  // register blocking by four (D % 4 == 0, checked by the caller)
  const size_t total = (size_t)C * W3 + W3 + (size_t)HD * C + C;
  float* pw = partial + (size_t)blockIdx.x * total;  // dW_qkv (C, 3HD), packed layout
  float* pb = pw + (size_t)C * W3;                   // db_qkv (3HD)
  float* pwo = pb + W3;                              // dW_o (HD, C)
  float* pbo = pwo + (size_t)HD * C;                 // db_o (C)
  for (size_t i = tid; i < total; i += nth) pw[i] = 0.f;
  float* pdb = BIAS ? dbias_partial + (size_t)blockIdx.x * H * F * F : nullptr;  // dbias (H, F, F)
  if (BIAS)
    for (int i = tid; i < H * F * F; i += nth) pdb[i] = 0.f;
  const float scale_q = rnd<T>(scale);
  const int ntiles = (tokens + BT - 1) / BT;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int t0 = tile * BT;
    const int rows = min(BT, tokens - t0) * F;
    const size_t base = (size_t)t0 * F * C;
    const T* gt = g + base;
    __syncthreads();  // the partial is zeroed and the previous tile consumed
    for (int i = tid; i < rows * C; i += nth) {
      xs[i] = to_f(x[base + i]);
      dxs[i] = 0.f;
    }
    __syncthreads();

    const int RG = (rows + 3) / 4;
    for (int h = 0; h < H; ++h) {
      // 1. q|k|v projection of head h, as in the forward.
      for (int item = tid; item < RG * D3; item += nth) {
        const int rg = item / D3, j = item - rg * D3;
        const int part = j / D, d = j - part * D;
        const int col = part * HD + h * D + d;
        const int r0 = rg * 4;
        const float* x0 = xs + (size_t)r0 * C;
        const float* x1 = xs + (size_t)min(r0 + 1, rows - 1) * C;
        const float* x2 = xs + (size_t)min(r0 + 2, rows - 1) * C;
        const float* x3 = xs + (size_t)min(r0 + 3, rows - 1) * C;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k = 0; k < C; ++k) {
          const float w = to_f(wqkv[(size_t)k * W3 + col]);
          a[0] += x0[k] * w;
          a[1] += x1[k] * w;
          a[2] += x2[k] * w;
          a[3] += x3[k] * w;
        }
        const float bias = bqkv[col];
        for (int u = 0; u < 4; ++u) {
          const int r = r0 + u;
          if (r < rows) {
            float v = rnd<T>(a[u] + bias);
            if (part == 0) v = rnd<T>(v * scale_q);
            qkv[(size_t)r * QS + j] = v;
          }
        }
      }
      __syncthreads();

      // 2. Logits and their float32 softmax, kept unrounded for the VJP.
      for (int row = tid; row < rows; row += nth) {
        const int tk = row / F;
        const float* q = qkv + (size_t)row * QS;
        const float* kb = qkv + (size_t)tk * F * QS + D;
        float* p = pr + (size_t)row * PS;
        const float* brow = BIAS ? bias + ((size_t)h * F + (row - tk * F)) * F : nullptr;
        float m = -INFINITY;
        for (int j = 0; j < F; ++j) {
          const float* kj = kb + (size_t)j * QS;
          float s = 0.f;
          for (int d = 0; d < D; ++d) s += q[d] * kj[d];
          if (BIAS) s += brow[j];
          p[j] = s;
          m = fmaxf(m, s);
        }
        float sum = 0.f;
        for (int j = 0; j < F; ++j) {
          const float e = expf(p[j] - m);
          p[j] = e;
          sum += e;
        }
        for (int j = 0; j < F; ++j) p[j] = p[j] / sum;
      }
      __syncthreads();

      // 3. o_h = round(round(P) V).
      for (int item = tid; item < rows * D; item += nth) {
        const int row = item / D, d = item - row * D;
        const int tk = row / F;
        const float* p = pr + (size_t)row * PS;
        const float* vb = qkv + (size_t)tk * F * QS + 2 * D + d;
        float s = 0.f;
        for (int j = 0; j < F; ++j) s += rnd<T>(p[j]) * vb[(size_t)j * QS];
        os[(size_t)row * OS + d] = rnd<T>(s);
      }
      __syncthreads();

      // 4. dW_o,h += o_h^T g, four features per g load (features d, d + D/4, ...).
      for (int item = tid; item < DQ * C; item += nth) {
        const int dq = item / C, cc = item - dq * C;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        for (int r = 0; r < rows; ++r) {
          const float gv = to_f(gt[(size_t)r * C + cc]);
          const float* o = os + (size_t)r * OS + dq;
#pragma unroll
          for (int u = 0; u < 4; ++u) a[u] += o[u * DQ] * gv;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) pwo[(size_t)(h * D + dq + u * DQ) * C + cc] += a[u];
      }
      __syncthreads();

      // 5. do = round(g W_o,h^T), over the o slots, four rows per weight load.
      for (int item = tid; item < RG * D; item += nth) {
        const int rg = item / D, d = item - rg * D;
        const int r0 = rg * 4;
        const T* g0 = gt + (size_t)r0 * C;
        const T* g1 = gt + (size_t)min(r0 + 1, rows - 1) * C;
        const T* g2 = gt + (size_t)min(r0 + 2, rows - 1) * C;
        const T* g3 = gt + (size_t)min(r0 + 3, rows - 1) * C;
        const T* wr = wo + (size_t)(h * D + d) * C;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        for (int cc = 0; cc < C; ++cc) {
          const float w = to_f(wr[cc]);
          a[0] += to_f(g0[cc]) * w;
          a[1] += to_f(g1[cc]) * w;
          a[2] += to_f(g2[cc]) * w;
          a[3] += to_f(g3[cc]) * w;
        }
        for (int u = 0; u < 4; ++u)
          if (r0 + u < rows) os[(size_t)(r0 + u) * OS + d] = rnd<T>(a[u]);
      }
      __syncthreads();

      // 6a. dv = round(P)^T do.
      for (int item = tid; item < rows * D; item += nth) {
        const int row = item / D, d = item - row * D;
        const int tk = row / F, j = row - tk * F;
        const float* pb0 = pr + (size_t)tk * F * PS + j;
        const float* ob = os + (size_t)tk * F * OS + d;
        float s = 0.f;
        for (int i = 0; i < F; ++i) s += rnd<T>(pb0[(size_t)i * PS]) * ob[(size_t)i * OS];
        dqk[(size_t)row * QS + 2 * D + d] = s;
      }
      __syncthreads();

      // 6b. ds = P * (dattn - sum_j dattn P), dattn = do V^T; rounded, over P. With a bias the
      // unrounded ds stays for 6c.
      for (int row = tid; row < rows; row += nth) {
        const int tk = row / F;
        const float* dob = os + (size_t)row * OS;
        const float* vb = qkv + (size_t)tk * F * QS + 2 * D;
        float* p = pr + (size_t)row * PS;
        float sum = 0.f;
        for (int j = 0; j < F; ++j) {
          float da = 0.f;
          for (int d = 0; d < D; ++d) da += dob[d] * vb[(size_t)j * QS + d];
          sum += da * p[j];
        }
        for (int j = 0; j < F; ++j) {
          float da = 0.f;
          for (int d = 0; d < D; ++d) da += dob[d] * vb[(size_t)j * QS + d];
          const float ds = p[j] * (da - sum);
          p[j] = BIAS ? ds : rnd<T>(ds);
        }
      }
      __syncthreads();

      // 6c. dbias[h] += the tile's token sum of the unrounded ds, in token order; ds rounds in place.
      // Each (i, j) belongs to one thread, so no two threads add into one element.
      if (BIAS) {
        const int nt = rows / F;
        for (int item = tid; item < F * F; item += nth) {
          const int i = item / F, j = item - i * F;
          float s = 0.f;
          for (int tk = 0; tk < nt; ++tk) {
            float* e = pr + (size_t)(tk * F + i) * PS + j;
            s += *e;
            *e = rnd<T>(*e);
          }
          pdb[(size_t)h * F * F + item] += s;
        }
        __syncthreads();
      }

      // 7. dq = (ds k) * scale and dk = ds^T q (q as scaled in the forward).
      for (int item = tid; item < rows * 2 * D; item += nth) {
        const int row = item / (2 * D), j = item - row * 2 * D;
        const int tk = row / F, i0 = row - tk * F;
        float s = 0.f;
        if (j < D) {
          const float* p = pr + (size_t)row * PS;
          const float* kb = qkv + (size_t)tk * F * QS + D + j;
          for (int jj = 0; jj < F; ++jj) s += p[jj] * kb[(size_t)jj * QS];
          dqk[(size_t)row * QS + j] = s * scale;
        } else {
          const float* pc = pr + (size_t)tk * F * PS + i0;
          const float* qb = qkv + (size_t)tk * F * QS + (j - D);
          for (int i = 0; i < F; ++i) s += pc[(size_t)i * PS] * qb[(size_t)i * QS];
          dqk[(size_t)row * QS + j] = s;
        }
      }
      __syncthreads();

      // 8. db_qkv += column sums of the unrounded dqkv, then round it in place.
      for (int j = tid; j < D3; j += nth) {
        float s = 0.f;
        for (int r = 0; r < rows; ++r) {
          const float v = dqk[(size_t)r * QS + j];
          s += v;
          dqk[(size_t)r * QS + j] = rnd<T>(v);
        }
        const int part = j / D;
        pb[part * HD + h * D + (j - part * D)] += s;
      }
      __syncthreads();

      // 9. dW_qkv,h += x^T dqkv (four columns j, j + 3D/4, ... per x load)  and
      // 10. dx += dqkv W_qkv,h^T; both only read.
      for (int item = tid; item < C * JQ; item += nth) {
        const int cc = item / JQ, jq = item - cc * JQ;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        for (int r = 0; r < rows; ++r) {
          const float xv = xs[(size_t)r * C + cc];
          const float* dr = dqk + (size_t)r * QS + jq;
#pragma unroll
          for (int u = 0; u < 4; ++u) a[u] += xv * dr[u * JQ];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = jq + u * JQ, part = j / D;
          pw[(size_t)cc * W3 + part * HD + h * D + (j - part * D)] += a[u];
        }
      }
      for (int item = tid; item < RG * C; item += nth) {
        const int rg = item / C, cc = item - rg * C;
        const int r0 = rg * 4;
        const float* d0 = dqk + (size_t)r0 * QS;
        const float* d1 = dqk + (size_t)min(r0 + 1, rows - 1) * QS;
        const float* d2 = dqk + (size_t)min(r0 + 2, rows - 1) * QS;
        const float* d3 = dqk + (size_t)min(r0 + 3, rows - 1) * QS;
        const T* wr = wqkv + (size_t)cc * W3 + h * D;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        for (int j = 0; j < D3; ++j) {
          const int part = j / D;
          const float w = to_f(wr[part * HD + (j - part * D)]);
          a[0] += d0[j] * w;
          a[1] += d1[j] * w;
          a[2] += d2[j] * w;
          a[3] += d3[j] * w;
        }
        for (int u = 0; u < 4; ++u)
          if (r0 + u < rows) dxs[(size_t)(r0 + u) * C + cc] += a[u];
      }
      __syncthreads();
    }

    // db_o += token sum of g; dx = round(g + dx_attention).
    for (int cc = tid; cc < C; cc += nth) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s += to_f(gt[(size_t)r * C + cc]);
      pbo[cc] += s;
    }
    for (int i = tid; i < rows * C; i += nth) dx[base + i] = from_f<T>(to_f(gt[i]) + dxs[i]);
  }
}

template <typename T, bool BIAS>
static int launch_bwd(const void* x, const void* g, const void* wqkv, const void* bqkv,
                      const void* wo, const void* bias, void* dbias_partial, void* dbias, void* dx,
                      void* partial, void* grads, int tokens, int f, int c, int heads, int dim,
                      int bt, int grid, float scale, cudaStream_t stream) {
  const size_t rows = (size_t)bt * f;
  const size_t smem = sizeof(float) * rows * (2 * c + 2 * (3 * dim + 1) + f + 1 + dim + 1);
  cudaError_t err = cudaFuncSetAttribute(
      temporal_bwd_kernel<T, BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  temporal_bwd_kernel<T, BIAS><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const T*>(wo), static_cast<const float*>(bias),
      static_cast<float*>(dbias_partial), static_cast<T*>(dx), static_cast<float*>(partial), tokens,
      f, c, heads, dim, bt, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t hd = (size_t)heads * dim;
  const size_t total = (size_t)c * 3 * hd + 3 * hd + hd * c + c;
  int rc = launch_reduce(static_cast<const float*>(partial), grid, total, 1, (int)total,
                         static_cast<float*>(grads), (int)total, stream);
  if (rc != 0 || !BIAS) return rc;
  const size_t panel = (size_t)heads * f * f;
  return launch_reduce(static_cast<const float*>(dbias_partial), grid, panel, 1, (int)panel,
                       static_cast<float*>(dbias), (int)panel, stream);
}

}  // namespace vdt

// dtype: 0 = float32, 1 = bfloat16. `bias` is (heads, f, f) float32 or null (the unbiased
// instantiation). Returns the cudaError_t of the launch.
extern "C" int temporal_attention_fwd(int dtype, const void* x, const void* wqkv,
                                      const void* bqkv, const void* wo, const void* bo,
                                      const void* bias, void* out, int tokens, int f, int c,
                                      int heads, int dim, int bt, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VDT_FWD(T, B) \
  vdt::launch<T, B>(x, wqkv, bqkv, wo, bo, bias, out, tokens, f, c, heads, dim, bt, scale, s)
  if (dtype == 0) return bias ? VDT_FWD(float, true) : VDT_FWD(float, false);
  if (dtype == 1) return bias ? VDT_FWD(__nv_bfloat16, true) : VDT_FWD(__nv_bfloat16, false);
#undef VDT_FWD
  return (int)cudaErrorInvalidValue;
}

// Backward: dx in x's type; `grads` (float32) receives dW_qkv (c, 3HD) |
// db_qkv (3HD) | dW_o (HD, c) | db_o (c), summed over the `grid` CTAs'
// partials in `partial` (grid x that size, float32). With `bias`, `dbias`
// (heads, f, f) float32 receives the sum of the CTAs' `dbias_partial`
// (grid x heads*f*f, float32); all three are null for the unbiased instantiation.
extern "C" int temporal_attention_bwd(int dtype, const void* x, const void* g, const void* wqkv,
                                      const void* bqkv, const void* wo, const void* bias,
                                      void* dbias_partial, void* dbias, void* dx, void* partial,
                                      void* grads, int tokens, int f, int c, int heads, int dim,
                                      int bt, int grid, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bias && !(dbias_partial && dbias)) return (int)cudaErrorInvalidValue;
#define VDT_BWD(T, B)                                                                           \
  vdt::launch_bwd<T, B>(x, g, wqkv, bqkv, wo, bias, dbias_partial, dbias, dx, partial, grads, \
                        tokens, f, c, heads, dim, bt, grid, scale, s)
  if (dtype == 0) return bias ? VDT_BWD(float, true) : VDT_BWD(float, false);
  if (dtype == 1) return bias ? VDT_BWD(__nv_bfloat16, true) : VDT_BWD(__nv_bfloat16, false);
#undef VDT_BWD
  return (int)cudaErrorInvalidValue;
}
