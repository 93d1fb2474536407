// Fused spatial linear-attention block, forward and backward, for Hopper (sm_90a).
//
// Replaces three TPU kernels of video_diffusion_nnx_tpu/ops/
// spatial_linear_attention.py: the one-pass `_kernel` (line 37, through
// `_forward`), and the two-pass pair `_context_kernel` (line 166, through
// `_ctx_pallas`) and `_out_kernel` (line 203, through `_forward_two_pass`).
// The TPU splits one pass from two only because of its VMEM budget; here
// both routes are the same two kernels, for every frame size.
//
// For one frame x (n, c), packed wqkv (c, 3*H*D) and wo (H*D, c):
//
//     ctx_h = softmax_n(x W_k,h)^T (x W_v,h)              (D, D), float32
//     out   = x + sum_h softmax_D(x W_q,h) * scale . ctx_h W_o,h
//
// Each stage has two versions. The staged kernels (`sla_context_panel_kernel`,
// `sla_out_panel_kernel`, below the first versions) stage the chunk and each
// head's weights in shared memory in x's type and run the products on the
// tensor cores in bf16; they take every shape whose 16-token chunk fits. The
// first versions multiply on the CUDA cores in float32 with the weights read
// from device memory one element at a time, and keep the rest:
//
// `sla_context_kernel`: one CTA per (frame, head) walks all n tokens in
// chunks twice: pass 0 projects k and keeps a running per-feature max and
// sum; pass 1 projects k|v again and forms s = round(exp(k - max) / sum)
// with the whole frame's statistics, as the TPU kernel rounds s after its
// division (`_context_kernel:193`), and sums round(s)^T round(v) in float32.
// A head is a CTA of its own, so no block-diagonal mask and no 128-lane
// head grouping are needed, and no sum crosses CTAs.
//
// `sla_out_kernel`: one CTA per (frame, token chunk). Per head it projects
// q in float32, softmaxes each token's D features with that head's own max
// (a max shared across heads can underflow a whole head to 0/0), scales
// when the scale is not 1, rounds, multiplies by the head's context rounded
// to x's type, rounds, and accumulates o_h W_o,h in float32; it writes
// x + round(y).
//
// Rounding points follow the TPU kernels: projections accumulate in float32
// and k, q stay float32 into their softmaxes; v, s = softmax_n(k) (after its
// division by the sum over all n tokens, `_context_kernel:193`), the q
// softmax times the scale, the context and o_h round to x's type before
// their products.
//
// Bound on this card. Each stage reads x once (the output stage also
// writes it) and does 2*n*(2*c*H*D + H*D*D) FLOPs per frame: with H*D = 256
// and D = 32 that is 270-770 FLOP per bf16 byte, around the H100's ~295
// FLOP/byte ridge (989 TFLOP/s over 3.35 TB/s), so the bound is the
// tensor-core rate at small c and the bytes at the widest c.

#include "common.cuh"

namespace vdt {

constexpr int kMaxAcc = 16;  // (D*D) / kThreads context entries per thread: D <= 64

template <typename T>
__global__ void __launch_bounds__(kThreads) sla_context_kernel(
    const T* __restrict__ x, const T* __restrict__ wqkv, float* __restrict__ ctx,
    float* __restrict__ stats, int n, int C, int H, int D, int NC) {
  extern __shared__ float smem[];
  const int KS = D + 1;
  float* xs = smem;                  // (NC, C)  token chunk
  float* ks = xs + (size_t)NC * C;   // (NC, KS) k in float32; in pass 1 then s, rounded
  float* vs = ks + (size_t)NC * KS;  // (NC, KS) v rounded to x's type (pass 1)
  float* mrun = vs + (size_t)NC * KS;  // (D) running max of k per feature
  float* srun = mrun + D;              // (D) running sum of exp(k - max)

  const int frame = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int HD = H * D, W3 = 3 * HD;
  const T* xf = x + (size_t)frame * n * C;
  const int nacc = (D * D + nth - 1) / nth;
  float acc[kMaxAcc];
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;
  if (tid < D) {
    mrun[tid] = -INFINITY;
    srun[tid] = 0.f;
  }

  // Pass 0: the k softmax's statistics over all n tokens; pass 1: the context from round(s) and round(v).
  for (int pass = 0; pass < 2; ++pass) {
    const int parts = pass + 1;  // pass 0 projects k alone
    for (int n0 = 0; n0 < n; n0 += NC) {
      const int nc = min(NC, n - n0);
      __syncthreads();  // the previous chunk is fully consumed
      for (int i = tid; i < nc * C; i += nth) xs[i] = to_f(xf[(size_t)n0 * C + i]);
      __syncthreads();

      // k (and in pass 1 v) projections of head h, four rows per weight load.
      const int RG = (nc + 3) / 4;
      for (int item = tid; item < RG * parts * D; item += nth) {
        const int rg = item / (parts * D), j = item - rg * parts * D;
        const int part = j / D, d = j - part * D;  // part 0: k, part 1: v
        const int col = (1 + part) * HD + h * D + d;
        const int r0 = rg * 4;
        const float* x0 = xs + (size_t)r0 * C;
        const float* x1 = xs + (size_t)min(r0 + 1, nc - 1) * C;
        const float* x2 = xs + (size_t)min(r0 + 2, nc - 1) * C;
        const float* x3 = xs + (size_t)min(r0 + 3, nc - 1) * C;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k = 0; k < C; ++k) {
          const float w = to_f(wqkv[(size_t)k * W3 + col]);
          a[0] += x0[k] * w;
          a[1] += x1[k] * w;
          a[2] += x2[k] * w;
          a[3] += x3[k] * w;
        }
        for (int u = 0; u < 4; ++u) {
          const int r = r0 + u;
          if (r < nc) {
            if (part == 0) ks[(size_t)r * KS + d] = a[u];
            else vs[(size_t)r * KS + d] = rnd<T>(a[u]);
          }
        }
      }
      __syncthreads();

      if (pass == 0) {
        // Online softmax statistics over the token axis, one feature per thread.
        if (tid < D) {
          const int d = tid;
          float mc = -INFINITY;
          for (int r = 0; r < nc; ++r) mc = fmaxf(mc, ks[(size_t)r * KS + d]);
          const float mold = mrun[d];
          const float mnew = fmaxf(mold, mc);
          float s = 0.f;
          for (int r = 0; r < nc; ++r) s += expf(ks[(size_t)r * KS + d] - mnew);
          srun[d] = srun[d] * expf(mold - mnew) + s;  // the factor is 0 on the first chunk
          mrun[d] = mnew;
        }
        continue;
      }

      // s = round(exp(k - max) / sum) with the frame's statistics, then ctx += s^T v (constant trip
      // count keeps acc in registers).
      for (int i = tid; i < nc * D; i += nth) {
        const int r = i / D, d = i - r * D;
        ks[(size_t)r * KS + d] = rnd<T>(expf(ks[(size_t)r * KS + d] - mrun[d]) / srun[d]);
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kMaxAcc; ++i) {
        const int idx = tid + i * nth;
        if (i < nacc && idx < D * D) {
          const int d = idx / D, e = idx - d * D;
          float s = 0.f;
          for (int r = 0; r < nc; ++r) s += ks[(size_t)r * KS + d] * vs[(size_t)r * KS + e];
          acc[i] += s;
        }
      }
    }
  }
  __syncthreads();

  float* out = ctx + ((size_t)frame * H + h) * D * D;
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int idx = tid + i * nth;
    if (i < nacc && idx < D * D) out[idx] = acc[i];
  }
  if (tid < D) {  // the k softmax's max and sum, for the backward
    const size_t at = ((size_t)frame * H + h) * D + tid;
    stats[at] = mrun[tid];
    stats[(size_t)gridDim.x * H * D + at] = srun[tid];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) sla_out_kernel(
    const T* __restrict__ x, const T* __restrict__ wqkv, const T* __restrict__ wo,
    const float* __restrict__ ctx, T* __restrict__ out, int n, int C, int H, int D,
    float scale, int NC) {
  extern __shared__ float smem[];
  const int QS = D + 1;
  float* xs = smem;                  // (NC, C)  token chunk
  float* ys = xs + (size_t)NC * C;   // (NC, C)  float32 sum over heads of o_h W_o,h
  float* qs = ys + (size_t)NC * C;   // (NC, QS) q, then its softmax
  float* os = qs + (size_t)NC * QS;  // (NC, QS) o_h
  float* cs = os + (size_t)NC * QS;  // (D, QS)  the head's context, rounded

  const int frame = blockIdx.x, n0 = blockIdx.y * NC;
  const int nc = min(NC, n - n0);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int HD = H * D, W3 = 3 * HD;
  const size_t base = ((size_t)frame * n + n0) * C;

  for (int i = tid; i < nc * C; i += nth) {
    xs[i] = to_f(x[base + i]);
    ys[i] = 0.f;
  }
  __syncthreads();

  const int RG = (nc + 3) / 4;
  for (int h = 0; h < H; ++h) {
    // q projection (float32) and the head's context rounded to x's type.
    for (int item = tid; item < RG * D; item += nth) {
      const int rg = item / D, d = item - rg * D;
      const int col = h * D + d;
      const int r0 = rg * 4;
      const float* x0 = xs + (size_t)r0 * C;
      const float* x1 = xs + (size_t)min(r0 + 1, nc - 1) * C;
      const float* x2 = xs + (size_t)min(r0 + 2, nc - 1) * C;
      const float* x3 = xs + (size_t)min(r0 + 3, nc - 1) * C;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < C; ++k) {
        const float w = to_f(wqkv[(size_t)k * W3 + col]);
        a[0] += x0[k] * w;
        a[1] += x1[k] * w;
        a[2] += x2[k] * w;
        a[3] += x3[k] * w;
      }
      for (int u = 0; u < 4; ++u)
        if (r0 + u < nc) qs[(size_t)(r0 + u) * QS + d] = a[u];
    }
    const float* ch = ctx + ((size_t)frame * H + h) * D * D;
    for (int i = tid; i < D * D; i += nth) cs[(i / D) * QS + i % D] = rnd<T>(ch[i]);
    __syncthreads();

    // Softmax over each token's D features, with this head's own max.
    for (int r = tid; r < nc; r += nth) {
      float* q = qs + (size_t)r * QS;
      float m = -INFINITY;
      for (int d = 0; d < D; ++d) m = fmaxf(m, q[d]);
      float s = 0.f;
      for (int d = 0; d < D; ++d) {
        const float e = expf(q[d] - m);
        q[d] = e;
        s += e;
      }
      for (int d = 0; d < D; ++d) {
        float v = q[d] / s;
        if (scale != 1.f) v *= scale;
        q[d] = rnd<T>(v);
      }
    }
    __syncthreads();

    // o_h = q ctx_h, rounded.
    for (int item = tid; item < nc * D; item += nth) {
      const int r = item / D, e = item - r * D;
      const float* q = qs + (size_t)r * QS;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += q[d] * cs[d * QS + e];
      os[(size_t)r * QS + e] = rnd<T>(s);
    }
    __syncthreads();

    // y += o_h W_o,h.
    for (int item = tid; item < RG * C; item += nth) {
      const int rg = item / C, cc = item - rg * C;
      const int r0 = rg * 4;
      const float* o0 = os + (size_t)r0 * QS;
      const float* o1 = os + (size_t)min(r0 + 1, nc - 1) * QS;
      const float* o2 = os + (size_t)min(r0 + 2, nc - 1) * QS;
      const float* o3 = os + (size_t)min(r0 + 3, nc - 1) * QS;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      for (int d = 0; d < D; ++d) {
        const float w = to_f(wo[(size_t)(h * D + d) * C + cc]);
        a[0] += o0[d] * w;
        a[1] += o1[d] * w;
        a[2] += o2[d] * w;
        a[3] += o3[d] * w;
      }
      for (int u = 0; u < 4; ++u)
        if (r0 + u < nc) ys[(size_t)(r0 + u) * C + cc] += a[u];
    }
    __syncthreads();
  }

  for (int i = tid; i < nc * C; i += nth) out[base + i] = from_f<T>(xs[i] + rnd<T>(ys[i]));
}

template <typename T>
static int launch_context(const void* x, const void* wqkv, void* ctx, void* stats, int frames,
                          int n, int c, int heads, int dim, int chunk, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)chunk * c + 2 * (size_t)chunk * (dim + 1) + 3 * dim);
  cudaError_t err = cudaFuncSetAttribute(
      sla_context_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sla_context_kernel<T><<<dim3(frames, heads), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv), static_cast<float*>(ctx),
      static_cast<float*>(stats), n, c, heads, dim, chunk);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_out(const void* x, const void* wqkv, const void* wo, const void* ctx, void* out,
                      int frames, int n, int c, int heads, int dim, float scale, int chunk,
                      cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (2 * (size_t)chunk * c + 2 * (size_t)chunk * (dim + 1) + (size_t)dim * (dim + 1));
  cudaError_t err = cudaFuncSetAttribute(
      sla_out_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(frames, (n + chunk - 1) / chunk);
  sla_out_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv), static_cast<const T*>(wo),
      static_cast<const float*>(ctx), static_cast<T*>(out), n, c, heads, dim, scale, chunk);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The forward with staged panels: the two kernels above, redesigned (tensor cores in bf16).
//
// The same function and rounding points as the TPU's `_ctx_stats_kernel` and `_out_kernel`.
// Every operand of their products is rounded to x's type in the TPU kernels' math (x, W_q, W_k,
// W_v, W_o, round(s), round(v), round(p * scale), round(ctx), round(o)), so in bf16 `mma.sync`
// with float32 accumulators keeps them; only the order of the sums changes.
//
// `sla_context_panel_kernel` runs twice over a grid of (frame, split, head group) CTAs, each
// split a contiguous range of the frame's token chunks (a frame alone would leave most SMs idle:
// 20 frames at the sampler's batch 2), each head group a contiguous range of heads (`ctx_plan`
// spreads the heads over CTAs where a frame's chunks alone leave a CTA too many serial steps:
// a CTA's heads run one after another, each waiting for its weights). The chunk's x rows are
// staged once in x's type for the CTA's heads, in chunks of a multiple of 16 tokens; each head's
// weights go through two buffers, the next head's copied asynchronously while this one computes.
//   pass 0: k = x W_k,h (float32); per (head, feature) and thread group a running max and sum
//           of exp(k - max) over the group's rows, merged over the groups in a fixed order into
//           the CTA's (max, sum) partial.
//   pass 1: the frame's max and sum, merged over the splits in a fixed order
//           (sum = sum_split sum_split exp(max_split - max); split 0 writes them to `stats`); then
//           per head one (c, 2D) product x [W_k,h | W_v,h] whose epilogue turns k into
//           round(exp(k - max) / sum) (the division taken as a product with the sum's reciprocal,
//           within an ulp of it, as `sla_bwd_kv` rebuilds s) and rounds v, and
//           ctx_h += round(s)^T round(v) in float32 in shared memory, written to the CTA's
//           partial once at its end.
// The partials are added in split order by `reduce_partials_kernel`: no atomics, so two runs
// are bit-equal. s is rounded after its normalisation over all n tokens, where the TPU kernels
// round it (the CUDA-core kernel above never rounds it). The extra cost is a second k product
// per token, 2 c D FLOPs per head.
//
// `sla_out_panel_kernel`: one CTA per (frame, token chunk), as the kernel above. Per head:
// q = x W_q,h (float32) and its softmax over the D features with the head's own max, then
// qc = round(p * scale); o = round(qc round(ctx_h)) and y += o W_o,h (through `panel_mma`) into
// a float32 panel in shared memory; then out = x + round(y). In bf16 q and its softmax stay in
// registers, a warp taking a 16-row strip and all D columns (three barriers per head); in float32
// q goes through shared memory and the softmax takes eight lanes per token (four barriers).
//
// Shapes whose 16-token chunk does not fit (at head dim 32: c above 688 / 576 in bf16, above
// 336 / 304 in float32, for the context / output kernel) take the CUDA-core kernels above;
// `ctx_plan` / `out_plan` (ops/spatial_linear_attention.py) and `sla_ctx_fits` / `sla_out_fits`
// choose alike.

// Each pass uses its own panels: k and the statistics in pass 0, round(s), round(v) and the
// contexts in pass 1, over the same two regions (`a`, `b`). HC is the CTA's head count.
struct SlaCtxPlan {
  int Cp, Dp, LDC, LDD, LDW, PSD, LDA, G;
  size_t x, a, b, mz, w, bytes;
};

__host__ __device__ inline SlaCtxPlan sla_ctx_plan(int NC, int C, int D, int HC, int elt) {
  SlaCtxPlan p;
  p.Cp = round16(C);
  p.Dp = round16(D);
  p.LDC = pad_ld(C);
  p.LDD = pad_ld(D);
  p.LDW = pad_ld(2 * p.Dp);
  p.PSD = p.Dp + 1;
  p.LDA = p.Dp + 4;
  p.G = kThreads / p.Dp;  // thread groups of pass 0's statistics
  const size_t a0 = (size_t)4 * NC * p.PSD, a1 = (size_t)2 * elt * NC * p.LDD;
  const size_t b0 = (size_t)4 * 2 * HC * p.G * p.Dp, b1 = (size_t)4 * HC * p.Dp * p.LDA;
  size_t at = 0;
  p.x = at;   at += (size_t)elt * NC * p.LDC;
  p.a = at;   at += a0 > a1 ? a0 : a1;
  p.b = at;   at += b0 > b1 ? b0 : b1;
  p.mz = at;  at += (size_t)4 * 2 * HC * p.Dp;
  at = (at + 15) / 16 * 16;
  p.w = at;   at += (size_t)2 * elt * p.Cp * p.LDW;
  p.bytes = at;
  return p;
}

__host__ __device__ inline bool sla_ctx_fits(int NC, int C, int D, int HC, int elt) {
  return NC % 16 == 0 && sla_ctx_plan(NC, C, D, HC, elt).bytes <= kSmemMax;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) sla_context_panel_kernel(
    const T* __restrict__ x, const T* __restrict__ wqkv, float* __restrict__ stat_part,
    float* __restrict__ ctx_part, float* __restrict__ stats, int n, int C, int H, int D, int NC,
    int pass) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int HC = H / gridDim.z, h0 = blockIdx.z * HC;  // this CTA's heads h0 .. h0 + HC - 1
  const SlaCtxPlan pl = sla_ctx_plan(NC, C, D, HC, sizeof(T));
  T* xs = reinterpret_cast<T*>(smem_raw + pl.x);           // (NC, Cp) token chunk
  float* ks = reinterpret_cast<float*>(smem_raw + pl.a);   // pass 0: (NC, Dp) k, float32
  T* sc = reinterpret_cast<T*>(smem_raw + pl.a);           // pass 1: (NC, Dp) round(s)
  T* vs = sc + (size_t)NC * pl.LDD;                        // pass 1: (NC, Dp) round(v)
  float* st = reinterpret_cast<float*>(smem_raw + pl.b);   // pass 0: (2, HC, G, Dp) running max, sum
  float* acc = reinterpret_cast<float*>(smem_raw + pl.b);  // pass 1: (HC, Dp, Dp) contexts, float32
  float* mz = reinterpret_cast<float*>(smem_raw + pl.mz);  // pass 1: (2, HC, Dp) max, 1 / sum
  T* wbuf = reinterpret_cast<T*>(smem_raw + pl.w);         // 2 x (W_k,h | W_v,h)
  const int Cp = pl.Cp, Dp = pl.Dp, LDC = pl.LDC, LDD = pl.LDD, LDW = pl.LDW, PSD = pl.PSD, LDA = pl.LDA,
            G = pl.G;

  const int frame = blockIdx.x, frames = gridDim.x, splits = gridDim.y;
  const int cta = blockIdx.y * frames + frame;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int HD = H * D, W3 = 3 * HD;
  float* mpart = stat_part;                               // (splits, frames, H, D) maxima
  float* zpart = stat_part + (size_t)splits * frames * HD;  // (splits, frames, H, D) sums
  float* cpart = ctx_part + ((size_t)cta * H + h0) * D * D;  // pass 1: this CTA's (HC, D, D) partial
  if (pass == 0) {
    for (int i = tid; i < HC * G * Dp; i += nth) {
      st[i] = -INFINITY;
      st[HC * G * Dp + i] = 0.f;
    }
  } else {
    for (int i = tid; i < HC * Dp * LDA; i += nth) acc[i] = 0.f;
    for (int i = tid; i < HC * Dp; i += nth) {  // the frame's statistics, the splits merged in order
      const int h = h0 + i / Dp, d = i % Dp;
      float m = -INFINITY, z = 0.f;
      if (d < D) {
        for (int sp = 0; sp < splits; ++sp) m = fmaxf(m, mpart[((size_t)sp * frames + frame) * HD + h * D + d]);
        for (int sp = 0; sp < splits; ++sp) {
          const size_t at = ((size_t)sp * frames + frame) * HD + h * D + d;
          if (zpart[at] > 0.f) z += zpart[at] * expf(mpart[at] - m);
        }
        if (blockIdx.y == 0) {
          const size_t at = ((size_t)frame * H + h) * D + d;
          stats[at] = m;
          stats[(size_t)frames * HD + at] = z;
        }
      }
      mz[i] = d < D ? m : 0.f;
      mz[HC * Dp + i] = d < D ? 1.f / z : 0.f;
    }
  }
  const int nchunks = (n + NC - 1) / NC, per = (nchunks + splits - 1) / splits;
  const int n_end = min(n, (int)(blockIdx.y + 1) * per * NC);

  auto load_head = [&](int j) {  // W_k,h (and in pass 1 W_v,h beside it) of head h0 + j into buffer j % 2
    T* w = wbuf + (size_t)(j & 1) * Cp * LDW;
    stage(w, LDW, wqkv + HD + (size_t)(h0 + j) * D, W3, C, D, Cp, Dp);
    if (pass == 1) stage(w + Dp, LDW, wqkv + 2 * HD + (size_t)(h0 + j) * D, W3, C, D, Cp, Dp);
    cp_async_commit();
  };

  for (int n0 = blockIdx.y * per * NC; n0 < n_end; n0 += NC) {
    const int nc = min(NC, n - n0);
    __syncthreads();  // the slots are initialised and the previous chunk consumed
    stage(xs, LDC, x + ((size_t)frame * n + n0) * C, C, nc, C, NC, Cp);
    load_head(0);

    for (int j = 0; j < HC; ++j) {  // the CTA's j-th head
      cp_async_wait_all();
      __syncthreads();  // its weights have landed; the previous head is done with the panels
      if (j + 1 < HC) load_head(j + 1);
      const T* w = wbuf + (size_t)(j & 1) * Cp * LDW;
      if (pass == 0) {
        // k = x W_k,h; then thread (g, d) folds the chunk's rows g, g + G, ... into its running max and sum.
        panel_mma<false, true>(xs, LDC, w, LDW, NC, Dp, Cp, [=](int r, int c, float v0, float v1) {
          ks[r * PSD + c] = v0;
          ks[r * PSD + c + 1] = v1;
        });
        __syncthreads();
        if (tid < G * Dp) {
          const int g = tid / Dp, d = tid - g * Dp;
          float mc = -INFINITY;
#pragma unroll 4
          for (int r = g; r < nc; r += G) mc = fmaxf(mc, ks[r * PSD + d]);
          if (d < D && mc > -INFINITY) {
            float* sm = st + (j * G + g) * Dp + d;
            float* sz = sm + HC * G * Dp;
            const float mo = *sm, mn = fmaxf(mo, mc);
            float z = mo == -INFINITY ? 0.f : *sz * expf(mo - mn);
#pragma unroll 4
            for (int r = g; r < nc; r += G) z += expf(ks[r * PSD + d] - mn);
            *sm = mn;
            *sz = z;
          }
        }
        continue;  // the next head's barrier protects ks
      }
      // k|v = x [W_k,h | W_v,h]: round(exp(k - max) / sum), zero past the chunk and past D; round(v).
      const float* mh = mz + j * Dp;
      const float* rz = mz + (HC + j) * Dp;
      panel_mma<false, true>(xs, LDC, w, LDW, NC, 2 * Dp, Cp, [=](int r, int c, float v0, float v1) {
        if (c < Dp) {
          const float s0 = r < nc && c < D ? expf(v0 - mh[c]) * rz[c] : 0.f;
          const float s1 = r < nc && c + 1 < D ? expf(v1 - mh[c + 1]) * rz[c + 1] : 0.f;
          st2(sc + r * LDD + c, s0, s1);
        } else {
          st2(vs + r * LDD + c - Dp, v0, v1);
        }
      });
      __syncthreads();
      // ctx_h += round(s)^T round(v) in shared memory; the next head's barrier protects sc and vs.
      panel_mma_add<true, true>(sc, LDD, vs, LDD, Dp, Dp, NC, acc + (size_t)j * Dp * LDA, LDA, D, D);
    }
  }
  __syncthreads();
  if (pass == 1) {
    for (int i = tid; i < HC * D * D; i += nth) {  // the CTA's partial, written once
      const int j = i / (D * D), d = (i / D) % D, e = i % D;
      cpart[i] = acc[((size_t)j * Dp + d) * LDA + e];
    }
  } else {
    for (int i = tid; i < HC * D; i += nth) {  // the CTA's partial, its groups merged in order
      const int j = i / D, d = i - j * D;
      const float* sm = st + j * G * Dp + d;
      const float* sz = sm + HC * G * Dp;
      float m = -INFINITY, z = 0.f;
      for (int g = 0; g < G; ++g) m = fmaxf(m, sm[g * Dp]);
      for (int g = 0; g < G; ++g)
        if (sz[g * Dp] > 0.f) z += sz[g * Dp] * expf(sm[g * Dp] - m);
      mpart[(size_t)cta * HD + h0 * D + i] = m;
      zpart[(size_t)cta * HD + h0 * D + i] = z;
    }
  }
}

constexpr int kCsPerThread = 16;  // elements of a (Dp, Dp) context panel per thread: Dp <= 64

struct SlaOutPlan {
  int Cp, Dp, LDC, LDF, LDD, PSD, WQ, WO;
  size_t x, y, p, qc, o, cs, w, bytes;
};

__host__ __device__ inline SlaOutPlan sla_out_plan(int NC, int C, int D, int elt) {
  SlaOutPlan p;
  p.Cp = round16(C);
  p.Dp = round16(D);
  p.LDC = pad_ld(C);
  p.LDF = p.Cp + 8;
  p.LDD = pad_ld(D);
  p.PSD = p.Dp + 1;
  p.WQ = p.Cp * p.LDD;  // W_q,h (Cp, Dp)
  p.WO = p.Dp * p.LDC;  // W_o,h (Dp, Cp)
  size_t at = 0;
  p.x = at;   at += (size_t)elt * NC * p.LDC;
  p.y = at;   at += (size_t)4 * NC * p.LDF;
  p.p = at;   at += elt == 2 ? 0 : (size_t)4 * NC * p.PSD;  // float32 q: the float32 route only
  p.qc = at;  at += (size_t)elt * NC * p.LDD;
  p.o = at;   at += (size_t)elt * NC * p.LDD;
  p.cs = at;  at += (size_t)elt * p.Dp * p.LDD;
  at = (at + 15) / 16 * 16;
  p.w = at;   at += (size_t)2 * elt * (p.WQ + p.WO);
  p.bytes = at;
  return p;
}

// The softmax takes at most four tokens per thread: chunks of up to 128 tokens.
__host__ __device__ inline bool sla_out_fits(int NC, int C, int D, int elt) {
  return NC % 16 == 0 && NC <= 128 && sla_out_plan(NC, C, D, elt).bytes <= kSmemMax;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) sla_out_panel_kernel(
    const T* __restrict__ x, const T* __restrict__ wqkv, const T* __restrict__ wo,
    const float* __restrict__ ctx, T* __restrict__ out, int n, int C, int H, int D, float scale,
    int NC) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SlaOutPlan pl = sla_out_plan(NC, C, D, sizeof(T));
  T* xs = reinterpret_cast<T*>(smem_raw + pl.x);           // (NC, Cp) token chunk
  float* ys = reinterpret_cast<float*>(smem_raw + pl.y);   // (NC, Cp) float32 sum of o_h W_o,h
  float* ps = reinterpret_cast<float*>(smem_raw + pl.p);   // float32 x: (NC, Dp) q, float32
  T* qc = reinterpret_cast<T*>(smem_raw + pl.qc);          // (NC, Dp) round(p * scale)
  T* os = reinterpret_cast<T*>(smem_raw + pl.o);           // (NC, Dp) round(o)
  T* cs = reinterpret_cast<T*>(smem_raw + pl.cs);          // (Dp, Dp) round(ctx_h)
  T* wbuf = reinterpret_cast<T*>(smem_raw + pl.w);         // 2 x (W_q,h | W_o,h)
  const int Cp = pl.Cp, Dp = pl.Dp, LDC = pl.LDC, LDF = pl.LDF, LDD = pl.LDD, PSD = pl.PSD;

  const int frame = blockIdx.x, n0 = blockIdx.y * NC;
  const int nc = min(NC, n - n0);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int HD = H * D, W3 = 3 * HD;
  const size_t base = ((size_t)frame * n + n0) * C;

  auto load_head = [&](int h) {  // W_q,h and W_o,h into buffer h % 2
    T* wq = wbuf + (size_t)(h & 1) * (pl.WQ + pl.WO);
    stage(wq, LDD, wqkv + (size_t)h * D, W3, C, D, Cp, Dp);
    stage(wq + pl.WQ, LDC, wo + (size_t)h * D * C, C, D, C, Dp, Cp);
    cp_async_commit();
  };

  stage(xs, LDC, x + base, C, nc, C, NC, Cp);
  load_head(0);
  for (int i = tid; i < NC * Cp; i += nth) ys[(i / Cp) * LDF + i % Cp] = 0.f;

  for (int h = 0; h < H; ++h) {
    cp_async_wait_all();
    __syncthreads();  // head h's weights have landed; the previous head is done with cs, os and its slot
    if (h + 1 < H) load_head(h + 1);
    const T* wq = wbuf + (size_t)(h & 1) * (pl.WQ + pl.WO);
    const T* wop = wq + pl.WQ;
    const float* ch = ctx + ((size_t)frame * H + h) * D * D;
    if constexpr (sizeof(T) == 2) {
      // The head's context, read into registers now and rounded into cs once q's phase is done, so that
      // its latency overlaps that phase.
      float cv[kCsPerThread];
#pragma unroll
      for (int u = 0; u < kCsPerThread; ++u) {
        const int i = tid + u * nth, d = i / Dp, e = i % Dp;
        cv[u] = i < Dp * Dp && d < D && e < D ? ch[d * D + e] : 0.f;
      }
      // q = x W_q,h and its softmax over the D features (float32, this head's own max) in registers: a
      // warp takes a 16-row strip and all Dp columns (Dp / 16 blocks), so each lane holds 2 rows x
      // Dp / 4 of q's columns and a row's four lanes reduce it with two shuffles. Then
      // qc = round(p * scale), zeros past the edges; the division and the scale are taken as one product
      // with scale / sum (within an ulp of them, as `sla_bwd_kv` rebuilds s).
      const int lane = tid & 31;
      for (int m0 = (tid >> 5) * 16; m0 < NC; m0 += nth / 2) {
        float acc[4][2][4];  // Dp <= 64: up to four 16-column blocks
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (16 * b < Dp) mma_block<false, true>(xs, LDC, wq, LDD, m0, 16 * b, Cp, acc[b]);
        const int c0 = (lane & 3) * 2;
        float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (16 * b < Dp && 16 * b + 8 * j + c0 + (e & 1) < D) mx[e >> 1] = fmaxf(mx[e >> 1], acc[b][j][e]);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          mx[t] = fmaxf(mx[t], __shfl_xor_sync(0xffffffffu, mx[t], 1));
          mx[t] = fmaxf(mx[t], __shfl_xor_sync(0xffffffffu, mx[t], 2));
        }
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const bool in = 16 * b < Dp && 16 * b + 8 * j + c0 + (e & 1) < D;
              acc[b][j][e] = in ? expf(acc[b][j][e] - mx[e >> 1]) : 0.f;
              sum[e >> 1] += acc[b][j][e];
            }
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          sum[t] += __shfl_xor_sync(0xffffffffu, sum[t], 1);
          sum[t] += __shfl_xor_sync(0xffffffffu, sum[t], 2);
          const int r = m0 + (lane >> 2) + 8 * t;
          sum[t] = r < nc ? scale / sum[t] : 0.f;  // rows past the chunk: zeros
        }
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int t = 0; t < 2; ++t)
              if (16 * b < Dp)
                st2(qc + (m0 + (lane >> 2) + 8 * t) * LDD + 16 * b + 8 * j + c0,
                    acc[b][j][2 * t] * sum[t], acc[b][j][2 * t + 1] * sum[t]);
      }
#pragma unroll
      for (int u = 0; u < kCsPerThread; ++u) {
        const int i = tid + u * nth;
        if (i < Dp * Dp) cs[(i / Dp) * LDD + i % Dp] = from_f<T>(cv[u]);
      }
    } else {
      // float32: the head's context into cs, q = x W_q,h on the CUDA cores into ps, then its softmax per token.
      for (int i = tid; i < Dp * Dp; i += nth) {
        const int d = i / Dp, e = i - d * Dp;
        cs[d * LDD + e] = from_f<T>(d < D && e < D ? ch[d * D + e] : 0.f);
      }
      panel_mma<false, true>(xs, LDC, wq, LDD, NC, Dp, Cp, [=](int r, int c, float v0, float v1) {
        ps[r * PSD + c] = v0;
        ps[r * PSD + c + 1] = v1;
      });
      __syncthreads();

      // Softmax over each token's D features (float32) with this head's own max, and qc = round(p * scale);
      // zeros past the edges. Eight lanes per token, each taking the features d = lane, lane + 8, ...
      // (D <= 64); a thread takes its four tokens tid / 8 + 32 i (NC <= 128) at once, so that their
      // latencies overlap. The division and the scale are taken as one product with scale / sum.
      const int sub = tid & 7;
      float ev[4][8], m[4], sum[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (tid >> 3) + 32 * i;
        m[i] = -INFINITY;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int d = sub + 8 * u;
          ev[i][u] = r < nc && d < D ? ps[r * PSD + d] : -INFINITY;
          m[i] = fmaxf(m[i], ev[i][u]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) m[i] = max8(m[i]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool live = (tid >> 3) + 32 * i < nc;
        sum[i] = 0.f;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          ev[i][u] = live && sub + 8 * u < D ? expf(ev[i][u] - m[i]) : 0.f;
          sum[i] += ev[i][u];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[i] = scale / sum8(sum[i]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (tid >> 3) + 32 * i;
        if (r >= NC) continue;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int d = sub + 8 * u;
          if (d < Dp) qc[r * LDD + d] = from_f<T>(r < nc && d < D ? ev[i][u] * sum[i] : 0.f);
        }
      }
    }
    __syncthreads();

    // o = round(qc ctx_h).
    panel_mma<false, true>(qc, LDD, cs, LDD, NC, Dp, Dp, [=](int r, int c, float v0, float v1) {
      st2(os + r * LDD + c, v0, v1);
    });
    __syncthreads();

    // y += o W_o,h; the next head's first barrier protects os, cs and the slot.
    panel_mma_add<false, true>(os, LDD, wop, LDC, NC, Cp, Dp, ys, LDF, NC, Cp);
  }
  __syncthreads();

  // out = x + round(y).
  for (int i = tid; i < nc * C; i += nth) {
    const int r = i / C, c = i - r * C;
    out[base + i] = from_f<T>(to_f(xs[r * LDC + c]) + rnd<T>(ys[r * LDF + c]));
  }
}

template <typename T>
static int launch_context_fwd(const void* x, const void* wqkv, void* ctx, void* stats, void* stat_part,
                              void* ctx_part, int frames, int splits, int groups, int n, int c, int heads,
                              int dim, int chunk, cudaStream_t stream, int* staged_out) {
  if (groups < 1 || heads % groups) return (int)cudaErrorInvalidValue;
  const bool staged = sla_ctx_fits(chunk, c, dim, heads / groups, sizeof(T));
  *staged_out = staged;
  if (!staged) return launch_context<T>(x, wqkv, ctx, stats, frames, n, c, heads, dim, chunk, stream);
  const size_t smem = sla_ctx_plan(chunk, c, dim, heads / groups, sizeof(T)).bytes;
  cudaError_t err = cudaFuncSetAttribute(sla_context_panel_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  for (int pass = 0; pass < 2; ++pass) {
    sla_context_panel_kernel<T><<<dim3(frames, splits, groups), kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(wqkv), static_cast<float*>(stat_part),
        static_cast<float*>(ctx_part), static_cast<float*>(stats), n, c, heads, dim, chunk, pass);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (splits == 1) return 0;  // the one partial is the contexts (the caller passed ctx as ctx_part)
  const size_t total = (size_t)frames * heads * dim * dim;
  return launch_reduce(static_cast<const float*>(ctx_part), splits, total, 1, (int)total,
                       static_cast<float*>(ctx), (int)total, stream);
}

template <typename T>
static int launch_out_fwd(const void* x, const void* wqkv, const void* wo, const void* ctx, void* out,
                          int frames, int n, int c, int heads, int dim, float scale, int chunk,
                          cudaStream_t stream, int* staged_out) {
  const bool staged = sla_out_fits(chunk, c, dim, sizeof(T));
  *staged_out = staged;
  if (!staged) return launch_out<T>(x, wqkv, wo, ctx, out, frames, n, c, heads, dim, scale, chunk, stream);
  const size_t smem = sla_out_plan(chunk, c, dim, sizeof(T)).bytes;
  cudaError_t err = cudaFuncSetAttribute(sla_out_panel_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sla_out_panel_kernel<T><<<dim3(frames, (n + chunk - 1) / chunk), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv), static_cast<const T*>(wo),
      static_cast<const float*>(ctx), static_cast<T*>(out), n, c, heads, dim, scale, chunk);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward, two kernels and the partial-sum reduction.
//
// They replace the TPU kernels `_bwd_q_kernel` (line 450, through
// `_q_path_pallas`) and `_bwd_kv_kernel` (line 534, through
// `_backward_pallas`); for wide frames they also take the place of
// `_ctx_stats_kernel` (line 246) and the chunked `_bwd_kv_chunk1_kernel` /
// `_bwd_kv_chunk2_kernel` (lines 610, 670), since neither kernel here holds
// a whole frame: both walk it in token chunks.
//
// The backward needs the forward's contexts and the k softmax's per-feature
// max and sum: the forward's context kernel writes both (`stats`), and the
// autograd function keeps them (at batch 8 of the flagship, 2.6 MB per
// spatial attention), so nothing is recomputed.
//
// Both kernels split each frame's token chunks over `gridDim.y` CTAs (a
// frame alone would leave most SMs idle: 80 frames at batch 8, 10 for the
// wide frame), CTA (frame, split) taking a contiguous range of chunks.
//
// `sla_bwd_q_kernel` walks its chunks and, per head, recomputes q's softmax
// and o = q ctx, and emits
//     dW_o += round(o)^T g,  do = round(g W_o^T),  dctx += round(q)^T do,
//     dq = p * (dp - sum_D(dp * p)),  dp = do ctx^T * scale,
//     dW_q += x^T round(dq),  dx_q = round(g + sum_h round(dq) W_q^T).
// dctx sums over the whole frame: each CTA writes its own partial.
//
// `sla_bwd_kv_kernel` (and its staged twin) runs twice. The k softmax runs over all n tokens, so
// its VJP needs rho = sum_n ds * s before any dk: pass 0 rebuilds s = exp(k -
// max) / sum from the saved statistics and sums, per (head, feature), a
// partial rho over its chunks, with ds = round(dctx) round(v)^T; pass 1 adds
// the frame's partials up and finishes dk = s * (ds - rho), dv =
// round(dctx)^T round(s), dW_k, dW_v and dx = round(dx_q + sum_h round(dk)
// W_k^T + round(dv) W_v^T). In float32 rounding is the identity, so the
// forward's context is s^T v and rho[d] = sum_e dctx[d, e] ctx[d, e], the
// same sum in another order: the staged kernel in float32 takes rho so and
// runs pass 1 alone. (In bf16 the context multiplies round(s), while rho
// needs float32 s.)
//
// Sums across CTAs (dctx, rho, the weight gradients) go through per-CTA
// float32 partials, added in a fixed order (`reduce_partials_kernel`, or the
// kv kernel's own loop for rho), so every result is deterministic. Rounding points follow the TPU kernels. The head groups
// and block-diagonal masks of the TPU kernels are not needed: every loop
// indexes one head.
//
// Bound: like the forward, about 2n(c * HD) FLOPs per projection and frame,
// and each kernel recomputes or back-propagates four or five of them
// (sla_bwd_kv: 12 c HD + 4 D HD FLOPs per token over x, dx_q and dx, about
// 0.14 ms per flagship training step against the bf16 tensor-core rate);
// tensor-core bound at small c, near the ridge at c = 256. Each kernel has
// two versions: the first (`sla_bwd_q_kernel`, `sla_bwd_kv_kernel`) multiplies
// on the CUDA cores in float32 with the weights read from device memory one
// element at a time; the staged ones (`sla_bwd_q_panel_kernel`,
// `sla_bwd_kv_panel_kernel`) stage the chunk and each head's weights in shared
// memory in x's type and run the products on the tensor cores in bf16. The
// planners `q_plan` / `kv_plan` (ops/spatial_linear_attention.py) and the
// launchers (`sla_tc_fits` / `sla_kv_fits`) choose the staged kernel wherever
// its 16-token chunk fits.

template <typename T>
__global__ void __launch_bounds__(kThreads) sla_bwd_q_kernel(
    const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ wqkv,
    const T* __restrict__ wo, const float* __restrict__ ctx, T* __restrict__ dxq,
    float* __restrict__ dctx, float* __restrict__ partial, int n, int C, int H, int D,
    float scale, int NC) {
  extern __shared__ float smem[];
  const int QS = D + 1;
  float* xs = smem;                  // (NC, C)  token chunk
  float* gs = xs + (size_t)NC * C;   // (NC, C)  its cotangent
  float* ys = gs + (size_t)NC * C;   // (NC, C)  float32 sum over heads of dq W_q^T
  float* ps = ys + (size_t)NC * C;   // (NC, QS) q softmax, then round(dq)
  float* qc = ps + (size_t)NC * QS;  // (NC, QS) round(p * scale)
  float* os = qc + (size_t)NC * QS;  // (NC, QS) round(o)
  float* ds = os + (size_t)NC * QS;  // (NC, QS) round(do)
  float* cs = ds + (size_t)NC * QS;  // (D, QS)  round(ctx_h)

  const int frame = blockIdx.x, frames = gridDim.x;
  const int cta = blockIdx.y * frames + frame;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int HD = H * D, W3 = 3 * HD;
  float* pwq = partial + (size_t)cta * 2 * C * HD;  // dW_q (C, HD)
  float* pwo = pwq + (size_t)C * HD;                // dW_o (HD, C)
  float* dc = dctx + (size_t)cta * H * D * D;       // this CTA's dctx partial (H, D, D)
  for (int i = tid; i < 2 * C * HD; i += nth) pwq[i] = 0.f;
  for (int i = tid; i < H * D * D; i += nth) dc[i] = 0.f;
  const int nchunks = (n + NC - 1) / NC, per = (nchunks + gridDim.y - 1) / gridDim.y;
  const int n_end = min(n, (int)(blockIdx.y + 1) * per * NC);

  for (int n0 = blockIdx.y * per * NC; n0 < n_end; n0 += NC) {
    const int nc = min(NC, n - n0);
    const size_t base = ((size_t)frame * n + n0) * C;
    __syncthreads();
    for (int i = tid; i < nc * C; i += nth) {
      xs[i] = to_f(x[base + i]);
      gs[i] = to_f(g[base + i]);
      ys[i] = 0.f;
    }
    __syncthreads();

    const int RG = (nc + 3) / 4;
    for (int h = 0; h < H; ++h) {
      // q projection (float32) and the head's context, rounded.
      for (int item = tid; item < RG * D; item += nth) {
        const int rg = item / D, d = item - rg * D;
        const int col = h * D + d;
        const int r0 = rg * 4;
        const float* x0 = xs + (size_t)r0 * C;
        const float* x1 = xs + (size_t)min(r0 + 1, nc - 1) * C;
        const float* x2 = xs + (size_t)min(r0 + 2, nc - 1) * C;
        const float* x3 = xs + (size_t)min(r0 + 3, nc - 1) * C;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k = 0; k < C; ++k) {
          const float w = to_f(wqkv[(size_t)k * W3 + col]);
          a[0] += x0[k] * w;
          a[1] += x1[k] * w;
          a[2] += x2[k] * w;
          a[3] += x3[k] * w;
        }
        for (int u = 0; u < 4; ++u)
          if (r0 + u < nc) ps[(size_t)(r0 + u) * QS + d] = a[u];
      }
      const float* ch = ctx + ((size_t)frame * H + h) * D * D;
      for (int i = tid; i < D * D; i += nth) cs[(i / D) * QS + i % D] = rnd<T>(ch[i]);
      __syncthreads();

      // Softmax over each token's D features (float32), and round(p * scale).
      for (int r = tid; r < nc; r += nth) {
        float* q = ps + (size_t)r * QS;
        float m = -INFINITY;
        for (int d = 0; d < D; ++d) m = fmaxf(m, q[d]);
        float s = 0.f;
        for (int d = 0; d < D; ++d) {
          const float e = expf(q[d] - m);
          q[d] = e;
          s += e;
        }
        for (int d = 0; d < D; ++d) {
          q[d] = q[d] / s;
          qc[(size_t)r * QS + d] = rnd<T>(q[d] * scale);
        }
      }
      __syncthreads();

      // o = round(qc . ctx) and do = round(g W_o,h^T).
      for (int item = tid; item < nc * D; item += nth) {
        const int r = item / D, e = item - r * D;
        const float* q = qc + (size_t)r * QS;
        float s = 0.f;
        for (int d = 0; d < D; ++d) s += q[d] * cs[d * QS + e];
        os[(size_t)r * QS + e] = rnd<T>(s);
      }
      for (int item = tid; item < nc * D; item += nth) {
        const int r = item / D, e = item - r * D;
        const float* gr = gs + (size_t)r * C;
        const T* wr = wo + (size_t)(h * D + e) * C;
        float s = 0.f;
        for (int cc = 0; cc < C; ++cc) s += gr[cc] * to_f(wr[cc]);
        ds[(size_t)r * QS + e] = rnd<T>(s);
      }
      __syncthreads();

      // dW_o,h += o^T g;  dctx_h += qc^T do;  dq (per token, over ps).
      for (int item = tid; item < D * C; item += nth) {
        const int e = item / C, cc = item - e * C;
        float s = 0.f;
        for (int r = 0; r < nc; ++r) s += os[(size_t)r * QS + e] * gs[(size_t)r * C + cc];
        pwo[(size_t)(h * D + e) * C + cc] += s;
      }
      for (int item = tid; item < D * D; item += nth) {
        const int d = item / D, e = item - d * D;
        float s = 0.f;
        for (int r = 0; r < nc; ++r) s += qc[(size_t)r * QS + d] * ds[(size_t)r * QS + e];
        dc[(size_t)h * D * D + item] += s;
      }
      for (int r = tid; r < nc; r += nth) {
        const float* dor = ds + (size_t)r * QS;
        float* p = ps + (size_t)r * QS;
        float sum = 0.f;
        for (int d = 0; d < D; ++d) {
          float dp = 0.f;
          for (int e = 0; e < D; ++e) dp += dor[e] * cs[d * QS + e];
          sum += dp * scale * p[d];
        }
        for (int d = 0; d < D; ++d) {
          float dp = 0.f;
          for (int e = 0; e < D; ++e) dp += dor[e] * cs[d * QS + e];
          p[d] = rnd<T>(p[d] * (dp * scale - sum));
        }
      }
      __syncthreads();

      // dW_q,h += x^T dq;  y += dq W_q,h^T.
      for (int item = tid; item < C * D; item += nth) {
        const int k = item / D, d = item - k * D;
        float s = 0.f;
        for (int r = 0; r < nc; ++r) s += xs[(size_t)r * C + k] * ps[(size_t)r * QS + d];
        pwq[(size_t)k * HD + h * D + d] += s;
      }
      for (int item = tid; item < RG * C; item += nth) {
        const int rg = item / C, k = item - rg * C;
        const int r0 = rg * 4;
        const float* p0 = ps + (size_t)r0 * QS;
        const float* p1 = ps + (size_t)min(r0 + 1, nc - 1) * QS;
        const float* p2 = ps + (size_t)min(r0 + 2, nc - 1) * QS;
        const float* p3 = ps + (size_t)min(r0 + 3, nc - 1) * QS;
        const T* wr = wqkv + (size_t)k * W3 + h * D;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        for (int d = 0; d < D; ++d) {
          const float w = to_f(wr[d]);
          a[0] += p0[d] * w;
          a[1] += p1[d] * w;
          a[2] += p2[d] * w;
          a[3] += p3[d] * w;
        }
        for (int u = 0; u < 4; ++u)
          if (r0 + u < nc) ys[(size_t)(r0 + u) * C + k] += a[u];
      }
      __syncthreads();
    }
    for (int i = tid; i < nc * C; i += nth) dxq[base + i] = from_f<T>(gs[i] + ys[i]);
  }
}

// The q path with staged panels: the kernel above, redesigned (tensor cores in bf16).
//
// The same function and rounding points. Every operand of its products is
// rounded to x's type in the TPU kernel's math (x, g, W_q, W_o,
// round(p * scale), round(ctx), o, do, dq), so in bf16 `mma.sync` with float32
// accumulators keeps them; only the order of the sums changes. Per head,
// through `panel_mma` (common.cuh; tensor cores for bf16 panels, the CUDA
// cores in float32 for float32 ones):
//     q = x W_q,h,  do = round(g W_o,h^T),  o = round(qc ctx),  dctx += qc^T do,
//     dp = do ctx^T,  dW_o,h += o^T g,  dW_q,h += x^T dq,  y += dq W_q,h^T;
// the two softmax rows (q's, and its VJP into dq) stay on the CUDA cores in
// float32, eight lanes per token. The chunk's x and g rows are staged once in
// x's type, in chunks of a multiple of 16 tokens; each head's W_q,h (c, D)
// and W_o,h (D, c) go through two buffers, the next head's copied
// asynchronously while this one computes. Five barriers per head. The weight
// gradients and dctx are one product per head and chunk, read-modify-written
// into the CTA's float32 partials once, and reduced in a fixed order by
// `reduce_partials_kernel`.
//
// A shape whose 16-token chunk does not fit (in bf16 c above about 400, in
// float32 about half that) takes the CUDA-core kernel above.

struct SlaTcPlan {
  int Cp, Dp, LDC, LDF, LDD, PSD, WQ, WO;
  size_t x, g, y, p, dp, qc, o, dob, dq, cs, w, bytes;
};

__host__ __device__ inline SlaTcPlan sla_tc_plan(int NC, int C, int D, int elt) {
  SlaTcPlan p;
  p.Cp = round16(C);
  p.Dp = round16(D);
  p.LDC = pad_ld(C);
  p.LDF = p.Cp + 8;
  p.LDD = pad_ld(D);
  p.PSD = p.Dp + 1;
  p.WQ = p.Cp * p.LDD;  // W_q,h (Cp, Dp)
  p.WO = p.Dp * p.LDC;  // W_o,h (Dp, Cp)
  size_t at = 0;
  p.x = at;   at += (size_t)elt * NC * p.LDC;
  p.g = at;   at += (size_t)elt * NC * p.LDC;
  p.y = at;   at += (size_t)4 * NC * p.LDF;
  p.p = at;   at += (size_t)4 * NC * p.PSD;
  p.dp = at;  at += (size_t)4 * NC * p.PSD;
  p.qc = at;  at += (size_t)elt * NC * p.LDD;
  p.o = at;   at += (size_t)elt * NC * p.LDD;
  p.dob = at; at += (size_t)elt * NC * p.LDD;
  p.dq = at;  at += (size_t)elt * NC * p.LDD;
  p.cs = at;  at += (size_t)elt * p.Dp * p.LDD;
  at = (at + 15) / 16 * 16;
  p.w = at;   at += (size_t)2 * elt * (p.WQ + p.WO);
  p.bytes = at;
  return p;
}

__host__ __device__ inline bool sla_tc_fits(int NC, int C, int D, int elt) {
  return NC % 16 == 0 && sla_tc_plan(NC, C, D, elt).bytes <= kSmemMax;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) sla_bwd_q_panel_kernel(
    const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ wqkv,
    const T* __restrict__ wo, const float* __restrict__ ctx, T* __restrict__ dxq,
    float* __restrict__ dctx, float* __restrict__ partial, int n, int C, int H, int D,
    float scale, int NC) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SlaTcPlan pl = sla_tc_plan(NC, C, D, sizeof(T));
  T* xs = reinterpret_cast<T*>(smem_raw + pl.x);     // (NC, Cp) token chunk
  T* gs = reinterpret_cast<T*>(smem_raw + pl.g);     // (NC, Cp) its cotangent
  float* ys = reinterpret_cast<float*>(smem_raw + pl.y);   // (NC, Cp) float32 sum of dq W_q^T
  float* ps = reinterpret_cast<float*>(smem_raw + pl.p);   // (NC, Dp) q, then its softmax
  float* dps = reinterpret_cast<float*>(smem_raw + pl.dp); // (NC, Dp) do ctx^T
  T* qc = reinterpret_cast<T*>(smem_raw + pl.qc);    // (NC, Dp) round(p * scale)
  T* os = reinterpret_cast<T*>(smem_raw + pl.o);     // (NC, Dp) round(o)
  T* dos = reinterpret_cast<T*>(smem_raw + pl.dob);  // (NC, Dp) round(do)
  T* dqs = reinterpret_cast<T*>(smem_raw + pl.dq);   // (NC, Dp) round(dq)
  T* cs = reinterpret_cast<T*>(smem_raw + pl.cs);    // (Dp, Dp) round(ctx_h)
  T* wbuf = reinterpret_cast<T*>(smem_raw + pl.w);   // 2 x (W_q,h | W_o,h)
  const int Cp = pl.Cp, Dp = pl.Dp, LDC = pl.LDC, LDF = pl.LDF, LDD = pl.LDD, PSD = pl.PSD;

  const int frame = blockIdx.x, frames = gridDim.x;
  const int cta = blockIdx.y * frames + frame;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int HD = H * D, W3 = 3 * HD;
  float* pwq = partial + (size_t)cta * 2 * C * HD;  // dW_q (C, HD)
  float* pwo = pwq + (size_t)C * HD;                // dW_o (HD, C)
  float* dc = dctx + (size_t)cta * H * D * D;       // this CTA's dctx partial (H, D, D)
  for (int i = tid; i < 2 * C * HD; i += nth) pwq[i] = 0.f;
  for (int i = tid; i < H * D * D; i += nth) dc[i] = 0.f;
  const int nchunks = (n + NC - 1) / NC, per = (nchunks + gridDim.y - 1) / gridDim.y;
  const int n_end = min(n, (int)(blockIdx.y + 1) * per * NC);

  auto load_head = [&](int h) {  // W_q,h and W_o,h into buffer h % 2
    T* wq = wbuf + (size_t)(h & 1) * (pl.WQ + pl.WO);
    stage(wq, LDD, wqkv + (size_t)h * D, W3, C, D, Cp, Dp);
    stage(wq + pl.WQ, LDC, wo + (size_t)h * D * C, C, D, C, Dp, Cp);
    cp_async_commit();
  };

  for (int n0 = blockIdx.y * per * NC; n0 < n_end; n0 += NC) {
    const int nc = min(NC, n - n0);
    const size_t base = ((size_t)frame * n + n0) * C;
    __syncthreads();  // the partials are zeroed and the previous chunk consumed
    stage(xs, LDC, x + base, C, nc, C, NC, Cp);
    stage(gs, LDC, g + base, C, nc, C, NC, Cp);
    load_head(0);
    for (int i = tid; i < NC * Cp; i += nth) ys[(i / Cp) * LDF + i % Cp] = 0.f;

    for (int h = 0; h < H; ++h) {
      cp_async_wait_all();
      __syncthreads();  // head h's weights have landed; the previous head is done with cs
      if (h + 1 < H) load_head(h + 1);
      const T* wq = wbuf + (size_t)(h & 1) * (pl.WQ + pl.WO);
      const T* wop = wq + pl.WQ;
      const float* ch = ctx + ((size_t)frame * H + h) * D * D;
      for (int i = tid; i < Dp * Dp; i += nth) {
        const int d = i / Dp, e = i - d * Dp;
        cs[d * LDD + e] = from_f<T>(d < D && e < D ? ch[d * D + e] : 0.f);
      }
      // q = x W_q,h (float32, into its softmax) and do = round(g W_o,h^T).
      panel_mma<false, true>(xs, LDC, wq, LDD, NC, Dp, Cp, [=](int r, int c, float v0, float v1) {
        ps[r * PSD + c] = v0;
        ps[r * PSD + c + 1] = v1;
      });
      panel_mma<false, false>(gs, LDC, wop, LDC, NC, Dp, Cp, [=](int r, int c, float v0, float v1) {
        st2(dos + r * LDD + c, v0, v1);
      });
      __syncthreads();

      // Softmax over each token's D features (float32), and qc = round(p * scale); zeros past the edges.
      // Eight lanes per token, each taking the features d = lane, lane + 8, ... (D <= 64).
      for (int r0 = 0; r0 < NC; r0 += nth / 8) {
        const int r = r0 + (tid >> 3), sub = tid & 7;
        const bool live = r < nc, in = r < NC;
        float* q = ps + (in ? r : 0) * PSD;
        T* qr = qc + (in ? r : 0) * LDD;
        float m = -INFINITY, sum = 0.f;
        for (int d = sub; d < D; d += 8)
          if (live) m = fmaxf(m, q[d]);
        m = max8(m);
        for (int d = sub; d < D; d += 8)
          if (live) {
            q[d] = expf(q[d] - m);
            sum += q[d];
          }
        sum = sum8(sum);
        for (int d = sub; d < Dp; d += 8) {
          if (live && d < D) {
            q[d] = q[d] / sum;
            qr[d] = from_f<T>(q[d] * scale);
          } else if (in) {
            qr[d] = from_f<T>(0.f);
          }
        }
      }
      __syncthreads();

      // o = round(qc ctx), dctx_h += qc^T do, dp = do ctx^T.
      panel_mma<false, true>(qc, LDD, cs, LDD, NC, Dp, Dp, [=](int r, int c, float v0, float v1) {
        st2(os + r * LDD + c, v0, v1);
      });
      panel_mma_add<true, true>(qc, LDD, dos, LDD, Dp, Dp, NC, dc + (size_t)h * D * D, D, D, D);
      panel_mma<false, false>(dos, LDD, cs, LDD, NC, Dp, Dp, [=](int r, int c, float v0, float v1) {
        dps[r * PSD + c] = v0;
        dps[r * PSD + c + 1] = v1;
      });
      __syncthreads();

      // dW_o,h += o^T g; dq = p * (dp * scale - sum_D(dp * scale * p)), rounded, per token.
      panel_mma_add<true, true>(os, LDD, gs, LDC, Dp, Cp, NC, pwo + (size_t)h * D * C, C, D, C);
      for (int r0 = 0; r0 < NC; r0 += nth / 8) {  // eight lanes per token, as for the softmax
        const int r = r0 + (tid >> 3), sub = tid & 7;
        const bool live = r < nc, in = r < NC;
        const float* p = ps + (in ? r : 0) * PSD;
        const float* dp = dps + (in ? r : 0) * PSD;
        T* dq = dqs + (in ? r : 0) * LDD;
        float sum = 0.f;
        for (int d = sub; d < D; d += 8)
          if (live) sum += dp[d] * scale * p[d];
        sum = sum8(sum);
        for (int d = sub; d < Dp; d += 8) {
          if (live && d < D) dq[d] = from_f<T>(p[d] * (dp[d] * scale - sum));
          else if (in) dq[d] = from_f<T>(0.f);
        }
      }
      __syncthreads();

      // dW_q,h += x^T dq;  y += dq W_q,h^T.
      panel_mma_add<true, true>(xs, LDC, dqs, LDD, Cp, Dp, NC, pwq + (size_t)h * D, HD, C, D);
      panel_mma_add<false, false>(dqs, LDD, wq, LDD, NC, Cp, Dp, ys, LDF, NC, Cp);
    }
    __syncthreads();
    for (int i = tid; i < nc * C; i += nth) {
      const int r = i / C, c = i - r * C;
      dxq[base + i] = from_f<T>(to_f(gs[r * LDC + c]) + ys[r * LDF + c]);
    }
  }
}

// k and v projections of head h for a chunk: ks float32, vs rounded.
template <typename T>
__device__ __forceinline__ void project_kv(const float* xs, const T* __restrict__ wqkv, float* ks,
                                           float* vs, int nc, int C, int HD, int h, int D) {
  const int QS = D + 1, W3 = 3 * HD;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int RG = (nc + 3) / 4;
  for (int item = tid; item < RG * 2 * D; item += nth) {
    const int rg = item / (2 * D), j = item - rg * 2 * D;
    const int part = j / D, d = j - part * D;
    const int col = (1 + part) * HD + h * D + d;
    const int r0 = rg * 4;
    const float* x0 = xs + (size_t)r0 * C;
    const float* x1 = xs + (size_t)min(r0 + 1, nc - 1) * C;
    const float* x2 = xs + (size_t)min(r0 + 2, nc - 1) * C;
    const float* x3 = xs + (size_t)min(r0 + 3, nc - 1) * C;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < C; ++k) {
      const float w = to_f(wqkv[(size_t)k * W3 + col]);
      a[0] += x0[k] * w;
      a[1] += x1[k] * w;
      a[2] += x2[k] * w;
      a[3] += x3[k] * w;
    }
    for (int u = 0; u < 4; ++u) {
      const int r = r0 + u;
      if (r < nc) {
        if (part == 0) ks[(size_t)r * QS + d] = a[u];
        else vs[(size_t)r * QS + d] = rnd<T>(a[u]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) sla_bwd_kv_kernel(
    const T* __restrict__ x, const T* __restrict__ wqkv, const float* __restrict__ dctx,
    const T* __restrict__ dxq, const float* __restrict__ stats, T* __restrict__ dx,
    float* __restrict__ rho_part, float* __restrict__ partial, int n, int C, int H, int D, int NC,
    int pass) {
  extern __shared__ float smem[];
  const int QS = D + 1;
  float* xs = smem;                   // (NC, C)  token chunk
  float* ys = xs + (size_t)NC * C;    // (NC, C)  float32 k/v-path dx over heads
  float* ks = ys + (size_t)NC * C;    // (NC, QS) k, then ds * s (pass 0) or round(s) (pass 1)
  float* vs = ks + (size_t)NC * QS;   // (NC, QS) round(v)
  float* dks = vs + (size_t)NC * QS;  // (NC, QS) round(dk)
  float* dvs = dks + (size_t)NC * QS; // (NC, QS) round(dv)
  float* cs = dvs + (size_t)NC * QS;  // (D, QS)  round(dctx_h)
  float* mz = cs + (size_t)D * QS;    // (2, D)   the head's k-softmax max and sum
  float* rho = mz + 2 * D;            // (H, D)   sum_n ds * s

  const int frame = blockIdx.x, frames = gridDim.x, splits = gridDim.y;
  const int cta = blockIdx.y * frames + frame;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int HD = H * D, W3 = 3 * HD;
  float* pwk = partial + (size_t)cta * 2 * C * HD;  // dW_k (C, HD)
  float* pwv = pwk + (size_t)C * HD;                // dW_v (C, HD)
  if (pass == 1) {
    for (int i = tid; i < 2 * C * HD; i += nth) pwk[i] = 0.f;
    for (int i = tid; i < HD; i += nth) {  // the frame's rho, its partials added in split order
      float s = 0.f;
      for (int sp = 0; sp < splits; ++sp) s += rho_part[((size_t)sp * frames + frame) * HD + i];
      rho[i] = s;
    }
  } else {
    for (int i = tid; i < HD; i += nth) rho[i] = 0.f;
  }
  const int nchunks = (n + NC - 1) / NC, per = (nchunks + splits - 1) / splits;
  const int n_end = min(n, (int)(blockIdx.y + 1) * per * NC);

  for (int n0 = blockIdx.y * per * NC; n0 < n_end; n0 += NC) {
    const int nc = min(NC, n - n0);
    const size_t base = ((size_t)frame * n + n0) * C;
    __syncthreads();
    for (int i = tid; i < nc * C; i += nth) {
      xs[i] = to_f(x[base + i]);
      ys[i] = 0.f;
    }
    __syncthreads();
    const int RG = (nc + 3) / 4;
    for (int h = 0; h < H; ++h) {
      project_kv<T>(xs, wqkv, ks, vs, nc, C, HD, h, D);
      const float* dch = dctx + ((size_t)frame * H + h) * D * D;
      for (int i = tid; i < D * D; i += nth) cs[(i / D) * QS + i % D] = rnd<T>(dch[i]);
      if (tid < D) {
        const size_t at = ((size_t)frame * H + h) * D + tid;
        mz[tid] = stats[at];
        mz[D + tid] = stats[(size_t)frames * HD + at];
      }
      __syncthreads();

      // s = exp(k - max) / sum;  ds = round(dctx) round(v)^T.
      for (int item = tid; item < nc * D; item += nth) {
        const int r = item / D, d = item - r * D;
        const float s = expf(ks[(size_t)r * QS + d] - mz[d]) / mz[D + d];
        const float* vr = vs + (size_t)r * QS;
        float dsv = 0.f;
        for (int e = 0; e < D; ++e) dsv += cs[d * QS + e] * vr[e];
        if (pass == 0) {
          ks[(size_t)r * QS + d] = dsv * s;
        } else {
          dks[(size_t)r * QS + d] = rnd<T>(s * (dsv - rho[h * D + d]));
          ks[(size_t)r * QS + d] = rnd<T>(s);
        }
      }
      __syncthreads();

      if (pass == 0) {
        for (int d = tid; d < D; d += nth) {
          float s = 0.f;
          for (int r = 0; r < nc; ++r) s += ks[(size_t)r * QS + d];
          rho[h * D + d] += s;
        }
        __syncthreads();
        continue;
      }

      // dv = round(dctx)^T round(s).
      for (int item = tid; item < nc * D; item += nth) {
        const int r = item / D, e = item - r * D;
        const float* sr = ks + (size_t)r * QS;
        float s = 0.f;
        for (int d = 0; d < D; ++d) s += cs[d * QS + e] * sr[d];
        dvs[(size_t)r * QS + e] = rnd<T>(s);
      }
      __syncthreads();

      // dW_k,h += x^T dk, dW_v,h += x^T dv;  y += dk W_k,h^T + dv W_v,h^T.
      for (int item = tid; item < 2 * C * D; item += nth) {
        const int part = item / (C * D), rest = item - part * C * D;
        const int k = rest / D, d = rest - k * D;
        const float* src = part == 0 ? dks : dvs;
        float s = 0.f;
        for (int r = 0; r < nc; ++r) s += xs[(size_t)r * C + k] * src[(size_t)r * QS + d];
        (part == 0 ? pwk : pwv)[(size_t)k * HD + h * D + d] += s;
      }
      for (int item = tid; item < RG * C; item += nth) {
        const int rg = item / C, k = item - rg * C;
        const int r0 = rg * 4;
        const int rr[4] = {r0, min(r0 + 1, nc - 1), min(r0 + 2, nc - 1), min(r0 + 3, nc - 1)};
        const T* wk = wqkv + (size_t)k * W3 + HD + h * D;
        const T* wv = wk + HD;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        for (int d = 0; d < D; ++d) {
          const float w1 = to_f(wk[d]), w2 = to_f(wv[d]);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            a[u] += dks[(size_t)rr[u] * QS + d] * w1 + dvs[(size_t)rr[u] * QS + d] * w2;
        }
        for (int u = 0; u < 4; ++u)
          if (r0 + u < nc) ys[(size_t)(r0 + u) * C + k] += a[u];
      }
      __syncthreads();
    }
    if (pass == 1)
      for (int i = tid; i < nc * C; i += nth) dx[base + i] = from_f<T>(to_f(dxq[base + i]) + ys[i]);
  }
  if (pass == 0) {
    __syncthreads();
    for (int i = tid; i < HD; i += nth) rho_part[(size_t)cta * HD + i] = rho[i];
  }
}

// The k/v path with staged panels: the kernel above, redesigned (tensor cores in bf16).
//
// The same function, passes and rounding points. Every operand of its
// products is rounded to x's type in the TPU kernel's math (x, W_k, W_v,
// round(v), round(dctx), round(s), dk, dv), so in bf16 `mma.sync` with float32
// accumulators keeps them; only the order of the sums changes. Per head h,
// through `panel_mma` (common.cuh; tensor cores for bf16 panels, the CUDA
// cores in float32 for float32 ones):
//     k|v = x [W_k,h | W_v,h]   (one product; the epilogue turns k into
//                                s = exp(k - max) / sum in float32, and rounds s and v),
//     ds = round(v) round(dctx_h)^T,
// and in pass 1 also
//     dk = round(s (ds - rho)) (in ds's epilogue),  dv = round(round(s) round(dctx_h)),
//     dW_k,h += x^T dk,  dW_v,h += x^T dv,  y += [dk | dv] [W_k,h | W_v,h]^T.
// Pass 0 multiplies ds by s in its epilogue and sums the chunk's rows per
// (head, feature) into a float32 slot per thread group, added up in a fixed
// order at the end (rho is a sum over the whole frame, so it needs its own
// pass; in float32 the forward's contexts give it, see above). The chunk's x rows are staged once in x's type, in chunks of a
// multiple of 16 tokens; each head's W_k,h | W_v,h, side by side as one
// (c, 2D) panel, goes through two buffers, the next head's copied
// asynchronously while this one computes; round(dctx_h) is staged once per
// head and chunk as a padded (D, D) panel. Three barriers per head. The
// weight gradients are one product per head and chunk each, read-modify-
// written into the CTA's float32 partials once (`panel_mma_add`: all of a
// block read, then written), and reduced in a fixed order by
// `reduce_partials_kernel`.
//
// A shape whose 16-token chunk does not fit (at head dim 32 and 8 heads: c
// above 544 in bf16, above 288 in float32) takes the CUDA-core kernel above.

struct SlaKvPlan {
  int Cp, Dp, LDC, LDF, LDD, LDW, PSD, G;
  size_t x, y, s, v, sc, dkv, cs, mz, rho, csum, w, bytes;
};

__host__ __device__ inline SlaKvPlan sla_kv_plan(int NC, int C, int D, int H, int elt) {
  SlaKvPlan p;
  p.Cp = round16(C);
  p.Dp = round16(D);
  p.LDC = pad_ld(C);
  p.LDF = p.Cp + 8;
  p.LDD = pad_ld(D);
  p.LDW = pad_ld(2 * p.Dp);
  p.PSD = p.Dp + 1;
  p.G = kThreads / p.Dp;  // thread groups of the rho column sums
  size_t at = 0;
  p.x = at;    at += (size_t)elt * NC * p.LDC;
  p.y = at;    at += (size_t)4 * NC * p.LDF;
  p.s = at;    at += (size_t)4 * NC * p.PSD;
  p.v = at;    at += (size_t)elt * NC * p.LDD;
  p.sc = at;   at += (size_t)elt * NC * p.LDD;
  p.dkv = at;  at += (size_t)elt * NC * p.LDW;
  p.cs = at;   at += (size_t)elt * p.Dp * p.LDD;
  p.mz = at;   at += (size_t)4 * 2 * H * p.Dp;
  p.rho = at;  at += (size_t)4 * H * p.Dp;
  p.csum = at; at += (size_t)4 * H * p.G * p.Dp;
  at = (at + 15) / 16 * 16;
  p.w = at;    at += (size_t)2 * elt * p.Cp * p.LDW;
  p.bytes = at;
  return p;
}

__host__ __device__ inline bool sla_kv_fits(int NC, int C, int D, int H, int elt) {
  return NC % 16 == 0 && sla_kv_plan(NC, C, D, H, elt).bytes <= kSmemMax;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) sla_bwd_kv_panel_kernel(
    const T* __restrict__ x, const T* __restrict__ wqkv, const float* __restrict__ dctx,
    const T* __restrict__ dxq, const float* __restrict__ stats, const float* __restrict__ ctx,
    T* __restrict__ dx, float* __restrict__ rho_part, float* __restrict__ partial, int n, int C, int H,
    int D, int NC, int pass) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SlaKvPlan pl = sla_kv_plan(NC, C, D, H, sizeof(T));
  T* xs = reinterpret_cast<T*>(smem_raw + pl.x);           // (NC, Cp) token chunk
  float* ys = reinterpret_cast<float*>(smem_raw + pl.y);   // (NC, Cp) float32 k/v-path dx over heads
  float* ss = reinterpret_cast<float*>(smem_raw + pl.s);   // (NC, Dp) s, float32 (pass 0: ds * s)
  T* vs = reinterpret_cast<T*>(smem_raw + pl.v);           // (NC, Dp) round(v)
  T* sc = reinterpret_cast<T*>(smem_raw + pl.sc);          // (NC, Dp) round(s)
  T* dkv = reinterpret_cast<T*>(smem_raw + pl.dkv);        // (NC, 2Dp) round(dk) | round(dv)
  T* cs = reinterpret_cast<T*>(smem_raw + pl.cs);          // (Dp, Dp) round(dctx_h)
  float* mz = reinterpret_cast<float*>(smem_raw + pl.mz);  // (2, H, Dp) k-softmax max and 1 / sum
  float* rho = reinterpret_cast<float*>(smem_raw + pl.rho);    // (H, Dp) sum_n ds * s (pass 1)
  float* csum = reinterpret_cast<float*>(smem_raw + pl.csum);  // (H, G, Dp) its partial sums (pass 0)
  T* wbuf = reinterpret_cast<T*>(smem_raw + pl.w);         // 2 x (W_k,h | W_v,h)
  const int Cp = pl.Cp, Dp = pl.Dp, LDC = pl.LDC, LDF = pl.LDF, LDD = pl.LDD, LDW = pl.LDW,
            PSD = pl.PSD, G = pl.G;

  const int frame = blockIdx.x, frames = gridDim.x, splits = gridDim.y;
  const int cta = blockIdx.y * frames + frame;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int HD = H * D, W3 = 3 * HD;
  float* pwk = partial + (size_t)cta * 2 * C * HD;  // dW_k (C, HD)
  float* pwv = pwk + (size_t)C * HD;                // dW_v (C, HD)
  for (int i = tid; i < H * Dp; i += nth) {
    const int h = i / Dp, d = i - h * Dp;
    const size_t at = ((size_t)frame * H + h) * D + d;
    const bool in = d < D;
    mz[i] = in ? stats[at] : 0.f;
    mz[H * Dp + i] = in ? 1.f / stats[(size_t)frames * HD + at] : 1.f;  // the reciprocal of the sum
    float r = 0.f;  // pass 1: the frame's rho, in float32 sum_e dctx * ctx from the forward's contexts
    if (pass == 1 && in) {  // (one pass), in bf16 its pass-0 partials added in split order
      if constexpr (sizeof(T) == 4) {
        const size_t at = (((size_t)frame * H + h) * D + d) * D;
        for (int e = 0; e < D; ++e) r += dctx[at + e] * ctx[at + e];
      } else {
        for (int sp = 0; sp < splits; ++sp) r += rho_part[((size_t)sp * frames + frame) * HD + h * D + d];
      }
    }
    rho[i] = r;
  }
  if (pass == 1) {
    for (int i = tid; i < 2 * C * HD; i += nth) pwk[i] = 0.f;
  } else {
    for (int i = tid; i < H * G * Dp; i += nth) csum[i] = 0.f;
  }
  const int nchunks = (n + NC - 1) / NC, per = (nchunks + splits - 1) / splits;
  const int n_end = min(n, (int)(blockIdx.y + 1) * per * NC);

  auto load_head = [&](int h) {  // W_k,h | W_v,h into buffer h % 2
    T* w = wbuf + (size_t)(h & 1) * Cp * LDW;
    stage(w, LDW, wqkv + HD + (size_t)h * D, W3, C, D, Cp, Dp);
    stage(w + Dp, LDW, wqkv + 2 * HD + (size_t)h * D, W3, C, D, Cp, Dp);
    cp_async_commit();
  };

  for (int n0 = blockIdx.y * per * NC; n0 < n_end; n0 += NC) {
    const int nc = min(NC, n - n0);
    const size_t base = ((size_t)frame * n + n0) * C;
    __syncthreads();  // the slots are initialised and the previous chunk consumed
    stage(xs, LDC, x + base, C, nc, C, NC, Cp);
    load_head(0);
    if (pass == 1)
      for (int i = tid; i < NC * Cp; i += nth) ys[(i / Cp) * LDF + i % Cp] = 0.f;

    for (int h = 0; h < H; ++h) {
      cp_async_wait_all();
      __syncthreads();  // head h's weights have landed; the previous head is done with the panels
      if (h + 1 < H) load_head(h + 1);
      const T* w = wbuf + (size_t)(h & 1) * Cp * LDW;
      const float* mh = mz + h * Dp;
      const float* rz = mz + (H + h) * Dp;
      // k|v = x [W_k,h | W_v,h]: s = exp(k - max) / sum in float32 (zero past the chunk and past D; the
      // division taken as a product with the sum's reciprocal, within an ulp of it) and round(s);
      // round(v). Padded columns of the weights are zero, so v is zero there.
      panel_mma<false, true>(xs, LDC, w, LDW, NC, 2 * Dp, Cp, [=](int r, int c, float v0, float v1) {
        if (c < Dp) {
          const float s0 = r < nc && c < D ? expf(v0 - mh[c]) * rz[c] : 0.f;
          const float s1 = r < nc && c + 1 < D ? expf(v1 - mh[c + 1]) * rz[c + 1] : 0.f;
          ss[r * PSD + c] = s0;
          ss[r * PSD + c + 1] = s1;
          st2(sc + r * LDD + c, s0, s1);
        } else {
          st2(vs + r * LDD + c - Dp, v0, v1);
        }
      });
      const float* dch = dctx + ((size_t)frame * H + h) * D * D;
      for (int i = tid; i < Dp * Dp; i += nth) {
        const int d = i / Dp, e = i - d * Dp;
        cs[d * LDD + e] = from_f<T>(d < D && e < D ? dch[d * D + e] : 0.f);
      }
      __syncthreads();

      if (pass == 0) {
        // ds = round(v) round(dctx_h)^T, times s in place; then each group's column sums.
        panel_mma<false, false>(vs, LDD, cs, LDD, NC, Dp, Dp, [=](int r, int c, float v0, float v1) {
          ss[r * PSD + c] *= v0;
          ss[r * PSD + c + 1] *= v1;
        });
        __syncthreads();
        if (tid < G * Dp) {
          const int g = tid / Dp, d = tid - g * Dp;
          float a = 0.f;
          for (int r = g; r < nc; r += G) a += ss[r * PSD + d];
          csum[(h * G + g) * Dp + d] += a;
        }
        continue;
      }

      // dk = round(s (ds - rho)) and dv = round(round(s) round(dctx_h)), side by side.
      const float* rh = rho + h * Dp;
      panel_mma<false, false>(vs, LDD, cs, LDD, NC, Dp, Dp, [=](int r, int c, float v0, float v1) {
        st2(dkv + r * LDW + c, ss[r * PSD + c] * (v0 - rh[c]), ss[r * PSD + c + 1] * (v1 - rh[c + 1]));
      });
      panel_mma<false, true>(sc, LDD, cs, LDD, NC, Dp, Dp, [=](int r, int c, float v0, float v1) {
        st2(dkv + r * LDW + Dp + c, v0, v1);
      });
      __syncthreads();

      // dW_k,h += x^T dk;  dW_v,h += x^T dv;  y += [dk | dv] [W_k,h | W_v,h]^T.
      panel_mma_add<true, true>(xs, LDC, dkv, LDW, Cp, Dp, NC, pwk + (size_t)h * D, HD, C, D);
      panel_mma_add<true, true>(xs, LDC, dkv + Dp, LDW, Cp, Dp, NC, pwv + (size_t)h * D, HD, C, D);
      panel_mma_add<false, false>(dkv, LDW, w, LDW, NC, Cp, 2 * Dp, ys, LDF, NC, Cp);
    }
    if (pass == 1) {
      __syncthreads();
      for (int i = tid; i < nc * C; i += nth) {
        const int r = i / C, c = i - r * C;
        dx[base + i] = from_f<T>(to_f(dxq[base + i]) + ys[r * LDF + c]);
      }
    }
  }
  if (pass == 0) {
    __syncthreads();
    for (int i = tid; i < HD; i += nth) {  // the CTA's rho partial, its groups added in order
      const int h = i / D, d = i - h * D;
      float r = 0.f;
      for (int g = 0; g < G; ++g) r += csum[(h * G + g) * Dp + d];
      rho_part[(size_t)cta * HD + i] = r;
    }
  }
}

template <typename T>
static int launch_bwd_q(const void* x, const void* g, const void* wqkv, const void* wo,
                        const void* ctx, void* dxq, void* dctx_part, void* dctx, void* partial,
                        void* dwq, void* dwo, int frames, int splits, int n, int c, int heads,
                        int dim, float scale, int chunk, cudaStream_t stream, int* staged) {
  cudaError_t err;
  *staged = sla_tc_fits(chunk, c, dim, sizeof(T));
  if (*staged) {
    const size_t smem = sla_tc_plan(chunk, c, dim, sizeof(T)).bytes;
    err = cudaFuncSetAttribute(sla_bwd_q_panel_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    sla_bwd_q_panel_kernel<T><<<dim3(frames, splits), kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(wqkv),
        static_cast<const T*>(wo), static_cast<const float*>(ctx), static_cast<T*>(dxq),
        static_cast<float*>(dctx_part), static_cast<float*>(partial), n, c, heads, dim, scale,
        chunk);
  } else {
    const size_t smem = sizeof(float) *
        (3 * (size_t)chunk * c + 4 * (size_t)chunk * (dim + 1) + (size_t)dim * (dim + 1));
    err = cudaFuncSetAttribute(sla_bwd_q_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    sla_bwd_q_kernel<T><<<dim3(frames, splits), kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(wqkv),
        static_cast<const T*>(wo), static_cast<const float*>(ctx), static_cast<T*>(dxq),
        static_cast<float*>(dctx_part), static_cast<float*>(partial), n, c, heads, dim, scale,
        chunk);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int hd = heads * dim;
  const size_t ctx_size = (size_t)frames * heads * dim * dim;
  int e = launch_reduce(static_cast<const float*>(dctx_part), splits, ctx_size, 1, (int)ctx_size,
                        static_cast<float*>(dctx), (int)ctx_size, stream);
  if (e != 0) return e;
  const size_t stride = 2 * (size_t)c * hd;
  const float* p = static_cast<const float*>(partial);
  e = launch_reduce(p, frames * splits, stride, c, hd, static_cast<float*>(dwq), hd, stream);
  if (e != 0) return e;
  return launch_reduce(p + (size_t)c * hd, frames * splits, stride, hd, c,
                       static_cast<float*>(dwo), c, stream);
}

template <typename T>
static int launch_bwd_kv(const void* x, const void* wqkv, const void* dctx, const void* dxq,
                         const void* stats, const void* ctx, void* dx, void* rho_part, void* partial,
                         void* dwk, void* dwv, int frames, int splits, int n, int c, int heads,
                         int dim, int chunk, cudaStream_t stream, int* staged_out) {
  const bool staged = sla_kv_fits(chunk, c, dim, heads, sizeof(T));
  const size_t smem = staged ? sla_kv_plan(chunk, c, dim, heads, sizeof(T)).bytes
                             : sizeof(float) * (2 * (size_t)chunk * c + 4 * (size_t)chunk * (dim + 1) +
                                                (size_t)dim * (dim + 1) + 2 * dim + (size_t)heads * dim);
  const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err = staged ? cudaFuncSetAttribute(sla_bwd_kv_panel_kernel<T>, attr, (int)smem)
                           : cudaFuncSetAttribute(sla_bwd_kv_kernel<T>, attr, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(frames, splits);
  for (int pass = staged && sizeof(T) == 4 ? 1 : 0; pass < 2; ++pass) {  // float32 staged: pass 1 alone
    if (staged) {
      sla_bwd_kv_panel_kernel<T><<<grid, kThreads, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(wqkv), static_cast<const float*>(dctx),
          static_cast<const T*>(dxq), static_cast<const float*>(stats), static_cast<const float*>(ctx),
          static_cast<T*>(dx), static_cast<float*>(rho_part), static_cast<float*>(partial), n, c, heads,
          dim, chunk, pass);
    } else {
      sla_bwd_kv_kernel<T><<<grid, kThreads, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(wqkv), static_cast<const float*>(dctx),
          static_cast<const T*>(dxq), static_cast<const float*>(stats), static_cast<T*>(dx),
          static_cast<float*>(rho_part), static_cast<float*>(partial), n, c, heads, dim, chunk, pass);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  *staged_out = staged;
  const int hd = heads * dim;
  const size_t stride = 2 * (size_t)c * hd;
  const float* p = static_cast<const float*>(partial);
  int e = launch_reduce(p, frames * splits, stride, c, hd, static_cast<float*>(dwk), hd, stream);
  if (e != 0) return e;
  return launch_reduce(p + (size_t)c * hd, frames * splits, stride, c, hd,
                       static_cast<float*>(dwv), hd, stream);
}

}  // namespace vdt

// dtype: 0 = float32, 1 = bfloat16. Each returns the cudaError_t of its launch.
// `stats` receives the k softmax's per-feature max (frames, H, D) followed by
// its sum (frames, H, D), float32. The staged kernel runs over frames x splits
// CTAs (`stat_part`: 2 x splits x frames x H x D floats; `ctx_part`: splits x
// frames x H x D x D, or ctx itself where splits is 1; each of the `groups`
// head groups, a divisor of heads, fills its own heads' slices); the CUDA-core
// one over frames x heads, without the workspaces. `*staged` is set to 1
// where the staged kernel ran, 0 where the CUDA-core one did.
extern "C" int sla_context_fwd(int dtype, const void* x, const void* wqkv, void* ctx, void* stats,
                               void* stat_part, void* ctx_part, int frames, int splits, int groups,
                               int n, int c, int heads, int dim, int chunk, void* stream, int* staged) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vdt::launch_context_fwd<float>(x, wqkv, ctx, stats, stat_part, ctx_part, frames, splits,
                                          groups, n, c, heads, dim, chunk, s, staged);
  if (dtype == 1)
    return vdt::launch_context_fwd<__nv_bfloat16>(x, wqkv, ctx, stats, stat_part, ctx_part, frames,
                                                  splits, groups, n, c, heads, dim, chunk, s, staged);
  return (int)cudaErrorInvalidValue;
}

extern "C" int sla_out_fwd(int dtype, const void* x, const void* wqkv, const void* wo,
                           const void* ctx, void* out, int frames, int n, int c, int heads,
                           int dim, float scale, int chunk, void* stream, int* staged) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vdt::launch_out_fwd<float>(x, wqkv, wo, ctx, out, frames, n, c, heads, dim, scale, chunk,
                                      s, staged);
  if (dtype == 1)
    return vdt::launch_out_fwd<__nv_bfloat16>(x, wqkv, wo, ctx, out, frames, n, c, heads, dim, scale,
                                              chunk, s, staged);
  return (int)cudaErrorInvalidValue;
}

// Backward, q path, over frames x splits CTAs: dx_q; dctx (frames, H, D, D),
// dW_q (c, HD) and dW_o (HD, c) float32, summed over the CTAs' partials
// (`dctx_part`: splits x frames x H x D x D; `partial`: frames x splits x
// 2 c HD floats). `*staged` is set to 1 where the staged kernel ran, 0 where
// the CUDA-core one did.
extern "C" int sla_bwd_q(int dtype, const void* x, const void* g, const void* wqkv, const void* wo,
                         const void* ctx, void* dxq, void* dctx_part, void* dctx, void* partial,
                         void* dwq, void* dwo, int frames, int splits, int n, int c, int heads,
                         int dim, float scale, int chunk, void* stream, int* staged) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vdt::launch_bwd_q<float>(x, g, wqkv, wo, ctx, dxq, dctx_part, dctx, partial, dwq, dwo,
                                    frames, splits, n, c, heads, dim, scale, chunk, s, staged);
  if (dtype == 1)
    return vdt::launch_bwd_q<__nv_bfloat16>(x, g, wqkv, wo, ctx, dxq, dctx_part, dctx, partial,
                                            dwq, dwo, frames, splits, n, c, heads, dim, scale,
                                            chunk, s, staged);
  return (int)cudaErrorInvalidValue;
}

// Backward, k/v path, over frames x splits CTAs (two passes): dx from dx_q,
// and dW_k, dW_v (c, HD) float32. `rho_part` holds splits x frames x HD
// floats, `partial` frames x splits x 2 c HD. `ctx` is the forward's contexts
// (frames, H, D, D) float32: the staged kernel in float32 takes rho = sum_e
// dctx * ctx from them (rounding is the identity there, so ctx = s^T v) and
// skips pass 0; bf16 does not read them. `*staged` is set to 1 where the
// staged kernel ran, 0 where the CUDA-core one did.
extern "C" int sla_bwd_kv(int dtype, const void* x, const void* wqkv, const void* dctx,
                          const void* dxq, const void* stats, const void* ctx, void* dx,
                          void* rho_part, void* partial, void* dwk, void* dwv, int frames,
                          int splits, int n, int c, int heads, int dim, int chunk, void* stream,
                          int* staged) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vdt::launch_bwd_kv<float>(x, wqkv, dctx, dxq, stats, ctx, dx, rho_part, partial, dwk,
                                     dwv, frames, splits, n, c, heads, dim, chunk, s, staged);
  if (dtype == 1)
    return vdt::launch_bwd_kv<__nv_bfloat16>(x, wqkv, dctx, dxq, stats, ctx, dx, rho_part, partial,
                                             dwk, dwv, frames, splits, n, c, heads, dim, chunk, s,
                                             staged);
  return (int)cudaErrorInvalidValue;
}
