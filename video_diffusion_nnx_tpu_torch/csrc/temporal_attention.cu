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
// bound is the bf16 tensor-core rate. The projections are 8c of the 8c + 4f
// FLOPs per row and head (86% at f = 10, c = 32). `temporal_fwd_panel_kernel`
// (below) puts them on the tensor cores, in bf16 or for float32 in
// split-precision TF32 (3xTF32), and the per-token products too;
// `temporal_fwd_kernel`, the first version, multiplies
// everything on the CUDA cores in float32, with the weights read from device
// memory one element at a time, and now runs only where the staged tile does
// not fit (`fwd_plan` in ops/temporal_attention.py and `tc_fwd_fits` choose
// alike) and `f32_fwd_takes_stream` keeps a float32 shape here.

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

// ---------------------------------------------------------------------------
// Forward with staged panels: the kernel above, redesigned (tensor cores in bf16, and in float32 in 3xTF32).
//
// The same function and rounding points as `temporal_fwd_kernel<T, BIAS>`.
// The operands of the two width-scaling products are already rounded to x's
// type in the TPU kernel's math (x, W_qkv, W_o, o_h), so in bf16 `mma.sync`
// with float32 accumulators keeps the rounding points; only the order of the
// sums changes. Per head h, through `tensor_mma` (common.cuh):
//     q|k|v = x W_part,h, one part at a time, the epilogue adding b_qkv,
//             rounding, and scaling q in x's type;
//     y += o_h W_o,h into a float32 shared accumulator (`tensor_mma_add`);
// on the tensor cores in either type: bf16 panels through mma.sync m16n8k16,
// float32 ones in split-precision TF32 (3xTF32: each operand split into a
// TF32 high and low part, three m16n8k8 products lo*hi + hi*lo + hi*hi per
// 8-deep step, each step summed in a fresh accumulator and added to the
// float32 total on the CUDA cores), which holds the float32 gates where one
// TF32 product would not. With those moved, the per-token f x f products set
// the time at the top level (f = 10, c = 32), so they run on the tensor cores
// too, in both types (in float32 faster than a CUDA-core branch at f = 10 and
// 16 on the H100, PERF.md §6): a 16-row block of query rows takes its logits
// against a window of keys, the whole tokens its rows touch (`key_window`: 32
// keys at f = 10, 16 at f = 16, 64 at f = 64), and keeps each row's own
// token's keys (`tensor_block`); the softmax (float32, eight lanes per row,
// the bias joining the logits before the row maximum) writes the rounded
// probabilities into the row's place in that window, zero elsewhere. q and
// the probabilities are rounded to x's type in the TPU kernel's math as well,
// so this changes only the order of sums. o_h = P V runs per block over its
// window. Where a block spans tokens (f = 10) that multiplies the other
// tokens' V rows by zero, and 0 x NaN (or infinity) would carry a NaN in one
// token into its neighbours' rows: so where the projection wrote a V that is
// not finite (`vbad`, or'ed over the CTA at the barrier before P V), P V runs
// once per token of the block over that token's keys alone, the other keys' V
// read as zeros (`tensor_keys`), each row keeping its own token's pass. For
// finite V the two give the same sums; the passes per token cost 10-11% of
// the bf16 kernel at f = 10 (PERF.md §6), so finite tiles take one. o_h is
// written over the q slots (q is no longer read).
//
// Staging. The tile's x rows go to shared memory once, in x's type (`stage`,
// asynchronous 8-byte copies), padded with zeros to 16 rows and to c rounded
// up to 16 columns. A head's weights go through a ring of two buffers, one
// (c, D) or (D, c) part at a time in the order W_q, W_k, W_v, W_o: part i+1
// is copied while part i is multiplied, one barrier per part and two more
// per head. out = x + round(y + b_o) is written once. bf16 tiles aim at two
// CTAs per SM; a float32 CTA holds an SM (the 3xTF32 fragments want its
// registers), its tile as many tokens as 227 KB holds. The bottleneck (f = 64,
// c = 256) takes 185 KB in bf16 for one token; a one-token tile over 227 KB
// (at f = 64 and head dim 32: c above 336 in bf16, above 208 in float32)
// keeps the CUDA-core kernel above, but in float32 where
// `f32_fwd_takes_stream` gives the shape to the streaming kernel.

// The widest window of keys a 16-row block of query rows attends to, rounded to 16: the whole tokens
// its rows touch. Blocks start at multiples of 16, so a block's first row lies at an offset into its
// token that is a multiple of g = gcd(16, F), at most F - g, where the block touches the most tokens.
__host__ __device__ inline int key_window(int F) {
  const int g = (F & -F) < 16 ? (F & -F) : 16;
  return round16(F * (1 + (F - g + 15) / F));
}

// The window of the block at row m0 of a tile of `rows` rows: its first key and its length.
__device__ __forceinline__ int2 block_window(int m0, int rows, int F) {
  const int ks = (m0 / F) * F;
  return make_int2(ks, (min(m0 + 15, rows - 1) / F + 1) * F - ks);
}

struct TcFwdPlan {
  int Rp, Cp, Dp, LDC, LDF, LDD, LDQ, WS, LW, LDP;
  size_t x, y, qkv, p, pw, w, bytes;
};

// Tiles also hold the probabilities in x's type by key window (pw) and 16 zero rows past the q|k|v panel,
// which the last block's window may reach.
__host__ __device__ inline TcFwdPlan tc_fwd_plan(int rows, int F, int C, int D, int elt) {
  TcFwdPlan p;
  p.Rp = round16(rows);
  p.Cp = round16(C);
  p.Dp = round16(D);
  p.LDC = pad_ld(C);
  p.LDF = p.Cp + 8;
  p.LDD = pad_ld(D);
  p.LDQ = pad_ld(3 * p.Dp);
  p.WS = p.Cp * p.LDD > p.Dp * p.LDC ? p.Cp * p.LDD : p.Dp * p.LDC;
  p.LW = key_window(F);
  p.LDP = pad_ld(p.LW);
  size_t at = 0;
  p.x = at;   at += (size_t)elt * p.Rp * p.LDC;
  p.y = at;   at += (size_t)4 * p.Rp * p.LDF;
  p.qkv = at; at += (size_t)elt * (p.Rp + 16) * p.LDQ;
  p.p = at;   at += (size_t)4 * p.Rp * (F + 1);
  p.pw = at;  at += (size_t)elt * p.Rp * p.LDP;
  p.w = at;   at += (size_t)2 * elt * p.WS;
  p.bytes = at;
  return p;
}

// The staged forward takes a shape when its tile of `bt` tokens fits shared memory.
__host__ __device__ inline bool tc_fwd_fits(int bt, int F, int C, int D, int elt) {
  return tc_fwd_plan(bt * F, F, C, D, elt).bytes <= kSmemMax;
}

// A float32 forward whose staged tile holds no token takes the streaming kernel of temporal_blockwise.cu in mode
// DENSE (3xTF32) rather than the CUDA-core kernel above where a token fills that kernel's one 64-key block (f = 64)
// and the head dim is at most 64. Measured on the H100 (PERF.md §6): faster at f = 64 (the fixed bottleneck, c =
// 256, head dim 32; c = 128, head dim 64), slower at f = 10, 16, 24, 32, 40 and 48 (head dims 32 and 64);
// f = 49-63 is not measured and keeps the CUDA-core kernel. ops/temporal_attention.py `_f32_fwd_takes_stream` is
// the same rule; the C entry below refuses a float32 shape it gives to the streaming kernel, except in a build with
// VDT_ANY_F32_ROUTE defined (kF32RuleChecked).
__host__ __device__ inline bool f32_fwd_takes_stream(int F, int C, int D) {
  return F == 64 && D <= 64 && !tc_fwd_fits(1, F, C, D, 4);
}

// Two CTAs per SM in bf16 (128 registers a thread); a float32 CTA holds an SM.
template <typename T, bool BIAS>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 1) temporal_fwd_panel_kernel(
    const T* __restrict__ x, const T* __restrict__ wqkv, const float* __restrict__ bqkv,
    const T* __restrict__ wo, const float* __restrict__ bo, const float* __restrict__ bias,
    T* __restrict__ out, int tokens, int F, int C, int H, int D, int BT, float scale_in) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TcFwdPlan pl = tc_fwd_plan(BT * F, F, C, D, sizeof(T));
  T* xs = reinterpret_cast<T*>(smem_raw + pl.x);          // (Rp, Cp) x
  float* ys = reinterpret_cast<float*>(smem_raw + pl.y);  // (Rp, Cp) float32 sum of o_h W_o,h
  T* qkv = reinterpret_cast<T*>(smem_raw + pl.qkv);       // (Rp, 3Dp) q|k|v of head h; o_h over q
  float* pr = reinterpret_cast<float*>(smem_raw + pl.p);  // (Rp, F+1) logits
  T* pw = reinterpret_cast<T*>(smem_raw + pl.pw);         // (Rp, LW) probabilities by key window
  T* wbuf = reinterpret_cast<T*>(smem_raw + pl.w);        // 2 x WS, the weight ring
  const int Rp = pl.Rp, Cp = pl.Cp, Dp = pl.Dp, LDC = pl.LDC, LDF = pl.LDF, LDD = pl.LDD,
            LDQ = pl.LDQ, WS = pl.WS, LW = pl.LW, LDP = pl.LDP, PS = F + 1;

  const int tid = threadIdx.x, nth = blockDim.x, lane = tid & 31, warp = tid >> 5, nwarps = nth >> 5;
  const int t0 = blockIdx.x * BT;
  const int rows = min(BT, tokens - t0) * F;
  const size_t base = (size_t)t0 * F * C;
  const int HD = H * D, W3 = 3 * HD;
  const float scale_q = rnd<T>(scale_in);

  // Weight part s of head h (s = 0..3: W_q, W_k, W_v, W_o) into ring slot i % 2.
  auto load_part = [&](int h, int s, int i) {
    T* dst = wbuf + (size_t)(i & 1) * WS;
    if (s == 3) stage(dst, LDC, wo + (size_t)h * D * C, C, D, C, Dp, Cp);  // (Dp, Cp): rows of W_o,h
    else stage(dst, LDD, wqkv + (size_t)s * HD + h * D, W3, C, D, Cp, Dp);  // (Cp, Dp)
    cp_async_commit();
  };
  auto part_ready = [&](int i) {  // wait for part i, and for everyone to be done with slot (i+1) % 2
    cp_async_wait_all();
    __syncthreads();
    return wbuf + (size_t)(i & 1) * WS;
  };

  stage(xs, LDC, x + base, C, rows, C, Rp, Cp);
  load_part(0, 0, 0);
  for (int i = tid; i < Rp * Cp; i += nth) ys[(i / Cp) * LDF + i % Cp] = 0.f;
  // the zeros of the windows (other tokens' keys) and of the rows past the q|k|v panel
  for (int i = tid; i < Rp * LW; i += nth) pw[(i / LW) * LDP + i % LW] = from_f<T>(0.f);
  for (int i = tid; i < 16 * LDQ; i += nth) qkv[(size_t)Rp * LDQ + i] = from_f<T>(0.f);

  for (int h = 0; h < H; ++h) {
    const int i0 = 4 * h;
    // 1. q|k|v = round(x W_part + b) (q then scaled and rounded again); zeros past D. vbad: the thread wrote
    // a V that is not finite.
    int vbad = 0;
    for (int part = 0; part < 3; ++part) {
      const T* w = part_ready(i0 + part);
      load_part(h, part + 1, i0 + part + 1);
      const float* bb = bqkv + part * HD + h * D;
      T* dst = qkv + part * Dp;
      tensor_mma<false, true>(xs, LDC, w, LDD, Rp, Dp, Cp, [=, &vbad](int r, int c, float v0, float v1) {
        float a = c < D ? rnd<T>(v0 + bb[c]) : 0.f;
        float b = c + 1 < D ? rnd<T>(v1 + bb[c + 1]) : 0.f;
        if (part == 0) {
          a = a * scale_q;
          b = b * scale_q;
        }
        if (part == 2 && !(isfinite(a) && isfinite(b))) vbad = 1;
        st2(dst + (size_t)r * LDQ + c, a, b);
      });
    }

    // 2-3. W_o,h has landed and q|k|v is complete: the logits (with the bias before the row
    // maximum), their float32 softmax rounded to x's type, and o_h = round(P V) over the q slots.
    // The softmax takes eight lanes per row, each taking the frames j = lane, lane + 8, ... (F <= 64).
    const T* w = part_ready(i0 + 3);
    if (h + 1 < H) load_part(h + 1, 0, i0 + 4);
    // Each 16-row block's logits against its key window (the whole tokens its rows touch) on the tensor
    // cores, keeping a row's own token's keys (float32, into pr); the softmax writes the rounded
    // probabilities into the row's window of pw, whose other keys stay zero; then o_h = P V per block on
    // the tensor cores over its window, or, where a V of the tile is not finite, once per token of the block
    // over that token's keys alone (`tensor_keys`).
    const int nb = LW / 16;
    for (int item = warp; item < (Rp / 16) * nb; item += nwarps) {
      const int m0 = (item / nb) * 16, n0 = (item % nb) * 16;
      if (m0 >= rows) continue;
      const int2 win = block_window(m0, rows, F);
      if (n0 >= win.y) continue;
      float acc[2][4];
      tensor_block<false>(qkv, LDQ, qkv + (size_t)win.x * LDQ + Dp, LDQ, m0, n0, Dp, acc);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = m0 + (lane >> 2) + (e >> 1) * 8, key = win.x + n0 + (lane & 3) * 2 + 8 * j + (e & 1);
          const int tk = r / F;
          if (r < rows && key / F == tk) pr[(size_t)r * PS + key - tk * F] = acc[j][e];
        }
    }
    __syncthreads();
    for (int r0 = 0; r0 < rows; r0 += nth / 8) {
      const int row = r0 + (tid >> 3), sub = tid & 7;
      const bool live = row < rows;
      const int rr = live ? row : rows - 1, tk = rr / F;
      const float* brow = BIAS ? bias + ((size_t)h * F + (rr - tk * F)) * F : nullptr;
      T* prow = pw + (size_t)rr * LDP + tk * F - block_window(rr & ~15, rows, F).x;
      float sv[8], m = -INFINITY, sum = 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int j = sub + 8 * u;
        sv[u] = 0.f;
        if (live && j < F) {
          sv[u] = pr[(size_t)rr * PS + j] + (BIAS ? brow[j] : 0.f);
          m = fmaxf(m, sv[u]);
        }
      }
      m = max8(m);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (live && sub + 8 * u < F) {
          sv[u] = expf(sv[u] - m);
          sum += sv[u];
        }
      sum = sum8(sum);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (live && sub + 8 * u < F) prow[sub + 8 * u] = from_f<T>(sv[u] / sum);
    }
    const bool one_pass = !__syncthreads_or(vbad);
    const int db = Dp / 16;
    for (int item = warp; item < (Rp / 16) * db; item += nwarps) {
      const int m0 = (item / db) * 16, n0 = (item % db) * 16;
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      if (m0 < rows) {
        const int2 win = block_window(m0, rows, F);
        const T* vw = qkv + (size_t)win.x * LDQ + 2 * Dp;
        if (one_pass) tensor_block<true>(pw, LDP, vw, LDQ, m0, n0, round16(win.y), acc);
        else  // one pass per token of the block over its keys alone; each row keeps its own token's
          for (int tk = m0 / F; tk * F < min(m0 + 16, rows); ++tk) {
            float part[2][4];
            tensor_keys(pw, LDP, vw, LDQ, m0, n0, tk * F - win.x, (tk + 1) * F - win.x, part);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if ((m0 + (lane >> 2) + 8 * (e >> 1)) / F == tk) acc[0][e] = part[0][e], acc[1][e] = part[1][e];
          }
      }
      const int r = m0 + (lane >> 2), c = n0 + (lane & 3) * 2;
      st2(qkv + (size_t)r * LDQ + c, acc[0][0], acc[0][1]);
      st2(qkv + (size_t)(r + 8) * LDQ + c, acc[0][2], acc[0][3]);
      st2(qkv + (size_t)r * LDQ + c + 8, acc[1][0], acc[1][1]);
      st2(qkv + (size_t)(r + 8) * LDQ + c + 8, acc[1][2], acc[1][3]);
    }
    __syncthreads();

    // 4. y += o_h W_o,h; the next head's first barrier protects o_h and the W_o slot.
    tensor_mma_add<false, true>(qkv, LDQ, w, LDC, Rp, Cp, Dp, ys, LDF, Rp, Cp);
  }
  __syncthreads();

  // 5. out = x + round(y + b_o).
  for (int i = tid; i < rows * C; i += nth) {
    const int r = i / C, c = i - r * C;
    out[base + i] = from_f<T>(to_f(xs[(size_t)r * LDC + c]) + rnd<T>(ys[(size_t)r * LDF + c] + bo[c]));
  }
}

template <typename T, bool BIAS>
static int launch(const void* x, const void* wqkv, const void* bqkv, const void* wo,
                  const void* bo, const void* bias, void* out, int tokens, int f, int c, int heads,
                  int dim, int bt, float scale, cudaStream_t stream, int* staged_out) {
  const bool staged = tc_fwd_fits(bt, f, c, dim, sizeof(T));
  const size_t smem = staged ? tc_fwd_plan(bt * f, f, c, dim, sizeof(T)).bytes
                             : sizeof(float) * (size_t)bt * f * (2 * c + 3 * dim + 1 + f + 1);
  auto kernel = staged ? temporal_fwd_panel_kernel<T, BIAS> : temporal_fwd_kernel<T, BIAS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (tokens + bt - 1) / bt;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv), static_cast<const float*>(bqkv),
      static_cast<const T*>(wo), static_cast<const float*>(bo), static_cast<const float*>(bias),
      static_cast<T*>(out), tokens, f, c, heads, dim, bt, scale);
  *staged_out = staged ? (sizeof(T) == 4 ? 3 : 1) : 0;  // 3: the staged kernel in float32, its products in 3xTF32
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
          dbias_partial[((size_t)blockIdx.x * H + h) * F * F + item] += s;
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

// ---------------------------------------------------------------------------
// Backward with staged panels: the kernel above, redesigned (tensor cores in bf16, and in float32 in
// 3xTF32).
//
// The same function and rounding points as `temporal_bwd_kernel<T, BIAS>`.
// Every operand of the products that scale with c is already rounded to x's
// type in the TPU kernel's math (x, g, W_qkv, W_o, q|k|v, o, do, dqkv), so in
// bf16 `mma.sync` with float32 accumulators reproduces the rounding points;
// only the order of the sums changes. Per head h the five width-scaling
// products:
//     q|k|v = x W_qkv,h (+ b, rounded),  do = round(g W_o,h^T),
//     dW_o,h += o^T g,  dW_qkv,h += x^T dqkv,  dx += dqkv W_qkv,h^T,
// run on the tensor cores in either type (`tensor_mma`, common.cuh): bf16 panels
// through mma.sync m16n8k16, float32 ones in split-precision TF32 (3xTF32:
// each operand split into a TF32 high and low part, three m16n8k8 products
// lo*hi + hi*lo + hi*hi per 8-deep step, each step summed in a fresh
// accumulator and added to the float32 total on the CUDA cores), which holds
// the float32 gates where one TF32 product would not. The per-token f x f
// attention products (logits, P V, P^T do, do V^T, ds k, ds^T q) are 12 f HD
// of the 22 c HD + 12 f HD FLOPs per row; they stay on the CUDA cores in
// float32, as do the softmax, its VJP and db_qkv from the unrounded dqkv: the
// logits with their softmax, and do V^T with the VJP, take eight lanes per
// row (shuffles for the row's maximum and sums); the other four one output
// per thread in bf16, four neighbouring columns a thread (float4 loads, four
// independent sums) in float32. (The float32 f x f products were tried on
// the tensor cores too, in 3xTF32 over 16-row key windows: at f = 10 the
// windows' masked columns and the recomputed logits made the kernel slower.)
//
// Staging. The tile's x and g rows go to shared memory once, in x's type
// (`stage`, asynchronous 8-byte copies), padded with zeros to 16 rows and to
// c rounded up to 16 columns. A head's weights go through a ring of two
// buffers, one (c, D) or (D, c) part at a time in the order W_q, W_k, W_v,
// W_o, W_q, W_k, W_v: part i+1 is copied asynchronously while part i is
// multiplied, and each part costs one barrier (nine or ten per head in all).
// The float32 dx accumulator (rows, c), the float32 probabilities and ds
// (rows, f), and two float32 column-sum slots per thread (db_qkv, summed in a
// fixed order) are float32 in both types. In bf16 the bottleneck (f = 64,
// c = 256) takes 226 KB for one token; smaller shapes aim at two CTAs per SM.
// In float32 one CTA holds an SM (the 3xTF32 fragments want its registers),
// its tile as many tokens as 227 KB holds, in any number of rows.
//
// Weight gradients: each head's dW_qkv,h and dW_o,h are one product over the
// tile's rows each, in registers, read-modify-written into the CTA's float32
// partial once per head and tile (`tensor_mma_red`: in bf16 a thread reads its
// eight elements before it writes them; in float32 each element is added with
// `red.global.add`, which does not stall the warp, by the one thread that owns
// it, in its program order); the partials and `reduce_partials_kernel` are as
// before, so runs stay bit-equal. Heads stay inside the tile loop:
// splitting heads over CTAs would need a cross-CTA sum of dx as well.
//
// A shape whose one-token tile does not fit (in bf16 c above about 260 at
// f = 64; in float32 about half that) takes the CUDA-core kernel above.

struct TcBwdPlan {
  int Rp, Cp, Dp, LDC, LDF, LDD, LDQ, WS;
  size_t x, g, dx, qkv, dqkv, p, o, dob, cs, w, bytes;
};

__host__ __device__ inline TcBwdPlan tc_bwd_plan(int rows, int F, int C, int D, int elt) {
  TcBwdPlan p;
  p.Rp = round16(rows);
  p.Cp = round16(C);
  p.Dp = round16(D);
  p.LDC = pad_ld(C);
  p.LDF = p.Cp + 8;
  p.LDD = pad_ld(D);
  p.LDQ = pad_ld(3 * p.Dp);
  p.WS = p.Cp * p.LDD > p.Dp * p.LDC ? p.Cp * p.LDD : p.Dp * p.LDC;
  size_t at = 0;
  p.x = at;    at += (size_t)elt * p.Rp * p.LDC;
  p.g = at;    at += (size_t)elt * p.Rp * p.LDC;
  p.dx = at;   at += (size_t)4 * p.Rp * p.LDF;
  p.qkv = at;  at += (size_t)elt * p.Rp * p.LDQ;
  p.dqkv = at; at += (size_t)elt * p.Rp * p.LDQ;
  p.p = at;    at += (size_t)4 * p.Rp * (F + 1);
  p.o = at;    at += (size_t)elt * p.Rp * p.LDD;
  p.dob = at;  at += (size_t)elt * p.Rp * p.LDD;
  p.cs = at;   at += (size_t)4 * 2 * kThreads;
  p.w = at;    at += (size_t)2 * elt * p.WS;
  p.bytes = at;
  return p;
}

// The tensor-core kernel takes a shape when its tile of `bt` tokens fits shared memory and a
// thread of the block is left for every column-sum slot (head dims up to 128).
__host__ __device__ inline bool tc_bwd_fits(int bt, int F, int C, int D, int elt) {
  return 2 * round16(D) <= kThreads && tc_bwd_plan(bt * F, F, C, D, elt).bytes <= kSmemMax;
}

// The backward's per-row dot products over a head's D columns: bf16 rows as `dot_rows`; float32 rows
// (16-byte aligned, D a multiple of 4) over float4 loads into four partial sums, four independent chains.
__device__ __forceinline__ float bdot(const bf16* a, const bf16* b, int D) { return dot_rows(a, b, D); }
__device__ __forceinline__ float bdot(const float* a, const float* b, int D) {
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int d = 0; d < D; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + d), y = *reinterpret_cast<const float4*>(b + d);
    s.x += x.x * y.x;
    s.y += x.y * y.y;
    s.z += x.z * y.z;
    s.w += x.w * y.w;
  }
  return (s.x + s.y) + (s.z + s.w);
}

// acc += w * v for the four floats of v (float32 rows of the per-token products, four columns a thread).
__device__ __forceinline__ void fma4(float4& acc, float w, const float* v) {
  const float4 x = *reinterpret_cast<const float4*>(v);
  acc.x += w * x.x;
  acc.y += w * x.y;
  acc.z += w * x.z;
  acc.w += w * x.w;
}

// Two CTAs per SM in bf16 (128 registers a thread); float32 tiles mostly fill an SM alone.
template <typename T, bool BIAS>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 1) temporal_bwd_panel_kernel(
    const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ wqkv,
    const float* __restrict__ bqkv, const T* __restrict__ wo, const float* __restrict__ bias,
    float* __restrict__ dbias_partial, T* __restrict__ dx, float* __restrict__ partial,
    int tokens, int F, int C, int H, int D, int BT, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TcBwdPlan pl = tc_bwd_plan(BT * F, F, C, D, sizeof(T));
  T* xs = reinterpret_cast<T*>(smem_raw + pl.x);      // (Rp, Cp) x
  T* gs = reinterpret_cast<T*>(smem_raw + pl.g);      // (Rp, Cp) g
  float* dxs = reinterpret_cast<float*>(smem_raw + pl.dx);  // (Rp, Cp) float32 sum of dqkv_h W_h^T
  T* qkv = reinterpret_cast<T*>(smem_raw + pl.qkv);   // (Rp, 3Dp) q|k|v of head h, rounded
  T* dqk = reinterpret_cast<T*>(smem_raw + pl.dqkv);  // (Rp, 3Dp) dq|dk|dv, rounded
  float* pr = reinterpret_cast<float*>(smem_raw + pl.p);    // (Rp, F+1) probabilities, then ds
  T* os = reinterpret_cast<T*>(smem_raw + pl.o);      // (Rp, Dp) o_h, rounded
  T* dos = reinterpret_cast<T*>(smem_raw + pl.dob);   // (Rp, Dp) do, rounded
  float* csum = reinterpret_cast<float*>(smem_raw + pl.cs); // (2, threads) column-sum slots
  T* wbuf = reinterpret_cast<T*>(smem_raw + pl.w);    // 2 x WS, the weight ring
  const int Rp = pl.Rp, Cp = pl.Cp, Dp = pl.Dp, LDC = pl.LDC, LDF = pl.LDF, LDD = pl.LDD,
            LDQ = pl.LDQ, WS = pl.WS, PS = F + 1;

  const int tid = threadIdx.x, nth = blockDim.x;
  const int HD = H * D, W3 = 3 * HD, D3 = 3 * D;
  // This CTA's partial: dW_qkv (C, 3HD) packed | db_qkv (3HD) | dW_o (HD, C) | db_o (C); the
  // offsets are taken where they are used, which keeps the kernel within 128 registers.
  float* pw = partial + (size_t)blockIdx.x * ((size_t)C * W3 + W3 + (size_t)HD * C + C);
  for (size_t i = tid; i < (size_t)C * W3 + W3 + (size_t)HD * C + C; i += nth) pw[i] = 0.f;
  if (BIAS)
    for (int i = tid; i < H * F * F; i += nth) dbias_partial[(size_t)blockIdx.x * H * F * F + i] = 0.f;
  const float scale_q = rnd<T>(scale);
  const int ntiles = (tokens + BT - 1) / BT;
  // Column-sum slots: dv by (group, d) with Gv groups, dq|dk by (group, j) with Gqk groups.
  const int Gv = max(1, nth / Dp), Gqk = max(1, nth / (2 * Dp));

  // Weight part s of head h (s = 0..6: W_q, W_k, W_v, W_o, W_q, W_k, W_v) into ring slot i % 2.
  auto load_part = [&](int h, int s, int i) {
    T* dst = wbuf + (size_t)(i & 1) * WS;
    if (s == 3) {
      stage(dst, LDC, wo + (size_t)h * D * C, C, D, C, Dp, Cp);  // (Dp, Cp): rows of W_o,h
    } else {
      const int part = s < 3 ? s : s - 4;
      stage(dst, LDD, wqkv + (size_t)part * HD + h * D, W3, C, D, Cp, Dp);  // (Cp, Dp)
    }
    cp_async_commit();
  };
  auto part_ready = [&](int i) {  // wait for part i, and for everyone to be done with slot (i+1) % 2
    cp_async_wait_all();
    __syncthreads();
    return wbuf + (size_t)(i & 1) * WS;
  };

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int t0 = tile * BT;
    const int rows = min(BT, tokens - t0) * F;
    const size_t base = (size_t)t0 * F * C;
    __syncthreads();  // the partials are zeroed and the previous tile consumed
    stage(xs, LDC, x + base, C, rows, C, Rp, Cp);
    stage(gs, LDC, g + base, C, rows, C, Rp, Cp);
    load_part(0, 0, 0);
    for (int i = tid; i < Rp * Cp; i += nth) dxs[(i / Cp) * LDF + i % Cp] = 0.f;

    for (int h = 0; h < H; ++h) {
      const int i0 = 7 * h;
      // 1. q|k|v = round(x W_part + b) (q then scaled and rounded again), on the tensor cores.
      for (int part = 0; part < 3; ++part) {
        const T* w = part_ready(i0 + part);
        load_part(h, part + 1, i0 + part + 1);
        const float* bb = bqkv + part * HD + h * D;
        T* dst = qkv + part * Dp;
        tensor_mma<false, true>(xs, LDC, w, LDD, Rp, Dp, Cp, [=](int r, int c, float v0, float v1) {
          float a = 0.f, b = 0.f;
          if (c < D) {
            a = rnd<T>(v0 + bb[c]);
            b = rnd<T>(v1 + bb[c + 1]);
            if (part == 0) {
              a = a * scale_q;
              b = b * scale_q;
            }
          }
          st2(dst + (size_t)r * LDQ + c, a, b);
        });
      }

      // 2. W_o,h has landed and q|k|v is complete: do = round(g W_o,h^T) on the tensor cores, and
      // the logits and their float32 softmax, kept unrounded for the VJP.
      {
        const T* w = part_ready(i0 + 3);
        load_part(h, 4, i0 + 4);
        tensor_mma<false, false>(gs, LDC, w, LDC, Rp, Dp, Cp, [=](int r, int c, float v0, float v1) {
          st2(dos + (size_t)r * LDD + c, v0, v1);
        });
        // Eight lanes per row, each taking the frames j = lane, lane + 8, ... (F <= 64).
        for (int r0 = 0; r0 < rows; r0 += nth / 8) {
          const int row = r0 + (tid >> 3), sub = tid & 7;
          const bool live = row < rows;
          const int rr = live ? row : rows - 1, tk = rr / F;
          const T* q = qkv + (size_t)rr * LDQ;
          const T* kb = qkv + (size_t)tk * F * LDQ + Dp;
          const float* brow = BIAS ? bias + ((size_t)h * F + (rr - tk * F)) * F : nullptr;
          float sv[8], m = -INFINITY, sum = 0.f;
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int j = sub + 8 * u;
            sv[u] = 0.f;
            if (live && j < F) {
              sv[u] = bdot(q, kb + (size_t)j * LDQ, D) + (BIAS ? brow[j] : 0.f);
              m = fmaxf(m, sv[u]);
            }
          }
          m = max8(m);
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (live && sub + 8 * u < F) {
              sv[u] = expf(sv[u] - m);
              sum += sv[u];
            }
          sum = sum8(sum);
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (live && sub + 8 * u < F) pr[(size_t)rr * PS + sub + 8 * u] = sv[u] / sum;
        }
      }
      __syncthreads();

      // 3. o_h = round(round(P) V) and dv = round(P)^T do (unrounded dv summed per column in a
      // slot of its own, then rounded); padded rows and columns are written as zeros.
      if constexpr (sizeof(T) == 4) {  // float32: four columns a thread, o and dv together
        const int DQ = Dp / 4;
        for (int item = tid; item < Rp * DQ; item += nth) {
          const int row = item / DQ, d = (item - row * DQ) * 4;
          float4 o4 = make_float4(0.f, 0.f, 0.f, 0.f), v4 = o4;
          if (row < rows && d < D) {
            const int tk = row / F, j0 = row - tk * F;
            const float* p = pr + (size_t)row * PS;
            const float* pc = pr + (size_t)tk * F * PS + j0;
            const T* vb = qkv + (size_t)tk * F * LDQ + 2 * Dp + d;
            const T* ob = dos + (size_t)tk * F * LDD + d;
            for (int j = 0; j < F; ++j) {
              fma4(o4, p[j], vb + (size_t)j * LDQ);
              fma4(v4, pc[(size_t)j * PS], ob + (size_t)j * LDD);
            }
          }
          *reinterpret_cast<float4*>(os + (size_t)row * LDD + d) = o4;
          *reinterpret_cast<float4*>(dqk + (size_t)row * LDQ + 2 * Dp + d) = v4;
        }
      } else {
        for (int item = tid; item < Rp * Dp; item += nth) {
          const int row = item / Dp, d = item - row * Dp;
          float s = 0.f;
          if (row < rows && d < D) {
            const int tk = row / F;
            const float* p = pr + (size_t)row * PS;
            const T* vb = qkv + (size_t)tk * F * LDQ + 2 * Dp + d;
            for (int j = 0; j < F; ++j) s += rnd<T>(p[j]) * to_f(vb[(size_t)j * LDQ]);
          }
          os[(size_t)row * LDD + d] = from_f<T>(s);
        }
        if (tid < Gv * Dp) {
          const int grp = tid / Dp, d = tid - grp * Dp;
          float cs = 0.f;
          for (int row = grp; row < Rp; row += Gv) {
            float s = 0.f;
            if (row < rows && d < D) {
              const int tk = row / F, j = row - tk * F;
              const float* pc = pr + (size_t)tk * F * PS + j;
              const T* ob = dos + (size_t)tk * F * LDD + d;
              for (int i = 0; i < F; ++i) s += rnd<T>(pc[(size_t)i * PS]) * to_f(ob[(size_t)i * LDD]);
            }
            cs += s;
            dqk[(size_t)row * LDQ + 2 * Dp + d] = from_f<T>(s);
          }
          csum[tid] = cs;
        }
      }
      __syncthreads();

      // 4. dW_o,h += o_h^T g on the tensor cores, once per head and tile; and, per row,
      // ds = P * (dattn - sum_j dattn P) with dattn = do V^T, over P (rounded unless a bias
      // needs the unrounded ds for dbias).
      tensor_mma_red<true, true>(os, LDD, gs, LDC, Dp, Cp, Rp, pw + (size_t)C * W3 + W3 + (size_t)h * D * C, C,
                              D, C);  // dW_o,h
      for (int r0 = 0; r0 < rows; r0 += nth / 8) {  // eight lanes per row, as for the softmax
        const int row = r0 + (tid >> 3), sub = tid & 7;
        const bool live = row < rows;
        const int rr = live ? row : rows - 1, tk = rr / F;
        const T* dob = dos + (size_t)rr * LDD;
        const T* vb = qkv + (size_t)tk * F * LDQ + 2 * Dp;
        float* p = pr + (size_t)rr * PS;
        float da[8], sum = 0.f;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int j = sub + 8 * u;
          da[u] = 0.f;
          if (live && j < F) {
            da[u] = bdot(dob, vb + (size_t)j * LDQ, D);
            sum += da[u] * p[j];
          }
        }
        sum = sum8(sum);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int j = sub + 8 * u;
          if (live && j < F) {
            const float ds = p[j] * (da[u] - sum);
            p[j] = BIAS ? ds : rnd<T>(ds);
          }
        }
      }
      __syncthreads();

      // 4b. dbias[h] += the tile's token sum of the unrounded ds, in token order; ds rounds in place.
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
          dbias_partial[((size_t)blockIdx.x * H + h) * F * F + item] += s;
        }
        __syncthreads();
      }

      // 5. dq = (ds k) * scale and dk = ds^T q, by (group, column): the unrounded values summed
      // per column into the thread's slot, the rounded ones into dq|dk.
      if constexpr (sizeof(T) == 4) {  // float32: four columns a thread
        const int DQ = Dp / 4;
        for (int item = tid; item < Rp * 2 * DQ; item += nth) {
          const int row = item / (2 * DQ), jq = item - row * 2 * DQ;
          const bool dq = jq < DQ;
          const int d = (dq ? jq : jq - DQ) * 4;
          float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
          if (row < rows && d < D) {
            const int tk = row / F, i0r = row - tk * F;
            if (dq) {
              const float* p = pr + (size_t)row * PS;
              const T* kb = qkv + (size_t)tk * F * LDQ + Dp + d;
              for (int jj = 0; jj < F; ++jj) fma4(s4, p[jj], kb + (size_t)jj * LDQ);
              s4 = make_float4(s4.x * scale, s4.y * scale, s4.z * scale, s4.w * scale);
            } else {
              const float* pc = pr + (size_t)tk * F * PS + i0r;
              const T* qb = qkv + (size_t)tk * F * LDQ + d;
              for (int i = 0; i < F; ++i) fma4(s4, pc[(size_t)i * PS], qb + (size_t)i * LDQ);
            }
          }
          *reinterpret_cast<float4*>(dqk + (size_t)row * LDQ + (dq ? 0 : Dp) + d) = s4;
        }
      } else {
        if (tid < Gqk * 2 * Dp) {
          const int grp = tid / (2 * Dp), j = tid - grp * 2 * Dp;
          const int d = j < Dp ? j : j - Dp;
          float cs = 0.f;
          for (int row = grp; row < Rp; row += Gqk) {
            float s = 0.f;
            if (row < rows && d < D) {
              const int tk = row / F, i0r = row - tk * F;
              if (j < Dp) {
                const float* p = pr + (size_t)row * PS;
                const T* kb = qkv + (size_t)tk * F * LDQ + Dp + d;
                for (int jj = 0; jj < F; ++jj) s += p[jj] * to_f(kb[(size_t)jj * LDQ]);
                s *= scale;
              } else {
                const float* pc = pr + (size_t)tk * F * PS + i0r;
                const T* qb = qkv + (size_t)tk * F * LDQ + d;
                for (int i = 0; i < F; ++i) s += pc[(size_t)i * PS] * to_f(qb[(size_t)i * LDQ]);
              }
            }
            cs += s;
            dqk[(size_t)row * LDQ + j] = from_f<T>(s);
          }
          csum[kThreads + tid] = cs;
        }
      }

      // 6. Per part of dqkv (W_q, W_k, W_v again): dW_part,h += x^T dpart and dx += dpart W_part^T,
      // both on the tensor cores; with the first part, db_qkv += the column sums in group order.
      for (int part = 0; part < 3; ++part) {
        const T* w = part_ready(i0 + 4 + part);
        if (part < 2) load_part(h, 5 + part, i0 + 5 + part);
        else if (h + 1 < H) load_part(h + 1, 0, i0 + 7);
        if (part == 0) {
          for (int j = tid; j < D3; j += nth) {
            const int pt = j / D, d = j - pt * D;
            float s = 0.f;
            if constexpr (sizeof(T) == 4) {  // the unrounded dq|dk|dv, summed over the rows in order
              for (int r = 0; r < rows; ++r) s += dqk[(size_t)r * LDQ + pt * Dp + d];
            } else if (pt < 2) {
              for (int grp = 0; grp < Gqk; ++grp) s += csum[kThreads + grp * 2 * Dp + pt * Dp + d];
            } else {
              for (int grp = 0; grp < Gv; ++grp) s += csum[grp * Dp + d];
            }
            pw[(size_t)C * W3 + pt * HD + h * D + d] += s;  // db_qkv
          }
        }
        const T* dp = dqk + part * Dp;
        tensor_mma_red<true, true>(xs, LDC, dp, LDQ, Cp, Dp, Rp, pw + part * HD + h * D, W3, C, D);
        tensor_mma_add<false, false>(dp, LDQ, w, LDD, Rp, Cp, Dp, dxs, LDF, Rp, Cp);
      }
    }
    __syncthreads();

    // db_o += token sum of g; dx = round(g + dx_attention).
    for (int c = tid; c < C; c += nth) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s += to_f(gs[(size_t)r * LDC + c]);
      pw[(size_t)C * W3 + W3 + (size_t)HD * C + c] += s;  // db_o
    }
    for (int i = tid; i < rows * C; i += nth) {
      const int r = i / C, c = i - r * C;
      dx[base + i] = from_f<T>(to_f(gs[(size_t)r * LDC + c]) + dxs[(size_t)r * LDF + c]);
    }
  }
}

template <typename T, bool BIAS>
static int launch_bwd(const void* x, const void* g, const void* wqkv, const void* bqkv,
                      const void* wo, const void* bias, void* dbias_partial, void* dbias, void* dx,
                      void* partial, void* grads, int tokens, int f, int c, int heads, int dim,
                      int bt, int grid, float scale, cudaStream_t stream, int* staged) {
  cudaError_t err;
  const bool fits = tc_bwd_fits(bt, f, c, dim, sizeof(T));
  *staged = fits ? (sizeof(T) == 4 ? 3 : 1) : 0;  // 3: the staged kernel with its float32 products in 3xTF32
  if (fits) {
    const size_t smem = tc_bwd_plan(bt * f, f, c, dim, sizeof(T)).bytes;
    err = cudaFuncSetAttribute(temporal_bwd_panel_kernel<T, BIAS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    temporal_bwd_panel_kernel<T, BIAS><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(wqkv),
        static_cast<const float*>(bqkv), static_cast<const T*>(wo), static_cast<const float*>(bias),
        static_cast<float*>(dbias_partial), static_cast<T*>(dx), static_cast<float*>(partial),
        tokens, f, c, heads, dim, bt, scale);
  } else {
    const size_t rows = (size_t)bt * f;
    const size_t smem = sizeof(float) * rows * (2 * c + 2 * (3 * dim + 1) + f + 1 + dim + 1);
    err = cudaFuncSetAttribute(temporal_bwd_kernel<T, BIAS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    temporal_bwd_kernel<T, BIAS><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(wqkv),
        static_cast<const float*>(bqkv), static_cast<const T*>(wo), static_cast<const float*>(bias),
        static_cast<float*>(dbias_partial), static_cast<T*>(dx), static_cast<float*>(partial),
        tokens, f, c, heads, dim, bt, scale);
  }
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
// instantiation). Returns the cudaError_t of the launch; `*staged` is set to 1 where the staged
// kernel ran in bf16, 3 where it ran in float32 (its products in 3xTF32), 0 where the CUDA-core one
// did. A float32 shape that `f32_fwd_takes_stream` gives to the streaming kernel is refused.
extern "C" int temporal_attention_fwd(int dtype, const void* x, const void* wqkv,
                                      const void* bqkv, const void* wo, const void* bo,
                                      const void* bias, void* out, int tokens, int f, int c,
                                      int heads, int dim, int bt, float scale, void* stream,
                                      int* staged) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vdt::kF32RuleChecked && vdt::f32_fwd_takes_stream(f, c, dim)) return (int)cudaErrorInvalidValue;
#define VDT_FWD(T, B) \
  vdt::launch<T, B>(x, wqkv, bqkv, wo, bo, bias, out, tokens, f, c, heads, dim, bt, scale, s, staged)
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
// `*staged` is 1 where the staged kernel ran in bf16, 3 where it ran in float32
// (its products in 3xTF32), 0 where the CUDA-core kernel did. A float32 shape that
// `f32_takes_tf32x3` gives to temporal_tf32x3.cu is refused (see kF32RuleChecked).
extern "C" int temporal_attention_bwd(int dtype, const void* x, const void* g, const void* wqkv,
                                      const void* bqkv, const void* wo, const void* bias,
                                      void* dbias_partial, void* dbias, void* dx, void* partial,
                                      void* grads, int tokens, int f, int c, int heads, int dim,
                                      int bt, int grid, float scale, void* stream, int* staged) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bias && !(dbias_partial && dbias)) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && vdt::kF32RuleChecked && vdt::f32_takes_tf32x3(f, c, dim)) return (int)cudaErrorInvalidValue;
#define VDT_BWD(T, B)                                                                           \
  vdt::launch_bwd<T, B>(x, g, wqkv, bqkv, wo, bias, dbias_partial, dbias, dx, partial, grads, \
                        tokens, f, c, heads, dim, bt, grid, scale, s, staged)
  if (dtype == 0) return bias ? VDT_BWD(float, true) : VDT_BWD(float, false);
  if (dtype == 1) return bias ? VDT_BWD(__nv_bfloat16, true) : VDT_BWD(__nv_bfloat16, false);
#undef VDT_BWD
  return (int)cudaErrorInvalidValue;
}
