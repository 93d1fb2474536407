// Blockwise (online-softmax) temporal-attention block for long clips,
// forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of video_diffusion_nnx_tpu/ops/temporal_attention.py
// `_fwd_blockwise_kernel` (line 405, through `_forward_blockwise`) and
// `_bwd_blockwise_kernel` (line 432, through `_backward_blockwise`), which
// carry every attention over more than 64 frames. The function is the dense
// kernels' (temporal_attention.cu),
//
//     out = x + sum_h softmax(q_h k_h^T / sqrt(D)) v_h W_o,h + b_o
//
// over the f axis of x (tokens, f, c), but no f x f panel exists anywhere:
// a running row maximum m, row sum l and unnormalised accumulator (all
// float32) are updated one KV block of KB = 32 frames at a time.
//
// Rounding points are the TPU blockwise kernels', which differ from the dense
// ones: q = round((x W_q + b_q) * scale), rounded once; k|v = round(x W + b);
// p = exp(s - m) is rounded to x's type before the p v product while l sums
// the unrounded p; o_h = acc / l is rounded before its W_o product, which
// accumulates in float32 over heads; out = x + round(y + b_o). The backward
// rebuilds p = exp(s - lse) from lse = m + log l, takes di = rowsum(do * o_h)
// from the unrounded do and o_h, rounds p, do, ds, dk|dv and dq to x's type
// before each product, sums db from the unrounded values, and keeps every
// weight gradient in float32.
//
// Two designs. The streaming kernels (`temporal_stream_fwd_kernel`,
// `temporal_stream_bwd_kernel`, below the first design; see their note) stage
// x, g and the weights in c-chunks, keep a token's q|k|v in shared memory and
// run every product on the tensor cores (bf16, or float32 in split-precision
// TF32); in mode DENSE they also carry
// the wide columns of f <= 64 that the dense kernels cannot hold, with the
// dense kernels' rounding points. They take every shape whose plan fits; the
// first design (`temporal_blockwise_fwd_kernel`, `..._bwd_kernel`) runs only
// where it does not: head dims over 32; in float32 the forward beyond f = 288
// and the backward beyond f = 160; in bf16 the forward beyond f = 288 at
// c >= 256 and the backward beyond f = 192 at c >= 128 (256 at c = 64, 320 at
// c = 32). `choose` and `sw_plan` decide, and
// ops/temporal_attention.py's `blockwise_plan` / `stream_plan` decide alike.
//
// First design. One CTA owns one token column at a time (a persistent grid
// walks the tokens). Shared memory holds only per-head panels whose size
// follows f and KB, never f^2 or c: q, the accumulator, one K|V block, one
// score block and the row statistics (the backward adds do, dk|dv and a
// second score block). x and g are read from device memory where a product
// needs them, so the kernels take any c. Across heads the CTA keeps the
// rounded o_h (and, in the backward, the rounded dq|dk|dv) in a scratch
// column of its own in device memory; the output projection, dx, dW_qkv and
// dW_o are then single products over all heads after the head loop. The TPU
// pads f to 8 sublanes and masks padded keys with -1e9; here the ragged last
// block is a loop bound. Every product runs through `mm`, a register-blocked
// loop on the CUDA cores in float32.
//
// Weight gradients cross CTAs as in temporal_attention.cu: each CTA adds
// into its own float32 partial and `reduce_partials_kernel` sums the partials
// in block order, so results are bit-equal from run to run.
//
// Bias. With `bias` (H, f, f) float32, the fixed-math relative position bias,
// bias[h, i, j] is added to the float32 logit of query frame i and key frame
// j before the row maximum, in the forward and wherever the backward rebuilds
// p (the TPU kernels' `bias_ref`; their KV-major transpose and padding of the
// bias are dropped, it is read with its own stride f). The backward also
// emits dbias: ds = p (dp - di), float32 and unrounded, summed over tokens.
// All H*f*f sums live across a CTA's tokens, more than shared memory holds
// beside the panels (512 KB at f = 128), so each CTA adds into an (H, f, f)
// partial of its own in device memory (`dbias_partial`): within one launch
// every element is added to by the same thread, once per token, in token
// order; no atomics. The partials are then reduced in block order like the
// weight gradients'. The first design takes the bias as a template flag, the
// streaming kernels as a null pointer or not.
//
// Bound on this card. Per token row the function needs 8*c*H*D + 4*f*H*D
// FLOPs forward and 22*c*H*D + 12*f*H*D backward (the dense backward's
// count), against 2 (3 in the backward) elements of c moved: far above the
// H100's FLOP-per-byte ridge, so the bound is the bf16 tensor-core rate.
// The first design's backward does 4*c*H*D + 2*f*H*D more than the function
// needs (K|V projected and the logits rebuilt in both sweeps); the streaming
// backward projects K|V once and rebuilds the logits in three sweeps (4*f*H*D
// more). `mma.sync` m16n8k16 is the streaming kernels' product; wgmma tiles
// and TMA are later work.

#include "common.cuh"

namespace vdt {

// Shapes of one launch, and the strides of the shared-memory panels (odd, so
// that row-wise loops spread over the banks).
struct Dims {
  int F, C, H, D, KB, HD, W3, QS, KS, PS;
  __host__ __device__ Dims(int f, int c, int h, int d, int kb)
      : F(f), C(c), H(h), D(d), KB(kb), HD(h * d), W3(3 * h * d), QS(d + 1), KS(2 * d + 1), PS(kb + 1) {}
  // Floats of shared memory: q and the accumulator, one K|V block, one score
  // block, m and l; the backward adds do, dk|dv, a second score block and di.
  __host__ __device__ size_t fwd_floats() const {
    return (size_t)2 * F * QS + (size_t)KB * KS + (size_t)F * PS + 2 * F;
  }
  __host__ __device__ size_t bwd_floats() const {
    return (size_t)3 * F * QS + (size_t)2 * KB * KS + (size_t)2 * F * PS + 3 * F;
  }
  // Column of the packed (c, 3HD) weight for feature n of head h's k|v block (n < 2D).
  __device__ int kv_col(int h, int n) const { return (1 + n / D) * HD + h * D + (n % D); }
};

// q_h = round((x W_q,h + b_q,h) * scale) for all f frames, into qs (F, QS).
template <typename T>
__device__ __forceinline__ void project_q(const Dims& s, const T* __restrict__ xt,
                                          const T* __restrict__ wqkv,
                                          const float* __restrict__ bqkv, float* qs, int h,
                                          float scale) {
  const int col0 = h * s.D;
  mm<4, 4>(
      threadIdx.x, blockDim.x, s.F, s.D, s.C,
      [&](int m, int k) { return to_f(xt[(size_t)m * s.C + k]); },
      [&](int k, int n) { return to_f(wqkv[(size_t)k * s.W3 + col0 + n]); },
      [&](int m, int n, float v) { qs[m * s.QS + n] = rnd<T>((v + bqkv[col0 + n]) * scale); });
  __syncthreads();
}

// k|v of head h for the `nb` frames from `xb`, rounded, into kvs (nb, KS): k in [0, D), v in [D, 2D).
template <typename T>
__device__ __forceinline__ void project_kv(const Dims& s, const T* __restrict__ xb,
                                           const T* __restrict__ wqkv,
                                           const float* __restrict__ bqkv, float* kvs, int h,
                                           int nb) {
  mm<2, 4>(
      threadIdx.x, blockDim.x, nb, 2 * s.D, s.C,
      [&](int m, int k) { return to_f(xb[(size_t)m * s.C + k]); },
      [&](int k, int n) { return to_f(wqkv[(size_t)k * s.W3 + s.kv_col(h, n)]); },
      [&](int m, int n, float v) { kvs[m * s.KS + n] = rnd<T>(v + bqkv[s.kv_col(h, n)]); });
  __syncthreads();
}

// The online-softmax sweep of head h over the KV blocks (forward, and sweep 1
// of the backward). On return, for every frame row: ms = running maximum,
// ls = sum of exp(s - m), acc (F, QS) = sum_j round(exp(s_j - m)) v_j.
// With BIAS, `bias_h` is head h's (F, F) bias panel.
template <typename T, bool BIAS>
__device__ void online_pass(const Dims& s, const T* __restrict__ xt, const T* __restrict__ wqkv,
                            const float* __restrict__ bqkv, const float* __restrict__ bias_h,
                            const float* qs, float* acc, float* kvs, float* ps, float* ms,
                            float* ls, int h) {
  const int tid = threadIdx.x, nth = blockDim.x;
  for (int i = tid; i < s.F * s.QS; i += nth) acc[i] = 0.f;
  for (int i = tid; i < s.F; i += nth) {
    ms[i] = -1e30f;
    ls[i] = 0.f;
  }
  __syncthreads();
  for (int j0 = 0; j0 < s.F; j0 += s.KB) {
    const int nb = min(s.KB, s.F - j0);
    project_kv<T>(s, xt + (size_t)j0 * s.C, wqkv, bqkv, kvs, h, nb);
    mm<4, 4>(
        tid, nth, s.F, nb, s.D, [&](int m, int k) { return qs[m * s.QS + k]; },
        [&](int k, int n) { return kvs[n * s.KS + k]; },
        [&](int m, int n, float v) {
          if (BIAS) v += bias_h[(size_t)m * s.F + j0 + n];
          ps[m * s.PS + n] = v;
        });
    __syncthreads();
    // Rescale: 8 lanes share a row; the loop bound is uniform so that every lane reaches the shuffles.
    const int lane = tid & 7;
    for (int r0 = 0; r0 < s.F; r0 += nth >> 3) {
      const int row = r0 + (tid >> 3);
      const bool live = row < s.F;
      float* p = ps + (size_t)(live ? row : 0) * s.PS;
      float mx = -1e30f;
      if (live)
        for (int j = lane; j < nb; j += 8) mx = fmaxf(mx, p[j]);
      mx = max8(mx);
      const float m_old = live ? ms[row] : 0.f, l_old = live ? ls[row] : 0.f;
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      if (live)
        for (int j = lane; j < nb; j += 8) {
          const float e = expf(p[j] - m_new);
          sum += e;
          p[j] = rnd<T>(e);
        }
      sum = sum8(sum);
      const float alpha = expf(m_old - m_new);
      if (live)
        for (int d = lane; d < s.D; d += 8) acc[row * s.QS + d] *= alpha;
      __syncwarp();  // every lane has read the row's old m and l
      if (live && lane == 0) {
        ms[row] = m_new;
        ls[row] = l_old * alpha + sum;
      }
    }
    __syncthreads();
    mm<4, 4>(
        tid, nth, s.F, s.D, nb, [&](int m, int k) { return ps[m * s.PS + k]; },
        [&](int k, int n) { return kvs[k * s.KS + s.D + n]; },
        [&](int m, int n, float v) { acc[m * s.QS + n] += v; });
    __syncthreads();
  }
}

// `ohs_all` is the CTAs' scratch, (grid, F, HD) of T: the rounded o_h of every head of the
// CTA's current token. It is written and read back by the same CTA, so it is not `const`.
template <typename T, bool BIAS>
__global__ void __launch_bounds__(kThreads) temporal_blockwise_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ wqkv, const float* __restrict__ bqkv,
    const T* __restrict__ wo, const float* __restrict__ bo, const float* __restrict__ bias,
    T* __restrict__ out, T* ohs_all, int tokens, int F, int C, int H, int D, int KB, float scale) {
  extern __shared__ float smem[];
  const Dims s(F, C, H, D, KB);
  float* qs = smem;                       // (F, QS)   q of the head
  float* acc = qs + (size_t)F * s.QS;     // (F, QS)   unnormalised output accumulator
  float* kvs = acc + (size_t)F * s.QS;    // (KB, KS)  one block's k|v
  float* ps = kvs + (size_t)KB * s.KS;    // (F, PS)   one block's logits, then probabilities
  float* ms = ps + (size_t)F * s.PS;      // (F)       running maximum
  float* ls = ms + F;                     // (F)       running sum
  const int tid = threadIdx.x, nth = blockDim.x;
  T* ohs = ohs_all + (size_t)blockIdx.x * F * s.HD;

  for (int tok = blockIdx.x; tok < tokens; tok += gridDim.x) {
    const T* xt = x + (size_t)tok * F * C;
    T* ot = out + (size_t)tok * F * C;
    for (int h = 0; h < H; ++h) {
      project_q<T>(s, xt, wqkv, bqkv, qs, h, scale);
      online_pass<T, BIAS>(s, xt, wqkv, bqkv, BIAS ? bias + (size_t)h * F * F : nullptr, qs, acc,
                           kvs, ps, ms, ls, h);
      for (int i = tid; i < F * D; i += nth) {
        const int r = i / D, d = i - r * D;
        ohs[(size_t)r * s.HD + h * D + d] = from_f<T>(acc[r * s.QS + d] / ls[r]);
      }
      __syncthreads();
    }
    // out = x + round(sum_h o_h W_o,h + b_o), one product over all heads.
    mm<4, 4>(
        tid, nth, F, C, s.HD, [&](int m, int k) { return to_f(ohs[(size_t)m * s.HD + k]); },
        [&](int k, int n) { return to_f(wo[(size_t)k * C + n]); },
        [&](int m, int n, float v) {
          const size_t i = (size_t)m * C + n;
          ot[i] = from_f<T>(to_f(xt[i]) + rnd<T>(v + bo[n]));
        });
    __syncthreads();  // the next token overwrites the scratch
  }
}

// Backward. Per token and head: sweep 1 (`online_pass`) rebuilds m, l and
// o_h; do = g W_o,h^T and di follow; sweep 2 walks the KV blocks again with
// lse = m + log l, emits dk|dv per block and accumulates dq. The rounded o_h
// and dq|dk|dv of all heads go to the CTA's scratch, `scr_all` (grid, F, 4HD)
// of T: o_h in [0, HD) of a row, dqkv in the packed layout behind it. After
// the heads: dW_o += o^T g, dW_qkv += x^T dqkv, db_o += sum g and
// dx = g + dqkv W_qkv^T. `wqkv_t` (3HD, c) and `wo_t` (c, HD) are the
// weights transposed by the caller, so that these two products read along
// rows too. With BIAS, `dbias_partial` is (grid, H, F, F) float32, one panel
// per CTA, which the CTA zeroes and then adds every token's ds into.
template <typename T, bool BIAS>
__global__ void __launch_bounds__(kThreads) temporal_blockwise_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ wqkv,
    const T* __restrict__ wqkv_t, const float* __restrict__ bqkv, const T* __restrict__ wo_t,
    const float* __restrict__ bias, float* dbias_partial, T* __restrict__ dx,
    float* __restrict__ partial, T* scr_all, int tokens, int F, int C, int H, int D, int KB,
    float scale) {
  extern __shared__ float smem[];
  const Dims s(F, C, H, D, KB);
  float* qs = smem;                        // (F, QS)   q of the head
  float* acc = qs + (size_t)F * s.QS;      // (F, QS)   sweep 1: accumulator, then o_h; sweep 2: dq
  float* dos = acc + (size_t)F * s.QS;     // (F, QS)   do, rounded once di is taken
  float* kvs = dos + (size_t)F * s.QS;     // (KB, KS)  one block's k|v
  float* dkv = kvs + (size_t)KB * s.KS;    // (KB, KS)  one block's dk|dv
  float* ps = dkv + (size_t)KB * s.KS;     // (F, PS)   logits, then probabilities
  float* dss = ps + (size_t)F * s.PS;      // (F, PS)   ds, rounded
  float* ms = dss + (size_t)F * s.PS;      // (F)       maximum, then lse
  float* ls = ms + F;                      // (F)       sum
  float* di = ls + F;                      // (F)       rowsum(do * o_h)
  const int tid = threadIdx.x, nth = blockDim.x, lane = tid & 7;
  const int HD = s.HD, W3 = s.W3, S4 = 4 * HD;
  T* scr = scr_all + (size_t)blockIdx.x * F * S4;

  const size_t total = (size_t)C * W3 + W3 + (size_t)HD * C + C;
  float* pw = partial + (size_t)blockIdx.x * total;  // dW_qkv (C, 3HD), packed layout
  float* pb = pw + (size_t)C * W3;                   // db_qkv (3HD)
  float* pwo = pb + W3;                              // dW_o (HD, C)
  float* pbo = pwo + (size_t)HD * C;                 // db_o (C)
  for (size_t i = tid; i < total; i += nth) pw[i] = 0.f;
  float* pdb = BIAS ? dbias_partial + (size_t)blockIdx.x * H * F * F : nullptr;  // dbias (H, F, F)
  if (BIAS)
    for (size_t i = tid; i < (size_t)H * F * F; i += nth) pdb[i] = 0.f;
  __syncthreads();

  for (int tok = blockIdx.x; tok < tokens; tok += gridDim.x) {
    const T* xt = x + (size_t)tok * F * C;
    const T* gt = g + (size_t)tok * F * C;
    T* dxt = dx + (size_t)tok * F * C;
    for (int h = 0; h < H; ++h) {
      const float* bias_h = BIAS ? bias + (size_t)h * F * F : nullptr;
      float* pdb_h = BIAS ? pdb + (size_t)h * F * F : nullptr;
      project_q<T>(s, xt, wqkv, bqkv, qs, h, scale);
      online_pass<T, BIAS>(s, xt, wqkv, bqkv, bias_h, qs, acc, kvs, ps, ms, ls, h);
      // o_h = acc / l: unrounded over acc, rounded to the scratch.
      for (int i = tid; i < F * D; i += nth) {
        const int r = i / D, d = i - r * D;
        const float o = acc[r * s.QS + d] / ls[r];
        acc[r * s.QS + d] = o;
        scr[(size_t)r * S4 + h * D + d] = from_f<T>(o);
      }
      // do = g W_o,h^T, unrounded.
      mm<4, 4>(
          tid, nth, F, D, C, [&](int m, int k) { return to_f(gt[(size_t)m * C + k]); },
          [&](int k, int n) { return to_f(wo_t[(size_t)k * HD + h * D + n]); },
          [&](int m, int n, float v) { dos[m * s.QS + n] = v; });
      __syncthreads();
      for (int r = tid; r < F; r += nth) ms[r] += logf(ls[r]);  // lse
      // di = rowsum(do * o_h) from the unrounded values; then do rounds in place and the
      // accumulator is cleared for dq. 8 lanes share a row.
      for (int r0 = 0; r0 < F; r0 += nth >> 3) {
        const int row = r0 + (tid >> 3);
        const bool live = row < F;
        float sum = 0.f;
        if (live)
          for (int d = lane; d < D; d += 8) {
            const int i = row * s.QS + d;
            sum += dos[i] * acc[i];
            dos[i] = rnd<T>(dos[i]);
            acc[i] = 0.f;
          }
        sum = sum8(sum);
        if (live && lane == 0) di[row] = sum;
      }
      __syncthreads();

      for (int j0 = 0; j0 < F; j0 += KB) {
        const int nb = min(KB, F - j0);
        project_kv<T>(s, xt + (size_t)j0 * C, wqkv, bqkv, kvs, h, nb);
        // p = exp(s - lse), unrounded.
        mm<4, 4>(
            tid, nth, F, nb, D, [&](int m, int k) { return qs[m * s.QS + k]; },
            [&](int k, int n) { return kvs[n * s.KS + k]; },
            [&](int m, int n, float v) {
              if (BIAS) v += bias_h[(size_t)m * F + j0 + n];
              ps[m * s.PS + n] = expf(v - ms[m]);
            });
        __syncthreads();
        // dp = do v^T; ds = p (dp - di), rounded; p rounds in place. With a bias the unrounded ds is
        // first added into this CTA's dbias panel: the same thread owns (m, n) of this block for
        // every token, and the tokens come in order.
        mm<4, 4>(
            tid, nth, F, nb, D, [&](int m, int k) { return dos[m * s.QS + k]; },
            [&](int k, int n) { return kvs[n * s.KS + D + k]; },
            [&](int m, int n, float v) {
              const float p = ps[m * s.PS + n];
              const float ds = p * (v - di[m]);
              if (BIAS) pdb_h[(size_t)m * F + j0 + n] += ds;
              dss[m * s.PS + n] = rnd<T>(ds);
              ps[m * s.PS + n] = rnd<T>(p);
            });
        __syncthreads();
        // dk = ds^T q and dv = p^T do, each by half of the threads; dq += ds k by all.
        const int half = nth >> 1;
        if (tid < half) {
          mm<2, 4>(
              tid, half, nb, D, F, [&](int m, int k) { return dss[k * s.PS + m]; },
              [&](int k, int n) { return qs[k * s.QS + n]; },
              [&](int m, int n, float v) { dkv[m * s.KS + n] = v; });
        } else {
          mm<2, 4>(
              tid - half, nth - half, nb, D, F, [&](int m, int k) { return ps[k * s.PS + m]; },
              [&](int k, int n) { return dos[k * s.QS + n]; },
              [&](int m, int n, float v) { dkv[m * s.KS + D + n] = v; });
        }
        mm<4, 4>(
            tid, nth, F, D, nb, [&](int m, int k) { return dss[m * s.PS + k]; },
            [&](int k, int n) { return kvs[k * s.KS + n]; },
            [&](int m, int n, float v) { acc[m * s.QS + n] += v; });
        __syncthreads();
        // db_k|v += column sums of the unrounded dk|dv; the rounded block goes to the scratch.
        for (int n = tid; n < 2 * D; n += nth) {
          float sum = 0.f;
          for (int r = 0; r < nb; ++r) sum += dkv[r * s.KS + n];
          pb[s.kv_col(h, n)] += sum;
        }
        for (int i = tid; i < nb * 2 * D; i += nth) {
          const int r = i / (2 * D), n = i - r * 2 * D;
          scr[(size_t)(j0 + r) * S4 + HD + s.kv_col(h, n)] = from_f<T>(dkv[r * s.KS + n]);
        }
        __syncthreads();
      }
      // dq = (sum over blocks) * scale: db_q from the unrounded values, rounded to the scratch.
      for (int d = tid; d < D; d += nth) {
        float sum = 0.f;
        for (int r = 0; r < F; ++r) sum += acc[r * s.QS + d] * scale;
        pb[h * D + d] += sum;
      }
      for (int i = tid; i < F * D; i += nth) {
        const int r = i / D, d = i - r * D;
        scr[(size_t)r * S4 + HD + h * D + d] = from_f<T>(acc[r * s.QS + d] * scale);
      }
      __syncthreads();
    }

    // After the heads, from the scratch: dW_o += o^T g.
    mm<4, 4>(
        tid, nth, HD, C, F, [&](int m, int k) { return to_f(scr[(size_t)k * S4 + m]); },
        [&](int k, int n) { return to_f(gt[(size_t)k * C + n]); },
        [&](int m, int n, float v) { pwo[(size_t)m * C + n] += v; });
    // dW_qkv += x^T dqkv.
    mm<4, 4>(
        tid, nth, C, W3, F, [&](int m, int k) { return to_f(xt[(size_t)k * C + m]); },
        [&](int k, int n) { return to_f(scr[(size_t)k * S4 + HD + n]); },
        [&](int m, int n, float v) { pw[(size_t)m * W3 + n] += v; });
    // db_o += sum of g over the frames.
    for (int n = tid; n < C; n += nth) {
      float sum = 0.f;
      for (int r = 0; r < F; ++r) sum += to_f(gt[(size_t)r * C + n]);
      pbo[n] += sum;
    }
    // dx = round(g + dqkv W_qkv^T).
    mm<4, 4>(
        tid, nth, F, C, W3, [&](int m, int k) { return to_f(scr[(size_t)m * S4 + HD + k]); },
        [&](int k, int n) { return to_f(wqkv_t[(size_t)k * C + n]); },
        [&](int m, int n, float v) {
          const size_t i = (size_t)m * C + n;
          dxt[i] = from_f<T>(to_f(gt[i]) + v);
        });
    __syncthreads();  // the next token overwrites the scratch
  }
}

// ---------------------------------------------------------------------------
// Streaming redesign: the kernels above, with staged panels and warp-owned
// query rows (tensor cores in bf16, and in float32 in 3xTF32).
//
// The same functions and rounding points as `temporal_blockwise_fwd_kernel`
// and `temporal_blockwise_bwd_kernel` (mode BLOCKWISE), and, in mode DENSE,
// those of the dense kernels of temporal_attention.cu for f <= 64 at widths
// whose one-token tile does not fit there: q = round(round(x W_q + b) *
// round(scale)), the softmax normalised before its probabilities round, and
// in the backward di = rowsum(dP * P) over the float32 probabilities. With
// one key block spanning all f <= 64 frames (KB = 64), the row maximum and
// sum are known before P V, so P can be normalised there.
//
// Design. One CTA owns one token column at a time (a persistent grid walks
// the tokens) and runs the heads in turn. Per head:
//   1. q|k|v = x W_qkv,h (+ b, rounded) and, in the backward, do = g W_o,h^T
//      (float32): on the tensor cores (`tensor_mma`, common.cuh), bf16 panels
//      through mma.sync m16n8k16, float32 ones in split-precision TF32
//      (3xTF32, three m16n8k8 TF32 products per float32 product, each 8-deep
//      step summed in a fresh accumulator and added on the CUDA cores, which
//      holds the float32 gates). x, g and the head's weights are staged in
//      shared memory in x's type, in c-chunks of CK columns, through a ring
//      of NS slots (`sw_plan`: the widest chunk that fits, then two slots),
//      so shared memory follows f and CK and never c.
//   2. Attention, warp by warp: each warp owns 16-row blocks of query rows
//      and keeps S, P and the output accumulator in mma.sync fragments in
//      registers (flash-attention style): S = q k^T over a KV block, the
//      online softmax of the block (bias added to the float32 logits before
//      the row maximum), P rounded to x's type and packed straight into the
//      A fragments of P V. The backward rebuilds m and l this way, then
//      (phase B, query rows) dq += round(dS) k with dS = P (dP - di),
//      dP = round(do) v^T, and dbias from the unrounded dS; then (phase A,
//      key rows, 16 at a time) dv += round(P)^T round(do) and
//      dk += round(dS)^T q over all query blocks. K|V of the head stay in
//      shared memory, so nothing is projected twice. In float32 both kernels
//      compute the same fragments on the tensor cores in 3xTF32 (`tensor_nt`,
//      `tensor_pv`: `nt3`, `pv3`), P and dS staying in registers as in bf16,
//      so no layout holds a scratch for them.
//   3. The width-scaling products after attention, per c-chunk: forward
//      y += round(o_h) W_o,h into a float32 accumulator; backward
//      dW_o,h += o^T g, dW_qkv,h += x^T dqkv and dx += dqkv W_qkv,h^T (one
//      product over the packed dq|dk|dv; `tensor_mma_red` into the weight
//      partials, in float32 dW_qkv,h as one product over the three parts'
//      columns; `tensor_mma_add` into dx, as in 1). The
//      accumulator (rows, c) lives in shared memory where it fits beside the
//      panels, else in a float32 scratch of the CTA's own in device memory,
//      read and written by the same thread.
// Weight gradients and dbias cross CTAs only through per-CTA float32
// partials reduced in a fixed order (`reduce_partials_kernel`), as above, so
// runs are bit-equal; db_qkv sums each warp's rows in registers and the
// warps in order. Rows pad to 16 and head dims to DP (32 or 64) with zeros;
// keys past f are masked to -inf, padded rows never reach an output.
//
// Where the plan does not fit 227 KB (see the head of this file) the first-design kernels above run.

// Shared-memory layout of the streaming kernels for one launch (host and device).
struct SwPlan {
  int Fp, Fk, Cp, Dp, KB, CK, nch, NS, acc_smem, LDQ, LDD, LDX, LDF, LDA, LDY;
  size_t sx, sg, swq, swo, slot;  // elements of T: x, g, W_qkv,h and W_o,h chunks within a ring slot
  size_t ring, qkv, o, dob, dof, st, cs, acc3, y, bytes;  // byte offsets
};

__host__ __device__ inline SwPlan sw_layout(int F, int C, int D, int elt, bool bwd, bool dense, int CK, int NS,
                                            int acc_smem) {
  SwPlan p;
  p.Fp = round16(F);
  p.Cp = round16(C);
  p.Dp = D <= 32 ? 32 : 64;
  p.KB = dense ? 64 : 32;
  p.Fk = (p.Fp + p.KB - 1) / p.KB * p.KB;  // k|v rows: whole KV blocks
  p.CK = CK;
  p.nch = (p.Cp + CK - 1) / CK;
  p.NS = NS;
  p.acc_smem = acc_smem;
  p.LDQ = pad_ld(3 * p.Dp);
  p.LDD = pad_ld(p.Dp);
  p.LDX = pad_ld(CK);
  p.LDF = p.Dp + 4;
  p.LDA = elt == 4 ? p.LDQ : 3 * p.Dp + 4;  // float32 panels sum in place: the q|k|v panel is the accumulator
  p.LDY = p.Cp + 4;
  p.sx = 0;
  p.sg = (size_t)p.Fp * p.LDX;
  p.swq = p.sg + (bwd ? (size_t)p.Fp * p.LDX : 0);
  p.swo = p.swq + (size_t)CK * p.LDQ;
  p.slot = p.swo + (size_t)p.Dp * p.LDX;
  size_t at = 0;
  p.ring = at; at = al16(at + (size_t)NS * p.slot * elt);
  p.qkv = at;  at = al16(at + (size_t)p.Fk * p.LDQ * elt);
  p.o = at;    at = al16(at + (size_t)p.Fp * p.LDD * elt);
  p.dob = at;  if (bwd) at = al16(at + (size_t)p.Fp * p.LDD * elt);
  p.dof = at;  if (bwd) at = al16(at + (size_t)p.Fp * p.LDF * 4);
  p.st = at;   if (bwd) at = al16(at + (size_t)3 * p.Fp * 4);
  p.cs = at;   if (bwd) at = al16(at + (size_t)(kThreads / 32) * 3 * p.Dp * 4);
  p.acc3 = at; if (p.nch > 1 && elt == 2) at = al16(at + (size_t)p.Fp * p.LDA * 4);
  p.y = at;    if (acc_smem) at = al16(at + (size_t)p.Fp * p.LDY * 4);
  p.bytes = at;
  return p;
}

// The plan a launch takes: the widest c-chunk first (c itself, then 256, 128, 64, 32), then the
// accumulator in shared memory before device memory, then two ring slots before one. False where
// nothing fits: head dims over 64 (over 32 in mode BLOCKWISE), or panels of too many frames.
__host__ __device__ inline bool sw_plan(int F, int C, int D, int elt, bool bwd, bool dense, SwPlan* out) {
  if (D > 64 || (!dense && D > 32) || (dense && F > 64)) return false;
  const int Cp = round16(C);
  const int cands[5] = {Cp, 256, 128, 64, 32};
  for (int i = 0; i < 5; ++i) {
    if (i > 0 && cands[i] >= Cp) continue;
    for (int acc = 1; acc >= 0; --acc)
      for (int ns = 2; ns >= 1; --ns) {
        const SwPlan p = sw_layout(F, C, D, elt, bwd, dense, cands[i], ns, acc);
        if (p.bytes <= kSmemMax) {
          *out = p;
          return true;
        }
      }
  }
  return false;
}

// The ring of staged chunks: stage gi (the CTA's gi-th chunk in order: token n = gi / per_token of the
// CTA, head, chunk) holds x[:, chunk], g[:, chunk] (backward), W_qkv,h[chunk, :] (q|k|v side by side at
// column offsets 0, Dp, 2Dp) and W_o,h[:, chunk], zero-padded to (Fp, CK), (CK, 3Dp), (Dp, CK). A head
// takes one stage where c is one chunk (its phases 1 and 3 share it), else 2 * nch: phase 1's chunks,
// then phase 3's.
template <typename T>
struct SwRing {
  const SwPlan& pl;
  T* ring;
  const T *x, *g, *wqkv, *wo;
  int tokens, F, C, H, D, spp;

  __device__ void issue(int gi) const {
    const int per_tok = H * spp, n = gi / per_tok, r = gi - n * per_tok;
    const int tok = blockIdx.x + n * gridDim.x;
    if (tok >= tokens) return;
    const int h = r / spp, c0 = ((r - h * spp) % pl.nch) * pl.CK, cw = min(pl.CK, C - c0);
    const int HD = H * D, W3 = 3 * HD;
    T* sl = ring + (size_t)(gi % pl.NS) * pl.slot;
    stage(sl + pl.sx, pl.LDX, x + (size_t)tok * F * C + c0, C, F, cw, pl.Fp, pl.CK);
    if (g) stage(sl + pl.sg, pl.LDX, g + (size_t)tok * F * C + c0, C, F, cw, pl.Fp, pl.CK);
    for (int part = 0; part < 3; ++part)
      stage(sl + pl.swq + part * pl.Dp, pl.LDQ, wqkv + (size_t)c0 * W3 + part * HD + h * D, W3, cw, D, pl.CK,
            pl.Dp);
    stage(sl + pl.swo, pl.LDX, wo + (size_t)h * D * C + c0, C, D, cw, pl.Dp, pl.CK);
    cp_async_commit();
  }

  // Wait for stage gi (with one slot, first load it); with two, then start loading stage gi + 1.
  __device__ const T* ready(int gi) const {
    if (pl.NS == 1) {
      __syncthreads();  // everyone is done with the slot
      issue(gi);
    }
    cp_async_wait_all();
    __syncthreads();
    if (pl.NS == 2) issue(gi + 1);
    return slot(gi);
  }

  __device__ const T* slot(int gi) const { return ring + (size_t)(gi % pl.NS) * pl.slot; }
};

// The q|k|v epilogue of head h for columns c, c + 1 of the (Fp, 3Dp) panel: bias, rounding (DENSE: q
// rounded, then scaled by the rounded scale and rounded again; BLOCKWISE: q scaled, then rounded once),
// zeros past f and past D.
template <typename T, bool DENSE>
__device__ __forceinline__ void qkv_store(T* qkv, int LDQ, int Dp, int F, int D, int HD, int h,
                                          const float* bqkv, float scale, float scale_q, int r, int c, float v0,
                                          float v1) {
  const int part = c / Dp, d = c - part * Dp;
  float v[2] = {v0, v1};
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (r >= F || d + u >= D) {
      v[u] = 0.f;
      continue;
    }
    const float t = v[u] + bqkv[part * HD + h * D + d + u];
    if (part == 0) v[u] = DENSE ? rnd<T>(rnd<T>(t) * scale_q) : rnd<T>(t * scale);
    else v[u] = rnd<T>(t);
  }
  st2(qkv + (size_t)r * LDQ + c, v[0], v[1]);
}

// Phase 1 of a head: q|k|v into the panel (one product with its epilogue where c is one chunk, else summed
// over the chunks in float32, then stored), and with `dof` (backward) do = g W_o,h^T added into it; on the
// tensor cores (`tensor_mma`: float32 in 3xTF32).
template <typename T, bool DENSE>
__device__ void project_head(const SwRing<T>& rg, int& gi, T* qkv, float* acc3, float* dof, int F, int D,
                             int HD, int h, const float* bqkv, float scale, float scale_q) {
  const SwPlan& pl = rg.pl;
  const int Fp = pl.Fp, Dp = pl.Dp, LDQ = pl.LDQ;
  auto epi = [=](int r, int c, float v0, float v1) {
    qkv_store<T, DENSE>(qkv, LDQ, Dp, F, D, HD, h, bqkv, scale, scale_q, r, c, v0, v1);
  };
  if (pl.nch > 1) {
    __syncthreads();  // in float32 the accumulator is the q|k|v panel, which the previous head's last products read
    for (int i = threadIdx.x; i < Fp * 3 * Dp; i += blockDim.x) acc3[(i / (3 * Dp)) * pl.LDA + i % (3 * Dp)] = 0.f;
  }
  if (dof)
    for (int i = threadIdx.x; i < Fp * Dp; i += blockDim.x) dof[(i / Dp) * pl.LDF + i % Dp] = 0.f;
  for (int ch = 0; ch < pl.nch; ++ch) {
    const T* sl = rg.ready(gi++);
    const T *xs = sl + pl.sx, *ws = sl + pl.swq;
    if (pl.nch == 1) tensor_mma<false, true>(xs, pl.LDX, ws, LDQ, Fp, 3 * Dp, pl.CK, epi);
    else tensor_mma_add<false, true>(xs, pl.LDX, ws, LDQ, Fp, 3 * Dp, pl.CK, acc3, pl.LDA, Fp, 3 * Dp);
    if (dof) tensor_mma_add<false, false>(sl + pl.sg, pl.LDX, sl + pl.swo, pl.LDX, Fp, Dp, pl.CK, dof, pl.LDF, Fp, Dp);
  }
  if (pl.nch > 1) {
    __syncthreads();
    const int half = 3 * Dp / 2;
    for (int i = threadIdx.x; i < Fp * half; i += blockDim.x) {
      const int r = i / half, c = (i - r * half) * 2;
      epi(r, c, acc3[(size_t)r * pl.LDA + c], acc3[(size_t)r * pl.LDA + c + 1]);
    }
  }
  __syncthreads();
}

// Two CTAs per SM in bf16 mode BLOCKWISE (128 registers a thread); a float32 CTA holds an SM.
template <typename T, bool DENSE, int DP>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 && !DENSE ? 2 : 1) temporal_stream_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ wqkv, const float* __restrict__ bqkv,
    const T* __restrict__ wo, const float* __restrict__ bo, const float* __restrict__ bias,
    T* __restrict__ out, float* yscr, int tokens, int F, int C, int H, int D, float scale, int CK, int NS,
    int acc_smem) {
  constexpr int NB = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SwPlan pl = sw_layout(F, C, D, sizeof(T), false, DENSE, CK, NS, acc_smem);
  T* qkv = reinterpret_cast<T*>(smem_raw + pl.qkv);   // (Fk, 3Dp) q|k|v of head h
  T* os = reinterpret_cast<T*>(smem_raw + pl.o);      // (Fp, Dp) o_h, rounded
  float* acc3 = reinterpret_cast<float*>(smem_raw + (sizeof(T) == 4 ? pl.qkv : pl.acc3));
  float* y = acc_smem ? reinterpret_cast<float*>(smem_raw + pl.y) : yscr + (size_t)blockIdx.x * pl.Fp * pl.LDY;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5, g = lane >> 2, q = lane & 3;
  const int HD = H * D, Fp = pl.Fp, LDQ = pl.LDQ, LDD = pl.LDD, LDY = pl.LDY;
  const float scale_q = rnd<T>(scale);
  const SwRing<T> rg{pl, reinterpret_cast<T*>(smem_raw + pl.ring), x, nullptr, wqkv, wo, tokens, F, C, H, D,
                     pl.nch == 1 ? 1 : 2 * pl.nch};

  for (int i = tid; i < pl.Fk * LDQ; i += blockDim.x) qkv[i] = from_f<T>(0.f);  // k|v rows past Fp stay zero
  if (pl.NS == 2) rg.issue(0);
  int gi = 0;
  for (int tok = blockIdx.x; tok < tokens; tok += gridDim.x) {
    for (int i = tid; i < Fp * pl.Cp; i += blockDim.x) y[(size_t)(i / pl.Cp) * LDY + i % pl.Cp] = 0.f;
    for (int h = 0; h < H; ++h) {
      project_head<T, DENSE>(rg, gi, qkv, acc3, nullptr, F, D, HD, h, bqkv, scale, scale_q);
      // o_h = round(acc / l) (BLOCKWISE) or round(round(P) V) (DENSE), warp by warp.
      const float* bias_h = bias ? bias + (size_t)h * F * F : nullptr;
      for (int rb = warp; rb < Fp / 16; rb += nw) {
        float o[NB][4], m[2], l[2];
        sweep_rows<T, DENSE, DP, true>(qkv + (size_t)rb * 16 * LDQ, LDQ, qkv + DP, qkv + 2 * DP, LDQ, F, rb * 16,
                                       bias_h, o, m, l, nullptr);
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float inv = DENSE ? 1.f : l[i];
            st2(os + (size_t)(rb * 16 + g + 8 * i) * LDD + 8 * j + 2 * q, o[j][2 * i] / inv, o[j][2 * i + 1] / inv);
          }
      }
      __syncthreads();
      // y += o_h W_o,h, chunk by chunk.
      for (int ch = 0; ch < pl.nch; ++ch) {
        const T* sl = pl.nch == 1 ? rg.slot(gi - 1) : rg.ready(gi++);
        const int c0 = ch * pl.CK;
        tensor_mma_add<false, true>(os, LDD, sl + pl.swo, pl.LDX, Fp, pl.CK, DP, y + c0, LDY, Fp, min(pl.CK, C - c0));
      }
    }
    __syncthreads();
    // out = x + round(y + b_o).
    const T* xt = x + (size_t)tok * F * C;
    T* ot = out + (size_t)tok * F * C;
    for (int i = tid; i < F * C; i += blockDim.x) {
      const int r = i / C, c = i - r * C;
      ot[i] = from_f<T>(to_f(xt[i]) + rnd<T>(y[(size_t)r * LDY + c] + bo[c]));
    }
    __syncthreads();  // y is cleared for the next token
  }
}

// Backward. `partial` and `dbias_partial` are the CTA's float32 partials as for the first design; `dxscr`
// the CTA's (Fp, Cp + 4) float32 dx accumulator where it does not fit shared memory.
template <typename T, bool DENSE, int DP>
__global__ void __launch_bounds__(kThreads, 1) temporal_stream_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ wqkv,
    const float* __restrict__ bqkv, const T* __restrict__ wo, const float* __restrict__ bias,
    float* dbias_partial, T* __restrict__ dx, float* __restrict__ partial, float* dxscr, int tokens, int F,
    int C, int H, int D, float scale, int CK, int NS, int acc_smem) {
  constexpr int NB = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SwPlan pl = sw_layout(F, C, D, sizeof(T), true, DENSE, CK, NS, acc_smem);
  T* qkv = reinterpret_cast<T*>(smem_raw + pl.qkv);    // (Fk, 3Dp) q|k|v of head h; then dq|dk|dv, rounded
  T* os = reinterpret_cast<T*>(smem_raw + pl.o);       // (Fp, Dp) o_h, rounded
  T* dob = reinterpret_cast<T*>(smem_raw + pl.dob);    // (Fp, Dp) do, rounded
  float* dof = reinterpret_cast<float*>(smem_raw + pl.dof);  // (Fp, Dp) do in float32; then dq in float32
  float* st0 = reinterpret_cast<float*>(smem_raw + pl.st);   // (Fp) lse (BLOCKWISE) or the row max (DENSE)
  float* st1 = st0 + pl.Fp;                                  // (Fp) the row sum (DENSE)
  float* dis = st1 + pl.Fp;                                  // (Fp) di
  float* csum = reinterpret_cast<float*>(smem_raw + pl.cs);  // (warps, 3Dp) column sums of dq|dk|dv
  float* acc3 = reinterpret_cast<float*>(smem_raw + (sizeof(T) == 4 ? pl.qkv : pl.acc3));
  float* dxa = acc_smem ? reinterpret_cast<float*>(smem_raw + pl.y) : dxscr + (size_t)blockIdx.x * pl.Fp * pl.LDY;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5, gq = lane >> 2, q = lane & 3;
  const int HD = H * D, W3 = 3 * HD, Fp = pl.Fp, LDQ = pl.LDQ, LDD = pl.LDD, LDF = pl.LDF, LDY = pl.LDY;
  const float scale_q = rnd<T>(scale);
  const SwRing<T> rg{pl, reinterpret_cast<T*>(smem_raw + pl.ring), x, g, wqkv, wo, tokens, F, C, H, D,
                     pl.nch == 1 ? 1 : 2 * pl.nch};

  const size_t total = (size_t)C * W3 + W3 + (size_t)HD * C + C;
  float* pw = partial + (size_t)blockIdx.x * total;  // dW_qkv (C, 3HD) | db_qkv (3HD) | dW_o (HD, C) | db_o (C)
  for (size_t i = tid; i < total; i += blockDim.x) pw[i] = 0.f;
  float* pdb = bias ? dbias_partial + (size_t)blockIdx.x * H * F * F : nullptr;  // dbias (H, F, F)
  if (bias)
    for (size_t i = tid; i < (size_t)H * F * F; i += blockDim.x) pdb[i] = 0.f;
  for (int i = tid; i < pl.Fk * LDQ; i += blockDim.x) qkv[i] = from_f<T>(0.f);  // k|v rows past Fp stay zero
  if (pl.NS == 2) rg.issue(0);
  int gi = 0;

  for (int tok = blockIdx.x; tok < tokens; tok += gridDim.x) {
    for (int i = tid; i < Fp * pl.Cp; i += blockDim.x) dxa[(size_t)(i / pl.Cp) * LDY + i % pl.Cp] = 0.f;
    for (int h = 0; h < H; ++h) {
      const float* bias_h = bias ? bias + (size_t)h * F * F : nullptr;
      float* pdb_h = bias ? pdb + (size_t)h * F * F : nullptr;
      project_head<T, DENSE>(rg, gi, qkv, acc3, dof, F, D, HD, h, bqkv, scale, scale_q);

      // Sweep 1 (query rows): o_h, the row statistics, di (BLOCKWISE: rowsum(do * o) from the unrounded
      // values) and do rounded.
      for (int rb = warp; rb < Fp / 16; rb += nw) {
        float o[NB][4], m[2], l[2], dsum[2] = {0.f, 0.f};
        sweep_rows<T, DENSE, DP, true>(qkv + (size_t)rb * 16 * LDQ, LDQ, qkv + DP, qkv + 2 * DP, LDQ, F, rb * 16,
                                       bias_h, o, m, l, nullptr);
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = rb * 16 + gq + 8 * i, c = 8 * j + 2 * q;
            const float inv = DENSE ? 1.f : l[i];
            const float o0 = o[j][2 * i] / inv, o1 = o[j][2 * i + 1] / inv;
            dsum[i] += dof[(size_t)r * LDF + c] * o0 + dof[(size_t)r * LDF + c + 1] * o1;
            st2(os + (size_t)r * LDD + c, o0, o1);
          }
        for (int i = 0; i < 2; ++i) {
          const float di = quad_sum(dsum[i]);
          const int r = rb * 16 + gq + 8 * i;
          if (q == 0) {
            st0[r] = DENSE ? m[i] : m[i] + logf(l[i]);
            st1[r] = l[i];
            if (!DENSE) dis[r] = di;
          }
        }
        for (int i = lane; i < 16 * DP; i += 32) {
          const int r = rb * 16 + i / DP, c = i % DP;
          dob[(size_t)r * LDD + c] = from_f<T>(dof[(size_t)r * LDF + c]);
        }
      }
      __syncthreads();

      // Phase B (query rows), over KV blocks of 32: P, dP = round(do) v^T, dS = P (dP - di), dbias += dS,
      // dq = (sum round(dS) k) * scale into dof in float32; column sums of dq. In mode DENSE di = rowsum(dP * P)
      // over all keys, from a first sweep.
      for (int i = lane; i < 3 * DP; i += 32) csum[warp * 3 * DP + i] = 0.f;
      __syncwarp();
      for (int rb = warp; rb < Fp / 16; rb += nw) {
        const int q0 = rb * 16;
        float dq[NB][4];
#pragma unroll
        for (int j = 0; j < NB; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
        // P and dP of one KV block (keys from kb0), P in s.
        auto block = [&](int kb0, float (&s)[4][4], float (&dp)[4][4]) {
          tensor_nt<4, DP>(s, qkv + (size_t)q0 * LDQ, LDQ, qkv + (size_t)kb0 * LDQ + DP, LDQ);
          tensor_nt<4, DP>(dp, dob + (size_t)q0 * LDD, LDD, qkv + (size_t)kb0 * LDQ + 2 * DP, LDQ);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = q0 + gq + 8 * (e >> 1), key = kb0 + 8 * j + 2 * q + (e & 1);
              float p = 0.f;
              if (key < F && row < F) {
                const float v = s[j][e] + (bias_h ? bias_h[(size_t)row * F + key] : 0.f);
                p = DENSE ? expf(v - st0[row]) / st1[row] : expf(v - st0[row]);
              }
              s[j][e] = p;
            }
        };
        if (DENSE) {
          float dsum[2] = {0.f, 0.f};
          for (int kb0 = 0; kb0 < F; kb0 += 32) {
            float s[4][4], dp[4][4];
            block(kb0, s, dp);
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) dsum[e >> 1] += dp[j][e] * s[j][e];
          }
          for (int i = 0; i < 2; ++i) {
            const float di = quad_sum(dsum[i]);
            if (q == 0) dis[q0 + gq + 8 * i] = di;
          }
          __syncwarp();
        }
        const float di[2] = {dis[q0 + gq], dis[q0 + gq + 8]};
        for (int kb0 = 0; kb0 < F; kb0 += 32) {
          float s[4][4], dp[4][4];
          block(kb0, s, dp);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = q0 + gq + 8 * (e >> 1), key = kb0 + 8 * j + 2 * q + (e & 1);
              const float ds = s[j][e] * (dp[j][e] - di[e >> 1]);
              if (pdb_h && key < F && row < F) {  // float32: one thread per element, in its program order
                if (sizeof(T) == 4) red_add(pdb_h + (size_t)row * F + key, ds);
                else pdb_h[(size_t)row * F + key] += ds;
              }
              dp[j][e] = rnd<T>(ds);
            }
          tensor_pv<NB, 4>(dq, dp, qkv + (size_t)kb0 * LDQ + DP, LDQ);
        }
        float cs[NB][2];
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dq[j][e] *= scale;
        column_sums<NB>(dq, cs);
        if (lane < 4)
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            csum[warp * 3 * DP + 8 * j + 2 * lane] += cs[j][0];
            csum[warp * 3 * DP + 8 * j + 2 * lane + 1] += cs[j][1];
          }
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = q0 + gq + 8 * i, c = 8 * j + 2 * q;
            dof[(size_t)r * LDF + c] = dq[j][2 * i];
            dof[(size_t)r * LDF + c + 1] = dq[j][2 * i + 1];
          }
      }
      __syncthreads();

      // Phase A (key rows, 16 at a time): dv = sum round(P)^T round(do), dk = sum round(dS)^T q over the
      // query blocks; their column sums, then round(dk) | round(dv) over the warp's own k|v rows.
      for (int kb = warp; kb < Fp / 16; kb += nw) {
        const int k0 = kb * 16;
        float dk[NB][4], dv[NB][4];
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
        for (int q0 = 0; q0 < Fp; q0 += 16) {
          float s[2][4], dp[2][4];
          tensor_nt<2, DP>(s, qkv + (size_t)k0 * LDQ + DP, LDQ, qkv + (size_t)q0 * LDQ, LDQ);
          tensor_nt<2, DP>(dp, qkv + (size_t)k0 * LDQ + 2 * DP, LDQ, dob + (size_t)q0 * LDD, LDD);
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = k0 + gq + 8 * (e >> 1), qr = q0 + 8 * j + 2 * q + (e & 1);
              float p = 0.f, ds = 0.f;
              if (key < F && qr < F) {
                const float v = s[j][e] + (bias_h ? bias_h[(size_t)qr * F + key] : 0.f);
                p = DENSE ? expf(v - st0[qr]) / st1[qr] : expf(v - st0[qr]);
                ds = p * (dp[j][e] - dis[qr]);
              }
              s[j][e] = rnd<T>(p);
              dp[j][e] = rnd<T>(ds);
            }
          tensor_pv<NB, 2>(dv, s, dob + (size_t)q0 * LDD, LDD);
          tensor_pv<NB, 2>(dk, dp, qkv + (size_t)q0 * LDQ, LDQ);
        }
        float cs[NB][2];
        column_sums<NB>(dk, cs);
        if (lane < 4)
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            csum[warp * 3 * DP + DP + 8 * j + 2 * lane] += cs[j][0];
            csum[warp * 3 * DP + DP + 8 * j + 2 * lane + 1] += cs[j][1];
          }
        column_sums<NB>(dv, cs);
        if (lane < 4)
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            csum[warp * 3 * DP + 2 * DP + 8 * j + 2 * lane] += cs[j][0];
            csum[warp * 3 * DP + 2 * DP + 8 * j + 2 * lane + 1] += cs[j][1];
          }
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = k0 + gq + 8 * i, c = 8 * j + 2 * q;
            st2(qkv + (size_t)r * LDQ + DP + c, dk[j][2 * i], dk[j][2 * i + 1]);
            st2(qkv + (size_t)r * LDQ + 2 * DP + c, dv[j][2 * i], dv[j][2 * i + 1]);
          }
      }
      __syncthreads();
      // dq rounded over q; db_qkv += the warps' column sums in warp order.
      for (int i = tid; i < Fp * DP; i += blockDim.x) {
        const int r = i / DP, c = i - r * DP;
        qkv[(size_t)r * LDQ + c] = from_f<T>(dof[(size_t)r * LDF + c]);
      }
      for (int col = tid; col < 3 * DP; col += blockDim.x) {
        const int part = col / DP, d = col - part * DP;
        if (d >= D) continue;
        float sum = 0.f;
        for (int w = 0; w < nw; ++w) sum += csum[w * 3 * DP + col];
        pw[(size_t)C * W3 + part * HD + h * D + d] += sum;
      }
      __syncthreads();

      // Phase 3, chunk by chunk: dW_o,h += o^T g, dW_part,h += x^T dpart, dx += dqkv W_qkv,h^T.
      for (int ch = 0; ch < pl.nch; ++ch) {
        const T* sl = pl.nch == 1 ? rg.slot(gi - 1) : rg.ready(gi++);
        const int c0 = ch * pl.CK, cw = min(pl.CK, C - c0);
        tensor_mma_red<true, true>(os, LDD, sl + pl.sg, pl.LDX, DP, pl.CK, Fp,
                                pw + (size_t)C * W3 + W3 + (size_t)h * D * C + c0, C, D, cw);
        if constexpr (sizeof(T) == 4) {  // float32: the three parts as one product over dq|dk|dv's 3DP columns
          float* dst = pw + (size_t)c0 * W3 + h * D;
          tf3_mma<true, true>(sl + pl.sx, pl.LDX, qkv, LDQ, pl.CK, 3 * DP, Fp, [=](int r, int c, float v0, float v1) {
            const int part = c / DP, d = c - part * DP;  // c even, DP a multiple of 8: c + 1 in the same part
            float* at = dst + (size_t)r * W3 + part * HD + d;
            if (r < cw && d < D) red_add(at, v0);
            if (r < cw && d + 1 < D) red_add(at + 1, v1);
          });
        } else {
          for (int part = 0; part < 3; ++part)
            tensor_mma_red<true, true>(sl + pl.sx, pl.LDX, qkv + part * DP, LDQ, pl.CK, DP, Fp,
                                    pw + (size_t)c0 * W3 + part * HD + h * D, W3, cw, D);
        }
        tensor_mma_add<false, false>(qkv, LDQ, sl + pl.swq, LDQ, Fp, pl.CK, 3 * DP, dxa + c0, LDY, Fp, cw);
      }
    }
    __syncthreads();
    // db_o += the token's sum of g; dx = round(g + dx_attention).
    const T* gt = g + (size_t)tok * F * C;
    T* dxt = dx + (size_t)tok * F * C;
    float* pbo = pw + (size_t)C * W3 + W3 + (size_t)HD * C;
    for (int c = tid; c < C; c += blockDim.x) {
      float sum = 0.f;
      for (int r = 0; r < F; ++r) sum += to_f(gt[(size_t)r * C + c]);
      pbo[c] += sum;
    }
    for (int i = tid; i < F * C; i += blockDim.x) {
      const int r = i / C, c = i - r * C;
      dxt[i] = from_f<T>(to_f(gt[i]) + dxa[(size_t)r * LDY + c]);
    }
    __syncthreads();  // dxa is cleared for the next token
  }
}

template <typename T, bool BIAS>
static int launch_fwd(const void* x, const void* wqkv, const void* bqkv, const void* wo,
                      const void* bo, const void* bias, void* out, void* scratch, int tokens, int f,
                      int c, int heads, int dim, int kb, int grid, float scale,
                      cudaStream_t stream) {
  const size_t smem = sizeof(float) * Dims(f, c, heads, dim, kb).fwd_floats();
  cudaError_t err = cudaFuncSetAttribute(temporal_blockwise_fwd_kernel<T, BIAS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  temporal_blockwise_fwd_kernel<T, BIAS><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv), static_cast<const float*>(bqkv),
      static_cast<const T*>(wo), static_cast<const float*>(bo), static_cast<const float*>(bias),
      static_cast<T*>(out), static_cast<T*>(scratch), tokens, f, c, heads, dim, kb, scale);
  return (int)cudaGetLastError();
}

template <typename T, bool BIAS>
static int launch_bwd(const void* x, const void* g, const void* wqkv, const void* wqkv_t,
                      const void* bqkv, const void* wo_t, const void* bias, void* dbias_partial,
                      void* dx, void* partial, void* scratch, int tokens, int f, int c, int heads,
                      int dim, int kb, int grid, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * Dims(f, c, heads, dim, kb).bwd_floats();
  cudaError_t err = cudaFuncSetAttribute(temporal_blockwise_bwd_kernel<T, BIAS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  temporal_blockwise_bwd_kernel<T, BIAS><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(wqkv),
      static_cast<const T*>(wqkv_t), static_cast<const float*>(bqkv),
      static_cast<const T*>(wo_t), static_cast<const float*>(bias),
      static_cast<float*>(dbias_partial), static_cast<T*>(dx), static_cast<float*>(partial),
      static_cast<T*>(scratch), tokens, f, c, heads, dim, kb, scale);
  return (int)cudaGetLastError();
}

template <typename T, bool DENSE, int DP>
static int launch_stream_fwd(const SwPlan& p, const void* x, const void* wqkv, const void* bqkv,
                             const void* wo, const void* bo, const void* bias, void* out, void* scratch,
                             int tokens, int f, int c, int heads, int dim, int grid, float scale,
                             cudaStream_t stream) {
  auto kernel = temporal_stream_fwd_kernel<T, DENSE, DP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, p.bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv), static_cast<const float*>(bqkv),
      static_cast<const T*>(wo), static_cast<const float*>(bo), static_cast<const float*>(bias),
      static_cast<T*>(out), static_cast<float*>(scratch), tokens, f, c, heads, dim, scale, p.CK, p.NS,
      p.acc_smem);
  return (int)cudaGetLastError();
}

template <typename T, bool DENSE, int DP>
static int launch_stream_bwd(const SwPlan& p, const void* x, const void* g, const void* wqkv,
                             const void* bqkv, const void* wo, const void* bias, void* dbias_partial,
                             void* dx, void* partial, void* scratch, int tokens, int f, int c, int heads,
                             int dim, int grid, float scale, cudaStream_t stream) {
  auto kernel = temporal_stream_bwd_kernel<T, DENSE, DP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, p.bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const T*>(wo), static_cast<const float*>(bias),
      static_cast<float*>(dbias_partial), static_cast<T*>(dx), static_cast<float*>(partial),
      static_cast<float*>(scratch), tokens, f, c, heads, dim, scale, p.CK, p.NS, p.acc_smem);
  return (int)cudaGetLastError();
}

// Bytes of device scratch a launch needs: the streaming kernels' float32 (Fp, Cp + 4) accumulator per CTA
// where it does not fit shared memory (else none), the first design's column of x's type per CTA.
static size_t scratch_bytes(bool staged, const SwPlan& p, int grid, int f, int heads, int dim, int elt,
                            bool bwd) {
  if (staged) return p.acc_smem ? 0 : (size_t)grid * p.Fp * p.LDY * 4;
  return (size_t)grid * f * (bwd ? 4 : 1) * heads * dim * elt;
}

// The route of a launch: 1 = the streaming kernel (mode DENSE where `dense`), 0 = the first design
// (mode BLOCKWISE only, where the streaming plan does not fit), -1 = none (DENSE that does not fit). The C
// entries report the streaming kernel in float32 as 3 (its products in 3xTF32).
static int choose(int f, int c, int dim, int elt, bool bwd, bool dense, SwPlan* p) {
  if (sw_plan(f, c, dim, elt, bwd, dense, p)) return 1;
  return dense ? -1 : 0;
}

}  // namespace vdt

// dtype: 0 = float32, 1 = bfloat16. `dense` 1 selects mode DENSE (f <= 64: the dense kernels'
// rounding points, for widths the dense kernels cannot hold), 0 the blockwise kernels. `grid` CTAs walk
// the tokens; `scratch` (scratch_size bytes) is the launch's device scratch (`scratch_bytes`). `bias` is
// (heads, f, f) float32 or null. Returns the cudaError_t of the launch; `*staged` is set to 1 where the
// streaming kernel ran in bf16, 3 where it ran in float32 (its products in 3xTF32), 0 where the first design did.
extern "C" int temporal_blockwise_fwd(int dtype, int dense, const void* x, const void* wqkv,
                                      const void* bqkv, const void* wo, const void* bo,
                                      const void* bias, void* out, void* scratch, size_t scratch_size,
                                      int tokens, int f, int c, int heads, int dim, int kb, int grid,
                                      float scale, void* stream, int* staged) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int elt = dtype == 0 ? 4 : 2;
  vdt::SwPlan p;
  const int route = vdt::choose(f, c, dim, elt, false, dense != 0, &p);
  if (route < 0 || vdt::scratch_bytes(route == 1, p, grid, f, heads, dim, elt, false) > scratch_size)
    return (int)cudaErrorInvalidValue;
  *staged = route == 1 && dtype == 0 ? 3 : route;
  if (route == 1) {
#define VDT_SFWD(T, DN, DP)                                                                            \
  vdt::launch_stream_fwd<T, DN, DP>(p, x, wqkv, bqkv, wo, bo, bias, out, scratch, tokens, f, c, heads, \
                                    dim, grid, scale, s)
    if (dtype == 0) return !dense ? VDT_SFWD(float, false, 32) : p.Dp == 32 ? VDT_SFWD(float, true, 32)
                                                                             : VDT_SFWD(float, true, 64);
    return !dense ? VDT_SFWD(__nv_bfloat16, false, 32) : p.Dp == 32 ? VDT_SFWD(__nv_bfloat16, true, 32)
                                                                     : VDT_SFWD(__nv_bfloat16, true, 64);
#undef VDT_SFWD
  }
#define VDT_FWD(T, B)                                                                          \
  vdt::launch_fwd<T, B>(x, wqkv, bqkv, wo, bo, bias, out, scratch, tokens, f, c, heads, dim, \
                        kb, grid, scale, s)
  if (dtype == 0) return bias ? VDT_FWD(float, true) : VDT_FWD(float, false);
  return bias ? VDT_FWD(__nv_bfloat16, true) : VDT_FWD(__nv_bfloat16, false);
#undef VDT_FWD
}

// Backward: dx in x's type; `grads` (float32) receives dW_qkv (c, 3HD) | db_qkv (3HD) |
// dW_o (HD, c) | db_o (c), summed over the `grid` CTAs' partials in `partial` (grid x that size,
// float32). `wqkv_t` (3HD, c) and `wo_t` (c, HD), the weights transposed, are read by the first design
// alone (null otherwise); the streaming kernel reads `wo` (HD, c). With `bias`, `dbias` (heads, f, f)
// float32 receives the sum of the CTAs' `dbias_partial` (grid x heads*f*f, float32); all three are null
// for the unbiased instantiation. `dense`, `scratch` and `scratch_size` as in the forward; `*staged` as
// there, but 3 where the streaming kernel ran in float32 (its products in 3xTF32). A float32 shape for the
// streaming kernel that `f32_takes_tf32x3` gives to temporal_tf32x3.cu is refused (see kF32RuleChecked).
extern "C" int temporal_blockwise_bwd(int dtype, int dense, const void* x, const void* g, const void* wqkv,
                                      const void* wqkv_t, const void* bqkv, const void* wo,
                                      const void* wo_t, const void* bias, void* dbias_partial, void* dbias,
                                      void* dx, void* partial, void* grads, void* scratch,
                                      size_t scratch_size, int tokens, int f, int c, int heads, int dim,
                                      int kb, int grid, float scale, void* stream, int* staged) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bias && !(dbias_partial && dbias)) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int elt = dtype == 0 ? 4 : 2;
  vdt::SwPlan p;
  const int route = vdt::choose(f, c, dim, elt, true, dense != 0, &p);
  if (route < 0 || vdt::scratch_bytes(route == 1, p, grid, f, heads, dim, elt, true) > scratch_size)
    return (int)cudaErrorInvalidValue;
  if (route == 0 && !(wqkv_t && wo_t)) return (int)cudaErrorInvalidValue;
  if (route == 1 && dtype == 0 && vdt::kF32RuleChecked && vdt::f32_takes_tf32x3(f, c, dim))
    return (int)cudaErrorInvalidValue;
  *staged = route == 1 && dtype == 0 ? 3 : route;
  int rc;
  if (route == 1) {
#define VDT_SBWD(T, DN, DP)                                                                               \
  vdt::launch_stream_bwd<T, DN, DP>(p, x, g, wqkv, bqkv, wo, bias, dbias_partial, dx, partial, scratch, \
                                    tokens, f, c, heads, dim, grid, scale, s)
    if (dtype == 0) rc = !dense ? VDT_SBWD(float, false, 32) : p.Dp == 32 ? VDT_SBWD(float, true, 32)
                                                                           : VDT_SBWD(float, true, 64);
    else rc = !dense ? VDT_SBWD(__nv_bfloat16, false, 32) : p.Dp == 32 ? VDT_SBWD(__nv_bfloat16, true, 32)
                                                                       : VDT_SBWD(__nv_bfloat16, true, 64);
#undef VDT_SBWD
  } else {
#define VDT_BWD(T, B)                                                                                   \
  vdt::launch_bwd<T, B>(x, g, wqkv, wqkv_t, bqkv, wo_t, bias, dbias_partial, dx, partial, scratch, tokens, \
                        f, c, heads, dim, kb, grid, scale, s)
    if (dtype == 0) rc = bias ? VDT_BWD(float, true) : VDT_BWD(float, false);
    else rc = bias ? VDT_BWD(__nv_bfloat16, true) : VDT_BWD(__nv_bfloat16, false);
#undef VDT_BWD
  }
  if (rc != 0) return rc;
  const size_t hd = (size_t)heads * dim;
  const size_t total = (size_t)c * 3 * hd + 3 * hd + hd * c + c;
  rc = vdt::launch_reduce(static_cast<const float*>(partial), grid, total, 1, (int)total,
                          static_cast<float*>(grads), (int)total, s);
  if (rc != 0 || !bias) return rc;
  const size_t panel = (size_t)heads * f * f;
  return vdt::launch_reduce(static_cast<const float*>(dbias_partial), grid, panel, 1, (int)panel,
                            static_cast<float*>(dbias), (int)panel, s);
}
