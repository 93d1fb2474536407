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
// per head, q is projected for all f frames, K and V are projected one block
// of KB frames at a time from the x column, and a running row maximum m, row
// sum l and unnormalised accumulator (all float32) are updated block by block.
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
// Design. One CTA owns one token column at a time (a persistent grid walks
// the tokens). Shared memory holds only per-head panels whose size follows f
// and KB, never f^2 or c: q, the accumulator, one K|V block, one score block
// and the row statistics (the backward adds do, dk|dv and a second score
// block). x and g are read from device memory where a product needs them
// (one column is at most a few hundred KB and stays in L2), so the kernels
// take any c. Across heads the CTA keeps the rounded o_h (and, in the
// backward, the rounded dq|dk|dv) in a scratch column of its own in device
// memory, written and read back by the same CTA; the output projection, dx,
// dW_qkv and dW_o are then single products over all heads after the head
// loop. That is how the backward does without the TPU kernel's float32
// (f, c) dx accumulator, which would not fit beside the panels at c = 256:
// dx = g + dqkv W_qkv^T is summed in registers and written once.
// The TPU pads f to 8 sublanes and masks padded keys with -1e9; here the
// ragged last block is a loop bound. Every product runs through `mm`, a
// register-blocked loop on the CUDA cores in float32.
//
// Weight gradients cross CTAs as in temporal_attention.cu: each CTA adds
// into its own float32 partial and `reduce_partials_kernel` sums the partials
// in block order, so results are bit-equal from run to run.
//
// Bias. The BIAS instantiations take `bias` (H, f, f) float32, the fixed-math
// relative position bias: bias[h, i, j0 + n] is added to the float32 logit of
// a KV block before the row maximum, in the forward, in the backward's
// statistics sweep, and again where its gradient sweep rebuilds p from lse
// (the TPU kernels' `bias_ref`; their KV-major transpose and padding of the
// bias are dropped, it is read with its own stride f). The backward also
// emits dbias: ds = p (dp - di) of every block, float32 and unrounded, summed
// over tokens. All H*f*f sums live across a CTA's tokens, more than shared
// memory holds beside the panels (512 KB at f = 128), so each CTA adds into
// an (H, f, f) partial of its own in device memory (`dbias_partial`): within
// one launch every element is added to by the same thread, once per token, in
// token order; no atomics. The partials are then reduced in block order like
// the weight gradients'.
//
// Bound on this card. Per token row the function needs 8*c*H*D + 4*f*H*D
// FLOPs forward and 22*c*H*D + 12*f*H*D backward (the dense backward's
// count), against 2 (3 in the backward) elements of c moved: far above the
// H100's FLOP-per-byte ridge, so the bound is the bf16 tensor-core rate.
// This backward does 4*c*H*D + 2*f*H*D more than the function needs (K|V
// projected and the logits rebuilt in both sweeps): overhead of the design,
// not part of the bound. These kernels multiply on the CUDA cores; wgmma
// tiles are later work.

#include "common.cuh"

namespace vdt {

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
                      void* dbias, void* dx, void* partial, void* grads, void* scratch, int tokens,
                      int f, int c, int heads, int dim, int kb, int grid, float scale,
                      cudaStream_t stream) {
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

// dtype: 0 = float32, 1 = bfloat16. `grid` CTAs walk the tokens; `scratch` holds grid * f * H*D
// elements of x's type. `bias` is (heads, f, f) float32 or null (the unbiased instantiation).
// Returns the cudaError_t of the launch.
extern "C" int temporal_blockwise_fwd(int dtype, const void* x, const void* wqkv,
                                      const void* bqkv, const void* wo, const void* bo,
                                      const void* bias, void* out, void* scratch, int tokens, int f,
                                      int c, int heads, int dim, int kb, int grid, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VDT_FWD(T, B)                                                                          \
  vdt::launch_fwd<T, B>(x, wqkv, bqkv, wo, bo, bias, out, scratch, tokens, f, c, heads, dim, \
                        kb, grid, scale, s)
  if (dtype == 0) return bias ? VDT_FWD(float, true) : VDT_FWD(float, false);
  if (dtype == 1) return bias ? VDT_FWD(__nv_bfloat16, true) : VDT_FWD(__nv_bfloat16, false);
#undef VDT_FWD
  return (int)cudaErrorInvalidValue;
}

// Backward: dx in x's type; `grads` (float32) receives dW_qkv (c, 3HD) | db_qkv (3HD) |
// dW_o (HD, c) | db_o (c), summed over the `grid` CTAs' partials in `partial` (grid x that size,
// float32). `scratch` holds grid * f * 4*H*D elements of x's type. With `bias`, `dbias`
// (heads, f, f) float32 receives the sum of the CTAs' `dbias_partial` (grid x heads*f*f, float32);
// all three are null for the unbiased instantiation.
extern "C" int temporal_blockwise_bwd(int dtype, const void* x, const void* g, const void* wqkv,
                                      const void* wqkv_t, const void* bqkv, const void* wo_t,
                                      const void* bias, void* dbias_partial, void* dbias, void* dx,
                                      void* partial, void* grads, void* scratch, int tokens, int f,
                                      int c, int heads, int dim, int kb, int grid, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bias && !(dbias_partial && dbias)) return (int)cudaErrorInvalidValue;
#define VDT_BWD(T, B)                                                                        \
  vdt::launch_bwd<T, B>(x, g, wqkv, wqkv_t, bqkv, wo_t, bias, dbias_partial, dbias, dx,     \
                        partial, grads, scratch, tokens, f, c, heads, dim, kb, grid, scale, s)
  if (dtype == 0) return bias ? VDT_BWD(float, true) : VDT_BWD(float, false);
  if (dtype == 1) return bias ? VDT_BWD(__nv_bfloat16, true) : VDT_BWD(__nv_bfloat16, false);
#undef VDT_BWD
  return (int)cudaErrorInvalidValue;
}
