// Cross (rectangular) attention block of the sequence-parallel temporal
// attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of video_diffusion_nnx_tpu/ops/cross_attention.py
// `_fwd_kernel` (line 121) and `_bwd_kernel` (line 151). A rank of a
// sequence-parallel group holds f_l of a clip's frames; its queries attend to
// the keys and values of all f_g frames, gathered from every rank:
//
//     out = x + sum_h softmax(q_h K_h^T) V_h W_o,h + b_o,   q_h = (x W_q,h + b_q,h) / sqrt(D)
//
// over the frame axis of x (tokens, f_l, c), with K and V (tokens, f_g, H*D)
// packed as the gather makes them: head h in columns [h*D, (h+1)*D) of a row.
//
// Rounding points are the TPU kernels': q = round((x W_q + b_q) * scale);
// an online softmax over KV blocks of 32 frames in float32 whose p = exp(s - m)
// is rounded to x's type before the p V product while l sums the unrounded p;
// o_h = round(acc / l); out = x + round(sum_h o_h W_o,h + b_o), the sum over
// heads in float32. The backward rebuilds p = exp(s - lse) from lse = m + log l,
// takes di = rowsum(do * o_h) from the unrounded do and o_h, rounds p, do, ds
// and dq to x's type before each product, sums db_q from the unrounded dq,
// writes dK and dV once, in x's type, and keeps every weight gradient in float32.
//
// Bound on this card: bytes. Per query row the function needs 4*c*H*D +
// 4*f_g*H*D FLOPs forward and 8*c*H*D + 8*f_g*H*D backward, but each token
// also reads its own K|V panels, 2*f_g*H*D elements, and the backward writes
// dK and dV of the same size. At the sequence-parallel recipe's widest level
// (x (2, 4096, 8, 32), K/V (2, 4096, 32, 256), bf16) the forward moves 277 MB
// against 4.3 GFLOP: 83 us of bytes at 3.35 TB/s against 4.3 us at the bf16
// tensor-core peak (the backward 549 MB against 8.6 GFLOP), and at every
// recipe shape the bytes' time is 5-20x the FLOPs'. What counts is to read K|V, x and g once, to
// write out, dx, dK and dV once, and to keep each token's critical path short.
//
// Two designs. The staged kernels (`cross_staged_fwd_kernel`,
// `cross_staged_bwd_kernel`, below) run wherever `cross_plan` fits 227 KB of
// shared memory, which is every shape of the recipe in either type; the
// first-design kernels (`cross_attention_fwd_kernel`, `..._bwd_kernel`) run
// the rest. Each C entry reports which one it launched.
//
// First design: temporal_blockwise.cu's first one. One CTA owns one token
// column at a time (a persistent grid walks the tokens) and loops over the
// heads; shared memory holds per-head float32 panels whose size follows f_l,
// the KV block and D, never c. x and g are read from device memory where a
// product needs them, so any c works; across heads the CTA keeps the rounded
// o_h (and dq) in a scratch column of its own in device memory. K and V are
// read straight from their packed rows; dK and dV of a token column are
// written once. Every product runs through `mm` on the CUDA cores.
//
// Weight gradients cross CTAs in both designs as in the other backward
// kernels: each CTA adds into its own float32 partial and
// `reduce_partials_kernel` sums the partials in block order, so results are
// bit-equal from run to run. No atomics.

#include "common.cuh"

namespace vdt {

// Shapes of one launch, and the strides of the shared-memory panels (odd, so
// that row-wise loops spread over the banks).
struct XDims {
  int FL, FG, C, H, D, KB, HD, QS, KS, PS;
  __host__ __device__ XDims(int fl, int fg, int c, int h, int d, int kb)
      : FL(fl), FG(fg), C(c), H(h), D(d), KB(kb), HD(h * d), QS(d + 1), KS(2 * d + 1), PS(kb + 1) {}
  // Floats of shared memory: q and the accumulator, one K|V block, one score
  // block, m and l; the backward adds do, dk|dv, a second score block and di.
  __host__ __device__ size_t fwd_floats() const {
    return (size_t)2 * FL * QS + (size_t)KB * KS + (size_t)FL * PS + 2 * FL;
  }
  __host__ __device__ size_t bwd_floats() const {
    return (size_t)3 * FL * QS + (size_t)2 * KB * KS + (size_t)2 * FL * PS + 3 * FL;
  }
};

// q_h = round((x W_q,h + b_q,h) * scale) for the f_l frames, into qs (FL, QS).
template <typename T>
__device__ __forceinline__ void project_q(const XDims& s, const T* __restrict__ xt,
                                          const T* __restrict__ wq, const float* __restrict__ bq,
                                          float* qs, int h, float scale) {
  const int col0 = h * s.D;
  mm<1, 1>(
      threadIdx.x, blockDim.x, s.FL, s.D, s.C,
      [&](int m, int k) { return to_f(xt[(size_t)m * s.C + k]); },
      [&](int k, int n) { return to_f(wq[(size_t)k * s.HD + col0 + n]); },
      [&](int m, int n, float v) { qs[m * s.QS + n] = rnd<T>((v + bq[col0 + n]) * scale); });
  __syncthreads();
}

// Head h's k|v of the `nb` frames from j0, read from the packed rows, into kvs (nb, KS): k in [0, D),
// v in [D, 2D).
template <typename T>
__device__ __forceinline__ void load_kv(const XDims& s, const T* __restrict__ kt,
                                        const T* __restrict__ vt, float* kvs, int h, int j0,
                                        int nb) {
  for (int i = threadIdx.x; i < nb * 2 * s.D; i += blockDim.x) {
    const int r = i / (2 * s.D), n = i - r * 2 * s.D;
    const T* src = n < s.D ? kt : vt;
    kvs[r * s.KS + n] = to_f(src[(size_t)(j0 + r) * s.HD + h * s.D + (n < s.D ? n : n - s.D)]);
  }
  __syncthreads();
}

// The online-softmax sweep of head h over the KV blocks (forward, and sweep 1
// of the backward). On return, for every query row: ms = running maximum,
// ls = sum of exp(s - m), acc (FL, QS) = sum_j round(exp(s_j - m)) v_j.
template <typename T>
__device__ void online_pass(const XDims& s, const T* __restrict__ kt, const T* __restrict__ vt,
                            const float* qs, float* acc, float* kvs, float* ps, float* ms,
                            float* ls, int h) {
  const int tid = threadIdx.x, nth = blockDim.x;
  for (int i = tid; i < s.FL * s.QS; i += nth) acc[i] = 0.f;
  for (int i = tid; i < s.FL; i += nth) {
    ms[i] = -1e30f;
    ls[i] = 0.f;
  }
  __syncthreads();
  for (int j0 = 0; j0 < s.FG; j0 += s.KB) {
    const int nb = min(s.KB, s.FG - j0);
    load_kv<T>(s, kt, vt, kvs, h, j0, nb);
    mm<1, 1>(
        tid, nth, s.FL, nb, s.D, [&](int m, int k) { return qs[m * s.QS + k]; },
        [&](int k, int n) { return kvs[n * s.KS + k]; },
        [&](int m, int n, float v) { ps[m * s.PS + n] = v; });
    __syncthreads();
    // Rescale: 8 lanes share a row; the loop bound is uniform so that every lane reaches the shuffles.
    const int lane = tid & 7;
    for (int r0 = 0; r0 < s.FL; r0 += nth >> 3) {
      const int row = r0 + (tid >> 3);
      const bool live = row < s.FL;
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
    mm<1, 1>(
        tid, nth, s.FL, s.D, nb, [&](int m, int k) { return ps[m * s.PS + k]; },
        [&](int k, int n) { return kvs[k * s.KS + s.D + n]; },
        [&](int m, int n, float v) { acc[m * s.QS + n] += v; });
    __syncthreads();
  }
}

// `ohs_all` is the CTAs' scratch, (grid, FL, HD) of T: the rounded o_h of every head of the
// CTA's current token. It is written and read back by the same CTA, so it is not `const`.
template <typename T>
__global__ void __launch_bounds__(kThreads) cross_attention_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ wq, const float* __restrict__ bq, const T* __restrict__ wo,
    const float* __restrict__ bo, T* __restrict__ out, T* ohs_all, int tokens, int FL, int FG,
    int C, int H, int D, int KB, float scale) {
  extern __shared__ float smem[];
  const XDims s(FL, FG, C, H, D, KB);
  float* qs = smem;                       // (FL, QS)  q of the head
  float* acc = qs + (size_t)FL * s.QS;    // (FL, QS)  unnormalised output accumulator
  float* kvs = acc + (size_t)FL * s.QS;   // (KB, KS)  one block's k|v
  float* ps = kvs + (size_t)KB * s.KS;    // (FL, PS)  one block's logits, then probabilities
  float* ms = ps + (size_t)FL * s.PS;     // (FL)      running maximum
  float* ls = ms + FL;                    // (FL)      running sum
  const int tid = threadIdx.x, nth = blockDim.x;
  T* ohs = ohs_all + (size_t)blockIdx.x * FL * s.HD;

  for (int tok = blockIdx.x; tok < tokens; tok += gridDim.x) {
    const T* xt = x + (size_t)tok * FL * C;
    const T* kt = k + (size_t)tok * FG * s.HD;
    const T* vt = v + (size_t)tok * FG * s.HD;
    T* ot = out + (size_t)tok * FL * C;
    for (int h = 0; h < H; ++h) {
      project_q<T>(s, xt, wq, bq, qs, h, scale);
      online_pass<T>(s, kt, vt, qs, acc, kvs, ps, ms, ls, h);
      for (int i = tid; i < FL * D; i += nth) {
        const int r = i / D, d = i - r * D;
        ohs[(size_t)r * s.HD + h * D + d] = from_f<T>(acc[r * s.QS + d] / ls[r]);
      }
      __syncthreads();
    }
    // out = x + round(sum_h o_h W_o,h + b_o), one product over all heads.
    mm<1, 2>(
        tid, nth, FL, C, s.HD, [&](int m, int kk) { return to_f(ohs[(size_t)m * s.HD + kk]); },
        [&](int kk, int n) { return to_f(wo[(size_t)kk * C + n]); },
        [&](int m, int n, float val) {
          const size_t i = (size_t)m * C + n;
          ot[i] = from_f<T>(to_f(xt[i]) + rnd<T>(val + bo[n]));
        });
    __syncthreads();  // the next token overwrites the scratch
  }
}

// Backward. Per token and head: sweep 1 (`online_pass`) rebuilds m, l and
// o_h; do = g W_o,h^T and di follow; sweep 2 walks the KV blocks again with
// lse = m + log l, writes each block's dk|dv and accumulates dq. The rounded
// o_h and dq of all heads go to the CTA's scratch, `scr_all` (grid, FL, 2HD)
// of T: o_h in [0, HD) of a row, dq in [HD, 2HD). After the heads:
// dW_o += o^T g, dW_q += x^T dq, db_o += sum g and dx = g + dq W_q^T.
// `wq_t` (HD, c) and `wo_t` (c, HD) are the weights transposed by the
// caller, so that these products read along rows.
template <typename T>
__global__ void __launch_bounds__(kThreads) cross_attention_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ wq, const T* __restrict__ wq_t,
    const float* __restrict__ bq, const T* __restrict__ wo_t, T* __restrict__ dx,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ partial, T* scr_all, int tokens,
    int FL, int FG, int C, int H, int D, int KB, float scale) {
  extern __shared__ float smem[];
  const XDims s(FL, FG, C, H, D, KB);
  float* qs = smem;                        // (FL, QS)  q of the head
  float* acc = qs + (size_t)FL * s.QS;     // (FL, QS)  sweep 1: accumulator, then o_h; sweep 2: dq
  float* dos = acc + (size_t)FL * s.QS;    // (FL, QS)  do, rounded once di is taken
  float* kvs = dos + (size_t)FL * s.QS;    // (KB, KS)  one block's k|v
  float* dkv = kvs + (size_t)KB * s.KS;    // (KB, KS)  one block's dk|dv
  float* ps = dkv + (size_t)KB * s.KS;     // (FL, PS)  logits, then probabilities
  float* dss = ps + (size_t)FL * s.PS;     // (FL, PS)  ds, rounded
  float* ms = dss + (size_t)FL * s.PS;     // (FL)      maximum, then lse
  float* ls = ms + FL;                     // (FL)      sum
  float* di = ls + FL;                     // (FL)      rowsum(do * o_h)
  const int tid = threadIdx.x, nth = blockDim.x, lane = tid & 7;
  const int HD = s.HD, S2 = 2 * HD;
  T* scr = scr_all + (size_t)blockIdx.x * FL * S2;

  const size_t total = (size_t)C * HD + HD + (size_t)HD * C + C;
  float* pwq = partial + (size_t)blockIdx.x * total;  // dW_q (C, HD)
  float* pbq = pwq + (size_t)C * HD;                  // db_q (HD)
  float* pwo = pbq + HD;                              // dW_o (HD, C)
  float* pbo = pwo + (size_t)HD * C;                  // db_o (C)
  for (size_t i = tid; i < total; i += nth) pwq[i] = 0.f;
  __syncthreads();

  for (int tok = blockIdx.x; tok < tokens; tok += gridDim.x) {
    const T* xt = x + (size_t)tok * FL * C;
    const T* gt = g + (size_t)tok * FL * C;
    const T* kt = k + (size_t)tok * FG * HD;
    const T* vt = v + (size_t)tok * FG * HD;
    T* dxt = dx + (size_t)tok * FL * C;
    T* dkt = dk + (size_t)tok * FG * HD;
    T* dvt = dv + (size_t)tok * FG * HD;
    for (int h = 0; h < H; ++h) {
      project_q<T>(s, xt, wq, bq, qs, h, scale);
      online_pass<T>(s, kt, vt, qs, acc, kvs, ps, ms, ls, h);
      // o_h = acc / l: unrounded over acc, rounded to the scratch.
      for (int i = tid; i < FL * D; i += nth) {
        const int r = i / D, d = i - r * D;
        const float o = acc[r * s.QS + d] / ls[r];
        acc[r * s.QS + d] = o;
        scr[(size_t)r * S2 + h * D + d] = from_f<T>(o);
      }
      // do = g W_o,h^T, unrounded.
      mm<1, 1>(
          tid, nth, FL, D, C, [&](int m, int kk) { return to_f(gt[(size_t)m * C + kk]); },
          [&](int kk, int n) { return to_f(wo_t[(size_t)kk * HD + h * D + n]); },
          [&](int m, int n, float val) { dos[m * s.QS + n] = val; });
      __syncthreads();
      for (int r = tid; r < FL; r += nth) ms[r] += logf(ls[r]);  // lse
      // di = rowsum(do * o_h) from the unrounded values; then do rounds in place and the
      // accumulator is cleared for dq. 8 lanes share a row.
      for (int r0 = 0; r0 < FL; r0 += nth >> 3) {
        const int row = r0 + (tid >> 3);
        const bool live = row < FL;
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

      for (int j0 = 0; j0 < FG; j0 += KB) {
        const int nb = min(KB, FG - j0);
        load_kv<T>(s, kt, vt, kvs, h, j0, nb);
        // p = exp(s - lse), unrounded.
        mm<1, 1>(
            tid, nth, FL, nb, D, [&](int m, int kk) { return qs[m * s.QS + kk]; },
            [&](int kk, int n) { return kvs[n * s.KS + kk]; },
            [&](int m, int n, float val) { ps[m * s.PS + n] = expf(val - ms[m]); });
        __syncthreads();
        // dp = do v^T; ds = p (dp - di), rounded; p rounds in place.
        mm<1, 1>(
            tid, nth, FL, nb, D, [&](int m, int kk) { return dos[m * s.QS + kk]; },
            [&](int kk, int n) { return kvs[n * s.KS + D + kk]; },
            [&](int m, int n, float val) {
              const float p = ps[m * s.PS + n];
              dss[m * s.PS + n] = rnd<T>(p * (val - di[m]));
              ps[m * s.PS + n] = rnd<T>(p);
            });
        __syncthreads();
        // dk = ds^T q and dv = p^T do, each by half of the threads; dq += ds k by all.
        const int half = nth >> 1;
        if (tid < half) {
          mm<1, 2>(
              tid, half, nb, D, FL, [&](int m, int kk) { return dss[kk * s.PS + m]; },
              [&](int kk, int n) { return qs[kk * s.QS + n]; },
              [&](int m, int n, float val) { dkv[m * s.KS + n] = val; });
        } else {
          mm<1, 2>(
              tid - half, nth - half, nb, D, FL, [&](int m, int kk) { return ps[kk * s.PS + m]; },
              [&](int kk, int n) { return dos[kk * s.QS + n]; },
              [&](int m, int n, float val) { dkv[m * s.KS + D + n] = val; });
        }
        mm<1, 1>(
            tid, nth, FL, D, nb, [&](int m, int kk) { return dss[m * s.PS + kk]; },
            [&](int kk, int n) { return kvs[kk * s.KS + n]; },
            [&](int m, int n, float val) { acc[m * s.QS + n] += val; });
        __syncthreads();
        // This column's dk|dv of the block, written once from float32. The next block's load
        // ends in a barrier before dkv is written again.
        for (int i = tid; i < nb * 2 * D; i += nth) {
          const int r = i / (2 * D), n = i - r * 2 * D;
          const size_t at = (size_t)(j0 + r) * HD + h * D + (n < D ? n : n - D);
          (n < D ? dkt : dvt)[at] = from_f<T>(dkv[r * s.KS + n]);
        }
      }
      // dq = (sum over blocks) * scale: db_q from the unrounded values, rounded to the scratch.
      for (int d = tid; d < D; d += nth) {
        float sum = 0.f;
        for (int r = 0; r < FL; ++r) sum += acc[r * s.QS + d] * scale;
        pbq[h * D + d] += sum;
      }
      for (int i = tid; i < FL * D; i += nth) {
        const int r = i / D, d = i - r * D;
        scr[(size_t)r * S2 + HD + h * D + d] = from_f<T>(acc[r * s.QS + d] * scale);
      }
      __syncthreads();
    }

    // After the heads, from the scratch: dW_o += o^T g.
    mm<4, 4>(
        tid, nth, HD, C, FL, [&](int m, int kk) { return to_f(scr[(size_t)kk * S2 + m]); },
        [&](int kk, int n) { return to_f(gt[(size_t)kk * C + n]); },
        [&](int m, int n, float val) { pwo[(size_t)m * C + n] += val; });
    // dW_q += x^T dq.
    mm<4, 4>(
        tid, nth, C, HD, FL, [&](int m, int kk) { return to_f(xt[(size_t)kk * C + m]); },
        [&](int kk, int n) { return to_f(scr[(size_t)kk * S2 + HD + n]); },
        [&](int m, int n, float val) { pwq[(size_t)m * HD + n] += val; });
    // db_o += sum of g over the frames.
    for (int n = tid; n < C; n += nth) {
      float sum = 0.f;
      for (int r = 0; r < FL; ++r) sum += to_f(gt[(size_t)r * C + n]);
      pbo[n] += sum;
    }
    // dx = round(g + dq W_q^T).
    mm<1, 2>(
        tid, nth, FL, C, HD, [&](int m, int kk) { return to_f(scr[(size_t)m * S2 + HD + kk]); },
        [&](int kk, int n) { return to_f(wq_t[(size_t)kk * C + n]); },
        [&](int m, int n, float val) {
          const size_t i = (size_t)m * C + n;
          dxt[i] = from_f<T>(to_f(gt[i]) + val);
        });
    __syncthreads();  // the next token overwrites the scratch
  }
}

// ---------------------------------------------------------------------------
// Staged redesign: heads in parallel, one warp each, K|V of a token read once
// for all heads, the width-scaling products on the tensor cores (bf16).
//
// The same functions and rounding points as the kernels above. Design:
//   1. Tiles of TT tokens (TT * f_l rows, padded to a multiple of 16: two
//      tokens at the recipe's f_l = 8). q = round((x W_q + b_q) * scale)
//      (and, in the backward, do = g W_o^T in float32 and rounded) come from
//      `panel_mma` over the tile's rows: `mma.sync` in bf16, the CUDA cores
//      in float32 (TF32 would miss the float32 gates). W_q and W_o^T (both
//      (c, H*D), x's type) stay resident for the persistent CTA's life where
//      they fit, and the tile's x (and g) rows come into one of two row slots
//      while the previous tile runs. Where they do not fit (c = 256), c-chunks
//      of the weights and of the tile's rows stream through a ring of one or
//      two slots, as `sw_plan` does for the temporal kernels.
//   2. Attention token by token: K|V of the token (f_g rows of all heads, in
//      x's type, straight from the packed rows) arrive through `cp.async`
//      into a two-slot ring, so that the next token's load overlaps this
//      token's work (one slot where shared memory is short); one block
//      barrier per token. Each warp owns whole heads
//      (warp w takes heads w, w + 8, ...) and keeps S, P and its accumulators
//      in m16n8k16 fragments (`sweep_rows`, `warp_nt`, `warp_pv` in
//      common.cuh): no block barrier inside a head. f_l = 8 does not fill an
//      m16 tile: the query rows are padded to 16 (a token's 16-row window
//      reaches into the next token's rows, which are masked). The kernel is
//      bound by bytes, so the idle half costs nothing, and P stays in the
//      layout of the A fragments of P V (an S^T = K q^T layout would need a
//      transpose there).
//   3. Forward: o_h = round(acc / l) overwrites q in place (a head's columns
//      belong to one warp, and a window never reaches back into the previous
//      token); after the tile's tokens out = x + round(o W_o + b_o) is one
//      product, written straight from the fragments.
//   4. Backward, per token and head: the sweep rebuilds m, l and o (lse and
//      di to the warp's scratch, round(o) to a panel); phase A walks key rows
//      16 at a time, dv = sum round(P)^T round(do) and dk = sum round(dS)^T q
//      over the query rows, and writes the head's dK and dV once from the
//      fragments; phase B walks query rows, dq = sum round(dS) k over KV
//      blocks of 32, adds its unrounded column sums to db_q and writes
//      round(dq) over q. After the tile's tokens: dW_o += round(o)^T g,
//      dW_q += x^T round(dq), db_o += sum g and dx = g + round(dq) W_q^T,
//      each one product over the tile's rows.
//   5. The weight-gradient partials (float32) stay in shared memory across
//      the CTA's tiles where they fit (c = 32) and are written to the CTA's
//      partial once; elsewhere the CTA's first tile writes its partial in
//      device memory and every later tile adds to it once (`partial_mma`).
//      db_q and db_o always stay on chip. Each partial is summed in a fixed
//      order, so two runs are bit-equal. dK and dV leave the fragments as
//      16-byte rows (`store_frag_rows`).
// In float32 the rounded copies are the values themselves: round(do) is do,
// and the chunked q sum runs in the q panel.
// `cross_plan` (ops/cross_attention.py mirrors it) picks the layout: the
// tile's tokens first, then the widest c-chunk, then the partials on chip,
// then two K|V slots, then two chunk slots; head dims 32 and 64.

// Shared-memory layout of a staged launch (host and device). Offsets in bytes; slot sizes in elements.
struct XPlan {
  int TT, Rp, Rq, Rd, Fq, Fgk, Cp, CK, nch, NKV, NW, part;
  int LDX, LDH, LDKV, LDF, LDA, LDPO;
  size_t xslot, kvslot, wslot, wrows;
  size_t xs, kv, w, qp, dob, op, dof, qacc, st, dbq, dbo, pw, scr, bytes;
};

constexpr int kXWarps = kThreads / 32;
constexpr int kXScr = 16 * (32 + 4);  // floats of a warp's scratch for P on the CUDA cores (float32)

__host__ __device__ inline XPlan cross_layout(int TT, int FL, int FG, int C, int H, int D, int elt, bool bwd,
                                             int CK, int part, int NKV, int NW) {
  XPlan p;
  const int HD = H * D;
  p.TT = TT;
  p.Rp = round16(TT * FL);
  p.Fq = round16(FL);
  p.Rq = p.Rp > (TT - 1) * FL + p.Fq ? p.Rp : (TT - 1) * FL + p.Fq;  // rows the last token's windows read
  p.Fgk = (FG + 31) / 32 * 32;
  p.Cp = round16(C);
  p.CK = CK;
  p.nch = (p.Cp + CK - 1) / CK;
  const bool resident = p.nch == 1;
  p.NKV = NKV;
  p.NW = resident ? 0 : NW;
  p.part = bwd ? part : 0;
  p.LDX = pad_ld(CK);  // x (and g) rows: the whole width where resident, else one chunk
  p.LDH = pad_ld(HD);
  p.LDKV = pad_ld(2 * HD);
  p.LDF = HD + 4;
  p.LDA = elt == 4 ? p.LDH : p.LDF;  // float32: do and the chunked q sum live in the panels themselves
  p.Rd = elt == 4 ? p.Rq : p.Rp;     // rows of the float32 do; in float32 also round(do), read by windows
  p.LDPO = p.Cp + 4;
  const int nrow = bwd ? 2 : 1;
  p.xslot = (size_t)nrow * p.Rp * p.LDX;
  p.kvslot = (size_t)p.Fgk * p.LDKV;
  p.wrows = resident ? 0 : p.xslot;  // a chunk slot: the tile's row chunks, then the weight chunks
  p.wslot = p.wrows + (size_t)nrow * CK * p.LDH;
  size_t at = 0;
  p.xs = at;   if (resident) at = al16(at + 2 * p.xslot * elt);
  p.kv = at;   at = al16(at + NKV * p.kvslot * elt);
  p.w = at;    at = al16(at + (resident ? (size_t)2 * p.Cp * p.LDH : p.NW * p.wslot) * elt);
  p.qp = at;   at = al16(at + (size_t)p.Rq * p.LDH * elt);
  p.dof = at;  if (bwd) at = al16(at + (size_t)p.Rd * p.LDA * 4);
  p.dob = at;  if (bwd && elt == 2) at = al16(at + (size_t)p.Rq * p.LDH * elt);
  p.op = at;   if (bwd) at = al16(at + (size_t)p.Rp * p.LDH * elt);
  p.qacc = at; if (!resident && elt == 2) at = al16(at + (size_t)p.Rp * p.LDF * 4);
  p.st = at;   if (bwd) at = al16(at + (size_t)kXWarps * 2 * p.Fq * 4);
  p.dbq = at;  if (bwd) at = al16(at + (size_t)HD * 4);
  p.dbo = at;  if (bwd) at = al16(at + (size_t)p.Cp * 4);
  p.pw = at;   if (p.part) at = al16(at + ((size_t)p.Cp * p.LDF + (size_t)HD * p.LDPO) * 4);
  p.scr = at;  if (elt == 4) at = al16(at + (size_t)kXWarps * kXScr * 4);
  p.bytes = at;
  return p;
}

// The plan of a launch: tokens per tile from TT down to 1, then the c-chunk (c itself, i.e. resident
// weights, then 128, 64, 32, 16), then (backward) the partials on chip before device memory, then two
// K|V slots before one, then two chunk slots before one; the first that fits 227 KB. False where none
// does, or the head dim is not 32 or 64.
__host__ __device__ inline bool cross_plan(int TT, int FL, int FG, int C, int H, int D, int elt, bool bwd,
                                           XPlan* out) {
  if ((D != 32 && D != 64) || TT < 1 || FL < 1 || FG < 1 || C < 1 || H < 1) return false;
  const int Cp = round16(C);
  const int cands[5] = {Cp, 128, 64, 32, 16};
  for (int tt = TT; tt >= 1; --tt)
    for (int i = 0; i < 5; ++i) {
      if (i > 0 && cands[i] >= Cp) continue;
      for (int part = bwd ? 1 : 0; part >= 0; --part)
        for (int nkv = 2; nkv >= 1; --nkv)
          for (int nw = i == 0 ? 1 : 2; nw >= 1; --nw) {
            const XPlan p = cross_layout(tt, FL, FG, C, H, D, elt, bwd, cands[i], part, nkv, nw);
            if (p.bytes <= kSmemMax) {
              *out = p;
              return true;
            }
          }
    }
  return false;
}

// Two neighbouring values of a row in device memory, rounded to T (paired where the second exists).
__device__ __forceinline__ void put2(bf16* p, float a, float b, bool both) {
  if (both && (reinterpret_cast<size_t>(p) & 3) == 0) *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  else {
    p[0] = __float2bfloat16(a);
    if (both) p[1] = __float2bfloat16(b);
  }
}
__device__ __forceinline__ void put2(float* p, float a, float b, bool both) {
  p[0] = a;
  if (both) p[1] = b;
}

// dst (the CTA's own partial in device memory, leading dimension ldd) = A B where `first` (the CTA's first
// tile: no read, no zero fill), else += A B, for r < Mv, c < Nv; the 16 x 16 blocks of panel_mma_add. In bf16
// each warp reads the old values of four of its blocks before it multiplies them, so that the reads overlap.
template <bool AT, bool BK>
__device__ void partial_mma(const bf16* A, int lda, const bf16* B, int ldb, int M, int N, int K, float* dst,
                            size_t ldd, int Mv, int Nv, bool first) {
  constexpr int G = 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int nb = N / 16, nblk = (M / 16) * nb;
  for (int b0 = warp; b0 < nblk; b0 += G * nwarps) {
    float old[G][2][4];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int blk = b0 + u * nwarps;
      const int r0 = (blk / nb) * 16 + (lane >> 2), c0 = (blk % nb) * 16 + (lane & 3) * 2;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + (e >> 1) * 8, c = c0 + 8 * j + (e & 1);
          old[u][j][e] = (!first && blk < nblk && r < Mv && c < Nv) ? dst[(size_t)r * ldd + c] : 0.f;
        }
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int blk = b0 + u * nwarps;  // the same for every lane of the warp
      if (blk >= nblk) break;
      const int m0 = (blk / nb) * 16, n0 = (blk % nb) * 16;
      float acc[2][4];
      mma_block<AT, BK>(A, lda, B, ldb, m0, n0, K, acc);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = m0 + (lane >> 2) + (e >> 1) * 8, c = n0 + (lane & 3) * 2 + 8 * j + (e & 1);
          if (r < Mv && c < Nv) dst[(size_t)r * ldd + c] = old[u][j][e] + acc[j][e];
        }
    }
  }
}
template <bool AT, bool BK>
__device__ void partial_mma(const float* A, int lda, const float* B, int ldb, int M, int N, int K, float* dst,
                            size_t ldd, int Mv, int Nv, bool first) {
  simt_mma<AT, BK>(A, lda, B, ldb, M, N, K, [=](int r, int c, float v0, float v1) {
    if (r < Mv && c < Nv) dst[(size_t)r * ldd + c] = first ? v0 : dst[(size_t)r * ldd + c] + v0;
    if (r < Mv && c + 1 < Nv) dst[(size_t)r * ldd + c + 1] = first ? v1 : dst[(size_t)r * ldd + c + 1] + v1;
  });
}

// The lane's rows g and g + 8 (lane = 4g + q) of a 16 x 8NB accumulator fragment, rounded to x's type, to
// `row_g` and `row_g8` in device memory (columns 0 .. 8NB; `ok_g` / `ok_g8` false skips a row). The quad's
// lanes trade their pairs so that each writes 8 neighbouring columns of a row at once (16 bytes in bf16):
// in round rr lane q reads from lane q + rr of its quad, which sends the pair of the block lane q writes.
template <int NB>
__device__ __forceinline__ void store_frag_rows(bf16* row_g, bf16* row_g8, const float (&a)[NB][4], bool ok_g,
                                                bool ok_g8) {
  const int lane = threadIdx.x & 31, q = lane & 3;
#pragma unroll
  for (int jj = 0; jj < NB / 4; ++jj)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      unsigned mine[4], out[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int u = 0; u < 4; ++u) mine[u] = pack_bf16(a[4 * jj + u][2 * half], a[4 * jj + u][2 * half + 1]);
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int want = (q - rr) & 3, src = (q + rr) & 3;
        const unsigned send = want == 0 ? mine[0] : want == 1 ? mine[1] : want == 2 ? mine[2] : mine[3];
        const unsigned got = __shfl_sync(0xffffffffu, send, (lane & ~3) | src);
#pragma unroll
        for (int p = 0; p < 4; ++p)
          if (p == src) out[p] = got;
      }
      if (half ? ok_g8 : ok_g)
        *reinterpret_cast<uint4*>((half ? row_g8 : row_g) + 8 * (4 * jj + q)) = make_uint4(out[0], out[1], out[2], out[3]);
    }
}
template <int NB>
__device__ __forceinline__ void store_frag_rows(float* row_g, float* row_g8, const float (&a)[NB][4], bool ok_g,
                                                bool ok_g8) {
  const int lane = threadIdx.x & 31, q = lane & 3;
#pragma unroll
  for (int jj = 0; jj < NB / 4; ++jj)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float out[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int want = (q - rr) & 3, src = (q + rr) & 3;
        float s0 = a[4 * jj][2 * half], s1 = a[4 * jj][2 * half + 1];
#pragma unroll
        for (int u = 1; u < 4; ++u)
          if (want == u) {
            s0 = a[4 * jj + u][2 * half];
            s1 = a[4 * jj + u][2 * half + 1];
          }
        const float g0 = __shfl_sync(0xffffffffu, s0, (lane & ~3) | src);
        const float g1 = __shfl_sync(0xffffffffu, s1, (lane & ~3) | src);
#pragma unroll
        for (int p = 0; p < 4; ++p)
          if (p == src) {
            out[2 * p] = g0;
            out[2 * p + 1] = g1;
          }
      }
      if (half ? ok_g8 : ok_g) {
        float4* d = reinterpret_cast<float4*>((half ? row_g8 : row_g) + 8 * (4 * jj + q));
        d[0] = make_float4(out[0], out[1], out[2], out[3]);
        d[1] = make_float4(out[4], out[5], out[6], out[7]);
      }
    }
}

// The CTA's loads: its tiles (blockIdx.x, + gridDim.x, ...); where the weights are resident, the rows of x
// (and g) of a tile into one of two row slots; K|V of a token into a K|V slot; where they are not, the ring
// of chunks: per tile nch stages of the first phase (forward: x and W_q; backward: x, g, W_q and W_o^T),
// then nch of the second (forward: x and W_o^T; backward: x, g and W_q), each holding the tile's rows
// [c0, c0 + CK) and the weights' rows [c0, c0 + CK). Each load commits its own cp.async group.
template <typename T>
struct XLoads {
  const XPlan& pl;
  unsigned char* smem;
  const T *x, *g, *k, *v, *wq, *wo_t;
  int tokens, ntiles, FL, FG, C, HD;

  __device__ int tile(int kk) const {
    const int t = blockIdx.x + kk * gridDim.x;
    return t < ntiles ? t : -1;
  }
  __device__ T* xslot(int kk) const { return reinterpret_cast<T*>(smem + pl.xs) + (size_t)(kk & 1) * pl.xslot; }
  __device__ T* kvslot(int n) const { return reinterpret_cast<T*>(smem + pl.kv) + (size_t)(n % pl.NKV) * pl.kvslot; }
  __device__ T* wslot(int gi) const { return reinterpret_cast<T*>(smem + pl.w) + (size_t)(gi % pl.NW) * pl.wslot; }

  // Columns [c0, c0 + width) of the rows of x (and g) of tile t into `dst` (Rp rows of LDX, zero past them).
  __device__ void tile_rows(T* dst, int t, int c0, int width) const {
    const int tok0 = t * pl.TT, R = min(pl.TT, tokens - tok0) * FL, cw = max(0, min(width, C - c0));
    stage(dst, pl.LDX, x + (size_t)tok0 * FL * C + c0, C, R, cw, pl.Rp, width);
    if (g) stage(dst + (size_t)pl.Rp * pl.LDX, pl.LDX, g + (size_t)tok0 * FL * C + c0, C, R, cw, pl.Rp, width);
  }

  __device__ void rows(int kk) const {
    const int t = tile(kk);
    if (t < 0) return;
    tile_rows(xslot(kk), t, 0, pl.Cp);
    cp_async_commit();
  }

  // K|V of token t of tile kk into K|V slot n: k in columns [0, HD), v in [HD, 2HD); rows past f_g zero.
  __device__ void kv(int kk, int t, int n) const {
    const int tl = tile(kk);
    if (tl < 0 || t >= pl.TT || tl * pl.TT + t >= tokens) return;
    const size_t tok = (size_t)tl * pl.TT + t;
    constexpr int E = 16 / sizeof(T);  // elements per copy
    const int U = HD / E;
    T* dst = kvslot(n);
    for (int i = threadIdx.x; i < pl.Fgk * 2 * U; i += blockDim.x) {
      const int r = i / (2 * U), rem = i - r * 2 * U, part = rem / U, u = rem - part * U;
      const bool valid = r < FG;
      const T* src = (part ? v : k) + (tok * FG + (valid ? r : 0)) * HD + u * E;
      cp_async16(dst + (size_t)r * pl.LDKV + part * HD + u * E, src, valid);
    }
    cp_async_commit();
  }

  // Chunk stage gi of the ring (see above) into its slot.
  __device__ void chunk(int gi, bool bwd) const {
    const int per_tile = 2 * pl.nch, kk = gi / per_tile, r = gi - kk * per_tile;
    const int t = tile(kk);
    if (t < 0) return;
    const int c0 = (r % pl.nch) * pl.CK, cw = max(0, min(pl.CK, C - c0));
    const bool first = r < pl.nch;
    T* dst = wslot(gi);
    tile_rows(dst, t, c0, pl.CK);
    T* wd = dst + pl.wrows;
    stage(wd, pl.LDH, ((first || bwd) ? wq : wo_t) + (size_t)c0 * HD, HD, cw, HD, pl.CK, HD);
    if (first && bwd) stage(wd + (size_t)pl.CK * pl.LDH, pl.LDH, wo_t + (size_t)c0 * HD, HD, cw, HD, pl.CK, HD);
    cp_async_commit();
  }

  // Wait for chunk stage gi; with two slots, then start loading stage gi + 1; with one, load it first.
  __device__ const T* ready_chunk(int gi, bool bwd) const {
    if (pl.NW == 1) {
      __syncthreads();  // everyone is done with the slot
      chunk(gi, bwd);
    }
    cp_async_wait_all();
    __syncthreads();
    if (pl.NW == 2) chunk(gi + 1, bwd);
    return wslot(gi);
  }

  // K|V of token t of tile kk (of Ti tokens; the CTA's n-th token): wait for it, then start loading the
  // next token's (two slots); with one slot, load it now.
  __device__ const T* ready_kv(int kk, int t, int Ti, int n) const {
    if (pl.NKV == 1) {
      __syncthreads();  // everyone is done with the slot
      kv(kk, t, n);
      cp_async_wait_all();
      __syncthreads();
    } else {
      cp_async_wait_all();
      __syncthreads();
      if (t + 1 < Ti) kv(kk, t + 1, n + 1);
      else kv(kk + 1, 0, n + 1);
    }
    return kvslot(n);
  }

  // The first loads of a CTA: resident weights and the first tile's rows, or the first chunk stage (two
  // slots); the first token's K|V (two slots).
  __device__ void prologue(T* ws, bool bwd) const {
    if (pl.nch == 1) {
      stage(ws, pl.LDH, wq, HD, C, HD, pl.Cp, HD);
      stage(ws + (size_t)pl.Cp * pl.LDH, pl.LDH, wo_t, HD, C, HD, pl.Cp, HD);
      rows(0);
    } else if (pl.NW == 2) {
      chunk(0, bwd);
    }
    if (pl.NKV == 2) kv(0, 0, 0);
  }
};

// q = round((x W_q + b_q) * scale) for the tile's rows into qp; with `bwd`, also do = g W_o^T into dof
// (float32) and round(do) into dob. Resident weights: starts the next tile's rows once their slot is free.
template <typename T>
__device__ void cross_project(const XLoads<T>& ld, int kk, int& gi, bool bwd, const T* ws, T* qp, float* qacc,
                              T* dob, float* dof, const float* __restrict__ bq, float scale) {
  const XPlan& pl = ld.pl;
  const int HD = ld.HD, Rp = pl.Rp, LDH = pl.LDH, LDA = pl.LDA;
  auto epi_q = [=](int r, int c, float v0, float v1) {
    st2(qp + (size_t)r * LDH + c, (v0 + bq[c]) * scale, (v1 + bq[c + 1]) * scale);
  };
  auto epi_do = [=](int r, int c, float v0, float v1) {
    dof[(size_t)r * LDA + c] = v0;
    dof[(size_t)r * LDA + c + 1] = v1;
    if (sizeof(T) == 2) st2(dob + (size_t)r * LDH + c, v0, v1);
  };
  if (pl.nch == 1) {
    if (kk == 0) cp_async_wait_all();  // the prologue's loads
    __syncthreads();                   // this tile's rows are in; the last tile is done with the panels
    ld.rows(kk + 1);
    const T* xp = ld.xslot(kk);
    panel_mma<false, true>(xp, pl.LDX, ws, LDH, Rp, HD, pl.Cp, epi_q);
    if (bwd) panel_mma<false, true>(xp + (size_t)Rp * pl.LDX, pl.LDX, ws + (size_t)pl.Cp * LDH, LDH, Rp, HD, pl.Cp,
                                    epi_do);
    return;
  }
  // Chunk by chunk into float32 sums: the first chunk stores (each element has one owner thread, the
  // same in every product of this shape), the rest add.
  auto put = [](float* acc, int ld) {
    return [=](int r, int c, float v0, float v1) {
      acc[(size_t)r * ld + c] = v0;
      acc[(size_t)r * ld + c + 1] = v1;
    };
  };
  for (int ch = 0; ch < pl.nch; ++ch) {
    const T* sl = ld.ready_chunk(gi++, bwd);
    const T* wd = sl + pl.wrows;
    if (ch == 0) {
      panel_mma<false, true>(sl, pl.LDX, wd, LDH, Rp, HD, pl.CK, put(qacc, LDA));
      if (bwd) panel_mma<false, true>(sl + (size_t)Rp * pl.LDX, pl.LDX, wd + (size_t)pl.CK * LDH, LDH, Rp, HD, pl.CK,
                                      put(dof, LDA));
    } else {
      panel_mma_add<false, true>(sl, pl.LDX, wd, LDH, Rp, HD, pl.CK, qacc, LDA, Rp, HD);
      if (bwd) panel_mma_add<false, true>(sl + (size_t)Rp * pl.LDX, pl.LDX, wd + (size_t)pl.CK * LDH, LDH, Rp, HD,
                                          pl.CK, dof, LDA, Rp, HD);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Rp * HD / 2; i += blockDim.x) {
    const int r = i / (HD / 2), c = (i - r * (HD / 2)) * 2;
    epi_q(r, c, qacc[(size_t)r * LDA + c], qacc[(size_t)r * LDA + c + 1]);
    if (bwd && sizeof(T) == 2) st2(dob + (size_t)r * LDH + c, dof[(size_t)r * LDA + c], dof[(size_t)r * LDA + c + 1]);
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 2) cross_staged_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ wq,
    const float* __restrict__ bq, const T* __restrict__ wo_t, const float* __restrict__ bo, T* __restrict__ out,
    int tokens, int FL, int FG, int C, int H, int TT, int CK, int NKV, int NW, float scale) {
  constexpr int NB = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const XPlan pl = cross_layout(TT, FL, FG, C, H, DP, sizeof(T), false, CK, 0, NKV, NW);
  const int HD = H * DP, LDH = pl.LDH, LDX = pl.LDX, Rp = pl.Rp;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5, g = lane >> 2, q = lane & 3;
  T* ws = reinterpret_cast<T*>(smem_raw + pl.w);      // resident: W_q (Cp, HD), then W_o^T (Cp, HD)
  T* qo = reinterpret_cast<T*>(smem_raw + pl.qp);     // (Rq, HD) q of the tile, then o over it
  float* qacc = reinterpret_cast<float*>(smem_raw + (sizeof(T) == 4 ? pl.qp : pl.qacc));
  float* scr = reinterpret_cast<float*>(smem_raw + pl.scr) + warp * kXScr;
  const XLoads<T> ld{pl, smem_raw, x, nullptr, k, v, wq, wo_t, tokens, (tokens + TT - 1) / TT, FL, FG, C, HD};
  const int nqb = (FL + 15) / 16;

  for (int i = tid; i < pl.Rq * LDH; i += blockDim.x) qo[i] = from_f<T>(0.f);  // rows past the tile stay finite
  ld.prologue(ws, false);
  int gi = 0, n = 0;
  for (int kk = 0;; ++kk) {
    const int tile = ld.tile(kk);
    if (tile < 0) break;
    const int tok0 = tile * TT, Ti = min(TT, tokens - tok0), R = Ti * FL;
    cross_project(ld, kk, gi, false, ws, qo, qacc, (T*)nullptr, (float*)nullptr, bq, scale);

    for (int t = 0; t < Ti; ++t, ++n) {
      const T* kv = ld.ready_kv(kk, t, Ti, n);
      for (int item = warp; item < H * nqb; item += nw) {
        const int h = item % H, qb = item / H, r0 = t * FL + 16 * qb, nv = min(16, FL - 16 * qb);
        float o[NB][4], m[2], l[2];
        sweep_rows<T, false, DP>(qo + (size_t)r0 * LDH + h * DP, LDH, kv + h * DP, kv + HD + h * DP, pl.LDKV, FG, 0,
                                 nullptr, o, m, l, scr);
        __syncwarp();  // every lane has read the window's q
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (g + 8 * i < nv)
              st2(qo + (size_t)(r0 + g + 8 * i) * LDH + h * DP + 8 * j + 2 * q, o[j][2 * i] / l[i],
                  o[j][2 * i + 1] / l[i]);
      }
    }

    // out = x + round(o W_o + b_o), straight from the fragments; `xr` holds the rows' columns from c0.
    T* ot = out + (size_t)tok0 * FL * C;
    auto epi_out = [=](const T* xr, int c0) {
      return [=](int r, int cl, float v0, float v1) {
        const int c = c0 + cl;
        if (r >= R || c >= C) return;
        const bool both = c + 1 < C;
        const float y0 = to_f(xr[(size_t)r * LDX + cl]) + rnd<T>(v0 + bo[c]);
        const float y1 = both ? to_f(xr[(size_t)r * LDX + cl + 1]) + rnd<T>(v1 + bo[c + 1]) : 0.f;
        put2(ot + (size_t)r * C + c, y0, y1, both);
      };
    };
    if (pl.nch == 1) {
      __syncthreads();  // o of every head
      panel_mma<false, false>(qo, LDH, ws + (size_t)pl.Cp * LDH, LDH, Rp, pl.Cp, HD, epi_out(ld.xslot(kk), 0));
    } else {
      for (int ch = 0; ch < pl.nch; ++ch) {
        const T* sl = ld.ready_chunk(gi++, false);
        panel_mma<false, false>(qo, LDH, sl + pl.wrows, LDH, Rp, pl.CK, HD, epi_out(sl, ch * pl.CK));
      }
    }
  }
  cp_async_wait_all();  // nothing stays in flight when the CTA ends
}

// Backward. `partial` is the CTA's float32 partial: dW_q (C, HD) | db_q (HD) | dW_o (HD, C) | db_o (C).
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1) cross_staged_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ gin, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ wq, const float* __restrict__ bq, const T* __restrict__ wo_t, T* __restrict__ dx,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ partial, int tokens, int FL, int FG, int C, int H,
    int TT, int CK, int NKV, int NW, int part, float scale) {
  constexpr int NB = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const XPlan pl = cross_layout(TT, FL, FG, C, H, DP, sizeof(T), true, CK, part, NKV, NW);
  const int HD = H * DP, LDH = pl.LDH, LDX = pl.LDX, LDF = pl.LDF, LDA = pl.LDA, Rp = pl.Rp, Cp = pl.Cp;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5, gq = lane >> 2, q = lane & 3;
  T* ws = reinterpret_cast<T*>(smem_raw + pl.w);              // resident: W_q (Cp, HD), then W_o^T (Cp, HD)
  T* qp = reinterpret_cast<T*>(smem_raw + pl.qp);             // (Rq, HD) q of the tile; round(dq) over it
  float* dof = reinterpret_cast<float*>(smem_raw + pl.dof);   // (Rd, HD) do, float32
  T* dob = reinterpret_cast<T*>(smem_raw + (sizeof(T) == 4 ? pl.dof : pl.dob));  // (Rq, HD) round(do)
  T* op = reinterpret_cast<T*>(smem_raw + pl.op);             // (Rp, HD) round(o)
  float* qacc = reinterpret_cast<float*>(smem_raw + (sizeof(T) == 4 ? pl.qp : pl.qacc));
  float* lse_s = reinterpret_cast<float*>(smem_raw + pl.st) + warp * 2 * pl.Fq;  // (Fq) lse of the warp's head
  float* di_s = lse_s + pl.Fq;                                                      // (Fq) di
  float* dbq_s = reinterpret_cast<float*>(smem_raw + pl.dbq);  // (HD)
  float* dbo_s = reinterpret_cast<float*>(smem_raw + pl.dbo);  // (Cp)
  float* pwq_s = reinterpret_cast<float*>(smem_raw + pl.pw);   // on chip: dW_q (Cp, LDF), then dW_o (HD, LDPO)
  float* pwo_s = pwq_s + (size_t)Cp * LDF;
  float* scr = reinterpret_cast<float*>(smem_raw + pl.scr) + warp * kXScr;
  const XLoads<T> ld{pl, smem_raw, x, gin, k, v, wq, wo_t, tokens, (tokens + TT - 1) / TT, FL, FG, C, HD};
  const int nqb = (FL + 15) / 16;

  const size_t total = (size_t)C * HD + HD + (size_t)HD * C + C;
  float* pg = partial + (size_t)blockIdx.x * total;
  float* pwo_g = pg + (size_t)C * HD + HD;
  for (int i = tid; i < pl.Rq * LDH; i += blockDim.x) qp[i] = from_f<T>(0.f);
  for (int i = tid; i < pl.Rd * LDA; i += blockDim.x) dof[i] = 0.f;
  if (sizeof(T) == 2)
    for (int i = tid; i < pl.Rq * LDH; i += blockDim.x) dob[i] = from_f<T>(0.f);
  for (int i = tid; i < Rp * LDH; i += blockDim.x) op[i] = from_f<T>(0.f);
  for (int i = tid; i < HD; i += blockDim.x) dbq_s[i] = 0.f;
  for (int i = tid; i < Cp; i += blockDim.x) dbo_s[i] = 0.f;
  if (pl.part)  // else the CTA's first tile writes its partial's weight gradients
    for (size_t i = tid; i < (size_t)Cp * LDF + (size_t)HD * pl.LDPO; i += blockDim.x) pwq_s[i] = 0.f;
  ld.prologue(ws, true);
  int gi = 0, n = 0;
  for (int kk = 0;; ++kk) {
    const int tile = ld.tile(kk);
    if (tile < 0) break;
    const int tok0 = tile * TT, Ti = min(TT, tokens - tok0), R = Ti * FL;
    cross_project(ld, kk, gi, true, ws, qp, qacc, dob, dof, bq, scale);

    for (int t = 0; t < Ti; ++t, ++n) {
      const T* kv = ld.ready_kv(kk, t, Ti, n);
      const size_t tok = (size_t)tok0 + t;
      for (int h = warp; h < H; h += nw) {
        const int hc = h * DP;
        const T* kh = kv + hc;
        const T* vh = kv + HD + hc;
        // Sweep: o, lse and di of every query block; round(o) to op.
        for (int qb = 0; qb < nqb; ++qb) {
          const int r0 = t * FL + 16 * qb, nv = min(16, FL - 16 * qb);
          float o[NB][4], m[2], l[2], dsum[2] = {0.f, 0.f};
          sweep_rows<T, false, DP>(qp + (size_t)r0 * LDH + hc, LDH, kh, vh, pl.LDKV, FG, 0, nullptr, o, m, l, scr);
#pragma unroll
          for (int j = 0; j < NB; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int row = gq + 8 * i, c = hc + 8 * j + 2 * q;
              if (row >= nv) continue;
              const float o0 = o[j][2 * i] / l[i], o1 = o[j][2 * i + 1] / l[i];
              dsum[i] += dof[(size_t)(r0 + row) * LDA + c] * o0 + dof[(size_t)(r0 + row) * LDA + c + 1] * o1;
              st2(op + (size_t)(r0 + row) * LDH + c, o0, o1);
            }
          for (int i = 0; i < 2; ++i) {
            const float di = quad_sum(dsum[i]);
            if (q == 0) {
              lse_s[16 * qb + gq + 8 * i] = m[i] + logf(l[i]);
              di_s[16 * qb + gq + 8 * i] = di;
            }
          }
        }
        __syncwarp();
        // Phase A (key rows, 16 at a time): dv = sum round(P)^T round(do), dk = sum round(dS)^T q; written once.
        for (int k0 = 0; k0 < FG; k0 += 16) {
          float dkf[NB][4], dvf[NB][4];
#pragma unroll
          for (int j = 0; j < NB; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) dkf[j][e] = dvf[j][e] = 0.f;
          for (int qb = 0; qb < nqb; ++qb) {
            const int r0 = t * FL + 16 * qb, nv = min(16, FL - 16 * qb);
            float s[2][4], dp[2][4];
            warp_nt<2>(s, kh + (size_t)k0 * pl.LDKV, pl.LDKV, qp + (size_t)r0 * LDH + hc, LDH, DP);
            warp_nt<2>(dp, vh + (size_t)k0 * pl.LDKV, pl.LDKV, dob + (size_t)r0 * LDH + hc, LDH, DP);
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int key = k0 + gq + 8 * (e >> 1), qc = 8 * j + 2 * q + (e & 1);
                float p = 0.f, ds = 0.f;
                if (key < FG && qc < nv) {
                  p = expf(s[j][e] - lse_s[16 * qb + qc]);
                  ds = p * (dp[j][e] - di_s[16 * qb + qc]);
                }
                s[j][e] = rnd<T>(p);
                dp[j][e] = rnd<T>(ds);
              }
            warp_pv<NB, 2>(dvf, s, dob + (size_t)r0 * LDH + hc, LDH, scr);
            warp_pv<NB, 2>(dkf, dp, qp + (size_t)r0 * LDH + hc, LDH, scr);
          }
          const int key = k0 + gq;
          const size_t at = (tok * FG + key) * HD + hc;
          store_frag_rows<NB>(dk + at, dk + at + 8 * HD, dkf, key < FG, key + 8 < FG);
          store_frag_rows<NB>(dv + at, dv + at + 8 * HD, dvf, key < FG, key + 8 < FG);
        }
        __syncwarp();
        // Phase B (query rows): dq = scale * sum round(dS) k; db_q += its column sums; round(dq) over q.
        for (int qb = 0; qb < nqb; ++qb) {
          const int r0 = t * FL + 16 * qb, nv = min(16, FL - 16 * qb);
          const float lse[2] = {lse_s[16 * qb + gq], lse_s[16 * qb + gq + 8]};
          const float di[2] = {di_s[16 * qb + gq], di_s[16 * qb + gq + 8]};
          float dq[NB][4];
#pragma unroll
          for (int j = 0; j < NB; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
          for (int kb0 = 0; kb0 < FG; kb0 += 32) {
            float s[4][4], dp[4][4];
            warp_nt<4>(s, qp + (size_t)r0 * LDH + hc, LDH, kh + (size_t)kb0 * pl.LDKV, pl.LDKV, DP);
            warp_nt<4>(dp, dob + (size_t)r0 * LDH + hc, LDH, vh + (size_t)kb0 * pl.LDKV, pl.LDKV, DP);
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int row = gq + 8 * (e >> 1), key = kb0 + 8 * j + 2 * q + (e & 1);
                float ds = 0.f;
                if (key < FG && row < nv) ds = expf(s[j][e] - lse[e >> 1]) * (dp[j][e] - di[e >> 1]);
                dp[j][e] = rnd<T>(ds);
              }
            warp_pv<NB, 4>(dq, dp, kh + (size_t)kb0 * pl.LDKV, pl.LDKV, scr);
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
              dbq_s[hc + 8 * j + 2 * lane] += cs[j][0];
              dbq_s[hc + 8 * j + 2 * lane + 1] += cs[j][1];
            }
          __syncwarp();  // every lane has read this block's q
#pragma unroll
          for (int j = 0; j < NB; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i)
              if (gq + 8 * i < nv)
                st2(qp + (size_t)(r0 + gq + 8 * i) * LDH + hc + 8 * j + 2 * q, dq[j][2 * i], dq[j][2 * i + 1]);
        }
      }
    }

    // Over columns [c0, c0 + N) of c, with the tile's rows of x and g from those columns in `xr` and `gr`
    // and W_q's rows from c0 in `wr`: dW_o += round(o)^T g, dW_q += x^T round(dq), db_o += sum g,
    // dx = g + round(dq) W_q^T.
    T* dxt = dx + (size_t)tok0 * FL * C;
    auto products = [&](const T* xr, const T* gr, const T* wr, int c0, int N) {
      const int cw = min(N, C - c0);
      if (pl.part) {
        const int cs = min(N, Cp - c0);
        panel_mma_add<true, true>(op, LDH, gr, LDX, HD, N, Rp, pwo_s + c0, pl.LDPO, HD, cs);
        panel_mma_add<true, true>(xr, LDX, qp, LDH, N, HD, Rp, pwq_s + (size_t)c0 * LDF, LDF, cs, HD);
      } else {
        partial_mma<true, true>(op, LDH, gr, LDX, HD, N, Rp, pwo_g + c0, C, HD, cw, kk == 0);
        partial_mma<true, true>(xr, LDX, qp, LDH, N, HD, Rp, pg + (size_t)c0 * HD, HD, cw, HD, kk == 0);
      }
      for (int cl = tid; cl < cw; cl += blockDim.x) {
        float sum = 0.f;
        for (int r = 0; r < R; ++r) sum += to_f(gr[(size_t)r * LDX + cl]);
        dbo_s[c0 + cl] += sum;
      }
      panel_mma<false, false>(qp, LDH, wr, LDH, Rp, N, HD, [=](int r, int cl, float v0, float v1) {
        const int c = c0 + cl;
        if (r >= R || c >= C) return;
        const bool both = c + 1 < C;
        const float y0 = to_f(gr[(size_t)r * LDX + cl]) + v0;
        const float y1 = both ? to_f(gr[(size_t)r * LDX + cl + 1]) + v1 : 0.f;
        put2(dxt + (size_t)r * C + c, y0, y1, both);
      });
    };
    if (pl.nch == 1) {
      __syncthreads();  // round(o) and round(dq) of every head
      const T* xp = ld.xslot(kk);
      products(xp, xp + (size_t)Rp * LDX, ws, 0, Cp);
    } else {
      for (int ch = 0; ch < pl.nch; ++ch) {
        const T* sl = ld.ready_chunk(gi++, true);
        products(sl, sl + (size_t)Rp * LDX, sl + pl.wrows, ch * pl.CK, pl.CK);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
  // The CTA's partial, written once: the on-chip weight gradients (else already in place), db_q, db_o.
  if (pl.part) {
    for (size_t i = tid; i < (size_t)C * HD; i += blockDim.x) pg[i] = pwq_s[(i / HD) * LDF + i % HD];
    for (size_t i = tid; i < (size_t)HD * C; i += blockDim.x) pwo_g[i] = pwo_s[(i / C) * pl.LDPO + i % C];
  }
  for (int i = tid; i < HD; i += blockDim.x) pg[(size_t)C * HD + i] = dbq_s[i];
  for (int i = tid; i < C; i += blockDim.x) pwo_g[(size_t)HD * C + i] = dbo_s[i];
}

template <typename T>
static int launch_fwd(const void* x, const void* k, const void* v, const void* wq, const void* bq,
                      const void* wo, const void* bo, void* out, void* scratch, int tokens, int fl,
                      int fg, int c, int heads, int dim, int kb, int grid, float scale,
                      cudaStream_t stream) {
  const size_t smem = sizeof(float) * XDims(fl, fg, c, heads, dim, kb).fwd_floats();
  cudaError_t err = cudaFuncSetAttribute(cross_attention_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cross_attention_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(wq), static_cast<const float*>(bq), static_cast<const T*>(wo),
      static_cast<const float*>(bo), static_cast<T*>(out), static_cast<T*>(scratch), tokens, fl,
      fg, c, heads, dim, kb, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_bwd(const void* x, const void* g, const void* k, const void* v, const void* wq,
                      const void* wq_t, const void* bq, const void* wo_t, void* dx, void* dk,
                      void* dv, void* partial, void* grads, void* scratch, int tokens, int fl,
                      int fg, int c, int heads, int dim, int kb, int grid, float scale,
                      cudaStream_t stream) {
  const size_t smem = sizeof(float) * XDims(fl, fg, c, heads, dim, kb).bwd_floats();
  cudaError_t err = cudaFuncSetAttribute(cross_attention_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cross_attention_bwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(wq), static_cast<const T*>(wq_t),
      static_cast<const float*>(bq), static_cast<const T*>(wo_t), static_cast<T*>(dx),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(partial),
      static_cast<T*>(scratch), tokens, fl, fg, c, heads, dim, kb, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t hd = (size_t)heads * dim;
  const size_t total = (size_t)c * hd + hd + hd * c + c;
  return launch_reduce(static_cast<const float*>(partial), grid, total, 1, (int)total,
                       static_cast<float*>(grads), (int)total, stream);
}

template <typename T, int DP>
static int launch_staged_fwd(const XPlan& p, const void* x, const void* k, const void* v, const void* wq,
                             const void* bq, const void* wo_t, const void* bo, void* out, int tokens, int fl,
                             int fg, int c, int heads, int grid, float scale, cudaStream_t stream) {
  auto kernel = cross_staged_fwd_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, p.bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(wq),
      static_cast<const float*>(bq), static_cast<const T*>(wo_t), static_cast<const float*>(bo),
      static_cast<T*>(out), tokens, fl, fg, c, heads, p.TT, p.CK, p.NKV, p.NW, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
static int launch_staged_bwd(const XPlan& p, const void* x, const void* g, const void* k, const void* v,
                             const void* wq, const void* bq, const void* wo_t, void* dx, void* dk, void* dv,
                             void* partial, int tokens, int fl, int fg, int c, int heads, int grid, float scale,
                             cudaStream_t stream) {
  auto kernel = cross_staged_bwd_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, p.bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(wq), static_cast<const float*>(bq), static_cast<const T*>(wo_t), static_cast<T*>(dx),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(partial), tokens, fl, fg, c, heads, p.TT,
      p.CK, p.NKV, p.NW, p.part, scale);
  return (int)cudaGetLastError();
}

}  // namespace vdt

// dtype: 0 = float32, 1 = bfloat16. x (tokens, fl, c); k, v (tokens, fg, heads*dim), all of x's type;
// wq (c, HD), wo (HD, c) and wo_t (c, HD, W_o transposed) of x's type; bq (HD) and bo (c) float32.
// `tile` is the staged kernel's tokens per tile, from which `cross_plan` (ops/cross_attention.py mirrors
// it) lays out the launch; where it fits, the staged kernel runs on `grid` CTAs and `*staged` is set to 1.
// Elsewhere the first design runs on `grid` CTAs, `*staged` is 0 and `scratch` (scratch_size bytes) must
// hold grid * fl * HD elements of x's type. Returns the cudaError_t.
extern "C" int cross_attention_fwd(int dtype, const void* x, const void* k, const void* v,
                                   const void* wq, const void* bq, const void* wo, const void* wo_t,
                                   const void* bo, void* out, void* scratch, size_t scratch_size, int tokens,
                                   int fl, int fg, int c, int heads, int dim, int kb, int tile, int grid,
                                   float scale, void* stream, int* staged) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int elt = dtype == 0 ? 4 : 2;
  vdt::XPlan p;
  if (vdt::cross_plan(tile, fl, fg, c, heads, dim, elt, false, &p)) {
    *staged = 1;
#define VDT_SFWD(T, DP) \
  vdt::launch_staged_fwd<T, DP>(p, x, k, v, wq, bq, wo_t, bo, out, tokens, fl, fg, c, heads, grid, scale, s)
    if (dtype == 0) return dim == 32 ? VDT_SFWD(float, 32) : VDT_SFWD(float, 64);
    return dim == 32 ? VDT_SFWD(__nv_bfloat16, 32) : VDT_SFWD(__nv_bfloat16, 64);
#undef VDT_SFWD
  }
  *staged = 0;
  if ((size_t)grid * fl * heads * dim * elt > scratch_size) return (int)cudaErrorInvalidValue;
#define VDT_FWD(T)                                                                          \
  vdt::launch_fwd<T>(x, k, v, wq, bq, wo, bo, out, scratch, tokens, fl, fg, c, heads, dim, \
                     kb, grid, scale, s)
  if (dtype == 0) return VDT_FWD(float);
  return VDT_FWD(__nv_bfloat16);
#undef VDT_FWD
}

// Backward: dx (tokens, fl, c), dk and dv (tokens, fg, HD), all in x's type; `grads` (float32)
// receives dW_q (c, HD) | db_q (HD) | dW_o (HD, c) | db_o (c), summed over the `grid` CTAs'
// partials in `partial` (grid x that size, float32). The staged kernel reads wq (c, HD) and wo_t
// (c, HD); the first design reads wq, wq_t (HD, c) and wo_t, and `scratch` (scratch_size bytes) must
// hold grid * fl * 2HD elements of x's type for it. `tile` and `*staged` as in the forward.
extern "C" int cross_attention_bwd(int dtype, const void* x, const void* g, const void* k,
                                   const void* v, const void* wq, const void* wq_t, const void* bq,
                                   const void* wo_t, void* dx, void* dk, void* dv, void* partial,
                                   void* grads, void* scratch, size_t scratch_size, int tokens, int fl,
                                   int fg, int c, int heads, int dim, int kb, int tile, int grid,
                                   float scale, void* stream, int* staged) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int elt = dtype == 0 ? 4 : 2;
  vdt::XPlan p;
  int rc;
  if (vdt::cross_plan(tile, fl, fg, c, heads, dim, elt, true, &p)) {
    *staged = 1;
#define VDT_SBWD(T, DP)                                                                                 \
  vdt::launch_staged_bwd<T, DP>(p, x, g, k, v, wq, bq, wo_t, dx, dk, dv, partial, tokens, fl, fg, c, heads, \
                                grid, scale, s)
    if (dtype == 0) rc = dim == 32 ? VDT_SBWD(float, 32) : VDT_SBWD(float, 64);
    else rc = dim == 32 ? VDT_SBWD(__nv_bfloat16, 32) : VDT_SBWD(__nv_bfloat16, 64);
#undef VDT_SBWD
    if (rc != 0) return rc;
    const size_t hd = (size_t)heads * dim;
    const size_t total = (size_t)c * hd + hd + hd * c + c;
    return vdt::launch_reduce(static_cast<const float*>(partial), grid, total, 1, (int)total,
                              static_cast<float*>(grads), (int)total, s);
  }
  *staged = 0;
  if (!wq_t || (size_t)grid * fl * 2 * heads * dim * elt > scratch_size) return (int)cudaErrorInvalidValue;
#define VDT_BWD(T)                                                                             \
  vdt::launch_bwd<T>(x, g, k, v, wq, wq_t, bq, wo_t, dx, dk, dv, partial, grads, scratch,     \
                     tokens, fl, fg, c, heads, dim, kb, grid, scale, s)
  if (dtype == 0) return VDT_BWD(float);
  return VDT_BWD(__nv_bfloat16);
#undef VDT_BWD
}
