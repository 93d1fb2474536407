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
// an online softmax over KV blocks in float32 whose p = exp(s - m) is rounded
// to x's type before the p V product while l sums the unrounded p; o_h =
// round(acc / l); out = x + round(sum_h o_h W_o,h + b_o), the sum over heads
// in float32. The backward rebuilds p = exp(s - lse) from lse = m + log l,
// takes di = rowsum(do * o_h) from the unrounded do and o_h, rounds p, do, ds
// and dq to x's type before each product, sums db_q from the unrounded dq,
// and keeps every weight gradient in float32.
//
// Design: temporal_blockwise.cu's. One CTA owns one token column at a time (a
// persistent grid walks the tokens) and loops over the heads; shared memory
// holds per-head panels whose size follows f_l, the KV block and D, never c:
// q, the accumulator, one K|V block, one score block and the row statistics
// (the backward adds do, dk|dv and a second score block). x and g are read
// from device memory where a product needs them, so any c works. Across heads
// the CTA keeps the rounded o_h (and, in the backward, the rounded dq) in a
// scratch column of its own in device memory; the output projection, dx, dW_q
// and dW_o are then single products over all heads. The differences from the
// blockwise kernels: K and V are inputs, read straight from their packed rows
// (the TPU's head-major transpose is dropped), not projected in the kernel;
// and dK and dV are outputs: a token column owns its own, so each block of
// them is written once, in x's type, from float32. The TPU pads f to 8
// sublanes, masks padded keys with -1e9 and caps its KV block; here the
// ragged last block is a loop bound, so the kernels take any f_g. Every
// product runs through `mm` (common.cuh) on the CUDA cores in float32.
//
// Weight gradients cross CTAs as in the other backward kernels: each CTA adds
// into its own float32 partial and `reduce_partials_kernel` sums the partials
// in block order, so results are bit-equal from run to run. No atomics.
//
// Bound on this card. Per query row the function needs 4*c*H*D + 4*f_g*H*D
// FLOPs forward and 8*c*H*D + 8*f_g*H*D backward (dW_q, dx, dW_o, do; dv, dp,
// dq, dk), against c elements of x (and of g and dx) moved per row plus the
// K|V rows: for the sequence-parallel recipe the bf16 tensor-core rate is the
// bound. The backward also recomputes q and the logits (4*c*H*D + 2*f_g*H*D
// more): overhead of the design, not part of the bound.

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

}  // namespace vdt

// dtype: 0 = float32, 1 = bfloat16. x (tokens, fl, c); k, v (tokens, fg, heads*dim), all of
// x's type; wq (c, HD) and wo (HD, c) of x's type; bq (HD) and bo (c) float32. `grid` CTAs walk
// the tokens; `scratch` holds grid * fl * HD elements of x's type. Returns the cudaError_t.
extern "C" int cross_attention_fwd(int dtype, const void* x, const void* k, const void* v,
                                   const void* wq, const void* bq, const void* wo, const void* bo,
                                   void* out, void* scratch, int tokens, int fl, int fg, int c,
                                   int heads, int dim, int kb, int grid, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VDT_FWD(T)                                                                          \
  vdt::launch_fwd<T>(x, k, v, wq, bq, wo, bo, out, scratch, tokens, fl, fg, c, heads, dim, \
                     kb, grid, scale, s)
  if (dtype == 0) return VDT_FWD(float);
  if (dtype == 1) return VDT_FWD(__nv_bfloat16);
#undef VDT_FWD
  return (int)cudaErrorInvalidValue;
}

// Backward: dx (tokens, fl, c), dk and dv (tokens, fg, HD), all in x's type; `grads` (float32)
// receives dW_q (c, HD) | db_q (HD) | dW_o (HD, c) | db_o (c), summed over the `grid` CTAs'
// partials in `partial` (grid x that size, float32). `wq_t` (HD, c) and `wo_t` (c, HD) are the
// transposed weights. `scratch` holds grid * fl * 2HD elements of x's type.
extern "C" int cross_attention_bwd(int dtype, const void* x, const void* g, const void* k,
                                   const void* v, const void* wq, const void* wq_t, const void* bq,
                                   const void* wo_t, void* dx, void* dk, void* dv, void* partial,
                                   void* grads, void* scratch, int tokens, int fl, int fg, int c,
                                   int heads, int dim, int kb, int grid, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VDT_BWD(T)                                                                             \
  vdt::launch_bwd<T>(x, g, k, v, wq, wq_t, bq, wo_t, dx, dk, dv, partial, grads, scratch,     \
                     tokens, fl, fg, c, heads, dim, kb, grid, scale, s)
  if (dtype == 0) return VDT_BWD(float);
  if (dtype == 1) return VDT_BWD(__nv_bfloat16);
#undef VDT_BWD
  return (int)cudaErrorInvalidValue;
}
