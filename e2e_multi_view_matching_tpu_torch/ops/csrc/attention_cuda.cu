// Fused view-structured attention for Hopper (sm_90a), FP32 on the CUDA cores.
//
// Replaces five Pallas TPU kernels of e2e_multi_view_matching_tpu/ops/attention_pallas.py:
//   attn_fwd           <- _attn_kernel       (one-shot masked softmax attention, mask
//                                              "full" | "self" | "cross" built from
//                                              token indices, -1e9 fill)
//   cross_attn_fwd     <- _cross_attn_kernel (online softmax over the other V-1 views'
//                                              keys; the own view's keys are never read)
//   cross_attn_fwd_lse <- _cross_attn_lse_kernel (the same, also storing the per-row
//                                              LSE = m + log(l + 1e-9) for the backward)
//   cross_attn_bwd_dq  <- _cross_attn_bwd_dq_kernel  (dq over the other views' keys)
//   cross_attn_bwd_dkv <- _cross_attn_bwd_dkv_kernel (dk, dv over the other views' queries)
//
// Layout: q, k, v, o, dout, dq, dk, dv are (BH, S, DH) contiguous float32, heads
// already split; lse and dvec are (BH, S) float32.
//
// What bounds it on an H100: arithmetic. Per (query, key) pair the forward does
// 2*DH FMAs (QK^T and PV) and one expf, the dq kernel 3*DH FMAs (QK^T, dO V^T,
// dS K) and the dk/dv kernel 4*DH (QK^T, dO V^T, P^T dO, dS^T Q), against 67
// TFLOP/s of FP32 (no tensor cores: TF32 is not f32). Device-memory traffic is
// small: each block streams its key (or query) range once from L2.
//
// Design. The TPU kernels keep one head's whole K and V (or one view's keys,
// for dk/dv) resident in VMEM and compute a (tile, keys) block at once; here
// the streamed operand goes through shared memory in tiles of 32 rows, and a
// loop inside the block takes the place of the TPU's sequential grid axis.
//   Forward: one thread owns one query row; q and the accumulator live in
//   registers, every key row is a warp-wide float4 broadcast from shared
//   memory, and the softmax is online (running max m from -1e9, running sum l,
//   rescaled accumulator), as in the TPU cross kernel. Output acc / (l + 1e-9).
//   Backward: two threads own one row and each holds half of the head dims in
//   the interleaved float4 order 2x + half, so the pair's two shared-memory
//   reads fall in different banks; the two halves of each dot product meet in
//   one __shfl_xor_sync (both threads then hold the same bits). p = exp(s -
//   lse) is rebuilt from the stashed LSE with no rescaling. dq keeps the BC
//   key rows of its dot products in registers for the update (254 registers,
//   no spills at DH = 64). dk/dv holds twice as much per thread (k, v, dk, dv:
//   128 floats at DH = 64), and keeping its rows too took 255 registers and
//   1.3 KB of spills per thread (15.5 ms at the training shape); so its update
//   rereads the rows from shared memory with volatile loads, which ptxas may
//   not merge with the earlier ones. In dk/dv each block owns its key rows and
//   sums over every query row of the other views itself: no atomics, the same
//   bits on every run.
//   Cross kernels tile each view separately: ceil(n_kpts / rows) tiles per
//   view, the last one ragged, so no tile straddles two views and any n_kpts
//   works (K = 400: 7 tiles of 64, the last with 16 live rows). Rows past the
//   view's end load zeros, take weight exactly 0, and store nothing.
//
// Plain versions: ops/attention.py::multi_head_attention with the same mask,
// and ops/attention_cuda.py::cross_attn_fwd_lse_plain / cross_attn_bwd_plain.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;   // forward: query rows per block, one thread per row
constexpr int BK = 32;   // forward: keys per shared-memory tile
constexpr int CH = 16;   // forward: keys per online-softmax step (register array)
constexpr int BR = 64;   // backward: owned rows per block, two threads per row
constexpr int BT = 32;   // backward: streamed rows per shared-memory tile
constexpr int BC = 4;    // backward: streamed rows per inner step
constexpr float kNegInf = -1e9f;

enum Mode { kFull = 0, kSelf = 1, kCross = 2 };

// Online-softmax pass over keys [key_lo, key_hi) of one (batch*head) slice.
template <int DH, int MODE>
__device__ __forceinline__ void attend_keys(
    const float* __restrict__ kb, const float* __restrict__ vb, int key_lo,
    int key_hi, int qrow, int n_kpts, float scale, const float (&q)[DH],
    float (&acc)[DH], float& m, float& l, float* __restrict__ ks,
    float* __restrict__ vs) {
  for (int t0 = key_lo; t0 < key_hi; t0 += BK) {
    const int nk = min(BK, key_hi - t0);
    __syncthreads();  // the previous tile has been consumed
    constexpr int n4 = BK * DH / 4;
    const float4* k4 = reinterpret_cast<const float4*>(kb + (size_t)t0 * DH);
    const float4* v4 = reinterpret_cast<const float4*>(vb + (size_t)t0 * DH);
    for (int i = threadIdx.x; i < n4; i += BQ) {
      const int row = (i * 4) / DH;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kk;
      if (row < nk) {
        kk = k4[i];
        vv = v4[i];
      }
      reinterpret_cast<float4*>(ks)[i] = kk;
      reinterpret_cast<float4*>(vs)[i] = vv;
    }
    __syncthreads();

#pragma unroll 1
    for (int c0 = 0; c0 < nk; c0 += CH) {
      float s[CH];
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const float4* kr = reinterpret_cast<const float4*>(ks + (c0 + j) * DH);
        float d = 0.f;
#pragma unroll
        for (int x = 0; x < DH / 4; ++x) {
          const float4 kk = kr[x];
          d = fmaf(q[4 * x + 0], kk.x, d);
          d = fmaf(q[4 * x + 1], kk.y, d);
          d = fmaf(q[4 * x + 2], kk.z, d);
          d = fmaf(q[4 * x + 3], kk.w, d);
        }
        d *= scale;
        const int key = t0 + c0 + j;
        if (MODE != kFull) {
          const bool same = (qrow / n_kpts) == (key / n_kpts);
          const bool allow = (MODE == kSelf) ? same : !same;
          if (!allow) d = kNegInf;
        }
        // past the ragged end of the key range: weight exactly 0
        if (c0 + j >= nk) d = -INFINITY;
        s[j] = d;
      }
      float cmax = s[0];
#pragma unroll
      for (int j = 1; j < CH; ++j) cmax = fmaxf(cmax, s[j]);
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        s[j] = expf(s[j] - m_new);
        psum += s[j];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int x = 0; x < DH; ++x) acc[x] *= alpha;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const float4* vr = reinterpret_cast<const float4*>(vs + (c0 + j) * DH);
        const float p = s[j];
#pragma unroll
        for (int x = 0; x < DH / 4; ++x) {
          const float4 vv = vr[x];
          acc[4 * x + 0] = fmaf(p, vv.x, acc[4 * x + 0]);
          acc[4 * x + 1] = fmaf(p, vv.y, acc[4 * x + 1]);
          acc[4 * x + 2] = fmaf(p, vv.z, acc[4 * x + 2]);
          acc[4 * x + 3] = fmaf(p, vv.w, acc[4 * x + 3]);
        }
      }
      m = m_new;
    }
  }
}

template <int DH>
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         bool valid, float (&r)[DH]) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int x = 0; x < DH / 4; ++x) {
    const float4 t = valid ? s4[x] : make_float4(0.f, 0.f, 0.f, 0.f);
    r[4 * x + 0] = t.x;
    r[4 * x + 1] = t.y;
    r[4 * x + 2] = t.z;
    r[4 * x + 3] = t.w;
  }
}

template <int DH>
__device__ __forceinline__ void store_row(float* __restrict__ dst,
                                          const float (&acc)[DH], float l) {
  const float inv = 1.f / (l + 1e-9f);
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int x = 0; x < DH / 4; ++x)
    d4[x] = make_float4(acc[4 * x + 0] * inv, acc[4 * x + 1] * inv,
                        acc[4 * x + 2] * inv, acc[4 * x + 3] * inv);
}

// grid (ceil(S / BQ), BH): every query attends all S keys under the mask.
template <int DH, int MODE>
__global__ void __launch_bounds__(BQ)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int S,
                int n_kpts, float scale) {
  __shared__ __align__(16) float ks[BK * DH];
  __shared__ __align__(16) float vs[BK * DH];
  const size_t base = (size_t)blockIdx.y * S * DH;
  const int qrow = blockIdx.x * BQ + threadIdx.x;
  const bool valid = qrow < S;
  float qr[DH], acc[DH];
  load_row<DH>(q + base + (size_t)qrow * DH, valid, qr);
#pragma unroll
  for (int x = 0; x < DH; ++x) acc[x] = 0.f;
  float m = kNegInf, l = 0.f;
  attend_keys<DH, MODE>(k + base, v + base, 0, S, qrow, n_kpts, scale, qr,
                        acc, m, l, ks, vs);
  if (valid) store_row<DH>(o + base + (size_t)qrow * DH, acc, l);
}

// grid (n_views * tiles, BH) with tiles = ceil(n_kpts / BQ) query tiles per
// view. The in-block loop over w replaces the TPU kernel's sequential grid
// axis; key view w + (w >= qv) skips the query's own view. With LSE, also
// store m + log(l + 1e-9) per row (the TPU kernel's 128-lane broadcast of it
// is a Mosaic layout rule).
template <int DH, bool LSE>
__global__ void __launch_bounds__(BQ)
cross_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int S, int n_views, int n_kpts,
                      int tiles, float scale) {
  __shared__ __align__(16) float ks[BK * DH];
  __shared__ __align__(16) float vs[BK * DH];
  const size_t base = (size_t)blockIdx.y * S * DH;
  const int qv = blockIdx.x / tiles;
  const int r = (blockIdx.x % tiles) * BQ + threadIdx.x;  // row within the view
  const bool valid = r < n_kpts;
  const int qrow = qv * n_kpts + r;
  float qr[DH], acc[DH];
  load_row<DH>(q + base + (size_t)qrow * DH, valid, qr);
#pragma unroll
  for (int x = 0; x < DH; ++x) acc[x] = 0.f;
  float m = kNegInf, l = 0.f;
  for (int w = 0; w < n_views - 1; ++w) {
    const int kv = w + (w >= qv ? 1 : 0);
    attend_keys<DH, kFull>(k + base, v + base, kv * n_kpts, (kv + 1) * n_kpts,
                           qrow, n_kpts, scale, qr, acc, m, l, ks, vs);
  }
  if (valid) {
    store_row<DH>(o + base + (size_t)qrow * DH, acc, l);
    if (LSE) lse[(size_t)blockIdx.y * S + qrow] = m + logf(l + 1e-9f);
  }
}

// ---- backward: two threads per owned row, half of the head dims each ----

// This thread's half of a row: float4 number 2x + half, x < DH / 8.
template <int DH>
__device__ __forceinline__ void load_half(const float* __restrict__ src, int half,
                                          bool valid, float (&r)[DH / 2]) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int x = 0; x < DH / 8; ++x) {
    const float4 t = valid ? s4[2 * x + half] : make_float4(0.f, 0.f, 0.f, 0.f);
    r[4 * x + 0] = t.x;
    r[4 * x + 1] = t.y;
    r[4 * x + 2] = t.z;
    r[4 * x + 3] = t.w;
  }
}

template <int DH>
__device__ __forceinline__ void store_half(float* __restrict__ dst, int half,
                                           const float (&r)[DH / 2], float mul) {
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int x = 0; x < DH / 8; ++x)
    d4[2 * x + half] = make_float4(r[4 * x + 0] * mul, r[4 * x + 1] * mul,
                                   r[4 * x + 2] * mul, r[4 * x + 3] * mul);
}

// This thread's half of the dot product of `a` with shared-memory row `row`.
template <int DH>
__device__ __forceinline__ float dot_half(const float (&a)[DH / 2],
                                          const float* __restrict__ row, int half) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float d = 0.f;
#pragma unroll
  for (int x = 0; x < DH / 8; ++x) {
    const float4 t = r4[2 * x + half];
    d = fmaf(a[4 * x + 0], t.x, d);
    d = fmaf(a[4 * x + 1], t.y, d);
    d = fmaf(a[4 * x + 2], t.z, d);
    d = fmaf(a[4 * x + 3], t.w, d);
  }
  return d;
}

// A float4 of shared memory read anew: a volatile load is never merged with
// an earlier load of the same address, so the row need not stay in registers.
__device__ __forceinline__ float4 lds_fresh(const float4* p) {
  float4 r;
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
               : "r"(a));
  return r;
}

// acc += c * (this thread's half of shared-memory row `row`); FRESH rereads
// the row with volatile loads.
template <int DH, bool FRESH>
__device__ __forceinline__ void axpy_half(float (&acc)[DH / 2], float c,
                                          const float* __restrict__ row, int half) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int x = 0; x < DH / 8; ++x) {
    const float4 t = FRESH ? lds_fresh(r4 + 2 * x + half) : r4[2 * x + half];
    acc[4 * x + 0] = fmaf(c, t.x, acc[4 * x + 0]);
    acc[4 * x + 1] = fmaf(c, t.y, acc[4 * x + 1]);
    acc[4 * x + 2] = fmaf(c, t.z, acc[4 * x + 2]);
    acc[4 * x + 3] = fmaf(c, t.w, acc[4 * x + 3]);
  }
}

// Rows [t0, t0 + n) of a and b into shared tiles of BT rows, zeros past n.
template <int DH>
__device__ __forceinline__ void load_tile_pair(const float* __restrict__ a,
                                               const float* __restrict__ b, int t0,
                                               int n, float* __restrict__ as,
                                               float* __restrict__ bs) {
  constexpr int n4 = BT * DH / 4;
  const float4* a4 = reinterpret_cast<const float4*>(a + (size_t)t0 * DH);
  const float4* b4 = reinterpret_cast<const float4*>(b + (size_t)t0 * DH);
  for (int i = threadIdx.x; i < n4; i += 2 * BR) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 y = x;
    if ((i * 4) / DH < n) {
      x = a4[i];
      y = b4[i];
    }
    reinterpret_cast<float4*>(as)[i] = x;
    reinterpret_cast<float4*>(bs)[i] = y;
  }
}

// dq: grid (n_views * tiles, BH), tiles = ceil(n_kpts / BR). The owned query
// rows stream the K and V tiles of the other views:
//   dq_i = scale * sum_j p_ij (dp_ij - dvec_i) k_j, p = exp(s - lse_i), dp = dO_i . v_j
template <int DH>
__global__ void __launch_bounds__(2 * BR)
cross_attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dvec,
                         float* __restrict__ dq, int S, int n_views, int n_kpts,
                         int tiles, float scale) {
  constexpr int HD = DH / 2;
  __shared__ __align__(16) float ks[BT * DH];
  __shared__ __align__(16) float vs[BT * DH];
  const int half = threadIdx.x & 1;
  const size_t base = (size_t)blockIdx.y * S * DH;
  const int qv = blockIdx.x / tiles;
  const int r = (blockIdx.x % tiles) * BR + (threadIdx.x >> 1);
  const bool valid = r < n_kpts;
  const int qrow = qv * n_kpts + r;
  float qh[HD], doh[HD], acc[HD];
  load_half<DH>(q + base + (size_t)qrow * DH, half, valid, qh);
  load_half<DH>(dout + base + (size_t)qrow * DH, half, valid, doh);
  const float lse_i = valid ? lse[(size_t)blockIdx.y * S + qrow] : 0.f;
  const float dvec_i = valid ? dvec[(size_t)blockIdx.y * S + qrow] : 0.f;
#pragma unroll
  for (int x = 0; x < HD; ++x) acc[x] = 0.f;
  for (int w = 0; w < n_views - 1; ++w) {
    const int kv = w + (w >= qv ? 1 : 0);
    const int hi = (kv + 1) * n_kpts;
    for (int t0 = kv * n_kpts; t0 < hi; t0 += BT) {
      const int nk = min(BT, hi - t0);
      __syncthreads();  // the previous tile has been consumed
      load_tile_pair<DH>(k + base, v + base, t0, nk, ks, vs);
      __syncthreads();
#pragma unroll 1
      for (int c0 = 0; c0 < nk; c0 += BC) {
        float s[BC], dp[BC];
#pragma unroll
        for (int j = 0; j < BC; ++j) {
          s[j] = dot_half<DH>(qh, ks + (c0 + j) * DH, half);
          dp[j] = dot_half<DH>(doh, vs + (c0 + j) * DH, half);
        }
#pragma unroll
        for (int j = 0; j < BC; ++j) {
          s[j] += __shfl_xor_sync(0xffffffffu, s[j], 1);
          dp[j] += __shfl_xor_sync(0xffffffffu, dp[j], 1);
        }
#pragma unroll
        for (int j = 0; j < BC; ++j) {
          // a key past the ragged end weighs exactly 0
          const float p = (c0 + j < nk) ? expf(s[j] * scale - lse_i) : 0.f;
          axpy_half<DH, false>(acc, p * (dp[j] - dvec_i), ks + (c0 + j) * DH, half);
        }
      }
    }
  }
  if (valid) store_half<DH>(dq + base + (size_t)qrow * DH, half, acc, scale);
}

// dk, dv: grid (n_views * tiles, BH). The block owns key rows of view kv and
// streams q, dO, lse and dvec of every query row of the other views:
//   dv_j = sum_i p_ij dO_i,  dk_j = scale * sum_i p_ij (dp_ij - dvec_i) q_i
template <int DH>
__global__ void __launch_bounds__(2 * BR)
cross_attn_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dvec,
                          float* __restrict__ dk, float* __restrict__ dv, int S,
                          int n_views, int n_kpts, int tiles, float scale) {
  constexpr int HD = DH / 2;
  __shared__ __align__(16) float qs[BT * DH];
  __shared__ __align__(16) float dos[BT * DH];
  __shared__ float ls[BT];
  __shared__ float dvs[BT];
  const int half = threadIdx.x & 1;
  const size_t base = (size_t)blockIdx.y * S * DH;
  const size_t rbase = (size_t)blockIdx.y * S;
  const int kv = blockIdx.x / tiles;
  const int r = (blockIdx.x % tiles) * BR + (threadIdx.x >> 1);
  const bool valid = r < n_kpts;
  const int krow = kv * n_kpts + r;
  float kh[HD], vh[HD], dkh[HD], dvh[HD];
  load_half<DH>(k + base + (size_t)krow * DH, half, valid, kh);
  load_half<DH>(v + base + (size_t)krow * DH, half, valid, vh);
#pragma unroll
  for (int x = 0; x < HD; ++x) {
    dkh[x] = 0.f;
    dvh[x] = 0.f;
  }
  for (int u = 0; u < n_views - 1; ++u) {
    const int qv = u + (u >= kv ? 1 : 0);
    const int hi = (qv + 1) * n_kpts;
    for (int t0 = qv * n_kpts; t0 < hi; t0 += BT) {
      const int nq = min(BT, hi - t0);
      __syncthreads();  // the previous tile has been consumed
      load_tile_pair<DH>(q + base, dout + base, t0, nq, qs, dos);
      if (threadIdx.x < BT) {
        const bool in = threadIdx.x < nq;
        ls[threadIdx.x] = in ? lse[rbase + t0 + threadIdx.x] : 0.f;
        dvs[threadIdx.x] = in ? dvec[rbase + t0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
#pragma unroll 1
      for (int c0 = 0; c0 < nq; c0 += BC) {
        float s[BC], dp[BC];
#pragma unroll
        for (int j = 0; j < BC; ++j) {
          s[j] = dot_half<DH>(kh, qs + (c0 + j) * DH, half);
          dp[j] = dot_half<DH>(vh, dos + (c0 + j) * DH, half);
        }
#pragma unroll
        for (int j = 0; j < BC; ++j) {
          s[j] += __shfl_xor_sync(0xffffffffu, s[j], 1);
          dp[j] += __shfl_xor_sync(0xffffffffu, dp[j], 1);
        }
#pragma unroll
        for (int j = 0; j < BC; ++j) {
          // a query row past the ragged end weighs exactly 0
          const float p = (c0 + j < nq) ? expf(s[j] * scale - ls[c0 + j]) : 0.f;
          axpy_half<DH, true>(dvh, p, dos + (c0 + j) * DH, half);
          axpy_half<DH, true>(dkh, p * (dp[j] - dvs[c0 + j]), qs + (c0 + j) * DH, half);
        }
      }
    }
  }
  if (valid) {
    store_half<DH>(dk + base + (size_t)krow * DH, half, dkh, scale);
    store_half<DH>(dv + base + (size_t)krow * DH, half, dvh, 1.f);
  }
}

template <int DH>
void launch_attn(const float* q, const float* k, const float* v, float* o,
                 int BH, int S, int n_kpts, int mode, float scale,
                 cudaStream_t st) {
  const dim3 grid((S + BQ - 1) / BQ, BH);
  if (mode == kFull)
    attn_fwd_kernel<DH, kFull><<<grid, BQ, 0, st>>>(q, k, v, o, S, n_kpts, scale);
  else if (mode == kSelf)
    attn_fwd_kernel<DH, kSelf><<<grid, BQ, 0, st>>>(q, k, v, o, S, n_kpts, scale);
  else
    attn_fwd_kernel<DH, kCross><<<grid, BQ, 0, st>>>(q, k, v, o, S, n_kpts, scale);
}

bool cross_shape_ok(int BH, int S, int n_views, int n_kpts) {
  return BH >= 1 && BH <= 65535 && n_views >= 2 && n_kpts >= 1 &&
         S == n_views * n_kpts;
}

int launch_cross_fwd(const float* q, const float* k, const float* v, float* o,
                     float* lse, int BH, int S, int dh, int n_views, int n_kpts,
                     float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!cross_shape_ok(BH, S, n_views, n_kpts)) return -1;
  const int tiles = (n_kpts + BQ - 1) / BQ;
  const dim3 grid(n_views * tiles, BH);
#define CROSS_FWD(D)                                                          \
  if (lse)                                                                    \
    cross_attn_fwd_kernel<D, true><<<grid, BQ, 0, st>>>(q, k, v, o, lse, S,   \
                                                        n_views, n_kpts,      \
                                                        tiles, scale);        \
  else                                                                        \
    cross_attn_fwd_kernel<D, false><<<grid, BQ, 0, st>>>(q, k, v, o, nullptr, \
                                                         S, n_views, n_kpts,  \
                                                         tiles, scale);
  switch (dh) {
    case 16: CROSS_FWD(16) break;
    case 32: CROSS_FWD(32) break;
    case 64: CROSS_FWD(64) break;
    default: return -1;
  }
#undef CROSS_FWD
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns 0 on success, -1 for an unsupported head width, mode or shape,
// otherwise the cudaGetLastError() code of the launch.
int attn_fwd(const float* q, const float* k, const float* v, float* o, int BH,
             int S, int dh, int n_kpts, int mode, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode < 0 || mode > 2) return -1;
  switch (dh) {
    case 16: launch_attn<16>(q, k, v, o, BH, S, n_kpts, mode, scale, st); break;
    case 32: launch_attn<32>(q, k, v, o, BH, S, n_kpts, mode, scale, st); break;
    case 64: launch_attn<64>(q, k, v, o, BH, S, n_kpts, mode, scale, st); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

int cross_attn_fwd(const float* q, const float* k, const float* v, float* o,
                   int BH, int S, int dh, int n_views, int n_kpts, float scale,
                   void* stream) {
  return launch_cross_fwd(q, k, v, o, nullptr, BH, S, dh, n_views, n_kpts, scale,
                          stream);
}

int cross_attn_fwd_lse(const float* q, const float* k, const float* v, float* o,
                       float* lse, int BH, int S, int dh, int n_views, int n_kpts,
                       float scale, void* stream) {
  return launch_cross_fwd(q, k, v, o, lse, BH, S, dh, n_views, n_kpts, scale,
                          stream);
}

int cross_attn_bwd_dq(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse, const float* dvec,
                      float* dq, int BH, int S, int dh, int n_views, int n_kpts,
                      float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!cross_shape_ok(BH, S, n_views, n_kpts)) return -1;
  const int tiles = (n_kpts + BR - 1) / BR;
  const dim3 grid(n_views * tiles, BH);
  switch (dh) {
    case 16: cross_attn_bwd_dq_kernel<16><<<grid, 2 * BR, 0, st>>>(q, k, v, dout, lse, dvec, dq, S, n_views, n_kpts, tiles, scale); break;
    case 32: cross_attn_bwd_dq_kernel<32><<<grid, 2 * BR, 0, st>>>(q, k, v, dout, lse, dvec, dq, S, n_views, n_kpts, tiles, scale); break;
    case 64: cross_attn_bwd_dq_kernel<64><<<grid, 2 * BR, 0, st>>>(q, k, v, dout, lse, dvec, dq, S, n_views, n_kpts, tiles, scale); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

int cross_attn_bwd_dkv(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse, const float* dvec,
                       float* dk, float* dv, int BH, int S, int dh, int n_views,
                       int n_kpts, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!cross_shape_ok(BH, S, n_views, n_kpts)) return -1;
  const int tiles = (n_kpts + BR - 1) / BR;
  const dim3 grid(n_views * tiles, BH);
  switch (dh) {
    case 16: cross_attn_bwd_dkv_kernel<16><<<grid, 2 * BR, 0, st>>>(q, k, v, dout, lse, dvec, dk, dv, S, n_views, n_kpts, tiles, scale); break;
    case 32: cross_attn_bwd_dkv_kernel<32><<<grid, 2 * BR, 0, st>>>(q, k, v, dout, lse, dvec, dk, dv, S, n_views, n_kpts, tiles, scale); break;
    case 64: cross_attn_bwd_dkv_kernel<64><<<grid, 2 * BR, 0, st>>>(q, k, v, dout, lse, dvec, dk, dv, S, n_views, n_kpts, tiles, scale); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
