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
// 2*DH FMAs (QK^T and PV) and one exp2f, the dq kernel 3*DH FMAs (QK^T, dO V^T,
// dS K) and the dk/dv kernel 4*DH (K Q^T, V dO^T, P^T dO, dS^T Q), against 67
// TFLOP/s of FP32 (no tensor cores: TF32 is not f32). Device-memory traffic is
// small: each block streams its key (or query) range once from L2. All five
// kernels are register-tiled alike, so that FFMA issue, not the shared-memory
// pipe, is what they wait on.

// Forward design (attn_fwd, cross_attn_fwd, cross_attn_fwd_lse: one body,
// fwd_tile). What bounds it is FFMA issue. Each FFMA needs both operands in
// registers; a kernel that broadcasts one shared-memory float4 per 4 FMAs (one
// thread per query row) runs at the shared-memory issue limit instead. So the
// block is register-tiled like a GEMM: 4 warps own 80 query rows, each thread
// a 5-row x 8-key micro-tile of S = QK^T (keys tx + 8i of each 64-key tile,
// tx = lane % 8) and a 5-row x DH/8-column tile of O. Per float4 step over the
// head dimension a thread loads 5 q and 8 k float4s for 160 FMAs (12.3 FMAs per
// LDS.128). P goes through a per-warp block of shared memory, and O += PV
// reads 2 P words and DH/32 V float4s per key for 5 * DH/8 FMAs.
//   The online softmax runs once per 64-key tile, in base 2: exp2f with
// log2(e) folded into the scale (the LSE stays within 1e-5 of the plain
// version). Row maxima meet across the 8 lanes of a row in three
// __shfl_xor_sync, O is rescaled once per tile, and each thread keeps its own
// part of the row sum l until the end (the lanes of a row share m, so the
// parts rescale alike). Constants as in the TPU kernels, carried to base 2: m
// starts at -1e9 and masked scores are -1e9 (both times log2(e)), keys past
// the end of the range weigh exactly 0 (-INFINITY, tested on the last tile
// only), O = acc / (l + 1e-9), LSE = m ln(2) + logf(l + 1e-9). exp2f and logf
// are the accurate library functions (no --use_fast_math). No atomics: the
// same bits on every run.
//   Registers: 168 at DH = 64, no spills. Three blocks of 4 warps put 3 warps
// on each SM sub-partition, whose 16K registers allow 170 each (5 warps of
// 4-row tiles would put 4 there and allow 128, which spilled).
//   Shared memory: Q in groups of 5 rows (+8 floats per group, so the 4 groups
// a warp reads at once fall in different banks), K rows padded by 4 floats (8
// consecutive keys in 8 bank groups), V unpadded (a warp reads one row), P
// 4 x 5 KB: 73.5 KB at DH = 64, dynamic, 3 blocks (12 warps) per SM. Copies
// are cp.async (16 B, zero-filled past the end; each thread one 16-byte
// column of every RPP-th row) into one K and one V buffer, with two barriers
// per tile: V(t) lands while QK^T(t) runs and K(t+1) while PV(t) runs.
//   Tiles: 80 = 400 / 5 query rows, so K = 400 wastes no row and K = 1024 16
// of 1040. Cross kernels keep every query tile inside one view and walk the
// other views' keys as one virtual range of (V-1)*K keys with the own view
// cut out (1600 keys = 25 full tiles at K = 400). In attn_fwd's self and
// cross modes each thread computes its 5 rows' views once and its 8 keys'
// views once per tile. Warps whose rows all lie past the end skip the
// arithmetic and keep only the copies and barriers.
//
// Backward design (cross_attn_bwd_dq, cross_attn_bwd_dkv: two kernels, as in
// the TPU package, each recomputing S and dP; each block owns its outputs, so
// there are no atomics and every run gives the same bits). Both take the
// forward's block: 4 warps own 80 rows of one view (K = 400 wastes no row),
// each thread 5 owned rows x 8 streamed rows of a 64-row tile, and stream the
// other views' rows through copy_keys' virtual range with the own view cut out.
//   dq owns query rows; per tile of keys it forms dP = dO V^T and S = Q K^T as
// two 5 x 8 micro-tiles, P = exp2f(S scale log2(e) - lse log2(e)) with
// lse log2(e) formed once per row (no running maximum: the forward's LSE
// already holds it), dS = P (dP - dvec) into the warp's block of shared memory
// the way the forward passes P, and dQ += dS K as the forward's O += P V (dQ a
// 5 x DH/8 tile per thread). K is one padded copy per tile, read as K^T by
// the micro-tile and by rows in the update.
//   dk/dv is its transpose: it owns key rows (K and V in the forward's Q
// layout) and streams the other views' Q, dO, LSE and dvec. Per tile it forms
// dP^T = V dO^T and S^T = K Q^T, P^T (query rows past the range weigh exactly
// 0), dV += P^T dO, dS^T = P^T (dP^T - dvec) and dK += dS^T Q; P^T and then
// dS^T go through the warp's block. One padded copy each of Q and dO serves
// both of their reads.
//   Copies: cp.async into one buffer per streamed operand. dq: V(t) lands
// during S and dQ of tile t-1, K(t) during dP(t): two barriers per tile. dk/dv
// uses Q and dO from its first product to its last, so it takes three: Q(t)
// with its LSE and dvec lands during dP^T(t), dO(t+1) during dK(t).
//   Registers: the two micro-tiles, their operands and the accumulators are
// live at once: 5*8 + 5*8 + 5*8 + 24 = 144 floats in dq, 184 in dk/dv (two
// accumulators). Both are built for 2 blocks (8 warps) per SM, which allows
// 255 registers a thread; ptxas takes 254 for both at DH = 64, no spills.
//   Shared memory at DH = 64: two owned groups 2 x 21.0 KB, two streamed
// tiles 2 x 17.4 KB (64 rows of DH + 4 floats), the P/dS blocks 20.5 KB, the
// LSE and dvec of a tile 0.5 KB: 97.8 KB, so 2 blocks per SM either way. At
// (32, 2000, 64) that is 800 blocks, 3.03 waves on 132 SMs. 32-row tiles
// (69.9 KB and <= 170 registers, 3 blocks per SM, 2.02 waves) cut the
// micro-tiles' FMAs per shared load from 12.3 to 8.9 and double the barriers
// per row; on an H100 they were no faster (level for dq, slower for dk/dv).

// Plain versions: ops/attention.py::multi_head_attention with the same mask,
// and ops/attention_cuda.py::cross_attn_fwd_lse_plain / cross_attn_bwd_plain.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int FW = 4;            // forward: warps per block
constexpr int FT = 32 * FW;      // forward: threads per block
constexpr int TM = 5;            // forward: query rows per thread (P's layout assumes 5)
constexpr int TN = 8;            // forward: keys per thread and tile
constexpr int RW = 4 * TM;       // forward: query rows per warp
constexpr int BQ = RW * FW;      // forward: query rows per block (80)
constexpr int BK = 8 * TN;       // forward: keys per tile (64)
constexpr int FWD_BLOCKS = 3;    // forward: blocks per SM (shared memory at DH = 64)
constexpr int CUNROLL = 4;       // forward: head-dim float4 steps per QK^T loop pass
constexpr int BWD_BLOCKS = 2;    // backward: blocks per SM (the forward's TM x TN tiles)
constexpr float kNegInf = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

enum Mode { kFull = 0, kSelf = 1, kCross = 2 };

// Shared-memory layout of the forward, in floats.
template <int DH>
struct FwdSmem {
  static constexpr int QG = TM * DH + 8;  // one thread's group of TM query rows
  static constexpr int KS = DH + 4;       // one key row
  static constexpr int PW = BK * RW;      // one warp's P block, [key][RW rows]:
                                          // rows 0-3 of lane group ty at 4 ty, row 4 at 16 + ty
  static constexpr int k_off = (BQ / TM) * QG;
  static constexpr int v_off = k_off + BK * KS;
  static constexpr int p_off = v_off + BK * DH;
  static constexpr size_t bytes = (p_off + FW * PW) * sizeof(float);
};

// 16-byte global -> shared copy, zero-filled (nothing read) when !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until this thread's copies have landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Tile row i <- key row x0 + i of the virtual key range [0, nkeys), whose key
// x + gap_len lies past the cut-out range when x >= gap; zeros past nkeys.
// Each thread copies one 16-byte column c of every RPP-th row.
template <int DH>
__device__ __forceinline__ void copy_keys(float* dst, int ld, const float* __restrict__ src,
                                          int x0, int nkeys, int gap, int gap_len) {
  constexpr int C = DH / 4, RPP = FT / C;
  static_assert(FT % C == 0 && BK % RPP == 0, "whole rows per pass");
  const int c = threadIdx.x % C, i0 = threadIdx.x / C;
  dst += i0 * ld + 4 * c;
  src += 4 * c;
#pragma unroll
  for (int j = 0; j < BK / RPP; ++j) {
    const int x = x0 + i0 + j * RPP;
    const bool valid = x < nkeys;
    const int key = valid ? x + (x >= gap ? gap_len : 0) : 0;
    cp_async16(dst + j * RPP * ld, src + (size_t)key * DH, valid);
  }
}

// One block: query rows row0 .. row0 + n_live - 1 of one (batch*head) slice
// (q, k, v, o and lse already offset to it) against the keys of the virtual
// range [0, nkeys) (see copy_keys), under the mask MODE over the actual key
// index (attn_fwd's modes; the cross kernels pass kFull and cut their own view
// out of the range instead).
template <int DH, int MODE, bool LSE>
__device__ __forceinline__ void fwd_tile(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int row0, int n_live, int nkeys,
    int gap, int gap_len, int n_kpts, float scale) {
  using L = FwdSmem<DH>;
  constexpr int C = DH / 4;    // float4s per row
  constexpr int CPT = DH / 8;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = smem + L::k_off;
  float* vs = smem + L::v_off;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tx = lane & 7, ty = lane >> 3;
  const int rl = warp * RW + ty * TM;    // this thread's first row in the tile
  const bool live = warp * RW < n_live;  // warp-uniform
  float* pw = smem + L::p_off + warp * L::PW;

  for (int e = threadIdx.x; e < BQ * C; e += FT) {
    const int i = e / C, c = e % C;
    const bool valid = i < n_live;
    cp_async16(qs + (i / TM) * L::QG + (i % TM) * DH + 4 * c,
               q + (size_t)(row0 + (valid ? i : 0)) * DH + 4 * c, valid);
  }
  copy_keys<DH>(ks, L::KS, k, 0, nkeys, gap, gap_len);
  cp_async_commit();

  int rview[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) rview[r] = MODE == kFull ? 0 : (row0 + rl + r) / n_kpts;
  float acc[TM][CPT], m[TM], l[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    m[r] = kNegInf * kLog2e;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;
  }
  const float* qrow = qs + (rl / TM) * L::QG;  // row r at + r * DH
  const float scale2 = scale * kLog2e;         // scores in base 2
  const float* krow = ks + tx * L::KS;         // key tx + 8i at + 8i * KS
  const int n_tiles = (nkeys + BK - 1) / BK;

  for (int t = 0; t < n_tiles; ++t) {
    const int x0 = t * BK;
    cp_async_wait_all();  // Q and K(t) have landed
    __syncthreads();      // ... for every thread; and every warp is done with V(t-1)
    copy_keys<DH>(vs, DH, v, x0, nkeys, gap, gap_len);  // lands during QK^T(t)
    cp_async_commit();
    if (live) {
      float s[TM][TN];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int i = 0; i < TN; ++i) s[r][i] = 0.f;
#pragma unroll CUNROLL
      for (int c = 0; c < C; ++c) {
        float4 qa[TM];
#pragma unroll
        for (int r = 0; r < TM; ++r)
          qa[r] = *reinterpret_cast<const float4*>(qrow + r * DH + 4 * c);
#pragma unroll
        for (int i = 0; i < TN; ++i) {
          const float4 kk = *reinterpret_cast<const float4*>(krow + i * 8 * L::KS + 4 * c);
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            s[r][i] = fmaf(qa[r].x, kk.x, s[r][i]);
            s[r][i] = fmaf(qa[r].y, kk.y, s[r][i]);
            s[r][i] = fmaf(qa[r].z, kk.z, s[r][i]);
            s[r][i] = fmaf(qa[r].w, kk.w, s[r][i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < TN; ++i) {
        const int x = x0 + tx + 8 * i;
        const int kview = MODE == kFull ? 0 : x / n_kpts;
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          s[r][i] *= scale2;
          if (MODE != kFull && (MODE == kSelf) != (rview[r] == kview)) s[r][i] = kNegInf * kLog2e;
        }
      }
      if (x0 + BK > nkeys) {  // the last tile: keys past the range weigh exactly 0
#pragma unroll
        for (int i = 0; i < TN; ++i)
#pragma unroll
          for (int r = 0; r < TM; ++r)
            if (x0 + tx + 8 * i >= nkeys) s[r][i] = -INFINITY;
      }
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        float mx = s[r][0];
#pragma unroll
        for (int i = 1; i < TN; ++i) mx = fmaxf(mx, s[r][i]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        const float m_new = fmaxf(m[r], mx);
        const float alpha = exp2f(m[r] - m_new);
        m[r] = m_new;
        float ps = 0.f;
#pragma unroll
        for (int i = 0; i < TN; ++i) {
          s[r][i] = exp2f(s[r][i] - m_new);
          ps += s[r][i];
        }
        l[r] = l[r] * alpha + ps;
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[r][c] *= alpha;
      }
#pragma unroll
      for (int i = 0; i < TN; ++i) {
        float* pk = pw + (tx + 8 * i) * RW;
        *reinterpret_cast<float4*>(pk + ty * 4) = make_float4(s[0][i], s[1][i], s[2][i], s[3][i]);
        pk[16 + ty] = s[4][i];
      }
    }
    cp_async_wait_all();  // V(t) has landed
    __syncthreads();      // ... for every thread; and every warp is done with K(t)
    if (t + 1 < n_tiles) {  // lands during PV(t)
      copy_keys<DH>(ks, L::KS, k, x0 + BK, nkeys, gap, gap_len);
      cp_async_commit();
    }
    if (live) {
      // P and V are zero past the end of the range: round the keys up to 8
      const int nk8 = (min(BK, nkeys - x0) + 7) & ~7;
#pragma unroll 1
      for (int j0 = 0; j0 < nk8; j0 += 8) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = j0 + jj;
          const float4 p = *reinterpret_cast<const float4*>(pw + j * RW + ty * 4);
          const float pr[TM] = {p.x, p.y, p.z, p.w, pw[j * RW + 16 + ty]};
          const float* vrow = vs + j * DH;
          if constexpr (CPT >= 4) {
#pragma unroll
            for (int h = 0; h < CPT / 4; ++h) {
              const float4 vv = *reinterpret_cast<const float4*>(vrow + 32 * h + 4 * tx);
#pragma unroll
              for (int r = 0; r < TM; ++r) {
                acc[r][4 * h + 0] = fmaf(pr[r], vv.x, acc[r][4 * h + 0]);
                acc[r][4 * h + 1] = fmaf(pr[r], vv.y, acc[r][4 * h + 1]);
                acc[r][4 * h + 2] = fmaf(pr[r], vv.z, acc[r][4 * h + 2]);
                acc[r][4 * h + 3] = fmaf(pr[r], vv.w, acc[r][4 * h + 3]);
              }
            }
          } else {
            const float2 vv = *reinterpret_cast<const float2*>(vrow + 2 * tx);
#pragma unroll
            for (int r = 0; r < TM; ++r) {
              acc[r][0] = fmaf(pr[r], vv.x, acc[r][0]);
              acc[r][1] = fmaf(pr[r], vv.y, acc[r][1]);
            }
          }
        }
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 4);
  }
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int row = rl + r;
    if (row >= n_live) continue;
    const float inv = 1.f / (l[r] + 1e-9f);
    float* orow = o + (size_t)(row0 + row) * DH;
    if constexpr (CPT >= 4) {
#pragma unroll
      for (int h = 0; h < CPT / 4; ++h)
        *reinterpret_cast<float4*>(orow + 32 * h + 4 * tx) =
            make_float4(acc[r][4 * h + 0] * inv, acc[r][4 * h + 1] * inv,
                        acc[r][4 * h + 2] * inv, acc[r][4 * h + 3] * inv);
    } else {
      *reinterpret_cast<float2*>(orow + 2 * tx) =
          make_float2(acc[r][0] * inv, acc[r][1] * inv);
    }
    if (LSE && tx == 0) lse[row0 + row] = m[r] * kLn2 + logf(l[r] + 1e-9f);
  }
}

// grid (ceil(S / BQ), BH): every query attends all S keys under the mask.
template <int DH, int MODE>
__global__ void __launch_bounds__(FT, FWD_BLOCKS)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int S,
                int n_kpts, float scale) {
  const size_t base = (size_t)blockIdx.y * S * DH;
  const int row0 = blockIdx.x * BQ;
  fwd_tile<DH, MODE, false>(q + base, k + base, v + base, o + base, nullptr, row0,
                            min(BQ, S - row0), S, S, 0, n_kpts, scale);
}

// grid (n_views * tiles, BH) with tiles = ceil(n_kpts / BQ) query tiles per
// view, the last one ragged. The keys are the (V-1)*K of the other views: the
// virtual key x is key x, or x + K from the query's own view qv on. With LSE,
// also store m + log(l + 1e-9) per row (the TPU kernel's 128-lane broadcast of
// it is a Mosaic layout rule).
template <int DH, bool LSE>
__global__ void __launch_bounds__(FT, FWD_BLOCKS)
cross_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int S, int n_views, int n_kpts,
                      int tiles, float scale) {
  const size_t base = (size_t)blockIdx.y * S * DH;
  const int qv = blockIdx.x / tiles;
  const int r0 = (blockIdx.x % tiles) * BQ;  // first row within the view
  fwd_tile<DH, kFull, LSE>(q + base, k + base, v + base, o + base,
                           LSE ? lse + (size_t)blockIdx.y * S : nullptr,
                           qv * n_kpts + r0, min(BQ, n_kpts - r0),
                           (n_views - 1) * n_kpts, qv * n_kpts, n_kpts, n_kpts, scale);
}


// ---- backward: register-tiled like the forward ----

// Shared-memory layout of the backward kernels, in floats: two owned groups of
// BQ rows in the forward's Q layout (dq: Q, dO; dk/dv: K, V), two streamed
// tiles of BK rows padded like the forward's K (dq: K, V; dk/dv: Q, dO), the
// per-warp P/dS blocks, and the LSE and dvec of the streamed rows (dk/dv).
template <int DH>
struct BwdSmem {
  static constexpr int QG = TM * DH + 8;  // one thread's group of TM owned rows
  static constexpr int RS = DH + 4;       // one streamed row
  static constexpr int PW = BK * RW;      // one warp's block, laid out as the forward's P
  static constexpr int b_off = (BQ / TM) * QG;
  static constexpr int x_off = 2 * b_off;
  static constexpr int y_off = x_off + BK * RS;
  static constexpr int p_off = y_off + BK * RS;
  static constexpr int l_off = p_off + FW * PW;  // LSE [BK], then dvec [BK]
  static constexpr size_t bytes = (l_off + 2 * BK) * sizeof(float);
};

// 4-byte global -> shared copy, zero-filled (nothing read) when !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// Rows row0 .. row0 + n_live - 1 of src into BQ / TM groups of TM rows (the
// forward's Q layout), zeros past n_live.
template <int DH>
__device__ __forceinline__ void copy_group(float* dst, const float* __restrict__ src, int row0,
                                           int n_live) {
  constexpr int C = DH / 4, QG = TM * DH + 8;
  for (int e = threadIdx.x; e < BQ * C; e += FT) {
    const int i = e / C, c = e % C;
    const bool valid = i < n_live;
    cp_async16(dst + (i / TM) * QG + (i % TM) * DH + 4 * c,
               src + (size_t)(row0 + (valid ? i : 0)) * DH + 4 * c, valid);
  }
}

// dst[i] <- lse, dst[BK + i] <- dvec of row x0 + i of the virtual range (see
// copy_keys); zeros past n.
__device__ __forceinline__ void copy_row_scalars(float* dst, const float* __restrict__ lse,
                                                 const float* __restrict__ dvec, int x0, int n,
                                                 int gap, int gap_len) {
  static_assert(2 * BK <= FT, "one scalar per thread");
  if (threadIdx.x >= 2 * BK) return;
  const int x = x0 + threadIdx.x % BK;
  const bool valid = x < n;
  const int row = valid ? x + (x >= gap ? gap_len : 0) : 0;
  cp_async4(dst + threadIdx.x, (threadIdx.x < BK ? lse : dvec) + row, valid);
}

// s[r][i] = (owned row r of this thread's group) . (streamed row tx + 8i):
// grow points at the group, trow at streamed row tx of the tile.
template <int DH>
__device__ __forceinline__ void micro_tile(float (&s)[TM][TN], const float* grow,
                                           const float* trow) {
  constexpr int C = DH / 4, RS = DH + 4;
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int i = 0; i < TN; ++i) s[r][i] = 0.f;
#pragma unroll CUNROLL
  for (int c = 0; c < C; ++c) {
    float4 a[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) a[r] = *reinterpret_cast<const float4*>(grow + r * DH + 4 * c);
#pragma unroll
    for (int i = 0; i < TN; ++i) {
      const float4 b = *reinterpret_cast<const float4*>(trow + i * 8 * RS + 4 * c);
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        s[r][i] = fmaf(a[r].x, b.x, s[r][i]);
        s[r][i] = fmaf(a[r].y, b.y, s[r][i]);
        s[r][i] = fmaf(a[r].z, b.z, s[r][i]);
        s[r][i] = fmaf(a[r].w, b.w, s[r][i]);
      }
    }
  }
}

// The warp's block pw [streamed row][RW owned rows] <- this thread's micro-tile.
__device__ __forceinline__ void store_block(float* pw, const float (&s)[TM][TN], int tx, int ty) {
#pragma unroll
  for (int i = 0; i < TN; ++i) {
    float* pk = pw + (tx + 8 * i) * RW;
    *reinterpret_cast<float4*>(pk + ty * 4) = make_float4(s[0][i], s[1][i], s[2][i], s[3][i]);
    pk[16 + ty] = s[4][i];
  }
}

// acc[r][.] += sum over streamed rows j < n8 of pw[j][r] * (row j of `rows`,
// this thread's columns 32h + 4tx ..); n8 is a multiple of 8, and rows past
// the range are zero in both.
template <int DH>
__device__ __forceinline__ void update(float (&acc)[TM][DH / 8], const float* pw,
                                       const float* rows, int n8, int tx, int ty) {
  constexpr int CPT = DH / 8, RS = DH + 4;
#pragma unroll 1
  for (int j0 = 0; j0 < n8; j0 += 8) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = j0 + jj;
      const float4 p = *reinterpret_cast<const float4*>(pw + j * RW + ty * 4);
      const float pr[TM] = {p.x, p.y, p.z, p.w, pw[j * RW + 16 + ty]};
      const float* row = rows + j * RS;
      if constexpr (CPT >= 4) {
#pragma unroll
        for (int h = 0; h < CPT / 4; ++h) {
          const float4 b = *reinterpret_cast<const float4*>(row + 32 * h + 4 * tx);
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            acc[r][4 * h + 0] = fmaf(pr[r], b.x, acc[r][4 * h + 0]);
            acc[r][4 * h + 1] = fmaf(pr[r], b.y, acc[r][4 * h + 1]);
            acc[r][4 * h + 2] = fmaf(pr[r], b.z, acc[r][4 * h + 2]);
            acc[r][4 * h + 3] = fmaf(pr[r], b.w, acc[r][4 * h + 3]);
          }
        }
      } else {
        const float2 b = *reinterpret_cast<const float2*>(row + 2 * tx);
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          acc[r][0] = fmaf(pr[r], b.x, acc[r][0]);
          acc[r][1] = fmaf(pr[r], b.y, acc[r][1]);
        }
      }
    }
  }
}

// Owned rows rl .. rl + TM - 1 (of n_live) of acc * mul to dst, row0 the
// block's first row.
template <int DH>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const float (&acc)[TM][DH / 8],
                                           int row0, int rl, int n_live, int tx, float mul) {
  constexpr int CPT = DH / 8;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    if (rl + r >= n_live) continue;
    float* row = dst + (size_t)(row0 + rl + r) * DH;
    if constexpr (CPT >= 4) {
#pragma unroll
      for (int h = 0; h < CPT / 4; ++h)
        *reinterpret_cast<float4*>(row + 32 * h + 4 * tx) =
            make_float4(acc[r][4 * h + 0] * mul, acc[r][4 * h + 1] * mul,
                        acc[r][4 * h + 2] * mul, acc[r][4 * h + 3] * mul);
    } else {
      *reinterpret_cast<float2*>(row + 2 * tx) = make_float2(acc[r][0] * mul, acc[r][1] * mul);
    }
  }
}

// dq: grid (n_views * tiles, BH), tiles = ceil(n_kpts / BQ). The block owns
// query rows of view qv and streams the K and V tiles of the other views:
//   dq_i = scale * sum_j p_ij (dp_ij - dvec_i) k_j, p = exp(s - lse_i), dp = dO_i . v_j
template <int DH>
__global__ void __launch_bounds__(FT, BWD_BLOCKS)
cross_attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dvec,
                         float* __restrict__ dq, int S, int n_views, int n_kpts,
                         int tiles, float scale) {
  using L = BwdSmem<DH>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = smem + L::b_off;
  float* ks = smem + L::x_off;
  float* vs = smem + L::y_off;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tx = lane & 7, ty = lane >> 3;
  const int rl = warp * RW + ty * TM;  // this thread's first row in the block
  float* pw = smem + L::p_off + warp * L::PW;
  const size_t base = (size_t)blockIdx.y * S * DH;
  const int qv = blockIdx.x / tiles;
  const int r0 = (blockIdx.x % tiles) * BQ;  // first row within the view
  const int row0 = qv * n_kpts + r0, n_live = min(BQ, n_kpts - r0);
  const bool live = warp * RW < n_live;  // warp-uniform
  const int nkeys = (n_views - 1) * n_kpts, gap = qv * n_kpts;
  k += base;
  v += base;

  copy_group<DH>(qs, q + base, row0, n_live);
  copy_group<DH>(dos, dout + base, row0, n_live);
  copy_keys<DH>(vs, L::RS, v, 0, nkeys, gap, n_kpts);
  cp_async_commit();

  float lse2[TM], dvr[TM], acc[TM][DH / 8];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const bool in = rl + r < n_live;
    const size_t i = (size_t)blockIdx.y * S + row0 + (in ? rl + r : 0);
    lse2[r] = in ? lse[i] * kLog2e : 0.f;
    dvr[r] = in ? dvec[i] : 0.f;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) acc[r][c] = 0.f;
  }
  const float scale2 = scale * kLog2e;
  const float* qrow = qs + (rl / TM) * L::QG;
  const float* dorow = dos + (rl / TM) * L::QG;
  const int n_tiles = (nkeys + BK - 1) / BK;

  for (int t = 0; t < n_tiles; ++t) {
    const int x0 = t * BK;
    cp_async_wait_all();  // Q, dO and V(t) have landed
    __syncthreads();      // ... for every thread; and every warp is done with K(t-1)
    copy_keys<DH>(ks, L::RS, k, x0, nkeys, gap, n_kpts);  // lands during dP(t)
    cp_async_commit();
    float dp[TM][TN];
    if (live) micro_tile<DH>(dp, dorow, vs + tx * L::RS);
    cp_async_wait_all();  // K(t) has landed
    __syncthreads();      // ... for every thread; and every warp is done with V(t)
    if (t + 1 < n_tiles) {  // lands during S and dQ of tile t
      copy_keys<DH>(vs, L::RS, v, x0 + BK, nkeys, gap, n_kpts);
      cp_async_commit();
    }
    if (!live) continue;
    float s[TM][TN];
    micro_tile<DH>(s, qrow, ks + tx * L::RS);
    const bool last = x0 + BK > nkeys;
#pragma unroll
    for (int i = 0; i < TN; ++i) {
      const bool past = last && x0 + tx + 8 * i >= nkeys;  // weighs exactly 0
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float p = past ? 0.f : exp2f(fmaf(s[r][i], scale2, -lse2[r]));
        s[r][i] = p * (dp[r][i] - dvr[r]);
      }
    }
    store_block(pw, s, tx, ty);
    __syncwarp();
    update<DH>(acc, pw, ks, (min(BK, nkeys - x0) + 7) & ~7, tx, ty);
  }
  if (live) store_rows<DH>(dq + base, acc, row0, rl, n_live, tx, scale);
}

// dk, dv: grid (n_views * tiles, BH). The block owns key rows of view kv and
// streams Q, dO, LSE and dvec of every query row of the other views:
//   dv_j = sum_i p_ij dO_i,  dk_j = scale * sum_i p_ij (dp_ij - dvec_i) q_i
template <int DH>
__global__ void __launch_bounds__(FT, BWD_BLOCKS)
cross_attn_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dvec,
                          float* __restrict__ dk, float* __restrict__ dv, int S,
                          int n_views, int n_kpts, int tiles, float scale) {
  using L = BwdSmem<DH>;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = smem + L::b_off;
  float* qs = smem + L::x_off;
  float* dos = smem + L::y_off;
  float* ls = smem + L::l_off;  // LSE of the tile's query rows, then dvec
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tx = lane & 7, ty = lane >> 3;
  const int rl = warp * RW + ty * TM;
  float* pw = smem + L::p_off + warp * L::PW;
  const size_t base = (size_t)blockIdx.y * S * DH;
  const int kv = blockIdx.x / tiles;
  const int r0 = (blockIdx.x % tiles) * BQ;
  const int row0 = kv * n_kpts + r0, n_live = min(BQ, n_kpts - r0);
  const bool live = warp * RW < n_live;
  const int nq = (n_views - 1) * n_kpts, gap = kv * n_kpts;
  q += base;
  dout += base;
  lse += (size_t)blockIdx.y * S;
  dvec += (size_t)blockIdx.y * S;

  copy_group<DH>(ks, k + base, row0, n_live);
  copy_group<DH>(vs, v + base, row0, n_live);
  copy_keys<DH>(dos, L::RS, dout, 0, nq, gap, n_kpts);
  cp_async_commit();

  float dka[TM][DH / 8], dva[TM][DH / 8];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      dka[r][c] = 0.f;
      dva[r][c] = 0.f;
    }
  const float scale2 = scale * kLog2e;
  const float* krow = ks + (rl / TM) * L::QG;
  const float* vrow = vs + (rl / TM) * L::QG;
  const int n_tiles = (nq + BK - 1) / BK;

  for (int t = 0; t < n_tiles; ++t) {
    const int x0 = t * BK;
    const int n8 = (min(BK, nq - x0) + 7) & ~7;
    cp_async_wait_all();  // K, V and dO(t) have landed
    __syncthreads();      // ... for every thread; and every warp is done with Q(t-1)
    copy_keys<DH>(qs, L::RS, q, x0, nq, gap, n_kpts);  // land during dP^T(t)
    copy_row_scalars(ls, lse, dvec, x0, nq, gap, n_kpts);
    cp_async_commit();
    float dp[TM][TN];
    if (live) micro_tile<DH>(dp, vrow, dos + tx * L::RS);
    cp_async_wait_all();  // Q(t), its LSE and dvec have landed
    __syncthreads();      // ... for every thread
    if (live) {
      float s[TM][TN];
      micro_tile<DH>(s, krow, qs + tx * L::RS);
      const bool last = x0 + BK > nq;
#pragma unroll
      for (int i = 0; i < TN; ++i) {
        const int j = tx + 8 * i;
        const bool past = last && x0 + j >= nq;  // weighs exactly 0
        const float l2 = ls[j] * kLog2e, dvj = ls[BK + j];
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float p = past ? 0.f : exp2f(fmaf(s[r][i], scale2, -l2));
          s[r][i] = p;
          dp[r][i] = p * (dp[r][i] - dvj);
        }
      }
      store_block(pw, s, tx, ty);
      __syncwarp();
      update<DH>(dva, pw, dos, n8, tx, ty);
    }
    __syncthreads();  // every warp is done with dO(t) (and its block of P^T)
    if (t + 1 < n_tiles) {  // lands during dK(t)
      copy_keys<DH>(dos, L::RS, dout, x0 + BK, nq, gap, n_kpts);
      cp_async_commit();
    }
    if (!live) continue;
    store_block(pw, dp, tx, ty);
    __syncwarp();
    update<DH>(dka, pw, qs, n8, tx, ty);
  }
  if (!live) return;
  store_rows<DH>(dk + base, dka, row0, rl, n_live, tx, scale);
  store_rows<DH>(dv + base, dva, row0, rl, n_live, tx, 1.f);
}

// Above 48 KB a block's shared memory is dynamic only; the carveout asks for
// the SM's whole 228 KB, so that FWD_BLOCKS (BWD_BLOCKS) blocks fit.
template <typename F>
void prepare_smem(F* kernel, size_t bytes) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       (int)cudaSharedmemCarveoutMaxShared);
}

template <int DH, int MODE>
void launch_attn_mode(const float* q, const float* k, const float* v, float* o,
                      int BH, int S, int n_kpts, float scale, cudaStream_t st) {
  constexpr size_t bytes = FwdSmem<DH>::bytes;
  prepare_smem(attn_fwd_kernel<DH, MODE>, bytes);
  const dim3 grid((S + BQ - 1) / BQ, BH);
  attn_fwd_kernel<DH, MODE><<<grid, FT, bytes, st>>>(q, k, v, o, S, n_kpts, scale);
}

template <int DH>
void launch_attn(const float* q, const float* k, const float* v, float* o,
                 int BH, int S, int n_kpts, int mode, float scale,
                 cudaStream_t st) {
  if (mode == kFull)
    launch_attn_mode<DH, kFull>(q, k, v, o, BH, S, n_kpts, scale, st);
  else if (mode == kSelf)
    launch_attn_mode<DH, kSelf>(q, k, v, o, BH, S, n_kpts, scale, st);
  else
    launch_attn_mode<DH, kCross>(q, k, v, o, BH, S, n_kpts, scale, st);
}

bool cross_shape_ok(int BH, int S, int n_views, int n_kpts) {
  return BH >= 1 && BH <= 65535 && n_views >= 2 && n_kpts >= 1 &&
         S == n_views * n_kpts;
}

template <int DH, bool LSE>
void launch_cross_dh(const float* q, const float* k, const float* v, float* o,
                     float* lse, int BH, int S, int n_views, int n_kpts, float scale,
                     cudaStream_t st) {
  constexpr size_t bytes = FwdSmem<DH>::bytes;
  prepare_smem(cross_attn_fwd_kernel<DH, LSE>, bytes);
  const int tiles = (n_kpts + BQ - 1) / BQ;
  const dim3 grid(n_views * tiles, BH);
  cross_attn_fwd_kernel<DH, LSE><<<grid, FT, bytes, st>>>(q, k, v, o, lse, S, n_views,
                                                          n_kpts, tiles, scale);
}

int launch_cross_fwd(const float* q, const float* k, const float* v, float* o,
                     float* lse, int BH, int S, int dh, int n_views, int n_kpts,
                     float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!cross_shape_ok(BH, S, n_views, n_kpts)) return -1;
#define CROSS_FWD(D)                                                                 \
  if (lse)                                                                           \
    launch_cross_dh<D, true>(q, k, v, o, lse, BH, S, n_views, n_kpts, scale, st);    \
  else                                                                               \
    launch_cross_dh<D, false>(q, k, v, o, nullptr, BH, S, n_views, n_kpts, scale, st);
  switch (dh) {
    case 16: CROSS_FWD(16) break;
    case 32: CROSS_FWD(32) break;
    case 64: CROSS_FWD(64) break;
    default: return -1;
  }
#undef CROSS_FWD
  return (int)cudaGetLastError();
}

template <int DH>
void launch_bwd_dq(const float* q, const float* k, const float* v, const float* dout,
                   const float* lse, const float* dvec, float* dq, int BH, int S,
                   int n_views, int n_kpts, float scale, cudaStream_t st) {
  constexpr size_t bytes = BwdSmem<DH>::bytes;
  prepare_smem(cross_attn_bwd_dq_kernel<DH>, bytes);
  const int tiles = (n_kpts + BQ - 1) / BQ;
  const dim3 grid(n_views * tiles, BH);
  cross_attn_bwd_dq_kernel<DH><<<grid, FT, bytes, st>>>(
      q, k, v, dout, lse, dvec, dq, S, n_views, n_kpts, tiles, scale);
}

template <int DH>
void launch_bwd_dkv(const float* q, const float* k, const float* v, const float* dout,
                    const float* lse, const float* dvec, float* dk, float* dv, int BH,
                    int S, int n_views, int n_kpts, float scale, cudaStream_t st) {
  constexpr size_t bytes = BwdSmem<DH>::bytes;
  prepare_smem(cross_attn_bwd_dkv_kernel<DH>, bytes);
  const int tiles = (n_kpts + BQ - 1) / BQ;
  const dim3 grid(n_views * tiles, BH);
  cross_attn_bwd_dkv_kernel<DH><<<grid, FT, bytes, st>>>(
      q, k, v, dout, lse, dvec, dk, dv, S, n_views, n_kpts, tiles, scale);
}

// {blocks per SM, registers, local (spill) bytes per thread, dynamic shared
// bytes, owned rows per block} of one kernel, as the runtime sees it.
template <typename F>
int kernel_info(F* kernel, size_t bytes, int* info) {
  prepare_smem(kernel, bytes);
  cudaFuncAttributes a;
  int blocks = 0;
  if (cudaFuncGetAttributes(&a, kernel) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, FT, bytes) !=
          cudaSuccess)
    return (int)cudaGetLastError();
  info[0] = blocks;
  info[1] = a.numRegs;
  info[2] = (int)a.localSizeBytes;
  info[3] = (int)bytes;
  info[4] = BQ;
  return 0;
}

template <int DH>
int kernel_info_dh(int which, int* info) {
  constexpr size_t fwd = FwdSmem<DH>::bytes, bwd = BwdSmem<DH>::bytes;
  switch (which) {
    case 0: return kernel_info(attn_fwd_kernel<DH, kFull>, fwd, info);
    case 1: return kernel_info(attn_fwd_kernel<DH, kSelf>, fwd, info);
    case 2: return kernel_info(attn_fwd_kernel<DH, kCross>, fwd, info);
    case 3: return kernel_info(cross_attn_fwd_kernel<DH, false>, fwd, info);
    case 4: return kernel_info(cross_attn_fwd_kernel<DH, true>, fwd, info);
    case 5: return kernel_info(cross_attn_bwd_dq_kernel<DH>, bwd, info);
    case 6: return kernel_info(cross_attn_bwd_dkv_kernel<DH>, bwd, info);
    default: return -1;
  }
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
  switch (dh) {
    case 16: launch_bwd_dq<16>(q, k, v, dout, lse, dvec, dq, BH, S, n_views, n_kpts, scale, st); break;
    case 32: launch_bwd_dq<32>(q, k, v, dout, lse, dvec, dq, BH, S, n_views, n_kpts, scale, st); break;
    case 64: launch_bwd_dq<64>(q, k, v, dout, lse, dvec, dq, BH, S, n_views, n_kpts, scale, st); break;
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
  switch (dh) {
    case 16: launch_bwd_dkv<16>(q, k, v, dout, lse, dvec, dk, dv, BH, S, n_views, n_kpts, scale, st); break;
    case 32: launch_bwd_dkv<32>(q, k, v, dout, lse, dvec, dk, dv, BH, S, n_views, n_kpts, scale, st); break;
    case 64: launch_bwd_dkv<64>(q, k, v, dout, lse, dvec, dk, dv, BH, S, n_views, n_kpts, scale, st); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

// Occupancy of a kernel: which = 0, 1, 2 for attn_fwd in modes full, self,
// cross; 3 cross_attn_fwd; 4 cross_attn_fwd_lse; 5 cross_attn_bwd_dq; 6
// cross_attn_bwd_dkv. Fills info[5] (see kernel_info) and returns 0, or -1
// for an unsupported head width or kernel.
int attn_kernel_info(int dh, int which, int* info) {
  switch (dh) {
    case 16: return kernel_info_dh<16>(which, info);
    case 32: return kernel_info_dh<32>(which, info);
    case 64: return kernel_info_dh<64>(which, info);
    default: return -1;
  }
}

}  // extern "C"
