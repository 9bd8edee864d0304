// bfloat16 view-structured attention for Hopper (sm_90a), on the tensor cores.
//
// Replaces the bfloat16 instantiations of five Pallas TPU kernels of
// e2e_multi_view_matching_tpu/ops/attention_pallas.py:
//   attn_fwd_bf16           <- _attn_kernel       (one-shot masked softmax attention, mask
//                                                   "full" | "self" | "cross" built from
//                                                   token indices, -1e9 fill)
//   cross_attn_fwd_bf16     <- _cross_attn_kernel (online softmax over the other V-1 views'
//                                                   keys; the own view's keys are never read)
//   cross_attn_fwd_lse_bf16 <- _cross_attn_lse_kernel (the same, also storing the per-row
//                                                   LSE = m + log(l + 1e-9) in float32)
//   cross_attn_bwd_dq_bf16  <- _cross_attn_bwd_dq_kernel  (dq over the other views' keys)
//   cross_attn_bwd_dkv_bf16 <- _cross_attn_bwd_dkv_kernel (dk, dv over the other views'
//                                                   queries)
// The float32 kernels stay in attention_cuda.cu.
//
// Layout: q, k, v, o, dout, dq, dk, dv are (BH, S, DH) contiguous bfloat16, heads
// already split; lse and dvec are (BH, S) float32.
//
// Forward arithmetic, as the Pallas bodies have it for bfloat16 q, k, v: S = Q K^T
// in float32 from the bfloat16 inputs (each product of two bfloat16 values is
// exact in float32), times the scale in float32; P = exp(S - m) in float32; O = P V
// with P kept in float32; O / (l + 1e-9) rounded to bfloat16 once; the LSE kernel
// also stores m + log(l + 1e-9) in float32. Plain versions:
// ops/attention_cuda.py::plain_view_attention and cross_attn_fwd_lse_plain (q, k, v
// upcast to float32, the float32 masked attention, the output rounded to bfloat16).
//
// Backward arithmetic (the Pallas bodies on bfloat16 q, k, v, dO with the float32
// LSE and dvec = rowsum(dO O)): s = q k^T scale and dp = dO v^T in float32, p =
// exp(s - lse), ds = p (dp - dvec) in float32; dq = scale sum_j bf16(ds_ij) k_j,
// dk = scale sum_i bf16(ds_ij) q_i, dv = sum_i bf16(p_ij) dO_i, float32 sums, each
// output rounded to bfloat16 once. The roundings of p and ds to bfloat16 are
// exactly what a bf16 mma A operand takes, so the backward needs no split terms.
// Plain version: ops/attention_cuda.py::cross_attn_bwd_plain on bfloat16 tensors.
//
// What bounds them on an H100: the tensor cores' bf16 rate (989 TFLOP/s dense) for
// the products (2 a (query, key) pair in the forward, 3 in dq, 4 in dk/dv), and the
// exponentials (one a pair, 4.18e12/s on the SFUs); device memory is far below
// both (each block streams its keys, or queries, once from L2).
//
// Design: FlashAttention-2 style on mma.sync.m16n8k16 (bf16 in, f32 accumulate).
// 4 warps own 64 rows, 16 each; a warp reads its A fragments (Q, or dO, K, V of
// the rows it owns) from shared memory with ldmatrix once per streamed tile (DH/16
// k-steps). The streamed operands go through shared memory in tiles of 64 rows with
// cp.async, double-buffered (tile t+1 lands while tile t is computed), rows padded
// by 8 bf16 so that ldmatrix reads conflict-free; a streamed operand whose rows
// index the product's columns (K in S = Q K^T) is read with ldmatrix as the B
// operand, one whose rows index the sum (V in P V) with ldmatrix.trans.
//   The online softmax works on the S accumulators in registers: each thread
// holds 2 columns of 8 key blocks for 2 rows, row maxima meet across the 4 lanes
// of a quad in two __shfl_xor_sync, exp2f with log2(e) folded into the scale
// (as the float32 kernels), each thread keeps its own part of the row sum l until
// the end. Constants as in the TPU kernels: masked scores -1e9 (times log2 e), m
// starts there, keys past the end of the range weigh exactly 0 (-INFINITY).
//   P V with P in float32 on bf16 tensor cores: P = P_hi + P_mid + P_lo, three
// bfloat16 terms that together hold P's 24 significant bits exactly (each term
// is the round-to-nearest of what the ones before it left), built straight from
// the S accumulator layout, which is the A-operand layout of the next product.
// Three mma's into one float32 accumulator then give P V with exact products,
// as the Pallas kernel's float32 dot does. (Two terms would leave up to 2^-16
// |P| of each weight out: below an output's bf16 ulp on average, but not on
// the outputs that cancel to near 0.) A tile's P V goes into a fresh
// accumulator, which is added to O in float32 (O = O alpha + tile): the tensor
// cores' float32 accumulation aligns to the largest term and drops the bits
// below, so a running O over all keys drifted up to ~1.5e-6 of sum p |v| / l
// (4e-6 absolute at |v| ~ 2 on an output that cancels to ~2e-5: 3.5 bf16 ulps
// there); 12 accumulations a tile from 0 leave ~7e-7 of it (~2^-20), inside
// the gate's 2^-18 (ops/attention_cuda.py::BF16_SUM_TOL). The backward kernels
// sum each tile's products into a fresh accumulator the same way.
//   Cross kernels: every row tile lies inside one view, and the streamed rows are
// the other views' as one virtual range of (V-1) K rows with the own view cut out.
//   dq (bwd_dq_tile) owns query rows: per tile of 64 keys it forms S = Q K^T and
// dP = dO V^T (K and V both read as B operands), p = exp2(S scale log2 e -
// lse log2 e) (no running maximum: the LSE holds it), dS = p (dP - dvec), and
// dQ += bf16(dS) K (K read again, with ldmatrix.trans). dk/dv (bwd_dkv_tile) is
// its transpose: it owns key rows and streams the other views' Q, dO, LSE and
// dvec; S^T = K Q^T and dP^T = V dO^T come out with the keys as rows, so P^T and
// dS^T are in the A-operand layout of dV += bf16(P^T) dO and dK += bf16(dS^T) Q.
// Each block owns its outputs: no atomics, the same bits on every run.
//   Registers: the forward holds S (32), O and the tile's accumulator (2 x DH/2),
// Q fragments (DH/4) and the P terms, built for 3 blocks per SM (<= 168
// registers a thread); the backward holds two score tiles (2 x 32), one or two
// output accumulators and the tile's (DH/2 each), built for 2 blocks per SM (<=
// 255). No spills. Shared memory at DH = 64: forward Q 9 KB, K and V 2 x 2 x 9 KB:
// 45 KB; backward two owned 9 KB groups and two double-buffered streamed
// operands: 54 KB (dk/dv also 1 KB of LSE and dvec).

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NW = 4;           // warps per block
constexpr int NT = 32 * NW;     // threads per block
constexpr int BQ = 16 * NW;     // query rows per block (16 a warp)
constexpr int BK = 64;          // keys per tile
constexpr int MIN_BLOCKS = 3;   // forward: blocks per SM the registers are sized for
constexpr int BWD_BLOCKS = 2;   // backward: blocks per SM the registers are sized for
constexpr float kNegInf = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

enum Mode { kFull = 0, kSelf = 1, kCross = 2 };

static_assert(BQ == BK, "Q and the K/V tiles share the copy routine");

// Shared-memory layout, in bf16 elements: Q (BQ rows), two K tiles, two V tiles,
// every row DH + 8 long (16 bytes of padding: the 8 rows an ldmatrix reads fall
// in 8 different groups of 4 banks).
template <int DH>
struct Smem {
  static constexpr int LD = DH + 8;
  static constexpr int TILE = BK * LD;
  static constexpr int k_off = BQ * LD;
  static constexpr int v_off = k_off + 2 * TILE;
  static constexpr size_t bytes = (size_t)(v_off + 2 * TILE) * sizeof(bf16);
};

// The backward's layout, in bf16 elements: two owned groups of BQ rows (dq: Q and
// dO; dk/dv: K and V), then two streamed operands of two tiles each (dq: K and V;
// dk/dv: Q and dO), then (dk/dv) two tiles of float32 LSE and dvec.
template <int DH>
struct BwdSmem {
  static constexpr int LD = DH + 8;
  static constexpr int TILE = BK * LD;
  static constexpr int b_off = BQ * LD;
  static constexpr int x_off = 2 * BQ * LD;
  static constexpr int y_off = x_off + 2 * TILE;
  static constexpr int end = y_off + 2 * TILE;
  static constexpr size_t bytes = (size_t)end * sizeof(bf16);
  static constexpr size_t bytes_scalars = bytes + 2 * 2 * BK * sizeof(float);
};

// 16-byte global -> shared copy, zero-filled (nothing read) when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4-byte global -> shared copy, zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Tile row i <- row x0 + i of the virtual range [0, n), whose row x is row
// x + gap_len of src from x >= gap on; zeros past n. Each thread copies one
// 16-byte chunk c of every RPP-th row.
template <int DH>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* __restrict__ src, int x0,
                                          int n, int gap, int gap_len) {
  constexpr int C = DH / 8, RPP = NT / C, LD = Smem<DH>::LD;
  static_assert(NT % C == 0 && BK % RPP == 0, "whole rows per pass");
  const int c = threadIdx.x % C, i0 = threadIdx.x / C;
#pragma unroll
  for (int j = 0; j < BK / RPP; ++j) {
    const int i = i0 + j * RPP;
    const int x = x0 + i;
    const bool valid = x < n;
    const int row = valid ? x + (x >= gap ? gap_len : 0) : 0;
    cp_async16(dst + i * LD + 8 * c, src + (size_t)row * DH + 8 * c, valid);
  }
}

// Four 8x8 bf16 matrices from shared memory; lane i gives the address of row
// i % 8 of matrix i / 8, and receives row lane / 4, columns 2 (lane % 4) + {0, 1}
// of each (with .trans: column lane / 4, rows 2 (lane % 4) + {0, 1}).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c (16x8 f32) += a (16x16 bf16, row-major fragment) * b (16x8 bf16, column fragment).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) rounded to bfloat16, packed as one A-fragment register (x low).
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  return as_u32(__floats2bfloat162_rn(x, y));
}

// (x, y) -> three bf16 pairs whose sum is exactly (x, y): each term rounds what
// the ones before it left (x - hi is exact in float32, and so on).
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  x -= __low2float(h);
  y -= __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(x, y);
  x -= __low2float(m);
  y -= __high2float(m);
  hi = as_u32(h);
  mid = as_u32(m);
  lo = as_u32(__floats2bfloat162_rn(x, y));
}

// One block: query rows row0 .. row0 + n_live - 1 of one (batch*head) slice (q,
// k, v, o already offset to it) against the keys of the virtual range [0, nkeys)
// (see copy_rows), under the mask MODE over the key index (attn_fwd's modes;
// the cross kernel passes kFull and cuts its own view out of the range). With
// LSE, also lse[row] = m + log(l + 1e-9) in float32 (lse offset to the slice).
template <int DH, int MODE, bool LSE>
__device__ __forceinline__ void fwd_tile(const bf16* __restrict__ q,
                                         const bf16* __restrict__ k,
                                         const bf16* __restrict__ v, bf16* __restrict__ o,
                                         float* __restrict__ lse, int row0, int n_live,
                                         int nkeys, int gap, int gap_len, int n_kpts,
                                         float scale) {
  using L = Smem<DH>;
  constexpr int LD = L::LD;
  constexpr int KS = DH / 16;  // k-steps of Q K^T
  constexpr int ND = DH / 8;   // 8-column blocks of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + L::k_off;
  bf16* vs = qs + L::v_off;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;  // fragment row g (and g + 8), columns 2 tq + {0, 1}
  const bool live = warp * 16 < n_live;    // warp-uniform

  copy_rows<DH>(qs, q + (size_t)row0 * DH, 0, n_live, INT_MAX, 0);
  copy_rows<DH>(ks, k, 0, nkeys, gap, gap_len);
  copy_rows<DH>(vs, v, 0, nkeys, gap, gap_len);
  cp_async_commit();

  const int rv0 = MODE == kFull ? 0 : (row0 + warp * 16 + g) / n_kpts;
  const int rv1 = MODE == kFull ? 0 : (row0 + warp * 16 + g + 8) / n_kpts;
  float acc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m0 = kNegInf * kLog2e, m1 = kNegInf * kLog2e, l0 = 0.f, l1 = 0.f;
  const float scale2 = scale * kLog2e;  // scores in base 2
  const int n_tiles = (nkeys + BK - 1) / BK;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();  // tile t (and Q) have landed
    __syncthreads();      // ... for every thread; and every warp is done with tile t-1
    if (t + 1 < n_tiles) {  // lands during tile t's products, in the other buffer
      const int nb = (t + 1) & 1;
      copy_rows<DH>(ks + nb * L::TILE, k, (t + 1) * BK, nkeys, gap, gap_len);
      copy_rows<DH>(vs + nb * L::TILE, v, (t + 1) * BK, nkeys, gap, gap_len);
      cp_async_commit();
    }
    if (!live) continue;
    uint32_t qf[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      ldsm_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * LD + 16 * kk + 8 * (lane >> 4));
    const bf16* kt = ks + (t & 1) * L::TILE;
    const bf16* vt = vs + (t & 1) * L::TILE;

    // S = Q K^T: 8 blocks of 8 keys
    float s[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int nb = 0; nb < 8; nb += 2) {
        uint32_t b[4];  // B fragments of key blocks nb and nb + 1
        ldsm_x4(b, kt + (8 * nb + (lane & 7) + 8 * (lane >> 4)) * LD + 16 * kk +
                       8 * ((lane >> 3) & 1));
        mma_bf16(s[nb], qf[kk], b[0], b[1]);
        mma_bf16(s[nb + 1], qf[kk], b[2], b[3]);
      }
    }

    const int x0 = t * BK;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int x = x0 + 8 * nb + 2 * tq + c;
        float a = s[nb][c] * scale2, b = s[nb][2 + c] * scale2;
        if (MODE != kFull) {
          const int kv = x / n_kpts;
          if ((MODE == kSelf) != (rv0 == kv)) a = kNegInf * kLog2e;
          if ((MODE == kSelf) != (rv1 == kv)) b = kNegInf * kLog2e;
        }
        if (x0 + BK > nkeys && x >= nkeys) a = b = -INFINITY;  // past the range: weight 0
        s[nb][c] = a;
        s[nb][2 + c] = b;
      }
    }

    // online softmax over the tile, rows g (elements 0, 1) and g + 8 (2, 3)
    float mx0 = s[0][0], mx1 = s[0][2];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      mx0 = fmaxf(mx0, fmaxf(s[nb][0], s[nb][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nb][2], s[nb][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      s[nb][0] = exp2f(s[nb][0] - mn0);
      s[nb][1] = exp2f(s[nb][1] - mn0);
      s[nb][2] = exp2f(s[nb][2] - mn1);
      s[nb][3] = exp2f(s[nb][3] - mn1);
      ps0 += s[nb][0] + s[nb][1];
      ps1 += s[nb][2] + s[nb][3];
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;

    // the tile's P V, 16 keys a k-step; the accumulators of key blocks 2j and
    // 2j + 1 are the A fragment of k-step j
    float to[ND][4];
#pragma unroll
    for (int d = 0; d < ND; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) to[d][e] = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t ph[4], pm[4], pl[4];
      split3(s[2 * j][0], s[2 * j][1], ph[0], pm[0], pl[0]);
      split3(s[2 * j][2], s[2 * j][3], ph[1], pm[1], pl[1]);
      split3(s[2 * j + 1][0], s[2 * j + 1][1], ph[2], pm[2], pl[2]);
      split3(s[2 * j + 1][2], s[2 * j + 1][3], ph[3], pm[3], pl[3]);
#pragma unroll
      for (int d = 0; d < ND; d += 2) {
        uint32_t b[4];  // B fragments of O's column blocks d and d + 1
        ldsm_x4_trans(b, vt + (16 * j + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * d +
                             8 * (lane >> 4));
        mma_bf16(to[d], ph, b[0], b[1]);
        mma_bf16(to[d], pm, b[0], b[1]);
        mma_bf16(to[d], pl, b[0], b[1]);
        mma_bf16(to[d + 1], ph, b[2], b[3]);
        mma_bf16(to[d + 1], pm, b[2], b[3]);
        mma_bf16(to[d + 1], pl, b[2], b[3]);
      }
    }
#pragma unroll
    for (int d = 0; d < ND; ++d) {  // O = O alpha + the tile's P V, in float32
      acc[d][0] = fmaf(acc[d][0], al0, to[d][0]);
      acc[d][1] = fmaf(acc[d][1], al0, to[d][1]);
      acc[d][2] = fmaf(acc[d][2], al1, to[d][2]);
      acc[d][3] = fmaf(acc[d][3], al1, to[d][3]);
    }
  }

  if (!live) return;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = l0 + 1e-9f, d1 = l1 + 1e-9f;
  const int r = warp * 16 + g;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const int col = 8 * d + 2 * tq;
    if (r < n_live)
      *reinterpret_cast<__nv_bfloat162*>(o + (size_t)(row0 + r) * DH + col) =
          __floats2bfloat162_rn(acc[d][0] / d0, acc[d][1] / d0);
    if (r + 8 < n_live)
      *reinterpret_cast<__nv_bfloat162*>(o + (size_t)(row0 + r + 8) * DH + col) =
          __floats2bfloat162_rn(acc[d][2] / d1, acc[d][3] / d1);
  }
  if (LSE && tq == 0) {  // m is in base 2: LSE = m ln 2 + log(l + 1e-9)
    if (r < n_live) lse[row0 + r] = m0 * kLn2 + logf(d0);
    if (r + 8 < n_live) lse[row0 + r + 8] = m1 * kLn2 + logf(d1);
  }
}

// grid (ceil(S / BQ), BH): every query attends all S keys under the mask.
template <int DH, int MODE>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
attn_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int S, int n_kpts,
                     float scale) {
  const size_t base = (size_t)blockIdx.y * S * DH;
  const int row0 = blockIdx.x * BQ;
  fwd_tile<DH, MODE, false>(q + base, k + base, v + base, o + base, nullptr, row0,
                            min(BQ, S - row0), S, INT_MAX, 0, n_kpts, scale);
}

// grid (n_views * tiles, BH) with tiles = ceil(n_kpts / BQ) query tiles per view,
// the last one ragged. The keys are the (V-1) K of the other views: the virtual
// key x is key x, or x + K from the query's own view qv on. With LSE (lse
// (BH, S) float32) it is cross_attn_fwd_lse_bf16.
template <int DH, bool LSE>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
cross_attn_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o,
                           float* __restrict__ lse, int S, int n_views, int n_kpts,
                           int tiles, float scale) {
  const size_t base = (size_t)blockIdx.y * S * DH;
  const int qv = blockIdx.x / tiles;
  const int r0 = (blockIdx.x % tiles) * BQ;  // first row within the view
  fwd_tile<DH, kFull, LSE>(q + base, k + base, v + base, o + base,
                           LSE ? lse + (size_t)blockIdx.y * S : nullptr, qv * n_kpts + r0,
                           min(BQ, n_kpts - r0), (n_views - 1) * n_kpts, qv * n_kpts,
                           n_kpts, n_kpts, scale);
}

// acc += bf16(x) B over one streamed tile: x is a warp's 16 x BK score
// accumulators (8 blocks of 8 columns, rounded to bfloat16: the A operand of
// k-step j is blocks 2j and 2j + 1), B the tile's BK rows read with
// ldmatrix.trans. The tile's sum starts from 0 and is added to acc in float32.
template <int DH>
__device__ __forceinline__ void add_tile_product(float (&acc)[DH / 8][4],
                                                 const float (&x)[8][4], const bf16* bt,
                                                 int lane) {
  constexpr int ND = DH / 8, LD = DH + 8;
  float to[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) to[d][e] = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) {
    const uint32_t a[4] = {pack_bf16(x[2 * j][0], x[2 * j][1]),
                           pack_bf16(x[2 * j][2], x[2 * j][3]),
                           pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]),
                           pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3])};
#pragma unroll
    for (int d = 0; d < ND; d += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, bt + (16 * j + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * d +
                           8 * (lane >> 4));
      mma_bf16(to[d], a, b[0], b[1]);
      mma_bf16(to[d + 1], a, b[2], b[3]);
    }
  }
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] += to[d][e];
}

// One dq block: query rows row0 .. row0 + n_live - 1 of one slice (q, dout
// offset to row0; k, v to the slice; lse, dvec to the row) against the keys of
// the virtual range [0, nkeys) (see copy_rows):
//   dq_i = scale sum_j bf16(p_ij (dp_ij - dvec_i)) k_j,  p_ij = exp(s_ij - lse_i)
template <int DH>
__device__ __forceinline__ void bwd_dq_tile(const bf16* __restrict__ q,
                                            const bf16* __restrict__ k,
                                            const bf16* __restrict__ v,
                                            const bf16* __restrict__ dout,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ dvec,
                                            bf16* __restrict__ dq, int n_live, int nkeys,
                                            int gap, int gap_len, float scale) {
  using L = BwdSmem<DH>;
  constexpr int LD = L::LD;
  constexpr int KS = DH / 16;
  constexpr int ND = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + L::b_off;
  bf16* ks = qs + L::x_off;
  bf16* vs = qs + L::y_off;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const bool live = warp * 16 < n_live;

  copy_rows<DH>(qs, q, 0, n_live, INT_MAX, 0);
  copy_rows<DH>(dos, dout, 0, n_live, INT_MAX, 0);
  copy_rows<DH>(ks, k, 0, nkeys, gap, gap_len);
  copy_rows<DH>(vs, v, 0, nkeys, gap, gap_len);
  cp_async_commit();

  const int r = warp * 16 + g;  // this thread's rows r and r + 8
  const float l2a = r < n_live ? lse[r] * kLog2e : 0.f;
  const float l2b = r + 8 < n_live ? lse[r + 8] * kLog2e : 0.f;
  const float dva = r < n_live ? dvec[r] : 0.f;
  const float dvb = r + 8 < n_live ? dvec[r + 8] : 0.f;
  float acc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  const float scale2 = scale * kLog2e;
  const int n_tiles = (nkeys + BK - 1) / BK;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();  // tile t (and Q, dO) have landed
    __syncthreads();      // ... for every thread; and every warp is done with tile t-1
    if (t + 1 < n_tiles) {
      const int nb = (t + 1) & 1;
      copy_rows<DH>(ks + nb * L::TILE, k, (t + 1) * BK, nkeys, gap, gap_len);
      copy_rows<DH>(vs + nb * L::TILE, v, (t + 1) * BK, nkeys, gap, gap_len);
      cp_async_commit();
    }
    if (!live) continue;
    const bf16* kt = ks + (t & 1) * L::TILE;
    const bf16* vt = vs + (t & 1) * L::TILE;

    // S = Q K^T and dP = dO V^T: 8 blocks of 8 keys each
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qf[4], df[4];
      ldsm_x4(qf, qs + (warp * 16 + (lane & 15)) * LD + 16 * kk + 8 * (lane >> 4));
      ldsm_x4(df, dos + (warp * 16 + (lane & 15)) * LD + 16 * kk + 8 * (lane >> 4));
#pragma unroll
      for (int nb = 0; nb < 8; nb += 2) {
        const int off = (8 * nb + (lane & 7) + 8 * (lane >> 4)) * LD + 16 * kk +
                        8 * ((lane >> 3) & 1);
        uint32_t b[4];
        ldsm_x4(b, kt + off);
        mma_bf16(s[nb], qf, b[0], b[1]);
        mma_bf16(s[nb + 1], qf, b[2], b[3]);
        ldsm_x4(b, vt + off);
        mma_bf16(dp[nb], df, b[0], b[1]);
        mma_bf16(dp[nb + 1], df, b[2], b[3]);
      }
    }

    // dS = p (dP - dvec) in float32, into s
    const int x0 = t * BK;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const bool past = x0 + BK > nkeys && x0 + 8 * nb + 2 * tq + c >= nkeys;
        const float pa = past ? 0.f : exp2f(fmaf(s[nb][c], scale2, -l2a));
        const float pb = past ? 0.f : exp2f(fmaf(s[nb][2 + c], scale2, -l2b));
        s[nb][c] = pa * (dp[nb][c] - dva);
        s[nb][2 + c] = pb * (dp[nb][2 + c] - dvb);
      }
    }

    add_tile_product<DH>(acc, s, kt, lane);  // the tile's bf16(dS) K
  }

  if (!live) return;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const int col = 8 * d + 2 * tq;
    if (r < n_live)
      *reinterpret_cast<__nv_bfloat162*>(dq + (size_t)r * DH + col) =
          __floats2bfloat162_rn(acc[d][0] * scale, acc[d][1] * scale);
    if (r + 8 < n_live)
      *reinterpret_cast<__nv_bfloat162*>(dq + (size_t)(r + 8) * DH + col) =
          __floats2bfloat162_rn(acc[d][2] * scale, acc[d][3] * scale);
  }
}

// Tile slot i <- the LSE and dvec of row x0 + i of the virtual range [0, n)
// (zeros past n): threads 0 .. BK-1 copy the LSE, BK .. 2 BK - 1 dvec.
__device__ __forceinline__ void copy_row_scalars(float* dst, const float* __restrict__ lse,
                                                 const float* __restrict__ dvec, int x0,
                                                 int n, int gap, int gap_len) {
  static_assert(NT == 2 * BK, "one scalar a thread");
  const int i = threadIdx.x % BK;
  const int x = x0 + i;
  const bool valid = x < n;
  const int row = valid ? x + (x >= gap ? gap_len : 0) : 0;
  const float* src = threadIdx.x < BK ? lse : dvec;
  cp_async4(dst + threadIdx.x, src + row, valid);
}

// One dk/dv block: key rows row0 .. row0 + n_live - 1 of one slice (k, v offset
// to row0; q, dout, lse, dvec to the slice) against the query rows of the
// virtual range [0, nq):
//   dv_j = sum_i bf16(p_ij) dO_i,  dk_j = scale sum_i bf16(p_ij (dp_ij - dvec_i)) q_i
template <int DH>
__device__ __forceinline__ void bwd_dkv_tile(const bf16* __restrict__ q,
                                             const bf16* __restrict__ k,
                                             const bf16* __restrict__ v,
                                             const bf16* __restrict__ dout,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ dvec,
                                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                                             int n_live, int nq, int gap, int gap_len,
                                             float scale) {
  using L = BwdSmem<DH>;
  constexpr int LD = L::LD;
  constexpr int KS = DH / 16;
  constexpr int ND = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + L::b_off;
  bf16* qs = ks + L::x_off;
  bf16* dos = ks + L::y_off;
  float* sc = reinterpret_cast<float*>(ks + L::end);  // 2 x (LSE[BK], dvec[BK])
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const bool live = warp * 16 < n_live;

  copy_rows<DH>(ks, k, 0, n_live, INT_MAX, 0);
  copy_rows<DH>(vs, v, 0, n_live, INT_MAX, 0);
  copy_rows<DH>(qs, q, 0, nq, gap, gap_len);
  copy_rows<DH>(dos, dout, 0, nq, gap, gap_len);
  copy_row_scalars(sc, lse, dvec, 0, nq, gap, gap_len);
  cp_async_commit();

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;
  const float scale2 = scale * kLog2e;
  const int n_tiles = (nq + BK - 1) / BK;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();  // tile t (and K, V) have landed
    __syncthreads();      // ... for every thread; and every warp is done with tile t-1
    if (t + 1 < n_tiles) {
      const int nb = (t + 1) & 1;
      copy_rows<DH>(qs + nb * L::TILE, q, (t + 1) * BK, nq, gap, gap_len);
      copy_rows<DH>(dos + nb * L::TILE, dout, (t + 1) * BK, nq, gap, gap_len);
      copy_row_scalars(sc + nb * 2 * BK, lse, dvec, (t + 1) * BK, nq, gap, gap_len);
      cp_async_commit();
    }
    if (!live) continue;
    const bf16* qt = qs + (t & 1) * L::TILE;
    const bf16* dot = dos + (t & 1) * L::TILE;
    const float* lt = sc + (t & 1) * 2 * BK;

    // S^T = K Q^T and dP^T = V dO^T: rows are this warp's keys, columns 8
    // blocks of 8 query rows
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nb][e] = dpt[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t kf[4], vf[4];
      ldsm_x4(kf, ks + (warp * 16 + (lane & 15)) * LD + 16 * kk + 8 * (lane >> 4));
      ldsm_x4(vf, vs + (warp * 16 + (lane & 15)) * LD + 16 * kk + 8 * (lane >> 4));
#pragma unroll
      for (int nb = 0; nb < 8; nb += 2) {
        const int off = (8 * nb + (lane & 7) + 8 * (lane >> 4)) * LD + 16 * kk +
                        8 * ((lane >> 3) & 1);
        uint32_t b[4];
        ldsm_x4(b, qt + off);
        mma_bf16(st[nb], kf, b[0], b[1]);
        mma_bf16(st[nb + 1], kf, b[2], b[3]);
        ldsm_x4(b, dot + off);
        mma_bf16(dpt[nb], vf, b[0], b[1]);
        mma_bf16(dpt[nb + 1], vf, b[2], b[3]);
      }
    }

    // P^T into st, dS^T = P^T (dP^T - dvec) into dpt, float32
    const int x0 = t * BK;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int y = 8 * nb + 2 * tq + c;  // query row in the tile
        const bool past = x0 + BK > nq && x0 + y >= nq;
        const float l2 = lt[y] * kLog2e, dvy = lt[BK + y];
        const float pa = past ? 0.f : exp2f(fmaf(st[nb][c], scale2, -l2));
        const float pb = past ? 0.f : exp2f(fmaf(st[nb][2 + c], scale2, -l2));
        st[nb][c] = pa;
        st[nb][2 + c] = pb;
        dpt[nb][c] = pa * (dpt[nb][c] - dvy);
        dpt[nb][2 + c] = pb * (dpt[nb][2 + c] - dvy);
      }
    }

    add_tile_product<DH>(dva, st, dot, lane);  // the tile's bf16(P^T) dO
    add_tile_product<DH>(dka, dpt, qt, lane);  // the tile's bf16(dS^T) Q
  }

  if (!live) return;
  const int r = warp * 16 + g;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const int col = 8 * d + 2 * tq;
    if (r < n_live) {
      *reinterpret_cast<__nv_bfloat162*>(dk + (size_t)r * DH + col) =
          __floats2bfloat162_rn(dka[d][0] * scale, dka[d][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + (size_t)r * DH + col) =
          __floats2bfloat162_rn(dva[d][0], dva[d][1]);
    }
    if (r + 8 < n_live) {
      *reinterpret_cast<__nv_bfloat162*>(dk + (size_t)(r + 8) * DH + col) =
          __floats2bfloat162_rn(dka[d][2] * scale, dka[d][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + (size_t)(r + 8) * DH + col) =
          __floats2bfloat162_rn(dva[d][2], dva[d][3]);
    }
  }
}

// grid (n_views * tiles, BH): the block owns query rows of view qv and streams
// the other views' keys.
template <int DH>
__global__ void __launch_bounds__(NT, BWD_BLOCKS)
cross_attn_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ dvec,
                              bf16* __restrict__ dq, int S, int n_views, int n_kpts,
                              int tiles, float scale) {
  const size_t base = (size_t)blockIdx.y * S * DH;
  const int qv = blockIdx.x / tiles;
  const int row0 = qv * n_kpts + (blockIdx.x % tiles) * BQ;
  const size_t r = (size_t)blockIdx.y * S + row0;
  bwd_dq_tile<DH>(q + base + (size_t)row0 * DH, k + base, v + base,
                  dout + base + (size_t)row0 * DH, lse + r, dvec + r,
                  dq + base + (size_t)row0 * DH, min(BQ, (qv + 1) * n_kpts - row0),
                  (n_views - 1) * n_kpts, qv * n_kpts, n_kpts, scale);
}

// grid (n_views * tiles, BH): the block owns key rows of view kv and streams
// the other views' queries.
template <int DH>
__global__ void __launch_bounds__(NT, BWD_BLOCKS)
cross_attn_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const bf16* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ dvec, bf16* __restrict__ dk,
                               bf16* __restrict__ dv, int S, int n_views, int n_kpts,
                               int tiles, float scale) {
  const size_t base = (size_t)blockIdx.y * S * DH;
  const int kv = blockIdx.x / tiles;
  const int row0 = kv * n_kpts + (blockIdx.x % tiles) * BQ;
  const size_t own = base + (size_t)row0 * DH;
  bwd_dkv_tile<DH>(q + base, k + own, v + own, dout + base, lse + (size_t)blockIdx.y * S,
                   dvec + (size_t)blockIdx.y * S, dk + own, dv + own,
                   min(BQ, (kv + 1) * n_kpts - row0), (n_views - 1) * n_kpts, kv * n_kpts,
                   n_kpts, scale);
}

// Above 48 KB a block's shared memory is dynamic only; the carveout asks for the
// SM's whole 228 KB, so that as many blocks fit as the registers allow.
template <typename F>
void prepare_smem(F* kernel, size_t bytes) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       (int)cudaSharedmemCarveoutMaxShared);
}

template <int DH, int MODE>
void launch_attn_mode(const bf16* q, const bf16* k, const bf16* v, bf16* o, int BH, int S,
                      int n_kpts, float scale, cudaStream_t st) {
  constexpr size_t bytes = Smem<DH>::bytes;
  prepare_smem(attn_fwd_bf16_kernel<DH, MODE>, bytes);
  const dim3 grid((S + BQ - 1) / BQ, BH);
  attn_fwd_bf16_kernel<DH, MODE><<<grid, NT, bytes, st>>>(q, k, v, o, S, n_kpts, scale);
}

template <int DH>
void launch_attn(const bf16* q, const bf16* k, const bf16* v, bf16* o, int BH, int S,
                 int n_kpts, int mode, float scale, cudaStream_t st) {
  if (mode == kFull)
    launch_attn_mode<DH, kFull>(q, k, v, o, BH, S, n_kpts, scale, st);
  else if (mode == kSelf)
    launch_attn_mode<DH, kSelf>(q, k, v, o, BH, S, n_kpts, scale, st);
  else
    launch_attn_mode<DH, kCross>(q, k, v, o, BH, S, n_kpts, scale, st);
}

// lse == nullptr: cross_attn_fwd_bf16; else cross_attn_fwd_lse_bf16.
template <int DH>
void launch_cross(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int BH,
                  int S, int n_views, int n_kpts, float scale, cudaStream_t st) {
  constexpr size_t bytes = Smem<DH>::bytes;
  const int tiles = (n_kpts + BQ - 1) / BQ;
  const dim3 grid(n_views * tiles, BH);
  if (lse == nullptr) {
    prepare_smem(cross_attn_fwd_bf16_kernel<DH, false>, bytes);
    cross_attn_fwd_bf16_kernel<DH, false><<<grid, NT, bytes, st>>>(
        q, k, v, o, nullptr, S, n_views, n_kpts, tiles, scale);
  } else {
    prepare_smem(cross_attn_fwd_bf16_kernel<DH, true>, bytes);
    cross_attn_fwd_bf16_kernel<DH, true><<<grid, NT, bytes, st>>>(
        q, k, v, o, lse, S, n_views, n_kpts, tiles, scale);
  }
}

// dk == nullptr: the dq kernel (into dq); else the dk/dv kernel (into dk, dv).
template <int DH>
void launch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                const float* lse, const float* dvec, bf16* dq, bf16* dk, bf16* dv, int BH,
                int S, int n_views, int n_kpts, float scale, cudaStream_t st) {
  const int tiles = (n_kpts + BQ - 1) / BQ;
  const dim3 grid(n_views * tiles, BH);
  if (dk == nullptr) {
    constexpr size_t bytes = BwdSmem<DH>::bytes;
    prepare_smem(cross_attn_bwd_dq_bf16_kernel<DH>, bytes);
    cross_attn_bwd_dq_bf16_kernel<DH><<<grid, NT, bytes, st>>>(
        q, k, v, dout, lse, dvec, dq, S, n_views, n_kpts, tiles, scale);
  } else {
    constexpr size_t bytes = BwdSmem<DH>::bytes_scalars;
    prepare_smem(cross_attn_bwd_dkv_bf16_kernel<DH>, bytes);
    cross_attn_bwd_dkv_bf16_kernel<DH><<<grid, NT, bytes, st>>>(
        q, k, v, dout, lse, dvec, dk, dv, S, n_views, n_kpts, tiles, scale);
  }
}

// {blocks per SM, registers, local (spill) bytes per thread, dynamic shared
// bytes, rows per block (query rows; key rows for dk/dv)} of one kernel, as the
// runtime sees it.
template <typename F>
int kernel_info(F* kernel, size_t bytes, int* info) {
  prepare_smem(kernel, bytes);
  cudaFuncAttributes a;
  int blocks = 0;
  if (cudaFuncGetAttributes(&a, kernel) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, NT, bytes) !=
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
  constexpr size_t bytes = Smem<DH>::bytes;
  switch (which) {
    case 0: return kernel_info(attn_fwd_bf16_kernel<DH, kFull>, bytes, info);
    case 1: return kernel_info(attn_fwd_bf16_kernel<DH, kSelf>, bytes, info);
    case 2: return kernel_info(attn_fwd_bf16_kernel<DH, kCross>, bytes, info);
    case 3: return kernel_info(cross_attn_fwd_bf16_kernel<DH, false>, bytes, info);
    case 4: return kernel_info(cross_attn_fwd_bf16_kernel<DH, true>, bytes, info);
    case 5:
      return kernel_info(cross_attn_bwd_dq_bf16_kernel<DH>, BwdSmem<DH>::bytes, info);
    case 6:
      return kernel_info(cross_attn_bwd_dkv_bf16_kernel<DH>, BwdSmem<DH>::bytes_scalars,
                         info);
    default: return -1;
  }
}

bool cross_shape_ok(int BH, int S, int n_views, int n_kpts) {
  return BH >= 1 && BH <= 65535 && n_views >= 2 && n_kpts >= 1 && S == n_views * n_kpts;
}

int cross_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                     int BH, int S, int dh, int n_views, int n_kpts, float scale,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!cross_shape_ok(BH, S, n_views, n_kpts)) return -1;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  switch (dh) {
    case 16: launch_cross<16>(qb, kb, vb, ob, lse, BH, S, n_views, n_kpts, scale, st); break;
    case 32: launch_cross<32>(qb, kb, vb, ob, lse, BH, S, n_views, n_kpts, scale, st); break;
    case 64: launch_cross<64>(qb, kb, vb, ob, lse, BH, S, n_views, n_kpts, scale, st); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

int cross_bwd(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* dvec, void* dq, void* dk, void* dv,
                     int BH, int S, int dh, int n_views, int n_kpts, float scale,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!cross_shape_ok(BH, S, n_views, n_kpts)) return -1;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v), *db = static_cast<const bf16*>(dout);
  bf16 *dqb = static_cast<bf16*>(dq), *dkb = static_cast<bf16*>(dk),
       *dvb = static_cast<bf16*>(dv);
  switch (dh) {
    case 16: launch_bwd<16>(qb, kb, vb, db, lse, dvec, dqb, dkb, dvb, BH, S, n_views, n_kpts, scale, st); break;
    case 32: launch_bwd<32>(qb, kb, vb, db, lse, dvec, dqb, dkb, dvb, BH, S, n_views, n_kpts, scale, st); break;
    case 64: launch_bwd<64>(qb, kb, vb, db, lse, dvec, dqb, dkb, dvb, BH, S, n_views, n_kpts, scale, st); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns 0 on success, -1 for an unsupported head width, mode or shape,
// otherwise the cudaGetLastError() code of the launch.
int attn_fwd_bf16(const void* q, const void* k, const void* v, void* o, int BH, int S,
                  int dh, int n_kpts, int mode, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode < 0 || mode > 2 || BH < 1 || BH > 65535 || S < 1 || n_kpts < 1) return -1;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  switch (dh) {
    case 16: launch_attn<16>(qb, kb, vb, ob, BH, S, n_kpts, mode, scale, st); break;
    case 32: launch_attn<32>(qb, kb, vb, ob, BH, S, n_kpts, mode, scale, st); break;
    case 64: launch_attn<64>(qb, kb, vb, ob, BH, S, n_kpts, mode, scale, st); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

int cross_attn_fwd_bf16(const void* q, const void* k, const void* v, void* o, int BH,
                        int S, int dh, int n_views, int n_kpts, float scale,
                        void* stream) {
  return cross_fwd(q, k, v, o, nullptr, BH, S, dh, n_views, n_kpts, scale, stream);
}

int cross_attn_fwd_lse_bf16(const void* q, const void* k, const void* v, void* o,
                            float* lse, int BH, int S, int dh, int n_views, int n_kpts,
                            float scale, void* stream) {
  if (lse == nullptr) return -1;
  return cross_fwd(q, k, v, o, lse, BH, S, dh, n_views, n_kpts, scale, stream);
}

int cross_attn_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* dvec, void* dq, int BH, int S,
                           int dh, int n_views, int n_kpts, float scale, void* stream) {
  return cross_bwd(q, k, v, dout, lse, dvec, dq, nullptr, nullptr, BH, S, dh, n_views,
                   n_kpts, scale, stream);
}

int cross_attn_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* dvec, void* dk, void* dv,
                            int BH, int S, int dh, int n_views, int n_kpts, float scale,
                            void* stream) {
  if (dk == nullptr || dv == nullptr) return -1;
  return cross_bwd(q, k, v, dout, lse, dvec, nullptr, dk, dv, BH, S, dh, n_views, n_kpts,
                   scale, stream);
}

// Occupancy of a kernel: which = 0, 1, 2 for attn_fwd_bf16 in modes full, self,
// cross; 3 cross_attn_fwd_bf16; 4 cross_attn_fwd_lse_bf16; 5
// cross_attn_bwd_dq_bf16; 6 cross_attn_bwd_dkv_bf16. Fills info[5] (see kernel_info) and returns 0,
// or -1 for an unsupported head width or kernel.
int attn_bf16_kernel_info(int dh, int which, int* info) {
  switch (dh) {
    case 16: return kernel_info_dh<16>(which, info);
    case 32: return kernel_info_dh<32>(which, info);
    case 64: return kernel_info_dh<64>(which, info);
    default: return -1;
  }
}

}  // extern "C"
