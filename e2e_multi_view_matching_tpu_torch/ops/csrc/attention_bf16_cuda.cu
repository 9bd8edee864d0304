// bfloat16 view-structured attention for Hopper (sm_90a), on the tensor cores.
//
// Replaces the bfloat16 instantiations of two Pallas TPU kernels of
// e2e_multi_view_matching_tpu/ops/attention_pallas.py:
//   attn_fwd_bf16       <- _attn_kernel       (one-shot masked softmax attention, mask
//                                               "full" | "self" | "cross" built from
//                                               token indices, -1e9 fill)
//   cross_attn_fwd_bf16 <- _cross_attn_kernel (online softmax over the other V-1 views'
//                                               keys; the own view's keys are never read)
// The float32 kernels stay in attention_cuda.cu.
//
// Layout: q, k, v, o are (BH, S, DH) contiguous bfloat16, heads already split.
//
// Arithmetic, as the Pallas bodies have it for bfloat16 q, k, v: S = Q K^T in
// float32 from the bfloat16 inputs (each product of two bfloat16 values is exact
// in float32), times the scale in float32; P = exp(S - m) in float32; O = P V with
// P kept in float32; O / (l + 1e-9) rounded to bfloat16 once. Plain version:
// ops/attention_cuda.py::plain_view_attention (q, k, v upcast to float32, the
// float32 masked attention, the output rounded to bfloat16).
//
// What bounds it on an H100: the tensor cores' bf16 rate (989 TFLOP/s dense) for
// QK^T and PV, and the exponentials (one a score, 4.18e12/s on the SFUs); device
// memory is far below both (each block streams its keys once from L2).
//
// Design: FlashAttention-2 style on mma.sync.m16n8k16 (bf16 in, f32 accumulate).
// 4 warps own 64 query rows, 16 each; a warp reads its Q fragments from shared
// memory with ldmatrix once per key tile (DH/16 k-steps). K and V go through
// shared memory in tiles of 64 keys with cp.async, double-buffered (tile t+1
// lands while tile t is computed), rows padded by 8 bf16 so that ldmatrix reads
// conflict-free; K is read with ldmatrix as the B operand of S = Q K^T, V with
// ldmatrix.trans as the B operand of PV.
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
// the gate's 2^-18 (ops/attention_cuda.py::BF16_SUM_TOL).
//   Cross kernel: every query tile lies inside one view, and the keys are the
// other views' as one virtual range of (V-1) K keys with the own view cut out.
//   Registers: S (32), O and the tile's accumulator (2 x DH/2), Q fragments
// (DH/4) and the P terms; built for 3 blocks per SM (<= 168 registers a
// thread), no spills. Shared memory at DH = 64: Q 9 KB, K and V 2 x 2 x 9 KB:
// 45 KB.

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
constexpr int MIN_BLOCKS = 3;   // blocks per SM the registers are sized for
constexpr float kNegInf = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;

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

// 16-byte global -> shared copy, zero-filled (nothing read) when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
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
// the cross kernel passes kFull and cuts its own view out of the range).
template <int DH, int MODE>
__device__ __forceinline__ void fwd_tile(const bf16* __restrict__ q,
                                         const bf16* __restrict__ k,
                                         const bf16* __restrict__ v, bf16* __restrict__ o,
                                         int row0, int n_live, int nkeys, int gap,
                                         int gap_len, int n_kpts, float scale) {
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
}

// grid (ceil(S / BQ), BH): every query attends all S keys under the mask.
template <int DH, int MODE>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
attn_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int S, int n_kpts,
                     float scale) {
  const size_t base = (size_t)blockIdx.y * S * DH;
  const int row0 = blockIdx.x * BQ;
  fwd_tile<DH, MODE>(q + base, k + base, v + base, o + base, row0, min(BQ, S - row0), S,
                     INT_MAX, 0, n_kpts, scale);
}

// grid (n_views * tiles, BH) with tiles = ceil(n_kpts / BQ) query tiles per view,
// the last one ragged. The keys are the (V-1) K of the other views: the virtual
// key x is key x, or x + K from the query's own view qv on.
template <int DH>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
cross_attn_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                           int n_views, int n_kpts, int tiles, float scale) {
  const size_t base = (size_t)blockIdx.y * S * DH;
  const int qv = blockIdx.x / tiles;
  const int r0 = (blockIdx.x % tiles) * BQ;  // first row within the view
  fwd_tile<DH, kFull>(q + base, k + base, v + base, o + base, qv * n_kpts + r0,
                      min(BQ, n_kpts - r0), (n_views - 1) * n_kpts, qv * n_kpts, n_kpts,
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

template <int DH>
void launch_cross(const bf16* q, const bf16* k, const bf16* v, bf16* o, int BH, int S,
                  int n_views, int n_kpts, float scale, cudaStream_t st) {
  constexpr size_t bytes = Smem<DH>::bytes;
  prepare_smem(cross_attn_fwd_bf16_kernel<DH>, bytes);
  const int tiles = (n_kpts + BQ - 1) / BQ;
  const dim3 grid(n_views * tiles, BH);
  cross_attn_fwd_bf16_kernel<DH><<<grid, NT, bytes, st>>>(q, k, v, o, S, n_views, n_kpts,
                                                          tiles, scale);
}

// {blocks per SM, registers, local (spill) bytes per thread, dynamic shared
// bytes, query rows per block} of one kernel, as the runtime sees it.
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
    case 3: return kernel_info(cross_attn_fwd_bf16_kernel<DH>, bytes, info);
    default: return -1;
  }
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH < 1 || BH > 65535 || n_views < 2 || n_kpts < 1 || S != n_views * n_kpts)
    return -1;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  switch (dh) {
    case 16: launch_cross<16>(qb, kb, vb, ob, BH, S, n_views, n_kpts, scale, st); break;
    case 32: launch_cross<32>(qb, kb, vb, ob, BH, S, n_views, n_kpts, scale, st); break;
    case 64: launch_cross<64>(qb, kb, vb, ob, BH, S, n_views, n_kpts, scale, st); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

// Occupancy of a kernel: which = 0, 1, 2 for attn_fwd_bf16 in modes full, self,
// cross; 3 cross_attn_fwd_bf16. Fills info[5] (see kernel_info) and returns 0,
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
