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
// also stores m + log(l + 1e-9) in float32. The kernels work in base 2 (log2 e
// folded into the scale); as in the TPU kernels masked scores are -1e9 (times
// log2 e), m starts there, and keys past the range weigh exactly 0 (-INFINITY).
// Plain versions:
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
// the products (2 a (query, key) pair in the forward as SDPA computes it, 4 in
// these forwards with P as three bf16 terms, 3 in dq, 4 in dk/dv), and the
// exponentials (one a pair, 4.18e12/s on the SFUs); device memory is far below
// both (each block streams its keys, or queries, once from L2).
//
// P V with P in float32 on bf16 tensor cores: P = P_hi + P_mid + P_lo, three
// bfloat16 terms that together hold P's 24 significant bits exactly (each term is
// the round-to-nearest of what the ones before it left), built straight from the S
// accumulator layout, which is the A-operand layout of the next product. Three
// products into one float32 accumulator then give P V with exact products, as the
// Pallas kernel's float32 dot does. (Two terms would leave up to 2^-16 |P| of each
// weight out: below an output's bf16 ulp on average, but not on the outputs that
// cancel to near 0.) A tile's P V goes into a fresh accumulator, which is added to
// O in float32 (O = O alpha + tile): the tensor cores' float32 accumulation aligns
// to the largest term and drops the bits below, so a running O over all keys
// drifted up to ~1.5e-6 of sum p |v| / l (4e-6 absolute at |v| ~ 2 on an output
// that cancels to ~2e-5: 3.5 bf16 ulps there); 12 accumulations a 64-key tile from
// 0 leave ~7e-7 of it (~2^-20), inside the gate's 2^-18
// (ops/attention_cuda.py::BF16_SUM_TOL). The backward kernels keep running
// sums instead (dQ; dK and dV): one float32 accumulator a gradient over all
// the streamed tiles, 4 k-steps of 16 a tile, in the walk's order; their gate,
// widened by the flips of the rounded p and ds, held with the same worst
// reading at the ragged shapes as fresh sums a tile did for dk/dv (PERF.md,
// section 6).
//
// attn_fwd_bf16, cross_attn_fwd_bf16 and cross_attn_fwd_lse_bf16 (the Hopper
// design, `hopper_fwd`; the LSE kernel stores m ln 2 + log(l + 1e-9) in its
// epilogue): a persistent grid of one 384-thread block per SM walks the work
// items of 128 query rows (two consumer warpgroups of 64 rows each) in a fixed
// order; a producer warp keeps TMA loads in flight: a work item's Q once, into one
// of two buffers, and the K and V tiles of 64 keys through a ring of 4
// shared-memory stages, each with a full and an empty mbarrier. Tiles are swizzled
// to the row width (128 B at DH = 64, 64 B at 32, 32 B at 16), as wgmma reads
// them. S = Q K^T is wgmma.m64n64k16 with both operands in shared memory; P V is
// wgmma.m64nDHk16 with P's three terms as the register A operand and V read
// MN-major (transposed). The two consumer warpgroups take turns on the tensor
// cores (named barriers): in its turn a warpgroup issues this tile's Q K^T and
// then the last tile's P V, hands the turn over, takes the scores' maximum and
// exponentials while its P V runs, then O's update and the split of P while the
// other warpgroup's products run. setmaxnreg gives the producer 40 registers and
// the consumers 232. In mode full the scale joins the exponent's FMA (ex2.approx:
// the SFU's exp2, exp2f's range test and subnormal scaling cost 3 instructions a
// score). The masked kernel compares each key index with the query view's bounds
// [qv K, (qv + 1) K), computed once a work item; the cross kernels walk the other
// views one at a time, each in 64-key tiles whose keys past the view's end (read
// from the next view, or zero-filled past S) weigh exactly 0. Rows past a view's
// or the slice's end are computed and not stored. No atomics: the same bits on
// every run. On the H100 the products with the softmax's ~13 instructions a score
// reach ~47% of the 4-product floor; the products alone ~60% (m64n64 tiles, dh =
// 64).
//
// cross_attn_bwd_dkv_bf16 and cross_attn_bwd_dq_bf16 (the Hopper design of
// the backward, `cross_attn_bwd_dkv_bf16_kernel`, `cross_attn_bwd_dq_bf16_kernel`):
// the same block shape and persistent grid, and one walk (`BwdWalk`): a work
// item is 128 rows inside one view, loaded once by TMA, against the other
// views' rows, streamed in tiles of 64 as the two ranges before and after the
// own view. dk/dv owns key rows (K and V, moved into registers as the A
// operands of its scores) and streams Q, dO, LSE and dvec; S^T = K Q^T and
// dP^T = V dO^T come out with the keys as rows, so P^T and dS^T are already
// the register A operand of dV += bf16(P^T) dO and dK += bf16(dS^T) Q. On the
// H100 its m64n64k16 products run at ~53% of peak and p and ds add ~35%. dq
// owns query rows (Q and dO, which stay in shared memory as the A operands of
// its scores, and its rows' LSE and dvec, loaded once an item) and streams K
// and V: S = Q K^T and dP = dO V^T, p and ds in float32 with the keys past a
// tile's range set to weigh 0, and dQ += bf16(dS) K with the packed dS as the
// register A operand and K read MN-major from the tile S came from: 3
// products a pair, one wait a tile (see the kernels).
//
// The tensor maps are encoded on the host at each call (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so the library links no libcuda) and
// passed as __grid_constant__ parameters; a base address that is not 16-byte
// aligned cannot be mapped and returns -2.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;          // keys per tile (every kernel)
constexpr float kNegInf = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

enum Mode { kFull = 0, kSelf = 1, kCross = 2 };

// Four 8x8 bf16 matrices from shared memory at address a; lane i gives the
// address of row i % 8 of matrix i / 8, and receives row lane / 4, columns
// 2 (lane % 4) + {0, 1} of each: a warp's 16 x 16 A fragment of a wgmma (or
// mma) product.
__device__ __forceinline__ void ldsm_x4_at(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// ---- attn_fwd_bf16 and cross_attn_fwd_bf16: TMA, wgmma, warp-specialised ----

constexpr int HW_THREADS = 384;  // warpgroup 0 the producer, 1 and 2 the consumers
constexpr int HW_ROWS = 128;     // query rows of a work item, 64 a consumer warpgroup
constexpr int HW_STAGES = 4;     // K/V tiles of 64 keys in flight
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;  // 40 x 128 + 232 x 256 <= 65536

// Shared-memory layout in bytes from a 1024-aligned base: two Q buffers of two
// 64-row halves (one a consumer warpgroup), HW_STAGES K tiles, HW_STAGES V tiles,
// each 64 rows of 2 DH bytes swizzled to the row width, then the mbarriers.
template <int DH>
struct HSmem {
  static constexpr int ROW = 2 * DH;    // bytes of a row, the swizzle span
  static constexpr int TILE = 64 * ROW;  // a Q half, a K or a V tile
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + 4 * TILE;
  static constexpr int v_off = k_off + HW_STAGES * TILE;
  static constexpr int bar_off = v_off + HW_STAGES * TILE;
  static constexpr int n_bars = 2 * HW_STAGES + 4;  // full, empty a stage; full, empty a Q buffer
  static constexpr size_t bytes = 1024 + bar_off + 8 * n_bars;  // + the base's alignment
  // wgmma descriptor: layout type (1: 128 B swizzle, 2: 64 B, 3: 32 B) and the
  // stride between 8-row groups
  static constexpr uint64_t layout = DH == 64 ? 1 : DH == 32 ? 2 : 3;
  static constexpr uint32_t group = 8 * ROW;
  static_assert(DH == 16 || DH == 32 || DH == 64, "head widths 16, 32, 64");
  static_assert(TILE % 1024 == 0, "tiles aligned to the 128 B swizzle's 1024 B atom");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor of a swizzled tile at addr (16-byte units of the
// start address, leading offset 1 (unused by these layouts), stride `group`).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint64_t layout, uint32_t group) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(group >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the phase of `parity` has completed (parity 1 on a fresh barrier:
// at once). A wait past ~10 s of SM clock traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > 20000000000LL) __trap();
  }
}

// 64 rows from `row` of slice bh into the shared tile at dst, swizzled as the map
// says (rows past S zero-filled); completes `bytes` on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(row), "r"(bh)
      : "memory");
}

// The two consumer warpgroups' turns on the tensor cores: barrier 1 + c is
// warpgroup c's (its 128 threads sync, the other's 128 arrive).
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups of this warpgroup's products are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// 2^x on the SFU (ex2.approx.ftz: the hardware's exp2, subnormal results flushed
// to 0; exp2f adds a range test and two multiplies a call to keep them). A
// weight below 2^-126 of the row's largest is 0 either way in a bf16 output.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (lo, hi) rounded to bfloat16, packed as one A-operand register (lo in the low
// half).
__device__ __forceinline__ uint32_t cvt_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// split3 on packed registers: each term rounds what the ones before it left,
// the halves read back by a shift and a mask (the bf16 intrinsics' struct costs
// byte permutes here).
__device__ __forceinline__ void split3_bf16x2(float x, float y, uint32_t& hi, uint32_t& mid,
                                              uint32_t& lo) {
  hi = cvt_bf16x2(x, y);
  x -= __uint_as_float(hi << 16);
  y -= __uint_as_float(hi & 0xffff0000u);
  mid = cvt_bf16x2(x, y);
  x -= __uint_as_float(mid << 16);
  y -= __uint_as_float(mid & 0xffff0000u);
  lo = cvt_bf16x2(x, y);
}

// Two floats from shared memory at addr (8-byte aligned): a 32-bit address
// instead of a generic pointer, one register fewer where registers are scarce.
__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts_f32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

// Keeps the compiler from moving reads (and writes) of r across the waits.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64 f32) = [d +] A B: A (64 x 16) and B (16 x 64) both K-major in shared
// memory (S = Q K^T: K's rows are B's columns).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 16 f32) = [d +] A B: A (64 x 16 bf16) from registers, B (16 x 16)
// MN-major in shared memory (P V: V's rows are B's rows, read transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[8], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
}

// d (64 x 32 f32) = [d +] A B: A (64 x 16 bf16) from registers, B (16 x 32)
// MN-major in shared memory (P V: V's rows are B's rows, read transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[16], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
}

// d (64 x 64 f32) = [d +] A B: A (64 x 16 bf16) from registers, B (16 x 64) in
// shared memory, MN-major with TRANS_B = 1 (P V: V's rows are B's rows, read
// transposed), K-major with 0 (S^T = K Q^T: Q's rows are B's columns).
template <int TRANS_B = 1>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

// attn_fwd_bf16's walk: work items of 128 rows over all S rows of each slice
// (item i: slice i / row_tiles); every item takes the keys [0, S) in 64-key tiles.
struct SelfWalk {
  int S, row_tiles, n_tiles;
  __device__ void item(int i, int& bh, int& row0, int& n_live) const {
    bh = i / row_tiles;
    row0 = (i - bh * row_tiles) * HW_ROWS;
    n_live = min(HW_ROWS, S - row0);
  }
  __device__ int key0(int t) const { return t * BK; }
  __device__ int valid(int t) const { return min(BK, S - t * BK); }
};

// cross_attn_fwd_bf16's walk: work items of 128 rows inside one view qv (the
// last of a view ragged; item i: slice i / (n_views row_tiles)); the keys of the
// other views, one view at a time, each in view_tiles = ceil(K / 64) tiles.
struct CrossWalk {
  int n_views, n_kpts, row_tiles, view_tiles, n_tiles, qv;
  __device__ void item(int i, int& bh, int& row0, int& n_live) {
    const int per = n_views * row_tiles;
    bh = i / per;
    const int rest = i - bh * per;
    qv = rest / row_tiles;
    const int r0 = (rest - qv * row_tiles) * HW_ROWS;  // first row within the view
    row0 = qv * n_kpts + r0;
    n_live = min(HW_ROWS, n_kpts - r0);
  }
  __device__ int key0(int t) const {
    const int vi = t / view_tiles;
    return (vi + (vi >= qv)) * n_kpts + (t - vi * view_tiles) * BK;
  }
  __device__ int valid(int t) const {
    return min(BK, n_kpts - (t - t / view_tiles * view_tiles) * BK);
  }
};

// The Hopper forward: the work items of `walk` from blockIdx.x on, gridDim.x
// apart, under the mask MODE over the key index (attn_fwd's modes; the cross
// kernels pass kFull). o is (BH, S, DH); qm, km, vm map q, k, v. With LSE the
// epilogue also stores lse[row] = m ln 2 + log(l + 1e-9) (lse (BH, S) float32).
template <int DH, int MODE, bool LSE, typename Walk>
__device__ __forceinline__ void hopper_fwd(const CUtensorMap* qm, const CUtensorMap* km,
                                           const CUtensorMap* vm, bf16* __restrict__ o,
                                           float* __restrict__ lse, Walk walk, int S,
                                           int n_kpts, float scale, int n_items) {
  using L = HSmem<DH>;
  constexpr int R = DH / 2;  // accumulator registers of a 64 x DH tile
  extern __shared__ __align__(16) unsigned char hw_smem[];
  const uint32_t base = (smem_u32(hw_smem) + 1023u) & ~1023u;
  // mbarriers: full and empty of each stage, full and empty of each Q buffer
  const uint32_t full0 = base + L::bar_off, empty0 = full0 + 8 * HW_STAGES;
  const uint32_t qfull0 = empty0 + 8 * HW_STAGES, qempty0 = qfull0 + 16;
  if (threadIdx.x == 0) {
    for (int s = 0; s < HW_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);    // the producer's arrival and the tile's bytes
      mbar_init(empty0 + 8 * s, 8);   // every consumer warp, done with the tile
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(qfull0 + 8 * b, 1);
      mbar_init(qempty0 + 8 * b, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 0) {  // the producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int i = blockIdx.x, u = 0; i < n_items; i += gridDim.x, ++u) {
      int bh, row0, n_live;
      walk.item(i, bh, row0, n_live);
      const int qb = u & 1;  // Q buffer; its (u / 2)-th use waits for the one before
      mbar_wait(qempty0 + 8 * qb, ((u >> 1) & 1) ^ 1);
      mbar_expect_tx(qfull0 + 8 * qb, 2 * L::TILE);
      tma_load(base + L::q_off + 2 * qb * L::TILE, qm, qfull0 + 8 * qb, row0, bh);
      tma_load(base + L::q_off + (2 * qb + 1) * L::TILE, qm, qfull0 + 8 * qb, row0 + 64, bh);
      for (int t = 0; t < walk.n_tiles; ++t) {
        const int key0 = walk.key0(t);
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        mbar_expect_tx(full0 + 8 * stage, 2 * L::TILE);
        tma_load(base + L::k_off + stage * L::TILE, km, full0 + 8 * stage, key0, bh);
        tma_load(base + L::v_off + stage * L::TILE, vm, full0 + 8 * stage, key0, bh);
        if (++stage == HW_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int c = wg - 1;  // consumer c owns rows 64 c .. 64 c + 63 of a work item
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;  // rows g, g + 8 of the warp's 16; columns 2 tq + {0, 1}
  const int r = 64 * c + 16 * warp + g;    // this thread's rows r and r + 8 of an item
  const float scale2 = scale * kLog2e;     // scores in base 2
  float s[32], to[R], acc[R];              // scores; the pending tile's P V; O
  uint32_t ph[16], pm[16], pl[16];         // P's three terms, the A operand of P V
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = 0.f;
#pragma unroll
  for (int e = 0; e < R; ++e) to[e] = 0.f;
  int stage = 0, rstage = 0;  // the tile for the next S; the tile whose P V is pending
  uint32_t phase = 0;
  if (c == 1) turn_pass(1);  // consumer 0 takes the first turn

  for (int i = blockIdx.x, u = 0; i < n_items; i += gridDim.x, ++u) {
    int bh, row0, n_live;
    walk.item(i, bh, row0, n_live);
    const int qb = u & 1;
    const uint64_t qd = smem_desc(base + L::q_off + (2 * qb + c) * L::TILE, L::layout, L::group);
    int lo0 = 0, lo1 = 0;  // masked modes: the first keys of rows r's and r + 8's views
    if (MODE != kFull) {
      lo0 = (row0 + r) / n_kpts * n_kpts;
      lo1 = (row0 + r + 8) / n_kpts * n_kpts;
    }
    float m0 = kNegInf * kLog2e, m1 = kNegInf * kLog2e, l0 = 0.f, l1 = 0.f;
    float al0 = 1.f, al1 = 1.f, pal0 = 1.f, pal1 = 1.f;  // alpha of the new, the pending tile
#pragma unroll
    for (int e = 0; e < R; ++e) acc[e] = 0.f;

    // P V of the pending tile into `to` from 0: 16 keys a k-step (two 8-row
    // groups of V), the three terms of P one after the other
    auto issue_pv = [&]() {
      const uint64_t vd = smem_desc(base + L::v_off + rstage * L::TILE, L::layout, L::group);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint64_t d = vd + ((2 * L::group * j) >> 4);
        wgmma_rs(to, ph[4 * j], ph[4 * j + 1], ph[4 * j + 2], ph[4 * j + 3], d, j > 0);
        wgmma_rs(to, pm[4 * j], pm[4 * j + 1], pm[4 * j + 2], pm[4 * j + 3], d, 1);
        wgmma_rs(to, pl[4 * j], pl[4 * j + 1], pl[4 * j + 2], pl[4 * j + 3], d, 1);
      }
    };
    // S = Q K^T of the tile in `stage`: DH / 16 k-steps of 32 bytes along the rows
    auto issue_s = [&]() {
      const uint64_t kd = smem_desc(base + L::k_off + stage * L::TILE, L::layout, L::group);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) wgmma_ss(s, qd + 2 * kk, kd + 2 * kk, kk > 0);
    };
    // O = O alpha + the pending tile's P V, in float32, alpha of the pending tile
    auto update_o = [&]() {
#pragma unroll
      for (int d = 0; d < DH / 8; ++d) {
        acc[4 * d] = fmaf(acc[4 * d], pal0, to[4 * d]);
        acc[4 * d + 1] = fmaf(acc[4 * d + 1], pal0, to[4 * d + 1]);
        acc[4 * d + 2] = fmaf(acc[4 * d + 2], pal1, to[4 * d + 2]);
        acc[4 * d + 3] = fmaf(acc[4 * d + 3], pal1, to[4 * d + 3]);
      }
    };
    // online softmax over tile t's scores in place (rows r: elements 0, 1 of
    // each 8-key block; r + 8: 2, 3): s <- exp2(s scale log2 e - m), alpha, l.
    // Mode full folds the scale into the exponent's FMA (the row maximum of the
    // raw scores times the scale is the maximum of the scaled ones); the masked
    // modes scale first and fill -1e9 (base 2), as the Pallas body does.
    auto scores = [&](int t) {
      const int valid = walk.valid(t);
      float c2 = scale2;  // the factor still to apply to s
      if (MODE != kFull) {
        const int key0 = walk.key0(t);
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = key0 + 8 * nb + 2 * tq + e;
            float a = s[4 * nb + e] * scale2, b = s[4 * nb + 2 + e] * scale2;
            if ((MODE == kSelf) != (x >= lo0 && x < lo0 + n_kpts)) a = kNegInf * kLog2e;
            if ((MODE == kSelf) != (x >= lo1 && x < lo1 + n_kpts)) b = kNegInf * kLog2e;
            s[4 * nb + e] = a;
            s[4 * nb + 2 + e] = b;
          }
        }
        c2 = 1.f;
      }
      if (valid < BK) {  // a ragged tile: keys past the range or the view weigh 0
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (8 * nb + 2 * tq + e >= valid) s[4 * nb + e] = s[4 * nb + 2 + e] = -INFINITY;
      }
      float mx0 = s[0], mx1 = s[2];
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * nb], s[4 * nb + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * nb + 2], s[4 * nb + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0 * c2), mn1 = fmaxf(m1, mx1 * c2);
      al0 = ex2(m0 - mn0);
      al1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        s[4 * nb] = ex2(fmaf(s[4 * nb], c2, -mn0));
        s[4 * nb + 1] = ex2(fmaf(s[4 * nb + 1], c2, -mn0));
        s[4 * nb + 2] = ex2(fmaf(s[4 * nb + 2], c2, -mn1));
        s[4 * nb + 3] = ex2(fmaf(s[4 * nb + 3], c2, -mn1));
        ps0 += s[4 * nb] + s[4 * nb + 1];
        ps1 += s[4 * nb + 2] + s[4 * nb + 3];
      }
      l0 = l0 * al0 + ps0;
      l1 = l1 * al1 + ps1;
    };
    // P's three terms in the A layout of P V (k-step j: key blocks 2j and
    // 2j + 1); the tile is pending from here on
    auto split_p = [&]() {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split3_bf16x2(s[8 * j], s[8 * j + 1], ph[4 * j], pm[4 * j], pl[4 * j]);
        split3_bf16x2(s[8 * j + 2], s[8 * j + 3], ph[4 * j + 1], pm[4 * j + 1], pl[4 * j + 1]);
        split3_bf16x2(s[8 * j + 4], s[8 * j + 5], ph[4 * j + 2], pm[4 * j + 2], pl[4 * j + 2]);
        split3_bf16x2(s[8 * j + 6], s[8 * j + 7], ph[4 * j + 3], pm[4 * j + 3], pl[4 * j + 3]);
      }
      pal0 = al0;
      pal1 = al1;
      rstage = stage;
      if (++stage == HW_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    };

    // Each turn: wait for the tile, take the turn, issue this warpgroup's
    // products (S of the new tile, then P V of the pending one), pass the turn.
    // The new scores' exponentials run under the pending P V, the rest of the
    // softmax under the other warpgroup's products.
    const int n = walk.n_tiles;
    mbar_wait(qfull0 + 8 * qb, (u >> 1) & 1);
    mbar_wait(full0 + 8 * stage, phase);
    turn_wait(1 + c);
    wgmma_fence();
    issue_s();
    wgmma_commit();
    turn_pass(2 - c);
    wgmma_wait<0>();
    fence_regs(s);
    if (n == 1 && lane == 0) mbar_arrive(qempty0 + 8 * qb);  // the item's last S is done
    scores(0);
    split_p();
    for (int t = 1; t < n; ++t) {
      mbar_wait(full0 + 8 * stage, phase);
      turn_wait(1 + c);
      wgmma_fence();
      issue_s();
      wgmma_commit();
      issue_pv();
      wgmma_commit();
      turn_pass(2 - c);
      wgmma_wait<1>();  // S of tile t
      fence_regs(s);
      if (t == n - 1 && lane == 0) mbar_arrive(qempty0 + 8 * qb);
      scores(t);
      fence_regs(s);
      wgmma_wait<0>();  // P V of tile t - 1
      fence_regs(s);
      fence_regs(to);
      if (lane == 0) mbar_arrive(empty0 + 8 * rstage);
      update_o();
      split_p();
    }
    turn_wait(1 + c);
    wgmma_fence();
    issue_pv();
    wgmma_commit();
    turn_pass(2 - c);
    wgmma_wait<0>();
    fence_regs(to);
    if (lane == 0) mbar_arrive(empty0 + 8 * rstage);
    update_o();

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = l0 + 1e-9f, d1 = l1 + 1e-9f;
    bf16* ob = o + ((size_t)bh * S + row0) * DH;
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) {
      const int col = 8 * d + 2 * tq;
      if (r < n_live)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r * DH + col) =
            __floats2bfloat162_rn(acc[4 * d] / d0, acc[4 * d + 1] / d0);
      if (r + 8 < n_live)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)(r + 8) * DH + col) =
            __floats2bfloat162_rn(acc[4 * d + 2] / d1, acc[4 * d + 3] / d1);
    }
    if (LSE && tq == 0) {  // m is in base 2: LSE = m ln 2 + log(l + 1e-9)
      float* lb = lse + (size_t)bh * S + row0;
      if (r < n_live) lb[r] = m0 * kLn2 + logf(d0);
      if (r + 8 < n_live) lb[r + 8] = m1 * kLn2 + logf(d1);
    }
  }
  if (c == 0) turn_wait(1);  // the turn consumer 1 passed after its last products
}

// Persistent grid of min(n_items, SMs) blocks of HW_THREADS: the BH ceil(S / 128)
// work items of SelfWalk; every query attends all S keys under the mask.
template <int DH, int MODE>
__global__ void __launch_bounds__(HW_THREADS, 1)
attn_fwd_bf16_kernel(const __grid_constant__ CUtensorMap qm,
                     const __grid_constant__ CUtensorMap km,
                     const __grid_constant__ CUtensorMap vm, bf16* __restrict__ o, int S,
                     int n_kpts, float scale, int n_items) {
  const SelfWalk walk{S, (S + HW_ROWS - 1) / HW_ROWS, (S + BK - 1) / BK};
  hopper_fwd<DH, MODE, false>(&qm, &km, &vm, o, nullptr, walk, S, n_kpts, scale, n_items);
}

__device__ __forceinline__ CrossWalk cross_walk(int n_views, int n_kpts) {
  const int view_tiles = (n_kpts + BK - 1) / BK;
  return CrossWalk{n_views, n_kpts, (n_kpts + HW_ROWS - 1) / HW_ROWS, view_tiles,
                   (n_views - 1) * view_tiles, 0};
}

// Persistent grid as above: the BH n_views ceil(K / 128) work items of
// CrossWalk; a query attends the (V-1) K keys of the other views.
template <int DH>
__global__ void __launch_bounds__(HW_THREADS, 1)
cross_attn_fwd_bf16_kernel(const __grid_constant__ CUtensorMap qm,
                           const __grid_constant__ CUtensorMap km,
                           const __grid_constant__ CUtensorMap vm, bf16* __restrict__ o,
                           int S, int n_views, int n_kpts, float scale, int n_items) {
  hopper_fwd<DH, kFull, false>(&qm, &km, &vm, o, nullptr, cross_walk(n_views, n_kpts), S,
                               n_kpts, scale, n_items);
}

// cross_attn_fwd_bf16_kernel that also stores the LSE: a kernel symbol of its
// own, so that a profile tells the training forward from the eval one.
template <int DH>
__global__ void __launch_bounds__(HW_THREADS, 1)
cross_attn_fwd_lse_bf16_kernel(const __grid_constant__ CUtensorMap qm,
                               const __grid_constant__ CUtensorMap km,
                               const __grid_constant__ CUtensorMap vm, bf16* __restrict__ o,
                               float* __restrict__ lse, int S, int n_views, int n_kpts,
                               float scale, int n_items) {
  hopper_fwd<DH, kFull, true>(&qm, &km, &vm, o, lse, cross_walk(n_views, n_kpts), S, n_kpts,
                              scale, n_items);
}

// ---- cross_attn_bwd_dkv_bf16 and cross_attn_bwd_dq_bf16: TMA, wgmma,
// warp-specialised ----

constexpr int HB_STAGES = 4;  // Q and dO tiles of 64 query rows in flight
// setmaxnreg of the dk/dv kernel: the block's 168 x 384 registers at launch
// shared as 56 x 128 (producer) + 224 x 256 (consumers). The producer walks
// the query ranges and stores the LSE and dvec, and spilled at the forward's 40
// (dh = 64); a consumer holds dK, dV, S^T, dP^T (4 x 32), the two bf16 A
// operands of the sums (2 x 16) and K's and V's fragments (2 x 16) while the
// products run.
constexpr int HB_PRODUCER_REGS = 56;
constexpr int HB_CONSUMER_REGS = 224;
static_assert(128 * HB_PRODUCER_REGS + 256 * HB_CONSUMER_REGS <= 168 * HW_THREADS,
              "setmaxnreg takes no more than the launch's registers");
// A stage's full barrier: the 32 producer threads, each after its stores of the
// tile's LSE and dvec, and thread 0 once more with the bytes TMA brings.
constexpr int HB_FULL_ARRIVALS = 33;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Shared-memory layout in bytes from a 1024-aligned base: two K/V buffers of
// four 64-row tiles (K's halves, then V's: one half a consumer warpgroup),
// HB_STAGES Q tiles, HB_STAGES dO tiles (each swizzled as HSmem's), a stage's
// 64 LSE log2 e and 64 dvec in float32, then the mbarriers.
template <int DH>
struct BSmem {
  static constexpr int TILE = HSmem<DH>::TILE;
  static constexpr int kv_off = 0;
  static constexpr int q_off = kv_off + 8 * TILE;
  static constexpr int do_off = q_off + HB_STAGES * TILE;
  static constexpr int sc_off = do_off + HB_STAGES * TILE;
  static constexpr int bar_off = sc_off + HB_STAGES * 2 * BK * 4;
  static constexpr int n_bars = 2 * HB_STAGES + 4;  // full, empty a stage; full, empty a K/V buffer
  static constexpr size_t bytes = 1024 + bar_off + 8 * n_bars;
};

// The backward kernels' walk: work items of 128 owned rows inside one view w
// (key rows for dk/dv, query rows for dq; the last of a view ragged; item i:
// slice i / (n_views row_tiles)), each against the other views' rows (query
// rows for dk/dv, keys for dq), streamed as the two contiguous ranges before
// and after the own view, [0, w K) and [(w + 1) K, S), in n_tiles(w) tiles of
// 64 (a tile that straddles into the own view or past S weighs 0 there: 25-26
// tiles at V = 5, K = 400, against 28 one view at a time).
struct BwdWalk {
  int S, n_views, n_kpts, row_tiles;
  __device__ void item(int i, int& bh, int& w, int& row0, int& n_live) const {
    const int per = n_views * row_tiles;
    bh = i / per;
    const int rest = i - bh * per;
    w = rest / row_tiles;
    const int r0 = (rest - w * row_tiles) * HW_ROWS;  // first row within the view
    row0 = w * n_kpts + r0;
    n_live = min(HW_ROWS, n_kpts - r0);
  }
  __device__ int n_tiles(int w) const {
    return cdiv(w * n_kpts, BK) + cdiv(S - (w + 1) * n_kpts, BK);
  }
  // tile t of view w's walk: streamed rows x0 .. x0 + 63, of which the first
  // `valid` weigh
  __device__ void tile(int w, int t, int& x0, int& valid) const {
    const int na = cdiv(w * n_kpts, BK);
    if (t < na) {
      x0 = t * BK;
      valid = min(BK, w * n_kpts - x0);
    } else {
      x0 = (w + 1) * n_kpts + (t - na) * BK;
      valid = min(BK, S - x0);
    }
  }
};

// dk and dv of the cross-view attention on a persistent grid of min(n_items,
// SMs) blocks: the BH n_views ceil(K / 128) work items of BwdWalk from
// blockIdx.x on, gridDim.x apart. qm, km, vm, dom map q, k, v, dO; lse, dvec,
// dk, dv are (BH, S). A producer warp loads an item's K and V once (TMA, into
// one of two buffers) and streams the query tiles through HB_STAGES stages:
// Q and dO by TMA, the LSE and dvec by plain loads of its 32 threads. Those two
// are (BH, S) float32, so a slice's stride is S floats: a multiple of the 16
// bytes a tensor map needs only where 4 divides S, which ragged shapes break.
// The producer also writes what makes a row that must not weigh (the own view,
// past a view or past S) drop out of the arithmetic: LSE +inf (p = exp2(-inf) =
// 0) and dvec 0 (ds = 0 (dp - 0) = 0), so the consumers mask nothing.
// Consumer warpgroup c owns the item's keys 64 c .. 64 c + 63; a warpgroup whose
// keys all lie past the view's end takes its turns and arrivals and computes
// nothing. Per tile: S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16, K and V the
// A operands, loaded into registers once a work item by ldmatrix from the
// swizzled tiles, so that the tensor cores read only Q and dO from shared
// memory; Q and dO K-major B operands), p = exp2(s scale log2 e - lse log2 e)
// and ds = p (dp - dvec) in float32 registers, then dV += bf16(P^T) dO and dK +=
// bf16(dS^T) Q (wgmma m64nDHk16, the rounded accumulators as the register A
// operand, dO and Q MN-major). In its turn a warpgroup issues the tile's S^T
// and dP^T, which queue behind its last tile's sums; it waits for both, frees
// the last tile's stage, takes p and ds while the other warpgroup's products
// run, and issues the tile's two sums straight into dV and dK (running sums:
// one fresh accumulator a tile, all the registers leave room for, would
// serialise dV's sum and dK's behind three waits a tile).
template <int DH>
__global__ void __launch_bounds__(HW_THREADS, 1)
cross_attn_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap qm,
                               const __grid_constant__ CUtensorMap km,
                               const __grid_constant__ CUtensorMap vm,
                               const __grid_constant__ CUtensorMap dom,
                               const float* __restrict__ lse, const float* __restrict__ dvec,
                               bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
                               int n_views, int n_kpts, float scale, int n_items) {
  using L = BSmem<DH>;
  using H = HSmem<DH>;
  constexpr int R = DH / 2;  // accumulator registers of a 64 x DH tile
  extern __shared__ __align__(16) unsigned char hb_smem[];
  const uint32_t base = (smem_u32(hb_smem) + 1023u) & ~1023u;
  // mbarriers: full and empty of each stage, full and empty of each K/V buffer
  const uint32_t full0 = base + L::bar_off, empty0 = full0 + 8 * HB_STAGES;
  const uint32_t kvfull0 = empty0 + 8 * HB_STAGES, kvempty0 = kvfull0 + 16;
  if (threadIdx.x == 0) {
    for (int s = 0; s < HB_STAGES; ++s) {
      mbar_init(full0 + 8 * s, HB_FULL_ARRIVALS);
      mbar_init(empty0 + 8 * s, 8);  // every consumer warp, done with the stage
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(kvfull0 + 8 * b, 1);
      mbar_init(kvempty0 + 8 * b, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const BwdWalk walk{S, n_views, n_kpts, cdiv(n_kpts, HW_ROWS)};
  const int wg = threadIdx.x / 128;

  if (wg == 0) {  // the producer warp: thread 0 issues the TMA loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(HB_PRODUCER_REGS));
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    int stage = 0;
    uint32_t phase = 0;
    for (int i = blockIdx.x, u = 0; i < n_items; i += gridDim.x, ++u) {
      int bh, kv, row0, n_live;
      walk.item(i, bh, kv, row0, n_live);
      const int b = u & 1;  // K/V buffer; its (u / 2)-th use waits for the one before
      if (lane == 0) {
        mbar_wait(kvempty0 + 8 * b, ((u >> 1) & 1) ^ 1);
        mbar_expect_tx(kvfull0 + 8 * b, 4 * L::TILE);
        for (int h = 0; h < 2; ++h) {
          tma_load(base + L::kv_off + (4 * b + h) * L::TILE, &km, kvfull0 + 8 * b, row0 + 64 * h,
                   bh);
          tma_load(base + L::kv_off + (4 * b + 2 + h) * L::TILE, &vm, kvfull0 + 8 * b,
                   row0 + 64 * h, bh);
        }
      }
      const int n = walk.n_tiles(kv);
      for (int t = 0; t < n; ++t) {
        int x0, valid;
        walk.tile(kv, t, x0, valid);
        // rows lane and lane + 32 of the tile, loaded before the wait for the
        // stage so that their latency passes while the consumers finish it
        const size_t row = (size_t)bh * S + x0 + lane;
        const bool w0 = lane < valid, w1 = lane + 32 < valid;
        const float l0 = w0 ? lse[row] : 0.f, l1 = w1 ? lse[row + 32] : 0.f;
        const float v0 = w0 ? dvec[row] : 0.f, v1 = w1 ? dvec[row + 32] : 0.f;
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full0 + 8 * stage, 2 * L::TILE);
          tma_load(base + L::q_off + stage * L::TILE, &qm, full0 + 8 * stage, x0, bh);
          tma_load(base + L::do_off + stage * L::TILE, &dom, full0 + 8 * stage, x0, bh);
        }
        const uint32_t sc = base + L::sc_off + 4 * (stage * 2 * BK + lane);
        sts_f32(sc, w0 ? l0 * kLog2e : INFINITY);
        sts_f32(sc + 4 * 32, w1 ? l1 * kLog2e : INFINITY);
        sts_f32(sc + 4 * BK, v0);
        sts_f32(sc + 4 * (BK + 32), v1);
        mbar_arrive(full0 + 8 * stage);  // releases the stores above
        if (++stage == HB_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(HB_CONSUMER_REGS));
  const int c = wg - 1;  // consumer c owns keys 64 c .. 64 c + 63 of a work item
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;  // keys g, g + 8 of the warp's 16; columns 2 tq + {0, 1}
  const int r = 64 * c + 16 * warp + g;    // this thread's keys r and r + 8 of an item
  const float scale2 = scale * kLog2e;     // scores in base 2
  float st[32], dpt[32], dka[R], dva[R];  // S^T, dP^T; dK, dV
  uint32_t pa[16], da[16];  // bf16(P^T), bf16(dS^T): the sums' A operands
  uint32_t kf[DH / 16][4], vf[DH / 16][4];  // K's and V's A fragments
#pragma unroll
  for (int e = 0; e < 32; ++e) st[e] = dpt[e] = 0.f;
  int stage = 0, pstage = 0;  // the tile for the next S^T, dP^T; the last one
  uint32_t phase = 0;
  if (c == 1) turn_pass(1);  // consumer 0 takes the first turn

  for (int i = blockIdx.x, u = 0; i < n_items; i += gridDim.x, ++u) {
    int bh, kv, row0, n_live;
    walk.item(i, bh, kv, row0, n_live);
    const int b = u & 1;
    const bool live = 64 * c < n_live;  // the same in the whole warpgroup
    const uint32_t ks = base + L::kv_off + (4 * b + c) * L::TILE;  // K's half; V's 2 tiles on
#pragma unroll
    for (int e = 0; e < R; ++e) dka[e] = dva[e] = 0.f;

    // S^T = K Q^T and dP^T = V dO^T of the tile in `stage`: DH / 16 k-steps of
    // 32 bytes along the rows, the two products' steps interleaved (measured
    // no slower than one product's chain after the other's)
    auto issue_sd = [&]() {
      const uint64_t qd = smem_desc(base + L::q_off + stage * L::TILE, H::layout, H::group);
      const uint64_t od = smem_desc(base + L::do_off + stage * L::TILE, H::layout, H::group);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        wgmma_rs<0>(st, kf[kk][0], kf[kk][1], kf[kk][2], kf[kk][3], qd + 2 * kk, kk > 0);
        wgmma_rs<0>(dpt, vf[kk][0], vf[kk][1], vf[kk][2], vf[kk][3], od + 2 * kk, kk > 0);
      }
    };
    // dV += bf16(P^T) dO and dK += bf16(dS^T) Q of the tile in `in`, their
    // steps interleaved as in issue_sd
    auto issue_sums = [&](int in) {
      const uint64_t od = smem_desc(base + L::do_off + in * L::TILE, H::layout, H::group);
      const uint64_t qd = smem_desc(base + L::q_off + in * L::TILE, H::layout, H::group);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t step = (2 * H::group * j) >> 4;
        wgmma_rs(dva, pa[4 * j], pa[4 * j + 1], pa[4 * j + 2], pa[4 * j + 3], od + step, 1);
        wgmma_rs(dka, da[4 * j], da[4 * j + 1], da[4 * j + 2], da[4 * j + 3], qd + step, 1);
      }
    };
    // p into st and ds into dpt, in place (keys r: elements 0, 1 of each 8-query
    // block; r + 8: 2, 3), from the stage's LSE log2 e and dvec
    auto p_ds = [&]() {
      const uint32_t lt = base + L::sc_off + 4 * (stage * 2 * BK + 2 * tq);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const float2 l2 = lds_f2(lt + 4 * 8 * nb);
        const float2 d2 = lds_f2(lt + 4 * (BK + 8 * nb));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float l = e ? l2.y : l2.x, dvy = e ? d2.y : d2.x;
          const float p0 = ex2(fmaf(st[4 * nb + e], scale2, -l));
          const float p1 = ex2(fmaf(st[4 * nb + 2 + e], scale2, -l));
          st[4 * nb + e] = p0;
          st[4 * nb + 2 + e] = p1;
          dpt[4 * nb + e] = p0 * (dpt[4 * nb + e] - dvy);
          dpt[4 * nb + 2 + e] = p1 * (dpt[4 * nb + 2 + e] - dvy);
        }
      }
    };
    // bf16(P^T) and bf16(dS^T) in the A layout of the sums (k-step j: query
    // blocks 2j and 2j + 1)
    auto pack = [&]() {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          pa[4 * j + h] = cvt_bf16x2(st[8 * j + 2 * h], st[8 * j + 2 * h + 1]);
          da[4 * j + h] = cvt_bf16x2(dpt[8 * j + 2 * h], dpt[8 * j + 2 * h + 1]);
        }
    };
    auto next_stage = [&]() {
      pstage = stage;
      if (++stage == HB_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    };

    const int n = walk.n_tiles(kv);
    mbar_wait(kvfull0 + 8 * b, (u >> 1) & 1);
    if (live) {  // this warp's 16 keys, k-step kk: 16-byte chunks 2 kk, 2 kk + 1
      const uint32_t row = 16 * warp + (lane & 15);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t o = row * (2 * DH) + 16 * (2 * kk + (lane >> 4));
        const uint32_t sw = o ^ (((o >> 7) & (DH / 8 - 1)) << 4);  // the TMA swizzle
        ldsm_x4_at(kf[kk], ks + sw);
        ldsm_x4_at(vf[kk], ks + 2 * L::TILE + sw);
      }
    }
    if (lane == 0) mbar_arrive(kvempty0 + 8 * b);  // K, V are in registers
    // S^T, dP^T of tile t queue behind the sums of tile t - 1, which go
    // straight into dV and dK: one wait a tile. The skip of a warpgroup with
    // no live key chooses between two loops: with the products under a branch
    // in one loop, ptxas serialised every wgmma of the kernel (C7518, a
    // wait it inserts on a path it cannot prove warpgroup-uniform).
    if (live) {
      for (int t = 0; t < n; ++t) {
        mbar_wait(full0 + 8 * stage, phase);
        turn_wait(1 + c);
        wgmma_fence();
        issue_sd();
        wgmma_commit();
        turn_pass(2 - c);
        wgmma_wait<0>();  // S^T, dP^T of tile t; the sums of tile t - 1
        fence_regs(st);
        fence_regs(dpt);
        fence_regs(dka);
        fence_regs(dva);
        if (t > 0 && lane == 0) mbar_arrive(empty0 + 8 * pstage);
        p_ds();
        pack();
        wgmma_fence();
        issue_sums(stage);
        wgmma_commit();
        next_stage();
      }
      wgmma_wait<0>();
      fence_regs(dka);
      fence_regs(dva);
    } else {  // the turns and the stages' arrivals only
      for (int t = 0; t < n; ++t) {
        mbar_wait(full0 + 8 * stage, phase);
        turn_wait(1 + c);
        turn_pass(2 - c);
        if (t > 0 && lane == 0) mbar_arrive(empty0 + 8 * pstage);
        next_stage();
      }
    }
    if (lane == 0) mbar_arrive(empty0 + 8 * pstage);

    if (live) {
      bf16* dkb = dk + ((size_t)bh * S + row0) * DH;
      bf16* dvb = dv + ((size_t)bh * S + row0) * DH;
#pragma unroll
      for (int d = 0; d < DH / 8; ++d) {
        const int col = 8 * d + 2 * tq;
        if (r < n_live) {
          *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)r * DH + col) =
              __floats2bfloat162_rn(dka[4 * d] * scale, dka[4 * d + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)r * DH + col) =
              __floats2bfloat162_rn(dva[4 * d], dva[4 * d + 1]);
        }
        if (r + 8 < n_live) {
          *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)(r + 8) * DH + col) =
              __floats2bfloat162_rn(dka[4 * d + 2] * scale, dka[4 * d + 3] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)(r + 8) * DH + col) =
              __floats2bfloat162_rn(dva[4 * d + 2], dva[4 * d + 3]);
        }
      }
    }
  }
  if (c == 0) turn_wait(1);  // the turn consumer 1 passed after its last products
}

constexpr int HQ_STAGES = 4;  // dq: K and V tiles of 64 keys in flight

// The dq kernel's shared memory in bytes from a 1024-aligned base: two Q/dO
// buffers of four 64-row tiles (Q's halves, then dO's: one half a consumer
// warpgroup), HQ_STAGES K tiles, HQ_STAGES V tiles (each swizzled as HSmem's),
// then the mbarriers.
template <int DH>
struct DqSmem {
  static constexpr int TILE = HSmem<DH>::TILE;
  static constexpr int qo_off = 0;
  static constexpr int k_off = qo_off + 8 * TILE;
  static constexpr int v_off = k_off + HQ_STAGES * TILE;
  static constexpr int bar_off = v_off + HQ_STAGES * TILE;
  static constexpr int n_bars = 2 * HQ_STAGES + 4;  // full, empty a stage and a Q/dO buffer
  static constexpr size_t bytes = 1024 + bar_off + 8 * n_bars;
};

// dq of the cross-view attention on a persistent grid of min(n_items, SMs)
// blocks: the BH n_views ceil(K / 128) work items of BwdWalk (128 query rows
// of one view qv) from blockIdx.x on, gridDim.x apart. qm, km, vm, dom map q,
// k, v, dO; lse and dvec are (BH, S) float32, dq (BH, S, DH). The producer's
// thread 0 loads an item's Q and dO once (TMA, into one of two buffers) and
// streams the other views' K and V in tiles of 64 keys through HQ_STAGES
// stages; it needs no other stores, so it takes the forward's 40 registers.
// Consumer warpgroup c owns the item's rows 64 c .. 64 c + 63, its halves of
// the Q and dO tiles, and loads its rows' LSE log2 e and dvec once an item
// with plain loads (a (BH, S) float32 slice's stride breaks TMA's 16-byte rule
// at ragged S); a row past the view's end gets LSE +inf and weighs 0. Per
// tile: S = Q K^T and dP = dO V^T (wgmma m64n64k16, both operands K-major in
// shared memory, as the forward's S), p = exp2(s scale log2 e - lse log2 e)
// and ds = p (dp - dvec) in float32 registers, then dQ += bf16(dS) K (wgmma
// m64nDHk16, the rounded dS the register A operand, K read MN-major from the
// tile S came from). A key past the tile's `valid` (the own view's, or a zero
// row past S, which would give s = 0 and p = exp(-lse) != 0) gets s = -inf,
// so p = 0, in a branch that only the tiles at a range's end take and that
// holds no product. dQ is a running sum. In its turn a warpgroup issues tile
// t's S and dP and then tile t - 1's sum (the first tile has no sum before
// it; the last sum takes a turn of its own), waits for all three, frees tile
// t - 1's stage and takes p and ds while the other warpgroup's products run:
// one wait a tile. A warpgroup whose rows all lie past the view's end takes
// its turns and arrivals in a loop without products. Q and dO as register A
// operands (as dk/dv's K and V) miscompiled at DH = 64 in an earlier form of
// this loop, whose sum was still running across the loop's back edge: ptxas
// gave the packed dS the registers of Q's and dO's last two k-steps, which
// the next tile's products then read (empty-asm fences on them changed
// nothing). In this loop the register form computes the right dq and is
// ~6% faster (tools/torch_attn_bf16_variants.py --kernel dq, `regs_a`), but
// only by ptxas's choice of registers, so Q and dO stay in shared memory.
template <int DH>
__global__ void __launch_bounds__(HW_THREADS, 1)
cross_attn_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap qm,
                              const __grid_constant__ CUtensorMap km,
                              const __grid_constant__ CUtensorMap vm,
                              const __grid_constant__ CUtensorMap dom,
                              const float* __restrict__ lse, const float* __restrict__ dvec,
                              bf16* __restrict__ dq, int S, int n_views, int n_kpts,
                              float scale, int n_items) {
  using L = DqSmem<DH>;
  using H = HSmem<DH>;
  constexpr int R = DH / 2;  // accumulator registers of a 64 x DH tile
  extern __shared__ __align__(16) unsigned char hq_smem[];
  const uint32_t base = (smem_u32(hq_smem) + 1023u) & ~1023u;
  // mbarriers: full and empty of each stage, full and empty of each Q/dO buffer
  const uint32_t full0 = base + L::bar_off, empty0 = full0 + 8 * HQ_STAGES;
  const uint32_t qfull0 = empty0 + 8 * HQ_STAGES, qempty0 = qfull0 + 16;
  if (threadIdx.x == 0) {
    for (int s = 0; s < HQ_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's arrival and the tile's bytes
      mbar_init(empty0 + 8 * s, 8);  // every consumer warp, done with the stage
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(qfull0 + 8 * b, 1);
      mbar_init(qempty0 + 8 * b, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const BwdWalk walk{S, n_views, n_kpts, cdiv(n_kpts, HW_ROWS)};
  const int wg = threadIdx.x / 128;

  if (wg == 0) {  // the producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int i = blockIdx.x, u = 0; i < n_items; i += gridDim.x, ++u) {
      int bh, qv, row0, n_live;
      walk.item(i, bh, qv, row0, n_live);
      const int b = u & 1;  // Q/dO buffer; its (u / 2)-th use waits for the one before
      mbar_wait(qempty0 + 8 * b, ((u >> 1) & 1) ^ 1);
      mbar_expect_tx(qfull0 + 8 * b, 4 * L::TILE);
      for (int h = 0; h < 2; ++h) {
        tma_load(base + L::qo_off + (4 * b + h) * L::TILE, &qm, qfull0 + 8 * b, row0 + 64 * h,
                 bh);
        tma_load(base + L::qo_off + (4 * b + 2 + h) * L::TILE, &dom, qfull0 + 8 * b,
                 row0 + 64 * h, bh);
      }
      const int n = walk.n_tiles(qv);
      for (int t = 0; t < n; ++t) {
        int x0, valid;
        walk.tile(qv, t, x0, valid);
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        mbar_expect_tx(full0 + 8 * stage, 2 * L::TILE);
        tma_load(base + L::k_off + stage * L::TILE, &km, full0 + 8 * stage, x0, bh);
        tma_load(base + L::v_off + stage * L::TILE, &vm, full0 + 8 * stage, x0, bh);
        if (++stage == HQ_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int c = wg - 1;  // consumer c owns rows 64 c .. 64 c + 63 of a work item
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;  // rows g, g + 8 of the warp's 16; columns 2 tq + {0, 1}
  const int r = 64 * c + 16 * warp + g;    // this thread's rows r and r + 8 of an item
  const float scale2 = scale * kLog2e;     // scores in base 2
  float s[32], dp[32], dqa[R];             // S, dP (then p, dS); dQ
  uint32_t da[16];                         // bf16(dS): the sum's A operand
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
  int stage = 0, pstage = 0;  // the tile for the next S, dP; the last one
  uint32_t phase = 0;
  if (c == 1) turn_pass(1);  // consumer 0 takes the first turn

  for (int i = blockIdx.x, u = 0; i < n_items; i += gridDim.x, ++u) {
    int bh, qv, row0, n_live;
    walk.item(i, bh, qv, row0, n_live);
    const int b = u & 1;
    const bool live = 64 * c < n_live;  // the same in the whole warpgroup
    const uint32_t qs = base + L::qo_off + (4 * b + c) * L::TILE;  // Q's half; dO's 2 tiles on
    const uint64_t qd = smem_desc(qs, H::layout, H::group);
    const uint64_t od = smem_desc(qs + 2 * L::TILE, H::layout, H::group);
    // rows r's and r + 8's LSE log2 e and dvec (a row past the view's end: +inf, 0)
    const size_t rr = (size_t)bh * S + row0 + r;
    const float l0 = r < n_live ? lse[rr] * kLog2e : INFINITY;
    const float l1 = r + 8 < n_live ? lse[rr + 8] * kLog2e : INFINITY;
    const float dv0 = r < n_live ? dvec[rr] : 0.f;
    const float dv1 = r + 8 < n_live ? dvec[rr + 8] : 0.f;
#pragma unroll
    for (int e = 0; e < R; ++e) dqa[e] = 0.f;

    // S = Q K^T and dP = dO V^T of the tile in `stage`: DH / 16 k-steps of 32
    // bytes along the rows, the two products' steps interleaved
    auto issue_sd = [&]() {
      const uint64_t kd = smem_desc(base + L::k_off + stage * L::TILE, H::layout, H::group);
      const uint64_t vd = smem_desc(base + L::v_off + stage * L::TILE, H::layout, H::group);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        wgmma_ss(s, qd + 2 * kk, kd + 2 * kk, kk > 0);
        wgmma_ss(dp, od + 2 * kk, vd + 2 * kk, kk > 0);
      }
    };
    // dQ += bf16(dS) K of the tile in `in`: 16 keys a k-step (two 8-row
    // groups of K, read MN-major)
    auto issue_sum = [&](int in) {
      const uint64_t kd = smem_desc(base + L::k_off + in * L::TILE, H::layout, H::group);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_rs(dqa, da[4 * j], da[4 * j + 1], da[4 * j + 2], da[4 * j + 3],
                 kd + ((2 * H::group * j) >> 4), 1);
    };
    // p and ds = p (dp - dvec) into dp, in place (rows r: elements 0, 1 of
    // each 8-key block; r + 8: 2, 3); keys from `valid` on weigh 0
    auto p_ds = [&](int valid) {
      if (valid < BK) {
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (8 * nb + 2 * tq + e >= valid) s[4 * nb + e] = s[4 * nb + 2 + e] = -INFINITY;
      }
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p0 = ex2(fmaf(s[4 * nb + e], scale2, -l0));
          const float p1 = ex2(fmaf(s[4 * nb + 2 + e], scale2, -l1));
          dp[4 * nb + e] = p0 * (dp[4 * nb + e] - dv0);
          dp[4 * nb + 2 + e] = p1 * (dp[4 * nb + 2 + e] - dv1);
        }
      }
    };
    // bf16(dS) in the A layout of the sum (k-step j: key blocks 2j and 2j + 1)
    auto pack = [&]() {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 4; ++h)
          da[4 * j + h] = cvt_bf16x2(dp[8 * j + 2 * h], dp[8 * j + 2 * h + 1]);
    };
    auto next_stage = [&]() {
      pstage = stage;
      if (++stage == HQ_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    };

    const int n = walk.n_tiles(qv);
    mbar_wait(qfull0 + 8 * b, (u >> 1) & 1);
    // As dk/dv, the skip of a warpgroup with no live row chooses between two
    // loops: no wgmma under a branch ptxas cannot prove warpgroup-uniform.
    if (live) {
      int x0, valid;
      walk.tile(qv, 0, x0, valid);
      mbar_wait(full0 + 8 * stage, phase);
      turn_wait(1 + c);
      wgmma_fence();
      issue_sd();
      wgmma_commit();
      turn_pass(2 - c);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      p_ds(valid);
      pack();
      next_stage();
      for (int t = 1; t < n; ++t) {
        walk.tile(qv, t, x0, valid);
        mbar_wait(full0 + 8 * stage, phase);
        turn_wait(1 + c);
        wgmma_fence();
        issue_sd();
        wgmma_commit();
        issue_sum(pstage);
        wgmma_commit();
        turn_pass(2 - c);
        wgmma_wait<0>();  // S, dP of tile t; the sum of tile t - 1
        fence_regs(s);
        fence_regs(dp);
        fence_regs(dqa);
        if (lane == 0) mbar_arrive(empty0 + 8 * pstage);
        p_ds(valid);
        pack();
        next_stage();
      }
      turn_wait(1 + c);
      wgmma_fence();
      issue_sum(pstage);
      wgmma_commit();
      turn_pass(2 - c);
      wgmma_wait<0>();
      fence_regs(dqa);
    } else {  // the turns and the stages' arrivals only
      for (int t = 0; t < n; ++t) {
        mbar_wait(full0 + 8 * stage, phase);
        turn_wait(1 + c);
        turn_pass(2 - c);
        if (t > 0 && lane == 0) mbar_arrive(empty0 + 8 * pstage);
        next_stage();
      }
      turn_wait(1 + c);  // the turn of the last tile's sum
      turn_pass(2 - c);
    }
    if (lane == 0) {
      mbar_arrive(empty0 + 8 * pstage);
      mbar_arrive(qempty0 + 8 * b);  // the item's last S and dP are done
    }

    if (live) {
      bf16* dqb = dq + ((size_t)bh * S + row0) * DH;
#pragma unroll
      for (int d = 0; d < DH / 8; ++d) {
        const int col = 8 * d + 2 * tq;
        if (r < n_live)
          *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)r * DH + col) =
              __floats2bfloat162_rn(dqa[4 * d] * scale, dqa[4 * d + 1] * scale);
        if (r + 8 < n_live)
          *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)(r + 8) * DH + col) =
              __floats2bfloat162_rn(dqa[4 * d + 2] * scale, dqa[4 * d + 3] * scale);
      }
    }
  }
  if (c == 0) turn_wait(1);  // the turn consumer 1 passed after its last products
}

// Above 48 KB a block's shared memory is dynamic only; the carveout asks for the
// SM's whole 228 KB, so that as many blocks fit as the registers allow.
template <typename F>
void prepare_smem(F* kernel, size_t bytes) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       (int)cudaSharedmemCarveoutMaxShared);
}

// SMs of the current device: the persistent grids' size.
int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the runtime has loaded (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                            cudaEnableDefault, &found);
#else
    const cudaError_t rc =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The TMA map of a (BH, S, DH) bfloat16 tensor at ptr, read in boxes of 64 rows of
// one slice, swizzled to the row width (2 DH bytes); rows past S read as zeros.
// False where it cannot be made (a base address not 16-byte aligned).
bool make_map(CUtensorMap* map, const void* ptr, int BH, int S, int DH) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)DH, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)DH * 2, (cuuint64_t)S * DH * 2};  // bytes
  const cuuint32_t box[3] = {(cuuint32_t)DH, 64, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = DH == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : DH == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool make_maps(CUtensorMap* maps, const void* q, const void* k, const void* v, int BH,
               int S, int DH) {
  return make_map(&maps[0], q, BH, S, DH) && make_map(&maps[1], k, BH, S, DH) &&
         make_map(&maps[2], v, BH, S, DH);
}

template <int DH, int MODE>
int launch_attn_mode(const void* q, const void* k, const void* v, bf16* o, int BH, int S,
                     int n_kpts, float scale, cudaStream_t st) {
  CUtensorMap maps[3];
  if (!make_maps(maps, q, k, v, BH, S, DH)) return -2;
  constexpr size_t bytes = HSmem<DH>::bytes;
  prepare_smem(attn_fwd_bf16_kernel<DH, MODE>, bytes);
  const int items = BH * ((S + HW_ROWS - 1) / HW_ROWS);
  attn_fwd_bf16_kernel<DH, MODE><<<min(items, sm_count()), HW_THREADS, bytes, st>>>(
      maps[0], maps[1], maps[2], o, S, n_kpts, scale, items);
  return 0;
}

template <int DH>
int launch_attn(const void* q, const void* k, const void* v, bf16* o, int BH, int S,
                int n_kpts, int mode, float scale, cudaStream_t st) {
  if (mode == kFull) return launch_attn_mode<DH, kFull>(q, k, v, o, BH, S, n_kpts, scale, st);
  if (mode == kSelf) return launch_attn_mode<DH, kSelf>(q, k, v, o, BH, S, n_kpts, scale, st);
  return launch_attn_mode<DH, kCross>(q, k, v, o, BH, S, n_kpts, scale, st);
}

// lse == nullptr: cross_attn_fwd_bf16; else cross_attn_fwd_lse_bf16 (both the
// Hopper kernel).
template <int DH>
int launch_cross(const void* q, const void* k, const void* v, bf16* o, float* lse, int BH,
                 int S, int n_views, int n_kpts, float scale, cudaStream_t st) {
  CUtensorMap maps[3];
  if (!make_maps(maps, q, k, v, BH, S, DH)) return -2;
  constexpr size_t bytes = HSmem<DH>::bytes;
  const int items = BH * n_views * ((n_kpts + HW_ROWS - 1) / HW_ROWS);
  const int grid = min(items, sm_count());
  if (lse == nullptr) {
    prepare_smem(cross_attn_fwd_bf16_kernel<DH>, bytes);
    cross_attn_fwd_bf16_kernel<DH><<<grid, HW_THREADS, bytes, st>>>(
        maps[0], maps[1], maps[2], o, S, n_views, n_kpts, scale, items);
  } else {
    prepare_smem(cross_attn_fwd_lse_bf16_kernel<DH>, bytes);
    cross_attn_fwd_lse_bf16_kernel<DH><<<grid, HW_THREADS, bytes, st>>>(
        maps[0], maps[1], maps[2], o, lse, S, n_views, n_kpts, scale, items);
  }
  return 0;
}

// dk == nullptr: the dq kernel (into dq); else the dk/dv kernel (into dk, dv).
// Both persistent, on the work items of BwdWalk; -2 where a TMA map cannot be
// made.
template <int DH>
int launch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
               const float* lse, const float* dvec, bf16* dq, bf16* dk, bf16* dv, int BH,
               int S, int n_views, int n_kpts, float scale, cudaStream_t st) {
  CUtensorMap maps[4];
  if (!make_maps(maps, q, k, v, BH, S, DH) || !make_map(&maps[3], dout, BH, S, DH)) return -2;
  const int items = BH * n_views * cdiv(n_kpts, HW_ROWS);
  if (dk == nullptr) {
    constexpr size_t bytes = DqSmem<DH>::bytes;
    prepare_smem(cross_attn_bwd_dq_bf16_kernel<DH>, bytes);
    cross_attn_bwd_dq_bf16_kernel<DH><<<min(items, sm_count()), HW_THREADS, bytes, st>>>(
        maps[0], maps[1], maps[2], maps[3], lse, dvec, dq, S, n_views, n_kpts, scale, items);
    return 0;
  }
  constexpr size_t bytes = BSmem<DH>::bytes;
  prepare_smem(cross_attn_bwd_dkv_bf16_kernel<DH>, bytes);
  cross_attn_bwd_dkv_bf16_kernel<DH><<<min(items, sm_count()), HW_THREADS, bytes, st>>>(
      maps[0], maps[1], maps[2], maps[3], lse, dvec, dk, dv, S, n_views, n_kpts, scale, items);
  return 0;
}

// {blocks per SM, registers, local (spill) bytes per thread, dynamic shared
// bytes, rows a block owns (query rows of a work item; key rows for dk/dv),
// threads per block, 1 for a persistent grid} of one kernel, as the runtime sees
// it at its own block size.
template <typename F>
int kernel_info(F* kernel, size_t bytes, int threads, int rows, int persistent, int* info) {
  prepare_smem(kernel, bytes);
  cudaFuncAttributes a;
  int blocks = 0;
  if (cudaFuncGetAttributes(&a, kernel) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, bytes) !=
          cudaSuccess)
    return (int)cudaGetLastError();
  info[0] = blocks;
  info[1] = a.numRegs;
  info[2] = (int)a.localSizeBytes;
  info[3] = (int)bytes;
  info[4] = rows;
  info[5] = threads;
  info[6] = persistent;
  return 0;
}

template <int DH>
int kernel_info_dh(int which, int* info) {
  constexpr size_t hw = HSmem<DH>::bytes;
  switch (which) {
    case 0: return kernel_info(attn_fwd_bf16_kernel<DH, kFull>, hw, HW_THREADS, HW_ROWS, 1, info);
    case 1: return kernel_info(attn_fwd_bf16_kernel<DH, kSelf>, hw, HW_THREADS, HW_ROWS, 1, info);
    case 2: return kernel_info(attn_fwd_bf16_kernel<DH, kCross>, hw, HW_THREADS, HW_ROWS, 1, info);
    case 3: return kernel_info(cross_attn_fwd_bf16_kernel<DH>, hw, HW_THREADS, HW_ROWS, 1, info);
    case 4: return kernel_info(cross_attn_fwd_lse_bf16_kernel<DH>, hw, HW_THREADS, HW_ROWS, 1, info);
    case 5:
      return kernel_info(cross_attn_bwd_dq_bf16_kernel<DH>, DqSmem<DH>::bytes, HW_THREADS,
                         HW_ROWS, 1, info);
    case 6:
      return kernel_info(cross_attn_bwd_dkv_bf16_kernel<DH>, BSmem<DH>::bytes, HW_THREADS,
                         HW_ROWS, 1, info);
    default: return -1;
  }
}

bool cross_shape_ok(int BH, int S, int n_views, int n_kpts) {
  return BH >= 1 && BH <= 65535 && n_views >= 2 && n_kpts >= 1 && S == n_views * n_kpts;
}

int cross_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int BH, int S,
              int dh, int n_views, int n_kpts, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!cross_shape_ok(BH, S, n_views, n_kpts)) return -1;
  bf16* ob = static_cast<bf16*>(o);
  int rc;
  switch (dh) {
    case 16: rc = launch_cross<16>(q, k, v, ob, lse, BH, S, n_views, n_kpts, scale, st); break;
    case 32: rc = launch_cross<32>(q, k, v, ob, lse, BH, S, n_views, n_kpts, scale, st); break;
    case 64: rc = launch_cross<64>(q, k, v, ob, lse, BH, S, n_views, n_kpts, scale, st); break;
    default: return -1;
  }
  return rc != 0 ? rc : (int)cudaGetLastError();
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
  int rc;
  switch (dh) {
    case 16: rc = launch_bwd<16>(qb, kb, vb, db, lse, dvec, dqb, dkb, dvb, BH, S, n_views, n_kpts, scale, st); break;
    case 32: rc = launch_bwd<32>(qb, kb, vb, db, lse, dvec, dqb, dkb, dvb, BH, S, n_views, n_kpts, scale, st); break;
    case 64: rc = launch_bwd<64>(qb, kb, vb, db, lse, dvec, dqb, dkb, dvb, BH, S, n_views, n_kpts, scale, st); break;
    default: return -1;
  }
  return rc != 0 ? rc : (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns 0 on success, -1 for an unsupported head width, mode or shape, -2
// where a TMA map cannot be made, otherwise the cudaGetLastError() code of the
// launch.
int attn_fwd_bf16(const void* q, const void* k, const void* v, void* o, int BH, int S,
                  int dh, int n_kpts, int mode, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode < 0 || mode > 2 || BH < 1 || BH > 65535 || S < 1 || n_kpts < 1) return -1;
  bf16* ob = static_cast<bf16*>(o);
  int rc;
  switch (dh) {
    case 16: rc = launch_attn<16>(q, k, v, ob, BH, S, n_kpts, mode, scale, st); break;
    case 32: rc = launch_attn<32>(q, k, v, ob, BH, S, n_kpts, mode, scale, st); break;
    case 64: rc = launch_attn<64>(q, k, v, ob, BH, S, n_kpts, mode, scale, st); break;
    default: return -1;
  }
  return rc != 0 ? rc : (int)cudaGetLastError();
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
// cross_attn_bwd_dq_bf16; 6 cross_attn_bwd_dkv_bf16. Fills info[7] (see
// kernel_info) and returns 0, or -1 for an unsupported head width or kernel.
int attn_bf16_kernel_info(int dh, int which, int* info) {
  switch (dh) {
    case 16: return kernel_info_dh<16>(which, info);
    case 32: return kernel_info_dh<32>(which, info);
    case 64: return kernel_info_dh<64>(which, info);
    default: return -1;
  }
}

}  // extern "C"
