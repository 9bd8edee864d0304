// Dustbin Sinkhorn for Hopper (sm_90a), FP32 on the CUDA cores: the four
// kernels of e2e_multi_view_matching_tpu/ops/sinkhorn_pallas.py.
//
//   sinkhorn_scaling    <- _sinkhorn_scaling_kernel    (eval forward)
//   sinkhorn_log        <- _sinkhorn_kernel            (algorithm="log"), and with
//     stash != 0        <- _sinkhorn_log_stash_kernel  (forward under grad)
//   sinkhorn_bwd        <- _sinkhorn_bwd_kernel        (reverse sweep)
//
// What bounds them on an H100. Per iteration and matrix entry the work is a
// few FMAs (scaling) or two exponentials (log domain, sweep): the floor is
// the exponential unit (16 a clock on each SM) or, where every iteration
// streams the matrix from device memory, the bytes. The TPU kernels keep one
// whole pair matrix (the sweep: two) resident in VMEM for all iterations.
// One (401, 401) f32 training matrix is 643 KB and one (1025, 1025) eval
// matrix 4.2 MB, more than a block's 227 KB of shared memory; a batch of 80
// is 51 MB / 336 MB against 50 MB of L2.
//
// All three run on thread-block clusters: one cluster owns one pair matrix
// for all its iterations, in one launch; the clusters are persistent, each
// walking over the pairs cid, cid + n_clusters, ...
//
// * The cluster's CS blocks (one per SM) split the rows into contiguous
//   bands. Warp w of a block owns the band rows w, w + 16, ...; lane l owns
//   the columns l, l + 32, ... (KC of them). A warp takes one row at a time
//   into registers, every load of the row in flight at once (lanes past N
//   load nothing), so every ROW reduction (a_i, the log-domain u_i, the
//   sweep's gu_i) finishes inside a warp, and the row's contribution to the
//   COLUMN reductions stays in the lanes' registers for the whole pass.
// * Every column reduction goes through distributed shared memory (DSMEM):
//   the block merges its 16 warps' vectors in warp order and writes its
//   band's partial vector to its own shared memory; after the cluster barrier
//   every block copies the CS partial vectors (map_shared_rank, 16 bytes a
//   load; the log kernel reads them in place) and merges them in rank order
//   into the whole b (gv, or the column log-sum-exp from (max, sum) pairs)
//   itself. Every block forms the same
//   bits, so one cluster barrier per iteration is enough; the partials are
//   double buffered so that iteration t+1's writes cannot race iteration t's
//   reads. No atomics: two runs give the same bits.
// * Residency is one template parameter RES of each kernel body. RES (the
//   401 x 401 shapes): the band stays in shared memory for all iterations
//   and every input is read from device memory once. sinkhorn_scaling keeps
//   its band of K (C is copied in again, with cp.async while the cluster
//   exchanges, before each of the 10 rebuilds); sinkhorn_log keeps its band
//   of C; sinkhorn_bwd keeps its bands of C and G and writes G once, at the
//   end; the stashed U[:, t] and V[:, t-1:t+1] rows are the only per-step
//   reads, staged while the cluster waits at its barrier. !RES (the 1025 x
//   1025 shapes): rows stream from device memory straight into registers (a
//   row is consumed by the warp that loads it); sinkhorn_log and
//   sinkhorn_bwd choose n_clusters so that the matrices in flight (C; C and
//   G) stay inside the 50 MB L2, sinkhorn_scaling takes a cluster a pair, as
//   many as fit (faster on the H100 than the L2 budget's count).
//   All three take N <= 1056 (33 columns a lane); sinkhorn_scaling alone
//   also takes N <= 2080 (the 2049 x 2049 pair matrices of K = 2048), in a
//   wide streamed instantiation that keeps its column sums in shared memory
//   (see scaling_cluster_kernel).
// * The plan (CS, RES, n_clusters, KC, shared bytes) is made in
//   ops/sinkhorn_cuda.py; the C side checks it against its own layout and
//   cudaOccupancyMaxActiveClusters and returns a non-zero code where the
//   cluster cannot be scheduled.
// * What holds them back (PERF.md): each warp's row is a dependent chain of
//   loads, a warp reduction and a division or exponential, one row after
//   another, with 16 warps an SM; the streamed rows wait on device memory.
//
// sinkhorn_scaling (stabilized scaling domain, the TPU kernel's absorption
// schedule):
//   1. one exact log-domain iteration  u = log_mu - LSE_j(C + v),
//                                      v = log_nu - LSE_i(C + u);
//   2. blocks of scaling iterations    a = mu / (K b + 1e-30),
//                                      b = nu / (K^T a + 1e-30)
//      (9 in the first block, 10 in every later one);
//   3. at every absorption u += log(a + 1e-30), v += log(b + 1e-30) and K is
//      REBUILT as exp(C + u + v) from the couplings (never carried
//      multiplicatively: entries that underflowed inside a block must revive),
//      fused into the first iteration of each block, which reads C instead of K;
//   4. output (C + (u + v)) - norm.
//
// sinkhorn_log: n_iters times the exact iteration of step 1, max-subtracted,
// u_0 = v_0 = 0, then the output (C + (u + v)) - norm. One pass over the band
// an iteration: a warp's row gives u_i (row max, then the sum of exp(x - max)
// with v added, inside the warp); from the same registers each lane folds
// C_ij + u_i into its columns' running (max, sum) pairs with one exponential
// an entry (lse_merge, an online log-sum-exp). So an entry costs the two
// exponentials of the iteration and no more, on the special-function unit
// (exp_ftz), and the resident band's rows are padded with -inf to the lanes'
// slots, so that no load of an iteration is predicated. The 16 warps' pairs
// meet in shared memory, the blocks' pairs are read over DSMEM after one
// cluster barrier, each merged in a fixed order, and every block forms
// v = log_nu - (log S + max). With the stash (a uniform flag: it only adds
// stores), iteration t writes the band's u_t to U (B, T, M) while the cluster
// is at the barrier, and each block its share of v_t's columns to V (B, T,
// N); without, U (B, M) and V (B, N) receive the last duals.
//
// sinkhorn_bwd: cotangent of C for Z = C + u_T + v_T. With gu_T = rowsum(g),
// gv_T = colsum(g), G = g, for t = T-1 .. 0:
//   Q = exp((C + u_t) + (v_t - log_nu))      column softmax, entries <= 1
//   gu = [t == T-1] gu_T - rowsum(Q gv)
//   P = exp((C + v_{t-1}) + (u_t - log_mu))  row softmax (v_{-1} = 0)
//   G -= Q gv + P gu;   gv <- -colsum(P gu)
//
// Plain versions: ops/sinkhorn.py::log_sinkhorn_mxu, log_sinkhorn_stash,
// log_sinkhorn_bwd.

#include <cooperative_groups.h>
#include <float.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kTiny = 1e-30f;
constexpr int CT = 512;       // threads of a cluster kernel's block
constexpr int CW = CT / 32;   // its warps

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// exp(x) on the special-function unit: ex2.approx.ftz of x log2(e), two
// instructions (expf's range handling and __expf's subnormal path take five
// or more); results below 2^-126 flush to 0, which no log-sum-exp term of
// the log-domain kernel needs (every sum holds a term of 1).
__device__ __forceinline__ float exp_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// Online log-sum-exp: the pair (m, z), standing for z exp(m), takes in the
// pair (y, w) with one exponential: with d = y - m and e = exp(-|d|),
// z = z e + w and m = y where d > 0, else z = z + w e.
__device__ __forceinline__ void lse_merge(float& m, float& z, float y, float w) {
  const float d = y - m;
  const float e = exp_ftz(-fabsf(d));
  const bool up = d > 0.f;
  z = up ? fmaf(z, e, w) : fmaf(w, e, z);
  m = up ? y : m;
}

// ---------------------------------------------------------------------------
// Cluster kernels

constexpr int CS_MAX = 8;         // the largest cluster the plan asks for
constexpr int KC_STREAMED = 33;   // columns a lane when streamed: N <= 1056
// columns a lane of the wide scaling kernel (streamed only): N <= 2080, the
// pair matrices of K = 2048 keypoints
constexpr int KC_WIDE = 65;

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Shared-memory layout of a block of each cluster kernel, in floats; every
// vector starts on 16 bytes (NP = round4(N)). The Python plan
// (ops/sinkhorn_cuda.py::_smem_floats) computes the same totals.
struct Layout {
  int mat, gmat, wsum, stage, part, col, vec, rowv, total;
};

__host__ __device__ constexpr Layout scaling_layout(bool res, int band, int N) {
  // K band (RES; rows N apart, from a 16-byte boundary up to 3 floats before
  // them) | the warps' column sums (CW x NP) | the gathered partials (CS_MAX
  // x NP) | 2 parities x (max | sum) partials | column (max | sum) | b, v,
  // log_nu | u, a, log_mu of the rows
  const int NP = round4(N), w = res ? round4(band * N + 3) : 0, st = w + CW * NP;
  return {0, 0, w, st, st + CS_MAX * NP, st + (CS_MAX + 4) * NP, st + (CS_MAX + 6) * NP,
          st + (CS_MAX + 9) * NP, st + (CS_MAX + 9) * NP + 3 * round4(band)};
}

// The wide scaling kernel's (streamed, kc = KC_WIDE): as scaling_layout's,
// but the warps' column sums are the lanes' accumulators and the gathered
// partials reuse them, so it has no stage of its own.
__host__ __device__ constexpr Layout scaling_wide_layout(int band, int N) {
  const int NP = round4(N), pt = CW * NP;
  return {0, 0, 0, 0, pt, pt + 4 * NP, pt + 6 * NP, pt + 9 * NP, pt + 9 * NP + 3 * round4(band)};
}

__host__ __device__ constexpr Layout bwd_layout(bool res, int band, int N) {
  // C band, G band (RES) | the warps' column sums | the gathered partials |
  // 2 parities of partials | gv, v_t - log_nu, v_{t-1}, log_nu | u_t, u_t -
  // log_mu, gu_T, log_mu of the rows
  const int NP = round4(N), w = res ? 2 * band * NP : 0, st = w + CW * NP;
  return {0, res ? band * NP : 0, w, st, st + CS_MAX * NP, 0, st + (CS_MAX + 2) * NP,
          st + (CS_MAX + 6) * NP, st + (CS_MAX + 6) * NP + 4 * round4(band)};
}

__host__ __device__ constexpr Layout log_layout(bool res, int band, int N, int kc) {
  // C band (RES; rows VS = 32 kc apart, -inf past N) | the warps' column
  // maxima, then sums (2 x CW x NP) | 2 parities x (max | sum) partials | v
  // (VS, 0 past N) | log_nu | u, log_mu of the rows
  const int NP = round4(N), VS = 32 * kc, w = res ? band * VS : 0, pt = w + 2 * CW * NP;
  return {0, 0, w, 0, pt, 0, pt + 4 * NP, pt + 4 * NP + VS + NP,
          pt + 4 * NP + VS + NP + 2 * round4(band)};
}

// The two halves of cluster.sync(): arrive (release) and wait (acquire), so
// that work that does not touch the partials can run in between.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Floats (0-3) from the 16-byte boundary at or below `src` to `src`.
__device__ __forceinline__ int span_offset(const float* src) {
  return (int)((reinterpret_cast<size_t>(src) >> 2) & 3);
}

// The block's copy of `count` floats, contiguous in device memory from
// `src`, into `dst`, 16 bytes a copy from the 16-byte boundary at or below
// `src` (the floats land at dst + span_offset(src); the copy reads up to 12
// bytes beyond both ends, inside the same 16-byte words), as one cp.async
// commit group.
__device__ __forceinline__ void fetch_span(float* dst, const float* src, int count) {
  const int off = span_offset(src);
  for (int c = threadIdx.x; 4 * c < off + count; c += CT) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst + 4 * c);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src - off + 4 * c));
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The lane's entries of a row (columns lane + 32 k, k < KC) into xs, `pad` in
// the slots past N (kv: the lane's columns): predicated loads off one base
// pointer with immediate offsets, branch-free.
template <int KC>
__device__ __forceinline__ void load_lane_row(float (&xs)[KC], const float* row, int kv,
                                              float pad) {
  const float* p = row + threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < KC; ++k) xs[k] = k < kv ? p[32 * k] : pad;
}

template <int KC>
__device__ __forceinline__ void store_lane_row(const float (&xs)[KC], float* row, int kv) {
  float* p = row + threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < KC; ++k)
    if (k < kv) p[32 * k] = xs[k];
}

// After the cluster barrier: copies the cluster's partial vectors `part` (NP
// floats at the same offset in every block) into the local `stage` (cs x NP),
// 16 bytes a load, and returns once every thread of the block has them; the
// caller sums stage[r * NP + j] over r in rank order.
__device__ __forceinline__ void gather_partials(cg::cluster_group& cluster, float* part,
                                                float* stage, int N) {
  const int n4 = round4(N) / 4, cs = (int)cluster.num_blocks();
  for (int idx = threadIdx.x; idx < cs * n4; idx += CT) {
    const int r = idx / n4;
    reinterpret_cast<float4*>(stage)[idx] =
        reinterpret_cast<const float4*>(cluster.map_shared_rank(part, r))[idx - r * n4];
  }
  __syncthreads();
}

// The 16 warps' rows of wsum (CW x NP), summed (or maxed) in warp order,
// into col[j]; returns once every thread of the block has them.
__device__ __forceinline__ void warp_rows_to_columns(const float* wsum, float* col, int N,
                                                     bool take_max) {
  const int NP = round4(N);
  for (int j = threadIdx.x; j < N; j += CT) {
    float s = take_max ? -INFINITY : 0.f;
#pragma unroll
    for (int w = 0; w < CW; ++w) s = take_max ? fmaxf(s, wsum[w * NP + j]) : s + wsum[w * NP + j];
    col[j] = s;
  }
  __syncthreads();
}

// The wide scaling kernel's column sums: the lane's slots (32 apart) of its
// warp's row of wsum, those inside N set to v.
template <int KC>
__device__ __forceinline__ void fill_lane_slots(float* al, int kv, float v) {
#pragma unroll
  for (int k = 0; k < KC; ++k)
    if (k < kv) al[32 * k] = v;
}

// The 16 warps' column sums (or maxima) of their lanes' acc, summed in warp
// order, into col[j] (through wsum, CW x NP).
template <int KC>
__device__ __forceinline__ void warps_to_columns(const float (&acc)[KC], float* wsum, float* col,
                                                 int N, int kv, bool take_max) {
  const int NP = round4(N), warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < KC; ++k)
    if (k < kv) wsum[warp * NP + lane + 32 * k] = acc[k];
  __syncthreads();
  warp_rows_to_columns(wsum, col, N, take_max);
}

// The 16 warps' column (max, sum) pairs (warp w's at row w of wm and wz,
// CW x NP each), merged in warp order into the block's pmax, psum.
__device__ __forceinline__ void warps_to_column_pairs(const float* wm, const float* wz,
                                                      float* pmax, float* psum, int N) {
  const int NP = round4(N);
  for (int j = threadIdx.x; j < N; j += CT) {
    float m = -FLT_MAX, z = 0.f;
#pragma unroll
    for (int w = 0; w < CW; ++w) lse_merge(m, z, wm[w * NP + j], wz[w * NP + j]);
    pmax[j] = m;
    psum[j] = z;
  }
}

// A column reduction over the cluster: the block's column sums into its
// partial vector pp, the cluster barrier (`between` runs after arriving, for
// work that does not touch the partials), then every block's pp gathered into
// stage (see gather_partials).
template <int KC, class Between>
__device__ __forceinline__ void cluster_column_sums(cg::cluster_group& cluster,
                                                    const float (&acc)[KC], float* wsum,
                                                    float* pp, float* stage, int N, int kv,
                                                    Between between) {
  warps_to_columns(acc, wsum, pp, N, kv, false);
  cluster_arrive();
  between();
  cluster_wait();
  gather_partials(cluster, pp, stage, N);
}

// Scaling-domain solve; one cluster per pair at a time. K: the streamed
// variant's (B, M, N) workspace (unused when RES).
//
// Warp w of a block takes the band rows w, w + 16, ...; lane l the columns
// l + 32 k, k < KC. A row goes into registers once per pass, every load in
// flight at once (lanes past N load nothing and hold a pad): RES from the
// band in shared memory (C, copied in whole; rebuilt into K at every
// absorption), streamed from K (or C) in device memory. The warp forms the
// row's a_i with a warp reduction and adds the row, scaled by a_i, into its
// lanes' column sums, which stay in registers until the pass ends and the
// 16 warps' sums meet in shared memory, summed in warp order. RES with
// KC <= 16 also keeps the lane's entries of b in registers for the
// iteration, so that the pass reads each entry of the band once.
//
// The wide kernel (KC = KC_WIDE, streamed only, N <= 2080): a row's 65
// entries a lane and 65 column sums would take 130 registers of the 128 a
// thread has at 512 threads. So the row stays in registers, and the lane's
// column sums (maxima in the exact iteration) live in its own slots of its
// warp's row of wsum, a read and a write of shared memory an entry, added in
// the same order as in registers; the 16 warps' rows meet as before, and
// the gathered partials reuse wsum once they have.
template <bool RES, int KC>
__global__ void __launch_bounds__(CT, 1)
scaling_cluster_kernel(const float* __restrict__ C, const float* __restrict__ log_mu,
                       const float* __restrict__ log_nu, float* __restrict__ out,
                       float* __restrict__ K, int B, int M, int N, int band,
                       int n_iters, int absorb_every, float norm) {
  constexpr bool B_REGS = RES && KC <= 16;
  constexpr bool WIDE = KC > KC_STREAMED;
  static_assert(!(RES && WIDE), "the wide kernel streams");
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / cs, n_clusters = gridDim.x / cs;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int i0 = rank * band;
  const int rows = max(0, min(band, M - i0));
  const int NP = round4(N);
  // the warp's rows: warp, warp + CW, ...: nq of them; the lane's columns:
  // lane + 32 k for k < kv
  const int nq = rows > warp ? (rows - warp + CW - 1) / CW : 0;
  const int kv = (N - lane + 31) / 32;
  extern __shared__ __align__(16) float csm[];
  const Layout L = WIDE ? scaling_wide_layout(band, N) : scaling_layout(RES, band, N);
  float* mat = csm + L.mat;       // RES: the band of C, then of K, as a span
  float* wsum = csm + L.wsum;     // CW x NP: the warps' column sums
  float* stage = csm + L.stage;   // CS_MAX x NP (WIDE: wsum)
  float* part = csm + L.part;     // 2 parities x 2NP
  float* cmax = csm + L.col;      // NP: column max (first iteration)
  float* csum = cmax + NP;        // NP: column sums
  float* sb = csm + L.vec;        // NP: b
  float* sv = sb + NP;            // NP: v
  float* slognu = sv + NP;        // NP
  float* su = csm + L.rowv;       // band: u
  float* sa = su + round4(band);  // band: a
  float* slogmu = sa + round4(band);
  const int n_absorb = (n_iters + absorb_every - 1) / absorb_every;
  const int n_scale = n_absorb * absorb_every - 1;  // scaling iterations
  int par = 0;
  float x[KC], acc[WIDE ? 1 : KC];  // a row's entries, the lane's column sums
  float bq[B_REGS ? KC : 1];  // B_REGS: the lane's entries of b
  float* al = wsum + warp * NP + lane;  // WIDE: the lane's column sums, 32 apart

  for (int pair = cid; pair < B; pair += n_clusters) {
    const float* Cp = C + ((size_t)pair * M + i0) * N;
    float* Kp = K + ((size_t)pair * M + i0) * N;
    float* kb = mat + span_offset(Cp);  // RES: row r of the band at kb + r N
    if constexpr (RES) fetch_span(mat, Cp, rows * N);
    for (int j = tid; j < NP; j += CT) {
      slognu[j] = j < N ? log_nu[(size_t)pair * N + j] : 0.f;
      sb[j] = j < N ? 1.f : 0.f;
    }
    for (int i = tid; i < rows; i += CT) slogmu[i] = log_mu[(size_t)pair * M + i0 + i];
    if constexpr (RES) cp_async_wait_all();
    __syncthreads();

    // 1. exact log-domain iteration (v = 0): u by rows and the column max of
    // C + u; then the column sum of exp(C + u - max); merged over the
    // cluster as (max, sum) pairs
    if constexpr (WIDE) {
      fill_lane_slots<KC>(al, kv, -INFINITY);
    } else {
#pragma unroll
      for (int k = 0; k < KC; ++k) acc[k] = -INFINITY;
    }
    for (int q = 0; q < nq; ++q) {
      const int r = warp + q * CW;
      load_lane_row(x, RES ? kb + r * N : Cp + (size_t)r * N, kv, -INFINITY);
      float mx = -INFINITY;
#pragma unroll
      for (int k = 0; k < KC; ++k) mx = fmaxf(mx, x[k]);
      mx = warp_max(mx);
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < KC; ++k) s += expf(x[k] - mx);
      s = warp_sum(s);
      const float ui = slogmu[r] - (logf(s) + mx);
      if (lane == 0) su[r] = ui;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        if constexpr (WIDE) {
          if (k < kv) al[32 * k] = fmaxf(al[32 * k], x[k] + ui);
        } else {
          acc[k] = fmaxf(acc[k], x[k] + ui);
        }
      }
    }
    if constexpr (WIDE) {
      __syncthreads();
      warp_rows_to_columns(wsum, cmax, N, true);
    } else {
      warps_to_columns(acc, wsum, cmax, N, kv, true);
    }
    if constexpr (WIDE) {
      fill_lane_slots<KC>(al, kv, 0.f);
    } else {
#pragma unroll
      for (int k = 0; k < KC; ++k) acc[k] = 0.f;
    }
    for (int q = 0; q < nq; ++q) {
      const int r = warp + q * CW;
      load_lane_row(x, RES ? kb + r * N : Cp + (size_t)r * N, kv, 0.f);
      const float ui = su[r];
      const float* cm = cmax + lane;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        if constexpr (WIDE) {
          if (k < kv) al[32 * k] += expf((x[k] + ui) - cm[32 * k]);
        } else {
          if (k < kv) acc[k] += expf((x[k] + ui) - cm[32 * k]);
        }
      }
    }
    if constexpr (WIDE) {
      __syncthreads();
      warp_rows_to_columns(wsum, csum, N, false);
    } else {
      warps_to_columns(acc, wsum, csum, N, kv, false);
    }
    {
      float* pp = part + par * 2 * NP;
      for (int j = tid; j < N; j += CT) {
        pp[j] = cmax[j];
        pp[NP + j] = csum[j];
      }
      cluster.sync();
      for (int j = tid; j < N; j += CT) {
        float mx = -INFINITY;
        for (int q = 0; q < cs; ++q) mx = fmaxf(mx, cluster.map_shared_rank(pp, q)[j]);
        float s = 0.f;
        for (int q = 0; q < cs; ++q) {
          const float* rp = cluster.map_shared_rank(pp, q);
          s += rp[NP + j] * expf(rp[j] - mx);
        }
        sv[j] = slognu[j] - (logf(s) + mx);
      }
      par ^= 1;
      __syncthreads();
    }

    // 2.-3. scaling iterations: blocks of absorb_every (the exact iteration
    // opens the first), each block's first rebuilding K from C, its last
    // absorbing. RES: the band holds C after the exact iteration; before a
    // later rebuild the block copies C into it while the cluster exchanges.
    auto rebuilds = [&](int it) { return it == 0 || (it + 1) % absorb_every == 0; };
    for (int it = 0; it < n_scale; ++it) {
      const bool rebuild = rebuilds(it);
      const bool absorb = (it + 2) % absorb_every == 0;
      if (RES && rebuild && it > 0) {
        cp_async_wait_all();
        __syncthreads();
      }
      if constexpr (B_REGS) load_lane_row(bq, sb, kv, 0.f);
      if constexpr (WIDE) {
        fill_lane_slots<KC>(al, kv, 0.f);
      } else {
#pragma unroll
        for (int k = 0; k < KC; ++k) acc[k] = 0.f;
      }
      for (int q = 0; q < nq; ++q) {
        const int r = warp + q * CW;
        if (rebuild) {  // K = exp(C + u + v)
          load_lane_row(x, RES ? kb + r * N : Cp + (size_t)r * N, kv, 0.f);
          const float ui = su[r];
          const float* vp = sv + lane;
#pragma unroll
          for (int k = 0; k < KC; ++k)
            if (k < kv) x[k] = expf((x[k] + ui) + vp[32 * k]);
          store_lane_row(x, RES ? kb + r * N : Kp + (size_t)r * N, kv);
        } else {
          load_lane_row(x, RES ? kb + r * N : Kp + (size_t)r * N, kv, 0.f);
        }
        float s = 0.f;
        if constexpr (B_REGS) {
#pragma unroll
          for (int k = 0; k < KC; ++k) s = fmaf(x[k], bq[k], s);
        } else {
          const float* p = sb + lane;
#pragma unroll
          for (int k = 0; k < KC; ++k)
            if (k < kv) s = fmaf(x[k], p[32 * k], s);
        }
        s = warp_sum(s);
        const float a = expf(slogmu[r]) / (s + kTiny);
        if (lane == 0) sa[r] = a;
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          if constexpr (WIDE) {
            if (k < kv) al[32 * k] = fmaf(x[k], a, al[32 * k]);
          } else {
            acc[k] = fmaf(x[k], a, acc[k]);
          }
        }
      }
      if constexpr (WIDE) {  // the warps' rows are the sums: merge, exchange, gather
        float* pp = part + par * 2 * NP;
        __syncthreads();
        warp_rows_to_columns(wsum, pp, N, false);
        cluster.sync();
        gather_partials(cluster, pp, stage, N);
      } else {
        cluster_column_sums(cluster, acc, wsum, part + par * 2 * NP, stage, N, kv, [&] {
          if (RES && it + 1 < n_scale && rebuilds(it + 1)) fetch_span(mat, Cp, rows * N);
        });
      }
      for (int j = tid; j < N; j += CT) {
        float s = 0.f;
        for (int q = 0; q < cs; ++q) s += stage[q * NP + j];
        const float bj = expf(slognu[j]) / (s + kTiny);
        if (absorb) {
          sv[j] += logf(bj + kTiny);
          sb[j] = 1.f;
        } else {
          sb[j] = bj;
        }
      }
      if (absorb)
        for (int i = tid; i < rows; i += CT) su[i] += logf(sa[i] + kTiny);
      par ^= 1;
      __syncthreads();
    }

    // 4. output
    float* op = out + ((size_t)pair * M + i0) * N;
    for (int i = 0; i < rows; ++i)
      for (int j = tid; j < N; j += CT)
        op[(size_t)i * N + j] = (Cp[(size_t)i * N + j] + (su[i] + sv[j])) - norm;
    __syncthreads();
  }
  cluster.sync();  // no block leaves while another may still read its partials
}

// Reverse sweep; one cluster per pair at a time. The same division of work
// as scaling_cluster_kernel: warp w takes the band rows w, w + 16, ...; lane
// l the columns l + 32 k, k < KC. Per reverse step a warp takes a row of C
// into registers once (RES: from the band of C in shared memory; streamed:
// from device memory), forms Q gv in registers, gu with a warp reduction,
// then P gu, and updates the row of G (RES: the band of G in shared memory,
// written to device memory once at the end; streamed: G in device memory,
// every load of the row before its stores); the lanes' column sums of P gu
// stay in registers until the 16 warps' sums meet in shared memory. RES with
// KC <= 16 keeps the lane's entries of v_t - log_nu, gv and v_{t-1} in
// registers for the step.
template <bool RES, int KC>
__global__ void __launch_bounds__(CT, 1)
bwd_cluster_kernel(const float* __restrict__ C, const float* __restrict__ U,
                   const float* __restrict__ V, const float* __restrict__ g,
                   const float* __restrict__ log_mu, const float* __restrict__ log_nu,
                   float* __restrict__ G, int B, int M, int N, int T, int band) {
  constexpr bool V_REGS = RES && KC <= 16;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / cs, n_clusters = gridDim.x / cs;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int i0 = rank * band;
  const int rows = max(0, min(band, M - i0));
  const int NP = round4(N);
  const int nq = rows > warp ? (rows - warp + CW - 1) / CW : 0;
  const int kv = (N - lane + 31) / 32;
  extern __shared__ __align__(16) float csm[];
  const Layout L = bwd_layout(RES, band, N);
  float* cmat = csm + L.mat;      // RES: the band of C, rows NP apart
  float* gmat = csm + L.gmat;     // RES: the band of G
  float* wsum = csm + L.wsum;     // CW x NP: the warps' column sums
  float* stage = csm + L.stage;   // CS_MAX x NP
  float* part = csm + L.part;     // 2 parities x NP
  float* sgv = csm + L.vec;       // NP: gv
  float* sqv = sgv + NP;          // NP: v_t - log_nu
  float* svp = sqv + NP;          // NP: v_{t-1}
  float* slognu = svp + NP;       // NP
  float* su = csm + L.rowv;       // band: u_t
  float* sum_ = su + round4(band);    // band: u_t - log_mu
  float* sgu0 = sum_ + round4(band);  // band: gu_T
  float* slogmu = sgu0 + round4(band);
  int par = 0;
  float x[KC], tq[KC], acc[KC];  // a row of C (then of G), Q gv (then Q gv + P gu), column sums
  float qv[V_REGS ? KC : 1], gv[V_REGS ? KC : 1], vp[V_REGS ? KC : 1];

  // the warps' column sums, merged over the cluster: sgv = sign * their sum;
  // `between` runs while the cluster gathers at the barrier
  auto exchange = [&](float sign, auto between) {
    cluster_column_sums(cluster, acc, wsum, part + par * NP, stage, N, kv, between);
    for (int j = tid; j < N; j += CT) {
      float s = 0.f;
      for (int q = 0; q < cs; ++q) s += stage[q * NP + j];
      sgv[j] = sign * s;
    }
    par ^= 1;
  };

  for (int pair = cid; pair < B; pair += n_clusters) {
    const float* Cp = C + ((size_t)pair * M + i0) * N;
    const float* gp = g + ((size_t)pair * M + i0) * N;
    float* Gp = G + ((size_t)pair * M + i0) * N;
    for (int j = tid; j < NP; j += CT) slognu[j] = j < N ? log_nu[(size_t)pair * N + j] : 0.f;
    for (int i = tid; i < rows; i += CT) slogmu[i] = log_mu[(size_t)pair * M + i0 + i];
    // start: G = g, gu_T = rowsum(g), gv_T = colsum(g); RES stages C
#pragma unroll
    for (int k = 0; k < KC; ++k) acc[k] = 0.f;
    for (int q = 0; q < nq; ++q) {
      const int r = warp + q * CW;
      load_lane_row(x, gp + (size_t)r * N, kv, 0.f);
      store_lane_row(x, RES ? gmat + r * NP : Gp + (size_t)r * N, kv);
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        s += x[k];
        acc[k] += x[k];
      }
      s = warp_sum(s);
      if (lane == 0) sgu0[r] = s;
      if constexpr (RES) {
        load_lane_row(x, Cp + (size_t)r * N, kv, 0.f);
        store_lane_row(x, cmat + r * NP, kv);
      }
    }
    // the duals of reverse step s (iteration t = T - 1 - s) into shared memory
    auto stage_step = [&](int s) {
      if (s >= T) return;
      const int t = T - 1 - s;
      const float* ut = U + ((size_t)pair * T + t) * M + i0;
      const float* vt = V + ((size_t)pair * T + t) * N;
      for (int j = tid; j < N; j += CT) {
        sqv[j] = vt[j] - slognu[j];
        svp[j] = t > 0 ? (vt - N)[j] : 0.f;
      }
      for (int i = tid; i < rows; i += CT) {
        su[i] = ut[i];
        sum_[i] = ut[i] - slogmu[i];
      }
    };
    exchange(1.f, [&] { stage_step(0); });

    for (int s = 0; s < T; ++s) {
      __syncthreads();
      if constexpr (V_REGS) {
        load_lane_row(qv, sqv, kv, 0.f);
        load_lane_row(gv, sgv, kv, 0.f);
        load_lane_row(vp, svp, kv, 0.f);
      }
#pragma unroll
      for (int k = 0; k < KC; ++k) acc[k] = 0.f;
      for (int q = 0; q < nq; ++q) {
        const int r = warp + q * CW;
        load_lane_row(x, RES ? cmat + r * NP : Cp + (size_t)r * N, kv, 0.f);
        // Q gv = exp((C + u_t) + (v_t - log_nu)) gv; gu = [s == 0] gu_T - rowsum
        const float ui = su[r];
        const float *qp = sqv + lane, *gvp = sgv + lane, *vpp = svp + lane;
        float rs = 0.f;
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          const float qk = V_REGS ? qv[k] : k < kv ? qp[32 * k] : 0.f;
          const float gk = V_REGS ? gv[k] : k < kv ? gvp[32 * k] : 0.f;
          tq[k] = k < kv ? expf((x[k] + ui) + qk) * gk : 0.f;
          rs += tq[k];
        }
        rs = warp_sum(rs);
        const float gu = (s == 0 ? sgu0[r] : 0.f) - rs;
        // P gu = exp((C + v_{t-1}) + (u_t - log_mu)) gu; G -= Q gv + P gu
        const float um = sum_[r];
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          const float vk = V_REGS ? vp[k] : k < kv ? vpp[32 * k] : 0.f;
          const float p = k < kv ? expf((x[k] + vk) + um) * gu : 0.f;
          tq[k] = tq[k] + p;
          acc[k] += p;
        }
        float* grow = RES ? gmat + r * NP : Gp + (size_t)r * N;
        load_lane_row(x, grow, kv, 0.f);
#pragma unroll
        for (int k = 0; k < KC; ++k) x[k] = x[k] - tq[k];
        store_lane_row(x, grow, kv);
      }
      exchange(-1.f, [&] { stage_step(s + 1); });
    }

    if constexpr (RES)
      for (int q = 0; q < nq; ++q) {
        const int r = warp + q * CW;
        load_lane_row(x, gmat + r * NP, kv, 0.f);
        store_lane_row(x, Gp + (size_t)r * N, kv);
      }
    __syncthreads();
  }
  cluster.sync();  // no block leaves while another may still read its partials
}

// Exact log-domain solve; one cluster per pair at a time, one pass over the
// band an iteration. Warp w takes the band rows w, w + 16, ...; lane l the
// columns l + 32 k, k < KC, two rows at a time (KC <= 16) so that their warp
// reductions interleave. A row goes into registers once per iteration (RES:
// from the band of C in shared memory, copied in once per pair with rows
// padded by -inf to 32 KC, so that no load of the iteration is predicated;
// streamed: from device memory), u_i comes from two warp reductions, and the
// lane folds C_ij + u_i into its columns' (max, sum) pairs (lse_merge): in
// registers for KC <= 16, else in its own slots of the warp's row of the
// column vectors.
template <int N>
struct Rows {
  static constexpr int value = N;
};

template <bool RES, int KC>
__global__ void __launch_bounds__(CT, 1)
log_cluster_kernel(const float* __restrict__ C, const float* __restrict__ log_mu,
                   const float* __restrict__ log_nu, float* __restrict__ out,
                   float* __restrict__ U, float* __restrict__ V, int B, int M, int N,
                   int band, int n_iters, int stash, float norm) {
  constexpr bool COL_REGS = KC <= 16;
  constexpr int ROWS_IN_FLIGHT = KC <= 16 ? 2 : 1;  // a warp's rows taken at once
  constexpr int VS = 32 * KC;                       // a padded row
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / cs, n_clusters = gridDim.x / cs;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int i0 = rank * band;
  const int rows = max(0, min(band, M - i0));
  const int NP = round4(N);
  const int nq = rows > warp ? (rows - warp + CW - 1) / CW : 0;
  const int kv = (N - lane + 31) / 32;
  // the block's share of the columns of v that it stores: [j0, j1)
  const int vshare = (N + cs - 1) / cs, j0 = rank * vshare, j1 = min(N, j0 + vshare);
  extern __shared__ __align__(16) float csm[];
  const Layout L = log_layout(RES, band, N, KC);
  float* mat = csm + L.mat;      // RES: the band of C, row r at mat + r VS
  float* wm = csm + L.wsum;      // CW x NP: the warps' column maxima
  float* wz = wm + CW * NP;      // CW x NP: their sums
  float* part = csm + L.part;    // 2 parities x (max | sum)
  float* sv = csm + L.vec;       // VS: v, 0 past N
  float* slognu = sv + VS;       // NP
  float* su = csm + L.rowv;      // band: u
  float* slogmu = su + round4(band);
  float* wml = wm + warp * NP + lane;  // the lane's slots of its warp's row
  float* wzl = wz + warp * NP + lane;
  const float* vl = sv + lane;
  int par = 0;
  float x[KC];                                         // a row of C
  float cm[COL_REGS ? KC : 1], cz[COL_REGS ? KC : 1];  // the lane's column (max, sum)
  // the lane's entries of band row r (RES: all KC slots, -inf past N)
  auto row_of = [&](float (&xs)[KC], const float* Cp, int r) {
    if constexpr (RES) {
#pragma unroll
      for (int k = 0; k < KC; ++k) xs[k] = mat[r * VS + lane + 32 * k];
    } else {
      load_lane_row(xs, Cp + (size_t)r * N, kv, -INFINITY);
    }
  };

  for (int pair = cid; pair < B; pair += n_clusters) {
    const float* Cp = C + ((size_t)pair * M + i0) * N;
    float* Up = U + (size_t)pair * (stash ? n_iters : 1) * M + i0;
    float* Vp = V + (size_t)pair * (stash ? n_iters : 1) * N;
    if constexpr (RES)  // each warp copies the rows it takes
      for (int q = 0; q < nq; ++q) {
        const int r = warp + q * CW;
        load_lane_row(x, Cp + (size_t)r * N, kv, -INFINITY);
#pragma unroll
        for (int k = 0; k < KC; ++k) mat[r * VS + lane + 32 * k] = x[k];
      }
    for (int j = tid; j < VS; j += CT) sv[j] = 0.f;  // v_0
    for (int j = tid; j < N; j += CT) slognu[j] = log_nu[(size_t)pair * N + j];
    for (int i = tid; i < rows; i += CT) slogmu[i] = log_mu[(size_t)pair * M + i0 + i];
    __syncthreads();

    for (int t = 0; t < n_iters; ++t) {
      // (max, sum) = (-FLT_MAX, 0): finite, so that a -INFINITY entry folds in
      // as exp(-inf) = 0
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        if constexpr (COL_REGS) {
          cm[k] = -FLT_MAX;
          cz[k] = 0.f;
        } else if (k < kv) {
          wml[32 * k] = -FLT_MAX;
          wzl[32 * k] = 0.f;
        }
      }
      // NR rows of the warp from its q-th: u_r = log_mu_r - LSE_j(C_rj + v_j)
      // for each (their reductions interleave), then their terms C_rj + u_r
      // folded into the lane's columns in row order
      auto take_rows = [&](auto nr, int q) {
        constexpr int NR = decltype(nr)::value;
        float xs[NR][KC], mx[NR], s[NR];
#pragma unroll
        for (int n = 0; n < NR; ++n) {
          row_of(xs[n], Cp, warp + (q + n) * CW);
          mx[n] = -INFINITY;
          s[n] = 0.f;
        }
#pragma unroll
        for (int k = 0; k < KC; ++k)
#pragma unroll
          for (int n = 0; n < NR; ++n) mx[n] = fmaxf(mx[n], xs[n][k] + vl[32 * k]);
#pragma unroll
        for (int n = 0; n < NR; ++n) mx[n] = warp_max(mx[n]);
#pragma unroll
        for (int k = 0; k < KC; ++k)
#pragma unroll
          for (int n = 0; n < NR; ++n) s[n] += exp_ftz((xs[n][k] + vl[32 * k]) - mx[n]);
#pragma unroll
        for (int n = 0; n < NR; ++n) {
          const int r = warp + (q + n) * CW;
          const float ui = slogmu[r] - (logf(warp_sum(s[n])) + mx[n]);
          if (lane == 0) su[r] = ui;
#pragma unroll
          for (int k = 0; k < KC; ++k) {
            if constexpr (COL_REGS) {
              lse_merge(cm[k], cz[k], xs[n][k] + ui, 1.f);
            } else {
              float m = k < kv ? wml[32 * k] : -FLT_MAX, z = k < kv ? wzl[32 * k] : 0.f;
              lse_merge(m, z, xs[n][k] + ui, 1.f);
              if (k < kv) {
                wml[32 * k] = m;
                wzl[32 * k] = z;
              }
            }
          }
        }
      };
      int q = 0;
      for (; q + ROWS_IN_FLIGHT <= nq; q += ROWS_IN_FLIGHT) take_rows(Rows<ROWS_IN_FLIGHT>{}, q);
      if constexpr (ROWS_IN_FLIGHT == 2)
        if (q < nq) take_rows(Rows<1>{}, q);
      // the band's column (max, sum), merged over the warps, then over the
      // cluster's blocks in rank order
      float* pp = part + par * 2 * NP;
      if constexpr (COL_REGS) {
        store_lane_row(cm, wm + warp * NP, kv);
        store_lane_row(cz, wz + warp * NP, kv);
      }
      __syncthreads();
      warps_to_column_pairs(wm, wz, pp, pp + NP, N);
      cluster_arrive();
      if (stash)
        for (int i = tid; i < rows; i += CT) Up[(size_t)t * M + i] = su[i];
      cluster_wait();
      // v_j = log_nu_j - LSE_i(C_ij + u_i): the blocks' pairs read over DSMEM
      for (int j = tid; j < N; j += CT) {
        float m = -FLT_MAX, z = 0.f;
#pragma unroll
        for (int q = 0; q < CS_MAX; ++q)
          if (q < cs) {
            const float* rp = cluster.map_shared_rank(pp, q);
            lse_merge(m, z, rp[j], rp[NP + j]);
          }
        const float vj = slognu[j] - (logf(z) + m);
        sv[j] = vj;
        if (stash && j >= j0 && j < j1) Vp[(size_t)t * N + j] = vj;
      }
      par ^= 1;
      __syncthreads();
    }

    // output (C + (u + v)) - norm over the band; without the stash, the last
    // duals into U (B, M) and V (B, N)
    float* op = out + ((size_t)pair * M + i0) * N;
    for (int q = 0; q < nq; ++q) {
      const int r = warp + q * CW;
      row_of(x, Cp, r);
      const float ui = su[r];
#pragma unroll
      for (int k = 0; k < KC; ++k) x[k] = (x[k] + (ui + vl[32 * k])) - norm;
      store_lane_row(x, op + (size_t)r * N, kv);
    }
    if (!stash) {
      for (int i = tid; i < rows; i += CT) Up[i] = su[i];
      for (int j = j0 + tid; j < j1; j += CT) Vp[j] = sv[j];
    }
    __syncthreads();
  }
  cluster.sync();  // no block leaves while another may still read its partials
}

using ScalingKernel = void (*)(const float*, const float*, const float*, float*, float*,
                               int, int, int, int, int, int, float);
using BwdKernel = void (*)(const float*, const float*, const float*, const float*,
                           const float*, const float*, float*, int, int, int, int, int);
using LogKernel = void (*)(const float*, const float*, const float*, float*, float*, float*,
                           int, int, int, int, int, int, float);

// The instantiations the plan can name (kc: columns a lane); nullptr for any
// other.
ScalingKernel scaling_kernel_for(int res, int kc) {
  if (!res) {
    if (kc == KC_WIDE) return scaling_cluster_kernel<false, KC_WIDE>;
    return kc == KC_STREAMED ? scaling_cluster_kernel<false, KC_STREAMED> : nullptr;
  }
  switch (kc) {
    case 4: return scaling_cluster_kernel<true, 4>;
    case 8: return scaling_cluster_kernel<true, 8>;
    case 13: return scaling_cluster_kernel<true, 13>;
    case 16: return scaling_cluster_kernel<true, 16>;
    case KC_STREAMED: return scaling_cluster_kernel<true, KC_STREAMED>;
  }
  return nullptr;
}

BwdKernel bwd_kernel_for(int res, int kc) {
  if (!res) return kc == KC_STREAMED ? bwd_cluster_kernel<false, KC_STREAMED> : nullptr;
  switch (kc) {
    case 4: return bwd_cluster_kernel<true, 4>;
    case 8: return bwd_cluster_kernel<true, 8>;
    case 13: return bwd_cluster_kernel<true, 13>;
    case 16: return bwd_cluster_kernel<true, 16>;
    case KC_STREAMED: return bwd_cluster_kernel<true, KC_STREAMED>;
  }
  return nullptr;
}

LogKernel log_kernel_for(int res, int kc) {
  if (!res) return kc == KC_STREAMED ? log_cluster_kernel<false, KC_STREAMED> : nullptr;
  switch (kc) {
    case 4: return log_cluster_kernel<true, 4>;
    case 8: return log_cluster_kernel<true, 8>;
    case 13: return log_cluster_kernel<true, 13>;
    case 16: return log_cluster_kernel<true, 16>;
    case KC_STREAMED: return log_cluster_kernel<true, KC_STREAMED>;
  }
  return nullptr;
}

cudaLaunchConfig_t cluster_config(int cs, int n_clusters, int smem, cudaStream_t st,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_clusters * cs);
  cfg.blockDim = dim3(CT);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Set the kernel's attributes for `cs` blocks of `smem` bytes and return how
// many such clusters the card can hold at once (or a negative CUDA error).
template <typename Kernel>
int prepare(Kernel kernel, int cs, int smem, cudaLaunchConfig_t* cfg) {
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem)) != cudaSuccess) return -(int)e;
  if (cs > 8 && (e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                                          1)) != cudaSuccess) return -(int)e;
  int n = 0;
  if ((e = cudaOccupancyMaxActiveClusters(&n, kernel, cfg)) != cudaSuccess) return -(int)e;
  return n;
}

// Launch `kernel` on the plan's clusters; -3 when no such cluster can be
// scheduled, -4 when the plan asks for more clusters than fit at once.
template <typename Kernel, typename... Args>
int launch_clusters(Kernel kernel, int cs, int n_clusters, int smem, cudaStream_t st,
                    Args... args) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(cs, n_clusters, smem, st, &attr);
  const int fit = prepare(kernel, cs, smem, &cfg);
  if (fit < 0) return -fit;
  if (fit < 1) return -3;
  if (n_clusters > fit) return -4;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

// sinkhorn_cluster_info for one instantiation (nullptr: -1).
template <typename Kernel>
int cluster_info(Kernel kernel, int cs, int smem, int* info) {
  if (!kernel) return -1;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(cs, 1, smem, nullptr, &attr);
  const int fit = prepare(kernel, cs, smem, &cfg);
  if (fit < 0) return -fit;
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return (int)e;
  info[0] = fit;
  info[1] = fa.numRegs;
  info[2] = (int)fa.localSizeBytes;
  return 0;
}

}  // namespace

extern "C" {

// A cluster kernel of the plan (kind 0: scaling, 1: sweep, 2: log domain;
// resident or streamed; kc columns a lane): info[0] = the clusters of `cs`
// blocks with `smem` bytes each that the card holds at once, info[1] =
// registers per thread, info[2] = local (spill) bytes per thread. Returns 0,
// -1 for a kernel that is not instantiated, or a CUDA error.
int sinkhorn_cluster_info(int kind, int res, int kc, int cs, int smem, int* info) {
  switch (kind) {
    case 0: return cluster_info(scaling_kernel_for(res, kc), cs, smem, info);
    case 1: return cluster_info(bwd_kernel_for(res, kc), cs, smem, info);
    case 2: return cluster_info(log_kernel_for(res, kc), cs, smem, info);
  }
  return -1;
}

// Whole scaling-domain solve for B pairs in one cluster launch on `stream`.
// C (B, M, N); log_mu (B, M); log_nu (B, N); out (B, M, N); K: (B, M, N)
// workspace of the streamed plan (resident == 0), else unused.
// Returns 0; -1 for a plan the kernel cannot take (N, or for RES the band, too
// large), -2 for no iterations, -3 / -4 (see launch_clusters), -5 for a plan
// whose shared bytes do not match the kernel's layout; or a CUDA error code.
int sinkhorn_scaling(const float* C, const float* log_mu, const float* log_nu,
                     float* out, float* K, int B, int M, int N, int n_iters,
                     int absorb_every, float norm, int cs, int resident,
                     int n_clusters, int kc, int smem, void* stream) {
  ScalingKernel kernel = scaling_kernel_for(resident, kc);
  if (!kernel || N > 32 * kc) return -1;
  if (n_iters < 1 || absorb_every < 1) return -2;
  const int band = (M + cs - 1) / cs;
  const Layout L = kc == KC_WIDE ? scaling_wide_layout(band, N)
                                  : scaling_layout(resident != 0, band, N);
  if (smem != (int)sizeof(float) * L.total) return -5;
  return launch_clusters(kernel, cs, n_clusters, smem, static_cast<cudaStream_t>(stream), C,
                         log_mu, log_nu, out, K, B, M, N, band, n_iters, absorb_every, norm);
}

// Exact log-domain solve, n_iters iterations, in one cluster launch on
// `stream`. C (B, M, N); log_mu (B, M); log_nu (B, N); out (B, M, N).
// stash == 0: U (B, M), V (B, N) receive the last duals.
// stash != 0: U (B, n_iters, M), V (B, n_iters, N) receive every u_t, v_t.
// Return codes as sinkhorn_scaling's.
int sinkhorn_log(const float* C, const float* log_mu, const float* log_nu, float* out,
                 float* U, float* V, int B, int M, int N, int n_iters, int stash, float norm,
                 int cs, int resident, int n_clusters, int kc, int smem, void* stream) {
  LogKernel kernel = log_kernel_for(resident, kc);
  if (!kernel || N > 32 * kc) return -1;
  if (n_iters < 1) return -2;
  const int band = (M + cs - 1) / cs;
  if (smem != (int)sizeof(float) * log_layout(resident != 0, band, N, kc).total) return -5;
  return launch_clusters(kernel, cs, n_clusters, smem, static_cast<cudaStream_t>(stream), C,
                         log_mu, log_nu, out, U, V, B, M, N, band, n_iters, stash, norm);
}

// Reverse sweep over the T stashed iterations in one cluster launch on
// `stream`. C, g, G (B, M, N); U (B, T, M); V (B, T, N); log_mu (B, M);
// log_nu (B, N). G receives the cotangent of C (it may not alias g).
// Return codes as sinkhorn_scaling's.
int sinkhorn_bwd(const float* C, const float* U, const float* V, const float* g,
                 const float* log_mu, const float* log_nu, float* G, int B, int M,
                 int N, int T, int cs, int resident, int n_clusters, int kc, int smem,
                 void* stream) {
  BwdKernel kernel = bwd_kernel_for(resident, kc);
  if (!kernel || N > 32 * kc) return -1;
  if (T < 1) return -2;
  const int band = (M + cs - 1) / cs;
  if (smem != (int)sizeof(float) * bwd_layout(resident != 0, band, N).total) return -5;
  return launch_clusters(kernel, cs, n_clusters, smem, static_cast<cudaStream_t>(stream), C,
                         U, V, g, log_mu, log_nu, G, B, M, N, T, band);
}

}  // extern "C"
