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
// sinkhorn_scaling and sinkhorn_bwd: one thread-block cluster owns one pair
// matrix for all its iterations, in one launch; the clusters are persistent,
// each walking over the pairs cid, cid + n_clusters, ...
//
// * The cluster's CS blocks (one per SM) split the rows into contiguous
//   bands. Warp w of a block owns the band rows w, w + 16, ...; lane l owns
//   the columns l, l + 32, ... (KC of them). A warp takes one row at a time
//   into registers, every load of the row in flight at once (lanes past N
//   load nothing), so every ROW reduction (a_i, the first iteration's u_i,
//   the sweep's gu_i) finishes inside a warp, and the row's contribution to
//   the COLUMN reductions stays in the lanes' registers for the whole pass.
// * Every column reduction goes through distributed shared memory (DSMEM):
//   the block sums its 16 warps' vectors in warp order and writes its band's
//   partial vector to its own shared memory; after the cluster barrier every
//   block copies the CS partial vectors (map_shared_rank, 16 bytes a load)
//   and sums them in rank order into the whole b (gv, or the first
//   iteration's column log-sum-exp from (max, sum) pairs) itself. Every block
//   forms the same bits, so one cluster barrier per iteration is enough; the
//   partials are double buffered so that iteration t+1's writes cannot race
//   iteration t's reads. No atomics: two runs give the same bits.
// * Residency is one template parameter RES of each kernel body. RES (the
//   401 x 401 shapes): the band stays in shared memory for all iterations
//   and every input is read from device memory once. sinkhorn_scaling keeps
//   its band of K (C is copied in again, with cp.async while the cluster
//   exchanges, before each of the 10 rebuilds); sinkhorn_bwd keeps its bands
//   of C and G and writes G once, at the end; the stashed U[:, t] and
//   V[:, t-1:t+1] rows are the only per-step reads, staged while the cluster
//   waits at its barrier. !RES (the 1025 x 1025 shapes): rows stream from
//   device memory straight into registers (a row is consumed by the warp
//   that loads it), and n_clusters is chosen so that the matrices in flight
//   (K; C and G) stay inside the 50 MB L2.
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
// u_0 = v_0 = 0; with the stash, iteration t writes u_t, v_t straight into
// U (B, T, M), V (B, T, N). Output (C + (u + v)) - norm. A block owns R =
// 16 rows of one pair, stages them in shared memory and finishes their row
// reductions; a second launch merges the column partials over the row blocks
// in a fixed order (no atomics), two launches an iteration.
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
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int R = 16;         // rows of one pair per block (log kernels)
constexpr int THREADS = 256;  // 8 warps, 2 rows each in the row reductions
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

// One exact log-domain iteration, row half-step + column partial log-sum-exps.
// grid (n_row_blocks, B). u_i = log_mu_i - LSE_j(C_ij + v_j) (v == nullptr: 0);
// then per column the block's partial (max, sum exp) of C_ij + u_i over its
// rows. sv, su: elements between two pairs in v and u (the stash is strided).
__global__ void __launch_bounds__(THREADS)
log_row_kernel(const float* __restrict__ C, const float* __restrict__ log_mu,
               const float* __restrict__ v, size_t sv, float* __restrict__ u,
               size_t su, float* __restrict__ pmax, float* __restrict__ psum,
               int M, int N) {
  extern __shared__ float sm[];
  float* tile = sm;          // R * N
  float* vs = sm + R * N;    // N
  float* us = vs + N;        // R
  const int pair = blockIdx.y, rb = blockIdx.x, nrb = gridDim.x;
  const int i0 = rb * R;
  const int rows = min(R, M - i0);
  const float* Cp = C + ((size_t)pair * M + i0) * N;
  for (int j = threadIdx.x; j < N; j += THREADS)
    vs[j] = v ? v[(size_t)pair * sv + j] : 0.f;
  for (int i = 0; i < rows; ++i)
    for (int j = threadIdx.x; j < N; j += THREADS)
      tile[i * N + j] = Cp[(size_t)i * N + j];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < rows; i += THREADS / 32) {
    float mx = -INFINITY;
    for (int j = lane; j < N; j += 32) mx = fmaxf(mx, tile[i * N + j] + vs[j]);
    mx = warp_max(mx);
    float s = 0.f;
    for (int j = lane; j < N; j += 32) s += expf((tile[i * N + j] + vs[j]) - mx);
    s = warp_sum(s);
    if (lane == 0) {
      const float ui = log_mu[(size_t)pair * M + i0 + i] - (logf(s) + mx);
      us[i] = ui;
      u[(size_t)pair * su + i0 + i] = ui;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < N; j += THREADS) {
    float mx = -INFINITY;
    for (int i = 0; i < rows; ++i) mx = fmaxf(mx, tile[i * N + j] + us[i]);
    float s = 0.f;
    for (int i = 0; i < rows; ++i) s += expf((tile[i * N + j] + us[i]) - mx);
    const size_t o = ((size_t)pair * nrb + rb) * N + j;
    pmax[o] = mx;
    psum[o] = s;
  }
}

// v_j = log_nu_j - LSE_i(C_ij + u_i) from the per-block partials, merged over
// the row blocks in order.
__global__ void log_col_kernel(const float* __restrict__ pmax,
                               const float* __restrict__ psum,
                               const float* __restrict__ log_nu,
                               float* __restrict__ v, size_t sv, int N, int nrb) {
  const int pair = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= N) return;
  const float* pm = pmax + (size_t)pair * nrb * N + j;
  const float* ps = psum + (size_t)pair * nrb * N + j;
  float mx = -INFINITY;
  for (int r = 0; r < nrb; ++r) mx = fmaxf(mx, pm[(size_t)r * N]);
  float s = 0.f;
  for (int r = 0; r < nrb; ++r) s += ps[(size_t)r * N] * expf(pm[(size_t)r * N] - mx);
  v[(size_t)pair * sv + j] = log_nu[(size_t)pair * N + j] - (logf(s) + mx);
}

// out = (C + (u + v)) - norm; su, sv: elements between two pairs in u and v
__global__ void output_kernel(const float* __restrict__ C,
                              const float* __restrict__ u, size_t su,
                              const float* __restrict__ v, size_t sv,
                              float* __restrict__ out, int M, int N,
                              float norm) {
  const int pair = blockIdx.z, i = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= N) return;
  const size_t o = ((size_t)pair * M + i) * N + j;
  out[o] = (C[o] + (u[(size_t)pair * su + i] + v[(size_t)pair * sv + j])) - norm;
}

// ---------------------------------------------------------------------------
// Cluster kernels (sinkhorn_scaling, sinkhorn_bwd)

constexpr int CS_MAX = 8;         // the largest cluster the plan asks for
constexpr int KC_STREAMED = 33;   // columns a lane when streamed: N <= 1056

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

__host__ __device__ constexpr Layout bwd_layout(bool res, int band, int N) {
  // C band, G band (RES) | the warps' column sums | the gathered partials |
  // 2 parities of partials | gv, v_t - log_nu, v_{t-1}, log_nu | u_t, u_t -
  // log_mu, gu_T, log_mu of the rows
  const int NP = round4(N), w = res ? 2 * band * NP : 0, st = w + CW * NP;
  return {0, res ? band * NP : 0, w, st, st + CS_MAX * NP, 0, st + (CS_MAX + 2) * NP,
          st + (CS_MAX + 6) * NP, st + (CS_MAX + 6) * NP + 4 * round4(band)};
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
  for (int j = threadIdx.x; j < N; j += CT) {
    float s = take_max ? -INFINITY : 0.f;
#pragma unroll
    for (int w = 0; w < CW; ++w) s = take_max ? fmaxf(s, wsum[w * NP + j]) : s + wsum[w * NP + j];
    col[j] = s;
  }
  __syncthreads();
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
template <bool RES, int KC>
__global__ void __launch_bounds__(CT, 1)
scaling_cluster_kernel(const float* __restrict__ C, const float* __restrict__ log_mu,
                       const float* __restrict__ log_nu, float* __restrict__ out,
                       float* __restrict__ K, int B, int M, int N, int band,
                       int n_iters, int absorb_every, float norm) {
  constexpr bool B_REGS = RES && KC <= 16;
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
  const Layout L = scaling_layout(RES, band, N);
  float* mat = csm + L.mat;       // RES: the band of C, then of K, as a span
  float* wsum = csm + L.wsum;     // CW x NP: the warps' column sums
  float* stage = csm + L.stage;   // CS_MAX x NP
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
  float x[KC], acc[KC];  // a row's entries, the lane's column sums
  float bq[B_REGS ? KC : 1];  // B_REGS: the lane's entries of b

  // x = the lane's entries of a row, `pad` past N
  auto load_row = [&](const float* row, float pad) {
    const float* p = row + lane;
#pragma unroll
    for (int k = 0; k < KC; ++k) x[k] = k < kv ? p[32 * k] : pad;
  };
  // the lane's entries of row r into the band of K (RES; rows from kb) or
  // K's workspace
  auto keep_row = [&](float* kb, float* kp, int r) {
    float* p = (RES ? kb + r * N : kp + (size_t)r * N) + lane;
#pragma unroll
    for (int k = 0; k < KC; ++k)
      if (k < kv) p[32 * k] = x[k];
  };

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
#pragma unroll
    for (int k = 0; k < KC; ++k) acc[k] = -INFINITY;
    for (int q = 0; q < nq; ++q) {
      const int r = warp + q * CW;
      load_row(RES ? kb + r * N : Cp + (size_t)r * N, -INFINITY);
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
      for (int k = 0; k < KC; ++k) acc[k] = fmaxf(acc[k], x[k] + ui);
    }
    warps_to_columns(acc, wsum, cmax, N, kv, true);
#pragma unroll
    for (int k = 0; k < KC; ++k) acc[k] = 0.f;
    for (int q = 0; q < nq; ++q) {
      const int r = warp + q * CW;
      load_row(RES ? kb + r * N : Cp + (size_t)r * N, 0.f);
      const float ui = su[r];
      const float* cm = cmax + lane;
#pragma unroll
      for (int k = 0; k < KC; ++k)
        if (k < kv) acc[k] += expf((x[k] + ui) - cm[32 * k]);
    }
    warps_to_columns(acc, wsum, csum, N, kv, false);
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
      if constexpr (B_REGS) {
        const float* p = sb + lane;
#pragma unroll
        for (int k = 0; k < KC; ++k) bq[k] = k < kv ? p[32 * k] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < KC; ++k) acc[k] = 0.f;
      for (int q = 0; q < nq; ++q) {
        const int r = warp + q * CW;
        if (rebuild) {  // K = exp(C + u + v)
          load_row(RES ? kb + r * N : Cp + (size_t)r * N, 0.f);
          const float ui = su[r];
          const float* vp = sv + lane;
#pragma unroll
          for (int k = 0; k < KC; ++k)
            if (k < kv) x[k] = expf((x[k] + ui) + vp[32 * k]);
          keep_row(kb, Kp, r);
        } else {
          load_row(RES ? kb + r * N : Kp + (size_t)r * N, 0.f);
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
        for (int k = 0; k < KC; ++k) acc[k] = fmaf(x[k], a, acc[k]);
      }
      cluster_column_sums(cluster, acc, wsum, part + par * 2 * NP, stage, N, kv, [&] {
        if (RES && it + 1 < n_scale && rebuilds(it + 1)) fetch_span(mat, Cp, rows * N);
      });
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

  auto load_row = [&](float (&xs)[KC], const float* row) {
    const float* p = row + lane;
#pragma unroll
    for (int k = 0; k < KC; ++k) xs[k] = k < kv ? p[32 * k] : 0.f;
  };
  auto store_row = [&](const float (&xs)[KC], float* row) {
    float* p = row + lane;
#pragma unroll
    for (int k = 0; k < KC; ++k)
      if (k < kv) p[32 * k] = xs[k];
  };
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
      load_row(x, gp + (size_t)r * N);
      store_row(x, RES ? gmat + r * NP : Gp + (size_t)r * N);
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        s += x[k];
        acc[k] += x[k];
      }
      s = warp_sum(s);
      if (lane == 0) sgu0[r] = s;
      if constexpr (RES) {
        load_row(x, Cp + (size_t)r * N);
        store_row(x, cmat + r * NP);
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
        load_row(qv, sqv);
        load_row(gv, sgv);
        load_row(vp, svp);
      }
#pragma unroll
      for (int k = 0; k < KC; ++k) acc[k] = 0.f;
      for (int q = 0; q < nq; ++q) {
        const int r = warp + q * CW;
        load_row(x, RES ? cmat + r * NP : Cp + (size_t)r * N);
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
        load_row(x, grow);
#pragma unroll
        for (int k = 0; k < KC; ++k) x[k] = x[k] - tq[k];
        store_row(x, grow);
      }
      exchange(-1.f, [&] { stage_step(s + 1); });
    }

    if constexpr (RES)
      for (int q = 0; q < nq; ++q) {
        const int r = warp + q * CW;
        load_row(x, gmat + r * NP);
        store_row(x, Gp + (size_t)r * N);
      }
    __syncthreads();
  }
  cluster.sync();  // no block leaves while another may still read its partials
}

using ScalingKernel = void (*)(const float*, const float*, const float*, float*, float*,
                               int, int, int, int, int, int, float);
using BwdKernel = void (*)(const float*, const float*, const float*, const float*,
                           const float*, const float*, float*, int, int, int, int, int);

// The instantiations the plan can name (kc: columns a lane); nullptr for any
// other.
ScalingKernel scaling_kernel_for(int res, int kc) {
  if (!res) return kc == KC_STREAMED ? scaling_cluster_kernel<false, KC_STREAMED> : nullptr;
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

}  // namespace

extern "C" {

// Rows per block of the log kernels; the Python wrapper sizes their
// partial-sum workspace with it.
int sinkhorn_rows_per_block() { return R; }

// A cluster kernel of the plan (kind 0: scaling with kc columns a lane, 1:
// sweep; resident or streamed): info[0] = the clusters of `cs` blocks with `smem` bytes each
// that the card holds at once, info[1] = registers per thread, info[2] =
// local (spill) bytes per thread. Returns 0, -1 for a scaling kernel that is
// not instantiated, or a CUDA error.
int sinkhorn_cluster_info(int kind, int res, int kc, int cs, int smem, int* info) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(cs, 1, smem, nullptr, &attr);
  cudaFuncAttributes fa;
  int fit;
  cudaError_t e;
  if (kind == 0) {
    ScalingKernel k = scaling_kernel_for(res, kc);
    if (!k) return -1;
    fit = prepare(k, cs, smem, &cfg);
    e = cudaFuncGetAttributes(&fa, k);
  } else {
    BwdKernel k = bwd_kernel_for(res, kc);
    if (!k) return -1;
    fit = prepare(k, cs, smem, &cfg);
    e = cudaFuncGetAttributes(&fa, k);
  }
  if (fit < 0) return -fit;
  if (e != cudaSuccess) return (int)e;
  info[0] = fit;
  info[1] = fa.numRegs;
  info[2] = (int)fa.localSizeBytes;
  return 0;
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
  if (smem != (int)sizeof(float) * scaling_layout(resident != 0, band, N).total) return -5;
  return launch_clusters(kernel, cs, n_clusters, smem, static_cast<cudaStream_t>(stream), C,
                         log_mu, log_nu, out, K, B, M, N, band, n_iters, absorb_every, norm);
}

// Exact log-domain solve, n_iters >= 1 iterations, all launches on `stream`.
// stash == 0: U (B, M), V (B, N) hold the running duals.
// stash != 0: U (B, n_iters, M), V (B, n_iters, N) receive every u_t, v_t.
// Workspace: part0, part1 (B, ceil(M / R), N). Returns 0, -1 when N is too
// wide for the shared-memory tile, -2 for no iterations, or the first
// non-zero cudaGetLastError() code.
int sinkhorn_log(const float* C, const float* log_mu, const float* log_nu,
                 float* out, float* U, float* V, float* part0, float* part1,
                 int B, int M, int N, int n_iters, int stash, float norm,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)(R * N + N + R) * sizeof(float);
  if (smem > 227 * 1024) return -1;
  if (n_iters < 1) return -2;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(log_row_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess) return (int)e;
  const int nrb = (M + R - 1) / R;
  const dim3 grid_rows(nrb, B);
  const int ct = 256;
  const dim3 grid_cols((N + ct - 1) / ct, B);
  const size_t su = stash ? (size_t)n_iters * M : (size_t)M;
  const size_t sv = stash ? (size_t)n_iters * N : (size_t)N;
  const float* v_in = nullptr;  // v_0 = 0
  float* u_out = U;
  float* v_out = V;
  for (int t = 0; t < n_iters; ++t) {
    if (stash) {
      u_out = U + (size_t)t * M;
      v_out = V + (size_t)t * N;
    }
    log_row_kernel<<<grid_rows, THREADS, smem, st>>>(C, log_mu, v_in, sv, u_out,
                                                    su, part0, part1, M, N);
    log_col_kernel<<<grid_cols, ct, 0, st>>>(part0, part1, log_nu, v_out, sv, N, nrb);
    v_in = v_out;
  }
  output_kernel<<<dim3((N + ct - 1) / ct, M, B), ct, 0, st>>>(
      C, u_out, su, v_out, sv, out, M, N, norm);
  return (int)cudaGetLastError();
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
