// Dustbin Sinkhorn for Hopper (sm_90a), FP32 on the CUDA cores: the four
// kernels of e2e_multi_view_matching_tpu/ops/sinkhorn_pallas.py.
//
//   sinkhorn_scaling    <- _sinkhorn_scaling_kernel    (eval forward)
//   sinkhorn_log        <- _sinkhorn_kernel            (algorithm="log"), and with
//     stash != 0        <- _sinkhorn_log_stash_kernel  (forward under grad)
//   sinkhorn_bwd        <- _sinkhorn_bwd_kernel        (reverse sweep)
//
// What bounds all of them on an H100: device-memory bytes. The TPU kernels keep
// one whole pair matrix (the backward: two) resident on chip; here one
// (401, 401) f32 training matrix is 643 KB and one (1025, 1025) eval matrix
// 4.2 MB, more than a block's 227 KB of shared memory, and a batch of 80 is 51
// MB / 336 MB against 50 MB of L2. So the matrices live in device memory, every
// iteration streams them, and the designs cut the number of passes:
//
// * Rows are whole inside a block. A block owns R rows of one pair and stages
//   them in shared memory, so every ROW reduction (u_i, a_i, the backward's
//   gu_i) finishes inside the block, and the same pass also produces the
//   block's partial COLUMN reductions. A small second launch merges the
//   partials over the row blocks in a fixed order: no atomicAdd, so two runs
//   give the same bits. One pass over the matrix per iteration instead of two.
// * The ragged edge (M, N multiples of nothing) is handled by bounds; no
//   padding enters the arithmetic, and the stash has exactly T rows.
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
//      fused into the first row pass of each block, which reads C instead of K;
//   4. output (C + (u + v)) - norm.
//
// sinkhorn_log: n_iters times the exact iteration of step 1, max-subtracted,
// u_0 = v_0 = 0; with the stash, iteration t writes u_t, v_t straight into
// U (B, T, M), V (B, T, N). Output (C + (u + v)) - norm.
//
// sinkhorn_bwd: cotangent of C for Z = C + u_T + v_T. With gu_T = rowsum(g),
// gv_T = colsum(g), G = g, for t = T-1 .. 0:
//   Q = exp((C + u_t) + (v_t - log_nu))      column softmax, entries <= 1
//   gu = [t == T-1] gu_T - rowsum(Q gv)
//   P = exp((C + v_{t-1}) + (u_t - log_mu))  row softmax (v_{-1} = 0)
//   G -= Q gv + P gu;   gv <- -colsum(P gu)
// gu_i needs only row i, so one launch per reverse step does everything for
// its rows (reads C once, reads and writes G once) and leaves column partials
// of P gu; the merge launch turns them into the next gv.
//
// Plain versions: ops/sinkhorn.py::log_sinkhorn_mxu, log_sinkhorn_stash,
// log_sinkhorn_bwd.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int R = 16;         // rows of one pair per block
constexpr int THREADS = 256;  // 8 warps, 2 rows each in the row reductions
constexpr float kTiny = 1e-30f;

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
// the row blocks in order; b = 1 where the scaling domain follows (b != nullptr).
__global__ void log_col_kernel(const float* __restrict__ pmax,
                               const float* __restrict__ psum,
                               const float* __restrict__ log_nu,
                               float* __restrict__ v, size_t sv,
                               float* __restrict__ b, int N, int nrb) {
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
  if (b) b[(size_t)pair * N + j] = 1.f;
}

// One scaling row half-step, fused with the column partial sums.
// rebuild != 0: the tile is exp(C + u + v), written back to K.
__global__ void __launch_bounds__(THREADS)
scale_row_kernel(const float* __restrict__ C, float* __restrict__ K,
                 const float* __restrict__ log_mu, const float* __restrict__ u,
                 const float* __restrict__ v, const float* __restrict__ b,
                 float* __restrict__ a, float* __restrict__ cpart, int M, int N,
                 int rebuild) {
  extern __shared__ float sm[];
  float* tile = sm;              // R * N
  float* bs = sm + R * N;        // N
  float* as = bs + N;            // R
  const int pair = blockIdx.y, rb = blockIdx.x, nrb = gridDim.x;
  const int i0 = rb * R;
  const int rows = min(R, M - i0);
  const size_t off = ((size_t)pair * M + i0) * N;
  for (int j = threadIdx.x; j < N; j += THREADS) bs[j] = b[(size_t)pair * N + j];
  if (rebuild) {
    const float* vp = v + (size_t)pair * N;
    for (int i = 0; i < rows; ++i) {
      const float ui = u[(size_t)pair * M + i0 + i];
      for (int j = threadIdx.x; j < N; j += THREADS) {
        const float kij = expf(C[off + (size_t)i * N + j] + ui + vp[j]);
        tile[i * N + j] = kij;
        K[off + (size_t)i * N + j] = kij;
      }
    }
  } else {
    for (int i = 0; i < rows; ++i)
      for (int j = threadIdx.x; j < N; j += THREADS)
        tile[i * N + j] = K[off + (size_t)i * N + j];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < rows; i += THREADS / 32) {
    float s = 0.f;
    for (int j = lane; j < N; j += 32) s = fmaf(tile[i * N + j], bs[j], s);
    s = warp_sum(s);
    if (lane == 0) {
      const float ai = expf(log_mu[(size_t)pair * M + i0 + i]) / (s + kTiny);
      as[i] = ai;
      a[(size_t)pair * M + i0 + i] = ai;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < N; j += THREADS) {
    float s = 0.f;
    for (int i = 0; i < rows; ++i) s = fmaf(tile[i * N + j], as[i], s);
    cpart[((size_t)pair * nrb + rb) * N + j] = s;
  }
}

// b_j = nu_j / (sum of the column partials + 1e-30); with absorb != 0 also
// u += log(a + 1e-30), v += log(b + 1e-30) and b = 1.
__global__ void scale_col_kernel(const float* __restrict__ cpart,
                                 const float* __restrict__ log_nu,
                                 const float* __restrict__ a,
                                 float* __restrict__ b, float* __restrict__ u,
                                 float* __restrict__ v, int M, int N, int nrb,
                                 int absorb) {
  const int pair = blockIdx.y;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < N) {
    const float* cp = cpart + (size_t)pair * nrb * N + idx;
    float s = 0.f;
    for (int r = 0; r < nrb; ++r) s += cp[(size_t)r * N];
    const float bj = expf(log_nu[(size_t)pair * N + idx]) / (s + kTiny);
    if (absorb) {
      v[(size_t)pair * N + idx] += logf(bj + kTiny);
      b[(size_t)pair * N + idx] = 1.f;
    } else {
      b[(size_t)pair * N + idx] = bj;
    }
  }
  if (absorb && idx < M) u[(size_t)pair * M + idx] += logf(a[(size_t)pair * M + idx] + kTiny);
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

// Reverse sweep, start: gu0_i = sum_j g_ij for the block's rows and the block's
// column partials sum_i g_ij. grid (n_row_blocks, B).
__global__ void __launch_bounds__(THREADS)
bwd_init_kernel(const float* __restrict__ g, float* __restrict__ gu0,
                float* __restrict__ cpart, int M, int N) {
  const int pair = blockIdx.y, rb = blockIdx.x, nrb = gridDim.x;
  const int i0 = rb * R;
  const int rows = min(R, M - i0);
  const float* gp = g + ((size_t)pair * M + i0) * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < rows; i += THREADS / 32) {
    float s = 0.f;
    for (int j = lane; j < N; j += 32) s += gp[(size_t)i * N + j];
    s = warp_sum(s);
    if (lane == 0) gu0[(size_t)pair * M + i0 + i] = s;
  }
  for (int j = threadIdx.x; j < N; j += THREADS) {
    float s = 0.f;
    for (int i = 0; i < rows; ++i) s += gp[(size_t)i * N + j];
    cpart[((size_t)pair * nrb + rb) * N + j] = s;
  }
}

// gv_j = sign * (sum of the column partials over the row blocks, in order)
__global__ void bwd_col_kernel(const float* __restrict__ cpart,
                               float* __restrict__ gv, int N, int nrb,
                               float sign) {
  const int pair = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= N) return;
  const float* cp = cpart + (size_t)pair * nrb * N + j;
  float s = 0.f;
  for (int r = 0; r < nrb; ++r) s += cp[(size_t)r * N];
  gv[(size_t)pair * N + j] = sign * s;
}

// One reverse step for R rows of one pair. grid (n_row_blocks, B).
// u_t, v_t, v_prev point at this step's rows of the stash (strides su, sv
// between pairs); v_prev == nullptr at t = 0 (v_{-1} = 0); gu0 != nullptr only
// in the first reverse step, which also reads the cotangent from Gin = g
// instead of G (Gin and G may be the same buffer: each element is read and
// written by the same thread).
__global__ void __launch_bounds__(THREADS)
bwd_step_kernel(const float* __restrict__ C, const float* Gin, float* G,
                const float* __restrict__ u_t, const float* __restrict__ v_t,
                const float* __restrict__ v_prev, size_t su, size_t sv,
                const float* __restrict__ log_mu, const float* __restrict__ log_nu,
                const float* __restrict__ gu0, const float* __restrict__ gv,
                float* __restrict__ cpart, int M, int N) {
  extern __shared__ float sm[];
  float* tc = sm;            // R * N   couplings
  float* tq = tc + R * N;    // R * N   Q * gv
  float* gvs = tq + R * N;   // N       gv
  float* qv = gvs + N;       // N       v_t - log_nu
  float* vp = qv + N;        // N       v_{t-1}
  float* us = vp + N;        // R       u_t
  float* um = us + R;        // R       u_t - log_mu
  float* gus = um + R;       // R       gu
  const int pair = blockIdx.y, rb = blockIdx.x, nrb = gridDim.x;
  const int i0 = rb * R;
  const int rows = min(R, M - i0);
  const size_t off = ((size_t)pair * M + i0) * N;
  for (int j = threadIdx.x; j < N; j += THREADS) {
    gvs[j] = gv[(size_t)pair * N + j];
    qv[j] = v_t[(size_t)pair * sv + j] - log_nu[(size_t)pair * N + j];
    vp[j] = v_prev ? v_prev[(size_t)pair * sv + j] : 0.f;
  }
  if (threadIdx.x < rows) {
    const float ui = u_t[(size_t)pair * su + i0 + threadIdx.x];
    us[threadIdx.x] = ui;
    um[threadIdx.x] = ui - log_mu[(size_t)pair * M + i0 + threadIdx.x];
  }
  for (int i = 0; i < rows; ++i)
    for (int j = threadIdx.x; j < N; j += THREADS)
      tc[i * N + j] = C[off + (size_t)i * N + j];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < rows; i += THREADS / 32) {
    const float ui = us[i];
    float s = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float q = expf((tc[i * N + j] + ui) + qv[j]) * gvs[j];
      tq[i * N + j] = q;
      s += q;
    }
    s = warp_sum(s);
    if (lane == 0)
      gus[i] = (gu0 ? gu0[(size_t)pair * M + i0 + i] : 0.f) - s;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < N; j += THREADS) {
    const float vpj = vp[j];
    float cs = 0.f;
    for (int i = 0; i < rows; ++i) {
      const float p = expf((tc[i * N + j] + vpj) + um[i]) * gus[i];
      const size_t o = off + (size_t)i * N + j;
      G[o] = Gin[o] - (tq[i * N + j] + p);
      cs += p;
    }
    cpart[((size_t)pair * nrb + rb) * N + j] = cs;
  }
}

}  // namespace

extern "C" {

// Rows per block; the Python wrapper sizes the partial-sum workspace with it.
int sinkhorn_rows_per_block() { return R; }

// Whole scaling-domain solve for B pairs, all launches on `stream`.
// C (B, M, N); log_mu (B, M); log_nu (B, N); out (B, M, N).
// Workspace: K (B, M, N); u, a (B, M); v, b (B, N);
// part0, part1 (B, ceil(M / R), N).
// Returns 0, -1 when N is too wide for the shared-memory tile, or the first
// non-zero cudaGetLastError() code.
int sinkhorn_scaling(const float* C, const float* log_mu, const float* log_nu,
                     float* out, float* K, float* u, float* v, float* a,
                     float* b, float* part0, float* part1, int B, int M, int N,
                     int n_iters, int absorb_every, float norm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem_log = (size_t)(R * N + N + R) * sizeof(float);
  const size_t smem_scale = (size_t)(R * N + N + R) * sizeof(float);
  if (smem_scale > 227 * 1024) return -1;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(log_row_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem_log)) != cudaSuccess) return (int)e;
  if ((e = cudaFuncSetAttribute(scale_row_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem_scale)) != cudaSuccess) return (int)e;
  const int nrb = (M + R - 1) / R;
  const dim3 grid_rows(nrb, B);
  const int ct = 256;
  const dim3 grid_cols(((M > N ? M : N) + ct - 1) / ct, B);
  const int n_absorb = (n_iters + absorb_every - 1) / absorb_every;

  log_row_kernel<<<grid_rows, THREADS, smem_log, st>>>(
      C, log_mu, nullptr, 0, u, (size_t)M, part0, part1, M, N);
  log_col_kernel<<<grid_cols, ct, 0, st>>>(part0, part1, log_nu, v, (size_t)N, b,
                                           N, nrb);
  for (int blk = 0; blk < n_absorb; ++blk) {
    const int first = blk == 0 ? 1 : 0;  // the exact iteration opens block 1
    for (int it = first; it < absorb_every; ++it) {
      scale_row_kernel<<<grid_rows, THREADS, smem_scale, st>>>(
          C, K, log_mu, u, v, b, a, part0, M, N, it == first ? 1 : 0);
      scale_col_kernel<<<grid_cols, ct, 0, st>>>(
          part0, log_nu, a, b, u, v, M, N, nrb, it == absorb_every - 1 ? 1 : 0);
    }
  }
  output_kernel<<<dim3((N + ct - 1) / ct, M, B), ct, 0, st>>>(
      C, u, (size_t)M, v, (size_t)N, out, M, N, norm);
  return (int)cudaGetLastError();
}

// Exact log-domain solve, n_iters >= 1 iterations, all launches on `stream`.
// stash == 0: U (B, M), V (B, N) hold the running duals.
// stash != 0: U (B, n_iters, M), V (B, n_iters, N) receive every u_t, v_t.
// Workspace: part0, part1 (B, ceil(M / R), N). Return codes as above.
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
    log_col_kernel<<<grid_cols, ct, 0, st>>>(part0, part1, log_nu, v_out, sv,
                                             nullptr, N, nrb);
    v_in = v_out;
  }
  output_kernel<<<dim3((N + ct - 1) / ct, M, B), ct, 0, st>>>(
      C, u_out, su, v_out, sv, out, M, N, norm);
  return (int)cudaGetLastError();
}

// Reverse sweep over the T stashed iterations, all launches on `stream`.
// C, g, G (B, M, N); U (B, T, M); V (B, T, N); log_mu (B, M); log_nu (B, N).
// G receives the cotangent of C (it may not alias g).
// Workspace: gu0 (B, M); gv (B, N); cpart (B, ceil(M / R), N).
int sinkhorn_bwd(const float* C, const float* U, const float* V, const float* g,
                 const float* log_mu, const float* log_nu, float* G, float* gu0,
                 float* gv, float* cpart, int B, int M, int N, int T,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)(2 * R * N + 3 * N + 3 * R) * sizeof(float);
  if (smem > 227 * 1024) return -1;
  if (T < 1) return -2;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(bwd_step_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess) return (int)e;
  const int nrb = (M + R - 1) / R;
  const dim3 grid_rows(nrb, B);
  const int ct = 256;
  const dim3 grid_cols((N + ct - 1) / ct, B);
  const size_t su = (size_t)T * M, sv = (size_t)T * N;

  bwd_init_kernel<<<grid_rows, THREADS, 0, st>>>(g, gu0, cpart, M, N);
  bwd_col_kernel<<<grid_cols, ct, 0, st>>>(cpart, gv, N, nrb, 1.f);
  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    bwd_step_kernel<<<grid_rows, THREADS, smem, st>>>(
        C, s == 0 ? g : G, G, U + (size_t)t * M, V + (size_t)t * N,
        t > 0 ? V + (size_t)(t - 1) * N : nullptr, su, sv, log_mu, log_nu,
        s == 0 ? gu0 : nullptr, gv, cpart, M, N);
    bwd_col_kernel<<<grid_cols, ct, 0, st>>>(cpart, gv, N, nrb, -1.f);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
