// potrf_block_f32: lower Cholesky of one n <= 1024 block, in place.
//
// Replaces cholesky_tpu/ops/pallas/mega.py:potrf_vmem_f32
// (_potrf_vmem_kernel with _chol_tile_grouped, _chol_tile_rows and
// _newton_uinv). On the main path it factors the whole matrix for
// n <= 1024, every diagonal block of the blocked recursion and every
// 128-wide leaf of the d and z tiers.
//
// Contract: only the lower triangle is read; the strict upper is zeroed;
// nothing outside the n x n view (row stride lda >= n) is written. info is
// the 1-based index of the first pivot with !(d > 0), NaN-safe. The
// factorization freezes at a failed pivot: the panel holding it stores
// only its diagonal tile, and nothing after it is updated, so every stored
// value stays finite except an input NaN at its own position.
//
// What bounds it on the H100: not its n^3/3 FFMA (5.3 us at 1024 on the
// 67 TF/s FP32 peak) but the chain of n/32 panels, each factored only
// after the previous panel's update: per panel the stage from L2, a
// 32-step pivot chain, a 32-step substitution per row, then the update.
// The TPU kernel kept the block in one core's VMEM; here one SM would do
// all of the update's FFMA as well (on an H100 at 1024: 3.3 ms on one
// thread block, 0.8 on many), so above the crossover the update is spread.
//
// Design: right-looking over 32-wide panels, each panel in four steps:
//   stage  the panel (all rows below the diagonal, at most 1024 x 32 f32
//          = 128 KB) into shared memory, column-major with an odd stride;
//   factor its 32 x 32 diagonal tile in warp 0's registers, lane l holding
//          row l, column k reaching the other lanes by __shfl_sync (the
//          tile of chol_tile.cuh; a ragged last tile is padded with
//          identity rows, which never fail and decouple);
//   solve  every row below by forward substitution from registers, two
//          rows per thread, interleaved, against the tile's reciprocal
//          diagonal (a right-looking order, whose chain is shorter, read
//          slower on the card);
//   update the lower 64 x 64 tiles of the trailing matrix, A22 -= X·Xᵀ
//          (k = 32), teams of 256 threads with 4 x 4 register micro-tiles.
// 512 threads a CTA, so that a thread may hold 128 registers: the pivot
// chain's row and the two solved rows stay in registers (with 1024
// threads, 64 registers each, they spill). The panel's loads are issued
// 16 rows at a time and a tile's old values before its stores, so that no
// load waits out another's latency. One CTA (plain launch, multi = 0) runs
// every step. With
// multi = 1 the kernel is one cooperative launch of enough CTAs for one
// update tile per team at the first panel (68 at n = 1024, capped by the
// card's co-resident limit): every CTA stages, factors and solves the
// panel itself, all of them bit for bit alike, so that no grid-wide sync
// separates the factor from the update; the CTAs split the trailing tiles
// and meet once per panel at a grid sync. A solved panel is written back
// to A only after that sync, each CTA its share of the rows, because the
// other CTAs read the unsolved panel until then. A failed pivot is seen
// by every CTA at once (the same tile, the same arithmetic); block 0
// publishes it in info before the panel's sync, and every CTA leaves the
// loop on info after it, so no grid sync is left waiting. Every read of
// data another CTA wrote bypasses L1 (__ldcg). The wrapper picks multi by
// n (ops/kernels/mega.py, from an A/B on the card); the device's limits
// are queried once, at the first launch on it.
#include <cooperative_groups.h>

#include "sgemm_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int W = 32;         // panel width: warp 0 owns the tile rows
constexpr int NT = 512;       // threads of a block: two panel rows each
constexpr int MAX_N = 1024;
constexpr int TT = 64;        // trailing-update tile edge
constexpr int TEAM = 256;     // threads per trailing tile (16 x 16, 4 x 4)
constexpr int TEAMS = NT / TEAM;
constexpr int STAGE_ROWS = 16;  // panel rows a warp loads before storing

// Write rows [0, rows) of the staged panel (column c0, width w) back to A,
// the lower part of its diagonal tile and every row below; this block's
// share of the elements when nblk blocks split them.
__device__ __forceinline__ void store_panel(float* A, long long lda, int c0,
                                            int w, int rows, const float* P,
                                            int ldp, int blk, int nblk) {
  float* const Ac = A + (long long)c0 * lda + c0;
  for (int idx = blk * NT + threadIdx.x; idx < rows * w; idx += nblk * NT) {
    const int k = idx % w, i = idx / w;
    if (i >= k) Ac[(long long)i * lda + k] = P[k * ldp + i];
  }
}

// Steps 3 and 4 of one panel (column c0, rows rows, a full one: rows below
// the tile exist only under a panel of width W): each row below the tile
// solves x·L11ᵀ = a in registers, then this block's teams take their
// lower 64 x 64 tiles of A22 -= X·Xᵀ.
__device__ __forceinline__ void solve_and_update(float* A, long long lda,
                                                 int c0, int rows, float* P,
                                                 int ldp, const float* dinv,
                                                 int blk, int nblk) {
  const int tid = threadIdx.x;
  // rows i and i + NT together, so that their two chains interleave
  for (int i = W + tid; i < rows; i += 2 * NT) {
    const bool two = i + NT < rows;
    float x[W], y[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      float s = P[k * ldp + i];
      float u = two ? P[k * ldp + i + NT] : 0.f;
#pragma unroll
      for (int m = 0; m < k; ++m) {
        const float lkm = P[m * ldp + k];
        s = fmaf(-x[m], lkm, s);
        u = fmaf(-y[m], lkm, u);
      }
      x[k] = s * dinv[k];
      y[k] = u * dinv[k];
    }
#pragma unroll
    for (int k = 0; k < W; ++k) {
      P[k * ldp + i] = x[k];
      if (two) P[k * ldp + i + NT] = y[k];
    }
  }
  __syncthreads();

  const int m = rows - W;
  if (m <= 0) return;
  float* const A22 = A + (long long)(c0 + W) * lda + c0 + W;
  const float* const X = P + W;
  const int nt = (m + TT - 1) / TT;
  const int ntiles = nt * (nt + 1) / 2;
  const int lt = tid % TEAM;
  const int tx = lt % (TT / ct::TN), ty = lt / (TT / ct::TN);
  for (int t = blk * TEAMS + tid / TEAM; t < ntiles; t += nblk * TEAMS) {
    int bi, bj;
    ct::tri_tile(t, bi, bj);
    int ri[ct::TM], ci[ct::TN];
#pragma unroll
    for (int a = 0; a < ct::TM; ++a)
      ri[a] = min(bi * TT + ty + a * (TT / ct::TM), m - 1);
#pragma unroll
    for (int b = 0; b < ct::TN; ++b)
      ci[b] = min(bj * TT + tx + b * (TT / ct::TN), m - 1);
    float acc[ct::TM][ct::TN] = {};
#pragma unroll 8
    for (int k = 0; k < W; ++k) {
      const float* xk = X + k * ldp;
      float a[ct::TM], b[ct::TN];
#pragma unroll
      for (int i = 0; i < ct::TM; ++i) a[i] = xk[ri[i]];
#pragma unroll
      for (int j = 0; j < ct::TN; ++j) b[j] = xk[ci[j]];
#pragma unroll
      for (int i = 0; i < ct::TM; ++i)
#pragma unroll
        for (int j = 0; j < ct::TN; ++j)
          acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // all 16 old values in flight at once, then the stores: a load after
    // a store to A could alias it, and would wait out its own latency
    float old[ct::TM][ct::TN];
#pragma unroll
    for (int i = 0; i < ct::TM; ++i)
#pragma unroll
      for (int j = 0; j < ct::TN; ++j)
        old[i][j] = __ldcg(A22 + (long long)ri[i] * lda + ci[j]);
#pragma unroll
    for (int i = 0; i < ct::TM; ++i) {
      const int r = bi * TT + ty + i * (TT / ct::TM);
#pragma unroll
      for (int j = 0; j < ct::TN; ++j) {
        const int c = bj * TT + tx + j * (TT / ct::TN);
        if (r < m && c <= r)
          A22[(long long)r * lda + c] = old[i][j] - acc[i][j];
      }
    }
  }
}

template <bool MULTI>
__global__ void __launch_bounds__(NT, 1)
potrf_block_f32_kernel(float* A, long long lda, int n, int* info) {
  // P[k * ldp + i] = panel element (row c0 + i, column c0 + k); ldp is odd
  // so the 32 columns of one row fall in 32 different banks
  extern __shared__ float P[];
  __shared__ float dinv[W];
  __shared__ int s_fail;
  const int tid = threadIdx.x;
  const int blk = MULTI ? blockIdx.x : 0, nblk = MULTI ? gridDim.x : 1;
  const int ldp = n | 1;

  // exact zeros in the strict upper triangle (never read): block b, warp q
  // clear rows b·32 + q, + 32·nblk, ...
  const int lane = tid % 32;
  for (int i = blk * (NT / 32) + tid / 32; i < n; i += nblk * (NT / 32))
    for (int j = i + 1 + lane; j < n; j += 32) A[(long long)i * lda + j] = 0.f;

  if (blk == 0 && tid == 0) *info = 0;   // read by all after a sync
  bool failed = false;
  for (int c0 = 0; c0 < n; c0 += W) {
    const int w = min(W, n - c0);
    const int rows = n - c0;
    const float* const Ac = A + (long long)c0 * lda + c0;

    // 0. the previous panel, solved and staged, goes back to A: no block
    // reads it after the last sync
    if (c0 > 0) {
      store_panel(A, lda, c0 - W, W, rows + W, P, ldp, blk, nblk);
      __syncthreads();
    }

    // 1. stage the panel's lower part (the tile's strict upper reads as
    // 0): lane k of a warp reads column k of a row, STAGE_ROWS rows' loads
    // in flight before the first store
    for (int i0 = tid / 32; i0 < rows; i0 += STAGE_ROWS * (NT / 32)) {
      float v[STAGE_ROWS];
#pragma unroll
      for (int u = 0; u < STAGE_ROWS; ++u) {
        const int i = i0 + u * (NT / 32);
        v[u] = (i < rows && lane < w && i >= lane)
                   ? __ldcg(Ac + (long long)i * lda + lane) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < STAGE_ROWS; ++u) {
        const int i = i0 + u * (NT / 32);
        if (i < rows && lane < w) P[lane * ldp + i] = v[u];
      }
    }
    if (tid == 0) s_fail = 0;
    __syncthreads();

    // 2. warp 0 factors the diagonal tile, lane l holding row l in
    // registers; rows l >= w are identity rows
    if (tid < 32) {
      const int l = tid;
      float row[W];
#pragma unroll
      for (int j = 0; j < W; ++j)
        row[j] = (l < w && j < w) ? P[j * ldp + l] : (j == l ? 1.f : 0.f);
      int f = 0;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const float d2 = __shfl_sync(0xffffffffu, row[k], k);
        if (!(d2 > 0.f)) {           // NaN-safe; the same for every lane
          f = c0 + k + 1;
          break;
        }
        const float d = sqrtf(d2), rd = __frcp_rn(d);
        if (l == k) {
          row[k] = d;
          dinv[k] = rd;
        } else if (l > k) {
          row[k] *= rd;
        }
        const float lk = row[k];
#pragma unroll
        for (int j = k + 1; j < W; ++j) {
          const float ljk = __shfl_sync(0xffffffffu, row[k], j);
          if (l >= j) row[j] = fmaf(-lk, ljk, row[j]);
        }
      }
      if (l < w) {
#pragma unroll
        for (int j = 0; j < W; ++j)
          if (j <= l) P[j * ldp + l] = row[j];
      }
      if (l == 0 && f) s_fail = f;
    }
    __syncthreads();

    if (s_fail) {
      // the tile as far as it got; nothing below it, nothing after it
      if (blk == 0) {
        store_panel(A, lda, c0, w, w, P, ldp, 0, 1);
        if (tid == 0) *info = s_fail;
      }
    } else {
      solve_and_update(A, lda, c0, rows, P, ldp, dinv, blk, nblk);
    }
    if constexpr (MULTI) {
      cg::this_grid().sync();
    } else {
      __syncthreads();
    }
    // every block finds the same pivot, but many blocks end the loop on
    // block 0's verdict, read by all after the same sync: no block can
    // leave while another waits at a later one
    if ((MULTI ? __ldcg(info) : s_fail) != 0) {
      failed = true;
      break;
    }
  }
  // the last panel, solved and staged, once nothing failed
  const int wl = (n - 1) % W + 1;
  if (!failed) store_panel(A, lda, n - wl, wl, wl, P, ldp, blk, nblk);
}

// The device's limit on co-resident blocks of the many-block launch, found
// once per device: 0 until then, -1 where the device has no cooperative
// launch. Both kernels' dynamic shared memory limit is set to the largest
// panel's (n = MAX_N) at the same time, so the limit, queried at that
// size, holds at every n.
constexpr int MAX_DEVICES = 64;
constexpr int SMEM_MAX = static_cast<int>(sizeof(float)) * W * (MAX_N | 1);
int multi_cap[MAX_DEVICES];

cudaError_t init_device(int device) {
  int coop = 0, nsm = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(potrf_block_f32_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(potrf_block_f32_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, potrf_block_f32_kernel<true>, NT, SMEM_MAX);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  multi_cap[device] = coop ? nsm * per_sm : -1;
  return cudaSuccess;
}

}  // namespace

// multi = 0: one thread block; 1: one cooperative launch over as many
// blocks as the first panel has update tiles for their teams.
CT_EXPORT int ct_potrf_block_f32(float* A, long long lda, int n, int* info,
                                 int multi, int device, void* stream) {
  if (n < 1 || n > MAX_N || lda < n || device < 0 || device >= MAX_DEVICES)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(float)) * W * (n | 1);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!multi_cap[device]) {
    err = init_device(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!multi) {
    potrf_block_f32_kernel<false><<<1, NT, smem, st>>>(A, lda, n, info);
    return static_cast<int>(cudaGetLastError());
  }
  if (multi_cap[device] < 0) return static_cast<int>(cudaErrorNotSupported);
  const int nt = (n - W + TT - 1) / TT;       // tile rows of the first A22
  const int want = (nt * (nt + 1) / 2 + TEAMS - 1) / TEAMS;
  const int nblk = max(1, min(want, multi_cap[device]));
  void* args[] = {&A, &lda, &n, &info};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(potrf_block_f32_kernel<true>), dim3(nblk),
      dim3(NT), args, smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
