// potrf_stream_f32: lower Cholesky of an n x n matrix, n % 128 == 0,
// 128 <= n <= 8192, in place, in one cooperative launch over every SM.
//
// Replaces cholesky_tpu/ops/pallas/mega.py:potrf_hbm_f32
// (_potrf_hbm_kernel), the TPU's whole-matrix potrf for 1024 < n <= 8192.
// On the GP model's train step it is every potrf of the n = 8192 kernel
// matrix; on the potrf path it is the whole factorization at 4096 and 8192.
//
// Contract (that of potrf_block.cu without its 1024 cap): only the lower
// triangle is read; the strict upper is written zero. info is the 1-based
// index of the first pivot with !(d > 0), NaN-safe. The factorization
// freezes at a failed pivot: the 128-wide diagonal tile holding it is
// stored as far as it got, and nothing after it is solved or updated, so
// every stored value stays finite except an input NaN at its own position.
//
// What bounds it on the H100: n^3/3 FFMA (92 G at n = 8192) and the chain
// of n/128 diagonal tiles, each factored after the previous panel's
// update. The TPU kernel walked 128-row panels left-looking through one
// core's VMEM; potrf_block.cu does the same walk on ONE SM, which made it
// the first bottleneck of the port (a sixth of one SM's FFMA rate). Here
// the update work is spread over every SM and only the diagonal tiles stay
// on one thread block.
//
// Design: right-looking over 128-wide panels, two grid-wide phases each:
//   S(j)   the panel below the diagonal tile, solved by a product with the
//          tile's inverse (P = A_panel · W_jᵀ) into the scratch P and the
//          panel, one 64-row tile per thread block;
//   U(j)   every lower 64 x 64 tile of the trailing matrix updated,
//          A22 -= P·Pᵀ (k = 128). With a look-ahead, block 0 updates the
//          next diagonal tile first and factors and inverts it (F(j + 1))
//          while the other blocks take the rest of U(j) from an atomic
//          counter; blocks on block 0's SM stay out of U, so F keeps its
//          SM to itself.
// F factors the 128 x 128 tile in shared memory and inverts it
// (chol_tile.cuh), and writes the inverse for S. F takes
// about 70 us per tile on the H100; at n = 4096 the kernel without F
// after the first tile still takes 3.1 of its 4.8 ms, so the update's
// SGEMM tile (sgemm_tile.cuh) is what bounds it. Every read of data
// other blocks wrote in this launch bypasses L1 (__ldcg). 1 + 2·(n/128 - 1) grid syncs; a failed pivot is
// published in info before a sync and every block leaves the panel loop
// on it.
#include <cooperative_groups.h>

#include "chol_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NB = ct::tile::NB;   // panel width and diagonal tile
constexpr int BT = 64;         // GEMM tile edge
constexpr int BK = 16;         // k-step of the GEMM tiles
constexpr int NT = (BT / ct::TM) * (BT / ct::TN);   // 256 threads
static_assert(NT == ct::tile::NT, "factor_tile runs on the whole block");
constexpr int MAX_N = 8192;
constexpr int SMEM = ct::tile::SMEM;

using ct::tile::factor_tile;

// A[r0 + r, c0 + c] -= acc over the thread's micro-tile, lower triangle
// only (c <= r); A is read through L2.
__device__ __forceinline__ void sub_lower(float* A, long long lda, int r0,
                                          int c0,
                                          const float (&acc)[ct::TM][ct::TN]) {
  const int tx = threadIdx.x % (BT / ct::TN);
  const int ty = threadIdx.x / (BT / ct::TN);
#pragma unroll
  for (int i = 0; i < ct::TM; ++i) {
    const int r = r0 + ty + i * (BT / ct::TM);
#pragma unroll
    for (int j = 0; j < ct::TN; ++j) {
      const int c = c0 + tx + j * (BT / ct::TN);
      if (c <= r) {
        float* p = A + (long long)r * lda + c;
        *p = __ldcg(p) - acc[i][j];
      }
    }
  }
}

// The trailing update of one lower 64 x 64 tile (ti, tj) of A22 =
// A[b:, b:] from the solved panel rows P[b:, :].
__device__ __forceinline__ void update_tile(float* A, long long lda,
                                            const float* P, int b, int m,
                                            int ti, int tj,
                                            float (*Xs)[BT + 1],
                                            float (*Ys)[BT + 1]) {
  float acc[ct::TM][ct::TN] = {};
  const float* Pb = P + (long long)b * NB;
  ct::tile_xyt<BT, BT, BK, true>(Pb, NB, 1, ti * BT, m, Pb, NB, 1, tj * BT,
                                 m, NB, Xs, Ys, acc);
  sub_lower(A + (long long)b * lda + b, lda, ti * BT, tj * BT, acc);
}

__device__ __forceinline__ int sm_id() {
  int id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  return id;
}

__global__ void __launch_bounds__(NT, 2)
potrf_stream_f32_kernel(float* A, long long lda, float* P, float* Winv, int n,
                        int* info) {
  extern __shared__ float T[];     // the diagonal tile, or the GEMM slabs
  __shared__ float dinv[NB];
  __shared__ int s_fail, s_tile;
  auto Xs = reinterpret_cast<float (*)[BT + 1]>(T);
  auto Ys = reinterpret_cast<float (*)[BT + 1]>(T + BK * (BT + 1));
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int nd = n / NB;
  // P's first NB rows are never a panel row: ctl[0] is block 0's SM,
  // ctl[1 + j] the next trailing tile of U(j)
  int* const ctl = reinterpret_cast<int*>(P);

  // ---- phase 0: the strict upper zeroed, the counters, F(0)
  if (blockIdx.x == 0) {
    if (tid == 0) ctl[0] = sm_id();
    factor_tile(A, lda, 0, NB, true, Winv, info, T, dinv, &s_fail);
  }
  if (blockIdx.x == gridDim.x - 1)
    for (int j = tid; j < nd; j += NT) ctl[1 + j] = 0;
  for (int r = blockIdx.x; r < n; r += gridDim.x)
    for (int c = r + 1 + tid; c < n; c += NT) A[(long long)r * lda + c] = 0.f;
  grid.sync();
  // the trailing updates run on every block but block 0, which factors
  // the diagonal tiles, and those beside it on its SM, which would take
  // issue slots from it
  const bool updates = gridDim.x <= 4 ||
                       (blockIdx.x != 0 && sm_id() != __ldcg(ctl));

  for (int j = 0; j + 1 < nd; ++j) {
    if (__ldcg(info) != 0) break;   // F(j) failed: freeze
    const int c0 = j * NB, b = c0 + NB, m = n - b;
    const int mt = m / BT;

    // ---- S(j): P[b:, :] = A[b:, c0:c0+NB] · Winvᵀ by 64-row tiles;
    // Winv is lower, so column tile lc needs k < (lc + 1)·BT only. The
    // block that solved the rows copies them into the panel.
    for (int lr = blockIdx.x; lr < mt; lr += gridDim.x) {
      for (int lc = 0; lc < 2; ++lc) {
        float acc[ct::TM][ct::TN] = {};
        ct::tile_xyt<BT, BT, BK, true>(A + (long long)b * lda + c0, lda, 1,
                                       lr * BT, m, Winv, NB, 1, lc * BT, NB,
                                       (lc + 1) * BT, Xs, Ys, acc);
        ct::store_tile<BT, BT>(P + (long long)b * NB, NB, lr * BT, lc * BT,
                               1.f, acc);
      }
      __syncthreads();
      for (int idx = tid; idx < BT * NB; idx += NT) {
        const long long r = b + lr * BT + idx / NB;
        const int c = idx % NB;
        A[r * lda + c0 + c] = __ldcg(P + r * NB + c);
      }
    }
    grid.sync();

    // ---- U(j): A22 -= P·Pᵀ on the lower tiles. Block 0 takes the next
    // diagonal tile (the first three tiles) and F(j + 1); the updating
    // blocks take the other tiles from a counter.
    if (blockIdx.x == 0) {
      update_tile(A, lda, P, b, m, 0, 0, Xs, Ys);
      update_tile(A, lda, P, b, m, 1, 0, Xs, Ys);
      update_tile(A, lda, P, b, m, 1, 1, Xs, Ys);
      factor_tile(A, lda, b, NB, true, Winv, info, T, dinv, &s_fail);
    }
    if (updates) {
      const int ntri = mt * (mt + 1) / 2;
      for (;;) {
        if (tid == 0) s_tile = 3 + atomicAdd(ctl + 1 + j, 1);
        __syncthreads();
        const int t = s_tile;
        __syncthreads();
        if (t >= ntri) break;
        int ti, tj;
        ct::tri_tile(t, ti, tj);
        update_tile(A, lda, P, b, m, ti, tj, Xs, Ys);
      }
    }
    grid.sync();
  }
}

}  // namespace

CT_EXPORT int ct_potrf_stream_f32(float* A, long long lda, float* P,
                                  float* Winv, int n, int* info, int device,
                                  void* stream) {
  if (n < NB || n > MAX_N || n % NB != 0 || lda < n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int coop = 0, nsm = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(potrf_stream_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, potrf_stream_f32_kernel, NT, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  void* args[] = {&A, &lda, &P, &Winv, &n, &info};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(potrf_stream_f32_kernel), dim3(nsm * per_sm),
      dim3(NT), args, SMEM, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
