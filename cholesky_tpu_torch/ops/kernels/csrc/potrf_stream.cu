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
// F factors the 128 x 128 tile in shared memory in 32-wide steps (warp 0
// the 32 x 32 block in registers and shuffles, one thread per row below
// it, the rest of the tile by a 16 x 16 thread grid with register
// blocking), then inverts it in 32-row blocks (one product against the rows already inverted, then a forward
// substitution down the block, one thread per column), so that no thread
// runs a chain longer than 32, and writes the inverse for S. F takes
// about 70 us per tile on the H100; at n = 4096 the kernel without F
// after the first tile still takes 3.1 of its 4.8 ms, so the update's
// SGEMM tile (sgemm_tile.cuh) is what bounds it. Every read of data
// other blocks wrote in this launch bypasses L1 (__ldcg). 1 + 2·(n/128 - 1) grid syncs; a failed pivot is
// published in info before a sync and every block leaves the panel loop
// on it.
#include <cooperative_groups.h>

#include "sgemm_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NB = 128;        // panel width and diagonal tile
constexpr int LDT = NB + 1;    // shared row stride of the tile
constexpr int DB = 32;         // step of the tile's own factor and inverse
constexpr int BT = 64;         // GEMM tile edge
constexpr int BK = 16;         // k-step of the GEMM tiles
constexpr int NT = (BT / ct::TM) * (BT / ct::TN);   // 256 threads
constexpr int MAX_N = 8192;
constexpr int SMEM = NB * LDT * static_cast<int>(sizeof(float));

// F: factor the diagonal tile A[c0:c0+NB, c0:c0+NB] (lower part only),
// store the factor back (lower part only) and, unless a pivot failed, its
// inverse into Winv (NB x NB, row-major, zero strict upper). Writes info:
// the absolute 1-based failed pivot, or 0. One thread block, blocked by
// DB-wide steps so that no thread runs a chain longer than one DB block.
__device__ void factor_tile(float* A, long long lda, int c0, float* Winv,
                            int* info, float* T, float* dinv, int* s_fail) {
  const int tid = threadIdx.x;
  float* const At = A + (long long)c0 * lda + c0;
  __syncthreads();                 // this block's own updates of the tile
#pragma unroll 8
  for (int idx = tid; idx < NB * NB; idx += NT) {
    const int i = idx / NB, k = idx % NB;
    T[i * LDT + k] = (k <= i) ? __ldcg(At + (long long)i * lda + k) : 0.f;
  }
  __syncthreads();

  // ---- the factor, right-looking over DB-wide steps
  int fail = 0;
  const int tr = tid / 16, tc = tid % 16;
  for (int c = 0; c < NB; c += DB) {
    // (a) warp 0 factors the DB x DB diagonal block, lane l holding row
    // c + l in registers; column k reaches the other lanes by shuffles
    if (tid < 32) {
      const int l = tid;
      float row[DB];
#pragma unroll
      for (int j = 0; j < DB; ++j) row[j] = T[(c + l) * LDT + c + j];
      int f = 0;
#pragma unroll
      for (int k = 0; k < DB; ++k) {
        const float d2 = __shfl_sync(0xffffffffu, row[k], k);
        if (!(d2 > 0.f)) {         // NaN-safe; the same for every lane
          f = c0 + c + k + 1;
          break;
        }
        const float d = sqrtf(d2), rd = __frcp_rn(d);
        if (l == k) {
          row[k] = d;
          dinv[c + k] = rd;        // W's diagonal, and the solves' scale
        } else if (l > k) {
          row[k] *= rd;
        }
        const float lk = row[k];
#pragma unroll
        for (int j = k + 1; j < DB; ++j) {
          const float ljk = __shfl_sync(0xffffffffu, row[k], j);
          if (l >= j) row[j] = fmaf(-lk, ljk, row[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < DB; ++j)
        if (j <= l) T[(c + l) * LDT + c + j] = row[j];
      if (l == 0) *s_fail = f;
    }
    __syncthreads();
    fail = *s_fail;
    if (fail) break;               // the same for every thread
    // (b) each row below the block solves x·Dᵀ = a, x in registers
    for (int r = c + DB + tid; r < NB; r += NT) {
      float* const xr = T + r * LDT + c;
      float x[DB];
#pragma unroll
      for (int k = 0; k < DB; ++k) {
        float s = xr[k];
#pragma unroll
        for (int m = 0; m < k; ++m)
          s = fmaf(-x[m], T[(c + k) * LDT + c + m], s);
        x[k] = s * dinv[c + k];
      }
#pragma unroll
      for (int k = 0; k < DB; ++k) xr[k] = x[k];
    }
    __syncthreads();
    // (c) the rest of the tile's lower triangle -= X·Xᵀ (k = DB); thread
    // (tr, tc) owns rows m0 + tr + 16a and columns m0 + tc + 16b
    const int m0 = c + DB;
    if (m0 < NB) {
      constexpr int G = (NB - DB) / 16;
      float acc[G][G] = {};
#pragma unroll 4
      for (int m = 0; m < DB; ++m) {
        float ra[G], cb[G];
#pragma unroll
        for (int a = 0; a < G; ++a) {
          const int i = m0 + tr + 16 * a;
          ra[a] = (i < NB) ? T[i * LDT + c + m] : 0.f;
        }
#pragma unroll
        for (int b = 0; b < G; ++b) {
          const int j = m0 + tc + 16 * b;
          cb[b] = (j < NB) ? T[j * LDT + c + m] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < G; ++a)
#pragma unroll
          for (int b = 0; b < G; ++b)
            acc[a][b] = fmaf(ra[a], cb[b], acc[a][b]);
      }
#pragma unroll
      for (int a = 0; a < G; ++a)
#pragma unroll
        for (int b = 0; b < G; ++b) {
          const int i = m0 + tr + 16 * a, j = m0 + tc + 16 * b;
          if (i < NB && j <= i) T[i * LDT + j] -= acc[a][b];
        }
    }
    __syncthreads();
  }

  if (!fail) {
    // ---- W = T⁻¹ by DB-row blocks I: W[I, :] = D_I⁻¹·(E_I − T[I, <I]·W).
    // W[i][j] (i > j) is kept at T[j][i], the unused strict upper of the
    // tile; W[j][j] = 1 / T[j][j] is dinv[j], written by (a).
    for (int r0 = 0; r0 < NB; r0 += DB) {
      // (i) R[i][j] = −Σ_{j <= k < r0} T[i][k]·W[k][j], i in the block,
      // j < r0, into T[j][i]
      for (int idx = tid; idx < DB * r0; idx += NT) {
        const int i = r0 + idx % DB, j = idx / DB;
        const float* const ti = T + i * LDT;
        const float* const wj = T + j * LDT;   // W[k][j] at T[j][k], k > j
        float s[4] = {-ti[j] * dinv[j], 0.f, 0.f, 0.f};
        int k = j + 1;
        for (; k + 3 < r0; k += 4) {
#pragma unroll
          for (int u = 0; u < 4; ++u) s[u] = fmaf(-ti[k + u], wj[k + u], s[u]);
        }
        for (; k < r0; ++k) s[0] = fmaf(-ti[k], wj[k], s[0]);
        T[j * LDT + i] = (s[0] + s[1]) + (s[2] + s[3]);
      }
      __syncthreads();
      // (ii) forward substitution down the block, thread j for column j,
      // the column in registers (zero above row j)
      const int j = tid;
      if (j < r0 + DB) {
        float x[DB];
#pragma unroll
        for (int q = 0; q < DB; ++q) {
          const int i = r0 + q;
          float s = (j < r0) ? T[j * LDT + i] : (i == j ? 1.f : 0.f);
#pragma unroll
          for (int m = 0; m < q; ++m)
            s = fmaf(-T[i * LDT + r0 + m], x[m], s);
          x[q] = s * dinv[i];
        }
#pragma unroll
        for (int q = 0; q < DB; ++q)
          if (r0 + q > j) T[j * LDT + r0 + q] = x[q];
      }
      __syncthreads();
    }
    for (int idx = 4 * tid; idx < NB * NB; idx += 4 * NT) {
      const int i = idx / NB;
      float w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = idx % NB + u;
        w[u] = (c < i) ? T[c * LDT + i] : (c == i ? dinv[c] : 0.f);
      }
      *reinterpret_cast<float4*>(Winv + idx) = make_float4(w[0], w[1], w[2],
                                                           w[3]);
    }
  }
  for (int idx = tid; idx < NB * NB; idx += NT) {
    const int i = idx / NB, k = idx % NB;
    if (k <= i) At[(long long)i * lda + k] = T[i * LDT + k];
  }
  if (tid == 0) *info = fail;
  __syncthreads();                 // T is reused as the GEMM slabs
}

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
    factor_tile(A, lda, 0, Winv, info, T, dinv, &s_fail);
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
      factor_tile(A, lda, b, Winv, info, T, dinv, &s_fail);
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
