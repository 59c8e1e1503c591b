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
// core's VMEM; potrf_block.cu does the same walk on ONE SM. Here the
// update work is spread over every SM and only the diagonal tiles stay
// on one thread block.
//
// Design: right-looking over 128-wide panels, two grid-wide phases each:
//   S(j)   the panel below the diagonal tile, solved by a product with the
//          tile's inverse (P = A_panel · W_jᵀ) into the scratch P and,
//          transposed, into PT, one 64 x 64 tile (row tile, column tile)
//          per thread block, each k-step 64 deep so that a tile waits out
//          two rounds of global latency at most;
//   U(j)   every lower tile of the trailing matrix updated, A22 -= P·Pᵀ
//          (k = 128), taken from an atomic counter: first the next
//          diagonal tile's three 64-tiles, each counted when stored, then
//          the 128 x 128 cp.async tile of sgemm128.cuh (on PT, both
//          operands row-fast) while the lower 128-tiles outnumber the
//          grid, 64-tiles after. Block 0 waits for the diagonal tile's
//          count and factors and inverts it (F(j + 1)) while the others
//          update; blocks on block 0's SM stay out of U, so F keeps its SM
//          to itself. The solved panel goes into A at the end of U(j).
// F is on the critical path wherever U(j) is short: the trace
// (chip_smoke.py phase 3) put it past U from panel 33 of 63 at n = 8192
// and in every panel at 4096, at 120-140 µs a panel before this design
// (the diagonal update on synchronous 16-deep k-steps on block 0 alone
// 39-47, the factor 55-66, the inverse 24-27). The diagonal update now
// runs on three blocks at once with its loads in flight, and the factor's
// trailing updates cover only the rows below each step (chol_tile.cuh);
// F is 58-81 µs a tile (n = 1024-8192). Every read of data other blocks
// wrote in this launch bypasses L1 (__ldcg, cp.async.cg).
// 1 + 2·(n/128 - 1) grid syncs; a failed pivot is published in info
// before a sync and every block leaves the panel loop on it.
//
// Registers: 128 a thread for two blocks an SM (the cooperative grid).
// The product routines run out of line, each in its own 128; the kernel
// saves its loop state around their calls, and F's pivot chain, with a
// pivot's shuffles in flight together, spills a few values too (the
// ptxas log of chip_smoke.py's build step).
//
// Trace: given a buffer of TRACE_SLOTS x (n/128) zeroed 64-bit words,
// the launch records %globaltimer (ns) at each phase boundary: row 0 for
// phase 0 (F(0)), row 1 + j for panel j. Block 0 writes its own stamps;
// the other blocks' ends of S and of U are the latest over them
// (atomicMax). A null buffer records nothing.
#include <cooperative_groups.h>

#include "chol_tile.cuh"
#include "sgemm128.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NB = ct::tile::NB;   // panel width and diagonal tile
constexpr int BT = 64;         // the small tiles' edge
constexpr int SBK = 64;        // their k-step
constexpr int NT = (BT / ct::TM) * (BT / ct::TN);   // 256 threads
static_assert(NT == ct::tile::NT, "factor_tile runs on the whole block");
static_assert(NT == ct::t128::NT && NB == ct::t128::BM,
              "one block, one tile");
constexpr int MAX_N = 8192;
constexpr int RING = ct::t128::smem_floats<false, false>() * sizeof(float);
constexpr int SLABS = 2 * SBK * (BT + 1) * sizeof(float);
static_assert(RING <= ct::tile::SMEM && SLABS <= ct::tile::SMEM &&
                  NB * NB * static_cast<int>(sizeof(float)) <= ct::tile::SMEM,
              "the tiles share the diagonal tile's shared memory");
constexpr int SMEM = ct::tile::SMEM;

// the stamps of one trace row
enum Stamp {
  S_START = 0,    // block 0 enters S(j) (row 0: the launch starts)
  S_LAST = 1,     // the last block arrives at the sync after S(j)
                  // (row 0: the grid size)
  SYNC1_EXIT = 2, // block 0 leaves that sync
  DIAG_END = 3,   // block 0 has updated the next diagonal tile
  FACTOR_END = 4, // block 0 has factored it
  F_END = 5,      // block 0 has inverted it: F(j + 1) is done
  U_LAST = 6,     // the last updating block finds no tile left (row 0:
                  // the last block arrives at the first sync)
  SYNC2_EXIT = 7, // block 0 leaves the sync after U(j)
  TRACE_SLOTS = 8
};

__device__ __forceinline__ void stamp_max(unsigned long long* slot) {
  __syncthreads();                 // every thread of the block is done
  if (threadIdx.x == 0) atomicMax(slot, ct::globaltimer());
}

using ct::tile::factor_tile;

// The block's dynamic shared memory: the diagonal tile of F, or the
// stages of the product tiles. Named here, not passed, so that the
// product routines below, kept out of line to bound each one's registers,
// still address it as shared memory.
extern __shared__ __align__(16) float smem[];

// acc += X[r0:r0+64, :K]·Y[c0:c0+64, :K]ᵀ for row-major X and Y (row
// strides ldx, ldy; K a multiple of 64), read through L2. Each 64-deep
// k-step stages both 64 x 64 slabs with all sixteen loads a thread in
// flight, then one barrier, the product, one barrier: two rounds of
// global latency at most for the k = 128 of the panel products, where a
// 16-deep step waits out eight.
__device__ __forceinline__ void slab_product(const float* X, long long ldx,
                                             int r0, const float* Y,
                                             long long ldy, int c0, int K,
                                             float (&acc)[ct::TM][ct::TN]) {
  auto Sx = reinterpret_cast<float (*)[BT + 1]>(smem);
  auto Sy = reinterpret_cast<float (*)[BT + 1]>(smem + SBK * (BT + 1));
  constexpr int U = BT * SBK / NT;   // 16
  for (int k0 = 0; k0 < K; k0 += SBK) {
    float v[U], w[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = threadIdx.x + u * NT, r = idx / SBK, k = idx % SBK;
      v[u] = __ldcg(X + (r0 + r) * ldx + k0 + k);
      w[u] = __ldcg(Y + (c0 + r) * ldy + k0 + k);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = threadIdx.x + u * NT, r = idx / SBK, k = idx % SBK;
      Sx[k][r] = v[u];
      Sy[k][r] = w[u];
    }
    __syncthreads();
    ct::mma_staged<BT, BT, SBK>(Sx, Sy, acc);
    __syncthreads();
  }
}

// S's tile: P[r0:r0+64, c:c+64] = X[r0:r0+64, :c+64]·Winv[c:c+64, :c+64]ᵀ
// (Winv is lower), X the panel rows below the diagonal tile; the same
// values transposed into PT[c:c+64, r0:r0+64] through shared memory, so
// that both stores are along rows.
__device__ __noinline__ void panel_tile(const float* X, long long lda,
                                        int r0, const float* Winv, int c,
                                        float* Pb, float* PTb, int n) {
  float acc[ct::TM][ct::TN] = {};
  slab_product(X, lda, r0, Winv, NB, c, c + BT, acc);
  const int tx = threadIdx.x % (BT / ct::TN);
  const int ty = threadIdx.x / (BT / ct::TN);
  auto St = reinterpret_cast<float (*)[BT + 1]>(smem);   // [col][row]
#pragma unroll
  for (int i = 0; i < ct::TM; ++i)
#pragma unroll
    for (int q = 0; q < ct::TN; ++q) {
      const int r = ty + i * (BT / ct::TM), cc = tx + q * (BT / ct::TN);
      Pb[(long long)(r0 + r) * NB + c + cc] = acc[i][q];
      St[cc][r] = acc[i][q];
    }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BT * BT; idx += NT) {
    const int cc = idx / BT, r = idx % BT;
    PTb[(long long)(c + cc) * n + r0 + r] = St[cc][r];
  }
  __syncthreads();                 // smem is the next tile's staging
}

// The trailing update of one lower 64 x 64 tile (ti, tj) of A22 =
// A[b:, b:] from the solved panel rows P[b:, :], lower triangle only; the
// old values are read through L2.
__device__ __noinline__ void update_tile(float* A, long long lda,
                                         const float* P, int b, int ti,
                                         int tj) {
  float acc[ct::TM][ct::TN] = {};
  const float* Pb = P + (long long)b * NB;
  slab_product(Pb, NB, ti * BT, Pb, NB, tj * BT, NB, acc);
  float* const At = A + (long long)(b + ti * BT) * lda + b + tj * BT;
  const int tx = threadIdx.x % (BT / ct::TN);
  const int ty = threadIdx.x / (BT / ct::TN);
  float old[ct::TM][ct::TN];
#pragma unroll
  for (int i = 0; i < ct::TM; ++i)
#pragma unroll
    for (int j = 0; j < ct::TN; ++j) {
      const int r = ty + i * (BT / ct::TM), c = tx + j * (BT / ct::TN);
      old[i][j] = (ti != tj || c <= r) ? __ldcg(At + (long long)r * lda + c)
                                       : 0.f;
    }
#pragma unroll
  for (int i = 0; i < ct::TM; ++i)
#pragma unroll
    for (int j = 0; j < ct::TN; ++j) {
      const int r = ty + i * (BT / ct::TM), c = tx + j * (BT / ct::TN);
      if (ti != tj || c <= r)
        At[(long long)r * lda + c] = old[i][j] - acc[i][j];
    }
}

// A 128-tile's accumulators go through shared memory, element (r, c) at
// smem[r·NB + swz(r, c)]: a warp's 32 stores of one micro-tile element
// (lane rows 4l apart, lane columns 4 apart) fall in 32 distinct banks,
// and 32 consecutive columns of one row still do.
__device__ __forceinline__ int swz(int r, int c) {
  const int l = (r >> 2) & 7;
  return c ^ (((l & 4) << 2) | (l & 3));
}

// The trailing update of one lower 128 x 128 tile (ti, tj) of A22: the
// product P_i·P_jᵀ, from the transposed panel rows PT (NB x n) so that
// both operands are row-fast, staged through shared memory, then A22 -= it
// a row at a time (lower triangle only on a diagonal tile), the old
// values read through L2 sixteen a thread before their stores.
__device__ __noinline__ void update_tile128(float* A, long long lda,
                                            const float* PT, int n, int b,
                                            int m, int ti, int tj) {
  {
    float acc[8][8] = {};
    const float* Pb = PT + b;      // row-fast: element (r, k) at k·n + r
    ct::t128::tile_xyt<false, false, true>(Pb, 1, n, ti * NB, m, Pb, 1, n,
                                           tj * NB, m, NB, smem, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ct::t128::row_of(i);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        smem[r * NB + swz(r, ct::t128::col_of(j))] = acc[i][j];
    }
  }
  __syncthreads();
  float* const At = A + (long long)(b + ti * NB) * lda + b + tj * NB;
  const bool diag = ti == tj;
  constexpr int U = 16;
#pragma unroll 1
  for (int q0 = 0; q0 < NB * NB / NT; q0 += U) {
    float old[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = threadIdx.x + (q0 + u) * NT, r = idx / NB, c = idx % NB;
      old[u] = (!diag || c <= r) ? __ldcg(At + (long long)r * lda + c) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = threadIdx.x + (q0 + u) * NT, r = idx / NB, c = idx % NB;
      if (!diag || c <= r)
        At[(long long)r * lda + c] = old[u] - smem[r * NB + swz(r, c)];
    }
  }
  __syncthreads();                 // smem is the next tile's ring
}

__device__ __forceinline__ int sm_id() {
  int id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  return id;
}

__global__ void __launch_bounds__(NT, 2)
potrf_stream_f32_kernel(float* A, long long lda, float* P, float* Winv,
                        float* PT, int n, int* info,
                        unsigned long long* trace) {
  __shared__ float dinv[NB];
  __shared__ int s_fail, s_tile;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int nd = n / NB;
  // P's first NB rows are never a panel row: ctl[0] is block 0's SM,
  // ctl[1 + j] the next trailing tile of U(j), ctl[1 + nd + j] the count
  // of the next diagonal tile's three 64-tiles U(j) has stored
  int* const ctl = reinterpret_cast<int*>(P);
  // with more than four blocks the first three tiles of each U(j), the
  // next diagonal tile's, go to three updating blocks while block 0 waits
  // for them; with fewer block 0 updates them itself
  const bool helpers = gridDim.x > 4;

  // block 0's stamp of row r
  const bool stamps = trace && blockIdx.x == 0 && tid == 0;
  auto mark = [&](int r, int s) {
    if (stamps) trace[r * TRACE_SLOTS + s] = ct::globaltimer();
  };

  // ---- phase 0: the strict upper zeroed, the counters, F(0)
  if (blockIdx.x == 0) {
    if (tid == 0) ctl[0] = sm_id();
    mark(0, S_START);
    mark(0, DIAG_END);
    if (stamps) trace[S_LAST] = gridDim.x;
    factor_tile(A, lda, 0, NB, true, Winv, info, smem, dinv, &s_fail,
                trace ? trace + FACTOR_END : nullptr);
    mark(0, F_END);
  }
  if (blockIdx.x == gridDim.x - 1)
    for (int j = tid; j < 2 * nd; j += NT) ctl[1 + j] = 0;
  for (int r = blockIdx.x; r < n; r += gridDim.x)
    for (int c = r + 1 + tid; c < n; c += NT) A[(long long)r * lda + c] = 0.f;
  if (trace) stamp_max(trace + U_LAST);
  grid.sync();
  mark(0, SYNC2_EXIT);
  // the trailing updates run on every block but block 0, which factors
  // the diagonal tiles, and those beside it on its SM, which would take
  // issue slots from it
  const bool updates = gridDim.x <= 4 ||
                       (blockIdx.x != 0 && sm_id() != __ldcg(ctl));

  for (int j = 0; j + 1 < nd; ++j) {
    if (__ldcg(info) != 0) break;   // F(j) failed: freeze
    const int c0 = j * NB, b = c0 + NB, m = n - b;
    const int mt = m / BT, mt2 = m / NB;
    const int row = 1 + j;
    mark(row, S_START);

    // ---- S(j): P[b:, :] = A[b:, c0:c0+NB] · Winvᵀ by 64 x 64 tiles (lr,
    // lc); Winv is lower, so column tile lc needs k < (lc + 1)·BT only.
    // The panel itself is written in U(j): tile (lr, 1) reads the columns
    // tile (lr, 0) solves.
    for (int it = blockIdx.x; it < 2 * mt; it += gridDim.x) {
      const int lr = it >> 1, lc = it & 1;
      panel_tile(A + (long long)b * lda + c0, lda, lr * BT, Winv, lc * BT,
                 P + (long long)b * NB, PT + b, n);
    }
    if (trace) stamp_max(trace + row * TRACE_SLOTS + S_LAST);
    grid.sync();
    mark(row, SYNC1_EXIT);

    // ---- U(j): A22 -= P·Pᵀ on the lower tiles, taken from a counter:
    // first the next diagonal tile's three 64-tiles, each published when
    // stored, then 128-tiles while they outnumber the grid, else 64-tiles.
    // Block 0 waits for the diagonal tile and factors and inverts it
    // (F(j + 1)) while the other blocks update.
    const bool wide = mt2 * (mt2 + 1) / 2 >= static_cast<int>(gridDim.x);
    if (blockIdx.x == 0) {
      if (helpers) {
        if (tid == 0) {
          while (atomicAdd(ctl + 1 + nd + j, 0) < 3) __nanosleep(100);
          __threadfence();
        }
        __syncthreads();
      } else {
        update_tile(A, lda, P, b, 0, 0);
        update_tile(A, lda, P, b, 1, 0);
        update_tile(A, lda, P, b, 1, 1);
      }
      mark(row, DIAG_END);
      factor_tile(A, lda, b, NB, true, Winv, info, smem, dinv, &s_fail,
                  trace ? trace + row * TRACE_SLOTS + FACTOR_END : nullptr);
      mark(row, F_END);
    }
    if (updates) {
      // counter values: 0-2 the diagonal tile's 64-tiles, then the rest
      const int ntri = wide ? 2 + mt2 * (mt2 + 1) / 2 : mt * (mt + 1) / 2;
      const int first = helpers ? 0 : 3;
      for (;;) {
        if (tid == 0) s_tile = first + atomicAdd(ctl + 1 + j, 1);
        __syncthreads();
        const int t = s_tile;
        __syncthreads();
        if (t >= ntri) break;
        int ti, tj;
        if (t < 3) {
          ct::tri_tile(t, ti, tj);
          update_tile(A, lda, P, b, ti, tj);
          __threadfence();         // the tile's stores, then the count
          __syncthreads();
          if (tid == 0) atomicAdd(ctl + 1 + nd + j, 1);
        } else if (wide) {
          ct::tri_tile(t - 2, ti, tj);
          update_tile128(A, lda, PT, n, b, m, ti, tj);
        } else {
          ct::tri_tile(t, ti, tj);
          update_tile(A, lda, P, b, ti, tj);
        }
      }
      if (trace) stamp_max(trace + row * TRACE_SLOTS + U_LAST);
    }
    if (blockIdx.x != 0 || gridDim.x == 1) {
      // the solved rows into the panel, 8 a thread in flight, after the
      // tiles (the diagonal ones first): nothing reads the panel again
      const long long total = static_cast<long long>(m) * NB;
      const int cb = gridDim.x > 1 ? blockIdx.x - 1 : 0;
      const long long step = static_cast<long long>(max(1, gridDim.x - 1)) *
                             NT * 8;
      for (long long base = static_cast<long long>(cb) * NT * 8 + tid;
           base < total; base += step) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const long long idx = base + u * NT;
          v[u] = idx < total ? __ldcg(P + (long long)b * NB + idx) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const long long idx = base + u * NT;
          if (idx < total) A[(b + idx / NB) * lda + c0 + idx % NB] = v[u];
        }
      }
    }
    grid.sync();
    mark(row, SYNC2_EXIT);
  }
}

}  // namespace

CT_EXPORT int ct_potrf_stream_f32(float* A, long long lda, float* P,
                                  float* Winv, float* PT, int n, int* info,
                                  unsigned long long* trace, int device,
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
  void* args[] = {&A, &lda, &P, &Winv, &PT, &n, &info, &trace};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(potrf_stream_f32_kernel), dim3(nsm * per_sm),
      dim3(NT), args, SMEM, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
