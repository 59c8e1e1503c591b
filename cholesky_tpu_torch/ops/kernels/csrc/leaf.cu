// potf2_f32 and trti2_f32: the leaf Cholesky and the leaf lower inverse of
// an n x n block, n <= 128 or a multiple of 128, with no upper cap.
//
// Replace cholesky_tpu/ops/pallas/leaf.py:potf2_f32 (_potf2_kernel) and
// trti2_f32 (_trti2_kernel, _trti2_unit_kernel). On the card they take the
// blocks the whole-matrix kernels refuse: the public potf2 above the
// potrf_stream_f32 cap (spotf2 at n = 16384), trtri with a block size
// above the trtri_stream_f32 cap, and the d tier's leaves there.
//
// Contracts (those of the TPU kernels):
//   potf2   in place; only the lower triangle is read and the strict upper
//           is written zero; info is the 1-based index of the first pivot
//           with !(d > 0), NaN-safe; the factor freezes at a failed pivot:
//           its 128-wide tile is stored as far as it got, nothing after it
//           is solved, and no later strip is updated (the trailing update
//           of the strip before it, which runs beside the failing strip's
//           panels, may stop part way), so every stored value stays finite
//           but an input NaN at its own position.
//   trti2   W = tril(L)⁻¹ into a separate buffer with a zero strict upper;
//           only the lower triangle of L is read. A zero diagonal is read
//           as 1 and does not stop the sweep; info is the 1-based index of
//           the first (smallest) zero diagonal, as LAPACK's strtri
//           reports it. With unit, the diagonal is read as 1, info is 0
//           and W's diagonal is L's, passed through as in xtrti2.
//
// What bounds them on the H100: n^3/6 FFMA each (0.73 T flops for potf2
// at n = 16384, 0.18 T for trti2 at 8192), at best the 67 TFLOP/s f32
// vector rate (21.9 ms for potf2 at 16384, 2.74 ms for trti2 at 8192),
// and what feeds the FFMA tiles; for potf2 also the chain of n/128
// diagonal tiles, each factored on one thread block (60-80 µs a tile).
//
// Design: the TPU kernels held the whole block in VMEM and swept 128-wide
// panels in one dispatch. Here the block stays in device memory and ONE C
// entry point enqueues a short kernel per step, so any n fits; no host
// code reads info: every later kernel reads the info word on the device
// and returns at once past a failure.
//   potf2, two levels: strips of KB columns (POTF2_KB in leaf.py, 512),
//   and 128-wide panels inside a strip, right-looking:
//     F(c0)  one block factors and inverts the diagonal tile
//            (chol_tile.cuh, as potrf_stream.cu does);
//     S(c0)  the rows below it, 64 per block: A_panel := A_panel · W⁻ᵀ,
//            also stored transposed into PT (one row a panel column);
//     U(c0)  the strip's own columns right of the panel, k = 128;
//   then the trailing matrix takes ONE A22 -= P·Pᵀ of depth KB from the
//   strip's PT rows. Each update is a trapezoid of lower tiles on
//   sgemm128.cuh's 128 x 128 cp.async tile with both operands row-fast
//   (the 64 x 64 tile where fewer than GEMM128_MIN_TILES tiles of 128
//   exist). Depth KB amortises each tile's read-modify-write of A and its
//   pipeline fill over KB/16 k-steps instead of 8. Lookahead: the next
//   strip's columns are updated first; that strip's F/S/U chain then runs
//   on a second stream of the highest priority while the rest of the
//   trailing matrix is updated on the caller's stream, which waits for
//   the chain at the end of each strip, so F is hidden behind the bulk
//   update except near the end. The two strips in flight use the two
//   halves of PT. The version before this one ran 128-wide panels with a
//   64 x 64-tile update of depth 128 and every F exposed: 88.0 ms at
//   16384 against cholesky_ex's 45.1-45.3; this one 44.3 (chip_compare.py),
//   KB = 256 44.5-44.7 and 1024 45.2-45.4 against 512's 43.8-44.3
//   (chip_smoke.py; NVIDIA H100 80GB HBM3, 700 W).
//   trti2, the 2 x 2 block identity inv([[A, 0], [B, C]]) = [[A⁻¹, 0],
//   [−C⁻¹·B·A⁻¹, C⁻¹]] applied bottom-up, trtri_block_f32's order of work
//   (mega.trtri_levels) as a short series of wide launches, so no cap on n
//   and no cooperative launch:
//     leaves  every 128-wide diagonal tile inverted at once, one block
//             each (trtri_leaf.cuh, shared with trtri_block.cu); block 0
//             writes info;
//     levels  for s = 128, 256, ... < n, each pair (A at a0, C at a0 + s,
//             C short at the end) of inverted s-blocks, in two launches
//             over the output tiles of every pair of the level:
//               Xᵀ = (B·A⁻¹)ᵀ = A⁻ᵀ·Bᵀ into W's strict upper, the mirror
//                 W[a0:c0, c0:c0+sc] of the block it is computed for;
//               W[c0:c0+sc, a0:c0] = −C⁻¹·X, X read back from the mirror;
//             on sgemm128.cuh's 128 x 128 tile where the level has
//             GEMM128_MIN_TILES tiles of 128 (the count passed from
//             leaf.py), on sgemm_tile.cuh's 64 x 64 below. A⁻¹ and C⁻¹
//             are lower, so a tile's depth runs only where they are live
//             (n³/6 FFMA in all), and the deepest tiles are launched
//             first. A⁻¹ is read from its diagonal tile on (its upper part
//             there is the leaf's zero) and C⁻¹ up to its diagonal tile,
//             so no launch reads a mirror but the one its level wrote;
//     finish  W's strict upper outside the leaves written zero (the
//             mirrors), and with unit, L's diagonal put on W's.
//   1 + 2·log2(n/128) + 1 launches: 14 at 8192, whose top level (two
//   launches of 1024 tiles of 128, depth up to 4096) holds 3/4 of the
//   FFMA. 5.11-5.22 ms at 8192 and 0.27-0.31 at 1024 against
//   solve_triangular(L, I)'s 17.48-17.60 and 0.40-0.41; trtri_stream_f32
//   on the same factor 0.87-0.88 / 2.27-2.34 / 12.48-12.67 ms at 2048 /
//   4096 / 8192, this kernel 0.56 / 1.21-1.27 / 5.09-5.30
//   (chip_smoke.py). The design before this one ran 64 panels in
//   sequence at 8192, each a per-row sweep (one thread a row through a
//   chain of up to 128 dependent FFMAs) and a fold of depth 128 on the
//   64 x 64 tile that read and wrote all of W[b:, :b] again: 18.65 ms at
//   8192 (sweeps 8.57 ms of device time, folds 9.62) against
//   solve_triangular(L, I)'s 17.48, 1.107 ms at 1024 (sweeps 0.93)
//   (chip_compare.py; NVIDIA H100 80GB HBM3, 700 W).
#include <algorithm>

#include "chol_tile.cuh"
#include "sgemm128.cuh"
#include "trtri_leaf.cuh"

namespace {

constexpr int NB = ct::tile::NB;   // panel width
constexpr int BT = 64;             // GEMM tile edge
constexpr int BK = 16;             // k-step of the GEMM tiles
constexpr int NT = (BT / ct::TM) * (BT / ct::TN);   // 256 threads
static_assert(NT == ct::tile::NT, "factor_tile runs on the whole block");
static_assert(NT == ct::tleaf::NT && NB == ct::tleaf::LW, "trti2's leaves");

// ---- potf2 ---------------------------------------------------------------

// The strict upper written zero and info cleared, before any step.
__global__ void potf2_init(float* A, long long lda, int n, int* info) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *info = 0;
  for (int r = blockIdx.x; r < n; r += gridDim.x)
    for (int c = r + 1 + threadIdx.x; c < n; c += blockDim.x)
      A[(long long)r * lda + c] = 0.f;
}

// F: factor (and, when rows follow, invert) the diagonal tile at c0.
__global__ void __launch_bounds__(NT)
potf2_factor(float* A, long long lda, int c0, int pw, int want_inv,
             float* Winv, int* info) {
  extern __shared__ float T[];
  __shared__ float dinv[NB];
  __shared__ int s_fail;
  if (*info != 0) return;          // an earlier tile failed: frozen
  ct::tile::factor_tile(A, lda, c0, pw, want_inv != 0, Winv, info, T, dinv,
                        &s_fail);
}

// S: the m rows below the tile at c0, 64 per block, times Winvᵀ in place,
// and transposed into PT (row k of PT the panel's column k, element r at
// PT[k·n + r], r the row of A), whose rows the trailing updates read along
// their unit stride. Winv is lower, so output column tile lc needs
// k < (lc + 1)·BT only.
__global__ void __launch_bounds__(NT)
potf2_solve(float* A, long long lda, int c0, int m, const float* Winv,
            float* PT, int n, const int* info) {
  __shared__ float Xs[BK][BT + 1];
  __shared__ float Ys[BK][BT + 1];
  __shared__ float St[BT][BT + 1];
  if (*info != 0) return;
  float* const P = A + (long long)(c0 + NB) * lda + c0;
  const int lr = blockIdx.x;
  float acc[2][ct::TM][ct::TN] = {};
  ct::tile_xyt<BT, BT, BK>(P, lda, 1, lr * BT, m, Winv, NB, 1, 0, NB, BT,
                           Xs, Ys, acc[0]);
  ct::tile_xyt<BT, BT, BK>(P, lda, 1, lr * BT, m, Winv, NB, 1, BT, NB, NB,
                           Xs, Ys, acc[1]);
  // every thread of the block has read its rows (tile_xyt ends with a
  // barrier): they may be overwritten
  const int tx = threadIdx.x % (BT / ct::TN);
  const int ty = threadIdx.x / (BT / ct::TN);
  const long long r0 = c0 + NB + lr * BT;     // the tile's first row of A
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ct::store_tile<BT, BT>(P, lda, lr * BT, h * BT, 1.f, acc[h]);
#pragma unroll
    for (int i = 0; i < ct::TM; ++i)
#pragma unroll
      for (int j = 0; j < ct::TN; ++j)
        St[tx + j * (BT / ct::TN)][ty + i * (BT / ct::TM)] = acc[h][i][j];
    __syncthreads();
    for (int idx = threadIdx.x; idx < BT * BT; idx += NT) {
      const int k = idx / BT, r = idx % BT;
      PT[static_cast<long long>(h * BT + k) * n + r0 + r] = St[k][r];
    }
    __syncthreads();
  }
}

// The trailing updates run on a trapezoid of A: rows [b, n), columns
// [b, b + w), lower part only, A[r][c] -= Σ_k P[r][k]·P[c][k] over K
// solved panel columns, read from their transposed copy: P[r][k] at
// PT[k·n + r]. Its tiles are walked column by column: column tile tj holds
// row tiles tj .. mt - 1.
__host__ __device__ inline long long trap_tiles(int mt, int wt) {
  return static_cast<long long>(wt) * mt - static_cast<long long>(wt) *
                                               (wt - 1) / 2;
}

__device__ __forceinline__ void trap_tile(int t, int mt, int& ti, int& tj) {
  tj = 0;
  while (t >= mt - tj) t -= mt - tj++;
  ti = tj + t;
}

// U on 64 x 64 tiles, one per block (grids too small for the 128 tile).
__global__ void __launch_bounds__(NT)
potf2_update64(float* A, long long lda, const float* PT, int K, int b, int n,
               const int* info) {
  __shared__ float Xs[BK][BT + 1];
  __shared__ float Ys[BK][BT + 1];
  if (*info != 0) return;
  const int m = n - b;
  int ti, tj;
  trap_tile(blockIdx.x, m / BT, ti, tj);
  float acc[ct::TM][ct::TN] = {};
  ct::tile_xyt<BT, BT, BK>(PT + b, 1, n, ti * BT, m, PT + b, 1, n, tj * BT,
                           m, K, Xs, Ys, acc);
  float* const At = A + static_cast<long long>(b) * lda + b;
  const int tx = threadIdx.x % (BT / ct::TN);
  const int ty = threadIdx.x / (BT / ct::TN);
#pragma unroll
  for (int i = 0; i < ct::TM; ++i) {
    const int r = ti * BT + ty + i * (BT / ct::TM);
#pragma unroll
    for (int j = 0; j < ct::TN; ++j) {
      const int c = tj * BT + tx + j * (BT / ct::TN);
      if (c <= r) At[static_cast<long long>(r) * lda + c] -= acc[i][j];
    }
  }
}

// U on sgemm128.cuh's 128 x 128 tile, one per block, both operands
// row-fast rows of PT (on the 16-byte grid: n % 128 == 0). The
// accumulators are subtracted from A a micro-tile row at a time, four
// columns at once off the diagonal where A and lda are on the 16-byte
// grid (VEC).
constexpr int SMEM128 =
    ct::t128::smem_floats<false, false>() * static_cast<int>(sizeof(float));

template <bool VEC>
__global__ void __launch_bounds__(ct::t128::NT, 2)
potf2_update128(float* A, long long lda, const float* PT, int K, int b,
                int n, const int* info) {
  extern __shared__ __align__(16) float smem[];
  constexpr int BM = ct::t128::BM;
  if (*info != 0) return;
  const int m = n - b;
  int ti, tj;
  trap_tile(blockIdx.x, m / BM, ti, tj);
  float acc[8][8] = {};
  ct::t128::tile_xyt<false, false, true>(PT + b, 1, n, ti * BM, m, PT + b, 1,
                                         n, tj * BM, m, K, smem, acc);
  float* const At = A + static_cast<long long>(b + ti * BM) * lda + b +
                    tj * BM;
  const bool diag = ti == tj;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ct::t128::row_of(i);
    float* const row = At + static_cast<long long>(r) * lda;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = ct::t128::col_of(4 * h);
      if (VEC && !diag) {
        float4 v = *reinterpret_cast<float4*>(row + c);
        v.x -= acc[i][4 * h];
        v.y -= acc[i][4 * h + 1];
        v.z -= acc[i][4 * h + 2];
        v.w -= acc[i][4 * h + 3];
        *reinterpret_cast<float4*>(row + c) = v;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!diag || c + e <= r) row[c + e] -= acc[i][4 * h + e];
      }
    }
  }
}

// ---- trti2 ---------------------------------------------------------------

template <bool UNIT>
__global__ void __launch_bounds__(NT)
trti2_leaf(const float* __restrict__ L, long long ldl, float* W,
           long long ldw, int n, int* info) {
  extern __shared__ __align__(16) float sm[];
  ct::tleaf::leaf<UNIT>(L, ldl, W, ldw, n, blockIdx.x, sm, info);
}

// Pairs of s-blocks whose second block starts inside the matrix.
__host__ __device__ inline int pairs(int n, int s) {
  return (n - s + 2 * s - 1) / (2 * s);
}

// Output tile t of a level's launch on E x E tiles, t = (a·pairs + p)·per
// + b, per = s / E: pair p (A at a0, C at c0 = a0 + s, sc rows of C), and
// the tile (ti, tj) of Xᵀ (s x sc; second = false) or of W21 (sc x s),
// ordered so that a, the slowest index, runs from the deepest tiles down.
// live: the tile lies inside the pair's short C.
struct LevelTile {
  long long a0, c0;
  int sc, ti, tj;
  bool live;
};

__device__ __forceinline__ LevelTile level_tile(int t, int n, int s, int E,
                                                bool second) {
  const int per = s / E, np = pairs(n, s);
  const int a = t / (np * per), p = t % (np * per) / per, b = t % per;
  LevelTile q;
  q.a0 = 2LL * p * s;
  q.c0 = q.a0 + s;
  q.sc = min(s, n - static_cast<int>(q.c0));
  q.ti = second ? per - 1 - a : a;   // Xᵀ: depth s − a·E; W21: (ti + 1)·E
  q.tj = b;
  q.live = (second ? q.ti : q.tj) * E < q.sc;
  return q;
}

// One level's launch on the 128 tile (a multiple of 128 rows: every tile
// is whole). First (SECOND = false): Xᵀ[r][c] = Σ_{k >= r} A⁻¹[k][r]·B[c][k]
// into the mirror, A⁻¹ row-fast from W, B k-fast from L (VEC: L on the
// 16-byte grid). Second: W21[i][j] = −Σ_{k <= i} C⁻¹[i][k]·Xᵀ[j][k], both
// k-fast from W.
constexpr int SMEM_X =
    ct::t128::smem_floats<false, true>() * static_cast<int>(sizeof(float));
constexpr int SMEM_W =
    ct::t128::smem_floats<true, true>() * static_cast<int>(sizeof(float));

template <bool SECOND, bool VEC>
__global__ void __launch_bounds__(ct::t128::NT, 2)
trti2_level128(const float* __restrict__ L, long long ldl, float* W,
               long long ldw, int n, int s) {
  constexpr int E = ct::t128::BM;
  extern __shared__ __align__(16) float smem[];
  const LevelTile q = level_tile(blockIdx.x, n, s, E, SECOND);
  if (!q.live) return;
  const int r0 = q.ti * E, c0 = q.tj * E;
  float acc[8][8] = {};
  float* D;
  if (!SECOND) {
    ct::t128::tile_xyt<false, true, VEC>(
        W + (q.a0 + r0) * ldw + q.a0, 1, ldw, r0, s,
        L + q.c0 * ldl + q.a0 + r0, ldl, 1, c0, q.sc, s - r0, smem, acc);
    D = W + q.a0 * ldw + q.c0;
  } else {
    ct::t128::tile_xyt<true, true, true>(
        W + q.c0 * ldw + q.c0, ldw, 1, r0, q.sc, W + q.a0 * ldw + q.c0, ldw,
        1, c0, s, min(r0 + E, q.sc), smem, acc);
    D = W + q.c0 * ldw + q.a0;
  }
  const float sign = SECOND ? -1.f : 1.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(D + (r0 + ct::t128::row_of(i)) * ldw + c0 +
                                 ct::t128::col_of(4 * h)) =
          make_float4(sign * acc[i][4 * h], sign * acc[i][4 * h + 1],
                      sign * acc[i][4 * h + 2], sign * acc[i][4 * h + 3]);
}

// The same on the 64 x 64 tile, for levels with few tiles of 128.
template <bool SECOND>
__global__ void __launch_bounds__(NT)
trti2_level64(const float* __restrict__ L, long long ldl, float* W,
              long long ldw, int n, int s) {
  __shared__ float Xs[BK][BT + 1];
  __shared__ float Ys[BK][BT + 1];
  const LevelTile q = level_tile(blockIdx.x, n, s, BT, SECOND);
  if (!q.live) return;
  const int r0 = q.ti * BT, c0 = q.tj * BT;
  float acc[ct::TM][ct::TN] = {};
  if (!SECOND) {
    ct::tile_xyt<BT, BT, BK>(W + (q.a0 + r0) * ldw + q.a0, 1, ldw, r0, s,
                             L + q.c0 * ldl + q.a0 + r0, ldl, 1, c0, q.sc,
                             s - r0, Xs, Ys, acc);
    ct::store_tile<BT, BT>(W + q.a0 * ldw + q.c0, ldw, r0, c0, 1.f, acc);
  } else {
    ct::tile_xyt<BT, BT, BK>(W + q.c0 * ldw + q.c0, ldw, 1, r0, q.sc,
                             W + q.a0 * ldw + q.c0, ldw, 1, c0, s,
                             min(r0 + BT, q.sc), Xs, Ys, acc);
    ct::store_tile<BT, BT>(W + q.c0 * ldw + q.a0, ldw, r0, c0, -1.f, acc);
  }
}

// W's strict upper right of each row's leaf written zero (the mirrors of
// every level), and with unit, L's diagonal put on W's, as xtrti2 leaves
// it (no launch reads W's diagonal after this one).
__global__ void trti2_finish(const float* __restrict__ L, long long ldl,
                             float* W, long long ldw, int n, int unit) {
  for (int r = blockIdx.x; r < n; r += gridDim.x) {
    float* const row = W + r * ldw;
    for (int c = (r / NB + 1) * NB + 4 * threadIdx.x; c < n;
         c += 4 * blockDim.x)
      *reinterpret_cast<float4*>(row + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    if (unit && threadIdx.x == 0) row[r] = L[r * ldl + r];
  }
}

bool leaf_size(int n) { return n >= 1 && (n <= NB || n % NB == 0); }

}  // namespace

CT_EXPORT int ct_potf2_f32(float* A, long long lda, float* Winv, float* PT,
                           int n, int kb, int min_tiles128, int* info,
                           int device, void* stream) {
  if (!leaf_size(n) || lda < n || kb < NB || kb % NB != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = reinterpret_cast<unsigned long long>(A) % 16 == 0 &&
                   lda % 4 == 0;
  err = cudaFuncSetAttribute(potf2_factor,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             ct::tile::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      vec ? potf2_update128<true> : potf2_update128<false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM128);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  potf2_init<<<std::min(n, 4096), 256, 0, s>>>(A, lda, n, info);

  // U of the trapezoid at b, w columns wide, from K panel columns whose
  // transposed copy is Pt: the 128 tile where the grid has min_tiles128 of
  // them, else the 64 tile
  auto update = [&](cudaStream_t st, const float* Pt, int K, int b, int w) {
    if (w <= 0) return;
    const int m = n - b;
    const auto t128 = static_cast<unsigned>(trap_tiles(m / 128, w / 128));
    if (t128 >= static_cast<unsigned>(min_tiles128)) {
      if (vec)
        potf2_update128<true><<<t128, ct::t128::NT, SMEM128, st>>>(
            A, lda, Pt, K, b, n, info);
      else
        potf2_update128<false><<<t128, ct::t128::NT, SMEM128, st>>>(
            A, lda, Pt, K, b, n, info);
    } else {
      potf2_update64<<<static_cast<unsigned>(trap_tiles(m / BT, w / BT)), NT,
                       0, st>>>(
          A, lda, Pt, K, b, n, info);
    }
  };
  // the strip [j0, j1): F, S and the strip's own columns of U, panel by
  // panel; its solved columns go transposed into PT's buffer Pt, one of
  // two, so that a strip's panels may run while the last one's trailing
  // update reads the other
  auto Pt = [&](int j0) {
    return PT + (j0 / kb % 2) * static_cast<long long>(kb) * n;
  };
  auto strip = [&](cudaStream_t st, int j0, int j1) {
    for (int c0 = j0; c0 < j1; c0 += NB) {
      const int pw = std::min(NB, n - c0), m = n - c0 - pw;
      potf2_factor<<<1, NT, ct::tile::SMEM, st>>>(A, lda, c0, pw, m > 0,
                                                   Winv, info);
      if (m > 0) {
        float* const Pc = Pt(j0) + static_cast<long long>(c0 - j0) * n;
        potf2_solve<<<m / BT, NT, 0, st>>>(A, lda, c0, m, Winv, Pc, n, info);
        update(st, Pc, NB, c0 + NB, j1 - c0 - NB);
      }
    }
  };

  strip(s, 0, std::min(kb, n));
  err = cudaGetLastError();
  if (err != cudaSuccess || kb >= n) return static_cast<int>(err);
  // Lookahead: the next strip's columns are updated first; then its
  // panels run on a second stream of the highest priority while the rest
  // of the trailing matrix is updated, which they do not touch.
  int least = 0, greatest = 0;
  cudaStream_t side = nullptr;
  cudaEvent_t ready = nullptr, done = nullptr;
  err = cudaDeviceGetStreamPriorityRange(&least, &greatest);
  if (err == cudaSuccess)
    err = cudaStreamCreateWithPriority(&side, cudaStreamNonBlocking,
                                       greatest);
  if (err == cudaSuccess)
    err = cudaEventCreateWithFlags(&ready, cudaEventDisableTiming);
  if (err == cudaSuccess)
    err = cudaEventCreateWithFlags(&done, cudaEventDisableTiming);
  for (int j0 = 0; err == cudaSuccess && j0 + kb < n; j0 += kb) {
    const int j1 = j0 + kb, j2 = std::min(j1 + kb, n);
    update(s, Pt(j0), kb, j1, j2 - j1);
    err = cudaEventRecord(ready, s);
    if (err == cudaSuccess) err = cudaStreamWaitEvent(side, ready, 0);
    if (err != cudaSuccess) break;
    strip(side, j1, j2);
    err = cudaEventRecord(done, side);
    if (err != cudaSuccess) break;
    update(s, Pt(j0), kb, j2, n - j2);
    err = cudaStreamWaitEvent(s, done, 0);   // the caller's stream last
    if (err == cudaSuccess) err = cudaGetLastError();
  }
  // released once their work is done
  if (done) cudaEventDestroy(done);
  if (ready) cudaEventDestroy(ready);
  if (side) cudaStreamDestroy(side);
  return static_cast<int>(err);
}

CT_EXPORT int ct_trti2_f32(const float* L, long long ldl, float* W,
                           long long ldw, int n, int unit, int min_tiles128,
                           int* info, int device, void* stream) {
  // W is the wrapper's own n x n buffer: on the 16-byte grid from n > 128
  if (!leaf_size(n) || ldl < n || ldw < n ||
      (n > NB && (ldw % 4 != 0 ||
                  reinterpret_cast<unsigned long long>(W) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = reinterpret_cast<unsigned long long>(L) % 16 == 0 &&
                   ldl % 4 == 0;
  const auto leaf_k = unit ? trti2_leaf<true> : trti2_leaf<false>;
  const auto x128 = vec ? trti2_level128<false, true>
                        : trti2_level128<false, false>;
  const auto w128 = trti2_level128<true, true>;
  err = cudaFuncSetAttribute(leaf_k,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             ct::tleaf::LEAF_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        x128, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_X);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        w128, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_W);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  leaf_k<<<(n + NB - 1) / NB, NT, ct::tleaf::LEAF_SMEM, st>>>(L, ldl, W, ldw,
                                                              n, info);
  for (int s = NB; s < n; s *= 2) {
    // the level's live tiles of 128: every pair's s/128 x sc/128
    const int np = pairs(n, s);
    const int last = n - (2 * (np - 1) * s + s);   // the last pair's sc
    const long long t128 =
        static_cast<long long>(s / 128) *
        ((np - 1) * (s / 128) + (std::min(s, last) + 127) / 128);
    if (t128 >= min_tiles128) {
      const unsigned grid = np * (s / 128) * (s / 128);
      x128<<<grid, ct::t128::NT, SMEM_X, st>>>(L, ldl, W, ldw, n, s);
      w128<<<grid, ct::t128::NT, SMEM_W, st>>>(L, ldl, W, ldw, n, s);
    } else {
      const unsigned grid = np * (s / BT) * (s / BT);
      trti2_level64<false><<<grid, NT, 0, st>>>(L, ldl, W, ldw, n, s);
      trti2_level64<true><<<grid, NT, 0, st>>>(L, ldl, W, ldw, n, s);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  trti2_finish<<<std::min(n, 4096), 256, 0, st>>>(L, ldl, W, ldw, n, unit);
  return static_cast<int>(cudaGetLastError());
}
