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
// What bounds them on the H100: n^3/3 FFMA each (0.73 T for potf2 at
// n = 16384), at best the 67 TFLOP/s f32 vector rate (21.9 ms for potf2
// at 16384), and for potf2 the chain of n/128 diagonal tiles, each
// factored on one thread block (60-80 µs a tile).
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
//   trti2, right-looking over 128-wide panels from the last one up. W
//   starts at zero and its strict lower part below-left of the panel
//   accumulates the fold of the panels already inverted:
//     sweep(b)  W[i, b:b+128] for every row i >= b, one thread per row
//               (the rows are independent; the 128 x 128 tile of L sits
//               in shared memory, read by broadcast), columns descending:
//               W[i][j] = −(acc[i][j] + Σ_{j<k<b+128} W[i][k]·L[k][j])/d_j;
//     fold(b)   W[b:, :b] += W[b:, b:b+128] · L[b:b+128, :b], 64 x 64
//               tiles with k = 128.
//   The same arithmetic as the TPU's left-looking fold (T2 = W·L per
//   panel), with each product done once the panel it needs is final, so
//   every launch is a wide set of equal tiles.
#include <algorithm>

#include "chol_tile.cuh"
#include "sgemm128.cuh"

namespace {

constexpr int NB = ct::tile::NB;   // panel width
constexpr int BT = 64;             // GEMM tile edge
constexpr int BK = 16;             // k-step of the GEMM tiles
constexpr int NT = (BT / ct::TM) * (BT / ct::TN);   // 256 threads
static_assert(NT == ct::tile::NT, "factor_tile runs on the whole block");
constexpr int RB = 64;             // rows (threads) per block of the sweep
constexpr int LDW = RB + 1;        // shared stride of the sweep's rows
constexpr int SWEEP_SMEM =
    (NB * ct::tile::LDT + NB * LDW + NB) * static_cast<int>(sizeof(float));

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

// W written zero (the fold accumulates into it) and info from L's diagonal.
__global__ void trti2_init(const float* L, long long ldl, float* W,
                           long long ldw, int n, int unit, int* info) {
  __shared__ int s_first;
  if (blockIdx.x == 0) {
    if (threadIdx.x == 0) s_first = n;
    __syncthreads();
    if (!unit)
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        if (L[(long long)i * ldl + i] == 0.f) atomicMin(&s_first, i);
    __syncthreads();
    if (threadIdx.x == 0) *info = (s_first < n) ? s_first + 1 : 0;
  }
  for (int r = blockIdx.x; r < n; r += gridDim.x)
    for (int c = threadIdx.x; c < n; c += blockDim.x)
      W[(long long)r * ldw + c] = 0.f;
}

// The sweep of the panel at columns [b, b + pw) for rows [r0, r0 + RB),
// r0 = b + blockIdx.x·RB, one thread per row, columns descending.
__global__ void __launch_bounds__(RB)
trti2_sweep(const float* L, long long ldl, float* W, long long ldw, int n,
            int b, int pw, int unit) {
  extern __shared__ float sm[];
  float* const Lt = sm;                        // Lt[k·LDT + c] = L[b+k][b+c]
  float* const Ws = sm + NB * ct::tile::LDT;   // Ws[c·LDW + t] = W[r0+t][b+c]
  float* const dinv = Ws + NB * LDW;
  constexpr int LDT = ct::tile::LDT;
  const int tid = threadIdx.x;
  const int r0 = b + blockIdx.x * RB;
  const int rows = min(RB, n - r0);
  for (int idx = tid; idx < pw * pw; idx += RB) {
    const int k = idx / pw, c = idx % pw;
    Lt[k * LDT + c] = (c <= k) ? L[(long long)(b + k) * ldl + b + c] : 0.f;
  }
  for (int idx = tid; idx < RB * pw; idx += RB) {
    const int t = idx / pw, c = idx % pw;
    Ws[c * LDW + t] = (t < rows) ? W[(long long)(r0 + t) * ldw + b + c] : 0.f;
  }
  __syncthreads();
  for (int c = tid; c < pw; c += RB) {
    const float d = Lt[c * LDT + c];
    dinv[c] = (unit || d == 0.f) ? 1.f : 1.f / d;
  }
  __syncthreads();
  const int i = r0 - b + tid;      // the row, relative to the panel
  if (tid < rows) {
    for (int c = pw - 1; c >= 0; --c) {
      float v;
      if (i < c) {
        v = 0.f;
      } else if (i == c) {
        v = dinv[c];
      } else {                     // W[i][k] = 0 for k > i: the sum is exact
        float s0 = Ws[c * LDW + tid], s1 = 0.f;
        int k = c + 1;
        for (; k + 1 < pw; k += 2) {
          s0 = fmaf(Ws[k * LDW + tid], Lt[k * LDT + c], s0);
          s1 = fmaf(Ws[(k + 1) * LDW + tid], Lt[(k + 1) * LDT + c], s1);
        }
        if (k < pw) s0 = fmaf(Ws[k * LDW + tid], Lt[k * LDT + c], s0);
        v = -(s0 + s1) * dinv[c];
      }
      Ws[c * LDW + tid] = v;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < RB * pw; idx += RB) {
    const int t = idx / pw, c = idx % pw;
    if (t < rows) W[(long long)(r0 + t) * ldw + b + c] = Ws[c * LDW + t];
  }
  // the last sweep puts a unit diagonal back: L's own, as LAPACK leaves it
  // (no launch reads W's diagonal after this one)
  if (unit && b == 0) {
    __syncthreads();
    if (tid < rows) {
      const long long r = r0 + tid;
      W[r * ldw + r] = L[r * ldl + r];
    }
  }
}

// The fold of the panel at b: W[b:, :b] += W[b:, b:b+NB] · L[b:b+NB, :b],
// one 64 x 64 tile per block, m = n - b rows.
__global__ void __launch_bounds__(NT)
trti2_fold(const float* L, long long ldl, float* W, long long ldw, int b,
           int m) {
  __shared__ float Xs[BK][BT + 1];
  __shared__ float Ys[BK][BT + 1];
  const int lr = blockIdx.y, lc = blockIdx.x;
  float acc[ct::TM][ct::TN] = {};
  // X(r, k) = W[b + r][b + k]; Y(c, k) = L[b + k][c]
  ct::tile_xyt<BT, BT, BK>(W + (long long)b * ldw + b, ldw, 1, lr * BT, m,
                           L + (long long)b * ldl, 1, ldl, lc * BT, b, NB,
                           Xs, Ys, acc);
  const int tx = threadIdx.x % (BT / ct::TN);
  const int ty = threadIdx.x / (BT / ct::TN);
#pragma unroll
  for (int i = 0; i < ct::TM; ++i) {
    const long long r = b + lr * BT + ty + i * (BT / ct::TM);
#pragma unroll
    for (int j = 0; j < ct::TN; ++j)
      W[r * ldw + lc * BT + tx + j * (BT / ct::TN)] += acc[i][j];
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
                           long long ldw, int n, int unit, int* info,
                           int device, void* stream) {
  if (!leaf_size(n) || ldl < n || ldw < n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(trti2_sweep,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SWEEP_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  trti2_init<<<std::min(n, 4096), 256, 0, s>>>(L, ldl, W, ldw, n, unit, info);
  for (int b = (n - 1) / NB * NB; b >= 0; b -= NB) {
    const int pw = std::min(NB, n - b), m = n - b;
    trti2_sweep<<<(m + RB - 1) / RB, RB, SWEEP_SMEM, s>>>(L, ldl, W, ldw, n, b,
                                                          pw, unit);
    if (b > 0)
      trti2_fold<<<dim3(b / BT, m / BT), NT, 0, s>>>(L, ldl, W, ldw, b, m);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
