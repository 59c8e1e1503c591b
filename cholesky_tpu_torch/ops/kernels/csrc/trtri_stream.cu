// trtri_stream_f32: inverse of a lower-triangular n x n matrix, n % 128 == 0,
// 128 <= n <= 8192, in one cooperative launch over every SM.
//
// Replaces cholesky_tpu/ops/pallas/mega.py:trtri_hbm_f32
// (_trtri_hbm_kernel), the TPU's whole-matrix trtri for 1024 < n <= 8192.
// On the GP model's train step it is potri's trtri at n = 4096, and both
// halves of the recursion at n = 8192.
//
// Contract (that of trtri_block.cu without its 1024 cap): only the lower
// triangle of L is read; W is a separate buffer whose strict upper is
// written zero. A zero diagonal entry is read as 1 and does not stop the
// inversion, so W stays finite; info is the 1-based index of the first
// (smallest) zero diagonal, as LAPACK's strtri reports it.
//
// What bounds it on the H100: n^3/6 FFMA (11.5 G at n = 4096), and the
// sequential dependency of the inverse. The TPU kernel streamed 128-row
// panels bottom-up through one core's VMEM. A one-CTA stream here would
// repeat potrf_block_f32's one-SM bottleneck at 4-64x the work; column
// stripes (one CTA per 32 columns, as trtri_block.cu) or bottom-up panels
// with a grid-wide sync between them both leave one CTA with a chain of
// about 16 n^2 FFMA (the first stripe, or each panel's bottom row tile),
// 268 M at n = 4096, which one SM runs at a few percent of the card.
//
// Design: the recursion W = [W1 0; -W2·M·W1 W2] run level by level, so
// every phase is a wide, independent set of 64 x 64 tiles:
//   phase A   every 128 x 128 diagonal tile inverted by forward
//             substitution (one thread per column), the off-diagonal
//             upper blocks zeroed, info from the diagonal;
//   level s   (s = 128, 256, ..., < n) for each pair of inverted s-blocks
//             W1 = W[b:b+s, b:b+s], W2 = W[b+s:b+s+s2, ...] and
//             M = L[b+s:b+s+s2, b:b+s]:  T = W2·M into the scratch S,
//             then W[b+s:, b:b+s] = -T·W1.
// One cooperative launch (grid from the occupancy query, a few CTAs per
// SM), a grid-wide sync between phases, 1 + 2·log2(n/128) phases. Each
// tile's k-loop skips the zero triangle of W1 or W2, so the flops stay
// n^3/6, and the longest chain is one tile of depth s, not n. Reads of W
// and S, which other CTAs wrote in this launch, bypass L1 (__ldcg).
#include <cooperative_groups.h>

#include "sgemm_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NB = 128;        // diagonal tile of phase A
constexpr int BT = 64;         // GEMM tile edge of the levels
constexpr int BK = 16;         // k-step of the GEMM tiles
constexpr int NT = (BT / ct::TM) * (BT / ct::TN);   // 256 threads
constexpr int MAX_N = 8192;

__global__ void __launch_bounds__(NT)
trtri_stream_f32_kernel(const float* L, long long ldl, float* W,
                        long long ldw, float* S, int n, int* info) {
  __shared__ float Xs[BK][BT + 1];
  __shared__ float Ys[BK][BT + 1];
  __shared__ int s_first;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int nd = n / NB;                 // diagonal tiles

  // ---- phase A: info, the upper off-diagonal blocks, the diagonal tiles
  if (blockIdx.x == 0) {
    if (tid == 0) s_first = n;
    __syncthreads();
    for (int i = tid; i < n; i += NT)
      if (L[i * ldl + i] == 0.f) atomicMin(&s_first, i);
    __syncthreads();
    if (tid == 0) *info = (s_first < n) ? s_first + 1 : 0;
  }
  for (int r = blockIdx.x; r < n; r += gridDim.x)
    for (int c = (r / NB + 1) * NB + tid; c < n; c += NT) W[r * ldw + c] = 0.f;
  // two tiles per CTA, one column per thread: lockstep forward
  // substitution of L_p·w = e_c down all 128 rows (rows above c come out
  // zero), so every thread of a warp reads the same L element
  for (int p = 2 * blockIdx.x + tid / NB; p < nd; p += 2 * gridDim.x) {
    const int c = tid % NB;
    const float* Lp = L + (long long)p * NB * ldl + p * NB;
    float* Wp = W + (long long)p * NB * ldw + p * NB;
    for (int i = 0; i < NB; ++i) {
      float x = (i == c) ? 1.f : 0.f;
      for (int k = 0; k < i; ++k) x = fmaf(-Lp[i * ldl + k], Wp[k * ldw + c], x);
      float d = Lp[i * ldl + i];
      if (d == 0.f) d = 1.f;
      Wp[i * ldw + c] = x / d;
    }
  }
  grid.sync();

  // ---- levels: merge pairs of inverted s-blocks into 2s-blocks
  for (int s = NB; s < n; s *= 2) {
    const int npairs = (n - s + 2 * s - 1) / (2 * s);  // pairs with b + s < n
    const int st = s / BT;                               // tiles along s
    const int tiles = npairs * st * st;
    // T = W2·M, T row-major s2 x s at S + q·s·s (ld s); W2 lower, so the
    // k-loop of row tile lr stops at the end of its own rows
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int q = t / (st * st), lr = (t % (st * st)) / st, lc = t % st;
      const int b = q * 2 * s;
      const int s2 = min(s, n - b - s);
      if (lr * BT >= s2) continue;
      const float* W2 = W + (long long)(b + s) * ldw + (b + s);
      const float* M = L + (long long)(b + s) * ldl + b;
      float acc[ct::TM][ct::TN] = {};
      // X = W2 (rows, k), Y(c, k) = M[k][c]
      ct::tile_xyt<BT, BT, BK, true>(W2, ldw, 1, lr * BT, s2, M, 1, ldl,
                                     lc * BT, s, (lr + 1) * BT, Xs, Ys, acc);
      ct::store_tile<BT, BT>(S + (long long)q * s * s, s, lr * BT, lc * BT,
                             1.f, acc);
    }
    grid.sync();
    // W[b+s:b+s+s2, b:b+s] = -T·W1; W1 lower, so the k-loop of column
    // tile lc starts at its own columns
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int q = t / (st * st), lr = (t % (st * st)) / st, lc = t % st;
      const int b = q * 2 * s;
      const int s2 = min(s, n - b - s);
      if (lr * BT >= s2) continue;
      const float* T = S + (long long)q * s * s;
      const float* W1 = W + (long long)b * ldw + b;
      const int k0 = lc * BT;
      float acc[ct::TM][ct::TN] = {};
      // X(r, k) = T[r][k0 + k], Y(c, k) = W1[k0 + k][c]
      ct::tile_xyt<BT, BT, BK, true>(T + k0, s, 1, lr * BT, s2,
                                     W1 + (long long)k0 * ldw, 1, ldw,
                                     lc * BT, s, s - k0, Xs, Ys, acc);
      ct::store_tile<BT, BT>(W + (long long)(b + s) * ldw + b, ldw, lr * BT,
                             lc * BT, -1.f, acc);
    }
    grid.sync();
  }
}

}  // namespace

CT_EXPORT int ct_trtri_stream_f32(const float* L, long long ldl, float* W,
                                  long long ldw, float* S, int n, int* info,
                                  int device, void* stream) {
  if (n < NB || n > MAX_N || n % NB != 0 || ldl < n || ldw < n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int coop = 0, nsm = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, trtri_stream_f32_kernel, NT, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  void* args[] = {&L, &ldl, &W, &ldw, &S, &n, &info};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(trtri_stream_f32_kernel), dim3(nsm * per_sm),
      dim3(NT), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
