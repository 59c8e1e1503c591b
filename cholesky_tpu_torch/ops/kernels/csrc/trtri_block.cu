// trtri_block_f32: inverse of a lower-triangular n <= 1024 block.
//
// Replaces cholesky_tpu/ops/pallas/mega.py:trtri_vmem_f32
// (_trtri_vmem_kernel with _utri_diag_info and _newton_uinv). On the main
// path it inverts each 512 leaf of the blocked triangular solves and of the
// potrf panel solve, whose product with the panel (gemm.cu) then replaces
// a triangular solve: 48 launches in each GP train step at n = 8192.
//
// Contract: only the lower triangle of L is read; the output is a separate
// buffer whose strict upper is zero. A zero diagonal entry is treated as
// 1 and does not stop the inversion, so the output stays finite; info is
// the 1-based index of the first (smallest) zero diagonal, as LAPACK's
// strtri reports it.
//
// What bounds it on the H100: not its n^3/6 FFMA (22 M at n = 512, under a
// microsecond at the 67 TFLOP/s f32 rate) but the length of its chain of
// dependent steps. The design before this one solved 32-column stripes by
// forward substitution, one row per block-wide barrier: about 750 barriers
// in a row on the longest stripe, 0.26-0.30 ms at n = 512 against
// solve_triangular's 0.17-0.18 (NVIDIA H100 80GB HBM3, 700 W). The TPU
// kernel avoided substitution with Newton tile inverses and block
// products.
//
// Design: the 2 x 2 block identity
//     inv([[A, 0], [B, C]]) = [[A⁻¹, 0], [−C⁻¹·B·A⁻¹, C⁻¹]]
// applied bottom-up, so the chain is O(log n) phases:
//   leaf   every 128-wide diagonal tile at once, one block each, in shared
//          memory (trtri_leaf.cuh, shared with trti2_f32): four warps invert its 32-wide diagonal blocks by
//          column-oriented substitution in registers (lane j owns column
//          j, no barrier in the chain), then the block joins them with the
//          identity at 64 and at 128 (16-byte shared loads); the last tile
//          may be short (identity padding decouples). Block 0 also
//          computes info. The 64-wide join alone is 0.5 M FFMA on one
//          SM, at least 2 µs.
//   level  for s = 128, 256, 512 < n, each pair (A at a0, C at a0 + s, C
//          short at the end) of inverted s-blocks: X = B·A⁻¹ into the
//          scratch S (and the mirror tile of W's strict upper zero), then
//          W21 = −C⁻¹·X, each a set of 32 x 32 output tiles spread over the
//          blocks. A⁻¹ and C⁻¹ are lower, so a tile's depth is only where
//          the triangles are live; the depth is split over four groups of
//          64 threads (4 x 4 micro-tiles, 32-deep k-major chunks, the next
//          chunk's loads and the next k's fragments ahead), whose sums
//          meet in shared memory.
// One cooperative launch runs the phases with a grid sync between them
// (2·log2(n/128) + 1 phases: 5 at n = 512), on one block an SM at most;
// n <= 128 is one block, one phase. One launch per phase instead took
// 0.111-0.116 ms a call at n = 512 against 0.093-0.096 (chip_smoke.py's
// A/B when this design was added). Device time 11.5 / 32.5 / 67.5 µs at
// n = 128 / 512 / 1024, the design before this one 37.0 / 262.3 / 860.6
// (chip_compare.py, NVIDIA H100 80GB HBM3, 700 W). Every read of data
// written in the launch bypasses L1 (__ldcg).
#include <cooperative_groups.h>

#include <algorithm>

#include "sgemm_tile.cuh"
#include "trtri_leaf.cuh"

namespace cg = cooperative_groups;

namespace {

using ct::tleaf::LEAF_SMEM;
using ct::tleaf::LW;               // leaf tile
using ct::tleaf::NT;               // threads of a block
constexpr int TW = 32;             // product tile edge
constexpr int GT = 64;             // threads of a product group (4 x 4 each)
constexpr int NG = NT / GT;        // groups: a tile's depth split four ways
constexpr int KC = 32;             // k-depth of a staged chunk
constexpr int LDS = TW + 4;        // row stride of a staged chunk (16-byte)
constexpr int MAX_N = 1024;
// shared floats: a product's two chunks of both operands for each group
constexpr int TILE_FLOATS = NG * 2 * 2 * KC * LDS;
constexpr int TILE_SMEM = TILE_FLOATS * sizeof(float);
constexpr int SMEM = std::max(LEAF_SMEM, TILE_SMEM);

// acc += X·Yᵀ over k in [0, K) for a 32 x 32 tile, group g of the block
// taking the chunks g, g + 4, ...: X k-fast (row r at X + r·ldx, rows >= xr
// read as zero), Y row-fast (column c at Y[k·ldy + c], all 32 columns
// live). Each group's partial sums are left in its acc; ends with a
// barrier.
__device__ void product(const float* X, long long ldx, int xr,
                        const float* Y, long long ldy, int K, float* sm,
                        float (&acc)[4][4]) {
  const int g = threadIdx.x / GT, t = threadIdx.x % GT;
  auto Xs = reinterpret_cast<float (*)[KC][LDS]>(sm + g * 4 * KC * LDS);
  auto Ys = reinterpret_cast<float (*)[KC][LDS]>(sm + g * 4 * KC * LDS +
                                                 2 * KC * LDS);
  constexpr int U = TW * KC / GT;  // 16 elements of each operand a thread
  const int ty = t / 8, tx = t % 8;
  const int lr = t / KC, lk = t % KC;   // X: row lr + 2u, k lk
  const int rounds = ((K + KC - 1) / KC + NG - 1) / NG;
  float xv[U], yv[U];
  auto fetch = [&](int r) {
    const int k0 = (r * NG + g) * KC;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = lr + 2 * u, k = k0 + lk;
      xv[u] = (row < xr && k < K) ? __ldcg(X + row * ldx + k) : 0.f;
      const int ky = k0 + lr + 2 * u;   // Y: k row ky, column lk
      yv[u] = ky < K ? __ldcg(Y + ky * ldy + lk) : 0.f;
    }
  };
  fetch(0);
  for (int r = 0; r < rounds; ++r) {
    const int b = r & 1;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      Xs[b][lk][lr + 2 * u] = xv[u];
      Ys[b][lr + 2 * u][lk] = yv[u];
    }
    __syncthreads();
    if (r + 1 < rounds) fetch(r + 1);
    if ((r * NG + g) * KC < K) {
      float4 a[2], c[2];
      a[0] = *reinterpret_cast<const float4*>(&Xs[b][0][4 * ty]);
      c[0] = *reinterpret_cast<const float4*>(&Ys[b][0][4 * tx]);
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        if (k + 1 < KC) {          // the next k's fragments first
          a[~k & 1] = *reinterpret_cast<const float4*>(&Xs[b][k + 1][4 * ty]);
          c[~k & 1] = *reinterpret_cast<const float4*>(&Ys[b][k + 1][4 * tx]);
        }
        const float av[4] = {a[k & 1].x, a[k & 1].y, a[k & 1].z, a[k & 1].w};
        const float cv[4] = {c[k & 1].x, c[k & 1].y, c[k & 1].z, c[k & 1].w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(av[i], cv[j], acc[i][j]);
      }
    }
  }
  __syncthreads();
}

// Pairs of s-blocks whose second block starts inside the matrix.
__host__ __device__ inline int pairs(int n, int s) {
  return (n - s + 2 * s - 1) / (2 * s);
}

// One 32 x 32 output tile t of level s: X = B·A⁻¹ into S, and the mirror
// tile of the strict upper of W zero (second = false); or W21 = −C⁻¹·X
// into W (second = true). The four groups' partial sums meet in shared
// memory, and each thread stores four of the tile's elements.
__device__ void level_tile(const float* __restrict__ L, long long ldl,
                           float* W, long long ldw, float* S, int n, int s,
                           int t, bool second, float* sm) {
  const int per = s / TW;
  const int p = t / (per * per), loc = t % (per * per);
  const int i = loc / per, j = loc % per;
  const long long a0 = 2LL * p * s, c0 = a0 + s;
  const int sc = min(s, n - static_cast<int>(c0));   // C's rows
  if (TW * i >= sc) return;        // past the short last block
  const long long r = c0 + TW * i, c = a0 + TW * j;
  float acc[4][4] = {};
  if (!second) {                   // A⁻¹ is lower: k from 32j on
    const int k0 = TW * j;
    product(L + r * ldl + a0 + k0, ldl, sc - TW * i, W + (a0 + k0) * ldw + c,
            ldw, s - k0, sm, acc);
  } else {                         // C⁻¹ is lower: k up to 32(i + 1)
    product(W + r * ldw + c0, ldw, sc - TW * i, S + c0 * n + c, n,
            min(TW * (i + 1), sc), sm, acc);
  }
  auto R = reinterpret_cast<float (*)[TW][TW + 1]>(sm);   // [group][r][c]
  const int g = threadIdx.x / GT, q = threadIdx.x % GT;
  const int ty = q / 8, tx = q % 8;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) R[g][4 * ty + a][4 * tx + b] = acc[a][b];
  __syncthreads();
  float* const D = second ? W : S;
  const long long ldd = second ? ldw : n;
  const int cc = threadIdx.x % TW;
  for (int rr = threadIdx.x / TW; rr < TW; rr += NT / TW) {
    if (TW * i + rr < sc) {
      const float v = (R[0][rr][cc] + R[1][rr][cc]) +
                      (R[2][rr][cc] + R[3][rr][cc]);
      D[(r + rr) * ldd + c + cc] = second ? -v : v;
    }
    // the mirror: W[c + rr][r + cc], above the diagonal, outside C
    if (!second && TW * i + cc < sc) W[(c + rr) * ldw + r + cc] = 0.f;
  }
  __syncthreads();                 // sm is the next tile's
}

// The whole inversion: the leaves, then each level's two halves, a grid
// sync between phases (a cooperative launch), or with one block, one leaf
// and no sync.
__global__ void __launch_bounds__(NT)
trtri_block_f32_kernel(const float* __restrict__ L, long long ldl, float* W,
                       long long ldw, float* S, int n, int* info) {
  extern __shared__ __align__(16) float sm[];
  const int nleaf = (n + LW - 1) / LW;
  for (int t = blockIdx.x; t < nleaf; t += gridDim.x)
    ct::tleaf::leaf(L, ldl, W, ldw, n, t, sm, info);
  for (int s = LW; s < n; s *= 2) {
    const int tiles = pairs(n, s) * (s / TW) * (s / TW);
    for (int second = 0; second < 2; ++second) {
      cg::this_grid().sync();
      for (int t = blockIdx.x; t < tiles; t += gridDim.x)
        level_tile(L, ldl, W, ldw, S, n, s, t, second != 0, sm);
    }
  }
}

}  // namespace

CT_EXPORT int ct_trtri_block_f32(const float* L, long long ldl, float* W,
                                 long long ldw, float* S, int n, int* info,
                                 int device, void* stream) {
  if (n < 1 || n > MAX_N || ldl < n || ldw < n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(trtri_block_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  if (n <= LW) {                   // one leaf: one block, one phase
    trtri_block_f32_kernel<<<1, NT, LEAF_SMEM, st>>>(L, ldl, W, ldw, S, n,
                                                     info);
    return static_cast<int>(cudaGetLastError());
  }
  int has_coop = 0, nsm = 0;
  err = cudaDeviceGetAttribute(&has_coop, cudaDevAttrCooperativeLaunch,
                               device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!has_coop) return static_cast<int>(cudaErrorNotSupported);
  // one block an SM at most, as many as the widest phase has tiles: the
  // leaves, or the last level's
  int widest = (n + LW - 1) / LW;
  for (int s = LW; s < n; s *= 2)
    widest = std::max(widest, pairs(n, s) * (s / TW) * (s / TW));
  const int grid = std::min(widest, nsm);
  void* args[] = {&L, &ldl, &W, &ldw, &S, &n, &info};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(trtri_block_f32_kernel), dim3(grid), dim3(NT),
      args, SMEM, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
