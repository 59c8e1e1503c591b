// potrf_block_f32: lower Cholesky of one n <= 1024 block, in place.
//
// Replaces cholesky_tpu/ops/pallas/mega.py:potrf_vmem_f32
// (_potrf_vmem_kernel with _chol_tile_grouped, _chol_tile_rows and
// _newton_uinv). On the main path it factors the whole matrix for
// n <= 1024 and every diagonal block of the blocked recursion.
//
// Contract: only the lower triangle is read; the strict upper is zeroed.
// info is the 1-based index of the first pivot with !(d > 0), NaN-safe.
// The factorization freezes at a failed pivot: the panel holding it stores
// only its diagonal tile, and nothing after it is updated, so every stored
// value stays finite except an input NaN at its own position.
//
// What bounds it on the H100: the TPU kernel kept the whole block in its
// 16 MB VMEM; a 1024^2 f32 block is 4 MB, far over the 227 KB of shared
// memory one block can use. Here the block stays in device memory (it
// fits in the 50 MB L2) and ONE thread block of 1024 threads runs the
// whole factorization, so a single SM's FFMA rate and shared-memory
// bandwidth bound it; the trailing updates are ~n^3/3 of its flops.
//
// Design: right-looking over 32-wide panels. Each panel (all rows below
// the diagonal, at most 1024 x 32 f32 = 128 KB) is staged in shared
// memory; warp 0 factors its 32 x 32 diagonal tile column by column (warp
// barriers only); every thread then solves one row below the tile against
// the tile by forward substitution; the panel is stored; the four 256-
// thread teams update the lower 64 x 64 tiles of the trailing matrix from
// the staged panel. The TPU wrapper's symmetrize-then-transpose and the
// Newton tile inverse existed to feed the MXU and are not carried over.
#include "sgemm_tile.cuh"

namespace {

constexpr int W = 32;         // panel width: one warp owns the tile rows
constexpr int NT = 1024;      // threads of the one block
constexpr int MAX_N = 1024;
constexpr int TT = 64;        // trailing-update tile edge
constexpr int TEAM = 256;     // threads per trailing tile (16 x 16, 4 x 4)

__global__ void __launch_bounds__(NT)
potrf_block_f32_kernel(float* A, long long lda, int n, int* info) {
  // P[k * ldp + i] = panel element (row c0 + i, column c0 + k); ldp is odd
  // so the 32 columns of one row fall in 32 different banks
  extern __shared__ float P[];
  __shared__ int s_fail;
  const int tid = threadIdx.x;
  const int ldp = n | 1;
  if (tid == 0) s_fail = 0;
  __syncthreads();

  for (int c0 = 0; c0 < n; c0 += W) {
    const int w = min(W, n - c0);
    const int rows = n - c0;
    float* const Ac = A + c0 * lda + c0;

    // 1. stage the panel's lower part (the tile's strict upper is not read)
    for (int idx = tid; idx < rows * w; idx += NT) {
      const int k = idx % w, i = idx / w;
      P[k * ldp + i] = (i >= k) ? Ac[i * lda + k] : 0.f;
    }
    __syncthreads();

    // 2. warp 0 factors the w x w diagonal tile; lane l owns tile row l
    if (tid < 32) {
      const int l = tid;
      for (int k = 0; k < w; ++k) {
        const float d2 = P[k * ldp + k];
        if (!(d2 > 0.f)) {            // NaN-safe; the same for every lane
          if (l == 0) s_fail = c0 + k + 1;
          break;
        }
        const float d = sqrtf(d2);
        __syncwarp();
        if (l == k) {
          P[k * ldp + k] = d;
        } else if (l > k && l < w) {
          P[k * ldp + l] /= d;
        }
        __syncwarp();
        if (l > k && l < w) {         // T[l][j] -= T[l][k]·T[j][k]
          const float tlk = P[k * ldp + l];
          for (int j = k + 1; j <= l; ++j)
            P[j * ldp + l] = fmaf(-tlk, P[k * ldp + j], P[j * ldp + l]);
        }
        __syncwarp();
      }
    }
    __syncthreads();
    const int fail = s_fail;

    // 3. panel solve: each row x below the tile solves x·Tᵀ = a
    if (!fail) {
      for (int i = w + tid; i < rows; i += NT) {
        for (int k = 0; k < w; ++k) {
          float s = P[k * ldp + i];
          for (int m = 0; m < k; ++m)
            s = fmaf(-P[m * ldp + i], P[m * ldp + k], s);
          P[k * ldp + i] = s / P[k * ldp + k];
        }
      }
      __syncthreads();
    }

    // 4. store the panel; after a failed pivot only its diagonal tile
    const int srows = fail ? w : rows;
    for (int idx = tid; idx < srows * w; idx += NT) {
      const int k = idx % w, i = idx / w;
      if (i >= k) Ac[i * lda + k] = P[k * ldp + i];
    }
    if (fail) break;

    // 5. trailing update of the lower triangle: A22 -= P2·P2ᵀ
    const int m = rows - w;
    if (m > 0) {
      float* const A22 = Ac + w * lda + w;
      const float* const P2 = P + w;
      const int nt = (m + TT - 1) / TT;
      const int ntiles = nt * (nt + 1) / 2;
      const int lt = tid % TEAM;
      const int tx = lt % (TT / ct::TN), ty = lt / (TT / ct::TN);
      for (int t = tid / TEAM; t < ntiles; t += NT / TEAM) {
        int bi, bj;
        ct::tri_tile(t, bi, bj);
        int ri[ct::TM], ci[ct::TN];
#pragma unroll
        for (int i = 0; i < ct::TM; ++i)
          ri[i] = min(bi * TT + ty + i * (TT / ct::TM), m - 1);
#pragma unroll
        for (int j = 0; j < ct::TN; ++j)
          ci[j] = min(bj * TT + tx + j * (TT / ct::TN), m - 1);
        float acc[ct::TM][ct::TN] = {};
        for (int k = 0; k < w; ++k) {
          const float* pk = P2 + k * ldp;
          float a[ct::TM], b[ct::TN];
#pragma unroll
          for (int i = 0; i < ct::TM; ++i) a[i] = pk[ri[i]];
#pragma unroll
          for (int j = 0; j < ct::TN; ++j) b[j] = pk[ci[j]];
#pragma unroll
          for (int i = 0; i < ct::TM; ++i)
#pragma unroll
            for (int j = 0; j < ct::TN; ++j)
              acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < ct::TM; ++i) {
          const int r = bi * TT + ty + i * (TT / ct::TM);
#pragma unroll
          for (int j = 0; j < ct::TN; ++j) {
            const int c = bj * TT + tx + j * (TT / ct::TN);
            if (r < m && c <= r) A22[r * lda + c] -= acc[i][j];
          }
        }
      }
    }
    __syncthreads();
  }

  // exact zeros in the strict upper triangle; warp q clears rows q, q+32, ..
  const int lane = tid % 32;
  for (int i = tid / 32; i < n; i += NT / 32)
    for (int j = i + 1 + lane; j < n; j += 32) A[i * lda + j] = 0.f;
  if (tid == 0) *info = s_fail;
}

}  // namespace

CT_EXPORT int ct_potrf_block_f32(float* A, long long lda, int n, int* info,
                                 int device, void* stream) {
  if (n < 1 || n > MAX_N || lda < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(float)) * W * (n | 1);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      potrf_block_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  potrf_block_f32_kernel<<<1, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      A, lda, n, info);
  return static_cast<int>(cudaGetLastError());
}
