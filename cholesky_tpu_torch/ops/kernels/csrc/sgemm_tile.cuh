// Shared-memory SGEMM tile used by gemm.cu and syrk.cu.
//
// One thread block computes a BM x BN tile of X·Yᵀ, where X (rows x K) and
// Y (cols x K) are strided operands: element (r, k) lives at
// p[r * s_r + k * s_k]. Transposes and slice views are therefore only
// strides; nothing is copied. Each k-step stages a BM x BK slab of X and a
// BN x BK slab of Y in shared memory (k-major, one padding column against
// bank conflicts); each thread accumulates a TM x TN register micro-tile in
// plain f32 FFMA. Ragged edges are zero-filled on load and masked on store.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define CT_EXPORT extern "C" __attribute__((visibility("default")))

namespace ct {

constexpr int TM = 4;  // micro-tile rows per thread
constexpr int TN = 4;  // micro-tile cols per thread

// Lower-triangle tile t -> (i, j), j <= i, row-major over the triangle.
__device__ __forceinline__ void tri_tile(int t, int& i, int& j) {
  i = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while (i * (i + 1) / 2 > t) --i;
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  j = t - i * (i + 1) / 2;
}

// Stage rows [r0, r0 + R) x k [k0, k0 + BK) of a strided operand into
// S[k][r]. Consecutive threads walk the operand's unit-stride axis so the
// global loads coalesce in either layout.
template <int R, int BK, int NT>
__device__ __forceinline__ void load_slab(const float* __restrict__ X,
                                          long long s_r, long long s_k,
                                          int r0, int rows, int k0, int K,
                                          float (*S)[R + 1]) {
  const bool k_fast = (s_k == 1);
  for (int idx = threadIdx.x; idx < R * BK; idx += NT) {
    int r, k;
    if (k_fast) {
      k = idx % BK;
      r = idx / BK;
    } else {
      r = idx % R;
      k = idx / R;
    }
    const int gr = r0 + r, gk = k0 + k;
    S[k][r] = (gr < rows && gk < K) ? X[gr * s_r + gk * s_k] : 0.f;
  }
}

// acc[i][j] += Σ_k X[r0 + ty + i*BM/TM, k] · Y[c0 + tx + j*BN/TN, k] over the
// whole K range, staging through shared memory. Ends with a barrier, so the
// caller may reuse the shared slabs.
template <int BM, int BN, int BK>
__device__ __forceinline__ void tile_xyt(const float* __restrict__ X,
                                         long long sx_r, long long sx_k,
                                         int r0, int rows,
                                         const float* __restrict__ Y,
                                         long long sy_r, long long sy_k,
                                         int c0, int cols, int K,
                                         float (*Xs)[BM + 1],
                                         float (*Ys)[BN + 1],
                                         float (&acc)[TM][TN]) {
  constexpr int NT = (BM / TM) * (BN / TN);
  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_slab<BM, BK, NT>(X, sx_r, sx_k, r0, rows, k0, K, Xs);
    load_slab<BN, BK, NT>(Y, sy_r, sy_k, c0, cols, k0, K, Ys);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = Xs[k][ty + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Ys[k][tx + j * (BN / TN)];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace ct
