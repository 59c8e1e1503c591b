// Shared-memory SGEMM tile used by gemm.cu, syrk.cu, leaf.cu,
// trtri_stream.cu, potrf_stream.cu and lauum.cu.
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

// The card's global nanosecond clock, comparable across SMs.
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Lower-triangle tile t -> (i, j), j <= i, row-major over the triangle.
__device__ __forceinline__ void tri_tile(int t, int& i, int& j) {
  i = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while (i * (i + 1) / 2 > t) --i;
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  j = t - i * (i + 1) / 2;
}

// Stage rows [r0, r0 + R) x k [k0, k0 + BK) of a strided operand into
// S[k][r]. Consecutive threads walk the operand's unit-stride axis so the
// global loads coalesce in either layout. L2: load through L2 only
// (__ldcg), for operands other thread blocks of a cooperative launch wrote
// before its last grid sync, which a stale L1 line would hide.
template <int R, int BK, int NT, bool L2 = false>
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
    const float* p = X + gr * s_r + gk * s_k;
    S[k][r] = (gr < rows && gk < K) ? (L2 ? __ldcg(p) : *p) : 0.f;
  }
}

// acc[i][j] += Σ_k Xs[k][ty + i*BM/TM] · Ys[k][tx + j*BN/TN] over one staged
// k-step: the register micro-tile product of every kernel here.
template <int BM, int BN, int BK>
__device__ __forceinline__ void mma_staged(float (*Xs)[BM + 1],
                                           float (*Ys)[BN + 1],
                                           float (&acc)[TM][TN]) {
  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);
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
}

// acc[i][j] += Σ_k X[r0 + ty + i*BM/TM, k] · Y[c0 + tx + j*BN/TN, k] over the
// whole K range, staging through shared memory. Ends with a barrier, so the
// caller may reuse the shared slabs. L2 as in load_slab.
template <int BM, int BN, int BK, bool L2 = false>
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
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_slab<BM, BK, NT, L2>(X, sx_r, sx_k, r0, rows, k0, K, Xs);
    load_slab<BN, BK, NT, L2>(Y, sy_r, sy_k, c0, cols, k0, K, Ys);
    __syncthreads();
    mma_staged<BM, BN, BK>(Xs, Ys, acc);
    __syncthreads();
  }
}

// D[r0 + r, c0 + c] = alpha · acc for the thread's micro-tile of a full
// BM x BN tile (no edge masking: the caller's tiles lie inside D).
template <int BM, int BN>
__device__ __forceinline__ void store_tile(float* D, long long ldd, int r0,
                                           int c0, float alpha,
                                           const float (&acc)[TM][TN]) {
  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      D[(r0 + ty + i * (BM / TM)) * ldd + c0 + tx + j * (BN / TN)] =
          alpha * acc[i][j];
}

}  // namespace ct
