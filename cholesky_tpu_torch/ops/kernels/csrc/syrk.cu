// syrk_lower_f32: C := alpha·A·Aᵀ + beta·C on the lower triangle, in place.
//
// Replaces cholesky_tpu/ops/pallas/syrk.py:syrk_f32 (_syrk_kernel), the
// trailing update A22 -= L21·L21ᵀ of the blocked potrf recursion. The TPU
// kernel walks a scalar-prefetched list of lower tiles and aliases C into
// its output so the strict upper survives; here the strict upper of C is
// simply never written.
//
// What bounds it on the H100: plain f32 FFMA, as gemm.cu, with half the
// products of a full GEMM because only the nt(nt+1)/2 lower tiles are
// launched.
//
// Design: one block per lower BN x BN tile of C; the block decodes its own
// tile (i, j), i >= j, from blockIdx.x (the Hopper form of scalar
// prefetch) and runs the shared SGEMM tile (sgemm_tile.cuh) on row blocks
// i and j of A. Diagonal tiles store only their lower triangle. A and C
// are strided (views of the working buffer); A must not overlap C.
#include "sgemm_tile.cuh"

#ifndef SYRK_BN
#define SYRK_BN 64
#endif
#ifndef SYRK_BK
#define SYRK_BK 16
#endif

namespace {

constexpr int BN = SYRK_BN, BK = SYRK_BK;
constexpr int NT = (BN / ct::TM) * (BN / ct::TN);

__global__ void __launch_bounds__(NT)
syrk_lower_f32_kernel(const float* __restrict__ A, long long sa0,
                      long long sa1, float* C, long long sc0, long long sc1,
                      int N, int K, float alpha, float beta) {
  __shared__ float Xs[BK][BN + 1];
  __shared__ float Ys[BK][BN + 1];
  int ti, tj;
  ct::tri_tile(blockIdx.x, ti, tj);
  const int r0 = ti * BN, c0 = tj * BN;
  float acc[ct::TM][ct::TN] = {};
  ct::tile_xyt<BN, BN, BK>(A, sa0, sa1, r0, N, A, sa0, sa1, c0, N, K, Xs,
                           Ys, acc);
  const int tx = threadIdx.x % (BN / ct::TN);
  const int ty = threadIdx.x / (BN / ct::TN);
#pragma unroll
  for (int i = 0; i < ct::TM; ++i) {
    const int r = r0 + ty + i * (BN / ct::TM);
    if (r >= N) continue;
#pragma unroll
    for (int j = 0; j < ct::TN; ++j) {
      const int c = c0 + tx + j * (BN / ct::TN);
      if (c > r) continue;  // strict upper (only on diagonal tiles)
      float v = alpha * acc[i][j];
      if (beta != 0.f) v = fmaf(beta, C[r * sc0 + c * sc1], v);
      C[r * sc0 + c * sc1] = v;
    }
  }
}

}  // namespace

CT_EXPORT int ct_syrk_lower_f32(const float* A, long long sa0, long long sa1,
                                float* C, long long sc0, long long sc1,
                                int N, int K, float alpha, float beta,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = (N + BN - 1) / BN;
  const int tiles = nt * (nt + 1) / 2;
  syrk_lower_f32_kernel<<<tiles, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      A, sa0, sa1, C, sc0, sc1, N, K, alpha, beta);
  return static_cast<int>(cudaGetLastError());
}
