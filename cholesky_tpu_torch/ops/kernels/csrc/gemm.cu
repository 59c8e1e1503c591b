// gemm_f32: D = alpha·A·B + beta·C in f32, for strided operands.
//
// Replaces cholesky_tpu/ops/pallas/gemm.py:matmul_f32 (_mm_kernel), the
// TPU's MXU GEMM at HIGHEST precision. On the main path it applies the
// inverse of each 512 leaf in the potrf panel solve (X = B·Tᵀ) and makes
// the trsm update B2 -= X1·Mᵀ in place on a view of the working buffer.
//
// What bounds it on the H100: plain FFMA (no TF32 tensor cores: the
// library's eps-scaled bounds need full f32 products), so at best the
// 67 TFLOP/s f32 vector rate; in this simple form the shared-memory loads
// of the micro-tile loop (8 LDS per 16 FFMA) come first.
//
// Design: one block per BM x BN output tile (64 x 64, 256 threads, 4 x 4
// register micro-tiles), a BK-deep (16) k-step staged through shared
// memory, row and column strides for every operand so transposed views
// and slices of the working buffer cost no copy, ragged edges masked in
// place of the TPU wrapper's padding. C may be the same memory as D: each
// element is read and then written by the one thread that owns it. A and
// B must not overlap D.
#include "sgemm_tile.cuh"

#ifndef GEMM_BM
#define GEMM_BM 64
#endif
#ifndef GEMM_BN
#define GEMM_BN 64
#endif
#ifndef GEMM_BK
#define GEMM_BK 16
#endif

namespace {

constexpr int BM = GEMM_BM, BN = GEMM_BN, BK = GEMM_BK;
constexpr int NT = (BM / ct::TM) * (BN / ct::TN);

__global__ void __launch_bounds__(NT)
gemm_f32_kernel(const float* __restrict__ A, long long sa0, long long sa1,
                const float* __restrict__ B, long long sb0, long long sb1,
                const float* C, long long sc0, long long sc1,
                float* D, long long sd0, long long sd1,
                int M, int N, int K, float alpha, float beta) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[ct::TM][ct::TN] = {};
  // A·B = A·(Bᵀ)ᵀ: Bᵀ is the (N x K) operand with strides (sb1, sb0)
  ct::tile_xyt<BM, BN, BK>(A, sa0, sa1, m0, M, B, sb1, sb0, n0, N, K,
                           As, Bs, acc);
  const int tx = threadIdx.x % (BN / ct::TN);
  const int ty = threadIdx.x / (BN / ct::TN);
#pragma unroll
  for (int i = 0; i < ct::TM; ++i) {
    const int r = m0 + ty + i * (BM / ct::TM);
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < ct::TN; ++j) {
      const int c = n0 + tx + j * (BN / ct::TN);
      if (c >= N) continue;
      float v = alpha * acc[i][j];
      if (beta != 0.f) v = fmaf(beta, C[r * sc0 + c * sc1], v);
      D[r * sd0 + c * sd1] = v;
    }
  }
}

}  // namespace

CT_EXPORT int ct_gemm_f32(const float* A, long long sa0, long long sa1,
                          const float* B, long long sb0, long long sb1,
                          const float* C, long long sc0, long long sc1,
                          float* D, long long sd0, long long sd1,
                          int M, int N, int K, float alpha, float beta,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_f32_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      A, sa0, sa1, B, sb0, sb1, C, sc0, sc1, D, sd0, sd1, M, N, K, alpha,
      beta);
  return static_cast<int>(cudaGetLastError());
}

CT_EXPORT const char* ct_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
