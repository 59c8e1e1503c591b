// gemm_f32: D = alpha·A·B + beta·C in f32, for strided operands.
//
// Replaces cholesky_tpu/ops/pallas/gemm.py:matmul_f32 (_mm_kernel), the
// TPU's MXU GEMM at HIGHEST precision. On the main path it applies the
// inverse of each 512 leaf in the potrf panel solve (X = B·Tᵀ), makes
// the trsm update B2 -= X1·Mᵀ in place on a view of the working buffer,
// and carries the trtri and lauum recursions of the GP step's potri.
//
// What bounds it on the H100: plain FFMA (no TF32 tensor cores: the
// library's eps-scaled bounds need full f32 products), so at best the
// 67 TFLOP/s f32 vector rate, 2.05 ms at 4096³. What bounds a tile of
// FFMA is what feeds it: shared-memory loads per FFMA and the latency of
// the global loads.
//
// Design: one block per output tile, of one of two kinds chosen per launch
// by the wrapper (ops/kernels/gemm.py, launch_plan):
//   128 x 128 (sgemm128.cuh): 256 threads with 8 x 8 register micro-tiles
//     fed by 16-byte shared loads, the next k's ahead, from a 3-stage
//     cp.async ring of 16-deep k-steps. Each operand is staged along its
//     own unit-stride axis (a kernel per layout pair; a k-fast stage is
//     copied k-major in shared memory before the product), by 16-byte
//     copies where its base and leading stride sit on the 16-byte grid
//     and by 4-byte copies elsewhere. Blocks walk the output in groups of
//     eight row tiles, so those in flight share A's rows and B's columns
//     in L2; about 41 TF/s at 4096³ (H100, 700 W);
//   64 x 64 (sgemm_tile.cuh): 256 threads with 4 x 4 micro-tiles, for
//     grids too small to fill the card with the large tile.
// Row and column strides for every operand, so transposed views and
// slices of the working buffer cost no copy; ragged edges are zero-filled
// on load and masked on store. C may be the same memory as D: each
// element is read and then written by the one thread that owns it. A and
// B must not overlap D.
#include "sgemm128.cuh"
#include "sgemm_tile.cuh"

namespace {

// ---- the 64 x 64 tile
constexpr int BM = 64, BN = 64, BK = 16;
constexpr int NT = (BM / ct::TM) * (BN / ct::TN);

__global__ void __launch_bounds__(NT)
gemm64_kernel(const float* __restrict__ A, long long sa0, long long sa1,
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

// ---- the 128 x 128 tile. AKF: A is k-fast (sa1 = 1); BKF: Bᵀ is k-fast
// (sb0 = 1); VEC: both on the 16-byte grid.
constexpr int GROUP = 8;            // row tiles per group of the walk

template <bool AKF, bool BKF, bool VEC>
__global__ void __launch_bounds__(ct::t128::NT, 2)
gemm128_kernel(const float* __restrict__ A, long long sa0, long long sa1,
               const float* __restrict__ B, long long sb0, long long sb1,
               const float* C, long long sc0, long long sc1,
               float* D, long long sd0, long long sd1,
               int M, int N, int K, float alpha, float beta) {
  constexpr int E = ct::t128::BM;
  extern __shared__ __align__(16) float smem[];
  const int tm = (M + E - 1) / E, tn = (N + E - 1) / E;
  const int per_group = GROUP * tn;
  const int first = (blockIdx.x / per_group) * GROUP;
  const int rows_in = min(tm - first, GROUP);
  const int in = blockIdx.x % per_group;
  const int m0 = (first + in % rows_in) * E, n0 = (in / rows_in) * E;
  float acc[8][8] = {};
  ct::t128::tile_xyt<AKF, BKF, VEC>(A, sa0, sa1, m0, M, B, sb1, sb0, n0, N,
                                    K, smem, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + ct::t128::row_of(i);
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + ct::t128::col_of(j);
      if (c >= N) continue;
      float v = alpha * acc[i][j];
      if (beta != 0.f) v = fmaf(beta, C[r * sc0 + c * sc1], v);
      D[r * sd0 + c * sd1] = v;
    }
  }
}

using Kernel128 = void (*)(const float*, long long, long long, const float*,
                           long long, long long, const float*, long long,
                           long long, float*, long long, long long, int, int,
                           int, float, float);

template <bool AKF, bool BKF>
cudaError_t launch128(bool vec, dim3 grid, cudaStream_t stream,
                      void** args) {
  constexpr int bytes =
      ct::t128::smem_floats<AKF, BKF>() * static_cast<int>(sizeof(float));
  const Kernel128 k = vec ? gemm128_kernel<AKF, BKF, true>
                          : gemm128_kernel<AKF, BKF, false>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernel(reinterpret_cast<const void*>(k), grid,
                          dim3(ct::t128::NT), args, bytes, stream);
}

}  // namespace

CT_EXPORT int ct_gemm_f32(const float* A, long long sa0, long long sa1,
                          const float* B, long long sb0, long long sb1,
                          const float* C, long long sc0, long long sc1,
                          float* D, long long sd0, long long sd1,
                          int M, int N, int K, float alpha, float beta,
                          int tile, int a_kfast, int b_kfast, int vec,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == 64) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    gemm64_kernel<<<grid, NT, 0, s>>>(A, sa0, sa1, B, sb0, sb1, C, sc0, sc1,
                                      D, sd0, sd1, M, N, K, alpha, beta);
    return static_cast<int>(cudaGetLastError());
  }
  if (tile != 128) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int E = ct::t128::BM;
  const dim3 grid(((M + E - 1) / E) * ((N + E - 1) / E));
  void* args[] = {&A,  &sa0, &sa1, &B, &sb0, &sb1, &C,     &sc0, &sc1,
                  &D,  &sd0, &sd1, &M, &N,   &K,   &alpha, &beta};
  const bool v = vec != 0;
  err = a_kfast ? (b_kfast ? launch128<true, true>(v, grid, s, args)
                           : launch128<true, false>(v, grid, s, args))
                : (b_kfast ? launch128<false, true>(v, grid, s, args)
                           : launch128<false, false>(v, grid, s, args));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

CT_EXPORT const char* ct_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
