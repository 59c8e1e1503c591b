// lauum_stream_f32 and lauu2_f32: B = tril(Lᵀ·L) from the lower triangle of
// L, out of place.
//
// Replaces cholesky_tpu/ops/pallas/mega.py:lauum_hbm_f32
// (_lauum_hbm_kernel, n % 128 == 0, n <= 8192) and
// cholesky_tpu/ops/pallas/leaf.py:lauu2_f32 (_lauu2_kernel, one leaf, whose
// strict upper passes the input through). On the GP model's train step the
// first is potri's lauum at n = 4096 and 8192; the second is each leaf of
// the lauum recursion when a block size is given, of any n (a complex
// lauum runs at twice its dimension through the real embedding).
//
// What bounds it on the H100: n^3/6 FFMA (92 G at n = 8192) in plain f32,
// as gemm.cu. The TPU kernel walked 128-row panels top-down, in place, with
// a k-stream of the rows below each panel. On the card the output tiles are
// independent, B[I, J] = Σ_{K >= I} L[K, I]ᵀ·L[K, J] for I >= J, so every
// lower tile is its own thread block and all SMs work at once; in place,
// a tile's store would race with other tiles' reads of L, so the result
// goes to a separate buffer.
//
// Design: one 256-thread block per 64 x 64 tile of B, decoded from
// blockIdx.x the way syrk.cu does it: the lower tiles first (row-major over
// the triangle, so the tiles with the longest k-loop start first), then
// the strict-upper tiles. A lower tile runs the shared-memory SGEMM loop
// of sgemm_tile.cuh over k from its own first row (the rows above are zero
// in L, which halves the flops), with loads masked to the lower triangle
// of L: the strict upper is never read. Strict-upper elements of B are
// zero (lauum_stream) or the input's, bit for bit (lauu2: PASS_UPPER).
#include "sgemm_tile.cuh"

namespace {

constexpr int BT = 64;
constexpr int BK = 16;
constexpr int NT = (BT / ct::TM) * (BT / ct::TN);   // 256 threads
constexpr int STREAM_MAX_N = 8192;

// S[k][r] = L[k0 + k][r0 + r], zero outside the lower triangle and outside
// n. Row-major L: consecutive threads walk r, the unit-stride axis.
__device__ __forceinline__ void slab_lower(const float* __restrict__ L,
                                           long long ldl, int n, int r0,
                                           int k0, float (*S)[BT + 1]) {
  for (int idx = threadIdx.x; idx < BT * BK; idx += NT) {
    const int r = idx % BT, k = idx / BT;
    const int gr = r0 + r, gk = k0 + k;
    S[k][r] = (gr < n && gk < n && gk >= gr) ? L[gk * ldl + gr] : 0.f;
  }
}

template <bool PASS_UPPER>
__global__ void __launch_bounds__(NT)
lauum_f32_kernel(const float* __restrict__ L, long long ldl,
                 float* __restrict__ B, long long ldb, int n) {
  __shared__ float Xs[BK][BT + 1];
  __shared__ float Ys[BK][BT + 1];
  const int nt = (n + BT - 1) / BT;
  const int ntri = nt * (nt + 1) / 2;
  const int tx = threadIdx.x % (BT / ct::TN);
  const int ty = threadIdx.x / (BT / ct::TN);
  int ti, tj;
  if (static_cast<int>(blockIdx.x) >= ntri) {
    // a strict-upper tile (row a, column b + 1 > a): zeros or the input
    ct::tri_tile(blockIdx.x - ntri, ti, tj);
    const int r0 = tj * BT, c0 = (ti + 1) * BT;
    for (int idx = threadIdx.x; idx < BT * BT; idx += NT) {
      const int r = r0 + idx / BT, c = c0 + idx % BT;
      if (r < n && c < n)
        B[r * ldb + c] = PASS_UPPER ? L[r * ldl + c] : 0.f;
    }
    return;
  }
  ct::tri_tile(blockIdx.x, ti, tj);
  const int r0 = ti * BT, c0 = tj * BT;
  float acc[ct::TM][ct::TN] = {};
  for (int k0 = r0; k0 < n; k0 += BK) {
    slab_lower(L, ldl, n, r0, k0, Xs);
    slab_lower(L, ldl, n, c0, k0, Ys);
    __syncthreads();
    ct::mma_staged<BT, BT, BK>(Xs, Ys, acc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < ct::TM; ++i) {
    const int r = r0 + ty + i * (BT / ct::TM);
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < ct::TN; ++j) {
      const int c = c0 + tx + j * (BT / ct::TN);
      if (c >= n) continue;
      float v = acc[i][j];
      if (c > r) v = PASS_UPPER ? L[r * ldl + c] : 0.f;  // diagonal tiles
      B[r * ldb + c] = v;
    }
  }
}

template <bool PASS_UPPER>
int launch(const float* L, long long ldl, float* B, long long ldb, int n,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nt = (n + BT - 1) / BT;
  if (nt * nt > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  lauum_f32_kernel<PASS_UPPER>
      <<<static_cast<unsigned>(nt * nt), NT, 0,
         static_cast<cudaStream_t>(stream)>>>(L, ldl, B, ldb, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

CT_EXPORT int ct_lauum_stream_f32(const float* L, long long ldl, float* B,
                                  long long ldb, int n, int device,
                                  void* stream) {
  if (n < 128 || n > STREAM_MAX_N || n % 128 != 0 || ldl < n || ldb < n)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<false>(L, ldl, B, ldb, n, device, stream);
}

CT_EXPORT int ct_lauu2_f32(const float* L, long long ldl, float* B,
                           long long ldb, int n, int device, void* stream) {
  if (n < 1 || ldl < n || ldb < n)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(L, ldl, B, ldb, n, device, stream);
}
