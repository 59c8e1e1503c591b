// trtri_block_f32: inverse of a lower-triangular n <= 1024 block.
//
// Replaces cholesky_tpu/ops/pallas/mega.py:trtri_vmem_f32
// (_trtri_vmem_kernel with _utri_diag_info and _newton_uinv). On the main
// path it inverts each 512 leaf of the potrf panel solve, whose product
// with the panel (gemm.cu) then replaces a triangular solve.
//
// Contract: only the lower triangle of L is read; the output is a separate
// buffer whose strict upper is zero. A zero diagonal entry is treated as
// 1 and does not stop the inversion, so the output stays finite; info is
// the 1-based index of the first (smallest) zero diagonal, as LAPACK's
// strtri reports it.
//
// What bounds it on the H100: n^3/6 FFMA with a sequential dependency down
// each column. The TPU kernel turned the substitutions into Newton
// iterations to feed its MXU; here the columns are independent, so blocks
// of 32 columns run on as many SMs, and the longest column stripe (the
// first) sets the time.
//
// Design: block b solves L·w_j = e_j for the 32 columns j of its stripe
// by blocked forward substitution over 32-row chunks. Thread (r, c) of the
// 32 x 32 block owns row r of the chunk and column c: it accumulates the
// product of the chunk's rows of L (staged in shared memory, 32 columns
// at a time, read from L2) with the rows already solved (kept in shared
// memory, at most 1024 x 32 f32 = 128 KB), then the chunk's own 32 x 32
// triangle is eliminated one row per barrier, column-oriented.
#include "sgemm_tile.cuh"

namespace {

constexpr int G = 32;          // columns per block
constexpr int R = 32;          // rows per chunk
constexpr int NT = G * R;      // thread (r, c) = (tid / G, tid % G)
constexpr int MAX_N = 1024;

__global__ void __launch_bounds__(NT)
trtri_block_f32_kernel(const float* __restrict__ L, long long ldl,
                       float* __restrict__ Wout, long long ldw, int n,
                       int* info) {
  // Wp[(i - j0) * G + c] = W[i][j0 + c] for the rows i >= j0 solved so far
  extern __shared__ float Wp[];
  __shared__ float Lt[R][R + 1];
  __shared__ int s_first;
  const int tid = threadIdx.x;
  const int r = tid / G, c = tid % G;
  const int j0 = blockIdx.x * G;

  if (blockIdx.x == 0) {               // info: the first zero diagonal
    if (tid == 0) s_first = n;
    __syncthreads();
    for (int i = tid; i < n; i += NT)
      if (L[i * ldl + i] == 0.f) atomicMin(&s_first, i);
    __syncthreads();
    if (tid == 0) *info = (s_first < n) ? s_first + 1 : 0;
  }

  for (int r0 = j0; r0 < n; r0 += R) {
    const int q = r0 - j0;             // panel row of the chunk's first row
    // right-hand side of row r0 + r: e_j - L[r0 + r, j0:r0]·W[j0:r0, j]
    float x = (r0 + r == j0 + c) ? 1.f : 0.f;
    for (int m0 = j0; m0 < r0; m0 += R) {
      Lt[r][c] = (r0 + r < n) ? L[(r0 + r) * ldl + m0 + c] : 0.f;
      __syncthreads();
#pragma unroll 8
      for (int mm = 0; mm < R; ++mm)
        x = fmaf(-Lt[r][mm], Wp[(m0 - j0 + mm) * G + c], x);
      __syncthreads();
    }
    // the chunk's diagonal triangle; a zero pivot and rows past n read 1
    float v = (c == r) ? 1.f : 0.f;
    if (r0 + r < n && c <= r) v = L[(r0 + r) * ldl + r0 + c];
    if (c == r && v == 0.f) v = 1.f;
    Lt[r][c] = v;
    __syncthreads();
    // column-oriented elimination: row rr is final once rows < rr are
    for (int rr = 0; rr < R; ++rr) {
      if (r == rr) {
        x /= Lt[rr][rr];
        Wp[(q + rr) * G + c] = x;
      }
      __syncthreads();
      if (r > rr) x = fmaf(-Lt[r][rr], Wp[(q + rr) * G + c], x);
    }
  }

  // store the stripe: zeros above row j0, the solved rows below
  const int ncols = min(G, n - j0);
  for (int idx = tid; idx < n * G; idx += NT) {
    const int i = idx / G, cc = idx % G;
    if (cc < ncols)
      Wout[i * ldw + j0 + cc] = (i < j0) ? 0.f : Wp[(i - j0) * G + cc];
  }
}

}  // namespace

CT_EXPORT int ct_trtri_block_f32(const float* L, long long ldl, float* W,
                                 long long ldw, int n, int* info,
                                 int device, void* stream) {
  if (n < 1 || n > MAX_N || ldl < n || ldw < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem =
      static_cast<int>(sizeof(float)) * ((n + R - 1) / R) * R * G;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      trtri_block_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  trtri_block_f32_kernel<<<(n + G - 1) / G, NT, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      L, ldl, W, ldw, n, info);
  return static_cast<int>(cudaGetLastError());
}
