// trmm_lln_f32: C = alpha·tril(L)·B in f32, L n x n, B n x m, strided.
//
// Replaces cholesky_tpu/ops/pallas/trmm.py:trmm_lln_f32 (_trmm_kernel),
// the live-tile TRMM onto which the public trmm canonicalizes all 16
// side/uplo/trans/diag combinations (ops/blocked.py _trmm_left_f32). Only
// the lower triangle of L is read, so a caller passes the triangle it
// holds without a masked copy. With `unit` its diagonal is not read: the
// product runs over the strict lower and B itself is added at the end. An
// upper triangle comes as the reversed views of the double reversal
// (kernels/trmm.py): pointers to the last rows and negated strides, which
// the signed stride arithmetic here takes as they are.
//
// What bounds it on the H100: n(n+1)m/2 FFMA (2.75e11 at n = m = 8192,
// 8.2 ms at the 67 TFLOP/s f32 vector rate; the bytes take 0.2 ms). Full
// f32 products, no TF32: the library's eps-scaled bounds need them. What
// bounds a tile of FFMA is shared-memory traffic per FFMA, so the tile is
// larger than sgemm_tile.cuh's: 128 x 128 per block, an 8 x 8 register
// micro-tile per thread read as four 16-byte shared loads per 64 FFMA
// (sgemm_tile.cuh's 4 x 4 takes eight 4-byte loads per 16).
//
// Design: one block of 256 threads per 128 x 128 output tile. The TPU grid
// enumerated the nt(nt+1)/2 live (row block, k block) pairs through scalar
// prefetch; here each output tile loops k only up to the end of its own
// row block, so the dead upper blocks of L are never read, and the
// triangle inside the diagonal block is masked as it is staged. Row tiles
// are launched heaviest first (the bottom ones run the longest k loops),
// which shortens the tail. The next k-step's slabs are fetched into
// registers while the current one is multiplied, into the other of two
// shared buffers, so one barrier per k-step suffices. Strided L and B
// (transposed views, slices) cost no copy: each slab is fetched along the
// operand's unit-stride axis (stride +1 or -1); ragged edges are masked
// instead of padded. The sign of each operand's unit stride is a template
// constant (four kernels): with a run-time sign the kernel ran slower on
// the H100 (PERF.md, section 6).
#include <cstdint>

#include "sgemm_tile.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 8;
constexpr int NT = 256;                 // a 16 x 16 grid of 8 x 8 micro-tiles
constexpr int LDS = BM + 4;             // shared row stride: 16-byte rows,
                                        // conflict-free k-fast staging
constexpr int PER = BM * BK / NT;       // slab elements per thread (4)
static_assert(BM == BN, "one staging routine serves both operands");

// This thread's PER elements of rows [r0, r0 + BM) x k [k0, k0 + BK) of a
// strided operand X (element (r, k) at X[r·s_r + k·s_k]), zero outside
// rows x K and, with LOWER, above the diagonal (k > r) or, with unit = 1,
// on it. k_fast: s_k == SGN (+1 or -1), so consecutive threads walk k;
// else they walk r.
template <bool LOWER, int SGN>
__device__ __forceinline__ void fetch(const float* __restrict__ X,
                                      long long s_r, long long s_k, int r0,
                                      int rows, int k0, int K, bool k_fast,
                                      int unit, float (&v)[PER]) {
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int r = k_fast ? idx / BK : idx % BM;
    const int k = k_fast ? idx % BK : idx / BM;
    const int gr = r0 + r, gk = k0 + k;
    const bool live = gr < rows && gk < K && (!LOWER || gk + unit <= gr);
    v[i] = !live    ? 0.f
           : k_fast ? X[gr * s_r + SGN * gk]
                    : X[gr * s_r + gk * s_k];
  }
}

// The fetched elements into the k-major shared slab S[k·LDS + r].
__device__ __forceinline__ void stash(float* S, bool k_fast,
                                      const float (&v)[PER]) {
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int r = k_fast ? idx / BK : idx % BM;
    const int k = k_fast ? idx % BK : idx / BM;
    S[k * LDS + r] = v[i];
  }
}

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  out[0] = q.x;
  out[1] = q.y;
  out[2] = q.z;
  out[3] = q.w;
}

// LS, BS: the sign of L's k stride and of B's row stride where it is the
// unit one.
template <int LS, int BS>
__global__ void __launch_bounds__(NT, 2)
trmm_lln_f32_kernel(const float* __restrict__ L, long long sl0,
                    long long sl1, const float* __restrict__ B,
                    long long sb0, long long sb1, float* __restrict__ C,
                    long long ldc, int n, int m, float alpha, int unit) {
  __shared__ __align__(16) float As[2][BK * LDS];
  __shared__ __align__(16) float Bs[2][BK * LDS];
  const int r0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int c0 = blockIdx.x * BN;
  const int K = min(r0 + BM, n);       // L[r][k] = 0 for k > r
  // L(r, k) has strides (sl0, sl1); Bᵀ(c, k) = B[k][c] has (sb1, sb0)
  const bool l_kfast = (sl1 == LS), b_kfast = (sb0 == BS);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[8][8] = {};
  float va[PER], vb[PER];
  fetch<true, LS>(L, sl0, sl1, r0, n, 0, K, l_kfast, unit, va);
  fetch<false, BS>(B, sb1, sb0, c0, m, 0, K, b_kfast, 0, vb);
  stash(As[0], l_kfast, va);
  stash(Bs[0], b_kfast, vb);
  __syncthreads();

  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) {
      fetch<true, LS>(L, sl0, sl1, r0, n, k0 + BK, K, l_kfast, unit, va);
      fetch<false, BS>(B, sb1, sb0, c0, m, k0 + BK, K, b_kfast, 0, vb);
    }
    const float* const a_s = As[buf];
    const float* const b_s = Bs[buf];
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      // rows ty·4 + {0..3} and 64 + ty·4 + {0..3}; the same for columns
      float a[8], b[8];
      load4(a_s + k * LDS + ty * 4, a);
      load4(a_s + k * LDS + 64 + ty * 4, a + 4);
      load4(b_s + k * LDS + tx * 4, b);
      load4(b_s + k * LDS + 64 + tx * 4, b + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      // the other buffer was last read before the previous barrier
      stash(As[buf ^ 1], l_kfast, va);
      stash(Bs[buf ^ 1], b_kfast, vb);
    }
    __syncthreads();
    buf ^= 1;
  }

  if (unit) {  // T = strict lower + I: the identity's part is B itself
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = r0 + (i / 4) * 64 + ty * 4 + i % 4;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + (j / 4) * 64 + tx * 4 + j % 4;
        if (r < n && c < m) acc[i][j] += B[r * sb0 + c * sb1];
      }
    }
  }
  const bool vec =
      ((reinterpret_cast<std::uintptr_t>(C) | (ldc * 4)) & 15) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (r >= n) continue;
    float* const row = C + r * ldc;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + h * 64 + tx * 4;
      if (vec && c + 3 < m) {
        *reinterpret_cast<float4*>(row + c) =
            make_float4(alpha * acc[i][h * 4], alpha * acc[i][h * 4 + 1],
                        alpha * acc[i][h * 4 + 2], alpha * acc[i][h * 4 + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < m) row[c + j] = alpha * acc[i][h * 4 + j];
      }
    }
  }
}

}  // namespace

CT_EXPORT int ct_trmm_lln_f32(const float* L, long long sl0, long long sl1,
                              const float* B, long long sb0, long long sb1,
                              float* C, long long ldc, int n, int m,
                              float alpha, int unit, int device,
                              void* stream) {
  if (n < 1 || m < 1 || (ldc < m && -ldc < m))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((m + BN - 1) / BN, (n + BM - 1) / BM);
  using Kernel = void (*)(const float*, long long, long long, const float*,
                          long long, long long, float*, long long, int, int,
                          float, int);
  const Kernel kernels[4] = {
      trmm_lln_f32_kernel<1, 1>, trmm_lln_f32_kernel<1, -1>,
      trmm_lln_f32_kernel<-1, 1>, trmm_lln_f32_kernel<-1, -1>};
  const Kernel kernel = kernels[(sl1 == -1 ? 2 : 0) + (sb0 == -1 ? 1 : 0)];
  kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      L, sl0, sl1, B, sb0, sb1, C, ldc, n, m, alpha, unit);
  return static_cast<int>(cudaGetLastError());
}
