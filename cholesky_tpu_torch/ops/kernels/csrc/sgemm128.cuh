// The 128 x 128 shared-memory FFMA tile for Hopper, used by gemm.cu and
// potrf_stream.cu.
//
// One block of 256 threads accumulates a 128 x 128 tile of X·Yᵀ in plain
// f32 FFMA, X (rows x K) and Y (cols x K) strided operands: element (r, k)
// at p[r·s_r + k·s_k]. Each thread holds an 8 x 8 register micro-tile;
// the eight warps are 2 x 4 warp tiles of 64 x 32, a warp's lanes 8 x 4,
// each lane rows 4l..4l+3 and 32 + 4l..32 + 4l + 3 of its warp tile (and
// the same for columns, 16 apart).
//
// What bounds a tile of FFMA is what feeds it. Per k a thread issues 64
// FFMA against two 16-byte shared loads of each operand (sgemm_tile.cuh's
// 4 x 4 tile: 16 FFMA against eight 4-byte loads), and the next k's loads
// issue before the current k's FFMA, so a warp does not wait on them. The
// global loads are asynchronous: a ring of STAGES BK-deep stages filled by
// cp.async, each stage issued STAGES - 1 k-steps before it is used.
//
// Layouts. An operand is staged as it lies, along its unit-stride axis:
//   row-fast (s_r = 1): [k][128], read by the product as it is;
//   k-fast (s_k = 1, a row-major A or a transposed B): [r][BK + 4], each
//     row four 16-byte chunks plus one of padding; once landed, the block
//     copies it into one k-major [k][128] buffer (two 16-byte loads and
//     eight 4-byte stores a thread, no bank conflicts), so the product
//     reads every operand as 16-byte loads of four rows. Read in place as
//     8-byte loads of two k, with no loads ahead, the k-fast product held
//     the 4096³ gemm to 34 TF/s, the row-fast one to 40 (H100, 700 W).
//
// Staging. VEC: 16-byte cp.async.cg, for an operand whose base is 16-byte
// aligned, unit stride 1 and leading stride a multiple of 4. .cg reads
// through L2 only, so a cooperative kernel may stage data that other
// blocks wrote before its last grid sync. Otherwise (a view off the
// 16-byte grid, or neither stride 1) each element is its own 4-byte
// cp.async.ca into the same places; .ca may hit L1, so that variant is
// for data written before the launch. Out-of-range elements (ragged
// edges) are zero-filled by the copy itself.
#pragma once

#include <cuda_runtime.h>

namespace ct {
namespace t128 {

constexpr int BM = 128;            // tile edge, rows and columns
constexpr int NT = 256;            // threads
constexpr int BK = 16;             // k-depth of a stage
constexpr int LDK = BK + 4;        // row stride of a k-fast stage
constexpr int STAGES = 3;          // the ring

template <bool KF>
__host__ __device__ constexpr int stage_floats() {
  return KF ? BM * LDK : BK * BM;
}

// Shared floats of the ring and the k-major copies, for operand layouts
// XKF, YKF.
template <bool XKF, bool YKF>
__host__ __device__ constexpr int smem_floats() {
  return STAGES * (stage_floats<XKF>() + stage_floats<YKF>()) +
         (XKF + YKF) * BK * BM;
}

__device__ __forceinline__ int warp_row() { return (threadIdx.x >> 5) >> 2; }
__device__ __forceinline__ int warp_col() { return (threadIdx.x >> 5) & 3; }
__device__ __forceinline__ int lane_row() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_col() { return threadIdx.x & 3; }

// The tile row of the thread's i-th micro-tile row, and the tile column
// of its j-th micro-tile column.
__device__ __forceinline__ int row_of(int i) {
  return 64 * warp_row() + 4 * lane_row() + (i & 3) + 32 * (i >> 2);
}

__device__ __forceinline__ int col_of(int j) {
  return 32 * warp_col() + 4 * lane_col() + (j & 3) + 16 * (j >> 2);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue the copies of rows [r0, r0 + BM) x k [k0, k0 + BK) of X into one
// stage S. Each thread copies two 16-byte chunks (four elements each);
// consecutive threads walk the unit-stride axis. TRI (row-fast only): of
// k's elements only rows r <= k + tri are live, the rest zero-filled
// like a ragged edge: a lower triangle staged without reading above it.
template <bool KF, bool VEC, bool TRI = false>
__device__ __forceinline__ void stage_load(const float* __restrict__ X,
                                           long long s_r, long long s_k,
                                           int r0, int rows, int k0, int K,
                                           float* S, int tri = 0) {
  static_assert(!(TRI && KF), "a triangle is staged row-fast");
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = threadIdx.x + h * NT;
    // k-fast: chunk (r, q) holds k 4q..4q+3 of row r; row-fast: chunk
    // (k, q) holds rows 4q..4q+3 of k
    const int r = KF ? c / (BK / 4) : 4 * (c % (BM / 4));
    const int k = KF ? 4 * (c % (BK / 4)) : c / (BM / 4);
    const int gr = r0 + r, gk = k0 + k;
    float* const dst = KF ? S + r * LDK + k : S + k * BM + r;
    // elements of the chunk inside rows x K (and the triangle)
    const int lim = TRI ? min(rows, gk + tri + 1) : rows;
    const int live = KF ? (gr < rows ? min(4, max(0, K - gk)) : 0)
                        : (gk < K ? min(4, max(0, lim - gr)) : 0);
    const float* const src = live ? X + gr * s_r + gk * s_k : X;
    if (VEC) {
      cp_async16(dst, src, 4 * live);
    } else {
      const long long step = KF ? s_k : s_r;   // along the chunk
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cp_async4(dst + e, e < live ? src + e * step : X, e < live ? 4 : 0);
    }
  }
}

// A landed k-fast stage S ([r][LDK]) into the k-major D ([k][BM]): thread
// t takes row t % 128 and k-half t / 128.
__device__ __forceinline__ void to_k_major(const float* S, float* D) {
  const int r = threadIdx.x % BM, h = threadIdx.x / BM;
  const float4 v0 = *reinterpret_cast<const float4*>(S + r * LDK + 8 * h);
  const float4 v1 =
      *reinterpret_cast<const float4*>(S + r * LDK + 8 * h + 4);
  float* const d = D + 8 * h * BM + r;
  d[0] = v0.x;
  d[BM] = v0.y;
  d[2 * BM] = v0.z;
  d[3 * BM] = v0.w;
  d[4 * BM] = v1.x;
  d[5 * BM] = v1.y;
  d[6 * BM] = v1.z;
  d[7 * BM] = v1.w;
}

// The thread's fragments of k from the k-major Xs and Ys.
__device__ __forceinline__ void fragments(const float* Xs, const float* Ys,
                                          int k, int xr, int yc,
                                          float (&a)[8], float (&b)[8]) {
  const float4 x0 = *reinterpret_cast<const float4*>(Xs + k * BM + xr);
  const float4 x1 = *reinterpret_cast<const float4*>(Xs + k * BM + xr + 32);
  const float4 y0 = *reinterpret_cast<const float4*>(Ys + k * BM + yc);
  const float4 y1 = *reinterpret_cast<const float4*>(Ys + k * BM + yc + 16);
  a[0] = x0.x;
  a[1] = x0.y;
  a[2] = x0.z;
  a[3] = x0.w;
  a[4] = x1.x;
  a[5] = x1.y;
  a[6] = x1.z;
  a[7] = x1.w;
  b[0] = y0.x;
  b[1] = y0.y;
  b[2] = y0.z;
  b[3] = y0.w;
  b[4] = y1.x;
  b[5] = y1.y;
  b[6] = y1.z;
  b[7] = y1.w;
}

// The micro-tile product over one k-major stage: acc[i][j] +=
// Σ_k X[row_of(i), k]·Y[col_of(j), k], one k at a time, the next k's
// fragments loaded before the current k's FFMA.
__device__ __forceinline__ void stage_mma(const float* Xs, const float* Ys,
                                          float (&acc)[8][8]) {
  const int xr = 64 * warp_row() + 4 * lane_row();
  const int yc = 32 * warp_col() + 4 * lane_col();
  float a[2][8], b[2][8];
  fragments(Xs, Ys, 0, xr, yc, a[0], b[0]);
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    if (k + 1 < BK) fragments(Xs, Ys, k + 1, xr, yc, a[~k & 1], b[~k & 1]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[i][j] = fmaf(a[k & 1][i], b[k & 1][j], acc[i][j]);
  }
}

// acc[i][j] += Σ_k X[r0 + row_of(i), k]·Y[c0 + col_of(j), k] over k in
// [0, K), rows and cols bounding X's and Y's rows. smem holds
// smem_floats<XKF, YKF>() floats, 16-byte aligned. Ends with a barrier,
// so the caller may reuse smem. TRI: X's row r and Y's row c enter at k
// only for r <= k + trix and c <= k + triy (stage_load).
template <bool XKF, bool YKF, bool VEC, bool TRI = false>
__device__ __forceinline__ void tile_xyt(const float* __restrict__ X,
                                         long long sx_r, long long sx_k,
                                         int r0, int rows,
                                         const float* __restrict__ Y,
                                         long long sy_r, long long sy_k,
                                         int c0, int cols, int K, float* smem,
                                         float (&acc)[8][8], int trix = 0,
                                         int triy = 0) {
  constexpr int XF = stage_floats<XKF>(), YF = stage_floats<YKF>();
  float* const Xs = smem;
  float* const Ys = smem + STAGES * XF;
  float* const Xk = Ys + STAGES * YF;              // the k-major copies
  float* const Yk = Xk + (XKF ? BK * BM : 0);
  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      stage_load<XKF, VEC, TRI>(X, sx_r, sx_k, r0, rows, s * BK, K,
                                Xs + s * XF, trix);
      stage_load<YKF, VEC, TRI>(Y, sy_r, sy_k, c0, cols, s * BK, K,
                                Ys + s * YF, triy);
    }
    cp_commit();
  }
  int slot = 0;
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<STAGES - 2>();         // this thread's copies of stage kt
    __syncthreads();               // everyone's; stage kt - 1 is read
    const int next = kt + STAGES - 1;
    if (next < nk) {
      const int ns = (slot + STAGES - 1) % STAGES;
      stage_load<XKF, VEC, TRI>(X, sx_r, sx_k, r0, rows, next * BK, K,
                                Xs + ns * XF, trix);
      stage_load<YKF, VEC, TRI>(Y, sy_r, sy_k, c0, cols, next * BK, K,
                                Ys + ns * YF, triy);
    }
    cp_commit();
    if (XKF || YKF) {              // the k-major copies, read after kt - 1
      if (XKF) to_k_major(Xs + slot * XF, Xk);
      if (YKF) to_k_major(Ys + slot * YF, Yk);
      __syncthreads();
    }
    stage_mma(XKF ? Xk : Xs + slot * XF, YKF ? Yk : Ys + slot * YF, acc);
    slot = (slot + 1) % STAGES;
  }
  cp_wait<0>();
  __syncthreads();
}

}  // namespace t128
}  // namespace ct
