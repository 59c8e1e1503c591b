// The 128 x 128 diagonal-tile Cholesky of one thread block of 256 threads,
// used by potrf_stream.cu and leaf.cu (potf2_f32).
//
// factor_tile factors the lower part of a diagonal tile in shared memory
// in 32-wide steps (warp 0 the 32 x 32 block in registers and shuffles,
// one thread per row below it, the rest of the tile by a 16 x 16 thread
// grid with register blocking), then inverts it in 32-row blocks (one
// product against the rows already inverted, then a forward substitution
// down the block, one thread per column), so that no thread runs a chain
// longer than 32. A tile narrower than 128 (the last tile of a matrix of
// n < 128) is padded with identity rows, which never fail and decouple.
//
// What bounds it is latency: one block on one SM, and the 128 pivots are
// one chain. Each pivot step scales its column by an rsqrtf refined by
// one Newton step (within an ulp of 1/sqrt), the correctly rounded sqrtf
// of the stored diagonal taken after the chain, and the trailing update
// of each step covers only the rows still below it. The factor took
// 41-43 µs a tile inside potrf_stream.cu at n = 4096 (H100, 700 W) with
// the chain's shuffles in warp 0, in all eight warps or through shared
// memory alike, so the chain alone does not bound it.
#pragma once

#include "sgemm_tile.cuh"

namespace ct {
namespace tile {

constexpr int NB = 128;        // tile edge
constexpr int LDT = NB + 1;    // shared row stride of the tile
constexpr int DB = 32;         // step of the tile's own factor and inverse
constexpr int NT = 256;        // threads of the block
constexpr int SMEM = NB * LDT * static_cast<int>(sizeof(float));

// 1/sqrt(x) for x > 0 within about an ulp: the hardware estimate and one
// Newton step, three dependent operations after it.
__device__ __forceinline__ float rsqrt_nr(float x) {
  const float r = rsqrtf(x);
  const float h = 0.5f * x;
  return r * fmaf(-h * r, r, 1.5f);
}

// T[i][j] -= Σ_m T[i][c + m]·T[j][c + m] over the lower triangle of rows
// and columns [c + DB, NB): thread (tid / 16, tid % 16) owns rows
// c + DB + tid / 16 + 16a and columns c + DB + tid % 16 + 16b, a, b < G,
// G = (NB - c - DB) / 16.
template <int G>
__device__ __forceinline__ void trailing_update(float* T, int c) {
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int m0 = c + DB;
  float acc[G][G] = {};
#pragma unroll 4
  for (int m = 0; m < DB; ++m) {
    float ra[G], cb[G];
#pragma unroll
    for (int a = 0; a < G; ++a) ra[a] = T[(m0 + tr + 16 * a) * LDT + c + m];
#pragma unroll
    for (int b = 0; b < G; ++b) cb[b] = T[(m0 + tc + 16 * b) * LDT + c + m];
#pragma unroll
    for (int a = 0; a < G; ++a)
#pragma unroll
      for (int b = 0; b < G; ++b) acc[a][b] = fmaf(ra[a], cb[b], acc[a][b]);
  }
#pragma unroll
  for (int a = 0; a < G; ++a)
#pragma unroll
    for (int b = 0; b < G; ++b) {
      const int i = m0 + tr + 16 * a, j = m0 + tc + 16 * b;
      if (j <= i) T[i * LDT + j] -= acc[a][b];
    }
}

// Factor the diagonal tile A[c0:c0+pw, c0:c0+pw] (lower part only, pw <=
// NB), store the factor back (lower part only) and, if want_inv and no
// pivot failed, its inverse into Winv (NB x NB, row-major, zero strict
// upper). Writes info: the absolute 1-based failed pivot, or 0. T is
// SMEM bytes of shared memory; dinv NB floats of shared memory. On a
// failed pivot the tile is stored as far as it got. With a stamp, thread
// 0 writes %globaltimer there when the factor (the first half) is done.
static __device__ void factor_tile(float* A, long long lda, int c0, int pw,
                                   bool want_inv, float* Winv, int* info,
                                   float* T, float* dinv, int* s_fail,
                                   unsigned long long* stamp = nullptr) {
  const int tid = threadIdx.x;
  float* const At = A + (long long)c0 * lda + c0;
  __syncthreads();                 // this block's own updates of the tile
#pragma unroll 8
  for (int idx = tid; idx < NB * NB; idx += NT) {
    const int i = idx / NB, k = idx % NB;
    T[i * LDT + k] = (i < pw && k <= i) ? __ldcg(At + (long long)i * lda + k)
                                        : (i == k ? 1.f : 0.f);
  }
  __syncthreads();

  // ---- the factor, right-looking over DB-wide steps
  int fail = 0;
  for (int c = 0; c < NB; c += DB) {
    // (a) warp 0 factors the DB x DB diagonal block, lane l holding row
    // c + l in registers, column k reaching the other lanes by shuffles.
    // The chain per pivot is one shuffle, the scale (rsqrt_nr) and one
    // update; the correctly rounded sqrtf of each diagonal is taken after
    // the chain. Every update is unconditional, its coefficient selected
    // (zero where a lane must not change), so that the shuffles of one
    // pivot issue back to back: predicated updates made ptxas pass them
    // all through one register, each waiting out the last. Past a failed
    // pivot the block is frozen, every later coefficient zero.
    if (tid < 32) {
      const int l = tid;
      float row[DB];
#pragma unroll
      for (int j = 0; j < DB; ++j) row[j] = T[(c + l) * LDT + c + j];
      int f = 0;
      float piv = 1.f;             // this lane's pivot, once factored
#pragma unroll
      for (int k = 0; k < DB; ++k) {
        const float d2 = __shfl_sync(0xffffffffu, row[k], k);
        f = (f == 0 && !(d2 > 0.f)) ? c0 + c + k + 1 : f;   // NaN-safe
        const bool live = f == 0;                           // every lane
        const float rd = rsqrt_nr(live ? d2 : 1.f);
        if (live && l == k) dinv[c + k] = rd;   // W's diagonal, the scale
        piv = live && l == k ? d2 : piv;
        row[k] *= live && l > k ? rd : 1.f;
        const float nlk = live ? -row[k] : 0.f;
#pragma unroll
        for (int j = k + 1; j < DB; ++j) {
          const float ljk = __shfl_sync(0xffffffffu, row[k], j);
          row[j] = fmaf(l >= j ? nlk : 0.f, ljk, row[j]);
        }
      }
      const float d = sqrtf(piv);
      const bool factored = f == 0 || c0 + c + l + 1 < f;
#pragma unroll
      for (int j = 0; j < DB; ++j)
        if (j <= l)
          T[(c + l) * LDT + c + j] = j == l && factored ? d : row[j];
      if (l == 0) *s_fail = f;
    }
    __syncthreads();
    fail = *s_fail;
    if (fail) break;               // the same for every thread
    // (b) each row below the block solves x·Dᵀ = a, x in registers
    for (int r = c + DB + tid; r < NB; r += NT) {
      float* const xr = T + r * LDT + c;
      float x[DB];
#pragma unroll
      for (int k = 0; k < DB; ++k) {
        float s = xr[k];
#pragma unroll
        for (int m = 0; m < k; ++m)
          s = fmaf(-x[m], T[(c + k) * LDT + c + m], s);
        x[k] = s * dinv[c + k];
      }
#pragma unroll
      for (int k = 0; k < DB; ++k) xr[k] = x[k];
    }
    __syncthreads();
    // (c) the rest of the tile's lower triangle -= X·Xᵀ (k = DB), over
    // the rows below the step only
    if (c == 0) trailing_update<(NB - DB) / 16>(T, c);
    else if (c == DB) trailing_update<(NB - 2 * DB) / 16>(T, c);
    else if (c == 2 * DB) trailing_update<(NB - 3 * DB) / 16>(T, c);
    __syncthreads();
  }

  if (stamp && tid == 0) *stamp = globaltimer();
  if (!fail && want_inv) {
    // ---- W = T⁻¹ by DB-row blocks I: W[I, :] = D_I⁻¹·(E_I − T[I, <I]·W).
    // W[i][j] (i > j) is kept at T[j][i], the unused strict upper of the
    // tile; W[j][j] = 1 / T[j][j] is dinv[j], written by (a).
    for (int r0 = 0; r0 < NB; r0 += DB) {
      // (i) R[i][j] = −Σ_{j <= k < r0} T[i][k]·W[k][j], i in the block,
      // j < r0, into T[j][i]
      for (int idx = tid; idx < DB * r0; idx += NT) {
        const int i = r0 + idx % DB, j = idx / DB;
        const float* const ti = T + i * LDT;
        const float* const wj = T + j * LDT;   // W[k][j] at T[j][k], k > j
        float s[4] = {-ti[j] * dinv[j], 0.f, 0.f, 0.f};
        int k = j + 1;
        for (; k + 3 < r0; k += 4) {
#pragma unroll
          for (int u = 0; u < 4; ++u) s[u] = fmaf(-ti[k + u], wj[k + u], s[u]);
        }
        for (; k < r0; ++k) s[0] = fmaf(-ti[k], wj[k], s[0]);
        T[j * LDT + i] = (s[0] + s[1]) + (s[2] + s[3]);
      }
      __syncthreads();
      // (ii) forward substitution down the block, thread j for column j,
      // the column in registers (zero above row j)
      const int j = tid;
      if (j < r0 + DB) {
        float x[DB];
#pragma unroll
        for (int q = 0; q < DB; ++q) {
          const int i = r0 + q;
          float s = (j < r0) ? T[j * LDT + i] : (i == j ? 1.f : 0.f);
#pragma unroll
          for (int m = 0; m < q; ++m)
            s = fmaf(-T[i * LDT + r0 + m], x[m], s);
          x[q] = s * dinv[i];
        }
#pragma unroll
        for (int q = 0; q < DB; ++q)
          if (r0 + q > j) T[j * LDT + r0 + q] = x[q];
      }
      __syncthreads();
    }
    for (int idx = 4 * tid; idx < NB * NB; idx += 4 * NT) {
      const int i = idx / NB;
      float w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = idx % NB + u;
        w[u] = (c < i) ? T[c * LDT + i] : (c == i ? dinv[c] : 0.f);
      }
      *reinterpret_cast<float4*>(Winv + idx) = make_float4(w[0], w[1], w[2],
                                                           w[3]);
    }
  }
  for (int idx = tid; idx < NB * NB; idx += NT) {
    const int i = idx / NB, k = idx % NB;
    if (k <= i && i < pw) At[(long long)i * lda + k] = T[i * LDT + k];
  }
  if (tid == 0) *info = fail;
  __syncthreads();                 // T may be reused by the caller
}

}  // namespace tile
}  // namespace ct
