// The 128-wide leaf of the lower-triangular inverse, shared by
// trtri_block.cu (trtri_block_f32) and leaf.cu (trti2_f32).
//
// One block of 256 threads inverts the diagonal tile at rows/columns
// [128·tile, 128·tile + 128) ∩ [0, n) of L into W, in shared memory: four
// warps invert its 32-wide diagonal blocks by column-oriented substitution
// in registers (lane j owns column j, no barrier in the chain), then the
// block joins them with the identity inv([[A, 0], [B, C]]) = [[A⁻¹, 0],
// [−C⁻¹·B·A⁻¹, C⁻¹]] at 64 and at 128 (16-byte shared loads). The last
// tile may be short (identity padding decouples). Only L's lower triangle
// is read; the tile is stored with its strict upper zero. A zero diagonal
// is read as 1 (UNIT: every diagonal), and tile 0's block writes info,
// the 1-based index of the first zero diagonal of all n (0 with UNIT).
// The block needs LEAF_SMEM bytes of dynamic shared memory.
#pragma once

#include "sgemm128.cuh"

namespace ct {
namespace tleaf {

constexpr int LW = 128;            // leaf tile
constexpr int TW = 32;             // diagonal blocks of the substitution
constexpr int NT = 256;            // threads of a block
constexpr int LDT = LW + 4;        // row stride of the leaf's tiles (16-byte)
constexpr int LDX = LW / 2 + 4;    // row stride of the leaf's join product
constexpr int INFO_CHUNK = 1024;   // diagonal entries in flight for info
// shared floats: the leaf's tile of L, its inverse and one join product
constexpr int LEAF_FLOATS = 2 * LW * LDT + (LW / 2) * LDX + LW;
constexpr int LEAF_SMEM = LEAF_FLOATS * sizeof(float);

// The leaf's join of the pairs of inverted S-blocks of its tile: for each
// pair (A at a0, C at a0 + S) V21 = −C⁻¹·(B·A⁻¹), B from the tile of L,
// through X; RM x 4 outputs a thread, its operands read as 16-byte loads
// (four k of a row, or four columns of a k).
template <int S, int RM>
__device__ __forceinline__ void join(const float* T, float* V, float* X) {
  constexpr int PAIRS = LW / (2 * S), PER = NT / PAIRS;
  static_assert(PER == (S / RM) * (S / 4), "one micro-tile a thread");
  const int p = threadIdx.x / PER, q = threadIdx.x % PER;
  const int ty = q / (S / 4), tx = q % (S / 4);
  const int a0 = 2 * S * p, c0 = a0 + S;
  // acc[a][b] += Σ_k P[(RM·ty + a)·ldp + k]·Q[k·ldq + 4tx + b]
  auto product = [&](const float* P, int ldp, const float* Q, int ldq,
                     float (&acc)[RM][4]) {
#pragma unroll 2
    for (int k = 0; k < S; k += 4) {
      float4 pv[RM];
#pragma unroll
      for (int a = 0; a < RM; ++a)
        pv[a] = *reinterpret_cast<const float4*>(P + (RM * ty + a) * ldp + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 qv =
            *reinterpret_cast<const float4*>(Q + (k + kk) * ldq + 4 * tx);
        const float qs[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
        for (int a = 0; a < RM; ++a) {
          const float pa = kk == 0 ? pv[a].x : kk == 1 ? pv[a].y
                                             : kk == 2 ? pv[a].z : pv[a].w;
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(pa, qs[b], acc[a][b]);
        }
      }
    }
  };
  float acc[RM][4] = {};
  product(T + c0 * LDT + a0, LDT, V + a0 * LDT + a0, LDT, acc);
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    *reinterpret_cast<float4*>(X + (S * p + RM * ty + a) * LDX + 4 * tx) =
        make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  }
  __syncthreads();
  product(V + c0 * LDT + c0, LDT, X + S * p * LDX, LDX, acc);
#pragma unroll
  for (int a = 0; a < RM; ++a)
    *reinterpret_cast<float4*>(V + (c0 + RM * ty + a) * LDT + a0 + 4 * tx) =
        make_float4(-acc[a][0], -acc[a][1], -acc[a][2], -acc[a][3]);
  __syncthreads();
}

// Invert the leaf tile at rows/columns [128·tile, 128·tile + 128) ∩ [0, n)
// into W, its strict upper zero.
template <bool UNIT = false>
__device__ void leaf(const float* __restrict__ L, long long ldl, float* W,
                     long long ldw, int n, int tile, float* sm, int* info) {
  float* const T = sm;             // L's tile, T[i·LDT + k]
  float* const V = sm + LW * LDT;  // its inverse
  float* const X = sm + 2 * LW * LDT;
  float* const dinv = X + (LW / 2) * LDX;
  __shared__ int s_first;
  const int tid = threadIdx.x;
  const int r0 = tile * LW, w = min(LW, n - r0);
  constexpr int U = LW * LW / NT;  // elements a thread: rows i0 + 2u
  const int k = tid % LW, i0 = tid / LW;

  if (tile == 0) {                 // info: the first zero diagonal
    if (tid == 0) s_first = n;
    __syncthreads();
    for (int b = 0; !UNIT && b < n; b += INFO_CHUNK) {
      float d[INFO_CHUNK / NT];
#pragma unroll
      for (int u = 0; u < INFO_CHUNK / NT; ++u) {
        const int i = b + tid + u * NT;
        d[u] = i < n ? L[i * (ldl + 1)] : 1.f;
      }
#pragma unroll
      for (int u = 0; u < INFO_CHUNK / NT; ++u)
        if (d[u] == 0.f) atomicMin(&s_first, b + tid + u * NT);
    }
    __syncthreads();
    if (tid == 0) *info = (s_first < n) ? s_first + 1 : 0;
  }
  {
    // the tile's lower part by 4-byte cp.async, every copy in flight at
    // once; the rest of T zero-filled by the copies themselves
    const float* const Lk = L + (r0 + i0) * ldl + r0 + k;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + 2 * u;
      const bool live = i < w && k <= i;
      ct::t128::cp_async4(T + i * LDT + k, live ? Lk + 2 * u * ldl : L,
                          live ? 4 : 0);
    }
    ct::t128::cp_commit();
    // the joins read whole blocks of V: the two 32 x 32 blocks above the
    // diagonal blocks that no step writes, zero
    for (int idx = tid; idx < 2 * TW * TW; idx += NT) {
      const int b = 2 * TW * (idx / (TW * TW)), e = idx % (TW * TW);
      V[(b + e / TW) * LDT + b + TW + e % TW] = 0.f;
    }
    ct::t128::cp_wait<0>();
  }
  __syncthreads();
  if (tid < LW) {                  // a zero pivot and rows past n read 1
    float& d = T[tid * LDT + tid];
    if (UNIT || tid >= w || d == 0.f) d = 1.f;
    dinv[tid] = 1.f / d;
  }
  __syncthreads();
  if (tid < LW) {
    // the four 32-wide diagonal blocks, warp q the one at o = 32q: lane j
    // solves for column j, x_k final once the columns left of it are
    // applied; no barrier in the chain
    const int o = (tid / 32) * TW, j = tid % 32;
    float x[TW];
#pragma unroll
    for (int i = 0; i < TW; ++i) x[i] = (i == j) ? 1.f : 0.f;
#pragma unroll
    for (int kk = 0; kk < TW; ++kk) {
      x[kk] *= dinv[o + kk];
#pragma unroll
      for (int i = kk + 1; i < TW; ++i)
        x[i] = fmaf(-T[(o + i) * LDT + o + kk], x[kk], x[i]);
    }
#pragma unroll
    for (int i = 0; i < TW; ++i) V[(o + i) * LDT + o + j] = x[i];
  }
  __syncthreads();
  join<32, 2>(T, V, X);
  join<64, 4>(T, V, X);
  // the tile, zero above its diagonal: four columns a thread, by 16-byte
  // stores where W's rows allow
  const int c4 = 4 * (tid % (LW / 4)), q0 = tid / (LW / 4);
  const bool vec = ldw % 4 == 0 && w == LW;
#pragma unroll 4
  for (int i = q0; i < w; i += NT / (LW / 4)) {
    const float4 v = *reinterpret_cast<const float4*>(V + i * LDT + c4);
    const float e[4] = {c4 <= i ? v.x : 0.f, c4 + 1 <= i ? v.y : 0.f,
                        c4 + 2 <= i ? v.z : 0.f, c4 + 3 <= i ? v.w : 0.f};
    float* const out = W + (r0 + i) * ldw + r0 + c4;
    if (vec)
      *reinterpret_cast<float4*>(out) = make_float4(e[0], e[1], e[2], e[3]);
    else
      for (int b = 0; b < 4 && c4 + b < w; ++b) out[b] = e[b];
  }
  __syncthreads();                 // sm is the next tile's
}

}  // namespace tleaf
}  // namespace ct
