// lauum_stream_f32 and lauu2_f32: B = tril(Lᵀ·L) from the lower triangle of
// L, out of place.
//
// Replaces cholesky_tpu/ops/pallas/mega.py:lauum_hbm_f32
// (_lauum_hbm_kernel, n % 128 == 0, n <= 8192) and
// cholesky_tpu/ops/pallas/leaf.py:lauu2_f32 (_lauu2_kernel, one leaf, whose
// strict upper passes the input through). On the GP model's train step the
// first is potri's lauum at n = 8192 (one launch a step); the second is
// each leaf of the lauum recursion when a block size is given, of any n (a
// complex lauum runs at twice its dimension through the real embedding).
//
// What bounds it on the H100: n^3/6 FFMA (92 G at n = 8192) in plain f32
// (TF32 is not f32-accurate), at best the 67 TFLOP/s vector rate: 2.74 ms
// at 8192. The TPU kernel walked 128-row panels top-down, in place, with a
// k-stream of the rows below each panel. On the card the output tiles are
// independent, B[I, J] = Σ_{K >= I} L[K, I]ᵀ·L[K, J] for I >= J, and the
// result goes to a separate buffer (in place, a tile's store would race
// with other tiles' reads of L). Tile (I, J)'s depth runs from its own row
// block to n, so the depths of the 2080 lower 128-tiles at 8192 range from
// 128 to 8192, and of the 36 at 1024 from 128 to 1024: too few tiles for
// the card, and a deep one last would finish alone.
//
// Design (lauum_stream_f32): syrk_lower_f32 of the row-fast view Lᵀ with
// each tile's depth starting at its own row block, on sgemm128.cuh's
// 128 x 128 cp.async tile (8 x 8 micro-tiles). Below
// mega.STREAM_WHOLE_MIN_TILES lower tiles (264, one wave of two blocks
// an SM) the tiles' k-steps, row by row over the triangle, are cut in
// equal runs of q as runs128.cuh cuts them, one a block, a split tile
// summed in k order by one more launch; from there a block takes a tile,
// in the same order, which is the deepest first (the wrapper's plan,
// ops/kernels/mega.py lauum_launch_plan). Only a tile's first eight
// k-steps (its own row block) meet L's strict upper: a first launch copies
// tril of L's diagonal 128-blocks into an n x 128 scratch D, from which
// those steps are staged, and writes B's strict upper tiles zero; every
// other step stages L itself, by 16-byte cp.async where L lies on the
// 16-byte grid. L's strict upper is never read. Diagonal tiles store zero
// above their diagonal.
//
// Measured (chip_smoke.py at commit f78f09b; ms of one call, NVIDIA H100
// 80GB HBM3, 700 W): equal runs for one wave against a tile a block,
// 0.0882 / 0.1458-0.1471 at 1024, 0.2343-0.2366 / 0.3290-0.3296 at 2048,
// 0.7835-0.7997 / 0.7420-0.7558 at 4096, 4.9905-5.0154 / 4.6973-4.7307 at
// 8192. Past a wave's worth of tiles the deepest-first order balances the
// card by itself, and runs only add the split tiles' stores and sums. At
// 8192 a tile a block runs the tile at 38-39 TF/s on the products it
// does (the diagonal tiles whole: 4.7 % above n³/3 flops). The design
// before this one, one 256-thread block per 64 x 64 tile of sgemm_tile.cuh
// with masked 4-byte loads of every k-step, took 9.2172-9.2229 ms at 8192
// (chip_smoke.py at commit bcdb7f0).
//
// lauu2_f32 keeps that 64 x 64 kernel: one 256-thread block per tile of
// B, the lower tiles first (row-major over the triangle), then the
// strict-upper tiles, which pass the input through bit for bit.
#include <algorithm>

#include "runs128.cuh"
#include "sgemm_tile.cuh"

namespace {

// ---- lauum_stream_f32 ----------------------------------------------------

using ct::runs::E;                 // the tile edge
using ct::runs::NT;                // threads
constexpr int DSTEPS = E / ct::runs::STEP;   // a tile's steps in D
constexpr int STREAM_MAX_N = 8192;

// The lower tiles t -> (I, J), row-major over the triangle; tile (I, J)
// spans L's rows [128·I, n), 8·(nt − I) steps. VEC: L on the 16-byte grid.
template <bool VEC>
struct LauumPlan {
  const float* L;
  long long ldl;
  const float* D;
  float* B;
  long long ldb;
  int nt;

  __device__ int steps_of_row(int I) const { return DSTEPS * (nt - I); }
  // the steps of rows 0 .. I − 1: Σ_{a=1}^{I} a·8·(nt + 1 − a)
  __device__ long long row_start(int I) const {
    const long long a = I;
    return DSTEPS *
           ((nt + 1) * a * (a + 1) / 2 - a * (a + 1) * (2 * a + 1) / 6);
  }
  __device__ long long total() const { return row_start(nt); }
  __device__ int steps(int t) const {
    int I, J;
    ct::tri_tile(t, I, J);
    return steps_of_row(I);
  }
  __device__ long long start(int t) const {
    int I, J;
    ct::tri_tile(t, I, J);
    return row_start(I) + static_cast<long long>(J) * steps_of_row(I);
  }
  __device__ int tile_at(long long u) const {
    int I = 0;
    while (I + 1 < nt && row_start(I + 1) <= u) ++I;
    return I * (I + 1) / 2 +
           static_cast<int>((u - row_start(I)) / steps_of_row(I));
  }
  // steps [s0, s1) of tile t: those inside the row block from D, the rest
  // from L
  __device__ void part(int t, int s0, int s1, float (&acc)[8][8],
                       float* sm) const {
    int I, J;
    ct::tri_tile(t, I, J);
    const long long r0 = static_cast<long long>(E) * I, c0 = E * J;
    const int sd = min(s1, DSTEPS);
    if (s0 < sd) {                 // X(r, k) = D[k0 + k][r]
      const long long k0 = r0 + s0 * ct::runs::STEP;
      const float* const X = D + k0 * E;
      const bool diag = I == J;
      ct::t128::tile_xyt<false, false, VEC>(
          X, 1, E, 0, E, diag ? X : L + k0 * ldl + c0, 1, diag ? E : ldl, 0,
          E, (sd - s0) * ct::runs::STEP, sm, acc);
    }
    const int sb = max(s0, DSTEPS);
    if (sb < s1) {                 // X(r, k) = L[k0 + k][r0 + r]
      const long long k0 = r0 + sb * ct::runs::STEP;
      ct::t128::tile_xyt<false, false, VEC>(
          L + k0 * ldl + r0, 1, ldl, 0, E, L + k0 * ldl + c0, 1, ldl, 0, E,
          (s1 - sb) * ct::runs::STEP, sm, acc);
    }
  }
  // four elements of row r, columns c .. c + 3, of tile t into B; zero
  // above a diagonal tile's diagonal
  __device__ void put4(int t, int r, int c, float4 v) const {
    int I, J;
    ct::tri_tile(t, I, J);
    if (I == J) {
      if (c > r) v.x = 0.f;
      if (c + 1 > r) v.y = 0.f;
      if (c + 2 > r) v.z = 0.f;
      if (c + 3 > r) v.w = 0.f;
    }
    *reinterpret_cast<float4*>(
        B + (static_cast<long long>(E) * I + r) * ldb + E * J + c) = v;
  }
  __device__ void store(int t, const float (&acc)[8][8]) const {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        put4(t, ct::t128::row_of(i), ct::t128::col_of(4 * h),
             make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                         acc[i][4 * h + 3]));
  }
  __device__ void store4(int t, int r, int c, float4 v) const {
    put4(t, r, c, v);
  }
};

// D[r][c] = L[r][128·I + c] for c <= r − 128·I (I = r / 128), else 0; B's
// row r zero right of its diagonal tile. A row a block (blocks of 128).
__global__ void lauum_prep(const float* __restrict__ L, long long ldl,
                           float* __restrict__ D, float* __restrict__ B,
                           long long ldb, int n) {
  for (int r = blockIdx.x; r < n; r += gridDim.x) {
    const int c0 = r / E * E, d = r - c0;
    for (int c = threadIdx.x; c < E; c += blockDim.x)
      D[static_cast<long long>(r) * E + c] =
          c <= d ? L[r * ldl + c0 + c] : 0.f;
    for (int c = c0 + E + 4 * threadIdx.x; c < n; c += 4 * blockDim.x)
      *reinterpret_cast<float4*>(B + r * ldb + c) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

constexpr int SMEM =
    ct::t128::smem_floats<false, false>() * static_cast<int>(sizeof(float));

// Run blockIdx.x of q steps, or with q = 0 tile blockIdx.x whole.
template <bool VEC>
__global__ void __launch_bounds__(NT, 2)
lauum_runs(LauumPlan<VEC> p, long long q, float* P) {
  extern __shared__ __align__(16) float sm[];
  long long u = static_cast<long long>(blockIdx.x) * q, u1 = u + q;
  if (q == 0) {
    u = p.start(blockIdx.x);
    u1 = u + p.steps(blockIdx.x);
  }
  u1 = min(u1, p.total());
  float* const slots = P + 2LL * blockIdx.x * ct::runs::SLOT;
  ct::runs::run(p, u, u1, slots, slots + ct::runs::SLOT, sm);
}

// The split tiles, a block per run boundary (blockIdx.x) and group set.
template <bool VEC>
__global__ void __launch_bounds__(NT)
lauum_sum(LauumPlan<VEC> p, long long q, const float* P) {
  ct::runs::sum_at(p, blockIdx.x, blockIdx.y * NT + threadIdx.x, q, P);
}

template <bool VEC>
cudaError_t launch_stream(const LauumPlan<VEC>& p, long long q, int blocks,
                          float* P, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      lauum_runs<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  lauum_runs<VEC><<<blocks, NT, SMEM, s>>>(p, q, P);
  if (q > 0 && blocks > 1)
    lauum_sum<VEC><<<dim3(blocks, ct::runs::GROUPS), NT, 0, s>>>(p, q, P);
  return cudaGetLastError();
}

// ---- lauu2_f32 -------------------------------------------------------------

constexpr int BT = 64;
constexpr int BK = 16;
constexpr int NT64 = (BT / ct::TM) * (BT / ct::TN);   // 256 threads

// S[k][r] = L[k0 + k][r0 + r], zero outside the lower triangle and outside
// n. Row-major L: consecutive threads walk r, the unit-stride axis.
__device__ __forceinline__ void slab_lower(const float* __restrict__ L,
                                           long long ldl, int n, int r0,
                                           int k0, float (*S)[BT + 1]) {
  for (int idx = threadIdx.x; idx < BT * BK; idx += NT64) {
    const int r = idx % BT, k = idx / BT;
    const int gr = r0 + r, gk = k0 + k;
    S[k][r] = (gr < n && gk < n && gk >= gr) ? L[gk * ldl + gr] : 0.f;
  }
}

__global__ void __launch_bounds__(NT64)
lauu2_kernel(const float* __restrict__ L, long long ldl,
             float* __restrict__ B, long long ldb, int n) {
  __shared__ float Xs[BK][BT + 1];
  __shared__ float Ys[BK][BT + 1];
  const int nt = (n + BT - 1) / BT;
  const int ntri = nt * (nt + 1) / 2;
  const int tx = threadIdx.x % (BT / ct::TN);
  const int ty = threadIdx.x / (BT / ct::TN);
  int ti, tj;
  if (static_cast<int>(blockIdx.x) >= ntri) {
    // a strict-upper tile (row a, column b + 1 > a): the input's
    ct::tri_tile(blockIdx.x - ntri, ti, tj);
    const int r0 = tj * BT, c0 = (ti + 1) * BT;
    for (int idx = threadIdx.x; idx < BT * BT; idx += NT64) {
      const int r = r0 + idx / BT, c = c0 + idx % BT;
      if (r < n && c < n) B[r * ldb + c] = L[r * ldl + c];
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
      if (c > r) v = L[r * ldl + c];  // diagonal tiles
      B[r * ldb + c] = v;
    }
  }
}

}  // namespace

// q steps a run, blocks runs covering the lower tiles' steps, or q = 0:
// blocks = the lower tiles, one a block. D: n x 128 floats; P: two
// 128 x 128 slots a block (q > 0). B is the wrapper's own n x n buffer.
CT_EXPORT int ct_lauum_stream_f32(const float* L, long long ldl, float* B,
                                  long long ldb, int n, long long q,
                                  int blocks, float* D, float* P, int device,
                                  void* stream) {
  if (n < E || n > STREAM_MAX_N || n % E != 0 || ldl < n || ldb < n ||
      ldb % 4 != 0 || reinterpret_cast<unsigned long long>(B) % 16 != 0 ||
      reinterpret_cast<unsigned long long>(D) % 16 != 0 || q < 0 ||
      blocks < 1 || (q > 0 && !P))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nt = n / E;
  const long long tiles = static_cast<long long>(nt) * (nt + 1) / 2;
  long long total = 0;               // the lower tiles' steps
  for (int I = 0; I < nt; ++I) total += (I + 1LL) * DSTEPS * (nt - I);
  if (q == 0 ? blocks != tiles : blocks * q < total)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  lauum_prep<<<std::min(n, 4096), E, 0, s>>>(L, ldl, D, B, ldb, n);
  const bool vec =
      reinterpret_cast<unsigned long long>(L) % 16 == 0 && ldl % 4 == 0;
  err = vec ? launch_stream(LauumPlan<true>{L, ldl, D, B, ldb, nt}, q,
                            blocks, P, s)
            : launch_stream(LauumPlan<false>{L, ldl, D, B, ldb, nt}, q,
                            blocks, P, s);
  return static_cast<int>(err);
}

CT_EXPORT int ct_lauu2_f32(const float* L, long long ldl, float* B,
                           long long ldb, int n, int device, void* stream) {
  if (n < 1 || ldl < n || ldb < n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nt = (n + BT - 1) / BT;
  if (nt * nt > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  lauu2_kernel<<<static_cast<unsigned>(nt * nt), NT64, 0,
                 static_cast<cudaStream_t>(stream)>>>(L, ldl, B, ldb, n);
  return static_cast<int>(cudaGetLastError());
}
