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
// lauu2_f32 is the same tile and plan at any n, the plan's leaf form
// (LauumPlan<VEC, true>), in one launch, or two where runs split tiles:
// no D and no first launch. Its k-steps are clipped at n, so a row
// block's tiles have ⌈(n − 128·I) / 16⌉ steps, f = (128·nt − n) / 16
// fewer than whole blocks would give, and the last row and column block
// may be partial. Every step stages L itself, the elements above L's
// diagonal zero-filled by the copies (sgemm128.cuh's TRI staging), so
// the strict upper never enters the product. Diagonal tiles store A's
// values above their diagonal, and each block of the runs launch then
// copies its share of the rows of A's strict upper right of the diagonal
// tiles, so the strict upper passes through bit for bit. B's rows (n
// floats) may lie off the 16-byte grid: its tiles are then stored a float
// at a time. The plan (leaf.lauu2_launch_plan) is mega.lauum_launch_plan
// at any n, but below 132 lower tiles (10 at 512, 6 at 368) the runs are
// cut for one block an SM, not two: cut for a whole wave a leaf's few
// tiles split into twice the parts, whose sums cost more than a second
// block an SM gains (device µs of a call, runs for 264 / 132 blocks: 25
// / 18 at 512, 44-45 / 37 at 1000, 141-145 / 152-156 at 2048, where the
// rule takes 264; chip_smoke.py's A/B at commit ab8a088, NVIDIA H100 80GB
// HBM3, 700 W). At leaf sizes a call is bound by the host's launch path
// as much as by the card (host enqueue 22-35 µs, device 9-18 µs at
// 128-512). At 2048 it took 0.1656-0.1811 ms, 2-9 % behind
// lauum_stream_f32 on the same L in turns, its device time 142.5 µs
// against 125.1 (chip_compare.py, same commit and card). It replaced
// one 256-thread block per 64 x 64 tile of sgemm_tile.cuh, with masked
// 4-byte loads of every k-step: 0.3382-0.3722 ms at 2048 (chip_smoke.py
// at commit 9a8ed17, NVIDIA H100 80GB HBM3, 700 W).
#include <algorithm>

#include "runs128.cuh"
#include "sgemm_tile.cuh"

namespace {

using ct::runs::E;                 // the tile edge
using ct::runs::NT;                // threads
constexpr int DSTEPS = E / ct::runs::STEP;   // a tile's steps in D
constexpr int STREAM_MAX_N = 8192;

// The lower tiles t -> (I, J), row-major over the triangle; tile (I, J)
// spans L's rows [128·I, n), steps_of_row(I) k-steps. VEC: L on the
// 16-byte grid. LEAF (lauu2_f32): any n, the strict upper passed through.
template <bool VEC, bool LEAF>
struct LauumPlan {
  const float* L;
  long long ldl;
  const float* D;
  float* B;
  long long ldb;
  int nt;
  int n;
  int f;       // LEAF: the steps a tile lacks at a partial last row block
  bool vecb;   // LEAF: B's rows on the 16-byte grid

  __device__ int steps_of_row(int I) const {
    return DSTEPS * (nt - I) - (LEAF ? f : 0);
  }
  // the steps of rows 0 .. I − 1: Σ_{a=1}^{I} a·(8·(nt + 1 − a) − f)
  __device__ long long row_start(int I) const {
    const long long a = I;
    return DSTEPS *
               ((nt + 1) * a * (a + 1) / 2 - a * (a + 1) * (2 * a + 1) / 6) -
           (LEAF ? f * a * (a + 1) / 2 : 0);
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
  // the depth of the steps [s0, s1) from row k0: clipped at n (LEAF)
  __device__ int depth(long long k0, int s0, int s1) const {
    const int k = (s1 - s0) * ct::runs::STEP;
    return LEAF ? static_cast<int>(min(static_cast<long long>(k), n - k0))
                : k;
  }
  // steps [s0, s1) of tile t: those inside the row block from D, the rest
  // from L; or (LEAF) all from L, the elements above its diagonal
  // zero-filled in the staging
  __device__ void part(int t, int s0, int s1, float (&acc)[8][8],
                       float* sm) const {
    int I, J;
    ct::tri_tile(t, I, J);
    const long long r0 = static_cast<long long>(E) * I, c0 = E * J;
    if constexpr (LEAF) {
      // X(r, k) = L[k0 + k][r0 + r] for r <= k + k0 − r0, else 0
      const long long k0 = r0 + s0 * ct::runs::STEP;
      ct::t128::tile_xyt<false, false, VEC, true>(
          L + k0 * ldl + r0, 1, ldl, 0, E, L + k0 * ldl + c0, 1, ldl, 0, E,
          depth(k0, s0, s1), sm, acc, static_cast<int>(k0 - r0),
          static_cast<int>(k0 - c0));
    } else {
      const int sd = min(s1, DSTEPS);
      if (s0 < sd) {               // X(r, k) = D[k0 + k][r]
        const long long k0 = r0 + s0 * ct::runs::STEP;
        const float* const X = D + k0 * E;
        const bool diag = I == J;
        ct::t128::tile_xyt<false, false, VEC>(
            X, 1, E, 0, E, diag ? X : L + k0 * ldl + c0, 1, diag ? E : ldl,
            0, E, depth(k0, s0, sd), sm, acc);
      }
      const int sb = max(s0, DSTEPS);
      if (sb < s1) {               // X(r, k) = L[k0 + k][r0 + r]
        const long long k0 = r0 + sb * ct::runs::STEP;
        ct::t128::tile_xyt<false, false, VEC>(
            L + k0 * ldl + r0, 1, ldl, 0, E, L + k0 * ldl + c0, 1, ldl, 0, E,
            depth(k0, sb, s1), sm, acc);
      }
    }
  }
  // element c of row r of B (LEAF, diagonal tile, above the diagonal):
  // A's own
  __device__ float upper(long long r, long long c) const {
    return c < n ? L[r * ldl + c] : 0.f;
  }
  // four elements of row r, columns c .. c + 3, of tile t into B; above a
  // diagonal tile's diagonal zero, or (LEAF) A's values. The two forms
  // stay apart: written as one, the float4 stores of lauum_stream_f32's
  // diagonal tiles compiled to four 4-byte stores each (its runs 10 %
  // slower at 2048).
  __device__ void put4(int t, int r, int c, float4 v) const {
    int I, J;
    ct::tri_tile(t, I, J);
    if constexpr (!LEAF) {
      if (I == J) {
        if (c > r) v.x = 0.f;
        if (c + 1 > r) v.y = 0.f;
        if (c + 2 > r) v.z = 0.f;
        if (c + 3 > r) v.w = 0.f;
      }
      *reinterpret_cast<float4*>(
          B + (static_cast<long long>(E) * I + r) * ldb + E * J + c) = v;
    } else {
      const long long gr = static_cast<long long>(E) * I + r;
      const long long gc = static_cast<long long>(E) * J + c;
      if (gr >= n) return;
      if (I == J) {
        if (c > r) v.x = upper(gr, gc);
        if (c + 1 > r) v.y = upper(gr, gc + 1);
        if (c + 2 > r) v.z = upper(gr, gc + 2);
        if (c + 3 > r) v.w = upper(gr, gc + 3);
      }
      float* const b = B + gr * ldb + gc;
      if (vecb && gc + 3 < n) {
        *reinterpret_cast<float4*>(b) = v;
      } else {
        if (gc < n) b[0] = v.x;
        if (gc + 1 < n) b[1] = v.y;
        if (gc + 2 < n) b[2] = v.z;
        if (gc + 3 < n) b[3] = v.w;
      }
    }
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
  // LEAF: rows b, b + nb, ... of A's strict upper right of the diagonal
  // tiles into B, by 16 bytes where L's and B's rows lie on the 16-byte
  // grid
  __device__ void copy_upper(int b, int nb) const {
    if constexpr (LEAF) {
      for (long long r = b; r < n; r += nb) {
        const int c1 = static_cast<int>(r / E * E + E);
        const int c4 = VEC && vecb ? c1 + max(0, n - c1) / 4 * 4 : c1;
        for (int c = c1 + 4 * threadIdx.x; c < c4; c += 4 * NT)
          *reinterpret_cast<float4*>(B + r * ldb + c) =
              *reinterpret_cast<const float4*>(L + r * ldl + c);
        for (int c = c4 + threadIdx.x; c < n; c += NT)
          B[r * ldb + c] = L[r * ldl + c];
      }
    }
  }
};

// lauum_stream_f32: D[r][c] = L[r][128·I + c] for c <= r − 128·I (I = r /
// 128), else 0; B's row r zero right of its diagonal tile. A row a block
// (blocks of 128).
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
template <class Plan>
__global__ void __launch_bounds__(NT, 2)
lauum_runs(Plan p, long long q, float* P) {
  extern __shared__ __align__(16) float sm[];
  long long u = static_cast<long long>(blockIdx.x) * q, u1 = u + q;
  if (q == 0) {
    u = p.start(blockIdx.x);
    u1 = u + p.steps(blockIdx.x);
  }
  u1 = min(u1, p.total());
  float* const slots = P + 2LL * blockIdx.x * ct::runs::SLOT;
  ct::runs::run(p, u, u1, slots, slots + ct::runs::SLOT, sm);
  p.copy_upper(blockIdx.x, gridDim.x);
}

// The split tiles, a block per run boundary (blockIdx.x) and group set.
template <class Plan>
__global__ void __launch_bounds__(NT)
lauum_sum(Plan p, long long q, const float* P) {
  ct::runs::sum_at(p, blockIdx.x, blockIdx.y * NT + threadIdx.x, q, P);
}

// The prep launch (lauum_stream_f32), the runs and, where runs split
// tiles, their sums.
template <bool VEC, bool LEAF>
cudaError_t launch(const LauumPlan<VEC, LEAF>& p, long long q, int blocks,
                   float* D, float* P, cudaStream_t s) {
  using Plan = LauumPlan<VEC, LEAF>;
  const cudaError_t err = cudaFuncSetAttribute(
      lauum_runs<Plan>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  if constexpr (!LEAF)
    lauum_prep<<<std::min(p.n, 4096), E, 0, s>>>(p.L, p.ldl, D, p.B, p.ldb,
                                                  p.n);
  lauum_runs<Plan><<<blocks, NT, SMEM, s>>>(p, q, P);
  if (q > 0 && blocks > 1)
    lauum_sum<Plan><<<dim3(blocks, ct::runs::GROUPS), NT, 0, s>>>(p, q, P);
  return cudaGetLastError();
}

// The lower tiles' steps at order n (nt row blocks, f as in LauumPlan):
// Σ_I (I + 1)·(8·(nt − I) − f).
long long total_steps(long long nt, long long f) {
  return DSTEPS * nt * (nt + 1) * (nt + 2) / 6 - f * nt * (nt + 1) / 2;
}

// The checks both entries share, then the launch of the plan for L's
// alignment.
template <bool LEAF>
int check_and_launch(const float* L, long long ldl, float* B, long long ldb,
                     int n, long long q, int blocks, float* D, float* P,
                     int device, void* stream) {
  if (n < 1 || ldl < n || ldb < n || q < 0 || blocks < 1 ||
      (q > 0 && blocks > 1 && !P) ||
      (!LEAF && reinterpret_cast<unsigned long long>(D) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nt = (n + E - 1) / E;
  const long long tiles = nt * (nt + 1) / 2;
  const int f = static_cast<int>((E * nt - n) / ct::runs::STEP);
  if (tiles > 0x7fffffffLL ||
      (q == 0 ? blocks != tiles : blocks * q < total_steps(nt, f)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec =
      reinterpret_cast<unsigned long long>(L) % 16 == 0 && ldl % 4 == 0;
  const bool vecb =
      reinterpret_cast<unsigned long long>(B) % 16 == 0 && ldb % 4 == 0;
  const int ntt = static_cast<int>(nt);
  err = vec ? launch(LauumPlan<true, LEAF>{L, ldl, D, B, ldb, ntt, n, f, vecb},
                     q, blocks, D, P, s)
            : launch(LauumPlan<false, LEAF>{L, ldl, D, B, ldb, ntt, n, f,
                                            vecb},
                     q, blocks, D, P, s);
  return static_cast<int>(err);
}

}  // namespace

// q steps a run, blocks runs covering the lower tiles' steps, or q = 0:
// blocks = the lower tiles, one a block. D: n x 128 floats; P: two
// 128 x 128 slots a block where runs split tiles (q > 0, blocks > 1). B
// is the wrapper's own n x n buffer.
CT_EXPORT int ct_lauum_stream_f32(const float* L, long long ldl, float* B,
                                  long long ldb, int n, long long q,
                                  int blocks, float* D, float* P, int device,
                                  void* stream) {
  if (n < E || n > STREAM_MAX_N || n % E != 0 || ldb % 4 != 0 ||
      reinterpret_cast<unsigned long long>(B) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return check_and_launch<false>(L, ldl, B, ldb, n, q, blocks, D, P, device,
                                 stream);
}

// The same at any n >= 1, B's strict upper A's, with no D (lauu2_f32).
CT_EXPORT int ct_lauu2_f32(const float* L, long long ldl, float* B,
                           long long ldb, int n, long long q, int blocks,
                           float* P, int device, void* stream) {
  return check_and_launch<true>(L, ldl, B, ldb, n, q, blocks, nullptr, P,
                                device, stream);
}
