// trtri_stream_f32: inverse of a lower-triangular n x n matrix, n % 128 == 0,
// 128 <= n <= 8192.
//
// Replaces cholesky_tpu/ops/pallas/mega.py:trtri_hbm_f32
// (_trtri_hbm_kernel), the TPU's whole-matrix trtri for 1024 < n <= 8192.
// On the GP model's train step it is potri's trtri at n = 8192, as two
// launches at 4096 (the tuned trtri_f32.mega_max_n) in the recursion.
//
// Contract (that of trtri_block.cu without its 1024 cap): only the lower
// triangle of L is read; W is a separate buffer whose strict upper is
// written zero. A zero diagonal entry is read as 1 and does not stop the
// inversion, so W stays finite; info is the 1-based index of the first
// (smallest) zero diagonal, as LAPACK's strtri reports it. A call repeats
// bit for bit.
//
// What bounds it on the H100: n^3/6 FFMA (11.5 G at n = 4096) in plain f32
// (TF32 is not f32-accurate), at best the 67 TFLOP/s vector rate: 0.342 ms
// at 4096; then the chain of log2(n/128) levels, each waiting for the one
// before it, and their tiles' uneven depths. The TPU kernel streamed
// 128-row panels bottom-up through one core's VMEM.
//
// Design: the 2 x 2 block identity inv([[A, 0], [B, C]]) = [[A⁻¹, 0],
// [−C⁻¹·B·A⁻¹, C⁻¹]] applied bottom-up (trtri_block_f32's and trti2_f32's
// order of work, mega.trtri_levels), a launch a phase:
//   leaves  every 128-wide diagonal tile at once, one block each
//           (trtri_leaf.cuh, shared with trtri_block.cu and leaf.cu's
//           trti2_f32); tile 0's block writes info;
//   levels  for s = 128, 256, ... < n, each pair (A at a0, C at c0 =
//           a0 + s, C short at the end) of inverted s-blocks, two
//           products on sgemm128.cuh's 128 x 128 tile, as trti2_f32 has
//           them: Xᵀ = (B·A⁻¹)ᵀ = A⁻ᵀ·Bᵀ into W's strict upper, the
//           mirror W[a0:c0, c0:c0+sc] of the block it is for, then
//           W[c0:c0+sc, a0:c0] = −C⁻¹·X with X read back from the mirror.
//           A⁻¹ and C⁻¹ are lower, so an output tile's depth runs only
//           where they are live: 128 to s. A product of fewer than
//           whole_min tiles (mega.STREAM_WHOLE_MIN_TILES, one wave of
//           264 blocks) has its tiles' k-steps, every pair's, cut in equal
//           runs for one wave (runs128.cuh), and a launch of its own sums
//           each split tile in k order; from whole_min tiles a block takes
//           a tile, the deepest first;
//   finish  W's strict upper right of each row's leaf written zero (the
//           mirrors).
// A⁻¹ is read from its diagonal tile on and C⁻¹ up to its diagonal tile,
// whose upper parts are the leaf's zeros, so no product reads a mirror but
// the one its level wrote. Every launch after the leaves may be scheduled
// while the one before it ends (programmatic dependent launch) and waits
// for it in griddepcontrol.wait; that took the gaps between phases from
// 183 to 147 µs at 4096.
//
// Measured (chip_smoke.py at commit f78f09b; ms of one call, NVIDIA H100
// 80GB HBM3, 700 W): the levels as ONE cooperative launch of two blocks
// an SM with a grid sync after each phase (the TPU kernel's one-dispatch
// shape) 0.3972-0.4103 / 1.1748-1.1788 / 7.1880-7.2337 at 2048 / 4096 /
// 8192, a launch a phase 0.3577-0.3585 / 1.0418-1.0909 / 5.2839-5.3026,
// with programmatic dependent launch 0.3325-0.3341 / 0.9831-0.9918 /
// 5.3935-5.4136 (kept: ahead at the GP step's 4096): the cooperative
// kernel held both products and the sums at 128 registers and spilled
// (216-260 bytes), its products ran 10-30 % slower and its sums, a
// block's work items in turn, 5x; it went. A tile a block on every level
// 1.5450-1.6114 at 4096, runs on every level 0.9989-1.0120 and the rule
// 0.9983-1.0284; at 8192 5.5363-5.6584, 5.7062-5.9246 and 5.2437-5.5053.
// Device time at 4096 (the trace): 0.947 ms, of which the leaves 17 µs,
// the products 732, the sums 43, the finish 8, the gaps between launches
// 147. The design before this one, one cooperative launch whose leaves
// were a forward substitution with one thread a column from device
// memory and whose levels ran a 64 x 64 tile (sgemm_tile.cuh) a block,
// took 2.53 ms at 4096, 354 µs of it the leaves and 1.33 ms the last level
// (chip_compare.py's trace at commit e3fba80).
//
// Trace: given a zeroed buffer of TRACE_SLOTS 64-bit words a phase, in
// launch order (mega.trtri_stream_phases), the launches record
// %globaltimer (ns): block 0's entry into the phase, and the latest end
// of any block's work in it (atomicMax). A null buffer records nothing.
#include <algorithm>
#include <initializer_list>
#include <utility>

#include "runs128.cuh"
#include "sgemm_tile.cuh"
#include "trtri_leaf.cuh"

namespace {

using ct::runs::E;                 // the tile edge and the leaf
using ct::runs::NT;                // threads
static_assert(E == ct::tleaf::LW && NT == ct::tleaf::NT, "the leaves");
constexpr int STEPS = E / ct::runs::STEP;   // k-steps of one 128 tile
constexpr int MAX_N = 8192;
constexpr int TRACE_SLOTS = 2;     // a phase's entry and its last end
// shared bytes of a product block (the larger of the two products' rings)
constexpr int SMEM =
    ct::t128::smem_floats<true, true>() * static_cast<int>(sizeof(float));

// block 0's entry into phase r, and the end of this block's work in it
__device__ __forceinline__ void stamp_entry(unsigned long long* trace,
                                            int r) {
  if (trace && blockIdx.x == 0 && threadIdx.x == 0)
    trace[r * TRACE_SLOTS] = ct::globaltimer();
}

__device__ __forceinline__ void stamp_end(unsigned long long* trace, int r) {
  if (!trace) return;
  __syncthreads();                 // every thread of the block is done
  if (threadIdx.x == 0)
    atomicMax(trace + r * TRACE_SLOTS + 1, ct::globaltimer());
}

// Pairs of s-blocks whose second block starts inside the matrix.
__host__ __device__ inline int pairs(int n, int s) {
  return (n - s + 2 * s - 1) / (2 * s);
}

// One product of level s over every pair. FIRST: the tiles (ti, tj) of
// Xᵀ (s x sc, depth 8·(m − ti) steps from row 128·ti of A⁻¹); else those
// of W21 (sc x s, depth 8·(ti + 1)). m = s / 128, mc = sc / 128 (m but
// for the last pair). Tiles pair by pair, in a pair row tile by row tile:
// pair p's tiles start at p·m², its steps at p·(a full pair's steps).
// VEC: L on the 16-byte grid (W, the wrapper's own, always is; off it,
// the first product stages both operands by 4-byte copies).
template <bool FIRST, bool VEC>
struct LevelPlan {
  const float* L;
  long long ldl;
  float* W;
  long long ldw;
  int s, m, np, mc_last;

  __device__ LevelPlan(const float* L_, long long ldl_, float* W_,
                       long long ldw_, int n, int s_)
      : L(L_), ldl(ldl_), W(W_), ldw(ldw_), s(s_), m(s_ / E),
        np(pairs(n, s_)),
        mc_last(min(s_, n - (2 * (pairs(n, s_) - 1) + 1) * s_) / E) {}

  __device__ int rows(int mc) const { return FIRST ? m : mc; }  // row tiles
  __device__ int cols(int mc) const { return FIRST ? mc : m; }  // per row
  __device__ int depth(int ti) const {
    return FIRST ? STEPS * (m - ti) : STEPS * (ti + 1);
  }
  // the steps of the row tiles before ti, each of cols tiles
  __device__ long long rows_before(int ti, int w) const {
    const long long a = ti;
    return FIRST ? STEPS * w * (a * m - a * (a - 1) / 2)
                 : STEPS * w * (a * (a + 1) / 2);
  }
  __device__ long long pair_steps(int mc) const {
    return rows_before(rows(mc), cols(mc));
  }
  __device__ long long total() const {
    return (np - 1) * pair_steps(m) + pair_steps(mc_last);
  }
  __device__ void decode(int t, int& p, int& ti, int& tj) const {
    p = t / (m * m);
    const int w = cols(p == np - 1 ? mc_last : m), l = t - p * m * m;
    ti = l / w;
    tj = l % w;
  }
  __device__ int steps(int t) const {
    int p, ti, tj;
    decode(t, p, ti, tj);
    return depth(ti);
  }
  __device__ long long start(int t) const {
    int p, ti, tj;
    decode(t, p, ti, tj);
    const int w = cols(p == np - 1 ? mc_last : m);
    return p * pair_steps(m) + rows_before(ti, w) +
           static_cast<long long>(tj) * depth(ti);
  }
  __device__ int tile_at(long long u) const {
    const int p = static_cast<int>(min(u / pair_steps(m),
                                       static_cast<long long>(np - 1)));
    const int w = cols(p == np - 1 ? mc_last : m);
    long long r = u - p * pair_steps(m);
    int ti = 0;
    while (r >= static_cast<long long>(w) * depth(ti)) r -= w * depth(ti++);
    return p * m * m + ti * w + static_cast<int>(r / depth(ti));
  }
  // block b's tile when a block takes a tile, the deepest first (row
  // tile rank a the slowest index, then pair, then column tile); false
  // for a block past the last pair's short C
  __device__ bool whole_tile(int b, int& t) const {
    const int a = b / (np * m), p = b / m % np, j = b % m;
    const int mc = p == np - 1 ? mc_last : m;
    const int ti = FIRST ? a : m - 1 - a;
    t = p * m * m + ti * cols(mc) + j;
    return (FIRST ? j : ti) < mc;
  }
  // steps [s0, s1) of tile t
  __device__ void part(int t, int s0, int s1, float (&acc)[8][8],
                       float* sm) const {
    int p, ti, tj;
    decode(t, p, ti, tj);
    const long long a0 = 2LL * p * s, c0 = a0 + s;
    const int K = (s1 - s0) * ct::runs::STEP;
    if (FIRST) {
      // Xᵀ[r][c] = Σ_k A⁻¹[k][r]·B[c][k]: A⁻¹ row-fast from W, B k-fast
      // from L, k from row 128·ti of A⁻¹
      const long long k0 = E * ti + s0 * ct::runs::STEP;
      ct::t128::tile_xyt<false, true, VEC>(
          W + (a0 + k0) * ldw + a0 + E * ti, 1, ldw, 0, E,
          L + (c0 + E * tj) * ldl + a0 + k0, ldl, 1, 0, E, K, sm, acc);
    } else {
      // W21[r][c] = −Σ_k C⁻¹[r][k]·Xᵀ[c][k], both k-fast from W
      const long long k0 = s0 * ct::runs::STEP;
      ct::t128::tile_xyt<true, true, true>(
          W + (c0 + E * ti) * ldw + c0 + k0, ldw, 1, 0, E,
          W + (a0 + E * tj) * ldw + c0 + k0, ldw, 1, 0, E, K, sm, acc);
    }
  }
  // four elements of row r, columns c .. c + 3, of tile t: into the
  // mirror, or negated into W21
  __device__ void store4(int t, int r, int c, float4 v) const {
    int p, ti, tj;
    decode(t, p, ti, tj);
    const long long a0 = 2LL * p * s, c0 = a0 + s;
    float* const out =
        FIRST ? W + (a0 + E * ti + r) * ldw + c0 + E * tj + c
              : W + (c0 + E * ti + r) * ldw + a0 + E * tj + c;
    if (!FIRST) v = make_float4(-v.x, -v.y, -v.z, -v.w);
    *reinterpret_cast<float4*>(out) = v;
  }
  __device__ void store(int t, const float (&acc)[8][8]) const {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store4(t, ct::t128::row_of(i), ct::t128::col_of(4 * h),
               make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                           acc[i][4 * h + 2], acc[i][4 * h + 3]));
  }
};

// The level's tiles of either product: every pair's m x mc.
inline int level_tiles(int n, int s) {
  const int m = s / E, np = pairs(n, s);
  return (np - 1) * m * m + m * (std::min(s, n - (2 * np - 1) * s) / E);
}

// The launches, one a phase: the leaves ...
__global__ void __launch_bounds__(NT)
trtri_stream_leaf(const float* __restrict__ L, long long ldl, float* W,
                  long long ldw, int n, int* info,
                  unsigned long long* trace) {
  extern __shared__ __align__(16) float sm[];
  ct::runs::release();
  stamp_entry(trace, 0);
  ct::tleaf::leaf<false>(L, ldl, W, ldw, n, blockIdx.x, sm, info);
  stamp_end(trace, 0);
}

// ... one product of level s: tile blockIdx.x of the deepest-first order
// where the level takes a block a tile (runs = 0), else run blockIdx.x of
// `runs` equal runs, its parts in two slots of P ...
template <bool FIRST, bool VEC>
__global__ void __launch_bounds__(NT, 2)
trtri_stream_runs(const float* __restrict__ L, long long ldl, float* W,
                  long long ldw, int n, int s, int runs, float* P,
                  unsigned long long* trace, int phase) {
  extern __shared__ __align__(16) float sm[];
  const LevelPlan<FIRST, VEC> p(L, ldl, W, ldw, n, s);
  ct::runs::release();
  ct::runs::depend();
  stamp_entry(trace, phase);
  long long u = 0, u1 = 0;         // none: a block past the last pair's C
  int t;
  if (runs > 0) {
    const long long total = p.total(), q = (total + runs - 1) / runs;
    u = blockIdx.x * q;
    u1 = min(u + q, total);
  } else if (p.whole_tile(blockIdx.x, t)) {
    u = p.start(t);
    u1 = u + p.steps(t);
  }
  float* const slots = P + 2LL * blockIdx.x * ct::runs::SLOT;
  ct::runs::run(p, u, u1, slots, slots + ct::runs::SLOT, sm);
  stamp_end(trace, phase);
}

// ... the sum of its split tiles, a block a run boundary and group set ...
template <bool FIRST, bool VEC>
__global__ void __launch_bounds__(NT)
trtri_stream_sum(const float* __restrict__ L, long long ldl, float* W,
                 long long ldw, int n, int s, int runs, const float* P,
                 unsigned long long* trace, int phase) {
  const LevelPlan<FIRST, VEC> p(L, ldl, W, ldw, n, s);
  ct::runs::release();
  ct::runs::depend();
  stamp_entry(trace, phase);
  ct::runs::sum_at(p, blockIdx.x, blockIdx.y * NT + threadIdx.x,
                   (p.total() + runs - 1) / runs, P);
  stamp_end(trace, phase);
}

// ... and the finish, W's strict upper right of each row's leaf zero (the
// mirrors), a block a row.
__global__ void __launch_bounds__(NT)
trtri_stream_finish(float* W, long long ldw, int n,
                    unsigned long long* trace, int phase) {
  ct::runs::depend();
  stamp_entry(trace, phase);
  for (int r = blockIdx.x; r < n; r += gridDim.x)
    for (int c = (r / E + 1) * E + 4 * threadIdx.x; c < n; c += 4 * NT)
      *reinterpret_cast<float4*>(W + r * ldw + c) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  stamp_end(trace, phase);
}

template <bool VEC>
cudaError_t launch_levels(const float* L, long long ldl, float* W,
                          long long ldw, int n, float* P, int blocks,
                          int whole_min, unsigned long long* trace,
                          cudaStream_t st) {
  const auto x = trtri_stream_runs<true, VEC>;
  const auto w = trtri_stream_runs<false, VEC>;
  const auto xs = trtri_stream_sum<true, VEC>;
  const auto ws = trtri_stream_sum<false, VEC>;
  cudaError_t err =
      cudaFuncSetAttribute(x, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(w, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
  const dim3 sums(blocks, ct::runs::GROUPS);
  int phase = 1;
  for (int s = E; s < n && err == cudaSuccess; s *= 2) {
    const int m = s / E, np = pairs(n, s);
    if (level_tiles(n, s) >= whole_min) {
      for (const auto k : {x, w})
        if (err == cudaSuccess)
          err = ct::runs::launch(k, np * m * m, SMEM, st, L, ldl, W,
                                 ldw, n, s, 0, P, trace, phase++);
      continue;
    }
    for (const auto [k, ks] : {std::pair(x, xs), std::pair(w, ws)}) {
      if (err == cudaSuccess)
        err = ct::runs::launch(k, blocks, SMEM, st, L, ldl, W, ldw, n,
                               s, blocks, P, trace, phase++);
      if (err == cudaSuccess)
        err = ct::runs::launch(ks, sums, 0, st, L, ldl, W, ldw, n, s,
                               blocks, static_cast<const float*>(P), trace,
                               phase++);
    }
  }
  if (err == cudaSuccess)
    err = ct::runs::launch(trtri_stream_finish, std::min(n, 4096), 0, st, W,
                           ldw, n, trace, phase);
  return err;
}

}  // namespace

// A level whose products have whole_min tiles of 128 or more takes a
// block a tile, deepest first; a smaller one `blocks` equal runs. P: two
// 128 x 128 slots a run. W is the wrapper's own n x n buffer.
CT_EXPORT int ct_trtri_stream_f32(const float* L, long long ldl, float* W,
                                  long long ldw, float* P, int n, int blocks,
                                  int whole_min, int* info,
                                  unsigned long long* trace, int device,
                                  void* stream) {
  if (n < E || n > MAX_N || n % E != 0 || ldl < n || ldw < n ||
      ldw % 4 != 0 || reinterpret_cast<unsigned long long>(W) % 16 != 0 ||
      !P || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(trtri_stream_leaf,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             ct::tleaf::LEAF_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  trtri_stream_leaf<<<n / E, NT, ct::tleaf::LEAF_SMEM, st>>>(L, ldl, W, ldw,
                                                             n, info, trace);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec =
      reinterpret_cast<unsigned long long>(L) % 16 == 0 && ldl % 4 == 0;
  err = vec ? launch_levels<true>(L, ldl, W, ldw, n, P, blocks, whole_min,
                                  trace, st)
            : launch_levels<false>(L, ldl, W, ldw, n, P, blocks, whole_min,
                                   trace, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
