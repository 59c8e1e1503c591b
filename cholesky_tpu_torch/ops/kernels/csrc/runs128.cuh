// Balanced k-runs over 128 x 128 output tiles of uneven depth, on
// sgemm128.cuh's tile: shared by lauum.cu (lauum_stream_f32) and
// trtri_stream.cu (trtri_stream_f32), whose triangular products give each
// output tile its own depth.
//
// A Plan lists tiles t = 0 .. tiles() - 1, tile t of steps(t) k-steps of
// 16, at [start(t), start(t) + steps(t)) of one sequence of total() steps
// (start(t + 1) = start(t) + steps(t)); tile_at(u) is the tile holding
// step u. Run b is the steps [b·q, b·q + q): one run a block, so every
// block does the same work whatever the depths (syrk.cu cuts a uniform
// depth the same way). A block accumulates each tile of its run
// (Plan::part over steps [s0, s1) of the tile), stores a tile whose whole
// depth lies in its run (Plan::store), and puts a part of a tile into its
// slot of the workspace P: its first tile's part into slot 0, its last
// tile's into slot 1 (the tiles between them are whole). One more launch
// (sum_at) then sums each split tile's parts in k order, run b0 first, and
// stores them (Plan::store4): no float atomics, so a call repeats bit for
// bit. A split tile is found from the first run boundary b·q inside it, so
// that launch has (runs − 1) x GROUPS work items, not one a tile: a block
// an item, 1024 of the tile's elements, four a thread.
#pragma once

#include "sgemm128.cuh"

namespace ct {
namespace runs {

constexpr int E = t128::BM;        // the tile edge
constexpr int NT = t128::NT;       // threads
constexpr int STEP = t128::BK;     // a k-step
constexpr int SLOT = E * E;        // floats of a slot
constexpr int GROUPS = SLOT / (4 * NT);   // a tile's groups of sum_at

// Programmatic dependent launch (Hopper): a kernel launched by launch()
// may be scheduled while the kernel before it on the stream still runs,
// once every block of that one has called release(); depend() then waits
// until it has finished and its stores are visible. In a kernel launched
// otherwise both are no-ops.
__device__ __forceinline__ void release() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void depend() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <class... Params, class... Args>
cudaError_t launch(void (*k)(Params...), dim3 grid, int smem,
                   cudaStream_t st, Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, k, args...);
}

// The thread's 8 x 8 micro-tile into a row-major E x E slot, by 16 bytes.
__device__ __forceinline__ void store_slot(float* slot,
                                           const float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(slot + t128::row_of(i) * E +
                                 t128::col_of(4 * h)) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                      acc[i][4 * h + 3]);
}

// The steps [u, u1) of the plan's sequence, tile by tile; slot0 and slot1
// are the block's two slots of P.
template <class Plan>
__device__ void run(const Plan& p, long long u, long long u1, float* slot0,
                    float* slot1, float* sm) {
  if (u >= u1) return;
  int t = p.tile_at(u);
  const int first = t;
  long long ut = p.start(t);
  while (u < u1) {
    const int T = p.steps(t);
    const int s0 = static_cast<int>(u - ut);
    const int s1 = static_cast<int>(min(static_cast<long long>(T),
                                        s0 + (u1 - u)));
    float acc[8][8] = {};
    p.part(t, s0, s1, acc, sm);
    if (s0 == 0 && s1 == T)
      p.store(t, acc);
    else
      store_slot(t == first ? slot0 : slot1, acc);
    u += s1 - s0;
    ut += T;
    ++t;
  }
}

// Group g (elements 4g .. 4g + 3, row-major) of the tile that run boundary
// b·q is the first to cut, if any: the sum of the tile's parts, over the
// runs b0 < ... < b1, in k order, every part's load in flight at once,
// through L2 (__ldcg: the last launch wrote them).
template <class Plan>
__device__ void sum_at(const Plan& p, long long b, int g, long long q,
                       const float* P) {
  const long long u = b * q;
  if (b < 1 || u >= p.total()) return;
  const int t = p.tile_at(u);
  const long long U = p.start(t);
  if (U == u || u - q > U) return;   // a tile's start, or not the first cut
  const long long b0 = U / q, b1 = (U + p.steps(t) - 1) / q;
  const int idx = 4 * g;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (long long r = b0; r <= b1; ++r) {
    // run b0 holds t in slot 1 unless t is its first tile; the runs after
    // it start inside t
    const bool last = r == b0 && b0 * q != U;
    const float4 x = __ldcg(
        reinterpret_cast<const float4*>(P + (2 * r + last) * SLOT + idx));
    v.x += x.x;
    v.y += x.y;
    v.z += x.z;
    v.w += x.w;
  }
  p.store4(t, idx / E, idx % E, v);
}

}  // namespace runs
}  // namespace ct
